from repro_torch.apps.bfs import bfs
from repro_torch.apps.pagerank import pagerank, pagerank_delta
from repro_torch.apps.sssp import sssp

__all__ = ["bfs", "pagerank", "pagerank_delta", "sssp"]
