from repro_torch.apps.bfs import bfs
from repro_torch.apps.sssp import sssp

__all__ = ["bfs", "sssp"]
