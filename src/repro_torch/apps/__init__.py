from repro_torch.apps.bfs import bfs
from repro_torch.apps.sssp import sssp
from repro_torch.apps.pagerank import pagerank, pagerank_delta
from repro_torch.apps.cc import cc
from repro_torch.apps.batch import batched_queries, multi_source_bfs, \
    multi_source_sssp
from repro_torch.apps.ppr import personalized_pagerank

__all__ = ["bfs", "sssp", "pagerank", "pagerank_delta", "cc",
           "batched_queries",
           "multi_source_bfs", "multi_source_sssp", "personalized_pagerank"]
