from repro_torch.graph.graph import COOGraph, degree_stats
from repro_torch.graph.generators import rmat, erdos_renyi, star, ring, ba_skewed
from repro_torch.graph import reference

__all__ = [
    "COOGraph",
    "degree_stats",
    "rmat",
    "erdos_renyi",
    "star",
    "ring",
    "ba_skewed",
    "reference",
]
