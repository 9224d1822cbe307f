"""The paper's primary contribution: RPVO/Rhizome partitioning, the
diffusive execution engine and LCO synchronization."""
from repro_torch.core.partition import PartitionConfig, Partition, build_partition
from repro_torch.core.actions import Semiring, BFS, SSSP, PAGERANK, SEMIRINGS
from repro_torch.core.lco import AndGate, Future, and_gate_tree
from repro_torch.core import engine

__all__ = [
    "PartitionConfig", "Partition", "build_partition",
    "Semiring", "BFS", "SSSP", "PAGERANK", "SEMIRINGS",
    "AndGate", "Future", "and_gate_tree",
    "engine",
]
