"""Connected components as a min-semiring diffusive fixpoint.

Weakly connected components by min-label propagation: every vertex starts
with its own id as value and diffuses it along the *symmetrized* edge set
with zero weights, so the relax ``v + 0`` copies labels and the fixpoint
assigns each vertex the minimum vertex id of its component — the SSSP
semiring on a zero-weight graph, run as one lane of
``run_stacked_lanes``.

Labels live in the engine's float32 value table, exact for vertex ids
below 2**24.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import engine
from repro_torch.core.partition import Partition, PartitionConfig, build_partition
from repro_torch.graph.graph import COOGraph
from repro_torch.query.lanes import run_stacked_lanes


def _symmetrized_zero_weight(g: COOGraph) -> COOGraph:
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    return COOGraph(g.n, src, dst, np.zeros(src.shape, np.float32)).dedup()


def cc(g: COOGraph, part: Partition | None = None,
       cfg: engine.EngineConfig = engine.EngineConfig(),
       num_shards: int = 16, rpvo_max: int = 1, device=None):
    """Returns (labels (n,) int64 — min vertex id per weakly connected
    component, per-lane stats, partition).  ``part``, if given, must be a
    partition of the symmetrized zero-weight graph.  ``device=None`` runs
    on CUDA (see ``engine.resolve_device``)."""
    if g.n >= (1 << 24):
        raise ValueError("float32 label table is exact only for n < 2**24")
    dev = engine.resolve_device(device)
    if part is None:
        part = build_partition(
            _symmetrized_zero_weight(g),
            PartitionConfig(num_shards=num_shards, rpvo_max=rpvo_max))
    # vertex-id initial values on every replica (consistent view); every
    # vertex is initially changed, so labels flood from round one
    init = np.where(part.slot_vertex >= 0,
                    part.slot_vertex.astype(np.float32), np.inf)
    val, stats = run_stacked_lanes(part, init[..., None],
                                   lane_unitw=np.zeros(1, np.int32), cfg=cfg,
                                   device=dev)
    labels = engine.vertex_values(part, val[..., 0]).astype(np.int64)
    return labels, stats, part
