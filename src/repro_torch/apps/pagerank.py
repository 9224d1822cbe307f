"""PageRank as a diffusive action (paper Listing 10).

Each round every vertex diffuses ``score/out_degree`` along out-edges
(the per-edge factor is folded into the edge weight at partition time);
the inbox accumulates with ``+``; ``rhizome-collapse(+)`` all-reduces the
per-replica partial inboxes (the AND-gate fires when all replicas have
contributed), then the trigger applies the damping update.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import engine
from repro_torch.core.partition import Partition, PartitionConfig, build_partition
from repro_torch.graph.graph import COOGraph


def _pr_graph(g: COOGraph) -> COOGraph:
    out_deg = np.maximum(g.out_degrees(), 1).astype(np.float32)
    w = 1.0 / out_deg[g.src]
    return COOGraph(g.n, g.src, g.dst, w)


def _partition(g, part, num_shards, rpvo_max):
    if part is None:
        part = build_partition(
            _pr_graph(g),
            PartitionConfig(num_shards=num_shards, rpvo_max=rpvo_max),
        )
    return part


def pagerank(g: COOGraph, damping: float = 0.85, iters: int = 30,
             part: Partition | None = None,
             cfg: engine.EngineConfig = engine.EngineConfig(),
             num_shards: int = 16, rpvo_max: int = 1,
             mesh=None, axis_names=("data", "model"), device=None):
    """Returns (scores (n,) float64, partition).  ``device=None`` runs on
    CUDA (see ``engine.resolve_device``); ``mesh`` runs the sharded
    layout (``engine.run_pagerank_sharded``), every rank making the
    call."""
    dev = engine.resolve_device(device)
    part = _partition(g, part, num_shards, rpvo_max)
    if mesh is None:
        val = engine.run_pagerank_stacked(part, damping, iters, cfg,
                                          device=dev)
    else:
        val = engine.run_pagerank_sharded(part, damping, iters, mesh,
                                          axis_names, cfg, device=dev)
    return engine.vertex_values(part, val).astype(np.float64), part


def pagerank_delta(g: COOGraph, damping: float = 0.85, tol=1e-7,
                   part: Partition | None = None,
                   cfg: engine.EngineConfig = engine.EngineConfig(),
                   num_shards: int = 16, rpvo_max: int = 1,
                   mesh=None, axis_names=("data", "model"),
                   max_rounds: int = 256, device=None):
    """Delta-PageRank: push-based residual propagation — only deltas
    above ``tol`` diffuse, so the frontier shrinks round over round and
    the engine's diffusion pruning (chunk skip, worklist launch) fires
    for the sum semiring.  Converges to the ``pagerank`` fixpoint within
    O(tol / (1-damping)) per vertex.

    Returns (scores (n,) float64, RunStats, partition); ``mesh`` runs
    the sharded layout (``engine.run_pagerank_delta_sharded``)."""
    dev = engine.resolve_device(device)
    part = _partition(g, part, num_shards, rpvo_max)
    if mesh is None:
        val, stats = engine.run_pagerank_delta(part, damping, tol, cfg,
                                               max_rounds, device=dev)
    else:
        val, stats = engine.run_pagerank_delta_sharded(
            part, damping, tol, mesh, axis_names, cfg, max_rounds,
            device=dev)
    return engine.vertex_values(part, val).astype(np.float64), stats, part
