"""Personalized PageRank on the query-lane axis.

Each lane is one personalization: score_q = (1 - d_q) * e_{s_q} + d_q *
A^T (score_q / outdeg), iterated to a per-lane tolerance on the shared
laned round (``repro_torch.query.lanes.make_ppr_round``).  Per-lane seeds
and dampings coexist in one round; dangling mass is not redistributed,
matching ``graph.reference`` and the engine's global PageRank.
"""
from __future__ import annotations

import numpy as np

from repro_torch.apps.pagerank import _pr_graph
from repro_torch.core import engine
from repro_torch.core.partition import Partition, PartitionConfig, build_partition
from repro_torch.graph.graph import COOGraph
from repro_torch.query.lanes import run_ppr_lanes


def personalized_pagerank(g: COOGraph, seeds, dampings=0.85,
                          part: Partition | None = None,
                          cfg: engine.EngineConfig = engine.EngineConfig(),
                          tol: float = 1e-8, max_rounds: int = 256,
                          num_shards: int = 16, rpvo_max: int = 1,
                          device=None):
    """Returns ((n, Q) float64 scores — one column per seed — per-lane
    ``LaneStats``, partition).  ``part``, if given, must partition the
    1/out-degree weighted graph (``apps.pagerank._pr_graph``).
    ``device=None`` runs on CUDA (see ``engine.resolve_device``)."""
    dev = engine.resolve_device(device)
    if part is None:
        part = build_partition(
            _pr_graph(g),
            PartitionConfig(num_shards=num_shards, rpvo_max=rpvo_max))
    val, stats = run_ppr_lanes(part, [int(s) for s in seeds], dampings,
                               cfg, tol=tol, max_rounds=max_rounds,
                               device=dev)
    val = val.cpu().numpy()
    cols = [engine.vertex_values(part, val[..., q]).astype(np.float64)
            for q in range(val.shape[-1])]
    return np.stack(cols, axis=-1), stats, part
