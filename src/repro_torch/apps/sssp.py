"""Single-source shortest paths: min-plus diffusive relaxation.

Same action shape as BFS with ``msg = dist + w`` (paper §6: 'BFS and SSSP
actions take 2-3 cycles of compute').
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core import actions, engine
from repro_torch.core.partition import Partition, PartitionConfig, build_partition
from repro_torch.graph.graph import COOGraph


def sssp(g: COOGraph, root: int, part: Partition | None = None,
         cfg: engine.EngineConfig = engine.EngineConfig(),
         num_shards: int = 16, rpvo_max: int = 1,
        mesh=None, axis_names=("data", "model"), device=None):
    """Returns (dist (n,) float64 with inf for unreachable, stats,
    partition).  ``device=None`` runs on CUDA (see
    ``engine.resolve_device``).  With ``mesh`` (a ``DeviceMesh``) every
    rank makes this call and runs its shard (``engine.run_sharded``)."""
    dev = engine.resolve_device(device)
    with obs.span("app.call", track="app", app="sssp", root=int(root)):
        if part is None:
            part = build_partition(
                g, PartitionConfig(num_shards=num_shards, rpvo_max=rpvo_max)
            )
        init = engine.init_values(part, actions.SSSP, {root: 0.0})
        if mesh is None:
            val, stats = engine.run_stacked(actions.SSSP, part, init, cfg,
                                            device=dev)
        else:
            val, stats = engine.run_sharded(actions.SSSP, part, init, mesh,
                                            axis_names, cfg, device=dev)
        with obs.span("app.extract", track="app"):
            dist = engine.vertex_values(part, val).astype(np.float64)
    return dist, stats, part
