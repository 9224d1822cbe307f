"""Breadth-first search as a diffusive action (paper Listings 4/6/9).

The action's predicate is ``new_level < level``; work sets the level; the
diffusion relays ``level+1`` along out-edges; ``rhizome-collapse(bcast)``
keeps replicas consistent. In the bulk engine these are the BFS semiring's
``improved`` / ``combine`` / ``relax`` and the sibling collapse.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core import actions, engine
from repro_torch.core.partition import Partition, PartitionConfig, build_partition
from repro_torch.graph.graph import COOGraph

UNREACHED = np.iinfo(np.int32).max


def bfs(g: COOGraph, root: int, part: Partition | None = None,
        cfg: engine.EngineConfig = engine.EngineConfig(),
        num_shards: int = 16, rpvo_max: int = 1,
        mesh=None, axis_names=("data", "model"), device=None):
    """Returns (levels (n,) int64, stats, partition).  ``device=None``
    runs on CUDA (see ``engine.resolve_device``).  With ``mesh`` (a
    ``DeviceMesh``) every rank makes this call and runs its shard
    (``engine.run_sharded``)."""
    dev = engine.resolve_device(device)
    with obs.span("app.call", track="app", app="bfs", root=int(root)):
        if part is None:
            part = build_partition(
                g, PartitionConfig(num_shards=num_shards, rpvo_max=rpvo_max)
            )
        init = engine.init_values(part, actions.BFS, {root: 0.0})
        if mesh is None:
            val, stats = engine.run_stacked(actions.BFS, part, init, cfg,
                                            device=dev)
        else:
            val, stats = engine.run_sharded(actions.BFS, part, init, mesh,
                                            axis_names, cfg, device=dev)
        with obs.span("app.extract", track="app"):
            lv = engine.vertex_values(part, val)
        levels = np.where(np.isfinite(lv), lv, 0).astype(np.int64)
        levels[~np.isfinite(lv)] = UNREACHED
    return levels, stats, part
