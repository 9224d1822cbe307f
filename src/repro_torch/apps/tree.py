"""Search trees: BFS and SSSP that also return a parent array (Graph500's
kernels 2 and 3).

``bfs_tree`` / ``sssp_tree`` run the fixpoint as ``apps.bfs`` /
``apps.sssp`` do (the same runner, on the partition's resident tables),
then pick each reached vertex's parent in one pass over the stacked edges
on the device (K10, ``kernels.tree_parents``):

- a vertex v other than the root takes an in-neighbour u along an input
  edge (u, v, w) with ``fl32(d[u] + w) == d[v]`` and ``d[u] < d[v]``
  (w = 1 for BFS: level[u] = level[v] - 1);
- the smallest global id wins, and every replica of v agrees (the pass
  writes one (n,) array by vertex id);
- ties: a vertex reached only through zero weights, or through a weight
  that float32 rounding absorbed, has only candidates with d[u] == d[v].
  It takes its parent in further rounds over those tie edges alone, from
  vertices that had a parent before the round, so the output is a tree
  whatever the weights.  BFS never needs one.

``parents[root] = root`` and -1 where a vertex is unreached (Graph500's
convention).  The pass reads the partition's resident tables
(``engine.device_arrays``: the stacked edges, ``slot_vertex`` and
``root_flat``), and the parents come back in one copy, into a host
buffer pinned on CUDA; an SSSP pass first reads the count of reached
vertices still without a parent, and each tie round adds a launch and a
read of that count (reads that ``engine_host_syncs_total`` does not
count).  Spans: ``app.tree`` (arg ``app``) inside ``app.call``; counters
``tree_passes_total{app}`` and ``tree_tie_rounds_total{app}``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.apps.bfs import UNREACHED
from repro_torch.core import actions, engine
from repro_torch.core.partition import Partition, PartitionConfig, build_partition
from repro_torch.graph.graph import COOGraph
from repro_torch.kernels import tree_parents as k10


def parents(part: Partition, arrays: engine.DeviceArrays, val, root: int,
            weighted: bool) -> tuple[np.ndarray, int]:
    """The parent array of the fixpoint ``val`` ((S, R_max) on the card)
    from ``root`` over ``arrays``' edges, and the tie rounds it took.
    Returns (int64 (n,) parents, tie rounds).  Raises if a tie round
    parents no vertex while reached ones are left without a parent: at a
    fixpoint every reached vertex has an in-edge that K10's rule takes,
    so that means the fixpoint's values and K10's sums disagree."""
    flat = val.reshape(-1)
    slot_vertex = arrays.slot_vertex.reshape(-1)
    edges = (arrays.edge_src_root_flat.reshape(-1),
             arrays.edge_dst_flat.reshape(-1), arrays.edge_w.reshape(-1),
             arrays.edge_mask.reshape(-1))
    parent = torch.full((part.n,), k10.NONE, dtype=torch.int32,
                        device=val.device)
    k10.tree_parents(flat, *edges, slot_vertex, parent, weighted)
    parent[int(root)] = int(root)
    rounds = 0
    if weighted:              # a unit step never ties: BFS needs no round
        reached = torch.isfinite(flat[arrays.root_flat])
        left = int((reached & (parent == k10.NONE)).sum())
        while left:
            k10.tree_parents(flat, *edges, slot_vertex, parent, weighted,
                             before=parent.clone())
            rounds += 1
            now = int((reached & (parent == k10.NONE)).sum())
            if now == left:
                raise RuntimeError(
                    f"parent tree from {int(root)}: {left} reached "
                    f"vertices have no parent after {rounds} tie rounds")
            left = now
    host = torch.empty(part.n, dtype=torch.int32,
                       pin_memory=val.device.type == "cuda")
    host.copy_(parent.masked_fill_(parent == k10.NONE, -1))
    return host.numpy().astype(np.int64), rounds


def _search(app: str, sem, g: COOGraph, root: int, part, cfg, num_shards,
            rpvo_max, mesh, device):
    dev = engine.resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(f"{app} runs stacked on one device")
    with obs.span("app.call", track="app", app=app, root=int(root)):
        if part is None:
            part = build_partition(
                g, PartitionConfig(num_shards=num_shards, rpvo_max=rpvo_max)
            )
        arrays = engine.device_arrays(part, dev)
        init = engine.init_values(part, sem, {root: 0.0})
        val, stats = engine.run_stacked(sem, part, init, cfg, device=dev,
                                        arrays=arrays)
        with obs.span("app.extract", track="app"):
            values = engine.vertex_values(part, val)
        with obs.span("app.tree", track="app", app=app):
            tree, ties = parents(part, arrays, val, root,
                                 weighted=sem.relax_kind == "add_w")
        m = obs.registry()
        m.counter("tree_passes_total",
                  "parent-tree passes after a fixpoint").labels(app=app).inc()
        m.counter("tree_tie_rounds_total",
                  "tie rounds of the parent-tree passes").labels(
                      app=app).inc(ties)
    return values, tree, stats, part


def bfs_tree(g: COOGraph, root: int, part: Partition | None = None,
             cfg: engine.EngineConfig = engine.EngineConfig(),
             num_shards: int = 16, rpvo_max: int = 1,
             mesh=None, axis_names=("data", "model"), device=None):
    """``apps.bfs`` with its BFS tree: returns ((levels (n,) int64,
    parents (n,) int64), stats, partition); levels as ``apps.bfs`` gives
    them.  Runs stacked on one device (``mesh`` must be None)."""
    lv, tree, stats, part = _search("bfs_tree", actions.BFS, g, root, part,
                                    cfg, num_shards, rpvo_max, mesh, device)
    levels = np.where(np.isfinite(lv), lv, 0).astype(np.int64)
    levels[~np.isfinite(lv)] = UNREACHED
    return (levels, tree), stats, part


def sssp_tree(g: COOGraph, root: int, part: Partition | None = None,
              cfg: engine.EngineConfig = engine.EngineConfig(),
              num_shards: int = 16, rpvo_max: int = 1,
              mesh=None, axis_names=("data", "model"), device=None):
    """``apps.sssp`` with its shortest-path tree: returns ((dist (n,)
    float64, inf where unreachable, parents (n,) int64), stats,
    partition).  Runs stacked on one device (``mesh`` must be None)."""
    dist, tree, stats, part = _search("sssp_tree", actions.SSSP, g, root,
                                      part, cfg, num_shards, rpvo_max, mesh,
                                      device)
    return (dist.astype(np.float64), tree), stats, part
