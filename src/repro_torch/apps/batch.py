"""Lane-batched and multi-source BFS / SSSP.

Built on the query-lane axis (``repro_torch.query.lanes``): a batch of K
source-rooted queries runs as K lanes of one shared fixpoint — mixed
BFS/SSSP batches share one round (BFS lanes relax with unit weights),
and a multi-source query is one lane seeded at several vertices
(distance or level to the *nearest* source).
"""
from __future__ import annotations

from repro_torch.core import engine
from repro_torch.core.partition import Partition, PartitionConfig, build_partition
from repro_torch.graph.graph import COOGraph
from repro_torch.query.lanes import decode_min_values, init_lane_values, \
    run_sharded_lanes, run_stacked_lanes


def _extract(part, val, kinds):
    return [decode_min_values(engine.vertex_values(part, val[..., q]), kind)
            for q, kind in enumerate(kinds)]


def batched_queries(g: COOGraph, queries, part: Partition | None = None,
                    cfg: engine.EngineConfig = engine.EngineConfig(),
                    num_shards: int = 16, rpvo_max: int = 1,
                    mesh=None, axis_names=("data", "model"), device=None):
    """Runs a mixed batch of min-semiring queries as lanes of one shared
    fixpoint.  ``queries``: list of ("bfs" | "sssp", sources) — sources a
    vertex, a list (multi-source), or a {vertex: value} dict.  Returns
    (list of per-query (n,) results — int64 levels for BFS, float64
    distances for SSSP — per-lane ``LaneStats``, partition).
    ``device=None`` runs on CUDA (see ``engine.resolve_device``); ``mesh``
    runs the sharded lanes (``run_sharded_lanes``), every rank making the
    call."""
    dev = engine.resolve_device(device)
    if part is None:
        part = build_partition(
            g, PartitionConfig(num_shards=num_shards, rpvo_max=rpvo_max))
    init, unitw = init_lane_values(part, queries)
    if mesh is None:
        val, stats = run_stacked_lanes(part, init, unitw, cfg, device=dev)
    else:
        val, stats = run_sharded_lanes(part, init, unitw, mesh, axis_names,
                                       cfg, device=dev)
    return _extract(part, val, [k for k, _ in queries]), stats, part


def multi_source_bfs(g: COOGraph, roots, **kw):
    """Level to the nearest of ``roots`` per vertex ((n,) int64)."""
    (levels,), stats, part = batched_queries(g, [("bfs", list(roots))], **kw)
    return levels, stats, part


def multi_source_sssp(g: COOGraph, roots, **kw):
    """Distance to the nearest of ``roots`` per vertex ((n,) float64)."""
    (dist,), stats, part = batched_queries(g, [("sssp", list(roots))], **kw)
    return dist, stats, part
