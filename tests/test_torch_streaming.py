"""The port's streaming mutation against the reference's.

``StreamingGraph`` (and ``DynamicGraph``) of both packages get the same
graph, the same partition config and the same mutation schedule; after
every commit the port's ``CommitInfo`` — its ``SpliceInfo`` and
``MaintStats`` included — equals the reference's exactly, its maintained
BFS/SSSP/CC values bit for bit, and PageRank within the reference test's
tolerance; the values also equal the numpy oracles and a cold port
fixpoint on the spliced partition (bit for bit), and the spliced
partition equals a from-scratch ``build_partition``.  The cases follow
the reference's own (``tests/test_streaming.py``,
``tests/test_dynamic_graph.py``): the runner x launch matrix (the
reference's Pallas kernels in interpret mode, the port's fused path
through the kernels' plain versions), the hypothesis schedule, support
invalidation, the adaptive rhizome split, the pinned cutoff, the
serving hooks (``QueryServer.apply_mutation``), the recorder's mutation
span; plus the scale-8 counter gate's ``stream_*`` legs, and a commit
that grows ``R_max`` under a served lane, so a launch plan kept from
the old partition would show.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as ref_engine  # noqa: E402
from repro.core.dynamic import DynamicGraph as RefDynamicGraph  # noqa: E402
from repro.core.partition import PartitionConfig as RefPCfg  # noqa: E402
from repro.core.streaming import StreamingGraph as RefStreamingGraph  # noqa: E402,E501
from repro.core.streaming import invalidate_unsupported as ref_invalidate  # noqa: E402,E501
from repro.graph import generators as ref_generators  # noqa: E402
from repro.graph.graph import COOGraph as RefCOOGraph  # noqa: E402
from repro.query.server import QueryServer as RefQueryServer  # noqa: E402
from repro.serve.admission import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.dynamic import DynamicGraph  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.core.streaming import (  # noqa: E402
    StreamingGraph, _pr_weights, invalidate_unsupported)
from repro_torch.graph import reference  # noqa: E402
from repro_torch.graph.graph import COOGraph  # noqa: E402
from repro_torch.kernels.fused_relax_reduce import (  # noqa: E402
    fused_relax_reduce_pallas)
from repro_torch.query.server import QueryServer  # noqa: E402
from repro_torch.serve.admission import ServeConfig  # noqa: E402

UNREACHED = np.iinfo(np.int32).max
CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _pg(g) -> COOGraph:
    """The port's copy of a reference graph."""
    return COOGraph(g.n, np.asarray(g.src), np.asarray(g.dst),
                    np.asarray(g.weight))


def _to_levels(lv):
    out = np.full(lv.size, UNREACHED, np.int64)
    fin = np.isfinite(lv)
    out[fin] = lv[fin].astype(np.int64)
    return out


def _canon(lbl):
    m = {}
    out = np.empty(len(lbl), np.int64)
    for i, x in enumerate(lbl):
        out[i] = m.setdefault(x, len(m))
    return out


def _assert_parts_equal(got, want):
    for f in dataclasses.fields(want):
        if f.name in ("cfg", "metrics"):
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _commit_dict(info) -> dict:
    """A ``CommitInfo`` of either package as plain values."""
    return {"inserted": info.inserted, "deleted": info.deleted,
            "mutated_src": np.asarray(info.mutated_src).tolist(),
            "mutated_dst": np.asarray(info.mutated_dst).tolist(),
            "splices": {k: dataclasses.asdict(v)
                        for k, v in info.splices.items()},
            "maint": {k: dataclasses.asdict(v)
                      for k, v in info.maint.items()},
            "replicas_added": info.replicas_added}


def _pair(g, pcfg_kw, cfg_kw=None, runner="stacked", **kw):
    """(reference, port) StreamingGraphs on the same graph and config."""
    cfg_kw = cfg_kw or {}
    ref = RefStreamingGraph(g, RefPCfg(**pcfg_kw),
                            cfg=ref_engine.EngineConfig(**cfg_kw),
                            runner=runner, **kw)
    port = StreamingGraph(_pg(g), PartitionConfig(**pcfg_kw),
                          cfg=engine.EngineConfig(**cfg_kw), runner=runner,
                          device=CPU, **kw)
    return ref, port


def _assert_tracked_equal(ref, port, pr_atol=1e-7):
    assert set(ref.tracked) == set(port.tracked)
    for k in ref.tracked:
        a = np.asarray(ref.tracked[k]["vals"])
        b = np.asarray(port.tracked[k]["vals"])
        if k[0] == "pagerank":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=pr_atol,
                                       err_msg=str(k))
        else:
            np.testing.assert_array_equal(b, a, err_msg=str(k))


def _random_batch(rng, n, k_ins, k_del, g):
    s = rng.integers(0, n, k_ins).astype(np.int32)
    d = rng.integers(0, n, k_ins).astype(np.int32)
    w = rng.integers(1, 10, k_ins).astype(np.float32)
    if k_del and g.num_edges > k_del:
        idx = rng.choice(g.num_edges, k_del, replace=False)
        return (s, d, w), (g.src[idx].copy(), g.dst[idx].copy())
    return (s, d, w), None


def _commit_both(pair, ins, dels):
    infos = []
    for sg in pair:
        if ins is not None:
            sg.insert_edges(*ins)
        if dels is not None:
            sg.delete_edges(*dels)
        infos.append(sg.commit())
    assert _commit_dict(infos[1]) == _commit_dict(infos[0])
    return infos[1]


def _check_all(sg, root, pr_tol):
    """Every tracked result of the port vs a cold oracle on the CURRENT
    graph, and min apps bit-identical vs a cold port run on the SAME
    partition."""
    gf = sg.g
    np.testing.assert_array_equal(
        _to_levels(sg.values("bfs", root)), reference.bfs_levels(gf, root))
    want = reference.sssp_dijkstra(gf, root)
    got = sg.values("sssp", root)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_array_equal(got[fin].astype(np.float32),
                                  want[fin].astype(np.float32))
    if ("cc", None) in sg.tracked:
        np.testing.assert_array_equal(
            _canon(sg.values("cc").tolist()),
            _canon(reference.connected_components(gf).tolist()))
    part = sg.view("base").part
    init = engine.init_values(part, actions.SSSP, {root: 0.0})
    val, _ = engine.run_stacked(actions.SSSP, part, init,
                                engine.EngineConfig(), device=CPU)
    np.testing.assert_array_equal(engine.vertex_values(part, val),
                                  sg.values("sssp", root))
    if ("pagerank", None) in sg.tracked:
        part_pr = build_partition(_pr_weights(gf), sg.pcfg)
        rank_t, _ = engine.run_pagerank_delta(
            part_pr, damping=0.85, tol=pr_tol, cfg=engine.EngineConfig(),
            device=CPU)
        want_pr = engine.vertex_values(part_pr, rank_t)
        err = float(np.abs(sg.values("pagerank") - want_pr).max())
        # each vertex may keep a sub-tol residual per in-edge per run
        assert err < 200 * pr_tol, err


def _drive(pair, rng, root, batches=4, k_ins=8, k_del=4, pr_tol=1e-7):
    ref, port = pair
    for b in range(batches):
        ins, dels = _random_batch(rng, port.g.n, k_ins,
                                  k_del if b % 2 else 0, port.g)
        info = _commit_both(pair, ins, dels)
        _assert_tracked_equal(ref, port)
        _check_all(port, root, pr_tol)
        _assert_parts_equal(port.view("base").part,
                            build_partition(port.g, port.pcfg))
        for ms in info.maint.values():
            assert ms.mode == "warm"


# --------------------------------------------------------------------------
# the differential matrix
# --------------------------------------------------------------------------

MATRIX = [
    # (use_pallas, grid_mode, runner)
    (False, "dense", "stacked"),
    (True, "dense", "stacked"),
    (True, "worklist", "stacked"),
    (True, "device_worklist", "stacked"),
    (False, "dense", "lanes"),          # Q=3 laned maintenance
    (True, "dense", "lanes"),
    (True, "device_worklist", "lanes"),
]


@pytest.mark.parametrize("use_pallas,grid_mode,runner", MATRIX)
def test_mutation_differential(use_pallas, grid_mode, runner):
    g = ref_generators.rmat(6, edge_factor=6, seed=3) \
        .with_random_weights(seed=3)
    pair = _pair(g, dict(num_shards=4, rpvo_max=3, local_edge_list_size=8,
                         seed=9),
                 dict(use_pallas=use_pallas, grid_mode=grid_mode),
                 runner=runner)
    root = int(g.src[0])
    for sg in pair:
        sg.track("bfs", root)
        sg.track("sssp", root)
        if runner == "lanes":
            sg.track("sssp", int(g.dst[0]))   # third lane in the group run
        sg.track("cc")
        sg.track("pagerank", tol=1e-7)
    _assert_tracked_equal(*pair)
    _drive(pair, np.random.default_rng(0), root)


def test_mutation_differential_reduce_mode():
    """``pallas_mode='reduce'`` (the segment reduce K9; its plain version
    on the CPU, the reference's kernel in interpret mode) through the
    same schedule on the stacked runner."""
    g = ref_generators.rmat(6, edge_factor=6, seed=3) \
        .with_random_weights(seed=3)
    pair = _pair(g, dict(num_shards=4, rpvo_max=3, local_edge_list_size=8,
                         seed=9),
                 dict(use_pallas=True, pallas_mode="reduce"))
    root = int(g.src[0])
    for sg in pair:
        sg.track("bfs", root)
        sg.track("sssp", root)
        sg.track("pagerank", tol=1e-7)
    _drive(pair, np.random.default_rng(1), root, batches=2)


def test_mutation_differential_q1_single_lane():
    """Q=1: a single tracked min query still goes through the laned
    group path."""
    g = ref_generators.rmat(6, edge_factor=5, seed=4)
    pair = _pair(g, dict(num_shards=4, rpvo_max=2, local_edge_list_size=8,
                         seed=2), runner="lanes")
    root = int(g.src[0])
    for sg in pair:
        sg.track("bfs", root)
    rng = np.random.default_rng(7)
    for _ in range(3):
        _commit_both(pair, *_random_batch(rng, g.n, 6, 3, pair[1].g))
        _assert_tracked_equal(*pair)
        np.testing.assert_array_equal(
            _to_levels(pair[1].values("bfs", root)),
            reference.bfs_levels(pair[1].g, root))


def test_unported_runner_and_mesh_raise():
    """``runner='sharded'`` with ``mesh=`` (ROADMAP Queue 1 item 10,
    ported) on a one-rank gloo group against the reference's 1-device
    mesh: every commit's tracked values and ``CommitInfo`` equal (a batch
    with deletes included); the sharded runner without a mesh, and an
    unknown runner, raise ``ValueError``."""
    import jax
    from jax.sharding import Mesh
    from torch_dist import single_rank_mesh
    ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    g_ref = ref_generators.rmat(5, edge_factor=4, seed=1) \
        .with_random_weights(seed=1)
    g = _pg(g_ref)
    pcfg = PartitionConfig(num_shards=1, rpvo_max=2)
    with pytest.raises(ValueError, match="mesh="):
        StreamingGraph(g, pcfg, runner="sharded", device=CPU)
    with pytest.raises(ValueError, match="unknown runner"):
        StreamingGraph(g, pcfg, runner="nope", device=CPU)
    root = int(g.src[0])
    with single_rank_mesh() as mesh:
        pair = (RefStreamingGraph(g_ref, RefPCfg(num_shards=1, rpvo_max=2),
                                  runner="sharded", mesh=ref_mesh),
                StreamingGraph(g, pcfg, runner="sharded", mesh=mesh,
                               device=CPU))
        for sg in pair:
            sg.track("bfs", root)
            sg.track("sssp", root)
            sg.track("pagerank", tol=1e-7)
        rng = np.random.default_rng(5)
        for _ in range(2):
            _commit_both(pair, *_random_batch(rng, g.n, 5, 2, pair[1].g))
            _assert_tracked_equal(*pair)


# --------------------------------------------------------------------------
# property-based schedules (hypothesis, when available)
# --------------------------------------------------------------------------

def test_hypothesis_random_schedules():
    pytest.importorskip("hypothesis", reason="hypothesis not installed")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=8, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1),
           scale=st.integers(5, 6),
           batches=st.integers(1, 3))
    def run(seed, scale, batches):
        rng = np.random.default_rng(seed)
        g = ref_generators.rmat(scale, edge_factor=5,
                                seed=seed % 1000).with_random_weights(
                                    seed=seed % 997)
        pair = _pair(g, dict(num_shards=4, rpvo_max=3,
                             local_edge_list_size=8,
                             seed=int(rng.integers(0, 100))))
        root = int(g.src[0])
        for sg in pair:
            sg.track("bfs", root)
            sg.track("sssp", root)
            sg.track("cc")
        for _ in range(batches):
            _commit_both(pair, *_random_batch(
                rng, g.n, int(rng.integers(1, 10)),
                int(rng.integers(0, 6)), pair[1].g))
            _assert_tracked_equal(*pair)
            _check_all(pair[1], root, 1e-7)
            _assert_parts_equal(pair[1].view("base").part,
                                build_partition(pair[1].g, pair[1].pcfg))

    run()


# --------------------------------------------------------------------------
# delete-side support invalidation is sound AND tight
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cut", "alternate"])
def test_invalidate_unsupported_exact_region(case):
    # path 0->1->2->3->4 plus, in 'alternate', an equal-cost edge 0->3
    n = 5
    vals = np.array([0, 1, 2, 3, 4], np.float32)
    pinned = np.zeros(n, bool)
    pinned[0] = True
    if case == "cut":       # delete 2->3: 3 and 4 lose support
        arrs = (np.array([0, 1, 3], np.int32), np.array([1, 2, 4], np.int32),
                np.ones(3, np.float32))
        want = [0, 0, 0, 1, 1]
    else:                   # the alternate path keeps 3 (and so 4)
        arrs = (np.array([0, 1, 0, 3], np.int32),
                np.array([1, 2, 3, 4], np.int32),
                np.array([1, 1, 3, 1], np.float32))
        want = [0, 0, 0, 0, 0]
    got = invalidate_unsupported(COOGraph(n, *arrs), vals, [2], [3], [1.0],
                                 pinned, unit_w=False)
    ref = ref_invalidate(RefCOOGraph(n, *arrs), vals, [2], [3], [1.0],
                         pinned, unit_w=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("unit_w", [True, False])
def test_invalidate_unsupported_random_matches_reference(unit_w):
    """A random weighted graph, its SSSP/BFS fixpoint and a random
    deletion batch: the port's invalidated set equals the reference's
    (the float32 support test is the same), zero weights included."""
    rng = np.random.default_rng(11)
    g = ref_generators.rmat(7, edge_factor=5, seed=2) \
        .with_random_weights(seed=2)
    w = np.asarray(g.weight).copy()
    if not unit_w:
        w[:5] = 0.0          # non-positive weights: the whole-value fallback
    root = int(np.argmax(g.out_degrees()))
    vals = reference.sssp_dijkstra(_pg(g), root).astype(np.float32)
    if unit_w:
        lv = reference.bfs_levels(_pg(g), root).astype(np.float64)
        vals = np.where(lv == UNREACHED, np.inf, lv).astype(np.float32)
    idx = rng.choice(g.num_edges, 12, replace=False)
    keep = np.ones(g.num_edges, bool)
    keep[idx] = False
    args = (g.n, np.asarray(g.src)[keep], np.asarray(g.dst)[keep], w[keep])
    pinned = np.zeros(g.n, bool)
    pinned[root] = True
    dels = (np.asarray(g.src)[idx], np.asarray(g.dst)[idx], w[idx])
    got = invalidate_unsupported(COOGraph(*args), vals, *dels, pinned,
                                 unit_w=unit_w)
    ref = ref_invalidate(RefCOOGraph(*args), vals, *dels, pinned,
                         unit_w=unit_w)
    np.testing.assert_array_equal(got, ref)


def test_deletes_only_relift_affected_region():
    """A delete far from most of the graph re-lifts only its cone:
    warm messages << cold messages, and equal to the reference's."""
    g = ref_generators.rmat(8, edge_factor=8, seed=11)
    pair = _pair(g, dict(num_shards=8, rpvo_max=4, local_edge_list_size=8,
                         seed=1))
    port = pair[1]
    root = int(np.argmax(g.out_degrees()))
    for sg in pair:
        sg.track("bfs", root)
    part = port.view("base").part
    init = engine.init_values(part, actions.BFS, {root: 0.0})
    _, cold = engine.run_stacked(actions.BFS, part, init,
                                 engine.EngineConfig(), device=CPU)
    lv = port.values("bfs", root)
    deep = np.isfinite(lv) & (lv >= np.nanmax(np.where(
        np.isfinite(lv), lv, np.nan)) - 1)
    e = int(np.nonzero(deep[g.dst])[0][0])
    info = _commit_both(pair, None, ([g.src[e]], [g.dst[e]]))
    np.testing.assert_array_equal(
        _to_levels(port.values("bfs", root)),
        reference.bfs_levels(port.g, root))
    assert info.maint[("bfs", root)].messages < int(cold.messages) // 2


# --------------------------------------------------------------------------
# adaptive rhizome growth
# --------------------------------------------------------------------------

def _hub_pair():
    g = ref_generators.erdos_renyi(64, avg_degree=3.0, seed=6)
    return g, _pair(g, dict(num_shards=4, rpvo_max=4,
                            local_edge_list_size=8, seed=3,
                            indegree_cutoff=4))


def _grow_hub(pair, hub, n):
    """Stream edges into ``hub`` until its replica count grows."""
    def replicas(sg):
        return int(sg.view("base").part.num_replicas[hub])

    r0 = replicas(pair[1])
    added = 0
    rng = np.random.default_rng(2)
    while replicas(pair[1]) == r0:
        s = rng.integers(0, n, 4).astype(np.int32)
        info = _commit_both(pair, (s, np.full(4, hub, np.int32)), None)
        added += info.replicas_added
        assert added < 64, "hub never split"
    return r0, added


def test_adaptive_split_matches_from_scratch():
    """The online split gives more replicas for the hub, values and the
    flight recorder's per-round records equal to a from-scratch
    partition of the final graph, each round's planner mirror, and the
    kernel wrapper's ``with_debug`` cell counts equal to the records."""
    g, pair = _hub_pair()
    port = pair[1]
    hub = 7
    root = int(g.src[0])
    for sg in pair:
        sg.track("bfs", root)
    r0, added = _grow_hub(pair, hub, g.n)
    assert added >= 1
    part = port.view("base").part
    assert int(part.num_replicas[hub]) > r0
    cold = build_partition(port.g, port.pcfg)
    _assert_parts_equal(part, cold)
    _assert_tracked_equal(*pair)
    np.testing.assert_array_equal(
        _to_levels(port.values("bfs", root)),
        reference.bfs_levels(port.g, root))

    cfg = engine.EngineConfig(use_pallas=True, grid_mode="worklist")
    recs = {}
    for name, p in (("spliced", part), ("scratch", cold)):
        with obs.recording(keep_frontiers=True) as rec:
            init = engine.init_values(p, actions.BFS, {root: 0.0})
            engine.run_stacked(actions.BFS, p, init, cfg, device=CPU)
        recs[name] = rec
    a, b = recs["spliced"], recs["scratch"]
    assert len(a.rounds) == len(b.rounds) > 0
    for ra, rb in zip(a.rounds, b.rounds):
        assert (ra.messages, ra.frontier, ra.cells, ra.launched,
                ra.tile_dmas, ra.dma_bytes) \
            == (rb.messages, rb.frontier, rb.cells, rb.launched,
                rb.tile_dmas, rb.dma_bytes)
    planner = engine.launch_planner(part, cfg)
    total = part.S * part.R_max
    gval = np.random.default_rng(0).uniform(
        0.0, 5.0, total).astype(np.float32)
    for r, gchg in zip(a.rounds, a.frontiers):
        wl, info = engine.plan_round_worklist(planner, cfg, gchg,
                                              with_info=True)
        assert (r.cells, r.launched) == (info.cells, info.launched)
        _, dbg = fused_relax_reduce_pallas(
            gval, gchg, part.edge_src_root_flat.reshape(-1),
            part.edge_w.reshape(-1).astype(np.float32),
            part.edge_mask.reshape(-1), part.edge_dst_flat.reshape(-1),
            total, actions.BFS.relax_kind, actions.BFS.segment,
            worklist=wl, with_debug=True, device=CPU)
        assert int(dbg[0]) == r.cells


def test_pinned_cutoff_defaults_from_initial_graph():
    g = ref_generators.rmat(6, edge_factor=6, seed=5)
    kw = dict(num_shards=4, rpvo_max=4, local_edge_list_size=8, seed=1)
    ref, port = _pair(g, kw)
    want = max(int(np.ceil(g.in_degrees().max() / 4)), 1)
    assert port.pcfg.indegree_cutoff == ref.pcfg.indegree_cutoff == want
    # pinned config reproduces the unpinned initial partition exactly
    _assert_parts_equal(port.view("base").part,
                        build_partition(_pg(g), PartitionConfig(**kw)))


# --------------------------------------------------------------------------
# serving: mutations between ticks
# --------------------------------------------------------------------------

def _servers(pair, **kw):
    """(reference, port) servers on the pair's base views, bound."""
    ref_kw = {k: (RefServeConfig(**v) if k == "serve" else v)
              for k, v in kw.items()}
    port_kw = {k: (ServeConfig(**v) if k == "serve" else v)
               for k, v in kw.items()}
    out = (RefQueryServer(pair[0].view("base").part, **ref_kw),
           QueryServer(pair[1].view("base").part, device=CPU, **port_kw))
    return out


def _assert_served_equal(srvs):
    ref, port = srvs
    assert set(ref.results) == set(port.results)
    for q, a in ref.results.items():
        b = port.results[q]
        assert (a.kind, a.status, a.rounds, a.messages) \
            == (b.kind, b.status, b.rounds, b.messages), q
        if a.values is None:
            assert b.values is None
        elif a.kind == "ppr":
            np.testing.assert_allclose(b.values, a.values, rtol=1e-4,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(b.values, a.values)
    assert dict(ref.counters) == dict(port.counters)
    assert ref.occupancy_trace == port.occupancy_trace


def _solo(part, kind, root):
    """A solo port run of one min request on ``part``."""
    sem = actions.BFS if kind == "bfs" else actions.SSSP
    init = engine.init_values(part, sem, {root: 0.0})
    val, _ = engine.run_stacked(sem, part, init, engine.EngineConfig(),
                                device=CPU)
    return engine.vertex_values(part, val)


@pytest.mark.parametrize("mode", ["all", "roots"])
def test_server_mutation_between_ticks(mode):
    g = ref_generators.rmat(6, edge_factor=6, seed=3) \
        .with_random_weights(seed=3)
    pair = _pair(g, dict(num_shards=4, rpvo_max=3, local_edge_list_size=8,
                         seed=9))
    srvs = _servers(pair, n_lanes=4)
    for sg, srv in zip(pair, srvs):
        sg.bind_server(srv, cache_invalidation=mode)
    root = int(g.src[0])
    for srv in srvs:
        srv.submit("sssp", [root])
        srv.run()
    rng = np.random.default_rng(5)
    s = rng.integers(0, g.n, 6).astype(np.int32)
    d = rng.integers(0, g.n, 6).astype(np.int32)
    _commit_both(pair, (s, d, rng.integers(1, 10, 6).astype(np.float32)),
                 None)
    assert srvs[1].counters["mutations"] == 1
    for srv in srvs:
        q2 = srv.submit("sssp", [root])
        srv.run()
    _assert_served_equal(srvs)
    want = reference.sssp_dijkstra(pair[1].g, root)
    fin = np.isfinite(want)
    np.testing.assert_allclose(srvs[1].results[q2].values[fin], want[fin],
                               rtol=1e-6)


@pytest.mark.parametrize("grid", ["dense", "device_worklist"])
@pytest.mark.parametrize("has_deletes", [False, True],
                         ids=["insert_warm", "delete_restart"])
def test_server_midflight_mutation(has_deletes, grid):
    """A lane in flight across a commit: insert-only batches migrate its
    state (warm continue), a batch with deletes restarts it; every trace
    equals the reference's, every answer its solo run on the final
    partition, and PPR lanes restart either way (the base view's
    weights are not PageRank's, so the PPR lane runs on a round budget)."""
    g = ref_generators.rmat(7, edge_factor=6, seed=8) \
        .with_random_weights(seed=8)
    pair = _pair(g, dict(num_shards=4, rpvo_max=3, local_edge_list_size=8,
                         seed=4))
    cfg = dict(use_pallas=grid != "dense", grid_mode=grid)
    srvs = (RefQueryServer(pair[0].view("base").part, n_lanes=2,
                           ppr_lanes=1,
                           cfg=ref_engine.EngineConfig(**cfg)),
            QueryServer(pair[1].view("base").part, n_lanes=2, ppr_lanes=1,
                        cfg=engine.EngineConfig(**cfg), device=CPU))
    for sg, srv in zip(pair, srvs):
        sg.bind_server(srv)
    roots = [int(r) for r in np.argsort(-g.out_degrees())[:3]]
    for srv in srvs:
        srv.submit("bfs", [roots[0]])
        srv.submit("sssp", [roots[1]])
        srv.submit("ppr", [roots[2]], tol=1e-7, max_rounds=6)
        srv.step()                      # in flight
    rng = np.random.default_rng(3 if not has_deletes else 9)
    if has_deletes:
        idx = rng.choice(g.num_edges, 6, replace=False)
        batch = (None, (g.src[idx].copy(), g.dst[idx].copy()))
    else:
        batch = ((rng.integers(0, g.n, 5).astype(np.int32),
                  rng.integers(0, g.n, 5).astype(np.int32)), None)
    _commit_both(pair, *batch)
    for srv in srvs:
        srv.run()
    _assert_served_equal(srvs)
    part = pair[1].view("base").part
    res = srvs[1].results
    np.testing.assert_array_equal(
        res[0].values.astype(np.int64), reference.bfs_levels(pair[1].g,
                                                             roots[0]))
    np.testing.assert_array_equal(res[1].values,
                                  _solo(part, "sssp", roots[1]))
    assert res[2].rounds == 6 and res[2].values is not None


def test_server_cache_invalidation_modes():
    g = ref_generators.rmat(6, edge_factor=6, seed=3)
    pair = _pair(g, dict(num_shards=4, rpvo_max=2, local_edge_list_size=8,
                         seed=9))
    srvs = _servers(pair, n_lanes=2, serve=dict(cache_size=16))
    root = int(g.src[0])
    for sg, srv in zip(pair, srvs):
        sg.bind_server(srv, cache_invalidation="all")
        srv.submit("bfs", [root])
        srv.run()
        srv.submit("bfs", [root])
        srv.run()
    port = srvs[1]
    assert port.counters["cache_hits"] >= 1
    hits_before = port.counters["cache_hits"]
    _commit_both(pair, ([int(g.dst[0])], [root]), None)
    assert port.counters["cache_invalidations"] >= 1
    for srv in srvs:
        q3 = srv.submit("bfs", [root])       # must recompute, not hit
        srv.run()
    assert port.counters["cache_hits"] == hits_before
    _assert_served_equal(srvs)
    np.testing.assert_array_equal(
        port.results[q3].values.astype(np.int64),
        reference.bfs_levels(pair[1].g, root))


@pytest.mark.parametrize("grid", ["dense", "device_worklist"])
def test_commit_growing_r_max_rebuilds_every_plan(grid):
    """A commit whose split grows ``R_max``: a served lane in flight, a
    tracked warm query (stacked, fused kernels' plain versions) and the
    server's device tables all move to the new partition.  A launch plan
    or table kept from the old partition would have the old segment
    count; here the values equal cold port runs on the spliced partition
    bit for bit and the reference's traces."""
    g, pair = _hub_pair()
    cfg = dict(use_pallas=True, grid_mode=grid)
    ref, port = pair
    for sg, c in ((ref, ref_engine.EngineConfig(**cfg)),
                  (port, engine.EngineConfig(**cfg))):
        sg.cfg = c
    root = int(g.src[0])
    for sg in pair:
        sg.track("sssp", root)
    srvs = (RefQueryServer(ref.view("base").part, n_lanes=2,
                           cfg=ref_engine.EngineConfig(**cfg)),
            QueryServer(port.view("base").part, n_lanes=2,
                        cfg=engine.EngineConfig(**cfg), device=CPU))
    for sg, srv in zip(pair, srvs):
        sg.bind_server(srv)
        srv.submit("bfs", [root])
        srv.step()
    r_max0 = port.view("base").part.R_max
    _grow_hub(pair, 7, g.n)
    part = port.view("base").part
    assert part.R_max > r_max0
    arrays = srvs[1].min_pool._arrays
    assert arrays.fused_plan.num_segments == part.S * part.R_max
    assert tuple(arrays.slot_valid.shape) == (part.S, part.R_max)
    assert srvs[1].min_pool.val.shape[:2] == (part.S, part.R_max)
    for srv in srvs:
        srv.run()
    _assert_served_equal(srvs)
    _assert_tracked_equal(*pair)
    np.testing.assert_array_equal(port.values("sssp", root),
                                  _solo(part, "sssp", root))
    np.testing.assert_array_equal(
        srvs[1].results[0].values.astype(np.int64),
        reference.bfs_levels(port.g, root))


# --------------------------------------------------------------------------
# flight-recorder wiring
# --------------------------------------------------------------------------

def test_commit_records_mutation_span_and_gauges():
    g = ref_generators.rmat(6, edge_factor=5, seed=2)
    sg = StreamingGraph(_pg(g), PartitionConfig(
        num_shards=4, rpvo_max=2, local_edge_list_size=8, seed=3),
        device=CPU)
    sg.track("bfs", int(g.src[0]))
    with obs.recording() as rec:
        sg.insert_edges([1, 2], [3, 4])
        sg.commit()
    spans = [e for e in rec.tracer._events if e["name"] == "mutation"]
    assert len(spans) == 1
    assert spans[0]["args"]["inserts"] == 2
    text = rec.registry.render_prometheus()
    assert 'stream_mutations_total{kind="insert"} 2' in text
    assert "stream_shards_rebuilt" in text
    assert "stream_affected_vertices" in text
    sec = sg.commit_seconds
    assert set(sec) == {"splice", "prepare", "upload", "fixpoint",
                        "maintain", "servers"}
    assert all(v >= 0 for v in sec.values())
    assert sec["maintain"] == pytest.approx(
        sec["prepare"] + sec["upload"] + sec["fixpoint"])
    assert set(sg.fixpoint_seconds) == {("bfs", int(g.src[0]))}
    assert sec["fixpoint"] == pytest.approx(
        sum(sg.fixpoint_seconds.values()))


@pytest.mark.parametrize("runner", ["stacked", "lanes"])
def test_commit_uploads_each_view_once(monkeypatch, runner):
    """A commit uploads each maintained view once, shares it between the
    view's fixpoints and keeps none of it after the commit."""
    from repro_torch.core import engine as eng
    g = ref_generators.rmat(6, edge_factor=5, seed=2)
    sg = StreamingGraph(_pg(g), PartitionConfig(
        num_shards=4, rpvo_max=2, local_edge_list_size=8, seed=3),
        runner=runner, device=CPU)
    root = int(g.src[0])
    for app in ("bfs", "sssp", "pagerank"):
        sg.track(app, root if app != "pagerank" else None)
    parts = []
    upload = eng.DeviceArrays.from_partition
    monkeypatch.setattr(eng.DeviceArrays, "from_partition", classmethod(
        lambda cls, part, device=None: parts.append(part)
        or upload(part, device)))
    sg.insert_edges([1, 2], [3, 4])
    sg.commit()
    assert parts == [sg.view("base").part, sg.view("pr").part]
    assert sg._arrays == {}
    want = ({"lanes"} if runner == "lanes"
            else {("bfs", root), ("sssp", root)}) | {("pagerank", None)}
    assert set(sg.fixpoint_seconds) == want


# --------------------------------------------------------------------------
# the counter gate's stream_* legs
# --------------------------------------------------------------------------

def test_counter_gate_stream_legs():
    """The six ``stream_*`` legs of ``counter_gate.json`` exactly, run by
    the code ``chip_smoke.py`` phase 3 runs on the card: the algorithmic
    counters (rounds, messages, pruned, per-shard messages, first
    frontier, executed cells, maintenance messages, seeds, invalidated)
    and the splices."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    gate = json.loads(chip_smoke.GATE.read_text())
    got = chip_smoke.stream_gate_legs(np, CPU, gate)
    assert len(got) == 6
    for leg, row in got.items():
        want = gate["runs"][leg]
        for f, v in row.items():
            assert v == want[f], (leg, f, v, want[f])


# --------------------------------------------------------------------------
# DynamicGraph (the paper's §7 insert / delete / warm restart)
# --------------------------------------------------------------------------

def _dyn_pair(g, **pcfg):
    return (RefDynamicGraph.build(g, RefPCfg(**pcfg)),
            DynamicGraph.build(_pg(g), PartitionConfig(**pcfg), device=CPU))


def _stats(st):
    return [int(x) for x in st]


def _path(n):
    src = np.arange(n - 1, dtype=np.int32)
    return RefCOOGraph(n, src, (src + 1).astype(np.int32), None)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["erdos_renyi", "rmat"])
def test_dynamic_insert_then_incremental_bfs(case, use_pallas):
    if case == "rmat":
        g = ref_generators.rmat(9, edge_factor=8, seed=9)
    else:
        g = ref_generators.erdos_renyi(300, avg_degree=3.0, seed=5)
    cfgs = (ref_engine.EngineConfig(use_pallas=use_pallas),
            engine.EngineConfig(use_pallas=use_pallas))
    root = int(np.argmax(g.out_degrees()))
    dgs = _dyn_pair(g, num_shards=8, rpvo_max=4)
    full = [dg.bfs_full(root, cfg=c) for dg, c in zip(dgs, cfgs)]
    np.testing.assert_array_equal(full[1][0], full[0][0])
    assert _stats(full[1][1]) == _stats(full[0][1])
    np.testing.assert_array_equal(full[1][0],
                                  reference.bfs_levels(dgs[1].g, root))
    reached = np.nonzero(full[1][0] != UNREACHED)[0]
    rng = np.random.default_rng(0)
    src = rng.choice(reached, size=10)
    dst = rng.integers(0, g.n, size=10).astype(np.int32)
    inc = []
    for dg, c in zip(dgs, cfgs):
        seeds = dg.insert_edges(src, dst)
        inc.append(dg.bfs_incremental_insert(seeds, cfg=c))
    np.testing.assert_array_equal(inc[1][0], inc[0][0])
    assert _stats(inc[1][1]) == _stats(inc[0][1])
    np.testing.assert_array_equal(inc[1][0],
                                  reference.bfs_levels(dgs[1].g, root))
    # the warm start re-diffuses only the mutation sites
    assert int(inc[1][1].messages) < int(full[1][1].messages)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dynamic_delete_edges_full_recompute(use_pallas):
    n = 14
    dgs = _dyn_pair(_path(n), num_shards=4, rpvo_max=1)
    cfgs = (ref_engine.EngineConfig(use_pallas=use_pallas),
            engine.EngineConfig(use_pallas=use_pallas))
    for dg, c in zip(dgs, cfgs):
        lv0, _ = dg.bfs_full(0, cfg=c)
        assert lv0[-1] == n - 1
        dg.delete_edges([7], [8])
    got = [dg.bfs_full(0, cfg=c) for dg, c in zip(dgs, cfgs)]
    lv1, stats = got[1]
    assert lv1[7] == 7 and lv1[8] == UNREACHED
    np.testing.assert_array_equal(lv1, got[0][0])
    assert _stats(stats) == _stats(got[0][1])
    np.testing.assert_array_equal(lv1, reference.bfs_levels(dgs[1].g, 0))


def test_dynamic_delete_edges_removes_all_copies():
    src = np.array([0, 1, 1, 2, 2, 2, 3], np.int32)
    dst = np.array([1, 2, 2, 3, 3, 4, 4], np.int32)   # dup (1,2) and (2,3)
    dgs = _dyn_pair(RefCOOGraph(10, src, dst, None), num_shards=4,
                    rpvo_max=1)
    for dg in dgs:
        dg.delete_edges([1, 2], [2, 3])
    keep = [(int(s), int(d)) for s, d in zip(dgs[1].g.src, dgs[1].g.dst)]
    assert keep == [(0, 1), (2, 4), (3, 4)]
    assert keep == [(int(s), int(d))
                    for s, d in zip(dgs[0].g.src, dgs[0].g.dst)]


def test_dynamic_delete_invalidates_every_monotone_app():
    n = 8
    dg = DynamicGraph.build(_pg(_path(n)),
                            PartitionConfig(num_shards=4, rpvo_max=1),
                            device=CPU)
    dg.bfs_full(0)
    dg.values["sssp"] = np.zeros(n)     # pretend a cached SSSP/CC state
    dg.values["cc"] = np.zeros(n)
    dg.values["pagerank"] = np.zeros(n)  # sum app: unaffected by the rule
    dg.delete_edges([3], [4])
    assert "bfs" not in dg.values
    assert "sssp" not in dg.values
    assert "cc" not in dg.values
    assert "pagerank" in dg.values
