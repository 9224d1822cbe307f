"""Port BFS and SSSP against the reference's, on the very same partition.

Values are bit-identical (``inf`` included) and every ``RunStats`` field
is exactly equal, with the relax phase on the plain torch path and on the
fused kernel's path (its plain version, on the CPU), against the
reference's jnp path and its Pallas kernel in interpret mode.  The
scale-8 counter gate's algorithmic fields are hit exactly.
"""
import dataclasses
import inspect
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import apps as ref_apps  # noqa: E402
from repro.apps.pagerank import _pr_graph as _ref_pr_graph  # noqa: E402
from repro.core import actions as ref_actions  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro_torch import apps, interop, obs  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.graph import generators  # noqa: E402

GATE = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" \
    / "baselines" / "counter_gate.json"

GRAPHS = {
    "rmat8": (lambda m: m.rmat(8, edge_factor=8, seed=7), 7),
    "rmat9": (lambda m: m.rmat(9, edge_factor=6, seed=1), 1),
    "ba_hub": (lambda m: m.ba_skewed(300, m_per=4, seed=0), 2),
    "star": (lambda m: m.star(65, inward=False), 4),
}


def _graph(mod, name):
    make, seed = GRAPHS[name]
    g = make(mod).with_random_weights(seed=seed)
    return g, int(np.argmax(g.out_degrees()))


def _both(name, shards, rpvo):
    """(reference graph, port graph, root, reference partition, port
    partition carried across by ``interop``)."""
    g_ref, root = _graph(ref_generators, name)
    g, _ = _graph(generators, name)
    part_ref = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=shards,
                                             rpvo_max=rpvo))
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    return g_ref, g, root, part_ref, part


def _stats(stats):
    return [int(x) for x in stats]


# (graph, shards, rpvo_max, use_pallas, collapse): every graph at 4 and 8
# shards, rpvo_max 1 and 4, on both relax paths; the collapse alternates
CASES = [(g, s, r, p, "eager" if (s + r + p) % 2 else "deferred")
         for g in GRAPHS for s in (4, 8) for r in (1, 4)
         for p in (False, True)]


@pytest.mark.parametrize("app", ["bfs", "sssp"])
@pytest.mark.parametrize("graph,shards,rpvo,use_pallas,collapse", CASES)
def test_app_matches_reference(app, graph, shards, rpvo, use_pallas,
                               collapse):
    g_ref, g, root, part_ref, part = _both(graph, shards, rpvo)
    kw = dict(use_pallas=use_pallas, collapse=collapse)
    want, want_stats, _ = getattr(ref_apps, app)(
        g_ref, root, part=part_ref, cfg=ref_engine.EngineConfig(**kw))
    got, stats, _ = getattr(apps, app)(
        g, root, part=part, cfg=engine.EngineConfig(**kw), device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert _stats(stats) == _stats(want_stats)
    assert all(s.dtype == torch.int64 for s in stats)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_port_partition_builds_the_same_run(use_pallas):
    """apps build their own partition when none is given."""
    g_ref, root = _graph(ref_generators, "rmat8")
    g, _ = _graph(generators, "rmat8")
    cfg = dict(use_pallas=use_pallas)
    want, ws, _ = ref_apps.sssp(g_ref, root, num_shards=4, rpvo_max=4,
                                cfg=ref_engine.EngineConfig(**cfg))
    got, gs, _ = apps.sssp(g, root, num_shards=4, rpvo_max=4,
                           cfg=engine.EngineConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert _stats(gs) == _stats(ws)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_init_changed_seeding_matches_reference(use_pallas):
    """Both frontier seeds: ``init_changed`` re-diffuses only the given
    slots (here the sources plus an arbitrary slot subset)."""
    g_ref, _, root, part_ref, part = _both("rmat9", 4, 4)
    init = ref_engine.init_values(part_ref, ref_actions.SSSP, {root: 0.0})
    np.testing.assert_array_equal(
        engine.init_values(part, actions.SSSP, {root: 0.0}), init)
    rng = np.random.default_rng(0)
    init_changed = (init == 0.0) | (rng.random(init.shape) < 0.1)
    cfg = dict(use_pallas=use_pallas)
    want_val, want_stats = ref_engine.run_stacked(
        ref_actions.SSSP, part_ref, init, ref_engine.EngineConfig(**cfg),
        init_changed=init_changed)
    val, stats = engine.run_stacked(
        actions.SSSP, part, init, engine.EngineConfig(**cfg),
        init_changed=init_changed, device="cpu")
    np.testing.assert_array_equal(interop.table_to_numpy(val),
                                  np.asarray(want_val))
    assert _stats(stats) == _stats(want_stats)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_track_stats_off_matches_reference(use_pallas):
    g_ref, g, root, part_ref, part = _both("rmat8", 4, 4)
    kw = dict(use_pallas=use_pallas, track_stats=False)
    want, ws, _ = ref_apps.bfs(g_ref, root, part=part_ref,
                               cfg=ref_engine.EngineConfig(**kw))
    got, gs, _ = apps.bfs(g, root, part=part, cfg=engine.EngineConfig(**kw),
                          device="cpu")
    np.testing.assert_array_equal(got, want)
    assert _stats(gs) == _stats(ws)
    assert int(gs.messages) == 0 and int(gs.pruned_actions) == 0


def _gate_totals(rounds, run):
    rs = [r for r in rounds if r.run == run]
    return {
        "rounds": len(rs),
        "frontier_first": rs[0].frontier if rs else 0,
        "messages": sum(r.messages for r in rs),
        "pruned": sum(r.pruned for r in rs),
        "cells": sum(r.cells for r in rs),
        "shard_messages": [sum(col) for col in zip(
            *(r.shard_messages for r in rs))],
    }


@pytest.mark.parametrize("use_pallas", [False, True])
def test_counter_gate_dense_legs(use_pallas):
    """benchmarks/baselines/counter_gate.json: bfs_dense and sssp_dense
    at RMAT scale 8 (edge factor 8, seed 7, 4 shards, rpvo_max 4).  The
    kernel path's executed cells equal the reference grid's live cells."""
    gate = json.loads(GATE.read_text())
    gg = gate["graph"]
    g = generators.rmat(gg["scale"], edge_factor=gg["edge_factor"],
                        seed=gg["seed"])
    root = int(np.argmax(g.out_degrees()))
    part = build_partition(g.with_random_weights(seed=gg["seed"]),
                           PartitionConfig(num_shards=4, rpvo_max=4))
    with obs.recording() as rec:
        for sem in (actions.BFS, actions.SSSP):
            engine.run_stacked(sem, part,
                               engine.init_values(part, sem, {root: 0.0}),
                               engine.EngineConfig(use_pallas=use_pallas),
                               device="cpu")
            got = _gate_totals(rec.rounds, sem.name)
            want = gate["runs"][f"{sem.name}_dense"]
            fields = ["rounds", "messages", "pruned", "shard_messages",
                      "frontier_first"] + (["cells"] if use_pallas else [])
            assert {k: got[k] for k in fields} == {k: want[k]
                                                   for k in fields}
            if not use_pallas:
                assert got["cells"] == 0


def test_dispatch_counters_count_rounds():
    g_ref, g, root, part_ref, part = _both("rmat8", 4, 4)
    reg = obs.registry()
    disp = reg.counter("engine_dispatches_total").labels(run="bfs")
    syncs = reg.counter("engine_host_syncs_total").labels(run="bfs")
    d0, s0 = disp.value, syncs.value
    _, stats, _ = apps.bfs(g, root, part=part,
                           cfg=engine.EngineConfig(use_pallas=True),
                           device="cpu")
    it = int(stats.iterations)
    assert disp.value - d0 == it            # one batch of launches a round
    assert syncs.value - s0 == it + 1       # plus the final empty check
    _, stats, _ = apps.bfs(g, root, part=part,
                           cfg=engine.EngineConfig(max_iters=2),
                           device="cpu")
    assert int(stats.iterations) == 2
    assert disp.value - d0 == it + 2 and syncs.value - s0 == it + 3


SHARDED_ENGINE_FNS = ["make_sharded_fn", "run_sharded",
                      "make_sharded_pagerank_fn", "run_pagerank_sharded",
                      "make_sharded_pagerank_delta_fn",
                      "run_pagerank_delta_sharded"]

BAD_FIELDS = [dict(collapse="lazy"), dict(exchange="sparse"),
              dict(pallas_mode="tiled"), dict(vmem_budget_bytes=0),
              dict(grid_mode="sparse"), dict(device_window=0),
              dict(checkpoint_every=0), dict(smem_budget_bytes=-1)]


@pytest.mark.parametrize("bad", BAD_FIELDS, ids=lambda d: next(iter(d)))
def test_engine_config_rejects_like_reference(bad):
    with pytest.raises(ValueError) as want:
        ref_engine.EngineConfig(**bad)
    with pytest.raises(ValueError) as got:
        engine.EngineConfig(**bad)
    assert str(got.value) == str(want.value)


def test_engine_config_fields_and_defaults_match_reference():
    want = {f.name: f.default for f in
            dataclasses.fields(ref_engine.EngineConfig)}
    got = {f.name: f.default for f in dataclasses.fields(engine.EngineConfig)}
    assert got == want


@pytest.mark.parametrize("case,item", [
    ("bfs_compact", "Queue 1 item 4"),
    ("bfs_reduce", "K9"),
    ("pagerank_delta_compact", "Queue 1 item 4"),
    ("pagerank_reduce", "K9"),
    ("server_mesh", "Queue 1 item 10"),
    ("server_apply_mutation", "Queue 1 item 8"),
    ("pagerank_mesh", "Queue 1 item 10"),
    ("bfs_mesh", "Queue 1 item 10"),
    ("sssp_mesh", "Queue 1 item 10"),
] + [(name, "Queue 1 item 10") for name in SHARDED_ENGINE_FNS])
def test_unported_options_raise(case, item):
    """Options the port once lacked, each case named by the ROADMAP item
    that brought it; every one now runs and equals the reference.
    ``pallas_mode='reduce'`` (kernel K9) and ``exchange='compact'``
    (``test_torch_segment_reduce.py`` and ``test_torch_compact.py`` hold
    the paths in full), ``QueryServer.apply_mutation`` (item 8;
    ``test_torch_streaming.py``), and the sharded layout (item 10:
    ``mesh=`` on the apps and ``QueryServer``, the six sharded engine
    functions), each with the reference's parameters and call form, run
    on a one-rank gloo group against the reference's 1-device mesh
    (``test_torch_sharded.py`` holds 8 and 4 ranks)."""
    if item == "Queue 1 item 10":
        _sharded_one_rank(case)
        return
    g_ref, g, root, part_ref, part = _both("rmat8", 4, 1)
    compact = engine.EngineConfig(exchange="compact")
    reduce = engine.EngineConfig(use_pallas=True, pallas_mode="reduce")
    if case.endswith("_compact"):
        ref_cfg = ref_engine.EngineConfig(exchange="compact")
        if case == "bfs_compact":
            want, want_stats, _ = ref_apps.bfs(g_ref, root, part=part_ref,
                                               cfg=ref_cfg)
            got, stats, _ = apps.bfs(g, root, part=part, cfg=compact,
                                     device="cpu")
            np.testing.assert_array_equal(got, want)
        else:
            want, want_stats, _ = ref_apps.pagerank_delta(
                g_ref, num_shards=4, cfg=ref_cfg)
            got, stats, _ = apps.pagerank_delta(g, num_shards=4,
                                                cfg=compact, device="cpu")
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
        assert _stats(stats) == _stats(want_stats)
        return
    if case == "server_apply_mutation":
        from repro.query import QueryServer as RefQueryServer
        from repro_torch.query import QueryServer
        servers = (RefQueryServer(part_ref, n_lanes=1),
                   QueryServer(part, n_lanes=1, device="cpu"))
        for srv, p in zip(servers, (part_ref, part)):
            srv.submit("bfs", root)
            srv.step()
            srv.apply_mutation(p, insert_seeds=[root])
            srv.run()
            assert srv.counters["mutations"] == 1
        want, got = (srv.results[0] for srv in servers)
        np.testing.assert_array_equal(got.values, want.values)
        assert (got.rounds, got.messages) == (want.rounds, want.messages)
        return
    if item == "K9":
        ref_cfg = ref_engine.EngineConfig(use_pallas=True,
                                          pallas_mode="reduce")
        if case == "bfs_reduce":
            want, _, _ = ref_apps.bfs(g_ref, root, part=part_ref,
                                      cfg=ref_cfg)
            got, _, _ = apps.bfs(g, root, part=part, cfg=reduce,
                                 device="cpu")
            np.testing.assert_array_equal(got, want)
        else:
            want, _ = ref_apps.pagerank(g_ref, num_shards=4, cfg=ref_cfg)
            got, _ = apps.pagerank(g, num_shards=4, cfg=reduce,
                                   device="cpu")
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


# the port's sharded entry points add these to the reference's parameters
SHARDED_EXTRA = {"run_sharded": ["device", "arrays"],
                 "run_pagerank_sharded": ["device"],
                 "run_pagerank_delta_sharded": ["device", "arrays"]}


def _sharded_one_rank(case):
    """One case of the sharded layout on a one-rank gloo group (1x1
    mesh) against the reference's 1-device mesh run: min values bit for
    bit and ``RunStats`` exactly, sums within the reference's sharded
    tolerance (rtol 1e-6 / atol 1e-9 of its run)."""
    import jax
    from jax.sharding import Mesh
    from torch_dist import single_rank_mesh
    ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    g_ref, g, root, part_ref, part = _both("rmat8", 1, 1)
    pr_ref = ref_partition.build_partition(
        _ref_pr_graph(g_ref), ref_partition.PartitionConfig(num_shards=1))
    pr = interop.partition_from_dict(dataclasses.asdict(pr_ref))
    cpu = "cpu"
    with single_rank_mesh() as mesh:
        if case in SHARDED_ENGINE_FNS:
            want = list(inspect.signature(getattr(ref_engine,
                                                  case)).parameters)
            got = list(inspect.signature(getattr(engine, case)).parameters)
            assert got == want + SHARDED_EXTRA.get(case, [])
        if case in ("make_sharded_fn", "run_sharded"):
            init = engine.init_values(part, actions.BFS, {root: 0.0})
            want, want_st = ref_engine.run_sharded(
                ref_actions.BFS, part_ref, init, ref_mesh)
            if case == "run_sharded":
                got, st = engine.run_sharded(actions.BFS, part, init, mesh,
                                             device=cpu)
            else:
                fn, sg = engine.make_sharded_fn(actions.BFS, part.S,
                                                part.R_max, mesh)
                assert (sg.rank, sg.size) == (0, 1)
                got, st = fn(engine.DeviceArrays.from_partition(
                    part, cpu, shard=0), torch.as_tensor(init))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert _stats(st) == _stats(want_st)
        elif case in ("make_sharded_pagerank_fn", "run_pagerank_sharded",
                      "pagerank_mesh"):
            want = np.asarray(ref_engine.run_pagerank_sharded(
                pr_ref, 0.85, 12, ref_mesh))
            if case == "make_sharded_pagerank_fn":
                fn, _ = engine.make_sharded_pagerank_fn(
                    pr.S, pr.R_max, pr.n, 0.85, 12, mesh)
                got = fn(engine.DeviceArrays.from_partition(pr, cpu,
                                                            shard=0))
            elif case == "run_pagerank_sharded":
                got = engine.run_pagerank_sharded(pr, 0.85, 12, mesh,
                                                  device=cpu)
            else:
                got, _ = apps.pagerank(g, iters=12, part=pr, mesh=mesh,
                                       device=cpu)
                want = ref_engine.vertex_values(pr_ref, want)
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                                       atol=1e-9)
        elif case == "make_sharded_pagerank_delta_fn":
            fn, _ = engine.make_sharded_pagerank_delta_fn(
                pr.S, pr.R_max, 0.85, 1e-9, mesh)
            ref_fn, sharding = ref_engine.make_sharded_pagerank_delta_fn(
                pr.S, pr.R_max, 0.85, 1e-9, ref_mesh)
            arrays = engine.DeviceArrays.from_partition(pr, cpu, shard=0)
            ref_arrays = jax.tree.map(
                lambda x: jax.device_put(x, sharding),
                ref_engine.DeviceArrays.from_partition(pr_ref))
            base = np.where(pr.slot_vertex >= 0, 0.15 / pr.n,
                            0.0).astype(np.float32)
            rank = delta = torch.as_tensor(base)
            r_rank = r_delta = jax.device_put(base, sharding)
            for _ in range(4):
                rank, delta, counts, work = fn(arrays, rank, delta)
                r_rank, r_delta, r_counts, r_work = ref_fn(
                    ref_arrays, r_rank, r_delta)
                np.testing.assert_allclose(rank.numpy(), np.asarray(r_rank),
                                           rtol=1e-6, atol=1e-9)
                assert (int(counts), int(work)) == (
                    int(np.asarray(r_counts)[0]), int(np.asarray(r_work)[0]))
        elif case == "run_pagerank_delta_sharded":
            want, want_st = ref_engine.run_pagerank_delta_sharded(
                pr_ref, 0.85, 1e-9, ref_mesh)
            got, st = engine.run_pagerank_delta_sharded(pr, 0.85, 1e-9, mesh,
                                                        device=cpu)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
            assert _stats(st)[:2] == _stats(want_st)[:2]
        elif case in ("bfs_mesh", "sssp_mesh"):
            app = case.split("_")[0]
            want = list(inspect.signature(getattr(ref_apps, app)).parameters)
            got = list(inspect.signature(getattr(apps, app)).parameters)
            assert got == want + ["device"]
            # the reference's call form (tests/test_engine_sharded.py)
            want, want_st, _ = getattr(ref_apps, app)(
                g_ref, root, num_shards=1, mesh=ref_mesh)
            got, st, _ = getattr(apps, app)(g, root, num_shards=1,
                                            mesh=mesh, device=cpu)
            np.testing.assert_array_equal(got, want)
            assert _stats(st) == _stats(want_st)
        else:                                         # server_mesh
            from repro.query import QueryServer as RefQueryServer
            from repro_torch.query import QueryServer
            servers = (RefQueryServer(part_ref, n_lanes=1, mesh=ref_mesh),
                       QueryServer(part, n_lanes=1, mesh=mesh, device=cpu))
            for srv in servers:
                srv.submit("bfs", root)
                srv.submit("sssp", root)
                srv.run()
            for q in (0, 1):
                want, got = (srv.results[q] for srv in servers)
                np.testing.assert_array_equal(got.values, want.values)
                assert (got.rounds, got.messages, got.exchanged) == (
                    want.rounds, want.messages, want.exchanged)


def test_grid_mode_is_moot_without_kernel():
    """Like the reference, grid_mode only shapes the kernel launch: the
    plain path runs any value."""
    g_ref, g, root, part_ref, part = _both("rmat8", 4, 1)
    want, _, _ = ref_apps.bfs(g_ref, root, part=part_ref,
                              cfg=ref_engine.EngineConfig(grid_mode="auto"))
    got, _, _ = apps.bfs(g, root, part=part,
                         cfg=engine.EngineConfig(grid_mode="auto"),
                         device="cpu")
    np.testing.assert_array_equal(got, want)


def test_semiring_without_kernel_form_rejected():
    _, _, root, part_ref, part = _both("rmat8", 4, 1)
    init = engine.init_values(part, actions.SSSP, {root: 0.0})
    for sem, eng, p in (
            (dataclasses.replace(ref_actions.SSSP, relax_kind=None),
             ref_engine, part_ref),
            (dataclasses.replace(actions.SSSP, relax_kind=None), engine,
             part)):
        kw = {} if eng is ref_engine else {"device": "cpu"}
        with pytest.raises(ValueError, match="no kernel relax form"):
            eng.run_stacked(sem, p, init, eng.EngineConfig(use_pallas=True),
                            **kw)


def test_sum_semiring_rejected_like_reference():
    _, _, _, part_ref, part = _both("rmat8", 4, 1)
    init = engine.init_values(part, actions.PAGERANK, {})
    with pytest.raises(ValueError, match="min-semiring"):
        ref_engine.run_stacked(ref_actions.PAGERANK, part_ref, init)
    with pytest.raises(ValueError, match="min-semiring"):
        engine.run_stacked(actions.PAGERANK, part, init, device="cpu")
