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
    """Options the port lacks raise, naming the ROADMAP item that brings
    them.  ``pallas_mode='reduce'`` (kernel K9) and ``exchange='compact'``
    have come since: their cases now run and equal the reference
    (``test_torch_segment_reduce.py`` and ``test_torch_compact.py`` hold
    the paths in full).  ``QueryServer`` refuses ``mesh=`` (item 10) and
    ``apply_mutation`` (item 8).  The sharded entry points take the
    reference's parameters and call form (``mesh=`` on the apps, the six
    sharded engine functions) and raise for item 10."""
    g_ref, g, root, part_ref, part = _both("rmat8", 4, 1)
    mesh = object()
    if case in SHARDED_ENGINE_FNS:
        fn = getattr(engine, case)
        want = inspect.signature(getattr(ref_engine, case)).parameters
        assert list(inspect.signature(fn).parameters) == list(want)
        init = engine.init_values(part, actions.BFS, {root: 0.0})
        args = {"make_sharded_fn": (actions.BFS, part.S, part.R_max, mesh),
                "run_sharded": (actions.BFS, part, init, mesh),
                "make_sharded_pagerank_fn": (part.S, part.R_max, g.n, 0.85,
                                             5, mesh),
                "run_pagerank_sharded": (part, 0.85, 5, mesh),
                "make_sharded_pagerank_delta_fn": (part.S, part.R_max, 0.85,
                                                   1e-6, mesh),
                "run_pagerank_delta_sharded": (part, 0.85, 1e-6, mesh)}
        with pytest.raises(NotImplementedError, match=item):
            fn(*args[case], ("data", "model"), engine.EngineConfig())
        return
    if case in ("bfs_mesh", "sssp_mesh"):
        app = case.split("_")[0]
        want = list(inspect.signature(getattr(ref_apps, app)).parameters)
        got = list(inspect.signature(getattr(apps, app)).parameters)
        assert got == want + ["device"]
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
    if case.startswith("server"):
        from repro_torch.query import QueryServer
        if case == "server_mesh":
            with pytest.raises(NotImplementedError, match=item):
                QueryServer(part, n_lanes=1, mesh=mesh, device="cpu")
        else:
            srv = QueryServer(part, n_lanes=1, device="cpu")
            with pytest.raises(NotImplementedError, match=item):
                srv.apply_mutation(part)
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
        return
    calls = {
        "pagerank_mesh": lambda: apps.pagerank(g, part=part, mesh=object(),
                                               device="cpu"),
        # the reference's call form (tests/test_engine_sharded.py)
        "bfs_mesh": lambda: apps.bfs(g, root, num_shards=1, mesh=mesh),
        "sssp_mesh": lambda: apps.sssp(g, root, num_shards=1, mesh=mesh),
    }
    with pytest.raises(NotImplementedError, match=item):
        calls[case]()


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
