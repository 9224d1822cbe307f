"""The port's worklist launches (kernel K2's plain version on the CPU)
against the reference's, on the very same inputs and partitions.

The host planner's plans equal the reference planner's (cells, order,
count and ``WorklistInfo``); the device compaction's cell list equals the
reference's ``plan(dst_filter=False)``; the plain worklist launch equals
the reference's worklist kernel in interpret mode (min bit-equal, sum
within rtol 1e-5 / atol 1e-6: the two sum in different orders); BFS and
SSSP under every grid mode are bit-identical with equal ``RunStats``;
and the six worklist legs of ``counter_gate.json`` are hit exactly.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro import apps as ref_apps  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro.kernels import fused_relax_reduce as ref_frr  # noqa: E402
from repro_torch import apps, interop, obs  # noqa: E402
from repro_torch.apps.pagerank import _pr_graph  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.graph import generators, reference  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

GATE = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" \
    / "baselines" / "counter_gate.json"
EBLK, SBLK = frr.EBLK, frr.SBLK
PAIRS = [("add_w", "min"), ("add_one", "min"), ("mul_w", "sum")]
GRID_MODES = ["worklist", "auto", "device_worklist"]


def _case(v, e, nseg, frac, seed, sorted_ids=True):
    """Sources from a small hub pool, so cells share chunks and the dst
    filter has cells to drop."""
    rng = np.random.default_rng(seed)
    gval = rng.uniform(0.0, 10.0, v).astype(np.float32)
    gchg = rng.random(v) < frac
    src = rng.permutation(v)[rng.integers(0, max(v // 8, 1), e)] \
        .astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    return gval, gchg, src, w, mask, ids


SHAPES = [(1, 1, 1), (127, 300, 50), (257, 2 * EBLK + 13, SBLK + 5),
          (500, 3 * EBLK + 9, 2 * SBLK + 1), (900, 9 * EBLK + 3, 1300)]
FRACS = [0.0, 0.02, 0.5, 1.0]


# --------------------------------------------------------------------------
# planning: host planner and device compaction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dst_filter", [True, False])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_planner_matches_reference(v, e, nseg, frac, sorted_ids,
                                   dst_filter):
    gval, gchg, src, w, mask, ids = _case(v, e, nseg, frac, v + e,
                                          sorted_ids)
    want, want_info = ref_frr.plan_worklist(ids, mask, src, gchg, nseg,
                                            dst_filter=dst_filter)
    got, info = frr.plan_worklist(ids, mask, src, gchg, nseg,
                                  dst_filter=dst_filter)
    for name in ("wl_i", "wl_j", "nlive"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name))
    # the reference's fields, then the rows the tiled kernels stage (none
    # on a pinned plan)
    n = len(want_info._fields)
    assert info._fields[:n] == want_info._fields
    assert info._fields[n:] == ("staged_rows", "staged_bytes")
    assert tuple(info)[:n] == tuple(want_info)
    assert tuple(info)[n:] == (0, 0)


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_planner_auto_threshold_and_mirror(v, e, nseg, frac):
    _, gchg, src, _, mask, ids = _case(v, e, nseg, frac, v + e)
    ref_planner = ref_frr.WorklistPlanner(ids, mask, src, nseg)
    planner = frr.WorklistPlanner(ids, mask, src, nseg)
    assert planner.total_cells == ref_planner.total_cells
    assert planner.live_fraction(gchg) == ref_planner.live_fraction(gchg)
    for thresh in (0.25, 0.6):
        got = planner.plan(gchg, max_live_fraction=thresh)
        want = ref_planner.plan(gchg, max_live_fraction=thresh)
        assert (got[0] is None) == (want[0] is None)
    mirror = frr.fused_grid_cells(ids, mask, src, gchg, nseg)
    d = planner.dense_mirror(gchg)
    assert d["cells"] == ref_planner.dense_mirror(gchg)["cells"] \
        == mirror["fused_live"]
    assert d["launched"] == mirror["launch_cells"] == planner.launch_cells


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_device_compaction_matches_reference_plan(v, e, nseg, frac,
                                                  sorted_ids):
    _, gchg, src, _, mask, ids = _case(v, e, nseg, frac, v + e, sorted_ids)
    want, _ = ref_frr.plan_worklist(ids, mask, src, gchg, nseg,
                                    dst_filter=False)
    t = [torch.as_tensor(x) for x in (gchg, src, mask, ids)]
    got = frr.build_device_worklist(*t, nseg)
    plan = frr.plan_launch(t[1], t[2], t[3], nseg, v)
    assert got.l_pad == frr.device_worklist_pad(plan) >= plan.num_cells
    n = int(want.nlive[0])
    assert int(got.nlive[0]) == n
    np.testing.assert_array_equal(got.wl_i[:n].numpy(), want.wl_i[:n])
    np.testing.assert_array_equal(got.wl_j[:n].numpy(), want.wl_j[:n])
    assert not got.wl_i[n:].any() and not got.wl_j[n:].any()
    # the reference's device list holds the same cells, in the same order
    ref_dev = ref_frr.build_device_worklist(
        *(jnp.asarray(x) for x in (gchg, src, mask, ids)), nseg, "pinned",
        None, v)
    np.testing.assert_array_equal(got.wl_j[:n].numpy(),
                                  np.asarray(ref_dev.wl_j)[:n])


def test_tiled_path_names_its_kernel():
    """The tiled worklist path (kernel K6) plans as the reference's does:
    without a tile width it raises, and a reference tiled plan crosses
    with its cells and tile lists (``test_torch_tiled.py`` holds the
    path in full)."""
    _, gchg, src, _, mask, ids = _case(100, 300, 40, 0.5, 1)
    for mod in (ref_frr, frr):
        with pytest.raises(ValueError, match="vblk"):
            mod.WorklistPlanner(ids, mask, src, 40, path="tiled")
    wl, _ = ref_frr.plan_worklist(ids, mask, src, gchg, 40, path="tiled",
                                  vblk=128)
    got = interop.worklist_from_dict(vars(wl))
    assert got.path == "tiled" and got.vblk == 128
    for name in ("wl_i", "wl_j", "nlive", "cell_ntiles", "cell_tile"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(wl, name))


def test_smem_budget_warns_like_reference():
    _, gchg, src, _, mask, ids = _case(500, 3 * EBLK, 700, 1.0, 2)
    for mod in (ref_frr, frr):
        planner = mod.WorklistPlanner(ids, mask, src, 700,
                                      smem_budget_bytes=16)
        with pytest.warns(UserWarning, match="smem_budget_bytes=16"):
            planner.plan(gchg)


# --------------------------------------------------------------------------
# the plain worklist launch against the reference's worklist kernel
# --------------------------------------------------------------------------

def _launch_both(case, nseg, relax, kind, grid_mode):
    got, count, dbg = frr.fused_relax_reduce(
        *(torch.as_tensor(x) for x in case), nseg, relax, kind,
        with_count=True, with_debug=True, grid_mode=grid_mode)
    want, want_count, want_dbg = ref_frr.fused_relax_reduce_pallas(
        *(jnp.asarray(x) for x in case), nseg, relax, kind, interpret=True,
        with_count=True, with_debug=True, grid_mode=grid_mode)
    return got.numpy(), np.asarray(want), count, want_count, dbg, want_dbg


def _assert_close(got, want, kind):
    if kind == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_worklist_launch_matches_reference(v, e, nseg, relax, kind,
                                           grid_mode):
    case = _case(v, e, nseg, 0.4, seed=v + e + nseg)
    got, want, count, want_count, dbg, want_dbg = _launch_both(
        case, nseg, relax, kind, grid_mode)
    _assert_close(got, want, kind)
    dense = ref.fused_relax_reduce_ref(*(torch.as_tensor(x) for x in case),
                                       nseg, relax, kind).numpy()
    _assert_close(got, dense, kind)
    assert int(count) == int(want_count)
    # executed cells: the planner's cells (host) or the dense live count
    _, info = frr.plan_worklist(case[5], case[4], case[2], case[1], nseg,
                                dst_filter=grid_mode == "worklist")
    assert int(dbg[0]) == int(want_dbg[0]) == info.cells


@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("frac", FRACS)
def test_worklist_frontier_densities(relax, kind, frac):
    case = _case(400, 3 * EBLK + 9, 700, frac, seed=5, sorted_ids=False)
    for grid_mode in ("worklist", "device_worklist"):
        got, want, *_ = _launch_both(case, 700, relax, kind, grid_mode)
        _assert_close(got, want, kind)
        if frac == 0.0:
            assert np.all(got == (np.inf if kind == "min" else 0.0))


@pytest.mark.parametrize("relax,kind", PAIRS)
def test_both_launch_the_same_plan(relax, kind):
    """One reference plan, carried across by ``interop``, drives both
    launches."""
    case = _case(600, 4 * EBLK + 1, 900, 0.3, seed=9)
    wl, _ = ref_frr.plan_worklist(case[5], case[4], case[2], case[1], 900)
    got = frr.fused_relax_reduce(*(torch.as_tensor(x) for x in case), 900,
                                 relax, kind,
                                 worklist=interop.worklist_from_dict(vars(wl)))
    want = ref_frr.fused_relax_reduce_pallas(
        *(jnp.asarray(x) for x in case), 900, relax, kind, interpret=True,
        worklist=wl)
    _assert_close(got.numpy(), np.asarray(want), kind)


def test_plain_worklist_padding_cells_inert():
    """Cells past ``nlive`` and cells whose chunk misses their block hold
    the identity."""
    gval = torch.arange(10, dtype=torch.float32)
    gchg = torch.ones(10, dtype=torch.bool)
    src = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    w = torch.ones(4)
    mask = torch.tensor([True, True, False, True])
    ids = torch.tensor([2, 2, 0, 300], dtype=torch.int32)
    wl_i = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    wl_j = torch.zeros(4, dtype=torch.int32)
    got = ref.fused_relax_reduce_wl_ref(
        gval, gchg, src, w, mask, ids, wl_i, wl_j,
        torch.tensor([2], dtype=torch.int32), 400, "add_w", "min")
    want = torch.full((400,), float("inf"))
    want[2], want[300] = 1.0, 4.0
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# BFS and SSSP under every grid mode, on the very same partition
# --------------------------------------------------------------------------

GRAPHS = {
    "rmat8": (lambda m: m.rmat(8, edge_factor=8, seed=7), 7),
    "rmat9": (lambda m: m.rmat(9, edge_factor=6, seed=1), 1),
    "ba_hub": (lambda m: m.ba_skewed(300, m_per=4, seed=0), 2),
}


def _both(name, shards, rpvo):
    make, seed = GRAPHS[name]
    g_ref = make(ref_generators).with_random_weights(seed=seed)
    g = make(generators).with_random_weights(seed=seed)
    root = int(np.argmax(g.out_degrees()))
    part_ref = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=shards,
                                             rpvo_max=rpvo))
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    return g_ref, g, root, part_ref, part


def _stats(stats):
    return [int(x) for x in stats]


@pytest.mark.parametrize("grid_mode", GRID_MODES)
@pytest.mark.parametrize("app", ["bfs", "sssp"])
@pytest.mark.parametrize("graph,shards,rpvo,collapse", [
    ("rmat8", 4, 4, "eager"), ("rmat9", 8, 4, "deferred"),
    ("rmat9", 4, 1, "eager"), ("ba_hub", 8, 4, "eager")])
def test_app_grid_modes_match_reference(graph, shards, rpvo, collapse, app,
                                        grid_mode):
    g_ref, g, root, part_ref, part = _both(graph, shards, rpvo)
    kw = dict(use_pallas=True, grid_mode=grid_mode, collapse=collapse)
    want, want_stats, _ = getattr(ref_apps, app)(
        g_ref, root, part=part_ref, cfg=ref_engine.EngineConfig(**kw))
    got, stats, _ = getattr(apps, app)(
        g, root, part=part, cfg=engine.EngineConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert _stats(stats) == _stats(want_stats)
    assert all(s.dtype == torch.int64 for s in stats)


@pytest.mark.parametrize("window", [1, 3, 8])
def test_device_windows_count_dispatches_and_cap(window):
    """One dispatch and one host read per window; ``max_iters`` caps the
    rounds inside a window exactly as the reference's loop does."""
    g_ref, g, root, part_ref, part = _both("rmat9", 4, 4)
    reg = obs.registry()
    disp = reg.counter("engine_dispatches_total").labels(run="sssp")
    syncs = reg.counter("engine_host_syncs_total").labels(run="sssp")
    d0, s0 = disp.value, syncs.value
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="device_worklist",
                              device_window=window)
    _, stats, _ = apps.sssp(g, root, part=part, cfg=cfg, device="cpu")
    rounds = int(stats.iterations)
    windows = -(-rounds // window)
    assert disp.value - d0 == windows and syncs.value - s0 == windows
    for cap in (1, rounds - 1):
        kw = dict(use_pallas=True, grid_mode="device_worklist",
                  device_window=window, max_iters=cap)
        want, ws, _ = ref_apps.sssp(g_ref, root, part=part_ref,
                                    cfg=ref_engine.EngineConfig(**kw))
        got, gs, _ = apps.sssp(g, root, part=part,
                               cfg=engine.EngineConfig(**kw), device="cpu")
        np.testing.assert_array_equal(got, want)
        assert _stats(gs) == _stats(ws) and int(gs.iterations) == cap


def test_host_worklist_counts_one_sync_per_frontier_test():
    _, g, root, _, part = _both("rmat8", 4, 4)
    reg = obs.registry()
    disp = reg.counter("engine_dispatches_total").labels(run="bfs")
    syncs = reg.counter("engine_host_syncs_total").labels(run="bfs")
    d0, s0 = disp.value, syncs.value
    _, stats, _ = apps.bfs(g, root, part=part, device="cpu",
                           cfg=engine.EngineConfig(use_pallas=True,
                                                   grid_mode="worklist"))
    it = int(stats.iterations)
    assert disp.value - d0 == it and syncs.value - s0 == it + 1


def test_empty_frontier_runs_dead_window():
    """An empty first frontier: the window's rounds are dead no-ops."""
    _, _, root, part_ref, part = _both("rmat8", 4, 1)
    init = engine.init_values(part, actions.SSSP, {root: 0.0})
    no_chg = np.zeros(init.shape, bool)
    for gm in ("dense", "device_worklist"):
        val, stats = engine.run_stacked(
            actions.SSSP, part, init,
            engine.EngineConfig(use_pallas=True, grid_mode=gm),
            init_changed=no_chg, device="cpu")
        np.testing.assert_array_equal(interop.table_to_numpy(val), init)
        assert _stats(stats) == [0] * 5


def test_fetch_reads_tensors_in_one_copy():
    a = torch.tensor([3, -1, 2**40], dtype=torch.int64)
    b = torch.tensor([[True, False], [False, True]])
    c = torch.tensor([1.5, -2.0], dtype=torch.float32)
    got = engine._fetch(a, b, c)
    for x, y in zip(got, (a, b, c)):
        np.testing.assert_array_equal(x, y.numpy())
        assert x.dtype == y.numpy().dtype


# --------------------------------------------------------------------------
# counter gate: the worklist legs of counter_gate.json, exactly
# --------------------------------------------------------------------------

def _gate_totals(rounds, run):
    rs = [r for r in rounds if r.run == run]
    return {
        "rounds": len(rs),
        "frontier_first": rs[0].frontier if rs else 0,
        "messages": sum(r.messages for r in rs),
        "pruned": sum(r.pruned for r in rs),
        "cells": sum(r.cells for r in rs),
        "launched": sum(r.launched for r in rs),
        "shard_messages": [sum(col) for col in zip(
            *(r.shard_messages for r in rs))],
    }


FIELDS = ["rounds", "messages", "pruned", "shard_messages",
          "frontier_first", "cells"]


@pytest.fixture(scope="module")
def gate():
    gate = json.loads(GATE.read_text())
    gg = gate["graph"]
    g = generators.rmat(gg["scale"], edge_factor=gg["edge_factor"],
                        seed=gg["seed"])
    pcfg = PartitionConfig(num_shards=4, rpvo_max=4)
    return (gate, g, int(np.argmax(g.out_degrees())),
            build_partition(g.with_random_weights(seed=gg["seed"]), pcfg),
            build_partition(_pr_graph(g), pcfg))


@pytest.mark.parametrize("app", ["bfs", "sssp"])
@pytest.mark.parametrize("grid", ["worklist", "device_worklist"])
def test_counter_gate_worklist_legs(gate, app, grid):
    want_all, _, root, part, _ = gate
    sem = actions.BFS if app == "bfs" else actions.SSSP
    with obs.recording() as rec:
        engine.run_stacked(sem, part,
                           engine.init_values(part, sem, {root: 0.0}),
                           engine.EngineConfig(use_pallas=True,
                                               grid_mode=grid),
                           device="cpu")
    got = _gate_totals(rec.rounds, sem.name)
    want = want_all["runs"][f"{app}_{grid}"]
    fields = FIELDS + (["launched"] if grid == "worklist" else [])
    assert {k: got[k] for k in fields} == {k: want[k] for k in fields}
    if grid == "device_worklist":
        assert all(r.window == 1 and r.grid == "device_worklist"
                   for r in rec.rounds)


@pytest.mark.parametrize("grid,leg", [
    ("auto", "pagerank_delta"), ("device_worklist", "pagerank_delta_device")])
def test_counter_gate_pagerank_delta_legs(gate, grid, leg):
    want_all, _, _, _, part_pr = gate
    with obs.recording() as rec:
        engine.run_pagerank_delta(
            part_pr, tol=3e-5, max_rounds=8, device="cpu",
            cfg=engine.EngineConfig(use_pallas=True, grid_mode=grid))
    got = _gate_totals(rec.rounds, "pagerank_delta")
    want = want_all["runs"][leg]
    assert {k: got[k] for k in FIELDS} == {k: want[k] for k in FIELDS}


@pytest.mark.parametrize("app", ["bfs", "sssp"])
def test_recorder_windows_sum_to_host_rounds(gate, app):
    """Per-window records (3-round windows) add up to the host loop's
    per-round records, and the values are the same."""
    _, _, root, part, _ = gate
    sem = actions.BFS if app == "bfs" else actions.SSSP
    init = engine.init_values(part, sem, {root: 0.0})
    out = {}
    for grid in ("dense", "device_worklist"):
        with obs.recording() as rec:
            val, _ = engine.run_stacked(
                sem, part, init,
                engine.EngineConfig(use_pallas=True, grid_mode=grid,
                                    device_window=3), device="cpu")
        out[grid] = (_gate_totals(rec.rounds, sem.name),
                     interop.table_to_numpy(val), len(rec.rounds))
    host, dev = out["dense"], out["device_worklist"]
    np.testing.assert_array_equal(host[1], dev[1])
    assert dev[2] == -(-host[2] // 3)
    for k in ("messages", "pruned", "cells", "shard_messages"):
        assert host[0][k] == dev[0][k]


def test_oracle_levels_under_device_worklist(gate):
    _, g, root, part, _ = gate
    levels, _, _ = apps.bfs(g, root, part=part, device="cpu",
                            cfg=engine.EngineConfig(
                                use_pallas=True,
                                grid_mode="device_worklist"))
    np.testing.assert_array_equal(levels, reference.bfs_levels(g, root))
