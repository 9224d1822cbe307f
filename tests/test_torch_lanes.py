"""The port's lane-batched kernels (K3, K4: their plain versions on the
CPU) and lane runners against the reference's, on the same inputs.

The laned fused relax equals the reference's laned Pallas kernel in
interpret mode — dense, host worklist and device worklist; min
bit-equal, sum within rtol 1e-5 / atol 1e-6 (the two sum in different
orders); per-lane counts and executed cells equal.  ``run_stacked_lanes``
/ ``batched_queries`` give bit-identical values and exactly equal
``LaneStats`` under every ``grid_mode``, with and without the kernel
path, and a ``lane_budget`` freezes a lane exactly as the reference's
does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro import apps as ref_apps  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro.kernels import fused_relax_reduce as ref_frr  # noqa: E402
from repro.query import lanes as ref_lanes  # noqa: E402
from repro_torch import apps, exchange, interop, obs  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.query import lanes  # noqa: E402

EBLK, SBLK = frr.EBLK, frr.SBLK
PAIRS = [("add_w", "min"), ("mul_w", "sum")]
GRID_MODES = ["dense", "worklist", "auto", "device_worklist"]
# the reference's laned kernel shapes (test_query_lanes.py), plus Q = 33:
# more lanes than one of the port's 32-lane groups
SHAPES = [(1, 1, 1, 1), (60, 90, 40, 3), (200, EBLK + 7, 300, 5),
          (200, EBLK + 7, 300, 33)]


def _lane_case(v, e, nseg, q, frac, seed):
    rng = np.random.default_rng(seed)
    gval = rng.uniform(0.0, 10.0, (v, q)).astype(np.float32)
    gchg = rng.random((v, q)) < frac
    unitw = (rng.random(q) < 0.5).astype(np.int32)
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = np.sort(rng.integers(0, nseg, e).astype(np.int32))
    return gval, gchg, unitw, src, w, mask, ids


def _assert_close(got, want, kind):
    if kind == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the laned fused relax against the reference's laned kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg,q", SHAPES)
def test_lanes_kernel_matches_reference(v, e, nseg, q, relax, kind,
                                        grid_mode):
    case = _lane_case(v, e, nseg, q, 0.4, seed=e + q)
    got, count, dbg = frr.fused_relax_reduce_lanes(
        *(torch.as_tensor(x) for x in case), nseg, relax, kind,
        with_count=True, with_debug=True, grid_mode=grid_mode)
    want, want_count, want_dbg = ref_frr.fused_relax_reduce_lanes_pallas(
        *(jnp.asarray(x) for x in case), nseg, relax, kind, interpret=True,
        with_count=True, with_debug=True, grid_mode=grid_mode)
    _assert_close(got.numpy(), np.asarray(want), kind)
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    assert int(dbg[0]) == int(want_dbg[0])
    plain = ref.fused_relax_reduce_lanes_ref(
        *(torch.as_tensor(x) for x in case), nseg, relax, kind)
    _assert_close(got.numpy(), plain.numpy(), kind)


@pytest.mark.parametrize("q", [1, 5, 33])
def test_lane_columns_equal_single_lane_runs(q):
    """No lane padding and no cross-lane leakage: each column of a Q-lane
    launch equals that lane launched alone, for every launch shape."""
    gval, gchg, unitw, src, w, mask, ids = _lane_case(
        300, 3 * EBLK + 5, 600, q, 0.3, seed=q)
    t = [torch.as_tensor(x) for x in (src, w, mask, ids)]
    for grid_mode in ("dense", "worklist", "device_worklist"):
        full = frr.fused_relax_reduce_lanes(
            torch.as_tensor(gval), torch.as_tensor(gchg),
            torch.as_tensor(unitw), *t, 600, "add_w", "min",
            grid_mode=grid_mode)
        for lane in range(q):
            one = frr.fused_relax_reduce_lanes(
                torch.as_tensor(gval[:, lane:lane + 1]),
                torch.as_tensor(gchg[:, lane:lane + 1]),
                torch.as_tensor(unitw[lane:lane + 1]), *t, 600, "add_w",
                "min", grid_mode=grid_mode)
            assert torch.equal(full[:, lane:lane + 1], one)


def test_lanes_kernel_converged_lane_is_inert():
    """A lane with an all-False frontier column contributes the identity
    everywhere and counts no message, while live lanes still reduce."""
    gval, gchg, unitw, src, w, mask, ids = _lane_case(
        120, 2 * EBLK + 3, 150, 4, 0.5, seed=9)
    gchg[:, 2] = False
    case = (gval, gchg, unitw, src, w, mask, ids)
    for grid_mode in ("dense", "worklist", "device_worklist"):
        got, counts = frr.fused_relax_reduce_lanes(
            *(torch.as_tensor(x) for x in case), 150, "add_w", "min",
            with_count=True, grid_mode=grid_mode)
        assert torch.all(got[:, 2] == np.inf) and int(counts[2]) == 0
        assert torch.isfinite(got[:, [0, 1, 3]]).any()
        want = ref_frr.fused_relax_reduce_lanes_pallas(
            *(jnp.asarray(x) for x in case), 150, "add_w", "min",
            interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lanes_chunk_bit_is_or_across_lanes():
    """The chunk frontier bit is the OR across lanes; counts are per
    lane — the reference's laned chunk tables on the same frontier."""
    v, q = 64, 3
    e = 2 * EBLK
    rng = np.random.default_rng(3)
    src = rng.integers(0, v, e).astype(np.int32)
    ids = np.sort(rng.integers(0, 50, e)).astype(np.int32)
    gchg = np.zeros((v, q), bool)
    gchg[src[:EBLK], 0] = True          # lane 0 live only in chunk 0
    gchg[src[EBLK:], 1] = True          # lane 1 live only in chunk 1
    mask = np.ones(e, bool)
    for frontier in (gchg, np.zeros((v, q), bool)):
        act, counts = frr._lane_chunk_tables(
            torch.as_tensor(src), torch.as_tensor(mask),
            torch.as_tensor(frontier))
        _, _, want_act, want_counts, _ = ref_frr._chunk_tables_lanes(
            jnp.asarray(ids), jnp.asarray(src),
            jnp.ones(e, jnp.int32), jnp.asarray(frontier.astype(np.int32)))
        np.testing.assert_array_equal(act.numpy(),
                                      np.asarray(want_act) > 0)
        np.testing.assert_array_equal(counts.numpy(),
                                      np.asarray(want_counts))
    assert act.tolist() == [False, False]


def test_lanes_kernel_rejects_bad_pairings():
    case = [torch.as_tensor(x)
            for x in _lane_case(30, 50, 20, 2, 0.5, seed=1)]
    with pytest.raises(ValueError, match="non-absorbing"):
        frr.fused_relax_reduce_lanes(*case, 20, "add_w", "sum")
    with pytest.raises(ValueError, match="lane_unitw"):
        frr.fused_relax_reduce_lanes(*case, 20, "add_one", "min")
    with pytest.raises(ValueError, match=r"\(V, Q\)"):
        frr.fused_relax_reduce_lanes(case[0][:, 0], case[1][:, 0],
                                     *case[2:], 20, "add_w", "min")


@pytest.mark.parametrize("relax,kind", PAIRS)
def test_plain_worklist_lanes_equals_dense_on_planned_cells(relax, kind):
    """K4's plain version over a planned worklist (host, dst-filtered, or
    the device compaction) equals the dense plain version; a worklist
    that omits live cells drops exactly their edges."""
    gval, gchg, unitw, src, w, mask, ids = _lane_case(
        500, 4 * EBLK + 9, 900, 6, 0.2, seed=21)
    t = [torch.as_tensor(x) for x in (gval, gchg, unitw, src, w, mask, ids)]
    dense = ref.fused_relax_reduce_lanes_ref(*t, 900, relax, kind)
    for dst_filter in (True, False):
        wl, _ = frr.plan_worklist(ids, mask, src, gchg, 900,
                                  dst_filter=dst_filter)
        got = ref.fused_relax_reduce_wl_lanes_ref(
            *t, wl.wl_i, wl.wl_j, wl.nlive, 900, relax, kind)
        _assert_close(got.numpy(), dense.numpy(), kind)
    empty = ref.fused_relax_reduce_wl_lanes_ref(
        *t, wl.wl_i, wl.wl_j, torch.zeros(1, dtype=torch.int32), 900, relax,
        kind)
    assert torch.all(empty == (np.inf if kind == "min" else 0.0))


# --------------------------------------------------------------------------
# lane runners against the reference's
# --------------------------------------------------------------------------

def _mixed_workload(seed=4):
    """The reference's mixed BFS/SSSP workload (test_query_lanes.py), on
    one partition shared by both packages."""
    g_ref = ref_generators.rmat(8, edge_factor=4, seed=seed) \
        .with_random_weights(seed=seed)
    g = generators.rmat(8, edge_factor=4, seed=seed) \
        .with_random_weights(seed=seed)
    deg = np.argsort(-g.out_degrees())
    roots = [int(deg[i]) for i in (0, 1, 2, 7)]
    queries = [("bfs", roots[0]), ("sssp", roots[1]),
               ("bfs", roots[2]), ("sssp", roots[3])]
    part_ref = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=4, rpvo_max=2))
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    return g_ref, g, queries, part_ref, part


def _lane_stats(stats):
    return {f: [int(x) for x in np.asarray(getattr(stats, f))]
            for f in stats._fields}


@pytest.mark.parametrize("grid_mode", GRID_MODES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_lane_batch_matches_reference(use_pallas, grid_mode):
    g_ref, g, queries, part_ref, part = _mixed_workload()
    kw = dict(use_pallas=use_pallas, grid_mode=grid_mode)
    want, want_stats, _ = ref_apps.batched_queries(
        g_ref, queries, part=part_ref, cfg=ref_engine.EngineConfig(**kw))
    got, stats, _ = apps.batched_queries(
        g, queries, part=part, cfg=engine.EngineConfig(**kw), device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _lane_stats(stats) == _lane_stats(want_stats)
    assert all(s.dtype == torch.int64 for s in stats)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_lane_batch_bit_identical_to_solo_runs(use_pallas):
    """Each lane equals its solo ``apps.bfs``/``apps.sssp`` run, and its
    rounds and messages equal the solo ``RunStats``."""
    _, g, queries, _, part = _mixed_workload()
    cfg = engine.EngineConfig(use_pallas=use_pallas)
    res, stats, _ = apps.batched_queries(g, queries, part=part, cfg=cfg,
                                         device="cpu")
    for q, ((kind, root), got) in enumerate(zip(queries, res)):
        solo, solo_stats, _ = getattr(apps, kind)(g, root, part=part,
                                                  cfg=cfg, device="cpu")
        np.testing.assert_array_equal(got, solo)
        assert int(stats.rounds[q]) == int(solo_stats.iterations)
        assert int(stats.messages[q]) == int(solo_stats.messages)


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
def test_lane_budget_freezes_like_reference(grid_mode):
    g_ref, g, queries, part_ref, part = _mixed_workload()
    init, unitw = lanes.init_lane_values(part, queries)
    budget = np.array([2, 100, 1, 3])
    kw = dict(use_pallas=True, grid_mode=grid_mode)
    want, want_stats = ref_lanes.run_stacked_lanes(
        part_ref, init, unitw, ref_engine.EngineConfig(**kw),
        lane_budget=budget)
    got, stats = lanes.run_stacked_lanes(
        part, init, unitw, engine.EngineConfig(**kw), lane_budget=budget,
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _lane_stats(stats) == _lane_stats(want_stats)
    assert [int(x) for x in stats.rounds] == [2, 9, 1, 3]


@pytest.mark.parametrize("grid_mode", ["dense", "device_worklist"])
def test_init_changed_and_max_iters_like_reference(grid_mode):
    """A seeded first frontier and a round cap give the reference's
    values and stats."""
    g_ref, g, queries, part_ref, part = _mixed_workload(seed=6)
    init, unitw = lanes.init_lane_values(part, queries)
    seeded = init < np.inf
    seeded[..., 1] = False                   # lane 1 starts converged
    for cap in (3, 4096):
        kw = dict(use_pallas=True, grid_mode=grid_mode, max_iters=cap,
                  device_window=2)
        want, want_stats = ref_lanes.run_stacked_lanes(
            part_ref, init, unitw, ref_engine.EngineConfig(**kw),
            init_changed=seeded)
        got, stats = lanes.run_stacked_lanes(
            part, init, unitw, engine.EngineConfig(**kw),
            init_changed=seeded, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert _lane_stats(stats) == _lane_stats(want_stats)


def test_lane_runner_rejects_unsupported_configs():
    """The reference's errors (test_query_lanes.py), for the port."""
    g = generators.ring(16)
    part = build_partition(g, PartitionConfig(num_shards=2))
    init = np.full((part.S, part.R_max, 1), np.inf, np.float32)
    with pytest.raises(ValueError, match="eager"):
        lanes.run_stacked_lanes(part, init, device="cpu",
                                cfg=engine.EngineConfig(collapse="deferred"))
    with pytest.raises(ValueError, match="fused-only"):
        lanes.run_stacked_lanes(part, init, device="cpu",
                                cfg=engine.EngineConfig(
                                    use_pallas=True, pallas_mode="reduce"))
    with pytest.raises(ValueError, match="min-semiring"):
        lanes.run_stacked_lanes(part, init, sem=actions.PAGERANK,
                                device="cpu")
    with pytest.raises(ValueError, match="lane_unitw"):
        lanes.run_stacked_lanes(part, init, sem=actions.BFS, device="cpu")
    with pytest.raises(ValueError, match=r"\(S, R_max, Q\)"):
        lanes.run_stacked_lanes(part, init[..., 0], device="cpu")
    # the compact exchange runs now, as the reference's does
    part_ref = ref_partition.build_partition(
        ref_generators.ring(16), ref_partition.PartitionConfig(num_shards=2))
    seeded, unitw = lanes.init_lane_values(part, [("bfs", 0), ("sssp", 3)])
    want, want_stats = ref_lanes.run_stacked_lanes(
        part_ref, seeded, unitw,
        cfg=ref_engine.EngineConfig(exchange="compact"))
    got, stats = lanes.run_stacked_lanes(
        part, seeded, unitw, device="cpu",
        cfg=engine.EngineConfig(exchange="compact"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _lane_stats(stats) == _lane_stats(want_stats)
    _sharded_lanes_one_rank()


def _sharded_lanes_one_rank():
    """The five sharded lane runners and ``batched_queries(mesh=)`` on a
    one-rank gloo group (1x1 mesh) against the reference's on its
    1-device mesh: min lanes bit for bit with equal ``LaneStats``, PPR
    rounds within rtol 1e-6 / atol 1e-9 with equal counts
    (``test_torch_sharded.py`` holds 8 and 4 ranks)."""
    import jax
    from jax.sharding import Mesh
    from repro.apps.pagerank import _pr_graph as ref_pr_graph
    from torch_dist import single_rank_mesh
    ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    g_ref = ref_generators.rmat(7, edge_factor=4, seed=3) \
        .with_random_weights(seed=3)
    g = generators.rmat(7, edge_factor=4, seed=3).with_random_weights(seed=3)
    one = ref_partition.PartitionConfig(num_shards=1, rpvo_max=2)
    part_ref = ref_partition.build_partition(g_ref, one)
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    pr_ref = ref_partition.build_partition(ref_pr_graph(g_ref), one)
    pr = interop.partition_from_dict(dataclasses.asdict(pr_ref))
    deg = np.argsort(-g.out_degrees())
    queries = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
               ("sssp", int(deg[4]))]
    seeded, unitw = lanes.init_lane_values(part, queries)
    with single_rank_mesh() as mesh:
        want, want_st = ref_lanes.run_sharded_lanes(part_ref, seeded, unitw,
                                                    mesh=ref_mesh)
        got, st = lanes.run_sharded_lanes(part, seeded, unitw, mesh=mesh,
                                          device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert _lane_stats(st) == _lane_stats(want_st)
        arrays = engine.DeviceArrays.from_partition(part, "cpu", shard=0)
        fn, sg = lanes.make_sharded_lanes_fn(part.S, part.R_max, 3, mesh)
        val, st = fn(arrays, torch.as_tensor(seeded), unitw)
        np.testing.assert_array_equal(val.numpy(), np.asarray(want))
        assert _lane_stats(st) == _lane_stats(want_st)
        # one round of each sharded pool round against the reference's
        rnd, _ = lanes.make_sharded_min_round(part.S, part.R_max, mesh)
        ref_rnd, sharding = ref_lanes.make_sharded_min_round(
            part.S, part.R_max, ref_mesh)
        ref_arrays = jax.tree.map(
            lambda x: jax.device_put(x, sharding),
            ref_engine.DeviceArrays.from_partition(part_ref))
        chg = np.isfinite(seeded) & (part.slot_vertex >= 0)[..., None]
        v, c, n = rnd(arrays, torch.as_tensor(seeded), torch.as_tensor(chg),
                      torch.as_tensor(unitw))
        rv, rc, rn = ref_rnd(ref_arrays, seeded, chg, unitw)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(n.numpy(), np.asarray(rn)[0])
        seeds, damp = [int(deg[0]), int(deg[3])], np.float32([0.85, 0.6])
        base = lanes.ppr_base_table(pr, seeds, damp)
        pr_arrays = engine.DeviceArrays.from_partition(pr, "cpu", shard=0)
        ref_pr_arrays = jax.tree.map(
            lambda x: jax.device_put(x, sharding),
            ref_engine.DeviceArrays.from_partition(pr_ref))
        live = np.ones(2, bool)
        ppr, _ = lanes.make_sharded_ppr_round(pr.S, pr.R_max, mesh)
        ref_ppr, _ = ref_lanes.make_sharded_ppr_round(pr.S, pr.R_max,
                                                      ref_mesh)
        v, d, n = ppr(pr_arrays, torch.as_tensor(base), torch.as_tensor(base),
                      torch.as_tensor(damp), torch.as_tensor(live))
        rv, rd, rn = ref_ppr(ref_pr_arrays, base, base, damp, live)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(d.numpy(), np.asarray(rd)[0], rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_array_equal(n.numpy(), np.asarray(rn)[0])
        tol = np.float32([1e-7, 1e-7])
        dppr, _ = lanes.make_sharded_ppr_delta_round(pr.S, pr.R_max, mesh)
        ref_dppr, _ = ref_lanes.make_sharded_ppr_delta_round(
            pr.S, pr.R_max, ref_mesh)
        out = dppr(pr_arrays, torch.as_tensor(base), torch.as_tensor(base),
                   torch.as_tensor(damp), torch.as_tensor(tol))
        ref_out = ref_dppr(ref_pr_arrays, base, base, damp, tol)
        for a, b in zip(out[:2], ref_out[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref_out[2]))
        np.testing.assert_array_equal(out[3].numpy(),
                                      np.asarray(ref_out[3])[0])
        want, want_st, _ = ref_apps.batched_queries(
            g_ref, queries, part=part_ref, mesh=ref_mesh)
        got, st, _ = apps.batched_queries(g, queries, part=part, mesh=mesh,
                                          device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert _lane_stats(st) == _lane_stats(want_st)


def test_converged_lane_stays_frozen_across_extra_rounds():
    """Drive the laned round past one lane's convergence: the converged
    column stays bit-stable while the other lane keeps relaxing."""
    g = generators.ring(64).with_random_weights(seed=0)
    part = build_partition(g, PartitionConfig(num_shards=4, rpvo_max=1))
    init, unitw = lanes.init_lane_values(
        part, [("bfs", {v: 0.0 for v in range(64)}), ("bfs", 0)])
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    val = torch.as_tensor(init)
    chg = actions.SSSP.improved(val, torch.full_like(val, np.inf)) \
        & arrays.slot_valid[..., None]
    cfg = engine.EngineConfig(use_pallas=True)
    frozen = None
    for rnd in range(6):
        val, chg, _ = exchange.fixpoint_round_stacked(
            actions.SSSP, arrays, cfg, part.S, part.R_max, val, chg,
            torch.as_tensor(unitw))
        if rnd == 0:
            assert not bool(chg[..., 0].any())
            frozen = val[..., 0].clone()
        else:
            assert torch.equal(val[..., 0], frozen)
            assert bool(chg[..., 1].any())


def test_lane_loops_count_dispatches_and_syncs():
    """One dispatch per round and one host sync per frontier test on
    host-driven loops; one of each per window under device_worklist."""
    _, g, queries, _, part = _mixed_workload()
    init, unitw = lanes.init_lane_values(part, queries)
    reg = obs.registry()
    disp = reg.counter("engine_dispatches_total").labels(run="lanes_min")
    syncs = reg.counter("engine_host_syncs_total").labels(run="lanes_min")
    for grid_mode, window in (("dense", 8), ("worklist", 8),
                              ("device_worklist", 3)):
        d0, s0 = disp.value, syncs.value
        _, stats = lanes.run_stacked_lanes(
            part, init, unitw, device="cpu",
            cfg=engine.EngineConfig(use_pallas=True, grid_mode=grid_mode,
                                    device_window=window))
        rounds = int(stats.rounds.max())
        if grid_mode == "device_worklist":
            windows = -(-rounds // window)
            assert (disp.value - d0, syncs.value - s0) == (windows, windows)
        else:
            assert (disp.value - d0, syncs.value - s0) == (rounds,
                                                           rounds + 1)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ppr_delta_error_at_tol_1e8_no_larger_than_reference(use_pallas):
    """The open check on the PPR error at tol 1e-8: the reference's and
    the port's ``run_ppr_delta_lanes`` against one float64 power
    iteration.  Both leave errors above atol 1e-7 at this tolerance (the
    dropped sub-tolerance residuals: the algorithm's, not the port's);
    the port's per-lane error is never the larger (within 1e-9 of float32
    summation noise) and its lanes run the same rounds."""
    from repro.apps.pagerank import _pr_graph as ref_pr_graph
    from repro.graph import reference as ref_reference
    g = ref_generators.rmat(9, edge_factor=8, seed=5)
    part_ref = ref_partition.build_partition(
        ref_pr_graph(g),
        ref_partition.PartitionConfig(num_shards=8, rpvo_max=4))
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    deg = np.argsort(-g.out_degrees())
    seeds = [int(deg[i]) for i in (0, 1, 5, 20)]
    damp = [0.85, 0.7, 0.6, 0.5]
    want = np.stack([ref_reference.personalized_pagerank(g, s, d, tol=1e-12)
                     for s, d in zip(seeds, damp)], axis=-1)
    ref_val, ref_st = ref_lanes.run_ppr_delta_lanes(
        part_ref, seeds, damp, tol=1e-8,
        cfg=ref_engine.EngineConfig(use_pallas=use_pallas))
    val, st = lanes.run_ppr_delta_lanes(
        part, seeds, damp, tol=1e-8, device="cpu",
        cfg=engine.EngineConfig(use_pallas=use_pallas))
    err_ref = np.abs(np.asarray(ref_val).reshape(-1, 4)[part.root_flat]
                     - want).max(axis=0)
    err = np.abs(val.numpy().reshape(-1, 4)[part.root_flat]
                 - want).max(axis=0)
    assert (err <= err_ref + 1e-9).all(), (err, err_ref)
    assert err_ref.max() > 1e-7
    np.testing.assert_array_equal(st.rounds.numpy(),
                                  np.asarray(ref_st.rounds))
