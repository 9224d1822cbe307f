"""The port's CUDA kernels (K1 dense, K2 worklist, K3/K4 their
lane-batched twins, K9 the segment reduce) against their plain versions,
on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernel builds from
``src/repro_torch/kernels/csrc`` on first use) and skips without one.
Run them on the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither ``jax`` nor ``repro``: the card's machine has
no JAX.  The plain version is ``repro_torch.kernels.ref``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import exchange  # noqa: E402
from repro_torch.apps import bfs, pagerank, pagerank_delta, sssp  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.graph import generators, reference  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import rhizome_segment_reduce as rsr  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    fused_relax_reduce_lanes_ref, fused_relax_reduce_ref,
    fused_relax_reduce_wl_lanes_ref, fused_relax_reduce_wl_ref,
    segment_combine_ref,
)
from repro_torch.query import lanes  # noqa: E402

pytestmark = pytest.mark.cuda

EBLK, SBLK = frr.EBLK, frr.SBLK
PAIRS = [("add_w", "min"), ("add_one", "min"), ("mul_w", "sum")]
SHAPES = [
    (1, 1, 1), (17, 7, 3), (300, EBLK, SBLK), (130, EBLK + 1, SBLK + 1),
    (500, 2 * EBLK + 13, 2 * SBLK + 5), (64, EBLK - 1, 1000),
    (5000, 20 * EBLK + 77, 3000),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(v, e, nseg, frac, seed, sorted_ids=True, negative=False):
    rng = np.random.default_rng(seed)
    gval = rng.uniform(0.0, 10.0, v).astype(np.float32)
    gchg = rng.random(v) < frac
    src = rng.integers(0, v, e).astype(np.int32)
    lo = -2.0 if negative else 0.1
    w = rng.uniform(lo, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    return gval, gchg, src, w, mask, ids


def _check(dev, case, nseg, relax, kind):
    args = [torch.as_tensor(x, device=dev) for x in case]
    out, count, dbg = frr.fused_relax_reduce(
        *args, nseg, relax, kind, with_count=True, with_debug=True)
    want = fused_relax_reduce_ref(*args, nseg, relax, kind)
    gval, gchg, src, w, mask, ids = case
    torch.cuda.synchronize()
    if kind == "min":
        assert torch.equal(out, want)
    else:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
        again = frr.fused_relax_reduce(*args, nseg, relax, kind)
        assert torch.equal(out, again)
    assert int(count) == int((mask & gchg[src]).sum())
    mirror = frr.fused_grid_cells(ids, mask, src, gchg, nseg)
    assert int(dbg[0]) == mirror["fused_live"]


@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_kernel_matches_plain(dev, relax, kind, v, e, nseg):
    _check(dev, _case(v, e, nseg, 0.4, seed=e + nseg), nseg, relax, kind)


@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("frac", [0.0, 0.01, 1.0])
def test_kernel_frontier_densities(dev, relax, kind, frac):
    _check(dev, _case(4000, 9 * EBLK + 9, 2700, frac, seed=5), 2700,
           relax, kind)


@pytest.mark.parametrize("relax,kind", PAIRS)
def test_kernel_unsorted_ids_negative_weights(dev, relax, kind):
    case = _case(300, 3000, 400, 0.5, seed=11, sorted_ids=False,
                 negative=kind == "min")
    _check(dev, case, 400, relax, kind)


def test_kernel_padding_edges_inert(dev):
    gval = torch.arange(10, dtype=torch.float32, device=dev)
    gchg = torch.ones(10, dtype=torch.bool, device=dev)
    src = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev)
    w = torch.ones(4, dtype=torch.float32, device=dev)
    mask = torch.tensor([True, True, False, False], device=dev)
    ids = torch.tensor([2, 2, 0, 5], dtype=torch.int32, device=dev)
    got = frr.fused_relax_reduce(gval, gchg, src, w, mask, ids, 6, "add_w",
                                 "min").cpu()
    assert got[0] == np.inf and got[5] == np.inf and got[2] == 1.0


def test_kernel_counts_launches(dev):
    case = _case(100, 700, 90, 0.5, seed=1)
    args = [torch.as_tensor(x, device=dev) for x in case]
    frr.launches = 0
    frr.fused_relax_reduce(*args, 90, "add_w", "min")
    fused_relax_reduce_ref(*args, 90, "add_w", "min")
    assert frr.launches == 1


@pytest.mark.parametrize("app,oracle", [(bfs, reference.bfs_levels),
                                        (sssp, reference.sssp_dijkstra)])
def test_engine_on_card_matches_oracle(dev, app, oracle):
    g = generators.rmat(10, edge_factor=8, seed=3).with_random_weights(seed=3)
    root = int(np.argmax(g.out_degrees()))
    frr.launches = 0
    got, stats, _ = app(g, root, num_shards=8, rpvo_max=4,
                        cfg=engine.EngineConfig(use_pallas=True))
    np.testing.assert_array_equal(got, oracle(g, root))
    assert frr.launches == int(stats.iterations)


# --------------------------------------------------------------------------
# K2: the worklist launch, from a host plan and from a device plan
# --------------------------------------------------------------------------

def _check_wl(dev, case, nseg, relax, kind, grid_mode):
    args = [torch.as_tensor(x, device=dev) for x in case]
    out, count, dbg = frr.fused_relax_reduce(
        *args, nseg, relax, kind, with_count=True, with_debug=True,
        grid_mode=grid_mode)
    gval, gchg, src, w, mask, ids = case
    wl, info = frr.plan_worklist(ids, mask, src, gchg, nseg,
                                 dst_filter=grid_mode == "worklist")
    plain = fused_relax_reduce_wl_ref(*args, wl.wl_i.to(dev),
                                      wl.wl_j.to(dev), wl.nlive.to(dev),
                                      nseg, relax, kind)
    dense = fused_relax_reduce_ref(*args, nseg, relax, kind)
    torch.cuda.synchronize()
    for want in (plain, dense):
        if kind == "min":
            assert torch.equal(out, want)
        else:
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    if kind == "sum":
        again = frr.fused_relax_reduce(*args, nseg, relax, kind,
                                       grid_mode=grid_mode)
        assert torch.equal(out, again)
    assert int(count) == int((mask & gchg[src]).sum())
    assert int(dbg[0]) == info.cells


@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_worklist_kernel_matches_plain(dev, relax, kind, v, e, nseg,
                                       grid_mode):
    _check_wl(dev, _case(v, e, nseg, 0.4, seed=e + nseg), nseg, relax,
              kind, grid_mode)


@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("frac", [0.0, 0.01, 1.0])
def test_worklist_kernel_frontier_densities(dev, relax, kind, frac,
                                            grid_mode):
    case = _case(4000, 9 * EBLK + 9, 2700, frac, seed=5, sorted_ids=False,
                 negative=kind == "min")
    _check_wl(dev, case, 2700, relax, kind, grid_mode)


def test_worklist_kernel_counts_launches(dev):
    case = _case(100, 700, 90, 0.5, seed=1)
    args = [torch.as_tensor(x, device=dev) for x in case]
    frr.launches = frr.wl_launches = 0
    for grid_mode in ("worklist", "device_worklist"):
        frr.fused_relax_reduce(*args, 90, "add_w", "min", grid_mode=grid_mode)
    assert (frr.launches, frr.wl_launches) == (0, 2)


def test_device_window_enqueues_without_sync(dev):
    """A device_worklist window enqueues every round without a host
    sync: the whole window runs under sync-debug mode 'error'."""
    g = generators.rmat(10, edge_factor=8, seed=3).with_random_weights(seed=3)
    root = int(np.argmax(g.out_degrees()))
    part = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=4))
    arrays = engine.DeviceArrays.from_partition(part, dev)
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="device_worklist")
    val = torch.as_tensor(engine.init_values(part, actions.SSSP,
                                             {root: 0.0}), device=dev)
    chg = (val == 0) & arrays.slot_valid
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exchange.fixpoint_window_stacked(
            actions.SSSP, arrays, cfg, part.S, part.R_max, 4, val, chg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out[2].sum()) > 0


@pytest.mark.parametrize("grid_mode", ["worklist", "auto", "device_worklist"])
@pytest.mark.parametrize("app,oracle", [(bfs, reference.bfs_levels),
                                        (sssp, reference.sssp_dijkstra)])
def test_engine_grid_modes_on_card_match_oracle(dev, app, oracle, grid_mode):
    g = generators.rmat(10, edge_factor=8, seed=3).with_random_weights(seed=3)
    root = int(np.argmax(g.out_degrees()))
    frr.wl_launches = 0
    got, stats, _ = app(g, root, num_shards=8, rpvo_max=4,
                        cfg=engine.EngineConfig(use_pallas=True,
                                                grid_mode=grid_mode))
    np.testing.assert_array_equal(got, oracle(g, root))
    assert frr.wl_launches > 0


def test_pagerank_on_card_matches_oracle(dev):
    g = generators.rmat(10, edge_factor=8, seed=3)
    want = reference.pagerank(g, 0.85, 30)
    got, _ = pagerank(g, iters=30, num_shards=8, rpvo_max=4,
                      cfg=engine.EngineConfig(use_pallas=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    want = reference.pagerank(g, 0.85, 200)
    for grid_mode in ("auto", "device_worklist"):
        got, stats, _ = pagerank_delta(
            g, tol=1e-9, num_shards=8, rpvo_max=4, max_rounds=400,
            cfg=engine.EngineConfig(use_pallas=True, grid_mode=grid_mode))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


# --------------------------------------------------------------------------
# K3 and K4: the lane-batched launches
# --------------------------------------------------------------------------

LANE_PAIRS = [("add_w", "min"), ("mul_w", "sum")]
LANE_SHAPES = [(1, 1, 1, 1), (60, 90, 40, 3), (200, EBLK + 7, 300, 5),
               (5000, 20 * EBLK + 77, 3000, 16), (700, 3 * EBLK + 1, 900, 33)]


def _lane_case(v, e, nseg, q, frac, seed, sorted_ids=True):
    rng = np.random.default_rng(seed)
    gval = rng.uniform(0.0, 10.0, (v, q)).astype(np.float32)
    gchg = rng.random((v, q)) < frac
    gchg[:, q // 2] = False               # one converged lane
    unitw = (rng.random(q) < 0.5).astype(np.int32)
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    return gval, gchg, unitw, src, w, mask, ids


def _check_lanes(dev, case, nseg, relax, kind, grid_mode):
    args = [torch.as_tensor(x, device=dev) for x in case]
    out, count, dbg = frr.fused_relax_reduce_lanes(
        *args, nseg, relax, kind, with_count=True, with_debug=True,
        grid_mode=grid_mode)
    gval, gchg, unitw, src, w, mask, ids = case
    wants = [fused_relax_reduce_lanes_ref(*args, nseg, relax, kind)]
    if grid_mode == "dense":
        cells = frr.fused_grid_cells(ids, mask, src, gchg, nseg)["fused_live"]
    else:
        wl, info = frr.plan_worklist(ids, mask, src, gchg, nseg,
                                     dst_filter=grid_mode == "worklist")
        cells = info.cells
        wants.append(fused_relax_reduce_wl_lanes_ref(
            *args, wl.wl_i.to(dev), wl.wl_j.to(dev), wl.nlive.to(dev), nseg,
            relax, kind))
    torch.cuda.synchronize()
    for want in wants:
        if kind == "min":
            assert torch.equal(out, want)
        else:
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    if kind == "sum":
        again = frr.fused_relax_reduce_lanes(*args, nseg, relax, kind,
                                             grid_mode=grid_mode)
        assert torch.equal(out, again)
    want_count = (mask[:, None] & gchg[src]).sum(axis=0)
    np.testing.assert_array_equal(count.cpu().numpy(), want_count)
    assert int(dbg[0]) == cells


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("relax,kind", LANE_PAIRS)
@pytest.mark.parametrize("v,e,nseg,q", LANE_SHAPES)
def test_lanes_kernels_match_plain(dev, relax, kind, v, e, nseg, q,
                                   grid_mode):
    _check_lanes(dev, _lane_case(v, e, nseg, q, 0.4, seed=e + q), nseg,
                 relax, kind, grid_mode)


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("relax,kind", LANE_PAIRS)
@pytest.mark.parametrize("frac", [0.0, 0.01, 1.0])
def test_lanes_kernels_frontier_densities(dev, relax, kind, frac,
                                          grid_mode):
    case = _lane_case(4000, 9 * EBLK + 9, 2700, 5, frac, seed=5,
                      sorted_ids=False)
    _check_lanes(dev, case, 2700, relax, kind, grid_mode)


def test_lane_columns_equal_single_lane_launches(dev):
    """No lane padding: the columns of Q = 33 equal Q = 1 launches."""
    gval, gchg, unitw, src, w, mask, ids = _lane_case(
        700, 3 * EBLK + 1, 900, 33, 0.3, seed=4)
    t = [torch.as_tensor(x, device=dev) for x in (src, w, mask, ids)]
    for grid_mode in ("dense", "device_worklist"):
        full = frr.fused_relax_reduce_lanes(
            torch.as_tensor(gval, device=dev),
            torch.as_tensor(gchg, device=dev),
            torch.as_tensor(unitw, device=dev), *t, 900, "add_w", "min",
            grid_mode=grid_mode)
        for lane in (0, 5, 31, 32):
            one = frr.fused_relax_reduce_lanes(
                torch.as_tensor(gval[:, lane:lane + 1], device=dev),
                torch.as_tensor(gchg[:, lane:lane + 1], device=dev),
                torch.as_tensor(unitw[lane:lane + 1], device=dev), *t, 900,
                "add_w", "min", grid_mode=grid_mode)
            assert torch.equal(full[:, lane:lane + 1], one)


def test_lanes_kernels_count_launches(dev):
    case = _lane_case(100, 700, 90, 4, 0.5, seed=1)
    args = [torch.as_tensor(x, device=dev) for x in case]
    frr.lanes_launches = frr.wl_lanes_launches = frr.launches = 0
    for grid_mode in ("dense", "worklist", "device_worklist"):
        frr.fused_relax_reduce_lanes(*args, 90, "add_w", "min",
                                     grid_mode=grid_mode)
    fused_relax_reduce_lanes_ref(*args, 90, "add_w", "min")
    assert (frr.lanes_launches, frr.wl_lanes_launches, frr.launches) == \
        (1, 2, 0)


def test_k4_partial_room_is_checked(dev):
    with pytest.raises(RuntimeError, match="bytes"):
        frr._check_partial_room(1 << 50, dev)


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
def test_lane_batch_on_card_matches_solo_runs(dev, grid_mode):
    g = generators.rmat(10, edge_factor=8, seed=3).with_random_weights(seed=3)
    deg = np.argsort(-g.out_degrees())
    part = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=4))
    queries = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
               ("bfs", int(deg[2])), ("sssp", int(deg[7]))]
    cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid_mode)
    frr.lanes_launches = frr.wl_lanes_launches = 0
    from repro_torch.apps import batched_queries
    res, stats, _ = batched_queries(g, queries, part=part, cfg=cfg)
    assert frr.lanes_launches + frr.wl_lanes_launches > 0
    for q, ((kind, root), got) in enumerate(zip(queries, res)):
        solo, solo_stats, _ = (bfs if kind == "bfs" else sssp)(
            g, root, part=part, cfg=engine.EngineConfig(use_pallas=True))
        np.testing.assert_array_equal(got, solo)
        assert int(stats.rounds[q]) == int(solo_stats.iterations)
        assert int(stats.messages[q]) == int(solo_stats.messages)


def test_lane_window_enqueues_without_sync(dev):
    g = generators.rmat(10, edge_factor=8, seed=3).with_random_weights(seed=3)
    part = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=4))
    arrays = engine.DeviceArrays.from_partition(part, dev)
    init, unitw = lanes.init_lane_values(part, [("bfs", 0), ("sssp", 1)])
    val = torch.as_tensor(init, device=dev)
    chg = (val == 0) & arrays.slot_valid[..., None]
    unitw = torch.as_tensor(unitw, device=dev)
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="device_worklist")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exchange.fixpoint_window_stacked(
            actions.SSSP, arrays, cfg, part.S, part.R_max, 4, val, chg,
            unitw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out[2].sum()) > 0


# --------------------------------------------------------------------------
# K9: the segment reduce
# --------------------------------------------------------------------------

SEG_SHAPES = [(1, 1), (7, 3), (100, 17), (EBLK, SBLK), (EBLK + 1, SBLK + 1),
              (2 * EBLK + 13, 2 * SBLK + 5), (EBLK - 1, 1000), (3000, 5),
              (200_000, 30_011)]


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("kind", ["min", "sum"])
@pytest.mark.parametrize("e,nseg", SEG_SHAPES)
def test_segment_combine_matches_plain(dev, e, nseg, kind, sorted_ids):
    rng = np.random.default_rng(e + nseg)
    data = torch.as_tensor(rng.uniform(-10, 10, e).astype(np.float32),
                           device=dev)
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    ids = torch.as_tensor(ids, device=dev)
    rsr.launches = 0
    got, cells = rsr.segment_combine(data, ids, nseg, kind, with_debug=True)
    want = segment_combine_ref(data, ids, nseg, kind)
    torch.cuda.synchronize()
    assert rsr.launches == 1
    if kind == "min":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, rsr.segment_combine(data, ids, nseg, kind))
    assert int(cells[0]) == rsr.plan_segments(ids, nseg).num_cells
    for dtype in (torch.bfloat16,):
        got_bf = rsr.segment_combine(data.to(dtype), ids, nseg, kind)
        want_bf = segment_combine_ref(data.to(dtype).float(), ids, nseg,
                                      kind).to(dtype)
        assert got_bf.dtype == dtype
        if kind == "min":
            assert torch.equal(got_bf, want_bf)
        else:
            torch.testing.assert_close(got_bf.float(), want_bf.float(),
                                       rtol=8e-2, atol=0.5)


@pytest.mark.parametrize("app,oracle", [(bfs, reference.bfs_levels),
                                        (sssp, reference.sssp_dijkstra)])
def test_reduce_mode_on_card_matches_oracle(dev, app, oracle):
    g = generators.rmat(10, edge_factor=8, seed=3).with_random_weights(seed=3)
    root = int(np.argmax(g.out_degrees()))
    rsr.launches = 0
    got, stats, _ = app(g, root, num_shards=8, rpvo_max=4,
                        cfg=engine.EngineConfig(use_pallas=True,
                                                pallas_mode="reduce"))
    np.testing.assert_array_equal(got, oracle(g, root))
    assert rsr.launches == int(stats.iterations)
