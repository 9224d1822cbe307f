"""The port's CUDA kernels (K1 dense, K2 worklist, K3/K4 their
lane-batched twins, K5-K8 the tiled twins of K1-K4, K9 the segment
reduce) against their plain versions and the dense ones and K9 against
their order models, on the card, and the worklist launches against the dense
ones on the same pieces, whole and split.

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
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    fused_relax_reduce_lanes_order, fused_relax_reduce_lanes_ref,
    fused_relax_reduce_order, fused_relax_reduce_ref,
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


# the worklist launches run the dense launch's pieces: on the same pieces
# they equal it bit for bit, whole blocks or split
ONE_PIECE = 1 << 20
PIECE_SHAPES = [(500, 2 * EBLK + 13, 2 * SBLK + 5), (5000, 20 * EBLK + 77,
                                                     3000),
                (3000, 30 * EBLK, 600)]


def _dense_twin(dev, case, nseg, relax, kind, grid_mode, cells,
                lanes=False):
    """(worklist launch, dense launch), both with the launches' pieces at
    ``cells`` cells; checks the cells run and that sums repeat."""
    args = [torch.as_tensor(x, device=dev) for x in case]
    n_src = 3 if lanes else 2
    plan = frr.plan_launch(args[n_src], args[n_src + 2], args[n_src + 3],
                           nseg, case[0].shape[0])
    launch = frr.fused_relax_reduce_lanes if lanes else frr.fused_relax_reduce
    old = frr.PIECE_CELLS
    frr.PIECE_CELLS = cells
    try:
        out, dbg = launch(*args, nseg, relax, kind, plan=plan,
                          with_debug=True, grid_mode=grid_mode)
        again = launch(*args, nseg, relax, kind, plan=plan,
                       grid_mode=grid_mode)
        dense = launch(*args, nseg, relax, kind, plan=plan)
    finally:
        frr.PIECE_CELLS = old
    gchg, src, mask, ids = (case[1], case[n_src], case[n_src + 2],
                            case[n_src + 3])
    wl, info = frr.plan_worklist(ids, mask, src, gchg, nseg,
                                 dst_filter=grid_mode == "worklist")
    torch.cuda.synchronize()
    assert torch.equal(out, again)             # bit-repeatable
    assert int(dbg[0]) == info.cells == int(wl.nlive[0])
    return out, dense


@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", PIECE_SHAPES)
def test_k2_one_piece_equals_k1(dev, v, e, nseg, relax, kind, grid_mode):
    case = _case(v, e, nseg, 0.3, seed=v + e, negative=kind == "min")
    out, dense = _dense_twin(dev, case, nseg, relax, kind, grid_mode,
                             ONE_PIECE)
    assert torch.equal(out, dense)


@pytest.mark.parametrize("cells", [1, 2])
@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", PIECE_SHAPES)
def test_k2_split_blocks_match_k1(dev, v, e, nseg, relax, kind, grid_mode,
                                  cells):
    case = _case(v, e, nseg, 0.3, seed=v + e + 1, negative=kind == "min")
    out, dense = _dense_twin(dev, case, nseg, relax, kind, grid_mode, cells)
    # a cell the host plan drops adds only the identity
    assert torch.equal(out, dense)


def test_worklist_tables_build_without_host_sync(dev):
    """A plan's first launch, dense included, builds its pieces and batch
    ranges; they are built on the card with no host sync (so a device
    window may be the first to need them) and equal their CPU build."""
    case = _case(3000, 30 * EBLK, 600, 0.3, seed=11)
    args = [torch.as_tensor(x, device=dev) for x in case]
    plan = frr.plan_launch(args[2], args[4], args[5], 600, 3000)
    assert not plan.scratch
    frr.fused_relax_reduce(*args, 600, "add_w", "min", plan=plan)
    assert ("pieces", frr.PIECE_CELLS) in plan.scratch \
        and "batches" in plan.scratch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pc = frr.plan_pieces(plan, 2)
        batches = frr.plan_batches(plan, args[5])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = [torch.as_tensor(x) for x in case]
    plan_h = frr.plan_launch(cpu[2], cpu[4], cpu[5], 600, 3000)
    pc_h = frr.plan_pieces(plan_h, 2)
    for got, want in zip(pc, pc_h):
        assert (got == want) if isinstance(got, int) \
            else torch.equal(got.cpu(), want)
    assert torch.equal(batches.cpu(), frr.plan_batches(plan_h, cpu[5]))


@pytest.mark.parametrize("lanes", [False, True])
def test_split_blocks_on_two_streams(dev, lanes):
    """Launches of one plan on two streams at once each take their own
    arrival tickets and give the launch on one stream bit for bit."""
    v, e, nseg = PIECE_SHAPES[2]
    case = (_lane_case(v, e, nseg, 16, 0.3, seed=4) if lanes
            else _case(v, e, nseg, 0.3, seed=4))
    args = [torch.as_tensor(x, device=dev) for x in case]
    n_src = 3 if lanes else 2
    plan = frr.plan_launch(args[n_src], args[n_src + 2], args[n_src + 3],
                           nseg, v)
    launch = frr.fused_relax_reduce_lanes if lanes else frr.fused_relax_reduce
    old = frr.PIECE_CELLS
    frr.PIECE_CELLS = 1
    try:
        want = launch(*args, nseg, "add_w", "min", plan=plan,
                      grid_mode="device_worklist")
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        outs = []
        for _ in range(4):
            outs.append(launch(*args, nseg, "add_w", "min", plan=plan,
                               grid_mode="device_worklist"))
            with torch.cuda.stream(side):
                outs.append(launch(*args, nseg, "add_w", "min", plan=plan,
                                   grid_mode="device_worklist"))
        torch.cuda.current_stream(dev).wait_stream(side)
    finally:
        frr.PIECE_CELLS = old
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, want)


@pytest.mark.parametrize("cells", [1, 2, ONE_PIECE])
@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("relax,kind", [("add_w", "min"), ("mul_w", "sum")])
@pytest.mark.parametrize("q", [1, 5, 33])
def test_k4_pieces_match_k3(dev, q, relax, kind, grid_mode, cells):
    """K4 equals K3 bit for bit on the same pieces, whole or split."""
    case = _lane_case(3000, 30 * EBLK, 600, q, 0.3, seed=q + cells)
    out, dense = _dense_twin(dev, case, 600, relax, kind, grid_mode, cells,
                             lanes=True)
    assert torch.equal(out, dense)


@pytest.mark.parametrize("cells", [2, ONE_PIECE])
@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("q", [None, 5, 33])
@pytest.mark.parametrize("relax,kind", [("add_w", "min"), ("mul_w", "sum")])
def test_tiled_worklist_twins_under_pieces(dev, relax, kind, q, grid_mode,
                                           cells):
    """K6 equals K2 and K8 equals K4 bit for bit, sum included, under
    split and whole blocks, with cells and staged rows as planned."""
    case = _tiled_case(3000, 30 * EBLK, 600, 0.3, 4, q=q)
    t = [torch.as_tensor(x, device=dev) for x in case]
    head = t[:2]
    if q is not None:
        head.append(torch.as_tensor(np.arange(q) % 2, device=dev))
    launch = frr.fused_relax_reduce_lanes if q else frr.fused_relax_reduce
    plan = frr.plan_launch(t[2], t[4], t[5], 600, 3000)
    gor = case[1].any(axis=1) if q else case[1]
    _, info = frr.plan_worklist(case[5], case[4], case[2], gor, 600,
                                num_slots=3000, path="tiled", vblk=1024,
                                dst_filter=grid_mode == "worklist")
    old = frr.PIECE_CELLS
    frr.PIECE_CELLS = cells
    try:
        tiled, dbg = launch(*head, *t[2:], 600, relax, kind, plan=plan,
                            grid_mode=grid_mode, path="tiled", vblk=1024,
                            with_debug=True)
        pinned = launch(*head, *t[2:], 600, relax, kind, plan=plan,
                        grid_mode=grid_mode, path="pinned")
    finally:
        frr.PIECE_CELLS = old
    torch.cuda.synchronize()
    assert torch.equal(tiled, pinned)
    assert (int(dbg[0]), int(dbg[1])) == (info.cells, info.staged_rows)


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


def _k9_cut(cells, fn):
    """``fn()`` with K9's pieces at ``cells`` cells."""
    old = rsr.PIECE_CELLS
    rsr.PIECE_CELLS = cells
    try:
        return fn()
    finally:
        rsr.PIECE_CELLS = old


def _bits_equal(got, want_f32):
    """``got`` (the kernel's output) equals the order model's float32
    result rounded once to ``got``'s dtype, bit for bit."""
    want = torch.from_numpy(want_f32).to(got.dtype)
    return torch.equal(got.cpu(), want)


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("kind", ["min", "sum"])
@pytest.mark.parametrize("e,nseg", SEG_SHAPES)
def test_segment_combine_matches_plain(dev, e, nseg, kind, sorted_ids):
    """K9 at the default cut and one piece a block equals its order
    model bit for bit (float32 and bfloat16, sums included) and its plain
    version (min bit for bit, sum within rtol 1e-5), and walks the plan's
    cells, runs its pieces and loads the edges of its batch ranges."""
    rng = np.random.default_rng(e + nseg)
    data = torch.as_tensor(rng.uniform(-10, 10, e).astype(np.float32),
                           device=dev)
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    ids = torch.as_tensor(ids, device=dev)
    want = segment_combine_ref(data, ids, nseg, kind)
    for cells in (rsr.PIECE_CELLS, ONE_PIECE):
        rsr.launches = 0
        got, walked = _k9_cut(cells, lambda: rsr.segment_combine(
            data, ids, nseg, kind, with_debug=True))
        torch.cuda.synchronize()
        assert rsr.launches == 1
        if kind == "min":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(got, _k9_cut(cells, lambda: rsr.segment_combine(
                data, ids, nseg, kind)))
        model, n_cells = ref.segment_combine_order(data, ids, nseg, kind,
                                                   cells)
        assert _bits_equal(got, model)
        assert int(walked[0]) == n_cells \
            == rsr.plan_segments(ids, nseg).num_cells
        assert walked.tolist() == _k9_cut(cells, lambda: rsr.launch_counts(
            rsr.plan_segments(ids, nseg), ids)).tolist()
        got_bf = _k9_cut(cells, lambda: rsr.segment_combine(
            data.to(torch.bfloat16), ids, nseg, kind))
        assert got_bf.dtype == torch.bfloat16
        model_bf, _ = ref.segment_combine_order(data.to(torch.bfloat16), ids,
                                                nseg, kind, cells)
        assert _bits_equal(got_bf, model_bf)
        want_bf = segment_combine_ref(data.to(torch.bfloat16).float(), ids,
                                      nseg, kind).to(torch.bfloat16)
        if kind == "min":
            assert torch.equal(got_bf, want_bf)
        else:
            torch.testing.assert_close(got_bf.float(), want_bf.float(),
                                       rtol=8e-2, atol=0.5)


@pytest.mark.parametrize("cells", [2, ONE_PIECE])
@pytest.mark.parametrize("kind", ["min", "sum"])
def test_segment_combine_masked_plan(dev, kind, cells):
    """K9 on a plan built under a mask (masked edges carry the identity,
    their ids outside their chunk's planned blocks) equals its order model
    under that mask bit for bit, and counts the cells, pieces and edges
    the plan's tables give."""
    e, nseg = 40 * EBLK + 77, 60 * SBLK + 3
    rng = np.random.default_rng(cells)
    data = rng.uniform(0.0, 10.0, e).astype(np.float32)
    ids = np.sort(rng.integers(0, nseg, e)).astype(np.int32)
    mask = rng.random(e) < 0.8
    ids = np.where(mask, ids, rng.integers(0, nseg, e)).astype(np.int32)
    data = np.where(mask, data, np.inf if kind == "min" else 0.0) \
        .astype(np.float32)
    t = [torch.as_tensor(x, device=dev) for x in (data, ids, mask)]
    plan = rsr.plan_segments(t[1], nseg, t[2])
    got, walked = _k9_cut(cells, lambda: rsr.segment_combine(
        t[0], t[1], nseg, kind, plan=plan, with_debug=True))
    model, n_cells = ref.segment_combine_order(data, ids, nseg, kind, cells,
                                               edge_mask=mask)
    torch.cuda.synchronize()
    assert _bits_equal(got, model)
    assert int(walked[0]) == n_cells == plan.num_cells
    assert walked.tolist() == _k9_cut(
        cells, lambda: rsr.launch_counts(plan, t[1])).tolist()


@pytest.mark.parametrize("which", ["data", "segment_ids"])
def test_segment_combine_misaligned_raises(dev, which):
    """A tensor off its vector loads' alignment raises; nothing falls
    back to a scalar path."""
    data = torch.rand(2 * EBLK + 1, device=dev)
    ids = torch.zeros(2 * EBLK + 1, dtype=torch.int32, device=dev)
    args = {"data": data[:-1], "segment_ids": ids[:-1]}
    args[which] = (data if which == "data" else ids)[1:]
    with pytest.raises(ValueError, match="aligned"):
        rsr.segment_combine(args["data"], args["segment_ids"], 7, "min")


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


# --------------------------------------------------------------------------
# K5-K8: the tiled launches
# --------------------------------------------------------------------------
# Shapes straddle a tile (V = 129 at vblk 128, V = 1025 at vblk 1024);
# vblk None is the automatic width.  The width shapes only the
# reference's tile accounting: the kernels stage rows.

TILED_SHAPES = [(1, 1, 1), (129, 300, 50), (1025, 5 * EBLK + 13, 2 * SBLK + 5),
                (5000, 20 * EBLK + 77, 3000)]
VBLKS = [128, 1024, None]


def _tiled_case(v, e, nseg, frac, seed, q=None):
    rng = np.random.default_rng(seed)
    shape = (v,) if q is None else (v, q)
    gval = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    gchg = rng.random(shape) < frac
    if q is not None and q > 1:
        gchg[:, q // 2] = False             # a converged lane
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = np.sort(rng.integers(0, nseg, e)).astype(np.int32)
    return gval, gchg, src, w, mask, ids


def _check_tiled(dev, case, nseg, relax, kind, grid_mode, vblk, unitw=None):
    """The tiled kernel of ``grid_mode`` against its pinned twin on the
    same plan, its plain version, the pinned oracle and the host mirror:
    K5/K6/K7/K8 equal K1/K2/K3/K4 bit for bit, sum included; min
    bit-equal to the plain version and the oracle, sum within rtol 1e-5;
    cells and staged rows exact, the same rows under every launch
    shape."""
    gval, gchg, src, w, mask, ids = case
    q = 1 if unitw is None else gval.shape[1]
    laned = unitw is not None
    vb = frr.select_kernel_path(gval.shape[0], q, path="tiled",
                                vblk=vblk)[1]
    t = [torch.as_tensor(x, device=dev) for x in case]
    head = t[:2] + ([torch.as_tensor(unitw, device=dev)] if laned else [])
    gor = gchg.any(axis=1) if laned else gchg
    plan = frr.plan_launch(t[2], t[4], t[5], nseg, gval.shape[0])
    m = frr.fused_grid_cells(ids, mask, src, gor, nseg, vblk=vb)
    wl = None
    if grid_mode == "worklist":
        wl, info = frr.plan_worklist(ids, mask, src, gor, nseg,
                                     num_slots=gval.shape[0], path="tiled",
                                     vblk=vb, lane_width=q)
        want_dbg = (info.cells, info.staged_rows)
    elif grid_mode == "device_worklist":
        wl = frr.build_device_worklist(t[1], t[2], t[4], t[5], nseg, plan,
                                       path="tiled", vblk=vb)
        _, info = frr.plan_worklist(ids, mask, src, gor, nseg,
                                    num_slots=gval.shape[0], path="tiled",
                                    vblk=vb, dst_filter=False)
        want_dbg = (info.cells, info.staged_rows)
    else:
        want_dbg = (m["fused_live"], m["fused_staged_rows"])
    assert want_dbg[1] == m["fused_staged_rows"]
    launch = frr.fused_relax_reduce_lanes if laned else frr.fused_relax_reduce

    def run(debug=True):
        return launch(*head, *t[2:], nseg, relax, kind, with_count=True,
                      with_debug=debug, plan=plan, worklist=wl, path="tiled",
                      vblk=vb)

    out, count, dbg = run()
    if wl is None:
        plain_fn = (ref.fused_relax_reduce_tiled_lanes_ref if laned
                    else ref.fused_relax_reduce_tiled_ref)
        plain, rows = plain_fn(*head, *t[2:], nseg, relax, kind, plan)
        pinned = launch(*head, *t[2:], nseg, relax, kind, plan=plan,
                        path="pinned")
    else:
        plain_fn = (ref.fused_relax_reduce_wl_tiled_lanes_ref if laned
                    else ref.fused_relax_reduce_wl_tiled_ref)
        plain, rows = plain_fn(*head, *t[2:], wl.wl_i.to(dev),
                               wl.wl_j.to(dev), wl.nlive.to(dev), nseg,
                               relax, kind)
        pinned = launch(*head, *t[2:], nseg, relax, kind, plan=plan,
                        worklist=frr.Worklist(wl.wl_i, wl.wl_j, wl.nlive))
    oracle = (fused_relax_reduce_lanes_ref if laned
              else fused_relax_reduce_ref)(*head, *t[2:], nseg, relax, kind)
    torch.cuda.synchronize()
    assert torch.equal(out, pinned)
    if kind == "min":
        assert torch.equal(out, plain) and torch.equal(out, oracle)
    else:
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-6)
        again, _ = run(debug=False)
        assert torch.equal(out, again)
    want_count = (mask[:, None] & gchg[src]).sum(axis=0) if laned \
        else (mask & gchg[src]).sum()
    np.testing.assert_array_equal(count.cpu().numpy(), want_count)
    assert (int(dbg[0]), int(dbg[1])) == want_dbg
    assert int(rows) == want_dbg[1]


@pytest.mark.parametrize("vblk", VBLKS)
@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", TILED_SHAPES)
def test_tiled_kernels_match_plain(dev, v, e, nseg, relax, kind, grid_mode,
                                   vblk):
    case = _tiled_case(v, e, nseg, 0.3, v + e)
    _check_tiled(dev, case, nseg, relax, kind, grid_mode, vblk)


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("frac", [0.0, 0.01, 1.0])
def test_tiled_kernels_frontier_densities(dev, frac, relax, kind,
                                          grid_mode):
    case = _tiled_case(5000, 20 * EBLK + 77, 3000, frac, 11)
    _check_tiled(dev, case, 3000, relax, kind, grid_mode, 128)


@pytest.mark.parametrize("vblk", VBLKS)
@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("relax,kind", LANE_PAIRS)
@pytest.mark.parametrize("q", [1, 5, 16, 33])
def test_tiled_lane_kernels_match_plain(dev, q, relax, kind, grid_mode,
                                        vblk):
    case = _tiled_case(1025, 5 * EBLK + 13, 2 * SBLK + 5, 0.3, q, q=q)
    unitw = (np.arange(q) % 2).astype(np.int32)
    _check_tiled(dev, case, 2 * SBLK + 5, relax, kind, grid_mode, vblk,
                 unitw)


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("frac", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("q", [5, 16])
def test_tiled_lane_kernels_frontier_densities(dev, q, frac, grid_mode):
    case = _tiled_case(5000, 20 * EBLK + 77, 3000, frac, 7, q=q)
    unitw = (np.arange(q) % 3 == 0).astype(np.int32)
    _check_tiled(dev, case, 3000, "add_w", "min", grid_mode, 128, unitw)


def test_tiled_kernels_count_launches(dev):
    case = [torch.as_tensor(x, device=dev)
            for x in _tiled_case(1025, 5 * EBLK, 700, 0.5, 3)]
    counts = ("launches", "wl_launches", "tiled_launches",
              "wl_tiled_launches")
    for name in counts:
        setattr(frr, name, 0)
    for grid_mode in ("dense", "worklist", "device_worklist"):
        frr.fused_relax_reduce(*case, 700, "add_w", "min",
                               grid_mode=grid_mode, vmem_budget_bytes=256)
    assert [getattr(frr, n) for n in counts] == [0, 0, 1, 2]
    lane = [torch.as_tensor(x, device=dev)
            for x in _tiled_case(1025, 5 * EBLK, 700, 0.5, 3, q=4)]
    unitw = torch.zeros(4, dtype=torch.int32, device=dev)
    frr.tiled_lanes_launches = frr.wl_tiled_lanes_launches = 0
    for grid_mode in ("dense", "worklist", "device_worklist"):
        frr.fused_relax_reduce_lanes(lane[0], lane[1], unitw, *lane[2:], 700,
                                     "add_w", "min", grid_mode=grid_mode,
                                     vmem_budget_bytes=256)
    assert (frr.tiled_lanes_launches, frr.wl_tiled_lanes_launches) == (1, 2)


def test_dense_tiled_relax_builds_no_tile_tables(dev, monkeypatch):
    """No tiled launch (K5-K8, dense, host and device plans) builds a
    tile table or a copy schedule: the kernels stage rows from the
    active flags the chunk tables already compute."""
    def refuse(*args, **kwargs):
        raise AssertionError("tile tables built for a tiled launch")

    case = [torch.as_tensor(x, device=dev)
            for x in _tiled_case(1025, 5 * EBLK, 700, 0.5, 3)]
    lane = [torch.as_tensor(x, device=dev)
            for x in _tiled_case(1025, 5 * EBLK, 700, 0.5, 3, q=4)]
    unitw = torch.zeros(4, dtype=torch.int32, device=dev)
    monkeypatch.setattr(frr, "_chunk_tile_tables", refuse)
    monkeypatch.setattr(frr, "tile_schedule", refuse)
    counts = ("tiled_launches", "wl_tiled_launches", "tiled_lanes_launches",
              "wl_tiled_lanes_launches")
    for name in counts:
        setattr(frr, name, 0)
    for grid_mode in ("dense", "worklist", "device_worklist"):
        frr.fused_relax_reduce(*case, 700, "add_w", "min",
                               grid_mode=grid_mode, vmem_budget_bytes=256)
        frr.fused_relax_reduce_lanes(lane[0], lane[1], unitw, *lane[2:],
                                     700, "add_w", "min",
                                     grid_mode=grid_mode,
                                     vmem_budget_bytes=256)
    torch.cuda.synchronize()
    assert [getattr(frr, n) for n in counts] == [1, 2, 1, 2]


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("app,oracle", [(bfs, reference.bfs_levels),
                                        (sssp, reference.sssp_dijkstra)])
def test_engine_over_budget_on_card_matches_oracle(dev, app, oracle,
                                                   grid_mode):
    g = generators.rmat(10, edge_factor=8, seed=5).with_random_weights(
        seed=5)
    root = int(np.argmax(g.out_degrees()))
    cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid_mode,
                              vmem_budget_bytes=4096)
    got, stats, _ = app(g, root, num_shards=4, rpvo_max=4, cfg=cfg,
                        device=dev)
    np.testing.assert_array_equal(got, oracle(g, root))
    pinned, pstats, _ = app(g, root, num_shards=4, rpvo_max=4,
                            cfg=engine.EngineConfig(use_pallas=True,
                                                    grid_mode=grid_mode),
                            device=dev)
    assert [int(x) for x in stats] == [int(x) for x in pstats]


# --------------------------------------------------------------------------
# the dense piece launches against their order models, and the tiled
# twins against them, bit for bit, sum included
# --------------------------------------------------------------------------

ORDER_SHAPES = [(17, 7, 3), (500, 2 * EBLK + 13, 2 * SBLK + 5),
                (3000, 8 * EBLK + 77, 600)]


def _bits(x):
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _with_cells(cells, fn):
    old = frr.PIECE_CELLS
    frr.PIECE_CELLS = cells
    try:
        return fn()
    finally:
        frr.PIECE_CELLS = old


@pytest.mark.parametrize("cells", [1, 2, ONE_PIECE])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", ORDER_SHAPES)
def test_k1_equals_order_model(dev, v, e, nseg, relax, kind, sorted_ids,
                               cells):
    case = _case(v, e, nseg, 0.4, seed=v + cells, sorted_ids=sorted_ids,
                 negative=kind == "min")
    args = [torch.as_tensor(x, device=dev) for x in case]
    out, dbg = _with_cells(cells, lambda: frr.fused_relax_reduce(
        *args, nseg, relax, kind, with_debug=True))
    want, executed = fused_relax_reduce_order(*case, nseg, relax, kind,
                                              cells)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(out), _bits(want))
    assert int(dbg[0]) == executed


@pytest.mark.parametrize("cells", [2, ONE_PIECE])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("relax,kind", LANE_PAIRS)
@pytest.mark.parametrize("q", [1, 5, 16, 33])
def test_k3_equals_order_model(dev, q, relax, kind, sorted_ids, cells):
    case = _lane_case(3000, 8 * EBLK + 77, 600, q, 0.4, seed=q + cells,
                      sorted_ids=sorted_ids)
    args = [torch.as_tensor(x, device=dev) for x in case]
    out, dbg = _with_cells(cells, lambda: frr.fused_relax_reduce_lanes(
        *args, 600, relax, kind, with_debug=True))
    want, executed = fused_relax_reduce_lanes_order(
        *case, 600, relax, kind, cells, frr._halves(q))
    torch.cuda.synchronize()
    assert np.array_equal(_bits(out), _bits(want))
    assert int(dbg[0]) == executed


@pytest.mark.parametrize("cells", [2, ONE_PIECE])
@pytest.mark.parametrize("q", [None, 5, 16, 33])
@pytest.mark.parametrize("relax,kind", LANE_PAIRS)
def test_dense_tiled_equal_pinned(dev, relax, kind, q, cells):
    """K5 equals K1 and K7 equals K3 bit for bit, sum included, whole
    blocks or split, and both equal the order model."""
    case = _tiled_case(3000, 30 * EBLK, 600, 0.3, 4, q=q)
    t = [torch.as_tensor(x, device=dev) for x in case]
    head = t[:2]
    if q is not None:
        unitw = np.arange(q) % 2
        head.append(torch.as_tensor(unitw, device=dev))
    launch = frr.fused_relax_reduce_lanes if q else frr.fused_relax_reduce
    plan = frr.plan_launch(t[2], t[4], t[5], 600, 3000)
    tiled, pinned = _with_cells(cells, lambda: (
        launch(*head, *t[2:], 600, relax, kind, plan=plan, path="tiled",
               vblk=1024),
        launch(*head, *t[2:], 600, relax, kind, plan=plan, path="pinned")))
    want, _ = (fused_relax_reduce_lanes_order(
        *case[:2], unitw, *case[2:], 600, relax, kind, cells,
        frr._halves(q)) if q else fused_relax_reduce_order(
            *case, 600, relax, kind, cells))
    torch.cuda.synchronize()
    assert torch.equal(tiled, pinned)
    assert np.array_equal(_bits(tiled), _bits(want))


# --------------------------------------------------------------------------
# the compact targeted exchange and the query server on the card
# --------------------------------------------------------------------------

def _compact_case(dev, scale=9, shards=8):
    """A partition whose source windows (S*P_t segments) straddle segment
    blocks and whose shards end in masked padding edges, on the card."""
    g = generators.rmat(scale, edge_factor=6, seed=1) \
        .with_random_weights(seed=1)
    part = build_partition(g, PartitionConfig(num_shards=shards,
                                              rpvo_max=4))
    assert (part.S * part.P_t) % SBLK and (~part.edge_mask).any()
    arrays = engine.DeviceArrays.from_partition(part, dev)
    return g, part, arrays


@pytest.mark.parametrize("frac", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("relax,kind", PAIRS)
def test_compact_plan_k1_k2_k9_match_plain(dev, relax, kind, frac):
    g, part, arrays = _compact_case(dev)
    plan, ids = arrays.compact.plan, arrays.compact.ids
    n = part.S * part.S * part.P_t
    rng = np.random.default_rng(3)
    v = part.S * part.R_max
    gval = torch.as_tensor(rng.uniform(0, 3, v).astype(np.float32),
                           device=dev)
    gchg = torch.as_tensor(rng.random(v) < frac, device=dev)
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    want = fused_relax_reduce_ref(gval, gchg, src, w, mask, ids, n, relax,
                                  kind)
    outs = [frr.fused_relax_reduce(gval, gchg, src, w, mask, ids, n, relax,
                                   kind, plan=plan, grid_mode=gm)
            for gm in ("dense", "device_worklist")]
    active = mask & gchg[src.long()]
    ident = torch.tensor(float("inf") if kind == "min" else 0.0,
                         device=dev)
    sv = gval[src.long()]
    msg = torch.where(active, actions.RELAX_FNS[relax](sv, w), ident)
    outs.append(rsr.segment_combine(msg, ids, n, kind, plan=plan))
    torch.cuda.synchronize()
    for out in outs:
        if kind == "min":
            assert torch.equal(out, want)
        else:
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(outs[0], outs[1])          # K2 = K1, sum included


@pytest.mark.parametrize("q", [1, 16])
def test_compact_plan_k3_matches_plain(dev, q):
    g, part, arrays = _compact_case(dev)
    plan, ids = arrays.compact.plan, arrays.compact.ids
    n = part.S * part.S * part.P_t
    rng = np.random.default_rng(4)
    v = part.S * part.R_max
    gval = torch.as_tensor(rng.uniform(0, 3, (v, q)).astype(np.float32),
                           device=dev)
    gchg = torch.as_tensor(rng.random((v, q)) < 0.1, device=dev)
    unitw = torch.as_tensor((np.arange(q) % 2).astype(np.int32), device=dev)
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    want = fused_relax_reduce_lanes_ref(gval, gchg, unitw, src, w, mask, ids,
                                        n, "add_w", "min")
    for gm in ("dense", "device_worklist"):
        out = frr.fused_relax_reduce_lanes(gval, gchg, unitw, src, w, mask,
                                           ids, n, "add_w", "min",
                                           plan=plan, grid_mode=gm)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
def test_compact_fixpoints_match_oracles(dev, grid_mode):
    g, part, _ = _compact_case(dev)
    root = int(np.argmax(g.out_degrees()))
    for app, want in ((bfs, reference.bfs_levels(g, root)),
                      (sssp, reference.sssp_dijkstra(g, root))):
        cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid_mode)
        got, st, _ = app(g, root, part=part, cfg=cfg)
        got_c, st_c, _ = app(g, root, part=part, cfg=engine.EngineConfig(
            use_pallas=True, grid_mode=grid_mode, exchange="compact"))
        np.testing.assert_array_equal(got_c, want)
        assert [int(x) for x in st_c] == [int(x) for x in st]


def test_compact_sum_scatter_repeats_bit_for_bit(dev):
    g, part, arrays = _compact_case(dev)
    rng = np.random.default_rng(6)
    part_sum = torch.as_tensor(rng.random((part.S, part.S, part.P_t, 16))
                               .astype(np.float32), device=dev)
    runs = [exchange.scatter_inbox(actions.PAGERANK,
                                   part_sum.transpose(0, 1),
                                   arrays.inbox_slot_map, part.R_max)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    cpu = exchange.scatter_inbox(actions.PAGERANK,
                                 part_sum.cpu().transpose(0, 1),
                                 arrays.inbox_slot_map.cpu(), part.R_max)
    assert torch.equal(runs[0].cpu(), cpu)


@pytest.mark.parametrize("exch,grid_mode,tick_rounds", [
    ("dense", "device_worklist", 4), ("compact", "device_worklist", 4),
    ("compact", "dense", 1)])
def test_query_server_on_the_card(dev, exch, grid_mode, tick_rounds):
    """A small request stream on the card: every min result equals its
    solo run, the counts of each request equal across configurations."""
    from repro_torch.query import QueryServer
    g, part, _ = _compact_case(dev)
    deg = np.argsort(-g.out_degrees(), kind="stable")
    srv = QueryServer(part, n_lanes=4, ppr_lanes=0, tick_rounds=tick_rounds,
                      cfg=engine.EngineConfig(use_pallas=True, exchange=exch,
                                              grid_mode=grid_mode))
    reqs = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
            ("reachability", int(deg[2])), ("bfs", int(deg[3])),
            ("sssp", int(deg[4])), ("bfs", int(deg[5]))]
    qids = [srv.submit(k, v) for k, v in reqs[:4]]
    srv.step()
    qids += [srv.submit(k, v) for k, v in reqs[4:]]
    res = srv.run()
    cfg1 = engine.EngineConfig(use_pallas=True)
    for qid, (kind, v) in zip(qids, reqs):
        app = sssp if kind == "sssp" else bfs
        want, st, _ = app(g, v, part=part, cfg=cfg1)
        if kind == "reachability":
            want = want != lanes.UNREACHED
        r = res[qid]
        assert r.status == "ok"
        np.testing.assert_array_equal(r.values, want)
        assert (r.rounds, r.messages) == (int(st.iterations),
                                          int(st.messages))


# --------------------------------------------------------------------------
# streaming mutation and crash-safe fixpoints on the card
# --------------------------------------------------------------------------

def _stream_schedule(g):
    """Two commits: 48 random inserts, then 32 inserts and 6 deletes."""
    rng = np.random.default_rng(3)

    def ins(k):
        return (rng.integers(0, g.n, k).astype(np.int32),
                rng.integers(0, g.n, k).astype(np.int32),
                rng.integers(1, 10, k).astype(np.float32))

    first, second = ins(48), ins(32)
    idx = rng.choice(g.num_edges, 6, replace=False)
    return [(first, None), (second, (g.src[idx].copy(), g.dst[idx].copy()))]


@pytest.mark.parametrize("grid_mode,runner", [
    ("dense", "stacked"), ("device_worklist", "stacked"),
    ("dense", "lanes"), ("device_worklist", "lanes")])
def test_streaming_on_the_card(dev, grid_mode, runner):
    """A StreamingGraph on the card (K1/K2, or K3/K4 with the lanes
    runner) and one on the CPU (the kernels' plain versions), same
    schedule: equal ``MaintStats``, min values bit for bit, PageRank
    within rtol 1e-4 / atol 1e-7."""
    import dataclasses
    from repro_torch.core.streaming import StreamingGraph
    g = generators.rmat(9, edge_factor=8, seed=4).with_random_weights(
        seed=4)
    root = int(np.argmax(g.out_degrees()))
    cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid_mode)
    sgs = [StreamingGraph(g, PartitionConfig(num_shards=4, rpvo_max=4),
                          cfg=cfg, runner=runner, device=d)
           for d in (dev, "cpu")]
    for sg in sgs:
        sg.track("bfs", root)
        sg.track("sssp", root)
        sg.track("pagerank", tol=1e-8)
    for ins, dels in _stream_schedule(g):
        infos = []
        for sg in sgs:
            sg.insert_edges(*ins)
            if dels is not None:
                sg.delete_edges(*dels)
            infos.append(sg.commit())
        assert {k: dataclasses.asdict(v) for k, v in infos[0].maint.items()
                if k[0] != "pagerank"} \
            == {k: dataclasses.asdict(v) for k, v in infos[1].maint.items()
                if k[0] != "pagerank"}
        for k in sgs[0].tracked:
            a, b = (sg.tracked[k]["vals"] for sg in sgs)
            if k[0] == "pagerank":
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
            else:
                np.testing.assert_array_equal(a, b)
    lv = sgs[0].values("bfs", root)
    want = reference.bfs_levels(sgs[0].g, root)
    np.testing.assert_array_equal(np.isfinite(lv), want != lanes.UNREACHED)


def test_checkpoint_cuda_tensors_async(dev, tmp_path):
    """An async save of CUDA tensors copies them to the host before the
    writer thread starts; a restore lands on the device asked for."""
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path))
    tree = {"val": torch.arange(12, dtype=torch.float32, device=dev)
            .reshape(3, 4), "chg": torch.ones(3, 4, dtype=torch.bool,
                                              device=dev)}
    want = {k: v.clone() for k, v in tree.items()}
    mgr.save(1, tree, blocking=False)
    tree["val"].add_(5.0)
    mgr.wait()
    got = mgr.restore(1, tree, device=dev)
    for k in want:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("task", ["stacked", "lanes"])
def test_resilient_on_the_card(dev, task, tmp_path):
    """``run_resilient`` on the card with a shard killed at round 3 and a
    real checkpoint manager equals the plain runner bit for bit, with
    equal ``RunStats``."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.resilient import LanesTask, StackedTask
    from repro_torch.core.resilient import run_resilient
    from repro_torch.runtime.chaos import ChaosEvent, ChaosPlan
    g = generators.rmat(9, edge_factor=8, seed=5).with_random_weights(
        seed=5)
    part = build_partition(g, PartitionConfig(num_shards=4, rpvo_max=2))
    deg = np.argsort(-g.out_degrees(), kind="stable")
    cfg = engine.EngineConfig(use_pallas=True, checkpoint_every=2)
    plain = engine.EngineConfig(use_pallas=True)
    if task == "stacked":
        init = engine.init_values(part, actions.SSSP, {int(deg[0]): 0.0})
        want, wst = engine.run_stacked(actions.SSSP, part, init, plain,
                                       device=dev)
        t = StackedTask(actions.SSSP, part, init, cfg, device=dev)
        wmsgs = int(wst.messages)
    else:
        init, unitw = lanes.init_lane_values(
            part, [("bfs", int(v)) for v in deg[:3]]
            + [("sssp", int(v)) for v in deg[3:6]])
        want, wst = lanes.run_stacked_lanes(part, init, unitw, plain,
                                            device=dev)
        t = LanesTask(part, init, unitw, cfg, device=dev)
        wmsgs = int(wst.messages.sum())
    got, stats, report = run_resilient(
        t, chaos=ChaosPlan(events=(ChaosEvent(round=3, kind="kill_shard",
                                              shard=1),)),
        manager=CheckpointManager(str(tmp_path)))
    assert report.status == "recovered" and report.checkpoints_written
    assert torch.equal(got, want)
    assert int(stats.messages) == wmsgs


def test_server_apply_mutation_on_the_card(dev):
    """A bound server on the card (K4 under ``device_worklist``) across
    an insert-only commit with lanes in flight and one with deletes:
    every answer equals a solo run on the final partition."""
    from repro_torch.core.streaming import StreamingGraph
    from repro_torch.query import QueryServer
    g = generators.rmat(9, edge_factor=8, seed=6).with_random_weights(
        seed=6)
    sg = StreamingGraph(g, PartitionConfig(num_shards=4, rpvo_max=4),
                        device=dev)
    srv = QueryServer(sg.view("base").part, n_lanes=4, ppr_lanes=0,
                      cfg=engine.EngineConfig(use_pallas=True,
                                              grid_mode="device_worklist"))
    sg.bind_server(srv)
    deg = np.argsort(-g.out_degrees(), kind="stable")
    reqs = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
            ("sssp", int(deg[2])), ("bfs", int(deg[3]))]
    qids = [srv.submit(k, v) for k, v in reqs]
    srv.step()
    for ins, dels in _stream_schedule(g):
        sg.insert_edges(*ins)
        if dels is not None:
            sg.delete_edges(*dels)
        sg.commit()
        srv.step()
    res = srv.run()
    part = sg.view("base").part
    for qid, (kind, v) in zip(qids, reqs):
        sem = actions.BFS if kind == "bfs" else actions.SSSP
        val, _ = engine.run_stacked(sem, part, engine.init_values(
            part, sem, {v: 0.0}), engine.EngineConfig(use_pallas=True),
            device=dev)
        want = lanes.decode_min_values(engine.vertex_values(part, val), kind)
        assert res[qid].status == "ok"
        np.testing.assert_array_equal(res[qid].values, want)


def _close_on_card(out, want, kind):
    torch.cuda.synchronize()
    if kind == "min":
        assert torch.equal(out, want)
    else:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grid_mode,counter", [
    ("dense", "launches"), ("worklist", "wl_launches"),
    ("device_worklist", "wl_launches")])
@pytest.mark.parametrize("relax,kind", PAIRS)
def test_pallas_name_launches_k1_k2(dev, relax, kind, grid_mode, counter):
    """``fused_relax_reduce_pallas`` in the reference's call form, with
    numpy arrays and no device, launches K1/K2 on the card and equals the
    plain version."""
    case = _case(900, 3 * EBLK + 17, 700, 0.3, 31, negative=kind == "min")
    n0 = getattr(frr, counter)
    out, count = frr.fused_relax_reduce_pallas(
        *case, 700, relax, kind, True, True, grid_mode=grid_mode)
    assert getattr(frr, counter) > n0
    assert out.is_cuda and count.is_cuda
    want = fused_relax_reduce_ref(
        *[torch.as_tensor(x, device=dev) for x in case], 700, relax, kind)
    _close_on_card(out, want, kind)


@pytest.mark.parametrize("grid_mode,counter", [
    ("dense", "lanes_launches"), ("device_worklist", "wl_lanes_launches")])
@pytest.mark.parametrize("relax,kind", LANE_PAIRS)
def test_pallas_name_launches_k3_k4(dev, relax, kind, grid_mode, counter):
    """``fused_relax_reduce_lanes_pallas`` with numpy arrays launches
    K3/K4 on the card and equals the plain version."""
    rng = np.random.default_rng(32)
    _, _, src, w, mask, ids = _case(900, 3 * EBLK + 17, 700, 0.3, 32)
    gvq = rng.uniform(0.0, 10.0, (900, 5)).astype(np.float32)
    gcq = rng.random((900, 5)) < 0.3
    unitw = np.array([1, 0, 1, 0, 0], np.int32)
    n0 = getattr(frr, counter)
    out, _ = frr.fused_relax_reduce_lanes_pallas(
        gvq, gcq, unitw, src, w, mask, ids, 700, relax, kind, True, True,
        grid_mode=grid_mode)
    assert getattr(frr, counter) > n0
    assert out.is_cuda
    want = fused_relax_reduce_lanes_ref(
        *[torch.as_tensor(x, device=dev)
          for x in (gvq, gcq, unitw, src, w, mask, ids)],
        700, relax, kind)
    _close_on_card(out, want, kind)


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_pallas_name_launches_k9(dev, kind):
    """``segment_combine_pallas`` with numpy arrays launches K9 on the
    card and equals the plain version."""
    rng = np.random.default_rng(33)
    data = rng.standard_normal(20 * EBLK + 5).astype(np.float32)
    ids = np.sort(rng.integers(0, 3000, data.shape[0])).astype(np.int32)
    n0 = rsr.launches
    out = rsr.segment_combine_pallas(data, ids, 3000, kind)
    assert rsr.launches == n0 + 1
    assert out.is_cuda
    want = segment_combine_ref(torch.as_tensor(data, device=dev),
                               torch.as_tensor(ids, device=dev), 3000, kind)
    _close_on_card(out, want, kind)


# --------------------------------------------------------------------------
# the sharded layout: one shard's launch, and a one-rank NCCL group
# --------------------------------------------------------------------------

def _shard_launch_case(dev, exch, weights):
    """One shard's launch inputs on an RMAT partition: its
    ``DeviceArrays`` (``shard=`` the heaviest row), gathered tables over
    every shard's slots and a frontier of a third of the slots."""
    g = generators.rmat(10, edge_factor=8, seed=3).with_random_weights(
        seed=3)
    if weights == "pagerank":
        from repro_torch.apps.pagerank import _pr_graph
        g = _pr_graph(g)
    part = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=4))
    r = int(np.argmax(part.edge_mask.sum(axis=1)))
    arrays = engine.DeviceArrays.from_partition(part, dev, shard=r)
    rng = np.random.default_rng(r)
    v = part.S * part.R_max
    gval = torch.as_tensor(rng.uniform(0, 9, v).astype(np.float32),
                           device=dev)
    gchg = torch.as_tensor(rng.random(v) < 0.3, device=dev)
    if exch == "compact":
        ct = arrays.compact
        ids, nseg, plan = ct.ids, part.S * part.P_t, ct.plan
    else:
        ids = arrays.edge_dst_flat.reshape(-1)
        nseg, plan = v, arrays.fused_plan
    edges = (arrays.edge_src_root_flat.reshape(-1),
             arrays.edge_w.reshape(-1), arrays.edge_mask.reshape(-1), ids)
    return gval, gchg, edges, nseg, plan


@pytest.mark.parametrize("exch", ["dense", "compact"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K9"])
def test_shard_launch_matches_plain(dev, exch, kernel):
    """K1 (dense), K2 (device worklist), K3 (Q = 5 lanes) and K9 on one
    shard's launch (its edges into ``S*R_max`` dense or ``S*P_t``
    compact segments) against their plain versions: min bit for bit,
    K1's sum within rtol 1e-5 / atol 1e-6."""
    gval, gchg, (src, w, mask, ids), nseg, plan = _shard_launch_case(
        dev, exch, "plain")
    if kernel in ("K1", "K2"):
        grid = "dense" if kernel == "K1" else "device_worklist"
        for relax, kind in PAIRS:
            got, n = frr.fused_relax_reduce(
                gval, gchg, src, w, mask, ids, nseg, relax, kind,
                with_count=True, plan=plan, grid_mode=grid)
            want = fused_relax_reduce_ref(gval, gchg, src, w, mask, ids,
                                          nseg, relax, kind)
            if kind == "min":
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            assert int(n) == int((mask & gchg[src.long()]).sum())
    elif kernel == "K3":
        q = 5
        rng = np.random.default_rng(7)
        gv = torch.as_tensor(rng.uniform(0, 9, (gval.shape[0], q))
                             .astype(np.float32), device=dev)
        gc = torch.as_tensor(rng.random((gval.shape[0], q)) < 0.3,
                             device=dev)
        unitw = torch.as_tensor([1, 0, 1, 0, 0], dtype=torch.int32,
                                device=dev)
        got, n = frr.fused_relax_reduce_lanes(
            gv, gc, unitw, src, w, mask, ids, nseg, "add_w", "min",
            with_count=True, plan=plan)
        want = fused_relax_reduce_lanes_ref(gv, gc, unitw, src, w, mask,
                                            ids, nseg, "add_w", "min")
        assert torch.equal(got, want)
    else:
        active = mask & gchg[src.long()]
        msg = torch.where(active, gval[src.long()] + w, torch.inf)
        got = rsr.segment_combine(msg, ids, nseg, "min", plan=plan)
        assert torch.equal(got, segment_combine_ref(msg, ids, nseg, "min"))


def test_sharded_bfs_on_one_rank_nccl_group(dev):
    """``bfs(..., num_shards=1, mesh=)`` on a one-rank NCCL group over
    the card (the counterpart of ``tests/test_engine_sharded.py:18``):
    the NCCL collectives launch and the levels equal the oracle."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.exchange import collectives
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        assert dist.get_backend(collectives.shard_group(mesh).group) \
            == "nccl"
        g = generators.erdos_renyi(200, avg_degree=4.0, seed=0)
        root = int(g.src[0])
        cfg = engine.EngineConfig(use_pallas=True)
        got, stats, _ = bfs(g, root, num_shards=1, mesh=mesh, cfg=cfg)
        want, want_stats, _ = bfs(g, root, num_shards=1, cfg=cfg)
        np.testing.assert_array_equal(got, reference.bfs_levels(g, root))
        assert [int(x) for x in stats] == [int(x) for x in want_stats]
    finally:
        dist.destroy_process_group()


def test_tracer_spans_share_the_profiler_clock(dev):
    """A ``Tracer`` span around a ~20 ms sleep kernel and its
    ``synchronize()``, mapped onto ``torch.profiler``'s clock
    (``trace_start_ns`` + ``time_range``), contains the kernel within 5 ms
    at each end; prints the kernel's offsets from the span's ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import obs

    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(1_000_000)
    stop.record()
    torch.cuda.synchronize()
    cycles = int(1_000_000 * 20.0 / start.elapsed_time(stop))
    tracer = obs.Tracer()
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    torch.cuda._sleep(1000)            # the thrown-away warm-up step
    torch.cuda.synchronize()
    prof.step()
    with tracer.span("sleep"):
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    prof.step()
    prof.stop()
    base = prof.profiler.kineto_results.trace_start_ns()
    kernel = max((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.end - e.time_range.start)
    k0 = base + kernel.time_range.start * 1e3
    k1 = base + kernel.time_range.end * 1e3
    span = next(e for e in tracer.events() if e["name"] == "sleep")
    s0 = tracer.epoch_ns + span["ts"] * 1e3
    s1 = s0 + span["dur"] * 1e3
    print(f"[clock] kernel {kernel.name[:40]} {(k1 - k0) / 1e6:.3f} ms; "
          f"kernel start - span start {(k0 - s0) / 1e6:+.4f} ms, span end "
          f"- kernel end {(s1 - k1) / 1e6:+.4f} ms")
    assert (k1 - k0) / 1e6 > 10.0
    assert abs(k0 - s0) <= 5e6 and abs(s1 - k1) <= 5e6


def _htod_copies(work, tmp_path, name):
    """The bytes of each host-to-device copy ``work()`` makes on the card,
    read from a ``torch.profiler`` trace (CUDA activity; one thrown-away
    warm-up step first, as the profiler can lose a trace's first
    records)."""
    import json

    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    prof.step()
    out = work()
    torch.cuda.synchronize()
    prof.step()
    prof.stop()
    path = tmp_path / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    assert copies and all("bytes" in e.get("args", {}) for e in copies)
    return [int(e["args"]["bytes"]) for e in copies], out


def test_second_call_uploads_no_partition_table(dev, tmp_path):
    """A second ``apps.bfs`` on one partition copies nothing to the card
    larger than the (S, R_max) initial table: the partition's tables are
    resident.  After ``drop_device_arrays`` the same call copies them
    again, which the trace shows (so it can see such a copy)."""
    g = generators.rmat(14, edge_factor=8, seed=7).with_random_weights(
        seed=7)
    root = int(np.argmax(g.out_degrees()))
    part = build_partition(g, PartitionConfig(num_shards=16, rpvo_max=4))
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="device_worklist")
    first = bfs(g, root, part=part, cfg=cfg)
    assert engine.device_arrays(part, "cuda") is \
        engine.device_arrays(part, torch.device("cuda", 0))
    table = part.S * part.R_max * 4
    warm, second = _htod_copies(
        lambda: bfs(g, root, part=part, cfg=cfg), tmp_path, "warm")
    engine.drop_device_arrays(part)
    cold, third = _htod_copies(
        lambda: bfs(g, root, part=part, cfg=cfg), tmp_path, "cold")
    print(f"[resident] S*R_max*4 = {table} B; warm call's copies "
          f"{sorted(warm)[-3:]} B (largest three), cold call's "
          f"{sorted(cold)[-3:]}")
    assert max(warm) <= table
    assert max(cold) > table
    np.testing.assert_array_equal(second[0], reference.bfs_levels(g, root))
    for other in (first, third):
        np.testing.assert_array_equal(second[0], other[0])
        assert [int(x) for x in second[1]] == [int(x) for x in other[1]]
