"""The port's tiled residency path (kernels K5-K8: their plain versions on
the CPU) against the reference's, on the same inputs and partitions.

Residency selection follows the reference's rules (budget, env var,
forced path/vblk, the index-table guard), with the Hopper tile width;
the per-chunk tile tables equal the reference's; the four plain tiled
launches equal the reference's tiled kernels in interpret mode (min
bit-equal, sum within rtol 1e-5 / atol 1e-6, cells equal; the port's
launches stage rows, counted by the mirror's ``fused_staged_rows`` and
the planner's ``staged_rows``, while the mirrors of the reference's tile
copies, ``fused_tile_dmas`` and ``plan(..., tile_lists=True)``, hold its
counts); the tiled worklist plain versions equal the pinned ones (K2's,
K4's) bit for bit; the default tiled planner builds no tile list, and
with ``tile_lists`` its plans equal the reference planner's but for the
copy schedule, which restarts at each run of cells sharing a chunk;
device plans equal in cells and tile lists; and BFS, SSSP, PageRank,
delta-PageRank and the lane runners with a value table over the budget
give the reference's values and exactly equal stats.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro import apps as ref_apps  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.apps.pagerank import _pr_graph as ref_pr_graph  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro.kernels import fused_relax_reduce as ref_frr  # noqa: E402
from repro.query import lanes as ref_lanes  # noqa: E402
from repro_torch import apps, interop, obs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.query import lanes  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                       # pragma: no cover
    HAVE_HYPOTHESIS = False

EBLK, SBLK = frr.EBLK, frr.SBLK
TINY_BUDGET = 256        # bytes: every table goes tiled
PAIRS = [("add_w", "min"), ("add_one", "min"), ("mul_w", "sum")]
LANE_PAIRS = [("add_w", "min"), ("mul_w", "sum")]
GRIDS = ["dense", "worklist", "device_worklist"]


def _case(v, e, nseg, frac, seed, q=None):
    """Sources from a small hub pool over the whole table, so chunks touch
    several tiles and cells share chunks."""
    rng = np.random.default_rng(seed)
    shape = (v,) if q is None else (v, q)
    gval = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    gchg = rng.random(shape) < frac
    src = rng.permutation(v)[rng.integers(0, max(v // 6, 1), e)] \
        .astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = np.sort(rng.integers(0, nseg, e)).astype(np.int32)
    return gval, gchg, src, w, mask, ids


def _assert_close(got, want, kind):
    if kind == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture
def room():
    """Narrow ``TILE_SMEM_BYTES`` to two 128-slot tiles of ``q`` lanes, so
    that a table of a few hundred slots spans several tiles."""
    saved = frr.TILE_SMEM_BYTES

    def narrow(q=1):
        frr.TILE_SMEM_BYTES = frr.tile_smem_bytes(128, q)

    yield narrow
    frr.TILE_SMEM_BYTES = saved


# --------------------------------------------------------------------------
# residency selection
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_slots,q,budget", [
    (1, 1, 512), (128, 1, 512), (129, 1, 512), (600, 1, 2400),
    (600, 1, 3072), (600, 5, 3072 * 5), (600, 5, 3071 * 5), (300, 16, 1),
    (5000, 33, 10**9)])
def test_path_decisions_match_reference(num_slots, q, budget):
    for forced in (None, 128, 256):
        want = ref_frr.select_kernel_path(num_slots, q, budget, vblk=forced)
        got = frr.select_kernel_path(num_slots, q, budget, vblk=forced)
        assert got[0] == want[0]
        if forced is not None and got[0] == "tiled":
            assert got == want
    for path in ("pinned", "tiled"):
        assert frr.select_kernel_path(num_slots, q, budget, path=path,
                                      vblk=128) \
            == ref_frr.select_kernel_path(num_slots, q, budget, path=path,
                                          vblk=128)


def test_budget_resolution_and_env_override(monkeypatch):
    monkeypatch.delenv(frr.VMEM_BUDGET_ENV, raising=False)
    assert frr.VMEM_BUDGET_ENV == ref_frr.VMEM_BUDGET_ENV
    assert frr.resolve_vmem_budget() == frr.DEFAULT_VMEM_BUDGET_BYTES
    assert frr.resolve_vmem_budget(77) == ref_frr.resolve_vmem_budget(77)
    # the default keeps an RMAT-18 Q = 16 table (17 MB) pinned
    assert frr.select_kernel_path(266_912, 16)[0] == "pinned"
    monkeypatch.setenv(frr.VMEM_BUDGET_ENV, "")
    assert frr.resolve_vmem_budget() == frr.DEFAULT_VMEM_BUDGET_BYTES
    monkeypatch.setenv(frr.VMEM_BUDGET_ENV, "1024")
    assert frr.resolve_vmem_budget() == ref_frr.resolve_vmem_budget() == 1024
    assert frr.resolve_vmem_budget(5) == 5          # an argument wins
    for n in (256, 257):
        assert frr.select_kernel_path(n)[0] \
            == ref_frr.select_kernel_path(n)[0]


@pytest.mark.parametrize("n_chunks,t_max,wl_cells", [
    (1, 0, 0), (17, 0, 0), (17, 5, 0), (17, 0, 64), (17, 5, 64)])
def test_smem_table_bytes_match_reference(n_chunks, t_max, wl_cells):
    assert frr.smem_table_bytes(n_chunks, t_max, wl_cells) \
        == ref_frr.smem_table_bytes(n_chunks, t_max, wl_cells)


@pytest.mark.parametrize("kw", [dict(vblk=0), dict(vblk=100),
                                dict(vblk=-128), dict(path="hbm")])
def test_bad_paths_raise_like_reference(kw):
    for mod in (ref_frr, frr):
        with pytest.raises(ValueError):
            mod.select_kernel_path(1000, 1, TINY_BUDGET, **kw)


@pytest.mark.parametrize("q", [1, 5, 16, 33])
def test_auto_vblk_is_the_largest_tile_the_room_holds(q):
    lanes_a_block = min(q, 32)
    want = frr.TILE_SMEM_BYTES // (2 * lanes_a_block * 4) // 128 * 128
    path, vblk = frr.select_kernel_path(10**6, q, TINY_BUDGET)
    assert path == "tiled" and vblk == want
    assert frr.tile_smem_bytes(vblk, q) <= frr.TILE_SMEM_BYTES \
        < frr.tile_smem_bytes(vblk + 128, q)
    # capped at the padded table
    assert frr.select_kernel_path(300, q, TINY_BUDGET) == ("tiled", 384)
    # a forced tile wider than the room is accepted, as in the
    # reference: no kernel allocates a tile
    big = want + 128
    assert frr.select_kernel_path(10**6, q, TINY_BUDGET, vblk=big) \
        == ref_frr.select_kernel_path(10**6, q, TINY_BUDGET, vblk=big) \
        == ("tiled", big)


@pytest.mark.parametrize("q,vblk", [(1, 16384), (16, 1024), (33, 768),
                                    (1, 12288)])
def test_forced_vblk_matches_reference(q, vblk):
    """A forced positive multiple of 128 gives the reference's (path,
    vblk), whatever the shared-memory room holds."""
    for path in (None, "tiled"):
        got = frr.select_kernel_path(100_000, q, TINY_BUDGET, path=path,
                                     vblk=vblk)
        want = ref_frr.select_kernel_path(100_000, q, TINY_BUDGET,
                                          path=path, vblk=vblk)
        assert got == want == ("tiled", vblk)


def test_smem_guard_widens_like_reference():
    """Tile lists over ``smem_budget_bytes`` widen a forced 128-slot tile
    as the reference widens it, with its warning; a pinned launch over
    the guard warns."""
    kw = dict(vblk=128, n_chunks=40, smem_budget_bytes=1300)
    with pytest.warns(UserWarning, match="widened to vblk=512"):
        want = ref_frr.select_kernel_path(2000, 1, TINY_BUDGET, **kw)
    with pytest.warns(UserWarning, match="widened to vblk=512"):
        got = frr.select_kernel_path(2000, 1, TINY_BUDGET, **kw)
    assert got == want == ("tiled", 512)
    with pytest.warns(UserWarning, match="smem_budget_bytes=16"):
        frr.select_kernel_path(100, 1, None, n_chunks=40,
                               smem_budget_bytes=16)


# --------------------------------------------------------------------------
# tile tables
# --------------------------------------------------------------------------

SHAPES = [(1, 1, 1), (129, 300, 50), (257, 2 * EBLK + 13, SBLK + 5),
          (600, 4 * EBLK - 1, 2 * SBLK + 1)]
FRACS = [0.0, 0.05, 0.5, 1.0]


@pytest.mark.parametrize("vblk", [128, 256])
@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_tile_tables_match_reference(v, e, nseg, frac, vblk):
    _, gchg, src, _, mask, ids = _case(v, e, nseg, frac, v + e)
    act = torch.as_tensor(mask & gchg[src])
    tt = frr._chunk_tile_tables(torch.as_tensor(src), act, v, vblk)
    e_pad = -(-e // EBLK) * EBLK
    src_p = np.zeros(e_pad, np.int32)
    src_p[:e] = src
    act_p = np.zeros(e_pad, np.int32)
    act_p[:e] = act.numpy()
    v_pad = -(-v // vblk) * vblk
    want_n, want_t = ref_frr._chunk_tile_tables(
        jnp.asarray(src_p), jnp.asarray(act_p.reshape(-1, EBLK)), v_pad,
        vblk)
    want_n, want_t = np.asarray(want_n), np.asarray(want_t)
    np.testing.assert_array_equal(tt.ntiles.numpy(), want_n)
    assert tt.t_max == want_t.shape[1] and tt.n_tiles == v_pad // vblk
    order, off = tt.order.numpy(), tt.off.numpy()
    act_c = act_p.reshape(-1, EBLK).astype(bool)
    tile_c = src_p.reshape(-1, EBLK) // vblk
    for j, n in enumerate(want_n):
        np.testing.assert_array_equal(tt.tiles.numpy()[j, :n], want_t[j, :n])
        # tile k's own edges: its active edges, in chunk order
        for k in range(n):
            pos = order[j, off[j, k]:off[j, k + 1]]
            want_pos = np.flatnonzero(act_c[j] & (tile_c[j] == want_t[j, k]))
            np.testing.assert_array_equal(pos, want_pos)
        assert (off[j, n:] == act_c[j].sum()).all()


# --------------------------------------------------------------------------
# the plain tiled launches against the reference's tiled kernels
# --------------------------------------------------------------------------

def _ref_launch(case, nseg, relax, kind, grid_mode, vblk, unitw=None):
    args = [jnp.asarray(x) for x in case]
    kw = dict(interpret=True, with_count=True, with_debug=True,
              grid_mode=grid_mode, path="tiled", vblk=vblk)
    if unitw is None:
        return ref_frr.fused_relax_reduce_pallas(*args, nseg, relax, kind,
                                                 **kw)
    return ref_frr.fused_relax_reduce_lanes_pallas(
        args[0], args[1], jnp.asarray(unitw), *args[2:], nseg, relax, kind,
        **kw)


def _check_launch(got, want, kind, grid_mode, case, nseg, vblk, q=1):
    out, count, dbg = got
    w_out, w_count, w_dbg = want
    _assert_close(out.numpy(), np.asarray(w_out), kind)
    np.testing.assert_array_equal(count.numpy(), np.asarray(w_count))
    cells, rows = (int(x) for x in dbg)
    assert cells == int(w_dbg[0])
    gchg = case[1].any(axis=-1) if case[1].ndim == 2 else case[1]
    # the port stages rows, the same under every launch shape; the
    # mirrors keep the reference's tile copies
    m = frr.fused_grid_cells(case[5], case[4], case[2], gchg, nseg,
                             vblk=vblk, lane_width=q)
    assert rows == m["fused_staged_rows"]
    if grid_mode == "worklist":
        _, info = frr.plan_worklist(case[5], case[4], case[2], gchg, nseg,
                                    path="tiled", vblk=vblk, lane_width=q,
                                    tile_lists=True)
        assert (cells, rows) == (info.cells, info.staged_rows)
        # the mirror's schedule restarts at each run of cells sharing a
        # chunk
        assert info.tile_dmas >= int(w_dbg[1])
    else:
        if grid_mode == "dense":
            assert cells == m["fused_live"]
        assert m["fused_tile_dmas"] == int(w_dbg[1])


@pytest.mark.parametrize("grid_mode", GRIDS)
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg,vblk", [
    (257, 2 * EBLK + 13, SBLK + 5, 128), (600, 4 * EBLK - 1, 700, 256)])
def test_tiled_launch_matches_reference(v, e, nseg, vblk, relax, kind,
                                        grid_mode):
    case = _case(v, e, nseg, 0.4, v + e)
    got = frr.fused_relax_reduce(
        *(torch.as_tensor(x) for x in case), nseg, relax, kind,
        with_count=True, with_debug=True, grid_mode=grid_mode, path="tiled",
        vblk=vblk)
    want = _ref_launch(case, nseg, relax, kind, grid_mode, vblk)
    _check_launch(got, want, kind, grid_mode, case, nseg, vblk)
    # min is bit-equal to the pinned launch and to the oracle
    if kind == "min":
        pinned = frr.fused_relax_reduce(*(torch.as_tensor(x) for x in case),
                                        nseg, relax, kind,
                                        grid_mode=grid_mode)
        assert torch.equal(got[0], pinned)


@pytest.mark.parametrize("grid_mode", GRIDS)
@pytest.mark.parametrize("relax,kind", LANE_PAIRS)
@pytest.mark.parametrize("q", [1, 5])
def test_tiled_lanes_launch_matches_reference(q, relax, kind, grid_mode):
    v, e, nseg, vblk = 300, 2 * EBLK + 13, SBLK + 40, 128
    gval, gchg, src, w, mask, ids = _case(v, e, nseg, 0.3, q, q=q)
    if q > 1:
        gchg[:, q // 2] = False                 # a converged lane
    unitw = (np.arange(q) % 2).astype(np.int32)
    case = (gval, gchg, src, w, mask, ids)
    t = [torch.as_tensor(x) for x in case]
    got = frr.fused_relax_reduce_lanes(
        t[0], t[1], torch.as_tensor(unitw), *t[2:], nseg, relax, kind,
        with_count=True, with_debug=True, grid_mode=grid_mode, path="tiled",
        vblk=vblk)
    want = _ref_launch(case, nseg, relax, kind, grid_mode, vblk, unitw)
    _check_launch(got, want, kind, grid_mode, case, nseg, vblk, q)
    if kind == "min":
        pinned = frr.fused_relax_reduce_lanes(
            t[0], t[1], torch.as_tensor(unitw), *t[2:], nseg, relax, kind,
            grid_mode=grid_mode)
        assert torch.equal(got[0], pinned)


def test_plain_tiled_frontier_extremes():
    """An empty frontier stages nothing; a full one stages at least one
    row per executed cell, and every launch shape stages a row per valid
    edge, as the mirror counts."""
    for frac, relax, kind in ((0.0, "add_w", "min"), (1.0, "mul_w", "sum")):
        raw = _case(400, 3 * EBLK, 700, frac, 5)
        case = [torch.as_tensor(x) for x in raw]
        for grid_mode in GRIDS:
            out, dbg = frr.fused_relax_reduce(
                *case, 700, relax, kind, with_debug=True,
                grid_mode=grid_mode, path="tiled", vblk=128)
            cells, copies = (int(x) for x in dbg)
            if frac == 0.0:
                assert (cells, copies) == (0, 0)
                assert bool((out == np.inf).all())
            else:
                assert copies >= cells > 0
            m = frr.fused_grid_cells(raw[5], raw[4], raw[2], raw[1], 700,
                                     vblk=128)
            assert copies == m["fused_staged_rows"] \
                == int(raw[4].sum()) * (frac == 1.0)
            if grid_mode == "dense":
                assert cells == m["fused_live"]


def _staged_case(v, e, nseg, frac, q, layout, seed):
    """A case whose ids are one sorted run ("sorted") or two shards'
    sorted runs back to back ("straddle": the chunk at the seam spans the
    whole segment range), with a (V,) or (V, q) frontier."""
    gval, gchg, src, w, mask, ids = _case(v, e, nseg, frac, seed, q=q)
    if layout == "straddle":
        cut = e // 2 + EBLK // 3
        ids = np.r_[np.sort(ids[:cut]), np.sort(ids[cut:])].astype(np.int32)
    return gval, gchg, src, w, mask, ids


def _staged_rows_by_definition(gchg, src, mask, ids, nseg):
    """Rows the dense tiled kernels stage, from their definition: each
    live (chunk, segment block) cell whose block meets the chunk's id
    range stages a row per active edge landing in its block."""
    gor = gchg.any(axis=1) if gchg.ndim == 2 else gchg
    act = mask & gor[src]
    rows = 0
    for j in range(-(-ids.shape[0] // EBLK)):
        sl = slice(j * EBLK, (j + 1) * EBLK)
        if not act[sl].any():
            continue                            # a dead chunk is skipped
        lo, hi = ids[sl][mask[sl]].min(), ids[sl][mask[sl]].max()
        for i in range(lo // SBLK, hi // SBLK + 1):
            rows += int((act[sl] & (ids[sl] // SBLK == i)).sum())
    return rows, int(act.sum())


@pytest.mark.parametrize("layout", ["sorted", "straddle"])
@pytest.mark.parametrize("q", [None, 1, 5, 16, 33])
@pytest.mark.parametrize("frac", FRACS)
def test_staged_rows_mirror_matches_definition(frac, q, layout):
    """The staged-row mirror equals a count from the definition and the
    plain dense tiled launch's own count: every active edge (active in
    some lane) is staged once, by its own cell, with a straddling chunk's
    cells included; the bytes are rows x Q x 4."""
    v, e, nseg = 600, 4 * EBLK - 1, 2 * SBLK + 1
    case = _staged_case(v, e, nseg, frac, q, layout, 17 + (q or 0))
    gval, gchg, src, w, mask, ids = case
    want, n_act = _staged_rows_by_definition(gchg, src, mask, ids, nseg)
    assert want == n_act
    lanes = q or 1
    m = frr.fused_grid_cells(ids, mask, src, gchg, nseg, vblk=128,
                             lane_width=lanes)
    assert m["fused_staged_rows"] == want
    assert m["staged_bytes"] == want * lanes * 4
    t = [torch.as_tensor(x) for x in case]
    if q is None:
        _, dbg = frr.fused_relax_reduce(*t, nseg, "add_w", "min",
                                        with_debug=True, path="tiled",
                                        vblk=128)
    else:
        _, dbg = frr.fused_relax_reduce_lanes(
            t[0], t[1], torch.zeros(q, dtype=torch.int32), *t[2:], nseg,
            "add_w", "min", with_debug=True, path="tiled", vblk=128)
    assert (int(dbg[0]), int(dbg[1])) == (m["fused_live"], want)


@pytest.mark.parametrize("q", [None, 1, 5, 16, 33])
@pytest.mark.parametrize("relax", ["add_w", "add_one"])
def test_dense_tiled_plain_min_equals_pinned_plain(relax, q):
    """The dense tiled launch's plain output is the pinned plain output
    (``fused_relax_reduce_ref``) bit for bit on min, as K5/K7 equal
    K1/K3 on the card."""
    if q is not None and relax == "add_one":
        relax = "add_w"                         # the laned BFS form
    v, e, nseg = 600, 4 * EBLK - 1, 700
    case = _staged_case(v, e, nseg, 0.4, q, "straddle", 3 + (q or 0))
    t = [torch.as_tensor(x) for x in case]
    if q is None:
        got = frr.fused_relax_reduce(*t, nseg, relax, "min", path="tiled",
                                     vblk=128)
        want = ref.fused_relax_reduce_ref(*t, nseg, relax, "min")
    else:
        unitw = torch.as_tensor((np.arange(q) % 2).astype(np.int32))
        got = frr.fused_relax_reduce_lanes(t[0], t[1], unitw, *t[2:], nseg,
                                           relax, "min", path="tiled",
                                           vblk=128)
        want = ref.fused_relax_reduce_lanes_ref(t[0], t[1], unitw, *t[2:],
                                                nseg, relax, "min")
    assert torch.equal(got, want)
    assert bool(torch.isfinite(want).any())


# --------------------------------------------------------------------------
# tiled plans: host planner and device compaction
# --------------------------------------------------------------------------

def _sequential_schedule(wl_j, nlive, cell_ntiles, cell_tile):
    """The reference planner's 2-slot schedule loop, restarted at each run
    of consecutive cells that share ``wl_j``."""
    cell_slot = np.zeros_like(cell_tile)
    cell_fetch = np.zeros_like(cell_tile)
    fetches = 0
    for c in range(nlive):
        if c == 0 or wl_j[c] != wl_j[c - 1]:
            resident, prev_slot = [-1, -1], 1
        for k in range(cell_ntiles[c]):
            tile = cell_tile[c, k]
            if tile == resident[0]:
                slot, fetch = 0, 0
            elif tile == resident[1]:
                slot, fetch = 1, 0
            else:
                slot, fetch = 1 - prev_slot, 1
                resident[slot] = tile
                fetches += 1
            cell_slot[c, k], cell_fetch[c, k] = slot, fetch
            prev_slot = slot
    return cell_slot, cell_fetch, fetches


@pytest.mark.parametrize("dst_filter", [True, False])
@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_tiled_host_plan_matches_reference(v, e, nseg, frac, dst_filter):
    _, gchg, src, _, mask, ids = _case(v, e, nseg, frac, v + e + 1)
    kw = dict(path="tiled", vblk=128, lane_width=3, dst_filter=dst_filter)
    want, want_info = ref_frr.plan_worklist(ids, mask, src, gchg, nseg, **kw)
    got, info = frr.plan_worklist(ids, mask, src, gchg, nseg, **kw,
                                  tile_lists=True)
    assert got.path == "tiled" and got.vblk == 128
    n_act = int((mask & gchg[src]).sum())
    assert (info.staged_rows, info.staged_bytes) == (n_act, n_act * 3 * 4)
    for name in ("wl_i", "wl_j", "nlive", "cell_ntiles", "cell_tile"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name))
    n = int(want.nlive[0])
    slot, fetch, fetches = _sequential_schedule(
        want.wl_j, n, want.cell_ntiles, want.cell_tile)
    np.testing.assert_array_equal(got.cell_slot.numpy(), slot)
    np.testing.assert_array_equal(got.cell_fetch.numpy(), fetch)
    assert info.tile_dmas == fetches >= want_info.tile_dmas
    assert info.dma_bytes == fetches * 128 * 3 * 4
    for f in ("cells", "launched", "dense_live", "tile_needed",
              "smem_table_bytes"):
        assert getattr(info, f) == getattr(want_info, f)
    # a reference plan carried across gets the port's schedule
    carried = interop.worklist_from_dict(vars(want))
    np.testing.assert_array_equal(carried.cell_fetch.numpy(), fetch)
    np.testing.assert_array_equal(carried.cell_slot.numpy(), slot)


@pytest.mark.parametrize("dst_filter", [True, False])
@pytest.mark.parametrize("q", [None, 5])
@pytest.mark.parametrize("v,e,nseg", SHAPES[1:])
def test_default_tiled_plan_builds_no_tile_lists(monkeypatch, v, e, nseg, q,
                                                 dst_filter):
    """The default tiled plan (what launches and round loops use) builds
    no tile list and no schedule, and still equals the reference planner
    in cells, order and counts; it counts a staged row per active edge
    (active in some lane)."""
    _, gchg, src, _, mask, ids = _case(v, e, nseg, 0.3, v + e + 3, q=q)
    gor = gchg.any(axis=1) if q else gchg
    kw = dict(path="tiled", vblk=128, dst_filter=dst_filter)
    want, want_info = ref_frr.plan_worklist(ids, mask, src, gor, nseg, **kw)

    def refuse(*args, **kwargs):
        raise AssertionError("a tile list built for a tiled launch")

    monkeypatch.setattr(frr, "tile_schedule", refuse)
    monkeypatch.setattr(frr, "_distinct_tiles", refuse)
    lanes_ = q or 1
    got, info = frr.plan_worklist(ids, mask, src, gchg, nseg, **kw,
                                  lane_width=lanes_)
    assert got.path == "tiled" and not got.has_cell_tiles
    for name in ("wl_i", "wl_j", "nlive"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name))
    for f in ("cells", "launched", "dense_live", "smem_table_bytes"):
        assert getattr(info, f) == getattr(want_info, f)
    n_act = int((mask & gor[src]).sum())
    assert (info.tile_dmas, info.staged_rows, info.staged_bytes) \
        == (0, n_act, n_act * lanes_ * 4)


@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("q,relax,kind", [
    (None, "add_w", "min"), (None, "add_one", "min"), (None, "mul_w", "sum")]
    + [(q, r, k) for q in (1, 5, 16, 33) for r, k in LANE_PAIRS])
def test_tiled_worklist_plain_equals_pinned_plain(q, relax, kind, grid_mode):
    """The tiled worklist plain versions (K6's, K8's) are K2's and K4's
    bit for bit, sum included, as the kernels are on the card; their
    staged rows equal the host plan's ``staged_rows`` or, on a device
    plan, the dense mirror's, and both equal K5's / K7's count on the
    same round."""
    v, e, nseg = 600, 4 * EBLK - 1, 2 * SBLK + 1
    case = _staged_case(v, e, nseg, 0.4, q, "straddle", 29 + (q or 0))
    gval, gchg, src, w, mask, ids = case
    t = [torch.as_tensor(x) for x in case]
    gor = gchg.any(axis=1) if q else gchg
    planner = frr.WorklistPlanner(ids, mask, src, nseg, num_slots=v,
                                  path="tiled", vblk=128,
                                  lane_width=q or 1)
    if grid_mode == "worklist":
        wl, info = planner.plan(gor)
        want_rows = info.staged_rows
    else:
        wl = frr.build_device_worklist(torch.as_tensor(gor), t[2], t[4],
                                       t[5], nseg, path="tiled", vblk=128)
        want_rows = planner.dense_mirror(gor)["staged_rows"]
    args = (wl.wl_i, wl.wl_j, wl.nlive, nseg, relax, kind)
    if q is None:
        plain, rows = ref.fused_relax_reduce_wl_tiled_ref(*t, *args)
        pinned = ref.fused_relax_reduce_wl_ref(*t, *args)
        launch = frr.fused_relax_reduce
        head = t[:2]
    else:
        unitw = torch.as_tensor((np.arange(q) % 2).astype(np.int32))
        plain, rows = ref.fused_relax_reduce_wl_tiled_lanes_ref(
            t[0], t[1], unitw, *t[2:], *args)
        pinned = ref.fused_relax_reduce_wl_lanes_ref(t[0], t[1], unitw,
                                                     *t[2:], *args)
        launch = frr.fused_relax_reduce_lanes
        head = [t[0], t[1], unitw]
    assert torch.equal(plain, pinned)
    assert bool(torch.isfinite(plain).any())
    _, dbg = launch(*head, *t[2:], nseg, relax, kind, with_debug=True,
                    worklist=wl)
    _, dense_dbg = launch(*head, *t[2:], nseg, relax, kind, with_debug=True,
                          path="tiled", vblk=128)
    assert int(rows) == int(dbg[1]) == want_rows == int(dense_dbg[1]) \
        == int((mask & gor[src]).sum())


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(data=st.data(), nlive=st.integers(0, 40),
           n_tiles=st.integers(1, 9))
    def test_tile_schedule_is_the_restarted_lru(data, nlive, n_tiles):
        """The closed-form schedule equals the sequential 2-slot LRU,
        restarted at each run, on arbitrary runs and tile lists."""
        t_max = n_tiles
        runs = data.draw(st.lists(st.booleans(), min_size=nlive,
                                  max_size=nlive))
        wl_j = np.cumsum([True] + runs[1:]) if nlive else np.zeros(0, int)
        wl_j = np.r_[wl_j, np.zeros(3, int)].astype(np.int32)
        cell_ntiles = np.zeros(nlive + 3, np.int32)
        cell_tile = np.zeros((nlive + 3, t_max), np.int32)
        for c in range(nlive):
            tiles = sorted(data.draw(st.sets(st.integers(0, n_tiles - 1),
                                             min_size=1)))
            cell_ntiles[c] = len(tiles)
            cell_tile[c, :len(tiles)] = tiles
        got = frr.tile_schedule(wl_j, nlive, cell_ntiles, cell_tile)
        want = _sequential_schedule(wl_j, nlive, cell_ntiles, cell_tile)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("v,e,nseg", SHAPES[1:])
def test_tiled_device_plan_matches_reference(v, e, nseg, frac):
    """The device plan's cells are the reference's; each cell's tile list
    is its chunk's, as the reference's device plan lists it."""
    _, gchg, src, _, mask, ids = _case(v, e, nseg, frac, v + e + 2)
    t = [torch.as_tensor(x) for x in (gchg, src, mask, ids)]
    got = frr.build_device_worklist(*t, nseg, path="tiled", vblk=128)
    assert got.path == "tiled" and not got.has_cell_tiles
    want = ref_frr.build_device_worklist(
        *(jnp.asarray(x) for x in (gchg, src, mask, ids)), nseg, "tiled", 128,
        v)
    n = int(want.nlive[0])
    assert int(got.nlive[0]) == n
    np.testing.assert_array_equal(got.wl_i[:n].numpy(),
                                  np.asarray(want.wl_i)[:n])
    np.testing.assert_array_equal(got.wl_j[:n].numpy(),
                                  np.asarray(want.wl_j)[:n])
    tt = frr._chunk_tile_tables(t[1], t[2] & t[0][t[1].long()], v, 128)
    j = got.wl_j[:n].long()
    np.testing.assert_array_equal(tt.ntiles[j].numpy(),
                                  np.asarray(want.cell_ntiles)[:n])
    want_t = np.asarray(want.cell_tile)[:n]
    for c in range(n):
        k = int(tt.ntiles[j[c]])
        np.testing.assert_array_equal(tt.tiles[j[c], :k].numpy(),
                                      want_t[c, :k])


# --------------------------------------------------------------------------
# the engine with a value table over the budget
# --------------------------------------------------------------------------

def _partitions(pr=False):
    """(reference graph, port graph, root, reference partition, port
    partition carried across); ``pr`` partitions the PageRank graph."""
    g_ref = ref_generators.rmat(8, edge_factor=4, seed=3)
    g = generators.rmat(8, edge_factor=4, seed=3)
    if pr:
        built = ref_pr_graph(g_ref)
    else:
        g_ref, g = g_ref.with_random_weights(seed=3), \
            g.with_random_weights(seed=3)
        built = g_ref
    part_ref = ref_partition.build_partition(
        built, ref_partition.PartitionConfig(num_shards=4, rpvo_max=4))
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    return g_ref, g, int(np.argmax(g.out_degrees())), part_ref, part


def _stats(stats):
    return [int(x) for x in stats]


def test_engine_partition_spans_tiles(room):
    room(1)
    _, _, _, _, part = _partitions()
    v = part.S * part.R_max
    assert 300 < v <= 600
    path, vblk = frr.select_kernel_path(v, 1, TINY_BUDGET)
    assert path == "tiled" and vblk == 128 and -(-v // vblk) >= 3


@pytest.mark.parametrize("grid_mode", GRIDS)
@pytest.mark.parametrize("app", ["bfs", "sssp"])
def test_fixpoint_over_budget_matches_reference(room, app, grid_mode):
    room(1)
    g_ref, g, root, part_ref, part = _partitions()
    kw = dict(use_pallas=True, grid_mode=grid_mode,
              vmem_budget_bytes=TINY_BUDGET)
    want, want_st, _ = getattr(ref_apps, app)(
        g_ref, root, part=part_ref, cfg=ref_engine.EngineConfig(**kw))
    got, st_, _ = getattr(apps, app)(g, root, part=part,
                                     cfg=engine.EngineConfig(**kw),
                                     device="cpu")
    np.testing.assert_array_equal(got, want)
    assert _stats(st_) == _stats(want_st)


@pytest.mark.parametrize("grid_mode", ["dense", "auto", "device_worklist"])
def test_pagerank_over_budget_matches_reference(room, grid_mode):
    room(1)
    g_ref, g, _, part_ref, part = _partitions(pr=True)
    kw = dict(use_pallas=True, grid_mode=grid_mode,
              vmem_budget_bytes=TINY_BUDGET)
    cfg_ref, cfg = ref_engine.EngineConfig(**kw), engine.EngineConfig(**kw)
    if grid_mode == "dense":
        want, _ = ref_apps.pagerank(g_ref, iters=12, part=part_ref,
                                    cfg=cfg_ref)
        got, _ = apps.pagerank(g, iters=12, part=part, cfg=cfg,
                               device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    want, want_st, _ = ref_apps.pagerank_delta(
        g_ref, tol=1e-4, part=part_ref, cfg=cfg_ref)
    got, st_, _ = apps.pagerank_delta(g, tol=1e-4, part=part, cfg=cfg,
                                      device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    assert _stats(st_) == _stats(want_st)


def _lane_stats(stats):
    return {f: [int(x) for x in np.asarray(getattr(stats, f))]
            for f in stats._fields}


@pytest.mark.parametrize("grid_mode", GRIDS)
def test_lanes_over_budget_match_reference(room, grid_mode):
    room(3)
    _, _, root, part_ref, part = _partitions()
    init, unitw = lanes.init_lane_values(
        part, [("bfs", root), ("sssp", 5), ("bfs", [1, 7])])
    kw = dict(use_pallas=True, grid_mode=grid_mode,
              vmem_budget_bytes=TINY_BUDGET)
    want, want_st = ref_lanes.run_stacked_lanes(
        part_ref, init, unitw, ref_engine.EngineConfig(**kw))
    got, st_ = lanes.run_stacked_lanes(part, init, unitw,
                                       engine.EngineConfig(**kw),
                                       device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _lane_stats(st_) == _lane_stats(want_st)


@pytest.mark.parametrize("grid_mode", ["auto", "device_worklist"])
def test_ppr_delta_lanes_over_budget_match_reference(room, grid_mode):
    room(2)
    _, _, root, part_ref, part = _partitions(pr=True)
    seeds, damps = [root, 3], [0.85, 0.6]
    kw = dict(use_pallas=True, grid_mode=grid_mode,
              vmem_budget_bytes=TINY_BUDGET)
    want, want_st = ref_lanes.run_ppr_delta_lanes(
        part_ref, seeds, damps, ref_engine.EngineConfig(**kw), tol=1e-5)
    got, st_ = lanes.run_ppr_delta_lanes(part, seeds, damps,
                                         engine.EngineConfig(**kw),
                                         tol=1e-5, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)
    assert _lane_stats(st_) == _lane_stats(want_st)


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
def test_recorder_tile_copies_equal_the_mirror(room, grid_mode):
    """The flight recorder's copy columns are the planner mirror's staged
    rows (4 bytes each on every tiled round, worklist and device windows
    included), and the launches' own row counters equal them round by
    round."""
    room(1)
    _, g, root, _, part = _partitions()
    cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid_mode,
                              vmem_budget_bytes=TINY_BUDGET)
    with obs.recording() as rec:
        apps.sssp(g, root, part=part, cfg=cfg, device="cpu")
    rounds = [r for r in rec.rounds if r.run == "sssp"]
    assert rounds and all(r.path == "tiled" for r in rounds)
    # every tiled round stages rows, 4 bytes each
    assert all(r.dma_bytes == r.tile_dmas * 4 for r in rounds)
    if grid_mode == "device_worklist":
        assert sum(r.tile_dmas for r in rounds) > 0
        return
    planner = engine.launch_planner(part, cfg)
    # replay the rounds: the frontier entering each round from the values
    from repro_torch.core import actions
    from repro_torch import exchange
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    val = torch.as_tensor(engine.init_values(part, actions.SSSP,
                                             {root: 0.0}))
    chg = (val == 0) & arrays.slot_valid
    t = [x.reshape(-1) for x in (arrays.edge_src_root_flat, arrays.edge_w,
                                 arrays.edge_mask, arrays.edge_dst_flat)]
    nseg = part.S * part.R_max
    for r in rounds:
        gchg = chg.reshape(-1)
        wl = None
        if r.grid == "worklist":
            wl, info = planner.plan(gchg.numpy())
            assert (r.cells, r.tile_dmas, r.dma_bytes) == (
                info.cells, info.staged_rows, info.staged_bytes)
        else:
            d = planner.dense_mirror(gchg.numpy())
            assert (r.cells, r.tile_dmas, r.dma_bytes) == (
                d["cells"], d["staged_rows"], d["staged_bytes"])
        _, dbg = frr.fused_relax_reduce(
            val.reshape(-1), gchg, *t, nseg, "add_w", "min", with_debug=True,
            worklist=wl, path="tiled", vblk=128, plan=arrays.fused_plan)
        assert (int(dbg[0]), int(dbg[1])) == (r.cells, r.tile_dmas)
        val, chg, _ = exchange.fixpoint_round_stacked(
            actions.SSSP, arrays, cfg, part.S, part.R_max, val, chg,
            worklist=wl)


def test_lane_planner_judges_residency_at_q_lanes(monkeypatch):
    """A Q-lane table over the budget at Q lanes but not at one plans
    tiled: the min-lane runner's planner gets the lane count."""
    _, _, root, part_ref, part = _partitions()
    v_pad = -(-(part.S * part.R_max) // 128) * 128
    budget = v_pad * 4 * 2                # pinned at Q <= 2, tiled at 3
    assert frr.select_kernel_path(part.S * part.R_max, 1, budget)[0] \
        == "pinned"
    seen = []
    planner_of = engine.launch_planner

    def spy(part_, cfg_, q_pad=1):
        planner = planner_of(part_, cfg_, q_pad)
        seen.append((q_pad, planner.path))
        return planner

    monkeypatch.setattr(engine, "launch_planner", spy)
    init, unitw = lanes.init_lane_values(
        part, [("bfs", root), ("sssp", 5), ("bfs", [1, 7])])
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="worklist",
                              vmem_budget_bytes=budget)
    got, st_ = lanes.run_stacked_lanes(part, init, unitw, cfg,
                                       device="cpu")
    assert seen == [(3, "tiled")]
    want, want_st = ref_lanes.run_stacked_lanes(
        part_ref, init, unitw, ref_engine.EngineConfig(
            use_pallas=True, grid_mode="worklist"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _lane_stats(st_) == _lane_stats(want_st)
