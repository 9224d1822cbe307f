"""The worklist launches' static tables and live flags, held to
straightforward numpy constructions over the edges.

K2, K4, K6 and K8 walk each segment block's planned cells in pieces and
run the cells a round lists.  Their tables are made once per partition
(the i-major order by ``plan_launch``; each cell's range of 32-edge
batches holding an edge of its block and the pieces on a plan's first
worklist launch) and once per round by the planner (the flags of the
listed cells); a device plan's flags are
the chunk frontier bits, and a worklist given as the reference's
``wl_i``/``wl_j``/``nlive`` is mapped onto the flags.  Each is checked
here on the CPU, with sorted and unsorted destinations, against a
construction that walks the edges one by one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import fused_relax_reduce as ref_frr  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402

EBLK, SBLK = frr.EBLK, frr.SBLK
SHAPES = [(1, 1, 1), (127, 300, 50), (257, 2 * EBLK + 13, SBLK + 5),
          (500, 3 * EBLK + 9, 2 * SBLK + 1), (900, 9 * EBLK + 3, 1300),
          (300, 6 * EBLK, 5 * SBLK)]
FRACS = [0.0, 0.02, 0.5, 1.0]


def _case(v, e, nseg, frac, seed, sorted_ids=True):
    rng = np.random.default_rng(seed)
    gchg = rng.random(v) < frac
    src = rng.permutation(v)[rng.integers(0, max(v // 8, 1), e)] \
        .astype(np.int32)
    mask = rng.random(e) < 0.9
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    return gchg, src, mask, ids


def _plan(case, nseg):
    gchg, src, mask, ids = case
    return frr.plan_launch(torch.as_tensor(src), torch.as_tensor(mask),
                           torch.as_tensor(ids), nseg, gchg.shape[0])


def _cells(mask, ids, nseg):
    """The planned cells, j-major: for each chunk, the blocks its valid
    edges' id range meets."""
    n_i = -(-max(nseg, 1) // SBLK)
    cells = []
    for j in range(-(-max(ids.shape[0], 1) // EBLK)):
        sl = slice(j * EBLK, (j + 1) * EBLK)
        d = ids[sl][mask[sl]]
        if d.size:
            cells += [(i, j) for i in range(d.min() // SBLK,
                                            min(d.max() // SBLK, n_i - 1)
                                            + 1)]
    return cells


def _imajor(cells):
    return sorted(cells)


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_imajor_order_matches_numpy(v, e, nseg, sorted_ids):
    case = _case(v, e, nseg, 0.5, v + e, sorted_ids)
    plan = _plan(case, nseg)
    cells = _cells(case[2], case[3], nseg)
    order = plan.cell_order.numpy()
    got = list(zip(plan.cell_i.numpy()[order], plan.cell_j.numpy()[order]))
    assert got == _imajor(cells)
    np.testing.assert_array_equal(plan.blk_chunk.numpy(),
                                  [j for _, j in _imajor(cells)])
    counts = np.bincount([i for i, _ in cells],
                         minlength=plan.num_blocks)
    np.testing.assert_array_equal(np.diff(plan.blk_ptr.numpy()), counts)


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_batch_ranges_match_numpy(v, e, nseg, sorted_ids):
    case = _case(v, e, nseg, 0.5, v + e + 1, sorted_ids)
    _, _, mask, ids = case
    plan = _plan(case, nseg)
    want = []
    for i, j in _imajor(_cells(mask, ids, nseg)):
        hits = [k // 32 for k in range(EBLK)
                if j * EBLK + k < ids.shape[0] and mask[j * EBLK + k]
                and ids[j * EBLK + k] // SBLK == i]
        want.append((min(hits), max(hits) + 1) if hits else (0, 0))
    got_t = frr.plan_batches(plan, torch.as_tensor(ids))
    assert frr.plan_batches(plan, None) is got_t    # kept on the plan
    got = got_t.numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got.reshape(-1, 2),
                                  np.asarray(want, np.int64).reshape(-1, 2))


@pytest.mark.parametrize("cells", [1, 2, 3, 8, 1000])
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_pieces_match_numpy(v, e, nseg, cells):
    case = _case(v, e, nseg, 0.5, v + e + 2)
    plan = _plan(case, nseg)
    pc = frr.plan_pieces(plan, cells)
    ptr = plan.blk_ptr.numpy()
    lo, hi, blk, slot, first = [], [], [], [], []
    n_split = 0
    for i in range(plan.num_blocks):
        first.append(len(blk))
        cnt = ptr[i + 1] - ptr[i]
        n = max(1, -(-cnt // cells))
        for r in range(n):
            lo.append(ptr[i] + r * cells)
            hi.append(min(ptr[i] + (r + 1) * cells, ptr[i + 1]))
            blk.append(i)
            slot.append(n_split if n > 1 else -1)
            n_split += n > 1
    first.append(len(blk))
    # the real pieces first, then padding up to the host-known bound
    n = len(blk)
    bound = plan.num_blocks + plan.num_cells // cells
    assert pc.num_pieces == pc.n_split == bound >= n
    assert bound >= n_split and pc.cells == cells
    ptr_k = pc.piece_ptr.numpy()
    np.testing.assert_array_equal(ptr_k[:n], lo)
    np.testing.assert_array_equal(ptr_k[1:n + 1], hi)
    assert (ptr_k[n:] == plan.num_cells).all()
    np.testing.assert_array_equal(pc.piece_blk.numpy()[:n], blk)
    assert (pc.piece_blk.numpy()[n:] == -1).all()
    np.testing.assert_array_equal(pc.piece_slot.numpy()[:n], slot)
    assert (pc.piece_slot.numpy()[n:] == -1).all()
    np.testing.assert_array_equal(pc.blk_piece.numpy(), first)
    assert frr.plan_pieces(plan, cells) is pc      # kept on the plan
    if cells == frr.PIECE_CELLS:
        assert frr.plan_pieces(plan) is pc


def _listed_flags(plan, wl_i, wl_j, nlive):
    """Flag per i-major planned cell: listed among the first nlive."""
    listed = set(zip(np.asarray(wl_i)[:int(nlive)].tolist(),
                     np.asarray(wl_j)[:int(nlive)].tolist()))
    order = plan.cell_order.numpy()
    pairs = zip(plan.cell_i.numpy()[order], plan.cell_j.numpy()[order])
    return np.array([(int(i), int(j)) in listed for i, j in pairs], np.uint8)


@pytest.mark.parametrize("dst_filter", [True, False])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_host_plan_flags_match_numpy(v, e, nseg, frac, sorted_ids,
                                     dst_filter):
    case = _case(v, e, nseg, frac, v + e + 3, sorted_ids)
    gchg, src, mask, ids = case
    plan = _plan(case, nseg)
    wl, info = frr.plan_worklist(ids, mask, src, gchg, nseg,
                                 dst_filter=dst_filter)
    assert wl.flags.dtype == torch.uint8
    want = _listed_flags(plan, wl.wl_i, wl.wl_j, wl.nlive[0])
    np.testing.assert_array_equal(wl.flags.numpy(), want)
    assert int(want.sum()) == info.cells
    # the reference's plan carried across maps onto the same flags
    ref_wl, _ = ref_frr.plan_worklist(ids, mask, src, gchg, nseg,
                                      dst_filter=dst_filter)
    got = frr.worklist_flags(plan, *(torch.as_tensor(np.asarray(x))
                                     for x in (ref_wl.wl_i, ref_wl.wl_j,
                                               ref_wl.nlive)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_device_plan_flags_match_numpy(v, e, nseg, frac, sorted_ids):
    case = _case(v, e, nseg, frac, v + e + 4, sorted_ids)
    gchg, src, mask, ids = case
    plan = _plan(case, nseg)
    t = [torch.as_tensor(x) for x in case]
    chunk_act, _ = frr._chunk_tables(t[1], t[2], t[0])
    got = frr.device_flags(plan, chunk_act)
    live = [bool((mask & gchg[src])[j * EBLK:(j + 1) * EBLK].any())
            for j in plan.blk_chunk.numpy()]
    np.testing.assert_array_equal(got.numpy(), np.asarray(live, np.uint8))
    # the compacted device list, and the reference's, map onto them too
    wl = frr.build_device_worklist(*t, nseg, plan)
    np.testing.assert_array_equal(
        frr.worklist_flags(plan, wl.wl_i, wl.wl_j, wl.nlive).numpy(),
        got.numpy())
    assert int(got.sum()) == int(wl.nlive[0])
    ref_wl, _ = ref_frr.plan_worklist(ids, mask, src, gchg, nseg,
                                      dst_filter=False)
    np.testing.assert_array_equal(
        frr.worklist_flags(plan, *(torch.as_tensor(np.asarray(x)) for x in
                                   (ref_wl.wl_i, ref_wl.wl_j,
                                    ref_wl.nlive))).numpy(), got.numpy())


def test_worklist_flags_drop_cells_the_plan_lacks():
    """A listed cell whose block the chunk's range misses holds no edge
    of that block: it maps to no flag; cells past nlive are ignored."""
    case = _case(300, 6 * EBLK, 5 * SBLK, 1.0, 5)
    plan = _plan(case, 5 * SBLK)
    i0, j0 = int(plan.cell_i[0]), int(plan.cell_j[0])
    missing = [i for i in range(plan.num_blocks)
               if (i, j0) not in set(zip(plan.cell_i.tolist(),
                                         plan.cell_j.tolist()))]
    wl_i = torch.tensor([i0] + missing[:1] + [i0], dtype=torch.int32)
    wl_j = torch.tensor([j0] * 3, dtype=torch.int32)
    for n in (0, 1, 2):
        got = frr.worklist_flags(plan, wl_i, wl_j,
                                 torch.tensor([n], dtype=torch.int32))
        assert int(got.sum()) == min(n, 1)
        if n:
            p = int(np.flatnonzero(plan.cell_order.numpy() == 0)[0])
            assert int(got[p]) == 1


def test_card_flags_checks_the_worklist():
    """A planner's flags must match the plan (the launch checks them); a
    host plan's cells must lie in the launch grid; a device plan needs no
    flags."""
    case = _case(257, 2 * EBLK + 13, SBLK + 5, 0.5, 6)
    gchg, src, mask, ids = case
    plan = _plan(case, SBLK + 5)
    wl, _ = frr.plan_worklist(ids, mask, src, gchg, SBLK + 5)
    assert frr._card_flags(None, plan, SBLK + 5) is None
    np.testing.assert_array_equal(
        frr._card_flags(wl, plan, SBLK + 5).numpy(), wl.flags.numpy())
    bad = frr.Worklist(wl.wl_i, wl.wl_j, wl.nlive,
                       flags=torch.zeros(plan.num_cells + 1,
                                         dtype=torch.uint8))
    frr._check_flags(wl.flags, plan, torch.device("cpu"))
    with pytest.raises(ValueError, match="flags"):
        frr._check_flags(frr._card_flags(bad, plan, SBLK + 5), plan,
                         torch.device("cpu"))
    far = frr.Worklist(torch.tensor([0, 5], dtype=torch.int32),
                       torch.tensor([0, 0], dtype=torch.int32),
                       torch.tensor([2], dtype=torch.int32))
    with pytest.raises(ValueError, match="outside the launch grid"):
        frr._card_flags(far, plan, SBLK + 5)
