"""The order models of the dense piece launches (K1, K3) on the CPU.

K1 and K3 run a plan's pieces over the cells whose chunk frontier bit is
set, and fold each cell's batch range in a fixed order: K1 batch by batch
on warp b % 8, K3 in windows of chunk positions cut into lists, a
segment's messages of a list folded into one partial before the owners
take it.  ``ref.fused_relax_reduce_order`` and
``ref.fused_relax_reduce_lanes_order`` replay that order one float32
operation at a time; ``tests/test_torch_cuda.py`` holds the kernels to
them bit for bit on the card.  Here the walk's cells, batch ranges and
pieces are held to the port's launch tables and to the reference's grid
mirror, and the models' inboxes to the reference's Pallas kernels (in
interpret mode) and to the plain versions: min bit for bit, sum within
rtol 1e-5 / atol 1e-6 (they sum in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import fused_relax_reduce as ref_frr  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

EBLK, SBLK = frr.EBLK, frr.SBLK
PAIRS = [("add_w", "min"), ("add_one", "min"), ("mul_w", "sum")]
LANE_PAIRS = [("add_w", "min"), ("mul_w", "sum")]
# (v, e, nseg): ragged sizes, a tail shorter than a batch, several chunks
# a block (pieces of 2 cut a block) and a hub (one segment takes most
# edges, so its runs span list and window boundaries)
SHAPES = [(17, 7, 3), (300, EBLK + 1, SBLK + 1),
          (500, 3 * EBLK + 13, 2 * SBLK + 5), (900, 6 * EBLK, 300)]


def _case(v, e, nseg, frac, seed, sorted_ids=True, q=None, hub=False):
    rng = np.random.default_rng(seed)
    shape = (v,) if q is None else (v, q)
    gval = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    gchg = rng.random(shape) < frac
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if hub:
        ids[rng.random(e) < 0.7] = nseg // 3
    if sorted_ids:
        ids = np.sort(ids)
    return gval, gchg, src, w, mask, ids


def _check(got, want, kind):
    if kind == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cells", [1, 3, 8])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("frac", [0.0, 0.02, 1.0])
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_piece_walk_matches_launch_tables(v, e, nseg, frac, sorted_ids,
                                          cells):
    """The walk's planned cells, batch ranges and pieces are the launch
    plan's, and its run cells are K1's executed cells: the plan's live
    cells and the reference grid's."""
    gval, gchg, src, w, mask, ids = _case(v, e, nseg, frac, seed=v + e,
                                          sorted_ids=sorted_ids)
    walk = ref.piece_walk(src, mask, ids, gchg, nseg, cells)
    t = [torch.as_tensor(x) for x in (src, mask, ids, gchg)]
    plan = frr.plan_launch(t[0], t[1], t[2], nseg, v)
    pc = frr.plan_pieces(plan, cells)
    batches = frr.plan_batches(plan, t[2]).numpy()
    blk_chunk = plan.blk_chunk.numpy()
    piece_ptr = pc.piece_ptr.numpy()
    p = 0
    for i, pieces in enumerate(walk):
        k0, k1 = int(pc.blk_piece[i]), int(pc.blk_piece[i + 1])
        assert len(pieces) == k1 - k0
        for k, piece in zip(range(k0, k1), pieces):
            assert piece_ptr[k + 1] - piece_ptr[k] == len(piece)
            for j, _, lo, hi in piece:
                assert (blk_chunk[p], *batches[p]) == (j, lo, hi)
                p += 1
    assert p == plan.num_cells
    chunk_act, _ = frr._chunk_tables(t[0], t[1], t[3])
    run = sum(live for pieces in walk for piece in pieces
              for _, live, _, _ in piece)
    assert run == int(frr._executed_cells(plan, chunk_act)[0])
    assert run == ref_frr.fused_grid_cells(ids, mask, src, gchg,
                                           nseg)["fused_live"]


@pytest.mark.parametrize("cells", [2, 8])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_k1_order_model_matches_reference(v, e, nseg, relax, kind,
                                          sorted_ids, cells):
    case = _case(v, e, nseg, 0.4, seed=e + nseg, sorted_ids=sorted_ids,
                 hub=nseg == 300)
    got, executed = ref.fused_relax_reduce_order(*case, nseg, relax, kind,
                                                 cells)
    want, want_dbg = ref_frr.fused_relax_reduce_pallas(
        *(jnp.asarray(x) for x in case), nseg, relax, kind, interpret=True,
        with_debug=True)
    _check(got, np.asarray(want), kind)
    assert executed == int(want_dbg[0])
    plain = ref.fused_relax_reduce_ref(*(torch.as_tensor(x) for x in case),
                                       nseg, relax, kind)
    _check(got, plain.numpy(), kind)


@pytest.mark.parametrize("cells", [2, 8])
@pytest.mark.parametrize("halves", [1, 2])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("relax,kind", LANE_PAIRS)
@pytest.mark.parametrize("q", [1, 5, 16, 33])
def test_k3_order_model_matches_reference(q, relax, kind, sorted_ids,
                                          halves, cells):
    v, e, nseg = SHAPES[3] if q == 5 else SHAPES[2]
    case = _case(v, e, nseg, 0.4, seed=q + cells, sorted_ids=sorted_ids,
                 q=q, hub=q == 5)
    unitw = (np.arange(q) % 2).astype(np.uint8)
    got, executed = ref.fused_relax_reduce_lanes_order(
        case[0], case[1], unitw, *case[2:], nseg, relax, kind, cells,
        halves)
    want, want_dbg = ref_frr.fused_relax_reduce_lanes_pallas(
        jnp.asarray(case[0]), jnp.asarray(case[1]), jnp.asarray(unitw),
        *(jnp.asarray(x) for x in case[2:]), nseg, relax, kind,
        interpret=True, with_debug=True)
    _check(got, np.asarray(want), kind)
    assert executed == int(want_dbg[0])
    plain = ref.fused_relax_reduce_lanes_ref(
        torch.as_tensor(case[0]), torch.as_tensor(case[1]),
        torch.as_tensor(unitw), *(torch.as_tensor(x) for x in case[2:]),
        nseg, relax, kind)
    _check(got, plain.numpy(), kind)


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_k3_order_model_lists_do_not_see_identity_positions(kind):
    """A list's partial does not depend on where the identity messages
    sit: the same edges with every inactive source's edge reordered
    inside its list give the same bits, so a fold that drops the
    positions dead in every lane (K7, K8) gives K3's."""
    relax = "add_w" if kind == "min" else "mul_w"
    v, e, nseg = 400, 2 * EBLK, 40
    rng = np.random.default_rng(3)
    gval = rng.uniform(0.0, 10.0, (v, 4)).astype(np.float32)
    gchg = np.zeros((v, 4), bool)
    gchg[: v // 2] = True                  # sources >= v/2 dead in every lane
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    mask = np.ones(e, bool)
    ids = np.sort(rng.integers(0, nseg, e)).astype(np.int32)
    unitw = np.zeros(4, np.uint8)
    base, _ = ref.fused_relax_reduce_lanes_order(
        gval, gchg, unitw, src, w, mask, ids, nseg, relax, kind, 8, 1)
    # move the dead edges of each list to its end, keeping the live ones
    # in order (their destinations move with them)
    src2, w2, ids2 = src.copy(), w.copy(), ids.copy()
    length = ref.WINDOW // ref.NWARP
    for lo in range(0, e, length):
        sl = np.arange(lo, lo + length)
        dead = src[sl] >= v // 2
        order = np.concatenate([sl[~dead], sl[dead]])
        src2[sl], w2[sl], ids2[sl] = src[order], w[order], ids[order]
    moved, _ = ref.fused_relax_reduce_lanes_order(
        gval, gchg, unitw, src2, w2, mask, ids2, nseg, relax, kind, 8, 1)
    np.testing.assert_array_equal(base, moved)
