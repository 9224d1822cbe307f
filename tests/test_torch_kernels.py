"""The port's fused relax+reduce (kernel K1) on the CPU against the
reference's Pallas kernel in interpret mode and its jnp oracle.

On a CPU tensor the port runs the kernel's plain version, so this holds
the plain version, the port's launch plan and its host mirror to the
reference; ``tests/test_torch_cuda.py`` holds the CUDA kernel to the
plain version on the card.  Min results are bit-equal; sum results agree
within rtol 1e-5 / atol 1e-6, the reference's own tolerance for its
kernel, because the two sum in different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import fused_relax_reduce as ref_frr  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

EBLK, SBLK = frr.EBLK, frr.SBLK
PAIRS = [("add_w", "min"), ("add_one", "min"), ("mul_w", "sum")]


def _case(v, e, nseg, frontier_frac, seed, sorted_ids=True, negative=False):
    rng = np.random.default_rng(seed)
    gval = rng.uniform(0.0, 10.0, v).astype(np.float32)
    gchg = rng.random(v) < frontier_frac
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(-2.0 if negative else 0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    return gval, gchg, src, w, mask, ids


def _compare(case, nseg, relax, kind):
    got, count, dbg = frr.fused_relax_reduce(
        *(torch.as_tensor(x) for x in case), nseg, relax, kind,
        with_count=True, with_debug=True)
    want, want_count, want_dbg = ref_frr.fused_relax_reduce_pallas(
        *(jnp.asarray(x) for x in case), nseg, relax, kind,
        interpret=True, with_count=True, with_debug=True)
    oracle = ref_oracle.fused_relax_reduce_ref(
        *(jnp.asarray(x) for x in case), nseg, relax, kind)
    got = got.numpy()
    for w in (np.asarray(want), np.asarray(oracle)):
        if kind == "min":
            np.testing.assert_array_equal(got, w)
        else:
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
    assert count.dtype == torch.int32 and int(count) == int(want_count)
    # the port's executed cells are the reference grid's live cells
    assert int(dbg[0]) == int(want_dbg[0])
    mirror = frr.fused_grid_cells(case[5], case[4], case[2], case[1], nseg)
    assert mirror["fused_live"] == int(dbg[0])
    return got


SHAPES = [
    (1, 1, 1), (17, 7, 3), (200, 100, 17),
    (300, EBLK, SBLK), (130, EBLK + 1, SBLK + 1),
    (500, 2 * EBLK + 13, 2 * SBLK + 5), (64, EBLK - 1, 1000),
]


@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("v,e,nseg", SHAPES)
def test_fused_matches_reference(relax, kind, v, e, nseg):
    _compare(_case(v, e, nseg, 0.4, seed=e + nseg), nseg, relax, kind)


@pytest.mark.parametrize("relax,kind", PAIRS)
@pytest.mark.parametrize("frac", [0.0, 0.01, 1.0])
def test_fused_frontier_densities(relax, kind, frac):
    got = _compare(_case(400, 3 * EBLK + 9, 700, frac, seed=5), 700,
                   relax, kind)
    if frac == 0.0:
        assert np.all(got == (np.inf if kind == "min" else 0.0))


@pytest.mark.parametrize("relax,kind", PAIRS)
def test_fused_unsorted_ids(relax, kind):
    _compare(_case(300, 1000, 400, 0.5, seed=11, sorted_ids=False), 400,
             relax, kind)


@pytest.mark.parametrize("relax", ["add_w", "add_one"])
def test_fused_negative_weights_min(relax):
    _compare(_case(300, 1200, 500, 0.5, seed=12, negative=True), 500,
             relax, "min")


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_fused_padding_edges_inert(kind):
    """Masked-off (padding) edges never contribute, whatever their ids."""
    relax = "add_w" if kind == "min" else "mul_w"
    case = (np.arange(10, dtype=np.float32), np.ones(10, bool),
            np.array([0, 1, 2, 3], np.int32), np.ones(4, np.float32),
            np.array([True, True, False, False]),
            np.array([2, 2, 0, 5], np.int32))
    got = _compare(case, 6, relax, kind)
    identity = np.inf if kind == "min" else 0.0
    assert got[0] == identity and got[5] == identity and got[2] == 1.0


def test_fused_rejects_non_absorbing_pairing():
    case = [torch.as_tensor(x) for x in _case(50, 100, 40, 0.5, seed=3)]
    with pytest.raises(ValueError, match="non-absorbing"):
        frr.fused_relax_reduce(*case, 40, "add_w", "sum")
    with pytest.raises(ValueError, match="non-absorbing"):
        ref_frr.fused_relax_reduce_pallas(
            *(jnp.asarray(x.numpy()) for x in case), 40, "add_w", "sum",
            interpret=True)


@pytest.mark.parametrize("relax,kind", PAIRS)
def test_ops_and_plain_versions_agree(relax, kind):
    case = [torch.as_tensor(x) for x in _case(250, 900, 300, 0.3, seed=8)]
    plan = frr.plan_launch(case[2], case[4], case[5], 300, 250)
    out, count = ops.fused_relax_reduce(*case, 300, relax, kind, plan=plan)
    torch.testing.assert_close(
        out, ref.fused_relax_reduce_ref(*case, 300, relax, kind),
        rtol=0, atol=0)
    want = ref_oracle.segment_combine_ref(
        jnp.asarray(np.arange(7, dtype=np.float32)),
        jnp.asarray(np.array([0, 0, 1, 3, 3, 3, 4], np.int32)), 6, kind)
    np.testing.assert_array_equal(
        ref.segment_combine_ref(torch.arange(7, dtype=torch.float32),
                                torch.tensor([0, 0, 1, 3, 3, 3, 4]), 6,
                                kind).numpy(), np.asarray(want))
    assert int(count) == int((case[4] & case[1][case[2].long()]).sum())


def _brute_force_cells(ids, mask, src, gchg, nseg):
    """Count (block, chunk) cells cell by cell: the chunk's valid-id range
    meets the block and some valid edge of the chunk has a live source."""
    e = ids.shape[0]
    n_chunks = max(-(-e // EBLK), 1)
    n_sblk = max(-(-nseg // SBLK), 1)
    walked = live = 0
    for j in range(n_chunks):
        sl = slice(j * EBLK, min((j + 1) * EBLK, e))
        valid = mask[sl]
        if not valid.any():
            continue
        lo, hi = ids[sl][valid].min(), ids[sl][valid].max()
        act = (valid & gchg[src[sl]]).any()
        for i in range(n_sblk):
            if hi >= i * SBLK and lo < (i + 1) * SBLK:
                walked += 1
                live += int(act)
    return walked, live


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("v,e,nseg,frac", [
    (300, 5 * EBLK + 17, 3 * SBLK + 1, 0.05), (64, EBLK - 1, 1000, 0.5),
    (900, 12 * EBLK, 2000, 0.0), (700, 9 * EBLK + 3, 4100, 1.0)])
def test_launch_mirror_matches_brute_force(v, e, nseg, frac, sorted_ids):
    _, gchg, src, _, mask, ids = _case(v, e, nseg, frac, seed=v + e,
                                       sorted_ids=sorted_ids)
    walked, live = _brute_force_cells(ids, mask, src, gchg, nseg)
    m = frr.fused_grid_cells(ids, mask, src, gchg, nseg)
    assert (m["launch_cells"], m["fused_live"]) == (walked, live)
    assert m["total_fused"] == max(-(-nseg // SBLK), 1) * max(-(-e // EBLK), 1)
    want = ref_frr.fused_grid_cells(ids, mask, src, gchg, nseg)
    assert m["fused_live"] == want["fused_live"]
    assert m["total_fused"] == want["total_fused"]
    plan = frr.plan_launch(torch.as_tensor(src), torch.as_tensor(mask),
                           torch.as_tensor(ids), nseg, v)
    assert plan.blk_chunk.shape[0] == walked
    assert plan.num_blocks == max(-(-nseg // SBLK), 1)
    # each block lists its chunks in ascending order (the sum order)
    ptr, chunks = plan.blk_ptr.tolist(), plan.blk_chunk.tolist()
    for i in range(plan.num_blocks):
        row = chunks[ptr[i]:ptr[i + 1]]
        assert row == sorted(row)


def test_plan_rejects_out_of_range_edges():
    src = torch.tensor([0, 5], dtype=torch.int32)
    ids = torch.tensor([0, 1], dtype=torch.int32)
    mask = torch.tensor([True, True])
    with pytest.raises(ValueError, match="edge_src outside"):
        frr.plan_launch(src, mask, ids, 4, 5)
    with pytest.raises(ValueError, match="edge_dst outside"):
        frr.plan_launch(src, mask, ids, 1, 6)
    # padding edges may hold any id
    frr.plan_launch(src, torch.tensor([True, False]), ids, 1, 5)
