"""The port's segment reduce (kernel K9's plain version on the CPU) and
the ``pallas_mode='reduce'`` engine path against the reference's.

``segment_combine`` equals ``segment_combine_pallas`` in interpret mode
on the reference tests' shapes, sorted and unsorted (min exact, sum
within rtol 1e-5 / atol 1e-6: the two sum in different orders), and in
bfloat16 at bf16 resolution; BFS and SSSP under
``EngineConfig(use_pallas=True, pallas_mode='reduce')`` give the
reference's values and ``RunStats`` exactly.

K9's order model (``ref.segment_combine_order``, which
``tests/test_torch_cuda.py`` holds the kernel to bit for bit) equals the
plain version and the reference's kernel on the same shapes, in
bfloat16, and on a plan built under a mask whose masked edges lie
outside their chunk's planned range: its batch ranges follow that mask.
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
from repro.kernels.ref import segment_combine_ref as jnp_ref  # noqa: E402
from repro.kernels.rhizome_segment_reduce import segment_combine_pallas  # noqa: E402,E501
from repro_torch import apps, exchange, interop  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.graph import generators, reference  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rhizome_segment_reduce as rsr  # noqa: E402

EBLK, SBLK = rsr.EBLK, rsr.SBLK
SHAPES = [
    (1, 1), (7, 3), (100, 17), (EBLK, SBLK), (EBLK + 1, SBLK + 1),
    (2 * EBLK + 13, 2 * SBLK + 5), (EBLK - 1, 1000), (3000, 5),
]


def _case(e, nseg, sorted_ids, seed):
    rng = np.random.default_rng(seed)
    data = rng.uniform(-10, 10, size=e).astype(np.float32)
    ids = rng.integers(0, nseg, size=e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    return data, ids


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("e,nseg", SHAPES)
@pytest.mark.parametrize("kind", ["min", "sum"])
def test_segment_combine_matches_reference(kind, e, nseg, sorted_ids):
    data, ids = _case(e, nseg, sorted_ids, seed=e * 7 + nseg)
    got, cells = rsr.segment_combine(torch.as_tensor(data),
                                     torch.as_tensor(ids), nseg, kind,
                                     with_debug=True)
    want = segment_combine_pallas(jnp.asarray(data), jnp.asarray(ids), nseg,
                                  kind, interpret=True)
    if kind == "min":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    plan = rsr.plan_segments(torch.as_tensor(ids), nseg)
    assert int(cells[0]) == plan.num_cells


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_segment_combine_bf16(kind):
    """bf16 in, bf16 out, float32 accumulation: within bf16 resolution of
    the float32 oracle, as the reference's bf16 test holds its kernel."""
    data, ids = _case(777, 300, True, seed=1)
    data_bf = torch.as_tensor(data).to(torch.bfloat16)
    got = ops.segment_combine(data_bf, torch.as_tensor(ids), 300, kind)
    assert got.dtype == torch.bfloat16
    want = jnp_ref(jnp.asarray(data_bf.float().numpy()), jnp.asarray(ids),
                   300, kind)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=8e-2, atol=0.5)
    ref_bf = segment_combine_pallas(
        jnp.asarray(data).astype(jnp.bfloat16), jnp.asarray(ids), 300, kind,
        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref_bf, np.float32),
                               rtol=8e-2, atol=0.5)


def _close(got, want, kind):
    if kind == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cells", [rsr.PIECE_CELLS, 1])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("e,nseg", SHAPES)
@pytest.mark.parametrize("kind", ["min", "sum"])
def test_order_model_matches_reference(kind, e, nseg, sorted_ids, cells):
    """K9's order model, at the kept cut and one cell a piece (every
    block of several cells split), against the plain version and the
    reference's kernel in interpret mode; it walks the plan's cells."""
    data, ids = _case(e, nseg, sorted_ids, seed=e * 7 + nseg)
    got, walked = ref.segment_combine_order(data, ids, nseg, kind, cells)
    assert got.dtype == np.float32
    want = segment_combine_pallas(jnp.asarray(data), jnp.asarray(ids), nseg,
                                  kind, interpret=True)
    _close(got, np.asarray(want), kind)
    plain = ref.segment_combine_ref(torch.as_tensor(data),
                                    torch.as_tensor(ids), nseg, kind)
    _close(got, plain.numpy(), kind)
    assert walked == rsr.plan_segments(torch.as_tensor(ids), nseg).num_cells


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_order_model_bf16(kind):
    """bfloat16 messages are taken exactly as float32 and the total is
    rounded once: min exact, sum within the float32 tolerance of the plain
    version before rounding, and at bf16 resolution of the reference's
    bf16 kernel after it."""
    data, ids = _case(3 * EBLK + 77, 300, True, seed=2)
    data_bf = torch.as_tensor(data).to(torch.bfloat16)
    got, _ = ref.segment_combine_order(data_bf, ids, 300, kind,
                                       rsr.PIECE_CELLS)
    plain = ref.segment_combine_ref(data_bf.float(), torch.as_tensor(ids),
                                    300, kind)
    _close(got, plain.numpy(), kind)
    got_bf = torch.from_numpy(got).to(torch.bfloat16)
    want_bf = ops.segment_combine(data_bf, torch.as_tensor(ids), 300, kind)
    if kind == "min":
        assert torch.equal(got_bf, want_bf)
    ref_bf = segment_combine_pallas(
        jnp.asarray(data).astype(jnp.bfloat16), jnp.asarray(ids), 300, kind,
        interpret=True)
    np.testing.assert_allclose(got_bf.float().numpy(),
                               np.asarray(ref_bf, np.float32),
                               rtol=8e-2, atol=0.5)


def _walk_counts(walk, e):
    """[cells, pieces, edges loaded] of a launch over ``walk``
    (``ref.piece_walk``): every cell's batch range, cut at the last of
    the ``e`` edges, is loaded once."""
    cells = [c for pieces in walk for piece in pieces for c in piece]
    loaded = sum(max(min(j * EBLK + 32 * hi, e) - j * EBLK - 32 * lo, 0)
                 for j, _, lo, hi in cells)
    return [len(cells), sum(len(pieces) for pieces in walk), loaded]


@pytest.mark.parametrize("cells", [rsr.PIECE_CELLS, 1])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("e,nseg", SHAPES)
def test_debug_counts_match_the_walk(e, nseg, sorted_ids, cells):
    """``with_debug``'s [cells, pieces, edges loaded], from the plan's
    tables, equal a numpy walk of the edges."""
    data, ids = _case(e, nseg, sorted_ids, seed=e + nseg)
    walk = ref.piece_walk(np.zeros_like(ids), np.ones(e, bool), ids,
                          np.ones(1, bool), nseg, cells)
    old = rsr.PIECE_CELLS
    rsr.PIECE_CELLS = cells
    try:
        _, dbg = rsr.segment_combine(torch.as_tensor(data),
                                     torch.as_tensor(ids), nseg, "min",
                                     with_debug=True)
    finally:
        rsr.PIECE_CELLS = old
    assert dbg.dtype == torch.int32
    assert dbg.tolist() == _walk_counts(walk, e)


def _masked_case(kind, seed):
    """Sorted ids with a fifth of the edges masked; a masked edge carries
    the identity and an id drawn anywhere, mostly outside its chunk's
    planned blocks."""
    e, nseg = 6 * EBLK + 41, 9 * SBLK + 3
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 10.0, e).astype(np.float32)
    ids = np.sort(rng.integers(0, nseg, e)).astype(np.int32)
    mask = rng.random(e) < 0.8
    ids = np.where(mask, ids, rng.integers(0, nseg, e)).astype(np.int32)
    data = np.where(mask, data, np.inf if kind == "min" else 0.0)
    return data.astype(np.float32), ids, mask, nseg


@pytest.mark.parametrize("cells", [rsr.PIECE_CELLS, 1])
@pytest.mark.parametrize("kind", ["min", "sum"])
def test_masked_plan_batch_ranges_follow_mask(kind, cells):
    data, ids, mask, nseg = _masked_case(kind, seed=5 + cells)
    t_ids, t_mask = torch.as_tensor(ids), torch.as_tensor(mask)
    plan = frr.plan_launch(None, t_mask, t_ids, nseg, 0)
    # the case is the one that needs the mask: masked edges whose block
    # lies outside their chunk's planned blocks
    walk = ref.piece_walk(np.zeros_like(ids), mask, ids, np.ones(1, bool),
                          nseg, cells)
    planned = {(i, j) for i, pieces in enumerate(walk)
               for piece in pieces for j, _, _, _ in piece}
    pos = np.flatnonzero(~mask)
    assert any((ids[k] // SBLK, k // EBLK) not in planned for k in pos)
    # the plan's batch ranges, built under its mask, are the walk's
    ranges = [(j, lo, hi) for pieces in walk for piece in pieces
              for j, _, lo, hi in piece]
    assert plan.edge_mask is t_mask
    batches = frr.plan_batches(plan, t_ids).numpy()
    assert [(int(j), int(lo), int(hi)) for j, (lo, hi)
            in zip(plan.blk_chunk.numpy(), batches)] == ranges
    got, walked = ref.segment_combine_order(data, ids, nseg, kind, cells,
                                            edge_mask=mask)
    assert walked == plan.num_cells
    plain = ref.segment_combine_ref(torch.as_tensor(data), t_ids, nseg, kind)
    _close(got, plain.numpy(), kind)
    want = segment_combine_pallas(jnp.asarray(data), jnp.asarray(ids), nseg,
                                  kind, interpret=True)
    _close(got, np.asarray(want), kind)
    old = rsr.PIECE_CELLS
    rsr.PIECE_CELLS = cells
    try:
        out, dbg = rsr.segment_combine(torch.as_tensor(data), t_ids, nseg,
                                       kind, plan=plan, with_debug=True)
    finally:
        rsr.PIECE_CELLS = old
    _close(out.numpy(), plain.numpy(), kind)
    assert dbg.tolist() == _walk_counts(walk, ids.shape[0])


def test_reduce_mode_passes_the_plans_mask(monkeypatch):
    """The exchange hands K9 the engine's launch plan, which keeps the
    mask that built it."""
    _, _, _, _, part = _both()
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    cfg = engine.EngineConfig(use_pallas=True, pallas_mode="reduce")
    seen = []
    real = ops.segment_combine

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "segment_combine", spy)
    n = part.S * part.R_max
    val = torch.zeros(n)
    exchange.stacked_dense_inbox(actions.SSSP, arrays, cfg, val, val == 0, n)
    assert len(seen) == 1 and seen[0]["plan"] is arrays.fused_plan
    assert torch.equal(arrays.fused_plan.edge_mask,
                       arrays.edge_mask.reshape(-1))


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_empty_segments_hold_identity(kind):
    got = rsr.segment_combine(torch.tensor([1.0, 2.0, 3.0]),
                              torch.tensor([5, 5, 9], dtype=torch.int32),
                              12, kind)
    identity = np.inf if kind == "min" else 0.0
    for s in range(12):
        if s not in (5, 9):
            assert float(got[s]) == identity


def test_segment_plan_rejects_ids_out_of_range():
    with pytest.raises(ValueError, match="edge_dst outside"):
        rsr.plan_segments(torch.tensor([0, 4], dtype=torch.int32), 4)


def _both(seed=7):
    g_ref = ref_generators.rmat(8, edge_factor=8, seed=seed) \
        .with_random_weights(seed=seed)
    g = generators.rmat(8, edge_factor=8, seed=seed).with_random_weights(
        seed=seed)
    part_ref = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=4, rpvo_max=4))
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    return g_ref, g, int(np.argmax(g.out_degrees())), part_ref, part


@pytest.mark.parametrize("collapse", ["eager", "deferred"])
@pytest.mark.parametrize("app", ["bfs", "sssp"])
def test_reduce_mode_matches_reference(app, collapse):
    g_ref, g, root, part_ref, part = _both()
    kw = dict(use_pallas=True, pallas_mode="reduce", collapse=collapse)
    want, want_stats, _ = getattr(ref_apps, app)(
        g_ref, root, part=part_ref, cfg=ref_engine.EngineConfig(**kw))
    got, stats, _ = getattr(apps, app)(g, root, part=part, device="cpu",
                                       cfg=engine.EngineConfig(**kw))
    np.testing.assert_array_equal(got, want)
    assert [int(x) for x in stats] == [int(x) for x in want_stats]
    if collapse == "eager":     # deferred runs are held to the reference
        oracle = reference.bfs_levels if app == "bfs" \
            else reference.sssp_dijkstra
        np.testing.assert_array_equal(got, oracle(g, root))


def test_reduce_mode_pagerank_matches_reference():
    g_ref = ref_generators.rmat(8, edge_factor=8, seed=3)
    g = generators.rmat(8, edge_factor=8, seed=3)
    cfg = dict(use_pallas=True, pallas_mode="reduce")
    want, _ = ref_apps.pagerank(g_ref, num_shards=4, rpvo_max=4,
                                cfg=ref_engine.EngineConfig(**cfg))
    got, _ = apps.pagerank(g, num_shards=4, rpvo_max=4, device="cpu",
                           cfg=engine.EngineConfig(**cfg))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_reduce_mode_has_no_laned_form():
    _, _, _, _, part = _both()
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    cfg = engine.EngineConfig(use_pallas=True, pallas_mode="reduce")
    q = 2
    val = torch.zeros((part.S * part.R_max, q))
    with pytest.raises(ValueError, match="fused-only"):
        exchange.relax(actions.SSSP, cfg, arrays.edge_src_root_flat,
                       arrays.edge_w, arrays.edge_mask, arrays.edge_dst_flat,
                       val, val > 0, part.S * part.R_max)
