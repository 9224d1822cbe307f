"""The port's kernel module takes the reference's call forms.

Each call the reference's benchmarks and tests make on
``repro.kernels`` is made on both packages with the same numpy inputs:
``fused_grid_cells`` in its default form and under ``grid_mode=
'worklist'`` / ``'device_worklist'`` (with ``pad_to=`` and
``dst_filter=``), ``device_worklist_pad(num_edges, num_segments)``, and
the ``_pallas`` entry points in the reference's positional order with
``interpret=`` (the port ignores it: a CPU tensor runs the kernel's
plain version).  Algorithmic keys equal the reference's values; the
launch keys of a device worklist (``wl_launched``, ``smem_table_bytes``)
describe the port's own launch.  Min results are bit-equal, sums within
rtol 1e-5 / atol 1e-6 (the reference's own kernel tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import fused_relax_reduce as ref_frr  # noqa: E402
from repro.kernels import rhizome_segment_reduce as ref_rsr  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import rhizome_segment_reduce as rsr  # noqa: E402

PAIRS = [("add_w", "min"), ("add_one", "min"), ("mul_w", "sum")]
ALGORITHMIC = ("total_fused", "total_unfused", "range_live", "fused_live",
               "chunk_ntiles", "fused_tile_dmas", "dma_bytes", "wl_cells",
               "wl_tile_dmas", "wl_tile_needed", "wl_dma_bytes")


def _stack(seed, s=4, e_max=500, nseg=700, v=900, frac=0.05, lanes=None):
    """The F3 probe: a random sorted (S, E_max) stack of 2,000 edges
    over 700 segments, a frontier of ``v`` slots (``lanes`` columns)."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, nseg, s * e_max)).astype(np.int32) \
        .reshape(s, e_max)
    src = rng.integers(0, v, (s, e_max)).astype(np.int32)
    mask = rng.random((s, e_max)) > 0.1
    shape = (v,) if lanes is None else (v, lanes)
    gchg = rng.random(shape) < frac
    return dst, mask, src, gchg, nseg


def _equal(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("vblk", [None, 128], ids=["pinned", "tiled"])
@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("seed,frac", [(0, 0.05), (1, 0.5), (2, 0.0)])
def test_fused_grid_cells_reference_form(grid_mode, vblk, seed, frac):
    dst, mask, src, gchg, nseg = _stack(seed, frac=frac)
    want = ref_frr.fused_grid_cells(dst, mask, src, gchg, nseg, vblk=vblk,
                                    grid_mode=grid_mode)
    got = frr.fused_grid_cells(dst, mask, src, gchg, nseg, vblk=vblk,
                               grid_mode=grid_mode)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for k in want:
        if k in ALGORITHMIC:
            assert _equal(got[k], want[k]), (k, got[k], want[k])
    launch = frr.plan_launch(torch.as_tensor(src.reshape(-1)),
                             torch.as_tensor(mask.reshape(-1)),
                             torch.as_tensor(dst.reshape(-1)), nseg,
                             gchg.shape[0])
    assert got["launch_cells"] == launch.num_cells
    if grid_mode == "worklist":
        # a host worklist pads as the reference's does
        assert got["wl_launched"] == want["wl_launched"]
        assert got["smem_table_bytes"] == want["smem_table_bytes"]
    elif grid_mode == "device_worklist":
        # the port's device list covers the plan's cells, not the grid
        assert got["wl_launched"] == frr.device_worklist_pad(launch)
        assert got["wl_launched"] <= want["wl_launched"]
    elif vblk is not None:
        assert got["smem_table_bytes"] == want["smem_table_bytes"]


@pytest.mark.parametrize("pad_to,dst_filter", [(8, True), (8, False),
                                               (64, True), (1, False)])
def test_fused_grid_cells_worklist_options(pad_to, dst_filter):
    dst, mask, src, gchg, nseg = _stack(3, frac=0.1)
    for vblk in (None, 256):
        kw = dict(vblk=vblk, grid_mode="worklist", pad_to=pad_to,
                  dst_filter=dst_filter)
        want = ref_frr.fused_grid_cells(dst, mask, src, gchg, nseg, **kw)
        got = frr.fused_grid_cells(dst, mask, src, gchg, nseg, **kw)
        for k in ("wl_cells", "wl_launched", "wl_tile_dmas",
                  "wl_tile_needed", "wl_dma_bytes", "smem_table_bytes"):
            assert got[k] == want[k], (vblk, k, got[k], want[k])


def test_fused_grid_cells_lane_frontier_and_flat_stack():
    """A (V, Q) lane frontier (the reference's callers pass its OR across
    lanes) and a 1-D edge stack."""
    dst, mask, src, gchg, nseg = _stack(4, lanes=5, frac=0.02)
    want = ref_frr.fused_grid_cells(dst, mask, src, gchg.any(axis=1), nseg,
                                    vblk=128, lane_width=5,
                                    grid_mode="worklist")
    got = frr.fused_grid_cells(dst, mask, src, gchg, nseg, vblk=128,
                               lane_width=5, grid_mode="worklist")
    for k in ALGORITHMIC:
        if k in want:
            assert _equal(got[k], want[k]), k
    flat = [x.reshape(-1) for x in (dst, mask, src)]
    want = ref_frr.fused_grid_cells(*flat, gchg.any(axis=1), nseg)
    got = frr.fused_grid_cells(*flat, gchg.any(axis=1), nseg)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("num_edges,num_segments", [
    (2000, 700), (1, 1), (512, 256), (513, 257), (261768 * 16, 266912)])
def test_device_worklist_pad_reference_form(num_edges, num_segments):
    assert frr.device_worklist_pad(num_edges, num_segments) \
        == ref_frr.device_worklist_pad(num_edges, num_segments)


def test_device_worklist_pad_plan_form():
    dst, mask, src, gchg, nseg = _stack(5)
    plan = frr.plan_launch(torch.as_tensor(src.reshape(-1)),
                           torch.as_tensor(mask.reshape(-1)),
                           torch.as_tensor(dst.reshape(-1)), nseg,
                           gchg.shape[0])
    assert frr.device_worklist_pad(plan) == frr._wl_pad_len(plan.num_cells)


def _edges(seed, v=900, e=2000, nseg=700, negative=False):
    rng = np.random.default_rng(seed)
    gval = rng.uniform(0.0, 10.0, v).astype(np.float32)
    gchg = rng.random(v) < 0.3
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(-2.0 if negative else 0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = np.sort(rng.integers(0, nseg, e)).astype(np.int32)
    return gval, gchg, src, w, mask, ids, nseg


def _close(got, want, kind):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    if kind == "min":
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
@pytest.mark.parametrize("relax,kind", PAIRS)
def test_fused_relax_reduce_pallas_positional(relax, kind, grid_mode):
    *args, nseg = _edges(6, negative=kind == "min")
    want, want_count = ref_frr.fused_relax_reduce_pallas(
        *args, nseg, relax, kind, True, True, grid_mode=grid_mode)
    got, count = frr.fused_relax_reduce_pallas(
        *args, nseg, relax, kind, True, True, grid_mode=grid_mode,
        device="cpu")
    _close(got, want, kind)
    assert int(count) == int(want_count)


@pytest.mark.parametrize("relax,kind", [("add_w", "min"), ("mul_w", "sum")])
def test_fused_relax_reduce_lanes_pallas_positional(relax, kind):
    rng = np.random.default_rng(7)
    gval, _, src, w, mask, ids, nseg = _edges(7)
    q = 5
    gvq = rng.uniform(0.0, 10.0, (gval.shape[0], q)).astype(np.float32)
    gcq = rng.random((gval.shape[0], q)) < 0.3
    gcq[:, 2] = False                    # a converged lane
    unitw = np.array([1, 0, 1, 0, 0], np.int32)
    want, want_count = ref_frr.fused_relax_reduce_lanes_pallas(
        gvq, gcq, unitw, src, w, mask, ids, nseg, relax, kind, True, True,
        None, None, None, 8)
    got, count = frr.fused_relax_reduce_lanes_pallas(
        gvq, gcq, unitw, src, w, mask, ids, nseg, relax, kind, True, True,
        None, None, None, 8, device="cpu")
    _close(got, want, kind)
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))


@pytest.mark.parametrize("kind", ["min", "sum"])
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_combine_pallas(kind, sorted_ids):
    rng = np.random.default_rng(8)
    e, nseg = 3000, 700
    data = rng.standard_normal(e).astype(np.float32)
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    want = ref_rsr.segment_combine_pallas(data, ids, nseg, kind,
                                          interpret=True)
    got = rsr.segment_combine_pallas(data, ids, nseg, kind, interpret=True,
                                     device="cpu")
    _close(got, want, kind)
    got = rsr.segment_combine_pallas(torch.as_tensor(data),
                                     torch.as_tensor(ids), nseg, kind)
    _close(got, want, kind)


def test_pallas_names_place_arrays_on_the_card(monkeypatch):
    """Arrays that are not tensors go where a tensor argument is, else on
    the card: without one the ``_pallas`` names raise instead of running
    the plain version on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gval, gchg, src, w, mask, ids, nseg = _edges(9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frr.fused_relax_reduce_pallas(gval, gchg, src, w, mask, ids, nseg,
                                      "add_w", "min")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frr.fused_relax_reduce_lanes_pallas(
            gval[:, None], gchg[:, None], np.ones(1, np.int32), src, w,
            mask, ids, nseg, "add_w", "min")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rsr.segment_combine_pallas(w, ids, nseg, "min")
    # a CPU tensor among the arguments is the caller asking for the CPU
    want = ref_rsr.segment_combine_pallas(w, ids, nseg, "min")
    _close(rsr.segment_combine_pallas(torch.as_tensor(w), ids, nseg, "min"),
           want, "min")
