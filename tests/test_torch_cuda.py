"""The port's CUDA kernels (K1 dense, K2 worklist) against their plain
versions, on the card.

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
from repro_torch.kernels.ref import (  # noqa: E402
    fused_relax_reduce_ref, fused_relax_reduce_wl_ref,
)

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
