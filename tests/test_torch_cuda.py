"""The port's CUDA kernel against its plain version, on the card.

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

from repro_torch.apps import bfs, sssp  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.graph import generators, reference  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels.ref import fused_relax_reduce_ref  # noqa: E402

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
