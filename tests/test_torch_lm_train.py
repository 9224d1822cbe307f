"""The port's ``Model.loss`` against the reference's, for all ten archs at
``reduced()`` width in float32, with the reference's ``Model.init``
weights carried across by ``interop.lm_params_from_numpy``: the loss and
every metric within rtol 1e-5, every gradient leaf (``backward`` on the
port, ``jax.value_and_grad`` on the reference) within GRAD_RTOL and
GRAD_ATOL_OF_MAX.  In the port alone: ``_chunked_ce`` equals the dense
loss, and remat on and off give the same loss and gradients.  The port
runs on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.lm.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.lm.models.model import Model as RefModel  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.lm.configs import ARCHS, get_config  # noqa: E402
from repro_torch.lm.models.model import Model, _flatten  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small ops run in six test workers at
    once, where torch's default thread pool spins against the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_RTOL = 1e-5
# gradients: rtol 1e-4, and an atol of 1e-5 of the model's largest |grad|
# entry (a key bias's gradient is zero in exact arithmetic, ~1e-8 of noise
# in either package's float32 sums)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5


def _batch(cfg, B, S, seed, labels=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "enc_dec":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return b


def _port_grads(model, batch):
    """(loss, metrics, {name: grad}) of the port's loss and backward."""
    params = model.param_tree()
    leaves = _flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss(params, batch)
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in leaves.items()}
    finally:
        for p in leaves.values():
            p.grad = None
            p.requires_grad_(False)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()}, grads)


def assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * top, err_msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_equal_reference(arch):
    rcfg, pcfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    ref = RefModel(rcfg)
    params, _ = ref.init(jax.random.PRNGKey(0))
    port = Model(pcfg, device="cpu")
    port.load_state_dict(lm_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params)))
    b = _batch(rcfg, 2, 8, 1)
    (rl, rm), rg = jax.value_and_grad(
        lambda p: ref.loss(p, {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True)(params)
    pl, pm, pg = _port_grads(port, b)
    np.testing.assert_allclose(pl, float(rl), rtol=LOSS_RTOL)
    assert set(pm) == set(rm)
    for k in rm:
        np.testing.assert_allclose(pm[k], float(rm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert_grads_close(pg, _flatten(jax.tree.map(np.asarray, rg)))


def _twins(cfg, other):
    a = Model(cfg, device="cpu")
    a.init(torch.Generator().manual_seed(0))
    b = Model(other, device="cpu")
    b.load_state_dict(a.state_dict())
    return a, b


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_changes_nothing(arch):
    """Each layer under ``torch.utils.checkpoint`` (remat on) gives the
    loss, metrics and gradients of the plain run."""
    cfg = ARCHS[arch].reduced()
    on, off = _twins(dataclasses.replace(cfg, remat=True),
                     dataclasses.replace(cfg, remat=False))
    b = _batch(cfg, 2, 8, 3, labels=False)
    l1, m1, g1 = _port_grads(on, b)
    l2, m2, g2 = _port_grads(off, b)
    assert l1 == l2 and m1 == m2
    for k in g2:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-6, atol=1e-7,
                                   msg=k)


@pytest.mark.parametrize("arch", ["minitron-4b", "granite-moe-1b-a400m"])
def test_chunked_ce_equals_dense(arch):
    """As the reference's ``tests/test_layers.py``: CE over 256-token
    chunks (two of them here) equals the dense loss, gradients too."""
    cfg = get_config(arch).reduced()
    dense, chunked = _twins(cfg, dataclasses.replace(cfg,
                                                     opts=("chunked_ce",)))
    b = _batch(cfg, 2, 513, 5)
    l1, _, g1 = _port_grads(dense, b)
    l2, _, g2 = _port_grads(chunked, b)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


def test_stacked_leaves_get_one_gradient_each():
    """In train mode a stage's stacked leaf is unbound once, so its
    gradient is one stacked tensor with a distinct slice a layer."""
    cfg = get_config("phi3-medium-14b").reduced()
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    _, _, g = _port_grads(model, _batch(cfg, 2, 8, 1))
    w = g["stage0.mlp.wi"]
    assert w.shape[0] == cfg.n_layers and not torch.equal(w[0], w[1])
    assert all(p.grad is None and not p.requires_grad
               for p in model.parameters())
