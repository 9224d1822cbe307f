"""The port's ``lax.scan`` (``repro_torch.lm.models.scan.scan``) and the
recurrences that run through it, at small widths on the CPU:

* the Mamba, sLSTM and mLSTM trips scanned give a plain Python loop's
  values bit for bit, with and without a gradient wanted;
* their gradients (inputs, constants, initial carry) equal autograd
  through the plain loop at rtol 1e-6 (float32), and the products
  issued (``FlopCounterMode``) are autograd's;
* ``apply_mamba``, ``apply_slstm`` and ``apply_mlstm`` and their input
  and weight gradients equal the reference's ``jax.grad`` on the same
  numpy inputs, within ``tests/test_torch_lm.py``'s tolerance (values)
  and ``tests/test_torch_lm_train.py``'s (gradients);
* on a gloo (2, 2) world (``tests/torch_dist_scan.py``) the sharded
  values and gradients equal the unsharded ones and no ``DTensor`` op is
  issued inside a trip.

``tests/test_torch_scan_counts.py`` holds the dry run's counted traces
against unrolled ones."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.lm.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.lm.models import layers as RL  # noqa: E402
from repro.lm.models import ssm as RS  # noqa: E402
from repro_torch.lm.configs import ARCHS  # noqa: E402
from repro_torch.lm.models import ssm as S  # noqa: E402
from repro_torch.lm.models.scan import scan  # noqa: E402

TESTS = os.path.dirname(__file__)
BODIES = ("mamba", "slstm", "mlstm")
# tests/test_torch_lm.py's tolerance for these blocks' values (its mLSTM
# state: atol 1e-4); tests/test_torch_lm_train.py's for gradients: rtol
# 1e-4, atol 1e-5 of the largest |grad| entry (a weight's gradient sums
# B * S float32 terms: the old loop through autograd missed rtol 1e-5 by
# as much, 6.5e-5 on the mLSTM's f_bias)
TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-4)
REF_GRAD_RTOL, REF_GRAD_ATOL_OF_MAX = 1e-4, 1e-5
# scan against autograd through the loop: rtol 1e-6, and an atol of 1e-6
# of the largest |grad| entry (an entry that cancels to ~0 keeps float32
# noise of the terms it sums)
GRAD_RTOL = GRAD_ATOL_OF_MAX = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _body(name, seed=0):
    """(step, carry, xs, consts, length) of one trip function at small
    widths, its inputs from a numpy seed."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    if name == "mamba":
        B, T, di, N = 2, 16, 8, 4
        xs = (t(B, T, di), F.softplus(t(B, T, di)), t(B, T, N), t(B, T, N))
        return (S._mamba_trip, (t(B, di, N),), xs,
                (-torch.exp(t(di, N, scale=0.5)),), T)
    if name == "slstm":
        B, T, H, hd = 2, 16, 2, 4
        # a negative n (and an m that keeps the forget weight at 1) makes
        # the clamp of the denominator bind
        n0 = t(B, H, hd)
        carry = (t(B, H, hd), torch.where(n0 < -1, -5.0, n0.abs()),
                 t(B, H))
        xs = (t(B, T, H, hd), t(B, T, H, hd), t(B, T, H),
              F.logsigmoid(t(B, T, H)) + 3.0)
        return S._slstm_trip, carry, xs, (), T
    B, nc, Lc, H, hd = 2, 3, 8, 2, 4
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool))
    xs = (t(B, nc, Lc, H, hd, scale=0.5), t(B, nc, Lc, H, hd, scale=0.5),
          t(B, nc, Lc, H, hd), t(B, nc, Lc, H),
          F.logsigmoid(t(B, nc, Lc, H) + 3.0))
    carry = (t(B, H, hd, hd), t(B, H, hd).abs(), t(B, H))
    return S._mlstm_trip, carry, xs, (tri,), nc


def _plain_loop(step, carry, xs, consts, length):
    """The trips as a plain Python loop, outputs stacked at the end."""
    ys = []
    for t in range(length):
        carry, y = step(carry, tuple(x.select(1, t) for x in xs), consts,
                        torch.einsum)
        ys.append(y)
    return carry, tuple(torch.stack(v, 1) for v in zip(*ys))


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("body", BODIES)
def test_scan_values_equal_a_plain_loop(body, grad):
    step, carry, xs, consts, length = _body(body)
    xs = tuple(x.requires_grad_(grad) for x in xs)
    got = scan(step, carry, xs, consts=consts)
    want = _plain_loop(step, carry, xs, consts, length)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g.detach(), w.detach())


def _loss_and_grads(run, step, carry, xs, consts, length, seed=1):
    """Every float input's gradient of sum(outputs * w) + sum(final
    carry * wc), and the FLOPs of the forward and backward."""
    rng = np.random.default_rng(seed)
    leaves = [t.clone().requires_grad_(True) if t.is_floating_point()
              else t for t in carry + xs + consts]
    c = tuple(leaves[:len(carry)])
    x = tuple(leaves[len(carry):len(carry) + len(xs)])
    k = tuple(leaves[len(carry) + len(xs):])
    with FlopCounterMode(display=False) as fc:
        final, ys = run(step, c, x, k, length)
        loss = sum((v * torch.from_numpy(rng.standard_normal(v.shape)
                                         .astype(np.float32))).sum()
                   for v in final + ys)
        loss.backward()
    return [t.grad for t in leaves if t.requires_grad], fc.get_total_flops()


@pytest.mark.parametrize("body", BODIES)
def test_scan_gradients_equal_autograd_through_the_loop(body):
    """Gradients of the inputs, the constants and the initial carry, and
    the products issued (forward and backward FLOPs) equal autograd's
    through the plain loop."""
    args = _body(body)
    got, got_flops = _loss_and_grads(
        lambda s, c, x, k, n: scan(s, c, x, consts=k), *args)
    want, want_flops = _loss_and_grads(_plain_loop, *args)
    assert got_flops == want_flops
    assert (got_flops > 0) == (body != "slstm")     # the sLSTM: no product
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        w = w.numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * float(np.abs(w).max()))


def test_slstm_clamp_binds_and_passes_no_gradient():
    """The sLSTM body's case above binds the denominator's clamp: where
    it binds, neither the scan's nor autograd's gradient reaches n."""
    step, carry, xs, consts, length = _body("slstm")
    z, o, li, lf = (x.select(1, 0) for x in xs)
    c, n, m = carry
    m_new = torch.maximum(lf + m, li)
    n_new = (torch.exp(lf + m - m_new)[..., None] * n
             + torch.exp(li - m_new)[..., None])
    assert bool((n_new < 1e-6).any())
    n0 = n.clone().requires_grad_(True)
    (_, _, _), (h,) = scan(step, (c, n0, m), xs)
    h.select(1, 0).sum().backward()
    assert bool((n0.grad[n_new < 1e-6] == 0).all())


# ---------------------------------------------------------------------------
# the blocks against the reference's jax.grad
# ---------------------------------------------------------------------------

BLOCKS = {"mamba": ("jamba-v0.1-52b", 9), "slstm": ("xlstm-125m", 7),
          "mlstm": ("xlstm-125m", 300)}     # mLSTM: two chunks, padded


@pytest.mark.parametrize("block", BLOCKS)
def test_block_values_and_gradients_equal_reference(block):
    arch, seq = BLOCKS[block]
    rcfg, pcfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    params, _ = RL.split_tree(getattr(RS, f"init_{block}")(
        jax.random.PRNGKey(3), rcfg, jnp.float32))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(11)
    for k in ("conv_b", "dt_bias"):
        if k in params:
            params[k] = (rng.standard_normal(params[k].shape) * 0.2
                         ).astype(np.float32)
    x = rng.standard_normal((2, seq, rcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, seq, rcfg.d_model)).astype(np.float32)
    ref_apply = getattr(RS, f"apply_{block}")

    def ref_loss(p, xx):
        out, state = ref_apply(p, rcfg, xx)
        return jnp.sum(out * w), (out, state)

    (_, (want, wstate)), (gp, gx) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(params, x)
    pt = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    got, gstate = getattr(S, f"apply_{block}")(pt, pcfg, xt)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, v in wstate.items():
        np.testing.assert_allclose(gstate[k].detach().numpy(), np.asarray(v),
                                   **STATE_TOL)
    for name, g, v in [("x", xt.grad, gx)] + [(k, pt[k].grad, v)
                                               for k, v in gp.items()]:
        v = np.asarray(v)
        np.testing.assert_allclose(
            g.numpy(), v, rtol=REF_GRAD_RTOL,
            atol=REF_GRAD_ATOL_OF_MAX * float(np.abs(v).max()), err_msg=name)


# ---------------------------------------------------------------------------
# a gloo (2, 2) world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("scan_mesh") / "out.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(TESTS, "..", "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable,
                          os.path.join(TESTS, "torch_dist_scan.py"), str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-6000:]
    return dict(np.load(out))


@pytest.mark.parametrize("block", BLOCKS)
def test_sharded_recurrence_equals_unsharded(mesh_runs, block):
    """The block on the (2, 2) mesh (weights and input placed) against
    the same block whole on each rank: outputs, final states and every
    gradient; forward and backward trips ran, none issued a ``DTensor``
    op."""
    z = mesh_runs
    keys = [k for k in z if k.startswith(f"{block}_whole_")
            and not k.endswith(("_trips", "_dtensor_ops"))]
    assert any("_grad_" in k for k in keys)
    for k in keys:
        want = z[k]
        np.testing.assert_allclose(
            z[k.replace("_whole_", "_mesh_")], want, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(want).max()), 1.0), err_msg=k)
    assert z[f"{block}_mesh_trips"] == z[f"{block}_whole_trips"] > 0
    assert z[f"{block}_mesh_dtensor_ops"] == 0
