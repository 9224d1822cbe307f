"""The port's optimizer and train step against the reference's, on the
CPU.

``AdamW.update`` and ``cosine_schedule`` on the same gradients; one
``make_train_step`` step (plain, ``accum_steps=4``, and with int8
compression and error feedback) from the same weights and batch, to the
tolerances of the reference's ``tests/test_grad_accum.py``;
``accum_steps=4`` against the full batch in the port alone."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro.lm.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.lm.models.model import Model as RefModel  # noqa: E402
from repro.lm.train import optimizer as ref_opt  # noqa: E402
from repro.lm.train import train_step as ref_ts  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.lm.configs import ARCHS  # noqa: E402
from repro_torch.lm.models.model import Model, _flatten  # noqa: E402
from repro_torch.lm.train import AdamW, cosine_schedule  # noqa: E402
from repro_torch.lm.train import make_train_step  # noqa: E402
from repro_torch.lm.train.train_step import (  # noqa: E402
    TrainState, batch_axes, cache_axes_tree)
from repro_torch.sharding import compression  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small ops run in six test workers at
    once, where torch's default thread pool spins against the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_grad_accum.py's tolerance: near-zero gradients let Adam's
# normalizer turn float summation noise into whole-step sign flips
STEP_TOL = dict(rtol=5e-4, atol=6e-4)
# a first Adam step moves an entry by lr * g / (|g| + eps): where the
# clipped gradient is under EPS_REGIME (100 eps) the step is a ratio of
# two numbers at the float32 noise of the backward, so such an entry is
# held to one lr, the most a step can move it
EPS_REGIME = 1e-6


def _np_tree(tree):
    return _flatten(jax.tree.map(lambda x: np.asarray(x, np.float32), tree))


def _assert_trees_close(port_tree, ref_tree, **tol):
    got = _flatten(lm_params_to_numpy(port_tree))
    want = _np_tree(ref_tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _setup(arch="minitron-4b", vocab=128, seed=0):
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), vocab=vocab)
    pcfg = dataclasses.replace(ARCHS[arch].reduced(), vocab=vocab)
    ref = RefModel(rcfg)
    params, _ = ref.init(jax.random.PRNGKey(seed))
    port = Model(pcfg, device="cpu")
    port.load_state_dict(lm_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params)))
    return ref, params, port


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_cosine_schedule_equals_reference():
    ref = ref_opt.cosine_schedule(3e-4, warmup=10, total=100)
    port = cosine_schedule(3e-4, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(port(torch.tensor(step))),
                                   float(ref(jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_adamw_update_equals_reference(lr):
    """Three updates of the same gradients (large enough to clip) from
    the same weights: parameters, moments, ``grad_norm`` and ``lr``."""
    _, params, port = _setup("granite-moe-1b-a400m")
    kw = dict(lr=1e-2 if lr == "constant"
              else None, weight_decay=0.1, clip_norm=0.5)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params) for _ in range(3)]
    ropt = ref_opt.AdamW(**{**kw, "lr": kw["lr"] or ref_opt.cosine_schedule(
        1e-2, warmup=2, total=10)})
    popt = AdamW(**{**kw, "lr": kw["lr"] or cosine_schedule(
        1e-2, warmup=2, total=10)})
    rstate = ropt.init(params)
    pparams = port.param_tree()
    pstate = popt.init(pparams)
    for g in grads:
        params, rstate, rm = ropt.update(
            jax.tree.map(jnp.asarray, g), rstate, params)
        pg = {k: torch.as_tensor(v) for k, v in _flatten(g).items()}
        out, pstate, pm = popt.update(_unflatten(pg), pstate, pparams)
        assert out is pparams
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6)
    assert int(pstate.step) == int(rstate.step) == 3
    _assert_trees_close(pparams, params, rtol=1e-5, atol=1e-6)
    _assert_trees_close(pstate.mu, rstate.mu, rtol=1e-5, atol=1e-7)
    _assert_trees_close(pstate.nu, rstate.nu, rtol=1e-5, atol=1e-9)


def _unflatten(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def test_adamw_blocks_along_the_leading_axis(monkeypatch):
    """An update in blocks of a few rows equals the whole-leaf update (up
    to the order of the norm's float32 sum)."""
    from repro_torch.lm.train import optimizer
    rng = np.random.default_rng(3)
    p0 = {"w": torch.as_tensor(rng.standard_normal((7, 5, 3)),
                               dtype=torch.bfloat16),
          "b": torch.as_tensor(rng.standard_normal(11), dtype=torch.float32)}
    g = {k: torch.as_tensor(rng.standard_normal(v.shape), dtype=v.dtype)
         for k, v in p0.items()}
    outs = []
    for block in (1 << 24, 16):
        monkeypatch.setattr(optimizer, "BLOCK_ELEMS", block)
        p = {k: v.clone() for k, v in p0.items()}
        opt = AdamW(lr=1e-2)
        st = opt.init(p)
        for _ in range(2):
            _, st, _ = opt.update(g, st, p)
        outs.append((p, st))
    (pa, sa), (pb, sb) = outs
    for k in p0:
        assert pa[k].dtype == pb[k].dtype == p0[k].dtype
        torch.testing.assert_close(pa[k], pb[k], rtol=1e-6, atol=0)
        torch.testing.assert_close(sa.mu[k], sb.mu[k], rtol=1e-6, atol=0)
        torch.testing.assert_close(sa.nu[k], sb.nu[k], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _ref_step(ref, params, batch, opt, **kw):
    step = jax.jit(ref_ts.make_train_step(ref, opt, **kw))
    res = (ref_ts.compression.init_residuals(params)
           if kw.get("compress_grads") else None)
    state = ref_ts.TrainState(params, opt.init(params), res)
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in m.items()}


def _port_step(port, batch, opt, **kw):
    step = make_train_step(port, opt, **kw)
    params = port.param_tree()
    res = (compression.init_residuals(params)
           if kw.get("compress_grads") else None)
    state, m = step(TrainState(params, opt.init(params), res), batch)
    assert all(p.grad is None and not p.requires_grad
               for p in port.parameters())
    return state, {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("kind", ["plain", "accum4", "compress"])
@pytest.mark.parametrize("arch", ["minitron-4b", "granite-moe-1b-a400m"])
def test_train_step_equals_reference(arch, kind):
    ref, params, port = _setup(arch)
    batch = RefPipeline(vocab=128, seq_len=16, global_batch=8,
                        seed=2).batch_at(0)
    kw = {"plain": {}, "accum4": {"accum_steps": 4},
          "compress": {"compress_grads": True}}[kind]
    rs, rm = _ref_step(ref, params, batch,
                       ref_opt.AdamW(lr=1e-2, weight_decay=0.0), **kw)
    ps, pm = _port_step(port, batch, AdamW(lr=1e-2, weight_decay=0.0), **kw)
    assert set(pm) == set(rm)
    for k in rm:
        np.testing.assert_allclose(pm[k], rm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    _assert_step_close(ps, rs, lr=1e-2, b1=0.9)


def _assert_step_close(ps, rs, lr, b1):
    """One step's parameters within STEP_TOL, but entries whose clipped
    gradient (the reference's first moment over 1 - b1) is under
    EPS_REGIME within one lr."""
    got = _flatten(lm_params_to_numpy(ps.params))
    want, mu = _np_tree(rs.params), _np_tree(rs.opt.mu)
    assert set(got) == set(want)
    for k in want:
        tiny = np.abs(mu[k] / (1 - b1)) < EPS_REGIME
        np.testing.assert_allclose(got[k][~tiny], want[k][~tiny], err_msg=k,
                                   **STEP_TOL)
        assert np.all(np.abs(got[k][tiny] - want[k][tiny]) <= lr), k


def test_accum_matches_full_batch():
    """As the reference's ``tests/test_grad_accum.py``, in the port."""
    _, _, full = _setup()
    _, _, acc = _setup()
    batch = RefPipeline(vocab=128, seq_len=16, global_batch=8,
                        seed=2).batch_at(0)
    sf, mf = _port_step(full, batch, AdamW(lr=1e-2, weight_decay=0.0))
    sa, ma = _port_step(acc, batch, AdamW(lr=1e-2, weight_decay=0.0),
                        accum_steps=4)
    np.testing.assert_allclose(ma["ce"], mf["ce"], rtol=1e-5)
    for k, v in _flatten(sf.params).items():
        np.testing.assert_allclose(_flatten(sa.params)[k].numpy(), v.numpy(),
                                   err_msg=k, **STEP_TOL)


def test_accum_needs_a_batch_that_splits():
    _, _, port = _setup()
    batch = RefPipeline(vocab=128, seq_len=8, global_batch=6,
                        seed=2).batch_at(0)
    with pytest.raises(ValueError, match="microbatches"):
        _port_step(port, batch, AdamW(), accum_steps=4)


def test_axes_helpers_equal_reference():
    for arch in sorted(ARCHS):
        assert batch_axes(ARCHS[arch]) == ref_ts.batch_axes(REF_ARCHS[arch])
        rcfg, pcfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
        want = ref_ts.cache_axes_tree(jax.eval_shape(
            lambda: RefModel(rcfg).init_cache(2, 8)))
        got = cache_axes_tree(Model(pcfg, device="meta").init_cache(2, 8))
        assert got == want, arch


def test_serve_exports_are_the_train_steps():
    from repro_torch import serve
    from repro_torch.lm.train import train_step
    assert serve.cache_axes_tree is train_step.cache_axes_tree
    assert serve.make_serve_steps is train_step.make_serve_steps
    with pytest.raises(AttributeError):
        serve.no_such_name  # noqa: B018
