"""The port's ``lm.models.Model`` against the reference's, for all ten
archs at ``reduced()`` width in float32, with the reference's
``Model.init`` weights carried across by ``interop.lm_params_from_numpy``:
``prefill`` and three ``decode_step``s give logits within rtol/atol 1e-4
and equal greedy tokens; the parameters' names, shapes and logical axes
are the reference's at full width; a decode with per-sequence positions
equals one sequence at a time.  The port runs on the CPU."""
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
from repro_torch.lm.models.model import Model, build_stages  # noqa: E402

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _batch(cfg, B, S_, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = _rand(rng, B, cfg.n_patches, cfg.d_model)
    if cfg.family == "enc_dec":
        b["frames"] = _rand(rng, B, cfg.encoder.n_frames, cfg.d_model)
    return b


def _models(arch, seed=0):
    rcfg, pcfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    ref = RefModel(rcfg)
    params, _ = ref.init(jax.random.PRNGKey(seed))
    port = Model(pcfg, device="cpu")
    port.load_state_dict(lm_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params)))
    return ref, params, port


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_prefill_and_decode_equal_reference(arch):
    ref, params, port = _models(arch)
    pp = port.param_tree()
    B, S_ = 2, 8
    b = _batch(ref.cfg, B, S_, 1)
    pre = ref.cfg.n_patches if ref.cfg.family == "vlm" else 0
    max_len = pre + S_ + 3
    rlog, rc = ref.prefill(params, {k: jnp.asarray(v) for k, v in b.items()},
                           ref.init_cache(B, max_len))
    plog, pc = port.prefill(pp, b, port.init_cache(B, max_len))
    assert plog.shape == (B, 1, ref.cfg.vocab)
    for i in range(4):
        _close(plog, rlog)
        rt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]
        pt = _np(plog[:, -1].argmax(-1))[:, None]
        np.testing.assert_array_equal(pt, rt)
        if i == 3:
            break
        rlog, rc = ref.decode_step(params, jnp.asarray(rt, jnp.int32), rc,
                                   jnp.asarray(pre + S_ + i, jnp.int32))
        plog, pc = port.decode_step(pp, pt, pc, pre + S_ + i)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "granite-moe-1b-a400m",
                                  "xlstm-125m", "jamba-v0.1-52b"])
def test_per_sequence_positions_equal_one_sequence_at_a_time(arch):
    """decode_step with a (B,) tensor of positions over ragged prompts
    equals each sequence's own B = 1 decode."""
    _, _, port = _models(arch)
    pp = port.param_tree()
    rng = np.random.default_rng(11)
    lens = [3, 6, 5]
    max_len = 10
    caches = port.init_cache(3, max_len)
    prompts = [rng.integers(0, port.cfg.vocab, (1, n)) for n in lens]
    for b, pr in enumerate(prompts):
        view = {k: v for k, v in caches.items()}
        sub = _slot(view, b)
        port.prefill(pp, {"tokens": pr}, sub)
    tok = rng.integers(0, port.cfg.vocab, (3, 1))
    got, _ = port.decode_step(pp, tok, caches, torch.tensor(lens))
    for b, pr in enumerate(prompts):
        one = port.init_cache(1, max_len)
        port.prefill(pp, {"tokens": pr}, one)
        want, _ = port.decode_step(pp, tok[b:b + 1], one, lens[b])
        _close(got[b:b + 1], want, dict(rtol=1e-5, atol=1e-5))


def _slot(caches, b):
    if isinstance(caches, dict):
        return {k: _slot(v, b) for k, v in caches.items()}
    return caches[:, b:b + 1]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_parameters_and_axes(arch):
    """The port's parameter names, shapes and logical axes are the
    reference's (``Model.init``'s trees, flattened), at full width."""
    ref = RefModel(REF_ARCHS[arch])
    box = {}

    def shapes(key):
        params, box["axes"] = ref.init(key)
        return params

    params_shape = jax.eval_shape(shapes, jax.random.PRNGKey(0))
    axes = box["axes"]
    port = Model(ARCHS[arch], device="meta")
    flat = {}

    def walk(t, a, prefix):
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], a[k], f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = (tuple(t[k].shape), a[k])

    walk(params_shape, axes, "")
    got = {k: (tuple(v.shape), port.param_axes[k])
           for k, v in port.state_dict().items()}
    assert got == flat
    assert [dataclasses.astuple(s) for s in build_stages(ARCHS[arch])] == \
        [dataclasses.astuple(s) for s in ref.stages]


def test_init_draws_from_the_generator():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    a, b = Model(cfg, device="cpu"), Model(cfg, device="cpu")
    a.init(torch.Generator().manual_seed(4))
    b.init(torch.Generator().manual_seed(4))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    w = a.param_tree()["stage0"]["moe"]["w_up"]
    assert w.shape[0] == cfg.n_layers
    assert not torch.equal(w[0], w[1])                   # layer by layer
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.02
