"""The port's LM stack against the reference's on the same numpy inputs
and weights: every function of ``layers``, ``moe`` and ``ssm`` at
``reduced()`` widths in float32 (rtol/atol 1e-5; MoE expert indices,
ranks and ``moe_drop_fraction`` exact), and ``spec_for`` on the meshes
of ``tests/test_sharding_specs.py``.  ``tests/test_torch_lm_model.py``
holds the whole models.  The port runs on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.lm.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.lm.models import layers as RL  # noqa: E402
from repro.lm.models import moe as RM  # noqa: E402
from repro.lm.models import ssm as RS  # noqa: E402
from repro.sharding import specs as ref_specs  # noqa: E402
from repro_torch.lm.configs import ARCHS  # noqa: E402
from repro_torch.lm.models import layers as L  # noqa: E402
from repro_torch.lm.models import moe as M  # noqa: E402
from repro_torch.lm.models import ssm as S  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **changes):
    """The reference's and the port's reduced config of ``arch``."""
    ref = dataclasses.replace(REF_ARCHS[arch].reduced(), **changes)
    port = dataclasses.replace(ARCHS[arch].reduced(), **changes)
    return ref, port


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _ref_params(init_fn, cfg):
    """Numpy leaves of a reference init function's params."""
    tree = init_fn(jax.random.PRNGKey(3), cfg, jnp.float32)
    params, _ = RL.split_tree(tree)
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_rope_and_positions():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 4, 16)
    scale = _rand(rng, 16)
    _close(L.rms_norm(_t(x), _t(scale), 1e-6), RL.rms_norm(x, scale, 1e-6))
    pos = np.arange(3, 8)
    _close(L.rope(_t(x), _t(pos), 1e4), RL.rope(x, pos, 1e4))
    _close(L.rope(_t(x), _t(pos), 8e6), RL.rope(x, pos, 8e6))
    _close(L.sinusoidal_positions(12, 64, torch.float32),
           RL.sinusoidal_positions(12, 64, jnp.float32))


@pytest.mark.parametrize("mask", ["causal", "full", "prefix"])
@pytest.mark.parametrize("kv", [1, 2, 4])
@pytest.mark.parametrize("attn", ["_plain_attention", "_chunked_attention"])
def test_attention_kernels(attn, kv, mask):
    rng = np.random.default_rng(1)
    sk = 1300 if attn == "_chunked_attention" else 11   # 2 chunks, padded
    q = _rand(rng, 2, 5, 4, 16)
    k, v = _rand(rng, 2, sk, kv, 16), _rand(rng, 2, sk, kv, 16)
    qp, kp = np.arange(sk - 5, sk), np.arange(sk)
    ref_fn, fn = {"causal": (RL.causal_mask, L.causal_mask),
                  "full": (RL.full_mask, L.full_mask),
                  "prefix": (RL.prefix_lm_mask(3), L.prefix_lm_mask(3))}[mask]
    want = getattr(RL, attn)(q, k, v, ref_fn, qp, kp, 0.25)
    got = getattr(L, attn)(_t(q), _t(k), _t(v), fn, _t(qp), _t(kp), 0.25)
    _close(got, want)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "qwen3-32b",
                                  "whisper-medium", "paligemma-3b"])
def test_apply_attention_with_and_without_cache(arch):
    """GQA/MQA, qk-norm, biases; a prompt into a cache at 0, then one
    step at its index, against the reference's cache contents."""
    rcfg, pcfg = _cfgs(arch)
    p = _ref_params(RL.init_attention, rcfg)
    for k in ("bq", "bk", "bv", "bo", "q_norm", "k_norm"):
        if k in p:      # non-trivial biases and norms
            p[k] = _rand(np.random.default_rng(len(k)), *p[k].shape, scale=0.3)
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 6, rcfg.d_model)
    pos = np.arange(6)
    want, _ = RL.apply_attention(p, rcfg, x, pos, RL.causal_mask, None)
    got, _ = L.apply_attention(_t(p), pcfg, _t(x), _t(pos), L.causal_mask,
                               None)
    _close(got, want)

    kv, hd = rcfg.n_kv_heads, rcfg.hd
    cache = {"k": np.zeros((2, 9, kv, hd), np.float32),
             "v": np.zeros((2, 9, kv, hd), np.float32)}
    pcache = _t(cache)
    want, rc = RL.apply_attention(p, rcfg, x, pos, RL.causal_mask, None,
                                  cache=cache, cache_index=0)
    got, pc = L.apply_attention(_t(p), pcfg, _t(x), _t(pos), L.causal_mask,
                                None, cache=pcache, cache_index=0)
    _close(got, want)
    _close(pc, rc)
    assert pc["k"] is pcache["k"]                       # written in place
    x1 = _rand(rng, 2, 1, rcfg.d_model)
    want, rc = RL.apply_attention(p, rcfg, x1, np.array([6]), RL.causal_mask,
                                  None, cache=rc, cache_index=6)
    got, pc = L.apply_attention(_t(p), pcfg, _t(x1), torch.tensor([6]),
                                L.causal_mask, None, cache=pc, cache_index=6)
    _close(got, want)
    _close(pc, rc)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "gelu"])
def test_apply_mlp(act):
    rcfg, pcfg = _cfgs("minitron-4b", mlp_act=act)
    p = _ref_params(RL.init_mlp, rcfg)
    x = _rand(np.random.default_rng(3), 2, 5, rcfg.d_model)
    _close(L.apply_mlp(_t(p), pcfg, _t(x), None),
           RL.apply_mlp(p, rcfg, x, None))


@pytest.mark.parametrize("arch,softcap", [("paligemma-3b", 0.0),
                                          ("minitron-4b", 0.0),
                                          ("minitron-4b", 5.0)])
def test_embed_and_unembed(arch, softcap):
    rcfg, pcfg = _cfgs(arch, logit_softcap=softcap)
    emb = _ref_params(RL.init_embedding, rcfg)
    un = (_ref_params(RL.init_unembed, rcfg) if not rcfg.tie_embeddings
          else {})
    tok = np.random.default_rng(4).integers(0, rcfg.vocab, (2, 7))
    want = RL.embed(emb, tok, rcfg)
    got = L.embed(_t(emb), _t(tok), pcfg)
    _close(got, want)
    _close(L.unembed(_t(un), _t(emb), got, pcfg, None),
           RL.unembed(un, emb, want, rcfg, None))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("T", [1, 7, 40])
def test_route_group_exact(T):
    """The dispatch metadata (expert ids, ranks, token order, keep) are
    exact and the buffer equal, with ties broken to the lower index."""
    rng = np.random.default_rng(T)
    xt = _rand(rng, T, 16)
    logits = _rand(rng, T, 6)
    logits[::3, 2] = logits[::3, 4]                      # exact ties
    C = max(int(T * 2 / 6 * 1.25), 1)
    want_buf, want_meta = RM._route_group(xt, logits, 6, 2, C, "swiglu")
    got_buf, got_meta = M._route_group(_t(xt), _t(logits), 6, 2, C, "swiglu")
    _close(got_buf, want_buf)
    e_idx, rank_c, st, sg, keep, probs, flat_e = got_meta
    for name, g, w in zip(("e_idx", "rank_c", "st", "keep", "flat_e"),
                          (e_idx, rank_c, st, keep, flat_e),
                          (want_meta[0], want_meta[1], want_meta[2],
                           want_meta[4], want_meta[6])):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    _close(sg, want_meta[3])
    _close(probs, want_meta[5])


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe(arch, grouped):
    opts = ("moe_grouped",) if grouped else ()
    rcfg, pcfg = _cfgs(arch, opts=opts)
    p = _ref_params(RM.init_moe, rcfg)
    x = _rand(np.random.default_rng(5), 3, 9, rcfg.d_model)
    want, waux = RM.apply_moe(p, rcfg, x, None)
    got, gaux = M.apply_moe(_t(p), pcfg, _t(x), None)
    _close(got, want)
    assert float(gaux["moe_drop_fraction"]) == float(
        waux["moe_drop_fraction"])
    for k in ("moe_load_balance", "moe_router_z"):
        _close(gaux[k], waux[k])


def test_moe_grouped_by_sequence_equals_one_sequence_at_a_time():
    """groups=B routes each sequence of a (B, 1, d) step alone, as the
    reference's decode of one slot at a time (T = 1, its own capacity)."""
    rcfg, pcfg = _cfgs("granite-moe-1b-a400m")
    p = _ref_params(RM.init_moe, rcfg)
    x = _rand(np.random.default_rng(6), 5, 1, rcfg.d_model)
    got, _ = M.apply_moe_grouped(_t(p), pcfg, _t(x), None, groups=5)
    for b in range(5):
        want, _ = RM.apply_moe(p, rcfg, x[b:b + 1], None)
        _close(got[b:b + 1], want)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

def test_mamba_sequence_and_step():
    rcfg, pcfg = _cfgs("jamba-v0.1-52b")
    p = _ref_params(RS.init_mamba, rcfg)
    rng = np.random.default_rng(7)
    for k in ("conv_b", "dt_bias"):
        p[k] = _rand(rng, *p[k].shape, scale=0.2)
    for S_ in (2, 9):                   # shorter and longer than d_conv
        x = _rand(rng, 2, S_, rcfg.d_model)
        want, wst = RS.apply_mamba(p, rcfg, x)
        got, gst = S.apply_mamba(_t(p), pcfg, _t(x))
        _close(got, want)
        _close(gst, wst)
    x1 = _rand(rng, 2, 1, rcfg.d_model)
    want, wst = RS.mamba_step(p, rcfg, x1, wst)
    got, gst = S.mamba_step(_t(p), pcfg, _t(x1), gst)
    _close(got, want)
    _close(gst, wst)
    _close(S.mamba_init_state(_t(p), pcfg, 3, torch.float32),
           RS.mamba_init_state(p, rcfg, 3, jnp.float32))


@pytest.mark.parametrize("seq", [5, 300])       # one chunk; two, padded
def test_mlstm_sequence_and_step(seq):
    rcfg, pcfg = _cfgs("xlstm-125m")
    p = _ref_params(RS.init_mlstm, rcfg)
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, seq, rcfg.d_model)
    want, wst = RS.apply_mlstm(p, rcfg, x)
    got, gst = S.apply_mlstm(_t(p), pcfg, _t(x))
    _close(got, want)
    _close(gst, wst, dict(rtol=1e-5, atol=1e-4))
    x1 = _rand(rng, 2, 1, rcfg.d_model)
    want, wst = RS.mlstm_step(p, rcfg, x1, wst)
    got, gst = S.mlstm_step(_t(p), pcfg, _t(x1), gst)
    _close(got, want)
    _close(gst, wst, dict(rtol=1e-5, atol=1e-4))
    _close(S.mlstm_init_state(_t(p), pcfg, 3, torch.float32),
           RS.mlstm_init_state(p, rcfg, 3, jnp.float32))


def test_slstm_sequence_and_step():
    rcfg, pcfg = _cfgs("xlstm-125m")
    p = _ref_params(RS.init_slstm, rcfg)
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 7, rcfg.d_model)
    want, wst = RS.apply_slstm(p, rcfg, x)
    got, gst = S.apply_slstm(_t(p), pcfg, _t(x))
    _close(got, want)
    _close(gst, wst)
    x1 = _rand(rng, 2, 1, rcfg.d_model)
    want, wst = RS.slstm_step(p, rcfg, x1, wst)
    got, gst = S.slstm_step(_t(p), pcfg, _t(x1), gst)
    _close(got, want)
    _close(gst, wst)
    _close(S.slstm_init_state(_t(p), pcfg, 3, torch.float32),
           RS.slstm_init_state(p, rcfg, 3, jnp.float32))


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


class FakeDeviceMesh:
    """The names and sizes a ``DeviceMesh`` exposes."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


MESH_CASES = [
    ({"data": 16, "model": 16}, "default", ("embed", "mlp"), (4096, 16384)),
    ({"data": 16, "model": 16}, "default", ("embed", "kv_heads", None),
     (4096, 8, 128)),
    ({"data": 16, "model": 16}, "default", ("heads", "mlp"), (64, 25600)),
    ({"pod": 2, "data": 16, "model": 16}, "default", ("act_batch", None),
     (256, 4096)),
    ({"data": 2, "model": 2}, "default", ("embed", "heads", None),
     (1024, 64, 128)),
    ({"data": 8, "model": 4}, "default", ("embed", "heads", None),
     (1024, 64, 128)),
    ({"pod": 2, "data": 4, "model": 8}, "default", ("embed", "heads", None),
     (1024, 64, 128)),
    ({"data": 16, "model": 16}, "opt",
     ("layers", "act_batch", "act_kv_seq", "act_kv_heads", None),
     (40, 128, 32768, 8, 128)),
    ({"data": 4, "model": 2}, "tp_only", ("embed", "vocab"), (64, 512)),
    ({"data": 4, "model": 2}, "tp_only", ("act_batch", "act_kv_seq"), None),
]


@pytest.mark.parametrize("mesh_cls", [FakeMesh, FakeDeviceMesh])
@pytest.mark.parametrize("case", range(len(MESH_CASES)))
def test_spec_for_equals_reference(case, mesh_cls):
    shape, rules, axes, dims = MESH_CASES[case]
    dp = tuple(a for a in ("pod", "data") if a in shape)
    want = ref_specs.spec_for(axes, ref_specs.ShardCtx(
        mesh=FakeMesh(shape), rules=rules, dp=dp, tp=("model",)), dims)
    ctx = specs.ShardCtx(mesh=mesh_cls(shape), rules=rules, dp=dp,
                         tp=("model",))
    got = specs.spec_for(axes, ctx, dims)
    assert PartitionSpec(*got) == want
    assert ctx.axis_size("dp") == int(np.prod([shape[a] for a in dp]))


def test_constrain_without_a_mesh_is_identity_and_raises_with_one():
    """Identity without a mesh; on a bound one (here a one-rank gloo
    mesh) it places the tensor as a ``DTensor`` of the same value (the
    4-rank cases are ``tests/test_torch_lm_sharded.py``'s)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch_dist import single_rank_mesh
    x = torch.ones(4, 4)
    assert specs.constrain(x, ("act_batch", None), None) is x
    assert specs.constrain(x, ("act_batch", None), specs.ShardCtx()) is x
    assert specs.spec_for(("embed", "mlp"), specs.ShardCtx()) == \
        ("data", "model")
    with single_rank_mesh() as mesh:
        out = specs.constrain(x, ("act_batch", None),
                              specs.ShardCtx(mesh=mesh))
        assert isinstance(out, DTensor)
        assert out.placements == (Replicate(), Replicate())
        assert torch.equal(specs.gathered(out), x)
