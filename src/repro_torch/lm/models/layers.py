"""Core transformer layers: RMSNorm, RoPE, GQA attention (+KV cache,
online-softmax chunking for long sequences), MLP variants, embeddings.

Parameter convention: init fns return a tree (nested dicts) whose leaves
are ``Leaf(value, axes)`` — a weight plus its logical sharding axes.
``split_tree`` separates (params, axes); apply fns consume plain tensors.
Weights are drawn by a ``Draw``: an explicit ``torch.Generator`` on a
device, or the ``meta`` device, which gives shapes and dtypes only.

Products are ``torch.einsum`` in the activation dtype, as the reference's
``jnp.einsum`` are; attention scores are float32 (the reference's
``preferred_element_type``).  A KV cache is written in place at
``cache_index`` and the same tensors are returned: a scalar index writes
rows ``[index, index + S)`` of every sequence, a (B,) index writes one
row a sequence at its own position (the batched decode of a slot pool).
A cache placed on a mesh (its sequence dim sharded under the "opt"
rules) is written shard by shard, each rank at its own offset.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.specs import (ShardCtx, constrain, is_dtensor,
                                       local_offset)


@dataclasses.dataclass
class Leaf:
    value: torch.Tensor
    axes: tuple


def split_tree(tree):
    """(params, axes): the two trees of a tree of ``Leaf``s."""
    if isinstance(tree, Leaf):
        return tree.value, tree.axes
    pairs = {k: split_tree(v) for k, v in tree.items()}
    return ({k: p for k, (p, _) in pairs.items()},
            {k: a for k, (_, a) in pairs.items()})


class Draw:
    """Where and from what parameters are drawn: ``generator`` on its
    device, or shapes only on the ``meta`` device (``generator=None``)."""

    def __init__(self, generator: torch.Generator | None = None):
        self.generator = generator
        self.device = (generator.device if generator is not None
                       else torch.device("meta"))

    def normal(self, shape):
        return torch.randn(shape, generator=self.generator,
                           dtype=torch.float32, device=self.device)


def dense_init(key: Draw, shape, axes, dtype, fan_in: int | None = None,
               scale=1.0):
    fan = fan_in if fan_in is not None else shape[0]
    w = key.normal(shape) * (scale / np.sqrt(max(fan, 1)))
    return Leaf(w.to(dtype), axes)


def zeros_init(key: Draw, shape, axes, dtype):
    return Leaf(torch.zeros(shape, dtype=dtype, device=key.device), axes)


def ones_init(key: Draw, shape, axes, dtype):
    return Leaf(torch.ones(shape, dtype=dtype, device=key.device), axes)


def full_init(key: Draw, shape, axes, dtype, value):
    return Leaf(torch.full(shape, value, dtype=dtype, device=key.device),
                axes)


# ---------------------------------------------------------------------------
# norms / positions
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps):
    dt = x.dtype
    xf = x.float()
    nrm = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / nrm) * scale.float()).to(dt)


def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs  # (...,S,half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq, d, dtype, device=None):
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(emb, device=device).to(dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CHUNK_THRESHOLD = 8192
KV_CHUNK = 1024


def init_attention(key, cfg, dtype):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(key, (d, H, hd), ("embed", "heads", "head_dim"), dtype),
        "wk": dense_init(key, (d, KV, hd), ("embed", "kv_heads", "head_dim"), dtype),
        "wv": dense_init(key, (d, KV, hd), ("embed", "kv_heads", "head_dim"), dtype),
        "wo": dense_init(key, (H, hd, d), ("heads", "head_dim", "embed"),
                         dtype, fan_in=H * hd),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones_init(key, (hd,), ("head_dim",), dtype)
        p["k_norm"] = ones_init(key, (hd,), ("head_dim",), dtype)
    if cfg.attn_bias:
        p["bq"] = zeros_init(key, (H, hd), ("heads", "head_dim"), dtype)
        p["bk"] = zeros_init(key, (KV, hd), ("kv_heads", "head_dim"), dtype)
        p["bv"] = zeros_init(key, (KV, hd), ("kv_heads", "head_dim"), dtype)
        p["bo"] = zeros_init(key, (d,), ("embed",), dtype)
    return p


def _mask(mask_fn, q_pos, k_pos):
    """(1, 1, Sq, Sk) or, for per-sequence positions, (B, 1, Sq, Sk)."""
    m = mask_fn(q_pos[..., :, None], k_pos[..., None, :])
    return m[None, None] if m.dim() == 2 else m[:, None]


def _grouped_scores(q, k, scale):
    """float32 (B, KV, rep, Sq, Sk) scores of q (B,Sq,H,hd) against k
    (B,Sk,KV,hd): query head h reads KV head h // rep, as the
    reference's ``jnp.repeat(k, rep, axis=2)`` does, without the copy."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    return torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale


def _plain_attention(q, k, v, mask_fn, q_pos, k_pos, scale):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd). Returns (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    logits = _grouped_scores(q, k, scale).reshape(B, H, Sq, -1)
    logits = torch.where(_mask(mask_fn, q_pos, k_pos), logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd",
                       probs.reshape(B, k.shape[2], -1, Sq, k.shape[1]), v)
    return out.reshape(B, Sq, H, hd)


def _chunked_attention(q, k, v, mask_fn, q_pos, k_pos, scale):
    """Online-softmax over KV chunks: O(Sq·C) live memory (flash pattern)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    nc = -(-Sk // KV_CHUNK)
    pad = nc * KV_CHUNK - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), -(10 ** 9),
                                             dtype=k_pos.dtype,
                                             device=k_pos.device)])
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for c in range(nc):
        sl = slice(c * KV_CHUNK, (c + 1) * KV_CHUNK)
        kb, vb, pb = k[:, sl], v[:, sl], k_pos[..., sl]
        logits = _grouped_scores(q, kb, scale).reshape(B, H, Sq, -1)
        logits = torch.where(_mask(mask_fn, q_pos, pb), logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgrqk,bkgd->bgrqd",
                          p.to(q.dtype).reshape(B, KV, rep, Sq, -1).float(),
                          vb.float()).reshape(B, H, Sq, hd)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2)  # (B,Sq,H,hd)


def write_cache(c, new, cache_index):
    """Write ``new`` (B,S,...) into the cache ``c`` (B,Smax,...) in place:
    rows [i, i + S) for a scalar ``i`` (clamped so they fit, as
    ``dynamic_update_slice`` does), or row ``i[b]`` of sequence b for a
    (B,) tensor (S = 1).  Returns ``c``."""
    new = new.to(c.dtype)
    if is_dtensor(c):
        return _write_cache_local(c, new, cache_index)
    if torch.is_tensor(cache_index) and cache_index.dim() == 1:
        idx = cache_index.clamp(0, c.shape[1] - 1)
        c[torch.arange(c.shape[0], device=c.device), idx] = new[:, 0]
    else:
        start = min(max(int(cache_index), 0), c.shape[1] - new.shape[1])
        c[:, start:start + new.shape[1]] = new
    return c


def _write_cache_local(c, new, cache_index):
    """``write_cache`` into a placed cache: each rank writes the rows of
    its own shard (its batch rows, its slice of the sequence at its
    offset) from ``new`` with the sequence dim gathered whole."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = c.device_mesh
    pl = tuple(Replicate() if q.is_shard(1) else q for q in c.placements)
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    new = new.redistribute(mesh, pl).to_local()
    local = c.to_local()
    b0, s0 = local_offset(c)[:2]
    nb, n = local.shape[:2]
    if torch.is_tensor(cache_index) and cache_index.dim() == 1:
        rows = cache_index.clamp(0, c.shape[1] - 1)[b0:b0 + nb] - s0
        ok = (rows >= 0) & (rows < n)
        b = torch.arange(nb, device=local.device)[ok]
        local[b, rows[ok]] = new[ok, 0]
    else:
        S = new.shape[1]
        start = min(max(int(cache_index), 0), c.shape[1] - S)
        lo, hi = max(start, s0), min(start + S, s0 + n)
        if lo < hi:
            local[:, lo - s0:hi - s0] = new[:, lo - start:hi - start]
    return c


def _partial_where(ref, used):
    """Gradient placements of a local view taken from ``used``: a
    pending sum over the mesh dims where ``ref`` is sharded and ``used``
    is whole (each rank there used part of it), ``used``'s own
    placements elsewhere."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if r.is_shard() and u.is_replicate() else u
                 for r, u in zip(ref.placements, used.placements))


def _attention_on_shards(attn, q, k, v, mask_fn, q_pos, k_pos, scale, ctx):
    """The attention core on each rank's own batch rows and query heads
    (heads are independent): the batched products over two sharded
    batch dims (batch, heads) are left to no ``DTensor`` view rule.
    A rank's query heads read the KV heads ``h // rep`` of its own."""
    from torch.distributed.tensor import DTensor
    if q_pos.dim() > 1:
        raise ValueError("per-sequence positions are not supported on a "
                         "mesh")
    q = constrain(q, ("act_batch", None, "act_heads", None), ctx)
    k = constrain(k, ("act_batch", None, "act_kv_heads", None), ctx)
    v = constrain(v, ("act_batch", None, "act_kv_heads", None), ctx)
    rep = q.shape[2] // k.shape[2]
    h0, kv0 = local_offset(q)[2], local_offset(k)[2]
    grad = _partial_where(q, k)
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=grad) for t in (k, v))
    nq = ql.shape[2]
    if h0 % rep == 0 and nq % rep == 0:
        sl = slice(h0 // rep - kv0, (h0 + nq) // rep - kv0)
        kl, vl = kl[:, :, sl], vl[:, :, sl]
    else:                     # a group split across ranks: one KV a head
        idx = (h0 + torch.arange(nq, device=ql.device)) // rep - kv0
        kl, vl = kl[:, :, idx], vl[:, :, idx]
    out = attn(ql, kl, vl, mask_fn, q_pos, k_pos, scale)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def apply_attention(p, cfg, x, positions, mask_fn, ctx: ShardCtx | None,
                    kv_override=None, cache=None, cache_index=None):
    """x: (B,S,d). mask_fn(q_pos, k_pos)->bool. Returns (out, new_cache).

    kv_override: (xkv, kv_positions) for cross-attention.
    cache: dict(k=(B,Smax,KV,hd), v=...) for incremental decode, written
    in place; ``cache_index`` an int or a (B,) tensor of positions.
    """
    B, S, d = x.shape
    scale = cfg.hd ** -0.5
    # the sequence gathered whole before the projections (a layer's
    # input is sequence-parallel at its boundary)
    x = constrain(x, ("act_batch", None, None), ctx)
    q = project(x, p["wq"], "bsd,dhk->bshk", 1, ctx)
    wk, wv, wo = p["wk"], p["wv"], p["wo"]
    xkv, kv_pos = (x, positions) if kv_override is None else kv_override
    xkv = constrain(xkv, ("act_batch", None, None), ctx)
    k = project(xkv, wk, "bsd,dhk->bshk", 1, ctx)
    v = project(xkv, wv, "bsd,dhk->bshk", 1, ctx)
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_pos, cfg.rope_theta)
    q = constrain(q, ("act_batch", None, "act_heads", None), ctx)
    k = constrain(k, ("act_batch", None, "act_kv_heads", None), ctx)

    new_cache = None
    if cache is not None:
        # write this step's K/V at cache_index, attend over the full cache
        ck = write_cache(cache["k"], k, cache_index)
        cv = write_cache(cache["v"], v, cache_index)
        new_cache = {"k": ck, "v": cv}
        k, v = ck, cv
        Smax = ck.shape[1]
        kv_pos = torch.arange(Smax, device=x.device)
        mask_base = mask_fn
        lim = cache_index + S
        if torch.is_tensor(lim) and lim.dim() == 1:
            lim = lim[:, None, None]          # (B,1,1) against (..,Sq,Sk)
        mask_fn = lambda qp, kp: mask_base(qp, kp) & (kp < lim)

    Sk = k.shape[1]
    # 'attn_chunked' switches to online-softmax at train lengths too
    threshold = 1024 if "attn_chunked" in cfg.opts else ATTN_CHUNK_THRESHOLD
    attn = (_chunked_attention if max(S, Sk) > threshold
            else _plain_attention)
    if is_dtensor(q):
        out = _attention_on_shards(attn, q, k.to(q.dtype), v.to(q.dtype),
                                   mask_fn, positions, kv_pos, scale, ctx)
    else:
        out = attn(q, k.to(q.dtype), v.to(q.dtype), mask_fn,
                   positions, kv_pos, scale)
    # the heads' sum reduced here: a gradient that comes back sequence-
    # parallel is gathered before the product's backward folds (b, s)
    out = constrain(heads_out(out, wo, ctx), ("act_batch", None, None),
                    ctx)
    if cfg.attn_bias:
        out = out + p["bo"]
    return out, new_cache


def causal_mask(qp, kp):
    return kp <= qp


def full_mask(qp, kp):
    return torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)


def prefix_lm_mask(prefix_len):
    def fn(qp, kp):
        return (kp <= qp) | (kp < prefix_len)
    return fn


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(key, cfg, dtype, d_ff=None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {
            "wi": dense_init(key, (d, f), ("embed", "mlp"), dtype),
            "wg": dense_init(key, (d, f), ("embed", "mlp"), dtype),
            "wo": dense_init(key, (f, d), ("mlp", "embed"), dtype, fan_in=f),
        }
    return {  # relu2 / gelu: non-gated
        "wi": dense_init(key, (d, f), ("embed", "mlp"), dtype),
        "wo": dense_init(key, (f, d), ("mlp", "embed"), dtype, fan_in=f),
    }


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, cfg, x, ctx: ShardCtx | None):
    x = constrain(x, ("act_batch", None, None), ctx)
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.einsum("bsd,df->bsf", x, p["wg"])) * h
    elif cfg.mlp_act == "geglu":
        h = gelu(torch.einsum("bsd,df->bsf", x, p["wg"])) * h
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = gelu(h)
    h = constrain(h, ("act_batch", None, "act_mlp"), ctx)
    return constrain(torch.einsum("bsf,fd->bsd", h, p["wo"]),
                     ("act_batch", None, None), ctx)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(key, cfg, dtype):
    return {"table": dense_init(key, (cfg.vocab, cfg.d_model),
                                ("vocab", "embed"), dtype, fan_in=1)}


def _embed_on_shards(table, tokens):
    """The lookup on a placed table: each rank gathers its vocab rows
    whole (the embed dim over its mesh dims), looks up the tokens those
    rows hold (zeros for the rest) and one all-reduce over the vocab's
    mesh dims sums the parts; the result is replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.exchange import collectives as C
    mesh = table.device_mesh
    vocab_dims = [i for i, q in enumerate(table.placements) if q.is_shard(0)]
    t = table.redistribute(mesh, tuple(
        q if i in vocab_dims else Replicate()
        for i, q in enumerate(table.placements)))
    local = t.to_local()
    idx = tokens - local_offset(t)[0]
    hit = (idx >= 0) & (idx < local.shape[0])
    out = torch.where(hit[..., None], local[idx.clamp(0, local.shape[0] - 1)],
                      0)
    for i in vocab_dims:
        out = C.psum_replicated(out, mesh.get_group(i), "embed_psum")
    return DTensor.from_local(out, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def embed(p, tokens, cfg):
    x = (_embed_on_shards(p["table"], tokens) if is_dtensor(p["table"])
         else p["table"][tokens])
    if cfg.family in ("vlm",):  # gemma scales embeddings
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def init_unembed(key, cfg, dtype):
    if cfg.tie_embeddings:
        return {}
    return {"wout": dense_init(key, (cfg.d_model, cfg.vocab),
                               ("embed", "vocab"), dtype)}


def _product_on_shards(x, w, eq, keep_dim, ctx):
    """``einsum(eq, x, w)`` on each rank's batch rows and its slice of
    ``w``'s dim ``keep_dim`` (the vocab of an unembedding, the heads of
    a projection): ``w`` gathered whole but for that dim, ``x`` with its
    batch rows and the whole embed dim; the output (B, S, n, ...) keeps
    both shardings, the batch on its dim 0 and ``w``'s on its dim 2.
    Run locally, the product needs no ``DTensor`` view of its output,
    which cannot unflatten a sharded dim into one (heads) that its mesh
    dim does not divide."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = constrain(x, ("act_batch", None, None), ctx)
    mesh = x.device_mesh
    w = w.redistribute(mesh, tuple(q if q.is_shard(keep_dim) else Replicate()
                                   for q in w.placements))
    # each rank's products use its batch rows against its slice of w:
    # their gradients are pending sums over the other's mesh dims
    xl = x.to_local(grad_placements=tuple(
        Partial() if qw.is_shard() else qx
        for qx, qw in zip(x.placements, w.placements)))
    wl = w.to_local(grad_placements=tuple(
        Partial() if qx.is_shard() else qw
        for qx, qw in zip(x.placements, w.placements)))
    out = torch.einsum(eq, xl, wl)
    pl = tuple(Shard(0) if qx.is_shard(0) else Shard(2) if qw.is_shard()
               else Replicate() for qx, qw in zip(x.placements, w.placements))
    return DTensor.from_local(out, mesh, pl, run_check=False)


def heads_out(o, wo, ctx):
    """The output projection ``einsum("bshk,hkd->bsd", o, wo)``.  On a
    mesh each rank contracts its own batch rows and query heads with
    ``wo`` gathered whole but for the heads: a pending sum over the
    heads' mesh dims (the reference's heads psum), with no ``DTensor``
    view that folds (h, k) (its backward would unflatten a sharded
    (h*k) dim into heads its mesh dim does not divide)."""
    eq = "bshk,hkd->bsd"
    if not is_dtensor(wo):
        return torch.einsum(eq, o, wo)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    o = constrain(o, ("act_batch", None, "act_heads", None), ctx)
    mesh = o.device_mesh
    wo = wo.redistribute(mesh, tuple(Shard(0) if q.is_shard(2)
                                     else Replicate() for q in o.placements))
    # a rank's heads get their whole gradient; wo's is a pending sum
    # over the batch's mesh dims
    wl = wo.to_local(grad_placements=tuple(
        Partial() if qo.is_shard(0) else qw
        for qo, qw in zip(o.placements, wo.placements)))
    out = torch.einsum(eq, o.to_local(), wl)
    pl = tuple(Shard(0) if q.is_shard(0) else Partial() if q.is_shard(2)
               else Replicate() for q in o.placements)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def project(x, w, eq, keep_dim, ctx):
    """``einsum(eq, x, w)``, on a mesh by ``_product_on_shards``."""
    if is_dtensor(w):
        return _product_on_shards(x, w, eq, keep_dim, ctx)
    return torch.einsum(eq, x, w)


def unembed(p, emb_p, x, cfg, ctx):
    w, eq, vd = ((emb_p["table"], "bsd,vd->bsv", 0) if cfg.tie_embeddings
                 else (p["wout"], "bsd,dv->bsv", 1))
    logits = constrain(project(x, w, eq, vd, ctx),
                       ("act_batch", None, "act_vocab"), ctx)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
