"""State-space / recurrent blocks: Mamba (selective SSM) and xLSTM
(mLSTM chunked linear attention + sLSTM scalar recurrence).

All blocks expose two forms:
* sequence form  — ``apply_*(p, cfg, x)`` over (B, S, d) for train and
  prefill: one ``scan.scan`` over time steps (Mamba, sLSTM) or over
  chunks (mLSTM), the reference's ``jax.lax.scan``; on a mesh the whole
  scan runs on each rank's shards (``local_call``, the carry elementwise
  over the sharded batch and inner / head dims), so a trip issues no
  ``DTensor`` op.  The reference's ``scan_unroll`` option changes nothing
  here;
* step form      — ``*_step(p, cfg, x_t, state)`` for O(1) decode.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.lm.models import layers as L
from repro_torch.lm.models.scan import scan
from repro_torch.sharding.specs import constrain, local_call, pointwise

MLSTM_CHUNK = 256


# ---------------------------------------------------------------------------
# Mamba (selective SSM, mamba-1 style as used by Jamba)
# ---------------------------------------------------------------------------

def init_mamba(key, cfg, dtype):
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.expand * d
    dt_rank = max(d // 16, 1)
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                     device=key.device).repeat(di, 1)
    return {
        "in_proj": L.dense_init(key, (d, 2 * di), ("embed", "mamba_inner"), dtype),
        "conv_w": L.dense_init(key, (mc.d_conv, di), (None, "mamba_inner"),
                               dtype, fan_in=mc.d_conv),
        "conv_b": L.zeros_init(key, (di,), ("mamba_inner",), dtype),
        "x_proj": L.dense_init(key, (di, dt_rank + 2 * mc.d_state),
                               ("mamba_inner", None), dtype, fan_in=di),
        "dt_proj": L.dense_init(key, (dt_rank, di), (None, "mamba_inner"),
                                dtype, fan_in=dt_rank),
        "dt_bias": L.zeros_init(key, (di,), ("mamba_inner",), dtype),
        "A_log": L.Leaf(torch.log(a), ("mamba_inner", None)),
        "D": L.ones_init(key, (di,), ("mamba_inner",), torch.float32),
        "out_proj": L.dense_init(key, (di, d), ("mamba_inner", "embed"),
                                 dtype, fan_in=di),
    }


def _causal_conv(u, w, b):
    """Causal depthwise conv along S of u (B,S,di) with w (d_conv, di),
    then the bias and SiLU."""
    up = F.pad(u, (0, 0, w.shape[0] - 1, 0))
    return F.silu(sum(up[:, i: i + u.shape[1]] * w[i]
                      for i in range(w.shape[0])) + b)


_INNER = ("act_batch", None, "act_mamba_inner")


def _mamba_scan_inputs(p, cfg, u, ctx=None):
    """Shared front: conv + projections. u: (B,S,di) -> (u,dt,Bm,Cm).
    The conv runs on each rank's batch rows and inner channels (it is
    depthwise; torch 2.11's ``DTensor`` pad crashes redistributing)."""
    mc = cfg.mamba
    dt_rank = p["dt_proj"].shape[0]
    u = local_call(_causal_conv, ctx,
                   (_INNER, (None, "mamba_inner"), ("mamba_inner",)),
                   _INNER)(u, p["conv_w"], p["conv_b"])
    # the inner dim's sum reduced here, and each product's output placed,
    # so no sum is left pending where the bias joins (torch 2.11's
    # DTensor cannot turn the bias's shards into one)
    proj = constrain(torch.einsum("bsi,ij->bsj", u, p["x_proj"]),
                     ("act_batch", None, None), ctx)
    dt_in, Bm, Cm = torch.split(proj, [dt_rank, mc.d_state, mc.d_state],
                                dim=-1)
    dt = F.softplus(constrain(torch.einsum("bsr,ri->bsi", dt_in,
                                           p["dt_proj"]), _INNER, ctx)
                    + p["dt_bias"])
    return u, dt, Bm, Cm


_ROWS = ("act_batch", None, None)


def _mamba_trip(carry, x, consts, prod):
    (h,), (u_t, dt_t, B_t, C_t), (A,) = carry, x, consts
    dA = torch.exp(dt_t[..., None] * A)             # (B,di,N)
    dBu = dt_t[..., None] * B_t[:, None, :] * u_t[..., None]
    h = h * dA + dBu
    return (h,), (prod("bin,bn->bi", h, C_t),)


def _mamba_recurrence(u, dt, Bm, Cm, A):
    """The selective scan over S of u, dt (B,S,di), B, C (B,S,N) and A
    (di,N) (a rank's shards on a mesh): y (B,S,di) and the final
    (B,di,N) state, in float32."""
    B, _, di = u.shape
    h0 = torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                     device=u.device)
    (h,), (y,) = scan(_mamba_trip, (h0,),
                      tuple(t.float() for t in (u, dt, Bm, Cm)), consts=(A,))
    return y, h


def _in_proj_halves(w, ctx):
    """The (d, di) halves of ``in_proj`` (d, 2*di) — the SSM input's and
    the gate's — each placed by its own axes.  On a mesh the inner dim
    is gathered first: a split of a dim sharded over its whole length
    would need the halves' shards on other ranks (torch 2.11's
    ``DTensor`` crashes redistributing them for the conv's pad)."""
    halves = torch.chunk(constrain(w, ("embed", None), ctx), 2, dim=1)
    return tuple(constrain(h, ("embed", "mamba_inner"), ctx) for h in halves)


def apply_mamba(p, cfg, x, ctx=None):
    """Sequence form. x: (B,S,d). Returns (y, final_state) so prefill can
    hand the recurrent state to the decode loop."""
    mc = cfg.mamba
    # the sequence gathered whole before the product (a layer's input is
    # sequence-parallel at its boundary), as the attention's is
    x = constrain(x, ("act_batch", None, None), ctx)
    u_raw, z = (constrain(torch.einsum("bsd,de->bse", x, w), _INNER, ctx)
                for w in _in_proj_halves(p["in_proj"], ctx))
    u, dt, Bm, Cm = _mamba_scan_inputs(p, cfg, u_raw, ctx)
    A = -torch.exp(p["A_log"])                      # (di, N)
    S = u.shape[1]
    # the carry and the scan's u and dt over the batch and inner dims, B
    # and C over the batch (the reference's constraints)
    y, h = local_call(_mamba_recurrence, ctx,
                      (_INNER, _INNER, _ROWS, _ROWS, ("mamba_inner", None)),
                      (_INNER, ("act_batch", "act_mamba_inner", None)))(
                          u, dt, Bm, Cm, A)
    y = y.to(x.dtype) + u * p["D"].to(x.dtype)
    y = y * F.silu(z)
    # placed as the product's output is: a gradient that comes back
    # sequence-parallel is gathered before its backward folds (b, s)
    out = constrain(torch.einsum("bsi,id->bsd", y, p["out_proj"]),
                    ("act_batch", None, None), ctx)
    # final conv state: last (d_conv-1) pre-conv inputs
    pad = max(mc.d_conv - 1 - S, 0)
    tail = u_raw[:, S - (mc.d_conv - 1 - pad):]
    if pad:
        tail = F.pad(tail, (0, 0, pad, 0))
    state = {"conv": tail.to(u_raw.dtype), "ssm": h}
    return out, state


def mamba_init_state(p, cfg, batch, dtype):
    mc = cfg.mamba
    di = p["conv_b"].shape[0]
    dev = p["conv_b"].device
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                           device=dev),
    }


def mamba_step(p, cfg, x_t, state, ctx=None):
    """x_t: (B,1,d). O(1) decode update."""
    mc = cfg.mamba
    xz = torch.einsum("bsd,de->bse", x_t, p["in_proj"])
    u, z = torch.chunk(xz, 2, dim=-1)               # (B,1,di)
    conv_buf = torch.cat([state["conv"], u], dim=1)  # (B,d_conv,di)
    u1 = (torch.einsum("bci,ci->bi", conv_buf, p["conv_w"])
          + p["conv_b"])[:, None]
    u1 = F.silu(u1)
    dt_rank = p["dt_proj"].shape[0]
    proj = torch.einsum("bsi,ij->bsj", u1, p["x_proj"])
    dt_in, Bm, Cm = torch.split(proj, [dt_rank, mc.d_state, mc.d_state],
                                dim=-1)
    dt = F.softplus(
        torch.einsum("bsr,ri->bsi", dt_in, p["dt_proj"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[:, 0, :, None].float() * A)
    dBu = (dt[:, 0, :, None] * Bm[:, 0, None, :] * u1[:, 0, :, None]).float()
    h = state["ssm"] * dA + dBu
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0].float())[:, None]
    y = y.to(x_t.dtype) + u1 * p["D"].to(x_t.dtype)
    y = y * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"])
    return out, {"conv": conv_buf[:, 1:], "ssm": h}


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM, chunkwise-parallel linear attention w/ gating)
# ---------------------------------------------------------------------------

def init_mlstm(key, cfg, dtype):
    d, H = cfg.d_model, cfg.n_heads
    hd = cfg.hd
    return {
        "wq": L.dense_init(key, (d, H, hd), ("embed", "heads", "head_dim"), dtype),
        "wk": L.dense_init(key, (d, H, hd), ("embed", "heads", "head_dim"), dtype),
        "wv": L.dense_init(key, (d, H, hd), ("embed", "heads", "head_dim"), dtype),
        "wi": L.dense_init(key, (d, H), ("embed", "heads"), dtype, scale=0.1),
        "wf": L.dense_init(key, (d, H), ("embed", "heads"), dtype, scale=0.1),
        "f_bias": L.full_init(key, (H,), ("heads",), torch.float32, 3.0),
        "wo": L.dense_init(key, (H, hd, d), ("heads", "head_dim", "embed"),
                           dtype, fan_in=H * hd),
        "norm": L.ones_init(key, (H, hd), ("heads", "head_dim"), dtype),
    }


def _mlstm_gates(p, x):
    logf = pointwise(F.logsigmoid,
                     torch.einsum("bsd,dh->bsh", x, p["wf"]).float()
                     + p["f_bias"])
    logi = torch.einsum("bsd,dh->bsh", x, p["wi"]).float()
    return logi, logf


_HEADS = ("act_batch", None, "act_heads")
_HD = _HEADS + (None,)
_BH = ("act_batch", "act_heads")


def _mlstm_trip(carry, x, consts, prod):
    """One chunk: the chunk's outputs and the state at its end."""
    Cst, nst, mst = carry          # (B,H,hd,hd),(B,H,hd),(B,H)
    qb, kb, vb, li, lf = x
    (tri,) = consts
    # cumulative log-forget within the chunk
    Fc = torch.cumsum(lf, dim=1)                   # (B,Lc,H)
    # intra-chunk decay matrix D[t,s] = exp(F_t - F_s + i_s) for s<=t
    logD = (Fc[:, :, None, :] - Fc[:, None, :, :]
            + li[:, None, :, :])                   # (B,Lq,Ls,H)
    logD = torch.where(tri[None, :, :, None], logD, -math.inf)
    # inter-chunk: state decayed by exp(F_t), query it
    m_intra = logD.amax(dim=2)                     # (B,Lq,H)
    m_inter = mst[:, None, :] + Fc                 # (B,Lq,H)
    m_all = torch.maximum(m_intra, m_inter)
    Dn = torch.exp(logD - m_all[:, :, None, :])
    scores = prod("bqhk,bshk->bqsh", qb, kb) * Dn
    h_intra = prod("bqsh,bshk->bqhk", scores, vb)
    w_inter = torch.exp(m_inter - m_all)           # (B,Lq,H)
    h_inter = prod("bqhk,bhkx->bqhx", qb * w_inter[..., None], Cst)
    norm_intra = scores.sum(dim=2)                 # (B,Lq,H)
    norm_inter = prod("bqhk,bhk->bqh", qb * w_inter[..., None], nst)
    h = h_intra + h_inter
    denom = torch.maximum(torch.abs(norm_intra + norm_inter),
                          torch.exp(-m_all))[..., None]
    out = h / denom
    # ---- state update to end of chunk ----
    Fend = Fc[:, -1, :]                            # (B,H)
    m_new = torch.maximum(mst + Fend,
                          (Fend[:, None, :] - Fc + li).amax(dim=1))
    decay_state = torch.exp(mst + Fend - m_new)    # (B,H)
    wk_ = torch.exp(Fend[:, None, :] - Fc + li - m_new[:, None, :])
    Cst = (Cst * decay_state[..., None, None]
           + prod("bshk,bshx->bhkx", wk_[..., None] * kb, vb))
    nst = (nst * decay_state[..., None]
           + prod("bsh,bshk->bhk", wk_, kb))
    return (Cst, nst, m_new), (out,)


def _mlstm_recurrence(q, k, v, logi, logf):
    """The chunkwise scan over S of the (B,S,H,hd) queries, keys and
    values and the (B,S,H) gate logits (a rank's shards on a mesh), S
    padded to whole chunks outside the scan: the (B,S,H,hd) outputs and
    the final C, n, m, in float32."""
    B, S, H, hd = q.shape
    Lc = min(MLSTM_CHUNK, S)
    nc = -(-S // Lc)
    pad = nc * Lc - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=-30.0)
        logf = F.pad(logf, (0, 0, 0, pad))
    q, k, v = q.float(), k.float(), v.float()
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=q.device))
    carry = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=q.device),
             torch.zeros((B, H, hd), dtype=torch.float32, device=q.device),
             torch.zeros((B, H), dtype=torch.float32, device=q.device))
    xs = tuple(t.reshape(B, nc, Lc, *t.shape[2:])
               for t in (q, k, v, logi, logf))
    (Cst, nst, mst), (out,) = scan(_mlstm_trip, carry, xs, consts=(tri,))
    return out.reshape(B, nc * Lc, H, hd)[:, :S], Cst, nst, mst


def _mlstm_qkv(p, x, hd, ctx):
    """(B,S,d) -> the (B,S,H,hd) queries and keys (scaled) and values."""
    q, k, v = (L.project(x, p[w], "bsd,dhk->bshk", 1, ctx)
               for w in ("wq", "wk", "wv"))
    return q * hd ** -0.5, k * hd ** -0.5, v


def apply_mlstm(p, cfg, x, ctx=None):
    """Chunkwise-parallel mLSTM. x: (B,S,d)."""
    x = constrain(x, ("act_batch", None, None), ctx)
    q, k, v = _mlstm_qkv(p, x, cfg.hd, ctx)
    logi, logf = _mlstm_gates(p, x)
    out, Cst, nst, mst = local_call(
        _mlstm_recurrence, ctx, (_HD, _HD, _HD, _HEADS, _HEADS),
        (_HD, _BH + (None, None), _BH + (None,), _BH))(q, k, v, logi, logf)
    out = L.rms_norm(out, p["norm"], cfg.norm_eps).to(x.dtype)
    return L.heads_out(out, p["wo"], ctx), {"C": Cst, "n": nst, "m": mst}


def mlstm_init_state(p, cfg, batch, dtype):
    H, hd = cfg.n_heads, cfg.hd
    dev = p["wq"].device
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=dev),
        "n": torch.zeros((batch, H, hd), dtype=torch.float32, device=dev),
        "m": torch.zeros((batch, H), dtype=torch.float32, device=dev),
    }


def mlstm_step(p, cfg, x_t, state, ctx=None):
    """x_t: (B,1,d); O(1) recurrent update."""
    hd = cfg.hd
    x_t = constrain(x_t, ("act_batch", None, None), ctx)
    q, k, v = (t[:, 0] for t in _mlstm_qkv(p, x_t, hd, ctx))
    logi, logf = _mlstm_gates(p, x_t)
    logi, logf = logi[:, 0], logf[:, 0]              # (B,H)
    m_new = torch.maximum(state["m"] + logf, logi)
    fdec = torch.exp(state["m"] + logf - m_new)
    iw = torch.exp(logi - m_new)
    kw = (k * iw[..., None]).float()
    C = state["C"] * fdec[..., None, None] + torch.einsum(
        "bhk,bhx->bhkx", kw, v.float())
    n = state["n"] * fdec[..., None] + kw
    h = torch.einsum("bhk,bhkx->bhx", q.float(), C)
    denom = torch.maximum(
        torch.abs(torch.einsum("bhk,bhk->bh", q.float(), n)),
        torch.exp(-m_new))[..., None]
    out = (h / denom)[:, None]                       # (B,1,H,hd)
    out = L.rms_norm(out, p["norm"], cfg.norm_eps).to(x_t.dtype)
    return L.heads_out(out, p["wo"], ctx), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with exponential gating)
# ---------------------------------------------------------------------------

def init_slstm(key, cfg, dtype):
    d, H = cfg.d_model, cfg.n_heads
    hd = cfg.hd
    return {
        "wz": L.dense_init(key, (d, H, hd), ("embed", "heads", "head_dim"), dtype),
        "wi": L.dense_init(key, (d, H), ("embed", "heads"), dtype, scale=0.1),
        "wf": L.dense_init(key, (d, H), ("embed", "heads"), dtype, scale=0.1),
        "wo_gate": L.dense_init(key, (d, H, hd), ("embed", "heads", "head_dim"), dtype),
        "f_bias": L.full_init(key, (H,), ("heads",), torch.float32, 3.0),
        "wo": L.dense_init(key, (H, hd, d), ("heads", "head_dim", "embed"),
                           dtype, fan_in=H * hd),
    }


def _slstm_step_math(p, z_t, o_t, logi, logf, state):
    c, n, m = state                                  # (B,H,hd),(B,H,hd),(B,H)
    m_new = torch.maximum(logf + m, logi)
    fw = torch.exp(logf + m - m_new)[..., None]
    iw = torch.exp(logi - m_new)[..., None]
    c_new = fw * c + iw * torch.tanh(z_t)
    n_new = fw * n + iw
    h = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return h, (c_new, n_new, m_new)


def _slstm_inputs(p, x, ctx):
    """x (B,S,d) -> the (B,S,H,hd) cell and output-gate inputs and the
    (B,S,H) gate logits, the sequence gathered whole first."""
    x = constrain(x, ("act_batch", None, None), ctx)
    z = L.project(x, p["wz"], "bsd,dhk->bshk", 1, ctx).float()
    o = L.project(x, p["wo_gate"], "bsd,dhk->bshk", 1, ctx).float()
    logi = torch.einsum("bsd,dh->bsh", x, p["wi"]).float()
    logf = (pointwise(F.logsigmoid,
                      torch.einsum("bsd,dh->bsh", x, p["wf"]).float())
            + p["f_bias"])
    return z, o, logi, logf


def _slstm_trip(carry, x, consts, prod):
    h, carry = _slstm_step_math(None, *x, carry)
    return carry, (h,)


def _slstm_recurrence(z, o, logi, logf):
    """The scalar recurrence over S of the (B,S,H,hd) cell and gate
    inputs and the (B,S,H) gate logits (a rank's shards on a mesh): the
    (B,S,H,hd) outputs and the final c, n, m."""
    B, _, H, hd = z.shape
    carry = (torch.zeros((B, H, hd), dtype=torch.float32, device=z.device),
             torch.zeros((B, H, hd), dtype=torch.float32, device=z.device),
             torch.full((B, H), -30.0, dtype=torch.float32, device=z.device))
    (cf, nf, mf), (h,) = scan(_slstm_trip, carry, (z, o, logi, logf))
    return h, cf, nf, mf


def apply_slstm(p, cfg, x, ctx=None):
    z, o, logi, logf = _slstm_inputs(p, x, ctx)
    # the state elementwise over the batch and heads
    h, cf, nf, mf = local_call(
        _slstm_recurrence, ctx, (_HD, _HD, _HEADS, _HEADS),
        (_HD, _BH + (None,), _BH + (None,), _BH))(z, o, logi, logf)
    h = h.to(x.dtype)                                # (B,S,H,hd)
    return L.heads_out(h, p["wo"], ctx), {"c": cf, "n": nf, "m": mf}


def slstm_init_state(p, cfg, batch, dtype):
    H, hd = cfg.n_heads, cfg.hd
    dev = p["wz"].device
    return {
        "c": torch.zeros((batch, H, hd), dtype=torch.float32, device=dev),
        "n": torch.zeros((batch, H, hd), dtype=torch.float32, device=dev),
        "m": torch.full((batch, H), -30.0, dtype=torch.float32, device=dev),
    }


def slstm_step(p, cfg, x_t, state, ctx=None):
    z, o, logi, logf = (t[:, 0] for t in _slstm_inputs(p, x_t, ctx))
    h, (c, n, m) = _slstm_step_math(
        p, z, o, logi, logf, (state["c"], state["n"], state["m"]))
    out = L.heads_out(h.to(x_t.dtype)[:, None], p["wo"], ctx)
    return out, {"c": c, "n": n, "m": m}
