"""Top-k token-choice MoE with static capacity and shared experts.

Routing is sort/scatter based — no (T, E, C) dispatch tensor:

1. per-group top-k assignment (ties go to the lower expert index),
2. rank-within-expert via a stable sort and cumulative counts,
3. scatter into an (E, C, d) buffer; capacity overflow drops, like
   classic capacity-factor routing (the dropped rows land in an extra
   expert row that is cut off),
4. grouped einsum over experts,
5. gather back + combine with router weights (``index_add_``: on a GPU
   the combine's float order is not fixed).

The capacity ``C`` follows the token count of a group, so a one-token
group drops differently from a batch: a batched decode over a slot pool
routes each slot as its own group (``apply_moe_grouped(..., groups=B)``),
as the reference's per-slot decode does.

**Rhizome note:** token→expert routing is a skewed bipartite graph; the
(E, C) buffer is the expert's "replica slot" row and the capacity clip
plays the cutoff_chunk role — the same split-hot-destinations idea the
paper applies to hub vertices.

``apply_moe_shardmap`` (expert parallelism over a mesh) waits for
sharded LM training (ROADMAP Queue 1, item 12c).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.lm.models import layers as L
from repro_torch.sharding.specs import ShardCtx, constrain


def init_moe(key, cfg, dtype):
    m = cfg.moe
    d = cfg.d_model
    f = m.d_expert_ff
    p = {
        "router": L.dense_init(key, (d, m.num_experts), ("embed", None),
                               dtype, scale=0.1),
        "w_gate": L.dense_init(key, (m.num_experts, d, f),
                               ("experts", "embed", "expert_mlp"), dtype,
                               fan_in=d),
        "w_up": L.dense_init(key, (m.num_experts, d, f),
                             ("experts", "embed", "expert_mlp"), dtype,
                             fan_in=d),
        "w_down": L.dense_init(key, (m.num_experts, f, d),
                               ("experts", "expert_mlp", "embed"), dtype,
                               fan_in=f),
    }
    if m.num_shared:
        shared_ff = m.d_shared_ff or m.d_expert_ff
        p["shared"] = L.init_mlp(key, cfg, dtype,
                                 d_ff=shared_ff * m.num_shared)
    return p


def top_k(probs, k):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    return max(int(tokens * m.top_k / m.num_experts * m.capacity_factor), 1)


def _route_groups(xt, logits, E, K, C):
    """``_route_group`` over a leading group axis: xt (G,T,d), logits
    (G,T,E) -> (buf (G,E,C,d), meta), every op local to its group."""
    G, T, d = xt.shape
    dev = xt.device
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_e = eidx.reshape(G, T * K)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_g = gate_vals.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    st = flat_t[order]
    sg = flat_g.gather(1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev
                         ).scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(T * K, device=dev) - starts.gather(1, se)
    keep = rank < C
    rank_c = torch.where(keep, rank, 0)
    e_idx = torch.where(keep, se, E)                # E => dropped
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, T * K)
    rows = torch.where(keep[..., None],
                       xt.gather(1, st[..., None].expand(G, T * K, d)), 0.0)
    buf = torch.zeros((G, E + 1, C, d), dtype=xt.dtype, device=dev)
    buf[g_idx, e_idx, rank_c] = rows
    return buf[:, :E], (e_idx, rank_c, st, sg, keep, probs, flat_e)


def _route_group(xt, logits, E, K, C, mlp_act):
    """Route one token group (xt (T,d), logits (T,E)): returns (dispatch
    buffer (E,C,d), combine metadata)."""
    buf, meta = _route_groups(xt[None], logits[None], E, K, C)
    return buf[0], tuple(t[0] for t in meta)


def _expert_ffn(p, cfg, buf):
    """(..., E, C, d) dispatch buffer -> (..., E, C, d) expert outputs."""
    h = torch.einsum("...ecd,edf->...ecf", buf, p["w_up"])
    if cfg.mlp_act in ("swiglu", "geglu"):
        act = F.silu(torch.einsum("...ecd,edf->...ecf", buf, p["w_gate"])) * h
    else:
        act = torch.square(F.relu(h))
    return torch.einsum("...ecf,efd->...ecd", act, p["w_down"])


def _combine(out_buf, e_idx, rank_c, st, sg, keep, T):
    """(G,E,C,d) expert outputs -> (G,T,d): each token's kept rows,
    weighted by their gates and summed (``index_add_``)."""
    G, E, C, d = out_buf.shape
    g_idx = torch.arange(G, device=out_buf.device)[:, None]
    gathered = out_buf[g_idx, e_idx.clamp(max=E - 1), rank_c]
    gathered = torch.where(keep[..., None], gathered, 0.0)
    out = torch.zeros((G * T, d), dtype=out_buf.dtype, device=out_buf.device)
    out.index_add_(0, (g_idx * T + st).reshape(-1),
                   (gathered * sg[..., None].to(out_buf.dtype)
                    ).reshape(-1, d))
    return out.reshape(G, T, d)


def _aux(cfg, logits, probs, flat_e, keep, T):
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    me = probs.reshape(-1, E).mean(dim=0)
    ce = torch.bincount(flat_e.reshape(-1), minlength=E) / (T * K)
    return {
        "moe_load_balance": E * torch.sum(me * ce) * m.router_aux_weight,
        "moe_router_z": (torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
                         * m.router_z_weight),
        "moe_drop_fraction": 1.0 - keep.float().mean(),
    }


def apply_moe(p, cfg, x, ctx: ShardCtx | None):
    """x: (B, S, d) -> (out, aux_losses dict)."""
    if "moe_shardmap" in cfg.opts and ctx is not None and ctx.mesh is not None:
        raise NotImplementedError(
            "apply_moe_shardmap is not ported yet (ROADMAP Queue 1, item "
            "12c: sharded LM training)")
    if "moe_grouped" in cfg.opts or "moe_shardmap" in cfg.opts:
        return apply_moe_grouped(p, cfg, x, ctx)
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    xt = x.reshape(1, T, d)
    logits = torch.einsum("gtd,de->gte", xt, p["router"]).float()
    buf, (e_idx, rank_c, st, sg, keep, probs, flat_e) = _route_groups(
        xt, logits, E, K, capacity(T, cfg))
    buf = constrain(buf[0], ("act_experts", None, None), ctx)
    out_buf = constrain(_expert_ffn(p, cfg, buf), ("act_experts", None, None),
                        ctx)
    out = _combine(out_buf[None], e_idx, rank_c, st, sg, keep, T
                   ).reshape(T, d)
    if m.num_shared:
        out = out + L.apply_mlp(p["shared"], cfg, x, ctx).reshape(T, d)
    return out.reshape(B, S, d), _aux(cfg, logits, probs, flat_e, keep, T)


def apply_moe_grouped(p, cfg, x, ctx: ShardCtx | None, groups: int | None = None):
    """Group-local routing: the tokens split into ``groups`` equal groups
    (default: the mesh's dp size, 1 without a mesh), each routed with its
    own capacity.  ``groups=B`` routes each sequence of a (B, 1, d)
    decode step alone."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    G = groups or (ctx.axis_size("dp") if ctx is not None
                   and ctx.mesh is not None else 1)
    T = B * S
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G

    xg = constrain(x.reshape(G, Tg, d), ("act_batch", None, None), ctx)
    logits = torch.einsum("gtd,de->gte", xg, p["router"]).float()
    buf, (e_idx, rank_c, st, sg, keep, probs, flat_e) = _route_groups(
        xg, logits, E, K, capacity(Tg, cfg))
    buf = constrain(buf, ("act_batch", "act_experts", None, None), ctx)
    out_buf = constrain(_expert_ffn(p, cfg, buf),
                        ("act_batch", "act_experts", None, None), ctx)
    out = _combine(out_buf, e_idx, rank_c, st, sg, keep, Tg)
    out = constrain(out, ("act_batch", None, None), ctx).reshape(B, S, d)
    if m.num_shared:
        out = out + L.apply_mlp(p["shared"], cfg, x, ctx)
    return out, _aux(cfg, logits, probs, flat_e, keep, T)
