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

On a mesh the routing (a sort, counts and scatters with no ``DTensor``
sharding rule) runs on each rank's local rows through ``local_call``:
replicated for the global routing of ``apply_moe``, a rank's own token
groups for ``apply_moe_grouped``.  ``apply_moe_shardmap`` schedules
expert parallelism by hand, as the reference's ``shard_map`` does: each
rank dispatches only its own experts' tokens, the expert weights are
all-gathered over dp, and one all-reduce over tp finishes the combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.exchange import collectives as C
from repro_torch.lm.models import layers as L
from repro_torch.sharding.specs import (ShardCtx, constrain, local_call,
                                       placements_for)

_GROUP = ("act_batch", None)
_ROUTE_OUT = (("act_batch", None, None, None),) + (_GROUP,) * 5 + (
    ("act_batch", None, None), _GROUP)


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


def expert_counts(idx, E: int):
    """``torch.bincount(idx, minlength=E)`` for expert ids ``idx < E``:
    a ``scatter_add_`` of ones, whose output shape is known before the
    ids are (a fake-tensor trace refuses ``bincount``)."""
    return torch.zeros(E, dtype=torch.int64, device=idx.device
                       ).scatter_add_(0, idx, torch.ones_like(idx,
                                                          dtype=torch.int64))


def _aux_values(cfg, logits, probs, flat_e, keep, T):
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    me = probs.reshape(-1, E).mean(dim=0)
    ce = expert_counts(flat_e.reshape(-1), E) / (T * K)
    return (E * torch.sum(me * ce) * m.router_aux_weight,
            torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
            * m.router_z_weight,
            1.0 - keep.float().mean())


def _aux(cfg, logits, probs, flat_e, keep, T, ctx=None):
    """The load-balance, z-loss and drop terms, each taken over every
    token: on a mesh the inputs are gathered whole."""
    full = lambda t: (None,) * t.dim()
    vals = local_call(
        lambda *a: _aux_values(cfg, *a, T), ctx,
        tuple(full(t) for t in (logits, probs, flat_e, keep)),
        tuple(() for _ in range(3)))(logits, probs, flat_e, keep)
    return dict(zip(("moe_load_balance", "moe_router_z",
                     "moe_drop_fraction"), vals))


def _route(xg, logits, E, K, cap, ctx):
    """``_route_groups`` on the rank's own groups (the group axis over
    dp; a group axis that does not split stays whole): (buf, e_idx,
    rank_c, st, sg, keep, probs, flat_e)."""
    return local_call(
        lambda x, lg: (lambda b, m: (b,) + m)(*_route_groups(x, lg, E, K,
                                                             cap)),
        ctx, (("act_batch", None, None), ("act_batch", None, None)),
        _ROUTE_OUT)(xg, logits)


def _combine_on(ctx, out_buf, e_idx, rank_c, st, sg, keep, T):
    return local_call(
        lambda *a: _combine(*a, T), ctx,
        (("act_batch", None, None, None),) + (_GROUP,) * 5,
        ("act_batch", None, None))(out_buf, e_idx, rank_c, st, sg, keep)


def apply_moe(p, cfg, x, ctx: ShardCtx | None):
    """x: (B, S, d) -> (out, aux_losses dict)."""
    if "moe_shardmap" in cfg.opts and ctx is not None and ctx.mesh is not None:
        return apply_moe_shardmap(p, cfg, x, ctx)
    if "moe_grouped" in cfg.opts or "moe_shardmap" in cfg.opts:
        return apply_moe_grouped(p, cfg, x, ctx)
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    xt = constrain(x, ("act_batch", None, None), ctx).reshape(1, T, d)
    logits = torch.einsum("gtd,de->gte", xt, p["router"]).float()
    buf, e_idx, rank_c, st, sg, keep, probs, flat_e = _route(
        xt, logits, E, K, capacity(T, cfg), ctx)
    buf = constrain(buf[0], ("act_experts", None, None), ctx)
    out_buf = constrain(_expert_ffn(p, cfg, buf), ("act_experts", None, None),
                        ctx)
    out = _combine_on(ctx, out_buf[None], e_idx, rank_c, st, sg, keep, T
                      ).reshape(B, S, d)
    out = constrain(out, ("act_batch", None, None), ctx)
    if m.num_shared:
        out = out + L.apply_mlp(p["shared"], cfg, x, ctx)
    return out, _aux(cfg, logits, probs, flat_e, keep, T, ctx)


def _shardmap_ffn(cfg, xg_l, eidx_l, gate_l, wg_l, wu_l, wd_l, E_loc, Cg,
                  e0, dp_group, tp_group):
    """The reference's ``shard_map`` body on one rank's local views:
    xg_l (Tg,d), eidx_l/gate_l (Tg,K), w*_l this rank's experts with
    their FSDP shard over dp.  Returns the (Tg, d) token sum over every
    expert (one all-reduce over tp)."""
    Tg, d = xg_l.shape
    K = eidx_l.shape[-1]
    E = cfg.moe.num_experts
    dev = xg_l.device
    wg = C.all_gather_dim(wg_l, 1, dp_group)
    wu = C.all_gather_dim(wu_l, 1, dp_group)
    wd = C.all_gather_dim(wd_l, 2, dp_group)
    flat_e = eidx_l.reshape(-1)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K)
    # the dispatch/combine chain stays in the activation dtype
    flat_g = gate_l.reshape(-1).to(xg_l.dtype)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = expert_counts(se, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(Tg * K, device=dev) - starts[se]
    local = (se >= e0) & (se < e0 + E_loc) & (rank < Cg)
    e_rel = torch.where(local, se - e0, E_loc)
    rank_c = torch.where(local, rank, 0)
    rows = torch.where(local[:, None], xg_l[st], 0.0)
    buf = torch.zeros((E_loc + 1, Cg, d), dtype=xg_l.dtype, device=dev)
    buf = buf.index_put((e_rel, rank_c), rows)[:E_loc]
    ob = _expert_ffn({"w_gate": wg, "w_up": wu, "w_down": wd}, cfg, buf)
    gathered = ob[e_rel.clamp(max=E_loc - 1), rank_c]
    gathered = torch.where(local[:, None], gathered, 0.0)
    part = torch.zeros((Tg, d), dtype=ob.dtype, device=dev).index_add(
        0, st, gathered * sg[:, None].to(ob.dtype))
    return C.psum_replicated(part, tp_group)       # one (Tg, d) reduce


def apply_moe_shardmap(p, cfg, x, ctx: ShardCtx):
    """Expert parallelism scheduled by hand (the reference's
    ``shard_map``): each tp rank dispatches and computes ONLY its local
    experts' tokens of its dp group, produces a partial (Tg, d) token
    sum, and one all-reduce over tp in the activation dtype finishes the
    combine.  Expert weights stay FSDP'd over dp: an all-gather inside,
    whose adjoint reduce-scatters the weight gradient."""
    from torch.distributed.tensor import DTensor, Partial
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    G = ctx.axis_size("dp")
    tp = ctx.axis_size("tp")
    T = B * S
    Tg = T // G
    Cg = max(int(Tg * K / E * m.capacity_factor), 1)
    assert E % tp == 0, (E, tp)
    E_loc = E // tp
    mesh = ctx.mesh
    dp_axes = ctx.dp if len(ctx.dp) > 1 else ctx.dp[0]
    tp_axes = ctx.tp if len(ctx.tp) > 1 else ctx.tp[0]

    # tokens grouped over dp (a (B, S) with the sequence over tp does not
    # fold into groups shard by shard)
    xg = constrain(x, ("act_batch", None, None), ctx).reshape(G, Tg, d)
    # router + aux outside (tiny, replicated over tp is fine)
    logits = torch.einsum("gtd,de->gte", xg, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = local_call(
        lambda pr: top_k(pr, K), ctx, (("act_batch", None, None),),
        (("act_batch", None, None), ("act_batch", None, None)))(probs)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    tok = placements_for((dp_axes, None, None), mesh)
    part_tp = tuple(Partial() if a in ctx.tp else pl for a, pl in
                    zip(mesh.mesh_dim_names, tok))

    def local(t, spec, grad=None):
        pl = placements_for(spec, mesh)
        d_t = (t.redistribute(mesh, pl) if isinstance(t, DTensor)
               else DTensor.from_local(t, mesh, pl, run_check=False))
        return d_t.to_local(grad_placements=grad)

    xg_l = local(xg, (dp_axes, None, None), part_tp)[0]
    eidx_l = local(eidx, (dp_axes, None, None))[0]
    gate_l = local(gate_vals, (dp_axes, None, None), part_tp)[0]
    wg_l = local(p["w_gate"], (tp_axes, dp_axes, None))
    wu_l = local(p["w_up"], (tp_axes, dp_axes, None))
    wd_l = local(p["w_down"], (tp_axes, None, dp_axes))
    tp_rank = mesh.get_local_rank(ctx.tp[0]) if len(ctx.tp) == 1 else \
        C.axes_group(mesh, ctx.tp).rank()
    out_l = _shardmap_ffn(cfg, xg_l, eidx_l, gate_l, wg_l, wu_l, wd_l,
                          E_loc, Cg, tp_rank * E_loc,
                          C.axes_group(mesh, ctx.dp),
                          C.axes_group(mesh, ctx.tp))
    out = DTensor.from_local(out_l[None], mesh, tok, run_check=False)
    # placed after the reshape, so its gradient comes back in the
    # groups' layout before the reshape's backward
    out = constrain(out.reshape(B, S, d), ("act_batch", None, None), ctx)
    if m.num_shared:
        out = out + L.apply_mlp(p["shared"], cfg, x, ctx)
    aux = _aux(cfg, logits, probs, eidx, torch.ones((), dtype=torch.bool,
                                                    device=x.device), T, ctx)
    aux["moe_drop_fraction"] = torch.zeros((), dtype=torch.float32,
                                           device=x.device)
    return out, aux


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

    xg = constrain(constrain(x, ("act_batch", None, None), ctx
                             ).reshape(G, Tg, d),
                   ("act_batch", None, None), ctx)
    logits = torch.einsum("gtd,de->gte", xg, p["router"]).float()
    buf, e_idx, rank_c, st, sg, keep, probs, flat_e = _route(
        xg, logits, E, K, capacity(Tg, cfg), ctx)
    buf = constrain(buf, ("act_batch", "act_experts", None, None), ctx)
    out_buf = constrain(_expert_ffn(p, cfg, buf),
                        ("act_batch", "act_experts", None, None), ctx)
    out = _combine_on(ctx, out_buf, e_idx, rank_c, st, sg, keep, Tg)
    out = constrain(constrain(out, ("act_batch", None, None), ctx
                              ).reshape(B, S, d),
                    ("act_batch", None, None), ctx)
    if m.num_shared:
        out = out + L.apply_mlp(p["shared"], cfg, x, ctx)
    return out, _aux(cfg, logits, probs, flat_e, keep, T, ctx)
