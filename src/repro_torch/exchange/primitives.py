"""Lane-generic relax / exchange / collapse primitives.

Every function here accepts value and frontier tables either **unlaned**
(``(V,)`` — one query) or **laned** (``(V, Q)`` — a trailing query-lane
axis, one column per concurrent query) and picks the matching kernel or
torch form from the rank, so the round compositions in
``exchange.rounds`` are written once.  The inter-shard exchange is the
dense global inbox or the compact targeted one (``cfg.exchange``).

The arrays argument is duck-typed against ``core.engine.DeviceArrays``
(the static per-shard partition tables); ``cfg`` against
``core.engine.EngineConfig`` — this module must not import ``core.engine``
(the engine imports *us*).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.actions import Semiring


def reduce_axis0(sem: Semiring, x):
    """Semiring reduction over axis 0 (trailing axes — incl. Q — ride)."""
    return x.amin(dim=0) if sem.segment == "min" else x.sum(dim=0)


# --------------------------------------------------------------------------
# relax phase: gather frontier sources, build messages, partial-reduce
# --------------------------------------------------------------------------

def relax(sem: Semiring, cfg, edge_src, edge_w, edge_mask, ids, gval, gchg,
          num_segments: int, lane_unitw=None, plan=None, worklist=None):
    """Relax phase over one edge set (flattened internally).

    ``gval``/``gchg``: (V,) or (V, Q).  Returns ((num_segments[, Q])
    partial, message count — a scalar unlaned, (Q,) per lane laned).
    Laned 'add_w' honours ``lane_unitw``: lanes with a nonzero flag relax
    with the constant weight 1.0 (BFS levels inside an SSSP launch).

    With ``cfg.use_pallas`` and ``pallas_mode='fused'`` the phase runs
    through the fused kernels (``plan`` is the dense launch plan for these
    edges): ``worklist`` — a host-planned live-cell list — selects the
    worklist launch, and so does ``cfg.grid_mode='device_worklist'`` with
    no plan given, which compacts the list on the device; otherwise the
    dense launch runs.  ``cfg.vmem_budget_bytes`` and
    ``cfg.smem_budget_bytes`` decide the value table's residency (pinned
    or tiled kernels), as ``core.engine.launch_planner`` decides it for
    the plans.  ``pallas_mode='reduce'`` (unlaned only) relaxes
    with torch ops and reduces with the segment-reduce kernel K9.
    Without ``use_pallas`` the phase runs as separate torch ops — the
    oracle path, which has no grid to sparsify.
    """
    laned = gval.dim() == 2
    src = edge_src.reshape(-1)
    idsf = ids.reshape(-1)
    w = edge_w.reshape(-1)
    mask = edge_mask.reshape(-1)
    # only the device mode is forwarded: host modes ('worklist', 'auto')
    # arrive as a planned worklist= or keep the dense launch
    grid_mode = ("device_worklist" if worklist is None
                 and cfg.grid_mode == "device_worklist" else "dense")
    fused = cfg.use_pallas and cfg.pallas_mode == "fused"
    from repro_torch.kernels import ops as kops

    if not laned:
        if fused:
            if sem.relax_kind is None:
                raise ValueError(
                    f"semiring {sem.name!r} has no kernel relax form "
                    "(relax_kind=None); construct it from actions.RELAX_FNS "
                    "or run with use_pallas=False")
            partial, count = kops.fused_relax_reduce(
                gval, gchg, src, w, mask, idsf, num_segments,
                relax_kind=sem.relax_kind, kind=sem.segment, plan=plan,
                worklist=worklist, grid_mode=grid_mode,
                vmem_budget_bytes=cfg.vmem_budget_bytes,
                smem_budget_bytes=cfg.smem_budget_bytes)
            if not cfg.track_stats:
                count = torch.zeros((), dtype=count.dtype,
                                    device=count.device)
            return partial, count
        srcl = src.long()
        active = mask & gchg[srcl]
        msg = torch.where(active, sem.relax(gval[srcl], w), sem.identity)
        if cfg.use_pallas:   # 'reduce': torch relax ops + the K9 reduce
            partial = kops.segment_combine(msg, idsf, num_segments,
                                           sem.segment, plan=plan)
        else:
            partial = sem.segment_combine(msg, idsf, num_segments)
        count = (active.sum() if cfg.track_stats
                 else torch.zeros((), dtype=torch.int64, device=gval.device))
        return partial, count

    # --- laned: (V, Q) tables over one shared edge set ---
    q = gval.shape[-1]
    if sem.relax_kind not in ("add_w", "mul_w"):
        raise ValueError(
            f"laned relax supports relax_kind 'add_w'|'mul_w', got "
            f"{sem.relax_kind!r} (express BFS lanes with lane_unitw=1)")
    unitw = (torch.zeros(q, dtype=torch.int32, device=gval.device)
             if lane_unitw is None else lane_unitw)
    if cfg.use_pallas:
        if not fused:
            raise ValueError(
                "laned Pallas execution is fused-only (the pre-fusion "
                "'reduce' composition has no laned form)")
        partial, counts = kops.fused_relax_reduce_lanes(
            gval, gchg, unitw, src, w, mask, idsf, num_segments,
            relax_kind=sem.relax_kind, kind=sem.segment, plan=plan,
            worklist=worklist, grid_mode=grid_mode,
            vmem_budget_bytes=cfg.vmem_budget_bytes,
            smem_budget_bytes=cfg.smem_budget_bytes)
        if not cfg.track_stats:
            counts = torch.zeros(q, dtype=torch.int32, device=gval.device)
        return partial, counts
    from repro_torch.kernels.ref import _lane_combine, _lane_messages
    msg = _lane_messages(gval, gchg, unitw, src, w, mask, sem.relax_kind,
                         sem.segment)
    partial = _lane_combine(msg, idsf, num_segments, sem.segment)
    counts = ((mask[:, None] & gchg[src.long()]).sum(dim=0,
                                                    dtype=torch.int32)
              if cfg.track_stats
              else torch.zeros(q, dtype=torch.int32, device=gval.device))
    return partial, counts


# --------------------------------------------------------------------------
# stacked relax composition (all shards resident on one device)
# --------------------------------------------------------------------------

def stacked_dense_inbox(sem: Semiring, arrays, cfg, gval, gchg, total: int,
                        lane_unitw=None, worklist=None):
    """Stacked dense relax: the reduced (total[, Q]) global inbox + count.

    Kernel paths: all shards' edges address the same global slot space,
    so the whole stack collapses in ONE launch — the fused kernel (dense
    or worklist), or under ``pallas_mode='reduce'`` the segment reduce
    over the flattened stack (``arrays.fused_plan`` excludes the masked
    edges, whose messages are the identity).  Plain path: one
    (S, total[, Q]) partial per source shard, then the axis-0 reduce —
    the reference's per-shard composition."""
    if cfg.use_pallas:
        return relax(sem, cfg, arrays.edge_src_root_flat, arrays.edge_w,
                     arrays.edge_mask, arrays.edge_dst_flat, gval, gchg,
                     total, lane_unitw, plan=arrays.fused_plan,
                     worklist=worklist)
    S = arrays.edge_dst_flat.shape[0]
    offs = (torch.arange(S, device=gval.device) * total)[:, None]
    partial, count = relax(sem, cfg, arrays.edge_src_root_flat,
                           arrays.edge_w, arrays.edge_mask,
                           arrays.edge_dst_flat.long() + offs, gval, gchg,
                           S * total, lane_unitw)
    return reduce_axis0(sem, partial.view((S, total) + partial.shape[1:])), \
        count


def stacked_compact_partial(sem: Semiring, arrays, cfg, S: int, P_t: int,
                            gval, gchg, lane_unitw=None, worklist=None):
    """Stacked compact relax: (S_src, S_tgt, P_t[, Q]) partials + count.

    Source shards get disjoint id windows of width S*P_t
    (``arrays.compact.ids``), so one relax over the flattened edge stack
    yields every per-source partial (a compact slot's meaning depends on
    its source shard: contributions must not merge across sources).  The
    kernel paths launch on the compact plan (``arrays.compact.plan``),
    never the dense ``fused_plan``; ``worklist`` is planned on the same
    offset ids (``core.engine.launch_planner``)."""
    plan = arrays.compact.plan if cfg.use_pallas else None
    flat, count = relax(sem, cfg, arrays.edge_src_root_flat, arrays.edge_w,
                        arrays.edge_mask, arrays.compact.ids, gval, gchg,
                        S * S * P_t, lane_unitw, plan=plan,
                        worklist=worklist)
    return flat.reshape((S, S, P_t) + tuple(flat.shape[1:])), count


# --------------------------------------------------------------------------
# inbox scatter + rhizome collapse
# --------------------------------------------------------------------------

def inbox_index(slot_map_t, R_max: int):
    """Where ``scatter_inbox`` puts each contribution: (S_src, n_tgt *
    P_t) int64 rows of the (n_tgt * (R_max + 1)) flat inbox with its pad
    column, source-major, for a slot map ((..., S_src, P_t), R_max =
    pad).  A partition's map is static, so the engine makes this once
    (``DeviceArrays.compact.inbox_index``)."""
    n_src, p_t = slot_map_t.shape[-2:]
    n_tgt = math.prod(slot_map_t.shape[:-2])
    base = torch.arange(n_tgt, device=slot_map_t.device)[:, None, None] \
        * (R_max + 1)
    return (slot_map_t.reshape(n_tgt, n_src, p_t).long() + base) \
        .transpose(0, 1).reshape(n_src, n_tgt * p_t)


def scatter_inbox(sem: Semiring, recv_t, slot_map_t, R_max: int,
                  index=None):
    """``recv_t``: (..., S_src, P_t[, Q]) contributions to a target's
    slots; ``slot_map_t``: (..., S_src, P_t) their local slots (R_max =
    pad).  Scatter-combine into (..., R_max[, Q]); leading dims are
    targets, each combined apart.

    A sum adds one scatter a source, in source order, from the identity,
    as the reference's scatter meets them: a (target, source) pair's
    slots are distinct but for the pad, so no scatter meets a slot twice
    and the sum repeats bit for bit from run to run, with no two float
    atomics on one slot.  A min, which no order changes, is one scatter.
    Pad entries land on a column that is sliced off.  ``index`` is
    ``inbox_index(slot_map_t, R_max)``, made here when absent.  A
    source-major stack handed as ``partial.transpose(0, 1)`` is read in
    place."""
    lead = tuple(slot_map_t.shape[:-2])
    n_src, p_t = slot_map_t.shape[-2:]
    tail = tuple(recv_t.shape[slot_map_t.dim():])
    n_tgt = math.prod(lead)
    if index is None:
        index = inbox_index(slot_map_t, R_max)
    recv = recv_t.reshape((n_tgt, n_src, p_t) + tail)
    out = torch.full((n_tgt * (R_max + 1),) + tail, sem.identity,
                     dtype=recv_t.dtype, device=recv_t.device)
    if sem.segment == "min":            # order-free: one scatter
        rows = recv.transpose(0, 1).reshape((-1,) + tail)
        at = index.reshape((-1,) + (1,) * len(tail)).expand(rows.shape)
        out.scatter_reduce_(0, at, rows, "amin")
    else:
        for s in range(n_src):
            out.index_add_(0, index[s],
                           recv[:, s].reshape((n_tgt * p_t,) + tail))
    out = out.view((n_tgt, R_max + 1) + tail)[:, :R_max]
    return out.reshape(lead + (R_max,) + tail)


def collapse(sem: Semiring, gx, sibling_flat, sibling_mask):
    """Rhizome collapse: AND-gate over all replicas of each slot's vertex.

    ``gx``: (V,) or (V, Q) gathered table; sibling tables index its
    leading axis (the lane axis rides along).  Returns the
    sibling-combined table shaped like ``sibling_flat`` without its last
    (K) axis (+ Q)."""
    laned = gx.dim() == 2
    sib = gx[sibling_flat.long()]                  # (..., K[, Q])
    mask = sibling_mask[..., None] if laned else sibling_mask
    sib = torch.where(mask, sib, sem.identity)
    dim = -2 if laned else -1
    return sib.amin(dim=dim) if sem.segment == "min" else sib.sum(dim=dim)


def compact_collapse(sem: Semiring, cand, rz_local, rz_sib_idx, rz_sib_mask,
                     gather_fn, R_max: int, R_rz_max: int):
    """Collapse only rhizome slots: gather them compactly, flatten the
    small table (``gather_fn``), combine siblings, scatter back.
    ``cand``: (..., R_max[, Q]).  Min semirings min-set (the collapsed
    value never exceeds ``cand``); sum semirings overwrite each rhizome
    slot with its siblings' total, which includes its own partial, so
    ``cand`` must be bare inbox partials (the PageRank/PPR rounds).  Pad
    entries of ``rz_local`` (= R_max) land on a column that is sliced
    off."""
    laned = cand.dim() == rz_local.dim() + 1
    axis = rz_local.dim() - 1                      # the slot axis
    pad_shape = list(cand.shape)
    pad_shape[axis] = 1
    cand_pad = torch.cat(
        [cand, torch.full(pad_shape, sem.identity, dtype=cand.dtype,
                          device=cand.device)], dim=axis)
    idx = rz_local.long()
    if laned:
        idx = idx[..., None].expand(tuple(rz_local.shape) + cand.shape[-1:])
    compact = torch.gather(cand_pad, axis, idx)    # (..., R_rz_max[, Q])
    g = gather_fn(compact)                         # (S*R_rz_max[, Q])
    sib = g[rz_sib_idx.long()]                     # (..., K[, Q])
    mask = rz_sib_mask[..., None] if laned else rz_sib_mask
    sib = torch.where(mask, sib, sem.identity)
    k_axis = -2 if laned else -1
    if sem.segment == "min":
        cand_pad.scatter_reduce_(axis, idx, sib.amin(dim=k_axis), "amin")
    else:
        cand_pad.scatter_(axis, idx, sib.sum(dim=k_axis))
    return cand_pad.narrow(axis, 0, R_max)


# --------------------------------------------------------------------------
# exchange-volume accounting
# --------------------------------------------------------------------------

def exchange_volume(S: int, R_max: int, P_t: int, cfg) -> int:
    """Entries that transit the inter-shard exchange per round, per live
    lane: every shard ships its per-target partial — (S, R_max) rows of
    the dense global inbox, or (S, P_t) targeted (target, distinct-slot)
    compact tables.  No collective runs on the stacked layout, but the
    exchanged tensors have these sizes; a converged lane is left out by
    the caller."""
    width = P_t if cfg.exchange == "compact" else R_max
    return S * S * width
