"""Lane-generic relax / exchange / collapse primitives.

Every function here accepts value and frontier tables either **unlaned**
(``(V,)`` — one query) or **laned** (``(V, Q)`` — a trailing query-lane
axis, one column per concurrent query) and picks the matching kernel or
torch form from the rank, so the round compositions in
``exchange.rounds`` are written once.  The compact exchange is ROADMAP
Queue 1 item 4.

The arrays argument is duck-typed against ``core.engine.DeviceArrays``
(the static per-shard partition tables); ``cfg`` against
``core.engine.EngineConfig`` — this module must not import ``core.engine``
(the engine imports *us*).
"""
from __future__ import annotations

import torch

from repro_torch.core.actions import Semiring


def reduce_axis0(sem: Semiring, x):
    """Semiring reduction over axis 0 (trailing axes — incl. Q — ride)."""
    return x.amin(dim=0) if sem.segment == "min" else x.sum(dim=0)


def check_ported(cfg):
    """Raise ``NotImplementedError`` for a config whose path the port
    does not have yet, naming the ROADMAP item that brings it."""
    if cfg.exchange == "compact":
        raise NotImplementedError(
            "exchange='compact' is not ported yet (ROADMAP Queue 1 item 4)")


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
    check_ported(cfg)
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


# --------------------------------------------------------------------------
# rhizome collapse
# --------------------------------------------------------------------------

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
