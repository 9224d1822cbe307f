"""Relax / exchange / collapse primitives over (V,) tables.

The port's slice covers the unlaned (single-query) layout: value and
frontier tables are ``(V,)`` tensors.  The laned ``(V, Q)`` layout is
ROADMAP Queue 1 item 6, the compact exchange item 4.

The arrays argument is duck-typed against ``core.engine.DeviceArrays``
(the static per-shard partition tables); ``cfg`` against
``core.engine.EngineConfig`` — this module must not import ``core.engine``
(the engine imports *us*).
"""
from __future__ import annotations

import torch

from repro_torch.core.actions import Semiring


def reduce_axis0(sem: Semiring, x):
    """Semiring reduction over axis 0 (trailing axes ride)."""
    return x.amin(dim=0) if sem.segment == "min" else x.sum(dim=0)


def check_ported(cfg):
    """Raise ``NotImplementedError`` for a config whose path the port
    does not have yet, naming the ROADMAP item that brings it."""
    if cfg.exchange == "compact":
        raise NotImplementedError(
            "exchange='compact' is not ported yet (ROADMAP Queue 1 item 4)")
    if cfg.use_pallas and cfg.pallas_mode == "reduce":
        raise NotImplementedError(
            "pallas_mode='reduce' is not ported yet (ROADMAP Queue 2, "
            "kernel K9)")


# --------------------------------------------------------------------------
# relax phase: gather frontier sources, build messages, partial-reduce
# --------------------------------------------------------------------------

def relax(sem: Semiring, cfg, edge_src, edge_w, edge_mask, ids, gval, gchg,
          num_segments: int, plan=None, worklist=None):
    """Relax phase over one edge set (flattened internally).

    ``gval``/``gchg``: (V,).  Returns ((num_segments,) partial, message
    count).  With ``cfg.use_pallas`` the phase runs through the fused
    kernels (``plan`` is the dense launch plan for these edges):
    ``worklist`` — a host-planned live-cell list — selects the worklist
    launch, and so does ``cfg.grid_mode='device_worklist'`` with no plan
    given, which compacts the list on the device; otherwise the dense
    launch runs.  Without ``use_pallas`` the phase runs as separate
    torch ops — the oracle path, which has no grid to sparsify.
    """
    if gval.dim() != 1:
        raise NotImplementedError(
            "laned (V, Q) relax is not ported yet (ROADMAP Queue 1 item 6)")
    check_ported(cfg)
    src = edge_src.reshape(-1)
    idsf = ids.reshape(-1)
    w = edge_w.reshape(-1)
    mask = edge_mask.reshape(-1)
    if cfg.use_pallas:
        if sem.relax_kind is None:
            raise ValueError(
                f"semiring {sem.name!r} has no kernel relax form "
                "(relax_kind=None); construct it from actions.RELAX_FNS "
                "or run with use_pallas=False")
        from repro_torch.kernels import ops as kops
        # only the device mode is forwarded: host modes ('worklist',
        # 'auto') arrive as a planned worklist= or keep the dense launch
        grid_mode = ("device_worklist" if worklist is None
                     and cfg.grid_mode == "device_worklist" else "dense")
        partial, count = kops.fused_relax_reduce(
            gval, gchg, src, w, mask, idsf, num_segments,
            relax_kind=sem.relax_kind, kind=sem.segment, plan=plan,
            worklist=worklist, grid_mode=grid_mode)
        if not cfg.track_stats:
            count = torch.zeros((), dtype=count.dtype, device=count.device)
        return partial, count
    srcl = src.long()
    active = mask & gchg[srcl]
    msg = torch.where(active, sem.relax(gval[srcl], w), sem.identity)
    partial = sem.segment_combine(msg, idsf, num_segments)
    count = (active.sum() if cfg.track_stats
             else torch.zeros((), dtype=torch.int64, device=gval.device))
    return partial, count


# --------------------------------------------------------------------------
# stacked relax composition (all shards resident on one device)
# --------------------------------------------------------------------------

def stacked_dense_inbox(sem: Semiring, arrays, cfg, gval, gchg, total: int,
                        worklist=None):
    """Stacked dense relax: the reduced (total,) global inbox + count.

    Fused path: all shards' edges address the same global slot space, so
    the whole stack collapses in ONE kernel launch (dense or worklist).
    Plain path: one (S, total) partial per source shard, then the axis-0
    reduce — the reference's per-shard composition."""
    if cfg.use_pallas:
        return relax(sem, cfg, arrays.edge_src_root_flat, arrays.edge_w,
                     arrays.edge_mask, arrays.edge_dst_flat, gval, gchg,
                     total, plan=arrays.fused_plan, worklist=worklist)
    S = arrays.edge_dst_flat.shape[0]
    offs = (torch.arange(S, device=gval.device) * total)[:, None]
    partial, count = relax(sem, cfg, arrays.edge_src_root_flat,
                           arrays.edge_w, arrays.edge_mask,
                           arrays.edge_dst_flat.long() + offs, gval, gchg,
                           S * total)
    return reduce_axis0(sem, partial.view(S, total)), count


# --------------------------------------------------------------------------
# rhizome collapse
# --------------------------------------------------------------------------

def collapse(sem: Semiring, gx, sibling_flat, sibling_mask):
    """Rhizome collapse: AND-gate over all replicas of each slot's vertex.

    ``gx``: (V,) gathered table; sibling tables index it.  Returns the
    sibling-combined table shaped like ``sibling_flat`` without its last
    (K) axis."""
    sib = gx[sibling_flat.long()]                  # (..., K)
    sib = torch.where(sibling_mask, sib, sem.identity)
    return sib.amin(dim=-1) if sem.segment == "min" else sib.sum(dim=-1)
