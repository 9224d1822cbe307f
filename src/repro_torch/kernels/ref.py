"""Plain PyTorch versions of the kernels: the oracles they are held to.

Semantics contract (shared by kernel, oracle, and the engine):
empty segments hold the combine identity (+inf for min, 0 for sum).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.actions import RELAX_FNS


def segment_combine_ref(data, segment_ids, num_segments: int, kind: str):
    """Semiring segment reduction: the inbox partial-reduce of one shard.

    data: (E,) float; segment_ids: (E,) int in [0, num_segments);
    returns (num_segments,) float.
    """
    if kind == "min":
        init = torch.full((num_segments,), math.inf, dtype=data.dtype,
                          device=data.device)
        reduce = "amin"
    elif kind == "sum":
        init = torch.zeros((num_segments,), dtype=data.dtype,
                           device=data.device)
        reduce = "sum"
    else:
        raise ValueError(kind)
    return init.scatter_reduce_(0, segment_ids.long(), data, reduce,
                                include_self=True)


def fused_relax_reduce_ref(gval, gchg, edge_src, edge_w, edge_mask,
                           edge_dst, num_segments: int, relax_kind: str,
                           kind: str):
    """Oracle for the fused frontier relax+reduce kernel: the unfused
    gather / relax / frontier-mask / segment-combine pipeline, with every
    intermediate materialized.  Shapes as in
    ``fused_relax_reduce.fused_relax_reduce``."""
    src = edge_src.long()
    src_val = gval[src]
    active = edge_mask & gchg[src]
    msg = RELAX_FNS[relax_kind](src_val, edge_w)
    identity = math.inf if kind == "min" else 0.0
    msg = torch.where(active, msg, torch.tensor(identity, dtype=msg.dtype,
                                                device=msg.device))
    return segment_combine_ref(msg, edge_dst, num_segments, kind)


def fused_relax_reduce_wl_ref(gval, gchg, edge_src, edge_w, edge_mask,
                              edge_dst, wl_i, wl_j, nlive,
                              num_segments: int, relax_kind: str, kind: str):
    """Plain version of the worklist launch (kernel K2).

    Cell ``c < nlive`` works edge chunk ``wl_j[c]`` against segment block
    ``wl_i[c]``: its (SBLK,) partial combines the chunk's active edges
    whose destination lies in the block.  Dead and pad cells hold the
    identity, so folding every row into the inbox by ``wl_i`` (the
    reference's ``_scatter_partials``) is exact.  Shapes as in
    ``fused_relax_reduce.fused_relax_reduce``; ``wl_i``/``wl_j``:
    (l_pad,) int, ``nlive``: (1,) int."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    identity = math.inf if kind == "min" else 0.0
    reduce = "amin" if kind == "min" else "sum"
    dev = gval.device
    e = edge_src.shape[0]
    n_chunks = max(-(-e // EBLK), 1)

    def chunks(x, fill):
        out = torch.full((n_chunks * EBLK,), fill, dtype=x.dtype, device=dev)
        out[:e] = x
        return out.view(n_chunks, EBLK)[wl_j.long()]     # (l_pad, EBLK)

    src = chunks(edge_src.long(), 0)
    local = chunks(edge_dst.long(), 0) - wl_i.long()[:, None] * SBLK
    cell = torch.arange(wl_i.shape[0], device=dev)[:, None]
    hit = (chunks(edge_mask, False) & gchg[src] & (local >= 0)
           & (local < SBLK) & (cell < nlive.to(dev).long()))
    msg = torch.where(hit, RELAX_FNS[relax_kind](gval[src],
                                                 chunks(edge_w, 0.0)),
                      identity)
    partials = torch.full((wl_i.shape[0], SBLK + 1), identity,
                          dtype=gval.dtype, device=dev)
    partials.scatter_reduce_(1, torch.where(hit, local, SBLK), msg, reduce,
                             include_self=True)
    n_i = max(-(-num_segments // SBLK), 1)
    inbox = torch.full((n_i, SBLK), identity, dtype=gval.dtype, device=dev)
    rows = wl_i.long()[:, None].expand(-1, SBLK)
    inbox.scatter_reduce_(0, rows, partials[:, :SBLK], reduce,
                          include_self=True)
    return inbox.reshape(-1)[:num_segments]


def _lane_messages(gval, gchg, lane_unitw, edge_src, edge_w, edge_mask,
                   relax_kind: str, kind: str):
    """(E, Q) relaxed, frontier-masked messages of the laned oracle."""
    src = edge_src.long()
    src_val = gval[src]                                    # (E, Q)
    active = edge_mask[:, None] & gchg[src]
    if relax_kind == "add_w":
        unit = torch.as_tensor(lane_unitw, device=gval.device)[None, :] != 0
        msg = src_val + torch.where(unit, 1.0, edge_w[:, None])
    elif relax_kind == "mul_w":
        msg = src_val * edge_w[:, None]
    else:
        raise ValueError(relax_kind)
    identity = math.inf if kind == "min" else 0.0
    return torch.where(active, msg, identity)


def _lane_combine(msg, edge_dst, num_segments: int, kind: str):
    """(num_segments, Q) semiring segment reduction of (E, Q) messages."""
    identity = math.inf if kind == "min" else 0.0
    reduce = {"min": "amin", "sum": "sum"}[kind]
    init = torch.full((num_segments, msg.shape[1]), identity,
                      dtype=msg.dtype, device=msg.device)
    idx = edge_dst.long()[:, None].expand(-1, msg.shape[1])
    return init.scatter_reduce_(0, idx, msg, reduce, include_self=True)


def fused_relax_reduce_lanes_ref(gval, gchg, lane_unitw, edge_src, edge_w,
                                 edge_mask, edge_dst, num_segments: int,
                                 relax_kind: str, kind: str):
    """Oracle for the lane-batched fused kernel (K3): per-lane gather /
    relax / frontier-mask / segment-combine with every (E, Q) intermediate
    materialized.  ``gval``/``gchg``: (V, Q); ``lane_unitw`` (Q,) swaps
    the edge weight for 1.0 per lane under 'add_w' (BFS lanes inside an
    SSSP launch).  Returns (num_segments, Q)."""
    msg = _lane_messages(gval, gchg, lane_unitw, edge_src, edge_w,
                         edge_mask, relax_kind, kind)
    return _lane_combine(msg, edge_dst, num_segments, kind)


def _listed_edges(edge_dst, wl_i, wl_j, nlive, num_segments: int):
    """(E,) bool: the edge's (chunk, dst block) cell is one of the first
    ``nlive`` listed cells (a worklist lists a cell at most once)."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    dev = edge_dst.device
    e = edge_dst.shape[0]
    n_chunks = max(-(-e // EBLK), 1)
    n_i = max(-(-num_segments // SBLK), 1)
    cells = torch.arange(wl_i.shape[0], device=dev)
    key = torch.where(cells < nlive.to(dev).long(),
                      wl_j.to(dev).long() * n_i + wl_i.to(dev).long(),
                      n_chunks * n_i)
    listed = torch.zeros(n_chunks * n_i + 1, dtype=torch.bool, device=dev)
    listed[key] = True
    blk = torch.div(edge_dst.long(), SBLK, rounding_mode="floor") \
        .clamp(0, n_i - 1)
    chunk = torch.arange(e, device=dev) // EBLK
    return listed[chunk * n_i + blk]


def fused_relax_reduce_wl_lanes_ref(gval, gchg, lane_unitw, edge_src,
                                    edge_w, edge_mask, edge_dst, wl_i, wl_j,
                                    nlive, num_segments: int,
                                    relax_kind: str, kind: str):
    """Plain version of the laned worklist launch (kernel K4): the laned
    oracle over the edges whose (dst block, chunk) cell is one of the
    first ``nlive`` listed cells — each listed cell folds exactly its
    chunk's edges into its block, and distinct cells meet only in the
    inbox.  Shapes as in
    ``fused_relax_reduce_lanes_ref``; ``wl_i``/``wl_j``: (l_pad,) int,
    ``nlive``: (1,) int."""
    in_cell = _listed_edges(edge_dst, wl_i, wl_j, nlive, num_segments)
    return fused_relax_reduce_lanes_ref(
        gval, gchg, lane_unitw, edge_src, edge_w, edge_mask & in_cell,
        edge_dst, num_segments, relax_kind, kind)


# --------------------------------------------------------------------------
# the tiled launches (K5-K8): each live cell stages the rows it reads and
# folds them as its pinned twin (K1-K4) does
# --------------------------------------------------------------------------

def _staged_rows(plan, act, edge_dst):
    """Rows a dense tiled launch (K5, K7) stages: a row per active edge
    (``act``) whose (chunk, dst block) cell the plan lists — every live
    cell stages its own active edges.  Returns an int32 scalar."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    dev = act.device
    n_i = plan.num_blocks
    keys = plan.cell_j.to(dev).long() * n_i + plan.cell_i.to(dev).long()
    if keys.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=dev)
    e = torch.nonzero(act).view(-1)
    want = e // EBLK * n_i + torch.div(edge_dst.long()[e], SBLK,
                                       rounding_mode="floor")
    at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
    return (keys[at] == want).sum(dtype=torch.int32)


def _wl_staged_rows(act, edge_dst, wl_i, wl_j, nlive, num_segments: int):
    """Rows a worklist tiled launch (K6, K8) stages: a row per active
    edge (``act``) whose (chunk, dst block) cell is one of the plan's
    first ``nlive`` cells.  Returns an int32 scalar."""
    return (act & _listed_edges(edge_dst, wl_i, wl_j, nlive, num_segments)
            ).sum(dtype=torch.int32)


def fused_relax_reduce_tiled_ref(gval, gchg, edge_src, edge_w, edge_mask,
                                 edge_dst, num_segments: int,
                                 relax_kind: str, kind: str, plan):
    """Plain version of the dense tiled launch (kernel K5), which stages
    the rows its cells read and folds them in K1's order: the oracle
    ``fused_relax_reduce_ref`` (min bit-equal to the kernel, sum up to
    reassociation) and K5's staged-row count (``_staged_rows``).  Returns
    ((num_segments,) partial, int32 rows).  ``plan`` is the edges'
    ``LaunchPlan``."""
    act = edge_mask & gchg[edge_src.long()]
    return (fused_relax_reduce_ref(gval, gchg, edge_src, edge_w, edge_mask,
                                   edge_dst, num_segments, relax_kind, kind),
            _staged_rows(plan, act, edge_dst))


def fused_relax_reduce_wl_tiled_ref(gval, gchg, edge_src, edge_w, edge_mask,
                                    edge_dst, wl_i, wl_j, nlive,
                                    num_segments: int, relax_kind: str,
                                    kind: str):
    """Plain version of the worklist tiled launch (kernel K6), which
    stages the rows its cells read and folds them in K2's order: K2's plain version ``fused_relax_reduce_wl_ref`` and K6's
    staged-row count over the plan's first ``nlive`` cells
    (``_wl_staged_rows``).  Returns ((num_segments,) partial, int32
    rows)."""
    act = edge_mask & gchg[edge_src.long()]
    return (fused_relax_reduce_wl_ref(gval, gchg, edge_src, edge_w,
                                      edge_mask, edge_dst, wl_i, wl_j,
                                      nlive, num_segments, relax_kind, kind),
            _wl_staged_rows(act, edge_dst, wl_i, wl_j, nlive, num_segments))


def fused_relax_reduce_tiled_lanes_ref(gval, gchg, lane_unitw, edge_src,
                                       edge_w, edge_mask, edge_dst,
                                       num_segments: int, relax_kind: str,
                                       kind: str, plan):
    """Plain version of the laned dense tiled launch (kernel K7), which
    stages the rows of edges active in some lane and folds them in K3's
    order: the laned oracle ``fused_relax_reduce_lanes_ref`` and K7's
    staged-row count over the OR-across-lanes frontier.  Returns
    ((num_segments, Q) partial, int32 rows)."""
    act = edge_mask & gchg.any(dim=1)[edge_src.long()]
    return (fused_relax_reduce_lanes_ref(gval, gchg, lane_unitw, edge_src,
                                         edge_w, edge_mask, edge_dst,
                                         num_segments, relax_kind, kind),
            _staged_rows(plan, act, edge_dst))


def fused_relax_reduce_wl_tiled_lanes_ref(gval, gchg, lane_unitw, edge_src,
                                          edge_w, edge_mask, edge_dst, wl_i,
                                          wl_j, nlive, num_segments: int,
                                          relax_kind: str, kind: str):
    """Plain version of the laned worklist tiled launch (kernel K8): K4's
    plain version ``fused_relax_reduce_wl_lanes_ref``
    and K8's staged-row count over the OR-across-lanes frontier.  Returns
    ((num_segments, Q) partial, int32 rows)."""
    act = edge_mask & gchg.any(dim=1)[edge_src.long()]
    return (fused_relax_reduce_wl_lanes_ref(gval, gchg, lane_unitw, edge_src,
                                            edge_w, edge_mask, edge_dst,
                                            wl_i, wl_j, nlive, num_segments,
                                            relax_kind, kind),
            _wl_staged_rows(act, edge_dst, wl_i, wl_j, nlive, num_segments))
