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
    """Plain version of the worklist launch (kernel K2 and its fold).

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


def fused_relax_reduce_wl_lanes_ref(gval, gchg, lane_unitw, edge_src,
                                    edge_w, edge_mask, edge_dst, wl_i, wl_j,
                                    nlive, num_segments: int,
                                    relax_kind: str, kind: str):
    """Plain version of the laned worklist launch (kernel K4 and its
    fold): the laned oracle over the edges whose (dst block, chunk) cell
    is one of the first ``nlive`` listed cells — each listed cell folds
    exactly its chunk's edges into its block, and the partials of
    distinct cells meet only in the inbox.  Shapes as in
    ``fused_relax_reduce_lanes_ref``; ``wl_i``/``wl_j``: (l_pad,) int,
    ``nlive``: (1,) int."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    dev = gval.device
    e = edge_src.shape[0]
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
    in_cell = listed[chunk * n_i + blk]
    return fused_relax_reduce_lanes_ref(
        gval, gchg, lane_unitw, edge_src, edge_w, edge_mask & in_cell,
        edge_dst, num_segments, relax_kind, kind)


# --------------------------------------------------------------------------
# the tiled launches (K5-K8): the dense ones stage the rows a cell reads,
# the worklist ones read the table tile by tile
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


def _tile_walk(edge_src, act, num_slots: int, vblk: int):
    """The order in which the worklist tiled kernels fold a round's active
    edges,
    and their tile tables: chunks ascending, then each chunk's tiles
    ascending, then the tile's own edges in chunk order.  Returns
    ((n_active,) edge indices in that order, ``TileTables``)."""
    from repro_torch.kernels.fused_relax_reduce import (
        EBLK, _chunk_tile_tables)
    tt = _chunk_tile_tables(edge_src, act, num_slots, vblk)
    n_chunks = tt.order.shape[0]
    base = torch.arange(n_chunks, device=act.device)[:, None] * EBLK
    walk = (base + tt.order).reshape(-1)
    keep = (torch.arange(EBLK, device=act.device)[None, :]
            < tt.off[:, -1:]).reshape(-1)
    return walk[keep], tt


def _in_plan(tt, edge_src, edge_dst, wl_i, wl_j, nlive, num_segments: int,
             cell_ntiles, cell_tile):
    """(E,) bool: the edge's (chunk, dst block) cell is one of the first
    ``nlive`` listed cells and — for a host plan, whose cells list their
    own tiles — its source's tile is in that cell's list.  A device plan
    (no ``cell_tile``) lists its chunk's tiles, which hold every active
    source."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    dev = edge_src.device
    e = edge_src.shape[0]
    n_chunks = max(-(-e // EBLK), 1)
    n_i = max(-(-num_segments // SBLK), 1)
    wl_i, wl_j = wl_i.to(dev).long(), wl_j.to(dev).long()
    live = torch.arange(wl_i.shape[0], device=dev) < nlive.to(dev).long()
    key = torch.where(live, wl_j * n_i + wl_i, n_chunks * n_i)
    cell_of = torch.full((n_chunks * n_i + 1,), -1, dtype=torch.long,
                         device=dev)
    cell_of[key] = torch.arange(wl_i.shape[0], device=dev)
    cell_of[-1] = -1
    blk = torch.div(edge_dst.long(), SBLK, rounding_mode="floor") \
        .clamp(0, n_i - 1)
    c = cell_of[torch.arange(e, device=dev) // EBLK * n_i + blk]
    ok = c >= 0
    if cell_tile is None:
        return ok
    # the host plan's (cell, tile) pairs as sorted keys cell * n_tiles +
    # tile (cells ascending, tiles ascending within a cell)
    cell_tile = cell_tile.to(dev).long()
    cols = torch.arange(cell_tile.shape[1], device=dev)[None, :]
    listed = (cols < cell_ntiles.to(dev).long()[:, None]) & live[:, None]
    pairs = (torch.arange(cell_tile.shape[0], device=dev)[:, None]
             * tt.n_tiles + cell_tile)[listed]
    want = c.clamp(min=0) * tt.n_tiles + torch.div(
        edge_src.long(), tt.vblk, rounding_mode="floor")
    at = torch.searchsorted(pairs, want).clamp(max=max(pairs.shape[0] - 1,
                                                       0))
    found = pairs[at] == want if pairs.shape[0] else torch.zeros_like(ok)
    return ok & found


def _wl_copies(tt, wl_j, nlive, cell_fetch):
    """Tile copies of a worklist tiled launch: a host plan's scheduled
    fetches, or a device plan's chunk tiles for every live cell."""
    dev = tt.ntiles.device
    live = torch.arange(wl_j.shape[0], device=dev) < nlive.to(dev).long()
    if cell_fetch is not None:
        return (cell_fetch.to(dev) * live[:, None]).sum(dtype=torch.int32)
    return (tt.ntiles[wl_j.to(dev).long()] * live).sum(dtype=torch.int32)


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
                                    kind: str, vblk: int, cell_ntiles=None,
                                    cell_tile=None, cell_fetch=None):
    """Plain version of the worklist tiled launch (kernel K6 and K2's
    fold): the active edges of the plan's first ``nlive`` cells whose
    tile the cell lists, folded in the order K6 walks them, and the
    plan's tile copies.  A host plan passes its ``cell_*`` tables; a
    device plan none.  Returns ((num_segments,) partial, int32
    copies)."""
    act = edge_mask & gchg[edge_src.long()]
    walk, tt = _tile_walk(edge_src, act, gval.shape[0], vblk)
    walk = walk[_in_plan(tt, edge_src, edge_dst, wl_i, wl_j, nlive,
                         num_segments, cell_ntiles, cell_tile)[walk]]
    src = edge_src.long()[walk]
    msg = RELAX_FNS[relax_kind](gval[src], edge_w[walk])
    return (segment_combine_ref(msg, edge_dst[walk], num_segments, kind),
            _wl_copies(tt, wl_j, nlive, cell_fetch))


def _tiled_lanes(gval, gchg, lane_unitw, edge_src, edge_w, edge_dst, walk,
                 num_segments: int, relax_kind: str, kind: str):
    msg = _lane_messages(gval, gchg, lane_unitw, edge_src[walk],
                         edge_w[walk], torch.ones_like(walk, dtype=torch.bool),
                         relax_kind, kind)
    return _lane_combine(msg, edge_dst[walk], num_segments, kind)


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
                                          relax_kind: str, kind: str,
                                          vblk: int, cell_ntiles=None,
                                          cell_tile=None, cell_fetch=None):
    """Plain version of the laned worklist tiled launch (kernel K8 and
    K4's fold), as ``fused_relax_reduce_wl_tiled_ref`` over the
    OR-across-lanes frontier.  Returns ((num_segments, Q) partial, int32
    copies)."""
    act = edge_mask & gchg.any(dim=1)[edge_src.long()]
    walk, tt = _tile_walk(edge_src, act, gval.shape[0], vblk)
    walk = walk[_in_plan(tt, edge_src, edge_dst, wl_i, wl_j, nlive,
                         num_segments, cell_ntiles, cell_tile)[walk]]
    return (_tiled_lanes(gval, gchg, lane_unitw, edge_src, edge_w, edge_dst,
                         walk, num_segments, relax_kind, kind),
            _wl_copies(tt, wl_j, nlive, cell_fetch))
