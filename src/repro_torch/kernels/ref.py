"""Plain PyTorch versions of the kernels: the oracles they are held to.

Semantics contract (shared by kernel, oracle, and the engine):
empty segments hold the combine identity (+inf for min, 0 for sum).
"""
from __future__ import annotations

import math

import numpy as np
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


# --------------------------------------------------------------------------
# order models: the kernels' combine order, one float32 operation at a
# time (numpy), so that a kernel's sums can be held to it bit for bit
# --------------------------------------------------------------------------

NWARP = 8          # warps a thread block (csrc/frr_common.cuh)
WINDOW = 256       # chunk positions a laned fold window (csrc/frr_lanes.cuh)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def piece_walk(edge_src, edge_mask, edge_dst, gchg, num_segments: int,
               cells: int):
    """The cells a piece launch runs on the chunk frontier bits (K1, K3,
    K5, K7), built with numpy from the edges alone: for each segment
    block, its planned cells (the chunks, ascending, whose valid-edge id
    range meets it) cut into pieces of at most ``cells``, and for each
    planned cell its chunk, whether it runs (its chunk holds a valid
    edge with a source in the frontier, OR'd across lanes for a (V, Q)
    one) and its batch range (the 32-edge batches holding a valid edge
    of its block, (0, 0) for none).  Returns a list over blocks of lists
    of pieces, each a list of (chunk, runs, batch_lo, batch_hi)."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    src, mask, ids = _np(edge_src), _np(edge_mask).astype(bool), \
        _np(edge_dst).astype(np.int64)
    chg = _np(gchg)
    chg = chg.any(axis=1) if chg.ndim == 2 else chg.astype(bool)
    e = ids.shape[0]
    n_chunks = max(-(-e // EBLK), 1)
    n_blk = max(-(-num_segments // SBLK), 1)
    planned = [[] for _ in range(n_blk)]
    for j in range(n_chunks):
        sl = slice(j * EBLK, min((j + 1) * EBLK, e))
        valid = mask[sl]
        if not valid.any():
            continue
        blocks = ids[sl] // SBLK
        live = bool((valid & chg[src[sl]]).any())
        pos = np.nonzero(valid)[0]
        for i in range(int(ids[sl][valid].min()) // SBLK,
                       min(int(ids[sl][valid].max()) // SBLK, n_blk - 1) + 1):
            b = pos[blocks[pos] == i] // 32
            lo, hi = (int(b.min()), int(b.max()) + 1) if b.size else (0, 0)
            planned[i].append((j, live, lo, hi))
    return [[cl[k:k + cells] for k in range(0, len(cl), cells)] or [[]]
            for cl in planned]


def _combine_np(kind):
    return np.minimum if kind == "min" else np.add


def _finish_pieces(rows, combine):
    """A block's inbox rows from its pieces' partials, in piece order."""
    r = rows[0]
    for x in rows[1:]:
        r = combine(r, x)
    return r


def fused_relax_reduce_order(gval, gchg, edge_src, edge_w, edge_mask,
                             edge_dst, num_segments: int, relax_kind: str,
                             kind: str, cells: int):
    """Order model of K1 (and of K2 and K5 on K1's cells): the inbox
    partial with every combine in the kernel's order, in float32.  Per
    piece (``piece_walk`` at ``cells``), NWARP accumulators of SBLK;
    each run cell's batches b in order, batch b on warp b % NWARP; in a
    batch the messages of one segment folded in lane order, then into
    the warp's accumulator; a piece's segment the warps folded in warp
    order; a split block's pieces folded in piece order.  Returns
    ((num_segments,) float32 array, executed cells)."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    ident = np.float32(math.inf if kind == "min" else 0.0)
    comb = _combine_np(kind)
    src, w, mask, ids = (_np(edge_src).astype(np.int64),
                         _np(edge_w).astype(np.float32),
                         _np(edge_mask).astype(bool),
                         _np(edge_dst).astype(np.int64))
    gval_m = np.where(_np(gchg).astype(bool), _np(gval).astype(np.float32),
                      ident).astype(np.float32)
    e = ids.shape[0]
    out = np.full(max(-(-num_segments // SBLK), 1) * SBLK, ident,
                  dtype=np.float32)
    executed = 0
    for i, pieces in enumerate(piece_walk(src, mask, ids, gchg,
                                          num_segments, cells)):
        rows = []
        for piece in pieces:
            acc = np.full((NWARP, SBLK), ident, dtype=np.float32)
            for j, live, b_lo, b_hi in piece:
                executed += live
                if not live:
                    continue
                for b in range(b_lo, b_hi):
                    warp = b % NWARP
                    groups = {}                     # first lane's order
                    for lane in range(32):
                        k = j * EBLK + b * 32 + lane
                        if k >= e or not mask[k]:
                            continue
                        local = ids[k] - i * SBLK
                        if not 0 <= local < SBLK:
                            continue
                        v = gval_m[src[k]]
                        m = (v + np.float32(1.0) if relax_kind == "add_one"
                             else v + w[k] if relax_kind == "add_w"
                             else v * w[k])
                        groups[local] = m if local not in groups \
                            else comb(groups[local], m)
                    for local, r in groups.items():
                        acc[warp, local] = comb(acc[warp, local], r)
            r = acc[0].copy()
            for k in range(1, NWARP):
                r = comb(r, acc[k])
            rows.append(r)
        out[i * SBLK:(i + 1) * SBLK] = _finish_pieces(rows, comb)
    return out[:num_segments], executed


def fused_relax_reduce_lanes_order(gval, gchg, lane_unitw, edge_src, edge_w,
                                   edge_mask, edge_dst, num_segments: int,
                                   relax_kind: str, kind: str, cells: int,
                                   halves: int):
    """Order model of K3 (and of K4, K7 and K8 on K3's cells): the
    (num_segments, Q) inbox partial with every combine in the kernel's
    order, in float32.  Per piece (``piece_walk`` at ``cells``) an
    (SBLK, Q) accumulator; each run cell's batch range [k_lo, k_hi) in
    windows of WINDOW chunk positions aligned to the chunk; a window cut
    into ``halves`` * NWARP lists of consecutive positions; in a list
    each segment's messages folded in position order from the identity
    into one partial, and the partials taken into the accumulator list
    after list; a split block's pieces folded in piece order.  Returns
    ((num_segments, Q) float32 array, executed cells)."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    ident = np.float32(math.inf if kind == "min" else 0.0)
    comb = _combine_np(kind)
    src, w, mask, ids = (_np(edge_src).astype(np.int64),
                         _np(edge_w).astype(np.float32),
                         _np(edge_mask).astype(bool),
                         _np(edge_dst).astype(np.int64))
    val = _np(gval).astype(np.float32)
    gval_m = np.where(_np(gchg).astype(bool), val, ident).astype(np.float32)
    q = val.shape[1]
    unit = _np(lane_unitw).reshape(q) != 0
    e = ids.shape[0]
    lists = halves * NWARP
    length = WINDOW // lists
    out = np.full((max(-(-num_segments // SBLK), 1) * SBLK, q), ident,
                  dtype=np.float32)
    executed = 0
    for i, pieces in enumerate(piece_walk(src, mask, ids, gchg,
                                          num_segments, cells)):
        rows = []
        for piece in pieces:
            acc = np.full((SBLK, q), ident, dtype=np.float32)
            for j, live, b_lo, b_hi in piece:
                executed += live
                k_lo, k_hi = 32 * b_lo, 32 * b_hi
                if not live or k_lo == k_hi:
                    continue
                for wb in range(k_lo - k_lo % WINDOW, k_hi, WINDOW):
                    for lst in range(lists):
                        part = {}
                        for k in range(wb + lst * length,
                                       wb + (lst + 1) * length):
                            x = j * EBLK + k
                            if not k_lo <= k < k_hi or x >= e \
                                    or not mask[x]:
                                continue
                            local = ids[x] - i * SBLK
                            if not 0 <= local < SBLK:
                                continue
                            v = gval_m[src[x]]
                            m = (v * w[x] if relax_kind == "mul_w" else
                                 v + np.where(unit, np.float32(1.0), w[x])
                                 .astype(np.float32))
                            part[local] = comb(part.get(
                                local, np.full(q, ident, np.float32)), m)
                        for local, r in part.items():
                            acc[local] = comb(acc[local], r)
            rows.append(acc)
        out[i * SBLK:(i + 1) * SBLK] = _finish_pieces(rows, comb)
    return out[:num_segments], executed
