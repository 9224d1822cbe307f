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


def frontier_relax_ref(values, src_flat, weights, mask, kind: str):
    """Gather + relax: msg_e = values[src_e] (+ w_e | * w_e), masked to the
    semiring identity. values: (V,), src_flat/weights/mask: (E,)."""
    v = values[src_flat.long()]
    if kind == "min":  # min-plus relax
        msg, identity = v + weights, math.inf
    elif kind == "sum":  # plus-times relax
        msg, identity = v * weights, 0.0
    else:
        raise ValueError(kind)
    return torch.where(mask, msg, torch.tensor(identity, dtype=msg.dtype,
                                               device=msg.device))


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


UNIT = 128         # edges a K9 warp folds at once (csrc/segment_combine.cu)
SEG_NWARP = 4      # warps a K9 block (csrc/segment_combine.cu)


def _fold_groups(gid, vals, comb, ident=None):
    """Fold ``vals`` (along axis 0) within each run of equal ``gid``
    (non-decreasing), in order: from the run's first value, or from
    ``ident`` when given.  Returns (the runs' first indices, their
    folds)."""
    n = gid.shape[0]
    starts = np.flatnonzero(np.r_[True, gid[1:] != gid[:-1]]) if n \
        else np.zeros(0, np.int64)
    lens = np.diff(np.r_[starts, n])
    if ident is None:
        out, r0 = vals[starts].copy(), 1
    else:
        out, r0 = np.full((starts.shape[0],) + vals.shape[1:], ident,
                          np.float32), 0
    for r in range(r0, int(lens.max(initial=0))):
        sel = lens > r
        out[sel] = comb(out[sel], vals[starts[sel] + r])
    return starts, out


def segment_combine_order(data, segment_ids, num_segments: int, kind: str,
                          cells: int, edge_mask=None):
    """Order model of K9: the (num_segments,) segment reduce with every
    combine in the kernel's order, in float32 (numpy, vectorized over the
    kernel's units).  Per piece (``piece_walk`` at ``cells`` under
    ``edge_mask``, every cell run) SEG_NWARP accumulators of SBLK; each
    cell's batch range cut into units of UNIT edges from its first batch,
    the piece's units counted over its cells in order, unit u on warp
    u % SEG_NWARP; lane l of a unit holds its edges 4l .. 4l + 3 (those past
    the range or the edges do not count), keyed by segment in the block
    (-1 below, SBLK above).  A unit whose keys do not decrease: each
    lane's runs folded in order, a run inside a lane taken whole, the
    lanes' last runs carried by a segmented Hillis-Steele scan (lane l
    takes lane l - d's partial at step d when their last keys agree), a
    lane's first run completed with its predecessor's scan value; any
    other unit: for each of the four edges of a lane in turn, each
    segment's lanes folded in lane order.  Each unit's totals are taken
    into its warp's accumulator in unit order; a piece's segment the
    warps folded in warp order; a split block's pieces folded in piece
    order.  ``data`` is float32 or bfloat16 (taken exactly as float32);
    the kernel rounds the result once to the input type.  Returns
    ((num_segments,) float32 array, cells walked)."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    if isinstance(data, torch.Tensor):
        data = data.detach().float().cpu().numpy()
    d = np.asarray(data, np.float32)
    ids = _np(segment_ids).astype(np.int64)
    e = ids.shape[0]
    mask = np.ones(e, bool) if edge_mask is None \
        else _np(edge_mask).astype(bool)
    ident = np.float32(math.inf if kind == "min" else 0.0)
    comb = _combine_np(kind)
    warps = SEG_NWARP
    walk = piece_walk(np.zeros(e, np.int64), mask, ids, np.ones(1, bool),
                      num_segments, cells)
    # the cells in launch order: piece, first position, end, first unit
    c_piece, c_lo, c_end, c_u0, c_nu, piece_blk = [], [], [], [], [], []
    for i, pieces in enumerate(walk):
        for piece in pieces:
            u0 = 0
            for j, _, lo, hi in piece:
                n_u = (hi - lo + 3) // 4
                c_piece.append(len(piece_blk))
                c_lo.append(j * EBLK + 32 * lo)
                c_end.append(min(j * EBLK + 32 * hi, e))
                c_u0.append(u0)
                c_nu.append(n_u)
                u0 += n_u
            piece_blk.append(i)
    walked = len(c_piece)
    c_nu = np.asarray(c_nu, np.int64)
    cell = np.repeat(np.arange(walked), c_nu)
    m_in = np.arange(cell.shape[0]) - np.repeat(np.cumsum(c_nu) - c_nu, c_nu)
    u_piece = np.asarray(c_piece, np.int64)[cell]
    u_seq = np.asarray(c_u0, np.int64)[cell] + m_in
    u_warp = u_seq % warps
    u_blk = np.asarray(piece_blk, np.int64)[u_piece]
    pos = (np.asarray(c_lo, np.int64)[cell] + UNIT * m_in)[:, None] \
        + np.arange(UNIT)
    valid = pos < np.asarray(c_end, np.int64)[cell][:, None]
    at = np.where(valid, pos, 0)
    local = ids[at] - u_blk[:, None] * SBLK
    key = np.where(valid, np.where(local < 0, -1,
                                   np.where(local < SBLK, local, SBLK)),
                   SBLK).reshape(-1, 32, 4)
    msg = np.where(valid, d[at], ident).astype(np.float32).reshape(-1, 32, 4)
    up = (key[:, :, 0] <= key[:, :, 1]) & (key[:, :, 1] <= key[:, :, 2]) \
        & (key[:, :, 2] <= key[:, :, 3])
    up[:, 1:] &= key[:, :-1, 3] <= key[:, 1:, 0]
    srt = up.all(axis=1)
    in_blk = lambda k: (k >= 0) & (k < SBLK)  # noqa: E731
    cu, ck, cs, cv = [], [], [], []          # unit, key, sub-order, value

    def emit(units, keys, vals, sub):
        cu.append(units)
        ck.append(keys)
        cs.append(np.full(units.shape[0], sub, np.int64))
        cv.append(vals.astype(np.float32))

    # sorted units: runs in the lane, the scan over the lanes' last runs
    us = np.flatnonzero(srt)
    k, v = key[us], msg[us]
    rows = np.broadcast_to(us[:, None], k.shape[:2])
    r, head = v[:, :, 0].copy(), v[:, :, 0].copy()
    for t in range(1, 4):
        same = k[:, :, t] == k[:, :, t - 1]
        is_head = ~same & (k[:, :, t - 1] == k[:, :, 0])
        head = np.where(is_head, r, head)
        mid = ~same & ~is_head & in_blk(k[:, :, t - 1])
        emit(rows[mid], k[:, :, t - 1][mid], r[mid], 0)
        r = np.where(same, comb(r, v[:, :, t]), v[:, :, t])
    k0, k3 = k[:, :, 0], k[:, :, 3]
    s = r
    for dd in (1, 2, 4, 8, 16):
        su = np.full_like(s, ident)
        su[:, dd:] = s[:, :-dd]
        ku = np.full_like(k3, -2)
        ku[:, dd:] = k3[:, :-dd]
        s = np.where(ku == k3, comb(su, s), s)
    s_prev = np.full_like(s, ident)
    s_prev[:, 1:] = s[:, :-1]
    prev3 = np.full_like(k3, -2)
    prev3[:, 1:] = k3[:, :-1]
    next0 = np.full_like(k0, -2)
    next0[:, :-1] = k0[:, 1:]
    hsel = (k0 != k3) & in_blk(k0)
    hv = np.where(prev3 == k0, comb(s_prev, head), head)
    emit(rows[hsel], k0[hsel], hv[hsel], 0)
    tsel = (next0 != k3) & in_blk(k3)
    emit(rows[tsel], k3[tsel], s[tsel], 0)

    # other units: each segment's lanes in lane order, edge by edge
    uq = np.flatnonzero(~srt)
    for t in range(4):
        kt, vt = key[uq, :, t], msg[uq, :, t]
        uu, ll = np.nonzero(in_blk(kt))
        kk = kt[uu, ll]
        o = np.lexsort((ll, kk, uu))
        g = (uu[o] * (SBLK + 1) + kk[o])
        starts, folds = _fold_groups(g, vt[uu, ll][o], comb)
        emit(uq[uu[o][starts]], kk[o][starts], folds, t)

    # each warp's accumulator: the units' totals in unit order
    cu, ck, cs, cv = (np.concatenate(x) for x in (cu, ck, cs, cv))
    n_pieces = len(piece_blk)
    acc = np.full((n_pieces, warps, SBLK), ident, np.float32)
    if cu.size:
        cp, cw, cq = u_piece[cu], u_warp[cu], u_seq[cu]
        o = np.lexsort((cs, cq, ck, cw, cp))
        g = (cp[o] * warps + cw[o]) * SBLK + ck[o]
        starts, folds = _fold_groups(g, cv[o], comb, ident)
        acc.reshape(-1)[g[starts]] = folds
    rows = acc[:, 0].copy()
    for w in range(1, warps):
        rows = comb(rows, acc[:, w])
    starts, blocks = _fold_groups(np.asarray(piece_blk), rows, comb)
    out = np.full((len(walk), SBLK), ident, np.float32)
    out[np.asarray(piece_blk)[starts]] = blocks
    return out.reshape(-1)[:num_segments], walked
