"""Round compositions over the exchange primitives.

One relax → exchange → rhizome-collapse composition per execution layout
(stacked, sharded) and per app class — monotone fixpoints and counted
PageRank-style rounds — each serving both the unlaned and the
lane-batched (trailing Q) table layouts.  ``core.engine`` and
``query.lanes`` are thin loops over these — the round loop, termination
check and stats bookkeeping live there; the per-round math lives here,
once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.actions import Semiring
from repro_torch.exchange import collectives
from repro_torch.exchange.collectives import axis_tuple  # noqa: F401
from repro_torch.exchange.primitives import (
    collapse, compact_collapse, reduce_axis0, relax, scatter_inbox,
    stacked_compact_partial, stacked_dense_inbox,
)


def _flat(table):
    """Collapse the leading (shard, slot) dims; a trailing Q rides."""
    return table.reshape((-1,) + tuple(table.shape[2:]))


# --------------------------------------------------------------------------
# stacked layout: all shards resident as a leading S axis on one device
# --------------------------------------------------------------------------

def stacked_inbox(sem: Semiring, arrays, cfg, S: int, R_max: int,
                  gval, gchg, lane_unitw=None, worklist=None):
    """Relax + exchange on the stacked layout.

    Dense: one reduced global inbox.  Compact: per-source (target,
    distinct-slot) partials, read target-major in place of the real
    all-to-all and scatter-combined per target (``scatter_inbox``).
    ``worklist`` is a host-planned sparse launch for the fused relax,
    planned against this exchange's launch (``core.engine.
    launch_planner``).  Returns the ((S, R_max[, Q]) inbox, message count
    — a scalar, or (Q,) per lane)."""
    if cfg.exchange == "compact":
        P_t = arrays.inbox_slot_map.shape[-1]
        partial, counts = stacked_compact_partial(
            sem, arrays, cfg, S, P_t, gval, gchg, lane_unitw, worklist)
        inbox = scatter_inbox(sem, partial.transpose(0, 1),
                              arrays.inbox_slot_map, R_max,
                              arrays.compact.inbox_index)
        return inbox, counts
    flat, counts = stacked_dense_inbox(sem, arrays, cfg, gval, gchg,
                                       S * R_max, lane_unitw, worklist)
    return flat.reshape((S, R_max) + tuple(flat.shape[1:])), counts


def stacked_collapse(sem: Semiring, arrays, cfg, table):
    """Eager rhizome collapse of a stacked (S, R_max[, Q]) table: the
    dense sibling collapse, or the compact rhizome-only gather/scatter."""
    if cfg.exchange == "compact":
        rz = arrays.rz_local
        return compact_collapse(sem, table, rz, arrays.rz_sibling_idx,
                                arrays.rz_sibling_mask, _flat,
                                table.shape[1], rz.shape[-1])
    return collapse(sem, _flat(table), arrays.sibling_flat,
                    arrays.sibling_mask)


def fixpoint_round_stacked(sem: Semiring, arrays, cfg, S: int, R_max: int,
                           val, chg, lane_unitw=None, worklist=None,
                           lane_mask=None):
    """One stacked fixpoint round: relax → exchange → combine → eager
    rhizome collapse → predicate.  ``val``/``chg``: (S, R_max) or
    (S, R_max, Q).  Returns (new val, new changed, message count).

    ``lane_mask`` ((Q,) bool) freezes masked-off lanes for this round:
    their frontier reads all-False (no relax work, no messages), they
    emit no next-round frontier, and their values carry through
    unchanged — the per-lane round budget."""
    laned = val.dim() == 3
    if lane_mask is not None:
        chg = chg & lane_mask
    inbox, counts = stacked_inbox(sem, arrays, cfg, S, R_max, _flat(val),
                                  _flat(chg), lane_unitw, worklist)
    cand = sem.combine(val, inbox)
    if cfg.collapse == "eager":
        cand = stacked_collapse(sem, arrays, cfg, cand)
    slot = arrays.slot_valid[..., None] if laned else arrays.slot_valid
    new_chg = sem.improved(cand, val) & slot
    if lane_mask is not None:
        cand = torch.where(lane_mask, cand, val)
        new_chg = new_chg & lane_mask
    return cand, new_chg, counts


def stacked_total_in(sem: Semiring, arrays, cfg, S: int, R_max: int,
                     gval, gchg, lane_unitw=None, worklist=None):
    """Relax → exchange → rhizome-collapse(⊕) of the *bare inbox* — the
    total in-flow per slot that counted (PageRank-style) rounds consume.
    The collapse sees inbox partials, never combined candidates, so the
    sum-semiring sibling-total overwrite is exact."""
    inbox, counts = stacked_inbox(sem, arrays, cfg, S, R_max, gval, gchg,
                                  lane_unitw, worklist)
    return stacked_collapse(sem, arrays, cfg, inbox), counts


def pagerank_round_stacked(sem: Semiring, arrays, cfg, S: int, R_max: int,
                           base, damping, val, chg, worklist=None):
    """One stacked PageRank round: relax → exchange → rhizome-collapse(+)
    → damping update."""
    total_in, counts = stacked_total_in(sem, arrays, cfg, S, R_max,
                                        _flat(val), _flat(chg),
                                        worklist=worklist)
    new_val = torch.where(arrays.slot_valid, base + damping * total_in, 0.0)
    return new_val, counts


def delta_pagerank_round_stacked(sem: Semiring, arrays, cfg, S: int,
                                 R_max: int, damping, tol, rank, delta,
                                 worklist=None):
    """One stacked **delta-PageRank** round (the diffusion-pruned sum
    semiring, paper Listing 10 with lazy residuals).

    Ranks follow the Neumann series ``rank = Σ_k (d·Aᵀ)^k base``, but each
    round ships only the residual delta, and only where ``|delta| > tol``
    (scalar or per-slot): sub-tolerance residuals are dropped (the
    paper's pruned diffusions), so the frontier shrinks round over round.
    Returns (new rank, new delta, new changed, message count); callers
    seed ``rank = delta = base`` (see ``engine.run_pagerank_delta``)."""
    chg = (delta.abs() > tol) & arrays.slot_valid
    total_in, counts = stacked_total_in(sem, arrays, cfg, S, R_max,
                                        _flat(delta), _flat(chg),
                                        worklist=worklist)
    new_delta = torch.where(arrays.slot_valid, damping * total_in, 0.0)
    new_rank = rank + new_delta
    new_chg = (new_delta.abs() > tol) & arrays.slot_valid
    return new_rank, new_delta, new_chg, counts


# --------------------------------------------------------------------------
# K-round windows: round sequences enqueued without a host sync
# --------------------------------------------------------------------------
# A round whose entering frontier is empty is a no-op under every
# semiring here (all sources read the absorbing identity, min candidates
# equal val, delta residuals are zero), so a window that overruns
# convergence stays exact — drivers trim the trailing dead rounds from
# the returned per-round stacks.  Each step also records the frontier
# ENTERING that round, giving the host the whole trajectory in one read.


def fixpoint_window_stacked(sem: Semiring, arrays, cfg, S: int, R_max: int,
                            k: int, val, chg, lane_unitw=None,
                            lane_mask=None):
    """K stacked fixpoint rounds, enqueued back to back.  Returns (val,
    chg, (k[, Q]) int64 per-round message counts, (k, S, R_max[, Q])
    per-round entering frontiers), all on the tables' device.  A fixed
    ``lane_mask`` freezes its masked-off lanes in every round."""
    counts, frontiers = [], []
    for _ in range(k):
        frontiers.append(chg)
        val, chg, c = fixpoint_round_stacked(
            sem, arrays, cfg, S, R_max, val, chg, lane_unitw,
            lane_mask=lane_mask)
        counts.append(c.to(torch.int64))
    return val, chg, torch.stack(counts), torch.stack(frontiers)


def delta_pagerank_window_stacked(sem: Semiring, arrays, cfg, S: int,
                                  R_max: int, k: int, damping, tol, rank,
                                  delta):
    """K stacked delta-PageRank rounds, enqueued back to back.  Returns
    (rank, delta, chg, (k,) int64 counts, (k, S, R_max) entering
    frontiers)."""
    counts, frontiers = [], []
    for _ in range(k):
        frontiers.append((delta.abs() > tol) & arrays.slot_valid)
        rank, delta, _, c = delta_pagerank_round_stacked(
            sem, arrays, cfg, S, R_max, damping, tol, rank, delta)
        counts.append(c.to(torch.int64))
    chg = (delta.abs() > tol) & arrays.slot_valid
    return rank, delta, chg, torch.stack(counts), torch.stack(frontiers)


# --------------------------------------------------------------------------
# sharded layout: one shard a process, real collectives
# --------------------------------------------------------------------------
# A shard's tables keep a leading dim of 1 — (1, R_max[, Q]) values and
# frontiers over one shard's ``DeviceArrays`` (``DeviceArrays.
# from_partition(part, shard=r)``), the reference's ``x[0]`` before it is
# stripped — and ``group`` (``collectives.ShardGroup``) stands where the
# reference passes its mesh ``axis_names``.


def shard_gather(x, group):
    """Tiled all-gather of a shard's (1, R[, Q]) table: the flat
    (S*R[, Q]) table of every shard in shard order."""
    return _flat(collectives.all_gather(x, group))


def shard_inbox(sem: Semiring, arrays_s, cfg, S: int, R_max: int, group,
                gval, gchg, lane_unitw=None):
    """Per-shard relax + real inbox exchange.

    The relax launches this shard's edges only (its own launch plan,
    ``S*R_max`` segments dense, ``S*P_t`` compact) over the gathered
    (S*R_max[, Q]) tables.  Dense: the (S, R_max[, Q]) partial →
    ``all_to_all`` → axis-0 reduce of the received partials in shard
    order.  Compact: only the (S, P_t[, Q]) targeted tables ride the
    ``all_to_all`` and scatter into the local slots.  Returns ((1,
    R_max[, Q]) inbox, this shard's message count)."""
    plan_on = cfg.use_pallas
    if cfg.exchange == "compact":
        ct = arrays_s.compact
        P_t = ct.inbox_slot_map.shape[-1]
        partial, counts = relax(
            sem, cfg, arrays_s.edge_src_root_flat, arrays_s.edge_w,
            arrays_s.edge_mask, ct.edge_dst_compact, gval, gchg, S * P_t,
            lane_unitw, plan=ct.plan if plan_on else None)
        recv = collectives.all_to_all(partial, group)
        inbox = scatter_inbox(sem, recv.reshape((1, S, P_t) + tuple(
            recv.shape[1:])), ct.inbox_slot_map, R_max, ct.inbox_index)
        return inbox, counts
    partial, counts = relax(
        sem, cfg, arrays_s.edge_src_root_flat, arrays_s.edge_w,
        arrays_s.edge_mask, arrays_s.edge_dst_flat, gval, gchg, S * R_max,
        lane_unitw, plan=arrays_s.fused_plan if plan_on else None)
    # row block t of the partial belongs to shard t
    recv = collectives.all_to_all(partial, group)
    recv = recv.reshape((S, R_max) + tuple(recv.shape[1:]))
    return reduce_axis0(sem, recv)[None], counts


def shard_collapse(sem: Semiring, arrays_s, cfg, table, group, R_max: int):
    """Eager rhizome collapse of a shard's (1, R_max[, Q]) table over the
    gathered siblings: every slot's siblings (dense), or the compact
    rhizome-only gather/scatter."""
    if cfg.exchange == "compact":
        ct = arrays_s.compact
        rz = ct.rz_local
        return compact_collapse(
            sem, table, rz, ct.rz_sibling_idx, ct.rz_sibling_mask,
            lambda x: shard_gather(x, group), R_max, rz.shape[-1])
    return collapse(sem, shard_gather(table, group), arrays_s.sibling_flat,
                    arrays_s.sibling_mask)


def make_shard_fixpoint_round(sem: Semiring, arrays_s, cfg, S: int,
                              R_max: int, group, lane_unitw=None):
    """The per-shard fixpoint round: (val, chg[, lane_mask]) → (new val,
    new changed, this shard's message count), with the same collective
    plan for unlaned (1, R_max) and laned (1, R_max, Q) tables — value
    and frontier ``all_gather`` (the diffusion fan-out), inbox
    ``all_to_all``, sibling collapse over the gathered table.

    ``lane_mask`` ((Q,) bool, the same on every shard) freezes masked-off
    lanes, as in ``fixpoint_round_stacked``."""

    def round_fn(val, chg, lane_mask=None):
        laned = val.dim() == 3
        if lane_mask is not None:
            chg = chg & lane_mask
        inbox, counts = shard_inbox(
            sem, arrays_s, cfg, S, R_max, group, shard_gather(val, group),
            shard_gather(chg, group), lane_unitw)
        cand = sem.combine(val, inbox)
        if cfg.collapse == "eager":
            cand = shard_collapse(sem, arrays_s, cfg, cand, group, R_max)
        slot = arrays_s.slot_valid[..., None] if laned \
            else arrays_s.slot_valid
        new_chg = sem.improved(cand, val) & slot
        if lane_mask is not None:
            cand = torch.where(lane_mask, cand, val)
            new_chg = new_chg & lane_mask
        return cand, new_chg, counts

    return round_fn


def shard_total_in(sem: Semiring, arrays_s, cfg, S: int, R_max: int, group,
                   gval, gchg, lane_unitw=None):
    """Sharded relax → exchange → rhizome-collapse(⊕) of the bare inbox
    (see ``stacked_total_in``)."""
    inbox, counts = shard_inbox(sem, arrays_s, cfg, S, R_max, group, gval,
                                gchg, lane_unitw)
    return shard_collapse(sem, arrays_s, cfg, inbox, group, R_max), counts


def delta_pagerank_round_shard(sem: Semiring, arrays_s, cfg, S: int,
                               R_max: int, group, damping, tol, rank,
                               delta):
    """Per-shard delta-PageRank round, the sharded twin of
    ``delta_pagerank_round_stacked``: value/frontier ``all_gather``,
    relax over the residual frontier, inbox exchange,
    rhizome-collapse(+).  Counts are this shard's (callers sum them)."""
    chg = (delta.abs() > tol) & arrays_s.slot_valid
    total_in, counts = shard_total_in(
        sem, arrays_s, cfg, S, R_max, group, shard_gather(delta, group),
        shard_gather(chg, group))
    new_delta = torch.where(arrays_s.slot_valid, damping * total_in, 0.0)
    new_rank = rank + new_delta
    new_chg = (new_delta.abs() > tol) & arrays_s.slot_valid
    return new_rank, new_delta, new_chg, counts


# --------------------------------------------------------------------------
# host-side accounting mirrors (flight-recorder feeds)
# --------------------------------------------------------------------------

def shard_message_mirror(edge_mask, edge_src_root_flat, gchg):
    """Per-shard message-volume mirror: how many live edge messages each
    shard's edge list delivers this round — ``edge_mask & frontier[src]``
    summed per shard, exactly the population ``relax`` counts (so the
    vector sums to the round's kernel-side message count).  Host-side
    numpy over the (S, E_max) partition arrays; feeds the flight
    recorder's per-shard skew/balance gauge."""
    mask = np.asarray(edge_mask)
    srcs = np.asarray(edge_src_root_flat)
    g = np.asarray(gchg).reshape(-1)
    return (mask & g[srcs]).sum(axis=tuple(range(1, mask.ndim)))


def expected_round_messages(edge_mask, edge_src_root_flat, gchg,
                            laned: bool = False) -> int:
    """The exact message total a clean round on frontier ``gchg`` must
    report: ``shard_message_mirror`` summed over shards (the resilient
    runner's inbox-integrity check: a round whose count falls short or
    overshoots it lost or duplicated an inbox).  With ``laned=True`` the
    trailing axis of ``gchg`` is the lane axis Q and the expectation sums
    over lanes, as the laned relax counts."""
    g = np.asarray(gchg)
    if not laned:
        return int(shard_message_mirror(edge_mask, edge_src_root_flat,
                                        g).sum())
    gq = g.reshape(-1, g.shape[-1])
    return int(sum(shard_message_mirror(edge_mask, edge_src_root_flat,
                                        gq[:, q]).sum()
                   for q in range(gq.shape[1])))


def mask_shard_frontier(chg, shard: int):
    """Frontier ``chg`` ((S, R_max[, Q]), a tensor or an array) with shard
    ``shard``'s rows forced False: a dropped inbox, that shard's outgoing
    messages lost for one round.  Returns a new table; the caller keeps
    the original for a retry."""
    if isinstance(chg, torch.Tensor):
        out = chg.clone()
        out[shard] = False
        return out
    return _mask_np(chg, shard)


def _mask_np(chg, shard: int):
    out = np.array(chg, copy=True)
    out[shard] = False
    return out
