"""Lane-batched multi-query fixpoints on the stacked layout.

Serving many source-rooted queries on one shared rhizome partition: the
engine's value table grows a trailing **query-lane axis Q** — values are
``(S, R_max, Q)``, the ``changed`` frontier is per lane — and one round
advances every live query at once.  A lane whose frontier column is
all-False reads as the absorbing identity inside the relax, so it stops
relaxing while the round keeps running for live lanes; the fused
kernels' chunk skip is the OR across lanes (K3 dense, K4 worklist; see
``kernels.fused_relax_reduce.fused_relax_reduce_lanes``).

One round serves a **mixed BFS/SSSP batch**: min-semiring lanes relax
with 'add_w', and the per-lane ``lane_unitw`` flag swaps the edge weight
for 1.0 (BFS levels are SSSP distances over unit weights — the same float
op, so a batched lane is bit-identical to its solo ``engine.run_stacked``
run).  Sum-semiring lanes (personalized PageRank, per-lane seed and
damping) run as counted ``make_ppr_round`` rounds with a per-lane
tolerance, or as residual-pruned ``make_ppr_delta_round`` rounds.

The loops run on the host, as ``engine.run_stacked``'s do: under
``grid_mode='dense'`` one host sync per round tests the frontier; under
``'worklist'``/``'auto'`` the OR-across-lanes frontier comes to the host
each round to plan the sparse launch; under ``'device_worklist'`` rounds
are enqueued in windows of ``device_window`` with one host read per
window.  ``engine_dispatches_total`` / ``engine_host_syncs_total`` (runs
``lanes_min`` and ``ppr_delta_lanes``) count exactly that.  Per-lane
statistics stay on the device.

Every runner takes the dense or the compact exchange (``cfg.exchange``).
The sharded runners (``run_sharded_lanes`` and the sharded rounds) run
one shard a process over ``torch.distributed``, every rank making the
same call (see ``core.engine.run_sharded``).  Entry points take
``device`` (``None`` means CUDA and raises without it).
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from repro_torch import exchange
from repro_torch.core import actions, engine
from repro_torch.core.actions import Semiring
from repro_torch.core.engine import DeviceArrays, EngineConfig
from repro_torch.core.partition import Partition

UNREACHED = np.iinfo(np.int32).max


def decode_min_values(vv: np.ndarray, kind: str) -> np.ndarray:
    """Decode a min-lane's per-vertex values for its query kind: 'bfs' ->
    int64 levels with the UNREACHED sentinel, 'reachability' -> bool,
    'sssp' -> float64 distances (inf where unreachable)."""
    if kind == "bfs":
        out = np.where(np.isfinite(vv), vv, 0).astype(np.int64)
        out[~np.isfinite(vv)] = UNREACHED
        return out
    if kind == "reachability":
        return np.isfinite(vv)
    if kind == "sssp":
        return vv.astype(np.float64)
    raise ValueError(f"unknown min-lane query kind {kind!r}")


class LaneStats(typing.NamedTuple):
    """Per-lane (Q,) int64 counters — the Fig-6 statistics, one per query,
    plus the exchange-volume accounting (entries shipped through the
    inter-shard exchange while the lane was live)."""

    rounds: torch.Tensor        # rounds in which the lane was live
    messages: torch.Tensor      # actions delivered (active edges) per lane
    work_actions: torch.Tensor  # predicate-true slot updates per lane
    exchanged: torch.Tensor     # exchange entries shipped while live


def _zero_stats(q: int, device) -> LaneStats:
    zero = torch.zeros(q, dtype=torch.int64, device=device)
    return LaneStats(zero, zero, zero, zero)


def _add_stats(stats: LaneStats, live, counts, work, vol: int) -> LaneStats:
    live = live.to(torch.int64)
    return LaneStats(rounds=stats.rounds + live,
                     messages=stats.messages + counts.to(torch.int64),
                     work_actions=stats.work_actions + work.to(torch.int64),
                     exchanged=stats.exchanged + live * vol)


def _check_cfg(cfg: EngineConfig):
    if cfg.collapse != "eager":
        raise ValueError("lane-batched runners support collapse='eager' only")
    if cfg.use_pallas and cfg.pallas_mode != "fused":
        raise ValueError(
            "lane-batched Pallas execution is fused-only (the pre-fusion "
            "'reduce' composition has no laned form)")


def _check_min(sem: Semiring):
    # the laned round relaxes with 'add_w' + the per-lane unitw flag, so a
    # semiring whose own relax differs (BFS 'add_one') must not be
    # accepted and silently re-relaxed with edge weights — BFS lanes are
    # expressed as lane_unitw=1 under the SSSP semiring instead
    if sem.segment != "min" or sem.relax_kind != "add_w":
        raise ValueError(
            "laned runners drive min-semiring 'add_w' fixpoints (express "
            "BFS lanes with lane_unitw=1, not the 'add_one' semiring); "
            "sum semirings run as make_ppr_round counted rounds")


def _volume(part: Partition, cfg: EngineConfig) -> int:
    """Entries that transit the exchange per round, per live lane
    (``exchange.exchange_volume``: S*S*R_max dense, S*S*P_t compact)."""
    return exchange.exchange_volume(part.S, part.R_max, part.P_t, cfg)


def _lane_vector(x, q: int, dtype, device):
    """A (Q,) tensor from a scalar, a sequence or a tensor."""
    return torch.as_tensor(np.broadcast_to(np.asarray(
        x.cpu() if isinstance(x, torch.Tensor) else x), (q,)).copy()).to(
            device=device, dtype=dtype)


def _host_loop(run: str, planner, cfg: EngineConfig, max_rounds: int,
               frontier, step, state):
    """Host-driven lane rounds: test the effective frontier
    ``frontier(state)`` ((S, R_max, Q) bool) — on the host, OR'd across
    lanes, when a planner plans the round's worklist, else as one flag —
    then ``state = step(state, worklist)``.  One dispatch per round, one
    host sync per frontier test."""
    it = syncs = 0
    while it < max_rounds:
        syncs += 1
        eff = frontier(state)
        wl = None
        if planner is not None:
            eff_h = eff.reshape(-1, eff.shape[-1]).cpu().numpy()
            if not eff_h.any():
                break
            wl = engine.plan_round_worklist(planner, cfg, eff_h.any(axis=1))
        elif not bool(eff.any()):
            break
        state = step(state, wl)
        it += 1
    engine._count_dispatches(run, it, syncs)
    return state


def _window_loop(run: str, cfg: EngineConfig, max_rounds: int, frontier,
                 step, state):
    """``device_worklist`` lane rounds: windows of ``cfg.device_window``
    rounds enqueued with no host sync, then one host read of whether any
    lane is still live.  A round entered with an empty effective frontier
    is a no-op (every source reads the identity, no lane counts as live),
    so a window that overruns convergence stays exact."""
    it = windows = 0
    live = True
    while it < max_rounds and live:
        k = min(cfg.device_window, max_rounds - it)
        for _ in range(k):
            state = step(state, None)
        it += k
        windows += 1
        live = bool(frontier(state).any())
    engine._count_dispatches(run, windows, windows)
    return state


# --------------------------------------------------------------------------
# stacked laned fixpoint runner (BFS / SSSP / reachability / CC lanes)
# --------------------------------------------------------------------------

def make_stacked_lanes_fn(part: Partition,
                          cfg: EngineConfig = EngineConfig(),
                          sem: Semiring = actions.SSSP, device=None,
                          arrays=None):
    """Builds the stacked laned fixpoint as a function of ((S, R_max, Q)
    init values, (Q,) lane_unitw, (S, R_max, Q) init changed[, (Q,)
    lane_budget]) -> (values, ``LaneStats``), with the partition's device
    tables built once.  Q comes from the arguments' shapes, so one
    function serves any lane count.

    ``lane_budget`` ((Q,) int, optional) is a per-lane round budget: a
    lane that has been live for ``budget`` rounds is frozen in-round
    (``exchange.fixpoint_round_stacked``'s ``lane_mask``) — its values
    stop improving and it costs no further messages.  ``arrays``:
    ``DeviceArrays.from_partition(part)`` when the caller has uploaded it
    already (``None``: uploaded here)."""
    _check_cfg(cfg)
    _check_min(sem)
    dev = engine.resolve_device(device)
    if arrays is None:
        arrays = DeviceArrays.from_partition(part, dev)
    S, R_max = part.S, part.R_max
    vol = _volume(part, cfg)

    def fn(init_val, lane_unitw, init_chg, lane_budget=None):
        val = torch.as_tensor(init_val, dtype=torch.float32, device=dev)
        q = val.shape[-1]
        # the plans' residency is judged at this call's Q lanes, as the
        # launches judge it
        planner = engine.launch_planner(part, cfg, q_pad=q) \
            if cfg.wants_worklist else None
        unitw = _lane_vector(lane_unitw, q, torch.int32, dev)
        chg = torch.as_tensor(init_chg, dtype=torch.bool, device=dev)
        budget = (None if lane_budget is None
                  else _lane_vector(lane_budget, q, torch.int64, dev))

        def frontier(state):
            _, chg, stats = state
            return chg if budget is None else chg & (stats.rounds < budget)

        def step(state, wl):
            val, chg, stats = state
            mask = None if budget is None else stats.rounds < budget
            live = frontier(state).reshape(-1, q).any(dim=0)
            val, chg, counts = exchange.fixpoint_round_stacked(
                sem, arrays, cfg, S, R_max, val, chg, unitw, worklist=wl,
                lane_mask=mask)
            return val, chg, _add_stats(stats, live, counts,
                                        chg.reshape(-1, q).sum(dim=0), vol)

        state = (val, chg, _zero_stats(q, dev))
        if cfg.wants_device_worklist:
            state = _window_loop("lanes_min", cfg, cfg.max_iters, frontier,
                                 step, state)
        else:
            state = _host_loop("lanes_min", planner, cfg, cfg.max_iters,
                               frontier, step, state)
        return state[0], state[2]

    return fn


def run_stacked_lanes(part: Partition, init_val, lane_unitw=None,
                      cfg: EngineConfig = EngineConfig(),
                      init_changed=None, sem: Semiring = actions.SSSP,
                      lane_budget=None, device=None, arrays=None):
    """Single-device lane-batched execution.  ``init_val``: (S, R_max, Q)
    float32 — one query per lane; ``lane_unitw`` (Q,) marks BFS-style
    lanes (relax with weight 1.0).  A lane converges when no slot of its
    column improves; the round keeps running while any lane is live.
    ``init_changed`` (optional (S, R_max, Q) bool) seeds the first
    frontier.  ``lane_budget`` ((Q,) int, scalar broadcasts) caps each
    lane's live rounds: a budget-exhausted lane freezes (partial values
    carried through, no further cost) while the others run on.

    Under ``cfg.grid_mode='worklist'|'auto'`` (fused only) each round's
    OR-across-lanes frontier plans a sparse K4 launch on the host; under
    ``'device_worklist'`` the K4 worklist is compacted on the device and
    rounds run in windows.  ``arrays`` as in ``make_stacked_lanes_fn``.
    Returns ((S, R_max, Q) values, per-lane ``LaneStats``) as tensors on
    ``device``."""
    init_val = np.asarray(init_val, np.float32) \
        if not isinstance(init_val, torch.Tensor) else init_val
    if init_val.ndim != 3:
        raise ValueError(f"init_val must be (S, R_max, Q); got "
                         f"{tuple(init_val.shape)}")
    _check_cfg(cfg)
    _check_min(sem)
    q = init_val.shape[-1]
    fn = make_stacked_lanes_fn(part, cfg, sem, device, arrays)
    slot_valid = torch.as_tensor(part.slot_vertex >= 0)[..., None]
    if init_changed is not None:
        init_chg = torch.as_tensor(init_changed, dtype=torch.bool).cpu() \
            & slot_valid
    else:
        vals = torch.as_tensor(init_val, dtype=torch.float32).cpu()
        init_chg = sem.improved(vals, torch.full_like(vals, sem.identity)) \
            & slot_valid
    unitw = np.zeros(q, np.int32) if lane_unitw is None else lane_unitw
    return fn(init_val, unitw, init_chg, lane_budget)


# --------------------------------------------------------------------------
# sharded laned runners (one shard a process, torch.distributed)
# --------------------------------------------------------------------------
# As ``engine.run_sharded``: every rank makes the same call; a shard's
# tables are (1, R_max, Q) over its own ``DeviceArrays`` (``shard=r``),
# and per-lane counts are summed over the shards by one all-reduce.


def make_sharded_lanes_fn(S: int, R_max: int, Q: int, mesh,
                          axis_names=("data", "model"),
                          cfg: EngineConfig = EngineConfig(),
                          sem: Semiring = actions.SSSP,
                          with_init_changed: bool = False):
    """The sharded laned fixpoint as ``(fn, group)``: ``fn(arrays, val,
    lane_unitw[, init_chg])`` takes this rank's shard and (1, R_max, Q)
    values ((1, R_max, Q) bool initial frontier with
    ``with_init_changed=True``; else derived from non-identity values)
    and returns its (1, R_max, Q) fixpoint values and the per-lane
    ``LaneStats`` summed over the shards.  The collective plan of
    ``engine.make_sharded_fn`` with the lane axis riding along: value and
    frontier ``all_gather``, inbox ``all_to_all`` (the (S, R_max, Q)
    partial dense, the (S, P_t, Q) tables compact), sibling collapse over
    the gathered table; each round ends in one all-reduce of the (Q,)
    counts, work and live flags, read to the host."""
    _check_cfg(cfg)
    _check_min(sem)
    cfg = engine._sharded_cfg(cfg, "make_sharded_lanes_fn")
    sg = engine.shard_group(S, mesh, axis_names)

    def fn(arrays, val, lane_unitw, init_chg=None):
        if with_init_changed != (init_chg is not None):
            raise ValueError("init_chg is given exactly when the function "
                             "was built with_init_changed=True")
        dev = val.device
        unitw = _lane_vector(lane_unitw, Q, torch.int32, dev)
        sv = arrays.slot_valid[..., None]
        if init_chg is None:
            chg = sem.improved(val, torch.full_like(val, sem.identity)) & sv
        else:
            chg = init_chg & sv
        vol = exchange.exchange_volume(
            S, R_max, arrays.compact.inbox_slot_map.shape[-1]
            if cfg.exchange == "compact" else 0, cfg)
        round_fn = exchange.make_shard_fixpoint_round(
            sem, arrays, cfg, S, R_max, sg, lane_unitw=unitw)
        psum = exchange.collectives.psum
        live = psum(chg.reshape(-1, Q).any(dim=0).to(torch.int64), sg) \
            .cpu().numpy() > 0
        totals = np.zeros((4, Q), np.int64)
        it, syncs = 0, 1
        while live.any() and it < cfg.max_iters:
            val, chg, counts = round_fn(val, chg)
            tot = psum(torch.stack([
                counts.to(torch.int64),
                chg.reshape(-1, Q).sum(dim=0),
                chg.reshape(-1, Q).any(dim=0).to(torch.int64)]), sg)
            counts_h, work_h, any_h = tot.cpu().numpy()
            totals += np.stack([live, counts_h, work_h, live * vol])
            live = any_h > 0
            it += 1
            syncs += 1
        engine._count_dispatches("lanes_min_sharded", it, syncs)
        return val, LaneStats(*(torch.as_tensor(t, device=dev)
                                for t in totals))

    return fn, sg


def make_sharded_min_round(S: int, R_max: int, mesh,
                           axis_names=("data", "model"),
                           cfg: EngineConfig = EngineConfig(),
                           sem: Semiring = actions.SSSP):
    """One sharded laned fixpoint round as ``(fn, group)``: ``fn(arrays,
    val, chg, unitw)`` -> (val, chg, (Q,) counts summed over the shards)
    on this shard's (1, R_max, Q) tables — one tick of the sharded
    ``QueryServer``'s min pool."""
    _check_cfg(cfg)
    _check_min(sem)
    cfg = engine._sharded_cfg(cfg, "make_sharded_min_round")
    sg = engine.shard_group(S, mesh, axis_names)

    def fn(arrays, val, chg, unitw):
        round_fn = exchange.make_shard_fixpoint_round(
            sem, arrays, cfg, S, R_max, sg, lane_unitw=unitw)
        val, chg, counts = round_fn(val, chg)
        return val, chg, exchange.collectives.psum(counts.to(torch.int64),
                                                   sg)

    return fn, sg


def run_sharded_lanes(part: Partition, init_val, lane_unitw=None,
                      mesh=None, axis_names=("data", "model"),
                      cfg: EngineConfig = EngineConfig(),
                      sem: Semiring = actions.SSSP,
                      init_changed=None, device=None, arrays=None):
    """Sharded laned execution; layout and call form as in
    ``engine.run_sharded`` (the full (S, R_max, Q) ``init_val`` on every
    rank).  ``init_changed`` optionally seeds the first frontier
    (streaming warm starts).  Returns the all-gathered (S, R_max, Q)
    values and the per-lane ``LaneStats``; ``arrays`` as in
    ``engine.run_sharded``."""
    q = init_val.shape[-1]
    unitw = np.zeros(q, np.int32) if lane_unitw is None else lane_unitw
    fn, sg = make_sharded_lanes_fn(
        part.S, part.R_max, q, mesh, axis_names, cfg, sem,
        with_init_changed=init_changed is not None)
    dev = engine.resolve_device(device)
    arrays = engine.shard_arrays(part, sg, dev, arrays)
    val = engine.shard_rows(init_val, sg, dev, torch.float32)
    rest = () if init_changed is None else (
        engine.shard_rows(init_changed, sg, dev, torch.bool),)
    val, stats = fn(arrays, val, unitw, *rest)
    return exchange.collectives.all_gather(val, sg), stats


def make_sharded_ppr_round(S: int, R_max: int, mesh,
                           axis_names=("data", "model"),
                           cfg: EngineConfig = EngineConfig()):
    """One sharded laned PPR round as ``(fn, group)``: ``fn(arrays, val,
    base, damping, live)`` -> (new val, (Q,) max-abs delta, (Q,) counts)
    on this shard's (1, R_max, Q) tables, the delta maxed and the counts
    summed over the shards — ``make_ppr_round`` over real collectives."""
    _check_cfg(cfg)
    cfg = engine._sharded_cfg(cfg, "make_sharded_ppr_round")
    sg = engine.shard_group(S, mesh, axis_names)
    sem = actions.PAGERANK

    def fn(arrays, val, base, damping, live):
        sv = arrays.slot_valid[..., None]
        chg = sv & live
        total_in, counts = exchange.shard_total_in(
            sem, arrays, cfg, S, R_max, sg, exchange.shard_gather(val, sg),
            exchange.shard_gather(chg, sg))
        new = torch.where(sv, base + damping * total_in, 0.0)
        new = torch.where(live, new, val)
        delta = exchange.collectives.pmax((new - val).abs().amax(dim=(0, 1)),
                                          sg)
        return new, delta, exchange.collectives.psum(
            counts.to(torch.int64), sg)

    return fn, sg


def make_sharded_ppr_delta_round(S: int, R_max: int, mesh,
                                 axis_names=("data", "model"),
                                 cfg: EngineConfig = EngineConfig()):
    """One sharded laned delta-PPR round as ``(fn, group)``: ``fn(arrays,
    rank, delta, damping, tol)`` -> (rank, delta, changed, (Q,) counts
    summed over the shards) on this shard's (1, R_max, Q) tables — the
    sharded twin of ``make_ppr_delta_round`` (each lane diffuses only
    residuals above its own tolerance)."""
    _check_cfg(cfg)
    cfg = engine._sharded_cfg(cfg, "make_sharded_ppr_delta_round")
    sg = engine.shard_group(S, mesh, axis_names)
    sem = actions.PAGERANK

    def fn(arrays, rank, delta, damping, tol):
        sv = arrays.slot_valid[..., None]
        chg = (delta.abs() > tol) & sv
        total_in, counts = exchange.shard_total_in(
            sem, arrays, cfg, S, R_max, sg,
            exchange.shard_gather(delta, sg), exchange.shard_gather(chg, sg))
        new_delta = torch.where(sv, damping * total_in, 0.0)
        new_chg = (new_delta.abs() > tol) & sv
        return rank + new_delta, new_delta, new_chg, \
            exchange.collectives.psum(counts.to(torch.int64), sg)

    return fn, sg


# --------------------------------------------------------------------------
# personalized-PageRank lanes (sum semiring, per-lane seed/damping)
# --------------------------------------------------------------------------

def make_ppr_round(part: Partition, cfg: EngineConfig = EngineConfig(),
                   arrays: DeviceArrays | None = None, device=None):
    """Builds the laned PPR round: (val, base, damping, live) ->
    (new_val, (Q,) max-abs delta, (Q,) message counts).  Pass ``arrays``
    to share one device copy of the static tables.

    One round is relax(mul_w) -> dense exchange -> rhizome-collapse(+)
    over the inbox -> per-lane damping update ``base + d_q * total_in``;
    ``base`` is the per-lane personalization table (``ppr_base_table``).
    ``live`` (Q,) freezes converged lanes: their frontier column is masked
    off (they cost no messages) and their values carry through."""
    _check_cfg(cfg)
    if arrays is None:
        arrays = DeviceArrays.from_partition(part, engine.resolve_device(
            device))
    S, R_max = part.S, part.R_max
    sem = actions.PAGERANK
    total = S * R_max
    sv = arrays.slot_valid[..., None]

    def round_fn(val, base, damping, live):
        q = val.shape[-1]
        gchg = (sv & live).reshape(total, q)
        total_in, counts = exchange.stacked_total_in(
            sem, arrays, cfg, S, R_max, val.reshape(total, q), gchg)
        new = torch.where(sv, base + damping * total_in, 0.0)
        new = torch.where(live, new, val)
        delta = (new - val).abs().amax(dim=(0, 1))
        return new, delta, counts

    return round_fn


def run_ppr_lanes(part: Partition, seeds, dampings,
                  cfg: EngineConfig = EngineConfig(), tol: float = 1e-6,
                  max_rounds: int = 256, device=None):
    """Lane-batched personalized PageRank to tolerance.  ``seeds``: one
    personalization vertex per lane; ``dampings``: per-lane damping
    (scalar broadcasts).  A lane converges when its max-abs score delta
    drops to ``tol``; live lanes keep the shared round busy (one host
    sync per round tests them).  Returns ((S, R_max, Q) scores, per-lane
    ``LaneStats``)."""
    _check_cfg(cfg)
    dev = engine.resolve_device(device)
    q = len(seeds)
    dampings = np.broadcast_to(np.asarray(dampings, np.float32), (q,)).copy()
    base = torch.as_tensor(ppr_base_table(part, seeds, dampings), device=dev)
    val = torch.as_tensor(np.stack(
        [engine.init_values(part, actions.PAGERANK, {int(s): 1.0})
         for s in seeds], axis=-1).astype(np.float32), device=dev)
    arrays = DeviceArrays.from_partition(part, dev)
    round_fn = make_ppr_round(part, cfg, arrays)
    vol = _volume(part, cfg)
    n_slots = arrays.slot_valid.sum()
    damp = torch.as_tensor(dampings, device=dev)
    live = torch.ones(q, dtype=torch.bool, device=dev)
    stats = _zero_stats(q, dev)
    it = 0
    while it < max_rounds and bool(live.any()):
        val, delta, counts = round_fn(val, base, damp, live)
        stats = _add_stats(stats, live, counts, live * n_slots, vol)
        live = live & (delta > tol)
        it += 1
    return val, stats


def make_ppr_delta_round(part: Partition,
                         cfg: EngineConfig = EngineConfig(),
                         arrays: DeviceArrays | None = None, device=None):
    """Builds the laned **delta-PPR** round: (rank, delta, damping, tol,
    worklist) -> (new_rank, new_delta, new_changed, (Q,) counts) — the
    laned twin of ``exchange.delta_pagerank_round_stacked``: each lane
    propagates only residual deltas above its own tolerance, so the
    per-lane frontier — and with it the OR-across-lanes chunk skip and
    any worklist launch — shrinks as lanes converge."""
    _check_cfg(cfg)
    if arrays is None:
        arrays = DeviceArrays.from_partition(part, engine.resolve_device(
            device))
    S, R_max = part.S, part.R_max
    sem = actions.PAGERANK
    total = S * R_max
    sv = arrays.slot_valid[..., None]

    def round_fn(rank, delta, damping, tol, worklist=None):
        q = rank.shape[-1]
        chg = (delta.abs() > tol) & sv
        total_in, counts = exchange.stacked_total_in(
            sem, arrays, cfg, S, R_max, delta.reshape(total, q),
            chg.reshape(total, q), worklist=worklist)
        new_delta = torch.where(sv, damping * total_in, 0.0)
        new_chg = (new_delta.abs() > tol) & sv
        return rank + new_delta, new_delta, new_chg, counts

    return round_fn


def run_ppr_delta_lanes(part: Partition, seeds, dampings,
                        cfg: EngineConfig = EngineConfig(), tol=1e-7,
                        max_rounds: int = 256, device=None):
    """Lane-batched delta-PPR to tolerance: like ``run_ppr_lanes`` but
    push-based over residuals — a lane's frontier is the slots whose
    delta still exceeds its ``tol`` (scalar broadcasts; per-lane array
    accepted), so late rounds diffuse only the few still-hot vertices of
    the few still-live lanes.  Host-driven under 'dense' / 'worklist' /
    'auto' (the frontier test and any plan read the frontier each round);
    windows of ``cfg.device_window`` rounds under 'device_worklist'.
    Returns ((S, R_max, Q) ranks, per-lane ``LaneStats``)."""
    _check_cfg(cfg)
    dev = engine.resolve_device(device)
    q = len(seeds)
    dampings = np.broadcast_to(np.asarray(dampings, np.float32), (q,)).copy()
    tols = np.broadcast_to(np.asarray(tol, np.float32), (q,)).copy()
    base = torch.as_tensor(ppr_base_table(part, seeds, dampings), device=dev)
    arrays = DeviceArrays.from_partition(part, dev)
    round_fn = make_ppr_delta_round(part, cfg, arrays)
    planner = engine.launch_planner(part, cfg, q_pad=q) \
        if cfg.wants_worklist else None
    vol = _volume(part, cfg)
    damp = torch.as_tensor(dampings, device=dev)
    tol_t = torch.as_tensor(tols, device=dev)
    sv = arrays.slot_valid[..., None]

    def frontier(state):
        return state[2]

    def step(state, wl):
        rank, delta, chg, stats = state
        live = chg.reshape(-1, q).any(dim=0)
        rank, delta, chg, counts = round_fn(rank, delta, damp, tol_t, wl)
        return rank, delta, chg, _add_stats(
            stats, live, counts, chg.reshape(-1, q).sum(dim=0), vol)

    state = (base, base, (base.abs() > tol_t) & sv, _zero_stats(q, dev))
    if cfg.wants_device_worklist:
        state = _window_loop("ppr_delta_lanes", cfg, max_rounds, frontier,
                             step, state)
    else:
        state = _host_loop("ppr_delta_lanes", planner, cfg, max_rounds,
                           frontier, step, state)
    return state[0], state[3]


# --------------------------------------------------------------------------
# lane state builders
# --------------------------------------------------------------------------

def init_lane_values(part: Partition, queries) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Builds ((S, R_max, Q) init values, (Q,) lane_unitw) for a batch of
    min-semiring queries.  ``queries``: list of ("bfs" | "sssp",
    sources) where sources is a vertex, a list of vertices (multi-source:
    all seeded at 0), or a {vertex: value} dict."""
    vals, unitw = [], []
    for kind, sources in queries:
        if kind not in ("bfs", "sssp"):
            raise ValueError(f"unknown min-lane query kind {kind!r}")
        if isinstance(sources, dict):
            src = {int(v): float(x) for v, x in sources.items()}
        elif isinstance(sources, (list, tuple, np.ndarray)):
            src = {int(v): 0.0 for v in sources}
        else:
            src = {int(sources): 0.0}
        vals.append(engine.init_values(part, actions.SSSP, src))
        unitw.append(1 if kind == "bfs" else 0)
    return (np.stack(vals, axis=-1).astype(np.float32),
            np.asarray(unitw, np.int32))


def ppr_base_table(part: Partition, seeds, dampings) -> np.ndarray:
    """(S, R_max, Q) per-lane personalization base: (1 - d_q) at every
    replica of lane q's seed vertex (consistent view), 0 elsewhere."""
    q = len(seeds)
    dampings = np.broadcast_to(np.asarray(dampings, np.float32), (q,))
    cols = [engine.init_values(part, actions.PAGERANK,
                               {int(s): float(1.0 - d)})
            for s, d in zip(seeds, dampings)]
    return np.stack(cols, axis=-1).astype(np.float32)
