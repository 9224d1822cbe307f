"""Crash-safe fixpoint runner.

Pregel-lineage systems checkpoint at superstep boundaries because round
boundaries are the natural consistency points; the round machinery
(``repro_torch.exchange``) already exposes them.  This module wraps the
per-round exchange compositions in a host-driven runner that adds, at
every round boundary:

1. **chaos injection** — a seedable ``runtime.chaos.ChaosPlan`` fires
   engine-level faults (shard kills, dropped/duplicated inboxes,
   corrupted value tiles, delayed shards) deterministically;
2. **detection** — three independent detectors, each surfacing a typed
   ``FaultDetected``:
   * a **crc scrub** of the per-shard value rows against the previous
     round boundary (corrupted tiles);
   * the **host counter mirror** ``exchange.expected_round_messages``:
     a round whose reported message count disagrees with the mirror
     dropped or duplicated an inbox;
   * the ``runtime.elastic.ShardPool`` **heartbeat window** (killed
     shards; delayed shards inside the window never trip it);
3. **recovery** — the ``RecoveryPolicy`` ladder: bounded same-round
   retry for transient faults, re-dispatch from the last checkpoint for
   state-loss faults (round 0's initial state is the implicit
   checkpoint), shard-pool **shrink** (rebuild the partition on the
   survivors and migrate per-vertex values), and finally graceful
   degradation to a typed ``'degraded'`` partial result;
4. **checkpointing** — every ``EngineConfig.checkpoint_every`` rounds
   the runner hands {value tables, frontier, accounting counters} to a
   ``CheckpointManager`` (async, atomic, crc-verified).  Counters ride
   in the checkpoint so a restored run's message totals equal an
   uninterrupted run's exactly.

Each task holds its tables on ``device`` (``None``: CUDA) and runs one
round a dispatch through the fused kernels when ``cfg.use_pallas``
(K1/K2 stacked, K3/K4 laned; K9 under ``pallas_mode='reduce'``).  A
task's ``DeviceArrays`` — and so its launch plan — is made from the
partition it runs on and made again when ``shrink`` rebuilds it.  The
scrub and the frontier tests read the tables to the host between
rounds; the checkpoint manager copies a snapshot's tensors to the host
before its writer thread starts.

Min-semiring fixpoints restored from any round boundary are
BIT-IDENTICAL to an uninterrupted run (monotone relaxation from
intermediate upper bounds reconverges to the same fixpoint, and the
replayed rounds are the same deterministic dispatches); sum-semiring
(delta-PageRank) runs agree within reassociation tolerance.
``ShardedTask`` runs the sharded layout: every rank drives the same
runner (the same chaos plan and policy, each with its own checkpoint
manager, which keeps that rank's shard), and what the detectors read —
the frontier, the crc scrub's value rows, the message count — is
gathered or summed over the shards, so every rank takes the same
decisions.
"""
from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from repro_torch import exchange, obs
from repro_torch.core import engine
from repro_torch.core.actions import Semiring
from repro_torch.core.engine import DeviceArrays, EngineConfig
from repro_torch.core.partition import Partition, build_partition
from repro_torch.runtime.chaos import (
    ChaosPlan, FaultDetected, FaultEventRecord, FixpointReport,
    RecoveryPolicy)
from repro_torch.runtime.elastic import ShardPool


# --------------------------------------------------------------------------
# per-shard crc scrub
# --------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def shard_crcs(arrays_host) -> list[list[int]]:
    """Per-shard crc32 of each (S, ...) value table (tensors are read to
    the host) — the round-boundary integrity fingerprint the scrub
    compares against."""
    out = []
    for h in arrays_host:
        h = _host(h)
        out.append([zlib.crc32(np.ascontiguousarray(h[s]).tobytes())
                    for s in range(h.shape[0])])
    return out


def _scrub_mismatch(before, now):
    """First (table, shard) whose crc changed since the last boundary,
    else None."""
    for t, (a, b) in enumerate(zip(before, now)):
        for s, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return t, s
    return None


def _set_rows(table, s: int, value):
    """``table`` with shard ``s``'s rows set to ``value``, as a new
    tensor (the caller's state, and any in-memory checkpoint sharing
    it, keep the original)."""
    out = table.clone()
    out[s] = value
    return out


# --------------------------------------------------------------------------
# task layouts: stacked / laned runners over one recovery core
# --------------------------------------------------------------------------

class StackedTask:
    """Single-device stacked min-semiring fixpoint (the ``run_stacked``
    layout) under the resilient runner.  ``graph`` (optional COOGraph)
    enables the ``on_dead='shrink'`` path — the partition is rebuilt on
    the surviving shards and per-vertex values migrate."""

    laned = False
    records = True

    def __init__(self, sem: Semiring, part: Partition, init_val,
                 cfg: EngineConfig = EngineConfig(), init_changed=None,
                 graph=None, device=None):
        if sem.segment != "min":
            raise ValueError("StackedTask drives min-semiring fixpoints; "
                             "use PagerankTask for counted sum rounds")
        self.sem = sem
        self.part = part
        self.cfg = cfg
        self.name = sem.name
        self.graph = graph
        self.device = engine.resolve_device(device)
        self._init_val = init_val
        self._init_changed = init_changed
        self._bind(part)

    def _bind(self, part: Partition):
        self.part = part
        self.arrays = DeviceArrays.from_partition(part, self.device)

    def init_state(self) -> dict:
        val = torch.as_tensor(self._init_val, dtype=torch.float32,
                              device=self.device)
        if self._init_changed is not None:
            chg = torch.as_tensor(self._init_changed, dtype=torch.bool,
                                  device=self.device) & self.arrays.slot_valid
        else:
            chg = self.sem.improved(
                val, torch.full_like(val, self.sem.identity)
            ) & self.arrays.slot_valid
        return {"val": val, "chg": chg}

    def dispatch(self, state, wl):
        part = self.part
        val, chg, mc = exchange.fixpoint_round_stacked(
            self.sem, self.arrays, self.cfg, part.S, part.R_max,
            state["val"], state["chg"], worklist=wl)
        return {"val": val, "chg": chg}, mc

    def host_frontier(self, state):
        return _host(state["chg"])

    def plan_frontier(self, chg_h):
        return chg_h.reshape(-1)

    def drop_shard(self, state, s: int):
        return {**state,
                "chg": exchange.mask_shard_frontier(state["chg"], s)}

    def corrupt_shard(self, state, s: int):
        return {**state, "val": _set_rows(state["val"], s, -7.25)}

    def crc_arrays(self, state):
        return [state["val"]]

    def put(self, host_state):
        return {"val": torch.as_tensor(host_state["val"],
                                       dtype=torch.float32,
                                       device=self.device),
                "chg": torch.as_tensor(host_state["chg"], dtype=torch.bool,
                                       device=self.device)}

    def finalize(self, state):
        val = state["val"]
        if self.cfg.collapse == "deferred":
            val = exchange.collapse(self.sem, val.reshape(-1),
                                    self.arrays.sibling_flat,
                                    self.arrays.sibling_mask)
        return val

    # ------------------------------------------------------------- shrink
    @property
    def can_shrink(self) -> bool:
        return self.graph is not None

    def shrink(self, survivors: int, ckpt_val):
        """Rebuild on ``survivors`` shards; migrate per-vertex values
        from the (checkpointed) old layout and re-seed the full finite
        frontier so the min fixpoint reconverges from its upper bounds.
        Returns the new partition (the caller's pool/planner rebind)."""
        old_part = self.part
        new_part, _ = shrink_partition(self.graph, old_part.cfg, survivors)
        self._init_val = migrate_values(old_part, ckpt_val, new_part,
                                        self.sem)
        self._init_changed = None
        self._bind(new_part)
        return new_part


class PagerankTask:
    """Stacked delta-PageRank (sum semiring) under the resilient runner.
    Restores agree with uninterrupted runs within reassociation
    tolerance (the replayed rounds are the same launches, so in practice
    replay is bit-exact on one device — the looser contract is what the
    differential suite asserts)."""

    laned = False
    records = True

    def __init__(self, part: Partition, damping: float = 0.85, tol=1e-6,
                 cfg: EngineConfig = EngineConfig(), max_rounds: int = 256,
                 init_rank=None, init_delta=None, device=None):
        from repro_torch.core.actions import PAGERANK as sem
        self.sem = sem
        self.part = part
        self.cfg = cfg
        self.name = "pagerank_delta"
        self.damping = damping
        self.max_rounds = max_rounds
        self.device = engine.resolve_device(device)
        self.arrays = DeviceArrays.from_partition(part, self.device)
        self.tol_t = engine._tol_table(part, tol, self.device)
        base = (1.0 - damping) / part.n
        if init_rank is None:
            self._rank0 = self._delta0 = torch.where(
                self.arrays.slot_valid, base, 0.0)
        else:
            self._rank0 = torch.as_tensor(init_rank, dtype=torch.float32,
                                          device=self.device)
            self._delta0 = torch.as_tensor(init_delta, dtype=torch.float32,
                                           device=self.device)

    def init_state(self) -> dict:
        chg = (self._delta0.abs() > self.tol_t) & self.arrays.slot_valid
        return {"rank": self._rank0, "delta": self._delta0, "chg": chg}

    def dispatch(self, state, wl):
        part = self.part
        rank, delta, chg, mc = exchange.delta_pagerank_round_stacked(
            self.sem, self.arrays, self.cfg, part.S, part.R_max,
            self.damping, self.tol_t, state["rank"], state["delta"],
            worklist=wl)
        return {"rank": rank, "delta": delta, "chg": chg}, mc

    def host_frontier(self, state):
        return _host(state["chg"])

    def plan_frontier(self, chg_h):
        return chg_h.reshape(-1)

    def drop_shard(self, state, s: int):
        # zeroing the residual rows both silences shard s's messages and
        # models the lost value mass a dropped inbox implies
        return {**state, "delta": _set_rows(state["delta"], s, 0.0),
                "chg": exchange.mask_shard_frontier(state["chg"], s)}

    def corrupt_shard(self, state, s: int):
        return {**state, "delta": _set_rows(state["delta"], s, 0.123)}

    def crc_arrays(self, state):
        return [state["rank"], state["delta"]]

    def put(self, host_state):
        def put(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=self.device)
        return {"rank": put(host_state["rank"], torch.float32),
                "delta": put(host_state["delta"], torch.float32),
                "chg": put(host_state["chg"], torch.bool)}

    def finalize(self, state):
        return state["rank"]

    can_shrink = False


class LanesTask:
    """Lane-batched min fixpoint (the ``query.lanes`` (S, R_max, Q)
    layout) under the resilient runner — the serving pools' restore
    path drives this shape.  Per-round message counts are per-lane;
    the counter-mirror detector compares their lane-summed total."""

    laned = True
    records = False

    def __init__(self, part: Partition, init_val, lane_unitw=None,
                 cfg: EngineConfig = EngineConfig(), init_changed=None,
                 sem: Semiring = None, device=None):
        from repro_torch.core import actions
        from repro_torch.query import lanes as lanes_mod
        sem = actions.SSSP if sem is None else sem
        lanes_mod._check_cfg(cfg)
        lanes_mod._check_min(sem)
        self.sem = sem
        self.part = part
        self.cfg = cfg
        self.name = "lanes_min"
        self.device = engine.resolve_device(device)
        self.arrays = DeviceArrays.from_partition(part, self.device)
        init_val = torch.as_tensor(init_val, dtype=torch.float32,
                                   device=self.device)
        if init_val.dim() != 3:
            raise ValueError(f"init_val must be (S, R_max, Q); got "
                             f"{tuple(init_val.shape)}")
        self.q = init_val.shape[-1]
        self._init_val = init_val
        self._init_changed = init_changed
        unitw = (np.zeros(self.q, np.int32) if lane_unitw is None
                 else np.asarray(lane_unitw, np.int32).reshape(self.q))
        self.lane_unitw = torch.as_tensor(unitw, device=self.device)
        # the planner prices a launch of the call's Q lanes, as the laned
        # runners' launches do (this port pads no lanes)
        self.q_pad = self.q

    def init_state(self) -> dict:
        val = self._init_val
        slot = self.arrays.slot_valid[..., None]
        if self._init_changed is not None:
            chg = torch.as_tensor(self._init_changed, dtype=torch.bool,
                                  device=self.device) & slot
        else:
            chg = self.sem.improved(
                val, torch.full_like(val, self.sem.identity)) & slot
        return {"val": val, "chg": chg}

    def dispatch(self, state, wl):
        part = self.part
        val, chg, counts = exchange.fixpoint_round_stacked(
            self.sem, self.arrays, self.cfg, part.S, part.R_max,
            state["val"], state["chg"], lane_unitw=self.lane_unitw,
            worklist=wl)
        return {"val": val, "chg": chg}, counts

    def host_frontier(self, state):
        return _host(state["chg"])

    def plan_frontier(self, chg_h):
        return chg_h.reshape(-1, self.q).any(axis=1)

    def drop_shard(self, state, s: int):
        return {**state,
                "chg": exchange.mask_shard_frontier(state["chg"], s)}

    def corrupt_shard(self, state, s: int):
        return {**state, "val": _set_rows(state["val"], s, -7.25)}

    def crc_arrays(self, state):
        return [state["val"]]

    def put(self, host_state):
        return {"val": torch.as_tensor(host_state["val"],
                                       dtype=torch.float32,
                                       device=self.device),
                "chg": torch.as_tensor(host_state["chg"], dtype=torch.bool,
                                       device=self.device)}

    def finalize(self, state):
        return state["val"]

    can_shrink = False


class ShardedTask:
    """Sharded min fixpoint over a ``DeviceMesh`` under the resilient
    runner: a round a dispatch of the sharded round
    (``exchange.make_shard_fixpoint_round``) with its message count
    summed over the shards, so the same chaos detectors and recovery
    ladder apply over real collectives.  Every rank builds the same task
    and runs ``run_resilient`` with it; the state is this shard's (1,
    R_max) rows (a checkpoint holds them), the frontier and the scrubbed
    values are gathered, and a fault on shard s touches shard s's rows.
    Host-planned worklist modes run as ``device_worklist``
    (``engine._sharded_cfg``)."""

    laned = False
    records = False

    def __init__(self, sem: Semiring, part: Partition, init_val, mesh,
                 axis_names=("data", "model"),
                 cfg: EngineConfig = EngineConfig(), device=None):
        if sem.segment != "min":
            raise ValueError("ShardedTask drives min-semiring fixpoints")
        self.sem = sem
        self.part = part
        self.cfg = engine._sharded_cfg(cfg, "ShardedTask")
        self.name = f"{sem.name}_sharded"
        self.mesh = mesh
        self.device = engine.resolve_device(device)
        self.sg = engine.shard_group(part.S, mesh, axis_names)
        self.arrays = engine.shard_arrays(part, self.sg, self.device)
        self._round = exchange.make_shard_fixpoint_round(
            sem, self.arrays, self.cfg, part.S, part.R_max, self.sg)
        self._init_val = np.asarray(init_val, np.float32)

    def init_state(self) -> dict:
        val = engine.shard_rows(self._init_val, self.sg, self.device,
                                torch.float32)
        chg = self.sem.improved(val, torch.full_like(
            val, self.sem.identity)) & self.arrays.slot_valid
        return {"val": val, "chg": chg}

    def dispatch(self, state, wl):
        # wl is always None: a sharded round plans no host worklist
        val, chg, mc = self._round(state["val"], state["chg"])
        return {"val": val, "chg": chg}, exchange.collectives.psum(
            mc.to(torch.int64), self.sg)

    def _gathered(self, table) -> np.ndarray:
        return _host(exchange.collectives.all_gather(table, self.sg))

    def host_frontier(self, state):
        return self._gathered(state["chg"])

    def plan_frontier(self, chg_h):
        return chg_h.reshape(-1)

    def drop_shard(self, state, s: int):
        if s != self.sg.rank:
            return state
        return {**state, "chg": torch.zeros_like(state["chg"])}

    def corrupt_shard(self, state, s: int):
        if s != self.sg.rank:
            return state
        return {**state, "val": torch.full_like(state["val"], -7.25)}

    def crc_arrays(self, state):
        return [self._gathered(state["val"])]

    def put(self, host_state):
        return {"val": torch.as_tensor(host_state["val"],
                                       dtype=torch.float32,
                                       device=self.device),
                "chg": torch.as_tensor(host_state["chg"], dtype=torch.bool,
                                       device=self.device)}

    def finalize(self, state):
        return exchange.collectives.all_gather(state["val"], self.sg)

    can_shrink = False


# --------------------------------------------------------------------------
# shard-pool shrink
# --------------------------------------------------------------------------

def shrink_partition(g, pcfg, survivors: int):
    """The surviving-layout rebuild after a shard death: the
    counter-hashed placement is a pure function of (graph, config), so
    the shrunken partition is BY CONSTRUCTION field-for-field equal to a
    from-scratch ``build_partition`` at the smaller shard count — the
    equality the elastic tests assert against an independent build.
    Returns (new partition, new config)."""
    if survivors < 1:
        raise ValueError("cannot shrink to zero shards")
    new_cfg = dataclasses.replace(pcfg, num_shards=survivors,
                                  mesh_dims=None)
    return build_partition(g, new_cfg), new_cfg


def migrate_values(old_part: Partition, old_val, new_part: Partition,
                   sem: Semiring) -> np.ndarray:
    """Per-vertex value migration across layouts: read each vertex's
    root-replica value on the old partition, write it to every replica
    slot of the new one (consistent initial view).  For min semirings
    the migrated values are valid upper bounds, so re-running the
    fixpoint from them (full frontier) reconverges exactly."""
    vv = engine.vertex_values(old_part, old_val)
    sv = np.asarray(new_part.slot_vertex)
    fill = sem.identity if sem.segment == "min" else 0.0
    return np.where(sv >= 0, vv[np.maximum(sv, 0)],
                    fill).astype(np.float32)


# --------------------------------------------------------------------------
# obs accounting
# --------------------------------------------------------------------------

def _count_fault(run: str, kind: str):
    obs.registry().counter(
        "engine_faults_total",
        "engine-level faults detected (crc / counter mirror / heartbeat)"
    ).labels(run=run, kind=kind).inc()


def _count_recovery(run: str, kind: str, action: str):
    obs.registry().counter(
        "engine_recoveries_total",
        "fault recoveries by action (retry / restore / shrink / degrade)"
    ).labels(run=run, kind=kind, action=action).inc()


# --------------------------------------------------------------------------
# the resilient runner
# --------------------------------------------------------------------------

def run_resilient(task, *, chaos: ChaosPlan | None = None,
                  policy: RecoveryPolicy | None = None, manager=None,
                  max_rounds: int | None = None):
    """Drive ``task``'s fixpoint to convergence under chaos, with
    checkpoint/restore recovery.  Returns ``(result, RunStats,
    FixpointReport)`` — the result/stats match the equivalent shipped
    runner exactly when no fault fires, and after recovery the
    min-semiring result AND the accounting totals equal an
    uninterrupted run's (counters ride in the checkpoint tree).

    ``manager``: an optional ``CheckpointManager`` (this package's, or
    any object with its ``save``/``wait``/``restore``); snapshots are
    taken every ``task.cfg.checkpoint_every`` rounds (async, atomic,
    crc-verified).  Without one, round 0's initial state serves as the
    implicit in-memory checkpoint.  ``RunStats`` come back as int64
    tensors on the task's device."""
    policy = policy or RecoveryPolicy()
    cfg = task.cfg
    K = cfg.checkpoint_every
    max_iters = (max_rounds if max_rounds is not None
                 else getattr(task, "max_rounds", cfg.max_iters))
    rec = obs.get_recorder()
    acct = obs.round_recorder()     # per-round records and round spans
    report = FixpointReport()
    part = task.part

    planner = (engine.launch_planner(part, cfg,
                                     q_pad=getattr(task, "q_pad", 1))
               if (cfg.wants_worklist
                   or (acct is not None and task.records and cfg.use_pallas
                       and cfg.pallas_mode == "fused"))
               else None)

    pool = ShardPool(part.S, window=policy.heartbeat_window)
    pool.heartbeat_all(0)
    state = task.init_state()
    counters = {"it": 0, "msgs": 0, "work": 0, "pruned": 0}
    mem_ckpt = (dict(state), dict(counters))
    scrub = chaos is not None
    crc = shard_crcs(task.crc_arrays(state)) if scrub else None
    killed: set[int] = set()
    delayed: dict[int, int] = {}
    retries_this_round = 0
    last_good_step: int | None = None
    degraded = False

    def ckpt_tree(st, cts):
        return {"state": st,
                "counters": {k: np.int64(v) for k, v in cts.items()}}

    def save_ckpt():
        nonlocal last_good_step
        t0 = time.perf_counter()
        manager.save(counters["it"], ckpt_tree(state, counters),
                     blocking=False,
                     meta={"round": counters["it"], "run": task.name,
                           "S": part.S, "R_max": part.R_max})
        report.checkpoint_write_s += time.perf_counter() - t0
        report.checkpoints_written += 1
        last_good_step = counters["it"]

    def record_fault(kind, shard, rnd, action, lost=0):
        report.faults.append(FaultEventRecord(
            kind=kind, shard=shard, round=rnd, action=action,
            rounds_lost=lost))
        _count_fault(task.name, kind)
        _count_recovery(task.name, kind, action)
        if rec is not None:
            rec.tracer.instant("fault", track="engine/faults", kind=kind,
                               shard=shard, round=rnd, action=action)

    def degrade(kind, shard, rnd):
        nonlocal degraded
        record_fault(kind, shard, rnd, "degrade")
        if not policy.degrade:
            raise FaultDetected(kind, shard, rnd,
                                "recovery budget exhausted")
        degraded = True

    def restore(kind, shard, rnd):
        """Re-dispatch from the last checkpoint (or round 0)."""
        nonlocal state, counters, crc, retries_this_round
        if report.restores >= policy.max_restores:
            degrade(kind, shard, rnd)
            return
        t0 = time.perf_counter()
        report.restores += 1
        rounds_before = counters["it"]
        restored = False
        if manager is not None and last_good_step is not None:
            manager.wait()
            tree = manager.restore(last_good_step,
                                   ckpt_tree(state, counters))
            state = task.put(tree["state"])
            counters = {k: int(v) for k, v in tree["counters"].items()}
            restored = True
        if not restored:
            state = dict(mem_ckpt[0])
            counters = dict(mem_ckpt[1])
        lost = max(rounds_before - counters["it"], 0)
        report.rounds_lost += lost
        killed.clear()
        delayed.clear()
        pool.revive_all(counters["it"])
        pool.heartbeat_all(counters["it"])
        crc = shard_crcs(task.crc_arrays(state)) if scrub else None
        retries_this_round = 0
        dt = time.perf_counter() - t0
        report.recovery_s += dt
        record_fault(kind, shard, rnd, "restore", lost)
        if rec is not None:
            now = rec.tracer.now()
            rec.tracer.complete("recovery", track="engine/faults",
                                start=now - dt, end=now, kind=kind)

    def shrink(kind, dead, rnd):
        """Rebuild the partition on the survivors; migrate values from
        the last checkpoint and reconverge on the smaller layout."""
        nonlocal state, counters, crc, planner, part, pool, \
            retries_this_round, last_good_step
        t0 = time.perf_counter()
        report.restores += 1
        rounds_before = counters["it"]
        ckpt_state, ckpt_counters = mem_ckpt
        if manager is not None and last_good_step is not None:
            manager.wait()
            tree = manager.restore(last_good_step,
                                   ckpt_tree(state, counters))
            ckpt_state = task.put(tree["state"])
            ckpt_counters = {k: int(v)
                             for k, v in tree["counters"].items()}
        survivors = part.S - len(dead)
        part = task.shrink(survivors, ckpt_state["val"])
        state = task.init_state()
        counters = dict(ckpt_counters)
        pool = ShardPool(part.S, window=policy.heartbeat_window)
        pool.heartbeat_all(counters["it"])
        planner = (engine.launch_planner(part, cfg)
                   if planner is not None else None)
        killed.clear()
        delayed.clear()
        crc = shard_crcs(task.crc_arrays(state)) if scrub else None
        retries_this_round = 0
        lost = max(rounds_before - counters["it"], 0)
        report.rounds_lost += lost
        last_good_step = None
        if manager is not None and K:
            save_ckpt()          # fresh shapes: stale steps never load
        report.recovery_s += time.perf_counter() - t0
        record_fault(kind, dead[0] if dead else None, rnd, "shrink", lost)

    while not degraded and counters["it"] < max_iters:
        chg_h = task.host_frontier(state)
        if not chg_h.any():
            # a corruption landing exactly on convergence must not slip
            # out as a clean result — final scrub before returning
            if scrub:
                m = _scrub_mismatch(crc,
                                    shard_crcs(task.crc_arrays(state)))
                if m is not None:
                    kind = ("kill_shard" if m[1] in killed
                            else "corrupt_tile")
                    restore(kind, m[1], counters["it"])
                    continue
            if killed and pool.dead() == [] and not degraded:
                # killed shards whose window hasn't elapsed by
                # convergence: the rounds since their death are suspect
                restore("kill_shard", sorted(killed)[0], counters["it"])
                continue
            break
        rnd = counters["it"] + 1

        # ---- chaos injection for this round (corruption lands between
        # round boundaries; the boundary scrub below is what catches it)
        pending_drop = pending_dup = None
        if chaos is not None:
            for e in chaos.events_at(rnd):
                chaos.mark_fired(e)
                if e.kind == "kill_shard":
                    killed.add(e.shard)
                elif e.kind == "corrupt_tile":
                    state = task.corrupt_shard(state, e.shard)
                elif e.kind == "drop_inbox":
                    pending_drop = e.shard
                elif e.kind == "dup_inbox":
                    pending_dup = e.shard
                elif e.kind == "delay_shard":
                    delayed[e.shard] = e.rounds

        # ---- detection: crc scrub over the previous round boundary
        if scrub:
            m = _scrub_mismatch(crc, shard_crcs(task.crc_arrays(state)))
            if m is not None:
                kind = "kill_shard" if m[1] in killed else "corrupt_tile"
                restore(kind, m[1], rnd)
                continue

        # ---- heartbeats + declare-dead
        silent = killed | {s for s, r in delayed.items() if r > 0}
        pool.heartbeat_all(rnd, except_shards=silent)
        for s in list(delayed):
            delayed[s] -= 1
            if delayed[s] <= 0:
                del delayed[s]
        newly_dead = pool.tick(rnd)
        if newly_dead:
            if policy.on_dead == "shrink" and task.can_shrink:
                shrink("kill_shard", newly_dead, rnd)
            else:
                restore("kill_shard", newly_dead[0], rnd)
            continue

        # ---- expected message total on the UNtampered frontier
        expected = (exchange.expected_round_messages(
            part.edge_mask, part.edge_src_root_flat, chg_h,
            laned=task.laned) if (scrub or pending_dup is not None
                                  or pending_drop is not None
                                  or retries_this_round > 0) else None)

        # ---- dispatch (possibly on a tampered frontier)
        dispatch_state = state
        plan_chg = chg_h
        if pending_drop is not None:
            dispatch_state = task.drop_shard(state, pending_drop)
            plan_chg = task.host_frontier(dispatch_state)
        wl = info = None
        if cfg.wants_worklist:
            wl, info = engine.plan_round_worklist(
                planner, cfg, task.plan_frontier(plan_chg),
                with_info=True)
        frontier = int(chg_h.sum()) if acct is not None else 0
        t0 = acct.tracer.now() if acct is not None else 0.0
        span = (acct.tracer.span("round", track=f"engine/{task.name}",
                                 round=rnd) if acct is not None else None)
        new_state, counts = task.dispatch(dispatch_state, wl)
        mc = int(counts.sum())
        reported = mc
        if pending_dup is not None:
            # the duplicated inbox double-counts shard s's deliveries
            if task.laned:
                per_lane = chg_h.reshape(-1, chg_h.shape[-1])
                dup = sum(int(exchange.shard_message_mirror(
                    part.edge_mask, part.edge_src_root_flat,
                    per_lane[:, qq])[pending_dup])
                    for qq in range(per_lane.shape[1]))
            else:
                dup = int(exchange.shard_message_mirror(
                    part.edge_mask, part.edge_src_root_flat,
                    chg_h)[pending_dup])
            reported = mc + dup

        # ---- detection: counter-mirror integrity
        if expected is not None and reported != expected:
            if span is not None:
                span.end(frontier=frontier, messages=reported,
                         fault=True)
            kind = ("drop_inbox" if reported < expected
                    else "dup_inbox")
            if retries_this_round < policy.max_retries:
                retries_this_round += 1
                report.retries += 1
                record_fault(kind, pending_drop
                             if pending_drop is not None
                             else pending_dup, rnd, "retry")
                continue          # same round, intact pre-round state
            restore(kind, pending_drop if pending_drop is not None
                    else pending_dup, rnd)
            continue

        # ---- commit the round
        retries_this_round = 0
        state = new_state
        chg_next = task.host_frontier(state)
        work = int(chg_next.sum())
        counters["it"] = rnd
        counters["msgs"] += mc
        counters["work"] += work
        counters["pruned"] += mc - min(work, mc)
        if scrub:
            crc = shard_crcs(task.crc_arrays(state))
        if acct is not None:
            wall = acct.tracer.now() - t0
            span.end(frontier=frontier, messages=mc)
            if task.records:
                engine._obs_record_round(
                    acct, task.name, part, cfg, planner, rnd,
                    chg_h.reshape(-1), frontier, mc, work, wl, info,
                    wall)
        if manager is not None and K and counters["it"] % K == 0:
            save_ckpt()

    if manager is not None:
        manager.wait()
    engine._count_dispatches(task.name, counters["it"], counters["it"])
    if degraded:
        report.status = "degraded"
    elif report.faults:
        report.status = "recovered"
    stats = engine._host_stats(counters["it"], counters["msgs"],
                               counters["work"], counters["pruned"],
                               task.device)
    return task.finalize(state), stats, report
