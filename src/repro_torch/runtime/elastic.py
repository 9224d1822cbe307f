"""Elastic scaling + straggler mitigation for 1000+ node fleets.

``ElasticCoordinator`` owns the fleet view: hosts heartbeat every step;
on a missed-heartbeat window the coordinator declares the host dead,
re-factorizes the largest viable mesh from surviving hosts (keeping the
model axis intact — TP is latency-critical; DP shrinks), and the trainer
restores from the latest checkpoint and continues. Because the sharding
rules are mesh-shape agnostic (sharding/specs.py), re-lowering for the
new mesh is mechanical — tests re-lower the same config at 3 fleet sizes.

``StragglerMonitor`` tracks per-host step durations with an EWMA; hosts
slower than ``threshold ×`` the fleet median are flagged for (1) input
bypass (data pipeline substitutes the fallback batch rather than stall),
then (2) eviction after ``patience`` consecutive flags — the two-stage
response of production fleets (bounded staleness first, re-mesh second).

Failures here are *simulated* (no real fleet behind them); the
state machine and mesh math are the deliverable.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostState:
    alive: bool = True
    last_heartbeat: int = 0
    ewma_step_s: float = 0.0
    slow_flags: int = 0


def viable_mesh_shapes(n_hosts: int, devices_per_host: int,
                       model_axis: int) -> list[tuple[int, int, int]]:
    """(pod, data, model) factorizations keeping the model axis intact and
    data a multiple of 2 where possible, largest first."""
    total = n_hosts * devices_per_host
    out = []
    if total % model_axis:
        return out
    rest = total // model_axis
    for pod in (2, 1):
        if rest % pod == 0:
            out.append((pod, rest // pod, model_axis))
    return sorted(set(out), key=lambda s: -s[0] * s[1] * s[2])


class ElasticCoordinator:
    def __init__(self, n_hosts: int, devices_per_host: int,
                 model_axis: int = 16, heartbeat_window: int = 3):
        self.devices_per_host = devices_per_host
        self.model_axis = model_axis
        self.window = heartbeat_window
        self.hosts = {h: HostState() for h in range(n_hosts)}
        self.step = 0
        self.remesh_events: list[dict] = []

    # --- heartbeats ---------------------------------------------------------
    def heartbeat(self, host_id: int, step: int):
        hs = self.hosts[host_id]
        hs.last_heartbeat = step

    def tick(self, step: int) -> bool:
        """Advance coordinator; returns True if a re-mesh is required."""
        self.step = step
        died = []
        for h, hs in self.hosts.items():
            if hs.alive and step - hs.last_heartbeat > self.window:
                hs.alive = False
                died.append(h)
        if died:
            self.remesh_events.append(
                {"step": step, "died": died, "mesh": self.current_mesh_shape()})
            return True
        return False

    def revive(self, host_id: int, step: int):
        """A restarted host rejoins the fleet (recovery after a restore
        re-dispatch): alive again, heartbeat clock reset to ``step``."""
        hs = self.hosts[host_id]
        hs.alive = True
        hs.last_heartbeat = step

    def kill_host(self, host_id: int):
        """Test hook: simulate an abrupt host failure."""
        self.hosts[host_id].alive = False
        self.remesh_events.append(
            {"step": self.step, "died": [host_id],
             "mesh": self.current_mesh_shape()})

    def alive_hosts(self) -> list[int]:
        return [h for h, hs in self.hosts.items() if hs.alive]

    def current_mesh_shape(self) -> tuple[int, int, int] | None:
        """Largest viable (pod, data, model) mesh. Prefers idling surplus
        hosts over shrinking the model axis (TP is latency-critical);
        degrades the model axis only when >10% of the fleet would idle."""
        total = len(self.alive_hosts()) * self.devices_per_host
        best = None
        for m in (self.model_axis, self.model_axis // 2,
                  self.model_axis // 4, 2, 1):
            if m < 1:
                continue
            usable = (total // m) * m
            if usable == 0:
                continue
            shapes = viable_mesh_shapes(
                usable // self.devices_per_host if usable % self.devices_per_host == 0
                else usable, 1 if usable % self.devices_per_host else self.devices_per_host,
                m)
            if not shapes:
                continue
            cand = shapes[0]
            if usable >= 0.9 * total:
                return cand          # keep (or nearly keep) the fleet busy
            if best is None:
                best = cand
        return best


class ShardPool:
    """Graph-shard liveness tracker for the resilient fixpoint runner:
    the multi-host heartbeat/declare-dead state machine above, reused
    one-"host"-per-shard.

    Shards heartbeat every fixpoint round; a shard that misses
    ``window`` consecutive rounds is declared dead at the next
    ``tick()``.  The runner then either restores the same layout from
    the last checkpoint (the dead shard's process restarts — ``revive``)
    or shrinks the shard pool: rebuild the partition on the survivors
    (``core.resilient.shrink_partition``) and migrate per-vertex values.
    A *delayed* shard — missed heartbeats but fewer than the window —
    never trips the machine (stragglers are not failures)."""

    def __init__(self, num_shards: int, window: int = 3):
        self.num_shards = num_shards
        self.coord = ElasticCoordinator(
            n_hosts=num_shards, devices_per_host=1, model_axis=1,
            heartbeat_window=window)

    def heartbeat(self, shard: int, round_: int):
        self.coord.heartbeat(shard, round_)

    def heartbeat_all(self, round_: int, except_shards=()):
        for s in range(self.num_shards):
            if s not in except_shards:
                self.coord.heartbeat(s, round_)

    def tick(self, round_: int) -> list[int]:
        """Advance the round clock; returns shards NEWLY declared dead."""
        before = set(self.alive())
        self.coord.tick(round_)
        return sorted(before - set(self.alive()))

    def alive(self) -> list[int]:
        return self.coord.alive_hosts()

    def dead(self) -> list[int]:
        return [s for s in range(self.num_shards)
                if s not in set(self.alive())]

    def revive(self, shard: int, round_: int):
        self.coord.revive(shard, round_)

    def revive_all(self, round_: int):
        for s in self.dead():
            self.coord.revive(s, round_)


class StragglerMonitor:
    def __init__(self, threshold: float = 1.5, patience: int = 3,
                 alpha: float = 0.3):
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha
        self.hosts: dict[int, HostState] = {}

    def record(self, host_id: int, step_s: float):
        hs = self.hosts.setdefault(host_id, HostState())
        hs.ewma_step_s = (step_s if hs.ewma_step_s == 0.0
                          else self.alpha * step_s
                          + (1 - self.alpha) * hs.ewma_step_s)

    def classify(self) -> dict:
        """{'bypass': [...], 'evict': [...]} — stage-1 input bypass,
        stage-2 eviction recommendation."""
        if not self.hosts:
            return {"bypass": [], "evict": []}
        med = float(np.median([h.ewma_step_s for h in self.hosts.values()]))
        bypass, evict = [], []
        for hid, hs in self.hosts.items():
            if med > 0 and hs.ewma_step_s > self.threshold * med:
                hs.slow_flags += 1
                if hs.slow_flags >= self.patience:
                    evict.append(hid)
                else:
                    bypass.append(hid)
            else:
                hs.slow_flags = 0
        return {"bypass": sorted(bypass), "evict": sorted(evict)}
