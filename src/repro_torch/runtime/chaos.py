"""Engine-level chaos: deterministic fault injection below the serving
layer.

The serving layer's ``FaultPlan`` kills serving lanes at tick
boundaries; this module extends the same deterministic-schedule idea
down into the fixpoint round machinery.  A ``ChaosPlan`` is a seedable
schedule of engine-level fault events keyed on the *round* number:

* ``kill_shard`` — shard ``s`` stops heartbeating and its value/frontier
  rows are lost (detected by the heartbeat window, or by the crc scrub
  when the dead shard's rows were zeroed in place);
* ``drop_inbox`` — shard ``s``'s outgoing frontier rows are masked for
  one round, so downstream shards silently miss messages (detected by
  the host counter mirror: reported messages < expected);
* ``dup_inbox`` — shard ``s``'s messages are double-counted for one
  round (reported messages > the mirror's expectation);
* ``corrupt_tile`` — bytes in shard ``s``'s value table are flipped
  (detected by the crc scrub over the round-boundary value snapshot, or
  by the kernels' ``with_debug`` counter mismatch on the next launch);
* ``delay_shard`` — shard ``s`` misses ``rounds`` heartbeats but comes
  back (a straggler, not a death — must NOT trigger recovery as long as
  the delay stays inside the heartbeat window).

Every detected fault surfaces as a typed ``FaultDetected``; the
``RecoveryPolicy`` bounds how the resilient runner responds — transient
retry, re-dispatch from the last checkpoint, then graceful degradation
to typed partial results.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("kill_shard", "drop_inbox", "dup_inbox", "corrupt_tile",
         "delay_shard")

# which fault classes lose device state (recovery must re-dispatch from
# a checkpoint) vs transient per-round perturbations (retrying the same
# round from the intact pre-round state suffices)
STATE_LOSS = frozenset(("kill_shard", "corrupt_tile"))
TRANSIENT = frozenset(("drop_inbox", "dup_inbox", "delay_shard"))


class FaultDetected(RuntimeError):
    """A chaos-injected (or real) fault caught by a detector: crc scrub,
    counter-mirror mismatch, or heartbeat expiry.  Typed so the resilient
    runner can route it to the right recovery path and tests can assert
    the detector that fired."""

    def __init__(self, kind: str, shard: int | None = None,
                 round_: int | None = None, detail: str = ""):
        self.kind = kind
        self.shard = shard
        self.round = round_
        msg = f"fault detected: {kind}"
        if shard is not None:
            msg += f" shard={shard}"
        if round_ is not None:
            msg += f" round={round_}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    round: int          # fixpoint round the event fires before
    kind: str           # one of KINDS
    shard: int          # target shard
    rounds: int = 1     # delay_shard: heartbeats missed

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"expected one of {KINDS}")


@dataclasses.dataclass
class ChaosPlan:
    """Deterministic engine-level fault schedule (the round-keyed analog
    of the serving layer's tick-keyed ``FaultPlan``).

    The plan is pure data: the resilient runner consumes events by round
    and marks them fired, so a re-dispatch of the same round after
    recovery does not re-fire them (each event injects exactly once —
    the differential suite depends on runs terminating)."""

    events: tuple = ()

    def __post_init__(self):
        self.events = tuple(
            e if isinstance(e, ChaosEvent) else ChaosEvent(*e)
            for e in self.events)
        self._fired: set = set()

    def events_at(self, round_: int):
        """Unfired events scheduled for ``round_`` (does not mark them)."""
        return [e for i, e in enumerate(self.events)
                if e.round == round_ and i not in self._fired]

    def mark_fired(self, event: ChaosEvent):
        for i, e in enumerate(self.events):
            if e is event or (e == event and i not in self._fired):
                self._fired.add(i)
                return
        raise ValueError(f"event not in plan: {event}")

    def reset(self):
        """Forget fired state (reuse the plan for a fresh run)."""
        self._fired.clear()

    @classmethod
    def random(cls, seed: int, n_events: int, max_round: int,
               num_shards: int, kinds=KINDS) -> "ChaosPlan":
        """A seedable random schedule: ``n_events`` events uniformly over
        rounds ``[1, max_round]`` × shards × ``kinds``.  Same seed, same
        plan — the chaos bench's randomized-round injection stays
        reproducible run-to-run."""
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds)
        evs = []
        for _ in range(int(n_events)):
            evs.append(ChaosEvent(
                round=int(rng.integers(1, max(max_round, 1) + 1)),
                kind=kinds[int(rng.integers(0, len(kinds)))],
                shard=int(rng.integers(0, num_shards))))
        # stable order: by round, then construction order
        evs.sort(key=lambda e: e.round)
        return cls(events=tuple(evs))


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Bounds on the resilient runner's response ladder:

    1. transient faults (dropped/duplicated inbox, short delays) —
       retry the same round from the intact pre-round state, at most
       ``max_retries`` times per round;
    2. state-loss faults (killed shard, corrupted tile) — re-dispatch
       from the last checkpoint (round 0's initial state counts as the
       implicit checkpoint), at most ``max_restores`` times per run;
    3. budgets exhausted — graceful degradation: return the current
       values with a typed ``'degraded'`` status instead of raising.

    ``heartbeat_window``: rounds a shard may miss heartbeats before it
    is declared dead (mirrors ``ElasticCoordinator``'s window).
    ``on_dead``: ``'restore'`` re-dispatches the same layout from the
    checkpoint; ``'shrink'`` rebuilds the partition on the surviving
    shards (the ``ShardPool`` path)."""

    max_retries: int = 2
    max_restores: int = 2
    heartbeat_window: int = 3
    on_dead: str = "restore"
    degrade: bool = True

    def __post_init__(self):
        if self.on_dead not in ("restore", "shrink"):
            raise ValueError("on_dead must be 'restore' or 'shrink'")


@dataclasses.dataclass
class FaultEventRecord:
    """One detected fault + how it was resolved (for reports/benches)."""

    kind: str
    shard: int | None
    round: int
    action: str          # 'retry' | 'restore' | 'shrink' | 'degrade'
    rounds_lost: int = 0


@dataclasses.dataclass
class FixpointReport:
    """Resilient-run epilogue: terminal status + recovery accounting.

    status: 'ok' (no faults), 'recovered' (faults occurred, full result),
    or 'degraded' (recovery budget exhausted; values are partial)."""

    status: str = "ok"
    faults: list = dataclasses.field(default_factory=list)
    retries: int = 0
    restores: int = 0
    rounds_lost: int = 0
    checkpoints_written: int = 0
    checkpoint_write_s: float = 0.0
    recovery_s: float = 0.0
