"""The flight recorder: one handle tying metrics + trace + round records.

A :class:`FlightRecorder` is *installed* process-wide (``install`` /
``recording``); instrumented code asks :func:`get_recorder` each time it
would record and does nothing when it returns ``None`` — the disabled
path is a single attribute read, adds no host↔device syncs, and leaves
every jit trace untouched (pinned by the obs-off parity test).

Enabled, the engine's host-driven round loops append one
:class:`RoundRecord` per round whose grid-cell / DMA columns come from
the same host launch mirror the differential tests assert against
the kernel's ``with_debug`` counters — so the telemetry itself is held
to the exact-counter bar.  That accounting changes what the engine runs
(a host planner, whole frontiers read back, numpy mirrors each round).
``FlightRecorder(rounds=False)`` records spans and counters alone: the
engine's loops then take exactly the branches they take with no
recorder, and every span site adds only its host stamps.
``save(path)`` writes a session JSON (records + metrics snapshot +
Chrome trace) that ``python -m repro_torch.obs.report`` renders.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer


@dataclasses.dataclass
class RoundRecord:
    """One engine round, as accounted by the host planner mirror.

    ``cells``/``launched``/``tile_dmas``/``dma_bytes`` are the planner
    mirror of the actual launch (worklist: ``WorklistInfo``; dense grid:
    the two-level-skip live count) — zero on non-fused paths, where no
    kernel launch exists.  ``shard_messages`` is the per-shard live-edge
    (message) count mirror feeding the skew gauge.

    Under a ``device_worklist`` windowed loop one record covers a
    K-round dispatch window: ``window`` is the 1-based window index
    (0 = host-driven per-round record), ``round`` the cumulative round
    count at window end, and the additive columns (messages, work,
    cells, DMA…) are summed over the window's live rounds — so window
    sums equal the per-round host-driven totals exactly."""

    run: str             # which runner/app emitted this round
    round: int           # 1-based round index within the run
    frontier: int        # live slots entering the round
    messages: int        # actions delivered (Fig-6 messages)
    work: int            # predicate-true slot updates
    pruned: int          # delivered but predicate-false
    grid: str            # 'dense' | 'worklist'
    path: str            # 'pinned' | 'tiled' | 'reduce' | 'jnp'
    cells: int           # live grid cells (planner mirror)
    launched: int        # launched cells (dense: total grid; wl: padded)
    tile_dmas: int       # tiled path only: rows staged (K5-K8)
    dma_bytes: int       # their bytes (rows x Q x 4)
    wall_s: float
    shard_messages: list | None = None
    window: int = 0      # dispatch-window index (0 = per-round record)


def _skew(counts) -> float:
    """max/mean load imbalance of a per-shard count vector (1.0 = perfectly
    balanced); 0 when nothing moved."""
    counts = list(counts)
    total = sum(counts)
    if not counts or total == 0:
        return 0.0
    return max(counts) / (total / len(counts))


class FlightRecorder:
    """Metrics registry + tracer + per-round records for one session.

    ``registry``/``tracer`` default to fresh private instances so
    concurrent sessions don't bleed into each other; pass
    ``metrics.registry()`` explicitly to feed the process-wide registry.
    ``keep_frontiers=True`` additionally stores each recorded round's
    frontier bitmap — test-only, for re-deriving mirrors.
    ``rounds=False`` turns the per-round accounting off (see the module's
    docstring): spans and counters only."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None, clock=None,
                 keep_frontiers: bool = False, meta: dict | None = None,
                 rounds: bool = True):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(clock=clock)
        self.round_accounting = rounds
        self.rounds: list[RoundRecord] = []
        self.frontiers: list = []
        self.keep_frontiers = keep_frontiers
        self.meta = dict(meta or {})

    # -- engine rounds ---------------------------------------------------

    def add_round(self, record: RoundRecord, frontier_bitmap=None):
        self.rounds.append(record)
        if self.keep_frontiers:
            self.frontiers.append(frontier_bitmap)
        m, run = self.registry, record.run
        if record.shard_messages:
            m.gauge("engine_shard_message_skew",
                    "per-shard message balance, max/mean (1.0 = even)"
                    ).labels(run=run).set(_skew(record.shard_messages))
        self.tracer.counter(
            f"engine/{run}", {"frontier": record.frontier,
                              "messages": record.messages,
                              "cells": record.cells})

    # -- persistence -----------------------------------------------------

    def to_session(self) -> dict:
        return {
            "meta": self.meta,
            "rounds": [dataclasses.asdict(r) for r in self.rounds],
            "metrics": metrics_to_json(self.registry.snapshot()),
            "trace": self.tracer.to_chrome(),
        }

    def save(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_session(), fh, indent=1)


def metrics_to_json(snapshot: dict) -> list:
    """Registry snapshot -> JSON-clean list (label tuples to dicts)."""
    out = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        series = []
        for key in sorted(entry["series"]):
            val = entry["series"][key]
            row = {"labels": dict(key)}
            if entry["kind"] == "histogram":
                counts, (count, total) = val
                row["bucket_counts"] = list(counts)
                row["count"], row["sum"] = count, total
            else:
                row["value"] = val
            series.append(row)
        item = {"name": name, "kind": entry["kind"],
                "help": entry.get("help", ""), "series": series}
        if "buckets" in entry:
            item["buckets"] = list(entry["buckets"])
        out.append(item)
    return out


def load_session(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


# -- the process-wide current recorder ----------------------------------

_active: FlightRecorder | None = None


def get_recorder() -> FlightRecorder | None:
    """The installed recorder, or None (the default — recording off)."""
    return _active


def round_recorder() -> FlightRecorder | None:
    """The installed recorder when it accounts rounds, else None."""
    rec = _active
    return rec if rec is not None and rec.round_accounting else None


class _NullSpan:
    """What :func:`span` returns with recording off."""
    __slots__ = ()

    def end(self, **extra_args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, track: str = "main", **labels):
    """A span on the installed recorder's tracer (``Tracer.span``), or a
    no-op one with recording off: the off path is one read of the
    installed recorder."""
    rec = _active
    if rec is None:
        return _NULL_SPAN
    return rec.tracer.span(name, track, **labels)


def install(recorder: FlightRecorder | None) -> FlightRecorder | None:
    """Install (or, with None, uninstall) the process-wide recorder;
    returns the previous one."""
    global _active
    prev, _active = _active, recorder
    return prev


@contextlib.contextmanager
def recording(recorder: FlightRecorder | None = None, **kw):
    """``with recording() as rec:`` — install a (fresh, by default)
    recorder for the block and restore the previous one after."""
    rec = recorder if recorder is not None else FlightRecorder(**kw)
    prev = install(rec)
    try:
        yield rec
    finally:
        install(prev)
