"""Span / event tracing with Chrome trace-event JSON export.

A :class:`Tracer` records *complete* spans (``ph: "X"``) and *instant*
events (``ph: "i"``) against an injectable monotonic clock — the same
injection point ``QueryServer`` uses, so deterministic-clock
tests produce deterministic traces.  ``to_chrome()`` emits the Chrome
trace-event format (a ``{"traceEvents": [...]}`` object with ``ts`` /
``dur`` in microseconds), loadable directly in Perfetto /
``chrome://tracing`` for round / tick / request timelines.

Spans nest naturally through the context manager::

    tracer = Tracer()
    with tracer.span("round", app="bfs", args={"round": 3}):
        ...
    tracer.save("trace.json")

Distinct subsystems go on distinct "threads" of the trace via the
``track`` argument (engine rounds, serving ticks, per-request
lifecycles each get a lane in the Perfetto UI).
"""
from __future__ import annotations

import json
import threading
import time


class Span:
    __slots__ = ("tracer", "name", "track", "args", "t0", "_closed")

    def __init__(self, tracer, name, track, args):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.t0 = tracer.now()
        self._closed = False

    def end(self, **extra_args):
        if self._closed:
            return
        self._closed = True
        if extra_args:
            self.args = dict(self.args or {}, **extra_args)
        self.tracer._emit_complete(self.name, self.track, self.t0,
                                   self.tracer.now() - self.t0, self.args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Tracer:
    """Collects trace events; exports Chrome trace-event JSON."""

    def __init__(self, clock=None, pid=0):
        self._clock = clock if clock is not None else time.monotonic
        self._epoch = self._clock()
        self._pid = pid
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tracks: dict[str, int] = {}

    def now(self) -> float:
        """Seconds since this tracer's epoch (injectable clock)."""
        return self._clock() - self._epoch

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks)
            self._tracks[track] = tid
        return tid

    def _emit_complete(self, name, track, t0, dur, args):
        ev = {"name": name, "ph": "X", "pid": self._pid,
              "tid": self._tid(track),
              "ts": round(t0 * 1e6, 3), "dur": round(dur * 1e6, 3)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, track: str = "main",
             args: dict | None = None, **labels) -> Span:
        """Open a span; ``.end()`` (or the ``with`` exit) records it.
        Keyword labels merge into ``args``."""
        merged = dict(args or {})
        merged.update(labels)
        return Span(self, name, track, merged or None)

    def complete(self, name: str, track: str = "main", start: float = 0.0,
                 end: float | None = None, args: dict | None = None,
                 **labels):
        """Record a complete span from explicit tracer-time stamps (both
        in :meth:`now` seconds) — for lifecycles whose start was noted
        before the outcome was known (request queued→admitted→terminal)."""
        merged = dict(args or {})
        merged.update(labels)
        t1 = end if end is not None else self.now()
        self._emit_complete(name, track, start, max(t1 - start, 0.0),
                            merged or None)

    def instant(self, name: str, track: str = "main",
                args: dict | None = None, **labels):
        merged = dict(args or {})
        merged.update(labels)
        ev = {"name": name, "ph": "i", "s": "t", "pid": self._pid,
              "tid": self._tid(track),
              "ts": round(self.now() * 1e6, 3)}
        if merged:
            ev["args"] = merged
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, values: dict, track: str = "counters"):
        """Chrome counter event (``ph: "C"``) — renders as a stacked
        area chart in Perfetto (queue depth, frontier size, ...)."""
        ev = {"name": name, "ph": "C", "pid": self._pid,
              "tid": self._tid(track),
              "ts": round(self.now() * 1e6, 3),
              "args": {k: float(v) for k, v in values.items()}}
        with self._lock:
            self._events.append(ev)

    # -- export ----------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = []
        for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": track}})
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh, indent=1)

    def clear(self):
        with self._lock:
            self._events.clear()
