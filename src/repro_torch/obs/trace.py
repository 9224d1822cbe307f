"""Span / event tracing with Chrome trace-event JSON export.

A :class:`Tracer` records *complete* spans (``ph: "X"``), *instant*
events (``ph: "i"``) and counters (``ph: "C"``); ``to_chrome()`` emits
the Chrome trace-event format (a ``{"traceEvents": [...]}`` object with
``ts`` / ``dur`` in microseconds since the tracer's epoch), loadable in
Perfetto / ``chrome://tracing``.

The clock.  By default spans are stamped from ``time.time_ns()``, the
Unix-epoch base ``torch.profiler`` stamps its events on, and the
tracer's epoch is kept as ``epoch_ns``: a span at ``ts`` microseconds
lies at ``epoch_ns + ts * 1000`` ns, the same axis as a profiler event
at ``prof.profiler.kineto_results.trace_start_ns()`` plus its
``time_range`` (µs).  ``now()`` still reads seconds since the epoch.  An
injected clock (``QueryServer``'s fake clocks in tests) gives
deterministic traces and no ``epoch_ns``.

Span ids.  Every span gets an ``id`` (unique within the tracer), kept in
its event's ``args``.  A span opened with :meth:`Tracer.span` also gets a
``parent``: the innermost span still open on the same thread (``None``
at the top), from a per-thread stack, so a layer's self time is its
duration less its children's cover (:func:`self_times`).  Spans recorded
after the fact with :meth:`Tracer.complete` (request lifecycles, which
span ticks) sit on no stack and carry no ``parent``; the spans of one
request share its ``qid``.

Distinct subsystems go on distinct "threads" of the trace via the
``track`` argument (engine rounds, serving ticks, per-request
lifecycles each get a lane in the Perfetto UI)::

    tracer = Tracer()
    with tracer.span("engine.window", track="engine/bfs", window=3):
        ...
    tracer.save("trace.json")

``repro_torch.obs`` names the spans the port records and where.
"""
from __future__ import annotations

import itertools
import json
import threading
import time


class Span:
    __slots__ = ("tracer", "name", "track", "args", "t0", "id", "parent",
                 "_closed")

    def __init__(self, tracer, name, track, args, sid, parent):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.id = sid
        self.parent = parent
        self.t0 = tracer.now()
        self._closed = False

    def end(self, **extra_args):
        if self._closed:
            return
        self._closed = True
        t1 = self.tracer.now()
        self.tracer._pop(self)
        args = dict(self.args or {}, **extra_args)
        args.update(id=self.id, parent=self.parent)
        self.tracer._emit_complete(self.name, self.track, self.t0,
                                   t1 - self.t0, args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Tracer:
    """Collects trace events; exports Chrome trace-event JSON."""

    def __init__(self, clock=None, pid=0):
        self._clock = clock
        if clock is None:
            self.epoch_ns = time.time_ns()
            self._epoch = 0.0
        else:
            self.epoch_ns = None
            self._epoch = clock()
        self._pid = pid
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tracks: dict[str, int] = {}
        self._ids = itertools.count(1)
        self._open = threading.local()     # .stack: this thread's spans

    def now(self) -> float:
        """Seconds since this tracer's epoch (``time.time_ns()``, or the
        injected clock)."""
        if self._clock is None:
            return (time.time_ns() - self.epoch_ns) * 1e-9
        return self._clock() - self._epoch

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _pop(self, span: Span) -> None:
        """Close ``span`` on its thread's stack, with any span above it
        that was left open."""
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is span:
                del stack[i:]
                return

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
        """Open a span, the child of the innermost span open on this
        thread; ``.end()`` (or the ``with`` exit) records it.  Keyword
        labels merge into ``args``."""
        merged = dict(args or {})
        merged.update(labels)
        stack = self._stack()
        span = Span(self, name, track, merged or None, next(self._ids),
                    stack[-1].id if stack else None)
        stack.append(span)
        return span

    def complete(self, name: str, track: str = "main", start: float = 0.0,
                 end: float | None = None, args: dict | None = None,
                 **labels):
        """Record a complete span from explicit tracer-time stamps (both
        in :meth:`now` seconds) — for lifecycles whose start was noted
        before the outcome was known (request queued→admitted→terminal).
        It gets an ``id`` and no ``parent``: it sits on no thread's
        stack."""
        merged = dict(args or {})
        merged.update(labels, id=next(self._ids))
        t1 = end if end is not None else self.now()
        self._emit_complete(name, track, start, max(t1 - start, 0.0),
                            merged)

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


def self_times(events) -> dict:
    """Seconds of self time by span id, for the spans of ``events`` (a
    tracer's ``events()``) that have a ``parent``: a span's duration less
    the part of it its children cover."""
    spans = {e["args"]["id"]: e for e in events
             if e.get("ph") == "X" and "parent" in e.get("args", {})}
    kids: dict = {}
    for e in spans.values():
        if e["args"]["parent"] in spans:
            kids.setdefault(e["args"]["parent"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    out = {}
    for sid, e in spans.items():
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        cover, end = 0.0, t0
        for a, b in sorted(kids.get(sid, ())):
            a, b = max(a, end), min(b, t1)
            if b > a:
                cover += b - a
                end = b
        out[sid] = (e["dur"] - cover) * 1e-6
    return out
