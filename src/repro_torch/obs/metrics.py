"""Process-wide metrics registry: counters, gauges, histograms.

Dependency-free (stdlib only).  Three instrument kinds:

* ``Counter``   — monotonically increasing totals (``inc``);
* ``Gauge``     — last-write-wins instantaneous values (``set``);
* ``Histogram`` — fixed-bucket distributions (``observe``) with
  count/sum, rendered as cumulative Prometheus buckets.

Every instrument is label-aware: ``counter.labels(app="bfs").inc()``
keys a child series by its sorted label items.  ``snapshot()`` captures
the whole registry as a plain dict; ``delta(before)`` subtracts an
earlier snapshot (counters/histogram counts subtract, gauges keep the
latest value) — the idiom benches use to report a run's own activity on
a shared process-wide registry.  ``render_prometheus()`` emits the
text exposition format, so live telemetry and scrape endpoints share
one schema with the BENCH json columns.

The module-level :func:`registry` returns the process default; tests
construct private ``MetricsRegistry`` instances.
"""
from __future__ import annotations

import bisect
import threading

_INF = float("inf")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if v == _INF:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


class _Child:
    """One labeled series of a parent instrument."""

    def __init__(self, parent, key):
        self._parent = parent
        self._key = key


class _CounterChild(_Child):
    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only increase; got %r" % (amount,))
        with self._parent._lock:
            self._parent._values[self._key] = \
                self._parent._values.get(self._key, 0) + amount

    @property
    def value(self):
        with self._parent._lock:
            return self._parent._values.get(self._key, 0)


class _GaugeChild(_Child):
    def set(self, value):
        with self._parent._lock:
            self._parent._values[self._key] = value

    def inc(self, amount=1):
        with self._parent._lock:
            self._parent._values[self._key] = \
                self._parent._values.get(self._key, 0) + amount

    def dec(self, amount=1):
        self.inc(-amount)

    @property
    def value(self):
        with self._parent._lock:
            return self._parent._values.get(self._key, 0)


class _HistogramChild(_Child):
    def observe(self, value):
        with self._parent._lock:
            counts, stats = self._parent._series(self._key)
            i = bisect.bisect_left(self._parent.buckets, value)
            counts[i] += 1
            stats[0] += 1
            stats[1] += value

    @property
    def count(self):
        with self._parent._lock:
            return self._parent._series(self._key)[1][0]

    @property
    def sum(self):
        with self._parent._lock:
            return self._parent._series(self._key)[1][1]


class _Instrument:
    kind = None
    _child_cls = None

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.RLock()
        self._values: dict = {}

    def labels(self, **labels):
        return self._child_cls(self, _label_key(labels))

    # bare (unlabeled) convenience: counter.inc() == counter.labels().inc()
    def __getattr__(self, attr):
        child = self._child_cls(self, ())
        if hasattr(child, attr):
            return getattr(child, attr)
        raise AttributeError(attr)


class Counter(_Instrument):
    kind = "counter"
    _child_cls = _CounterChild

    def snapshot_values(self):
        with self._lock:
            return dict(self._values)


class Gauge(_Instrument):
    kind = "gauge"
    _child_cls = _GaugeChild

    def snapshot_values(self):
        with self._lock:
            return dict(self._values)


# latency-flavored default buckets (seconds), plus +Inf
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
                   1.0, 5.0, 10.0)


class Histogram(_Instrument):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))

    def _series(self, key):
        if key not in self._values:
            # per-bucket counts (one extra for +Inf) + [count, sum]
            self._values[key] = ([0] * (len(self.buckets) + 1), [0, 0.0])
        return self._values[key]

    def snapshot_values(self):
        with self._lock:
            return {k: (list(c), list(s))
                    for k, (c, s) in self._values.items()}


class MetricsRegistry:
    """A named collection of instruments with snapshot/delta semantics."""

    def __init__(self):
        self._lock = threading.RLock()
        self._instruments: dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst

    def counter(self, name, help="") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    # -- snapshot / delta ------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict capture: {name: {"kind", "help", "series"}} where
        series maps label-key tuples to values (or histogram state)."""
        with self._lock:
            insts = list(self._instruments.items())
        out = {}
        for name, inst in insts:
            entry = {"kind": inst.kind, "help": inst.help,
                     "series": inst.snapshot_values()}
            if inst.kind == "histogram":
                entry["buckets"] = list(inst.buckets)
            out[name] = entry
        return out

    def delta(self, before: dict) -> dict:
        """Subtract an earlier :meth:`snapshot`.  Counters and histogram
        bucket counts subtract; gauges keep their current value (they
        are instantaneous, not cumulative).  Series absent from
        ``before`` are kept whole."""
        now = self.snapshot()
        out = {}
        for name, entry in now.items():
            prev = before.get(name, {}).get("series", {})
            series = {}
            for key, val in entry["series"].items():
                if entry["kind"] == "counter" and key in prev:
                    series[key] = val - prev[key]
                elif entry["kind"] == "histogram" and key in prev:
                    pc, ps = prev[key]
                    counts, stats = val
                    series[key] = (
                        [c - p for c, p in zip(counts, pc)],
                        [stats[0] - ps[0], stats[1] - ps[1]])
                else:
                    series[key] = val
            out[name] = dict(entry, series=series)
        return out

    # -- exposition ------------------------------------------------------

    def render_prometheus(self, snapshot: dict | None = None) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        snap = snapshot if snapshot is not None else self.snapshot()
        lines = []
        for name in sorted(snap):
            entry = snap[name]
            if entry.get("help"):
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {entry['kind']}")
            for key in sorted(entry["series"]):
                val = entry["series"][key]
                if entry["kind"] == "histogram":
                    counts, (count, total) = val
                    cum = 0
                    edges = list(entry["buckets"]) + [_INF]
                    for c, edge in zip(counts, edges):
                        cum += c
                        lk = key + (("le", _fmt_value(edge)),)
                        lines.append(f"{name}_bucket{_fmt_labels(lk)}"
                                     f" {cum}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} "
                        f"{_fmt_value(total)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {count}")
                else:
                    lines.append(f"{name}{_fmt_labels(key)} "
                                 f"{_fmt_value(val)}")
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._instruments.clear()


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default
