"""The program's own spans in a traced window, laid over the device trace.

``repro_torch.obs`` stamps its spans on ``torch.profiler``'s clock
(Unix-epoch nanoseconds: a span at ``ts`` µs lies at ``epoch_ns + ts *
1000``), so the host's spans and the card's kernels and copies share one
axis.  Around a traced window they are collected in four steps:

1. ``install(obs)`` puts a span-only recorder
   (``obs.FlightRecorder(rounds=False)``: the program's loops then run
   exactly as with no recorder) in place before set-up, so set-up's
   partition spans are caught, and ``uninstall(obs, rec)`` takes it away
   after the run.  Untraced runs install nothing.  A program without
   span-only recording or the shared clock gets no recorder (``install``
   returns ``None``), and there is nothing to read.
2. ``device_intervals(prof)`` reads a stopped profiler's kernels and
   copies as (start, end) ns on the same axis.
3. ``WindowSpans(rec.tracer, t0_ns, t1_ns, device)`` keeps the spans in
   memory, cuts them to the window [t0_ns, t1_ns] (host ``time.time_ns()``
   stamps at the window's ends) and takes the device's idle intervals in
   the window: the window less the union of the device's intervals.
4. Its readings: ``idle_by_span`` (each idle interval goes to the
   innermost program span open on the host then, or to ``(no span)``),
   ``idle_inside`` (idle seconds while the host is inside any span of the
   given names), and per span name ``total``, ``count``, ``ending_ms``
   (spans ending in the window) and ``before`` (set-up's spans).

Innermost means deepest by the spans' ``parent`` links, then latest
started: on the one host thread that drives the program, the span on top
of its stack.  Request lifecycles (``queued``, ``run``) sit on no stack
and never take idle time; they count in ``total`` and ``ending_ms``.
"""
from __future__ import annotations

import heapq

NO_SPAN = "(no span)"


def install(obs):
    """A span-only recorder installed in ``obs`` (the program's
    ``repro_torch.obs``), or ``None`` where the program has no span-only
    recording or no Unix-epoch span clock."""
    try:
        rec = obs.FlightRecorder(rounds=False)
    except TypeError:
        return None
    if getattr(rec.tracer, "epoch_ns", None) is None:
        return None
    obs.install(rec)
    return rec


def uninstall(obs, rec) -> None:
    if rec is not None:
        obs.install(None)


def device_intervals(prof) -> list[tuple[float, float]]:
    """The CUDA kernels and copies of a stopped ``torch.profiler`` trace,
    (start, end) in Unix-epoch ns, sorted."""
    from torch.autograd import DeviceType
    base = prof.profiler.kineto_results.trace_start_ns()
    return sorted((base + e.time_range.start * 1e3,
                   base + e.time_range.end * 1e3)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def idle_intervals(busy, t0: float, t1: float) -> list[tuple[float, float]]:
    """[t0, t1] less the union of the ``busy`` intervals, as sorted
    disjoint intervals."""
    out, at = [], t0
    for a, b in sorted(busy):
        if b <= at:
            continue
        if a >= t1:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class WindowSpans:
    """A tracer's spans cut to the window [t0_ns, t1_ns], with the
    device's idle intervals there (``device``: the device's busy
    intervals, from ``device_intervals``)."""

    def __init__(self, tracer, t0_ns: float, t1_ns: float, device):
        self.t0, self.t1 = t0_ns, t1_ns
        self.window_s = (t1_ns - t0_ns) * 1e-9
        base = tracer.epoch_ns
        self.spans = []          # (start ns, end ns, name, args)
        for e in tracer.events():
            if e.get("ph") == "X":
                a = base + e["ts"] * 1e3
                self.spans.append((a, a + e["dur"] * 1e3, e["name"],
                                   e.get("args") or {}))
        self.idle = idle_intervals(device, t0_ns, t1_ns)
        self.idle_s = sum(b - a for a, b in self.idle) * 1e-9

    def _in_window(self, name):
        for a, b, n, _ in self.spans:
            if n == name and b > self.t0 and a < self.t1:
                yield max(a, self.t0), min(b, self.t1)

    def total(self, name: str) -> float:
        """Seconds of the window inside spans named ``name`` (summed)."""
        return sum(b - a for a, b in self._in_window(name)) * 1e-9

    def count(self, name: str) -> int:
        """Spans named ``name`` that start in the window."""
        return sum(1 for a, _, n, _ in self.spans
                   if n == name and self.t0 <= a < self.t1)

    def ending_ms(self, name: str) -> list[float]:
        """Milliseconds of each span named ``name`` that ends in the
        window."""
        return [(b - a) * 1e-6 for a, b, n, _ in self.spans
                if n == name and self.t0 < b <= self.t1]

    def before(self, name: str) -> float:
        """Seconds of the spans named ``name`` that ended before the
        window (set-up's)."""
        return sum(b - a for a, b, n, _ in self.spans
                   if n == name and b <= self.t0) * 1e-9

    def idle_inside(self, *names: str) -> float:
        """Idle seconds of the device while the host is inside a span of
        one of ``names``."""
        inside = _union(iv for n in names for iv in self._in_window(n))
        return _overlap(inside, self.idle) * 1e-9

    def attribute(self, intervals) -> dict:
        """Seconds of ``intervals`` (sorted, disjoint, in ns) by the name
        of the innermost stacked span open then, ``NO_SPAN`` where none
        is."""
        stacked = {s[3]["id"]: s for s in self.spans if "parent" in s[3]}

        def depth(sid):
            d = 0
            p = stacked[sid][3]["parent"]
            while p in stacked:
                d += 1
                p = stacked[p][3]["parent"]
            return d
        marks = []
        for sid, (a, b, _, _) in stacked.items():
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                marks.append((a, 1, sid))
                marks.append((b, 0, sid))
        marks.sort()
        # the window cut into pieces, each under one innermost span
        pieces, heap, closed, at = [], [], set(), self.t0
        for t, opening, sid in marks:
            while heap and heap[0][2] in closed:
                heapq.heappop(heap)
            if t > at:
                pieces.append((at, t, stacked[heap[0][2]][2] if heap
                               else NO_SPAN))
                at = t
            if opening:
                heapq.heappush(heap, (-depth(sid), -t, sid))
            else:
                closed.add(sid)
        if at < self.t1:
            pieces.append((at, self.t1, NO_SPAN))
        out: dict = {}
        i = 0
        for a, b in intervals:
            while i < len(pieces) and pieces[i][1] <= a:
                i += 1
            j = i
            while j < len(pieces) and pieces[j][0] < b:
                lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
                if hi > lo:
                    out[pieces[j][2]] = out.get(pieces[j][2], 0.0) \
                        + (hi - lo) * 1e-9
                j += 1
        return out

    def idle_by_span(self, top: int = 10) -> list:
        """[span name, idle seconds] of the ``top`` spans by the device's
        idle time while each was the innermost span open on the host,
        ``NO_SPAN`` among them."""
        got = self.attribute(self.idle)
        return [[k, v] for k, v in
                sorted(got.items(), key=lambda kv: -kv[1])[:top]]
