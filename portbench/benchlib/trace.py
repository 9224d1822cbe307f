"""The device trace of a measured window (``--trace 1``).

``torch.profiler`` records the card's kernels and copies (CUDA activity
only, so the host pays no per-operator record).  A warm-up step is
traced and thrown away first: an unscheduled trace can lose its first
records.  Over a window of many seconds only sums are reliable (kernel
records can be stamped a few milliseconds early), so the reduction keeps
sums: the time each operation ran, the time the card was busy (the union
of the operations' intervals), and the idle time before each operation,
summed by the name of the operation that ended the gap.
"""
from __future__ import annotations

import collections

import torch


class Window:
    """``with Window(on) as w:`` wraps the measured window; ``w.warm()`` is
    called once before it with the callable that makes the warm-up step.
    After the block ``w.result`` holds the reduction, or ``None`` when
    tracing is off."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.result = None

    def warm(self, step) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile, schedule
        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1,
                                              repeat=1))
        self.prof.start()
        step()
        torch.cuda.synchronize()
        self.prof.step()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        torch.cuda.synchronize()
        self.prof.step()
        self.prof.stop()
        if exc[0] is None:
            self.result = reduce_events(self.prof.events())
        return False


def reduce_events(events, top: int = 10, width: int = 120) -> dict:
    """Sums over the device's operations: ``device_s`` (every operation's
    time added), ``busy_s`` (their union), ``ops`` and ``gaps``
    ([name, seconds] of the ``top`` operations by time, and of the idle
    time before each operation by its name; names cut to ``width``
    characters)."""
    from torch.autograd import DeviceType
    spans = []
    by_name = collections.defaultdict(float)
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        name = e.name[:width]
        spans.append((t0, t1, name))
        by_name[name] += (t1 - t0) * 1e-6
    spans.sort()
    busy = 0.0
    gaps = collections.defaultdict(float)
    end = None
    for t0, t1, name in spans:
        if end is None or t0 > end:
            if end is not None:
                gaps[name] += (t0 - end) * 1e-6
            busy += (t1 - t0) * 1e-6
            end = t1
        elif t1 > end:
            busy += (t1 - end) * 1e-6
            end = t1

    def rank(d):
        return [[k, v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_s": sum(by_name.values()), "busy_s": busy,
            "ops": rank(by_name), "gaps": rank(gaps)}

