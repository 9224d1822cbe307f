"""``benchlib.spans`` on the CPU: the device's idle time crossed with the
program's spans, on synthetic intervals and on a tiny run of a cell."""
import copy
import pathlib
import time
import types

import pytest
import torch

from benchlib import spans, spec, traffic

HERE = pathlib.Path(__file__).parent
MS = 1e6                       # ns


class FakeTracer:
    """Spans given as (name, start ms, end ms, args) on epoch 0."""

    epoch_ns = 0

    def __init__(self, rows):
        self.rows = rows

    def events(self):
        return [{"name": n, "ph": "X", "ts": a * 1e3, "dur": (b - a) * 1e3,
                 "args": args} for n, a, b, args in self.rows]


def _stacked(sid, parent):
    return {"id": sid, "parent": parent}


# the window is [0, 100] ms
ROWS = [
    ("app.call", 10, 60, _stacked(1, None)),
    ("engine.upload", 12, 30, _stacked(2, 1)),
    ("engine.plan", 20, 25, _stacked(3, 2)),
    ("app.extract", 50, 58, _stacked(4, 1)),
    ("app.call", 70, 130, _stacked(5, None)),     # runs past the window
    ("partition.placement", -50, -20, _stacked(6, None)),
    ("queued", 0, 95, {"id": 7, "qid": 3}),        # on no stack
]
DEVICE = [(0, 15 * MS), (22 * MS, 24 * MS), (40 * MS, 55 * MS),
          (90 * MS, 200 * MS)]


def _window():
    return spans.WindowSpans(FakeTracer(ROWS), 0, 100 * MS, DEVICE)


def test_idle_intervals_are_the_window_less_the_busy_union():
    busy = [(5, 10), (8, 12), (20, 30), (-5, 1), (95, 120)]
    assert spans.idle_intervals(busy, 0, 100) == [(1, 5), (12, 20),
                                                   (30, 95)]
    assert spans.idle_intervals([], 0, 10) == [(0, 10)]
    assert spans.idle_intervals([(0, 10)], 0, 10) == []


def test_idle_goes_to_the_innermost_span_open_on_the_host():
    w = _window()
    # idle [15, 22], [24, 40], [55, 90] ms
    assert w.idle_s == pytest.approx((7 + 16 + 35) * 1e-3)
    got = dict(w.idle_by_span())
    assert got == {
        "engine.upload": pytest.approx(10e-3),   # [15, 20], [25, 30]
        "engine.plan": pytest.approx(3e-3),      # [20, 22], [24, 25]
        "app.call": pytest.approx(32e-3),        # [30, 40] [58, 60] [70, 90]
        "app.extract": pytest.approx(3e-3),      # [55, 58]: a gap's end
        spans.NO_SPAN: pytest.approx(10e-3),     # [60, 70], between calls
    }
    assert sum(got.values()) == pytest.approx(w.idle_s)
    assert w.idle_by_span(top=1) == [["app.call", pytest.approx(32e-3)]]


def test_idle_inside_counts_a_span_with_its_children():
    w = _window()
    assert w.idle_inside("engine.upload") == pytest.approx(13e-3)
    assert w.idle_inside("engine.plan") == pytest.approx(3e-3)
    assert w.idle_inside("engine.upload", "app.extract") == \
        pytest.approx(16e-3)
    # the second call is cut at the window's end
    assert w.idle_inside("app.call") == pytest.approx((28 + 20) * 1e-3)
    assert w.idle_inside("missing") == 0.0


def test_totals_counts_and_set_up_spans():
    w = _window()
    assert w.total("app.call") == pytest.approx((50 + 30) * 1e-3)
    assert w.count("app.call") == 2
    assert w.total("queued") == pytest.approx(95e-3)
    assert w.ending_ms("queued") == [pytest.approx(95.0)]
    assert w.ending_ms("app.call") == [pytest.approx(50.0)]
    assert w.before("partition.placement") == pytest.approx(30e-3)
    assert w.before("app.call") == 0.0
    assert w.window_s == pytest.approx(0.1)


def test_install_needs_span_only_recording():
    from repro_torch import obs

    class Old:                       # no rounds=False: nothing installed
        def __init__(self, **kw):
            if kw:
                raise TypeError(kw)
    older = types.SimpleNamespace(FlightRecorder=Old, install=obs.install)
    assert spans.install(older) is None
    assert obs.get_recorder() is None
    rec = spans.install(obs)
    try:
        assert obs.get_recorder() is rec and not rec.round_accounting
        assert rec.tracer.epoch_ns is not None
    finally:
        spans.uninstall(obs, rec)
    assert obs.get_recorder() is None
    spans.uninstall(obs, None)


def _tiny(monkeypatch, name, rec_seen):
    """A cell's run at scale 7 on the CPU, noting the installed recorder
    at every fixpoint and server step."""
    from repro_torch import obs
    from repro_torch.core import engine
    from repro_torch.query import server

    for mod, fn in ((engine, "run_stacked"),
                    (engine, "run_pagerank_stacked"),
                    (server.QueryServer, "step")):
        orig = getattr(mod, fn)

        def seen(*a, _orig=orig, **k):
            rec_seen.append(obs.get_recorder())
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, seen)
    cell = spec.load_cell(HERE.parent, HERE, name, trace=False)
    cfg = dict(cell.config, scale=7,
               partition={"num_shards": 4, "rpvo_max": 4})
    t = copy.deepcopy(cell.traffic)
    t["engine"]["use_pallas"] = False
    if "root_pool" in t:
        t["root_pool"] = 8
    if t["driver"] == "serve":
        t.update(server=dict(t["server"], n_lanes=4), clients=8)
        cell.driver.DRAIN_S = 0.5     # answers that never come: fail fast
    start_ns, start = time.time_ns(), time.perf_counter()
    facts, _ = traffic.run(traffic.Run(
        cfg, t, cell.driver, 2**31 + 99, 0.15, False, torch.device("cpu"),
        start))
    t0 = start_ns + facts["setup_s"] * 1e9
    return facts, t0, t0 + facts["window_s"] * 1e9


@pytest.mark.parametrize("name", ["parmat-s22-traversal", "parmat-s22-serve",
                                  "graph500-s22-pagerank"])
def test_untraced_run_installs_nothing(monkeypatch, name):
    from repro_torch import obs
    seen = []
    _tiny(monkeypatch, name, seen)
    assert seen and all(r is None for r in seen)
    assert obs.get_recorder() is None


@pytest.mark.parametrize("name,calls,inner", [
    ("parmat-s22-traversal", "app.call", "engine.upload"),
    ("graph500-s22-pagerank", "app.call", "engine.upload"),
    ("parmat-s22-serve", "server.tick", "server.retire")])
def test_spans_of_a_tiny_run_cover_its_window(monkeypatch, name, calls,
                                              inner):
    """With a span-only recorder around the run, set-up's partition
    spans and the window's spans are read; a card idle all the window
    leaves its idle time to the spans, and they add up to it."""
    from repro_torch import obs
    seen = []
    rec = spans.install(obs)
    try:
        facts, t0, t1 = _tiny(monkeypatch, name, seen)
    finally:
        spans.uninstall(obs, rec)
    assert seen and all(r is rec for r in seen)
    w = spans.WindowSpans(rec.tracer, t0, t1, [])
    assert w.before("partition.placement") > 0
    assert w.before("partition.assemble") > 0
    assert w.count(calls) > 0 and w.total(inner) > 0
    assert w.idle_s == pytest.approx(facts["window_s"], rel=1e-6)
    got = dict(w.idle_by_span(top=100))
    assert sum(got.values()) == pytest.approx(w.idle_s, rel=1e-6)
    assert got.get(spans.NO_SPAN, 0.0) < w.idle_s
    assert w.idle_inside(inner) == pytest.approx(w.total(inner))
