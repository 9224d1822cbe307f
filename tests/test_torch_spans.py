"""Spans alone (``FlightRecorder(rounds=False)``): the port dispatches the
very same operations, with the same host syncs, as with no recorder; its
spans form a sound tree, stamped on ``torch.profiler``'s clock.

No JAX here: these check the port against itself.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import apps, obs, query  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.graph import generators  # noqa: E402
from repro_torch.obs import report  # noqa: E402

COUNTERS = ("engine_host_syncs_total", "engine_dispatches_total")
UNREAD = ("engine_rounds_total", "engine_messages_total",
          "engine_pruned_total", "engine_grid_cells_total",
          "engine_dma_bytes_total", "engine_frontier",
          "engine_wall_seconds_total", "serve_live_lanes",
          "serve_submitted_total", "serve_admitted_total",
          "serve_latency_seconds")


class Ops(TorchDispatchMode):
    """The aten operations dispatched inside the mode, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def graph():
    g = generators.rmat(8, edge_factor=8, seed=7).with_random_weights(seed=7)
    root = int(np.argmax(g.out_degrees()))
    part = build_partition(g, PartitionConfig(num_shards=4, rpvo_max=4))
    return g, root, part


def _counters():
    snap = obs.registry().snapshot()
    return {(name, key): val for name in COUNTERS
            for key, val in snap.get(name, {"series": {}})["series"].items()}


def _search(app, grid_mode):
    def work(g, root, part):
        out, stats, _ = getattr(apps, app)(
            g, root, part=part, device="cpu",
            cfg=engine.EngineConfig(use_pallas=True, grid_mode=grid_mode))
        return out, [int(x) for x in stats]
    return work


def _pagerank(g, root, part):
    return apps.pagerank(g, iters=5, part=part, device="cpu",
                         cfg=engine.EngineConfig(use_pallas=True))[0]


def _ticks(g, root, part):
    srv = query.QueryServer(
        part, n_lanes=4, ppr_lanes=0, tick_rounds=4, device="cpu",
        cfg=engine.EngineConfig(use_pallas=True,
                                grid_mode="device_worklist"))
    srcs = np.argsort(-g.out_degrees())[:6]
    for i, v in enumerate(srcs):
        srv.submit(("bfs", "sssp")[i % 2], int(v))
    for _ in range(3):
        srv.step()
    return {q: r.values for q, r in srv.results.items()}


WORK = {
    "bfs-device_worklist": _search("bfs", "device_worklist"),
    "bfs-worklist": _search("bfs", "worklist"),
    "sssp-device_worklist": _search("sssp", "device_worklist"),
    "sssp-worklist": _search("sssp", "worklist"),
    "pagerank": _pagerank,
    "server-3-ticks": _ticks,
}
SPANS = {
    "bfs-device_worklist": {"app.call", "engine.upload", "engine.plan",
                            "engine.init", "engine.window", "engine.read",
                            "app.extract"},
    "bfs-worklist": {"app.call", "engine.upload", "engine.plan",
                     "engine.init", "app.extract"},
    "pagerank": {"app.call", "engine.upload", "engine.plan", "engine.init",
                 "engine.iterations", "app.extract"},
    "server-3-ticks": {"engine.upload", "engine.plan", "server.tick",
                       "server.admit", "server.step", "server.retire",
                       "queued", "run"},
}
SPANS["sssp-device_worklist"] = SPANS["bfs-device_worklist"]
SPANS["sssp-worklist"] = SPANS["bfs-worklist"]


def _run(work, graph, rec):
    engine.drop_device_arrays(graph[2])    # both runs start cold
    before = _counters()
    with Ops() as mode:
        if rec is None:
            out = work(*graph)
        else:
            with obs.recording(rec):
                out = work(*graph)
    after = _counters()
    return mode.ops, {k: v - before.get(k, 0) for k, v in after.items()}, out


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(WORK))
def test_spans_alone_dispatch_the_same_ops_and_syncs(graph, case):
    rec = obs.FlightRecorder(rounds=False)
    ops0, counts0, out0 = _run(WORK[case], graph, None)
    ops1, counts1, out1 = _run(WORK[case], graph, rec)
    assert ops1 == ops0
    assert counts1 == counts0 and counts0
    _same(out1, out0)
    assert rec.rounds == []
    names = {e["name"] for e in rec.tracer.events() if e["ph"] == "X"}
    assert SPANS[case] <= names
    assert "round" not in names


def _tree_check(events):
    spans = [e for e in events if e["ph"] == "X"]
    ids = [e["args"]["id"] for e in spans]
    assert len(ids) == len(set(ids))
    stacked = {e["args"]["id"]: e for e in spans if "parent" in e["args"]}
    for e in stacked.values():
        p = e["args"]["parent"]
        if p is not None:
            q = stacked[p]
            assert q["ts"] <= e["ts"] + 1e-3
            assert e["ts"] + e["dur"] <= q["ts"] + q["dur"] + 1e-3
    own = obs.self_times(events)
    kids = {}
    for e in stacked.values():
        kids.setdefault(e["args"]["parent"], []).append(e["args"]["id"])

    def subtree(sid):
        return own[sid] + sum(subtree(k) for k in kids.get(sid, ()))
    for sid in kids.get(None, ()):            # one thread: children disjoint
        assert subtree(sid) == pytest.approx(stacked[sid]["dur"] * 1e-6,
                                             rel=1e-6, abs=1e-8)
    return stacked


def test_span_tree_is_sound_on_a_traced_run(graph):
    with obs.recording(rounds=False) as rec:
        _search("bfs", "device_worklist")(*graph)
        _pagerank(*graph)
        _ticks(*graph)
    stacked = _tree_check(rec.tracer.events())
    by_name = {}
    for e in stacked.values():
        by_name.setdefault(e["name"], []).append(e)
    for child, parent in (("engine.plan", "engine.upload"),
                          ("engine.read", "engine.window"),
                          ("server.admit", "server.tick"),
                          ("server.step", "server.tick"),
                          ("app.extract", "app.call")):
        for e in by_name[child]:
            assert stacked[e["args"]["parent"]]["name"] == parent
    calls = by_name["app.call"]
    assert [(c["args"]["app"], c["args"].get("root")) for c in calls] == [
        ("bfs", graph[1]), ("pagerank", None)]
    requests = [e for e in rec.tracer.events()
                if e["name"] in ("queued", "run")]
    assert requests and all("parent" not in e["args"] for e in requests)


def test_self_time_is_duration_less_the_childrens_cover():
    now = [0.0]
    tr = obs.Tracer(clock=lambda: now[0])

    def at(t):
        now[0] = t
    outer = tr.span("outer")
    at(1.0)
    with tr.span("a"):
        at(3.0)
    at(5.0)
    b = tr.span("b")
    at(5.2)
    with tr.span("c"):
        at(5.5)
    at(6.0)
    b.end()
    at(10.0)
    outer.end()
    tr.complete("queued", start=0.5, end=9.0)       # on no stack
    ev = {e["name"]: e for e in tr.events()}
    own = obs.self_times(tr.events())
    got = {n: own[ev[n]["args"]["id"]] for n in ("outer", "a", "b", "c")}
    assert got == pytest.approx({"outer": 7.0, "a": 2.0, "b": 0.7,
                                 "c": 0.3})
    assert ev["c"]["args"]["parent"] == ev["b"]["args"]["id"]
    assert ev["outer"]["args"]["parent"] is None
    assert ev["queued"]["args"]["id"] not in own
    _tree_check(tr.events())


def test_a_span_left_open_is_closed_with_its_parent():
    tr = obs.Tracer()
    outer = tr.span("outer")
    tr.span("leaked")                 # never ended
    outer.end()
    with tr.span("next") as nxt:
        pass
    assert nxt.parent is None


def test_spans_share_the_unix_epoch_clock():
    """A span maps onto ``time.time_ns()`` through ``epoch_ns``, and onto
    a CPU ``torch.profiler`` trace through its ``trace_start_ns``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    before = time.time_ns()
    tr = obs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("marked") as sp:
            with record_function("marker"):
                torch.ones(64).sum()
    after = time.time_ns()
    ev = next(e for e in tr.events() if e["name"] == "marked")
    s0 = tr.epoch_ns + ev["ts"] * 1e3
    s1 = s0 + ev["dur"] * 1e3
    assert before <= tr.epoch_ns <= s0 <= s1 <= after
    assert sp.tracer is tr
    start = prof.profiler.kineto_results.trace_start_ns()
    mark = next(e for e in prof.events() if e.name == "marker")
    m0 = start + mark.time_range.start * 1e3
    m1 = start + mark.time_range.end * 1e3
    assert s0 - 5e6 <= m0 <= m1 <= s1 + 5e6


def test_window_span_ends_without_live_rounds(graph):
    """A device_worklist fixpoint whose first window runs no live round
    still records that window's span."""
    g, root, part = graph
    init = engine.init_values(part, actions.BFS, {root: 0.0})
    with obs.recording(rounds=False) as rec:
        _, stats = engine.run_stacked(
            actions.BFS, part, init,
            engine.EngineConfig(use_pallas=True,
                                grid_mode="device_worklist"),
            init_changed=np.zeros_like(init, dtype=bool), device="cpu")
    assert int(stats.iterations) == 0
    windows = [e for e in rec.tracer.events()
               if e["name"] == "engine.window"]
    assert len(windows) == 1 and windows[0]["args"]["rounds"] == 0
    assert obs.get_recorder() is None


def test_round_accounting_keeps_what_the_report_renders(graph):
    g, root, part = graph
    with obs.recording() as rec:
        apps.bfs(g, root, part=part, device="cpu",
                 cfg=engine.EngineConfig(use_pallas=True,
                                         grid_mode="worklist"))
        _ticks(g, root, part)
    assert rec.rounds
    snap = rec.registry.snapshot()
    assert not set(UNREAD) & set(snap)
    text = report.render(rec.to_session())
    assert "== engine rounds ==" in text and "bfs: rounds=" in text
    assert "== serving ==" in text and "server ticks = 3" in text
