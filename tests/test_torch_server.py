"""The port's ``QueryServer`` against the reference's, trace for trace.

Both servers get the same partition, the same request streams, submitted
between the same ticks, and the same injected clock; every
``QueryResult`` (values — min kinds bit for bit, PPR within rtol 1e-4 /
atol 1e-7 — status, rounds, messages, ``exchanged``, lane, ticks,
latency, flags), the ``counters``, the ``occupancy_trace`` and the
``snapshot()`` meta must match, under the dense and the compact exchange
and ``tick_rounds`` 1 and 4.  The cases follow the reference's own
(``tests/test_query_server.py``, ``tests/test_serve_robustness.py``):
mixed kinds, mid-flight admission, the block / reject / shed policies,
preemption, deadlines, timeouts, round budgets (0 included), tenants,
the result cache and ``FaultPlan``.  The reference runs its plain jnp
rounds except in the cases marked ``use_pallas`` (its Pallas kernels in
interpret mode); the port's fused cases run the kernels' plain versions.
The port's host reads per tick are counted (``host_syncs``,
``engine_host_syncs_total``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps.pagerank import _pr_graph as ref_pr_graph  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro.graph.graph import COOGraph as RefCOOGraph  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro import query as ref_query  # noqa: E402
from repro_torch import interop, obs, query, serve  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.graph import reference  # noqa: E402
from repro_torch.graph.graph import COOGraph  # noqa: E402
from repro_torch.query import server as server_mod  # noqa: E402

RTOL, ATOL = 1e-4, 1e-7
EXCHANGES = ["dense", "compact"]
META = list(server_mod._RESULT_META_FIELDS)


class FakeClock:
    """Deterministic wall clock: now() returns ``t`` until advanced."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TickClock(FakeClock):
    """Advances one second on every reading."""

    def __call__(self):
        self.t += 1.0
        return self.t


def _parts(g_ref):
    part_ref = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=4, rpvo_max=2))
    return part_ref, interop.partition_from_dict(
        dataclasses.asdict(part_ref))


def _path_parts(n=24):
    src = np.arange(n - 1, dtype=np.int32)
    return _parts(RefCOOGraph(n, src, (src + 1).astype(np.int32), None))


def _rmat_parts():
    g = ref_generators.rmat(7, edge_factor=5, seed=5) \
        .with_random_weights(seed=5)
    return (*_parts(g), np.argsort(-g.out_degrees()))


def _ppr_parts():
    g = ref_generators.rmat(6, edge_factor=4, seed=3)
    return (*_parts(ref_pr_graph(g)), np.argsort(-g.out_degrees()))


def _servers(parts, exch="dense", use_pallas=False, serve_kw=None,
             faults=None, clock=FakeClock, grid_mode="dense", **kw):
    """[(reference server, clock), (port server, clock)] on the same
    partition, config, admission settings and clock kind."""
    part_ref, part = parts[:2]
    out = []
    for ref_side in (True, False):
        eng = ref_engine if ref_side else engine
        pkg = ref_query if ref_side else serve
        sk = dict(serve_kw or {})
        if faults is not None:
            sk["faults"] = pkg.FaultPlan(**faults)
        clk = clock()
        extra = {} if ref_side else {"device": "cpu"}
        srv = (ref_query if ref_side else query).QueryServer(
            part_ref if ref_side else part,
            cfg=eng.EngineConfig(exchange=exch, use_pallas=use_pallas,
                                 grid_mode=grid_mode),
            serve=pkg.ServeConfig(**sk) if sk else None, clock=clk,
            **kw, **extra)
        out.append((srv, clk))
    return out


def _values_equal(kind, got, want):
    if want is None:
        assert got is None
    elif kind == "ppr":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _assert_same(pair):
    (ref_srv, _), (srv, _) = pair
    assert sorted(srv.results) == sorted(ref_srv.results)
    for qid, want in ref_srv.results.items():
        got = srv.results[qid]
        assert {f: getattr(got, f) for f in META} \
            == {f: getattr(want, f) for f in META}, qid
        _values_equal(want.kind, got.values, want.values)
    assert srv.counters == ref_srv.counters
    assert srv.occupancy_trace == ref_srv.occupancy_trace
    assert (srv.tick, srv.rounds_driven) == (ref_srv.tick,
                                             ref_srv.rounds_driven)
    assert srv.occupancy() == ref_srv.occupancy()
    assert srv.in_flight() == ref_srv.in_flight()
    _, meta = srv.snapshot()
    _, ref_meta = ref_srv.snapshot()
    assert meta == ref_meta


def _both(pair, fn):
    """Run ``fn(server, clock)`` on both servers; their return values."""
    return [fn(srv, clk) for srv, clk in pair]


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("tick_rounds", [1, 4])
@pytest.mark.parametrize("exch", EXCHANGES)
def test_mixed_kinds_in_waves(exch, tick_rounds):
    """BFS, SSSP, reachability, multi-source BFS and PPR requests in two
    waves, the second submitted mid-flight."""
    parts = _rmat_parts()
    deg = parts[2]
    pair = _servers(parts, exch, n_lanes=3, ppr_lanes=2,
                    tick_rounds=tick_rounds)

    def run(srv, clk):
        srv.submit("bfs", int(deg[0]))
        srv.submit("sssp", int(deg[1]))
        srv.submit("reachability", int(deg[4]))
        srv.submit("bfs", [int(deg[1]), int(deg[4])])
        srv.step()
        clk.t = 1.5
        srv.step()
        srv.submit("sssp", {int(deg[2]): 0.5, int(deg[7]): 0.0})
        srv.submit("bfs", int(deg[9]))
        return srv.run()

    _both(pair, run)
    _assert_same(pair)


@pytest.mark.parametrize("tick_rounds", [1, 4])
@pytest.mark.parametrize("exch", EXCHANGES)
def test_ppr_requests(exch, tick_rounds):
    parts = _ppr_parts()
    deg = parts[2]
    pair = _servers(parts, exch, n_lanes=1, ppr_lanes=2,
                    tick_rounds=tick_rounds)

    def run(srv, clk):
        srv.submit("ppr", int(deg[0]), damping=0.85, tol=1e-8)
        srv.submit("ppr", int(deg[3]), damping=0.6, tol=1e-8)
        srv.submit("bfs", int(deg[1]))
        srv.step()
        srv.submit("ppr", int(deg[5]), damping=0.7, tol=1e-7)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)
    srv = pair[1][0]
    for r in srv.results.values():
        if r.kind == "ppr":
            assert r.status == serve.QueryStatus.OK


@pytest.mark.parametrize("grid_mode", ["dense", "device_worklist"])
@pytest.mark.parametrize("exch", EXCHANGES)
def test_kernel_path_against_interpret_mode(exch, grid_mode):
    """The fused kernels' path (K3, K4 on a device plan: their plain
    versions on the CPU) against the reference's Pallas kernels in
    interpret mode; PPR at tol 1e-6, where the two sum orders give the
    same rounds."""
    parts = _ppr_parts()
    deg = parts[2]
    pair = _servers(parts, exch, use_pallas=True, n_lanes=2, ppr_lanes=1,
                    tick_rounds=2, grid_mode=grid_mode)

    def run(srv, clk):
        for i in (0, 1, 3):
            srv.submit("bfs" if i != 1 else "sssp", int(deg[i]))
        srv.submit("ppr", int(deg[2]), tol=1e-6)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)


@pytest.mark.parametrize("exch", EXCHANGES)
def test_admits_into_lane_freed_mid_flight(exch):
    parts = _path_parts(40)
    pair = _servers(parts, exch, n_lanes=2)
    n = 40
    _both(pair, lambda srv, clk: [srv.submit("bfs", v)
                                  for v in (0, n - 3, n - 5)])
    _both(pair, lambda srv, clk: srv.run())
    _assert_same(pair)
    res = pair[1][0].results
    assert res[2].admitted_tick > res[1].completed_tick
    assert res[2].admitted_tick < res[0].completed_tick
    assert res[0].rounds == n
    src = np.arange(n - 1, dtype=np.int32)
    g = COOGraph(n, src, (src + 1).astype(np.int32), None)
    for qid, root in enumerate((0, n - 3, n - 5)):
        np.testing.assert_array_equal(res[qid].values,
                                      reference.bfs_levels(g, root))


@pytest.mark.parametrize("exch", EXCHANGES)
def test_occupancy_and_queue_drain(exch):
    parts = _rmat_parts()
    deg = parts[2]
    pair = _servers(parts, exch, n_lanes=2)
    _both(pair, lambda srv, clk: [srv.submit("bfs", int(deg[i]))
                                  for i in range(6)])
    _both(pair, lambda srv, clk: srv.run())
    _assert_same(pair)
    assert max(pair[1][0].occupancy_trace) <= 2


def test_submit_validation_typed_errors():
    parts = _path_parts()
    for srv, _ in _servers(parts, n_lanes=1, ppr_lanes=1):
        n = srv.part.n
        for args, kw, match in [
                (("pagerank-global", 0), {}, "unknown query kind"),
                (("bfs", []), {}, "empty sources"),
                (("bfs", n + 7), {}, "out of range"),
                (("sssp", [0, -3]), {}, "out of range"),
                (("ppr", 0), dict(damping=float("nan")), "damping"),
                (("ppr", 0), dict(damping=1.0), "damping"),
                (("ppr", 0), dict(tol=float("nan")), "tol"),
                (("ppr", [0, 1]), {}, "single personalization seed"),
                (("bfs", 0), dict(max_rounds=-1), "max_rounds"),
                (("bfs", 0), dict(deadline_s=-1.0), "deadline_s"),
                (("sssp", {0: float("nan")}), {}, "non-finite")]:
            with pytest.raises(ValueError, match=match):
                srv.submit(*args, **kw)
        assert srv.queue == [] and srv.results == {}
    srv = query.QueryServer(parts[1], n_lanes=1, ppr_lanes=0, device="cpu")
    with pytest.raises(ValueError, match="no lanes"):
        srv.submit("ppr", 0)
    assert issubclass(query.QueryValidationError, ValueError)


# ------------------------------------------------------ overload policies
@pytest.mark.parametrize("policy", ["reject", "shed", "block"])
@pytest.mark.parametrize("exch", EXCHANGES)
def test_overload_policies(policy, exch):
    parts = _path_parts()
    pair = _servers(parts, exch, n_lanes=1,
                    serve_kw=dict(max_queue=2, overload_policy=policy))

    def run(srv, clk):
        srv.submit("bfs", 0, priority=0)
        srv.submit("bfs", 1, priority=0)
        srv.submit("bfs", 2, priority=5)
        srv.step()
        srv.submit("bfs", 3, priority=0)
        srv.submit("bfs", 4, priority=1)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)


def test_block_policy_safety_valve():
    parts = _path_parts()
    for srv, _ in _servers(parts, n_lanes=1, serve_kw=dict(
            max_queue=1, overload_policy="block", block_max_ticks=0)):
        srv.submit("bfs", 0)
        with pytest.raises((serve.AdmissionError,
                            ref_query.AdmissionError)):
            srv.submit("bfs", 1)


@pytest.mark.parametrize("exch", EXCHANGES)
def test_queue_full_and_every_lane_busy(exch):
    parts = _path_parts()
    pair = _servers(parts, exch, n_lanes=1,
                    serve_kw=dict(max_queue=1, overload_policy="reject"))

    def run(srv, clk):
        srv.submit("bfs", 0)
        srv.step()
        srv.submit("bfs", 1)
        srv.submit("bfs", 2)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)
    assert pair[1][0].results[2].status == serve.QueryStatus.REJECTED


# ------------------------------------------------------------- preemption
@pytest.mark.parametrize("tick_rounds", [1, 4])
@pytest.mark.parametrize("exch", EXCHANGES)
def test_priority_preemption_restarts_victim(exch, tick_rounds):
    parts = _path_parts()
    pair = _servers(parts, exch, n_lanes=1, tick_rounds=tick_rounds)

    def run(srv, clk):
        srv.submit("bfs", 0)
        srv.step()
        srv.step()
        srv.submit("bfs", srv.part.n - 2, priority=3)
        srv.submit("bfs", 5, priority=0)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)
    assert pair[1][0].counters["preemptions"] == 1


# --------------------------------------------------- deadlines / budgets
@pytest.mark.parametrize("tick_rounds", [1, 4])
@pytest.mark.parametrize("exch", EXCHANGES)
def test_deadlines_timeouts_and_budgets(exch, tick_rounds):
    """A deadline blown mid-flight and one while queued, a timeout, a
    round budget and a zero budget, in one stream."""
    parts = _path_parts()
    pair = _servers(parts, exch, n_lanes=2, tick_rounds=tick_rounds)

    def run(srv, clk):
        srv.submit("bfs", 0, deadline_s=10.0)
        srv.submit("sssp", 1, timeout_s=20.0)
        srv.submit("bfs", 2, deadline_s=5.0)        # queued behind them
        srv.submit("bfs", 3, max_rounds=0)
        srv.submit("bfs", 4, max_rounds=3)
        srv.step()
        srv.step()
        clk.t = 8.0
        srv.step()
        clk.t = 100.0
        srv.submit("bfs", 6)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)
    st = {q: r.status for q, r in pair[1][0].results.items()}
    S = serve.QueryStatus
    assert st[0] == S.DEADLINE_EXPIRED and st[2] == S.DEADLINE_EXPIRED
    assert st[1] == S.TIMEOUT and st[3] == S.BUDGET_EXHAUSTED
    assert st[4] == S.BUDGET_EXHAUSTED and st[5] == S.OK


@pytest.mark.parametrize("exch", EXCHANGES)
def test_converged_lane_wins_deadline_race(exch):
    parts = _ppr_parts()
    for tol, status in ((1.0, "ok"), (1e-9, "deadline_expired")):
        pair = _servers(parts, exch, n_lanes=1, ppr_lanes=1,
                        clock=TickClock)
        _both(pair, lambda srv, clk: srv.submit("ppr", 0, tol=tol,
                                                deadline_s=2.5))
        _both(pair, lambda srv, clk: srv.run())
        _assert_same(pair)
        assert pair[1][0].results[0].status == status


# ------------------------------------------------------ tenants and cache
@pytest.mark.parametrize("exch", EXCHANGES)
def test_tenant_fair_admission(exch):
    parts = _path_parts()
    pair = _servers(parts, exch, n_lanes=2,
                    serve_kw=dict(tenant_weights={"heavy": 2.0}))

    def run(srv, clk):
        for v, t in ((0, "heavy"), (1, "heavy"), (2, "heavy"),
                     (3, "light"), (4, "light")):
            srv.submit("bfs", v, tenant=t)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)


@pytest.mark.parametrize("exch", EXCHANGES)
def test_result_cache_hit_and_staleness(exch):
    parts = _path_parts()
    pair = _servers(parts, exch, n_lanes=1,
                    serve_kw=dict(cache_size=2, cache_ttl_s=30.0))

    def run(srv, clk):
        srv.submit("bfs", 0)
        srv.run()
        clk.t = 10.0
        srv.submit("bfs", 0)                 # a hit
        clk.t = 100.0
        srv.submit("bfs", 0)                 # stale: recomputed
        srv.submit("bfs", [2, 5])
        srv.run()
        srv.submit("bfs", [5, 2])            # the same canonical key
        srv.submit("sssp", 7)
        srv.submit("bfs", 9)
        srv.run()
        srv.invalidate_cache(None)
        srv.submit("bfs", 0)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)
    assert pair[1][0].results[1].cached


# --------------------------------------------------------- fault injection
@pytest.mark.parametrize("tick_rounds", [1, 4])
@pytest.mark.parametrize("exch", EXCHANGES)
def test_fault_plan(exch, tick_rounds):
    parts = _path_parts()
    pair = _servers(parts, exch, n_lanes=2, tick_rounds=tick_rounds,
                    faults=dict(lane_failures=((2, "min", 0),),
                                tick_delays=((3, 60.0),)))

    def run(srv, clk):
        srv.submit("bfs", 0)
        srv.submit("bfs", 1, timeout_s=30.0)
        srv.submit("bfs", 2)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)
    srv = pair[1][0]
    assert srv.counters["injected_lane_failures"] == 1
    assert srv.counters["injected_delays"] == 1
    assert srv.results[0].status == serve.QueryStatus.FAILED
    assert srv.results[1].status == serve.QueryStatus.TIMEOUT


# ----------------------------------------------------- snapshot / restore
class _Manager:
    """An in-memory stand-in for the checkpoint manager's interface."""

    def __init__(self):
        self.saved = {}

    def save(self, step, tree, blocking=False, meta=None):
        self.saved[step] = (tree, meta)

    def latest_step(self):
        return max(self.saved) if self.saved else None

    def restore_meta(self, step):
        return self.saved[step][1]

    def restore(self, step, like):
        return self.saved[step][0]


@pytest.mark.parametrize("exch", EXCHANGES)
def test_snapshot_restore_matches_reference(exch):
    """Checkpoint every 2 ticks, restore mid-flight from the last one
    into a new server and drain it: the same trace as the reference's,
    in-flight lanes ending RECOVERED with min values unchanged."""
    parts = _ppr_parts()
    deg = parts[2]
    pair = _servers(parts, exch, n_lanes=2, ppr_lanes=1,
                    serve_kw=dict(checkpoint_every=2))
    managers = []
    for srv, clk in pair:
        m = _Manager()
        managers.append(m)
        srv.attach_checkpoints(m)
        srv.submit("bfs", int(deg[0]))
        srv.submit("sssp", int(deg[1]))
        srv.submit("ppr", int(deg[2]), tol=1e-8)
        srv.submit("bfs", int(deg[3]))
        for _ in range(3):
            srv.step()
    restored = []
    for (srv, clk), m, ref_side in zip(pair, managers, (True, False)):
        mod = ref_query if ref_side else query
        eng = ref_engine if ref_side else engine
        extra = {} if ref_side else {"device": "cpu"}
        new = mod.QueryServer.restore(
            srv.part, m, cfg=eng.EngineConfig(exchange=exch),
            clock=clk, **extra)
        new.run()
        restored.append((new, clk))
    _assert_same(restored)
    got = restored[1][0].results
    assert any(r.status == serve.QueryStatus.RECOVERED
               for r in got.values())


# ------------------------------------------------------------ host reads
@pytest.mark.parametrize("tick_rounds", [1, 4])
@pytest.mark.parametrize("exch", EXCHANGES)
def test_host_reads_per_tick(exch, tick_rounds):
    """A pool with occupied lanes reads its live flags once a tick and,
    when it steps, its counts and exit flags in one more read; a lane
    that retires with values reads them once.  The pools step exactly as
    often as the reference's (``engine_dispatches_total``)."""
    parts = _ppr_parts()
    deg = parts[2]
    pair = _servers(parts, exch, n_lanes=2, ppr_lanes=2,
                    tick_rounds=tick_rounds)
    regs = [ref_obs.registry(), obs.registry()]
    runs = ("server_min", "server_ppr")

    def counters(reg):
        return {(name, run): reg.counter(name).labels(run=run).value
                for name in ("engine_dispatches_total",
                             "engine_host_syncs_total") for run in runs}

    before = [counters(r) for r in regs]

    def run(srv, clk):
        for i in range(4):
            srv.submit("bfs" if i % 2 else "sssp", int(deg[i]))
        srv.submit("ppr", int(deg[4]), tol=1e-7)
        srv.submit("ppr", int(deg[5]), damping=0.6, tol=1e-7)
        return srv.run()

    _both(pair, run)
    _assert_same(pair)
    after = [counters(r) for r in regs]
    delta = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    srv = pair[1][0]
    for run_name in runs:
        steps = delta[1][("engine_dispatches_total", run_name)]
        assert steps == delta[0][("engine_dispatches_total", run_name)]
        # reads: one live read per occupied pool-tick plus one per step
        occupied_ticks = delta[1][("engine_host_syncs_total",
                                   run_name)] - steps
        assert 0 < occupied_ticks <= srv.tick
    retired_valued = sum(r.values is not None and r.lane >= 0
                         for r in srv.results.values())
    assert srv.host_syncs == retired_valued + sum(
        delta[1][("engine_host_syncs_total", r)] for r in runs)



@pytest.mark.parametrize("exch", EXCHANGES)
def test_overload_run_statuses(exch):
    """The overload run ``chip_smoke.py`` phase 8b makes at RMAT-18, here
    on a path graph: ten BFS requests into an 8-deep 'reject' queue, the
    first with a 1 s deadline, a lane failure at tick 1 on lane 1 and the
    clock moved past the deadline after the first tick."""
    parts = _path_parts()
    pair = _servers(parts, exch, n_lanes=16,
                    serve_kw=dict(max_queue=8, overload_policy="reject"),
                    faults=dict(lane_failures=((1, "min", 1),)))

    def run(srv, clk):
        for i in range(10):
            srv.submit("bfs", i, deadline_s=1.0 if i == 0 else None)
        srv.step()
        clk.t = 5.0
        return {qid: r.status for qid, r in sorted(srv.run().items())}

    got = _both(pair, run)
    _assert_same(pair)
    assert got[1] == {0: "deadline_expired", 1: "lane_failed",
                      2: "ok", 3: "ok", 4: "ok", 5: "ok", 6: "ok", 7: "ok",
                      8: "rejected", 9: "rejected"}
    assert pair[1][0].counters["injected_lane_failures"] == 1
