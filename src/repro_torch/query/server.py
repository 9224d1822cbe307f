"""Continuous-batching graph query server.

A pool of ``Q`` query lanes shares one round per semiring class (a
min-pool for BFS / SSSP / reachability, a sum-pool for personalized
PageRank).  Requests join free lanes mid-flight by masked state
injection — the new lane's (S, R_max) column of values and frontier is
written into the batched tables on the card between rounds, from the
few slots its sources seed — and are evicted the round they converge,
so a nearby-source BFS never waits on a diameter-spanning SSSP (no
head-of-line blocking).  A freed lane is inert by construction: its
``changed`` column is all-False, so it reads as the absorbing identity
inside the shared relax and contributes nothing until the next
injection overwrites it.

Each tick runs the laned round of ``exchange.fixpoint_round_stacked``
(the min pool) or ``query.lanes.make_ppr_delta_round`` (the PPR pool,
residual-pruned delta rounds) with ``worklist=None``: with
``EngineConfig.use_pallas`` that is the laned kernel K3 under
``grid_mode`` 'dense' / 'worklist' / 'auto' and K4 on a device plan
under 'device_worklist', over the dense or the compact exchange
(``EngineConfig.exchange``).

Overload safety (``ServeConfig``): a bounded admission queue with a
backpressure policy ('block' / 'reject' / 'shed'); priority- and
deadline-aware lane assignment (an urgent request can preempt the
lowest-priority running lane, strictly greater priority only; an
expired deadline evicts mid-flight with a partial-result flag; queued
requests whose deadline passes never occupy a lane); per-request round
budgets (``max_rounds``; zero returns at once with the initial values)
and wall-clock timeouts (``timeout_s``); weighted per-tenant fairness; a
root-keyed LRU result cache with a staleness bound; and deterministic
fault injection (``FaultPlan``: a lane failure or a delayed tick
resolves the request with a typed ``QueryResult.status``, never an
exception out of the serving loop).  With the default ``ServeConfig``
the loop is trace-identical to the unpoliced server.

The ``EngineConfig`` also governs the value table's residency
(``vmem_budget_bytes``): a lane table over the budget runs every pool
round through the tiled kernels with the same serving semantics.

``QueryServer(mesh=...)`` serves on the sharded layout: every rank runs
the same server and makes the same calls (SPMD), each holding its
shard's (1, R_max, Q) lane tables and running the pools' sharded rounds
(``lanes.make_sharded_min_round``, ``make_sharded_ppr_delta_round``):
injection writes a lane's column on the shard that owns each slot, the
live flags are a max over the shards, and a retiring lane's values, a
snapshot and a mutation's migration gather the lane tables.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch import exchange, obs
from repro_torch.core import actions, engine
from repro_torch.core.engine import EngineConfig
from repro_torch.core.partition import Partition
from repro_torch.query import lanes as L
from repro_torch.serve import admission as _adm
from repro_torch.serve.admission import (
    AdmissionError, AdmissionQueue, QueryStatus, QueryValidationError,
    ResultCache, ServeConfig,
)

MIN_KINDS = ("bfs", "sssp", "reachability")


@dataclasses.dataclass
class QueryRequest:
    """One source-rooted query over the served graph.

    kind: 'bfs' | 'sssp' | 'reachability' (min-pool) or 'ppr' (sum-pool).
    sources: vertex id, list of vertices (multi-source), or {vertex:
    initial value} dict; for 'ppr' a single personalization seed vertex.

    Robustness fields: ``priority`` (higher = more urgent; may
    preempt a strictly-lower-priority lane), ``tenant`` (fair-share
    admission id), ``deadline_s`` (SLO from submit, queue wait included —
    expiry evicts with partial values), ``timeout_s`` (wall-clock
    execution cap from admission), ``max_rounds`` (round budget; 0
    returns the initial values immediately).  All malformed inputs raise
    ``QueryValidationError`` at construction — nothing reaches a lane.
    """

    qid: int
    kind: str
    sources: object
    damping: float = 0.85        # ppr only
    tol: float = 1e-6            # ppr only
    priority: int = 0
    tenant: str = "default"
    deadline_s: float | None = None
    timeout_s: float | None = None
    max_rounds: int | None = None

    def __post_init__(self):
        if self.kind not in MIN_KINDS + ("ppr",):
            raise QueryValidationError(
                f"unknown query kind {self.kind!r}")
        if isinstance(self.sources, dict):
            n_src = len(self.sources)
            for v, x in self.sources.items():
                if not np.isfinite(float(x)):
                    raise QueryValidationError(
                        f"non-finite initial value {x!r} for source "
                        f"vertex {v!r}")
        elif isinstance(self.sources, (list, tuple, np.ndarray)):
            n_src = int(np.asarray(self.sources).reshape(-1).size)
        else:
            n_src = 1
        if n_src == 0:
            raise QueryValidationError(
                "empty sources: a query needs at least one source vertex")
        if self.kind == "ppr":
            if n_src != 1:
                raise QueryValidationError(
                    "ppr takes a single personalization seed vertex; "
                    "multi-seed personalization is not supported")
            d = float(self.damping)
            if not np.isfinite(d) or not (0.0 < d < 1.0):
                raise QueryValidationError(
                    f"ppr damping must be finite and in (0, 1); got "
                    f"{self.damping!r}")
            t = float(self.tol)
            if not np.isfinite(t) or t < 0.0:
                raise QueryValidationError(
                    f"ppr tol must be finite and >= 0; got {self.tol!r}")
        if self.max_rounds is not None and int(self.max_rounds) < 0:
            raise QueryValidationError(
                f"max_rounds must be >= 0; got {self.max_rounds!r}")
        for name in ("deadline_s", "timeout_s"):
            v = getattr(self, name)
            if v is not None and (not np.isfinite(float(v)) or v < 0):
                raise QueryValidationError(
                    f"{name} must be finite and >= 0; got {v!r}")


@dataclasses.dataclass
class QueryResult:
    qid: int
    kind: str
    values: np.ndarray | None    # (n,) levels/distances/bool/scores; None
    #                              when the outcome carries no values
    rounds: int                  # rounds the lane was live
    messages: int                # actions delivered for this query
    lane: int                    # lane the query ran in (-1: never ran)
    admitted_tick: int
    completed_tick: int
    latency_s: float             # submit -> completion (includes queue wait)
    exchanged: int = 0           # exchange entries shipped while live
    status: str = QueryStatus.OK  # typed outcome (see QueryStatus)
    partial: bool = False        # values are a mid-flight snapshot
    cached: bool = False         # served from the result cache
    tenant: str = "default"
    priority: int = 0
    preemptions: int = 0         # times this request was preempted
    submitted_tick: int = 0


def _cache_key(req: QueryRequest):
    """Canonical root key: list order and dict insertion order never
    split cache entries for the same logical query."""
    if isinstance(req.sources, dict):
        src = tuple(sorted((int(v), float(x))
                           for v, x in req.sources.items()))
    elif isinstance(req.sources, (list, tuple, np.ndarray)):
        src = tuple(sorted(int(v) for v in
                           np.asarray(req.sources).reshape(-1)))
    else:
        src = (int(req.sources),)
    key = (req.kind, src)
    if req.kind == "ppr":
        key += (float(req.damping), float(req.tol))
    return key


def _req_to_dict(req: QueryRequest) -> dict:
    """JSON-able form of a request (checkpoint manifest payload)."""
    if isinstance(req.sources, dict):
        src = {"kind": "map", "v": [[int(v), float(x)]
                                    for v, x in req.sources.items()]}
    elif isinstance(req.sources, (list, tuple, np.ndarray)):
        src = {"kind": "list",
               "v": [int(v) for v in np.asarray(req.sources).reshape(-1)]}
    else:
        src = {"kind": "one", "v": int(req.sources)}
    return {"qid": req.qid, "kind": req.kind, "sources": src,
            "damping": float(req.damping), "tol": float(req.tol),
            "priority": req.priority, "tenant": req.tenant,
            "deadline_s": req.deadline_s, "timeout_s": req.timeout_s,
            "max_rounds": req.max_rounds}


def _req_from_dict(d: dict) -> QueryRequest:
    src = d["sources"]
    if src["kind"] == "map":
        sources = {int(v): float(x) for v, x in src["v"]}
    elif src["kind"] == "list":
        sources = [int(v) for v in src["v"]]
    else:
        sources = int(src["v"])
    return QueryRequest(qid=d["qid"], kind=d["kind"], sources=sources,
                        damping=d["damping"], tol=d["tol"],
                        priority=d["priority"], tenant=d["tenant"],
                        deadline_s=d["deadline_s"],
                        timeout_s=d["timeout_s"],
                        max_rounds=d["max_rounds"])


_RESULT_META_FIELDS = (
    "qid", "kind", "rounds", "messages", "lane", "admitted_tick",
    "completed_tick", "latency_s", "exchanged", "status", "partial",
    "cached", "tenant", "priority", "preemptions", "submitted_tick")


def _result_to_dict(r: QueryResult) -> dict:
    d = {f: getattr(r, f) for f in _RESULT_META_FIELDS}
    d["latency_s"] = float(d["latency_s"])
    d["has_values"] = r.values is not None
    return d


def _result_from_dict(d: dict, values) -> QueryResult:
    return QueryResult(values=values,
                       **{f: d[f] for f in _RESULT_META_FIELDS})


class _LanePool:
    """Shared pool plumbing: the lane tables live on the server's device
    as (S, R_max, Q) tensors, or this shard's (1, R_max, Q) rows when
    the server holds a mesh (``server._sg``).  ``step()`` runs one shared round and
    ``step_window(k)`` k rounds back to back, each returning device
    tensors (the server reads them in one transfer): the (Q,) message
    counts and, for a window, the (Q,) live-round counts summed over it.
    A lane that converges mid-window reads as the absorbing identity for
    the remaining rounds, so the summed accounting equals k single-round
    ticks exactly."""

    def __init__(self, part: Partition, n_lanes: int, cfg: EngineConfig,
                 arrays: engine.DeviceArrays, server):
        self.n = n_lanes
        self._cfg, self._server = cfg, server
        self._sg = server._sg
        self.dev = arrays.slot_valid.device
        self.reqs: list[QueryRequest | None] = [None] * n_lanes
        self._bind(part, arrays)

    def _bind(self, part: Partition, arrays: engine.DeviceArrays):
        """Point the pool at ``part`` and its device tables (a fresh
        ``DeviceArrays``: its launch plan and tables are ``part``'s)."""
        self.part, self._arrays = part, arrays
        self.exchange_volume = L._volume(part, self._cfg)
        self._valid = (np.asarray(part.slot_vertex) >= 0).reshape(-1)

    def put(self, x, dtype) -> torch.Tensor:
        """A host array on the card, copied without waiting for the
        card's queue (a blocking copy would synchronize the stream)."""
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=self.dev, dtype=dtype, non_blocking=True)

    def _rows(self, x):
        """The rows of a full (S, ...) host table this pool holds: all of
        them, or this shard's one."""
        if self._sg is None:
            return x
        r = self._sg.rank
        return x[r:r + 1]

    def _full(self, table) -> torch.Tensor:
        """A pool table as the full (S, R_max, Q) tensor (gathered over
        the shards when sharded: every rank takes part)."""
        if self._sg is None:
            return table
        return exchange.collectives.all_gather(table, self._sg)

    def _table(self, fill, dtype) -> torch.Tensor:
        rows = self.part.S if self._sg is None else 1
        return torch.full((rows, self.part.R_max, self.n), fill,
                          dtype=dtype, device=self.dev)

    def _write(self, table, lane: int, fill, col: np.ndarray):
        """Set lane ``lane`` of an (S, R_max, Q) table to the host column
        ``col`` ((S, R_max), ``fill`` everywhere but a few slots): the
        column is filled on the card and only its other slots cross —
        on a mesh, only the slots of this shard's rows."""
        table[:, :, lane] = fill
        col = self._rows(col)
        s, r = np.nonzero(col != fill)
        if s.size:
            table[self.put(s, torch.int64), self.put(r, torch.int64),
                  lane] = self.put(col[s, r], table.dtype)

    def live_dev(self) -> torch.Tensor:
        live = self.chg.reshape(-1, self.n).any(dim=0)
        if self._sg is not None:
            live = exchange.collectives.pmax(live, self._sg)
        return live

    def live(self) -> np.ndarray:
        """(Q,) live flags, reduced on the card; only they cross."""
        return self._server._read(self.live_dev())[0].copy()

    def step_window(self, k: int):
        counts = torch.zeros(self.n, dtype=torch.int64, device=self.dev)
        lives = torch.zeros(self.n, dtype=torch.int64, device=self.dev)
        for _ in range(k):
            lives += self.live_dev()
            counts += self.step()
        return counts, lives

    def _values(self, table, lane: int) -> np.ndarray:
        """Lane ``lane``'s per-vertex (root-replica) values, one copy."""
        return engine.vertex_values(
            self.part, self._server._read(self._full(table[:, :, lane]))[0])


class _MinPool(_LanePool):
    """Min-semiring lane pool: the laned fixpoint round of
    ``exchange.fixpoint_round_stacked`` (SSSP semiring, BFS lanes by
    ``lane_unitw``)."""

    def __init__(self, part, n_lanes, cfg, arrays, server):
        super().__init__(part, n_lanes, cfg, arrays, server)
        self.val = self._table(np.inf, torch.float32)
        self.chg = self._table(False, torch.bool)
        self.set_unitw(np.zeros(n_lanes, np.int32))

    def _bind(self, part, arrays):
        super()._bind(part, arrays)
        if self._sg is not None:
            srv = self._server
            self._round, _ = L.make_sharded_min_round(
                part.S, part.R_max, srv.mesh, srv.axis_names, self._cfg)

    def set_unitw(self, unitw):
        self.unitw = np.array(unitw, np.int32)
        self._unitw = self.put(self.unitw, torch.int32)

    def rebind(self, part: Partition, arrays: engine.DeviceArrays,
               insert_seeds=None, has_deletes: bool = False) -> None:
        """Swap the pool onto a mutated partition (streaming commit).

        Rounds run over ``arrays`` from now on (shapes may change when a
        splice grows ``R_max``).  Live lanes migrate: insert-only
        batches warm-continue — per-vertex values are still valid upper
        bounds, so they re-scatter onto the new replica layout with the
        lane frontier OR'd with the insert seeds (the old tables cross
        to the host in one read); a batch with deletes can RAISE min
        values, so every live lane restarts from its request (same lane,
        rounds keep accumulating)."""
        old_part = self.part
        live = [lane for lane, r in enumerate(self.reqs) if r is not None]
        warm = live and not has_deletes
        if warm:
            old_val, old_chg = self._server._read(self._full(self.val),
                                                  self._full(self.chg))
        self._bind(part, arrays)
        S, R_max = part.S, part.R_max
        val = np.full((S, R_max, self.n), np.inf, np.float32)
        chg = np.zeros((S, R_max, self.n), bool)
        if warm:
            # every lane at once: (n, Q) per-vertex values and frontier
            # flags (a vertex is live if any replica was), then scattered
            # onto the new layout; lanes without a request stay inert
            sv_old = np.asarray(old_part.slot_vertex)
            ok_old = sv_old >= 0
            sv_new = np.asarray(part.slot_vertex)
            ok_new = sv_new >= 0
            seeds = (np.asarray(insert_seeds, np.int64)
                     if insert_seeds is not None else np.zeros(0, np.int64))
            vv = old_val.reshape(-1, self.n)[old_part.root_flat]
            fl = np.zeros((part.n, self.n), bool)
            np.logical_or.at(fl, sv_old[ok_old], old_chg[ok_old])
            fl[seeds] |= np.isfinite(vv[seeds])
            occupied = np.zeros(self.n, bool)
            occupied[live] = True
            val[ok_new] = np.where(occupied, vv[sv_new[ok_new]], np.inf)
            chg[ok_new] = fl[sv_new[ok_new]] & occupied
        self.val = self.put(self._rows(val), torch.float32)
        self.chg = self.put(self._rows(chg), torch.bool)
        if not warm:
            for lane in live:
                self.inject(lane, self.reqs[lane])

    def inject(self, lane: int, req: QueryRequest):
        init, unitw = L.init_lane_values(
            self.part, [("bfs" if req.kind == "reachability" else req.kind,
                         req.sources)])
        col = init[..., 0]
        self._write(self.val, lane, np.inf, col)
        self._write(self.chg, lane, False, np.isfinite(col)
                    & self._valid.reshape(col.shape))
        self.unitw[lane] = int(unitw[0])
        self._unitw[lane] = int(unitw[0])
        self.reqs[lane] = req

    def step(self) -> torch.Tensor:
        part = self.part
        if self._sg is not None:
            self.val, self.chg, counts = self._round(
                self._arrays, self.val, self.chg, self._unitw)
            return counts
        self.val, self.chg, counts = exchange.fixpoint_round_stacked(
            actions.SSSP, self._arrays, self._cfg, part.S, part.R_max,
            self.val, self.chg, lane_unitw=self._unitw)
        return counts

    def extract(self, lane: int) -> np.ndarray:
        return L.decode_min_values(self._values(self.val, lane),
                                   self.reqs[lane].kind)

    def silence(self, lane: int):
        """Kill a lane's in-flight frontier (eviction before
        convergence): the lane reads as the absorbing identity until the
        next injection overwrites it."""
        self.chg[:, :, lane] = False


class _PprPool(_LanePool):
    """Sum-semiring lane pool on delta rounds
    (``query.lanes.make_ppr_delta_round``): per-lane seed, damping and
    residual tolerance, so converged and late lanes stop costing relax
    work."""

    def __init__(self, part, n_lanes, cfg, arrays, server):
        super().__init__(part, n_lanes, cfg, arrays, server)
        self._fresh_tables()
        self.set_lane_params(np.zeros(n_lanes, np.float32),
                             np.full(n_lanes, 1e-6, np.float32))

    def _bind(self, part, arrays):
        super()._bind(part, arrays)
        if self._sg is None:
            self._round = L.make_ppr_delta_round(part, self._cfg,
                                                 arrays=arrays)
        else:
            srv = self._server
            sharded, _ = L.make_sharded_ppr_delta_round(
                part.S, part.R_max, srv.mesh, srv.axis_names, self._cfg)
            self._round = lambda *a: sharded(arrays, *a)

    def _fresh_tables(self):
        self.rank = self._table(0.0, torch.float32)
        self.delta = self._table(0.0, torch.float32)
        self.chg = self._table(False, torch.bool)

    def rebind(self, part: Partition, arrays: engine.DeviceArrays,
               insert_seeds=None, has_deletes: bool = False) -> None:
        """Swap the pool onto a mutated partition (streaming commit).
        Sum-semiring residual state is exact only for the graph it was
        seeded on, so every live lane restarts from its request."""
        self._bind(part, arrays)
        self._fresh_tables()
        for lane, req in enumerate(self.reqs):
            if req is not None:
                self.inject(lane, req)

    def set_lane_params(self, damping, tol):
        self.damping = np.array(damping, np.float32)
        self.tol = np.array(tol, np.float32)
        self._damping = self.put(self.damping, torch.float32)
        self._tol = self.put(self.tol, torch.float32)

    def inject(self, lane: int, req: QueryRequest):
        srcs = np.asarray(req.sources).reshape(-1)
        if srcs.size != 1:
            raise QueryValidationError(
                f"ppr takes a single personalization seed; got "
                f"{srcs.size} sources")
        base = L.ppr_base_table(self.part, [int(srcs[0])],
                                [req.damping])[..., 0]
        self._write(self.rank, lane, 0.0, base)
        self._write(self.delta, lane, 0.0, base)
        self._write(self.chg, lane, False, (base > np.float32(req.tol))
                    & self._valid.reshape(base.shape))
        self.damping[lane] = req.damping
        self.tol[lane] = req.tol
        self._damping[lane] = float(self.damping[lane])
        self._tol[lane] = float(self.tol[lane])
        self.reqs[lane] = req

    def step(self) -> torch.Tensor:
        self.rank, self.delta, self.chg, counts = self._round(
            self.rank, self.delta, self._damping, self._tol)
        return counts

    def extract(self, lane: int) -> np.ndarray:
        return self._values(self.rank, lane).astype(np.float64)

    def silence(self, lane: int):
        self.delta[:, :, lane] = 0.0
        self.chg[:, :, lane] = False


class QueryServer:
    """Continuous batcher over query lanes sharing one compiled round.

    ``step()`` is one global round tick: apply any injected faults,
    expire queued deadlines, admit queued requests into free lanes
    (priority / fairness / preemption aware), advance each pool one
    laned round, retire converged lanes — and evict lanes whose
    deadline, timeout, or round budget ran out, with typed statuses and
    partial values.  ``run()`` drains the queue.  Occupancy / round /
    message counters are kept per lane for the serving metrics in
    ``benchmarks/query_bench.py`` and ``benchmarks/serve_bench.py``.

    ``mesh=`` (a ``DeviceMesh`` whose ``axis_names`` hold ``part.S``
    ranks) serves on the sharded layout, every rank running the same
    server (see the module docstring).  ``apply_mutation`` swaps the
    server onto a mutated partition between ticks
    (``StreamingGraph.bind_server``).

    ``serve=ServeConfig(...)`` enables the overload-safety layer; the
    default config reproduces the unpoliced server trace-identically.
    ``clock`` injects a virtual wall clock (tests); ``server.counters``
    tallies every typed outcome for the load harness's consistency
    check.

    ``tick_rounds=K`` makes each tick a K-round window: every pool's K
    rounds are enqueued back to back with no host read between them, so
    a tick costs one read of the window's counts instead of K.
    Converged lanes are inert mid-window and per-lane rounds/messages
    come from the window's live-round counts, so results and accounting
    are exactly the single-round tick's; ticks serving a lane with a
    max_rounds / deadline / timeout constraint fall back to single-round
    stepping automatically.

    Host reads: a pool with occupied lanes reads its (Q,) live flags
    once a tick and, when it steps, its counts and exit flags (and a
    window's live-round counts) in one more transfer; a retiring lane's
    values come back in one copy.  ``host_syncs`` counts them, and
    ``engine_host_syncs_total`` (runs ``server_min``, ``server_ppr``)
    the pools' share.  The tables stay on ``device`` (``None``: CUDA).
    """

    def __init__(self, part: Partition, n_lanes: int = 8,
                 cfg: EngineConfig = EngineConfig(),
                 ppr_lanes: int | None = None, mesh=None,
                 axis_names=("data", "model"),
                 serve: ServeConfig | None = None, clock=None,
                 tick_rounds: int = 1, device=None):
        self.part = part
        self.mesh = mesh
        self.axis_names = axis_names
        self._sg = (None if mesh is None
                    else engine.shard_group(part.S, mesh, axis_names))
        self.serve = serve if serve is not None else ServeConfig()
        if int(tick_rounds) < 1:
            raise ValueError(f"tick_rounds={tick_rounds!r}")
        # K-round window tick: each tick advances every pool up to K
        # rounds with one host read instead of K.  Ticks with a lane
        # under a max_rounds / deadline / timeout constraint fall back to
        # single-round stepping so eviction points stay exact;
        # tick_rounds=1 is the per-round tick, bit for bit.
        self.tick_rounds = int(tick_rounds)
        self._clock = clock if clock is not None else time.monotonic
        self._clock_offset = 0.0         # advanced by FaultPlan tick delays
        self.device = engine.resolve_device(device)
        self._cfg = cfg
        arrays = self._device_arrays(part)
        self.host_syncs = 0      # device->host reads made by the server
        self.min_pool = _MinPool(part, n_lanes, cfg, arrays, self)
        self.ppr_pool = _PprPool(
            part, n_lanes if ppr_lanes is None else ppr_lanes, cfg, arrays,
            self)
        self.queue = AdmissionQueue(
            self.serve.max_queue, self.serve.overload_policy,
            self.serve.tenant_weights)
        self.cache = ResultCache(self.serve.cache_size,
                                 self.serve.cache_ttl_s)
        self.results: dict[int, QueryResult] = {}
        self.counters = collections.Counter()
        self.tick = 0
        self.rounds_driven = 0   # pool rounds advanced (windows included)
        self._next_qid = 0
        self._lane_rounds = {}       # (pool, lane) -> rounds live
        self._lane_msgs = {}
        self._lane_exchanged = {}
        self._submit_time = {}       # qid -> clock time at submit
        self._submit_tick = {}       # qid -> tick at submit
        self._deadline_at = {}       # qid -> absolute clock deadline
        self._admit_tick = {}
        self._admit_time = {}        # (pool, lane) -> clock time at admit
        self._seq_of_qid = {}        # qid -> FIFO seq (preemption put-back)
        self._preempt_count = {}     # qid -> times preempted
        self._pools_used: set[int] = set()
        self.occupancy_trace: list[int] = []   # live lanes per tick
        self._obs_submit_t = {}      # qid -> tracer time at submit
        self._obs_admit_t = {}       # qid -> tracer time at admission
        self._ckpt_manager = None    # attach_checkpoints() wires saving
        self._resumed_qids: set[int] = set()   # lanes that crossed a restore

    def _device_arrays(self, part: Partition) -> engine.DeviceArrays:
        """One device copy of ``part``'s static graph tables, shared by
        both pools; the kernel path's launch plan (and the compact
        exchange's scatter index) is built here, not in a tick."""
        arrays = engine.DeviceArrays.from_partition(
            part, self.device,
            shard=None if self._sg is None else self._sg.rank)
        if self._cfg.use_pallas:
            arrays.launch_plan(self._cfg)
        if self._cfg.exchange == "compact":
            arrays.compact.inbox_index      # made now, not in a tick
        return arrays

    def now(self) -> float:
        """Server wall clock (injected faults advance it)."""
        return self._clock() + self._clock_offset

    # ------------------------------------------------------------- submit
    def submit(self, kind: str, sources, damping: float = 0.85,
               tol: float = 1e-6, qid: int | None = None,
               priority: int = 0, tenant: str = "default",
               deadline_s: float | None = None,
               timeout_s: float | None = None,
               max_rounds: int | None = None) -> int:
        if qid is None:
            qid = self._next_qid
        self._next_qid = max(self._next_qid, qid) + 1
        req = QueryRequest(qid=qid, kind=kind, sources=sources,
                           damping=damping, tol=tol, priority=priority,
                           tenant=tenant, deadline_s=deadline_s,
                           timeout_s=timeout_s, max_rounds=max_rounds)
        pool = self.ppr_pool if kind == "ppr" else self.min_pool
        if pool.n == 0:
            raise ValueError(
                f"no lanes for kind {kind!r}: the request could never be "
                "admitted (server built with 0 lanes in its pool)")
        self._check_sources_in_range(req)
        now = self.now()
        self._submit_time[qid] = now
        self._submit_tick[qid] = self.tick
        self.counters["submitted"] += 1
        rec = obs.get_recorder()
        if rec is not None:
            self._obs_submit_t[qid] = rec.tracer.now()
        if deadline_s is not None:
            self._deadline_at[qid] = now + deadline_s

        # root-keyed result cache: a fresh hit never touches a lane
        if self.serve.cache_size:
            hit = self.cache.get(_cache_key(req), now)
            if rec is not None:
                rec.registry.counter(
                    "serve_cache_total", "result-cache events").labels(
                        event="hit" if hit is not None else "miss").inc()
            if hit is not None:
                self.counters["cache_hits"] += 1
                self._finish(req, values=np.array(hit, copy=True),
                             status=QueryStatus.OK, partial=False,
                             cached=True, rounds=0)
                return qid
            self.counters["cache_misses"] += 1

        # zero round budget: resolve immediately with the initial values
        if max_rounds is not None and int(max_rounds) == 0:
            self._finish(req, values=self._initial_values(req),
                         status=QueryStatus.BUDGET_EXHAUSTED, partial=True,
                         rounds=0)
            return qid

        if self.serve.overload_policy == "block" and self.queue.full:
            spins = 0
            while self.queue.full:
                if spins >= self.serve.block_max_ticks:
                    raise AdmissionError(
                        f"blocked submit exceeded block_max_ticks="
                        f"{self.serve.block_max_ticks}")
                progressed = self.step()
                spins += 1
                if not progressed and self.queue.full:
                    raise AdmissionError(
                        "blocked submit cannot make progress: queue full "
                        "and the serving loop is drained")
        seq = self.queue.next_seq
        decision, victim = self.queue.offer(req, priority, tenant)
        if victim is not None:
            self._finish(victim, values=None, status=QueryStatus.SHED)
        if decision == "admitted":
            self._seq_of_qid[qid] = seq
        elif decision == "rejected":
            self._finish(req, values=None, status=QueryStatus.REJECTED)
        elif decision == "shed_incoming":
            self._finish(req, values=None, status=QueryStatus.SHED)
        return qid

    def _check_sources_in_range(self, req: QueryRequest):
        if isinstance(req.sources, dict):
            ids = list(req.sources.keys())
        elif isinstance(req.sources, (list, tuple, np.ndarray)):
            ids = np.asarray(req.sources).reshape(-1).tolist()
        else:
            ids = [req.sources]
        n = self.part.n
        for v in ids:
            if not (0 <= int(v) < n):
                raise QueryValidationError(
                    f"source vertex {int(v)} out of range for a graph "
                    f"with {n} vertices")

    def _initial_values(self, req: QueryRequest) -> np.ndarray:
        """The 0-round snapshot: what a lane would hold right after
        injection (zero-round-budget requests return this)."""
        if req.kind == "ppr":
            seed = int(np.asarray(req.sources).reshape(-1)[0])
            col = L.ppr_base_table(self.part, [seed], [req.damping])[..., 0]
            return engine.vertex_values(self.part, col).astype(np.float64)
        kind = "bfs" if req.kind == "reachability" else req.kind
        init, _ = L.init_lane_values(self.part, [(kind, req.sources)])
        vv = engine.vertex_values(self.part, init[..., 0])
        return L.decode_min_values(vv, req.kind)

    def _finish(self, req: QueryRequest, values, status: str,
                partial: bool = False, cached: bool = False,
                rounds: int = 0):
        """Resolve a request that never ran (or ran 0 rounds) with a
        typed status."""
        self.results[req.qid] = QueryResult(
            qid=req.qid, kind=req.kind, values=values, rounds=rounds,
            messages=0, lane=-1,
            admitted_tick=-1 if status in (QueryStatus.REJECTED,
                                           QueryStatus.SHED) else self.tick,
            completed_tick=self.tick,
            latency_s=self.now() - self._submit_time[req.qid],
            status=status, partial=partial, cached=cached,
            tenant=req.tenant, priority=req.priority,
            preemptions=self._preempt_count.get(req.qid, 0),
            submitted_tick=self._submit_tick[req.qid])
        self.counters[status] += 1
        self._obs_request_end(req, status, cached=cached)

    def _obs_request_end(self, req: QueryRequest, status: str,
                         cached: bool = False):
        """Terminal-status metrics + the request's lifecycle spans
        (queued→admitted→terminal) — no-op without an installed
        recorder."""
        rec = obs.get_recorder()
        if rec is None:
            return
        rec.registry.counter(
            "serve_requests_total", "terminal request statuses").labels(
                status=status, kind=req.kind).inc()
        end = rec.tracer.now()
        t0 = self._obs_submit_t.pop(req.qid, None)
        ta = self._obs_admit_t.pop(req.qid, None)
        if t0 is not None:
            rec.tracer.complete(
                "queued", track="requests", start=t0,
                end=ta if ta is not None else end,
                qid=req.qid, kind=req.kind)
        if ta is not None or cached:
            # cache hits never touch a lane: a zero-duration run at the
            # terminal instant keeps every lifecycle ending in a 'run'
            rec.tracer.complete(
                "run", track="requests",
                start=ta if ta is not None else end, end=end,
                qid=req.qid, kind=req.kind, status=status,
                cached=cached)

    # ---------------------------------------------------------- cache ops
    def invalidate_cache(self, root: int | None = None) -> int:
        """Invalidate cached results — rooted at ``root``, or the whole
        cache with None (the streaming-graph mutation hook).  Returns
        entries dropped; tallied in ``counters['cache_invalidations']``
        and the obs ``serve_cache_total{event="invalidation"}`` counter."""
        n = (self.cache.invalidate_all() if root is None
             else self.cache.invalidate(root))
        self.counters["cache_invalidations"] += n
        rec = obs.get_recorder()
        if rec is not None and n:
            rec.registry.counter(
                "serve_cache_total", "result-cache events").labels(
                    event="invalidation").inc(n)
        return n

    # ------------------------------------------------------- streaming ops
    def apply_mutation(self, new_part: Partition, insert_seeds=None,
                       has_deletes: bool = False,
                       affected_roots=None) -> None:
        """Swap the server onto a mutated partition between ticks (the
        ``StreamingGraph.commit`` hook).

        One fresh device copy of the new graph tables (with its own
        launch plan: nothing planned for the old partition survives)
        feeds both pools' ``rebind``: live min lanes warm-continue across
        insert-only batches (frontier OR'd with ``insert_seeds``) and
        restart when ``has_deletes``, PPR lanes always restart.  The
        result cache is then invalidated — the whole cache when
        ``affected_roots`` is None (exact: a mutation can move any root's
        result), else per affected root (the root-affine heuristic
        ``invalidate_cache(root)`` documents)."""
        arrays = self._device_arrays(new_part)
        self.part = new_part
        self.min_pool.rebind(new_part, arrays, insert_seeds=insert_seeds,
                             has_deletes=has_deletes)
        self.ppr_pool.rebind(new_part, arrays)
        if affected_roots is None:
            self.invalidate_cache(None)
        else:
            for root in np.asarray(affected_roots).reshape(-1):
                self.invalidate_cache(int(root))
        self.counters["mutations"] += 1
        rec = obs.get_recorder()
        if rec is not None:
            rec.registry.counter(
                "serve_mutations_total",
                "partition swaps applied between ticks").inc()

    # -------------------------------------------------------------- admit
    def _tenant_in_flight(self) -> dict:
        c: dict = {}
        for pool in (self.min_pool, self.ppr_pool):
            for r in pool.reqs:
                if r is not None:
                    c[r.tenant] = c.get(r.tenant, 0) + 1
        return c

    def _place(self, pool, lane: int, req: QueryRequest):
        pool.inject(lane, req)
        self._pools_used.add(id(pool))
        key = (id(pool), lane)
        self._lane_rounds[key] = 0
        self._lane_msgs[key] = 0
        self._lane_exchanged[key] = 0
        self._admit_tick[key] = self.tick
        self._admit_time[key] = self.now()
        self.counters["admitted"] += 1
        rec = obs.get_recorder()
        if rec is not None:
            self._obs_admit_t[req.qid] = rec.tracer.now()

    def _preempt(self, pool, lane: int):
        """Evict a running lane for a more urgent request: the victim is
        re-queued at its original FIFO position and restarts."""
        req = pool.reqs[lane]
        pool.silence(lane)
        pool.reqs[lane] = None
        self._preempt_count[req.qid] = \
            self._preempt_count.get(req.qid, 0) + 1
        self.counters["preemptions"] += 1
        rec = obs.get_recorder()
        if rec is not None:
            rec.registry.counter(
                "serve_preemptions_total", "running lanes preempted").inc()
            ta = self._obs_admit_t.pop(req.qid, None)
            if ta is not None:     # close the preempted stint's run span
                rec.tracer.complete("run", track="requests", start=ta,
                                    qid=req.qid, kind=req.kind,
                                    status="preempted")
            rec.tracer.instant("preempt", track="requests", qid=req.qid)
        back = self.queue.put_back(
            req, req.priority, req.tenant,
            self._seq_of_qid.get(req.qid, self.queue.next_seq))
        if back is False:
            self._finish(req, values=None, status=QueryStatus.SHED)
        elif back is not True:       # a lower-priority queued item displaced
            self._finish(back, values=None, status=QueryStatus.SHED)

    def _admit(self) -> list[int]:
        admitted = []
        for pool, kinds in ((self.min_pool, MIN_KINDS),
                            (self.ppr_pool, ("ppr",))):
            def pool_pred(r, kinds=kinds):
                return r.kind in kinds

            for lane in range(pool.n):
                if pool.reqs[lane] is not None or not len(self.queue):
                    continue
                entry = self.queue.take(pool_pred, self._tenant_in_flight())
                if entry is None:
                    break
                self._seq_of_qid[entry.item.qid] = entry.seq
                self._place(pool, lane, entry.item)
                admitted.append(entry.item.qid)
            # preemption: the best still-queued candidate may outrank the
            # lowest-priority running lane (strictly greater only, so
            # uniform-priority traffic never preempts)
            while self.serve.preempt and len(self.queue):
                entry = self.queue.peek(pool_pred, self._tenant_in_flight())
                if entry is None:
                    break
                occ = [(pool.reqs[l].priority,
                        -self._admit_tick[(id(pool), l)], l)
                       for l in range(pool.n) if pool.reqs[l] is not None]
                if not occ:
                    break
                victim_pri, _, victim_lane = min(occ)
                if entry.priority <= victim_pri:
                    break
                self.queue.remove(entry)
                self._preempt(pool, victim_lane)
                self._seq_of_qid[entry.item.qid] = entry.seq
                self._place(pool, victim_lane, entry.item)
                admitted.append(entry.item.qid)
        return admitted

    # --------------------------------------------------------------- step
    def _retire(self, pool, lane: int, status: str, partial: bool):
        with obs.span("server.retire", track="server", lane=lane):
            req = pool.reqs[lane]
            key = (id(pool), lane)
            if status == QueryStatus.OK and req.qid in self._resumed_qids:
                # the lane crossed a restore: the values are complete (and
                # bit-identical for min lanes) but the path was not clean
                status = QueryStatus.RECOVERED
            keep_values = (status == QueryStatus.OK
                           or status == QueryStatus.RECOVERED
                           or status in QueryStatus.PARTIAL_VALUED)
            values = pool.extract(lane) if keep_values else None
            self.results[req.qid] = QueryResult(
                qid=req.qid, kind=req.kind, values=values,
                rounds=self._lane_rounds[key],
                messages=self._lane_msgs[key], lane=lane,
                admitted_tick=self._admit_tick[key],
                completed_tick=self.tick,
                latency_s=self.now() - self._submit_time[req.qid],
                exchanged=self._lane_exchanged[key],
                status=status, partial=partial, tenant=req.tenant,
                priority=req.priority,
                preemptions=self._preempt_count.get(req.qid, 0),
                submitted_tick=self._submit_tick[req.qid])
            self.counters[status] += 1
            self._obs_request_end(req, status)
            if status == QueryStatus.OK and self.serve.cache_size:
                self.cache.put(_cache_key(req), np.array(values, copy=True),
                               self.now())
            pool.reqs[lane] = None             # lane freed immediately
            if status != QueryStatus.OK:
                pool.silence(lane)             # kill the in-flight frontier

    def _evict_overdue(self, pool, occupied, live_before):
        """Budget / deadline / timeout checks on still-live lanes.  A
        lane that already converged is retired OK by the normal path —
        convergence wins the race against a same-tick deadline expiry."""
        now = self.now()
        for lane in list(occupied):
            if not live_before[lane]:
                continue
            req = pool.reqs[lane]
            key = (id(pool), lane)
            status = None
            if req.max_rounds is not None \
                    and self._lane_rounds[key] >= req.max_rounds:
                status = QueryStatus.BUDGET_EXHAUSTED
            elif req.deadline_s is not None \
                    and now >= self._deadline_at[req.qid]:
                status = QueryStatus.DEADLINE_EXPIRED
            elif req.timeout_s is not None \
                    and now >= self._admit_time[key] + req.timeout_s:
                status = QueryStatus.TIMEOUT
            if status is not None:
                self._retire(pool, lane, status, partial=True)
                occupied.remove(lane)
                live_before[lane] = False

    def _tick_window(self, pool, occupied) -> int:
        """Rounds this tick may advance in one dispatch: ``tick_rounds``
        unless some occupied lane carries a per-round constraint
        (max_rounds / deadline_s / timeout_s), whose eviction point
        must stay exact at round granularity."""
        if self.tick_rounds == 1:
            return 1
        for lane in occupied:
            r = pool.reqs[lane]
            if r.max_rounds is not None or r.deadline_s is not None \
                    or r.timeout_s is not None:
                return 1
        return self.tick_rounds

    def _step_pool(self, pool):
        occupied = [lane for lane in range(pool.n)
                    if pool.reqs[lane] is not None]
        if not occupied:
            return 0
        with obs.span("server.step", track="server"):
            live_before = pool.live()             # writable: evictions
            syncs = 1
            self._evict_overdue(pool, occupied, live_before)  # lanes off
            lives = None       # per-lane live-round counts (window tick)
            stepped = any(live_before[lane] for lane in occupied)
            if not stepped:
                # occupied-but-converged lanes (e.g. empty-frontier
                # queries) still retire below; nothing ran, so nothing
                # else changed
                counts = np.zeros(pool.n, np.int64)
                live_after = live_before
            else:
                k = self._tick_window(pool, occupied)
                if k == 1:
                    reads = (pool.step(),)
                else:
                    reads = pool.step_window(k)
                # counts (and a window's live rounds) with the exit
                # flags, one transfer
                out = self._read(*reads, pool.live_dev())
                counts, live_after = out[0], out[-1]
                if k > 1:
                    lives = out[1]
                self.rounds_driven += k
                syncs += 1
        engine._count_dispatches(
            "server_min" if pool is self.min_pool else "server_ppr",
            int(stepped), syncs)
        n_live = 0
        for lane in occupied:
            key = (id(pool), lane)
            if live_before[lane]:
                rl = 1 if lives is None else int(lives[lane])
                self._lane_rounds[key] += rl
                self._lane_msgs[key] += int(counts[lane])
                self._lane_exchanged[key] += pool.exchange_volume * rl
                n_live += 1
            if not live_after[lane]:           # converged -> evict now
                self._retire(pool, lane, QueryStatus.OK, partial=False)
        return n_live

    def _read(self, *tensors):
        """One device->host transfer of ``tensors`` (numpy out)."""
        self.host_syncs += 1
        return engine._fetch(*tensors)

    def _apply_faults(self):
        plan = self.serve.faults
        if plan is None:
            return
        delay = plan.delay_at(self.tick)
        if delay:
            self._clock_offset += delay    # a stalled tick, without sleeping
            self.counters["injected_delays"] += 1
        for pool_name, lane in plan.failures_at(self.tick):
            pool = self.min_pool if pool_name == "min" else self.ppr_pool
            if 0 <= lane < pool.n and pool.reqs[lane] is not None:
                self.counters["injected_lane_failures"] += 1
                self._retire(pool, lane, QueryStatus.FAILED, partial=True)

    def _expire_queued(self):
        if not len(self.queue):
            return
        now = self.now()
        expired = self.queue.drain_if(
            lambda r: r.deadline_s is not None
            and now >= self._deadline_at[r.qid])
        for req in expired:
            self._finish(req, values=None,
                         status=QueryStatus.DEADLINE_EXPIRED)

    def step(self) -> bool:
        """One global round tick. Returns False when fully drained."""
        rec = obs.get_recorder()
        span = (rec.tracer.span("server.tick", track="server",
                                tick=self.tick)
                if rec is not None else None)
        self._apply_faults()
        self._expire_queued()
        with obs.span("server.admit", track="server"):
            self._admit()
        n_live = self._step_pool(self.min_pool) \
            + self._step_pool(self.ppr_pool)
        self.occupancy_trace.append(n_live)
        self.tick += 1
        K = self.serve.checkpoint_every
        if self._ckpt_manager is not None and K and self.tick % K == 0:
            self.save_checkpoint()
        if rec is not None:
            depth = len(self.queue)
            span.end(live=n_live, queue=depth)
            rec.registry.counter("serve_ticks_total",
                                 "server round ticks").inc()
            rec.registry.gauge("serve_queue_depth",
                               "queued requests after the tick").set(depth)
            rec.tracer.counter("server",
                               {"queue_depth": depth, "live_lanes": n_live})
        return bool(n_live or len(self.queue)
                    or any(r is not None for r in self.min_pool.reqs)
                    or any(r is not None for r in self.ppr_pool.reqs))

    def run(self, max_ticks: int = 10000) -> dict[int, QueryResult]:
        for _ in range(max_ticks):
            if not self.step():
                break
        return self.results

    # ------------------------------------------------- checkpoint/restore
    def attach_checkpoints(self, manager) -> None:
        """Wire a ``CheckpointManager``: with ``ServeConfig.
        checkpoint_every=K`` set, ``step()`` snapshots the whole serving
        state every K ticks (async, atomic, crc-verified)."""
        self._ckpt_manager = manager

    def snapshot(self) -> tuple[dict, dict]:
        """(array tree, JSON meta) capturing the server at a tick
        boundary: both pools' lane tables + per-lane unit-weight /
        damping / tolerance vectors, every queued and in-flight request,
        the per-lane accounting, completed results, and the admission
        queue — everything ``restore`` needs to warm-boot a server whose
        min lanes resume bit-identically."""
        mp, pp = self.min_pool, self.ppr_pool
        tree = {
            "min": {"val": mp._full(mp.val).cpu().numpy(),
                    "chg": mp._full(mp.chg).cpu().numpy(),
                    "unitw": np.array(self.min_pool.unitw, copy=True)},
            "ppr": {"rank": pp._full(pp.rank).cpu().numpy(),
                    "delta": pp._full(pp.delta).cpu().numpy(),
                    "chg": pp._full(pp.chg).cpu().numpy(),
                    "damping": np.array(self.ppr_pool.damping, copy=True),
                    "tol": np.array(self.ppr_pool.tol, copy=True)},
            "results": {str(qid): np.asarray(r.values)
                        for qid, r in self.results.items()
                        if r.values is not None},
        }
        pools = {"min": self.min_pool, "ppr": self.ppr_pool}
        lanes = {}
        for name, pool in pools.items():
            rows = []
            for lane, req in enumerate(pool.reqs):
                if req is None:
                    rows.append(None)
                    continue
                key = (id(pool), lane)
                rows.append({
                    "req": _req_to_dict(req),
                    "rounds": int(self._lane_rounds[key]),
                    "msgs": int(self._lane_msgs[key]),
                    "exchanged": int(self._lane_exchanged[key]),
                    "admit_tick": int(self._admit_tick[key]),
                    "admit_time": float(self._admit_time[key]),
                })
            lanes[name] = rows
        meta = {
            "n_lanes": self.min_pool.n, "ppr_lanes": self.ppr_pool.n,
            "tick_rounds": self.tick_rounds,
            "tick": self.tick, "rounds_driven": self.rounds_driven,
            "next_qid": self._next_qid, "now": float(self.now()),
            "counters": {k: int(v) for k, v in self.counters.items()},
            "occupancy_trace": [int(x) for x in self.occupancy_trace],
            "pools_used": [n for n, p in pools.items()
                           if id(p) in self._pools_used],
            "lanes": lanes,
            "queue": {
                "seq": self.queue.next_seq,
                "entries": [[int(e.seq), int(e.priority), e.tenant,
                             _req_to_dict(e.item)]
                            for e in self.queue._entries]},
            "submit_time": {str(k): float(v)
                            for k, v in self._submit_time.items()},
            "submit_tick": {str(k): int(v)
                            for k, v in self._submit_tick.items()},
            "deadline_at": {str(k): float(v)
                            for k, v in self._deadline_at.items()},
            "seq_of_qid": {str(k): int(v)
                           for k, v in self._seq_of_qid.items()},
            "preempt_count": {str(k): int(v)
                              for k, v in self._preempt_count.items()},
            "resumed_qids": sorted(self._resumed_qids),
            "results": [_result_to_dict(r) for r in self.results.values()],
        }
        return tree, meta

    def save_checkpoint(self, blocking: bool = False) -> int:
        """Snapshot the serving state to the attached manager at the
        current tick (async by default).  Returns the checkpoint step."""
        if self._ckpt_manager is None:
            raise RuntimeError("no CheckpointManager attached "
                               "(call attach_checkpoints first)")
        tree, meta = self.snapshot()
        self._ckpt_manager.save(self.tick, tree, blocking=blocking,
                                meta=meta)
        rec = obs.get_recorder()
        if rec is not None:
            rec.registry.counter(
                "serve_checkpoints_total",
                "serving-state checkpoints written").inc()
        return self.tick

    @classmethod
    def restore(cls, part: Partition, manager, *, step: int | None = None,
                cfg: EngineConfig = EngineConfig(), mesh=None,
                axis_names=("data", "model"),
                serve: ServeConfig | None = None, clock=None, device=None):
        """Warm-boot a server from a checkpoint: lane tables, queued and
        in-flight requests, accounting, and results all resume at the
        checkpointed tick — min-semiring lanes bit-identically (same
        tables, same compiled round).  In-flight lanes complete with
        ``QueryStatus.RECOVERED``.  ``part``/``cfg``/``mesh`` must
        describe the same served graph the checkpoint was taken on."""
        if step is None:
            step = manager.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint to restore from")
        meta = manager.restore_meta(step)
        srv = cls(part, n_lanes=meta["n_lanes"], cfg=cfg,
                  ppr_lanes=meta["ppr_lanes"], mesh=mesh,
                  axis_names=axis_names, serve=serve, clock=clock,
                  tick_rounds=meta["tick_rounds"], device=device)
        like = {
            "min": {"val": 0, "chg": 0, "unitw": 0},
            "ppr": {"rank": 0, "delta": 0, "chg": 0, "damping": 0,
                    "tol": 0},
            "results": {str(r["qid"]): 0 for r in meta["results"]
                        if r["has_values"]},
        }
        tree = manager.restore(step, like)
        srv._load_snapshot(tree, meta)
        return srv

    def _load_snapshot(self, tree: dict, meta: dict):
        mp, pp = self.min_pool, self.ppr_pool
        mp.val = mp.put(mp._rows(tree["min"]["val"]), torch.float32)
        mp.chg = mp.put(mp._rows(tree["min"]["chg"]), torch.bool)
        mp.set_unitw(tree["min"]["unitw"])
        pp.rank = pp.put(pp._rows(tree["ppr"]["rank"]), torch.float32)
        pp.delta = pp.put(pp._rows(tree["ppr"]["delta"]), torch.float32)
        pp.chg = pp.put(pp._rows(tree["ppr"]["chg"]), torch.bool)
        pp.set_lane_params(tree["ppr"]["damping"], tree["ppr"]["tol"])
        self.tick = int(meta["tick"])
        self.rounds_driven = int(meta["rounds_driven"])
        self._next_qid = int(meta["next_qid"])
        self.counters = collections.Counter(meta["counters"])
        self.occupancy_trace = list(meta["occupancy_trace"])
        pools = {"min": mp, "ppr": pp}
        self._pools_used = {id(pools[n]) for n in meta["pools_used"]}
        for name, pool in pools.items():
            for lane, row in enumerate(meta["lanes"][name]):
                if row is None:
                    continue
                req = _req_from_dict(row["req"])
                pool.reqs[lane] = req
                key = (id(pool), lane)
                self._lane_rounds[key] = row["rounds"]
                self._lane_msgs[key] = row["msgs"]
                self._lane_exchanged[key] = row["exchanged"]
                self._admit_tick[key] = row["admit_tick"]
                self._admit_time[key] = row["admit_time"]
                self._resumed_qids.add(req.qid)
                if name == "min":
                    _, unitw = L.init_lane_values(
                        self.part,
                        [("bfs" if req.kind == "reachability"
                          else req.kind, req.sources)])
                    pool.unitw[lane] = int(unitw[0])
        mp.set_unitw(mp.unitw)
        self.queue._entries = [
            _adm._Entry(seq, pri, tenant, _req_from_dict(d))
            for seq, pri, tenant, d in meta["queue"]["entries"]]
        self.queue._seq = int(meta["queue"]["seq"])
        self._submit_time = {int(k): v
                             for k, v in meta["submit_time"].items()}
        self._submit_tick = {int(k): v
                             for k, v in meta["submit_tick"].items()}
        self._deadline_at = {int(k): v
                             for k, v in meta["deadline_at"].items()}
        self._seq_of_qid = {int(k): v
                            for k, v in meta["seq_of_qid"].items()}
        self._preempt_count = {int(k): v
                               for k, v in meta["preempt_count"].items()}
        self._resumed_qids.update(meta["resumed_qids"])
        for rd in meta["results"]:
            vals = (tree["results"][str(rd["qid"])]
                    if rd["has_values"] else None)
            self.results[rd["qid"]] = _result_from_dict(rd, vals)
        # resume the snapshot's wall clock so restored deadlines /
        # timeouts / latencies stay coherent under any injected clock
        self._clock_offset = meta["now"] - self._clock()

    def degrade_in_flight(self) -> list[int]:
        """Graceful degradation when recovery is impossible (no usable
        checkpoint, restore budget exhausted): every in-flight lane
        retires with ``QueryStatus.DEGRADED`` partial values, every
        queued request resolves ``DEGRADED`` with no values.  The server
        stays serviceable for new traffic.  Returns the affected qids."""
        out = []
        for pool in (self.min_pool, self.ppr_pool):
            for lane in range(pool.n):
                if pool.reqs[lane] is not None:
                    out.append(pool.reqs[lane].qid)
                    self._retire(pool, lane, QueryStatus.DEGRADED,
                                 partial=True)
        for req in self.queue.drain_if(lambda r: True):
            out.append(req.qid)
            self._finish(req, values=None, status=QueryStatus.DEGRADED)
        return out

    # ------------------------------------------------------------ metrics
    def occupancy(self) -> float:
        """Mean live lanes per tick over the capacity of the pools that
        actually served requests (serving utilization)."""
        if not self.occupancy_trace:
            return 0.0
        cap = sum(pool.n for pool in (self.min_pool, self.ppr_pool)
                  if id(pool) in self._pools_used)
        return float(np.mean(self.occupancy_trace)) / max(cap, 1)

    def in_flight(self) -> int:
        return sum(r is not None for pool in (self.min_pool, self.ppr_pool)
                   for r in pool.reqs)
