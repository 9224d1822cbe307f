"""Streaming graphs: batched mutations with incremental recompute
(paper §7 "recompute from there without starting from scratch").

`StreamingGraph` owns a mutable COO graph plus per-app *views* (the
plain graph for BFS/SSSP, the 1/out-degree-weighted graph for
delta-PageRank, the symmetrized zero-weight graph for CC), each mapped
by a spliced partition.  Mutation batches are buffered by
``insert_edges`` / ``delete_edges`` and applied by ``commit()``:

* **In-place partition splicing** — ``partition.splice_partition``
  regenerates only the shard rows the batch touched; counter-hashed
  placement makes the result field-for-field equal to a from-scratch
  ``build_partition`` of the post-mutation graph.
* **Adaptive rhizome growth** — the Eq. 1 cutoff is *pinned* to the
  initial graph (``PartitionConfig.indegree_cutoff``, the CCA
  exemplars' fixed ``RHIZOME_INDEGREE_CUTOFF``), so a vertex whose
  streamed in-degree crosses k·cutoff splits into its k-th rhizome
  replica online; the splice creates the slot and value migration seeds
  it with the root's current value.
* **Incremental result maintenance** — tracked queries are refreshed
  per batch instead of recomputed cold:

  - monotone min apps (BFS/SSSP/CC): old values are valid upper bounds
    after inserts, so the fixpoint warm-starts with ``init_changed``
    seeded only at the insert sources; deletes first run per-vertex
    *support invalidation* (a value is kept only while some surviving
    in-edge still realizes it — processed in increasing-value order,
    exact for positive weights) and re-lift only the invalidated
    region.  CC (zero weights, cyclic support) invalidates the deleted
    edges' whole components and reseeds them with self-labels.
    Min-semiring results are **bit-identical** to a cold fixpoint on
    the same partition (same f32 path-sum set, order-independent min).
  - delta-PageRank: ranks migrate as-is and the residual table is
    seeded with the exact base-case correction ``d·(A'-A)ᵀ p`` on the
    mutated sources' neighborhoods (negative residuals diffuse via the
    ``|delta| > tol`` frontier), so only the affected region re-runs.

Runners: ``runner='stacked'`` drives ``engine.run_stacked`` per query,
``'lanes'`` batches every tracked min query of a view into one laned
fixpoint (Q lanes, ``lanes.run_stacked_lanes``), ``'sharded'`` does the
same through ``lanes.run_sharded_lanes`` over ``mesh`` (a ``DeviceMesh``:
every rank holds the same ``StreamingGraph`` and makes the same calls;
each commit uploads this rank's shard of each view it maintains, and
delta-PageRank runs ``engine.run_pagerank_delta_sharded``).

Every fixpoint runs on ``device`` (``None``: CUDA).  A commit uploads
each view it maintains once, as a fresh ``DeviceArrays`` of the spliced
partition that all of the view's fixpoints share, and drops them when
it ends: no launch plan, launch table or worklist planner outlives a
commit.  The graph, the splices, the support invalidation and the
PageRank correction stay on the host (numpy); tracked values are host
arrays.  ``commit_seconds`` holds the last commit's host-clock split:
``splice``, then maintenance as ``prepare`` (the host's warm state:
invalidation, scatters, the PageRank correction), ``upload`` (the
views' device arrays, synced) and ``fixpoint`` (the warm fixpoints,
their results read back), with ``maintain`` their sum, and ``servers``.
``fixpoint_seconds`` gives each warm fixpoint's seconds by tracked key
(under ``runner='lanes'`` the one laned fixpoint of the min queries is
keyed ``'lanes'``).
"""
from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import actions, engine
from repro_torch.core.partition import (Partition, PartitionConfig,
                                        SpliceInfo, _stable_argsort,
                                        build_partition, splice_partition)
from repro_torch.graph.graph import COOGraph

_MIN_APPS = ("bfs", "sssp", "cc")


# --------------------------------------------------------------------------
# value-table scatter/gather helpers (per-vertex <-> (S, R_max) slots)
# --------------------------------------------------------------------------

def scatter_vertex_values(part: Partition, vv: np.ndarray,
                          fill: float = np.inf) -> np.ndarray:
    """(n,) per-vertex values -> (S, R_max) float32 slot table; every
    replica of v gets ``vv[v]`` (consistent view), invalid slots get
    ``fill`` so they never participate."""
    out = np.full((part.S, part.R_max), fill, np.float32)
    sv = np.asarray(part.slot_vertex)
    valid = sv >= 0
    out[valid] = np.asarray(vv, np.float32)[sv[valid]]
    return out


def scatter_vertex_flags(part: Partition, flags: np.ndarray) -> np.ndarray:
    """(n,) bool -> (S, R_max) bool on every replica of flagged vertices."""
    out = np.zeros((part.S, part.R_max), bool)
    sv = np.asarray(part.slot_vertex)
    valid = sv >= 0
    out[valid] = np.asarray(flags, bool)[sv[valid]]
    return out


# --------------------------------------------------------------------------
# delete-side support invalidation (the bounded re-lift)
# --------------------------------------------------------------------------

def invalidate_unsupported(g: COOGraph, values: np.ndarray,
                           del_src, del_dst, del_w,
                           pinned: np.ndarray,
                           unit_w: bool) -> np.ndarray:
    """Which vertices' min-fixpoint values a deletion batch invalidates.

    ``values`` is the pre-delete fixpoint, ``g`` the POST-delete graph.
    A finite, non-pinned value survives only while some in-edge of the
    new graph still *supports* it (``f32(val[u] + w) == val[v]`` with u
    valid).  Candidates are processed in increasing value order, so for
    strictly positive effective weights every potential supporter is
    finalized first and the result is exact; cost is proportional to
    the affected region, not the graph.  ``unit_w`` uses weight 1 per
    edge (BFS levels); otherwise ``g.weight`` must be positive —
    non-positive weights fall back to invalidating every non-pinned
    finite vertex (a whole-value re-lift, still exact)."""
    n = g.n
    vals = np.asarray(values, np.float32)
    finite = np.isfinite(vals)
    E = g.num_edges
    w_eff = (np.ones(E, np.float32) if unit_w
             else np.asarray(g.weight, np.float32))
    if not unit_w and E and float(w_eff.min()) <= 0.0:
        return finite & ~pinned

    order_in = _stable_argsort(g.dst, n)
    in_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(g.dst, minlength=n), out=in_indptr[1:])
    in_src = g.src[order_in]
    in_w = w_eff[order_in]
    order_out = _stable_argsort(g.src, n)
    out_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(g.src, minlength=n), out=out_indptr[1:])
    out_dst = g.dst[order_out]
    out_w = w_eff[order_out]

    invalid = np.zeros(n, bool)
    revalidated = np.zeros(n, bool)
    heap: list[tuple[float, int]] = []
    dw = (np.ones(len(del_src), np.float32) if unit_w
          else np.asarray(del_w, np.float32))
    for u, v, w in zip(np.asarray(del_src), np.asarray(del_dst), dw):
        u, v = int(u), int(v)
        if pinned[v] or not finite[v] or not finite[u]:
            continue
        if np.float32(vals[u] + np.float32(w)) == vals[v]:
            heapq.heappush(heap, (float(vals[v]), v))
    while heap:
        _, v = heapq.heappop(heap)
        if revalidated[v] or invalid[v]:
            continue
        supported = False
        for i in range(in_indptr[v], in_indptr[v + 1]):
            u = int(in_src[i])
            if invalid[u] or not finite[u]:
                continue
            if np.float32(vals[u] + in_w[i]) == vals[v]:
                supported = True
                break
        if supported:
            revalidated[v] = True
            continue
        invalid[v] = True
        for i in range(out_indptr[v], out_indptr[v + 1]):
            x = int(out_dst[i])
            if pinned[x] or invalid[x] or revalidated[x] or not finite[x]:
                continue
            if np.float32(vals[v] + out_w[i]) == vals[x]:
                heapq.heappush(heap, (float(vals[x]), x))
    return invalid


# --------------------------------------------------------------------------
# per-batch bookkeeping
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MaintStats:
    """Incremental-maintenance accounting for one tracked query."""

    app: str
    mode: str                      # 'warm' (incremental) | 'cold'
    rounds: int
    messages: int
    work: int
    seeds: int                     # frontier vertices seeded
    invalidated: int               # vertices invalidated by deletes


@dataclasses.dataclass
class CommitInfo:
    """What one ``commit()`` did: splice + maintenance summary."""

    inserted: int
    deleted: int
    mutated_src: np.ndarray
    mutated_dst: np.ndarray
    splices: dict                  # view name -> SpliceInfo
    maint: dict                    # tracked key -> MaintStats
    replicas_added: int            # adaptive rhizome splits (base view)


@dataclasses.dataclass
class _View:
    name: str
    graph: COOGraph
    part: Partition


def _pr_weights(g: COOGraph) -> COOGraph:
    # the exact weighting apps.pagerank uses, so streamed pr views are
    # bit-compatible with cold pagerank partitions
    from repro_torch.apps.pagerank import _pr_graph
    return _pr_graph(g)


class StreamingGraph:
    """Mutable graph + spliced partitions + incrementally-maintained
    query results (see module docstring)."""

    def __init__(self, g: COOGraph, pcfg: PartitionConfig,
                 cfg: engine.EngineConfig = engine.EngineConfig(),
                 runner: str = "stacked", mesh=None,
                 axis_names=("data", "model"),
                 staleness_slo: float | None = None,
                 staleness_metric: str = "edges", device=None):
        if runner not in ("stacked", "lanes", "sharded"):
            raise ValueError(f"unknown runner {runner!r}")
        if runner == "sharded" and mesh is None:
            raise ValueError("runner='sharded' runs over a mesh: pass mesh=")
        if staleness_metric not in ("edges", "pr_mass"):
            raise ValueError(f"unknown staleness metric "
                             f"{staleness_metric!r}")
        if staleness_slo is not None and not staleness_slo > 0:
            raise ValueError(f"staleness_slo must be > 0; got "
                             f"{staleness_slo!r}")
        if pcfg.indegree_cutoff is None:
            # pin Eq. 1's cutoff to the initial graph so streamed
            # in-degree growth splits rhizomes instead of re-deriving
            # every vertex's replica count from a moving global max
            indeg_max = max(int(g.in_degrees().max()) if g.n else 1, 1)
            pcfg = dataclasses.replace(
                pcfg,
                indegree_cutoff=max(
                    int(np.ceil(indeg_max / pcfg.rpvo_max)), 1))
        self.g = g
        self.pcfg = pcfg
        self.cfg = cfg
        self.runner = runner
        self.mesh = mesh
        self.axis_names = axis_names
        self.device = device
        self._views: dict[str, _View] = {
            "base": _View("base", g, build_partition(g, pcfg))}
        self._pending_ins: list[tuple] = []
        self._pending_del: list[tuple] = []
        self.tracked: dict[tuple, dict] = {}
        self._servers: list[tuple] = []
        self._commits = 0
        # sym-view directed-pair support counts (lazy, see _ensure_view)
        self._mult: dict[int, int] | None = None
        # deferred-commit staleness SLO (see staleness())
        self.staleness_slo = staleness_slo
        self._staleness_metric = staleness_metric
        self.auto_refreshes = 0
        self.commit_seconds: dict[str, float] = {}
        self.fixpoint_seconds: dict = {}
        self._arrays: dict[str, engine.DeviceArrays] = {}
        self._upload_s = 0.0

    # ------------------------------------------------------------- views
    def view(self, name: str) -> _View:
        if name not in self._views:
            self._views[name] = self._make_view(name)
        return self._views[name]

    def _make_view(self, name: str) -> _View:
        if name == "pr":
            gv = _pr_weights(self.g)
        elif name == "sym":
            gv = self._build_sym()
        else:
            raise ValueError(f"unknown view {name!r}")
        return _View(name, gv, build_partition(gv, self.pcfg))

    def _build_sym(self) -> COOGraph:
        """Symmetrized zero-weight dedup'd view, with directed-pair
        support counts so later batches can maintain the edge *order*
        incrementally (append/delete only — a from-scratch dedup would
        reshuffle first-occurrence order and defeat the splice)."""
        g, n = self.g, self.g.n
        key = np.concatenate([
            g.src.astype(np.int64) * n + g.dst,
            g.dst.astype(np.int64) * n + g.src])
        self._mult = {}
        for k in key.tolist():
            self._mult[k] = self._mult.get(k, 0) + 1
        uniq, first = np.unique(key, return_index=True)
        keep = np.sort(first)
        sk = key[keep]
        return COOGraph(n, (sk // n).astype(np.int32),
                        (sk % n).astype(np.int32),
                        np.zeros(sk.size, np.float32))

    # ---------------------------------------------------------- tracking
    def track(self, app: str, root: int | None = None,
              damping: float = 0.85, tol: float = 1e-7,
              max_rounds: int = 256) -> np.ndarray:
        """Register a query for incremental maintenance; computes it
        cold once and returns the per-vertex values."""
        if app in ("bfs", "sssp"):
            assert root is not None
            key = (app, int(root))
            view = self.view("base")
            init = engine.init_values(
                view.part, actions.BFS if app == "bfs" else actions.SSSP,
                {int(root): 0.0})
            vals, _ = self._run_min_single(
                view, init, scatter_vertex_flags(
                    view.part, self._root_flag(int(root))),
                unitw=1 if app == "bfs" else 0)
            self.tracked[key] = {"vals": vals}
        elif app == "cc":
            key = ("cc", None)
            view = self.view("sym")
            ids = np.arange(self.g.n, dtype=np.float32)
            vals, _ = self._run_min_single(
                view, scatter_vertex_values(view.part, ids),
                scatter_vertex_flags(view.part, np.ones(self.g.n, bool)),
                unitw=0)
            self.tracked[key] = {"vals": vals}
        elif app == "pagerank":
            key = ("pagerank", None)
            view = self.view("pr")
            rank_t, _ = self._run_pr(view, damping, tol, max_rounds,
                                     None, None)
            self.tracked[key] = {
                "vals": engine.vertex_values(view.part, rank_t),
                "damping": float(damping), "tol": float(tol),
                "max_rounds": int(max_rounds)}
        else:
            raise ValueError(f"unknown app {app!r}")
        return self.tracked[key]["vals"]

    def values(self, app: str, root: int | None = None) -> np.ndarray:
        key = (app, int(root) if app in ("bfs", "sssp") else None)
        return self.tracked[key]["vals"]

    def _root_flag(self, root: int) -> np.ndarray:
        f = np.zeros(self.g.n, bool)
        f[root] = True
        return f

    # --------------------------------------------------------- mutations
    def insert_edges(self, src, dst, weight=None) -> None:
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        w = (np.ones(src.size, np.float32) if weight is None
             else np.asarray(weight, np.float32).reshape(-1))
        self._pending_ins.append((src, dst, w))
        self._maybe_auto_refresh()

    def delete_edges(self, src, dst) -> None:
        """Buffer deletion of every edge matching each (src, dst) pair."""
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        self._pending_del.append((src, dst))
        self._maybe_auto_refresh()

    # ------------------------------------------------- staleness SLO
    def staleness(self) -> float:
        """How stale the tracked results are under the deferred
        (uncommitted) mutations.  ``'edges'``: buffered edge-mutation
        count.  ``'pr_mass'``: an upper bound on the L1 norm of the
        zeroth-order delta-PageRank correction ``d·(A'-A)ᵀ p`` —
        ``d · Σ p[u]`` over the pending mutations' distinct source
        vertices (each mutated source redistributes at most its full
        damped rank mass) — i.e. staleness in rank units rather than
        edge counts.  Falls back to the edge count when no pagerank
        query is tracked."""
        n_pend = sum(int(x[0].size) for x in self._pending_ins) \
            + sum(int(x[0].size) for x in self._pending_del)
        if self._staleness_metric == "edges" \
                or ("pagerank", None) not in self.tracked:
            return float(n_pend)
        if n_pend == 0:
            return 0.0
        srcs = np.unique(np.concatenate(
            [x[0] for x in self._pending_ins]
            + [x[0] for x in self._pending_del]).astype(np.int64))
        p = np.asarray(self.tracked[("pagerank", None)]["vals"],
                       np.float64)
        d = self.tracked[("pagerank", None)]["damping"]
        return float(d * p[srcs].sum())

    def _maybe_auto_refresh(self):
        """Deferred-commit auto-refresh (the staleness SLO): buffering
        is free until the staleness crosses ``staleness_slo``, at which
        point the batch commits — bounded staleness without paying a
        splice per mutation."""
        if self.staleness_slo is None:
            return
        if self.staleness() > self.staleness_slo:
            self.auto_refreshes += 1
            rec = obs.get_recorder()
            if rec is not None:
                rec.registry.counter(
                    "stream_auto_refresh_total",
                    "commits triggered by the staleness SLO").inc()
            self.commit()

    def bind_server(self, server, cache_invalidation: str = "all") -> None:
        """Wire a ``QueryServer`` serving the base view: each commit
        applies the mutation between ticks (``server.apply_mutation``)
        and fires its cache-invalidation hooks.  ``cache_invalidation``:
        ``'all'`` flushes the result cache (exact — any root's result
        may change); ``'roots'`` fires ``invalidate_cache(root)`` per
        mutated endpoint (the root-affine heuristic)."""
        assert cache_invalidation in ("all", "roots")
        self._servers.append((server, cache_invalidation))

    # ------------------------------------------------------------ commit
    def commit(self) -> CommitInfo:
        """Apply the buffered batch: splice every live view's partition,
        refresh every tracked query incrementally, notify bound servers,
        and record mutation spans/gauges on the flight recorder."""
        n = self.g.n
        ins = self._pending_ins
        dels = self._pending_del
        self._pending_ins, self._pending_del = [], []
        isrc = (np.concatenate([x[0] for x in ins]) if ins
                else np.zeros(0, np.int32))
        idst = (np.concatenate([x[1] for x in ins]) if ins
                else np.zeros(0, np.int32))
        iw = (np.concatenate([x[2] for x in ins]) if ins
              else np.zeros(0, np.float32))
        ksrc = (np.concatenate([x[0] for x in dels]) if dels
                else np.zeros(0, np.int32))
        kdst = (np.concatenate([x[1] for x in dels]) if dels
                else np.zeros(0, np.int32))

        old_g = self.g
        old_vals = {k: st["vals"].copy() for k, st in self.tracked.items()}

        # resolve deletions against the current edge list (all copies)
        kill_key = np.unique(ksrc.astype(np.int64) * n + kdst)
        edge_key = old_g.src.astype(np.int64) * n + old_g.dst
        keep = ~np.isin(edge_key, kill_key)
        dsrc = old_g.src[~keep]
        ddst = old_g.dst[~keep]
        dw = old_g.weight[~keep]

        self.g = COOGraph(
            n, np.concatenate([old_g.src[keep], isrc]),
            np.concatenate([old_g.dst[keep], idst]),
            np.concatenate([old_g.weight[keep], iw]))
        msrc = np.unique(np.concatenate([isrc, dsrc])).astype(np.int64)
        mdst = np.unique(np.concatenate([idst, ddst])).astype(np.int64)

        self._commits += 1
        rec = obs.get_recorder()
        span = (rec.tracer.span("mutation", track="stream",
                                batch=self._commits)
                if rec is not None else None)

        # ---- splice every live view ----
        t0 = time.perf_counter()
        splices: dict[str, SpliceInfo] = {}
        old_parts = {name: v.part for name, v in self._views.items()}
        for name, v in self._views.items():
            if name == "base":
                gv, vs, vd = self.g, msrc, mdst
            elif name == "pr":
                gv, vs, vd = _pr_weights(self.g), msrc, mdst
            elif name == "sym":
                gv, sym_ins, sym_del = self._sym_apply(
                    isrc, idst, dsrc, ddst)
                ends = np.unique(np.concatenate(
                    [sym_ins[0], sym_ins[1], sym_del[0], sym_del[1]]
                )).astype(np.int64)
                vs = vd = ends
                self._sym_ins, self._sym_del = sym_ins, sym_del
            v.part, splices[name] = splice_partition(
                v.part, gv, self.pcfg, vs, vd)
            v.graph = gv

        # ---- incremental maintenance of tracked queries ----
        t1 = time.perf_counter()
        self._arrays, self.fixpoint_seconds = {}, {}
        self._upload_s = 0.0
        maint: dict[tuple, MaintStats] = {}
        min_keys = [k for k in self.tracked if k[0] in ("bfs", "sssp")]
        group = self.runner in ("lanes", "sharded") and len(min_keys) > 0
        try:
            if group:
                self._maintain_min_group(min_keys, old_vals, old_parts,
                                         isrc, idst, dsrc, ddst, dw, maint)
            else:
                for key in min_keys:
                    self._maintain_min(key, old_vals[key], old_parts,
                                       isrc, idst, dsrc, ddst, dw, maint)
            if ("cc", None) in self.tracked:
                self._maintain_cc(old_vals[("cc", None)], maint)
            if ("pagerank", None) in self.tracked:
                self._maintain_pr(old_vals[("pagerank", None)], old_g,
                                  msrc, maint)
        finally:
            self._arrays = {}          # no device table outlives the commit

        info = CommitInfo(
            inserted=int(isrc.size), deleted=int(dsrc.size),
            mutated_src=msrc, mutated_dst=mdst, splices=splices,
            maint=maint,
            replicas_added=splices["base"].replicas_added)
        t2 = time.perf_counter()
        fix_s = sum(self.fixpoint_seconds.values())

        # ---- server + flight-recorder wiring ----
        seeds = np.unique(isrc).astype(np.int64)
        roots = np.unique(np.concatenate([msrc, mdst]))
        for server, mode in self._servers:
            server.apply_mutation(
                self.view("base").part, insert_seeds=seeds,
                has_deletes=dsrc.size > 0,
                affected_roots=None if mode == "all" else roots)
        self.commit_seconds = {
            "splice": t1 - t0, "prepare": t2 - t1 - self._upload_s - fix_s,
            "upload": self._upload_s, "fixpoint": fix_s,
            "maintain": t2 - t1, "servers": time.perf_counter() - t2}
        if rec is not None:
            reg = rec.registry
            reg.counter("stream_mutations_total",
                        "edges inserted/deleted by commit()").labels(
                            kind="insert").inc(int(isrc.size))
            reg.counter("stream_mutations_total").labels(
                kind="delete").inc(int(dsrc.size))
            reg.counter("stream_replicas_added_total",
                        "adaptive rhizome splits").inc(
                            info.replicas_added)
            reg.gauge("stream_affected_vertices",
                      "mutation endpoints in the last batch").set(
                          int(roots.size))
            for name, sp in splices.items():
                reg.gauge("stream_shards_rebuilt",
                          "shard rows regenerated by the last splice"
                          ).labels(view=name).set(sp.shards_rebuilt)
            span.end(inserts=int(isrc.size), deletes=int(dsrc.size),
                     affected=int(roots.size),
                     shards_rebuilt=splices["base"].shards_rebuilt,
                     replicas_added=info.replicas_added)
        return info

    # ---------------------------------------------------- sym maintenance
    def _sym_apply(self, isrc, idst, dsrc, ddst):
        """Update the sym view's COO in append/delete order (support
        counting over directed pairs) and return its ins/del lists."""
        n = self.g.n
        gv = self._views["sym"].graph
        add_s, add_d = [], []
        for u, v in zip(isrc.tolist(), idst.tolist()):
            for a, b in ((u, v), (v, u)):
                k = a * n + b
                c = self._mult.get(k, 0)
                if c == 0:
                    add_s.append(a)
                    add_d.append(b)
                self._mult[k] = c + 1
        dead = set()
        # deletions remove ALL copies of each base pair; support drops by
        # the multiplicity of removed copies
        mult_removed: dict[tuple, int] = {}
        for u, v in zip(dsrc.tolist(), ddst.tolist()):
            mult_removed[(u, v)] = mult_removed.get((u, v), 0) + 1
        for (u, v), m in mult_removed.items():
            for a, b in ((u, v), (v, u)):
                k = a * n + b
                c = self._mult.get(k, 0) - m
                if c <= 0:
                    self._mult.pop(k, None)
                    dead.add(k)
                else:
                    self._mult[k] = c
        if dead:
            key = gv.src.astype(np.int64) * n + gv.dst
            keep = ~np.isin(key, np.fromiter(dead, np.int64))
            del_s = gv.src[~keep]
            del_d = gv.dst[~keep]
            gs, gd = gv.src[keep], gv.dst[keep]
        else:
            del_s = del_d = np.zeros(0, np.int32)
            gs, gd = gv.src, gv.dst
        new_s = np.concatenate([gs, np.asarray(add_s, np.int32)])
        new_d = np.concatenate([gd, np.asarray(add_d, np.int32)])
        gv = COOGraph(n, new_s, new_d, np.zeros(new_s.size, np.float32))
        return gv, (np.asarray(add_s, np.int32),
                    np.asarray(add_d, np.int32)), (del_s, del_d)

    # ------------------------------------------------------- min runners
    def _view_arrays(self, view: _View) -> engine.DeviceArrays:
        """The view's device arrays for this commit's fixpoints: uploaded
        from its spliced partition on first use in the commit (the time,
        synced, counts as ``upload``) and dropped when the commit ends."""
        if view.name not in self._arrays:
            t0 = time.perf_counter()
            dev = engine.resolve_device(self.device)
            if self.runner == "sharded":     # this rank's shard of the view
                self._arrays[view.name] = engine.shard_arrays(
                    view.part, engine.shard_group(
                        view.part.S, self.mesh, self.axis_names), dev)
            else:
                self._arrays[view.name] = \
                    engine.DeviceArrays.from_partition(view.part, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self._upload_s += time.perf_counter() - t0
        return self._arrays[view.name]

    def _warm(self, key, run, view: _View):
        """``run(arrays)`` on the view's arrays of this commit, its
        seconds kept as ``fixpoint_seconds[key]``."""
        arrays = self._view_arrays(view)
        t0 = time.perf_counter()
        out = run(arrays)
        self.fixpoint_seconds[key] = time.perf_counter() - t0
        return out

    def _run_min_single(self, view: _View, init, chg, unitw: int,
                        arrays=None):
        """One min query through the configured runner; returns
        ((n,) per-vertex values, (rounds, messages, work))."""
        part = view.part
        if self.runner == "stacked":
            sem = actions.BFS if unitw else actions.SSSP
            val, st = engine.run_stacked(sem, part, init, self.cfg,
                                         init_changed=chg,
                                         device=self.device, arrays=arrays)
            stats = (int(st.iterations), int(st.messages),
                     int(st.work_actions))
        else:
            val, st = self._run_lanes(
                part, np.asarray(init, np.float32)[..., None],
                np.asarray([unitw], np.int32),
                np.asarray(chg, bool)[..., None], arrays)
            val = val[..., 0]
            stats = (int(st.rounds[0]), int(st.messages[0]),
                     int(st.work_actions[0]))
        return engine.vertex_values(part, val), stats

    def _run_lanes(self, part, init, unitw, chg, arrays):
        """One laned min fixpoint through the lane runner of
        ``self.runner`` ('lanes': stacked, 'sharded': over the mesh)."""
        from repro_torch.query import lanes
        if self.runner == "sharded":
            return lanes.run_sharded_lanes(
                part, init, lane_unitw=unitw, mesh=self.mesh,
                axis_names=self.axis_names, cfg=self.cfg,
                init_changed=chg, device=self.device, arrays=arrays)
        return lanes.run_stacked_lanes(
            part, init, lane_unitw=unitw, cfg=self.cfg, init_changed=chg,
            device=self.device, arrays=arrays)

    def _min_warm_state(self, key, vals, isrc, idst, dsrc, ddst, dw):
        """init/changed per-vertex state for one min query after the
        batch: support-invalidate deletes, seed insert sources + the
        valid boundary of the invalidated region."""
        app, root = key
        unit = app == "bfs"
        pinned = self._root_flag(root)
        invalid = (invalidate_unsupported(
            self.g, vals, dsrc, ddst, dw, pinned, unit_w=unit)
            if dsrc.size else np.zeros(self.g.n, bool))
        init_vv = np.asarray(vals, np.float32).copy()
        init_vv[invalid] = np.inf
        finite = np.isfinite(init_vv)
        chg_v = np.zeros(self.g.n, bool)
        if isrc.size:
            s = np.unique(isrc)
            chg_v[s[finite[s]]] = True
        if invalid.any():
            b = finite[self.g.src] & invalid[self.g.dst]
            chg_v[np.unique(self.g.src[b])] = True
        return init_vv, chg_v, int(invalid.sum())

    def _maintain_min(self, key, vals, old_parts, isrc, idst,
                      dsrc, ddst, dw, maint):
        app, root = key
        view = self.view("base")
        init_vv, chg_v, n_inv = self._min_warm_state(
            key, vals, isrc, idst, dsrc, ddst, dw)
        init = scatter_vertex_values(view.part, init_vv)
        chg = scatter_vertex_flags(view.part, chg_v)
        new_vals, (r, m, w) = self._warm(
            key, lambda arrays: self._run_min_single(
                view, init, chg, unitw=1 if app == "bfs" else 0,
                arrays=arrays), view)
        self.tracked[key]["vals"] = new_vals
        maint[key] = MaintStats(app=app, mode="warm", rounds=r,
                                messages=m, work=w,
                                seeds=int(chg_v.sum()), invalidated=n_inv)

    def _maintain_min_group(self, keys, old_vals, old_parts, isrc, idst,
                            dsrc, ddst, dw, maint):
        """All tracked base-view min queries in ONE laned fixpoint
        (Q = len(keys)); per-lane stats feed per-key MaintStats."""
        view = self.view("base")
        part = view.part
        cols_init, cols_chg, unitw, inv_counts = [], [], [], []
        for key in keys:
            init_vv, chg_v, n_inv = self._min_warm_state(
                key, old_vals[key], isrc, idst, dsrc, ddst, dw)
            cols_init.append(scatter_vertex_values(part, init_vv))
            cols_chg.append(scatter_vertex_flags(part, chg_v))
            unitw.append(1 if key[0] == "bfs" else 0)
            inv_counts.append(n_inv)
        init = np.stack(cols_init, axis=-1)
        chg = np.stack(cols_chg, axis=-1)

        def run(arrays):
            val, st = self._run_lanes(part, init,
                                      np.asarray(unitw, np.int32), chg,
                                      arrays)
            return val.cpu().numpy(), [t.cpu().numpy() for t in (
                st.rounds, st.messages, st.work_actions)]
        val, (rounds, msgs, work) = self._warm("lanes", run, view)
        for q, key in enumerate(keys):
            self.tracked[key]["vals"] = engine.vertex_values(
                part, val[..., q])
            maint[key] = MaintStats(
                app=key[0], mode="warm", rounds=int(rounds[q]),
                messages=int(msgs[q]), work=int(work[q]),
                seeds=int(cols_chg[q].sum()), invalidated=inv_counts[q])

    def _maintain_cc(self, vals, maint):
        """CC after a batch: merged components re-flood from the sym
        inserts' endpoints (monotone); deleted sym edges invalidate the
        touched components wholesale (their min-label support is cyclic,
        so per-vertex invalidation does not apply) and each member
        reseeds with its own id."""
        view = self.view("sym")
        sym_ins, sym_del = self._sym_ins, self._sym_del
        n = self.g.n
        invalid = np.zeros(n, bool)
        if sym_del[0].size:
            affected = np.unique(np.asarray(
                vals, np.float32)[np.concatenate(
                    [sym_del[0], sym_del[1]]).astype(np.int64)])
            invalid = np.isin(np.asarray(vals, np.float32), affected)
        init_vv = np.asarray(vals, np.float32).copy()
        init_vv[invalid] = np.arange(n, dtype=np.float32)[invalid]
        chg_v = invalid.copy()
        if sym_ins[0].size:
            chg_v[np.unique(sym_ins[0]).astype(np.int64)] = True
        init = scatter_vertex_values(view.part, init_vv)
        chg = scatter_vertex_flags(view.part, chg_v)
        new_vals, (r, m, w) = self._warm(
            ("cc", None), lambda arrays: self._run_min_single(
                view, init, chg, unitw=0, arrays=arrays), view)
        self.tracked[("cc", None)]["vals"] = new_vals
        maint[("cc", None)] = MaintStats(
            app="cc", mode="warm", rounds=r, messages=m, work=w,
            seeds=int(chg_v.sum()), invalidated=int(invalid.sum()))

    # -------------------------------------------------------- pagerank
    def _run_pr(self, view, damping, tol, max_rounds, init_rank,
                init_delta, arrays=None):
        if self.runner == "sharded":
            rank, st = engine.run_pagerank_delta_sharded(
                view.part, damping=damping, tol=tol, mesh=self.mesh,
                axis_names=self.axis_names, cfg=self.cfg,
                max_rounds=max_rounds, init_rank=init_rank,
                init_delta=init_delta, device=self.device, arrays=arrays)
        else:
            rank, st = engine.run_pagerank_delta(
                view.part, damping=damping, tol=tol, cfg=self.cfg,
                max_rounds=max_rounds, init_rank=init_rank,
                init_delta=init_delta, device=self.device, arrays=arrays)
        return rank, (int(st.iterations), int(st.messages),
                      int(st.work_actions))

    def _maintain_pr(self, old_ranks, old_g, msrc, maint):
        """Delta-PR maintenance: migrate old ranks, seed the residual
        table with the exact correction ``d·(A'-A)ᵀ p`` over the
        mutated sources' old/new out-edges (weights fold in 1/out_deg,
        so every out-edge of a mutated source contributes)."""
        st = self.tracked[("pagerank", None)]
        d, tol, mr = st["damping"], st["tol"], st["max_rounds"]
        p = np.asarray(old_ranks, np.float32)
        n = self.g.n
        c = np.zeros(n, np.float32)
        msk = np.zeros(n, bool)
        msk[msrc] = True
        w_old = (1.0 / np.maximum(old_g.out_degrees(), 1)).astype(
            np.float32)
        sel = msk[old_g.src]
        np.add.at(c, old_g.dst[sel],
                  (-d * p[old_g.src[sel]] * w_old[old_g.src[sel]]
                   ).astype(np.float32))
        w_new = (1.0 / np.maximum(self.g.out_degrees(), 1)).astype(
            np.float32)
        sel = msk[self.g.src]
        np.add.at(c, self.g.dst[sel],
                  (d * p[self.g.src[sel]] * w_new[self.g.src[sel]]
                   ).astype(np.float32))
        view = self.view("pr")
        # the round rule is rank += FUTURE deltas, so the zeroth-order
        # correction folds into the rank seed (cold: rank0 = delta0 = base)
        init_rank = scatter_vertex_values(view.part, p + c, fill=0.0)
        init_delta = scatter_vertex_values(view.part, c, fill=0.0)

        def run(arrays):
            rank_t, stats = self._run_pr(view, d, tol, mr, init_rank,
                                         init_delta, arrays)
            return engine.vertex_values(view.part, rank_t), stats
        vals, (r, m, w) = self._warm(("pagerank", None), run, view)
        self.tracked[("pagerank", None)]["vals"] = vals
        maint[("pagerank", None)] = MaintStats(
            app="pagerank", mode="warm", rounds=r, messages=m, work=w,
            seeds=int((np.abs(c) > tol).sum()), invalidated=0)

    # ---------------------------------------------- checkpoint / WAL
    def snapshot(self) -> tuple[dict, dict]:
        """(array tree, JSON meta) of the full streaming state: the
        committed graph, every tracked query's values, and the
        **write-ahead log** — the buffered-but-uncommitted mutation
        batches.  A crash mid-commit restores to the pre-commit
        boundary with the batch still in the WAL; replaying it through
        the normal ``commit()`` path reproduces the interrupted commit
        EXACTLY (same splice, same warm-start maintenance, bit-identical
        min values) — commit is all-or-nothing."""
        tree = {
            "graph": {"src": np.asarray(self.g.src),
                      "dst": np.asarray(self.g.dst),
                      "weight": np.asarray(self.g.weight)},
            "tracked": {_skey(k): np.asarray(st["vals"])
                        for k, st in self.tracked.items()},
            "wal_ins": {str(i): {"src": s, "dst": d, "w": w}
                        for i, (s, d, w)
                        in enumerate(self._pending_ins)},
            "wal_del": {str(i): {"src": s, "dst": d}
                        for i, (s, d) in enumerate(self._pending_del)},
        }
        meta = {
            "n": int(self.g.n),
            "pcfg": _pcfg_to_dict(self.pcfg),
            "commits": self._commits,
            "auto_refreshes": self.auto_refreshes,
            "staleness_slo": self.staleness_slo,
            "staleness_metric": self._staleness_metric,
            "tracked": {_skey(k): {kk: vv for kk, vv in st.items()
                                   if kk != "vals"}
                        for k, st in self.tracked.items()},
            "n_wal_ins": len(self._pending_ins),
            "n_wal_del": len(self._pending_del),
        }
        return tree, meta

    def save_checkpoint(self, manager, blocking: bool = False) -> int:
        """Snapshot to a ``CheckpointManager`` at the current commit
        count (async by default).  Returns the checkpoint step."""
        tree, meta = self.snapshot()
        manager.save(self._commits, tree, blocking=blocking, meta=meta)
        return self._commits

    @classmethod
    def restore(cls, manager, *, step: int | None = None,
                cfg: engine.EngineConfig = engine.EngineConfig(),
                runner: str = "stacked", mesh=None,
                axis_names=("data", "model"),
                device=None) -> "StreamingGraph":
        """Rebuild a ``StreamingGraph`` from a checkpoint: committed
        graph and partition (deterministic ``build_partition``), tracked
        values (no cold recompute), and the WAL of uncommitted batches —
        call ``commit()`` to replay a batch interrupted mid-commit.  The
        checkpoint's format is the reference package's, so either
        package restores what the other wrote."""
        if step is None:
            step = manager.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint to restore from")
        meta = manager.restore_meta(step)
        like = {
            "graph": {"src": 0, "dst": 0, "weight": 0},
            "tracked": {k: 0 for k in meta["tracked"]},
            "wal_ins": {str(i): {"src": 0, "dst": 0, "w": 0}
                        for i in range(meta["n_wal_ins"])},
            "wal_del": {str(i): {"src": 0, "dst": 0}
                        for i in range(meta["n_wal_del"])},
        }
        tree = manager.restore(step, like)
        g = COOGraph(meta["n"],
                     np.asarray(tree["graph"]["src"], np.int32),
                     np.asarray(tree["graph"]["dst"], np.int32),
                     np.asarray(tree["graph"]["weight"], np.float32))
        pcfg = _pcfg_from_dict(meta["pcfg"])
        sg = cls(g, pcfg, cfg=cfg, runner=runner, mesh=mesh,
                 axis_names=axis_names,
                 staleness_slo=meta["staleness_slo"],
                 staleness_metric=meta["staleness_metric"], device=device)
        sg._commits = meta["commits"]
        sg.auto_refreshes = meta["auto_refreshes"]
        for skey, params in meta["tracked"].items():
            entry = dict(params)
            entry["vals"] = np.asarray(tree["tracked"][skey])
            sg.tracked[_unskey(skey)] = entry
        sg._pending_ins = [
            (np.asarray(b["src"], np.int32),
             np.asarray(b["dst"], np.int32),
             np.asarray(b["w"], np.float32))
            for b in (tree["wal_ins"][str(i)]
                      for i in range(meta["n_wal_ins"]))]
        sg._pending_del = [
            (np.asarray(b["src"], np.int32),
             np.asarray(b["dst"], np.int32))
            for b in (tree["wal_del"][str(i)]
                      for i in range(meta["n_wal_del"]))]
        return sg


def _skey(key: tuple) -> str:
    app, root = key
    return f"{app}:{'' if root is None else int(root)}"


def _unskey(s: str) -> tuple:
    app, _, root = s.partition(":")
    return (app, int(root) if root else None)


def _pcfg_to_dict(pcfg: PartitionConfig) -> dict:
    d = dataclasses.asdict(pcfg)
    for k, v in d.items():
        if isinstance(v, tuple):
            d[k] = list(v)
    return d


def _pcfg_from_dict(d: dict) -> PartitionConfig:
    fields = {f.name for f in dataclasses.fields(PartitionConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in d.items() if k in fields}
    return PartitionConfig(**kw)
