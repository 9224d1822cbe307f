"""Traffic driver ``serve``: queries of the ``mix`` ('bfs', 'sssp',
'reachability' shares) into one ``QueryServer`` from ``clients``
closed-loop clients, each submitting its next query when its last one
returns.

Traffic keys: ``mix``, ``clients``, ``root_pool`` (queries' roots are
uniform over that many vertices with an out-edge, drawn from the seed),
``server`` (the ``QueryServer`` arguments), ``engine`` (the port's
``EngineConfig`` fields), ``sample`` and ``limits``.  Reports every
completed query's submit-to-result latency on the host clock.
"""
from __future__ import annotations

import collections
import time

import numpy as np

from benchlib import bounds, port, reference
from benchlib.stats import Reservoir
from benchlib.trace import Window
from benchlib.traffic import (free, log, log_partition, partition,
                              read_peak, roots, search_readings,
                              window_facts)

CONTROLS = ("bf16", "stale")
DRAIN_S = 60.0        # the wait past the window for queries still in flight


def run(r, g) -> tuple[dict, dict]:
    t = r.traffic
    pool = roots(r, g, t["root_pool"])
    kinds = list(t["mix"])
    probs = np.array([float(t["mix"][k]) for k in kinds])
    probs = probs / probs.sum()
    cfg = port.engine_config(t["engine"])
    coo = port.coo(g)
    facts = {}
    part, facts["partition_s"] = partition(r, coo)
    opts = dict(t["server"])
    log_partition(r, facts, part)
    srv = port.server(part, opts, cfg, r.device)
    lanes = int(opts["n_lanes"])

    def stream(stream_id):
        rng = np.random.default_rng([int(r.seed), stream_id])
        while True:
            yield (kinds[int(rng.choice(len(kinds), p=probs))],
                   pool[int(rng.integers(len(pool)))])

    warm = stream(4)                       # every kind's shapes, built once
    for _ in range(2 * lanes):
        srv.submit(*next(warm))
    srv.run()
    srv.results.clear()
    log(r, "warm-up queries answered")

    queries = stream(2)
    meta = {}                              # qid -> (kind, root, submit time)
    per_kind = max(int(t["sample"]) // len(kinds), 1)
    samples = {k: Reservoir(per_kind, r.seed + i)
               for i, k in enumerate(kinds)}
    lat_ms, done = [], collections.Counter()
    counted = {"ok": 0, "failed": 0}

    def submit(at):
        kind, root = next(queries)
        meta[srv.submit(kind, root)] = (kind, root, at)

    def collect(now, in_window):
        for qid in list(srv.results):
            res = srv.results.pop(qid)
            kind, root, at = meta.pop(qid)
            if not in_window:
                continue
            ok = res.status == "ok"
            counted["ok" if ok else "failed"] += 1
            lat_ms.append((now - at) * 1e3 if ok else float("inf"))
            if ok:
                done[(kind, root)] += 1
                samples[kind].offer((root, res.values))

    w = Window(r.trace)
    w.warm(lambda: (srv.submit(*next(warm)), srv.run(),
                    srv.results.clear()))
    tick0 = srv.tick
    t0 = time.perf_counter()
    facts["setup_s"] = t0 - r.t_start
    with w:
        for _ in range(int(t["clients"])):
            submit(t0)
        while True:
            srv.step()
            now = time.perf_counter()
            before = len(meta)
            collect(now, True)
            if now - t0 >= r.seconds:
                break
            for _ in range(before - len(meta)):
                submit(now)
        window_s = time.perf_counter() - t0
    ticks = srv.tick - tick0
    occ = srv.occupancy_trace[tick0:tick0 + ticks]
    window_facts(facts, w, window_s)
    facts.update(queries_ok=counted["ok"], latencies_ms=lat_ms,
                 ticks=ticks, occupancy=float(np.mean(occ)) / lanes
                 if occ else None,
                 attempted=counted["ok"] + counted["failed"],
                 failed=counted["failed"])
    # every query still in flight has to come back: a minute at most
    deadline = time.perf_counter() + DRAIN_S
    while meta and time.perf_counter() < deadline:
        srv.step()
        collect(time.perf_counter(), False)
    unanswered = len(meta)
    log(r, f"window closed: {ticks} ticks, {counted['ok']} answered in "
        f"{window_s:.3f} s; drained")
    read_peak(r, facts)
    del srv, part
    free(r)

    n = g.n
    csr = reference.CSR.from_coo(n, g.src, g.dst, g.weight)
    reach = {}

    def bfs_of(root):
        if root not in reach:
            reach[root] = reference.bfs(csr, root)
        return reach[root]

    if r.trace:
        facts["bound_bytes"] = sum(c * bounds.search_bytes(
            n, bfs_of(root).reached, bfs_of(root).edges, kind == "sssp",
            lanes) for (kind, root), c in done.items())
    readings = {who: {"unanswered": unanswered}
                for who in (None, *r.controls)}
    search_readings(r, readings, samples, csr, reach)
    log(r, "answers compared")
    return facts, readings
