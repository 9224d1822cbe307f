"""Traffic driver ``calls``: back-to-back whole-graph calls, each ending in
its result on the host.

Traffic keys: ``apps`` (cycled through, from 'bfs', 'sssp',
'pagerank'), ``root_pool`` (a search app takes its roots from a pool of
that many vertices with an out-edge, drawn from the seed), ``pagerank``
({damping, iters}), ``engine`` (the port's ``EngineConfig`` fields),
``sample`` and ``limits``.  Reports fixpoints, Graph500's TEPS count
and PageRank's edges x iterations.
"""
from __future__ import annotations

import collections
import time

import numpy as np

from benchlib import bounds, check, port, reference
from benchlib.stats import Reservoir
from benchlib.trace import Window
from benchlib.traffic import (SEARCHES, free, log, log_partition, partition,
                              read_peak, roots, search_readings,
                              window_facts)

CONTROLS = ("bf16", "stale")


def run(r, g) -> tuple[dict, dict]:
    t = r.traffic
    apps = list(t["apps"])
    searches = [a for a in apps if a in SEARCHES]
    pool = roots(r, g, t["root_pool"]) if searches else [None]
    pr = t.get("pagerank", {})
    damping, iters = float(pr.get("damping", 0.85)), int(pr.get("iters", 30))
    cfg = port.engine_config(t["engine"])
    coo = port.coo(g)
    facts = {}
    state = {"coo": coo}
    if "pagerank" in apps:
        # the first call builds PageRank's partition (its 1/out-degree
        # weights are the port's): zero iterations time the partition
        t0 = time.perf_counter()
        _, state["part"] = port.pagerank(coo, damping, 0, None, cfg,
                                         r.device, r.config["partition"])
        facts["partition_s"] = time.perf_counter() - t0
    else:
        state["part"], facts["partition_s"] = partition(r, coo)
    log_partition(r, facts, state["part"])

    def call(i):
        app = apps[i % len(apps)]
        root = pool[(i // len(apps)) % len(pool)]
        if app == "pagerank":
            out, _ = port.pagerank(state["coo"], damping, iters,
                                   state["part"], cfg, r.device,
                                   r.config["partition"])
        else:
            out = port.search(app, state["coo"], root, state["part"], cfg,
                              r.device)
        return app, root, out

    for i in range(len(apps)):            # every app's shapes, built once
        call(i)
    log(r, "warm-up calls made")
    per_kind = max(int(t["sample"]) // len(apps), 1)
    samples = {a: Reservoir(per_kind, r.seed + k)
               for k, a in enumerate(apps)}
    done = collections.Counter()          # (app, root) -> calls
    w = Window(r.trace)
    w.warm(lambda: call(0))
    syncs0 = port.host_syncs()
    t0 = time.perf_counter()
    facts["setup_s"] = t0 - r.t_start
    call_s = []
    with w:
        i = 0
        while True:
            t1 = time.perf_counter()
            app, root, out = call(i)
            samples[app].offer((root, out))
            done[(app, root)] += 1
            i += 1
            t2 = time.perf_counter()
            call_s.append(t2 - t1)
            if t2 - t0 >= r.seconds:
                break
        window_s = time.perf_counter() - t0
    syncs1 = port.host_syncs()
    q = np.quantile(call_s, [0.1, 0.5, 0.9]) * 1e3
    quarters = [float(np.median(c)) * 1e3
                for c in np.array_split(np.array(call_s), 4) if len(c)]
    log(r, f"window closed: {i} calls in {window_s:.3f} s; a call "
        f"{q[0]:.1f} / {q[1]:.1f} / {q[2]:.1f} ms (10th / 50th / 90th), "
        "by quarter " + " ".join(f"{x:.1f}" for x in quarters))
    window_facts(facts, w, window_s)
    read_peak(r, facts)
    state.clear()
    free(r)

    n, E = g.n, g.num_edges
    csr = reference.CSR.from_coo(n, g.src, g.dst, g.weight)
    reach = {root: reference.bfs(csr, root)
             for (app, root) in done if app in SEARCHES}
    fix = sum(c for (app, _), c in done.items() if app in SEARCHES)
    runs = sum(c for (app, _), c in done.items() if app == "pagerank")
    nbytes = 0.0
    if fix:
        facts["fixpoints"] = fix
        facts["teps_edges"] = sum(reach[root].edges * c for (app, root), c
                                  in done.items() if app in SEARCHES)
        if syncs1 is not None:
            facts["host_syncs"] = syncs1 - (syncs0 or 0)
        nbytes += sum(c * bounds.search_bytes(
            n, reach[root].reached, reach[root].edges, app == "sssp")
            for (app, root), c in done.items() if app in SEARCHES)
    if runs:
        facts["pagerank_runs"] = runs
        facts["pagerank_edge_iters"] = runs * E * iters
        nbytes += runs * bounds.pagerank_bytes(n, E, iters)
    facts["bound_bytes"] = nbytes
    facts["attempted"] = fix + runs
    facts["failed"] = 0

    log(r, "reference searches made")
    readings = {}
    if "pagerank" in samples:
        want = reference.pagerank(n, g.src, g.dst, damping, iters)
        for who in (None, *r.controls):
            outs = [out for _, out in samples.pop("pagerank").items] \
                if who is None else [check.control_pagerank(
                    who, n, g.src, g.dst, damping, iters).cpu().numpy()]
            readings.setdefault(who, {})["pagerank_max_rel_err"] = max(
                check.max_rel_err(out, want) for out in outs)
    search_readings(r, readings, samples, csr, reach)
    log(r, "answers compared")
    return facts, readings
