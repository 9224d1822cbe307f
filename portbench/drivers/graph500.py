"""Traffic driver ``graph500``: Graph500 v3's kernels 2 and 3 on the port.

From each search key in turn a BFS and then an SSSP (``apps``, cycled
through, from 'bfs_tree' and 'sssp_tree'), back to back over the window;
each call returns its values and a parent array.  Traffic keys as the
``calls`` driver's: ``apps``, ``root_pool`` (the search keys, drawn from
the seed among vertices with an out-edge), ``engine``, ``sample`` and
``limits``.  Reports fixpoints, Graph500's TEPS count, the engine's host
syncs, the byte bound of the searches and of their parent passes
(``tree_bytes``), and in traced runs the port's ``app.tree`` spans (a
span-only recorder installed on the port's ``obs`` around the run) and
K10's device time, summed by kernel name from the window's trace.

Compared numbers: ``bfs_mismatch`` (levels that differ from the
reference's), ``sssp_reach_mismatch`` (vertices reached by one side
only), ``sssp_max_rel_err`` (the largest relative gap to the float64
reference over vertices at a positive distance; one at distance 0 must
read 0), ``bfs_parent_invalid`` and ``sssp_parent_invalid`` (vertices
whose parent breaks Graph500's validation against the answer's own
values, ``benchlib.graph500.validate_tree`` with the SSSP limit as its
tolerance), each summed over the sampled answers.  The controls answer
the same sampled calls: ``bf16`` and ``stale`` put their values (as in
``benchlib.check``) beside the program's parents, ``parents`` the
program's values beside parents each swapped for another reached vertex.
"""
from __future__ import annotations

import collections
import time

import numpy as np

from benchlib import bounds, check, graph500, port, port_tree, reference
from benchlib import spans
from benchlib.stats import Reservoir
from benchlib.trace import Window
from benchlib.traffic import (free, log, log_partition, partition, read_peak,
                              roots, window_facts)

CONTROLS = ("bf16", "stale", "parents")
KIND = {"bfs_tree": "bfs", "sssp_tree": "sssp"}
K10 = "tree_parents"          # K10's kernels carry it in their names


def run(r, g) -> tuple[dict, dict]:
    port_tree.require_trees()
    t = r.traffic
    apps = list(t["apps"])
    for app in apps:
        if app not in KIND:
            raise ValueError(f"unknown app {app!r} for driver 'graph500'")
    pool = roots(r, g, t["root_pool"])
    obs = port_tree.obs() if r.trace else None
    rec = spans.install(obs) if r.trace else None
    try:
        facts, done, samples = _drive(r, g, apps, pool, rec)
    finally:
        spans.uninstall(obs, rec)
    return facts, _compare(r, g, facts, done, samples)


def _drive(r, g, apps, pool, rec):
    """Set-up, the window and its facts: (facts, calls made by (app,
    root), the sampled answers by app)."""
    t = r.traffic
    cfg = port.engine_config(t["engine"])
    state = {"coo": port.coo(g)}
    facts = {}
    state["part"], facts["partition_s"] = partition(r, state["coo"])
    log_partition(r, facts, state["part"])

    def call(i):
        app = apps[i % len(apps)]
        root = pool[(i // len(apps)) % len(pool)]
        return app, root, port.search(app, state["coo"], root,
                                      state["part"], cfg, r.device)

    for i in range(len(apps)):            # every app's shapes, built once
        call(i)
    log(r, "warm-up calls made")
    per_kind = max(int(t["sample"]) // len(apps), 1)
    samples = {a: Reservoir(per_kind, r.seed + k)
               for k, a in enumerate(apps)}
    done = collections.Counter()          # (app, root) -> calls
    w = Window(r.trace)
    w.warm(lambda: call(0))
    syncs0, trees0 = port.host_syncs(), port_tree.tree_counts()
    t0, ns0 = time.perf_counter(), time.time_ns()
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
        window_s, ns1 = time.perf_counter() - t0, time.time_ns()
    syncs1, trees1 = port.host_syncs(), port_tree.tree_counts()
    q = np.quantile(call_s, [0.1, 0.5, 0.9]) * 1e3
    grew = {k: trees1[k] - trees0[k] for k in trees1}
    log(r, f"window closed: {i} calls in {window_s:.3f} s; a call "
        f"{q[0]:.1f} / {q[1]:.1f} / {q[2]:.1f} ms (10th / 50th / 90th); "
        f"tree passes {grew['tree_passes_total']}, tie rounds "
        f"{grew['tree_tie_rounds_total']}")
    window_facts(facts, w, window_s)
    if syncs1 is not None:
        facts["host_syncs"] = syncs1 - (syncs0 or 0)
    if rec is not None:
        ws = spans.WindowSpans(rec.tracer, ns0, ns1, [])
        if ws.count("app.tree"):
            facts["tree_span_s"] = ws.total("app.tree")
            facts["tree_calls"] = ws.count("app.call")
    if w.prof is not None:
        facts["tree_device_s"] = _kernel_seconds(w.prof.events(), K10)
    read_peak(r, facts)
    state.clear()
    free(r)
    return facts, done, samples


def _kernel_seconds(events, name: str) -> float:
    """Device seconds of the trace's kernels whose name holds ``name``."""
    from torch.autograd import DeviceType
    return sum((e.time_range.end - e.time_range.start) * 1e-6
               for e in events
               if e.device_type == DeviceType.CUDA and name in e.name)


def _compare(r, g, facts, done, samples) -> dict:
    """The window's counts from the reference, and the sampled answers
    held to it, for the program and each control."""
    n = g.n
    csr = reference.CSR.from_coo(n, g.src, g.dst, g.weight)
    keys = {root for _, root in done}
    reach = {root: reference.bfs(csr, root) for root in keys}
    facts["fixpoints"] = sum(done.values())
    facts["teps_edges"] = sum(reach[root].edges * c
                              for (_, root), c in done.items())
    search = tree = 0.0
    for (app, root), c in done.items():
        weighted = app == "sssp_tree"
        s = reach[root]
        search += c * bounds.search_bytes(n, s.reached, s.edges, weighted)
        tree += c * graph500.tree_bytes(n, s.reached, s.edges, weighted)
    facts["tree_bytes"] = tree
    facts["bound_bytes"] = search + tree
    facts["attempted"] = facts["fixpoints"]
    facts["failed"] = 0
    log(r, "reference searches made")

    tol = float(r.traffic["limits"]["sssp_max_rel_err"])
    ssp = {}
    readings = {}
    for who in (None, *r.controls):
        got = readings.setdefault(who, {})
        for app, res in samples.items():
            kind = KIND[app]
            bad = invalid = reach_bad = 0
            gap = 0.0
            for root, (values, parents) in res.items:
                if who == "parents":
                    parents = graph500.swap_parents(values, parents, kind)
                elif who is not None:
                    values = check.control_answer(who, kind, csr, root)
                if kind == "bfs":
                    bad += check.mismatches("bfs", values, reach[root], n)
                else:
                    if root not in ssp:
                        ssp[root] = reference.sssp(csr, root)
                    rb, e = graph500.distance_errors(values,
                                                     ssp[root].values)
                    reach_bad += rb
                    gap = max(gap, e)
                invalid += graph500.validate_tree(csr, root, values,
                                                  parents, kind, tol)
            if kind == "bfs":
                got["bfs_mismatch"] = bad
            else:
                got["sssp_reach_mismatch"] = reach_bad
                got["sssp_max_rel_err"] = gap
            got[f"{kind}_parent_invalid"] = invalid
    if ssp:
        facts["sssp_rounds_max"] = max(s.rounds for s in ssp.values())
        log(r, f"reference SSSP rounds (a bound on the hop depth H) over "
            f"the sampled keys: at most {facts['sssp_rounds_max']}")
    log(r, "answers compared")
    return readings
