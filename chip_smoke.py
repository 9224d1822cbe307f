#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` into
the ignored ``src/repro_torch/kernels/build/`` (one ``nvcc`` per source,
started together) and runs, in order:

1. device: the card's name and power limit, and the kernels' build time;
2. kernels vs plain versions: the dense kernel K1 and the worklist
   kernel K2 (from a host plan and from a device plan) against their
   plain PyTorch versions on the card, all three relax/combine pairings,
   ragged sizes, frontier densities 0 / 1% / 100%, padding edges,
   unsorted ids and negative weights for min.  Min is bit-equal; sum is
   within rtol 1e-5 / atol 1e-6 (the kernels sum in another order) and
   bit-equal between two runs; counts and executed cells equal the host
   mirror (K1) or the planner's cells (K2);
3. counter gate: BFS and SSSP (dense, worklist, device_worklist) and
   delta-PageRank (auto, device_worklist) on the RMAT scale-8 partition
   under the flight recorder hit ``benchmarks/baselines/counter_gate.json``
   exactly;
4. slice-1 path: ``apps.bfs`` and ``apps.sssp`` with K1 on an RMAT-18
   partition (edge factor 16, seed 7, 16 shards, rpvo_max 4) equal the
   numpy oracles exactly, with one K1 launch per round; then every round
   is replayed to time K1 against its bound, its plain version and a
   library scatter-reduce;
5. slice-2 path at the same width: BFS and SSSP under
   ``grid_mode='worklist'`` and ``'device_worklist'`` equal the oracles,
   with one host sync per window under ``'device_worklist'`` (and no
   sync inside a window: it is enqueued under CUDA sync-debug mode
   'error'); ``apps.pagerank`` (30 rounds, K1 mul_w/sum) and
   ``apps.pagerank_delta`` (auto and device_worklist) on the partition of
   ``_pr_graph(g)`` within rtol 1e-4 / atol 1e-7 of
   ``reference.pagerank``; then every worklist round (BFS, SSSP,
   delta-PageRank) is replayed to time the host planner, K2 alone, K2
   with its fold, the relax phase (host plan and device plan), K1 on the
   same round, the plain version and a library call, against the same
   byte bound as K1;
6. slice-3 path, query lanes, at the same width: first the lane-batched
   kernels K3 (dense) and K4 (worklist, host and device plans) against
   their plain versions (both laned pairings, mixed ``lane_unitw``,
   Q in {1, 5, 16, 33}, ragged sizes, frontier densities 0 / 1% / 100%,
   a converged lane) and the segment reduce K9 (float32 and bfloat16);
   then ``apps.batched_queries`` with Q = 16 lanes on the RMAT-18
   partition — BFS from the 8 highest-out-degree vertices, SSSP from the
   next 8 — under ``dense`` (K3), ``worklist`` and ``device_worklist``
   (K4), every lane bit-equal to its solo K1 run with equal rounds and
   messages and one K3/K4 launch per round, a laned ``device_worklist``
   window enqueued under sync-debug mode 'error'; ``apps.cc`` on the
   symmetrized zero-weight graph against scipy's weak components;
   ``apps.personalized_pagerank`` (K3 ``mul_w/sum``) and
   ``run_ppr_delta_lanes`` (``auto`` and ``device_worklist``, K4) with 8
   seeds and mixed dampings within rtol 1e-4 / atol 1e-7 of a float64
   power iteration; BFS and SSSP under ``pallas_mode='reduce'`` (K9)
   equal the numpy oracles; and the heaviest rounds replayed to time K3,
   K4 (with and without its fold) and K9 against their plain versions, a
   library call and the bound — K3 also against 16 solo K1 launches of
   the same round.

``--profile`` also traces one replayed lane round's relax phase (K3 and
K4 host-plan launches) with ``torch.profiler`` and prints its device
time by operator.

Any failure raises and the script exits non-zero.  It imports nothing of
JAX or of the JAX package.  The last lines are the ``kernels`` JSON and
``{"ok": true, "device": {...}}``; per-round timings go to
``chip_smoke_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chip_smoke_out" / "chip_smoke.json"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
RMAT_SCALE, EDGE_FACTOR, SEED, SHARDS, RPVO_MAX = 18, 16, 7, 16, 4
TIMING_REPS = 20
PROFILE = "--profile" in sys.argv[1:]
PR_ITERS = 30            # dense PageRank rounds
PR_TOL = 5e-10           # delta-PageRank residual tolerance at RMAT-18
PR_RTOL, PR_ATOL = 1e-4, 1e-7
KERNELS = ("fused_relax_reduce", "fused_relax_reduce_wl",
           "fused_relax_reduce_lanes", "fused_relax_reduce_wl_lanes",
           "segment_combine")
LANES = 16               # the lane slice's batch: 8 BFS + 8 SSSP queries
PPR_SEEDS = 8            # personalized-PageRank lanes
PPR_DAMPINGS = (0.85, 0.7, 0.6, 0.5)
PPR_DELTA_TOL = 1e-10    # delta-PPR residual tolerance at RMAT-18


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn, reps=TIMING_REPS, warmup=3):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls,
    from CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b):
    """Largest |a - b| over entries where either is finite (inf == inf
    counts as 0); raises on a finite/infinite mismatch."""
    fin = torch.isfinite(a) | torch.isfinite(b)
    check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
          "kernel and plain version disagree on which entries are finite")
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max())


# --------------------------------------------------------------------------
# phase 1: device and build
# --------------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all(KERNELS)
    build_s = time.perf_counter() - t0
    log(f"[device] {smi}")
    log(f"[device] built {', '.join(lib.name for lib in libs)} in "
        f"{build_s:.2f} s (in parallel)")
    return smi, build_s


# --------------------------------------------------------------------------
# phase 2: kernel vs its plain version on the card
# --------------------------------------------------------------------------

def _case(np, v, e, nseg, frac, seed, sorted_ids, negative):
    rng = np.random.default_rng(seed)
    gval = rng.uniform(0.0, 10.0, v).astype(np.float32)
    gchg = rng.random(v) < frac
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(-2.0 if negative else 0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    return gval, gchg, src, w, mask, ids


def _check_out(torch, out, want, kind, where):
    if kind == "min":
        check(torch.equal(out, want), f"min differs: {where}")
    else:
        check(torch.allclose(out, want, rtol=1e-5, atol=1e-6),
              f"sum outside rtol 1e-5 / atol 1e-6: {where}")
    return max_abs_err(torch, out, want)


def phase_kernel_vs_plain(torch, np, dev):
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels.ref import (
        fused_relax_reduce_ref, fused_relax_reduce_wl_ref)
    shapes = [(17, 7, 3), (1000, 5 * frr.EBLK + 13, 2 * frr.SBLK + 5),
              (30011, 97 * frr.EBLK + 311, 20011)]
    errs = {"K1": 0.0, "K2": 0.0}
    n = 0
    for relax, kind in (("add_w", "min"), ("add_one", "min"),
                        ("mul_w", "sum")):
        for v, e, nseg in shapes:
            for frac in (0.0, 0.01, 1.0):
                for sorted_ids in (True, False):
                    case = _case(np, v, e, nseg, frac, seed=v + e + n,
                                 sorted_ids=sorted_ids,
                                 negative=kind == "min")
                    args = [torch.as_tensor(x, device=dev) for x in case]
                    gval, gchg, src, w, mask, ids = case
                    want = fused_relax_reduce_ref(*args, nseg, relax, kind)
                    where = f"{relax}/{kind} v={v} e={e} nseg={nseg} " \
                            f"frac={frac} sorted={sorted_ids}"
                    # K1, then K2 from a host plan and from a device plan
                    for grid_mode in ("dense", "worklist",
                                      "device_worklist"):
                        name = "K1" if grid_mode == "dense" else "K2"
                        at = f"{name} {grid_mode} {where}"
                        out, count, dbg = frr.fused_relax_reduce(
                            *args, nseg, relax, kind, with_count=True,
                            with_debug=True, grid_mode=grid_mode)
                        torch.cuda.synchronize()
                        errs[name] = max(errs[name], _check_out(
                            torch, out, want, kind, at))
                        if kind == "sum":
                            again = frr.fused_relax_reduce(
                                *args, nseg, relax, kind,
                                grid_mode=grid_mode)
                            check(torch.equal(out, again),
                                  f"sum differs between runs: {at}")
                        check(int(count) == int((mask & gchg[src]).sum()),
                              f"count differs: {at}")
                        if grid_mode == "dense":
                            cells = frr.fused_grid_cells(
                                ids, mask, src, gchg, nseg)["fused_live"]
                        else:
                            wl, info = frr.plan_worklist(
                                ids, mask, src, gchg, nseg,
                                dst_filter=grid_mode == "worklist")
                            cells = info.cells
                            plain = fused_relax_reduce_wl_ref(
                                *args, wl.wl_i.to(dev), wl.wl_j.to(dev),
                                wl.nlive.to(dev), nseg, relax, kind)
                            errs[name] = max(errs[name], _check_out(
                                torch, out, plain, kind, at + " (wl plain)"))
                        check(int(dbg[0]) == cells,
                              f"executed cells {int(dbg[0])} != {cells}: "
                              f"{at}")
                    n += 1
    log(f"[kernel] {n} cases x (K1, K2 host plan, K2 device plan): min "
        f"bit-equal, sum max_abs_err K1 {errs['K1']:.3g} K2 "
        f"{errs['K2']:.3g} (rtol 1e-5) and bit-repeatable, counts and "
        "executed cells equal the host mirror / the planner")
    return errs


# --------------------------------------------------------------------------
# phase 3: counter gate at RMAT scale 8
# --------------------------------------------------------------------------

def _gate_totals(rounds, run):
    rs = [r for r in rounds if r.run == run]
    return {"rounds": len(rs), "frontier_first": rs[0].frontier,
            "messages": sum(r.messages for r in rs),
            "pruned": sum(r.pruned for r in rs),
            "cells": sum(r.cells for r in rs),
            "launched": sum(r.launched for r in rs),
            "shard_messages": [sum(c) for c in zip(
                *(r.shard_messages for r in rs))]}


def phase_counter_gate(np, dev):
    from repro_torch import obs
    from repro_torch.apps.pagerank import _pr_graph
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators
    gate = json.loads(
        (ROOT / "benchmarks" / "baselines" / "counter_gate.json").read_text())
    gg = gate["graph"]
    g = generators.rmat(gg["scale"], edge_factor=gg["edge_factor"],
                        seed=gg["seed"])
    root = int(np.argmax(g.out_degrees()))
    pcfg = PartitionConfig(num_shards=4, rpvo_max=4)
    part = build_partition(g.with_random_weights(seed=gg["seed"]), pcfg)
    part_pr = build_partition(_pr_graph(g), pcfg)
    fields = ("rounds", "messages", "pruned", "shard_messages",
              "frontier_first", "cells")
    legs = [(f"{sem.name}_{grid}", sem.name, grid,
             lambda cfg, sem=sem: engine.run_stacked(
                 sem, part, engine.init_values(part, sem, {root: 0.0}), cfg,
                 device=dev))
            for sem in (actions.BFS, actions.SSSP)
            for grid in ("dense", "worklist", "device_worklist")]
    legs += [(leg, "pagerank_delta", grid,
              lambda cfg: engine.run_pagerank_delta(
                  part_pr, tol=3e-5, max_rounds=8, cfg=cfg, device=dev))
             for leg, grid in (("pagerank_delta", "auto"),
                               ("pagerank_delta_device", "device_worklist"))]
    for leg, run, grid, call in legs:
        with obs.recording() as rec:
            call(engine.EngineConfig(use_pallas=True, grid_mode=grid))
        got = _gate_totals(rec.rounds, run)
        want = gate["runs"][leg]
        # 'launched' is the port's own launch shape on dense and device
        # legs; host worklists pad as the reference does
        for f in fields + (("launched",) if grid == "worklist" else ()):
            check(got[f] == want[f],
                  f"counter gate {leg}.{f}: {got[f]} != {want[f]}")
        log(f"[gate] {leg}: rounds {got['rounds']}, messages "
            f"{got['messages']}, pruned {got['pruned']}, cells "
            f"{got['cells']} — equal to counter_gate.json")


# --------------------------------------------------------------------------
# phase 4: the slice-1 path at RMAT-18
# --------------------------------------------------------------------------

def _round_bound_ms(part, relax_kind, n_active):
    """Least time for one round's fused relax+reduce: every valid edge's
    source id and mask must be read to find the active edges, each active
    edge's destination id (and weight, unless the relax ignores it), the
    value table and frontier once, and the inbox written once; the
    arithmetic (a relax and a combine per active edge) is far below the
    float32 rate.  Returns (ms, "bytes" | "operations")."""
    e = part.S * part.E_max
    v = part.S * part.R_max
    per_active = 4 + (0 if relax_kind == "add_one" else 4)
    nbytes = e * (4 + 1) + n_active * per_active + v * (4 + 1) + v * 4 + 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * n_active / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def rmat18(np):
    """The RMAT-18 graph (weighted), its partition, the BFS root and the
    numpy oracles both slices' paths are held to."""
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators, reference
    t0 = time.perf_counter()
    g = generators.rmat(RMAT_SCALE, edge_factor=EDGE_FACTOR,
                        seed=SEED).with_random_weights(seed=SEED)
    part = build_partition(g, PartitionConfig(num_shards=SHARDS,
                                              rpvo_max=RPVO_MAX))
    root = int(np.argmax(g.out_degrees()))
    log(f"[main] RMAT-{RMAT_SCALE}: n={g.n} edges={g.num_edges} S={part.S} "
        f"E_max={part.E_max} R_max={part.R_max} root={root} "
        f"(generate + partition {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    want = {"bfs": reference.bfs_levels(g, root),
            "sssp": reference.sssp_dijkstra(g, root)}
    log(f"[main] numpy oracles {time.perf_counter() - t0:.1f} s")
    return g, part, root, want


def phase_main_path(torch, np, dev, g, part, root, want):
    from repro_torch import apps, exchange
    from repro_torch.core import actions, engine
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fused_relax_reduce_ref

    want_levels, want_dist = want["bfs"], want["sssp"]
    cfg = engine.EngineConfig(use_pallas=True)
    report = {"rounds": {}, "fixpoint_s": {}, "per_round": []}
    launches = 0
    for name, app, want in (("bfs", apps.bfs, want_levels),
                            ("sssp", apps.sssp, want_dist)):
        frr.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, stats, _ = app(g, root, part=part, cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = frr.launches
        rounds = int(stats.iterations)
        check(np.array_equal(got, want),
              f"{name} differs from the numpy oracle at "
              f"{int((got != want).sum())} vertices")
        check(n_launch == rounds,
              f"{name}: {n_launch} kernel launches for {rounds} rounds")
        launches += n_launch
        report["rounds"][name] = rounds
        report["fixpoint_s"][name] = wall
        log(f"[main] {name}: equal to the oracle; {rounds} rounds, "
            f"{n_launch} kernel launches, {int(stats.messages)} messages, "
            f"fixpoint wall {wall:.3f} s (setup included)")

    # replay every round of both fixpoints to time the relax phase
    arrays = engine.DeviceArrays.from_partition(part, dev)
    plan = arrays.fused_plan
    S, R_max, nseg = part.S, part.R_max, part.S * part.R_max
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    ids = arrays.edge_dst_flat.reshape(-1)
    ids_long = ids.long()
    err = 0.0

    def seed(sem):
        val = torch.as_tensor(engine.init_values(part, sem, {root: 0.0}),
                              device=dev)
        chg = sem.improved(val, torch.full_like(val, sem.identity)) \
            & arrays.slot_valid
        return val, chg

    for sem in (actions.BFS, actions.SSSP):
        val, chg = seed(sem)
        rnd = 0
        torch.cuda.synchronize()
        t_rounds = time.perf_counter()
        while bool(chg.any()):
            val, chg, _ = exchange.fixpoint_round_stacked(
                sem, arrays, cfg, S, R_max, val, chg)
            rnd += 1
        torch.cuda.synchronize()
        rounds_s = time.perf_counter() - t_rounds
        check(rnd == report["rounds"][sem.name], "replay round count")
        report["fixpoint_s"][f"{sem.name}_rounds_only"] = rounds_s

        val, chg = seed(sem)
        rnd = 0
        while bool(chg.any()):
            rnd += 1
            gval, gchg = val.reshape(-1), chg.reshape(-1)
            kind, rk = sem.segment, sem.relax_kind
            gval_m = frr._masked_value_tables(gval, gchg, sem.identity)
            chunk_act, count = frr._chunk_tables(src, mask, gchg)
            out, dbg = frr._launch(gval_m, src, w, mask, ids, plan,
                                   chunk_act, rk, kind, True)
            plain = fused_relax_reduce_ref(gval, gchg, src, w, mask, ids,
                                           nseg, rk, kind)
            torch.cuda.synchronize()
            check(torch.equal(out, plain), f"{sem.name} round {rnd}: kernel "
                  "differs from its plain version")
            err = max(err, max_abs_err(torch, out, plain))
            gchg_h = gchg.cpu().numpy()
            mirror = frr.fused_grid_cells(part.edge_dst_flat, part.edge_mask,
                                          part.edge_src_root_flat, gchg_h,
                                          nseg)
            check(int(dbg[0]) == mirror["fused_live"],
                  f"{sem.name} round {rnd}: executed cells")
            active = mask & gchg[src.long()]
            msg = torch.where(active, sem.relax(gval[src.long()], w),
                              torch.tensor(sem.identity, device=dev))
            n_active = int(count)
            bound, bound_by = _round_bound_ms(part, rk, n_active)
            row = {
                "app": sem.name, "round": rnd,
                "frontier": int(gchg_h.sum()), "active_edges": n_active,
                "cells": mirror["fused_live"],
                "launch_cells": mirror["launch_cells"],
                "ms": time_ms(torch, lambda: ops.fused_relax_reduce(
                    gval, gchg, src, w, mask, ids, nseg, rk, kind,
                    plan=plan)),
                "kernel_ms": time_ms(torch, lambda: frr._launch(
                    gval_m, src, w, mask, ids, plan, chunk_act, rk, kind,
                    False)),
                "plain_ms": time_ms(torch, lambda: fused_relax_reduce_ref(
                    gval, gchg, src, w, mask, ids, nseg, rk, kind), reps=5),
                "library_ms": time_ms(
                    torch, lambda: torch.full(
                        (nseg,), math.inf, device=dev).scatter_reduce_(
                            0, ids_long, msg, "amin", include_self=True),
                    reps=5),
                "bound_ms": bound, "bound_by": bound_by,
            }
            report["per_round"].append(row)
            val, chg, _ = exchange.fixpoint_round_stacked(
                sem, arrays, cfg, S, R_max, val, chg)
    rows = report["per_round"]
    med = {k: statistics.median(r[k] for r in rows)
           for k in ("ms", "kernel_ms", "plain_ms", "library_ms",
                     "bound_ms")}
    heavy = max(rows, key=lambda r: r["active_edges"])
    report["median"] = med
    report["heaviest"] = heavy
    log(f"[main] per round, median of {len(rows)} rounds: fused relax "
        f"{med['ms']:.4f} ms (kernel alone {med['kernel_ms']:.4f} ms), "
        f"bound {med['bound_ms']:.4f} ms, plain {med['plain_ms']:.4f} ms, "
        f"scatter_reduce amin {med['library_ms']:.4f} ms")
    log(f"[main] heaviest round ({heavy['app']} round {heavy['round']}, "
        f"{heavy['active_edges']} active edges, {heavy['cells']} cells): "
        f"fused relax {heavy['ms']:.4f} ms (kernel alone "
        f"{heavy['kernel_ms']:.4f} ms), bound {heavy['bound_ms']:.4f} ms, "
        f"plain {heavy['plain_ms']:.4f} ms, scatter_reduce amin "
        f"{heavy['library_ms']:.4f} ms")
    return launches, err, report


# --------------------------------------------------------------------------
# phase 5: the slice-2 path at RMAT-18 — worklist launches and PageRank
# --------------------------------------------------------------------------

def _library_ms(torch, kind, ids_long, msg, nseg):
    """One PyTorch call computing the round's inbox from messages that
    are already relaxed and masked: ``scatter_reduce_`` amin for min,
    ``index_add_`` for sum."""
    if kind == "min":
        return time_ms(torch, lambda: torch.full(
            (nseg,), math.inf, device=msg.device).scatter_reduce_(
                0, ids_long, msg, "amin", include_self=True), reps=5)
    return time_ms(torch, lambda: torch.zeros(
        nseg, device=msg.device).index_add_(0, ids_long, msg), reps=5)


def _replay_rounds(torch, np, dev, app, sem, part, arrays, planner, state,
                   tables, step, worklists=True):
    """Replay one fixpoint round by round: ``tables(state)`` gives the
    round's (gval, gchg), ``step(state, wl)`` the next state.  With
    ``worklists`` each round is planned on the host, K2 is checked
    against its plain version and the planner, and the worklist launch is
    timed piece by piece beside K1 on the same round; without, the round
    times K1's relax phase (dense PageRank).  Returns (rows, K2 err)."""
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (
        fused_relax_reduce_ref, fused_relax_reduce_wl_ref)
    nseg = part.S * part.R_max
    plan = arrays.fused_plan
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    ids = arrays.edge_dst_flat.reshape(-1)
    ids_long, src_long = ids.long(), src.long()
    kind, rk = sem.segment, sem.relax_kind
    rows, err, rnd = [], 0.0, 0
    while True:
        gval, gchg = tables(state)
        gchg_h = gchg.cpu().numpy()
        if not gchg_h.any():
            break
        rnd += 1
        gval_m = frr._masked_value_tables(gval, gchg, sem.identity)
        chunk_act, count = frr._chunk_tables(src, mask, gchg)
        active = mask & gchg[src_long]
        msg = torch.where(active, sem.relax(gval[src_long], w), sem.identity)
        n_active = int(count)
        bound, bound_by = _round_bound_ms(part, rk, n_active)
        row = {"app": app, "round": rnd, "frontier": int(gchg_h.sum()),
               "active_edges": n_active, "bound_ms": bound,
               "bound_by": bound_by,
               "k1_ms": time_ms(torch, lambda: frr._launch(
                   gval_m, src, w, mask, ids, plan, chunk_act, rk, kind,
                   False)),
               "library_ms": _library_ms(torch, kind, ids_long, msg, nseg)}
        wl = None
        if not worklists:
            row.update(
                kernel_ms=row["k1_ms"],
                ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                    gval, gchg, src, w, mask, ids, nseg, rk, kind,
                    plan=plan)),
                plain_ms=time_ms(torch, lambda: fused_relax_reduce_ref(
                    gval, gchg, src, w, mask, ids, nseg, rk, kind), reps=3))
        else:
            t0 = time.perf_counter()
            wl, info = planner.plan(gchg_h)
            row["plan_ms"] = 1e3 * (time.perf_counter() - t0)
            wl_dev = wl.to(dev)
            grid = frr._wl_grid(wl, dev)
            out, dbg = frr._launch_wl(gval_m, src, w, mask, ids, wl, nseg,
                                      rk, kind, True)

            def plain():
                return fused_relax_reduce_wl_ref(
                    gval, gchg, src, w, mask, ids, wl_dev.wl_i, wl_dev.wl_j,
                    wl_dev.nlive, nseg, rk, kind)

            want = plain()
            torch.cuda.synchronize()
            err = max(err, _check_out(torch, out, want, kind,
                                      f"{app} round {rnd} K2"))
            check(int(dbg[0]) == info.cells,
                  f"{app} round {rnd}: K2 executed {int(dbg[0])} cells, "
                  f"planned {info.cells}")
            row.update(
                cells=info.cells, dense_cells=info.dense_live,
                launched=info.launched,
                cells_ms=time_ms(torch, lambda: frr._wl_cells(
                    gval_m, src, w, mask, ids, wl_dev, grid, rk, kind,
                    False)),
                kernel_ms=time_ms(torch, lambda: frr._wl_fold(
                    frr._wl_cells(gval_m, src, w, mask, ids, wl_dev, grid,
                                  rk, kind, False)[0], wl_dev, nseg, kind)),
                ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                    gval, gchg, src, w, mask, ids, nseg, rk, kind,
                    plan=plan, worklist=wl)),
                device_ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                    gval, gchg, src, w, mask, ids, nseg, rk, kind,
                    plan=plan, grid_mode="device_worklist")),
                plain_ms=time_ms(torch, plain, reps=3))
        rows.append(row)
        state = step(state, wl)
    return rows, err


def phase_slice2(torch, np, dev, g, part, root, want):
    from repro_torch import apps, exchange, obs
    from repro_torch.apps.pagerank import _pr_graph
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import reference
    from repro_torch.kernels import fused_relax_reduce as frr

    reg = obs.registry()
    report = {"runs": {}, "per_round": []}
    launches = {"K1": 0, "K2": 0}

    def drive(key, run, call):
        """Drive one run of the path with the launch counts set to 0 just
        before it and read just after; returns its result and a row."""
        d = reg.counter("engine_dispatches_total").labels(run=run)
        h = reg.counter("engine_host_syncs_total").labels(run=run)
        d0, h0 = d.value, h.value
        frr.launches = frr.wl_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        row = {"wall_s": time.perf_counter() - t0, "k1": frr.launches,
               "k2": frr.wl_launches, "dispatches": d.value - d0,
               "host_syncs": h.value - h0}
        launches["K1"] += row["k1"]
        launches["K2"] += row["k2"]
        report["runs"][key] = row
        return res, row

    # BFS and SSSP with worklist launches
    for grid in ("worklist", "device_worklist"):
        cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid)
        for name, app in (("bfs", apps.bfs), ("sssp", apps.sssp)):
            (got, stats, _), row = drive(
                f"{name}_{grid}", name,
                lambda: app(g, root, part=part, cfg=cfg))
            rounds = int(stats.iterations)
            row.update(rounds=rounds, messages=int(stats.messages))
            check(np.array_equal(got, want[name]),
                  f"{name} {grid} differs from the numpy oracle at "
                  f"{int((got != want[name]).sum())} vertices")
            check(row["k2"] > 0, f"{name} {grid}: K2 was never launched")
            windows = -(-rounds // cfg.device_window)
            syncs = windows if grid == "device_worklist" else rounds + 1
            check(row["host_syncs"] == syncs and row["dispatches"]
                  == (windows if grid == "device_worklist" else rounds),
                  f"{name} {grid}: {row['dispatches']} dispatches, "
                  f"{row['host_syncs']} host syncs for {rounds} rounds")
            log(f"[slice2] {name} {grid}: equal to the oracle; {rounds} "
                f"rounds, K2 launches {row['k2']}, K1 launches "
                f"{row['k1']}, {row['host_syncs']} host syncs "
                f"({row['host_syncs'] / rounds:.3f} a round), fixpoint "
                f"wall {row['wall_s']:.3f} s (setup included)")

    # a device_worklist window enqueues without any host sync
    arrays = engine.DeviceArrays.from_partition(part, dev)
    cfg_dev = engine.EngineConfig(use_pallas=True,
                                  grid_mode="device_worklist")
    val = torch.as_tensor(engine.init_values(part, actions.SSSP,
                                             {root: 0.0}), device=dev)
    chg = (val == 0) & arrays.slot_valid
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exchange.fixpoint_window_stacked(
            actions.SSSP, arrays, cfg_dev, part.S, part.R_max,
            cfg_dev.device_window, val, chg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[slice2] a {cfg_dev.device_window}-round SSSP window enqueued "
        "under sync-debug mode 'error': no host sync inside the window")

    # PageRank on the partition of _pr_graph(g)
    t0 = time.perf_counter()
    g_pr = _pr_graph(g)
    part_pr = build_partition(g_pr, PartitionConfig(num_shards=SHARDS,
                                                    rpvo_max=RPVO_MAX))
    conv_iters = math.ceil(math.log(1e-6) / math.log(0.85))
    if 0.85 ** conv_iters >= 1e-6:
        conv_iters += 1
    want_pr = reference.pagerank(g, 0.85, PR_ITERS)
    want_conv = reference.pagerank(g, 0.85, conv_iters)
    log(f"[slice2] PageRank partition + numpy oracles "
        f"({PR_ITERS} and {conv_iters} iterations) "
        f"{time.perf_counter() - t0:.1f} s")
    (got, _), row = drive("pagerank", "pagerank", lambda: apps.pagerank(
        g, iters=PR_ITERS, part=part_pr,
        cfg=engine.EngineConfig(use_pallas=True)))
    check(np.allclose(got, want_pr, rtol=PR_RTOL, atol=PR_ATOL),
          f"pagerank off the oracle by {float(np.abs(got - want_pr).max())}")
    check(row["k1"] == PR_ITERS, f"pagerank: {row['k1']} K1 launches")
    row["max_abs_diff"] = float(np.abs(got - want_pr).max())
    log(f"[slice2] pagerank: {PR_ITERS} rounds within rtol {PR_RTOL} / atol "
        f"{PR_ATOL} of the oracle (max |diff| {row['max_abs_diff']:.3g}), "
        f"{row['k1']} K1 launches, wall {row['wall_s']:.3f} s")
    for grid in ("auto", "device_worklist"):
        cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid)
        (got, stats, _), row = drive(
            f"pagerank_delta_{grid}", "pagerank_delta",
            lambda: apps.pagerank_delta(g, tol=PR_TOL, part=part_pr,
                                        cfg=cfg))
        rounds = int(stats.iterations)
        row.update(rounds=rounds, messages=int(stats.messages),
                   max_abs_diff=float(np.abs(got - want_conv).max()))
        check(np.allclose(got, want_conv, rtol=PR_RTOL, atol=PR_ATOL),
              f"pagerank_delta {grid} off the oracle by "
              f"{row['max_abs_diff']}")
        if grid == "device_worklist":
            check(row["k2"] >= rounds,
                  f"pagerank_delta device: {row['k2']} K2 launches")
            check(row["host_syncs"] == -(-rounds // cfg.device_window),
                  f"pagerank_delta device: {row['host_syncs']} host syncs")
        log(f"[slice2] pagerank_delta {grid}: tol {PR_TOL}, {rounds} rounds "
            f"within rtol {PR_RTOL} / atol {PR_ATOL} of the "
            f"{conv_iters}-iteration oracle (max |diff| "
            f"{row['max_abs_diff']:.3g}), K1 {row['k1']} / K2 {row['k2']} "
            f"launches, {row['host_syncs']} host syncs, wall "
            f"{row['wall_s']:.3f} s")

    # replay: worklist rounds of BFS, SSSP and delta-PageRank, and one
    # dense PageRank round (every round has the same active edges)
    wl_cfg = engine.EngineConfig(use_pallas=True, grid_mode="worklist")
    planner = engine.launch_planner(part, wl_cfg)
    err = 0.0
    for sem in (actions.BFS, actions.SSSP):
        v0 = torch.as_tensor(engine.init_values(part, sem, {root: 0.0}),
                             device=dev)
        c0 = sem.improved(v0, torch.full_like(v0, sem.identity)) \
            & arrays.slot_valid
        rows, e = _replay_rounds(
            torch, np, dev, sem.name, sem, part, arrays, planner, (v0, c0),
            lambda st: (st[0].reshape(-1), st[1].reshape(-1)),
            lambda st, wl, sem=sem: exchange.fixpoint_round_stacked(
                sem, arrays, wl_cfg, part.S, part.R_max, *st,
                worklist=wl)[:2])
        check(len(rows) == report["runs"][f"{sem.name}_worklist"]["rounds"],
              f"{sem.name} replay round count")
        report["per_round"] += rows
        err = max(err, e)
    arrays_pr = engine.DeviceArrays.from_partition(part_pr, dev)
    planner_pr = engine.launch_planner(part_pr, wl_cfg)
    pr = actions.PAGERANK
    tol_t = engine._tol_table(part_pr, PR_TOL, dev)
    base = (1.0 - 0.85) / part_pr.n
    d0 = torch.where(arrays_pr.slot_valid, base, 0.0)

    def pr_tables(st):
        return (st[1].reshape(-1),
                ((st[1].abs() > tol_t) & arrays_pr.slot_valid).reshape(-1))

    rows, e = _replay_rounds(
        torch, np, dev, "pagerank_delta", pr, part_pr, arrays_pr, planner_pr,
        (d0, d0), pr_tables,
        lambda st, wl: exchange.delta_pagerank_round_stacked(
            pr, arrays_pr, wl_cfg, part_pr.S, part_pr.R_max, 0.85, tol_t,
            *st, worklist=wl)[:2])
    report["per_round"] += rows
    err = max(err, e)
    val = torch.where(arrays_pr.slot_valid, 1.0 / part_pr.n, 0.0)
    rows, _ = _replay_rounds(
        torch, np, dev, "pagerank", pr, part_pr, arrays_pr, None,
        (val, arrays_pr.slot_valid),
        lambda st: (st[0].reshape(-1), st[1].reshape(-1)),
        lambda st, wl: (st[0], torch.zeros_like(st[1])), worklists=False)
    report["pagerank_round"] = rows[0]
    wl_rows = [r for r in report["per_round"] if "cells" in r]
    keys = ("plan_ms", "cells_ms", "kernel_ms", "ms", "device_ms", "k1_ms",
            "plain_ms", "library_ms", "bound_ms")
    report["median"] = {k: statistics.median(r[k] for r in wl_rows)
                        for k in keys}
    report["heaviest"] = max(wl_rows, key=lambda r: r["active_edges"])
    med, heavy = report["median"], report["heaviest"]
    log(f"[slice2] per worklist round, median of {len(wl_rows)} rounds: "
        f"planner {med['plan_ms']:.2f} ms (host), K2 {med['cells_ms']:.4f} "
        f"ms, K2+fold {med['kernel_ms']:.4f} ms, relax phase "
        f"{med['ms']:.4f} ms (device plan {med['device_ms']:.4f} ms), K1 "
        f"{med['k1_ms']:.4f} ms, plain {med['plain_ms']:.4f} ms, library "
        f"{med['library_ms']:.4f} ms, bound {med['bound_ms']:.4f} ms")
    log(f"[slice2] heaviest worklist round ({heavy['app']} round "
        f"{heavy['round']}, {heavy['active_edges']} active edges, "
        f"{heavy['cells']} cells): planner {heavy['plan_ms']:.2f} ms, K2 "
        f"{heavy['cells_ms']:.4f} ms, K2+fold {heavy['kernel_ms']:.4f} ms, "
        f"relax phase {heavy['ms']:.4f} ms (device plan "
        f"{heavy['device_ms']:.4f} ms), K1 {heavy['k1_ms']:.4f} ms, plain "
        f"{heavy['plain_ms']:.4f} ms, library {heavy['library_ms']:.4f} ms,"
        f" bound {heavy['bound_ms']:.4f} ms")
    prr = report["pagerank_round"]
    log(f"[slice2] dense PageRank round (K1 mul_w/sum, "
        f"{prr['active_edges']} active edges): relax phase {prr['ms']:.4f} "
        f"ms, K1 {prr['k1_ms']:.4f} ms, plain {prr['plain_ms']:.4f} ms, "
        f"index_add_ {prr['library_ms']:.4f} ms, bound "
        f"{prr['bound_ms']:.4f} ms")
    return launches, err, report, part_pr


# --------------------------------------------------------------------------
# phase 6: the slice-3 path at RMAT-18 — query lanes and the segment reduce
# --------------------------------------------------------------------------

def _lane_case(np, v, e, nseg, q, frac, seed):
    rng = np.random.default_rng(seed)
    gval = rng.uniform(0.0, 10.0, (v, q)).astype(np.float32)
    gchg = rng.random((v, q)) < frac
    if q > 1:
        gchg[:, q // 2] = False             # a converged lane
    unitw = (rng.random(q) < 0.5).astype(np.int32)
    src = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    mask = rng.random(e) < 0.9
    ids = rng.integers(0, nseg, e).astype(np.int32)
    if seed % 2:
        ids = np.sort(ids)
    return gval, gchg, unitw, src, w, mask, ids


def phase_lane_kernels_vs_plain(torch, np, dev):
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    from repro_torch.kernels.ref import (
        fused_relax_reduce_lanes_ref, fused_relax_reduce_wl_lanes_ref,
        segment_combine_ref)
    shapes = [(17, 7, 3), (1000, 5 * frr.EBLK + 13, 2 * frr.SBLK + 5),
              (30011, 97 * frr.EBLK + 311, 20011)]
    errs = {"K3": 0.0, "K4": 0.0, "K9": 0.0}
    n = 0
    for relax, kind in (("add_w", "min"), ("mul_w", "sum")):
        for q in (1, 5, 16, 33):
            for v, e, nseg in shapes:
                for frac in (0.0, 0.01, 1.0):
                    case = _lane_case(np, v, e, nseg, q, frac,
                                      seed=v + e + q + n)
                    args = [torch.as_tensor(x, device=dev) for x in case]
                    gval, gchg, unitw, src, w, mask, ids = case
                    want = fused_relax_reduce_lanes_ref(*args, nseg, relax,
                                                        kind)
                    want_count = (mask[:, None] & gchg[src]).sum(axis=0)
                    where = f"{relax}/{kind} q={q} v={v} e={e} " \
                            f"nseg={nseg} frac={frac}"
                    for grid_mode in ("dense", "worklist",
                                      "device_worklist"):
                        name = "K3" if grid_mode == "dense" else "K4"
                        at = f"{name} {grid_mode} {where}"
                        out, count, dbg = frr.fused_relax_reduce_lanes(
                            *args, nseg, relax, kind, with_count=True,
                            with_debug=True, grid_mode=grid_mode)
                        torch.cuda.synchronize()
                        errs[name] = max(errs[name], _check_out(
                            torch, out, want, kind, at))
                        if kind == "sum":
                            again = frr.fused_relax_reduce_lanes(
                                *args, nseg, relax, kind,
                                grid_mode=grid_mode)
                            check(torch.equal(out, again),
                                  f"sum differs between runs: {at}")
                        check(np.array_equal(count.cpu().numpy(),
                                             want_count),
                              f"per-lane counts differ: {at}")
                        if grid_mode == "dense":
                            cells = frr.fused_grid_cells(
                                ids, mask, src, gchg, nseg)["fused_live"]
                        else:
                            wl, info = frr.plan_worklist(
                                ids, mask, src, gchg, nseg,
                                dst_filter=grid_mode == "worklist")
                            cells = info.cells
                            plain = fused_relax_reduce_wl_lanes_ref(
                                *args, wl.wl_i.to(dev), wl.wl_j.to(dev),
                                wl.nlive.to(dev), nseg, relax, kind)
                            errs[name] = max(errs[name], _check_out(
                                torch, out, plain, kind, at + " (wl plain)"))
                        check(int(dbg[0]) == cells,
                              f"executed cells {int(dbg[0])} != {cells}: "
                              f"{at}")
                    n += 1
    rng = np.random.default_rng(0)
    m = 0
    for kind in ("min", "sum"):
        for e, nseg in ((1, 1), (2 * frr.EBLK + 13, 2 * frr.SBLK + 5),
                        (200_000, 30_011)):
            for sorted_ids in (True, False):
                # sums take non-negative messages, as the engine's sum path
                # does: signed terms cancel to near 0, where atol 1e-6 is
                # below the rounding of terms of size 10
                lo = -10.0 if kind == "min" else 0.0
                data = rng.uniform(lo, 10, e).astype(np.float32)
                ids = rng.integers(0, nseg, e).astype(np.int32)
                if sorted_ids:
                    ids = np.sort(ids)
                i = torch.as_tensor(ids, device=dev)
                cells = rsr.plan_segments(i, nseg).num_cells
                for dtype in (torch.float32, torch.bfloat16):
                    d = torch.as_tensor(data, device=dev).to(dtype)
                    at = f"K9 {kind} {dtype} e={e} nseg={nseg} " \
                         f"sorted={sorted_ids}"
                    out, dbg = rsr.segment_combine(d, i, nseg, kind,
                                                   with_debug=True)
                    want = segment_combine_ref(d.float(), i, nseg,
                                               kind).to(dtype)
                    torch.cuda.synchronize()
                    check(out.dtype == dtype, f"output dtype: {at}")
                    if dtype == torch.float32:
                        errs["K9"] = max(errs["K9"], _check_out(
                            torch, out, want, kind, at))
                    elif kind == "min":
                        check(torch.equal(out, want), f"min differs: {at}")
                    else:     # the reference test's bf16 tolerance
                        check(torch.allclose(out.float(), want.float(),
                                             rtol=8e-2, atol=0.5),
                              f"bf16 sum outside rtol 8e-2: {at}")
                    check(torch.equal(out, rsr.segment_combine(
                        d, i, nseg, kind)), f"differs between runs: {at}")
                    check(int(dbg[0]) == cells, f"K9 cells: {at}")
                    m += 1
    log(f"[lanes] {n} laned cases x (K3, K4 host plan, K4 device plan), "
        f"Q in 1/5/16/33: min bit-equal, sum max_abs_err K3 "
        f"{errs['K3']:.3g} K4 {errs['K4']:.3g} (rtol 1e-5) and "
        "bit-repeatable, per-lane counts and executed cells equal the "
        f"host mirror / the planner; {m} K9 cases (float32 max_abs_err "
        f"{errs['K9']:.3g}, bfloat16 at bf16 resolution), repeatable")
    return errs


def _lane_round_bound_ms(part, n_active_edges, n_active_pairs, q):
    """Least time for one laned round's fused relax+reduce: every edge's
    source id and mask read to find the active edges, each edge active in
    some lane's destination id and weight, the (V, Q) value table and
    frontier once, the (num_segments, Q) inbox and (Q,) counts written
    once; a relax and a combine per active (edge, lane) pair at the
    float32 rate.  Returns (ms, "bytes" | "operations")."""
    e = part.S * part.E_max
    v = part.S * part.R_max
    nbytes = e * (4 + 1) + n_active_edges * (4 + 4) + v * q * (4 + 1) \
        + v * q * 4 + q * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * n_active_pairs / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _segment_bound_ms(e, nseg, itemsize=4):
    """Least time for K9: each message and id read once, the result
    written once; one combine per message at the float32 rate."""
    t_bytes = (e * (itemsize + 4) + nseg * itemsize) / HBM_BYTES_PER_S
    t_ops = e / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _ppr_oracle(torch, np, g, seeds, dampings, dev):
    """Personalized PageRank in float64 by power iteration on the card
    (``index_add_``): x = (1 - d) e_s + d A^T (x / outdeg), dangling mass
    dropped — ``reference.personalized_pagerank``'s semantics — iterated
    until no score moves by 1e-15.  Returns (n, Q) float64."""
    src = torch.as_tensor(g.src.astype(np.int64), device=dev)
    dst = torch.as_tensor(g.dst.astype(np.int64), device=dev)
    out_deg = np.maximum(g.out_degrees(), 1).astype(np.float64)
    w = torch.as_tensor(1.0 / out_deg[g.src], device=dev)
    q = len(seeds)
    d = torch.as_tensor(np.asarray(dampings, np.float64), device=dev)
    base = torch.zeros((g.n, q), dtype=torch.float64, device=dev)
    base[torch.as_tensor(seeds, device=dev), torch.arange(q, device=dev)] = \
        1.0 - d
    x = base * 0
    x[torch.as_tensor(seeds, device=dev), torch.arange(q, device=dev)] = 1.0
    for _ in range(1000):
        y = torch.zeros_like(x).index_add_(0, dst, x[src] * w[:, None])
        nx = base + d * y
        done = float((nx - x).abs().max()) < 1e-15
        x = nx
        if done:
            break
    return x.cpu().numpy()


def _profile(torch, what, fn, reps=5):
    """Print the device time by operator of ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    log(f"[profile] {what}, {reps} calls:\n"
        + prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=18))


def _heaviest_lane_round(torch, np, dev, part, arrays, queries):
    """Replay the Q-lane fixpoint round by round (dense launches) and
    return the entering (gval, gchg) tables of the round with the most
    active (edge, lane) pairs, the lane_unitw tensor, the round number
    and the rounds run."""
    from repro_torch import exchange
    from repro_torch.core import actions, engine
    from repro_torch.query import lanes
    init, unitw = lanes.init_lane_values(part, queries)
    val = torch.as_tensor(init, device=dev)
    unitw = torch.as_tensor(unitw, device=dev)
    chg = (val < math.inf) & arrays.slot_valid[..., None]
    cfg = engine.EngineConfig(use_pallas=True)
    best, rnd = None, 0
    while bool(chg.any()):
        rnd += 1
        nval, nchg, counts = exchange.fixpoint_round_stacked(
            actions.SSSP, arrays, cfg, part.S, part.R_max, val, chg, unitw)
        pairs = int(counts.sum())
        if best is None or pairs > best[0]:
            best = (pairs, rnd, val.reshape(-1, val.shape[-1]).clone(),
                    chg.reshape(-1, chg.shape[-1]).clone())
        val, chg = nval, nchg
    _, at, gval, gchg = best
    return gval, gchg, unitw, at, rnd


def _time_lane_kernels(torch, np, dev, part, arrays, planner, queries):
    """Time K3 and K4 on the heaviest round of the Q-lane fixpoint, beside
    the plain versions, a library call over pre-relaxed (E, Q) messages
    (``index_reduce_`` amin), the bound, and — for K3 — 16 solo K1
    launches of the same round.  Returns (K3 row, K4 row, max err)."""
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (
        _lane_messages, fused_relax_reduce_lanes_ref,
        fused_relax_reduce_wl_lanes_ref)
    gval, gchg, unitw, rnd, rounds = _heaviest_lane_round(
        torch, np, dev, part, arrays, queries)
    plan = arrays.fused_plan
    nseg = part.S * part.R_max
    q = gval.shape[1]
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    ids = arrays.edge_dst_flat.reshape(-1)
    ids_long = ids.long()
    gval_m = frr._masked_value_tables(gval, gchg, math.inf)
    unit_u8 = (unitw != 0).to(torch.uint8)
    chunk_act, counts = frr._lane_chunk_tables(src, mask, gchg,
                                               plan.src_deg)
    gchg_h = gchg.cpu().numpy()
    plain = fused_relax_reduce_lanes_ref(gval, gchg, unitw, src, w, mask,
                                         ids, nseg, "add_w", "min")
    out, dbg = frr._launch_lanes(gval_m, unit_u8, src, w, mask, ids, plan,
                                 chunk_act, "add_w", "min", True)
    torch.cuda.synchronize()
    check(torch.equal(out, plain), f"K3 round {rnd}: differs from plain")
    mirror = frr.fused_grid_cells(part.edge_dst_flat, part.edge_mask,
                                  part.edge_src_root_flat, gchg_h, nseg)
    check(int(dbg[0]) == mirror["fused_live"], f"K3 round {rnd}: cells")
    msg = _lane_messages(gval, gchg, unitw, src, w, mask, "add_w", "min")
    n_edges = int((mask & gchg.any(dim=1)[src.long()]).sum())
    n_pairs = int(counts.sum())
    bound, bound_by = _lane_round_bound_ms(part, n_edges, n_pairs, q)

    def library():
        return torch.full((nseg, q), math.inf, device=dev).index_reduce_(
            0, ids_long, msg, "amin", include_self=True)

    solo = []
    for lane in range(q):
        g_q = gval[:, lane].contiguous()
        c_q = gchg[:, lane].contiguous()
        solo.append((frr._masked_value_tables(g_q, c_q, math.inf),
                     frr._chunk_tables(src, mask, c_q)[0],
                     "add_one" if int(unitw[lane]) else "add_w"))

    def k1_solo():
        for g_q, a_q, rk in solo:
            frr._launch(g_q, src, w, mask, ids, plan, a_q, rk, "min", False)

    common = {"round": rnd, "rounds": rounds, "lanes": q,
              "active_edges": n_edges, "active_pairs": n_pairs,
              "bound_ms": bound, "bound_by": bound_by,
              "library_ms": time_ms(torch, library, reps=5)}
    k3 = dict(common, cells=mirror["fused_live"],
              launch_cells=mirror["launch_cells"],
              ms=time_ms(torch, lambda: ops.fused_relax_reduce_lanes(
                  gval, gchg, unitw, src, w, mask, ids, nseg, "add_w",
                  "min", plan=plan)),
              kernel_ms=time_ms(torch, lambda: frr._launch_lanes(
                  gval_m, unit_u8, src, w, mask, ids, plan, chunk_act,
                  "add_w", "min", False)),
              plain_ms=time_ms(torch, lambda: fused_relax_reduce_lanes_ref(
                  gval, gchg, unitw, src, w, mask, ids, nseg, "add_w",
                  "min"), reps=3),
              k1_solo_ms=time_ms(torch, k1_solo, reps=5))
    k3["batching_gain"] = k3["k1_solo_ms"] / k3["kernel_ms"]
    if PROFILE:
        _profile(torch, "K3 relax phase", lambda: ops.fused_relax_reduce_lanes(
            gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min",
            plan=plan))

    t0 = time.perf_counter()
    wl, info = planner.plan(gchg_h.any(axis=1))
    plan_ms = 1e3 * (time.perf_counter() - t0)
    wl_dev = wl.to(dev)
    grid = frr._wl_grid(wl, dev)
    out4, dbg4 = frr._launch_wl_lanes(gval_m, unit_u8, src, w, mask, ids, wl,
                                      nseg, "add_w", "min", True)
    plain4 = fused_relax_reduce_wl_lanes_ref(
        gval, gchg, unitw, src, w, mask, ids, wl_dev.wl_i, wl_dev.wl_j,
        wl_dev.nlive, nseg, "add_w", "min")
    torch.cuda.synchronize()
    check(torch.equal(out4, plain4) and torch.equal(out4, plain),
          f"K4 round {rnd}: differs from plain")
    check(int(dbg4[0]) == info.cells, f"K4 round {rnd}: cells")
    dev_pad = frr.device_worklist_pad(plan)
    if PROFILE:
        _profile(torch, "K4 relax phase (host plan)",
                 lambda: ops.fused_relax_reduce_lanes(
                     gval, gchg, unitw, src, w, mask, ids, nseg, "add_w",
                     "min", plan=plan, worklist=wl))
    k4 = dict(common, cells=info.cells, launched=info.launched,
              plan_ms=plan_ms,
              partial_bytes_host=frr.wl_lanes_partial_bytes(info.launched, q),
              partial_bytes_device=frr.wl_lanes_partial_bytes(dev_pad, q),
              device_pad=dev_pad,
              cells_ms=time_ms(torch, lambda: frr._wl_lanes_cells(
                  gval_m, unit_u8, src, w, mask, ids, wl_dev, grid, "add_w",
                  "min", False)),
              kernel_ms=time_ms(torch, lambda: frr._wl_lanes_fold(
                  frr._wl_lanes_cells(gval_m, unit_u8, src, w, mask, ids,
                                      wl_dev, grid, "add_w", "min",
                                      False)[0], wl_dev, nseg, "min")),
              ms=time_ms(torch, lambda: ops.fused_relax_reduce_lanes(
                  gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min",
                  plan=plan, worklist=wl)),
              device_ms=time_ms(torch, lambda: ops.fused_relax_reduce_lanes(
                  gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min",
                  plan=plan, grid_mode="device_worklist")),
              plain_ms=time_ms(torch, lambda: fused_relax_reduce_wl_lanes_ref(
                  gval, gchg, unitw, src, w, mask, ids, wl_dev.wl_i,
                  wl_dev.wl_j, wl_dev.nlive, nseg, "add_w", "min"), reps=3))
    return k3, k4, max_abs_err(torch, out, plain)


def _time_segment_kernel(torch, np, dev, part, arrays, root):
    """Replay the ``pallas_mode='reduce'`` BFS and SSSP fixpoints and time
    K9 on the round with the most active edges, beside its plain version,
    ``scatter_reduce_`` amin and the bound."""
    from repro_torch import exchange
    from repro_torch.core import actions, engine
    from repro_torch.kernels import ops
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    from repro_torch.kernels.ref import segment_combine_ref
    cfg = engine.EngineConfig(use_pallas=True, pallas_mode="reduce")
    nseg = part.S * part.R_max
    plan = arrays.fused_plan
    src = arrays.edge_src_root_flat.reshape(-1).long()
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    ids = arrays.edge_dst_flat.reshape(-1)
    ids_long = ids.long()
    best = None
    for sem in (actions.BFS, actions.SSSP):
        val = torch.as_tensor(engine.init_values(part, sem, {root: 0.0}),
                              device=dev)
        chg = (val == 0) & arrays.slot_valid
        rnd = 0
        while bool(chg.any()):
            rnd += 1
            gval, gchg = val.reshape(-1), chg.reshape(-1)
            active = mask & gchg[src]
            n = int(active.sum())
            if best is None or n > best[0]:
                msg = torch.where(active, sem.relax(gval[src], w), math.inf)
                best = (n, sem.name, rnd, msg)
            val, chg, _ = exchange.fixpoint_round_stacked(
                sem, arrays, cfg, part.S, part.R_max, val, chg)
    n, app, rnd, msg = best
    out, dbg = rsr._launch(msg, ids, plan, "min", True)
    plain = segment_combine_ref(msg, ids, nseg, "min")
    torch.cuda.synchronize()
    check(torch.equal(out, plain), f"K9 {app} round {rnd}: differs")
    check(int(dbg[0]) == plan.num_cells, f"K9 {app} round {rnd}: cells")
    e = msg.shape[0]
    bound, bound_by = _segment_bound_ms(e, nseg)
    row = {"app": app, "round": rnd, "active_edges": n, "edges": e,
           "cells": plan.num_cells, "bound_ms": bound, "bound_by": bound_by,
           "ms": time_ms(torch, lambda: ops.segment_combine(
               msg, ids, nseg, "min", plan=plan)),
           "kernel_ms": time_ms(torch, lambda: rsr._launch(
               msg, ids, plan, "min", False)),
           "plain_ms": time_ms(torch, lambda: segment_combine_ref(
               msg, ids, nseg, "min"), reps=5),
           "library_ms": time_ms(torch, lambda: torch.full(
               (nseg,), math.inf, device=dev).scatter_reduce_(
                   0, ids_long, msg, "amin", include_self=True), reps=5)}
    return row, max_abs_err(torch, out, plain)


def phase_lanes(torch, np, dev, g, part, root, want, part_pr):
    from repro_torch import apps, exchange, obs
    from repro_torch.apps.cc import _symmetrized_zero_weight
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    from repro_torch.query import lanes
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    reg = obs.registry()
    report = {"runs": {}}
    launches = {"K3": 0, "K4": 0, "K9": 0}

    def drive(key, run, call):
        """Drive one run of the path with the launch counts set to 0 just
        before it and read just after; returns its result and a row."""
        d = reg.counter("engine_dispatches_total").labels(run=run)
        h = reg.counter("engine_host_syncs_total").labels(run=run)
        d0, h0 = d.value, h.value
        frr.launches = frr.wl_launches = 0
        frr.lanes_launches = frr.wl_lanes_launches = rsr.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        row = {"wall_s": time.perf_counter() - t0, "k1": frr.launches,
               "k2": frr.wl_launches, "k3": frr.lanes_launches,
               "k4": frr.wl_lanes_launches, "k9": rsr.launches,
               "dispatches": d.value - d0, "host_syncs": h.value - h0}
        for k in launches:
            launches[k] += row[k.lower()]
        report["runs"][key] = row
        return res, row

    # the lane slice: Q = 16 lanes, each held to its solo K1 run
    deg = np.argsort(-g.out_degrees(), kind="stable")
    roots = [int(v) for v in deg[:LANES]]
    half = LANES // 2
    queries = [("bfs", r) for r in roots[:half]] + \
        [("sssp", r) for r in roots[half:]]
    cfg1 = engine.EngineConfig(use_pallas=True)
    t0 = time.perf_counter()
    solo = []
    for kind, r in queries:
        got, st, _ = getattr(apps, kind)(g, r, part=part, cfg=cfg1)
        solo.append((got, int(st.iterations), int(st.messages)))
    log(f"[lanes] {LANES} solo K1 runs (BFS from the {half} highest-out-"
        f"degree vertices, SSSP from the next {half}): "
        f"{time.perf_counter() - t0:.2f} s")
    for grid in ("dense", "worklist", "device_worklist"):
        cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid)
        (res, stats, _), row = drive(
            f"lanes_{grid}", "lanes_min",
            lambda: apps.batched_queries(g, queries, part=part, cfg=cfg))
        lane_rounds = [int(x) for x in stats.rounds]
        lane_msgs = [int(x) for x in stats.messages]
        for q, (got, (want_q, it, mc)) in enumerate(zip(res, solo)):
            check(np.array_equal(got, want_q),
                  f"lane {q} ({queries[q][0]}) {grid} differs from its solo "
                  f"K1 run at {int((got != want_q).sum())} vertices")
            check(lane_rounds[q] == it and lane_msgs[q] == mc,
                  f"lane {q} {grid}: rounds/messages {lane_rounds[q]}/"
                  f"{lane_msgs[q]}, solo {it}/{mc}")
        rounds = max(lane_rounds)
        if grid == "device_worklist":
            windows = -(-rounds // cfg.device_window)
            check(row["host_syncs"] == windows and row["k4"]
                  == windows * cfg.device_window and row["k3"] == 0,
                  f"lanes {grid}: {row['k4']} K4 launches, "
                  f"{row['host_syncs']} host syncs for {rounds} rounds")
        else:
            name = "k3" if grid == "dense" else "k4"
            other = "k4" if grid == "dense" else "k3"
            check(row[name] == rounds and row[other] == 0,
                  f"lanes {grid}: {row[name]} launches for {rounds} rounds")
        row.update(rounds=rounds, lane_rounds=lane_rounds,
                   messages=sum(lane_msgs))
        log(f"[lanes] Q={LANES} {grid}: every lane bit-equal to its solo K1 "
            f"run, rounds and messages equal; {rounds} rounds, K3 "
            f"{row['k3']} / K4 {row['k4']} launches, {row['host_syncs']} "
            f"host syncs, wall {row['wall_s']:.3f} s (setup included)")

    # a laned device_worklist window enqueues without any host sync
    arrays = engine.DeviceArrays.from_partition(part, dev)
    cfg_dev = engine.EngineConfig(use_pallas=True,
                                  grid_mode="device_worklist")
    init, unitw = lanes.init_lane_values(part, queries)
    val = torch.as_tensor(init, device=dev)
    chg = (val == 0) & arrays.slot_valid[..., None]
    unitw_t = torch.as_tensor(unitw, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exchange.fixpoint_window_stacked(
            actions.SSSP, arrays, cfg_dev, part.S, part.R_max,
            cfg_dev.device_window, val, chg, unitw_t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[lanes] a {cfg_dev.device_window}-round Q={LANES} window enqueued "
        "under sync-debug mode 'error': no host sync inside the window")

    # connected components on the symmetrized zero-weight graph
    t0 = time.perf_counter()
    part_cc = build_partition(_symmetrized_zero_weight(g),
                              PartitionConfig(num_shards=SHARDS,
                                              rpvo_max=RPVO_MAX))
    ncomp, lab = connected_components(
        csr_matrix((np.ones(g.num_edges), (g.src, g.dst)), shape=(g.n, g.n)),
        directed=True, connection="weak")
    min_id = np.full(ncomp, g.n, np.int64)
    np.minimum.at(min_id, lab, np.arange(g.n))
    want_cc = min_id[lab]
    log(f"[lanes] cc partition + scipy components ({ncomp}): "
        f"{time.perf_counter() - t0:.1f} s")
    (labels, stats, _), row = drive("cc", "lanes_min", lambda: apps.cc(
        g, part=part_cc, cfg=cfg1))
    check(np.array_equal(labels, want_cc),
          f"cc differs from scipy at {int((labels != want_cc).sum())} "
          "vertices")
    check(row["k3"] == int(stats.rounds[0]),
          f"cc: {row['k3']} K3 launches for {int(stats.rounds[0])} rounds")
    row.update(rounds=int(stats.rounds[0]), components=int(ncomp))
    log(f"[lanes] cc: equal to scipy's {ncomp} weak components (min-id "
        f"labels); {row['rounds']} rounds, {row['k3']} K3 launches, wall "
        f"{row['wall_s']:.3f} s")

    # personalized PageRank lanes against a float64 power iteration
    seeds = [int(v) for v in deg[:PPR_SEEDS]]
    damps = [PPR_DAMPINGS[i % len(PPR_DAMPINGS)] for i in range(PPR_SEEDS)]
    t0 = time.perf_counter()
    want_ppr = _ppr_oracle(torch, np, g, seeds, damps, dev)
    log(f"[lanes] float64 PPR oracle ({PPR_SEEDS} seeds, dampings "
        f"{sorted(set(damps))}): {time.perf_counter() - t0:.1f} s")
    (scores, stats, _), row = drive(
        "ppr", "ppr", lambda: apps.personalized_pagerank(
            g, seeds, damps, part=part_pr, cfg=cfg1))
    diff = float(np.abs(scores - want_ppr).max())
    check(np.allclose(scores, want_ppr, rtol=PR_RTOL, atol=PR_ATOL),
          f"ppr off the float64 oracle by {diff}")
    rounds = int(stats.rounds.max())
    check(row["k3"] == rounds, f"ppr: {row['k3']} K3 launches, {rounds} "
          "rounds")
    row.update(rounds=rounds, lane_rounds=[int(x) for x in stats.rounds],
               max_abs_diff=diff)
    log(f"[lanes] personalized_pagerank: {PPR_SEEDS} lanes within rtol "
        f"{PR_RTOL} / atol {PR_ATOL} of the oracle (max |diff| {diff:.3g}); "
        f"{rounds} rounds, {row['k3']} K3 launches, wall "
        f"{row['wall_s']:.3f} s")
    for grid in ("auto", "device_worklist"):
        cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid)
        (rank, stats), row = drive(
            f"ppr_delta_{grid}", "ppr_delta_lanes",
            lambda: lanes.run_ppr_delta_lanes(part_pr, seeds, damps, cfg,
                                              tol=PPR_DELTA_TOL))
        rank = rank.cpu().numpy()
        got = np.stack([engine.vertex_values(part_pr, rank[..., q])
                        for q in range(PPR_SEEDS)], axis=-1)
        diff = float(np.abs(got - want_ppr).max())
        check(np.allclose(got, want_ppr, rtol=PR_RTOL, atol=PR_ATOL),
              f"ppr_delta {grid} off the float64 oracle by {diff}")
        rounds = int(stats.rounds.max())
        check(row["k4"] > 0 and row["k4"] + row["k3"] >= rounds,
              f"ppr_delta {grid}: K3 {row['k3']} / K4 {row['k4']} "
              f"launches for {rounds} rounds")
        if grid == "device_worklist":
            check(row["host_syncs"] == -(-rounds // cfg.device_window),
                  f"ppr_delta device: {row['host_syncs']} host syncs")
        row.update(rounds=rounds, messages=int(stats.messages.sum()),
                   max_abs_diff=diff)
        log(f"[lanes] run_ppr_delta_lanes {grid}: tol {PPR_DELTA_TOL}, "
            f"{rounds} rounds within rtol {PR_RTOL} / atol {PR_ATOL} of the "
            f"oracle (max |diff| {diff:.3g}), K3 {row['k3']} / K4 {row['k4']} "
            f"launches, {row['host_syncs']} host syncs, wall "
            f"{row['wall_s']:.3f} s")

    # pallas_mode='reduce': BFS and SSSP through K9
    cfg_r = engine.EngineConfig(use_pallas=True, pallas_mode="reduce")
    for name in ("bfs", "sssp"):
        (got, stats, _), row = drive(
            f"{name}_reduce", name,
            lambda: getattr(apps, name)(g, root, part=part, cfg=cfg_r))
        check(np.array_equal(got, want[name]),
              f"{name} reduce differs from the numpy oracle at "
              f"{int((got != want[name]).sum())} vertices")
        check(row["k9"] == int(stats.iterations) and row["k1"] == 0,
              f"{name} reduce: {row['k9']} K9 launches, "
              f"{int(stats.iterations)} rounds")
        log(f"[lanes] {name} pallas_mode='reduce': equal to the oracle; "
            f"{int(stats.iterations)} rounds, {row['k9']} K9 launches, "
            f"wall {row['wall_s']:.3f} s")

    # replay the heaviest rounds for timings
    planner = engine.launch_planner(part, engine.EngineConfig(
        use_pallas=True, grid_mode="worklist"), q_pad=LANES)
    k3, k4, err = _time_lane_kernels(torch, np, dev, part, arrays, planner,
                                     queries)
    k9, err9 = _time_segment_kernel(torch, np, dev, part, arrays, root)
    report.update(k3=k3, k4=k4, k9=k9)
    log(f"[lanes] heaviest Q={LANES} round (round {k3['round']} of "
        f"{k3['rounds']}: {k3['active_edges']} active edges, "
        f"{k3['active_pairs']} active (edge, lane) pairs): K3 relax phase "
        f"{k3['ms']:.4f} ms (kernel alone {k3['kernel_ms']:.4f} ms), 16 solo "
        f"K1 launches {k3['k1_solo_ms']:.4f} ms (gain "
        f"{k3['batching_gain']:.2f}x), plain {k3['plain_ms']:.4f} ms, "
        f"index_reduce_ amin {k3['library_ms']:.4f} ms, bound "
        f"{k3['bound_ms']:.4f} ms ({k3['bound_by']})")
    log(f"[lanes] same round, K4 ({k4['cells']} cells): planner "
        f"{k4['plan_ms']:.2f} ms (host), K4 {k4['cells_ms']:.4f} ms, K4+fold "
        f"{k4['kernel_ms']:.4f} ms, relax phase {k4['ms']:.4f} ms (device "
        f"plan {k4['device_ms']:.4f} ms), plain {k4['plain_ms']:.4f} ms; "
        f"partials {k4['partial_bytes_host']} B (host pad "
        f"{k4['launched']}), {k4['partial_bytes_device']} B (device pad "
        f"{k4['device_pad']})")
    log(f"[lanes] heaviest reduce round ({k9['app']} round {k9['round']}, "
        f"{k9['active_edges']} active of {k9['edges']} edges): K9 "
        f"{k9['ms']:.4f} ms (kernel alone {k9['kernel_ms']:.4f} ms), plain "
        f"{k9['plain_ms']:.4f} ms, scatter_reduce_ amin "
        f"{k9['library_ms']:.4f} ms, bound {k9['bound_ms']:.4f} ms")
    return launches, {"K3": err, "K4": err, "K9": err9}, report


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi, build_s = phase_device()
    errs = phase_kernel_vs_plain(torch, np, dev)
    phase_counter_gate(np, dev)
    g, part, root, want = rmat18(np)
    k1_launches, err, report = phase_main_path(torch, np, dev, g, part, root,
                                               want)
    launches2, err2, report2, part_pr = phase_slice2(torch, np, dev, g, part,
                                                     root, want)
    errs3 = phase_lane_kernels_vs_plain(torch, np, dev)
    launches3, err3, report3 = phase_lanes(torch, np, dev, g, part, root,
                                           want, part_pr)
    heavy, heavy2 = report["heaviest"], report2["heaviest"]
    k3, k4, k9 = report3["k3"], report3["k4"], report3["k9"]

    report.update(slice2=report2, slice3=report3, device=smi,
                  build_s=build_s, total_s=time.perf_counter() - t_start)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    kernels = {"kernels": [{
        "name": "fused_relax_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_relax_reduce.cu",
        "replaces": "src/repro/kernels/fused_relax_reduce.py:323",
        "launches": k1_launches + launches2["K1"],
        "max_abs_err": max(err, errs["K1"]),
        "ms": heavy["ms"],
        "plain_ms": heavy["plain_ms"],
        "bound_ms": heavy["bound_ms"],
        "bound_by": heavy["bound_by"],
        "library_ms": heavy["library_ms"],
        "kernel_ms": heavy["kernel_ms"],
        "median_ms": report["median"]["ms"],
        "checked": True,
    }, {
        "name": "fused_relax_reduce_wl",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_relax_reduce_wl.cu",
        "replaces": "src/repro/kernels/fused_relax_reduce.py:613",
        "launches": launches2["K2"],
        "max_abs_err": max(err2, errs["K2"]),
        "ms": heavy2["ms"],
        "plain_ms": heavy2["plain_ms"],
        "bound_ms": heavy2["bound_ms"],
        "bound_by": heavy2["bound_by"],
        "library_ms": heavy2["library_ms"],
        "kernel_ms": heavy2["kernel_ms"],
        "cells_ms": heavy2["cells_ms"],
        "median_ms": report2["median"]["ms"],
        "checked": True,
    }, {
        "name": "fused_relax_reduce_lanes",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_relax_reduce_lanes.cu",
        "replaces": "src/repro/kernels/fused_relax_reduce.py:391",
        "launches": launches3["K3"],
        "max_abs_err": max(err3["K3"], errs3["K3"]),
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "kernel_ms": k3["kernel_ms"],
        "k1_solo_ms": k3["k1_solo_ms"],
        "lanes": k3["lanes"],
        "checked": True,
    }, {
        "name": "fused_relax_reduce_wl_lanes",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_relax_reduce_wl_lanes.cu",
        "replaces": "src/repro/kernels/fused_relax_reduce.py:639",
        "launches": launches3["K4"],
        "max_abs_err": max(err3["K4"], errs3["K4"]),
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
        "kernel_ms": k4["kernel_ms"],
        "cells_ms": k4["cells_ms"],
        "lanes": k4["lanes"],
        "checked": True,
    }, {
        "name": "segment_combine",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_combine.cu",
        "replaces": "src/repro/kernels/rhizome_segment_reduce.py:39",
        "launches": launches3["K9"],
        "max_abs_err": max(err3["K9"], errs3["K9"]),
        "ms": k9["ms"],
        "plain_ms": k9["plain_ms"],
        "bound_ms": k9["bound_ms"],
        "bound_by": k9["bound_by"],
        "library_ms": k9["library_ms"],
        "kernel_ms": k9["kernel_ms"],
        "checked": True,
    }]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
