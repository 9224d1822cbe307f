#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``src/repro_torch/kernels/csrc`` into
the ignored ``src/repro_torch/kernels/build/`` and runs, in order:

1. device: the card's name and power limit, and the kernel's build time;
2. kernel vs plain version: the fused relax+reduce kernel against its
   plain PyTorch version on the card, all three relax/combine pairings,
   ragged sizes, frontier densities 0 / 1% / 100%, padding edges,
   unsorted ids and negative weights for min.  Min is bit-equal; sum is
   within rtol 1e-5 (the kernel sums in another order) and bit-equal
   between two runs; counts and executed cells equal the host mirror;
3. counter gate: BFS and SSSP on the RMAT scale-8 partition under the
   flight recorder hit ``benchmarks/baselines/counter_gate.json``'s
   ``bfs_dense`` / ``sssp_dense`` fields exactly;
4. main path: ``apps.bfs`` and ``apps.sssp`` with the kernel on an
   RMAT-18 partition (edge factor 16, seed 7, 16 shards, rpvo_max 4)
   equal the numpy oracles exactly, with one kernel launch per round;
   then every round is replayed to time the kernel against its bound,
   its plain version and a library scatter-reduce.

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
    lib = _build.build("fused_relax_reduce")
    build_s = time.perf_counter() - t0
    log(f"[device] {smi}")
    log(f"[device] built {lib.name} in {build_s:.2f} s")
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


def phase_kernel_vs_plain(torch, np, dev):
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels.ref import fused_relax_reduce_ref
    shapes = [(17, 7, 3), (1000, 5 * frr.EBLK + 13, 2 * frr.SBLK + 5),
              (30011, 97 * frr.EBLK + 311, 20011)]
    errs = {}
    n = 0
    for relax, kind in (("add_w", "min"), ("add_one", "min"),
                        ("mul_w", "sum")):
        err = 0.0
        for v, e, nseg in shapes:
            for frac in (0.0, 0.01, 1.0):
                for sorted_ids in (True, False):
                    case = _case(np, v, e, nseg, frac, seed=v + e + n,
                                 sorted_ids=sorted_ids,
                                 negative=kind == "min")
                    args = [torch.as_tensor(x, device=dev) for x in case]
                    out, count, dbg = frr.fused_relax_reduce(
                        *args, nseg, relax, kind, with_count=True,
                        with_debug=True)
                    want = fused_relax_reduce_ref(*args, nseg, relax, kind)
                    torch.cuda.synchronize()
                    where = f"{relax}/{kind} v={v} e={e} nseg={nseg} " \
                            f"frac={frac} sorted={sorted_ids}"
                    if kind == "min":
                        check(torch.equal(out, want), f"min differs: {where}")
                    else:
                        check(torch.allclose(out, want, rtol=1e-5,
                                             atol=1e-6),
                              f"sum outside rtol 1e-5: {where}")
                        again = frr.fused_relax_reduce(*args, nseg, relax,
                                                       kind)
                        check(torch.equal(out, again),
                              f"sum differs between runs: {where}")
                    err = max(err, max_abs_err(torch, out, want))
                    gval, gchg, src, w, mask, ids = case
                    check(int(count) == int((mask & gchg[src]).sum()),
                          f"count differs: {where}")
                    mirror = frr.fused_grid_cells(ids, mask, src, gchg, nseg)
                    check(int(dbg[0]) == mirror["fused_live"],
                          f"executed cells {int(dbg[0])} != mirror "
                          f"{mirror['fused_live']}: {where}")
                    n += 1
        errs[(relax, kind)] = err
    log(f"[kernel] {n} cases: min bit-equal, sum max_abs_err "
        f"{errs[('mul_w', 'sum')]:.3g} (rtol 1e-5), counts and executed "
        "cells equal the host mirror")
    return errs


# --------------------------------------------------------------------------
# phase 3: counter gate at RMAT scale 8
# --------------------------------------------------------------------------

def phase_counter_gate(np, dev):
    from repro_torch import obs
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators
    gate = json.loads(
        (ROOT / "benchmarks" / "baselines" / "counter_gate.json").read_text())
    gg = gate["graph"]
    g = generators.rmat(gg["scale"], edge_factor=gg["edge_factor"],
                        seed=gg["seed"])
    root = int(np.argmax(g.out_degrees()))
    part = build_partition(g.with_random_weights(seed=gg["seed"]),
                           PartitionConfig(num_shards=4, rpvo_max=4))
    fields = ("rounds", "messages", "pruned", "shard_messages",
              "frontier_first", "cells")
    with obs.recording() as rec:
        for sem in (actions.BFS, actions.SSSP):
            engine.run_stacked(sem, part,
                               engine.init_values(part, sem, {root: 0.0}),
                               engine.EngineConfig(use_pallas=True),
                               device=dev)
            rs = [r for r in rec.rounds if r.run == sem.name]
            got = {"rounds": len(rs), "frontier_first": rs[0].frontier,
                   "messages": sum(r.messages for r in rs),
                   "pruned": sum(r.pruned for r in rs),
                   "cells": sum(r.cells for r in rs),
                   "shard_messages": [sum(c) for c in zip(
                       *(r.shard_messages for r in rs))]}
            want = gate["runs"][f"{sem.name}_dense"]
            for f in fields:
                check(got[f] == want[f],
                      f"counter gate {sem.name}_dense.{f}: {got[f]} != "
                      f"{want[f]}")
            log(f"[gate] {sem.name}_dense: rounds {got['rounds']}, messages "
                f"{got['messages']}, pruned {got['pruned']}, cells "
                f"{got['cells']} — equal to counter_gate.json")


# --------------------------------------------------------------------------
# phase 4: the main path at RMAT-18
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


def phase_main_path(torch, np, dev):
    from repro_torch import apps, exchange
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators, reference
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fused_relax_reduce_ref

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
    want_levels = reference.bfs_levels(g, root)
    want_dist = reference.sssp_dijkstra(g, root)
    log(f"[main] numpy oracles {time.perf_counter() - t0:.1f} s")

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
    launches, err, report = phase_main_path(torch, np, dev)
    heavy = report["heaviest"]

    report.update(device=smi, build_s=build_s,
                  total_s=time.perf_counter() - t_start)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    kernels = {"kernels": [{
        "name": "fused_relax_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_relax_reduce.cu",
        "replaces": "src/repro/kernels/fused_relax_reduce.py:323",
        "launches": launches,
        "max_abs_err": max(err, *errs.values()),
        "ms": heavy["ms"],
        "plain_ms": heavy["plain_ms"],
        "bound_ms": heavy["bound_ms"],
        "bound_by": heavy["bound_by"],
        "library_ms": heavy["library_ms"],
        "kernel_ms": heavy["kernel_ms"],
        "median_ms": report["median"]["ms"],
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
