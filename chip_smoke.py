#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --plan-timing [SRC]
    python3 chip_smoke.py --fold-sweep
    python3 chip_smoke.py --trace-drops
    python3 chip_smoke.py --lm-sharded
    python3 chip_smoke.py --dryrun JOB

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
   mirror (K1) or the planner's cells (K2); K2 on flags listing exactly
   K1's cells equals K1 bit for bit (K1 and K2 share one launch over the
   plan's pieces), K1 with every block one piece equals K1 in pieces
   (min bit for bit, sum within rtol 1e-5), and on the small shapes K1,
   in pieces and one piece a block, equals its order model
   (``ref.fused_relax_reduce_order``) bit for bit, sum included;
3. counter gate: BFS and SSSP (dense, worklist, device_worklist) and
   delta-PageRank (auto, device_worklist) on the RMAT scale-8 partition
   under the flight recorder hit ``benchmarks/baselines/counter_gate.json``
   exactly, and so do the gate's streaming schedule (a
   ``StreamingGraph`` tracking BFS and SSSP through two commits, K1:
   the six ``stream_*`` legs) and its kill-and-restore leg
   (``run_resilient`` with a real ``CheckpointManager``:
   ``resilient_kill_restore``);
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
   delta-PageRank) is replayed: K2 from the host plan and the device
   plan against its plain version and the planner's cell counts, K2 on
   flags listing exactly the round's K1 cells against K1 bit for bit,
   and K1 one piece a block against K1 in pieces; the host
   planner, K2 alone (host and device plans), the relax phase (both
   plans), K1 on the same round, the plain version and a library call
   are timed against the same byte bound as K1; on the heaviest round K2
   is timed at 4, 8, 16 and 32 cells a piece, the cut's histogram is
   printed, ``torch.profiler`` counts the kernels each relax phase
   (K1, K2 host plan, K2 device plan) puts on the card, and the
   ``[k1-cell]`` line gives K1 alone on the heaviest dense round and
   summed over every round phases 4 and 5 replay;
6. slice-3 path, query lanes, at the same width: first the lane-batched
   kernels K3 (dense) and K4 (worklist, host and device plans) against
   their plain versions (both laned pairings, mixed ``lane_unitw``,
   Q in {1, 5, 16, 33}, ragged sizes, frontier densities 0 / 1% / 100%,
   a converged lane), K4 on flags listing exactly K3's cells against K3
   bit for bit, K3 one piece a block against K3 in pieces, and on the
   small shapes K3 against its order model
   (``ref.fused_relax_reduce_lanes_order``) bit for bit, sum included;
   and the segment reduce K9 (float32 and bfloat16) against its plain
   version and, at its cut and one piece a block, its order model
   (``ref.segment_combine_order``) bit for bit, with the cells, pieces
   and edges it counts equal to its plan's tables;
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
   equal the numpy oracles, and PageRank under it (30 rounds, K9's sum)
   is within rtol 1e-4 / atol 1e-7 of the float64 oracle, one K9 launch
   a round; and the heaviest rounds replayed to time K3, K4 (host and
   device plans; also at 4-32 cells a piece, and on flags listing K3's
   cells held to K3 bit for bit) and K9 against their plain versions, a
   library call and the bound — K3 also against 16 solo K1 launches of
   the same round — with the kernels each laned relax phase puts on the
   card counted by ``torch.profiler``; the ``[k3-fold]`` lines give K3
   alone summed over the fixpoint's rounds, the laned kernels' blocks
   resident per SM, and the heaviest piece's edges and runs.  K9 is held
   to its order model bit for bit on the heaviest min round and on a
   PageRank round (sum), and timed there through its wrapper, with
   prepared launches (``_k9_raw``: device time, the wrapper's host time
   left out) and against ``scatter_reduce_`` amin / ``index_add_``; the
   ``[k9]`` lines give its pieces and the ids and messages its warps
   load, both counted on the card (``with_debug``) and held to the
   plan's tables, ``[k9-trace]`` the K9 kernels ``torch.profiler`` sees
   in traces of 20 launches started three ways (the scheduled one, its
   launches 0.05 s inside its window on both sides, must see all 20)
   and the launches each holds no kernel record of, and
   ``[k9-cell]`` its time at
   4-32 cells a piece on the heaviest round, summed over the 13
   BFS/SSSP rounds and on the PageRank round.

7. slice-4 path, the tiled residency: first the tiled kernels K5 (dense),
   K6 (worklist, host and device plans), K7 (dense lanes) and K8
   (worklist lanes) against their plain versions (all pairings, Q in
   {1, 5, 16, 33}, vblk 128 and the automatic width, ragged sizes,
   frontier densities 0 / 1% / 100%, a converged lane) and against their
   pinned twins K1-K4 on the same plan and pieces, bit for bit, sum
   included (and, one piece a block, to the dense K1/K3), with
   executed cells and staged rows equal to the host mirror (the same rows
   dense and on both plans); then on the RMAT-18 partition with
   ``vmem_budget_bytes`` under the value table's bytes (512 KiB unlaned,
   8 MiB for Q = 16 lanes): BFS and SSSP under ``dense`` (K5),
   ``worklist`` and ``device_worklist`` (K6, a window enqueued under
   sync-debug mode 'error') equal the oracles, delta-PageRank under
   ``device_worklist`` within tolerance, and ``apps.batched_queries``
   under the three launch shapes (K7, K8) every lane bit-equal to the
   pinned K3 run, with one tiled launch per round; then the heaviest
   rounds replayed to time K5 against K1, K6 against K2, K7 against K3
   and K8 against K4 on the same round and plan (host and device plans
   for K6/K8, with the tiled and pinned planners' host time and K6/K8
   alone at 4-32 cells a piece), beside their plain versions,
   the pinned twin's library call and byte bound, and the rows the
   kernels stage.

8. slice-10 path, the compact targeted exchange and the query server,
   at the same width.  8a: BFS and SSSP under ``exchange='compact'`` with
   ``dense`` (K1), ``worklist`` and ``device_worklist`` (K2) launches
   equal the oracles, with rounds, messages and pruned counts equal to
   the dense exchange's; PageRank (30 rounds) and delta-PageRank
   (``device_worklist``) within tolerance of the float64 oracle; BFS
   under ``pallas_mode='reduce'`` (K9 on the compact plan); Q = 16 lanes
   (K3 dense, K4 device plan) bit-equal to the dense exchange's lanes,
   ``LaneStats.exchanged`` = live lane-rounds x S*S*P_t; SSSP under a
   512 KiB budget (K5, K6) equal to the pinned run; then the heaviest
   compact rounds replayed to hold K1, K2, K3 and K9 on the compact plan
   to their plain versions (min bit for bit, sum on a PageRank round
   within rtol 1e-5 / atol 1e-6) and time each against the same kernel
   on the dense plan of the round, its byte bound (the compact inbox
   counted in), its library call, with the inbox scatter's cost at
   Q = 16 (``[compact]``, ``[compact-kernel]``).  8b: a ``QueryServer``
   (16 min lanes, 8 PPR lanes) on the PageRank partition answers one
   stream (16 BFS, 8 SSSP, 8 reachability, then 8 PPR, in four waves
   between ticks) three ways (``SERVE_RUNS``: dense exchange and
   ``device_worklist`` at 8 rounds a tick, compact and
   ``device_worklist`` at 8, compact and ``dense`` at 1): every min
   result equals its solo run bit for bit (the root's BFS equals the
   numpy oracle), PPR within tolerance of the float64
   oracle, rounds and messages equal across the runs (the PPR pool needs
   the PageRank weights, so the root's SSSP is held to Dijkstra on them
   within rtol 1e-5, as the reference's server test holds it); requests per
   second, latency p50/p99, ms a tick, host reads a tick and occupancy
   are printed (``[serve]``); three ticks under CUDA's sync-debug mode
   'warn' show each synchronizing call is one of the server's counted
   host reads; four ticks under ``torch.profiler`` give the device's
   busy share and the kernels by device time (``[serve-profile]``); and
   an overload run gives its typed statuses.

9. slice-11 path, streaming mutation and recovery, at RMAT-18
   (``phase_mutation``): ``StreamingGraph``s under ``dense`` (K1) and
   ``device_worklist`` (K2) track BFS/SSSP from the root and
   delta-PageRank through a 1% insert batch (41,882 edges) and 4,096
   inserts + 8 deletes; after each commit BFS/SSSP equal the numpy
   oracles and a cold fixpoint on the spliced partition bit for bit, with
   fewer warm messages than cold, and PageRank is within rtol 1e-4 /
   atol 1e-7 of the float64 oracle; ``runner='lanes'`` (K3) on the same
   schedule equals them bit for bit; a ``QueryServer`` (16 lanes,
   ``device_worklist``: K4) bound to the dense graph answers 48
   BFS/SSSP requests across three commits (insert-only with lanes in
   flight, one with deletes, one more insert-only), each answer equal to
   a solo run on the partition it finished on; ``StackedTask`` (SSSP,
   K1), ``PagerankTask`` (K2) and ``LanesTask`` (Q = 16, K3) under a
   fault and a real ``CheckpointManager`` equal their uninterrupted
   runs.  It prints each commit's split (splice, maintenance, the
   server's swap), warm against cold rounds and messages, requests/s,
   host reads a tick and the checkpoint write and restore times
   (``[mutation]``).

10. slice-12 path, the sharded layout on ``torch.distributed``
   (``phase_sharded``): ``bfs(..., num_shards=1, mesh=)`` on a one-rank
   NCCL group over the card; then 16 ranks spawned side by side on the
   one card (NCCL takes one rank a GPU) over a gloo group with a
   ``FileStore``, a ``DeviceMesh("cuda", (8, 2))`` over them, each rank
   loading phase 4's RMAT-18 partition and phase 5's PageRank partition
   from one pickle and making the same calls: a probe of which gloo
   collective takes which CUDA dtype, BFS and SSSP under ``dense`` (K1),
   ``device_worklist`` (K2), ``pallas_mode='reduce'`` (K9) and the
   compact exchange, PageRank (30 rounds) and delta-PageRank, Q = 16
   lanes under ``dense`` (K3) and ``device_worklist`` (K4), a sharded
   ``QueryServer`` (16 min + 8 PPR lanes) answering 16 mixed requests,
   ``StreamingGraph(runner='sharded')`` through one commit of 4,096
   inserts (BFS, SSSP) and one ``ShardedTask`` recovering from a
   corrupted tile with real checkpoint managers.  Here, against what
   rank 0 writes: min values equal the numpy oracles and ``RunStats`` /
   ``LaneStats`` the stacked runs exactly, PageRank within rtol 1e-4 /
   atol 1e-7 of the oracle, served answers their solo runs (PPR the
   float64 oracle), the warm commit a cold run and the oracle, the
   recovered run the uninterrupted one; then K1, K2, K3 (Q = 16) and K9
   on one shard's launch on the heaviest round against their plain
   versions and K1/K3/K9 against their order models.  It prints each
   leg's wall, rounds and a round's split into relax, collectives and
   host (rank 0, each synced), the bytes each collective brings a rank
   a round (``[sharded]``).  These times are 16 ranks sharing one card
   over gloo, not a multi-GPU layout's.

11. slice-13 simulation layer (``phase_amcca``): ``benchmarks/fig10.py``'s
   simulator runs (BFS on ``ba_skewed`` 600 / 1,200 on 64 / 256 CCs,
   mesh and torus), ``fig6.py``'s (RMAT-10 SSSP on 256 CCs, rpvo_max 8)
   and ``fig8.py``'s cost-model replays (``ba_skewed(2^14)``, five
   all-vertex rounds, 4,096 and 16,384 CCs, rpvo_max 1-16) run on the
   card and again through the same code on the CPU, every ``SimResult``
   / ``CostResult`` field equal, simulated values equal to the numpy
   oracles; one RMAT-14 BFS simulation on 4,096 CCs runs on the card
   alone, held to the oracle.  It prints cycles, speedups, the torus's
   time and energy against the mesh and the wall seconds (``[amcca]``).

12. slice-13 LM serving (``phase_lm_serve``): 12a the ten architectures
   at ``reduced()`` width in float32 with the same weights on the card
   and the CPU (prefill logits within rtol/atol 1e-4, 8 greedy tokens
   and every MoE routing's expert indices equal); 12b minitron-4b at
   full width in bfloat16 (weights drawn on the card from seed 0), a
   ``ContinuousBatcher`` of 8 slots (max_len 1,024) answering 16
   requests (prompts of 64-512 tokens, 32 new), each answer run again
   alone (B = 1) on its own tokens: equal up to the first step whose
   top-2 margin is under 8 bfloat16 ulps of the row's largest |logit|,
   and every token within that of the lone run's top logit; requests/s,
   decode tokens/s, prefill ms, peak memory and a profiled decode step
   are printed; 12c granite-moe-1b-a400m (float32 and a capacity factor
   of E / K, so no token drops; each decoded token's MoE routing forced
   to the prefill's, near-ties under 1e-6 of probability allowed) and
   xlstm-125m (bfloat16) at full width: a
   4 x 256 prefill and 16 decode steps, each step's logits within the
   tolerance of a prefill of the extended sequence (``[lm-serve]``).

13. slice-14 LM training (``phase_lm_train``): 13a the ten architectures
   at ``reduced()`` width in float32 with the same weights on the card
   and the CPU: ``Model.loss`` and its metrics within rtol 1e-5, every
   gradient leaf within rtol 1e-4 + 1e-5 of the largest gradient; for
   minitron and granite one ``make_train_step`` step with remat on and
   off, and with ``accum_steps=4`` against one batch (granite at a
   capacity factor of E / K, so no token drops), within
   ``tests/test_grad_accum.py``'s rtol 5e-4 / atol 6e-4 (an entry whose
   clipped gradient is under 100 Adam eps within one lr); 13b
   minitron-4b at full width and depth in bfloat16 (remat on, weights
   drawn on the card from seed 0) trained 8 ``Trainer`` steps on
   ``TokenPipeline(vocab=256000, seq_len=512, global_batch=4)`` at a
   constant lr: step 0's ce in [12, 14], every metric finite, the last
   ce under the first, peak memory under 75 GiB; it prints ms a step
   (forward + backward, optimizer), tokens/s, MFU against 989.4 TFLOP/s
   and one profiled step's kernels and device busy share; 13c
   granite-moe-1b-a400m at full width cut to 2 layers, in a child
   process (``--lm-resume DIR``) with ``CUBLAS_WORKSPACE_CONFIG`` set
   and deterministic algorithms: 6 ``Trainer`` steps with async
   checkpoints every 2, killed at step 5 and resumed, every parameter,
   moment and logged metric equal bit for bit to a straight run, with
   the checkpoint write (caller's and writer's thread) and restore
   times (``[lm-train]``).
14. Sharded LM training and serving (``phase_lm_sharded``,
   ``[lm-sharded]``): gloo's point-to-point send of the card's tensors
   probed in two throwaway processes; 14a 13b's minitron-4b run on a
   (1, 1) mesh over a one-rank NCCL group, 4 ``Trainer(..., ctx)``
   steps with each ce equal to 13b's within 1e-3 relative, then
   ``make_serve_steps`` under "opt" (a 4 x 256 prefill, 8 decode steps)
   held to the unsharded model by 12b's rule; 14b four spawned gloo
   ranks on the card, a (2, 2) ("data", "model") mesh: granite at full
   width and depth (float32, ``moe_shardmap``, capacity E / K) and
   minitron cut to 4 layers (bfloat16), 2 ``make_train_step`` steps
   each, held after the ranks free their state to an unsharded twin on
   rank 0 (granite: loss and metrics rtol 1e-5, every parameter to
   ``tests/test_grad_accum.py``'s tolerance with the Adam-eps clause,
   the twin taking the sharded run's expert choices; minitron: ce 1e-2),
   a rank's parameter + moment bytes at most 0.26 of the unsharded, one
   all-reduce over model a MoE layer in the forward, the collectives a
   step counted (``CommDebugMode``) and metered (calls, bytes, synced
   seconds), each rank's peak; then serving under "opt" with the KV
   sequence over model; 14c ``pipeline_apply`` over a ("pod",) mesh of
   2 gloo ranks at the dry-run's pipeline cell, float32 held to the
   sequential stages (output and gradients), bfloat16 timed.
15. The dry-run tools (``phase_dryrun``, ``[dryrun]``), after phase 14:
   each trace runs in a child process of its own (``--dryrun JOB``; a
   fake default process group cannot share a process with phase 14's
   groups), all started together, a core each, on fake CUDA tensors
   over ``fake`` process groups.  15a: minitron-4b ``train_4k`` /
   ``prefill_32k`` / ``decode_32k``, granite-moe-1b-a400m ``train_4k``
   and xlstm-125m ``long_500k`` on the 16x16 mesh, ``graph-bfs-rhizome``
   on the 16x16 and 2x16x16 meshes and the pipeline cell; each must be
   ``ok``, its ``per_device`` fields finite, its FLOPs nonzero where it
   has products, and its record as written equal field for field to
   ``reanalyze`` of its trace summary read back from disk; each cell's
   roofline terms, dominant term and trace seconds are printed.  15b: a
   child traces 13b's minitron-4b step (full width and depth, bfloat16,
   remat, 4 x 512) on a (1, 1) mesh; the parent then runs the same step
   for real, and the traced FLOPs must be within 1% of
   ``FlopCounterMode`` over it, the argument bytes equal to its
   parameter, moment and batch bytes, and argument + temp within 1% of
   ``torch.cuda.max_memory_allocated()`` but not within 1% with one
   decoder layer's parameters, moments and gradients left out; its
   bound is printed beside the measured ms a step.  Writes
   ``chip_smoke_out/dryrun.json`` (the records) and
   ``dryrun_report.json``.

``--lm-sharded`` runs 13b (cut to 14a's steps, its reference) and phase
14 alone, with no kernel build, and writes
``chip_smoke_out/lm_sharded.json``.

``--profile`` also traces one replayed lane round's relax phase (K3 and
K4 host-plan launches) with ``torch.profiler`` and prints its device
time by operator.

``--plan-timing`` runs none of the phases: it times, on the RMAT-18
partition, the launch plan's build (``plan_launch`` as the engine calls
it, and, where the package builds them apart, the tables a plan's first
piece launch adds, K1's and K9's), the device arrays' upload and the
BFS/SSSP fixpoints under ``pallas_mode`` 'fused' and 'reduce' (whole,
and their rounds alone on built arrays), with the ``repro_torch`` under
``SRC`` (this checkout's
``src`` by default; another checkout's, to set two versions side by
side), and prints them as one JSON line.

``--fold-sweep`` runs none of the phases either: it builds variants of
the laned fold (``FOLD_SWEEP``: the window, the gathers in flight, the
blocks an SM, full-warp lists at Q = 16) and times K3 with each on the
RMAT-18 Q = 16 rounds, held to the kept build bit for bit.

Any failure raises and the script exits non-zero.  It imports nothing of
JAX or of the JAX package.  The last lines are the ``kernels`` JSON and
``{"ok": true, "device": {...}}``; per-round timings go to
``chip_smoke_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chip_smoke_out" / "chip_smoke.json"
GATE = ROOT / "benchmarks" / "baselines" / "counter_gate.json"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
RMAT_SCALE, EDGE_FACTOR, SEED, SHARDS, RPVO_MAX = 18, 16, 7, 16, 4
TIMING_REPS = 20
PROFILE = "--profile" in sys.argv[1:]
PLAN_REPS = 10                    # timing reps of --plan-timing
PR_ITERS = 30            # dense PageRank rounds
PR_TOL = 5e-10           # delta-PageRank residual tolerance at RMAT-18
PR_RTOL, PR_ATOL = 1e-4, 1e-7
# the sources: K1/K2, K3/K4, K9, K5/K6 and K7/K8
KERNELS = ("fused_relax_reduce_wl", "fused_relax_reduce_wl_lanes",
           "segment_combine", "fused_relax_reduce_wl_tiled",
           "fused_relax_reduce_wl_tiled_lanes")
LANES = 16               # the lane slice's batch: 8 BFS + 8 SSSP queries
PPR_SEEDS = 8            # personalized-PageRank lanes
PPR_DAMPINGS = (0.85, 0.7, 0.6, 0.5)
PPR_DELTA_TOL = 1e-10    # delta-PPR residual tolerance at RMAT-18
TILED_BUDGET = 512 * 2**10        # under the RMAT-18 table's 1,068,032 B
TILED_LANE_BUDGET = 8 * 2**20     # under the Q = 16 table's 17,088,512 B
TILED_REPS = 3                    # timing reps of the tiled kernels
TRACE_MARGIN_S = 0.05             # idle host time around traced launches


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
    n = models = 0
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
                    models += _k1_orders(torch, np, frr, args, case, nseg,
                                         relax, kind, where,
                                         model=e < 8 * frr.EBLK)
                    n += 1
    log(f"[kernel] {n} cases x (K1, K2 host plan, K2 device plan): min "
        f"bit-equal, sum max_abs_err K1 {errs['K1']:.3g} K2 "
        f"{errs['K2']:.3g} (rtol 1e-5) and bit-repeatable, counts and "
        "executed cells equal the host mirror / the planner; K2 on flags "
        "listing K1's cells equals K1 bit for bit, K1 one piece a block "
        f"equals K1 in pieces (min bit for bit, sum rtol 1e-5); {models} "
        "cases equal the K1 order model bit for bit, in pieces and one "
        "piece a block")
    return errs


def bits(np, x):
    """The float32 bit patterns of a tensor or array."""
    a = x.detach().cpu().numpy() if hasattr(x, "detach") else x
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _k1_orders(torch, np, frr, args, case, nseg, relax, kind, where,
               model=True):
    """K1 (dense, at PIECE_CELLS) against K2 on flags listing exactly its
    cells (bit for bit: the flags path against the chunk-bit path), and
    against K1 one piece a block (min bit for bit, sum within rtol 1e-5);
    with ``model``, both against the K1 order model bit for bit, sum
    included.  Returns 1 if it checked the order model, else 0."""
    from repro_torch.kernels.ref import fused_relax_reduce_order
    identity = math.inf if kind == "min" else 0.0
    src, w, mask, ids = args[2:]
    plan = frr.plan_launch(src, mask, ids, nseg, args[0].shape[0])
    gval_m = frr._masked_value_tables(args[0], args[1], identity)
    chunk_act, _ = frr._chunk_tables(src, mask, args[1])
    k1 = frr._launch(gval_m, src, w, mask, ids, plan, chunk_act, relax,
                     kind, False)[0]
    k2 = frr._launch_wl(gval_m, src, w, mask, ids, plan, chunk_act,
                        frr.device_flags(plan, chunk_act), relax, kind,
                        False)[0]
    whole = _one_piece(frr, lambda: frr._launch(
        gval_m, src, w, mask, ids, plan, chunk_act, relax, kind, False)[0])
    torch.cuda.synchronize()
    check(torch.equal(k1, k2), f"K2 on K1's cells differs from K1: {where}")
    _check_out(torch, whole, k1, kind, f"K1 one piece a block: {where}")
    if not model:
        return 0
    for cells, out in ((frr.PIECE_CELLS, k1), (WHOLE_BLOCKS, whole)):
        want, _ = fused_relax_reduce_order(*case, nseg, relax, kind, cells)
        check(np.array_equal(bits(np, out), bits(np, want)),
              f"K1 differs from its order model at {cells} cells a piece: "
              f"{where}")
    return 1


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


def _gate_graph(np, gate):
    """The gate's weighted RMAT graph, its partition and root."""
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators
    gg = gate["graph"]
    g = generators.rmat(gg["scale"], edge_factor=gg["edge_factor"],
                        seed=gg["seed"])
    gw = g.with_random_weights(seed=gg["seed"])
    part = build_partition(gw, PartitionConfig(num_shards=4, rpvo_max=4))
    return g, gw, part, int(np.argmax(g.out_degrees()))


def stream_gate_legs(np, dev, gate):
    """The gate's streaming schedule (``benchmarks/counter_gate.py``)
    through the port on ``dev``: BFS and SSSP tracked by a
    ``StreamingGraph`` (K1, dense), two commits of 16 random inserts, the
    second with 8 deletes.  Returns the six ``stream_*`` legs."""
    from repro_torch import obs
    from repro_torch.core import engine
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.core.streaming import StreamingGraph
    _, gw, _, root = _gate_graph(np, gate)
    sg = StreamingGraph(gw, PartitionConfig(num_shards=4, rpvo_max=4),
                        cfg=engine.EngineConfig(use_pallas=True),
                        device=dev)
    sg.track("bfs", root)
    sg.track("sssp", root)
    rng = np.random.default_rng(gate["graph"]["seed"])
    out = {}
    with obs.recording() as rec:
        for batch in range(2):
            s = rng.integers(0, gw.n, 16).astype(np.int32)
            d = rng.integers(0, gw.n, 16).astype(np.int32)
            w = rng.integers(1, 10, 16).astype(np.float32)
            sg.insert_edges(s, d, w)
            if batch == 1:
                idx = rng.choice(sg.g.num_edges, 8, replace=False)
                sg.delete_edges(sg.g.src[idx], sg.g.dst[idx])
            info = sg.commit()
            for name in ("bfs", "sssp"):
                row = _gate_totals(rec.rounds, name)
                ms = info.maint[(name, root)]
                row.update(maint_messages=ms.messages, seeds=ms.seeds,
                           invalidated=ms.invalidated)
                out[f"stream_{name}_batch{batch}"] = row
            sp = info.splices["base"]
            out[f"stream_splice_batch{batch}"] = {
                "shards_rebuilt": sp.shards_rebuilt,
                "replicas_added": sp.replicas_added,
                "replicas_moved": sp.replicas_moved,
                "affected_edges": sp.affected_edges}
            rec.rounds.clear()
    return out


def resilient_gate_leg(np, dev, gate):
    """The gate's kill-and-restore leg through the port on ``dev``: SSSP
    (K1, dense) under ``run_resilient`` with ``checkpoint_every=2``, a
    shard killed at round 3 and restored through a ``CheckpointManager``
    in a temporary directory; totals against an uninterrupted run."""
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import actions, engine
    from repro_torch.core.resilient import StackedTask, run_resilient
    from repro_torch.runtime.chaos import ChaosEvent, ChaosPlan
    _, _, part, root = _gate_graph(np, gate)
    init = engine.init_values(part, actions.SSSP, {root: 0.0})
    base_val, base = engine.run_stacked(
        actions.SSSP, part, init, engine.EngineConfig(use_pallas=True),
        device=dev)
    plan = ChaosPlan(events=(ChaosEvent(round=3, kind="kill_shard",
                                        shard=1),))
    with tempfile.TemporaryDirectory() as d:
        got, stats, report = run_resilient(
            StackedTask(actions.SSSP, part, init,
                        engine.EngineConfig(use_pallas=True,
                                            checkpoint_every=2),
                        device=dev),
            chaos=plan, manager=CheckpointManager(d))
    totals = [int(x) for x in (stats.iterations, stats.messages,
                               stats.work_actions)]
    return {"resilient_kill_restore": {
        "status": report.status, "faults": len(report.faults),
        "restores": report.restores, "rounds_lost": report.rounds_lost,
        "checkpoints_written": report.checkpoints_written,
        "rounds": totals[0], "messages": totals[1], "work": totals[2],
        "equal_uninterrupted": bool(
            totals == [int(x) for x in (base.iterations, base.messages,
                                        base.work_actions)]
            and torch.equal(got, base_val))}}


def phase_counter_gate(np, dev):
    from repro_torch import obs
    from repro_torch.apps.pagerank import _pr_graph
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    gate = json.loads(GATE.read_text())
    g, _, part, root = _gate_graph(np, gate)
    part_pr = build_partition(_pr_graph(g), PartitionConfig(
        num_shards=4, rpvo_max=4))
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
    t0 = time.perf_counter()
    legs = stream_gate_legs(np, dev, gate)
    legs.update(resilient_gate_leg(np, dev, gate))
    for leg, got in legs.items():
        want = gate["runs"][leg]
        for f, v in got.items():
            check(v == want[f],
                  f"counter gate {leg}.{f}: {v} != {want[f]}")
    log(f"[gate] {', '.join(legs)}: every field equal to "
        f"counter_gate.json (stream_bfs_batch0: "
        f"{legs['stream_bfs_batch0']['messages']} messages, "
        f"{legs['stream_bfs_batch0']['seeds']} seeds; "
        f"resilient_kill_restore: {legs['resilient_kill_restore']}) "
        f"in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 4: the slice-1 path at RMAT-18
# --------------------------------------------------------------------------

def _round_bound_ms(part, relax_kind, n_active, nseg=None):
    """Least time for one round's fused relax+reduce: every valid edge's
    source id and mask must be read to find the active edges, each active
    edge's destination id (and weight, unless the relax ignores it), the
    value table and frontier once, and the ``nseg``-segment inbox
    (default S*R_max, the dense exchange's) written once; the arithmetic
    (a relax and a combine per active edge) is far below the float32
    rate.  Returns (ms, "bytes" | "operations")."""
    e = part.S * part.E_max
    v = part.S * part.R_max
    nseg = v if nseg is None else nseg
    per_active = 4 + (0 if relax_kind == "add_one" else 4)
    nbytes = e * (4 + 1) + n_active * per_active + v * (4 + 1) + nseg * 4 \
        + 4
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


PIECE_SWEEP = (4, 8, 16, 32)     # cells a piece, timed on the heaviest rounds
WHOLE_BLOCKS = 1 << 30           # cells a piece: every block one piece


def _with_pieces(frr, cells, fn):
    """``fn()`` with the worklist launches' pieces at ``cells`` cells."""
    old = frr.PIECE_CELLS
    frr.PIECE_CELLS = cells
    try:
        return fn()
    finally:
        frr.PIECE_CELLS = old


def _one_piece(frr, fn):
    """``fn()`` with every segment block one piece: no launch then
    combines pieces through the split buffer."""
    return _with_pieces(frr, WHOLE_BLOCKS, fn)


def _piece_sweep(torch, frr, launch):
    """Device ms of ``launch(flags)`` (a host plan's flags, or None for
    the device plan; ``launch`` closes over the rest) at each piece size
    of ``PIECE_SWEEP``: {cells: {"host": ms, "device": ms}}."""
    return {p: {plan: _with_pieces(frr, p, lambda: time_ms(
        torch, lambda: launch(plan == "host")))
        for plan in ("host", "device")} for p in PIECE_SWEEP}


def _sweep_text(sweep):
    return ", ".join(f"P={p} {v['host']:.4f}/{v['device']:.4f}"
                     for p, v in sweep.items())


def _piece_stats(frr, plan):
    """The kept cut of ``plan``: the heaviest block's planned cells and a
    histogram of blocks by their piece count."""
    pc = frr.plan_pieces(plan)
    cells = (plan.blk_ptr[1:] - plan.blk_ptr[:-1]).cpu()
    npc = (pc.blk_piece[1:] - pc.blk_piece[:-1]).cpu()
    edges = (1, 2, 4, 8, 16, 32, 64, 1 << 30)
    hist, lo = {}, 1
    for hi in edges:
        n = int(((npc >= lo) & (npc <= hi)).sum())
        if n:
            hist[f"{lo}" if lo == hi else f"{lo}-{hi}"] = n
        lo = hi + 1
    return {"cells_per_piece": pc.cells,
            "pieces": int((pc.piece_blk >= 0).sum()), "grid": pc.num_pieces,
            "split_rows": int((pc.piece_slot >= 0).sum()),
            "blocks": plan.num_blocks,
            "planned_cells": plan.num_cells,
            "heaviest_block_cells": int(cells.max()),
            "blocks_by_pieces": hist, "combine": "ticket"}


def _launch_count(torch, fn):
    """What one call of ``fn`` puts on the card, by ``torch.profiler``:
    {"kernels": n, "copies": n, "names": [...]} (memcpy and memset
    events are copies).  The profiler records the third of three calls,
    after one skipped and one warm-up step (a trace that starts with the
    call can miss its first kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    copies = [n for n in names if n.startswith(("Memcpy", "Memset"))]
    return {"kernels": len(names) - len(copies), "copies": len(copies),
            "names": names}


def _replay_rounds(torch, np, dev, app, sem, part, arrays, planner, state,
                   tables, step, worklists=True):
    """Replay one fixpoint round by round: ``tables(state)`` gives the
    round's (gval, gchg), ``step(state, wl)`` the next state.  With
    ``worklists`` each round is planned on the host, K2 (host and device
    plans) is checked against its plain version, the planner and, one
    piece a block, against K1 bit for bit, and the relax phase and K2
    alone are timed beside K1 on the same round; without, the round
    times K1's relax phase (dense PageRank).  Returns (rows, K2 err, the
    heaviest worklist round's launch arguments)."""
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
    rows, err, rnd, best = [], 0.0, 0, None
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
            flags = frr._card_flags(wl, plan, nseg)
            out, dbg = frr._launch_wl(gval_m, src, w, mask, ids, plan,
                                      chunk_act, flags, rk, kind, True)
            out_d, dbg_d = frr._launch_wl(gval_m, src, w, mask, ids, plan,
                                          chunk_act, None, rk, kind, True)
            out1, _ = frr._launch(gval_m, src, w, mask, ids, plan,
                                  chunk_act, rk, kind, False)
            # K2 on flags listing exactly K1's cells, and K1 one piece a
            # block
            out_f, _ = frr._launch_wl(gval_m, src, w, mask, ids, plan,
                                      chunk_act,
                                      frr.device_flags(plan, chunk_act), rk,
                                      kind, False)
            whole = _one_piece(frr, lambda: frr._launch(
                gval_m, src, w, mask, ids, plan, chunk_act, rk, kind,
                False)[0])

            def plain():
                return fused_relax_reduce_wl_ref(
                    gval, gchg, src, w, mask, ids, wl_dev.wl_i, wl_dev.wl_j,
                    wl_dev.nlive, nseg, rk, kind)

            want = plain()
            torch.cuda.synchronize()
            at = f"{app} round {rnd} K2"
            err = max(err, _check_out(torch, out, want, kind, at))
            err = max(err, _check_out(torch, out_d, want, kind,
                                      at + " device plan"))
            check(torch.equal(out_f, out1),
                  f"{at}: K2 on K1's cells differs from K1 bit for bit")
            _check_out(torch, whole, out1, kind,
                       f"{at}: K1 one piece a block against K1 in pieces")
            check(int(dbg[0]) == info.cells,
                  f"{at}: executed {int(dbg[0])} cells, planned {info.cells}")
            check(int(dbg_d[0]) == info.dense_live,
                  f"{at}: device plan executed {int(dbg_d[0])} cells, the "
                  f"dense launch {info.dense_live}")
            row.update(
                cells=info.cells, dense_cells=info.dense_live,
                launched=info.launched,
                kernel_ms=time_ms(torch, lambda: frr._launch_wl(
                    gval_m, src, w, mask, ids, plan, chunk_act, flags, rk,
                    kind, False)),
                device_kernel_ms=time_ms(torch, lambda: frr._launch_wl(
                    gval_m, src, w, mask, ids, plan, chunk_act, None, rk,
                    kind, False)),
                ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                    gval, gchg, src, w, mask, ids, nseg, rk, kind,
                    plan=plan, worklist=wl)),
                device_ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                    gval, gchg, src, w, mask, ids, nseg, rk, kind,
                    plan=plan, grid_mode="device_worklist")),
                plain_ms=time_ms(torch, plain, reps=3))
            if best is None or n_active > best["active_edges"]:
                best = {"app": app, "round": rnd, "active_edges": n_active,
                        "launch": (gval_m, src, w, mask, ids, plan,
                                   chunk_act, flags, rk, kind),
                        "relax": (gval, gchg, src, w, mask, ids, nseg, rk,
                                  kind),
                        "wl": wl}
        rows.append(row)
        state = step(state, wl)
    return rows, err, best


def phase_slice2(torch, np, dev, g, part, root, want):
    from repro_torch import apps, exchange, obs
    from repro_torch.kernels import ops
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
    err, heavy_wl = 0.0, None
    for sem in (actions.BFS, actions.SSSP):
        v0 = torch.as_tensor(engine.init_values(part, sem, {root: 0.0}),
                             device=dev)
        c0 = sem.improved(v0, torch.full_like(v0, sem.identity)) \
            & arrays.slot_valid
        rows, e, best = _replay_rounds(
            torch, np, dev, sem.name, sem, part, arrays, planner, (v0, c0),
            lambda st: (st[0].reshape(-1), st[1].reshape(-1)),
            lambda st, wl, sem=sem: exchange.fixpoint_round_stacked(
                sem, arrays, wl_cfg, part.S, part.R_max, *st,
                worklist=wl)[:2])
        check(len(rows) == report["runs"][f"{sem.name}_worklist"]["rounds"],
              f"{sem.name} replay round count")
        report["per_round"] += rows
        err = max(err, e)
        if heavy_wl is None \
                or best["active_edges"] > heavy_wl["active_edges"]:
            heavy_wl = best
    arrays_pr = engine.DeviceArrays.from_partition(part_pr, dev)
    planner_pr = engine.launch_planner(part_pr, wl_cfg)
    pr = actions.PAGERANK
    tol_t = engine._tol_table(part_pr, PR_TOL, dev)
    base = (1.0 - 0.85) / part_pr.n
    d0 = torch.where(arrays_pr.slot_valid, base, 0.0)

    def pr_tables(st):
        return (st[1].reshape(-1),
                ((st[1].abs() > tol_t) & arrays_pr.slot_valid).reshape(-1))

    rows, e, best = _replay_rounds(
        torch, np, dev, "pagerank_delta", pr, part_pr, arrays_pr, planner_pr,
        (d0, d0), pr_tables,
        lambda st, wl: exchange.delta_pagerank_round_stacked(
            pr, arrays_pr, wl_cfg, part_pr.S, part_pr.R_max, 0.85, tol_t,
            *st, worklist=wl)[:2])
    report["per_round"] += rows
    err = max(err, e)
    if best["active_edges"] > heavy_wl["active_edges"]:
        heavy_wl = best
    val = torch.where(arrays_pr.slot_valid, 1.0 / part_pr.n, 0.0)
    rows, _, _ = _replay_rounds(
        torch, np, dev, "pagerank", pr, part_pr, arrays_pr, None,
        (val, arrays_pr.slot_valid),
        lambda st: (st[0].reshape(-1), st[1].reshape(-1)),
        lambda st, wl: (st[0], torch.zeros_like(st[1])), worklists=False)
    report["pagerank_round"] = rows[0]

    # the heaviest worklist round: K2 at each piece size, and the kernels
    # each relax phase puts on the card
    args, relax = heavy_wl["launch"], heavy_wl["relax"]
    plan_h = args[5]
    report["pieces"] = _piece_stats(frr, plan_h)
    report["piece_sweep"] = _piece_sweep(
        torch, frr, lambda host: frr._launch_wl(
            *args[:7], args[7] if host else None, *args[8:], False))
    report["relax_launches"] = {
        "K1": _launch_count(torch, lambda: ops.fused_relax_reduce(
            *relax, plan=plan_h)),
        "K2_host_plan": _launch_count(torch, lambda: ops.fused_relax_reduce(
            *relax, plan=plan_h, worklist=heavy_wl["wl"])),
        "K2_device_plan": _launch_count(
            torch, lambda: ops.fused_relax_reduce(
                *relax, plan=plan_h, grid_mode="device_worklist"))}
    wl_rows = [r for r in report["per_round"] if "cells" in r]
    keys = ("plan_ms", "kernel_ms", "device_kernel_ms", "ms", "device_ms",
            "k1_ms", "plain_ms", "library_ms", "bound_ms")
    report["median"] = {k: statistics.median(r[k] for r in wl_rows)
                        for k in keys}
    report["heaviest"] = max(wl_rows, key=lambda r: r["active_edges"])
    med, heavy = report["median"], report["heaviest"]
    log(f"[slice2] per worklist round, median of {len(wl_rows)} rounds: "
        f"planner {med['plan_ms']:.2f} ms (host), K2 "
        f"{med['kernel_ms']:.4f} ms (device plan "
        f"{med['device_kernel_ms']:.4f} ms), relax phase {med['ms']:.4f} ms "
        f"(device plan {med['device_ms']:.4f} ms), K1 {med['k1_ms']:.4f} "
        f"ms, plain {med['plain_ms']:.4f} ms, library "
        f"{med['library_ms']:.4f} ms, bound {med['bound_ms']:.4f} ms")
    log(f"[slice2] heaviest worklist round ({heavy['app']} round "
        f"{heavy['round']}, {heavy['active_edges']} active edges, "
        f"{heavy['cells']} cells): planner {heavy['plan_ms']:.2f} ms, K2 "
        f"{heavy['kernel_ms']:.4f} ms (device plan "
        f"{heavy['device_kernel_ms']:.4f} ms), relax phase "
        f"{heavy['ms']:.4f} ms (device plan {heavy['device_ms']:.4f} ms), "
        f"K1 {heavy['k1_ms']:.4f} ms, plain {heavy['plain_ms']:.4f} ms, "
        f"library {heavy['library_ms']:.4f} ms, bound "
        f"{heavy['bound_ms']:.4f} ms")
    ps, rl = report["pieces"], report["relax_launches"]
    log(f"[pieces] P={ps['cells_per_piece']} cells a piece, combine "
        f"{ps['combine']} (kept): {ps['pieces']} pieces (grid "
        f"{ps['grid']}) over "
        f"{ps['blocks']} blocks and {ps['planned_cells']} planned cells, "
        f"{ps['split_rows']} split rows, heaviest block "
        f"{ps['heaviest_block_cells']} cells, blocks by pieces "
        f"{ps['blocks_by_pieces']}; K2 on the heaviest round "
        f"(host/device plan ms): {_sweep_text(report['piece_sweep'])}")
    log("[pieces] kernels (+ copies) a relax phase puts on the card, by "
        "torch.profiler: " + ", ".join(
            f"{k} {v['kernels']} (+{v['copies']})" for k, v in rl.items()))
    prr = report["pagerank_round"]
    log(f"[slice2] dense PageRank round (K1 mul_w/sum, "
        f"{prr['active_edges']} active edges): relax phase {prr['ms']:.4f} "
        f"ms, K1 {prr['k1_ms']:.4f} ms, plain {prr['plain_ms']:.4f} ms, "
        f"index_add_ {prr['library_ms']:.4f} ms, bound "
        f"{prr['bound_ms']:.4f} ms")
    return launches, err, report, part_pr, want_pr, want_conv


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
        segment_combine_order, segment_combine_ref)
    shapes = [(17, 7, 3), (1000, 5 * frr.EBLK + 13, 2 * frr.SBLK + 5),
              (30011, 97 * frr.EBLK + 311, 20011)]
    errs = {"K3": 0.0, "K4": 0.0, "K9": 0.0}
    n = models = 0
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
                    models += _k3_orders(torch, np, frr, args, case, nseg,
                                         relax, kind, where,
                                         model=e < 8 * frr.EBLK)
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
                    check(dbg.tolist() == rsr.launch_counts(
                        rsr.plan_segments(i, nseg), i).tolist(),
                          f"K9 pieces and edges loaded: {at}")
                    # the order model, at the kept cut and one piece a block
                    for cut in (rsr.PIECE_CELLS, WHOLE_BLOCKS):
                        got = _k9_cut(rsr, cut, lambda: rsr.segment_combine(
                            d, i, nseg, kind))
                        model, _ = segment_combine_order(d, i, nseg, kind,
                                                         cut)
                        check(_k9_bits(torch, got, model),
                              f"K9 differs from its order model at "
                              f"{cut} cells a piece: {at}")
                    m += 1
    log(f"[lanes] {n} laned cases x (K3, K4 host plan, K4 device plan), "
        f"Q in 1/5/16/33: min bit-equal, sum max_abs_err K3 "
        f"{errs['K3']:.3g} K4 {errs['K4']:.3g} (rtol 1e-5) and "
        "bit-repeatable, per-lane counts and executed cells equal the "
        "host mirror / the planner; K4 on flags listing K3's cells equals "
        "K3 bit for bit, K3 one piece a block equals K3 in pieces (min bit "
        f"for bit, sum rtol 1e-5); {models} cases equal the K3 order model "
        "bit for bit, in pieces and one piece a block; "
        f"{m} K9 cases (float32 max_abs_err "
        f"{errs['K9']:.3g}, bfloat16 at bf16 resolution), repeatable, "
        f"equal to the K9 order model bit for bit at {rsr.PIECE_CELLS} "
        "cells a piece and one piece a block")
    return errs


def _k9_cut(rsr, cells, fn):
    """``fn()`` with K9's pieces at ``cells`` cells."""
    old = rsr.PIECE_CELLS
    rsr.PIECE_CELLS = cells
    try:
        return fn()
    finally:
        rsr.PIECE_CELLS = old


def _k9_bits(torch, got, model):
    """K9's output equals its order model's float32 result rounded once
    to the output's dtype, bit for bit."""
    return torch.equal(got.cpu(), torch.from_numpy(model).to(got.dtype))


def _k3_orders(torch, np, frr, args, case, nseg, relax, kind, where,
               model=True):
    """K3 (dense, at PIECE_CELLS) against K4 on flags listing exactly its
    cells (bit for bit) and against K3 one piece a block (min bit for
    bit, sum within rtol 1e-5); with ``model``, both against the K3
    order model bit for bit, sum included.  Returns 1 if it checked the
    order model, else 0."""
    from repro_torch.kernels.ref import fused_relax_reduce_lanes_order
    identity = math.inf if kind == "min" else 0.0
    gval, gchg, unitw, src, w, mask, ids = args
    q = gval.shape[1]
    unit_u8 = (unitw != 0).to(torch.uint8)
    plan = frr.plan_launch(src, mask, ids, nseg, gval.shape[0])
    gval_m = frr._masked_value_tables(gval, gchg, identity)
    chunk_act, _ = frr._lane_chunk_tables(src, mask, gchg, plan.src_deg)

    def k3():
        return frr._launch_lanes(gval_m, unit_u8, src, w, mask, ids, plan,
                                 chunk_act, relax, kind, False)[0]

    out = k3()
    k4 = frr._launch_wl_lanes(gval_m, unit_u8, src, w, mask, ids, plan,
                              chunk_act, frr.device_flags(plan, chunk_act),
                              relax, kind, False)[0]
    whole = _one_piece(frr, k3)
    torch.cuda.synchronize()
    check(torch.equal(out, k4), f"K4 on K3's cells differs from K3: {where}")
    _check_out(torch, whole, out, kind, f"K3 one piece a block: {where}")
    if not model:
        return 0
    for cells, got in ((frr.PIECE_CELLS, out), (WHOLE_BLOCKS, whole)):
        want, _ = fused_relax_reduce_lanes_order(
            *case, nseg, relax, kind, cells, frr._halves(q))
        check(np.array_equal(bits(np, got), bits(np, want)),
              f"K3 differs from its order model at {cells} cells a piece: "
              f"{where}")
    return 1


def _lane_round_bound_ms(part, n_active_edges, n_active_pairs, q,
                         nseg=None):
    """Least time for one laned round's fused relax+reduce: every edge's
    source id and mask read to find the active edges, each edge active in
    some lane's destination id and weight, the (V, Q) value table and
    frontier once, the (nseg, Q) inbox (default nseg = S*R_max) and (Q,)
    counts written once; a relax and a combine per active (edge, lane)
    pair at the float32 rate.  Returns (ms, "bytes" | "operations")."""
    e = part.S * part.E_max
    v = part.S * part.R_max
    nseg = v if nseg is None else nseg
    nbytes = e * (4 + 1) + n_active_edges * (4 + 4) + v * q * (4 + 1) \
        + nseg * q * 4 + q * 4
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
    from repro_torch.kernels import fused_relax_reduce as frr
    init, unitw = lanes.init_lane_values(part, queries)
    val = torch.as_tensor(init, device=dev)
    unitw = torch.as_tensor(unitw, device=dev)
    unit_u8 = (unitw != 0).to(torch.uint8)
    chg = (val < math.inf) & arrays.slot_valid[..., None]
    cfg = engine.EngineConfig(use_pallas=True)
    plan = arrays.fused_plan
    edges = (arrays.edge_src_root_flat.reshape(-1),
             arrays.edge_w.reshape(-1), arrays.edge_mask.reshape(-1),
             arrays.edge_dst_flat.reshape(-1))
    best, rnd, k3_ms = None, 0, []
    while bool(chg.any()):
        rnd += 1
        gval = val.reshape(-1, val.shape[-1])
        gchg = chg.reshape(-1, chg.shape[-1])
        gval_m = frr._masked_value_tables(gval, gchg, math.inf)
        chunk_act, _ = frr._lane_chunk_tables(edges[0], edges[2], gchg,
                                              plan.src_deg)
        k3_ms.append(time_ms(torch, lambda: frr._launch_lanes(
            gval_m, unit_u8, *edges, plan, chunk_act, "add_w", "min",
            False), reps=5))
        nval, nchg, counts = exchange.fixpoint_round_stacked(
            actions.SSSP, arrays, cfg, part.S, part.R_max, val, chg, unitw)
        pairs = int(counts.sum())
        if best is None or pairs > best[0]:
            best = (pairs, rnd, gval.clone(), gchg.clone())
        val, chg = nval, nchg
    _, at, gval, gchg = best
    return gval, gchg, unitw, at, rnd, k3_ms


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
    gval, gchg, unitw, rnd, rounds, k3_ms = _heaviest_lane_round(
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
    k3["round_sum_ms"] = sum(k3_ms)
    k3["blocks_per_sm"] = {"K3/K4": frr.lane_blocks_per_sm(q),
                           "K7/K8": frr.lane_blocks_per_sm(q, tiled=True)}
    k3["hub"] = _hub_piece(np, frr, plan, mask, ids, chunk_act, q)
    if PROFILE:
        _profile(torch, "K3 relax phase", lambda: ops.fused_relax_reduce_lanes(
            gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min",
            plan=plan))

    t0 = time.perf_counter()
    wl, info = planner.plan(gchg_h.any(axis=1))
    plan_ms = 1e3 * (time.perf_counter() - t0)
    wl_dev = wl.to(dev)
    flags = frr._card_flags(wl, plan, nseg)

    def launch4(flags, debug=False):
        return frr._launch_wl_lanes(gval_m, unit_u8, src, w, mask, ids, plan,
                                    chunk_act, flags, "add_w", "min", debug)

    out4, dbg4 = launch4(flags, True)
    out4d, dbg4d = launch4(None, True)
    # K4 on flags listing exactly K3's cells, and K3 one piece a block
    out4f, _ = launch4(frr.device_flags(plan, chunk_act))
    whole = _one_piece(frr, lambda: frr._launch_lanes(
        gval_m, unit_u8, src, w, mask, ids, plan, chunk_act, "add_w", "min",
        False)[0])
    plain4 = fused_relax_reduce_wl_lanes_ref(
        gval, gchg, unitw, src, w, mask, ids, wl_dev.wl_i, wl_dev.wl_j,
        wl_dev.nlive, nseg, "add_w", "min")
    torch.cuda.synchronize()
    check(torch.equal(out4, plain4) and torch.equal(out4, plain)
          and torch.equal(out4d, plain),
          f"K4 round {rnd}: differs from plain")
    check(torch.equal(out4f, out), f"K4 round {rnd}: K4 on K3's cells "
          "differs from K3 bit for bit")
    check(torch.equal(whole, out), f"K3 round {rnd}: one piece a block "
          "differs from K3 in pieces (min)")
    check(int(dbg4[0]) == info.cells
          and int(dbg4d[0]) == mirror["fused_live"],
          f"K4 round {rnd}: cells {int(dbg4[0])} (device plan "
          f"{int(dbg4d[0])})")
    if PROFILE:
        _profile(torch, "K4 relax phase (host plan)",
                 lambda: ops.fused_relax_reduce_lanes(
                     gval, gchg, unitw, src, w, mask, ids, nseg, "add_w",
                     "min", plan=plan, worklist=wl))
    relax = (gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min")
    k4 = dict(common, cells=info.cells, launched=info.launched,
              device_cells=int(dbg4d[0]), plan_ms=plan_ms,
              split_bytes=frr.plan_pieces(plan).n_split * frr.SBLK * q * 4,
              kernel_ms=time_ms(torch, lambda: launch4(flags)),
              device_kernel_ms=time_ms(torch, lambda: launch4(None)),
              piece_sweep=_piece_sweep(
                  torch, frr, lambda host: launch4(flags if host else None)),
              relax_launches={
                  "K3": _launch_count(torch, lambda: (
                      ops.fused_relax_reduce_lanes(*relax, plan=plan))),
                  "K4_host_plan": _launch_count(torch, lambda: (
                      ops.fused_relax_reduce_lanes(*relax, plan=plan,
                                                   worklist=wl))),
                  "K4_device_plan": _launch_count(torch, lambda: (
                      ops.fused_relax_reduce_lanes(
                          *relax, plan=plan, grid_mode="device_worklist")))},
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


def _hub_piece(np, frr, plan, mask, ids, chunk_act, q):
    """The heaviest piece of a laned round: the piece whose run cells
    hold the most edges of their block, with its edge count, its runs
    (the (cell, window, list, segment) partials the laned fold writes)
    and its cells, and the same for the median piece."""
    from repro_torch.kernels.ref import NWARP, WINDOW
    mask_h, ids_h = mask.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
    act_h = chunk_act.cpu().numpy()
    n_chunks = act_h.shape[0]
    e = np.nonzero(mask_h)[0]
    j = e // frr.EBLK
    e, j = e[act_h[j]], j[act_h[j]]
    i = ids_h[e] // frr.SBLK
    blk_ptr = plan.blk_ptr.cpu().numpy().astype(np.int64)
    keys = np.repeat(np.arange(blk_ptr.shape[0] - 1), np.diff(blk_ptr)) \
        * n_chunks + plan.blk_chunk.cpu().numpy()
    cell = np.searchsorted(keys, i * n_chunks + j)
    pc = frr.plan_pieces(plan)
    piece = np.searchsorted(pc.piece_ptr.cpu().numpy()[1:], cell,
                            side="right")
    per = np.bincount(piece)
    k = int(np.argmax(per))
    lists = frr._halves(q) * NWARP
    pos = e % frr.EBLK
    run = ((cell * (frr.EBLK // WINDOW) + pos // WINDOW) * lists
           + pos % WINDOW // (WINDOW // lists)) * frr.SBLK + ids_h[e] \
        % frr.SBLK
    sel = piece == k
    ptr = pc.piece_ptr.cpu().numpy()
    return {"piece": k, "edges": int(per[k]),
            "runs": int(np.unique(run[sel]).shape[0]),
            "cells": int(ptr[k + 1] - ptr[k]),
            "median_piece_edges": float(np.median(per[per > 0])),
            "lists_per_window": lists}


K9_SWEEP = (4, 8, 12, 16, 24, 32)  # K9's cells a piece, timed on its rounds


def _k9_raw(torch, frr, rsr, data, ids, plan, kind):
    """A call that launches K9 on ``data`` at the current cut
    with every argument made beforehand (no checks, no allocation, no
    count), for timing: its host cost, one ctypes call, is well under the
    kernel's, so back-to-back calls keep the card busy and ``time_ms``
    reads device time.  Raises if a launch fails."""
    dev = data.device
    pc = frr.plan_pieces(plan, rsr.PIECE_CELLS)
    out = torch.empty(plan.num_segments, dtype=data.dtype, device=dev)
    split = torch.empty((pc.n_split, frr.SBLK), dtype=torch.float32,
                        device=dev)
    args = (data.data_ptr(), ids.data_ptr(),
            *frr._piece_ptrs(plan, pc, None, None, plan.num_blocks, ids),
            data.shape[0], plan.num_segments, pc.num_pieces, out.data_ptr(),
            split.data_ptr(), None, frr._KIND_CODE[kind],
            rsr._DTYPE_CODE[data.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    fn = frr._kernel("segment_combine_launch")

    def call(keep=(out, split, pc)):
        check(fn(*args) == 0, "K9 launch failed")
    return call


def _k9_trace(torch, launch, reps=20):
    """K9's kernels in ``torch.profiler`` traces of ``reps`` calls of
    ``launch`` three ways, in this order: the trace started and given
    0.2 s before the calls (``settled``), started right before them
    (``bare``), and recorded in the third step of a wait/warm-up/active
    schedule, each step's launches ``TRACE_MARGIN_S`` inside its window
    on both sides (``scheduled``: the card's kernel records are stamped
    up to a few ms off the host's clock, and the trace drops those it
    places before its window; ``--trace-drops``, PERF.md §6).  Each:
    ``_trace_record`` and the mean device time (us) of its
    ``segment_combine_kernel`` events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def k9(prof):
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and "segment_combine_kernel" in e.name]
        return {**_trace_record(prof),
                "mean_us": statistics.fmean(us) if us else None}

    def calls():
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    out = {"reps": reps}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.2)
        calls()
    out["settled"] = k9(prof)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        calls()
    out["bare"] = k9(prof)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            time.sleep(TRACE_MARGIN_S)
            calls()
            time.sleep(TRACE_MARGIN_S)
            prof.step()
    out["scheduled"] = k9(prof)
    return out


def _segment_messages(torch, sem, arrays, val, chg):
    """The (E,) messages ``pallas_mode='reduce'`` hands K9 for one round:
    relaxed, with the identity where the edge is masked or its source is
    not in the frontier."""
    src = arrays.edge_src_root_flat.reshape(-1).long()
    gval, gchg = val.reshape(-1), chg.reshape(-1)
    active = arrays.edge_mask.reshape(-1) & gchg[src]
    msg = torch.where(active, sem.relax(gval[src],
                                        arrays.edge_w.reshape(-1)),
                      sem.identity)
    return msg, int(active.sum())


def _time_segment_kernel(torch, np, dev, part, arrays, root, part_pr):
    """Replay the ``pallas_mode='reduce'`` BFS and SSSP fixpoints and one
    dense PageRank round on ``part_pr`` (every round has the same active
    edges), hold K9 to its order model on the heaviest min round and the
    PageRank round bit for bit, and time it beside its plain version, its
    library call (``scatter_reduce_`` amin, ``index_add_``) and the bound;
    the ``[k9-cell]`` sweep times it at each piece size, summed
    over the 13 min rounds."""
    from repro_torch import exchange
    from repro_torch.core import actions, engine
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    from repro_torch.kernels.ref import (segment_combine_order,
                                         segment_combine_ref)
    cfg = engine.EngineConfig(use_pallas=True, pallas_mode="reduce")
    nseg = part.S * part.R_max
    plan = arrays.fused_plan
    mask = arrays.edge_mask.reshape(-1)
    ids = arrays.edge_dst_flat.reshape(-1)
    ids_long = ids.long()
    rounds = []
    for sem in (actions.BFS, actions.SSSP):
        val = torch.as_tensor(engine.init_values(part, sem, {root: 0.0}),
                              device=dev)
        chg = (val == 0) & arrays.slot_valid
        rnd = 0
        while bool(chg.any()):
            rnd += 1
            msg, n = _segment_messages(torch, sem, arrays, val, chg)
            rounds.append((n, sem.name, rnd, msg))
            val, chg, _ = exchange.fixpoint_round_stacked(
                sem, arrays, cfg, part.S, part.R_max, val, chg)
    n, app, rnd, msg = max(rounds, key=lambda r: r[0])
    t0 = time.perf_counter()
    model, walked = segment_combine_order(msg, ids, nseg, "min",
                                          rsr.PIECE_CELLS, edge_mask=mask)
    model_s = time.perf_counter() - t0
    out, dbg = rsr._launch(msg, ids, plan, "min", True)
    plain = segment_combine_ref(msg, ids, nseg, "min")
    torch.cuda.synchronize()
    check(torch.equal(out, plain), f"K9 {app} round {rnd}: differs")
    check(_k9_bits(torch, out, model),
          f"K9 {app} round {rnd}: differs from its order model")
    check(int(dbg[0]) == plan.num_cells == walked,
          f"K9 {app} round {rnd}: cells")
    check(dbg.tolist() == rsr.launch_counts(plan, ids).tolist(),
          f"K9 {app} round {rnd}: pieces and edges loaded")
    _, pieces, loaded = dbg.tolist()
    e = msg.shape[0]
    bound, bound_by = _segment_bound_ms(e, nseg)
    launch = lambda m=msg: rsr._launch(m, ids, plan, "min", False)  # noqa

    def raw(m=msg):
        return _k9_raw(torch, frr, rsr, m, ids, plan, "min")

    def raw_rounds():
        calls = [raw(m) for _, _, _, m in rounds]
        return lambda: [c() for c in calls]
    row = {"app": app, "round": rnd, "active_edges": n, "edges": e,
           "cells": plan.num_cells, "pieces": pieces,
           "cells_per_piece": rsr.PIECE_CELLS, "edges_loaded": loaded,
           "bound_ms": bound, "bound_by": bound_by,
           "model_s": model_s,
           "ms": time_ms(torch, lambda: ops.segment_combine(
               msg, ids, nseg, "min", plan=plan)),
           "kernel_ms": time_ms(torch, launch),
           "raw_ms": time_ms(torch, raw()),
           "round_sum_ms": time_ms(torch, raw_rounds()),
           "plain_ms": time_ms(torch, lambda: segment_combine_ref(
               msg, ids, nseg, "min"), reps=5),
           "library_ms": _library_ms(torch, "min", ids_long, msg, nseg),
           "trace": _k9_trace(torch, launch)}
    tr = row["trace"]["scheduled"]
    check(tr["kernels"] == row["trace"]["reps"],
          f"K9 {app} round {rnd}: a scheduled trace of "
          f"{row['trace']['reps']} launches saw {tr['kernels']} K9 kernels "
          f"(it holds {tr['launches']} launches, none recorded on the card "
          f"at launch-order positions {tr['missing']})")

    # the PageRank round: K9's sum form, held to the order model
    arrays_pr = engine.DeviceArrays.from_partition(part_pr, dev)
    pr = actions.PAGERANK
    val = torch.where(arrays_pr.slot_valid, 1.0 / part_pr.n, 0.0)
    msg_pr, n_pr = _segment_messages(torch, pr, arrays_pr, val,
                                     arrays_pr.slot_valid)
    plan_pr = arrays_pr.fused_plan
    mask_pr = arrays_pr.edge_mask.reshape(-1)
    ids_pr = arrays_pr.edge_dst_flat.reshape(-1)
    nseg_pr = part_pr.S * part_pr.R_max
    model_pr, _ = segment_combine_order(msg_pr, ids_pr, nseg_pr, "sum",
                                        rsr.PIECE_CELLS, edge_mask=mask_pr)
    out_pr = rsr._launch(msg_pr, ids_pr, plan_pr, "sum", False)[0]
    plain_pr = segment_combine_ref(msg_pr, ids_pr, nseg_pr, "sum")
    torch.cuda.synchronize()
    check(_k9_bits(torch, out_pr, model_pr),
          "K9 pagerank round: differs from its order model")
    check(torch.allclose(out_pr, plain_pr, rtol=1e-5, atol=1e-7),
          "K9 pagerank round: off its plain version")
    launch_pr = lambda: rsr._launch(msg_pr, ids_pr, plan_pr,  # noqa: E731
                                    "sum", False)
    bound_pr, by_pr = _segment_bound_ms(msg_pr.shape[0], nseg_pr)
    row_pr = {"active_edges": n_pr, "edges": msg_pr.shape[0],
              "cells": plan_pr.num_cells, "bound_ms": bound_pr,
              "bound_by": by_pr,
              "max_abs_err": max_abs_err(torch, out_pr, plain_pr),
              "ms": time_ms(torch, lambda: ops.segment_combine(
                  msg_pr, ids_pr, nseg_pr, "sum", plan=plan_pr)),
              "kernel_ms": time_ms(torch, launch_pr),
              "raw_ms": time_ms(torch, _k9_raw(
                  torch, frr, rsr, msg_pr, ids_pr, plan_pr, "sum")),
              "plain_ms": time_ms(torch, lambda: segment_combine_ref(
                  msg_pr, ids_pr, nseg_pr, "sum"), reps=5),
              "library_ms": _library_ms(torch, "sum", ids_pr.long(), msg_pr,
                                        nseg_pr)}

    # [k9-cell]: each piece size on the heaviest round, summed
    # over the min rounds and on the PageRank round (raw launches)
    sweep = {}
    for cells in K9_SWEEP:
        def timed(cells=cells):
            got = launch()[0]
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"K9 at {cells} cells a piece: "
                  "differs")
            return {"heaviest_ms": time_ms(torch, raw()),
                    "sum_ms": time_ms(torch, raw_rounds()),
                    "pagerank_ms": time_ms(torch, _k9_raw(
                        torch, frr, rsr, msg_pr, ids_pr, plan_pr, "sum"))}
        sweep[cells] = _k9_cut(rsr, cells, timed)
    row.update(sweep=sweep, rounds=len(rounds))
    return row, row_pr, max_abs_err(torch, out, plain)


def phase_lanes(torch, np, dev, g, part, root, want, part_pr, want_pr):
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
    (got, _), row = drive("pagerank_reduce", "pagerank", lambda: apps.pagerank(
        g, iters=PR_ITERS, part=part_pr, cfg=cfg_r))
    diff = float(np.abs(got - want_pr).max())
    check(np.allclose(got, want_pr, rtol=PR_RTOL, atol=PR_ATOL),
          f"pagerank reduce off the oracle by {diff}")
    check(row["k9"] == PR_ITERS and row["k1"] == 0,
          f"pagerank reduce: {row['k9']} K9 launches for {PR_ITERS} rounds")
    row["max_abs_diff"] = diff
    log(f"[lanes] pagerank pallas_mode='reduce': {PR_ITERS} rounds within "
        f"rtol {PR_RTOL} / atol {PR_ATOL} of the float64 oracle (max |diff| "
        f"{diff:.3g}), {row['k9']} K9 launches (sum), wall "
        f"{row['wall_s']:.3f} s")

    # replay the heaviest rounds for timings
    planner = engine.launch_planner(part, engine.EngineConfig(
        use_pallas=True, grid_mode="worklist"), q_pad=LANES)
    k3, k4, err = _time_lane_kernels(torch, np, dev, part, arrays, planner,
                                     queries)
    k9, k9_sum, err9 = _time_segment_kernel(torch, np, dev, part, arrays,
                                            root, part_pr)
    report.update(k3=k3, k4=k4, k9=k9, k9_sum=k9_sum)
    log(f"[lanes] heaviest Q={LANES} round (round {k3['round']} of "
        f"{k3['rounds']}: {k3['active_edges']} active edges, "
        f"{k3['active_pairs']} active (edge, lane) pairs): K3 relax phase "
        f"{k3['ms']:.4f} ms (kernel alone {k3['kernel_ms']:.4f} ms), 16 solo "
        f"K1 launches {k3['k1_solo_ms']:.4f} ms (gain "
        f"{k3['batching_gain']:.2f}x), plain {k3['plain_ms']:.4f} ms, "
        f"index_reduce_ amin {k3['library_ms']:.4f} ms, bound "
        f"{k3['bound_ms']:.4f} ms ({k3['bound_by']})")
    log(f"[lanes] same round, K4 ({k4['cells']} cells, device plan "
        f"{k4['device_cells']}): planner {k4['plan_ms']:.2f} ms (host), K4 "
        f"{k4['kernel_ms']:.4f} ms (device plan "
        f"{k4['device_kernel_ms']:.4f} ms), relax phase {k4['ms']:.4f} ms "
        f"(device plan {k4['device_ms']:.4f} ms), plain "
        f"{k4['plain_ms']:.4f} ms; split buffer {k4['split_bytes']} B; K4 "
        f"by piece size (host/device plan ms): "
        f"{_sweep_text(k4['piece_sweep'])}")
    hub = k3["hub"]
    log(f"[k3-fold] K3 alone ({hub['lists_per_window']} lists a window): "
        f"heaviest Q={LANES} round {k3['kernel_ms']:.4f} ms; summed over "
        f"the {k3['rounds']} rounds of the fixpoint "
        f"{k3['round_sum_ms']:.4f} ms; blocks resident per SM at "
        f"Q={LANES}: {k3['blocks_per_sm']}")
    log(f"[k3-fold] heaviest piece of the heaviest round: piece "
        f"{hub['piece']}, {hub['cells']} cells, {hub['edges']} edges of "
        f"its block in run cells, {hub['runs']} runs at "
        f"{hub['lists_per_window']} lists a window (median piece "
        f"{hub['median_piece_edges']:.0f} edges)")
    log("[lanes] kernels (+ copies) a laned relax phase puts on the card, "
        "by torch.profiler: " + ", ".join(
            f"{k} {v['kernels']} (+{v['copies']})"
            for k, v in k4["relax_launches"].items()))
    log(f"[lanes] heaviest reduce round ({k9['app']} round {k9['round']}, "
        f"{k9['active_edges']} active of {k9['edges']} edges): K9 "
        f"{k9['ms']:.4f} ms (kernel alone {k9['kernel_ms']:.4f} ms), plain "
        f"{k9['plain_ms']:.4f} ms, scatter_reduce_ amin "
        f"{k9['library_ms']:.4f} ms, bound {k9['bound_ms']:.4f} ms")
    log(f"[k9] same round: {k9['cells']} cells in {k9['pieces']} pieces of "
        f"at most {k9['cells_per_piece']} (4 warps a block), "
        f"equal to the order model bit for bit (model "
        f"{k9['model_s']:.1f} s on the host); raw launches "
        f"{k9['raw_ms']:.4f} ms; its warps loaded {k9['edges_loaded']} "
        f"ids and messages ({k9['edges_loaded'] * 8} B, counted on the "
        f"card; the bound reads {k9['edges']}, {k9['edges'] * 8} B); "
        f"summed over the {k9['rounds']} min rounds "
        f"{k9['round_sum_ms']:.4f} ms (raw launches)")
    tr = k9["trace"]
    log(f"[k9-trace] torch.profiler over {tr['reps']} wrapper launches of "
        "the same round, K9 kernels seen and their mean device time: "
        + ", ".join(f"{w} {tr[w]['kernels']} ("
                    + (f"{tr[w]['mean_us']:.2f} us" if tr[w]['mean_us']
                       else "none") + ")"
                    for w in ("settled", "bare", "scheduled"))
        + "; launches held without a kernel record, by launch-order "
        "position: "
        + ", ".join(f"{w} {tr[w]['missing']} of {tr[w]['launches']} "
                    f"(least lag {tr[w]['min_lag_us']} us)"
                    for w in ("settled", "bare", "scheduled"))
        + "; raw launches "
        f"{1e3 * k9['raw_ms']:.2f} us")
    log(f"[k9] pagerank reduce round ({k9_sum['active_edges']} active "
        f"edges, sum): equal to the order model bit for bit; K9 "
        f"{k9_sum['ms']:.4f} ms (kernel alone {k9_sum['kernel_ms']:.4f} ms, "
        f"raw launches {k9_sum['raw_ms']:.4f} ms), plain "
        f"{k9_sum['plain_ms']:.4f} ms, index_add_ "
        f"{k9_sum['library_ms']:.4f} ms, bound {k9_sum['bound_ms']:.4f} ms")
    log("[k9-cell] K9 ms (raw launches) by cells a piece (heaviest min "
        "round / summed over the min rounds / pagerank round): " + ", ".join(
            f"P={k} {v['heaviest_ms']:.4f}/{v['sum_ms']:.4f}/"
            f"{v['pagerank_ms']:.4f}" for k, v in k9["sweep"].items()))
    return launches, {"K3": err, "K4": err, "K9": err9}, report


# --------------------------------------------------------------------------
# phase 7: the slice-4 path at RMAT-18 — the tiled residency (K5-K8)
# --------------------------------------------------------------------------

def _tiled_check(torch, np, dev, case, nseg, relax, kind, grid_mode, vblk,
                 unitw=None):
    """One tiled launch (K5/K6, or K7/K8 with ``unitw``) against its
    pinned twin (K1/K2/K3/K4) on the same plan, bit for bit on min and on
    sum; against its plain version and the pinned oracle (min bit-equal,
    sum within rtol 1e-5 / atol 1e-6 and bit-equal between two runs); a
    worklist one's plain version bit-equal to its twin's on min (the
    plain sums are not repeatable on the card); counts,
    executed cells and staged rows equal to the host mirror, the same
    rows under every launch shape.  Returns (kernel, max |err|)."""
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ref
    gval, gchg, src, w, mask, ids = case
    laned = unitw is not None
    q = gval.shape[1] if laned else 1
    v = gval.shape[0]
    vb = frr.select_kernel_path(v, q, path="tiled", vblk=vblk)[1]
    t = [torch.as_tensor(x, device=dev) for x in case]
    head = t[:2] + ([torch.as_tensor(unitw, device=dev)] if laned else [])
    gor = gchg.any(axis=1) if laned else gchg
    plan = frr.plan_launch(t[2], t[4], t[5], nseg, v)
    m = frr.fused_grid_cells(ids, mask, src, gor, nseg, vblk=vb)
    wl = None
    if grid_mode == "worklist":
        wl, info = frr.plan_worklist(ids, mask, src, gor, nseg, num_slots=v,
                                     path="tiled", vblk=vb, lane_width=q)
        want_dbg = (info.cells, info.staged_rows)
    elif grid_mode == "device_worklist":
        wl = frr.build_device_worklist(t[1], t[2], t[4], t[5], nseg, plan,
                                       path="tiled", vblk=vb)
        _, info = frr.plan_worklist(ids, mask, src, gor, nseg, num_slots=v,
                                    path="tiled", vblk=vb, dst_filter=False)
        want_dbg = (info.cells, info.staged_rows)
    else:
        want_dbg = (m["fused_live"], m["fused_staged_rows"])
    name = ("K7" if wl is None else "K8") if laned \
        else ("K5" if wl is None else "K6")
    twin = ("K3" if wl is None else "K4") if laned \
        else ("K1" if wl is None else "K2")
    launch = frr.fused_relax_reduce_lanes if laned else frr.fused_relax_reduce

    def run(debug=True):
        return launch(*head, *t[2:], nseg, relax, kind, with_count=True,
                      with_debug=debug, plan=plan, worklist=wl, path="tiled",
                      vblk=vb)

    out, count, dbg = run()
    if wl is None:
        plain_fn = (ref.fused_relax_reduce_tiled_lanes_ref if laned
                    else ref.fused_relax_reduce_tiled_ref)
        plain, rows = plain_fn(*head, *t[2:], nseg, relax, kind, plan)
        pinned = launch(*head, *t[2:], nseg, relax, kind, plan=plan,
                        path="pinned")
        twin_plain = plain
    else:
        plain_fn, twin_fn = (
            (ref.fused_relax_reduce_wl_tiled_lanes_ref,
             ref.fused_relax_reduce_wl_lanes_ref) if laned
            else (ref.fused_relax_reduce_wl_tiled_ref,
                  ref.fused_relax_reduce_wl_ref))
        cells = (wl.wl_i.to(dev), wl.wl_j.to(dev), wl.nlive.to(dev), nseg,
                 relax, kind)
        plain, rows = plain_fn(*head, *t[2:], *cells)
        twin_plain = twin_fn(*head, *t[2:], *cells)
        pinned = launch(*head, *t[2:], nseg, relax, kind, plan=plan,
                        worklist=frr.Worklist(wl.wl_i, wl.wl_j, wl.nlive))
        # one piece a block: the tiled and pinned worklist launches give
        # the dense pinned launch's bits, sum included
        whole = _one_piece(frr, lambda: (run(debug=False)[0], launch(
            *head, *t[2:], nseg, relax, kind, plan=plan,
            worklist=frr.Worklist(wl.wl_i, wl.wl_j, wl.nlive)), launch(
            *head, *t[2:], nseg, relax, kind, plan=plan, path="pinned")))
        check(torch.equal(whole[0], whole[1])
              and torch.equal(whole[0], whole[2]),
              f"{name}/{twin} one piece a block differ from the dense "
              f"launch: {grid_mode} {relax}/{kind} q={q}")
    oracle = (ref.fused_relax_reduce_lanes_ref if laned
              else ref.fused_relax_reduce_ref)(*head, *t[2:], nseg, relax,
                                               kind)
    torch.cuda.synchronize()
    at = f"{name} {grid_mode} {relax}/{kind} q={q} v={v} nseg={nseg} " \
         f"vblk={vb}"
    err = _check_out(torch, out, plain, kind, at)
    _check_out(torch, out, oracle, kind, at + " (pinned oracle)")
    check(torch.equal(out, pinned),
          f"differs from {twin} bit for bit: {at}")
    # the plain versions sum with scatter_reduce_, whose atomics on the
    # card reorder a sum from call to call: only min repeats bit for bit
    if kind == "min":
        check(torch.equal(plain, twin_plain),
              f"plain version differs from {twin}'s bit for bit: {at}")
    if kind == "sum":
        check(torch.equal(out, run(debug=False)[0]),
              f"sum differs between runs: {at}")
    want_count = (mask[:, None] & gchg[src]).sum(axis=0) if laned \
        else (mask & gchg[src]).sum()
    check(np.array_equal(count.cpu().numpy(), want_count),
          f"counts differ: {at}")
    got_dbg = (int(dbg[0]), int(dbg[1]))
    check(got_dbg == want_dbg and int(rows) == want_dbg[1]
          and want_dbg[1] == m["fused_staged_rows"],
          f"cells/rows {got_dbg} (plain {int(rows)}) != mirror {want_dbg} "
          f"(dense rows {m['fused_staged_rows']}): {at}")
    return name, err


def phase_tiled_kernels_vs_plain(torch, np, dev):
    from repro_torch.kernels import fused_relax_reduce as frr
    shapes = [(1025, 5 * frr.EBLK + 13, 2 * frr.SBLK + 5),
              (30011, 97 * frr.EBLK + 311, 20011)]
    errs = {"K5": 0.0, "K6": 0.0, "K7": 0.0, "K8": 0.0}
    n = 0
    combos = [(None, p) for p in (("add_w", "min"), ("add_one", "min"),
                                  ("mul_w", "sum"))]
    combos += [(q, p) for q in (1, 5, 16, 33)
               for p in (("add_w", "min"), ("mul_w", "sum"))]
    for q, (relax, kind) in combos:
        for v, e, nseg in shapes:
            for frac in (0.0, 0.01, 1.0):
                vblk = 128 if n % 2 else None
                if q is None:
                    case, unitw = _case(np, v, e, nseg, frac, seed=v + n,
                                        sorted_ids=True,
                                        negative=kind == "min"), None
                else:
                    c = _lane_case(np, v, e, nseg, q, frac, seed=v + q + n)
                    case, unitw = c[:2] + c[3:], c[2]
                for grid_mode in ("dense", "worklist", "device_worklist"):
                    name, err = _tiled_check(torch, np, dev, case, nseg,
                                             relax, kind, grid_mode, vblk,
                                             unitw)
                    errs[name] = max(errs[name], err)
                n += 1
    log(f"[tiled] {n} cases x (dense, host plan, device plan): K5/K6 and "
        f"K7/K8 (Q in 1/5/16/33), vblk 128 and automatic: min bit-equal to "
        f"the plain versions and the pinned oracle, sum max_abs_err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + " (rtol 1e-5) and bit-repeatable; K5/K6/K7/K8 bit-equal to "
        "K1/K2/K3/K4 on the same plan, sum included, and the worklist plain "
        "versions to K2's/K4's on min; counts, executed cells and staged rows "
        "equal "
        "the host mirror, the same rows dense and on both plans")
    return errs


def _heaviest_round(torch, dev, part, arrays, sem, root):
    """Replay ``sem``'s pinned dense fixpoint from ``root`` and return the
    entering (gval, gchg) of its round with the most active edges, the
    round number and the rounds run."""
    from repro_torch import exchange
    from repro_torch.core import engine
    val = torch.as_tensor(engine.init_values(part, sem, {root: 0.0}),
                          device=dev)
    chg = sem.improved(val, torch.full_like(val, sem.identity)) \
        & arrays.slot_valid
    src = arrays.edge_src_root_flat.reshape(-1).long()
    mask = arrays.edge_mask.reshape(-1)
    cfg = engine.EngineConfig(use_pallas=True)
    best, rnd = None, 0
    while bool(chg.any()):
        rnd += 1
        n = int((mask & chg.reshape(-1)[src]).sum())
        if best is None or n > best[0]:
            best = (n, rnd, val.reshape(-1).clone(), chg.reshape(-1).clone())
        val, chg, _ = exchange.fixpoint_round_stacked(
            sem, arrays, cfg, part.S, part.R_max, val, chg)
    return best[2], best[3], best[1], rnd


def _plan_ms(planner, gchg_h, reps=3):
    """Mean host time of one round's plan (ms) and the last plan."""
    t0 = time.perf_counter()
    for _ in range(reps):
        res = planner.plan(gchg_h)
    return 1e3 * (time.perf_counter() - t0) / reps, res


def _time_wl_twins(torch, frr, tiled, pinned, flags_t, flags_p):
    """K6 (K8) against K2 (K4), each alone, on the host plan (the tiled
    planner's flags ``flags_t``, the pinned one's ``flags_p``) and the
    device plan; then K6 (K8) at each piece size of ``PIECE_SWEEP``.
    ``tiled(flags)`` and ``pinned(flags)`` launch the kernels."""
    return {
        "kernel_ms": time_ms(torch, lambda: tiled(flags_t)),
        "pinned_ms": time_ms(torch, lambda: pinned(flags_p)),
        "device_kernel_ms": time_ms(torch, lambda: tiled(None)),
        "pinned_device_kernel_ms": time_ms(torch, lambda: pinned(None)),
        "piece_sweep": _piece_sweep(
            torch, frr, lambda host: tiled(flags_t if host else None))}


def _time_tiled_kernels(torch, np, dev, part, arrays, root):
    """K5 against K1 and K6 against K2 on the heaviest SSSP round, with
    the plain versions, the pinned twins' library call and byte bound,
    the rows each kernel stages and the planners' host time.  Returns
    (K5 row, K6 row, max err)."""
    from repro_torch.core import actions, engine
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops, ref
    sem = actions.SSSP
    gval, gchg, rnd, rounds = _heaviest_round(torch, dev, part, arrays, sem,
                                              root)
    plan = arrays.fused_plan
    nseg = v = part.S * part.R_max
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    ids = arrays.edge_dst_flat.reshape(-1)
    rk, kind = sem.relax_kind, sem.segment
    path, vblk = frr.select_kernel_path(v, 1, TILED_BUDGET)
    check(path == "tiled", "the RMAT-18 table is over the tiled budget")
    gval_m = frr._masked_value_tables(gval, gchg, sem.identity)
    act = frr._active_edges(src, mask, gchg)
    chunk_act, count = frr._chunk_tables(src, mask, gchg, act)
    out1, _ = frr._launch(gval_m, src, w, mask, ids, plan, chunk_act, rk,
                          kind, False)
    out5, dbg5 = frr._launch_tiled(gval_m, src, w, mask, ids, plan,
                                   chunk_act, act, rk, kind, True)
    plain5, rows5 = ref.fused_relax_reduce_tiled_ref(
        gval, gchg, src, w, mask, ids, nseg, rk, kind, plan)
    gchg_h = gchg.cpu().numpy()
    mirror = frr.fused_grid_cells(part.edge_dst_flat, part.edge_mask,
                                  part.edge_src_root_flat, gchg_h, nseg,
                                  vblk=vblk)
    torch.cuda.synchronize()
    check(torch.equal(out5, out1) and torch.equal(out5, plain5),
          f"K5 round {rnd}: differs from K1 / its plain version")
    check((int(dbg5[0]), int(dbg5[1])) == (mirror["fused_live"],
                                           mirror["fused_staged_rows"])
          and int(rows5) == mirror["fused_staged_rows"],
          f"K5 round {rnd}: cells/rows {dbg5.tolist()} != mirror")
    n_active = int(count)
    bound, bound_by = _round_bound_ms(part, rk, n_active)
    msg = torch.where(act, sem.relax(gval[src.long()], w), sem.identity)
    common = {"round": rnd, "rounds": rounds, "vblk": vblk,
              "tiles": -(-v // vblk), "active_edges": n_active,
              "bound_ms": bound, "bound_by": bound_by,
              "library_ms": _library_ms(torch, kind, ids.long(), msg, nseg)}
    k5 = dict(common, cells=mirror["fused_live"],
              rows=mirror["fused_staged_rows"],
              dma_bytes=mirror["staged_bytes"],
              reference_tile_copies=mirror["fused_tile_dmas"],
              reference_tile_bytes=mirror["dma_bytes"],
              ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                  gval, gchg, src, w, mask, ids, nseg, rk, kind, plan=plan,
                  vmem_budget_bytes=TILED_BUDGET)),
              pinned_phase_ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                  gval, gchg, src, w, mask, ids, nseg, rk, kind, plan=plan)),
              kernel_ms=time_ms(torch, lambda: frr._launch_tiled(
                  gval_m, src, w, mask, ids, plan, chunk_act, act, rk, kind,
                  False)),
              pinned_ms=time_ms(torch, lambda: frr._launch(
                  gval_m, src, w, mask, ids, plan, chunk_act, rk, kind,
                  False)),
              plain_ms=time_ms(torch, lambda: ref.fused_relax_reduce_tiled_ref(
                  gval, gchg, src, w, mask, ids, nseg, rk, kind, plan)))

    # K6 against K2 on the same cells: the tiled planner's host plan (the
    # pinned planner's cells) and the device plan
    cfg_t = engine.EngineConfig(use_pallas=True, grid_mode="worklist",
                                vmem_budget_bytes=TILED_BUDGET)
    planner_t = engine.launch_planner(part, cfg_t)
    planner_p = engine.launch_planner(part, engine.EngineConfig(
        use_pallas=True, grid_mode="worklist"))
    plan_ms, (wl_t, info_t) = _plan_ms(planner_t, gchg_h)
    pinned_plan_ms, (wl_p, info_p) = _plan_ms(planner_p, gchg_h)
    check(torch.equal(wl_t.wl_j, wl_p.wl_j) and torch.equal(wl_t.wl_i,
                                                            wl_p.wl_i),
          "the tiled and pinned planners list other cells")
    f_t, f_p = (frr._card_flags(wl, plan, nseg) for wl in (wl_t, wl_p))

    def launch6(flags, debug=False):
        return frr._launch_wl_tiled(gval_m, src, w, mask, ids, act, plan,
                                    chunk_act, flags, rk, kind, debug)

    def launch2(flags):
        return frr._launch_wl(gval_m, src, w, mask, ids, plan, chunk_act,
                              flags, rk, kind, False)

    out6, dbg6 = launch6(f_t, True)
    out2, _ = launch2(f_p)
    out6d, dbg6d = launch6(None, True)
    out2d, _ = launch2(None)
    whole6, whole2 = _one_piece(frr, lambda: (launch6(f_t)[0],
                                              launch2(f_p)[0]))
    on_t = wl_t.to(dev)
    plain6, rows6 = ref.fused_relax_reduce_wl_tiled_ref(
        gval, gchg, src, w, mask, ids, on_t.wl_i, on_t.wl_j, on_t.nlive,
        nseg, rk, kind)
    torch.cuda.synchronize()
    check(torch.equal(out6, out2) and torch.equal(out6d, out2d)
          and torch.equal(whole6, whole2) and torch.equal(whole6, out1)
          and torch.equal(out6, out1) and torch.equal(out6, plain6),
          f"K6 round {rnd}: differs from K2 on the same plan and pieces / "
          "K1 / its plain version")
    check((int(dbg6[0]), int(dbg6[1])) == (info_t.cells, info_t.staged_rows)
          and int(rows6) == info_t.staged_rows
          and int(dbg6d[1]) == mirror["fused_staged_rows"]
          == info_t.staged_rows,
          f"K6 round {rnd}: cells/rows {dbg6.tolist()} (device plan "
          f"{dbg6d.tolist()}) != plan")
    k6 = dict(common, cells=info_t.cells, device_cells=int(dbg6d[0]),
              rows=info_t.staged_rows, dma_bytes=info_t.staged_bytes,
              plan_ms=plan_ms, pinned_plan_ms=pinned_plan_ms,
              pinned_cells=info_p.cells,
              ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                  gval, gchg, src, w, mask, ids, nseg, rk, kind, plan=plan,
                  worklist=wl_t)),
              pinned_phase_ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                  gval, gchg, src, w, mask, ids, nseg, rk, kind, plan=plan,
                  worklist=wl_p)),
              device_ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                  gval, gchg, src, w, mask, ids, nseg, rk, kind, plan=plan,
                  grid_mode="device_worklist",
                  vmem_budget_bytes=TILED_BUDGET)),
              pinned_device_ms=time_ms(torch, lambda: ops.fused_relax_reduce(
                  gval, gchg, src, w, mask, ids, nseg, rk, kind, plan=plan,
                  grid_mode="device_worklist")),
              plain_ms=time_ms(torch, lambda: ref.fused_relax_reduce_wl_tiled_ref(
                  gval, gchg, src, w, mask, ids, on_t.wl_i, on_t.wl_j,
                  on_t.nlive, nseg, rk, kind), reps=TILED_REPS, warmup=1))
    k6.update(_time_wl_twins(torch, frr, launch6, launch2, f_t, f_p))
    return k5, k6, max(max_abs_err(torch, out5, plain5),
                       max_abs_err(torch, out6, plain6))


def _time_tiled_lane_kernels(torch, np, dev, part, arrays, queries):
    """K7 against K3 and K8 against K4 on the heaviest Q-lane round, as
    ``_time_tiled_kernels`` does K5 and K6.  Returns (K7, K8, max err)."""
    from repro_torch.core import engine
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ref import _lane_messages
    gval, gchg, unitw, rnd, rounds, k3_ms = _heaviest_lane_round(
        torch, np, dev, part, arrays, queries)
    plan = arrays.fused_plan
    nseg = v = part.S * part.R_max
    q = gval.shape[1]
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    ids = arrays.edge_dst_flat.reshape(-1)
    path, vblk = frr.select_kernel_path(v, q, TILED_LANE_BUDGET)
    check(path == "tiled", "the Q-lane table is over the tiled budget")
    gval_m = frr._masked_value_tables(gval, gchg, math.inf)
    unit_u8 = (unitw != 0).to(torch.uint8)
    chunk_act, counts, act = frr._lane_chunk_tables(
        src, mask, gchg, plan.src_deg, with_act=True)
    out3, _ = frr._launch_lanes(gval_m, unit_u8, src, w, mask, ids, plan,
                                chunk_act, "add_w", "min", False)
    out7, dbg7 = frr._launch_tiled_lanes(gval_m, unit_u8, src, w, mask, ids,
                                         plan, chunk_act, act, "add_w",
                                         "min", True)
    plain7, rows7 = ref.fused_relax_reduce_tiled_lanes_ref(
        gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min", plan)
    gchg_h = gchg.cpu().numpy()
    mirror = frr.fused_grid_cells(part.edge_dst_flat, part.edge_mask,
                                  part.edge_src_root_flat, gchg_h, nseg,
                                  vblk=vblk, lane_width=q)
    torch.cuda.synchronize()
    check(torch.equal(out7, out3) and torch.equal(out7, plain7),
          f"K7 round {rnd}: differs from K3 / its plain version")
    check((int(dbg7[0]), int(dbg7[1])) == (mirror["fused_live"],
                                           mirror["fused_staged_rows"])
          and int(rows7) == mirror["fused_staged_rows"],
          f"K7 round {rnd}: cells/rows {dbg7.tolist()} != mirror")
    n_edges = int(act.sum())
    n_pairs = int(counts.sum())
    bound, bound_by = _lane_round_bound_ms(part, n_edges, n_pairs, q)
    msg = _lane_messages(gval, gchg, unitw, src, w, mask, "add_w", "min")
    ids_long = ids.long()
    common = {"round": rnd, "rounds": rounds, "lanes": q, "vblk": vblk,
              "tiles": -(-v // vblk), "active_edges": n_edges,
              "active_pairs": n_pairs, "bound_ms": bound,
              "bound_by": bound_by,
              "library_ms": time_ms(torch, lambda: torch.full(
                  (nseg, q), math.inf, device=dev).index_reduce_(
                      0, ids_long, msg, "amin", include_self=True), reps=5)}
    k7 = dict(common, cells=mirror["fused_live"],
              rows=mirror["fused_staged_rows"],
              dma_bytes=mirror["staged_bytes"],
              reference_tile_copies=mirror["fused_tile_dmas"],
              reference_tile_bytes=mirror["dma_bytes"],
              ms=time_ms(torch, lambda: ops.fused_relax_reduce_lanes(
                  gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min",
                  plan=plan, vmem_budget_bytes=TILED_LANE_BUDGET)),
              pinned_phase_ms=time_ms(
                  torch, lambda: ops.fused_relax_reduce_lanes(
                      gval, gchg, unitw, src, w, mask, ids, nseg, "add_w",
                      "min", plan=plan)),
              kernel_ms=time_ms(torch, lambda: frr._launch_tiled_lanes(
                  gval_m, unit_u8, src, w, mask, ids, plan, chunk_act, act,
                  "add_w", "min", False)),
              pinned_ms=time_ms(torch, lambda: frr._launch_lanes(
                  gval_m, unit_u8, src, w, mask, ids, plan, chunk_act,
                  "add_w", "min", False)),
              plain_ms=time_ms(
                  torch, lambda: ref.fused_relax_reduce_tiled_lanes_ref(
                      gval, gchg, unitw, src, w, mask, ids, nseg, "add_w",
                      "min", plan), reps=TILED_REPS, warmup=1))

    cfg_t = engine.EngineConfig(use_pallas=True, grid_mode="worklist",
                                vmem_budget_bytes=TILED_LANE_BUDGET)
    planner_t = engine.launch_planner(part, cfg_t, q_pad=q)
    planner_p = engine.launch_planner(part, engine.EngineConfig(
        use_pallas=True, grid_mode="worklist"), q_pad=q)
    gor = gchg_h.any(axis=1)
    plan_ms, (wl_t, info_t) = _plan_ms(planner_t, gor)
    pinned_plan_ms, (wl_p, info_p) = _plan_ms(planner_p, gor)
    check(torch.equal(wl_t.wl_j, wl_p.wl_j) and torch.equal(wl_t.wl_i,
                                                            wl_p.wl_i),
          "the tiled and pinned lane planners list other cells")
    f_t, f_p = (frr._card_flags(wl, plan, nseg) for wl in (wl_t, wl_p))

    def launch8(flags, debug=False):
        return frr._launch_wl_tiled_lanes(gval_m, unit_u8, src, w, mask, ids,
                                          act, plan, chunk_act, flags,
                                          "add_w", "min", debug)

    def launch4(flags):
        return frr._launch_wl_lanes(gval_m, unit_u8, src, w, mask, ids, plan,
                                    chunk_act, flags, "add_w", "min", False)

    out8, dbg8 = launch8(f_t, True)
    out4, _ = launch4(f_p)
    out8d, dbg8d = launch8(None, True)
    out4d, _ = launch4(None)
    whole8, whole4 = _one_piece(frr, lambda: (launch8(f_t)[0],
                                              launch4(f_p)[0]))
    on_t = wl_t.to(dev)
    plain8, rows8 = ref.fused_relax_reduce_wl_tiled_lanes_ref(
        gval, gchg, unitw, src, w, mask, ids, on_t.wl_i, on_t.wl_j,
        on_t.nlive, nseg, "add_w", "min")
    torch.cuda.synchronize()
    check(torch.equal(out8, out4) and torch.equal(out8d, out4d)
          and torch.equal(whole8, whole4) and torch.equal(whole8, out3)
          and torch.equal(out8, out3) and torch.equal(out8, plain8),
          f"K8 round {rnd}: differs from K4 on the same plan and pieces / "
          "K3 / its plain version")
    check((int(dbg8[0]), int(dbg8[1])) == (info_t.cells, info_t.staged_rows)
          and int(rows8) == info_t.staged_rows
          and int(dbg8d[1]) == mirror["fused_staged_rows"]
          == info_t.staged_rows,
          f"K8 round {rnd}: cells/rows {dbg8.tolist()} (device plan "
          f"{dbg8d.tolist()}) != plan")
    k8 = dict(common, cells=info_t.cells, device_cells=int(dbg8d[0]),
              rows=info_t.staged_rows, dma_bytes=info_t.staged_bytes,
              plan_ms=plan_ms, pinned_plan_ms=pinned_plan_ms,
              pinned_cells=info_p.cells,
              ms=time_ms(torch, lambda: ops.fused_relax_reduce_lanes(
                  gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min",
                  plan=plan, worklist=wl_t)),
              pinned_phase_ms=time_ms(
                  torch, lambda: ops.fused_relax_reduce_lanes(
                      gval, gchg, unitw, src, w, mask, ids, nseg, "add_w",
                      "min", plan=plan, worklist=wl_p)),
              device_ms=time_ms(torch, lambda: ops.fused_relax_reduce_lanes(
                  gval, gchg, unitw, src, w, mask, ids, nseg, "add_w", "min",
                  plan=plan, grid_mode="device_worklist",
                  vmem_budget_bytes=TILED_LANE_BUDGET)),
              pinned_device_ms=time_ms(
                  torch, lambda: ops.fused_relax_reduce_lanes(
                      gval, gchg, unitw, src, w, mask, ids, nseg, "add_w",
                      "min", plan=plan, grid_mode="device_worklist")),
              plain_ms=time_ms(
                  torch, lambda: ref.fused_relax_reduce_wl_tiled_lanes_ref(
                      gval, gchg, unitw, src, w, mask, ids, on_t.wl_i,
                      on_t.wl_j, on_t.nlive, nseg, "add_w", "min"),
                  reps=TILED_REPS, warmup=1))
    k8.update(_time_wl_twins(torch, frr, launch8, launch4, f_t, f_p))
    return k7, k8, max(max_abs_err(torch, out7, plain7),
                       max_abs_err(torch, out8, plain8))


def phase_tiled(torch, np, dev, g, part, root, want, part_pr, want_conv):
    from repro_torch import apps, exchange, obs
    from repro_torch.core import actions, engine
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import rhizome_segment_reduce as rsr

    reg = obs.registry()
    report = {"runs": {}}
    counters = {"k1": "launches", "k2": "wl_launches",
                "k3": "lanes_launches", "k4": "wl_lanes_launches",
                "k5": "tiled_launches", "k6": "wl_tiled_launches",
                "k7": "tiled_lanes_launches",
                "k8": "wl_tiled_lanes_launches"}
    launches = {"K5": 0, "K6": 0, "K7": 0, "K8": 0}

    def drive(key, run, call):
        """Drive one run of the path with the launch counts set to 0 just
        before it and read just after; returns its result and a row."""
        d = reg.counter("engine_dispatches_total").labels(run=run)
        h = reg.counter("engine_host_syncs_total").labels(run=run)
        d0, h0 = d.value, h.value
        for attr in counters.values():
            setattr(frr, attr, 0)
        rsr.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        row = {"wall_s": time.perf_counter() - t0, "k9": rsr.launches,
               "dispatches": d.value - d0, "host_syncs": h.value - h0}
        row.update({k: getattr(frr, attr) for k, attr in counters.items()})
        for k in launches:
            launches[k] += row[k.lower()]
        report["runs"][key] = row
        return res, row

    def only(row, name, n, at):
        """``name``'s launches are ``n`` and no other kernel launched."""
        others = {k: v for k, v in row.items()
                  if k.startswith("k") and k != name and v}
        check(row[name] == n and not others,
              f"{at}: {row[name]} {name.upper()} launches for {n} rounds, "
              f"others {others}")

    # BFS and SSSP over the budget: K5 dense, K6 host and device plans
    for grid in ("dense", "worklist", "device_worklist"):
        cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid,
                                  vmem_budget_bytes=TILED_BUDGET)
        for name, app in (("bfs", apps.bfs), ("sssp", apps.sssp)):
            (got, stats, _), row = drive(
                f"{name}_tiled_{grid}", name,
                lambda: app(g, root, part=part, cfg=cfg))
            rounds = int(stats.iterations)
            row.update(rounds=rounds, messages=int(stats.messages))
            check(np.array_equal(got, want[name]),
                  f"{name} tiled {grid} differs from the numpy oracle at "
                  f"{int((got != want[name]).sum())} vertices")
            windows = -(-rounds // cfg.device_window)
            if grid == "device_worklist":
                only(row, "k6", windows * cfg.device_window,
                     f"{name} tiled {grid}")
                check(row["host_syncs"] == windows,
                      f"{name} tiled {grid}: {row['host_syncs']} syncs")
            else:
                only(row, "k5" if grid == "dense" else "k6", rounds,
                     f"{name} tiled {grid}")
            log(f"[tiled] {name} {grid} at vmem_budget_bytes="
                f"{TILED_BUDGET}: equal to the oracle; {rounds} rounds, K5 "
                f"{row['k5']} / K6 {row['k6']} launches, "
                f"{row['host_syncs']} host syncs, wall {row['wall_s']:.3f} s")

    # a tiled device_worklist window enqueues without any host sync
    arrays = engine.DeviceArrays.from_partition(part, dev)
    cfg_dev = engine.EngineConfig(use_pallas=True,
                                  grid_mode="device_worklist",
                                  vmem_budget_bytes=TILED_BUDGET)
    val = torch.as_tensor(engine.init_values(part, actions.SSSP,
                                             {root: 0.0}), device=dev)
    chg = (val == 0) & arrays.slot_valid
    frr.wl_tiled_launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exchange.fixpoint_window_stacked(
            actions.SSSP, arrays, cfg_dev, part.S, part.R_max,
            cfg_dev.device_window, val, chg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(frr.wl_tiled_launches == cfg_dev.device_window,
          "the tiled window's rounds run K6")
    log(f"[tiled] a {cfg_dev.device_window}-round SSSP window of K6 "
        "launches enqueued under sync-debug mode 'error': no host sync")

    # delta-PageRank over the budget under device_worklist
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="device_worklist",
                              vmem_budget_bytes=TILED_BUDGET)
    (got, stats, _), row = drive(
        "pagerank_delta_tiled_device_worklist", "pagerank_delta",
        lambda: apps.pagerank_delta(g, tol=PR_TOL, part=part_pr, cfg=cfg))
    rounds = int(stats.iterations)
    row.update(rounds=rounds, messages=int(stats.messages),
               max_abs_diff=float(np.abs(got - want_conv).max()))
    check(np.allclose(got, want_conv, rtol=PR_RTOL, atol=PR_ATOL),
          f"pagerank_delta tiled off the oracle by {row['max_abs_diff']}")
    windows = -(-rounds // cfg.device_window)
    only(row, "k6", windows * cfg.device_window, "pagerank_delta tiled")
    log(f"[tiled] pagerank_delta device_worklist: {rounds} rounds within "
        f"rtol {PR_RTOL} / atol {PR_ATOL} of the oracle (max |diff| "
        f"{row['max_abs_diff']:.3g}), K6 {row['k6']} launches, "
        f"{row['host_syncs']} host syncs, wall {row['wall_s']:.3f} s")

    # Q = 16 lanes over the budget: K7 dense, K8 host and device plans,
    # every lane bit-equal to the pinned K3 run
    deg = np.argsort(-g.out_degrees(), kind="stable")
    roots = [int(v) for v in deg[:LANES]]
    half = LANES // 2
    queries = [("bfs", r) for r in roots[:half]] + \
        [("sssp", r) for r in roots[half:]]
    pinned, pstats, _ = apps.batched_queries(
        g, queries, part=part, cfg=engine.EngineConfig(use_pallas=True))
    for grid in ("dense", "worklist", "device_worklist"):
        cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid,
                                  vmem_budget_bytes=TILED_LANE_BUDGET)
        (res, stats, _), row = drive(
            f"lanes_tiled_{grid}", "lanes_min",
            lambda: apps.batched_queries(g, queries, part=part, cfg=cfg))
        for q, (got, want_q) in enumerate(zip(res, pinned)):
            check(np.array_equal(got, want_q),
                  f"lane {q} tiled {grid} differs from its K3 run at "
                  f"{int((got != want_q).sum())} vertices")
        check(all(torch.equal(a, b) for a, b in zip(stats, pstats)),
              f"lanes tiled {grid}: LaneStats differ from the K3 run")
        rounds = int(stats.rounds.max())
        if grid == "device_worklist":
            windows = -(-rounds // cfg.device_window)
            only(row, "k8", windows * cfg.device_window,
                 f"lanes tiled {grid}")
        else:
            only(row, "k7" if grid == "dense" else "k8", rounds,
                 f"lanes tiled {grid}")
        row.update(rounds=rounds)
        log(f"[tiled] Q={LANES} {grid} at vmem_budget_bytes="
            f"{TILED_LANE_BUDGET}: every lane bit-equal to the K3 run, "
            f"LaneStats equal; {rounds} rounds, K7 {row['k7']} / K8 "
            f"{row['k8']} launches, {row['host_syncs']} host syncs, wall "
            f"{row['wall_s']:.3f} s")

    # replay the heaviest rounds for timings
    k5, k6, err = _time_tiled_kernels(torch, np, dev, part, arrays, root)
    k7, k8, err_l = _time_tiled_lane_kernels(torch, np, dev, part, arrays,
                                             queries)
    report.update(k5=k5, k6=k6, k7=k7, k8=k8)
    log(f"[tiled] heaviest SSSP round ({k5['round']} of {k5['rounds']}, "
        f"{k5['active_edges']} active edges, {k5['cells']} cells): K5 relax "
        f"phase {k5['ms']:.4f} ms (pinned {k5['pinned_phase_ms']:.4f} ms), "
        f"kernel {k5['kernel_ms']:.4f} ms ({k5['rows']} staged rows = "
        f"{k5['dma_bytes']} B; the reference's {k5['tiles']} tiles of vblk "
        f"{k5['vblk']} would copy {k5['reference_tile_copies']} = "
        f"{k5['reference_tile_bytes']} B) against K1 {k5['pinned_ms']:.4f} "
        f"ms; plain {k5['plain_ms']:.4f} ms, scatter_reduce_ amin "
        f"{k5['library_ms']:.4f} ms, bound {k5['bound_ms']:.4f} ms")
    log(f"[tiled] same round, K6 host plan ({k6['cells']} cells, "
        f"{k6['rows']} staged rows = {k6['dma_bytes']} B; tiled planner "
        f"{k6['plan_ms']:.1f} ms, pinned {k6['pinned_plan_ms']:.1f} ms): K6 "
        f"{k6['kernel_ms']:.4f} ms against K2 {k6['pinned_ms']:.4f} ms; "
        f"device plan ({k6['device_cells']} cells) K6 "
        f"{k6['device_kernel_ms']:.4f} ms against K2 "
        f"{k6['pinned_device_kernel_ms']:.4f} ms; relax phase "
        f"{k6['ms']:.4f} ms against {k6['pinned_phase_ms']:.4f} (device plan "
        f"{k6['device_ms']:.4f} against {k6['pinned_device_ms']:.4f}), plain "
        f"{k6['plain_ms']:.4f} ms; K6 by piece size (host/device plan ms): "
        + _sweep_text(k6["piece_sweep"]))
    log(f"[tiled] heaviest Q={LANES} round ({k7['round']} of "
        f"{k7['rounds']}, {k7['active_pairs']} active pairs, {k7['cells']} "
        f"cells): K7 relax phase {k7['ms']:.4f} ms (pinned "
        f"{k7['pinned_phase_ms']:.4f} ms), kernel {k7['kernel_ms']:.4f} ms "
        f"({k7['rows']} staged rows = {k7['dma_bytes']} B; the reference's "
        f"{k7['tiles']} tiles of vblk {k7['vblk']} would copy "
        f"{k7['reference_tile_copies']} = {k7['reference_tile_bytes']} B) "
        f"against K3 {k7['pinned_ms']:.4f} ms; plain {k7['plain_ms']:.4f} "
        f"ms, index_reduce_ amin {k7['library_ms']:.4f} ms, bound "
        f"{k7['bound_ms']:.4f} ms")
    log(f"[tiled] same round, K8 host plan ({k8['cells']} cells, "
        f"{k8['rows']} staged rows = {k8['dma_bytes']} B; tiled planner "
        f"{k8['plan_ms']:.1f} ms, pinned {k8['pinned_plan_ms']:.1f} ms): K8 "
        f"{k8['kernel_ms']:.4f} ms against K4 {k8['pinned_ms']:.4f} ms; "
        f"device plan ({k8['device_cells']} cells) K8 "
        f"{k8['device_kernel_ms']:.4f} ms against K4 "
        f"{k8['pinned_device_kernel_ms']:.4f} ms; relax phase "
        f"{k8['ms']:.4f} ms against {k8['pinned_phase_ms']:.4f} (device plan "
        f"{k8['device_ms']:.4f} against {k8['pinned_device_ms']:.4f}), plain "
        f"{k8['plain_ms']:.4f} ms; K8 by piece size (host/device plan ms): "
        + _sweep_text(k8["piece_sweep"]))
    return launches, {"K5": err, "K6": err, "K7": err_l, "K8": err_l}, report


# --------------------------------------------------------------------------
# phase 8: the compact targeted exchange (8a) and the query server (8b)
# --------------------------------------------------------------------------

# each kernel's launch counter: (module, attribute)
_COUNTERS = {"K1": ("frr", "launches"), "K2": ("frr", "wl_launches"),
             "K3": ("frr", "lanes_launches"),
             "K4": ("frr", "wl_lanes_launches"),
             "K5": ("frr", "tiled_launches"),
             "K6": ("frr", "wl_tiled_launches"),
             "K7": ("frr", "tiled_lanes_launches"),
             "K8": ("frr", "wl_tiled_lanes_launches"),
             "K9": ("rsr", "launches")}
SERVE_LANES, SERVE_PPR_LANES = 16, 8
SERVE_PPR_DAMPINGS = (0.85, 0.7)
# the delta rounds prune residuals below tol; at 1e-8 what they leave
# exceeds atol 1e-7 against the float64 oracle (7.6e-7 on the H100), so
# the stream asks 1e-10, phase 6's delta-PPR tolerance
SERVE_PPR_TOL = 1e-10
# (exchange, grid_mode, tick_rounds) of the three serving runs
SERVE_RUNS = (("dense", "device_worklist", 8),
              ("compact", "device_worklist", 8),
              ("compact", "dense", 1))


def _run_counter(torch, report, launches):
    """``drive(key, run, call)``: run ``call`` with every kernel's launch
    count set to 0 just before it and read just after (added to
    ``launches``), and the engine's dispatch / host-sync counters of
    ``run`` read around it; returns (result, row)."""
    from repro_torch import obs
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    mods = {"frr": frr, "rsr": rsr}
    reg = obs.registry()

    def drive(key, run, call):
        d = reg.counter("engine_dispatches_total").labels(run=run)
        h = reg.counter("engine_host_syncs_total").labels(run=run)
        d0, h0 = d.value, h.value
        for mod, attr in _COUNTERS.values():
            setattr(mods[mod], attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        row = {"wall_s": time.perf_counter() - t0,
               "dispatches": d.value - d0, "host_syncs": h.value - h0}
        for k, (mod, attr) in _COUNTERS.items():
            row[k] = getattr(mods[mod], attr)
            launches[k] += row[k]
        report["runs"][key] = row
        return res, row

    return drive


def _plan_shape(frr, plan):
    """Blocks, cells and real pieces of a launch plan."""
    pc = frr.plan_pieces(plan)
    return {"segments": plan.num_segments, "blocks": plan.num_blocks,
            "cells": plan.num_cells,
            "pieces": int((pc.piece_blk >= 0).sum()),
            "split_rows": pc.n_split}


def _heaviest(step, state, count):
    """Replay a fixpoint with ``step(state) -> (state, active count)``
    until ``count(state)`` is 0; returns (the entering state of the round
    with the most active edges (or pairs), its round, rounds run)."""
    best, rnd = None, 0
    while count(state):
        rnd += 1
        nxt, n = step(state)
        n = int(n)
        if best is None or n > best[0]:
            best = (n, rnd, state)
        state = nxt
    return best[2], best[1], rnd


def _compact_kernels(torch, np, dev, part, part_pr, root):
    """Replay the heaviest compact round and hold K1, K2 (device plan),
    K3 and K9 on the compact plan to their plain versions — min bit for
    bit, sum (PageRank round: K1 mul_w/sum and K9's sum) within rtol 1e-5
    / atol 1e-6 — and time each against the same kernel on the dense plan
    of that round, its byte bound (the compact inbox written counted in),
    and its library call; also the inbox scatter's cost."""
    from repro_torch import exchange
    from repro_torch.core import actions, engine
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    from repro_torch.kernels.ref import (fused_relax_reduce_ref,
                                         segment_combine_ref)

    out = {}
    arrays = engine.DeviceArrays.from_partition(part, dev)
    cfg = engine.EngineConfig(use_pallas=True, exchange="compact")
    S, R_max = part.S, part.R_max
    nseg_c, nseg_d = S * S * part.P_t, S * R_max
    cplan, dplan = arrays.compact.plan, arrays.fused_plan
    cids, dids = arrays.compact.ids, arrays.edge_dst_flat.reshape(-1)
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K9": 0.0}

    # the heaviest SSSP round on the compact exchange
    sem = actions.SSSP
    v0 = torch.as_tensor(engine.init_values(part, sem, {root: 0.0}),
                         device=dev)
    c0 = (v0 < math.inf) & arrays.slot_valid

    def step(st):
        val, chg, n = exchange.fixpoint_round_stacked(
            sem, arrays, cfg, S, R_max, *st)
        return (val, chg), n

    (val, chg), rnd, rounds = _heaviest(step, (v0, c0),
                                        lambda st: bool(st[1].any()))
    gval, gchg = val.reshape(-1), chg.reshape(-1)
    gval_m = frr._masked_value_tables(gval, gchg, math.inf)
    chunk_act, count = frr._chunk_tables(src, mask, gchg)
    n_active = int(count)
    for name, launch in (
            ("K1", lambda plan, ids, dbg=False: frr._launch(
                gval_m, src, w, mask, ids, plan, chunk_act, "add_w", "min",
                dbg)),
            ("K2", lambda plan, ids, dbg=False: frr._launch_wl(
                gval_m, src, w, mask, ids, plan, chunk_act, None, "add_w",
                "min", dbg))):
        got, _ = launch(cplan, cids)
        plain = fused_relax_reduce_ref(gval, gchg, src, w, mask, cids,
                                       nseg_c, "add_w", "min")
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"{name} on the compact plan differs "
              f"from its plain version (SSSP round {rnd})")
        err[name] = max(err[name], max_abs_err(torch, got, plain))
        bound, by = _round_bound_ms(part, "add_w", n_active, nseg_c)
        out[name.lower()] = {
            "round": rnd, "rounds": rounds, "active_edges": n_active,
            "kernel_ms": time_ms(torch, lambda: launch(cplan, cids)),
            "dense_plan_kernel_ms": time_ms(torch, lambda: launch(dplan,
                                                                  dids)),
            "ms": time_ms(torch, lambda: ops.fused_relax_reduce(
                gval, gchg, src, w, mask, cids, nseg_c, "add_w", "min",
                plan=cplan, grid_mode="dense" if name == "K1"
                else "device_worklist")),
            "plain_ms": time_ms(torch, lambda: fused_relax_reduce_ref(
                gval, gchg, src, w, mask, cids, nseg_c, "add_w", "min"),
                reps=5),
            "bound_ms": bound, "bound_by": by,
            "dense_bound_ms": _round_bound_ms(part, "add_w", n_active)[0]}
    active = mask & gchg[src.long()]
    msg = torch.where(active, gval[src.long()] + w,
                      torch.tensor(math.inf, device=dev))
    lib = _library_ms(torch, "min", cids.long(), msg, nseg_c)
    out["k1"]["library_ms"] = out["k2"]["library_ms"] = lib
    # K9 on the compact plan, min (this round) and sum (a PageRank round)
    got = rsr.segment_combine(msg, cids, nseg_c, "min", plan=cplan)
    plain = segment_combine_ref(msg, cids, nseg_c, "min")
    torch.cuda.synchronize()
    check(torch.equal(got, plain), "K9 on the compact plan differs from its "
          f"plain version (SSSP round {rnd})")
    err["K9"] = max_abs_err(torch, got, plain)
    e = msg.shape[0]
    out["k9"] = {
        "round": rnd, "messages": e,
        "kernel_ms": time_ms(torch, lambda: rsr._launch(
            msg, cids, cplan, "min", False)),
        "dense_plan_kernel_ms": time_ms(torch, lambda: rsr._launch(
            msg, dids, dplan, "min", False)),
        "ms": time_ms(torch, lambda: ops.segment_combine(
            msg, cids, nseg_c, "min", plan=cplan)),
        "plain_ms": time_ms(torch, lambda: segment_combine_ref(
            msg, cids, nseg_c, "min"), reps=5),
        "library_ms": lib}
    out["k9"]["bound_ms"], out["k9"]["bound_by"] = _segment_bound_ms(
        e, nseg_c)
    out["k9"]["dense_bound_ms"] = _segment_bound_ms(e, nseg_d)[0]

    arr_pr = engine.DeviceArrays.from_partition(part_pr, dev)
    cplan_pr, cids_pr = arr_pr.compact.plan, arr_pr.compact.ids
    src_p = arr_pr.edge_src_root_flat.reshape(-1)
    w_p = arr_pr.edge_w.reshape(-1)
    mask_p = arr_pr.edge_mask.reshape(-1)
    pv = torch.where(arr_pr.slot_valid, 1.0 / part_pr.n, 0.0).reshape(-1)
    pc = arr_pr.slot_valid.reshape(-1)
    nseg_p = part_pr.S * part_pr.S * part_pr.P_t
    got = ops.fused_relax_reduce(pv, pc, src_p, w_p, mask_p, cids_pr, nseg_p,
                                 "mul_w", "sum", plan=cplan_pr)[0]
    plain = fused_relax_reduce_ref(pv, pc, src_p, w_p, mask_p, cids_pr,
                                   nseg_p, "mul_w", "sum")
    pmsg = torch.where(mask_p & pc[src_p.long()], pv[src_p.long()] * w_p,
                       torch.zeros((), device=dev))
    got9 = rsr.segment_combine(pmsg, cids_pr, nseg_p, "sum", plan=cplan_pr)
    plain9 = segment_combine_ref(pmsg, cids_pr, nseg_p, "sum")
    torch.cuda.synchronize()
    for name, a, b in (("K1", got, plain), ("K9", got9, plain9)):
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
              f"{name} sum on the compact plan off its plain version by "
              f"{max_abs_err(torch, a, b)}")
        err[name] = max(err[name], max_abs_err(torch, a, b))
    out["k9"]["sum_kernel_ms"] = time_ms(torch, lambda: rsr._launch(
        pmsg, cids_pr, cplan_pr, "sum", False))
    out["k9"]["sum_library_ms"] = _library_ms(torch, "sum", cids_pr.long(),
                                              pmsg, nseg_p)

    return out, err, arrays


def _compact_lane_kernel(torch, np, dev, part, arrays, queries, out, err):
    """K3 on the compact plan at the heaviest Q = 16 compact round, held
    to its plain version bit for bit and timed against K3 on the dense
    plan of the round, its bound (the 144 MB laned compact inbox counted
    in) and ``index_reduce_``; and the inbox scatter's cost at Q = 16
    (one scatter a source in source order, the repeatable sum) against
    one ``index_add_`` over all sources."""
    from repro_torch import exchange
    from repro_torch.core import actions, engine
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (_lane_messages,
                                         fused_relax_reduce_lanes_ref)
    from repro_torch.query import lanes
    S, R_max = part.S, part.R_max
    nseg_c = S * S * part.P_t
    cfg = engine.EngineConfig(use_pallas=True, exchange="compact")
    cplan, dplan = arrays.compact.plan, arrays.fused_plan
    cids, dids = arrays.compact.ids, arrays.edge_dst_flat.reshape(-1)
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    init, unitw = lanes.init_lane_values(part, queries)
    v0 = torch.as_tensor(init, device=dev)
    unitw = torch.as_tensor(unitw, device=dev)
    c0 = (v0 < math.inf) & arrays.slot_valid[..., None]

    def step(st):
        val, chg, n = exchange.fixpoint_round_stacked(
            actions.SSSP, arrays, cfg, S, R_max, *st, unitw)
        return (val, chg), n.sum()

    (val, chg), rnd, rounds = _heaviest(step, (v0, c0),
                                        lambda st: bool(st[1].any()))
    q = val.shape[-1]
    gval, gchg = val.reshape(-1, q), chg.reshape(-1, q)
    gval_m = frr._masked_value_tables(gval, gchg, math.inf)
    unit_u8 = (unitw != 0).to(torch.uint8)
    chunk_act, counts = frr._lane_chunk_tables(src, mask, gchg,
                                               cplan.src_deg)
    dchunk_act, _ = frr._lane_chunk_tables(src, mask, gchg, dplan.src_deg)

    def launch(plan, ids, act):
        return frr._launch_lanes(gval_m, unit_u8, src, w, mask, ids, plan,
                                 act, "add_w", "min", False)[0]

    got = launch(cplan, cids, chunk_act)
    plain = fused_relax_reduce_lanes_ref(gval, gchg, unitw, src, w, mask,
                                         cids, nseg_c, "add_w", "min")
    torch.cuda.synchronize()
    check(torch.equal(got, plain), "K3 on the compact plan differs from its "
          f"plain version (Q = {q} round {rnd})")
    err["K3"] = max_abs_err(torch, got, plain)
    n_edges = int((mask & gchg.any(dim=1)[src.long()]).sum())
    n_pairs = int(counts.sum())
    bound, by = _lane_round_bound_ms(part, n_edges, n_pairs, q, nseg_c)
    msg = _lane_messages(gval, gchg, unitw, src, w, mask, "add_w", "min")
    cids_long = cids.long()
    out["k3"] = {
        "round": rnd, "rounds": rounds, "lanes": q,
        "active_edges": n_edges, "active_pairs": n_pairs,
        "kernel_ms": time_ms(torch, lambda: launch(cplan, cids, chunk_act)),
        "dense_plan_kernel_ms": time_ms(torch, lambda: launch(
            dplan, dids, dchunk_act)),
        "ms": time_ms(torch, lambda: ops.fused_relax_reduce_lanes(
            gval, gchg, unitw, src, w, mask, cids, nseg_c, "add_w", "min",
            plan=cplan)),
        "plain_ms": time_ms(torch, lambda: fused_relax_reduce_lanes_ref(
            gval, gchg, unitw, src, w, mask, cids, nseg_c, "add_w", "min"),
            reps=3),
        "library_ms": time_ms(torch, lambda: torch.full(
            (nseg_c, q), math.inf, device=dev).index_reduce_(
                0, cids_long, msg, "amin", include_self=True), reps=5),
        "bound_ms": bound, "bound_by": by,
        "dense_bound_ms": _lane_round_bound_ms(part, n_edges, n_pairs,
                                               q)[0],
        "inbox_bytes": nseg_c * q * 4}

    # the inbox scatter at Q = 16: sum in source order, and min
    part_sum = torch.rand((S, S, part.P_t, q), device=dev)
    smap, index = arrays.inbox_slot_map, arrays.compact.inbox_index
    scat = {"contributions": int((smap < R_max).sum())}
    for sem in (actions.PAGERANK, actions.SSSP):
        def scatter(sem=sem):
            return exchange.scatter_inbox(sem, part_sum.transpose(0, 1),
                                          smap, R_max, index)
        a, b = scatter(), scatter()
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"scatter_inbox ({sem.segment}) does not "
              "repeat bit for bit")
        scat[sem.segment] = time_ms(torch, scatter, reps=10)
    flat_idx = index.reshape(-1)
    scat["one_index_add"] = time_ms(torch, lambda: torch.zeros(
        (S * (R_max + 1), q), device=dev).index_add_(
            0, flat_idx, part_sum.reshape(-1, q)), reps=10)
    scat["collapse_min"] = time_ms(torch, lambda: exchange.stacked_collapse(
        actions.SSSP, arrays, cfg, val), reps=10)
    out["k3"]["scatter"] = scat


def phase_compact(torch, np, dev, g, part, root, want, part_pr, want_pr,
                  want_conv):
    """8a: BFS / SSSP / PageRank / delta-PageRank / reduce / lanes / tiled
    under ``exchange='compact'`` at RMAT-18, held to the oracles and to
    the dense-exchange runs' counters; then the kernels on the compact
    plan (``_compact_kernels``, ``_compact_lane_kernel``)."""
    from repro_torch import apps
    from repro_torch.core import engine
    from repro_torch.kernels import fused_relax_reduce as frr

    report = {"runs": {}}
    launches = {k: 0 for k in _COUNTERS}
    drive = _run_counter(torch, report, launches)
    arrays = engine.DeviceArrays.from_partition(part, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cplan = arrays.compact.plan
    torch.cuda.synchronize()
    plan_ms = 1e3 * (time.perf_counter() - t0)
    win = part.S * part.P_t
    shapes = {"compact": _plan_shape(frr, cplan),
              "dense": _plan_shape(frr, arrays.fused_plan)}
    straddle = sum(1 for i in range(cplan.num_blocks)
                   if (i * frr.SBLK) // win
                   != min((i + 1) * frr.SBLK - 1, part.S * win - 1) // win)
    report.update(P_t=part.P_t, R_rz_max=part.R_rz_max, plans=shapes,
                  compact_plan_ms=plan_ms, straddling_blocks=straddle)
    log(f"[compact] S={part.S} R_max={part.R_max} P_t={part.P_t} "
        f"R_rz_max={part.R_rz_max}; a source window is S*P_t = {win} "
        f"segments ({win % frr.SBLK} past a block edge: {straddle} blocks "
        f"straddle two windows); compact plan (built in {plan_ms:.1f} ms, "
        f"on first use): {shapes['compact']}; dense plan: {shapes['dense']}")

    # BFS and SSSP under the three launch shapes, dense vs compact
    for grid in ("dense", "worklist", "device_worklist"):
        for name in ("bfs", "sssp"):
            runs = {}
            for exch in ("dense", "compact"):
                cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid,
                                          exchange=exch)
                (got, st, _), row = drive(
                    f"{name}_{grid}_{exch}", name,
                    lambda: getattr(apps, name)(g, root, part=part, cfg=cfg))
                check(np.array_equal(got, want[name]),
                      f"{name} {grid} {exch} differs from the oracle at "
                      f"{int((got != want[name]).sum())} vertices")
                row.update(rounds=int(st.iterations),
                           messages=int(st.messages),
                           pruned=int(st.pruned_actions))
                runs[exch] = row
            c, d = runs["compact"], runs["dense"]
            check((c["rounds"], c["messages"], c["pruned"])
                  == (d["rounds"], d["messages"], d["pruned"]),
                  f"{name} {grid}: compact rounds/messages/pruned "
                  f"{c['rounds']}/{c['messages']}/{c['pruned']}, dense "
                  f"{d['rounds']}/{d['messages']}/{d['pruned']}")
            key = "K1" if grid == "dense" else "K2"
            check(c[key] > 0 and c[key] == d[key],
                  f"{name} {grid}: {key} launches compact {c[key]}, "
                  f"dense {d[key]}")
            log(f"[compact] {name} {grid}: equal to the oracle; rounds "
                f"{c['rounds']}, messages {c['messages']}, pruned "
                f"{c['pruned']} as on the dense exchange; {key} launches "
                f"{c[key]}; fixpoint wall {c['wall_s']:.3f} s (dense "
                f"exchange {d['wall_s']:.3f} s, setup included)")

    # PageRank (30 rounds, K1's sum) and delta-PageRank (device plan)
    cfg = engine.EngineConfig(use_pallas=True, exchange="compact")
    (got, _), row = drive("pagerank", "pagerank", lambda: apps.pagerank(
        g, iters=PR_ITERS, part=part_pr, cfg=cfg))
    row["max_abs_diff"] = float(np.abs(got - want_pr).max())
    check(np.allclose(got, want_pr, rtol=PR_RTOL, atol=PR_ATOL)
          and row["K1"] == PR_ITERS,
          f"compact pagerank off the oracle by {row['max_abs_diff']} "
          f"({row['K1']} K1 launches)")
    log(f"[compact] pagerank: {PR_ITERS} rounds within rtol {PR_RTOL} / "
        f"atol {PR_ATOL} of the oracle (max |diff| "
        f"{row['max_abs_diff']:.3g}), {row['K1']} K1 launches, wall "
        f"{row['wall_s']:.3f} s")
    cfg = engine.EngineConfig(use_pallas=True, exchange="compact",
                              grid_mode="device_worklist")
    (got, st, _), row = drive(
        "pagerank_delta", "pagerank_delta", lambda: apps.pagerank_delta(
            g, tol=PR_TOL, part=part_pr, cfg=cfg))
    row.update(rounds=int(st.iterations), messages=int(st.messages),
               max_abs_diff=float(np.abs(got - want_conv).max()))
    check(np.allclose(got, want_conv, rtol=PR_RTOL, atol=PR_ATOL)
          and row["K2"] >= row["rounds"],
          f"compact pagerank_delta off the oracle by {row['max_abs_diff']}")
    log(f"[compact] pagerank_delta device_worklist: {row['rounds']} rounds "
        f"within rtol {PR_RTOL} / atol {PR_ATOL} of the oracle (max |diff| "
        f"{row['max_abs_diff']:.3g}), {row['K2']} K2 launches, "
        f"{row['host_syncs']} host syncs, wall {row['wall_s']:.3f} s")

    # BFS under pallas_mode='reduce': K9 on the compact plan
    cfg = engine.EngineConfig(use_pallas=True, pallas_mode="reduce",
                              exchange="compact")
    (got, st, _), row = drive("bfs_reduce", "bfs", lambda: apps.bfs(
        g, root, part=part, cfg=cfg))
    check(np.array_equal(got, want["bfs"])
          and row["K9"] == int(st.iterations),
          f"compact reduce bfs: {row['K9']} K9 launches, "
          f"{int((got != want['bfs']).sum())} vertices off the oracle")
    log(f"[compact] bfs reduce: equal to the oracle; {row['K9']} K9 "
        f"launches, wall {row['wall_s']:.3f} s")

    # Q = 16 lanes: every lane equal to the dense-exchange lane
    deg = np.argsort(-g.out_degrees(), kind="stable")
    roots = [int(v) for v in deg[:LANES]]
    queries = [("bfs", r) for r in roots[:LANES // 2]] + \
        [("sssp", r) for r in roots[LANES // 2:]]
    vol = part.S * part.S * part.P_t
    for grid, key in (("dense", "K3"), ("device_worklist", "K4")):
        res = {}
        for exch in ("dense", "compact"):
            cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid,
                                      exchange=exch)
            (vals, st, _), row = drive(
                f"lanes_{grid}_{exch}", "lanes_min",
                lambda: apps.batched_queries(g, queries, part=part,
                                             cfg=cfg))
            res[exch] = (vals, st, row)
        (vc, sc, rc), (vd, sd, rd) = res["compact"], res["dense"]
        for q in range(LANES):
            check(np.array_equal(vc[q], vd[q]),
                  f"lane {q} {grid}: compact differs from the dense "
                  f"exchange at {int((vc[q] != vd[q]).sum())} vertices")
        check(sc.rounds.tolist() == sd.rounds.tolist()
              and sc.messages.tolist() == sd.messages.tolist(),
              f"lanes {grid}: compact rounds/messages differ from dense")
        check((sc.exchanged == sc.rounds * vol).all().item(),
              f"lanes {grid}: exchanged is not live lane-rounds x S*S*P_t")
        check(rc[key] > 0, f"lanes {grid}: {key} never launched")
        log(f"[compact] Q={LANES} lanes {grid}: every lane bit-equal to the "
            f"dense exchange's, rounds and messages equal; exchanged "
            f"{int(sc.exchanged.sum())} = live lane-rounds x {vol} (dense "
            f"{int(sd.exchanged.sum())}); {key} launches {rc[key]}; wall "
            f"{rc['wall_s']:.3f} s (dense exchange {rd['wall_s']:.3f} s)")

    # the tiled path (K5, K6) on the compact ids against the pinned run
    for grid, key in (("dense", "K5"), ("device_worklist", "K6")):
        cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid,
                                  exchange="compact",
                                  vmem_budget_bytes=TILED_BUDGET)
        (got, st, _), row = drive(f"sssp_tiled_{grid}", "sssp",
                                  lambda: apps.sssp(g, root, part=part,
                                                    cfg=cfg))
        pinned = report["runs"][f"sssp_{grid}_compact"]
        check(np.array_equal(got, want["sssp"]) and row[key] > 0
              and int(st.iterations) == pinned["rounds"]
              and int(st.messages) == pinned["messages"],
              f"compact tiled sssp {grid}: {row[key]} {key} launches")
        log(f"[compact] sssp tiled ({TILED_BUDGET} B budget) {grid}: equal "
            f"to the pinned run and the oracle; {row[key]} {key} launches")

    out, err, arrays = _compact_kernels(torch, np, dev, part, part_pr, root)
    _compact_lane_kernel(torch, np, dev, part, arrays, queries, out, err)
    report.update(out)
    for k in ("k1", "k2", "k9"):
        r = out[k]
        log(f"[compact-kernel] {k.upper()} on the compact plan, heaviest "
            f"SSSP round {r['round']}: {r['kernel_ms']:.4f} ms (dense plan, "
            f"same round {r['dense_plan_kernel_ms']:.4f}); relax phase "
            f"{r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms (dense "
            f"{r['dense_bound_ms']:.4f}); plain {r['plain_ms']:.4f} ms; "
            f"library {r['library_ms']:.4f} ms")
    r = out["k9"]
    log(f"[compact-kernel] K9 sum on the compact plan (PageRank round): "
        f"{r['sum_kernel_ms']:.4f} ms, index_add_ {r['sum_library_ms']:.4f} "
        f"ms")
    r = out["k3"]
    log(f"[compact-kernel] K3 on the compact plan, heaviest Q={r['lanes']} "
        f"round {r['round']} ({r['active_pairs']} active pairs): "
        f"{r['kernel_ms']:.4f} ms (dense plan {r['dense_plan_kernel_ms']:.4f})"
        f"; relax phase {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
        f"(inbox {r['inbox_bytes']} B; dense {r['dense_bound_ms']:.4f}); "
        f"plain {r['plain_ms']:.4f} ms; index_reduce_ amin "
        f"{r['library_ms']:.4f} ms")
    s = r["scatter"]
    log(f"[compact-kernel] inbox scatter at Q={r['lanes']} "
        f"({s['contributions']} (source, target, slot) contributions): "
        f"sum, an index_add_ a source in source order {s['sum']:.4f} ms; "
        f"min, one scatter_reduce_ amin {s['min']:.4f} ms; one index_add_ "
        f"over all sources (float atomics, no fixed order) "
        f"{s['one_index_add']:.4f} ms; compact collapse (min) "
        f"{s['collapse_min']:.4f} ms")
    return launches, err, report


def _percentile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(p / 100 * len(xs))) - 1)]


def phase_serving(torch, np, dev, g, part_pr, want):
    """8b: one request stream (16 BFS, 8 SSSP, 8 reachability, then 8 PPR,
    in four waves submitted between ticks) through a ``QueryServer`` on
    the PageRank partition of RMAT-18, three ways (``SERVE_RUNS``):
    every min result equal to its solo run bit for bit (the root's BFS
    equal to the numpy oracle, its SSSP within rtol 1e-5 of Dijkstra's
    float64 oracle on the 1/out-degree weights, as the reference's server
    test holds it), PPR within tolerance of the float64 oracle, rounds and
    messages equal across the runs; then the overload run's typed
    statuses.  The PPR pool needs the PageRank weights, so the server
    serves that partition."""
    from repro_torch import apps, query, serve
    from repro_torch.apps.pagerank import _pr_graph
    from repro_torch.core import engine
    from repro_torch.graph import reference
    from repro_torch.query.lanes import UNREACHED

    report = {"runs": {}}
    launches = {k: 0 for k in _COUNTERS}
    drive = _run_counter(torch, report, launches)
    g_pr = _pr_graph(g)
    deg = np.argsort(-g.out_degrees(), kind="stable")
    root = int(deg[0])
    waves = [[("bfs", int(v)) for v in deg[:16]],
             [("sssp", int(v)) for v in [deg[0], *deg[17:24]]],
             [("reachability", int(v)) for v in deg[24:32]],
             [("ppr", int(v), SERVE_PPR_DAMPINGS[i % 2])
              for i, v in enumerate(deg[:SERVE_PPR_LANES])]]
    t0 = time.perf_counter()
    cfg1 = engine.EngineConfig(use_pallas=True)
    solo = {}
    for kind, v in [r for w in waves[:3] for r in w]:
        app = apps.sssp if kind == "sssp" else apps.bfs
        if (app, v) not in solo:
            got, st, _ = app(g_pr, v, part=part_pr, cfg=cfg1)
            solo[(app, v)] = (got, int(st.iterations), int(st.messages))
    # the 1/out-degree weights are not integers, so SSSP meets Dijkstra's
    # float64 oracle within the reference server test's rtol 1e-5
    want_sssp = reference.sssp_dijkstra(g_pr, root)
    got_sssp = solo[(apps.sssp, root)][0]
    fin = np.isfinite(want_sssp)
    check(np.array_equal(solo[(apps.bfs, root)][0], want["bfs"]),
          "solo BFS on the PageRank partition differs from the oracle")
    check(np.array_equal(np.isfinite(got_sssp), fin)
          and np.allclose(got_sssp[fin], want_sssp[fin], rtol=1e-5),
          "solo SSSP on the PageRank partition off Dijkstra's oracle")
    seeds = [r[1] for r in waves[3]]
    want_ppr = _ppr_oracle(torch, np, g, seeds,
                           [r[2] for r in waves[3]], dev)
    log(f"[serve] {len(solo)} solo runs, the root's SSSP oracle on the "
        f"PageRank weights and the float64 PPR oracle: "
        f"{time.perf_counter() - t0:.1f} s")

    per_run = {}
    for exch, grid, k in SERVE_RUNS:
        cfg = engine.EngineConfig(use_pallas=True, exchange=exch,
                                  grid_mode=grid)
        t0 = time.perf_counter()
        srv = query.QueryServer(part_pr, n_lanes=SERVE_LANES,
                                ppr_lanes=SERVE_PPR_LANES, cfg=cfg,
                                tick_rounds=k)
        setup_s = time.perf_counter() - t0
        qids = {}

        def stream(srv=srv, qids=qids):
            for i, wave in enumerate(waves):
                for req in wave:
                    kw = ({"damping": req[2], "tol": SERVE_PPR_TOL}
                          if req[0] == "ppr" else {})
                    qids[srv.submit(req[0], req[1], **kw)] = req
                if i < len(waves) - 1:
                    srv.step()
            return srv.run()

        key = f"{exch}_{grid}_k{k}"
        syncs0 = srv.host_syncs
        res, row = drive(f"serve_{key}", "server_min", stream)
        check(len(res) == 40 and all(r.status == "ok"
                                     for r in res.values()),
              f"serve {key}: {len(res)} results, statuses "
              f"{sorted({r.status for r in res.values()})}")
        vol = srv.min_pool.exchange_volume
        for qid, req in qids.items():
            r = res[qid]
            check(r.exchanged == r.rounds * vol, f"serve {key} q{qid}: "
                  "exchanged is not rounds x the exchange volume")
            if req[0] == "ppr":
                col = want_ppr[:, seeds.index(req[1])]
                check(np.allclose(r.values, col, rtol=PR_RTOL,
                                  atol=PR_ATOL),
                      f"serve {key} ppr {req[1]}: off the oracle by "
                      f"{float(np.abs(r.values - col).max())}")
                continue
            app = apps.sssp if req[0] == "sssp" else apps.bfs
            sv, sr, sm = solo[(app, req[1])]
            if req[0] == "reachability":
                sv = sv != UNREACHED
            check(np.array_equal(r.values, sv) and r.rounds == sr
                  and r.messages == sm,
                  f"serve {key} {req[0]} {req[1]}: differs from its solo "
                  f"run (rounds {r.rounds}/{sr}, messages {r.messages}/{sm})")
        lat = [r.latency_s * 1e3 for r in res.values()]
        lat_t = [r.completed_tick - r.submitted_tick for r in res.values()]
        summary = {
            "setup_s": setup_s, "wall_s": row["wall_s"],
            "requests_per_s": len(res) / row["wall_s"],
            "ticks": srv.tick, "rounds_driven": srv.rounds_driven,
            "ms_per_tick": 1e3 * row["wall_s"] / srv.tick,
            "latency_ms_p50": _percentile(lat, 50),
            "latency_ms_p99": _percentile(lat, 99),
            "latency_ticks_p50": _percentile(lat_t, 50),
            "latency_ticks_p99": _percentile(lat_t, 99),
            "host_syncs": srv.host_syncs - syncs0,
            "host_syncs_per_tick": (srv.host_syncs - syncs0) / srv.tick,
            "occupancy": srv.occupancy(),
            "launches": {kk: row[kk] for kk in ("K3", "K4") if row[kk]},
            "trace": {qid: (r.rounds, r.messages)
                      for qid, r in res.items()}}
        lane_key = "K4" if grid == "device_worklist" else "K3"
        other = "K3" if lane_key == "K4" else "K4"
        check(row[lane_key] > 0 and row[other] == 0,
              f"serve {key}: K3 {row['K3']} / K4 {row['K4']} launches")
        per_run[key] = summary
        log(f"[serve] {key}: 40 requests answered, min results equal to "
            f"their solo runs, PPR within tolerance; {srv.tick} ticks, "
            f"{srv.rounds_driven} pool rounds; {summary['requests_per_s']:.1f}"
            f" requests/s, latency p50/p99 {summary['latency_ms_p50']:.1f}/"
            f"{summary['latency_ms_p99']:.1f} ms "
            f"({summary['latency_ticks_p50']}/"
            f"{summary['latency_ticks_p99']} ticks), "
            f"{summary['ms_per_tick']:.2f} ms a tick, "
            f"{summary['host_syncs_per_tick']:.2f} host reads a tick, mean "
            f"occupancy {summary['occupancy']:.3f}; {lane_key} launches "
            f"{row[lane_key]}; server set-up {setup_s:.3f} s")
    traces = [s.pop("trace") for s in per_run.values()]
    check(all(t == traces[0] for t in traces),
          "rounds and messages differ between the serving runs")
    report["serve"] = per_run

    # host reads of a tick, counted by CUDA's sync-debug warnings
    import warnings
    srv = query.QueryServer(part_pr, n_lanes=SERVE_LANES,
                            ppr_lanes=SERVE_PPR_LANES,
                            cfg=engine.EngineConfig(use_pallas=True,
                                                    exchange="compact"))
    for kind, v in waves[0][:4] + [(r[0], r[1]) for r in waves[3][:2]]:
        srv.submit(kind, v)
    srv.step()
    torch.cuda.synchronize()
    before = srv.host_syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                srv.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    reads = srv.host_syncs - before
    check(len(syncs) == reads,
          f"3 ticks: {len(syncs)} synchronizing CUDA calls, {reads} host "
          f"reads counted: " + "; ".join(
              sorted({str(w.message)[:120] for w in syncs})))
    report["tick_syncs"] = {"ticks": 3, "syncs": len(syncs)}
    log(f"[serve] 3 ticks under sync-debug mode 'warn': {len(syncs)} "
        f"synchronizing calls, each one of the server's {reads} counted "
        "host reads (live flags, then counts with exit flags, then a "
        "retiring lane's values)")

    # where a tick's time goes: torch.profiler over four ticks
    srv = query.QueryServer(part_pr, n_lanes=SERVE_LANES,
                            ppr_lanes=SERVE_PPR_LANES,
                            cfg=engine.EngineConfig(use_pallas=True,
                                                    exchange="compact"))
    for req in waves[0] + waves[3]:
        srv.submit(req[0], req[1])
    prof = _tick_profile(torch, srv)
    report["tick_profile"] = prof
    log(f"[serve-profile] {prof['ticks']} ticks of 16 BFS + 8 PPR lanes "
        f"(compact, dense, 1 round a tick), under torch.profiler: wall "
        f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
        f"({prof['busy']:.1%}), {prof['kernels']} kernels and copies; by "
        "device time: " + "; ".join(f"{n} {ms:.3f} ms x{c}"
                             for n, ms, c in prof["top"]))

    # the overload run: typed statuses
    clock = _FakeClock()
    srv = query.QueryServer(
        part_pr, n_lanes=SERVE_LANES, clock=clock,
        cfg=engine.EngineConfig(use_pallas=True, exchange="compact"),
        serve=serve.ServeConfig(
            max_queue=8, overload_policy="reject",
            faults=serve.FaultPlan(lane_failures=((1, "min", 1),))))
    got = overload_run(srv, clock, [int(v) for v in deg[:10]])
    check(got == OVERLOAD_STATUSES and srv.counters[
        "injected_lane_failures"] == 1,
          f"overload run: statuses {got}")
    report["overload"] = got
    log(f"[serve] overload run (queue 8, 'reject', a 1 s deadline, a lane "
        f"failure): statuses {got}")
    return launches, report


# --------------------------------------------------------------------------
# phase 9: streaming mutation and crash-safe fixpoints at RMAT-18
# --------------------------------------------------------------------------

MUT_BATCH1 = 41882           # a 1% insert batch (of 4,188,283 edges)
MUT_BATCH2, MUT_DELETES = 4096, 8
MUT_BATCH3 = 1024            # the serving run's third, insert-only commit
MUT_LANES = 16               # the served min lanes and LanesTask's Q
MUT_CKPT_EVERY = 2
MUT_TICKS = 10               # ticks after a commit: a wave's lanes end


def _mutation_batches(np, g):
    """Phase 9's three commits, from the seed: (inserts, deletes) each;
    inserted weights 1-9, deleted pairs drawn from the graph's edges."""
    rng = np.random.default_rng(SEED)

    def inserts(k):
        return (rng.integers(0, g.n, k).astype(np.int32),
                rng.integers(0, g.n, k).astype(np.int32),
                rng.integers(1, 10, k).astype(np.float32))

    first, second = inserts(MUT_BATCH1), inserts(MUT_BATCH2)
    idx = rng.choice(g.num_edges, MUT_DELETES, replace=False)
    dels = (g.src[idx].copy(), g.dst[idx].copy())
    return [(first, None), (second, dels), (inserts(MUT_BATCH3), None)]


def _buffer(sg, batch):
    ins, dels = batch
    sg.insert_edges(*ins)
    if dels is not None:
        sg.delete_edges(*dels)


def _snapshot(sg):
    """What a check needs of a StreamingGraph after a commit, kept before
    the next one: the graph, the base partition and the values."""
    return {"g": sg.g, "part": sg.view("base").part,
            "pr_part": (sg.view("pr").part if ("pagerank", None)
                        in sg.tracked else None),
            "vals": {k: st["vals"].copy() for k, st in sg.tracked.items()},
            "split": dict(sg.commit_seconds),
            "fixpoint_s": dict(sg.fixpoint_seconds)}


def _oracles(g, root, iters):
    """The numpy oracles of one graph (BFS levels, Dijkstra, float64
    PageRank) and their seconds, made in a worker process while the main
    one splices and drives the card."""
    from repro_torch.graph import reference
    t0 = time.perf_counter()
    out = {"bfs": reference.bfs_levels(g, root),
           "sssp": reference.sssp_dijkstra(g, root),
           "pr": reference.pagerank(g, 0.85, iters)}
    out["s"] = time.perf_counter() - t0
    return out


def _timed_manager(directory):
    """A port ``CheckpointManager`` whose writer's whole write (the
    ``.npy`` files, crc-32s, manifest fsync, rename and GC, on the
    writer thread) is timed: ``write_s`` sums it, ``writes`` counts it;
    ``save_s`` / ``saves`` do the same for ``save`` on the caller's
    thread (its wait for a previous write and the host copy) and
    ``restore_s`` / ``restores`` for ``restore``."""
    from repro_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        write_s, writes = 0.0, 0
        save_s, saves = 0.0, 0
        restore_s, restores = 0.0, 0

        def _write(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super()._write(*args, **kwargs)
            self.write_s += time.perf_counter() - t0
            self.writes += 1
            return out

        def save(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().save(*args, **kwargs)
            self.save_s += time.perf_counter() - t0
            self.saves += 1
            return out

        def restore(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().restore(*args, **kwargs)
            self.restore_s += time.perf_counter() - t0
            self.restores += 1
            return out
    return Timed(directory)


def _conv_iters():
    it = math.ceil(math.log(1e-6) / math.log(0.85))
    return it + 1 if 0.85 ** it >= 1e-6 else it


def _check_maintained(torch, np, dev, sg_cfg, snap, info, root, oracle,
                      name, k):
    """One commit of a tracked StreamingGraph: BFS/SSSP equal the numpy
    oracles on the new graph and a cold port fixpoint on the spliced
    partition bit for bit, with fewer warm messages than cold; PageRank
    within tolerance of the float64 oracle, with fewer warm messages than
    a cold delta-PageRank on the spliced view.  Each cold fixpoint is
    timed alone (synced, on arrays uploaded before the clock starts) as
    the commit timed its warm one.  Returns the log row."""
    from repro_torch.core import actions, engine
    from repro_torch.query.lanes import UNREACHED
    part, vals = snap["part"], snap["vals"]
    warm_s = snap["fixpoint_s"]
    row = {"split_s": snap["split"], "laned": "lanes" in warm_s,
           "maint": {}}
    lv = vals[("bfs", root)]
    levels = np.where(np.isfinite(lv), lv, 0).astype(np.int64)
    levels[~np.isfinite(lv)] = UNREACHED
    check(np.array_equal(levels, oracle["bfs"]),
          f"{name} commit {k}: BFS differs from the numpy oracle")
    dist, want = vals[("sssp", root)], oracle["sssp"]
    fin = np.isfinite(want)
    check(np.array_equal(np.isfinite(dist), fin)
          and np.array_equal(dist[fin], want[fin].astype(np.float32)),
          f"{name} commit {k}: SSSP differs from the numpy oracle")
    arrays = engine.DeviceArrays.from_partition(part, dev)
    for app, sem in (("bfs", actions.BFS), ("sssp", actions.SSSP)):
        init = engine.init_values(part, sem, {root: 0.0})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val, st = engine.run_stacked(sem, part, init, sg_cfg, device=dev,
                                     arrays=arrays)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        check(np.array_equal(engine.vertex_values(part, val),
                             vals[(app, root)]),
              f"{name} commit {k}: warm {app} differs from a cold "
              "fixpoint on the spliced partition")
        ms = info.maint[(app, root)]
        check(ms.messages < int(st.messages),
              f"{name} commit {k}: warm {app} sent {ms.messages} "
              f"messages, cold {int(st.messages)}")
        row["maint"][app] = {
            "warm_rounds": ms.rounds, "warm_messages": ms.messages,
            "seeds": ms.seeds, "invalidated": ms.invalidated,
            "cold_rounds": int(st.iterations),
            "cold_messages": int(st.messages), "cold_s": cold_s,
            "warm_s": warm_s.get((app, root), warm_s.get("lanes"))}
    if ("pagerank", None) in vals:
        got = vals[("pagerank", None)]
        diff = float(np.abs(got - oracle["pr"]).max())
        check(np.allclose(got, oracle["pr"], rtol=PR_RTOL, atol=PR_ATOL),
              f"{name} commit {k}: PageRank off the oracle by {diff}")
        ms = info.maint[("pagerank", None)]
        arrays_pr = engine.DeviceArrays.from_partition(snap["pr_part"], dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = engine.run_pagerank_delta(snap["pr_part"], 0.85, PR_TOL,
                                          sg_cfg, device=dev,
                                          arrays=arrays_pr)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        check(ms.messages < int(st.messages),
              f"{name} commit {k}: warm PageRank sent {ms.messages} "
              f"messages, cold {int(st.messages)}")
        row["maint"]["pagerank"] = {
            "warm_rounds": ms.rounds, "warm_messages": ms.messages,
            "seeds": ms.seeds, "max_abs_diff": diff,
            "cold_rounds": int(st.iterations),
            "cold_messages": int(st.messages), "cold_s": cold_s,
            "warm_s": warm_s[("pagerank", None)]}
    return row


def _log_commit(name, k, row, info):
    sp = info.splices["base"]
    m = row["maint"]
    shared = " (one laned fixpoint)" if row["laned"] else ""
    parts = [f"{app} warm {v['warm_rounds']} rounds / {v['warm_messages']} "
             f"messages in {v['warm_s']:.4f} s{shared} against cold "
             f"{v['cold_rounds']} / {v['cold_messages']} in "
             f"{v['cold_s']:.4f} s" for app, v in m.items()]
    if "pagerank" in m:
        parts.append(
            f"PageRank max |diff| {m['pagerank']['max_abs_diff']:.3g}")
    s = row["split_s"]
    log(f"[mutation] {name} commit {k} (+{info.inserted} -{info.deleted}, "
        f"{sp.shards_rebuilt} shards rebuilt, {info.replicas_added} "
        f"replicas added, R_max {row['r_max']}): splice {s['splice']:.2f} "
        f"s, maintenance {s['maintain']:.3f} s = prepare "
        f"{s['prepare']:.3f} + upload {s['upload']:.4f} + fixpoints "
        f"{s['fixpoint']:.4f} s, servers {s['servers']:.3f} s; "
        + "; ".join(parts))


def phase_mutation(torch, np, dev, g, part, root, part_pr):
    """9: streaming mutation and recovery at RMAT-18 (phase 4's graph).

    a. ``StreamingGraph``s under ``dense`` (K1; BFS/SSSP from the root
       and delta-PageRank, tol ``PR_TOL``) and ``device_worklist`` (K2;
       BFS/SSSP) go through a 1% insert batch and 4,096 inserts + 8
       deletes; after each commit BFS/SSSP equal the numpy oracles (made
       in a worker process meanwhile) and a cold port fixpoint on the
       spliced partition bit for bit, with fewer warm messages than
       cold, PageRank within tolerance of the float64 oracle; each warm
       fixpoint is timed beside its cold one, and the commit's wall time
       split into splice, prepare, upload, fixpoints and servers.
    b. ``runner='lanes'`` (K3) on the same schedule: values equal 9a's.
    c. A ``QueryServer`` (16 min lanes, ``device_worklist``: K4) bound to
       9a's dense graph answers three waves of 16 BFS/SSSP requests
       across three commits (insert-only while lanes are in flight, one
       with deletes, one more insert-only): every answer equals a solo
       run on the partition it finished on.
    d. ``run_resilient`` under a real ``CheckpointManager``:
       ``StackedTask`` (SSSP, K1, a shard killed at round 3),
       ``PagerankTask`` (K2 device plan, a corrupted tile) and
       ``LanesTask`` (Q = 16, K3, a shard killed) equal their
       uninterrupted runs; the checkpoint writes are timed on the
       caller's thread and on the writer's."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch import query
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.core.resilient import (LanesTask, PagerankTask,
                                            StackedTask, run_resilient)
    from repro_torch.core.streaming import StreamingGraph
    from repro_torch.query import lanes as L
    from repro_torch.runtime.chaos import ChaosEvent, ChaosPlan

    t_phase = time.perf_counter()
    report = {"runs": {}, "commits": {}}
    launches = {k: 0 for k in _COUNTERS}
    drive = _run_counter(torch, report, launches)
    batches = _mutation_batches(np, g)
    pcfg = PartitionConfig(num_shards=SHARDS, rpvo_max=RPVO_MAX)
    pool = ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    pending, oracles = {}, {}

    def oracle(k):
        if k not in oracles:
            t0 = time.perf_counter()
            oracles[k] = pending.pop(k).result()
            log(f"[mutation] numpy oracles after commit {k}: "
                f"{oracles[k]['s']:.1f} s in a worker process (waited "
                f"{time.perf_counter() - t0:.1f} s for them)")
        return oracles[k]

    def track(sg, apps):
        for app in apps:
            if app == "pagerank":
                sg.track(app, tol=PR_TOL)
            else:
                sg.track(app, root)
        return sg

    # ---- 9a/9c: the dense graph, a server bound to it, three commits
    cfg_dense = engine.EngineConfig(use_pallas=True)
    cfg_dwl = engine.EngineConfig(use_pallas=True,
                                  grid_mode="device_worklist")
    sga, row = drive("stream_dense_track", "stream", lambda: track(
        StreamingGraph(g, pcfg, cfg=cfg_dense, device=dev),
        ("bfs", "sssp", "pagerank")))
    log(f"[mutation] dense StreamingGraph built and tracking BFS, SSSP and "
        f"PageRank (cutoff {sga.pcfg.indegree_cutoff}): "
        f"{row['wall_s']:.1f} s")
    srv = query.QueryServer(sga.view("base").part, n_lanes=MUT_LANES,
                            cfg=cfg_dwl, device=dev)
    sga.bind_server(srv)
    deg = np.argsort(-g.out_degrees(), kind="stable")
    waves = [[("bfs" if i % 2 == 0 else "sssp", int(deg[i]))
              for i in range(16)],
             [("bfs" if i % 2 == 0 else "sssp", int(deg[i]))
              for i in range(16, 32)],
             [("sssp" if i % 2 == 0 else "bfs", int(deg[i]))
              for i in range(16)]]
    qids, finished_on, snaps_a, infos_a = {}, {}, {0: None}, {}
    serve_s = [0.0]
    in_flight = []

    def ticks(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            srv.step()
        torch.cuda.synchronize()
        serve_s[0] += time.perf_counter() - t0

    def settle(k):
        for q in srv.results:
            finished_on.setdefault(q, k)

    def submit(wave):
        for kind, v in wave:
            qids[srv.submit(kind, v)] = (kind, v)

    def commit(k):
        settle(k - 1)
        in_flight.append(sum(r is not None for r in srv.min_pool.reqs))
        _buffer(sga, batches[k - 1])
        infos_a[k] = sga.commit()
        snaps_a[k] = _snapshot(sga)
        if k < 3:
            pending[k] = pool.submit(_oracles, sga.g, root, _conv_iters())
        serve_s[0] += sga.commit_seconds["servers"]

    def stream():
        parts = {0: sga.view("base").part}
        submit(waves[0])
        ticks(2)                        # wave 0 in flight
        commit(1)                       # insert-only: warm continue
        ticks(MUT_TICKS)                # wave 0 ends on partition 1
        submit(waves[1])
        ticks(2)
        commit(2)                       # deletes: the lanes restart
        ticks(MUT_TICKS)                # wave 1 ends on partition 2
        submit(waves[2])
        ticks(2)
        commit(3)                       # insert-only again
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run()
        torch.cuda.synchronize()
        serve_s[0] += time.perf_counter() - t0
        settle(3)
        return parts

    syncs0, tick0 = srv.host_syncs, srv.tick
    with pool:
        parts0, row = drive("stream_dense_serving", "server_min", stream)
        for k in (1, 2):
            oracle(k)
    check(row["K1"] > 0 and row["K4"] > 0,
          f"dense stream with serving: K1 {row['K1']} / K4 {row['K4']}")
    check(srv.counters["mutations"] == 3, "the server saw "
          f"{srv.counters['mutations']} mutations")
    check(in_flight[0] > 0, "no lane was in flight at the first commit")
    parts_by_commit = {0: parts0[0], **{k: snaps_a[k]["part"]
                                        for k in (1, 2, 3)}}
    for k in (1, 2):
        r = _check_maintained(torch, np, dev, cfg_dense, snaps_a[k],
                              infos_a[k], root, oracle(k), "dense", k)
        r.update(r_max=snaps_a[k]["part"].R_max)
        report["commits"][f"dense_{k}"] = r
        _log_commit("dense", k, r, infos_a[k])
    # the third commit: held to cold fixpoints (no oracle needed)
    snap = snaps_a[3]
    for app, sem in (("bfs", actions.BFS), ("sssp", actions.SSSP)):
        val, _ = engine.run_stacked(
            sem, snap["part"], engine.init_values(snap["part"], sem,
                                                  {root: 0.0}),
            cfg_dense, device=dev)
        check(np.array_equal(engine.vertex_values(snap["part"], val),
                             snap["vals"][(app, root)]),
              f"dense commit 3: warm {app} differs from a cold fixpoint")
    sp = snap["split"]
    log(f"[mutation] dense commit 3 (+{infos_a[3].inserted}): splice "
        f"{sp['splice']:.2f} s, maintenance {sp['maintain']:.3f} s = "
        f"prepare {sp['prepare']:.3f} + upload {sp['upload']:.4f} + "
        f"fixpoints {sp['fixpoint']:.4f} s, servers {sp['servers']:.3f} s; "
        "BFS/SSSP equal cold fixpoints")

    # every served answer equals a solo run on its partition
    solo = {}
    results = srv.results
    check(len(results) == 48 and all(r.status == "ok"
                                      for r in results.values()),
          f"served {len(results)} results, statuses "
          f"{sorted({r.status for r in results.values()})}")
    for q, (kind, v) in qids.items():
        p = finished_on[q]
        if (p, kind, v) not in solo:
            sem = actions.BFS if kind == "bfs" else actions.SSSP
            pp = parts_by_commit[p]
            val, _ = engine.run_stacked(
                sem, pp, engine.init_values(pp, sem, {v: 0.0}), cfg_dense,
                device=dev)
            solo[(p, kind, v)] = L.decode_min_values(
                engine.vertex_values(pp, val), kind)
        check(np.array_equal(results[q].values, solo[(p, kind, v)]),
              f"served {kind} from {v} (finished after commit {p}) "
              "differs from its solo run")
    ticks_n = srv.tick - tick0
    serve_row = {
        "requests": len(results), "wall_s": serve_s[0],
        "requests_per_s": len(results) / serve_s[0], "ticks": ticks_n,
        "host_syncs_per_tick": (srv.host_syncs - syncs0) / ticks_n,
        "ms_per_commit": [1e3 * snaps_a[k]["split"]["servers"]
                          for k in (1, 2, 3)],
        "in_flight_at_commit": in_flight,
        "finished_after_commit": [sum(1 for q in qids if finished_on[q] == k)
                                  for k in range(4)],
        "K4": row["K4"]}
    report["serving"] = serve_row
    log(f"[mutation] serving: 48 requests across 3 commits "
        f"({in_flight} lanes in flight at the commits; finished after "
        f"commits 0-3: {serve_row['finished_after_commit']}), every answer "
        f"equal to its solo run on its partition; "
        f"{serve_row['requests_per_s']:.1f} requests/s over "
        f"{serve_s[0]:.2f} s of ticks and swaps, {ticks_n} ticks, "
        f"{serve_row['host_syncs_per_tick']:.2f} host reads a tick, "
        "apply_mutation " + ", ".join(
            f"{x:.1f}" for x in serve_row["ms_per_commit"]) + " ms; K4 "
        f"launches {row['K4']}")

    # ---- 9a: the device_worklist graph; 9b: the lanes runner.  Neither
    # tracks PageRank: its pr view would splice each batch once more, and
    # K2's warm delta-PageRank is held on the CPU tests and 9d's card run
    for name, runner, cfg, apps, lane in (
            ("device_worklist", "stacked", cfg_dwl, ("bfs", "sssp"), "K2"),
            ("lanes", "lanes", cfg_dense, ("bfs", "sssp"), "K3")):
        sg, row = drive(f"stream_{name}_track", "stream", lambda: track(
            StreamingGraph(g, pcfg, cfg=cfg, runner=runner, device=dev),
            apps))
        for k in (1, 2):
            _buffer(sg, batches[k - 1])
            info, row = drive(f"stream_{name}_commit{k}", "stream",
                              sg.commit)
            check(row[lane] > 0, f"{name} commit {k}: no {lane} launch")
            snap = _snapshot(sg)
            for key, v in snap["vals"].items():
                want = snaps_a[k]["vals"][key]
                check(np.array_equal(v, want) if key[0] != "pagerank"
                      else np.allclose(v, want, rtol=PR_RTOL, atol=PR_ATOL),
                      f"{name} commit {k}: {key} differs from the dense "
                      "graph's")
            r = _check_maintained(torch, np, dev, cfg, snap, info, root,
                                  oracle(k), name, k)
            r.update(r_max=snap["part"].R_max,
                     launches={kk: row[kk] for kk in _COUNTERS if row[kk]})
            report["commits"][f"{name}_{k}"] = r
            _log_commit(name, k, r, info)

    # ---- 9d: recovery under real checkpoint managers
    rec_rows = {}
    with tempfile.TemporaryDirectory() as d:
        init = engine.init_values(part, actions.SSSP, {root: 0.0})
        roots16 = [int(v) for v in deg[:MUT_LANES]]
        q_init, unitw = L.init_lane_values(
            part, [("bfs" if i < 8 else "sssp", v)
                   for i, v in enumerate(roots16)])
        cases = (
            ("stacked_sssp", lambda: StackedTask(
                actions.SSSP, part, init, engine.EngineConfig(
                    use_pallas=True, checkpoint_every=MUT_CKPT_EVERY),
                device=dev), dict(round=3, kind="kill_shard", shard=1)),
            ("pagerank", lambda: PagerankTask(
                part_pr, 0.85, PR_TOL, engine.EngineConfig(
                    use_pallas=True, grid_mode="device_worklist",
                    checkpoint_every=MUT_CKPT_EVERY), device=dev),
             dict(round=3, kind="corrupt_tile", shard=2)),
            ("lanes", lambda: LanesTask(
                part, q_init, unitw, engine.EngineConfig(
                    use_pallas=True, checkpoint_every=MUT_CKPT_EVERY),
                device=dev), dict(round=3, kind="kill_shard", shard=1)))
        for name, make, event in cases:
            clean, _ = drive(f"resilient_{name}_clean", name,
                             lambda: run_resilient(make()))
            manager = _timed_manager(f"{d}/{name}")
            (got, stats, rep), row = drive(
                f"resilient_{name}", name, lambda: run_resilient(
                    make(), chaos=ChaosPlan(events=(ChaosEvent(**event),)),
                    manager=manager))
            want, want_stats, _ = clean
            check(rep.status == "recovered" and rep.restores >= 1
                  and rep.checkpoints_written > 0,
                  f"resilient {name}: {rep}")
            check([int(x) for x in stats] == [int(x) for x in want_stats],
                  f"resilient {name}: RunStats {list(map(int, stats))} != "
                  f"uninterrupted {list(map(int, want_stats))}")
            if name == "pagerank":
                check(torch.allclose(got, want, rtol=PR_RTOL, atol=PR_ATOL),
                      f"resilient {name}: off the uninterrupted run")
                eng, est = engine.run_pagerank_delta(
                    part_pr, 0.85, PR_TOL, engine.EngineConfig(
                        use_pallas=True, grid_mode="device_worklist"),
                    device=dev)
                check(torch.allclose(got, eng, rtol=PR_RTOL, atol=PR_ATOL),
                      f"resilient {name}: off run_pagerank_delta")
            else:
                check(torch.equal(got, want),
                      f"resilient {name}: values differ from the "
                      "uninterrupted run")
                if name == "stacked_sssp":
                    eng, est = engine.run_stacked(
                        actions.SSSP, part, init,
                        engine.EngineConfig(use_pallas=True), device=dev)
                else:
                    eng, est = L.run_stacked_lanes(
                        part, q_init, unitw,
                        engine.EngineConfig(use_pallas=True), device=dev)
                check(torch.equal(got, eng),
                      f"resilient {name}: differs from the plain runner")
            rec_rows[name] = {
                "rounds": int(stats.iterations),
                "messages": int(stats.messages),
                "faults": len(rep.faults), "restores": rep.restores,
                "rounds_lost": rep.rounds_lost,
                "checkpoints_written": rep.checkpoints_written,
                "checkpoint_write_ms": 1e3 * rep.checkpoint_write_s,
                "writer_ms": 1e3 * manager.write_s,
                "writer_writes": manager.writes,
                "restore_ms": 1e3 * rep.recovery_s,
                "wall_s": row["wall_s"],
                "launches": {kk: row[kk] for kk in _COUNTERS if row[kk]}}
            log(f"[mutation] resilient {name}: {event['kind']} at round 3 "
                f"recovered ({rep.restores} restore, {rep.rounds_lost} "
                f"rounds lost, {rep.checkpoints_written} checkpoints); "
                f"values and RunStats equal the uninterrupted run "
                f"({int(stats.iterations)} rounds, {int(stats.messages)} "
                f"messages); checkpoint writes "
                f"{rec_rows[name]['checkpoint_write_ms']:.1f} ms in all on "
                f"the caller's thread (host copy and hand-off), "
                f"{rec_rows[name]['writer_ms']:.1f} ms on the writer's "
                f"({manager.writes} writes: files, crc-32s, fsync, "
                f"rename), restore {rec_rows[name]['restore_ms']:.1f} ms, "
                "wall "
                f"{row['wall_s']:.2f} s; launches "
                f"{rec_rows[name]['launches']}")
    report["resilient"] = rec_rows
    for k in ("K1", "K2", "K3", "K4"):
        check(launches[k] > 0, f"phase 9 launched no {k}")
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[mutation] phase 9: {report['phase_s']:.1f} s; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches, report


def _tick_profile(torch, srv, ticks=4, top=10):
    """Wall and device time of ``ticks`` server ticks, recorded in the
    third step of a wait/warm-up/active ``torch.profiler`` schedule (an
    unscheduled trace can drop kernels, PERF.md §7; the steps before it
    are ticks too): the device's busy share, the kernels launched and
    the ``top`` kernels and copies by device time (name cut to 60
    characters, ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for step in range(3):
            t0 = time.perf_counter()
            for _ in range(ticks if step == 2 else 1):
                srv.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    device_ms = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"ticks": ticks, "wall_ms": 1e3 * wall, "device_ms": device_ms,
            "busy": device_ms / (1e3 * wall),
            "kernels": sum(c for _, c in by_name.values()),
            "top": [(n[:60], ms, c) for n, (ms, c) in rows[:top]]}


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# the overload run's statuses by qid: its deadline, its lane failure, six
# answered, two rejected at a full queue (tests/test_torch_server.py runs
# the same stream on the CPU against the reference)
OVERLOAD_STATUSES = {0: "deadline_expired", 1: "lane_failed",
                     2: "ok", 3: "ok", 4: "ok", 5: "ok", 6: "ok", 7: "ok",
                     8: "rejected", 9: "rejected"}


def overload_run(srv, clock, roots):
    """Ten BFS requests (the first with a 1 s deadline) into a server
    with an 8-deep 'reject' queue; one tick, the clock moved to 5 s, then
    drained.  Returns {qid: status}."""
    for i, r in enumerate(roots):
        srv.submit("bfs", r, deadline_s=1.0 if i == 0 else None)
    srv.step()
    clock.t = 5.0
    return {qid: res.status for qid, res in sorted(srv.run().items())}


# --fold-sweep: the laned fold's constants, each changed alone in a copy
# of csrc (file, text, replacement); "full-warp lists" keeps the sources
# and runs a list a warp at Q = 16
FOLD_SWEEP = {
    "kept": [],
    "window 128": [("frr_lanes.cuh", "WINDOW = 256;", "WINDOW = 128;")],
    "4 gathers a list": [("frr_lanes.cuh", "GATHER_DEPTH = 8;",
                          "GATHER_DEPTH = 4;")],
    "16 gathers a list": [("frr_lanes.cuh", "GATHER_DEPTH = 8;",
                           "GATHER_DEPTH = 16;")],
    "4 blocks an SM": [("fused_relax_reduce_wl_lanes.cu",
                        "BLOCKS_PER_SM = 5;", "BLOCKS_PER_SM = 4;")],
    "6 blocks an SM": [("fused_relax_reduce_wl_lanes.cu",
                        "BLOCKS_PER_SM = 5;", "BLOCKS_PER_SM = 6;")],
    "full-warp lists": [],
}


TRACE_DROP_TRACES = 20   # traces of each way --trace-drops takes


def _trace_record(prof, name="segment_combine_kernel"):
    """What a finished ``torch.profiler`` trace holds of its launches:
    ``kernels``, the kernel records on the card whose name holds
    ``name``; ``launches``, the launch calls it holds; ``missing``, the
    launch-order positions of those it holds no kernel record of;
    ``first_launch_us``, the first launch call after the trace's start;
    ``min_lag_us``, the least time from a launch call to its recorded
    kernel's start (the two clocks' disagreement shows as a negative
    lag)."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    ev = res.events()
    kern = {e.correlation_id(): e for e in ev
            if e.device_type() == DeviceType.CUDA}
    seq = [(t, kern.get(c)) for t, c in sorted(
        (e.start_ns(), e.correlation_id()) for e in ev
        if e.device_type() != DeviceType.CUDA
        and "LaunchKernel" in e.name())]
    lags = [(k.start_ns() - t) / 1e3 for t, k in seq if k is not None]
    return {"kernels": sum(1 for e in kern.values() if name in e.name()),
            "launches": len(seq),
            "missing": [i for i, (_, k) in enumerate(seq) if k is None],
            "first_launch_us": ((seq[0][0] - res.trace_start_ns()) / 1e3
                                if seq else None),
            "min_lag_us": min(lags) if lags else None}


def trace_drops() -> int:
    """``--trace-drops``: where ``torch.profiler`` loses K9's kernel
    records.  K9 on the RMAT-18 BFS round with the most active edges
    (``pallas_mode='reduce'``), 20 wrapper launches a trace, traced
    ``TRACE_DROP_TRACES`` times in turns each way: ``bare`` (started
    right before the launches), ``settled`` (0.2 s inside the trace
    first), ``scheduled`` (the third step of a wait/warm-up/active
    schedule, as phase 6 traces), ``scheduled_lead`` (the same with a
    sync and 0.05 s before each step's launches), ``scheduled_tail``
    (0.05 s after each step's sync) and ``scheduled_sentinel`` (20
    launches of a one-element ``add_`` right before each step's K9
    launches, with no sync between).  For each trace its
    ``_trace_record``.  All of it twice: in a
    process that has traced nothing else (``fresh``), then after one
    CPU + CUDA trace of the same launches, as phases 5 and 6 take before
    phase 6's K9 traces (``primed``).  Prints the card and one JSON
    line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch import exchange
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    dev = torch.device("cuda")
    smi, _ = phase_device()
    g = generators.rmat(RMAT_SCALE, edge_factor=EDGE_FACTOR,
                        seed=SEED).with_random_weights(seed=SEED)
    part = build_partition(g, PartitionConfig(num_shards=SHARDS,
                                              rpvo_max=RPVO_MAX))
    root = int(np.argmax(g.out_degrees()))
    arrays = engine.DeviceArrays.from_partition(part, dev)
    cfg = engine.EngineConfig(use_pallas=True, pallas_mode="reduce")
    sem = actions.BFS
    val = torch.as_tensor(engine.init_values(part, sem, {root: 0.0}),
                          device=dev)
    chg = (val == 0) & arrays.slot_valid
    rounds = []
    while bool(chg.any()):
        rounds.append(_segment_messages(torch, sem, arrays, val, chg))
        val, chg, _ = exchange.fixpoint_round_stacked(
            sem, arrays, cfg, part.S, part.R_max, val, chg)
    msg, active = max(rounds, key=lambda r: r[1])
    ids = arrays.edge_dst_flat.reshape(-1)
    reps = 20

    def calls():
        for _ in range(reps):
            rsr._launch(msg, ids, arrays.fused_plan, "min", False)
        torch.cuda.synchronize()
    calls()
    act = [ProfilerActivity.CUDA]

    def unscheduled(lead, tail):
        with profile(activities=act) as prof:
            torch.cuda.synchronize()
            time.sleep(lead)
            calls()
            time.sleep(tail)
        return prof

    one = torch.zeros(1, device=dev)

    def scheduled(lead=0.0, tail=0.0, sentinels=0):
        with profile(activities=act, schedule=schedule(
                wait=1, warmup=1, active=1)) as prof:
            for _ in range(3):
                if lead:
                    torch.cuda.synchronize()
                    time.sleep(lead)
                for _ in range(sentinels):
                    one.add_(1.0)
                calls()
                time.sleep(tail)
                prof.step()
        return prof
    ways = {"bare": lambda: unscheduled(0.0, 0.0),
            "settled": lambda: unscheduled(0.2, 0.0),
            "scheduled": scheduled,
            "scheduled_lead": lambda: scheduled(lead=0.05),
            "scheduled_tail": lambda: scheduled(tail=0.05),
            "scheduled_sentinel": lambda: scheduled(sentinels=reps)}
    out, summary = {}, {}
    for history in ("fresh", "primed"):
        if history == "primed":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                calls()
        for _ in range(TRACE_DROP_TRACES):
            for w, run in ways.items():
                out.setdefault(f"{history} {w}", []).append(
                    _trace_record(run()))
    for w, t in out.items():
        summary[w] = s = {
            "traces": len(t),
            "short": sum(1 for x in t if x["kernels"] < reps),
            "k9": [x["kernels"] for x in t],
            "missing_at": sorted(collections.Counter(
                i for x in t for i in x["missing"]).items()),
            "short_traces": [x for x in t if x["kernels"] < reps],
            "min_lag_us": min((x["min_lag_us"] for x in t
                               if x["min_lag_us"] is not None),
                              default=None)}
        log(f"[trace-drops] {w}: {s['short']} of {s['traces']} traces saw "
            f"fewer than {reps} K9 kernels {s['k9']}; launches without a "
            f"kernel record, by launch-order position: {s['missing_at']}; "
            f"least launch-to-kernel lag {s['min_lag_us']} us; the short "
            "ones: "
            + json.dumps([{k: v for k, v in x.items() if k != "missing"}
                          for x in s["short_traces"]]))
    print(smi)
    print(json.dumps({"trace_drops": {"reps": reps, "active_edges": active,
                                      "summary": summary, "traces": out}}))
    return 0


def fold_sweep() -> int:
    """``--fold-sweep``: K3 alone on the RMAT-18 Q = 16 lane fixpoint's
    rounds (the heaviest, and summed over all of them; device ms from CUDA
    events, two passes in turns) for each variant of ``FOLD_SWEEP``, each
    built with ``nvcc`` from a copy of ``csrc`` under ``chip_smoke_out``
    and held to the kept build bit for bit on every round (min); prints
    the card and one JSON line."""
    import ctypes
    import shutil
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import exchange
    from repro_torch.core import actions, engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.query import lanes
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = "fused_relax_reduce_wl_lanes"
    libs, jobs = {}, []
    for key, subs in FOLD_SWEEP.items():
        d = OUT.parent / "fold_sweep" / key.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for file, a, b in subs:
            text = (d / file).read_text()
            check(a in text, f"{key}: {a!r} is not in {file}")
            (d / file).write_text(text.replace(a, b))
        libs[key] = d / f"lib{name}.so"
        jobs.append(subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(libs[key]),
             str(d / f"{name}.cu")]))
    check(all(j.wait(timeout=600) == 0 for j in jobs), "a variant's build")
    g, part, _, _ = rmat18(np)
    arrays = engine.DeviceArrays.from_partition(part, dev)
    plan = arrays.fused_plan
    edges = (arrays.edge_src_root_flat.reshape(-1),
             arrays.edge_w.reshape(-1), arrays.edge_mask.reshape(-1),
             arrays.edge_dst_flat.reshape(-1))
    deg = np.argsort(-g.out_degrees(), kind="stable")
    roots = [int(v) for v in deg[:LANES]]
    queries = [("bfs", r) for r in roots[:LANES // 2]] + \
        [("sssp", r) for r in roots[LANES // 2:]]
    init, unitw = lanes.init_lane_values(part, queries)
    val = torch.as_tensor(init, device=dev)
    unitw = torch.as_tensor(unitw, device=dev)
    unit_u8 = (unitw != 0).to(torch.uint8)
    chg = (val < math.inf) & arrays.slot_valid[..., None]
    cfg = engine.EngineConfig(use_pallas=True)
    rounds, pairs = [], []
    while bool(chg.any()):
        gchg = chg.reshape(-1, LANES)
        chunk_act, counts = frr._lane_chunk_tables(edges[0], edges[2], gchg,
                                                   plan.src_deg)
        rounds.append((frr._masked_value_tables(
            val.reshape(-1, LANES), gchg, math.inf), chunk_act))
        pairs.append(int(counts.sum()))
        val, chg, _ = exchange.fixpoint_round_stacked(
            actions.SSSP, arrays, cfg, part.S, part.R_max, val, chg, unitw)
    heavy = pairs.index(max(pairs))        # the most active (edge, lane)
    halves = frr._halves

    def k3(r):
        return frr._launch_lanes(r[0], unit_u8, *edges, plan, r[1], "add_w",
                                 "min", False)[0]

    out, want = {}, None
    for _ in range(2):
        for key in FOLD_SWEEP:
            frr._libs[name] = ctypes.CDLL(str(libs[key]))
            frr._fns.pop("frr_wl_lanes_launch", None)
            frr._halves = (lambda q: 1) if key == "full-warp lists" \
                else halves
            try:
                got = [k3(r) for r in rounds]
                if want is None:
                    want = got
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{key}: K3 differs from the kept build")
                ms = [time_ms(torch, lambda r=r: k3(r), reps=10)
                      for r in rounds]
            finally:
                frr._halves = halves
            out.setdefault(key, []).append(
                {"heaviest_ms": ms[heavy], "sum_ms": sum(ms)})
    print(smi)
    print(json.dumps({"fold_sweep": out, "rounds": len(rounds),
                      "heaviest_round": heavy + 1}))
    return 0


def plan_timing(src) -> int:
    """``--plan-timing``: wall ms (synced, median, min and max over
    ``PLAN_REPS``) of the launch plan's build, the tables a plan's first
    piece launch adds (K1's and, where it has its own cut, K9's), the
    device arrays' upload, and the BFS/SSSP fixpoints under the fused
    (K1) and the reduce (K9) composition, set-up included as phases 4
    and 6 time them, and their rounds alone on built arrays, each after
    one warm-up call, with the ``repro_torch`` under ``src``; prints the
    card and one JSON line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import apps
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_relax_reduce as frr
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build_all(p.stem for p in _build.CSRC.glob("*.cu"))
    g, part, root, want = rmat18(np)

    def wall(fn, reps=PLAN_REPS):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return {"median": statistics.median(times), "min": min(times),
                "max": max(times)}

    arrays = engine.DeviceArrays.from_partition(part, dev)
    src_f, mask_f, dst_f = (arrays.edge_src_root_flat.reshape(-1),
                            arrays.edge_mask.reshape(-1),
                            arrays.edge_dst_flat.reshape(-1))
    n = part.S * part.R_max
    out = {"src": str(src), "num_edges": int(src_f.shape[0]),
           "plan_launch_ms": wall(lambda: frr.plan_launch(
               src_f, mask_f, dst_f, n, n)),
           "device_arrays_ms": wall(
               lambda: engine.DeviceArrays.from_partition(part, dev))}
    if hasattr(frr, "cell_batches"):      # built on a first worklist launch
        plan = arrays.fused_plan
        out["worklist_tables_ms"] = wall(lambda: (
            frr.piece_tables(plan.blk_ptr, plan.num_cells, frr.PIECE_CELLS),
            frr.cell_batches(plan, mask_f, dst_f)))
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    if hasattr(rsr, "PIECE_CELLS"):       # K9's pieces, on its first launch
        plan = arrays.fused_plan
        out["k9_tables_ms"] = wall(lambda: (
            frr.piece_tables(plan.blk_ptr, plan.num_cells, rsr.PIECE_CELLS),
            frr.cell_batches(plan, mask_f, dst_f)))
    from repro_torch import exchange
    from repro_torch.core import actions
    for mode in ("fused", "reduce"):
        cfg = engine.EngineConfig(use_pallas=True, pallas_mode=mode)
        tag = "" if mode == "fused" else "_reduce"
        for name, app, sem in (("bfs", apps.bfs, actions.BFS),
                               ("sssp", apps.sssp, actions.SSSP)):
            got, _, _ = app(g, root, part=part, cfg=cfg)
            check(np.array_equal(got, want[name]),
                  f"{name} {mode} differs from the numpy oracle")
            out[f"{name}{tag}_fixpoint_ms"] = wall(
                lambda app=app: app(g, root, part=part, cfg=cfg))

            def rounds(sem=sem):  # the fixpoint's rounds on built arrays
                val = torch.as_tensor(
                    engine.init_values(part, sem, {root: 0.0}), device=dev)
                chg = (val == 0) & arrays.slot_valid
                while bool(chg.any()):
                    val, chg, _ = exchange.fixpoint_round_stacked(
                        sem, arrays, cfg, part.S, part.R_max, val, chg)
            out[f"{name}{tag}_rounds_ms"] = wall(rounds)
    print(smi)
    print(json.dumps({"plan_timing": out}))
    return 0


# --------------------------------------------------------------------------
# phase 10: the sharded layout on torch.distributed
# --------------------------------------------------------------------------
# The card's machine has one GPU and NCCL takes one rank a GPU, so the
# 16 shards run as 16 spawned ranks side by side on the one card, over a
# gloo group whose collectives stage the card's tensors through the host
# (``exchange.collectives``): their times are not a multi-GPU layout's.
# A one-rank NCCL group runs first, so the NCCL calls themselves launch.

SHARD_RANKS, SHARD_MESH = 16, (8, 2)
SHARD_DIR = ROOT / "chip_smoke_out" / "sharded"
SHARD_INSERTS = 4096          # the streaming leg's one commit
SHARD_SERVE_PPR = ((0, 0.85), (3, 0.7), (6, 0.6), (9, 0.85))
SHARD_CKPT_EVERY = 4          # the resilient leg's checkpoint cadence
SHARD_FAULT = ("corrupt_tile", 3, 5)   # kind, round, shard


def _shard_configs(engine):
    """The BFS/SSSP legs: K1 dense, K2 device worklist, K9 reduce and the
    compact exchange (K1 on each shard's compact plan)."""
    return {"dense": engine.EngineConfig(use_pallas=True),
            "device_worklist": engine.EngineConfig(
                use_pallas=True, grid_mode="device_worklist"),
            "reduce": engine.EngineConfig(use_pallas=True,
                                          pallas_mode="reduce"),
            "compact": engine.EngineConfig(use_pallas=True,
                                           exchange="compact")}


def _probe_collectives(torch, dist, dev):
    """Which collective of the gloo world group takes which CUDA dtype
    (``exchange.collectives`` hands gloo the card's tensors as they
    are: a refusal here fails the leg that needs it).  Point-to-point
    send/recv is probed apart, in phase 14 (where gloo does not take a
    CUDA tensor there, it aborts the process)."""
    table = {}
    world = dist.get_world_size()
    for dtype in (torch.float32, torch.bfloat16, torch.int64, torch.uint8,
                  torch.bool):
        x = torch.ones(world, dtype=dtype, device=dev)
        calls = {
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(world * world, dtype=dtype, device=dev), x),
            "all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty_like(x), x),
            "all_reduce": lambda: dist.all_reduce(
                x.clone(), op=dist.ReduceOp.MAX if dtype == torch.bool
                else dist.ReduceOp.SUM)}
        if dtype.is_floating_point:     # the sharded LM's gradients
            calls["reduce_scatter_tensor"] = \
                lambda: dist.reduce_scatter_tensor(
                    torch.empty(1, dtype=dtype, device=dev), x)
        for op, call in calls.items():
            key = f"{op}/{str(dtype).removeprefix('torch.')}"
            try:
                call()
                torch.cuda.synchronize()
                table[key] = "ok"
            except (RuntimeError, ValueError, TypeError) as e:
                table[key] = "refused: " + str(e).splitlines()[0][:100]
            dist.barrier()
    return table


def _shard_rank(rank, world, spec):
    """One rank of phase 10: every leg through the entry points, each
    rank making the same calls; rank 0 writes the results, every rank its
    kernel launch counts."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import apps
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import actions, engine, resilient
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.core.streaming import StreamingGraph
    from repro_torch.exchange import collectives, rounds
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    from repro_torch.query import QueryServer
    from repro_torch.runtime.chaos import ChaosEvent, ChaosPlan

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"],
                                                         world),
                            rank=rank, world_size=world)
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(SHARD_MESH),
                      mesh_dim_names=("data", "model"))
    probe = _probe_collectives(torch, dist, dev)
    with open(spec["data"], "rb") as f:
        data = pickle.load(f)
    part, part_pr, g, root = (data["part"], data["part_pr"], data["g"],
                              data["root"])
    setup_s = time.perf_counter() - t_start
    mods = {"frr": frr, "rsr": rsr}
    totals = collections.Counter()
    legs, out = {}, {}
    relax_s = [0.0]
    plain_relax = rounds.relax

    def timed_relax(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plain_relax(*a, **k)
        torch.cuda.synchronize()
        relax_s[0] += time.perf_counter() - t0
        return res

    rounds.relax = timed_relax          # the shard rounds' relax phase
    collectives.timing = True

    def leg(name, call, n_rounds):
        for mod, attr in _COUNTERS.values():
            setattr(mods[mod], attr, 0)
        collectives.reset_counters()
        relax_s[0] = 0.0
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {"wall_s": wall, "rounds": int(n_rounds(res)),
               "relax_s": relax_s[0],
               "collective_s": dict(collectives.seconds),
               "bytes": dict(collectives.bytes_in),
               "calls": dict(collectives.calls)}
        for k, (mod, attr) in _COUNTERS.items():
            row[k] = getattr(mods[mod], attr)
            totals[k] += row[k]
        legs[name] = row
        return res

    def it(res):
        return res[1].iterations

    for tag, cfg in _shard_configs(engine).items():
        for app in ("bfs", "sssp"):
            vals, st, _ = leg(f"{app}_{tag}", lambda: getattr(apps, app)(
                None, root, part=part, cfg=cfg, mesh=mesh), it)
            out[f"{app}_{tag}"] = vals
            out[f"{app}_{tag}_stats"] = np.asarray([int(x) for x in st])
    cfg = engine.EngineConfig(use_pallas=True)
    out["pagerank"], _ = leg("pagerank", lambda: apps.pagerank(
        None, iters=PR_ITERS, part=part_pr, cfg=cfg, mesh=mesh),
        lambda res: PR_ITERS)
    sc, st, _ = leg("pagerank_delta", lambda: apps.pagerank_delta(
        None, tol=PR_TOL, part=part_pr, cfg=cfg, mesh=mesh), it)
    out["pagerank_delta"] = sc
    out["pagerank_delta_stats"] = np.asarray([int(x) for x in st])
    for tag in ("dense", "device_worklist"):
        lcfg = _shard_configs(engine)[tag]
        res, st, _ = leg(f"lanes_{tag}", lambda: apps.batched_queries(
            None, data["queries"], part=part, cfg=lcfg, mesh=mesh),
            lambda res: int(res[1].rounds.max()))
        out[f"lanes_{tag}"] = np.stack(res).astype(np.float64)
        out[f"lanes_{tag}_stats"] = np.stack([x.cpu().numpy()
                                              for x in st])

    def serve():
        srv = QueryServer(part_pr, n_lanes=LANES, ppr_lanes=PPR_SEEDS,
                          cfg=cfg, mesh=mesh)
        qids = [srv.submit(kind, v, damping=d, tol=SERVE_PPR_TOL)
                for kind, v, d in data["serve"]]
        res = srv.run()
        return srv, [res[q] for q in qids]

    srv, served = leg("server", serve, lambda res: res[0].rounds_driven)
    out["served"] = np.stack([np.asarray(r.values, np.float64)
                              for r in served])
    out["served_rows"] = np.asarray([[r.rounds, r.messages,
                                      r.completed_tick] for r in served])
    legs["server"]["ticks"] = srv.tick
    legs["server"]["host_syncs"] = srv.host_syncs

    t0 = time.perf_counter()
    sg = StreamingGraph(g, PartitionConfig(num_shards=SHARDS,
                                           rpvo_max=RPVO_MAX),
                        cfg=cfg, runner="sharded", mesh=mesh)
    sg.track("bfs", root)
    sg.track("sssp", root)
    stream_setup_s = time.perf_counter() - t0
    ins = data["inserts"]

    def commit():
        sg.insert_edges(*ins)
        return sg.commit()

    info = leg("stream_commit", commit, lambda info: sum(
        m.rounds for m in info.maint.values()))
    legs["stream_commit"]["setup_s"] = stream_setup_s
    legs["stream_commit"]["split"] = dict(sg.commit_seconds)
    legs["stream_commit"]["maint"] = {
        k[0]: [m.rounds, m.messages] for k, m in info.maint.items()}
    spliced = sg.view("base").part
    for app in ("bfs", "sssp"):
        out[f"stream_{app}"] = sg.values(app, root)
        sem = actions.BFS if app == "bfs" else actions.SSSP
        init = engine.init_values(spliced, sem, {root: 0.0})
        val, st = leg(f"stream_cold_{app}", lambda: engine.run_sharded(
            sem, spliced, init, mesh, cfg=cfg), lambda res: res[1].iterations)
        out[f"stream_cold_{app}"] = engine.vertex_values(spliced, val)
        legs["stream_commit"]["maint"][f"cold_{app}"] = [
            int(st.iterations), int(st.messages)]

    init = engine.init_values(part, actions.SSSP, {root: 0.0})
    kind, rnd, shard = SHARD_FAULT
    mgr = CheckpointManager(str(SHARD_DIR / f"ckpt{rank}"))
    rcfg = engine.EngineConfig(use_pallas=True,
                               checkpoint_every=SHARD_CKPT_EVERY)
    val, st, report = leg("resilient", lambda: resilient.run_resilient(
        resilient.ShardedTask(actions.SSSP, part, init, mesh, cfg=rcfg),
        chaos=ChaosPlan(events=(ChaosEvent(round=rnd, kind=kind,
                                           shard=shard),)),
        manager=mgr), lambda res: res[1].iterations)
    out["resilient"] = engine.vertex_values(part, val)
    out["resilient_stats"] = np.asarray([int(x) for x in st])
    legs["resilient"]["report"] = {
        "status": report.status, "restores": report.restores,
        "rounds_lost": report.rounds_lost,
        "checkpoints_written": report.checkpoints_written}

    rounds.relax = plain_relax
    collectives.timing = False
    dist.barrier()
    with open(SHARD_DIR / f"counts{rank}.json", "w") as f:
        json.dump(dict(totals), f)
    if rank == 0:
        np.savez(SHARD_DIR / "rank0.npz", **out)
        with open(SHARD_DIR / "rank0.json", "w") as f:
            json.dump({"probe": probe, "legs": legs, "setup_s": setup_s,
                       "total_s": time.perf_counter() - t_start}, f)
    dist.barrier()
    dist.destroy_process_group()


def _nccl_one_rank(torch, np, dev):
    """``bfs(g, root, num_shards=1, mesh=<1x1 mesh>)`` on a one-rank NCCL
    group over the card (``tests/test_engine_sharded.py:18``'s
    counterpart): the NCCL collectives launch, the levels equal the
    oracle.  Returns the launch counts of the run."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import apps
    from repro_torch.core import engine
    from repro_torch.exchange import collectives
    from repro_torch.graph import generators, reference
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        check(dist.get_backend(collectives.shard_group(mesh).group)
              == "nccl", "the one-rank group is not NCCL")
        g = generators.erdos_renyi(200, avg_degree=4.0, seed=0)
        root = int(g.src[0])
        launches = collections.Counter()
        collectives.reset_counters()
        (got, stats, _), row = _run_counter(
            torch, {"runs": {}}, launches)(
                "nccl_bfs", "bfs_sharded", lambda: apps.bfs(
                    g, root, num_shards=1, mesh=mesh,
                    cfg=engine.EngineConfig(use_pallas=True)))
        check(np.array_equal(got, reference.bfs_levels(g, root)),
              "one-rank NCCL BFS differs from the oracle")
        n_coll = sum(collectives.calls.values())
        check(n_coll > 0 and row["K1"] == int(stats.iterations),
              "one-rank NCCL BFS: no collectives or K1 launches missing")
        log(f"[sharded] one-rank NCCL group: BFS equal to the oracle, "
            f"{int(stats.iterations)} rounds, {n_coll} NCCL collectives, "
            f"K1 launches {row['K1']}")
        return launches
    finally:
        dist.destroy_process_group()


def _serve_requests(np, g):
    """The sharded server's 16 requests: BFS from the 6 highest
    out-degree vertices, SSSP from the next 4, reachability from 2, PPR
    from 4 (``SHARD_SERVE_PPR``: degree rank, damping)."""
    deg = np.argsort(-g.out_degrees())
    reqs = [("bfs", int(deg[i]), 0.85) for i in range(6)]
    reqs += [("sssp", int(deg[i]), 0.85) for i in range(6, 10)]
    reqs += [("reachability", int(deg[i]), 0.85) for i in (10, 11)]
    reqs += [("ppr", int(deg[i]), d) for i, d in SHARD_SERVE_PPR]
    return reqs


def _shard_kernels(torch, np, dev, part, root):
    """K1, K2, K3 and K9 on one shard's launch (the shard with the most
    edges, its edges into every shard's ``S*R_max`` slots) on the
    heaviest BFS round (K3: that round's BFS tables in 8 lanes and the
    heaviest SSSP round's in 8): each against its plain version, K1, K3
    and K9 against their order models, and timed through its wrapper
    (``ms``: the relax phase) and alone on prepared tables
    (``kernel_ms``), beside the plain version, a library call and the
    byte bound of the shard's launch (its edges read once, the gathered
    table and frontier read once, the inbox written once)."""
    from repro_torch.core import actions, engine
    from repro_torch.kernels import fused_relax_reduce as frr
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    from repro_torch.kernels.ref import (
        fused_relax_reduce_lanes_ref, fused_relax_reduce_ref,
        segment_combine_order, segment_combine_ref)
    stacked = engine.DeviceArrays.from_partition(part, dev)
    gval, gchg, rnd, _ = _heaviest_round(torch, dev, part, stacked,
                                         actions.BFS, root)
    sval, schg, _, _ = _heaviest_round(torch, dev, part, stacked,
                                       actions.SSSP, root)
    r = int(np.argmax(part.edge_mask.sum(axis=1)))
    arrays = engine.DeviceArrays.from_partition(part, dev, shard=r)
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    ids = arrays.edge_dst_flat.reshape(-1)
    plan, nseg = arrays.fused_plan, part.S * part.R_max
    active = mask & gchg[src.long()]
    n_active = int(active.sum())
    args = (gval, gchg, src, w, mask, ids)
    case = tuple(x.cpu().numpy() for x in args)
    out, err = {"shard": r, "round": rnd, "active_edges": n_active}, {}

    def k12(grid):
        return frr.fused_relax_reduce(*args, nseg, "add_one", "min",
                                      plan=plan, grid_mode=grid)

    want = fused_relax_reduce_ref(*args, nseg, "add_one", "min")
    gval_m = frr._masked_value_tables(gval, gchg, math.inf)
    chunk_act, _ = frr._chunk_tables(src, mask, gchg)
    alone = {"K1": lambda: frr._launch(gval_m, src, w, mask, ids, plan,
                                       chunk_act, "add_one", "min", False),
             "K2": lambda: frr._launch_wl(gval_m, src, w, mask, ids, plan,
                                          chunk_act, None, "add_one", "min",
                                          False)}
    bound = 1e3 * (part.E_max * 5 + n_active * 4 + nseg * 9) \
        / HBM_BYTES_PER_S
    for key, grid in (("K1", "dense"), ("K2", "device_worklist")):
        got = k12(grid)
        check(torch.equal(got, want),
              f"{key} on shard {r}'s launch differs from its plain version")
        err[key] = max_abs_err(torch, got, want)
        out[key] = {"ms": time_ms(torch, lambda g=grid: k12(g)),
                    "kernel_ms": time_ms(torch, alone[key]),
                    "bound_ms": bound}
    _k1_orders(torch, np, frr, args, case, nseg, "add_one", "min",
               f"shard {r}, BFS round {rnd}")
    out["plain_ms"] = time_ms(torch, lambda: fused_relax_reduce_ref(
        *args, nseg, "add_one", "min"), reps=5)
    msg = torch.where(active, gval[src.long()] + 1.0, math.inf)
    out["library_ms"] = _library_ms(torch, "min", ids.long(), msg, nseg)

    q = LANES
    lv = torch.stack([gval] * (q // 2) + [sval.reshape(-1)] * (q // 2), 1)
    lc = torch.stack([gchg] * (q // 2) + [schg.reshape(-1)] * (q // 2), 1)
    unitw = torch.as_tensor([1] * (q // 2) + [0] * (q // 2),
                            dtype=torch.int32, device=dev)
    largs = (lv.contiguous(), lc.contiguous(), unitw, src, w, mask, ids)

    def k3():
        return frr.fused_relax_reduce_lanes(*largs, nseg, "add_w", "min",
                                            plan=plan)

    got = k3()
    lwant = fused_relax_reduce_lanes_ref(*largs, nseg, "add_w", "min")
    check(torch.equal(got, lwant),
          f"K3 on shard {r}'s launch differs from its plain version")
    err["K3"] = max_abs_err(torch, got, lwant)
    _k3_orders(torch, np, frr, largs, tuple(x.cpu().numpy() for x in largs),
               nseg, "add_w", "min", f"shard {r}, Q = {q}")
    lval_m = frr._masked_value_tables(largs[0], largs[1], math.inf)
    lchunk, _ = frr._lane_chunk_tables(src, mask, largs[1], plan.src_deg)
    unit_u8 = (unitw != 0).to(torch.uint8)
    l_active = int((mask & largs[1][src.long()].any(dim=1)).sum())
    out["K3"] = {"ms": time_ms(torch, k3),
                 "kernel_ms": time_ms(torch, lambda: frr._launch_lanes(
                     lval_m, unit_u8, src, w, mask, ids, plan, lchunk,
                     "add_w", "min", False)),
                 "plain_ms": time_ms(
                     torch, lambda: fused_relax_reduce_lanes_ref(
                         *largs, nseg, "add_w", "min"), reps=3),
                 "bound_ms": 1e3 * (part.E_max * 5 + l_active * 8
                                    + nseg * q * 9) / HBM_BYTES_PER_S}

    def k9():
        return rsr.segment_combine(msg, ids, nseg, "min", plan=plan)

    got = k9()
    check(torch.equal(got, segment_combine_ref(msg, ids, nseg, "min")),
          f"K9 on shard {r}'s launch differs from its plain version")
    model, _ = segment_combine_order(msg.cpu().numpy(), ids.cpu().numpy(),
                                     nseg, "min", rsr.PIECE_CELLS,
                                     edge_mask=mask.cpu().numpy())
    check(_k9_bits(torch, got, model),
          f"K9 on shard {r}'s launch differs from its order model")
    err["K9"] = 0.0
    out["K9"] = {"ms": time_ms(torch, k9),
                 "kernel_ms": time_ms(torch, _k9_raw(torch, frr, rsr, msg,
                                                     ids, plan, "min")),
                 "bound_ms": _segment_bound_ms(part.E_max, nseg)[0]}
    torch.cuda.synchronize()
    return out, err


def phase_sharded(torch, np, dev, g, part, root, want, part_pr, want_pr,
                  want_conv):
    """Phase 10: the one-rank NCCL run, the 16 ranks' legs on the one
    card (spawned, gloo), their results checked here, and one shard's
    kernels on the heaviest round.  Returns (launches, errors,
    report)."""
    import pickle
    import shutil

    import torch.multiprocessing as mp
    from repro_torch import apps
    from repro_torch.apps.pagerank import _pr_graph
    from repro_torch.core import engine
    from repro_torch.graph import reference
    from repro_torch.graph.graph import COOGraph
    from repro_torch.query import lanes as L
    t_phase = time.perf_counter()
    launches = _nccl_one_rank(torch, np, dev)

    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    deg = np.argsort(-g.out_degrees())
    queries = [("bfs", int(v)) for v in deg[:LANES // 2]] \
        + [("sssp", int(v)) for v in deg[LANES // 2:LANES]]
    rng = np.random.default_rng(SEED)
    inserts = (rng.integers(0, g.n, SHARD_INSERTS).astype(np.int32),
               rng.integers(0, g.n, SHARD_INSERTS).astype(np.int32),
               rng.integers(1, 10, SHARD_INSERTS).astype(np.float32))
    serve = _serve_requests(np, g)
    t0 = time.perf_counter()
    with open(SHARD_DIR / "data.pkl", "wb") as f:
        pickle.dump({"part": part, "part_pr": part_pr, "g": g, "root": root,
                     "queries": queries, "serve": serve,
                     "inserts": inserts}, f, protocol=5)
    spec = {"store": str(SHARD_DIR / "store"),
            "data": str(SHARD_DIR / "data.pkl")}
    log(f"[sharded] shipped the RMAT-{RMAT_SCALE} partitions and graph to "
        f"the ranks ({(SHARD_DIR / 'data.pkl').stat().st_size / 2**20:.0f} "
        f"MiB, {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_shard_rank, args=(SHARD_RANKS, spec),
                             nprocs=SHARD_RANKS, join=False,
                             start_method="spawn")

    # meanwhile: the stacked runs and oracles the ranks are held to
    stacked = {}
    for tag, cfg in _shard_configs(engine).items():
        for app in ("bfs", "sssp"):
            _, st, _ = getattr(apps, app)(g, root, part=part, cfg=cfg)
            stacked[f"{app}_{tag}"] = [int(x) for x in st]
    for tag in ("dense", "device_worklist"):
        res, st, _ = apps.batched_queries(g, queries, part=part,
                                          cfg=_shard_configs(engine)[tag])
        stacked[f"lanes_{tag}"] = (np.stack(res).astype(np.float64),
                                   np.stack([x.cpu().numpy() for x in st]))
    g_pr = _pr_graph(g)
    solo = []
    for kind, v, d in serve:
        if kind == "ppr":
            solo.append(None)
            continue
        app = apps.sssp if kind == "sssp" else apps.bfs
        vals, _, _ = app(g_pr, v, part=part_pr,
                         cfg=engine.EngineConfig(use_pallas=True))
        solo.append(vals != L.UNREACHED if kind == "reachability" else vals)
    ppr = [(v, d) for kind, v, d in serve if kind == "ppr"]
    ppr_want = _ppr_oracle(torch, np, g, [v for v, _ in ppr],
                           [d for _, d in ppr], dev)
    g_mut = COOGraph(g.n, np.concatenate([g.src, inserts[0]]),
                     np.concatenate([g.dst, inserts[1]]),
                     np.concatenate([g.weight, inserts[2]]))
    mut_want = {"bfs": reference.bfs_levels(g_mut, root),
                "sssp": reference.sssp_dijkstra(g_mut, root)}
    parent_s = time.perf_counter() - t0
    while not ctx.join():
        pass
    ranks_s = time.perf_counter() - t0
    got = dict(np.load(SHARD_DIR / "rank0.npz"))
    info = json.loads((SHARD_DIR / "rank0.json").read_text())
    for r in range(SHARD_RANKS):
        for k, n in json.loads(
                (SHARD_DIR / f"counts{r}.json").read_text()).items():
            launches[k] += n
    log(f"[sharded] {SHARD_RANKS} ranks on one card (gloo, mesh "
        f"{SHARD_MESH}): {ranks_s:.1f} s (set-up {info['setup_s']:.1f} s "
        f"a rank; stacked runs and oracles here meanwhile {parent_s:.1f} s)")
    for key, res in sorted(info["probe"].items()):
        log(f"[sharded] probe gloo CUDA {key}: {res}")

    for tag in _shard_configs(engine):
        for app in ("bfs", "sssp"):
            k = f"{app}_{tag}"
            check(np.array_equal(got[k], want[app]),
                  f"sharded {k} differs from the numpy oracle")
            check(list(got[f"{k}_stats"]) == stacked[k],
                  f"sharded {k} RunStats {list(got[f'{k}_stats'])} differ "
                  f"from the stacked run's {stacked[k]}")
    check(np.allclose(got["pagerank"], want_pr, rtol=PR_RTOL, atol=PR_ATOL),
          "sharded PageRank outside tolerance of the oracle")
    check(np.allclose(got["pagerank_delta"], want_conv, rtol=PR_RTOL,
                      atol=PR_ATOL),
          "sharded delta-PageRank outside tolerance of the oracle")
    for tag in ("dense", "device_worklist"):
        vals, st = stacked[f"lanes_{tag}"]
        check(np.array_equal(got[f"lanes_{tag}"], vals),
              f"sharded lanes ({tag}) differ from the stacked lanes")
        check(np.array_equal(got[f"lanes_{tag}_stats"], st),
              f"sharded LaneStats ({tag}) differ from the stacked run's")
    j = 0
    for i, (kind, v, d) in enumerate(serve):
        if kind == "ppr":
            check(np.allclose(got["served"][i], ppr_want[:, j],
                              rtol=PR_RTOL, atol=PR_ATOL),
                  f"served PPR from {v} outside tolerance of the oracle")
            j += 1
        else:
            check(np.array_equal(got["served"][i],
                                 np.asarray(solo[i], np.float64)),
                  f"served {kind} from {v} differs from its solo run")
    maint = info["legs"]["stream_commit"]["maint"]
    for app in ("bfs", "sssp"):
        check(np.array_equal(got[f"stream_{app}"], got[f"stream_cold_{app}"]),
              f"sharded streaming: warm {app} differs from a cold run")
        check(maint[app][1] < maint[f"cold_{app}"][1],
              f"sharded streaming: warm {app} sent {maint[app][1]} "
              f"messages, cold {maint[f'cold_{app}'][1]}")
    lv = got["stream_bfs"]
    levels = np.where(np.isfinite(lv), lv, 0).astype(np.int64)
    levels[~np.isfinite(lv)] = L.UNREACHED
    check(np.array_equal(levels, mut_want["bfs"]),
          "sharded streaming: BFS differs from the numpy oracle")
    dist_, wd = got["stream_sssp"], mut_want["sssp"]
    fin = np.isfinite(wd)
    check(np.array_equal(np.isfinite(dist_), fin)
          and np.array_equal(dist_[fin], wd[fin].astype(np.float32)),
          "sharded streaming: SSSP differs from the numpy oracle")
    check(np.array_equal(got["resilient"], want["sssp"]),
          "sharded resilient SSSP differs from the uninterrupted run")
    check(list(got["resilient_stats"]) == list(got["sssp_dense_stats"]),
          "sharded resilient RunStats differ from the uninterrupted run's")
    check(info["legs"]["resilient"]["report"]["status"] == "recovered",
          "the sharded resilient run did not recover from its fault")

    report = {"legs": info["legs"], "probe": info["probe"],
              "ranks_s": ranks_s, "parent_s": parent_s}
    for name, row in info["legs"].items():
        n = max(row["rounds"], 1)
        coll = sum(row["collective_s"].values())
        host = row["wall_s"] - coll - row["relax_s"]
        per = {op: b / n for op, b in row["bytes"].items()}
        kern = {k: row[k] for k in _COUNTERS if row[k]}
        log(f"[sharded] {name}: wall {row['wall_s']:.3f} s, {row['rounds']} "
            f"rounds; a round {1e3 * row['wall_s'] / n:.2f} ms = relax "
            f"{1e3 * row['relax_s'] / n:.2f} + collectives "
            f"{1e3 * coll / n:.2f} + host {1e3 * host / n:.2f} (rank 0); "
            f"kernels {kern}")
        log(f"[sharded] {name}: bytes a rank a round "
            + ", ".join(f"{op} {b:,.0f}" for op, b in sorted(per.items())))
    rs = info["legs"]["resilient"]["report"]
    log(f"[sharded] resilient: {SHARD_FAULT[0]} at round {SHARD_FAULT[1]} "
        f"on shard {SHARD_FAULT[2]}: {rs}")
    sm = info["legs"]["stream_commit"]
    log(f"[sharded] streaming: {SHARD_INSERTS} inserts, commit split "
        f"{ {k: round(v, 3) for k, v in sm['split'].items()} }, warm / cold "
        f"[rounds, messages] {sm['maint']}, StreamingGraph set-up "
        f"{sm['setup_s']:.1f} s")
    srv = info["legs"]["server"]
    log(f"[sharded] server: {len(serve)} requests in {srv['ticks']} ticks, "
        f"{srv['wall_s']:.2f} s ({len(serve) / srv['wall_s']:.1f} "
        f"requests/s), {srv['host_syncs']} host reads")

    kern, errs = _shard_kernels(torch, np, dev, part, root)
    report["kernels"] = kern
    log(f"[sharded] shard {kern['shard']}'s launch, BFS round "
        f"{kern['round']} ({kern['active_edges']} active edges), ms through "
        f"the wrapper (alone; bound): "
        + "; ".join(f"{k} {kern[k]['ms']:.4f} ({kern[k]['kernel_ms']:.4f}; "
                    f"{kern[k]['bound_ms']:.4f})"
                    for k in ("K1", "K2", "K3", "K9"))
        + f"; plain K1 {kern['plain_ms']:.4f}, K3 "
        f"{kern['K3']['plain_ms']:.4f}; library (scatter_reduce_ amin) "
        f"{kern['library_ms']:.4f}; each equal to its plain version, "
        "K1/K3/K9 to their order models")
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[sharded] phase 10: {report['phase_s']:.1f} s")
    return launches, errs, report


# --------------------------------------------------------------------------
# phase 11: the AM-CCA simulator and cost model on the card
# --------------------------------------------------------------------------

AMCCA_FIG8_CCS = (4096, 16384)        # fig8.py's two chip sizes
AMCCA_RPVO = (1, 2, 4, 8, 16)
AMCCA_FIG8_ROUNDS = 5                 # all-vertex rounds replayed


def _fields_equal(torch, card, cpu, where):
    """Every field of two SimResults / CostResults equal: tensors with
    dtype and shape, scalars exactly."""
    for f in dataclasses.fields(card):
        a, b = getattr(card, f.name), getattr(cpu, f.name)
        if torch.is_tensor(a):
            check(a.dtype == b.dtype and a.shape == b.shape
                  and torch.equal(a.cpu(), b.cpu()),
                  f"{where}: card and CPU differ in {f.name}")
        else:
            check(a == b, f"{where}: {f.name} card {a} != CPU {b}")


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _sim_twin(torch, dev, part, torus, sources, weights, where):
    """One simulator run on the card and the same on the CPU, equal
    field for field; returns (result, card s, CPU s)."""
    from repro_torch.core.amcca_sim import AmccaSim
    card, t_card = _timed(torch, lambda: AmccaSim(
        part, torus=torus, device=dev).run_min_app(sources, weights))
    cpu, t_cpu = _timed(torch, lambda: AmccaSim(
        part, torus=torus, device="cpu").run_min_app(sources, weights))
    _fields_equal(torch, card, cpu, where)
    return card, t_card, t_cpu


def _sim_oracle(np, part, res, want, where):
    """Root-slot values equal the numpy oracle (BFS levels or Dijkstra
    distances), unreached vertices infinite."""
    got = res.values.cpu().numpy()[part.root_flat]
    reached = np.isfinite(want) & (want != np.iinfo(np.int32).max)
    check(np.array_equal(got[reached], want[reached].astype(np.float64)),
          f"{where}: values differ from the oracle")
    check(bool(np.isinf(got[~reached]).all()),
          f"{where}: an unreached vertex has a value")


def phase_amcca(torch, np, dev):
    """Phase 11: fig6's and fig10's simulator configs and fig8's cost
    model on the card and on the CPU, equal field for field, values held
    to the numpy oracles; one simulator run at the paper's chip scale
    (RMAT-14, 4,096 CCs) on the card alone."""
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators, reference
    out = {}
    t_phase = time.perf_counter()

    # fig10 first: BFS on ba_skewed, mesh against torus (the first run
    # also warms the card up; its times are not kept)
    fig10 = []
    for rep, (n, shards) in enumerate(((600, 64), (600, 64), (1200, 256))):
        g = generators.ba_skewed(n, m_per=5, seed=9)
        root = int(np.argmax(g.out_degrees()))
        want = reference.bfs_levels(g, root)
        row = {"n": n, "ccs": shards}
        for torus in (False, True):
            part = build_partition(g, PartitionConfig(
                num_shards=shards, rpvo_max=4, local_edge_list_size=8,
                torus=torus, seed=8))
            where = f"fig10 n={n} {'torus' if torus else 'mesh'}"
            res, t_card, t_cpu = _sim_twin(torch, dev, part, torus,
                                           {root: 0.0}, False, where)
            _sim_oracle(np, part, res, want, where)
            key = "torus" if torus else "mesh"
            row[key] = {"cycles": res.cycles, "energy_pj": res.energy_pj,
                        "card_s": t_card, "cpu_s": t_cpu}
        if rep == 0:
            continue
        row["time_reduction_pct"] = 100 * (
            row["mesh"]["cycles"] - row["torus"]["cycles"]) \
            / row["mesh"]["cycles"]
        row["energy_increase_pct"] = 100 * (
            row["torus"]["energy_pj"] - row["mesh"]["energy_pj"]) \
            / row["mesh"]["energy_pj"]
        fig10.append(row)
        log(f"[amcca] fig10 ba_skewed({n}) on {shards} CCs, rpvo_max 4, "
            f"BFS: mesh {row['mesh']['cycles']} cycles, torus "
            f"{row['torus']['cycles']} (time -{row['time_reduction_pct']:.1f}"
            f"%, energy +{row['energy_increase_pct']:.1f}%); card "
            f"{row['mesh']['card_s']:.3f} / {row['torus']['card_s']:.3f} s, "
            f"CPU {row['mesh']['cpu_s']:.3f} / {row['torus']['cpu_s']:.3f} s")
    out["fig10"] = fig10

    # fig6: RMAT-10 SSSP on 256 CCs, rpvo_max 8, vicinity ghosts
    g = generators.rmat(10, edge_factor=8, seed=7).with_random_weights(seed=7)
    root = int(np.argmax(g.out_degrees()))
    part = build_partition(g, PartitionConfig(
        num_shards=256, rpvo_max=8, local_edge_list_size=8,
        ghost_alloc="vicinity", seed=1))
    res, t_card, t_cpu = _sim_twin(torch, dev, part, True, {root: 0.0}, True,
                                   "fig6")
    _sim_oracle(np, part, res, reference.sssp_dijkstra(g, root), "fig6")
    out["fig6"] = {
        "cycles": res.cycles, "actions": res.actions_executed,
        "work_actions": res.work_actions, "staged": res.diffusions_staged,
        "pruned": res.diffusions_pruned,
        "stalls": res.contention_stall_cycles, "card_s": t_card,
        "cpu_s": t_cpu, "card_ms_per_cycle": 1e3 * t_card / res.cycles,
        "cpu_ms_per_cycle": 1e3 * t_cpu / res.cycles}
    log(f"[amcca] fig6 RMAT-10 SSSP on 256 CCs, rpvo_max 8: "
        f"{res.cycles} cycles, {res.actions_executed} actions "
        f"({100 * res.work_actions / res.actions_executed:.1f}% work), "
        f"{res.diffusions_pruned} of {res.diffusions_staged} staged "
        f"diffusions pruned, {res.contention_stall_cycles} stalls; card "
        f"{t_card:.3f} s ({out['fig6']['card_ms_per_cycle']:.3f} ms a "
        f"cycle), CPU {t_cpu:.3f} s ({out['fig6']['cpu_ms_per_cycle']:.3f}"
        f" ms a cycle)")

    # fig8: the cost model's all-vertex rounds at 4,096 and 16,384 CCs
    g = generators.ba_skewed(1 << 14, m_per=8, seed=3)
    trace = [np.arange(g.n, dtype=np.int64)] * AMCCA_FIG8_ROUNDS
    fig8 = []
    for ccs in AMCCA_FIG8_CCS:
        base = None
        for rmax in AMCCA_RPVO:
            part = build_partition(g, PartitionConfig(
                num_shards=ccs, rpvo_max=rmax, local_edge_list_size=16,
                seed=6))
            cm = CostModel(part, torus=True, device=dev)
            cm.replay(trace[:1])                      # warm
            card, t_card = _timed(torch, lambda: cm.replay(trace))
            cpu, t_cpu = _timed(torch, lambda: CostModel(
                part, torus=True, device="cpu").replay(trace))
            where = f"fig8 {ccs} CCs rpvo_max {rmax}"
            _fields_equal(torch, card, cpu, where)
            check(card.rounds == AMCCA_FIG8_ROUNDS, f"{where}: rounds")
            base = base if base is not None else card.cycles
            fig8.append({"ccs": ccs, "rpvo_max": rmax,
                         "cycles": card.cycles, "speedup": base / card.cycles,
                         "messages": card.messages,
                         "max_link_load": card.max_link_load,
                         "card_ms": 1e3 * t_card, "cpu_ms": 1e3 * t_cpu})
        rows = [r for r in fig8 if r["ccs"] == ccs]
        log(f"[amcca] fig8 ba_skewed(2^14) on {ccs} CCs, "
            f"{AMCCA_FIG8_ROUNDS} all-vertex rounds, speedup over "
            f"rpvo_max 1: " + ", ".join(
                f"{r['rpvo_max']}: {r['speedup']:.2f}" for r in rows)
            + "; replay card " + "/".join(f"{r['card_ms']:.1f}"
                                          for r in rows)
            + " ms, CPU " + "/".join(f"{r['cpu_ms']:.1f}" for r in rows)
            + " ms")
    out["fig8"] = fig8

    # the paper's chip scale: RMAT-14 BFS on 64x64 CCs, on the card only
    g = generators.rmat(14, edge_factor=8, seed=7)
    root = int(np.argmax(g.out_degrees()))
    part = build_partition(g, PartitionConfig(
        num_shards=4096, rpvo_max=4, local_edge_list_size=8, seed=1))
    from repro_torch.core.amcca_sim import AmccaSim
    res, t_card = _timed(torch, lambda: AmccaSim(
        part, torus=True, device=dev).run_min_app({root: 0.0}, False))
    _sim_oracle(np, part, res, reference.bfs_levels(g, root), "R14 BFS")
    out["r14"] = {"cycles": res.cycles, "injected": res.messages_injected,
                  "hops": res.hops_total, "stalls":
                  res.contention_stall_cycles, "max_inflight":
                  res.max_inflight, "energy_pj": res.energy_pj,
                  "card_s": t_card, "card_ms_per_cycle":
                  1e3 * t_card / res.cycles}
    log(f"[amcca] RMAT-14 BFS on 4,096 CCs (64x64 torus), rpvo_max 4: "
        f"{res.cycles} cycles, {res.messages_injected} messages, "
        f"{res.contention_stall_cycles} stalls, {res.max_inflight} in "
        f"flight at most; card {t_card:.3f} s "
        f"({out['r14']['card_ms_per_cycle']:.3f} ms a cycle)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[amcca] phase 11: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 12: the LM serving path
# --------------------------------------------------------------------------

LM_FULL_ARCH = "minitron-4b"
LM_SLOTS, LM_MAX_LEN = 8, 1024
LM_REQUESTS, LM_MAX_NEW = 16, 32
LM_PROMPT_LENS = (64, 512)            # drawn uniformly, both included
LM_TOKENS_GREEDY = 8                  # phase 12a's greedy tokens
LM_REDUCED_TOL = 1e-4                 # float32 card vs CPU, rtol and atol
BF16_ULP = 2.0 ** -8
LM_BF16_ULPS = 8      # bf16 tolerance: 8 ulps of the row's largest logit
LM_DVP_ARCHS = ("granite-moe-1b-a400m", "xlstm-125m")
LM_DVP_BATCH, LM_DVP_PROMPT, LM_DVP_STEPS = 4, 256, 16
# a near-tie of the router: how far (in probability) a forced expert may
# sit under the step's own k-th choice; the float32 gap between two ways
# of computing one position is ~1e-8, a router's typical gap ~1e-4
LM_ROUTE_TIE = 1e-6


def _bf16_tol(scale):
    return LM_BF16_ULPS * BF16_ULP * max(1.0, float(scale))


@contextlib.contextmanager
def _force_routing(moe, forced):
    """The n-th MoE routing while open takes the expert indices
    ``forced[n]`` (gates read from its own probabilities) and appends how
    far the forced experts' probabilities fall below its own k-th
    largest: 0 where the forced set is its own choice."""
    ties = []
    top_k = moe.top_k

    def forcing(probs, k):
        vals, _ = top_k(probs, k)
        idx = forced[len(ties)].to(probs.device).reshape(vals.shape)
        got = probs.gather(-1, idx)
        ties.append(float((vals[..., -1:] - got).clamp_min(0).max()))
        return got, idx

    moe.top_k = forcing
    try:
        yield ties
    finally:
        moe.top_k = top_k


@contextlib.contextmanager
def _record_routing(moe):
    """Collects the expert indices of every MoE routing while open."""
    seen = []
    top_k = moe.top_k

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        seen.append(idx.cpu())
        return vals, idx

    moe.top_k = recording
    try:
        yield seen
    finally:
        moe.top_k = top_k


def _lm_batch(np, cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "enc_dec":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return b


def _greedy(torch, model, batch, n_tokens, max_len):
    """Prefill, then ``n_tokens - 1`` greedy decode steps: (first logits,
    (B, n_tokens) tokens)."""
    B = batch["tokens"].shape[0]
    pre = model.cfg.n_patches if model.cfg.family == "vlm" else 0
    params = model.param_tree()
    logits, caches = model.prefill(params, batch,
                                   model.init_cache(B, max_len))
    first = logits
    toks = [logits[:, -1].argmax(-1)]
    for i in range(n_tokens - 1):
        logits, caches = model.decode_step(
            params, toks[-1][:, None], caches,
            pre + batch["tokens"].shape[1] + i)
        toks.append(logits[:, -1].argmax(-1))
    return first, torch.stack(toks, 1)


def _lm_reduced_twins(torch, np, dev):
    """12a: every arch at reduced width in float32, the same weights on
    the card and on the CPU: prefill logits within LM_REDUCED_TOL, the
    greedy tokens and every MoE routing's expert indices equal."""
    from repro_torch.lm.configs import ARCHS
    from repro_torch.lm.models import moe
    from repro_torch.lm.models.model import Model
    rows = {}
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].reduced()
        cpu = Model(cfg, device="cpu")
        cpu.init(torch.Generator().manual_seed(0))
        card = Model(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        batch = _lm_batch(np, cfg, 2, 16, 1)
        max_len = (cfg.n_patches if cfg.family == "vlm" else 0) + 16 \
            + LM_TOKENS_GREEDY
        runs = {}
        for name, model in (("card", card), ("cpu", cpu)):
            with _record_routing(moe) as seen:
                t0 = time.perf_counter()
                logits, toks = _greedy(torch, model, batch, LM_TOKENS_GREEDY,
                                       max_len)
                toks = toks.cpu()
                runs[name] = (logits.float().cpu(), toks, seen,
                              time.perf_counter() - t0)
        (lc, tc, rc, sc), (lp, tp, rp, sp) = runs["card"], runs["cpu"]
        err = float((lc - lp).abs().max())
        check(torch.allclose(lc, lp, rtol=LM_REDUCED_TOL, atol=LM_REDUCED_TOL),
              f"[lm-serve] {arch}: card prefill logits differ from the CPU "
              f"by {err:.3g}")
        check(torch.equal(tc, tp),
              f"[lm-serve] {arch}: greedy tokens differ: {tc.tolist()} vs "
              f"{tp.tolist()}")
        check(len(rc) == len(rp) and all(torch.equal(a, b)
                                         for a, b in zip(rc, rp)),
              f"[lm-serve] {arch}: MoE expert indices differ")
        rows[arch] = {"max_abs_err": err, "routings": len(rc),
                      "card_s": sc, "cpu_s": sp}
        log(f"[lm-serve] 12a {arch} reduced float32: prefill logits max "
            f"|card - CPU| {err:.3g}, {LM_TOKENS_GREEDY} greedy tokens x 2 "
            f"equal, {len(rc)} MoE routings' expert indices equal; card "
            f"{sc:.3f} s, CPU {sp:.3f} s")
    return rows


def _single_stream(torch, model, params, prompt, forced, max_len):
    """One request alone, teacher-forced on the batched answer
    ``forced``: at each step the single-stream argmax, its top-2 margin,
    its logit of the forced token, the row's largest |logit|; and the
    prefill's seconds."""
    dev = model.device
    caches = model.init_cache(1, max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": prompt[None]}, caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    steps = []
    for j, tok in enumerate(forced):
        row = logits[0, -1].float()
        top2 = row.topk(2)          # its values; argmax picks among ties
        steps.append((int(row.argmax()),
                       float(top2.values[0] - top2.values[1]),
                       float(top2.values[0] - row[tok]),
                       float(row.abs().max())))
        if j < len(forced) - 1:
            logits, caches = model.decode_step(
                params, torch.tensor([[tok]], device=dev), caches,
                len(prompt) + j)
    return steps, prefill_s


def _batch_vs_one(torch, model, params, prompts):
    """One decode step of every prompt in an LM_SLOTS-slot cache at
    per-slot positions against each prompt's own B = 1 step: the largest
    |logit difference| over the row's largest |logit|, in bf16 ulps."""
    from repro_torch.serve.scheduler import _slot_views
    dev = model.device
    caches = model.init_cache(LM_SLOTS, LM_MAX_LEN)
    pos, last, worst = [], [], 0.0
    for s, p in enumerate(prompts[:LM_SLOTS]):
        lg, _ = model.prefill(params, {"tokens": p[None]},
                              _slot_views(caches, s))
        pos.append(len(p))
        last.append(int(lg[0, -1].argmax()))
    toks = torch.tensor(last, device=dev)[:, None]
    batched, _ = model.decode_step(params, toks, caches,
                                   torch.tensor(pos, device=dev))
    for s, p in enumerate(prompts[:LM_SLOTS]):
        one = model.init_cache(1, LM_MAX_LEN)
        model.prefill(params, {"tokens": p[None]}, one)
        lg, _ = model.decode_step(params, toks[s:s + 1], one, len(p))
        row = lg[0, -1].float()
        worst = max(worst, float((batched[s, -1].float() - row).abs().max())
                    / (BF16_ULP * float(row.abs().max())))
    return worst, (toks, caches, torch.tensor(pos, device=dev))


def _lm_full_serve(torch, np, dev, cfg):
    """12b: a ContinuousBatcher of LM_SLOTS slots answers LM_REQUESTS
    requests on ``cfg`` (minitron-4b at full width, bfloat16, weights
    drawn on the card from seed 0).  Each answer is held to its
    single-stream run, fed the answer's own tokens: equal up to the first
    step whose single-stream top-2 margin is under the bf16 tolerance
    (what a greedy single-stream run would give), and at every step the
    answer's token within the tolerance of the single-stream top logit."""
    import types
    from repro_torch import obs
    from repro_torch.lm.models.model import Model
    from repro_torch.serve.scheduler import ContinuousBatcher, Request
    model = Model(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    (params, _), init_s = _timed(torch, lambda: model.init(
        torch.Generator(device=dev).manual_seed(0)))
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1,
                        LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]

    warm = ContinuousBatcher(model, params, n_slots=LM_SLOTS,
                             max_len=LM_MAX_LEN)
    warm.submit(Request(rid=-1, tokens=prompts[0][:64], max_new=4))
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    batcher = ContinuousBatcher(model, params, n_slots=LM_SLOTS,
                                max_len=LM_MAX_LEN)
    reqs = [Request(rid=i, tokens=p, max_new=LM_MAX_NEW)
            for i, p in enumerate(prompts)]
    with obs.recording() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            batcher.submit(r)
        done = batcher.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(done) == LM_REQUESTS and all(
        r.done and len(r.out) == LM_MAX_NEW for r in reqs),
        "[lm-serve] a request did not finish")
    events = rec.tracer.events()
    prefill_s = sum(e["dur"] for e in events if e["name"] == "prefill") / 1e6
    ticks = [e for e in events if e["name"] == "tick"]
    tick_s = sum(e["dur"] for e in ticks) / 1e6
    decode_tokens = sum(e["args"]["active"] for e in ticks)
    decode_s = tick_s - prefill_s

    held = whole = 0
    worst_gap = 0.0
    solo_prefill = []
    for r, p in zip(reqs, prompts):
        steps, ps = _single_stream(torch, model, params, p, r.out,
                                   LM_MAX_LEN)
        solo_prefill.append((len(p), ps))
        upto = next((j for j, (_, m, _, s) in enumerate(steps)
                     if m < _bf16_tol(s)), LM_MAX_NEW)
        want = [a for a, _, _, _ in steps]
        check(r.out[:upto] == want[:upto],
              f"[lm-serve] request {r.rid} (prompt {len(p)}): batched "
              f"{r.out[:upto]} differs from single-stream {want[:upto]} "
              f"before step {upto}")
        for j, (_, _, gap, s) in enumerate(steps):
            check(gap <= _bf16_tol(s),
                  f"[lm-serve] request {r.rid} step {j}: the batched token's "
                  f"single-stream logit is {gap:.4g} under the top "
                  f"(tolerance {_bf16_tol(s):.4g})")
            worst_gap = max(worst_gap, gap / _bf16_tol(s))
        held += upto
        whole += r.out == want
    ulps, probe = _batch_vs_one(torch, model, params, prompts)
    toks, caches, pos = probe
    prof = _tick_profile(torch, types.SimpleNamespace(
        step=lambda: model.decode_step(params, toks, caches, pos)), ticks=3)
    out = {
        "arch": cfg.name, "params": n_params, "param_bytes": sum(
            p.numel() * p.element_size() for p in model.parameters()),
        "init_s": init_s, "requests": LM_REQUESTS, "slots": LM_SLOTS,
        "max_len": LM_MAX_LEN, "prompt_lens": [int(n) for n in lens],
        "wall_s": wall, "requests_per_s": LM_REQUESTS / wall,
        "ticks": batcher.tick, "decode_tokens": decode_tokens,
        "decode_s": decode_s, "decode_tokens_per_s": decode_tokens / decode_s,
        "batched_prefill_s": prefill_s,
        "solo_prefill_ms_mean": 1e3 * statistics.mean(
            s for _, s in solo_prefill),
        "solo_prefill_ms_per_token": 1e3 * sum(s for _, s in solo_prefill)
        / sum(n for n, _ in solo_prefill),
        "max_memory_allocated": peak, "tokens_held": held,
        "tokens_total": LM_REQUESTS * LM_MAX_NEW,
        "answers_equal_whole": whole, "worst_gap_over_tol": worst_gap,
        "batch_vs_one_ulps": ulps, "decode_profile": prof}
    log(f"[lm-serve] 12b {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}; "
        f"{n_params / 1e9:.3f} B parameters, "
        f"{out['param_bytes'] / 1e9:.2f} GB; drawn in {init_s:.2f} s): "
        f"{LM_REQUESTS} requests (prompts {min(lens)}-{max(lens)}, "
        f"{LM_MAX_NEW} new) on {LM_SLOTS} slots in {wall:.3f} s = "
        f"{out['requests_per_s']:.2f} requests/s, {batcher.tick} ticks; "
        f"decode {decode_tokens} tokens in {decode_s:.3f} s = "
        f"{out['decode_tokens_per_s']:.1f} tokens/s; slot prefills "
        f"{prefill_s:.3f} s; single-stream prefill "
        f"{out['solo_prefill_ms_mean']:.2f} ms a prompt "
        f"({out['solo_prefill_ms_per_token']:.4f} ms a token); peak "
        f"{peak / 2**30:.2f} GiB allocated")
    log(f"[lm-serve] 12b answers vs single-stream: {held} of "
        f"{out['tokens_total']} tokens equal before a top-2 margin under "
        f"{LM_BF16_ULPS} bf16 ulps; every token within the tolerance of the "
        f"single-stream top (worst {worst_gap:.3f} of it); {whole} of "
        f"{LM_REQUESTS} answers equal whole; one {LM_SLOTS}-slot decode "
        f"step against B = 1 steps: {ulps:.1f} bf16 ulps of the row's "
        f"largest |logit| at most")
    log(f"[lm-serve] 12b one {LM_SLOTS}-slot decode step (profiled, 3 "
        f"steps): {prof['wall_ms'] / 3:.2f} ms wall, device busy "
        f"{100 * prof['busy']:.1f}%, {prof['kernels'] / 3:.0f} kernels a "
        f"step; top: " + "; ".join(f"{n} {ms:.3f} ms x{c}"
                                   for n, ms, c in prof["top"][:4]))
    del model, params, caches, batcher
    return out


def _dvp_config(cfg):
    """12c's config of an MoE arch: float32, and a capacity factor of
    E / K, so no token is dropped.  A prefill of B*S tokens drops
    tokens over an expert's capacity (0-15% a layer for granite at
    S = 257) where a decode step's one token a group never is, and a
    bfloat16 rounding of the hidden state flips the router's top-8 among
    32 near-equal experts: either makes the two paths different
    functions, so the check holds the cache handoff alone."""
    if cfg.moe is None:
        return cfg
    moe = dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               moe=moe)


def _lm_decode_vs_prefill(torch, np, dev, cfg):
    """12c: prefill LM_DVP_BATCH x LM_DVP_PROMPT tokens, then
    LM_DVP_STEPS teacher-forced decode steps at per-sequence positions
    (each sequence routes its MoE token alone), each step's logits
    within the tolerance of a prefill of the extended sequence, on
    ``_dvp_config``'s config.  Each MoE routing of the decoded token is
    forced to the prefill's routing of that position, which may differ
    from the step's own top-k only at a near-tie (LM_ROUTE_TIE), so the
    logits compare the cache handoff.  bfloat16: 8 ulps of the row's
    largest |logit|; float32: 2^-10 of it."""
    from repro_torch.lm.models import moe
    from repro_torch.lm.models.model import Model
    model = Model(cfg, device=dev)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    B, S, n = LM_DVP_BATCH, LM_DVP_PROMPT, LM_DVP_STEPS
    rel = LM_BF16_ULPS * BF16_ULP if cfg.dtype == "bfloat16" else 2.0 ** -10
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + n)),
                           device=dev)
    caches = model.init_cache(B, S + n)
    _, caches = model.prefill(params, {"tokens": toks[:, :S]}, caches)
    worst = worst_err = worst_tie = 0.0
    routings = flips = 0
    t0 = time.perf_counter()
    for i in range(n):
        with _record_routing(moe) as seen_full:
            full, _ = model.prefill(params, {"tokens": toks[:, :S + i + 1]},
                                    model.init_cache(B, S + i + 1))
        # the prefill's routing of the decoded position (last in each
        # sequence of its (1, B*(S+i+1), K) indices), forced on the step
        forced = [f.reshape(B, S + i + 1, -1)[:, -1:] for f in seen_full]
        with _force_routing(moe, forced) as ties:
            dec, caches = model.decode_step(
                params, toks[:, S + i:S + i + 1], caches,
                torch.full((B,), S + i, device=dev))
        check(len(ties) == len(forced),
              f"[lm-serve] {cfg.name}: routing counts differ")
        for layer, tie in enumerate(ties):
            check(tie <= LM_ROUTE_TIE,
                  f"[lm-serve] {cfg.name}: decode step {i} routes a token "
                  f"of MoE layer {layer} off the prefill's experts by "
                  f"{tie:.3g} of probability (a near-tie is under "
                  f"{LM_ROUTE_TIE:g})")
            flips += tie > 0
            worst_tie = max(worst_tie, tie)
        routings += len(ties)
        d, f = dec[:, -1].float(), full[:, -1].float()
        err = float((d - f).abs().max())
        tol = rel * max(1.0, float(f.abs().max()))
        check(err <= tol, f"[lm-serve] {cfg.name}: decode step {i} logits "
              f"differ from the prefill by {err:.4g} > {tol:.4g}")
        worst = max(worst, err / tol)
        worst_err = max(worst_err, err)
    torch.cuda.synchronize()
    row = {"dtype": cfg.dtype, "worst_err_over_tol": worst,
           "worst_abs_err": worst_err, "moe_routings": routings,
           "moe_near_ties": flips, "worst_tie": worst_tie,
           "s": time.perf_counter() - t0}
    log(f"[lm-serve] 12c {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}): {B}x{S} prefill, {n} decode steps "
        f"each within {rel:.4g} of the row's largest |logit| of the "
        f"extended prefill (worst |decode - prefill| {worst_err:.4g}, "
        f"{worst:.3f} of the tolerance); {routings} MoE routings forced to "
        f"the prefill's, {flips} of them off the step's own choice by at "
        f"most {worst_tie:.3g} of probability; {row['s']:.2f} s")
    del model, params, caches
    return row


def phase_lm_serve(torch, np, dev, full=True):
    """Phase 12: the LM serving path (12a, 12b, 12c).  ``full=False``
    runs 12b and 12c at reduced width, for a rehearsal."""
    from repro_torch.lm.configs import get_config
    t_phase = time.perf_counter()
    out = {"reduced": _lm_reduced_twins(torch, np, dev)}
    width = (lambda c: c) if full else (
        lambda c: dataclasses.replace(c.reduced(), dtype="bfloat16",
                                      param_dtype="bfloat16"))
    out["serve"] = _lm_full_serve(torch, np, dev,
                                  width(get_config(LM_FULL_ARCH)))
    torch.cuda.empty_cache()
    out["decode_vs_prefill"] = {
        arch: _lm_decode_vs_prefill(torch, np, dev,
                                    _dvp_config(width(get_config(arch))))
        for arch in LM_DVP_ARCHS}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm-serve] phase 12: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 13: the LM training path
# --------------------------------------------------------------------------

# 13a: card against CPU in float32 at reduced width.  Loss and metrics
# within rtol 1e-5; a gradient within rtol 1e-4 and an atol of 1e-5 of the
# model's largest |gradient| (a key bias's gradient is zero in exact
# arithmetic and ~1e-8 of noise in either device's float32 sums; the CPU
# tests hold the port to jax.grad the same way)
LM_TRAIN_LOSS_RTOL = 1e-5
LM_TRAIN_GRAD_RTOL, LM_TRAIN_GRAD_ATOL_OF_MAX = 1e-4, 1e-5
# one train step's parameters: tests/test_grad_accum.py's tolerance, but
# an entry whose clipped gradient is under LM_EPS_REGIME (100 Adam eps)
# moves by lr * g / (|g| + eps), a ratio at the float32 noise of the
# backward: it is held to one lr, the most a step can move it
LM_STEP_RTOL, LM_STEP_ATOL = 5e-4, 6e-4
LM_EPS_REGIME = 1e-6
LM_TRAIN_STEP_ARCHS = ("minitron-4b", "granite-moe-1b-a400m")
LM_TRAIN_LR = 3e-4
# 13b: minitron-4b at full width and depth
LM_TRAIN_ARCH = "minitron-4b"
LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_STEPS = 512, 4, 8
LM_TRAIN_CE_RANGE = (12.0, 14.0)     # ln 256,000 = 12.45, + ~0.5 (unit logits)
LM_TRAIN_PEAK_GIB = 75.0
H100_BF16_FLOPS = 989.4e12           # dense bf16 peak, H100 SXM5 (80GB HBM3)
# 13c: granite-moe-1b-a400m at full width, cut to 2 layers
LM_RESUME_ARCH, LM_RESUME_LAYERS = "granite-moe-1b-a400m", 2
LM_RESUME_STEPS, LM_RESUME_EVERY, LM_RESUME_KILL = 6, 2, 5
LM_TRAIN_DIR = ROOT / "chip_smoke_out" / "lm_train"


def _loss_grads(torch, model, batch):
    """(loss, metrics, {name: gradient}) of ``model.loss`` and its
    backward, with every ``.grad`` cleared afterwards."""
    from repro_torch.lm.models.model import _flatten
    params = model.param_tree()
    leaves = _flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss(params, batch)
        loss.backward()
        grads = {k: p.grad.detach().float().cpu() for k, p in leaves.items()}
    finally:
        for p in leaves.values():
            p.grad = None
            p.requires_grad_(False)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()}, grads)


def _grads_err(torch, got, want, where):
    """Every gradient leaf within the 13a tolerance; the largest |got -
    want| over the largest |want|."""
    top = max(float(w.abs().max()) for w in want.values())
    atol = LM_TRAIN_GRAD_ATOL_OF_MAX * top
    for k in want:
        check(torch.allclose(got[k], want[k], rtol=LM_TRAIN_GRAD_RTOL,
                             atol=atol),
              f"{where}: gradient {k} differs by "
              f"{float((got[k] - want[k]).abs().max()):.3g} (atol {atol:.3g})")
    return max(float((got[k] - want[k]).abs().max()) for k in want) / top


def _step_err(torch, a, b, where):
    """Two states after one step: parameters within LM_STEP_RTOL /
    LM_STEP_ATOL, except entries in Adam's eps regime (``b``'s clipped
    gradient, its first moment over 1 - b1, under LM_EPS_REGIME), held to
    one lr.  Returns the largest |a - b| and the eps-regime count."""
    from repro_torch.lm.models.model import _flatten
    pa, pb = _flatten(a.params), _flatten(b.params)
    mu = _flatten(b.opt.mu)
    worst, tiny_n = 0.0, 0
    for k in pb:
        x, y = pa[k].float(), pb[k].float()
        tiny = (mu[k] / (1 - 0.9)).abs() < LM_EPS_REGIME
        tiny_n += int(tiny.sum())
        bad = ((x - y).abs() > LM_STEP_ATOL + LM_STEP_RTOL * y.abs()) & ~tiny
        check(not bool(bad.any()) and bool(
            ((x - y).abs()[tiny] <= LM_TRAIN_LR).all()),
              f"{where}: parameter {k} differs by "
              f"{float((x - y).abs().max()):.3g} after one step")
        worst = max(worst, float((x - y).abs().max()))
    return worst, tiny_n


def _model_like(cfg, dev, src):
    """A model of ``cfg`` on ``dev`` holding ``src``'s weights."""
    from repro_torch.lm.models.model import Model
    model = Model(cfg, device=dev)
    model.load_state_dict(src.state_dict())
    return model


def _one_step(torch, model, batch, **kw):
    from repro_torch.lm.train import AdamW, make_train_step
    from repro_torch.lm.train.train_step import TrainState
    opt = AdamW(lr=LM_TRAIN_LR)
    params = model.param_tree()
    state, metrics = make_train_step(model, opt, **kw)(
        TrainState(params, opt.init(params), None), batch)
    return state, {k: float(v) for k, v in metrics.items()}


def _lm_train_twins(torch, np, dev):
    """13a: every arch at reduced width in float32, the same weights on
    the card and on the CPU: loss, metrics and every gradient leaf; for
    LM_TRAIN_STEP_ARCHS also remat on against off and accum_steps=4
    against one step on the card."""
    from repro_torch.data import TokenPipeline
    from repro_torch.lm.configs import ARCHS
    from repro_torch.lm.models.model import Model
    rows = {}
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].reduced()
        cpu = Model(cfg, device="cpu")
        cpu.init(torch.Generator().manual_seed(0))
        card = _model_like(cfg, dev, cpu)
        batch = _lm_batch(np, cfg, 2, 16, 2)
        t0 = time.perf_counter()
        lc, mc, gc = _loss_grads(torch, card, batch)
        card_s = time.perf_counter() - t0
        lp, mp, gp = _loss_grads(torch, cpu, batch)
        check(abs(lc - lp) <= LM_TRAIN_LOSS_RTOL * abs(lp) and set(mc) == set(
            mp) and all(abs(mc[k] - mp[k]) <= LM_TRAIN_LOSS_RTOL * abs(mp[k])
                        for k in mp),
              f"[lm-train] {arch}: card loss {lc} / metrics {mc} differ from "
              f"the CPU's {lp} / {mp}")
        rows[arch] = {"loss": lc, "loss_rel_err": abs(lc - lp) / abs(lp),
                      "grad_err_of_max": _grads_err(
                          torch, gc, gp, f"[lm-train] {arch}"),
                      "card_s": card_s}
        line = (f"[lm-train] 13a {arch} reduced float32: loss {lc:.6f}, "
                f"|card - CPU| {rows[arch]['loss_rel_err']:.2e} of it; "
                f"{len(gc)} gradient leaves within rtol "
                f"{LM_TRAIN_GRAD_RTOL:g} + {LM_TRAIN_GRAD_ATOL_OF_MAX:g} of "
                f"the largest (worst {rows[arch]['grad_err_of_max']:.2e} of "
                f"it)")
        if arch in LM_TRAIN_STEP_ARCHS:
            on = _model_like(dataclasses.replace(cfg, remat=True), dev, cpu)
            off = _model_like(dataclasses.replace(cfg, remat=False), dev,
                              cpu)
            _, _, g_on = _loss_grads(torch, on, batch)
            _, _, g_off = _loss_grads(torch, off, batch)
            remat_grad = _grads_err(torch, g_on, g_off,
                                    f"[lm-train] {arch} remat")
            pipe_batch = TokenPipeline(vocab=cfg.vocab, seq_len=16,
                                       global_batch=8, seed=2).batch_at(0)
            s_on, _ = _one_step(torch, on, pipe_batch)
            s_off, _ = _one_step(torch, off, pipe_batch)
            remat_step, _ = _step_err(torch, s_on, s_off,
                                      f"[lm-train] {arch} remat step")
            # a microbatch of B/4 sequences routes with a quarter of the
            # capacity and drops other tokens than the whole batch: the
            # MoE arch runs at capacity factor E/K (no drops), so the two
            # are one function
            full, acc = (_model_like(_dvp_config(cfg), dev, cpu)
                         for _ in range(2))
            s_full, m_full = _one_step(torch, full, pipe_batch)
            s_acc, m_acc = _one_step(torch, acc, pipe_batch, accum_steps=4)
            check(abs(m_acc["ce"] - m_full["ce"]) <= 1e-5 * abs(m_full["ce"]),
                  f"[lm-train] {arch}: accum_steps=4 ce {m_acc['ce']} vs "
                  f"{m_full['ce']}")
            accum_step, tiny = _step_err(torch, s_acc, s_full,
                                         f"[lm-train] {arch} accum")
            rows[arch].update(remat_grad_err_of_max=remat_grad,
                              remat_step_err=remat_step,
                              accum_step_err=accum_step, eps_regime=tiny)
            line += (f"; remat on/off gradients {remat_grad:.2e} of the "
                     f"largest, one step {remat_step:.3g}; accum_steps=4 vs "
                     f"1{' (no MoE drops)' if cfg.moe else ''} ce within "
                     f"1e-5, one step {accum_step:.3g} (rtol "
                     f"{LM_STEP_RTOL:g}, atol {LM_STEP_ATOL:g}; {tiny} "
                     f"entries in Adam's eps regime held to one lr)")
        log(line)
    return rows


class _TimedOpt:
    """An optimizer whose ``update`` is timed on the host clock between
    two ``torch.cuda.synchronize()``s (``seconds``, one a step)."""

    def __init__(self, torch, opt):
        self.torch, self.opt, self.seconds = torch, opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.opt.update(grads, state, params)
        self.torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def _lm_train_full(torch, np, dev, cfg, smi, seq, batch_size, steps):
    """13b: ``Trainer`` on ``cfg`` (minitron-4b at full width and depth,
    bfloat16, remat on, weights drawn on the card from seed 0) for
    ``steps`` steps of ``TokenPipeline(vocab, seq, batch_size, seed=0)``
    at a constant lr: ms a step (forward + backward, optimizer),
    tokens/s, MFU, peak memory, and one profiled step's kernels and
    device busy share."""
    import shutil
    import types
    from repro_torch.data import TokenPipeline
    from repro_torch.lm.configs.base import ShapeSpec
    from repro_torch.lm.launch.specs import model_flops, param_count
    from repro_torch.lm.models.model import Model
    from repro_torch.lm.train import AdamW
    from repro_torch.lm.train.trainer import Trainer, TrainerConfig
    ckpt_dir = LM_TRAIN_DIR / "full"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    opt = _TimedOpt(torch, AdamW(lr=LM_TRAIN_LR))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq,
                         global_batch=batch_size, seed=0)
    trainer = Trainer(model, opt, pipe, TrainerConfig(
        steps=steps, ckpt_every=steps + 1, ckpt_dir=str(ckpt_dir),
        log_every=1))
    state, init_s = _timed(torch, lambda: trainer.init_state(0))
    step_s = []
    inner = trainer.step_fn

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out
    trainer.step_fn = timed_step
    state, run_s = _timed(torch, lambda: trainer.run(state))
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    check(len(hist) == steps and all(
        math.isfinite(v) for h in hist for v in h.values()),
        f"[lm-train] 13b: a metric is not finite: {hist}")
    ce0, ce_last = hist[0]["ce"], hist[-1]["ce"]
    check(LM_TRAIN_CE_RANGE[0] <= ce0 <= LM_TRAIN_CE_RANGE[1],
          f"[lm-train] 13b: step 0's ce {ce0:.4f} is outside "
          f"{LM_TRAIN_CE_RANGE}")
    check(ce_last < ce0, f"[lm-train] 13b: ce did not fall: {ce0:.4f} -> "
          f"{ce_last:.4f}")
    check(peak < LM_TRAIN_PEAK_GIB * 2**30,
          f"[lm-train] 13b: peak {peak / 2**30:.2f} GiB")
    batch = pipe.batch_at(steps)

    def one():
        _, m = inner(state, batch)
        torch.stack([v.float() for v in m.values()]).tolist()
    prof = _tick_profile(torch, types.SimpleNamespace(step=one), ticks=1)
    warm, opt_s = step_s[1:], opt.seconds[1:]
    mean_s = statistics.mean(warm)
    opt_mean = statistics.mean(opt_s)
    tokens = seq * batch_size
    flops = model_flops(cfg, ShapeSpec("train", "train", seq, batch_size))
    n_params = param_count(cfg)
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "seq_len": seq, "batch": batch_size, "steps": steps,
        "lr": LM_TRAIN_LR, "init_s": init_s, "run_s": run_s,
        "step_ms": [1e3 * s for s in step_s],
        "opt_ms": [1e3 * s for s in opt.seconds],
        "step_ms_mean": 1e3 * mean_s,
        "step_ms_median": 1e3 * statistics.median(warm),
        "fwd_bwd_ms_mean": 1e3 * (mean_s - opt_mean),
        "opt_ms_mean": 1e3 * opt_mean,
        "tokens_per_s": tokens / mean_s, "model_flops": flops,
        "mfu": flops / mean_s / H100_BF16_FLOPS,
        "max_memory_allocated": peak,
        "ce": [h["ce"] for h in hist], "grad_norm": [
            h["grad_norm"] for h in hist],
        "profile": prof, "device": smi}
    log(f"[lm-train] 13b {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.param_dtype}, remat; "
        f"{n_params / 1e9:.3f} B parameters, drawn in {init_s:.2f} s), "
        f"{batch_size} x {seq} tokens a step, lr {LM_TRAIN_LR:g} constant, "
        f"{steps} Trainer steps on {smi}: ce {ce0:.4f} -> {ce_last:.4f}; "
        f"step 0 {1e3 * step_s[0]:.1f} ms, steps 1-{steps - 1} "
        f"{out['step_ms_mean']:.1f} ms mean ({out['step_ms_median']:.1f} "
        f"median) = forward+backward {out['fwd_bwd_ms_mean']:.1f} + "
        f"optimizer {out['opt_ms_mean']:.1f}; {out['tokens_per_s']:.0f} "
        f"tokens/s; MFU {100 * out['mfu']:.2f}% (6·N·D = "
        f"{flops / 1e12:.2f} TFLOP a step over {H100_BF16_FLOPS / 1e12:.1f} "
        f"TFLOP/s dense bf16, H100 SXM5); peak {peak / 2**30:.2f} GiB "
        f"allocated")
    log(f"[lm-train] 13b one profiled step on {smi}: "
        f"{prof['wall_ms']:.1f} ms wall, device busy "
        f"{100 * prof['busy']:.1f}%, {prof['kernels']} kernels; top: "
        + "; ".join(f"{n} {ms:.2f} ms x{c}" for n, ms, c in prof["top"][:5]))
    del trainer, state, model, opt
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def lm_resume(out_dir, dev="cuda", cfg=None) -> int:
    """13c, in a process of its own (``--lm-resume DIR``, started with
    ``CUBLAS_WORKSPACE_CONFIG`` set, run under
    ``torch.use_deterministic_algorithms``): granite-moe-1b-a400m at full
    width cut to LM_RESUME_LAYERS layers, bfloat16, trained
    LM_RESUME_STEPS steps by ``Trainer`` (weights from seed 0) with async
    checkpoints every LM_RESUME_EVERY, once straight through and once
    killed at step LM_RESUME_KILL and resumed.  Prints one JSON line: the
    leaves and logged metrics of the two runs that differ (each must be
    equal bit for bit), the ops that warned of no deterministic form
    (``warn_only``, so they are named rather than raised), and the
    checkpoint managers' times."""
    import shutil
    import warnings
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.data import TokenPipeline
    from repro_torch.lm.configs import get_config
    from repro_torch.lm.models.model import Model
    from repro_torch.lm.train import AdamW
    from repro_torch.lm.train.trainer import (
        SimulatedFailure, Trainer, TrainerConfig)
    cfg = cfg or dataclasses.replace(get_config(LM_RESUME_ARCH),
                                     n_layers=LM_RESUME_LAYERS)

    def bomb(step):
        if step == LM_RESUME_KILL:
            raise SimulatedFailure(f"killed at step {step}")

    def train(name):
        d = pathlib.Path(out_dir) / name
        shutil.rmtree(d, ignore_errors=True)
        tr = Trainer(Model(cfg, device=dev), AdamW(lr=LM_TRAIN_LR),
                     TokenPipeline(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                                   global_batch=LM_TRAIN_BATCH, seed=0),
                     TrainerConfig(steps=LM_RESUME_STEPS,
                                   ckpt_every=LM_RESUME_EVERY, log_every=1,
                                   ckpt_dir=str(d), async_ckpt=True))
        tr.ckpt = c = _timed_manager(str(d))
        if name == "killed":
            with contextlib.suppress(SimulatedFailure):
                tr.run(failure_hook=bomb)
            check(tr.history[-1]["step"] == LM_RESUME_KILL,
                  f"13c: the failure at step {LM_RESUME_KILL} did not fire")
            c.wait()
            check(c.latest_step() == LM_RESUME_KILL - 1,
                  f"13c: latest checkpoint {c.latest_step()}")
        state = tr.run()
        leaves = [(p, t.cpu()) for p, t in _flatten(state)]
        ckpt_bytes = sum(f.stat().st_size for f in d.rglob("*.npy")) // max(
            len(c.all_steps()), 1)
        shutil.rmtree(d, ignore_errors=True)
        return leaves, {h["step"]: h for h in tr.history}, {
            "saves": c.saves, "caller_ms": 1e3 * c.save_s,
            "writes": c.writes, "writer_ms": 1e3 * c.write_s,
            "restores": c.restores, "restore_ms": 1e3 * c.restore_s,
            "checkpoint_bytes": ckpt_bytes}

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        (a, ha, ta), (b, hb, tb) = train("straight"), train("killed")
    nondet = sorted({str(w.message).split("\n")[0][:160] for w in seen
                     if "deterministic" in str(w.message)})
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers,
        "params": sum(x.numel() for p, x in a if p[0] == ".params"),
        "leaves": len(a), "nondeterministic": nondet,
        "unequal": [str(p) for (p, x), (_, y) in zip(a, b)
                    if x.dtype != y.dtype or not torch.equal(x, y)],
        "metrics_unequal": [s for s in sorted(ha) if ha[s] != hb[s]],
        "ce": [ha[s]["ce"] for s in sorted(ha)],
        "times": {"straight": ta, "killed": tb}}))
    return 0


def _lm_train_resume(torch, smi):
    """13c: ``lm_resume`` in a child process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts (cuBLAS reads it once
    a process), so only this sub-phase runs deterministic algorithms."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--lm-resume",
         str(LM_TRAIN_DIR / "resume")], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=900)
    check(res.returncode == 0, f"[lm-train] 13c exited {res.returncode}: "
          f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    row = json.loads(res.stdout.strip().splitlines()[-1])
    row["wall_s"] = time.perf_counter() - t0
    check(not row["unequal"], f"[lm-train] 13c: the resumed run differs "
          f"from the straight one in {row['unequal']}")
    check(not row["metrics_unequal"], f"[lm-train] 13c: logged metrics "
          f"differ at steps {row['metrics_unequal']}")
    t = row["times"]
    log(f"[lm-train] 13c {row['arch']} at full width cut to {row['layers']} "
        f"layers ({row['params'] / 1e6:.1f} M parameters, bfloat16; "
        f"{t['straight']['checkpoint_bytes'] / 1e9:.2f} GB a checkpoint), "
        f"{LM_RESUME_STEPS} Trainer steps, async checkpoints every "
        f"{LM_RESUME_EVERY}, under deterministic algorithms on {smi}: killed "
        f"at step {LM_RESUME_KILL} and resumed from step "
        f"{LM_RESUME_KILL - 1}, all {row['leaves']} parameter, moment and "
        f"step leaves and every logged metric equal bit for bit to the "
        f"straight run (ce {row['ce'][0]:.4f} -> {row['ce'][-1]:.4f}); "
        f"ops with no deterministic form: {row['nondeterministic'] or 'none'}; "
        f"checkpoint writes {t['killed']['caller_ms'] / t['killed']['saves']:.1f} "
        f"ms a save on the caller's thread (the wait for the previous write "
        f"included), {t['killed']['writer_ms'] / t['killed']['writes']:.1f} ms "
        f"on the writer's; restore {t['killed']['restore_ms']:.1f} ms; "
        f"{row['wall_s']:.1f} s with the process start")
    return row


def phase_lm_train(torch, np, dev, smi, full=True):
    """Phase 13: the LM training path (13a, 13b, 13c).  ``full=False``
    runs 13b at reduced width and leaves out 13c, for a rehearsal."""
    from repro_torch.lm.configs import get_config
    t_phase = time.perf_counter()
    out = {"reduced": _lm_train_twins(torch, np, dev)}
    torch.cuda.empty_cache()
    cfg = get_config(LM_TRAIN_ARCH)
    if not full:
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                  param_dtype="bfloat16", remat=True)
    out["full"] = _lm_train_full(torch, np, dev, cfg, smi, LM_TRAIN_SEQ,
                                 LM_TRAIN_BATCH, LM_TRAIN_STEPS)
    torch.cuda.empty_cache()
    if full:
        out["resume"] = _lm_train_resume(torch, smi)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm-train] phase 13: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 14: sharded LM training and serving on torch.distributed
# --------------------------------------------------------------------------

LM_SHARD_DIR = ROOT / "chip_smoke_out" / "lm_sharded"
LM_SHARD_RANKS = 4                   # 14b: (data=2, model=2) on the one card
LM_SHARD_STEPS = 2                   # 14b's train steps
LM_SHARD_A_STEPS = 4                 # 14a's Trainer steps (13b's first 4)
LM_SHARD_CE_RTOL = 1e-3              # 14a: ce against the unsharded Trainer
LM_SHARD_F32_RTOL = 1e-5             # 14b(i): loss and metrics, float32
LM_SHARD_BF16_CE_RTOL = 1e-2         # 14b(ii): ce, bfloat16
LM_SHARD_SHARE = 0.26                # 14b(i): local param + moment bytes
# 14b: a leaf's change over the steps, p - p0, against the twin's: the
# relative L2 gap |d - d_twin| / |d_twin|.  A state left unchanged reads
# 1, a reversed update 2, one of the two steps left out about 0.5.
# float32 parts only where a near-zero gradient's sign differs; bfloat16
# also rounds each step's result to the parameter's ulp (about a third
# of an lr step at the init's scale) and sums its gradients in another
# order
LM_SHARD_DELTA_GAP = {"float32": 0.05, "bfloat16": 0.25}
LM_SHARD_DENSE_LAYERS = 4            # 14b(ii)/(iii): minitron cut to 4 layers
LM_SHARD_PROMPT, LM_SHARD_DECODE = 256, 8
LM_SHARD_MOE_ARCH = "granite-moe-1b-a400m"
PIPE_STAGES, PIPE_LAYERS, PIPE_D = 2, 4, 4096     # dryrun's pipeline cell
PIPE_MICRO, PIPE_MB = 8, 32
PIPE_RTOL, PIPE_ATOL, PIPE_GRAD_RTOL = 2e-5, 2e-6, 1e-4


def _rank_device(torch, kind):
    """The device every rank of phase 14 works on: index 0 of ``kind``
    (the phase's own device type, passed in each rank's spec)."""
    dev = torch.device(kind, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


class _CommMeter:
    """Every collective a window dispatches (``DTensor``'s functional
    collectives and the ``c10d`` ops of ``torch.distributed``), by kind:
    calls, the bytes each hands back to this rank, and its seconds with
    the card synchronized before and after (so the window runs slower
    than an unmetered one)."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode
        meter = self
        self.calls = collections.Counter()
        self.bytes = collections.Counter()
        self.seconds = collections.Counter()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented   # its collectives come through
                kwargs = kwargs or {}
                ns = func.namespace
                if ns not in ("_c10d_functional", "c10d", "_dtensor",
                              "_c10d_functional_autograd") or any(
                        w in func.__name__ for w in ("wait", "wrap")):
                    return func(*args, **kwargs)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = func(*args, **kwargs)
                flat = out if isinstance(out, (list, tuple)) else (out,)
                for o in flat:
                    if hasattr(o, "wait") and not torch.is_tensor(o):
                        o.wait()
                tensors = [o for o in flat if torch.is_tensor(o)]
                if ns != "c10d":
                    tensors = [torch.ops._c10d_functional.wait_tensor(t)
                               for t in tensors]
                else:                 # in place: the first argument
                    first = args[0]
                    tensors = list(first) if isinstance(
                        first, (list, tuple)) else [first]
                    tensors = [t for x in tensors for t in (
                        x if isinstance(x, (list, tuple)) else [x])
                        if torch.is_tensor(t)]
                torch.cuda.synchronize()
                kind = func.__name__.split(".")[0].strip("_")
                meter.calls[kind] += 1
                meter.bytes[kind] += sum(t.numel() * t.element_size()
                                         for t in tensors)
                meter.seconds[kind] += time.perf_counter() - t0
                return out
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def row(self, per=1):
        return {k: {"calls": self.calls[k] / per,
                    "bytes": self.bytes[k] / per,
                    "seconds": self.seconds[k] / per}
                for k in sorted(self.calls)}


def _comm_counts(comm):
    return {str(k).split(".")[-1]: int(v)
            for k, v in comm.get_comm_counts().items()}


def _greedy_rule(torch, got_tokens, want_logits, where):
    """12b's rule: every sequence's greedy tokens equal the unsharded
    run's up to the first step whose top-2 margin there is under the
    bfloat16 tolerance.  Returns (tokens compared, tokens equal)."""
    checked = 0
    for b in range(got_tokens.shape[0]):
        for t, lg in enumerate(want_logits):
            row = lg[b].float()
            top2 = torch.topk(row, 2).values
            if float(top2[0] - top2[1]) < _bf16_tol(row.abs().max()):
                break
            check(int(got_tokens[b, t]) == int(row.argmax()),
                  f"{where}: sequence {b} step {t}: token "
                  f"{int(got_tokens[b, t])} != {int(row.argmax())}")
            checked += 1
    return checked


def _serve_run(torch, model, ctx, prompt, n_decode):
    """A prefill of ``prompt`` and ``n_decode`` greedy decode steps
    through ``make_serve_steps``: ((B, n_decode + 1) tokens, each step's
    (B, V) logits on the host, prefill ms, decode ms a step)."""
    from repro_torch.lm.train.train_step import make_serve_steps
    pre, dec = make_serve_steps(model, ctx)
    B, P = prompt.shape
    params = model.param_tree()
    caches = model.init_cache(B, P + n_decode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = pre(params, {"tokens": prompt}, caches)
    torch.cuda.synchronize()
    pre_ms = 1e3 * (time.perf_counter() - t0)
    steps = [logits[:, -1].float().cpu()]
    toks = [logits[:, -1].argmax(-1)]
    t0 = time.perf_counter()
    for i in range(n_decode):
        logits, caches = dec(params, toks[-1][:, None], caches, P + i)
        steps.append(logits[:, -1].float().cpu())
        toks.append(logits[:, -1].argmax(-1))
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / n_decode
    return torch.stack(toks, 1).cpu(), steps, pre_ms, dec_ms


def _lm_sharded_nccl(torch, np, dev, smi, cfg, ce_13b, ms_13b):
    """14a: a (1, 1) ("data", "model") mesh over a one-rank NCCL group:
    ``Trainer(..., ctx)`` on ``cfg`` (13b's run: weights from seed 0,
    13b's token pipeline, constant lr) for LM_SHARD_A_STEPS steps, each
    step's ce held to 13b's unsharded Trainer, then serving under the
    "opt" rules held to the unsharded model of the same weights."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.data import TokenPipeline
    from repro_torch.lm.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.lm.models.model import Model
    from repro_torch.lm.train import AdamW
    from repro_torch.lm.train.trainer import Trainer, TrainerConfig
    from repro_torch.exchange.collectives import backend_for
    ckpt = LM_SHARD_DIR / "a"
    shutil.rmtree(ckpt, ignore_errors=True)
    backend = backend_for(dev.type, 1)
    dist.init_process_group(
        backend, store=dist.HashStore(), rank=0, world_size=1,
        **({"device_id": dev} if backend == "nccl" else {}))
    try:
        mesh = make_test_mesh((1, 1), device=dev.type)
        ctx = make_ctx(mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device=dev, ctx=ctx)
        check(model.sharded, "14a: the model's parameters are not placed")
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                             global_batch=LM_TRAIN_BATCH, seed=0)
        trainer = Trainer(model, AdamW(lr=LM_TRAIN_LR), pipe, TrainerConfig(
            steps=LM_SHARD_A_STEPS, ckpt_every=LM_SHARD_A_STEPS + 1,
            ckpt_dir=str(ckpt), log_every=1), ctx)
        state, init_s = _timed(torch, lambda: trainer.init_state(0))
        inner, step_s, comms = trainer.step_fn, [], []

        def timed_step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CommDebugMode() as comm:
                out = inner(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            comms.append(_comm_counts(comm))
            return out
        trainer.step_fn = timed_step
        trainer.run(state)
        peak = torch.cuda.max_memory_allocated()
        hist = trainer.history
        ce = [h["ce"] for h in hist]
        check(len(hist) == LM_SHARD_A_STEPS and all(
            math.isfinite(v) for h in hist for v in h.values()),
            f"[lm-sharded] 14a: a metric is not finite: {hist}")
        rel = [abs(a - b) / abs(b) for a, b in zip(ce, ce_13b)]
        check(max(rel) <= LM_SHARD_CE_RTOL,
              f"[lm-sharded] 14a: ce {ce} against 13b's {ce_13b[:len(ce)]}")
        check(peak < LM_TRAIN_PEAK_GIB * 2**30,
              f"[lm-sharded] 14a: peak {peak / 2**30:.2f} GiB")
        del trainer, state
        torch.cuda.empty_cache()
        # serving under "opt" against the unsharded model of the weights
        octx = make_ctx(mesh, "opt")
        prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_TRAIN_BATCH, LM_SHARD_PROMPT)), device=dev)
        toks, _, pre_ms, dec_ms = _serve_run(torch, model, octx, prompt,
                                             LM_SHARD_DECODE)
        twin = Model(cfg, device=dev)
        twin.load_state_dict({k: v.to_local()
                              for k, v in model.state_dict().items()})
        del model
        _, want, twin_pre, twin_dec = _serve_run(torch, twin, None, prompt,
                                                 LM_SHARD_DECODE)
        n_eq = _greedy_rule(torch, toks, want, "[lm-sharded] 14a serve")
        del twin
    finally:
        dist.destroy_process_group()
    warm = step_s[1:]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "init_s": init_s,
           "backend": backend,
           "step_ms": [1e3 * s for s in step_s],
           "step_ms_mean": 1e3 * statistics.mean(warm),
           "step_ms_13b": ms_13b, "ce": ce, "ce_13b": ce_13b[:len(ce)],
           "ce_rel_max": max(rel), "peak_bytes": peak,
           "collectives_a_step": comms[-1], "serve": {
               "prefill_ms": pre_ms, "decode_ms": dec_ms,
               "plain_prefill_ms": twin_pre, "plain_decode_ms": twin_dec,
               "tokens_checked": n_eq}, "device": smi}
    log(f"[lm-sharded] 14a {cfg.name} ({cfg.n_layers} layers, "
        f"{cfg.param_dtype}, remat) on a (1, 1) mesh over a one-rank "
        f"{backend} group, {LM_SHARD_A_STEPS} Trainer steps of {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ} on {smi}: ce {', '.join(f'{c:.4f}' for c in ce)} "
        f"(13b unsharded: {', '.join(f'{c:.4f}' for c in ce_13b[:len(ce)])};"
        f" largest relative gap {max(rel):.2e}); steps 1-"
        f"{LM_SHARD_A_STEPS - 1} {out['step_ms_mean']:.1f} ms mean against "
        f"13b's {ms_13b:.1f} ms unsharded (the difference is DTensor's "
        f"dispatch); peak {peak / 2**30:.2f} GiB; collectives a step "
        f"{comms[-1] or 'none'}")
    log(f"[lm-sharded] 14a serving under 'opt' on {smi}: prefill "
        f"{LM_TRAIN_BATCH} x {LM_SHARD_PROMPT} {pre_ms:.1f} ms (unsharded "
        f"{twin_pre:.1f}), decode {dec_ms:.1f} ms a step (unsharded "
        f"{twin_dec:.1f}); {n_eq} greedy tokens equal before a top-2 margin "
        f"under {LM_BF16_ULPS} bf16 ulps")
    return out


def _param_bytes(tree, local):
    from repro_torch.lm.models.model import _flatten
    from repro_torch.sharding.specs import is_dtensor
    total = 0
    for t in _flatten(tree).values():
        if local and is_dtensor(t):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _shard_train(torch, np, dist, dev, ctx, cfg, batches, tag):
    """14b(i)/(ii) on every rank: ``make_train_step`` on the mesh for
    the batches, the first step under ``CommDebugMode`` and the second
    metered; then the updated parameters and the eps-regime mask
    gathered to rank 0's host.  Returns (rank 0's row, host leaves)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.exchange import collectives
    from repro_torch.lm.models.model import Model, _flatten
    from repro_torch.lm.train import AdamW, make_train_step
    from repro_torch.lm.train.train_step import TrainState
    from repro_torch.sharding.specs import gathered
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev, ctx=ctx)
    model.init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=LM_TRAIN_LR)
    params = model.param_tree()
    state = TrainState(params, opt.init(params), None)
    share = (_param_bytes(params, True) + _param_bytes(state.opt.mu, True)
             + _param_bytes(state.opt.nu, True)) / (
        _param_bytes(params, False) + _param_bytes(state.opt.mu, False)
        + _param_bytes(state.opt.nu, False))
    row = {"share": share}
    if cfg.moe is not None:
        # the forward alone: one all-reduce over model a MoE layer
        collectives.reset_counters()
        with torch.no_grad():
            model.loss(params, batches[0], ctx)
        row["forward_psum_model"] = collectives.calls["psum_replicated"]
        row["forward_weight_gathers"] = collectives.calls["all_gather_dim"]
    step = make_train_step(model, opt, ctx)
    metrics, step_s = [], []
    meter = _CommMeter(torch)
    # the expert choices of every routing, for the twin to take (a router
    # near-tie may fall either way under another summation order)
    from repro_torch.lm.models import moe as moe_mod
    with (_record_routing(moe_mod) if cfg.moe is not None
          else contextlib.nullcontext([])) as seen:
        for i, batch in enumerate(batches):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                with CommDebugMode() as comm:
                    state, m = step(state, batch)
                row["comm_counts"] = _comm_counts(comm)
            else:
                with meter:
                    state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    routing = [None] * dist.get_world_size()
    dist.all_gather_object(routing, seen)
    # the groups in order: the ranks of model coordinate 0, by data
    rows = [routing[r] for r in ctx.mesh.mesh[:, 0].tolist()]
    forced = [torch.cat([r[n] for r in rows]).reshape(1, -1, r0.shape[-1])
              for n, r0 in enumerate(rows[0])]
    row.update(metrics=metrics, step_ms=[1e3 * s for s in step_s],
               metered=meter.row(len(batches) - 1),
               peak_bytes=torch.cuda.max_memory_allocated())
    host = {}
    mu = _flatten(state.opt.mu)
    for k, p in _flatten(state.params).items():
        full = gathered(p)
        tiny = gathered(DTensor.from_local(
            (mu[k].to_local() / (1 - 0.9)).abs() < LM_EPS_REGIME,
            p.device_mesh, p.placements, run_check=False))
        if dist.get_rank() == 0:
            host[k] = (full.cpu(), tiny.cpu())
        del full, tiny
    host["routing"] = forced
    del model, state, step, params, mu
    torch.cuda.empty_cache()
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, row["peak_bytes"])
    row["peak_bytes_ranks"] = peaks
    shares = [None] * dist.get_world_size()
    dist.all_gather_object(shares, share)
    row["share_ranks"] = shares
    return row, host


def _twin_train(torch, dev, cfg, batches, host, row, where, ce_only):
    """Rank 0, after the ranks freed their state: the unsharded twin's
    steps on the same weights and batches, and the sharded run held to
    it."""
    from repro_torch.lm.models.model import Model, _flatten
    from repro_torch.lm.train import AdamW, make_train_step
    from repro_torch.lm.train.train_step import TrainState
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=LM_TRAIN_LR)
    params = model.param_tree()
    state = TrainState(params, opt.init(params), None)
    p0 = {k: p.detach().clone() for k, p in _flatten(params).items()}
    step = make_train_step(model, opt)
    twin_s, twin_m = [], []
    from repro_torch.lm.models import moe as moe_mod
    with (_force_routing(moe_mod, host["routing"]) if cfg.moe is not None
          else contextlib.nullcontext([])) as ties:
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            twin_m.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            twin_s.append(time.perf_counter() - t0)
    check(len(ties) == len(host["routing"]),
          f"{where}: the twin routed {len(ties)} times, the sharded run "
          f"{len(host['routing'])}")
    for n, tie in enumerate(ties):
        check(tie <= LM_ROUTE_TIE,
              f"{where}: routing {n} of the twin takes the sharded run's "
              f"experts off its own by {tie:.3g} of probability (a near-tie "
              f"is under {LM_ROUTE_TIE:g})")
    row["routing_calls"] = len(ties)
    row["routing_tie_max"] = max(ties, default=0.0)
    worst_m = 0.0
    for got, want in zip(row["metrics"], twin_m):
        for k in (("ce", "loss") if ce_only else want):
            rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            worst_m = max(worst_m, rel)
            tol = LM_SHARD_BF16_CE_RTOL if ce_only else LM_SHARD_F32_RTOL
            check(math.isfinite(got[k]) and rel <= tol,
                  f"{where}: {k} {got[k]} against the twin's {want[k]}")
    worst_p, tiny_n, gaps = 0.0, 0, {}
    gap_limit = LM_SHARD_DELTA_GAP[cfg.param_dtype]
    for k, p in _flatten(state.params).items():
        got, tiny = (t.to(dev) for t in host[k])
        diff = (got.float() - p.float()).abs()
        tiny_n += int(tiny.sum())
        # the change each run made, held to the twin's: an update left
        # out, reversed or of the wrong size fails here
        start = p0.pop(k).float()
        moved = float(torch.linalg.vector_norm(p.float() - start))
        if moved > 0:
            gaps[k] = float(torch.linalg.vector_norm(
                got.float() - p.float())) / moved
            check(gaps[k] <= gap_limit,
                  f"{where}: parameter {k} changed {gaps[k]:.3g} of the "
                  f"twin's change away from it (limit {gap_limit:g})")
        else:
            check(bool((got.float() == start).all()),
                  f"{where}: parameter {k} moved where the twin's did not")
        del start
        if ce_only:
            # bfloat16: a step moves an entry by at most lr (plus the
            # weight decay) and a rounding of half a bf16 ulp (at most
            # 2^-8 of it), so two runs part by at most twice that a step;
            # more is a fault
            bound = 2 * len(batches) * (LM_TRAIN_LR * 1.1
                                        + BF16_ULP * p.float().abs())
            bad = diff > bound
        else:
            bad = (diff > LM_STEP_ATOL + LM_STEP_RTOL * p.float().abs()) \
                & ~tiny
            check(bool((diff[tiny] <= LM_TRAIN_LR).all()),
                  f"{where}: {k}: an eps-regime entry moved by more than lr")
        if bool(bad.any()):
            i = int(diff.argmax())
            check(False, f"{where}: parameter {k} differs by "
                  f"{float(diff.max()):.3g} (the twin's entry "
                  f"{float(p.flatten()[i]):.4g}, the sharded run's "
                  f"{float(got.flatten()[i]):.4g})")
        worst_p = max(worst_p, float(diff.max()))
        del got, tiny, diff
    check(bool(gaps), f"{where}: the twin's steps moved no parameter")
    worst_gap = max(gaps, key=gaps.get)
    row.update(twin_metrics=twin_m, twin_step_ms=[1e3 * s for s in twin_s],
               metric_rel_max=worst_m, param_abs_max=worst_p,
               eps_regime=tiny_n, change_gap_max=gaps[worst_gap],
               change_gap_leaf=worst_gap, change_gap_limit=gap_limit,
               leaves_moved=len(gaps),
               twin_peak_bytes=torch.cuda.max_memory_allocated())
    del model, state, step, params
    torch.cuda.empty_cache()


def _shard_serve(torch, np, dist, dev, mesh, cfg):
    """14b(iii) on every rank: serving under "opt" (the KV sequence over
    model); rank 0 then holds it to the unsharded model."""
    from repro_torch.lm.launch.mesh import make_ctx
    from repro_torch.lm.models.model import Model
    octx = make_ctx(mesh, "opt")
    model = Model(cfg, device=dev, ctx=octx)
    model.init(torch.Generator(device=dev).manual_seed(0))
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_TRAIN_BATCH, LM_SHARD_PROMPT)), device=dev)
    dist.barrier()
    toks, _, pre_ms, dec_ms = _serve_run(torch, model, octx, prompt,
                                         LM_SHARD_DECODE)
    del model
    torch.cuda.empty_cache()
    dist.barrier()
    row = {"prefill_ms": pre_ms, "decode_ms": dec_ms}
    if dist.get_rank() == 0:
        twin = Model(cfg, device=dev)
        twin.init(torch.Generator(device=dev).manual_seed(0))
        _, want, tp, td = _serve_run(torch, twin, None, prompt,
                                     LM_SHARD_DECODE)
        row.update(plain_prefill_ms=tp, plain_decode_ms=td,
                   tokens_checked=_greedy_rule(
                       torch, toks, want, "[lm-sharded] 14b(iii)"))
        del twin
        torch.cuda.empty_cache()
    return row


def _lm_shard_rank(rank, world, spec):
    """One rank of 14b: 4 ranks on the one card over gloo, a (2, 2)
    ("data", "model") mesh, every rank making the same calls; rank 0
    holds each case to its unsharded twin after the ranks freed theirs
    and writes the results."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.lm.configs import get_config
    from repro_torch.lm.launch.mesh import make_ctx, make_test_mesh
    dev = _rank_device(torch, spec["device"])
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"],
                                                         world),
                            rank=rank, world_size=world)
    mesh = make_test_mesh((2, 2), device=dev.type)
    ctx = make_ctx(mesh)
    res = {}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        cfg = get_config(case["arch"])
        if spec["reduced"]:
            cfg = dataclasses.replace(cfg.reduced(), dtype=cfg.dtype,
                                      param_dtype=cfg.param_dtype)
        cfg = dataclasses.replace(cfg, **case.get("replace", {}))
        if "moe" in case:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts
                / cfg.moe.top_k))
        if case["kind"] == "serve":
            row = _shard_serve(torch, np, dist, dev, mesh, cfg)
        else:
            batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                        _lm_batch(np, cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                  SEED + i).items()}
                       for i in range(LM_SHARD_STEPS)]
            row, host = _shard_train(torch, np, dist, dev, ctx, cfg,
                                     batches, case["tag"])
            dist.barrier()
            if rank == 0:
                _twin_train(torch, dev, cfg, batches, host, row,
                            f"[lm-sharded] 14b({case['tag']})",
                            ce_only=case["dtype"] == "bfloat16")
            del host
        dist.barrier()
        row["wall_s"] = time.perf_counter() - t0
        row["config"] = {"arch": cfg.name, "layers": cfg.n_layers,
                         "d_model": cfg.d_model, "dtype": cfg.param_dtype,
                         "opts": list(cfg.opts), "remat": cfg.remat}
        res[case["tag"]] = row
    if rank == 0:
        with open(spec["out"], "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _pipe_stage(torch, F):
    def stage_fn(wp, x):
        w1, w2 = wp
        for i in range(w1.shape[0]):
            x = x + F.gelu(x @ w1[i]) @ w2[i]
        return x
    return stage_fn


def _pipe_rank(rank, world, spec):
    """One rank of 14c: ``pipeline_apply`` over a ("pod",) mesh of 2
    gloo ranks on the card; float32 held to the sequential stages on rank
    0 (output and the gradient of sum(y²)), then bfloat16 timed."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    sys.path.insert(0, str(SRC))
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.exchange import collectives
    from repro_torch.lm.launch.mesh import make_test_mesh
    from repro_torch.sharding.pipeline import pipeline_apply, stage_shardings
    from repro_torch.sharding.specs import gathered
    dev = _rank_device(torch, spec["device"])
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"],
                                                         world),
                            rank=rank, world_size=world)
    mesh = make_test_mesh((world,), ("pod",), device=dev.type)
    S, Lp, d = PIPE_STAGES, spec["layers"], spec["d"]
    n_micro, mb = PIPE_MICRO, PIPE_MB
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w1 = torch.randn((S, Lp, d, 4 * d), generator=gen, device=dev) * d ** -0.5
    w2 = torch.randn((S, Lp, 4 * d, d), generator=gen, device=dev) * (
        0.5 * (4 * d) ** -0.5)
    x = torch.randn((n_micro, mb, d), generator=gen, device=dev)
    stage_fn = _pipe_stage(torch, F)
    fn = pipeline_apply(stage_fn, S, n_micro, mesh)
    (m, pl), _ = stage_shardings(mesh, (w1, w2))
    placed = tuple(distribute_tensor(w, m, pl, src_data_rank=None
                                     ).requires_grad_(True) for w in (w1, w2))
    y = fn(placed, x)
    torch.sum(y ** 2).backward()
    g = [gathered(p.grad) for p in placed]
    res = {}
    if rank == 0:
        ws = [w.clone().requires_grad_(True) for w in (w1, w2)]
        ys = []
        for k in range(n_micro):          # the stages one after the other
            v = x[k]
            for s in range(S):
                v = stage_fn((ws[0][s], ws[1][s]), v)
            ys.append(v)
        ys = torch.stack(ys)
        torch.sum(ys ** 2).backward()
        y, ys = y.detach(), ys.detach()
        out_err = float((y - ys).abs().max())
        check(bool(torch.allclose(y, ys, rtol=PIPE_RTOL, atol=PIPE_ATOL)),
              f"[lm-sharded] 14c: pipeline output differs from the "
              f"sequential stages by {out_err:.3g}")
        grad_err = []
        for got, w in zip(g, ws):
            scale = float(w.grad.abs().max())
            grad_err.append(float((got - w.grad).abs().max()) / scale)
            check(bool(torch.allclose(got, w.grad, rtol=PIPE_GRAD_RTOL,
                                      atol=PIPE_GRAD_RTOL * scale)),
                  f"[lm-sharded] 14c: gradient differs by "
                  f"{grad_err[-1]:.3g} of its largest entry")
        res.update(out_err=out_err, grad_rel_err=grad_err)
        del ws, ys
    del placed, y, g
    torch.cuda.empty_cache()
    # bfloat16: ms a schedule and the bytes a tick
    pb = tuple(distribute_tensor(w.to(torch.bfloat16), m, pl,
                                 src_data_rank=None) for w in (w1, w2))
    xb = x.to(torch.bfloat16)
    del w1, w2
    with torch.no_grad():
        fn(pb, xb)
        ms = []
        for _ in range(spec["reps"]):
            collectives.reset_counters()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(pb, xb)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    n_t = n_micro + S - 1
    got = [None] * world
    dist.all_gather_object(got, dict(collectives.bytes_in))
    res.update(bf16_ms=ms, ticks=n_t,
               bytes_a_tick=got[1].get("ppermute", 0) / n_t,
               peak_bytes=torch.cuda.max_memory_allocated())
    if rank == 0:
        with open(spec["out"], "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _probe_gloo_p2p_rank(rank, world, spec):
    """A gloo send/recv of a CUDA tensor between two throwaway ranks."""
    import torch
    import torch.distributed as dist
    dev = _rank_device(torch, spec["device"])
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"],
                                                         world),
                            rank=rank, world_size=world)
    x = torch.arange(8, dtype=spec["dtype"], device=dev)
    if rank == 0:
        dist.send(x, 1)
    else:
        y = torch.zeros_like(x)
        dist.recv(y, 0)
        torch.cuda.synchronize()
        if bool((y == x).all()):
            pathlib.Path(spec["out"]).write_text("ok")
    dist.destroy_process_group()


def _spawn_ranks(torch, fn, world, spec, timeout):
    """``world`` spawned ranks of ``fn``; their exit codes (None: still
    running at ``timeout`` seconds, then killed)."""
    import torch.multiprocessing as mp
    store = pathlib.Path(spec["store"])
    if store.exists():
        store.unlink()        # a stale store file hangs gloo
    ctx = mp.start_processes(fn, args=(world, spec), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if time.perf_counter() > deadline:
                break
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        log(f"[lm-sharded] a rank failed: {e}")
    codes = [p.exitcode for p in ctx.processes]
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join()
    return codes


def _probe_gloo_p2p(torch, kind):
    """Whether gloo's point-to-point send/recv takes the card's tensors
    (it is probed in two throwaway processes: where it does not, it
    aborts the process).  ``sharding.pipeline`` stages its sends through
    host memory on a gloo group whatever this says."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        path = LM_SHARD_DIR / f"p2p_{name}"
        codes = _spawn_ranks(torch, _probe_gloo_p2p_rank, 2, {
            "store": str(LM_SHARD_DIR / "p2p_store"), "dtype": dtype,
            "device": kind, "out": str(path)}, timeout=60)
        out[f"send_recv/{name}"] = (
            "ok" if path.exists() and codes == [0, 0]
            else f"refused: exit codes {codes}")
    return out


def phase_lm_sharded(torch, np, dev, smi, report13, full=True):
    """Phase 14: sharded LM training and serving (14a one-rank NCCL,
    14b four gloo ranks on the card, 14c the GPipe pipeline).
    ``full=False`` runs every case at reduced width, for a rehearsal."""
    import shutil
    from repro_torch.lm.configs import get_config
    t_phase = time.perf_counter()
    shutil.rmtree(LM_SHARD_DIR, ignore_errors=True)
    LM_SHARD_DIR.mkdir(parents=True)
    out = {"p2p_probe": _probe_gloo_p2p(torch, dev.type)}
    log(f"[lm-sharded] gloo send/recv of the card's tensors: "
        f"{out['p2p_probe']}; the pipeline's ppermute stages its sends "
        f"through host memory on a gloo group (chosen from the backend "
        f"and the device)")
    cfg = get_config(LM_TRAIN_ARCH)
    if not full:
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                  param_dtype="bfloat16", remat=True)
    full13 = report13["full"]
    out["a"] = _lm_sharded_nccl(torch, np, _rank_device(torch, dev.type),
                                smi, cfg,
                                full13["ce"], full13["step_ms_mean"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cases = [{"tag": "i", "kind": "train", "arch": LM_SHARD_MOE_ARCH,
              "dtype": "float32", "moe": True,
              "replace": {"opts": ("moe_shardmap",), "dtype": "float32",
                          "param_dtype": "float32"}},
             {"tag": "ii", "kind": "train", "arch": LM_TRAIN_ARCH,
              "dtype": "bfloat16",
              "replace": {"n_layers": LM_SHARD_DENSE_LAYERS}},
             {"tag": "iii", "kind": "serve", "arch": LM_TRAIN_ARCH,
              "dtype": "bfloat16",
              "replace": {"n_layers": LM_SHARD_DENSE_LAYERS}}]
    spec = {"store": str(LM_SHARD_DIR / "store"), "cases": cases,
            "reduced": not full, "device": dev.type,
            "out": str(LM_SHARD_DIR / "b.json")}
    codes = _spawn_ranks(torch, _lm_shard_rank, LM_SHARD_RANKS, spec,
                         timeout=900)
    check(codes == [0] * LM_SHARD_RANKS,
          f"[lm-sharded] 14b: rank exit codes {codes}")
    b = json.loads((LM_SHARD_DIR / "b.json").read_text())
    b["wall_s"] = time.perf_counter() - t0
    out["b"] = b
    i, ii, iii = b["i"], b["ii"], b["iii"]
    check(max(i["share_ranks"]) <= LM_SHARD_SHARE,
          f"[lm-sharded] 14b(i): a rank holds {max(i['share_ranks']):.4f} "
          f"of the parameter and moment bytes")
    n_moe = i["config"]["layers"]
    check(i["forward_psum_model"] == n_moe,
          f"[lm-sharded] 14b(i): {i['forward_psum_model']} all-reduces over "
          f"model in the forward, for {n_moe} MoE layers")
    cc = i["comm_counts"]
    check(any("all_gather" in k or "allgather" in k for k in cc)
          and any("reduce_scatter" in k for k in cc),
          f"[lm-sharded] 14b(i): no all-gather or reduce-scatter a step: "
          f"{cc}")
    for tag in ("i", "ii"):
        r = b[tag]
        log(f"[lm-sharded] 14b({tag}) {r['config']} on a (2, 2) mesh of 4 "
            f"gloo ranks sharing {smi} (not a multi-GPU layout's times): "
            f"steps {', '.join(f'{s:.0f}' for s in r['step_ms'])} ms "
            f"(rank 0; the first under CommDebugMode, the second metered), "
            f"unsharded twin {', '.join(f'{s:.0f}' for s in r['twin_step_ms'])}"
            f" ms; ce {[round(m['ce'], 5) for m in r['metrics']]} vs "
            f"{[round(m['ce'], 5) for m in r['twin_metrics']]} (largest "
            f"relative gap {r['metric_rel_max']:.2e}); parameters within "
            f"{r['param_abs_max']:.3g} ({r['eps_regime']} eps-regime "
            f"entries); each leaf's change within {r['change_gap_max']:.3g} "
            f"of the twin's ({r['change_gap_leaf']}, limit "
            f"{r['change_gap_limit']:g}, {r['leaves_moved']} leaves moved; "
            f"a state left unchanged reads 1); local parameter + moment bytes "
            f"{max(r['share_ranks']):.4f} of the unsharded; peak GiB by rank "
            f"{[round(p / 2**30, 2) for p in r['peak_bytes_ranks']]}")
        log(f"[lm-sharded] 14b({tag}) collectives a step on rank 0: counts "
            f"{r['comm_counts']}; metered "
            + "; ".join(f"{k} {v['calls']:.0f} calls {v['bytes'] / 2**20:.1f}"
                        f" MiB {v['seconds']:.3f} s"
                        for k, v in r["metered"].items()))
    log(f"[lm-sharded] 14b(i) forward: {i['forward_psum_model']} all-reduces "
        f"over model for {n_moe} MoE layers, {i['forward_weight_gathers']} "
        f"expert-weight all-gathers over data; the twin took the sharded "
        f"run's expert choices in all {i['routing_calls']} routings (its own "
        f"k-th probability above a forced expert's by at most "
        f"{i['routing_tie_max']:.3g})")
    log(f"[lm-sharded] 14b(iii) serving under 'opt' (KV sequence over "
        f"model), 4 gloo ranks on {smi}: prefill {LM_TRAIN_BATCH} x "
        f"{LM_SHARD_PROMPT} {iii['prefill_ms']:.0f} ms (unsharded "
        f"{iii['plain_prefill_ms']:.0f}), decode {iii['decode_ms']:.0f} ms "
        f"a step (unsharded {iii['plain_decode_ms']:.1f}); "
        f"{iii['tokens_checked']} greedy tokens equal before a top-2 "
        f"margin under {LM_BF16_ULPS} bf16 ulps")
    t0 = time.perf_counter()
    pspec = {"store": str(LM_SHARD_DIR / "pstore"),
             "out": str(LM_SHARD_DIR / "c.json"),
             "layers": PIPE_LAYERS if full else 2,
             "d": PIPE_D if full else 256, "reps": 5, "device": dev.type}
    codes = _spawn_ranks(torch, _pipe_rank, PIPE_STAGES, pspec, timeout=600)
    check(codes == [0] * PIPE_STAGES,
          f"[lm-sharded] 14c: rank exit codes {codes}")
    c = json.loads((LM_SHARD_DIR / "c.json").read_text())
    c["wall_s"] = time.perf_counter() - t0
    out["c"] = c
    want_bytes = PIPE_MB * pspec["d"] * 2
    check(c["bytes_a_tick"] == want_bytes,
          f"[lm-sharded] 14c: {c['bytes_a_tick']} bytes a tick, not "
          f"{want_bytes}")
    log(f"[lm-sharded] 14c pipeline_apply, {PIPE_STAGES} stages x "
        f"{pspec['layers']} MLP layers (d {pspec['d']}, 4d hidden, gelu), "
        f"{PIPE_MICRO} microbatches of {PIPE_MB}, 2 gloo ranks sharing "
        f"{smi}: float32 output within {c['out_err']:.3g} of the sequential "
        f"stages, gradients within {max(c['grad_rel_err']):.3g} of their "
        f"largest entry; bfloat16 "
        f"{statistics.median(c['bf16_ms']):.1f} ms a schedule (median of "
        f"{len(c['bf16_ms'])}, {c['ticks']} ticks, host-staged sends), "
        f"{c['bytes_a_tick']:.0f} bytes received a tick")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm-sharded] phase 14: {out['phase_s']:.1f} s")
    return out


def lm_sharded_alone() -> int:
    """``--lm-sharded``: phase 14 alone, after 13b's minitron-4b run cut
    to 14a's LM_SHARD_A_STEPS steps (its unsharded reference); no kernel
    is built.  Writes ``chip_smoke_out/lm_sharded.json`` and prints the
    card and one JSON line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.lm.configs import get_config
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    r13 = {"full": _lm_train_full(torch, np, dev, get_config(LM_TRAIN_ARCH),
                                  smi, LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                                  LM_SHARD_A_STEPS)}
    torch.cuda.empty_cache()
    out = phase_lm_sharded(torch, np, dev, smi, r13)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / "lm_sharded.json").write_text(json.dumps(
        {"lm_train_13b": r13, "lm_sharded": out}, indent=1, default=str))
    print(smi)
    print(json.dumps({"ok": True, "phase_s": out["phase_s"]}))
    return 0


# --------------------------------------------------------------------------
# phase 15: the dry-run tools on fake process groups (15a), against a real
# step (15b)
# --------------------------------------------------------------------------

DRYRUN_DIR = ROOT / "chip_smoke_out" / "dryrun"
DRYRUN_OUT = ROOT / "chip_smoke_out" / "dryrun.json"
DRYRUN_CELLS = (("minitron-4b", "train_4k"), ("minitron-4b", "prefill_32k"),
                ("minitron-4b", "decode_32k"),
                ("granite-moe-1b-a400m", "train_4k"),
                ("xlstm-125m", "long_500k"))      # 16x16 mesh
DRYRUN_BUDGET_S = 300        # a cell's trace before it counts as failed
DRYRUN_WAIT_S = 400          # the 15a/15b children, all started together
DRYRUN_FLOPS_RTOL = 0.01     # 15b: traced FLOPs against FlopCounterMode
# 15b: argument + temp bytes against the real step's peak allocation.  Set
# from the H100's readings: the trace misses the peak by 0.0006-0.0013 of
# it (MemTracker follows each storage's bytes; the card rounds each block
# and holds the cuBLAS workspace), and by 0.0192-0.0198 with one decoder
# layer's parameters, moments and gradients (0.914 GiB) left out, which
# 15b also checks
DRYRUN_MEM_RTOL = 0.01


def _calib_shape():
    from repro_torch.lm.configs.base import ShapeSpec
    return ShapeSpec("train_4x512", "train", LM_TRAIN_SEQ, LM_TRAIN_BATCH)


def _dryrun_jobs():
    """Phase 15's traces: DRYRUN_CELLS on the 16x16 mesh,
    ``graph-bfs-rhizome`` on both meshes, the pipeline cell, and
    ``calib`` (15b's step)."""
    from repro_torch.lm.launch.dryrun import PIPELINE_CELL
    return ([[a, s, False, None] for a, s in DRYRUN_CELLS]
            + [["graph-bfs-rhizome", "rmat22", mp, "rhizome"]
               for mp in (False, True)]
            + [[*PIPELINE_CELL, True, None], "calib"])


def dryrun_job(job) -> int:
    """One of phase 15's traces, in a process of its own (``--dryrun
    JOB``; a fake default group cannot share a process with phase 14's
    groups): a cell ``[arch, shape, multi_pod, graph_mode]`` traced on
    fake CUDA tensors by ``dryrun.run_cell`` into DRYRUN_DIR, or
    ``calib``, 13b's minitron-4b step (full width and depth, bfloat16,
    remat, 4 x 512) traced on a (1, 1) mesh into DRYRUN_DIR/calib.json."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.lm.configs import get_config
    from repro_torch.lm.launch import dryrun
    from repro_torch.lm.launch.mesh import make_test_mesh
    torch.set_num_threads(1)      # one core a child
    dryrun.RESULTS_DIR = str(DRYRUN_DIR)
    if job != "calib":
        arch, shape, multi_pod, graph_mode = job
        dryrun.run_cell(arch, shape, multi_pod, force=True,
                        graph_mode=graph_mode, budget_s=DRYRUN_BUDGET_S)
        return 0
    t0 = time.perf_counter()
    with dryrun.fake_group(1):
        mesh = make_test_mesh((1, 1))
        with dryrun.fake_tensors():
            low = dryrun.lower_model(get_config(LM_TRAIN_ARCH),
                                     _calib_shape(), mesh)
            calib = dryrun.record_trace({"lower_s": time.perf_counter() - t0},
                                        low, 1, budget_s=DRYRUN_BUDGET_S)
    (DRYRUN_DIR / "calib.json").write_text(json.dumps(calib, indent=1))
    return 0


def _run_dryrun_jobs(jobs):
    """Each job in a child process (``dryrun_job``), all started
    together, each on a core; every child is stopped before this
    returns.  Returns the exit codes ("killed" past DRYRUN_WAIT_S) and
    the wall seconds."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for i, job in enumerate(jobs):
            out = open(DRYRUN_DIR / f"job{i}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun",
                 json.dumps(job)], stdout=out, stderr=subprocess.STDOUT,
                cwd=ROOT), out))
        rcs = []
        for proc, _ in procs:
            try:
                rcs.append(proc.wait(timeout=max(
                    DRYRUN_WAIT_S - (time.perf_counter() - t0), 1)))
            except subprocess.TimeoutExpired:
                rcs.append("killed")
    finally:
        for proc, out in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    return rcs, time.perf_counter() - t0


def _finite_tree(x):
    if isinstance(x, dict):
        return all(_finite_tree(v) for v in x.values())
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return True
    return math.isfinite(x)


def _real_step(torch, dev, cfg):
    """13b's step run for real on the card, made as the dry run makes it
    (``dryrun.lower_model``'s optimizer and batch): its FLOPs under
    ``FlopCounterMode``, its parameter, moment and batch bytes, its peak
    allocation and the ms of two more steps."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.lm.models.model import Model
    from repro_torch.lm.train.optimizer import AdamW, _leaves, cosine_schedule
    from repro_torch.lm.train.train_step import TrainState, make_train_step
    model = Model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10000))
    params = model.param_tree()
    state = TrainState(params, opt.init(params), None)
    step = make_train_step(model, opt)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                              generator=gen, device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    leaves = _leaves(params) + _leaves(state.opt.mu) \
        + _leaves(state.opt.nu) + [state.opt.step] + list(batch.values())
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves)
    # one decoder layer's parameters and gradients (the same dtype) and
    # moments: the part 15b leaves out to show its tolerance would see it
    layer_bytes = sum(2 * t[0].numel() * t.element_size()
                      for t in _leaves(params["stage0"])) + sum(
        t[0].numel() * t.element_size() for t in
        _leaves(state.opt.mu["stage0"]) + _leaves(state.opt.nu["stage0"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = []
    for _ in range(2):
        (state, _), s = _timed(torch, lambda: step(state, batch))
        ms.append(1e3 * s)
    del model, opt, state, params, step, leaves, batch
    torch.cuda.empty_cache()
    return {"flops": float(fc.get_total_flops()), "argument_bytes": arg_bytes,
            "layer_bytes": layer_bytes, "max_memory_allocated": peak,
            "step_ms": ms}


def phase_dryrun(torch, np, dev, smi):
    """Phase 15 (``[dryrun]``), after phase 14: every trace in a child of
    its own (``_run_dryrun_jobs``), then 15a: every cell ok, its
    ``per_device`` fields finite, FLOPs nonzero where it has products,
    and its record as written equal field for field to ``reanalyze`` of
    its trace summary read back from disk; 15b runs 13b's step for real
    and holds the trace of the same step to it: FLOPs within
    DRYRUN_FLOPS_RTOL of ``FlopCounterMode``, argument bytes equal,
    argument + temp within DRYRUN_MEM_RTOL of the peak allocation (and
    outside it with one layer's state left out)."""
    from repro_torch.lm.configs import get_config
    from repro_torch.lm.launch import dryrun, reanalyze
    t_phase = time.perf_counter()
    jobs = _dryrun_jobs()
    rcs, jobs_s = _run_dryrun_jobs(jobs)
    for i, (job, rc) in enumerate(zip(jobs, rcs)):
        tail = (DRYRUN_DIR / f"job{i}.log").read_text()[-4000:]
        check(rc == 0, f"[dryrun] the child tracing {job} exited {rc}: "
              f"{tail}")
    recs, rows = [], []
    for arch, shape, multi_pod, _ in jobs[:-1]:
        tag = dryrun._tag(arch, shape, multi_pod, "default", (), False)
        rec = json.loads((DRYRUN_DIR / f"{tag}.json").read_text())
        recs.append(rec)
        name = f"{arch} {shape} {'2x16x16' if multi_pod else '16x16'}"
        check(rec.get("ok"), f"[dryrun] 15a {name}: {rec.get('error')}\n"
              f"{rec.get('traceback', '')[-2000:]}")
        pd, r = rec["per_device"], rec["roofline"]
        check(_finite_tree(pd) and _finite_tree(r),
              f"[dryrun] 15a {name}: a per_device field is not finite")
        check(pd["flops"] > 0 or arch.startswith("graph-"),
              f"[dryrun] 15a {name}: no FLOPs counted")
        check(reanalyze.reanalyze(rec, str(DRYRUN_DIR / f"{tag}.trace.json.gz"))
              == rec, f"[dryrun] 15a {name}: reanalyze does not reproduce it")
        rows.append({"cell": name, "trace_s": rec["trace_s"],
                     "lower_s": rec["lower_s"], **{
                         k: r[k] for k in ("compute_s", "memory_s",
                                           "collective_s", "dominant",
                                           "bound_s")},
                     "flops": pd["flops"], "bytes": pd["bytes_accessed"],
                     "collective_bytes": pd["collective_bytes"],
                     "memory": rec["memory"],
                     "useful_compute_ratio": rec.get(
                         "useful_compute_ratio")})
        log(f"[dryrun] 15a {name}: compute {r['compute_s']:.4g} s, memory "
            f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s, "
            f"dominant {r['dominant']}; useful "
            f"{rec.get('useful_compute_ratio') or 0:.3f}; traced in "
            f"{rec['trace_s']:.2f} s (built in {rec['lower_s']:.1f} s) on "
            f"the host of {smi}")
    calib = json.loads((DRYRUN_DIR / "calib.json").read_text())
    DRYRUN_OUT.write_text(json.dumps({"cells": recs, "calib": calib},
                                     indent=1))
    cfg = get_config(LM_TRAIN_ARCH)
    real = _real_step(torch, dev, cfg)
    traced = calib["per_device"]["flops"]
    mem = calib["memory"]
    est = mem["argument_size_bytes"] + mem["temp_size_bytes"]
    check(abs(traced - real["flops"]) <= DRYRUN_FLOPS_RTOL * real["flops"],
          f"[dryrun] 15b: traced FLOPs {traced:.6g} against "
          f"FlopCounterMode's {real['flops']:.6g}")
    check(mem["argument_size_bytes"] == real["argument_bytes"],
          f"[dryrun] 15b: argument bytes {mem['argument_size_bytes']} "
          f"against the real step's {real['argument_bytes']}")
    peak = real["max_memory_allocated"]
    gap = abs(est - peak) / peak
    gap_less_layer = abs(est - real["layer_bytes"] - peak) / peak
    check(gap <= DRYRUN_MEM_RTOL,
          f"[dryrun] 15b: argument + temp {est / 2**30:.2f} GiB against "
          f"the real step's peak {peak / 2**30:.2f} GiB")
    check(gap_less_layer > DRYRUN_MEM_RTOL,
          f"[dryrun] 15b: {DRYRUN_MEM_RTOL} does not see one layer's "
          f"state ({real['layer_bytes'] / 2**30:.3f} GiB) left out")
    r = calib["roofline"]
    log(f"[dryrun] 15b {cfg.name} (full width and depth, bfloat16, remat, "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}) on a (1, 1) mesh: traced FLOPs "
        f"{traced:.6g} vs FlopCounterMode {real['flops']:.6g} (rel "
        f"{abs(traced - real['flops']) / real['flops']:.2e}); argument "
        f"bytes {mem['argument_size_bytes']} = the real step's; argument + "
        f"temp {est / 2**30:.2f} GiB vs max_memory_allocated "
        f"{peak / 2**30:.2f} GiB (rel {gap:.4f}; {gap_less_layer:.4f} with "
        f"one layer's state, {real['layer_bytes'] / 2**30:.3f} GiB, left "
        f"out; held to {DRYRUN_MEM_RTOL}); bound {1e3 * r['bound_s']:.1f} ms "
        f"({r['dominant']}: compute {1e3 * r['compute_s']:.1f}, memory "
        f"{1e3 * r['memory_s']:.1f} ms) vs "
        + ", ".join(f"{m:.1f}" for m in real["step_ms"])
        + f" ms a step measured; traced in {calib['trace_s']:.1f} s; "
        f"on {smi}")
    report = {"cells": rows, "calib": {
        "traced_flops": traced, "real": real, "memory": mem,
        "mem_gap": gap, "mem_gap_less_layer": gap_less_layer,
        "roofline": r, "trace_s": calib["trace_s"]},
        "jobs_s": jobs_s, "phase_s": time.perf_counter() - t_phase,
        "device": smi}
    DRYRUN_OUT.with_name("dryrun_report.json").write_text(
        json.dumps(report, indent=1))
    log(f"[dryrun] phase 15: {report['phase_s']:.1f} s ({len(jobs)} traces "
        f"in {jobs_s:.1f} s, side by side)")
    return report


def _k1_sums(report, report2):
    """K1 alone on the heaviest dense round and summed over every round
    that phases 4 and 5 replay; logged and returned."""
    ms = [r["kernel_ms"] for r in report["per_round"]] \
        + [r["k1_ms"] for r in report2["per_round"]]
    out = {"heaviest_ms": report["heaviest"]["kernel_ms"],
           "sum_ms": sum(ms), "rounds": len(ms)}
    log(f"[k1-cell] K1 alone (global-load cell): heaviest dense round "
        f"{out['heaviest_ms']:.4f} ms; summed over the {len(ms)} replayed "
        f"rounds of phases 4-5 {out['sum_ms']:.4f} ms")
    return out


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
    launches2, err2, report2, part_pr, want_pr, want_conv = phase_slice2(
        torch, np, dev, g, part, root, want)
    report["k1_sums"] = _k1_sums(report, report2)
    errs3 = phase_lane_kernels_vs_plain(torch, np, dev)
    launches3, err3, report3 = phase_lanes(torch, np, dev, g, part, root,
                                           want, part_pr, want_pr)
    t_tiled = time.perf_counter()
    errs4 = phase_tiled_kernels_vs_plain(torch, np, dev)
    launches4, err4, report4 = phase_tiled(torch, np, dev, g, part, root,
                                           want, part_pr, want_conv)
    report4["phase_s"] = time.perf_counter() - t_tiled
    log(f"[tiled] phase 7: {report4['phase_s']:.1f} s")
    t8 = time.perf_counter()
    launches8, err8, report8 = phase_compact(
        torch, np, dev, g, part, root, want, part_pr, want_pr, want_conv)
    launches8b, report8b = phase_serving(torch, np, dev, g, part_pr, want)
    for k, n in launches8b.items():
        launches8[k] += n
    report8.update(serving=report8b,
                   phase_s=time.perf_counter() - t8)
    log(f"[compact] phase 8: {report8['phase_s']:.1f} s")
    launches9, report9 = phase_mutation(torch, np, dev, g, part, root,
                                        part_pr)
    launches10, err10, report10 = phase_sharded(
        torch, np, dev, g, part, root, want, part_pr, want_pr, want_conv)
    report11 = phase_amcca(torch, np, dev)
    report12 = phase_lm_serve(torch, np, dev)
    report13 = phase_lm_train(torch, np, dev, smi)
    report14 = phase_lm_sharded(torch, np, dev, smi, report13)
    torch.cuda.empty_cache()
    report15 = phase_dryrun(torch, np, dev, smi)
    heavy, heavy2 = report["heaviest"], report2["heaviest"]
    k3, k4, k9 = report3["k3"], report3["k4"], report3["k9"]
    k9_sum = report3["k9_sum"]

    report.update(slice2=report2, slice3=report3, slice4=report4,
                  slice10=report8, slice11=report9, slice12=report10,
                  slice13={"amcca": report11, "lm_serve": report12},
                  slice14={"lm_train": report13},
                  slice15={"lm_sharded": report14},
                  slice16={"dryrun": report15},
                  device=smi, build_s=build_s,
                  total_s=time.perf_counter() - t_start)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    kernels = {"kernels": [{
        "name": "fused_relax_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_relax_reduce_wl.cu",
        "replaces": "src/repro/kernels/fused_relax_reduce.py:323",
        "launches": k1_launches + launches2["K1"] + launches8["K1"]
        + launches9["K1"] + launches10["K1"],
        "max_abs_err": max(err, errs["K1"], err8["K1"], err10["K1"]),
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
        "launches": launches2["K2"] + launches8["K2"] + launches9["K2"]
        + launches10["K2"],
        "max_abs_err": max(err2, errs["K2"], err8["K2"], err10["K2"]),
        "ms": heavy2["ms"],
        "plain_ms": heavy2["plain_ms"],
        "bound_ms": heavy2["bound_ms"],
        "bound_by": heavy2["bound_by"],
        "library_ms": heavy2["library_ms"],
        "kernel_ms": heavy2["kernel_ms"],
        "device_kernel_ms": heavy2["device_kernel_ms"],
        "median_ms": report2["median"]["ms"],
        "checked": True,
    }, {
        "name": "fused_relax_reduce_lanes",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_relax_reduce_wl_lanes.cu",
        "replaces": "src/repro/kernels/fused_relax_reduce.py:391",
        "launches": launches3["K3"] + launches8["K3"] + launches9["K3"]
        + launches10["K3"],
        "max_abs_err": max(err3["K3"], errs3["K3"], err8["K3"],
                           err10["K3"]),
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
        "launches": launches3["K4"] + launches8["K4"] + launches9["K4"]
        + launches10["K4"],
        "max_abs_err": max(err3["K4"], errs3["K4"]),
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
        "kernel_ms": k4["kernel_ms"],
        "device_kernel_ms": k4["device_kernel_ms"],
        "lanes": k4["lanes"],
        "checked": True,
    }, {
        "name": "segment_combine",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_combine.cu",
        "replaces": "src/repro/kernels/rhizome_segment_reduce.py:39",
        "launches": launches3["K9"] + launches8["K9"] + launches9["K9"]
        + launches10["K9"],
        "max_abs_err": max(err3["K9"], errs3["K9"], err8["K9"], err10["K9"]),
        "ms": k9["ms"],
        "plain_ms": k9["plain_ms"],
        "bound_ms": k9["bound_ms"],
        "bound_by": k9["bound_by"],
        "library_ms": k9["library_ms"],
        "kernel_ms": k9["kernel_ms"],
        "raw_ms": k9["raw_ms"],
        "sum_kernel_ms": k9_sum["kernel_ms"],
        "sum_raw_ms": k9_sum["raw_ms"],
        "sum_library_ms": k9_sum["library_ms"],
        "sum_max_abs_err": k9_sum["max_abs_err"],
        "checked": True,
    }]}
    tiled = (("K5", "fused_relax_reduce_tiled", 502),
             ("K6", "fused_relax_reduce_wl_tiled", 703),
             ("K7", "fused_relax_reduce_tiled_lanes", 553),
             ("K8", "fused_relax_reduce_wl_tiled_lanes", 744))
    for row, key in zip(kernels["kernels"], ("k1", "k2", "k3", None, "k9")):
        if key is not None:
            c8 = report8[key]
            row["compact"] = {f: c8[f] for f in (
                "kernel_ms", "dense_plan_kernel_ms", "ms", "plain_ms",
                "bound_ms", "library_ms") if f in c8}
    for key, name, line in tiled:
        cu = name if "_wl_" in name else name.replace("_tiled", "_wl_tiled")
        check(launches4[key] > 0, f"{key} was never launched on the path")
        row = report4[key.lower()]
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{cu}.cu",
            "replaces": f"src/repro/kernels/fused_relax_reduce.py:{line}",
            "launches": launches4[key] + launches8[key] + launches9[key]
            + launches10[key],
            "max_abs_err": max(err4[key], errs4[key]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel_ms": row["kernel_ms"],
            "pinned_ms": row["pinned_ms"],
            "dma_bytes": row["dma_bytes"],
            "vblk": row["vblk"],
            "checked": True,
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--plan-timing" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--plan-timing") + 1:]
        sys.exit(plan_timing(pathlib.Path(rest[0]).resolve() if rest
                             else SRC))
    if "--fold-sweep" in sys.argv[1:]:
        sys.exit(fold_sweep())
    if "--trace-drops" in sys.argv[1:]:
        sys.exit(trace_drops())
    if "--lm-sharded" in sys.argv[1:]:
        sys.exit(lm_sharded_alone())
    if "--dryrun" in sys.argv[1:]:
        sys.exit(dryrun_job(json.loads(
            sys.argv[sys.argv.index("--dryrun") + 1])))
    if "--lm-resume" in sys.argv[1:]:
        sys.exit(lm_resume(sys.argv[sys.argv.index("--lm-resume") + 1]))
    sys.exit(main())
