"""``run.py``'s body: one run of one cell, its result as the last line of
standard output."""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names
# The host threads of the program's CPU operations.  One reads steadier
# on a card whose host cores are shared: eight threads raced other
# tenants for them.
HOST_THREADS = 1


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's "
                                "benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: pathlib.Path) -> None:
    """Every compiler cache a run could fill, at fixed paths inside the
    checkout (the port's nvcc builds already live in
    ``src/repro_torch/kernels/build``)."""
    base = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def host_threads() -> None:
    """``HOST_THREADS`` for the program's CPU operations, set before torch
    loads."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def device_block(torch, chips: int, facts: dict, trace: dict | None):
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips,
           "memory_peak_bytes": facts.get("memory_peak_bytes", 0)}
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev


def metrics_of(cell, facts: dict) -> dict:
    out = {}
    for m in cell.metrics:
        v = m.read(facts)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out


def main(argv, t_start: float, root: pathlib.Path,
         bench_dir: pathlib.Path) -> int:
    args = parse(argv)
    cache_dirs(root)
    from benchlib import spec

    cell = spec.load_cell(root, bench_dir, args.workload, bool(args.trace))
    host_threads()
    sys.path.insert(0, str(root / "src"))
    import torch

    from benchlib import check, traffic

    torch.set_num_threads(HOST_THREADS)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.cuda.init()
    print(f"portbench: {time.perf_counter() - t_start:9.3f} s  torch and "
          "the card ready", file=sys.stderr, flush=True)
    facts, readings = traffic.run(traffic.Run(
        config=cell.config, traffic=cell.traffic, driver=cell.driver,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t_start=t_start))
    correct, checks = check.verdict(readings[None], cell.traffic["limits"])
    result = {"correct": correct, "attempted": facts["attempted"],
              "failed": facts["failed"], "metrics": metrics_of(cell, facts),
              "device": device_block(torch, cell.chips, facts,
                                     facts.get("trace"))}
    if "trace" in facts:
        result["breakdown"] = {"device_ops": facts["trace"]["ops"],
                               "idle_gaps": facts["trace"]["gaps"]}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
