"""What every traffic driver shares: the run's inputs, the graph made from
the seed, and the steps of set-up, window and check that the drivers
under ``drivers/`` have in common.

A traffic file (``traffic/<mix>.json``) holds a mix's parameters and
names its driver, ``drivers/<driver>.py``, found by name
(``spec.load_driver``).  A driver's ``run(r, graph)`` drives the port
through set-up, the measured window and the check, and returns
``(facts, readings)``: the facts the metric readers read, and each
compared number, ``readings[None]`` for the program and ``readings[c]``
for control ``c`` (one of the driver's ``CONTROLS``) answering the same
sampled calls.  Each driver samples answers (``sample``: a reservoir per
kind of answer, drawn from the seed) and compares them once the window
has closed and the peak memory has been read; the traffic file's
``limits`` gives each compared number's limit.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from benchlib import check, graphgen, port, reference
from benchlib.trace import Window

SEARCHES = ("bfs", "sssp", "reachability")


@dataclasses.dataclass
class Run:
    """One run's inputs: the cell's configuration and traffic, the
    traffic's driver module, the seed, the window's seconds, whether the
    window is traced, the device, the process's start on the host clock,
    and the controls whose readings are taken beside the program's."""

    config: dict
    traffic: dict
    driver: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    controls: tuple = ()


def run(r: Run) -> tuple[dict, dict]:
    """(facts, readings) of one run of the driver over the seed's graph."""
    for c in r.controls:
        if c not in r.driver.CONTROLS:
            raise ValueError(f"unknown control {c!r} for driver "
                             f"{r.traffic['driver']!r}")
    g = graphgen.make_graph(r.config, r.seed, r.device)
    log(r, f"graph made: {g.n} vertices, {g.num_edges} edges")
    return r.driver.run(r, g)


def log(r: Run, what: str) -> None:
    """A phase's end, in host seconds since the process started, on
    standard error."""
    print(f"portbench: {time.perf_counter() - r.t_start:9.3f} s  {what}",
          file=sys.stderr, flush=True)


def roots(r: Run, g: graphgen.Graph, pool: int) -> list[int]:
    """``pool`` vertices drawn from the seed, uniformly among those with
    an out-edge (Graph500's search keys)."""
    cand = torch.nonzero(g.out_degrees() >= 1).reshape(-1).cpu().numpy()
    rng = np.random.default_rng([int(r.seed), 1])
    return [int(v) for v in rng.choice(cand, int(pool), replace=False)]


def partition(r: Run, coo) -> tuple[object, float]:
    """The port's partition of ``coo`` and its host seconds."""
    t0 = time.perf_counter()
    part = port.build_partition(coo, r.config["partition"])
    return part, time.perf_counter() - t0


def log_partition(r: Run, facts: dict, part) -> None:
    log(r, f"partition built in {facts['partition_s']:.3f} s: S {part.S}, "
        f"R_max {part.R_max}, E_max {part.E_max}")


def read_peak(r: Run, facts: dict) -> None:
    """The window's peak device memory, read before the program's state is
    dropped and the reference runs on the same device."""
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
        facts["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            r.device))


def free(r: Run) -> None:
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()


def window_facts(facts: dict, w: Window, window_s: float) -> None:
    facts["window_s"] = window_s
    if w.result is not None:
        facts["trace"] = dict(w.result, window_s=window_s)


def search_readings(r: Run, readings: dict, samples: dict, csr,
                    reach: dict) -> None:
    """Vertices that differ from the reference, summed over each kind's
    sampled answers (``samples[kind].items``: (root, answer)), for the
    program and for each control; ``reach`` caches the reference's BFS
    by root."""
    ssp = {}
    for who in (None, *r.controls):
        got = readings.setdefault(who, {})
        for kind, res in samples.items():
            bad = 0
            for root, out in res.items:
                if kind == "sssp":
                    if root not in ssp:
                        ssp[root] = reference.sssp(csr, root)
                    want = ssp[root]
                else:
                    if root not in reach:
                        reach[root] = reference.bfs(csr, root)
                    want = reach[root]
                if who is not None:
                    out = check.control_answer(who, kind, csr, root)
                bad += check.mismatches(kind, out, want, csr.n)
            got[{"reachability": "reach"}.get(kind, kind) + "_mismatch"] = bad
