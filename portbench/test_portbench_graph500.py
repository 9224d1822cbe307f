"""The ``graph500`` traffic on the CPU: Graph500's validation counts each
kind of bad tree, the program reads correct and each control, and each
fault planted underneath, not; the parent pass's byte count and the new
readers.  The chip's readings come from ``run.py`` and ``control.py``
at the cell's own size."""
import copy
import json
import math
import pathlib
import time

import numpy as np
import pytest
import torch

from benchlib import check, graph500, reference, spec, traffic

HERE = pathlib.Path(__file__).parent
CELL = "graph500-s22-traversal"
MAX = np.iinfo(np.int32).max


def _csr(edges, n):
    src, dst, w = (torch.tensor(x) for x in zip(*edges))
    return reference.CSR.from_coo(n, src.long(), dst.long(), w.float())


# 0 -> 1 (0.5), 0 -> 2 (0.25), 2 -> 1 (0.125, and a duplicate of 0.5),
# 1 -> 3 (1.0), 3 -> 1 (1.0); vertex 4 unreached
EDGES = [(0, 1, 0.5), (0, 2, 0.25), (2, 1, 0.125), (2, 1, 0.5),
         (1, 3, 1.0), (3, 1, 1.0)]
LEVELS = np.array([0, 1, 1, 2, MAX])
BFS_PARENTS = np.array([0, 0, 0, 1, -1])
DIST = np.array([0.0, 0.375, 0.25, 1.375, np.inf])
SSSP_PARENTS = np.array([0, 2, 0, 1, -1])


def test_validate_tree_passes_sound_trees():
    csr = _csr(EDGES, 5)
    assert graph500.validate_tree(csr, 0, LEVELS, BFS_PARENTS, "bfs",
                                  1e-5) == 0
    assert graph500.validate_tree(csr, 0, DIST, SSSP_PARENTS, "sssp",
                                  1e-5) == 0
    # the reference's levels (-1 unreached) read as the port's do
    ref_levels = np.where(LEVELS == MAX, -1, LEVELS)
    assert graph500.validate_tree(csr, 0, ref_levels, BFS_PARENTS, "bfs",
                                  1e-5) == 0


@pytest.mark.parametrize("kind,fault,values,parents,count", [
    ("bfs", "wrong_root", LEVELS, [1, 0, 0, 1, -1], 1),
    ("bfs", "cycle", LEVELS, [0, 3, 0, 1, -1], 2),        # 1 <-> 3
    ("bfs", "non_edge", LEVELS, [0, 0, 0, 2, -1], 1),     # (2, 3) no edge
    ("bfs", "wrong_level", LEVELS, [0, 2, 0, 1, -1], 1),  # level 1 from 1
    ("bfs", "parent_of_unreached", LEVELS, [0, 0, 0, 1, 3], 1),
    ("bfs", "unreached_without_parent", LEVELS, [0, -1, 0, 1, -1], 2),
    ("sssp", "distance_off", DIST * np.array([1, 1, 1, 1 + 1e-3, 1]),
     SSSP_PARENTS, 1),
    ("sssp", "longer_edge", DIST, [0, 0, 0, 1, -1], 1),   # 0.5 != 0.375
    ("sssp", "out_of_range", DIST, [0, 2, 0, 7, -1], 1),
])
def test_validate_tree_counts_each_bad_kind(kind, fault, values, parents,
                                            count):
    csr = _csr(EDGES, 5)
    got = graph500.validate_tree(csr, 0, np.asarray(values),
                                 np.asarray(parents), kind, 1e-5)
    assert got == count, fault


def test_validate_tree_takes_the_least_duplicate_weight_and_rel_tol():
    csr = _csr(EDGES, 5)
    # d[1] = 0.25 + 0.125 within 1e-5 relative: passes; 1e-4 off: fails
    near = DIST * np.array([1, 1 + 5e-6, 1, 1, 1])
    far = DIST * np.array([1, 1 + 1e-4, 1, 1, 1])
    assert graph500.validate_tree(csr, 0, near, SSSP_PARENTS, "sssp",
                                  1e-5) == 0
    assert graph500.validate_tree(csr, 0, far, SSSP_PARENTS, "sssp",
                                  1e-5) == 2          # 1, and 3 from it
    assert graph500.validate_tree(csr, 0, LEVELS[:3], BFS_PARENTS, "bfs",
                                  1e-5) == 5          # wrong shape: all


def test_distance_errors_and_the_parents_control():
    want = torch.tensor([0.0, 0.0, 2.0, 4.0, math.inf], dtype=torch.float64)
    assert graph500.distance_errors([0, 0, 2, 4.00002, np.inf], want) == \
        (0, pytest.approx(5e-6))
    assert graph500.distance_errors([0, 1e-9, 2, 4, np.inf], want)[1] == \
        math.inf                                      # 0 must read 0
    assert graph500.distance_errors([0, 0, np.inf, 4, 1.0], want)[0] == 2
    assert graph500.distance_errors([0, 0], want) == (5, math.inf)
    swapped = graph500.swap_parents(LEVELS, BFS_PARENTS, "bfs")
    np.testing.assert_array_equal(swapped, [1, 2, 3, 0, -1])
    csr = _csr(EDGES, 5)
    assert graph500.validate_tree(csr, 0, LEVELS, swapped, "bfs", 1e-5) > 0


def test_tree_bytes_count_from_the_graph():
    # 3 reached vertices, 5 edges out of them, n = 8: each edge's id and
    # destination value (and weight), 3 x (2 offsets + value + parent),
    # 8 parent ids
    assert graph500.tree_bytes(8, 3, 5, False) == 5 * 8 + 3 * 16 + 8 * 4
    assert graph500.tree_bytes(8, 3, 5, True) == 5 * 12 + 3 * 16 + 8 * 4


def test_new_readers_read_traced_facts_only():
    read = {m: spec.load_reader(HERE, m) for m in (
        "tree_ms_per_call.graph500", "tree_roofline_pct.graph500")}
    untraced = {"window_s": 30.0, "fixpoints": 10, "teps_edges": 1e9,
                "tree_bytes": 3.35e9, "bound_bytes": 6.7e9}
    assert all(r(untraced) is None for r in read.values())
    traced = dict(untraced, tree_span_s=0.5, tree_calls=100,
                  tree_device_s=0.004)
    assert read["tree_ms_per_call.graph500"](traced) == pytest.approx(5.0)
    assert read["tree_roofline_pct.graph500"](traced) == pytest.approx(25.0)


def tiny(seed=2**31 + 7, controls=(), trace=False, cell=None,
         seconds=0.15):
    """The cell's run at scale 7 on the CPU (the port's torch relax and
    K10's plain version); returns (correct by who, facts, readings)."""
    cell = cell or spec.load_cell(HERE.parent, HERE, CELL, trace=False)
    cfg = dict(cell.config, scale=7,
               partition={"num_shards": 4, "rpvo_max": 4})
    t = copy.deepcopy(cell.traffic)
    t["engine"]["use_pallas"] = False
    t["root_pool"] = 8
    facts, readings = traffic.run(traffic.Run(
        cfg, t, cell.driver, seed, seconds, trace, torch.device("cpu"),
        time.perf_counter(), controls=controls))
    verdicts = {who: check.verdict(rd, t["limits"])[0]
                for who, rd in readings.items()}
    return verdicts, facts, readings


def test_program_is_correct_and_every_control_is_not():
    # a window long enough for a BFS and an SSSP on a busy host
    verdicts, facts, readings = tiny(controls=("bf16", "stale", "parents"),
                                     seconds=1.0)
    assert facts["fixpoints"] >= 2
    assert verdicts == {None: True, "bf16": False, "stale": False,
                        "parents": False}
    assert facts["attempted"] > 0 and facts["failed"] == 0
    assert facts["fixpoints"] == facts["attempted"]
    assert facts["tree_bytes"] > 0 and \
        facts["bound_bytes"] > facts["tree_bytes"]
    assert 0 < readings[None]["sssp_max_rel_err"] <= 1e-5
    assert readings["bf16"]["sssp_max_rel_err"] > 1e-3
    assert readings["parents"]["bfs_parent_invalid"] > 0
    assert readings["parents"]["sssp_parent_invalid"] > 0
    assert readings["stale"]["bfs_mismatch"] > 0
    for m in ("tree_ms_per_call.graph500", "tree_roofline_pct.graph500"):
        assert spec.load_reader(HERE, m)(facts) is None   # untraced


def _tree_fault(monkeypatch):
    from repro_torch.apps import tree
    run = tree.parents

    def all_root(*a, **k):                   # every parent the root
        par, ties = run(*a, **k)
        return np.where(par >= 0, a[3], -1), ties
    monkeypatch.setattr(tree, "parents", all_root)


def _values_fault(monkeypatch):
    from repro_torch.core import engine
    values = engine.vertex_values

    def one_off(part, val):
        out = np.array(values(part, val))
        finite = np.flatnonzero(np.isfinite(out))
        if finite.size:
            out[finite[-1]] += 1
        return out
    monkeypatch.setattr(engine, "vertex_values", one_off)


@pytest.mark.parametrize("fault", [_tree_fault, _values_fault],
                         ids=["parents_all_root", "answer_altered"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    verdicts, _, _ = tiny()
    assert verdicts[None] is False


def test_driver_exits_on_a_port_without_trees(monkeypatch):
    from repro_torch import apps
    monkeypatch.delattr(apps, "bfs_tree")
    with pytest.raises(SystemExit) as e:
        tiny()
    assert e.value.code not in (None, 0)


class _Profiled:
    """A stand-in for ``benchlib.trace.Window`` on the CPU: no device
    trace, one K10 kernel record of 2 ms."""

    def __init__(self, on):
        from types import SimpleNamespace as NS

        from torch.autograd import DeviceType
        kernel = NS(name="void tree_parents_kernel<true, true>(float)",
                    device_type=DeviceType.CUDA,
                    time_range=NS(start=0.0, end=2000.0))
        other = NS(name="frr_wl_kernel", device_type=DeviceType.CUDA,
                   time_range=NS(start=0.0, end=5000.0))
        self.prof = NS(events=lambda: [kernel, other])
        self.result = None

    def warm(self, step):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_traced_run_reads_the_tree_spans_and_k10s_time(monkeypatch):
    from repro_torch import obs
    cell = spec.load_cell(HERE.parent, HERE, CELL, trace=True)
    monkeypatch.setattr(cell.driver, "Window", _Profiled)
    seen = []
    run = cell.driver._drive

    def drive(r, g, apps, pool, rec):
        seen.append(obs.get_recorder() is rec is not None)
        return run(r, g, apps, pool, rec)
    monkeypatch.setattr(cell.driver, "_drive", drive)
    verdicts, facts, _ = tiny(trace=True, cell=cell)
    assert verdicts[None] is True and seen == [True]
    assert obs.get_recorder() is None
    assert facts["tree_device_s"] == pytest.approx(2e-3)
    assert facts["tree_calls"] > 0 and facts["tree_span_s"] > 0
    values = {m.name: m.read(facts) for m in cell.metrics}
    for name in ("tree_ms_per_call.graph500", "tree_roofline_pct.graph500",
                 "host_syncs_per_fixpoint.graph500", "partition_s"):
        assert values[name] is not None and values[name] > 0, name


def test_untraced_run_installs_nothing(monkeypatch):
    from repro_torch import obs
    from repro_torch.core import engine
    seen = []
    run = engine.run_stacked

    def spy(*a, **k):
        seen.append(obs.get_recorder())
        return run(*a, **k)
    monkeypatch.setattr(engine, "run_stacked", spy)
    tiny()
    assert seen and all(r is None for r in seen)


def test_search_config_makes_the_pagerank_cells_graph():
    """The deployment's own file repeats ``graph500-s22``'s generator and
    partition keys, so a seed makes the same graph and partition in
    both cells; this holds the two files equal."""
    pagerank, search = (
        json.loads((HERE / "configs" / f"{name}.json").read_text())
        for name in ("graph500-s22", "graph500-s22-search"))
    own = {"name", "source", "guarantees", "assumed"}
    for key in sorted((set(pagerank) | set(search)) - own):
        assert pagerank.get(key) == search.get(key), key
    assert {"generator", "scale", "weight", "partition"} <= set(search)
