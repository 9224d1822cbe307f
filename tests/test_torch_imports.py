"""The port stands alone: no ``jax`` and no ``repro`` anywhere in it, and
its entry points never move to the CPU on their own."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax_or_reference():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def _tiny():
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators
    g = generators.ring(16)
    return g, build_partition(g, PartitionConfig(num_shards=2))


@pytest.mark.parametrize("entry", ["bfs", "sssp", "run_stacked",
                                   "from_partition", "pagerank",
                                   "pagerank_delta", "run_pagerank_delta",
                                   "batched_queries", "cc",
                                   "personalized_pagerank",
                                   "run_stacked_lanes", "run_ppr_lanes",
                                   "run_ppr_delta_lanes", "QueryServer",
                                   "StreamingGraph", "DynamicGraph",
                                   "StackedTask", "PagerankTask",
                                   "LanesTask"])
def test_entry_points_without_device_need_cuda(monkeypatch, entry):
    from repro_torch.apps import (
        batched_queries, bfs, cc, pagerank, pagerank_delta,
        personalized_pagerank, sssp,
    )
    from repro_torch.core import actions, engine, resilient
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.core.streaming import StreamingGraph
    from repro_torch.query import QueryServer, lanes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, part = _tiny()
    init, unitw = lanes.init_lane_values(part, [("bfs", 0), ("sssp", 1)])
    calls = {
        "batched_queries": lambda: batched_queries(g, [("bfs", 0)],
                                                   part=part),
        "cc": lambda: cc(g),
        "personalized_pagerank": lambda: personalized_pagerank(g, [0]),
        "run_stacked_lanes": lambda: lanes.run_stacked_lanes(part, init,
                                                             unitw),
        "run_ppr_lanes": lambda: lanes.run_ppr_lanes(part, [0], 0.85),
        "run_ppr_delta_lanes": lambda: lanes.run_ppr_delta_lanes(
            part, [0, 1], 0.85),
        "bfs": lambda: bfs(g, 0, part=part),
        "sssp": lambda: sssp(g, 0, part=part),
        "run_stacked": lambda: engine.run_stacked(
            actions.BFS, part, engine.init_values(part, actions.BFS,
                                                  {0: 0.0})),
        "from_partition": lambda: engine.DeviceArrays.from_partition(part),
        "pagerank": lambda: pagerank(g, part=part),
        "pagerank_delta": lambda: pagerank_delta(g, part=part),
        "run_pagerank_delta": lambda: engine.run_pagerank_delta(part),
        "QueryServer": lambda: QueryServer(part),
        "StreamingGraph": lambda: StreamingGraph(
            g, PartitionConfig(num_shards=2)).track("bfs", 0),
        "DynamicGraph": lambda: DynamicGraph.build(
            g, PartitionConfig(num_shards=2)).bfs_full(0),
        "StackedTask": lambda: resilient.StackedTask(
            actions.BFS, part, engine.init_values(part, actions.BFS,
                                                  {0: 0.0})),
        "PagerankTask": lambda: resilient.PagerankTask(part),
        "LanesTask": lambda: resilient.LanesTask(part, init, unitw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_cpu_device_runs_when_asked():
    from repro_torch.apps import bfs
    g, part = _tiny()
    levels, stats, _ = bfs(g, 0, part=part, device="cpu")
    np.testing.assert_array_equal(levels, np.arange(16))
    assert int(stats.iterations) == 16


MIRRORED = ["checkpoint.manager", "runtime.chaos", "runtime.elastic",
            "core.dynamic", "core.streaming", "core.resilient",
            "checkpoint", "runtime"]


@pytest.mark.parametrize("name", MIRRORED)
def test_new_modules_mirror_reference_names(name):
    """The modules ported for mutation and fault tolerance carry every
    public name of their reference counterpart."""
    import importlib
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    want = {n for n in (getattr(ref, "__all__", None) or vars(ref))
            if not n.startswith("_")
            and getattr(getattr(ref, n), "__module__", "").startswith(
                "repro.")}
    assert want, name
    assert want <= set(vars(port)), sorted(want - set(vars(port)))
