"""The port stands alone: no ``jax`` and no ``repro`` anywhere in it, and
its entry points never move to the CPU on their own."""
import ast
import json
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
                                   "LanesTask", "run_sharded",
                                   "run_sharded_lanes", "ShardedTask",
                                   "AmccaSim", "CostModel", "Model",
                                   "serve_cli", "Trainer", "train_cli",
                                   "make_train_step", "make_test_mesh",
                                   "make_ctx", "make_production_mesh",
                                   "train_cli_mesh", "dryrun_cli",
                                   "run_cell", "lower_graph_cell",
                                   "lower_pipeline_cell"])
def test_entry_points_without_device_need_cuda(monkeypatch, tmp_path,
                                              entry):
    from repro_torch.apps import (
        batched_queries, bfs, cc, pagerank, pagerank_delta,
        personalized_pagerank, sssp,
    )
    from repro_torch.core import actions, engine, resilient
    from repro_torch.core.amcca_sim import AmccaSim
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.lm.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.lm.launch import dryrun, serve, train
    from repro_torch.lm.launch.mesh import (make_ctx, make_production_mesh,
                                            make_test_mesh)
    from repro_torch.lm.models import Model
    from repro_torch.lm.train import AdamW, make_train_step
    from repro_torch.lm.train.trainer import Trainer, TrainerConfig
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
        "AmccaSim": lambda: AmccaSim(part),
        "CostModel": lambda: CostModel(part),
        "Model": lambda: Model(get_config("minitron-4b").reduced()),
        "serve_cli": lambda: serve.main(["--arch", "minitron-4b",
                                         "--reduced"]),
        "Trainer": lambda: Trainer(
            Model(get_config("minitron-4b").reduced()), AdamW(),
            TokenPipeline(vocab=512, seq_len=8, global_batch=2),
            TrainerConfig(steps=1, ckpt_dir=str(tmp_path))),
        "train_cli": lambda: train.main(["--arch", "minitron-4b",
                                         "--reduced", "--steps", "1",
                                         "--ckpt-dir", str(tmp_path)]),
        "make_train_step": lambda: make_train_step(
            Model(get_config("minitron-4b").reduced()), AdamW()),
        "make_test_mesh": lambda: make_test_mesh(),
        "make_ctx": lambda: make_ctx(make_test_mesh((1, 1))),
        "make_production_mesh": lambda: make_production_mesh(),
        "train_cli_mesh": lambda: train.main(["--arch", "minitron-4b",
                                              "--reduced", "--mesh", "1,1",
                                              "--ckpt-dir", str(tmp_path)]),
        "dryrun_cli": lambda: dryrun.main(["--arch", "minitron-4b",
                                           "--shape", "train_4k",
                                           "--reduced"]),
        "run_cell": lambda: dryrun.run_cell("minitron-4b", "train_4k",
                                            False, reduced=True),
        "lower_graph_cell": lambda: dryrun.lower_graph_cell(False),
        "lower_pipeline_cell": lambda: dryrun.lower_pipeline_cell(),
    }
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun"))
    sharded = {
        "run_sharded": lambda mesh, p: engine.run_sharded(
            actions.BFS, p, engine.init_values(p, actions.BFS, {0: 0.0}),
            mesh),
        "run_sharded_lanes": lambda mesh, p: lanes.run_sharded_lanes(
            p, lanes.init_lane_values(p, [("bfs", 0)])[0], mesh=mesh),
        "ShardedTask": lambda mesh, p: resilient.ShardedTask(
            actions.BFS, p, engine.init_values(p, actions.BFS, {0: 0.0}),
            mesh),
    }
    if entry in sharded:
        from repro_torch.core.partition import build_partition
        from torch_dist import single_rank_mesh
        one = build_partition(g, PartitionConfig(num_shards=1))
        with single_rank_mesh() as mesh, \
                pytest.raises(RuntimeError, match="no CUDA device"):
            sharded[entry](mesh, one)
        return
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
            "checkpoint", "runtime", "exchange", "exchange.rounds",
            "core.engine", "query.lanes", "kernels.ref", "core.amcca_sim",
            "core.costmodel", "serve.scheduler", "lm.configs",
            "lm.configs.base", "lm.models.layers", "lm.models.ssm",
            "lm.models.model", "data", "data.pipeline",
            "sharding.compression", "lm.train", "lm.train.optimizer",
            "lm.train.trainer", "sharding.specs", "sharding.pipeline",
            "lm.models.moe", "lm.launch.mesh", "lm.launch.hlo_analysis",
            "lm.launch.dryrun", "lm.launch.reanalyze"]
# importing these reference modules sets XLA_FLAGS (a 512-device host
# platform) for the whole process: their names are read in a child
SET_ENV = {"lm.launch.dryrun", "lm.launch.reanalyze"}


def _public_names(package, name):
    import importlib
    mod = importlib.import_module(f"{package}.{name}")
    return {n for n in (getattr(mod, "__all__", None) or vars(mod))
            if not n.startswith("_")
            and getattr(getattr(mod, n), "__module__", "").startswith(
                f"{package}.")}


@pytest.mark.parametrize("name", MIRRORED)
def test_new_modules_mirror_reference_names(name):
    """The modules ported for mutation, fault tolerance, the sharded
    layout, the AM-CCA simulation layer, the LM serving and training
    paths and the dry-run tools carry every public name of their
    reference counterpart."""
    import importlib
    if name in SET_ENV:
        code = ("import json, sys\n"
                f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
                "from test_torch_imports import _public_names\n"
                f"print(json.dumps(sorted(_public_names('repro', {name!r}))))")
        res = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=ROOT, timeout=120,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                 "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr
        want = set(json.loads(res.stdout.strip().splitlines()[-1]))
    else:
        want = _public_names("repro", name)
    port = importlib.import_module(f"repro_torch.{name}")
    assert want, name
    assert want <= set(vars(port)), sorted(want - set(vars(port)))


@pytest.mark.parametrize("path", [PKG / "exchange" / "collectives.py",
                                  ROOT / "tests" / "torch_dist.py",
                                  PKG / "sharding" / "pipeline.py",
                                  PKG / "lm" / "launch" / "mesh.py",
                                  ROOT / "tests" / "torch_dist_lm.py"],
                         ids=["collectives", "torch_dist", "pipeline",
                              "mesh", "torch_dist_lm"])
def test_sharded_layout_stands_alone(path):
    """The collectives module, and the helper whose spawned ranks run the
    sharded tests, import neither JAX nor the reference package, even
    where nothing blocks them; the collectives are the exchange layer's
    ``exchange.collectives``."""
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({str(path)!r}, run_name='m')\n"
        "from repro_torch import exchange\n"
        "from repro_torch.exchange import collectives\n"
        "assert exchange.collectives is collectives\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_serve_does_not_import_the_lm_stack():
    """``repro_torch.serve`` re-exports the LM serve steps lazily: importing
    it (and its submodules) loads nothing of ``repro_torch.lm``, and the
    first lookup of an export loads the train-step module."""
    code = (
        "import sys\n"
        "import repro_torch.serve\n"
        "import repro_torch.serve.admission\n"
        "print(sorted(m for m in sys.modules "
        "if m.startswith('repro_torch.lm')))\n"
        "f = repro_torch.serve.make_serve_steps\n"
        "print(f.__module__)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:2] == [
        "[]", "repro_torch.lm.train.train_step"]


@pytest.mark.parametrize("world", [None, "2", "8"])
def test_train_mesh_needs_its_rank_count(monkeypatch, tmp_path, world):
    """``train --mesh 2,2`` outside a world of 4 ranks raises, naming both
    counts, before it touches a device or a process group."""
    from repro_torch.lm.launch import train
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(ValueError, match=f"needs 4 ranks, WORLD_SIZE is "
                                         f"{world or 1}"):
        train.main(["--arch", "minitron-4b", "--reduced", "--mesh", "2,2",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path)])


def test_no_sharded_lm_stub_is_left():
    """Every place that raised for a bound mesh, waiting for sharded LM
    training, now runs."""
    left = [f"{p.relative_to(PKG)}:{i}"
            for p in PKG.rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if "item 12c" in line or "not ported yet" in line]
    assert left == []
