"""The port's crash-safe fixpoints against the reference's.

``run_resilient`` of both packages drives the same task (``StackedTask``,
``PagerankTask``, ``LanesTask``) on the same partition under the same
``ChaosPlan`` and ``RecoveryPolicy``: the port's result equals the
reference's (min bit for bit, delta-PageRank within the reference
test's tolerance), its ``RunStats`` exactly, and its ``FixpointReport``
field for field (the host-clock seconds aside).  The cases follow the
reference's own (``tests/test_resilience.py``, its non-sharded tests,
and ``tests/test_elastic.py``): every fault kind under the dense, host
and device worklist launches (the port's fused path through the
kernels' plain versions), real checkpoint managers, restore from round
0, degradation, shrink on death, the chaos and elastic state machines,
post-recovery flight-recorder records, a ``QueryServer`` killed and
restored through a real manager, and the streaming WAL — whose
checkpoints each package restores from the other's.  Plus the scale-8
counter gate's ``resilient_kill_restore`` leg.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402,E501
from repro.core import actions as ref_actions  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import resilient as ref_res  # noqa: E402
from repro.core.partition import PartitionConfig as RefPCfg  # noqa: E402
from repro.core.partition import build_partition as ref_build  # noqa: E402
from repro.core.streaming import StreamingGraph as RefStreamingGraph  # noqa: E402,E501
from repro.graph import generators as ref_generators  # noqa: E402
from repro.query import QueryServer as RefQueryServer  # noqa: E402
from repro.runtime import chaos as ref_chaos  # noqa: E402
from repro.runtime import elastic as ref_elastic  # noqa: E402
from repro.serve.admission import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import exchange, interop, obs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import actions, engine, resilient  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.core.streaming import StreamingGraph  # noqa: E402
from repro_torch.graph.graph import COOGraph  # noqa: E402
from repro_torch.kernels.fused_relax_reduce import (  # noqa: E402
    fused_grid_cells, fused_relax_reduce_pallas)
from repro_torch.query import QueryServer  # noqa: E402
from repro_torch.query import lanes  # noqa: E402
from repro_torch.runtime import chaos, elastic  # noqa: E402
from repro_torch.serve.admission import QueryStatus, ServeConfig  # noqa: E402,E501

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent
SIDES = ("reference", "port")


# --------------------------------------------------------------------------
# helpers: one call on both packages
# --------------------------------------------------------------------------

def _pg(g) -> COOGraph:
    return COOGraph(g.n, np.asarray(g.src), np.asarray(g.dst),
                    np.asarray(g.weight))


def _case(scale=7, seed=5, shards=4, rpvo=2):
    g = ref_generators.rmat(scale, edge_factor=5, seed=seed) \
        .with_random_weights(seed=seed)
    part = ref_build(g, RefPCfg(num_shards=shards, rpvo_max=rpvo))
    root = int(np.argsort(-g.out_degrees())[0])
    return g, part, interop.partition_from_dict(dataclasses.asdict(part)), \
        root


def _pr_case(data):
    """The PageRank tests' partition: the reference test's own (random
    weights, whose delta-PageRank overflows; both packages must still
    agree) or ``_pr_graph``'s weights, which converge."""
    if data == "reference_data":
        return _case(seed=8)[1:3]
    from repro.apps.pagerank import _pr_graph
    g = ref_generators.rmat(7, edge_factor=5, seed=8)
    part = ref_build(_pr_graph(g), RefPCfg(num_shards=4, rpvo_max=2))
    return part, interop.partition_from_dict(dataclasses.asdict(part))


PR_CASES = [("reference_data", "dense"), ("pr_weights", "dense"),
            ("pr_weights", "device_worklist")]


def _sssp_init(part, root):
    return engine.init_values(part, actions.SSSP, {root: 0.0})


def _cfgs(**kw):
    return ref_engine.EngineConfig(**kw), engine.EngineConfig(**kw)


def _plans(events):
    """The same ``ChaosPlan`` in both packages."""
    return tuple(mod.ChaosPlan(events=tuple(mod.ChaosEvent(**e)
                                            for e in events))
                 for mod in (ref_chaos, chaos))


def _policies(**kw):
    return ref_chaos.RecoveryPolicy(**kw), chaos.RecoveryPolicy(**kw)


def _report(rep) -> dict:
    d = dataclasses.asdict(rep)
    for k in ("checkpoint_write_s", "recovery_s"):
        d.pop(k)
    return d


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stats(st):
    return [int(x) for x in st]


def _both(make_tasks, chaos_events=None, policy=None, managers=None,
          **kw):
    """Run ``run_resilient`` on the reference's and the port's task and
    assert reports and ``RunStats`` equal; returns both results."""
    tasks = make_tasks()
    plans = _plans(chaos_events) if chaos_events is not None \
        else (None, None)
    pols = _policies(**policy) if policy is not None else (None, None)
    mgrs = managers or (None, None)
    out = []
    for mod, task, plan, pol, mgr in zip((ref_res, resilient), tasks, plans,
                                         pols, mgrs):
        out.append(mod.run_resilient(task, chaos=plan, policy=pol,
                                     manager=mgr, **kw))
    (ra, sa, pa), (rb, sb, pb) = out
    assert _report(pb) == _report(pa)
    assert _stats(sb) == _stats(sa)
    return out


def _stacked_tasks(part_r, part_p, init, cfgs, **kw):
    pkw = dict(kw)
    if "graph" in kw:
        pkw["graph"] = _pg(kw["graph"])
    return lambda: (
        ref_res.StackedTask(ref_actions.SSSP, part_r, init, cfgs[0], **kw),
        resilient.StackedTask(actions.SSSP, part_p, init, cfgs[1],
                              device=CPU, **pkw))


# --------------------------------------------------------------------------
# clean runs equal the shipped runners
# --------------------------------------------------------------------------

GRIDS = [dict(), dict(use_pallas=True, grid_mode="worklist"),
         dict(use_pallas=True, grid_mode="device_worklist")]


@pytest.mark.parametrize("cfg_kw", GRIDS,
                         ids=["dense", "worklist", "device_worklist"])
def test_resilient_no_chaos_equals_run_stacked(cfg_kw):
    g, part_r, part, root = _case()
    init = _sssp_init(part, root)
    cfgs = _cfgs(**cfg_kw)
    (ra, _, _), (got, stats, report) = _both(
        _stacked_tasks(part_r, part, init, cfgs))
    want, wstats = engine.run_stacked(actions.SSSP, part, init, cfgs[1],
                                      device=CPU)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got), _np(ra))
    assert report.status == "ok" and not report.faults
    assert _stats(stats)[:3] == _stats(wstats)[:3]


@pytest.mark.parametrize("data,grid", PR_CASES)
def test_resilient_pagerank_clean_equals_delta_runner(data, grid):
    part_r, part = _pr_case(data)
    cfgs = _cfgs(use_pallas=grid != "dense", grid_mode=grid)
    (ra, _, _), (got, stats, report) = _both(lambda: (
        ref_res.PagerankTask(part_r, 0.85, 1e-6, cfgs[0]),
        resilient.PagerankTask(part, 0.85, 1e-6, cfgs[1], device=CPU)))
    want, wstats = engine.run_pagerank_delta(part, 0.85, 1e-6, cfgs[1],
                                             device=CPU)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_allclose(_np(got), _np(ra), rtol=1e-6, atol=1e-9)
    assert report.status == "ok"
    assert int(stats.iterations) == int(wstats.iterations)
    assert int(stats.messages) == int(wstats.messages)


# --------------------------------------------------------------------------
# the fault-class differential
# --------------------------------------------------------------------------

FAULTS = [
    ("kill_shard", "restore"),
    ("corrupt_tile", "restore"),
    ("drop_inbox", "retry"),
    ("dup_inbox", "retry"),
    ("delay_shard", None),       # a straggler is NOT a fault
]


@pytest.mark.parametrize("kind,action", FAULTS,
                         ids=[k for k, _ in FAULTS])
@pytest.mark.parametrize("grid", ["dense", "worklist", "device_worklist"])
def test_fault_differential_stacked(kind, action, grid):
    cfgs = _cfgs(use_pallas=(grid != "dense"), grid_mode=grid)
    g, part_r, part, root = _case()
    init = _sssp_init(part, root)
    want, wstats = engine.run_stacked(actions.SSSP, part, init, cfgs[1],
                                      device=CPU)
    assert int(wstats.iterations) > 4
    (ra, _, _), (got, stats, report) = _both(
        _stacked_tasks(part_r, part, init, cfgs),
        [dict(round=3, kind=kind, shard=2, rounds=1)])
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got), _np(ra))
    if action is None:
        assert report.status == "ok" and not report.faults
    else:
        assert report.status == "recovered"
        assert any(f.kind == kind and f.action == action
                   for f in report.faults)
    # counters ride the recovery: totals equal the uninterrupted run
    assert _stats(stats)[:3] == _stats(wstats)[:3]


@pytest.mark.parametrize("data,grid", PR_CASES)
def test_fault_differential_pagerank(data, grid):
    cfgs = _cfgs(use_pallas=grid != "dense", grid_mode=grid)
    part_r, part = _pr_case(data)
    want, wstats = engine.run_pagerank_delta(part, 0.85, 1e-6, cfgs[1],
                                             device=CPU)
    (ra, _, _), (got, stats, report) = _both(
        lambda: (ref_res.PagerankTask(part_r, 0.85, 1e-6, cfgs[0]),
                 resilient.PagerankTask(part, 0.85, 1e-6, cfgs[1],
                                        device=CPU)),
        [dict(round=2, kind="corrupt_tile", shard=1),
         dict(round=4, kind="drop_inbox", shard=0)])
    assert report.status == "recovered"
    assert "corrupt_tile" in {f.kind for f in report.faults}
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(_np(got), _np(ra), rtol=1e-6, atol=1e-9)
    assert int(stats.iterations) == int(wstats.iterations)
    assert int(stats.messages) == int(wstats.messages)


@pytest.mark.parametrize("grid", ["dense", "worklist", "device_worklist"])
def test_fault_differential_lanes(grid):
    cfgs = _cfgs(use_pallas=grid != "dense", grid_mode=grid)
    g, part_r, part, root = _case()
    roots = np.argsort(-g.out_degrees())[:3]
    queries = [("sssp", int(roots[0])), ("bfs", int(roots[1])),
               ("sssp", int(roots[2]))]
    init, unitw = lanes.init_lane_values(part, queries)
    want, wstats = lanes.run_stacked_lanes(part, init, unitw, cfg=cfgs[1],
                                           device=CPU)
    (ra, _, _), (got, stats, report) = _both(
        lambda: (ref_res.LanesTask(part_r, init, unitw, cfgs[0]),
                 resilient.LanesTask(part, init, unitw, cfgs[1],
                                     device=CPU)),
        [dict(round=2, kind="corrupt_tile", shard=3),
         dict(round=3, kind="dup_inbox", shard=1)])
    assert report.status == "recovered"
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got), _np(ra))
    assert int(stats.messages) == int(wstats.messages.sum())


def test_chaos_exhaustive_kinds_single_run():
    """One run surviving the whole fault zoo still lands on the oracle."""
    g, part_r, part, root = _case(scale=8, seed=11)
    init = _sssp_init(part, root)
    cfgs = _cfgs()
    want, wstats = engine.run_stacked(actions.SSSP, part, init, cfgs[1],
                                      device=CPU)
    _, (got, stats, report) = _both(
        _stacked_tasks(part_r, part, init, cfgs),
        [dict(round=2, kind="delay_shard", shard=0, rounds=1),
         dict(round=3, kind="drop_inbox", shard=2),
         dict(round=4, kind="corrupt_tile", shard=1),
         dict(round=5, kind="dup_inbox", shard=3),
         dict(round=6, kind="kill_shard", shard=0)],
        policy=dict(max_retries=2, max_restores=4))
    assert report.status == "recovered"
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _stats(stats)[:2] == _stats(wstats)[:2]


# --------------------------------------------------------------------------
# checkpoint/restore through real managers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grid", ["dense", "device_worklist"])
@pytest.mark.parametrize("checkpoint_every", [1, 3])
def test_checkpointed_restore_exact(checkpoint_every, grid, tmp_path):
    g, part_r, part, root = _case(scale=8, seed=2)
    cfgs = _cfgs(checkpoint_every=checkpoint_every,
                 use_pallas=grid != "dense", grid_mode=grid)
    init = _sssp_init(part, root)
    want, wstats = engine.run_stacked(actions.SSSP, part, init,
                                      engine.EngineConfig(), device=CPU)
    _, (got, stats, report) = _both(
        _stacked_tasks(part_r, part, init, cfgs),
        [dict(round=6, kind="kill_shard", shard=1)],
        managers=(RefManager(str(tmp_path / "ref")),
                  CheckpointManager(str(tmp_path / "port"))))
    assert report.status == "recovered"
    assert report.checkpoints_written > 0
    assert 0 <= report.rounds_lost <= checkpoint_every + \
        chaos.RecoveryPolicy().heartbeat_window
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _stats(stats)[:2] == _stats(wstats)[:2]
    # the port's checkpoints hold the reference's leaves and meta
    steps = CheckpointManager(str(tmp_path / "port")).all_steps()
    assert steps == RefManager(str(tmp_path / "ref")).all_steps()
    mp = json.loads((tmp_path / "port" / f"step_{steps[-1]:010d}"
                     / "manifest.json").read_text())
    mr = json.loads((tmp_path / "ref" / f"step_{steps[-1]:010d}"
                     / "manifest.json").read_text())
    assert mp["meta"] == mr["meta"]
    assert {k: (v["shape"], v["dtype"]) for k, v in mp["leaves"].items()} \
        == {k: (v["shape"], v["dtype"]) for k, v in mr["leaves"].items()}


@pytest.mark.parametrize("task", ["pagerank", "lanes"])
def test_checkpointed_restore_other_tasks(task, tmp_path):
    """``PagerankTask`` and ``LanesTask`` through a real manager: one
    kill, restored from the last checkpoint, equal to the uninterrupted
    run and to the reference's."""
    g, part_r, part, root = _case(seed=8)
    cfgs = _cfgs(checkpoint_every=2)
    if task == "pagerank":
        part_r, part = _pr_case("pr_weights")
        def make():
            return (ref_res.PagerankTask(part_r, 0.85, 1e-6, cfgs[0]),
                    resilient.PagerankTask(part, 0.85, 1e-6, cfgs[1],
                                           device=CPU))
        want, _ = engine.run_pagerank_delta(part, 0.85, 1e-6, device=CPU)
    else:
        roots = np.argsort(-g.out_degrees())[:4]
        init, unitw = lanes.init_lane_values(
            part, [("bfs" if i % 2 else "sssp", int(r))
                   for i, r in enumerate(roots)])

        def make():
            return (ref_res.LanesTask(part_r, init, unitw, cfgs[0]),
                    resilient.LanesTask(part, init, unitw, cfgs[1],
                                        device=CPU))
        want, _ = lanes.run_stacked_lanes(part, init, unitw, device=CPU)
    (ra, _, _), (got, _, report) = _both(
        make, [dict(round=3, kind="kill_shard", shard=1)],
        managers=(RefManager(str(tmp_path / "ref")),
                  CheckpointManager(str(tmp_path / "port"))))
    assert report.status == "recovered" and report.restores == 1
    if task == "pagerank":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(_np(got), _np(ra), rtol=1e-6, atol=1e-9)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(got), _np(ra))


def test_restore_without_manager_uses_round0():
    g, part_r, part, root = _case()
    init = _sssp_init(part, root)
    want, wstats = engine.run_stacked(actions.SSSP, part, init,
                                      engine.EngineConfig(), device=CPU)
    _, (got, stats, report) = _both(
        _stacked_tasks(part_r, part, init, _cfgs()),
        [dict(round=4, kind="corrupt_tile", shard=0)])
    assert report.status == "recovered"
    assert report.rounds_lost >= 3     # all the way back to round 0
    np.testing.assert_array_equal(_np(got), _np(want))
    assert int(stats.messages) == int(wstats.messages)


# --------------------------------------------------------------------------
# graceful degradation + typed raise
# --------------------------------------------------------------------------

def test_degraded_after_budget_exhaustion():
    g, part_r, part, root = _case()
    init = _sssp_init(part, root)
    (ra, _, _), (got, stats, report) = _both(
        _stacked_tasks(part_r, part, init, _cfgs()),
        [dict(round=2, kind="corrupt_tile", shard=0)],
        policy=dict(max_restores=0))
    assert report.status == "degraded"
    assert any(f.action == "degrade" for f in report.faults)
    assert tuple(got.shape) == (part.S, part.R_max)  # partial values
    np.testing.assert_array_equal(_np(got), _np(ra))


def test_degrade_false_raises_typed():
    g, part_r, part, root = _case()
    init = _sssp_init(part, root)
    plan = _plans([dict(round=2, kind="corrupt_tile", shard=0)])[1]
    with pytest.raises(chaos.FaultDetected) as ei:
        resilient.run_resilient(
            resilient.StackedTask(actions.SSSP, part, init, device=CPU),
            chaos=plan,
            policy=chaos.RecoveryPolicy(max_restores=0, degrade=False))
    assert ei.value.kind == "corrupt_tile"


# --------------------------------------------------------------------------
# ChaosPlan semantics (the copied module, held to the reference's)
# --------------------------------------------------------------------------

def test_chaos_plan_random_deterministic():
    a = chaos.ChaosPlan.random(seed=3, n_events=6, max_round=10,
                               num_shards=4)
    b = chaos.ChaosPlan.random(seed=3, n_events=6, max_round=10,
                               num_shards=4)
    assert a.events == b.events
    c = chaos.ChaosPlan.random(seed=4, n_events=6, max_round=10,
                               num_shards=4)
    assert a.events != c.events
    assert all(1 <= e.round <= 10 and 0 <= e.shard < 4 for e in a.events)
    r = ref_chaos.ChaosPlan.random(seed=3, n_events=6, max_round=10,
                                   num_shards=4)
    assert [dataclasses.asdict(e) for e in a.events] \
        == [dataclasses.asdict(e) for e in r.events]


def test_chaos_events_fire_exactly_once():
    plan = chaos.ChaosPlan(events=(chaos.ChaosEvent(
        round=2, kind="drop_inbox", shard=0),))
    evs = plan.events_at(2)
    assert len(evs) == 1
    plan.mark_fired(evs[0])
    assert plan.events_at(2) == []     # a replayed round does not re-fire
    plan.reset()
    assert len(plan.events_at(2)) == 1


def test_unported_sharded_task_raises():
    with pytest.raises(NotImplementedError, match="item 10"):
        resilient.ShardedTask(actions.SSSP, None, None, None)


# --------------------------------------------------------------------------
# shard-pool shrink
# --------------------------------------------------------------------------

def test_shrink_partition_equals_independent_build():
    g, part_r, part, _ = _case(shards=4)
    new_part, new_cfg = resilient.shrink_partition(_pg(g), part.cfg, 3)
    ref_part, _ = ref_res.shrink_partition(g, part_r.cfg, 3)
    indep = build_partition(
        _pg(g), PartitionConfig(num_shards=3, rpvo_max=part.cfg.rpvo_max,
                                seed=part.cfg.seed,
                                indegree_cutoff=part.cfg.indegree_cutoff))
    assert new_cfg.num_shards == 3
    for f in ("slot_vertex", "slot_is_root", "edge_src_root_flat",
              "edge_dst_flat", "edge_mask", "edge_w", "root_flat",
              "num_replicas", "sibling_flat", "sibling_mask"):
        np.testing.assert_array_equal(getattr(new_part, f),
                                      getattr(indep, f), err_msg=f)
        np.testing.assert_array_equal(getattr(new_part, f),
                                      np.asarray(getattr(ref_part, f)),
                                      err_msg=f)


def test_shrink_on_death_reconverges_to_oracle():
    g, part_r, part, root = _case(shards=4)
    init = _sssp_init(part, root)
    want, _ = engine.run_stacked(actions.SSSP, part, init,
                                 engine.EngineConfig(), device=CPU)
    want_vv = engine.vertex_values(part, want)
    holder = {}

    def make():
        tasks = _stacked_tasks(part_r, part, init, _cfgs(), graph=g)()
        holder["port"] = tasks[1]
        return tasks

    (ra, _, _), (got, stats, report) = _both(
        make, [dict(round=3, kind="kill_shard", shard=2)],
        policy=dict(on_dead="shrink"))
    task = holder["port"]
    assert report.status == "recovered"
    assert any(f.action == "shrink" for f in report.faults)
    assert task.part.S == 3            # pool shrank by the dead shard
    np.testing.assert_array_equal(engine.vertex_values(task.part, got),
                                  want_vv)
    np.testing.assert_array_equal(_np(got), _np(ra))


def test_migrate_values_consistent_view():
    g, part_r, part, root = _case(shards=4)
    init = _sssp_init(part, root)
    done, _ = engine.run_stacked(actions.SSSP, part, init,
                                 engine.EngineConfig(), device=CPU)
    new_part, _ = resilient.shrink_partition(_pg(g), part.cfg, 3)
    mig = resilient.migrate_values(part, done, new_part, actions.SSSP)
    sv = np.asarray(new_part.slot_vertex)
    vv = engine.vertex_values(part, done)
    np.testing.assert_array_equal(mig[sv >= 0], vv[sv[sv >= 0]])
    assert (mig[sv < 0] == np.float32(np.inf)).all()
    ref_new, _ = ref_res.shrink_partition(g, part_r.cfg, 3)
    np.testing.assert_array_equal(
        mig, ref_res.migrate_values(part_r, _np(done), ref_new,
                                    ref_actions.SSSP))


def test_shard_crcs_match_reference():
    rng = np.random.default_rng(1)
    tables = [rng.standard_normal((4, 9)).astype(np.float32),
              rng.random((4, 9, 3)) > 0.5]
    got = resilient.shard_crcs([torch.as_tensor(t) for t in tables])
    assert got == ref_res.shard_crcs(tables)
    changed = [tables[0].copy(), tables[1]]
    changed[0][2, 5] += 1.0
    assert resilient._scrub_mismatch(got, resilient.shard_crcs(changed)) \
        == (0, 2)
    assert resilient._scrub_mismatch(got, got) is None


# --------------------------------------------------------------------------
# recovered rounds still satisfy the planner mirror and kernel counters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grid_mode", ["dense", "worklist"])
def test_records_after_recovery_match_mirrors(grid_mode):
    g, part_r, part, root = _case()
    cfgs = _cfgs(use_pallas=True, grid_mode=grid_mode)
    init = _sssp_init(part, root)
    want, _ = engine.run_stacked(actions.SSSP, part, init, cfgs[1],
                                 device=CPU)
    events = [dict(round=3, kind="corrupt_tile", shard=1)]
    with ref_obs.recording(keep_frontiers=True) as ref_rec:
        ref_res.run_resilient(
            ref_res.StackedTask(ref_actions.SSSP, part_r, init, cfgs[0]),
            chaos=_plans(events)[0])
    with obs.recording(keep_frontiers=True) as rec:
        got, _, report = resilient.run_resilient(
            resilient.StackedTask(actions.SSSP, part, init, cfgs[1],
                                  device=CPU), chaos=_plans(events)[1])
    assert report.status == "recovered"
    np.testing.assert_array_equal(_np(got), _np(want))
    fields = ("run", "round", "frontier", "messages", "work", "pruned",
              "grid", "cells", "shard_messages")
    assert [[getattr(r, f) for f in fields] for r in rec.rounds] \
        == [[getattr(r, f) for f in fields] for r in ref_rec.rounds]
    planner = engine.launch_planner(part, cfgs[1])
    total = part.S * part.R_max
    gval = np.random.default_rng(0).uniform(0, 5, total).astype(np.float32)
    for r, gchg in zip(rec.rounds, rec.frontiers):
        shard = exchange.shard_message_mirror(
            part.edge_mask, part.edge_src_root_flat, gchg)
        assert r.shard_messages == [int(x) for x in shard]
        mirror = fused_grid_cells(part.edge_dst_flat, part.edge_mask,
                                  part.edge_src_root_flat, gchg, total,
                                  grid_mode=grid_mode)
        wl = None
        if r.grid == "worklist":
            wl, info = engine.plan_round_worklist(planner, cfgs[1], gchg,
                                                  with_info=True)
            assert (r.cells, r.launched) == (info.cells, info.launched)
            assert r.cells == mirror["wl_cells"]
        else:
            assert r.cells == mirror["fused_live"]
        _, dbg = fused_relax_reduce_pallas(
            gval, gchg, part.edge_src_root_flat.reshape(-1),
            part.edge_w.reshape(-1), part.edge_mask.reshape(-1),
            part.edge_dst_flat.reshape(-1), total, "add_w", "min",
            worklist=wl, with_debug=True, device=CPU)
        assert int(dbg[0]) == r.cells


# --------------------------------------------------------------------------
# elastic state machines (the copied module, held to the reference's)
# --------------------------------------------------------------------------

def _elastic_trace(mod):
    """One scripted pass over every elastic state machine; returns what
    each observable said, for the two packages to be compared."""
    out = {"viable": mod.viable_mesh_shapes(n_hosts=128, devices_per_host=4,
                                            model_axis=16),
           "viable8": mod.viable_mesh_shapes(n_hosts=8, devices_per_host=1,
                                             model_axis=2),
           "viable3": mod.viable_mesh_shapes(n_hosts=3, devices_per_host=1,
                                             model_axis=2)}
    c = mod.ElasticCoordinator(n_hosts=128, devices_per_host=4,
                               model_axis=16)
    ticks = []
    for step in range(8):
        for h in range(128):
            if h != 17 or step < 2:
                c.heartbeat(h, step)
        ticks.append(c.tick(step))
    out.update(ticks=ticks, alive17=c.hosts[17].alive,
               shape=c.current_mesh_shape())
    c3 = mod.ElasticCoordinator(n_hosts=3, devices_per_host=1,
                                model_axis=16)
    c3.kill_host(2)
    out["degraded_shape"] = c3.current_mesh_shape()
    cw = mod.ElasticCoordinator(n_hosts=2, devices_per_host=1,
                                model_axis=1, heartbeat_window=3)
    cw.heartbeat(0, 0)
    cw.heartbeat(1, 0)
    window = []
    for step in (1, 2, 3, 4):
        cw.heartbeat(0, step)
        window.append((cw.tick(step), cw.hosts[1].alive))
    cw.revive(1, 5)
    window.append((cw.tick(5), cw.hosts[1].alive))
    out.update(window=window, remesh=cw.remesh_events[-1]["died"])
    m = mod.StragglerMonitor(threshold=1.5, patience=3)
    classes = []
    for step in range(4):
        for h in range(8):
            m.record(h, 1.0 if h != 3 else 3.0)
        classes.append(m.classify())
    m2 = mod.StragglerMonitor(alpha=0.3)
    for x in (2.0, 4.0, 1.0):
        m2.record(0, x)
    m3 = mod.StragglerMonitor(threshold=1.5, patience=3, alpha=1.0)
    for h in range(4):
        m3.record(h, 1.0 if h != 1 else 5.0)
    recovery = [m3.classify()]
    for _ in range(3):
        for h in range(4):
            m3.record(h, 1.0)           # host 1 recovers
        recovery.append(m3.classify())
    out.update(classes=classes, ewma=m2.hosts[0].ewma_step_s,
               recovery=recovery)
    pool = mod.ShardPool(4, window=2)
    pool.heartbeat_all(0)
    deaths = [pool.tick(0)]
    for r in (1, 2, 3):
        pool.heartbeat_all(r, except_shards=(1, 3))
        deaths.append(pool.tick(r))
    pool.revive(1, 4)
    dead_after = pool.dead()
    pool.revive_all(4)
    pool2 = mod.ShardPool(4, window=3)
    pool2.heartbeat_all(0)
    delayed = []
    for r in range(1, 8):
        pool2.heartbeat_all(r, except_shards=(2,) if r in (3, 4) else ())
        delayed.append(pool2.tick(r))
    out.update(deaths=deaths, dead_after=dead_after, alive=pool.alive(),
               delayed=delayed, alive2=pool2.alive())
    return out


def test_elastic_state_machines_match_reference():
    got = _elastic_trace(elastic)
    assert got == _elastic_trace(ref_elastic)
    assert (2, 16, 16) in got["viable"]
    assert set(got["viable8"]) == {(2, 2, 2), (1, 4, 2)}
    assert got["viable3"] == []
    sizes = [a * b * c for a, b, c in got["viable"]]
    assert sizes == sorted(sizes, reverse=True)
    assert any(got["ticks"]) and not got["alive17"]
    assert int(np.prod(got["shape"])) % 16 == 0
    assert int(np.prod(got["degraded_shape"])) == 2
    assert got["window"] == [(False, True)] * 3 + [(True, False),
                                                   (False, True)]
    assert 3 in got["classes"][-1]["evict"]
    assert got["recovery"][-1] == {"bypass": [], "evict": []}
    assert got["ewma"] == pytest.approx(0.3 * 1.0 + 0.7 * (0.3 * 4.0
                                                            + 0.7 * 2.0))
    assert got["deaths"] == [[], [], [], [1, 3]]
    assert got["dead_after"] == [3] and got["alive"] == [0, 1, 2, 3]
    assert got["delayed"] == [[]] * 7 and got["alive2"] == [0, 1, 2, 3]


# --------------------------------------------------------------------------
# serving: kill-and-restore a QueryServer mid-flight, real managers
# --------------------------------------------------------------------------

def _serving_case():
    g = ref_generators.rmat(7, edge_factor=5, seed=5).with_random_weights(
        seed=5)
    part_r = ref_build(g, RefPCfg(num_shards=4, rpvo_max=2))
    roots = [int(r) for r in np.argsort(-g.out_degrees())[:4]]
    return g, part_r, interop.partition_from_dict(
        dataclasses.asdict(part_r)), roots


@pytest.mark.parametrize("grid", ["dense", "device_worklist"])
def test_server_kill_and_restore_bit_identical(grid, tmp_path):
    g, part_r, part, roots = _serving_case()
    cfgs = _cfgs(use_pallas=grid != "dense", grid_mode=grid)

    def submit_all(srv):
        return [srv.submit("bfs", roots[0]),
                srv.submit("sssp", roots[1]),
                srv.submit("sssp", roots[2]),
                srv.submit("bfs", roots[3])]

    oracle = QueryServer(part, n_lanes=2, cfg=cfgs[1], device=CPU)
    oq = submit_all(oracle)
    ores = oracle.run()
    results = []
    for side in SIDES:
        d = str(tmp_path / side)
        if side == "reference":
            srv = RefQueryServer(part_r, n_lanes=2, cfg=cfgs[0],
                                 serve=RefServeConfig(checkpoint_every=2))
            mgr = RefManager
        else:
            srv = QueryServer(part, n_lanes=2, cfg=cfgs[1],
                              serve=ServeConfig(checkpoint_every=2),
                              device=CPU)
            mgr = CheckpointManager
        qs = submit_all(srv)
        writer = mgr(d)
        srv.attach_checkpoints(writer)
        for _ in range(4):             # crash mid-flight, past a snapshot
            srv.step()
        assert srv.results.keys() != set(qs)
        # the crash comes once the tick-4 snapshot is on disk, so both
        # packages restore the same tick (an async write still in flight
        # would leave the tick-2 one as the latest)
        writer.wait()
        del srv                        # crash
        if side == "reference":
            srv2 = RefQueryServer.restore(
                part_r, mgr(d), cfg=cfgs[0],
                serve=RefServeConfig(checkpoint_every=2))
        else:
            srv2 = QueryServer.restore(
                part, mgr(d), cfg=cfgs[1],
                serve=ServeConfig(checkpoint_every=2), device=CPU)
        results.append((qs, srv2.run()))
    (rq, rres), (qs, res) = results
    assert set(res) == set(qs)
    for q, oq_, rq_ in zip(qs, oq, rq):
        o, r, a = ores[oq_], res[q], rres[rq_]
        np.testing.assert_array_equal(r.values, o.values)
        np.testing.assert_array_equal(r.values, np.asarray(a.values))
        assert (r.rounds, r.messages, r.status) \
            == (o.rounds, o.messages, r.status)
        assert (r.rounds, r.messages, r.status) \
            == (a.rounds, a.messages, a.status)
    statuses = {res[q].status for q in qs}
    assert QueryStatus.RECOVERED in statuses
    assert statuses <= {QueryStatus.OK, QueryStatus.RECOVERED}


def test_server_restore_without_checkpoint_raises(tmp_path):
    _, _, part, _ = _serving_case()
    with pytest.raises(FileNotFoundError):
        QueryServer.restore(part, CheckpointManager(str(tmp_path)),
                            device=CPU)


def test_server_degrade_in_flight():
    _, _, part, roots = _serving_case()
    srv = QueryServer(part, n_lanes=1, device=CPU)
    q0 = srv.submit("sssp", roots[0])
    q1 = srv.submit("sssp", roots[1])   # queued behind the single lane
    srv.step()
    hit = srv.degrade_in_flight()
    assert set(hit) == {q0, q1}
    assert srv.results[q0].status == QueryStatus.DEGRADED
    assert srv.results[q0].values is not None          # partial values
    assert srv.results[q1].status == QueryStatus.DEGRADED
    assert srv.results[q1].values is None
    q2 = srv.submit("bfs", roots[2])
    assert srv.run()[q2].status == QueryStatus.OK


# --------------------------------------------------------------------------
# streaming: WAL replay, across the two packages
# --------------------------------------------------------------------------

def _stream_case():
    g = ref_generators.rmat(7, edge_factor=5, seed=3)
    kw = dict(num_shards=4, rpvo_max=2)
    return g, kw


def _stream_batch(g, seed=7, k=40):
    rng = np.random.default_rng(seed)
    ins = (rng.integers(0, g.n, k).astype(np.int32),
           rng.integers(0, g.n, k).astype(np.int32),
           (rng.random(k) + 0.1).astype(np.float32))
    dels = (np.asarray(g.src)[:10].copy(), np.asarray(g.dst)[:10].copy())
    return ins, dels


def _make_stream(side, g, kw, **extra):
    if side == "reference":
        sg = RefStreamingGraph(g, RefPCfg(**kw), **extra)
    else:
        sg = StreamingGraph(_pg(g), PartitionConfig(**kw), device=CPU,
                            **extra)
    return sg


def _track_three(sg):
    sg.track("bfs", 0)
    sg.track("sssp", 1)
    sg.track("pagerank")
    return sg


def _commit_info(info):
    return {"inserted": info.inserted, "deleted": info.deleted,
            "mutated_src": np.asarray(info.mutated_src).tolist(),
            "mutated_dst": np.asarray(info.mutated_dst).tolist(),
            "splices": {k: dataclasses.asdict(v)
                        for k, v in info.splices.items()},
            "maint": _maint(info), "replicas_added": info.replicas_added}


def _maint(info):
    return {k: dataclasses.asdict(v) for k, v in info.maint.items()}


@pytest.mark.parametrize("writer,reader", [
    ("reference", "port"), ("port", "reference"), ("port", "port")])
def test_streaming_wal_crash_mid_commit_exact(writer, reader, tmp_path):
    """A StreamingGraph checkpointed with a buffered batch in its WAL
    (the crash-mid-commit case) is restored by ``reader``'s package and
    committed: its maintained values equal the writer package's own
    uninterrupted commit (min bit for bit, PageRank within tolerance)
    and ``MaintStats`` are equal."""
    g, kw = _stream_case()
    ins, dels = _stream_batch(g)
    oracle = _track_three(_make_stream(writer, g, kw))
    oracle.insert_edges(*ins)
    oracle.delete_edges(*dels)
    want = oracle.commit()

    sg = _track_three(_make_stream(writer, g, kw))
    sg.insert_edges(*ins)
    sg.delete_edges(*dels)
    mgr = (RefManager if writer == "reference" else CheckpointManager)(
        str(tmp_path))
    sg.save_checkpoint(mgr, blocking=True)   # WAL holds the batch
    del sg                                   # crash mid-commit

    rmgr = (RefManager if reader == "reference" else CheckpointManager)(
        str(tmp_path))
    cls = RefStreamingGraph if reader == "reference" else StreamingGraph
    extra = {} if reader == "reference" else {"device": CPU}
    sg2 = cls.restore(rmgr, **extra)
    assert sg2._pending_ins and sg2._pending_del
    got = sg2.commit()                       # replay the WAL
    assert _maint(got) == _maint(want)
    # a restored graph makes its other views on first use, after the
    # replayed splice: the base view's splice is the one both made
    assert dataclasses.asdict(got.splices["base"]) \
        == dataclasses.asdict(want.splices["base"])
    if writer != reader:
        # the writer's package replays the same checkpoint: the two
        # replays' CommitInfo are equal field for field
        wmgr = (RefManager if writer == "reference" else CheckpointManager)(
            str(tmp_path))
        wcls = RefStreamingGraph if writer == "reference" \
            else StreamingGraph
        wextra = {} if writer == "reference" else {"device": CPU}
        own = wcls.restore(wmgr, **wextra).commit()
        assert _commit_info(got) == _commit_info(own)
    for k in oracle.tracked:
        a = np.asarray(oracle.tracked[k]["vals"])
        b = np.asarray(sg2.tracked[k]["vals"])
        if k[0] == "pagerank":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7)
        else:
            np.testing.assert_array_equal(b, a, err_msg=str(k))


def test_streaming_checkpoint_roundtrip_post_commit(tmp_path):
    g, kw = _stream_case()
    ins, dels = _stream_batch(g)
    sg = _make_stream("port", g, kw)
    sg.track("sssp", 0)
    sg.insert_edges(*ins)
    sg.delete_edges(*dels)
    sg.commit()
    mgr = CheckpointManager(str(tmp_path))
    sg.save_checkpoint(mgr, blocking=True)
    sg2 = StreamingGraph.restore(mgr, device=CPU)
    assert sg2._commits == sg._commits
    assert not sg2._pending_ins and not sg2._pending_del
    np.testing.assert_array_equal(sg.tracked[("sssp", 0)]["vals"],
                                  sg2.tracked[("sssp", 0)]["vals"])
    more = _stream_batch(g, seed=9, k=8)[0]
    for s in (sg, sg2):
        s.insert_edges(*more)
        s.commit()
    np.testing.assert_array_equal(sg.tracked[("sssp", 0)]["vals"],
                                  sg2.tracked[("sssp", 0)]["vals"])


def test_streaming_staleness_slo_auto_refresh():
    g, kw = _stream_case()
    ins, _ = _stream_batch(g, k=20)
    more, _ = _stream_batch(g, seed=8, k=10)
    runs = []
    for side in SIDES:
        sg = _make_stream(side, g, kw, staleness_slo=25.0)
        sg.track("bfs", 0)
        sg.insert_edges(*ins)              # 20 <= 25: stays buffered
        assert sg.auto_refreshes == 0 and sg._pending_ins
        sg.insert_edges(*more)             # 30 > 25: auto-commit
        assert sg.auto_refreshes == 1
        assert not sg._pending_ins and sg.staleness() == 0.0
        runs.append(np.asarray(sg.tracked[("bfs", 0)]["vals"]))
    eager = _make_stream("port", g, kw)
    eager.track("bfs", 0)
    eager.insert_edges(*ins)
    eager.insert_edges(*more)
    eager.commit()
    np.testing.assert_array_equal(runs[1], eager.tracked[("bfs", 0)]["vals"])
    np.testing.assert_array_equal(runs[1], runs[0])


def test_streaming_staleness_pr_mass_metric():
    g, kw = _stream_case()
    ins, _ = _stream_batch(g, k=15)
    got = []
    for side in SIDES:
        sg = _make_stream(side, g, kw, staleness_slo=1e9,
                          staleness_metric="pr_mass")
        sg.track("pagerank")
        sg.insert_edges(*ins)
        got.append(sg.staleness())
    p = np.asarray(sg.tracked[("pagerank", None)]["vals"])
    d = sg.tracked[("pagerank", None)]["damping"]
    assert got[1] == pytest.approx(float(d * p[np.unique(ins[0])].sum()))
    assert got[1] == pytest.approx(got[0], rel=1e-5)
    with pytest.raises(ValueError):
        StreamingGraph(_pg(g), PartitionConfig(**kw), staleness_slo=1.0,
                       staleness_metric="nope", device=CPU)


# --------------------------------------------------------------------------
# the counter gate's resilient_kill_restore leg
# --------------------------------------------------------------------------

def test_counter_gate_resilient_leg():
    """``resilient_kill_restore`` of ``counter_gate.json`` exactly, run by
    the code ``chip_smoke.py`` phase 3 runs on the card."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    gate = json.loads(chip_smoke.GATE.read_text())
    got = chip_smoke.resilient_gate_leg(np, CPU, gate)
    assert got == {"resilient_kill_restore":
                   gate["runs"]["resilient_kill_restore"]}
