"""Resident device tables (``engine.device_arrays``): a partition's
static tables and launch plan are uploaded once per device and reused by
every later call on it, with the same values, ``RunStats`` and counters
as a cold call; a new partition gets its own; the tables go with their
partition.

No JAX here: these check the port against itself.
"""
import copy
import gc
import pickle
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import apps, obs  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.partition import (  # noqa: E402
    PartitionConfig, build_partition, splice_partition,
)
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph.graph import COOGraph  # noqa: E402
from repro_torch.query import lanes  # noqa: E402

CPU = "cpu"
PCFG = PartitionConfig(num_shards=4, rpvo_max=4)
TABLES = "engine_device_tables_total"
COUNTERS = (TABLES, "engine_host_syncs_total", "engine_dispatches_total")


@pytest.fixture(scope="module")
def graph():
    g = generators.rmat(8, edge_factor=8, seed=7).with_random_weights(seed=7)
    root = int(np.argmax(g.out_degrees()))
    return g, root, build_partition(g, PCFG)


def _counters():
    snap = obs.registry().snapshot()
    return {(name, key): val for name in COUNTERS
            for key, val in snap.get(name, {"series": {}})["series"].items()}


def _delta(before, name=None):
    after = _counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0) and (name is None or k[0] == name)}


def _tables(delta):
    return {dict(key)["result"]: n for (name, key), n in delta.items()
            if name == TABLES}


def _cfg(grid_mode="dense"):
    return engine.EngineConfig(use_pallas=True, grid_mode=grid_mode)


def _search(app, grid_mode):
    def work(g, root, part):
        out, stats, _ = getattr(apps, app)(g, root, part=part, device=CPU,
                                           cfg=_cfg(grid_mode))
        return out, [int(x) for x in stats]
    return work


def _pagerank(g, root, part):
    return apps.pagerank(g, iters=5, part=part, device=CPU, cfg=_cfg())[0]


def _pagerank_delta(grid_mode):
    def work(g, root, part):
        out, stats, _ = apps.pagerank_delta(g, tol=1e-6, part=part,
                                            device=CPU, cfg=_cfg(grid_mode))
        return out, [int(x) for x in stats]
    return work


def _lanes(g, root, part):
    srcs = np.argsort(-g.out_degrees())[:4]
    init, unitw = lanes.init_lane_values(
        part, [(("bfs", "sssp")[i % 2], int(v)) for i, v in enumerate(srcs)])
    val, st = lanes.run_stacked_lanes(part, init, unitw,
                                      _cfg("device_worklist"), device=CPU)
    return val.numpy(), [x.numpy() for x in st]


def _ppr(g, root, part):
    val, st = lanes.run_ppr_lanes(part, [root, 0], 0.85, _cfg(), device=CPU)
    return val.numpy(), [x.numpy() for x in st]


def _ppr_delta(g, root, part):
    val, st = lanes.run_ppr_delta_lanes(part, [root, 0], 0.85, _cfg(),
                                        device=CPU)
    return val.numpy(), [x.numpy() for x in st]


WORK = {
    "bfs-dense": _search("bfs", "dense"),
    "bfs-device_worklist": _search("bfs", "device_worklist"),
    "sssp-dense": _search("sssp", "dense"),
    "sssp-worklist": _search("sssp", "worklist"),
    "pagerank": _pagerank,
    "pagerank_delta-dense": _pagerank_delta("dense"),
    "pagerank_delta-device_worklist": _pagerank_delta("device_worklist"),
    "lanes": _lanes,
    "ppr_lanes": _ppr,
    "ppr_delta_lanes": _ppr_delta,
}


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(WORK))
def test_second_call_hits_and_equals_a_cold_call(graph, case):
    """Two calls on one partition upload once and hit once; the warm
    call's values, stats and sync/dispatch counts equal a cold call's."""
    work, part = WORK[case], graph[2]
    engine.drop_device_arrays(part)
    c0 = _counters()
    first = work(*graph)
    c1 = _counters()
    warm = work(*graph)
    warm_counts = _delta(c1)
    assert _tables(_delta(c0)) == {"upload": 1, "hit": 1}
    engine.drop_device_arrays(part)
    c2 = _counters()
    cold = work(*graph)
    cold_counts = _delta(c2)
    assert _tables(cold_counts) == {"upload": 1}
    assert _tables(warm_counts) == {"hit": 1}
    drop = lambda d: {k: v for k, v in d.items() if k[0] != TABLES}  # noqa: E731,E501
    assert drop(warm_counts) == drop(cold_counts)
    _same(warm, cold)
    _same(first, cold)


def test_spliced_partition_gets_its_own_tables(graph):
    """``splice_partition`` after an edge insert makes a new partition,
    which uploads tables of its own; its BFS equals a fresh build's."""
    g, root, part = graph
    leaf = int(np.argmin(g.out_degrees()))
    src, dst = np.array([root], np.int32), np.array([leaf], np.int32)
    g2 = COOGraph(g.n, np.concatenate([g.src, src]),
                  np.concatenate([g.dst, dst]),
                  np.concatenate([g.weight, np.ones(1, np.float32)]))
    apps.bfs(g, root, part=part, device=CPU, cfg=_cfg())
    old = engine.device_arrays(part, CPU)
    new_part, _ = splice_partition(part, g2, part.cfg, src, dst)
    c0 = _counters()
    got, stats, _ = apps.bfs(g2, root, part=new_part, device=CPU,
                             cfg=_cfg())
    assert _tables(_delta(c0)) == {"upload": 1}
    assert engine.device_arrays(new_part, CPU) is not old
    assert engine.device_arrays(part, CPU) is old
    want, want_stats, _ = apps.bfs(g2, root, part=build_partition(g2, PCFG),
                                   device=CPU, cfg=_cfg())
    np.testing.assert_array_equal(got, want)
    assert [int(x) for x in stats] == [int(x) for x in want_stats]


def test_tables_go_with_their_partition(graph):
    g, root, _ = graph
    part = build_partition(g, PCFG)
    apps.sssp(g, root, part=part, device=CPU, cfg=_cfg())
    arrays = engine.device_arrays(part, CPU)
    tables = [weakref.ref(arrays.edge_w), weakref.ref(arrays.slot_valid),
              weakref.ref(arrays.fused_plan.blk_ptr)]
    del arrays, part
    gc.collect()
    assert all(t() is None for t in tables)


def test_drop_frees_the_tables_without_a_collection(graph):
    g, root, part = graph
    arrays = engine.device_arrays(part, CPU)
    valid = weakref.ref(arrays.slot_valid)
    del arrays
    engine.drop_device_arrays(part)
    assert valid() is None
    c0 = _counters()
    engine.device_arrays(part, CPU)
    assert _tables(_delta(c0)) == {"upload": 1}


def test_explicit_arrays_bypass_the_cache(graph):
    g, root, part = graph
    engine.drop_device_arrays(part)
    mine = engine.DeviceArrays.from_partition(part, CPU)
    init = engine.init_values(part, actions.BFS, {root: 0.0})
    c0 = _counters()
    val, _ = engine.run_stacked(actions.BFS, part, init, _cfg(), device=CPU,
                                arrays=mine)
    rank, _ = engine.run_pagerank_delta(part, cfg=_cfg(), device=CPU,
                                        arrays=mine)
    lanes.make_ppr_round(part, _cfg(), mine)
    assert _delta(c0, TABLES) == {}
    resident = engine.device_arrays(part, CPU)
    assert resident is not mine
    assert _tables(_delta(c0)) == {"upload": 1}


def test_device_names_share_one_entry(graph):
    g, root, part = graph
    a = engine.device_arrays(part, "cpu")
    assert engine.device_arrays(part, torch.device("cpu", 0)) is a
    assert engine.device_arrays(part, torch.device("cpu")) is a


def test_copies_of_a_partition_carry_no_tables(graph):
    """A pickled or deep-copied partition uploads its own tables: the
    copy carries none."""
    g, root, part = graph
    arrays = engine.device_arrays(part, CPU)
    for twin in (pickle.loads(pickle.dumps(part)), copy.deepcopy(part)):
        c0 = _counters()
        assert engine.device_arrays(twin, CPU) is not arrays
        assert _tables(_delta(c0)) == {"upload": 1}
    assert engine.device_arrays(part, CPU) is arrays


def test_entry_without_device_needs_cuda(monkeypatch, graph):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.device_arrays(graph[2])
