"""Port PageRank and delta-PageRank against the reference's, on the very
same partition.

Scores agree within rtol 1e-4 / atol 1e-7 — the tolerance the
reference's own delta-PageRank test holds against the numpy oracle; the
two packages sum in different orders — and delta-PageRank's ``RunStats``
are exactly equal under every grid mode: the residual frontier
``|delta| > tol`` is the same slot for slot.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps.pagerank import _pr_graph as ref_pr_graph  # noqa: E402
from repro.apps.pagerank import pagerank as ref_pr  # noqa: E402
from repro.apps.pagerank import pagerank_delta as ref_pr_delta  # noqa: E402,E501
from repro import apps as ref_apps  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro_torch import apps, interop, obs  # noqa: E402
from repro_torch.apps.pagerank import _pr_graph  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.graph import generators, reference  # noqa: E402

RTOL, ATOL = 1e-4, 1e-7

GRAPHS = {
    "rmat8": lambda m: m.rmat(8, edge_factor=6, seed=3),
    "ba_hub": lambda m: m.ba_skewed(300, m_per=4, seed=0),
}


def _both(name, shards=8, rpvo=4):
    g_ref = GRAPHS[name](ref_generators)
    g = GRAPHS[name](generators)
    part_ref = ref_partition.build_partition(
        ref_pr_graph(g_ref),
        ref_partition.PartitionConfig(num_shards=shards, rpvo_max=rpvo))
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    return g_ref, g, part_ref, part


def _stats(stats):
    return [int(x) for x in stats]


def test_pr_graph_matches_reference():
    g_ref, g, _, _ = _both("rmat8")
    want, got = ref_pr_graph(g_ref), _pr_graph(g)
    np.testing.assert_array_equal(got.src, want.src)
    np.testing.assert_array_equal(got.dst, want.dst)
    np.testing.assert_array_equal(got.weight, want.weight)


@pytest.mark.parametrize("grid_mode", ["dense", "device_worklist"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_pagerank_matches_reference(graph, use_pallas, grid_mode):
    g_ref, g, part_ref, part = _both(graph)
    kw = dict(use_pallas=use_pallas, grid_mode=grid_mode)
    want, _ = ref_pr(g_ref, iters=30, part=part_ref,
                     cfg=ref_engine.EngineConfig(**kw))
    got, _ = apps.pagerank(g, iters=30, part=part,
                           cfg=engine.EngineConfig(**kw), device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, reference.pagerank(g, 0.85, 30),
                               rtol=RTOL, atol=ATOL)


def test_pagerank_builds_its_own_partition():
    g = GRAPHS["rmat8"](generators)
    got, part = apps.pagerank(g, iters=10, num_shards=4, rpvo_max=4,
                              device="cpu")
    assert part.S == 4
    np.testing.assert_allclose(got, reference.pagerank(g, 0.85, 10),
                               rtol=RTOL, atol=ATOL)


DELTA_CFGS = [dict(), dict(use_pallas=True),
              dict(use_pallas=True, grid_mode="worklist"),
              dict(use_pallas=True, grid_mode="auto"),
              dict(use_pallas=True, grid_mode="device_worklist"),
              dict(use_pallas=True, grid_mode="device_worklist",
                   device_window=3)]


@pytest.mark.parametrize("kw", DELTA_CFGS,
                         ids=lambda kw: "-".join(map(str, kw.values()))
                         or "plain")
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_pagerank_delta_matches_reference(graph, kw):
    g_ref, g, part_ref, part = _both(graph)
    want, want_stats, _ = ref_pr_delta(
        g_ref, tol=1e-9, part=part_ref, cfg=ref_engine.EngineConfig(**kw),
        max_rounds=400)
    got, stats, _ = apps.pagerank_delta(
        g, tol=1e-9, part=part, cfg=engine.EngineConfig(**kw),
        max_rounds=400, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, reference.pagerank(g, 0.85, 200),
                               rtol=RTOL, atol=ATOL)
    assert _stats(stats) == _stats(want_stats)
    assert int(stats.pruned_actions) > 0


@pytest.mark.parametrize("grid_mode", ["dense", "auto", "device_worklist"])
def test_pagerank_delta_per_vertex_tol(grid_mode):
    g_ref, g, part_ref, part = _both("rmat8")
    tol = np.full(g.n, 1e-7, np.float32)
    tol[g.n // 2:] = 1e-3
    kw = dict(use_pallas=True, grid_mode=grid_mode)
    want, want_stats, _ = ref_pr_delta(
        g_ref, tol=tol, part=part_ref, cfg=ref_engine.EngineConfig(**kw))
    got, stats, _ = apps.pagerank_delta(
        g, tol=tol, part=part, cfg=engine.EngineConfig(**kw), device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _stats(stats) == _stats(want_stats)
    with pytest.raises(ValueError, match="per-vertex tol"):
        engine.run_pagerank_delta(part, tol=tol[:-1], device="cpu")


@pytest.mark.parametrize("grid_mode", ["worklist", "device_worklist"])
@pytest.mark.parametrize("max_rounds", [1, 5])
def test_pagerank_delta_round_cap(max_rounds, grid_mode):
    g_ref, g, part_ref, part = _both("rmat8")
    kw = dict(use_pallas=True, grid_mode=grid_mode, device_window=4)
    want, want_stats, _ = ref_pr_delta(
        g_ref, tol=1e-9, part=part_ref, cfg=ref_engine.EngineConfig(**kw),
        max_rounds=max_rounds)
    got, stats, _ = apps.pagerank_delta(
        g, tol=1e-9, part=part, cfg=engine.EngineConfig(**kw),
        max_rounds=max_rounds, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _stats(stats) == _stats(want_stats)
    assert int(stats.iterations) == max_rounds


def test_pagerank_delta_warm_start_matches_reference():
    """``init_rank`` / ``init_delta`` seed the accumulation (negative
    residuals diffuse too: the frontier tests ``|delta|``)."""
    _, _, part_ref, part = _both("rmat8")
    rng = np.random.default_rng(4)
    rank0 = rng.uniform(0, 1e-2, (part.S, part.R_max)).astype(np.float32)
    delta0 = rng.uniform(-1e-4, 1e-4, rank0.shape).astype(np.float32)
    valid = part.slot_vertex >= 0
    rank0, delta0 = rank0 * valid, delta0 * valid
    kw = dict(use_pallas=True, grid_mode="auto")
    want, want_stats = ref_engine.run_pagerank_delta(
        part_ref, tol=1e-8, cfg=ref_engine.EngineConfig(**kw),
        init_rank=rank0, init_delta=delta0)
    got, stats = engine.run_pagerank_delta(
        part, tol=1e-8, cfg=engine.EngineConfig(**kw), init_rank=rank0,
        init_delta=delta0, device="cpu")
    np.testing.assert_allclose(interop.table_to_numpy(got),
                               np.asarray(want), rtol=RTOL, atol=ATOL)
    assert _stats(stats) == _stats(want_stats)


@pytest.mark.parametrize("window", [2, 8])
def test_pagerank_delta_recorder_windows(window):
    """Per-window records under 'device_worklist' add up to the host
    loop's per-round records; the reference records the same windows."""
    g_ref, g, part_ref, part = _both("rmat8")
    rows = {}
    for label, grid, mod, p in (
            ("host", "dense", engine, part),
            ("dev", "device_worklist", engine, part),
            ("ref_dev", "device_worklist", ref_engine, part_ref)):
        rec_mod = obs if mod is engine else ref_obs
        kw = {"device": "cpu"} if mod is engine else {}
        with rec_mod.recording() as rec:
            mod.run_pagerank_delta(
                p, tol=1e-6, max_rounds=50,
                cfg=mod.EngineConfig(use_pallas=True, grid_mode=grid,
                                     device_window=window), **kw)
        rs = [r for r in rec.rounds if r.run == "pagerank_delta"]
        rows[label] = {
            "records": len(rs),
            "messages": sum(r.messages for r in rs),
            "work": sum(r.work for r in rs),
            "pruned": sum(r.pruned for r in rs),
            "cells": sum(r.cells for r in rs),
            "shard_messages": [sum(c) for c in zip(
                *(r.shard_messages for r in rs))],
            "windows": [r.window for r in rs]}
    host, dev, ref_dev = rows["host"], rows["dev"], rows["ref_dev"]
    assert dev == ref_dev
    assert dev["records"] == -(-host["records"] // window)
    for k in ("messages", "work", "pruned", "cells", "shard_messages"):
        assert dev[k] == host[k]


def test_pagerank_delta_counts_windows():
    _, g, _, part = _both("rmat8")
    reg = obs.registry()
    disp = reg.counter("engine_dispatches_total").labels(run="pagerank_delta")
    syncs = reg.counter("engine_host_syncs_total").labels(
        run="pagerank_delta")
    d0, s0 = disp.value, syncs.value
    _, stats, _ = apps.pagerank_delta(
        g, tol=1e-6, part=part, device="cpu",
        cfg=engine.EngineConfig(use_pallas=True,
                                grid_mode="device_worklist"))
    windows = -(-int(stats.iterations) // 8)
    assert disp.value - d0 == windows and syncs.value - s0 == windows
    d0, s0 = disp.value, syncs.value
    _, stats, _ = apps.pagerank_delta(g, tol=1e-6, part=part, device="cpu")
    it = int(stats.iterations)
    assert disp.value - d0 == it and syncs.value - s0 == it + 1


@pytest.mark.parametrize("fn", ["pagerank", "pagerank_delta"])
def test_mesh_names_its_roadmap_item(fn):
    """``mesh=`` (ROADMAP Queue 1 item 10, ported): on a one-rank gloo
    group against the reference's 1-device mesh, within the reference's
    sharded tolerance (test_delta_pagerank.py:79: rtol 1e-6 / atol 1e-9),
    with equal iterations and messages for the delta run."""
    import jax
    from jax.sharding import Mesh
    from torch_dist import single_rank_mesh
    ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    g_ref, g, part_ref, part = _both("rmat8", shards=1)
    kw = {"tol": 1e-9, "max_rounds": 400} if fn == "pagerank_delta" else {}
    want = getattr(ref_apps, fn)(g_ref, part=part_ref, mesh=ref_mesh, **kw)
    with single_rank_mesh() as mesh:
        got = getattr(apps, fn)(g, part=part, mesh=mesh, device="cpu", **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-9)
    if fn == "pagerank_delta":
        assert _stats(got[1])[:2] == _stats(want[1])[:2]
