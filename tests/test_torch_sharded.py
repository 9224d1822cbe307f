"""The port's sharded layout on ``torch.distributed`` (gloo on the CPU)
against the reference's ``shard_map`` runs and the port's stacked runs.

Three processes of work, started once for the module:

* the reference's sharded runs on 8 XLA host devices (a 4x2 mesh), in
  one JAX subprocess (``JAX_PLATFORMS=cpu``,
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
  ``tests/test_engine_sharded.py`` runs them), saved to an ``.npz``;
* the port's: 8 spawned gloo ranks on a 4x2 ``DeviceMesh`` and 4 ranks
  on a 2x2 one (``tests/torch_dist.py``: a ``FileStore`` under the
  test's temporary directory, so parallel test workers share no port;
  the children never import JAX), each case run sharded and stacked on
  the same partition.

The cases mirror the reference's sharded tests (named in each test).
Tolerances: min values bit-identical to the reference's sharded run, the
port's stacked run and the numpy oracles; ``RunStats`` / ``LaneStats``,
the recorder's per-shard messages and served schedules exactly equal;
sums within rtol 1e-4 / atol 1e-7 of the oracle and the reference, and
rtol 1e-6 / atol 1e-9 of the stacked run.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps.pagerank import _pr_graph as ref_pr_graph  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro.graph import reference  # noqa: E402
from repro.graph.graph import COOGraph as RefCOOGraph  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.exchange import collectives  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.query import lanes  # noqa: E402

from torch_dist import single_rank_mesh  # noqa: E402

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"

REF_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro import apps, obs
    from repro.apps.pagerank import _pr_graph
    from repro.core import actions, engine
    from repro.core.partition import PartitionConfig, build_partition
    from repro.core.resilient import ShardedTask, run_resilient
    from repro.core.streaming import StreamingGraph
    from repro.graph import generators
    from repro.graph.graph import COOGraph
    from repro.query import QueryServer, lanes

    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    out = {}

    def stats(st):
        return np.asarray([int(x) for x in st], np.int64)

    g = generators.ba_skewed(300, m_per=4, seed=9).with_random_weights(
        seed=9)
    root = int(g.src[0])
    for exch in ("dense", "compact"):
        cfg = engine.EngineConfig(exchange=exch)
        lv, st, part = apps.bfs(g, root, num_shards=8, rpvo_max=4,
                                mesh=mesh, cfg=cfg)
        d, dst, _ = apps.sssp(g, root, part=part, mesh=mesh, cfg=cfg)
        dd, _, _ = apps.sssp(g, root, part=part, mesh=mesh,
                             cfg=engine.EngineConfig(collapse="deferred",
                                                     exchange=exch))
        out.update({f"engine/plain_{exch}_bfs": lv,
                    f"engine/plain_{exch}_bfs_stats": stats(st),
                    f"engine/plain_{exch}_sssp": d,
                    f"engine/plain_{exch}_sssp_stats": stats(dst),
                    f"engine/plain_{exch}_sssp_deferred": dd})
    g = generators.ba_skewed(260, m_per=4, seed=9).with_random_weights(
        seed=9)
    root = int(np.argmax(g.out_degrees()))
    for exch in ("dense", "compact"):
        cfg = engine.EngineConfig(exchange=exch)
        lv, st, part = apps.bfs(g, root, num_shards=8, rpvo_max=4,
                                mesh=mesh, cfg=cfg)
        d, dst, _ = apps.sssp(g, root, part=part, mesh=mesh, cfg=cfg)
        pr, _ = apps.pagerank(g, iters=12, num_shards=8, rpvo_max=4,
                              mesh=mesh, cfg=cfg)
        out.update({f"engine/fused_{exch}_bfs": lv,
                    f"engine/fused_{exch}_bfs_stats": stats(st),
                    f"engine/fused_{exch}_sssp": d,
                    f"engine/fused_{exch}_sssp_stats": stats(dst),
                    f"engine/fused_{exch}_pr": pr})

    g = generators.rmat(8, edge_factor=6, seed=3)
    for exch in ("dense", "compact"):
        sc, st, _ = apps.pagerank_delta(
            g, tol=1e-9, num_shards=8, rpvo_max=4, max_rounds=400,
            mesh=mesh, cfg=engine.EngineConfig(exchange=exch))
        out[f"delta/{exch}"], out[f"delta/{exch}_stats"] = sc, stats(st)

    g = generators.rmat(8, edge_factor=4, seed=6).with_random_weights(seed=6)
    deg = np.argsort(-g.out_degrees())
    queries = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
               ("bfs", int(deg[2])), ("sssp", int(deg[7]))]
    for exch in ("dense", "compact"):
        res, st, _ = apps.batched_queries(
            g, queries, num_shards=8, rpvo_max=4, mesh=mesh,
            cfg=engine.EngineConfig(exchange=exch))
        out[f"lanes/{exch}"] = np.stack(res).astype(np.float64)
        out[f"lanes/{exch}_stats"] = np.stack(
            [np.asarray(x, np.int64) for x in st])

    part = build_partition(_pr_graph(g),
                           PartitionConfig(num_shards=8, rpvo_max=4))
    trace = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
             ("ppr", int(deg[2])), ("bfs", int(deg[3])),
             ("reachability", int(deg[5])), ("sssp", int(deg[8])),
             ("ppr", int(deg[9])), ("bfs", int(deg[12]))]
    for exch in ("dense", "compact"):
        srv = QueryServer(part, n_lanes=2, ppr_lanes=1, mesh=mesh,
                          cfg=engine.EngineConfig(exchange=exch))
        qids = [srv.submit(k, r, tol=1e-9) for k, r in trace]
        res = srv.run()
        out[f"server/trace_{exch}"] = np.asarray(
            [[res[q].rounds, res[q].messages, res[q].admitted_tick,
              res[q].completed_tick, res[q].lane, res[q].exchanged]
             for q in qids], np.int64)
        out[f"server/trace_{exch}_values"] = np.stack(
            [np.asarray(res[q].values, np.float64) for q in qids])

    g = generators.ba_skewed(400, m_per=4, seed=11).with_random_weights(
        seed=11)
    part = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=2))
    init = engine.init_values(part, actions.SSSP, {0: 0.0})
    val, st = engine.run_sharded(actions.SSSP, part, init, mesh)
    out["worklist/dense"] = np.asarray(val)
    out["worklist/dense_stats"] = stats(st)

    g = generators.ba_skewed(400, m_per=4, seed=11)
    with obs.recording(meta={"case": "sharded-skew"}) as rec:
        _, st, _ = apps.pagerank_delta(g, tol=3e-5, num_shards=8,
                                       rpvo_max=2, mesh=mesh, max_rounds=6)
    rounds = [r for r in rec.rounds if r.run == "pagerank_delta_sharded"]
    out["obs/stats"] = stats(st)
    out["obs/shard_messages"] = np.asarray(
        [r.shard_messages for r in rounds], np.int64)
    out["obs/frontier"] = np.asarray([r.frontier for r in rounds])

    g = generators.rmat(6, edge_factor=6, seed=3).with_random_weights(seed=3)
    mesh1 = Mesh(np.array(jax.devices()[:8]).reshape(8,), ("data",))
    pcfg = PartitionConfig(num_shards=8, rpvo_max=3,
                           local_edge_list_size=8, seed=9)
    sg = StreamingGraph(g, pcfg, runner="sharded", mesh=mesh1,
                        axis_names=("data",))
    root = int(g.src[0])
    sg.track("bfs", root); sg.track("sssp", root)
    sg.track("pagerank", tol=1e-7)
    rng = np.random.default_rng(1)
    for batch in range(3):
        s = rng.integers(0, g.n, 6).astype(np.int32)
        d = rng.integers(0, g.n, 6).astype(np.int32)
        sg.insert_edges(s, d, rng.integers(1, 10, 6).astype(np.float32))
        if batch == 1:
            idx = rng.choice(sg.g.num_edges, 4, replace=False)
            sg.delete_edges(sg.g.src[idx], sg.g.dst[idx])
        info = sg.commit()
        for app in ("bfs", "sssp"):
            m = info.maint[(app, root)]
            out[f"streaming/{app}_{batch}"] = sg.values(app, root)
            out[f"streaming/{app}_{batch}_maint"] = np.asarray(
                [m.rounds, m.messages, m.work, m.seeds])
        out[f"streaming/pagerank_{batch}"] = sg.values("pagerank")

    g = generators.rmat(8, edge_factor=5, seed=4).with_random_weights(seed=4)
    part = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=2))
    root = int(np.argsort(-g.out_degrees())[0])
    init = engine.init_values(part, actions.SSSP, {root: 0.0})
    clean, st, _ = run_resilient(ShardedTask(actions.SSSP, part, init, mesh))
    out["resilient/clean"] = np.asarray(clean)
    out["resilient/clean_stats"] = stats(st)
    np.savez(sys.argv[1], **out)
    print("REF_SHARDED_OK")
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{'ref': the reference's 8-device runs, 8: the port's 8 ranks, 4:
    its 4 ranks} as loaded ``.npz`` dicts."""
    tmp = tmp_path_factory.mktemp("sharded")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CHILD, str(tmp / "ref.npz")],
        env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for world, dims in ((8, (4, 2)), (4, (2, 2))):
            path = tmp / f"port{world}" / "out.npz"
            path.parent.mkdir()
            res = subprocess.run(
                [sys.executable, str(TESTS / "torch_dist.py"), str(path),
                 str(world), *map(str, dims)],
                env=_env(), capture_output=True, text=True, timeout=400)
            assert res.returncode == 0, res.stderr[-6000:]
            out[world] = dict(np.load(path))
        so, se = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_SHARDED_OK" in so, se[-6000:]
    out["ref"] = dict(np.load(tmp / "ref.npz"))
    return out


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------
# engine: run_sharded, the sharded PageRanks (test_engine_sharded.py:65,
# 90, 148; test_delta_pagerank.py:79; test_worklist.py:641)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["plain_dense", "plain_compact",
                                 "fused_dense", "fused_compact"])
def test_bfs_sssp_sharded(runs, tag):
    got, want = runs[8], runs["ref"]
    k = f"engine/{tag}"
    seed, n = (9, 300) if tag.startswith("plain") else (9, 260)
    g = ref_generators.ba_skewed(n, m_per=4, seed=seed).with_random_weights(
        seed=seed)
    root = int(g.src[0]) if tag.startswith("plain") \
        else int(np.argmax(g.out_degrees()))
    for app in ("bfs", "sssp"):
        _eq(got[f"{k}_{app}"], want[f"{k}_{app}"])
        _eq(got[f"{k}_{app}"], got[f"{k}_{app}_stacked"])
        _eq(got[f"{k}_{app}_stats"], want[f"{k}_{app}_stats"])
        _eq(got[f"{k}_{app}_stats"], got[f"{k}_{app}_stacked_stats"])
    _eq(got[f"{k}_bfs"], reference.bfs_levels(g, root))
    np.testing.assert_allclose(got[f"{k}_sssp"],
                               reference.sssp_dijkstra(g, root),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exch", ["dense", "compact"])
def test_sssp_deferred_collapse_sharded(runs, exch):
    got, want = runs[8], runs["ref"]
    k = f"engine/plain_{exch}_sssp_deferred"
    _eq(got[k], want[k])
    _eq(got[k], got[f"{k}_stacked"])


@pytest.mark.parametrize("exch", ["dense", "compact"])
def test_pagerank_sharded(runs, exch):
    got, want = runs[8], runs["ref"]
    k = f"engine/fused_{exch}_pr"
    g = ref_generators.ba_skewed(260, m_per=4, seed=9).with_random_weights(
        seed=9)
    np.testing.assert_allclose(got[k], reference.pagerank(g, iters=12),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[k], got[f"{k}_stacked"], rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("exch", ["dense", "compact"])
def test_pagerank_delta_sharded(runs, exch):
    got, want = runs[8], runs["ref"]
    k = f"delta/{exch}"
    g = ref_generators.rmat(8, edge_factor=6, seed=3)
    np.testing.assert_allclose(got[k], got[f"{k}_stacked"], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(got[k], reference.pagerank(g, iters=200),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7)
    # iterations and messages
    _eq(got[f"{k}_stats"][:2], got[f"{k}_stacked_stats"][:2])
    _eq(got[f"{k}_stats"][:2], want[f"{k}_stats"][:2])


def test_worklist_modes_route_to_device_worklist(runs):
    """'worklist' warns once and runs as 'device_worklist'; all three
    equal the dense sharded run, the stacked run and the reference's."""
    got, want = runs[8], runs["ref"]
    assert int(got["worklist/warnings"]) == 1
    for gm in ("device_worklist", "worklist"):
        _eq(got[f"worklist/{gm}"], got["worklist/dense"])
        _eq(got[f"worklist/{gm}_stats"], got["worklist/dense_stats"])
    _eq(got["worklist/dense"], got["worklist/stacked"])
    _eq(got["worklist/dense_stats"], got["worklist/stacked_stats"])
    _eq(got["worklist/dense"], want["worklist/dense"])
    _eq(got["worklist/dense_stats"], want["worklist/dense_stats"])


@pytest.mark.parametrize("tag", ["pinned", "tiled"])
def test_kernel_path_sharded(runs, tag):
    """test_fused_kernel.py:197, test_fused_tiled.py:327: the kernel path
    (its plain versions here), pinned and under a budget below the
    table, sharded against stacked and the oracle."""
    got = runs[8]
    g = ref_generators.erdos_renyi(180, avg_degree=4.0, seed=21)
    _eq(got[f"fused/{tag}_bfs"], got[f"fused/{tag}_bfs_stacked"])
    _eq(got[f"fused/{tag}_stats"], got[f"fused/{tag}_stacked_stats"])
    _eq(got[f"fused/{tag}_bfs"], reference.bfs_levels(g, int(g.src[0])))


def test_tiled_lanes_sharded(runs):
    """test_fused_tiled.py:368."""
    got = runs[8]
    _eq(got["fused/tiled_lanes"], got["fused/tiled_lanes_stacked"])
    _eq(got["fused/tiled_lanes_stats"],
        got["fused/tiled_lanes_stacked_stats"])


# --------------------------------------------------------------------------
# lanes (test_query_lanes.py:162, test_exchange_unified.py:94)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["dense_plain", "dense_fused",
                                 "compact_plain", "compact_fused"])
def test_lane_batch_sharded(runs, tag):
    got, want = runs[8], runs["ref"]
    exch = tag.split("_")[0]
    _eq(got[f"lanes/{tag}"], got[f"lanes/{tag}_stacked"])
    _eq(got[f"lanes/{tag}_stats"], got[f"lanes/{tag}_stacked_stats"])
    _eq(got[f"lanes/{tag}"], want[f"lanes/{exch}"])
    # rounds, messages, work, exchanged
    _eq(got[f"lanes/{tag}_stats"], want[f"lanes/{exch}_stats"])


def test_compact_lanes_exchange_less(runs):
    got = runs[8]
    assert (got["lanes/compact_fused_stats"][3]
            < got["lanes/dense_fused_stats"][3]).all()


# --------------------------------------------------------------------------
# the sharded QueryServer (test_exchange_unified.py:144, 181, 257;
# test_serve_robustness.py:526)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("exch", ["dense", "compact"])
def test_server_no_head_of_line_blocking(runs, exch):
    got = runs[8]
    rows, vals = got[f"server/hol_{exch}"], got[f"server/hol_{exch}_values"]
    long_r, s1, s2 = rows            # rounds, msgs, admitted, completed, lane
    assert s2[2] > s1[3] and s2[2] < long_r[3]
    assert s2[4] == s1[4] != long_r[4]
    assert s1[3] < long_r[3] and s2[3] < long_r[3]
    n = 40
    g = RefCOOGraph(n, np.arange(n - 1, dtype=np.int32),
                    np.arange(1, n, dtype=np.int32), None)
    for v, root in zip(vals, (0, n - 3, n - 5)):
        _eq(v, reference.bfs_levels(g, root))
    assert long_r[0] == n and long_r[5] > 0


def test_server_mixed_kinds(runs):
    got = runs[8]
    g = ref_generators.rmat(7, edge_factor=5, seed=8)
    deg = np.argsort(-g.out_degrees())
    for v, seed, d in zip(got["server/mixed_ppr"], (int(deg[0]),
                                                    int(deg[3])),
                          (0.85, 0.6)):
        np.testing.assert_allclose(
            v, reference.personalized_pagerank(g, seed, d, tol=1e-12),
            rtol=1e-4, atol=1e-7)
    _eq(got["server/mixed_bfs"], reference.bfs_levels(g, int(deg[1])))


@pytest.mark.parametrize("exch", ["dense", "compact"])
def test_server_trace_equals_stacked(runs, exch):
    """Every request's values, rounds, messages, admitted and completed
    ticks, lane and exchanged volume equal the stacked server's and the
    reference's sharded server's (PPR values within tolerance)."""
    got, want = runs[8], runs["ref"]
    k = f"server/trace_{exch}"
    for other in (got[f"{k}_stacked"], want[k]):
        _eq(got[f"{k}_sharded"], other)
    kinds = ["bfs", "sssp", "ppr", "bfs", "reachability", "sssp", "ppr",
             "bfs"]
    for i, kind in enumerate(kinds):
        a = got[f"{k}_sharded_values"][i]
        for b in (got[f"{k}_stacked_values"][i], want[f"{k}_values"][i]):
            if kind == "ppr":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
            else:
                _eq(a, b)


@pytest.mark.parametrize("exch", ["dense", "compact"])
def test_server_snapshot_gathers_lane_tables(runs, exch):
    got = runs[8]
    _eq(got[f"server/snap_{exch}"], got[f"server/snap_{exch}_stacked"])


@pytest.mark.parametrize("exch", ["dense", "compact"])
def test_sharded_ppr_delta_round_trace(runs, exch):
    got = runs[8]
    ranks, counts = got[f"ppr_round/{exch}_ranks"], \
        got[f"ppr_round/{exch}_counts"]
    np.testing.assert_allclose(ranks[:, 0], ranks[:, 1], rtol=1e-5,
                               atol=1e-9)
    _eq(counts[:, 0], counts[:, 1])


# --------------------------------------------------------------------------
# flight recorder (test_obs.py:515)
# --------------------------------------------------------------------------

def test_recorded_shard_messages(runs):
    got, want = runs[8], runs["ref"]
    sm = got["obs/shard_messages"]
    assert int(got["obs/rounds"]) == int(got["obs/stats"][0]) == len(sm) > 0
    assert sm.sum() == int(got["obs/stats"][1])
    _eq(sm, want["obs/shard_messages"])
    _eq(got["obs/frontier"], want["obs/frontier"])
    _eq(got["obs/stats"], want["obs/stats"])


# --------------------------------------------------------------------------
# streaming (test_streaming.py:173) and recovery (test_resilience.py:405)
# --------------------------------------------------------------------------

def test_streaming_sharded(runs):
    got, want = runs[8], runs["ref"]
    _eq(got["streaming/sharded_src"], got["streaming/lanes_src"])
    g = ref_generators.rmat(6, edge_factor=6, seed=3)
    mg = RefCOOGraph(g.n, got["streaming/sharded_src"],
                     got["streaming/sharded_dst"], None)
    root = int(g.src[0])
    for batch in range(3):
        for app in ("bfs", "sssp"):
            k = f"{app}_{batch}"
            _eq(got[f"streaming/sharded_{k}"], got[f"streaming/lanes_{k}"])
            _eq(got[f"streaming/sharded_{k}"], want[f"streaming/{k}"])
            _eq(got[f"streaming/sharded_{k}_maint"],
                got[f"streaming/lanes_{k}_maint"])
            _eq(got[f"streaming/sharded_{k}_maint"],
                want[f"streaming/{k}_maint"])
        k = f"pagerank_{batch}"
        np.testing.assert_allclose(got[f"streaming/sharded_{k}"],
                                   got[f"streaming/lanes_{k}"],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got[f"streaming/sharded_{k}"],
                                   want[f"streaming/{k}"],
                                   rtol=1e-4, atol=1e-7)
    lv = got["streaming/sharded_bfs_2"]
    want_lv = reference.bfs_levels(mg, root)
    fin = np.isfinite(lv)
    _eq(fin, want_lv != np.iinfo(np.int32).max)
    _eq(lv[fin].astype(np.int64), want_lv[fin])


@pytest.mark.parametrize("kind", ["clean", "corrupt_tile", "kill_shard",
                                  "drop_inbox"])
def test_resilient_sharded(runs, kind):
    got, want = runs[8], runs["ref"]
    _eq(got[f"resilient/{kind}"], want["resilient/clean"])
    _eq(got[f"resilient/{kind}_stats"], want["resilient/clean_stats"])
    _eq(got[f"resilient/{kind}"], got["resilient/run_sharded"])
    flag = "clean_ok" if kind == "clean" else f"{kind}_recovered"
    assert bool(got[f"resilient/{flag}"])


# --------------------------------------------------------------------------
# a 2x2 mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("exch", ["dense", "compact"])
def test_four_ranks(runs, exch):
    got = runs[4]
    k = f"four/{exch}"
    for app in ("bfs", "sssp"):
        _eq(got[f"{k}_{app}"], got[f"{k}_{app}_stacked"])
        _eq(got[f"{k}_{app}_stats"], got[f"{k}_{app}_stacked_stats"])
    for s in ("pr", "delta"):
        np.testing.assert_allclose(got[f"{k}_{s}"], got[f"{k}_{s}_stacked"],
                                   rtol=1e-6, atol=1e-9)
    _eq(got[f"{k}_delta_stats"][:2], got[f"{k}_delta_stacked_stats"][:2])


def test_four_ranks_lanes_device_worklist(runs):
    got = runs[4]
    _eq(got["four/lanes"], got["four/lanes_stacked"])
    _eq(got["four/lanes_stats"], got["four/lanes_stacked_stats"])


# --------------------------------------------------------------------------
# in-process: the partition both packages shard, the collectives, the
# mesh's checks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["plain", "pagerank"])
def test_sharded_partitions_equal_reference(weights):
    """The ranks build their partitions with the port, the reference's
    runs with the reference: field for field the same."""
    from repro_torch.apps.pagerank import _pr_graph
    g = generators.rmat(8, edge_factor=4, seed=6).with_random_weights(seed=6)
    g_ref = ref_generators.rmat(8, edge_factor=4, seed=6) \
        .with_random_weights(seed=6)
    if weights == "pagerank":
        g, g_ref = _pr_graph(g), ref_pr_graph(g_ref)
    got = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=4))
    want = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=8, rpvo_max=4))
    for f in ("edge_src_root_flat", "edge_dst_flat", "edge_w", "edge_mask",
              "sibling_flat", "sibling_mask", "slot_vertex",
              "edge_dst_compact", "inbox_slot_map", "rz_local",
              "rz_sibling_idx", "rz_sibling_mask"):
        _eq(getattr(got, f), getattr(want, f))


def test_collectives_one_rank():
    with single_rank_mesh() as mesh:
        sg = collectives.shard_group(mesh)
        assert (sg.rank, sg.size) == (0, 1)
        x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        b = torch.tensor([True, False, True])
        _eq(collectives.all_gather(x, sg), x)
        _eq(collectives.all_to_all(x, sg), x)
        _eq(collectives.all_gather(b, sg), b)
        assert collectives.all_gather(b, sg).dtype == torch.bool
        _eq(collectives.psum(torch.tensor([3, 4]), sg), [3, 4])
        m = collectives.pmax(b, sg)
        _eq(m, b)
        assert m.dtype == torch.bool and b.tolist() == [True, False, True]


def test_one_mesh_axis_one_rank():
    """``axis_names`` naming one dimension of the mesh: its group."""
    g = generators.ring(16)
    part = build_partition(g, PartitionConfig(num_shards=1))
    init = engine.init_values(part, actions.BFS, {0: 0.0})
    want, want_st = engine.run_stacked(actions.BFS, part, init,
                                       device="cpu")
    with single_rank_mesh() as mesh:
        got, st = engine.run_sharded(actions.BFS, part, init, mesh,
                                     axis_names="model", device="cpu")
    _eq(got, want)
    assert [int(x) for x in st] == [int(x) for x in want_st]


def test_mesh_checks_one_rank():
    """One shard a rank: a partition of another shard count, or axes the
    mesh lacks, raise ``ValueError``."""
    g = generators.ring(16)
    part = build_partition(g, PartitionConfig(num_shards=2))
    init = engine.init_values(part, actions.BFS, {0: 0.0})
    with single_rank_mesh() as mesh:
        with pytest.raises(ValueError, match="one shard a rank"):
            engine.run_sharded(actions.BFS, part, init, mesh, device="cpu")
        with pytest.raises(ValueError, match="no axes"):
            engine.make_sharded_fn(actions.BFS, 1, 4, mesh, ("rows",))
        with pytest.raises(ValueError, match="min-semiring"):
            engine.make_sharded_fn(actions.PAGERANK, 1, 4, mesh)
        seeded, unitw = lanes.init_lane_values(
            build_partition(g, PartitionConfig(num_shards=1)), [("bfs", 0)])
        with pytest.raises(ValueError, match="lane_unitw"):
            lanes.make_sharded_lanes_fn(1, 4, 1, mesh, sem=actions.BFS)
