"""Process-group helpers for the port's sharded-layout tests (CPU, gloo).

``single_rank_mesh()`` makes a one-rank gloo group in this process (an
in-process ``HashStore``) and its 1x1 ``("data", "model")`` mesh, and
destroys the group afterwards.

Run as a script, it spawns ranks of the port's sharded layout:

    python tests/torch_dist.py OUT.npz WORLD D0 [D1]

starts WORLD gloo ranks (``spawn``, a ``FileStore`` beside OUT), lays a
``DeviceMesh`` of shape (D0[, D1]) over them and runs every case of
``CASES_8`` (WORLD = 8) or ``CASES_4`` (WORLD = 4) on every rank, each
rank making the same sharded calls; rank 0 alone makes the stacked runs
they are held to (no collectives) and writes what the cases return to
OUT.npz.  A case's keys are prefixed with its name.  The children import
``repro_torch`` only — never JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def single_rank_mesh():
    """A 1x1 ``DeviceMesh`` over a one-rank gloo group in this process."""
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the ranks' cases (every rank runs them; rank 0's results are kept)
# --------------------------------------------------------------------------

CPU = "cpu"


def _rank0() -> bool:
    """Whether this rank makes the stacked runs (rank 0: the others skip
    them, since only rank 0's results are kept)."""
    return dist.get_rank() == 0


def _stats(st) -> np.ndarray:
    return np.asarray([int(x) for x in st], np.int64)


def _lane_stats(st) -> np.ndarray:
    return np.stack([np.asarray(x.cpu(), np.int64) for x in st])


def _apps_case(mesh, world, g, root, cfg, tag, out, iters=12,
               pagerank_graph=True, deferred=False):
    """BFS / SSSP (eager, and deferred collapse when asked) and PageRank
    sharded and stacked on one partition."""
    from repro_torch import apps
    from repro_torch.core import engine
    lv, st, part = apps.bfs(g, root, num_shards=world, rpvo_max=4,
                            mesh=mesh, cfg=cfg, device=CPU)
    d, dst, _ = apps.sssp(g, root, part=part, mesh=mesh, cfg=cfg,
                          device=CPU)
    out.update({f"{tag}_bfs": lv, f"{tag}_bfs_stats": _stats(st),
                f"{tag}_sssp": d, f"{tag}_sssp_stats": _stats(dst)})
    if _rank0():
        lv0, st0, _ = apps.bfs(g, root, part=part, cfg=cfg, device=CPU)
        d0, dst0, _ = apps.sssp(g, root, part=part, cfg=cfg, device=CPU)
        out.update({f"{tag}_bfs_stacked": lv0,
                    f"{tag}_bfs_stacked_stats": _stats(st0),
                    f"{tag}_sssp_stacked": d0,
                    f"{tag}_sssp_stacked_stats": _stats(dst0)})
    if deferred:
        dcfg = engine.EngineConfig(collapse="deferred",
                                   exchange=cfg.exchange,
                                   use_pallas=cfg.use_pallas)
        out[f"{tag}_sssp_deferred"], _, _ = apps.sssp(
            g, root, part=part, mesh=mesh, cfg=dcfg, device=CPU)
        if _rank0():
            out[f"{tag}_sssp_deferred_stacked"], _, _ = apps.sssp(
                g, root, part=part, cfg=dcfg, device=CPU)
    if pagerank_graph:
        out[f"{tag}_pr"], ppart = apps.pagerank(
            g, iters=iters, num_shards=world, rpvo_max=4, mesh=mesh,
            cfg=cfg, device=CPU)
        if _rank0():
            out[f"{tag}_pr_stacked"], _ = apps.pagerank(
                g, iters=iters, part=ppart, cfg=cfg, device=CPU)


def case_engine(mesh, world, out):
    """test_engine_sharded.py:65/90/148 — BFS, SSSP (deferred collapse
    too) and PageRank, dense and compact, plain and kernel paths."""
    from repro_torch.core import engine
    from repro_torch.graph import generators
    g = generators.ba_skewed(300, m_per=4, seed=9).with_random_weights(
        seed=9)
    root = int(g.src[0])
    for exch in ("dense", "compact"):
        _apps_case(mesh, world, g, root, engine.EngineConfig(exchange=exch),
                   f"plain_{exch}", out, pagerank_graph=False,
                   deferred=True)
    g = generators.ba_skewed(260, m_per=4, seed=9).with_random_weights(
        seed=9)
    root = int(np.argmax(g.out_degrees()))
    for exch in ("dense", "compact"):
        _apps_case(mesh, world, g, root,
                   engine.EngineConfig(exchange=exch, use_pallas=True),
                   f"fused_{exch}", out)


def case_delta(mesh, world, out):
    """test_delta_pagerank.py:79 — sharded delta-PageRank (kernel path)
    against the stacked run."""
    from repro_torch import apps
    from repro_torch.core import engine
    from repro_torch.graph import generators
    g = generators.rmat(8, edge_factor=6, seed=3)
    for exch in ("dense", "compact"):
        cfg = engine.EngineConfig(use_pallas=True, exchange=exch)
        sc, st, part = apps.pagerank_delta(g, tol=1e-9, num_shards=world,
                                           rpvo_max=4, cfg=cfg,
                                           max_rounds=400, mesh=mesh,
                                           device=CPU)
        out.update({f"{exch}": sc, f"{exch}_stats": _stats(st)})
        if _rank0():
            sc0, st0, _ = apps.pagerank_delta(g, tol=1e-9, part=part,
                                              cfg=cfg, max_rounds=400,
                                              device=CPU)
            out.update({f"{exch}_stacked": sc0,
                        f"{exch}_stacked_stats": _stats(st0)})


def case_fused(mesh, world, out):
    """test_fused_kernel.py:197 and test_fused_tiled.py:327/368 — the
    kernel path pinned and under a budget below every table (tiled), BFS
    and laned, sharded against stacked."""
    from repro_torch import apps
    from repro_torch.core import engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators
    from repro_torch.query import lanes
    g = generators.erdos_renyi(180, avg_degree=4.0, seed=21)
    root = int(g.src[0])
    for tag, budget in (("pinned", None), ("tiled", 256)):
        cfg = engine.EngineConfig(use_pallas=True, vmem_budget_bytes=budget)
        lv, st, part = apps.bfs(g, root, num_shards=world, rpvo_max=4,
                                mesh=mesh, cfg=cfg, device=CPU)
        out.update({f"{tag}_bfs": lv, f"{tag}_stats": _stats(st)})
        if _rank0():
            lv0, st0, _ = apps.bfs(g, root, part=part, cfg=cfg, device=CPU)
            out.update({f"{tag}_bfs_stacked": lv0,
                        f"{tag}_stacked_stats": _stats(st0)})
    g = generators.ba_skewed(150, m_per=3, seed=6).with_random_weights(
        seed=6)
    part = build_partition(g, PartitionConfig(num_shards=world, rpvo_max=4))
    init, unitw = lanes.init_lane_values(
        part, [("bfs", 2), ("sssp", 9), ("sssp", 0)])
    cfg = engine.EngineConfig(use_pallas=True, vmem_budget_bytes=256)
    v, st = lanes.run_sharded_lanes(part, init, unitw, mesh=mesh, cfg=cfg,
                                    device=CPU)
    out.update({"tiled_lanes": v.numpy(),
                "tiled_lanes_stats": _lane_stats(st)})
    if _rank0():
        v0, st0 = lanes.run_stacked_lanes(part, init, unitw, cfg=cfg,
                                          device=CPU)
        out.update({"tiled_lanes_stacked": v0.numpy(),
                    "tiled_lanes_stacked_stats": _lane_stats(st0)})


def _skewed_queries(seed):
    from repro_torch.graph import generators
    g = generators.rmat(8, edge_factor=4, seed=seed).with_random_weights(
        seed=seed)
    deg = np.argsort(-g.out_degrees())
    queries = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
               ("bfs", int(deg[2])), ("sssp", int(deg[7]))]
    return g, queries


def case_lanes(mesh, world, out):
    """test_query_lanes.py:162 (the 8-device child) and
    test_exchange_unified.py:94 — sharded lane batches, plain and kernel
    paths, dense and compact, against the stacked lanes."""
    from repro_torch import apps
    from repro_torch.core import engine
    g, queries = _skewed_queries(6)
    for exch in ("dense", "compact"):
        for use_pallas in (False, True):
            cfg = engine.EngineConfig(use_pallas=use_pallas, exchange=exch)
            tag = f"{exch}_{'fused' if use_pallas else 'plain'}"
            res, st, part = apps.batched_queries(
                g, queries, num_shards=world, rpvo_max=4, mesh=mesh,
                cfg=cfg, device=CPU)
            out.update({f"{tag}": np.stack(res).astype(np.float64),
                        f"{tag}_stats": _lane_stats(st)})
            if _rank0():
                res0, st0, _ = apps.batched_queries(g, queries, part=part,
                                                    cfg=cfg, device=CPU)
                out.update({f"{tag}_stacked":
                            np.stack(res0).astype(np.float64),
                            f"{tag}_stacked_stats": _lane_stats(st0)})


def _serve(srv, trace):
    qids = [srv.submit(kind, root, tol=1e-9) for kind, root in trace]
    res = srv.run()
    rows = np.asarray([[res[q].rounds, res[q].messages, res[q].admitted_tick,
                        res[q].completed_tick, res[q].lane,
                        res[q].exchanged] for q in qids], np.int64)
    n = max(len(res[q].values) for q in qids)
    vals = np.stack([np.asarray(res[q].values, np.float64) for q in qids])
    assert vals.shape[1] == n
    return rows, vals


def case_server(mesh, world, out):
    """test_exchange_unified.py:144/181/257 — the sharded QueryServer:
    no head-of-line blocking on a path, mixed min and PPR kinds, and a
    request trace served as the stacked server serves it."""
    from repro_torch.apps.pagerank import _pr_graph
    from repro_torch.core import engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators
    from repro_torch.graph.graph import COOGraph
    from repro_torch.query import QueryServer
    n = 40
    src = np.arange(n - 1, dtype=np.int32)
    g = COOGraph(n, src, (src + 1).astype(np.int32), None)
    part = build_partition(g, PartitionConfig(num_shards=world, rpvo_max=1))
    for exch in ("dense", "compact"):
        srv = QueryServer(part, n_lanes=2, mesh=mesh, device=CPU,
                          cfg=engine.EngineConfig(exchange=exch))
        out[f"hol_{exch}"], out[f"hol_{exch}_values"] = _serve(
            srv, [("bfs", 0), ("bfs", n - 3), ("bfs", n - 5)])
    g = generators.rmat(7, edge_factor=5, seed=8)
    part = build_partition(_pr_graph(g),
                           PartitionConfig(num_shards=world, rpvo_max=2))
    deg = np.argsort(-g.out_degrees())
    srv = QueryServer(part, n_lanes=2, ppr_lanes=2, mesh=mesh, device=CPU)
    qa = srv.submit("ppr", int(deg[0]), damping=0.85, tol=1e-9)
    qb = srv.submit("ppr", int(deg[3]), damping=0.6, tol=1e-9)
    qc = srv.submit("bfs", int(deg[1]))
    res = srv.run()
    out["mixed_ppr"] = np.stack([res[qa].values, res[qb].values])
    out["mixed_bfs"] = np.asarray(res[qc].values)
    g = generators.rmat(8, edge_factor=4, seed=6).with_random_weights(seed=6)
    part = build_partition(_pr_graph(g),
                           PartitionConfig(num_shards=world, rpvo_max=4))
    deg = np.argsort(-g.out_degrees())
    trace = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
             ("ppr", int(deg[2])), ("bfs", int(deg[3])),
             ("reachability", int(deg[5])), ("sssp", int(deg[8])),
             ("ppr", int(deg[9])), ("bfs", int(deg[12]))]
    for exch in ("dense", "compact"):
        cfg = engine.EngineConfig(exchange=exch)
        for tag, m in (("sharded", mesh), ("stacked", None)):
            if m is None and not _rank0():
                continue
            srv = QueryServer(part, n_lanes=2, ppr_lanes=1, cfg=cfg,
                              mesh=m, device=CPU)
            out[f"trace_{exch}_{tag}"], out[f"trace_{exch}_{tag}_values"] \
                = _serve(srv, trace)
        # a snapshot of the sharded server holds the whole lane tables
        for tag, m in (("", mesh), ("_stacked", None)):
            if m is None and not _rank0():
                continue
            srv = QueryServer(part, n_lanes=2, ppr_lanes=1, cfg=cfg,
                              mesh=m, device=CPU)
            for kind, root in trace[:4]:
                srv.submit(kind, root, tol=1e-9)
            srv.step()
            srv.step()
            out[f"snap_{exch}{tag}"] = srv.snapshot()[0]["min"]["val"]


def case_worklist(mesh, world, out):
    """test_worklist.py:641 — SSSP under 'dense', 'device_worklist' and
    'worklist' (warned once, run as 'device_worklist')."""
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.graph import generators
    g = generators.ba_skewed(400, m_per=4, seed=11).with_random_weights(
        seed=11)
    part = build_partition(g, PartitionConfig(num_shards=world, rpvo_max=2))
    init = engine.init_values(part, actions.SSSP, {0: 0.0})
    base = dict(use_pallas=True, pallas_mode="fused")
    for gm in ("dense", "device_worklist"):
        val, st = engine.run_sharded(
            actions.SSSP, part, init, mesh, ("data", "model"),
            engine.EngineConfig(grid_mode=gm, **base), device=CPU)
        out[gm], out[f"{gm}_stats"] = val.numpy(), _stats(st)
    engine._SHARDED_GRID_WARNED.discard("make_sharded_fn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(2):
            val, st = engine.run_sharded(
                actions.SSSP, part, init, mesh, ("data", "model"),
                engine.EngineConfig(grid_mode="worklist", **base),
                device=CPU)
    out["worklist"], out["worklist_stats"] = val.numpy(), _stats(st)
    out["warnings"] = np.asarray(
        sum("device_worklist" in str(w.message) for w in rec))
    if _rank0():
        val, st = engine.run_stacked(actions.SSSP, part, init,
                                     engine.EngineConfig(**base),
                                     device=CPU)
        out["stacked"], out["stacked_stats"] = val.numpy(), _stats(st)


def case_obs(mesh, world, out):
    """test_obs.py:515 — a recorded sharded delta-PageRank: shard 0
    records every round with its per-shard message mirror."""
    from repro_torch import obs
    from repro_torch.apps.pagerank import pagerank_delta
    from repro_torch.graph import generators
    g = generators.ba_skewed(400, m_per=4, seed=11)
    with obs.recording(meta={"case": "sharded-skew"}) as rec:
        _, st, _ = pagerank_delta(g, tol=3e-5, num_shards=world, rpvo_max=2,
                                  mesh=mesh, max_rounds=6, device=CPU)
    rounds = [r for r in rec.rounds if r.run == "pagerank_delta_sharded"]
    out["stats"] = _stats(st)
    out["rounds"] = np.asarray(len(rounds))
    out["shard_messages"] = np.asarray([r.shard_messages for r in rounds],
                                       np.int64).reshape(len(rounds), world)
    out["frontier"] = np.asarray([r.frontier for r in rounds], np.int64)


def case_streaming(mesh, world, out):
    """test_streaming.py:173 — StreamingGraph(runner='sharded') on a 1-D
    ("data",) mesh through three batches (deletes in the second), held
    to runner='lanes' on the stacked layout."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.core.streaming import StreamingGraph
    from repro_torch.graph import generators
    g = generators.rmat(6, edge_factor=6, seed=3).with_random_weights(seed=3)
    mesh1 = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
    pcfg = PartitionConfig(num_shards=world, rpvo_max=3,
                           local_edge_list_size=8, seed=9)
    root = int(g.src[0])
    for tag, runner, m in (("sharded", "sharded", mesh1),
                           ("lanes", "lanes", None)):
        if m is None and not _rank0():
            continue
        sg = StreamingGraph(g, pcfg, runner=runner, mesh=m,
                            axis_names=("data",), device=CPU)
        sg.track("bfs", root)
        sg.track("sssp", root)
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
            for key in (("bfs", root), ("sssp", root)):
                m_ = info.maint[key]
                out[f"{tag}_{key[0]}_{batch}"] = sg.values(*key)
                out[f"{tag}_{key[0]}_{batch}_maint"] = np.asarray(
                    [m_.rounds, m_.messages, m_.work, m_.seeds])
            out[f"{tag}_pagerank_{batch}"] = sg.values("pagerank")
        out[f"{tag}_src"], out[f"{tag}_dst"] = sg.g.src, sg.g.dst


def case_resilient(mesh, world, out, tmp):
    """test_resilience.py:405 — ShardedTask clean and under three chaos
    kinds (a corrupted tile, a killed shard, a dropped inbox), each
    rank with its own checkpoint manager in one run."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import actions, engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.core.resilient import ShardedTask, run_resilient
    from repro_torch.graph import generators
    from repro_torch.runtime.chaos import ChaosEvent, ChaosPlan
    g = generators.rmat(8, edge_factor=5, seed=4).with_random_weights(seed=4)
    part = build_partition(g, PartitionConfig(num_shards=world, rpvo_max=2))
    root = int(np.argsort(-g.out_degrees())[0])
    init = engine.init_values(part, actions.SSSP, {root: 0.0})
    clean, st, rep = run_resilient(ShardedTask(actions.SSSP, part, init,
                                               mesh, device=CPU))
    out["clean"], out["clean_stats"] = clean.numpy(), _stats(st)
    out["clean_ok"] = np.asarray(rep.status == "ok")
    val, st = engine.run_sharded(actions.SSSP, part, init, mesh, device=CPU)
    out["run_sharded"], out["run_sharded_stats"] = val.numpy(), _stats(st)
    for kind, rnd, shard in (("corrupt_tile", 3, 5), ("kill_shard", 4, 2),
                             ("drop_inbox", 3, 1)):
        chaos = ChaosPlan(events=(ChaosEvent(round=rnd, kind=kind,
                                             shard=shard),))
        mgr = None
        cfg = engine.EngineConfig()
        if kind == "corrupt_tile":
            mgr = CheckpointManager(os.path.join(tmp, f"ckpt{dist.get_rank()}"))
            cfg = engine.EngineConfig(checkpoint_every=2)
        got, st, rep = run_resilient(
            ShardedTask(actions.SSSP, part, init, mesh, cfg=cfg, device=CPU),
            chaos=chaos, manager=mgr)
        out[kind], out[f"{kind}_stats"] = got.numpy(), _stats(st)
        out[f"{kind}_recovered"] = np.asarray(rep.status == "recovered")


def case_ppr_delta_round(mesh, world, out):
    """test_serve_robustness.py:526 — the sharded delta-PPR round replays
    the stacked delta trace round for round (dense and compact)."""
    from repro_torch.apps.pagerank import _pr_graph
    from repro_torch.core import engine
    from repro_torch.core.partition import PartitionConfig, build_partition
    from repro_torch.exchange import collectives
    from repro_torch.graph import generators
    from repro_torch.query import lanes as L
    g = generators.rmat(7, edge_factor=4, seed=11)
    part = build_partition(_pr_graph(g),
                           PartitionConfig(num_shards=world, rpvo_max=4))
    deg = np.argsort(-g.out_degrees())
    seeds = [int(deg[0]), int(deg[5])]
    dmp = torch.tensor([0.85, 0.6])
    tol = torch.tensor([1e-7, 1e-7])
    base = torch.as_tensor(L.ppr_base_table(part, seeds, dmp.numpy()))
    for exch in ("dense", "compact"):
        cfg = engine.EngineConfig(exchange=exch)
        arrays = engine.DeviceArrays.from_partition(part, CPU)
        st_round = L.make_ppr_delta_round(part, cfg, arrays=arrays)
        sh_round, sg = L.make_sharded_ppr_delta_round(
            part.S, part.R_max, mesh, ("data", "model"), cfg)
        sh_arrays = engine.DeviceArrays.from_partition(part, CPU,
                                                       shard=sg.rank)
        r_st = d_st = base
        r_sh = d_sh = base[sg.rank:sg.rank + 1]
        ranks, counts = [], []
        for _ in range(6):
            r_st, d_st, _, c_st = st_round(r_st, d_st, dmp, tol)
            r_sh, d_sh, _, c_sh = sh_round(sh_arrays, r_sh, d_sh, dmp, tol)
            ranks.append(np.stack([collectives.all_gather(r_sh, sg).numpy(),
                                   r_st.numpy()]))
            counts.append(np.stack([c_sh.numpy(), c_st.numpy()]))
        out[f"{exch}_ranks"] = np.stack(ranks)
        out[f"{exch}_counts"] = np.stack(counts)


def case_four(mesh, world, out):
    """A 2x2 mesh: BFS, SSSP and PageRank on four shards (dense and
    compact, the kernel path), delta-PageRank and a lane batch, against
    the stacked runs."""
    from repro_torch import apps
    from repro_torch.core import engine
    from repro_torch.graph import generators
    g = generators.ba_skewed(300, m_per=4, seed=9).with_random_weights(
        seed=9)
    root = int(np.argmax(g.out_degrees()))
    for exch in ("dense", "compact"):
        cfg = engine.EngineConfig(exchange=exch, use_pallas=True)
        _apps_case(mesh, world, g, root, cfg, exch, out)
        sc, st, part = apps.pagerank_delta(g, tol=1e-9, num_shards=world,
                                           rpvo_max=4, cfg=cfg, mesh=mesh,
                                           device=CPU)
        out.update({f"{exch}_delta": sc, f"{exch}_delta_stats": _stats(st)})
        if _rank0():
            sc0, st0, _ = apps.pagerank_delta(g, tol=1e-9, part=part,
                                              cfg=cfg, device=CPU)
            out.update({f"{exch}_delta_stacked": sc0,
                        f"{exch}_delta_stacked_stats": _stats(st0)})
    g, queries = _skewed_queries(4)
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="device_worklist")
    res, st, part = apps.batched_queries(g, queries, num_shards=world,
                                         rpvo_max=2, mesh=mesh, cfg=cfg,
                                         device=CPU)
    out.update({"lanes": np.stack(res).astype(np.float64),
                "lanes_stats": _lane_stats(st)})
    if _rank0():
        res0, st0, _ = apps.batched_queries(g, queries, part=part, cfg=cfg,
                                            device=CPU)
        out.update({"lanes_stacked": np.stack(res0).astype(np.float64),
                    "lanes_stacked_stats": _lane_stats(st0)})


CASES_8 = {"engine": case_engine, "delta": case_delta, "fused": case_fused,
           "lanes": case_lanes, "server": case_server,
           "worklist": case_worklist, "obs": case_obs,
           "streaming": case_streaming, "resilient": case_resilient,
           "ppr_round": case_ppr_delta_round}
CASES_4 = {"four": case_four}


def _rank_main(rank, world, dims, out_path):
    from torch.distributed.device_mesh import DeviceMesh
    store = dist.FileStore(out_path + ".store", world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(dims),
                      mesh_dim_names=("data", "model"))
    tmp = os.path.dirname(out_path)
    results = {}
    for name, case in (CASES_8 if world == 8 else CASES_4).items():
        out = {}
        args = (tmp,) if case is case_resilient else ()
        case(mesh, world, out, *args)
        results.update({f"{name}/{k}": np.asarray(v)
                        for k, v in out.items()})
    if rank == 0:
        np.savez(out_path, **results)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    warnings.filterwarnings("ignore", category=FutureWarning)
    out_path, world = sys.argv[1], int(sys.argv[2])
    dims = tuple(int(d) for d in sys.argv[3:])
    if os.path.exists(out_path + ".store"):    # a stale store hangs gloo
        os.remove(out_path + ".store")
    mp.start_processes(_rank_main, args=(world, dims, out_path),
                       nprocs=world, start_method="spawn")
