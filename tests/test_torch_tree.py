"""Search trees (``apps.bfs_tree`` / ``apps.sssp_tree``) and their pass,
K10 (``kernels.tree_parents``): values and stats equal ``apps.bfs`` /
``apps.sssp`` and the numpy oracles, every parent array passes a check
written here from Graph500's rules, ties still give a tree, K10's plain
version equals a loop over the edges, and on the card K10 equals its
plain version.

No JAX here: the card's machine runs the ``cuda``-marked tests of this
file (``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tree.py``).
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import apps, obs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.graph import generators, reference  # noqa: E402
from repro_torch.graph.graph import COOGraph  # noqa: E402
from repro_torch.kernels import tree_parents as k10  # noqa: E402

UNREACHED = np.iinfo(np.int32).max
GRID_MODES = ["dense", "device_worklist"]


def _graph500_like(scale, seed):
    """A seeded RMAT graph with Graph500's shares, symmetrised, weights
    uniform in [0, 1) in float32: in-degree hubs, real-valued SSSP."""
    g = generators.rmat(scale, edge_factor=8, a=0.57, b=0.19, c=0.19,
                        seed=seed)
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    w = np.random.default_rng(seed).random(src.size).astype(np.float32)
    return COOGraph(g.n, src, dst, w)


@pytest.fixture(scope="module", params=[(9, 1), (10, 2), (11, 3)],
                ids=["rmat9", "rmat10", "rmat11"])
def graph(request):
    scale, seed = request.param
    g = _graph500_like(scale, seed)
    part = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=4))
    assert part.num_replicas.max() > 1          # hubs have replicas
    deg = g.out_degrees()
    roots = [int(np.argmax(deg)),
             int(np.random.default_rng(seed).choice(np.flatnonzero(deg)))]
    return g, part, roots


def check_tree(g, root, values, parents, kind):
    """Vertices breaking Graph500's validation, checked with numpy alone:
    the root is its own parent; unreached exactly where the parent is -1;
    (parent, v) is an input edge; BFS: the parent's level is one less;
    SSSP: some edge (parent, v, w) gives fl32(d[parent] + w) == d[v]; and
    every chain of parents reaches the root."""
    n = g.n
    reached = (values != UNREACHED) if kind == "bfs" else np.isfinite(values)
    bad = set()
    if parents[root] != root:
        bad.add(root)
    bad |= set(np.flatnonzero(reached != (parents >= 0)).tolist())
    best = {}                                   # (u, v) -> fl32 d[u] + w
    for u, v, w in zip(g.src.tolist(), g.dst.tolist(), g.weight.tolist()):
        if kind == "bfs":
            ok = values[u] + 1 == values[v]
        else:
            ok = np.float32(values[u]) + np.float32(w) == \
                np.float32(values[v])
        best[(u, v)] = best.get((u, v), False) or ok
    for v in np.flatnonzero(reached):
        p = int(parents[v])
        if v == root:
            continue
        if (p, int(v)) not in best or not best[(p, int(v))]:
            bad.add(int(v))
            continue
        at, steps = int(v), 0
        while at != root and steps <= n:
            at, steps = int(parents[at]), steps + 1
            if at < 0:
                break
        if at != root:
            bad.add(int(v))
    return len(bad)


@pytest.mark.parametrize("grid_mode", GRID_MODES)
def test_bfs_tree_values_equal_bfs_and_tree_is_valid(graph, grid_mode):
    g, part, roots = graph
    cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid_mode)
    for root in roots:
        (lv, par), st, p = apps.bfs_tree(g, root, part=part, cfg=cfg,
                                         device="cpu")
        lv0, st0, _ = apps.bfs(g, root, part=part, cfg=cfg, device="cpu")
        assert p is part and par.dtype == np.int64 and par.shape == (g.n,)
        np.testing.assert_array_equal(lv, lv0)
        np.testing.assert_array_equal(lv, reference.bfs_levels(g, root))
        assert [int(x) for x in st] == [int(x) for x in st0]
        assert check_tree(g, root, lv, par, "bfs") == 0
        assert par[root] == root
        assert (par == -1).sum() == (lv == UNREACHED).sum()


@pytest.mark.parametrize("grid_mode", GRID_MODES)
def test_sssp_tree_values_equal_sssp_and_tree_is_valid(graph, grid_mode):
    g, part, roots = graph
    cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid_mode)
    for root in roots:
        (d, par), st, _ = apps.sssp_tree(g, root, part=part, cfg=cfg,
                                         device="cpu")
        d0, st0, _ = apps.sssp(g, root, part=part, cfg=cfg, device="cpu")
        np.testing.assert_array_equal(d, d0)
        want = reference.sssp_dijkstra(g, root)
        np.testing.assert_array_equal(np.isfinite(d), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(d[fin], want[fin], rtol=1e-5, atol=0)
        assert [int(x) for x in st] == [int(x) for x in st0]
        assert check_tree(g, root, d, par, "sssp") == 0


def test_replicas_agree_at_the_fixpoint(graph):
    """K10 reads d[v] at the edge's replica slot: every replica holds the
    root replica's value once the run has collapsed them."""
    g, part, roots = graph
    from repro_torch.core import actions
    init = engine.init_values(part, actions.SSSP, {roots[0]: 0.0})
    val, _ = engine.run_stacked(
        actions.SSSP, part, init,
        engine.EngineConfig(use_pallas=True, grid_mode="device_worklist"),
        device="cpu")
    flat = val.reshape(-1).numpy()
    sv = np.asarray(part.slot_vertex).reshape(-1)
    live = sv >= 0
    np.testing.assert_array_equal(flat[live],
                                  flat[np.asarray(part.root_flat)[sv[live]]])


def _tie_graph():
    """Vertices reached only along ties: 0 -0.5-> 1 -0-> 2 -0-> 3 (a
    zero-weight chain, 2 and 3 also joined both ways by zero weights),
    0 -1-> 4 -1e-9-> 5 (a weight absorbed by rounding: d[5] = fl32(1 +
    1e-9) = 1), a self-loop of weight 0 on 3, and a longer way into 3
    (0 -2-> 6 -2-> 3).  Vertex 7 is unreached."""
    edges = [(0, 1, 0.5), (1, 2, 0.0), (2, 3, 0.0), (3, 2, 0.0),
             (0, 4, 1.0), (4, 5, 1e-9), (3, 3, 0.0), (0, 6, 2.0),
             (6, 3, 2.0), (5, 4, 0.25)]
    src, dst, w = (np.array(x) for x in zip(*edges))
    return COOGraph(8, src.astype(np.int32), dst.astype(np.int32),
                    w.astype(np.float32))


def _tie_rounds(app):
    snap = obs.registry().snapshot().get("tree_tie_rounds_total")
    if not snap:
        return 0
    return sum(v for k, v in snap["series"].items() if app in str(k))


@pytest.mark.parametrize("grid_mode", GRID_MODES)
@pytest.mark.parametrize("shards", [1, 2])
def test_ties_still_give_a_tree_and_count_their_rounds(grid_mode, shards,
                                                       monkeypatch):
    g = _tie_graph()
    part = build_partition(g, PartitionConfig(num_shards=shards,
                                              rpvo_max=2))
    cfg = engine.EngineConfig(use_pallas=True, grid_mode=grid_mode)
    launched = []
    run = k10.tree_parents
    monkeypatch.setattr(k10, "tree_parents",
                        lambda *a, **k: launched.append(k) or run(*a, **k))
    before = _tie_rounds("sssp_tree")
    (d, par), _, _ = apps.sssp_tree(g, 0, part=part, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(
        d, [0, 0.5, 0.5, 0.5, 1.0, 1.0, 2.0, np.inf])
    # round 1: 2 <- 1 and 5 <- 4; round 2: 3 <- 2; then none is left
    np.testing.assert_array_equal(par, [0, 0, 1, 2, 0, 4, 0, -1])
    assert check_tree(g, 0, d, par, "sssp") == 0
    assert _tie_rounds("sssp_tree") - before == 2
    assert len(launched) == 3 and "before" not in launched[0]
    launched.clear()
    before = _tie_rounds("bfs_tree")
    (lv, par), _, _ = apps.bfs_tree(g, 0, part=part, cfg=cfg, device="cpu")
    assert check_tree(g, 0, lv, par, "bfs") == 0
    assert len(launched) == 1 and _tie_rounds("bfs_tree") == before


def test_one_launch_a_search_without_ties(graph, monkeypatch):
    g, part, roots = graph
    launched = []
    run = k10.tree_parents
    monkeypatch.setattr(k10, "tree_parents",
                        lambda *a, **k: launched.append(1) or run(*a, **k))
    apps.bfs_tree(g, roots[0], part=part, device="cpu",
                  cfg=engine.EngineConfig(use_pallas=True,
                                          grid_mode="device_worklist"))
    assert launched == [1]


def _loop(val, src, dst, w, mask, sv, parent, weighted, before=None):
    """K10's rule one edge at a time, in float32."""
    out = parent.clone()
    for e in range(src.numel()):
        if not mask[e]:
            continue
        du, dv = val[src[e]], val[dst[e]]
        c = w[e] if weighted else torch.tensor(1.0)
        if not (torch.isfinite(dv) and (du + c) == dv):
            continue
        u, v = int(sv[src[e]]), int(sv[dst[e]])
        if before is None:
            ok = bool(du < dv)
        else:
            ok = bool(du == dv) and before[u] != k10.NONE \
                and before[v] == k10.NONE
        if ok:
            out[v] = min(int(out[v]), u)
    return out


def _k10_case(seed, v=300, e=4000, n=120):
    rng = np.random.default_rng(seed)
    # few distinct values, so equalities and ties are common
    val = rng.choice(np.float32([0, 0.25, 0.5, 0.75, 1.0, 1.25, np.inf]),
                     v).astype(np.float32)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = np.sort(rng.integers(0, v, e)).astype(np.int32)
    w = rng.choice(np.float32([0, 0.25, 0.5, 1e-9]), e).astype(np.float32)
    mask = rng.random(e) < 0.9
    sv = rng.integers(0, n, v).astype(np.int32)
    parent = np.where(rng.random(n) < 0.3, rng.integers(0, n, n),
                      k10.NONE).astype(np.int32)
    return [torch.as_tensor(x) for x in (val, src, dst, w, mask, sv, parent)]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k10_plain_version_equals_a_loop(seed, weighted, ties):
    val, src, dst, w, mask, sv, parent = _k10_case(seed)
    before = parent.clone() if ties else None
    want = _loop(val, src, dst, w, mask, sv, parent, weighted, before)
    got = k10.tree_parents(val, src, dst, w, mask, sv, parent.clone(),
                           weighted, before=before)
    assert torch.equal(got, want)
    # the case offers parents, but a unit step never ties (BFS)
    assert torch.equal(want, parent) == (ties and not weighted)


def test_k10_refuses_misshapen_tables():
    val, src, dst, w, mask, sv, parent = _k10_case(0)
    with pytest.raises(ValueError):
        k10.tree_parents(val, src.long(), dst, w, mask, sv, parent, True)
    with pytest.raises(ValueError):
        k10.tree_parents(val, src, dst[:-1], w, mask, sv, parent, True)


def test_tree_tables_do_not_travel_with_a_pickled_partition(graph):
    g, part, roots = graph
    apps.bfs_tree(g, roots[0], part=part, device="cpu")
    assert vars(part)[engine._RESIDENT]
    assert not vars(pickle.loads(pickle.dumps(part)))[engine._RESIDENT]


def _table_requests():
    snap = obs.registry().snapshot().get("engine_device_tables_total")
    return {str(k): v for k, v in snap["series"].items()} if snap else {}


def test_tree_reads_the_resident_tables_and_uploads_nothing_more(graph):
    """The pass reads ``slot_vertex`` and ``root_flat`` from the
    partition's one resident ``DeviceArrays``: a second search is a hit
    and the partition keeps no other device tables."""
    g, part, roots = graph
    engine.drop_device_arrays(part)
    before = _table_requests()
    apps.sssp_tree(g, roots[0], part=part, device="cpu")
    apps.bfs_tree(g, roots[1], part=part, device="cpu")
    after = _table_requests()
    grew = {k: after[k] - before.get(k, 0) for k in after}
    assert sorted(v for v in grew.values() if v) == [1, 1]
    assert grew[next(k for k in grew if "upload" in k)] == 1
    arrays = engine.device_arrays(part, "cpu")
    np.testing.assert_array_equal(arrays.slot_vertex.numpy(),
                                  part.slot_vertex)
    assert arrays.slot_vertex.dtype == torch.int32
    np.testing.assert_array_equal(arrays.root_flat.numpy(), part.root_flat)
    assert [k for k in vars(part) if "tree" in k] == []


@pytest.mark.parametrize("shard", [None, 1])
def test_device_arrays_hold_the_tree_tables(graph, shard):
    g, part, roots = graph
    arrays = engine.DeviceArrays.from_partition(part, "cpu", shard=shard)
    want = part.slot_vertex if shard is None else part.slot_vertex[1:2]
    np.testing.assert_array_equal(arrays.slot_vertex.numpy(), want)
    np.testing.assert_array_equal(arrays.root_flat.numpy(), part.root_flat)


def test_a_tie_round_that_parents_nothing_raises(monkeypatch):
    """Values and K10's sums that disagree leave reached vertices that
    no tie edge can parent: the pass raises instead of returning -1."""
    g = _tie_graph()
    part = build_partition(g, PartitionConfig(num_shards=1, rpvo_max=2))
    run = k10.tree_parents
    monkeypatch.setattr(
        k10, "tree_parents",
        lambda *a, before=None, **k: a[6] if before is not None
        else run(*a, **k))
    with pytest.raises(RuntimeError, match="3 reached vertices have no "
                       "parent after 1 tie rounds"):
        apps.sssp_tree(g, 0, part=part, device="cpu")


@pytest.mark.parametrize("app", ["bfs_tree", "sssp_tree"])
def test_tree_apps_without_device_need_cuda(monkeypatch, app):
    g = generators.ring(16)
    part = build_partition(g, PartitionConfig(num_shards=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(apps, app)(g, 0, part=part)
    with pytest.raises(NotImplementedError):
        getattr(apps, app)(g, 0, part=part, device="cpu", mesh=object())


def test_app_tree_nests_under_app_call_and_counts_a_pass(graph):
    g, part, roots = graph

    def passes():
        snap = obs.registry().snapshot().get("tree_passes_total")
        return {str(k): v for k, v in snap["series"].items()} if snap else {}
    before = passes()
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="device_worklist")
    with obs.recording(rounds=False) as rec:
        apps.bfs_tree(g, roots[0], part=part, cfg=cfg, device="cpu")
        apps.sssp_tree(g, roots[1], part=part, cfg=cfg, device="cpu")
    after = passes()
    grew = {k: after[k] - before.get(k, 0) for k in after}
    assert sorted(grew.values()) == [1, 1]
    assert any("bfs_tree" in k for k in grew) and \
        any("sssp_tree" in k for k in grew)
    spans = {e["args"]["id"]: e for e in rec.tracer.events()
             if e["ph"] == "X" and "parent" in e["args"]}
    trees = [e for e in spans.values() if e["name"] == "app.tree"]
    assert [e["args"]["app"] for e in trees] == ["bfs_tree", "sssp_tree"]
    for e in trees:
        call = spans[e["args"]["parent"]]
        assert call["name"] == "app.call"
        assert call["args"]["app"] == e["args"]["app"]
        assert call["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= call["ts"] + call["dur"] + 1e-3


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed,v,e,n", [(0, 300, 4000, 120),
                                        (1, 5000, 200_000, 3000),
                                        (2, 1, 1, 1), (3, 70, 33, 9)])
def test_k10_on_card_equals_its_plain_version(dev, seed, v, e, n, weighted,
                                              ties):
    case = _k10_case(seed, v, e, n)
    before = case[-1].clone() if ties else None
    want = k10.tree_parents(*case[:-1], case[-1].clone(), weighted,
                            before=before)
    k10.launches = 0
    got = k10.tree_parents(*[x.to(dev) for x in case[:-1]],
                           case[-1].to(dev), weighted,
                           before=before.to(dev) if ties else None)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and k10.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("app,oracle", [("bfs_tree", "bfs"),
                                        ("sssp_tree", "sssp")])
def test_tree_apps_on_card_equal_the_cpu_run(dev, app, oracle):
    g = _graph500_like(12, 5)
    part = build_partition(g, PartitionConfig(num_shards=8, rpvo_max=4))
    root = int(np.argmax(g.out_degrees()))
    cfg = engine.EngineConfig(use_pallas=True, grid_mode="device_worklist")
    k10.launches = 0
    (val, par), st, _ = getattr(apps, app)(g, root, part=part, cfg=cfg,
                                           device=dev)
    assert k10.launches >= 1
    (val_c, par_c), st_c, _ = getattr(apps, app)(g, root, part=part,
                                                 cfg=cfg, device="cpu")
    np.testing.assert_array_equal(val, val_c)
    np.testing.assert_array_equal(par, par_c)
    val0, _, _ = getattr(apps, oracle)(g, root, part=part, cfg=cfg,
                                       device=dev)
    np.testing.assert_array_equal(val, val0)
    assert check_tree(g, root, val, par,
                      "bfs" if oracle == "bfs" else "sssp") == 0
