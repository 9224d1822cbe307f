"""The benchmark's generator and reference on the CPU, at small sizes."""
import collections
import heapq
import json
import pathlib

import numpy as np
import pytest
import torch

from benchlib import graphgen, reference

CONFIGS = pathlib.Path(__file__).parent / "configs"
CPU = torch.device("cpu")


def config(name, **over):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("name", ["parmat-s22", "graph500-s22"])
def test_same_seed_same_graph(name):
    a = graphgen.make_graph(config(name, scale=8), 2**31 + 7, CPU)
    b = graphgen.make_graph(config(name, scale=8), 2**31 + 7, CPU)
    c = graphgen.make_graph(config(name, scale=8), 2**31 + 8, CPU)
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.src, c.src) or not torch.equal(a.dst, c.dst)


@pytest.mark.parametrize("name", ["parmat-s22", "graph500-s22"])
def test_quadrant_shares(name):
    cfg = config(name, scale=10, permute=False, symmetrize=False,
                 drop_duplicates=False)
    g = graphgen.make_graph(cfg, 11, CPU)
    half = g.n // 2
    hi_s, hi_d = g.src >= half, g.dst >= half
    share = {q: float(m.float().mean()) for q, m in {
        "a": ~hi_s & ~hi_d, "b": ~hi_s & hi_d,
        "c": hi_s & ~hi_d, "d": hi_s & hi_d}.items()}
    for q in "abcd":
        assert abs(share[q] - cfg[q]) < 0.02, (q, share)


def test_graph500_is_symmetric_and_permuted_with_duplicates_kept():
    g = graphgen.make_graph(config("graph500-s22", scale=9), 5, CPU)
    pairs = collections.Counter(zip(g.src.tolist(), g.dst.tolist()))
    # both directions of every edge, as often as it was drawn
    assert all(pairs[(d, s)] == c for (s, d), c in pairs.items())
    assert max(pairs.values()) > 1                        # duplicates kept
    assert g.num_edges == 2 * 16 * g.n                    # none dropped
    plain = graphgen.make_graph(config("graph500-s22", scale=9,
                                       permute=False), 5, CPU)
    # the labels moved: the hub is no longer vertex 0
    assert int(torch.argmax(plain.out_degrees())) == 0
    assert int(torch.argmax(g.out_degrees())) != 0


def test_parmat_drops_duplicates_only():
    cfg = config("parmat-s22", scale=9)
    g = graphgen.make_graph(cfg, 5, CPU)
    pairs = list(zip(g.src.tolist(), g.dst.tolist()))
    assert len(set(pairs)) == len(pairs) == g.num_edges
    assert pairs == sorted(pairs)
    kept = graphgen.make_graph(dict(cfg, drop_duplicates=False), 5, CPU)
    assert kept.num_edges == 16 * kept.n > g.num_edges
    assert set(zip(kept.src.tolist(), kept.dst.tolist())) == set(pairs)


def test_weights_follow_the_config():
    g = graphgen.make_graph(config("parmat-s22", scale=8), 3, CPU)
    w = g.weight
    assert w.dtype == torch.float32
    assert float(w.min()) >= 1 and float(w.max()) <= 10
    assert torch.equal(w, w.round())


def brute(n, src, dst, w, root):
    """Dijkstra and BFS by the book, on python lists."""
    adj = [[] for _ in range(n)]
    for s, d, x in zip(src, dst, w):
        adj[s].append((d, x))
    level = [-1] * n
    level[root] = 0
    q = [root]
    for u in q:
        for v, _ in adj[u]:
            if level[v] < 0:
                level[v] = level[u] + 1
                q.append(v)
    dist = [float("inf")] * n
    dist[root] = 0.0
    pq = [(0.0, root)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for v, x in adj[u]:
            if d + x < dist[v]:
                dist[v] = d + x
                heapq.heappush(pq, (d + x, v))
    return level, dist


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_searches_against_brute_force(seed):
    g = graphgen.make_graph(config("parmat-s22", scale=7), seed, CPU)
    csr = reference.CSR.from_coo(g.n, g.src, g.dst, g.weight)
    root = int(torch.argmax(g.out_degrees()))
    level, dist = brute(g.n, g.src.tolist(), g.dst.tolist(),
                        g.weight.tolist(), root)
    b = reference.bfs(csr, root)
    s = reference.sssp(csr, root)
    assert b.values.tolist() == level
    assert s.values.tolist() == dist
    reached = [v for v in range(g.n) if level[v] >= 0]
    deg = g.out_degrees().tolist()
    assert b.reached == s.reached == len(reached)
    assert b.edges == s.edges == sum(deg[v] for v in reached)


def test_reference_pagerank_against_dense_power_iteration():
    g = graphgen.make_graph(config("graph500-s22", scale=6), 9, CPU)
    n = g.n
    A = np.zeros((n, n))
    np.add.at(A, (g.dst.numpy(), g.src.numpy()), 1.0)
    deg = A.sum(axis=0)
    M = A / np.where(deg > 0, deg, 1.0)
    x = np.full(n, 1.0 / n)
    for _ in range(30):
        x = 0.15 / n + 0.85 * (M @ x)
    got = reference.pagerank(n, g.src, g.dst, 0.85, 30).numpy()
    np.testing.assert_allclose(got, x, rtol=1e-12)


def test_stopping_early_is_what_the_stale_control_does():
    g = graphgen.make_graph(config("parmat-s22", scale=7), 4, CPU)
    csr = reference.CSR.from_coo(g.n, g.src, g.dst, g.weight)
    root = int(torch.argmax(g.out_degrees()))
    full = reference.bfs(csr, root)
    short = reference.bfs(csr, root, max_rounds=full.rounds - 1)
    assert int((short.values != full.values).sum()) > 0
