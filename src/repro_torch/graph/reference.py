"""Oracle implementations (the paper verifies against NetworkX; we verify
against these — plain numpy/heapq, no JAX).

Also produces per-iteration *frontier traces* (which vertices improved at
each relaxation round) consumed by the AM-CCA cost model to replay the
paper's message-level experiments.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.graph.graph import COOGraph

UNREACHED = np.iinfo(np.int32).max
INF = np.float32(np.inf)


def bfs_levels(g: COOGraph, root: int) -> np.ndarray:
    """BFS level per vertex; UNREACHED if not reachable from root."""
    indptr, indices, _ = g.csr()
    level = np.full(g.n, UNREACHED, dtype=np.int64)
    level[root] = 0
    frontier = [root]
    lvl = 0
    while frontier:
        nxt = []
        for u in frontier:
            for v in indices[indptr[u] : indptr[u + 1]]:
                if level[v] == UNREACHED:
                    level[v] = lvl + 1
                    nxt.append(int(v))
        frontier = nxt
        lvl += 1
    return level


def sssp_dijkstra(g: COOGraph, root: int) -> np.ndarray:
    """Single-source shortest paths (non-negative weights)."""
    indptr, indices, weights = g.csr()
    dist = np.full(g.n, np.inf, dtype=np.float64)
    dist[root] = 0.0
    pq = [(0.0, root)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for e in range(indptr[u], indptr[u + 1]):
            v = int(indices[e])
            nd = d + float(weights[e])
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist.astype(np.float64)


def pagerank(g: COOGraph, damping: float = 0.85, iters: int = 30) -> np.ndarray:
    """Power-iteration PageRank with the paper's per-iteration semantics:
    each vertex sends score/out_degree along out-edges; dangling vertices'
    mass is NOT redistributed (matches the message-count formulation of
    Listing 10, where a vertex only diffuses what it receives)."""
    out_deg = g.out_degrees().astype(np.float64)
    score = np.full(g.n, 1.0 / g.n, dtype=np.float64)
    base = (1.0 - damping) / g.n
    for _ in range(iters):
        contrib = np.where(out_deg > 0, score / np.maximum(out_deg, 1), 0.0)
        incoming = np.zeros(g.n, dtype=np.float64)
        np.add.at(incoming, g.dst, contrib[g.src])
        score = base + damping * incoming
    return score


def connected_components(g: COOGraph) -> np.ndarray:
    """Weakly connected components: per-vertex label = min vertex id in
    the component (edges treated as undirected). Plain numpy BFS."""
    indptr, indices, _ = COOGraph(
        g.n, np.concatenate([g.src, g.dst]),
        np.concatenate([g.dst, g.src]), None).csr()
    label = np.full(g.n, -1, dtype=np.int64)
    for v in range(g.n):
        if label[v] >= 0:
            continue
        label[v] = v            # v is the smallest unvisited id -> the label
        stack = [v]
        while stack:
            u = stack.pop()
            for w in indices[indptr[u] : indptr[u + 1]]:
                if label[w] < 0:
                    label[w] = v
                    stack.append(int(w))
    return label


def personalized_pagerank(g: COOGraph, seed: int, damping: float = 0.85,
                          tol: float = 1e-10,
                          max_iters: int = 1000) -> np.ndarray:
    """Personalized PageRank to tolerance: score = (1-d) * e_seed +
    d * A^T (score / outdeg), dangling mass not redistributed (the same
    per-iteration semantics as ``pagerank`` above)."""
    out_deg = g.out_degrees().astype(np.float64)
    score = np.zeros(g.n, dtype=np.float64)
    score[seed] = 1.0
    base = np.zeros(g.n, dtype=np.float64)
    base[seed] = 1.0 - damping
    for _ in range(max_iters):
        contrib = np.where(out_deg > 0, score / np.maximum(out_deg, 1), 0.0)
        incoming = np.zeros(g.n, dtype=np.float64)
        np.add.at(incoming, g.dst, contrib[g.src])
        new = base + damping * incoming
        delta = np.abs(new - score).max()
        score = new
        if delta <= tol:
            break
    return score


def bfs_frontier_trace(g: COOGraph, root: int) -> list[np.ndarray]:
    """List of per-round frontiers (vertex id arrays). Round k's frontier
    diffuses along its out-edges in round k+1 — the message trace the
    AM-CCA cost model replays."""
    level = bfs_levels(g, root)
    out = []
    lvl = 0
    while True:
        f = np.nonzero(level == lvl)[0].astype(np.int32)
        if f.size == 0:
            break
        out.append(f)
        lvl += 1
    return out


def sssp_relax_trace(g: COOGraph, root: int) -> list[np.ndarray]:
    """Bellman-Ford style rounds: vertices whose distance improved in round k.

    This is the synchronous-relaxation schedule our TPU engine executes;
    the asynchronous execution reaches the same fixpoint (monotone min-plus).
    """
    indptr, indices, weights = g.csr()
    dist = np.full(g.n, np.inf)
    dist[root] = 0.0
    changed = np.zeros(g.n, dtype=bool)
    changed[root] = True
    trace = [np.array([root], dtype=np.int32)]
    while changed.any():
        new = dist.copy()
        src_active = np.nonzero(changed)[0]
        for u in src_active:
            for e in range(indptr[u], indptr[u + 1]):
                v = int(indices[e])
                nd = dist[u] + float(weights[e])
                if nd < new[v]:
                    new[v] = nd
        changed = new < dist
        dist = new
        if changed.any():
            trace.append(np.nonzero(changed)[0].astype(np.int32))
    return trace
