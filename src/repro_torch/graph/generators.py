"""Synthetic graph generators matching the paper's datasets (§6.1).

RMAT with (a=0.45, b=0.25, c=0.15, d=0.15) as generated by PaRMAT, and
Erdős–Rényi via expected-degree sampling. ``ba_skewed`` is a heavy-tailed
preferential-attachment generator for tests that need extreme in-degree
skew at small n (the WK/R22 analog at laptop scale).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.graph import COOGraph


def rmat(scale: int, edge_factor: int = 16, a: float = 0.45, b: float = 0.25,
         c: float = 0.15, seed: int = 0, dedup: bool = True) -> COOGraph:
    """RMAT-<scale>: n = 2**scale vertices, edge_factor*n edges (paper: R18, R22)."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    d = 1.0 - (a + b + c)
    # Quadrant probabilities per bit: vectorized recursive descent.
    for bit in range(scale):
        r = rng.random(m)
        # quadrant: 0 -> (0,0), 1 -> (0,1), 2 -> (1,0), 3 -> (1,1)
        q = np.select([r < a, r < a + b, r < a + b + c], [0, 1, 2], default=3)
        src = (src << 1) | (q >> 1)
        dst = (dst << 1) | (q & 1)
        del r, q
    g = COOGraph(n, src.astype(np.int32), dst.astype(np.int32), None)
    if dedup:
        g = g.dedup()
    return g


def erdos_renyi(n: int, avg_degree: float = 9.0, seed: int = 0) -> COOGraph:
    """Directed Erdős–Rényi with expected out-degree ``avg_degree`` (paper: E18)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return COOGraph(n, src.astype(np.int32), dst.astype(np.int32), None).dedup()


def star(n: int, hub: int = 0, inward: bool = True) -> COOGraph:
    """All vertices point at ``hub`` (inward) or hub points at all (outward).

    The worst-case in-degree (or out-degree) skew — the rhizome stress test.
    """
    others = np.array([v for v in range(n) if v != hub], dtype=np.int32)
    hubs = np.full(others.shape, hub, dtype=np.int32)
    if inward:
        return COOGraph(n, others, hubs, None)
    return COOGraph(n, hubs, others, None)


def ring(n: int) -> COOGraph:
    src = np.arange(n, dtype=np.int32)
    dst = (src + 1) % n
    return COOGraph(n, src, dst.astype(np.int32), None)


def ba_skewed(n: int, m_per: int = 4, seed: int = 0) -> COOGraph:
    """Preferential attachment (Barabási–Albert flavored), directed toward
    earlier vertices — produces the heavy in-degree tail of WK/LJ at small n."""
    rng = np.random.default_rng(seed)
    src_list = []
    dst_list = []
    # seed clique
    k0 = max(2, m_per)
    for i in range(1, k0 + 1):
        src_list.append(i)
        dst_list.append(0)
    deg = np.zeros(n, dtype=np.float64)
    deg[0] = k0
    deg[1 : k0 + 1] = 1e-3
    for v in range(k0 + 1, n):
        p = deg[:v] / deg[:v].sum()
        targets = rng.choice(v, size=min(m_per, v), replace=False, p=p)
        for t in targets:
            src_list.append(v)
            dst_list.append(int(t))
            deg[t] += 1.0
        deg[v] += 1e-3
    return COOGraph(
        n,
        np.asarray(src_list, dtype=np.int32),
        np.asarray(dst_list, dtype=np.int32),
        None,
    ).dedup()
