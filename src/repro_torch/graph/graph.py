"""Directed graph container + degree statistics (paper Table 1).

The container is a plain COO edge list in numpy: the partitioner
(``repro_torch.core.partition``) turns it into the sharded RPVO/Rhizome layout,
and ``repro_torch.graph.reference`` runs oracle algorithms on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class COOGraph:
    """A directed graph as parallel COO arrays.

    Attributes:
      n: number of vertices (ids are 0..n-1).
      src, dst: int32 arrays of shape (E,).
      weight: float32 array of shape (E,) (SSSP weights; 1.0 if unweighted).
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        if self.weight is None:
            self.weight = np.ones(self.src.shape, dtype=np.float32)
        self.weight = np.asarray(self.weight, dtype=np.float32)
        assert self.src.shape == self.dst.shape == self.weight.shape
        if self.src.size:
            assert int(self.src.max()) < self.n and int(self.dst.max()) < self.n
            assert int(self.src.min()) >= 0 and int(self.dst.min()) >= 0

    @property
    def num_edges(self) -> int:
        return int(self.src.size)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n).astype(np.int64)

    def with_random_weights(self, low: int = 1, high: int = 10, seed: int = 0) -> "COOGraph":
        """Paper §6.1: 'random weights are assigned to the edges ... to make
        the SSSP meaningful'."""
        rng = np.random.default_rng(seed)
        w = rng.integers(low, high + 1, size=self.src.shape).astype(np.float32)
        return COOGraph(self.n, self.src, self.dst, w)

    def dedup(self) -> "COOGraph":
        """Remove duplicate (src, dst) pairs, keeping the first weight."""
        key = self.src.astype(np.int64) * self.n + self.dst
        _, idx = np.unique(key, return_index=True)
        idx.sort()
        return COOGraph(self.n, self.src[idx], self.dst[idx], self.weight[idx])

    def csr(self):
        """Return (indptr, indices, weights) sorted by src (out-adjacency)."""
        order = np.argsort(self.src, kind="stable")
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.src, minlength=self.n), out=indptr[1:])
        return indptr, self.dst[order], self.weight[order]


def _pctile_pair(deg: np.ndarray, pct: float = 99.0) -> tuple[float, float]:
    return pct, float(np.percentile(deg, pct)) if deg.size else 0.0


def degree_stats(g: COOGraph) -> dict:
    """Table-1 style statistics: mean/std/max/<%, %tile> for in & out degrees."""
    kin = g.in_degrees()
    kout = g.out_degrees()
    stats = {"vertices": g.n, "edges": g.num_edges}
    for name, deg in (("in", kin), ("out", kout)):
        pct, tile = _pctile_pair(deg)
        stats[name] = {
            "mean": float(deg.mean()) if deg.size else 0.0,
            "std": float(deg.std()) if deg.size else 0.0,
            "max": int(deg.max()) if deg.size else 0,
            "pctile": (pct, tile),
        }
    # skew indicator used throughout: max/mean in-degree
    stats["in_skew"] = stats["in"]["max"] / max(stats["in"]["mean"], 1e-9)
    return stats
