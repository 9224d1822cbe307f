"""The plain reference: BFS levels, SSSP distances and PageRank scores
computed with ``torch`` from the benchmark's own COO graph.

It shares nothing with the program under test: it never sees a partition,
and it imports nothing of the port.  BFS and SSSP run level by level from
a CSR built here; SSSP relaxes in float64, PageRank iterates in float64
(``dtype`` lowers both for the control).  Each search also returns what
the byte bound and the TEPS count need: the vertices it reached and the
edges out of them.
"""
from __future__ import annotations

import dataclasses

import torch

UNREACHED = -1


@dataclasses.dataclass
class CSR:
    n: int
    indptr: torch.Tensor      # int64 (n + 1,)
    dst: torch.Tensor         # int64 (E,), grouped by source
    weight: torch.Tensor      # float64 (E,)
    out_deg: torch.Tensor     # int64 (n,)

    @classmethod
    def from_coo(cls, n, src, dst, weight) -> "CSR":
        order = torch.argsort(src, stable=True)
        deg = torch.bincount(src, minlength=n)
        indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
        indptr[1:] = torch.cumsum(deg, 0)
        return cls(n, indptr, dst[order], weight[order].to(torch.float64),
                   deg)

    def edges_out(self, frontier: torch.Tensor) -> torch.Tensor:
        """Edge ids (into ``dst``) of every edge out of ``frontier``."""
        deg = self.out_deg[frontier]
        total = int(deg.sum())
        if total == 0:
            return torch.empty(0, dtype=torch.int64, device=deg.device)
        start = torch.repeat_interleave(self.indptr[frontier], deg)
        first = torch.repeat_interleave(torch.cumsum(deg, 0) - deg, deg)
        return start + torch.arange(total, device=deg.device) - first


@dataclasses.dataclass
class Search:
    values: torch.Tensor      # levels (int64, UNREACHED) or distances
    reached: int              # vertices reached, the root included
    edges: int                # edges out of reached vertices (TEPS count)
    rounds: int               # rounds that changed some value


def bfs(csr: CSR, root: int, max_rounds: int | None = None) -> Search:
    """Level-synchronous BFS.  ``max_rounds`` stops early (the control)."""
    dev = csr.indptr.device
    level = torch.full((csr.n,), UNREACHED, dtype=torch.int64, device=dev)
    level[root] = 0
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    rounds = 0
    while frontier.numel() and (max_rounds is None or rounds < max_rounds):
        nbr = csr.dst[csr.edges_out(frontier)]
        nbr = torch.unique(nbr[level[nbr] == UNREACHED])
        if not nbr.numel():
            break
        level[nbr] = rounds + 1
        frontier = nbr
        rounds += 1
    reached = level != UNREACHED
    return Search(level, int(reached.sum()),
                  int(csr.out_deg[reached].sum()), rounds)


def sssp(csr: CSR, root: int, dtype=torch.float64,
         max_rounds: int | None = None) -> Search:
    """Frontier Bellman-Ford: each round relaxes the edges out of the
    vertices whose distance fell in the last.  Exact in float64 for the
    configurations' weights; ``dtype`` computes in a lower precision (the
    control), ``max_rounds`` stops early."""
    dev = csr.indptr.device
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    dist = torch.full((csr.n,), float("inf"), dtype=dtype, device=dev)
    dist[root] = 0
    w = csr.weight.to(dtype)
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    rounds = 0
    while frontier.numel() and (max_rounds is None or rounds < max_rounds):
        e = csr.edges_out(frontier)
        src = torch.repeat_interleave(frontier, csr.out_deg[frontier])
        cand = dist[src] + w[e]
        best = torch.full_like(dist, inf).scatter_reduce(
            0, csr.dst[e], cand, reduce="amin")
        better = best < dist
        frontier = torch.nonzero(better).reshape(-1)
        if not frontier.numel():
            break
        dist = torch.where(better, best, dist)
        rounds += 1
    reached = torch.isfinite(dist)
    return Search(dist.to(torch.float64), int(reached.sum()),
                  int(csr.out_deg[reached].sum()), rounds)


def pagerank(n, src, dst, damping: float = 0.85, iters: int = 30,
             dtype=torch.float64) -> torch.Tensor:
    """Power iteration with the paper's semantics (Listing 10): every
    vertex starts at 1/n and sends score/out-degree along its out-edges;
    a dangling vertex's score is not passed on; each round sets
    score = (1 - damping)/n + damping * (sum of what arrived).  Returns
    float64 scores; ``dtype`` is the precision of the iteration."""
    deg = torch.bincount(src, minlength=n).to(dtype)
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0).to(dtype)
    score = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    base = torch.tensor((1.0 - damping) / n, dtype=dtype, device=src.device)
    for _ in range(iters):
        contrib = (score * inv)[src]
        incoming = torch.zeros_like(score).index_add_(0, dst, contrib)
        score = base + damping * incoming
    return score.to(torch.float64)
