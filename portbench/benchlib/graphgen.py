"""The benchmark's own graph generator: RMAT / Kronecker edges made with
``torch`` from a seed, on whatever device the generator lives on.

A configuration file names the recursive quadrant shares (a, b, c, d), the
scale, the edge factor, and the switches that tell PaRMAT's graphs from
Graph500's: ``permute`` (random vertex labels), ``symmetrize`` (both
directions of every edge), ``drop_duplicates`` and the edge weights.
Self-loops are kept, as both generators make them.  The edges end
sorted by (source, destination) after one sort on the device; nothing
passes over the edges on the host.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Graph:
    """A directed graph as COO tensors on one device, sorted by (src, dst):
    ``src``, ``dst`` int64 (E,), ``weight`` float32 (E,)."""

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())

    def out_degrees(self) -> torch.Tensor:
        return torch.bincount(self.src, minlength=self.n)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def kronecker_edges(scale: int, m: int, a: float, b: float, c: float,
                    gen: torch.Generator):
    """``m`` edges of the 2**scale-vertex recursive matrix: at each of the
    ``scale`` levels an edge falls in quadrant (0,0), (0,1), (1,0), (1,1)
    with shares a, b, c, 1 - a - b - c.  Returns int64 (src, dst)."""
    dev = gen.device
    src = torch.zeros(m, dtype=torch.int64, device=dev)
    dst = torch.zeros(m, dtype=torch.int64, device=dev)
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=dev)
        src_bit = r >= a + b
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src, dst


def make_graph(cfg: dict, seed: int, device) -> Graph:
    """The configuration's graph from ``seed``.  ``cfg`` keys: ``scale``,
    ``edge_factor``, ``a``, ``b``, ``c``, ``d``, ``permute``,
    ``symmetrize``, ``drop_duplicates``, ``weight``
    ({"kind": "integer" | "uniform", "low", "high"})."""
    gen = generator(seed, device)
    scale, n = int(cfg["scale"]), 1 << int(cfg["scale"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    if abs(a + b + c + float(cfg["d"]) - 1.0) > 1e-9:
        raise ValueError("quadrant shares a + b + c + d must be 1")
    src, dst = kronecker_edges(scale, int(cfg["edge_factor"]) * n, a, b, c,
                               gen)
    if cfg.get("permute"):
        perm = torch.randperm(n, generator=gen, device=gen.device)
        src, dst = perm[src], perm[dst]
    if cfg.get("symmetrize"):
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    key = src * n + dst
    key = torch.unique(key) if cfg.get("drop_duplicates") \
        else torch.sort(key).values
    src, dst = key // n, key % n
    w = cfg["weight"]
    if w["kind"] == "integer":
        weight = torch.randint(int(w["low"]), int(w["high"]) + 1, key.shape,
                               generator=gen, device=gen.device)
    elif w["kind"] == "uniform":
        weight = torch.rand(key.shape, generator=gen, device=gen.device) \
            * (float(w["high"]) - float(w["low"])) + float(w["low"])
    else:
        raise ValueError(f"unknown weight kind {w['kind']!r}")
    return Graph(n, src, dst, weight.to(torch.float32))
