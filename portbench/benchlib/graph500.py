"""Graph500 v3's validation of a search's output, and the least bytes of
the pass that makes its parent array: plain torch on the benchmark's own
CSR, nothing of the program under test.

``validate_tree`` counts the vertices that break the specification's
checks of a BFS or SSSP parent array against the search's values: the
root is its own parent; a vertex is unreached exactly where its parent is
-1; ``(parents[v], v)`` is an input edge; a BFS parent's level is one
less; an SSSP parent's distance plus the least weight of the edges from
it differs from ``d[v]`` by at most ``rel_tol * d[v]``; every chain of
parents reaches the root.  ``distance_errors`` compares SSSP distances
with the float64 reference's, and ``swap_parents`` is the ``parents``
control: each reached vertex's parent swapped for another reached
vertex.  ``tree_bytes`` counts what a parent pass must move at least.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchlib.bounds import ID, VAL
from benchlib.reference import CSR

PORT_UNREACHED = np.iinfo(np.int32).max     # the port's unreached level
_INDEX = "_graph500_edge_index"


def edge_index(csr: CSR) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted distinct ``src * n + dst`` keys, the least float64 weight
    of each key's edges), made once per CSR and kept on it."""
    got = getattr(csr, _INDEX, None)
    if got is None:
        n = csr.n
        src = torch.repeat_interleave(
            torch.arange(n, device=csr.indptr.device), csr.out_deg)
        key, order = torch.sort(src * n + csr.dst)
        keys, inv = torch.unique_consecutive(key, return_inverse=True)
        w_min = torch.full(keys.shape, math.inf, dtype=torch.float64,
                           device=keys.device).scatter_reduce_(
            0, inv, csr.weight[order], "amin")
        got = (keys, w_min)
        setattr(csr, _INDEX, got)
    return got


def _reached(values: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bfs":
        return (values >= 0) & (values < PORT_UNREACHED)
    if kind == "sssp":
        return torch.isfinite(values)
    raise ValueError(f"unknown search kind {kind!r}")


def validate_tree(csr: CSR, root: int, values, parents, kind: str,
                  rel_tol: float) -> int:
    """Vertices of a search from ``root`` whose parent breaks Graph500's
    validation (each counted once; a wrong root counts one).  ``values``:
    BFS levels (unreached: negative or the int32 maximum) or SSSP
    distances (unreached: inf); ``parents``: int (n,), -1 where
    unreached.  Answers of another shape count all ``n``."""
    n, dev = csr.n, csr.indptr.device
    if np.shape(values) != (n,) or np.shape(parents) != (n,):
        return n
    val = torch.as_tensor(np.asarray(values)).to(dev)
    reached = _reached(val, kind)
    val = val.to(torch.float64)
    par = torch.as_tensor(np.asarray(parents)).to(dev, torch.int64)
    ids = torch.arange(n, device=dev)
    inside = (par >= 0) & (par < n)
    bad = (par >= n) | (par < -1) | (reached != (par >= 0))
    bad[root] |= par[root] != root
    check = reached & inside & (ids != root)
    keys, w_min = edge_index(csr)
    p = par.clamp(0, n - 1)
    key = p * n + ids
    at = torch.searchsorted(keys, key).clamp(max=max(keys.numel() - 1, 0))
    edge = keys[at] == key if keys.numel() else torch.zeros_like(check)
    if kind == "bfs":
        rule = val[p] == val - 1
    else:
        rule = (val[p] + w_min[at] - val).abs() <= rel_tol * val
    bad |= check & ~(edge & rule)
    # pointer jumping: after ceil(log2 n) squarings every vertex whose
    # chain reaches the root within n steps points at the root
    jump = torch.where(inside, par, ids)
    jump[root] = root
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        jump = jump[jump]
    bad |= reached & (jump != root)
    return int(bad.sum())


def distance_errors(got, want: torch.Tensor) -> tuple[int, float]:
    """(vertices reached on one side only, the largest relative gap over
    vertices with a positive reference distance) of SSSP distances
    against the float64 reference's.  A vertex at reference distance 0
    must read 0 exactly, else the gap is ``inf``; an answer of another
    shape counts every vertex and ``inf``."""
    if got is None or np.shape(got) != tuple(want.shape):
        return int(want.numel()), math.inf
    g = torch.as_tensor(np.asarray(got, np.float64)).to(want.device)
    fin_g, fin_w = torch.isfinite(g), torch.isfinite(want)
    reach = int((fin_g != fin_w).sum())
    both = fin_g & fin_w
    pos = both & (want > 0)
    gap = float(((g[pos] - want[pos]).abs() / want[pos]).max()) \
        if bool(pos.any()) else 0.0
    if bool((both & (want == 0) & (g != 0)).any()):
        gap = math.inf
    return reach, gap


def swap_parents(values, parents, kind: str) -> np.ndarray:
    """The ``parents`` control: each reached vertex's parent swapped for
    another reached vertex, the next one in id order (the first for the
    last)."""
    out = np.array(parents, dtype=np.int64, copy=True)
    r = np.flatnonzero(_reached(torch.as_tensor(np.asarray(values)),
                                kind).numpy())
    if r.size > 1:
        out[r] = np.roll(r, -1)
    return out


def tree_bytes(n: int, reached: int, edges: int, weighted: bool) -> float:
    """Least bytes of one parent pass: for each edge out of a reached
    vertex its destination id, its weight where weighted and the
    destination's value; for each reached vertex its offsets, its value
    and its parent written; ``n`` ids for the parent array."""
    per_edge = ID + (VAL if weighted else 0) + VAL
    return edges * per_edge + reached * (2 * ID + VAL + ID) + n * ID
