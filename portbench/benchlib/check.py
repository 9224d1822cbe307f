"""The comparison that decides ``correct``: the program's answers against
the reference's, one number per kind of answer, each held to the limit
its traffic file states.

Levels, reachability and integer-weighted distances are exact, so their
number is the count of vertices that differ (limit 0).  PageRank scores
are compared by the largest relative gap to the float64 reference.  A
control puts a lower-precision or stale reference in the program's place
(``control_answer``, ``control_pagerank``); it has to come out not
correct.  A driver names the controls it offers (its ``CONTROLS``).
"""
from __future__ import annotations

import numpy as np
import torch

from benchlib import reference

PORT_UNREACHED = np.iinfo(np.int32).max     # the port's unreached level


def mismatches(kind: str, got, want: reference.Search, n: int) -> int:
    """Vertices whose answer differs from the reference's search (``want``
    is the BFS for 'bfs' and 'reachability', the SSSP for 'sssp').  An
    answer of another shape counts all ``n``."""
    if got is None or np.shape(got) != (n,):
        return n
    dev = want.values.device
    g = torch.as_tensor(np.asarray(got)).to(dev)
    if kind == "bfs":
        w = torch.where(want.values == reference.UNREACHED,
                        torch.tensor(PORT_UNREACHED, device=dev),
                        want.values)
    elif kind == "reachability":
        w = want.values != reference.UNREACHED
    elif kind == "sssp":
        w = want.values
    else:
        raise ValueError(f"unknown answer kind {kind!r}")
    return int((g != w).sum())


def max_rel_err(got, want: torch.Tensor) -> float:
    """Largest |got - want| / want over the vertices (every reference
    score is at least (1 - damping)/n > 0); ``inf`` for a wrong shape."""
    if got is None or np.shape(got) != tuple(want.shape):
        return float("inf")
    g = torch.as_tensor(np.asarray(got, np.float64)).to(want.device)
    return float(((g - want).abs() / want).max())


def control_answer(control: str, kind: str, csr, root: int) -> np.ndarray:
    """The control's answer to a search, in the port's output format:
    'bf16' relaxes (SSSP) or stores (levels) in bfloat16; 'stale' stops
    one round before the fixpoint, leaving the last round undelivered."""
    exact = reference.sssp(csr, root) if kind == "sssp" \
        else reference.bfs(csr, root)
    if control == "stale":
        rounds = max(exact.rounds - 1, 0)
        s = (reference.sssp(csr, root, max_rounds=rounds) if kind == "sssp"
             else reference.bfs(csr, root, max_rounds=rounds))
    elif kind == "sssp":
        s = reference.sssp(csr, root, dtype=torch.bfloat16)
    else:
        lv = exact.values
        lv = torch.where(lv == reference.UNREACHED, lv,
                         lv.to(torch.bfloat16).to(torch.int64))
        s = reference.Search(lv, exact.reached, exact.edges, exact.rounds)
    if kind == "sssp":
        return s.values.cpu().numpy()
    if kind == "reachability":
        return (s.values != reference.UNREACHED).cpu().numpy()
    lv = s.values
    return torch.where(lv == reference.UNREACHED,
                       torch.tensor(PORT_UNREACHED, device=lv.device),
                       lv).cpu().numpy()


def control_pagerank(control: str, n, src, dst, damping, iters):
    if control == "stale":
        return reference.pagerank(n, src, dst, damping, iters - 1)
    return reference.pagerank(n, src, dst, damping, iters,
                              dtype=torch.bfloat16)


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every reading at or under its
    limit.  A reading without a limit is refused."""
    out = {}
    for name, value in readings.items():
        if name not in limits:
            raise KeyError(f"no limit for check {name!r} in the traffic file")
        out[name] = {"value": value, "limit": limits[name]}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
