"""Parent trees of a min-semiring fixpoint: kernel K10.

After ``run_stacked`` has reached its fixpoint, one pass over the
partition's stacked edges picks each reached vertex's parent for
Graph500's kernels 2 and 3 (``apps.bfs_tree`` / ``apps.sssp_tree``).
For every input edge (u, v, w) with ``fl32(d[u] + w) == d[v]`` and
``d[u] < d[v]`` (w = 1 for BFS, whose levels make the rule level[u] =
level[v] - 1), u is offered as v's parent and ``parent[v]`` keeps the
smallest global id offered.  A tie round (``before=``) takes the edges
with ``d[u] == d[v]`` instead, and offers u only where u had a parent in
``before`` and v had none.  Values are read through the edges' slot ids
(the source's root slot, the destination's replica slot), global ids
through the slot -> vertex table.

On CUDA tensors ``tree_parents`` launches ``csrc/tree_parents.cu``; on
CPU tensors it runs the plain version, ``tree_parents_ref``.  There is
no fallback between the two.  ``launches`` counts K10 launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

NONE = 2**31 - 1        # no parent (yet): the int32 maximum

# K10 launches made by ``tree_parents`` since the count was last set to 0
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 8 + [ctypes.c_longlong, ctypes.c_int, _P]
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load("tree_parents").tree_parents_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def tree_parents_ref(val, edge_src, edge_dst, edge_w, edge_mask,
                     slot_vertex, parent, weighted: bool, before=None):
    """The plain version of one K10 launch: lowers ``parent`` in place
    and returns it."""
    s, t = edge_src.long(), edge_dst.long()
    du, dv = val[s], val[t]
    c = edge_w if weighted else torch.ones_like(du)
    hit = edge_mask & (dv < math.inf) & ((du + c) == dv)
    hit &= (du == dv) if before is not None else (du < dv)
    u, v = slot_vertex[s[hit]], slot_vertex[t[hit]].long()
    if before is not None:
        keep = (before[u.long()] != NONE) & (before[v] == NONE)
        u, v = u[keep], v[keep]
    return parent.scatter_reduce_(0, v, u.to(parent.dtype), "amin")


def _check(val, edge_src, edge_dst, edge_w, edge_mask, slot_vertex, parent,
           before):
    dev = val.device
    e = edge_src.shape[0]
    for t, dtype, name, size in (
            (val, torch.float32, "val", None),
            (edge_src, torch.int32, "edge_src", e),
            (edge_dst, torch.int32, "edge_dst", e),
            (edge_w, torch.float32, "edge_w", e),
            (edge_mask, torch.bool, "edge_mask", e),
            (slot_vertex, torch.int32, "slot_vertex", val.shape[0]),
            (parent, torch.int32, "parent", None),
            (before, torch.int32, "before", parent.shape[0])):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, val on {dev}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype}; got "
                             f"{t.dtype} {tuple(t.shape)}")
        if size is not None and t.shape[0] != size:
            raise ValueError(f"{name} has {t.shape[0]} entries, not {size}")


def tree_parents(val, edge_src, edge_dst, edge_w, edge_mask, slot_vertex,
                 parent, weighted: bool, before=None):
    """One K10 launch over the (E,) edges: ``val`` (V,) float32 slot
    values; ``edge_src`` / ``edge_dst`` (E,) int32 slot ids;
    ``edge_w`` (E,) float32 (read when ``weighted``); ``edge_mask`` (E,)
    bool; ``slot_vertex`` (V,) int32; ``parent`` (n,) int32, ``NONE``
    where there is no parent yet, lowered in place and returned.
    ``before`` (a copy of ``parent``) makes it a tie round.  Nothing here
    waits for the card; a launch error raises."""
    global launches
    _check(val, edge_src, edge_dst, edge_w, edge_mask, slot_vertex, parent,
           before)
    if val.device.type == "cpu":
        return tree_parents_ref(val, edge_src, edge_dst, edge_w, edge_mask,
                                slot_vertex, parent, weighted, before)
    if val.device.type != "cuda":
        raise ValueError(f"unsupported device {val.device}")
    stream = torch.cuda.current_stream(val.device).cuda_stream
    rc = _kernel()(val.data_ptr(), edge_src.data_ptr(), edge_dst.data_ptr(),
                   edge_w.data_ptr(), edge_mask.data_ptr(),
                   slot_vertex.data_ptr(),
                   before.data_ptr() if before is not None else None,
                   parent.data_ptr(), edge_src.shape[0], int(weighted),
                   stream)
    if rc != 0:
        raise RuntimeError(f"tree_parents launch failed: cudaError {rc}")
    launches += 1
    return parent
