"""Plain PyTorch versions of the kernels: the oracles they are held to.

Semantics contract (shared by kernel, oracle, and the engine):
empty segments hold the combine identity (+inf for min, 0 for sum).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.actions import RELAX_FNS


def segment_combine_ref(data, segment_ids, num_segments: int, kind: str):
    """Semiring segment reduction: the inbox partial-reduce of one shard.

    data: (E,) float; segment_ids: (E,) int in [0, num_segments);
    returns (num_segments,) float.
    """
    if kind == "min":
        init = torch.full((num_segments,), math.inf, dtype=data.dtype,
                          device=data.device)
        reduce = "amin"
    elif kind == "sum":
        init = torch.zeros((num_segments,), dtype=data.dtype,
                           device=data.device)
        reduce = "sum"
    else:
        raise ValueError(kind)
    return init.scatter_reduce_(0, segment_ids.long(), data, reduce,
                                include_self=True)


def fused_relax_reduce_ref(gval, gchg, edge_src, edge_w, edge_mask,
                           edge_dst, num_segments: int, relax_kind: str,
                           kind: str):
    """Oracle for the fused frontier relax+reduce kernel: the unfused
    gather / relax / frontier-mask / segment-combine pipeline, with every
    intermediate materialized.  Shapes as in
    ``fused_relax_reduce.fused_relax_reduce``."""
    src = edge_src.long()
    src_val = gval[src]
    active = edge_mask & gchg[src]
    msg = RELAX_FNS[relax_kind](src_val, edge_w)
    identity = math.inf if kind == "min" else 0.0
    msg = torch.where(active, msg, torch.tensor(identity, dtype=msg.dtype,
                                                device=msg.device))
    return segment_combine_ref(msg, edge_dst, num_segments, kind)
