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


def fused_relax_reduce_wl_ref(gval, gchg, edge_src, edge_w, edge_mask,
                              edge_dst, wl_i, wl_j, nlive,
                              num_segments: int, relax_kind: str, kind: str):
    """Plain version of the worklist launch (kernel K2 and its fold).

    Cell ``c < nlive`` works edge chunk ``wl_j[c]`` against segment block
    ``wl_i[c]``: its (SBLK,) partial combines the chunk's active edges
    whose destination lies in the block.  Dead and pad cells hold the
    identity, so folding every row into the inbox by ``wl_i`` (the
    reference's ``_scatter_partials``) is exact.  Shapes as in
    ``fused_relax_reduce.fused_relax_reduce``; ``wl_i``/``wl_j``:
    (l_pad,) int, ``nlive``: (1,) int."""
    from repro_torch.kernels.fused_relax_reduce import EBLK, SBLK
    identity = math.inf if kind == "min" else 0.0
    reduce = "amin" if kind == "min" else "sum"
    dev = gval.device
    e = edge_src.shape[0]
    n_chunks = max(-(-e // EBLK), 1)

    def chunks(x, fill):
        out = torch.full((n_chunks * EBLK,), fill, dtype=x.dtype, device=dev)
        out[:e] = x
        return out.view(n_chunks, EBLK)[wl_j.long()]     # (l_pad, EBLK)

    src = chunks(edge_src.long(), 0)
    local = chunks(edge_dst.long(), 0) - wl_i.long()[:, None] * SBLK
    cell = torch.arange(wl_i.shape[0], device=dev)[:, None]
    hit = (chunks(edge_mask, False) & gchg[src] & (local >= 0)
           & (local < SBLK) & (cell < nlive.to(dev).long()))
    msg = torch.where(hit, RELAX_FNS[relax_kind](gval[src],
                                                 chunks(edge_w, 0.0)),
                      identity)
    partials = torch.full((wl_i.shape[0], SBLK + 1), identity,
                          dtype=gval.dtype, device=dev)
    partials.scatter_reduce_(1, torch.where(hit, local, SBLK), msg, reduce,
                             include_self=True)
    n_i = max(-(-num_segments // SBLK), 1)
    inbox = torch.full((n_i, SBLK), identity, dtype=gval.dtype, device=dev)
    rows = wl_i.long()[:, None].expand(-1, SBLK)
    inbox.scatter_reduce_(0, rows, partials[:, :SBLK], reduce,
                          include_self=True)
    return inbox.reshape(-1)[:num_segments]
