"""Wrappers the exchange layer calls for its kernels.

A CUDA tensor launches the hand-written kernel, and the call raises if
the kernel does not build or launch; a CPU tensor runs the kernel's plain
PyTorch version.  There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.fused_relax_reduce import fused_relax_reduce as _frr
from repro_torch.kernels.fused_relax_reduce import \
    fused_relax_reduce_lanes as _frr_lanes
from repro_torch.kernels.rhizome_segment_reduce import \
    segment_combine as _segment_combine


def segment_combine(data, segment_ids, num_segments: int, kind: str,
                    plan=None):
    """Semiring segment reduction (min | sum) over edge messages (K9).
    ``plan`` is the ids' launch plan (the engine passes its
    ``fused_plan``), built here when absent."""
    return _segment_combine(data, segment_ids, num_segments, kind,
                            plan=plan)


def fused_relax_reduce(gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
                       num_segments: int, relax_kind: str, kind: str,
                       plan=None, worklist=None, grid_mode: str = "dense"):
    """Fused frontier gather + semiring relax + mask + segment reduction —
    the whole per-round relax phase.  Returns ((num_segments,) partial,
    int32 active-edge message count).  ``plan`` is the edges'
    ``fused_relax_reduce.plan_launch``, built once per partition by the
    engine; ``worklist`` (a host plan) or ``grid_mode='device_worklist'``
    selects the worklist launch K2, else the dense launch K1 runs."""
    return _frr(gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
                num_segments, relax_kind, kind, with_count=True, plan=plan,
                worklist=worklist, grid_mode=grid_mode)


def fused_relax_reduce_lanes(gval, gchg, lane_unitw, edge_src, edge_w,
                             edge_mask, edge_dst, num_segments: int,
                             relax_kind: str, kind: str, plan=None,
                             worklist=None, grid_mode: str = "dense"):
    """Lane-batched fused relax phase: per-lane (V, Q) values and
    frontiers over one shared edge set, one launch for all queries.
    Returns ((num_segments, Q) partial, (Q,) int32 per-lane active-edge
    counts).  ``worklist`` (a host plan over the OR-across-lanes
    frontier) or ``grid_mode='device_worklist'`` selects the worklist
    launch K4, else the dense launch K3 runs."""
    return _frr_lanes(gval, gchg, lane_unitw, edge_src, edge_w, edge_mask,
                      edge_dst, num_segments, relax_kind, kind,
                      with_count=True, plan=plan, worklist=worklist,
                      grid_mode=grid_mode)
