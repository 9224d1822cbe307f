"""Blocked semiring segment reduction: the standalone inbox reduce.

The engine's ``pallas_mode='reduce'`` composition relaxes with plain
torch ops and reduces the (E,) messages with this kernel, K9
(``csrc/segment_combine.cu``): one thread block per ``SBLK``-wide segment
block walks the ``EBLK``-edge chunks whose sorted destination range meets
it (``fused_relax_reduce.plan_launch``'s block -> chunk lists, built with
no source table), with no frontier skip, and folds the messages in a
fixed order — no float atomics, so a sum repeats bit for bit and min is
exact.  float32 and bfloat16 messages are accumulated in float32 and the
result is returned in the input type.

On a CPU tensor ``segment_combine`` runs the plain version
(``ref.segment_combine_ref`` in float32); on a CUDA tensor it launches
the kernel, or raises.  ``launches`` counts K9 launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_relax_reduce as frr
from repro_torch.kernels.ref import segment_combine_ref

EBLK, SBLK = frr.EBLK, frr.SBLK

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# K9 launches made by ``_launch`` since the count was last set to 0
launches = 0


def plan_segments(segment_ids, num_segments: int,
                  edge_mask=None) -> frr.LaunchPlan:
    """K9's launch plan for these ids (every id in ``[0,
    num_segments)``): the block -> chunk lists of ``plan_launch`` with no
    source table.  ``edge_mask`` (default: all edges) drops edges that
    carry the identity from the chunk ranges."""
    if edge_mask is None:
        edge_mask = torch.ones(segment_ids.shape, dtype=torch.bool,
                               device=segment_ids.device)
    return frr.plan_launch(None, edge_mask, segment_ids, num_segments, 0)


def _launch(data, ids, plan: frr.LaunchPlan, kind: str, with_debug: bool):
    """Launch K9 on the current stream.  Returns the (num_segments,)
    result in ``data``'s dtype and, with ``with_debug``, the (1,) int32
    count of (block, chunk) cells walked.  Raises on any launch error."""
    global launches
    dev = data.device
    if data.dtype not in _DTYPE_CODE or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous 1-D float32 or "
                         f"bfloat16; got {data.dtype} {tuple(data.shape)}")
    for t, dtype, name in ((ids, torch.int32, "segment_ids"),
                           (plan.blk_ptr, torch.int32, "blk_ptr"),
                           (plan.blk_chunk, torch.int32, "blk_chunk")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data on {dev}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype}")
    e = data.shape[0]
    if ids.shape[0] != e or plan.num_edges != e:
        raise ValueError("data, segment_ids and the plan differ in length")
    if e >= 2**31 - EBLK or plan.num_segments >= 2**31:
        raise ValueError("sizes exceed int32 indexing")
    out = torch.empty(plan.num_segments, dtype=data.dtype, device=dev)
    dbg = torch.zeros(1, dtype=torch.int32, device=dev) if with_debug \
        else None
    rc = frr._kernel("segment_combine_launch")(
        data.data_ptr(), ids.data_ptr(), plan.blk_ptr.data_ptr(),
        plan.blk_chunk.data_ptr(), e, plan.num_segments, plan.num_blocks,
        out.data_ptr(), dbg.data_ptr() if dbg is not None else None,
        frr._KIND_CODE[kind], _DTYPE_CODE[data.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_combine launch failed: cudaError {rc}")
    launches += 1
    return out, dbg


def segment_combine(data, segment_ids, num_segments: int, kind: str,
                    plan: frr.LaunchPlan | None = None,
                    with_debug: bool = False):
    """Blocked semiring segment reduce (min | sum).  ``data``: (E,)
    float32 or bfloat16 messages; ``segment_ids``: (E,) int32 in
    ``[0, num_segments)``, sorted or not (the range skip bites when
    sorted).  Returns (num_segments,) in ``data``'s dtype; empty segments
    hold the identity (+inf for min, 0 for sum).  ``plan`` is
    ``plan_segments`` of the ids (or ``DeviceArrays.fused_plan`` on the
    engine's path, whose masked edges carry the identity), built here when
    absent.  ``with_debug=True`` also returns the (1,) int32 count of
    cells walked."""
    if kind not in frr._KIND_CODE:
        raise ValueError(kind)
    dev = data.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {data.device}")
    if plan is None and (dev == "cuda" or with_debug):
        plan = plan_segments(segment_ids, num_segments)
    if dev == "cuda":
        out, dbg = _launch(data, segment_ids, plan, kind, with_debug)
    else:
        out = segment_combine_ref(data.float(), segment_ids, num_segments,
                                  kind).to(data.dtype)
        dbg = (torch.tensor([plan.num_cells], dtype=torch.int32)
               if with_debug else None)
    return (out, dbg) if with_debug else out
