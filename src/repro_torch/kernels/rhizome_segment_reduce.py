"""Blocked semiring segment reduction: the standalone inbox reduce.

The engine's ``pallas_mode='reduce'`` composition relaxes with plain
torch ops and reduces the (E,) messages with this kernel, K9
(``csrc/segment_combine.cu``).  It runs the piece launch of K1-K8: one
thread block per piece of at most ``PIECE_CELLS`` planned cells of one
``SBLK``-wide segment block (the ``EBLK``-edge chunks whose sorted
destination range meets it, from ``fused_relax_reduce.plan_launch`` with
no source table), every cell run, each reading only its batch range
(``fused_relax_reduce.plan_batches``, built under the mask the plan
keeps, ``LaunchPlan.edge_mask``).  A warp folds 128 edges at a time with vector loads: a sorted
run of ids by a shuffle segmented scan, anything else by the lane-order
fold.  A split block's pieces combine in piece order; no float atomics,
so a sum repeats bit for bit and min is exact
(``ref.segment_combine_order`` replays the order).  float32 and bfloat16
messages are accumulated in float32 and the result is returned in the
input type, rounded once.  A block is four warps and a piece at most 24
cells (``PIECE_CELLS``), the winners of a sweep on the H100 (PERF.md).

On a CPU tensor ``segment_combine`` runs the plain version
(``ref.segment_combine_ref`` in float32); on a CUDA tensor it launches
the kernel, or raises.  ``launches`` counts K9 launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_relax_reduce as frr
from repro_torch.kernels.ref import segment_combine_ref

EBLK, SBLK = frr.EBLK, frr.SBLK

PIECE_CELLS = 24       # planned cells a K9 block takes at most (PERF.md:
                       # the sweep over 4, 8, 12, 16, 24 and 32)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# K9 launches made by ``_launch`` since the count was last set to 0
launches = 0


def plan_segments(segment_ids, num_segments: int,
                  edge_mask=None) -> frr.LaunchPlan:
    """K9's launch plan for these ids (every id in ``[0,
    num_segments)``): the block -> chunk lists of ``plan_launch`` with no
    source table.  ``edge_mask`` (default: all edges) drops edges that
    carry the identity from the chunk ranges; the plan keeps it, and its
    batch ranges follow it."""
    if edge_mask is None:
        edge_mask = torch.ones(segment_ids.shape, dtype=torch.bool,
                               device=segment_ids.device)
    return frr.plan_launch(None, edge_mask, segment_ids, num_segments, 0)


def _tables(plan: frr.LaunchPlan, ids, stream: int):
    """K9's launch tables on ``plan`` at ``PIECE_CELLS`` for launches on
    ``stream``, made once and kept in its ``scratch`` (the wrapper's host
    time would otherwise outlast the kernel): the piece count, the ten
    piece-table pointers and the split buffer's pointer.  The pieces,
    batch ranges and tickets are the plan's own, shared with K1-K8."""
    key = ("k9", PIECE_CELLS, stream)
    if key not in plan.scratch:
        pc = frr.plan_pieces(plan, PIECE_CELLS)
        split = torch.empty((pc.n_split, SBLK), dtype=torch.float32,
                            device=plan.blk_ptr.device)
        plan.scratch[key] = (
            pc.num_pieces, frr._piece_ptrs(plan, pc, None, None,
                                           plan.num_blocks, ids),
            split.data_ptr(), split)
    return plan.scratch[key][:3]


def launch_counts(plan: frr.LaunchPlan, ids):
    """What one K9 launch over ``plan`` at ``PIECE_CELLS`` walks, from its
    tables: the (3,) int32 [cells, pieces, edges loaded] that the kernel
    counts with ``with_debug`` (every cell's batch range, cut at the last
    edge, is loaded once)."""
    pc = frr.plan_pieces(plan, PIECE_CELLS)
    b = frr.plan_batches(plan, ids).long()
    e0 = plan.blk_chunk.long() * EBLK
    loaded = (torch.clamp(e0 + 32 * b[:, 1], max=plan.num_edges)
              - e0 - 32 * b[:, 0]).clamp(min=0).sum()
    return torch.stack([torch.tensor(plan.num_cells, device=loaded.device),
                        (pc.piece_blk >= 0).sum(), loaded]).to(torch.int32)


def _launch(data, ids, plan: frr.LaunchPlan, kind: str, with_debug: bool):
    """Launch K9 on the current stream over ``plan``'s pieces at
    ``PIECE_CELLS``, each cell's batch range built under the plan's own
    mask.  Returns the (num_segments,) result in ``data``'s dtype and,
    with ``with_debug``, the (3,) int32 [cells, pieces, edges] the
    kernel walked, pieces ran and edges its warps loaded.  Nothing here
    waits for the card.  Raises on a misaligned tensor and on any launch
    error."""
    global launches
    dev = data.device
    if data.dtype not in _DTYPE_CODE or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous 1-D float32 or "
                         f"bfloat16; got {data.dtype} {tuple(data.shape)}")
    for t, dtype, name in ((ids, torch.int32, "segment_ids"),
                           (plan.edge_mask, torch.bool, "the plan's mask"),
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
    # a lane loads four ids (16 bytes) and four messages at once
    for t, name in ((data, "data"), (ids, "segment_ids")):
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name} must be aligned to "
                             f"{4 * t.element_size()} bytes for K9's vector "
                             f"loads; got address {t.data_ptr():#x}")
    out = torch.empty(plan.num_segments, dtype=data.dtype, device=dev)
    dbg = torch.zeros(3, dtype=torch.int32, device=dev) if with_debug \
        else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_pieces, ptrs, split = _tables(plan, ids, stream)
    rc = frr._kernel("segment_combine_launch")(
        data.data_ptr(), ids.data_ptr(), *ptrs, e, plan.num_segments,
        n_pieces, out.data_ptr(), split,
        dbg.data_ptr() if dbg is not None else None,
        frr._KIND_CODE[kind], _DTYPE_CODE[data.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"segment_combine launch failed: cudaError {rc}")
    launches += 1
    return out, dbg


def segment_combine(data, segment_ids, num_segments: int, kind: str,
                    plan: frr.LaunchPlan | None = None,
                    with_debug: bool = False):
    """Blocked semiring segment reduce (min | sum).  ``data``: (E,)
    float32 or bfloat16 messages; ``segment_ids``: (E,) int32 in
    ``[0, num_segments)``, sorted or not (the range skip and the sorted
    fold bite when sorted).  Returns (num_segments,) in ``data``'s dtype;
    empty segments hold the identity (+inf for min, 0 for sum).

    ``plan`` is the ids' launch plan (the engine passes its
    ``fused_plan``), built here over every edge when absent; an edge its
    mask drops must carry the identity.  ``with_debug=True`` also
    returns the (3,) int32 [cells walked, pieces run, edges loaded]
    (on a CPU tensor, ``launch_counts``)."""
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
        dbg = launch_counts(plan, segment_ids) if with_debug else None
    return (out, dbg) if with_debug else out
