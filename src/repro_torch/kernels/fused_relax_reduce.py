"""Fused frontier-aware relax + segment reduce: the round's relax phase.

One engine round's relax phase,

    src_val = gval[edge_src]                  # gather
    active  = edge_mask & gchg[edge_src]      # frontier mask
    msg     = where(active, relax(src_val, w), identity)
    inbox   = segment_reduce(msg, edge_dst)   # min or sum

runs as one CUDA kernel (``csrc/fused_relax_reduce.cu``) that never
writes a per-edge array to device memory.  The frontier mask is folded
into the value table before launch (``_masked_value_tables``): inactive
sources read as the absorbing identity, ``relax(identity, w) ==
identity`` for every supported pairing, so the kernel gathers one table.

Blocking keeps the reference's ``EBLK``-edge chunks and ``SBLK``-wide
segment blocks, and its two skips:

1. **Sorted-range skip** — edges are sorted by destination within each
   shard, so chunk *j* covers ids ``[lo_j, hi_j]``.  ``plan_launch``
   lists, once per partition, the chunks whose range meets each segment
   block (a CSR, ``LaunchPlan``); one thread block per segment block walks
   only its list.
2. **Frontier chunk skip** — ``chunk_act[j]`` says whether any valid edge
   of chunk *j* has a changed source this round (``_chunk_tables``, torch
   ops, which also yield the active-edge message count).  A block skips a
   dead chunk without reading its edges.

So the kernel executes exactly the TPU grid's live (block, chunk) cells;
``with_debug`` returns its own count of them, and ``fused_grid_cells``
mirrors that count on the host.

On a CPU tensor ``fused_relax_reduce`` runs the plain version
(``ref.fused_relax_reduce_ref``); on a CUDA tensor it launches the
kernel, or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
import typing

import numpy as np
import torch

from repro_torch.core.actions import RELAX_FNS
from repro_torch.kernels.ref import fused_relax_reduce_ref

EBLK = 512   # edge-axis chunk (matches csrc/fused_relax_reduce.cu)
SBLK = 256   # segment-axis block (matches csrc/fused_relax_reduce.cu)

RELAX_KINDS = tuple(RELAX_FNS)

# pairings for which the combine identity absorbs under relax —
# relax(identity, w) == identity — the property the frontier masking
# relies on (inactive sources are folded into the value table as the
# identity and must never contribute)
ABSORBING_PAIRS = frozenset(
    {("add_w", "min"), ("add_one", "min"), ("mul_w", "sum")})

_RELAX_CODE = {"add_w": 0, "add_one": 1, "mul_w": 2}
_KIND_CODE = {"min": 0, "sum": 1}

# kernel launches made by ``_launch`` since the count was last set to 0
launches = 0


def _round_up(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


def _check_pair(relax_kind: str, kind: str):
    assert relax_kind in RELAX_KINDS, relax_kind
    if (relax_kind, kind) not in ABSORBING_PAIRS:
        raise ValueError(
            f"non-absorbing relax/combine pairing {(relax_kind, kind)}: "
            "frontier masking requires relax(identity, w) == identity "
            f"(supported: {sorted(ABSORBING_PAIRS)})")


class LaunchPlan(typing.NamedTuple):
    """Static launch tables of one edge set: for segment block ``i`` the
    chunks ``blk_chunk[blk_ptr[i]:blk_ptr[i+1]]`` (ascending) are those
    whose valid-edge id range meets the block."""

    blk_ptr: torch.Tensor     # (n_sblk + 1,) int32
    blk_chunk: torch.Tensor   # (launch cells,) int32
    num_edges: int
    num_segments: int
    num_slots: int

    @property
    def num_blocks(self) -> int:
        return self.blk_ptr.shape[0] - 1


def _pad_to_chunks(x, fill):
    """(E,) -> (n_chunks, EBLK), padded with ``fill``."""
    e = x.shape[0]
    n_chunks = _round_up(e, EBLK) // EBLK
    out = torch.full((n_chunks * EBLK,), fill, dtype=x.dtype,
                     device=x.device)
    out[:e] = x
    return out.view(n_chunks, EBLK)


def _chunk_ranges(edge_dst, edge_mask):
    """Per-chunk [lo, hi] id range over valid edges (int64); a chunk with
    no valid edge gets lo = int64 max, hi = -1 and meets no block."""
    idc = _pad_to_chunks(edge_dst.long(), 0)
    valid = _pad_to_chunks(edge_mask, False)
    lo = torch.where(valid, idc, torch.iinfo(torch.int64).max).amin(dim=1)
    hi = torch.where(valid, idc, -1).amax(dim=1)
    return lo, hi


def plan_launch(edge_src, edge_mask, edge_dst, num_segments: int,
                num_slots: int) -> LaunchPlan:
    """Build the block -> chunk lists for one edge set, with torch ops on
    the edges' device.  Valid edges must address ``[0, num_slots)`` with
    ``edge_src`` and ``[0, num_segments)`` with ``edge_dst``; the kernel
    reads memory at those offsets, so they are checked here, once."""
    e = edge_src.shape[0]
    if edge_mask.shape != (e,) or edge_dst.shape != (e,):
        raise ValueError("edge_src, edge_mask and edge_dst must be (E,)")
    if e and bool(edge_mask.any()):
        src_v, dst_v = edge_src[edge_mask], edge_dst[edge_mask]
        if int(src_v.min()) < 0 or int(src_v.max()) >= num_slots:
            raise ValueError(f"edge_src outside [0, {num_slots})")
        if int(dst_v.min()) < 0 or int(dst_v.max()) >= num_segments:
            raise ValueError(f"edge_dst outside [0, {num_segments})")
    dev = edge_dst.device
    n_sblk = _round_up(num_segments, SBLK) // SBLK
    lo, hi = _chunk_ranges(edge_dst, edge_mask)
    i_lo = torch.div(lo, SBLK, rounding_mode="floor").clamp(min=0)
    i_hi = torch.div(hi, SBLK, rounding_mode="floor").clamp(max=n_sblk - 1)
    nb = (i_hi - i_lo + 1).clamp(min=0)
    chunk = torch.repeat_interleave(
        torch.arange(nb.shape[0], device=dev), nb)
    first = torch.cumsum(nb, 0) - nb
    blk = i_lo[chunk] + torch.arange(chunk.shape[0], device=dev) \
        - first[chunk]
    order = torch.sort(blk, stable=True).indices
    counts = torch.bincount(blk, minlength=n_sblk)
    blk_ptr = torch.zeros(n_sblk + 1, dtype=torch.int32, device=dev)
    blk_ptr[1:] = torch.cumsum(counts, 0)
    return LaunchPlan(blk_ptr, chunk[order].to(torch.int32).contiguous(),
                      e, num_segments, num_slots)


def _masked_value_tables(gval, gchg, identity):
    """Frontier masking folded into the value table (absorbing identity):
    relax(identity, w) == identity for all supported pairings, so an
    inactive source can never contribute — the same result as the
    oracle's explicit where(active, ...) mask, one fewer gather."""
    return torch.where(gchg, gval, torch.tensor(identity, dtype=gval.dtype,
                                                device=gval.device))


def _chunk_tables(edge_src, edge_mask, gchg):
    """Per-chunk frontier bit (``(n_chunks,) bool``: any valid edge with a
    changed source) and the active-edge count (int32) — the Fig-6
    message counter, a free reduction of the gather the bitmap needs."""
    act = edge_mask & torch.index_select(gchg, 0, edge_src)
    chunk_act = _pad_to_chunks(act, False).any(dim=1)
    return chunk_act, act.sum(dtype=torch.int32)


def _executed_cells(plan: LaunchPlan, chunk_act):
    """Cells the kernel executes: listed (block, chunk) pairs whose chunk
    is live.  The plain path reports this in place of the kernel count."""
    return chunk_act[plan.blk_chunk.long()].sum(dtype=torch.int32).view(1)


def _bind(lib):
    fn = lib.frr_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_kernel_fn = None


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        from repro_torch.kernels import _build
        _kernel_fn = _bind(_build.load("fused_relax_reduce"))
    return _kernel_fn


def _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                       plan: LaunchPlan, chunk_act):
    dev = gval_m.device
    want = [(gval_m, torch.float32, "gval"), (edge_src, torch.int32, "src"),
            (edge_w, torch.float32, "w"), (edge_mask, torch.bool, "mask"),
            (edge_dst, torch.int32, "ids"),
            (plan.blk_ptr, torch.int32, "blk_ptr"),
            (plan.blk_chunk, torch.int32, "blk_chunk"),
            (chunk_act, torch.bool, "chunk_act")]
    for t, dtype, name in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, gval on {dev}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    e = edge_src.shape[0]
    if any(t.shape[0] != e for t in (edge_w, edge_mask, edge_dst)):
        raise ValueError("edge arrays differ in length")
    if plan.num_edges != e or plan.num_slots != gval_m.shape[0]:
        raise ValueError("launch plan was built for another edge set")
    if chunk_act.shape[0] != _round_up(e, EBLK) // EBLK:
        raise ValueError("chunk_act does not match the edge count")
    if e >= 2**31 - EBLK or plan.num_segments >= 2**31:
        raise ValueError("edge or segment count exceeds int32 indexing")


def _launch(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan: LaunchPlan,
            chunk_act, relax_kind: str, kind: str, with_debug: bool):
    """Launch the CUDA kernel on the current stream.  Returns the
    (num_segments,) partial and, with ``with_debug``, the (1,) int32
    executed-cell counter.  Raises on any launch error."""
    global launches
    _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                       chunk_act)
    out = torch.empty(plan.num_segments, dtype=torch.float32,
                      device=gval_m.device)
    dbg = (torch.zeros(1, dtype=torch.int32, device=gval_m.device)
           if with_debug else None)
    stream = torch.cuda.current_stream(gval_m.device).cuda_stream
    rc = _kernel()(
        gval_m.data_ptr(), edge_src.data_ptr(), edge_w.data_ptr(),
        edge_mask.data_ptr(), edge_dst.data_ptr(), plan.blk_ptr.data_ptr(),
        plan.blk_chunk.data_ptr(), chunk_act.data_ptr(), edge_src.shape[0],
        plan.num_segments, plan.num_blocks, out.data_ptr(),
        dbg.data_ptr() if dbg is not None else None,
        _RELAX_CODE[relax_kind], _KIND_CODE[kind], stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce launch failed: cudaError {rc}")
    launches += 1
    return out, dbg


def fused_relax_reduce(gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
                       num_segments: int, relax_kind: str, kind: str,
                       with_count: bool = False, with_debug: bool = False,
                       plan: LaunchPlan | None = None):
    """Fused gather/relax/mask/segment-reduce.

    gval: (V,) f32 vertex (replica-slot) values; gchg: (V,) bool changed
    flags (the frontier); edge_src/edge_dst: (E,) int32 into [0, V) /
    [0, num_segments); edge_w: (E,) f32; edge_mask: (E,) bool (False on
    padding).  Returns the (num_segments,) inbox partial — empty segments
    hold the combine identity.  ``with_count=True`` appends the int32
    active-edge count; ``with_debug=True`` appends the (1,) int32 count of
    executed (block, chunk) cells that ``fused_grid_cells`` mirrors.
    ``plan`` is ``plan_launch`` of these edges, built here when absent
    (callers that launch every round build it once).  Edges should be
    sorted by ``edge_dst`` for the range skip to bite; correctness never
    depends on the sort.

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    _check_pair(relax_kind, kind)
    identity = math.inf if kind == "min" else 0.0
    dev = gval.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {gval.device}")
    need_plan = dev == "cuda" or with_debug
    if need_plan and plan is None:
        plan = plan_launch(edge_src, edge_mask, edge_dst, num_segments,
                           gval.shape[0])
    if dev == "cuda" or with_debug or with_count:
        chunk_act, count = _chunk_tables(edge_src, edge_mask, gchg)
    if dev == "cuda":
        gval_m = _masked_value_tables(gval, gchg, identity)
        out, dbg = _launch(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                           plan, chunk_act, relax_kind, kind, with_debug)
    else:
        out = fused_relax_reduce_ref(gval, gchg, edge_src, edge_w,
                                     edge_mask, edge_dst, num_segments,
                                     relax_kind, kind)
        dbg = _executed_cells(plan, chunk_act) if with_debug else None
    res = (out,)
    if with_count:
        res += (count,)
    if with_debug:
        res += (dbg,)
    return res[0] if len(res) == 1 else res


# --------------------------------------------------------------------------
# host-side launch mirror (grid-cell accounting)
# --------------------------------------------------------------------------

def fused_grid_cells(edge_dst, edge_mask, edge_src, gchg,
                     num_segments: int) -> dict:
    """Host-side mirror of the fused launch over an edge stack.

    Edge arrays are (S, E_max) host arrays, or 1-D for a single flat
    launch; ``gchg`` is the (V,) frontier.  Returns ``total_fused`` (the
    reference's dense (segment block, chunk) grid), ``launch_cells`` (the
    (block, chunk) pairs whose range meets, which this port's blocks walk)
    and ``fused_live`` (those whose chunk is frontier-live: the cells the
    kernel executes, equal to its ``with_debug`` count and to the
    reference grid's live cells)."""
    ids = np.asarray(edge_dst).reshape(-1).astype(np.int64)
    msk = np.asarray(edge_mask).reshape(-1).astype(bool)
    srcs = np.asarray(edge_src).reshape(-1)
    g = np.asarray(gchg).reshape(-1)
    e = ids.shape[0]
    n_chunks = _round_up(e, EBLK) // EBLK
    n_sblk = _round_up(num_segments, SBLK) // SBLK
    pad = n_chunks * EBLK - e
    idc = np.pad(ids, (0, pad)).reshape(n_chunks, EBLK)
    mkc = np.pad(msk, (0, pad)).reshape(n_chunks, EBLK)
    act = np.zeros(n_chunks * EBLK, bool)
    act[:e] = msk & g[srcs]
    lo = np.where(mkc, idc, np.iinfo(np.int64).max).min(axis=1)
    hi = np.where(mkc, idc, -1).max(axis=1)
    i_lo = np.maximum(lo // SBLK, 0)
    i_hi = np.minimum(hi // SBLK, n_sblk - 1)
    nb = np.maximum(i_hi - i_lo + 1, 0)
    live = act.reshape(n_chunks, EBLK).any(axis=1)
    return {"total_fused": n_sblk * n_chunks,
            "launch_cells": int(nb.sum()),
            "fused_live": int(nb[live].sum())}
