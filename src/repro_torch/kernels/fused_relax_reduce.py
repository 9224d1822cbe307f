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

**Worklist launches** (``grid_mode='worklist' | 'device_worklist'``, or
an explicit ``worklist=``) run the same math as a 1-D launch over a list
of live (block, chunk) cells, j-major (``csrc/fused_relax_reduce_wl.cu``,
kernel K2): each cell writes an (SBLK,) partial and a second kernel
folds the partials into the inbox in cell-list order.  The list comes
from the host planner (``WorklistPlanner``, numpy, with the reference's
dst filter that drops cells holding no active edge of their block) or is
compacted on the device from the chunk frontier bits
(``build_device_worklist``, no host sync; its length is static: the
power of two above the launch plan's cell count).

**Lane-batched launches** (``fused_relax_reduce_lanes``) run the same
math over a (V, Q) table of query lanes that share one edge set: kernel
K3 (``csrc/fused_relax_reduce_lanes.cu``) for the dense launch and K4
(``csrc/fused_relax_reduce_wl_lanes.cu``) with its laned fold for
worklists.  The chunk frontier bit is the OR across lanes, the message
counts are per lane, and plans are made from the OR-across-lanes
frontier: ``WorklistPlanner``, ``plan_worklist``, ``build_device_worklist``
and ``fused_grid_cells`` accept a (V, Q) frontier and OR it.

On a CPU tensor ``fused_relax_reduce`` runs the plain versions
(``ref.fused_relax_reduce_ref``, ``ref.fused_relax_reduce_wl_ref``) and
``fused_relax_reduce_lanes`` theirs (``ref.fused_relax_reduce_lanes_ref``,
``ref.fused_relax_reduce_wl_lanes_ref``); on a CUDA tensor they launch
the kernels, or raise.  ``launches`` counts K1 launches, ``wl_launches``
K2 launches, ``lanes_launches`` K3 launches and ``wl_lanes_launches`` K4
launches.
"""
from __future__ import annotations

import ctypes
import math
import typing
import warnings

import numpy as np
import torch

from repro_torch.core.actions import RELAX_FNS
from repro_torch.kernels.ref import (
    fused_relax_reduce_lanes_ref, fused_relax_reduce_ref,
    fused_relax_reduce_wl_lanes_ref, fused_relax_reduce_wl_ref,
)

EBLK = 512   # edge-axis chunk (matches csrc/frr_common.cuh)
SBLK = 256   # segment-axis block (matches csrc/frr_common.cuh)

WL_PAD = 8      # host worklists are padded to >= this many cells and then
                # to a power of two, as the reference pads its launches
WL_BLOCKS_PER_SM = 8   # K2's fixed grid for a device-resident worklist

RELAX_KINDS = tuple(RELAX_FNS)

# relax kinds of the lane-batched kernels: BFS lanes run 'add_w' with
# their lane_unitw flag set, so 'add_one' has no laned form
LANE_RELAX_KINDS = ("add_w", "mul_w")

# pairings for which the combine identity absorbs under relax —
# relax(identity, w) == identity — the property the frontier masking
# relies on (inactive sources are folded into the value table as the
# identity and must never contribute)
ABSORBING_PAIRS = frozenset(
    {("add_w", "min"), ("add_one", "min"), ("mul_w", "sum")})

_RELAX_CODE = {"add_w": 0, "add_one": 1, "mul_w": 2}
_KIND_CODE = {"min": 0, "sum": 1}

# kernel launches made by ``_launch`` (K1), ``_launch_wl`` (K2),
# ``_launch_lanes`` (K3) and ``_launch_wl_lanes`` (K4) since the counts
# were last set to 0
launches = 0
wl_launches = 0
lanes_launches = 0
wl_lanes_launches = 0


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
    whose valid-edge id range meets the block.  ``cell_i``/``cell_j``
    list the same (block, chunk) cells j-major (chunk ascending, then
    block): the order the worklist launches keep.  ``src_deg`` is each
    slot's count of valid out-edges (the laned launches' per-lane message
    counts come from it); a segment-reduce plan has none."""

    blk_ptr: torch.Tensor     # (n_sblk + 1,) int32
    blk_chunk: torch.Tensor   # (launch cells,) int32
    cell_i: torch.Tensor      # (launch cells,) int32, j-major
    cell_j: torch.Tensor      # (launch cells,) int32, j-major
    num_edges: int
    num_segments: int
    num_slots: int
    src_deg: torch.Tensor | None = None   # (num_slots,) int32

    @property
    def num_blocks(self) -> int:
        return self.blk_ptr.shape[0] - 1

    @property
    def num_cells(self) -> int:
        return self.blk_chunk.shape[0]


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
    reads memory at those offsets, so they are checked here, once.
    ``edge_src=None`` plans a segment reduce of given messages (K9), which
    gathers nothing."""
    e = edge_dst.shape[0]
    if edge_mask.shape != (e,) or edge_dst.shape != (e,) or (
            edge_src is not None and edge_src.shape != (e,)):
        raise ValueError("edge_src, edge_mask and edge_dst must be (E,)")
    if e and bool(edge_mask.any()):
        dst_v = edge_dst[edge_mask]
        if edge_src is not None:
            src_v = edge_src[edge_mask]
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
                      blk.to(torch.int32), chunk.to(torch.int32),
                      e, num_segments, num_slots,
                      None if edge_src is None
                      else _src_degrees(edge_src, edge_mask, num_slots))


def _masked_value_tables(gval, gchg, identity):
    """Frontier masking folded into the value table (absorbing identity):
    relax(identity, w) == identity for all supported pairings, so an
    inactive source can never contribute — the same result as the
    oracle's explicit where(active, ...) mask, one fewer gather.  Works
    alike for a (V,) table and a (V, Q) lane table (per-lane frontier);
    the result is contiguous, row-major."""
    return torch.where(gchg, gval, identity)


def _chunk_tables(edge_src, edge_mask, gchg):
    """Per-chunk frontier bit (``(n_chunks,) bool``: any valid edge with a
    changed source) and the active-edge count (int32) — the Fig-6
    message counter, a free reduction of the gather the bitmap needs."""
    act = edge_mask & torch.index_select(gchg, 0, edge_src)
    chunk_act = _pad_to_chunks(act, False).any(dim=1)
    return chunk_act, act.sum(dtype=torch.int32)


def _src_degrees(edge_src, edge_mask, num_slots: int):
    """(num_slots,) int32: each slot's count of valid out-edges."""
    src = torch.where(edge_mask, edge_src, 0).long()
    return torch.zeros(num_slots, dtype=torch.int32,
                       device=edge_src.device).index_add_(
        0, src, edge_mask.to(torch.int32))


def _lane_chunk_tables(edge_src, edge_mask, gchg, src_deg=None):
    """Laned chunk tables for a (V, Q) frontier: the per-chunk bit is the
    OR across lanes (a chunk is dead only when no lane has an active
    source in it) and the active-edge counts are per lane ((Q,) int32,
    one Fig-6 message counter per query).  Both come without an (E, Q)
    gather: the bit is ``_chunk_tables`` of the OR-across-lanes (V,)
    frontier, and lane q's count is the sum of ``src_deg`` (valid
    out-edges per slot, from the launch plan or built here) over its
    changed slots."""
    chunk_act, _ = _chunk_tables(edge_src, edge_mask, gchg.any(dim=1))
    if src_deg is None:
        src_deg = _src_degrees(edge_src, edge_mask, gchg.shape[0])
    counts = (gchg * src_deg[:, None]).sum(dim=0, dtype=torch.int32)
    return chunk_act, counts


def _or_lanes(gchg):
    """A (V,) frontier from a (V, Q) one (OR across lanes); a (V,) frontier
    passes through.  Works on numpy arrays and tensors."""
    if gchg.ndim == 2:
        return gchg.any(-1)
    return gchg


def _executed_cells(plan: LaunchPlan, chunk_act):
    """Cells the kernel executes: listed (block, chunk) pairs whose chunk
    is live.  The plain path reports this in place of the kernel count."""
    return chunk_act[plan.blk_chunk.long()].sum(dtype=torch.int32).view(1)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {   # C entry point -> (library, argument types)
    "frr_launch": ("fused_relax_reduce",
                   [_P] * 8 + [_I] * 3 + [_P] * 2 + [_I] * 2 + [_P]),
    "frr_wl_launch": ("fused_relax_reduce_wl",
                      [_P] * 8 + [_I] * 2 + [_P] * 2 + [_I] * 2 + [_P]),
    "frr_wl_fold": ("fused_relax_reduce_wl", [_P] * 3 + [_I] * 2 + [_P]
                    + [_I] + [_P]),
    "frr_lanes_launch": ("fused_relax_reduce_lanes",
                         [_P] * 9 + [_I] * 4 + [_P] * 2 + [_I] * 2 + [_P]),
    "frr_wl_lanes_launch": ("fused_relax_reduce_wl_lanes",
                            [_P] * 9 + [_I] * 3 + [_P] * 2 + [_I] * 2
                            + [_P]),
    "frr_wl_lanes_fold": ("fused_relax_reduce_wl_lanes",
                          [_P] * 3 + [_I] * 3 + [_P] + [_I] + [_P]),
    "segment_combine_launch": ("segment_combine",
                               [_P] * 4 + [_I] * 3 + [_P] * 2 + [_I] * 2
                               + [_P]),
}
_fns: dict = {}
_libs: dict = {}


def _kernel(entry: str = "frr_launch"):
    """The bound C entry point, its library built and loaded on first
    use."""
    if entry not in _fns:
        from repro_torch.kernels import _build
        name, argtypes = _SIGNATURES[entry]
        if name not in _libs:
            _libs[name] = _build.load(name)
        fn = getattr(_libs[name], entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def _check_edge_args(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                     *tables):
    """Device, dtype, shape and contiguity of a launch's tensors:
    ``tables`` are further (tensor, dtype, name) triples.  A (V, Q) lane
    table is checked as its flat view."""
    dev = gval_m.device
    if gval_m.dim() == 2 and gval_m.is_contiguous():
        gval_m = gval_m.view(-1)
    want = [(gval_m, torch.float32, "gval"), (edge_src, torch.int32, "src"),
            (edge_w, torch.float32, "w"), (edge_mask, torch.bool, "mask"),
            (edge_dst, torch.int32, "ids"), *tables]
    for t, dtype, name in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, gval on {dev}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    e = edge_src.shape[0]
    if any(t.shape[0] != e for t in (edge_w, edge_mask, edge_dst)):
        raise ValueError("edge arrays differ in length")
    if e >= 2**31 - EBLK:
        raise ValueError("edge count exceeds int32 indexing")


def _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                       plan: LaunchPlan, chunk_act):
    """K1's and K3's launch tensors; ``gval_m`` is (V,) or (V, Q)."""
    _check_edge_args(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                     (plan.blk_ptr, torch.int32, "blk_ptr"),
                     (plan.blk_chunk, torch.int32, "blk_chunk"),
                     (chunk_act, torch.bool, "chunk_act"))
    e = edge_src.shape[0]
    if plan.num_edges != e or plan.num_slots != gval_m.shape[0]:
        raise ValueError("launch plan was built for another edge set")
    if chunk_act.shape[0] != _round_up(e, EBLK) // EBLK:
        raise ValueError("chunk_act does not match the edge count")
    if plan.num_segments >= 2**31:
        raise ValueError("segment count exceeds int32 indexing")


def _launch(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan: LaunchPlan,
            chunk_act, relax_kind: str, kind: str, with_debug: bool):
    """Launch the CUDA kernel on the current stream.  Returns the
    (num_segments,) partial and, with ``with_debug``, the (1,) int32
    executed-cell counter.  Raises on any launch error."""
    global launches
    if gval_m.dim() != 1:
        raise ValueError("K1 takes a (V,) value table")
    _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                       chunk_act)
    out = torch.empty(plan.num_segments, dtype=torch.float32,
                      device=gval_m.device)
    dbg = (torch.zeros(1, dtype=torch.int32, device=gval_m.device)
           if with_debug else None)
    stream = torch.cuda.current_stream(gval_m.device).cuda_stream
    rc = _kernel("frr_launch")(
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


# --------------------------------------------------------------------------
# worklist planning (host side)
# --------------------------------------------------------------------------

class Worklist:
    """A planned sparse launch: the live (block, chunk) cells ``wl_i``,
    ``wl_j`` ((l_pad,) int32, j-major, zero past the count) and their
    count ``nlive`` ((1,) int32).  A host plan holds CPU tensors; a
    device plan (``build_device_worklist``) holds tensors on the card,
    and its count is never read on the host."""

    def __init__(self, wl_i, wl_j, nlive):
        self.wl_i = wl_i
        self.wl_j = wl_j
        self.nlive = nlive

    @property
    def l_pad(self) -> int:
        return self.wl_i.shape[0]

    def to(self, device) -> "Worklist":
        return Worklist(self.wl_i.to(device), self.wl_j.to(device),
                        self.nlive.to(device))


class WorklistInfo(typing.NamedTuple):
    """Host-side accounting of one plan (the ``fused_grid_cells`` mirror
    for worklist launches)."""

    cells: int           # live cells after the dst-range empty-cell drop
    launched: int        # padded 1-D grid length
    dense_live: int      # what the dense grid's two-level skip would run
    tile_dmas: int       # value-tile copies (none: the table is resident)
    tile_needed: int
    dma_bytes: int
    # the reference's int32 scalar-prefetch tables for this launch:
    # per-chunk lo/hi/act rows, wl_i/wl_j, nlive
    smem_table_bytes: int


def _wl_pad_len(nlive: int, pad_to: int = WL_PAD) -> int:
    return max(pad_to, 1 << max(nlive - 1, 0).bit_length())


class WorklistPlanner:
    """Precomputes the frontier-independent parts of worklist planning
    for one edge set + segment count, so per-round plans only pay the
    frontier-dependent work (numpy, on the host).

    ``edge_dst``/``edge_mask``/``edge_src`` may be (S, E_max) stacked or
    flat, flattened as the kernels flatten them.  The (block, chunk)
    cells whose ranges meet are kept as a j-major list (never as the
    dense (n_sblk, n_chunks) matrix); ``plan(gchg)`` returns
    (Worklist, WorklistInfo) equal to the reference planner's pinned
    plan.  ``path='tiled'`` raises: that is kernel K6."""

    def __init__(self, edge_dst, edge_mask, edge_src, num_segments: int,
                 *, path: str = "pinned",
                 smem_budget_bytes: int | None = None):
        if path != "pinned":
            raise NotImplementedError(
                "the tiled worklist path is not ported yet (ROADMAP Queue "
                "2, kernel K6): the value table stays resident in device "
                "memory")
        ids = np.asarray(edge_dst).reshape(-1)
        mask = np.asarray(edge_mask).reshape(-1).astype(bool)
        srcs = np.asarray(edge_src).reshape(-1)
        e = ids.shape[0]
        e_pad = _round_up(e, EBLK)
        self.n_i = _round_up(num_segments, SBLK) // SBLK
        self.n_chunks = e_pad // EBLK
        self.path = path
        self.smem_budget_bytes = smem_budget_bytes
        self._smem_warned = False

        idc = np.zeros(e_pad, np.int64)
        idc[:e] = ids
        mkc = np.zeros(e_pad, bool)
        mkc[:e] = mask
        srcc = np.zeros(e_pad, np.int64)
        srcc[:e] = srcs
        self.mask = mkc.reshape(self.n_chunks, EBLK)
        self.srcs = srcc.reshape(self.n_chunks, EBLK)
        idc = idc.reshape(self.n_chunks, EBLK)
        lo = np.where(self.mask, idc, np.iinfo(np.int64).max).min(axis=1)
        hi = np.where(self.mask, idc, -1).max(axis=1)
        i_lo = np.maximum(lo // SBLK, 0)
        i_hi = np.minimum(hi // SBLK, self.n_i - 1)
        nb = np.maximum(i_hi - i_lo + 1, 0)
        # the cells whose ranges meet, j-major: np.nonzero(intersects.T)
        self.cell_j = np.repeat(np.arange(self.n_chunks), nb)
        first = np.cumsum(nb) - nb
        self.cell_i = i_lo[self.cell_j] + np.arange(self.cell_j.shape[0]) \
            - first[self.cell_j]
        # each edge's own cell, keyed j-major (j * n_i + dst block)
        self.edge_cell = (np.arange(self.n_chunks)[:, None] * self.n_i
                          + idc // SBLK)

    @property
    def total_cells(self) -> int:
        """The reference's dense grid, the denominator of 'auto'."""
        return self.n_i * self.n_chunks

    @property
    def launch_cells(self) -> int:
        """Cells the port's dense launch walks (``LaunchPlan.num_cells``)."""
        return self.cell_j.shape[0]

    def _live_map(self, gchg):
        gchg = _or_lanes(np.asarray(gchg)).reshape(-1)
        act = self.mask & gchg[self.srcs]        # (n_chunks, EBLK)
        live = act.any(axis=1)[self.cell_j]      # per listed cell
        return act, live

    def live_fraction(self, gchg) -> float:
        """Fraction of the dense grid the two-level skip would execute —
        the signal ``grid_mode='auto'`` keys the dense/worklist choice on."""
        _, live = self._live_map(gchg)
        return live.sum() / max(self.total_cells, 1)

    def dense_mirror(self, gchg) -> dict:
        """Mirror of the dense launch (K1) for this edge set: ``cells`` it
        executes and ``launched``, the cells its blocks walk."""
        _, live = self._live_map(gchg)
        return {"cells": int(live.sum()), "launched": self.launch_cells,
                "tile_dmas": 0, "dma_bytes": 0}

    def plan(self, gchg, pad_to: int = WL_PAD, dst_filter: bool = True,
             max_live_fraction: float | None = None):
        """Plan one round's launch from the (V,) bool frontier (a (V, Q)
        lane frontier is OR'd across lanes).

        j-major cell order (j outer, i inner).  With ``dst_filter`` a
        cell is kept only if one of its chunk's active edges lands in its
        block — the reference drops the others, which contribute only
        the identity.  ``max_live_fraction`` implements 'auto': when the
        dense grid's live fraction is at or above it, return (None, None)
        before any per-cell work."""
        act, live = self._live_map(gchg)
        dense_live = int(live.sum())
        if max_live_fraction is not None \
                and dense_live / max(self.total_cells, 1) \
                >= max_live_fraction:
            return None, None
        if dst_filter:
            hit = np.zeros(self.total_cells, bool)
            hit[self.edge_cell[act]] = True
            jj, ii = np.divmod(np.flatnonzero(hit), self.n_i)
        else:
            jj, ii = self.cell_j[live], self.cell_i[live]
        nlive = int(ii.shape[0])
        l_pad = _wl_pad_len(nlive, pad_to)
        wl_i = np.zeros(l_pad, np.int32)
        wl_j = np.zeros(l_pad, np.int32)
        wl_i[:nlive] = ii
        wl_j[:nlive] = jj
        wl = Worklist(torch.from_numpy(wl_i), torch.from_numpy(wl_j),
                      torch.tensor([nlive], dtype=torch.int32))
        info = WorklistInfo(
            cells=nlive, launched=l_pad, dense_live=dense_live,
            tile_dmas=0, tile_needed=0, dma_bytes=0,
            smem_table_bytes=4 * (3 * self.n_chunks + 2 * l_pad + 1))
        return wl, self._check_smem(info)

    def _check_smem(self, info: WorklistInfo) -> WorklistInfo:
        if self.smem_budget_bytes is not None and not self._smem_warned \
                and info.smem_table_bytes > self.smem_budget_bytes:
            self._smem_warned = True
            warnings.warn(
                f"worklist tables ({info.launched} cells, {self.n_chunks} "
                f"chunks) weigh {info.smem_table_bytes} bytes — over "
                f"smem_budget_bytes={self.smem_budget_bytes}; prefer "
                "grid_mode='auto' (dense frontiers keep the dense grid)",
                stacklevel=3)
        return info


def plan_worklist(edge_dst, edge_mask, edge_src, gchg, num_segments: int,
                  *, path="pinned", pad_to: int = WL_PAD,
                  dst_filter: bool = True):
    """One-shot worklist plan (see ``WorklistPlanner`` for the reusable
    form drivers amortize across rounds)."""
    planner = WorklistPlanner(edge_dst, edge_mask, edge_src, num_segments,
                              path=path)
    return planner.plan(gchg, pad_to=pad_to, dst_filter=dst_filter)


# --------------------------------------------------------------------------
# device-side worklist compaction (grid_mode='device_worklist')
# --------------------------------------------------------------------------
# The device twin of WorklistPlanner.plan(dst_filter=False): the launch
# plan's j-major cell list, filtered by the chunk frontier bits and
# compacted by a cumsum-scatter into fixed-length wl_i / wl_j, with the
# live count left on the device.  The length is static per partition, so
# rounds enqueue without a host sync.  The reference pads to the power of
# two above the FULL (n_sblk, n_chunks) grid (8.5 M cells at RMAT-18, so
# about 17 GB of K2 partials); this pads above the cells whose ranges
# meet (about 40 k at RMAT-18, 64 MiB of partials).


def device_worklist_pad(plan: LaunchPlan) -> int:
    """Static length of a device-compacted worklist for ``plan``."""
    return _wl_pad_len(plan.num_cells)


def _compact_live_cells(plan: LaunchPlan, chunk_act, l_pad: int):
    """Cumsum-scatter frontier compaction of the plan's j-major cells:
    fixed-shape ``wl_i``/``wl_j`` and the (1,) live count.  Dead cells
    scatter to a dropped slot; the tail keeps cell (0, 0), never run."""
    live = torch.index_select(chunk_act, 0, plan.cell_j)
    pos = torch.cumsum(live, 0) - 1
    idx = torch.where(live, pos, l_pad)
    dev = chunk_act.device
    wl_i = torch.zeros(l_pad + 1, dtype=torch.int32, device=dev)
    wl_j = torch.zeros(l_pad + 1, dtype=torch.int32, device=dev)
    wl_i.scatter_(0, idx, plan.cell_i)
    wl_j.scatter_(0, idx, plan.cell_j)
    nlive = live.sum(dtype=torch.int32).view(1)
    return Worklist(wl_i[:l_pad], wl_j[:l_pad], nlive)


def build_device_worklist(gchg, edge_src, edge_mask, edge_dst,
                          num_segments: int,
                          plan: LaunchPlan | None = None) -> Worklist:
    """The ``grid_mode='device_worklist'`` plan, built with torch ops on
    the frontier's device.  Its cells equal
    ``WorklistPlanner.plan(gchg, dst_filter=False)``'s, in order.  A
    (V, Q) lane frontier is OR'd across lanes."""
    if plan is None:
        plan = plan_launch(edge_src, edge_mask, edge_dst, num_segments,
                           gchg.shape[0])
    chunk_act, _ = _chunk_tables(edge_src, edge_mask, _or_lanes(gchg))
    return _compact_live_cells(plan, chunk_act, device_worklist_pad(plan))


def _launch_worklist(gchg, edge_src, edge_mask, edge_dst,
                     num_segments: int) -> Worklist:
    """Plan a host worklist at launch time from the tensors (copied to
    the host; a (V, Q) frontier is OR'd across lanes): the convenience
    the differential tests drive; round drivers plan with a
    ``WorklistPlanner`` instead."""
    wl, _ = plan_worklist(
        *(t.detach().cpu().numpy() for t in (edge_dst, edge_mask, edge_src,
                                              gchg)), num_segments)
    return wl


# --------------------------------------------------------------------------
# K2: the worklist launch on the card
# --------------------------------------------------------------------------

def _wl_cells(gval_m, edge_src, edge_w, edge_mask, edge_dst, wl: Worklist,
              grid: int, relax_kind: str, kind: str, with_debug: bool):
    """K2 proper: one block per live cell over ``grid`` blocks, writing
    the (l_pad, SBLK) partials.  ``wl`` must already be on the card."""
    dev = gval_m.device
    partials = torch.empty((wl.l_pad, SBLK), dtype=torch.float32, device=dev)
    dbg = torch.zeros(1, dtype=torch.int32, device=dev) if with_debug \
        else None
    rc = _kernel("frr_wl_launch")(
        gval_m.data_ptr(), edge_src.data_ptr(), edge_w.data_ptr(),
        edge_mask.data_ptr(), edge_dst.data_ptr(), wl.wl_i.data_ptr(),
        wl.wl_j.data_ptr(), wl.nlive.data_ptr(), edge_src.shape[0], grid,
        partials.data_ptr(), dbg.data_ptr() if dbg is not None else None,
        _RELAX_CODE[relax_kind], _KIND_CODE[kind],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce_wl launch failed: "
                           f"cudaError {rc}")
    return partials, dbg


def _wl_order(wl: Worklist, num_segments: int):
    """The folds' cell order: each segment block's cells in cell-list
    order — a stable sort of ``wl_i`` with the cells past the count keyed
    past every block — as (n_i, order, ptr), on the worklist's device."""
    dev = wl.wl_i.device
    n_i = _round_up(num_segments, SBLK) // SBLK
    cells = torch.arange(wl.l_pad, dtype=torch.int32, device=dev)
    key = torch.where(cells < wl.nlive, wl.wl_i, n_i)
    key, order = torch.sort(key, stable=True)
    ptr = torch.searchsorted(
        key, torch.arange(n_i + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return n_i, order, ptr


def _wl_fold(partials, wl: Worklist, num_segments: int, kind: str):
    """K2's fold (the reference's ``_scatter_partials``): each block's
    cells combined into the inbox in cell-list order (``_wl_order``)."""
    dev = partials.device
    n_i, order, ptr = _wl_order(wl, num_segments)
    out = torch.empty(num_segments, dtype=torch.float32, device=dev)
    rc = _kernel("frr_wl_fold")(
        partials.data_ptr(), order.data_ptr(), ptr.data_ptr(), n_i,
        num_segments, out.data_ptr(), _KIND_CODE[kind],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce_wl fold failed: "
                           f"cudaError {rc}")
    return out


def _wl_grid(wl: Worklist, dev) -> int:
    """K2's grid: exactly ``nlive`` blocks for a host plan (whose count
    the host holds), else a fixed few blocks per SM striding over the
    count in device memory."""
    if wl.nlive.device.type == "cpu":
        return max(int(wl.nlive[0]), 1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(wl.l_pad, WL_BLOCKS_PER_SM * n_sm)


def _wl_on_card(gval_m, edge_src, edge_w, edge_mask, edge_dst,
               wl: Worklist, num_segments: int):
    """Check a worklist against the launch grid (host plans only: a
    device plan's count is never read) and move it to the card.  Returns
    (K2/K4 grid, worklist on the card)."""
    dev = gval_m.device
    if wl.nlive.device.type == "cpu":     # a host plan: check its cells
        n = int(wl.nlive[0])
        n_chunks = _round_up(edge_src.shape[0], EBLK) // EBLK
        if not 0 <= n <= wl.l_pad or (n and (
                int(wl.wl_j[:n].max()) >= n_chunks
                or int(wl.wl_i[:n].max()) * SBLK >= max(num_segments, 1)
                or int(wl.wl_i[:n].min()) < 0
                or int(wl.wl_j[:n].min()) < 0)):
            raise ValueError("worklist cells outside the launch grid")
    grid = _wl_grid(wl, dev)
    wl = wl.to(dev)
    _check_edge_args(gval_m, edge_src, edge_w, edge_mask,
                     edge_dst, (wl.wl_i, torch.int32, "wl_i"),
                     (wl.wl_j, torch.int32, "wl_j"),
                     (wl.nlive, torch.int32, "nlive"))
    if wl.wl_j.shape[0] != wl.l_pad or wl.nlive.shape[0] != 1:
        raise ValueError("worklist arrays differ in length")
    return grid, wl


def _launch_wl(gval_m, edge_src, edge_w, edge_mask, edge_dst, wl: Worklist,
               num_segments: int, relax_kind: str, kind: str,
               with_debug: bool):
    """Launch K2 and its fold on the current stream.  A host plan (CPU
    tensors) is copied to the card; a device plan stays there and nothing
    here waits for the card.  Returns the (num_segments,) inbox partial
    and, with ``with_debug``, the (1,) int32 executed-cell count.  Raises
    on any launch error."""
    global wl_launches
    if gval_m.dim() != 1:
        raise ValueError("K2 takes a (V,) value table")
    grid, wl = _wl_on_card(gval_m, edge_src, edge_w, edge_mask, edge_dst, wl,
                           num_segments)
    partials, dbg = _wl_cells(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                              wl, grid, relax_kind, kind, with_debug)
    out = _wl_fold(partials, wl, num_segments, kind)
    wl_launches += 1
    return out, dbg


# --------------------------------------------------------------------------
# K3 and K4: the lane-batched launches on the card
# --------------------------------------------------------------------------

def wl_lanes_partial_bytes(l_pad: int, q: int) -> int:
    """Bytes of K4's (l_pad, SBLK, Q) float32 partial buffer."""
    return l_pad * SBLK * q * 4


def _check_lane_tables(gval_m, unitw):
    if gval_m.dtype != torch.float32 or gval_m.dim() != 2 \
            or not gval_m.is_contiguous():
        raise ValueError(f"gval must be a contiguous (V, Q) float32; got "
                         f"{gval_m.dtype} {tuple(gval_m.shape)}")
    q = gval_m.shape[1]
    if unitw.device != gval_m.device or unitw.dtype != torch.uint8 \
            or unitw.shape != (q,) or not unitw.is_contiguous():
        raise ValueError(f"lane_unitw must be a contiguous ({q},) uint8 on "
                         f"{gval_m.device}")
    if not 1 <= q < 2**31 // SBLK:
        raise ValueError(f"lane count {q} outside [1, {2**31 // SBLK})")


def _launch_lanes(gval_m, unitw, edge_src, edge_w, edge_mask, edge_dst,
                  plan: LaunchPlan, chunk_act, relax_kind: str, kind: str,
                  with_debug: bool):
    """Launch K3 on the current stream: one block per (segment block,
    group of 32 lanes).  Returns the (num_segments, Q) partial
    and, with ``with_debug``, the (1,) int32 executed-cell counter.
    Raises on any launch error."""
    global lanes_launches
    _check_lane_tables(gval_m, unitw)
    _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                       chunk_act)
    q = gval_m.shape[1]
    dev = gval_m.device
    out = torch.empty((plan.num_segments, q), dtype=torch.float32,
                      device=dev)
    dbg = torch.zeros(1, dtype=torch.int32, device=dev) if with_debug \
        else None
    rc = _kernel("frr_lanes_launch")(
        gval_m.data_ptr(), edge_src.data_ptr(), edge_w.data_ptr(),
        edge_mask.data_ptr(), edge_dst.data_ptr(), unitw.data_ptr(),
        plan.blk_ptr.data_ptr(), plan.blk_chunk.data_ptr(),
        chunk_act.data_ptr(), edge_src.shape[0], plan.num_segments,
        plan.num_blocks, q, out.data_ptr(),
        dbg.data_ptr() if dbg is not None else None,
        _RELAX_CODE[relax_kind], _KIND_CODE[kind],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce_lanes launch failed: "
                           f"cudaError {rc}")
    lanes_launches += 1
    return out, dbg


def _check_partial_room(nbytes: int, dev):
    """Raise, with the byte count, when K4's partial buffer cannot be
    allocated: it must fit in the allocator's free cache plus the card's
    free memory.  Nothing here waits for the card."""
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    if nbytes <= cached:
        return
    free, _ = torch.cuda.mem_get_info(dev)
    if nbytes > free + cached:
        raise RuntimeError(
            f"K4's partial buffer needs {nbytes} bytes (l_pad x {SBLK} x Q "
            f"x 4); the card has {free + cached} free")


def _wl_lanes_cells(gval_m, unitw, edge_src, edge_w, edge_mask, edge_dst,
                    wl: Worklist, grid: int, relax_kind: str, kind: str,
                    with_debug: bool):
    """K4 proper: ``grid`` blocks per lane group over the live cells,
    writing the (l_pad, SBLK, Q) partials.  ``wl`` must already be on the
    card."""
    dev = gval_m.device
    q = gval_m.shape[1]
    _check_partial_room(wl_lanes_partial_bytes(wl.l_pad, q), dev)
    partials = torch.empty((wl.l_pad, SBLK, q), dtype=torch.float32,
                           device=dev)
    dbg = torch.zeros(1, dtype=torch.int32, device=dev) if with_debug \
        else None
    rc = _kernel("frr_wl_lanes_launch")(
        gval_m.data_ptr(), edge_src.data_ptr(), edge_w.data_ptr(),
        edge_mask.data_ptr(), edge_dst.data_ptr(), unitw.data_ptr(),
        wl.wl_i.data_ptr(), wl.wl_j.data_ptr(), wl.nlive.data_ptr(),
        edge_src.shape[0], grid, q, partials.data_ptr(),
        dbg.data_ptr() if dbg is not None else None,
        _RELAX_CODE[relax_kind], _KIND_CODE[kind],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce_wl_lanes launch failed: "
                           f"cudaError {rc}")
    return partials, dbg


def _wl_lanes_fold(partials, wl: Worklist, num_segments: int, kind: str):
    """K4's laned fold: each block's (SBLK, Q) partials combined into the
    (num_segments, Q) inbox in cell-list order (``_wl_order``)."""
    dev = partials.device
    q = partials.shape[2]
    n_i, order, ptr = _wl_order(wl, num_segments)
    out = torch.empty((num_segments, q), dtype=torch.float32, device=dev)
    rc = _kernel("frr_wl_lanes_fold")(
        partials.data_ptr(), order.data_ptr(), ptr.data_ptr(), n_i,
        num_segments, q, out.data_ptr(), _KIND_CODE[kind],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce_wl_lanes fold failed: "
                           f"cudaError {rc}")
    return out


def _launch_wl_lanes(gval_m, unitw, edge_src, edge_w, edge_mask, edge_dst,
                     wl: Worklist, num_segments: int, relax_kind: str,
                     kind: str, with_debug: bool):
    """Launch K4 and its laned fold on the current stream, as
    ``_launch_wl`` does K2.  Returns the (num_segments, Q) inbox partial
    and, with ``with_debug``, the (1,) int32 executed-cell count."""
    global wl_lanes_launches
    _check_lane_tables(gval_m, unitw)
    grid, wl = _wl_on_card(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                           wl, num_segments)
    partials, dbg = _wl_lanes_cells(gval_m, unitw, edge_src, edge_w,
                                    edge_mask, edge_dst, wl, grid,
                                    relax_kind, kind, with_debug)
    out = _wl_lanes_fold(partials, wl, num_segments, kind)
    wl_lanes_launches += 1
    return out, dbg


def _pack(out, count, dbg, with_count: bool, with_debug: bool):
    """out / (out, count) / (out, dbg) / (out, count, dbg)."""
    res = (out,)
    if with_count:
        res += (count,)
    if with_debug:
        res += (dbg,)
    return res[0] if len(res) == 1 else res


def fused_relax_reduce(gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
                       num_segments: int, relax_kind: str, kind: str,
                       with_count: bool = False, with_debug: bool = False,
                       plan: LaunchPlan | None = None,
                       grid_mode: str = "dense",
                       worklist: Worklist | None = None):
    """Fused gather/relax/mask/segment-reduce.

    gval: (V,) f32 vertex (replica-slot) values; gchg: (V,) bool changed
    flags (the frontier); edge_src/edge_dst: (E,) int32 into [0, V) /
    [0, num_segments); edge_w: (E,) f32; edge_mask: (E,) bool (False on
    padding).  Returns the (num_segments,) inbox partial — empty segments
    hold the combine identity.  ``with_count=True`` appends the int32
    active-edge count; ``with_debug=True`` appends the (1,) int32 count of
    executed (block, chunk) cells.  ``plan`` is ``plan_launch`` of these
    edges, built here when absent (callers that launch every round build
    it once).  Edges should be sorted by ``edge_dst`` for the range skip
    to bite; correctness never depends on the sort.

    ``worklist=`` (a host plan from ``WorklistPlanner`` or a device plan
    from ``build_device_worklist``) runs the worklist launch K2;
    ``grid_mode='worklist'`` plans one on the host here and
    ``grid_mode='device_worklist'`` compacts one on the device.  Any
    other ``grid_mode`` keeps the dense launch K1.  Min results are
    bit-identical across launches; sums differ by reassociation only.

    CUDA tensors launch the kernels; CPU tensors run the plain versions.
    """
    _check_pair(relax_kind, kind)
    identity = math.inf if kind == "min" else 0.0
    dev = gval.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {gval.device}")
    if worklist is None and grid_mode == "worklist":
        worklist = _launch_worklist(gchg, edge_src, edge_mask, edge_dst,
                                    num_segments)
    need_plan = worklist is None and (
        dev == "cuda" or with_debug or grid_mode == "device_worklist")
    if need_plan and plan is None:
        plan = plan_launch(edge_src, edge_mask, edge_dst, num_segments,
                           gval.shape[0])
    chunk_act, count = _chunk_tables(edge_src, edge_mask, gchg)
    if worklist is None and grid_mode == "device_worklist":
        worklist = _compact_live_cells(plan, chunk_act,
                                       device_worklist_pad(plan))
    if dev == "cuda":
        gval_m = _masked_value_tables(gval, gchg, identity)
        if worklist is not None:
            out, dbg = _launch_wl(gval_m, edge_src, edge_w, edge_mask,
                                  edge_dst, worklist, num_segments,
                                  relax_kind, kind, with_debug)
        else:
            out, dbg = _launch(gval_m, edge_src, edge_w, edge_mask,
                               edge_dst, plan, chunk_act, relax_kind, kind,
                               with_debug)
    elif worklist is not None:
        out = fused_relax_reduce_wl_ref(
            gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
            worklist.wl_i, worklist.wl_j, worklist.nlive, num_segments,
            relax_kind, kind)
        dbg = worklist.nlive.clone() if with_debug else None
    else:
        out = fused_relax_reduce_ref(gval, gchg, edge_src, edge_w,
                                     edge_mask, edge_dst, num_segments,
                                     relax_kind, kind)
        dbg = _executed_cells(plan, chunk_act) if with_debug else None
    return _pack(out, count, dbg, with_count, with_debug)


def fused_relax_reduce_lanes(gval, gchg, lane_unitw, edge_src, edge_w,
                             edge_mask, edge_dst, num_segments: int,
                             relax_kind: str, kind: str,
                             with_count: bool = False,
                             with_debug: bool = False,
                             plan: LaunchPlan | None = None,
                             grid_mode: str = "dense",
                             worklist: Worklist | None = None):
    """Lane-batched fused gather/relax/mask/segment-reduce.

    ``gval``/``gchg``: (V, Q) per-lane values and frontiers over one
    shared edge set (shapes of the edges as in ``fused_relax_reduce``).
    Returns the (num_segments, Q) per-lane inbox partial; ``with_count``
    appends the (Q,) int32 per-lane active-edge counts, ``with_debug``
    the (1,) int32 executed-cell count.  ``lane_unitw`` (Q,) only
    matters for ``relax_kind='add_w'``: a lane with a nonzero flag relaxes
    with weight 1.0 (BFS levels) instead of the edge weight (SSSP), so one
    launch serves a mixed BFS/SSSP batch.  A converged lane has an
    all-False frontier column and contributes the identity everywhere;
    the chunk skip is the OR across lanes.

    The dense launch is K3; ``worklist=`` (a host plan, from the
    OR-across-lanes frontier) or ``grid_mode='worklist' |
    'device_worklist'`` runs K4 and its fold.  There is no lane padding:
    any Q gives the columns its lanes would give alone.  Min results are
    bit-identical across launches; sums differ by reassociation only.

    CUDA tensors launch the kernels; CPU tensors run the plain versions.
    """
    if relax_kind not in LANE_RELAX_KINDS:
        raise ValueError(
            f"laned relax supports relax_kind 'add_w'|'mul_w', got "
            f"{relax_kind!r} (express BFS lanes with lane_unitw=1)")
    _check_pair(relax_kind, kind)
    if gval.dim() != 2 or gchg.shape != gval.shape:
        raise ValueError(f"gval and gchg must be (V, Q); got "
                         f"{tuple(gval.shape)} and {tuple(gchg.shape)}")
    identity = math.inf if kind == "min" else 0.0
    dev = gval.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {gval.device}")
    unitw = torch.as_tensor(lane_unitw).reshape(gval.shape[1]).to(
        device=gval.device)
    if worklist is None and grid_mode == "worklist":
        worklist = _launch_worklist(gchg, edge_src, edge_mask, edge_dst,
                                    num_segments)
    need_plan = worklist is None and (
        dev == "cuda" or with_debug or grid_mode == "device_worklist")
    if need_plan and plan is None:
        plan = plan_launch(edge_src, edge_mask, edge_dst, num_segments,
                           gval.shape[0])
    chunk_act, counts = _lane_chunk_tables(
        edge_src, edge_mask, gchg, None if plan is None else plan.src_deg)
    if worklist is None and grid_mode == "device_worklist":
        worklist = _compact_live_cells(plan, chunk_act,
                                       device_worklist_pad(plan))
    if dev == "cuda":
        gval_m = _masked_value_tables(gval, gchg, identity)
        unit_u8 = (unitw != 0).to(torch.uint8)
        if worklist is not None:
            out, dbg = _launch_wl_lanes(gval_m, unit_u8, edge_src, edge_w,
                                        edge_mask, edge_dst, worklist,
                                        num_segments, relax_kind, kind,
                                        with_debug)
        else:
            out, dbg = _launch_lanes(gval_m, unit_u8, edge_src, edge_w,
                                     edge_mask, edge_dst, plan, chunk_act,
                                     relax_kind, kind, with_debug)
    elif worklist is not None:
        out = fused_relax_reduce_wl_lanes_ref(
            gval, gchg, unitw, edge_src, edge_w, edge_mask, edge_dst,
            worklist.wl_i, worklist.wl_j, worklist.nlive, num_segments,
            relax_kind, kind)
        dbg = worklist.nlive.clone() if with_debug else None
    else:
        out = fused_relax_reduce_lanes_ref(gval, gchg, unitw, edge_src,
                                           edge_w, edge_mask, edge_dst,
                                           num_segments, relax_kind, kind)
        dbg = _executed_cells(plan, chunk_act) if with_debug else None
    return _pack(out, counts, dbg, with_count, with_debug)


# --------------------------------------------------------------------------
# host-side launch mirror (grid-cell accounting)
# --------------------------------------------------------------------------

def fused_grid_cells(edge_dst, edge_mask, edge_src, gchg,
                     num_segments: int) -> dict:
    """Host-side mirror of the fused launch over an edge stack.

    Edge arrays are (S, E_max) host arrays, or 1-D for a single flat
    launch; ``gchg`` is the (V,) frontier, or a (V, Q) lane frontier,
    OR'd across lanes (the laned launches skip on the OR).  Returns
    ``total_fused`` (the reference's dense (segment block, chunk) grid),
    ``launch_cells`` (the (block, chunk) pairs whose range meets, which
    this port's blocks walk) and ``fused_live`` (those whose chunk is
    frontier-live: the cells the kernel executes, equal to its
    ``with_debug`` count and to the reference grid's live cells)."""
    planner = WorklistPlanner(edge_dst, edge_mask, edge_src, num_segments)
    d = planner.dense_mirror(gchg)
    return {"total_fused": planner.total_cells,
            "launch_cells": d["launched"], "fused_live": d["cells"]}
