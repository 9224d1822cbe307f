"""Fused frontier-aware relax + segment reduce: the round's relax phase.

One engine round's relax phase,

    src_val = gval[edge_src]                  # gather
    active  = edge_mask & gchg[edge_src]      # frontier mask
    msg     = where(active, relax(src_val, w), identity)
    inbox   = segment_reduce(msg, edge_dst)   # min or sum

runs as one CUDA kernel launch that never writes a per-edge array to
device memory.  The frontier mask is folded into the value table before
launch (``_masked_value_tables``): inactive sources read as the absorbing
identity, ``relax(identity, w) == identity`` for every supported pairing,
so the kernel gathers one table.

Blocking keeps the reference's ``EBLK``-edge chunks and ``SBLK``-wide
segment blocks, and its two skips:

1. **Sorted-range skip** — edges are sorted by destination within each
   shard, so chunk *j* covers ids ``[lo_j, hi_j]``.  ``plan_launch``
   lists, once per partition, the chunks whose range meets each segment
   block: the planned cells (a CSR, ``LaunchPlan``).
2. **Frontier chunk skip** — ``chunk_act[j]`` says whether any valid edge
   of chunk *j* has a changed source this round (``_chunk_tables``, torch
   ops, which also yield the active-edge message count).  A dead chunk's
   edges are never read.

**One launch shape for every kernel** (``csrc/frr_common.cuh``).  The
first launch of a plan cuts each segment block's planned cells into
pieces of at most ``PIECE_CELLS`` consecutive cells (``plan_pieces``)
and finds each cell's batch range, the 32-edge batches of its chunk that
hold a valid edge of its block (``plan_batches``), with no host sync,
and keeps both on the plan.  A thread block takes one piece, walks its
cells in chunk order, runs the cells of the round, folds only a cell's
batch range and keeps one accumulator for the piece.  A block that is
one piece writes the inbox; the pieces of a split block write their
partials to a small buffer, and the last to arrive folds them in piece
order, so sums repeat bit for bit.  The dense launch (kernel K1,
``csrc/fused_relax_reduce_wl.cu``) runs the planned cells whose chunk is
live: exactly the TPU grid's live (block, chunk) cells, which
``with_debug`` counts and ``fused_grid_cells`` mirrors on the host.

**Worklist launches** (``grid_mode='worklist' | 'device_worklist'``, or
an explicit ``worklist=``) run K1's launch over the cells a worklist
lists (kernel K2): a flag byte per planned cell.  The host planner
(``WorklistPlanner``, numpy, with the reference's dst filter that drops
cells holding no active edge of their block) fills them and the launch
uploads them in one copy; a device plan (``grid_mode='device_worklist'``)
needs none, as the kernel reads each cell's chunk frontier bit (K1's
cells); a worklist given as ``wl_i``/``wl_j``/``nlive`` alone is mapped
onto them on the card (``worklist_flags``).  On the same cells K2's bits
are K1's.  ``Worklist`` keeps the reference's j-major
``wl_i``/``wl_j``/``nlive``; ``build_device_worklist`` still compacts
them on the device (no host sync; its length is static: the power of two
above the launch plan's cell count).

**Lane-batched launches** (``fused_relax_reduce_lanes``) run the same
math over a (V, Q) table of query lanes that share one edge set: kernels
K3 (dense) and K4 (worklist), one launch
(``csrc/fused_relax_reduce_wl_lanes.cu``) over the same pieces with a
lane-group grid axis.  Their cell spreads a cell's edges over every warp
of the block and has the owners of each (segment, lane) combine the
warps' partials in position order (``csrc/frr_lanes.cuh``).  The chunk
frontier bit is the OR across lanes, the message counts are per lane,
and plans are made from the OR-across-lanes frontier:
``WorklistPlanner``, ``plan_worklist``, ``build_device_worklist`` and
``fused_grid_cells`` accept a (V, Q) frontier and OR it.

**Residency** (``select_kernel_path``): a value table whose padded
bytes exceed the budget (``vmem_budget_bytes``, the ``REPRO_VMEM_BUDGET``
env var, else ``DEFAULT_VMEM_BUDGET_BYTES``) runs *tiled*, through
kernels K5 (dense), K6 (worklist), K7 (dense lanes) and K8 (worklist
lanes), sharing ``csrc/frr_tiles.cuh``.  Each live cell copies with
``cp.async`` only the source rows it reads (its active edges' sources,
from the (E,) active flags) into a shared-memory row buffer indexed by
chunk position, and folds them with its pinned twin's own fold; K5/K6
run one launch (``csrc/fused_relax_reduce_wl_tiled.cu``) and K7/K8
another (``..._wl_tiled_lanes.cu``), K1's launch shape with the same
pieces, flags and combine.  K5 and K6 equal K1 and K2, K7 and K8 equal
K3 and K4, bit for bit, sum included.  No tiled launch builds a tile
table; the reference's tile lists, copy schedule and copy counts stay as
a mirror off the launch path (``_chunk_tile_tables``, ``tile_schedule``,
``plan(..., tile_lists=True)``, ``dense_mirror(..., tile_lists=True)``).
The default budget keeps every table the card can hold on the pinned
kernels K1–K4; a budget set through the config or the env var, or
``path=``/``vblk=``, reaches the tiled ones.

On a CPU tensor ``fused_relax_reduce`` runs the plain versions
(``ref.fused_relax_reduce_ref``, ``ref.fused_relax_reduce_wl_ref`` and
their tiled forms) and ``fused_relax_reduce_lanes`` theirs; on a CUDA
tensor they launch the kernels, or raise.  ``launches``,
``wl_launches``, ``lanes_launches``, ``wl_lanes_launches``,
``tiled_launches``, ``wl_tiled_launches``, ``tiled_lanes_launches`` and
``wl_tiled_lanes_launches`` count K1–K8 launches, each kernel apart
where two share a CUDA kernel.
"""
from __future__ import annotations

import ctypes
import math
import os
import typing
import warnings

import numpy as np
import torch

from repro_torch.core.actions import RELAX_FNS
from repro_torch.kernels import ref

EBLK = 512   # edge-axis chunk (matches csrc/frr_common.cuh)
SBLK = 256   # segment-axis block (matches csrc/frr_common.cuh)

WL_PAD = 8      # host worklists are padded to >= this many cells and then
                # to a power of two, as the reference pads its launches
PIECE_CELLS = 8        # planned cells a K1-K8 block takes at most
                       # (PERF.md: the sweep over 4, 8, 16 and 32; K9
                       # has its own cut, rhizome_segment_reduce.py)


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
# ``_launch_lanes`` (K3), ``_launch_wl_lanes`` (K4), ``_launch_tiled``
# (K5), ``_launch_wl_tiled`` (K6), ``_launch_tiled_lanes`` (K7) and
# ``_launch_wl_tiled_lanes`` (K8) since the counts were last set to 0
launches = 0
wl_launches = 0
lanes_launches = 0
wl_lanes_launches = 0
tiled_launches = 0
wl_tiled_launches = 0
tiled_lanes_launches = 0
wl_tiled_lanes_launches = 0

# The value-table budget above which launches go tiled.  The reference's
# 12 MiB is three quarters of a TPU core's VMEM, the fast memory its
# pinned kernels copy the whole table into.  Nothing here plays that
# part: K1-K4 gather from device memory at any table size.  So the
# default is the H100's 80 GiB of device memory, which keeps every table
# the card can hold on the pinned kernels; a smaller budget (the config
# field, the env var) sends the launches to the tiled kernels K5-K8.
DEFAULT_VMEM_BUDGET_BYTES = 80 * 2**30
VMEM_BUDGET_ENV = "REPRO_VMEM_BUDGET"

# The shared-memory room that sizes the automatic tile width.  On a TPU
# the double buffer of two vblk-wide tiles sits in VMEM, so the
# reference sizes vblk from the table budget.  No kernel here allocates a
# tile: K5-K8 stage rows (K5/K6 two (EBLK,) slots, 4 KB; K7/K8 a row
# buffer of 2 * (EBLK / 2) * min(Q, 32) * 4 bytes, at most 64 KB).  The
# automatic vblk, the widest 128-multiple whose two tiles of min(Q, 32)
# lanes fit this room (12,288 slots at one lane, 768 at 16), shapes only
# the reference's tile accounting, mirrored off the launch path.
TILE_SMEM_BYTES = 96 * 1024
LGRP = 32        # lanes a laned block serves (csrc/frr_lanes.cuh)


def _round_up(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


# --------------------------------------------------------------------------
# residency: pinned or tiled value table
# --------------------------------------------------------------------------

def resolve_vmem_budget(vmem_budget_bytes=None) -> int:
    """The byte budget the value table must live within: an explicit
    argument wins, else the ``REPRO_VMEM_BUDGET`` env var (an empty one
    counts as unset), else ``DEFAULT_VMEM_BUDGET_BYTES``."""
    if vmem_budget_bytes is not None:
        return int(vmem_budget_bytes)
    env = os.environ.get(VMEM_BUDGET_ENV)
    if env:
        return int(env)
    return DEFAULT_VMEM_BUDGET_BYTES


def smem_table_bytes(n_chunks: int, t_max: int = 0,
                     wl_cells: int = 0) -> int:
    """Bytes of the int32 index tables one fused launch reads, priced as
    the reference prices its scalar-prefetch tables: the per-chunk
    lo/hi/act rows, plus (tiled) the per-chunk tile lists, plus
    (worklist) ``wl_i``/``wl_j``/``nlive`` and — when both — the per-cell
    tile/slot/fetch tables.  ``t_max`` is the tile-list width (0 =
    pinned), ``wl_cells`` the padded worklist length (0 = dense)."""
    rows = 3 * n_chunks
    if t_max and not wl_cells:
        rows += n_chunks * (1 + t_max)
    if wl_cells:
        rows += 2 * wl_cells + 1
        if t_max:
            rows += wl_cells * (1 + 3 * t_max)
    return rows * 4


def tile_smem_bytes(vblk: int, q_pad: int = 1) -> int:
    """Shared memory of a tiled block's two tile slots: a laned block
    stages only its own group of at most ``LGRP`` lanes."""
    return 2 * vblk * min(q_pad, LGRP) * 4


def select_kernel_path(num_slots: int, q_pad: int = 1,
                       vmem_budget_bytes=None, *, path=None, vblk=None,
                       n_chunks=None, wl_cells: int = 0,
                       smem_budget_bytes=None, return_info: bool = False):
    """Pick the value table's residency for ``num_slots`` (x ``q_pad``
    lanes, no lane padding) float32 slots.

    Returns ``("pinned", None)`` when ``round_up(num_slots, 128) * q_pad
    * 4`` fits the budget, else ``("tiled", vblk)``.  The automatic
    ``vblk`` is the largest multiple of 128 whose double buffer
    (``tile_smem_bytes``) fits ``TILE_SMEM_BYTES``, capped at the padded
    table.  ``path``/``vblk`` force the decision; a forced ``vblk`` must
    be a positive multiple of 128, or ``ValueError``, as in the
    reference.  No kernel allocates a tile: the tiled kernels stage the
    rows a cell reads, and ``vblk`` shapes only the reference's tile
    accounting, mirrored off the launch path.

    With ``n_chunks`` and ``smem_budget_bytes`` the index tables'
    footprint (``smem_table_bytes``) joins the decision as in the
    reference: tile lists over the budget widen ``vblk`` (doubling) with
    a warning, and a pinned launch over it warns.  ``return_info=True``
    appends a dict with the footprint behind the decision."""
    budget = resolve_vmem_budget(vmem_budget_bytes)
    v_pad = _round_up(num_slots, 128)
    if path is None:
        path = "pinned" if v_pad * q_pad * 4 <= budget else "tiled"
    if path == "pinned":
        info = {"path": "pinned", "vblk": None, "smem_table_bytes":
                smem_table_bytes(n_chunks, 0, wl_cells) if n_chunks else None}
        if n_chunks is not None and smem_budget_bytes is not None \
                and info["smem_table_bytes"] > smem_budget_bytes:
            warnings.warn(
                f"fused-kernel index tables ({n_chunks} chunks, "
                f"wl_cells={wl_cells}) weigh {info['smem_table_bytes']} "
                f"bytes — over smem_budget_bytes={smem_budget_bytes} on "
                "the pinned path", stacklevel=2)
        return ("pinned", None, info) if return_info else ("pinned", None)
    if path != "tiled":
        raise ValueError(f"unknown kernel path {path!r}")
    if vblk is None:
        vblk = TILE_SMEM_BYTES // tile_smem_bytes(1, q_pad) // 128 * 128
        if vblk < 128:
            raise ValueError(
                f"TILE_SMEM_BYTES={TILE_SMEM_BYTES} cannot hold two "
                f"128-slot tiles of {min(q_pad, LGRP)} lanes "
                f"({tile_smem_bytes(128, q_pad)} bytes)")
        vblk = min(vblk, v_pad)
    if vblk % 128 or vblk <= 0:
        raise ValueError(f"vblk must be a positive multiple of 128; "
                         f"got {vblk}")
    vblk = int(vblk)
    info = {"path": "tiled", "vblk": vblk, "smem_table_bytes": None}
    if n_chunks is not None and smem_budget_bytes is not None:
        def footprint(vb):
            t_max = min(_round_up(num_slots, vb) // vb, EBLK)
            return smem_table_bytes(n_chunks, t_max, wl_cells)
        if footprint(vblk) > smem_budget_bytes:
            vblk0 = vblk
            while footprint(vblk) > smem_budget_bytes and vblk < v_pad:
                vblk *= 2    # fewer, wider tiles: shorter tile lists
            warnings.warn(
                f"fused-kernel index tables ({n_chunks} chunks, "
                f"wl_cells={wl_cells}) exceed smem_budget_bytes="
                f"{smem_budget_bytes} at vblk={vblk0}; widened to "
                f"vblk={vblk} ({footprint(vblk)} table bytes)"
                + ("" if footprint(vblk) <= smem_budget_bytes else
                   " — still over budget"), stacklevel=2)
        info["vblk"] = vblk
        info["smem_table_bytes"] = footprint(vblk)
    return ("tiled", vblk, info) if return_info else ("tiled", vblk)


def _check_pair(relax_kind: str, kind: str):
    assert relax_kind in RELAX_KINDS, relax_kind
    if (relax_kind, kind) not in ABSORBING_PAIRS:
        raise ValueError(
            f"non-absorbing relax/combine pairing {(relax_kind, kind)}: "
            "frontier masking requires relax(identity, w) == identity "
            f"(supported: {sorted(ABSORBING_PAIRS)})")


class PieceTables(typing.NamedTuple):
    """How the launches (K1-K8) cut the segment blocks' planned cells
    into pieces of at most ``cells`` consecutive cells of the i-major
    list (``LaunchPlan.blk_chunk``), one thread block each.
    A block with no planned cell is one empty piece, so every segment is
    written.  The pieces of block ``i`` are ``blk_piece[i]:blk_piece[i +
    1]``, piece ``k`` holds cell positions ``piece_ptr[k]:piece_ptr[k +
    1]``.  A block cut into several pieces ("split") gives each piece a
    row of the launch's split buffer, ``piece_slot`` (consecutive over a
    block's pieces, in piece order; -1 for a block that is one piece).
    The tables are built on the card with no host sync, so their lengths
    are bounds known on the host: ``num_pieces`` (the launch's grid) is
    ``n_blocks + n_cells // cells``, never fewer than the real pieces,
    which come first; a piece past them has ``piece_blk`` -1 and is never
    run.  ``n_split`` (the split buffer's rows) is the same bound."""

    piece_ptr: torch.Tensor   # (n_pieces + 1,) int32
    piece_blk: torch.Tensor   # (n_pieces,) int32
    piece_slot: torch.Tensor  # (n_pieces,) int32
    blk_piece: torch.Tensor   # (n_sblk + 1,) int32
    n_split: int
    cells: int

    @property
    def num_pieces(self) -> int:
        return self.piece_blk.shape[0]


class LaunchPlan(typing.NamedTuple):
    """Static launch tables of one edge set: for segment block ``i`` the
    chunks ``blk_chunk[blk_ptr[i]:blk_ptr[i+1]]`` (ascending) are those
    whose valid-edge id range meets the block: the planned cells,
    i-major.  ``cell_i``/``cell_j`` list the same (block, chunk) cells
    j-major (chunk ascending, then block), the order worklists keep, and
    ``cell_order[p]`` is the j-major index of i-major cell ``p``.
    ``scratch`` keeps what the launches build on first use: the
    cells' batch ranges (``plan_batches``), the cuts of the blocks' cells
    into pieces (``plan_pieces``) and the arrival tickets, one set per
    CUDA stream (``_tickets``: right while the launches on a stream run
    in order).  ``src_deg`` is each slot's count of valid out-edges (the
    laned launches' per-lane message counts come from it); a
    segment-reduce plan has none.  ``edge_mask`` is the (E,) bool mask
    that built the plan: the batch ranges follow it."""

    blk_ptr: torch.Tensor     # (n_sblk + 1,) int32
    blk_chunk: torch.Tensor   # (launch cells,) int32, i-major
    cell_i: torch.Tensor      # (launch cells,) int32, j-major
    cell_j: torch.Tensor      # (launch cells,) int32, j-major
    num_edges: int
    num_segments: int
    num_slots: int
    src_deg: torch.Tensor | None = None   # (num_slots,) int32
    cell_order: torch.Tensor | None = None   # (launch cells,) int64
    scratch: dict | None = None
    edge_mask: torch.Tensor | None = None    # (E,) bool

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


def cell_batches(plan: LaunchPlan, edge_mask, edge_dst):
    """(num_cells, 2) uint8, i-major: each planned cell's ``[first, last +
    1)`` 32-edge batches of its chunk holding a valid edge of its block,
    ``(0, 0)`` for none, with torch ops on the plan's device and no host
    sync.  Right for any edge order; tight for edges sorted by
    destination."""
    n_cells = plan.num_cells
    dev = edge_dst.device
    if n_cells == 0:
        return torch.zeros((0, 2), dtype=torch.uint8, device=dev)
    e = edge_dst.shape[0]
    pos = torch.arange(e, device=dev)
    j = pos // EBLK
    # a chunk's first j-major cell, and the block it lists first: a chunk
    # with no planned cell holds no valid edge
    first = torch.searchsorted(
        plan.cell_j, torch.arange(_round_up(e, EBLK) // EBLK, device=dev,
                                  dtype=torch.int32))
    i_lo = plan.cell_i[first.clamp(max=n_cells - 1)].long()
    blk = torch.div(edge_dst.long(), SBLK, rounding_mode="floor")
    c = torch.where(edge_mask, first[j] + blk - i_lo[j], n_cells)
    b = (pos % EBLK) // 32
    lo = torch.full((n_cells + 1,), EBLK // 32, dtype=torch.int64,
                    device=dev).scatter_reduce_(0, c, b, "amin")
    hi = torch.zeros(n_cells + 1, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, c, b + 1, "amax")
    lo = torch.where(hi > 0, lo, 0)
    return torch.stack([lo, hi], 1)[:n_cells][plan.cell_order] \
        .to(torch.uint8).contiguous()


def piece_tables(blk_ptr, num_cells: int, cells: int) -> PieceTables:
    """Cut each segment block's planned cells (``blk_ptr``, i-major;
    ``num_cells`` of them) into consecutive pieces of at most ``cells``
    cells, with torch ops on the plan's device and no host sync
    (``PieceTables``: padded to a bound known on the host)."""
    if cells < 1:
        raise ValueError(f"a piece holds at least one cell; got {cells}")
    dev = blk_ptr.device
    ptr = blk_ptr.long()
    n_blk = ptr.shape[0] - 1
    # max(1, ceil(c / cells)) <= c // cells + 1 for each block's c cells
    bound = n_blk + num_cells // cells
    npc = torch.clamp(torch.div(ptr[1:] - ptr[:-1] + cells - 1, cells,
                                rounding_mode="floor"), min=1)
    blk_piece = torch.zeros(n_blk + 1, dtype=torch.int64, device=dev)
    blk_piece[1:] = torch.cumsum(npc, 0)
    k = torch.arange(bound, device=dev)
    blk = torch.searchsorted(blk_piece[1:], k, right=True)
    real = blk < n_blk
    blk_c = blk.clamp(max=max(n_blk - 1, 0))
    piece_lo = torch.where(real, ptr[blk_c] + (k - blk_piece[blk_c]) * cells,
                           num_cells)
    split = real & (npc[blk_c] > 1)
    slot = torch.where(split, torch.cumsum(split, 0) - 1, -1)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return PieceTables(i32(torch.cat([piece_lo, ptr[-1:]])),
                       i32(torch.where(real, blk, -1)), i32(slot),
                       i32(blk_piece), bound, int(cells))


def plan_pieces(plan: LaunchPlan, cells: int | None = None) -> PieceTables:
    """``plan``'s pieces at ``cells`` cells (default ``PIECE_CELLS``),
    made on first use with no host sync and kept in its ``scratch``."""
    key = ("pieces", PIECE_CELLS if cells is None else int(cells))
    if key not in plan.scratch:
        plan.scratch[key] = piece_tables(plan.blk_ptr, plan.num_cells,
                                         key[1])
    return plan.scratch[key]


def plan_batches(plan: LaunchPlan, edge_dst):
    """``cell_batches`` of ``plan`` (whose edges' destinations these are)
    under the mask that built it (``plan.edge_mask``), made on first use
    with no host sync and kept in its ``scratch``: K1-K8 and K9 on one
    plan share them."""
    if "batches" not in plan.scratch:
        plan.scratch["batches"] = cell_batches(plan, plan.edge_mask,
                                               edge_dst)
    return plan.scratch["batches"]


def _tickets(plan: LaunchPlan, n: int, stream: int):
    """The plan's (n,) int32 arrival tickets for launches on ``stream``
    (a ``cuda_stream`` handle), made once per size and stream.  They are
    zero between launches: the piece of a split block that arrives last
    resets its block's ticket.  That holds because the launches on one
    stream run one after another and each runs to its end (a
    kernel that faults leaves the CUDA context unusable); launches on
    another stream get tickets of their own."""
    key = ("tickets", n, stream)
    if key not in plan.scratch:
        plan.scratch[key] = torch.zeros(n, dtype=torch.int32,
                                        device=plan.blk_ptr.device)
    return plan.scratch[key]


def plan_launch(edge_src, edge_mask, edge_dst, num_segments: int,
                num_slots: int) -> LaunchPlan:
    """Build the block -> chunk lists for one edge set, with torch ops on
    the edges' device, and the i-major order (``cell_order``).  Valid
    edges must address ``[0, num_slots)`` with ``edge_src`` and ``[0,
    num_segments)`` with ``edge_dst``; the kernel reads memory at those
    offsets, so they are checked here, once.
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
                      else _src_degrees(edge_src, edge_mask, num_slots),
                      order, {}, edge_mask)


def _masked_value_tables(gval, gchg, identity):
    """Frontier masking folded into the value table (absorbing identity):
    relax(identity, w) == identity for all supported pairings, so an
    inactive source can never contribute — the same result as the
    oracle's explicit where(active, ...) mask, one fewer gather.  Works
    alike for a (V,) table and a (V, Q) lane table (per-lane frontier);
    the result is contiguous, row-major."""
    return torch.where(gchg, gval, identity)


def _active_edges(edge_src, edge_mask, gchg):
    """(E,) bool: valid edges whose source is in the (V,) frontier."""
    return edge_mask & torch.index_select(gchg, 0, edge_src)


def _chunk_tables(edge_src, edge_mask, gchg, act=None):
    """Per-chunk frontier bit (``(n_chunks,) bool``: any valid edge with a
    changed source) and the active-edge count (int32) — the Fig-6
    message counter, a free reduction of the gather the bitmap needs.
    ``act`` passes ``_active_edges`` when the caller already has it."""
    if act is None:
        act = _active_edges(edge_src, edge_mask, gchg)
    chunk_act = _pad_to_chunks(act, False).any(dim=1)
    return chunk_act, act.sum(dtype=torch.int32)


def _src_degrees(edge_src, edge_mask, num_slots: int):
    """(num_slots,) int32: each slot's count of valid out-edges."""
    src = torch.where(edge_mask, edge_src, 0).long()
    return torch.zeros(num_slots, dtype=torch.int32,
                       device=edge_src.device).index_add_(
        0, src, edge_mask.to(torch.int32))


def _lane_chunk_tables(edge_src, edge_mask, gchg, src_deg=None,
                       with_act: bool = False):
    """Laned chunk tables for a (V, Q) frontier: the per-chunk bit is the
    OR across lanes (a chunk is dead only when no lane has an active
    source in it) and the active-edge counts are per lane ((Q,) int32,
    one Fig-6 message counter per query); ``with_act`` appends the (E,)
    active rows OR'd across lanes, which the tiled launches stage rows
    (K7) or build tile lists (K8) from.  All come without an (E, Q)
    gather: the bit and the rows are ``_chunk_tables`` of the
    OR-across-lanes (V,) frontier, and lane q's count is the sum of
    ``src_deg`` (valid out-edges per slot, from the launch plan or built
    here) over its changed slots."""
    act = _active_edges(edge_src, edge_mask, gchg.any(dim=1))
    chunk_act, _ = _chunk_tables(edge_src, edge_mask, None, act)
    if src_deg is None:
        src_deg = _src_degrees(edge_src, edge_mask, gchg.shape[0])
    counts = (gchg * src_deg[:, None]).sum(dim=0, dtype=torch.int32)
    return (chunk_act, counts, act) if with_act else (chunk_act, counts)


class TileTables(typing.NamedTuple):
    """Per-chunk slot-tile lists of one round (``_chunk_tile_tables``):
    the reference's tiled scalar-prefetch tables, mirrored off the launch
    path (no kernel here reads them).

    Chunk j's active edges fall in the ``ntiles[j]`` distinct tiles
    ``tiles[j, :ntiles[j]]`` (ascending; entries past the count hold
    in-range tiles that are never read).  ``order[j]`` lists the chunk's
    edge positions stably sorted by tile, inactive edges last, so tile
    k's own edges are ``order[j, off[j, k]:off[j, k + 1]]`` in chunk
    order; ``off[j, k]`` for k >= ``ntiles[j]`` is the chunk's active
    count."""

    ntiles: torch.Tensor   # (n_chunks,) int32
    tiles: torch.Tensor    # (n_chunks, t_max) int32
    off: torch.Tensor      # (n_chunks, t_max + 1) int32
    order: torch.Tensor    # (n_chunks, EBLK) int32
    vblk: int
    n_tiles: int

    @property
    def t_max(self) -> int:
        return self.tiles.shape[1]


def _chunk_tile_tables(edge_src, act, num_slots: int,
                       vblk: int) -> TileTables:
    """The reference's per-chunk tile lists (its tiled kernels' tables,
    a mirror here) from the (E,) active rows, with torch ops on their
    device and no host sync: sort each chunk row with an ``n_tiles``
    sentinel on inactive edges, flag first occurrences and scatter the
    distinct tiles (and where their edges start) to the left.
    O(E log EBLK), independent of the tile count — no (n_chunks,
    n_tiles) matrix."""
    n_tiles = _round_up(num_slots, vblk) // vblk
    t_max = min(n_tiles, EBLK)
    src = _pad_to_chunks(edge_src, 0)
    key = torch.where(_pad_to_chunks(act, False),
                      torch.div(src, vblk, rounding_mode="floor"),
                      n_tiles).to(torch.int32)
    t, order = torch.sort(key, dim=1, stable=True)
    real = t < n_tiles
    first = torch.ones_like(real)
    first[:, 1:] = t[:, 1:] != t[:, :-1]
    is_tile = first & real
    ntiles = is_tile.sum(dim=1, dtype=torch.int32)
    n_act = real.sum(dim=1, dtype=torch.int32)
    # the k-th distinct tile of a row lands in column k; the others in
    # the dropped column t_max
    col = torch.where(is_tile, torch.cumsum(is_tile, dim=1) - 1, t_max)
    pos = torch.arange(EBLK, dtype=torch.int32, device=t.device) \
        .expand_as(t).contiguous()
    off = n_act[:, None].repeat(1, t_max + 1)
    off.scatter_(1, col, torch.where(is_tile, pos, n_act[:, None]))
    off[:, t_max] = n_act
    tiles = torch.full((t.shape[0], t_max + 1), n_tiles - 1,
                       dtype=torch.int32, device=t.device)
    tiles.scatter_(1, col, torch.where(is_tile, t, n_tiles - 1))
    return TileTables(ntiles, tiles[:, :t_max].contiguous(),
                      off.contiguous(), order.to(torch.int32), vblk,
                      n_tiles)


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
    "frr_wl_launch": ("fused_relax_reduce_wl",
                      [_P] * 15 + [_I] * 3 + [_P] * 3 + [_I] * 2 + [_P]),
    "frr_wl_lanes_launch": ("fused_relax_reduce_wl_lanes",
                            [_P] * 16 + [_I] * 4 + [_P] * 3 + [_I] * 3
                            + [_P]),
    "frr_wl_lanes_blocks_per_sm": ("fused_relax_reduce_wl_lanes", [_I] * 2),
    "segment_combine_launch": ("segment_combine",
                               [_P] * 12 + [_I] * 3 + [_P] * 3 + [_I] * 2
                               + [_P]),
    "frr_wl_tiled_launch": ("fused_relax_reduce_wl_tiled",
                            [_P] * 16 + [_I] * 3 + [_P] * 3 + [_I] * 2
                            + [_P]),
    "frr_wl_tiled_lanes_launch": ("fused_relax_reduce_wl_tiled_lanes",
                                  [_P] * 16 + [_I] * 5 + [_P] * 3
                                  + [_I] * 3 + [_P]),
    "frr_wl_tiled_lanes_blocks_per_sm": ("fused_relax_reduce_wl_tiled_lanes",
                                         [_I] * 2),
}
_fns: dict = {}
_libs: dict = {}


def _kernel(entry: str):
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
    """Launch K1 on the current stream: the piece launch over the planned
    cells whose chunk is live (``_launch_pieces`` with no flags).
    Returns the (num_segments,) partial and, with ``with_debug``, the
    (1,) int32 executed-cell counter.  Raises on any launch error."""
    global launches
    res = _launch_pieces(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                         chunk_act, None, relax_kind, kind, with_debug)
    launches += 1
    return res


# --------------------------------------------------------------------------
# worklist planning (host side)
# --------------------------------------------------------------------------

class Worklist:
    """A planned sparse launch: the live (block, chunk) cells ``wl_i``,
    ``wl_j`` ((l_pad,) int32, j-major, zero past the count) and their
    count ``nlive`` ((1,) int32).  A host plan holds CPU tensors, and a
    planner's plan also the launch's own form of its cells: ``flags``,
    a (num_cells,) uint8 byte per planned cell of the edges'
    ``LaunchPlan``, i-major, 1 where the cell is listed (page-locked
    when a card is present, so the launch uploads it in one copy that
    does not wait).  A device plan (``build_device_worklist``) holds
    tensors on the card, and its count is never read on the host; a plan
    without flags is mapped onto them at launch (``worklist_flags``).

    A tiled plan (``path='tiled'``, tile width ``vblk``) runs K6/K8,
    which need nothing more.  A tiled host plan may also hold the
    reference's tile accounting, which no launch reads: each cell's
    dst-filtered tile list ``cell_ntiles`` / ``cell_tile`` ((l_pad,),
    (l_pad, t_max)) and its copy schedule ``cell_slot`` / ``cell_fetch``
    (``tile_schedule``), from ``plan(..., tile_lists=True)`` or a
    reference plan carried across (``interop.worklist_from_dict``)."""

    def __init__(self, wl_i, wl_j, nlive, cell_ntiles=None, cell_tile=None,
                 cell_slot=None, cell_fetch=None, *, path="pinned",
                 vblk=None, flags=None):
        self.wl_i = wl_i
        self.wl_j = wl_j
        self.nlive = nlive
        self.cell_ntiles = cell_ntiles
        self.cell_tile = cell_tile
        self.cell_slot = cell_slot
        self.cell_fetch = cell_fetch
        self.path = path
        self.vblk = vblk
        self.flags = flags

    @property
    def l_pad(self) -> int:
        return self.wl_i.shape[0]

    @property
    def has_cell_tiles(self) -> bool:
        return self.cell_tile is not None

    def to(self, device) -> "Worklist":
        move = [None if t is None else t.to(device) for t in (
            self.wl_i, self.wl_j, self.nlive, self.cell_ntiles,
            self.cell_tile, self.cell_slot, self.cell_fetch, self.flags)]
        return Worklist(*move[:7], path=self.path, vblk=self.vblk,
                        flags=move[7])


class WorklistInfo(typing.NamedTuple):
    """Host-side accounting of one plan (the ``fused_grid_cells`` mirror
    for worklist launches)."""

    cells: int           # live cells after the dst-range empty-cell drop
    launched: int        # padded 1-D grid length
    dense_live: int      # what the dense grid's two-level skip would run
    # the reference's tile accounting (``plan(..., tile_lists=True)``
    # only, else 0): tile copies its schedule makes, tile visits before
    # reuse, and the copies' bytes
    tile_dmas: int
    tile_needed: int
    dma_bytes: int
    # the reference's int32 scalar-prefetch tables for this launch:
    # per-chunk lo/hi/act rows, wl_i/wl_j, nlive (+ the tiled cell tables)
    smem_table_bytes: int
    # the rows K6/K8 stage (0 pinned): a row per active edge (active in
    # some lane), each staged by the one listed cell that owns it, and
    # their bytes (rows x lane_width x 4)
    staged_rows: int = 0
    staged_bytes: int = 0


def _wl_pad_len(nlive: int, pad_to: int = WL_PAD) -> int:
    return max(pad_to, 1 << max(nlive - 1, 0).bit_length())


def tile_schedule(wl_j, nlive: int, cell_ntiles, cell_tile):
    """The 2-slot tile-copy schedule over a tiled host plan's tile lists
    (the reference's accounting, which no launch reads): ``(cell_slot,
    cell_fetch, copies)``, numpy, shaped like ``cell_tile``.

    The schedule restarts at each run of consecutive cells that share
    ``wl_j`` (j-major order makes them contiguous).  Within a run it is
    the reference's sequential 2-entry LRU (a needed tile still in a slot
    is reused; a fetch goes to the slot the previous tile was not read
    from), in closed form: over the run's tile visits in order, a visit
    that repeats its predecessor takes the predecessor's slot and
    fetches nothing; the k-th of the others goes to slot ``k % 2`` and
    fetches unless it repeats the visit two before it.  So ``copies`` is
    the reference's count plus the reuses it carried across a run
    boundary."""
    wl_j = np.asarray(wl_j)
    ntl = np.asarray(cell_ntiles)[:nlive].astype(np.int64)
    cell_tile = np.asarray(cell_tile)
    cell_slot = np.zeros(cell_tile.shape, np.int32)
    cell_fetch = np.zeros(cell_tile.shape, np.int32)
    n = int(ntl.sum())
    if n == 0:
        return cell_slot, cell_fetch, 0
    cell = np.repeat(np.arange(nlive), ntl)
    col = np.arange(n) - np.repeat(np.cumsum(ntl) - ntl, ntl)
    tile = cell_tile[cell, col]
    run = np.cumsum(np.r_[True, wl_j[1:nlive] != wl_j[:nlive - 1]])[cell]
    new_run = np.r_[True, run[1:] != run[:-1]]
    rep = ~new_run & np.r_[False, tile[1:] == tile[:-1]]
    keep = np.flatnonzero(~rep)
    d_run, d_tile = run[keep], tile[keep]
    d_first = np.r_[True, d_run[1:] != d_run[:-1]]
    starts = np.flatnonzero(d_first)
    k = np.arange(keep.shape[0]) - np.repeat(
        starts, np.diff(np.r_[starts, keep.shape[0]]))
    fetch_d = np.ones(keep.shape[0], bool)
    fetch_d[2:] = (k[2:] < 2) | (d_tile[2:] != d_tile[:-2])
    slot = np.zeros(n, np.int32)
    fetch = np.zeros(n, np.int32)
    slot[keep] = k % 2
    fetch[keep] = fetch_d
    last = np.maximum.accumulate(np.where(~rep, np.arange(n), 0))
    slot = slot[last]
    cell_slot[cell, col] = slot
    cell_fetch[cell, col] = fetch
    return cell_slot, cell_fetch, int(fetch.sum())


def _distinct_tiles(keys, n_tiles: int):
    """Sorted distinct (group, tile) pairs from int64 keys ``group *
    n_tiles + tile``: (groups, tiles)."""
    pairs = np.unique(keys)
    return pairs // n_tiles, pairs % n_tiles


class WorklistPlanner:
    """Precomputes the frontier-independent parts of worklist planning
    for one edge set + segment count (+ tile width), so per-round plans
    only pay the frontier-dependent work (numpy, on the host).

    ``edge_dst``/``edge_mask``/``edge_src`` may be (S, E_max) stacked or
    flat, flattened as the kernels flatten them.  The (block, chunk)
    cells whose ranges meet are kept as a j-major list (never as the
    dense (n_sblk, n_chunks) matrix); ``plan(gchg)`` returns
    (Worklist, WorklistInfo) equal to the reference planner's plan.
    ``path='tiled'`` (with ``vblk``; ``num_slots`` sizes the slot tiling)
    plans the same cells and counts the rows K6/K8 stage; ``lane_width``
    prices a laned launch's rows.  The reference's tile lists and copy
    schedule are built only on request (``plan(..., tile_lists=True)``)."""

    def __init__(self, edge_dst, edge_mask, edge_src, num_segments: int,
                 *, num_slots: int | None = None, path: str = "pinned",
                 vblk: int | None = None, lane_width: int = 1,
                 smem_budget_bytes: int | None = None):
        if path not in ("pinned", "tiled"):
            raise ValueError(f"unknown kernel path {path!r}")
        ids = np.asarray(edge_dst).reshape(-1)
        mask = np.asarray(edge_mask).reshape(-1).astype(bool)
        srcs = np.asarray(edge_src).reshape(-1)
        e = ids.shape[0]
        e_pad = _round_up(e, EBLK)
        self.n_i = _round_up(num_segments, SBLK) // SBLK
        self.n_chunks = e_pad // EBLK
        self.path = path
        self.vblk = int(vblk) if vblk is not None else None
        self.lane_width = int(lane_width)
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
        # each edge's own cell, keyed j-major (j * n_i + dst block), and
        # for a valid edge the j-major index of that cell in the list
        self.edge_cell = (np.arange(self.n_chunks)[:, None] * self.n_i
                          + idc // SBLK)
        self.edge_cidx = np.where(
            self.mask, first[:, None] + idc // SBLK - i_lo[:, None], 0)
        # each j-major cell's position in the launch's i-major list (the
        # inverse of plan_launch's stable sort by block)
        self.imajor = np.empty(self.cell_j.shape[0], np.int64)
        self.imajor[np.argsort(self.cell_i, kind="stable")] = \
            np.arange(self.cell_j.shape[0])
        if self.path == "tiled":
            if self.vblk is None:
                raise ValueError("tiled worklist planning needs vblk")
            v_pad = _round_up(num_slots if num_slots is not None
                              else int(srcc.max(initial=0)) + 1, self.vblk)
            self.n_tiles = v_pad // self.vblk
            self.t_max = min(self.n_tiles, EBLK)
            self.tile_of = self.srcs // self.vblk
        else:
            self.t_max = 0

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

    def _chunk_ntiles(self, act):
        """Distinct active-source tiles per chunk ((n_chunks,) int64)."""
        j = np.nonzero(act)[0]
        chunks, _ = _distinct_tiles(j * self.n_tiles + self.tile_of[act],
                                    self.n_tiles)
        return np.bincount(chunks, minlength=self.n_chunks)

    def _staged_rows(self, act):
        """Rows the dense tiled kernels (K5, K7) stage: every live cell
        stages its chunk's active edges whose destination lies in its
        block, so a row per active edge whose (chunk, dst block) cell is
        listed and live (each such edge is, as the plan's ranges cover
        every valid edge; the count checks it)."""
        keys = self.cell_j * self.n_i + self.cell_i      # ascending
        hit = act & act.any(axis=1)[:, None]
        want = self.edge_cell[hit]
        at = np.minimum(np.searchsorted(keys, want), max(keys.size - 1, 0))
        return int((keys[at] == want).sum()) if keys.size else 0

    def dense_mirror(self, gchg, tile_lists: bool = False) -> dict:
        """Mirror of the dense launch (K1, or K5 when tiled) for this edge
        set: ``cells`` it executes, ``launched``, the cells its blocks
        walk, and on the tiled path the rows K5/K7 stage
        (``staged_rows``, ``staged_bytes`` = rows x lane_width x 4),
        which a tiled device plan of K6/K8 stages too.  ``tile_lists``
        adds the reference's tile accounting: each chunk's distinct
        active-source tiles (``chunk_ntiles``), the tile copies when every
        live cell copies its chunk's tiles (``tile_dmas``) and their bytes
        (``dma_bytes``); else those two are 0."""
        act, live = self._live_map(gchg)
        out = {"cells": int(live.sum()), "launched": self.launch_cells,
               "tile_dmas": 0, "dma_bytes": 0, "staged_rows": 0,
               "staged_bytes": 0}
        if self.path == "tiled":
            out["staged_rows"] = self._staged_rows(act)
            out["staged_bytes"] = out["staged_rows"] * self.lane_width * 4
            if tile_lists:
                ntiles = self._chunk_ntiles(act)
                out["chunk_ntiles"] = ntiles
                out["tile_dmas"] = int(ntiles[self.cell_j[live]].sum())
                out["dma_bytes"] = out["tile_dmas"] * self.vblk \
                    * self.lane_width * 4
        return out

    def plan(self, gchg, pad_to: int = WL_PAD, dst_filter: bool = True,
             max_live_fraction: float | None = None,
             tile_lists: bool = False):
        """Plan one round's launch from the (V,) bool frontier (a (V, Q)
        lane frontier is OR'd across lanes).

        j-major cell order (j outer, i inner).  With ``dst_filter`` a
        cell is kept only if one of its chunk's active edges lands in its
        block — the reference drops the others, which contribute only
        the identity.  ``max_live_fraction`` implements 'auto': when the
        dense grid's live fraction is at or above it, return (None, None)
        before any per-cell work.

        On the tiled path the info counts the rows K6/K8 stage: every
        active edge's (chunk, dst block) cell is listed (the dst filter
        keeps it; unfiltered, its chunk is live and its block meets the
        chunk's range), so a row per active edge.  ``tile_lists`` adds
        the reference's tile accounting, which no launch reads: each
        cell's tile list (with ``dst_filter`` only the tiles of its own
        active edges, else its chunk's), the copy schedule
        (``tile_schedule``) and the info's ``tile_dmas`` /
        ``tile_needed`` / ``dma_bytes``."""
        act, live = self._live_map(gchg)
        dense_live = int(live.sum())
        if max_live_fraction is not None \
                and dense_live / max(self.total_cells, 1) \
                >= max_live_fraction:
            return None, None
        if dst_filter:
            hit = np.zeros(self.launch_cells, bool)
            hit[self.edge_cidx[act]] = True      # one entry per active edge
            cidx = np.flatnonzero(hit)
        else:
            cidx = np.flatnonzero(live)
        n_act = np.count_nonzero(act)
        jj, ii = self.cell_j[cidx], self.cell_i[cidx]
        keys = jj * self.n_i + ii
        flags = _host_flags(self.launch_cells)
        flags.numpy()[self.imajor[cidx]] = 1
        nlive = int(ii.shape[0])
        l_pad = _wl_pad_len(nlive, pad_to)
        wl_i = np.zeros(l_pad, np.int32)
        wl_j = np.zeros(l_pad, np.int32)
        wl_i[:nlive] = ii
        wl_j[:nlive] = jj
        nlive_t = torch.tensor([nlive], dtype=torch.int32)
        staged = int(n_act) if self.path == "tiled" else 0
        info = WorklistInfo(
            cells=nlive, launched=l_pad, dense_live=dense_live,
            tile_dmas=0, tile_needed=0, dma_bytes=0,
            smem_table_bytes=smem_table_bytes(self.n_chunks, self.t_max,
                                              l_pad),
            staged_rows=staged, staged_bytes=staged * self.lane_width * 4)
        if self.path != "tiled" or not tile_lists:
            wl = Worklist(torch.from_numpy(wl_i), torch.from_numpy(wl_j),
                          nlive_t, path=self.path, vblk=self.vblk,
                          flags=flags)
            return wl, self._check_smem(info)

        # the reference's tile accounting: each kept cell's distinct
        # tiles, ascending (sorted unique (cell, tile) keys over the
        # active edges), and their copy schedule
        t_max = self.t_max
        if dst_filter:
            cells, tiles = _distinct_tiles(
                self.edge_cell[act] * self.n_tiles + self.tile_of[act],
                self.n_tiles)
            c_of = np.searchsorted(keys, cells)
        else:
            j_act = np.nonzero(act)[0]
            ch, ch_tiles = _distinct_tiles(
                j_act * self.n_tiles + self.tile_of[act], self.n_tiles)
            ch_cnt = np.bincount(ch, minlength=self.n_chunks)
            ch_ptr = np.cumsum(ch_cnt) - ch_cnt
            per = ch_cnt[jj]
            c_of = np.repeat(np.arange(nlive), per)
            rank = np.arange(c_of.shape[0]) - np.repeat(
                np.cumsum(per) - per, per)
            tiles = ch_tiles[ch_ptr[jj][c_of] + rank]
        cnt = np.bincount(c_of, minlength=nlive)
        col = np.arange(c_of.shape[0]) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        cell_ntiles = np.zeros(l_pad, np.int32)
        cell_ntiles[:nlive] = cnt
        cell_tile = np.zeros((l_pad, t_max), np.int32)
        cell_tile[c_of, col] = tiles
        cell_slot, cell_fetch, fetches = tile_schedule(
            wl_j, nlive, cell_ntiles, cell_tile)
        wl = Worklist(
            torch.from_numpy(wl_i), torch.from_numpy(wl_j), nlive_t,
            *(torch.from_numpy(x) for x in (cell_ntiles, cell_tile,
                                             cell_slot, cell_fetch)),
            path="tiled", vblk=self.vblk, flags=flags)
        info = info._replace(
            tile_dmas=fetches, tile_needed=int(cnt.sum()),
            dma_bytes=fetches * self.vblk * self.lane_width * 4)
        return wl, self._check_smem(info)

    def _check_smem(self, info: WorklistInfo) -> WorklistInfo:
        if self.smem_budget_bytes is not None and not self._smem_warned \
                and info.smem_table_bytes > self.smem_budget_bytes:
            self._smem_warned = True
            warnings.warn(
                f"worklist tables ({info.launched} cells, {self.n_chunks} "
                f"chunks, t_max={self.t_max}) weigh "
                f"{info.smem_table_bytes} bytes — over "
                f"smem_budget_bytes={self.smem_budget_bytes}; prefer "
                "grid_mode='auto' (dense frontiers keep the dense grid) or "
                "a wider vblk", stacklevel=3)
        return info


def plan_worklist(edge_dst, edge_mask, edge_src, gchg, num_segments: int,
                  *, num_slots=None, path="pinned", vblk=None,
                  lane_width: int = 1, pad_to: int = WL_PAD,
                  dst_filter: bool = True, tile_lists: bool = False):
    """One-shot worklist plan (see ``WorklistPlanner`` for the reusable
    form round loops amortize across rounds).  ``gchg`` is the (V,)
    frontier (a (V, Q) one is OR'd across lanes); it also sizes the slot
    table unless ``num_slots`` overrides."""
    if num_slots is None:
        num_slots = np.asarray(gchg).shape[0]
    planner = WorklistPlanner(edge_dst, edge_mask, edge_src, num_segments,
                              num_slots=num_slots, path=path, vblk=vblk,
                              lane_width=lane_width)
    return planner.plan(gchg, pad_to=pad_to, dst_filter=dst_filter,
                        tile_lists=tile_lists)


# --------------------------------------------------------------------------
# the worklist launches' live cells
# --------------------------------------------------------------------------
# A worklist launch (K2, K4, K6, K8) walks every planned cell of its
# pieces and runs the listed ones.  A host plan lists them as a flag byte
# per planned cell (``Worklist.flags``, filled by the planner); a device
# plan lists the planned cells whose chunk is live, which the kernel
# reads from the chunk frontier bits itself, so ``grid_mode=
# 'device_worklist'`` compacts nothing on the card.  ``build_device_
# worklist`` still compacts them into the reference's j-major form: the
# plan's cell list filtered by the chunk bits and compacted by a
# cumsum-scatter into fixed-length wl_i / wl_j, with the live count left
# on the device (static length, no host sync).  The reference pads to the
# power of two above the FULL (n_sblk, n_chunks) grid (8.5 M cells at
# RMAT-18); this pads above the cells whose ranges meet (about 40 k).


def _host_flags(n: int):
    """(n,) uint8 zeros on the host for a plan's flags: page-locked when a
    card is present.  PyTorch's caching host allocator hands the planner
    the same buffers back once their copies to the card are done, so the
    launch's upload is one copy that does not wait."""
    return torch.zeros(n, dtype=torch.uint8,
                       pin_memory=torch.cuda.is_available())


def device_flags(plan: LaunchPlan, chunk_act):
    """The (num_cells,) uint8 live flags of a device plan, i-major: the
    planned cells whose chunk is live.  The kernels read each from
    ``chunk_act`` themselves; this is its plain version."""
    return torch.index_select(chunk_act, 0, plan.blk_chunk.long()) \
        .to(torch.uint8)


def worklist_flags(plan: LaunchPlan, wl_i, wl_j, nlive):
    """Map a worklist's first ``nlive`` j-major cells onto ``plan``'s
    (num_cells,) uint8 flags, i-major, with torch ops on the plan's
    device (no host sync).  A listed cell that the plan does not hold
    meets no edge of its block and is dropped."""
    dev = plan.blk_ptr.device
    n_i, n = plan.num_blocks, plan.num_cells
    out = torch.zeros(n + 1, dtype=torch.uint8, device=dev)
    if n:
        keys = plan.cell_j.long() * n_i + plan.cell_i.long()   # ascending
        key = wl_j.to(dev).long() * n_i + wl_i.to(dev).long()
        pos = torch.searchsorted(keys, key).clamp(max=n - 1)
        listed = torch.arange(key.shape[0], device=dev) \
            < nlive.to(dev).long()
        out[torch.where(listed & (keys[pos] == key), pos, n)] = 1
    return out[:n][plan.cell_order]


def device_worklist_pad(plan, num_segments: int | None = None) -> int:
    """Static length of a device-compacted worklist.  ``(plan)``: the
    port's, over ``plan``'s cells (the cells whose ranges meet).
    ``(num_edges, num_segments)``: the reference's, over the full
    (segment block, chunk) grid, pow2-padded."""
    if isinstance(plan, LaunchPlan):
        return _wl_pad_len(plan.num_cells)
    n_i = _round_up(num_segments, SBLK) // SBLK
    return _wl_pad_len(n_i * (_round_up(int(plan), EBLK) // EBLK))


def _compact_live_cells(plan: LaunchPlan, chunk_act, l_pad: int,
                        path: str = "pinned", vblk=None):
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
    return Worklist(wl_i[:l_pad], wl_j[:l_pad], nlive, path=path,
                    vblk=vblk)


def build_device_worklist(gchg, edge_src, edge_mask, edge_dst,
                          num_segments: int,
                          plan: LaunchPlan | None = None, *,
                          path: str = "pinned", vblk=None) -> Worklist:
    """The ``grid_mode='device_worklist'`` plan in the reference's form,
    built with torch ops on the frontier's device.  Its cells equal
    ``WorklistPlanner.plan(gchg, dst_filter=False)``'s, in order.  A
    (V, Q) lane frontier is OR'd across lanes.  ``path='tiled'`` marks
    the plan for the tiled kernels with tile width ``vblk``."""
    if path == "tiled" and vblk is None:
        raise ValueError("a tiled device worklist needs vblk")
    if plan is None:
        plan = plan_launch(edge_src, edge_mask, edge_dst, num_segments,
                           gchg.shape[0])
    chunk_act, _ = _chunk_tables(edge_src, edge_mask, _or_lanes(gchg))
    return _compact_live_cells(plan, chunk_act, device_worklist_pad(plan),
                               path, vblk)


def _launch_worklist(gchg, edge_src, edge_mask, edge_dst,
                     num_segments: int, path: str = "pinned", vblk=None,
                     lane_width: int = 1) -> Worklist:
    """Plan a host worklist at launch time from the tensors (copied to
    the host; a (V, Q) frontier is OR'd across lanes): the convenience
    the differential tests drive; round drivers plan with a
    ``WorklistPlanner`` instead."""
    wl, _ = plan_worklist(
        *(t.detach().cpu().numpy() for t in (edge_dst, edge_mask, edge_src,
                                              gchg)), num_segments,
        path=path, vblk=vblk, lane_width=lane_width)
    return wl


def _card_flags(wl: Worklist | None, plan: LaunchPlan, num_segments: int):
    """A worklist's live flags on the plan's card: None for a device
    plan (the kernel reads the chunk frontier bits), a planner's flags in
    one copy that does not wait, else ``worklist_flags`` of its cells (a
    host plan's cells are checked against the launch grid first)."""
    if wl is None:
        return None
    if wl.flags is not None:
        return wl.flags.to(plan.blk_ptr.device, non_blocking=True)
    if wl.nlive.device.type == "cpu":     # a host plan: check its cells
        n = int(wl.nlive[0])
        n_chunks = _round_up(plan.num_edges, EBLK) // EBLK
        if not 0 <= n <= wl.l_pad or (n and (
                int(wl.wl_j[:n].max()) >= n_chunks
                or int(wl.wl_i[:n].max()) * SBLK >= max(num_segments, 1)
                or int(wl.wl_i[:n].min()) < 0
                or int(wl.wl_j[:n].min()) < 0)):
            raise ValueError("worklist cells outside the launch grid")
    return worklist_flags(plan, wl.wl_i, wl.wl_j, wl.nlive)


# --------------------------------------------------------------------------
# K1-K4: the pinned piece launches on the card
# --------------------------------------------------------------------------

def _check_flags(flags, plan: LaunchPlan, dev):
    if flags is not None and (
            flags.device != dev or flags.dtype != torch.uint8
            or flags.shape != (plan.num_cells,)
            or not flags.is_contiguous()):
        raise ValueError(f"flags must be a contiguous ({plan.num_cells},) "
                         f"uint8 on {dev}")


def _piece_ptrs(plan: LaunchPlan, pc: PieceTables, flags, chunk_act,
                n_tickets: int, edge_dst):
    """The ten piece-table pointers a piece launch takes, in the C
    entry points' order: piece begin / end, block, split slot, a block's
    pieces, the cells' chunks and batch ranges (of the plan's edges,
    whose destinations ``edge_dst`` are), the flags (null for a device
    plan), the
    chunk frontier bits (null for K9, which runs every cell) and the
    arrival tickets."""
    return [pc.piece_ptr.data_ptr(), pc.piece_ptr[1:].data_ptr(),
            pc.piece_blk.data_ptr(), pc.piece_slot.data_ptr(),
            pc.blk_piece.data_ptr(), plan.blk_chunk.data_ptr(),
            plan_batches(plan, edge_dst).data_ptr(),
            None if flags is None else flags.data_ptr(),
            None if chunk_act is None else chunk_act.data_ptr(),
            _tickets(plan, n_tickets, torch.cuda.current_stream(
                plan.blk_ptr.device).cuda_stream).data_ptr()]


def _launch_pieces(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                   plan: LaunchPlan, chunk_act, flags, relax_kind: str,
                   kind: str, with_debug: bool):
    """The piece launch of K1 and K2 on the current stream: one block per
    piece of ``plan`` (``PIECE_CELLS``), running the cells ``flags``
    lists ((num_cells,) uint8 on the card, i-major), or with
    ``flags=None`` (a dense launch, a device plan) the planned cells
    whose chunk is live.  Nothing here waits for the card.  Returns the
    (num_segments,) inbox partial and, with ``with_debug``, the (1,)
    int32 count of cells run.  Raises on any launch error."""
    if gval_m.dim() != 1:
        raise ValueError("K1 and K2 take a (V,) value table")
    _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                       chunk_act)
    dev = gval_m.device
    _check_flags(flags, plan, dev)
    out = torch.empty(plan.num_segments, dtype=torch.float32, device=dev)
    dbg = torch.zeros(1, dtype=torch.int32, device=dev) if with_debug \
        else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    pc = plan_pieces(plan)
    split = torch.empty((pc.n_split, SBLK), dtype=torch.float32, device=dev)
    if pc.num_pieces:
        rc = _kernel("frr_wl_launch")(
            gval_m.data_ptr(), edge_src.data_ptr(), edge_w.data_ptr(),
            edge_mask.data_ptr(), edge_dst.data_ptr(),
            *_piece_ptrs(plan, pc, flags, chunk_act, plan.num_blocks,
                         edge_dst),
            edge_src.shape[0], plan.num_segments, pc.num_pieces,
            out.data_ptr(), split.data_ptr(),
            dbg.data_ptr() if dbg is not None else None,
            _RELAX_CODE[relax_kind], _KIND_CODE[kind], stream)
        if rc != 0:
            raise RuntimeError(f"fused_relax_reduce piece launch failed: "
                               f"cudaError {rc}")
    return out, dbg


def _launch_wl(gval_m, edge_src, edge_w, edge_mask, edge_dst,
               plan: LaunchPlan, chunk_act, flags, relax_kind: str,
               kind: str, with_debug: bool):
    """Launch K2 on the current stream: ``_launch_pieces`` over the cells
    ``flags`` lists, or with ``flags=None`` (a device plan) K1's cells.
    Returns as ``_launch_pieces``."""
    global wl_launches
    res = _launch_pieces(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                         chunk_act, flags, relax_kind, kind, with_debug)
    wl_launches += 1
    return res


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


def _lane_groups(q: int) -> int:
    return -(-q // LGRP)


def _halves(q: int) -> int:
    """Lists a warp of the laned fold at ``q`` lanes: 2, one a half-warp,
    when a lane group holds at most 16 lanes (no thread idles); else 1,
    one a warp (PERF.md: the half-warp form ran about 11% faster at Q =
    16)."""
    return 2 if q <= 16 else 1


def _launch_lane_pieces(gval_m, unitw, edge_src, edge_w, edge_mask,
                        edge_dst, plan: LaunchPlan, chunk_act, flags,
                        relax_kind: str, kind: str, with_debug: bool):
    """The piece launch of K3 and K4 on the current stream: K1's pieces
    and cells (``flags``, or None: those whose chunk is live) with the
    laned cell, one block per (piece, group of 32 lanes).  Returns the
    (num_segments, Q) inbox partial and, with ``with_debug``, the (1,)
    int32 count of cells run."""
    _check_lane_tables(gval_m, unitw)
    _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                       chunk_act)
    dev = gval_m.device
    _check_flags(flags, plan, dev)
    q = gval_m.shape[1]
    pc = plan_pieces(plan)
    out = torch.empty((plan.num_segments, q), dtype=torch.float32,
                      device=dev)
    split = torch.empty((pc.n_split, SBLK, q), dtype=torch.float32,
                        device=dev)
    dbg = torch.zeros(1, dtype=torch.int32, device=dev) if with_debug \
        else None
    rc = _kernel("frr_wl_lanes_launch")(
        gval_m.data_ptr(), edge_src.data_ptr(), edge_w.data_ptr(),
        edge_mask.data_ptr(), edge_dst.data_ptr(), unitw.data_ptr(),
        *_piece_ptrs(plan, pc, flags, chunk_act,
                     plan.num_blocks * _lane_groups(q), edge_dst),
        edge_src.shape[0], plan.num_segments, pc.num_pieces, q,
        out.data_ptr(), split.data_ptr(),
        dbg.data_ptr() if dbg is not None else None,
        _RELAX_CODE[relax_kind], _KIND_CODE[kind], _halves(q),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce_lanes piece launch failed: "
                           f"cudaError {rc}")
    return out, dbg


def _launch_lanes(gval_m, unitw, edge_src, edge_w, edge_mask, edge_dst,
                  plan: LaunchPlan, chunk_act, relax_kind: str, kind: str,
                  with_debug: bool):
    """Launch K3 on the current stream: ``_launch_lane_pieces`` over the
    planned cells whose chunk is live (the OR across lanes).  Returns
    the (num_segments, Q) partial and, with ``with_debug``, the (1,)
    int32 executed-cell counter.  Raises on any launch error."""
    global lanes_launches
    res = _launch_lane_pieces(gval_m, unitw, edge_src, edge_w, edge_mask,
                              edge_dst, plan, chunk_act, None, relax_kind,
                              kind, with_debug)
    lanes_launches += 1
    return res


def _launch_wl_lanes(gval_m, unitw, edge_src, edge_w, edge_mask, edge_dst,
                     plan: LaunchPlan, chunk_act, flags, relax_kind: str,
                     kind: str, with_debug: bool):
    """Launch K4 on the current stream: ``_launch_lane_pieces`` over the
    cells ``flags`` lists, or with ``flags=None`` (a device plan) K3's
    cells.  Returns as ``_launch_lane_pieces``."""
    global wl_lanes_launches
    res = _launch_lane_pieces(gval_m, unitw, edge_src, edge_w, edge_mask,
                              edge_dst, plan, chunk_act, flags, relax_kind,
                              kind, with_debug)
    wl_lanes_launches += 1
    return res


# --------------------------------------------------------------------------
# K5-K8: the tiled launches on the card
# --------------------------------------------------------------------------

def _check_act(act, edge_src):
    """The (E,) active-edge flags a dense tiled launch stages rows from."""
    if act.device != edge_src.device or act.dtype != torch.bool \
            or act.shape != edge_src.shape or not act.is_contiguous():
        raise ValueError(f"act must be a contiguous {tuple(edge_src.shape)} "
                         f"bool on {edge_src.device}")


def _launch_tiled_pieces(gval_m, edge_src, edge_w, edge_mask, edge_dst, act,
                         plan: LaunchPlan, chunk_act, flags, relax_kind: str,
                         kind: str, with_debug: bool):
    """The piece launch of K5 and K6 on the current stream: K1's and K2's
    launch (pieces, the cells ``flags`` lists or, with None, those whose
    chunk is live, the combine), each cell staging the rows of its active
    edges (``act``, from ``_active_edges``) that land in its block.
    Nothing here waits for the card.  Returns the (num_segments,) inbox
    partial and, with ``with_debug``, the (2,) int32 [cells run, staged
    rows]."""
    if gval_m.dim() != 1:
        raise ValueError("K5 and K6 take a (V,) value table")
    _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                       chunk_act)
    _check_act(act, edge_src)
    dev = gval_m.device
    _check_flags(flags, plan, dev)
    pc = plan_pieces(plan)
    out = torch.empty(plan.num_segments, dtype=torch.float32, device=dev)
    split = torch.empty((pc.n_split, SBLK), dtype=torch.float32, device=dev)
    dbg = torch.zeros(2, dtype=torch.int32, device=dev) if with_debug \
        else None
    rc = _kernel("frr_wl_tiled_launch")(
        gval_m.data_ptr(), edge_src.data_ptr(), edge_w.data_ptr(),
        edge_mask.data_ptr(), edge_dst.data_ptr(), act.data_ptr(),
        *_piece_ptrs(plan, pc, flags, chunk_act, plan.num_blocks,
                     edge_dst),
        edge_src.shape[0], plan.num_segments, pc.num_pieces, out.data_ptr(),
        split.data_ptr(), dbg.data_ptr() if dbg is not None else None,
        _RELAX_CODE[relax_kind], _KIND_CODE[kind],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce_tiled piece launch failed: "
                           f"cudaError {rc}")
    return out, dbg


def _launch_tiled(gval_m, edge_src, edge_w, edge_mask, edge_dst,
                  plan: LaunchPlan, chunk_act, act, relax_kind: str,
                  kind: str, with_debug: bool):
    """Launch K5 on the current stream: ``_launch_tiled_pieces`` over K1's
    cells.  Returns the (num_segments,) partial and, with
    ``with_debug``, the (2,) int32 [executed cells, staged rows].
    Raises on any launch error."""
    global tiled_launches
    res = _launch_tiled_pieces(gval_m, edge_src, edge_w, edge_mask,
                               edge_dst, act, plan, chunk_act, None,
                               relax_kind, kind, with_debug)
    tiled_launches += 1
    return res


def _launch_wl_tiled(gval_m, edge_src, edge_w, edge_mask, edge_dst, act,
                     plan: LaunchPlan, chunk_act, flags, relax_kind: str,
                     kind: str, with_debug: bool):
    """Launch K6 on the current stream: ``_launch_tiled_pieces`` over the
    cells ``flags`` lists (None: a device plan).  Returns as
    ``_launch_tiled_pieces``."""
    global wl_tiled_launches
    res = _launch_tiled_pieces(gval_m, edge_src, edge_w, edge_mask,
                               edge_dst, act, plan, chunk_act, flags,
                               relax_kind, kind, with_debug)
    wl_tiled_launches += 1
    return res


def _launch_tiled_lane_pieces(gval_m, unitw, edge_src, edge_w, edge_mask,
                              edge_dst, act, plan: LaunchPlan, chunk_act,
                              flags, relax_kind: str, kind: str,
                              with_debug: bool):
    """The piece launch of K7 and K8 on the current stream: K3's and K4's
    launch (pieces, cells, combine), each cell staging its lane group's
    columns of the rows of its edges active in some lane (``act``, the
    OR-across-lanes flags of ``_lane_chunk_tables``) that land in its
    block.  Returns the (num_segments, Q) inbox partial and, with
    ``with_debug``, the (2,) int32 [cells run, staged rows] (one row per
    cell and position, whatever the lane groups)."""
    _check_lane_tables(gval_m, unitw)
    _check_launch_args(gval_m, edge_src, edge_w, edge_mask, edge_dst, plan,
                       chunk_act)
    _check_act(act, edge_src)
    if gval_m.data_ptr() % 16:
        raise ValueError("the value table must be 16-byte aligned")
    dev = gval_m.device
    _check_flags(flags, plan, dev)
    q = gval_m.shape[1]
    pc = plan_pieces(plan)
    out = torch.empty((plan.num_segments, q), dtype=torch.float32,
                      device=dev)
    split = torch.empty((pc.n_split, SBLK, q), dtype=torch.float32,
                        device=dev)
    dbg = torch.zeros(2, dtype=torch.int32, device=dev) if with_debug \
        else None
    rc = _kernel("frr_wl_tiled_lanes_launch")(
        gval_m.data_ptr(), edge_src.data_ptr(), edge_w.data_ptr(),
        edge_dst.data_ptr(), act.data_ptr(), unitw.data_ptr(),
        *_piece_ptrs(plan, pc, flags, chunk_act,
                     plan.num_blocks * _lane_groups(q), edge_dst),
        edge_src.shape[0], plan.num_segments, pc.num_pieces,
        gval_m.shape[0], q, out.data_ptr(), split.data_ptr(),
        dbg.data_ptr() if dbg is not None else None,
        _RELAX_CODE[relax_kind], _KIND_CODE[kind], _halves(q),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_relax_reduce_tiled_lanes piece launch "
                           f"failed: cudaError {rc}")
    return out, dbg


def _launch_tiled_lanes(gval_m, unitw, edge_src, edge_w, edge_mask,
                        edge_dst, plan: LaunchPlan, chunk_act, act,
                        relax_kind: str, kind: str, with_debug: bool):
    """Launch K7 on the current stream: ``_launch_tiled_lane_pieces`` over
    K3's cells.  Returns as it does."""
    global tiled_lanes_launches
    res = _launch_tiled_lane_pieces(gval_m, unitw, edge_src, edge_w,
                                    edge_mask, edge_dst, act, plan,
                                    chunk_act, None, relax_kind, kind,
                                    with_debug)
    tiled_lanes_launches += 1
    return res


def _launch_wl_tiled_lanes(gval_m, unitw, edge_src, edge_w, edge_mask,
                           edge_dst, act, plan: LaunchPlan, chunk_act,
                           flags, relax_kind: str, kind: str,
                           with_debug: bool):
    """Launch K8 on the current stream: ``_launch_tiled_lane_pieces`` over
    the cells ``flags`` lists (None: a device plan).  Returns as it
    does."""
    global wl_tiled_lanes_launches
    res = _launch_tiled_lane_pieces(gval_m, unitw, edge_src, edge_w,
                                    edge_mask, edge_dst, act, plan,
                                    chunk_act, flags, relax_kind, kind,
                                    with_debug)
    wl_tiled_lanes_launches += 1
    return res


def lane_blocks_per_sm(q: int, tiled: bool = False) -> int:
    """Thread blocks of the laned piece kernel (K3/K4, or K7/K8 with
    ``tiled``) resident on one SM of the current card at ``q`` lanes, by
    the CUDA occupancy calculator."""
    n = _kernel("frr_wl_tiled_lanes_blocks_per_sm" if tiled
                else "frr_wl_lanes_blocks_per_sm")(int(q), _halves(q))
    if n < 0:
        raise RuntimeError(f"occupancy query failed: cudaError {-n}")
    return n


def _pack(out, count, dbg, with_count: bool, with_debug: bool):
    """out / (out, count) / (out, dbg) / (out, count, dbg)."""
    res = (out,)
    if with_count:
        res += (count,)
    if with_debug:
        res += (dbg,)
    return res[0] if len(res) == 1 else res


def _residency(num_slots: int, q: int, num_edges: int, worklist,
               vmem_budget_bytes, path, vblk, smem_budget_bytes):
    """(path, vblk) of one launch: a given worklist's own, else
    ``select_kernel_path``'s."""
    if worklist is not None:
        return worklist.path, worklist.vblk
    return select_kernel_path(
        num_slots, q, vmem_budget_bytes, path=path, vblk=vblk,
        n_chunks=_round_up(num_edges, EBLK) // EBLK,
        smem_budget_bytes=smem_budget_bytes)


def fused_relax_reduce(gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
                       num_segments: int, relax_kind: str, kind: str,
                       with_count: bool = False, with_debug: bool = False,
                       plan: LaunchPlan | None = None,
                       grid_mode: str = "dense",
                       worklist: Worklist | None = None,
                       vmem_budget_bytes=None, path=None, vblk=None,
                       smem_budget_bytes=None):
    """Fused gather/relax/mask/segment-reduce.

    gval: (V,) f32 vertex (replica-slot) values; gchg: (V,) bool changed
    flags (the frontier); edge_src/edge_dst: (E,) int32 into [0, V) /
    [0, num_segments); edge_w: (E,) f32; edge_mask: (E,) bool (False on
    padding).  Returns the (num_segments,) inbox partial — empty segments
    hold the combine identity.  ``with_count=True`` appends the int32
    active-edge count; ``with_debug=True`` appends the int32 counts of
    executed (block, chunk) cells — (1,) pinned, (2,) tiled: [cells,
    staged rows].  ``plan`` is ``plan_launch`` of these edges, built
    here when absent (callers that launch every round build it once).
    Edges should be sorted by ``edge_dst`` for the range skip to bite;
    correctness never depends on the sort.

    ``worklist=`` (a host plan from ``WorklistPlanner`` or a device plan
    from ``build_device_worklist``) runs a worklist launch;
    ``grid_mode='worklist'`` plans one on the host here and
    ``grid_mode='device_worklist'`` compacts one on the device.  Any
    other ``grid_mode`` keeps the dense launch.  Residency follows
    ``select_kernel_path`` (``vmem_budget_bytes``, ``path``, ``vblk``,
    ``smem_budget_bytes``), or a given worklist's own: pinned runs K1
    (dense) / K2 (worklist), tiled K5 / K6.  Min results are
    bit-identical across launches; K5's sums are K1's, K6's are K2's,
    and K2's are K1's (the cells a worklist drops add only the
    identity); the plain version sums in another order.

    CUDA tensors launch the kernels; CPU tensors run the plain versions.
    """
    _check_pair(relax_kind, kind)
    identity = math.inf if kind == "min" else 0.0
    dev = gval.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {gval.device}")
    v = gval.shape[0]
    path, vblk = _residency(v, 1, edge_src.shape[0], worklist,
                            vmem_budget_bytes, path, vblk,
                            smem_budget_bytes)
    tiled = path == "tiled"
    if worklist is None and grid_mode == "worklist":
        worklist = _launch_worklist(gchg, edge_src, edge_mask, edge_dst,
                                    num_segments, path, vblk)
    wl_launch = worklist is not None or grid_mode == "device_worklist"
    need_plan = dev == "cuda" or (worklist is None and (
        with_debug or grid_mode == "device_worklist" or tiled))
    if need_plan and plan is None:
        plan = plan_launch(edge_src, edge_mask, edge_dst, num_segments, v)
    act = _active_edges(edge_src, edge_mask, gchg)
    chunk_act, count = _chunk_tables(edge_src, edge_mask, gchg, act)
    if dev == "cuda":
        gval_m = _masked_value_tables(gval, gchg, identity)
        flags = _card_flags(worklist, plan, num_segments)
        if wl_launch and tiled:
            out, dbg = _launch_wl_tiled(gval_m, edge_src, edge_w, edge_mask,
                                        edge_dst, act, plan, chunk_act,
                                        flags, relax_kind, kind, with_debug)
        elif wl_launch:
            out, dbg = _launch_wl(gval_m, edge_src, edge_w, edge_mask,
                                  edge_dst, plan, chunk_act, flags,
                                  relax_kind, kind, with_debug)
        elif tiled:
            out, dbg = _launch_tiled(gval_m, edge_src, edge_w, edge_mask,
                                     edge_dst, plan, chunk_act, act,
                                     relax_kind, kind, with_debug)
        else:
            out, dbg = _launch(gval_m, edge_src, edge_w, edge_mask,
                               edge_dst, plan, chunk_act, relax_kind, kind,
                               with_debug)
        return _pack(out, count, dbg, with_count, with_debug)
    if worklist is None and grid_mode == "device_worklist":
        worklist = _compact_live_cells(plan, chunk_act,
                                       device_worklist_pad(plan), path, vblk)
    if worklist is not None and tiled:
        out, rows = ref.fused_relax_reduce_wl_tiled_ref(
            gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
            worklist.wl_i, worklist.wl_j, worklist.nlive, num_segments,
            relax_kind, kind)
        dbg = torch.cat([worklist.nlive, rows.view(1)])
    elif worklist is not None:
        out = ref.fused_relax_reduce_wl_ref(
            gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
            worklist.wl_i, worklist.wl_j, worklist.nlive, num_segments,
            relax_kind, kind)
        dbg = worklist.nlive.clone() if with_debug else None
    elif tiled:
        out, rows = ref.fused_relax_reduce_tiled_ref(
            gval, gchg, edge_src, edge_w, edge_mask, edge_dst, num_segments,
            relax_kind, kind, plan)
        dbg = torch.cat([_executed_cells(plan, chunk_act), rows.view(1)])
    else:
        out = ref.fused_relax_reduce_ref(gval, gchg, edge_src, edge_w,
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
                             worklist: Worklist | None = None,
                             vmem_budget_bytes=None, path=None, vblk=None,
                             smem_budget_bytes=None):
    """Lane-batched fused gather/relax/mask/segment-reduce.

    ``gval``/``gchg``: (V, Q) per-lane values and frontiers over one
    shared edge set (shapes of the edges as in ``fused_relax_reduce``).
    Returns the (num_segments, Q) per-lane inbox partial; ``with_count``
    appends the (Q,) int32 per-lane active-edge counts, ``with_debug``
    the int32 executed-cell count ((2,) tiled: [cells, staged rows]).
    ``lane_unitw`` (Q,) only matters for ``relax_kind='add_w'``: a lane
    with a nonzero flag relaxes with weight 1.0 (BFS levels) instead of
    the edge weight (SSSP), so one launch serves a mixed BFS/SSSP batch.
    A converged lane has an all-False frontier column and contributes the
    identity everywhere; the chunk skip is the OR across lanes.

    Pinned, the dense launch is K3 and ``worklist=`` (a host plan, from
    the OR-across-lanes frontier) or ``grid_mode='worklist' |
    'device_worklist'`` runs K4; tiled (the (V, Q) table
    over the budget, or ``path``/``vblk``), K7 and K8.  There is no lane
    padding: any Q gives the columns its lanes would give alone, and
    residency is judged at Q lanes.  Min results are bit-identical
    across launches; K7's sums are K3's, K8's are K4's, and K4's are
    K3's; the plain version sums in another order.

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
    v, q = gval.shape
    unitw = torch.as_tensor(lane_unitw).reshape(q).to(device=gval.device)
    path, vblk = _residency(v, q, edge_src.shape[0], worklist,
                            vmem_budget_bytes, path, vblk,
                            smem_budget_bytes)
    tiled = path == "tiled"
    if worklist is None and grid_mode == "worklist":
        worklist = _launch_worklist(gchg, edge_src, edge_mask, edge_dst,
                                    num_segments, path, vblk, q)
    wl_launch = worklist is not None or grid_mode == "device_worklist"
    need_plan = dev == "cuda" or (worklist is None and (
        with_debug or grid_mode == "device_worklist" or tiled))
    if need_plan and plan is None:
        plan = plan_launch(edge_src, edge_mask, edge_dst, num_segments, v)
    chunk_act, counts, act = _lane_chunk_tables(
        edge_src, edge_mask, gchg, None if plan is None else plan.src_deg,
        with_act=True)
    if dev == "cuda":
        gval_m = _masked_value_tables(gval, gchg, identity)
        unit_u8 = (unitw != 0).to(torch.uint8)
        flags = _card_flags(worklist, plan, num_segments)
        if wl_launch and tiled:
            out, dbg = _launch_wl_tiled_lanes(
                gval_m, unit_u8, edge_src, edge_w, edge_mask, edge_dst, act,
                plan, chunk_act, flags, relax_kind, kind, with_debug)
        elif wl_launch:
            out, dbg = _launch_wl_lanes(gval_m, unit_u8, edge_src, edge_w,
                                        edge_mask, edge_dst, plan, chunk_act,
                                        flags, relax_kind, kind, with_debug)
        elif tiled:
            out, dbg = _launch_tiled_lanes(
                gval_m, unit_u8, edge_src, edge_w, edge_mask, edge_dst, plan,
                chunk_act, act, relax_kind, kind, with_debug)
        else:
            out, dbg = _launch_lanes(gval_m, unit_u8, edge_src, edge_w,
                                     edge_mask, edge_dst, plan, chunk_act,
                                     relax_kind, kind, with_debug)
        return _pack(out, counts, dbg, with_count, with_debug)
    if worklist is None and grid_mode == "device_worklist":
        worklist = _compact_live_cells(plan, chunk_act,
                                       device_worklist_pad(plan), path, vblk)
    if worklist is not None and tiled:
        out, rows = ref.fused_relax_reduce_wl_tiled_lanes_ref(
            gval, gchg, unitw, edge_src, edge_w, edge_mask, edge_dst,
            worklist.wl_i, worklist.wl_j, worklist.nlive, num_segments,
            relax_kind, kind)
        dbg = torch.cat([worklist.nlive, rows.view(1)])
    elif worklist is not None:
        out = ref.fused_relax_reduce_wl_lanes_ref(
            gval, gchg, unitw, edge_src, edge_w, edge_mask, edge_dst,
            worklist.wl_i, worklist.wl_j, worklist.nlive, num_segments,
            relax_kind, kind)
        dbg = worklist.nlive.clone() if with_debug else None
    elif tiled:
        out, rows = ref.fused_relax_reduce_tiled_lanes_ref(
            gval, gchg, unitw, edge_src, edge_w, edge_mask, edge_dst,
            num_segments, relax_kind, kind, plan)
        dbg = torch.cat([_executed_cells(plan, chunk_act), rows.view(1)])
    else:
        out = ref.fused_relax_reduce_lanes_ref(gval, gchg, unitw, edge_src,
                                               edge_w, edge_mask, edge_dst,
                                               num_segments, relax_kind,
                                               kind)
        dbg = _executed_cells(plan, chunk_act) if with_debug else None
    return _pack(out, counts, dbg, with_count, with_debug)


# --------------------------------------------------------------------------
# host-side launch mirror (grid-cell accounting)
# --------------------------------------------------------------------------

def _unfused_mirror(edge_dst, seg0) -> dict:
    """The reference's unfused composition: S per-shard segment-reduce
    launches over (S, E_max) ids, every in-shard position valid (padding
    ids widen chunk ranges), range skip only.  Returns its grid size
    (``total_unfused``) and the cells whose range meets (``range_live``)."""
    S, E_max = edge_dst.shape
    ep = _round_up(E_max, EBLK)
    ids = np.zeros((S, ep), np.int64)
    ids[:, :E_max] = edge_dst
    valid = np.zeros(ep, bool)
    valid[:E_max] = True
    idc = ids.reshape(S, ep // EBLK, EBLK)
    v = valid.reshape(ep // EBLK, EBLK)[None, :, :]
    lo = np.where(v, idc, np.iinfo(np.int64).max).min(axis=-1)
    hi = np.where(v, idc, -1).max(axis=-1)                   # (S, n_j)
    inter = (hi[:, None, :] >= seg0[None, :, :]) \
        & (lo[:, None, :] < seg0[None, :, :] + SBLK)         # (S, n_i, n_j)
    return {"total_unfused": int(inter.size),
            "range_live": int(inter.sum())}


def fused_grid_cells(edge_dst, edge_mask, edge_src, gchg,
                     num_segments: int, vblk: int | None = None,
                     lane_width: int = 1, grid_mode: str = "dense",
                     pad_to: int = WL_PAD, dst_filter: bool = True) -> dict:
    """Host-side mirror of the fused launch over an edge stack, with the
    reference's keys and call form.

    Edge arrays are (S, E_max) host arrays, or 1-D for a single flat
    launch; ``gchg`` is the (V,) frontier, or a (V, Q) lane frontier,
    OR'd across lanes (the laned launches skip on the OR).  Returns
    ``total_fused`` (the reference's dense (segment block, chunk) grid),
    ``fused_live`` (its cells whose chunk is frontier-live: the cells the
    kernel executes, equal to its ``with_debug`` count), the reference's
    unfused mirror (``total_unfused``, ``range_live``), and the port's
    own ``launch_cells`` (the (block, chunk) pairs whose range meets,
    which this port's blocks walk).

    With ``vblk`` it also mirrors the tiled launch: ``fused_staged_rows``
    (the rows K5/K7 stage, equal to their count) and ``staged_bytes``
    (rows x lane_width x 4), and the reference's tile accounting:
    ``chunk_ntiles`` (the distinct active-source tiles of each chunk),
    ``fused_tile_dmas`` (tile copies when each live cell copies its
    chunk's tiles, equal to the reference kernel's count), ``dma_bytes``
    (copies x vblk x lane_width x 4) and ``smem_table_bytes``.

    ``grid_mode='worklist'`` adds the host worklist's mirror (the
    planner's, with ``pad_to`` and ``dst_filter``): ``wl_cells``,
    ``wl_launched``, ``wl_tile_dmas``, ``wl_tile_needed``,
    ``wl_dma_bytes`` and ``smem_table_bytes``.  ``'device_worklist'``
    adds the same keys for a device plan: its cells are the dense grid's
    live ones and its tile copies the chunks' lists summed over them;
    ``wl_launched`` is this port's static device list
    (``device_worklist_pad`` of the launch's plan), not the reference's
    full-grid length."""
    num_slots = np.asarray(gchg).shape[0]
    tiled = vblk is not None
    planner = WorklistPlanner(edge_dst, edge_mask, edge_src, num_segments,
                              num_slots=num_slots,
                              path="tiled" if tiled else "pinned",
                              vblk=vblk, lane_width=lane_width)
    d = planner.dense_mirror(gchg, tile_lists=tiled)
    seg0 = np.arange(planner.n_i)[:, None] * SBLK
    out = {"total_fused": planner.total_cells,
           "launch_cells": d["launched"], "fused_live": d["cells"],
           **_unfused_mirror(np.atleast_2d(np.asarray(edge_dst)), seg0)}
    if tiled:
        out["chunk_ntiles"] = d["chunk_ntiles"].tolist()
        out["fused_tile_dmas"] = d["tile_dmas"]
        out["dma_bytes"] = d["dma_bytes"]
        out["fused_staged_rows"] = d["staged_rows"]
        out["staged_bytes"] = d["staged_bytes"]
    if grid_mode == "worklist":
        _, info = planner.plan(gchg, pad_to=pad_to, dst_filter=dst_filter,
                               tile_lists=tiled)
        out.update(wl_cells=info.cells, wl_launched=info.launched,
                   wl_tile_dmas=info.tile_dmas,
                   wl_tile_needed=info.tile_needed,
                   wl_dma_bytes=info.dma_bytes,
                   smem_table_bytes=info.smem_table_bytes)
    elif grid_mode == "device_worklist":
        l_pad = _wl_pad_len(planner.launch_cells)
        out.update(wl_cells=d["cells"], wl_launched=l_pad,
                   wl_tile_dmas=d["tile_dmas"], wl_tile_needed=d["tile_dmas"],
                   wl_dma_bytes=d["dma_bytes"],
                   smem_table_bytes=smem_table_bytes(
                       planner.n_chunks, planner.t_max, l_pad))
    elif tiled:
        out["smem_table_bytes"] = smem_table_bytes(planner.n_chunks,
                                                   planner.t_max)
    return out


# --------------------------------------------------------------------------
# the reference's entry-point names
# --------------------------------------------------------------------------

def _tensors(*xs, device=None):
    """``xs`` as tensors: arrays that are not tensors go on ``device``,
    else on the device of the first tensor among ``xs``, else on CUDA
    (``engine.resolve_device``, which raises when there is no card)."""
    from repro_torch.core.engine import resolve_device
    if device is None:
        device = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                      None)
    dev = resolve_device(device)
    return [x if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x), device=dev) for x in xs]


def fused_relax_reduce_pallas(gval, gchg, edge_src, edge_w, edge_mask,
                              edge_dst, num_segments: int, relax_kind: str,
                              kind: str, interpret: bool = True,
                              with_count: bool = False,
                              vmem_budget_bytes=None, path=None, vblk=None,
                              with_debug: bool = False,
                              grid_mode: str = "dense", worklist=None,
                              smem_budget_bytes=None, device=None):
    """``fused_relax_reduce`` in the reference's positional order.
    ``interpret`` is accepted and ignored: a CUDA tensor launches the
    kernel (K1, K2, K5 or K6), a CPU tensor runs its plain version.
    Arrays that are not tensors go on ``device``, else where the tensor
    arguments are, else on the card (``_tensors``)."""
    return fused_relax_reduce(
        *_tensors(gval, gchg, edge_src, edge_w, edge_mask, edge_dst,
                  device=device),
        num_segments, relax_kind, kind, with_count=with_count,
        with_debug=with_debug, grid_mode=grid_mode, worklist=worklist,
        vmem_budget_bytes=vmem_budget_bytes, path=path, vblk=vblk,
        smem_budget_bytes=smem_budget_bytes)


def fused_relax_reduce_lanes_pallas(gval, gchg, lane_unitw, edge_src, edge_w,
                                    edge_mask, edge_dst, num_segments: int,
                                    relax_kind: str, kind: str,
                                    interpret: bool = True,
                                    with_count: bool = False,
                                    vmem_budget_bytes=None, path=None,
                                    vblk=None, lane_tile=None,
                                    with_debug: bool = False,
                                    grid_mode: str = "dense",
                                    worklist=None, smem_budget_bytes=None,
                                    device=None):
    """``fused_relax_reduce_lanes`` in the reference's positional order.
    ``interpret`` and ``lane_tile`` (the reference's lane padding, which
    changes no value) are accepted and ignored: a CUDA tensor launches
    the kernel (K3, K4, K7 or K8), a CPU tensor runs its plain version.
    Arrays that are not tensors are placed as in
    ``fused_relax_reduce_pallas``."""
    return fused_relax_reduce_lanes(
        *_tensors(gval, gchg, lane_unitw, edge_src, edge_w, edge_mask,
                  edge_dst, device=device),
        num_segments, relax_kind, kind, with_count=with_count,
        with_debug=with_debug, grid_mode=grid_mode, worklist=worklist,
        vmem_budget_bytes=vmem_budget_bytes, path=path, vblk=vblk,
        smem_budget_bytes=smem_budget_bytes)
