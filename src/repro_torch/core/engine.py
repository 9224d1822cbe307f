"""Diffusive fixpoint engine (paper §4–§5) in PyTorch.

The paper's asynchronous message-driven execution is re-expressed as bulk
edge-parallel relaxation rounds whose fixpoint equals the asynchronous
fixpoint (monotone semirings ⇒ order-free). One round is the diffuse-queue
drain: diffusions generated in round k are evaluated in round k+1 against
the newest vertex state, so stale diffusions are *subsumed* exactly as the
paper's lazy-diffuse pruning does.

The per-round math — relax, dense or compact targeted exchange, rhizome
collapse — lives in the exchange layer (``repro_torch.exchange``); this
module runs the rounds: it owns the fixpoint loop, the termination check
and the Fig-6 stats bookkeeping.  ``run_stacked`` keeps all shards
stacked ``(S, …)`` on one device; ``run_sharded`` and the sharded
PageRanks run one shard a process over ``torch.distributed`` (a
``DeviceMesh`` in ``mesh=``), every rank making the same call.

With ``EngineConfig.use_pallas`` the relax phase of every round runs
through the hand-written fused kernels (``kernels.fused_relax_reduce``)
on a CUDA device; without it the same math runs as separate torch ops —
the oracle path.  ``grid_mode`` shapes the launch: the dense launch
(K1), a host-planned worklist launch (K2) every round ('worklist') or
when the frontier is sparse ('auto'), or a worklist compacted on the
device ('device_worklist'), whose rounds run in windows of
``device_window`` rounds with one host read per window.

Entry points take ``device``: ``None`` means ``"cuda"`` and raises when
CUDA is absent; pass ``device="cpu"`` to run on the CPU, where the fused
path runs its kernel's plain version.
"""
from __future__ import annotations

import dataclasses
import functools
import typing
import warnings

import numpy as np
import torch

from repro_torch import exchange, obs
from repro_torch.core.actions import Semiring
from repro_torch.core.partition import Partition
from repro_torch.kernels import fused_relax_reduce as frr


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine options, with the reference's fields, defaults and checks.

    ``exchange='compact'`` ships per-source (target, distinct-slot)
    partials instead of the dense global inbox: the fused relax launches
    over offset compact ids (``S*S*P_t`` segments, ``DeviceArrays.
    compact``), and only rhizome slots take part in the collapse.
    ``pallas_mode='reduce'`` relaxes with torch ops and reduces with the
    segment-reduce kernel K9 (unlaned runs only, as in the reference).
    ``vmem_budget_bytes`` decides the value table's residency, as in the
    reference (``kernels.fused_relax_reduce.select_kernel_path``; None
    defers to the ``REPRO_VMEM_BUDGET`` env var, then to a default that
    keeps every table the card holds pinned): a (S*R_max[, Q]) table over
    the budget runs the fused relax through the tiled kernels K5-K8,
    which stage the source rows each live cell reads into shared memory,
    instead of K1-K4.
    ``smem_budget_bytes`` arms the index-table guard (a warning, and a
    wider tile on the tiled path), as in the reference.
    ``checkpoint_every=K`` makes the resilient runner
    (``core.resilient.run_resilient``) hand its state to a checkpoint
    manager every K rounds; the plain runners ignore it, as in the
    reference."""

    collapse: str = "eager"      # 'eager' | 'deferred' (min-semirings only)
    exchange: str = "dense"      # 'dense' | 'compact' (targeted messages)
    max_iters: int = 4096
    use_pallas: bool = False     # route the relax phase through the kernel
    # 'fused'  — one gather+relax+mask+reduce kernel with frontier chunk
    #            skip (the hot path; default)
    # 'reduce' — plain gather/relax/mask + a standalone segment-reduce
    #            kernel (the pre-fusion composition)
    pallas_mode: str = "fused"
    # False skips the Fig-6 message counter; RunStats then reports zero
    # messages/pruned
    track_stats: bool = True
    # fused-kernel launch shape: 'dense' (K1) | 'worklist' (host-planned
    # K2 every round) | 'auto' (K2 when the dense grid's live fraction is
    # below WORKLIST_AUTO_THRESHOLD) | 'device_worklist' (K2 over a list
    # compacted on the device, rounds enqueued in windows)
    grid_mode: str = "dense"
    # rounds per window of a device_worklist loop: one host read each
    device_window: int = 8
    # byte budget for the kernel's prefetched index tables (None: no guard)
    smem_budget_bytes: int | None = None
    # checkpoint cadence for a resilient runner (None disables)
    checkpoint_every: int | None = None
    # byte budget for the value table's fast-memory residency
    vmem_budget_bytes: int | None = None

    def __post_init__(self):
        if self.collapse not in ("eager", "deferred"):
            raise ValueError(f"collapse={self.collapse!r}")
        if self.exchange not in ("dense", "compact"):
            raise ValueError(f"exchange={self.exchange!r}")
        if self.pallas_mode not in ("fused", "reduce"):
            raise ValueError(f"pallas_mode={self.pallas_mode!r}")
        if self.vmem_budget_bytes is not None \
                and self.vmem_budget_bytes <= 0:
            raise ValueError(
                f"vmem_budget_bytes={self.vmem_budget_bytes!r}")
        if self.grid_mode not in ("dense", "worklist", "auto",
                                  "device_worklist"):
            raise ValueError(f"grid_mode={self.grid_mode!r}")
        if self.device_window < 1:
            raise ValueError(f"device_window={self.device_window!r}")
        if self.checkpoint_every is not None and self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every={self.checkpoint_every!r}")
        if self.smem_budget_bytes is not None \
                and self.smem_budget_bytes <= 0:
            raise ValueError(
                f"smem_budget_bytes={self.smem_budget_bytes!r}")

    @property
    def wants_worklist(self) -> bool:
        """Whether runners plan host-side worklist launches (only the
        fused kernel path has a grid to sparsify)."""
        return (self.grid_mode in ("worklist", "auto") and self.use_pallas
                and self.pallas_mode == "fused")

    @property
    def wants_device_worklist(self) -> bool:
        """Whether the relax phase compacts its worklist on the device,
        so the runners enqueue rounds in windows."""
        return (self.grid_mode == "device_worklist" and self.use_pallas
                and self.pallas_mode == "fused")


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, and raises when CUDA is absent: the engine
    never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class CompactTables:
    """The compact exchange's device tables of one partition, made on
    first use and kept, so a dense run never uploads or plans them: the
    reference's five compact fields, where the inbox scatter puts each
    contribution (``exchange.inbox_index``), the offset ids the stacked
    launch reduces over (``edge_dst_compact + s*S*P_t`` on source shard
    s: each source gets a disjoint window of ``S*P_t`` segments) and that
    launch's plan (``S*S*P_t`` segments over the ``S*R_max`` slots).  A
    masked padding edge's id is its window's lowest; the plan keeps the
    mask, so its chunk ranges skip it.

    One shard's tables (``shard=r``) are row r of each field (a leading
    dim of 1); its launch reduces its own edges into its ``S*P_t``
    window with no offset."""

    def __init__(self, part: Partition, put, edge_src, edge_mask,
                 shard: int | None = None):
        self._part, self._put = part, put
        self._src, self._mask = edge_src, edge_mask
        self._shard = shard

    def _field(self, x, dtype):
        s = self._shard
        return self._put(x if s is None else np.asarray(x)[s:s + 1], dtype)

    @functools.cached_property
    def edge_dst_compact(self):        # (S, E_max) int32 -> [0, S*P_t)
        return self._field(self._part.edge_dst_compact, torch.int32)

    @functools.cached_property
    def inbox_slot_map(self):          # (S_tgt, S_src, P_t) int32, R_max pad
        return self._field(self._part.inbox_slot_map, torch.int32)

    @functools.cached_property
    def rz_local(self):                # (S, R_rz_max) int32, R_max pad
        return self._field(self._part.rz_local, torch.int32)

    @functools.cached_property
    def rz_sibling_idx(self):          # (S, R_rz_max, K) int32
        return self._field(self._part.rz_sibling_idx, torch.int32)

    @functools.cached_property
    def rz_sibling_mask(self):         # (S, R_rz_max, K) bool
        return self._field(self._part.rz_sibling_mask, torch.bool)

    @functools.cached_property
    def inbox_index(self):             # exchange.inbox_index of the map
        return exchange.inbox_index(self.inbox_slot_map, self._part.R_max)

    @functools.cached_property
    def ids(self):                     # (S*E_max,) int32 offset ids
        part = self._part
        dst = self.edge_dst_compact
        if self._shard is not None:    # one window: no offset
            return dst.reshape(-1)
        offs = torch.arange(part.S, dtype=torch.int32, device=dst.device) \
            * (part.S * part.P_t)
        return (dst + offs[:, None]).reshape(-1)

    @functools.cached_property
    def plan(self) -> frr.LaunchPlan:
        part = self._part
        windows = 1 if self._shard is not None else part.S
        return frr.plan_launch(self._src.reshape(-1),
                               self._mask.reshape(-1), self.ids,
                               windows * part.S * part.P_t,
                               part.S * part.R_max)


class DeviceArrays(typing.NamedTuple):
    """Static per-shard tensors, stacked with leading dim S, plus the
    fused kernel's launch plan over the flattened dense edge stack.  The
    reference's compact fields (``edge_dst_compact``, ``inbox_slot_map``,
    ``rz_local``, ``rz_sibling_idx``, ``rz_sibling_mask``) are read
    through ``compact``, which uploads them on first use.

    ``from_partition(part, shard=r)`` uploads one shard: every field is
    row r with a leading dim of 1 (the reference's ``x[0]`` under
    ``shard_map``) and the plan is that shard's own launch — its edges
    into the ``S*R_max`` slots of every shard.  ``root_flat`` (each
    vertex's root slot, read with ``slot_vertex`` by the parent pass of
    ``apps.bfs_tree`` / ``sssp_tree``) is the whole partition's either
    way."""

    edge_src_root_flat: torch.Tensor  # (S, E_max) int32
    edge_dst_flat: torch.Tensor       # (S, E_max) int32 (sorted per shard)
    edge_w: torch.Tensor              # (S, E_max) f32
    edge_mask: torch.Tensor           # (S, E_max) bool
    sibling_flat: torch.Tensor        # (S, R_max, K) int32
    sibling_mask: torch.Tensor        # (S, R_max, K) bool
    slot_valid: torch.Tensor          # (S, R_max) bool
    fused_plan: frr.LaunchPlan        # block -> edge-chunk lists
    compact: CompactTables            # the compact exchange's tables
    slot_vertex: torch.Tensor | None = None  # (S, R_max) int32, -1 pad
    root_flat: torch.Tensor | None = None    # (n,) int64, every shard's

    @classmethod
    def from_partition(cls, part: Partition, device=None,
                       shard: int | None = None) -> "DeviceArrays":
        dev = resolve_device(device)

        def put(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x)).to(
                device=dev, dtype=dtype)

        def row(x, dtype):
            x = np.asarray(x)
            return put(x if shard is None else x[shard:shard + 1], dtype)

        with obs.span("engine.upload", track="app"):
            src = row(part.edge_src_root_flat, torch.int32)
            dst = row(part.edge_dst_flat, torch.int32)
            mask = row(part.edge_mask, torch.bool)
            with obs.span("engine.plan", track="app"):
                plan = frr.plan_launch(src.reshape(-1), mask.reshape(-1),
                                       dst.reshape(-1), part.S * part.R_max,
                                       part.S * part.R_max)
            return cls(
                edge_src_root_flat=src,
                edge_dst_flat=dst,
                edge_w=row(part.edge_w, torch.float32),
                edge_mask=mask,
                sibling_flat=row(part.sibling_flat, torch.int32),
                sibling_mask=row(part.sibling_mask, torch.bool),
                slot_valid=row(part.slot_vertex >= 0, torch.bool),
                fused_plan=plan,
                compact=CompactTables(part, put, src, mask, shard),
                slot_vertex=row(part.slot_vertex, torch.int32),
                root_flat=put(part.root_flat, torch.int64),
            )

    @property
    def edge_dst_compact(self):
        return self.compact.edge_dst_compact

    @property
    def inbox_slot_map(self):
        return self.compact.inbox_slot_map

    @property
    def rz_local(self):
        return self.compact.rz_local

    @property
    def rz_sibling_idx(self):
        return self.compact.rz_sibling_idx

    @property
    def rz_sibling_mask(self):
        return self.compact.rz_sibling_mask

    def launch_plan(self, cfg) -> frr.LaunchPlan:
        """The fused launch's plan under ``cfg.exchange``."""
        return self.compact.plan if cfg.exchange == "compact" \
            else self.fused_plan


# --------------------------------------------------------------------------
# resident device tables: one upload per partition and device
# --------------------------------------------------------------------------

_RESIDENT = "_device_tables"


class _Resident(dict):
    """A partition's resident ``DeviceArrays`` by device, kept in the
    partition's ``__dict__``.  Pickled (or deep-copied) it is empty:
    device tables do not travel with a partition."""

    def __reduce__(self):
        return (_Resident, ())


def _device_key(dev: torch.device) -> torch.device:
    """``dev`` with its index made explicit, so ``cuda`` and ``cuda:0``
    (the current device) name one entry, as ``cpu`` and ``cpu:0`` do."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if dev.type == "cpu" else dev


def device_arrays(part: Partition, device=None) -> DeviceArrays:
    """``part``'s static device tables on ``device``, resident across
    calls: ``DeviceArrays.from_partition`` uploads and plans them on the
    first call for a device (its spans ``engine.upload`` ⊃
    ``engine.plan``); later calls return the same tables, their launch
    plan and the plan's scratch included (an ``engine.upload`` span with
    ``resident=True`` around the lookup).  ``engine_device_tables_total``
    counts each call under ``result`` ``upload`` or ``hit``.

    Keyed on the partition object and the resolved device.  The tables
    live on the partition and go with it: they and the partition form a
    cycle (``CompactTables`` holds its partition), which ``gc.collect()``
    frees once nothing else holds the partition.  They are the
    partition's arrays as first uploaded: a caller that writes a
    partition's arrays in place calls ``drop_device_arrays`` first.  A
    splice (``splice_partition``), a server's mutation or a restore makes
    a new ``Partition``, and so new tables."""
    key = _device_key(resolve_device(device))
    tables = vars(part).setdefault(_RESIDENT, _Resident())
    counter = obs.registry().counter(
        "engine_device_tables_total",
        "partition device-table requests, uploaded or found resident")
    if key in tables:
        with obs.span("engine.upload", track="app", resident=True):
            counter.labels(result="hit").inc()
            return tables[key]
    tables[key] = DeviceArrays.from_partition(part, key)
    counter.labels(result="upload").inc()
    return tables[key]


def drop_device_arrays(part: Partition) -> None:
    """Forget ``part``'s resident device tables on every device, so its
    next ``device_arrays`` call uploads them anew."""
    vars(part).pop(_RESIDENT, None)


class RunStats(typing.NamedTuple):
    iterations: torch.Tensor        # rounds executed
    messages: torch.Tensor          # actions delivered (edge messages)
    work_actions: torch.Tensor      # predicate-true slot updates
    pruned_actions: torch.Tensor    # delivered but predicate-false
    diffusions: torch.Tensor        # slots that diffused (entered the frontier)


# --------------------------------------------------------------------------
# worklist launch planning (grid_mode='worklist'|'auto' host-driven rounds)
# --------------------------------------------------------------------------

# 'auto' plans a worklist launch only when the dense grid's live fraction
# drops below this — a dense frontier gains nothing from the 1-D launch
# but pays the planning pass
WORKLIST_AUTO_THRESHOLD = 0.25


def launch_planner(part: Partition, cfg: EngineConfig, q_pad: int = 1):
    """Host-side ``WorklistPlanner`` for the stacked fused launch under
    ``cfg``, mirroring the launch ``relax`` makes: the dense exchange
    flattens ``edge_dst_flat`` over ``S*R_max`` segments; the compact one
    offsets ``edge_dst_compact`` into per-source-shard windows over
    ``S*S*P_t`` (``CompactTables.ids``).  Its residency is the launch's:
    ``select_kernel_path`` of the (S*R_max, q_pad) table against
    ``cfg.vmem_budget_bytes``, so a laned launch passes its lane count
    ``q_pad`` (which also prices the staged rows)."""
    S, R_max = part.S, part.R_max
    num_slots = S * R_max
    if cfg.exchange == "compact":
        offs = (np.arange(S, dtype=np.int64) * (S * part.P_t))[:, None]
        ids = np.asarray(part.edge_dst_compact) + offs
        num_segments = S * S * part.P_t
    else:
        ids = np.asarray(part.edge_dst_flat)
        num_segments = num_slots
    n_chunks = frr._round_up(ids.size, frr.EBLK) // frr.EBLK
    path, vblk = frr.select_kernel_path(
        num_slots, q_pad, cfg.vmem_budget_bytes, n_chunks=n_chunks,
        smem_budget_bytes=cfg.smem_budget_bytes)
    return frr.WorklistPlanner(
        ids, part.edge_mask, part.edge_src_root_flat, num_segments,
        num_slots=num_slots, path=path, vblk=vblk, lane_width=q_pad,
        smem_budget_bytes=cfg.smem_budget_bytes)


def plan_round_worklist(planner, cfg: EngineConfig, gchg,
                        with_info: bool = False):
    """One round's launch decision for a host-driven loop: a ``Worklist``
    under 'worklist' (and under 'auto' when the frontier is sparse
    enough), else None — the dense launch.  ``with_info=True`` also
    returns the planner's ``WorklistInfo`` (None for dense rounds)."""
    thresh = (WORKLIST_AUTO_THRESHOLD if cfg.grid_mode == "auto"
              else None)
    wl, info = planner.plan(gchg, max_live_fraction=thresh)
    return (wl, info) if with_info else wl


def _obs_record_round(rec, run, part, cfg, planner, rnd, gchg, frontier,
                      mc, work, wl, info, wall_s):
    """Build + store one flight-recorder ``RoundRecord``: the cell and
    copy columns come from the planner mirror of the launch this round
    made (``WorklistInfo`` for worklist launches: the cells and the rows
    K6 stages; for dense launches the cells K1/K5 executes, the rows K5
    stages and, as ``launched``, the cells its blocks walk), plus the
    per-shard message-volume mirror feeding the skew gauge.  Only ever
    called with a recorder installed."""
    grid = "dense" if wl is None else "worklist"
    tile_dmas = dma_bytes = 0
    if planner is not None:
        path = planner.path
        if wl is not None:
            cells, launched = info.cells, info.launched
            tile_dmas, dma_bytes = info.staged_rows, info.staged_bytes
        else:
            d = planner.dense_mirror(gchg)
            cells, launched = d["cells"], d["launched"]
            if cfg.pallas_mode == "fused":
                tile_dmas, dma_bytes = d["staged_rows"], d["staged_bytes"]
    else:
        path = "torch"
        cells = launched = 0
    shard = exchange.shard_message_mirror(
        part.edge_mask, part.edge_src_root_flat, gchg)
    rec.add_round(
        obs.RoundRecord(
            run=run, round=rnd, frontier=frontier, messages=mc, work=work,
            pruned=mc - min(work, mc), grid=grid, path=path, cells=cells,
            launched=launched, tile_dmas=tile_dmas, dma_bytes=dma_bytes,
            wall_s=wall_s, shard_messages=[int(x) for x in shard]),
        frontier_bitmap=gchg.copy() if rec.keep_frontiers else None)


# --------------------------------------------------------------------------
# fixpoint apps (BFS / SSSP)
# --------------------------------------------------------------------------

def run_stacked(sem: Semiring, part: Partition, init_val,
                cfg: EngineConfig = EngineConfig(), init_changed=None,
                device=None, arrays=None):
    """Single-device stacked execution. ``init_val``: (S, R_max) float32.
    ``init_changed`` (optional bool (S, R_max)) seeds the first frontier —
    used by incremental recompute to re-diffuse only mutation sites.

    The fixpoint is a Python loop over rounds.  Under 'dense',
    'worklist' and 'auto' each round is one batch of eager launches and
    the loop pays one host sync per round to test the frontier (and to
    plan the worklist); under 'device_worklist' rounds are enqueued in
    windows of ``cfg.device_window`` with one host read per window.
    ``engine_dispatches_total`` / ``engine_host_syncs_total`` count
    exactly that.  ``arrays``: the caller's own
    ``DeviceArrays.from_partition(part)`` (``None``: the partition's
    resident tables, ``device_arrays``).
    Returns ((S, R_max) values, ``RunStats``) as tensors on ``device``."""
    if sem.segment != "min":
        raise ValueError(
            "run_stacked drives monotone min-semiring fixpoints; the "
            "collapse of a combined candidate is only sound there — use "
            "run_pagerank_stacked for counted sum-semiring rounds")
    dev = resolve_device(device)
    if arrays is None:
        arrays = device_arrays(part, dev)
    with obs.span("engine.init", track="app"):
        val = torch.as_tensor(init_val, dtype=torch.float32, device=dev)
        if init_changed is not None:
            chg = torch.as_tensor(init_changed, dtype=torch.bool,
                                  device=dev) & arrays.slot_valid
        else:
            chg = sem.improved(val, torch.full_like(val, sem.identity)) \
                & arrays.slot_valid
    if cfg.wants_device_worklist:
        S, R_max = part.S, part.R_max

        def window(k, state):
            val, chg, counts, ent = exchange.fixpoint_window_stacked(
                sem, arrays, cfg, S, R_max, k, *state)
            return (val, chg), counts, ent, chg

        (val, _), stats = _run_device_windows(
            sem.name, part, arrays, cfg, cfg.max_iters, window, (val, chg),
            chg)
    else:
        def round_fn(state, wl):
            val, chg, mc = exchange.fixpoint_round_stacked(
                sem, arrays, cfg, part.S, part.R_max, *state, worklist=wl)
            return (val, chg), chg, mc

        (val, _), stats = _run_host_rounds(
            sem.name, part, arrays, cfg, cfg.max_iters, round_fn,
            (val, chg), chg)
    if cfg.collapse == "deferred":
        val = exchange.collapse(sem, val.reshape(-1), arrays.sibling_flat,
                                arrays.sibling_mask)
    return val, stats


def _run_host_rounds(run, part, arrays, cfg, max_rounds, round_fn, state,
                     chg):
    """The host-driven round loop shared by the fixpoint and
    delta-PageRank runners: test the frontier, plan a worklist when the
    config asks ('worklist' / 'auto'), run ``round_fn(state, worklist)``
    -> (state, next frontier, message count).  With no planner and no
    recorder the frontier test reads one flag; otherwise the frontier
    comes to the host once per round, for the plan and the accounting
    alike (a recorder that records spans alone changes nothing here).
    Returns (state, ``RunStats``)."""
    rec = obs.round_recorder()
    planner = (launch_planner(part, cfg)
               if cfg.wants_worklist or (rec is not None and cfg.use_pallas)
               else None)
    on_host = planner is not None or rec is not None
    dev = chg.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    msgs = work_total = pruned = zero
    it = syncs = 0
    while it < max_rounds:
        syncs += 1
        if on_host:
            gchg = chg.reshape(-1).cpu().numpy()
            if not gchg.any():
                break
        elif not bool(chg.any()):
            break
        wl = info = None
        if cfg.wants_worklist:
            wl, info = plan_round_worklist(planner, cfg, gchg,
                                           with_info=True)
        if rec is not None:
            frontier = int(gchg.sum())
            t0 = rec.tracer.now()
            span = rec.tracer.span("round", track=f"engine/{run}",
                                   round=it + 1)
        state, chg, mc = round_fn(state, wl)
        mc = mc.to(torch.int64)
        work = chg.sum()
        it += 1
        msgs = msgs + mc
        work_total = work_total + work
        pruned = pruned + mc - torch.minimum(work, mc)
        if rec is not None:
            mc_h, work_h = int(mc), int(work)
            wall = rec.tracer.now() - t0
            span.end(frontier=frontier, messages=mc_h)
            _obs_record_round(rec, run, part, cfg, planner, it, gchg,
                              frontier, mc_h, work_h, wl, info, wall)
    _count_dispatches(run, it, syncs)
    it_t = torch.tensor(it, dtype=torch.int64, device=dev)
    return state, RunStats(iterations=it_t, messages=msgs,
                           work_actions=work_total, pruned_actions=pruned,
                           diffusions=work_total)


def _fetch(*tensors):
    """Copy several device tensors to the host in ONE transfer (their
    bytes concatenated); returns numpy arrays of their dtypes and
    shapes."""
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        n = t.numel() * dtype.itemsize
        out.append(flat[at:at + n].view(dtype).reshape(tuple(t.shape)))
        at += n
    return out


def _window_totals(counts_h, sizes):
    """Accounting of one window from its per-round message counts and
    frontier sizes (``sizes[r]`` entering round r, ``sizes[k]`` at exit):
    rounds whose entering frontier is empty ran as no-ops and count as
    zero rounds, matching the host loop's early exit.  Returns
    (live_rounds, messages, work, pruned)."""
    live = msgs = work = pruned = 0
    for r in range(counts_h.shape[0]):
        if sizes[r] == 0:
            break
        mc, wk = int(counts_h[r]), int(sizes[r + 1])
        live += 1
        msgs += mc
        work += wk
        pruned += mc - min(wk, mc)
    return live, msgs, work, pruned


def _record_device_window(rec, run, part, planner, l_pad, window, it_end,
                          ent, totals, wall):
    """One per-window flight-recorder ``RoundRecord``, recomputed from
    the window's frontier trajectory ``ent`` ((k+1, V) bool: the frontier
    entering each round, then the exit frontier): cells and shard
    messages summed over the live rounds, so window sums equal the
    host-driven per-round totals.  ``launched`` is the port's static
    device-worklist length times the live rounds.  A tiled device plan
    stages the dense launch's rows, which is the dense mirror's count."""
    live, msgs, work, pruned = totals
    cells = tile_dmas = dma_bytes = 0
    shard_sum = None
    for r in range(live):
        d = planner.dense_mirror(ent[r])
        cells += d["cells"]
        tile_dmas += d["staged_rows"]
        dma_bytes += d["staged_bytes"]
        sh = np.asarray(exchange.shard_message_mirror(
            part.edge_mask, part.edge_src_root_flat, ent[r]))
        shard_sum = sh if shard_sum is None else shard_sum + sh
    rec.add_round(
        obs.RoundRecord(
            run=run, round=it_end, frontier=int(ent[0].sum()),
            messages=msgs, work=work, pruned=pruned,
            grid="device_worklist", path=planner.path, cells=cells,
            launched=l_pad * live, tile_dmas=tile_dmas,
            dma_bytes=dma_bytes, wall_s=wall,
            shard_messages=([int(x) for x in shard_sum]
                            if shard_sum is not None else None),
            window=window),
        frontier_bitmap=ent[0].copy() if rec.keep_frontiers else None)


def _run_device_windows(run, part, arrays, cfg, max_rounds, window, state,
                        chg):
    """The device_worklist loop: windows of ``cfg.device_window`` rounds,
    each enqueued by ``window(k, state)`` -> (state, (k,) counts, (k, ...)
    entering frontiers, exit frontier) with no host sync inside, then
    ONE host read of the per-round counts and frontier sizes (the whole
    frontiers too when a round-accounting flight recorder is installed,
    which gets one ``RoundRecord`` per window).  Each window is an
    ``engine.window`` span, its read an ``engine.read``.  The first
    window is enqueued without looking at the initial frontier: an empty
    one gives dead rounds, which are no-ops.  Returns (state,
    ``RunStats``)."""
    rec = obs.get_recorder()
    acct = rec if rec is not None and rec.round_accounting else None
    planner = launch_planner(part, cfg) if acct is not None else None
    l_pad = (frr.device_worklist_pad(arrays.launch_plan(cfg))
             if acct is not None else 0)
    it = msgs = work_total = pruned = windows = 0
    live_exit = True
    while it < max_rounds and live_exit:
        k = min(cfg.device_window, max_rounds - it)
        windows += 1
        if rec is not None:
            t0 = rec.tracer.now()
            span = rec.tracer.span("engine.window", track=f"engine/{run}",
                                   window=windows)
        state, counts, ent, chg = window(k, state)
        ent = torch.cat([ent.reshape(k, -1), chg.reshape(1, -1)])
        with obs.span("engine.read", track=f"engine/{run}"):
            if acct is not None:
                counts_h, ent_h = _fetch(counts, ent)
                sizes = ent_h.sum(axis=1)
            else:
                counts_h, sizes = _fetch(counts, ent.sum(dim=1))
        totals = _window_totals(counts_h, sizes)
        live = totals[0]
        if acct is not None and live:
            _record_device_window(acct, run, part, planner, l_pad, windows,
                                  it + live, ent_h, totals,
                                  acct.tracer.now() - t0)
        if rec is not None:
            span.end(frontier=int(sizes[0]), messages=totals[1],
                     rounds=live)
        it += live
        msgs += totals[1]
        work_total += totals[2]
        pruned += totals[3]
        live_exit = bool(sizes[k])
    _count_dispatches(run, windows, windows)
    mk = lambda x: torch.tensor(x, dtype=torch.int64, device=chg.device)  # noqa: E731,E501
    return state, RunStats(iterations=mk(it), messages=mk(msgs),
                           work_actions=mk(work_total),
                           pruned_actions=mk(pruned),
                           diffusions=mk(work_total))


def _host_stats(it, msgs, work, pruned, device=None) -> RunStats:
    """``RunStats`` of host-side totals, as int64 tensors on ``device``
    (the resilient runner's accounting)."""
    mk = lambda x: torch.tensor(x, dtype=torch.int64, device=device)  # noqa: E731,E501
    return RunStats(iterations=mk(it), messages=mk(msgs),
                    work_actions=mk(work), pruned_actions=mk(pruned),
                    diffusions=mk(work))


def _count_dispatches(run: str, dispatches: int, host_syncs: int):
    """Registry accounting for the dispatch/host-sync columns: batches
    of launches a fixpoint enqueued (a round each on host-driven loops, a
    window each under 'device_worklist') and the device→host sync points
    (frontier tests, window reads) it paid."""
    m = obs.registry()
    m.counter(
        "engine_dispatches_total",
        "dispatches issued by engine fixpoint loops"
    ).labels(run=run).inc(dispatches)
    m.counter(
        "engine_host_syncs_total",
        "device->host sync points paid by engine fixpoint loops"
    ).labels(run=run).inc(host_syncs)


# --------------------------------------------------------------------------
# PageRank-style counted-iteration apps
# --------------------------------------------------------------------------

def run_pagerank_stacked(part: Partition, damping: float, iters: int,
                         cfg: EngineConfig = EngineConfig(), device=None):
    """``iters`` dense PageRank rounds on the stacked layout, on the
    partition's resident tables (``device_arrays``); returns the
    (S, R_max) scores on ``device``."""
    from repro_torch.core.actions import PAGERANK as sem

    dev = resolve_device(device)
    arrays = device_arrays(part, dev)
    base = (1.0 - damping) / part.n
    with obs.span("engine.init", track="app"):
        # initial score 1/n on every replica (consistent view)
        val = torch.where(arrays.slot_valid, 1.0 / part.n, 0.0)
    chg = arrays.slot_valid  # PR predicate is #t — always diffuse
    with obs.span("engine.iterations", track="engine/pagerank",
                  iters=iters):
        for _ in range(iters):
            val, _ = exchange.pagerank_round_stacked(
                sem, arrays, cfg, part.S, part.R_max, base, damping, val,
                chg)
    return val


def _tol_table(part: Partition, tol, device):
    """Per-slot residual tolerance: a scalar passes through as a 0-d
    float32 tensor; an (n,) per-vertex array maps every replica of vertex
    v to ``tol[v]`` (invalid slots get +inf — they never diffuse)."""
    tol_arr = np.asarray(tol, np.float32)
    if tol_arr.ndim == 0:
        return torch.tensor(float(tol_arr), dtype=torch.float32,
                            device=device)
    if tol_arr.shape != (part.n,):
        raise ValueError(
            f"per-vertex tol must be shape ({part.n},); got {tol_arr.shape}")
    sv = np.asarray(part.slot_vertex)
    table = np.where(sv >= 0, tol_arr[np.maximum(sv, 0)], np.inf)
    return torch.as_tensor(table.astype(np.float32), device=device)


def run_pagerank_delta(part: Partition, damping: float = 0.85,
                       tol=1e-6, cfg: EngineConfig = EngineConfig(),
                       max_rounds: int = 256,
                       init_rank=None, init_delta=None, device=None,
                       arrays=None):
    """Stacked **delta-PageRank**: push-based residual propagation with
    per-vertex pruning.

    Ranks accumulate the Neumann series ``Σ_k (d·Aᵀ)^k base`` — the same
    fixpoint the dense power iteration converges to — but each round
    diffuses only residual deltas above ``tol`` (scalar or (n,)
    per-vertex), so the frontier shrinks as residuals decay and the
    kernels' chunk skip and worklist launches fire for the sum semiring.

    Host-driven under 'dense' / 'worklist' / 'auto' (the frontier test
    and any planning read the frontier each round); windows of
    ``cfg.device_window`` rounds under 'device_worklist'.  Returns
    ((S, R_max) ranks, RunStats: messages delivered, slots whose residual
    stayed live (work), deliveries pruned below tolerance).
    ``init_rank`` / ``init_delta`` warm-start the accumulation;
    ``arrays`` as in ``run_stacked``."""
    from repro_torch.core.actions import PAGERANK as sem

    dev = resolve_device(device)
    if arrays is None:
        arrays = device_arrays(part, dev)
    S, R_max = part.S, part.R_max
    base = (1.0 - damping) / part.n
    tol_t = _tol_table(part, tol, dev)
    if init_rank is None:
        rank = delta = torch.where(arrays.slot_valid, base, 0.0)
    else:
        rank = torch.as_tensor(init_rank, dtype=torch.float32, device=dev)
        delta = torch.as_tensor(init_delta, dtype=torch.float32, device=dev)
    chg = (delta.abs() > tol_t) & arrays.slot_valid
    if cfg.wants_device_worklist:
        def window(k, state):
            rank, delta, chg, counts, ent = \
                exchange.delta_pagerank_window_stacked(
                    sem, arrays, cfg, S, R_max, k, damping, tol_t, *state)
            return (rank, delta), counts, ent, chg

        (rank, _), stats = _run_device_windows(
            "pagerank_delta", part, arrays, cfg, max_rounds, window,
            (rank, delta), chg)
        return rank, stats

    def round_fn(state, wl):
        rank, delta, chg, mc = exchange.delta_pagerank_round_stacked(
            sem, arrays, cfg, S, R_max, damping, tol_t, *state, worklist=wl)
        return (rank, delta), chg, mc

    (rank, _), stats = _run_host_rounds(
        "pagerank_delta", part, arrays, cfg, max_rounds, round_fn,
        (rank, delta), chg)
    return rank, stats


def init_values(part: Partition, sem: Semiring, sources: dict[int, float]):
    """(S, R_max) initial values: semiring identity everywhere except all
    replicas of each source vertex (consistent initial view)."""
    val = np.full((part.S, part.R_max), sem.identity, dtype=np.float32)
    if sem.segment == "sum":
        val[:] = 0.0
    for v, x in sources.items():
        s0, sl0 = divmod(int(part.root_flat[v]), part.R_max)
        for k in range(part.cfg.rpvo_max):
            if part.sibling_mask[s0, sl0, k]:
                f = int(part.sibling_flat[s0, sl0, k])
                val[f // part.R_max, f % part.R_max] = x
    return val


def vertex_values(part: Partition, val) -> np.ndarray:
    """Extract the per-vertex (root-replica) values as numpy."""
    gval = torch.as_tensor(val).detach().reshape(-1).cpu().numpy()
    return gval[part.root_flat]


# --------------------------------------------------------------------------
# sharded execution: one shard a process over torch.distributed
# --------------------------------------------------------------------------
# The reference runs ``shard_map`` from one controller; here every rank
# makes the same call with the same arguments (SPMD), uploads only its
# own shard (``DeviceArrays.from_partition(part, shard=r)``: its rows and
# its own launch plan) and runs one round per Python iteration over real
# collectives (``exchange.collectives``).  Each round ends in ONE
# all-reduce of [messages, work, any-changed], read to the host: the
# round's one host sync.  Every rank returns the all-gathered (S, R_max)
# table and the same all-reduced totals, so ``vertex_values`` and the
# apps read a sharded run as they read a stacked one.

_SHARDED_GRID_WARNED: set = set()


def _sharded_cfg(cfg: EngineConfig, where: str) -> EngineConfig:
    """A sharded round plans no host worklist (the reference's traced
    collective loop cannot run one): ``grid_mode='worklist'|'auto'``
    warns once per call site and runs as ``'device_worklist'`` — the
    same sparse launch, its list compacted on the device."""
    if cfg.grid_mode in ("worklist", "auto") and cfg.use_pallas \
            and cfg.pallas_mode == "fused":
        if where not in _SHARDED_GRID_WARNED:
            _SHARDED_GRID_WARNED.add(where)
            warnings.warn(
                f"{where}: grid_mode={cfg.grid_mode!r} needs a host-planned "
                "worklist, which a sharded round does not plan; routing to "
                "grid_mode='device_worklist' (the same sparse launch, "
                "compacted on the device)", stacklevel=3)
        return dataclasses.replace(cfg, grid_mode="device_worklist")
    return cfg


def shard_group(S: int, mesh, axis_names=("data", "model")):
    """This rank's ``collectives.ShardGroup`` on ``mesh``; raises
    ``ValueError`` unless the axes hold exactly ``S`` ranks (one shard a
    rank, as the reference requires)."""
    sg = exchange.collectives.shard_group(mesh, axis_names)
    if sg.size != S:
        raise ValueError(
            f"mesh axes {exchange.axis_tuple(axis_names)} hold {sg.size} "
            f"ranks; the partition has {S} shards (one shard a rank)")
    return sg


def shard_rows(x, sg, device, dtype) -> torch.Tensor:
    """This shard's rows of a full (S, ...) table (an array or a tensor)
    as a (1, ...) tensor on ``device``."""
    r = sg.rank
    if isinstance(x, torch.Tensor):
        t = x[r:r + 1]
    else:
        t = torch.as_tensor(np.ascontiguousarray(np.asarray(x)[r:r + 1]))
    return t.to(device=device, dtype=dtype)


def shard_arrays(part: Partition, sg, device=None, arrays=None):
    """This shard's ``DeviceArrays`` (``arrays`` when given)."""
    if arrays is None:
        arrays = DeviceArrays.from_partition(part, device, shard=sg.rank)
    return arrays


def shard_round(round_fn, state, sg):
    """One sharded round's device part: ``round_fn(state)`` -> (state,
    next frontier, this shard's message count), closed by ONE all-reduce
    of [messages, work, any-changed].  Returns (state, frontier, the
    (3,) int64 totals, not read to the host)."""
    state, chg, mc = round_fn(state)
    tot = exchange.collectives.psum(torch.stack(
        [mc.to(torch.int64).reshape(()), chg.sum().to(torch.int64),
         chg.any().to(torch.int64)]), sg)
    return state, chg, tot


def _run_shard_rounds(run, sg, max_rounds, round_fn, state, chg):
    """The sharded round loop: one all-reduce of the initial frontier's
    liveness, then a ``shard_round`` per iteration, its totals read to
    the host.  Returns (state, ``RunStats`` of the all-reduced
    totals)."""
    psum = exchange.collectives.psum
    dev = chg.device
    live = int(psum(chg.any().to(torch.int64).reshape(1), sg)[0]) > 0
    it = msgs = work_total = pruned = 0
    syncs = 1
    while live and it < max_rounds:
        state, chg, tot = shard_round(round_fn, state, sg)
        mc, work, anyc = tot.tolist()
        syncs += 1
        it += 1
        msgs += mc
        work_total += work
        pruned += mc - min(work, mc)
        live = anyc > 0
    _count_dispatches(run, it, syncs)
    return state, _host_stats(it, msgs, work_total, pruned, dev)


def shard_fixpoint_step(sem: Semiring, arrays, cfg: EngineConfig, S: int,
                        R_max: int, sg):
    """The sharded min fixpoint's round as ``shard_round`` drives it:
    state (val, chg) -> (state, next frontier, this shard's message
    count), over ``exchange.make_shard_fixpoint_round``."""
    round_fn = exchange.make_shard_fixpoint_round(sem, arrays, cfg, S,
                                                  R_max, sg)

    def step(state):
        val, chg, mc = round_fn(*state)
        return (val, chg), chg, mc

    return step


def make_sharded_fn(sem: Semiring, S: int, R_max: int, mesh,
                    axis_names=("data", "model"),
                    cfg: EngineConfig = EngineConfig()):
    """The sharded min fixpoint as ``(fn, group)``: ``fn(arrays, val)``
    takes this rank's shard (``DeviceArrays.from_partition(part,
    shard=group.rank)``, (1, R_max) values) and returns its (1, R_max)
    fixpoint values and the all-reduced ``RunStats``; ``group`` is the
    shards' ``collectives.ShardGroup`` (the reference returns its
    ``NamedSharding`` here)."""
    if sem.segment != "min":
        raise ValueError(
            "make_sharded_fn drives monotone min-semiring fixpoints; use "
            "make_sharded_pagerank_fn for counted sum-semiring rounds")
    cfg = _sharded_cfg(cfg, "make_sharded_fn")
    sg = shard_group(S, mesh, axis_names)

    def fn(arrays, val):
        chg = sem.improved(val, torch.full_like(val, sem.identity)) \
            & arrays.slot_valid
        (val, _), stats = _run_shard_rounds(
            f"{sem.name}_sharded", sg, cfg.max_iters,
            shard_fixpoint_step(sem, arrays, cfg, S, R_max, sg), (val, chg),
            chg)
        if cfg.collapse == "deferred":
            val = exchange.collapse(sem, exchange.shard_gather(val, sg),
                                    arrays.sibling_flat, arrays.sibling_mask)
        return val, stats

    return fn, sg


def run_sharded(sem: Semiring, part: Partition, init_val, mesh,
                axis_names=("data", "model"),
                cfg: EngineConfig = EngineConfig(), device=None,
                arrays=None):
    """Sharded execution: the leading (shard) dim of every table is split
    over ``axis_names`` of ``mesh``, whose ranks there must number
    ``part.S``.  Every rank calls it with the same arguments (the full
    (S, R_max) ``init_val``); each runs its shard and returns the
    all-gathered (S, R_max) values and the all-reduced ``RunStats``.
    ``arrays``: this rank's ``DeviceArrays.from_partition(part,
    shard=rank)`` when uploaded already."""
    fn, sg = make_sharded_fn(sem, part.S, part.R_max, mesh, axis_names, cfg)
    dev = resolve_device(device)
    arrays = shard_arrays(part, sg, dev, arrays)
    val, stats = fn(arrays, shard_rows(init_val, sg, dev, torch.float32))
    return exchange.collectives.all_gather(val, sg), stats


def make_sharded_pagerank_fn(S: int, R_max: int, n: int, damping: float,
                             iters: int, mesh, axis_names=("data", "model"),
                             cfg: EngineConfig = EngineConfig()):
    """Sharded PageRank as ``(fn, group)``: ``fn(arrays)`` runs ``iters``
    rounds of relax → exchange → rhizome-collapse(+) → damping update on
    this rank's shard and returns its (1, R_max) scores."""
    from repro_torch.core.actions import PAGERANK as sem

    cfg = _sharded_cfg(cfg, "make_sharded_pagerank_fn")
    sg = shard_group(S, mesh, axis_names)
    base = (1.0 - damping) / n

    def fn(arrays):
        sv = arrays.slot_valid
        gchg = exchange.shard_gather(sv, sg)   # PR predicate is #t
        val = torch.where(sv, 1.0 / n, 0.0)
        for _ in range(iters):
            total_in, _ = exchange.shard_total_in(
                sem, arrays, cfg, S, R_max, sg,
                exchange.shard_gather(val, sg), gchg)
            val = torch.where(sv, base + damping * total_in, 0.0)
        return val

    return fn, sg


def run_pagerank_sharded(part: Partition, damping: float, iters: int, mesh,
                         axis_names=("data", "model"),
                         cfg: EngineConfig = EngineConfig(), device=None):
    """Sharded PageRank; layout and call form as in ``run_sharded``.
    Returns the all-gathered (S, R_max) scores."""
    fn, sg = make_sharded_pagerank_fn(part.S, part.R_max, part.n, damping,
                                      iters, mesh, axis_names, cfg)
    arrays = shard_arrays(part, sg, resolve_device(device))
    return exchange.collectives.all_gather(fn(arrays), sg)


def make_sharded_pagerank_delta_fn(S: int, R_max: int, damping: float,
                                   tol: float, mesh,
                                   axis_names=("data", "model"),
                                   cfg: EngineConfig = EngineConfig()):
    """One sharded delta-PageRank round as ``(fn, group)``: ``fn(arrays,
    rank, delta)`` -> (rank, delta, message count, live-slot count), the
    tables this shard's (1, R_max) and both counts summed over the shards
    by one all-reduce.  Host-planned worklist modes run as
    ``device_worklist`` (``_sharded_cfg``)."""
    from repro_torch.core.actions import PAGERANK as sem

    cfg = _sharded_cfg(cfg, "make_sharded_pagerank_delta_fn")
    sg = shard_group(S, mesh, axis_names)

    def fn(arrays, rank, delta):
        rank, delta, chg, counts = exchange.delta_pagerank_round_shard(
            sem, arrays, cfg, S, R_max, sg, damping, tol, rank, delta)
        tot = exchange.collectives.psum(torch.stack(
            [counts.to(torch.int64).reshape(()), chg.sum()]), sg)
        return rank, delta, tot[0], tot[1]

    return fn, sg


def run_pagerank_delta_sharded(part: Partition, damping: float = 0.85,
                               tol: float = 1e-6, mesh=None,
                               axis_names=("data", "model"),
                               cfg: EngineConfig = EngineConfig(),
                               max_rounds: int = 256, init_rank=None,
                               init_delta=None, device=None, arrays=None):
    """Sharded delta-PageRank (a host-driven round loop over real
    collectives); layout and call form as in ``run_sharded``.  Scalar
    ``tol`` only.  A round's message and live-slot counts come back in
    one read; with a flight recorder installed each round also gathers
    the frontier for the per-shard message mirror, and shard 0 records
    the round (run ``pagerank_delta_sharded``).  Returns the all-gathered
    (S, R_max) ranks and the all-reduced ``RunStats``."""
    if np.ndim(tol) != 0:
        raise ValueError("run_pagerank_delta_sharded takes a scalar tol")
    tol = float(tol)
    fn, sg = make_sharded_pagerank_delta_fn(part.S, part.R_max, damping, tol,
                                            mesh, axis_names, cfg)
    dev = resolve_device(device)
    arrays = shard_arrays(part, sg, dev, arrays)
    sv = arrays.slot_valid
    if init_rank is None:
        rank = delta = torch.where(sv, (1.0 - damping) / part.n, 0.0)
    else:
        rank = shard_rows(init_rank, sg, dev, torch.float32)
        delta = shard_rows(init_delta, sg, dev, torch.float32)
    rec = obs.round_recorder()
    rec_path = "torch"
    if cfg.use_pallas and cfg.pallas_mode == "fused":
        rec_path, _ = frr.select_kernel_path(
            part.S * part.R_max, 1, cfg.vmem_budget_bytes,
            smem_budget_bytes=cfg.smem_budget_bytes)
    elif cfg.use_pallas:
        rec_path = cfg.pallas_mode
    psum = exchange.collectives.psum
    live = int(psum(((delta.abs() > tol) & sv).any().to(torch.int64)
                    .reshape(1), sg)[0]) > 0
    it = msgs = work_total = pruned = 0
    syncs = 1
    while live and it < max_rounds:
        if rec is not None:
            # recorder-only frontier gather: the per-shard message mirror
            # reads the whole live-residual bitmap on the host
            gchg = exchange.shard_gather((delta.abs() > tol) & sv, sg) \
                .cpu().numpy()
            frontier = int(gchg.sum())
            t0 = rec.tracer.now()
            span = rec.tracer.span(
                "round", track="engine/pagerank_delta_sharded",
                round=it + 1)
        rank, delta, counts, work = fn(arrays, rank, delta)
        mc, w = torch.stack([counts, work]).tolist()
        syncs += 1
        it += 1
        msgs += mc
        work_total += w
        pruned += mc - min(w, mc)
        live = w > 0
        if rec is not None:
            wall = rec.tracer.now() - t0
            span.end(frontier=frontier, messages=mc)
            if sg.rank == 0:
                shard = exchange.shard_message_mirror(
                    part.edge_mask, part.edge_src_root_flat, gchg)
                rec.add_round(
                    obs.RoundRecord(
                        run="pagerank_delta_sharded", round=it,
                        frontier=frontier, messages=mc, work=w,
                        pruned=mc - min(w, mc), grid="dense", path=rec_path,
                        cells=0, launched=0, tile_dmas=0, dma_bytes=0,
                        wall_s=wall, shard_messages=[int(x) for x in shard]),
                    frontier_bitmap=gchg.copy() if rec.keep_frontiers
                    else None)
    _count_dispatches("pagerank_delta_sharded", it, syncs)
    return (exchange.collectives.all_gather(rank, sg),
            _host_stats(it, msgs, work_total, pruned, dev))
