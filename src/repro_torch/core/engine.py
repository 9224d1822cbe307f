"""Diffusive fixpoint engine (paper §4–§5) in PyTorch.

The paper's asynchronous message-driven execution is re-expressed as bulk
edge-parallel relaxation rounds whose fixpoint equals the asynchronous
fixpoint (monotone semirings ⇒ order-free). One round is the diffuse-queue
drain: diffusions generated in round k are evaluated in round k+1 against
the newest vertex state, so stale diffusions are *subsumed* exactly as the
paper's lazy-diffuse pruning does.

The per-round math — relax, dense exchange, rhizome collapse — lives in
the exchange layer (``repro_torch.exchange``); this module runs the
rounds: it owns the fixpoint loop, the termination check and the Fig-6
stats bookkeeping.  ``run_stacked`` keeps all shards stacked ``(S, …)``
on one device.

With ``EngineConfig.use_pallas`` the relax phase of every round is one
launch of the hand-written fused kernel
(``kernels.fused_relax_reduce``) on a CUDA device; without it the same
math runs as separate torch ops — the oracle path.

Entry points take ``device``: ``None`` means ``"cuda"`` and raises when
CUDA is absent; pass ``device="cpu"`` to run on the CPU, where the fused
path runs its kernel's plain version.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch import exchange, obs
from repro_torch.core.actions import Semiring
from repro_torch.core.partition import Partition
from repro_torch.kernels import fused_relax_reduce as frr


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine options, with the reference's fields, defaults and checks.

    Paths this port has not reached raise ``NotImplementedError`` when a
    run would take them: ``exchange='compact'``, ``pallas_mode='reduce'``
    and a ``grid_mode`` other than ``'dense'`` under ``use_pallas``.
    ``vmem_budget_bytes``, ``smem_budget_bytes``, ``device_window`` and
    ``checkpoint_every`` are validated but not acted on yet: the CUDA
    kernel reads the value table from device memory at any size."""

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
    # fused-kernel launch shape: 'dense' | 'worklist' | 'auto' |
    # 'device_worklist'
    grid_mode: str = "dense"
    # rounds per dispatch window of a device-resident loop
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


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, and raises when CUDA is absent: the engine
    never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class DeviceArrays(typing.NamedTuple):
    """Static per-shard tensors, stacked with leading dim S, plus the
    fused kernel's launch plan over the flattened dense edge stack."""

    edge_src_root_flat: torch.Tensor  # (S, E_max) int32
    edge_dst_flat: torch.Tensor       # (S, E_max) int32 (sorted per shard)
    edge_w: torch.Tensor              # (S, E_max) f32
    edge_mask: torch.Tensor           # (S, E_max) bool
    sibling_flat: torch.Tensor        # (S, R_max, K) int32
    sibling_mask: torch.Tensor        # (S, R_max, K) bool
    slot_valid: torch.Tensor          # (S, R_max) bool
    fused_plan: frr.LaunchPlan        # block -> edge-chunk lists

    @classmethod
    def from_partition(cls, part: Partition, device=None) -> "DeviceArrays":
        dev = resolve_device(device)

        def put(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x)).to(
                device=dev, dtype=dtype)

        src = put(part.edge_src_root_flat, torch.int32)
        dst = put(part.edge_dst_flat, torch.int32)
        mask = put(part.edge_mask, torch.bool)
        plan = frr.plan_launch(src.reshape(-1), mask.reshape(-1),
                               dst.reshape(-1), part.S * part.R_max,
                               part.S * part.R_max)
        return cls(
            edge_src_root_flat=src,
            edge_dst_flat=dst,
            edge_w=put(part.edge_w, torch.float32),
            edge_mask=mask,
            sibling_flat=put(part.sibling_flat, torch.int32),
            sibling_mask=put(part.sibling_mask, torch.bool),
            slot_valid=put(part.slot_vertex >= 0, torch.bool),
            fused_plan=plan,
        )


class RunStats(typing.NamedTuple):
    iterations: torch.Tensor        # rounds executed
    messages: torch.Tensor          # actions delivered (edge messages)
    work_actions: torch.Tensor      # predicate-true slot updates
    pruned_actions: torch.Tensor    # delivered but predicate-false
    diffusions: torch.Tensor        # slots that diffused (entered the frontier)


def _obs_record_round(rec, run, part, cfg, rnd, gchg, frontier, mc, work,
                      wall_s):
    """Build + store one flight-recorder ``RoundRecord``: the cell
    columns come from the host mirror of the fused launch this round made
    (``frr.fused_grid_cells``: ``cells`` the (block, chunk) cells the
    kernel executes, ``launched`` the cells its blocks walk), plus the
    per-shard message-volume mirror feeding the skew gauge.  Only ever
    called with a recorder installed."""
    if cfg.use_pallas:
        path = "fused"
        m = frr.fused_grid_cells(part.edge_dst_flat, part.edge_mask,
                                 part.edge_src_root_flat, gchg,
                                 part.S * part.R_max)
        cells, launched = m["fused_live"], m["launch_cells"]
    else:
        path = "torch"
        cells = launched = 0
    shard = exchange.shard_message_mirror(
        part.edge_mask, part.edge_src_root_flat, gchg)
    rec.add_round(
        obs.RoundRecord(
            run=run, round=rnd, frontier=frontier, messages=mc, work=work,
            pruned=mc - min(work, mc), grid="dense", path=path, cells=cells,
            launched=launched, tile_dmas=0, dma_bytes=0, wall_s=wall_s,
            shard_messages=[int(x) for x in shard]),
        frontier_bitmap=gchg.copy() if rec.keep_frontiers else None)


# --------------------------------------------------------------------------
# fixpoint apps (BFS / SSSP)
# --------------------------------------------------------------------------

def run_stacked(sem: Semiring, part: Partition, init_val,
                cfg: EngineConfig = EngineConfig(), init_changed=None,
                device=None):
    """Single-device stacked execution. ``init_val``: (S, R_max) float32.
    ``init_changed`` (optional bool (S, R_max)) seeds the first frontier —
    used by incremental recompute to re-diffuse only mutation sites.

    The fixpoint is a Python loop over rounds: each round is one batch of
    eager launches, and the loop pays one host sync per round to test
    the frontier (``engine_dispatches_total`` / ``engine_host_syncs_total``
    count exactly that).  Returns ((S, R_max) values, ``RunStats``) as
    tensors on ``device``."""
    if sem.segment != "min":
        raise ValueError(
            "run_stacked drives monotone min-semiring fixpoints; the "
            "collapse of a combined candidate is only sound there — use "
            "run_pagerank_stacked for counted sum-semiring rounds")
    exchange.check_ported(cfg)
    dev = resolve_device(device)
    arrays = DeviceArrays.from_partition(part, dev)
    S, R_max = part.S, part.R_max
    rec = obs.get_recorder()

    val = torch.as_tensor(init_val, dtype=torch.float32, device=dev)
    if init_changed is not None:
        chg = torch.as_tensor(init_changed, dtype=torch.bool, device=dev) \
            & arrays.slot_valid
    else:
        chg = sem.improved(val, torch.full_like(val, sem.identity)) \
            & arrays.slot_valid
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    msgs = work_total = pruned = zero
    it = syncs = 0
    while it < cfg.max_iters:
        syncs += 1
        if not bool(chg.any()):
            break
        if rec is not None:
            gchg = chg.reshape(-1).cpu().numpy()
            frontier = int(gchg.sum())
            t0 = rec.tracer.now()
            span = rec.tracer.span("round", track=f"engine/{sem.name}",
                                   round=it + 1)
        val, chg, mc = exchange.fixpoint_round_stacked(
            sem, arrays, cfg, S, R_max, val, chg)
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
            _obs_record_round(rec, sem.name, part, cfg, it, gchg, frontier,
                              mc_h, work_h, wall)
    _count_dispatches(sem.name, it, syncs)
    stats = RunStats(iterations=torch.tensor(it, dtype=torch.int64,
                                             device=dev),
                     messages=msgs, work_actions=work_total,
                     pruned_actions=pruned, diffusions=work_total)
    if cfg.collapse == "deferred":
        val = exchange.collapse(sem, val.reshape(-1), arrays.sibling_flat,
                                arrays.sibling_mask)
    return val, stats


def _count_dispatches(run: str, dispatches: int, host_syncs: int):
    """Registry accounting for the dispatch/host-sync columns: rounds
    dispatched (one batch of eager launches each) and device→host sync
    points (frontier tests) that a fixpoint paid."""
    m = obs.registry()
    m.counter(
        "engine_dispatches_total",
        "dispatches issued by engine fixpoint loops"
    ).labels(run=run).inc(dispatches)
    m.counter(
        "engine_host_syncs_total",
        "device->host sync points paid by engine fixpoint loops"
    ).labels(run=run).inc(host_syncs)


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
