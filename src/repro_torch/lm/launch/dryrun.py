"""Multi-pod dry run: trace one step of every (architecture × input
shape) cell for the 16×16 single-pod mesh AND the 2×16×16 multi-pod
mesh, on fake tensors over a fake process group, and count what one
rank runs: its FLOPs, its memory traffic, its collective payload bytes
by kind and its memory (fits?) — the §Roofline inputs.  The port's
counterpart of the reference's lower + compile + ``memory_analysis()`` /
``cost_analysis()`` / HLO parse; ``parse_collective_bytes`` is kept for
HLO text the reference wrote.

A cell's trace, in one process: a ``fake`` default process group of 256
(512) ranks, the production mesh over it (``lm.launch.mesh``), the model
built under ``FakeTensorMode`` with its ``DTensor`` placements, and one
step run as rank 0 — ``make_train_step`` for ``train`` cells,
``Model.prefill`` for ``prefill``, ``Model.decode_step`` for
``decode``.  No tensor holds data and no collective moves any; shapes,
dtypes and every op rank 0 issues are real.

What is counted, by one dispatch mode over rank 0's LOCAL ops (each
``DTensor`` op is seen as the local ops and collectives it runs; its
sharding propagation, which runs the op again at the global shape, runs
outside the mode and is not counted):

* ``flops``: products and convolutions, by ``torch.utils.flop_counter``'s
  formulas on the local shapes;
* ``bytes_accessed``: operand bytes plus result bytes of every op that
  is not a view.  Eager PyTorch fuses nothing, so this is the traffic
  of the ops as issued, an upper bound that reads higher than the
  reference's post-fusion HLO figure for the same step;
* ``collective_bytes``: by the reference's kind names, as result bytes
  (the HLO convention): the functional collectives ``DTensor`` issues
  and the c10d calls of ``exchange.collectives`` and the pipeline's
  point-to-point sends, each by the kind called (a point-to-point send
  or receive is a ``collective-permute`` of the bytes it carries).

A recurrence (Mamba's, the sLSTM's over time steps, the mLSTM's over
chunks: ``lm.models.scan.scan``) is counted as the reference's
``hlo_analysis`` counts a while loop of known trip count: its forward
and its backward each trace ONE trip, weighed by the trip count
(``_RankCounter.repeat``; every trip issues the same ops, so the counts
equal an unrolled trace's, ``trace(..., unroll=True)``), with its stacked
outputs and saved carries allocated at full size.  The layer loop and
the attention's chunks stay unrolled Python loops, counted as traced;
the graph cell traces ONE round of its data-dependent fixpoint loop.

Results are cached as JSON under ``results/dryrun_torch/`` (one file
per cell), each beside ``<tag>.trace.json.gz``, the per-op summary
``reanalyze`` reads.

Usage (fake CUDA tensors; ``--device cpu`` traces fake CPU tensors,
``--reduced`` takes each architecture's smoke-scale config on the
(2, 2) / (2, 2, 2) mesh it is sized for, ``--budget-s`` records a cell
whose trace passes that many seconds as failed):
  PYTHONPATH=src python -m repro_torch.lm.launch.dryrun --arch qwen3-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.lm.launch.dryrun --all [--multi-pod] [--graph]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import os
import re
import time
import traceback
import types
import typing

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core.engine import resolve_device
from repro_torch.lm.configs import ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.lm.configs.base import ModelConfig, ShapeSpec
from repro_torch.lm.launch import specs as SP
from repro_torch.lm.launch.mesh import (make_ctx, make_production_mesh,
                                        make_test_mesh)
from repro_torch.lm.models.model import Model
from repro_torch.lm.train.optimizer import AdamW, _leaves, cosine_schedule
from repro_torch.lm.train.train_step import (TrainState, batch_axes,
                                            cache_axes_tree, make_train_step)
from repro_torch.sharding.specs import (  # noqa: F401 (reference names)
    ShardCtx, is_dtensor, place, sharding_for)

# the checkout's results/dryrun_torch/ (the reference's path resolves
# under src/; benchmarks/ read results/dryrun/, which this never writes)
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "..", "results", "dryrun_torch")

# --- hardware constants (one NVIDIA H100 SXM5, NVIDIA's data sheet) -------
PEAK_FLOPS = 989.4e12        # dense bf16 / card
HBM_BW = 3.35e12             # B/s / card
# NVLink 4: 18 links of 25 GB/s each way, 450 GB/s each way (900 GB/s
# both ways together).  A rank's collective bytes are result bytes, what
# it receives, which arrive over the incoming direction alone: the
# per-direction rate bounds them.
ICI_BW = 450e9               # B/s / card, one direction

_DT_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
             "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
             "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

_COLL_RE = re.compile(
    r"=\s*([^=]*?)\s*(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(-start|-done)?\(")
_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|"
                       r"pred|f8e4m3fn|f8e5m2)\[([0-9,]*)\]")


def parse_collective_bytes(hlo_text: str) -> dict:
    """Sum result-shape bytes of every collective op, by kind."""
    out: dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m or (m.group(3) == "-done"):
            continue  # count -start (or plain), skip -done duplicates
        result_part, kind = m.group(1), m.group(2)
        nbytes = 0.0
        for dt, dims in _SHAPE_RE.findall(result_part):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DT_BYTES[dt]
        out[kind] = out.get(kind, 0.0) + nbytes
    out["total"] = float(sum(v for k, v in out.items() if k != "total"))
    return out


# Fields the port has no counterpart for, each with its reason.
NULL_REASONS = {
    "compile_s": "nothing is compiled: one step is traced on fake tensors",
    "xla_cost_raw": "no XLA cost analysis: the port's ops run eagerly",
    "memory.generated_code_size_bytes": "no generated program: eager ops",
    "per_device.num_whiles": "no while op: a recurrence's scan is "
                             "counted as one trip times its trip count, "
                             "other Python loops unrolled",
}

# collective op (namespace.name) -> the reference's kind
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}
# ops that move no bytes: allocation without a fill, waits, metadata
_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.empty_like",
               "aten.new_empty", "aten.new_empty_strided",
               "_c10d_functional.wait_tensor",
               "aten._local_scalar_dense", "aten.lift_fresh"}
# metadata queries, not counted at all: ``FakeTensorMode`` issues a
# varying number of them (more on a miss of its dispatch cache)
_UNCOUNTED = {"prim.device"}


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    """Bytes a tensor holds on this rank (a ``DTensor``: its shard)."""
    shape = SP.local_shape(t) if is_dtensor(t) else tuple(t.shape)
    return math.prod(shape) * t.element_size()


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


class _RankCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts every local op this rank issues: op -> [calls, FLOPs,
    bytes, collective kind, collective bytes], each weighed by
    ``weight``.  A ``DTensor`` op is handed on to ``DTensor`` (its local
    ops come back here).  Past ``deadline`` (a ``time.perf_counter``
    value) the next op raises ``TimeoutError``.  ``weighs_trips``: a
    ``scan`` under this counter runs one trip inside ``repeat(length)``
    (``unroll``: every trip, unweighed)."""

    def __init__(self, deadline: float | None = None, unroll: bool = False):
        super().__init__()
        self.ops: dict[str, list] = {}
        self.deadline = deadline
        self.weighs_trips = not unroll
        self.weight = 1

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Everything issued inside counts ``n`` times (``0``: not at
        all)."""
        w = self.weight
        self.weight = w * n
        try:
            yield
        finally:
            self.weight = w

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types_):
            return NotImplemented
        if self.deadline is not None and time.perf_counter() > self.deadline:
            raise TimeoutError(
                f"the trace passed its budget after "
                f"{sum(r[0] for r in self.ops.values())} ops")
        out = func(*args, **kwargs)
        name = str(func._overloadpacket)
        if name in _UNCOUNTED or not self.weight:
            return out
        row = self.ops.get(name)
        if row is None:
            row = self.ops[name] = [0, 0.0, 0.0, _COLLECTIVES.get(name), 0.0]
        w = self.weight
        row[0] += w
        fl = flop_registry.get(func._overloadpacket)
        if fl is not None:
            row[1] += w * float(fl(*args, **kwargs, out_val=out))
        if name in _NO_TRAFFIC or func.is_view:
            return out
        res = _tensors(out)
        row[2] += w * float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                            + sum(_nbytes(t) for t in res))
        if row[3] is not None:
            # result bytes: a c10d call writes its first argument
            got = _tensors(args[0]) if name.startswith("c10d.") else res
            row[4] += w * float(sum(_nbytes(t) for t in got))
        return out


@contextlib.contextmanager
def _outside_modes():
    """``DTensor``'s sharding propagation (which runs each op again at
    its global shape; the three entry points its dispatch calls in torch
    2.11 and 2.13) and its strided-shard offset arithmetic (which builds
    index tensors) run with every dispatch mode off: neither is rank 0's
    work, and a fake-tensor trace refuses the data-dependent index reads
    of the latter."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import placement_types

    def outside(fn):
        def call(*a, **k):
            with _disable_current_modes():
                return fn(*a, **k)
        return call

    prop = DTensor._op_dispatcher.sharding_propagator
    saved = []
    for name in ("propagate_op_sharding", "propagate_op_sharding_non_cached",
                 "propagate"):
        saved.append((prop, name, prop.__dict__.get(name)))
        setattr(prop, name, outside(getattr(prop, name)))
    strided = getattr(placement_types, "_StridedShard", None)
    name = "local_shard_size_and_offset"
    own = vars(strided).get(name) if strided is not None else None
    if own is not None:
        saved.append((strided, name, own))
        wrapped = outside(getattr(strided, name))
        setattr(strided, name, staticmethod(wrapped)
                if isinstance(own, staticmethod) else wrapped)
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks (this
    process rank 0) when none exists, torn down on exit; a group that
    exists already is used as it is (it must hold the mesh's ranks).
    Build meshes inside it and outside ``fake_tensors``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("fake", store=FakeStore(),
                                world_size=world_size, rank=0)
    try:
        yield
    finally:
        if own:
            dist.destroy_process_group()


@contextlib.contextmanager
def fake_tensors():
    """A trace's tensors: ``FakeTensorMode``, with ``DTensor``'s
    propagation outside the dispatch modes."""
    import logging
    from torch._subclasses.fake_tensor import FakeTensorMode
    # DTensor warns once a redistribution for each mesh-dim pair it
    # reduces in steps: a sweep's log would be nothing else
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        with FakeTensorMode(), _outside_modes():
            yield
    finally:
        log.setLevel(level)


def _production_mesh(multi_pod: bool, device, reduced: bool = False):
    """The production mesh (``reduced``: the (2, 2) or (2, 2, 2) mesh
    the smoke-scale configs are sized for), its rank table real under
    ``fake_tensors``."""
    with _disable_current_modes():
        if reduced:
            return make_test_mesh(
                (2, 2, 2) if multi_pod else (2, 2),
                ("pod", "data", "model") if multi_pod else ("data", "model"),
                device=device)
        return make_production_mesh(multi_pod=multi_pod, device=device)


@dataclasses.dataclass
class Lowered:
    """A cell ready to trace: ``run()`` makes its one step; ``arguments``
    are the tensors the step reads that live on the device across steps
    (the reference's argument buffers: parameters, optimizer state,
    caches, the batch's placed shards); ``has_dynamic_loops`` marks a
    cell whose traced step is one iteration of a data-dependent loop."""
    run: typing.Callable[[], object]
    arguments: list
    has_dynamic_loops: bool = False
    batch_bytes: int = 0


def _adt(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _batch(cfg, shape: ShapeSpec, dev):
    """Every model input, whole (the same on every rank under SPMD; the
    step places what it shards)."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32, device=dev)}
    if shape.kind == "train":
        batch["labels"] = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model),
                                            dtype=_adt(cfg), device=dev)
    if cfg.family == "enc_dec" and shape.kind != "decode":
        batch["frames"] = torch.zeros((B, cfg.encoder.n_frames, cfg.d_model),
                                      dtype=_adt(cfg), device=dev)
    return batch


def lower_model(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules: str = "default") -> Lowered:
    """One model cell on ``mesh`` (inside ``fake_tensors``): the model and
    its inputs built with their placements, and the step to trace."""
    ctx = make_ctx(mesh, rules=rules)
    dev = torch.device(mesh.device_type)
    model = Model(cfg, device=dev, ctx=ctx)
    params = model.param_tree()
    batch = _batch(cfg, shape, dev)
    # the batch as the reference's arguments hold it: placed over dp
    ax = batch_axes(cfg)
    batch_bytes = _tree_bytes(place(batch, {k: ax[k] for k in batch}, ctx))
    if shape.kind == "train":
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10000))
        state = TrainState(params, opt.init(params), None)
        step = make_train_step(model, opt, ctx)
        return Lowered(lambda: step(state, batch),
                       _leaves(params) + _leaves(state.opt.mu)
                       + _leaves(state.opt.nu) + [state.opt.step],
                       batch_bytes=batch_bytes)
    max_len = shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)
    caches = model.init_cache(shape.global_batch, max_len)
    caches = place(caches, cache_axes_tree(caches), ctx)
    if shape.kind == "prefill":
        return Lowered(lambda: model.prefill(params, batch, caches, ctx),
                       _leaves(params) + _leaves(caches),
                       batch_bytes=batch_bytes)
    # decode: one new token against a cache of max_len
    if cfg.family == "enc_dec":
        enc = {"out": torch.zeros((shape.global_batch, cfg.encoder.n_frames,
                                   cfg.d_model), dtype=_adt(cfg), device=dev),
               "pos": torch.zeros((cfg.encoder.n_frames,), dtype=torch.int32,
                                  device=dev)}
        caches["enc"] = place(enc, cache_axes_tree(enc), ctx)
    return Lowered(lambda: model.decode_step(params, batch["tokens"], caches,
                                             max_len - 1, ctx),
                   _leaves(params) + _leaves(caches), batch_bytes=batch_bytes)


def _lower_cell(arch: str, shape_name: str, multi_pod: bool,
                rules: str = "default", opts: tuple = (), *, device=None,
                reduced: bool = False):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if opts:
        cfg = dataclasses.replace(cfg, opts=tuple(opts))
    mesh = _production_mesh(multi_pod, device, reduced)
    return lower_model(cfg, SHAPES[shape_name], mesh, rules), mesh


def graph_cell_shapes(S: int, n_log2: int = 22, edge_factor: int = 16,
                      rpvo_max: int = 16, mode: str = "rhizome") -> dict:
    """The reference's analytic padded dims of an RMAT-``n_log2``
    partition over ``S`` shards (balanced allocator: near-ideal)."""
    n = 1 << n_log2
    E = edge_factor * n
    if mode == "rhizome":
        R_total = int(n * 1.02) + rpvo_max  # ~2% hub replicas (R22-like)
        E_max = int(math.ceil(E / S) * 1.05)
    elif mode == "rpvo":
        R_total = n
        E_max = int(math.ceil(E / S) * 1.05)
    else:  # 'simple': hub out-degree ~ n^0.55 concentrates on one shard
        R_total = n
        E_max = int(math.ceil(E / S) * 8)    # measured skew factor for R22
    R_max = int(math.ceil(R_total / S))
    # compact-exchange plan shapes: distinct dsts per (src,tgt) bounded by
    # E_max/S with 2x pad for skew; rhizome table ~2% of slots
    return {"R_max": R_max, "E_max": E_max,
            "K": rpvo_max if mode == "rhizome" else 1,
            "P_t": max(int(math.ceil(E_max / S * 2)), 8),
            "R_rz": max(int(math.ceil(R_max * 0.02)), 8)
            if mode == "rhizome" else 1}


def lower_graph_cell(multi_pod: bool, n_log2: int = 22, edge_factor: int = 16,
                     rpvo_max: int = 16, mode: str = "rhizome",
                     compact: bool = False, *, device=None, mesh=None):
    """The paper's own technique as a dry-run cell: BFS on an RMAT-<n_log2>
    scale partition, one shard a rank over the whole mesh (``mesh``, or
    the production mesh). Shapes are derived analytically (no 128M-edge
    host build); each rank's (1, ...) tables are fake.  The traced step
    is ONE round of the fixpoint — the relax/exchange/collapse round and
    its stats all-reduce (``engine.shard_round``), the reference's while
    body and condition — with the engine's default torch relax
    (``use_pallas=False``, as the reference's default)."""
    from repro_torch.core import actions, engine
    from repro_torch.exchange import inbox_index

    mesh = mesh or _production_mesh(multi_pod, device)
    axes = tuple(mesh.mesh_dim_names)
    S = mesh.size()
    d = graph_cell_shapes(S, n_log2, edge_factor, rpvo_max, mode)
    R_max, E_max, K = d["R_max"], d["E_max"], d["K"]
    ecfg = engine.EngineConfig(exchange="compact" if compact else "dense")
    with _disable_current_modes():          # reads the mesh's rank table
        sg = engine.shard_group(S, mesh, axes)
    dev = torch.device(mesh.device_type)

    def t(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    slot_map = t((1, S, d["P_t"]), torch.int32)
    tables = types.SimpleNamespace(
        edge_dst_compact=t((1, E_max), torch.int32),
        inbox_slot_map=slot_map,
        rz_local=t((1, d["R_rz"]), torch.int32),
        rz_sibling_idx=t((1, d["R_rz"], K), torch.int32),
        rz_sibling_mask=t((1, d["R_rz"], K), torch.bool),
        inbox_index=inbox_index(slot_map, R_max))
    arrays = engine.DeviceArrays(
        edge_src_root_flat=t((1, E_max), torch.int32),
        edge_dst_flat=t((1, E_max), torch.int32),
        edge_w=t((1, E_max), torch.float32),
        edge_mask=t((1, E_max), torch.bool),
        sibling_flat=t((1, R_max, K), torch.int32),
        sibling_mask=t((1, R_max, K), torch.bool),
        slot_valid=t((1, R_max), torch.bool),
        fused_plan=None, compact=tables)
    val = t((1, R_max), torch.float32)
    sem = actions.BFS

    def run():
        chg = sem.improved(val, torch.full_like(val, sem.identity)) \
            & arrays.slot_valid
        step = engine.shard_fixpoint_step(sem, arrays, ecfg, S, R_max, sg)
        return engine.shard_round(step, (val, chg), sg)

    fields = list(arrays[:7]) + ([tables.edge_dst_compact, slot_map,
                                  tables.rz_local, tables.rz_sibling_idx,
                                  tables.rz_sibling_mask, tables.inbox_index]
                                 if compact else [])
    return Lowered(run, fields + [val], has_dynamic_loops=True), mesh


def lower_pipeline_cell(n_micro: int = 8, mb: int = 32, d: int = 4096,
                        layers_per_stage: int = 4, *, device=None, mesh=None):
    """Pipeline-parallel proof cell: a 2-stage GPipe schedule over the
    'pod' axis of the production 2x16x16 mesh, transformer-MLP stages,
    traced forward as rank 0 (stage 0)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.pipeline import pipeline_apply, stage_shardings

    mesh = mesh or _production_mesh(True, device)
    dev = torch.device(mesh.device_type)

    def stage_fn(wp, x):  # wp: (layers_per_stage, d, 4d) + (..., 4d, d)
        w1, w2 = wp
        for i in range(layers_per_stage):
            h = F.gelu(x @ w1[i], approximate="tanh")   # jax.nn.gelu
            x = x + h @ w2[i]
        return x

    fn = pipeline_apply(stage_fn, n_stages=2, n_micro=n_micro, mesh=mesh)
    shapes = ((2, layers_per_stage, d, 4 * d), (2, layers_per_stage, 4 * d, d))
    w = tuple(torch.empty(s, dtype=torch.bfloat16, device=dev)
              for s in shapes)
    w = tuple(distribute_tensor(t, m, pl, src_data_rank=None)
              for t, (m, pl) in zip(w, stage_shardings(mesh, w)))
    x = torch.zeros((n_micro, mb, d), dtype=torch.bfloat16, device=dev)

    def run():
        with torch.no_grad():
            return fn(w, x)

    return Lowered(run, list(w) + [x]), mesh


def trace(lowered: Lowered, budget_s: float | None = None,
          unroll: bool = False):
    """Run ``lowered``'s step under the rank counter (inside
    ``fake_tensors``).  Returns (summary, memory, seconds): the per-op
    summary ``per_device`` reads, the memory fields and the trace's wall
    seconds.  The peak comes from
    ``torch.distributed._tools.mem_tracker.MemTracker``, which follows
    each fake storage's bytes: ``temp_size_bytes`` is that peak less the
    arguments it tracks.  ``unroll``: every trip of every scan traced,
    none weighed."""
    from torch.distributed._tools.mem_tracker import MemTracker
    tracked = sum(_nbytes(t) for t in lowered.arguments)
    t0 = time.perf_counter()
    counter = _RankCounter(None if not budget_s else t0 + budget_s, unroll)
    mt = MemTracker()
    mt.track_external(*lowered.arguments)
    with counter, mt:
        out = lowered.run()
    seconds = time.perf_counter() - t0
    peak = sum(s["Total"] for s in mt.get_tracker_snapshot("peak").values())
    memory = {
        "argument_size_bytes": tracked + lowered.batch_bytes,
        "output_size_bytes": _tree_bytes(out),
        "temp_size_bytes": max(int(peak) - tracked, 0),
        "generated_code_size_bytes": None,
    }
    summary = {"ops": [[k] + v for k, v in sorted(counter.ops.items())],
               "has_dynamic_loops": lowered.has_dynamic_loops}
    return summary, memory, seconds


def per_device(summary: dict) -> dict:
    """The reference's ``per_device`` fields from a trace summary."""
    flops = byts = 0.0
    coll: dict[str, float] = {}
    for _, _, f, b, kind, cb in summary["ops"]:
        flops += f
        byts += b
        if kind is not None:
            coll[kind] = coll.get(kind, 0.0) + cb
    return {"flops": flops, "bytes_accessed": byts,
            "collective_bytes": coll,
            "collective_total": float(sum(coll.values())),
            "has_dynamic_loops": summary["has_dynamic_loops"],
            "num_whiles": None}


def roofline(pd: dict) -> dict:
    """Roofline terms of a ``per_device`` record against the H100's
    peaks, with the dominant term and its time."""
    terms = {"compute_s": pd["flops"] / PEAK_FLOPS,
             "memory_s": pd["bytes_accessed"] / HBM_BW,
             "collective_s": pd["collective_total"] / ICI_BW}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


def analyze_into(rec: dict, summary: dict):
    """``per_device``, ``collectives``, ``roofline`` and (with
    ``model_flops``) ``useful_compute_ratio`` of ``rec`` from a trace
    summary: what ``run_cell`` writes and ``reanalyze`` recomputes."""
    pd = per_device(summary)
    rec["per_device"] = pd
    rec["collectives"] = {**pd["collective_bytes"],
                          "total": pd["collective_total"]}
    rec["roofline"] = roofline(pd)
    if rec.get("model_flops"):
        g = pd["flops"] * rec["num_devices"]
        rec["useful_compute_ratio"] = rec["model_flops"] / g if g else None


def record_trace(rec: dict, lowered: Lowered, num_devices: int,
                 trace_path: str | None = None,
                 budget_s: float | None = None) -> dict:
    """Trace ``lowered`` and fill ``rec``'s measured fields (the summary
    written to ``trace_path`` when given).  Returns ``rec``."""
    summary, memory, seconds = trace(lowered, budget_s)
    rec["trace_s"] = round(seconds, 2)
    rec["compile_s"] = None
    rec["xla_cost_raw"] = None
    rec["memory"] = memory
    rec["null_reasons"] = dict(NULL_REASONS)
    rec["num_devices"] = num_devices
    if trace_path is not None:
        with gzip.open(trace_path, "wt") as zf:
            json.dump(summary, zf)   # re-analyzable without tracing
    analyze_into(rec, summary)
    return rec


# (arch, shape) of the 2-stage GPipe cell: ``run_cell`` traces it with
# ``lower_pipeline_cell`` and records it as the reference does
PIPELINE_CELL = ("pipeline-gpipe2", "micro8x32x4096")


def _tag(arch, shape_name, multi_pod, rules, opts, reduced):
    if (arch, shape_name) == PIPELINE_CELL:
        return arch
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}__{rules}"
    if opts:
        tag += "__" + "-".join(opts)
    return tag + ("__reduced" if reduced else "")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules: str = "default", force: bool = False,
             graph_mode: str | None = None, opts: tuple = (), *,
             device=None, reduced: bool = False,
             budget_s: float | None = None) -> dict:
    """Trace one cell and write its record (cached: an existing record
    is returned unless ``force``).  A model cell, a graph cell (with
    ``graph_mode``) or the pipeline cell (``PIPELINE_CELL``, on the
    2x16x16 mesh).  A cell that fails or passes ``budget_s`` seconds of
    tracing is recorded ``ok: false`` with its error."""
    dev = resolve_device(device)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    tag = _tag(arch, shape_name, multi_pod, rules, opts, reduced)
    path = os.path.join(RESULTS_DIR, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    rec: dict = {"arch": arch, "shape": shape_name,
                 "multi_pod": multi_pod, "rules": rules,
                 "opts": list(opts), "device": dev.type, "reduced": reduced}
    pipeline = (arch, shape_name) == PIPELINE_CELL
    model = graph_mode is None and not pipeline
    if model:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        ok, reason = cell_applicable(cfg, shape)
        if not ok:
            rec["skipped"] = reason
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            return rec
        rec["model_flops"] = SP.model_flops(cfg.reduced() if reduced else cfg,
                                            shape)
    t0 = time.time()
    try:
        with fake_group(512 if multi_pod else 256), fake_tensors():
            if pipeline:
                lowered, mesh = lower_pipeline_cell(device=dev)
            elif graph_mode is not None:
                lowered, mesh = lower_graph_cell(
                    multi_pod, mode=graph_mode, compact="compact" in opts,
                    device=dev)
            else:
                lowered, mesh = _lower_cell(arch, shape_name, multi_pod,
                                            rules, opts, device=dev,
                                            reduced=reduced)
            rec["lower_s"] = round(time.time() - t0, 1)
            record_trace(rec, lowered, mesh.size(),
                         path.replace(".json", ".trace.json.gz"), budget_s)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _line(arch, shape, mp, rec):
    status = ("SKIP " + rec.get("skipped", "")) if "skipped" in rec else \
        ("OK" if rec.get("ok") else "FAIL " + rec.get("error", ""))
    r = rec.get("roofline", {})
    return (f"{arch:24s} {shape:12s} {'pod2' if mp else 'pod1'} "
            f"{status[:90]}"
            + (f"  comp={r.get('compute_s', 0):.3e}s "
               f"mem={r.get('memory_s', 0):.3e}s "
               f"coll={r.get('collective_s', 0):.3e}s "
               f"dom={r.get('dominant', '')} "
               f"trace={rec.get('trace_s')}s" if r else ""))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--graph", action="store_true",
                    help="dry-run the graph engine cells")
    ap.add_argument("--pipeline", action="store_true",
                    help="dry-run the 2-stage GPipe cell on the 2x16x16 mesh")
    ap.add_argument("--graph-mode", default="rhizome",
                    choices=["rhizome", "rpvo", "simple"])
    ap.add_argument("--rules", default="default")
    ap.add_argument("--opts", default="",
                    help="comma list: moe_grouped,attn_chunked,chunked_ce,scan_unroll")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors (default: cuda, "
                         "which must exist)")
    ap.add_argument("--reduced", action="store_true",
                    help="each architecture's smoke-scale config")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="seconds a cell's trace may take before it is "
                         "recorded as failed")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    pods = [False, True] if args.both_meshes else [args.multi_pod]
    cells = []
    if args.pipeline:
        cells.append((*PIPELINE_CELL, True, None))
    elif args.graph:
        for mp in pods:
            cells.append((f"graph-bfs-{args.graph_mode}", "rmat22", mp,
                          args.graph_mode))
    elif args.all:
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                for mp in pods:
                    cells.append((arch, shape, mp, None))
    else:
        if not (args.arch and args.shape):
            ap.error("name --arch and --shape, or pass --all, --graph or "
                     "--pipeline")
        for mp in pods:
            cells.append((args.arch, args.shape, mp, None))

    opts = tuple(o for o in args.opts.split(",") if o)
    for arch, shape, mp, gm in cells:
        rec = run_cell(arch, shape, mp, rules=args.rules, force=args.force,
                       graph_mode=gm, opts=opts, device=dev,
                       reduced=args.reduced, budget_s=args.budget_s)
        print(_line(arch, shape, mp, rec))


if __name__ == "__main__":
    main()
