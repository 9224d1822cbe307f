"""Collectives of the sharded layout, on ``torch.distributed``.

The port's counterpart of the ``lax`` collectives the reference's
``shard_map`` rounds use: ``all_gather`` is ``lax.all_gather(...,
tiled=True)`` (the diffusion fan-out and the rhizome collapse's sibling
read), ``all_to_all`` is ``lax.all_to_all(..., tiled=True)`` (the inbox
exchange) and ``psum`` / ``pmax`` are ``lax.psum`` / ``lax.pmax`` (the
round's message, work and live counts).

The layout is SPMD: one process a shard, every process making the same
calls.  ``shard_group(mesh, axis_names)`` maps a
``torch.distributed.device_mesh.DeviceMesh`` onto the shards: a rank's
shard index is its row-major coordinate over ``axis_names`` (the layout
the reference's ``P(("data", "model"))`` gives), and the collectives run
over the process group that spans those axes — the world group when they
cover the mesh, the mesh dimension's group when they name one.

Tensors travel as they are, on the group's backend: NCCL moves CUDA
tensors on the card, gloo takes CPU tensors and CUDA ones (it stages
the latter through host memory itself; on an H100 it took every one of
these collectives on float32, int64, uint8 and bool tensors of the card,
``chip_smoke.py`` phase 10's probe).  Nothing here retries on another
backend or copy.

Instrumentation: ``calls[op]`` and ``bytes_in[op]`` count each
collective and the bytes it hands back to this rank (per process), and
with ``timing = True`` each call synchronizes the card first and adds
its host-clock seconds to ``seconds[op]`` — what a round spends in the
exchange, apart from the kernels that feed it.
"""
from __future__ import annotations

import collections
import math
import time
import typing

import torch
import torch.distributed as dist

calls: collections.Counter = collections.Counter()
bytes_in: collections.Counter = collections.Counter()
seconds: collections.Counter = collections.Counter()
timing = False

# torch 2.13 names all_gather_single as all_gather_into_tensor's successor
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class ShardGroup(typing.NamedTuple):
    """The shards' process group: ``rank`` is this process's shard
    index, ``size`` the number of shards."""

    group: object
    rank: int
    size: int


def backend_for(device_type: str, world_size: int) -> str:
    """The process group's backend for ranks on ``device_type``: NCCL
    when each of ``world_size`` ranks has a GPU of its own, gloo when
    the ranks outnumber the visible GPUs (they share a card: gloo stages
    its tensors through host memory) or run on the CPU."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


_GLOO_CUDA_GATHERS = []     # the kernel registration, kept alive


def route_gloo_cuda_gathers():
    """Route the functional all-gather of CUDA tensors (``DTensor``'s
    ``Shard`` -> ``Replicate``) through ``dist.all_gather_into_tensor``
    on the resolved group, synchronously.  The functional op calls the
    group's coalesced all-gather, which gloo runs on the host's view of
    the card's pointers: on an H100 with torch 2.11 it crashed every rank
    (SIGSEGV), while ``all_gather_into_tensor`` (gloo's
    ``_allgather_base``, staging through host memory) and the functional
    all-reduce, reduce-scatter and all-to-all took the card's tensors
    (``chip_smoke.py`` phase 14).  Called once a process by
    ``lm.launch.mesh`` when the world's backend is gloo and the mesh's
    devices are CUDA; an NCCL process never registers it."""
    if _GLOO_CUDA_GATHERS:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(x, group_size, group_name):
        out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    def gather_coalesced(xs, group_size, group_name):
        return [gather(x, group_size, group_name) for x in xs]

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    lib.impl("all_gather_into_tensor_coalesced", gather_coalesced, "CUDA")
    _GLOO_CUDA_GATHERS.append(lib)


def axis_tuple(axis_names):
    return axis_names if isinstance(axis_names, tuple) else (axis_names,)


def shard_group(mesh, axis_names=("data", "model")) -> ShardGroup:
    """The ``ShardGroup`` of this process on ``mesh`` over
    ``axis_names``: the axes must name mesh dimensions and either cover
    the mesh (laid over every rank, row-major over the axes in rank
    order) or be one of its dimensions."""
    axis_names = axis_tuple(axis_names)
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axis_names if a not in names]
    if missing:
        raise ValueError(f"mesh has no axes {missing} (its axes: {names})")
    dims = [names.index(a) for a in axis_names]
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    sizes = [mesh.mesh.shape[d] for d in dims]
    shard = 0
    for d, n in zip(dims, sizes):
        shard = shard * n + coord[d]
    if len(dims) == mesh.mesh.dim():
        group = dist.group.WORLD
    elif len(dims) == 1:
        group = mesh.get_group(dims[0])
    else:
        raise ValueError(
            f"axes {axis_names} neither cover the mesh {names} nor name "
            "one of its dimensions")
    size = math.prod(sizes)
    if dist.get_world_size(group) != size \
            or dist.get_group_rank(group, dist.get_rank()) != shard:
        raise ValueError("the mesh's process group does not hold its "
                         "shards one a rank in row-major order")
    return ShardGroup(group, shard, size)


def _start(op: str, x: torch.Tensor):
    calls[op] += 1
    if timing:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.perf_counter()
    return None


def _stop(op: str, t0, out: torch.Tensor):
    bytes_in[op] += out.numel() * out.element_size()
    if t0 is not None:
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        seconds[op] += time.perf_counter() - t0


def all_gather(x: torch.Tensor, sg: ShardGroup) -> torch.Tensor:
    """Tiled all-gather along dim 0: (k, ...) on every shard ->
    (size * k, ...), shard s's rows at ``[s * k, (s + 1) * k)``."""
    t0 = _start("all_gather", x)
    x = x.contiguous()
    out = x.new_empty((sg.size * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group=sg.group)
    _stop("all_gather", t0, out)
    return out


def all_to_all(x: torch.Tensor, sg: ShardGroup) -> torch.Tensor:
    """Tiled all-to-all along dim 0: (size * k, ...) -> (size * k, ...);
    rows ``[t * k, (t + 1) * k)`` go to shard t, and the rows received
    from shard s land at ``[s * k, (s + 1) * k)``."""
    if x.shape[0] % sg.size:
        raise ValueError(f"dim 0 ({x.shape[0]}) is not a multiple of the "
                         f"{sg.size} shards")
    t0 = _start("all_to_all", x)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=sg.group)
    _stop("all_to_all", t0, out)
    return out


def _all_reduce(op: str, x: torch.Tensor, sg: ShardGroup, red):
    t0 = _start(op, x)
    out = x.clone(memory_format=torch.contiguous_format)   # reduced in place
    dist.all_reduce(out, op=red, group=sg.group)
    _stop(op, t0, out)
    return out


def psum(x: torch.Tensor, sg: ShardGroup) -> torch.Tensor:
    """Sum of ``x`` over the shards, on every shard."""
    return _all_reduce("psum", x, sg, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, sg: ShardGroup) -> torch.Tensor:
    """Elementwise max of ``x`` over the shards (bool: any)."""
    return _all_reduce("pmax", x, sg, dist.ReduceOp.MAX)


def reset_counters():
    """Zero ``calls``, ``bytes_in`` and ``seconds``."""
    calls.clear()
    bytes_in.clear()
    seconds.clear()


# --------------------------------------------------------------------------
# autograd-aware collectives of the sharded LM (``lm.models.moe``)
# --------------------------------------------------------------------------

class _GatherDim(torch.autograd.Function):
    """Tiled all-gather along ``dim`` over ``group``; its adjoint is the
    reduce-scatter (sum) of the gradient along the same dim."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
        _gather_into(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        gt = g.movedim(ctx.dim, 0).contiguous()
        out = gt.new_empty((gt.shape[0] // n,) + tuple(gt.shape[1:]))
        dist.reduce_scatter_tensor(out, gt, op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) over ``group`` of partial values whose sum every
    rank then uses as one replicated value: the gradient of each part is
    the replicated sum's gradient, passed through as it is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def axes_group(mesh, axes):
    """The process group of ``mesh`` over the named ``axes`` (one mesh
    dimension's group, or the group of several flattened)."""
    axes = axis_tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)`` with autograd.
    Counted (forward calls) as ``all_gather_dim``."""
    out = _GatherDim.apply(x, dim, group)
    calls["all_gather_dim"] += 1
    bytes_in["all_gather_dim"] += out.numel() * out.element_size()
    return out


def psum_replicated(x: torch.Tensor, group,
                    kind: str = "psum_replicated") -> torch.Tensor:
    """``lax.psum(x, axis)`` inside a ``shard_map`` whose output is
    replicated over ``axis``, with autograd.  Counted (forward calls)
    under ``kind``."""
    out = _SumReplicated.apply(x, group)
    calls[kind] += 1
    bytes_in[kind] += out.numel() * out.element_size()
    return out
