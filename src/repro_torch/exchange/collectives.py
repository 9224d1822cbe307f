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
