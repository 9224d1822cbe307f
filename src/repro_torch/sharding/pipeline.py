"""GPipe-style pipeline parallelism over the ``pod`` mesh axis.

The layer stack is split into ``n_stages`` contiguous groups; stage s's
parameters live on pod s (leading stage dim sharded over ``pod``).
Microbatches flow through an SPMD schedule, every rank of the pod axis
running the same loop: at tick t, stage s processes microbatch t−s and
hands its activation to stage s+1 (``ppermute``) — inter-pod traffic is
exactly one activation tensor a tick.

``ppermute`` is a ``torch.autograd.Function`` over
``dist.batch_isend_irecv`` whose backward sends the gradient along the
inverse permutation, so the gradient of the pipelined loss is GPipe with
the full activation stash, as the reference's ``jax.grad`` through its
``ppermute``s is.  A gloo group stages CUDA tensors through host memory
for the point-to-point sends (decided by the backend and the device).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.exchange import collectives
from repro_torch.sharding.specs import is_dtensor


def _staged(group, t: torch.Tensor) -> bool:
    """Whether point-to-point sends of ``t`` go through host memory: a
    gloo group reads and writes a send's bytes from the host."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _exchange(x: torch.Tensor, perm, group, kind: str) -> torch.Tensor:
    """Send ``x`` from each source to its destination (group ranks);
    a rank that receives nothing gets zeros.  A receive is counted in
    ``collectives.calls[kind]`` / ``bytes_in[kind]``."""
    me = dist.get_group_rank(group, dist.get_rank())
    staged = _staged(group, x)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me:
            ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(
                group, d), group))
        if d == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                group, s), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if any(d == me for _, d in perm):
        collectives.calls[kind] += 1
        collectives.bytes_in[kind] += out.numel() * out.element_size()
    return out.to(x.device) if staged else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _exchange(x, perm, group, "ppermute")

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return (_exchange(g.contiguous(), inv, ctx.group, "ppermute_grad"),
                None, None)


class _Tie(torch.autograd.Function):
    """``x`` itself, with ``dep`` made a zero-gradient input: every
    rank's backward then reaches every ``ppermute`` it made, in the same
    order as every other rank (each one's adjoint is a send/receive the
    peers wait for)."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep_shape = dep.shape
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.dep_shape)


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every stage, used as ONE replicated
    value (each rank computes the same loss from it): the adjoint keeps
    the last stage's own gradient and gives the others none.  ``dep``
    (the last tick's received activation) ties the schedule into every
    rank's graph."""

    @staticmethod
    def forward(ctx, outs, dep, last, group):
        ctx.mine = dist.get_group_rank(group, dist.get_rank()) == last
        ctx.dep_shape = dep.shape
        got = _exchange(outs, [(last, i) for i in range(last)], group,
                        "broadcast")
        return outs.clone() if ctx.mine else got

    @staticmethod
    def backward(ctx, g):
        return ((g if ctx.mine else torch.zeros_like(g)),
                g.new_zeros(ctx.dep_shape), None, None)


def ppermute(x: torch.Tensor, perm, group) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)`` over ``group`` (pairs of group
    ranks), with autograd."""
    return _PPermute.apply(x, tuple(perm), group)


def _own_stage(p, stage: int):
    """This rank's stage of a stacked leaf: the local (1, ...) shard of a
    ``DTensor`` sharded over pod, or row ``stage`` of a whole tensor."""
    return p.to_local()[0] if is_dtensor(p) else p[stage]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn, n_stages: int, n_micro: int, mesh,
                   pod_axis: str = "pod", inner_spec=()):
    """Build a pipelined fn(stacked_params, x) -> y.

    stage_fn(stage_params, x_micro) -> x_micro applies ONE stage.
    stacked_params: tree with leading dim n_stages (``stage_shardings``
    places it over pod; a whole tensor on every rank also works).
    x: (n_micro, micro_batch, ...) — microbatch-major input, the same
    on every rank (``inner_spec`` replicated, as the reference's
    default); y is the same on every rank, one replicated value: every
    rank computes the same loss from it, and the gradient of that loss
    is the sequential stages' gradient.
    """
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    assert sizes[pod_axis] == n_stages
    if tuple(inner_spec):
        raise ValueError("pipeline_apply takes a replicated inner_spec")
    group = mesh.get_group(pod_axis)

    def fn(stacked_params, x):
        stage = mesh.get_local_rank(pod_axis)
        params_s = _tree_map(lambda p: _own_stage(p, stage), stacked_params)
        n_t = n_micro + n_stages - 1
        perm = [(i, i + 1) for i in range(n_stages - 1)]
        last = n_stages - 1
        buf = torch.zeros_like(x[0])       # current activation at this stage
        outs = [None] * n_micro            # collected at the last stage
        for t in range(n_t):
            # stage 0 ingests microbatch t (if valid); others take recv
            x_in = (_Tie.apply(x[min(max(t, 0), n_micro - 1)], buf)
                    if stage == 0 else buf)
            y = stage_fn(params_s, x_in)
            buf = ppermute(y, perm, group)
            # last stage emits microbatch t-(n_stages-1)
            if stage == last and t >= last:
                outs[t - last] = y
        outs = torch.stack(outs) if stage == last else torch.zeros_like(x)
        # broadcast the last stage's outputs to every stage
        return _FromLast.apply(outs, buf, last, group)

    return fn


def stage_shardings(mesh, params_stacked, pod_axis: str = "pod"):
    """(mesh, placements) for every leaf: the leading stage dim sharded
    over ``pod``."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Shard(0) if a == pod_axis else Replicate()
               for a in mesh.mesh_dim_names)
    return _tree_map(lambda p: (mesh, pl), params_stacked)
