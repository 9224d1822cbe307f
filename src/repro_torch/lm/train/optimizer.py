"""AdamW with f32 moments and global-norm clipping.

The reference's math and call forms: ``init(params) -> OptState`` and
``update(grads, state, params) -> (params, state, metrics)`` over trees
(nested dicts) of tensors.  The update is made in place under
``torch.no_grad()``: the returned parameters and moments are the tensors
passed in, and ``state.step`` is a new 0-d int32 tensor.  Each leaf is
updated in blocks along its leading axis (a stacked leaf's layers, an
embedding's rows) of at most ``BLOCK_ELEMS`` values, so the float32
temporaries stay a block's size; a whole-leaf update of minitron-4b's
stacked MLP weight would hold several 3.6 GB float32 copies.

On a mesh the parameters are ``DTensor``s and the moments are placed
like them.  Each gradient is first redistributed to its parameter's
placements (a backward may hand back a pending sum), the global norm
counts each element once (a sum of squares over a shard is a pending
sum over the mesh dims that shard it, replicated over the others), and
the blocked update runs on each rank's local shards: the element-wise
math is the unsharded one's.
"""
from __future__ import annotations

import dataclasses
import math
import typing

import torch

from repro_torch.lm.models.model import _map
from repro_torch.sharding.specs import gathered, is_dtensor

BLOCK_ELEMS = 1 << 24


class OptState(typing.NamedTuple):
    step: torch.Tensor
    mu: typing.Any          # first moment (f32)
    nu: typing.Any          # second moment (f32)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def as_placed(g, p):
    """Gradient ``g`` in its parameter ``p``'s placements (a plain
    ``p``: ``g`` itself)."""
    if g is None or not is_dtensor(p):
        return g
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _sq_sum(g):
    """Sum of squares of ``g`` in float32, blockwise; on a ``DTensor``
    the plain total of every element, on every rank."""
    local = _local(g)
    ssq = torch.zeros((), dtype=torch.float32, device=local.device)
    for (b,) in _blocks(local):
        ssq = ssq + torch.sum(torch.square(b.float()))
    if not is_dtensor(g):
        return ssq
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = tuple(Replicate() if q.is_replicate() else Partial()
               for q in g.placements)
    return gathered(DTensor.from_local(ssq, g.device_mesh, pl,
                                       run_check=False))


def _blocks(*tensors):
    """Matching views of ``tensors`` (one shape) in blocks along the
    leading axis of at most ``BLOCK_ELEMS`` values (one block for a
    scalar or a leaf under the limit)."""
    t0 = tensors[0]
    if t0.dim() == 0 or t0.numel() <= BLOCK_ELEMS:
        yield tensors
        return
    rows = max(1, BLOCK_ELEMS // (t0.numel() // t0.shape[0]))
    for r in range(0, t0.shape[0], rows):
        yield tuple(t[r:r + rows] for t in tensors)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: typing.Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> OptState:
        leaves = _leaves(params)
        dev = leaves[0].device if leaves else None
        zeros = lambda: _map(lambda p: torch.zeros_like(
            p, dtype=torch.float32, memory_format=torch.contiguous_format),
            params)
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        mu=zeros(), nu=zeros())

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """Returns (params, state, metrics), params and moments updated
        in place.  A ``None`` gradient counts as zeros (an unused
        parameter)."""
        flat_p = _leaves(params)
        flat_g = [as_placed(g, p) for g, p in zip(_leaves(grads), flat_p)]
        flat_m, flat_v = _leaves(state.mu), _leaves(state.nu)
        dev = state.step.device
        gsq = torch.zeros((), dtype=torch.float32, device=dev)
        for g in flat_g:
            if g is not None:
                gsq = gsq + _sq_sum(g)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=dev), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=dev), stepf)
        lr = torch.as_tensor(self._lr(step), dtype=torch.float32, device=dev)
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            p, m, v = _local(p), _local(m), _local(v)
            g = torch.zeros_like(p) if g is None else _local(g)
            for pb, gb, mb, vb in _blocks(p, g, m, v):
                gf = gb.float() * scale
                mb.copy_(b1 * mb + (1 - b1) * gf)
                vb.copy_(b2 * vb + (1 - b2) * torch.square(gf))
                delta = (mb / bc1) / (torch.sqrt(vb / bc2) + self.eps)
                pf = pb.float()
                delta = delta + self.weight_decay * pf
                pb.copy_(pf - lr * delta)
        return params, OptState(step, state.mu, state.nu), {
            "grad_norm": gnorm, "lr": lr}
