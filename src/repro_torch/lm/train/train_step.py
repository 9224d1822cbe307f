"""Train / serve step factories.

``make_train_step`` builds the step: ``model.loss`` and its backward,
optional int8 gradient compression (error feedback carried in the step
state), the AdamW update.  The parameters are the model's own
(``model.param_tree()``): the step turns their gradients on for its
backward, updates them in place, and clears every ``.grad`` before it
returns, so no gradient outlives a step and serving's ``torch.no_grad``
paths see the parameters as they were built.

``make_serve_steps`` builds the prefill and decode steps.

With a bound ``ctx`` the parameters are ``DTensor``s on its mesh
(``Model(cfg, ctx=ctx)`` or ``model.place(ctx)``): the batch is placed
by ``batch_axes`` (dp over the batch dim), each gradient is taken in
its parameter's placements, the caches are placed by
``cache_axes_tree`` on the first prefill, and the metrics are plain
0-d tensors, the same on every rank.
"""
from __future__ import annotations

import contextlib
import typing

import torch

from repro_torch.lm.models.model import Model, _map
from repro_torch.lm.train.optimizer import AdamW, _leaves, as_placed
from repro_torch.sharding import compression
from repro_torch.sharding.specs import (ShardCtx, constrain, is_dtensor,
                                       place, spmd)


class TrainState(typing.NamedTuple):
    params: typing.Any
    opt: typing.Any
    residuals: typing.Any    # grad-compression error feedback (or None)


@contextlib.contextmanager
def _grads_on(leaves):
    """Gradients on for ``leaves`` while open; afterwards every ``.grad``
    is cleared and the leaves are as they were."""
    was = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            yield
    finally:
        for p, w in zip(leaves, was):
            p.grad = None
            p.requires_grad_(w)


def make_train_step(model: Model, opt: AdamW, ctx: ShardCtx | None = None,
                    compress_grads: bool = False, accum_steps: int = 1):
    """Returns step(state: TrainState, batch) -> (state, metrics).

    ``accum_steps > 1`` splits the batch into microbatches, runs each
    one's loss and backward in turn and sums their gradients into f32
    buffers: peak activation memory scales with the microbatch, the
    update is numerically the full-batch mean."""

    axes = batch_axes(model.cfg)

    def _backward(params, batch):
        # the backward recomputes remat'd layers: placed like the forward
        with spmd(ctx):
            # token ids stay plain: the lookups read them whole and
            # ``Model._loss`` places the labels where it uses them
            batch = {k: v if k in ("tokens", "labels") else
                     constrain(v, axes.get(k, (None,) * v.dim()), ctx)
                     for k, v in batch.items()}
            loss, metrics = model.loss(params, batch, ctx)
            loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def step(state: TrainState, batch):
        params = state.params
        leaves = _leaves(params)
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        with _grads_on(leaves):
            if accum_steps > 1:
                micro = {k: _split(v, accum_steps, model.device)
                         for k, v in batch.items()}
                gsum = [torch.zeros_like(p, dtype=torch.float32)
                        for p in leaves]
                ms = []
                for i in range(accum_steps):
                    ms.append(_backward(
                        params, {k: v[i] for k, v in micro.items()}))
                    for acc, p in zip(gsum, leaves):
                        if p.grad is not None:
                            acc.add_(as_placed(p.grad, p))
                            p.grad = None
                grads = _tree_like(params, leaves,
                                   [g.div_(accum_steps) for g in gsum])
                del gsum
                metrics = {k: torch.stack([m[k] for m in ms]).mean()
                           for k in ms[0]}
            else:
                metrics = _backward(params, batch)
                grads = _tree_like(params, leaves,
                                   [as_placed(p.grad, p) for p in leaves])
            residuals = state.residuals
            if compress_grads:
                grads, residuals = compression.compress_decompress(
                    grads, residuals)
            _, new_opt, opt_metrics = opt.update(grads, state.opt, params)
            del grads
        metrics = {**metrics, **opt_metrics}
        return TrainState(params, new_opt, residuals), metrics

    return step


def _split(x, n, device):
    """(B, ...) -> (n, B // n, ...) on ``device``."""
    x = torch.as_tensor(x, device=device)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not split into {n} "
                         f"microbatches")
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _tree_like(tree, leaves, values):
    """``tree``'s structure with each leaf (in ``_leaves`` order) replaced
    by its value."""
    by_id = {id(p): v for p, v in zip(leaves, values)}
    return _map(lambda p: by_id[id(p)], tree)


def batch_axes(cfg) -> dict:
    """Logical axes for each batch field (DP batch, replicated seq)."""
    ax = {"tokens": ("act_batch", None), "labels": ("act_batch", None)}
    if cfg.family == "vlm":
        ax["patch_embeds"] = ("act_batch", None, None)
    if cfg.family == "enc_dec":
        ax["frames"] = ("act_batch", None, None)
    return ax


def _cache_axes(name, nd):
    if name in ("k", "v"):
        # (layers, B, S, KV, hd)
        return ("layers", "act_batch", "act_kv_seq", "act_kv_heads", None)[:nd]
    if name == "conv":
        return ("layers", "act_batch", None, "act_mamba_inner")[:nd]
    if name == "ssm":
        return ("layers", "act_batch", "act_mamba_inner", None)[:nd]
    if name == "C":
        return ("layers", "act_batch", "act_heads", None, None)[:nd]
    if name in ("n", "c"):
        return ("layers", "act_batch", "act_heads", None)[:nd]
    if name == "m":
        return ("layers", "act_batch", "act_heads")[:nd]
    if name == "out":   # encoder output (B, F, d)
        return ("act_batch", None, None)[:nd]
    if name == "pos":
        return (None,)[:nd]
    return tuple([None] * nd)


def cache_axes_tree(caches):
    """Logical axes for a cache tree: KV tensors get their sequence dim
    sharded 'tp' (act_kv_seq), recurrent states shard the inner dim."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _cache_axes(name, tree.dim())
    return walk(caches, None)


def make_serve_steps(model: Model, ctx: ShardCtx | None = None):
    """Returns (prefill_fn, decode_fn)."""

    def prefill(params, batch, caches):
        if ctx is not None and ctx.mesh is not None and not any(
                is_dtensor(t) for t in _leaves(caches)):
            caches = place(caches, cache_axes_tree(caches), ctx)
        return model.prefill(params, batch, caches, ctx)

    def decode(params, tokens_t, caches, index):
        logits, caches = model.decode_step(params, tokens_t, caches, index,
                                           ctx)
        return logits, caches

    return prefill, decode
