"""Abstract inputs and state, and the model-FLOP and parameter counts.

``input_specs(cfg, shape)`` returns stand-ins for every model input, and
``abstract_params`` / ``abstract_opt_state`` / ``abstract_caches`` do
the same for parameters, optimizer state and caches: tensors on the
``meta`` device, shapes and dtypes with no storage.  With a bound
``ctx`` each stand-in is a ``DTensor`` over ``meta`` in its
``sharding_for`` placements (the reference's ``ShapeDtypeStruct`` with
a ``NamedSharding``); ``local_shape(leaf)`` gives the rank's shard
shape.  ``model_flops``, ``param_count``, ``active_param_count`` are the
reference's counts.
"""
from __future__ import annotations

import math

import torch

from repro_torch.lm.configs.base import ModelConfig, ShapeSpec
from repro_torch.lm.models.model import Model, _flatten, _map
from repro_torch.lm.train.optimizer import AdamW
from repro_torch.lm.train.train_step import batch_axes, cache_axes_tree
from repro_torch.sharding.specs import ShardCtx, local_shape, sharding_for

__all__ = ["input_specs", "abstract_params", "abstract_opt_state",
           "abstract_caches", "local_shape", "model_flops", "param_count",
           "active_param_count"]

META = torch.device("meta")


def _bound(ctx: ShardCtx | None) -> bool:
    return ctx is not None and ctx.mesh is not None


def _meta(shape, dtype, axes=None, ctx: ShardCtx | None = None):
    t = torch.empty(shape, dtype=dtype, device=META)
    if axes is None or not _bound(ctx):
        return t
    from torch.distributed.tensor import distribute_tensor
    mesh, pl = sharding_for(axes, ctx, tuple(shape))
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def _place_meta(tree, axes, ctx):
    return _map(lambda t, a: _meta(t.shape, t.dtype, a, ctx), tree, axes)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                ctx: ShardCtx | None = None) -> dict:
    """Batch stand-ins for one cell. train/prefill: full (B, S) tokens;
    decode: (B, 1) next tokens."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    adt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    ax = batch_axes(cfg)
    batch = {"tokens": _meta((B, S), torch.int32, ax["tokens"], ctx)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32, ax["labels"], ctx)
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["patch_embeds"] = _meta((B, cfg.n_patches, cfg.d_model), adt,
                                      ax["patch_embeds"], ctx)
    if cfg.family == "enc_dec" and shape.kind != "decode":
        batch["frames"] = _meta((B, cfg.encoder.n_frames, cfg.d_model), adt,
                                ax["frames"], ctx)
    return batch


def abstract_params(model: Model, ctx: ShardCtx | None = None):
    """(parameter stand-ins on ``meta``, logical axes tree)."""
    axes = model._axes_tree
    return _place_meta(model.param_tree(), axes, ctx), axes


def abstract_opt_state(opt: AdamW, params_shapes, axes, ctx):
    """The optimizer state's stand-ins: the moments placed like their
    parameters, the step count replicated."""
    return opt.init(params_shapes)


def abstract_caches(model: Model, batch_size: int, max_len: int, ctx,
                    cache_dtype=None):
    shapes = Model(model.cfg, device=META).init_cache(
        batch_size, max_len, cache_dtype=cache_dtype)
    axes = cache_axes_tree(shapes)
    return _place_meta(shapes, axes, ctx), axes


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode D = B·1."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        return 6.0 * n_active * D
    if shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        return 2.0 * n_active * D
    D = shape.global_batch * 1
    return 2.0 * n_active * D


def param_count(cfg: ModelConfig) -> float:
    model = Model(cfg, device=META)
    return float(sum(math.prod(p.shape)
                     for p in _flatten(model.param_tree()).values()))


def active_param_count(cfg: ModelConfig) -> float:
    """Params touched per token (MoE: top_k of routed + shared + backbone)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    # routed expert params per MoE layer
    per_expert = 3 * cfg.d_model * m.d_expert_ff
    n_moe_layers = _num_moe_layers(cfg)
    routed_total = n_moe_layers * m.num_experts * per_expert
    routed_active = n_moe_layers * m.top_k * per_expert
    return total - routed_total + routed_active


def _num_moe_layers(cfg: ModelConfig) -> int:
    if cfg.family == "moe":
        return cfg.n_layers - cfg.moe.first_dense_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // 2   # MoE every other layer
    return 0
