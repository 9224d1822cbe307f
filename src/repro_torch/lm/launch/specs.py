"""Abstract inputs and state, and the model-FLOP and parameter counts.

``input_specs(cfg, shape)`` returns stand-ins for every model input, and
``abstract_params`` / ``abstract_opt_state`` / ``abstract_caches`` do
the same for parameters, optimizer state and caches: tensors on the
``meta`` device, shapes and dtypes with no storage.  A bound mesh is
sharded LM training's (ROADMAP Queue 1, item 12c) and raises here.
``model_flops``, ``param_count``, ``active_param_count`` are the
reference's counts.
"""
from __future__ import annotations

import math

import torch

from repro_torch.lm.configs.base import ModelConfig, ShapeSpec
from repro_torch.lm.models.model import Model, _flatten, _map
from repro_torch.lm.train.optimizer import AdamW
from repro_torch.lm.train.train_step import cache_axes_tree
from repro_torch.sharding.specs import ShardCtx

META = torch.device("meta")


def _no_mesh(ctx: ShardCtx | None):
    if ctx is not None and ctx.mesh is not None:
        raise NotImplementedError(
            "abstract state on a bound mesh is not ported yet (ROADMAP "
            "Queue 1, item 12c: sharded LM training)")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                ctx: ShardCtx | None = None) -> dict:
    """Batch stand-ins for one cell. train/prefill: full (B, S) tokens;
    decode: (B, 1) next tokens."""
    _no_mesh(ctx)
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    adt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    batch = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["patch_embeds"] = _meta((B, cfg.n_patches, cfg.d_model), adt)
    if cfg.family == "enc_dec" and shape.kind != "decode":
        batch["frames"] = _meta((B, cfg.encoder.n_frames, cfg.d_model), adt)
    return batch


def abstract_params(model: Model, ctx: ShardCtx | None = None):
    """(parameter stand-ins on ``meta``, logical axes tree)."""
    _no_mesh(ctx)
    return (_map(lambda p: torch.empty_like(p, device=META),
                 model.param_tree()), model._axes_tree)


def abstract_opt_state(opt: AdamW, params_shapes, axes, ctx):
    _no_mesh(ctx)
    return opt.init(params_shapes)


def abstract_caches(model: Model, batch_size: int, max_len: int, ctx,
                    cache_dtype=None):
    _no_mesh(ctx)
    shapes = Model(model.cfg, device=META).init_cache(
        batch_size, max_len, cache_dtype=cache_dtype)
    return shapes, cache_axes_tree(shapes)


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
