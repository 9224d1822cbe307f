"""Model / shape / run configuration dataclasses.

One ``ModelConfig`` covers every assigned architecture family (dense,
MoE, enc-dec, VLM, SSM, hybrid) — family-specific sub-configs are
optional fields. ``reduced()`` derives the CPU smoke-test variant.
"""
from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert_ff: int
    num_shared: int = 0              # shared (always-on) experts
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    moe_period: int = 1              # MoE FFN every `period` layers
    first_dense_layers: int = 0      # leading dense-FFN layers (deepseek)
    first_dense_d_ff: int = 0
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style layer pattern: period of `period` layers with attention
    at index `attn_index`, Mamba elsewhere."""
    period: int = 8
    attn_index: int = 4


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder; the conv/audio frontend is a stub —
    ``input_specs`` supplies precomputed frame embeddings."""
    n_layers: int = 24
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|enc_dec|vlm|ssm|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 => d_model // n_heads
    mlp_act: str = "swiglu"          # swiglu|geglu|relu2
    pos: str = "rope"                # rope|sinusoidal|learned|none
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    hybrid: HybridConfig | None = None
    encoder: EncoderConfig | None = None
    n_patches: int = 0               # VLM stub prefix length
    xlstm_pattern: str = ""          # e.g. "ms" = alternate mLSTM/sLSTM
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "bfloat16"
    remat: bool = True
    # logical->physical sharding rule-set name (sharding/specs.py)
    sharding_rules: str = "default"
    subquadratic: bool = False       # supports long_500k decode
    # beyond-paper optimization flags (EXPERIMENTS.md §Perf):
    #   moe_grouped   — group-local MoE routing (no global sort collectives)
    #   attn_chunked  — online-softmax attention at train/prefill lengths
    #   chunked_ce    — CE loss over vocab chunks (no (B,S,V) logits buffer)
    #   scan_unroll   — unroll recurrent scans (mamba/xlstm) to cut carry traffic
    opts: tuple = ()

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        red = dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if self.hybrid is None else self.hybrid.period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab=512,
            dtype="float32",
            param_dtype="float32",
            remat=False,
        )
        if self.moe is not None:
            red = dataclasses.replace(red, moe=dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert_ff=32,
                d_shared_ff=32 if self.moe.num_shared else 0,
                first_dense_d_ff=64 if self.moe.first_dense_layers else 0))
        if self.mamba is not None:
            red = dataclasses.replace(red, mamba=dataclasses.replace(
                self.mamba, d_state=4))
        if self.encoder is not None:
            red = dataclasses.replace(red, encoder=dataclasses.replace(
                self.encoder, n_layers=2, n_frames=16))
        if self.n_patches:
            red = dataclasses.replace(red, n_patches=8)
        return red


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell: (kind, seq_len, global_batch)."""
    name: str
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch × shape) runs; reason recorded in EXPERIMENTS.md."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 512k-token KV decode is not the "
                       "sub-quadratic regime this shape targets (DESIGN.md §4)")
    return True, ""
