"""Qwen3-32B [hf:Qwen/Qwen3-8B family]: 64L d5120 64H GQA kv=8,
head_dim 128, qk-norm, d_ff 25600, vocab 151936."""
from repro_torch.lm.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936,
    mlp_act="swiglu", pos="rope", rope_theta=1e6, qk_norm=True,
)
