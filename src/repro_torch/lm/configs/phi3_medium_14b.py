"""Phi-3-medium 14B [arXiv:2404.14219]: 40L d5120 40H GQA kv=10,
RoPE + SwiGLU, d_ff 17920, vocab 100352."""
from repro_torch.lm.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352,
    mlp_act="swiglu", pos="rope",
)
