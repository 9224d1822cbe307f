"""Jamba-v0.1 52B [arXiv:2403.19887]: 32L in periods of 8 — attention at
period index 4, Mamba elsewhere (1:7); MoE (16 experts top-2, d_ff 14336)
every other layer. GQA kv=8, vocab 65536. Hybrid => long_500k eligible."""
from repro_torch.lm.configs.base import HybridConfig, MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    mlp_act="swiglu", pos="none",  # jamba uses no positional encoding
    moe=MoEConfig(num_experts=16, top_k=2, d_expert_ff=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    hybrid=HybridConfig(period=8, attn_index=4),
    subquadratic=True,
)
