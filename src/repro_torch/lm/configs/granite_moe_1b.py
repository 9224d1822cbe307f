"""Granite-3.0-1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L, 32 experts top-8, per-expert d_ff 512, GQA kv=8, tied embeddings."""
from repro_torch.lm.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    mlp_act="swiglu", pos="rope", tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert_ff=512),
)
