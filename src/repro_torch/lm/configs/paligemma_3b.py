"""PaliGemma-3B backbone [arXiv:2407.07726]: SigLIP frontend (stubbed as
precomputed patch embeddings) + Gemma-2B-class decoder. MQA (kv=1),
head_dim 256, GeGLU, tied embeddings, prefix-LM attention over patches."""
from repro_torch.lm.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    mlp_act="geglu", pos="rope", tie_embeddings=True,
    n_patches=256,
)
