"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]: 40L d8192 64H GQA
kv=8, d_ff 22528, vocab 256000, no biases, tied embeddings."""
from repro_torch.lm.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000,
    mlp_act="swiglu", pos="rope", rope_theta=8e6, tie_embeddings=True,
)
