"""Whisper-medium [arXiv:2212.04356]: 24-layer encoder (conv/audio
frontend stubbed: input_specs supplies 1500 frame embeddings) + 24-layer
decoder with cross-attention. MHA (kv=16), GELU MLP, sinusoidal positions,
attention biases, tied embeddings."""
from repro_torch.lm.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="enc_dec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865,
    mlp_act="gelu", pos="sinusoidal", attn_bias=True, tie_embeddings=True,
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
)
