"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained experts — 64 routed
top-6 + 2 shared (d_ff 1408 each); first layer is a dense FFN (d_ff
10944); 28L, GQA kv=16(MHA), vocab 102400."""
from repro_torch.lm.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400,
    mlp_act="swiglu", pos="rope",
    moe=MoEConfig(num_experts=64, top_k=6, d_expert_ff=1408,
                  num_shared=2, d_shared_ff=1408,
                  first_dense_layers=1, first_dense_d_ff=10944),
)
