"""xLSTM-125M [arXiv:2405.04517]: 12 blocks alternating mLSTM (matrix
memory, chunked linear attention) and sLSTM (scalar recurrence); d_ff=0
(no FFN blocks), 4 heads, vocab 50304. Recurrent state => O(1) decode =>
eligible for long_500k."""
from repro_torch.lm.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304,
    pos="none", xlstm_pattern="ms",
    subquadratic=True,
)
