"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
(arXiv:2405.21060). 48L, d_model=2048, ssm_state=128, vocab=50280.
d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSM heads, 1 group, conv width 4.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    block="mamba2",
    n_layers=48,
    d_model=2048,
    n_heads=1,  # attention-free; unused
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, conv_width=4, expansion=2, head_dim=64, n_groups=1, chunk=128),
    act="swiglu",
    norm="rms",
    tie_embeddings=True,
)
