"""hymba-1.5b [hybrid] — parallel attention + Mamba heads (arXiv:2411.13676).

32L, d_model=1600, 25 heads (GQA kv=5, head_dim 64), d_ff=5504, vocab=32001,
ssm_state=16; 128 meta tokens, sliding-window attention with 3 global-attention
layers (first / middle / last, per the paper).
"""
from .base import HymbaConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    block="hymba",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    # chunk=64: SSD quadratic intermediates scale with chunk length; 64
    # measured ~6% lower memory roofline than 128 on train_4k (EXPERIMENTS §Perf).
    ssm=SSMConfig(d_state=16, conv_width=4, expansion=2, head_dim=64, n_groups=1, chunk=64),
    hymba=HymbaConfig(n_meta_tokens=128, swa_window=1024, global_layers=(0, 15, 31)),
    act="swiglu",
    norm="rms",
)
