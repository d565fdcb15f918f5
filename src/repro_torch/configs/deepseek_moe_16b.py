"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6
(arXiv:2401.06066). 28L, d_model=2048, 16 heads (kv=16, MHA), expert d_ff=1408,
vocab=102400.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    block="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102400,
    moe=MoEConfig(n_experts=64, top_k=6, expert_ff=1408, n_shared=2),
    act="swiglu",
    norm="rms",
)
