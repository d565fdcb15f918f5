"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
(hf:microsoft/Phi-3.5-MoE-instruct). 32L, d_model=4096, 32 heads (GQA kv=8),
expert d_ff=6400, vocab=32064.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    block="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    moe=MoEConfig(n_experts=16, top_k=2, expert_ff=6400, n_shared=0),
    act="swiglu",
    norm="rms",
)
