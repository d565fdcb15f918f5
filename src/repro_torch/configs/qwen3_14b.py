"""qwen3-14b [dense] — qk_norm, GQA kv=8 (hf:Qwen/Qwen3-14B family).
40L, d_model=5120, 40 heads, d_ff=17408, vocab=151936.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    block="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    act="swiglu",
    norm="rms",
)
