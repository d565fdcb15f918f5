"""glm4-9b [dense] — RoPE, GQA kv=2 (hf:THUDM/glm-4-9b).
40L, d_model=4096, 32 heads, d_ff=13696, vocab=151552.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    block="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    act="swiglu",
    norm="rms",
)
