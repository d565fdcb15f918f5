"""minitron-8b [dense] — pruned Nemotron-4 (arXiv:2407.14679;
hf:nvidia/Minitron-8B-Base). 32L, d_model=4096, 32 heads (GQA kv=8),
d_ff=16384, vocab=256000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    block="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    act="swiglu",
    norm="rms",
)
