"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191;
hf:Qwen/Qwen2-VL-7B-Instruct). 28L, d_model=3584, 28 heads (GQA kv=4),
d_ff=18944, vocab=152064. The vision frontend is a stub:
``transformer.forward(embeds=...)`` takes precomputed patch embeddings;
the backbone is the text transformer with M-RoPE sections (16, 24, 24)
over head_dim/2 = 64 frequency slots. The serving engine serves text
tokens (one position in all three streams).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    block="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    act="swiglu",
    norm="rms",
)
