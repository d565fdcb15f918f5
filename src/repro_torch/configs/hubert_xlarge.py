"""hubert-xlarge [audio] — encoder-only, wav2vec2-style backbone
(arXiv:2106.07447; hf:facebook/hubert-xlarge-ll60k). 48L, d_model=1280, 16
heads (MHA), d_ff=5120, vocab=504 (cluster targets). The conv feature
extractor is a stub: ``transformer.forward(embeds=...)`` takes
precomputed frame embeddings [B, T, 1280]. Encoder-only: no decode step,
no serving engine.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    block="dense",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    frontend="audio",
    act="gelu",
    norm="ln",
)
