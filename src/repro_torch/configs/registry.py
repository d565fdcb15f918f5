"""Architecture registry: --arch <id> lookup + reduced smoke variants.

The port's own copies of the reference's ten configs: the dense and MoE
attention decoders (qwen2-vl-7b with M-RoPE), the SSM decoder
(mamba2-1.3b), the hybrid one (hymba-1.5b), all served, and the encoder
(hubert-xlarge), run through ``models.transformer.forward``.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .base import HymbaConfig, ModelConfig, MoEConfig, SSMConfig

from . import (
    deepseek_7b,
    deepseek_moe_16b,
    glm4_9b,
    hubert_xlarge,
    hymba_1p5b,
    mamba2_1p3b,
    minitron_8b,
    phi35_moe_42b,
    qwen2_vl_7b,
    qwen3_14b,
)

ARCHS = {
    "glm4-9b": glm4_9b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "qwen2-vl-7b": qwen2_vl_7b.CONFIG,
    "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.CONFIG,
    "mamba2-1.3b": mamba2_1p3b.CONFIG,
    "hymba-1.5b": hymba_1p5b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
}


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the same reduction as
    ``repro.configs.registry.smoke_config``: GQA ratio, qk-norm, top-k
    routing, the SSD recurrence, meta tokens and the sliding window,
    M-RoPE and encoder-ness kept, width/depth/vocab, the expert count, the
    SSM state, the window and the M-RoPE sections shrunk; hubert's MHA at
    4 heads)."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        head_dim=16,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=256,
        attn_chunk=32,
        remat=False,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=8,
            top_k=min(cfg.moe.top_k, 3),
            expert_ff=32,
            n_shared=min(cfg.moe.n_shared, 1),
        )
        kw["d_ff"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(
            d_state=16, conv_width=4, expansion=2, head_dim=16, n_groups=1, chunk=16
        )
    if cfg.hymba is not None:
        kw["hymba"] = HymbaConfig(n_meta_tokens=8, swa_window=32, global_layers=(0,))
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (2, 3, 3)  # sums to head_dim/2 = 8
    if cfg.name.startswith("hubert"):
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 4
    return dataclasses.replace(cfg, **kw)
