"""Architecture registry: --arch <id> lookup + reduced smoke variants.

The port serves the dense attention archs; the other families of
``repro.configs`` (MoE, SSM, hybrid, encoder) arrive with their model code.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .base import ModelConfig

from . import deepseek_7b, glm4_9b, qwen3_14b

ARCHS = {
    "glm4-9b": glm4_9b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
}


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the same reduction as
    ``repro.configs.registry.smoke_config`` for the dense archs: GQA ratio
    and qk-norm kept, width/depth/vocab shrunk)."""
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
    return dataclasses.replace(cfg, **kw)
