"""Model / shape configuration schema (the port's own copy of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoEConfig", "SSMConfig", "HymbaConfig", "ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0  # shared (always-on) experts, DeepSeek-MoE style
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    conv_width: int = 4
    expansion: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HymbaConfig:
    n_meta_tokens: int = 128
    swa_window: int = 1024
    # Layer indices using global (full) attention; the rest use sliding window.
    global_layers: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    block: str  # 'dense' | 'moe' | 'mamba2' | 'hymba'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    causal: bool = True  # False = encoder-only (no decode step)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # M-RoPE (t, h, w)
    act: str = "swiglu"  # 'swiglu' | 'gelu'
    norm: str = "rms"  # 'rms' | 'ln'
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hymba: Optional[HymbaConfig] = None
    frontend: Optional[str] = None  # None | 'audio' | 'vision' (stub embeddings)
    norm_eps: float = 1e-6
    # Execution knobs (not architecture):
    remat: bool = True
    attn_chunk: int = 1024  # KV chunk for online-softmax attention
    causal_skip: bool = False  # skip fully-masked KV chunks (perf opt)
    kv_bits: Optional[int] = None  # int8 KV cache (decode memory-roofline opt)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return (self.ssm.expansion * self.d_model) if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return (self.d_inner // self.ssm.head_dim) if self.ssm else 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = 0
        if self.block in ("dense",):
            per_layer = attn + mlp
        elif self.block == "moe":
            m = self.moe
            e_mlp = 3 * d * m.expert_ff
            per_layer = attn + (m.n_experts + m.n_shared) * e_mlp + d * m.n_experts
        elif self.block == "mamba2":
            di, s = self.d_inner, self.ssm
            conv_dim = di + 2 * s.n_groups * s.d_state
            per_layer = (
                d * (2 * di + 2 * s.n_groups * s.d_state + self.ssm_heads)
                + conv_dim * s.conv_width
                + di * d
            )
        elif self.block == "hymba":
            di, s = self.d_inner, self.ssm
            conv_dim = di + 2 * s.n_groups * s.d_state
            ssm_p = (
                d * (2 * di + 2 * s.n_groups * s.d_state + self.ssm_heads)
                + conv_dim * s.conv_width
                + di * d
            )
            per_layer = attn + ssm_p + mlp
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb

    def active_param_count(self) -> int:
        """Active params per token (= param_count for dense; MoE counts top-k)."""
        if self.block != "moe":
            return self.param_count()
        d, m = self.d_model, self.moe
        attn = (
            d * (self.n_heads * self.hd)
            + 2 * d * (self.n_kv_heads * self.hd)
            + (self.n_heads * self.hd) * d
        )
        e_mlp = 3 * d * m.expert_ff
        per_layer = attn + (m.top_k + m.n_shared) * e_mlp + d * m.n_experts
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
