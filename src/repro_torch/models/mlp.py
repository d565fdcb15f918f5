"""Feed-forward block: SwiGLU (the port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import dense, swiglu

__all__ = ["mlp_params_shape", "mlp"]


def mlp_params_shape(cfg: ModelConfig, d_ff: int = 0):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r}: the port has swiglu (ROADMAP A13)")
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def mlp(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str) -> torch.Tensor:
    g = dense(params["w_gate"], x, mode=mode, name="mlp_gate")
    u = dense(params["w_up"], x, mode=mode, name="mlp_up")
    return dense(params["w_down"], swiglu(g, u), mode=mode, name="mlp_down")
