"""Feed-forward blocks (the port of ``repro.models.mlp``): SwiGLU
(LLaMA-family) and GELU (encoder-family; any ``act`` other than
``"swiglu"``, as in the reference)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import dense, gelu, swiglu

__all__ = ["mlp_params_shape", "mlp"]


def mlp_params_shape(cfg: ModelConfig, d_ff: int = 0):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return {"w_in": (d, f), "w_out2": (f, d)}


def mlp(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str) -> torch.Tensor:
    if cfg.act == "swiglu":
        g = dense(params["w_gate"], x, mode=mode, name="mlp_gate")
        u = dense(params["w_up"], x, mode=mode, name="mlp_up")
        return dense(params["w_down"], swiglu(g, u), mode=mode, name="mlp_down")
    h = gelu(dense(params["w_in"], x, mode=mode, name="mlp_in"))
    return dense(params["w_out2"], h, mode=mode, name="mlp_out")
