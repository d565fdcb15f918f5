"""Mamba2 (SSD, state-space duality) block: the chunked scan over a whole
sequence and the O(1) decode step (the port of ``repro.models.ssm``).

Within chunks of length Q the recurrence runs in its quadratic dual form;
across chunks a short loop carries the ``[heads, head_dim, d_state]`` SSM
state. Decode is a pure O(1) state update. The projections
(``in_proj``/``out_proj``) go through :func:`layers.dense` in the caller's
matmul mode, so they are the quantized GEMM kernels' (B4/B5, B1 or B6) on
the card; the recurrence, the depthwise conv and the gated norm are plain
PyTorch, as they are plain XLA in the reference (no Pallas kernel).

The numerics follow the reference's: the state and every recurrence sum in
float32, the conv window in the cache's dtype, ``y`` rounded to the
activation dtype before the gated ``rms_norm``, and the intra-chunk decay's
exponent masked before ``exp`` (masking after it gives ``inf * 0``).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from .layers import dense, rms_norm, silu

__all__ = [
    "ssm_params_shape",
    "mamba2",
    "mamba2_decode",
    "init_ssm_cache",
]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = cfg.d_inner
    heads = cfg.ssm_heads
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, heads, conv_dim


def ssm_params_shape(cfg: ModelConfig) -> Dict:
    s, d_in, heads, conv_dim = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + heads  # z, xBC, dt
    return {
        "in_proj": (d, proj_out),
        "conv_w": (conv_dim, s.conv_width),
        "conv_b": (conv_dim,),
        "A_log": (heads,),
        "D": (heads,),
        "dt_bias": (heads,),
        "norm_scale": (d_in,),
        "out_proj": (d_in, d),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it:
    ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, C]; w: [C, W]. The products take
    ``w``'s dtype (float32 for a bfloat16 x, as in the reference)."""
    width = w.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for j in range(width):  # the conv width (4)
        out = out + pad[:, j : j + x.shape[1], :] * w[:, j]
    return out + b


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s, d_in, _heads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : d_in + d_in + 2 * gn]
    dt = zxbcdt[..., d_in + d_in + 2 * gn :]
    return z, xbc, dt


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD. x: [b, s, h, p]; dt: [b, s, h]; A: [h]; B, C: [b, s, g,
    n] -> (y [b, s, h, p] in x's dtype, final state [b, g, r, p, n] f32).
    Heads are grouped, h = g * r; the chunk is the largest divisor of s
    that is at most ``chunk``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    q = min(chunk, s)
    while s % q:
        q -= 1
    c = s // q
    f32 = torch.float32

    xf = x.to(f32).reshape(b, c, q, g, r, p)
    dtf = dt.to(f32).reshape(b, c, q, g, r)
    Bf = B.to(f32).reshape(b, c, q, g, n)
    Cf = C.to(f32).reshape(b, c, q, g, n)
    dA = dtf * A.to(f32).reshape(g, r)  # [b, c, q, g, r]
    cum = torch.cumsum(dA, dim=2)

    # Intra-chunk (the quadratic dual form): scores over (query i, key j <= i).
    S = torch.einsum("bcqgn,bckgn->bcqkg", Cf, Bf)
    diff = cum[:, :, :, None] - cum[:, :, None, :]  # [b, c, q, k, g, r]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None, None], diff,
                                  torch.tensor(float("-inf"), device=x.device)))
    y_diag = torch.einsum("bcqkg,bcqkgr,bckgr,bckgrp->bcqgrp", S, decay, dtf, xf)

    # Each chunk's contribution to the carried state.
    decay_states = torch.exp(cum[:, :, -1:] - cum)  # [b, c, q, g, r]
    states = torch.einsum("bckgn,bckgr,bckgrp->cbgrpn", Bf, dtf * decay_states, xf)
    chunk_decay = torch.exp(cum[:, :, -1].movedim(1, 0))  # [c, b, g, r]

    carry = torch.zeros((b, g, r, p, n), dtype=f32, device=x.device)
    prev = []
    for i in range(c):
        prev.append(carry)  # the state entering chunk i
        carry = carry * chunk_decay[i][..., None, None] + states[i]
    prev_states = torch.stack(prev)  # [c, b, g, r, p, n]

    # Inter-chunk output: queries read the state entering their chunk.
    y_off = torch.einsum("bcqgn,cbgrpn,bcqgr->bcqgrp", Cf, prev_states, torch.exp(cum))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def mamba2(params, u: torch.Tensor, cfg: ModelConfig, *, mode: str = "dequant",
           return_state: bool = False):
    """Full-sequence Mamba2 block. u: [B, S, d] -> [B, S, d] (and the final
    SSM state with ``return_state``)."""
    s_cfg, d_in, heads, _ = _dims(cfg)
    b, s, _ = u.shape
    zxbcdt = dense(params["in_proj"], u, mode=mode, name="ssm_in")
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc = silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    gn = s_cfg.n_groups * s_cfg.d_state
    x = xbc[..., :d_in].reshape(b, s, heads, s_cfg.head_dim)
    B = xbc[..., d_in : d_in + gn].reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    C = xbc[..., d_in + gn :].reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    dt = softplus(dt.to(torch.float32) + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["A_log"].to(torch.float32))
    y, state = _ssd_chunked(x, dt, A, B, C, s_cfg.chunk)
    y = (y.to(torch.float32)
         + params["D"].to(torch.float32).reshape(heads, 1) * x.to(torch.float32)).to(u.dtype)
    y = y.reshape(b, s, d_in)
    y = rms_norm(params["norm_scale"], y * silu(z), cfg.norm_eps)
    out = dense(params["out_proj"], y, mode=mode, name="ssm_out")
    if return_state:
        return out, state
    return out


# ---------------------------------------------------------------------------
# Decode


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *, device=None):
    """One layer's decode state: the float32 SSM state ``[B, g, r, p, n]``
    and the conv window's last ``conv_width - 1`` inputs ``[B, W-1, C]`` in
    ``dtype``."""
    s, _d_in, heads, conv_dim = _dims(cfg)
    return {
        "state": torch.zeros(
            (batch, s.n_groups, heads // s.n_groups, s.head_dim, s.d_state),
            dtype=torch.float32, device=device,
        ),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba2_decode(params, u: torch.Tensor, cache, cfg: ModelConfig, *, mode: str = "dequant"):
    """One-token decode, an O(1) state update. u: [B, 1, d] -> (out [B, 1,
    d], new cache)."""
    s_cfg, d_in, heads, _ = _dims(cfg)
    b = u.shape[0]
    g, r = s_cfg.n_groups, heads // s_cfg.n_groups
    f32 = torch.float32
    zxbcdt = dense(params["in_proj"], u, mode=mode, name="ssm_in")  # [B, 1, *]
    z, xbc, dt = _split_proj(zxbcdt[:, 0], cfg)
    # The depthwise conv over the rolling window.
    win = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv_out = (torch.einsum("bwc,cw->bc", win.to(f32), params["conv_w"].to(f32))
                + params["conv_b"].to(f32))
    xbc = silu(conv_out)
    gn = s_cfg.n_groups * s_cfg.d_state
    x = xbc[..., :d_in].reshape(b, g, r, s_cfg.head_dim)
    B = xbc[..., d_in : d_in + gn].reshape(b, g, s_cfg.d_state)
    C = xbc[..., d_in + gn :].reshape(b, g, s_cfg.d_state)
    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32)).reshape(b, g, r)
    A = -torch.exp(params["A_log"].to(f32)).reshape(g, r)
    dA = torch.exp(dt * A)  # [b, g, r]
    state = cache["state"] * dA[..., None, None] + torch.einsum(
        "bgn,bgr,bgrp->bgrpn", B, dt, x)
    y = torch.einsum("bgn,bgrpn->bgrp", C, state)
    y = y + params["D"].to(f32).reshape(g, r, 1) * x
    y = y.reshape(b, d_in).to(u.dtype)
    y = rms_norm(params["norm_scale"], y * silu(z).to(u.dtype), cfg.norm_eps)
    out = dense(params["out_proj"], y[:, None, :], mode=mode, name="ssm_out")
    return out, {"state": state, "conv": win[:, 1:]}
