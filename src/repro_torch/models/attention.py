"""Grouped-query attention (the port of ``repro.models.attention``, dense
causal layers): RoPE, qk-norm, prefill attention with a paged-prefix key
side, and paged decode attention through the fused kernel.

Prefill attention is plain PyTorch, as it is plain XLA in the reference
(no Pallas kernel): the same online-softmax recurrence over KV chunks, in
float32 with bfloat16 operands. Decode attention is one call of
``kernels.ops.paged_attention`` per layer: the CUDA kernel appends the new
K/V rows into their pages and attends over the lane's pages.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import dense, rms_norm

__all__ = ["attention_params_shape", "apply_rope", "attention", "attention_decode"]

NEG_INF = -1e30


def _rope_angles(positions: torch.Tensor, hd: int, theta: float) -> torch.Tensor:
    """positions: [..., S] -> [..., S, hd/2] f32 angles."""
    half = hd // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    return positions[..., None].to(torch.float32) * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S]."""
    hd = x.shape[-1]
    ang = _rope_angles(positions, hd, theta)  # [B, S, hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_params_shape(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    shapes = {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


def _pick_chunk(sk: int, want: int) -> int:
    """Largest divisor of sk that is <= want (uniform KV chunks)."""
    c = min(want, sk)
    while sk % c:
        c -= 1
    return c


def _flash_over_kv(q, k, v, q_pos, chunk: int, n_prefix: int) -> torch.Tensor:
    """Causal online-softmax attention. q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd]
    -> [B,Sq,H,hd] f32. Keys below ``n_prefix`` (a cached prompt prefix)
    are visible to every query; ``q_pos`` are the queries' key-axis
    positions."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    chunk = _pick_chunk(sk, chunk)
    # Operands stay in the compute dtype; products accumulate in f32 (the
    # bf16 values are widened exactly).
    qf = (q.to(torch.float32) * (hd ** -0.5)).to(q.dtype)
    qf = qf.reshape(b, sq, kv, rep, hd).to(torch.float32)
    acc = torch.zeros((b, sq, kv, rep, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, kv, rep), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kv, rep), dtype=torch.float32, device=q.device)
    for j in range(sk // chunk):
        kj = k[:, j * chunk : (j + 1) * chunk].to(torch.float32)
        vj = v[:, j * chunk : (j + 1) * chunk]
        k_pos = j * chunk + torch.arange(chunk, device=q.device)
        vis = (q_pos[:, None] - k_pos[None, :] >= 0) | (k_pos[None, :] < n_prefix)
        s = torch.einsum("bqgrd,bkgd->bqgrk", qf, kj)
        s = s + torch.where(vis, 0.0, NEG_INF)[None, :, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum(
            "bqgrk,bkgd->bqgrd", p.to(vj.dtype).to(torch.float32), vj.to(torch.float32)
        )
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, h, hd)


def attention(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    mode: str,
    kv_prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_kv: bool = False,
):
    """Full-sequence causal attention. x: [B, S, d]; positions: [B, S];
    ``mode`` is the quantized-matmul mode (see ``layers.dense``).
    ``kv_prefix`` ([B, M, KV, hd] K and V of an already-prefilled prompt
    prefix) is concatenated on the key side; ``return_kv`` also returns
    this call's post-RoPE K/V for the page writes."""
    b, s, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(params["wq"], x, mode=mode, name="attn_q").reshape(b, s, h, hd)
    k = dense(params["wk"], x, mode=mode, name="attn_k").reshape(b, s, kvh, hd)
    v = dense(params["wv"], x, mode=mode, name="attn_v").reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kq, vq = k, v
    q_pos = torch.arange(s, device=x.device)
    n_prefix = 0
    if kv_prefix is not None:
        pk, pv = kv_prefix
        n_prefix = pk.shape[1]
        kq = torch.cat([pk.to(k.dtype), k], dim=1)
        vq = torch.cat([pv.to(v.dtype), v], dim=1)
        q_pos = q_pos + n_prefix
    out = _flash_over_kv(q, kq, vq, q_pos, cfg.attn_chunk, n_prefix)
    out = out.to(x.dtype).reshape(b, s, h * hd)
    y = dense(params["wo"], out, mode=mode, name="attn_o")
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(
    params,
    x: torch.Tensor,
    pool,
    pos: torch.Tensor,
    cfg: ModelConfig,
    *,
    table: torch.Tensor,
    mode: str,
):
    """Paged decode attention. x: [B, Q, d]; pos: [B] int32 position of each
    lane's first query token; ``pool`` is this layer's page pool and
    ``table`` the [B, T] block table. The Q new K/V rows are appended into
    their pages and query ``j`` attends over positions ``<= pos + j``, in
    one ``paged_attention`` call. Returns (y [B, Q, d], pool)."""
    b, qn, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(params["wq"], x, mode=mode, name="attn_q").reshape(b, qn, h, hd)
    k = dense(params["wk"], x, mode=mode, name="attn_k").reshape(b, qn, kvh, hd)
    v = dense(params["wv"], x, mode=mode, name="attn_v").reshape(b, qn, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    qpos = pos.long()[:, None] + torch.arange(qn, device=x.device)[None, :]
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    out, new_pool = kops.paged_attention(
        pool, table, pos, q.contiguous(), k.contiguous(), v.contiguous()
    )
    out = out.to(x.dtype).reshape(b, qn, h * hd)
    return dense(params["wo"], out, mode=mode, name="attn_o"), new_pool
