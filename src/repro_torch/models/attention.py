"""Grouped-query attention (the port of ``repro.models.attention``, causal
layers): RoPE, qk-norm, prefill attention with a cached-prefix key side,
paged decode attention through the fused kernel, and decode attention on
the unpaged engine's dense per-lane cache.

Prefill attention is plain PyTorch, as it is plain XLA in the reference
(no Pallas kernel): the same online-softmax recurrence over KV chunks, in
float32 with bfloat16 operands. Paged decode attention is one call of
``kernels.ops.paged_attention`` per layer: the CUDA kernel appends the new
K/V rows into their pages and attends over the lane's pages. Decode
attention on the dense cache (:func:`init_kv_cache`; a ring buffer on a
sliding-window layer, with hymba's meta keys before the sequence) is the
reference's XLA code spelled in torch ops: a float32 cache attends in
float32, an int8 cache quantizes q and the folded softmax weights per row
and takes two integer dots, each summed exactly (:func:`int_dot`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..kernels.paged_attention import quant_rows
from .layers import dense, rms_norm

__all__ = [
    "attention_params_shape",
    "apply_rope",
    "attention",
    "attention_decode",
    "init_kv_cache",
    "int_dot",
]

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


def _flash_over_kv(q, k, v, q_pos, chunk: int, n_prefix: int,
                   prefix_real: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal online-softmax attention. q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd]
    -> [B,Sq,H,hd] f32. Keys below ``n_prefix`` (a cached prompt prefix)
    are visible to every query; ``q_pos`` are the queries' key-axis
    positions. ``prefix_real`` (a scalar tensor): the real length of a
    padded prefix, whose keys in ``[prefix_real, n_prefix)`` no query
    sees."""
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
        if prefix_real is not None:  # a padded prefix: its pad rows are never seen
            vis = vis & ~((k_pos[None, :] >= prefix_real) & (k_pos[None, :] < n_prefix))
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
    prefix_len: Optional[torch.Tensor] = None,
    return_kv: bool = False,
):
    """Full-sequence causal attention. x: [B, S, d]; positions: [B, S];
    ``mode`` is the quantized-matmul mode (see ``layers.dense``).
    ``kv_prefix`` ([B, M, KV, hd] K and V of an already-prefilled prompt
    prefix) is concatenated on the key side; ``prefix_len`` (a scalar
    tensor) is its real length when it is padded (chunked prefill on the
    dense cache), and its rows past that are masked out; ``return_kv``
    also returns this call's post-RoPE K/V for the cache writes."""
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
    out = _flash_over_kv(q, kq, vq, q_pos, cfg.attn_chunk, n_prefix,
                         prefix_len if kv_prefix is not None else None)
    out = out.to(x.dtype).reshape(b, s, h * hd)
    y = dense(params["wo"], out, mode=mode, name="attn_o")
    if return_kv:
        return y, (k, v)
    return y


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
                  dtype=torch.float32, *, device=None):
    """One layer's dense decode cache: K and V ``[B, KV, S_cache, hd]`` in
    ``dtype``, or int8 with one float32 scale per row and KV head
    (``k_scale``/``v_scale`` ``[B, KV, S_cache]``) when ``cfg.kv_bits ==
    8``. A sliding-window layer (``window > 0``) keeps a ring buffer of
    ``min(max_len, window)`` rows."""
    s = min(max_len, window) if window else max_len
    shape = (batch, cfg.n_kv_heads, s, cfg.hd)
    if cfg.kv_bits is not None:
        if cfg.kv_bits != 8:
            raise NotImplementedError("kv_bits: the dense cache has only the int8 layout")
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def int_dot(eq: str, a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """An einsum of two int8 tensors summed exactly, as int32. PyTorch has
    no integer einsum on CUDA, and a float32 sum of ``127 * 127 * S``
    products is exact only below 2^24, so the products are summed in
    float64 (exact below 2^53) on every device: the same int32 result on
    the card and the CPU."""
    return torch.einsum(eq, a8.to(torch.float64), b8.to(torch.float64)).to(torch.int32)


def _decode_dense(q, k, v, cache, pos, cfg: ModelConfig, window: int, kv_prefix):
    """The dense-cache half of :func:`attention_decode` at Q = 1: write the
    new rows at each lane's slot (``pos % S_cache`` on a ring buffer, else
    ``min(pos, S_cache - 1)``, in place), then attend. Returns (out [B, 1,
    H, hd] f32, the cache)."""
    b, qn, h, hd = q.shape
    kvh = cfg.n_kv_heads
    rep = h // kvh
    int8_cache = cache["k"].dtype == torch.int8
    s_cache = cache["k"].shape[2]
    k_t = k.transpose(1, 2)  # [B, KV, 1, hd]
    v_t = v.transpose(1, 2)
    pos_l = pos.long()
    slot = torch.remainder(pos_l, s_cache) if window else torch.clamp_max(pos_l, s_cache - 1)
    lanes = torch.arange(b, device=q.device)
    new = cache  # written in place, as the page pools are on the card
    if int8_cache:
        k_q, k_s = quant_rows(k_t[:, :, 0])
        v_q, v_s = quant_rows(v_t[:, :, 0])
        new["k"][lanes, :, slot] = k_q
        new["v"][lanes, :, slot] = v_q
        new["k_scale"][lanes, :, slot] = k_s
        new["v_scale"][lanes, :, slot] = v_s
    else:
        new["k"][lanes, :, slot] = k_t[:, :, 0].to(cache["k"].dtype)
        new["v"][lanes, :, slot] = v_t[:, :, 0].to(cache["v"].dtype)
    ck, cv = new["k"], new["v"]

    qpos = pos_l[:, None] + torch.arange(qn, device=q.device)[None, :]  # [B, Q]
    idx = torch.arange(s_cache, device=q.device)
    # Slot i is visible to query j iff i <= pos + j; a full ring (pos >=
    # S_cache on a window layer) is all valid.
    valid = idx[None, None, :] <= qpos[:, :, None]
    if window:
        valid = valid | (qpos[:, :, None] >= s_cache)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    f32 = torch.float32
    if int8_cache:
        qf = (q.to(f32) * (hd ** -0.5)).reshape(b, qn, kvh, rep, hd)
        q8, q_s = quant_rows(qf)
        s32 = int_dot("bqgrd,bgsd->bqgrs", q8, ck)
        s = s32.to(f32) * q_s[..., None] * new["k_scale"][:, None, :, None, :]
    else:
        qf = (q.to(f32) * (hd ** -0.5)).to(ck.dtype).reshape(b, qn, kvh, rep, hd)
        s = torch.einsum("bqgrd,bgsd->bqgrs", qf.to(f32), ck.to(f32))
    s = s + bias[:, :, None, None, :]
    if kv_prefix is not None:
        pk = kv_prefix[0]  # meta prefix keys [B, M, KV, hd]
        sp = torch.einsum("bqgrd,bmgd->bqgrm", qf.to(f32), pk.to(ck.dtype).to(f32))
        s = torch.cat([sp, s], dim=-1)
    p = torch.softmax(s.to(f32), dim=-1)

    def pv(p_seq):
        if not int8_cache:
            return torch.einsum("bqgrs,bgsd->bqgrd", p_seq.to(cv.dtype).to(f32), cv.to(f32))
        # Fold the per-row v scales into p, then quantize it per row: one
        # integer dot, exact since sum_s p[s] v8[s] vs[s] = (p * vs) . v8.
        p_fold = p_seq * new["v_scale"][:, None, :, None, :]
        p8, p_s = quant_rows(p_fold)
        return int_dot("bqgrs,bgsd->bqgrd", p8, cv).to(f32) * p_s[..., None]

    if kv_prefix is not None:
        m = kv_prefix[0].shape[1]
        pvx = kv_prefix[1]
        out = torch.einsum("bqgrm,bmgd->bqgrd", p[..., :m].to(pvx.dtype).to(f32), pvx.to(f32))
        out = out + pv(p[..., m:])
    else:
        out = pv(p)
    return out.reshape(b, qn, h, hd), new


def attention_decode(
    params,
    x: torch.Tensor,
    cache,
    pos: torch.Tensor,
    cfg: ModelConfig,
    *,
    table: Optional[torch.Tensor] = None,
    mode: str,
    window: int = 0,
    kv_prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Decode attention. x: [B, Q, d]; pos: [B] int32 position of each
    lane's first query token. Returns (y [B, Q, d], new cache).

    With ``table`` (the [B, T] block table) ``cache`` is this layer's page
    pool: the Q new K/V rows are appended into their pages and query ``j``
    attends over positions ``<= pos + j``, in one ``paged_attention`` call
    (the pool is written in place on the card).

    Without it ``cache`` is the dense per-lane cache of
    :func:`init_kv_cache` (the unpaged engine), at Q = 1: the new row is
    written in place at slot ``pos % S_cache`` of a sliding-window layer's
    ring buffer (``window > 0``) or at ``min(pos, S_cache - 1)``, and ``kv_prefix``
    (hymba's meta K/V ``[B, M, KV, hd]``) is attended before the sequence.
    """
    b, qn, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if table is None and qn != 1:
        raise NotImplementedError(
            "multi-token decode on the dense cache (speculation on the unpaged "
            "engine): ROADMAP A16")
    q = dense(params["wq"], x, mode=mode, name="attn_q").reshape(b, qn, h, hd)
    k = dense(params["wk"], x, mode=mode, name="attn_k").reshape(b, qn, kvh, hd)
    v = dense(params["wv"], x, mode=mode, name="attn_v").reshape(b, qn, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    qpos = pos.long()[:, None] + torch.arange(qn, device=x.device)[None, :]
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    if table is None:
        out, new_cache = _decode_dense(q, k, v, cache, pos, cfg, window, kv_prefix)
    else:
        if window or kv_prefix is not None:
            raise NotImplementedError(
                "paged KV cache: sliding-window layers and meta keys keep the dense "
                "cache (hymba serves unpaged)")
        out, new_cache = kops.paged_attention(
            cache, table, pos, q.contiguous(), k.contiguous(), v.contiguous()
        )
    out = out.to(x.dtype).reshape(b, qn, h * hd)
    return dense(params["wo"], out, mode=mode, name="attn_o"), new_cache
