"""Grouped-query attention (the port of ``repro.models.attention``): RoPE
and M-RoPE, qk-norm, full-sequence attention (causal, sliding-window or
unmasked, with a cached-prefix key side), paged decode attention through
the fused kernel, and decode attention on the unpaged engine's dense
per-lane cache.

Full-sequence attention is plain PyTorch, as it is plain XLA in the
reference (no Pallas kernel): the same online-softmax recurrence over KV
chunks, in float32 with bfloat16 operands; a static sliding window skips
the key chunks no query of a query chunk sees. Paged decode attention is
one call of ``kernels.ops.paged_attention`` per layer: the CUDA kernel
appends the new K/V rows into their pages and attends over the lane's
pages. Decode attention on the dense cache (:func:`init_kv_cache`; a ring
buffer on a sliding-window layer, with hymba's meta keys before the
sequence) is the reference's XLA code spelled in torch ops: a float32
cache attends in float32, an int8 cache quantizes q and the folded softmax
weights per row and takes two integer dots, each summed exactly
(:func:`int_dot`); a speculative window of Q tokens writes its Q rows and
attends one query row at a time.
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
    "rope_positions",
    "attention",
    "attention_decode",
    "init_kv_cache",
    "int_dot",
]

NEG_INF = -1e30


def _rope_angles(positions: torch.Tensor, hd: int, theta: float,
                 sections: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """positions: [..., S] (or [..., S, 3] for M-RoPE) -> [..., S, hd/2]
    f32 angles. With ``sections`` (t, h, w) the frequency slots are owned
    by the three position streams in that order, and each slot reads the
    position of its owner (Qwen2-VL's M-RoPE)."""
    half = hd // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    if sections is None:
        return positions[..., None].to(torch.float32) * freqs
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to hd/2 = {half}")
    owner = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                    torch.tensor(sections, device=positions.device))
    return positions.to(torch.float32)[..., owner] * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S], or [B, S, 3] with M-RoPE
    ``sections``."""
    hd = x.shape[-1]
    ang = _rope_angles(positions, hd, theta, sections)  # [B, S, hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """Positions ``[B, S]`` as :func:`apply_rope` takes them for ``cfg``:
    broadcast to ``[B, S, 3]`` under M-RoPE (text tokens carry one
    position in all three streams), else unchanged."""
    if cfg.mrope_sections is None:
        return pos
    return pos[..., None].expand(pos.shape + (3,))


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


def _online_softmax_step(qf, kj, vj, bias, acc, m, l):
    """One key chunk of the flash recurrence. qf [B,Sq,KV,rep,hd] f32;
    kj, vj [B,C,KV,hd]; bias [Sq, C] (0 or NEG_INF)."""
    s = torch.einsum("bqgrd,bkgd->bqgrk", qf, kj.to(torch.float32))
    s = s + bias[None, :, None, None, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum(
        "bqgrk,bkgd->bqgrd", p.to(vj.dtype).to(torch.float32), vj.to(torch.float32)
    )
    return acc * alpha[..., None] + pv, m_new, l


def _zeros_state(qf):
    b, sq, kv, rep, hd = qf.shape
    return (torch.zeros((b, sq, kv, rep, hd), dtype=torch.float32, device=qf.device),
            torch.full((b, sq, kv, rep), NEG_INF, dtype=torch.float32, device=qf.device),
            torch.zeros((b, sq, kv, rep), dtype=torch.float32, device=qf.device))


def _window_static(qf, k, v, window: int, chunk: int, n_prefix: int) -> torch.Tensor:
    """Sliding-window attention with the invisible key chunks skipped (q
    and k chunked alike): a query chunk reads the chunks overlapping its
    window and chunk 0 (the always-visible prefix). qf [B,S,KV,rep,hd]
    (scaled, f32); k, v [B,S,KV,hd]."""
    sq = qf.shape[1]
    outs = []
    for qi in range(sq // chunk):
        q_blk = qf[:, qi * chunk:(qi + 1) * chunk]
        q_pos = qi * chunk + torch.arange(chunk, device=qf.device)
        lo = max(0, (qi * chunk - (window - 1)) // chunk)
        acc, m, l = _zeros_state(q_blk)
        for kj in sorted({0} | set(range(lo, qi + 1))):
            k_pos = kj * chunk + torch.arange(chunk, device=qf.device)
            diff = q_pos[:, None] - k_pos[None, :]
            vis = ((diff >= 0) & (diff < window)) | (k_pos[None, :] < n_prefix)
            acc, m, l = _online_softmax_step(
                q_blk, k[:, kj * chunk:(kj + 1) * chunk], v[:, kj * chunk:(kj + 1) * chunk],
                torch.where(vis, 0.0, NEG_INF), acc, m, l)
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    return torch.cat(outs, dim=1)


def _flash_over_kv(q, k, v, kind: str, q_pos, window: int, chunk: int, n_prefix: int,
                   prefix_real: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Online-softmax attention over key chunks. q: [B,Sq,H,hd]; k,v:
    [B,Sk,KV,hd] -> [B,Sq,H,hd] f32.

    ``kind``: ``"full"`` (every key visible: an encoder), ``"causal"``, or
    ``"window"`` (``0 <= q_pos - k_pos < window``); ``q_pos`` are the
    queries' positions on the key axis, and under ``causal`` and
    ``window`` the keys below ``n_prefix`` (a cached prompt prefix, or
    hymba's meta tokens) are visible to every query. ``prefix_real`` (a
    scalar tensor): the real length of a padded prefix, whose keys in
    ``[prefix_real, n_prefix)`` no query sees. A window runs over
    self-attention only (Sq == Sk, no padded prefix), skipping the key
    chunks no query of a query chunk can see (:func:`_window_static`)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    chunk = _pick_chunk(sk, chunk)
    if kind not in ("full", "causal", "window"):
        raise ValueError(f"attention kind must be full, causal or window, got {kind!r}")
    if kind == "window" and (sq != sk or prefix_real is not None):
        raise ValueError(f"window attention runs over self-attention only (Sq {sq}, Sk {sk})")
    # Operands stay in the compute dtype; products accumulate in f32 (the
    # bf16 values are widened exactly).
    qf = (q.to(torch.float32) * (hd ** -0.5)).to(q.dtype)
    qf = qf.reshape(b, sq, kv, rep, hd).to(torch.float32)
    if kind == "window":
        return _window_static(qf, k, v, window, chunk, n_prefix).reshape(b, sq, h, hd)
    acc, m, l = _zeros_state(qf)
    for j in range(sk // chunk):
        k_pos = j * chunk + torch.arange(chunk, device=q.device)
        if kind == "full":
            vis = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        else:
            vis = (q_pos[:, None] - k_pos[None, :] >= 0) | (k_pos[None, :] < n_prefix)
        if prefix_real is not None:  # a padded prefix: its pad rows are never seen
            vis = vis & ~((k_pos[None, :] >= prefix_real) & (k_pos[None, :] < n_prefix))
        acc, m, l = _online_softmax_step(
            qf, k[:, j * chunk:(j + 1) * chunk], v[:, j * chunk:(j + 1) * chunk],
            torch.where(vis, 0.0, NEG_INF), acc, m, l)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, h, hd)


def attention(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    mode: str,
    kind: str = "causal",
    window: int = 0,
    n_prefix: int = 0,
    kv_prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    prefix_len: Optional[torch.Tensor] = None,
    return_kv: bool = False,
):
    """Full-sequence attention. x: [B, S, d]; positions: [B, S] (or [B, S,
    3] under M-RoPE); ``mode`` is the quantized-matmul mode (see
    ``layers.dense``); ``kind`` and ``window`` as in
    :func:`_flash_over_kv`. ``n_prefix`` marks the first N sequence tokens
    visible to every query (hymba's meta tokens). ``kv_prefix`` ([B, M, KV,
    hd] K and V of an already-prefilled prompt prefix) is concatenated on
    the key side; ``prefix_len`` (a scalar tensor) is its real length when
    it is padded (chunked prefill on the dense cache), and its rows past
    that are masked out; ``return_kv`` also returns this call's post-RoPE
    K/V for the cache writes."""
    b, s, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(params["wq"], x, mode=mode, name="attn_q").reshape(b, s, h, hd)
    k = dense(params["wk"], x, mode=mode, name="attn_k").reshape(b, s, kvh, hd)
    v = dense(params["wv"], x, mode=mode, name="attn_v").reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    kq, vq = k, v
    q_pos = torch.arange(s, device=x.device)
    if kv_prefix is not None:
        pk, pv = kv_prefix
        n_prefix = max(n_prefix, pk.shape[1])
        kq = torch.cat([pk.to(k.dtype), k], dim=1)
        vq = torch.cat([pv.to(v.dtype), v], dim=1)
        q_pos = q_pos + pk.shape[1]
    out = _flash_over_kv(q, kq, vq, kind, q_pos, window, cfg.attn_chunk, n_prefix,
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


def _write_dense(cache, k, v, pos, window: int) -> None:
    """Write the Q new rows per lane (k, v ``[B, Q, KV, hd]``; int8 rows
    quantized per (lane, query, head) row) into the dense cache, in place:
    at ``pos % S_cache`` on a ring buffer (``window > 0``, Q = 1), else at
    ``clip(pos + j, 0, S_cache - 1)``. Rows clipped onto the last slot
    (queries past the cache, whose logits no caller commits) all carry the
    last query's row, so the repeated writes agree whatever order the card
    takes them in, and the slot ends as the reference's in-order scatter
    leaves it."""
    b, qn = k.shape[:2]
    s_cache = cache["k"].shape[2]
    pos_l = pos.long()
    if window:
        slot = torch.remainder(pos_l, s_cache)[:, None]
    else:
        slot = torch.clamp(pos_l[:, None] + torch.arange(qn, device=k.device)[None, :],
                           0, s_cache - 1)
    if qn > 1:
        last = (slot == s_cache - 1)[..., None, None]
        k = torch.where(last, k[:, -1:], k)
        v = torch.where(last, v[:, -1:], v)
    lanes = torch.arange(b, device=k.device)[:, None].expand(b, qn)
    if cache["k"].dtype == torch.int8:
        k_q, k_s = quant_rows(k)
        v_q, v_s = quant_rows(v)
        cache["k"][lanes, :, slot] = k_q
        cache["v"][lanes, :, slot] = v_q
        cache["k_scale"][lanes, :, slot] = k_s
        cache["v_scale"][lanes, :, slot] = v_s
    else:
        cache["k"][lanes, :, slot] = k.to(cache["k"].dtype)
        cache["v"][lanes, :, slot] = v.to(cache["v"].dtype)


def _attend_dense(q, qpos, cache, cfg: ModelConfig, window: int, kv_prefix):
    """One query per lane (q ``[B, 1, H, hd]`` at ``qpos`` ``[B, 1]``)
    against the dense cache: slot i is visible iff ``i <= qpos`` (a full
    ring, ``qpos >= S_cache`` on a window layer, is all valid), after
    ``kv_prefix``'s meta keys. A float32 cache attends in float32; an int8
    cache quantizes q and the folded softmax weights per row and takes two
    integer dots. Returns ``[B, 1, H, hd]`` f32."""
    b, qn, h, hd = q.shape
    kvh = cfg.n_kv_heads
    rep = h // kvh
    int8_cache = cache["k"].dtype == torch.int8
    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[2]
    idx = torch.arange(s_cache, device=q.device)
    valid = idx[None, None, :] <= qpos[:, :, None]
    if window:
        valid = valid | (qpos[:, :, None] >= s_cache)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    f32 = torch.float32
    if int8_cache:
        qf = (q.to(f32) * (hd ** -0.5)).reshape(b, qn, kvh, rep, hd)
        q8, q_s = quant_rows(qf)
        s32 = int_dot("bqgrd,bgsd->bqgrs", q8, ck)
        s = s32.to(f32) * q_s[..., None] * cache["k_scale"][:, None, :, None, :]
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
        p_fold = p_seq * cache["v_scale"][:, None, :, None, :]
        p8, p_s = quant_rows(p_fold)
        return int_dot("bqgrs,bgsd->bqgrd", p8, cv).to(f32) * p_s[..., None]

    if kv_prefix is not None:
        m = kv_prefix[0].shape[1]
        pvx = kv_prefix[1]
        out = torch.einsum("bqgrm,bmgd->bqgrd", p[..., :m].to(pvx.dtype).to(f32), pvx.to(f32))
        out = out + pv(p[..., m:])
    else:
        out = pv(p)
    return out.reshape(b, qn, h, hd)


def _decode_dense(q, k, v, cache, pos, cfg: ModelConfig, window: int, kv_prefix):
    """The dense-cache half of :func:`attention_decode`: write the Q new
    rows in place (:func:`_write_dense`), then attend each query row
    alone (:func:`_attend_dense`), so that query ``j``'s row is computed
    by the very operations, at the very shapes, of a one-token call at
    ``pos + j``: keys past it are masked to exact zeros, and a verify
    window is bitwise its sequential decode steps on any device. Returns
    (out [B, Q, H, hd] f32, the cache)."""
    qn = q.shape[1]
    _write_dense(cache, k, v, pos, window)
    qpos = pos.long()[:, None] + torch.arange(qn, device=q.device)[None, :]
    outs = [_attend_dense(q[:, j:j + 1], qpos[:, j:j + 1], cache, cfg, window, kv_prefix)
            for j in range(qn)]
    return (outs[0] if qn == 1 else torch.cat(outs, dim=1)), cache


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
    lane's first query token. The Q tokens take positions ``pos .. pos + Q
    - 1`` and query ``j`` attends over positions ``<= pos + j``, so Q > 1
    (the speculative verify) gives the logits of Q one-token calls.
    Returns (y [B, Q, d], new cache).

    With ``table`` (the [B, T] block table) ``cache`` is this layer's page
    pool: the Q new K/V rows are appended into their pages and attended
    in one ``paged_attention`` call (the pool is written in place on the
    card).

    Without it ``cache`` is the dense per-lane cache of
    :func:`init_kv_cache` (the unpaged engine; :func:`_decode_dense`): the
    new rows are written in place at slot ``pos % S_cache`` of a
    sliding-window layer's ring buffer (``window > 0``) or at ``clip(pos +
    j, 0, S_cache - 1)``, and ``kv_prefix`` (hymba's meta K/V ``[B, M, KV,
    hd]``) is attended before the sequence. A ring buffer and meta keys
    take Q = 1 only, as in the reference.
    """
    b, qn, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if qn > 1 and (window or kv_prefix is not None):
        raise NotImplementedError(
            "multi-token decode: full-causal dense/moe layers only (no ring "
            "buffer, no learnable kv_prefix) — SSM/hybrid archs can't verify")
    q = dense(params["wq"], x, mode=mode, name="attn_q").reshape(b, qn, h, hd)
    k = dense(params["wk"], x, mode=mode, name="attn_k").reshape(b, qn, kvh, hd)
    v = dense(params["wv"], x, mode=mode, name="attn_v").reshape(b, qn, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    qpos = rope_positions(cfg, pos.long()[:, None] + torch.arange(qn, device=x.device)[None, :])
    q = apply_rope(q, qpos, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, qpos, cfg.rope_theta, cfg.mrope_sections)
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
