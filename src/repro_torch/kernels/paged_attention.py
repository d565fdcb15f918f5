"""Paged-attention decode over the KV page pool: CUDA kernel wrapper, its
plain PyTorch version, and the pool helpers every pool writer shares.

Replaces ``repro/kernels/paged_attention.py::_paged_attn_kernel``
(``paged_attention_kernel`` / ``paged_attention``), the Pallas TPU kernel
that every decode-attention layer of the paged engine runs, for float32,
int8 and packed int4 pools, with one query row per lane at decode (Q = 1)
and the Q = k + 1 rows of a speculative verify. The CUDA source is
``csrc/paged_attention.cu``: the lane's new K/V rows are appended into
its pages and each (lane, KV head, tile of query rows) runs online-softmax
attention over the pages its rows reach; a row's result is bitwise that of
the Q = 1 call at its position, whatever Q and its tile. What bounds it on
the card: the bytes of the attended pages. Unlike the JAX
kernel, which returned a new pool through input/output aliasing, the CUDA
kernel **updates the pool in place** and returns the same dict.

The plain version has the kernel's numerics — f32 after dequantization,
trash pages select-zeroed — computed as the reference's
``paged_attention_gather_ref`` does: for float32 and int8 pools a gather
and a one-shot softmax (not the reference's ``paged_attention_xla`` int8
branch, which requantizes q and the softmax weights); for int4 pools the
gather and the reference's page-blocked online-softmax recurrence
(``_int4_flash_step`` / ``_int4_finish``), whose fully masked rows come out
as exact zeros.

int4 pools (the precision tier, ``kv_bits=4``) hold uint8 ``[P, KV, ps,
hd/2]`` values in the split-half layout of :func:`pack_int4` and one f32
scale per row, quantized by :func:`quant_rows` at ``KV4_QMAX``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .build import load
from .ref import inv_qmax, rows_matmul

__all__ = [
    "NEG_INF",
    "TRASH_PAGE",
    "KV4_QMAX",
    "quant_rows",
    "pack_int4",
    "unpack_int4",
    "pool_kind",
    "append_rows",
    "paged_attention_plain",
    "paged_attention_cuda",
    "tile_rows",
    "launches",
    "launches_verify",
    "reset_launches",
]

NEG_INF = -1e30  # finite: exp(NEG_INF - NEG_INF) == 1, never NaN
TRASH_PAGE = 0  # reserved pool page (serving.kv_cache.TRASH_PAGE): never read
KV4_QMAX = 7.0  # symmetric int4 grid: quantized values live in [-7, 7]

# The card's per-block shared memory, for the kernel's tiles.
_MAX_SMEM = 232448
# Query rows a tile aims at: one query token at glm4-9b's 16 heads per KV
# head, so a verify of Q tokens runs Q times a decode step's blocks.
_TILE_ROWS = 16

# Wrapper calls that launched the CUDA kernel: Q = 1 calls (decode) and
# Q > 1 calls (speculative verify, the multi-row path).
launches = 0
launches_verify = 0

_lib = None


def reset_launches() -> None:
    global launches, launches_verify
    launches = 0
    launches_verify = 0


def quant_rows(x: torch.Tensor, qmax: float = 127.0):
    """Symmetric absmax quantization over the last axis -> (int8, f32 scale).

    The one grid of every KV-row writer (prefill pages, the plain append,
    the CUDA kernel): reciprocal-multiply form, ``scale = max(amax, 1e-30)
    * float32(1/qmax)``, ``q = floor(x * (1/scale) + 0.5)``, bitwise the
    reference's ``quant_rows``.
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) * inv_qmax(qmax)
    q = torch.clamp(torch.floor(xf * torch.reciprocal(scale) + 0.5), -qmax, qmax)
    return q.to(torch.int8), scale[..., 0]


def pack_int4(q: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Pack int8 nibble values (in [-8, 7]) two per byte along ``dim`` (the
    last axis by default): byte ``j`` of a C-channel row holds channel
    ``j`` in its low nibble and channel ``j + C/2`` in its high nibble (the
    reference's split-half layout). A nibble is the low four bits of the
    value's two's complement, read through a uint8 view of ``q``, so no
    negative value is ever cast to uint8."""
    c = q.shape[dim]
    u = q.view(torch.uint8)
    lo = u.narrow(dim, 0, c // 2) & 0xF
    hi = u.narrow(dim, c // 2, c // 2) & 0xF
    return lo | (hi << 4)


def unpack_int4(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 ``[..., C/2]`` -> int8 ``[...,
    C]``, each nibble sign-extended (``(v ^ 8) - 8`` in int32: the value the
    reference's arithmetic shifts give)."""
    bi = b.to(torch.int32)
    lo = ((bi & 0xF) ^ 8) - 8
    hi = ((bi >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def pool_kind(pool) -> str:
    """Precision tier of a page pool by value dtype: int8 -> "int8", packed
    uint8 nibbles -> "int4", anything else -> "float"."""
    dt = pool["k"].dtype
    if dt == torch.int8:
        return "int8"
    if dt == torch.uint8:
        return "int4"
    return "float"


def append_rows(pool: Dict, k_new, v_new, table, pos) -> Dict:
    """Scatter Q tokens' K/V rows through the block table into a *copy* of
    the pool (the plain, functional form of the kernel's in-place append).

    k_new/v_new: ``[B, Q, KV, hd]``; table: ``[B, T]``; pos: ``[B]`` first
    token position per lane; positions clamp to ``[0, T*ps - 1]``.
    """
    ps = pool["k"].shape[2]
    t = table.shape[1]
    qn = k_new.shape[1]
    dev = k_new.device
    lin = torch.clamp(
        pos.long()[:, None] + torch.arange(qn, device=dev)[None, :], 0, t * ps - 1
    )
    pidx = torch.gather(table.long(), 1, lin // ps)  # [B, Q]
    slot = lin % ps
    out = {key: val.clone() for key, val in pool.items()}
    kind = pool_kind(pool)
    if kind in ("int8", "int4"):
        qm = 127.0 if kind == "int8" else KV4_QMAX
        k_q, k_s = quant_rows(k_new, qm)
        v_q, v_s = quant_rows(v_new, qm)
        if kind == "int4":
            k_q, v_q = pack_int4(k_q), pack_int4(v_q)
        out["k"][pidx, :, slot, :] = k_q
        out["v"][pidx, :, slot, :] = v_q
        out["k_scale"][pidx, :, slot] = k_s
        out["v_scale"][pidx, :, slot] = v_s
    else:
        out["k"][pidx, :, slot, :] = k_new.to(torch.float32).to(pool["k"].dtype)
        out["v"][pidx, :, slot, :] = v_new.to(torch.float32).to(pool["v"].dtype)
    return out


def _q_rows(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, Q, H, hd] -> [B, KV, Q*rep, hd] f32, scaled by hd^-1/2 (row ``qr``
    is query ``qr // rep``, rep ``qr % rep``)."""
    b, qn, h, hd = q.shape
    qf = q.to(torch.float32) * float(torch.tensor(hd ** -0.5, dtype=torch.float32))
    qf = qf.reshape(b, qn, kvh, h // kvh, hd)
    return qf.movedim(1, 2).reshape(b, kvh, qn * (h // kvh), hd)


def _rows_out(out: torch.Tensor, qn: int) -> torch.Tensor:
    """[B, KV, Q*rep, hd] -> [B, Q, H, hd] (inverse of :func:`_q_rows`)."""
    b, kvh, qr, hd = out.shape
    out = out.reshape(b, kvh, qn, qr // qn, hd)
    return out.movedim(2, 1).reshape(b, qn, kvh * (qr // qn), hd)


def _int4_flash_step(qv, kf, vf, vis, carry):
    """One page's online-softmax update (the reference's
    ``_int4_flash_step``). qv ``[..., QR, hd]`` pre-scaled; kf/vf ``[...,
    ps, hd]`` dequantized; vis broadcastable to the ``[..., QR, ps]``
    scores; carry ``(m, l, acc)``."""
    m, l, acc = carry
    s = rows_matmul(qv, kf.transpose(-1, -2))
    s = s + torch.where(vis, 0.0, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + rows_matmul(p, vf)
    return m_new, l_new, acc_new


def _int4_finish(m, l, acc):
    """Normalize the carry; fully masked rows (retired lanes' all-trash
    tables) come out as exact zeros."""
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return torch.where(m[..., None] > 0.5 * NEG_INF, out, torch.zeros((), device=out.device))


def paged_attention_plain(pool, table, pos, q, k_new, v_new) -> Tuple:
    """Plain version: append, gather ``pool[table]``, dequantize, zero the
    trash pages (a select: NaN poison dies), then a one-shot f32 softmax
    (float32 and int8 pools) or the page-blocked online softmax (int4).

    q: ``[B, Q, H, hd]`` post-RoPE (unscaled); k_new/v_new ``[B, Q, KV,
    hd]``. Returns ``(out [B, Q, H, hd] f32, appended pool copy)``.
    """
    b, qn, h, hd = q.shape
    kvh, ps = pool["k"].shape[1:3]
    t = table.shape[1]
    dev = q.device
    new_pool = append_rows(pool, k_new, v_new, table, pos)
    kind = pool_kind(pool)
    tl = table.long()

    def flat(x):  # [B, T, KV, ps, ...] -> [B, KV, T*ps, ...]
        return x.movedim(2, 1).reshape((b, kvh, t * ps) + tuple(x.shape[4:]))

    readable = torch.repeat_interleave(table != TRASH_PAGE, ps, dim=1)  # [B, T*ps]

    def dequant(key):
        vals = new_pool[key][tl]
        if kind == "int4":
            vals = unpack_int4(vals)
        x = flat(vals).to(torch.float32)
        if kind != "float":
            x = x * flat(new_pool[key + "_scale"][tl])[..., None]
        return torch.where(readable[:, None, :, None], x, torch.zeros((), device=dev))

    kf, vf = dequant("k"), dequant("v")
    q2 = _q_rows(q, kvh)  # [B, KV, QR, hd]
    qr = q2.shape[2]
    row_tok = torch.arange(qr, device=dev) // (h // kvh)  # row -> query token
    bound = pos.long()[:, None] + row_tok[None, :]  # [B, rows]
    if kind == "int4":
        k5 = kf.reshape(b, kvh, t, ps, hd)
        v5 = vf.reshape(b, kvh, t, ps, hd)
        page_ok = table != TRASH_PAGE  # [B, T]
        carry = (torch.full((b, kvh, qr), NEG_INF, device=dev),
                 torch.zeros((b, kvh, qr), device=dev),
                 torch.zeros((b, kvh, qr, hd), device=dev))
        for i in range(t):
            gpos = i * ps + torch.arange(ps, device=dev)
            vis = (gpos[None, None, :] <= bound[:, :, None]) & page_ok[:, i, None, None]
            carry = _int4_flash_step(q2, k5[:, :, i], v5[:, :, i], vis[:, None], carry)
        return _rows_out(_int4_finish(*carry), qn), new_pool
    vis = torch.arange(t * ps, device=dev)[None, None, :] <= bound[:, :, None]
    vis = vis & readable[:, None, :]
    s = rows_matmul(q2, kf.transpose(-1, -2))
    s = s + torch.where(vis[:, None], 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = rows_matmul(p, vf)
    return _rows_out(out, qn), new_pool


def _bind():
    global _lib
    if _lib is None:
        fn = load("paged_attention").paged_attention_launch
        c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [
            c_void_p, c_void_p, c_void_p,  # q, k_new, v_new (bf16)
            c_void_p, c_void_p, c_void_p, c_void_p, c_int,  # pools, scales, kind
            c_void_p, c_void_p, c_void_p,  # table, pos, out
            c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int,  # B Q H KV hd ps T R
            c_float, c_float, c_float, c_void_p,  # q_scale, qmax, inv_qmax, stream
        ]
        fn.restype = c_int
        _lib = fn
    return _lib


# The pool kinds as the CUDA source numbers them (``kind`` argument).
_KIND_CODE = {"float": 0, "int8": 1, "int4": 2}


def _smem_bytes(rows: int, hd: int, ps: int) -> int:
    return 4 * (rows * hd + ps * (hd + 1) + ps * hd + rows * ps + rows * hd + 3 * rows)


def tile_rows(qn: int, rep: int, hd: int, ps: int) -> int:
    """Query rows per tile of the CUDA kernel for ``qn`` query tokens with
    ``rep`` heads per KV head: whole query tokens, as many as ``_TILE_ROWS``
    rows hold (at least one) and shared memory takes; a one-token call is
    one tile. Raises when one token's ``rep`` rows do not fit."""
    fit = (_MAX_SMEM // 4 - ps * (2 * hd + 1)) // (2 * hd + ps + 3)
    if rep > fit:
        raise ValueError(
            f"one query token's {rep} rows need {_smem_bytes(rep, hd, ps)} bytes of shared "
            f"memory (> {_MAX_SMEM})"
        )
    tokens = max(1, min(qn, _TILE_ROWS // rep, fit // rep))
    return tokens * rep


def paged_attention_cuda(pool, table, pos, q, k_new, v_new) -> Tuple:
    """Launch the CUDA kernels: the append (in place), then paged flash decode.

    Takes float32, int8 or packed int4 (uint8, ``hd/2`` bytes a row) pools
    and bfloat16 q/k_new/v_new (the model's activations); raises on
    anything else. Returns ``(out [B, Q, H, hd] f32, pool)`` with ``pool``
    the same dict, its tensors updated in place.
    """
    global launches, launches_verify
    b, qn, h, hd = q.shape
    kind = pool_kind(pool)
    scaled = kind != "float"
    tensors = [("q", q), ("k_new", k_new), ("v_new", v_new), ("table", table),
               ("pos", pos), ("pool k", pool["k"]), ("pool v", pool["v"])]
    if scaled:
        tensors += [("k_scale", pool["k_scale"]), ("v_scale", pool["v_scale"])]
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention_cuda: {name} must be on {q.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_cuda: {name} must be contiguous")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    p_pages, kvh, ps, hdp = pool["k"].shape
    if kind == "float" and pool["k"].dtype != torch.float32:
        raise ValueError(f"float pools must be float32, got {pool['k'].dtype}")
    if pool["v"].dtype != pool["k"].dtype or pool["v"].shape != pool["k"].shape:
        raise ValueError("pool k and v must have one dtype and shape")
    if scaled:
        for key in ("k_scale", "v_scale"):
            if pool[key].dtype != torch.float32 or pool[key].shape != (p_pages, kvh, ps):
                raise ValueError(f"{key} must be float32 [P, KV, ps]")
    want_hdp = hd // 2 if kind == "int4" else hd
    if (kind == "int4" and hd % 2) or hdp != want_hdp or k_new.shape != (b, qn, kvh, hd) \
            or v_new.shape != k_new.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
            f"{kind} pool {tuple(pool['k'].shape)}"
        )
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of KV heads {kvh}")
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[0] != b:
        raise ValueError("table must be int32 [B, T]")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,):
        raise ValueError("pos must be int32 [B]")
    rows = tile_rows(qn, h // kvh, hd, ps)
    t = table.shape[1]
    out = torch.empty((b, qn, h, hd), dtype=torch.float32, device=q.device)
    qmax = KV4_QMAX if kind == "int4" else 127.0
    fn = _bind()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pool["k"].data_ptr(), pool["v"].data_ptr(),
        pool["k_scale"].data_ptr() if scaled else None,
        pool["v_scale"].data_ptr() if scaled else None,
        _KIND_CODE[kind], table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, qn, h, kvh, hd, ps, t, rows,
        float(torch.tensor(hd ** -0.5, dtype=torch.float32)), qmax, inv_qmax(qmax),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    if qn == 1:
        launches += 1
    else:
        launches_verify += 1
    return out, pool
