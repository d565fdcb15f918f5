"""Plain PyTorch oracles for the quantized-matmul kernels (the port of
``repro.kernels.ref`` and of ``repro.kernels.ops._weight_only_ref``).

The rounding numerics are those of the reference as it runs compiled: XLA
folds the division of the row abs-max by the constant ``qmax`` into a
multiply by the float32 reciprocal ``1/qmax`` wherever the quantization is
jitted (the engine's steps, the interpret-mode kernel, ``ops`` dispatch),
while ``x / scale`` stays an IEEE division. So::

    scale = max(amax, 1e-30) * float32(1/qmax)     # reciprocal multiply
    q     = clip(floor(x / scale + 1/2))           # IEEE division, ties up

The CUDA kernel computes exactly this, with the contraction of ``x/scale +
0.5`` into anything else ruled out by the ``__fdiv_rn``/``__fadd_rn``
intrinsics.

Every epilogue is grouped ``acc * (x_scale * w_scale)``, as the Pallas
kernels group it (the reference's ``quant_matmul_ref`` and
``ocs_quant_matmul_ref`` apply ``(acc * x_scale) * w_scale``, an ulp away):
the int8 paths are then bitwise the reference's kernels. The weight-only
paths sum float32 products of exact float32 values (widened bf16 or f32
activations, int8 weights) in float32: equal to the reference's up to the
order of the sums.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = [
    "over_experts",
    "inv_qmax",
    "dynamic_quant_ref",
    "int8_matmul",
    "fused_quant_matmul_ref",
    "float_matmul",
    "quant_matmul_ref",
    "weight_only_ref",
    "ocs_quant_matmul_ref",
    "fma_f32",
    "w4a8_matmul_ref",
]

# Columns per product block of the plain versions: the int8 product is exact
# in float64 on the card, and blocking bounds the [K, block] float copy of
# w8 (float64 there, float32 for the weight-only products).
_F64_BLOCK_N = 16384


def over_experts(fn, x: torch.Tensor, stacked, **kw) -> torch.Tensor:
    """The plain version of an expert-stacked call: ``fn`` (a 2-D plain
    version) on each expert's slice, ``fn(x[e], *(a[e] for a in stacked),
    **kw)``, stacked to ``[E, M, N]``. An entry of ``stacked`` may be None
    (passed as None)."""
    return torch.stack([
        fn(x[e], *(None if a is None else a[e] for a in stacked), **kw)
        for e in range(x.shape[0])
    ])


def inv_qmax(qmax: float) -> float:
    """float32(1/qmax) as a Python float (exact in float32)."""
    return float(np.float32(1.0 / float(qmax)))


def dynamic_quant_ref(x: torch.Tensor, bits: int = 8):
    """Per-row dynamic quantization: x [M, K] float -> (q [M, K] int8,
    scale [M] f32), scale = max|row| * (1/qmax), q = clip(floor(x/scale+1/2))."""
    qmax = (1 << (bits - 1)) - 1
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=1)
    scale = torch.clamp_min(amax, 1e-30) * inv_qmax(qmax)
    q = torch.clamp(torch.floor(xf / scale[:, None] + 0.5), -qmax, qmax)
    return q.to(torch.int8), scale


def int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product [M, K] @ [K, N].

    The CPU multiplies in int32. PyTorch has no int32 matmul on CUDA, so
    there the product is taken in float64, which is exact while
    ``K * 127 * 127 < 2^53``, in column blocks.
    """
    if a8.device.type == "cpu":
        return a8.to(torch.int32) @ w8.to(torch.int32)
    a = a8.to(torch.float64)
    out = torch.empty((a8.shape[0], w8.shape[1]), dtype=torch.int32, device=a8.device)
    for n0 in range(0, w8.shape[1], _F64_BLOCK_N):
        blk = w8[:, n0 : n0 + _F64_BLOCK_N].to(torch.float64)
        out[:, n0 : n0 + blk.shape[1]] = (a @ blk).to(torch.int32)
    return out


def fused_quant_matmul_ref(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale: torch.Tensor,
    src_tail: torch.Tensor,
    bits: int = 8,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Dynamic-quant -> OCS expand -> int matmul -> f32 epilogue.

    x: [M, K] float; w8: [K+S, N] int8 *packed* expanded weights; src_tail:
    [S] int32. The activation scale covers the K original channels; the
    duplicates reuse their source's quantized value. The epilogue is
    grouped ``acc * (scale * w_scale)`` like the kernel's.
    """
    if out_dtype is None:
        out_dtype = torch.float32
    q, scale = dynamic_quant_ref(x, bits)
    if src_tail.shape[0]:
        q = torch.cat([q, q[:, src_tail.long()]], dim=1)
    acc = int8_matmul(q, w8)
    ws = w_scale.to(torch.float32).reshape(1, -1)
    return (acc.to(torch.float32) * (scale[:, None] * ws)).to(out_dtype)


def rows_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``[..., R, K] @ [..., K, N]``) with each row summed in the
    order a call of many rows gives it. The CPU's GEMM sums a lone row in
    another order (its one-row path), so a lone row goes through as two:
    a decode step's row then equals the same row inside a verify step.
    Every plain version whose rows must not depend on the row count
    multiplies through here."""
    if a.shape[-2] == 1:
        return torch.matmul(torch.cat([a, a], dim=-2), b)[..., :1, :]
    return torch.matmul(a, b)


def float_matmul(a: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """float32 product ``[M, K] @ [K, N]`` of float activations and int8
    weights, widened exactly to float32 (in column blocks, which bounds the
    float32 copy of ``w8``; rows through :func:`rows_matmul`)."""
    a = a.to(torch.float32)
    if w8.shape[1] <= _F64_BLOCK_N:
        return rows_matmul(a, w8.to(torch.float32))
    out = torch.empty((a.shape[0], w8.shape[1]), dtype=torch.float32, device=a.device)
    for n0 in range(0, w8.shape[1], _F64_BLOCK_N):
        blk = w8[:, n0 : n0 + _F64_BLOCK_N].to(torch.float32)
        out[:, n0 : n0 + blk.shape[1]] = rows_matmul(a, blk)
    return out


def _epilogue(acc: torch.Tensor, x_scale, w_scale: torch.Tensor, out_dtype):
    """``acc * (x_scale * w_scale)``; ``x_scale`` None is 1, and ``1 * ws``
    is ``ws``, so that is ``acc * w_scale`` bit for bit."""
    ws = w_scale.to(torch.float32).reshape(1, -1)
    scale = ws if x_scale is None else x_scale.to(torch.float32).reshape(-1, 1) * ws
    return (acc.to(torch.float32) * scale).to(out_dtype)


def quant_matmul_ref(
    x: torch.Tensor,
    w8: torch.Tensor,
    x_scale: Optional[torch.Tensor],
    w_scale: torch.Tensor,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Blocked quantized matmul (B5): ``x [M, K] @ w8 [K, N]`` then
    ``acc * (x_scale [M] * w_scale [N])``. int8 x: exact int32 accumulation;
    float x: weight-only, float32 accumulation."""
    if x.dtype == torch.int8:
        acc = int8_matmul(x, w8)
    else:
        acc = float_matmul(x, w8)
    return _epilogue(acc, x_scale, w_scale, out_dtype)


def weight_only_ref(x: torch.Tensor, w8: torch.Tensor, w_scale, out_dtype=None):
    """Weight-only int8 matmul oracle: ``(x @ w8) * w_scale`` in float32,
    cast to ``out_dtype`` (default ``x.dtype``)."""
    acc = float_matmul(x, w8)
    acc = acc * torch.as_tensor(w_scale, dtype=torch.float32, device=acc.device).reshape(1, -1)
    return acc.to(out_dtype or x.dtype)


def ocs_quant_matmul_ref(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale: torch.Tensor,
    src_tail: torch.Tensor,
    x_scale: Optional[torch.Tensor],
    tail_mult=None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """OCS-expanded matmul (B4), materializing ``x_exp = [x | x[:, src_tail]
    * tail_mult]`` (the HBM round trip the kernel avoids). int8 x takes an
    int8 0/1 ``tail_mult`` mask (or None) and accumulates in int32; float x
    takes a float32 ``tail_mult`` and accumulates in float32. Scales are
    ``x_scale [M]``, ``w_scale [N]``."""
    tail = x[:, src_tail.long()]
    if x.dtype == torch.int8:
        if tail_mult is not None:
            tail = tail * tail_mult.to(torch.int8)
        acc = int8_matmul(torch.cat([x, tail], dim=1), w8)
    else:
        tail = tail.to(torch.float32)
        if tail_mult is not None:
            tail = tail * tail_mult.to(torch.float32)
        acc = float_matmul(torch.cat([x.to(torch.float32), tail], dim=1), w8)
    return _epilogue(acc, x_scale, w_scale, out_dtype)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add), for
    float32 ``a``, ``b``, ``c`` whose product ``a * b`` is exact in float64
    (two 24-bit significands). The sum is taken in float64 with its
    rounding error (TwoSum); the one case where rounding that sum to
    float32 differs from rounding the exact value, a float64 sum exactly
    halfway between two float32 values, goes to the side of the error.
    Exact on any device (no contraction of the caller's ops is relied on)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.to(torch.float32)
    rd = r.to(torch.float64)
    other = torch.nextafter(r, torch.where(s > rd, math.inf, -math.inf).to(torch.float32))
    halfway = (s != rd) & (2.0 * s == rd + other.to(torch.float64))
    to_other = halfway & (((s > rd) & (err > 0)) | ((s < rd) & (err < 0)))
    return torch.where(to_other, other, r)


def w4a8_matmul_ref(
    x: torch.Tensor,
    w4: torch.Tensor,
    s4: torch.Tensor,
    w8: torch.Tensor,
    s8: torch.Tensor,
    src_tail: torch.Tensor,
    outlier_idx: torch.Tensor,
    bits: int = 8,
    out_dtype=None,
) -> torch.Tensor:
    """W4A8 with OCS-separated int8 outlier rows (B6's oracle; the port of
    the reference's ``w4a8_matmul_ref``).

    x: [M, K] float; w4: [(K+S)/2, N] uint8 split-half packed int4 weights,
    outlier rows zero; w8: [T, N] int8 outlier rows; s4/s8: [N] f32;
    src_tail: [S] int32; outlier_idx: [T] int32 rows of the expanded K.
    The activations are quantized in the **reciprocal** form of
    ``paged_attention.quant_rows`` at qmax ``2^(bits-1) - 1`` (not
    :func:`dynamic_quant_ref`'s division form). Two exact integer sums
    (``acc4`` over all expanded rows, ``acc8`` over the outlier rows), then
    the float32 epilogue ``acc4 * (a_s * s4) + acc8 * (a_s * s8)`` as the
    reference computes it compiled: XLA contracts the first product and the
    add into one fused multiply-add, ``fma(acc4, a_s * s4, acc8 * (a_s *
    s8))`` (:func:`fma_f32`); with T == 0 it is the product alone. Rounded
    once to ``out_dtype`` (default f32).
    """
    from .paged_attention import quant_rows, unpack_int4

    if out_dtype is None:
        out_dtype = torch.float32
    q, a_s = quant_rows(x, float((1 << (bits - 1)) - 1))
    q_exp = torch.cat([q, q[:, src_tail.long()]], dim=1) if src_tail.shape[0] else q
    acc4 = int8_matmul(q_exp, unpack_int4(w4.T).T)  # int8 [K+S, N], outlier rows 0
    c4 = a_s[:, None] * s4.to(torch.float32).reshape(1, -1)
    if not outlier_idx.shape[0]:
        return (acc4.to(torch.float32) * c4).to(out_dtype)
    acc8 = int8_matmul(q_exp[:, outlier_idx.long()], w8)
    t8 = acc8.to(torch.float32) * (a_s[:, None] * s8.to(torch.float32).reshape(1, -1))
    return fma_f32(acc4.to(torch.float32), c4, t8).to(out_dtype)
