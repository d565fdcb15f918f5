"""Plain PyTorch oracles for the W8A8 kernel (the port of ``repro.kernels.ref``).

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
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "inv_qmax",
    "dynamic_quant_ref",
    "int8_matmul",
    "fused_quant_matmul_ref",
]

# Columns per float64 product block on the card: the plain int8 product is
# exact in float64, and blocking bounds its [K, block] float64 copy of w8.
_F64_BLOCK_N = 16384


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
