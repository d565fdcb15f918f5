"""Dispatch over the kernels, by device.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written CUDA kernel or raises. There is no switch that
sends a CUDA tensor to the plain version, and no fallback around a build or
a launch. Production code calls these and never the kernels directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import dynamic_quant as _dq
from . import fused_qmatmul as _fq
from . import ocs_matmul as _om
from . import paged_attention as _pa
from . import quant_matmul as _qm
from . import w4a8_qmatmul as _w4

__all__ = [
    "quant_matmul",
    "dynamic_quant",
    "ocs_quant_matmul",
    "fused_quant_matmul",
    "w4a8_matmul",
    "paged_attention",
]


def _device_kind(t: torch.Tensor) -> str:
    return t.device.type


def quant_matmul(x, w8, w_scale, x_scale=None, *, out_dtype: Optional[torch.dtype] = None):
    """Blocked quantized matmul ``[M, K] @ [K, N]``: weight-only for float
    x, W8A8 for int8 x; see :mod:`repro_torch.kernels.quant_matmul`."""
    kind = _device_kind(x)
    if kind == "cpu":
        return _qm.quant_matmul_plain(x, w8, w_scale, x_scale, out_dtype=out_dtype)
    if kind == "cuda":
        return _qm.quant_matmul_cuda(x, w8, w_scale, x_scale, out_dtype=out_dtype)
    raise ValueError(f"quant_matmul: no kernel for device {x.device}")


def dynamic_quant(x, *, bits: int = 8):
    """Per-row dynamic quantization: x [M, K] -> (q int8 [M, K], scale
    [M]); see :mod:`repro_torch.kernels.dynamic_quant`."""
    kind = _device_kind(x)
    if kind == "cpu":
        return _dq.dynamic_quant_plain(x, bits=bits)
    if kind == "cuda":
        return _dq.dynamic_quant_cuda(x, bits=bits)
    raise ValueError(f"dynamic_quant: no kernel for device {x.device}")


def ocs_quant_matmul(
    x, w8, w_scale, src_tail, x_scale=None, tail_mult=None, *,
    tail_is_mask: bool = False, out_dtype: Optional[torch.dtype] = None,
):
    """Fused OCS-expansion matmul (``[M, K]`` against ``[K+S, N]`` without
    materializing the expanded activations; S == 0 runs ``quant_matmul``);
    see :mod:`repro_torch.kernels.ocs_matmul`."""
    kind = _device_kind(x)
    if kind == "cpu":
        return _om.ocs_quant_matmul_plain(
            x, w8, w_scale, src_tail, x_scale, tail_mult,
            tail_is_mask=tail_is_mask, out_dtype=out_dtype,
        )
    if kind == "cuda":
        return _om.ocs_quant_matmul_cuda(
            x, w8, w_scale, src_tail, x_scale, tail_mult,
            tail_is_mask=tail_is_mask, out_dtype=out_dtype,
        )
    raise ValueError(f"ocs_quant_matmul: no kernel for device {x.device}")


def fused_quant_matmul(
    x, w8, w_scale, src_tail, *, bits: int = 8,
    out_dtype: Optional[torch.dtype] = None,
):
    """One-pass dynamic-quant + OCS-expanded W8A8 matmul (``[M, K] @ packed
    [K+S, N]``); see :mod:`repro_torch.kernels.fused_qmatmul`."""
    kind = _device_kind(x)
    if kind == "cpu":
        return _fq.fused_quant_matmul_plain(
            x, w8, w_scale, src_tail, bits=bits, out_dtype=out_dtype
        )
    if kind == "cuda":
        return _fq.fused_quant_matmul_cuda(
            x, w8, w_scale, src_tail, bits=bits, out_dtype=out_dtype
        )
    raise ValueError(f"fused_quant_matmul: no kernel for device {x.device}")


def w4a8_matmul(
    x, w4, s4, w8, s8, src_tail, outlier_idx, *, bits: int = 8,
    out_dtype: Optional[torch.dtype] = None,
):
    """W4A8 matmul with OCS-separated int8 outlier rows (``[M, K]`` against
    split-half packed int4 ``[(K+S)/2, N]`` plus ``[T, N]`` int8 rows); see
    :mod:`repro_torch.kernels.w4a8_qmatmul`."""
    kind = _device_kind(x)
    if kind == "cpu":
        return _w4.w4a8_matmul_plain(
            x, w4, s4, w8, s8, src_tail, outlier_idx, bits=bits, out_dtype=out_dtype
        )
    if kind == "cuda":
        return _w4.w4a8_matmul_cuda(
            x, w4, s4, w8, s8, src_tail, outlier_idx, bits=bits, out_dtype=out_dtype
        )
    raise ValueError(f"w4a8_matmul: no kernel for device {x.device}")


def paged_attention(pool, table, pos, q, k_new, v_new):
    """Fused append + paged flash-decode attention over the page pool
    (float32, int8 or packed int4 pages). Returns ``(out [B, Q, H, hd]
    f32, pool)``: on the card the pool is updated in place; on the CPU a
    new appended pool is returned."""
    kind = _device_kind(q)
    if kind == "cpu":
        return _pa.paged_attention_plain(pool, table, pos, q, k_new, v_new)
    if kind == "cuda":
        return _pa.paged_attention_cuda(pool, table, pos, q, k_new, v_new)
    raise ValueError(f"paged_attention: no kernel for device {q.device}")
