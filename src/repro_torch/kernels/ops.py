"""Dispatch over the kernels, by device.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written CUDA kernel or raises. There is no switch that
sends a CUDA tensor to the plain version, and no fallback around a build or
a launch. Production code calls these and never the kernels directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import fused_qmatmul as _fq
from . import paged_attention as _pa

__all__ = ["fused_quant_matmul", "paged_attention"]


def _device_kind(t: torch.Tensor) -> str:
    return t.device.type


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


def paged_attention(pool, table, pos, q, k_new, v_new):
    """Fused append + paged flash-decode attention over the page pool.
    Returns ``(out [B, Q, H, hd] f32, pool)``: on the card the pool is
    updated in place; on the CPU a new appended pool is returned."""
    kind = _device_kind(q)
    if kind == "cpu":
        return _pa.paged_attention_plain(pool, table, pos, q, k_new, v_new)
    if kind == "cuda":
        return _pa.paged_attention_cuda(pool, table, pos, q, k_new, v_new)
    raise ValueError(f"paged_attention: no kernel for device {q.device}")
