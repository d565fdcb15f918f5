"""Fused dynamic-quant + OCS-expanded W8A8 matmul: CUDA kernel wrapper and
its plain PyTorch version.

Replaces ``repro/kernels/fused_qmatmul.py::_kernel`` (``fused_qmatmul_kernel``
/ ``fused_quant_matmul``), the Pallas TPU kernel that every linear layer of
the W8A8 serving path runs. The CUDA source is ``csrc/fused_qmatmul.cu``:
a row prologue (abs-max, scale, int8 row, OCS tail gather), a ``__dp4a``
int8 GEMM with split K over an int32 workspace, and the f32 epilogue — the
TPU kernel's resident [bm, K] row tile does not fit a block's shared memory
at K = 4096 or 13696, so the work is three launches with the same
numerics. What bounds it on the card: the int8 weight bytes at decode
(M <= 8), the int8 multiply-adds at prefill. It takes every K (the
reference's VMEM-budget fallback to XLA has no counterpart here).

**Contract** (``repro.core.ocs`` layout): ``w8`` is the *packed* expanded
weight matrix ``[K + S, N]`` (duplicated channels after the K originals,
multipliers folded in, padding rows zero); the per-row activation scale
covers the K original channels only; outputs are bitwise
:func:`repro_torch.kernels.ref.fused_quant_matmul_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref
from .build import load

__all__ = [
    "fused_quant_matmul_plain",
    "fused_quant_matmul_cuda",
    "launches",
    "reset_launches",
]

# Wrapper calls that launched the CUDA kernel (one per call: the prologue,
# GEMM and epilogue launches of one call count once).
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def _bind():
    global _lib
    if _lib is None:
        lib = load("fused_qmatmul")
        fn = lib.fused_qmatmul_launch
        c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [
            c_void_p, c_int, c_int, c_int, c_int, c_int,  # x, x_bf16, M, K, S, Kp
            c_void_p, c_void_p, c_void_p, c_int,  # src_tail, w8, w_scale, N
            c_float, c_float,  # qmax, inv_qmax
            c_void_p, c_void_p, c_void_p,  # q_exp, scale, acc scratch
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        fn.restype = c_int
        _lib = fn
    return _lib


def fused_quant_matmul_plain(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale: torch.Tensor,
    src_tail: torch.Tensor,
    *,
    bits: int = 8,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain PyTorch version (CPU path; the card's correctness oracle)."""
    return ref.fused_quant_matmul_ref(
        x, w8, w_scale.reshape(-1), src_tail, bits, out_dtype or torch.float32
    )


def _check(x, w8, w_scale, src_tail, bits):
    for name, t in (("x", x), ("w8", w8), ("w_scale", w_scale), ("src_tail", src_tail)):
        if not t.is_cuda:
            raise ValueError(f"fused_quant_matmul_cuda: {name} must be a CUDA tensor")
        if t.device != x.device:
            raise ValueError("fused_quant_matmul_cuda: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"fused_quant_matmul_cuda: {name} must be contiguous")
    if x.ndim != 2 or w8.ndim != 2:
        raise ValueError(f"want x [M, K] and w8 [K+S, N], got {tuple(x.shape)}, {tuple(w8.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w8.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError("w8 must be int8 and w_scale float32")
    if src_tail.dtype != torch.int32 or src_tail.ndim != 1:
        raise ValueError("src_tail must be a 1-D int32 tensor")
    m, k = x.shape
    ke, n = w8.shape
    if ke != k + src_tail.shape[0]:
        raise ValueError(f"w8 rows {ke} != K {k} + S {src_tail.shape[0]}")
    if w_scale.numel() != n:
        raise ValueError(f"w_scale has {w_scale.numel()} entries, want N = {n}")
    if n % 4:
        raise ValueError(f"the kernel reads w8 in 4-column words: N % 4 must be 0, got {n}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    if m == 0:
        raise ValueError("empty x")


def fused_quant_matmul_cuda(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale: torch.Tensor,
    src_tail: torch.Tensor,
    *,
    bits: int = 8,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel. x: [M, K] f32/bf16; w8: [K+S, N] int8;
    w_scale: [N] f32; src_tail: [S] int32 -> [M, N] ``out_dtype`` (default
    f32; f32 or bf16). Raises on anything the kernel does not take."""
    global launches
    w_scale = w_scale.reshape(-1)
    _check(x, w8, w_scale, src_tail, bits)
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    m, k = x.shape
    ke, n = w8.shape
    s = ke - k
    kp = ke + (-ke) % 16
    qmax = float((1 << (bits - 1)) - 1)
    dev = x.device
    q_exp = torch.empty((m, kp), dtype=torch.int8, device=dev)
    scale = torch.empty((m,), dtype=torch.float32, device=dev)
    acc = torch.empty((m, n), dtype=torch.int32, device=dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, s, kp,
        src_tail.data_ptr(), w8.data_ptr(), w_scale.data_ptr(), n,
        qmax, ref.inv_qmax(qmax),
        q_exp.data_ptr(), scale.data_ptr(), acc.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_qmatmul launch failed: cudaError {err}")
    launches += 1
    return out
