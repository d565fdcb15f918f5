"""Blocked quantized matmul (weight-only int8 and W8A8): CUDA kernel wrapper
and its plain PyTorch version.

Replaces ``repro/kernels/quant_matmul.py::_kernel`` (``quant_matmul_kernel``
/ ``quant_matmul``): ``y = (x @ w8) * (x_scale[m] * w_scale[n])``. Float x
(f32/bf16) is the weight-only mode (f32 accumulation of the exact products
of widened activations and int8 weights); int8 x is W8A8 (int32
accumulation). It is ``ops.quant_matmul`` and the S == 0 case of
``ops.ocs_quant_matmul``, so every linear layer of a clip-only tree
(``ocs_ratio=0``) served in ``dequant`` mode runs it. The CUDA source is
``csrc/quant_matmul.cu`` (the kernels of ``csrc/ocs_matmul.cu`` with no OCS
tail); what bounds it on the card is the int8 weight bytes at decode and
the f32 multiply-adds at prefill.

**Contract**: ``x_scale`` ([M], a scalar, or None = 1) and ``w_scale``
([N] or a scalar) broadcast; ``out_dtype`` defaults to f32 on the int8 path
and to ``x.dtype`` otherwise. The int8 path is bitwise
:func:`repro_torch.kernels.ref.quant_matmul_ref`; the weight-only path
equals it up to the order of the float32 sums (the kernel's order is fixed,
so its output does not change from run to run).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import ref
from .build import load

__all__ = [
    "quant_matmul_plain",
    "quant_matmul_cuda",
    "launches",
    "reset_launches",
]

# Wrapper calls that launched the CUDA kernel.
launches = 0

_lib = {}

# The weight-only GEMM's grid (qmatmul_common.cuh): 256 columns per block,
# up to 8 rows; K is split over the grid until ~2 blocks per SM of the
# H100's 132 are in flight, with at least 64 rows of K per split.
_COLS = 256
_WANT_BLOCKS = 264
_MIN_SPLIT_ROWS = 64


def reset_launches() -> None:
    global launches
    launches = 0


def _bind():
    if not _lib:
        lib = load("quant_matmul")
        c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
        wo = lib.quant_matmul_wo_launch
        wo.argtypes = [
            c_void_p, c_int, c_int, c_int,  # x, x_bf16, M, K
            c_void_p, c_void_p, c_void_p, c_int,  # w8, xs, ws, N
            c_int, c_int, c_void_p,  # k_chunk, nsplit, part
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        wo.restype = c_int
        i8 = lib.quant_matmul_int8_launch
        i8.argtypes = [
            c_void_p, c_int, c_int,  # x, M, K
            c_void_p, c_void_p, c_void_p, c_int,  # w8, xs, ws, N
            c_void_p, c_int, c_void_p,  # q, Kp, acc
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        i8.restype = c_int
        _lib.update(wo=wo, int8=i8)
    return _lib


def scales(x: torch.Tensor, w_scale, x_scale, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_scale [M], w_scale [N])`` as contiguous float32 on ``x``'s
    device: scalars broadcast, ``x_scale=None`` is all ones."""
    m, dev = x.shape[0], x.device
    xs = (torch.ones((m,), dtype=torch.float32, device=dev) if x_scale is None
          else torch.as_tensor(x_scale, dtype=torch.float32, device=dev).reshape(-1))
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev).reshape(-1)
    if xs.numel() == 1:
        xs = xs.expand(m)
    if ws.numel() == 1:
        ws = ws.expand(n)
    if xs.numel() != m or ws.numel() != n:
        raise ValueError(
            f"scales: x_scale has {xs.numel()} entries (want M = {m} or 1), "
            f"w_scale {ws.numel()} (want N = {n} or 1)"
        )
    return xs.contiguous(), ws.contiguous()


def out_dtype_for(x: torch.Tensor, out_dtype) -> torch.dtype:
    """f32 on the int8 path, ``x.dtype`` otherwise, unless given."""
    if out_dtype is not None:
        return out_dtype
    return torch.float32 if x.dtype == torch.int8 else x.dtype


def wo_split_plan(m: int, ke: int, n: int) -> Tuple[int, int]:
    """``(k_chunk, n_splits)`` of the weight-only GEMM's split K."""
    tm = 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8
    blocks = math.ceil(n / _COLS) * math.ceil(m / tm)
    nsplit = min(math.ceil(_WANT_BLOCKS / blocks), max(1, ke // _MIN_SPLIT_ROWS))
    nsplit = max(nsplit, 1)
    k_chunk = math.ceil(ke / nsplit)
    k_chunk += (-k_chunk) % 16
    return k_chunk, math.ceil(ke / k_chunk)


def check_cuda_operands(what: str, x, w8, s: int, out_dtype) -> None:
    """The checks the weight-only and int8 GEMMs share (B4 and B5; ``s`` is
    the OCS tail length, 0 for B5)."""
    for name, t in (("x", x), ("w8", w8)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} must be a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x.ndim != 2 or w8.ndim != 2:
        raise ValueError(f"{what}: want x [M, K] and w8 [K(+S), N], got "
                         f"{tuple(x.shape)}, {tuple(w8.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"{what}: x must be float32, bfloat16 or int8, got {x.dtype}")
    if w8.dtype != torch.int8:
        raise ValueError(f"{what}: w8 must be int8, got {w8.dtype}")
    if w8.shape[0] != x.shape[1] + s:
        raise ValueError(f"{what}: w8 has {w8.shape[0]} rows, want K + S = {x.shape[1] + s}")
    m, k = x.shape
    n = w8.shape[1]
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f"{what}: empty operand")
    if n % 4:
        raise ValueError(f"{what}: the kernel reads w8 in 4-column words: N % 4 must be 0, got {n}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: out_dtype must be float32 or bfloat16, got {out_dtype}")


def quant_matmul_plain(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale,
    x_scale=None,
    *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain PyTorch version (CPU path; the card's correctness oracle)."""
    xs, ws = scales(x, w_scale, x_scale, w8.shape[1])
    return ref.quant_matmul_ref(x, w8, xs, ws, out_dtype_for(x, out_dtype))


def quant_matmul_cuda(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale,
    x_scale=None,
    *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel. x: [M, K] f32/bf16 (weight-only) or int8;
    w8: [K, N] int8 -> [M, N] ``out_dtype`` (f32 or bf16). Raises on
    anything the kernel does not take."""
    global launches
    out_dtype = out_dtype_for(x, out_dtype)
    check_cuda_operands("quant_matmul_cuda", x, w8, 0, out_dtype)
    m, k = x.shape
    n = w8.shape[1]
    xs, ws = scales(x, w_scale, x_scale, n)
    dev = x.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fns = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out_bf16 = int(out_dtype == torch.bfloat16)
    if x.dtype == torch.int8:
        kp = k + (-k) % 16
        q = None if kp == k else torch.empty((m, kp), dtype=torch.int8, device=dev)
        acc = torch.empty((m, n), dtype=torch.int32, device=dev)
        err = fns["int8"](
            x.data_ptr(), m, k, w8.data_ptr(), xs.data_ptr(), ws.data_ptr(), n,
            None if q is None else q.data_ptr(), kp, acc.data_ptr(),
            out.data_ptr(), out_bf16, stream,
        )
    else:
        k_chunk, nsplit = wo_split_plan(m, k, n)
        part = torch.empty((nsplit, m, n), dtype=torch.float32, device=dev)
        err = fns["wo"](
            x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, w8.data_ptr(),
            xs.data_ptr(), ws.data_ptr(), n, k_chunk, nsplit, part.data_ptr(),
            out.data_ptr(), out_bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: cudaError {err}")
    launches += 1
    return out
