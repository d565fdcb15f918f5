"""W4A8 matmul with OCS-separated int8 outlier rows: CUDA kernel wrapper and
its plain PyTorch version.

Replaces ``repro/kernels/fused_qmatmul.py::_w4a8_kernel`` (``:220``; the
pallas_call in ``w4a8_qmatmul_kernel``, ``:290``; the wrapper
``w4a8_quant_matmul``, ``:348``), the Pallas TPU kernel that every linear
layer of the ``w4a8`` serving tier runs. The CUDA source is
``csrc/w4a8_qmatmul.cu``: a row prologue (abs-max, reciprocal-form scale,
the int8 row, the OCS tail and the outlier rows gathered by indexed
loads), a ``__dp4a`` GEMM that reads each packed weight byte once and
sign-extends its two nibbles in registers, the ``__dp4a`` int8 GEMM over the outlier
rows, and the f32 epilogue. What bounds it on the card: the weight bytes at
decode (half of B1's, plus the outlier rows), the int8 multiply-adds at
prefill.

**Contract** (``repro_torch.core.ocs.W4A8Linear`` layout): ``w4`` is
``[(K+S)/2, N]`` uint8, byte row ``j`` holding expanded rows ``j`` (low
nibble) and ``j + (K+S)/2`` (high nibble), outlier rows zero; ``w8`` is
``[T, N]`` int8; any N (a ragged N runs zero-padded to a multiple of 16 and
is sliced: :func:`repro_torch.kernels.quant_matmul.padded_cols`); outputs
are bitwise
:func:`repro_torch.kernels.ref.w4a8_matmul_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref
from .build import load
from .quant_matmul import pad_cols, padded_cols

__all__ = [
    "w4a8_matmul_plain",
    "w4a8_matmul_cuda",
    "launches",
    "reset_launches",
]

# Wrapper calls that launched the CUDA kernel (one per call: the prologue,
# the two GEMMs and the epilogue of one call count once).
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def _bind():
    global _lib
    if _lib is None:
        fn = load("w4a8_qmatmul").w4a8_qmatmul_launch
        c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [
            c_void_p, c_int, c_int, c_int, c_int,  # x, x_bf16, M, K, S
            c_void_p, c_void_p, c_int,  # src_tail, outlier_idx, T
            c_void_p, c_void_p, c_void_p, c_void_p, c_int,  # w4, s4, w8, s8, N
            c_float, c_float,  # qmax, inv_qmax
            c_void_p, c_int, c_void_p, c_int,  # q2, Hp, q8, Tp
            c_void_p, c_void_p,  # scale, acc scratch
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        fn.restype = c_int
        _lib = fn
    return _lib


def w4a8_matmul_plain(
    x: torch.Tensor,
    w4: torch.Tensor,
    s4: torch.Tensor,
    w8: torch.Tensor,
    s8: torch.Tensor,
    src_tail: torch.Tensor,
    outlier_idx: torch.Tensor,
    *,
    bits: int = 8,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain PyTorch version (CPU path; the card's correctness oracle)."""
    return ref.w4a8_matmul_ref(
        x, w4, s4.reshape(-1), w8, s8.reshape(-1), src_tail, outlier_idx, bits,
        out_dtype or torch.float32,
    )


def _check(x, w4, s4, w8, s8, src_tail, outlier_idx, bits):
    for name, t in (("x", x), ("w4", w4), ("s4", s4), ("w8", w8), ("s8", s8),
                    ("src_tail", src_tail), ("outlier_idx", outlier_idx)):
        if not t.is_cuda:
            raise ValueError(f"w4a8_matmul_cuda: {name} must be a CUDA tensor")
        if t.device != x.device:
            raise ValueError("w4a8_matmul_cuda: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"w4a8_matmul_cuda: {name} must be contiguous")
    if x.ndim != 2 or w4.ndim != 2 or w8.ndim != 2:
        raise ValueError(
            f"want x [M, K], w4 [(K+S)/2, N], w8 [T, N], got {tuple(x.shape)}, "
            f"{tuple(w4.shape)}, {tuple(w8.shape)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w4.dtype != torch.uint8 or w8.dtype != torch.int8:
        raise ValueError("w4 must be uint8 and w8 int8")
    if s4.dtype != torch.float32 or s8.dtype != torch.float32:
        raise ValueError("s4 and s8 must be float32")
    for name, t in (("src_tail", src_tail), ("outlier_idx", outlier_idx)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    m, k = x.shape
    kh, n = w4.shape
    ke = 2 * kh
    if ke != k + src_tail.shape[0]:
        raise ValueError(f"w4 holds {ke} rows, want K {k} + S {src_tail.shape[0]}")
    if w8.shape != (outlier_idx.shape[0], n):
        raise ValueError(f"w8 is {tuple(w8.shape)}, want [T = {outlier_idx.shape[0]}, N = {n}]")
    if s4.numel() != n or s8.numel() != n:
        raise ValueError(f"s4/s8 have {s4.numel()}/{s8.numel()} entries, want N = {n}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    if m == 0:
        raise ValueError("empty x")


def w4a8_matmul_cuda(
    x: torch.Tensor,
    w4: torch.Tensor,
    s4: torch.Tensor,
    w8: torch.Tensor,
    s8: torch.Tensor,
    src_tail: torch.Tensor,
    outlier_idx: torch.Tensor,
    *,
    bits: int = 8,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel. x: [M, K] f32/bf16; w4: [(K+S)/2, N] uint8;
    s4, s8: [N] f32; w8: [T, N] int8; src_tail: [S] int32; outlier_idx: [T]
    int32 -> [M, N] ``out_dtype`` (default f32; f32 or bf16). Raises on
    anything the kernel does not take. ``outlier_idx`` entries must lie in
    ``[0, K+S)`` (the layout :func:`repro_torch.core.ocs.to_w4a8` makes)."""
    global launches
    s4, s8 = s4.reshape(-1), s8.reshape(-1)
    _check(x, w4, s4, w8, s8, src_tail, outlier_idx, bits)
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    m, k = x.shape
    kh, n_out = w4.shape
    # A ragged N runs zero columns up to n (the kernel reads weights in
    # 4-column words) and is sliced, as the reference's wrapper pads N.
    n = padded_cols(n_out)
    w4, s4, w8, s8 = pad_cols(w4, n), pad_cols(s4, n), pad_cols(w8, n), pad_cols(s8, n)
    s = 2 * kh - k
    t = outlier_idx.shape[0]
    hp = kh + (-kh) % 16  # each half of the expanded row, zero padded
    tp = t + (-t) % 16
    qmax = float((1 << (bits - 1)) - 1)
    dev = x.device
    q2 = torch.empty((m, 2 * hp), dtype=torch.int8, device=dev)
    q8 = torch.empty((m, tp), dtype=torch.int8, device=dev) if t else None
    scale = torch.empty((m,), dtype=torch.float32, device=dev)
    acc = torch.empty((2 if t else 1, m, n), dtype=torch.int32, device=dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, s,
        src_tail.data_ptr(), outlier_idx.data_ptr(), t,
        w4.data_ptr(), s4.data_ptr(), w8.data_ptr(), s8.data_ptr(), n,
        qmax, ref.inv_qmax(qmax),
        q2.data_ptr(), hp, q8.data_ptr() if t else None, tp,
        scale.data_ptr(), acc.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"w4a8_qmatmul launch failed: cudaError {err}")
    launches += 1
    return out if n == n_out else out[:, :n_out].contiguous()
