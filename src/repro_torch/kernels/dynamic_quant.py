"""Per-row dynamic int8 quantization: CUDA kernel wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/dynamic_quant.py::_kernel`` (``dynamic_quant_kernel``
/ ``dynamic_quant``), reached through ``ops.dynamic_quant``. The CUDA source
is ``csrc/dynamic_quant.cu``: one block per row, an abs-max pass and a
quantize pass, at any K (the reference's VMEM-budget fallback has no
counterpart). Its arithmetic is B1's row prologue (``row_quant_kernel`` in
``csrc/qmatmul_common.cuh``). What bounds it on the card: bytes.

Numerics: ``scale = max(amax, 1e-30) * float32(1/qmax)``, ``q = clip(floor(
x / scale + 1/2))``; outputs are bitwise
:func:`repro_torch.kernels.ref.dynamic_quant_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import ref
from .build import load

__all__ = ["dynamic_quant_plain", "dynamic_quant_cuda", "launches", "reset_launches"]

# Wrapper calls that launched the CUDA kernel.
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def _bind():
    global _lib
    if _lib is None:
        fn = load("dynamic_quant").dynamic_quant_launch
        c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [
            c_void_p, c_int, c_int, c_int,  # x, x_bf16, M, K
            c_float, c_float,  # qmax, inv_qmax
            c_void_p, c_void_p, c_void_p,  # q, scale, stream
        ]
        fn.restype = c_int
        _lib = fn
    return _lib


def dynamic_quant_plain(x: torch.Tensor, *, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: x [M, K] -> (q [M, K] int8, scale [M] f32)."""
    return ref.dynamic_quant_ref(x, bits)


def dynamic_quant_cuda(x: torch.Tensor, *, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. x: [M, K] f32/bf16, contiguous, on the card
    -> (q [M, K] int8, scale [M] f32). Raises on anything the kernel does
    not take."""
    global launches
    if not x.is_cuda:
        raise ValueError("dynamic_quant_cuda: x must be a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("dynamic_quant_cuda: x must be contiguous")
    if x.ndim != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"dynamic_quant_cuda: want a non-empty x [M, K], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dynamic_quant_cuda: x must be float32 or bfloat16, got {x.dtype}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    m, k = x.shape
    qmax = float((1 << (bits - 1)) - 1)
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    err = _bind()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, qmax, ref.inv_qmax(qmax),
        q.data_ptr(), scale.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dynamic_quant launch failed: cudaError {err}")
    launches += 1
    return q, scale
