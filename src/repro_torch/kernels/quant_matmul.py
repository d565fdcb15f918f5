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
tail: bf16 x on ``csrc/wo_tc_gemm.cuh``'s tensor cores, f32 x on the CUDA
cores); what bounds it on the card is the int8 weight bytes at decode and
the multiply-adds at prefill.

**Contract**: ``x_scale`` ([M], a scalar, or None = 1) and ``w_scale``
([N] or a scalar) broadcast; ``out_dtype`` defaults to f32 on the int8 path
and to ``x.dtype`` otherwise. The int8 path is bitwise
:func:`repro_torch.kernels.ref.quant_matmul_ref`; the weight-only path
equals it up to the order of the float32 sums (the kernel's order is fixed,
so its output does not change from run to run).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import ref, scratch
from .build import load

__all__ = [
    "quant_matmul_plain",
    "quant_matmul_cuda",
    "tc_rows",
    "tc_split_plan",
    "launches",
    "reset_launches",
]

# Wrapper calls that launched the CUDA kernel.
launches = 0

_lib = {}

# The weight-only GEMM's grid (qmatmul_common.cuh): 256 columns per block,
# up to 8 rows; K is split over the grid until the column blocks alone
# would put ~2 blocks on each of the H100's 132 SMs, with at least 64 rows
# of K per split. The split follows from K and N only: every row is then
# summed in one order whatever M is, so a verify step over B*(k+1) rows
# gives each row bitwise what B-row decode steps give it.
_COLS = 256
_WANT_BLOCKS = 264
_MIN_SPLIT_ROWS = 64
# The split-K workspace is [n_splits, rows, N] float32. A call whose
# workspace would pass this size (a long prefill) runs in row chunks that
# stay within it (240 rows at glm4-9b's w_down); a row's sums are the same
# in any chunk.
_MAX_PART_BYTES = 64 << 20
# The bf16 tensor-core GEMM's grid (csrc/wo_tc_gemm.cuh, B5's and B4's):
# 128 columns per block of 4 warps, the contraction in stages of 32 rows,
# split over the grid until the column blocks alone would put ~2 blocks on
# each SM, with at least 256 rows (2 stages a warp) per split; from the
# contraction's rows (tc_rows: K, and B4's OCS tail) and N only, as above.
_TC_COLS = 128
_TC_STAGE_K = 32
_TC_WANT_BLOCKS = 264
_TC_MIN_SPLIT_ROWS = 256


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
        tc = lib.quant_matmul_tc_launch
        tc.argtypes = [
            c_void_p, c_int, c_int,  # x, M, K
            c_void_p, c_void_p, c_void_p, c_int,  # w8, xs, ws, N
            c_int, c_int, c_void_p, c_void_p,  # k_chunk, nsplit, part, counters
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        tc.restype = c_int
        i8 = lib.quant_matmul_int8_launch
        i8.argtypes = [
            c_void_p, c_int, c_int,  # x, M, K
            c_void_p, c_void_p, c_void_p, c_int,  # w8, xs, ws, N
            c_void_p, c_int, c_void_p,  # q, Kp, acc
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        i8.restype = c_int
        _lib.update(wo=wo, tc=tc, int8=i8)
    return _lib


def scales(x: torch.Tensor, w_scale, x_scale,
           n: int) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(x_scale [M] or None, w_scale [N])`` as contiguous float32 on
    ``x``'s device: scalars broadcast; ``x_scale=None`` stays None, which
    the epilogues read as 1 (``1 * w_scale == w_scale``, so no ones tensor
    is made and the bits are the same)."""
    m, dev = x.shape[0], x.device
    xs = None if x_scale is None else _vector(x_scale, m, dev, "x_scale", "M")
    return xs, _vector(w_scale, n, dev, "w_scale", "N")


def _vector(v, size: int, dev, name: str, dim: str) -> torch.Tensor:
    """``v`` (a scalar or ``size`` entries) as a contiguous float32 [size]
    on ``dev``; a tensor that already is one comes back as it is."""
    if (isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device == dev
            and v.dim() == 1 and v.shape[0] == size and v.is_contiguous()):
        return v
    t = torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1)
    if t.numel() == 1:
        t = t.expand(size)
    if t.numel() != size:
        raise ValueError(f"scales: {name} has {t.numel()} entries (want {dim} = {size} or 1)")
    return t.contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def out_dtype_for(x: torch.Tensor, out_dtype) -> torch.dtype:
    """f32 on the int8 path, ``x.dtype`` otherwise, unless given."""
    if out_dtype is not None:
        return out_dtype
    return torch.float32 if x.dtype == torch.int8 else x.dtype


def wo_split_plan(ke: int, n: int) -> Tuple[int, int]:
    """``(k_chunk, n_splits)`` of the weight-only GEMM's split K over ``ke``
    rows of K for ``n`` columns (independent of M)."""
    blocks = math.ceil(n / _COLS)
    nsplit = min(math.ceil(_WANT_BLOCKS / blocks), max(1, ke // _MIN_SPLIT_ROWS))
    nsplit = max(nsplit, 1)
    k_chunk = math.ceil(ke / nsplit)
    k_chunk += (-k_chunk) % 16
    return k_chunk, math.ceil(ke / k_chunk)


def tc_rows(k: int, s: int) -> int:
    """Rows of the tensor-core GEMM's contraction for ``k`` columns of x and
    ``s`` OCS tail rows: ``k`` with no tail (B5); else B4's virtual rows,
    K rounded up to a 32-row stage (Kb) plus ``s``: the tail's stages start
    on a stage of their own, and virtual row ``r >= Kb`` reads weight row
    ``k + r - Kb``."""
    if s == 0:
        return k
    return k + (-k) % _TC_STAGE_K + s


@functools.lru_cache(maxsize=None)
def tc_split_plan(k: int, n: int) -> Tuple[int, int]:
    """``(k_chunk, n_splits)`` of the bf16 tensor-core GEMM's split of ``k``
    rows of its contraction (:func:`tc_rows`) for ``n`` columns
    (independent of M; ``k_chunk`` a multiple of the 32-row stage)."""
    blocks = math.ceil(n / _TC_COLS)
    nsplit = max(1, min(math.ceil(_TC_WANT_BLOCKS / blocks), k // _TC_MIN_SPLIT_ROWS))
    k_chunk = math.ceil(k / nsplit)
    k_chunk += (-k_chunk) % _TC_STAGE_K
    return k_chunk, math.ceil(k / k_chunk)


def wo_row_chunk(m: int, n: int, nsplit: int) -> int:
    """Rows per launch of the weight-only GEMM: all ``m`` unless its
    split-K workspace ``[nsplit, rows, n]`` f32 would pass
    ``_MAX_PART_BYTES``."""
    return min(m, max(1, _MAX_PART_BYTES // (4 * nsplit * n)))


def _part(dev, nsplit: int, rows: int, n: int) -> torch.Tensor:
    """The split-K workspace ``[nsplit, rows, n]`` f32, kept per device
    (``scratch``; reuse relies on stream order)."""
    nbytes = 4 * nsplit * rows * n
    return scratch.buffer("split_k", dev, nbytes)[:nbytes].view(torch.float32)


def launch_wo(fn, x, out, xs, ws, ke: int, *args) -> int:
    """Run the CUDA-core weight-only entry point ``fn`` (B4's, or B5's f32-x
    one) over ``x``'s rows in chunks of :func:`wo_row_chunk` rows that share
    one workspace, with :func:`wo_split_plan`'s split of ``ke`` rows of K.
    ``args`` are the entry point's arguments between ``K`` and ``xs``; ``xs``
    may be None (= 1). Returns the first nonzero cudaError, else 0."""
    m, k = x.shape
    n = out.shape[1]
    k_chunk, nsplit = wo_split_plan(ke, n)
    rows = wo_row_chunk(m, n, nsplit)
    part = _part(x.device, nsplit, rows, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x_bf16, out_bf16 = int(x.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16)
    for r in range(0, m, rows):
        xr, outr = (x, out) if rows == m else (x[r:r + rows], out[r:r + rows])
        xsr = xs if xs is None or rows == m else xs[r:r + rows]
        err = fn(xr.data_ptr(), x_bf16, xr.shape[0], k, *args, _ptr(xsr), ws.data_ptr(),
                 n, k_chunk, nsplit, part.data_ptr(), outr.data_ptr(), out_bf16, stream)
        if err != 0:
            return err
    return 0


@functools.lru_cache(maxsize=1024)
def _tc_launch_plan(m: int, k: int, n: int, max_part: int) -> Tuple[int, int, int, int, int]:
    """``(k_chunk, nsplit, rows, workspace bytes, counter bytes)`` of an
    ``m``-row call of the tensor-core GEMM over ``k`` rows of contraction
    (:func:`tc_rows`): :func:`tc_split_plan`'s split,
    row chunks of :func:`wo_row_chunk` rows when the split needs a
    workspace (none with one split; ``max_part`` is ``_MAX_PART_BYTES``,
    part of the key so a changed bound takes effect), and one counter per
    token tile and column tile of any chunk."""
    k_chunk, nsplit = tc_split_plan(k, n)
    if nsplit == 1:
        return k_chunk, 1, m, 0, 0
    rows = min(m, max(1, max_part // (4 * nsplit * n)))  # wo_row_chunk's rows
    return k_chunk, nsplit, rows, 4 * nsplit * rows * n, 4 * math.ceil(rows / 8) * math.ceil(
        n / _TC_COLS)


def launch_tc(fn, x, out, xs, ws, kv: int, *args) -> int:
    """Run a bf16 tensor-core entry point (B5's, or B4's with its OCS tail)
    over ``x``'s rows with :func:`tc_split_plan`'s split of ``kv`` rows of
    contraction (:func:`tc_rows`), in row chunks when the split needs a
    workspace (kept per device, as are the counters). ``args`` are the
    entry point's arguments between ``K`` and ``xs``; ``xs`` may be None
    (= 1). Returns the first nonzero cudaError, else 0."""
    m, k = x.shape
    n = out.shape[1]
    k_chunk, nsplit, rows, part_bytes, count_bytes = _tc_launch_plan(m, kv, n, _MAX_PART_BYTES)
    part = counters = None
    if nsplit > 1:
        part = scratch.buffer("split_k", x.device, part_bytes).data_ptr()
        counters = scratch.buffer("split_k_counters", x.device, count_bytes,
                                  zeroed=True).data_ptr()
    out_bf16 = int(out.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r in range(0, m, rows):
        xr, outr = (x, out) if rows == m else (x[r:r + rows], out[r:r + rows])
        xsr = xs if xs is None or rows == m else xs[r:r + rows]
        err = fn(xr.data_ptr(), xr.shape[0], k, *args, _ptr(xsr), ws.data_ptr(), n,
                 k_chunk, nsplit, part, counters, outr.data_ptr(), out_bf16, stream)
        if err != 0:
            return err
    return 0


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
    """Launch the CUDA kernel. x: [M, K] bf16 (weight-only, tensor cores),
    f32 (weight-only, CUDA cores) or int8; w8: [K, N] int8 -> [M, N]
    ``out_dtype`` (f32 or bf16). Raises on anything the kernel does not
    take."""
    global launches
    out_dtype = out_dtype_for(x, out_dtype)
    check_cuda_operands("quant_matmul_cuda", x, w8, 0, out_dtype)
    m, k = x.shape
    n = w8.shape[1]
    xs, ws = scales(x, w_scale, x_scale, n)
    dev = x.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fns = _bind()
    if x.dtype == torch.int8:
        stream = torch.cuda.current_stream(dev).cuda_stream
        out_bf16 = int(out_dtype == torch.bfloat16)
        kp = k + (-k) % 16
        q = None if kp == k else torch.empty((m, kp), dtype=torch.int8, device=dev)
        acc = torch.empty((m, n), dtype=torch.int32, device=dev)
        err = fns["int8"](
            x.data_ptr(), m, k, w8.data_ptr(), _ptr(xs), ws.data_ptr(), n,
            _ptr(q), kp, acc.data_ptr(), out.data_ptr(), out_bf16, stream,
        )
    elif x.dtype == torch.bfloat16:
        err = launch_tc(fns["tc"], x, out, xs, ws, k, w8.data_ptr())
    else:  # float32 x: no serving caller; the CUDA-core GEMM
        err = launch_wo(fns["wo"], x, out, xs, ws, k, w8.data_ptr())
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: cudaError {err}")
    launches += 1
    return out
