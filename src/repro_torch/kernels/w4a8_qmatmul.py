"""W4A8 matmul with OCS-separated int8 outlier rows: CUDA kernel wrapper and
its plain PyTorch version.

Replaces ``repro/kernels/fused_qmatmul.py::_w4a8_kernel`` (``:220``; the
pallas_call in ``w4a8_qmatmul_kernel``, ``:290``; the wrapper
``w4a8_quant_matmul``, ``:348``), the Pallas TPU kernel that every linear
layer of the ``w4a8`` serving tier runs. The CUDA source is
``csrc/w4a8_qmatmul.cu``: a row prologue (abs-max, reciprocal-form scale,
the int8 row, the OCS tail and the outlier rows gathered by indexed
loads) and one launch of the int8 tensor-core GEMM of
``csrc/i8_tc_gemm.cuh`` (B1's), whose int4 stages unpack both nibbles of
each packed weight byte in registers and whose outlier stages are B1's
int8 stage, with the f32 epilogue in it -- two device operations a call.
What bounds it on the card: the weight bytes at decode (half of B1's,
plus the outlier rows), the int8 multiply-adds at prefill.

**Plan** (:func:`launch_plan`, from (M, int4 stages, outlier stages, N) on
the host): B1's tiles and split rule
(:func:`repro_torch.kernels.fused_qmatmul.split_plan`: a stage of either
kind is one 32-row weight box, as B1's is), over the int4 stages and then
the outlier ones, the decode tile's splits kept to one wave of blocks,
with an accumulator of two sums when there are outlier rows. The row scratch (``q2``, ``q8``, ``scale``), the split-K accumulator
and its counters are kept per device (:mod:`repro_torch.kernels.scratch`),
so a steady loop, or a CUDA-graph capture after one sizing call,
allocates only the output.

**Contract** (``repro_torch.core.ocs.W4A8Linear`` layout): ``w4`` is
``[(K+S)/2, N]`` uint8, byte row ``j`` holding expanded rows ``j`` (low
nibble) and ``j + (K+S)/2`` (high nibble), outlier rows zero; ``w8`` is
``[T, N]`` int8; N a multiple of 16 (a leaf stores a ragged N's columns
zero-padded: ``core.ocs.pad_out_cols``); outputs
are bitwise
:func:`repro_torch.kernels.ref.w4a8_matmul_ref`.

**The expert axis.** x ``[E, M, K]`` against a stack of W4A8 leaves (every
operand with a leading ``[E]``: a MoE layer's experts, M = the capacity)
is one call over all E experts (:func:`launch`: the prologue over every
expert's rows, then one GEMM launch), with the plan of one expert's shapes
and the workspaces sized for the stack; each expert's slice is bitwise the
2-D call on it, which is the stack of one. Its plain version loops over
the 2-D one.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import ref, scratch
from .build import load
from .fused_qmatmul import split_plan, tile_for
from .quant_matmul import check_cols, stack_scales

__all__ = [
    "w4a8_matmul_plain",
    "w4a8_matmul_cuda",
    "launch",
    "launch_plan",
    "launches",
    "launches_stack",
    "reset_launches",
    "row_layout",
]

# Wrapper calls that launched the CUDA kernel (one per call: the prologue
# and the GEMM of one call count once).
launches = 0
# Of ``launches``, those over an expert stack (one call a stacked matrix).
launches_stack = 0

# Rows of the contraction a GEMM stage (csrc/i8_tc_gemm.cuh). Each half of
# q2 and q8 are padded to whole stages, so no token box of a stage reads
# across the halves.
_STAGE_K = 32
# The int4 sum enters the tensor cores as 16 x its nibbles: |sum| <= (K+S)
# * 127 * 128 must stay below 2^31.
_MAX_KE = (2**31 - 1) // (127 * 128)

_lib = None


def reset_launches() -> None:
    global launches, launches_stack
    launches = 0
    launches_stack = 0


def _bind():
    global _lib
    if _lib is None:
        fn = load("w4a8_qmatmul").w4a8_qmatmul_launch
        c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [
            c_void_p, c_int, c_int,  # x, x_bf16, E
            c_int, c_int, c_int,  # M, K, S
            c_void_p, c_void_p, c_int,  # src_tail, outlier_idx, T
            c_void_p, c_void_p, c_void_p, c_void_p, c_int,  # w4, s4, w8, s8, N
            c_float, c_float,  # qmax, inv_qmax
            c_void_p, c_int, c_void_p, c_int,  # q2, Hp, q8, Tp
            c_void_p,  # scale
            c_int, c_int, c_int, c_void_p, c_void_p,  # tile, stages, nsplit, acc, counters
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def row_layout(h: int, t: int) -> Tuple[int, int]:
    """``(Hp, Tp)``: the columns of each half of ``q2`` (``h`` = (K+S)/2
    byte rows of ``w4``) and of ``q8`` (``t`` outlier rows), each rounded
    up to whole 32-row stages; ``q2`` is ``[M, 2 * Hp]``, ``q8`` ``[M,
    Tp]`` (row strides the TMA reads)."""
    return h + (-h) % _STAGE_K, t + (-t) % _STAGE_K


@functools.lru_cache(maxsize=1024)
def launch_plan(m: int, st4: int, st8: int, n: int) -> Tuple[int, int, int, int, int]:
    """``(tile, stages_per_split, nsplit, accumulator bytes, counter bytes)``
    of an ``m``-row call over ``st4`` int4 stages (``Hp / 32``), ``st8``
    outlier stages (``Tp / 32``) and ``n`` columns: B1's tiles and split
    rule over the ``st4 + st8`` stages, int4 ones first, except that the
    decode tile's splits stop at one wave of blocks (132, one an SM): a
    B6 decode call reads half of B1's weight bytes, so a second wave's
    blocks cost more than they add (timed on the card). With a split the
    int32 accumulator holds ``acc4`` and, with outlier rows, ``acc8``
    (``[st8 > 0 ? 2 : 1, m, n]``), one split when that is over the bound."""
    return split_plan(m, st4 + st8, n, 2 if st8 else 1, one_wave=tile_for(m) == 0)


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
    """The plain PyTorch version (CPU path; the card's correctness oracle).
    An expert stack (x ``[E, M, K]`` and every other operand with a leading
    ``[E]``) runs the 2-D version on each expert."""
    if x.ndim == 3:
        return ref.over_experts(w4a8_matmul_plain, x, (w4, s4, w8, s8, src_tail, outlier_idx),
                                bits=bits, out_dtype=out_dtype)
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
    if ke > _MAX_KE:
        raise ValueError(f"K + S = {ke} over {_MAX_KE}: the int4 sum would overflow int32")
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
    ``[0, K+S)`` (the layout :func:`repro_torch.core.ocs.to_w4a8` makes).
    An expert stack (x [E, M, K], every other operand with a leading [E])
    is one call -> [E, M, N]; a 2-D call runs as the stack of one."""
    global launches, launches_stack
    stacked = x.ndim == 3
    if stacked:
        e = x.shape[0]
        if w4.ndim != 3 or w8.ndim != 3 or src_tail.ndim != 2 or outlier_idx.ndim != 2:
            raise ValueError(f"want w4 [E, (K+S)/2, N], w8 [E, T, N], src_tail [E, S], "
                             f"outlier_idx [E, T], got {tuple(w4.shape)}, {tuple(w8.shape)}, "
                             f"{tuple(src_tail.shape)}, {tuple(outlier_idx.shape)}")
        s4 = stack_scales(s4, e, w4.shape[2], x.device)
        s8 = stack_scales(s8, e, w4.shape[2], x.device)
        src_tail, outlier_idx = src_tail.contiguous(), outlier_idx.contiguous()
        for name, t in (("x", x), ("w4", w4), ("w8", w8), ("src_tail", src_tail),
                        ("outlier_idx", outlier_idx)):
            if t.shape[0] != e:
                raise ValueError(f"w4a8_matmul_cuda: {name} has {t.shape[0]} experts, want {e}")
            if not t.is_contiguous():
                raise ValueError(f"w4a8_matmul_cuda: {name} must be contiguous")
        if e == 0:
            raise ValueError("w4a8_matmul_cuda: no experts")
        _check(x[0], w4[0], s4[0], w8[0], s8[0], src_tail[0], outlier_idx[0], bits)  # one slice
    else:
        s4, s8 = s4.reshape(-1), s8.reshape(-1)
        _check(x, w4, s4, w8, s8, src_tail, outlier_idx, bits)
        x, w4, s4, w8, s8, src_tail, outlier_idx = (
            t[None] for t in (x, w4, s4, w8, s8, src_tail, outlier_idx))
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    n_out = w4.shape[2]
    check_cols("w4a8_matmul_cuda", n_out, 16)  # the TMA reads rows of 16 bytes
    out = torch.empty((x.shape[0], x.shape[1], n_out), dtype=out_dtype, device=x.device)
    err = launch(_bind(), x, w4, s4, w8, s8, src_tail, outlier_idx, out,
                 float((1 << (bits - 1)) - 1))
    if err != 0:
        raise RuntimeError(f"w4a8_qmatmul launch failed: cudaError {err}")
    launches += 1
    launches_stack += stacked
    return out if stacked else out[0]


def launch(fn, x, w4, s4, w8, s8, src_tail, outlier_idx, out, qmax: float) -> int:
    """Run B6's entry point ``fn`` (the prologue and the GEMM) once over
    ``x`` ``[M, K]`` or an expert stack ``[E, M, K]`` (E = 1 for 2-D x) into
    ``out`` with :func:`launch_plan`'s tile and split of one expert's
    shapes, the row scratch (``q2`` [E, M, 2 * Hp] int8, ``q8`` [E, M, Tp]
    int8 when T > 0, ``scale`` [E, M] f32: :func:`row_layout`) and, with a
    split, the int32 accumulator ``[E, sums, M, N]`` and E sets of counters
    (zero at rest: the kernel leaves them zero), all kept per device
    (``scratch``; reuse relies on stream order). Returns the entry point's
    cudaError (0 = ok)."""
    e = x.shape[0] if x.ndim == 3 else 1
    m, k = x.shape[-2:]
    h, n = w4.shape[-2:]
    t = outlier_idx.shape[-1]
    hp, tp = row_layout(h, t)
    dev = x.device
    tile, per, nsplit, acc_bytes, count_bytes = launch_plan(
        m, hp // _STAGE_K, tp // _STAGE_K, n)
    q2 = scratch.buffer("b6_q2", dev, e * m * 2 * hp)
    q8 = scratch.buffer("b6_q8", dev, e * m * tp).data_ptr() if t else None
    scale = scratch.buffer("b6_scale", dev, 4 * e * m)
    acc = counters = None
    if nsplit > 1:
        acc = scratch.buffer("b6_acc", dev, e * acc_bytes, zeroed=True).data_ptr()
        counters = scratch.buffer("split_k_counters", dev, e * count_bytes,
                                  zeroed=True).data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return fn(
        x.data_ptr(), int(x.dtype == torch.bfloat16), e, m, k, 2 * h - k,
        src_tail.data_ptr(), outlier_idx.data_ptr(), t,
        w4.data_ptr(), s4.data_ptr(), w8.data_ptr(), s8.data_ptr(), n,
        qmax, ref.inv_qmax(qmax),
        q2.data_ptr(), hp, q8, tp, scale.data_ptr(), tile, per, nsplit, acc, counters,
        out.data_ptr(), int(out.dtype == torch.bfloat16), stream,
    )
