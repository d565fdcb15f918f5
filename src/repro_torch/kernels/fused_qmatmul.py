"""Fused dynamic-quant + OCS-expanded W8A8 matmul: CUDA kernel wrapper and
its plain PyTorch version.

Replaces ``repro/kernels/fused_qmatmul.py::_kernel`` (``fused_qmatmul_kernel``
/ ``fused_quant_matmul``), the Pallas TPU kernel that every linear layer of
the W8A8 serving path runs. The CUDA source is ``csrc/fused_qmatmul.cu``:
a row prologue (abs-max, scale, int8 row, OCS tail gather) and the int8
tensor-core GEMM of ``csrc/i8_tc_gemm.cuh`` with the f32 epilogue in it --
two launches a call; the TPU kernel's resident [bm, K] row tile does not
fit a block's shared memory at K = 4096 or 13696. What bounds it on the
card: the int8 weight bytes at decode (M <= 8), the int8 multiply-adds at
prefill. It takes every K (the reference's VMEM-budget fallback to XLA has
no counterpart here) and an N that is a multiple of 16: the TMA reads
weight rows of a multiple of 16 bytes, and a quantized leaf stores a
ragged N's columns zero-padded to one (``core.ocs.pad_out_cols``, where
the reference's wrapper pads N to its tile on every call).

**Plan** (:func:`launch_plan`, from (M, Kp, N) on the host): the block tile
(8 tokens x 256 columns up to M = 8, else 64 x 128) and the split
of K over the grid, which fills the SMs at small M; the integer sums are
exact in any order, so the plan never moves a bit. The row scratch, the
split-K accumulator and its counters are kept per device
(:mod:`repro_torch.kernels.scratch`), so a steady loop, or a CUDA-graph
capture after one sizing call, allocates only the output.

**Contract** (``repro.core.ocs`` layout): ``w8`` is the *packed* expanded
weight matrix ``[K + S, N]`` (duplicated channels after the K originals,
multipliers folded in, padding rows zero); the per-row activation scale
covers the K original channels only; outputs are bitwise
:func:`repro_torch.kernels.ref.fused_quant_matmul_ref`.

**The expert axis.** x ``[E, M, K]`` against a stack ``w8 [E, K + S, N]``
(``w_scale [E, N]``, ``src_tail [E, S]``: a MoE layer's experts, M = the
capacity) is one call over all E experts (:func:`launch`: the prologue
over every expert's rows, then one GEMM launch), with the plan of one
expert's shapes and the workspaces sized for the stack; each expert's
slice is bitwise the 2-D call on it, which is the stack of one. Its plain
version loops over the 2-D one.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import ref, scratch
from .build import load
from .quant_matmul import check_cols, stack_scales

__all__ = [
    "fused_quant_matmul_plain",
    "fused_quant_matmul_cuda",
    "launch",
    "launch_plan",
    "launches",
    "launches_stack",
    "split_plan",
    "reset_launches",
]

# Wrapper calls that launched the CUDA kernel (one per call: the prologue
# and the GEMM of one call count once).
launches = 0
# Of ``launches``, those over an expert stack (one call a stacked matrix).
launches_stack = 0

# The int8 tensor-core GEMM's block tiles (csrc/i8_tc_gemm.cuh), as (tokens,
# columns, blocks wanted): tile 0 for decode (M <= 8) at one block an SM of
# the H100's 132, tile 1 above M = 8 at two (its occupancy). The
# contraction goes in stages of 32 rows, split over the grid until the
# tiles reach the blocks wanted, with at least 4 stages a split; the
# splits meet in an int32 accumulator [M, N] (zero at rest; B6's [2, M, N]
# with outlier rows), so a split needs it within _MAX_ACC_BYTES.
_TILES = ((8, 256, 132), (64, 128, 264))
_STAGE_K = 32
_MIN_SPLIT_STAGES = 4
_MAX_ACC_BYTES = 64 << 20

_lib = None


def reset_launches() -> None:
    global launches, launches_stack
    launches = 0
    launches_stack = 0


def _bind():
    global _lib
    if _lib is None:
        lib = load("fused_qmatmul")
        fn = lib.fused_qmatmul_launch
        c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [
            c_void_p, c_int, c_int, c_int, c_int, c_int, c_int,  # x, x_bf16, E, M, K, S, Kp
            c_void_p, c_void_p, c_void_p, c_int,  # src_tail, w8, w_scale, N
            c_float, c_float,  # qmax, inv_qmax
            c_void_p, c_void_p,  # q_exp, scale scratch
            c_int, c_int, c_int, c_void_p, c_void_p,  # tile, stages, nsplit, acc, counters
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        fn.restype = c_int
        _lib = fn
    return _lib


def tile_for(m: int) -> int:
    """The GEMM's block tile for an ``m``-row call (an index of ``_TILES``)."""
    return 0 if m <= 8 else 1


def split_plan(m: int, nst: int, n: int, sums: int = 1,
               one_wave: bool = False) -> Tuple[int, int, int, int, int]:
    """``(tile, stages_per_split, nsplit, accumulator bytes, counter bytes)``
    of an ``m``-row call over ``nst`` 32-row stages and ``n`` columns on the
    int8 tensor-core GEMM: :func:`tile_for`'s tile, the split of the
    stages, and with a split the int32 accumulator (``sums`` of ``[m, n]``)
    and one counter per token tile and column tile. B1 has one sum; B6
    (``kernels/w4a8_qmatmul.py``) two when it has outlier rows. The splits
    reach the blocks wanted (B1), or with ``one_wave`` stop short of them,
    so that no block waits for a second wave (B6 at decode)."""
    tile = tile_for(m)
    toks, cols, want = _TILES[tile]
    tiles = math.ceil(m / toks) * math.ceil(n / cols)
    reach = want // tiles if one_wave else math.ceil(want / tiles)
    nsplit = max(1, min(reach, nst // _MIN_SPLIT_STAGES))
    acc_bytes = 4 * sums * m * n
    if acc_bytes > _MAX_ACC_BYTES:
        nsplit = 1
    per = math.ceil(nst / nsplit)
    nsplit = math.ceil(nst / per)
    if nsplit == 1:
        return tile, per, 1, 0, 0
    return tile, per, nsplit, acc_bytes, 4 * tiles


@functools.lru_cache(maxsize=1024)
def launch_plan(m: int, kp: int, n: int) -> Tuple[int, int, int, int, int]:
    """:func:`split_plan` of an ``m``-row call over ``kp`` rows of
    contraction (K + S rounded up to 16), ``ceil(kp / 32)`` stages, and
    ``n`` columns."""
    return split_plan(m, math.ceil(kp / _STAGE_K), n)


def fused_quant_matmul_plain(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale: torch.Tensor,
    src_tail: torch.Tensor,
    *,
    bits: int = 8,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain PyTorch version (CPU path; the card's correctness oracle).
    An expert stack (x ``[E, M, K]``, w8 ``[E, K+S, N]``, w_scale ``[E,
    N]``, src_tail ``[E, S]``) runs the 2-D version on each expert."""
    if x.ndim == 3:
        return ref.over_experts(fused_quant_matmul_plain, x, (w8, w_scale, src_tail),
                                bits=bits, out_dtype=out_dtype)
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
    f32; f32 or bf16). An expert stack (x [E, M, K], w8 [E, K+S, N],
    w_scale [E, N], src_tail [E, S]) is one call -> [E, M, N]; a 2-D call
    runs as the stack of one. Raises on anything the kernel does not
    take."""
    global launches, launches_stack
    stacked = x.ndim == 3
    if stacked:
        if w8.ndim != 3 or src_tail.ndim != 2:
            raise ValueError(f"want w8 [E, K+S, N] and src_tail [E, S], got "
                             f"{tuple(w8.shape)}, {tuple(src_tail.shape)}")
        e = x.shape[0]
        ws = stack_scales(w_scale, e, w8.shape[2], x.device)
        src_tail = src_tail.contiguous()
        if e == 0 or w8.shape[0] != e or src_tail.shape[0] != e:
            raise ValueError(f"fused_quant_matmul_cuda: x, w8 and src_tail have {e}, "
                             f"{w8.shape[0]} and {src_tail.shape[0]} experts")
        for t in (x, w8):
            if not t.is_contiguous():
                raise ValueError("fused_quant_matmul_cuda: x and w8 must be contiguous")
        _check(x[0], w8[0], ws[0], src_tail[0], bits)  # the 2-D checks, on one slice
    else:
        ws = w_scale.reshape(-1)
        _check(x, w8, ws, src_tail, bits)
        x, w8, ws, src_tail = x[None], w8[None], ws[None], src_tail[None]
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    e, m = x.shape[:2]
    n_out = w8.shape[2]
    check_cols("fused_quant_matmul_cuda", n_out, 16)  # the TMA reads rows of 16 bytes
    out = torch.empty((e, m, n_out), dtype=out_dtype, device=x.device)
    err = launch(_bind(), x, w8, ws, src_tail, out, float((1 << (bits - 1)) - 1))
    if err != 0:
        raise RuntimeError(f"fused_qmatmul launch failed: cudaError {err}")
    launches += 1
    launches_stack += stacked
    return out if stacked else out[0]


def launch(fn, x, w8, w_scale, src_tail, out, qmax: float) -> int:
    """Run B1's entry point ``fn`` (the prologue and the GEMM) once over
    ``x`` ``[M, K]`` or an expert stack ``[E, M, K]`` (E = 1 for 2-D x) into
    ``out`` with :func:`launch_plan`'s tile and split of one expert's
    shapes, the row scratch (``q_exp`` [E, M, Kp] int8, ``scale`` [E, M]
    f32) and, with a split, the int32 accumulator ``[E, M, N]`` and E sets
    of counters (zero at rest: the kernel leaves them zero), all kept per
    device (``scratch``; reuse relies on stream order). Returns the entry
    point's cudaError (0 = ok)."""
    e = x.shape[0] if x.ndim == 3 else 1
    m, k = x.shape[-2:]
    ke, n = w8.shape[-2:]
    kp = ke + (-ke) % 16
    dev = x.device
    tile, per, nsplit, acc_bytes, count_bytes = launch_plan(m, kp, n)
    q_exp = scratch.buffer("b1_q_exp", dev, e * m * kp)
    scale = scratch.buffer("b1_scale", dev, 4 * e * m)
    acc = counters = None
    if nsplit > 1:
        acc = scratch.buffer("b1_acc", dev, e * acc_bytes, zeroed=True).data_ptr()
        counters = scratch.buffer("split_k_counters", dev, e * count_bytes,
                                  zeroed=True).data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return fn(
        x.data_ptr(), int(x.dtype == torch.bfloat16), e, m, k, ke - k, kp,
        src_tail.data_ptr(), w8.data_ptr(), w_scale.data_ptr(), n,
        qmax, ref.inv_qmax(qmax),
        q_exp.data_ptr(), scale.data_ptr(), tile, per, nsplit, acc, counters,
        out.data_ptr(), int(out.dtype == torch.bfloat16), stream,
    )
