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
tail: bf16 x on the tensor cores, ``csrc/wo_tc_gemm.cuh``'s decode tile or
``csrc/wo_tc_prefill.cuh``'s prefill tile by :func:`tc_plan`, f32 x on the
CUDA cores); what bounds it on the card is the int8 weight bytes at decode and
the multiply-adds at prefill.

**Contract**: ``x_scale`` ([M], a scalar, or None = 1) and ``w_scale``
([N] or a scalar) broadcast; N a multiple of 4, the kernels' weight
words (16 for an expert stack, the TMA's row alignment): a quantized leaf
stores a ragged N's columns zero-padded to a multiple of 16 once
(``core.ocs.pad_out_cols``), where the reference's wrapper pads N to its
tile on every call, and :func:`check_cols` refuses an unpadded one;
``out_dtype`` defaults to f32 on the int8 path
and to ``x.dtype`` otherwise. The int8 path is bitwise
:func:`repro_torch.kernels.ref.quant_matmul_ref`; the weight-only path
equals it up to the order of the float32 sums (the kernel's order is fixed,
so its output does not change from run to run).

**The expert axis.** x ``[E, M, K]`` bf16 against a stack ``w8 [E, K, N]``
(``w_scale [E, N]``; a MoE layer's experts, M = the capacity) is one
launch over all E experts (:func:`launch_tc_stack`), each expert's slice
bitwise the 2-D call on it: the tile and split are the plan of one
expert's shapes, so either tile may serve. Its plain version loops over
the 2-D one (:func:`repro_torch.kernels.ref.over_experts`).
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
    "padded_cols",
    "pad_cols",
    "check_cols",
    "tc_rows",
    "tc_split_plan",
    "tc_plan",
    "tc_stack_plan",
    "launch_tc_stack",
    "stack_scales",
    "check_stack",
    "TC_DECODE",
    "TC_PREFILL",
    "TC_TILE_NAMES",
    "launches",
    "launches_stack",
    "reset_launches",
]

# Wrapper calls that launched the CUDA kernel.
launches = 0
# Of ``launches``, those over an expert stack (one call a stacked matrix).
launches_stack = 0

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
# Its tiles (tc_plan): the decode tile (8-32 tokens a block, split K over
# the grid, csrc/wo_tc_gemm.cuh) and the prefill tile (csrc/wo_tc_prefill.cuh:
# 64 tokens x 128 columns a block, each weight stage converted once per 64
# tokens, every split of a block walked in time, no workspace). A call takes
# the prefill tile from _TC_PREFILL_MIN_ROWS rows on once its 64 x 128 tiles
# reach _TC_PREFILL_MIN_TILES, enough to give most of the H100's 132 SMs a
# block; with fewer (glm4-9b's wk/wv, 2 column tiles) the decode tile's
# splits over the grid were faster. Both thresholds were chosen by timing
# both tiles at glm4-9b's shapes (``launch/kernel_times.py --tiles``;
# PERF.md). Both tiles sum every element in one order, so the choice
# changes no bit. The tile indices are the entry points' ``tile``.
TC_DECODE, TC_PREFILL = 0, 1
TC_TILE_NAMES = ("decode", "prefill")
_TC_PREFILL_TOKS = 64
_TC_PREFILL_MIN_ROWS = 64
_TC_PREFILL_MIN_TILES = 96


def reset_launches() -> None:
    global launches, launches_stack
    launches = 0
    launches_stack = 0


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
            c_void_p, c_int, c_int, c_int,  # x, E, M, K
            c_void_p, c_void_p, c_void_p, c_int,  # w8, xs, ws, N
            c_int, c_int, c_int,  # k_chunk, nsplit, tile
            c_void_p, c_void_p,  # part, counters
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


def padded_cols(n: int, align: int = 4) -> int:
    """The columns a card GEMM runs for ``n`` output columns: ``n`` when
    ``n % align == 0``, else ``n`` rounded up to 16. B4 and B5 read
    weights in 4-column words, B1's and B6's TMA in rows of a multiple of
    16 bytes (``align=16``); rows of 16 bytes also keep B4/B5 on their TMA
    path. The rounding never crosses a 128- or 256-column tile, so the
    split of K, and every column below ``n``, is what an aligned call of
    the same columns gives. A quantized leaf stores its columns padded to a
    multiple of 16 (``core.ocs.pad_out_cols``), which every GEMM takes as
    it is."""
    return n if n % align == 0 else n + (-n) % 16


def pad_cols(t: torch.Tensor, cols: int) -> torch.Tensor:
    """``t`` with its last dimension zero-padded to ``cols`` (contiguous)."""
    pad = cols - t.shape[-1]
    return t if pad == 0 else torch.nn.functional.pad(t, (0, pad)).contiguous()


def check_cols(what: str, n: int, align: int = 4) -> None:
    """Refuse an ``n`` the card's GEMM does not take as it is (see
    :func:`padded_cols`): its weights are padded once, when the tree is
    built (``core.ocs.pad_out_cols``), never per call."""
    if n % align:
        raise ValueError(
            f"{what}: N = {n} is not a multiple of {align}; pad the weight's columns "
            f"when the tree is built (repro_torch.core.ocs.pad_out_cols)")


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


def tc_plan(m: int, k: int, kv: int, n: int,
            max_part: int) -> Tuple[int, int, int, int, int, int]:
    """``(tile, k_chunk, nsplit, rows, workspace bytes, counter bytes)`` of
    an ``m``-row call of the tensor-core GEMM over ``k`` columns of x,
    ``kv`` rows of contraction (:func:`tc_rows`) and ``n`` columns. Both
    tiles take :func:`tc_split_plan`'s split of ``kv`` rows for ``n``
    columns. ``TC_PREFILL`` (one launch: no row chunks, no workspace, no
    counter) from ``_TC_PREFILL_MIN_ROWS`` rows on, for operands the TMA
    takes (``n % 16 == 0``, ``k % 8 == 0``) and at least
    ``_TC_PREFILL_MIN_TILES`` tiles of 64 x 128; else ``TC_DECODE``, with
    :func:`_tc_launch_plan`'s row chunks, workspace (within ``max_part``)
    and counters, its splits in space (one a block). Operands the TMA cannot
    take run the decode tile's non-TMA branch."""
    tiles = math.ceil(m / _TC_PREFILL_TOKS) * math.ceil(n / _TC_COLS)
    if (m >= _TC_PREFILL_MIN_ROWS and n % 16 == 0 and k % 8 == 0
            and tiles >= _TC_PREFILL_MIN_TILES):
        return (TC_PREFILL, *tc_split_plan(kv, n), m, 0, 0)
    return (TC_DECODE, *_tc_launch_plan(m, kv, n, max_part))


def tc_stack_plan(e: int, m: int, k: int, kv: int,
                  n: int) -> Tuple[int, int, int, int, int]:
    """``(tile, k_chunk, nsplit, workspace bytes, counter bytes)`` of a
    stacked call over ``e`` experts of ``m`` rows each: :func:`tc_plan`'s
    tile and split of one expert's shapes (so every slice sums as the 2-D
    call on it), in one launch (no row chunks): with the decode tile's
    splits, ``e`` workspaces ``[nsplit, m, n]`` and ``e`` sets of
    counters."""
    tile, k_chunk, nsplit = tc_plan(m, k, kv, n, _MAX_PART_BYTES)[:3]
    if tile == TC_PREFILL or nsplit == 1:
        return tile, k_chunk, nsplit, 0, 0
    return (tile, k_chunk, nsplit, 4 * e * nsplit * m * n,
            4 * e * math.ceil(m / 8) * math.ceil(n / _TC_COLS))


def launch_tc_stack(fn, x, out, xs, ws, kv: int, *args) -> int:
    """Run a bf16 tensor-core entry point (B5's, or B4's with its OCS tail)
    once over ``x [E, M, K]`` into ``out [E, M, N]`` with
    :func:`tc_stack_plan`'s plan, its workspace and counters kept per
    device. ``ws`` is ``[E, N]``, ``xs`` ``[E, M]`` or None (= 1); ``args``
    are the entry point's arguments between ``K`` and ``xs``. Returns the
    cudaError (0 = ok)."""
    e, m, k = x.shape
    n = out.shape[-1]
    tile, k_chunk, nsplit, part_bytes, count_bytes = tc_stack_plan(e, m, k, kv, n)
    part = counters = None
    if part_bytes:
        part = scratch.buffer("split_k", x.device, part_bytes).data_ptr()
        counters = scratch.buffer("split_k_counters", x.device, count_bytes,
                                  zeroed=True).data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return fn(x.data_ptr(), e, m, k, *args, _ptr(xs), ws.data_ptr(), n, k_chunk, nsplit, tile,
              part, counters, out.data_ptr(), int(out.dtype == torch.bfloat16), stream)


def stack_scales(w_scale, e: int, n: int, dev) -> torch.Tensor:
    """An expert stack's per-column scales as a contiguous float32 ``[E,
    N]`` on ``dev``: ``[E, N]`` (or ``[E, 1, N]``) as it is, a per-tensor
    ``[E, 1, 1]`` broadcast over the columns. Scales of another expert
    count raise ``ValueError``."""
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
    if ws.numel() not in (e, e * n) or (ws.ndim and ws.shape[0] != e):
        raise ValueError(f"scales of shape {tuple(ws.shape)} for {e} experts of {n} columns")
    ws = ws.reshape(e, -1)
    if ws.shape[1] == 1 and n != 1:
        ws = ws.expand(e, n)
    return ws.contiguous()


def check_stack(what: str, x, w, ws, others=()) -> None:
    """The checks of an expert-stacked call: x ``[E, M, K]`` bf16 on the
    card with K % 8 == 0 (the stacked launch reads x through the TMA only),
    ``w`` ``[E, rows, N]``, ``ws`` ``[E, N]`` float32 and every other
    stacked operand with the same E, all contiguous on x's device."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"{what}: want x [E, M, K] and weights [E, rows, N], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: an expert stack takes bfloat16 x, got {x.dtype}")
    if x.shape[2] % 8:
        raise ValueError(f"{what}: an expert stack takes K % 8 == 0, got K = {x.shape[2]}")
    e, n = x.shape[0], w.shape[-1]
    if ws.shape != (e, n) or ws.dtype != torch.float32:
        raise ValueError(f"{what}: want float32 scales [E, N] = [{e}, {n}], got "
                         f"{ws.dtype} {tuple(ws.shape)}")
    for t in (x, w, ws) + tuple(t for t in others if t is not None):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: every operand must be on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.shape[0] != e:
            raise ValueError(f"{what}: an operand has {t.shape[0]} experts, want {e}")
    if x.shape[1] == 0 or x.shape[2] == 0 or n == 0:
        raise ValueError(f"{what}: empty operand")


def launch_tc(fn, x, out, xs, ws, kv: int, *args) -> int:
    """Run a bf16 tensor-core entry point (B5's, or B4's with its OCS tail)
    over ``x``'s rows with :func:`tc_plan`'s tile and :func:`tc_split_plan`'s
    split of ``kv`` rows of contraction (:func:`tc_rows`), in row chunks
    when the split needs a workspace (kept per device, as are the
    counters). ``args`` are the entry point's arguments between ``K`` and
    ``xs``; ``xs`` may be None (= 1). Returns the first nonzero cudaError,
    else 0."""
    m, k = x.shape
    n = out.shape[1]
    tile, k_chunk, nsplit, rows, part_bytes, count_bytes = tc_plan(m, k, kv, n,
                                                                   _MAX_PART_BYTES)
    part = counters = None
    if part_bytes:
        part = scratch.buffer("split_k", x.device, part_bytes).data_ptr()
        counters = scratch.buffer("split_k_counters", x.device, count_bytes,
                                  zeroed=True).data_ptr()
    out_bf16 = int(out.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r in range(0, m, rows):
        xr, outr = (x, out) if rows == m else (x[r:r + rows], out[r:r + rows])
        xsr = xs if xs is None or rows == m else xs[r:r + rows]
        err = fn(xr.data_ptr(), 1, xr.shape[0], k, *args, _ptr(xsr), ws.data_ptr(), n,
                 k_chunk, nsplit, tile, part, counters, outr.data_ptr(), out_bf16, stream)
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
    """The plain PyTorch version (CPU path; the card's correctness oracle).
    An expert stack (x ``[E, M, K]``, w8 ``[E, K, N]``, w_scale ``[E, N]``,
    x_scale None) runs the 2-D version on each expert."""
    if x.ndim == 3:
        if x_scale is not None:
            raise ValueError("quant_matmul_plain: an expert stack takes no x_scale")
        return ref.over_experts(quant_matmul_plain, x, (w8, w_scale), out_dtype=out_dtype)
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
    ``out_dtype`` (f32 or bf16). An expert stack, x [E, M, K] bf16 against
    w8 [E, K, N] and w_scale [E, N], is one launch -> [E, M, N]. Raises on
    anything the kernel does not take."""
    global launches
    if x.ndim == 3:
        return _quant_matmul_stack_cuda(x, w8, w_scale, x_scale, out_dtype)
    out_dtype = out_dtype_for(x, out_dtype)
    check_cuda_operands("quant_matmul_cuda", x, w8, 0, out_dtype)
    m, k = x.shape
    n_out = w8.shape[1]
    xs, ws = scales(x, w_scale, x_scale, n_out)
    check_cols("quant_matmul_cuda", n_out)
    n = n_out
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


def _quant_matmul_stack_cuda(x, w8, w_scale, x_scale, out_dtype) -> torch.Tensor:
    """:func:`quant_matmul_cuda` of an expert stack: one launch of the
    tensor-core entry point over all E experts."""
    global launches, launches_stack
    if x_scale is not None:
        raise ValueError("quant_matmul_cuda: an expert stack takes no x_scale")
    out_dtype = out_dtype_for(x, out_dtype)
    ws = stack_scales(w_scale, w8.shape[0], w8.shape[2], x.device)
    check_stack("quant_matmul_cuda", x, w8, ws)
    if w8.dtype != torch.int8 or w8.shape[1] != x.shape[2]:
        raise ValueError(f"quant_matmul_cuda: want int8 w8 [E, K, N], got {w8.dtype} "
                         f"{tuple(w8.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_matmul_cuda: out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    e, m, k = x.shape
    n_out = w8.shape[2]
    check_cols("quant_matmul_cuda", n_out, 16)  # the stacked TMA reads rows of 16 bytes
    out = torch.empty((e, m, n_out), dtype=out_dtype, device=x.device)
    err = launch_tc_stack(_bind()["tc"], x, out, None, ws, k, w8.data_ptr())
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: cudaError {err}")
    launches += 1
    launches_stack += 1
    return out
