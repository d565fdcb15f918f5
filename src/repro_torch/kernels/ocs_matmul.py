"""Quantized matmul with fused OCS channel expansion: CUDA kernel wrapper and
its plain PyTorch version.

Replaces ``repro/kernels/ocs_matmul.py::_kernel`` (``ocs_matmul_kernel`` /
``ocs_quant_matmul``), the kernel every linear layer runs in the engine's
default ``dequant`` mode: ``y = x_exp @ w8 * (x_scale[m] * w_scale[n])``
with ``x_exp = [x | x[:, src_tail] * tail_mult]``, the expanded activations
never written to device memory. Float x (f32/bf16) is weight-only (f32
accumulation); int8 x is W8A8 (int32 accumulation). The CUDA source is
``csrc/ocs_matmul.cu``; what bounds it on the card is the int8 weight bytes
at decode and the multiply-adds at prefill.

**Routes** (:func:`tc_route`, chosen from the operands and the caller's
declaration, never by a failure and never by a read from the device): bf16
x with ``tail_mult`` None or declared a 0/1 mask (``tail_is_mask=True``, as
``dense`` declares a packed leaf's) -- every linear layer of ``dequant``
serving -- runs B5's bf16 tensor-core GEMM (``csrc/wo_tc_gemm.cuh``'s
decode tile or ``csrc/wo_tc_prefill.cuh``'s prefill tile, by
:func:`repro_torch.kernels.quant_matmul.tc_plan`) with the tail gathered
inside it; f32 x, or multipliers not declared a mask, run
the CUDA-core weight-only GEMM (counted in ``launches_cuda_cores``); int8 x
the dp4a GEMM. The split of K follows from (K, S, N) alone on every route.

**Contract** (the reference wrapper's): ``w8`` is ``[K + S, N]`` with the S
OCS duplicate rows after the K originals, N a multiple of 4 (16 for an
expert stack; a leaf stores a ragged N padded, as in B5); ``x_scale`` ([M], a scalar, or
None = 1) and ``w_scale`` ([N] or a scalar) broadcast; ``out_dtype``
defaults to f32 on the int8 path and to ``x.dtype`` otherwise. On the int8
path ``tail_mult`` must be a 0/1 mask (checked, or declared with
``tail_is_mask=True``): fractional multipliers would need requantization and
belong folded into the weight rows. On the weight-only path the declaration
is a promise the route relies on (bf16 x times a declared mask is taken as
exact in bf16) and is not checked: checking would read the device. S == 0
routes to B5 (:mod:`repro_torch.kernels.quant_matmul`), as in the
reference. The int8 path is bitwise
:func:`repro_torch.kernels.ref.ocs_quant_matmul_ref`; the weight-only path
equals it up to the order of the float32 sums.

**The expert axis.** bf16 x ``[E, M, K]`` against a stack ``w8 [E, K + S,
N]`` (``w_scale [E, N]``, ``src_tail`` and ``tail_mult`` ``[E, S]``: a MoE
layer's experts, M = the capacity) is one launch of the tensor-core route
over all E experts, each expert's slice bitwise the 2-D call on it
(:func:`repro_torch.kernels.quant_matmul.launch_tc_stack`); the other
routes take no stack. S == 0 runs B5's stacked launch. Its plain version
loops over the 2-D one.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import quant_matmul as _qm
from . import ref
from .build import load

__all__ = [
    "ocs_quant_matmul_plain",
    "ocs_quant_matmul_cuda",
    "tc_route",
    "launches",
    "launches_cuda_cores",
    "launches_stack",
    "reset_launches",
]

# Wrapper calls that launched the CUDA kernel (calls with S == 0 launch B5
# and count there), and those of them that took the CUDA-core weight-only
# GEMM (f32 x, or multipliers not declared a mask) rather than the tensor
# cores.
launches = 0
launches_cuda_cores = 0
# Of ``launches``, those over an expert stack (one launch a stacked matrix).
launches_stack = 0

_lib = {}


def reset_launches() -> None:
    global launches, launches_cuda_cores, launches_stack
    launches = 0
    launches_cuda_cores = 0
    launches_stack = 0


def _bind():
    if not _lib:
        lib = load("ocs_matmul")
        c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
        wo = lib.ocs_matmul_wo_launch
        wo.argtypes = [
            c_void_p, c_int, c_int, c_int, c_int,  # x, x_bf16, M, K, S
            c_void_p, c_void_p,  # src_tail, tail_mult
            c_void_p, c_void_p, c_void_p, c_int,  # w8, xs, ws, N
            c_int, c_int, c_void_p,  # k_chunk, nsplit, part
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        wo.restype = c_int
        tc = lib.ocs_matmul_tc_launch
        tc.argtypes = [
            c_void_p, c_int, c_int, c_int, c_int,  # x, E, M, K, S
            c_void_p, c_void_p,  # src_tail, tail_mult
            c_void_p, c_void_p, c_void_p, c_int,  # w8, xs, ws, N
            c_int, c_int, c_int,  # k_chunk, nsplit, tile
            c_void_p, c_void_p,  # part, counters
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        tc.restype = c_int
        i8 = lib.ocs_matmul_int8_launch
        i8.argtypes = [
            c_void_p, c_int, c_int, c_int,  # x, M, K, S
            c_void_p, c_void_p,  # src_tail, mask
            c_void_p, c_void_p, c_void_p, c_int,  # w8, xs, ws, N
            c_void_p, c_int, c_void_p,  # q, Kp, acc
            c_void_p, c_int, c_void_p,  # out, out_bf16, stream
        ]
        i8.restype = c_int
        _lib.update(wo=wo, tc=tc, int8=i8)
    return _lib


def _tail_mult(x: torch.Tensor, tail_mult, tail_is_mask: bool):
    """The tail multipliers as the kernels take them: float32 on the
    weight-only path; an int8 0/1 mask on the int8 path, where anything
    else raises."""
    if tail_mult is None:
        return None
    tm = torch.as_tensor(tail_mult, device=x.device)
    if x.dtype != torch.int8:
        return tm.to(torch.float32).reshape(-1).contiguous()
    if not tail_is_mask and not bool(((tm == 0) | (tm == 1)).all()):
        raise ValueError(
            "fractional tail_mult on the int8 path would need requantization; "
            "fold the multipliers into the packed weight rows (or declare a "
            "0/1 mask with tail_is_mask=True)"
        )
    return tm.to(torch.int8).reshape(-1).contiguous()


def tc_route(x: torch.Tensor, mult: Optional[torch.Tensor], tail_is_mask: bool) -> bool:
    """True when a weight-only call takes the bf16 tensor cores: bf16 x
    whose tail multipliers are absent or declared a 0/1 mask by
    ``tail_is_mask``, so that every product is exact in bf16. The
    multipliers are never read here (a read would wait on the device at
    every call and break a CUDA-graph capture): undeclared ones, like f32
    x, take the CUDA-core GEMM. int8 x never comes here."""
    return x.dtype == torch.bfloat16 and (mult is None or tail_is_mask)


def _split(x, w8, src_tail):
    if x.ndim != 2 or w8.ndim != 2 or src_tail.ndim != 1:
        raise ValueError(
            f"want x [M, K], w8 [K+S, N], src_tail [S]; got {tuple(x.shape)}, "
            f"{tuple(w8.shape)}, {tuple(src_tail.shape)}"
        )
    s = w8.shape[0] - x.shape[1]
    if s < 0 or s != src_tail.shape[0]:
        raise ValueError(
            f"w8 rows {w8.shape[0]} != K {x.shape[1]} + S {src_tail.shape[0]}"
        )
    return s


def ocs_quant_matmul_plain(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale,
    src_tail: torch.Tensor,
    x_scale=None,
    tail_mult=None,
    *,
    tail_is_mask: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain PyTorch version (CPU path; the card's correctness oracle).
    An expert stack (x ``[E, M, K]``, w8 ``[E, K+S, N]``, w_scale ``[E, N]``,
    src_tail and tail_mult ``[E, S]``, x_scale None) runs the 2-D version
    on each expert."""
    if x.ndim == 3:
        if x_scale is not None:
            raise ValueError("ocs_quant_matmul_plain: an expert stack takes no x_scale")
        return ref.over_experts(
            lambda xe, we, se, te, me: ocs_quant_matmul_plain(
                xe, we, se, te, None, me, tail_is_mask=tail_is_mask, out_dtype=out_dtype),
            x, (w8, w_scale, src_tail, tail_mult))
    s = _split(x, w8, src_tail)
    mult = _tail_mult(x, tail_mult, tail_is_mask)
    if s == 0:  # no splits: the plain matmul (B5)
        return _qm.quant_matmul_plain(x, w8, w_scale, x_scale, out_dtype=out_dtype)
    xs, ws = _qm.scales(x, w_scale, x_scale, w8.shape[1])
    return ref.ocs_quant_matmul_ref(x, w8, ws, src_tail, xs, mult,
                                    _qm.out_dtype_for(x, out_dtype))


def ocs_quant_matmul_cuda(
    x: torch.Tensor,
    w8: torch.Tensor,
    w_scale,
    src_tail: torch.Tensor,
    x_scale=None,
    tail_mult=None,
    *,
    tail_is_mask: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel. x: [M, K] f32/bf16 (weight-only) or int8;
    w8: [K+S, N] int8; src_tail: [S] int32 -> [M, N] ``out_dtype`` (f32 or
    bf16). S == 0 launches B5; the weight-only route is :func:`tc_route`'s.
    An expert stack (x [E, M, K] bf16, w8 [E, K+S, N], w_scale [E, N],
    src_tail and tail_mult [E, S]) is one launch on the tensor cores -> [E,
    M, N]. Raises on anything the kernels do not take."""
    global launches, launches_cuda_cores
    if x.ndim == 3:
        return _ocs_stack_cuda(x, w8, w_scale, src_tail, x_scale, tail_mult, tail_is_mask,
                               out_dtype)
    s = _split(x, w8, src_tail)
    mult = _tail_mult(x, tail_mult, tail_is_mask)
    if s == 0:
        return _qm.quant_matmul_cuda(x, w8, w_scale, x_scale, out_dtype=out_dtype)
    out_dtype = _qm.out_dtype_for(x, out_dtype)
    _qm.check_cuda_operands("ocs_quant_matmul_cuda", x, w8, s, out_dtype)
    if not src_tail.is_cuda or src_tail.device != x.device or src_tail.dtype != torch.int32:
        raise ValueError("ocs_quant_matmul_cuda: src_tail must be int32 on x's device")
    if mult is not None and mult.numel() != s:
        raise ValueError(f"ocs_quant_matmul_cuda: tail_mult has {mult.numel()} entries, want S = {s}")
    src_tail = src_tail.contiguous()
    m, k = x.shape
    n_out = w8.shape[1]
    xs, ws = _qm.scales(x, w_scale, x_scale, n_out)
    _qm.check_cols("ocs_quant_matmul_cuda", n_out)
    n = n_out
    dev = x.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fns = _bind()
    mult_ptr = None if mult is None else mult.data_ptr()
    cuda_cores = False
    if x.dtype == torch.int8:
        stream = torch.cuda.current_stream(dev).cuda_stream
        out_bf16 = int(out_dtype == torch.bfloat16)
        kp = (k + s) + (-(k + s)) % 16
        q = torch.empty((m, kp), dtype=torch.int8, device=dev)
        acc = torch.empty((m, n), dtype=torch.int32, device=dev)
        err = fns["int8"](
            x.data_ptr(), m, k, s, src_tail.data_ptr(), mult_ptr,
            w8.data_ptr(), _qm._ptr(xs), ws.data_ptr(), n,
            q.data_ptr(), kp, acc.data_ptr(), out.data_ptr(), out_bf16, stream,
        )
    elif tc_route(x, mult, tail_is_mask):
        err = _qm.launch_tc(fns["tc"], x, out, xs, ws, _qm.tc_rows(k, s), s,
                            src_tail.data_ptr(), mult_ptr, w8.data_ptr())
    else:
        cuda_cores = True
        err = _qm.launch_wo(fns["wo"], x, out, xs, ws, k + s, s, src_tail.data_ptr(),
                            mult_ptr, w8.data_ptr())
    if err != 0:
        raise RuntimeError(f"ocs_matmul launch failed: cudaError {err}")
    launches += 1
    launches_cuda_cores += cuda_cores
    return out


def _ocs_stack_cuda(x, w8, w_scale, src_tail, x_scale, tail_mult, tail_is_mask,
                    out_dtype) -> torch.Tensor:
    """:func:`ocs_quant_matmul_cuda` of an expert stack: one launch of the
    tensor-core entry point over all E experts (B5's with no tail)."""
    global launches, launches_stack
    if x_scale is not None:
        raise ValueError("ocs_quant_matmul_cuda: an expert stack takes no x_scale")
    if w8.ndim != 3 or src_tail.ndim != 2:
        raise ValueError(f"ocs_quant_matmul_cuda: want w8 [E, K+S, N] and src_tail [E, S], got "
                         f"{tuple(w8.shape)}, {tuple(src_tail.shape)}")
    e, m, k = x.shape
    s = w8.shape[1] - k
    if s < 0 or s != src_tail.shape[1]:
        raise ValueError(f"ocs_quant_matmul_cuda: w8 rows {w8.shape[1]} != K {k} + S "
                         f"{src_tail.shape[1]}")
    if s == 0:
        return _qm.quant_matmul_cuda(x, w8, w_scale, None, out_dtype=out_dtype)
    mult = None
    if tail_mult is not None:
        mult = torch.as_tensor(tail_mult, device=x.device).to(torch.float32).reshape(e, -1)
        mult = mult.contiguous()
    if not tc_route(x, mult, tail_is_mask):
        raise ValueError("ocs_quant_matmul_cuda: an expert stack runs the tensor-core route "
                         "only (bf16 x; tail multipliers absent or declared a 0/1 mask)")
    out_dtype = _qm.out_dtype_for(x, out_dtype)
    if w8.dtype != torch.int8 or src_tail.dtype != torch.int32:
        raise ValueError("ocs_quant_matmul_cuda: want int8 w8 and int32 src_tail")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ocs_quant_matmul_cuda: out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    n_out = w8.shape[2]
    ws = _qm.stack_scales(w_scale, e, n_out, x.device)
    src_tail = src_tail.contiguous()
    _qm.check_stack("ocs_quant_matmul_cuda", x, w8, ws, (src_tail, mult))
    _qm.check_cols("ocs_quant_matmul_cuda", n_out, 16)  # the stacked TMA reads rows of 16 bytes
    out = torch.empty((e, m, n_out), dtype=out_dtype, device=x.device)
    err = _qm.launch_tc_stack(_bind()["tc"], x, out, None, ws, _qm.tc_rows(k, s), s,
                              src_tail.data_ptr(), None if mult is None else mult.data_ptr(),
                              w8.data_ptr())
    if err != 0:
        raise RuntimeError(f"ocs_matmul launch failed: cudaError {err}")
    launches += 1
    launches_stack += 1
    return out
