"""Shared layer primitives with PTQ integration (the port of
``repro.models.layers``).

``dense`` is the entry point for every matmul. Its weight is a float
tensor, an :class:`OCSQuantLinear` or a :class:`W4A8Linear`; for the
quantized ones the ``mode`` argument (the engine's ``matmul_mode``,
threaded down from the model functions) picks the quantized matmul, and
every 2-D one goes through a kernel (``kernels.ops``: the CUDA kernel on
the card, its plain version on the CPU):

* ``dequant`` (the reference's default) -- weight-only int8:
  ``ops.ocs_quant_matmul`` (B4; B5 when the weight has no OCS split) on the
  bf16 activations, whose tail duplicates are gathered inside the kernel.
  A packed leaf (``is_packed()``, read from the device once per leaf and
  cached) declares its tail multipliers a 0/1 mask, so on the card the
  call takes the bf16 tensor cores without reading the mask back.
  The port follows the reference's **kernel route** numerics: float32 sums
  of the exact products of the widened activations and the int8 weights,
  then ``* w_scale``, rounded once to the activation dtype. It does not
  follow the reference's XLA route, which first rounds the dequantized
  weights to bf16 (``expand_activations(x) @ w.dequant(bf16)``).
* ``w8a8`` -- dynamic per-row int8 activations: the fused W8A8 kernel
  ``ops.fused_quant_matmul`` (B1).
* ``w4a8`` -- the sub-8-bit tier: a :class:`W4A8Linear` (made by
  ``core.ocs.to_w4a8``; the engine converts its tree at construction)
  through the W4A8 kernel ``ops.w4a8_matmul`` (B6). An ``OCSQuantLinear``
  in this mode, or a ``W4A8Linear`` in another, raises ``ValueError``.

An **expert stack** (a MoE layer's ``[E, ...]`` leaf: ``values [E, K+S,
N]`` with ``[E, ...]`` scales and split tables, or the same for
``W4A8Linear``) takes ``x [E, C, K]``, each expert's C rows (its capacity
slots), and makes one kernel call for the stack: on the card one launch
covers all E experts, each expert's slice bitwise the 2-D call on it; on
the CPU the plain version loops over the experts. Any other stacked
weight, or a stack with ``x`` of another shape, raises.

A leaf with a calibrated activation grid (``a_bits`` and ``a_scale``, the
paper's static W8A8, Tables 3 and 4) takes the **static-grid** branch in
``w8a8``: the activations expanded by the leaf's spec, quantized on the
fixed grid (``floor(x / a_scale + 0.5)`` with a true division, clamped to
``±qmax``; ``a_scale`` is a leaf of the tree, a runtime value in the
reference's compiled step too) and multiplied as int8 x int8 -> int32 by
``ops.quant_matmul`` (B5's int8 route) with the epilogue ``acc * (a_scale
* w_scale)``: bitwise the reference's ``_int8_matmul``. In ``dequant`` the
grid is not used, as in the reference.

The mode is an argument, never a module global. Activations stay bfloat16
between layers, as in the reference (``embed`` casts).

A **float** weight is a site of the activation-PTQ context
(``core.actquant``, Tables 3 and 4): under a context its input is expanded
and fake-quantized with the weight's rows gathered to match; with none the
call is ``x @ w``.

Every call first hands its input to ``core.tap.tag`` under its ``name``
(the reference's tap sites: ``attn_q`` ... ``mlp_down``, ``lm_head``),
which does nothing unless a collector is active (the drift monitor's
sampled forward).
"""
from __future__ import annotations

import math

import torch

from ..core import actquant, tap
from ..core.ocs import OCSQuantLinear, W4A8Linear, expand_activations
from ..core.quantizer import qmax
from ..kernels import ops as kops
from ..kernels.quant_matmul import stack_scales

__all__ = ["MODES", "dense", "rms_norm", "layer_norm", "embed", "act_quant", "silu", "swiglu",
           "gelu"]

MODES = ("dequant", "w8a8", "w4a8")


def _check_packed(w: OCSQuantLinear) -> None:
    """The dynamic-W8A8 contract: the expansion must be pure duplication
    (mult folded into the weight rows, bias zero; pad rows carry mult 0 and
    map to zero weight rows). Weight-OCS trees from ``quantize_params``
    satisfy it by construction; the check is cached per leaf."""
    if not w.is_packed():
        raise ValueError(
            "dynamic w8a8 needs packed expanded weights (pure duplication); "
            "fold activation-OCS multipliers/biases into the rows before "
            "quantization"
        )


def _flat_w_scale(w: OCSQuantLinear) -> torch.Tensor:
    """Per-column scales ``[N]`` (a per-tensor scale broadcast)."""
    ws = w.weight.scale.reshape(-1)
    if ws.numel() == 1:
        return ws.expand(w.weight.values.shape[-1])
    return ws


def _fused_w8a8(w: OCSQuantLinear, x: torch.Tensor, bits: int) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    src_tail = w.spec.src[w.n_orig:]
    y = kops.fused_quant_matmul(
        x2, w.weight.values, _flat_w_scale(w).contiguous(), src_tail, bits=bits,
        out_dtype=x.dtype,
    )
    return y.reshape(lead + (y.shape[-1],))


def _ocs_dequant(w: OCSQuantLinear, x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = kops.ocs_quant_matmul(
        x2, w.weight.values, _flat_w_scale(w), w.spec.src[w.n_orig:],
        tail_mult=w.spec.mult[w.n_orig:], tail_is_mask=w.is_packed(), out_dtype=x.dtype,
    )
    return y.reshape(lead + (y.shape[-1],))


def _static_w8a8(w: OCSQuantLinear, x: torch.Tensor, what: str) -> torch.Tensor:
    """The calibrated static-grid W8A8 matmul (see the module docstring):
    any spec (the expansion is applied to the activations before the
    grid, so multipliers and biases need not be folded), a per-tensor
    ``a_scale``."""
    a_s = w.a_scale
    if a_s.numel() != 1:
        raise ValueError(f"{what}: a static activation grid takes one a_scale per tensor, "
                         f"got shape {tuple(a_s.shape)}")
    q = qmax(w.a_bits)
    a_s = a_s.to(device=x.device, dtype=torch.float32).reshape(())
    xe = expand_activations(x, w.spec)
    x8 = torch.clamp(torch.floor(xe / a_s + 0.5), -q, q).to(torch.int8)
    lead = x.shape[:-1]
    y = kops.quant_matmul(x8.reshape(-1, x8.shape[-1]).contiguous(), w.weight.values,
                          _flat_w_scale(w), a_s, out_dtype=x.dtype)
    return y.reshape(lead + (y.shape[-1],))


def _is_expert_stack(values: torch.Tensor, mult: torch.Tensor, x: torch.Tensor) -> bool:
    """A ``[E, K(+S), N]`` leaf with ``[E, ...]`` split tables applied to
    ``x [E, C, K]`` (the same E)."""
    return (values.ndim == 3 and mult.ndim == 2 and x.ndim == 3
            and x.shape[0] == values.shape[0] == mult.shape[0])


def _ocs_dequant_stack(w: OCSQuantLinear, x: torch.Tensor) -> torch.Tensor:
    e, n = w.weight.values.shape[0], w.weight.values.shape[-1]
    return kops.ocs_quant_matmul(
        x.contiguous(), w.weight.values, stack_scales(w.weight.scale, e, n, x.device),
        w.spec.src[:, w.n_orig:], tail_mult=w.spec.mult[:, w.n_orig:],
        tail_is_mask=w.is_packed(), out_dtype=x.dtype,
    )


def _fused_w8a8_stack(w: OCSQuantLinear, x: torch.Tensor, bits: int) -> torch.Tensor:
    e, n = w.weight.values.shape[0], w.weight.values.shape[-1]
    return kops.fused_quant_matmul(
        x.contiguous(), w.weight.values, stack_scales(w.weight.scale, e, n, x.device),
        w.spec.src[:, w.n_orig:].contiguous(), bits=bits, out_dtype=x.dtype,
    )


def _w4a8(w: W4A8Linear, x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = kops.w4a8_matmul(
        x2, w.w4, w.s4, w.w8, w.s8, w.spec.src[w.n_orig:], w.outlier_idx,
        bits=w.a_bits, out_dtype=x.dtype,
    )
    return y.reshape(lead + (y.shape[-1],))


def dense(w, x: torch.Tensor, *, mode: str, name: str = "") -> torch.Tensor:
    """y = x @ w with quantization-aware dispatch. x: [..., Cin]; ``mode``
    is one of :data:`MODES` (ignored for float weights); ``name`` labels
    errors and is the tap site's name. A quantized leaf's padded output
    columns (``n_out``, see ``core.ocs.pad_out_cols``) are sliced off."""
    tap.tag(name, x)
    y = _dense(w, x, mode, name)
    n_out = getattr(w, "n_out", None)
    return y if n_out is None else y[..., :n_out]


def _dense(w, x: torch.Tensor, mode: str, name: str) -> torch.Tensor:
    what = name or "dense"
    if isinstance(w, W4A8Linear):
        if mode != "w4a8":
            raise ValueError(
                f"{what}: W4A8Linear weights serve in matmul mode 'w4a8', got {mode!r}"
            )
        if w.w4.ndim == 3 and _is_expert_stack(w.w4, w.spec.mult, x):
            return kops.w4a8_matmul(
                x.contiguous(), w.w4, w.s4, w.w8, w.s8, w.spec.src[:, w.n_orig:].contiguous(),
                w.outlier_idx, bits=w.a_bits, out_dtype=x.dtype,
            )
        if w.w4.ndim != 2:
            raise ValueError(
                f"{what}: slice stacked quantized weights per layer before the matmul "
                "(an expert stack takes x [E, C, K])"
            )
        return _w4a8(w, x)
    if isinstance(w, OCSQuantLinear):
        if mode == "w4a8":
            raise ValueError(
                f"{what}: matmul mode 'w4a8' needs W4A8Linear weights; convert the "
                "tree with repro_torch.core.ocs.to_w4a8 (the serving engine does "
                "this when matmul_mode='w4a8')"
            )
        if mode not in MODES:
            raise ValueError(f"{what}: matmul mode must be one of {MODES}, got {mode!r}")
        static = mode == "w8a8" and w.a_bits is not None and w.a_scale is not None
        bits = w.a_bits if w.a_bits is not None else 8
        if _is_expert_stack(w.weight.values, w.spec.mult, x):
            if static:
                raise ValueError(f"{what}: an expert stack has no static activation grid")
            if mode == "dequant":
                return _ocs_dequant_stack(w, x)
            _check_packed(w)
            return _fused_w8a8_stack(w, x, bits)
        if w.weight.values.ndim != 2 or w.spec.mult.ndim != 1:
            raise ValueError(
                f"{what}: slice stacked quantized weights per layer before the matmul "
                "(an expert stack takes x [E, C, K])"
            )
        if mode == "dequant":
            return _ocs_dequant(w, x)
        if static:
            return _static_w8a8(w, x, what)
        _check_packed(w)
        return _fused_w8a8(w, x, bits)
    site = actquant.site_key(name)
    if site is not None:  # an activation-PTQ context (Tables 3 and 4)
        x, w = actquant.apply_act_quant(x, w.to(x.dtype), site)
    return x @ w.to(x.dtype)


def _row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed two-level order: zero-padded to a
    multiple of 32, groups of 32, then the group sums. A row's result does
    not depend on how many rows the call holds (``torch.mean`` over a long
    row on the card splits it across blocks when the rows are few, and
    sums 8 rows in another order than 40)."""
    d = v.shape[-1]
    if d % 32:
        v = torch.nn.functional.pad(v, (0, -d % 32))
    return v.reshape(v.shape[:-1] + (-1, 32)).sum(-1).sum(-1, keepdim=True)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = _row_sum(x * x) / x.shape[-1]
    return (x * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dtype)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm: float32 mean and (biased) variance, ``(x - mu) *
    rsqrt(var + eps) * scale + bias``, cast back to ``x``'s dtype. The
    sums are :func:`_row_sum`'s, so a row does not depend on the call's
    row count."""
    dtype = x.dtype
    x = x.to(torch.float32)
    d = x.shape[-1]
    mu = _row_sum(x) / d
    xc = x - mu
    var = _row_sum(xc * xc) / d
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def embed(table: torch.Tensor, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return table[ids.long()].to(dtype)


def act_quant(x: torch.Tensor, bits, clip) -> torch.Tensor:
    """Fake-quantize an activation on a *fixed* calibrated grid (paper §5):
    ``floor(x / step + 0.5)`` with ``step = clip / qmax`` in float32 and a
    true division (the reference's form for a runtime ``clip``), clamped,
    times ``step``, in ``x``'s dtype. ``bits`` or ``clip`` None: ``x``."""
    if bits is None or clip is None:
        return x
    q = qmax(bits)
    step = torch.as_tensor(clip, dtype=torch.float32, device=x.device) / torch.tensor(
        float(q), dtype=torch.float32, device=x.device)
    v = torch.clamp(torch.floor(x.to(torch.float32) / step + 0.5), -q, q)
    return (v * step).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, spelled ``x * (1 / (1 + exp(-x)))`` op by op: on
    bfloat16 each op rounds its result, as the reference's compiled
    ``jax.nn.silu`` does (``F.silu`` rounds once and differs in ~40% of the
    bf16 outputs)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up``."""
    return silu(gate) * up


# ``jax.nn.gelu``'s constants, rounded to bfloat16 as the reference's
# weakly typed Python floats are on a bfloat16 operand.
_GELU_C = 0.044715
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x +
    0.044715 x^3)))``, as ``jax.nn.gelu`` spells it: op by op, each result
    rounded to ``x``'s dtype, the constants in that dtype, and ``x^3`` as
    ``x * (x * x)`` (``F.gelu`` rounds once and parts from the reference
    on bfloat16)."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    cube = x * (x * x)
    inner = c(_SQRT_2_OVER_PI) * (x + c(_GELU_C) * cube)
    cdf = c(0.5) * (c(1.0) + torch.tanh(inner))
    return x * cdf
