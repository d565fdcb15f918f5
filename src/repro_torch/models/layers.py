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

The mode is an argument, never a module global. Calibrated activation grids
(``a_scale``) have no producer on the serving path and are not ported.
Activations stay bfloat16 between layers, as in the reference (``embed``
casts).
"""
from __future__ import annotations

import torch

from ..core.ocs import OCSQuantLinear, W4A8Linear
from ..kernels import ops as kops

__all__ = ["MODES", "dense", "rms_norm", "embed", "swiglu"]

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
    errors."""
    what = name or "dense"
    if isinstance(w, W4A8Linear):
        if mode != "w4a8":
            raise ValueError(
                f"{what}: W4A8Linear weights serve in matmul mode 'w4a8', got {mode!r}"
            )
        if w.w4.ndim != 2:
            raise ValueError(
                f"{what}: slice stacked quantized weights per layer before the matmul"
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
        if w.a_bits is not None and w.a_scale is not None:
            raise NotImplementedError(
                f"{what}: static calibrated activation grids (a_scale) are not "
                "ported (ROADMAP A10/A14)"
            )
        if w.weight.values.ndim != 2 or w.spec.mult.ndim != 1:
            raise ValueError(
                f"{what}: slice stacked quantized weights per layer before the matmul"
            )
        if mode == "dequant":
            return _ocs_dequant(w, x)
        _check_packed(w)
        return _fused_w8a8(w, x, w.a_bits if w.a_bits is not None else 8)
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


def embed(table: torch.Tensor, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return table[ids.long()].to(dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, spelled ``gate * (1 / (1 + exp(-gate))) * up`` op by
    op: on bfloat16 each op rounds its result, as the reference's compiled
    ``jax.nn.silu`` does (``F.silu`` rounds once and differs in ~40% of the
    bf16 outputs)."""
    sig = 1.0 / (1.0 + torch.exp(-gate))
    return gate * sig * up
