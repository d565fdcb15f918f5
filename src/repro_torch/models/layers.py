"""Shared layer primitives with PTQ integration (the port of
``repro.models.layers``).

``dense`` is the entry point for every matmul. Its weight is a float tensor
or an :class:`OCSQuantLinear`; the latter always runs dynamic **w8a8** —
"the production serving mode", the one quantized-matmul mode the port has
(the engine refuses the others at construction) — where every 2-D
quantized matmul goes through the fused W8A8 kernel
(``kernels.ops.fused_quant_matmul``: the CUDA kernel on the card, its plain
version on the CPU). The reference's ``serving_mode`` context is not
carried over: it chooses between modes, and a mode argument returns with
the second mode (ROADMAP A6, A12). Activations stay bfloat16 between
layers, as in the reference (``embed`` casts).
"""
from __future__ import annotations

import torch

from ..core.ocs import OCSQuantLinear
from ..kernels import ops as kops

__all__ = ["dense", "rms_norm", "embed", "swiglu"]


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


def _fused_w8a8(w: OCSQuantLinear, x: torch.Tensor, bits: int) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    src_tail = w.spec.src[w.n_orig:]
    y = kops.fused_quant_matmul(
        x2, w.weight.values, w.weight.scale.reshape(-1), src_tail, bits=bits,
        out_dtype=x.dtype,
    )
    return y.reshape(lead + (y.shape[-1],))


def dense(w, x: torch.Tensor, *, name: str = "") -> torch.Tensor:
    """y = x @ w with quantization-aware dispatch. x: [..., Cin]; ``name``
    labels errors."""
    if isinstance(w, OCSQuantLinear):
        if w.a_bits is not None and w.a_scale is not None:
            raise NotImplementedError(
                "static calibrated activation grids: ROADMAP A6"
            )
        if w.weight.values.ndim != 2 or w.spec.mult.ndim != 1:
            raise ValueError(
                f"{name or 'dense'}: slice stacked quantized weights per layer "
                "before the matmul"
            )
        bits = w.a_bits if w.a_bits is not None else 8
        _check_packed(w)
        return _fused_w8a8(w, x, bits)
    return x @ w.to(x.dtype)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
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
