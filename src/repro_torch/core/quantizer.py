"""Linear symmetric quantization (paper Eq. 1), the port of
``repro.core.quantizer``.

The grid has ``2^k - 1`` points (sign-magnitude: a point at zero and
``2^(k-1) - 1`` on each side)::

    LinearQuant(x) = round(x * (2^(k-1) - 1) / max|x|) * max|x| / (2^(k-1) - 1)

Rounding is ``floor(v + 1/2)`` (ties up), never ``torch.round`` (ties to
even): the Hermite-identity proof of quantization-aware splitting (§3.3)
holds exactly only for ties-up, and the reference's integer grids are
bitwise those of this module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "qmax",
    "div_exact",
    "compute_scale",
    "quantize_int",
    "dequantize",
    "QuantParams",
    "quantize_tensor",
    "storage_dtype",
]


def div_exact(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d``, correctly rounded on every device: PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which can be an ulp off the quotient; a device-tensor divisor takes
    the true division, as the CPU does."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def qmax(bits: int) -> int:
    """Largest positive integer level: 2^(k-1) - 1 (sign-magnitude grid)."""
    if bits < 2:
        raise ValueError(f"need >=2 bits for signed symmetric quant, got {bits}")
    return (1 << (bits - 1)) - 1


def storage_dtype(bits: int) -> torch.dtype:
    """Smallest integer dtype that can hold a k-bit signed value."""
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


def _reduce_absmax(x: torch.Tensor, channel_axis: Optional[int]) -> torch.Tensor:
    if channel_axis is None:
        return x.abs().amax()
    axes = tuple(i for i in range(x.ndim) if i != channel_axis % x.ndim)
    return x.abs().amax(dim=axes)


def compute_scale(
    x: torch.Tensor,
    bits: int,
    *,
    channel_axis: Optional[int] = None,
    clip: Optional[float] = None,
) -> torch.Tensor:
    """Scale s such that q = floor(x / s + 1/2), q in [-qmax, qmax].

    ``clip`` overrides the dynamic range (the clipping threshold T). The
    range is clamped to ``tiny * qmax`` so the scale stays a normal float.
    """
    if clip is not None:
        rng = torch.tensor(clip, dtype=torch.float32, device=x.device)
    else:
        rng = _reduce_absmax(x.to(torch.float32), channel_axis)
    # tiny * qmax is exact in float32 (tiny is a power of two, qmax < 2^24).
    rng = torch.clamp_min(rng, torch.finfo(torch.float32).tiny * qmax(bits))
    return div_exact(rng, qmax(bits))


def _broadcast_scale(scale: torch.Tensor, ndim: int, channel_axis: Optional[int]):
    if channel_axis is None or scale.ndim == 0:
        return scale
    shape = [1] * ndim
    shape[channel_axis % ndim] = -1
    return scale.reshape(shape)


def quantize_int(
    x: torch.Tensor,
    scale: torch.Tensor,
    bits: int,
    *,
    channel_axis: Optional[int] = None,
) -> torch.Tensor:
    """Round-to-nearest, ties up: Q(v) = floor(v + 1/2), then saturate."""
    s = _broadcast_scale(scale, x.ndim, channel_axis)
    q = torch.floor(x.to(torch.float32) / s + 0.5)
    q = torch.clamp(q, -qmax(bits), qmax(bits))
    return q.to(storage_dtype(bits))


def dequantize(
    q: torch.Tensor,
    scale: torch.Tensor,
    *,
    channel_axis: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    s = _broadcast_scale(scale, q.ndim, channel_axis)
    return (q.to(torch.float32) * s).to(dtype)


@dataclasses.dataclass
class QuantParams:
    """A quantized tensor: integer values + scale (+ static metadata)."""

    values: torch.Tensor  # int8/int16 storage
    scale: torch.Tensor  # scalar or per-channel vector (f32)
    bits: int = 8
    channel_axis: Optional[int] = None

    def dequant(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return dequantize(
            self.values, self.scale, channel_axis=self.channel_axis, dtype=dtype
        )


def quantize_tensor(
    x: torch.Tensor,
    bits: int,
    *,
    channel_axis: Optional[int] = None,
    clip: Optional[float] = None,
) -> QuantParams:
    scale = compute_scale(x, bits, channel_axis=channel_axis, clip=clip)
    q = quantize_int(x, scale, bits, channel_axis=channel_axis)
    return QuantParams(values=q, scale=scale, bits=bits, channel_axis=channel_axis)
