"""Per-lane token sampling (temperature / top-k / top-p), the port of
``repro.serving.sampling``.

One function over tensors: ``[B, V]`` logits plus per-lane sampling
parameter vectors in, ``[B]`` next tokens out. The engine calls it only on
steps with a sampled lane; greedy-only steps take ``argmax`` and never reach
it.

Contract (what ``tests/test_torch_sampling.py`` holds):

* the temperature-scaled logits and the kept set (top-k widened by ties,
  then the nucleus rule ``cum - p < top_p`` over the descending sort) are
  computed with the reference's operations, in its order, on float32
  logits, so they are bitwise the reference's, except for a token whose
  nucleus decision float32 rounding settles (the mass before it within a
  few ulps of ``top_p``: ``exp`` and the sums round differently in the two
  stacks). At ``top_p = 1`` that is the far tail, which the reference drops
  where its float32 cumulative sum reaches 1.0;
* lanes with ``temperature == 0`` take the exact ``argmax`` of the logits,
  the engine's greedy token;
* a draw depends on ``(seed, position)`` of the request alone, where
  ``position`` is the cache position of the token being consumed, never on
  the lane, the batch or the order of submission: it is reproducible run
  to run on one device.

The draw is the Gumbel-max trick on the masked logits, with its noise from
a counter-based hash of ``(seed, position, token id)`` in 64-bit integer
tensor operations (32-bit arithmetic, exact on any device), so the
uniforms are the same on the CPU and the card, no ``torch.Generator`` is
kept per lane, and no lane costs a host round trip. Threefry's key stream
(``jax.random.fold_in`` and ``categorical``) is not reproduced: the port's
sampled tokens are draws from the same distribution, not the reference's
tokens.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

__all__ = [
    "params_to_arrays",
    "greedy_sampling_arrays",
    "scaled_and_kept",
    "uniforms",
    "sample_tokens",
]

_M32 = 0xFFFFFFFF


def params_to_arrays(params: Sequence, device=None) -> Dict[str, torch.Tensor]:
    """Per-lane ``SamplingParams`` -> the tensor schema :func:`sample_tokens`
    consumes: ``temperature`` / ``top_p`` float32, ``top_k`` int64 (0 =
    off), ``seed`` int64 in ``[0, 2**32)``, each ``[B]``."""
    return {
        "temperature": torch.tensor([p.temperature for p in params],
                                    dtype=torch.float32, device=device),
        "top_k": torch.tensor([p.top_k for p in params], dtype=torch.int64,
                              device=device),
        "top_p": torch.tensor([p.top_p for p in params], dtype=torch.float32,
                              device=device),
        "seed": torch.tensor([p.seed & _M32 for p in params], dtype=torch.int64,
                             device=device),
    }


def greedy_sampling_arrays(batch: int, device=None) -> Dict[str, torch.Tensor]:
    """The all-greedy per-lane parameter vectors (the engine's idle state)."""
    from .config import SamplingParams

    return params_to_arrays([SamplingParams()] * batch, device)


def scaled_and_kept(
    logits: torch.Tensor, samp: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 logits ``[B, V]`` -> (temperature-scaled logits, kept mask),
    each ``[B, V]``: the reference's restriction, operation for operation."""
    v = logits.shape[-1]
    temp = samp["temperature"]
    # A tensor divisor: torch's CUDA division by a Python scalar multiplies
    # by its reciprocal, this divides.
    scaled = logits / torch.clamp_min(temp, 1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: keep logits >= the k-th largest (ties widen the set).
    k_eff = torch.where(samp["top_k"] > 0, torch.clamp_max(samp["top_k"], v),
                        torch.full_like(samp["top_k"], v))
    kth = torch.gather(srt, -1, (k_eff - 1)[:, None])
    # top-p: the smallest prefix of the sorted distribution reaching top_p;
    # `cum - p < top_p` always keeps the top token.
    e = torch.exp(srt - srt[:, :1])
    probs = e / torch.sum(e, dim=-1, keepdim=True)
    keep = (torch.cumsum(probs, dim=-1) - probs) < samp["top_p"][:, None]
    p_thresh = torch.amin(
        torch.where(keep, srt, torch.full_like(srt, float("inf"))), dim=-1,
        keepdim=True)
    return scaled, (scaled >= kth) & (scaled >= p_thresh)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``0 <= x, c < 2**32``, exact in int64 (two
    16-bit halves of ``c``, so no product passes 2**48)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (the ``lowbias32`` finalizer) on int64 tensors
    holding values in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniforms(seed: torch.Tensor, pos: torch.Tensor, v: int) -> torch.Tensor:
    """float64 uniforms in ``(0, 1)``, ``[B, V]``: entry ``[b, t]`` hashes
    ``(seed[b], pos[b], t)`` and nothing else."""
    lane = _mix32(_mix32(seed & _M32) ^ (pos.to(torch.int64) & _M32))
    tok = _mix32((torch.arange(v, dtype=torch.int64, device=seed.device)
                  * 0x9E3779B1 + 0x632BE5AB) & _M32)
    u32 = _mix32(lane[:, None] ^ tok[None, :])
    return (u32.to(torch.float64) + 0.5) * 2.0 ** -32


def sample_tokens(
    logits: torch.Tensor, samp: Dict[str, torch.Tensor], pos: torch.Tensor
) -> torch.Tensor:
    """logits ``[B, V]``, per-lane params, positions ``[B]`` -> int32 tokens
    ``[B]``. Greedy lanes (``temperature == 0``) take the exact argmax."""
    greedy = torch.argmax(logits, dim=-1)
    scaled, keep = scaled_and_kept(logits.to(torch.float32), samp)
    gumbel = -torch.log(-torch.log(uniforms(samp["seed"], pos, logits.shape[-1])))
    noisy = torch.where(keep, scaled.to(torch.float64) + gumbel,
                        torch.full_like(gumbel, float("-inf")))
    sampled = torch.argmax(noisy, dim=-1)
    return torch.where(samp["temperature"] > 0.0, sampled, greedy).to(torch.int32)
