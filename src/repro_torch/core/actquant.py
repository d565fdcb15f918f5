"""Activation quantization context (paper §5.3, Tables 3 and 4), the port of
``repro.core.actquant``.

Activation PTQ is evaluated by running the float model under a context that
intercepts every quantizable activation site (the input of each linear or
convolution, named by its tap site and disambiguated by an ordinal within
one forward pass) and applies:

1. optional **activation OCS**: expand the channels per a calibration-derived
   :class:`~repro_torch.core.ocs.OCSSpec` (split channels halved, the
   weight's rows duplicated unchanged, Eq. 4), or **Oracle OCS** (Table 4):
   per-batch selection of the top-|x| channels with exact knowledge of the
   batch;
2. **fake quantization** of the (possibly expanded) activations on a grid
   fixed from calibration.

``models.layers.dense`` (float weights) and the convnet's ``_qconv`` and
head consult it. With no context active :func:`site_key` returns ``None``
at once: no allocation, no device work, so a serving step launches what it
launches without the sites. The port is eager, so the ordinals restart with
:meth:`ActQuantCtx.reset` before every forward (the reference's jitted
forward resets while tracing).

**Numerics.** The reference evaluates its tables under ``jax.jit`` with
each site's clip a Python constant. XLA folds the grid step to a constant,
rewrites ``x / step`` into a multiply by the folded reciprocal
``float32(1 / float32(clip / qmax))``, and on the CPU contracts that
multiply and the ``+ 0.5`` into one fused multiply-add.
:func:`_fake_quant_fixed` computes that compiled form exactly
(``kernels.ref.fma_f32``), on any device: ``floor(fma(x, 1/step, 0.5))``,
clamped to ``±qmax``, times ``step``. At a tie an IEEE ``x / step + 0.5``
can give another code.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.ref import fma_f32
from .clipping import find_clip
from .ocs import OCSSpec, expand_activations, oracle_expand
from .quantizer import qmax

__all__ = ["ActQuantCtx", "act_quant_ctx", "active_ctx", "site_key", "apply_act_quant",
           "post_ocs_clip"]

_ACTIVE: Optional["ActQuantCtx"] = None


@dataclasses.dataclass
class ActQuantCtx:
    bits: int
    clips: Dict[str, float]  # site -> clip threshold (calibrated)
    specs: Dict[str, OCSSpec] = dataclasses.field(default_factory=dict)
    oracle_ratio: float = 0.0  # > 0: Table 4's per-batch oracle selection
    _counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self):
        self._counts = {}

    def next_site(self, name: str) -> str:
        k = self._counts.get(name, 0)
        self._counts[name] = k + 1
        return f"{name}#{k}"


def active_ctx() -> Optional[ActQuantCtx]:
    return _ACTIVE


@contextlib.contextmanager
def act_quant_ctx(ctx: ActQuantCtx):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ctx
    ctx.reset()
    try:
        yield ctx
    finally:
        _ACTIVE = prev


def site_key(name: str) -> Optional[str]:
    """Advance the ordinal of ``name`` in the active context (None if there
    is none)."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.next_site(name)


def _fake_quant_fixed(x: torch.Tensor, bits: int, clip: float) -> torch.Tensor:
    """Fake-quantize ``x`` on the fixed grid of ``clip``, as the reference's
    jitted form computes it (module docstring), in ``x``'s dtype."""
    q = qmax(bits)
    step = np.float32(np.float32(clip) / np.float32(q))
    rcp = np.float32(1.0) / step

    def const(v):
        return torch.tensor(float(v), dtype=torch.float32, device=x.device)

    v = torch.floor(fma_f32(x.to(torch.float32), const(rcp), const(0.5)))
    return (torch.clamp(v, -q, q) * const(step)).to(x.dtype)


def apply_act_quant(x: torch.Tensor, w: torch.Tensor, site: Optional[str]):
    """Transform (activations, weight rows) at one site under the context.

    x: ``[..., Cin]``; w: ``[Cin, ...]`` (first axis the input channels).
    Returns the (possibly expanded) pair with the activations fake-quantized
    on the calibrated grid; a no-op with no context or an unknown site."""
    ctx = _ACTIVE
    if ctx is None or site is None:
        return x, w
    clip = ctx.clips.get(site)
    if ctx.oracle_ratio > 0:
        n = max(1, math.ceil(ctx.oracle_ratio * x.shape[-1]))  # ceil(r*C)
        x, src = oracle_expand(x, n)
        w = w.index_select(0, src.long())
    else:
        spec = ctx.specs.get(site)
        if spec is not None:
            x = expand_activations(x, spec)
            w = w.index_select(0, spec.src.long())
    if clip is not None:
        x = _fake_quant_fixed(x, ctx.bits, clip)
    return x, w


def post_ocs_clip(stats, spec: Optional[OCSSpec], method: Optional[str], bits: int) -> float:
    """Calibrated clip threshold of a site, accounting for the OCS halving:
    split channels contribute half their profiled max. ``stats``: the
    site's ``ChannelStats``. Host numpy, the reference's arithmetic."""
    if spec is None:
        return find_clip(stats.hist, bits, method)
    mult = spec.mult.detach().cpu().numpy()
    src = spec.src.detach().cpu().numpy()
    eff_max = float(np.max(stats.abs_max[src] * mult)) if len(src) else 0.0
    if method in (None, "none", "max"):
        return max(eff_max, 1e-30)
    # Clipping on top of OCS is not the paper's (Table 3 note); the
    # reference scales the no-OCS threshold into the reduced range.
    base = find_clip(stats.hist, bits, method)
    no_ocs_max = max(float(stats.abs_max.max()), 1e-30)
    return base * eff_max / no_ocs_max
