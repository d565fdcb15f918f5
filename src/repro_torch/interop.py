"""Parameter trees from numpy arrays.

:func:`params_from_numpy` turns a nested dict of numpy arrays — the
reference package's parameters, flattened to numpy by the caller — into the
port's tree on ``device``, so both packages can compute on identical
weights. Float leaves become float tensors; a quantized leaf is a dict
``{values, scale, src, mult, bias, n_orig, a_bits}`` (optionally ``bits``,
and ``a_scale``, a calibrated activation grid) and becomes an :class:`~repro_torch.core.ocs.OCSQuantLinear`; a W4A8 leaf
is a dict ``{w4, s4, w8, s8, outlier_idx, src, mult, bias, n_orig,
a_bits}`` and becomes a :class:`~repro_torch.core.ocs.W4A8Linear`. It takes
numpy, not JAX, so it lives in the package; the JAX -> numpy flattening
lives with the tests. A MoE tree's ``moe`` subtree (the float ``router``,
the ``[L, E, ...]`` quantized ``experts`` stacks, the ``shared`` experts)
converts leaf by leaf like the rest.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.ocs import OCSQuantLinear, OCSSpec, W4A8Linear
from .core.quantizer import QuantParams
from .device import resolve_device

__all__ = ["params_from_numpy"]


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(dev)


def _spec(d, dev) -> OCSSpec:
    return OCSSpec(
        src=_tensor(np.asarray(d["src"], np.int32), dev),
        mult=_tensor(np.asarray(d["mult"], np.float32), dev),
        bias=_tensor(np.asarray(d["bias"], np.float32), dev),
    )


def _w4a8_leaf(d, dev) -> W4A8Linear:
    return W4A8Linear(
        w4=_tensor(np.asarray(d["w4"], np.uint8), dev),
        s4=_tensor(np.asarray(d["s4"], np.float32), dev),
        w8=_tensor(np.asarray(d["w8"], np.int8), dev),
        s8=_tensor(np.asarray(d["s8"], np.float32), dev),
        outlier_idx=_tensor(np.asarray(d["outlier_idx"], np.int32), dev),
        spec=_spec(d, dev),
        n_orig=int(d["n_orig"]),
        a_bits=int(d["a_bits"]),
    )


def _quant_leaf(d, dev) -> OCSQuantLinear:
    values = _tensor(d["values"], dev)
    scale = _tensor(np.asarray(d["scale"], np.float32), dev)
    # An unstacked per-channel leaf keeps a [Cout] scale on axis 1; stacked
    # leaves carry broadcast-ready [..., 1, Cout] scales (channel_axis None).
    channel_axis = 1 if (values.ndim == 2 and scale.ndim == 1) else None
    return OCSQuantLinear(
        weight=QuantParams(
            values=values, scale=scale, bits=int(d.get("bits", 8)),
            channel_axis=channel_axis,
        ),
        spec=_spec(d, dev),
        n_orig=int(d["n_orig"]),
        a_bits=None if d.get("a_bits") is None else int(d["a_bits"]),
        a_scale=(None if d.get("a_scale") is None
                 else _tensor(np.asarray(d["a_scale"], np.float32), dev)),
    )


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays (and quantized-leaf dicts) -> the port's
    parameter tree on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)

    def visit(node):
        if isinstance(node, dict):
            if "values" in node and "src" in node:
                return _quant_leaf(node, dev)
            if "w4" in node and "src" in node:
                return _w4a8_leaf(node, dev)
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return _tensor(node, dev)

    return visit(tree)
