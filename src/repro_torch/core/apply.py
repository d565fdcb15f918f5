"""Apply a :class:`QuantRecipe` to a whole parameter tree (the port of
``repro.core.apply``, serving path).

:func:`quantize_params` turns every quantizable weight into an
:class:`OCSQuantLinear` leaf (expanded int8 values + scales + expansion
spec). Weights with leading stack dims (``[L, Cin, Cout]``, a MoE layer's
experts ``[L, E, Cin, Cout]``) are quantized per slice into preallocated
stacks: each slice gets its own split table and scale, and only one slice
is held in float32 at a time. The tree is a nested dict of tensors laid
out like ``models.transformer.init_params``; its leaves may also be
zero-argument callables that make them (``init_params(..., lazy=True)``),
drawn one at a time in the tree's order.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from .ocs import OCSQuantLinear, OCSSpec, W4A8Linear, make_ocs_quant_linear, pad_out_cols
from .quantizer import QuantParams
from .recipe import QuantRecipe

__all__ = ["quantize_params", "path_str", "map_with_path", "tree_to"]


def path_str(path) -> str:
    """``("layers", "attn", "wq")`` -> ``"layers/attn/wq"`` (the reference's
    key-path spelling, which the recipe's skip patterns match against)."""
    return "/".join(str(p) for p in path)


def map_with_path(fn: Callable, tree, path=(), *, is_leaf=None):
    """Map ``fn(path, leaf)`` over a nested dict/list tree (leaves are
    anything that is not a dict, list or tuple, or what ``is_leaf``
    accepts)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_to(tree, device):
    """Copy of a parameter tree (tensors, OCSQuantLinear and W4A8Linear
    leaves) on ``device``; tensors already there are shared, not copied."""
    dev = torch.device(device)

    def move(_path, leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.to(dev)
        if isinstance(leaf, OCSQuantLinear):
            w, sp = leaf.weight, leaf.spec
            return OCSQuantLinear(
                weight=QuantParams(w.values.to(dev), w.scale.to(dev), w.bits,
                                   w.channel_axis),
                spec=OCSSpec(sp.src.to(dev), sp.mult.to(dev), sp.bias.to(dev)),
                n_orig=leaf.n_orig,
                a_bits=leaf.a_bits,
                a_scale=None if leaf.a_scale is None else leaf.a_scale.to(dev),
                n_out=leaf.n_out,
            )
        if isinstance(leaf, W4A8Linear):
            sp = leaf.spec
            return W4A8Linear(
                w4=leaf.w4.to(dev), s4=leaf.s4.to(dev), w8=leaf.w8.to(dev),
                s8=leaf.s8.to(dev), outlier_idx=leaf.outlier_idx.to(dev),
                spec=OCSSpec(sp.src.to(dev), sp.mult.to(dev), sp.bias.to(dev)),
                n_orig=leaf.n_orig, a_bits=leaf.a_bits, n_out=leaf.n_out,
            )
        return leaf

    return map_with_path(move, tree)


def _is_quantizable(path: str, leaf, recipe: QuantRecipe) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not leaf.is_floating_point():
        return False
    return not recipe.should_skip(path)


def _quant_linear_stacked(w: torch.Tensor, recipe: QuantRecipe) -> OCSQuantLinear:
    """Build a (possibly stacked) OCSQuantLinear from [..., Cin, Cout], one
    slice at a time (each converted to float32 on its own): the slices'
    results are written into stacks allocated at the first, whose shapes
    every slice shares (the split count follows from Cin)."""
    lead = tuple(w.shape[:-2])
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))

    def one(i):
        return make_ocs_quant_linear(
            flat[i].to(torch.float32),
            recipe.ocs_ratio,
            recipe.w_bits,
            qa=recipe.qa_split,
            clip_method=recipe.w_clip,
            per_channel=recipe.per_channel,
            pad_to=recipe.pad_to,
        )

    if not lead:
        return one(0)

    # Stacks with the leading dims back. Scales are stored broadcast-ready
    # against the values: per-channel [Cout] -> [..., 1, Cout], per-tensor
    # scalar -> [..., 1, 1].
    parts = None
    for i in range(flat.shape[0]):
        lin = one(i)
        per_channel = lin.weight.channel_axis == 1
        got = (lin.weight.values,
               lin.weight.scale[None, :] if per_channel else lin.weight.scale[None, None],
               lin.spec.src, lin.spec.mult, lin.spec.bias)
        if parts is None:
            parts = [torch.empty((flat.shape[0],) + tuple(t.shape), dtype=t.dtype,
                                 device=t.device) for t in got]
        for dst, t in zip(parts, got):
            dst[i] = t
        del lin, got
    values, scale, src, mult, bias = (t.reshape(lead + tuple(t.shape[1:])) for t in parts)
    qp = QuantParams(values=values, scale=scale, bits=recipe.w_bits, channel_axis=None)
    return OCSQuantLinear(
        weight=qp, spec=OCSSpec(src=src, mult=mult, bias=bias), n_orig=int(w.shape[-2]),
        a_bits=recipe.a_bits,
    )


def quantize_params(params, recipe: QuantRecipe, *, device=None):
    """Replace quantizable weights with OCSQuantLinear integer leaves (their
    output columns zero-padded to a multiple of ``ocs.PAD_N``, the true
    count in ``n_out``: :func:`repro_torch.core.ocs.pad_out_cols`).

    Runs on ``device`` (``None`` = the card; raises without one unless
    ``device="cpu"``); leaves are moved there first. A callable leaf is
    called once, in the tree's order, and its result quantized (or kept);
    nothing holds it afterwards.
    """
    dev = resolve_device(device)
    if not recipe.wants_weight_quant():
        return map_with_path(lambda _p, leaf: leaf() if callable(leaf) else leaf, params)

    def visit(path, leaf):
        if callable(leaf):  # a lazy leaf: drawn here, dropped once quantized
            leaf = leaf()
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.to(dev)
        p = path_str(path)
        if not _is_quantizable(p, leaf, recipe):
            return leaf
        return pad_out_cols(_quant_linear_stacked(leaf, recipe))

    return map_with_path(visit, params)
