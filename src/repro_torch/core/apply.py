"""Apply a :class:`QuantRecipe` to a whole parameter tree (the port of
``repro.core.apply``).

:func:`fake_quantize_params` replaces every quantizable weight by its
OCS + clip + quantize-dequantize "effective" float equivalent (the expanded
layer collapsed back with ``ocs.collapse_expanded``): same shape, dtype and
device, so model code runs unchanged (the paper's accuracy tables).
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

from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from .allocate import knapsack_allocate
from .clipping import find_clip
from .ocs import (OCSQuantLinear, OCSSpec, W4A8Linear, collapse_expanded,
                  make_ocs_quant_linear, pad_out_cols, split_weights)
from .quantizer import QuantParams, fake_quant
from .recipe import QuantRecipe

__all__ = ["fake_quantize_params", "knapsack_splits", "quantize_params",
           "act_scales_from_collector", "path_str", "map_with_path", "tree_to"]


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


def _fake_quant_2d(w: torch.Tensor, recipe: QuantRecipe,
                   n_splits: Optional[int] = None) -> torch.Tensor:
    """OCS split -> clip -> quantize -> dequantize -> collapse, ``[Cin,
    Cout]`` float32 on ``w``'s device. Per-channel scales take each
    expanded column's own max (the reference quantizes column by column,
    unclipped; one broadcast division per element is the same arithmetic)."""
    w_exp, spec, thresh = split_weights(
        w, recipe.ocs_ratio, recipe.w_bits, qa=recipe.qa_split,
        clip_method=recipe.w_clip, n_splits=n_splits,
    )
    if recipe.per_channel:
        wq = fake_quant(w_exp, recipe.w_bits, channel_axis=1)
    else:
        wq = fake_quant(w_exp, recipe.w_bits, clip=thresh)
    return collapse_expanded(wq, spec, w.shape[0])[0]


def _map_stacked(w: torch.Tensor, fn: Callable[[int, torch.Tensor], torch.Tensor]):
    """``fn(i, slice)`` over the leading stack dims of ``[..., Cin, Cout]``
    (each slice in float32), restacked; the result is float32."""
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    out = torch.stack([fn(i, flat[i].to(torch.float32)) for i in range(flat.shape[0])])
    return out.reshape(tuple(w.shape[:-2]) + tuple(out.shape[1:]))


def knapsack_splits(params, recipe: QuantRecipe) -> Dict[str, int]:
    """Global split allocation (§3.4 knapsack variant): ``"path#slice"`` ->
    split count, over every slice of every quantizable leaf (the
    allocation does not depend on the order the slices come in)."""
    layers = []

    def collect(path, leaf):
        p = path_str(path)
        if _is_quantizable(p, leaf, recipe):
            flat = leaf.reshape((-1,) + tuple(leaf.shape[-2:]))
            layers.extend((f"{p}#{i}", flat[i]) for i in range(flat.shape[0]))
        return leaf

    map_with_path(collect, params)
    return knapsack_allocate(layers, recipe.ocs_ratio)


def fake_quantize_params(params, recipe: QuantRecipe):
    """Replace quantizable weights with their PTQ'd float equivalents, each
    on its own device in its own dtype (the tree is not moved).
    ``recipe.alloc == "knapsack"`` swaps the per-layer ``ceil(r*C)`` split
    count for the globally budgeted allocation (same total overhead)."""
    if not recipe.wants_weight_quant():
        return params
    alloc = knapsack_splits(params, recipe) if recipe.alloc == "knapsack" else None

    def visit(path, leaf):
        p = path_str(path)
        if not _is_quantizable(p, leaf, recipe):
            return leaf
        out = _map_stacked(leaf, lambda i, w2d: _fake_quant_2d(
            w2d, recipe, n_splits=None if alloc is None else alloc[f"{p}#{i}"]))
        return out.to(leaf.dtype)

    return map_with_path(visit, params)


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


def act_scales_from_collector(collector, recipe: QuantRecipe) -> Dict[str, float]:
    """Per-site activation clip thresholds from calibration stats (§5.3):
    ``find_clip`` of each site's histogram at ``recipe.a_bits`` with
    ``recipe.a_clip``; ``{}`` when the recipe keeps activations float."""
    if not recipe.wants_act_quant():
        return {}
    return {name: find_clip(stats.hist, recipe.a_bits, recipe.a_clip)
            for name, stats in collector.sites.items()}
