"""Outlier Channel Splitting (paper §3), the port of ``repro.core.ocs``.

A linear layer ``y = x @ W`` (``W: [Cin, Cout]``) is expanded by duplicating
the input channels that hold outliers. Weight OCS (Eq. 3) splits row ``m``
of ``W`` into two rows and duplicates activation channel ``m`` unchanged;
the expansion is the affine spec ``x_exp[..., c] = x[..., src[c]] * mult[c]
+ bias[c]``, so ``x_exp @ W_exp == x @ W`` in float.

Quantization-aware splitting (§3.3) splits ``w`` into ``((w - Δ/2)/2, (w +
Δ/2)/2)`` so that ``Q(w) = Q(w1) + Q(w2)`` exactly; Δ comes from a short
fixed-point iteration (naive halving first, then QA re-splits).

**Where the port differs from the reference in how, not what.** The
reference splits on the host: each of the ``ceil(r*C)`` splits recomputes
``np.abs(w).max(axis=1)`` over the whole matrix and re-``concatenate`` s it,
which at glm4-9b widths is host-minutes per matrix (``lm_head`` [4096,
151552] takes 82 splits, ``w_down`` [13696, 4096] takes 274). The port runs
the *same* splits on the tensor's device into a preallocated ``[C+n, N]``
buffer and keeps the row-max vector up to date (two rows change per
split), with the same first-index argmax tie rule and the same float32
arithmetic for ``(row ∓ Δ/2)/2``: the expanded weights and ``src`` are
bitwise the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.paged_attention import pack_int4
from ..kernels.quant_matmul import pad_cols
from .clipping import find_clip
from .quantizer import QuantParams, div_exact, qmax, quantize_tensor

__all__ = [
    "OCSSpec",
    "n_splits_for_ratio",
    "expanded_channels",
    "split_weights",
    "expand_activations",
    "split_activations_spec",
    "duplicate_weight_rows",
    "fold_expansion_mult",
    "oracle_expand",
    "collapse_expanded",
    "OCSQuantLinear",
    "make_ocs_quant_linear",
    "W4A8Linear",
    "to_w4a8",
    "PAD_N",
    "pad_out_cols",
]

# Output columns of a quantized leaf are stored zero-padded to a multiple of
# PAD_N: the card's GEMMs read rows of a multiple of 16 bytes (B1's and B6's
# TMA) or 4-column words (B4/B5), so a ragged N is padded once, when the
# tree is built, not on every call.
PAD_N = 16


@dataclasses.dataclass
class OCSSpec:
    """Affine channel-expansion spec: x_exp[c] = x[src[c]] * mult[c] + bias[c]."""

    src: torch.Tensor  # int32 [C_exp]
    mult: torch.Tensor  # f32   [C_exp]
    bias: torch.Tensor  # f32   [C_exp]

    @staticmethod
    def identity(n_channels: int, device=None) -> "OCSSpec":
        return OCSSpec(
            src=torch.arange(n_channels, dtype=torch.int32, device=device),
            mult=torch.ones(n_channels, dtype=torch.float32, device=device),
            bias=torch.zeros(n_channels, dtype=torch.float32, device=device),
        )


def n_splits_for_ratio(n_channels: int, ratio: float) -> int:
    """ceil(r * C) splits (paper §3.4); 0 for r == 0."""
    if ratio <= 0:
        return 0
    return int(math.ceil(ratio * n_channels))


def expanded_channels(cin: int, ratio: float, *, pad_to: int = 1) -> int:
    """Expanded (and padded) contraction dim after OCS, shape arithmetic
    only: what :func:`make_ocs_quant_linear` builds for ``cin`` input
    channels (the reference's with ``groups=1``, the only grouping the
    port has)."""
    c = cin + n_splits_for_ratio(cin, ratio)
    return c + ((-c) % pad_to)


def expand_activations(x: torch.Tensor, spec: OCSSpec) -> torch.Tensor:
    """Apply the expansion spec along the last axis of x."""
    return x[..., spec.src.long()] * spec.mult + spec.bias


# ---------------------------------------------------------------------------
# Weight OCS (offline, on the weight's device)


def _run_splits(w: torch.Tensor, n_splits: int, delta: float, qa: bool):
    """``n_splits`` greedy splits of the row holding the current global max
    |value| (§3.4). Returns ``(w_exp [C+n, N] f32, src [C+n] int32)``."""
    c, n = w.shape
    dev = w.device
    out = torch.empty((c + n_splits, n), dtype=torch.float32, device=dev)
    out[:c] = w
    src = torch.empty((c + n_splits,), dtype=torch.int32, device=dev)
    src[:c] = torch.arange(c, dtype=torch.int32, device=dev)
    rowmax = torch.empty((c + n_splits,), dtype=torch.float32, device=dev)
    rowmax[:c] = w.abs().amax(dim=1)
    # The reference computes row -/+ 0.5*delta with the Python float rounded
    # to float32 (numpy's weak-scalar rule); the rounded value is exact in
    # float32, so torch's scalar cast reproduces it.
    half = float(np.float32(0.5 * delta)) if (qa and delta > 0) else None
    for k in range(n_splits):
        cur = c + k
        idx = torch.argmax(rowmax[:cur]).reshape(1)  # first index on ties
        row = out.index_select(0, idx)
        if half is not None:
            r1 = (row - half) / 2.0
            r2 = (row + half) / 2.0
        else:
            r1 = row / 2.0
            r2 = r1
        out[cur : cur + 1] = r2
        out.index_copy_(0, idx, r1)
        src[cur : cur + 1] = src.index_select(0, idx)
        rowmax[cur : cur + 1] = r2.abs().amax(dim=1)
        rowmax.index_copy_(0, idx, r1.abs().amax(dim=1))
    return out, src


def split_weights(
    w: torch.Tensor,
    ratio: float,
    bits: int,
    *,
    qa: bool = True,
    clip_method: Optional[str] = None,
    fixed_point_iters: int = 2,
    n_splits: Optional[int] = None,
) -> Tuple[torch.Tensor, OCSSpec, float]:
    """Weight OCS on ``w: [Cin, Cout]`` (float32, on any device).

    Returns ``(w_expanded, spec, clip_threshold)``: ``spec`` duplicates
    activations unchanged (mult=1, bias=0) and ``clip_threshold`` is the
    post-split threshold chosen by ``clip_method`` (max|w| when None).
    """
    w = w.to(torch.float32)
    if w.ndim != 2:
        raise ValueError(f"split_weights expects [Cin, Cout], got {tuple(w.shape)}")
    n = n_splits_for_ratio(w.shape[0], ratio) if n_splits is None else int(n_splits)
    if n == 0:
        spec = OCSSpec.identity(w.shape[0], device=w.device)
        t = find_clip(w, bits, clip_method)
        return w, spec, float(t)

    # Pass 1: naive halving to estimate the post-split grid step.
    w_est, src_est = _run_splits(w, n, 0.0, False)
    thresh = find_clip(w_est, bits, clip_method)
    delta = thresh / qmax(bits)
    if qa:
        w_exp, src = w_est, src_est
        for _ in range(max(1, fixed_point_iters)):
            w_exp, src = _run_splits(w, n, delta, True)
            new_thresh = find_clip(w_exp, bits, clip_method)
            new_delta = new_thresh / qmax(bits)
            if abs(new_delta - delta) <= 1e-7 * max(delta, 1e-12):
                thresh, delta = new_thresh, new_delta
                break
            thresh, delta = new_thresh, new_delta
    else:
        w_exp, src = w_est, src_est

    c_exp = src.shape[0]
    spec = OCSSpec(
        src=src,
        mult=torch.ones(c_exp, dtype=torch.float32, device=w.device),
        bias=torch.zeros(c_exp, dtype=torch.float32, device=w.device),
    )
    return w_exp, spec, float(thresh)


# ---------------------------------------------------------------------------
# Activation OCS (calibration-driven) and Oracle OCS


def split_activations_spec(stats, ratio: float, *, act_delta: float = 0.0, qa: bool = False,
                           device=None) -> OCSSpec:
    """An expansion spec splitting the top-outlier activation channels of a
    calibrated site (``core.histogram.ChannelStats``), on ``device``.

    The first ``ceil(r * C)`` channels of ``stats.split_order()`` (most
    99th-percentile exceedances, ties by the larger abs-max, §5.3) are each
    split once: both copies carry mult 1/2 (Eq. 4). With ``qa`` and the
    grid step ``act_delta``, biases -/+ Δ/4 make the split
    quantization-preserving. Bitwise the reference's for the same stats."""
    c = stats.n_channels
    order = stats.split_order()[:n_splits_for_ratio(c, ratio)]
    src = list(range(c))
    mult = [1.0] * c
    bias = [0.0] * c
    for ch in order:
        ch = int(ch)
        mult[ch] = 0.5
        bias[ch] = -0.25 * act_delta if qa else 0.0
        src.append(ch)
        mult.append(0.5)
        bias.append(+0.25 * act_delta if qa else 0.0)
    return OCSSpec(
        src=torch.tensor(src, dtype=torch.int32, device=device),
        mult=torch.tensor(mult, dtype=torch.float32, device=device),
        bias=torch.tensor(bias, dtype=torch.float32, device=device),
    )


def duplicate_weight_rows(w: torch.Tensor, spec: OCSSpec) -> torch.Tensor:
    """Weight expansion for *activation* OCS: rows are copied unchanged."""
    return w.index_select(0, spec.src.to(device=w.device, dtype=torch.long))


def fold_expansion_mult(w_exp: torch.Tensor, spec: OCSSpec) -> Tuple[torch.Tensor, OCSSpec]:
    """Fold the activation-side multipliers into the expanded weight rows:
    ``(x[:, src] * mult) @ W == x[:, src] @ (mult[:, None] * W)``, so an
    expansion whose bias is zero can be *packed* (float32 ``mult[:, None] *
    w_exp``, and the spec with mult 1 everywhere: pure duplication, the
    dynamic-W8A8 contract). Fold before quantizing: the multiplier changes
    the rows' range. A spec with a non-zero bias (a QA activation split's
    -/+ Δ/4) raises ``ValueError``: a bias cannot move into the weights."""
    if spec.bias.numel() and bool((spec.bias != 0.0).any()):
        raise ValueError(
            "fold_expansion_mult requires bias == 0 (QA activation splits "
            "carry a +-delta/4 bias that cannot move into the weights)"
        )
    mult = spec.mult.to(device=w_exp.device, dtype=torch.float32)
    w_folded = w_exp.to(torch.float32) * mult[:, None]
    return w_folded, OCSSpec(src=spec.src, mult=torch.ones_like(spec.mult), bias=spec.bias)


def oracle_expand(x: torch.Tensor, n_split: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle OCS (Table 4): the ``n_split`` channels of the last axis with
    the largest |x| *in this batch* are halved, both copies. Returns
    ``(x_expanded [..., C + n_split], src int32 [C + n_split])``; gather the
    weight rows with ``src``.

    The reference selects with ``lax.top_k``: largest first, ties to the
    lower index. ``torch.topk`` promises no order among ties on the card,
    and the order of the duplicates is the order of the summation after
    them (ReLU leaves whole channels at 0, which tie), so the selection is
    a stable descending sort. The result keeps ``x``'s dtype, as the
    reference's weakly typed multiplier does."""
    c = x.shape[-1]
    ch_max = x.reshape(-1, c).abs().amax(dim=0)
    top = torch.sort(ch_max, descending=True, stable=True).indices[:n_split]
    mult = torch.ones(c, dtype=x.dtype, device=x.device)
    mult[top] = 0.5
    src = torch.cat([torch.arange(c, device=x.device), top]).to(torch.int32)
    return torch.cat([x * mult, x[..., top] * 0.5], dim=-1), src


# ---------------------------------------------------------------------------
# Collapse (fake-quant evaluation)


def collapse_expanded(
    w_exp: torch.Tensor, spec: OCSSpec, n_orig: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an expanded layer back to its original shape, on ``w_exp``'s
    device: ``(w_eff [n_orig, Cout], y_bias [Cout])``, float32, with
    ``x_exp @ w_exp == x @ w_eff + y_bias`` for every x.

    The reference sums ``mult[c] * w_exp[c]`` into row ``src[c]`` in
    float64 with ``np.add.at``, i.e. row by row in index order. Here the
    rows go in waves: wave k holds every row that is the k-th of its
    ``src``, so no wave adds twice into one row and each output row gets
    its terms in the reference's order; the float64 sums, and so their
    float32 roundings, are bitwise the reference's. ``y_bias = bias @
    w_exp`` is a float64 product on the device, as the reference's numpy
    one, rounded once to float32 (exactly zero when ``bias`` is: weight
    OCS)."""
    dev = w_exp.device
    src = spec.src.detach().cpu().numpy().astype(np.int64)
    w64 = w_exp.to(torch.float64) * spec.mult.to(device=dev, dtype=torch.float64)[:, None]
    # rank[c]: how many rows before c share its src (np.add.at's order).
    order = np.argsort(src, kind="stable")
    sorted_src = src[order]
    first = np.searchsorted(sorted_src, sorted_src, side="left")
    rank = np.empty_like(src)
    rank[order] = np.arange(src.size) - first
    w_eff = torch.zeros((n_orig, w_exp.shape[1]), dtype=torch.float64, device=dev)
    for k in range(int(rank.max()) + 1 if rank.size else 0):
        rows = np.nonzero(rank == k)[0]
        w_eff.index_add_(0, torch.from_numpy(src[rows]).to(dev),
                         w64.index_select(0, torch.from_numpy(rows).to(dev)))
    y_bias = spec.bias.to(device=dev, dtype=torch.float64) @ w_exp.to(torch.float64)
    return w_eff.to(torch.float32), y_bias.to(torch.float32)


# ---------------------------------------------------------------------------
# Fused state for a quantized linear layer


@dataclasses.dataclass
class OCSQuantLinear:
    """Serving-ready quantized linear: expanded int weights + expansion spec.

    ``y = (expand_activations(x, spec) [quantized to a_bits at serve time])
          @ dequant(weight)``. Stacked leaves (``[L, C_exp, Cout]`` values,
    ``[L, 1, Cout]`` scales, ``[L, C_exp]`` spec) slice per layer with
    :meth:`layer`.
    """

    weight: QuantParams  # int values [C_exp(+pad), Cout(+pad)]
    spec: OCSSpec
    n_orig: int = 0
    a_bits: Optional[int] = None
    a_scale: Optional[torch.Tensor] = None  # activation scale from calibration
    # The true output columns when the stored ones are zero-padded
    # (:func:`pad_out_cols`); None when they are not.
    n_out: Optional[int] = None

    @property
    def out_features(self) -> int:
        return self.n_out if self.n_out is not None else int(self.weight.values.shape[-1])

    def is_packed(self) -> bool:
        """True if the expansion is pure duplication (mult 1, or 0 on pad
        rows; bias 0): the dynamic-W8A8 contract. Read back from the device
        once per leaf and cached; slices inherit their stack's answer."""
        packed = self.__dict__.get("_packed")
        if packed is None:
            mult, bias = self.spec.mult, self.spec.bias
            packed = not (
                bool(((mult != 0.0) & (mult != 1.0)).any()) or bool((bias != 0.0).any())
            )
            self._packed = packed
        return packed

    def layer(self, i: int) -> "OCSQuantLinear":
        """Slice one layer of a stacked leaf (views, no copy): a MoE layer's
        ``[L, E, ...]`` expert leaf gives its ``[E, ...]`` stack, which
        ``layers.dense`` takes whole, and that stack's ``layer(e)`` one
        expert."""
        out = OCSQuantLinear(
            weight=QuantParams(
                values=self.weight.values[i],
                scale=self.weight.scale[i],
                bits=self.weight.bits,
                channel_axis=self.weight.channel_axis,
            ),
            spec=OCSSpec(
                src=self.spec.src[i], mult=self.spec.mult[i], bias=self.spec.bias[i]
            ),
            n_orig=self.n_orig,
            a_bits=self.a_bits,
            a_scale=None if self.a_scale is None else self.a_scale[i],
            n_out=self.n_out,
        )
        out._packed = self.is_packed()
        return out


def _pad_expanded(w_exp: torch.Tensor, spec: OCSSpec, pad: int):
    """Zero rows appended to the expanded dim; the spec maps them to channel
    0 with mult 0 (they quantize exactly to 0)."""
    if pad == 0:
        return w_exp, spec
    dev = w_exp.device
    w_exp = torch.cat(
        [w_exp, torch.zeros((pad, w_exp.shape[1]), dtype=w_exp.dtype, device=dev)], 0
    )
    spec = OCSSpec(
        src=torch.cat([spec.src, torch.zeros(pad, dtype=torch.int32, device=dev)]),
        mult=torch.cat([spec.mult, torch.zeros(pad, dtype=torch.float32, device=dev)]),
        bias=torch.cat([spec.bias, torch.zeros(pad, dtype=torch.float32, device=dev)]),
    )
    return w_exp, spec


def make_ocs_quant_linear(
    w: torch.Tensor,
    ratio: float,
    bits: int,
    *,
    qa: bool = True,
    clip_method: Optional[str] = None,
    per_channel: bool = False,
    pad_to: int = 1,
) -> OCSQuantLinear:
    """Full offline weight pipeline: OCS split -> (clip) -> integer quantize.

    ``pad_to`` zero-pads the expanded contraction dim to a multiple. The
    reference's shard-local ``groups`` split serves tensor-parallel meshes,
    which one card does not have.
    """
    w_exp, spec, thresh = split_weights(
        w, ratio, bits, qa=qa, clip_method=clip_method
    )
    w_exp, spec = _pad_expanded(w_exp, spec, (-w_exp.shape[0]) % pad_to)
    clip = None if per_channel else thresh
    qp = quantize_tensor(
        w_exp, bits, channel_axis=1 if per_channel else None, clip=clip
    )
    return OCSQuantLinear(weight=qp, spec=spec, n_orig=int(w.shape[0]))


# ---------------------------------------------------------------------------
# The sub-8-bit tier: packed int4 weights + OCS-ranked int8 outlier rows


@dataclasses.dataclass
class W4A8Linear:
    """Sub-8-bit serving tier: packed int4 weights + 8-bit outlier rows.

    The OCS ranking criterion (§3.4, the rows holding the largest |w|)
    picks ``T`` rows of the expanded contraction axis that stay int8 in
    ``w8``; every other row drops to int4 in ``w4``, where the outlier rows
    are zero, so ``y = q_a @ deq4(w4) + q_a[:, outlier_idx] @ deq8(w8)``
    is an exact partition of the integer sum (``q_a`` the per-row int8,
    OCS-expanded activations). ``w4`` packs two rows a byte in the
    split-half layout: byte row ``j`` holds expanded rows ``j`` (low
    nibble) and ``j + K_exp/2`` (high nibble). Stacked leaves carry a
    leading ``[L]`` on every tensor and slice with :meth:`layer`.
    """

    w4: torch.Tensor  # uint8 [K_exp/2, Cout] packed nibbles, outlier rows zero
    s4: torch.Tensor  # f32 [Cout] per-column int4 grid scale
    w8: torch.Tensor  # int8 [T, Cout] outlier rows at 8 bits
    s8: torch.Tensor  # f32 [Cout] per-column int8 grid scale
    outlier_idx: torch.Tensor  # int32 [T] rows of the expanded K kept at 8 bits
    spec: OCSSpec
    n_orig: int = 0
    a_bits: int = 8
    n_out: Optional[int] = None  # as OCSQuantLinear.n_out

    @property
    def out_features(self) -> int:
        return self.n_out if self.n_out is not None else int(self.w4.shape[-1])

    def layer(self, i: int) -> "W4A8Linear":
        """Slice one layer of a stacked leaf (views, no copy); as
        :meth:`OCSQuantLinear.layer` for ``[L, E, ...]`` expert leaves."""
        return W4A8Linear(
            w4=self.w4[i], s4=self.s4[i], w8=self.w8[i], s8=self.s8[i],
            outlier_idx=self.outlier_idx[i],
            spec=OCSSpec(
                src=self.spec.src[i], mult=self.spec.mult[i], bias=self.spec.bias[i]
            ),
            n_orig=self.n_orig,
            a_bits=self.a_bits,
            n_out=self.n_out,
        )


def pad_out_cols(lin):
    """An :class:`OCSQuantLinear` or :class:`W4A8Linear` whose output columns
    are zero-padded to a multiple of :data:`PAD_N` (values and per-column
    scales; a per-tensor scale stays), with ``n_out`` the true count. A
    leaf already aligned, or already padded, comes back as it is.
    ``layers.dense`` slices the padded columns off every output, so the
    card's GEMMs take the leaf as stored and copy no weight per call."""
    if isinstance(lin, W4A8Linear):
        n = lin.w4.shape[-1]
        if n % PAD_N == 0:
            return lin
        cols = n + (-n) % PAD_N
        return dataclasses.replace(
            lin, w4=pad_cols(lin.w4, cols), s4=pad_cols(lin.s4, cols),
            w8=pad_cols(lin.w8, cols), s8=pad_cols(lin.s8, cols), n_out=lin.out_features)
    qp = lin.weight
    n = qp.values.shape[-1]
    if n % PAD_N == 0:
        return lin
    cols = n + (-n) % PAD_N
    scale = qp.scale
    if scale.ndim and scale.shape[-1] == n:  # per-channel ([N] or [..., 1, N])
        scale = pad_cols(scale, cols)
    out = dataclasses.replace(
        lin, weight=QuantParams(pad_cols(qp.values, cols), scale, qp.bits, qp.channel_axis),
        n_out=lin.out_features)
    if "_packed" in lin.__dict__:
        out._packed = lin._packed
    return out


def _abs_max(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w.abs().amax(dim)`` without the ``|w|`` copy: max(max w, -min w),
    the same value (for a zero maximum, perhaps its other sign)."""
    return torch.maximum(w.amax(dim=dim), -w.amin(dim=dim))


def _w4a8_split(w: torch.Tensor, ratio: float):
    """Separate and quantize one ``[K_exp, Cout]`` float32 matrix, on its
    device. Returns ``(w4 uint8, s4, q8 int8, s8, outlier_idx int32)``,
    bitwise the reference's numpy ``_w4a8_split``: a stable argsort of
    ``-max|W[k, :]|``, the sorted top ``ceil(ratio * K_exp)`` rows, float32
    ``amax / 7`` and ``amax / 127`` scales (true division on the card too:
    ``div_exact``), ``floor(w / s + 1/2)``."""
    k_exp, n = w.shape
    if k_exp % 2:
        raise ValueError(
            f"w4a8 split-half packing needs an even contraction dim, got {k_exp}"
        )
    dev = w.device
    s_out = n_splits_for_ratio(k_exp, ratio)
    if s_out:
        order = torch.argsort(-_abs_max(w, 1), stable=True)
        outlier_idx = torch.sort(order[:s_out]).values.to(torch.int32)
    else:
        outlier_idx = torch.zeros((0,), dtype=torch.int32, device=dev)
    oi = outlier_idx.long()

    w_lo = w.index_fill(0, oi, 0.0)
    s4 = div_exact(torch.clamp_min(_abs_max(w_lo, 0), 1e-30), 7.0)
    # floor(w / s4 + 1/2), clamped, in place on the copy.
    q4 = w_lo.div_(s4[None, :]).add_(0.5).floor_().clamp_(-7, 7).to(torch.int8)
    del w_lo
    w4 = pack_int4(q4, dim=0)  # split-half along the contraction axis
    del q4

    w_out = w[oi]  # [T, N]
    if s_out:
        s8 = div_exact(torch.clamp_min(_abs_max(w_out, 0), 1e-30), 127.0)
    else:
        s8 = torch.ones((n,), dtype=torch.float32, device=dev)
    q8 = torch.clamp(torch.floor(w_out / s8[None, :] + 0.5), -127, 127).to(torch.int8)
    return w4, s4, q8, s8, outlier_idx


def to_w4a8(lin: OCSQuantLinear, ratio: float) -> W4A8Linear:
    """Convert an int8-tier :class:`OCSQuantLinear` to the W4A8 tier, on the
    leaf's device (the port of ``repro.core.ocs.to_w4a8``).

    ``ratio`` is the outlier fraction: ``ceil(ratio * K_exp)`` expanded
    input channels, ranked by ``max|W[k, :]|``, keep int8 rows; the rest
    drop to packed int4. ``ratio == 0`` keeps no outlier rows. An odd
    ``K_exp`` gets one zero weight row and a dead spec entry (src 0, mult
    0, bias 0). Stacked leaves keep their leading dims, ``[L]`` or a MoE
    layer's ``[L, E]`` experts (one slice is dequantized at a time, which
    bounds the float32 copy). A leaf whose output columns are padded
    (:func:`pad_out_cols`, as ``quantize_params`` stores them) converts
    them too (zero columns stay zero) and keeps its ``n_out``, so the
    result is padded alike.
    """
    if not 0.0 <= ratio <= 1.0:
        raise ValueError(f"outlier ratio must be in [0, 1], got {ratio}")
    qp, spec = lin.weight, lin.spec
    values = qp.values
    odd = values.shape[-2] % 2
    if odd:
        def pad1(a, v):
            return torch.cat([a, torch.full(a.shape[:-1] + (1,), v, dtype=a.dtype,
                                            device=a.device)], dim=-1)

        spec = OCSSpec(src=pad1(spec.src, 0), mult=pad1(spec.mult, 0.0),
                       bias=pad1(spec.bias, 0.0))
    lead = tuple(values.shape[:-2])
    flat_v = values.reshape((-1,) + tuple(values.shape[-2:]))
    if lead:
        if qp.channel_axis is not None:
            raise ValueError("stacked leaves carry broadcast-ready scales (channel_axis None)")
        flat_s = qp.scale.reshape((flat_v.shape[0],) + tuple(qp.scale.shape[len(lead):]))
    parts = []
    for i in range(flat_v.shape[0]):
        if lead:
            w = QuantParams(flat_v[i], flat_s[i], qp.bits).dequant(torch.float32)
        else:
            w = qp.dequant(torch.float32)
        if odd:
            w = torch.cat([w, torch.zeros((1, w.shape[1]), dtype=w.dtype, device=w.device)])
        parts.append(_w4a8_split(w, ratio))
        del w
    if lead:
        w4, s4, q8, s8, oidx = (
            torch.stack([p[j] for p in parts]).reshape(lead + tuple(parts[0][j].shape))
            for j in range(5)
        )
    else:
        w4, s4, q8, s8, oidx = parts[0]
    return W4A8Linear(
        w4=w4, s4=s4, w8=q8, s8=s8, outlier_idx=oidx, spec=spec, n_orig=lin.n_orig,
        a_bits=lin.a_bits if lin.a_bits is not None else 8, n_out=lin.n_out,
    )
