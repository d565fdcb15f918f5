"""Clip-threshold optimization (paper §4), the port of ``repro.core.clipping``.

``mse`` sweeps candidate thresholds and minimizes the histogram-weighted
quantization MSE (paper Eq. 9); ``none`` (no clipping) is threshold =
max|x|. The sweep itself is host-side numpy over 2048 bins, as in the
reference. A weight tensor is binned where it lives: on the card the
``|x|`` histogram of a [4096, 151552] matrix is one ``bincount`` instead of
minutes of ``np.add.at`` on the host, with the same bin index arithmetic
(float32 ``|x| * (n_bins / max|x|)``, truncated), so the counts are equal.
ACIQ and KL arrive with the experiment tables that use them.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .histogram import StreamingHistogram
from .quantizer import qmax

__all__ = ["find_clip", "CLIP_METHODS", "mse_clip"]


def _tensor_to_hist(x, n_bins: int = 2048) -> StreamingHistogram:
    """One-shot ``StreamingHistogram.update`` of a whole tensor.

    For a torch tensor the counts are taken on its device. A single update
    never doubles the range (it starts at the tensor's own max), so the
    result equals ``StreamingHistogram(n_bins).update(x)`` exactly.
    """
    if not isinstance(x, torch.Tensor):
        h = StreamingHistogram(n_bins)
        h.update(np.asarray(x))
        return h
    h = StreamingHistogram(n_bins)
    ax = x.detach().to(torch.float32).abs().reshape(-1)
    if ax.numel() == 0:
        return h
    m = float(ax.max())
    h.max_seen = m
    h.range = m if m > 0 else 1.0
    # numpy multiplies the float32 array by the (weak) Python float, i.e. by
    # its float32 rounding; spell that rounding out.
    mult = torch.tensor(n_bins / h.range, dtype=torch.float32, device=ax.device)
    idx = torch.clamp_max((ax * mult).to(torch.int64), n_bins - 1)
    h.counts = torch.bincount(idx, minlength=n_bins).cpu().numpy().astype(np.int64)
    h.total = int(ax.numel())
    return h


def _hist_quant_mse(centers, counts, thresh: float, bits: int) -> float:
    """Histogram-weighted MSE of symmetric linear quantization clipped at thresh."""
    if thresh <= 0:
        return float("inf")
    scale = thresh / qmax(bits)
    q = np.clip(np.round(centers / scale), 0, qmax(bits)) * scale
    return float((counts * (centers - q) ** 2).sum() / max(counts.sum(), 1))


def mse_clip(hist: StreamingHistogram, bits: int, n_candidates: int = 128) -> float:
    """Sweep evenly spaced thresholds in (0, max|x|], pick minimal MSE (Eq. 9)."""
    centers = hist.bin_centers
    counts = hist.counts.astype(np.float64)
    hi = hist.max_seen if hist.max_seen > 0 else hist.range
    best_t, best_mse = hi, float("inf")
    for t in np.linspace(hi / n_candidates, hi, n_candidates):
        m = _hist_quant_mse(centers, counts, float(t), bits)
        if m < best_mse:
            best_mse, best_t = m, float(t)
    return best_t


CLIP_METHODS = {"mse": mse_clip}


def find_clip(
    x_or_hist: Union[np.ndarray, torch.Tensor, StreamingHistogram],
    bits: int,
    method: Optional[str],
) -> float:
    """Return the clip threshold T for the given method ('none'/None = max|x|)."""
    hist = (
        x_or_hist
        if isinstance(x_or_hist, StreamingHistogram)
        else _tensor_to_hist(x_or_hist)
    )
    if method in (None, "none", "max"):
        return float(max(hist.max_seen, 1e-30))
    if method not in CLIP_METHODS:
        raise ValueError(
            f"unknown clip method {method!r}; the port has {list(CLIP_METHODS)} "
            "(aciq/kl arrive with the experiment tables, ROADMAP A14)"
        )
    return float(CLIP_METHODS[method](hist, bits))
