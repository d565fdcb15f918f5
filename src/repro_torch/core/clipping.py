"""Clip-threshold optimization (paper §4), the port of ``repro.core.clipping``.

* ``mse`` sweeps candidate thresholds and minimizes the histogram-weighted
  quantization MSE (paper Eq. 9);
* ``aciq`` fits a Gaussian and a Laplacian to the ``|x|`` moments and
  minimizes the better fit's closed-form clip + rounding MSE on the
  ``2^(k-1) - 1``-step sign-magnitude grid (Banner et al. 2018);
* ``kl`` minimizes the KL divergence between the clipped histogram and its
  ``2^k - 1``-bin requantization (TensorRT/MXNet style);
* ``none`` (no clipping) is threshold = max|x|.

The searches are host-side numpy and ``math`` over 2048 bins, the
reference's arithmetic step for step, so the thresholds equal its. A
weight tensor is binned where it lives: on the card the ``|x|`` histogram of a [4096, 151552] matrix is one ``bincount`` instead of
minutes of ``np.add.at`` on the host, with the same bin index arithmetic
(float32 ``|x| * (n_bins / max|x|)``, truncated), so the counts are equal.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from .histogram import StreamingHistogram
from .quantizer import qmax

__all__ = ["find_clip", "CLIP_METHODS", "mse_clip", "aciq_clip", "kl_clip"]


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
    ax = x.detach().to(torch.float32).abs().reshape(-1)  # a copy: scaled in place below
    if ax.numel() == 0:
        return h
    m = float(ax.max())
    h.max_seen = m
    h.range = m if m > 0 else 1.0
    # numpy multiplies the float32 array by the (weak) Python float, i.e. by
    # its float32 rounding; spell that rounding out. The float -> int cast
    # truncates as numpy's does; the indices are at most ~n_bins, so int32
    # holds them.
    mult = torch.tensor(n_bins / h.range, dtype=torch.float32, device=ax.device)
    counts = torch.bincount(ax.mul_(mult).to(torch.int32), minlength=n_bins)
    del ax
    # The maximum (and a product rounded up to it) lands at index n_bins or
    # just past it: the reference clamps those into the last bin.
    counts = counts.cpu().numpy().astype(np.int64)
    counts[n_bins - 1] += counts[n_bins:].sum()
    h.counts = counts[:n_bins].copy()
    h.total = int(x.numel())
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


# ---------------------------------------------------------------------------
# ACIQ


def _phi(z):
    return math.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _Q(z):
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def _gauss_clip_mse(alpha: float, sigma: float, bits: int) -> float:
    """MSE(alpha) = 2*E[(x-a)^2; x>a] + step^2/12 for X ~ N(0, sigma^2)."""
    if alpha <= 0:
        return float("inf")
    z = alpha / sigma
    clip_noise = 2.0 * ((sigma**2 + alpha**2) * _Q(z) - alpha * sigma * _phi(z))
    step = alpha / qmax(bits)  # 2^(k-1)-1 positive steps (sign-magnitude grid)
    return clip_noise + step**2 / 12.0


def _laplace_clip_mse(alpha: float, b: float, bits: int) -> float:
    """For X ~ Laplace(0, b): 2*∫_a^inf (x-a)^2 f = 2 b^2 e^{-a/b}."""
    if alpha <= 0:
        return float("inf")
    clip_noise = 2.0 * b * b * math.exp(-alpha / b)
    step = alpha / qmax(bits)
    return clip_noise + step**2 / 12.0


def _golden_min(f, lo: float, hi: float, iters: int = 60) -> float:
    gr = (math.sqrt(5) - 1) / 2
    a, b = lo, hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    for _ in range(iters):
        if f(c) < f(d):
            b = d
        else:
            a = c
        c, d = b - gr * (b - a), a + gr * (b - a)
    return 0.5 * (a + b)


def aciq_clip(hist: StreamingHistogram, bits: int) -> float:
    """Fit Gaussian & Laplacian to |x| stats; use the better fit's
    closed-form MSE. Laplace MLE b = E|x|, Gaussian sigma^2 = E[x^2]; the
    fit whose moment relation (E[x^2] = 2 b^2, resp. E|x| =
    sigma*sqrt(2/pi)) the data matches better wins."""
    b = hist.mean_abs()
    var = hist.var_abs()
    sigma = math.sqrt(max(var, 1e-30))
    if b <= 0:
        return max(hist.max_seen, 1e-30)
    lap_err = abs(var - 2 * b * b) / max(var, 1e-30)
    gau_err = abs(b - sigma * math.sqrt(2 / math.pi)) / max(b, 1e-30)
    hi = max(hist.max_seen, hist.range)
    if lap_err < gau_err:
        alpha = _golden_min(lambda a: _laplace_clip_mse(a, b, bits), 1e-8, hi)
    else:
        alpha = _golden_min(lambda a: _gauss_clip_mse(a, sigma, bits), 1e-8, hi)
    return float(min(alpha, hi))


# ---------------------------------------------------------------------------
# KL divergence (TensorRT / MXNet style)


def _smooth_distribution(p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """MXNet's smoothing: move eps mass into zero bins from nonzero bins."""
    p = p.astype(np.float64)
    is_zero = p == 0
    n_zeros = int(is_zero.sum())
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        return p
    eps1 = eps * n_zeros / n_nonzeros
    out = p.copy()
    out[is_zero] = eps
    out[~is_zero] -= eps1
    if (out[~is_zero] <= 0).any():  # degenerate; fall back to uniform blend
        out = p + eps
    return out


def _kl(p: np.ndarray, q: np.ndarray) -> float:
    p = p / max(p.sum(), 1e-30)
    q = q / max(q.sum(), 1e-30)
    mask = p > 0
    return float((p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-30))).sum())


def kl_clip(hist: StreamingHistogram, bits: int) -> float:
    """Minimize KL(ref || quantized) over candidate thresholds (MXNet's
    ``_get_optimal_threshold``): for each candidate bin count i, the
    reference is hist[:i] with the tail folded into its last bin, the
    candidate that reference summed into ``2^k - 1`` bins and spread back
    over each bin's nonzero members, both smoothed.

    The spread back is one vectorised ``where`` over the ``[2^k - 1,
    repl]`` blocks where the reference loops over the blocks: the same
    float64 quotient ``q_small[j] / occupancy[j]`` lands in each nonzero
    member, so the candidate is bitwise the reference's."""
    counts = hist.counts.astype(np.float64)
    n_bins = hist.n_bins
    n_quant = (1 << bits) - 1
    if counts.sum() == 0:
        return max(hist.max_seen, 1e-30)
    nz = np.nonzero(counts)[0]
    hi_bin = int(nz[-1]) + 1 if nz.size else n_bins
    best_t, best_kl = hist.bin_edges[hi_bin], float("inf")
    start = max(n_quant, hi_bin // 16, 1)
    for i in range(start, hi_bin + 1, max(1, (hi_bin - start) // 64 or 1)):
        ref = counts[:i].copy()
        ref[-1] += counts[i:].sum()  # fold outlier tail into the last bin
        repl = int(np.ceil(i / n_quant))
        padded = np.zeros(repl * n_quant)
        padded[:i] = ref
        blocks = padded.reshape(n_quant, repl)
        q_small = blocks.sum(axis=1)
        member = blocks > 0
        occupancy = member.sum(axis=1)
        share = q_small / np.maximum(occupancy, 1)
        expanded = np.where(member, share[:, None], 0.0).reshape(-1)[:i]
        p = _smooth_distribution(ref)
        q = _smooth_distribution(expanded)
        d = _kl(p, q)
        if d < best_kl:
            best_kl, best_t = d, float(hist.bin_edges[i])
    return best_t


CLIP_METHODS = {"mse": mse_clip, "aciq": aciq_clip, "kl": kl_clip}


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
        raise ValueError(f"unknown clip method {method!r}; want one of {list(CLIP_METHODS)}")
    return float(CLIP_METHODS[method](hist, bits))
