"""Streaming histograms for calibration (TensorRT/MXNet-style).

Activation clipping (paper §4) and activation-OCS channel selection (paper §5.3)
both work on *sampled distributions*: a small number of calibration batches is run
through the float model and per-layer statistics are accumulated. At production
scale the raw samples cannot be stored, so we accumulate:

* an absolute-value histogram with power-of-two range growth (rebinning by
  integer factors keeps previously accumulated mass exact), and
* per-channel statistics (abs-max and counts of values above a high quantile)
  for OCS channel selection.

Everything here is host-side numpy — calibration is a pipeline stage, not a
training hot loop. (The port's copy of ``repro.core.histogram``. A whole
weight tensor is binned on its own device by ``clipping._tensor_to_hist``.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["StreamingHistogram", "ChannelStats"]


class StreamingHistogram:
    """Histogram of |x| over [0, range) with automatic range doubling."""

    def __init__(self, n_bins: int = 2048):
        self.n_bins = int(n_bins)
        self.counts = np.zeros(self.n_bins, dtype=np.int64)
        self.range = 0.0  # upper edge; 0 means empty
        self.total = 0
        self.max_seen = 0.0

    def update(self, x: np.ndarray) -> None:
        ax = np.abs(np.asarray(x, dtype=np.float32)).ravel()
        if ax.size == 0:
            return
        m = float(ax.max())
        self.max_seen = max(self.max_seen, m)
        if self.range == 0.0:
            self.range = m if m > 0 else 1.0
        while m > self.range:
            self._double_range()
        idx = np.minimum(
            (ax * (self.n_bins / self.range)).astype(np.int64), self.n_bins - 1
        )
        np.add.at(self.counts, idx, 1)
        self.total += ax.size

    def _double_range(self) -> None:
        # Fold pairs of bins together: [0,R) -> [0,2R) with exact mass transfer.
        folded = self.counts.reshape(self.n_bins // 2, 2).sum(axis=1)
        self.counts = np.concatenate(
            [folded, np.zeros(self.n_bins - self.n_bins // 2, dtype=np.int64)]
        )
        self.range *= 2.0

    @property
    def bin_edges(self) -> np.ndarray:
        return np.linspace(0.0, self.range, self.n_bins + 1)

    @property
    def bin_centers(self) -> np.ndarray:
        e = self.bin_edges
        return 0.5 * (e[:-1] + e[1:])

    def quantile(self, q: float) -> float:
        """Approximate q-quantile of |x| from the histogram."""
        if self.total == 0:
            return 0.0
        cdf = np.cumsum(self.counts) / self.total
        i = int(np.searchsorted(cdf, q))
        return float(self.bin_edges[min(i + 1, self.n_bins)])

    def mean_abs(self) -> float:
        if self.total == 0:
            return 0.0
        return float((self.counts * self.bin_centers).sum() / self.total)

    def var_abs(self) -> float:
        """E[x^2] of the underlying symmetric distribution (= Var for zero mean)."""
        if self.total == 0:
            return 0.0
        return float((self.counts * self.bin_centers**2).sum() / self.total)


@dataclasses.dataclass
class ChannelStats:
    """Per-channel calibration stats for activation OCS (paper §5.3).

    ``exceed_counts[c]`` counts values in channel ``c`` above the (running)
    99th-percentile threshold — channels with the highest counts are split.
    """

    n_channels: int
    percentile: float = 0.99
    abs_max: Optional[np.ndarray] = None
    exceed_counts: Optional[np.ndarray] = None
    hist: Optional[StreamingHistogram] = None

    def __post_init__(self):
        if self.abs_max is None:
            self.abs_max = np.zeros(self.n_channels, dtype=np.float32)
        if self.exceed_counts is None:
            self.exceed_counts = np.zeros(self.n_channels, dtype=np.int64)
        if self.hist is None:
            self.hist = StreamingHistogram()

    def update(self, x: np.ndarray, channel_axis: int = -1) -> None:
        """x: activation batch; channel_axis indexes the layer's input channels."""
        x = np.asarray(x, dtype=np.float32)
        x = np.moveaxis(x, channel_axis, -1).reshape(-1, self.n_channels)
        ax = np.abs(x)
        self.hist.update(ax)
        thresh = self.hist.quantile(self.percentile)
        self.abs_max = np.maximum(self.abs_max, ax.max(axis=0))
        self.exceed_counts += (ax > thresh).sum(axis=0)

    def split_order(self) -> np.ndarray:
        """Channels ordered by outlier-count (descending), ties by abs-max."""
        # lexsort: last key is primary.
        return np.lexsort((-self.abs_max, -self.exceed_counts))
