"""Live quantization-drift telemetry (paper §5; the port of
``repro.obs.drift``).

OCS/clip calibration fixes a per-site activation grid from the outlier
profile seen at calibration time. Under deployment traffic that profile
drifts — and quantization error grows silently, because the serving path
clips activations to the *calibrated* range no matter what arrives. The
:class:`QuantDriftMonitor` watches exactly that gap: the per-site
**saturation rate** (fraction of activation magnitudes above the
calibrated clip) versus the outlier mass the calibration profile budgeted
for, flagging a site when live mass exceeds calibration by ``factor``.

Mechanics — every piece reuses existing machinery:

* **Sampling**: the engine runs one decode forward every ``drift_every``
  steps with a collector active (logits discarded, and the page-pool rows
  it writes restored, so serving state is untouched). ``tap.tag`` does
  nothing without a collector and copies the activations to the host with
  one, so the existing tap sites in ``models/layers.dense`` feed the
  monitor, with ``core/tap``'s ``name#ordinal`` site keying.
* **Profiles**: per-site :class:`~repro_torch.core.histogram.StreamingHistogram`
  (fixed 2048 bins — bounded memory) builds the calibration-reference
  during the first ``calib_samples`` sampled steps; the live window is an
  EMA of per-sample saturation rates (a float per site).
* **Clips**: sites quantized with a static activation grid use the
  calibrated clip (``a_scale * qmax(a_bits)`` via :func:`clips_from_params`);
  dynamically-quantized / float sites self-calibrate a reference clip at
  ``quantile`` of the early-traffic magnitude distribution.

A site is **flagged** when it has seen at least ``min_values`` live values
and its EMA saturation rate exceeds ``factor * calib_rate`` where
``calib_rate`` is the outlier mass the calibration window put above the
clip, floored at a per-precision-tier rate (``(1 - quantile)`` scaled up
``2x`` per bit below 8 — see ``grid_bits``) so an empty tail can't make
any exceedance an alarm, and so the coarser int4/w4a8 grids' naturally
higher saturation never false-flags ordinary traffic.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core import tap
from ..core.apply import map_with_path
from ..core.histogram import StreamingHistogram
from ..core.ocs import OCSQuantLinear, W4A8Linear
from ..core.quantizer import qmax

__all__ = ["QuantDriftMonitor", "clips_from_params"]

# tap-site names bound at the dense() call sites, keyed by the weight's
# name in the params tree (see models/attention.py and mlp.py; the MoE and
# SSM names are the reference's, for the blocks the port has not reached)
_WEIGHT_TO_SITE = {
    "wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_o",
    "w_gate": "mlp_gate", "w_up": "mlp_up", "w_down": "mlp_down",
    "w_in": "mlp_in", "w_out2": "mlp_out",
    "in_proj": "ssm_in", "out_proj": "ssm_out",
    "head": "lm_head",
}


class _SiteState:
    __slots__ = ("hist", "clip", "calib_rate", "calib_batches", "ema_rate",
                 "live_values", "fixed_clip")

    def __init__(self, clip: Optional[float]):
        self.hist = StreamingHistogram()
        self.clip = clip                 # None until calibrated
        self.fixed_clip = clip is not None
        self.calib_rate = 0.0
        self.calib_batches = 0
        self.ema_rate = 0.0
        self.live_values = 0


class _DriftCollector:
    """Duck-typed stand-in for ``core.tap.Collector``: same ``begin_batch``
    / ``add`` protocol, but feeds the monitor instead of ChannelStats."""

    def __init__(self, monitor: "QuantDriftMonitor"):
        self._monitor = monitor
        self._counts: Dict[str, int] = {}

    def begin_batch(self) -> None:
        self._counts = {}

    def add(self, name: str, x: np.ndarray) -> None:
        k = self._counts.get(name, 0)
        self._counts[name] = k + 1
        self._monitor.observe(f"{name}#{k}", x)


class QuantDriftMonitor:
    """Tracks per-site activation saturation against the calibrated grid."""

    def __init__(self, *, clips: Optional[Dict[str, float]] = None,
                 quantile: float = 0.999, factor: float = 4.0,
                 calib_samples: int = 8, min_values: int = 2048,
                 ema_alpha: float = 0.25, grid_bits: int = 8):
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0,1), got {quantile}")
        if factor <= 1.0:
            raise ValueError(f"drift factor must be > 1, got {factor}")
        if grid_bits < 2 or grid_bits > 8:
            raise ValueError(f"grid_bits must be in [2, 8], got {grid_bits}")
        self.clips = dict(clips or {})
        self.quantile = quantile
        self.factor = factor
        self.calib_samples = calib_samples
        self.min_values = min_values
        self.ema_alpha = ema_alpha
        # Per-precision-tier calibration floor: a b-bit grid has 2^(8-b)x
        # fewer levels than int8, so the same calibrated clip saturates a
        # proportionally larger activation mass *by design* — the sub-8-bit
        # tiers budget that much more baseline outlier mass before a site
        # counts as drifted. Without this, an engine serving the int4 tier
        # would false-flag every site from its ordinary traffic.
        self.grid_bits = grid_bits
        self.rate_floor = (1.0 - quantile) * float(2 ** (8 - grid_bits))
        self.sites: Dict[str, _SiteState] = {}
        self.samples = 0  # sampled forward passes observed

    # -- ingestion ----------------------------------------------------------

    def collector(self) -> _DriftCollector:
        """Fresh tap-protocol collector for one forward pass."""
        return _DriftCollector(self)

    def sample(self, forward: Callable[[], object]) -> None:
        """Run ``forward`` (an *eager* model call) with activation taps
        routed into this monitor. The callable's outputs are discarded —
        only the tapped activations matter."""
        c = self.collector()
        c.begin_batch()
        with tap.collecting(c):
            forward()
        self.samples += 1

    def observe(self, site: str, x: np.ndarray) -> None:
        """Record one batch of activations for ``site``."""
        a = np.abs(np.asarray(x, dtype=np.float32)).ravel()
        if a.size == 0:
            return
        st = self.sites.get(site)
        if st is None:
            st = self.sites[site] = _SiteState(self.clips.get(site))
        if st.calib_batches < self.calib_samples:
            # calibration window: build the reference profile. Sites with a
            # grid-calibrated clip still accumulate the histogram so
            # calib_rate reflects in-profile traffic against that clip.
            st.hist.update(a)
            st.calib_batches += 1
            if st.calib_batches == self.calib_samples:
                if not st.fixed_clip:
                    st.clip = float(st.hist.quantile(self.quantile))
                st.calib_rate = max(
                    self._mass_above(st.hist, st.clip), self.rate_floor
                )
            return
        rate = float((a > st.clip).mean())
        st.ema_rate += self.ema_alpha * (rate - st.ema_rate)
        st.live_values += a.size

    @staticmethod
    def _mass_above(hist: StreamingHistogram, clip: float) -> float:
        if hist.total == 0 or clip is None:
            return 0.0
        above = hist.counts[hist.bin_edges[1:] > clip].sum()
        return float(above) / float(hist.total)

    # -- reporting ----------------------------------------------------------

    def ratio(self, st: _SiteState) -> float:
        return st.ema_rate / st.calib_rate if st.calib_rate > 0 else 0.0

    def flagged(self) -> Dict[str, float]:
        """Sites currently in drift -> live/calibrated outlier-mass ratio."""
        out = {}
        for name, st in self.sites.items():
            if (st.clip is not None and st.live_values >= self.min_values
                    and st.ema_rate > self.factor * st.calib_rate):
                out[name] = self.ratio(st)
        return out

    def stats(self) -> Dict[str, float]:
        flagged = self.flagged()
        max_ratio = 0.0
        for st in self.sites.values():
            if st.clip is not None and st.live_values >= self.min_values:
                max_ratio = max(max_ratio, self.ratio(st))
        return {
            "drift_samples": self.samples,
            "drift_sites": len(self.sites),
            "drift_flagged_sites": len(flagged),
            "drift_max_ratio": max_ratio,
        }

    def report(self) -> Dict[str, dict]:
        """Per-site diagnostic view (clip, calibrated vs live outlier mass)."""
        return {
            name: {
                "clip": st.clip,
                "calibrated": st.calib_batches >= self.calib_samples,
                "grid_clip": st.fixed_clip,
                "calib_rate": st.calib_rate,
                "live_rate": st.ema_rate,
                "live_values": st.live_values,
                "ratio": self.ratio(st),
            }
            for name, st in self.sites.items()
        }

    def publish(self, registry) -> None:
        """Mirror monitor state into a metrics registry (labelled gauges)."""
        s = self.stats()
        registry.gauge(
            "quant_drift_sites", "tap sites tracked by the drift monitor"
        ).set(s["drift_sites"])
        registry.gauge(
            "quant_drift_flagged_sites", "sites whose live outlier mass "
            "exceeds the calibrated budget"
        ).set(s["drift_flagged_sites"])
        registry.gauge(
            "quant_drift_max_ratio", "max live/calibrated outlier-mass ratio"
        ).set(s["drift_max_ratio"])
        for name, st in self.sites.items():
            registry.gauge(
                "quant_drift_saturation_rate",
                "EMA fraction of activation magnitudes above the site clip",
                labels={"site": name},
            ).set(st.ema_rate)


def clips_from_params(params) -> Dict[str, float]:
    """Derive per-tap-site clip thresholds from a quantized params tree.

    Sites whose :class:`~repro_torch.core.ocs.OCSQuantLinear` leaves carry a
    static activation grid (``a_bits``/``a_scale`` from calibration) map to
    ``clip = a_scale * qmax(a_bits)`` — the largest representable magnitude
    on that grid. Dynamically-quantized and float leaves contribute
    nothing (the monitor self-calibrates those sites), and so do
    :class:`~repro_torch.core.ocs.W4A8Linear` leaves (their activations are
    quantized dynamically). The tree is walked in sorted key order, as the
    reference's ``jax.tree_util`` walk visits dict keys, so a site's ordinal
    is the same in both packages. Returns ``{}`` for layouts it does not
    recognize rather than guessing.
    """
    clips: Dict[str, float] = {}
    ordinals: Dict[str, int] = {}

    def visit(path, leaf):
        if not isinstance(leaf, OCSQuantLinear):
            return leaf
        if leaf.a_bits is None or leaf.a_scale is None:
            return leaf
        key = None
        for p in reversed(path):
            if isinstance(p, str) and p in _WEIGHT_TO_SITE:
                key = _WEIGHT_TO_SITE[p]
                break
        if key is None:
            return leaf
        k = ordinals.get(key, 0)
        ordinals[key] = k + 1
        scale = leaf.a_scale.detach().to("cpu", dtype=torch.float32).numpy()
        clips[f"{key}#{k}"] = float(scale.max() * qmax(leaf.a_bits))
        return leaf

    def sorted_tree(tree):
        if isinstance(tree, dict):
            return {k: sorted_tree(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)) and not isinstance(tree, (OCSQuantLinear,
                                                                       W4A8Linear)):
            return type(tree)(sorted_tree(v) for v in tree)
        return tree

    try:
        map_with_path(visit, sorted_tree(params),
                      is_leaf=lambda l: isinstance(l, (OCSQuantLinear, W4A8Linear)))
    except Exception:
        return {}
    return clips
