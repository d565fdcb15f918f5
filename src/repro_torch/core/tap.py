"""Activation tapping for calibration and drift telemetry (the port of
``repro.core.tap``).

Models call ``tap.tag(site_name, x)`` at every quantizable activation site
(the input of each linear layer). Outside a ``collecting(...)`` context this
does nothing at all: no copy, no ``.cpu()``, no device synchronisation, so
the serving step launches exactly the device operations it launches without
the tap sites. Inside one, the values are copied to the host and accumulated
into per-site :class:`ChannelStats` (or whatever the collector does with
them: the drift monitor's collector feeds its own profiles).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from .histogram import ChannelStats

__all__ = ["Collector", "collecting", "tag", "active_collector"]

_ACTIVE: Optional["Collector"] = None


class Collector:
    """Accumulates per-site channel statistics across calibration batches.

    Site names repeat across layers ("mlp_up" in every block), so sites are
    keyed ``name#ordinal`` with the ordinal counting occurrences *within one
    forward pass* (``begin_batch`` resets it): per-layer sites, in the
    model's layer order.
    """

    def __init__(self, percentile: float = 0.99):
        self.percentile = percentile
        self.sites: Dict[str, ChannelStats] = {}
        self._counts: Dict[str, int] = {}

    def begin_batch(self) -> None:
        self._counts = {}

    def add(self, name: str, x: np.ndarray) -> None:
        k = self._counts.get(name, 0)
        self._counts[name] = k + 1
        key = f"{name}#{k}"
        c = x.shape[-1]
        st = self.sites.get(key)
        if st is None:
            st = self.sites[key] = ChannelStats(
                n_channels=c, percentile=self.percentile
            )
        if st.n_channels != c:
            raise ValueError(
                f"site {key!r}: channel count changed {st.n_channels} -> {c}"
            )
        st.update(x)

    def __getitem__(self, name: str) -> ChannelStats:
        return self.sites[name]

    def __contains__(self, name: str) -> bool:
        return name in self.sites

    def __len__(self) -> int:
        return len(self.sites)


@contextlib.contextmanager
def collecting(collector: Collector):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, collector
    try:
        yield collector
    finally:
        _ACTIVE = prev


def active_collector() -> Optional[Collector]:
    return _ACTIVE


def tag(name: str, x: torch.Tensor) -> None:
    """Record activation values for ``name`` if a collector is active (the
    values as float32 on the host; bfloat16 widens exactly)."""
    if _ACTIVE is None:
        return
    _ACTIVE.add(name, x.detach().to(torch.float32).cpu().numpy())
