"""Typed metrics primitives and a central registry (the port of
``repro.obs.metrics``, line for line: pure Python).

Counter / Gauge / Histogram with a :class:`MetricsRegistry` that owns every
instrument, renders Prometheus text exposition, and produces JSON-safe
snapshots (one dict per call — ``serve.py`` appends them as JSONL lines).

Design constraints, in order:

* **Hot-path cheap.** ``Counter.inc`` is one float add; ``Histogram.observe``
  is a float add, a deque append, and a bisect into a short bounds tuple.
  The engine calls these every step/token, observability on or off.
* **Bounded memory.** Histograms keep Prometheus-style cumulative bucket
  counts (fixed bounds) plus a bounded reservoir of recent observations for
  exact quantiles — a rolling window, never the full event stream.
* **Derivable views.** ``as_dict()`` flattens the registry into the flat
  ``name -> value`` shape the engine's stats-v8 view is built from.

Metric naming follows Prometheus conventions: ``snake_case`` with a unit
suffix (``_total`` for counters, ``_seconds``/``_ms`` on histograms), and
optional labels frozen at creation time (``{"site": "attn_q#0"}``).
"""
from __future__ import annotations

import math
import re
from bisect import bisect_left
from collections import deque
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# default histogram bounds: latency-flavoured seconds, ~geometric
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# bounded reservoir for exact quantiles; smoke/bench runs stay well under
# this, so windowed percentiles equal exact percentiles there
DEFAULT_WINDOW = 4096


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonically increasing float counter."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_v")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self._v += n

    def set_(self, v: float) -> None:
        """Internal: legacy attribute-facade support (``eng.steps = 0`` in
        ``__init__``, ``eng.steps += 1`` via property get+set). Must never
        move the counter backwards except to zero (re-init)."""
        if v != 0.0 and v < self._v:
            raise ValueError(f"counter {self.name}: set_ would decrease")
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def expose(self) -> Iterable[Tuple[str, str, float]]:
        yield self.name, _fmt_labels(self.labels), self._v

    def state(self) -> dict:
        return {"type": self.kind, "value": self._v}


class Gauge:
    """Point-in-time value (can go up or down)."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_v")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._v += n

    @property
    def value(self) -> float:
        return self._v

    def expose(self) -> Iterable[Tuple[str, str, float]]:
        yield self.name, _fmt_labels(self.labels), self._v

    def state(self) -> dict:
        return {"type": self.kind, "value": self._v}


class Histogram:
    """Cumulative-bucket histogram plus a bounded quantile reservoir.

    Prometheus exposition uses the fixed cumulative buckets (``_bucket``
    series with ``le`` labels, ``_sum``, ``_count``); :meth:`percentile`
    answers from the rolling reservoir of the last ``window`` observations
    (nearest-rank, matching ``runtime.health.StepTimer``). Runs shorter
    than the window get *exact* percentiles.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "buckets", "_counts", "_window",
                 "count", "sum")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 window: int = DEFAULT_WINDOW):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1: +Inf
        self._window = deque(maxlen=window)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self._counts[bisect_left(self.buckets, v)] += 1
        self._window.append(v)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the rolling window (0 when empty)."""
        if not self._window:
            return 0.0
        xs = sorted(self._window)
        idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
        return xs[idx]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def expose(self) -> Iterable[Tuple[str, str, float]]:
        cum = 0
        for bound, n in zip(self.buckets, self._counts):
            cum += n
            lab = dict(self.labels, le=_fmt_value(bound))
            yield f"{self.name}_bucket", _fmt_labels(lab), float(cum)
        lab = dict(self.labels, le="+Inf")
        yield f"{self.name}_bucket", _fmt_labels(lab), float(self.count)
        yield f"{self.name}_sum", _fmt_labels(self.labels), self.sum
        yield f"{self.name}_count", _fmt_labels(self.labels), float(self.count)

    def state(self) -> dict:
        return {
            "type": self.kind, "count": self.count, "sum": self.sum,
            "p50": self.percentile(50), "p95": self.percentile(95),
            "buckets": dict(zip(map(_fmt_value, self.buckets), self._counts)),
        }


class MetricsRegistry:
    """Owns every instrument; get-or-create by (name, labels).

    Re-requesting an existing (name, labels) pair returns the same object;
    requesting it with a different metric *type* raises — one name, one
    type, as Prometheus requires.
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}

    def _get(self, cls, name: str, help: str,
             labels: Optional[Dict[str, str]], **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(name, help, labels, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}"
            )
        return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  window: int = DEFAULT_WINDOW) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         buckets=buckets, window=window)

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None) -> Optional[object]:
        return self._metrics.get(
            (name, tuple(sorted((labels or {}).items())))
        )

    def as_dict(self) -> Dict[str, float]:
        """Flat ``name{labels} -> value`` view (histograms: _count/_sum)."""
        out: Dict[str, float] = {}
        for m in self:
            for name, labs, v in m.expose():
                out[name + labs] = v
        return out

    def snapshot(self) -> dict:
        """JSON-safe nested snapshot — one JSONL line per call site."""
        out: Dict[str, dict] = {}
        for (name, labs), m in self._metrics.items():
            key = name + _fmt_labels(dict(labs))
            out[key] = m.state()
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one HELP/TYPE per name)."""
        lines = []
        seen_header = set()
        for (name, _), m in sorted(self._metrics.items()):
            if name not in seen_header:
                seen_header.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
            for series, labs, v in m.expose():
                lines.append(f"{series}{labs} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"
