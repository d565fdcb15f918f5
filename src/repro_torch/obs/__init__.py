"""Serving observability: tracing, metrics, and quant-drift telemetry (the
port of ``repro.obs``).

Three host-side subsystems, all off-by-default-cheap and bounded-memory:

* :mod:`repro_torch.obs.trace`   — typed span events in a bounded ring buffer,
  exported as Chrome trace-event JSON (loadable in Perfetto / chrome://tracing)
  plus a per-request timeline (``trace_request``).
* :mod:`repro_torch.obs.metrics` — Counter/Gauge/Histogram primitives with a
  central registry, Prometheus text exposition, and JSONL snapshots. The
  engine's stats dict view is derived from this registry.
* :mod:`repro_torch.obs.drift`   — sampled quantization-drift monitor: per-site
  activation saturation rate vs the calibrated clip/OCS grid (paper §5:
  quantization quality depends on the outlier profile seen at calibration).
* :mod:`repro_torch.obs.log`     — per-component ``logging`` loggers for the
  launchers (machine-readable stdout stays on ``print``).

Spans time host wall around work that already synchronises with the card;
nothing here adds a device synchronisation.
"""
from .log import get_logger, setup_logging
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import SpanEvent, TraceRing

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanEvent",
    "TraceRing",
    "get_logger",
    "setup_logging",
]
