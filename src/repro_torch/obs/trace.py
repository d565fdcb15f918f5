"""Structured step/request tracing: typed span events in a bounded ring
(the port of ``repro.obs.trace``, line for line: pure Python).

The engine emits :class:`SpanEvent` records (host-side, ``perf_counter``
timestamps) into a :class:`TraceRing` — a ``deque(maxlen=capacity)`` so
memory is bounded no matter how long the engine runs; once full, the
oldest events fall off and ``dropped`` counts them.

Event vocabulary (``kind``):

========================  ====  =======================================
kind                      ph    emitted on
========================  ====  =======================================
``step``                  X     every engine step (engine lane)
``decode_step``           X     batched decode dispatch (engine lane)
``prefill``               X     monolithic prefill install (request)
``prefill_chunk``         X     one scheduler chunk grant (request)
``spec_draft``            X     speculative draft dispatch (engine lane)
``spec_verify``           X     speculative verify dispatch (engine lane)
``admit``                 i     request admitted into a lane
``first_token``           i     request's first token booked
``retire``                i     request finished (args: finish_reason)
``preempt``               i     lane preempted for page pressure
``resume``                i     preempted request re-admitted
``shed``                  i     request shed (admission or deadline)
``quarantine``            i     lane quarantined on nonfinite fault
``kernel_fallback``       i     fused kernel demoted to reference
                                (never emitted by the port, which
                                has no fallback)
``prefix_hit``            i     prefix-cache pages reused on install
``prefix_miss``           i     prefix-cache lookup found nothing
``sched_budget_limited``  i     step scheduler hit the token budget
``sched_promote``         i     aged request promoted to queue head
``place``                 i     router placed a request on a replica
``retry``                 i     router queued a backoff retry
``migrate``               i     in-flight request moved between replicas
``drain``                 i     replica breaker opened (degraded/drain)
``replica_dead``          i     replica declared dead
========================  ====  =======================================

The ``place`` .. ``replica_dead`` rows are emitted by the replica router
(:mod:`repro_torch.serving.router`) into its *own* ring — request instants on
the request's track, replica lifecycle instants on the engine lane.

``ph`` follows the Chrome trace-event format: ``X`` = complete span with a
duration, ``i`` = instant. :meth:`TraceRing.chrome_trace` renders the ring
as a Perfetto-loadable ``{"traceEvents": [...]}`` document with one track
(pid/tid pair) per request plus an engine lane; :meth:`TraceRing.
trace_request` gives a single request's timeline.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["SpanEvent", "TraceRing", "ENGINE_TRACK", "validate_chrome_trace"]

# track id for engine-wide (non-request) events; request tracks use the
# request uid (a non-negative int)
ENGINE_TRACK = -1

_PID = 1  # single engine process


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One typed trace event. ``ts`` is ``time.perf_counter()`` seconds;
    ``dur`` is 0.0 for instants. ``track`` is a request uid or
    ``ENGINE_TRACK``."""

    kind: str
    ph: str           # "X" complete span | "i" instant
    ts: float
    dur: float
    track: object     # request uid (any hashable) or ENGINE_TRACK
    step: int
    args: Dict[str, object]


class TraceRing:
    """Bounded ring buffer of :class:`SpanEvent`.

    ``emit`` is the only hot-path entry point: build a dataclass, append to
    a bounded deque. Everything else (export, per-request filtering) is
    offline.
    """

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self.emitted = 0  # total ever emitted (dropped = emitted - len)

    # -- emission -----------------------------------------------------------

    def emit(self, kind: str, *, track=ENGINE_TRACK, ts: float = 0.0,
             dur: float = 0.0, step: int = 0, **args) -> None:
        """Record one event. ``ts=0.0`` means "now"; pass an explicit
        ``perf_counter`` start for spans measured by the caller."""
        if ts == 0.0:
            ts = time.perf_counter()
        ph = "X" if dur > 0.0 else "i"
        self.emitted += 1
        self._ring.append(SpanEvent(kind, ph, ts, dur, track, step, args))

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._ring)

    def events(self) -> List[SpanEvent]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Render as a Chrome trace-event JSON document (Perfetto-loadable).

        Tracks: the engine lane is tid 0; each request uid gets the next
        tid in first-event order (uids need not be ints), named via
        thread_name metadata events. Timestamps are microseconds relative
        to the earliest event in the ring.
        """
        evs = sorted(self._ring, key=lambda e: (e.ts, -e.dur))
        t0 = evs[0].ts if evs else 0.0
        out = []
        tids: Dict[object, int] = {ENGINE_TRACK: 0}
        for e in evs:
            tid = tids.setdefault(e.track, len(tids))
            rec = {
                "name": e.kind,
                "ph": e.ph,
                "ts": (e.ts - t0) * 1e6,
                "pid": _PID,
                "tid": tid,
                "args": dict(e.args, step=e.step),
            }
            if e.ph == "X":
                rec["dur"] = e.dur * 1e6
            else:
                rec["s"] = "t"  # thread-scoped instant
            out.append(rec)
        meta = [{
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": "serving-engine"},
        }]
        for track, tid in sorted(tids.items(), key=lambda p: p[1]):
            if tid == 0 and not any(
                e.track == ENGINE_TRACK for e in evs
            ):
                continue  # engine lane reserved but unused
            name = "engine" if track == ENGINE_TRACK else f"req {track}"
            meta.append({
                "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                "args": {"name": name},
            })
        return {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=str)

    def trace_request(self, uid: int) -> List[dict]:
        """Chronological timeline for one request: list of
        ``{kind, t_s, dur_s, step, args}`` with ``t_s`` relative to the
        earliest event *in the ring* (same base as :meth:`chrome_trace`)."""
        evs = sorted(self._ring, key=lambda e: (e.ts, -e.dur))
        t0 = evs[0].ts if evs else 0.0
        return [
            {"kind": e.kind, "t_s": e.ts - t0, "dur_s": e.dur,
             "step": e.step, "args": dict(e.args)}
            for e in evs if e.track == uid
        ]

    def summary(self) -> Dict[str, int]:
        """Event counts by kind (diagnostic)."""
        out: Dict[str, int] = {}
        for e in self._ring:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out


def validate_chrome_trace(doc: dict) -> Optional[str]:
    """Structural check of an exported trace document; returns an error
    string or None. Used by tests and the CI artifact-validation step."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return "missing traceEvents"
    for i, e in enumerate(doc["traceEvents"]):
        for k in ("name", "ph", "pid", "tid"):
            if k not in e:
                return f"event {i}: missing {k!r}"
        if e["ph"] == "X":
            if "dur" not in e or e["dur"] < 0:
                return f"event {i}: X event without valid dur"
        if e["ph"] != "M" and "ts" not in e:
            return f"event {i}: missing ts"
    return None
