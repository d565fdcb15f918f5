"""Step-time watchdog and file-based liveness (the port of
``repro.runtime.health``, pure Python; the reference's code, unchanged).

* :class:`StepTimer` -- rolling per-step wall time: nearest-rank
  percentiles over a window, and a straggler flag when ``patience``
  consecutive steps exceed ``factor x`` the rolling median. The serving
  engine times every ``step()`` with it (``step_p50_ms`` / ``step_p95_ms``
  / ``step_stalled``), and its median sizes
  ``EngineOverloaded.retry_after_hint_s``.
* :class:`HeartbeatMonitor` -- a heartbeat file replaced atomically after
  every beat (throttled by ``min_interval``); an external watchdog reads it
  and calls a writer stale once its last beat is older than ``timeout``.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = ["StepTimer", "HeartbeatMonitor"]


class StepTimer:
    """Rolling per-step timing with straggler flagging."""

    def __init__(self, window: int = 50, factor: float = 1.5, patience: int = 3):
        self.window: Deque[float] = deque(maxlen=window)
        self.factor = factor
        self.patience = patience
        self._over = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        med = self.median()
        if med > 0 and dt > self.factor * med:
            self._over += 1
        else:
            self._over = 0
        self.window.append(dt)
        return dt

    def median(self) -> float:
        if not self.window:
            return 0.0
        s = sorted(self.window)
        return s[len(s) // 2]

    def percentile(self, q: float) -> float:
        """q-th percentile (0-100) of the rolling window, 0.0 when empty.

        Nearest-rank over the sorted window — the serving watchdog surfaces
        p50/p95 step times through ``ServingEngine.stats()``."""
        if not self.window:
            return 0.0
        s = sorted(self.window)
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[idx]

    @property
    def is_straggling(self) -> bool:
        return self._over >= self.patience


class HeartbeatMonitor:
    """File-based liveness: writer side (train loop) + watchdog side.

    ``min_interval`` throttles the writer: a serving engine beating every
    step can run thousands of steps per second, and an atomic tmp-write +
    ``os.replace`` per step is pure filesystem churn a liveness watchdog
    (polling at seconds granularity) can never observe. Beats landing
    within ``min_interval`` seconds of the last *written* beat are skipped;
    ``force=True`` bypasses the throttle (the final beat of a drain, so the
    file always ends at the true last step). The default ``0.0`` keeps the
    legacy write-every-beat behavior.
    """

    def __init__(self, path: str, host_id: int = 0, timeout: float = 300.0,
                 min_interval: float = 0.0):
        self.path = path
        self.host_id = host_id
        self.timeout = timeout
        self.min_interval = min_interval
        self.beats = 0  # beat() calls
        self.writes = 0  # beats that reached the file
        self._last_write = 0.0  # time.time() of the last write; 0 = never
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, extra: Optional[Dict] = None,
             force: bool = False):
        self.beats += 1
        now = time.time()
        if (not force and self.min_interval > 0.0
                and now - self._last_write < self.min_interval):
            return
        rec = {
            "host": self.host_id,
            "step": int(step),
            "time": now,
            **(extra or {}),
        }
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)
        self.writes += 1
        self._last_write = now

    def read(self) -> Optional[Dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def stale(self, timeout: Optional[float] = None) -> bool:
        """Is this monitor's own heartbeat file stale (older than
        ``timeout`` seconds, default the monitor's ``timeout``)?

        The single-file form of :meth:`stale_hosts`, used by the serving
        replica router's liveness gate: an unreadable file only counts as
        stale after the first write landed (a replica that has not beaten
        yet is *cold*, not dead)."""
        limit = self.timeout if timeout is None else timeout
        rec = self.read()
        if rec is None:
            return self.writes > 0
        return time.time() - rec.get("time", 0.0) > limit

    def stale_hosts(self, paths: List[str]) -> List[int]:
        """Watchdog: which heartbeat files have gone stale?"""
        now = time.time()
        out = []
        for p in paths:
            try:
                with open(p) as f:
                    rec = json.load(f)
                if now - rec["time"] > self.timeout:
                    out.append(int(rec["host"]))
            except (FileNotFoundError, json.JSONDecodeError, KeyError):
                out.append(-1)  # unreadable = presumed dead
        return out
