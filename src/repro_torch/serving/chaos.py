"""Deterministic chaos harness for the replica router (the port of
``repro.serving.chaos``).

Fault injection that is *scripted*, not random: a :class:`FaultPlan` is a
frozen list of fault records, each pinned to a router step, and
:class:`ChaosHarness` applies exactly the due records at the top of each
step before driving :meth:`Router.step`. Two runs of the same plan over
the same requests execute the identical failure sequence — which is what
lets tests and ``chip_smoke.py`` assert *bit-exact* outputs
under crashes instead of merely "it didn't hang".

Fault vocabulary:

* :class:`KillReplica` — declare a replica dead at step k (the
  crash-and-migrate headline: every in-flight request must complete
  elsewhere, token-identical to the uncontended oracle);
* :class:`DrainReplica` — operator drain at step k (queued requests
  migrate, active lanes finish in place);
* :class:`InjectNaN` — arm the engine's fault hook on one replica: the
  step producing output index ``at_output_index`` of request ``uid`` goes
  nonfinite through the production finite check (quarantine, fault
  streak — the health gate's food);
* :class:`StallSteps` — wrap the replica's ``step`` to sleep ``seconds``
  for the next ``steps`` calls: the router-side watchdog must see the
  straggle and degrade the replica (and heal it once the stall passes);
* :class:`PagePressure` — allocate ``pages`` pages directly from the
  replica's pool for ``hold_steps`` router steps, forcing the engine's
  preemption path under the router.

Faults are applied best-effort: killing an already-dead replica or
stalling one that died first is a no-op, so composed plans stay valid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

from .router import Router

__all__ = [
    "KillReplica",
    "DrainReplica",
    "InjectNaN",
    "StallSteps",
    "PagePressure",
    "FaultPlan",
    "ChaosHarness",
]


@dataclasses.dataclass(frozen=True)
class KillReplica:
    step: int
    replica: int


@dataclasses.dataclass(frozen=True)
class DrainReplica:
    step: int
    replica: int


@dataclasses.dataclass(frozen=True)
class InjectNaN:
    step: int
    replica: int
    uid: int
    at_output_index: int = 1


@dataclasses.dataclass(frozen=True)
class StallSteps:
    step: int
    replica: int
    steps: int = 3
    seconds: float = 0.05


@dataclasses.dataclass(frozen=True)
class PagePressure:
    step: int
    replica: int
    pages: int = 2
    hold_steps: int = 4


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable failure script: fault records pinned to router steps
    (step 0 fires before the first ``Router.step`` call)."""

    faults: Tuple = ()

    def __post_init__(self):
        for f in self.faults:
            if not isinstance(f, (KillReplica, DrainReplica, InjectNaN,
                                  StallSteps, PagePressure)):
                raise TypeError(f"unknown fault record: {f!r}")
            if f.step < 0:
                raise ValueError(f"fault step must be >= 0: {f!r}")

    def at(self, step: int) -> List:
        return [f for f in self.faults if f.step == step]

    @property
    def last_step(self) -> int:
        return max((f.step for f in self.faults), default=-1)


class ChaosHarness:
    """Drives a :class:`Router` through a :class:`FaultPlan`.

    ``step()`` applies the records due at the current harness step (its
    own counter — deterministic regardless of what the router did), then
    advances the router one step. ``run()`` loops until the router drains
    AND the plan is exhausted, releasing any held page pressure at the
    end so the allocator invariant holds on every replica."""

    def __init__(self, router: Router, plan: FaultPlan):
        self.router = router
        self.plan = plan
        self.tick = 0
        # rid -> list of (release_at_tick, allocator, page_ids)
        self._held: List[Tuple[int, object, List[int]]] = []
        self._stalls: Dict[int, Dict] = {}  # rid -> {"left": n}

    # ------------------------------------------------------- fault actions

    def _apply(self, fault) -> None:
        rep = self.router.replicas[fault.replica]
        if isinstance(fault, KillReplica):
            self.router.kill(fault.replica)
        elif isinstance(fault, DrainReplica):
            self.router.drain(fault.replica)
        elif isinstance(fault, InjectNaN):
            rep.engine.inject_fault(fault.uid, fault.at_output_index)
        elif isinstance(fault, StallSteps):
            self._install_stall(rep, fault)
        elif isinstance(fault, PagePressure):
            alloc = rep.engine.allocator
            take = min(fault.pages, alloc.available())
            if take > 0:
                self._held.append(
                    (self.tick + fault.hold_steps, alloc, alloc.alloc(take))
                )

    def _install_stall(self, rep, fault: StallSteps) -> None:
        """Shadow the engine's bound ``step`` with a sleeping wrapper for
        the next ``fault.steps`` calls. The sleep lands *inside* the
        router's per-replica timed window (the router calls
        ``rep.engine.step()``), so the watchdog observes it exactly like a
        genuinely slow replica."""
        state = self._stalls.setdefault(
            rep.rid, {"left": 0, "orig": rep.engine.step}
        )
        state["left"] += fault.steps
        orig = state["orig"]
        eng = rep.engine

        def stalled_step():
            if state["left"] > 0:
                state["left"] -= 1
                time.sleep(fault.seconds)
                if state["left"] == 0:
                    del eng.step  # restore the bound method
            return orig()

        eng.step = stalled_step

    def _release_due(self) -> None:
        still = []
        for release_at, alloc, ids in self._held:
            if self.tick >= release_at:
                alloc.release(ids)
            else:
                still.append((release_at, alloc, ids))
        self._held = still

    def release_all(self) -> None:
        """Drop every held page (end-of-run cleanup)."""
        for _, alloc, ids in self._held:
            alloc.release(ids)
        self._held = []

    # -------------------------------------------------------------- drive

    def step(self) -> bool:
        for fault in self.plan.at(self.tick):
            self._apply(fault)
        self._release_due()
        self.tick += 1
        return self.router.step()

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            busy = self.step()
            if not busy and self.tick > self.plan.last_step:
                break
        self.release_all()
