"""Continuous-batching step scheduler: admission order + chunked-prefill
token budgeting (the port of ``repro.serving.scheduler``, pure
bookkeeping, with the reference's span-trace hooks).

Without a budget, a newly admitted request runs its whole prompt in one
prefill call while every live decode lane waits behind it. This module is
the policy half of budgeted prefill (``serving/engine.py`` owns the
mechanism): it decides *which* queued request is admitted next and *how
many* prefill tokens each mid-prefill lane may run in the current engine
step, under the per-step ``EngineConfig.prefill_budget``.

Design rules:

* **Budget** -- at most ``prefill_budget`` prefill tokens run per engine
  step, split into chunks of at most ``chunk_size`` tokens (config
  guarantees ``budget >= chunk_size``, so every step with prefill work
  makes progress). Decode tokens are never counted against the budget --
  the budget exists to protect them.
* **Policy** -- ``fifo`` admits and drains prefills in submit order;
  ``sjf`` (shortest job first) orders by remaining prefill length, which
  minimizes mean TTFT under load but can starve long prompts -- hence the
  **aging bound**: a request queued longer than ``aging_steps`` engine
  steps is ordered ahead of policy order (FIFO among aged peers), so no
  request waits more than ``O(aging_steps)`` behind shorter late arrivals.
* **Resumes first** -- preempted requests (requeued at the head by the
  engine) outrank everything: they already hold committed work whose pages
  sit in the prefix cache.

The engine feeds it plain ``(slot, remaining, seq)`` tuples and applies
the returned plan, so the invariants are property-testable without an
engine (``tests/test_torch_scheduler.py``).
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

__all__ = ["StepScheduler"]


class StepScheduler:
    """Queue ordering + per-step chunk planning for one engine.

    Counters (surfaced as ``sched_*`` in stats schema v7):

    * ``chunks`` — prefill chunk calls planned;
    * ``budget_limited_steps`` — steps where prefill work remained but the
      budget was exhausted (the knob is actually binding);
    * ``aging_promotions`` — requests promoted past sjf order by the aging
      bound (starvation that *would* have happened);
    * ``peak_step_tokens`` — max prefill tokens planned in any single step
      (tests assert ``<= prefill_budget``).
    """

    def __init__(
        self,
        policy: str = "fifo",
        aging_steps: int = 64,
        prefill_budget: int = 0,
        chunk_size: int = 64,
    ):
        if policy not in ("fifo", "sjf"):
            raise ValueError(f"policy must be fifo|sjf, got {policy!r}")
        self.policy = policy
        self.aging_steps = aging_steps
        self.prefill_budget = prefill_budget
        self.chunk_size = chunk_size
        self.chunks = 0
        self.budget_limited_steps = 0
        self.aging_promotions = 0
        self.peak_step_tokens = 0
        self._first_seen: dict = {}  # uid -> engine step first observed queued
        self._promoted: set = set()  # uids already counted as aging promotions
        # Optional TraceRing attached by the engine: the budget-limited and
        # aging-promotion instants.
        self.trace = None

    # -- admission ordering -------------------------------------------------

    def order_queue(
        self, queue: Sequence, step: int, is_resume: Callable[[object], bool]
    ) -> List:
        """Admission order for ``queue`` (requests with ``.uid``/``.prompt``)
        at engine ``step``. Resumes first, then aged requests (FIFO among
        themselves), then policy order; arrival index breaks every tie, so
        ``fifo`` reproduces the pre-scheduler admission order exactly."""
        live = {r.uid for r in queue}
        self._first_seen = {u: s for u, s in self._first_seen.items() if u in live}
        self._promoted &= live
        for r in queue:
            self._first_seen.setdefault(r.uid, step)

        def aged(r) -> bool:
            return step - self._first_seen[r.uid] >= self.aging_steps

        if self.policy == "sjf":
            for i, r in enumerate(queue):
                # A promotion is only a promotion if aging moved the request
                # ahead of a strictly shorter, younger competitor.
                if aged(r) and r.uid not in self._promoted and any(
                    not aged(o) and len(o.prompt) < len(r.prompt)
                    for o in queue
                ):
                    self._promoted.add(r.uid)
                    self.aging_promotions += 1
                    if self.trace is not None:
                        self.trace.emit(
                            "sched_promote", track=r.uid, step=step,
                            waited=step - self._first_seen[r.uid],
                        )

        def key(i: int):
            r = queue[i]
            head = is_resume(r) or aged(r)
            length = 0 if head or self.policy == "fifo" else len(r.prompt)
            return (not is_resume(r), not aged(r), length, i)

        return [queue[i] for i in sorted(range(len(queue)), key=key)]

    # -- chunk planning -----------------------------------------------------

    def plan_chunks(
        self, lanes: Sequence[Tuple[int, int, int]]
    ) -> List[Tuple[int, int]]:
        """Plan this step's prefill chunks.

        ``lanes`` holds ``(slot, remaining_prefill_tokens, seq)`` for every
        mid-prefill lane (``seq`` = install order). Returns ``(slot, grant)``
        chunk grants, in execution order, consuming at most
        ``prefill_budget`` tokens; lanes drain head-first (the policy-first
        lane finishes its prefill soonest, minimizing its TTFT) rather than
        round-robin."""
        if self.policy == "sjf":
            order = sorted(lanes, key=lambda t: (t[1], t[2]))
        else:
            order = sorted(lanes, key=lambda t: t[2])
        plan: List[Tuple[int, int]] = []
        left = self.prefill_budget
        limited = False
        for slot, remaining, _ in order:
            while remaining > 0:
                grant = min(self.chunk_size, remaining)
                if grant > left:
                    limited = True
                    break
                plan.append((slot, grant))
                left -= grant
                remaining -= grant
            if limited:
                break
        if limited:
            self.budget_limited_steps += 1
            if self.trace is not None:
                self.trace.emit(
                    "sched_budget_limited",
                    budget=self.prefill_budget,
                    planned=self.prefill_budget - left,
                )
        self.chunks += len(plan)
        used = self.prefill_budget - left
        if used > self.peak_step_tokens:
            self.peak_step_tokens = used
        return plan

    # -- bookkeeping --------------------------------------------------------

    def note_admitted(self, uid) -> None:
        """Forget queue-aging state for an admitted (or dropped) request."""
        self._first_seen.pop(uid, None)
        self._promoted.discard(uid)
