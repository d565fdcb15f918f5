"""Fault-tolerant replica router: N data-parallel :class:`ServingEngine`
replicas behind one load-aware, health-gated front end (the port of
``repro.serving.router``).

A :class:`ReplicaSet` of independent engines (same model, one shared
quantized tree on the device, separate KV pools) and a :class:`Router`
that owns placement, liveness, and recovery:

* **load-aware placement** — ``least_loaded`` scores every healthy
  replica by outstanding decode/prefill tokens + queue depth + pages in
  use (weights on :class:`RouterConfig`) and picks the minimum;
  ``round_robin`` rotates. Draining and dead replicas take no placements.
* **health gating** — a 3-state circuit breaker per replica
  (``healthy -> draining -> dead``) driven by the engine's fault machinery
  (consecutive-quarantine streak + recent kernel fallbacks; the port's
  engines have no fallback, so that term reads 0 and is kept so the
  breaker reads as the reference's), a router-side
  :class:`repro_torch.runtime.health.StepTimer` around each replica's steps
  (a straggling replica degrades to draining and heals when it stops
  straggling), and :class:`HeartbeatMonitor` staleness for replicas
  with a heartbeat file. Draining replicas finish their active lanes
  but their *queued* requests migrate away immediately.
* **crash-and-migrate** — a dead (or :meth:`Router.kill`-ed) replica's
  in-flight requests are harvested — committed tokens intact — and
  resubmitted to healthy replicas. The target engine re-installs them
  through its ``_resume_paged`` recompute path (prompt re-prefill +
  committed-output replay through the decode path), so the continuation
  decodes over a bit-identical cache: greedy output equals the
  uncontended single-engine oracle token for token, and seeded sampling
  is reproducible because a draw depends on ``(seed, position)`` only —
  *where* a token is produced cannot change *which* token it is.
  Migration needs the replay path, hence **paged replicas only**, as in
  the reference: an unpaged engine (``EngineConfig(paged=False)``, or an
  SSM or hybrid model) is refused.
* **precision-tier affinity** — replicas carry a tier identity
  ``(kv_bits, matmul_mode)``. A request with committed tokens resumes
  on its source tier ONLY: replaying an int8-cache prefix through an
  int4 pool (or a w8a8 trace through w4a8 weights) would decode the
  continuation over different numerics than produced the committed
  tokens, silently breaking the bit-identical-resume contract above.
  Cross-tier migration is therefore **rejected** — when no same-tier
  replica is left alive the request goes terminal with finish reason
  ``"tier_mismatch"`` rather than resuming wrong. Requests with no
  committed output (queued, never prefilled) carry no tier constraint.
* **retry / timeout / backoff** — ``EngineOverloaded`` sheds retry with
  capped exponential backoff plus deterministic jitter, informed by the
  exception's ``retry_after_hint_s``; ``Request.deadline_s`` is enforced
  **end to end**: the router rebases the engine-visible deadline to the
  remaining budget on every resubmission, so hops never reset the clock.

The deterministic chaos harness driving scripted failures through this
surface lives in :mod:`repro_torch.serving.chaos`. The router is host-side
bookkeeping; the replicas' engines run on the card unless built with
``device="cpu"`` (:meth:`ReplicaSet.build` takes the device).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.apply import map_with_path, tree_to
from ..core.ocs import OCSQuantLinear, to_w4a8
from ..device import resolve_device
from ..obs.metrics import MetricsRegistry
from ..obs.trace import TraceRing
from ..runtime.health import StepTimer

from .config import EngineConfig, SamplingParams
from .engine import (
    _SENTINEL_REASONS,
    EngineOverloaded,
    Request,
    ServingEngine,
    TokenEvent,
    _Slot,
)

__all__ = [
    "HEALTHY",
    "DRAINING",
    "DEAD",
    "Replica",
    "ReplicaSet",
    "Router",
    "RouterConfig",
]

# Circuit-breaker states. ``draining`` covers both the degraded breaker
# (heals itself) and an explicit drain() (pinned until undrained/killed).
HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"

_HEALTH_VALUE = {HEALTHY: 1.0, DRAINING: 0.5, DEAD: 0.0}

# Router-terminal reasons that must emit a synthetic finished=True event
# from stream(): the engine's sentinels plus the router's own cross-tier
# migration rejection (engines never produce "tier_mismatch").
_ROUTER_SENTINELS = tuple(_SENTINEL_REASONS) + ("tier_mismatch",)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Every router-level knob, validated and hashable (the engine-level
    knobs stay on :class:`EngineConfig` — one config object per layer)."""

    placement: str = "least_loaded"  # least_loaded | round_robin
    # Retry/backoff for EngineOverloaded sheds: delay(attempt) =
    # min(cap, max(base * 2^attempt, retry_after_hint)) * (1 +- jitter),
    # jitter deterministic in (uid, attempt). A request past max_retries
    # placement attempts is terminally shed by the router.
    max_retries: int = 3
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 1.0
    backoff_jitter: float = 0.25  # fraction of the delay, symmetric
    # Circuit breaker: fault score = engine consecutive-quarantine streak
    # + recent kernel-fallback strikes (always 0 on the port's engines). degraded_after trips healthy
    # -> draining (heals when the score drops back below); dead_after is
    # terminal. A straggling router-side StepTimer also degrades.
    degraded_after: int = 2
    dead_after: int = 4
    # A kernel-fallback strike is forgiven after this many fallback-free
    # engine steps (one strike per window), so the breaker scores *recent*
    # fallbacks — a lifetime total would walk every long-running replica
    # toward dead no matter how healthy it is now.
    fallback_forget_steps: int = 200
    straggle_factor: float = 4.0  # router StepTimer straggler threshold
    straggle_patience: int = 3
    heartbeat_timeout_s: float = 60.0  # staleness bound for replicas with
    # a heartbeat file (multi-process deployments; in-process loops beat
    # every step and never trip it)
    trace: bool = False  # router-level span ring (place/retry/drain/
    trace_capacity: int = 4096  # migrate/replica_dead instants)

    def __post_init__(self):
        if self.placement not in ("least_loaded", "round_robin"):
            raise ValueError(
                "placement must be least_loaded|round_robin, got "
                f"{self.placement!r}"
            )
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s < 0 or self.backoff_cap_s < self.backoff_base_s:
            raise ValueError(
                "need 0 <= backoff_base_s <= backoff_cap_s, got "
                f"{self.backoff_base_s}/{self.backoff_cap_s}"
            )
        if not 0.0 <= self.backoff_jitter < 1.0:
            raise ValueError(
                f"backoff_jitter must be in [0, 1), got {self.backoff_jitter}"
            )
        if not 1 <= self.degraded_after <= self.dead_after:
            raise ValueError(
                "need 1 <= degraded_after <= dead_after, got "
                f"{self.degraded_after}/{self.dead_after}"
            )
        if self.fallback_forget_steps < 1:
            raise ValueError(
                "fallback_forget_steps must be >= 1, got "
                f"{self.fallback_forget_steps}"
            )
        if self.straggle_factor <= 1.0:
            raise ValueError(
                f"straggle_factor must be > 1, got {self.straggle_factor}"
            )
        if self.heartbeat_timeout_s <= 0:
            raise ValueError(
                "heartbeat_timeout_s must be > 0, got "
                f"{self.heartbeat_timeout_s}"
            )

    def replace(self, **kw) -> "RouterConfig":
        return dataclasses.replace(self, **kw)


class Replica:
    """One engine plus its router-side health state."""

    def __init__(self, rid: int, engine: ServingEngine,
                 config: RouterConfig):
        if not engine.paged:
            raise ValueError(
                "router replicas must be paged engines (dense/moe archs): "
                "cross-replica migration resumes through the paged replay "
                f"path; replica {rid} is unpaged"
            )
        self.rid = rid
        self.engine = engine
        # Precision-tier identity: committed tokens only resume on a
        # replica whose KV storage and matmul numerics match the engine
        # that produced them (kv_bits 0 = float pool).
        self.tier = (int(engine.kv_bits or 0), str(engine.matmul_mode))
        self.state = HEALTHY
        self.pinned = False  # explicit drain(): never self-heals
        # Router-side watchdog around THIS replica's steps — independent of
        # the engine's own timer so a chaos stall wrapped around
        # engine.step is still observed by the router.
        self.step_timer = StepTimer(
            window=50, factor=config.straggle_factor,
            patience=config.straggle_patience,
        )
        # Windowed kernel-fallback strikes (engine.kernel_fallbacks is a
        # lifetime counter; the breaker must score recent behaviour only).
        self.fallback_forget_steps = config.fallback_forget_steps
        self._fallback_strikes = 0
        self._fallbacks_seen = 0  # engine.kernel_fallbacks accounted so far
        self._clean_since_step = 0  # engine.steps at the last new fallback

    def fault_score(self) -> int:
        """The circuit-breaker input: the engine's consecutive-quarantine
        streak plus one strike per *recent* kernel fallback (a fallback
        consumed a quarantine streak of 3 to fire, so it earns suspicion —
        but suspicion expires: each strike is forgiven after
        ``fallback_forget_steps`` fallback-free engine steps, so a
        long-lived replica's lifetime total never creeps it toward dead).
        The port's engines dispatch by device with no fallback, so
        ``engine.kernel_fallbacks`` stays 0 and only the streak counts; the
        strike bookkeeping is kept so the breaker reads as the
        reference's. Idempotent per engine step — safe to call any number
        of times."""
        fb = self.engine.kernel_fallbacks
        steps = self.engine.steps
        if fb > self._fallbacks_seen:
            self._fallback_strikes += fb - self._fallbacks_seen
            self._fallbacks_seen = fb
            self._clean_since_step = steps
        elif self._fallback_strikes > 0:
            forgiven = (
                (steps - self._clean_since_step) // self.fallback_forget_steps
            )
            if forgiven > 0:
                self._fallback_strikes = max(
                    0, self._fallback_strikes - forgiven
                )
                self._clean_since_step += (
                    forgiven * self.fallback_forget_steps
                )
        return self.engine._fault_streak + self._fallback_strikes

    def active(self) -> int:
        return sum(1 for s in self.engine.slots if s.req is not None)

    def busy(self) -> bool:
        return self.active() > 0 or bool(self.engine.queue)


class ReplicaSet:
    """N independent engines serving the same quantized model.

    Each replica gets its own :class:`EngineConfig`-shaped state (KV pool,
    counters); the model config and parameter tree are shared (read-only:
    no serving path writes a weight). Build homogeneous sets with :meth:`build`, or
    pass pre-built engines (e.g. heterogeneous pools, mixed precision
    tiers) directly — the router keys migration on each replica's
    ``tier`` so mixed-tier sets stay correct (cross-tier resume is
    rejected, never silently degraded).
    """

    def __init__(self, engines: Sequence[ServingEngine],
                 config: Optional[RouterConfig] = None):
        if not engines:
            raise ValueError("ReplicaSet needs >= 1 engine")
        config = config or RouterConfig()
        self.replicas = [
            Replica(rid, eng, config) for rid, eng in enumerate(engines)
        ]

    @classmethod
    def build(cls, cfg, params, econfig: EngineConfig, n: int,
              config: Optional[RouterConfig] = None, *, device=None) -> "ReplicaSet":
        """``n`` engines over ONE copy of ``params`` on ``device`` (the card
        unless ``device="cpu"``): the tree is moved once, converted once to
        the W4A8 tier when ``econfig.matmul_mode`` asks for it, and every
        engine's own ``tree_to`` then shares its tensors (a tensor already
        on the device is not copied)."""
        if n < 1:
            raise ValueError(f"need >= 1 replica, got {n}")
        dev = resolve_device(device)
        shared = tree_to(params, dev)
        if econfig.matmul_mode == "w4a8":
            shared = map_with_path(
                lambda _p, leaf: (to_w4a8(leaf, econfig.w4a8_outlier_ratio)
                                  if isinstance(leaf, OCSQuantLinear) else leaf),
                shared)
        return cls(
            [ServingEngine(cfg, shared, econfig, device=dev) for _ in range(n)], config
        )

    def __len__(self) -> int:
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def __getitem__(self, rid: int) -> Replica:
        return self.replicas[rid]


def _jitter_unit(uid, attempt: int) -> float:
    """Deterministic pseudo-random in [-1, 1): a Weyl-ish integer hash of
    (uid, attempt) — stable across runs and processes (no PYTHONHASHSEED
    dependence: non-int uids hash by their repr bytes), so chaos
    scenarios replay bit-identically."""
    seed = uid if isinstance(uid, int) else sum(repr(uid).encode())
    h = (seed * 2654435761 + attempt * 40503) & 0xFFFFFFFF
    return (h % 10_000) / 5_000.0 - 1.0


@dataclasses.dataclass
class _Pending:
    """One request waiting for a (re)placement attempt."""

    req: Request
    attempt: int  # placement attempts already consumed
    not_before: float  # perf_counter gate for the next attempt
    tier: Optional[Tuple[int, str]] = None  # same-tier resume constraint
    # (set when the request carries committed tokens from a harvested
    # replica; None = any healthy replica may take it)


class Router:
    """The replicated serving front end. Single-threaded by design — the
    same cooperative step loop as :class:`ServingEngine`, one level up
    (the replicas step one after another in one process):
    ``step()`` runs retries, the health gate, and one step of every live
    replica; ``submit``/``generate``/``stream``/``run`` mirror the engine
    API so single-engine callers port by swapping the object."""

    def __init__(self, replicas: ReplicaSet,
                 config: Optional[RouterConfig] = None):
        self.config = config or RouterConfig()
        self.replicas = replicas
        for rep in self.replicas:
            # Rebuild timers if the set was constructed with another config
            # (straggle knobs live on the router's config).
            rep.step_timer.factor = self.config.straggle_factor
            rep.step_timer.patience = self.config.straggle_patience
            rep.fallback_forget_steps = self.config.fallback_forget_steps
        self._rr_next = 0  # round-robin cursor
        self._last_hint = 0.0  # retry_after_hint_s of the latest shed
        self._pending: Deque[_Pending] = deque()
        self._placed: Dict[object, int] = {}  # uid -> rid (live placements)
        # End-to-end deadline bookkeeping: uid -> (t0, original deadline).
        # Engines re-stamp t_submit on every submit, so without rebasing a
        # migrated/retried request would get a fresh clock per hop.
        self._budget: Dict[object, Tuple[float, float]] = {}
        self.done: List[Request] = []  # router-terminal (never reached an
        # engine): exhausted retries, expired while waiting
        self.steps = 0
        self._auto_uid = 0
        self.metrics = MetricsRegistry()
        self._c_placed = self.metrics.counter(
            "router_placed", "requests placed onto a replica"
        )
        self._c_retried = self.metrics.counter(
            "router_retried", "shed submissions retried with backoff"
        )
        self._c_migrated = self.metrics.counter(
            "router_migrated", "in-flight requests moved off a replica"
        )
        self._c_drained = self.metrics.counter(
            "router_drained", "healthy -> draining transitions"
        )
        self._c_dead = self.metrics.counter(
            "router_dead_replicas", "replicas declared dead"
        )
        self._c_shed = self.metrics.counter(
            "router_shed", "requests terminally shed by the router"
        )
        self._c_timed_out = self.metrics.counter(
            "router_timed_out", "requests expired at the router"
        )
        self._c_tier_rejected = self.metrics.counter(
            "router_tier_rejected",
            "cross-tier migrations rejected (source precision tier extinct)",
        )
        self._hist_migrate = self.metrics.histogram(
            "router_migrate_seconds",
            "harvest from the failed replica -> accepted resubmission",
        )
        self.trace: Optional[TraceRing] = (
            TraceRing(self.config.trace_capacity) if self.config.trace
            else None
        )

    # ----------------------------------------------------------- placement

    def _live(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == HEALTHY]

    def _tier_alive(self, tier: Tuple[int, str]) -> bool:
        """True while any non-dead replica of ``tier`` remains — a
        draining one may heal, so a tier-pinned request keeps waiting;
        once the tier is extinct the wait is hopeless and the request
        is rejected."""
        return any(
            r.state != DEAD and r.tier == tier for r in self.replicas
        )

    def _load(self, rep: Replica) -> float:
        """Placement score: outstanding tokens a replica still owes
        (decode budget of active lanes, unprefilled prompt, queued work)
        plus weighted queue depth and pages in use. Lower is emptier."""
        eng = rep.engine
        tok = 0
        for s in eng.slots:
            if s.req is None:
                continue
            tok += max(0, s.req.max_new_tokens - len(s.req.output))
            if s.prefilling:
                tok += len(s.req.prompt) - max(s.prefill_pos, 0)
        for r in eng.queue:
            tok += len(r.prompt) + r.max_new_tokens
        pages = eng.allocator.in_use() if eng.paged else 0
        return tok + 8.0 * len(eng.queue) + 1.0 * pages

    def _pick(
        self, tier: Optional[Tuple[int, str]] = None
    ) -> Optional[Replica]:
        live = self._live()
        if tier is not None:
            live = [r for r in live if r.tier == tier]
        if not live:
            return None
        if self.config.placement == "round_robin":
            n = len(self.replicas)
            for _ in range(n):
                rep = self.replicas[self._rr_next % n]
                self._rr_next += 1
                if rep.state == HEALTHY and (
                    tier is None or rep.tier == tier
                ):
                    return rep
            return None
        # least_loaded; ties break toward the lowest rid (deterministic)
        return min(live, key=lambda r: (self._load(r), r.rid))

    def _backoff(self, attempt: int, hint_s: float, uid) -> float:
        c = self.config
        delay = min(c.backoff_cap_s,
                    max(c.backoff_base_s * (2.0 ** attempt), hint_s))
        return max(0.0, delay * (1.0 + c.backoff_jitter
                                 * _jitter_unit(uid, attempt)))

    def _remaining(self, req: Request, now: float) -> Optional[float]:
        """Seconds of end-to-end deadline budget left (None = no deadline)."""
        if req.uid not in self._budget:
            return None
        t0, deadline = self._budget[req.uid]
        if deadline is None:
            return None
        return deadline - (now - t0)

    def _terminal(self, req: Request, reason: str, now: float) -> None:
        req.finish_reason = reason
        req.t_done = now
        self.done.append(req)
        self._budget.pop(req.uid, None)
        self._placed.pop(req.uid, None)
        if reason == "shed":
            self._c_shed.inc()
        elif reason == "timeout":
            self._c_timed_out.inc()
        elif reason == "tier_mismatch":
            self._c_tier_rejected.inc()
        if self.trace is not None:
            self.trace.emit("retire", track=req.uid, step=self.steps,
                            finish_reason=reason, where="router")

    def _try_place(self, req: Request, attempt: int,
                   tier: Optional[Tuple[int, str]] = None) -> bool:
        """One placement attempt. True if an engine accepted the request;
        False leaves it to the caller (retry or terminal-shed). A request
        whose end-to-end deadline already lapsed goes terminal here;
        ``tier`` pins the candidate set to one precision tier (committed
        tokens resume on matching numerics only)."""
        now = time.perf_counter()
        left = self._remaining(req, now)
        if left is not None and left <= 0.0:
            self._terminal(req, "timeout", now)
            return True  # handled (terminally)
        rep = self._pick(tier)
        if rep is None:
            return False
        # Invariant: a request the router is placing carries no terminal
        # markings (shed markings are cleared at shed time below; this is
        # the defensive backstop for harvested lanes).
        req.finish_reason = None
        req.t_done = 0.0
        if left is not None:
            req.deadline_s = left  # rebase: engines restamp t_submit
        try:
            rep.engine.submit(req)
        except EngineOverloaded as e:
            # The engine marked the request terminal ("shed", t_done) before
            # raising, but the router still owns it — a retry is coming.
            # Clear the markings or stream() sees t_done > 0 and yields a
            # false terminal shed sentinel while the retry is pending.
            req.finish_reason = None
            req.t_done = 0.0
            self._last_hint = e.retry_after_hint_s
            return False
        self._placed[req.uid] = rep.rid
        self._c_placed.inc()
        if self.trace is not None:
            self.trace.emit("place", track=req.uid, step=self.steps,
                            replica=rep.rid, attempt=attempt)
        return True

    def _enqueue_retry(self, req: Request, attempt: int, hint_s: float,
                       tier: Optional[Tuple[int, str]] = None) -> None:
        now = time.perf_counter()
        if attempt >= self.config.max_retries:
            self._terminal(req, "shed", now)
            return
        delay = self._backoff(attempt, hint_s, req.uid)
        left = self._remaining(req, now)
        if left is not None and left <= delay:
            # The backoff alone would blow the deadline: expire now rather
            # than sleep into a guaranteed timeout.
            self._terminal(req, "timeout", now)
            return
        self._pending.append(_Pending(req, attempt + 1, now + delay, tier))
        self._c_retried.inc()
        if self.trace is not None:
            self.trace.emit("retry", track=req.uid, step=self.steps,
                            attempt=attempt + 1, delay_s=delay)

    # ------------------------------------------------------------- public

    def submit(self, req: Request) -> None:
        """Place ``req`` on a healthy replica (or queue a backoff retry).

        Unlike :meth:`ServingEngine.submit` this never raises
        :class:`EngineOverloaded` — overload turns into bounded retries
        and, past ``max_retries``, a terminal ``"shed"``. With zero
        healthy replicas the request waits in the retry queue (replicas
        may heal) until retries run out."""
        if isinstance(req.uid, int):
            self._auto_uid = max(self._auto_uid, req.uid + 1)
        self._budget[req.uid] = (time.perf_counter(), req.deadline_s)
        self._last_hint = 0.0
        if self._try_place(req, 0):
            return
        self._enqueue_retry(req, 0, self._last_hint)

    def generate(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        *,
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        uid: Optional[object] = None,
        deadline_s: Optional[float] = None,
    ) -> Iterator[TokenEvent]:
        """The engine's streaming facade, router-wide: the iterator drives
        ``Router.step()``, so tokens stream from whichever replica holds
        the request — across migrations."""
        if uid is None:
            uid = self._auto_uid
        req = Request(
            uid=uid, prompt=list(prompt), max_new_tokens=max_new_tokens,
            eos_id=eos_id, sampling=sampling, deadline_s=deadline_s,
        )
        self.submit(req)
        return self.stream(req)

    def stream(self, req: Request) -> Iterator[TokenEvent]:
        """Yield ``req``'s tokens as they land, stepping the whole replica
        set as needed. Same sentinel contract as the engine: requests that
        end without booking a final token (shed / timeout / error) emit
        one synthetic ``finished=True`` event with their
        ``finish_reason``."""
        seen = 0
        sent_final = False
        while True:
            while seen < len(req.output):
                last = req.t_done > 0.0 and seen == len(req.output) - 1
                sent_final = sent_final or last
                yield TokenEvent(
                    uid=req.uid, token=req.output[seen], index=seen,
                    t=req.t_tokens[seen], finished=last,
                    finish_reason=req.finish_reason if last else None,
                )
                seen += 1
            if req.t_done > 0.0:
                if not sent_final and req.finish_reason in _ROUTER_SENTINELS:
                    yield TokenEvent(
                        uid=req.uid, token=-1, index=len(req.output),
                        t=req.t_done, finished=True,
                        finish_reason=req.finish_reason,
                    )
                return
            if not self.step() and req.t_done == 0.0 and not self._pending:
                return  # routerwide drain without finishing the request

    def drain(self, rid: int) -> None:
        """Explicitly drain a replica: no new placements, active lanes
        finish where they are, queued requests migrate immediately. Pinned
        — the health gate never heals an explicit drain (use
        :meth:`undrain`)."""
        rep = self.replicas[rid]
        if rep.state == DEAD:
            return
        rep.pinned = True
        self._to_draining(rep, why="drain")

    def undrain(self, rid: int) -> None:
        """Lift an explicit :meth:`drain` (dead replicas stay dead)."""
        rep = self.replicas[rid]
        rep.pinned = False
        if rep.state == DRAINING:
            rep.state = HEALTHY

    def kill(self, rid: int) -> None:
        """Declare a replica dead NOW (crash simulation / operator action):
        every in-flight request — queued or mid-decode, committed tokens
        intact — migrates to the healthy replicas."""
        self._to_dead(self.replicas[rid], why="kill")

    def step(self) -> bool:
        """One router iteration: flush due retries, step every live replica
        (dead ones are never stepped), then run the health gate over the
        fresh timer/fault evidence — faults surface the same step they
        happen, and a replica that just stopped straggling heals on the
        step that proves it. Returns True while any replica is busy or
        retries are pending."""
        self.steps += 1
        self._flush_retries()
        busy = False
        for rep in self.replicas:
            if rep.state == DEAD:
                continue
            rep.step_timer.start()
            try:
                produced = rep.engine.step()
            except Exception:
                # A crashing step is a dead replica, not a dead router:
                # harvest and migrate, keep serving.
                rep.step_timer.stop()
                self._to_dead(rep, why="step_raised")
                busy = True
                continue
            rep.step_timer.stop()
            busy = busy or produced or bool(rep.engine.queue)
        self._health_gate()
        # The gate may have migrated work onto live queues after ``busy``
        # was tallied — never report drained while a survivor holds work.
        busy = busy or any(
            r.state != DEAD and r.busy() for r in self.replicas
        )
        return busy or bool(self._pending)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until every replica drains and no retries remain. Returns
        the router-terminal requests (engine-terminal ones live on their
        replica's ``done`` list; callers usually hold the Request objects
        anyway)."""
        for _ in range(max_steps):
            if not self.step():
                break
        return self.done

    # ------------------------------------------------------------- health

    def _heartbeat_stale(self, rep: Replica) -> bool:
        hb = rep.engine._heartbeat
        if hb is None or rep.engine.steps == 0:
            return False
        return hb.stale(self.config.heartbeat_timeout_s)

    def _health_gate(self) -> None:
        c = self.config
        for rep in self.replicas:
            if rep.state == DEAD:
                continue
            score = rep.fault_score()
            if score >= c.dead_after:
                self._to_dead(rep, why="fault_streak")
                continue
            if self._heartbeat_stale(rep):
                self._to_dead(rep, why="heartbeat_stale")
                continue
            degraded = score >= c.degraded_after or rep.step_timer.is_straggling
            if rep.state == HEALTHY and degraded:
                self._to_draining(rep, why="degraded")
            elif rep.state == DRAINING and not degraded and not rep.pinned:
                rep.state = HEALTHY  # breaker closes: takes placements again

    def _to_draining(self, rep: Replica, *, why: str) -> None:
        if rep.state != HEALTHY:
            return
        rep.state = DRAINING
        self._c_drained.inc()
        if self.trace is not None:
            self.trace.emit("drain", step=self.steps, replica=rep.rid,
                            why=why)
        # Queued requests would wait behind a sick replica: move them now.
        # Active lanes stay — a draining replica still steps them home.
        self._migrate(rep, self._harvest_queue(rep))

    def _to_dead(self, rep: Replica, *, why: str) -> None:
        if rep.state == DEAD:
            return
        rep.state = DEAD
        self._c_dead.inc()
        if self.trace is not None:
            self.trace.emit("replica_dead", step=self.steps, replica=rep.rid,
                            why=why)
        self._migrate(rep, self._harvest_queue(rep) + self._harvest_slots(rep))

    # ---------------------------------------------------------- migration

    def _harvest_queue(self, rep: Replica) -> List[Request]:
        out = list(rep.engine.queue)
        rep.engine.queue.clear()
        return out

    def _harvest_slots(self, rep: Replica) -> List[Request]:
        """Strip a dead replica's active lanes: requests keep their
        committed output (the resume payload); the lane's pages go back
        through the allocator's retirement path so even a dead replica's
        pool holds the ``in_use + available == capacity`` invariant (its
        device caches are garbage now — nothing will ever step them)."""
        eng = rep.engine
        out = []
        for i, slot in enumerate(eng.slots):
            if slot.req is None:
                continue
            if eng.paged and slot.pages:
                eng.allocator.truncate(slot.pages, 0)
            out.append(slot.req)
            eng.slots[i] = _Slot()
        return out

    def _migrate(self, src: Replica, reqs: List[Request]) -> None:
        for req in reqs:
            if req.t_done > 0.0:
                continue  # already router-terminal — not ours to move
            # Committed tokens pin the resume to the source's precision
            # tier: replaying an int8 trace through an int4 pool (or
            # w8a8 output through w4a8 weights) decodes the continuation
            # over numerics that never produced the prefix. A request
            # with no output yet restarts cleanly anywhere.
            tier = src.tier if req.output else None
            if tier is not None and not self._tier_alive(tier):
                self._reject_tier(req, tier, src.rid)
                continue
            t0 = time.perf_counter()  # per request, or the Nth observed
            # latency would include every earlier placement in the batch
            self._placed.pop(req.uid, None)
            self._last_hint = 0.0
            handled = self._try_place(req, 0, tier)
            dst = self._placed.get(req.uid)
            if dst is not None:  # genuinely re-placed on another replica
                self._c_migrated.inc()
                self._hist_migrate.observe(time.perf_counter() - t0)
                if self.trace is not None:
                    self.trace.emit(
                        "migrate", track=req.uid, step=self.steps,
                        src=src.rid, dst=dst, committed=len(req.output),
                    )
            elif not handled:
                # No healthy capacity right now: the retry queue keeps the
                # request alive (committed tokens intact) until a replica
                # heals or retries run out. migrated counts completed
                # moves only; a retry that lands later books router_placed.
                self._enqueue_retry(req, 0, self._last_hint, tier)

    def _reject_tier(self, req: Request, tier: Tuple[int, str],
                     src_rid: int = -1) -> None:
        """Terminal cross-tier rejection: the request's tier is extinct,
        and resuming on a different tier would silently change the
        numerics under its committed tokens."""
        self._placed.pop(req.uid, None)
        if self.trace is not None:
            self.trace.emit(
                "tier_reject", track=req.uid, step=self.steps,
                src=src_rid, kv_bits=tier[0], matmul_mode=tier[1],
                committed=len(req.output),
            )
        self._terminal(req, "tier_mismatch", time.perf_counter())

    def _flush_retries(self) -> None:
        if not self._pending:
            return
        now = time.perf_counter()
        still: Deque[_Pending] = deque()
        while self._pending:
            p = self._pending.popleft()
            if p.not_before > now:
                still.append(p)
                continue
            if p.tier is not None and not self._tier_alive(p.tier):
                # The tier went extinct while this retry waited out its
                # backoff — reject now rather than burn the remaining
                # attempts on placements that can never match.
                self._reject_tier(p.req, p.tier)
                continue
            self._last_hint = 0.0
            if not self._try_place(p.req, p.attempt, p.tier):
                if p.attempt >= self.config.max_retries:
                    self._terminal(p.req, "shed", now)
                else:
                    # _try_place just refreshed _last_hint from the shed's
                    # retry_after_hint_s — backoff stays informed on every
                    # hop, not just the first submit.
                    self._enqueue_retry(p.req, p.attempt, self._last_hint,
                                        p.tier)
        self._pending = still

    # -------------------------------------------------------------- stats

    def _refresh_gauges(self) -> None:
        m = self.metrics
        for rep in self.replicas:
            m.gauge(
                f"replica_health_{rep.rid}",
                "replica circuit breaker (1 healthy / 0.5 draining / 0 dead)",
            ).set(_HEALTH_VALUE[rep.state])
            m.gauge(
                f"replica_load_{rep.rid}",
                "placement load score (lower = emptier)",
            ).set(self._load(rep) if rep.state != DEAD else 0.0)
        m.gauge("router_replicas", "replicas in the set").set(
            float(len(self.replicas))
        )
        m.gauge("router_healthy_replicas", "replicas taking placements").set(
            float(len(self._live()))
        )
        m.gauge("router_pending_retries", "requests awaiting backoff").set(
            float(len(self._pending))
        )

    def stats(self) -> Dict:
        """Flat router counters (the reference's stats schema v9, plus the
        v10 ``router_tier_rejected`` counter — the engine schema stays
        per-replica via ``replicas[rid].engine.stats()``; the router adds
        the ``router_*`` / ``replica_health_*`` layer on top)."""
        self._refresh_gauges()
        s = {
            "router_steps": float(self.steps),
            "router_placed": self._c_placed.value,
            "router_retried": self._c_retried.value,
            "router_migrated": self._c_migrated.value,
            "router_drained": self._c_drained.value,
            "router_dead_replicas": self._c_dead.value,
            "router_shed": self._c_shed.value,
            "router_timed_out": self._c_timed_out.value,
            "router_tier_rejected": self._c_tier_rejected.value,
            "router_replicas": float(len(self.replicas)),
            "router_healthy_replicas": float(len(self._live())),
            "router_pending_retries": float(len(self._pending)),
            "router_migrate_p50_ms": self._hist_migrate.percentile(50) * 1e3,
            "router_migrate_p95_ms": self._hist_migrate.percentile(95) * 1e3,
        }
        for rep in self.replicas:
            s[f"replica{rep.rid}_health"] = _HEALTH_VALUE[rep.state]
            s[f"replica{rep.rid}_step_p50_ms"] = (
                rep.step_timer.percentile(50) * 1e3
            )
        return s

    def metrics_text(self) -> str:
        """Prometheus text exposition of the router registry."""
        self._refresh_gauges()
        return self.metrics.prometheus_text()
