"""Continuous-batching serving engine (the port of ``repro.serving.engine``:
its paged and unpaged engines and the request lifecycle).

* **caches** -- ``EngineConfig.paged`` (None: paged for dense and MoE
  models, unpaged for the SSM and hybrid ones, as the reference resolves
  it). A paged engine keeps K/V in page pools with block tables and a
  prefix cache (below). An unpaged engine keeps the dense per-lane caches
  of :func:`models.transformer.init_cache` (float32; int8 rows with
  ``kv_bits=8``; no int4 layout): a b = 1 scratch cache takes each
  request's prefill and is copied into the lane's row once the prompt is
  done (:meth:`ServingEngine._adopt_scratch`). Dense and MoE prompts
  prefill in one :func:`models.transformer.prefill_with_cache` call (or,
  budgeted, :func:`models.transformer.prefill_chunk_with_cache` chunks);
  Mamba2 and hymba prompts replay through the decode step, one call per
  prompt token, as the reference's do. Admission is always *reserve*
  (fixed slots never oversubscribe), nothing preempts, and the page stats
  read 0. Speculation runs on either cache (dense and MoE models): the
  verify writes its window's rows into the dense cache, and a rejected
  tail is rolled back by rewinding ``pos``, as on the pools.

* **request lifecycle** -- ``submit(Request)`` queues; per-request
  :class:`~repro_torch.serving.config.SamplingParams` select greedy (the
  default, the mode every exactness contract is stated over) or
  temperature / top-k / top-p sampling whose draw depends on ``(seed,
  position)`` only (``serving.sampling``); :meth:`ServingEngine.generate`
  and :meth:`ServingEngine.stream` yield :class:`TokenEvent` s as tokens
  land (a first token streams right after its prefill, before the batch
  completes); :meth:`ServingEngine.cancel` retires a request mid-flight,
  releasing its pages through ``PageAllocator.truncate``.
* **admission** -- in :class:`~repro_torch.serving.scheduler.StepScheduler`
  order (resumes first, then requests past the aging bound, then ``fifo``
  or ``sjf``), with no head-of-line bypass. ``EngineConfig.admission``:
  *reserve* allocates the worst-case pages of prompt + budget up front
  (prefix hits first); *optimistic* allocates the prompt's pages plus
  ``admission_headroom`` and grows each lane before every decode step or
  speculation round, preempting the youngest lane when the pool runs dry
  (its full committed pages are registered in the prefix cache and the
  request is requeued at the head). The resume takes them back as prefix
  hits, re-prefills the prompt past them as a fresh install would, and
  replays the committed output tokens past the prompt through the decode
  path (:meth:`ServingEngine._run_replay`, one
  :func:`models.transformer.decode_tokens` call over the lane's table row),
  so every K/V row it writes is bitwise the row the decode steps wrote and
  a resumed greedy stream is token for token the uninterrupted one.
* **prefill** -- monolithic by default: one
  :func:`models.transformer.prefill_into_pages` call per request over the
  prompt suffix past its prefix hits. With ``EngineConfig.prefill_budget >
  0`` it is *budgeted*: admission only reserves the lane and its pages,
  and each engine step runs at most ``prefill_budget`` prompt tokens in
  chunks of ``chunk_size`` (page-aligned, each one prefill call reading the
  lane's earlier pages as its prefix) before the decode step. Mid-prefill
  lanes are invisible to decode (trash table row), pause speculation, are
  preemption victims like any lane, and register each full prompt page a
  chunk completes, so a preempted half-prefilled lane resumes from the
  prefix cache.
* **decode** -- every engine step decodes one token for all decoding lanes
  (:func:`models.transformer.decode_step`); greedy-only steps take the
  argmax, steps with a sampled lane run ``sampling.sample_tokens`` at each
  lane's cache position. A lane whose logits go nonfinite retires with
  ``finish_reason="error"``. With ``EngineConfig.spec`` set and every lane
  greedy and decoding, a step is one self-speculative round
  (``serving.spec_decode``), token-identical to plain greedy decode.
* **overload** -- ``Request.deadline_s`` sheds queued and active requests
  past their deadline at the top of every step (``"timeout"``);
  ``EngineConfig.max_queue`` bounds the queue with a typed
  :class:`EngineOverloaded` (``"shed"``); every ``step()`` runs inside the
  watchdog (``runtime.health.StepTimer``, and ``HeartbeatMonitor`` when
  ``heartbeat_path`` is set).
* **faults** -- :meth:`ServingEngine.inject_fault` poisons (NaN) the step
  that would produce one output token of one request; the NaN flows
  through the same finite check as a real fault. Consecutive quarantines
  count in ``_fault_streak`` (a healthy completion clears it), which the
  replica router's breaker reads. The reference's automatic kernel
  fallback has no counterpart: the port dispatches by device with no
  fallback, so ``kernel_fallbacks`` stays 0.
* **observability** -- a per-engine
  :class:`~repro_torch.obs.metrics.MetricsRegistry` owns every counter and
  histogram the engine books (the counter attributes are registry-backed
  properties); ``EngineConfig.trace`` turns on a bounded
  :class:`~repro_torch.obs.trace.TraceRing` of the reference's span events
  (exportable as Chrome trace JSON); ``EngineConfig.drift_every`` samples
  a :class:`~repro_torch.obs.drift.QuantDriftMonitor` forward every N
  steps (it restores the page-pool rows it writes); ``profile_dir`` wraps
  :meth:`ServingEngine.run` in a ``torch.profiler`` window. Spans time
  host wall around work that already synchronises; nothing is added to
  the device stream for them.
* **stats** -- :class:`EngineStats` under the reference's field names,
  derived from the registry; ``stats()`` returns its dict view and
  :meth:`ServingEngine.metrics_text` the registry as Prometheus text.

Every linear layer of prefill and decode runs in ``EngineConfig.matmul_mode``
(passed to the model functions, which pass it to every ``layers.dense``):

* ``"dequant"`` (the default) -- weight-only int8 through the fused OCS
  matmul (kernel B4; B5 for weights with no OCS split, as a clip-only
  ``ocs_ratio=0`` tree has);
* ``"w8a8"`` -- dynamic per-row int8 activations through the fused W8A8
  kernel (B1);
* ``"w4a8"`` -- the sub-8-bit tier: at construction every
  ``OCSQuantLinear`` leaf is converted once, on the engine's device, to a
  ``W4A8Linear`` (``core.ocs.to_w4a8`` with
  ``EngineConfig.w4a8_outlier_ratio``: the OCS-ranked outlier rows stay
  int8, the rest drop to packed int4), served through the W4A8 kernel
  (B6).

``EngineConfig.kv_bits`` picks the page pools: float32 (unset), int8 (8)
or packed int4 (4; B2's int4 branch). The engine runs on the card unless
built with ``device="cpu"``. It serves the dense and the MoE decoders
(deepseek-moe-16b, phi3.5-moe-42b-a6.6b) paged or unpaged, and the
Mamba2 (mamba2-1.3b) and hymba (hymba-1.5b) decoders unpaged. An
encoder-only model (hubert-xlarge) has no decode step: it runs through
:func:`models.transformer.forward`, and the engine refuses it, as the
reference's does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.apply import map_with_path, tree_to
from ..core.ocs import OCSQuantLinear, to_w4a8
from ..device import resolve_device
from ..kernels.paged_attention import check_layout
from ..models import transformer as T
from ..obs.drift import QuantDriftMonitor, clips_from_params
from ..obs.log import get_logger
from ..obs.metrics import MetricsRegistry
from ..obs.trace import TraceRing
from ..runtime.health import HeartbeatMonitor, StepTimer
from . import kv_cache as kvc
from . import sampling as sampling_mod
from . import spec_decode as spec_mod
from .config import ConfigError, EngineConfig, SamplingParams
from .scheduler import StepScheduler

__all__ = [
    "Request",
    "TokenEvent",
    "EngineStats",
    "EngineOverloaded",
    "ServingEngine",
    "FINISH_REASONS",
]

# Every request that leaves the engine carries exactly one:
#   eos       -- emitted the request's eos_id
#   length    -- exhausted max_new_tokens
#   cancelled -- cancel(uid) mid-flight
#   timeout   -- deadline_s expired (queued or active)
#   error     -- nonfinite logits quarantined the lane
#   shed      -- rejected at submit (bounded queue full)
FINISH_REASONS = ("eos", "length", "cancelled", "timeout", "error", "shed")

# Terminal reasons that never booked a final token themselves: stream()
# emits a synthetic finished=True event for them, so a streaming caller
# cannot hang on a request that silently left the queue ("cancelled" simply
# ends the stream).
_SENTINEL_REASONS = ("timeout", "error", "shed")

_LOG = get_logger("serving.engine")


class EngineOverloaded(RuntimeError):
    """Typed rejection: the bounded submit queue (``EngineConfig.max_queue``)
    is full. The request was never queued; its ``finish_reason`` is
    ``"shed"`` and ``t_done`` is set, so ``stream()`` / ``generate()`` yield
    the single shed sentinel event instead of hanging.

    ``queue_depth`` is the depth of the queue that rejected the request;
    ``retry_after_hint_s`` is the engine's rolling median step time times
    that depth (0.0 on an engine that has never stepped).
    """

    def __init__(self, msg: str = "", *, queue_depth: int = 0,
                 retry_after_hint_s: float = 0.0):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.retry_after_hint_s = retry_after_hint_s


_GREEDY = SamplingParams()


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None  # None = greedy
    deadline_s: Optional[float] = None  # seconds after submit; None = none
    # Filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0  # first admission into a lane (queue-wait stats)
    t_first_token: float = 0.0
    t_done: float = 0.0
    t_tokens: List[float] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None  # one of FINISH_REASONS


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token of one request. ``t`` is the ``time.perf_counter``
    stamp the engine booked the token at (TTFT and inter-token latencies
    derive from the same stamps)."""

    uid: int
    token: int
    index: int  # 0-based position in the request's output stream
    t: float
    finished: bool = False
    finish_reason: Optional[str] = None  # set on the final event


@dataclasses.dataclass
class EngineStats:
    """Typed serving counters under the reference's field names: its stats
    schema v10 without the fields of what the port does not have (JAX
    backends, jit traces and compile time, the kernel fallback);
    ``spec_compile_s`` stays 0. ``device`` is the
    port's own. Every field is derived from the engine's metrics registry,
    as the reference's v8+ is: counts read registry counters, latency means
    and percentiles the registry histograms (nearest-rank over a rolling
    window of 4096 observations, so exact for shorter runs), point-in-time
    readings the gauges refreshed at read time. The span-trace fields
    (``trace_*``) and the quant-drift fields (``drift_*``) are 0 while
    their subsystem is off. The dict view (:meth:`as_dict`) is what
    ``ServingEngine.stats()`` returns; ``completed`` counts successful
    terminals (eos/length) only."""

    completed: int = 0
    cancelled: int = 0
    preempted: int = 0
    shed: int = 0
    timed_out: int = 0
    errors: int = 0
    step_p50_ms: float = 0.0
    step_p95_ms: float = 0.0
    step_stalled: float = 0.0
    decode_steps: int = 0
    decoded_tokens: int = 0
    mean_latency_s: float = 0.0
    mean_ttft_s: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    itl_p50_s: float = 0.0
    itl_p95_s: float = 0.0
    prefill_tokens: int = 0
    prefill_time_s: float = 0.0
    prefill_tok_per_s: float = 0.0
    decode_time_s: float = 0.0
    decode_tok_per_s: float = 0.0
    prefill_calls: int = 0
    prefill_requests: int = 0
    prefill_calls_per_request: float = 0.0
    kv_page_size: float = 0.0
    kv_pages_capacity: float = 0.0
    kv_pages_in_use: float = 0.0
    kv_pages_cached: float = 0.0
    kv_pages_peak: float = 0.0
    kv_pool_occupancy: float = 0.0
    kv_pool_peak_occupancy: float = 0.0
    prefix_hit_rate: float = 0.0
    prefix_hit_pages: float = 0.0
    matmul_mode: str = "dequant"
    kv_bits: float = 0.0
    kv_bytes_per_token: float = 0.0
    kv_pool_capacity_tokens: float = 0.0
    attn_step_ms: float = 0.0
    spec_enabled: float = 0.0
    spec_rounds: float = 0.0
    spec_k: float = 0.0
    spec_proposed: float = 0.0
    spec_accepted: float = 0.0
    spec_acceptance_rate: float = 0.0
    spec_tokens_per_target_step: float = 0.0
    spec_draft_time_s: float = 0.0
    spec_verify_time_s: float = 0.0
    spec_compile_s: float = 0.0
    queue_wait_p50_s: float = 0.0
    queue_wait_p95_s: float = 0.0
    sched_policy: str = "fifo"
    sched_prefill_budget: float = 0.0
    sched_chunks: float = 0.0
    sched_budget_limited_steps: float = 0.0
    sched_aging_promotions: float = 0.0
    sched_peak_step_prefill_tokens: float = 0.0
    trace_enabled: float = 0.0
    trace_events: float = 0.0
    trace_dropped: float = 0.0
    drift_enabled: float = 0.0
    drift_samples: float = 0.0
    drift_sites: float = 0.0
    drift_flagged_sites: float = 0.0
    drift_max_ratio: float = 0.0
    device: str = "cuda"

    def as_dict(self) -> Dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    remaining: int = 0
    pages: List[int] = dataclasses.field(default_factory=list)
    seq: int = 0  # install order: preemption evicts the youngest
    # Budgeted prefill: prompt tokens already prefilled, or -1 once the
    # lane is decoding. Mid-prefill lanes are decode-invisible (trash table
    # row, greedy sampling).
    prefill_pos: int = -1
    keys: List[bytes] = dataclasses.field(default_factory=list)  # prompt
    # chain keys: full pages register as their chunk completes
    scratch: Optional[Dict] = None  # unpaged chunked prefill: the b=1 cache

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.prefill_pos >= 0


# Counter attribute -> (registry metric name, integer-valued, help): the
# reference's names for the counters the port books. Each attribute is a
# ServingEngine property over a registered Counter
# (_install_counter_properties), so ``self.steps += 1`` *is* the metric
# update. Nothing is compiled, so every prefill and decode second is warm.
_COUNTER_METRICS = {
    "steps": ("engine_steps_total", True, "engine step iterations"),
    "decoded_tokens": ("engine_decoded_tokens_total", True,
                       "decode tokens booked into request outputs"),
    "completed": ("engine_completed_total", True,
                  "successful terminals (eos/length)"),
    "cancelled": ("engine_cancelled_total", True,
                  "requests cancelled mid-flight"),
    "preempted": ("engine_preempted_total", True,
                  "lanes preempted under page-pool pressure"),
    "shed": ("engine_shed_total", True,
             "requests rejected at submit (bounded queue full)"),
    "timed_out": ("engine_timed_out_total", True,
                  "requests shed past their deadline_s"),
    "errors": ("engine_errors_total", True,
               "requests quarantined on nonfinite logits"),
    "prefill_calls": ("engine_prefill_calls_total", True,
                      "calls spent on prefill"),
    "prefill_requests": ("engine_prefill_requests_total", True,
                         "requests that entered prefill"),
    "prefill_tokens": ("engine_prefill_tokens_total", True,
                       "prompt tokens run through prefill compute"),
    "prefill_time_s": ("engine_prefill_warm_seconds_total", False,
                       "prefill wall time"),
    "decode_time_s": ("engine_decode_warm_seconds_total", False,
                      "decode wall time (decode steps, spec rounds, resume replays)"),
}


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        config: Optional[EngineConfig] = None,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        config = config if config is not None else EngineConfig()
        if not cfg.causal:
            raise ValueError("encoder-only arch: no decode serving")
        T.check_block(cfg)
        # Paged KV cache: attention archs only (SSM and hybrid decode states
        # are O(1) per lane: nothing to page).
        self.paged = cfg.block in T.ATTN_BLOCKS if config.paged is None else config.paged
        if self.paged and cfg.block not in T.ATTN_BLOCKS:
            raise ValueError(f"paged KV cache: dense/moe only, got {cfg.block}")
        if not self.paged and (config.kv_bits or cfg.kv_bits) == 4:
            raise ConfigError(
                "kv_bits=4 packs nibbles into page pools; this engine resolved to "
                f"an unpaged cache (block={cfg.block!r}) -- the dense cache has no "
                "int4 layout")
        if self.device.type == "cuda" and self.paged:  # refuse up front
            check_layout(cfg.hd, config.page_size)
        if config.kv_bits is not None and config.kv_bits != cfg.kv_bits:
            cfg = dataclasses.replace(cfg, kv_bits=config.kv_bits)
        self.cfg = cfg
        self.config = config
        self.kv_bits = cfg.kv_bits
        # The registry always exists: every counter attribute below is a
        # registry-backed property (_COUNTER_METRICS), so booking costs one
        # float add whether anyone reads it or not. Span tracing and drift
        # sampling are opt-in (EngineConfig.trace / drift_every).
        self.metrics = MetricsRegistry()
        self._metric_counters = {
            attr: self.metrics.counter(name, help_)
            for attr, (name, _integer, help_) in _COUNTER_METRICS.items()
        }
        self._hist_ttft = self.metrics.histogram(
            "request_ttft_seconds", "submit -> first booked token")
        self._hist_itl = self.metrics.histogram(
            "request_itl_seconds", "gap between consecutive booked tokens")
        self._hist_qwait = self.metrics.histogram(
            "request_queue_wait_seconds", "submit -> first lane admission")
        self._hist_latency = self.metrics.histogram(
            "request_latency_seconds",
            "submit -> done over successful terminals (eos/length)")
        self._hist_step = self.metrics.histogram(
            "engine_step_seconds", "one step() call, productive or not")
        self.trace: Optional[TraceRing] = (
            TraceRing(config.trace_capacity) if config.trace else None)
        self.params = tree_to(params, self.device)
        if config.matmul_mode == "w4a8":
            # The sub-8-bit weight tier, converted once, on the engine's
            # device.
            def to_tier(_path, leaf):
                if isinstance(leaf, OCSQuantLinear):
                    return to_w4a8(leaf, config.w4a8_outlier_ratio)
                return leaf

            self.params = map_with_path(to_tier, self.params)
        # Quant-drift monitor: clips come from the tree's calibrated
        # activation grids where present; other sites self-calibrate from
        # early traffic. The sub-8-bit tiers calibrate against a wider
        # baseline-saturation floor. The first sampling failure disables
        # the monitor for good (telemetry never takes the serving loop down).
        grid_bits = 4 if (cfg.kv_bits == 4 or config.matmul_mode == "w4a8") else 8
        self._drift: Optional[QuantDriftMonitor] = (
            QuantDriftMonitor(clips=clips_from_params(self.params),
                              factor=config.drift_threshold, grid_bits=grid_bits)
            if config.drift_every > 0 else None
        )
        self._drift_broken = False
        self._drift_last_step = -1
        self._profiler = None  # the torch.profiler window of profile_dir
        # No automatic kernel fallback (dispatch is by device), so the
        # router's breaker term for it always reads 0.
        self.kernel_fallbacks = 0
        self.max_batch = config.max_batch
        self.max_len = config.max_len
        self.matmul_mode = config.matmul_mode
        self.page_size = config.page_size
        if self.paged:
            if self.max_len % self.page_size:
                raise ValueError(
                    f"max_len {self.max_len} must be a multiple of page_size "
                    f"{self.page_size}"
                )
            self.max_pages_per_seq = self.max_len // self.page_size
            n_pages = config.n_pages
            if n_pages is None:
                # The fixed-slot footprint plus the reserved trash page.
                n_pages = self.max_batch * self.max_pages_per_seq + 1
            self.allocator = kvc.PageAllocator(n_pages, self.page_size)
            self.caches = kvc.init_paged_cache(
                cfg, self.max_batch, n_pages, self.page_size, self.max_pages_per_seq,
                device=self.device,
            )
        else:
            self.allocator = None
            self.caches = T.init_cache(cfg, self.max_batch, self.max_len, torch.float32,
                                       device=self.device)
        self.slots = [_Slot() for _ in range(self.max_batch)]
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self.tokens = torch.zeros((self.max_batch, 1), dtype=torch.int32, device=self.device)
        # Optimistic admission means something only on a paged engine:
        # fixed slots never oversubscribe, so an unpaged one reserves.
        self.admission = config.admission if self.paged else "reserve"
        self.replay_lengths: List[int] = []  # each resume replay's rows (its tail, padded on MoE)
        self._install_seq = 0  # monotonic install stamp (victim selection)
        # The step scheduler orders admission for every engine and plans
        # the chunks of budgeted prefill when prefill_budget > 0.
        self.chunked = config.prefill_budget > 0
        self._sched = StepScheduler(
            policy=config.sched_policy,
            aging_steps=config.sched_aging_steps,
            prefill_budget=config.prefill_budget,
            chunk_size=config.chunk_size,
        )
        self._sched.trace = self.trace  # budget-limited / promotion instants
        self._preempted_uids: set = set()  # resumes outrank policy order
        self._fault_at: Dict[int, int] = {}  # uid -> output index to poison
        self._fault_streak = 0  # consecutive quarantined requests (no
        # healthy eos/length completion in between)
        # Serving watchdog: step-time percentiles and an optional heartbeat.
        self._step_timer = StepTimer(window=200)
        self._heartbeat = (
            HeartbeatMonitor(config.heartbeat_path,
                             min_interval=config.heartbeat_interval_s)
            if config.heartbeat_path else None
        )
        # Per-lane sampling (greedy unless a request says otherwise); the
        # tensor view is rebuilt lazily after admissions and retirements.
        self._sampling: List[SamplingParams] = [_GREEDY] * self.max_batch
        self._samp_cache: Optional[Dict[str, torch.Tensor]] = None
        self._auto_uid = 0
        # Self-speculative decoding: the quantized model drafts k tokens per
        # lane under spec.draft_mode, the target verifies them in one step.
        self._spec = (spec_mod.SpecDecoder(cfg, config.spec, self.matmul_mode)
                      if config.spec is not None else None)
        if self._spec is not None:
            self._spec.trace = self.trace  # draft/verify spans, engine lane
        # Per-step attention-time probe (stats()["attn_step_ms"]); paged
        # engines only, off by default.
        self.attn_probe = config.attn_probe and self.paged

    # ------------------------------------------------------------- sampling

    def _samp_device(self) -> Dict[str, torch.Tensor]:
        if self._samp_cache is None:
            self._samp_cache = sampling_mod.params_to_arrays(self._sampling, self.device)
        return self._samp_cache

    def _samp_one(self, sp: SamplingParams) -> Dict[str, torch.Tensor]:
        """Single-lane sampling tensors (a prefill's first token)."""
        return sampling_mod.params_to_arrays([sp], self.device)

    def _set_lane_sampling(self, slot_idx: int, sp: SamplingParams) -> None:
        self._sampling[slot_idx] = sp
        self._samp_cache = None

    def _active_sampled(self) -> bool:
        return any(
            s.req is not None and not self._sampling[i].greedy
            for i, s in enumerate(self.slots)
        )

    # -------------------------------------------------------------- prefill

    def _prefill_bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        if self.paged:
            b = max(b, self.page_size)  # page-granular writes
        return min(b, self.max_len)

    def _scope(self, name: str):
        """A ``torch.profiler`` label while the profile_dir window is open
        (the reference's ``jax.named_scope``), else nothing."""
        if self._profiler is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _prefill(
        self, tokens: np.ndarray, prefix_ids: List[int], page_ids: List[int],
        sp: SamplingParams, sample_pos: int,
    ) -> Tuple[int, bool, float, float]:
        """One prefill call: ``tokens`` (positions ``len(prefix_ids) *
        page_size`` on) into ``page_ids``, the pages ``prefix_ids`` read as
        the prefix. Returns (the token after the last one, drawn by ``sp`` at
        ``sample_pos``; the finite flag of its logits; the call's start and
        wall seconds, for its span)."""
        m = len(tokens)  # >= 1
        bucket = self._prefill_bucket(m)
        nb = bucket // self.page_size
        ids = np.full((nb,), kvc.TRASH_PAGE, np.int32)
        k = min(nb, len(page_ids))
        ids[:k] = page_ids[:k]  # bucket pads past the pages write to trash
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :m] = tokens
        dev = self.device
        pools = [layer["attn"] for layer in self.caches["layers"]]
        t0 = time.perf_counter()
        with torch.no_grad(), self._scope("serving_prefill"):
            logits, new_pools = T.prefill_into_pages(
                self.params, torch.as_tensor(toks, device=dev), self.cfg, pools,
                torch.as_tensor(ids, device=dev),
                length=torch.as_tensor([m], dtype=torch.int32, device=dev),
                prefix_ids=torch.as_tensor(prefix_ids, dtype=torch.int32, device=dev),
                mode=self.matmul_mode,
            )
            first, finite = self._first_token(logits, sp, sample_pos)
        elapsed = time.perf_counter() - t0
        self.prefill_time_s += elapsed
        self.prefill_calls += 1
        self.prefill_tokens += m
        self.caches["layers"] = [{"attn": p} for p in new_pools]
        return first, finite, t0, elapsed

    def _first_token(self, logits: torch.Tensor, sp: SamplingParams,
                     sample_pos: int) -> Tuple[int, bool]:
        """A prefill's ``[1, V]`` logits -> (the next token, the argmax or
        ``sp``'s draw at ``sample_pos``; whether the logits are finite)."""
        finite = bool(torch.isfinite(logits).all())
        if sp.greedy:
            return int(torch.argmax(logits[0])), finite  # sync: the prefill has retired
        pos = torch.as_tensor([sample_pos], dtype=torch.int32, device=self.device)
        return int(sampling_mod.sample_tokens(logits, self._samp_one(sp), pos)[0]), finite

    def _prefill_request(self, tokens: np.ndarray, prefix_ids: List[int],
                         page_ids: List[int], sp: SamplingParams, sample_pos: int,
                         uid) -> Tuple[int, bool]:
        """:meth:`_prefill` of a request's prompt suffix (an install or a
        resume), traced as one ``prefill`` span."""
        first, finite, t0, elapsed = self._prefill(tokens, prefix_ids, page_ids, sp,
                                                   sample_pos)
        if self.trace is not None:
            self.trace.emit("prefill", track=uid, ts=t0, dur=elapsed, step=self.steps,
                            tokens=len(tokens))
        return first, finite

    def _run_replay(self, slot_idx: int, tokens: np.ndarray, start: int) -> None:
        """Write decode-path K/V for positions ``start .. start+len(tokens)-1``
        of lane ``slot_idx`` (whose table row must already be set): one
        :func:`models.transformer.decode_tokens` call at b = 1 over the
        lane's table row, its logits discarded (a resume already knows every
        committed token). Every kernel gives a row what its one-token call
        gives it (the verify contract), so each row written is bitwise the
        row the uninterrupted run's decode step wrote. The port runs
        eagerly, so a dense model's call takes exactly the tail. A MoE
        model's capacity follows the call's row count, so its call routes
        the reference's rows: the tail zero-padded to the reference's
        bucket (8, doubled until it holds the tail, at most ``max_len``).
        The pad rows write K/V past the committed position, invisible to
        every read and overwritten later, and rank after the tail in every
        expert, so they take no slot from it. Booked as decode time, as the
        reference books it; ``replay_lengths`` gets the rows the call
        ran."""
        if len(tokens) == 0:
            return
        rows = len(tokens)
        if self.cfg.block == "moe":
            rows = 8
            while rows < len(tokens):
                rows *= 2
            rows = min(rows, self.max_len)
        dev = self.device
        caches = {
            "layers": self.caches["layers"],
            "table": self.caches["table"][slot_idx:slot_idx + 1],
            "pos": torch.tensor([start], dtype=torch.int32, device=dev),
        }
        toks = np.zeros((1, rows), np.int32)
        toks[0, :len(tokens)] = tokens
        toks = torch.as_tensor(toks, device=dev)
        t0 = time.perf_counter()
        with torch.no_grad(), self._scope("serving_replay"):
            _, new_caches = T.decode_tokens(self.params, toks, caches, self.cfg,
                                            mode=self.matmul_mode)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the replay's time is decode time
        self.decode_time_s += time.perf_counter() - t0
        self.caches["layers"] = new_caches["layers"]
        self.replay_lengths.append(rows)

    def _finish_first_token(self, req: Request, first: int) -> bool:
        """Book the prefill-produced token; True if the request is already
        done (immediate eos, or a 1-token budget) and takes no lane."""
        now = time.perf_counter()
        req.t_first_token = now
        req.output.append(first)
        req.t_tokens.append(now)
        self._hist_ttft.observe(now - req.t_submit)
        if self.trace is not None:
            self.trace.emit("first_token", track=req.uid, step=self.steps)
        if req.eos_id is not None and first == req.eos_id:
            req.finish_reason = "eos"
        elif req.max_new_tokens <= 1:
            req.finish_reason = "length"
        else:
            return False
        req.t_done = time.perf_counter()
        self.done.append(req)
        self._book_terminal(req)
        return True

    def _book_terminal(self, req: Request) -> None:
        """Registry and trace booking for one terminal request, called once
        wherever a request leaves the engine with ``t_done`` stamped (a shed
        at submit excepted: it never entered and emits its own ``shed``
        instant). Successful terminals book the latency histogram; every
        terminal emits a ``retire`` instant."""
        if req.finish_reason in ("eos", "length"):
            self.completed += 1
            if req.t_done and req.t_submit:
                self._hist_latency.observe(req.t_done - req.t_submit)
        elif req.finish_reason == "cancelled":
            self.cancelled += 1
        if self.trace is not None:
            self.trace.emit("retire", track=req.uid, step=self.steps,
                            finish_reason=req.finish_reason)

    def _quarantine(self, req: Request) -> None:
        """Terminal-error a request whose prefill logits went nonfinite
        (before it took a lane; an active lane retires through ``_retire``
        with the reason set)."""
        req.finish_reason = "error"
        req.t_done = time.perf_counter()
        self.done.append(req)
        self._book_terminal(req)
        self._note_fault(req)

    def _note_fault(self, req: Request) -> None:
        """Book one quarantined request. The streak counts consecutive
        quarantines with no healthy completion in between (``_retire``
        clears it on eos/length); the replica router's breaker reads it. The
        reference demotes its attention kernel after three; the port has no
        fallback."""
        self.errors += 1
        self._fault_at.pop(req.uid, None)
        self._fault_streak += 1
        if self.trace is not None:
            self.trace.emit("quarantine", track=req.uid, step=self.steps,
                            streak=self._fault_streak)

    def inject_fault(self, uid: int, at_output_index: int) -> None:
        """Test hook: poison (NaN) the step that would produce output token
        ``at_output_index`` (>= 1; index 0 comes from prefill) of request
        ``uid``. The NaN is added to that lane's logits and flows through
        the same finite check as a real numerical fault, so tests exercise
        the quarantine path end to end."""
        self._fault_at[uid] = at_output_index

    def _fault_row(self, window: int = 1) -> Optional[np.ndarray]:
        """Per-lane injection row for the next decode or verify step: NaN
        for lanes whose pending fault falls inside the step's output window
        (``window`` tokens for a speculative round), 0.0 otherwise. None
        when no lane has one due, so a step without a pending fault adds
        nothing to its logits and launches what it launches without the
        hook."""
        if not self._fault_at:
            return None
        fault = np.zeros((self.max_batch,), np.float32)
        for i, slot in enumerate(self.slots):
            r = slot.req
            if r is None or slot.prefilling:
                continue
            at = self._fault_at.get(r.uid)
            if at is not None and at < len(r.output) + window:
                fault[i] = np.nan
        return fault if np.isnan(fault).any() else None

    def _set_row(self, slot_idx: int, pages: List[int]) -> None:
        row = np.full((self.max_pages_per_seq,), kvc.TRASH_PAGE, np.int32)
        row[: len(pages)] = pages
        self.caches["table"][slot_idx] = torch.as_tensor(row, device=self.device)

    def _start_decoding(self, slot_idx: int, slot: _Slot, pos: int, token: int,
                        sp: SamplingParams) -> None:
        """Point lane ``slot_idx`` at ``slot``'s pages and make it decode
        ``token`` at ``pos``."""
        self._set_row(slot_idx, slot.pages)
        self.caches["pos"][slot_idx] = pos
        self.tokens[slot_idx, 0] = token
        self.slots[slot_idx] = slot
        self._set_lane_sampling(slot_idx, sp)

    def _need_install(self, n_committed: int, need_total: int) -> int:
        """Pages granted at install time: the worst case under ``reserve``
        admission, or the committed context plus headroom under
        ``optimistic`` (later pages grow per decode step)."""
        if self.admission != "optimistic":
            return need_total
        return min(
            kvc.pages_needed(n_committed, self.page_size)
            + self.config.admission_headroom,
            need_total,
        )

    def _claim_pages(self, tokens: np.ndarray, n_committed: int, need_total: int,
                     max_hit: int):
        """Prefix hits of ``tokens`` (at most ``max_hit`` pages) plus fresh
        pages up to the install grant. Returns ``(hit_ids, new_ids, keys)``,
        or None -- holding nothing -- when the pool cannot grant it."""
        need_install = self._need_install(n_committed, need_total)
        if self.allocator.available() < need_install - max_hit:
            return None  # cannot fit even with a full prefix hit: fail fast
            # before the O(prompt) hash work
        hit_ids, keys = self.allocator.match_prefix(tokens, max_hit)
        need_new = need_install - len(hit_ids)
        if self.allocator.available() < need_new:
            self.allocator.release(hit_ids)  # un-retain; stay queued
            return None
        return hit_ids, self.allocator.alloc(need_new), keys

    def _need_total(self, req: Request) -> int:
        return min(kvc.pages_needed(len(req.prompt) + req.max_new_tokens, self.page_size),
                   self.max_pages_per_seq)

    def _install(self, slot_idx: int, req: Request) -> bool:
        """Admit ``req`` into lane ``slot_idx``. Returns False -- leaving the
        request queued -- only when the pool cannot hold it."""
        if req.output:
            if not self.paged:
                # The reference's unpaged install (repro/serving/engine.py:1066-1093)
                # re-prefills the prompt alone and appends a fresh first token
                # after the committed output, with the whole budget again: the
                # stream restarts past its budget. No resume is defined there.
                raise NotImplementedError(
                    f"request {req.uid} carries committed output: the unpaged engine has "
                    "no resume (an unpaged engine never preempts; the reference's "
                    "unpaged install restarts such a stream past its budget)")
            return self._resume_paged(slot_idx, req)
        if self.chunked:
            return self._install_chunked(slot_idx, req)
        if not self.paged:
            return self._install_unpaged(slot_idx, req)
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        self._validate_prompt_len(n)
        sp = req.sampling or _GREEDY
        ps = self.page_size
        # Cap prefix hits so the suffix keeps >= 1 token (the prefill must
        # still produce the first-token logits).
        claim = self._claim_pages(prompt, n, self._need_total(req), (n - 1) // ps)
        if claim is None:
            return False
        hit_ids, new_ids, keys = claim
        self.allocator.note_prefix_stats(len(hit_ids), n // ps)
        self._emit_prefix(req, hit_ids)
        row_ids = hit_ids + new_ids
        self.prefill_requests += 1
        first, finite = self._prefill_request(prompt[len(hit_ids) * ps:], hit_ids, new_ids,
                                              sp, n - 1, req.uid)
        if not finite:
            self.allocator.release(row_ids)
            self._quarantine(req)
            return True
        # Publish the freshly written full prompt pages (decode appends past
        # the prompt, so sharing them is safe).
        for j in range(len(hit_ids), n // ps):
            self.allocator.register(keys[j], row_ids[j])
        if self._finish_first_token(req, first):
            self.allocator.release(row_ids)  # registered pages stay hit-able
            return True
        self._start_decoding(slot_idx, _Slot(req=req, remaining=req.max_new_tokens - 1,
                                             pages=row_ids, seq=self._install_seq),
                             n, first, sp)
        self._install_seq += 1
        return True

    def _emit_prefix(self, req: Request, hit_ids: List[int]) -> None:
        if self.trace is not None:
            self.trace.emit("prefix_hit" if hit_ids else "prefix_miss", track=req.uid,
                            step=self.steps, pages=len(hit_ids))

    def _resume_paged(self, slot_idx: int, req: Request) -> bool:
        """Re-install a preempted request (``req.output`` holds its committed
        tokens) with bit-exact recompute, as the reference does:

        * full pages of the committed context (prompt + output, registered
          at preemption) come back as prefix hits, their rows the original
          bits;
        * a prompt remainder past the hits re-runs the same suffix prefill
          as a fresh install (its first token is already committed and is
          discarded; a nonfinite result quarantines as a fresh prefill
          does); a prompt fully covered by hits makes no prefill call;
        * the committed output tokens past the prompt and the hits replay
          through the decode path (:meth:`_run_replay`), whose K/V rows are
          bitwise what the uninterrupted run's decode steps wrote, so the
          continuation decodes over the same cache and a greedy stream is
          token for token the uninterrupted one.
        """
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        m = len(req.output)
        ps = self.page_size
        pos = n + m - 1  # committed position: K/V must exist below it
        ctx = np.concatenate([prompt, np.asarray(req.output, np.int64)])
        # Every full committed page is reusable: the resume needs no logits.
        claim = self._claim_pages(ctx[:pos], pos + 1, self._need_total(req), pos // ps)
        if claim is None:
            return False
        hit_ids, new_ids, keys = claim
        row_ids = hit_ids + new_ids
        h = len(hit_ids) * ps  # committed tokens covered by hits
        self._emit_prefix(req, hit_ids)
        if h < n:
            _, finite = self._prefill_request(prompt[h:], hit_ids, new_ids, _GREEDY, n - 1,
                                              req.uid)
            if not finite:
                self.allocator.release(row_ids)
                self._quarantine(req)
                return True
        # The table row first: the replay decodes through it.
        self._set_row(slot_idx, row_ids)
        start = max(h, n)
        self._run_replay(slot_idx, ctx[start:pos], start)
        # (Re-)publish the full committed pages this resume rewrote; pages
        # still registered from the preemption win (first writer wins).
        for j in range(len(hit_ids), pos // ps):
            self.allocator.register(keys[j], row_ids[j])
        self._start_decoding(slot_idx, _Slot(req=req, remaining=req.max_new_tokens - m,
                                             pages=row_ids, seq=self._install_seq),
                             pos, int(req.output[-1]), req.sampling or _GREEDY)
        self._install_seq += 1
        return True

    # ------------------------------------------------------ unpaged engine

    def _prefill_scratch(self, tokens: np.ndarray, scratch, start: int,
                         sp: SamplingParams, sample_pos: int):
        """Run ``tokens`` (prompt positions ``start`` on) into a b = 1
        scratch cache of :func:`models.transformer.init_cache`. Dense and
        MoE: one :func:`models.transformer.prefill_chunk_with_cache` call
        over the bucket-padded tokens, the cache's rows below ``start`` read
        as the prefix (padded to the reference's power-of-two bucket), or
        with no scratch one :func:`models.transformer.prefill_with_cache`
        call that makes it. Mamba2 and hymba: one decode step per token, as
        the reference replays them. Returns (the token after the last one,
        drawn by ``sp`` at ``sample_pos``; the finite flag of its logits,
        the last step's only on a replay, since an SSM NaN propagates
        through the state; the scratch; the call's start and wall
        seconds)."""
        m = len(tokens)
        dev = self.device
        mode = self.matmul_mode
        t0 = time.perf_counter()
        with torch.no_grad(), self._scope("serving_prefill"):
            if self.cfg.block in T.ATTN_BLOCKS:
                bucket = self._prefill_bucket(m)
                toks = np.zeros((1, bucket), np.int64)
                toks[0, :m] = tokens
                toks = torch.as_tensor(toks, device=dev)
                length = torch.tensor([m], dtype=torch.int32, device=dev)
                if scratch is None:
                    logits, scratch = T.prefill_with_cache(
                        self.params, toks, self.cfg, self.max_len, length=length, mode=mode)
                else:
                    prefix_pad = 0
                    if start:
                        prefix_pad = 8
                        while prefix_pad < start:
                            prefix_pad *= 2
                        prefix_pad = min(prefix_pad, self.max_len)
                    logits, scratch = T.prefill_chunk_with_cache(
                        self.params, toks, self.cfg, scratch, start=start, length=length,
                        prefix_pad=prefix_pad, mode=mode)
                calls = 1
            else:
                if scratch is None:
                    scratch = T.init_cache(self.cfg, 1, self.max_len, torch.float32,
                                           device=dev)
                toks = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)[None, :]
                for i in range(m):
                    logits, scratch = T.decode_step(self.params, toks[:, i:i + 1], scratch,
                                                    self.cfg, mode=mode)
                calls = m
            first, finite = self._first_token(logits, sp, sample_pos)
        elapsed = time.perf_counter() - t0
        self.prefill_time_s += elapsed
        self.prefill_calls += calls
        self.prefill_tokens += m
        return first, finite, scratch, t0, elapsed

    def _install_unpaged(self, slot_idx: int, req: Request) -> bool:
        """Monolithic install on the unpaged engine: the whole prompt into a
        fresh scratch cache (:meth:`_prefill_scratch`), adopted into the
        lane's row unless the request ends at its first token."""
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        self._validate_prompt_len(n)
        sp = req.sampling or _GREEDY
        self.prefill_requests += 1
        first, finite, scratch, t0, elapsed = self._prefill_scratch(prompt, None, 0, sp, n - 1)
        if self.trace is not None:
            self.trace.emit("prefill", track=req.uid, ts=t0, dur=elapsed, step=self.steps,
                            tokens=n)
        if not finite:
            self._quarantine(req)
            return True
        if self._finish_first_token(req, first):
            return True
        self._adopt_scratch(slot_idx, scratch)
        self.tokens[slot_idx, 0] = first
        self.slots[slot_idx] = _Slot(req=req, remaining=req.max_new_tokens - 1,
                                     seq=self._install_seq)
        self._install_seq += 1
        self._set_lane_sampling(slot_idx, sp)
        return True

    def _adopt_scratch(self, slot_idx: int, scratch) -> None:
        """Copy a b = 1 scratch cache into row ``slot_idx`` of the engine's
        caches, every leaf of every layer, and the lane's position; the
        other lanes are untouched."""
        def put(dst, src):
            if isinstance(dst, dict):
                for key in dst:
                    put(dst[key], src[key])
            else:
                dst[slot_idx:slot_idx + 1].copy_(src)

        for eng_layer, scr_layer in zip(self.caches["layers"], scratch["layers"]):
            put(eng_layer, scr_layer)
        self.caches["pos"][slot_idx] = scratch["pos"][0]

    def _run_chunk_scratch(self, slot_idx: int, grant: int) -> None:
        """One chunk of lane ``slot_idx``'s prompt into its b = 1 scratch
        (:meth:`_prefill_scratch`: a prefill chunk for dense and MoE, a
        bounded run of the decode-step replay for Mamba2 and hymba). The
        final chunk adopts the scratch (:meth:`_finalize_unpaged`)."""
        slot = self.slots[slot_idx]
        req = slot.req
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        start = slot.prefill_pos
        end = start + grant
        sp = req.sampling or _GREEDY
        first, finite, slot.scratch, t0, elapsed = self._prefill_scratch(
            prompt[start:end], slot.scratch, start, sp, n - 1)
        if self.trace is not None:
            self.trace.emit("prefill_chunk", track=req.uid, ts=t0, dur=elapsed,
                            step=self.steps, start=start, grant=grant, final=end >= n)
        if end >= n:
            self._finalize_unpaged(slot_idx, first, finite)
        elif self.cfg.block in T.ATTN_BLOCKS and not finite:
            # A replay's chunk checks nothing before the last (an SSM NaN
            # propagates through the state), as the reference's does.
            self.slots[slot_idx] = _Slot()
            self._quarantine(req)
        else:
            slot.prefill_pos = end

    def _finalize_unpaged(self, slot_idx: int, first: int, finite: bool) -> None:
        """The last chunk is done: adopt the scratch into the engine's caches
        and make the lane decode, or finish or quarantine the request
        without its ever taking a decode lane (as the monolithic install)."""
        slot = self.slots[slot_idx]
        req = slot.req
        if not finite:
            self.slots[slot_idx] = _Slot()
            self._quarantine(req)
            return
        if self._finish_first_token(req, first):
            self.slots[slot_idx] = _Slot()
            return
        self._adopt_scratch(slot_idx, slot.scratch)
        self.tokens[slot_idx, 0] = first
        slot.scratch = None
        slot.remaining = req.max_new_tokens - 1
        slot.prefill_pos = -1
        self._set_lane_sampling(slot_idx, req.sampling or _GREEDY)

    # ------------------------------------------------------ chunked prefill

    def _is_resume(self, req: Request) -> bool:
        """True for requests requeued by preemption: decode-phase victims
        carry committed output; mid-prefill victims have none, so their
        uids are remembered."""
        return bool(req.output) or req.uid in self._preempted_uids

    def _install_chunked(self, slot_idx: int, req: Request) -> bool:
        """Budgeted admission: reserve the lane and its pages without any
        prefill compute; the per-step chunk plan (:meth:`_run_chunk_plan`)
        drains the prompt through the step loop. The lane is
        decode-invisible until its final chunk."""
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        self._validate_prompt_len(n)
        if not self.paged:
            # The lane only: its prompt chunks run into a b=1 scratch cache.
            self.slots[slot_idx] = _Slot(
                req=req, remaining=req.max_new_tokens, seq=self._install_seq,
                prefill_pos=0,
                scratch=(T.init_cache(self.cfg, 1, self.max_len, torch.float32,
                                      device=self.device)
                         if self.cfg.block in T.ATTN_BLOCKS else None))
            self._install_seq += 1
            self.prefill_requests += 1
            return True
        ps = self.page_size
        # The final chunk must keep >= 1 token.
        claim = self._claim_pages(prompt, n, self._need_total(req), (n - 1) // ps)
        if claim is None:
            return False
        hit_ids, new_ids, keys = claim
        self.allocator.note_prefix_stats(len(hit_ids), n // ps)
        self._emit_prefix(req, hit_ids)
        self.slots[slot_idx] = _Slot(
            req=req, remaining=req.max_new_tokens, pages=hit_ids + new_ids,
            seq=self._install_seq, prefill_pos=len(hit_ids) * ps, keys=keys,
        )
        self._install_seq += 1
        self.prefill_requests += 1
        return True

    def _run_chunk_plan(self) -> None:
        """Run this step's chunk grants (at most ``prefill_budget`` tokens in
        all) over the mid-prefill lanes."""
        lanes = [
            (i, len(s.req.prompt) - s.prefill_pos, s.seq)
            for i, s in enumerate(self.slots)
            if s.prefilling
        ]
        if not lanes:
            return
        for slot_idx, grant in self._sched.plan_chunks(lanes):
            if not self.slots[slot_idx].prefilling:
                continue  # quarantined by an earlier chunk this step
            if self.paged:
                self._run_chunk_paged(slot_idx, grant)
            else:
                self._run_chunk_scratch(slot_idx, grant)

    def _run_chunk_paged(self, slot_idx: int, grant: int) -> None:
        """One chunk of lane ``slot_idx``'s prompt straight into its pages.

        ``prefill_pos`` is page-aligned for every non-final chunk (install
        starts at a page boundary, intermediate grants are whole chunks and
        ``chunk_size % page_size == 0``), so the chunk's pages are
        ``pages[start/ps:]`` and its prefix exactly ``pages[:start/ps]``."""
        slot = self.slots[slot_idx]
        req = slot.req
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        start = slot.prefill_pos
        end = start + grant
        sp = req.sampling or _GREEDY
        ps = self.page_size
        p0 = start // ps
        first, finite, t0, elapsed = self._prefill(prompt[start:end], slot.pages[:p0],
                                                   slot.pages[p0:], sp, n - 1)
        if self.trace is not None:
            self.trace.emit("prefill_chunk", track=req.uid, ts=t0, dur=elapsed,
                            step=self.steps, start=start, grant=grant, final=end >= n)
        if not finite:
            self.allocator.release(slot.pages)
            self.slots[slot_idx] = _Slot()
            self._quarantine(req)
            return
        # Publish the full prompt pages this chunk completed: a preempted
        # half-prefilled lane then resumes from the prefix cache.
        for j in range(p0, min(end, n) // ps):
            self.allocator.register(slot.keys[j], slot.pages[j])
        slot.prefill_pos = end
        if end < n:
            return
        if self._finish_first_token(req, first):
            self.allocator.release(slot.pages)  # registered pages stay hit-able
            self.slots[slot_idx] = _Slot()
            return
        slot.remaining = req.max_new_tokens - 1
        slot.prefill_pos = -1
        slot.keys = []
        self._start_decoding(slot_idx, slot, n, first, sp)

    # -------------------------------------------------- overload machinery

    def _retire(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        slot.req.t_done = time.perf_counter()
        if slot.req.finish_reason is None:
            slot.req.finish_reason = "length"
        if slot.req.finish_reason in ("eos", "length"):
            self._fault_streak = 0  # a healthy completion clears the streak
        self.done.append(slot.req)
        self._book_terminal(slot.req)
        if self.paged:
            # Reclaim the pages (retirement is truncate to 0 tokens; cancel
            # rides the same path) and point the lane at the trash page so
            # its dead writes never land in a page the allocator hands out
            # again. An unpaged lane's row is overwritten by its next adopt.
            self.allocator.truncate(slot.pages, 0)
            self.caches["table"][slot_idx] = kvc.TRASH_PAGE
            self.caches["pos"][slot_idx] = 0
        self.slots[slot_idx] = _Slot()
        self._set_lane_sampling(slot_idx, _GREEDY)

    def _preempt(self, slot_idx: int) -> None:
        """Evict lane ``slot_idx`` under pool pressure and requeue its
        request at the queue head. Every full page of its committed context
        is registered in the prefix cache first, so the released pages stay
        hit-able and the resume usually allocates only the tail page."""
        slot = self.slots[slot_idx]
        req = slot.req
        prefilling = slot.prefilling
        if not prefilling:
            # Mid-prefill lanes registered their full pages chunk by chunk,
            # and their table row is still the trash page.
            pos = len(req.prompt) + len(req.output) - 1
            keys = self.allocator.chain_keys(list(req.prompt) + req.output,
                                             pos // self.page_size)
            for j, key in enumerate(keys[: len(slot.pages)]):
                self.allocator.register(key, slot.pages[j])
            self.caches["table"][slot_idx] = kvc.TRASH_PAGE
            self.caches["pos"][slot_idx] = 0
        self.allocator.truncate(slot.pages, 0)
        self.slots[slot_idx] = _Slot()
        self._set_lane_sampling(slot_idx, _GREEDY)
        self._preempted_uids.add(req.uid)
        self.queue.appendleft(req)
        self.preempted += 1
        if self.trace is not None:
            if prefilling:
                self.trace.emit("preempt", track=req.uid, step=self.steps, prefilling=True)
            else:
                self.trace.emit("preempt", track=req.uid, step=self.steps, prefilling=False,
                                committed=len(req.output))

    def _grow_lane(self, slot_idx: int, delta: int, touched: Dict) -> None:
        """Grow lane ``slot_idx``'s pages to cover its next ``delta``
        positions, preempting the youngest lane (possibly itself) while the
        pool comes up short. Terminates: each preemption frees >= 1 page,
        the oldest lane is never a victim while others are active, and one
        lane's need never exceeds the pool (submit() rejects those)."""
        slot = self.slots[slot_idx]
        req = slot.req
        pos = len(req.prompt) + len(req.output) - 1
        need = min(kvc.pages_needed(pos + delta, self.page_size), self.max_pages_per_seq)
        while self.slots[slot_idx].req is req and len(slot.pages) < need:
            short = need - len(slot.pages)
            if self.allocator.available() < short:
                victim = max(
                    (i for i, s in enumerate(self.slots) if s.req is not None),
                    key=lambda i: self.slots[i].seq,
                )
                self._preempt(victim)
                continue
            slot.pages.extend(self.allocator.alloc(short))
            touched[slot_idx] = slot.pages

    def _ensure_capacity(self, delta: int) -> None:
        """Optimistic admission's growth, before every decode step or
        speculation round: each decoding lane, oldest first (so the oldest
        is never starved by younger arrivals), gets pages for its next
        ``delta`` positions. A no-op under reserve admission."""
        if self.admission != "optimistic":
            return
        touched: Dict[int, List[int]] = {}
        # Mid-prefill lanes hold their prompt's pages plus headroom and
        # write no decode positions: they do not grow, but stay victims.
        order = sorted(
            (i for i, s in enumerate(self.slots) if s.req is not None and not s.prefilling),
            key=lambda i: self.slots[i].seq,
        )
        for i in order:
            s = self.slots[i]
            if s.req is not None and not s.prefilling:  # not since preempted
                self._grow_lane(i, delta, touched)
        for i, pages in touched.items():
            if self.slots[i].req is not None:  # not lost to an older lane's growth
                self._set_row(i, pages)

    def _shed_expired(self) -> None:
        """Deadlines, at the top of every step: queued requests past
        ``deadline_s`` leave before taking a lane; active lanes retire
        keeping their partial output. Both end ``"timeout"``."""
        now = time.perf_counter()

        def expired(r: Request) -> bool:
            return r.deadline_s is not None and now - r.t_submit > r.deadline_s

        for r in [r for r in self.queue if expired(r)]:
            self.queue.remove(r)
            r.finish_reason = "timeout"
            r.t_done = now
            self.done.append(r)
            self._book_terminal(r)
            self.timed_out += 1
            if self.trace is not None:
                self.trace.emit("shed", track=r.uid, step=self.steps, where="queue_deadline")
        for i, slot in enumerate(self.slots):
            if slot.req is not None and expired(slot.req):
                slot.req.finish_reason = "timeout"
                self._retire(i)
                self.timed_out += 1

    # ------------------------------------------------------------------ API

    def _validate_prompt_len(self, n: int) -> None:
        if n == 0:
            raise ValueError("empty prompt: nothing to prefill")
        if n + 1 > self.max_len:
            raise ValueError(
                f"prompt length {n} needs at least one decode slot beyond it; "
                f"engine max_len is {self.max_len}"
            )

    def submit(self, req: Request) -> None:
        # Reject here, not at admission: a request larger than the whole
        # pool would deadlock the queue.
        self._validate_prompt_len(len(req.prompt))
        if req.sampling is not None and not isinstance(req.sampling, SamplingParams):
            raise TypeError(
                f"Request.sampling must be SamplingParams, got {type(req.sampling)}"
            )
        if self._spec is not None and len(req.prompt) + req.max_new_tokens > self.max_len:
            # A speculative window writes up to k positions past the
            # committed point; exactness needs every committed position in a
            # real cache slot, so the whole budget must fit (plain decode
            # merely overwrites the last slot past max_len).
            raise ValueError(
                f"speculative engine: prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) must fit max_len ({self.max_len})"
            )
        if self.paged:
            need = self._need_total(req)
            if need > self.allocator.capacity:
                raise ValueError(
                    f"request needs {need} pages; pool capacity is "
                    f"{self.allocator.capacity} (raise n_pages)"
                )
        if isinstance(req.uid, int):  # generate()'s auto-uids stay unique
            self._auto_uid = max(self._auto_uid, req.uid + 1)
        req.t_submit = time.perf_counter()
        if self.config.max_queue and len(self.queue) >= self.config.max_queue:
            # Load shedding: the request is terminal, so stream() yields its
            # sentinel.
            req.finish_reason = "shed"
            req.t_done = req.t_submit
            self.shed += 1
            if self.trace is not None:
                self.trace.emit("shed", track=req.uid, step=self.steps, where="queue_full")
            raise EngineOverloaded(
                f"queue full ({len(self.queue)}/{self.config.max_queue}): "
                f"request {req.uid} shed",
                queue_depth=len(self.queue),
                retry_after_hint_s=self._step_timer.percentile(50) * len(self.queue),
            )
        self.queue.append(req)

    def generate(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        *,
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        uid: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> Iterator[TokenEvent]:
        """Submit one request and stream its tokens as :class:`TokenEvent` s.

        The generator drives the engine (each ``next()`` runs engine steps
        until the request produces its next token), so other in-flight
        requests keep decoding in the same steps. ``cancel(uid)`` mid-stream
        ends it. A request the bounded queue sheds streams one
        ``finished=True, finish_reason="shed"`` sentinel (``submit()`` +
        ``stream()`` raise the typed :class:`EngineOverloaded` instead).
        """
        if uid is None:
            uid = self._auto_uid  # submit() bumps past it
        req = Request(
            uid=uid, prompt=list(prompt), max_new_tokens=max_new_tokens,
            eos_id=eos_id, sampling=sampling, deadline_s=deadline_s,
        )
        try:
            self.submit(req)
        except EngineOverloaded:
            pass  # terminal "shed": stream() yields the sentinel and ends
        return self.stream(req)

    def stream(self, req: Request) -> Iterator[TokenEvent]:
        """Yield ``req``'s tokens as they are produced, stepping the engine
        as needed; ``req`` must already be submitted to this engine.

        The final event carries ``finished=True`` and ``finish_reason`` when
        the engine knew the outcome as it booked the token (eos, budget). A
        ``cancel()`` after the last yielded token simply ends the stream. A
        request that ends without booking a final token -- shed, timed out
        or quarantined -- gets one synthetic ``finished=True`` event with
        ``token=-1``."""
        seen = 0
        sent_final = False
        while True:
            while seen < len(req.output):
                last = req.t_done > 0.0 and seen == len(req.output) - 1
                sent_final = sent_final or last
                yield TokenEvent(
                    uid=req.uid,
                    token=req.output[seen],
                    index=seen,
                    t=req.t_tokens[seen],
                    finished=last,
                    finish_reason=req.finish_reason if last else None,
                )
                seen += 1
            if req.t_done > 0.0:
                if not sent_final and req.finish_reason in _SENTINEL_REASONS:
                    yield TokenEvent(
                        uid=req.uid, token=-1, index=len(req.output),
                        t=req.t_done, finished=True,
                        finish_reason=req.finish_reason,
                    )
                return  # finished (a queue-cancelled request yields nothing)
            # The step may itself finish the request (a deadline shed of the
            # last queued request drains the engine and ends it): re-check.
            if not self.step() and not self.queue and req.t_done == 0.0:
                return  # engine drained without finishing the request

    def cancel(self, uid: int) -> bool:
        """Cancel a request mid-flight. Returns True if found.

        A queued request leaves before taking a lane; an active one retires
        at once, its pages released through ``PageAllocator.truncate``
        (leaving the allocator as if it had drained). Completed requests are
        not cancellable."""
        for r in self.queue:
            if r.uid == uid:
                self.queue.remove(r)
                r.finish_reason = "cancelled"
                r.t_done = time.perf_counter()
                self.done.append(r)
                self._book_terminal(r)
                return True
        for i, slot in enumerate(self.slots):
            if slot.req is not None and slot.req.uid == uid:
                slot.req.finish_reason = "cancelled"
                self._retire(i)
                return True
        return False

    def _admit(self) -> None:
        """Admission in scheduler order (resumes first, then requests past
        the aging bound, then policy order; ``fifo`` is submit order). Stops
        at the first request that does not fit: no head-of-line bypass."""
        if not self.queue:
            return
        ordered = self._sched.order_queue(list(self.queue), self.steps, self._is_resume)
        for req in ordered:
            free = next((i for i, s in enumerate(self.slots) if s.req is None), None)
            if free is None:
                break
            # Before _install: a monolithic prefill books the first token
            # into req.output, which would make every admission look like a
            # resume after the fact.
            resumed = self._is_resume(req)
            t_install = time.perf_counter()
            if not self._install(free, req):
                break  # pool full: wait for pages to be reclaimed
            self.queue.remove(req)
            self._sched.note_admitted(req.uid)
            if self.trace is not None:
                # ts = the pre-install instant, so the admit sorts ahead of
                # the prefill span _install just emitted.
                self.trace.emit("resume" if resumed else "admit", track=req.uid,
                                step=self.steps, ts=t_install,
                                queued_s=t_install - req.t_submit)
            self._preempted_uids.discard(req.uid)
            if not req.t_admit:
                req.t_admit = time.perf_counter()
                self._hist_qwait.observe(req.t_admit - req.t_submit)

    def _spec_step(self) -> bool:
        """One speculative iteration: draft k tokens per lane, verify all k+1
        positions in one target step, commit each lane's accepted prefix
        (plus the target's correction or bonus token), roll back the rest.

        Every committed token is the target's greedy argmax, so the stream
        is token-identical to plain greedy decode; the draft only decides
        how many of those tokens one target step yields.
        """
        dec = self._spec
        # Optimistic growth before the position snapshots: a verify window
        # writes up to k+1 positions past each lane's committed point, and a
        # preemption during growth rewrites lane state the snapshots must
        # already show.
        self._ensure_capacity(dec.controller.k + 1)
        if not any(s.req for s in self.slots):
            return True  # growth preempted every lane; re-admit next step
        pos0 = self.caches["pos"].cpu().numpy()
        tok0 = self.tokens[:, 0].cpu().numpy()
        warm0 = dec.draft_time_s + dec.verify_time_s
        # Clamp the window to the largest remaining lane budget: drafts past
        # every budget can never commit (k == 0 is a plain decode step
        # through the verify path when every lane needs exactly 1 token).
        k_want = min(dec.controller.k,
                     max(0, max(s.remaining for s in self.slots if s.req) - 1))
        fault = self._fault_row(window=k_want + 1)
        dec.trace_step = self.steps  # spec spans land on the engine lane
        with self._scope("serving_spec_round"):
            greedy, drafts, finite, self.caches, k = dec.propose_and_verify(
                self.params, self.caches, self.tokens, k_want,
                fault=None if fault is None else torch.as_tensor(fault, device=self.device))
        self.steps += 1
        now = time.perf_counter()
        new_pos = pos0.copy()
        next_tok = tok0.copy()
        round_committed = round_acc = round_prop = 0
        to_retire = []
        faulted: List[Request] = []
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue  # idle lanes drafted/verified into the trash page or own rows
            if not bool(finite[i]):
                # Nonfinite verify logits: commit nothing (the whole window
                # is suspect), leave the position at the round start; other
                # lanes are unaffected (the flag is per lane).
                slot.req.finish_reason = "error"
                faulted.append(slot.req)
                to_retire.append(i)
                continue
            usable = min(k, slot.remaining - 1)  # drafts that could commit
            commit, n_acc = spec_mod.committed_tokens(drafts[i], greedy[i], k)
            used = 0
            done = False
            for t in commit:
                self._hist_itl.observe(now - slot.req.t_tokens[-1])  # in-round gaps: 0.0
                slot.req.output.append(int(t))
                slot.req.t_tokens.append(now)
                self.decoded_tokens += 1
                slot.remaining -= 1
                used += 1
                if slot.req.eos_id is not None and int(t) == slot.req.eos_id:
                    slot.req.finish_reason = "eos"
                    done = True  # eos mid-window: drop the tail
                    break
                if slot.remaining <= 0:
                    slot.req.finish_reason = "length"
                    done = True  # budget mid-window: drop the tail
                    break
            # Acceptance counts the drafts that could commit: window tails
            # past a lane's budget measure nothing.
            dec.book_lane(min(n_acc, usable), used, usable)
            round_committed += used
            round_acc += min(n_acc, usable)
            round_prop += usable
            # Rollback: rewind the lane to its committed position (its pages
            # all stay owned; only retirement releases them).
            new_pos[i] = pos0[i] + used
            next_tok[i] = commit[used - 1]
            if done:
                to_retire.append(i)
        dec.end_round(round_acc, round_prop)
        self.caches["pos"] = kvc.rewind_positions(self.caches["pos"], new_pos)
        self.tokens = torch.as_tensor(next_tok, dtype=torch.int32,
                                      device=self.device)[:, None]
        for i in to_retire:
            self._retire(i)
        for r in faulted:
            self._note_fault(r)
        # The engine's decode time mirrors the draft + verify time, so
        # decode_tok_per_s stays the generation throughput under speculation.
        self.decode_time_s += (dec.draft_time_s + dec.verify_time_s) - warm0
        return True

    def step(self) -> bool:
        """One engine iteration, inside the watchdog: shed expired deadlines,
        admit from the queue, run this step's prefill chunks, grow optimistic
        lanes (preempting on exhaustion), decode one token for every
        decoding lane (or run one speculation round), retire finished lanes.
        False when idle."""
        t0 = time.perf_counter()
        self._step_timer.start()
        try:
            out = self._step_impl()
        finally:
            self._hist_step.observe(self._step_timer.stop())
        if self.trace is not None:
            self.trace.emit("step", ts=t0, dur=time.perf_counter() - t0, step=self.steps,
                            active=sum(1 for s in self.slots if s.req is not None),
                            queued=len(self.queue))
        if self._heartbeat is not None:
            active = sum(1 for s in self.slots if s.req is not None)
            self._heartbeat.beat(self.steps, {"active": active, "queued": len(self.queue)},
                                 force=not out and not self.queue)
        if (self._drift is not None and out and self.steps != self._drift_last_step
                and self.steps % self.config.drift_every == 0):
            self._drift_last_step = self.steps
            self._drift_sample()
        return out

    def _pool_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(page, row) of the position each lane's next decode step writes:
        the rows a decode step over the live batch appends to every layer's
        pool (idle and mid-prefill lanes write the trash page)."""
        ps = self.page_size
        table = self.caches["table"]
        lin = torch.clamp(self.caches["pos"].long(), 0, table.shape[1] * ps - 1)
        page = torch.gather(table.long(), 1, (lin // ps)[:, None])[:, 0]
        return page, lin % ps

    def _drift_sample(self) -> None:
        """One monitoring forward: a decode step over the live batch with a
        drift collector active, so the ``core.tap`` sites in ``layers.dense``
        feed the monitor. Its logits are discarded. On the card the step
        appends its K/V rows to the pools in place, so the rows it writes (one
        per lane and layer) are read before and written back after: every
        pool byte and the lane positions are as they were. An unpaged engine
        runs the step on a copy of its caches. Runs after the
        watchdog's timed window; the first failure disables the monitor for
        the engine's lifetime."""
        if self._drift_broken:
            return
        if not any(s.req is not None and not s.prefilling for s in self.slots):
            return  # nothing decoding: the batch rows are all garbage
        if not self.paged:
            # The dense caches' rows are written in place: the monitoring
            # step runs on a copy of them.
            copy = {"layers": [_clone_tree(layer) for layer in self.caches["layers"]],
                    "pos": self.caches["pos"].clone()}

            def forward_copy():
                with torch.no_grad():
                    T.decode_step(self.params, self.tokens, copy, self.cfg,
                                  mode=self.matmul_mode)

            try:
                self._drift.sample(forward_copy)
            except Exception as e:  # telemetry never takes the serving loop down
                self._drift_broken = True
                _LOG.warning("quant-drift monitor disabled: %s", e)
            return
        page, row = self._pool_rows()
        pools = [layer["attn"] for layer in self.caches["layers"]]
        saved = [{key: t[page, :, row].clone() for key, t in pool.items()} for pool in pools]

        def forward():
            with torch.no_grad():
                T.decode_step(self.params, self.tokens, self.caches, self.cfg,
                              mode=self.matmul_mode)

        try:
            self._drift.sample(forward)
        except Exception as e:  # telemetry never takes the serving loop down
            self._drift_broken = True
            _LOG.warning("quant-drift monitor disabled: %s", e)
        finally:
            for pool, rows in zip(pools, saved):
                for key, t in pool.items():
                    t[page, :, row] = rows[key]

    def _step_impl(self) -> bool:
        self._shed_expired()
        self._admit()
        if self.chunked:
            # Budgeted prefill first; the decode lanes then step in the same
            # iteration, so one step's chunks are the most a token waits.
            self._run_chunk_plan()
        if not any(s.req is not None for s in self.slots):
            return False
        if not any(s.req is not None and not s.prefilling for s in self.slots):
            return True  # a prefill-only step
        # Speculation needs every lane greedy and decoding: a round with a
        # sampled lane is a plain sampled step (greedy lanes keep their
        # argmax tokens), and a mid-prefill lane would draft through its
        # trash row.
        if (self._spec is not None and not self._active_sampled()
                and not any(s.prefilling for s in self.slots)):
            return self._spec_step()
        self._ensure_capacity(1)  # the decode writes one position per lane
        if not any(s.req is not None and not s.prefilling for s in self.slots):
            return True  # growth preempted every lane; re-admit next step
        sampled = self._active_sampled()
        n_active = sum(1 for s in self.slots if s.req is not None and not s.prefilling)
        fault = self._fault_row()
        t0 = time.perf_counter()
        with torch.no_grad(), self._scope("serving_decode_step"):
            pos = self.caches["pos"]  # each lane's consumed position
            logits, self.caches = T.decode_step(
                self.params, self.tokens, self.caches, self.cfg, mode=self.matmul_mode
            )
            if fault is not None:  # the injection hook: NaN on poisoned lanes
                logits = logits + torch.as_tensor(fault, device=self.device)[:, None]
            finite = torch.isfinite(logits).all(dim=-1)
            if sampled:
                nxt = sampling_mod.sample_tokens(logits, self._samp_device(), pos)[:, None]
            else:  # greedy-only steps never reach the sampler
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        self.steps += 1
        nxt_np = nxt.cpu().numpy()  # sync point: the decode step has retired
        finite_np = finite.cpu().numpy()
        now = time.perf_counter()
        self.decode_time_s += now - t0
        if self.trace is not None:
            self.trace.emit("decode_step", ts=t0, dur=now - t0, step=self.steps,
                            lanes=n_active)
        faulted: List[Request] = []
        for i, slot in enumerate(self.slots):
            if slot.req is None or slot.prefilling:
                continue  # mid-prefill lanes decoded into the trash page
            if not bool(finite_np[i]):
                # Nonfinite logits: book nothing, free the lane; neighbour
                # lanes are unaffected (the flag is per lane).
                slot.req.finish_reason = "error"
                faulted.append(slot.req)
                self._retire(i)
                continue
            tok = int(nxt_np[i, 0])
            self._hist_itl.observe(now - slot.req.t_tokens[-1])
            slot.req.output.append(tok)
            slot.req.t_tokens.append(now)
            self.decoded_tokens += 1
            slot.remaining -= 1
            if slot.req.eos_id is not None and tok == slot.req.eos_id:
                slot.req.finish_reason = "eos"
                self._retire(i)
            elif slot.remaining <= 0:
                slot.req.finish_reason = "length"
                self._retire(i)
        self.tokens = nxt
        for r in faulted:
            self._note_fault(r)
        return True

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until the queue and the lanes drain (or the step budget).
        ``EngineConfig.profile_dir`` wraps the drive in a ``torch.profiler``
        window."""
        self.start_profile()
        try:
            for _ in range(max_steps):
                if not self.step() and not self.queue:
                    break
        finally:
            self.stop_profile()
        return self.done

    def start_profile(self) -> None:
        """Open a ``torch.profiler`` window (CPU activity, and CUDA activity
        on the card) that writes a Chrome trace into
        ``EngineConfig.profile_dir`` when it closes; a no-op when unset or
        already open. A profiler that cannot start is logged, never raised:
        it must not take the serving loop down."""
        if not self.config.profile_dir or self._profiler is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.config.profile_dir))
            prof.start()
        except Exception as e:
            _LOG.warning("torch profiler window not opened: %s", e)
            return
        self._profiler = prof

    def stop_profile(self) -> None:
        """Close the window :meth:`start_profile` opened (writing its trace)."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        try:
            prof.stop()
        except Exception as e:
            _LOG.warning("torch profiler window not closed: %s", e)

    def _refresh_gauges(self) -> None:
        """Mirror point-in-time engine state into registry gauges, so the
        Prometheus text, the snapshots and the stats view read one source.
        Counters and histograms book live at their event sites; readings of
        live structures (pool occupancy, queue depth, rolling step
        percentiles, the scheduler's counters) refresh here, at read
        time."""
        m = self.metrics
        alloc = self.allocator
        m.gauge("engine_queue_depth", "requests waiting for a lane").set(len(self.queue))
        m.gauge("engine_active_lanes", "lanes holding a request").set(
            sum(1 for s in self.slots if s.req is not None))
        m.gauge("engine_step_p50_ms", "rolling step-time p50").set(
            self._step_timer.percentile(50) * 1e3)
        m.gauge("engine_step_p95_ms", "rolling step-time p95").set(
            self._step_timer.percentile(95) * 1e3)
        m.gauge("engine_step_stalled", "watchdog straggler flag").set(
            1.0 if self._step_timer.is_straggling else 0.0)
        m.gauge("kv_pages_capacity", "page-pool capacity").set(
            float(alloc.capacity) if alloc else 0.0)
        m.gauge("kv_pages_in_use", "pages currently owned by lanes").set(
            float(alloc.in_use()) if alloc else 0.0)
        m.gauge("kv_pages_cached", "prefix-cache pages (reclaimable)").set(
            float(alloc.cached_pages()) if alloc else 0.0)
        m.gauge("kv_pages_peak", "peak pages in use").set(
            float(alloc.peak_in_use) if alloc else 0.0)
        m.gauge("kv_pool_occupancy", "in-use fraction of the pool").set(
            alloc.in_use() / alloc.capacity if alloc else 0.0)
        m.gauge("kv_pool_peak_occupancy", "peak in-use fraction").set(
            alloc.peak_in_use / alloc.capacity if alloc else 0.0)
        m.gauge("prefix_hit_rate", "prefix-cache page hit rate").set(
            alloc.hit_rate() if alloc else 0.0)
        m.gauge("prefix_hit_pages", "prefix-cache pages reused").set(
            float(alloc.prefix_hit_pages) if alloc else 0.0)
        m.gauge("sched_chunks", "prefill chunk calls planned").set(float(self._sched.chunks))
        m.gauge("sched_budget_limited_steps", "steps where the prefill budget bound").set(
            float(self._sched.budget_limited_steps))
        m.gauge("sched_aging_promotions", "requests promoted by the aging bound").set(
            float(self._sched.aging_promotions))
        m.gauge("sched_peak_step_prefill_tokens", "max prefill tokens in one step").set(
            float(self._sched.peak_step_tokens))
        if self._spec is not None:
            m.gauge("spec_acceptance_rate", "draft-token acceptance rate (EMA source)").set(
                self._spec.acceptance_rate)
        if self.trace is not None:
            m.gauge("trace_events", "span events currently in the ring").set(
                float(len(self.trace)))
            m.gauge("trace_dropped", "span events aged out of the bounded ring").set(
                float(self.trace.dropped))
        m.gauge("kv_bytes_per_token", "per-token KV cache footprint across all layers").set(
            float(kvc.kv_bytes_per_token(self.cfg)) if self.paged else 0.0)
        m.gauge("kv_pool_capacity_tokens", "page-pool capacity expressed in tokens").set(
            float(alloc.capacity * self.page_size) if alloc else 0.0)
        if self._drift is not None:
            self._drift.publish(m)

    def metrics_text(self) -> str:
        """Prometheus text exposition of the engine's registry (gauges
        refreshed first)."""
        self._refresh_gauges()
        return self.metrics.prometheus_text()

    def metrics_snapshot(self) -> dict:
        """JSON-safe nested registry snapshot (one JSONL line per call)."""
        self._refresh_gauges()
        return self.metrics.snapshot()

    def drift_report(self) -> dict:
        """Per-site drift diagnostics ({} when ``drift_every`` is off)."""
        return self._drift.report() if self._drift is not None else {}

    def _attn_step_ms(self) -> float:
        """Probe the decode-attention hot path: the best of 3 warm calls
        (after one warm-up) of layer 0's ``attention_decode`` (its
        projections and B2) at positions ``max_len // 2`` on every lane,
        over the live page table, in ms: CUDA events on the card, the host
        clock on the CPU. An instrument, not an average over the run, at a
        fixed position so that runs compare. The call appends its K/V rows
        into the pool it is given (in place on the card), so it runs on a
        copy of layer 0's pool: the live pools, positions and allocator are
        untouched. The input is zeros in bfloat16, the serving activations'
        dtype. 0.0 when the probe is off or the engine unpaged."""
        if not self.attn_probe:
            return 0.0
        p0 = T.layer_params(self.params, 0)["attn"]
        pool = {k: t.clone() for k, t in self.caches["layers"][0]["attn"].items()}
        table = self.caches["table"]
        pos = torch.full((self.max_batch,), self.max_len // 2, dtype=torch.int32,
                         device=self.device)
        x = torch.zeros((self.max_batch, 1, self.cfg.d_model), dtype=torch.bfloat16,
                        device=self.device)

        def call():
            T.attention_decode(p0, x, pool, pos, self.cfg, table=table, mode=self.matmul_mode)

        cuda = self.device.type == "cuda"
        best = float("inf")
        with torch.no_grad():
            call()  # warm
            for _ in range(3):
                if cuda:
                    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0.record()
                    call()
                    t1.record()
                    t1.synchronize()
                    best = min(best, t0.elapsed_time(t1))
                else:
                    t0 = time.perf_counter()
                    call()
                    best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    def engine_stats(self) -> EngineStats:
        """The typed stats record (``stats()`` is its dict view), derived
        from the metrics registry: counts read registry counters (through
        the attribute facade), percentiles the registry histograms booked
        live at the event sites, point-in-time readings the gauges of
        :meth:`_refresh_gauges`."""
        self._refresh_gauges()
        gv = lambda name: self.metrics.gauge(name).value  # noqa: E731
        s = EngineStats(
            completed=self.completed,
            cancelled=self.cancelled,
            preempted=self.preempted,
            shed=self.shed,
            timed_out=self.timed_out,
            errors=self.errors,
            step_p50_ms=gv("engine_step_p50_ms"),
            step_p95_ms=gv("engine_step_p95_ms"),
            step_stalled=gv("engine_step_stalled"),
            decode_steps=self.steps,
            decoded_tokens=self.decoded_tokens,
            mean_latency_s=self._hist_latency.mean,
            mean_ttft_s=self._hist_ttft.mean,
            ttft_p50_s=self._hist_ttft.percentile(50),
            ttft_p95_s=self._hist_ttft.percentile(95),
            itl_p50_s=self._hist_itl.percentile(50),
            itl_p95_s=self._hist_itl.percentile(95),
            prefill_tokens=self.prefill_tokens,
            prefill_time_s=self.prefill_time_s,
            prefill_tok_per_s=(
                self.prefill_tokens / self.prefill_time_s if self.prefill_time_s else 0.0
            ),
            decode_time_s=self.decode_time_s,
            decode_tok_per_s=(
                self.decoded_tokens / self.decode_time_s if self.decode_time_s else 0.0
            ),
            prefill_calls=self.prefill_calls,
            prefill_requests=self.prefill_requests,
            prefill_calls_per_request=(
                self.prefill_calls / self.prefill_requests if self.prefill_requests else 0.0
            ),
            # Page-pool accounting: zeros when unpaged (the schema stays flat).
            kv_page_size=float(self.page_size) if self.paged else 0.0,
            kv_pages_capacity=gv("kv_pages_capacity"),
            kv_pages_in_use=gv("kv_pages_in_use"),
            kv_pages_cached=gv("kv_pages_cached"),
            kv_pages_peak=gv("kv_pages_peak"),
            kv_pool_occupancy=gv("kv_pool_occupancy"),
            kv_pool_peak_occupancy=gv("kv_pool_peak_occupancy"),
            prefix_hit_rate=gv("prefix_hit_rate"),
            prefix_hit_pages=gv("prefix_hit_pages"),
            matmul_mode=self.matmul_mode,
            kv_bits=float(self.kv_bits or 0),
            kv_bytes_per_token=gv("kv_bytes_per_token"),
            kv_pool_capacity_tokens=gv("kv_pool_capacity_tokens"),
            spec_enabled=1.0 if self._spec is not None else 0.0,
            queue_wait_p50_s=self._hist_qwait.percentile(50),
            queue_wait_p95_s=self._hist_qwait.percentile(95),
            sched_policy=self.config.sched_policy,
            sched_prefill_budget=float(self.config.prefill_budget),
            sched_chunks=gv("sched_chunks"),
            sched_budget_limited_steps=gv("sched_budget_limited_steps"),
            sched_aging_promotions=gv("sched_aging_promotions"),
            sched_peak_step_prefill_tokens=gv("sched_peak_step_prefill_tokens"),
            trace_enabled=1.0 if self.trace is not None else 0.0,
            trace_events=float(len(self.trace)) if self.trace is not None else 0.0,
            trace_dropped=float(self.trace.dropped) if self.trace is not None else 0.0,
            drift_enabled=1.0 if self._drift is not None else 0.0,
            attn_step_ms=self._attn_step_ms(),
            device=str(self.device),
        )
        if self._spec is not None:
            for k, v in self._spec.stats().items():
                setattr(s, k, v)
        if self._drift is not None:
            for k, v in self._drift.stats().items():
                setattr(s, k, float(v))
        return s

    def stats(self) -> Dict:
        """The dict view of :meth:`engine_stats`."""
        return self.engine_stats().as_dict()


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {key: _clone_tree(v) for key, v in tree.items()}
    return tree.clone()


def _install_counter_properties() -> None:
    """Install the counter attributes as registry-backed properties:
    ``eng.steps`` reads ``Counter.value`` (an int for integer-valued
    counters); ``eng.steps += 1`` goes get -> add -> set through
    ``Counter.set_``, which refuses to move a counter backwards."""

    def make(attr: str, integer: bool):
        def fget(self):
            v = self._metric_counters[attr].value
            return int(v) if integer else v

        def fset(self, v):
            self._metric_counters[attr].set_(float(v))

        return property(fget, fset)

    for attr, (_name, integer, _help) in _COUNTER_METRICS.items():
        setattr(ServingEngine, attr, make(attr, integer))


_install_counter_properties()
