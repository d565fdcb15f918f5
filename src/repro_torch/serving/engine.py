"""Continuous-batching paged serving engine (the port of
``repro.serving.engine``, its paged engine and request lifecycle).

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
  request is requeued at the head; the resume takes them back as prefix
  hits and re-prefills the committed tail past them).
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
* **stats** -- :class:`EngineStats` under the reference's field names;
  ``stats()`` returns its dict view.

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
built with ``device="cpu"``. The unpaged engine, tracing, metrics export
and drift monitoring are later slices (ROADMAP A10, A13).
"""
from __future__ import annotations

import dataclasses
import math
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
from ..runtime.health import HeartbeatMonitor, StepTimer
from . import kv_cache as kvc
from . import sampling as sampling_mod
from . import spec_decode as spec_mod
from .config import EngineConfig, SamplingParams
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
    schema v10 without the span-trace and drift fields (``trace_*``,
    ``drift_*``: their subsystems are a later slice) and without the fields
    of what the port does not have (JAX backends, jit traces and compile
    time, the kernel fallback, the attention-time probe); ``spec_compile_s``
    stays 0. ``device`` is the port's own. The dict view (:meth:`as_dict`)
    is what ``ServingEngine.stats()`` returns. Latency means and
    percentiles are nearest-rank over every observation; ``completed``
    counts successful terminals (eos/length) only."""

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

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.prefill_pos >= 0


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (0 when empty), as the reference's metrics."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))]


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
        if cfg.block != "dense" or not cfg.causal:
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense decoders (ROADMAP A13)"
            )
        if self.device.type == "cuda":  # refuse up front, not at the first decode
            check_layout(cfg.hd, config.page_size)
        if config.kv_bits is not None and config.kv_bits != cfg.kv_bits:
            cfg = dataclasses.replace(cfg, kv_bits=config.kv_bits)
        self.cfg = cfg
        self.config = config
        self.kv_bits = cfg.kv_bits
        self.params = tree_to(params, self.device)
        if config.matmul_mode == "w4a8":
            # The sub-8-bit weight tier, converted once, on the engine's
            # device.
            def to_tier(_path, leaf):
                if isinstance(leaf, OCSQuantLinear):
                    return to_w4a8(leaf, config.w4a8_outlier_ratio)
                return leaf

            self.params = map_with_path(to_tier, self.params)
        self.max_batch = config.max_batch
        self.max_len = config.max_len
        self.matmul_mode = config.matmul_mode
        self.page_size = config.page_size
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
        self.slots = [_Slot() for _ in range(self.max_batch)]
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self.tokens = torch.zeros((self.max_batch, 1), dtype=torch.int32, device=self.device)
        self.admission = config.admission
        self.steps = 0
        self.decoded_tokens = 0
        self.completed = 0
        self.cancelled = 0
        self.preempted = 0
        self.shed = 0
        self.timed_out = 0
        self.errors = 0
        self.prefill_calls = 0
        self.prefill_requests = 0
        self.prefill_tokens = 0
        self.prefill_time_s = 0.0
        self.decode_time_s = 0.0
        self._ttft: List[float] = []
        self._itl: List[float] = []
        self._latency: List[float] = []
        self._qwait: List[float] = []
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
        self._preempted_uids: set = set()  # resumes outrank policy order
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
        return min(max(b, self.page_size), self.max_len)

    def _prefill(
        self, tokens: np.ndarray, prefix_ids: List[int], page_ids: List[int],
        sp: SamplingParams, sample_pos: int,
    ) -> Tuple[int, bool]:
        """One prefill call: ``tokens`` (positions ``len(prefix_ids) *
        page_size`` on) into ``page_ids``, the pages ``prefix_ids`` read as
        the prefix. Returns (the token after the last one, drawn by ``sp`` at
        ``sample_pos``; the finite flag of its logits)."""
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
        with torch.no_grad():
            logits, new_pools = T.prefill_into_pages(
                self.params, torch.as_tensor(toks, device=dev), self.cfg, pools,
                torch.as_tensor(ids, device=dev),
                length=torch.as_tensor([m], dtype=torch.int32, device=dev),
                prefix_ids=torch.as_tensor(prefix_ids, dtype=torch.int32, device=dev),
                mode=self.matmul_mode,
            )
            finite = bool(torch.isfinite(logits).all())
            if sp.greedy:
                first = int(torch.argmax(logits[0]))  # sync: the prefill has retired
            else:
                pos = torch.as_tensor([sample_pos], dtype=torch.int32, device=dev)
                first = int(sampling_mod.sample_tokens(logits, self._samp_one(sp), pos)[0])
        self.prefill_time_s += time.perf_counter() - t0
        self.prefill_calls += 1
        self.prefill_tokens += m
        self.caches["layers"] = [{"attn": p} for p in new_pools]
        return first, finite

    def _finish_first_token(self, req: Request, first: int) -> bool:
        """Book the prefill-produced token; True if the request is already
        done (immediate eos, or a 1-token budget) and takes no lane."""
        now = time.perf_counter()
        req.t_first_token = now
        req.output.append(first)
        req.t_tokens.append(now)
        self._ttft.append(now - req.t_submit)
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
        if req.finish_reason in ("eos", "length"):
            self.completed += 1
            self._latency.append(req.t_done - req.t_submit)
        elif req.finish_reason == "cancelled":
            self.cancelled += 1
        elif req.finish_reason == "error":
            self.errors += 1

    def _quarantine(self, req: Request) -> None:
        """Terminal-error a request whose prefill logits went nonfinite."""
        req.finish_reason = "error"
        req.t_done = time.perf_counter()
        self.done.append(req)
        self._book_terminal(req)

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
            return self._resume_paged(slot_idx, req)
        if self.chunked:
            return self._install_chunked(slot_idx, req)
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
        row_ids = hit_ids + new_ids
        self.prefill_requests += 1
        first, finite = self._prefill(prompt[len(hit_ids) * ps:], hit_ids, new_ids, sp, n - 1)
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

    def _resume_paged(self, slot_idx: int, req: Request) -> bool:
        """Re-install a request preempted mid-decode (``req.output`` holds
        its committed tokens). The full pages of its committed context,
        registered at preemption, come back as prefix hits; one prefill call
        re-writes the committed positions past them (prompt remainder and
        decoded tokens alike), and the lane decodes on from its last
        committed token. Re-prefilled rows follow prefill's numerics, not
        the decode steps' that first wrote them, so the continuation may
        part from an uninterrupted run at a near-tie."""
        n = len(req.prompt)
        m = len(req.output)
        ps = self.page_size
        pos = n + m - 1  # committed position: K/V must exist below it
        ctx = np.concatenate([np.asarray(req.prompt, np.int64),
                              np.asarray(req.output, np.int64)])
        # Every full committed page is reusable: the resume needs no logits.
        claim = self._claim_pages(ctx[:pos], pos + 1, self._need_total(req), pos // ps)
        if claim is None:
            return False
        hit_ids, new_ids, keys = claim
        row_ids = hit_ids + new_ids
        h = len(hit_ids) * ps
        if h < pos:
            _, finite = self._prefill(ctx[h:pos], hit_ids, new_ids, _GREEDY, pos - 1)
            if not finite:
                self.allocator.release(row_ids)
                self._quarantine(req)
                return True
        # (Re-)publish the full committed pages; pages still registered from
        # the preemption win (first writer wins).
        for j in range(len(hit_ids), pos // ps):
            self.allocator.register(keys[j], row_ids[j])
        self._start_decoding(slot_idx, _Slot(req=req, remaining=req.max_new_tokens - m,
                                             pages=row_ids, seq=self._install_seq),
                             pos, int(req.output[-1]), req.sampling or _GREEDY)
        self._install_seq += 1
        return True

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
        ps = self.page_size
        # The final chunk must keep >= 1 token.
        claim = self._claim_pages(prompt, n, self._need_total(req), (n - 1) // ps)
        if claim is None:
            return False
        hit_ids, new_ids, keys = claim
        self.allocator.note_prefix_stats(len(hit_ids), n // ps)
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
            if self.slots[slot_idx].prefilling:  # not quarantined this step
                self._run_chunk_paged(slot_idx, grant)

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
        first, finite = self._prefill(prompt[start:end], slot.pages[:p0], slot.pages[p0:],
                                      sp, n - 1)
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
        self.done.append(slot.req)
        self._book_terminal(slot.req)
        # Reclaim the pages (retirement is truncate to 0 tokens; cancel rides
        # the same path) and point the lane at the trash page so its dead
        # writes never land in a page the allocator hands out again.
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
        if not slot.prefilling:
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
            if not self._install(free, req):
                break  # pool full: wait for pages to be reclaimed
            self.queue.remove(req)
            self._sched.note_admitted(req.uid)
            self._preempted_uids.discard(req.uid)
            if not req.t_admit:
                req.t_admit = time.perf_counter()
                self._qwait.append(req.t_admit - req.t_submit)

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
        greedy, drafts, finite, self.caches, k = dec.propose_and_verify(
            self.params, self.caches, self.tokens, k_want)
        self.steps += 1
        now = time.perf_counter()
        new_pos = pos0.copy()
        next_tok = tok0.copy()
        round_committed = round_acc = round_prop = 0
        to_retire = []
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue  # idle lanes drafted/verified into the trash page
            if not bool(finite[i]):
                # Nonfinite verify logits: commit nothing (the whole window
                # is suspect), leave the position at the round start; other
                # lanes are unaffected (the flag is per lane).
                slot.req.finish_reason = "error"
                to_retire.append(i)
                continue
            usable = min(k, slot.remaining - 1)  # drafts that could commit
            commit, n_acc = spec_mod.committed_tokens(drafts[i], greedy[i], k)
            used = 0
            done = False
            for t in commit:
                self._itl.append(now - slot.req.t_tokens[-1])  # in-round gaps: 0.0
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
        self._step_timer.start()
        try:
            out = self._step_impl()
        finally:
            self._step_timer.stop()
        if self._heartbeat is not None:
            active = sum(1 for s in self.slots if s.req is not None)
            self._heartbeat.beat(self.steps, {"active": active, "queued": len(self.queue)},
                                 force=not out and not self.queue)
        return out

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
        t0 = time.perf_counter()
        with torch.no_grad():
            pos = self.caches["pos"]  # each lane's consumed position
            logits, self.caches = T.decode_step(
                self.params, self.tokens, self.caches, self.cfg, mode=self.matmul_mode
            )
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
        for i, slot in enumerate(self.slots):
            if slot.req is None or slot.prefilling:
                continue  # mid-prefill lanes decoded into the trash page
            if not bool(finite_np[i]):
                # Nonfinite logits: book nothing, free the lane; neighbour
                # lanes are unaffected (the flag is per lane).
                slot.req.finish_reason = "error"
                self._retire(i)
                continue
            tok = int(nxt_np[i, 0])
            self._itl.append(now - slot.req.t_tokens[-1])
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
        return True

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until the queue and the lanes drain (or the step budget)."""
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self.done

    def engine_stats(self) -> EngineStats:
        """The typed stats record (``stats()`` is its dict view)."""
        alloc = self.allocator
        cap = alloc.capacity
        sched = self._sched
        s = EngineStats(
            completed=self.completed,
            cancelled=self.cancelled,
            preempted=self.preempted,
            shed=self.shed,
            timed_out=self.timed_out,
            errors=self.errors,
            step_p50_ms=self._step_timer.percentile(50) * 1e3,
            step_p95_ms=self._step_timer.percentile(95) * 1e3,
            step_stalled=1.0 if self._step_timer.is_straggling else 0.0,
            decode_steps=self.steps,
            decoded_tokens=self.decoded_tokens,
            mean_latency_s=float(np.mean(self._latency)) if self._latency else 0.0,
            mean_ttft_s=float(np.mean(self._ttft)) if self._ttft else 0.0,
            ttft_p50_s=_percentile(self._ttft, 50),
            ttft_p95_s=_percentile(self._ttft, 95),
            itl_p50_s=_percentile(self._itl, 50),
            itl_p95_s=_percentile(self._itl, 95),
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
            kv_page_size=float(self.page_size),
            kv_pages_capacity=float(cap),
            kv_pages_in_use=float(alloc.in_use()),
            kv_pages_cached=float(alloc.cached_pages()),
            kv_pages_peak=float(alloc.peak_in_use),
            kv_pool_occupancy=alloc.in_use() / cap if cap else 0.0,
            kv_pool_peak_occupancy=alloc.peak_in_use / cap if cap else 0.0,
            prefix_hit_rate=alloc.hit_rate(),
            prefix_hit_pages=float(alloc.prefix_hit_pages),
            matmul_mode=self.matmul_mode,
            kv_bits=float(self.kv_bits or 0),
            kv_bytes_per_token=float(kvc.kv_bytes_per_token(self.cfg)),
            kv_pool_capacity_tokens=float(cap * self.page_size),
            spec_enabled=1.0 if self._spec is not None else 0.0,
            queue_wait_p50_s=_percentile(self._qwait, 50),
            queue_wait_p95_s=_percentile(self._qwait, 95),
            sched_policy=self.config.sched_policy,
            sched_prefill_budget=float(self.config.prefill_budget),
            sched_chunks=float(sched.chunks),
            sched_budget_limited_steps=float(sched.budget_limited_steps),
            sched_aging_promotions=float(sched.aging_promotions),
            sched_peak_step_prefill_tokens=float(sched.peak_step_tokens),
            device=str(self.device),
        )
        if self._spec is not None:
            for k, v in self._spec.stats().items():
                setattr(s, k, v)
        return s

    def stats(self) -> Dict:
        """The dict view of :meth:`engine_stats`."""
        return self.engine_stats().as_dict()
