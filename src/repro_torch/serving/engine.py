"""Continuous-batching paged serving engine, greedy subset (the port of
``repro.serving.engine``).

Requests are admitted FIFO into decode lanes with *reserve* admission (the
worst-case pages of prompt + budget are allocated up front, prefix hits
first); each admission prefills the prompt suffix into its pages in one
call (:func:`models.transformer.prefill_into_pages`) and books the first
token; every engine step then decodes one greedy token for all active lanes
(:func:`models.transformer.decode_step`) and retires lanes whose budget or
eos is reached. A lane whose logits go nonfinite is retired with
``finish_reason="error"``. With ``EngineConfig.spec`` set, each step is
instead one self-speculative round (``serving.spec_decode``): k draft
tokens per lane, one verify step over all k + 1 positions, each lane's
accepted prefix plus the target's token committed and the rest rolled back
by rewinding its position; the committed stream is token-identical to
plain greedy decode. Preemption, chunked prefill, sampling, tracing and
drift monitoring are later slices (ROADMAP A7, A9, A10).

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
built with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.apply import map_with_path, tree_to
from ..core.ocs import OCSQuantLinear, to_w4a8
from ..device import resolve_device
from ..kernels.paged_attention import check_layout
from ..models import transformer as T
from . import kv_cache as kvc
from . import spec_decode as spec_mod
from .config import EngineConfig

__all__ = ["Request", "ServingEngine", "FINISH_REASONS"]

FINISH_REASONS = ("eos", "length", "error")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # Filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    t_tokens: List[float] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None  # one of FINISH_REASONS


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    remaining: int = 0
    pages: List[int] = dataclasses.field(default_factory=list)


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
        if config.admission != "reserve":
            raise NotImplementedError("optimistic admission: ROADMAP A9")
        if config.prefill_budget:
            raise NotImplementedError("budgeted chunked prefill: ROADMAP A9")
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
        self.steps = 0
        self.decoded_tokens = 0
        self.completed = 0
        self.errors = 0
        self.prefill_calls = 0
        self.prefill_requests = 0
        self.prefill_tokens = 0
        self.prefill_time_s = 0.0
        self.decode_time_s = 0.0
        self._ttft: List[float] = []
        self._itl: List[float] = []
        self._latency: List[float] = []
        # Self-speculative decoding: the quantized model drafts k tokens per
        # lane under spec.draft_mode, the target verifies them in one step.
        self._spec = (spec_mod.SpecDecoder(cfg, config.spec, self.matmul_mode)
                      if config.spec is not None else None)

    # ------------------------------------------------------------- internals

    def _prefill_bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(max(b, self.page_size), self.max_len)

    def _run_prefill_paged(
        self, suffix: np.ndarray, hit_ids: List[int], new_ids: List[int]
    ) -> Tuple[int, bool]:
        """Suffix-only prefill writing K/V into the pools: one call per
        request. Returns (first generated token, finite flag)."""
        m = len(suffix)  # >= 1: admission caps prefix hits at (n-1)//page_size
        bucket = self._prefill_bucket(m)
        nb = bucket // self.page_size
        ids = np.full((nb,), kvc.TRASH_PAGE, np.int32)
        k = min(nb, len(new_ids))
        ids[:k] = new_ids[:k]
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :m] = suffix
        dev = self.device
        pools = [layer["attn"] for layer in self.caches["layers"]]
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, new_pools = T.prefill_into_pages(
                self.params, torch.as_tensor(toks, device=dev), self.cfg, pools,
                torch.as_tensor(ids, device=dev),
                length=torch.as_tensor([m], dtype=torch.int32, device=dev),
                prefix_ids=torch.as_tensor(hit_ids, dtype=torch.int32, device=dev),
                mode=self.matmul_mode,
            )
        finite = bool(torch.isfinite(logits).all())
        first = int(torch.argmax(logits[0]))  # sync: the prefill has retired
        self.prefill_time_s += time.perf_counter() - t0
        self.prefill_calls += 1
        self.prefill_requests += 1
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

    def _quarantine(self, req: Request) -> None:
        """Terminal-error a request whose prefill logits went nonfinite."""
        req.finish_reason = "error"
        req.t_done = time.perf_counter()
        self.done.append(req)
        self.errors += 1

    def _install_paged(self, slot_idx: int, req: Request) -> bool:
        """Admit ``req`` into lane ``slot_idx``. Returns False — leaving the
        request queued — only when the pool cannot hold it."""
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        self._validate_prompt_len(n)
        ps = self.page_size
        need = min(kvc.pages_needed(n + req.max_new_tokens, ps), self.max_pages_per_seq)
        # Cap prefix hits so the suffix keeps >= 1 token (the prefill must
        # still produce the first-token logits).
        max_hit = (n - 1) // ps
        if self.allocator.available() < need - max_hit:
            return False
        hit_ids, keys = self.allocator.match_prefix(prompt, max_hit)
        need_new = need - len(hit_ids)
        if self.allocator.available() < need_new:
            self.allocator.release(hit_ids)  # un-retain; stay queued
            return False
        self.allocator.note_prefix_stats(len(hit_ids), n // ps)
        new_ids = self.allocator.alloc(need_new)
        row_ids = hit_ids + new_ids
        n_hit = len(hit_ids) * ps

        first, finite = self._run_prefill_paged(prompt[n_hit:], hit_ids, new_ids)
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

        row = np.full((self.max_pages_per_seq,), kvc.TRASH_PAGE, np.int32)
        row[: len(row_ids)] = row_ids
        self.caches["table"][slot_idx] = torch.as_tensor(row, device=self.device)
        self.caches["pos"][slot_idx] = n
        self.tokens[slot_idx, 0] = first
        self.slots[slot_idx] = _Slot(
            req=req, remaining=req.max_new_tokens - 1, pages=row_ids
        )
        return True

    def _retire(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        slot.req.t_done = time.perf_counter()
        if slot.req.finish_reason is None:
            slot.req.finish_reason = "length"
        self.done.append(slot.req)
        if slot.req.finish_reason == "error":
            self.errors += 1
        else:
            self._book_terminal(slot.req)
        # Reclaim the pages and point the lane at the trash page so its dead
        # writes never land in a page the allocator hands out again.
        self.allocator.truncate(slot.pages, 0)
        self.caches["table"][slot_idx] = kvc.TRASH_PAGE
        self.caches["pos"][slot_idx] = 0
        self.slots[slot_idx] = _Slot()

    def _validate_prompt_len(self, n: int) -> None:
        if n == 0:
            raise ValueError("empty prompt: nothing to prefill")
        if n + 1 > self.max_len:
            raise ValueError(
                f"prompt length {n} needs at least one decode slot beyond it; "
                f"engine max_len is {self.max_len}"
            )

    # ------------------------------------------------------------------ API

    def submit(self, req: Request) -> None:
        # Reject here, not at admission: a request larger than the whole
        # pool would deadlock the queue.
        self._validate_prompt_len(len(req.prompt))
        if self._spec is not None and len(req.prompt) + req.max_new_tokens > self.max_len:
            # A speculative window writes up to k positions past the
            # committed point; exactness needs every committed position in a
            # real cache slot, so the whole budget must fit (plain decode
            # merely overwrites the last slot past max_len).
            raise ValueError(
                f"speculative engine: prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) must fit max_len ({self.max_len})"
            )
        need = min(
            kvc.pages_needed(len(req.prompt) + req.max_new_tokens, self.page_size),
            self.max_pages_per_seq,
        )
        if need > self.allocator.capacity:
            raise ValueError(
                f"request needs {need} pages; pool capacity is "
                f"{self.allocator.capacity} (raise n_pages)"
            )
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        """FIFO admission; stops at the first request that does not fit (no
        head-of-line bypass)."""
        while self.queue:
            free = next((i for i, s in enumerate(self.slots) if s.req is None), None)
            if free is None:
                return
            req = self.queue[0]
            if not self._install_paged(free, req):
                return  # pool full: wait for pages to be reclaimed
            self.queue.popleft()
            req.t_admit = req.t_admit or time.perf_counter()

    def _spec_step(self) -> bool:
        """One speculative iteration: draft k tokens per lane, verify all k+1
        positions in one target step, commit each lane's accepted prefix
        (plus the target's correction or bonus token), roll back the rest.

        Every committed token is the target's greedy argmax, so the stream
        is token-identical to plain greedy decode; the draft only decides
        how many of those tokens one target step yields.
        """
        dec = self._spec
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
        """One engine iteration: admit from the queue, decode one token for
        every active lane (or run one speculation round), retire finished
        lanes. False when idle."""
        self._admit()
        if not any(s.req is not None for s in self.slots):
            return False
        if self._spec is not None:
            return self._spec_step()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, self.caches = T.decode_step(
                self.params, self.tokens, self.caches, self.cfg, mode=self.matmul_mode
            )
            finite = torch.isfinite(logits).all(dim=-1)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        self.steps += 1
        nxt_np = nxt.cpu().numpy()  # sync point: the decode step has retired
        finite_np = finite.cpu().numpy()
        now = time.perf_counter()
        self.decode_time_s += now - t0
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
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

    def stats(self) -> Dict:
        """Counters and latencies under the reference's stats names (the
        subset this engine has; there is no jit, so no compile time)."""
        alloc = self.allocator
        cap = alloc.capacity
        return {
            "completed": self.completed,
            "errors": self.errors,
            "decode_steps": self.steps,
            "decoded_tokens": self.decoded_tokens,
            "mean_latency_s": float(np.mean(self._latency)) if self._latency else 0.0,
            "mean_ttft_s": float(np.mean(self._ttft)) if self._ttft else 0.0,
            "ttft_p50_s": _percentile(self._ttft, 50),
            "ttft_p95_s": _percentile(self._ttft, 95),
            "itl_p50_s": _percentile(self._itl, 50),
            "itl_p95_s": _percentile(self._itl, 95),
            "prefill_tokens": self.prefill_tokens,
            "prefill_time_s": self.prefill_time_s,
            "prefill_tok_per_s": (
                self.prefill_tokens / self.prefill_time_s if self.prefill_time_s else 0.0
            ),
            "decode_time_s": self.decode_time_s,
            "decode_tok_per_s": (
                self.decoded_tokens / self.decode_time_s if self.decode_time_s else 0.0
            ),
            "prefill_calls": self.prefill_calls,
            "prefill_requests": self.prefill_requests,
            "kv_page_size": float(self.page_size),
            "kv_pages_capacity": float(cap),
            "kv_pages_in_use": float(alloc.in_use()),
            "kv_pages_cached": float(alloc.cached_pages()),
            "kv_pages_peak": float(alloc.peak_in_use),
            "kv_pool_occupancy": alloc.in_use() / cap if cap else 0.0,
            "kv_pool_peak_occupancy": alloc.peak_in_use / cap if cap else 0.0,
            "prefix_hit_rate": alloc.hit_rate(),
            "prefix_hit_pages": float(alloc.prefix_hit_pages),
            "matmul_mode": self.matmul_mode,
            "kv_bits": float(self.kv_bits or 0),
            "kv_bytes_per_token": float(kvc.kv_bytes_per_token(self.cfg)),
            "device": str(self.device),
            "spec_enabled": 1.0 if self._spec is not None else 0.0,
            **(self._spec.stats() if self._spec is not None else {
                key: 0.0 for key in spec_mod.SPEC_STATS}),
        }
