"""Self-speculative decoding: the OCS-quantized model is its own draft (the
port of ``repro.serving.spec_decode``).

* **draft** -- the quantized fast path (``SpecConfig.draft_mode``, by
  default dynamic ``w8a8``, optionally cut to the first ``draft_layers``
  layers as an early-exit drafter) proposes ``k`` greedy tokens per decode
  lane, one single-token :func:`~repro_torch.models.transformer.decode_step`
  at a time;
* **verify** -- the target (the engine's ``matmul_mode``) scores all ``k +
  1`` positions in one :func:`~repro_torch.models.transformer.verify_step`
  against the same paged caches: B2's multi-row path and every matmul
  kernel at M = B * (k + 1);
* **commit / rollback** -- per lane, the longest prefix of proposals that
  matches the target's own greedy argmax chain is committed, plus the
  target's next token, so every committed token is the target's argmax and
  the stream is token-identical to plain greedy decode. The rejected tail
  is rolled back by rewinding the positions
  (:func:`~repro_torch.serving.kv_cache.rewind_positions`).

The drafter writes approximate K/V rows while proposing; the verify step
re-writes every proposed position at target precision, so the cache below
the committed position is what plain greedy decode would have written.

:class:`AdaptiveK` moves the live window within ``[k_min, k]`` from the
acceptance rate. Nothing is traced or compiled here (PyTorch runs eagerly),
so ``spec_compile_s`` stays 0.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T

__all__ = ["SpecConfig", "AdaptiveK", "SpecDecoder", "committed_tokens", "SPEC_STATS"]


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs (``EngineConfig.spec``).

    ``k`` is the *maximum* draft window; the adaptive controller moves the
    live window within ``[k_min, k]``. ``draft_mode`` is the matmul mode the
    drafter runs in (``w8a8`` = the fused dynamic-quant fast path; a
    ``w4a8`` engine needs ``draft_mode="w4a8"``).
    """

    k: int = 4
    k_min: int = 1
    draft_mode: str = "w8a8"
    draft_layers: Optional[int] = None  # None = all layers
    adaptive: bool = True
    grow_at: float = 0.8  # acceptance EMA above this: k += 1
    shrink_at: float = 0.4  # acceptance EMA below this: k -= 1
    ema: float = 0.8  # EMA decay for the observed acceptance rate

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec window k must be >= 1, got {self.k}")
        if not 1 <= self.k_min <= self.k:
            raise ValueError(f"need 1 <= k_min <= k, got {self.k_min}/{self.k}")
        if self.draft_layers is not None and self.draft_layers < 1:
            raise ValueError("draft_layers must be >= 1")


class AdaptiveK:
    """Shrink/grow the draft window from an EMA of the per-round fraction
    of accepted draft tokens (accepted / proposed over the active lanes)."""

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self.k = cfg.k if not cfg.adaptive else max(cfg.k_min, min(2, cfg.k))
        self.acc_ema: Optional[float] = None

    def update(self, accepted: int, proposed: int) -> int:
        if not self.cfg.adaptive or proposed <= 0:
            return self.k
        rate = accepted / proposed
        self.acc_ema = (
            rate
            if self.acc_ema is None
            else self.cfg.ema * self.acc_ema + (1.0 - self.cfg.ema) * rate
        )
        if self.acc_ema > self.cfg.grow_at and self.k < self.cfg.k:
            self.k += 1
        elif self.acc_ema < self.cfg.shrink_at and self.k > self.cfg.k_min:
            self.k -= 1
        return self.k


def committed_tokens(draft_row, greedy_row, k: int) -> Tuple[List[int], int]:
    """Greedy accept for one lane: the longest matching proposal prefix plus
    the target's next token.

    ``greedy_row[j]`` is the target's argmax after consuming the current
    token and proposals ``< j``. Returns ``(tokens to commit, n_accepted)``
    with ``len(tokens) == n_accepted + 1`` (a full miss still commits the
    target's correction, so a round never stalls).
    """
    out: List[int] = []
    for j in range(k):
        tgt = int(greedy_row[j])
        out.append(tgt)  # always the target's token
        if int(draft_row[j]) != tgt:
            return out, j
    out.append(int(greedy_row[k]))  # bonus: the target's token after a full accept
    return out, k


class SpecDecoder:
    """Draft/verify rounds and acceptance bookkeeping for one engine."""

    def __init__(self, cfg: ModelConfig, spec: SpecConfig, matmul_mode: str):
        if cfg.block not in ("dense", "moe"):
            raise ValueError(
                f"speculative decoding: attention decoders only, got {cfg.block} "
                "(SSM/hybrid decode states cannot roll back a rejected tail)"
            )
        self.cfg = cfg
        self.spec = spec
        self.matmul_mode = matmul_mode
        self.controller = AdaptiveK(spec)
        # Counters (the engine's stats() shows them).
        self.rounds = 0  # spec rounds (== target verify steps)
        self.lane_rounds = 0  # per-lane verify events
        self.proposed = 0  # draft tokens proposed (active lanes)
        self.accepted = 0  # draft tokens accepted
        self.committed = 0  # tokens committed (accepted + corrections/bonus)
        self.draft_time_s = 0.0
        self.verify_time_s = 0.0
        self.compile_s = 0.0  # nothing is compiled: stays 0
        self.draft_steps = 0  # draft decode steps (the sum of the windows)
        self.plain_rounds = 0  # rounds with k == 0: a one-token verify
        # The engine attaches its TraceRing (or leaves None) and stamps
        # trace_step before each round, so draft/verify spans land on the
        # engine lane.
        self.trace = None
        self.trace_step = 0

    def propose_and_verify(self, params, caches, tokens: torch.Tensor,
                           k: Optional[int] = None, fault: Optional[torch.Tensor] = None):
        """One speculation round over the whole decode batch.

        tokens: ``[B, 1]`` current per-lane tokens. Drafts ``k`` proposals
        per lane (default: the controller's window), rewinds ``pos`` to the
        round start, then runs one target verify step over ``[B, k+1]``
        (``k == 0`` is a plain decode step through the verify path).
        Returns ``(greedy [B, k+1], drafts [B, k], finite
        [B])`` as numpy, the caches (target K/V written for every proposed
        position, ``pos`` past the window) and ``k``; the caller commits
        per lane and rewinds ``pos``, committing nothing for a lane whose
        ``finite`` flag is False. ``fault`` (``[B]`` float32, NaN on the
        lanes the engine's fault-injection hook poisons) is added to the
        verify logits before the finite check; None adds nothing.
        """
        if k is None:
            k = self.controller.k
        cfg, spec = self.cfg, self.spec
        pos0 = caches["pos"].clone()
        t0 = time.perf_counter()
        with torch.no_grad():
            cur, drafts = tokens, []
            for _ in range(k):
                logits, caches = T.decode_step(params, cur, caches, cfg, mode=spec.draft_mode,
                                               layers_limit=spec.draft_layers)
                cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                drafts.append(cur)
            if drafts:
                draft_toks = torch.cat(drafts, dim=1)  # [B, k]
            else:
                draft_toks = torch.zeros((tokens.shape[0], 0), dtype=torch.int32,
                                         device=tokens.device)
            np_drafts = draft_toks.cpu().numpy()  # sync: the draft chain has retired
            t1 = time.perf_counter()
            # Rewind to the round start: verify re-scores (and re-writes at
            # target precision) every drafted position.
            caches["pos"] = pos0
            logits, caches = T.verify_step(params, torch.cat([tokens, draft_toks], dim=1),
                                           caches, cfg, mode=self.matmul_mode)
            if fault is not None:
                logits = logits + fault[:, None, None]
            finite = torch.isfinite(logits).all(dim=2).all(dim=1)  # [B]
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, k+1]
            np_greedy = greedy.cpu().numpy()  # sync: the verify step has retired
            np_finite = finite.cpu().numpy()
        t2 = time.perf_counter()
        self.draft_time_s += t1 - t0
        self.verify_time_s += t2 - t1
        self.rounds += 1
        self.draft_steps += k
        self.plain_rounds += k == 0
        if self.trace is not None:
            self.trace.emit("spec_draft", ts=t0, dur=t1 - t0,
                            step=self.trace_step, k=k)
            self.trace.emit("spec_verify", ts=t1, dur=t2 - t1,
                            step=self.trace_step,
                            lanes=int(tokens.shape[0]))
        return np_greedy, np_drafts, np_finite, caches, k

    def book_lane(self, n_accepted: int, n_committed: int, n_proposed: int) -> None:
        """Book one active lane's outcome for this round. ``n_proposed`` is
        the lane's *usable* window (drafts that could commit within its
        remaining budget)."""
        self.lane_rounds += 1
        self.proposed += n_proposed
        self.accepted += n_accepted
        self.committed += n_committed

    def end_round(self, accepted: int, proposed: int) -> None:
        self.controller.update(accepted, proposed)

    @property
    def k(self) -> int:
        return self.controller.k

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_target_step(self) -> float:
        return self.committed / self.lane_rounds if self.lane_rounds else 0.0

    def stats(self) -> dict:
        """The ``SPEC_STATS`` keys, ``spec_<name>`` reading attribute
        ``<name>``."""
        return {key: float(getattr(self, key[len("spec_"):])) for key in SPEC_STATS}


# The engine's ``spec_*`` stats (the reference's keys): what
# ``SpecDecoder.stats`` reports, and what an engine without speculation
# reports as 0.
SPEC_STATS = ("spec_rounds", "spec_k", "spec_proposed", "spec_accepted",
              "spec_acceptance_rate", "spec_tokens_per_target_step", "spec_draft_time_s",
              "spec_verify_time_s", "spec_compile_s")
