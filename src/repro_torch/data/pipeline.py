"""Deterministic, shardable, restart-exact synthetic LM data pipeline (the
port's numpy copy of ``repro.data.pipeline``: every batch is bitwise the
reference's for every ``(seed, step, shard)``).

Design for 1000+ nodes: a batch is a *pure function of (seed, step, shard)*.
There is no iterator state to checkpoint beyond the integer step — restart
(or elastic re-shard to a different host count) regenerates bit-identical
global batches, because every sequence is keyed by its global position::

    global_seq_index = step * global_batch + batch_slot

Each host materializes only its slice of the global batch
(``host_id / n_hosts``), so feeding scales linearly with hosts and no data
ever crosses the network.

The token distribution is a noisy affine bigram chain over a Zipf-weighted
vocabulary — enough structure that a ~5-50M-param LM visibly learns (loss
drops well below uniform entropy) while needing no external corpus:

    next = (a * prev + b + eps) mod V   with prob 1 - eps_p,
    next ~ Zipf(V)                      otherwise.

``CalibrationSampler`` replays training batches for PTQ activation profiling
(the paper samples 512 *training* images for exactly this purpose, §5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataState", "SyntheticLM", "make_batch_iterator", "CalibrationSampler"]


@dataclasses.dataclass
class DataState:
    """Everything the checkpoint needs to resume the pipeline exactly."""

    seed: int
    step: int

    def to_dict(self) -> Dict[str, int]:
        return {"seed": int(self.seed), "step": int(self.step)}

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "DataState":
        return DataState(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLM:
    """Deterministic synthetic LM stream.

    vocab: model vocabulary (sequences use [0, vocab));
    seq_len: tokens per sequence (labels are the 1-shifted sequence);
    zipf_a: Zipf exponent for the marginal distribution.
    """

    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        zipf_a: float = 1.3,
        noise_p: float = 0.15,
    ):
        self.vocab = int(vocab)
        self.seq_len = int(seq_len)
        self.global_batch = int(global_batch)
        self.seed = int(seed)
        self.noise_p = float(noise_p)
        # Fixed chain coefficients derived from the seed (shared by all hosts).
        root = np.random.RandomState(seed ^ 0x5EED)
        self.a = int(root.randint(2, max(3, vocab - 1))) | 1  # odd -> bijective mod 2^k-ish
        self.b = int(root.randint(1, vocab))
        # Zipf weights for the noise marginal (truncated, normalized).
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        w = ranks ** (-zipf_a)
        self.zipf_p = w / w.sum()

    def _gen_sequence(self, global_index: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 1_000_003 + global_index) % (2**31))
        n = self.seq_len + 1
        out = np.empty(n, dtype=np.int64)
        out[0] = rng.randint(self.vocab)
        noise = rng.rand(n) < self.noise_p
        zipf_draws = rng.choice(self.vocab, size=n, p=self.zipf_p)
        for t in range(1, n):
            if noise[t]:
                out[t] = zipf_draws[t]
            else:
                out[t] = (self.a * out[t - 1] + self.b) % self.vocab
        return out

    def batch_at(
        self, step: int, *, host_id: int = 0, n_hosts: int = 1
    ) -> Dict[str, np.ndarray]:
        """Host-local slice of the global batch for ``step`` (pure function)."""
        if self.global_batch % n_hosts:
            raise ValueError(f"batch {self.global_batch} not divisible by {n_hosts}")
        per = self.global_batch // n_hosts
        lo = host_id * per
        seqs = np.stack(
            [
                self._gen_sequence(step * self.global_batch + lo + i)
                for i in range(per)
            ]
        )
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }


def make_batch_iterator(
    ds: SyntheticLM,
    state: DataState,
    *,
    host_id: int = 0,
    n_hosts: int = 1,
) -> Iterator[Tuple[DataState, Dict[str, np.ndarray]]]:
    """Yields (state-after, batch). Resuming from a checkpointed state is
    exact: the iterator is stateless beyond ``state.step``."""
    step = state.step
    while True:
        batch = ds.batch_at(step, host_id=host_id, n_hosts=n_hosts)
        step += 1
        yield DataState(seed=state.seed, step=step), batch


class CalibrationSampler:
    """Replays a fixed window of *training* batches for PTQ profiling (§5).

    The paper profiles activations on 512 training images; here we replay
    ``n_batches`` deterministic training batches (never validation data).
    """

    def __init__(self, ds: SyntheticLM, n_batches: int = 4, start_step: int = 0):
        self.ds = ds
        self.n_batches = n_batches
        self.start_step = start_step

    def __iter__(self):
        for s in range(self.start_step, self.start_step + self.n_batches):
            yield self.ds.batch_at(s)
