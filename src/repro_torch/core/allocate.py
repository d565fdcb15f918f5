"""Knapsack channel allocation across layers (paper §3.4), the port's copy
of ``repro.core.allocate`` (numpy; a weight may also be a torch tensor on
any device, whose per-row max is taken there and read back).

The paper's default gives every layer ``ceil(r*C)`` splits. It also tried a
"more intelligent" global allocation: *"formulates extra channel allocation
as a knapsack problem. The reward function is the percentage reduction in
the dynamic range of the distribution, and the cost is the increase in
memory size ... experimentally not better than the simple method."* The
paper omits results for space; Table 7 (``experiments/table7.py``) tests
the negative result.

Marginal-reward computation without materializing splits: splitting always
targets the channel holding the current global max |w| and replaces it with
two channels of half that max, so the sequence of post-split dynamic ranges
follows from a max-heap of per-channel maxima alone — O(k log C) per layer
for k candidate splits. Rewards are non-increasing, so global greedy by
reward/cost solves the (fractional-relaxed) knapsack exactly; the integral
gap is one split per layer.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["range_reduction_curve", "knapsack_allocate"]


def range_reduction_curve(w2d: np.ndarray, max_splits: int) -> np.ndarray:
    """Dynamic range after 0..max_splits max-channel splits. Shape [k+1]."""
    if isinstance(w2d, torch.Tensor):
        ch_max = w2d.detach().to(torch.float32).abs().amax(dim=1).cpu().numpy()
    else:
        ch_max = np.abs(np.asarray(w2d, np.float32)).max(axis=1)
    heap = [-float(m) for m in ch_max]
    heapq.heapify(heap)
    out = np.empty(max_splits + 1, np.float32)
    out[0] = -heap[0]
    for k in range(1, max_splits + 1):
        m = -heapq.heappop(heap)
        heapq.heappush(heap, -m / 2.0)
        heapq.heappush(heap, -m / 2.0)
        out[k] = -heap[0]
    return out


def _concave_blocks(cum_reward: np.ndarray) -> List[Tuple[int, float]]:
    """Upper concave envelope of (k, cum_reward): [(block_end_k, avg_reward)].

    Marginal range reductions are not monotone (tied channel maxima yield a
    zero reward followed by a positive one), so the greedy must consume
    *blocks* up to each envelope breakpoint — within a block the average
    marginal reward is what matters, and block averages are non-increasing,
    which restores greedy optimality for the fractional relaxation.
    """
    blocks: List[Tuple[int, float]] = []
    k0, r0 = 0, 0.0
    n = len(cum_reward) - 1
    while k0 < n:
        best_k, best_avg = k0 + 1, -1.0
        for k in range(k0 + 1, n + 1):
            avg = (float(cum_reward[k]) - r0) / (k - k0)
            if avg > best_avg + 1e-12:
                best_k, best_avg = k, avg
        blocks.append((best_k, best_avg))
        r0 = float(cum_reward[best_k])
        k0 = best_k
    return blocks


def _numel(w) -> int:
    return w.numel() if isinstance(w, torch.Tensor) else w.size


def knapsack_allocate(
    layers: Sequence[Tuple[str, np.ndarray]],
    ratio: float,
    *,
    max_per_layer_ratio: float = 0.25,
) -> Dict[str, int]:
    """Distribute a global memory budget of ``ratio`` x total-bytes.

    layers: (name, w2d [Cin, Cout]) pairs. Returns name -> n_splits with
    sum(splits_i * bytes_per_row_i) <= ratio * total_bytes. Greedy over
    concave-envelope blocks ranked by (range-reduction %) / (row bytes).
    """
    total_bytes = sum(_numel(w) for _, w in layers)
    budget = ratio * total_bytes

    state = {}
    heap: List[Tuple[float, str]] = []
    for name, w in layers:
        cin, cout = w.shape
        kmax = max(1, int(max_per_layer_ratio * cin))
        curve = range_reduction_curve(w, kmax)
        r0 = max(float(curve[0]), 1e-30)
        cum = (curve[0] - curve) / r0  # cumulative fractional range reduction
        blocks = _concave_blocks(cum)
        state[name] = {"blocks": blocks, "i": 0, "k": 0, "cost": cout}
        if blocks:
            heapq.heappush(heap, (-(blocks[0][1] / cout), name))

    alloc: Dict[str, int] = {name: 0 for name, _ in layers}
    spent = 0.0
    while heap:
        _, name = heapq.heappop(heap)
        st = state[name]
        end_k, _avg = st["blocks"][st["i"]]
        n_new = end_k - st["k"]
        block_cost = n_new * st["cost"]
        if spent + block_cost > budget:
            # Partial block: take as many whole splits as still fit.
            n_fit = int((budget - spent) // st["cost"])
            alloc[name] += n_fit
            spent += n_fit * st["cost"]
            continue  # this layer is done; others may still fit smaller blocks
        alloc[name] = end_k
        spent += block_cost
        st["k"] = end_k
        st["i"] += 1
        if st["i"] < len(st["blocks"]):
            heapq.heappush(
                heap, (-(st["blocks"][st["i"]][1] / st["cost"]), name)
            )
    return alloc
