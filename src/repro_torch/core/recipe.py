"""Quantization recipes: the user-facing configuration of the PTQ pipeline
(the port's copy of ``repro.core.recipe``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["QuantRecipe", "PAPER_BASELINE", "W8A8_SERVING"]


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    # Weight quantization.
    w_bits: int = 8
    w_clip: Optional[str] = None  # None/'none' | 'mse' (| 'aciq' | 'kl' later)
    ocs_ratio: float = 0.0  # weight OCS expand ratio r (ceil(r*C) splits)
    qa_split: bool = True  # quantization-aware splitting (§3.3)
    per_channel: bool = False  # beyond-paper: per-output-channel scales
    # Activation quantization (None = keep activations in float).
    a_bits: Optional[int] = None
    a_clip: Optional[str] = "mse"
    ocs_ratio_act: float = 0.0  # activation OCS ratio (§5.3)
    # Layer selection: substrings; a param path containing any is skipped
    # (the paper never quantizes the first layer; norms/scales/biases are
    # vectors; the rest name per-head SSM scalars of other archs).
    skip_patterns: Tuple[str, ...] = (
        "embed", "meta", "router", "norm", "scale", "bias", "conv",
        "a_log", "/d",
    )
    # Alignment padding of the expanded contraction dim.
    pad_to: int = 1
    # Split allocation across layers: 'uniform' = ceil(r*C) per layer.
    alloc: str = "uniform"

    def wants_weight_quant(self) -> bool:
        return self.w_bits < 32

    def wants_act_quant(self) -> bool:
        return self.a_bits is not None

    def should_skip(self, path: str) -> bool:
        p = path.lower()
        return any(s in p for s in self.skip_patterns)


# The paper's per-tensor, no-retraining baseline configuration.
PAPER_BASELINE = QuantRecipe(w_bits=8, w_clip=None, ocs_ratio=0.0, a_bits=8)

# Production serving default: W8A8, OCS r=0.02 + MSE clip, per-channel scales.
W8A8_SERVING = QuantRecipe(
    w_bits=8,
    w_clip="mse",
    ocs_ratio=0.02,
    per_channel=True,
    a_bits=8,
    a_clip="mse",
    pad_to=128,
)
