"""Typed serving configuration (the port of ``repro.serving.config``):
``EngineConfig`` with the fields the greedy paged path uses (speculation
included), the same defaults as the reference, and the argparse flags
generated from it (``spec`` becomes ``--spec-k`` / ``--draft-layers``).

There is no ``kernels`` field: the port dispatches by device (the CUDA
kernels on the card, their plain versions on the CPU), not by a per-engine
backend choice. Modes and policies the port has not reached yet are valid
values that :class:`~repro_torch.serving.engine.ServingEngine` refuses at
construction with ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from .spec_decode import SpecConfig

__all__ = ["EngineConfig", "add_engine_config_args", "engine_config_from_args"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level serving knobs, validated and hashable."""

    max_batch: int = dataclasses.field(
        default=8, metadata={"help": "decode lanes (continuous-batching width)"}
    )
    max_len: int = dataclasses.field(
        default=512, metadata={"help": "max prompt+decode positions per lane"}
    )
    matmul_mode: str = dataclasses.field(
        default="dequant",
        metadata={
            "help": "dequant = weight-only int8 (fused OCS matmul); w8a8 = "
            "dynamic per-row int8 activations; w4a8 = packed int4 weights "
            "with an OCS-selected outlier-channel set kept at int8",
            "choices": ["dequant", "w8a8", "w4a8"],
        },
    )
    kv_bits: Optional[int] = dataclasses.field(
        default=None,
        metadata={
            "help": "KV-cache precision: 8 = int8 rows, 4 = packed nibble "
            "pages (half the KV bytes per token of int8), 0/unset = the "
            "model config's default (float32 pages)",
            "optional_int": True,
        },
    )
    w4a8_outlier_ratio: float = dataclasses.field(
        default=0.05,
        metadata={
            "help": "w4a8: fraction of input channels kept at int8 "
            "(OCS absmax ranking; 0 = naive all-int4 weights)",
        },
    )
    page_size: int = dataclasses.field(
        default=16,
        metadata={"help": "KV page size in tokens (power of two; at least 4 on a CUDA device)"},
    )
    n_pages: Optional[int] = dataclasses.field(
        default=None,
        metadata={
            "help": "KV pool pages (0/unset = the fixed-slot footprint)",
            "optional_int": True,
        },
    )
    admission: str = dataclasses.field(
        default="reserve",
        metadata={
            "help": "paged admission: reserve = worst-case pages up front "
            "(optimistic admission is not ported yet, A9)",
            "choices": ["reserve", "optimistic"],
        },
    )
    prefill_budget: int = dataclasses.field(
        default=0,
        metadata={
            "help": "max prefill tokens per engine step (0 = monolithic "
            "prefill; chunked prefill is not ported yet, A9)",
        },
    )

    spec: Optional[SpecConfig] = dataclasses.field(
        default=None,
        metadata={"help": "self-speculative decoding", "spec": True},
    )

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_len < 2:
            raise ValueError(
                f"max_len must leave room for prompt + 1 token, got {self.max_len}"
            )
        if self.matmul_mode not in ("dequant", "w8a8", "w4a8"):
            raise ValueError(
                f"matmul_mode must be dequant|w8a8|w4a8, got {self.matmul_mode!r}"
            )
        if self.kv_bits is not None and self.kv_bits not in (4, 8):
            raise ValueError(f"kv_bits must be 4 or 8 (or unset), got {self.kv_bits}")
        if not 0.0 <= self.w4a8_outlier_ratio <= 1.0:
            raise ValueError(
                f"w4a8_outlier_ratio must be in [0, 1], got {self.w4a8_outlier_ratio}"
            )
        if self.page_size < 1 or self.page_size & (self.page_size - 1):
            raise ValueError(f"page_size must be a power of two, got {self.page_size}")
        if self.n_pages is not None and self.n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the trash page), got {self.n_pages}"
            )
        if self.admission not in ("reserve", "optimistic"):
            raise ValueError(
                f"admission must be reserve|optimistic, got {self.admission!r}"
            )
        if self.prefill_budget < 0:
            raise ValueError(f"prefill_budget must be >= 0, got {self.prefill_budget}")
        if self.spec is not None and not isinstance(self.spec, SpecConfig):
            raise TypeError(f"spec must be a SpecConfig, got {type(self.spec)}")
        if (self.matmul_mode == "w4a8" and self.spec is not None
                and self.spec.draft_mode != "w4a8"):
            raise ValueError(
                "matmul_mode='w4a8' serves a W4A8Linear parameter tree; a "
                f"draft_mode={self.spec.draft_mode!r} drafter cannot run it (the "
                "int8 matmul modes need the OCSQuantLinear tree): set "
                "spec.draft_mode='w4a8'"
            )

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def add_engine_config_args(
    ap: argparse.ArgumentParser, defaults: Optional[EngineConfig] = None
) -> None:
    """Add one flag per :class:`EngineConfig` field to ``ap``."""
    d = defaults or EngineConfig()
    g = ap.add_argument_group("engine", "EngineConfig fields (auto-generated)")
    for f in dataclasses.fields(EngineConfig):
        meta = f.metadata
        default = getattr(d, f.name)
        if meta.get("spec"):
            sd = default if default is not None else SpecConfig()
            g.add_argument(_flag("spec_k"), type=int,
                           default=sd.k if default is not None else 0,
                           help="self-speculative draft window (0 = off)")
            g.add_argument(_flag("draft_layers"), type=int, default=sd.draft_layers or 0,
                           help="truncate the drafter to the first L layers (0 = all)")
        elif meta.get("optional_int"):
            g.add_argument(_flag(f.name), type=int, default=default or 0,
                           help=meta.get("help"))
        else:
            g.add_argument(_flag(f.name), type=type(default), default=default,
                           choices=meta.get("choices"), help=meta.get("help"))


def engine_config_from_args(args: argparse.Namespace, **overrides) -> EngineConfig:
    """Invert :func:`add_engine_config_args`: parsed flags -> EngineConfig."""
    kw = {}
    for f in dataclasses.fields(EngineConfig):
        if f.metadata.get("spec"):
            kw[f.name] = (SpecConfig(k=args.spec_k, draft_layers=args.draft_layers or None)
                          if args.spec_k else None)
            continue
        val = getattr(args, f.name)
        kw[f.name] = (val or None) if f.metadata.get("optional_int") else val
    kw.update(overrides)
    return EngineConfig(**kw)
