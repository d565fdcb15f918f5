"""Typed serving configuration (the port of ``repro.serving.config``):
per-request :class:`SamplingParams`, and ``EngineConfig`` with the fields
the engine uses (the paged or unpaged cache, speculation, admission, the
step scheduler, the bounded queue, the watchdog, and the observability
layer's span trace, profiler window and drift monitor, and the
attention-time probe), the same defaults,
help texts (the probe's names the port's own timing) and validation as
the reference, and the argparse flags
generated from it (``spec`` becomes ``--spec-k`` / ``--draft-layers``;
``trace`` a ``store_true`` flag; ``paged`` a three-state ``--paged
{auto,on,off}``). Contradicting fields raise :class:`ConfigError`.

There is no ``kernels`` field: the port dispatches by device (the CUDA
kernels on the card, their plain versions on the CPU), not by a per-engine
backend choice. Nor is there the jit compile cache (nothing is compiled).
``profile_dir`` opens a ``torch.profiler`` window where the reference
opens a ``jax.profiler`` one.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from .spec_decode import SpecConfig

__all__ = [
    "ConfigError",
    "SamplingParams",
    "EngineConfig",
    "add_engine_config_args",
    "engine_config_from_args",
]


class ConfigError(ValueError):
    """Individually valid settings that contradict each other (``kv_bits=4``
    on an unpaged engine: the dense cache has no int4 layout). Still a
    ``ValueError`` for existing handlers."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode sampling.

    The default (``temperature == 0``) is exact greedy argmax, the decode
    semantics every exactness contract of the engine is stated over.
    Non-greedy requests draw from the temperature-scaled distribution
    restricted by ``top_k`` / ``top_p``; a draw depends on ``(seed, token
    position)`` only (``serving.sampling``), so a fixed seed reproduces its
    tokens across runs and batch compositions on one device.
    """

    temperature: float = 0.0  # 0 = greedy (exact argmax)
    top_k: int = 0  # 0 = no top-k restriction
    top_p: float = 1.0  # 1 = no nucleus restriction
    seed: int = 0  # per-request seed

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


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
    paged: Optional[bool] = dataclasses.field(
        default=None,
        metadata={
            "help": "paged KV cache (auto = paged on attention archs)",
            "tri_state": True,
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
    attn_probe: bool = dataclasses.field(
        default=False,
        metadata={
            "help": "probe per-step attention time into stats().attn_step_ms "
            "(layer 0's paged attention on a copy of its pool, timed on the device)",
            "store_true": True,
        },
    )
    admission: str = dataclasses.field(
        default="reserve",
        metadata={
            "help": "paged admission policy: reserve = worst-case pages up "
            "front (never preempts); optimistic = admit on prompt pages + "
            "headroom, preempt-and-recompute the youngest lane on exhaustion",
            "choices": ["reserve", "optimistic"],
        },
    )
    admission_headroom: int = dataclasses.field(
        default=1,
        metadata={
            "help": "optimistic admission: decode pages granted beyond the "
            "prompt at install time (>= 1 so the first decode token always "
            "has a slot)",
        },
    )
    max_queue: int = dataclasses.field(
        default=0,
        metadata={
            "help": "bounded submit queue (0 = unbounded); a full queue "
            "rejects with EngineOverloaded and finish_reason='shed'",
        },
    )
    sched_policy: str = dataclasses.field(
        default="fifo",
        metadata={
            "help": "admission/chunk ordering: fifo = submit order; sjf = "
            "shortest remaining prefill first (aged requests are promoted "
            "ahead after sched_aging_steps engine steps in queue)",
            "choices": ["fifo", "sjf"],
        },
    )
    prefill_budget: int = dataclasses.field(
        default=0,
        metadata={
            "help": "max prefill tokens per engine step (0 = monolithic "
            "prefill); > 0 chunks prompts so decode lanes never wait behind "
            "a whole prompt",
        },
    )
    chunk_size: int = dataclasses.field(
        default=64,
        metadata={
            "help": "prefill chunk length in tokens (a multiple of "
            "page_size; only used when prefill_budget > 0)",
        },
    )
    sched_aging_steps: int = dataclasses.field(
        default=64,
        metadata={
            "help": "anti-starvation bound: a queued request older than this "
            "many engine steps is ordered ahead of policy order (sjf cannot "
            "starve long prompts)",
        },
    )
    heartbeat_path: str = dataclasses.field(
        default="",
        metadata={
            "help": "serving heartbeat file, written once per engine step "
            "('' = off); external watchdogs read it for liveness",
        },
    )
    heartbeat_interval_s: float = dataclasses.field(
        default=0.0,
        metadata={
            "help": "min seconds between heartbeat file writes (0 = every "
            "step); throttles the per-step atomic file replace on fast loops",
        },
    )
    trace: bool = dataclasses.field(
        default=False,
        metadata={
            "help": "record typed span events (admit / prefill_chunk / "
            "decode_step / spec / preempt / shed / ...) into a bounded "
            "host-side ring buffer; export Chrome trace JSON via "
            "ServingEngine.trace",
            "store_true": True,
        },
    )
    trace_capacity: int = dataclasses.field(
        default=8192,
        metadata={
            "help": "span-event ring capacity; the oldest events drop once "
            "full (bounded memory no matter how long the engine runs)",
        },
    )
    profile_dir: str = dataclasses.field(
        default="",
        metadata={
            "help": "torch.profiler trace output directory ('' = off); run() "
            "wraps the serving loop in a profiler window (CPU and CUDA "
            "activity, one Chrome trace file per window)",
        },
    )
    drift_every: int = dataclasses.field(
        default=0,
        metadata={
            "help": "sample quantization-drift telemetry every N engine "
            "steps (0 = off): each sample runs one eager tapped forward "
            "over the live decode batch and books per-site activation "
            "saturation against the calibrated clip grid",
        },
    )
    drift_threshold: float = dataclasses.field(
        default=4.0,
        metadata={
            "help": "drift flag: live outlier mass above this multiple of "
            "the calibrated outlier mass marks a site as drifted (> 1)",
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
        if self.kv_bits == 4 and self.paged is False:
            raise ConfigError(
                "kv_bits=4 packs nibbles into page pools; the dense cache "
                "has no int4 layout -- drop paged=False or use kv_bits=8"
            )
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
        if self.admission_headroom < 1:
            raise ValueError(
                "admission_headroom must be >= 1 (the first decode token "
                f"needs a page slot), got {self.admission_headroom}"
            )
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        if self.sched_policy not in ("fifo", "sjf"):
            raise ValueError(
                f"sched_policy must be fifo|sjf, got {self.sched_policy!r}"
            )
        if self.prefill_budget < 0:
            raise ValueError(f"prefill_budget must be >= 0, got {self.prefill_budget}")
        if self.prefill_budget:
            if self.chunk_size < 1:
                raise ValueError(
                    "chunk_size must be >= 1 when prefill_budget > 0, "
                    f"got {self.chunk_size}"
                )
            if self.prefill_budget < self.chunk_size:
                raise ValueError(
                    "prefill_budget must be >= chunk_size (each step must "
                    f"fit one chunk), got budget {self.prefill_budget} < "
                    f"chunk {self.chunk_size}"
                )
            if self.paged is not False and self.chunk_size % self.page_size:
                raise ValueError(
                    "chunk_size must be a multiple of page_size for paged "
                    f"engines, got chunk {self.chunk_size} / page "
                    f"{self.page_size}"
                )
        if self.sched_aging_steps < 1:
            raise ValueError(
                f"sched_aging_steps must be >= 1, got {self.sched_aging_steps}"
            )
        if self.heartbeat_interval_s < 0:
            raise ValueError(
                "heartbeat_interval_s must be >= 0, got "
                f"{self.heartbeat_interval_s}"
            )
        if self.trace_capacity < 1:
            raise ValueError(
                f"trace_capacity must be >= 1, got {self.trace_capacity}"
            )
        if self.drift_every < 0:
            raise ValueError(
                f"drift_every must be >= 0, got {self.drift_every}"
            )
        if self.drift_threshold <= 1.0:
            raise ValueError(
                "drift_threshold must be > 1 (a site at its calibrated "
                f"outlier mass is not drifted), got {self.drift_threshold}"
            )
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


# The three-state CLI vocabulary of an Optional[bool] field (``paged``):
# "auto" defers to the engine's per-arch default.
_TRI = {"auto": None, "on": True, "off": False}


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
        elif meta.get("store_true"):
            g.add_argument(_flag(f.name), action="store_true", default=default,
                           help=meta.get("help"))
        elif meta.get("optional_int"):
            g.add_argument(_flag(f.name), type=int, default=default or 0,
                           help=meta.get("help"))
        elif meta.get("tri_state"):
            g.add_argument(_flag(f.name), choices=sorted(_TRI),
                           default=next(k for k, v in _TRI.items() if v == default),
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
        if f.metadata.get("tri_state"):
            kw[f.name] = _TRI[val]
        else:
            kw[f.name] = (val or None) if f.metadata.get("optional_int") else val
    kw.update(overrides)
    return EngineConfig(**kw)
