"""Where a decode step's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--arch glm4-9b] [--layers N] [--matmul-mode {dequant,w8a8,w4a8} ...] \
        [--paged {auto,on,off}]

Builds ``--arch`` (glm4-9b by default; deepseek-moe-16b, mamba2-1.3b,
hymba-1.5b and the other registry archs too) at full width (``--layers``
deep, the arch's published depth by default; random weights from
``--seed``, each leaf drawn and quantized before the next), quantizes it
with the serving launcher's recipe and serves 8 requests (16-256-token
prompts; 16-64 on a Mamba2 or hymba model, whose prompts replay through
the decode step a token at a time) with ``EngineConfig(max_batch=8,
max_len=512, matmul_mode=--matmul-mode, paged=--paged)``: ``dequant`` (the
default) on float32 KV, ``w8a8`` on int8 KV, ``w4a8`` (the engine converts
the tree to W4A8 leaves) on int4 pages, or on float32 KV when the engine is
unpaged (the dense cache has no int4 layout); several modes are profiled
in turn on the one quantized tree. The
first engine step (admission, 8 prefills, one decode) runs unprofiled; the
next ``--steps`` decode steps run under ``torch.profiler`` (CPU + CUDA
activity). Prints the device time and the device operations (kernel
launches, memsets) per kernel family (the hand-written kernels' launches
and every other kernel) and the device busy share of the profiled wall
time; writes the same as JSON to ``--out``. Profiling adds host overhead:
its step time is not the serving number (``chip_smoke.py`` measures that
unprofiled).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config, list_archs
from ..core.apply import quantize_params
from ..core.recipe import QuantRecipe
from ..device import resolve_device
from ..models import transformer as T
from ..serving import EngineConfig, Request, ServingEngine

# Kernel families by (mangled) kernel name substrings, the first match wins.
FAMILIES = (
    ("fused_qmatmul: row_quant", ("row_quant_kernel",)),
    ("w4a8_qmatmul: prologue", ("w4a8_prologue_kernel",)),
    ("int4_gemm (w4a8_qmatmul before its tensor cores)", ("int4_gemm_kernel",)),
    ("i8_tc_gemm (fused_qmatmul, int8 tensor cores, epilogue fused)", ("i8_tc_gemm_kernel",)),
    ("w4_tc_gemm (w4a8_qmatmul's int4 and outlier stages, int8 tensor cores, epilogue fused)",
     ("w4_tc_gemm_kernel",)),
    ("int8_gemm (quant_/ocs_matmul int8; w4a8_qmatmul's outlier rows before its tensor cores)",
     ("int8_gemm_kernel",)),
    ("wo_tc_gemm (quant_matmul, bf16 tensor cores; its prefill tile too)",
     ("wo_tc_gemm_kernel", "wo_tc_prefill_kernel")),
    ("wo_gemm (ocs_matmul; quant_matmul's f32 x)", ("wo_gemm_kernel",)),
    ("epilogue", ("epilogue_kernel",)),
    ("paged_attention (append, chunks, merge)",
     ("append_kernel", "chunk_attention_kernel", "merge_kernel")),
    ("memset (int8 workspace)", ("Memset",)),
)


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_steps(eng, steps: int) -> dict:
    """Profile ``steps`` engine steps of ``eng`` (already past its first
    step) under ``torch.profiler``: wall ms a step, device ms and device
    operations a step per kernel family, the busy share, the largest other
    kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels, memsets): a CPU op's self device
    # time repeats the time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", "")) and _self_device_us(e) > 0]
    fam = {name: 0.0 for name, _ in FAMILIES}
    ops = {name: 0 for name, _ in FAMILIES}  # device operations (launches, memsets)
    other, other_ops = 0.0, 0
    other_top = []
    for e in events:
        us = _self_device_us(e)
        for name, keys in FAMILIES:
            if any(key in e.key for key in keys):
                fam[name] += us
                ops[name] += e.count
                break
        else:
            other += us
            other_ops += e.count
            other_top.append((us, e.key))
    device_us = sum(fam.values()) + other
    return dict(steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
                device_ms_per_step={k: v / steps / 1e3 for k, v in fam.items()},
                other_ms_per_step=other / steps / 1e3,
                device_ops_per_step={k: v / steps for k, v in ops.items()},
                other_ops_per_step=other_ops / steps,
                ops_per_step=(sum(ops.values()) + other_ops) / steps,
                busy_ms_per_step=device_us / steps / 1e3,
                busy_share=(device_us / wall_us) if wall_us else None,
                other_top=[(k, us / steps / 1e3)
                           for us, k in sorted(other_top, reverse=True)[:20]])


def report(prof: dict, label: str) -> None:
    """Print :func:`profile_steps`' result."""
    steps = prof["steps"]
    print(f"profiled {steps} decode steps ({label}): wall "
          f"{prof['wall_ms_per_step']:.2f} ms/step (profiler on)")
    busy = prof["busy_ms_per_step"]
    if busy == 0:
        print("device time: not measured (the profiler recorded no device activity)")
        return
    rows = [(k, prof["device_ms_per_step"][k], prof["device_ops_per_step"][k])
            for k in prof["device_ms_per_step"]]
    rows.append(("other kernels", prof["other_ms_per_step"], prof["other_ops_per_step"]))
    for name, ms, n in rows:
        print(f"  {name}: {ms:.3f} ms/step ({100 * ms / busy:.1f}% of device time; "
              f"{n:.0f} ops/step)")
    print(f"device busy {busy:.2f} ms/step = {100 * prof['busy_share']:.1f}% of wall; idle "
          f"{100 * (1 - prof['busy_share']):.1f}%; {prof['ops_per_step']:.0f} device "
          "operations a step")
    for key, ms in prof["other_top"][:8]:
        print(f"    other: {key[:90]}: {ms:.3f} ms/step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b", choices=list_archs())
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the arch's published depth)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--matmul-mode", nargs="+", default=["dequant"],
                    choices=["dequant", "w8a8", "w4a8"],
                    help="one or more modes, each profiled in turn on the one quantized tree "
                         "(the output file of each named after its mode when several)")
    ap.add_argument("--paged", default="auto", choices=["auto", "on", "off"],
                    help="the engine's KV cache (auto = paged on attention archs)")
    ap.add_argument("--out", default="chiprun_out/profile_decode.json")
    args = ap.parse_args(argv)
    dev = resolve_device(None)

    base = get_config(args.arch)
    cfg = dataclasses.replace(base, n_layers=args.layers or base.n_layers)
    params = T.init_params(cfg, seed=args.seed, device=dev, lazy=True)
    q = quantize_params(params, QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02,
                                            per_channel=True, pad_to=1), device=dev)
    del params
    paged = {"auto": None, "on": True, "off": False}[args.paged]
    unpaged = paged is False or (paged is None and cfg.block not in T.ATTN_BLOCKS)
    prompt_max = 256 if cfg.block in T.ATTN_BLOCKS else 64
    outs = []
    for mode in args.matmul_mode:
        kv_bits = {"dequant": None, "w8a8": 8, "w4a8": None if unpaged else 4}[mode]
        eng = ServingEngine(cfg, q, EngineConfig(max_batch=8, max_len=512, matmul_mode=mode,
                                                 kv_bits=kv_bits, page_size=16, paged=paged),
                            device=dev)
        rng = np.random.default_rng(args.seed)
        for i in range(8):
            plen = int(rng.integers(16, prompt_max + 1))
            eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, plen).tolist(),
                               max_new_tokens=args.steps + 2))
        eng.step()  # admission + prefills + the first decode, unprofiled
        torch.cuda.synchronize()
        prof = profile_steps(eng, args.steps)
        del eng
        report(prof, f"{args.arch}, {mode}, {cfg.n_layers} layers, 8 lanes")
        out = dict(arch=args.arch, layers=cfg.n_layers, matmul_mode=mode, paged=not unpaged,
                   card=torch.cuda.get_device_name(0), **prof)
        path = Path(args.out)
        if len(args.matmul_mode) > 1:
            path = path.with_name(f"{path.stem}_{mode}{path.suffix}")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        outs.append(out)
    return outs[0] if len(outs) == 1 else outs

if __name__ == "__main__":
    main()
