"""Where a decode step's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--layers 40] [--matmul-mode dequant|w8a8|w4a8]

Builds glm4-9b at full width (``--layers`` deep; random weights from
``--seed``), quantizes it with the serving launcher's recipe and serves 8
requests (16-256-token prompts) with ``EngineConfig(max_batch=8,
max_len=512, matmul_mode=--matmul-mode)``: ``dequant`` (the default) on
float32 KV pages, ``w8a8`` on int8 pages, ``w4a8`` (the engine converts the
tree to W4A8 leaves) on int4 pages. The first engine step
(admission, 8 prefills, one decode) runs unprofiled; the next ``--steps``
decode steps run under ``torch.profiler`` (CPU + CUDA activity). Prints
the device time and the device operations (kernel launches, memsets) per
kernel family (the hand-written kernels' launches and every other kernel)
and the device busy share of the profiled wall time;
writes the same as JSON to ``--out``.
Profiling adds host overhead: its step time is not the serving number
(``chip_smoke.py`` measures that unprofiled).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--matmul-mode", default="dequant", choices=["dequant", "w8a8", "w4a8"])
    ap.add_argument("--out", default="chiprun_out/profile_decode.json")
    args = ap.parse_args(argv)
    dev = resolve_device(None)

    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=args.layers)
    params = T.init_params(cfg, seed=args.seed, device=dev)
    q = quantize_params(params, QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02,
                                            per_channel=True, pad_to=1), device=dev)
    del params
    kv_bits = {"dequant": None, "w8a8": 8, "w4a8": 4}[args.matmul_mode]
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=8, max_len=512,
                                             matmul_mode=args.matmul_mode,
                                             kv_bits=kv_bits, page_size=16), device=dev)
    rng = np.random.default_rng(args.seed)
    for i in range(8):
        plen = int(rng.integers(16, 257))
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, plen).tolist(),
                           max_new_tokens=args.steps + 2))
    eng.step()  # admission + prefills + the first decode, unprofiled
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
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
    steps = args.steps
    print(f"profiled {steps} decode steps ({args.matmul_mode}), {cfg.n_layers} layers, "
          f"8 lanes: wall "
          f"{wall_us / steps / 1e3:.2f} ms/step (profiler on)")
    if device_us == 0:
        print("device time: not measured (the profiler recorded no device activity)")
    else:
        for name, us, n in ([(k, fam[k], ops[k]) for k in fam]
                            + [("other kernels", other, other_ops)]):
            print(f"  {name}: {us / steps / 1e3:.3f} ms/step "
                  f"({100 * us / device_us:.1f}% of device time; {n / steps:.0f} ops/step)")
        print(f"device busy {device_us / steps / 1e3:.2f} ms/step = "
              f"{100 * device_us / wall_us:.1f}% of wall; idle "
              f"{100 * (1 - device_us / wall_us):.1f}%; "
              f"{(sum(ops.values()) + other_ops) / steps:.0f} device operations a step")
        for us, key in sorted(other_top, reverse=True)[:8]:
            print(f"    other: {key[:90]}: {us / steps / 1e3:.3f} ms/step")
    out = dict(layers=cfg.n_layers, steps=steps, matmul_mode=args.matmul_mode,
               wall_ms_per_step=wall_us / steps / 1e3,
               device_ms_per_step={k: v / steps / 1e3 for k, v in fam.items()},
               other_ms_per_step=other / steps / 1e3,
               device_ops_per_step={k: v / steps for k, v in ops.items()},
               other_ops_per_step=other_ops / steps,
               busy_share=(device_us / wall_us) if wall_us else None,
               other_top=[(k, us / steps / 1e3) for us, k in sorted(other_top, reverse=True)[:20]],
               card=torch.cuda.get_device_name(0))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
