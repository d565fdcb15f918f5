"""Wall and device time per call of B2 (paged attention), B5
(quant_matmul) and B4 (ocs_matmul) on the card, beside their library
yardsticks, against this checkout's ``src`` or another's, so that a parent
and a change can be timed in one call.

    python3 src/repro_torch/launch/kernel_times.py [--src DIR] [--calls N] [--out FILE]

``--src DIR`` puts ``DIR`` first on ``sys.path`` before ``repro_torch`` is
imported (say the ``src`` of a parent commit unpacked with ``git
archive``); without it the ``src`` this file lies in is used. Only the
wrappers' public calls are used: ``paged_attention_cuda(pool, table, pos,
q, k_new, v_new)``, ``quant_matmul_cuda(x, w8, w_scale, [x_scale],
out_dtype=...)`` and ``ocs_quant_matmul_cuda(x, w8, w_scale, src_tail,
[x_scale], tail_mult=..., tail_is_mask=..., out_dtype=...)``. The cases,
the yardsticks and both timings are
``chip_smoke.py``'s (this checkout's, at its root): ``time_ms`` (wall,
CUDA events around back-to-back calls, host work included) and
``graph_ms`` (device, the same calls captured in one CUDA graph and
replayed).

Cases, at glm4-9b's shapes (random data from ``--seed``):

- B2: ``chip_smoke.b2_case`` (8 lanes, a retired one among them; float32,
  int8 and int4 pools) at Q = 1, 5 and 17; yardstick ``chip_smoke.sdpa``.
- B5: bf16 x against int8 weights [K, N] of the clip-only tree's shapes
  (wq/wo, wk/wv, w_gate/w_up, w_down, lm_head), M = 8 and 256, bf16 out;
  weight copies cycled past the 50 MB L2. Yardstick: bf16 ``torch.matmul``
  of the weights converted before the timing, times the column scales.
  The M = 8 rows are also summed as one 40-layer decode step (7 x 40 calls
  + the lm_head).
- B4 (``ocs_quant_matmul_cuda``): the same shapes with the OCS tails the
  serving recipe gives glm4-9b (S = 82, 274 at ``w_down``), an all-ones
  mask declared as ``dense`` declares a packed leaf's, M = 8 (summed as one
  decode step) and the lm_head at M = 256; weights cycled with
  ``chip_smoke.cycled``, timed with ``chip_smoke.wo_times``, whose
  yardstick multiplies the materialized expanded activations.
- Digests: the sha256 of B4's f32 outputs (wq/wo and w_down shapes with
  their OCS tails, M = 8 and 256, weight-only as ``dense`` calls it and
  int8) and of B5's weight-only ones on the same inputs (the first K rows
  of the weights), so that two checkouts' runs show whose bits moved.

Prints one line a case and writes the lot as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
LAYERS = 40
# glm4-9b's clip-only linear shapes (K, N) and their calls a decode step.
B5_SHAPES = {"wq/wo": ((4096, 4096), 2 * LAYERS), "wk/wv": ((4096, 256), 2 * LAYERS),
             "w_gate/w_up": ((4096, 13696), 2 * LAYERS), "w_down": ((13696, 4096), LAYERS),
             "lm_head": ((4096, 151552), 1)}


# glm4-9b's OCS tail lengths from the serving recipe (r = 0.02, pad_to=1).
B4_TAILS = {"wq/wo": 82, "wk/wv": 82, "w_gate/w_up": 82, "w_down": 274, "lm_head": 82}


def b4_digests(seed: int):
    """sha256 of B4's f32 outputs, and of B5's weight-only ones, on inputs
    drawn from a fresh generator."""
    import hashlib

    import torch
    from repro_torch.kernels import ocs_matmul as om
    from repro_torch.kernels import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, (k, s, n) in {"wq/wo": (4096, 82, 4096), "w_down": (13696, 274, 4096)}.items():
        w8 = torch.randint(-127, 128, (k + s, n), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
        src = torch.randint(0, k, (s,), generator=gen, device="cuda", dtype=torch.int32)
        mult = torch.ones((s,), device="cuda")
        for m in (8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            x8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            xs = torch.rand((m,), generator=gen, device="cuda") * 0.05 + 1e-3
            ys = {"weight-only": om.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult,
                                                          tail_is_mask=True,
                                                          out_dtype=torch.float32),
                  "int8": om.ocs_quant_matmul_cuda(x8, w8, ws, src, xs, mult),
                  "B5 weight-only": qm.quant_matmul_cuda(x, w8[:k], ws,
                                                         out_dtype=torch.float32)}
            for mode, y in ys.items():
                out[f"{name} M={m} {mode}"] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="kernel_times.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ocs_matmul as om
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_matmul as qm

    card = cs.gpu_line()
    print(f"card: {card}; repro_torch from {Path(pa.__file__).resolve().parents[2]}", flush=True)

    def times(fn):
        return cs.time_ms(fn, args.calls), cs.graph_ms(fn, args.calls)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for kind in ("float32", "int8", "int4"):
        for qn in (1, 5, 17):
            pool, table, pos, q, kn, vn = cs.b2_case(gen, kind, Q=qn)
            ms, dev = times(lambda: pa.paged_attention_cuda(pool, table, pos, q, kn, vn))
            lib, lib_dev = times(cs.sdpa(pool, table, pos, q, kind))
            rows.append(dict(kernel="B2", pool=kind, Q=qn, ms=ms, device_ms=dev,
                             library_ms=lib, library_device_ms=lib_dev))
            print(f"B2 pool={kind} Q={qn}: ms={ms:.4f} device_ms={dev:.4f} library_ms="
                  f"{lib:.4f} library_device_ms={lib_dev:.4f}", flush=True)
            del pool
    step = {"ms": 0.0, "device_ms": 0.0, "library_ms": 0.0, "library_device_ms": 0.0}
    for name, ((k, n), per_step) in B5_SHAPES.items():
        w8 = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
        copies = [w8] + [w8.clone() for _ in range(math.ceil(2 * cs.L2_BYTES / w8.numel()) - 1)]
        wb = w8.to(torch.bfloat16)
        lib_copies = [wb] + [wb.clone() for _ in range(math.ceil(cs.L2_BYTES / w8.numel()) - 1)]
        for m in (8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            state = {"i": 0}

            def kern():
                state["i"] = (state["i"] + 1) % len(copies)
                qm.quant_matmul_cuda(x, copies[state["i"]], ws, out_dtype=torch.bfloat16)

            def lib():
                state["i"] = (state["i"] + 1) % len(lib_copies)
                return torch.matmul(x, lib_copies[state["i"]]) * ws

            ms, dev = times(kern)
            lms, ldev = times(lib)
            rows.append(dict(kernel="B5", names=name, M=m, K=k, N=n, ms=ms, device_ms=dev,
                             library_ms=lms, library_device_ms=ldev))
            print(f"B5 {name} M={m} K={k} N={n}: ms={ms:.4f} device_ms={dev:.4f} library_ms="
                  f"{lms:.4f} library_device_ms={ldev:.4f}", flush=True)
            if m == 8:
                for key, v in (("ms", ms), ("device_ms", dev), ("library_ms", lms),
                               ("library_device_ms", ldev)):
                    step[key] += per_step * v
        del copies, lib_copies, wb
    print(f"B5 one {LAYERS}-layer decode step (M=8, 7 x {LAYERS} + lm_head calls): "
          f"ms={step['ms']:.3f} device_ms={step['device_ms']:.3f} library_ms="
          f"{step['library_ms']:.3f} library_device_ms={step['library_device_ms']:.3f}")
    b4_step = dict.fromkeys(step, 0.0)
    for name, ((k, n), per_step) in B5_SHAPES.items():
        s = B4_TAILS[name]
        w8 = torch.randint(-127, 128, (k + s, n), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
        src = torch.randint(0, k, (s,), generator=gen, device="cuda", dtype=torch.int32)
        mult = torch.ones((s,), device="cuda")
        copies, wb_copies = cs.cycled(w8), cs.cycled(w8.to(torch.bfloat16))
        for m in (8, 256) if name == "lm_head" else (8,):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            t = cs.wo_times(cs.cycling(lambda wt: om.ocs_quant_matmul_cuda(
                x, wt, ws, src, tail_mult=mult, tail_is_mask=True, out_dtype=torch.bfloat16),
                copies), torch.cat([x, x[:, src.long()]], 1), ws, wb_copies, args.calls)
            rows.append(dict(kernel="B4", names=name, M=m, K=k, S=s, N=n, **t))
            print(f"B4 {name} M={m} K={k}+{s} N={n}: ms={t['ms']:.4f} device_ms="
                  f"{t['device_ms']:.4f} library_ms={t['library_ms']:.4f} library_device_ms="
                  f"{t['library_device_ms']:.4f}", flush=True)
            if m == 8:
                for key in b4_step:
                    b4_step[key] += per_step * t[key]
        del copies, wb_copies
    print(f"B4 one {LAYERS}-layer decode step (M=8, 7 x {LAYERS} + lm_head calls): "
          f"ms={b4_step['ms']:.3f} device_ms={b4_step['device_ms']:.3f} library_ms="
          f"{b4_step['library_ms']:.3f} library_device_ms={b4_step['library_device_ms']:.3f}")
    digests = b4_digests(args.seed + 1)
    for key, d in digests.items():
        print(f"B4 {key}: sha256 {d}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, rows=rows, b5_step=step, b4_step=b4_step,
                                   b4_sha256=digests), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
