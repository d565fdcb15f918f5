"""Wall and device time per call of B2 (paged attention), B5
(quant_matmul), B4 (ocs_matmul), B1 (fused_qmatmul) and B6 (w4a8_qmatmul)
on the card, beside their library yardsticks, against this checkout's
``src`` or another's, so that a parent and a change can be timed in one
call.

    python3 src/repro_torch/launch/kernel_times.py [--src DIR] [--calls N] [--ragged]
        [--tiles] [--out FILE]

``--src DIR`` puts ``DIR`` first on ``sys.path`` before ``repro_torch`` is
imported (say the ``src`` of a parent commit unpacked with ``git
archive``); without it the ``src`` this file lies in is used. Only the
wrappers' public calls are used: ``paged_attention_cuda(pool, table, pos,
q, k_new, v_new)``, ``quant_matmul_cuda(x, w8, w_scale, [x_scale],
out_dtype=...)``, ``ocs_quant_matmul_cuda(x, w8, w_scale, src_tail,
[x_scale], tail_mult=..., tail_is_mask=..., out_dtype=...)``,
``fused_quant_matmul_cuda(x, w8, w_scale, src_tail, out_dtype=...)`` and
``w4a8_matmul_cuda(x, w4, s4, w8, s8, src_tail, outlier_idx,
out_dtype=...)``. The cases,
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
  Each M's rows are also summed as one 40-layer step (7 x 40 calls + the
  lm_head). Each row names the tile ``quant_matmul.tc_plan`` gave the call
  (the argument lists of both are the same in a parent whose plan has no
  tile; its rows say "decode").
- B4 (``ocs_quant_matmul_cuda``): the same shapes with the OCS tails the
  serving recipe gives glm4-9b (S = 82, 274 at ``w_down``), an all-ones
  mask declared as ``dense`` declares a packed leaf's, M = 8 and 256, each
  summed as one step, tiles named as B5's; weights cycled with
  ``chip_smoke.cycled``, timed with ``chip_smoke.wo_times``, whose
  yardstick multiplies the materialized expanded activations, and again
  with K + S zero-padded to a multiple of 16 (``library_aligned_*``).
- B1 (``fused_quant_matmul_cuda``): the same shapes with the same OCS
  tails, bf16 x and out, M = 8 and M = 256, each summed as one 40-layer
  step; weights cycled as for B4. Yardstick: ``torch._int_mm`` on the
  quantized, zero-padded operands (M padded to 32; its weights cycled),
  then the epilogue (``chip_smoke.b1_times``).
- B6 (``w4a8_matmul_cuda``): the same shapes as ``to_w4a8(., 0.05)``
  leaves them (the same OCS tails, T = 209 outlier rows, 699 at
  ``w_down``), random packed nibbles, bf16 x and out, M = 8 and M = 256,
  each summed as one 40-layer step; the (w4, w8) pairs cycled past the
  L2. Yardstick: ``torch._int_mm`` x 2 (the int4 weights unpacked to int8
  before the timing, and the outlier rows) + the epilogue
  (``chip_smoke.b6_times``).
- With ``--ragged``: B1, B4, B5 and B6 at hymba-1.5b's lm_head, N =
  32001, on weights stored zero-padded to 32016 columns (as
  ``quantize_params`` stores them) against the same calls padding the
  weights on every call and slicing the output, as the wrappers did
  before the padding moved to the tree (:func:`ragged_rows`).
- With ``--tiles`` (wrappers with a prefill tile only): B5 and B4 at each
  shape and M in ``TILE_MS``, device ms with the decode tile and with the
  prefill tile (``quant_matmul.tc_plan`` overridden for the timing), beside
  the tile the plan picks (:func:`tile_rows`): the timing that sets the
  plan's thresholds.
- Digests: the sha256 of B4's f32 outputs (wq/wo and w_down shapes with
  their OCS tails, M = 8 and 256, weight-only as ``dense`` calls it and
  int8) and of B5's weight-only ones on the same inputs (the first K rows
  of the weights), and of B1's and B6's f32 and bf16 outputs (wq/wo,
  w_down and lm_head, M = 8 and 256), so that two checkouts' runs show
  whose bits moved.

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


def b1_digests(seed: int):
    """sha256 of B1's f32 and bf16 outputs on inputs drawn from a fresh
    generator."""
    import hashlib

    import torch
    from repro_torch.kernels import fused_qmatmul as fq

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, (k, s, n) in {"wq/wo": (4096, 82, 4096), "w_down": (13696, 274, 4096),
                            "lm_head": (4096, 82, 151552)}.items():
        w8 = torch.randint(-127, 128, (k + s, n), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
        src = torch.randint(0, k, (s,), generator=gen, device="cuda", dtype=torch.int32)
        for m in (8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            for dt in (torch.float32, torch.bfloat16):
                y = fq.fused_quant_matmul_cuda(x, w8, ws, src, out_dtype=dt)
                raw = y.view(torch.int16 if dt == torch.bfloat16 else torch.int32)
                out[f"{name} M={m} {str(dt)[6:]}"] = hashlib.sha256(
                    raw.cpu().numpy().tobytes()).hexdigest()
    return out


# to_w4a8(., 0.05)'s outlier rows at glm4-9b's K + S (4178 -> 209, 13970 -> 699).
B6_OUTLIERS = {"wq/wo": 209, "wk/wv": 209, "w_gate/w_up": 209, "w_down": 699, "lm_head": 209}


def b6_case(gen, k, s, t, n):
    """Random W4A8 operands at (K, S, T, N): packed nibbles [(K+S)/2, N],
    both scales, outlier rows [T, N], a tail and sorted outlier indices."""
    import torch

    w4 = torch.randint(0, 256, ((k + s) // 2, n), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.uint8)
    s4 = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
    w8 = torch.randint(-127, 128, (t, n), generator=gen, device="cuda", dtype=torch.int8)
    s8 = torch.rand((n,), generator=gen, device="cuda") * 0.001 + 1e-5
    src = torch.randint(0, k, (s,), generator=gen, device="cuda", dtype=torch.int32)
    oidx = torch.sort(torch.randperm(k + s, generator=gen, device="cuda")[:t]).values
    return w4, s4, w8, s8, src, oidx.to(torch.int32)


def b6_digests(seed: int):
    """sha256 of B6's f32 and bf16 outputs on inputs drawn from a fresh
    generator."""
    import hashlib

    import torch
    from repro_torch.kernels import w4a8_qmatmul as w4q

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name in ("wq/wo", "w_down", "lm_head"):
        (k, n), _ = B5_SHAPES[name]
        args = b6_case(gen, k, B4_TAILS[name], B6_OUTLIERS[name], n)
        for m in (8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            for dt in (torch.float32, torch.bfloat16):
                y = w4q.w4a8_matmul_cuda(x, *args, out_dtype=dt)
                raw = y.view(torch.int16 if dt == torch.bfloat16 else torch.int32)
                out[f"{name} M={m} {str(dt)[6:]}"] = hashlib.sha256(
                    raw.cpu().numpy().tobytes()).hexdigest()
    return out


def b6_rows(gen, calls: int):
    """B6's rows at M = 8 and 256 and each M's calls of one step, timed with
    ``chip_smoke.b6_times`` (the ``_int_mm`` x 2 + epilogue yardstick)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import w4a8_qmatmul as w4q

    rows = []
    steps = {m: dict(ms=0.0, device_ms=0.0, library_ms=0.0, library_device_ms=0.0)
             for m in (8, 256)}
    for name, ((k, n), per_step) in B5_SHAPES.items():
        s, t = B4_TAILS[name], B6_OUTLIERS[name]
        w4, s4, w8, s8, src, oidx = b6_case(gen, k, s, t, n)
        nbytes = w4.numel() + w8.numel()
        copies = [(w4, w8)] + [(w4.clone(), w8.clone())
                               for _ in range(math.ceil(2 * cs.L2_BYTES / nbytes) - 1)]
        for m in (8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            run = cs.cycling(lambda ws: w4q.w4a8_matmul_cuda(
                x, ws[0], s4, ws[1], s8, src, oidx, out_dtype=torch.bfloat16), copies)
            tm = cs.b6_times(run, x, w4, s4, w8, s8, src, oidx, calls)
            rows.append(dict(kernel="B6", names=name, M=m, K=k, S=s, T=t, N=n, **tm))
            print(f"B6 {name} M={m} K={k}+{s} T={t} N={n}: ms={tm['ms']:.4f} device_ms="
                  f"{tm['device_ms']:.4f} library_ms={tm['library_ms']:.4f} library_device_ms="
                  f"{tm['library_device_ms']:.4f}", flush=True)
            for key in steps[m]:
                steps[m][key] += per_step * tm[key]
        del copies
    for m, tm in steps.items():
        print(f"B6 one {LAYERS}-layer step's M={m} calls (7 x {LAYERS} + lm_head): "
              f"ms={tm['ms']:.3f} device_ms={tm['device_ms']:.3f} library_ms="
              f"{tm['library_ms']:.3f} library_device_ms={tm['library_device_ms']:.3f}",
              flush=True)
    return rows, steps


def b1_rows(gen, calls: int):
    """B1's rows at M = 8 and 256 and each M's calls of one step, timed with
    ``chip_smoke.b1_times`` (the ``_int_mm`` + epilogue yardstick)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import fused_qmatmul as fq

    rows = []
    steps = {m: dict(ms=0.0, device_ms=0.0, library_ms=0.0, library_device_ms=0.0)
             for m in (8, 256)}
    for name, ((k, n), per_step) in B5_SHAPES.items():
        s = B4_TAILS[name]
        w8 = torch.randint(-127, 128, (k + s, n), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
        src = torch.randint(0, k, (s,), generator=gen, device="cuda", dtype=torch.int32)
        copies = cs.cycled(w8)
        for m in (8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            t = cs.b1_times(cs.cycling(lambda wt: fq.fused_quant_matmul_cuda(
                x, wt, ws, src, out_dtype=torch.bfloat16), copies), x, w8, ws, src, calls)
            rows.append(dict(kernel="B1", names=name, M=m, K=k, S=s, N=n, **t))
            print(f"B1 {name} M={m} K={k}+{s} N={n}: ms={t['ms']:.4f} device_ms="
                  f"{t['device_ms']:.4f} library_ms={t['library_ms']:.4f} library_device_ms="
                  f"{t['library_device_ms']:.4f}", flush=True)
            for key in steps[m]:
                steps[m][key] += per_step * t[key]
        del copies
    for m, t in steps.items():
        print(f"B1 one {LAYERS}-layer step's M={m} calls (7 x {LAYERS} + lm_head): "
              f"ms={t['ms']:.3f} device_ms={t['device_ms']:.3f} library_ms="
              f"{t['library_ms']:.3f} library_device_ms={t['library_device_ms']:.3f}",
              flush=True)
    return rows, steps


def ragged_rows(gen, calls: int):
    """What padding a ragged N per call costs: B1, B4, B5 and B6 at
    hymba-1.5b's lm_head (K 1600, an OCS tail of 32 rows for B1, B4 and B6,
    N 32001), M = 8, bf16 x and out, on weights stored padded to 32016
    columns ("stored") against the same calls zero-padding the unpadded
    weights and scales on every call and slicing the output ("per call"),
    the work the wrappers did before ``core.ocs.pad_out_cols``. Weights
    cycled past the L2 either way."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import fused_qmatmul as fq
    from repro_torch.kernels import ocs_matmul as om
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import w4a8_qmatmul as w4q

    k, s, t, n, m = 1600, 32, 16, 32001, 8
    cols = qm.padded_cols(n, 16)
    bf16 = torch.bfloat16
    w8 = torch.randint(-127, 128, (k + s, n), generator=gen, device="cuda", dtype=torch.int8)
    w4 = torch.randint(0, 256, ((k + s) // 2, n), generator=gen, device="cuda",
                       dtype=torch.uint8)
    ws = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
    src = torch.randint(0, k, (s,), generator=gen, device="cuda", dtype=torch.int32)
    idx = torch.randperm(k + s, generator=gen, device="cuda")[:t].to(torch.int32)
    mult = torch.ones((s,), device="cuda")
    x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(bf16)
    calls_of = {
        "B1": lambda w, w4_, sc: fq.fused_quant_matmul_cuda(x, w, sc, src, out_dtype=bf16),
        "B4": lambda w, w4_, sc: om.ocs_quant_matmul_cuda(
            x, w, sc, src, tail_mult=mult, tail_is_mask=True, out_dtype=bf16),
        "B5": lambda w, w4_, sc: qm.quant_matmul_cuda(x, w[:k], sc, out_dtype=bf16),
        "B6": lambda w, w4_, sc: w4q.w4a8_matmul_cuda(x, w4_, sc, w[:t], sc, src, idx,
                                                      out_dtype=bf16),
    }
    rows = []
    for how in ("stored", "per call"):
        if how == "stored":
            w8c, w4c, wsc = (qm.pad_cols(a, cols) for a in (w8, w4, ws))
        else:
            w8c, w4c, wsc = w8, w4, ws
        pairs = list(zip(cs.cycled(w8c), cs.cycled(w4c)))
        for kernel, call in calls_of.items():
            if how == "stored":
                run = cs.cycling(lambda p, f=call: f(p[0], p[1], wsc)[:, :n], pairs)
            else:
                run = cs.cycling(lambda p, f=call: f(
                    qm.pad_cols(p[0], cols), qm.pad_cols(p[1], cols),
                    qm.pad_cols(wsc, cols))[:, :n].contiguous(), pairs)
            ms, dev = cs.time_ms(run, calls), cs.graph_ms(run, calls)
            rows.append(dict(kernel=kernel, M=m, K=k, N=n, weight_cols=cols, padded=how,
                             ms=ms, device_ms=dev))
            print(f"ragged N: {kernel} M={m} K={k} N={n}, weights padded {how}: "
                  f"ms={ms:.4f} device_ms={dev:.4f}", flush=True)
        del pairs
    return rows


# Row counts of the --tiles sweep: verify-sized calls and prefill buckets.
TILE_MS = (32, 64, 128, 192, 256)


def tile_rows(gen, calls: int):
    """B5 and B4 (the serving tails, an all-ones mask declared) at each
    glm4-9b shape and M in ``TILE_MS``, bf16 x and out, weights cycled past
    the L2: device ms a call with the decode tile and with the prefill tile
    (the plan overridden for the timing; the same split either way), and
    the tile the plan picks."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ocs_matmul as om
    from repro_torch.kernels import quant_matmul as qm

    plan = qm.tc_plan

    def forced(tile):
        def fixed(m, k, kv, n, max_part):
            if tile == qm.TC_PREFILL:
                return (tile, *qm.tc_split_plan(kv, n), m, 0, 0)
            return (qm.TC_DECODE, *qm._tc_launch_plan(m, kv, n, max_part))
        return fixed

    rows = []
    for label in ("B5", "B4"):
        for name, ((k, n), _) in B5_SHAPES.items():
            s = B4_TAILS[name] if label == "B4" else 0
            w8 = torch.randint(-127, 128, (k + s, n), generator=gen, device="cuda",
                               dtype=torch.int8)
            ws = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
            src = torch.randint(0, k, (s,), generator=gen, device="cuda", dtype=torch.int32)
            mult = torch.ones((s,), device="cuda")
            copies = cs.cycled(w8)
            for m in TILE_MS:
                x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
                if s:
                    run = cs.cycling(lambda wt: om.ocs_quant_matmul_cuda(
                        x, wt, ws, src, tail_mult=mult, tail_is_mask=True,
                        out_dtype=torch.bfloat16), copies)
                else:
                    run = cs.cycling(lambda wt: qm.quant_matmul_cuda(
                        x, wt, ws, out_dtype=torch.bfloat16), copies)
                dev = {}
                for tile in (qm.TC_DECODE, qm.TC_PREFILL):
                    qm.tc_plan = forced(tile)
                    try:
                        dev[qm.TC_TILE_NAMES[tile]] = cs.graph_ms(run, calls)
                    finally:
                        qm.tc_plan = plan
                picked = qm.TC_TILE_NAMES[plan(m, k, qm.tc_rows(k, s), n, qm._MAX_PART_BYTES)[0]]
                rows.append(dict(kernel=label, names=name, M=m, K=k, S=s, N=n, plan=picked,
                                 decode_device_ms=dev["decode"],
                                 prefill_device_ms=dev["prefill"]))
                print(f"tiles: {label} {name} M={m} K={k}+{s} N={n}: decode device_ms="
                      f"{dev['decode']:.4f} prefill device_ms={dev['prefill']:.4f} "
                      f"(the plan: {picked})", flush=True)
            del copies
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="kernel_times.json")
    ap.add_argument("--ragged", action="store_true",
                    help="also time the GEMMs at a ragged N, weights padded once against "
                         "padded per call")
    ap.add_argument("--tiles", action="store_true",
                    help="also time B5 and B4 on each of their two tiles (this tree's only)")
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

    def tile(m, k, s, n):
        """The tile this checkout's plan gives the call ("decode" where the
        plan has no other)."""
        if not hasattr(qm, "tc_plan"):
            return "decode"
        return qm.TC_TILE_NAMES[qm.tc_plan(m, k, qm.tc_rows(k, s), n, qm._MAX_PART_BYTES)[0]]

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
    keys = ("ms", "device_ms", "library_ms", "library_device_ms")
    b5_steps = {m: dict.fromkeys(keys, 0.0) for m in (8, 256)}
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
            t = tile(m, k, 0, n)
            rows.append(dict(kernel="B5", names=name, M=m, K=k, N=n, tile=t, ms=ms,
                             device_ms=dev, library_ms=lms, library_device_ms=ldev))
            print(f"B5 {name} M={m} K={k} N={n} ({t} tile): ms={ms:.4f} device_ms={dev:.4f} "
                  f"library_ms={lms:.4f} library_device_ms={ldev:.4f}", flush=True)
            for key, v in (("ms", ms), ("device_ms", dev), ("library_ms", lms),
                           ("library_device_ms", ldev)):
                b5_steps[m][key] += per_step * v
        del copies, lib_copies, wb
    for m, st in b5_steps.items():
        print(f"B5 one {LAYERS}-layer step's M={m} calls (7 x {LAYERS} + lm_head): "
              f"ms={st['ms']:.3f} device_ms={st['device_ms']:.3f} library_ms="
              f"{st['library_ms']:.3f} library_device_ms={st['library_device_ms']:.3f}")
    b4_steps = {m: dict.fromkeys(keys + ("library_aligned_ms", "library_aligned_device_ms"), 0.0)
                for m in (8, 256)}
    for name, ((k, n), per_step) in B5_SHAPES.items():
        s = B4_TAILS[name]
        w8 = torch.randint(-127, 128, (k + s, n), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
        src = torch.randint(0, k, (s,), generator=gen, device="cuda", dtype=torch.int32)
        mult = torch.ones((s,), device="cuda")
        copies, wb_copies = cs.cycled(w8), cs.cycled(w8.to(torch.bfloat16))
        for m in (8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            t = cs.wo_times(cs.cycling(lambda wt: om.ocs_quant_matmul_cuda(
                x, wt, ws, src, tail_mult=mult, tail_is_mask=True, out_dtype=torch.bfloat16),
                copies), torch.cat([x, x[:, src.long()]], 1), ws, wb_copies, args.calls)
            tl = tile(m, k, s, n)
            rows.append(dict(kernel="B4", names=name, M=m, K=k, S=s, N=n, tile=tl, **t))
            aligned = (f" library_aligned_device_ms={t['library_aligned_device_ms']:.4f}"
                       if "library_aligned_device_ms" in t else "")
            print(f"B4 {name} M={m} K={k}+{s} N={n} ({tl} tile): ms={t['ms']:.4f} device_ms="
                  f"{t['device_ms']:.4f} library_ms={t['library_ms']:.4f} library_device_ms="
                  f"{t['library_device_ms']:.4f}{aligned}", flush=True)
            for key in b4_steps[m]:
                b4_steps[m][key] += per_step * t.get(key, t[key.replace("_aligned", "")])
        del copies, wb_copies
    for m, st in b4_steps.items():
        print(f"B4 one {LAYERS}-layer step's M={m} calls (7 x {LAYERS} + lm_head): "
              f"ms={st['ms']:.3f} device_ms={st['device_ms']:.3f} library_ms="
              f"{st['library_ms']:.3f} library_device_ms={st['library_device_ms']:.3f} "
              f"library_aligned_ms={st['library_aligned_ms']:.3f} library_aligned_device_ms="
              f"{st['library_aligned_device_ms']:.3f}")
    more, b1_steps = b1_rows(gen, args.calls)
    rows += more
    more, b6_steps = b6_rows(gen, args.calls)
    rows += more
    digests = b4_digests(args.seed + 1)
    for key, d in digests.items():
        print(f"B4 {key}: sha256 {d}")
    b1_sha = b1_digests(args.seed + 2)
    for key, d in b1_sha.items():
        print(f"B1 {key}: sha256 {d}")
    b6_sha = b6_digests(args.seed + 3)
    for key, d in b6_sha.items():
        print(f"B6 {key}: sha256 {d}")
    if args.ragged:
        rows += ragged_rows(gen, args.calls)
    if args.tiles:
        rows += tile_rows(gen, args.calls)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, rows=rows, b5_steps=b5_steps, b4_steps=b4_steps,
                                   b1_steps=b1_steps, b6_steps=b6_steps, b4_sha256=digests,
                                   b1_sha256=b1_sha, b6_sha256=b6_sha),
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
