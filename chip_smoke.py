#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--layers N] [--clip-layers N] [--out DIR]

Phases (any failure raises, and the script exits non-zero with no result):

1. Print the card's name and power limit (``nvidia-smi``), build every CUDA
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together).
2. Quantize glm4-9b at its full published width (d_model 4096, 32/2 heads,
   hd 128, d_ff 13696, vocab 151552) and ``--layers`` deep (default 40,
   the published depth; a smaller value is the one cut): random weights
   from a seeded ``torch.Generator`` on the card, quantized on the card by
   ``quantize_params`` with the serving launcher's recipe (w8, MSE clip,
   OCS r=0.02, per-channel, pad_to=1).
3. Kernel phase: each kernel's wrapper on card tensors at the shapes the
   main paths give it, held against its plain PyTorch version on the same
   inputs, and timed (CUDA events) beside its plain version, a library
   yardstick the port never calls, and its bound.
   ``fused_qmatmul`` (B1) at every glm4-9b linear shape (the layer-0 and
   ``lm_head`` weights just quantized) with M in {1, 8, 256}: bitwise.
   ``paged_attention`` (B2) on int8 and float32 pools (8 lanes, ragged
   positions, one all-trash lane, Q = 1): appended pools bitwise, outputs
   within ``B2_ATOL``. ``ocs_matmul`` (B4) weight-only at every shape with
   M in {1, 8, 256}: f32 outputs within the summation-order bound
   (``WO_TOL_FACTOR``), bf16 outputs within one bf16 ulp; int8 mode at
   M in {8, 256}: bitwise. ``dynamic_quant`` (B3) at K in {4096, 13696},
   M in {1, 8, 256}: bitwise.
4. Serve phases: every launch count set to 0 just before each and read just
   after. ``ServingEngine`` serves 8 seeded requests (prompts of 16-256
   tokens, 32 new tokens each, greedy) with ``EngineConfig(max_batch=8,
   max_len=512, page_size=16)`` and (a) ``matmul_mode="w8a8", kv_bits=8``,
   (b) the defaults, ``dequant`` on float32 pages. Asserts that every
   request finishes by length, that parameters and pools lie on the card,
   that the phase's matmul kernel (B1 for w8a8, B4 for dequant) ran 7*L+1
   times per decode step and per prefill call and the others not at all,
   and ``paged_attention`` L times per decode step.
5. Clip-only tree: the OCS tree is freed, the same seeded weights are made
   again and quantized with ``ocs_ratio=0`` (the paper's baseline, no
   split), ``--clip-layers`` deep (default: ``--layers``). ``quant_matmul``
   (B5) is checked and timed as B4 at its shapes (weight-only and int8),
   and the tree is served in ``dequant`` mode as in 4(b): B5 7*L+1 times
   per step and call, B4 and B1 not at all.
6. Reference check: a smoke-size glm4-9b run through prefill and
   teacher-forced decode on the card (kernels) and on the CPU (plain
   versions) from the same weights, in w8a8 (int8 pages), dequant (float
   pages) and dequant on a clip-only tree; logits agree within
   ``MODEL_RTOL`` of the largest logit.

Output: a ``kernels`` JSON line (every kernel's launches on its path,
error, times and bound), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Per-shape detail goes to
``<out>/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, int8
# and bf16 tensor-core ops/s, float32 (non-tensor-core) flop/s.
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# paged_attention output tolerance vs its plain version: both are f32 after
# dequantization; they differ in summation order and in expf vs torch's
# softmax exp (measured 4.8e-7 on int8 and 6.0e-7 on float32 pools, H100).
# The same limit as tests/test_torch_cuda.py.
B2_ATOL = 2e-5
# Weight-only matmuls (B4, B5) vs their plain versions, f32 outputs: both
# sum the same exact products (bf16 x int8 is exact in f32) in another
# order, so |kernel - plain| <= 2 * K * 2**-24 * (|x_exp| @ |w|) * |ws|
# elementwise (twice the classic bound on one recursive f32 sum's error).
# bf16 outputs: within that bound plus one bf16 ulp (two values that far
# apart round to neighbours; an output near zero after cancellation can be
# several bf16 steps apart within the f32 bound, as seen at M = 256).
WO_TOL_FACTOR = 2.0
# Card (kernels) vs CPU (plain versions) logits at smoke size, relative to
# the logits' max magnitude. The same port code runs on both sides. In
# w8a8, B1 and the pools are bitwise, so the sound reading is 0 (H100, seed
# 0); in dequant the weight-only sums part at f32 rounding, which now and
# then flips a bf16 activation. The limit allows about one bf16 ulp of the
# largest logit (2**-7 = 0.0078). Readings of subtly wrong plain versions
# and of a sound one summing in another order are in
# tests/test_torch_smoke_check.py.
MODEL_RTOL = 0.01

L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def same_bits(a, b) -> bool:
    """Bitwise equality (NaN payloads included) of two tensors."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def b1_bound_ms(m, k, s, n):
    byts = m * k * 2 + (k + s) * n + s * 4 + n * 4 + m * n * 2
    ops = 2.0 * m * (k + s) * n
    t_b, t_o = byts / HBM_BPS, ops / INT8_OPS
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def kernel_phase_b1(qparams, cfg, gen, iters):
    """fused_qmatmul at every glm4-9b linear shape x M in {1, 8, 256}."""
    import torch
    from repro_torch.kernels import fused_qmatmul as fq
    from repro_torch.kernels import ref

    weights = layer_weights(qparams)
    # One timed entry per distinct (K, N); the names share it.
    groups = {}
    for name, w in weights.items():
        key = (w.n_orig, w.weight.values.shape[1])
        groups.setdefault(key, []).append(name)
    rows = []
    for (k, n), names in groups.items():
        w = weights[names[0]]
        w8 = w.weight.values
        ws = w.weight.scale.reshape(-1).contiguous()
        src = w.spec.src[w.n_orig:].contiguous()
        s = src.shape[0]
        # Weight copies cycled so the timed calls read HBM, not L2, as the
        # serve loop does (each layer's weights are read once per step).
        n_copies = max(1, math.ceil(2 * L2_BYTES / w8.numel()))
        copies = [w8] + [w8.clone() for _ in range(n_copies - 1)]
        for m in (1, 8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            got = fq.fused_quant_matmul_cuda(x, w8, ws, src, out_dtype=torch.bfloat16)
            want = fq.fused_quant_matmul_plain(x, w8, ws, src, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"fused_qmatmul {names} M={m}: not bitwise equal (max |d| {diff})"
                )
            state = {"i": 0}

            def run_kernel():
                state["i"] = (state["i"] + 1) % n_copies
                fq.fused_quant_matmul_cuda(x, copies[state["i"]], ws, src,
                                           out_dtype=torch.bfloat16)

            ms = time_ms(run_kernel, iters)
            plain_ms = time_ms(
                lambda: fq.fused_quant_matmul_plain(x, w8, ws, src, out_dtype=torch.bfloat16),
                max(2, iters // 5), warmup=1,
            )
            # Library yardstick: torch._int_mm on the already quantized,
            # zero-padded operands (it wants M > 16 and K, N % 8 == 0) plus
            # the epilogue; the activation quantization is not in it.
            q, sc = ref.dynamic_quant_ref(x)
            q = torch.cat([q, q[:, src.long()]], 1) if s else q
            mp, kp = max(m, 32), (k + s) + (-(k + s)) % 8
            qp = torch.zeros((mp, kp), dtype=torch.int8, device="cuda")
            qp[:m, : k + s] = q
            wp = torch.zeros((kp, n), dtype=torch.int8, device="cuda")
            wp[: k + s] = w8
            scp = torch.zeros((mp,), dtype=torch.float32, device="cuda")
            scp[:m] = sc
            lib_ms = None
            if n % 8 == 0:
                lib_ms = time_ms(
                    lambda: (torch._int_mm(qp, wp).float() * (scp[:, None] * ws[None, :])
                             ).to(torch.bfloat16),
                    iters,
                )
            del qp, wp
            bound, by = b1_bound_ms(m, k, s, n)
            rows.append(dict(names=names, M=m, K=k, S=s, N=n, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound, bound_by=by,
                             max_abs_err=0.0))
            log(f"B1 fused_qmatmul {'/'.join(names)} M={m} K={k}+{s} N={n}: "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms={bound:.4f} "
                f"({by}) bitwise=yes")
        del copies
    return rows


def make_b2_case(gen, int8: bool, B=8, H=32, KV=2, hd=128, ps=16, max_len=512):
    """Pools, ragged tables (lane 7 all trash), positions up to max_len-1."""
    import torch

    T = max_len // ps
    P = B * T + 1
    if int8:
        pool = {
            "k": torch.randint(-127, 128, (P, KV, ps, hd), generator=gen, device="cuda",
                               dtype=torch.int8),
            "v": torch.randint(-127, 128, (P, KV, ps, hd), generator=gen, device="cuda",
                               dtype=torch.int8),
            "k_scale": torch.rand((P, KV, ps), generator=gen, device="cuda") * 0.02 + 1e-3,
            "v_scale": torch.rand((P, KV, ps), generator=gen, device="cuda") * 0.02 + 1e-3,
        }
    else:
        pool = {
            "k": torch.randn((P, KV, ps, hd), generator=gen, device="cuda"),
            "v": torch.randn((P, KV, ps, hd), generator=gen, device="cuda"),
        }
    # Trash page poisoned: it must never reach an output.
    for key in ("k_scale", "v_scale") if int8 else ("k", "v"):
        pool[key][0] = float("nan")
    pos = torch.tensor([17, 511, 256, 40, 130, 300, 5, 0], dtype=torch.int32)[:B]
    table = torch.zeros((B, T), dtype=torch.int32)
    nxt = 1
    for b in range(B - 1):
        for t in range(int(pos[b]) // ps + 1):
            table[b, t] = nxt
            nxt += 1
    q = (torch.randn((B, 1, H, hd), generator=gen, device="cuda")).to(torch.bfloat16)
    kn = (torch.randn((B, 1, KV, hd), generator=gen, device="cuda")).to(torch.bfloat16)
    vn = (torch.randn((B, 1, KV, hd), generator=gen, device="cuda")).to(torch.bfloat16)
    return pool, table.to("cuda"), pos.to("cuda"), q, kn, vn


def b2_bound_ms(pool, table, pos, q):
    import torch

    int8 = pool["k"].dtype != torch.float32
    b, qn, h, hd = q.shape
    kvh, ps = pool["k"].shape[1:3]
    t = table.shape[1]
    elt = 1 if int8 else 4
    row = kvh * (2 * hd * elt + (8 if int8 else 0))  # k + v (+ 2 scales)
    pages = attended = 0
    tab = table.cpu()
    for i, p in enumerate(pos.cpu().tolist()):
        n_act = min(t, (p + qn - 1) // ps + 1)
        pages += sum(1 for j in range(n_act) if int(tab[i, j]) != 0)
        attended += p + qn
    byts = (pages * ps * row + b * qn * h * hd * 2 + 2 * b * qn * kvh * hd * 2
            + b * qn * row + table.numel() * 4 + b * 4 + b * qn * h * hd * 4)
    flops = 4.0 * h * hd * attended
    t_b, t_o = byts / HBM_BPS, flops / F32_FLOPS
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def kernel_phase_b2(gen, iters):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa

    rows = []
    for int8 in (True, False):
        pool, table, pos, q, kn, vn = make_b2_case(gen, int8)
        want_out, want_pool = pa.paged_attention_plain(pool, table, pos, q, kn, vn)
        work = {k: v.clone() for k, v in pool.items()}
        got_out, got_pool = pa.paged_attention_cuda(work, table, pos, q, kn, vn)
        torch.cuda.synchronize()
        for key in want_pool:
            if not same_bits(got_pool[key], want_pool[key]):
                raise AssertionError(f"paged_attention int8={int8}: pool {key} differs")
        if not torch.isfinite(got_out).all():
            raise AssertionError("paged_attention: nonfinite output (trash page leaked)")
        err = (got_out - want_out).abs().max().item()
        if err > B2_ATOL:
            raise AssertionError(f"paged_attention int8={int8}: max |d| {err} > {B2_ATOL}")
        if got_out[7].abs().max().item() != 0.0:
            raise AssertionError("paged_attention: the all-trash lane is not exact zeros")
        ms = time_ms(lambda: pa.paged_attention_cuda(work, table, pos, q, kn, vn), iters)
        plain_ms = time_ms(lambda: pa.paged_attention_plain(pool, table, pos, q, kn, vn),
                           max(2, iters // 5), warmup=1)
        # Library yardstick: SDPA over the dequantized, gathered pages
        # (gathered outside the timing; KV heads expanded to the 32 heads).
        b, _, h, hd = q.shape
        kvh, ps = pool["k"].shape[1:3]
        tl = table.long()
        kg = want_pool["k"][tl].float()
        vg = want_pool["v"][tl].float()
        if int8:
            kg = kg * want_pool["k_scale"][tl][..., None]
            vg = vg * want_pool["v_scale"][tl][..., None]
        L = tl.shape[1] * ps
        kg = kg.movedim(2, 1).reshape(b, kvh, L, hd).nan_to_num(0.0)
        vg = vg.movedim(2, 1).reshape(b, kvh, L, hd).nan_to_num(0.0)
        kg = kg.repeat_interleave(h // kvh, dim=1)
        vg = vg.repeat_interleave(h // kvh, dim=1)
        mask = (torch.arange(L, device="cuda")[None, :] <= pos[:, None].long()) & \
            torch.repeat_interleave(table != 0, ps, dim=1)
        mask = mask[:, None, None, :]
        qf = q.float().movedim(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qf, kg, vg, attn_mask=mask),
                         iters)
        bound, by = b2_bound_ms(pool, table, pos, q)
        rows.append(dict(pool="int8" if int8 else "float32", B=b, H=h, KV=kvh, hd=hd,
                         ps=ps, T=int(table.shape[1]), ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by,
                         max_abs_err=err))
        log(f"B2 paged_attention pool={'int8' if int8 else 'float32'} B={b} H={h}/{kvh} "
            f"hd={hd} ps={ps}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.5f} ({by}) max_abs_err={err:.3g} pools bitwise=yes")
    return rows


def layer_weights(qparams):
    """The layer-0 linear weights and the ``lm_head`` of a quantized tree."""
    from repro_torch.models.transformer import layer_params

    lp = layer_params(qparams, 0)
    return {
        "wq": lp["attn"]["wq"], "wk": lp["attn"]["wk"], "wv": lp["attn"]["wv"],
        "wo": lp["attn"]["wo"], "w_gate": lp["mlp"]["w_gate"],
        "w_up": lp["mlp"]["w_up"], "w_down": lp["mlp"]["w_down"],
        "lm_head": qparams["lm_head"],
    }


def cycled(t):
    """``t`` and enough copies of it that cycling through them reads more
    than twice the L2 cache: timed calls then read device memory, as the
    serve loop does (each layer's weights are read once per step)."""
    n = max(1, math.ceil(2 * L2_BYTES / (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def time_cycled(fn, copies, iters, warmup=2):
    state = {"i": 0}

    def run():
        state["i"] = (state["i"] + 1) % len(copies)
        fn(copies[state["i"]])

    return time_ms(run, iters, warmup)


def bf16_ulp(t):
    """One bf16 step at each value of the float32 tensor ``t``."""
    import torch

    _, e = torch.frexp(t.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(t), e - 8)


def bf16_ulps(a, b) -> int:
    """Largest distance, in bf16 steps, between two bf16 tensors (+0 and -0
    are the same step)."""
    import torch

    def key(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((key(a) - key(b)).abs().max().item())


def matmul_bound_ms(m, k, s, n, *, x_bytes, out_bytes, peak_ops):
    """Each input read once (x, the [K+S, N] int8 weights, src_tail and
    tail_mult, both scales), the output written once, at HBM rate; or the
    multiply-adds at ``peak_ops``: the larger."""
    byts = m * k * x_bytes + (k + s) * n + s * 8 + n * 4 + m * 4 + m * n * out_bytes
    ops = 2.0 * m * (k + s) * n
    t_b, t_o = byts / HBM_BPS, ops / peak_ops
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def kernel_phase_wo(label, qparams, gen, iters):
    """B4 (``ocs_matmul``, the OCS tree) or B5 (``quant_matmul``, the
    clip-only tree) at every glm4-9b linear shape: weight-only at M in {1,
    8, 256} (f32 outputs within the summation-order bound, bf16 outputs
    within it plus one bf16 ulp; timed with bf16 outputs, as ``dense`` calls
    it), int8 at M in {8, 256} (bitwise)."""
    import torch
    from repro_torch.kernels import ocs_matmul as om
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref

    weights = layer_weights(qparams)
    groups = {}
    for name, w in weights.items():
        groups.setdefault((w.n_orig, w.weight.values.shape[1]), []).append(name)
    rows = []
    for (k, n), names in groups.items():
        w = weights[names[0]]
        w8 = w.weight.values
        ws = w.weight.scale.reshape(-1).contiguous()
        src = w.spec.src[w.n_orig:].contiguous()
        mult = w.spec.mult[w.n_orig:].contiguous()
        s = src.shape[0]
        if (label == "B5") != (s == 0):
            raise AssertionError(f"{label} {names}: S = {s}")

        if s:
            def kern(x, wt, out_dtype):
                return om.ocs_quant_matmul_cuda(x, wt, ws, src, tail_mult=mult,
                                                tail_is_mask=x.dtype == torch.int8,
                                                out_dtype=out_dtype)

            def plain(x, out_dtype):
                return om.ocs_quant_matmul_plain(x, w8, ws, src, tail_mult=mult,
                                                 out_dtype=out_dtype)
        else:
            def kern(x, wt, out_dtype):
                return qm.quant_matmul_cuda(x, wt, ws, out_dtype=out_dtype)

            def plain(x, out_dtype):
                return qm.quant_matmul_plain(x, w8, ws, out_dtype=out_dtype)

        copies = cycled(w8)
        wb_copies = cycled(w8.to(torch.bfloat16))
        for m in (1, 8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            xe = torch.cat([x.float(), x[:, src.long()].float() * mult], 1) if s else x.float()
            got, want = kern(x, w8, torch.float32), plain(x, torch.float32)
            torch.cuda.synchronize()
            tol = (WO_TOL_FACTOR * (k + s + 2) * 2.0 ** -24
                   * ref.float_matmul(xe.abs(), w8.abs()) * ws.abs())
            err = (got - want).abs()
            ratio = (err / tol.clamp_min(1e-30)).max().item()
            if not torch.isfinite(got).all() or ratio > 1.0:
                raise AssertionError(f"{label} {names} M={m}: |kernel - plain| is {ratio:.3g} "
                                     "of the summation-order bound")
            g16 = kern(x, w8, torch.bfloat16).float()
            p16 = plain(x, torch.bfloat16).float()
            ulps = bf16_ulps(g16.to(torch.bfloat16), p16.to(torch.bfloat16))
            lim16 = tol + bf16_ulp(torch.maximum(g16.abs(), p16.abs()))
            if not ((g16 - p16).abs() <= lim16).all():
                raise AssertionError(f"{label} {names} M={m}: bf16 outputs beyond the bound "
                                     f"plus one bf16 ulp ({ulps} steps apart)")
            ms = time_cycled(lambda wt: kern(x, wt, torch.bfloat16), copies, iters)
            plain_ms = time_ms(lambda: plain(x, torch.bfloat16), max(2, iters // 5), warmup=1)
            # Library yardstick: bf16 torch.matmul of the materialized
            # expanded activations and the weights converted to bf16 before
            # the timing, then the column scales.
            xeb = xe.to(torch.bfloat16)
            lib_ms = time_cycled(lambda wb: torch.matmul(xeb, wb) * ws, wb_copies, iters)
            bound, by = matmul_bound_ms(m, k, s, n, x_bytes=2, out_bytes=2,
                                        peak_ops=BF16_FLOPS)
            err_max = err.max().item()
            rows.append(dict(mode="weight-only", names=names, M=m, K=k, S=s, N=n, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                             bound_by=by, max_abs_err=err_max, tol_share=ratio,
                             bf16_steps=ulps))
            log(f"{label} weight-only {'/'.join(names)} M={m} K={k}+{s} N={n}: kernel_ms="
                f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms="
                f"{bound:.4f} ({by}) f32 max|d|={err_max:.3g} ({ratio:.3g} of bound), "
                f"bf16 within bound + 1 ulp")
        del wb_copies
        for m in (8, 256):
            x8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                               dtype=torch.int8)
            xs = torch.rand((m,), generator=gen, device="cuda") * 0.05 + 1e-3
            if s:
                got = om.ocs_quant_matmul_cuda(x8, w8, ws, src, xs, mult)
                want = om.ocs_quant_matmul_plain(x8, w8, ws, src, xs, mult)
            else:
                got = qm.quant_matmul_cuda(x8, w8, ws, xs)
                want = qm.quant_matmul_plain(x8, w8, ws, xs)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                d = (got - want).abs().max().item()
                raise AssertionError(f"{label} int8 {names} M={m}: not bitwise (max |d| {d})")
            if s:
                ms = time_cycled(lambda wt: om.ocs_quant_matmul_cuda(
                    x8, wt, ws, src, xs, mult, tail_is_mask=True), copies, iters)
                plain_ms = time_ms(lambda: om.ocs_quant_matmul_plain(x8, w8, ws, src, xs, mult),
                                   max(2, iters // 5), warmup=1)
            else:
                ms = time_cycled(lambda wt: qm.quant_matmul_cuda(x8, wt, ws, xs), copies, iters)
                plain_ms = time_ms(lambda: qm.quant_matmul_plain(x8, w8, ws, xs),
                                   max(2, iters // 5), warmup=1)
            # Library yardstick: torch._int_mm on the materialized expanded
            # operands, zero-padded to M >= 32 and K % 8 == 0, plus the
            # epilogue.
            qe = torch.cat([x8, x8[:, src.long()]], 1) if s else x8
            mp, kp = max(m, 32), (k + s) + (-(k + s)) % 8
            qp = torch.zeros((mp, kp), dtype=torch.int8, device="cuda")
            qp[:m, : k + s] = qe
            wp = torch.zeros((kp, n), dtype=torch.int8, device="cuda")
            wp[: k + s] = w8
            xsp = torch.zeros((mp,), dtype=torch.float32, device="cuda")
            xsp[:m] = xs
            lib_ms = None
            if n % 8 == 0:
                lib_ms = time_cycled(
                    lambda wpc: torch._int_mm(qp, wpc).float() * (xsp[:, None] * ws[None, :]),
                    cycled(wp), iters)
            del qp, wp
            bound, by = matmul_bound_ms(m, k, s, n, x_bytes=1, out_bytes=4, peak_ops=INT8_OPS)
            rows.append(dict(mode="int8", names=names, M=m, K=k, S=s, N=n, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                             bound_by=by, max_abs_err=0.0))
            log(f"{label} int8 {'/'.join(names)} M={m} K={k}+{s} N={n}: kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms="
                f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms={bound:.4f} ({by}) "
                f"bitwise=yes")
        del copies
    return rows


def kernel_phase_b3(gen, iters):
    """dynamic_quant at K in {4096, 13696} x M in {1, 8, 256}: bitwise."""
    import torch
    from repro_torch.kernels import dynamic_quant as dq

    rows = []
    dq.reset_launches()
    for k in (4096, 13696):
        for m in (1, 8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            q, sc = dq.dynamic_quant_cuda(x)
            q_want, sc_want = dq.dynamic_quant_plain(x)
            torch.cuda.synchronize()
            if not (torch.equal(q, q_want) and same_bits(sc, sc_want)):
                raise AssertionError(f"dynamic_quant M={m} K={k}: not bitwise equal")
            # Not cycled: the activations come hot from the previous op.
            ms = time_ms(lambda: dq.dynamic_quant_cuda(x), iters)
            plain_ms = time_ms(lambda: dq.dynamic_quant_plain(x), max(2, iters // 5), warmup=1)
            bound = 1e3 * (m * k * 2 + m * k + m * 4) / HBM_BPS
            rows.append(dict(M=m, K=k, ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=bound, bound_by="bytes", max_abs_err=0.0))
            log(f"B3 dynamic_quant M={m} K={k}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms=null bound_ms={bound:.5f} (bytes) bitwise=yes")
    return rows, dq.launches


def counters():
    from repro_torch.kernels import dynamic_quant, fused_qmatmul, ocs_matmul
    from repro_torch.kernels import paged_attention, quant_matmul

    return {"fused_qmatmul": fused_qmatmul, "paged_attention": paged_attention,
            "ocs_matmul": ocs_matmul, "quant_matmul": quant_matmul,
            "dynamic_quant": dynamic_quant}


def serve_phase(label, cfg, qparams, seed, card, ecfg, matmul_kernel):
    """Serve 8 seeded requests; every launch count is set to 0 just before
    and read just after. ``matmul_kernel`` must run 7*L+1 times per decode
    step and per prefill call, the other matmul kernels not at all."""
    import numpy as np
    import torch
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear
    from repro_torch.serving import Request, ServingEngine

    eng = ServingEngine(cfg, qparams, ecfg, device="cuda")
    rng = np.random.default_rng(seed)
    reqs = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(16, 257))).tolist(),
                max_new_tokens=32)
        for i in range(8)
    ]
    for r in reqs:
        eng.submit(r)
    mods = counters()
    for mod in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod in mods.items()}
    stats = eng.stats()
    L = cfg.n_layers
    if len(done) != 8 or any(r.finish_reason != "length" for r in done):
        raise AssertionError(f"{label}: finish reasons {[r.finish_reason for r in done]}")
    if any(len(r.output) != 32 for r in done):
        raise AssertionError(f"{label}: a request did not produce 32 tokens")

    def on_card(_p, leaf):
        ts = [leaf] if isinstance(leaf, torch.Tensor) else (
            [leaf.weight.values, leaf.weight.scale, leaf.spec.src, leaf.spec.mult,
             leaf.spec.bias] if isinstance(leaf, OCSQuantLinear) else [])
        for t in ts:
            if not t.is_cuda:
                raise AssertionError(f"parameter {'/'.join(map(str, _p))} not on the card")
        return leaf

    map_with_path(on_card, eng.params)
    for layer in eng.caches["layers"]:
        for t in layer["attn"].values():
            if not t.is_cuda:
                raise AssertionError("a pool tensor is not on the card")
    steps, calls = stats["decode_steps"], stats["prefill_calls"]
    want = {name: 0 for name in counts}
    want[matmul_kernel] = (7 * L + 1) * (steps + calls)
    want["paged_attention"] = L * steps
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, want {want}")
    pool_kind = "int8" if ecfg.kv_bits == 8 else "float32"
    log(f"serve {label}: {len(done)} requests, {stats['prefill_tokens']} prompt tokens over "
        f"{calls} prefill calls, {steps} decode steps, {stats['decoded_tokens']} decoded "
        f"tokens, {pool_kind} pages, wall {wall:.2f} s")
    log(f"serve {label} on {card}: prefill {stats['prefill_tok_per_s']:.1f} tok/s | decode "
        f"{stats['decode_tok_per_s']:.1f} tok/s | ttft p50 {stats['ttft_p50_s'] * 1e3:.1f} ms "
        f"p95 {stats['ttft_p95_s'] * 1e3:.1f} ms | itl p50 {stats['itl_p50_s'] * 1e3:.2f} ms")
    log(f"serve {label}: {matmul_kernel} wrapper calls {counts[matmul_kernel]} = (7*{L}+1) x "
        f"({steps} decode steps + {calls} prefill calls); paged_attention "
        f"{counts['paged_attention']} = {L} x {steps}; others 0")
    return dict(stats=stats, wall_s=wall, launches=counts, n_layers=L, pool=pool_kind)


def smoke_logits(qp, cfg, seed, dev, mode="w8a8"):
    """Logits of prefill + 4 teacher-forced decode steps of the smoke model
    on ``dev`` (the kernels on ``cuda``, the plain versions on ``cpu``), in
    matmul ``mode``."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import kv_cache as kvc

    rng = np.random.default_rng(seed)
    n = 27
    toks = np.zeros((1, 32), np.int64)
    toks[0, :n] = rng.integers(0, cfg.vocab, n)
    follow = rng.integers(0, cfg.vocab, 4)
    pools = [kvc.init_page_pool(cfg, 8, 16, device=dev) for _ in range(cfg.n_layers)]
    ids = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    with torch.no_grad():
        lg, pools = T.prefill_into_pages(
            qp, torch.as_tensor(toks, device=dev), cfg, pools, ids,
            length=torch.tensor([n], device=dev),
            prefix_ids=torch.zeros(0, dtype=torch.int32, device=dev), mode=mode)
        out = [lg]
        caches = {"layers": [{"attn": p} for p in pools],
                  "table": torch.tensor([[1, 2, 3, 0]], dtype=torch.int32, device=dev),
                  "pos": torch.tensor([n], dtype=torch.int32, device=dev)}
        for t in follow:
            lg, caches = T.decode_step(
                qp, torch.tensor([[int(t)]], dtype=torch.int32, device=dev), caches, cfg,
                mode=mode)
            out.append(lg)
    return torch.cat(out).float().cpu()


def smoke_model(seed, *, kv_bits=8, ocs_ratio=0.02):
    """The smoke glm4-9b (``kv_bits`` KV pages: 8 = int8, None = float32)
    and its tree quantized on the CPU with the serving recipe (``ocs_ratio``
    0 is the clip-only tree)."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import quantize_params
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(smoke_config("glm4-9b"), kv_bits=kv_bits)
    params = T.init_params(cfg, seed=seed, device="cpu")
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=ocs_ratio, per_channel=True,
                         pad_to=1)
    return cfg, quantize_params(params, recipe, device="cpu")


# Reference-check cases: (label, matmul mode, KV bits, OCS ratio).
REFERENCE_CASES = (
    ("w8a8, int8 pages", "w8a8", 8, 0.02),
    ("dequant, float32 pages", "dequant", None, 0.02),
    ("dequant, clip-only tree", "dequant", None, 0.0),
)


def reference_check(seed):
    """Smoke glm4-9b: card kernels vs CPU plain versions, same weights, in
    each of ``REFERENCE_CASES``."""
    import torch
    from repro_torch.core.apply import tree_to

    out = {}
    for label, mode, kv_bits, ratio in REFERENCE_CASES:
        cfg, qp = smoke_model(seed, kv_bits=kv_bits, ocs_ratio=ratio)
        cpu = smoke_logits(qp, cfg, seed, "cpu", mode)
        card = smoke_logits(tree_to(qp, torch.device("cuda")), cfg, seed, "cuda", mode)
        scale = cpu.abs().max().item()
        err = (card - cpu).abs().max().item()
        if not torch.isfinite(card).all() or err > MODEL_RTOL * scale:
            raise AssertionError(f"reference check ({label}): max |d logits| {err} > "
                                 f"{MODEL_RTOL} x {scale}")
        log(f"reference check ({label}; smoke glm4-9b, prefill + 4 teacher-forced decode "
            f"steps, card kernels vs CPU plain): max |d logits| {err:.6g} of max |logit| "
            f"{scale:.6g} ({err / scale:.3g}; limit {MODEL_RTOL})")
        out[label] = dict(max_abs_err=err, logit_scale=scale)
    return out


def step_sum(rows, L, mode=None):
    """One decode step's work of a matmul kernel: the M = 8 rows, each
    shape counted once per layer (the lm_head once); ms, plain_ms,
    library_ms and bound_ms summed, and the bound's kind by its larger
    share."""
    per_step = {"wq": L, "wk": L, "wv": L, "wo": L, "w_gate": L, "w_up": L,
                "w_down": L, "lm_head": 1}
    tot = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = 0.0
    for r in rows:
        if r["M"] != 8 or (mode is not None and r.get("mode") != mode):
            continue
        mult = sum(per_step[nm] for nm in r["names"])
        for key in tot:
            tot[key] += mult * (r[key] or 0.0)
        if r["bound_by"] == "operations":
            by_ops += mult * r["bound_ms"]
    tot["bound_by"] = "operations" if by_ops > tot["bound_ms"] / 2 else "bytes"
    return tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="glm4-9b depth (40 = the published depth, no cut)")
    ap.add_argument("--clip-layers", type=int, default=None,
                    help="depth of the clip-only tree (default: --layers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout of "
              "the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.core.apply import quantize_params
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build_all()
    for name, text in logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"built {name}: " + (" | ".join(regs) if regs else "ok"))
    t_build = time.perf_counter() - t0
    log(f"build: {t_build:.1f} s ({len(logs)} sources)")

    depth = get_config("glm4-9b").n_layers

    def model(layers):
        cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=layers)
        cut = ("no cut" if layers == depth
               else f"the one cut: n_layers {layers} of {depth}")
        log(f"model: glm4-9b at full width (d_model {cfg.d_model}, heads {cfg.n_heads}/"
            f"{cfg.n_kv_heads}, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
            f"{cfg.n_layers} layers ({cut})")
        return cfg

    def quantized(cfg, ratio):
        """The seeded weights, quantized on the card; the float weights are
        freed before this returns."""
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = T.init_params(cfg, gen, device="cuda")
        recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=ratio, per_channel=True,
                             pad_to=1)
        q = quantize_params(params, recipe, device="cuda")
        del params
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"quantize: {dt:.1f} s on the card (w8, mse clip, ocs r={ratio}, per-channel)")
        return q, dt

    cfg = model(args.layers)
    qparams, t_quant = quantized(cfg, 0.02)
    serve_cfg = EngineConfig(max_batch=8, max_len=512, page_size=16)

    gen_k = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    b1 = kernel_phase_b1(qparams, cfg, gen_k, args.iters)
    b2 = kernel_phase_b2(gen_k, args.iters)
    b4 = kernel_phase_wo("B4", qparams, gen_k, args.iters)
    b3, b3_launches = kernel_phase_b3(gen_k, args.iters)
    serves = {
        "w8a8": serve_phase("w8a8", cfg, qparams, args.seed, card,
                            serve_cfg.replace(matmul_mode="w8a8", kv_bits=8),
                            "fused_qmatmul"),
        "dequant": serve_phase("dequant", cfg, qparams, args.seed, card, serve_cfg,
                               "ocs_matmul"),
    }
    del qparams

    cfg_clip = model(args.clip_layers or args.layers)
    qclip, t_quant_clip = quantized(cfg_clip, 0.0)
    b5 = kernel_phase_wo("B5", qclip, gen_k, args.iters)
    serves["clip-only"] = serve_phase("clip-only dequant", cfg_clip, qclip, args.seed, card,
                                      serve_cfg, "quant_matmul")
    del qclip
    refc = reference_check(args.seed)

    L = cfg.n_layers
    # Kernel line: the matmul kernels at one decode step's work (M = 8: 7
    # layer matmuls x L + lm_head; B4/B5 weight-only, as dense calls them),
    # B2 at its decode shape on the int8 pool and B3 at M = 8, K = 4096
    # (per call).
    b1_step = step_sum(b1, L)
    b4_step = step_sum(b4, L, "weight-only")
    b5_step = step_sum(b5, cfg_clip.n_layers, "weight-only")
    b2_main = next(r for r in b2 if r["pool"] == "int8")
    b3_main = next(r for r in b3 if r["M"] == 8 and r["K"] == 4096)

    def entry(name, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    wo_err = lambda rows: max(r["max_abs_err"] for r in rows if r["mode"] == "weight-only")
    kernels = [
        entry("fused_qmatmul", "src/repro/kernels/fused_qmatmul.py:60",
              serves["w8a8"]["launches"]["fused_qmatmul"], 0.0, b1_step),
        entry("paged_attention", "src/repro/kernels/paged_attention.py:460",
              serves["w8a8"]["launches"]["paged_attention"], b2_main["max_abs_err"], b2_main),
        entry("ocs_matmul", "src/repro/kernels/ocs_matmul.py:44",
              serves["dequant"]["launches"]["ocs_matmul"], wo_err(b4), b4_step),
        entry("quant_matmul", "src/repro/kernels/quant_matmul.py:39",
              serves["clip-only"]["launches"]["quant_matmul"], wo_err(b5), b5_step),
        entry("dynamic_quant", "src/repro/kernels/dynamic_quant.py:37", b3_launches, 0.0,
              b3_main),
    ]
    what = {"fused_qmatmul": "one decode step's calls, M=8",
            "paged_attention": "one call, int8 pool, 8 lanes",
            "ocs_matmul": "one decode step's calls, M=8, weight-only",
            "quant_matmul": "one decode step's calls, M=8, weight-only, clip-only tree",
            "dynamic_quant": "one call, M=8, K=4096; launches from the kernel phase"}
    for k in kernels:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"kernel {k['name']} ({what[k['name']]}): kernel_ms={k['ms']:.4f} plain_ms="
            f"{k['plain_ms']:.4f} library_ms={lib} bound_ms={k['bound_ms']:.4f} "
            f"({k['bound_by']}) launches={k['launches']} max_abs_err={k['max_abs_err']:.3g}")
    total = time.perf_counter() - t_start
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  n_layers=L, clip_layers=cfg_clip.n_layers, build_s=t_build,
                  quantize_s=t_quant, quantize_clip_s=t_quant_clip, total_s=total,
                  peak_mem_gib=peak_gb, b1=b1, b2=b2, b3=b3, b4=b4, b5=b5, serve=serves,
                  reference_check=refc, kernels=kernels)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    log(f"total: {total:.1f} s (build {t_build:.1f} s, quantize {t_quant:.1f} + "
        f"{t_quant_clip:.1f} s), depth {L} layers (clip-only tree {cfg_clip.n_layers}), "
        f"peak device memory {peak_gb:.1f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
