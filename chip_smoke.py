#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--layers N] [--short-layers N] [--out DIR]

Phases (any failure raises, and the script exits non-zero with no result):

1. Print the card's name and power limit (``nvidia-smi``), build every CUDA
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together).
2. Quantize glm4-9b at its full published width (d_model 4096, 32/2 heads,
   hd 128, d_ff 13696, vocab 151552) and ``--layers`` deep (default 40,
   the published depth; a smaller value is a cut): random weights
   from a seeded ``torch.Generator`` on the card, quantized on the card by
   ``quantize_params`` with the serving launcher's recipe (w8, MSE clip,
   OCS r=0.02, per-channel, pad_to=1).
3. Kernel phase: each kernel's wrapper on card tensors at the shapes the
   main paths give it, held against its plain PyTorch version on the same
   inputs, and timed (CUDA events over back-to-back calls) beside its plain
   version, a library yardstick the port never calls, and its bound. B2,
   B2', B4 and B5, and their yardsticks, are also timed as device time per call:
   the same calls captured in a CUDA graph and replayed (no host work
   between the kernels).
   ``fused_qmatmul`` (B1) at every glm4-9b linear shape (the layer-0 and
   ``lm_head`` weights just quantized) with M in {1, 8, 256}: bitwise.
   ``paged_attention`` (B2) on int8, float32 and packed int4 pools (8
   lanes, ragged positions, one all-trash lane, a NaN-poisoned trash page,
   Q = 1): appended pools bitwise, outputs within ``B2_ATOL``; the same
   at pages of 1 and 2 rows (untimed).
   ``ocs_matmul`` (B4) weight-only at every shape with M in {1, 8, 256},
   on the bf16 tensor cores with the OCS tail gathered in the kernel (the
   route ``dense`` takes; checked by the wrapper's count of CUDA-core
   calls): f32 outputs within the summation-order bound
   (``WO_TOL_FACTOR``), bf16 outputs within it plus one bf16 ulp; its
   CUDA-core route (f32 x) once a shape at M = 8, within the same bound;
   int8 mode at M in {8, 256}: bitwise. A
   ``w_down`` prefill long enough to run in two row chunks (the bound on
   the split-K workspace): rows bitwise an 8-row call's, within the bound.
   ``paged_attention`` with Q > 1 query tokens per lane (B2', the
   speculative verify; Q in {2, 5, 17}) on the three pool kinds: pools
   bitwise, outputs within ``B2_ATOL``, every row bitwise the sequential
   Q = 1 launches at its position.
   ``dynamic_quant`` (B3) at K in {4096, 13696}, M in {1, 8, 256}:
   bitwise. ``w4a8_qmatmul`` (B6) at every shape (the layer-0 and lm_head
   leaves converted with ``to_w4a8(., 0.05)`` on the card, each conversion,
   and that of a stacked two-layer leaf, bitwise the same conversion on the
   CPU) with M in {1, 8, 256}: bitwise, f32 and bf16 outputs.
   Verify check, in dequant (float32 pages), w8a8 (int8) and w4a8 (int4):
   ``verify_step`` over 5 tokens of 8 lanes is bitwise 5 sequential
   ``decode_step`` calls at the full model (logits, every layer's pools,
   positions).
4. Serve phases: every launch count set to 0 just before each and read just
   after. ``ServingEngine`` serves 8 seeded requests (prompts of 16-256
   tokens, 32 new tokens each, greedy) with ``EngineConfig(max_batch=8,
   max_len=512, page_size=16)`` and (a) ``matmul_mode="w8a8", kv_bits=8``,
   (b) the defaults, ``dequant`` on float32 pages, (c) ``matmul_mode="w4a8",
   kv_bits=4``: the engine converts the int8 tree to W4A8 leaves on the
   card. Asserts that every request finishes by length, that parameters
   and pools lie on the card (pools of the phase's dtype), that the phase's
   matmul kernel (B1 for w8a8, B4 for dequant, B6 for w4a8) ran 7*L+1
   times per decode step and per prefill call and the others not at all
   (B4 never on its CUDA-core route),
   and ``paged_attention`` L times per decode step. Then self-speculative
   decoding (``EngineConfig.spec``) on the same requests: (d) dequant on
   float32 pages with the default drafter (w8a8, k <= 4), (e) w8a8 on int8
   pages drafting with the first 10 layers, (f) w4a8 on int4 pages drafting
   in w4a8. Each is held token for token against the plain phase of its
   mode, its allocator state at retire against that phase's, and its
   launches against the count its rounds and draft steps give. Then, on
   the first ``--short-layers`` layers of the same tree (default 10; the
   second cut), a plain w8a8 phase and (g) ``SpecConfig(k=16,
   adaptive=False)`` in w8a8 on int8 pages (verify Q = 17; the draft is
   the target: every draft accepted), held against it likewise.
5. Clip-only tree: the OCS tree is freed, the same seeded weights are made
   again and quantized with ``ocs_ratio=0`` (the paper's baseline, no
   split), ``--short-layers`` deep (default 10). ``quant_matmul``
   (B5) is checked and timed as B4 at its shapes (weight-only and int8),
   and the tree is served in ``dequant`` mode as in 4(b): B5 7*L+1 times
   per step and call, B4 and B1 not at all.
6. Reference check: a smoke-size glm4-9b run through prefill and
   teacher-forced decode on the card (kernels) and on the CPU (plain
   versions) from the same weights, in w8a8 (int8 pages), dequant (float
   pages), dequant on a clip-only tree and w4a8 (int4 pages), the decode
   followed by a teacher-forced ``verify_step`` of 5 tokens; logits agree
   within ``MODEL_RTOL`` of the largest logit.

Output: a ``time:`` line at the end of each phase (seconds since the
start), a ``kernels`` JSON line (every kernel's launches on its path,
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


def graph_ms(fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph
    (after one call outside it, which sizes the wrappers' kept workspaces)
    and replayed, timed with CUDA events: the kernels back to back with no
    host work between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / iters
    del graph
    return ms


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


def b2_case(gen, kind, Q=1, B=8, H=32, KV=2, hd=128, ps=16, max_len=512, poison=False):
    """``kind`` ("int8", "float32" or "int4") pools, ragged tables (lane 7
    all trash), ``Q`` query tokens per lane at positions up to max_len-1
    (first positions lowered so a window never runs past the table); with
    ``poison`` the trash page holds NaN (it must never reach an output)."""
    import torch

    T = max_len // ps
    P = B * T + 1
    if kind == "float32":
        pool = {
            "k": torch.randn((P, KV, ps, hd), generator=gen, device="cuda"),
            "v": torch.randn((P, KV, ps, hd), generator=gen, device="cuda"),
        }
    else:
        lo, hi, dt, row = ((-127, 128, torch.int8, hd) if kind == "int8"
                           else (0, 256, torch.int32, hd // 2))
        pool = {
            "k": torch.randint(lo, hi, (P, KV, ps, row), generator=gen, device="cuda",
                               dtype=dt),
            "v": torch.randint(lo, hi, (P, KV, ps, row), generator=gen, device="cuda",
                               dtype=dt),
            "k_scale": torch.rand((P, KV, ps), generator=gen, device="cuda") * 0.02 + 1e-3,
            "v_scale": torch.rand((P, KV, ps), generator=gen, device="cuda") * 0.02 + 1e-3,
        }
        if kind == "int4":  # packed nibbles
            pool["k"] = pool["k"].to(torch.uint8)
            pool["v"] = pool["v"].to(torch.uint8)
    if poison:
        for key in ("k", "v") if kind == "float32" else ("k_scale", "v_scale"):
            pool[key][0] = float("nan")
    pos = torch.tensor([17, 511, 256, 40, 130, 300, 5, 0], dtype=torch.int32)[:B]
    pos = pos.clamp_max(max_len - Q)
    table = torch.zeros((B, T), dtype=torch.int32)
    nxt = 1
    for b in range(B - 1):
        for t in range((int(pos[b]) + Q - 1) // ps + 1):
            table[b, t] = nxt
            nxt += 1
    q = (torch.randn((B, Q, H, hd), generator=gen, device="cuda")).to(torch.bfloat16)
    kn = (torch.randn((B, Q, KV, hd), generator=gen, device="cuda")).to(torch.bfloat16)
    vn = (torch.randn((B, Q, KV, hd), generator=gen, device="cuda")).to(torch.bfloat16)
    return pool, table.to("cuda"), pos.to("cuda"), q, kn, vn


def sdpa(pool, table, pos, q, kind):
    """Library yardstick: SDPA over the dequantized, gathered pages
    (gathered here, outside any timing; KV heads expanded to the query
    heads; a poisoned trash page read as zeros), query j of a lane seeing
    positions <= pos + j of readable pages. Returns the call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import unpack_int4

    b, qn, h, hd = q.shape
    kvh, ps = pool["k"].shape[1:3]
    tl = table.long()
    kg, vg = pool["k"][tl], pool["v"][tl]
    if kind == "int4":
        kg, vg = unpack_int4(kg), unpack_int4(vg)
    kg, vg = kg.float(), vg.float()
    if kind != "float32":
        kg = kg * pool["k_scale"][tl][..., None]
        vg = vg * pool["v_scale"][tl][..., None]
    L = tl.shape[1] * ps
    kg = kg.movedim(2, 1).reshape(b, kvh, L, hd).nan_to_num(0.0)
    vg = vg.movedim(2, 1).reshape(b, kvh, L, hd).nan_to_num(0.0)
    kg = kg.repeat_interleave(h // kvh, dim=1)
    vg = vg.repeat_interleave(h // kvh, dim=1)
    bound = pos[:, None].long() + torch.arange(qn, device="cuda")[None, :]  # [B, Q]
    mask = (torch.arange(L, device="cuda")[None, None, :] <= bound[:, :, None]) & \
        torch.repeat_interleave(table != 0, ps, dim=1)[:, None, :]
    qf = q.float().movedim(1, 2)
    return lambda: F.scaled_dot_product_attention(qf, kg, vg, attn_mask=mask[:, None])


def b2_bound_ms(pool, table, pos, q):
    import torch

    scaled = pool["k"].dtype != torch.float32
    b, qn, h, hd = q.shape
    kvh, ps, hdp = pool["k"].shape[1:4]
    t = table.shape[1]
    elt = pool["k"].element_size()  # hdp = hd / 2 bytes for int4 pools
    row = kvh * (2 * hdp * elt + (8 if scaled else 0))  # k + v (+ 2 scales)
    pages = attended = 0
    tab = table.cpu()
    for i, p in enumerate(pos.cpu().tolist()):
        n_act = min(t, (p + qn - 1) // ps + 1)
        pages += sum(1 for j in range(n_act) if int(tab[i, j]) != 0)
        attended += qn * p + qn * (qn + 1) // 2  # query j attends p + j + 1 positions
    byts = (pages * ps * row + b * qn * h * hd * 2 + 2 * b * qn * kvh * hd * 2
            + b * qn * row + table.numel() * 4 + b * 4 + b * qn * h * hd * 4)
    flops = 4.0 * h * hd * attended
    t_b, t_o = byts / HBM_BPS, flops / F32_FLOPS
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def b2_times(work, pool, want_pool, table, pos, q, kn, vn, kind, iters):
    """B2's wall and device ms per call (back-to-back calls; a CUDA graph of
    them), its plain version's wall ms, SDPA's wall and device ms."""
    from repro_torch.kernels import paged_attention as pa

    def kern():
        pa.paged_attention_cuda(work, table, pos, q, kn, vn)

    lib = sdpa(want_pool, table, pos, q, kind)
    return dict(ms=time_ms(kern, iters), device_ms=graph_ms(kern, iters),
                plain_ms=time_ms(lambda: pa.paged_attention_plain(pool, table, pos, q, kn, vn),
                                 max(2, iters // 5), warmup=1),
                library_ms=time_ms(lib, iters), library_device_ms=graph_ms(lib, iters))


def b2_checked(label, pool, table, pos, q, kn, vn):
    """One B2 call on a copy of ``pool`` against the plain version: pools
    bitwise, outputs finite and within ``B2_ATOL``, the all-trash lane 7
    exact zeros. Returns (the appended copy, the plain version's pool, max
    |d|)."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    want_out, want_pool = pa.paged_attention_plain(pool, table, pos, q, kn, vn)
    work = {k: v.clone() for k, v in pool.items()}
    got_out, got_pool = pa.paged_attention_cuda(work, table, pos, q, kn, vn)
    torch.cuda.synchronize()
    for key in want_pool:
        if not same_bits(got_pool[key], want_pool[key]):
            raise AssertionError(f"{label}: pool {key} differs")
    if not torch.isfinite(got_out).all():
        raise AssertionError(f"{label}: nonfinite output (trash page leaked)")
    err = (got_out - want_out).abs().max().item()
    if err > B2_ATOL:
        raise AssertionError(f"{label}: max |d| {err} > {B2_ATOL}")
    if got_out[7].abs().max().item() != 0.0:
        raise AssertionError(f"{label}: the all-trash lane is not exact zeros")
    return work, want_pool, err


def kernel_phase_b2(gen, iters):
    from repro_torch.kernels import paged_attention as pa

    rows = []
    for kind in ("int8", "float32", "int4"):
        pool, table, pos, q, kn, vn = b2_case(gen, kind, poison=True)
        work, want_pool, err = b2_checked(f"paged_attention {kind}", pool, table, pos, q, kn,
                                          vn)
        tm = b2_times(work, pool, want_pool, table, pos, q, kn, vn, kind, iters)
        b, _, h, hd = q.shape
        kvh, ps = pool["k"].shape[1:3]
        bound, by = b2_bound_ms(pool, table, pos, q)
        pages, chunks = pa.chunk_plan(int(table.shape[1]), ps, hd)
        rows.append(dict(pool=kind, B=b, H=h, KV=kvh, hd=hd,
                         ps=ps, T=int(table.shape[1]), chunk_pages=pages, chunks=chunks,
                         bound_ms=bound, bound_by=by, max_abs_err=err, **tm))
        log(f"B2 paged_attention pool={kind} B={b} H={h}/{kvh} hd={hd} ps={ps} "
            f"({chunks} chunks of {pages} pages): kernel_ms={tm['ms']:.4f} device_ms="
            f"{tm['device_ms']:.4f} plain_ms={tm['plain_ms']:.4f} library_ms="
            f"{tm['library_ms']:.4f} library_device_ms={tm['library_device_ms']:.4f} "
            f"bound_ms={bound:.5f} ({by}) max_abs_err={err:.3g} pools bitwise=yes")
    # Pages of 1 and 2 rows, which the engine takes too: checked, not timed.
    for ps in (1, 2):
        for kind in ("int8", "float32", "int4"):
            pool, table, pos, q, kn, vn = b2_case(gen, kind, ps=ps, poison=True)
            _, _, err = b2_checked(f"paged_attention {kind} ps={ps}", pool, table, pos, q, kn,
                                   vn)
            pages, chunks = pa.chunk_plan(int(table.shape[1]), ps, q.shape[-1])
            rows.append(dict(pool=kind, ps=ps, T=int(table.shape[1]), chunk_pages=pages,
                             chunks=chunks, max_abs_err=err, timed=False))
            log(f"B2 paged_attention pool={kind} ps={ps} ({chunks} chunks of {pages} pages): "
                f"max_abs_err={err:.3g} pools bitwise=yes (untimed)")
            del pool
    return rows


# B2's multi-row path: the verify windows of the spec phases (Q = k + 1 for
# the default k = 4) and of SpecConfig(k=16), and a short one.
B2V_QS = (2, 5, 17)


def kernel_phase_b2v(gen, iters):
    """B2's Q > 1 rows (the speculative verify) on int8, float32 and int4
    pools at Q in ``B2V_QS``: pools bitwise the plain version's (the trash
    page, which several rows write and nothing reads, aside), outputs within
    ``B2_ATOL``, and every row bitwise the sequential Q = 1 launches at its
    position."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    rows = []
    for kind in ("int8", "float32", "int4"):
        for qn in B2V_QS:
            pool, table, pos, q, kn, vn = b2_case(gen, kind, Q=qn, poison=True)
            want_out, want_pool = pa.paged_attention_plain(pool, table, pos, q, kn, vn)
            work = {k: v.clone() for k, v in pool.items()}
            got_out, got_pool = pa.paged_attention_cuda(work, table, pos, q, kn, vn)
            seq = {k: v.clone() for k, v in pool.items()}
            outs = []
            for j in range(qn):
                o, seq = pa.paged_attention_cuda(seq, table, pos + j, q[:, j:j + 1].contiguous(),
                                                 kn[:, j:j + 1].contiguous(),
                                                 vn[:, j:j + 1].contiguous())
                outs.append(o)
            torch.cuda.synchronize()
            for key in want_pool:
                if not same_bits(got_pool[key][1:], want_pool[key][1:]):
                    raise AssertionError(f"paged_attention Q={qn} {kind}: pool {key} differs")
                if not same_bits(seq[key][1:], got_pool[key][1:]):
                    raise AssertionError(f"paged_attention Q={qn} {kind}: pool {key} differs "
                                         "from the sequential Q=1 launches'")
            if not torch.isfinite(got_out).all() or got_out[7].abs().max().item() != 0.0:
                raise AssertionError(f"paged_attention Q={qn} {kind}: nonfinite output or "
                                     "the all-trash lane not zeros")
            err = (got_out - want_out).abs().max().item()
            if err > B2_ATOL:
                raise AssertionError(f"paged_attention Q={qn} {kind}: max |d| {err} > {B2_ATOL}")
            if not same_bits(torch.cat(outs, 1), got_out):
                raise AssertionError(f"paged_attention Q={qn} {kind}: rows differ from the "
                                     "sequential Q=1 launches")
            tm = b2_times(work, pool, want_pool, table, pos, q, kn, vn, kind, iters)
            bound, by = b2_bound_ms(pool, table, pos, q)
            b, _, h, hd = q.shape
            rows.append(dict(pool=kind, Q=qn, B=b, H=h, KV=pool["k"].shape[1], hd=hd,
                             bound_ms=bound, bound_by=by, max_abs_err=err,
                             tile_rows=pa.tile_rows(qn, h // pool["k"].shape[1], hd, 16), **tm))
            log(f"B2' paged_attention pool={kind} Q={qn} B={b} H={h}/{pool['k'].shape[1]} "
                f"hd={hd}: kernel_ms={tm['ms']:.4f} device_ms={tm['device_ms']:.4f} plain_ms="
                f"{tm['plain_ms']:.4f} library_ms={tm['library_ms']:.4f} library_device_ms="
                f"{tm['library_device_ms']:.4f} bound_ms={bound:.5f} ({by}) max_abs_err="
                f"{err:.3g} pools bitwise=yes, rows bitwise the sequential Q=1 launches")
            del pool, work, seq, want_pool
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


def cycling(fn, copies):
    """A call of ``fn`` on the next of ``copies`` each time."""
    state = {"i": 0}

    def run():
        state["i"] = (state["i"] + 1) % len(copies)
        fn(copies[state["i"]])

    return run


def time_cycled(fn, copies, iters, warmup=2):
    return time_ms(cycling(fn, copies), iters, warmup)


def wo_times(run_kern, xeb, ws, wb_copies, iters):
    """Wall and device ms of ``run_kern`` (a weight-only call cycling its
    weight copies) and of its library yardstick: bf16 ``torch.matmul`` of
    the materialized expanded activations ``xeb`` and the weights converted
    to bf16 before the timing (``wb_copies``), then the column scales
    ``ws``. Device times are CUDA graphs of the same calls."""
    import torch

    run_lib = cycling(lambda wb: torch.matmul(xeb, wb) * ws, wb_copies)
    return dict(ms=time_ms(run_kern, iters), library_ms=time_ms(run_lib, iters),
                device_ms=graph_ms(run_kern, iters),
                library_device_ms=graph_ms(run_lib, iters))


def wo_tol(xe, w8, ws, k, s):
    """The summation-order bound of a weight-only output against its plain
    version, elementwise: ``WO_TOL_FACTOR * (K + S + 2) * 2**-24 *
    (|x_exp| @ |w8|) * |ws|`` (``xe``: the expanded activations, f32)."""
    from repro_torch.kernels import ref

    return (WO_TOL_FACTOR * (k + s + 2) * 2.0 ** -24
            * ref.float_matmul(xe.abs(), w8.abs()) * ws.abs())


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
    it, wall and device), int8 at M in {8, 256} (bitwise). B4's bf16 calls
    must all take the tensor cores; its CUDA-core route (f32 x) is checked
    once a shape at M = 8, within the same bound."""
    import torch
    from repro_torch.kernels import ocs_matmul as om
    from repro_torch.kernels import quant_matmul as qm

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
            packed = w.is_packed()  # as dense declares a packed leaf's mask

            def kern(x, wt, out_dtype):
                return om.ocs_quant_matmul_cuda(x, wt, ws, src, tail_mult=mult,
                                                tail_is_mask=packed, out_dtype=out_dtype)

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
        n_cuda_cores = om.launches_cuda_cores
        for m in (1, 8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            xe = torch.cat([x.float(), x[:, src.long()].float() * mult], 1) if s else x.float()
            got, want = kern(x, w8, torch.float32), plain(x, torch.float32)
            torch.cuda.synchronize()
            tol = wo_tol(xe, w8, ws, k, s)
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
            t = wo_times(cycling(lambda wt: kern(x, wt, torch.bfloat16), copies),
                         xe.to(torch.bfloat16), ws, wb_copies, iters)
            plain_ms = time_ms(lambda: plain(x, torch.bfloat16), max(2, iters // 5), warmup=1)
            bound, by = matmul_bound_ms(m, k, s, n, x_bytes=2, out_bytes=2,
                                        peak_ops=BF16_FLOPS)
            err_max = err.max().item()
            rows.append(dict(mode="weight-only", names=names, M=m, K=k, S=s, N=n,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             max_abs_err=err_max, tol_share=ratio, bf16_steps=ulps, **t))
            log(f"{label} weight-only {'/'.join(names)} M={m} K={k}+{s} N={n}: kernel_ms="
                f"{t['ms']:.4f} device_ms={t['device_ms']:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={t['library_ms']:.4f} library_device_ms="
                f"{t['library_device_ms']:.4f} bound_ms={bound:.4f} ({by}) f32 max|d|="
                f"{err_max:.3g} ({ratio:.3g} of bound), bf16 within bound + 1 ulp")
        del wb_copies
        if om.launches_cuda_cores != n_cuda_cores:
            raise AssertionError(f"{label} {names}: bf16 x left the tensor cores")
        if s:
            # B4's CUDA-core route, which f32 x takes, at this full-width shape.
            x = torch.randn((8, k), generator=gen, device="cuda") * 2.0
            got, want = kern(x, w8, torch.float32), plain(x, torch.float32)
            torch.cuda.synchronize()
            if om.launches_cuda_cores != n_cuda_cores + 1:
                raise AssertionError(f"{label} {names}: f32 x did not take the CUDA cores")
            err = (got - want).abs()
            ratio = (err / wo_tol(torch.cat([x, x[:, src.long()] * mult], 1), w8, ws, k, s)
                     .clamp_min(1e-30)).max().item()
            if not torch.isfinite(got).all() or ratio > 1.0:
                raise AssertionError(f"{label} f32 x (CUDA cores) {names} M=8: |kernel - "
                                     f"plain| is {ratio:.3g} of the summation-order bound")
            log(f"{label} f32 x (CUDA-core route) {'/'.join(names)} M=8 K={k}+{s} N={n}: "
                f"f32 max|d|={err.max().item():.3g} ({ratio:.3g} of bound)")
        if names == ["w_down"]:
            rows.append(wo_chunk_case(label, kern, plain, k, s, n, w8, ws, src, mult, gen,
                                      iters))
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


def wo_chunk_case(label, kern, plain, k, s, n, w8, ws, src, mult, gen, iters):
    """A prefill long enough that the weight-only GEMM runs in two row
    chunks (``quant_matmul.wo_row_chunk``, which bounds its split-K
    workspace): rows at the start, across the chunk boundary and at the end
    bitwise the same rows in an 8-row call; every output within the
    summation-order bound of the plain version; timed."""
    import torch
    from repro_torch.kernels import quant_matmul as qm

    # The tensor-core split plan of B5's K rows or B4's Kb + S virtual rows.
    nsplit = qm.tc_split_plan(qm.tc_rows(k, s), n)[1]
    chunk = qm.wo_row_chunk(1 << 30, n, nsplit)
    m = chunk + 64
    x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
    got = kern(x, w8, torch.float32)
    for lo in (0, chunk - 4, m - 8):
        if not same_bits(kern(x[lo:lo + 8].contiguous(), w8, torch.float32), got[lo:lo + 8]):
            raise AssertionError(f"{label} weight-only w_down M={m}: rows {lo}..{lo + 7} "
                                 "differ from the same rows in an 8-row call")
    want = plain(x, torch.float32)
    xe = torch.cat([x.float(), x[:, src.long()].float() * mult], 1) if s else x.float()
    tol = wo_tol(xe, w8, ws, k, s)
    err = (got - want).abs()
    ratio = (err / tol.clamp_min(1e-30)).max().item()
    if not torch.isfinite(got).all() or ratio > 1.0:
        raise AssertionError(f"{label} weight-only w_down M={m}: |kernel - plain| is "
                             f"{ratio:.3g} of the summation-order bound")
    del want, tol, xe
    ms = time_ms(lambda: kern(x, w8, torch.bfloat16), iters)
    plain_ms = time_ms(lambda: plain(x, torch.bfloat16), max(2, iters // 5), warmup=1)
    bound, by = matmul_bound_ms(m, k, s, n, x_bytes=2, out_bytes=2, peak_ops=BF16_FLOPS)
    part_mib = 4 * nsplit * chunk * n / 2**20
    log(f"{label} weight-only w_down M={m} K={k}+{s} N={n} in 2 row chunks of <= {chunk} "
        f"(split-K workspace {part_mib:.1f} MiB; {4 * nsplit * m * n / 2**20:.1f} MiB in one "
        f"launch): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by}) "
        f"f32 max|d|={err.max().item():.3g} ({ratio:.3g} of bound); rows bitwise an 8-row "
        "call's")
    return dict(mode="weight-only", names=["w_down"], M=m, K=k, S=s, N=n, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=err.max().item(), tol_share=ratio, row_chunk=chunk,
                workspace_mib=part_mib)


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


# The W4A8 tier's outlier fraction: EngineConfig's default, the reference's.
W4A8_RATIO = 0.05


def w4a8_bound_ms(m, k, s, t, n):
    """Each input read once (x bf16, the packed int4 weights, the int8
    outlier rows, both scales, src_tail and outlier_idx), the bf16 output
    written once, at HBM rate; or the int8 multiply-adds of both products
    at 1,979 TOP/s: the larger."""
    byts = m * k * 2 + (k + s) // 2 * n + t * n + 8 * n + 4 * (s + t) + m * n * 2
    ops = 2.0 * m * (k + s + t) * n
    t_b, t_o = byts / HBM_BPS, ops / INT8_OPS
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def to_w4a8_checked(name, leaf):
    """``to_w4a8(leaf, W4A8_RATIO)`` on the card, as the engine converts
    its tree, held bitwise against the same conversion of ``leaf`` on the
    CPU (which tests/test_torch_w4a8.py holds bitwise against the
    reference's numpy conversion): all five arrays and the padded spec."""
    from repro_torch.core.apply import tree_to
    from repro_torch.core.ocs import to_w4a8

    def arrays(lin):
        return {"w4": lin.w4, "s4": lin.s4, "w8": lin.w8, "s8": lin.s8,
                "outlier_idx": lin.outlier_idx, "spec.src": lin.spec.src,
                "spec.mult": lin.spec.mult, "spec.bias": lin.spec.bias}

    card = to_w4a8(leaf, W4A8_RATIO)
    cpu = to_w4a8(tree_to(leaf, "cpu"), W4A8_RATIO)
    got, want = arrays(card), arrays(cpu)
    bad = [k for k in got if got[k].shape != want[k].shape
           or not same_bits(got[k].cpu(), want[k])]
    if bad or (card.n_orig, card.a_bits) != (cpu.n_orig, cpu.a_bits):
        raise AssertionError(f"to_w4a8 {name}: the card's conversion differs from the "
                             f"CPU's in {bad or ['n_orig/a_bits']}")
    return card


def head_layers(qparams, n):
    """The first ``n`` layers of a quantized tree (views, no copy)."""
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear

    layers = map_with_path(lambda _p, leaf: stacked_head(leaf, n)
                           if isinstance(leaf, OCSQuantLinear) else leaf[:n],
                           qparams["layers"])
    return dict(qparams, layers=layers)


def stacked_head(lin, n):
    """The first ``n`` layers of a stacked ``OCSQuantLinear`` leaf (views)."""
    from repro_torch.core.ocs import OCSQuantLinear, OCSSpec
    from repro_torch.core.quantizer import QuantParams

    w, sp = lin.weight, lin.spec
    return OCSQuantLinear(
        weight=QuantParams(w.values[:n], w.scale[:n], w.bits, w.channel_axis),
        spec=OCSSpec(sp.src[:n], sp.mult[:n], sp.bias[:n]), n_orig=lin.n_orig,
        a_bits=lin.a_bits, a_scale=None if lin.a_scale is None else lin.a_scale[:n])


def kernel_phase_b6(qparams, gen, iters):
    """w4a8_qmatmul at every glm4-9b linear shape x M in {1, 8, 256}: the
    layer-0 and lm_head leaves converted with ``to_w4a8`` on the card (every
    one, and a stacked two-layer ``w_down``, bitwise the CPU's conversion);
    bitwise against the plain version with f32 and bf16 outputs; timed with
    bf16 outputs, as ``dense`` calls it."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import w4a8_qmatmul as w4k

    weights = layer_weights(qparams)
    t0 = time.perf_counter()
    converted = {name: to_w4a8_checked(name, w) for name, w in weights.items()}
    to_w4a8_checked("w_down layers 0-1 (stacked)",
                    stacked_head(qparams["layers"]["mlp"]["w_down"], 2))
    log(f"to_w4a8 on the card: bitwise the CPU's conversion (w4, s4, w8, s8, outlier_idx, "
        f"spec) for {', '.join(weights)} and a stacked two-layer w_down "
        f"({time.perf_counter() - t0:.1f} s with the CPU side)")
    groups = {}
    for name, w in weights.items():
        groups.setdefault((w.n_orig, w.weight.values.shape[1]), []).append(name)
    rows = []
    for (k, n), names in groups.items():
        lin = converted[names[0]]
        w4, w8 = lin.w4, lin.w8
        src = lin.spec.src[lin.n_orig:].contiguous()
        oidx = lin.outlier_idx
        s, t = src.shape[0], oidx.shape[0]

        def kern(x, ws, out_dtype):
            return w4k.w4a8_matmul_cuda(x, ws[0], lin.s4, ws[1], lin.s8, src, oidx,
                                        out_dtype=out_dtype)

        def plain(x, out_dtype):
            return w4k.w4a8_matmul_plain(x, w4, lin.s4, w8, lin.s8, src, oidx,
                                         out_dtype=out_dtype)

        nbytes = w4.numel() + w8.numel()
        n_copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        copies = [(w4, w8)] + [(w4.clone(), w8.clone()) for _ in range(n_copies - 1)]
        # Library yardstick: torch._int_mm on the materialized expanded
        # activations and the int4 weights unpacked to int8 before the
        # timing, the outlier product likewise, then the epilogue.
        ke = k + s
        kp, tp = ke + (-ke) % 8, t + (-t) % 8
        wq = torch.zeros((kp, n), dtype=torch.int8, device="cuda")
        wq[:ke] = pa.unpack_int4(w4.T).T
        w8p = torch.zeros((tp, n), dtype=torch.int8, device="cuda")
        w8p[:t] = w8
        lib_copies = cycled(wq)
        for m in (1, 8, 256):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            for out_dtype in (torch.float32, torch.bfloat16):
                got, want = kern(x, (w4, w8), out_dtype), plain(x, out_dtype)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    d = (got.float() - want.float()).abs().max().item()
                    raise AssertionError(f"w4a8_qmatmul {names} M={m} {out_dtype}: not "
                                         f"bitwise (max |d| {d})")
            ms = time_cycled(lambda ws: kern(x, ws, torch.bfloat16), copies, iters)
            plain_ms = time_ms(lambda: plain(x, torch.bfloat16), max(2, iters // 5), warmup=1)
            q, sc = pa.quant_rows(x, 127.0)
            qe = torch.cat([q, q[:, src.long()]], 1) if s else q
            mp = max(m, 32)
            qp = torch.zeros((mp, kp), dtype=torch.int8, device="cuda")
            qp[:m, :ke] = qe
            q8 = torch.zeros((mp, tp), dtype=torch.int8, device="cuda")
            q8[:m, :t] = qe[:, oidx.long()]
            scp = torch.zeros((mp,), dtype=torch.float32, device="cuda")
            scp[:m] = sc

            def lib(wqc):
                y = torch._int_mm(qp, wqc).float() * (scp[:, None] * lin.s4[None, :])
                if t:
                    y = y + torch._int_mm(q8, w8p).float() * (scp[:, None] * lin.s8[None, :])
                return y.to(torch.bfloat16)

            lib_ms = time_cycled(lib, lib_copies, iters)
            del qp, q8
            bound, by = w4a8_bound_ms(m, k, s, t, n)
            rows.append(dict(names=names, M=m, K=k, S=s, T=t, N=n, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound, bound_by=by,
                             max_abs_err=0.0))
            log(f"B6 w4a8_qmatmul {'/'.join(names)} M={m} K={k}+{s} T={t} N={n}: "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bound:.4f} ({by}) bitwise=yes (f32 and bf16 out)")
        del copies, lib_copies, wq, w8p, lin
    del converted
    return rows


def counters():
    """Every launch count: name -> (wrapper module, count attribute).
    ``paged_attention_verify`` is B2's count of Q > 1 calls,
    ``ocs_matmul_cuda_cores`` B4's of calls on its CUDA-core route (none on
    a serving path: ``dense`` gives it bf16 x and declares a packed leaf's
    0/1 mask)."""
    from repro_torch.kernels import dynamic_quant, fused_qmatmul, ocs_matmul
    from repro_torch.kernels import paged_attention, quant_matmul, w4a8_qmatmul

    return {"fused_qmatmul": (fused_qmatmul, "launches"),
            "paged_attention": (paged_attention, "launches"),
            "paged_attention_verify": (paged_attention, "launches_verify"),
            "ocs_matmul": (ocs_matmul, "launches"),
            "ocs_matmul_cuda_cores": (ocs_matmul, "launches_cuda_cores"),
            "quant_matmul": (quant_matmul, "launches"),
            "dynamic_quant": (dynamic_quant, "launches"),
            "w4a8_qmatmul": (w4a8_qmatmul, "launches")}


# The matmul kernel each mode runs on an OCS tree.
MODE_KERNEL = {"dequant": "ocs_matmul", "w8a8": "fused_qmatmul", "w4a8": "w4a8_qmatmul"}


def alloc_state(a):
    """The allocator's state once every request has retired: pages in use,
    free and cached, refcounts, the prefix cache's chain keys, its counters
    and the peak (which page ids sit where on the free list follows the
    order lanes retire in)."""
    return (a.in_use(), a.available(), a.cached_pages(), dict(a._ref), sorted(a._page_of),
            a.prefix_hit_pages, a.prefix_lookup_pages, a.peak_in_use)


def serve_phase(label, cfg, qparams, seed, card, ecfg, matmul_kernel, plain=None):
    """Serve 8 seeded requests; every launch count is set to 0 just before
    and read just after. ``matmul_kernel`` must run 7*L+1 times per decode
    step and per prefill call, the other matmul kernels not at all.

    With ``ecfg.spec`` set, each step is a speculation round: the target's
    kernel runs 7*L+1 times per round and per prefill call, the drafter's
    (``MODE_KERNEL[spec.draft_mode]``) 7*n+1 times per draft step over its
    n layers, B2 n times per draft step and L times per one-token round,
    B2's Q > 1 path L times per other round; the outputs must equal
    ``plain``'s (the plain phase of the same mode on the same prompts) token
    for token, and the allocator must end in its state."""
    import numpy as np
    import torch
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear, W4A8Linear
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import kv_cache as kvc

    t0 = time.perf_counter()
    eng = ServingEngine(cfg, qparams, ecfg, device="cuda")
    torch.cuda.synchronize()
    t_construct = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    reqs = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(16, 257))).tolist(),
                max_new_tokens=32)
        for i in range(8)
    ]
    for r in reqs:
        eng.submit(r)
    mods = counters()
    for mod, _ in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: getattr(mod, attr) for name, (mod, attr) in mods.items()}
    stats = eng.stats()
    L = cfg.n_layers
    if len(done) != 8 or any(r.finish_reason != "length" for r in done):
        raise AssertionError(f"{label}: finish reasons {[r.finish_reason for r in done]}")
    if any(len(r.output) != 32 for r in done):
        raise AssertionError(f"{label}: a request did not produce 32 tokens")

    weight_bytes = {"int8": 0, "w4a8": 0}

    def on_card(_p, leaf):
        ts = [leaf] if isinstance(leaf, torch.Tensor) else (
            [leaf.weight.values, leaf.weight.scale, leaf.spec.src, leaf.spec.mult,
             leaf.spec.bias] if isinstance(leaf, OCSQuantLinear) else
            [leaf.w4, leaf.s4, leaf.w8, leaf.s8, leaf.outlier_idx, leaf.spec.src,
             leaf.spec.mult, leaf.spec.bias] if isinstance(leaf, W4A8Linear) else [])
        if isinstance(leaf, OCSQuantLinear):
            weight_bytes["int8"] += leaf.weight.values.numel()
        if isinstance(leaf, W4A8Linear):
            weight_bytes["w4a8"] += leaf.w4.numel() + leaf.w8.numel()
            if ecfg.matmul_mode != "w4a8":
                raise AssertionError("a W4A8Linear leaf outside the w4a8 tier")
        elif isinstance(leaf, OCSQuantLinear) and ecfg.matmul_mode == "w4a8":
            raise AssertionError(f"{'/'.join(map(str, _p))} not converted to W4A8Linear")
        for t in ts:
            if not t.is_cuda:
                raise AssertionError(f"parameter {'/'.join(map(str, _p))} not on the card")
        return leaf

    map_with_path(on_card, eng.params)
    pool_kind = {None: "float32", 8: "int8", 4: "int4"}[ecfg.kv_bits]
    want_dtype = {"float32": torch.float32, "int8": torch.int8, "int4": torch.uint8}[pool_kind]
    for layer in eng.caches["layers"]:
        for t in layer["attn"].values():
            if not t.is_cuda:
                raise AssertionError("a pool tensor is not on the card")
        if layer["attn"]["k"].dtype != want_dtype:
            raise AssertionError(f"{label}: pool values are {layer['attn']['k'].dtype}")
    steps, calls = stats["decode_steps"], stats["prefill_calls"]
    want = {name: 0 for name in counts}
    want[matmul_kernel] = (7 * L + 1) * (steps + calls)
    spec = ecfg.spec
    if spec is None:
        want["paged_attention"] = L * steps
    else:
        dec = eng._spec
        n = min(spec.draft_layers or L, L)
        want[MODE_KERNEL[spec.draft_mode]] += (7 * n + 1) * dec.draft_steps
        want["paged_attention"] = n * dec.draft_steps + L * dec.plain_rounds
        want["paged_attention_verify"] = L * (dec.rounds - dec.plain_rounds)
        if not want["paged_attention_verify"]:
            raise AssertionError(f"{label}: no round verified more than one token")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, want {want}")
    outputs = {r.uid: list(r.output) for r in done}
    alloc = alloc_state(eng.allocator)
    if plain is not None:
        bad = sorted(uid for uid in outputs if outputs[uid] != plain["outputs"][uid])
        if bad:
            raise AssertionError(f"{label}: requests {bad} differ from the plain phase's tokens")
        if alloc != plain["alloc"]:
            raise AssertionError(f"{label}: allocator state {alloc} at retire differs from the "
                                 f"plain phase's {plain['alloc']}")
    tree = "w4a8" if ecfg.matmul_mode == "w4a8" else "int8"
    log(f"serve {label}: engine built in {t_construct:.2f} s; quantized weight bytes "
        f"{weight_bytes[tree] / 1e9:.3f} GB ({tree} leaves); KV bytes per token "
        f"{kvc.kv_bytes_per_token(eng.cfg)} ({pool_kind} pages)")
    log(f"serve {label}: {len(done)} requests, {stats['prefill_tokens']} prompt tokens over "
        f"{calls} prefill calls, {steps} decode steps, {stats['decoded_tokens']} decoded "
        f"tokens, {pool_kind} pages, wall {wall:.2f} s")
    log(f"serve {label} on {card}: prefill {stats['prefill_tok_per_s']:.1f} tok/s | decode "
        f"{stats['decode_tok_per_s']:.1f} tok/s | ttft p50 {stats['ttft_p50_s'] * 1e3:.1f} ms "
        f"p95 {stats['ttft_p95_s'] * 1e3:.1f} ms | itl p50 {stats['itl_p50_s'] * 1e3:.2f} ms "
        f"p95 {stats['itl_p95_s'] * 1e3:.2f} ms")
    if spec is None:
        log(f"serve {label}: {matmul_kernel} wrapper calls {counts[matmul_kernel]} = "
            f"(7*{L}+1) x ({steps} decode steps + {calls} prefill calls); paged_attention "
            f"{counts['paged_attention']} = {L} x {steps}; others 0")
    else:
        log(f"serve {label}: {spec}: {stats['spec_rounds']:.0f} rounds ({dec.plain_rounds} "
            f"of one token), {dec.draft_steps} draft steps; acceptance "
            f"{stats['spec_acceptance_rate']:.4f}, {stats['spec_tokens_per_target_step']:.4f} "
            f"tokens per target step; draft {stats['spec_draft_time_s']:.3f} s, verify "
            f"{stats['spec_verify_time_s']:.3f} s; launch counts "
            f"{ {k: v for k, v in counts.items() if v} } as reckoned; tokens identical to the "
            f"plain phase's, allocator state at retire equal")
    return dict(stats=stats, wall_s=wall, launches=counts, n_layers=L, pool=pool_kind,
                construct_s=t_construct, weight_bytes=weight_bytes[tree],
                kv_bytes_per_token=kvc.kv_bytes_per_token(eng.cfg), outputs=outputs,
                alloc=alloc, spec=None if spec is None else dataclasses.asdict(spec),
                draft_steps=None if spec is None else dec.draft_steps)


def verify_check(label, cfg, params, mode, kv_bits, seed):
    """``verify_step`` over 5 tokens is bitwise 5 sequential ``decode_step``
    calls on the card at the full model: 8 lanes at ragged positions, after
    4 teacher-forced decode steps of context; logits, every layer's pools
    and the positions compared."""
    import copy

    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import kv_cache as kvc

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    B, T_, ps, qn = 8, 4, 16, 5
    caches = kvc.init_paged_cache(cfg, B, B * T_ + 1, ps, T_, device="cuda")
    caches["table"] = torch.arange(1, B * T_ + 1, dtype=torch.int32,
                                   device="cuda").reshape(B, T_)
    caches["pos"] = torch.tensor([0, 3, 17, 30, 8, 44, 21, 12], dtype=torch.int32,
                                 device="cuda")
    rng = np.random.default_rng(seed)

    def toks(shape):
        return torch.as_tensor(rng.integers(0, cfg.vocab, shape), dtype=torch.int32,
                               device="cuda")

    with torch.no_grad():
        for _ in range(4):
            _, caches = T.decode_step(params, toks((B, 1)), caches, cfg, mode=mode)
        window = toks((B, qn))
        seq, outs = copy.deepcopy(caches), []
        for j in range(qn):
            lg, seq = T.decode_step(params, window[:, j:j + 1].contiguous(), seq, cfg,
                                    mode=mode)
            outs.append(lg)
        lg_v, ver = T.verify_step(params, window, caches, cfg, mode=mode)
    torch.cuda.synchronize()
    if not torch.equal(torch.stack(outs, 1), lg_v):
        d = (torch.stack(outs, 1).float() - lg_v.float()).abs().max().item()
        raise AssertionError(f"verify check ({label}): logits differ from {qn} decode steps "
                             f"(max |d| {d})")
    if not torch.equal(ver["pos"], seq["pos"]):
        raise AssertionError(f"verify check ({label}): positions differ")
    for i in range(cfg.n_layers):
        for key, val in ver["layers"][i]["attn"].items():
            if not same_bits(val, seq["layers"][i]["attn"][key]):
                raise AssertionError(f"verify check ({label}): layer {i} pool {key} differs")
    dt = time.perf_counter() - t0
    log(f"verify check ({label}; {cfg.n_layers} layers, {B} lanes, Q={qn}): verify_step "
        f"bitwise {qn} sequential decode_steps (logits, {cfg.n_layers} layers' pools, "
        f"positions); {dt:.2f} s")
    return dict(n_layers=cfg.n_layers, lanes=B, Q=qn, bitwise=True, seconds=dt)


def smoke_logits(qp, cfg, seed, dev, mode="w8a8"):
    """Logits of prefill + 4 teacher-forced decode steps + a teacher-forced
    verify of 5 tokens of the smoke model on ``dev`` (the kernels on
    ``cuda``, the plain versions on ``cpu``), in matmul ``mode``."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import kv_cache as kvc

    rng = np.random.default_rng(seed)
    n = 27
    toks = np.zeros((1, 32), np.int64)
    toks[0, :n] = rng.integers(0, cfg.vocab, n)
    follow = rng.integers(0, cfg.vocab, 4)
    window = rng.integers(0, cfg.vocab, (1, 5))
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
        lg, caches = T.verify_step(qp, torch.as_tensor(window, dtype=torch.int32, device=dev),
                                   caches, cfg, mode=mode)
        out.append(lg[0])
    return torch.cat(out).float().cpu()


def smoke_model(seed, *, kv_bits=8, ocs_ratio=0.02, w4a8=False):
    """The smoke glm4-9b (``kv_bits`` KV pages: 8 = int8, 4 = int4, None =
    float32) and its tree quantized on the CPU with the serving recipe
    (``ocs_ratio`` 0 is the clip-only tree; ``w4a8`` converts it to the
    W4A8 tier with ``to_w4a8(., W4A8_RATIO)``, as the engine does)."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import map_with_path, quantize_params
    from repro_torch.core.ocs import OCSQuantLinear, to_w4a8
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(smoke_config("glm4-9b"), kv_bits=kv_bits)
    params = T.init_params(cfg, seed=seed, device="cpu")
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=ocs_ratio, per_channel=True,
                         pad_to=1)
    qp = quantize_params(params, recipe, device="cpu")
    if w4a8:
        qp = map_with_path(lambda _p, leaf: to_w4a8(leaf, W4A8_RATIO)
                           if isinstance(leaf, OCSQuantLinear) else leaf, qp)
    return cfg, qp


# Reference-check cases: (label, matmul mode, KV bits, OCS ratio).
REFERENCE_CASES = (
    ("w8a8, int8 pages", "w8a8", 8, 0.02),
    ("dequant, float32 pages", "dequant", None, 0.02),
    ("dequant, clip-only tree", "dequant", None, 0.0),
    ("w4a8 + int4 pages", "w4a8", 4, 0.02),
)


def reference_check(seed):
    """Smoke glm4-9b: card kernels vs CPU plain versions, same weights, in
    each of ``REFERENCE_CASES``."""
    import torch
    from repro_torch.core.apply import tree_to

    out = {}
    for label, mode, kv_bits, ratio in REFERENCE_CASES:
        cfg, qp = smoke_model(seed, kv_bits=kv_bits, ocs_ratio=ratio, w4a8=mode == "w4a8")
        cpu = smoke_logits(qp, cfg, seed, "cpu", mode)
        card = smoke_logits(tree_to(qp, torch.device("cuda")), cfg, seed, "cuda", mode)
        scale = cpu.abs().max().item()
        err = (card - cpu).abs().max().item()
        if not torch.isfinite(card).all() or err > MODEL_RTOL * scale:
            raise AssertionError(f"reference check ({label}): max |d logits| {err} > "
                                 f"{MODEL_RTOL} x {scale}")
        log(f"reference check ({label}; smoke glm4-9b, prefill + 4 teacher-forced decode "
            f"steps + a teacher-forced verify of 5, card kernels vs CPU plain): max |d logits| "
            f"{err:.6g} of max |logit| "
            f"{scale:.6g} ({err / scale:.3g}; limit {MODEL_RTOL})")
        out[label] = dict(max_abs_err=err, logit_scale=scale)
    return out


def step_sum(rows, L, mode=None, m=8):
    """One decode step's work of a matmul kernel: the M = 8 rows (``m``:
    the rows of another call size, 256 for a prefill's), each shape counted
    once per layer (the lm_head once); ms, plain_ms, library_ms and
    bound_ms summed, and the bound's kind by its larger share."""
    per_step = {"wq": L, "wk": L, "wv": L, "wo": L, "w_gate": L, "w_up": L,
                "w_down": L, "lm_head": 1}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms", "library_device_ms")
    tot = {k: 0.0 for k in keys}
    by_ops = 0.0
    for r in rows:
        if r["M"] != m or (mode is not None and r.get("mode") != mode):
            continue
        mult = sum(per_step[nm] for nm in r["names"])
        for key in tot:
            tot[key] += mult * (r.get(key) or 0.0)
        if r["bound_by"] == "operations":
            by_ops += mult * r["bound_ms"]
    for key in ("device_ms", "library_device_ms"):  # measured for B2, B4 and B5 only
        if not tot[key]:
            del tot[key]
    tot["bound_by"] = "operations" if by_ops > tot["bound_ms"] / 2 else "bytes"
    return tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="glm4-9b depth (40 = the published depth, no cut)")
    ap.add_argument("--short-layers", type=int, default=10,
                    help="depth of the clip-only tree and of the k=16 spec phase and "
                         "its plain reference (paths that need no full-depth check)")
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
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear, to_w4a8
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.spec_decode import SpecConfig

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
               else f"cut: n_layers {layers} of {depth}")
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

    marks = {}

    def mark(what):
        """Log and keep the seconds since the start at the end of a phase."""
        marks[what] = time.perf_counter() - t_start
        log(f"time: {what} done at {marks[what]:.1f} s")

    cfg = model(args.layers)
    qparams, t_quant = quantized(cfg, 0.02)
    serve_cfg = EngineConfig(max_batch=8, max_len=512, page_size=16)
    mark("quantize")

    gen_k = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    b1 = kernel_phase_b1(qparams, cfg, gen_k, args.iters)
    mark("B1")
    b2 = kernel_phase_b2(gen_k, args.iters)
    b2v = kernel_phase_b2v(gen_k, args.iters)
    mark("B2, B2'")
    b4 = kernel_phase_wo("B4", qparams, gen_k, args.iters)
    b3, b3_launches = kernel_phase_b3(gen_k, args.iters)
    mark("B4, B3")
    b6 = kernel_phase_b6(qparams, gen_k, args.iters)
    mark("B6")
    # The verify contract at the full model, in each tier (the w4a8 tree
    # converted as the engine converts it).
    q_w4a8 = map_with_path(lambda _p, leaf: to_w4a8(leaf, W4A8_RATIO)
                           if isinstance(leaf, OCSQuantLinear) else leaf, qparams)
    verify = {
        "dequant": verify_check("dequant, float32 pages", cfg, qparams, "dequant", None,
                                args.seed),
        "w8a8": verify_check("w8a8, int8 pages", cfg, qparams, "w8a8", 8, args.seed),
        "w4a8": verify_check("w4a8, int4 pages", cfg, q_w4a8, "w4a8", 4, args.seed),
    }
    del q_w4a8
    mark("verify checks")
    serves = {
        "w8a8": serve_phase("w8a8", cfg, qparams, args.seed, card,
                            serve_cfg.replace(matmul_mode="w8a8", kv_bits=8),
                            "fused_qmatmul"),
        "dequant": serve_phase("dequant", cfg, qparams, args.seed, card, serve_cfg,
                               "ocs_matmul"),
        # The engine converts the int8 tree to the W4A8 tier (to_w4a8 with
        # EngineConfig's default ratio, W4A8_RATIO) on the card.
        "w4a8": serve_phase("w4a8", cfg, qparams, args.seed, card,
                            serve_cfg.replace(matmul_mode="w4a8", kv_bits=4),
                            "w4a8_qmatmul"),
    }
    log(f"w4a8 tier: weight bytes {serves['w4a8']['weight_bytes'] / 1e9:.3f} GB vs int8 "
        f"{serves['w8a8']['weight_bytes'] / 1e9:.3f} GB; KV bytes per token "
        f"{serves['w4a8']['kv_bytes_per_token']} (int4) vs "
        f"{serves['w8a8']['kv_bytes_per_token']} (int8)")
    # Self-speculative decoding, each held token for token against the plain
    # phase of its mode: (label, engine config, plain phase, target kernel).
    spec_phases = (
        ("spec dequant", serve_cfg.replace(spec=SpecConfig()), "dequant"),
        ("spec w8a8", serve_cfg.replace(matmul_mode="w8a8", kv_bits=8,
                                        spec=SpecConfig(draft_layers=10)), "w8a8"),
        ("spec w4a8", serve_cfg.replace(matmul_mode="w4a8", kv_bits=4,
                                        spec=SpecConfig(draft_mode="w4a8")), "w4a8"),
    )
    mark("plain serves")
    for label, ecfg, plain in spec_phases:
        serves[label] = serve_phase(label, cfg, qparams, args.seed, card, ecfg,
                                    MODE_KERNEL[ecfg.matmul_mode], plain=serves[plain])
    mark("spec serves")
    # A window of 16 (verify Q = 17) drafting in the target's own mode (the
    # draft is the target, so every draft must be accepted), on the first
    # --short-layers layers of the same tree against a plain w8a8 phase of
    # that depth.
    cfg_short = model(min(args.short_layers, cfg.n_layers))
    q_short = head_layers(qparams, cfg_short.n_layers)
    w8a8_cfg = serve_cfg.replace(matmul_mode="w8a8", kv_bits=8)
    serves["w8a8 short"] = serve_phase(f"w8a8 ({cfg_short.n_layers} layers)", cfg_short,
                                       q_short, args.seed, card, w8a8_cfg, "fused_qmatmul")
    serves["spec k=16"] = serve_phase(
        f"spec k=16 ({cfg_short.n_layers} layers)", cfg_short, q_short, args.seed, card,
        w8a8_cfg.replace(spec=SpecConfig(k=16, adaptive=False)), "fused_qmatmul",
        plain=serves["w8a8 short"])
    if serves["spec k=16"]["stats"]["spec_acceptance_rate"] != 1.0:
        raise AssertionError("spec k=16: a draft in the target's own mode was rejected")
    mark("k=16 serves")
    del qparams, q_short

    cfg_clip = cfg_short
    qclip, t_quant_clip = quantized(cfg_clip, 0.0)
    b5 = kernel_phase_wo("B5", qclip, gen_k, args.iters)
    serves["clip-only"] = serve_phase("clip-only dequant", cfg_clip, qclip, args.seed, card,
                                      serve_cfg, "quant_matmul")
    del qclip
    mark("clip-only tree")
    refc = reference_check(args.seed)
    mark("reference check")

    L = cfg.n_layers
    # Kernel line: the matmul kernels at one decode step's work (M = 8: 7
    # layer matmuls x L + lm_head; B4/B5 weight-only, as dense calls them),
    # B2 at its decode shape on the int8 and the int4 pool and B3 at M = 8,
    # K = 4096 (per call).
    b1_step = step_sum(b1, L)
    b4_step = step_sum(b4, L, "weight-only")
    b5_step = step_sum(b5, L, "weight-only")
    for label, rows in (("B4", b4), ("B5", b5)):
        for m in (8, 256):
            t = step_sum(rows, L, "weight-only", m)
            log(f"{label} weight-only, the M={m} calls of one {L}-layer step (7 x {L} + "
                f"lm_head): ms={t['ms']:.3f} device_ms={t['device_ms']:.3f} library_ms="
                f"{t['library_ms']:.3f} library_device_ms={t['library_device_ms']:.3f} "
                f"bound_ms={t['bound_ms']:.3f} ({t['bound_by']})")
    b6_step = step_sum(b6, L)
    b2_main = next(r for r in b2 if r["pool"] == "int8")
    b2_int4 = next(r for r in b2 if r["pool"] == "int4")
    b3_main = next(r for r in b3 if r["M"] == 8 and r["K"] == 4096)
    # B2's Q > 1 path at the default window (k = 4: Q = 5) on the default
    # float32 pages; launches from the default spec phase.
    b2v_main = next(r for r in b2v if r["pool"] == "float32" and r["Q"] == 5)

    def entry(name, replaces, launches, err, t, source=None):
        source = source or f"src/repro_torch/csrc/{name}.cu"
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        # Device time (a CUDA graph of the timed calls) beside the wall time,
        # where measured (B2, B2', B4, B5) and the library call's likewise.
        for key in ("device_ms", "library_device_ms"):
            if key in t:
                e[key] = t[key]
        return e

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
        entry("w4a8_qmatmul", "src/repro/kernels/fused_qmatmul.py:220",
              serves["w4a8"]["launches"]["w4a8_qmatmul"], 0.0, b6_step),
        entry("paged_attention_int4", "src/repro/kernels/paged_attention.py:554",
              serves["w4a8"]["launches"]["paged_attention"], b2_int4["max_abs_err"], b2_int4,
              source="src/repro_torch/csrc/paged_attention.cu"),
        entry("paged_attention_verify", "src/repro/kernels/paged_attention.py:534",
              serves["spec dequant"]["launches"]["paged_attention_verify"],
              max(r["max_abs_err"] for r in b2v), b2v_main,
              source="src/repro_torch/csrc/paged_attention.cu"),
    ]
    what = {"fused_qmatmul": "one decode step's calls, M=8",
            "paged_attention": "one call, int8 pool, 8 lanes",
            "ocs_matmul": "one decode step's calls, M=8, weight-only",
            "quant_matmul": f"one {L}-layer decode step's calls, M=8, weight-only, "
                            f"clip-only tree; launches from the {cfg_clip.n_layers}-layer serve",
            "dynamic_quant": "one call, M=8, K=4096; launches from the kernel phase",
            "w4a8_qmatmul": "one decode step's calls, M=8",
            "paged_attention_int4": "one call, int4 pool, 8 lanes; B2's int4 branch",
            "paged_attention_verify": "one call, float32 pool, 8 lanes, Q=5; B2's Q>1 rows; "
                                      "launches from the default spec phase"}
    for k in kernels:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        dev = (f" device_ms={k['device_ms']:.4f} library_device_ms="
               f"{k['library_device_ms']:.4f}" if "device_ms" in k else "")
        log(f"kernel {k['name']} ({what[k['name']]}): kernel_ms={k['ms']:.4f} plain_ms="
            f"{k['plain_ms']:.4f} library_ms={lib}{dev} bound_ms={k['bound_ms']:.4f} "
            f"({k['bound_by']}) launches={k['launches']} max_abs_err={k['max_abs_err']:.3g}")
    total = time.perf_counter() - t_start
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  n_layers=L, short_layers=cfg_clip.n_layers, build_s=t_build,
                  quantize_s=t_quant, quantize_clip_s=t_quant_clip, total_s=total,
                  peak_mem_gib=peak_gb, b1=b1, b2=b2, b2v=b2v, b3=b3, b4=b4, b5=b5, b6=b6,
                  verify_check=verify, serve=serves, phase_end_s=marks,
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
