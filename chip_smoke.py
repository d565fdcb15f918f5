#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--layers N] [--out DIR]

Phases (any failure raises, and the script exits non-zero with no result):

1. Print the card's name and power limit (``nvidia-smi``), build every CUDA
   kernel of the path from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, started together).
2. Quantize glm4-9b at its full published width (d_model 4096, 32/2 heads,
   hd 128, d_ff 13696, vocab 151552) and ``--layers`` deep (default 40,
   the published depth; a smaller value is the one cut): random weights
   from a seeded ``torch.Generator`` on the card, quantized on the card by
   ``quantize_params`` with the serving launcher's recipe (w8, MSE clip,
   OCS r=0.02, per-channel, pad_to=1).
3. Kernel phase: each kernel's wrapper on card tensors at the shapes the
   main path gives it, held against its plain PyTorch version on the same
   inputs. ``fused_qmatmul`` at every glm4-9b linear shape (the layer-0
   and ``lm_head`` weights just quantized) with M in {1, 8, 256}: bitwise.
   ``paged_attention`` on int8 and float32 pools (8 lanes, ragged
   positions, one all-trash lane, Q = 1): appended pools bitwise, outputs
   within ``B2_ATOL``. Each is timed (CUDA events), beside its plain
   version, a library yardstick the port never calls, and its bound.
4. Serve phase: every launch count set to 0, then ``ServingEngine`` with
   ``EngineConfig(max_batch=8, max_len=512, matmul_mode="w8a8", kv_bits=8,
   page_size=16)`` serves 8 seeded requests (prompts of 16-256 tokens, 32
   new tokens each, greedy); counts read right after. Asserts that every
   request finishes by length, that every parameter and pool lies on the
   card, that ``fused_qmatmul`` ran 7*L+1 times per decode step and per
   prefill call, and ``paged_attention`` L times per decode step.
5. Reference check: a smoke-size glm4-9b served through prefill and
   teacher-forced decode on the card (kernels) and on the CPU (plain
   versions) from the same weights; logits agree within ``MODEL_RTOL``.

Output: a ``kernels`` JSON line (every kernel's launches on the main path,
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
# tensor-core ops/s, float32 (non-tensor-core) flop/s.
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
F32_FLOPS = 67e12

# paged_attention output tolerance vs its plain version: both are f32 after
# dequantization; they differ in summation order and in expf vs torch's
# softmax exp (measured 4.8e-7 on int8 and 6.0e-7 on float32 pools, H100).
# The same limit as tests/test_torch_cuda.py.
B2_ATOL = 2e-5
# Card (kernels) vs CPU (plain versions) logits at smoke size, relative to
# the logits' max magnitude. The same port code runs on both sides and B1
# and the pools are bitwise, so the sound reading is 0 (H100, seed 0). The
# limit allows about one bf16 ulp of the largest logit (2**-7 = 0.0078);
# subtly wrong plain versions (B1 rounding half to even, B2 masking the
# newest token) read 0.039 and 0.31 (tests/test_torch_smoke_check.py).
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
    from repro_torch.models.transformer import layer_params

    lp = layer_params(qparams, 0)
    weights = {
        "wq": lp["attn"]["wq"], "wk": lp["attn"]["wk"], "wv": lp["attn"]["wv"],
        "wo": lp["attn"]["wo"], "w_gate": lp["mlp"]["w_gate"],
        "w_up": lp["mlp"]["w_up"], "w_down": lp["mlp"]["w_down"],
        "lm_head": qparams["lm_head"],
    }
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


def serve_phase(cfg, qparams, seed, card):
    import numpy as np
    import torch
    from repro_torch.core.ocs import OCSQuantLinear
    from repro_torch.kernels import fused_qmatmul as fq
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    ecfg = EngineConfig(max_batch=8, max_len=512, matmul_mode="w8a8", kv_bits=8,
                        page_size=16)
    eng = ServingEngine(cfg, qparams, ecfg, device="cuda")
    rng = np.random.default_rng(seed)
    reqs = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(16, 257))).tolist(),
                max_new_tokens=32)
        for i in range(8)
    ]
    for r in reqs:
        eng.submit(r)
    fq.reset_launches()
    pa.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_b1, n_b2 = fq.launches, pa.launches
    stats = eng.stats()
    L = cfg.n_layers
    if len(done) != 8 or any(r.finish_reason != "length" for r in done):
        raise AssertionError(f"finish reasons: {[r.finish_reason for r in done]}")
    if any(len(r.output) != 32 for r in done):
        raise AssertionError("a request did not produce 32 tokens")

    def on_card(_p, leaf):
        ts = [leaf] if isinstance(leaf, torch.Tensor) else (
            [leaf.weight.values, leaf.weight.scale, leaf.spec.src, leaf.spec.mult,
             leaf.spec.bias] if isinstance(leaf, OCSQuantLinear) else [])
        for t in ts:
            if not t.is_cuda:
                raise AssertionError(f"parameter {'/'.join(map(str, _p))} not on the card")
        return leaf

    from repro_torch.core.apply import map_with_path

    map_with_path(on_card, eng.params)
    for layer in eng.caches["layers"]:
        for t in layer["attn"].values():
            if not t.is_cuda:
                raise AssertionError("a pool tensor is not on the card")
    steps, calls = stats["decode_steps"], stats["prefill_calls"]
    want_b1 = (7 * L + 1) * (steps + calls)
    want_b2 = L * steps
    if n_b1 != want_b1 or n_b2 != want_b2:
        raise AssertionError(
            f"launch counts: fused_qmatmul {n_b1} (want {want_b1}), "
            f"paged_attention {n_b2} (want {want_b2})"
        )
    log(f"serve: {len(done)} requests, {stats['prefill_tokens']} prompt tokens over "
        f"{calls} prefill calls, {steps} decode steps, {stats['decoded_tokens']} decoded "
        f"tokens, wall {wall:.2f} s")
    log(f"serve on {card}: prefill {stats['prefill_tok_per_s']:.1f} tok/s | decode "
        f"{stats['decode_tok_per_s']:.1f} tok/s | ttft p50 {stats['ttft_p50_s'] * 1e3:.1f} ms "
        f"p95 {stats['ttft_p95_s'] * 1e3:.1f} ms | itl p50 {stats['itl_p50_s'] * 1e3:.2f} ms")
    log(f"serve: fused_qmatmul wrapper calls {n_b1} = (7*{L}+1) x ({steps} decode steps + "
        f"{calls} prefill calls); paged_attention {n_b2} = {L} x {steps}")
    return dict(stats=stats, wall_s=wall, b1_launches=n_b1, b2_launches=n_b2,
                b1_per_step=7 * L + 1, b2_per_step=L)


def smoke_logits(qp, cfg, seed, dev):
    """Logits of prefill + 4 teacher-forced decode steps of the smoke model
    on ``dev`` (the kernels on ``cuda``, the plain versions on ``cpu``)."""
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
            prefix_ids=torch.zeros(0, dtype=torch.int32, device=dev))
        out = [lg]
        caches = {"layers": [{"attn": p} for p in pools],
                  "table": torch.tensor([[1, 2, 3, 0]], dtype=torch.int32, device=dev),
                  "pos": torch.tensor([n], dtype=torch.int32, device=dev)}
        for t in follow:
            lg, caches = T.decode_step(
                qp, torch.tensor([[int(t)]], dtype=torch.int32, device=dev), caches, cfg)
            out.append(lg)
    return torch.cat(out).float().cpu()


def smoke_model(seed):
    """The smoke glm4-9b (int8 KV pages) and its tree quantized on the CPU
    with the serving recipe."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import quantize_params
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(smoke_config("glm4-9b"), kv_bits=8)
    params = T.init_params(cfg, seed=seed, device="cpu")
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True, pad_to=1)
    return cfg, quantize_params(params, recipe, device="cpu")


def reference_check(seed):
    """Smoke glm4-9b: card kernels vs CPU plain versions, same weights."""
    import torch
    from repro_torch.core.apply import tree_to

    cfg, qp = smoke_model(seed)
    logits = {"cpu": smoke_logits(qp, cfg, seed, "cpu"),
              "cuda": smoke_logits(tree_to(qp, torch.device("cuda")), cfg, seed, "cuda")}
    scale = logits["cpu"].abs().max().item()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    if not torch.isfinite(logits["cuda"]).all() or err > MODEL_RTOL * scale:
        raise AssertionError(f"reference check: max |d logits| {err} > {MODEL_RTOL} x {scale}")
    log(f"reference check (smoke glm4-9b, prefill + 4 teacher-forced decode steps, card "
        f"kernels vs CPU plain): max |d logits| {err:.6g} of max |logit| {scale:.6g}")
    return dict(max_abs_err=err, logit_scale=scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="glm4-9b depth (40 = the published depth, no cut)")
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
    log(f"build: {t_build:.1f} s")

    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=args.layers)
    depth = get_config("glm4-9b").n_layers
    cut = "no cut" if cfg.n_layers == depth else f"the one cut: n_layers {cfg.n_layers} of {depth}"
    log(f"model: glm4-9b at full width (d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
        f"{cfg.n_layers} layers ({cut})")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = T.init_params(cfg, gen, device="cuda")
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True, pad_to=1)
    qparams = quantize_params(params, recipe, device="cuda")
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    log(f"quantize: {t_quant:.1f} s on the card (w8, mse clip, ocs r=0.02, per-channel)")

    gen_k = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    b1 = kernel_phase_b1(qparams, cfg, gen_k, args.iters)
    b2 = kernel_phase_b2(gen_k, args.iters)
    serve = serve_phase(cfg, qparams, args.seed, card)
    refc = reference_check(args.seed)

    L = cfg.n_layers
    # Kernel line: B1 at its decode-step work (M = 8: 7 layer matmuls x L +
    # lm_head), B2 at its decode shape on the int8 pool (per call).
    per_step = {"wq": L, "wk": L, "wv": L, "wo": L, "w_gate": L, "w_up": L,
                "w_down": L, "lm_head": 1}
    b1_step = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    b1_by_ops = 0.0
    for r in b1:
        if r["M"] != 8:
            continue
        mult = sum(per_step[nm] for nm in r["names"])
        for key in b1_step:
            b1_step[key] += mult * (r[key] or 0.0)
        if r["bound_by"] == "operations":
            b1_by_ops += mult * r["bound_ms"]
    b2_main = next(r for r in b2 if r["pool"] == "int8")
    kernels = [
        {
            "name": "fused_qmatmul", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_qmatmul.cu",
            "replaces": "src/repro/kernels/fused_qmatmul.py:60",
            "launches": serve["b1_launches"], "max_abs_err": 0.0,
            "ms": b1_step["ms"], "plain_ms": b1_step["plain_ms"],
            "bound_ms": b1_step["bound_ms"],
            "bound_by": "operations" if b1_by_ops > b1_step["bound_ms"] / 2 else "bytes",
            "library_ms": b1_step["library_ms"],
        },
        {
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:460",
            "launches": serve["b2_launches"], "max_abs_err": b2_main["max_abs_err"],
            "ms": b2_main["ms"], "plain_ms": b2_main["plain_ms"],
            "bound_ms": b2_main["bound_ms"], "bound_by": b2_main["bound_by"],
            "library_ms": b2_main["library_ms"],
        },
    ]
    for k in kernels:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        what = ("one decode step's calls, M=8" if k["name"] == "fused_qmatmul"
                else "one call, int8 pool, 8 lanes")
        log(f"kernel {k['name']} ({what}): kernel_ms={k['ms']:.4f} plain_ms="
            f"{k['plain_ms']:.4f} library_ms={lib} bound_ms={k['bound_ms']:.4f} "
            f"({k['bound_by']}) launches={k['launches']} max_abs_err={k['max_abs_err']:.3g}")
    total = time.perf_counter() - t_start
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  n_layers=L, build_s=t_build, quantize_s=t_quant, total_s=total,
                  peak_mem_gib=peak_gb,
                  b1=b1, b2=b2, serve=serve, reference_check=refc, kernels=kernels)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    log(f"total: {total:.1f} s (build {t_build:.1f} s, quantize {t_quant:.1f} s), "
        f"depth {L} layers, peak device memory {peak_gb:.1f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
