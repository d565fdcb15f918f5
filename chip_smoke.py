#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--layers N] [--short-layers N] [--phi-layers N] [--out DIR]

Cuts, each logged where it is made: glm4-9b's depth (``--layers``, default
its published 40); at ``--short-layers`` (default 10): the clip-only
trees, glm4-9b's lifecycle, traced, router, k=16 spec, unpaged w8a8 and
chaos phases, hymba-1.5b's and qwen2-vl-7b's w4a8 phases; the SSM and
hybrid serves at ``SSM_SERVE_LAYERS`` (mamba2-1.3b 24 of 48, hymba-1.5b
16 of 32); the SSM and hybrid phases' repeats at ``SSM_REPEAT_LAYERS``
(4); deepseek-moe-16b at ``MOE_LAYERS`` (8 of 28),
phi3.5-moe at ``--phi-layers`` (default 4 of 32); the SSM and hybrid
serve phases' prompts: 16-20 tokens (8 requests on 8 lanes, 32 new tokens
each; their prompts replay through the decode step, one full step a
token, as the reference's do).

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
   version, a library yardstick the port never calls, and its bound. Every
   kernel but B3, and its yardstick, is also timed as device time per call:
   the same calls captured in a CUDA graph and replayed (no host work
   between the kernels).
   ``fused_qmatmul`` (B1, the int8 tensor-core GEMM) at every glm4-9b
   linear shape (the layer-0 and ``lm_head`` weights just quantized) with M
   in {1, 8, 256}: bitwise.
   ``paged_attention`` (B2) on int8, float32 and packed int4 pools (8
   lanes, ragged positions, one all-trash lane, a NaN-poisoned trash page,
   Q = 1): appended pools bitwise, outputs within ``B2_ATOL``; the same
   at pages of 1 and 2 rows (untimed).
   ``ocs_matmul`` (B4) weight-only at every shape with M in {1, 8, 64,
   256}, on the bf16 tensor cores with the OCS tail gathered in the kernel
   (the route ``dense`` takes; checked by the wrapper's count of CUDA-core
   calls; the decode tile or the prefill tile by ``quant_matmul.tc_plan``):
   f32 outputs within the summation-order bound (``WO_TOL_FACTOR``), bf16
   outputs within it plus one bf16 ulp, the first 8 rows of each M = 64
   and M = 256 call bitwise an 8-row call's (the decode tile's); its CUDA-core route (f32 x)
   once a shape at M = 8, within the same bound; int8 mode at M in {8,
   256}: bitwise. A ``w_down`` prefill of 519 rows (the decode tile would
   have run it in two row chunks to bound its split-K workspace): rows at
   the start, the middle and the end bitwise an 8-row call's, within the
   bound.
   ``paged_attention`` with Q > 1 query tokens per lane (B2', the
   speculative verify and a resume's replay; Q in {2, 5, 17, 31}) on the
   three pool kinds: pools bitwise, outputs within ``B2_ATOL``, every row
   bitwise the sequential Q = 1 launches at its position.
   ``dynamic_quant`` (B3) at K in {4096, 13696}, M in {1, 8, 256}:
   bitwise, timed on a CUDA graph too. ``w4a8_qmatmul`` (B6) at every shape (the layer-0 and lm_head
   leaves converted with ``to_w4a8(., 0.05)`` on the card, each conversion,
   and that of a stacked two-layer leaf, bitwise the same conversion on the
   CPU) with M in {1, 8, 256}: bitwise, f32 and bf16 outputs.
   Verify check, in dequant (float32 pages), w8a8 (int8) and w4a8 (int4),
   and on the unpaged engine's dense caches in dequant (float32) and w8a8
   (int8): ``verify_step`` over 5 tokens of 8 lanes is bitwise 5
   sequential ``decode_step`` calls at the full model (logits, every
   layer's pools or caches, positions).
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
   launches against the count its rounds and draft steps give. Then the
   unpaged phases of 6b at ``--layers``. Then, on the first
   ``--short-layers`` layers of the same tree (default 10; the second cut;
   the lifecycle, traced and router phases are cut to this depth),
   plain w8a8 and dequant phases, and the request lifecycle on the same
   requests, each held against the plain phase of its mode at this depth:
   (h) dequant with
   ``prefill_budget=128, chunk_size=64`` (at least the chunks the prompts
   need, at most 128 prompt tokens a step), held against the plain dequant
   phase: a request may part from it only where one prefill of the plain
   model gives a top-2 logit margin below ``TIE_MARGIN`` (each parting
   printed; the prefill attention's key chunk follows the call's key
   count, the reference's own rule); (i) dequant with optimistic admission
   on a pool of each prompt's pages plus one (at least one preemption, the
   page peak within the capacity): a resume re-prefills the prompt past its
   hits and replays the committed tokens through the decode path, and every
   request is bitwise the plain dequant phase's; (j) w8a8 on int8 pages
   with odd uids sampled (``SAMPLED_PARAMS``, ``seed=uid``): greedy
   requests bitwise the plain w8a8 phase's, every request bitwise the same
   served again in reverse submission order. Then the observability layer
   and the router: (k) dequant with ``trace=True, drift_every=4``: tokens
   bitwise the plain dequant phase's, the span ring exported as Chrome
   trace JSON to ``<out>/chip_smoke_trace.json`` and validated, one
   explicit drift sample once all lanes decode leaving every pool byte as
   it was (pools cloned and digested around it); (l) two w8a8 replicas on
   int8 pages sharing the tree behind ``Router`` serve (j)'s requests and
   replica 0 is killed once its lanes have committed 4 tokens: every output
   bitwise (j)'s, at least one migration, every page of both pools back.
   Each chunk and each resume's prefill is one prefill call in the launch
   reckoning, each resume replay and drift sample a decode call (B2' when a
   replay's tail is longer than one token), and every serve phase ends with
   no page in use. Then (g) ``SpecConfig(k=16, adaptive=False)`` in w8a8
   on int8 pages (verify Q = 17; the draft is the target: every draft
   accepted), held against the plain w8a8 phase likewise, the unpaged w8a8
   pair of 6b, and (m) one chaos ``FaultPlan`` (InjectNaN, StallSteps,
   PagePressure, KillReplica) run twice over two optimistic w8a8 replicas:
   each request's (finish_reason, tokens) identical across the runs, the
   poisoned request "error", the others bitwise the plain phase's, no page
   leaked. B2' is then held at every tail length the replays of (i), (l)
   and (m) ran.
5. Clip-only tree: the OCS tree is freed, the same seeded weights are made
   again and quantized with ``ocs_ratio=0`` (the paper's baseline, no
   split), ``--short-layers`` deep (default 10). ``quant_matmul``
   (B5) is checked and timed as B4 at its shapes (weight-only and int8),
   and the tree is served in ``dequant`` mode as in 4(b): B5 7*L+1 times
   per step and call, B4 and B1 not at all.
6. MoE serving: the glm4-9b trees are freed; deepseek-moe-16b at its
   published width (d_model 2048, 16/16 heads, hd 128, 64 routed experts
   top-6 of expert_ff 1408, 2 shared experts fused to width 2816,
   capacity factor 1.25, vocab 102400) and ``MOE_LAYERS`` deep (8 of
   its published 28, a cut that keeps the script within 60% of its time
   limit), its seeded weights drawn leaf by leaf on the
   card and quantized as drawn (``init_params(lazy=True)`` through
   ``quantize_params``, the serving recipe; quantize seconds and peak
   device memory printed). Served as in 4 in (n) w8a8 (int8 pages), (o)
   dequant (float32 pages) and (p) w4a8 (int4 pages; the engine converts
   the expert stacks): the phase's kernel runs 10*L+1 times per step and
   call, 3*L of them one launch over an expert stack (its ``_experts``
   count); the dropped assignments per call kind (prefill, decode, verify)
   are counted from the routing (a wrapper of ``models.moe.dispatch``). After
   each, a fresh engine's decode step is profiled (two steps, device
   operations and busy share, ``launch/profile_decode.py``'s reckoning).
   (q) spec w8a8 (drafting with the first quarter of the layers): its
   acceptance and token agreement with (n), which it must equal wherever no
   verify dropped an assignment (a token's MoE output follows the other
   rows of its call, as in the reference). The engine's w4a8 conversion of
   a layer-0 expert stack is bitwise ``to_w4a8`` on the card and on the
   CPU. (r) its clip-only tree (``ocs_ratio=0``) at ``--short-layers``
   (default 10, a cut) in dequant: B5 over the experts. Kernel phase: B4,
   B5, B1 and B6 over the layer-0 expert stacks (E = 64; K 2048 -> N 1408
   and K 1408 -> N 2048; C in ``STACK_CS``) with empty capacity rows and
   an all-zero expert: one launch a call, every expert's slice bitwise its
   2-D launch, zero rows zero, against the plain stacked call bitwise (B1,
   B6) or within the weight-only bound (B4, B5, also on both of their
   tiles, bitwise each other); timed with the library yardstick and the
   bound. (s) phi3.5-moe-42b-a6.6b (16 experts top-2, no shared, GQA 32/8,
   expert_ff 6400, vocab 32064) at ``--phi-layers`` (default 4 of 32, a
   cut: its float32 tree is ~168 GB) in w8a8.
6b. The unpaged engine and the SSM and hybrid decoders. After the spec
   phases, (d) glm4-9b at ``--layers`` on the unpaged engine
   (``paged=False``: dense per-lane float32 caches, a b = 1 scratch cache
   adopted after each prefill), the plain phases' requests in dequant,
   monolithic and chunked (``prefill_budget=128, chunk_size=64``), each
   held against the paged plain dequant phase up to near-ties
   (``TIE_MARGIN``), and spec dequant on it (the default drafter: w8a8, k
   <= 4; the verify writes its window's rows into the dense caches, a
   rejected tail is rolled back by rewinding ``pos``) token for token the
   unpaged dequant phase; at ``--short-layers``, a plain w8a8 phase on int8
   dense caches and spec w8a8 on them drafting with all layers but the
   last, token for token it. After the MoE phases: (a) mamba2-1.3b at
   its published width (d_model 2048, 64 SSM heads of 64, d_state 128,
   d_inner 4096, vocab 50280, the lm_head the tied float embedding) and
   depth (48), and (b) hymba-1.5b (d_model 1600, 25/5 heads of
   64, d_ff 5504, 50 SSM heads, d_state 16, 128 meta tokens, window 1024,
   global layers 0/15/31, vocab 32001: its in_proj's 6482 and lm_head's
   32001 columns stored padded to 6496 and 32016 once) at its 32 layers,
   each drawn leaf by leaf and quantized on the card. (c) B1, B4 and B6 at
   each of their linear shapes (the layer-0 and lm_head leaves; M in {1,
   8, 256}, B4 also 64) and B5 on a one-layer clip-only tree's, against
   their plain versions to the bounds above (bitwise for B1, B6 and the
   int8 paths). Served on the unpaged engine (``max_batch=8,
   max_len=64``, 8 requests of 16-20-token prompts, 32 new tokens: every
   decode step M = 8), at ``SSM_SERVE_LAYERS`` (cuts):
   mamba2-1.3b at 24 layers in dequant, w8a8 and w4a8, hymba-1.5b at 16
   (global layers 0 and 15) in dequant and w8a8 on int8 caches, and in
   w4a8 at ``--short-layers`` (a cut); each phase once, then twice at
   ``SSM_REPEAT_LAYERS`` (4; the repeat's depth cut), the second token for
   token the first; the mode's kernel 2 x L times a step and a prompt
   token (mamba2 at L layers: its in_proj and out_proj) or 9 x L + 1
   (hymba), B2 never.
   One decode step of each profiled (device operations, busy share).
6c. The last configs. qwen2-vl-7b at its published width (d_model 3584,
   28/4 heads of 128, d_ff 18944, vocab 152064, M-RoPE sections (16, 24,
   24); text tokens: one position in the three streams) and depth (28),
   and minitron-8b (d_model 4096, 32/8 heads, d_ff 16384, vocab 256000: the
   widest lm_head served) at 32, each drawn leaf by leaf and quantized on
   the card; B1, B4, B5 and B6 at each of their linear shapes as in (c);
   B2 at qwen2-vl's 28/4 heads (rep 7) on float32, int8 and int4 pools,
   Q = 1 and Q = 5 (rows bitwise the sequential launches). qwen2-vl-7b is
   served as in 4 in dequant, w8a8 (int8 pages), w4a8 (int4 pages) at
   ``--short-layers`` (a cut) and spec dequant (token for token its plain
   phase, allocator state equal); then ``transformer.forward`` over the 8
   prompts in one call (M = 8 x the longest): finite, the kernel 7*L+1
   times, each prompt's last-position argmax its request's first token up
   to a near-tie (``TIE_MARGIN``). minitron-8b is served in dequant.
   hubert-xlarge (the encoder: d_model 1280, 16 heads of 80, d_ff 5120,
   LayerNorm, GELU, unmasked attention, vocab 504 stored padded to 512) at
   its 48 layers: B1, B4, B5 and B6 at its shapes (M = 4000 too), then
   ``forward`` and ``loss_fn`` on seeded frame embeddings ``[4, 1000,
   1280]`` (20 s of audio at 50 Hz: M = 4000 a GEMM) and seeded labels in
   dequant, w8a8 and w4a8: finite logits and loss, the mode's kernel
   6*48+1 times a call and nothing else.
6d. (n) The paper's weight-PTQ experiments (``repro_torch.experiments``)
   at their full size. The convnet, the LSTM and the bench LM are trained
   on the card from their seeded init, 400 steps each at the reference's
   settings, fresh on every run (no cache; cuDNN deterministic from here
   on, so the convnet's training repeats): each one's loss at the logged
   steps, wall time and steps/s printed; the convnet's held-out accuracy
   at least twice chance (``EXP_MIN_ACC``), the LMs' perplexity below half
   their vocabulary (``EXP_MAX_PPL``); each one's float forward card vs
   CPU on the trained weights within ``EXP_F32_RTOL`` / ``EXP_LM_RTOL`` of
   the largest logit. The quick arms of Tables 1, 2, 5, 6 and 7 on the
   trained trees, each table printed. Fake-quantized leaves built on the
   card bitwise the same built on the CPU (the bench LM with no clip, MSE,
   ACIQ and KL, and with knapsack allocation; the convnet with KL; the
   LSTM with ACIQ, per-channel). The precision-tier gate
   (``launch/quality_eval.py``) on the trained bench LM: every tier's
   metrics and the reference's verdict printed, the floors held, the
   OCS-beats-naive comparisons printed (not held: the reference calibrated
   them on its own trained LM), the launches per tier counted (B1 in int8,
   B6 in the two w4a8 tiers, B4 in a dequant row of the int8 tree, 7 x 4 +
   1 a forward), each tier's logits card vs CPU within
   ``FORWARD_CARD_RTOL``; B1, B4 and B6 at the bench LM's shapes (K + S =
   131 and 262, M = 1024; B6 with 14 and 27 outlier rows, ``to_w4a8(.,
   0.1)``, and with none) as in (c). glm4-9b's layer-0 and lm_head leaves
   at full width quantized on the card with ACIQ and with KL clipping (w8,
   OCS r = 0.02, per-tensor): the seconds printed, the lm_head's split
   table, int grid and scale bitwise the CPU's (layer 0's are held so by
   ``tests/test_torch_cuda.py``).
7. Reference check: a smoke-size glm4-9b run through prefill and
   teacher-forced decode on the card (kernels) and on the CPU (plain
   versions) from the same weights, in w8a8 (int8 pages), dequant (float
   pages), dequant on a clip-only tree and w4a8 (int4 pages), the decode
   followed by a teacher-forced ``verify_step`` of 5 tokens; logits agree
   within ``MODEL_RTOL`` of the largest logit. The same for the MoE smoke
   configs (deepseek-moe-16b in the three tiers, phi3.5-moe in w8a8), the
   card routing as the CPU did: its own expert set may differ only at a
   near-tie (``ROUTE_TIE``). The smoke mamba2-1.3b and hymba-1.5b in the
   three modes (hymba's w8a8 on int8 caches): 40 teacher-forced decode
   steps of 2 lanes from fresh dense caches (past hymba's smoke window of
   32), logits within ``SSM_CARD_RTOL`` of the mode. ``forward`` of the
   smoke hubert-xlarge, qwen2-vl-7b and hymba-1.5b over 2 x 40 positions
   in the three modes: logits within ``FORWARD_CARD_RTOL`` of the mode.

Output: a ``time:`` line at the end of each phase (seconds since the
start), a ``kernels`` JSON line (every kernel's launches on its path,
``launches_by_path`` for the matmul kernels and B2 on every serving path
and hubert-xlarge's forward, the SSM, hybrid, qwen2-vl-7b, minitron-8b
and hubert-xlarge models' GEMMs and the bench LM's in the quality gate
(``*_benchlm``) as entries of their own; error, times and bound), the
``nvidia-smi`` line, and last
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

# Phase (h) may part from the plain dequant phase only where the plain
# model's top-2 logit margin is below this (logits): the CPU engine tests'
# bound (tests/_torch_lifecycle.py, TIE_TOL). The partings seen had margins
# of at most 0.0312, one bf16 step of logits of 4-8 (H100). No resume is
# held this way: phase (i) is bitwise.
TIE_MARGIN = 0.25
# Phase (j)'s sampled requests: SamplingParams(**SAMPLED_PARAMS, seed=uid).
SAMPLED_PARAMS = dict(temperature=0.8, top_k=50, top_p=0.9)

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


def b1_times(run_kern, x, w8, ws, src, iters):
    """Wall and device ms of ``run_kern`` (a B1 call cycling its weight
    copies) and of its library yardstick: ``torch._int_mm`` on the already
    quantized, zero-padded operands (it wants M > 16 and K, N % 8 == 0;
    the activation quantization is not in it) plus the epilogue, its
    weights cycled like the kernel's; library times are None where N % 8
    != 0. Device times are CUDA graphs of the same calls."""
    import torch
    from repro_torch.kernels import ref

    (m, k), (ke, n) = x.shape, w8.shape
    t = dict(ms=time_ms(run_kern, iters), device_ms=graph_ms(run_kern, iters),
             library_ms=None, library_device_ms=None)
    if n % 8:
        return t
    q, sc = ref.dynamic_quant_ref(x)
    q = torch.cat([q, q[:, src.long()]], 1) if ke > k else q
    mp, kp = max(m, 32), ke + (-ke) % 8
    qp = torch.zeros((mp, kp), dtype=torch.int8, device="cuda")
    qp[:m, :ke] = q
    wp = torch.zeros((kp, n), dtype=torch.int8, device="cuda")
    wp[:ke] = w8
    scp = torch.zeros((mp,), dtype=torch.float32, device="cuda")
    scp[:m] = sc
    run_lib = cycling(lambda wpc: (torch._int_mm(qp, wpc).float()
                                   * (scp[:, None] * ws[None, :])).to(torch.bfloat16),
                      cycled(wp))
    del wp
    t.update(library_ms=time_ms(run_lib, iters), library_device_ms=graph_ms(run_lib, iters))
    return t


def kernel_phase_b1(qparams, cfg, gen, iters, m_rows=(1, 8, 256)):
    """fused_qmatmul at every linear shape of the tree (glm4-9b's first) x
    M in ``m_rows``."""
    import torch
    from repro_torch.kernels import fused_qmatmul as fq

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
        copies = cycled(w8)
        for m in m_rows:
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            got = fq.fused_quant_matmul_cuda(x, w8, ws, src, out_dtype=torch.bfloat16)
            want = fq.fused_quant_matmul_plain(x, w8, ws, src, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"fused_qmatmul {names} M={m}: not bitwise equal (max |d| {diff})"
                )
            run_kernel = cycling(lambda wt: fq.fused_quant_matmul_cuda(
                x, wt, ws, src, out_dtype=torch.bfloat16), copies)
            t = b1_times(run_kernel, x, w8, ws, src, iters)
            ms, device_ms, lib_ms, lib_dev = (
                t["ms"], t["device_ms"], t["library_ms"], t["library_device_ms"])
            plain_ms = time_ms(
                lambda: fq.fused_quant_matmul_plain(x, w8, ws, src, out_dtype=torch.bfloat16),
                max(2, iters // 5), warmup=1,
            )
            bound, by = b1_bound_ms(m, k, s, n)
            rows.append(dict(names=names, M=m, K=k, S=s, N=n, ms=ms, device_ms=device_ms,
                             plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev,
                             bound_ms=bound, bound_by=by, max_abs_err=0.0))
            log(f"B1 fused_qmatmul {'/'.join(names)} M={m} K={k}+{s} N={n}: "
                f"kernel_ms={ms:.4f} device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                f"library_device_ms={'null' if lib_dev is None else f'{lib_dev:.4f}'} "
                f"bound_ms={bound:.4f} ({by}) bitwise=yes")
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
# the default k = 4) and of SpecConfig(k=16), a short one, and Q = 31, a
# resume replay's tail (32 new tokens: at most 31 committed past a prompt).
B2V_QS = (2, 5, 17, 31)


def b2v_check(gen, kind, qn, H=32, KV=2):
    """One B2 call with ``qn`` query tokens per lane on a ``kind`` pool
    (``H``/``KV`` heads of 128) against its plain version and against
    ``qn`` sequential Q = 1 launches: pools bitwise (the trash page, which
    several rows write and nothing reads, aside), outputs finite and within
    ``B2_ATOL``, the all-trash lane zeros, every row bitwise the sequential
    launches'. Returns (max |d|, the case and the plain version's pool, for
    timing)."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    pool, table, pos, q, kn, vn = b2_case(gen, kind, Q=qn, H=H, KV=KV, poison=True)
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
    del seq
    return err, (pool, work, want_pool, table, pos, q, kn, vn)


def kernel_phase_b2v(gen, iters):
    """B2's Q > 1 rows (the speculative verify, and a resume's replay) on
    int8, float32 and int4 pools at Q in ``B2V_QS``, held by
    :func:`b2v_check` and timed."""
    from repro_torch.kernels import paged_attention as pa

    rows = []
    for kind in ("int8", "float32", "int4"):
        for qn in B2V_QS:
            err, (pool, work, want_pool, table, pos, q, kn, vn) = b2v_check(gen, kind, qn)
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
            del pool, work, want_pool
    return rows


def layer_weights(qparams):
    """The layer-0 quantized linear weights of a dense, Mamba2 or hymba tree,
    named by their leaf's key (``wq`` ... ``w_down``, ``in_proj``,
    ``out_proj``), and the ``lm_head`` where it is quantized (a tied
    embedding is not)."""
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear
    from repro_torch.models.transformer import layer_params

    out = {}

    def visit(path, leaf):
        if isinstance(leaf, OCSQuantLinear):
            out[path[-1]] = leaf
        return leaf

    map_with_path(visit, layer_params(qparams, 0))
    if isinstance(qparams.get("lm_head"), OCSQuantLinear):
        out["lm_head"] = qparams["lm_head"]
    return out


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
    ``ws``. Device times are CUDA graphs of the same calls. Where the
    contraction (K + S) is not a multiple of 16, also the same product with
    both operands zero-padded to one (exact: the padding adds zero
    products), as ``library_aligned_ms`` and ``library_aligned_device_ms``:
    rows of K + S bf16 that are not 16-byte multiples may keep the library
    off its aligned kernels."""
    import torch

    run_lib = cycling(lambda wb: torch.matmul(xeb, wb) * ws, wb_copies)
    t = dict(ms=time_ms(run_kern, iters), library_ms=time_ms(run_lib, iters),
             device_ms=graph_ms(run_kern, iters), library_device_ms=graph_ms(run_lib, iters))
    ke = xeb.shape[1]
    pad = (-ke) % 16
    if pad:
        xep = torch.nn.functional.pad(xeb, (0, pad))
        wp_copies = [torch.nn.functional.pad(wb, (0, 0, 0, pad)) for wb in wb_copies]
        run_al = cycling(lambda wb: torch.matmul(xep, wb) * ws, wp_copies)
        t.update(library_aligned_ms=time_ms(run_al, iters),
                 library_aligned_device_ms=graph_ms(run_al, iters))
        del wp_copies
    return t


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


def kernel_phase_wo(label, qparams, gen, iters, m_rows=(1, 8, 64, 256)):
    """B4 (``ocs_matmul``, the OCS tree) or B5 (``quant_matmul``, the
    clip-only tree) at every linear shape of the tree (glm4-9b's first):
    weight-only at M in ``m_rows`` (f32 outputs within the summation-order
    bound, bf16 outputs within it plus one bf16 ulp; at M >= 64 the first 8
    rows bitwise an 8-row call's, the decode tile's, whichever tile the
    call took; timed with bf16 outputs, as ``dense`` calls it, wall and
    device; each row names the tile ``quant_matmul.tc_plan`` gave the
    call), int8 at M in {8, 256}
    (bitwise). B4's bf16 calls must all take the tensor cores; its
    CUDA-core route (f32 x) is checked once a shape at M = 8, within the
    same bound."""
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
        for m in m_rows:
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            xe = torch.cat([x.float(), x[:, src.long()].float() * mult], 1) if s else x.float()
            tile = qm.TC_TILE_NAMES[qm.tc_plan(m, k, qm.tc_rows(k, s), n, qm._MAX_PART_BYTES)[0]]
            got, want = kern(x, w8, torch.float32), plain(x, torch.float32)
            torch.cuda.synchronize()
            if m > 8 and not same_bits(kern(x[:8].contiguous(), w8, torch.float32), got[:8]):
                raise AssertionError(f"{label} {names} M={m} ({tile} tile): rows 0..7 differ "
                                     "from an 8-row call's")
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
            rows.append(dict(mode="weight-only", names=names, M=m, K=k, S=s, N=n, tile=tile,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             max_abs_err=err_max, tol_share=ratio, bf16_steps=ulps, **t))
            aligned = (f" library_aligned_device_ms={t['library_aligned_device_ms']:.4f}"
                       if "library_aligned_device_ms" in t else "")
            log(f"{label} weight-only {'/'.join(names)} M={m} K={k}+{s} N={n} ({tile} tile): "
                f"kernel_ms={t['ms']:.4f} device_ms={t['device_ms']:.4f} plain_ms="
                f"{plain_ms:.4f} library_ms={t['library_ms']:.4f} library_device_ms="
                f"{t['library_device_ms']:.4f}{aligned} bound_ms={bound:.4f} ({by}) f32 "
                f"max|d|={err_max:.3g} ({ratio:.3g} of bound), bf16 within bound + 1 ulp"
                + (", rows 0..7 bitwise an 8-row call's" if m > 8 else ""))
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
            rows.append(wo_long_case(label, kern, plain, k, s, n, w8, ws, src, mult, gen,
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


def wo_long_case(label, kern, plain, k, s, n, w8, ws, src, mult, gen, iters):
    """A prefill of the w_down shape long enough that the decode tile would
    run it in two row chunks (``quant_matmul.wo_row_chunk``, which bounds
    the split-K workspace; 519 rows): rows at the start, across that chunk
    boundary and at the end bitwise the same rows in an 8-row call; every
    output within the summation-order bound of the plain version; timed,
    with the plan ``quant_matmul.tc_plan`` gives it (its tile and rows a
    launch)."""
    import torch
    from repro_torch.kernels import quant_matmul as qm

    # The tensor-core split plan of B5's K rows or B4's Kb + S virtual rows.
    kv = qm.tc_rows(k, s)
    nsplit = qm.tc_split_plan(kv, n)[1]
    chunk = qm.wo_row_chunk(1 << 30, n, nsplit)
    m = chunk + 64
    tile, _, _, rows, part_bytes, _ = qm.tc_plan(m, k, kv, n, qm._MAX_PART_BYTES)
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
    name = qm.TC_TILE_NAMES[tile]
    log(f"{label} weight-only w_down M={m} K={k}+{s} N={n} ({name} tile, {rows} rows a launch, "
        f"split-K workspace {part_bytes / 2**20:.1f} MiB): kernel_ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} bound_ms={bound:.4f} ({by}) f32 max|d|={err.max().item():.3g} "
        f"({ratio:.3g} of bound); rows bitwise an 8-row call's")
    return dict(mode="weight-only", names=["w_down"], M=m, K=k, S=s, N=n, tile=name, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=err.max().item(), tol_share=ratio, rows_a_launch=rows,
                workspace_mib=part_bytes / 2**20)


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
            device_ms = graph_ms(lambda: dq.dynamic_quant_cuda(x), iters)
            plain_ms = time_ms(lambda: dq.dynamic_quant_plain(x), max(2, iters // 5), warmup=1)
            bound = 1e3 * (m * k * 2 + m * k + m * 4) / HBM_BPS
            rows.append(dict(M=m, K=k, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound, bound_by="bytes",
                             max_abs_err=0.0))
            log(f"B3 dynamic_quant M={m} K={k}: kernel_ms={ms:.4f} device_ms={device_ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms=null bound_ms={bound:.5f} (bytes) "
                f"bitwise=yes")
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


def to_w4a8_checked(name, leaf, ratio=W4A8_RATIO):
    """``to_w4a8(leaf, ratio)`` on the card, as the engine converts its
    tree (``W4A8_RATIO``), held bitwise against the same conversion of
    ``leaf`` on the CPU (which tests/test_torch_w4a8.py holds bitwise
    against the reference's numpy conversion): all five arrays and the
    padded spec."""
    from repro_torch.core.apply import tree_to
    from repro_torch.core.ocs import to_w4a8

    def arrays(lin):
        return {"w4": lin.w4, "s4": lin.s4, "w8": lin.w8, "s8": lin.s8,
                "outlier_idx": lin.outlier_idx, "spec.src": lin.spec.src,
                "spec.mult": lin.spec.mult, "spec.bias": lin.spec.bias}

    card = to_w4a8(leaf, ratio)
    cpu = to_w4a8(tree_to(leaf, "cpu"), ratio)
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
        a_bits=lin.a_bits, a_scale=None if lin.a_scale is None else lin.a_scale[:n],
        n_out=lin.n_out)


def b6_times(run_kern, x, w4, s4, w8, s8, src, oidx, iters):
    """Wall and device ms of ``run_kern`` (a B6 call cycling its weight
    copies) and of its library yardstick: ``torch._int_mm`` on the
    materialized expanded activations against the int4 weights unpacked
    to int8 before the timing (its copies cycled like the kernel's), the
    outlier product likewise, then the epilogue (M padded to 32, K + S and
    T to 8, as ``_int_mm`` wants). Device times are CUDA graphs of the same
    calls."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    (m, k), n = x.shape, w4.shape[1]
    s, t = src.shape[0], oidx.shape[0]
    ke = k + s
    kp, tp = ke + (-ke) % 8, t + (-t) % 8
    wq = torch.zeros((kp, n), dtype=torch.int8, device="cuda")
    wq[:ke] = pa.unpack_int4(w4.T).T
    w8p = torch.zeros((tp, n), dtype=torch.int8, device="cuda")
    w8p[:t] = w8
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
        y = torch._int_mm(qp, wqc).float() * (scp[:, None] * s4[None, :])
        if t:
            y = y + torch._int_mm(q8, w8p).float() * (scp[:, None] * s8[None, :])
        return y.to(torch.bfloat16)

    run_lib = cycling(lib, cycled(wq))
    del wq
    return dict(ms=time_ms(run_kern, iters), device_ms=graph_ms(run_kern, iters),
                library_ms=time_ms(run_lib, iters), library_device_ms=graph_ms(run_lib, iters))


def kernel_phase_b6(qparams, gen, iters, m_rows=(1, 8, 256), ratio=W4A8_RATIO):
    """w4a8_qmatmul at every linear shape of the tree (glm4-9b's first) x M
    in ``m_rows``: the
    layer-0 and lm_head leaves converted with ``to_w4a8(., ratio)`` on the card (every
    one, and a stacked two-layer ``w_down``, bitwise the CPU's conversion);
    bitwise against the plain version with f32 and bf16 outputs; timed with
    bf16 outputs, as ``dense`` calls it, wall and device (a CUDA graph of the
    same calls), beside its yardstick (``b6_times``)."""
    import torch
    from repro_torch.kernels import w4a8_qmatmul as w4k

    weights = layer_weights(qparams)
    t0 = time.perf_counter()
    converted = {name: to_w4a8_checked(name, w, ratio) for name, w in weights.items()}
    part = "mlp" if "mlp" in qparams["layers"] else "ssm"
    key = next(k for k in ("w_down", "w_out2", "out_proj") if k in qparams["layers"][part])
    to_w4a8_checked(f"{key} layers 0-1 (stacked)", stacked_head(qparams["layers"][part][key], 2),
                    ratio)
    log(f"to_w4a8 on the card: bitwise the CPU's conversion (w4, s4, w8, s8, outlier_idx, "
        f"spec) for {', '.join(weights)} and a stacked two-layer {key} "
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
        for m in m_rows:
            x = (torch.randn((m, k), generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            for out_dtype in (torch.float32, torch.bfloat16):
                got, want = kern(x, (w4, w8), out_dtype), plain(x, out_dtype)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    d = (got.float() - want.float()).abs().max().item()
                    raise AssertionError(f"w4a8_qmatmul {names} M={m} {out_dtype}: not "
                                         f"bitwise (max |d| {d})")
            run_kernel = cycling(lambda ws: kern(x, ws, torch.bfloat16), copies)
            tm = b6_times(run_kernel, x, w4, lin.s4, w8, lin.s8, src, oidx, iters)
            plain_ms = time_ms(lambda: plain(x, torch.bfloat16), max(2, iters // 5), warmup=1)
            bound, by = w4a8_bound_ms(m, k, s, t, n)
            rows.append(dict(names=names, M=m, K=k, S=s, T=t, N=n, **tm, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, max_abs_err=0.0))
            log(f"B6 w4a8_qmatmul {'/'.join(names)} M={m} K={k}+{s} T={t} N={n}: "
                f"kernel_ms={tm['ms']:.4f} device_ms={tm['device_ms']:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={tm['library_ms']:.4f} "
                f"library_device_ms={tm['library_device_ms']:.4f} "
                f"bound_ms={bound:.4f} ({by}) bitwise=yes (f32 and bf16 out)")
        del copies, lin
    del converted
    return rows


def counters():
    """Every launch count: name -> (wrapper module, count attribute).
    ``<kernel>_experts`` is a matmul wrapper's count of its launches over
    an expert stack (one a MoE layer's stacked matrix; part of its count),
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
            "w4a8_qmatmul": (w4a8_qmatmul, "launches"),
            "fused_qmatmul_experts": (fused_qmatmul, "launches_stack"),
            "ocs_matmul_experts": (ocs_matmul, "launches_stack"),
            "quant_matmul_experts": (quant_matmul, "launches_stack"),
            "w4a8_qmatmul_experts": (w4a8_qmatmul, "launches_stack")}


# The matmul kernel each mode runs on an OCS tree.
MODE_KERNEL = {"dequant": "ocs_matmul", "w8a8": "fused_qmatmul", "w4a8": "w4a8_qmatmul"}


def alloc_state(a):
    """The allocator's state once every request has retired: pages in use,
    free and cached, refcounts, the prefix cache's chain keys, its counters
    and the peak (which page ids sit where on the free list follows the
    order lanes retire in)."""
    return (a.in_use(), a.available(), a.cached_pages(), dict(a._ref), sorted(a._page_of),
            a.prefix_hit_pages, a.prefix_lookup_pages, a.peak_in_use)


def seeded_requests(cfg, seed, sampled=False):
    """The serve phases' 8 requests: prompts of 16-256 seeded tokens, 32 new
    tokens each, greedy; with ``sampled``, odd uids get
    ``SAMPLED_PARAMS`` with ``seed=uid``."""
    import numpy as np
    from repro_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(seed)
    reqs = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(16, 257))).tolist(),
                max_new_tokens=32)
        for i in range(8)
    ]
    if sampled:
        for r in reqs[1::2]:
            r.sampling = SamplingParams(**SAMPLED_PARAMS, seed=r.uid)
    return reqs


def serve_phase(label, cfg, qparams, seed, card, ecfg, matmul_kernel, plain=None,
                sampled=False, reverse=False, hook=None, keep_params=False):
    """Serve 8 seeded requests; every launch count is set to 0 just before
    and read just after. ``matmul_kernel`` must run P*L+1 times per decode
    step and per prefill call (P = ``matmuls_per_layer``: 7 for a dense
    layer, 10 for a MoE layer with shared experts, 7 without), the other
    matmul kernels not at all; of those, 3*L over the expert stacks in a
    MoE model (its ``_experts`` count), one launch a stacked matrix.

    With ``ecfg.spec`` set, each step is a speculation round: the target's
    kernel runs 7*L+1 times per round and per prefill call, the drafter's
    (``MODE_KERNEL[spec.draft_mode]``) 7*n+1 times per draft step over its
    n layers, B2 n times per draft step and L times per one-token round,
    B2's Q > 1 path L times per other round; the outputs must equal
    ``plain``'s (the plain phase of the same mode on the same prompts) token
    for token, and the allocator must end in its state.

    Every prefill call counts, a chunk of budgeted prefill and a resume's
    re-prefill alike; a resume's replay (``engine.replay_lengths``: one
    ``decode_tokens`` call over its committed tail) and a drift sample (one
    ``decode_step``) count as a decode step does, the replay through B2's
    Q > 1 path when its tail is longer than one token. ``sampled`` gives odd
    uids ``SAMPLED_PARAMS``; ``reverse`` submits the requests in reverse
    order; ``hook(engine)``, when given, runs after the counts are set to 0
    and before the engine runs to its end (it may step the engine);
    ``keep_params`` returns the engine's tree (converted, in w4a8) under
    ``params``."""
    import torch
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear, W4A8Linear
    from repro_torch.serving import ServingEngine
    from repro_torch.serving import kv_cache as kvc

    t0 = time.perf_counter()
    eng = ServingEngine(cfg, qparams, ecfg, device="cuda")
    torch.cuda.synchronize()
    t_construct = time.perf_counter() - t0
    reqs = seeded_requests(cfg, seed, sampled)
    for r in reqs[::-1] if reverse else reqs:
        eng.submit(r)
    mods = counters()
    for mod, _ in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    hooked = hook(eng) if hook is not None else None
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
    replays = list(eng.replay_lengths)
    drift = int(stats["drift_samples"])
    want = {name: 0 for name in counts}
    per = matmuls_per_layer(cfg)
    stacks = 3 if cfg.block == "moe" else 0
    want[matmul_kernel] = (per * L + 1) * (steps + calls + len(replays) + drift)
    want[matmul_kernel + "_experts"] = stacks * L * (steps + calls + len(replays) + drift)
    want["paged_attention"] = L * (sum(1 for n in replays if n == 1) + drift)
    want["paged_attention_verify"] = L * sum(1 for n in replays if n > 1)
    spec = ecfg.spec
    if spec is None:
        want["paged_attention"] += L * steps
    else:
        dec = eng._spec
        n = min(spec.draft_layers or L, L)
        want[MODE_KERNEL[spec.draft_mode]] += (per * n + 1) * dec.draft_steps
        want[MODE_KERNEL[spec.draft_mode] + "_experts"] += stacks * n * dec.draft_steps
        want["paged_attention"] += n * dec.draft_steps + L * dec.plain_rounds
        want["paged_attention_verify"] += L * (dec.rounds - dec.plain_rounds)
        if not want["paged_attention_verify"]:
            raise AssertionError(f"{label}: no round verified more than one token")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, want {want}")
    outputs = {r.uid: list(r.output) for r in done}
    prompts = {r.uid: list(r.prompt) for r in done}
    alloc = alloc_state(eng.allocator)
    if eng.allocator.in_use():
        raise AssertionError(f"{label}: {eng.allocator.in_use()} pages in use at the end")
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
        extra = (f" + {len(replays)} resume replays (tails {replays})" if replays else "") + (
            f" + {drift} drift samples" if drift else "")
        log(f"serve {label}: {matmul_kernel} wrapper calls {counts[matmul_kernel]} = "
            f"({per}*{L}+1) x ({steps} decode steps + {calls} prefill calls{extra})"
            + (f", {counts[matmul_kernel + '_experts']} of them over the expert stacks "
               f"(3*{L} a call)" if stacks else "")
            + f"; paged_attention {counts['paged_attention']}, its Q>1 path "
            f"{counts['paged_attention_verify']}, as reckoned; others 0")
    else:
        log(f"serve {label}: {spec}: {stats['spec_rounds']:.0f} rounds ({dec.plain_rounds} "
            f"of one token), {dec.draft_steps} draft steps; acceptance "
            f"{stats['spec_acceptance_rate']:.4f}, {stats['spec_tokens_per_target_step']:.4f} "
            f"tokens per target step; draft {stats['spec_draft_time_s']:.3f} s, verify "
            f"{stats['spec_verify_time_s']:.3f} s; launch counts "
            f"{ {k: v for k, v in counts.items() if v} } as reckoned"
            + ("; tokens identical to the plain phase's, allocator state at retire equal"
               if plain is not None else ""))
    if ecfg.prefill_budget or ecfg.admission != "reserve" or sampled:
        log(f"serve {label}: scheduler {stats['sched_policy']}, budget "
            f"{stats['sched_prefill_budget']:.0f}, {stats['sched_chunks']:.0f} chunks, "
            f"{stats['sched_budget_limited_steps']:.0f} budget-limited steps, peak "
            f"{stats['sched_peak_step_prefill_tokens']:.0f} prefill tokens a step, "
            f"{stats['sched_aging_promotions']:.0f} aging promotions | preempted "
            f"{stats['preempted']}, shed {stats['shed']}, timed out {stats['timed_out']} | "
            f"queue wait p50 {stats['queue_wait_p50_s'] * 1e3:.1f} ms p95 "
            f"{stats['queue_wait_p95_s'] * 1e3:.1f} ms | pages peak "
            f"{stats['kv_pages_peak']:.0f} of {stats['kv_pages_capacity']:.0f}")
    res = dict(stats=stats, wall_s=wall, launches=counts, n_layers=L, pool=pool_kind,
               construct_s=t_construct, weight_bytes=weight_bytes[tree],
               kv_bytes_per_token=kvc.kv_bytes_per_token(eng.cfg), outputs=outputs,
               alloc=alloc, prompts=prompts, replays=replays, hook=hooked,
               spec=None if spec is None else dataclasses.asdict(spec),
               draft_steps=None if spec is None else dec.draft_steps)
    if keep_params:
        res["params"] = eng.params
    return res


def top2_margin(cfg, params, tokens, mode):
    """The top-2 logit margin after ``tokens``: one prefill of the whole
    sequence (no prefix, no chunks) through the port's model in ``mode`` on
    fresh float32 pages."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import kv_cache as kvc

    ps = 16
    n = len(tokens)
    nb = kvc.pages_needed(n, ps)
    caches = kvc.init_paged_cache(dataclasses.replace(cfg, kv_bits=None), 1, nb + 1, ps,
                                  nb, device="cuda")
    toks = torch.zeros((1, nb * ps), dtype=torch.int64, device="cuda")
    toks[0, :n] = torch.as_tensor(tokens, device="cuda")
    with torch.no_grad():
        logits, _ = T.prefill_into_pages(
            params, toks, cfg, [layer["attn"] for layer in caches["layers"]],
            torch.arange(1, nb + 1, dtype=torch.int32, device="cuda"),
            length=torch.tensor([n], dtype=torch.int32, device="cuda"),
            prefix_ids=torch.zeros((0,), dtype=torch.int32, device="cuda"), mode=mode)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def hold_near_ties(label, cfg, params, got, plain, mode):
    """``got``'s tokens against the plain phase's: a request may part from
    it only where the plain model's top-2 margin after the common prefix
    is below ``TIE_MARGIN``. Prints each parting; returns them."""
    partings = []
    for uid, want in plain["outputs"].items():
        have = got["outputs"][uid]
        d = next((j for j, (x, y) in enumerate(zip(have, want)) if x != y), None)
        if d is None:
            continue
        margin = top2_margin(cfg, params, plain["prompts"][uid] + want[:d], mode)
        partings.append(dict(uid=uid, at=d, margin=margin))
        log(f"serve {label}: request {uid} parts from the plain phase at output token {d} "
            f"({want[d]} -> {have[d]}); the plain model's top-2 margin there {margin:.4f} "
            f"(bound {TIE_MARGIN})")
        if not margin < TIE_MARGIN:
            raise AssertionError(f"{label}: request {uid} parts at token {d}, where the "
                                 f"top-2 margin {margin:.4f} is no near-tie")
    log(f"serve {label}: tokens held against the plain phase: "
        f"{8 - len(partings)} of 8 requests identical, {len(partings)} part at near-ties")
    return partings


def lifecycle_phases(cfg, qparams, seed, card, serve_cfg, serves):
    """Phases (h)-(j): budgeted chunked prefill and optimistic admission in
    dequant, sampled lanes in w8a8 on int8 pages, each served like the plain
    phases and held against them."""
    from repro_torch.kernels import quant_matmul
    from repro_torch.serving import kv_cache as kvc

    prompts = serves["dequant"]["prompts"]
    out = {}
    # (h) Budgeted chunked prefill: 64-row chunks, at most 128 prompt tokens
    # a step.
    ecfg = serve_cfg.replace(prefill_budget=128, chunk_size=64)
    ph = serve_phase("chunked dequant", cfg, qparams, seed, card, ecfg, "ocs_matmul")
    st = ph["stats"]
    need = sum(-(-len(p) // 64) for p in prompts.values())
    if st["sched_chunks"] < need:
        raise AssertionError(f"chunked dequant: {st['sched_chunks']} chunks, the prompts "
                             f"need {need}")
    if st["sched_peak_step_prefill_tokens"] > 128:
        raise AssertionError("chunked dequant: a step ran more than 128 prompt tokens")
    w_gate = qparams["layers"]["mlp"]["w_gate"].weight.values  # [L, d + S, d_ff]
    s_rows = w_gate.shape[1] - cfg.d_model
    tile = quant_matmul.tc_plan(64, cfg.d_model, quant_matmul.tc_rows(cfg.d_model, s_rows),
                                w_gate.shape[2], 1 << 30)[0]
    log(f"serve chunked dequant: {st['sched_chunks']:.0f} chunks (the prompts need {need}), "
        f"{st['prefill_calls']} prefill calls; a 64-row chunk's w_gate/w_up call takes "
        f"the {quant_matmul.TC_TILE_NAMES[tile]} tile")
    ph["partings"] = hold_near_ties("chunked dequant", cfg, qparams, ph, serves["dequant"],
                                    "dequant")
    out["chunked dequant"] = ph
    # (i) Optimistic admission on a pool that holds every prompt plus one
    # page of headroom each, and no more: decode growth must preempt.
    n_pages = 1 + sum(kvc.pages_needed(len(p), 16) + 1 for p in prompts.values())
    ecfg = serve_cfg.replace(admission="optimistic", n_pages=n_pages)
    ph = serve_phase("optimistic dequant", cfg, qparams, seed, card, ecfg, "ocs_matmul")
    st = ph["stats"]
    if st["preempted"] < 1:
        raise AssertionError("optimistic dequant: no lane was preempted")
    if st["kv_pages_peak"] > st["kv_pages_capacity"]:
        raise AssertionError("optimistic dequant: the page peak passed the capacity")
    if not ph["replays"]:
        raise AssertionError("optimistic dequant: no resume replayed its committed tokens")
    bad = sorted(uid for uid, toks in ph["outputs"].items()
                 if toks != serves["dequant"]["outputs"][uid])
    if bad:
        raise AssertionError(f"optimistic dequant: requests {bad} differ from the plain "
                             "dequant phase's tokens (a resume must be bit-exact)")
    log(f"serve optimistic dequant: pool of {n_pages} pages, {st['preempted']} preemptions, "
        f"{st['prefill_calls']} prefill calls for 8 requests, resume replays of "
        f"{ph['replays']} tokens through the decode path (B2' at Q = each); every request "
        f"bitwise the plain dequant phase's")
    out["optimistic dequant"] = ph
    # (j) Sampled lanes beside greedy ones in w8a8 on int8 pages, then the
    # same requests submitted in reverse order to a second engine.
    ecfg = serve_cfg.replace(matmul_mode="w8a8", kv_bits=8)
    ph = serve_phase("sampled w8a8", cfg, qparams, seed, card, ecfg, "fused_qmatmul",
                     sampled=True)
    again = serve_phase("sampled w8a8, reversed", cfg, qparams, seed, card, ecfg,
                        "fused_qmatmul", sampled=True, reverse=True)
    plain = serves["w8a8"]["outputs"]
    for uid, toks in ph["outputs"].items():
        if uid % 2 == 0 and toks != plain[uid]:
            raise AssertionError(f"sampled w8a8: greedy request {uid} differs from the "
                                 "plain w8a8 phase's tokens")
        if toks != again["outputs"][uid]:
            raise AssertionError(f"sampled w8a8: request {uid} differs when served again "
                                 "in reverse order")
    # The sampler at one decode step of this phase (8 lanes, the odd 4
    # sampled) against the greedy step's argmax: wall per call of
    # back-to-back calls.
    import torch
    from repro_torch.serving import SamplingParams, sampling

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    logits = (torch.randn((8, cfg.vocab), generator=g, device="cuda") * 3).to(torch.bfloat16)
    samp = sampling.params_to_arrays(
        [r.sampling or SamplingParams() for r in seeded_requests(cfg, seed, True)], "cuda")
    pos = torch.full((8,), 300, dtype=torch.int32, device="cuda")
    ph["sampler_ms"] = time_ms(lambda: sampling.sample_tokens(logits, samp, pos), 20)
    ph["argmax_ms"] = time_ms(lambda: torch.argmax(logits, dim=-1), 20)
    log(f"serve sampled w8a8: sample_tokens on [8, {cfg.vocab}] bf16 logits "
        f"{ph['sampler_ms']:.3f} ms a step against argmax {ph['argmax_ms']:.3f} ms")
    differ = sum(ph["outputs"][u] != plain[u] for u in range(1, 8, 2))
    log(f"serve sampled w8a8: greedy requests bitwise the plain w8a8 phase's; sampled "
        f"requests bitwise the same served again in reverse order ({differ} of 4 differ "
        f"from greedy)")
    out["sampled w8a8"] = ph
    out["sampled w8a8, reversed"] = again
    return out


def pool_digest(eng):
    """Every pool tensor of every layer, cloned, and a digest of their bits
    (an int64 sum of the words weighted by their index mod 65521)."""
    import torch

    clones, digest = [], 0
    for layer in eng.caches["layers"]:
        for key in sorted(layer["attn"]):
            t = layer["attn"][key]
            clones.append(t.clone())
            w = t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.uint8)
            w = w.reshape(-1).to(torch.int64)
            idx = torch.arange(w.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
            digest += int((w * idx).sum())
    return clones, digest


def traced_phase(cfg, qparams, seed, card, serve_cfg, serves, out_dir):
    """Phase (k): the plain dequant phase with ``trace=True,
    drift_every=4``. Tokens bitwise the plain dequant phase's; the Chrome
    trace, exported under ``out_dir``, validates; one explicit
    ``_drift_sample()`` once all 8 lanes decode leaves every pool byte as it
    was (the pools cloned and digested before and after)."""
    import torch
    from repro_torch.obs.trace import validate_chrome_trace

    box = {}

    def hook(eng):
        while not all(s.req is not None and not s.prefilling for s in eng.slots):
            eng.step()
        before, d0 = pool_digest(eng)
        pos = eng.caches["pos"].clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._drift_sample()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after, d1 = pool_digest(eng)
        same = all(same_bits(a, b) for a, b in zip(before, after))
        if d0 != d1 or not same or not torch.equal(pos, eng.caches["pos"]):
            raise AssertionError("traced dequant: a drift sample changed the pools")
        if eng._drift_broken:
            raise AssertionError("traced dequant: the drift monitor failed")
        del before, after
        box["eng"] = eng
        return dict(digest_before=d0, digest_after=d1, sample_s=dt, at_step=eng.steps)

    ecfg = serve_cfg.replace(trace=True, drift_every=4)
    ph = serve_phase("traced dequant", cfg, qparams, seed, card, ecfg, "ocs_matmul", hook=hook)
    eng = box.pop("eng")
    bad = sorted(uid for uid, toks in ph["outputs"].items()
                 if toks != serves["dequant"]["outputs"][uid])
    if bad:
        raise AssertionError(f"traced dequant: requests {bad} differ from the plain dequant "
                             "phase's tokens")
    path = Path(out_dir) / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    eng.trace.export(str(path))
    err = validate_chrome_trace(json.loads(path.read_text()))
    if err is not None:
        raise AssertionError(f"traced dequant: the exported trace is invalid: {err}")
    st = ph["stats"]
    if not st["drift_samples"] or not st["drift_sites"]:
        raise AssertionError("traced dequant: the drift monitor sampled nothing")
    h = ph["hook"]
    ph["trace"] = dict(path=str(path), events=len(eng.trace), dropped=eng.trace.dropped,
                       summary=eng.trace.summary())
    log(f"serve traced dequant: every request bitwise the plain dequant phase's; trace "
        f"{len(eng.trace)} events ({eng.trace.dropped} dropped) -> {path.name}, valid; "
        f"kinds {eng.trace.summary()}")
    log(f"serve traced dequant: drift {st['drift_samples']:.0f} samples over "
        f"{st['drift_sites']:.0f} sites, {st['drift_flagged_sites']:.0f} flagged, max ratio "
        f"{st['drift_max_ratio']:.3f}; the explicit sample at step {h['at_step']} took "
        f"{h['sample_s'] * 1e3:.1f} ms wall, pool digest {h['digest_before']} before and "
        f"{h['digest_after']} after (pools bitwise unchanged)")
    del eng
    return ph


def _router_counts(replicas, L):
    """Launch counts of the replicas' engines against the reckoning: the
    matmul kernel (7*L+1) per decode step, prefill call and resume replay;
    B2 L per decode step and one-token replay; its Q > 1 path L per longer
    replay."""
    steps = calls = 0
    reps = []
    for eng in replicas:
        st = eng.stats()
        steps += st["decode_steps"]
        calls += st["prefill_calls"]
        reps += list(eng.replay_lengths)
    return dict(steps=steps, calls=calls, replays=reps,
                matmul=(7 * L + 1) * (steps + calls + len(reps)),
                paged_attention=L * (steps + sum(1 for n in reps if n == 1)),
                paged_attention_verify=L * sum(1 for n in reps if n > 1))


def router_phase(cfg, qparams, seed, serve_cfg, serves, kill_after=4, device="cuda"):
    """Phase (l): two replicas sharing the w8a8 tree on int8 pages serve
    phase (j)'s requests (odd uids sampled) behind the router; replica 0 is
    killed once every lane it holds has committed ``kill_after`` tokens.
    Every output bitwise phase (j)'s, at least one migration, every page of
    both pools back, the launches as reckoned."""
    import torch
    from repro_torch.serving import ReplicaSet, Router, RouterConfig

    ecfg = serve_cfg.replace(matmul_mode="w8a8", kv_bits=8)
    L = cfg.n_layers
    mods = counters()
    for mod, _ in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    router = Router(ReplicaSet.build(cfg, qparams, ecfg, 2, device=device),
                    RouterConfig(placement="round_robin"))
    engines = [rep.engine for rep in router.replicas]
    leaf = lambda e: e.params["layers"]["mlp"]["w_up"].weight.values  # noqa: E731
    shared = leaf(engines[0]).data_ptr() == leaf(engines[1]).data_ptr() == \
        qparams["layers"]["mlp"]["w_up"].weight.values.data_ptr()
    if not shared:
        raise AssertionError("router: the replicas do not share the tree on the card")
    reqs = seeded_requests(cfg, seed, sampled=True)
    for r in reqs:
        router.submit(r)
    killed = None
    while router.step():
        if killed is None:
            lanes = [s.req for s in engines[0].slots if s.req is not None]
            if lanes and not engines[0].queue and all(
                    len(r.output) >= kill_after for r in lanes):
                killed = dict(step=router.steps, committed={r.uid: len(r.output) for r in lanes})
                router.kill(0)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: getattr(mod, attr) for name, (mod, attr) in mods.items()}
    st = router.stats()
    if killed is None or st["router_migrated"] < 1:
        raise AssertionError(f"router: no migration (kill {killed}, stats {st})")
    if any(r.finish_reason != "length" or len(r.output) != 32 for r in reqs):
        raise AssertionError(f"router: finish reasons {[r.finish_reason for r in reqs]}")
    want_out = serves["sampled w8a8"]["outputs"]
    bad = sorted(r.uid for r in reqs if list(r.output) != want_out[r.uid])
    if bad:
        raise AssertionError(f"router: requests {bad} differ from the sampled w8a8 phase's "
                             "tokens after migration")
    for eng in engines:
        if eng.allocator.in_use() or eng.allocator.in_use() + eng.allocator.available() \
                != eng.allocator.capacity:
            raise AssertionError("router: a replica's pool did not get every page back")
    rc = _router_counts(engines, L)
    want = {name: 0 for name in counts}
    want["fused_qmatmul"] = rc["matmul"]
    want["paged_attention"] = rc["paged_attention"]
    want["paged_attention_verify"] = rc["paged_attention_verify"]
    if device == "cuda" and counts != want:
        raise AssertionError(f"router: launch counts {counts}, want {want}")
    log(f"serve router w8a8 (2 replicas, one tree): replica 0 killed at router step "
        f"{killed['step']} with committed tokens {killed['committed']}; migrated "
        f"{st['router_migrated']:.0f}, migrate p50 {st['router_migrate_p50_ms']:.2f} ms; the "
        f"survivor replayed tails {rc['replays']}; every output bitwise the sampled w8a8 "
        f"phase's (greedy and sampled), every page of both pools back; wall {wall:.2f} s")
    log(f"serve router w8a8: fused_qmatmul {counts['fused_qmatmul']} = (7*{L}+1) x "
        f"({rc['steps']} decode steps + {rc['calls']} prefill calls + {len(rc['replays'])} "
        f"replays); paged_attention {counts['paged_attention']}, its Q>1 path "
        f"{counts['paged_attention_verify']}, as reckoned")
    per = [eng.stats() for eng in engines]
    out = dict(stats=st, per_replica=per, wall_s=wall, launches=counts, killed=killed,
               replays=rc["replays"], outputs={r.uid: list(r.output) for r in reqs})
    del router, engines
    return out


# Phase (m)'s failure script over two replicas (round-robin placement: even
# uids on replica 0, odd on replica 1): poison uid 1's third token, stall
# replica 0 for three steps, take every free page of replica 1 for 24 steps
# (its lanes' growth must preempt), kill replica 0.
def chaos_plan():
    from repro_torch.serving import (FaultPlan, InjectNaN, KillReplica, PagePressure,
                                     StallSteps)

    return FaultPlan((InjectNaN(step=0, replica=1, uid=1, at_output_index=3),
                      StallSteps(step=2, replica=0, steps=3, seconds=0.05),
                      PagePressure(step=4, replica=1, pages=1 << 20, hold_steps=24),
                      KillReplica(step=10, replica=0)))


def chaos_phase(cfg, qparams, seed, serve_cfg, plain, device="cuda"):
    """Phase (m): :func:`chaos_plan` run twice over two replicas (w8a8,
    int8 pages, optimistic admission on a pool of every prompt's pages plus
    one each) serving the seeded greedy requests: each request's
    (finish_reason, tokens) identical across the runs, the poisoned request
    "error", every other request bitwise ``plain``'s (the plain w8a8 phase
    of the same depth), no page leaked on either replica."""
    import torch
    from repro_torch.serving import ChaosHarness, ReplicaSet, Router, RouterConfig
    from repro_torch.serving import kv_cache as kvc

    reqs0 = seeded_requests(cfg, seed)
    n_pages = 1 + sum(kvc.pages_needed(len(r.prompt), 16) + 1 for r in reqs0)
    ecfg = serve_cfg.replace(matmul_mode="w8a8", kv_bits=8, admission="optimistic",
                             n_pages=n_pages)
    L = cfg.n_layers
    mods = counters()
    runs = []
    for _ in range(2):
        for mod, _m in mods.values():
            mod.reset_launches()
        router = Router(ReplicaSet.build(cfg, qparams, ecfg, 2, device=device),
                        RouterConfig(placement="round_robin"))
        reqs = seeded_requests(cfg, seed)
        for r in reqs:
            router.submit(r)
        t0 = time.perf_counter()
        harness = ChaosHarness(router, chaos_plan())
        harness.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engines = [rep.engine for rep in router.replicas]
        for eng in engines:
            a = eng.allocator
            if a.in_use() or a.in_use() + a.available() != a.capacity:
                raise AssertionError("chaos: a replica leaked pages")
        counts = {name: getattr(mod, attr) for name, (mod, attr) in mods.items()}
        rc = _router_counts(engines, L)
        want = {name: 0 for name in counts}
        want["fused_qmatmul"] = rc["matmul"]
        want["paged_attention"] = rc["paged_attention"]
        want["paged_attention_verify"] = rc["paged_attention_verify"]
        if device == "cuda" and counts != want:
            raise AssertionError(f"chaos: launch counts {counts}, want {want}")
        st = router.stats()
        runs.append(dict(outputs={r.uid: (r.finish_reason, list(r.output)) for r in reqs},
                         stats=st, launches=counts, wall_s=wall, replays=rc["replays"],
                         preempted=sum(e.stats()["preempted"] for e in engines),
                         errors=sum(e.stats()["errors"] for e in engines)))
        del router, engines, harness
    a, b = runs
    if a["outputs"] != b["outputs"]:
        raise AssertionError("chaos: the two runs of one plan differ")
    if a["outputs"][1][0] != "error":
        raise AssertionError(f"chaos: the poisoned request ended {a['outputs'][1][0]!r}")
    bad = sorted(uid for uid, (why, toks) in a["outputs"].items()
                 if uid != 1 and (why != "length" or toks != plain[uid]))
    if bad:
        raise AssertionError(f"chaos: requests {bad} differ from the plain phase's tokens")
    if not a["preempted"]:
        raise AssertionError("chaos: the page pressure preempted no lane")
    for i, run in enumerate(runs):
        st = run["stats"]
        log(f"serve chaos w8a8 ({L} layers), run {i + 1}: pool of {n_pages} pages a replica; "
            f"placed {st['router_placed']:.0f}, migrated {st['router_migrated']:.0f}, drained "
            f"{st['router_drained']:.0f}, dead {st['router_dead_replicas']:.0f}; preempted "
            f"{run['preempted']}, quarantined {run['errors']}; replays {run['replays']}; "
            f"wall {run['wall_s']:.2f} s; launches {run['launches']}")
    log(f"serve chaos: both runs of {len(chaos_plan().faults)} faults give identical "
        f"(finish_reason, tokens) for all 8 requests; uid 1 ended 'error'; the other 7 "
        f"bitwise the plain {L}-layer w8a8 phase's; no page leaked")
    return dict(runs=runs, n_pages=n_pages)


def b2v_replay_holds(gen, qs_by_kind):
    """B2's Q > 1 path at the tail lengths the resume replays ran
    (``{pool kind: {Q, ...}}``), held as ``kernel_phase_b2v`` holds it,
    untimed. Returns the rows."""
    rows = []
    for kind, qs in sorted(qs_by_kind.items()):
        for qn in sorted(q for q in qs if q > 1):
            err = b2v_check(gen, kind, qn)[0]
            rows.append(dict(pool=kind, Q=qn, max_abs_err=err, timed=False))
            log(f"B2' paged_attention pool={kind} Q={qn} (a resume replay's tail): "
                f"max_abs_err={err:.3g} pools bitwise=yes, rows bitwise the sequential Q=1 "
                f"launches")
    return rows


def verify_check(label, cfg, params, mode, kv_bits, seed, paged=True):
    """``verify_step`` over 5 tokens is bitwise 5 sequential ``decode_step``
    calls on the card at the full model: 8 lanes at ragged positions, after
    4 teacher-forced decode steps of context; logits, every layer's pools
    (with ``paged`` False, the unpaged engine's dense caches of 64 rows)
    and the positions compared."""
    import copy

    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import kv_cache as kvc

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    B, T_, ps, qn = 8, 4, 16, 5
    if paged:
        caches = kvc.init_paged_cache(cfg, B, B * T_ + 1, ps, T_, device="cuda")
        caches["table"] = torch.arange(1, B * T_ + 1, dtype=torch.int32,
                                       device="cuda").reshape(B, T_)
    else:
        caches = T.init_cache(cfg, B, T_ * ps, device="cuda")
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
    what = "pools" if paged else "dense caches"
    log(f"verify check ({label}; {cfg.n_layers} layers, {B} lanes, Q={qn}): verify_step "
        f"bitwise {qn} sequential decode_steps (logits, {cfg.n_layers} layers' {what}, "
        f"positions); {dt:.2f} s")
    return dict(n_layers=cfg.n_layers, lanes=B, Q=qn, bitwise=True, seconds=dt, paged=paged)


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


# ---------------------------------------------------------------------------
# MoE serving: deepseek-moe-16b (and phi3.5-moe-42b-a6.6b), the expert axis
# of B4, B5, B1 and B6.

# The capacities of the stacked-launch kernel phase: a decode step's (8
# lanes route 48 assignments to 64 experts: C = 8) and a prefill's (C = 32:
# a 256-token bucket).
STACK_CS = (8, 32)
# deepseek-moe-16b's depth (of its published 28): a cut, since its
# quantization takes ~4.4 s a layer on an H100 80GB HBM3 and the script
# aims at 60% of its time limit with phase (n) in it.
MOE_LAYERS = 8
# Card vs CPU at the MoE smoke sizes: the card routes as the CPU did, and
# where its own router picks another expert set the k-th and (k+1)-th
# probabilities must be this close (a flipped near-tie; the CPU test's
# bound, tests/test_torch_moe.py).
ROUTE_TIE = 0.01
# The kernels' stacked entries in the kernels line: name -> (wrapper count
# key, source, the TPU kernel its vmapped call reaches).
STACK_KERNELS = {
    "ocs_matmul_experts": ("ocs_matmul", "src/repro_torch/csrc/ocs_matmul.cu",
                           "src/repro/kernels/ocs_matmul.py:44"),
    "quant_matmul_experts": ("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
                             "src/repro/kernels/quant_matmul.py:39"),
    "fused_qmatmul_experts": ("fused_qmatmul", "src/repro_torch/csrc/fused_qmatmul.cu",
                              "src/repro/kernels/fused_qmatmul.py:60"),
    "w4a8_qmatmul_experts": ("w4a8_qmatmul", "src/repro_torch/csrc/w4a8_qmatmul.cu",
                             "src/repro/kernels/fused_qmatmul.py:220"),
}


def matmuls_per_layer(cfg) -> int:
    """``dense`` calls of a quantized weight a layer: attention's 4, and the
    MLP's 3 (SwiGLU; GELU's 2) or the experts' 3 stacked calls plus the shared
    experts' 3 (MoE); a Mamba2 layer's in_proj and out_proj; a hymba
    layer's attention, SSM and MLP (9)."""
    if cfg.block == "moe":
        return 4 + 3 + (3 if cfg.moe.n_shared else 0)
    if cfg.block == "mamba2":
        return 2
    if cfg.block == "hymba":
        return 4 + 2 + 3
    return 4 + (3 if cfg.act == "swiglu" else 2)  # GELU: w_in, w_out2


def matmuls_per_step(cfg) -> int:
    """Quantized ``dense`` calls of one decode step: every layer's, and the
    lm_head's unless it is the tied float embedding (mamba2-1.3b's)."""
    return matmuls_per_layer(cfg) * cfg.n_layers + (0 if cfg.tie_embeddings else 1)


def moe_model(arch, layers):
    """``arch`` at full width, ``layers`` deep (None: its published depth),
    the cut logged on its own line."""
    from repro_torch.configs import get_config

    base = get_config(arch)
    layers = base.n_layers if layers is None else layers
    cfg = dataclasses.replace(base, n_layers=layers)
    m = cfg.moe
    cut = "no cut" if layers == base.n_layers else f"cut: n_layers {layers} of {base.n_layers}"
    log(f"model: {arch} at full width (d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, hd {cfg.hd}, {m.n_experts} experts top-{m.top_k}, expert_ff "
        f"{m.expert_ff}, {m.n_shared} shared, capacity factor {m.capacity_factor}, vocab "
        f"{cfg.vocab}), {layers} layers ({cut})")
    return cfg


# The script's peak device memory before the last reset of the allocator's
# peak (each MoE quantization measures its own).
PEAK_BYTES = [0]


def moe_quantized(cfg, seed, ratio):
    """The seeded weights drawn leaf by leaf on the card (``init_params(lazy=
    True)``) and quantized as drawn: the float32 tree is never whole.
    Returns (tree, seconds, peak GiB of the quantization)."""
    import torch
    from repro_torch.core.apply import quantize_params
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    PEAK_BYTES[0] = max(PEAK_BYTES[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lazy = T.init_params(cfg, seed=seed, device="cuda", lazy=True)
    q = quantize_params(lazy, QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=ratio,
                                          per_channel=True, pad_to=1), device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    held = (torch.cuda.memory_allocated() - base) / 2**30
    log(f"quantize {cfg.name} ({cfg.n_layers} layers, ocs r={ratio}): {dt:.1f} s on the card, "
        f"peak device memory {peak:.2f} GiB, tree {held:.2f} GiB")
    return q, dt, peak


def stack_rows(x, frac, gen):
    """Zero all but about ``frac`` of ``x``'s capacity rows (empty slots),
    expert 1 wholly: the occupancy a routed stack has."""
    import torch

    keep = torch.rand(x.shape[:2], generator=gen, device="cuda") < frac
    keep[1] = False
    return x * keep[..., None].to(x.dtype)


def stack_call(kind, w, x, out_dtype, plain=False):
    """The wrapper's stacked call (or its plain version) with the operands
    ``dense`` gives it for the stacked leaf ``w`` of one layer."""
    from repro_torch.kernels import fused_qmatmul as fq, ocs_matmul as om
    from repro_torch.kernels import w4a8_qmatmul as w4
    from repro_torch.kernels.quant_matmul import stack_scales

    if kind == "B6":
        fn = w4.w4a8_matmul_plain if plain else w4.w4a8_matmul_cuda
        return fn(x, w.w4, w.s4, w.w8, w.s8, w.spec.src[:, w.n_orig:].contiguous(),
                  w.outlier_idx, bits=w.a_bits, out_dtype=out_dtype)
    e, n = w.weight.values.shape[0], w.weight.values.shape[-1]
    ws = stack_scales(w.weight.scale, e, n, x.device)
    src = w.spec.src[:, w.n_orig:].contiguous()
    if kind == "B1":
        fn = fq.fused_quant_matmul_plain if plain else fq.fused_quant_matmul_cuda
        return fn(x, w.weight.values, ws, src, bits=8, out_dtype=out_dtype)
    fn = om.ocs_quant_matmul_plain if plain else om.ocs_quant_matmul_cuda
    return fn(x, w.weight.values, ws, src, tail_mult=w.spec.mult[:, w.n_orig:],
              tail_is_mask=True, out_dtype=out_dtype)


def stack_library(kind, w, x):
    """The library yardstick of a stacked call (never called by the port):
    weight-only, one bf16 ``torch.bmm`` of the materialized expanded
    activations against the stack dequantized to bf16 before the timing,
    then the column scales; B1, per expert ``torch._int_mm`` on the already
    quantized, zero-padded operands plus the epilogue; B6 likewise over the
    int4 weights unpacked to int8 and the outlier rows."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    e, c, k = x.shape
    if kind in ("B4", "B5"):
        vals = w.weight.values
        ws = w.weight.scale.reshape(e, 1, -1).float()
        src = w.spec.src[:, w.n_orig:].long()
        xe = x
        if src.shape[1]:
            tail = torch.gather(x, 2, src[:, None, :].expand(e, c, src.shape[1]))
            xe = torch.cat([x, tail * w.spec.mult[:, None, w.n_orig:].to(x.dtype)], 2)
        wb = vals.to(torch.bfloat16)
        return lambda: torch.bmm(xe, wb) * ws
    rows, mp = [], max(c, 32)
    for i in range(e):
        xi = x[i]
        if kind == "B1":
            vals = w.weight.values[i]
            src = w.spec.src[i, w.n_orig:].long()
            q, sc = ref.dynamic_quant_ref(xi)
            qe = torch.cat([q, q[:, src]], 1)
            ke = qe.shape[1]
            kp = ke + (-ke) % 8
            qp = torch.zeros((mp, kp), dtype=torch.int8, device="cuda")
            qp[:c, :ke] = qe
            wp = torch.zeros((kp, vals.shape[1]), dtype=torch.int8, device="cuda")
            wp[:ke] = vals
            scp = torch.zeros((mp,), device="cuda")
            scp[:c] = sc
            rows.append((qp, wp, scp[:, None] * w.weight.scale.reshape(e, -1)[i][None, :],
                         None, None, None))
        else:
            src = w.spec.src[i, w.n_orig:].long()
            oidx = w.outlier_idx[i].long()
            q, sc = pa.quant_rows(xi, 127.0)
            qe = torch.cat([q, q[:, src]], 1)
            ke = qe.shape[1]
            kp = ke + (-ke) % 8
            t = oidx.shape[0]
            tp = t + (-t) % 8
            n = w.w4.shape[-1]
            wq = torch.zeros((kp, n), dtype=torch.int8, device="cuda")
            wq[:ke] = pa.unpack_int4(w.w4[i].T).T
            qp = torch.zeros((mp, kp), dtype=torch.int8, device="cuda")
            qp[:c, :ke] = qe
            q8 = torch.zeros((mp, tp), dtype=torch.int8, device="cuda")
            q8[:c, :t] = qe[:, oidx]
            w8p = torch.zeros((tp, n), dtype=torch.int8, device="cuda")
            w8p[:t] = w.w8[i]
            scp = torch.zeros((mp,), device="cuda")
            scp[:c] = sc
            rows.append((qp, wq, scp[:, None] * w.s4[i][None, :], q8, w8p,
                         scp[:, None] * w.s8[i][None, :]))

    def run():
        for qp, wp, s4, q8, w8p, s8 in rows:
            y = torch._int_mm(qp, wp).float() * s4
            if q8 is not None:
                y = y + torch._int_mm(q8, w8p).float() * s8
            y.to(torch.bfloat16)

    return run


def stack_bound_ms(kind, w, x):
    """Each input read once (x, the stacked weights, their tails and
    scales), the output written once at HBM rate; or the multiply-adds at
    the bf16 (B4, B5) or int8 (B1, B6) tensor-core peak: the larger. A tail
    entry is its int32 source (B1, B6 fold the multipliers into the
    weights) and, for B4, its float32 multiplier, as the 2-D bounds count
    them."""
    e, c, k = x.shape
    if kind == "B6":
        n = w.w4.shape[-1]
        ke = 2 * w.w4.shape[1]
        wbytes = w.w4.numel() + w.w8.numel() + 8 * e * n + 4 * w.outlier_idx.numel()
        peak = INT8_OPS
    else:
        n = w.weight.values.shape[-1]
        ke = w.weight.values.shape[1]
        wbytes = w.weight.values.numel() + 4 * e * n
        peak = INT8_OPS if kind == "B1" else BF16_FLOPS
    tail = (8 if kind == "B4" else 4) * e * (ke - k)
    byts = x.numel() * 2 + wbytes + tail + e * c * n * 2
    ops = 2.0 * e * c * ke * n
    t_b, t_o = byts / HBM_BPS, ops / peak
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def force_tile(tile):
    """Make ``quant_matmul.tc_plan`` give ``tile``; returns the function that
    undoes it."""
    from repro_torch.kernels import quant_matmul as qm

    plan = qm.tc_plan

    def forced(m, k, kv, n, max_part):
        if tile == qm.TC_PREFILL:
            return (qm.TC_PREFILL, *qm.tc_split_plan(kv, n), m, 0, 0)
        return (qm.TC_DECODE, *qm._tc_launch_plan(m, kv, n, max_part))

    qm.tc_plan = forced

    def undo():
        qm.tc_plan = plan

    return undo


def kernel_phase_stack(leaves, gen, iters):
    """B4, B5, B1 and B6 over deepseek-moe-16b's layer-0 expert stacks
    (``leaves``: kind -> {"w_gate", "w_down"} stacked leaves, E = 64; w_up
    has w_gate's shape) at C in ``STACK_CS``, bf16 x with empty capacity
    rows (zero) and an all-zero expert: one launch a call (its count and
    its stack count each move by one), each expert's output bitwise the 2-D
    launch on its slice, zero rows zero; against the plain stacked call
    bitwise (B1, B6) or within the weight-only bound (B4, B5; f32 outputs;
    bf16 within it plus one bf16 ulp); B4 and B5 also on their prefill tile
    at C = 32, bitwise the decode tile. Timed: wall and device ms, the plain
    version, the library yardstick (``stack_library``) and the bound."""
    import torch
    from repro_torch.kernels import fused_qmatmul as fq, ocs_matmul as om
    from repro_torch.kernels import quant_matmul as qm, w4a8_qmatmul as w4
    from repro_torch.models.layers import dense

    mods = {"B4": om, "B5": qm, "B1": fq, "B6": w4}
    modes = {"B4": "dequant", "B5": "dequant", "B1": "w8a8", "B6": "w4a8"}
    rows = []
    for kind in ("B4", "B5", "B1", "B6"):
        mod = mods[kind]
        for name in ("w_gate", "w_down"):
            w = leaves[kind][name]
            k = w.n_orig
            e = (w.w4 if kind == "B6" else w.weight.values).shape[0]
            n = (w.w4 if kind == "B6" else w.weight.values).shape[-1]
            s = (w.spec.src.shape[1] - k)
            for c in STACK_CS:
                x = (torch.randn((e, c, k), generator=gen, device="cuda") * 1.5).to(
                    torch.bfloat16)
                x = stack_rows(x, 48 / (e * 8) if c == 8 else 0.75, gen)
                n0 = (mod.launches, mod.launches_stack)
                got = dense(w, x, mode=modes[kind], name=f"moe_{name[2:]}")
                torch.cuda.synchronize()
                if (mod.launches, mod.launches_stack) != (n0[0] + 1, n0[1] + 1):
                    raise AssertionError(f"{kind} stack {name}: not one launch")
                if got.shape != (e, c, n) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{kind} stack {name} C={c}: shape or non-finite")
                zero = (x == 0).all(-1)
                if not bool((got[zero] == 0).all()):
                    raise AssertionError(f"{kind} stack {name} C={c}: a zero row is not zero")
                for i in range(e):
                    one = dense(w.layer(i), x[i], mode=modes[kind])
                    if not same_bits(got[i], one):
                        raise AssertionError(f"{kind} stack {name} C={c}: expert {i} differs "
                                             "from its 2-D launch")
                tiles = ["planned"]
                if kind in ("B4", "B5") and c == max(STACK_CS):
                    for tile in (qm.TC_DECODE, qm.TC_PREFILL):
                        undo = force_tile(tile)
                        try:
                            forced = dense(w, x, mode=modes[kind])
                            alone = [dense(w.layer(i), x[i], mode=modes[kind])
                                     for i in (0, e // 2, e - 1)]
                        finally:
                            undo()
                        if not same_bits(forced, got) or not all(
                                same_bits(a, got[i]) for a, i in zip(alone, (0, e // 2, e - 1))):
                            raise AssertionError(f"{kind} stack {name} C={c}: the "
                                                 f"{qm.TC_TILE_NAMES[tile]} tile differs")
                        tiles.append(qm.TC_TILE_NAMES[tile])
                if kind in ("B1", "B6"):
                    want = stack_call(kind, w, x, torch.bfloat16, plain=True)
                    if not same_bits(got, want):
                        raise AssertionError(f"{kind} stack {name} C={c}: differs from plain")
                    err = 0.0
                else:
                    g32 = stack_call(kind, w, x, torch.float32)
                    p32 = stack_call(kind, w, x, torch.float32, plain=True)
                    xe, w8, ws = x.float(), w.weight.values, w.weight.scale.reshape(e, -1)
                    if s:
                        src = w.spec.src[:, k:].long()
                        tail = torch.gather(xe, 2, src[:, None, :].expand(e, c, s))
                        xe = torch.cat([xe, tail * w.spec.mult[:, None, k:]], 2)
                    tol = torch.stack([wo_tol(xe[i], w8[i], ws[i], k, s) for i in range(e)])
                    if not bool(((g32 - p32).abs() <= tol).all()):
                        raise AssertionError(f"{kind} stack {name} C={c}: beyond the bound")
                    p16 = stack_call(kind, w, x, torch.bfloat16, plain=True).float()
                    lim = tol + bf16_ulp(torch.maximum(got.float().abs(), p16.abs()))
                    if not bool(((got.float() - p16).abs() <= lim).all()):
                        raise AssertionError(f"{kind} stack {name} C={c}: bf16 beyond the bound")
                    err = float((g32 - p32).abs().max())
                run = lambda: dense(w, x, mode=modes[kind])  # noqa: E731
                plain = lambda: stack_call(kind, w, x, torch.bfloat16, plain=True)  # noqa: E731
                lib = stack_library(kind, w, x)
                bound, by = stack_bound_ms(kind, w, x)
                r = dict(kernel=kind, name=name, E=e, C=c, K=k, S=s, N=n,
                         ms=time_ms(run, iters), device_ms=graph_ms(run, iters),
                         plain_ms=time_ms(plain, 2, warmup=1),
                         library_ms=time_ms(lib, iters), library_device_ms=graph_ms(lib, iters),
                         bound_ms=bound, bound_by=by, max_abs_err=err, tiles=tiles)
                rows.append(r)
                log(f"{kind} stack {name} E={e} C={c} K={k}+{s} N={n}: one launch, every "
                    f"expert bitwise its 2-D launch ({', '.join(tiles)} tile), zero rows zero, "
                    f"vs plain max |d| {err:.3g}; ms={r['ms']:.4f} device_ms="
                    f"{r['device_ms']:.4f} plain_ms={r['plain_ms']:.3f} library_ms="
                    f"{r['library_ms']:.4f} library_device_ms={r['library_device_ms']:.4f} "
                    f"bound_ms={bound:.4f} ({by})")
                del x, got
    return rows


def stack_step(rows, kind, L, c=8):
    """One MoE decode step's stacked calls of ``kind`` (w_gate and w_up at
    w_gate's shape, w_down; each once a layer), at capacity ``c``."""
    tot = {key: 0.0 for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                "library_device_ms", "bound_ms")}
    by_ops = 0.0
    for r in rows:
        if r["kernel"] != kind or r["C"] != c:
            continue
        mult = L * (2 if r["name"] == "w_gate" else 1)
        for key in tot:
            tot[key] += mult * r[key]
        if r["bound_by"] == "operations":
            by_ops += mult * r["bound_ms"]
    tot["bound_by"] = "operations" if by_ops > tot["bound_ms"] / 2 else "bytes"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["kernel"] == kind)
    return tot


class RoutingCounts:
    """Dropped assignments per call kind, from the routing the MoE block
    computes (a wrapper of ``models.moe.dispatch``), kept on the device until
    read; the call kind comes from the model function the engine called
    (a prefill, a one-token decode step, a multi-token verify)."""

    def __init__(self):
        self.kind = "prefill"
        self.dropped = {}
        self.assigned = {}
        self.calls = {}

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer as T

        self._orig = (T.prefill_into_pages, T.decode_tokens)
        counts = self

        def prefill(*a, **kw):
            counts.kind = "prefill"
            return counts._orig[0](*a, **kw)

        def decode(params, tokens, *a, **kw):
            counts.kind = "decode" if tokens.shape[1] == 1 else "verify"
            return counts._orig[1](params, tokens, *a, **kw)

        def dispatch(top_idx, n_experts, cap):
            out = counts._dispatch(top_idx, n_experts, cap)
            counts._note(out[2])
            return out

        self._dispatch = moe_mod.dispatch
        T.prefill_into_pages, T.decode_tokens = prefill, decode
        moe_mod.dispatch = dispatch
        return self

    def _note(self, keep):
        k = self.kind
        d = (~keep).sum()
        self.dropped[k] = self.dropped[k] + d if k in self.dropped else d
        self.assigned[k] = self.assigned.get(k, 0) + keep.numel()
        self.calls[k] = self.calls.get(k, 0) + 1

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer as T

        T.prefill_into_pages, T.decode_tokens = self._orig
        moe_mod.dispatch = self._dispatch
        return False

    def summary(self):
        return {k: dict(calls=self.calls[k], dropped=int(self.dropped[k]),
                        assigned=self.assigned[k]) for k in self.calls}


def moe_step_profile(label, cfg, params, ecfg, seed, steps=2, reqs=None):
    """A decode step's device operations and busy share (a MoE model's, or
    with ``reqs`` another's): a fresh engine on the served tree, the
    phase's requests, one unprofiled step (admission, prefills, a decode),
    then ``steps`` decode steps under ``torch.profiler``
    (``launch/profile_decode.py``'s reckoning)."""
    import torch
    from repro_torch.launch.profile_decode import profile_steps
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(cfg, params, ecfg, device="cuda")
    for r in reqs if reqs is not None else seeded_requests(cfg, seed):
        eng.submit(r)
    eng.step()
    torch.cuda.synchronize()
    prof = profile_steps(eng, steps)
    ops = {k: v for k, v in prof["device_ops_per_step"].items() if v}
    log(f"profile {label} ({cfg.n_layers} layers, {ecfg.max_batch} lanes, {steps} decode steps, "
        f"profiler on): "
        f"{prof['ops_per_step']:.0f} device operations a step; device busy "
        f"{prof['busy_ms_per_step']:.2f} ms of {prof['wall_ms_per_step']:.2f} ms a step "
        f"({100 * (1 - prof['busy_share']):.1f}% idle); hand-written families {ops}")
    del eng
    return prof


def moe_phases(args, card, serve_cfg, gen):
    """deepseek-moe-16b at ``MOE_LAYERS`` (8 of 28): quantized leaf
    by leaf on the card; served in w8a8 (int8 pages), dequant (float32
    pages) and w4a8 (int4 pages); each step profiled once; a spec w8a8
    phase; its clip-only tree at --short-layers or MOE_LAYERS, the
    shallower (a cut), served in dequant
    (B5); phi3.5-moe-42b-a6.6b at --phi-layers (a cut) in w8a8. Then the
    stacked-launch kernel phase on the layer-0 experts."""
    import torch
    from repro_torch.core.ocs import to_w4a8
    from repro_torch.models.transformer import layer_params
    from repro_torch.serving.spec_decode import SpecConfig

    out = {"serves": {}, "profiles": {}, "drops": {}}
    cfg = moe_model("deepseek-moe-16b", MOE_LAYERS)
    q, t_q, peak_q = moe_quantized(cfg, args.seed, 0.02)
    out.update(quantize_s=t_q, quantize_peak_gib=peak_q)
    phases = (("w8a8", serve_cfg.replace(matmul_mode="w8a8", kv_bits=8), "fused_qmatmul"),
              ("dequant", serve_cfg, "ocs_matmul"),
              ("w4a8", serve_cfg.replace(matmul_mode="w4a8", kv_bits=4), "w4a8_qmatmul"))
    q_w4a8 = None
    for mode, ecfg, kern in phases:
        label = f"deepseek-moe-16b {mode}"
        with RoutingCounts() as rc:
            res = serve_phase(label, cfg, q, args.seed, card, ecfg, kern,
                              keep_params=mode == "w4a8")
        if mode == "w4a8":
            q_w4a8 = res.pop("params")
        out["serves"][mode] = res
        out["drops"][mode] = rc.summary()
        log(f"serve {label}: dropped assignments by call kind {rc.summary()}")
        out["profiles"][mode] = moe_step_profile(label, cfg, q_w4a8 if mode == "w4a8" else q,
                                                 ecfg, args.seed)
    log(f"serve deepseek-moe-16b: weight bytes w4a8 {out['serves']['w4a8']['weight_bytes'] / 1e9:.3f}"
        f" GB vs int8 {out['serves']['w8a8']['weight_bytes'] / 1e9:.3f} GB; KV bytes per token "
        f"{out['serves']['w8a8']['kv_bytes_per_token']} (int8), "
        f"{out['serves']['dequant']['kv_bytes_per_token']} (float32), "
        f"{out['serves']['w4a8']['kv_bytes_per_token']} (int4)")
    # Self-speculation (w8a8, drafting with the first quarter of the layers):
    # held to the plain w8a8 phase's tokens only where no verify dropped an
    # assignment (a token's MoE output follows the other rows of its call:
    # ROADMAP "MoE greedy exactness is a knife edge"); agreement reported.
    spec = SpecConfig(draft_layers=max(1, cfg.n_layers // 4))
    with RoutingCounts() as rc:
        res = serve_phase("deepseek-moe-16b spec w8a8", cfg, q, args.seed, card,
                          serve_cfg.replace(matmul_mode="w8a8", kv_bits=8, spec=spec),
                          "fused_qmatmul")
    plain = out["serves"]["w8a8"]["outputs"]
    same = sum(a == b for uid in plain for a, b in zip(res["outputs"][uid], plain[uid]))
    total = sum(len(v) for v in plain.values())
    parted = sorted(uid for uid in plain if res["outputs"][uid] != plain[uid])
    drops = rc.summary()
    res.update(agreement=same / total, parted=parted)
    out["serves"]["spec w8a8"] = res
    out["drops"]["spec w8a8"] = drops
    log(f"serve deepseek-moe-16b spec w8a8 ({spec}): acceptance "
        f"{res['stats']['spec_acceptance_rate']:.4f}, token agreement with plain w8a8 "
        f"{same}/{total} ({same / total:.4f}), requests parted {parted}; dropped "
        f"assignments by call kind {drops}")
    # A decode step of 8 lanes never drops (capacity 8); with no verify drop
    # either, every row's MoE output is the plain step's, so the tokens are.
    if parted and not drops.get("verify", {}).get("dropped"):
        raise AssertionError("spec w8a8 parted from plain greedy with no verify drop")
    leaves = {"B4": {}, "B1": {}, "B6": {}}
    lp = layer_params(q, 0)["moe"]["experts"]
    lp4 = layer_params(q_w4a8, 0)["moe"]["experts"]
    for name in ("w_gate", "w_down"):
        leaves["B4"][name] = leaves["B1"][name] = lp[name]
        leaves["B6"][name] = lp4[name]
    # The card's conversion of one layer-0 expert stack, bitwise the CPU's.
    conv = to_w4a8_checked("layer-0 expert stack w_down", lp["w_down"])
    if not all(same_bits(a, b) for a, b in ((conv.w4, lp4["w_down"].w4),
                                            (conv.w8, lp4["w_down"].w8))):
        raise AssertionError("the engine's w4a8 expert stack differs from to_w4a8's")
    del conv, q_w4a8
    # The clip-only tree (ocs_ratio=0: B5 over the experts), cut.
    cfg_clip = moe_model("deepseek-moe-16b", min(args.short_layers, cfg.n_layers))
    qclip, t_clip, _ = moe_quantized(cfg_clip, args.seed, 0.0)
    out["quantize_clip_s"] = t_clip
    with RoutingCounts() as rc:
        out["serves"]["clip-only dequant"] = serve_phase(
            f"deepseek-moe-16b clip-only dequant ({cfg_clip.n_layers} layers)", cfg_clip, qclip,
            args.seed, card, serve_cfg, "quant_matmul")
    out["drops"]["clip-only dequant"] = rc.summary()
    leaves["B5"] = {name: layer_params(qclip, 0)["moe"]["experts"][name]
                    for name in ("w_gate", "w_down")}
    out["stack"] = kernel_phase_stack(leaves, gen, args.iters)
    out["layers"] = cfg.n_layers
    out["clip_layers"] = cfg_clip.n_layers
    del q, qclip, leaves, lp, lp4
    torch.cuda.empty_cache()
    # phi3.5-moe-42b-a6.6b, w8a8, cut in depth.
    cfg_phi = moe_model("phi3.5-moe-42b-a6.6b", args.phi_layers)
    qphi, t_phi, peak_phi = moe_quantized(cfg_phi, args.seed, 0.02)
    out.update(phi_quantize_s=t_phi, phi_layers=cfg_phi.n_layers)
    with RoutingCounts() as rc:
        out["serves"]["phi3.5 w8a8"] = serve_phase(
            f"phi3.5-moe-42b-a6.6b w8a8 ({cfg_phi.n_layers} layers)", cfg_phi, qphi, args.seed,
            card, serve_cfg.replace(matmul_mode="w8a8", kv_bits=8), "fused_qmatmul")
    out["drops"]["phi3.5 w8a8"] = rc.summary()
    log(f"serve phi3.5-moe-42b-a6.6b w8a8: dropped assignments by call kind {rc.summary()}")
    del qphi
    torch.cuda.empty_cache()
    return out


def moe_smoke_model(arch, seed, *, kv_bits, w4a8):
    """A MoE smoke config and its tree quantized on the CPU with the
    serving recipe (``w4a8``: converted as the engine converts it)."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import map_with_path, quantize_params
    from repro_torch.core.ocs import OCSQuantLinear, to_w4a8
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(smoke_config(arch), kv_bits=kv_bits)
    qp = quantize_params(T.init_params(cfg, seed=seed, device="cpu"),
                         QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True,
                                     pad_to=1), device="cpu")
    if w4a8:
        qp = map_with_path(lambda _p, leaf: to_w4a8(leaf, W4A8_RATIO)
                           if isinstance(leaf, OCSQuantLinear) else leaf, qp)
    return cfg, qp


class ForcedRoutes:
    """While active, every MoE routing records its ``top_idx`` (``record``)
    or takes the next recorded one (``replay``: the gates are the caller's
    own renormalized probabilities of those experts), and notes, where its
    own choice differs as a set, the gap between its k-th and (k+1)-th
    probabilities."""

    def __init__(self, routes=None):
        self.routes = [] if routes is None else routes
        self.replay = routes is not None
        self.margins = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe as moe_mod

        self._orig = moe_mod.route
        own_route = self._orig
        state = self
        it = iter(self.routes)

        def route(router_w, xf, k):
            gate, own = own_route(router_w, xf, k)
            if not state.replay:
                state.routes.append(own.cpu())
                return gate, own
            want = next(it).to(own.device)
            probs = torch.softmax(xf.to(torch.float32) @ router_w.to(torch.float32), -1)
            srt = torch.sort(probs, dim=-1, descending=True, stable=True).values
            differ = (own.sort(-1).values != want.sort(-1).values).any(-1)
            for r in torch.nonzero(differ).reshape(-1).tolist():
                state.margins.append(float(srt[r, k - 1] - srt[r, k]))
            g = probs.gather(1, want)
            return g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9), want

        moe_mod.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod

        moe_mod.route = self._orig
        return False


# MoE reference-check cases: (label, arch, matmul mode, KV bits).
MOE_REFERENCE_CASES = (
    ("deepseek-moe-16b w8a8, int8 pages", "deepseek-moe-16b", "w8a8", 8),
    ("deepseek-moe-16b dequant, float32 pages", "deepseek-moe-16b", "dequant", None),
    ("deepseek-moe-16b w4a8 + int4 pages", "deepseek-moe-16b", "w4a8", 4),
    ("phi3.5-moe-42b-a6.6b w8a8, int8 pages", "phi3.5-moe-42b-a6.6b", "w8a8", 8),
)


def moe_reference_check(seed):
    """The MoE smoke configs: card kernels vs CPU plain versions, same
    weights (``smoke_logits``: prefill, 4 teacher-forced decodes, a
    teacher-forced verify of 5). The card routes as the CPU did (its own
    choice may differ only at a near-tie, ``ROUTE_TIE``), and the logits
    agree within ``MODEL_RTOL``."""
    import torch
    from repro_torch.core.apply import tree_to

    out = {}
    for label, arch, mode, kv_bits in MOE_REFERENCE_CASES:
        cfg, qp = moe_smoke_model(arch, seed, kv_bits=kv_bits, w4a8=mode == "w4a8")
        with ForcedRoutes() as rec:
            cpu = smoke_logits(qp, cfg, seed, "cpu", mode)
        with ForcedRoutes(rec.routes) as rep:
            card = smoke_logits(tree_to(qp, torch.device("cuda")), cfg, seed, "cuda", mode)
        scale = cpu.abs().max().item()
        err = (card - cpu).abs().max().item()
        if any(m > ROUTE_TIE for m in rep.margins):
            raise AssertionError(f"reference check ({label}): the card's router parted from "
                                 f"the CPU's away from a near-tie: margins {rep.margins}")
        if not torch.isfinite(card).all() or err > MODEL_RTOL * scale:
            raise AssertionError(f"reference check ({label}): max |d logits| {err} > "
                                 f"{MODEL_RTOL} x {scale}")
        log(f"reference check ({label}; smoke, prefill + 4 teacher-forced decode steps + a "
            f"teacher-forced verify of 5, card kernels vs CPU plain, {len(rec.routes)} "
            f"routings, the card's own routing parting at {len(rep.margins)} rows, margins "
            f"{[round(m, 6) for m in rep.margins]}): max |d logits| {err:.6g} of max |logit| "
            f"{scale:.6g} ({err / scale:.3g}; limit {MODEL_RTOL})")
        out[label] = dict(max_abs_err=err, logit_scale=scale, route_flips=len(rep.margins))
    return out


def step_sum(rows, L, mode=None, m=8):
    """One decode step's work of a matmul kernel: the M = 8 rows (``m``:
    the rows of another call size, 256 for a prefill's), each shape counted
    once per layer (the lm_head once); ms, plain_ms, library_ms and
    bound_ms summed, and the bound's kind by its larger share."""
    per_step = {"wq": L, "wk": L, "wv": L, "wo": L, "w_gate": L, "w_up": L,
                "w_down": L, "w_in": L, "w_out2": L, "in_proj": L, "out_proj": L,
                "lm_head": 1}
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
    for key in ("device_ms", "library_device_ms"):  # absent where not measured
        if not tot[key]:
            del tot[key]
    tot["bound_by"] = "operations" if by_ops > tot["bound_ms"] / 2 else "bytes"
    return tot


# ---------------------------------------------------------------------------
# The unpaged engine (EngineConfig.paged=False) and the SSM and hybrid
# decoders it serves: mamba2-1.3b and hymba-1.5b.

# The SSM and hybrid serve phases' requests: SSM_REQUESTS prompts of 16-20
# seeded tokens (a cut: those prompts replay through the decode step, one
# full b = 1 step a token, as the reference's engine replays them: ~0.1 s
# a token for mamba2-1.3b, ~0.2 s for hymba-1.5b with an H100 80GB HBM3),
# SSM_NEW_TOKENS new tokens each, greedy, on as many lanes (every decode
# step's GEMMs at M = 8, as the kernel checks and the step sums take
# them); max_len 64, below hymba's window of 1024: the full-size ring never
# wraps (the smoke reference check passes its window of 32).
SSM_REQUESTS = 8
SSM_NEW_TOKENS = 32
SSM_MAX_LEN = 64
# The depth of the SSM and hybrid phases' repeats (a cut: each phase is
# served once at its depth, then twice at this one, the second token for
# token the first), which keeps the script within 60% of its time limit:
# a replayed prompt token costs a full step at any depth.
SSM_REPEAT_LAYERS = 4
# The depth of the SSM and hybrid serves (cuts that make room for phase
# (n); the quantize and the kernel checks stay at the full 48 and
# 32): a replayed prompt token costs a full step, on an H100 80GB HBM3
# 21-24 s a serve at mamba2-1.3b's 48 layers and 42-62 s at hymba-1.5b's
# 32 (9-10 s at 24; 17 s at 16). hymba-1.5b's first 16 layers hold two of its
# three global layers (0, 15); the rest are window layers whose 1024-row
# window the 64-row serves never fill. hymba's w4a8 serve runs at
# --short-layers.
SSM_SERVE_LAYERS = {"mamba2-1.3b": 24, "hymba-1.5b": 16}
# Card (kernels) vs CPU (plain versions) logits of the SSM and hybrid smoke
# models, relative to the largest logit, by matmul mode. B1 and B6 are
# bitwise their plain versions and the recurrence, the conv and the
# dense-cache attention gave the CPU's bits on the card (0 in w8a8 and
# w4a8, int8 caches included, H100 80GB HBM3); B4 sums in another float32
# order (0.0015 and 0.0019 of the largest logit in dequant).
SSM_CARD_RTOL = {"dequant": 0.01, "w8a8": 0.0, "w4a8": 0.0}


def ssm_requests(cfg, seed, prompt_len=None):
    """The SSM and hybrid serve phases' requests (fresh ones on each call);
    ``prompt_len`` cuts every prompt to that many tokens (the profiles)."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(16, 21))).tolist(),
                    max_new_tokens=SSM_NEW_TOKENS) for i in range(SSM_REQUESTS)]
    if prompt_len:
        for r in reqs:
            r.prompt = r.prompt[:prompt_len]
    return reqs


def unpaged_serve_phase(label, cfg, qparams, card, ecfg, matmul_kernel, reqs, plain=None):
    """Serve ``reqs`` on an unpaged engine (``ecfg.paged`` False, or an SSM
    or hybrid model); every launch count is set to 0 just before and read
    just after. The mode's kernel must run ``matmuls_per_step`` times per
    decode step and per prefill call (a replayed prompt token is one, as
    the reference counts it; with ``ecfg.spec`` a decode step is a round,
    its verify one such call and its drafter's kernel ``matmuls_per_layer
    * n + 1`` times a draft step over its n layers), every other kernel not
    at all: B2 neither, the dense caches' attention being torch ops. Every request must end by
    length; parameters and every cache tensor lie on the card, attention
    caches float32 or int8 as the phase asks. With ``plain`` (an earlier
    phase's result) every request must be token for token its."""
    import torch
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear, W4A8Linear
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    eng = ServingEngine(cfg, qparams, ecfg, device="cuda")
    torch.cuda.synchronize()
    t_construct = time.perf_counter() - t0
    if eng.paged or eng.admission != "reserve":
        raise AssertionError(f"{label}: the engine is not an unpaged reserve engine")
    new_tokens = reqs[0].max_new_tokens
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
    if len(done) != len(reqs) or any(r.finish_reason != "length" for r in done):
        raise AssertionError(f"{label}: finish reasons {[r.finish_reason for r in done]}")
    if any(len(r.output) != new_tokens for r in done):
        raise AssertionError(f"{label}: a request did not produce {new_tokens} tokens")

    def on_card(path, leaf):
        ts = [leaf] if isinstance(leaf, torch.Tensor) else (
            [leaf.weight.values, leaf.weight.scale, leaf.spec.src] if isinstance(
                leaf, OCSQuantLinear) else [leaf.w4, leaf.w8, leaf.s4, leaf.s8]
            if isinstance(leaf, W4A8Linear) else [])
        if any(not t.is_cuda for t in ts):
            raise AssertionError(f"{label}: {'/'.join(map(str, path))} not on the card")
        if (ecfg.matmul_mode == "w4a8") != isinstance(leaf, W4A8Linear) and isinstance(
                leaf, (OCSQuantLinear, W4A8Linear)):
            raise AssertionError(f"{label}: {'/'.join(map(str, path))} in the wrong tier")
        return leaf

    map_with_path(on_card, eng.params)
    map_with_path(on_card, eng.caches)
    want_kv = torch.int8 if eng.kv_bits == 8 else torch.float32
    for layer in eng.caches["layers"]:
        if "attn" in layer and layer["attn"]["k"].dtype != want_kv:
            raise AssertionError(f"{label}: attention cache of {layer['attn']['k'].dtype}")
    steps, calls = stats["decode_steps"], stats["prefill_calls"]
    want = {name: 0 for name in counts}
    want[matmul_kernel] = matmuls_per_step(cfg) * (steps + calls)
    spec = ecfg.spec
    if spec is not None:  # a round is a verify step plus its draft steps
        dec = eng._spec
        n = min(spec.draft_layers or cfg.n_layers, cfg.n_layers)
        want[MODE_KERNEL[spec.draft_mode]] += (
            matmuls_per_layer(cfg) * n + 1) * dec.draft_steps
        if dec.rounds != steps or dec.rounds == dec.plain_rounds:
            raise AssertionError(f"{label}: {dec.rounds} rounds ({dec.plain_rounds} of one "
                                 f"token) in {steps} decode steps")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, want {want}")
    outputs = {r.uid: list(r.output) for r in done}
    prompts = {r.uid: list(r.prompt) for r in done}
    if plain is not None:
        bad = sorted(uid for uid in outputs if outputs[uid] != plain["outputs"][uid])
        if bad:
            raise AssertionError(f"{label}: requests {bad} differ from {plain['label']}'s tokens")
    kv = "int8" if eng.kv_bits == 8 else "float32"
    log(f"serve {label}: engine built in {t_construct:.2f} s; {len(done)} requests, "
        f"{stats['prefill_tokens']} prompt tokens over {calls} prefill calls, {steps} decode "
        f"steps, {stats['decoded_tokens']} decoded tokens, {kv} dense caches, wall {wall:.2f} s")
    log(f"serve {label} on {card}: prefill {stats['prefill_tok_per_s']:.1f} tok/s | decode "
        f"{stats['decode_tok_per_s']:.1f} tok/s | ttft p50 {stats['ttft_p50_s'] * 1e3:.1f} ms "
        f"p95 {stats['ttft_p95_s'] * 1e3:.1f} ms | itl p50 {stats['itl_p50_s'] * 1e3:.2f} ms "
        f"p95 {stats['itl_p95_s'] * 1e3:.2f} ms")
    if spec is None:
        log(f"serve {label}: {matmul_kernel} wrapper calls {counts[matmul_kernel]} = "
            f"{matmuls_per_step(cfg)} x ({steps} decode steps + {calls} prefill calls); "
            "others 0" + (f"; every request token for token {plain['label']}'s" if plain else ""))
    else:
        log(f"serve {label}: {spec}: {stats['spec_rounds']:.0f} rounds ({dec.plain_rounds} "
            f"of one token), {dec.draft_steps} draft steps; acceptance "
            f"{stats['spec_acceptance_rate']:.4f}, {stats['spec_tokens_per_target_step']:.4f} "
            f"tokens per target step; draft {stats['spec_draft_time_s']:.3f} s, verify "
            f"{stats['spec_verify_time_s']:.3f} s; launch counts "
            f"{ {k: v for k, v in counts.items() if v} } as reckoned"
            + (f"; every request token for token {plain['label']}'s" if plain else ""))
    return dict(label=label, stats=stats, wall_s=wall, launches=counts, n_layers=cfg.n_layers,
                construct_s=t_construct, outputs=outputs, prompts=prompts, kv=kv,
                spec=None if spec is None else dataclasses.asdict(spec),
                draft_steps=None if spec is None else dec.draft_steps)


def glm_unpaged_phases(cfg, qparams, seed, card, serve_cfg, serves):
    """Phase (d): glm4-9b on the unpaged engine (``paged=False``), the plain
    dequant phase's requests, monolithic and chunked (``prefill_budget=128,
    chunk_size=64``), each held against the paged plain dequant phase up to
    its near-ties (the prefill's key count and the decode attention's sums
    differ between the two caches)."""
    out = {}
    for label, extra in (("unpaged dequant", {}),
                         ("unpaged chunked dequant", dict(prefill_budget=128, chunk_size=64))):
        ph = unpaged_serve_phase(label, cfg, qparams, card,
                                 serve_cfg.replace(paged=False, **extra), "ocs_matmul",
                                 seeded_requests(cfg, seed))
        if extra:
            need = sum(-(-len(p) // 64) for p in ph["prompts"].values())
            if ph["stats"]["sched_chunks"] < need:
                raise AssertionError(f"{label}: {ph['stats']['sched_chunks']} chunks, the "
                                     f"prompts need {need}")
        else:
            if ph["stats"]["prefill_calls"] != 8:
                raise AssertionError(f"{label}: {ph['stats']['prefill_calls']} prefill calls")
        ph["partings"] = hold_near_ties(label, cfg, qparams, ph, serves["dequant"], "dequant")
        out[label] = ph
    return out


def ssm_model(arch, layers):
    """``arch`` (mamba2-1.3b or hymba-1.5b) at full width, ``layers`` deep
    (None: its published depth), the cut logged."""
    from repro_torch.configs import get_config

    base = get_config(arch)
    layers = base.n_layers if layers is None else layers
    cfg = dataclasses.replace(base, n_layers=layers)
    cut = "no cut" if layers == base.n_layers else f"cut: n_layers {layers} of {base.n_layers}"
    if cfg.hymba is not None and layers < base.n_layers:
        # The first layers of the full model: its global layers among them.
        glob = tuple(i for i in base.hymba.global_layers if i < layers)
        cfg = dataclasses.replace(cfg, hymba=dataclasses.replace(cfg.hymba, global_layers=glob))
        cut += f", global layers {glob} of {base.hymba.global_layers}"
    s = cfg.ssm
    extra = ""
    if cfg.hymba is not None:
        extra = (f", attention {cfg.n_heads}/{cfg.n_kv_heads} heads hd {cfg.hd}, d_ff "
                 f"{cfg.d_ff}, {cfg.hymba.n_meta_tokens} meta tokens, window "
                 f"{cfg.hymba.swa_window}, global layers {cfg.hymba.global_layers}")
    log(f"model: {arch} at full width (d_model {cfg.d_model}, {cfg.ssm_heads} SSM heads of "
        f"{s.head_dim}, d_state {s.d_state}, d_inner {cfg.d_inner}{extra}, vocab {cfg.vocab}"
        f"{', tied lm_head' if cfg.tie_embeddings else ''}), {layers} layers ({cut})")
    return cfg


def ssm_phases(args, card, gen):
    """(a) mamba2-1.3b quantized at 48 layers, served at its
    ``SSM_SERVE_LAYERS`` (a cut) in dequant, w8a8 and w4a8, and (b)
    hymba-1.5b quantized at 32 layers, served at its ``SSM_SERVE_LAYERS``
    (a cut) in dequant and w8a8 on int8 caches and, at ``--short-layers``
    (a cut), w4a8: each quantized leaf by leaf on the
    card, served on the unpaged engine, and served twice more at
    ``SSM_REPEAT_LAYERS`` (the repeat's depth cut), the second token for
    token the first; one decode step of each profiled. (c) B1, B4 and B6 at
    each of their linear shapes on the layer-0 and lm_head leaves, B5 on a
    one-layer clip-only tree's, against their plain versions."""
    import torch
    from repro_torch.serving import EngineConfig

    out = {"serves": {}, "first": {}, "profiles": {}, "kernels": {}, "quantize": {}}
    base = EngineConfig(max_batch=SSM_REQUESTS, max_len=SSM_MAX_LEN)
    iters = max(5, args.iters // 2)
    mamba, hymba = SSM_SERVE_LAYERS["mamba2-1.3b"], SSM_SERVE_LAYERS["hymba-1.5b"]
    for arch, modes in (("mamba2-1.3b", (("dequant", None, mamba), ("w8a8", None, mamba),
                                         ("w4a8", None, mamba))),
                        ("hymba-1.5b", (("dequant", None, hymba), ("w8a8", 8, hymba),
                                        ("w4a8", None, args.short_layers)))):
        cfg = ssm_model(arch, None)
        q, t_q, peak_q = moe_quantized(cfg, args.seed, 0.02)
        out["quantize"][arch] = dict(seconds=t_q, peak_gib=peak_q, layers=cfg.n_layers)
        kern = {"B1": kernel_phase_b1(q, cfg, gen, iters),
                "B4": kernel_phase_wo("B4", q, gen, iters),
                "B6": kernel_phase_b6(q, gen, iters)}
        qc, _, _ = moe_quantized(dataclasses.replace(cfg, n_layers=1), args.seed, 0.0)
        kern["B5"] = kernel_phase_wo("B5", qc, gen, iters)
        del qc
        out["kernels"][arch] = kern
        for mode, kv_bits, layers in modes:
            c, qm = cfg, q
            if layers is not None and layers < cfg.n_layers:
                c = ssm_model(arch, layers)
                qm = head_layers(q, layers)
            ecfg = base.replace(matmul_mode=mode, kv_bits=kv_bits)
            label = f"{arch} {mode}" + (" int8 caches" if kv_bits else "") + (
                f" ({c.n_layers} layers)" if c is not cfg else "")
            first = unpaged_serve_phase(label, c, qm, card, ecfg, MODE_KERNEL[mode],
                                        ssm_requests(c, args.seed))
            out["serves"][label] = first
            out["first"][f"{arch} {mode}"] = label
            # The repeat (a depth cut): at SSM_REPEAT_LAYERS, served twice
            # there, the second token for token the first (a phase already
            # that short repeats itself).
            rc, rq, rlabel, rfirst = c, qm, label, first
            if c.n_layers > SSM_REPEAT_LAYERS:
                rc, rq = ssm_model(arch, SSM_REPEAT_LAYERS), head_layers(q, SSM_REPEAT_LAYERS)
                rlabel = f"{arch} {mode}" + (" int8 caches" if kv_bits else "") + (
                    f" ({rc.n_layers} layers)")
                rfirst = unpaged_serve_phase(rlabel, rc, rq, card, ecfg, MODE_KERNEL[mode],
                                             ssm_requests(rc, args.seed))
                out["serves"][rlabel] = rfirst
            out["serves"][rlabel + ", again"] = unpaged_serve_phase(
                rlabel + ", again", rc, rq, card, ecfg, MODE_KERNEL[mode],
                ssm_requests(rc, args.seed), plain=rfirst)
            out["profiles"][label] = moe_step_profile(
                label, c, qm, ecfg, args.seed, reqs=ssm_requests(c, args.seed, prompt_len=4))
        del q
        torch.cuda.empty_cache()
    return out


def ssm_smoke_logits(qp, cfg, seed, dev, mode):
    """40 teacher-forced decode steps of 2 lanes from fresh dense caches
    (past hymba's smoke window of 32): logits [40, 2, V] f32."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T

    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (40, 2))
    caches = T.init_cache(cfg, 2, 64, device=dev)
    out = []
    with torch.no_grad():
        for row in toks:
            lg, caches = T.decode_step(qp, torch.as_tensor(row[:, None], device=dev), caches,
                                       cfg, mode=mode)
            out.append(lg.float().cpu())
    return torch.stack(out)


def ssm_reference_check(seed):
    """The smoke mamba2-1.3b and hymba-1.5b, card kernels vs CPU plain
    versions from the same tree (quantized on the CPU, the SSM in_proj
    stored padded), in each matmul mode (hymba's w8a8 on int8 caches):
    logits within ``SSM_CARD_RTOL`` of the mode of the largest."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import map_with_path, quantize_params, tree_to
    from repro_torch.core.ocs import OCSQuantLinear, to_w4a8
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    out = {}
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        base = smoke_config(arch)
        q = quantize_params(T.init_params(base, seed=seed, device="cpu"),
                            QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02,
                                        per_channel=True, pad_to=1), device="cpu")
        for mode in ("dequant", "w8a8", "w4a8"):
            kv_bits = 8 if (mode == "w8a8" and arch == "hymba-1.5b") else None
            cfg = dataclasses.replace(base, kv_bits=kv_bits)
            qp = q if mode != "w4a8" else map_with_path(
                lambda _p, leaf: to_w4a8(leaf, W4A8_RATIO)
                if isinstance(leaf, OCSQuantLinear) else leaf, q)
            cpu = ssm_smoke_logits(qp, cfg, seed, "cpu", mode)
            card = ssm_smoke_logits(tree_to(qp, torch.device("cuda")), cfg, seed, "cuda", mode)
            scale = cpu.abs().max().item()
            err = (card - cpu).abs().max().item()
            label = f"{arch} {mode}" + (" int8 caches" if kv_bits else "")
            rtol = SSM_CARD_RTOL[mode]
            if not torch.isfinite(card).all() or err > rtol * scale:
                raise AssertionError(f"reference check ({label}): max |d logits| {err} > "
                                     f"{rtol} x {scale}")
            agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
            log(f"reference check ({label}; smoke size, 40 teacher-forced decode steps of 2 "
                f"lanes, card kernels vs CPU plain): max |d logits| {err:.6g} of max |logit| "
                f"{scale:.6g} ({err / scale:.3g}; limit {rtol}); argmax agreement "
                f"{agree:.4f}")
            out[label] = dict(max_abs_err=err, logit_scale=scale, argmax_agreement=agree)
    return out


# ---------------------------------------------------------------------------
# Speculation on the unpaged engine, and the last configs: qwen2-vl-7b
# (M-RoPE) and minitron-8b served at full width, hubert-xlarge (the
# encoder: LayerNorm, GELU, unmasked attention) through forward.

# hubert-xlarge's forward: HUBERT_BATCH clips of HUBERT_FRAMES frames each
# (20 s of audio at its 50 Hz frame rate): every GEMM at M = 4000.
HUBERT_BATCH = 4
HUBERT_FRAMES = 1000
# Card (kernels) vs CPU (plain versions) logits of forward on the smoke
# hubert-xlarge, qwen2-vl-7b and hymba-1.5b, relative to the largest logit,
# by matmul mode: MODEL_RTOL's allowance of about one bf16 ulp of the
# largest logit in every mode (the full-sequence attention, LayerNorm and
# GELU are torch ops on either side; their float32 sums may part in order).
# tests/test_torch_cuda.py reads the same constant.
FORWARD_CARD_RTOL = {"dequant": 0.01, "w8a8": 0.01, "w4a8": 0.01}


def dense_model(arch, layers=None):
    """A dense or encoder ``arch`` at full width, ``layers`` deep (None: its
    published depth), the cut logged."""
    from repro_torch.configs import get_config

    base = get_config(arch)
    layers = base.n_layers if layers is None else layers
    cfg = dataclasses.replace(base, n_layers=layers)
    cut = "no cut" if layers == base.n_layers else f"cut: n_layers {layers} of {base.n_layers}"
    extra = (f", M-RoPE sections {cfg.mrope_sections}" if cfg.mrope_sections else "") + (
        ", encoder (unmasked attention), LayerNorm, GELU" if not cfg.causal else "")
    log(f"model: {arch} at full width (d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}{extra}), "
        f"{layers} layers ({cut})")
    return cfg


def unpaged_spec_dequant_phase(cfg, qparams, seed, card, serve_cfg, plain):
    """Spec dequant on the unpaged engine (float32 dense caches; the default
    drafter: w8a8, k <= 4) at ``cfg``'s depth, token for token ``plain``,
    the unpaged dequant phase."""
    from repro_torch.serving.spec_decode import SpecConfig

    return unpaged_serve_phase(
        "unpaged spec dequant", cfg, qparams, card,
        serve_cfg.replace(paged=False, spec=SpecConfig()), "ocs_matmul",
        seeded_requests(cfg, seed), plain=plain)


def unpaged_spec_w8a8_phases(cfg, qparams, seed, card, serve_cfg):
    """A plain w8a8 phase on int8 dense caches at ``cfg``'s depth, then spec
    w8a8 on them drafting with all layers but the last (an early exit of
    random weights accepts little earlier), token for token it."""
    from repro_torch.serving.spec_decode import SpecConfig

    L = cfg.n_layers
    ecfg = serve_cfg.replace(paged=False, matmul_mode="w8a8", kv_bits=8)
    plain = unpaged_serve_phase(f"unpaged w8a8 int8 caches ({L} layers)", cfg, qparams, card,
                                ecfg, "fused_qmatmul", seeded_requests(cfg, seed))
    spec = unpaged_serve_phase(
        f"unpaged spec w8a8 int8 caches ({L} layers)", cfg, qparams, card,
        ecfg.replace(spec=SpecConfig(draft_layers=max(1, L - 1))), "fused_qmatmul",
        seeded_requests(cfg, seed), plain=plain)
    return {"unpaged w8a8 short": plain, "unpaged spec w8a8 short": spec}


def forward_first_tokens(label, cfg, qparams, plain, mode):
    """``forward`` over the plain serve phase's 8 prompts in one call
    (zero-padded to the longest: M = 8 x its length a GEMM): finite logits,
    the mode's kernel ``matmuls_per_step`` times and no other kernel; at
    each prompt's last position the argmax is the request's first token, or
    the forward's own top-2 margin there is below ``TIE_MARGIN`` (the
    paged prefill sums its keys in other chunks)."""
    import torch
    from repro_torch.models import transformer as T

    prompts = plain["prompts"]
    uids = sorted(prompts)
    n = max(len(p) for p in prompts.values())
    toks = torch.zeros((len(uids), n), dtype=torch.int64, device="cuda")
    for i, uid in enumerate(uids):
        toks[i, :len(prompts[uid])] = torch.as_tensor(prompts[uid], device="cuda")
    mods = counters()
    for mod, _ in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = T.forward(qparams, toks, cfg, mode=mode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: getattr(mod, attr) for name, (mod, attr) in mods.items()}
    want = {name: 0 for name in counts}
    want[MODE_KERNEL[mode]] = matmuls_per_step(cfg)
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, want {want}")
    if logits.shape != (len(uids), n, cfg.vocab) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"{label}: logits {tuple(logits.shape)}, or nonfinite")
    partings = []
    for i, uid in enumerate(uids):
        last = logits[i, len(prompts[uid]) - 1].float()
        top = torch.topk(last, 2)
        first = plain["outputs"][uid][0]
        if int(top.indices[0]) != first:
            margin = float(top.values[0] - top.values[1])
            partings.append(dict(uid=uid, margin=margin))
            log(f"{label}: request {uid}'s first token {first}, forward's argmax "
                f"{int(top.indices[0])}, its top-2 margin {margin:.4f} (bound {TIE_MARGIN})")
            if not margin < TIE_MARGIN:
                raise AssertionError(f"{label}: request {uid}'s first token is no near-tie "
                                     "of forward's last logits")
    log(f"{label}: forward over {len(uids)} prompts x {n} positions (M = {len(uids) * n}) "
        f"in {mode}, wall {wall:.2f} s; {MODE_KERNEL[mode]} {counts[MODE_KERNEL[mode]]} "
        f"launches = {matmuls_per_step(cfg)}; last-position argmax the first served token "
        f"for {len(uids) - len(partings)} of {len(uids)}, the rest near-ties")
    return dict(wall_s=wall, launches=counts, rows=len(uids) * n, partings=partings)


def slice_kernels(label, q, cfg, gen, iters, seed, m_rows=(1, 8, 256)):
    """B1, B4 and B6 at each linear shape of the tree (its layer-0 and
    lm_head leaves) and B5 on a one-layer clip-only tree's, at M in
    ``m_rows`` (B4 and B5 also 64), against their plain versions to the
    bounds of the glm4-9b kernel phase."""
    wo_ms = tuple(sorted(set(m_rows) | {64}))
    kern = {"B1": kernel_phase_b1(q, cfg, gen, iters, m_rows=m_rows),
            "B4": kernel_phase_wo("B4", q, gen, iters, m_rows=wo_ms),
            "B6": kernel_phase_b6(q, gen, iters, m_rows=m_rows)}
    qc, _, _ = moe_quantized(dataclasses.replace(cfg, n_layers=1), seed, 0.0)
    kern["B5"] = kernel_phase_wo("B5", qc, gen, iters, m_rows=wo_ms)
    del qc
    log(f"kernel checks at the {label} shapes: B1, B4, B5, B6 held at M in {wo_ms}")
    return kern


def slice_b2(arch, cfg, gen):
    """B2 at ``cfg``'s heads on the three pool kinds: Q = 1 against its
    plain version (:func:`b2_checked`) and Q = 5 against its plain version
    and bitwise the sequential launches (:func:`b2v_check`)."""
    rows = []
    for kind in ("float32", "int8", "int4"):
        pool, table, pos, qq, kn, vn = b2_case(gen, kind, H=cfg.n_heads, KV=cfg.n_kv_heads,
                                               poison=True)
        _, _, err = b2_checked(f"paged_attention {kind} ({arch} heads)", pool, table, pos, qq,
                               kn, vn)
        err_v, _ = b2v_check(gen, kind, 5, H=cfg.n_heads, KV=cfg.n_kv_heads)
        rows.append(dict(arch=arch, pool=kind, H=cfg.n_heads, KV=cfg.n_kv_heads, Q1_err=err,
                         Q5_err=err_v))
        log(f"paged_attention at {arch}'s {cfg.n_heads}/{cfg.n_kv_heads} heads (rep "
            f"{cfg.n_heads // cfg.n_kv_heads}), {kind} pool: Q=1 max |d| {err:.3g}, Q=5 "
            f"max |d| {err_v:.3g} and its rows bitwise the sequential launches")
    return rows


def slice_phases(args, card, serve_cfg, gen):
    """qwen2-vl-7b (28 layers; M-RoPE) and minitron-8b (32 layers) at their
    published widths and depths, quantized leaf by leaf on the card, with
    B1, B4, B5 and B6 held at each of their linear shapes and B2 at each
    model's heads (qwen2-vl's 28/4, rep 7; minitron's 32/8, rep 4) on the
    three pool kinds, Q = 1 and 5 (:func:`slice_b2`); served on the paged
    engine: qwen2-vl in dequant, w8a8 (int8 pages), w4a8 (int4 pages) at
    --short-layers (a cut) and spec dequant token for token its plain
    phase, then ``forward`` over the 8 prompts; minitron in dequant.
    hubert-xlarge at 48 layers: B1, B4, B5, B6 at its shapes (M = 4000
    too), and ``forward`` and ``loss_fn`` on seeded frame embeddings
    ``[HUBERT_BATCH, HUBERT_FRAMES, 1280]`` and labels in dequant, w8a8 and
    w4a8: finite logits of ``[B, T, 504]`` (the lm_head stored padded to
    512), the mode's kernel ``6 * 48 + 1`` times a call and nothing else."""
    import torch
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear, to_w4a8
    from repro_torch.models import transformer as T
    from repro_torch.serving.spec_decode import SpecConfig

    out = {"serves": {}, "kernels": {}, "quantize": {}, "forward": {}, "b2": []}
    iters = max(5, args.iters // 2)

    # qwen2-vl-7b: M-RoPE (text tokens: one position in all three streams).
    arch = "qwen2-vl-7b"
    cfg = dense_model(arch)
    q, t_q, peak = moe_quantized(cfg, args.seed, 0.02)
    out["quantize"][arch] = dict(seconds=t_q, peak_gib=peak, layers=cfg.n_layers)
    out["kernels"][arch] = slice_kernels(arch, q, cfg, gen, iters, args.seed)
    out["b2"] += slice_b2(arch, cfg, gen)
    sv = out["serves"]
    sv[f"{arch} dequant"] = serve_phase(f"{arch} dequant", cfg, q, args.seed, card, serve_cfg,
                                        "ocs_matmul")
    sv[f"{arch} w8a8"] = serve_phase(f"{arch} w8a8", cfg, q, args.seed, card,
                                     serve_cfg.replace(matmul_mode="w8a8", kv_bits=8),
                                     "fused_qmatmul")
    short = min(args.short_layers, cfg.n_layers)
    c_short = dense_model(arch, short)
    sv[f"{arch} w4a8"] = serve_phase(f"{arch} w4a8 ({short} layers)", c_short,
                                     head_layers(q, short), args.seed, card,
                                     serve_cfg.replace(matmul_mode="w4a8", kv_bits=4),
                                     "w4a8_qmatmul")
    sv[f"{arch} spec dequant"] = serve_phase(f"{arch} spec dequant", cfg, q, args.seed, card,
                                             serve_cfg.replace(spec=SpecConfig()),
                                             "ocs_matmul", plain=sv[f"{arch} dequant"])
    out["forward"][arch] = forward_first_tokens(f"forward {arch}", cfg, q,
                                                sv[f"{arch} dequant"], "dequant")
    del q
    torch.cuda.empty_cache()

    # minitron-8b: the widest lm_head served (N = 256000).
    arch = "minitron-8b"
    cfg = dense_model(arch)
    q, t_q, peak = moe_quantized(cfg, args.seed, 0.02)
    out["quantize"][arch] = dict(seconds=t_q, peak_gib=peak, layers=cfg.n_layers)
    out["kernels"][arch] = slice_kernels(arch, q, cfg, gen, iters, args.seed)
    out["b2"] += slice_b2(arch, cfg, gen)
    sv[f"{arch} dequant"] = serve_phase(f"{arch} dequant", cfg, q, args.seed, card, serve_cfg,
                                        "ocs_matmul")
    del q
    torch.cuda.empty_cache()

    # hubert-xlarge: the encoder, through forward and loss_fn only.
    arch = "hubert-xlarge"
    cfg = dense_model(arch)
    q, t_q, peak = moe_quantized(cfg, args.seed, 0.02)
    out["quantize"][arch] = dict(seconds=t_q, peak_gib=peak, layers=cfg.n_layers)
    rows = HUBERT_BATCH * HUBERT_FRAMES
    out["kernels"][arch] = slice_kernels(arch, q, cfg, gen, iters, args.seed,
                                         m_rows=(1, 8, 256, rows))
    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    embeds = torch.randn((HUBERT_BATCH, HUBERT_FRAMES, cfg.d_model), generator=g,
                         device="cuda")
    labels = torch.randint(0, cfg.vocab, (HUBERT_BATCH, HUBERT_FRAMES), generator=g,
                           device="cuda")
    mods = counters()
    argmax = {}
    for mode in ("dequant", "w8a8", "w4a8"):
        params = q if mode != "w4a8" else map_with_path(
            lambda _p, leaf: to_w4a8(leaf, W4A8_RATIO) if isinstance(leaf, OCSQuantLinear)
            else leaf, q)
        for mod, _ in mods.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = T.forward(params, None, cfg, mode=mode, embeds=embeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: getattr(mod, attr) for name, (mod, attr) in mods.items()}
        with torch.no_grad():
            loss = float(T.loss_fn(params, {"embeds": embeds, "labels": labels}, cfg,
                                   mode=mode))
        want = {name: 0 for name in counts}
        want[MODE_KERNEL[mode]] = matmuls_per_step(cfg)
        if counts != want:
            raise AssertionError(f"hubert-xlarge forward {mode}: launch counts {counts}, "
                                 f"want {want}")
        if (logits.shape != (HUBERT_BATCH, HUBERT_FRAMES, cfg.vocab)
                or not torch.isfinite(logits.float()).all() or not math.isfinite(loss)):
            raise AssertionError(f"hubert-xlarge forward {mode}: logits "
                                 f"{tuple(logits.shape)}, loss {loss}, or nonfinite")
        argmax[mode] = logits.argmax(-1)
        agree = float((argmax[mode] == argmax["dequant"]).float().mean())
        out["forward"][f"{arch} {mode}"] = dict(wall_s=wall, launches=counts, loss=loss,
                                                rows=rows, frames_per_s=rows / wall,
                                                argmax_agreement_dequant=agree)
        log(f"forward {arch} {mode} ({cfg.n_layers} layers, embeds [{HUBERT_BATCH}, "
            f"{HUBERT_FRAMES}, {cfg.d_model}], M = {rows} a GEMM): wall {wall:.3f} s "
            f"({rows / wall:.0f} frames/s), logits [{HUBERT_BATCH}, {HUBERT_FRAMES}, "
            f"{cfg.vocab}] finite, loss_fn {loss:.4f} on seeded labels (ln {cfg.vocab} = "
            f"{math.log(cfg.vocab):.4f}); {MODE_KERNEL[mode]} {counts[MODE_KERNEL[mode]]} "
            f"launches = 6 x {cfg.n_layers} + lm_head, others 0; argmax agreement with "
            f"dequant {agree:.4f}")
        del params, logits
    del q, embeds
    torch.cuda.empty_cache()
    return out


def forward_smoke_logits(qp, cfg, seed, dev, mode):
    """``forward`` of 2 seeded sequences of 40 (tokens, or frame embeddings
    for the audio frontend): logits [2, 40, V] f32."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(seed)
    tokens = embeds = None
    if cfg.frontend == "audio":
        embeds = torch.as_tensor(rng.normal(size=(2, 40, cfg.d_model)), dtype=torch.float32,
                                 device=dev)
    else:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)), device=dev)
    with torch.no_grad():
        return T.forward(qp, tokens, cfg, mode=mode, embeds=embeds).float().cpu()


def forward_reference_check(seed):
    """``forward`` of the smoke hubert-xlarge, qwen2-vl-7b and hymba-1.5b,
    card kernels vs CPU plain versions from one tree (quantized on the
    CPU), in each matmul mode: logits within ``FORWARD_CARD_RTOL`` of the
    mode of the largest."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import map_with_path, quantize_params, tree_to
    from repro_torch.core.ocs import OCSQuantLinear, to_w4a8
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    out = {}
    for arch in ("hubert-xlarge", "qwen2-vl-7b", "hymba-1.5b"):
        cfg = smoke_config(arch)
        q = quantize_params(T.init_params(cfg, seed=seed, device="cpu"),
                            QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02,
                                        per_channel=True, pad_to=1), device="cpu")
        for mode in ("dequant", "w8a8", "w4a8"):
            qp = q if mode != "w4a8" else map_with_path(
                lambda _p, leaf: to_w4a8(leaf, W4A8_RATIO)
                if isinstance(leaf, OCSQuantLinear) else leaf, q)
            cpu = forward_smoke_logits(qp, cfg, seed, "cpu", mode)
            card = forward_smoke_logits(tree_to(qp, torch.device("cuda")), cfg, seed, "cuda",
                                        mode)
            scale = cpu.abs().max().item()
            err = (card - cpu).abs().max().item()
            rtol = FORWARD_CARD_RTOL[mode]
            label = f"forward {arch} {mode}"
            if not torch.isfinite(card).all() or err > rtol * scale:
                raise AssertionError(f"reference check ({label}): max |d logits| {err} > "
                                     f"{rtol} x {scale}")
            agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
            log(f"reference check ({label}; smoke size, 2 x 40 positions, card kernels vs "
                f"CPU plain): max |d logits| {err:.6g} of max |logit| {scale:.6g} "
                f"({err / scale:.3g}; limit {rtol}); argmax agreement {agree:.4f}")
            out[label] = dict(max_abs_err=err, logit_scale=scale, argmax_agreement=agree)
    return out


# ---------------------------------------------------------------------------
# Phase (n): the paper's weight-PTQ experiments (``repro_torch.experiments``)
# and the precision-tier gate (``launch/quality_eval.py``) on the card: the
# three subjects trained from their seeded init, the tables' quick arms, the
# fake-quantized leaves held bitwise against the CPU's, the gate on the
# trained bench LM through B1, B4 and B6 (held at its shapes), and glm4-9b's
# layer-0 and lm_head leaves quantized with ACIQ and KL clipping.

# Training must have worked: the convnet at least twice chance (16
# classes), the LMs' held-out perplexity below half their vocabulary (512).
EXP_MIN_ACC = 2 * 100.0 / 16
EXP_MAX_PPL = 256.0
# The trained subjects' float forward, card against CPU on the same
# weights, of the largest logit: the float32 convnet and LSTM (cuDNN and
# cuBLAS sums against the CPU's), and the bench LM's bfloat16 activations
# (tests/test_torch_forward.py's FLOAT_RTOL).
EXP_F32_RTOL = 1e-3
EXP_LM_RTOL = 0.02
# The gate's GEMMs: one call per linear layer of a [16, 64] batch.
EXP_M = 16 * 64
# The gate's w4a8_ocs outlier fraction (tools/quality_eval.py's default).
EXP_OUTLIER_RATIO = 0.1


def _flat_leaves(tree):
    from repro_torch.core.apply import map_with_path

    out = []
    map_with_path(lambda p, leaf: out.append(("/".join(map(str, p)), leaf)), tree)
    return out


def fake_quant_holds(trained, cpu):
    """Fake-quantized leaves built on the card bitwise the same leaves built
    on the CPU: the bench LM once per clip method (none, mse, aciq, kl) and
    once with knapsack allocation, the convnet (KL) and the LSTM (ACIQ,
    per-channel)."""
    import torch
    from repro_torch.core.apply import fake_quantize_params
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.experiments import common

    cases = [("lm", QuantRecipe(w_bits=4, w_clip=c, ocs_ratio=0.02))
             for c in (None, "mse", "aciq", "kl")]
    cases += [("lm", QuantRecipe(w_bits=3, w_clip="mse", ocs_ratio=0.02, alloc="knapsack")),
              ("convnet", QuantRecipe(w_bits=4, w_clip="kl", ocs_ratio=0.05)),
              ("lstm", QuantRecipe(w_bits=4, w_clip="aciq", ocs_ratio=0.05, per_channel=True))]
    out = []
    for subj, rec in cases:
        fq = common.fake_quant_convnet if subj == "convnet" else fake_quantize_params
        t0 = time.perf_counter()
        got = fq(trained[subj], rec)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fq(cpu[subj], rec)
        t_cpu = time.perf_counter() - t0
        n = 0
        for (path, g), (_, w) in zip(_flat_leaves(got), _flat_leaves(want)):
            if not same_bits(g.cpu(), w):
                raise AssertionError(f"fake_quantize {subj} {rec}: leaf {path} differs "
                                     "between the card and the CPU")
            n += 1
        what = (f"w{rec.w_bits} clip={rec.w_clip} r={rec.ocs_ratio} alloc={rec.alloc}"
                + (" per-channel" if rec.per_channel else ""))
        out.append(dict(subject=subj, recipe=what, leaves=n, card_s=t_card, cpu_s=t_cpu))
        log(f"experiments: fake-quantized {subj} ({what}) on the card bitwise the CPU's, "
            f"{n} leaves ({t_card:.2f} s card, {t_cpu:.2f} s CPU)")
    return out


def gate_phase(lm, gen, iters):
    """The precision-tier gate on the trained bench LM: each tier's logits
    on the eval and stress batches with the launches of every kernel
    counted per tier (B1 in int8, B6 in the w4a8 tiers, B4 in int8_dequant;
    7 x L + 1 calls a forward), the gate's metrics and verdict printed, its
    floors held (the OCS-beats-naive criteria printed, not held: they were
    calibrated on the reference's trained LM), each tier's logits on one
    eval batch held against the CPU's (``FORWARD_CARD_RTOL`` of the mode),
    then B1, B4 and B6 at the bench LM's shapes (M = 1024)."""
    import torch
    from repro_torch.core.apply import tree_to
    from repro_torch.experiments import common
    from repro_torch.launch import quality_eval as Q

    cfg = common.LM_CFG
    t0 = time.perf_counter()
    batches = Q.eval_batches(8, "cuda")
    stress = Q.stress_batches(8, cfg.vocab, device="cuda")
    trees = Q.tier_trees(lm, EXP_OUTLIER_RATIO)
    cnt = counters()
    logits, slogits, launches = {}, {}, {}
    for name, (p, mode) in trees.items():
        for mod, attr in cnt.values():
            setattr(mod, attr, 0)
        logits[name] = Q.tier_logits(p, cfg, batches, mode)
        slogits[name] = Q.tier_logits(p, cfg, stress, mode)
        torch.cuda.synchronize()
        launches[name] = {k: getattr(mod, attr) for k, (mod, attr) in cnt.items()
                          if getattr(mod, attr)}
    tiers = Q.tier_metrics(logits, slogits, batches)
    wall = time.perf_counter() - t0
    per_tier = (7 * cfg.n_layers + 1) * (len(batches) + len(stress))
    want = {"float": {}, "int8": {"fused_qmatmul": per_tier},
            "w4a8_ocs": {"w4a8_qmatmul": per_tier}, "w4a8_naive": {"w4a8_qmatmul": per_tier},
            "int8_dequant": {"ocs_matmul": per_tier}}
    if launches != want:
        raise AssertionError(f"quality gate: launches per tier {launches}, want {want}")
    for line in Q.format_tiers(tiers).splitlines():
        log(f"quality gate: {line}")
    violations = Q.gate(tiers)
    log(f"quality gate (the reference's gate, unchanged): "
        f"{'PASS' if not violations else 'FAIL'}" + "".join(f"; {v}" for v in violations))
    low = [f"{n} {tiers[n]['top1_vs_float']:.4f} < {f}" for n, f in Q.FLOORS.items()
           if tiers[n]["top1_vs_float"] < f]
    if low:
        raise AssertionError(f"quality gate: tiers below their floors: {low}")
    ocs, naive = tiers["w4a8_ocs"], tiers["w4a8_naive"]
    log(f"quality gate: floors held ({Q.FLOORS}); OCS vs naive (printed, not held): stress "
        f"top-1 {ocs['top1_stress_vs_float']:.4f} vs {naive['top1_stress_vs_float']:.4f}, "
        f"logit MSE {ocs['logit_mse_vs_float']:.4g} vs {naive['logit_mse_vs_float']:.4g}, "
        f"stress logit MSE {ocs['logit_mse_stress_vs_float']:.4g} vs "
        f"{naive['logit_mse_stress_vs_float']:.4g}; launches per tier {launches}; "
        f"{wall:.1f} s")
    card_cpu = {}
    for name, (p, mode) in trees.items():
        with torch.no_grad():
            got = torch.from_numpy(logits[name][0])
            want_l = Q.tier_logits(tree_to(p, "cpu"), cfg,
                                   [{k: v.cpu() for k, v in batches[0].items()}], mode)[0]
        rel = (got - want_l).abs().max().item() / max(abs(want_l).max(), 1e-30)
        tol = EXP_LM_RTOL if name == "float" else FORWARD_CARD_RTOL[mode]
        card_cpu[name] = rel
        if not rel <= tol:
            raise AssertionError(f"quality gate {name}: card logits {rel:.3g} of the largest "
                                 f"from the CPU's (limit {tol})")
    log(f"quality gate: each tier's logits on eval batch 0, card vs CPU, of the largest "
        f"logit: {', '.join(f'{k} {v:.3g}' for k, v in card_cpu.items())}")
    q = trees["int8"][0]
    kern = {"B1": kernel_phase_b1(q, cfg, gen, iters, m_rows=(EXP_M,)),
            "B4": kernel_phase_wo("B4", q, gen, iters, m_rows=(EXP_M,)),
            "B6": kernel_phase_b6(q, gen, iters, m_rows=(EXP_M,), ratio=EXP_OUTLIER_RATIO),
            "B6 naive": kernel_phase_b6(q, gen, iters, m_rows=(EXP_M,), ratio=0.0)}
    log(f"kernel checks at the bench LM's shapes (K + S in 131, 262; M = {EXP_M}): B1 and B6 "
        f"bitwise (outlier rows {sorted({r['T'] for r in kern['B6']})} and 0), B4 within "
        "WO_TOL_FACTOR's bound")
    return dict(tiers=tiers, violations=violations, launches=launches, seconds=wall,
                card_vs_cpu=card_cpu, kernels=kern)


def glm_clip_phase(seed):
    """glm4-9b's layer-0 and lm_head leaves at full width, quantized on the
    card with ACIQ and with KL clipping (w8, OCS r=0.02, per-tensor: the
    threshold is the grid's range); the lm_head's split table, int grid
    and scale bitwise the same quantization on the CPU. (Layer 0's leaves
    are held card vs CPU by ``tests/test_torch_cuda.py::
    test_glm4_9b_layer0_aciq_kl_card_vs_cpu_cuda``, which keeps their CPU
    side out of the script's time.)"""
    import torch
    from repro_torch.core.apply import quantize_params
    from repro_torch.core.ocs import OCSQuantLinear
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    cfg = dense_model("glm4-9b", 1)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    sub = {"layers": params["layers"], "lm_head": params["lm_head"]}
    del params
    head_cpu = {"lm_head": sub["lm_head"].cpu()}
    out = {}
    for method in ("aciq", "kl"):
        recipe = QuantRecipe(w_bits=8, w_clip=method, ocs_ratio=0.02, per_channel=False)
        t0 = time.perf_counter()
        qc = quantize_params(sub, recipe, device="cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        qh = quantize_params(head_cpu, recipe, device="cpu")["lm_head"]
        t_cpu = time.perf_counter() - t0
        a = qc["lm_head"]
        for what, x, y in (("values", a.weight.values, qh.weight.values),
                           ("scale", a.weight.scale, qh.weight.scale),
                           ("src", a.spec.src, qh.spec.src)):
            if x.shape != y.shape or not same_bits(x.cpu(), y):
                raise AssertionError(f"glm4-9b {method}: lm_head {what} differs between the "
                                     "card and the CPU")
        out[method] = dict(card_s=t_card, cpu_s=t_cpu, held="lm_head",
                           leaves=[p for p, leaf in _flat_leaves(qc)
                                   if isinstance(leaf, OCSQuantLinear)])
        log(f"glm4-9b layer 0 + lm_head, w8 {method} clip, ocs r=0.02, per-tensor: quantized "
            f"on the card in {t_card:.2f} s; the lm_head's split table, int grid and scale "
            f"bitwise the CPU's (CPU {t_cpu:.2f} s)")
        del qc, qh
    del sub, head_cpu
    torch.cuda.empty_cache()
    return out


def experiments_phase(args, gen):
    """Phase (n). Trains the convnet, LSTM and bench LM 400 steps each on
    the card (fresh every run: no cache), holds that training worked and
    each subject's float forward card vs CPU, runs the quick arms of
    Tables 1, 2, 5, 6 and 7 on the trained trees, holds fake-quantized
    leaves card vs CPU (:func:`fake_quant_holds`), runs the gate
    (:func:`gate_phase`) and glm4-9b's ACIQ/KL quantization
    (:func:`glm_clip_phase`)."""
    import torch
    from repro_torch.core.apply import tree_to
    from repro_torch.experiments import common, table1, table2, table5, table6, table7
    from repro_torch.models import transformer as T
    from repro_torch.models.convnet import convnet_forward, make_synthetic_images
    from repro_torch.models.lstm import lstm_forward

    t_phase = time.perf_counter()
    common.float32_deterministic()  # the convnet's training repeats run to run
    bench = common.Bench("cuda", cache=False, out_dir=Path(args.out) / "experiments", log=log)
    train = {}
    for name in ("convnet", "lstm", "lm"):
        bench.params(name)
        sec, hist = bench.train_seconds[name], bench.histories[name]
        train[name] = dict(seconds=sec, steps=common.STEPS, steps_per_s=common.STEPS / sec,
                           history=hist)
        log(f"experiments: trained {name} {common.STEPS} steps on the card in {sec:.1f} s "
            f"({common.STEPS / sec:.1f} steps/s); loss at steps " + ", ".join(
                f"{h['step']}: {h['loss']:.3f}" for h in hist))
    trained = {n: bench.params(n) for n in ("convnet", "lstm", "lm")}
    held = {"convnet_acc": bench.convnet_accuracy(trained["convnet"]),
            "lstm_ppl": bench.lstm_ppl(trained["lstm"]), "lm_ppl": bench.lm_ppl(trained["lm"])}
    log(f"experiments: trained float quality: convnet {held['convnet_acc']:.2f}% (>= "
        f"{EXP_MIN_ACC}), LSTM ppl {held['lstm_ppl']:.2f}, bench LM ppl "
        f"{held['lm_ppl']:.2f} (< {EXP_MAX_PPL})")
    if not (held["convnet_acc"] >= EXP_MIN_ACC and held["lstm_ppl"] < EXP_MAX_PPL
            and held["lm_ppl"] < EXP_MAX_PPL):
        raise AssertionError(f"experiments: training did not work: {held}")

    cpu = {n: tree_to(p, "cpu") for n, p in trained.items()}
    images = torch.from_numpy(
        make_synthetic_images(256, common.CONV_CFG, seed=777)["images"]).cuda()
    lstm_t = torch.from_numpy(common.LSTM_DS.batch_at(common.PPL_START)["tokens"]).cuda()
    lm_t = torch.from_numpy(common.LM_DS.batch_at(common.PPL_START)["tokens"]).cuda()
    fwd = {"convnet": (lambda p, x: convnet_forward(p, x, common.CONV_CFG), images,
                       EXP_F32_RTOL),
           "lstm": (lambda p, x: lstm_forward(p, x, common.LSTM_CFG), lstm_t, EXP_F32_RTOL),
           "lm": (lambda p, x: T.forward(p, x, common.LM_CFG), lm_t, EXP_LM_RTOL)}
    card_cpu = {}
    for name, (f, x, tol) in fwd.items():
        with torch.no_grad():
            got = f(trained[name], x).float().cpu()
            want = f(cpu[name], x.cpu()).float()
        rel = (got - want).abs().max().item() / want.abs().max().item()
        card_cpu[name] = rel
        if not rel <= tol:
            raise AssertionError(f"experiments: {name} float forward card vs CPU {rel:.3g} of "
                                 f"the largest logit (limit {tol})")
    log(f"experiments: float forward card vs CPU on the trained weights, of the largest "
        f"logit: {', '.join(f'{k} {v:.3g}' for k, v in card_cpu.items())} (limits "
        f"{EXP_F32_RTOL}, {EXP_F32_RTOL}, {EXP_LM_RTOL})")

    tables, table_s = {}, {}
    for name, mod in (("table1", table1), ("table2", table2), ("table5", table5),
                      ("table6", table6), ("table7", table7)):
        t0 = time.perf_counter()
        tables[name] = mod.run(quick=True, bench=bench)
        table_s[name] = time.perf_counter() - t0
        log(f"experiments: {name} (quick) on the card in {table_s[name]:.1f} s")
    holds = fake_quant_holds(trained, cpu)
    gate = gate_phase(trained["lm"], gen, max(5, args.iters // 2))
    glm = glm_clip_phase(args.seed)
    wall = time.perf_counter() - t_phase
    log(f"experiments phase: {wall:.1f} s")
    return dict(train=train, held=held, forward_card_vs_cpu=card_cpu, tables=tables,
                table_seconds=table_s, fake_quant_holds=holds, gate=gate, glm_clip=glm,
                seconds=wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="glm4-9b depth (40 = the published depth, no cut)")
    ap.add_argument("--short-layers", type=int, default=10,
                    help="depth of the clip-only trees (glm4-9b's and deepseek-moe-16b's) "
                         "and of the k=16 spec phase and its plain reference (paths that "
                         "need no full-depth check)")
    ap.add_argument("--phi-layers", type=int, default=4,
                    help="phi3.5-moe-42b-a6.6b depth (of 32: its float32 tree is ~168 GB)")
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

    def model(layers):
        return dense_model("glm4-9b", layers)

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
        # The unpaged engine's verify: its dense caches, float32 and int8.
        "dequant unpaged": verify_check("dequant, float32 dense caches", cfg, qparams,
                                        "dequant", None, args.seed, paged=False),
        "w8a8 unpaged": verify_check("w8a8, int8 dense caches", cfg, qparams, "w8a8", 8,
                                     args.seed, paged=False),
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
    serves.update(glm_unpaged_phases(cfg, qparams, args.seed, card, serve_cfg, serves))
    serves["unpaged spec dequant"] = unpaged_spec_dequant_phase(
        cfg, qparams, args.seed, card, serve_cfg, serves["unpaged dequant"])
    mark("unpaged glm4-9b serves")
    # The first --short-layers layers of the same tree (the second cut): the
    # lifecycle, traced and router phases (cut to this depth), held
    # against plain dequant and w8a8 phases of that depth, then a window of
    # 16 (verify Q = 17) drafting in the target's own mode (the draft is the
    # target, so every draft must be accepted), speculation on int8 dense
    # caches, and the chaos phase.
    cfg_short = model(min(args.short_layers, cfg.n_layers))
    q_short = head_layers(qparams, cfg_short.n_layers)
    w8a8_cfg = serve_cfg.replace(matmul_mode="w8a8", kv_bits=8)
    serves["w8a8 short"] = serve_phase(f"w8a8 ({cfg_short.n_layers} layers)", cfg_short,
                                       q_short, args.seed, card, w8a8_cfg, "fused_qmatmul")
    serves["dequant short"] = serve_phase(f"dequant ({cfg_short.n_layers} layers)", cfg_short,
                                          q_short, args.seed, card, serve_cfg, "ocs_matmul")
    short_plain = {"dequant": serves["dequant short"], "w8a8": serves["w8a8 short"]}
    lifecycle = lifecycle_phases(cfg_short, q_short, args.seed, card, serve_cfg, short_plain)
    serves.update(lifecycle)
    mark("lifecycle serves")
    serves["traced dequant"] = traced_phase(cfg_short, q_short, args.seed, card, serve_cfg,
                                            short_plain, args.out)
    serves["router w8a8"] = router_phase(cfg_short, q_short, args.seed, serve_cfg, lifecycle)
    mark("traced and router serves")
    serves["spec k=16"] = serve_phase(
        f"spec k=16 ({cfg_short.n_layers} layers)", cfg_short, q_short, args.seed, card,
        w8a8_cfg.replace(spec=SpecConfig(k=16, adaptive=False)), "fused_qmatmul",
        plain=serves["w8a8 short"])
    if serves["spec k=16"]["stats"]["spec_acceptance_rate"] != 1.0:
        raise AssertionError("spec k=16: a draft in the target's own mode was rejected")
    serves.update(unpaged_spec_w8a8_phases(cfg_short, q_short, args.seed, card, serve_cfg))
    mark("k=16 and unpaged w8a8 serves")
    serves["chaos"] = chaos_phase(cfg_short, q_short, args.seed, serve_cfg,
                                  serves["w8a8 short"]["outputs"])
    mark("chaos serves")
    # B2' at every tail length the resume replays ran: float32 pages in (i),
    # int8 pages in (l) and (m).
    replay_qs = {"float32": set(serves["optimistic dequant"]["replays"]),
                 "int8": set(serves["router w8a8"]["replays"]).union(
                     *(run["replays"] for run in serves["chaos"]["runs"]))}
    b2v_replay = b2v_replay_holds(gen_k, replay_qs)
    mark("B2' replay holds")
    del qparams, q_short

    cfg_clip = cfg_short
    qclip, t_quant_clip = quantized(cfg_clip, 0.0)
    b5 = kernel_phase_wo("B5", qclip, gen_k, args.iters)
    serves["clip-only"] = serve_phase("clip-only dequant", cfg_clip, qclip, args.seed, card,
                                      serve_cfg, "quant_matmul")
    del qclip
    mark("clip-only tree")
    torch.cuda.empty_cache()
    moe = moe_phases(args, card, serve_cfg, gen_k)
    mark("MoE phases")
    ssm = ssm_phases(args, card, gen_k)
    mark("SSM and hybrid phases")
    sl = slice_phases(args, card, serve_cfg, gen_k)
    mark("qwen2-vl-7b, minitron-8b and hubert-xlarge phases")
    exp = experiments_phase(args, gen_k)
    mark("experiments phase")
    refc = reference_check(args.seed)
    refc.update(moe_reference_check(args.seed))
    refc.update(ssm_reference_check(args.seed))
    refc.update(forward_reference_check(args.seed))
    mark("reference check")

    L = cfg.n_layers
    # Kernel line: the matmul kernels at one decode step's work (M = 8: 7
    # layer matmuls x L + lm_head; B4/B5 weight-only, as dense calls them),
    # B2 at its decode shape on the int8 and the int4 pool and B3 at M = 8,
    # K = 4096 (per call).
    b1_step = step_sum(b1, L)
    b4_step = step_sum(b4, L, "weight-only")
    b5_step = step_sum(b5, L, "weight-only")
    for label, rows, mode in (("B1", b1, None), ("B4 weight-only", b4, "weight-only"),
                              ("B5 weight-only", b5, "weight-only"), ("B6", b6, None)):
        for m in (8, 64, 256) if mode else (8, 256):
            t = step_sum(rows, L, mode, m)
            log(f"{label}, the M={m} calls of one {L}-layer step (7 x {L} + "
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

    # B2's Q > 1 launches: the default spec phase's verifies and the resume
    # replays of (i), (l) and the first run of (m).
    verify_launches = {
        "spec dequant": serves["spec dequant"]["launches"]["paged_attention_verify"],
        "optimistic dequant": serves["optimistic dequant"]["launches"]["paged_attention_verify"],
        "router w8a8": serves["router w8a8"]["launches"]["paged_attention_verify"],
        "chaos": serves["chaos"]["runs"][0]["launches"]["paged_attention_verify"],
    }

    def entry(name, replaces, launches, err, t, source=None):
        source = source or f"src/repro_torch/csrc/{name}.cu"
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        # Device time (a CUDA graph of the timed calls) beside the wall time,
        # where measured (every kernel but B3), and the library call's.
        for key in ("device_ms", "library_device_ms"):
            if key in t:
                e[key] = t[key]
        return e

    wo_err = lambda rows: max(r["max_abs_err"] for r in rows if r["mode"] == "weight-only")

    def wo_tiles(rows):
        """The tiles B4's or B5's weight-only calls took, by row count."""
        tiles = {}
        for r in rows:
            if "tile" in r:
                tiles.setdefault(str(r["M"]), set()).add(r["tile"])
        return {m: sorted(v) for m, v in tiles.items()}

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
              sum(verify_launches.values()),
              max(r["max_abs_err"] for r in b2v + b2v_replay), b2v_main,
              source="src/repro_torch/csrc/paged_attention.cu"),
    ]
    # The expert-stacked launches: one MoE decode step's stacked calls (C = 8,
    # w_gate, w_up and w_down of each of the L_moe layers); launches from the
    # MoE serve phase of each kernel's mode (B5: the clip-only MoE phase).
    Lm = moe["layers"]
    stack_serve = {"ocs_matmul": "dequant", "quant_matmul": "clip-only dequant",
                   "fused_qmatmul": "w8a8", "w4a8_qmatmul": "w4a8"}
    stack_kind = {"ocs_matmul": "B4", "quant_matmul": "B5", "fused_qmatmul": "B1",
                  "w4a8_qmatmul": "B6"}
    for name, (base, source, replaces) in STACK_KERNELS.items():
        t = stack_step(moe["stack"], stack_kind[base], Lm)
        kernels.append(entry(name, replaces,
                             moe["serves"][stack_serve[base]]["launches"][base + "_experts"],
                             t["max_abs_err"], t, source=source))
    # The SSM and hybrid models' decode steps (M = 8): mamba2-1.3b's 2 x 48
    # calls (its lm_head is the tied float embedding), hymba-1.5b's 9 x L +
    # lm_head at the depth each mode was served (w4a8 at --short-layers);
    # launches from the first serve of each mode.
    ssm_serve = {(arch, mode): ssm["first"][f"{arch} {mode}"]
                 for arch in ("mamba2-1.3b", "hymba-1.5b")
                 for mode in ("dequant", "w8a8", "w4a8")}
    ssm_kind = {"dequant": ("ocs_matmul", "B4", "src/repro/kernels/ocs_matmul.py:44"),
                "w8a8": ("fused_qmatmul", "B1", "src/repro/kernels/fused_qmatmul.py:60"),
                "w4a8": ("w4a8_qmatmul", "B6", "src/repro/kernels/fused_qmatmul.py:220")}
    ssm_what = {}
    for (arch, mode), label in ssm_serve.items():
        base, kind, replaces = ssm_kind[mode]
        rows = ssm["kernels"][arch][kind]
        depth = ssm["serves"][label]["n_layers"]
        t = step_sum(rows, depth, "weight-only" if kind == "B4" else None)
        err = wo_err(rows) if kind == "B4" else 0.0
        name = f"{base}_{arch.split('-')[0]}"
        kernels.append(entry(name, replaces,
                             ssm["serves"][label]["launches"][base], err, t,
                             source=f"src/repro_torch/csrc/{base}.cu"))
        ssm_what[name] = (f"one {depth}-layer {arch} decode step's "
                          f"calls, M=8; launches from the {label} serve (unpaged engine)")
    # qwen2-vl-7b's and minitron-8b's decode steps (M = 8) at the depth each
    # mode was served, launches from that serve; hubert-xlarge's forward
    # (M = 4000 a GEMM), launches from its forward runs.
    slice_what = {}
    slice_runs = {
        ("qwen2-vl-7b", "dequant"): sl["serves"]["qwen2-vl-7b dequant"],
        ("qwen2-vl-7b", "w8a8"): sl["serves"]["qwen2-vl-7b w8a8"],
        ("qwen2-vl-7b", "w4a8"): sl["serves"]["qwen2-vl-7b w4a8"],
        ("minitron-8b", "dequant"): sl["serves"]["minitron-8b dequant"],
        ("hubert-xlarge", "dequant"): sl["forward"]["hubert-xlarge dequant"],
        ("hubert-xlarge", "w8a8"): sl["forward"]["hubert-xlarge w8a8"],
        ("hubert-xlarge", "w4a8"): sl["forward"]["hubert-xlarge w4a8"],
    }
    for (arch, mode), run in slice_runs.items():
        base, kind, replaces = ssm_kind[mode]
        rows = sl["kernels"][arch][kind]
        fwd = arch == "hubert-xlarge"
        depth = sl["quantize"][arch]["layers"] if fwd else run["n_layers"]
        m = HUBERT_BATCH * HUBERT_FRAMES if fwd else 8
        t = step_sum(rows, depth, "weight-only" if kind == "B4" else None, m)
        err = wo_err(rows) if kind == "B4" else 0.0
        name = f"{base}_{arch.split('-')[0]}"
        kernels.append(entry(name, replaces, run["launches"][base], err, t,
                             source=f"src/repro_torch/csrc/{base}.cu"))
        slice_what[name] = (
            f"one {depth}-layer {arch} forward's calls, M={m}; launches from its {mode} forward"
            if fwd else f"one {depth}-layer {arch} decode step's calls, M=8; launches from "
            f"the {arch} {mode} serve (paged engine)")
    # The bench LM's GEMMs in the quality gate (one forward's calls, M =
    # 1024), launches from the gate's tiers: B1 int8, B6 the two w4a8
    # tiers, B4 int8_dequant.
    exp_what = {}
    gl = exp["gate"]["launches"]
    exp_launches = {"fused_qmatmul": gl["int8"].get("fused_qmatmul", 0),
                    "ocs_matmul": gl["int8_dequant"].get("ocs_matmul", 0),
                    "w4a8_qmatmul": gl["w4a8_ocs"].get("w4a8_qmatmul", 0)
                    + gl["w4a8_naive"].get("w4a8_qmatmul", 0)}
    exp_tiers = {"fused_qmatmul": "int8", "ocs_matmul": "int8_dequant",
                 "w4a8_qmatmul": "w4a8_ocs and w4a8_naive"}
    Lb = 4
    for base, kind in (("fused_qmatmul", "B1"), ("ocs_matmul", "B4"), ("w4a8_qmatmul", "B6")):
        rows = exp["gate"]["kernels"][kind]
        t = step_sum(rows, Lb, "weight-only" if kind == "B4" else None, EXP_M)
        name = f"{base}_benchlm"
        kernels.append(entry(name, ssm_kind[{"B1": "w8a8", "B4": "dequant",
                                             "B6": "w4a8"}[kind]][2],
                             exp_launches[base], wo_err(rows) if kind == "B4" else 0.0, t,
                             source=f"src/repro_torch/csrc/{base}.cu"))
        exp_what[name] = (f"one {Lb}-layer trained bench-LM forward's calls, M={EXP_M}; "
                          f"launches from the quality gate's {exp_tiers[base]} tier(s)")
    # Every kernel's launches on every serving path (the first serve of each
    # path in the mode that runs it; B2 runs on none of the unpaged paths).
    paths = {
        "glm4-9b paged": {"fused_qmatmul": serves["w8a8"], "ocs_matmul": serves["dequant"],
                          "quant_matmul": serves["clip-only"], "w4a8_qmatmul": serves["w4a8"],
                          "paged_attention": serves["w8a8"]},
        "glm4-9b unpaged": {"ocs_matmul": serves["unpaged dequant"],
                            "paged_attention": serves["unpaged dequant"]},
        "deepseek-moe-16b paged": {"fused_qmatmul": moe["serves"]["w8a8"],
                                   "ocs_matmul": moe["serves"]["dequant"],
                                   "quant_matmul": moe["serves"]["clip-only dequant"],
                                   "w4a8_qmatmul": moe["serves"]["w4a8"],
                                   "paged_attention": moe["serves"]["w8a8"]},
    }
    paths["glm4-9b unpaged spec"] = {
        "ocs_matmul": serves["unpaged spec dequant"],
        "fused_qmatmul": serves["unpaged spec w8a8 short"],
        "paged_attention": serves["unpaged spec dequant"]}
    paths["qwen2-vl-7b paged"] = {
        "ocs_matmul": sl["serves"]["qwen2-vl-7b dequant"],
        "fused_qmatmul": sl["serves"]["qwen2-vl-7b w8a8"],
        "w4a8_qmatmul": sl["serves"]["qwen2-vl-7b w4a8"],
        "paged_attention": sl["serves"]["qwen2-vl-7b w8a8"]}
    paths["minitron-8b paged"] = {"ocs_matmul": sl["serves"]["minitron-8b dequant"],
                                  "paged_attention": sl["serves"]["minitron-8b dequant"]}
    paths["hubert-xlarge forward"] = {
        ssm_kind[mode][0]: sl["forward"][f"hubert-xlarge {mode}"]
        for mode in ("dequant", "w8a8", "w4a8")}
    paths["hubert-xlarge forward"]["paged_attention"] = sl["forward"]["hubert-xlarge dequant"]
    paths["bench-lm quality gate"] = {base: {"launches": {base: n}}
                                      for base, n in exp_launches.items()}
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        paths[f"{arch} unpaged"] = {
            ssm_kind[mode][0]: ssm["serves"][ssm_serve[(arch, mode)]]
            for mode in ("dequant", "w8a8", "w4a8")}
        paths[f"{arch} unpaged"]["paged_attention"] = ssm["serves"][ssm_serve[(arch, "w8a8")]]
    for k in kernels:
        base = k["name"]
        if base in ("fused_qmatmul", "ocs_matmul", "quant_matmul", "w4a8_qmatmul",
                    "paged_attention"):
            k["launches_by_path"] = {path: runs[base]["launches"][base]
                                     for path, runs in paths.items() if base in runs}
    tiles = {"ocs_matmul": wo_tiles(b4), "quant_matmul": wo_tiles(b5)}
    for k in kernels:
        if k["name"] in tiles:
            k["tiles"] = tiles[k["name"]]
    what = {"fused_qmatmul": "one decode step's calls, M=8",
            "paged_attention": "one call, int8 pool, 8 lanes",
            "ocs_matmul": "one decode step's calls, M=8, weight-only",
            "quant_matmul": f"one {L}-layer decode step's calls, M=8, weight-only, "
                            f"clip-only tree; launches from the {cfg_clip.n_layers}-layer serve",
            "dynamic_quant": "one call, M=8, K=4096; launches from the kernel phase",
            "w4a8_qmatmul": "one decode step's calls, M=8",
            "paged_attention_int4": "one call, int4 pool, 8 lanes; B2's int4 branch",
            "paged_attention_verify": "one call, float32 pool, 8 lanes, Q=5; B2's Q>1 rows; "
                                      f"launches {verify_launches}"}
    for name, (base, _, _) in STACK_KERNELS.items():
        what[name] = (f"one {Lm}-layer deepseek-moe-16b decode step's expert-stacked calls "
                      f"(E=64, C=8: w_gate, w_up, w_down a layer); launches from the "
                      f"{stack_serve[base]} MoE serve phase")
    what.update(ssm_what)
    what.update(slice_what)
    what.update(exp_what)
    for k in kernels:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        dev = (f" device_ms={k['device_ms']:.4f}" if "device_ms" in k else "") + (
            f" library_device_ms={k['library_device_ms']:.4f}"
            if "library_device_ms" in k else "")
        log(f"kernel {k['name']} ({what[k['name']]}): kernel_ms={k['ms']:.4f} plain_ms="
            f"{k['plain_ms']:.4f} library_ms={lib}{dev} bound_ms={k['bound_ms']:.4f} "
            f"({k['bound_by']}) launches={k['launches']} max_abs_err={k['max_abs_err']:.3g}")
    total = time.perf_counter() - t_start
    peak_gb = max(PEAK_BYTES[0], torch.cuda.max_memory_allocated()) / 2**30
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  n_layers=L, short_layers=cfg_clip.n_layers, build_s=t_build,
                  quantize_s=t_quant, quantize_clip_s=t_quant_clip, total_s=total,
                  peak_mem_gib=peak_gb, b1=b1, b2=b2, b2v=b2v, b2v_replay=b2v_replay, b3=b3,
                  b4=b4, b5=b5, b6=b6,
                  verify_check=verify, serve=serves, phase_end_s=marks, moe=moe, ssm=ssm,
                  slice=sl, experiments=exp,
                  reference_check=refc, kernels=kernels)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    log(f"total: {total:.1f} s (build {t_build:.1f} s, quantize {t_quant:.1f} + "
        f"{t_quant_clip:.1f} s, deepseek-moe-16b {moe['quantize_s']:.1f} + "
        f"{moe['quantize_clip_s']:.1f} s, phi3.5-moe {moe['phi_quantize_s']:.1f} s, mamba2-1.3b "
        f"{ssm['quantize']['mamba2-1.3b']['seconds']:.1f} s, hymba-1.5b "
        f"{ssm['quantize']['hymba-1.5b']['seconds']:.1f} s, qwen2-vl-7b "
        f"{sl['quantize']['qwen2-vl-7b']['seconds']:.1f} s, minitron-8b "
        f"{sl['quantize']['minitron-8b']['seconds']:.1f} s, hubert-xlarge "
        f"{sl['quantize']['hubert-xlarge']['seconds']:.1f} s), experiments phase "
        f"{exp['seconds']:.1f} s (training "
        f"{sum(t['seconds'] for t in exp['train'].values()):.1f} s), depth {L} "
        f"layers (clip-only tree {cfg_clip.n_layers}; deepseek-moe-16b {Lm}, its clip-only "
        f"tree {moe['clip_layers']}; phi3.5-moe {moe['phi_layers']}), peak device memory "
        f"{peak_gb:.1f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
