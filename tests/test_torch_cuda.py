"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where
``torch.cuda.is_available()`` is false, as on CPU-only machines. On a
machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This module imports torch and ``repro_torch`` only (no JAX), so it runs
where the JAX package is not installed. Tolerances: ``fused_qmatmul``,
``w4a8_qmatmul``, ``dynamic_quant``, the int8 paths of ``ocs_matmul`` /
``quant_matmul`` and ``to_w4a8`` on the card (against the CPU) are bitwise; ``paged_attention`` pools (float32, int8 and
int4) are bitwise and outputs within ``B2_ATOL`` (float32 summation order
and ``expf`` vs torch's softmax); the
weight-only paths within the float32 summation-order bound
(``WO_TOL_FACTOR``, as in ``tests/test_torch_ocs_matmul.py``) for f32
outputs and within it plus one bf16 ulp for bf16 outputs (outputs near zero
after cancellation can be several bf16 steps apart within the f32 bound).
"""
import math

import numpy as np
import pytest
import torch

from _torch_interop import cuda_or_skip, torch_threads  # noqa: F401

from repro_torch.core.apply import quantize_params, tree_to
from repro_torch.core.ocs import to_w4a8
from repro_torch.core.recipe import QuantRecipe
from repro_torch.kernels import dynamic_quant as tdq
from repro_torch.kernels import fused_qmatmul as tfq
from repro_torch.kernels import ocs_matmul as tom
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import w4a8_qmatmul as tw4

B2_ATOL = 2e-5
WO_TOL_FACTOR = 2.0


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,k,n,s,bf16",
    [(48, 1000, 72, 13, False), (5, 384, 64, 0, False), (33, 130, 36, 7, True),
     (1, 256, 200, 6, True), (300, 4096, 512, 82, True)],
)
def test_fused_qmatmul_cuda_bitwise(m, k, n, s, bf16):
    """B1 bitwise its plain version; an N that is not a multiple of 16 runs
    on weights stored zero-padded to one (``core.ocs.pad_out_cols``, as a
    quantized leaf stores them), its first N columns bitwise the plain
    version's on the unpadded weights."""
    cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(m * 31 + k)
    dt = torch.bfloat16 if bf16 else torch.float32
    x = (torch.randn((m, k), generator=g, device="cuda") * 2.5).to(dt)
    w8 = torch.randint(-127, 128, (k + s, n), generator=g, device="cuda", dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device="cuda") * 0.01 + 1e-4
    src = torch.randint(0, k, (s,), generator=g, device="cuda", dtype=torch.int32)
    npad = tqm.padded_cols(n, 16)
    got = tfq.fused_quant_matmul_cuda(x, tqm.pad_cols(w8, npad), tqm.pad_cols(ws, npad), src,
                                      out_dtype=dt)[:, :n]
    want = tfq.fused_quant_matmul_plain(x, w8, ws, src, out_dtype=dt)
    assert torch.equal(got, want)


# glm4-9b's linear shape classes (K, S, N) for B1 on the int8 tensor cores,
# S as the serving recipe leaves it (r = 0.02, pad_to=1); each also runs
# with S = 0. Row counts across the decode tiles (M <= 8, M <= 32) and the
# prefill tile, with ragged last token tiles and one split of K or several:
# a decode row, a decode step, verifies of 8 x 5 and 8 x 17, prefill
# buckets.
B1_SHAPES = {"wq/wo": (4096, 82, 4096), "wk/wv": (4096, 82, 256),
             "w_gate/w_up": (4096, 82, 13696), "w_down": (13696, 274, 4096),
             "lm_head": (4096, 82, 151552)}
B1_MS = (1, 8, 40, 64, 136, 200, 256, 512)


def _b1_weights(k, s, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w8 = torch.randint(-127, 128, (k + s, n), generator=g, device="cuda", dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device="cuda") * 0.01 + 1e-4
    src = torch.randint(0, k, (s,), generator=g, device="cuda", dtype=torch.int32)
    return g, w8, ws, src


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [True, False], ids=["S>0", "S=0"])
@pytest.mark.parametrize("name", list(B1_SHAPES))
def test_fused_qmatmul_tc_glm4_9b_cuda(name, tail):
    """B1 on the int8 tensor cores at a glm4-9b shape class, with and
    without an OCS tail, at every M of ``B1_MS``: bitwise its plain version
    with x in bf16 and in f32 and with f32 and bf16 outputs, and rows
    bitwise the same rows of calls of 8 rows and of one row (a row's bits
    do not depend on the call's row count, tile or split)."""
    cuda_or_skip()
    k, s, n = B1_SHAPES[name]
    s = s if tail else 0
    g, w8, ws, src = _b1_weights(k, s, n, k + s + n)
    x = torch.randn((max(B1_MS), k), generator=g, device="cuda") * 2.0
    for i, m in enumerate(B1_MS):
        xm = x[:m].to((torch.bfloat16, torch.float32)[i % 2])
        for dt in (torch.float32, torch.bfloat16):
            got = tfq.fused_quant_matmul_cuda(xm, w8, ws, src, out_dtype=dt)
            want = tfq.fused_quant_matmul_plain(xm, w8, ws, src, out_dtype=dt)
            assert _same_bits(got, want), (m, xm.dtype, dt)
        for lo, r in ((0, min(8, m)), (max(0, m - 8), min(8, m)), (m // 2, 1)):
            part = tfq.fused_quant_matmul_cuda(xm[lo:lo + r].contiguous(), w8, ws, src,
                                               out_dtype=torch.bfloat16)
            assert _same_bits(part, got[lo:lo + r]), (m, lo, r)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 256])
def test_fused_qmatmul_repeated_calls_reuse_workspace_cuda(m):
    """Repeated B1 calls with a split K (wq/wo: 9 splits at M = 8, 3 at M =
    256) give the same bits, reuse the kept row and split-K scratch after
    the first call, and leave the split-K counters at zero; a call captured
    in a CUDA graph and replayed gives them too."""
    from repro_torch.kernels import scratch

    cuda_or_skip()
    k, s, n = B1_SHAPES["wq/wo"]
    g, w8, ws, src = _b1_weights(k, s, n, 11)
    assert tfq.launch_plan(m, k + s + (-(k + s)) % 16, n)[2] > 1
    x = (torch.randn((m, k), generator=g, device="cuda") * 2.0).to(torch.bfloat16)
    first = tfq.fused_quant_matmul_cuda(x, w8, ws, src, out_dtype=torch.bfloat16)
    kept = {key: buf.data_ptr() for key, buf in scratch._bufs.items()}
    n0 = tfq.launches
    for _ in range(3):
        assert _same_bits(tfq.fused_quant_matmul_cuda(x, w8, ws, src,
                                                      out_dtype=torch.bfloat16), first)
    assert tfq.launches == n0 + 3
    assert {key: buf.data_ptr() for key, buf in scratch._bufs.items()} == kept
    counters = scratch.buffer("split_k_counters", x.device, 0)
    torch.cuda.synchronize()
    assert int(counters.count_nonzero()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = tfq.fused_quant_matmul_cuda(x, w8, ws, src, out_dtype=torch.bfloat16)
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(replayed, first)
    assert {key: buf.data_ptr() for key, buf in scratch._bufs.items()} == kept


# (M, K, S, N) with N % 4 != 0 (ROADMAP C4): hymba-1.5b's lm_head (K 1600,
# N 32001) at a decode step and a verify, and a small ragged N at a decode
# row and a prefill; S even so that the W4A8 leaf packs K + S rows.
RAGGED_CASES = [(8, 1600, 32, 32001), (40, 1600, 32, 32001), (5, 300, 8, 37),
                (256, 300, 0, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,s,n", RAGGED_CASES)
def test_gemms_take_a_ragged_n_cuda(m, k, s, n):
    """A ragged N (not a multiple of 4) runs on weights stored zero-padded
    to a multiple of 16 (``core.ocs.pad_out_cols``: once, when the tree is
    built; no wrapper pads per call), and its first N columns are, bit for
    bit, what the plain versions give on the unpadded weights: B1 and B6
    bitwise; B4's and B5's int8 paths bitwise; their weight-only paths (the
    tensor cores for bf16 x, the CUDA cores for f32 x) within the
    summation-order bound of the plain version, bf16 outputs within it
    plus one bf16 ulp. Every wrapper refuses the unpadded weights before
    any launch, naming the build-time pad."""
    cuda_or_skip()
    g, w8, ws, src = _b1_weights(k, s, n, m + k + s + n)
    npad = tqm.padded_cols(n, 16)
    w8p, wsp = tqm.pad_cols(w8, npad), tqm.pad_cols(ws, npad)
    xb = (torch.randn((m, k), generator=g, device="cuda") * 2.0).to(torch.bfloat16)
    n0 = (tfq.launches, tom.launches, tqm.launches, tw4.launches)
    mult = torch.ones((s,), device="cuda")
    with pytest.raises(ValueError, match="pad_out_cols"):
        tfq.fused_quant_matmul_cuda(xb, w8, ws, src)
    with pytest.raises(ValueError, match="pad_out_cols"):
        tom.ocs_quant_matmul_cuda(xb, w8, ws, src, tail_mult=mult, tail_is_mask=True)
    with pytest.raises(ValueError, match="pad_out_cols"):
        tqm.quant_matmul_cuda(xb, w8[:k].contiguous(), ws)
    assert (tfq.launches, tom.launches, tqm.launches, tw4.launches) == n0
    for dt in (torch.float32, torch.bfloat16):
        got = tfq.fused_quant_matmul_cuda(xb, w8p, wsp, src, out_dtype=dt)
        assert got.shape == (m, npad) and not got[:, n:].any()
        assert _same_bits(got[:, :n].contiguous(),
                          tfq.fused_quant_matmul_plain(xb, w8, ws, src, out_dtype=dt))
    for x in (xb, xb.float()):
        got = tom.ocs_quant_matmul_cuda(x, w8p, wsp, src, tail_mult=mult, tail_is_mask=True,
                                        out_dtype=torch.float32)[:, :n]
        want = tom.ocs_quant_matmul_plain(x, w8, ws, src, tail_mult=mult,
                                          out_dtype=torch.float32)
        xe = torch.cat([x.float(), x[:, src.long()].float()], 1)
        bound = (WO_TOL_FACTOR * (k + s + 2) * 2.0 ** -24
                 * tref.float_matmul(xe.abs(), w8.abs()) * ws)
        assert got.shape == (m, n) and torch.isfinite(got).all()
        assert ((got - want).abs() <= bound).all(), x.dtype
    g16 = tom.ocs_quant_matmul_cuda(xb, w8p, wsp, src, tail_mult=mult, tail_is_mask=True,
                                    out_dtype=torch.bfloat16)[:, :n].float()
    p16 = tom.ocs_quant_matmul_plain(xb, w8, ws, src, tail_mult=mult,
                                     out_dtype=torch.bfloat16).float()
    assert ((g16 - p16).abs() <= bound + _bf16_ulp(torch.maximum(g16.abs(), p16.abs()))).all()
    x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    xs = torch.rand((m,), generator=g, device="cuda") * 0.05 + 1e-3
    for dt in (torch.float32, torch.bfloat16):
        got = tom.ocs_quant_matmul_cuda(x8, w8p, wsp, src, xs, mult, out_dtype=dt)[:, :n]
        assert _same_bits(got.contiguous(), tom.ocs_quant_matmul_plain(x8, w8, ws, src, xs,
                                                                       mult, out_dtype=dt)), dt
    x4, w4, s4, w48, s8, src4, oidx = _w4a8_case(m, k, n, s, 13, torch.bfloat16, m + n)
    assert w4.shape[1] == npad  # stored as pad_out_cols stores a W4A8Linear
    with pytest.raises(ValueError, match="pad_out_cols"):
        tw4.w4a8_matmul_cuda(x4, w4[:, :n].contiguous(), s4[:n].contiguous(),
                             w48[:, :n].contiguous(), s8[:n].contiguous(), src4, oidx)
    for dt in (torch.float32, torch.bfloat16):
        got = tw4.w4a8_matmul_cuda(x4, w4, s4, w48, s8, src4, oidx, out_dtype=dt)
        want = tw4.w4a8_matmul_plain(x4, w4[:, :n], s4[:n], w48[:, :n], s8[:n], src4, oidx,
                                     out_dtype=dt)
        assert _same_bits(got[:, :n].contiguous(), want), dt


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_cuda_vs_plain(int8, ps):
    cuda_or_skip()
    rng = np.random.RandomState(ps + int8)
    B, T, KV, H, hd = 3, 4, 2, 8, 32
    P = B * T + 1
    if int8:
        pool = {"k": rng.randint(-127, 128, (P, KV, ps, hd)).astype(np.int8),
                "v": rng.randint(-127, 128, (P, KV, ps, hd)).astype(np.int8),
                "k_scale": (rng.rand(P, KV, ps) * 0.1 + 0.01).astype(np.float32),
                "v_scale": (rng.rand(P, KV, ps) * 0.1 + 0.01).astype(np.float32)}
        pool["k_scale"][0] = np.nan  # poisoned trash page
    else:
        pool = {"k": rng.randn(P, KV, ps, hd).astype(np.float32),
                "v": rng.randn(P, KV, ps, hd).astype(np.float32)}
        pool["k"][0] = np.nan
    table = np.zeros((B, T), np.int32)
    table[0, :2] = [1, 2]
    table[1, :4] = [3, 4, 5, 6]
    pos = np.array([ps + 3, 4 * ps - 1, 0], np.int32)  # lane 2 retired
    dev = torch.device("cuda")
    tpool = {k: torch.from_numpy(v).to(dev) for k, v in pool.items()}
    args = [torch.from_numpy(a).to(dev) for a in (table, pos)]
    args += [torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(dev).to(torch.bfloat16)
             for sh in ((B, 1, H, hd), (B, 1, KV, hd), (B, 1, KV, hd))]
    want_o, want_p = tpa.paged_attention_plain(tpool, *args)
    got_o, got_p = tpa.paged_attention_cuda({k: v.clone() for k, v in tpool.items()}, *args)
    torch.cuda.synchronize()
    assert torch.isfinite(got_o).all()
    assert (got_o[2] == 0).all()
    torch.testing.assert_close(got_o, want_o, atol=B2_ATOL, rtol=0)
    for key in want_p:
        assert _same_bits(got_p[key], want_p[key]), key


@pytest.mark.cuda
def test_paged_attention_cuda_refuses_float32_inputs():
    """The kernel reads bfloat16 q/k_new/v_new (the model's activations)
    only; other input dtypes are refused before any launch."""
    cuda_or_skip()
    dev = torch.device("cuda")
    pool = {"k": torch.zeros((2, 1, 4, 8), device=dev), "v": torch.zeros((2, 1, 4, 8), device=dev)}
    table = torch.ones((1, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.zeros((1, 1, 2, 8), device=dev)
    kn = torch.zeros((1, 1, 1, 8), device=dev)
    n0 = tpa.launches
    with pytest.raises(ValueError, match="bfloat16"):
        tpa.paged_attention_cuda(pool, table, pos, q, kn, kn)
    assert tpa.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,bf16", [(5, 300, False), (1, 2048, True), (300, 13696, True)])
def test_dynamic_quant_cuda_bitwise(m, k, bf16):
    cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(m + k)
    x = torch.randn((m, k), generator=g, device="cuda") * 3.0
    x = x.to(torch.bfloat16) if bf16 else x
    q, sc = tdq.dynamic_quant_cuda(x)
    q_want, sc_want = tdq.dynamic_quant_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, q_want)
    assert _same_bits(sc, sc_want)


def _bf16_ulp(t):
    _, e = torch.frexp(t.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(t), e - 8)


# (M, K, N, S, x dtype, tail_mult kind): ragged M and K (N % 4 == 0, which
# the kernels read in 4-column words), S = 0 (B5), and one glm4-9b shape.
OCS_CASES = [
    (5, 300, 72, 7, torch.bfloat16, "half"),
    (33, 130, 36, 130, torch.float32, "mask"),
    (3, 200, 52, 0, torch.bfloat16, None),
    (17, 1000, 260, 21, torch.float32, None),
    (8, 4096, 4096, 82, torch.bfloat16, "ones"),
    (256, 4096, 256, 0, torch.bfloat16, None),
]


def _ocs_case(m, k, n, s, dt, mult_kind, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((m, k), generator=g, device="cuda") * 2.0).to(dt)
    w8 = torch.randint(-127, 128, (k + s, n), generator=g, device="cuda", dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device="cuda") * 0.01 + 1e-4
    src = torch.randint(0, k, (s,), generator=g, device="cuda", dtype=torch.int32)
    mult = None
    if mult_kind == "half":
        mult = torch.tensor([0.0, 0.5, 1.0], device="cuda")[
            torch.randint(0, 3, (s,), generator=g, device="cuda")]
    elif mult_kind == "mask":
        mult = torch.randint(0, 2, (s,), generator=g, device="cuda").float()
    elif mult_kind == "ones":
        mult = torch.ones((s,), device="cuda")
    return x, w8, ws, src, mult


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,s,dt,mult_kind", OCS_CASES)
def test_ocs_matmul_cuda_weight_only(m, k, n, s, dt, mult_kind):
    """B4 (B5 when S == 0) weight-only: f32 outputs within the summation
    bound, bf16 outputs within it plus one bf16 ulp, launches counted on
    the kernel that ran."""
    cuda_or_skip()
    x, w8, ws, src, mult = _ocs_case(m, k, n, s, dt, mult_kind, m * 131 + k + s)
    n_om, n_qm = tom.launches, tqm.launches
    got = tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult, out_dtype=torch.float32)
    want = tom.ocs_quant_matmul_plain(x, w8, ws, src, tail_mult=mult, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (tom.launches - n_om, tqm.launches - n_qm) == ((1, 0) if s else (0, 1))
    tail = x[:, src.long()].float() * (1.0 if mult is None else mult)
    xe = torch.cat([x.float(), tail], 1)
    bound = (WO_TOL_FACTOR * (k + s + 2) * 2.0 ** -24
             * tref.float_matmul(xe.abs(), w8.abs()) * ws)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= bound).all()
    got16 = tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult, out_dtype=torch.bfloat16)
    want16 = tom.ocs_quant_matmul_plain(x, w8, ws, src, tail_mult=mult,
                                        out_dtype=torch.bfloat16).float()
    got16 = got16.float()
    assert ((got16 - want16).abs()
            <= bound + _bf16_ulp(torch.maximum(got16.abs(), want16.abs()))).all()
    # The split-K reduction is in a fixed order: the same call, the same bits.
    again = tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult, out_dtype=torch.float32)
    assert _same_bits(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,s", [(5, 300, 72, 7), (33, 130, 36, 130), (3, 200, 52, 0),
                                     (17, 256, 64, 0), (256, 4096, 4096, 82)])
def test_ocs_matmul_cuda_int8_bitwise(m, k, n, s):
    """B4's int8 path (B5 when S == 0; K % 16 == 0 reads x in place) with a
    0/1 mask and per-row scales, f32 and bf16 outputs: bitwise."""
    cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(m + k + n + s)
    x = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    w8 = torch.randint(-127, 128, (k + s, n), generator=g, device="cuda", dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device="cuda") * 0.01 + 1e-4
    xs = torch.rand((m,), generator=g, device="cuda") * 0.05 + 1e-3
    src = torch.randint(0, k, (s,), generator=g, device="cuda", dtype=torch.int32)
    mask = torch.randint(0, 2, (s,), generator=g, device="cuda").float()
    for dt in (torch.float32, torch.bfloat16):
        got = tom.ocs_quant_matmul_cuda(x, w8, ws, src, xs, mask, out_dtype=dt)
        want = tom.ocs_quant_matmul_plain(x, w8, ws, src, xs, mask, out_dtype=dt)
        torch.cuda.synchronize()
        assert _same_bits(got, want), dt
    got = tqm.quant_matmul_cuda(x, w8[:k], 0.5, xs)
    assert _same_bits(got, tqm.quant_matmul_plain(x, w8[:k], 0.5, xs))


@pytest.mark.cuda
def test_ocs_matmul_cuda_refuses_before_launch():
    """Operands the kernels do not take raise before any launch."""
    cuda_or_skip()
    dev = torch.device("cuda")
    x = torch.zeros((2, 8), dtype=torch.bfloat16, device=dev)
    src = torch.zeros((2,), dtype=torch.int32, device=dev)
    n0 = (tom.launches, tqm.launches)
    with pytest.raises(ValueError, match="w8 rows"):  # w8 holds K + S rows
        tom.ocs_quant_matmul_cuda(x, torch.zeros((11, 6), dtype=torch.int8, device=dev),
                                  torch.ones(6, device=dev), src)
    with pytest.raises(ValueError, match="fractional"):
        tom.ocs_quant_matmul_cuda(x.to(torch.int8), torch.zeros((10, 8), dtype=torch.int8,
                                                                device=dev),
                                  torch.ones(8, device=dev), src,
                                  tail_mult=torch.tensor([0.5, 1.0], device=dev))
    with pytest.raises(ValueError, match="out_dtype"):
        tqm.quant_matmul_cuda(x, torch.zeros((8, 8), dtype=torch.int8, device=dev),
                              torch.ones(8, device=dev), out_dtype=torch.float16)
    assert (tom.launches, tqm.launches) == n0


# (M, K, N, S, T, x dtype): ragged shapes (N % 4 == 0), T == 0 and S == 0,
# and glm4-9b's K+S = 4178 (T = 209) and 13970 (T = 699); the decode and
# the 64-token tiles on either side of M = 8 (9, and 40: a verify of 8 x
# 5), an odd K+S (309, padded as to_w4a8 pads it), T = 1 and T = 33 (one
# outlier stage, two), N = 37 (run on 48 columns), a split whose stage
# ranges cross from the int4 stages into the outlier ones (wk/wv at M = 8:
# 15 splits), and the lm_head's width at M = 256 (one split: the
# accumulator's bound).
W4A8_CASES = [
    (5, 300, 72, 8, 0, torch.float32),
    (33, 250, 52, 6, 13, torch.bfloat16),
    (3, 130, 36, 0, 7, torch.float32),
    (1, 4096, 4096, 82, 209, torch.bfloat16),
    (8, 13696, 256, 274, 699, torch.bfloat16),
    (256, 4096, 512, 82, 209, torch.bfloat16),
    (9, 4096, 4096, 82, 209, torch.bfloat16),
    (40, 4096, 4096, 82, 209, torch.float32),
    (7, 301, 64, 8, 20, torch.bfloat16),
    (8, 1000, 128, 6, 1, torch.bfloat16),
    (24, 1000, 256, 6, 33, torch.float32),
    (5, 300, 37, 8, 13, torch.bfloat16),
    (8, 4096, 256, 82, 209, torch.bfloat16),
    (256, 4096, 151552, 82, 209, torch.bfloat16),
]


def _w4a8_case(m, k, n, s, t, dt, seed):
    """Random W4A8 operands; an odd K+S gets what ``to_w4a8`` gives it: a
    dead tail entry (src 0) and a zero last expanded row (the high nibble
    of the last byte row). An N that is not a multiple of 16 is stored as
    ``core.ocs.pad_out_cols`` stores it: zero columns (weights and scales)
    up to the next multiple of 16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((m, k), generator=g, device="cuda") * 2.0).to(dt)
    ke = k + s + (k + s) % 2
    w4 = torch.randint(0, 256, (ke // 2, n), generator=g, device="cuda",
                       dtype=torch.int32).to(torch.uint8)
    s4 = torch.rand((n,), generator=g, device="cuda") * 0.01 + 1e-4
    w8 = torch.randint(-127, 128, (t, n), generator=g, device="cuda", dtype=torch.int8)
    s8 = torch.rand((n,), generator=g, device="cuda") * 0.001 + 1e-5
    src = torch.randint(0, k, (s,), generator=g, device="cuda", dtype=torch.int32)
    oidx = torch.sort(torch.randperm(k + s, generator=g, device="cuda")[:t]).values
    if ke > k + s:
        src = torch.cat([src, torch.zeros((1,), dtype=torch.int32, device="cuda")])
        w4[-1] &= 0x0F
    npad = tqm.padded_cols(n, 16)
    w4, s4, w8, s8 = (tqm.pad_cols(a, npad) for a in (w4, s4, w8, s8))
    return x, w4, s4, w8, s8, src, oidx.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,s,t,dt", W4A8_CASES)
def test_w4a8_qmatmul_cuda_bitwise(m, k, n, s, t, dt):
    """B6 against its plain version, f32 and bf16 outputs: bitwise; one
    launch counted per call; the same call gives the same bits."""
    cuda_or_skip()
    args = _w4a8_case(m, k, n, s, t, dt, m * 7 + k + t)
    for out_dtype in (torch.float32, torch.bfloat16):
        n0 = tw4.launches
        got = tw4.w4a8_matmul_cuda(*args, out_dtype=out_dtype)
        want = tw4.w4a8_matmul_plain(*args, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert tw4.launches == n0 + 1
        assert _same_bits(got, want), out_dtype
        assert _same_bits(tw4.w4a8_matmul_cuda(*args, out_dtype=out_dtype), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,s,t,dt", [c for c in W4A8_CASES if c[0] > 1])
def test_w4a8_qmatmul_rows_independent_of_call_rows_cuda(m, k, n, s, t, dt):
    """Each row of an M-row B6 call is bitwise the same row called alone
    (f32 out), whatever tile and split the M-row call ran: the verify
    contract."""
    cuda_or_skip()
    x, *rest = _w4a8_case(m, k, n, s, t, dt, m * 7 + k + t)
    got = tw4.w4a8_matmul_cuda(x, *rest)
    for r in range(m):
        alone = tw4.w4a8_matmul_cuda(x[r:r + 1].contiguous(), *rest)
        assert _same_bits(alone, got[r:r + 1]), r


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(8, 4096), (8, 256), (256, 4096)])
def test_w4a8_qmatmul_split_leaves_workspace_zero_cuda(m, n):
    """Repeated B6 calls with a split K (glm4-9b's wq/wo at M = 8 and 256,
    wk/wv at M = 8, whose splits cross into the outlier stages) give the
    same bits, count one launch each, reuse the kept scratch after the
    first call, and leave the two-sum accumulator and the counters at zero;
    a call captured in a CUDA graph and replayed gives them too."""
    from repro_torch.kernels import scratch

    cuda_or_skip()
    args = _w4a8_case(m, 4096, n, 82, 209, torch.bfloat16, m + n)
    hp, tp = tw4.row_layout(2089, 209)
    assert tw4.launch_plan(m, hp // 32, tp // 32, n)[2] > 1
    first = tw4.w4a8_matmul_cuda(*args, out_dtype=torch.bfloat16)
    kept = {key: buf.data_ptr() for key, buf in scratch._bufs.items()}
    n0 = tw4.launches
    for _ in range(3):
        assert _same_bits(tw4.w4a8_matmul_cuda(*args, out_dtype=torch.bfloat16), first)
    assert tw4.launches == n0 + 3
    assert {key: buf.data_ptr() for key, buf in scratch._bufs.items()} == kept
    torch.cuda.synchronize()
    for key in ("b6_acc", "split_k_counters"):
        assert int(scratch.buffer(key, first.device, 0).count_nonzero()) == 0, key
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = tw4.w4a8_matmul_cuda(*args, out_dtype=torch.bfloat16)
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(replayed, first)
    assert {key: buf.data_ptr() for key, buf in scratch._bufs.items()} == kept
    assert int(scratch.buffer("b6_acc", first.device, 0).count_nonzero()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [0.0, 0.05, 0.25])
@pytest.mark.parametrize("layers,cin", [(None, 37), (3, 48)], ids=["odd-Kexp", "stacked"])
def test_to_w4a8_cuda_bitwise_cpu(layers, cin, ratio):
    """``to_w4a8`` on the card, as the engine converts its tree, is bitwise
    the same conversion on the CPU (which ``tests/test_torch_w4a8.py``
    holds bitwise against the reference) in all five arrays and the padded
    spec; the leaves' clipped rows give ties in the outlier ranking, which
    the stable argsort must break alike."""
    cuda_or_skip()
    rng = np.random.RandomState(cin + int(100 * ratio))
    w = rng.randn(*(() if layers is None else (layers,)), cin, 24).astype(np.float32)
    w[..., rng.randint(0, cin), :] *= 6.0  # an outlier row
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.05, per_channel=True, pad_to=1)
    lin = quantize_params({"w": torch.from_numpy(w)}, recipe, device="cpu")["w"]
    assert lin.weight.values.shape[-2] % 2 == 1  # the dead-row padding path
    want = to_w4a8(lin, ratio)
    got = to_w4a8(tree_to(lin, "cuda"), ratio)
    for name in ("w4", "s4", "w8", "s8", "outlier_idx"):
        assert getattr(got, name).is_cuda
        assert _same_bits(getattr(got, name), getattr(want, name)), name
    for name in ("src", "mult", "bias"):
        assert _same_bits(getattr(got.spec, name), getattr(want.spec, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("ocs_ratio", [0.0, 0.05])
def test_quantize_params_cuda_bitwise_cpu(ocs_ratio):
    """``quantize_params`` on the card (as ``chip_smoke.py`` quantizes
    glm4-9b) is bitwise the same recipe on the CPU: values, scales and
    spec of a stacked leaf."""
    cuda_or_skip()
    rng = np.random.RandomState(7 + int(100 * ocs_ratio))
    w = rng.randn(2, 96, 40).astype(np.float32)
    w[:, 5] *= 8.0  # an outlier channel
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=ocs_ratio, per_channel=True,
                         pad_to=1)
    want = quantize_params({"w": torch.from_numpy(w)}, recipe, device="cpu")["w"]
    got = quantize_params({"w": torch.from_numpy(w)}, recipe, device="cuda")["w"]
    assert got.weight.values.is_cuda
    assert _same_bits(got.weight.values, want.weight.values)
    assert _same_bits(got.weight.scale, want.weight.scale)
    for name in ("src", "mult", "bias"):
        assert _same_bits(getattr(got.spec, name), getattr(want.spec, name)), name


@pytest.mark.cuda
def test_w4a8_qmatmul_cuda_refuses_before_launch():
    cuda_or_skip()
    x, w4, s4, w8, s8, src, oidx = _w4a8_case(2, 40, 12, 0, 3, torch.float32, 1)
    n0 = tw4.launches
    with pytest.raises(ValueError, match="rows"):  # w4 holds K+S rows
        tw4.w4a8_matmul_cuda(x[:, :38].contiguous(), w4, s4, w8, s8, src, oidx)
    with pytest.raises(ValueError, match="s4/s8"):
        tw4.w4a8_matmul_cuda(x, w4[:, :6].contiguous(), s4, w8[:, :6].contiguous(), s8, src,
                             oidx)
    with pytest.raises(ValueError, match="w8"):
        tw4.w4a8_matmul_cuda(x, w4, s4, w8[:2], s8, src, oidx)
    with pytest.raises(ValueError, match="uint8"):
        tw4.w4a8_matmul_cuda(x, w4.to(torch.int8), s4, w8, s8, src, oidx)
    assert tw4.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_attention_cuda_int4_vs_plain(ps):
    """B2's int4 branch: packed pools bitwise after the append, outputs
    within ``B2_ATOL``, a NaN-poisoned trash page never read, the retired
    lane exact zeros."""
    cuda_or_skip()
    rng = np.random.RandomState(ps + 4)
    B, T, KV, H, hd = 3, 4, 2, 8, 32
    P = B * T + 1
    pool = {"k": rng.randint(0, 256, (P, KV, ps, hd // 2)).astype(np.uint8),
            "v": rng.randint(0, 256, (P, KV, ps, hd // 2)).astype(np.uint8),
            "k_scale": (rng.rand(P, KV, ps) * 0.2 + 0.02).astype(np.float32),
            "v_scale": (rng.rand(P, KV, ps) * 0.2 + 0.02).astype(np.float32)}
    pool["k_scale"][0] = np.nan  # poisoned trash page
    pool["v_scale"][0] = np.nan
    table = np.zeros((B, T), np.int32)
    table[0, :2] = [1, 2]
    table[1, :4] = [3, 4, 5, 6]
    pos = np.array([ps + 3, 4 * ps - 1, 0], np.int32)  # lane 2 retired
    dev = torch.device("cuda")
    tpool = {k: torch.from_numpy(v).to(dev) for k, v in pool.items()}
    args = [torch.from_numpy(a).to(dev) for a in (table, pos)]
    args += [torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(dev).to(torch.bfloat16)
             for sh in ((B, 1, H, hd), (B, 1, KV, hd), (B, 1, KV, hd))]
    want_o, want_p = tpa.paged_attention_plain(tpool, *args)
    n0 = tpa.launches
    got_o, got_p = tpa.paged_attention_cuda({k: v.clone() for k, v in tpool.items()}, *args)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    assert torch.isfinite(got_o).all()
    assert (got_o[2] == 0).all()
    torch.testing.assert_close(got_o, want_o, atol=B2_ATOL, rtol=0)
    for key in want_p:
        assert _same_bits(got_p[key], want_p[key]), key


def _multirow_case(kind, qn, H, KV, seed, hd=128, ps=16, B=4, T=8):
    """``qn`` query tokens per lane: lane 0's window runs past its two
    pages into trash table entries, lane 1 ends near the table's end, lane 2
    starts at position 0, lane 3 is retired (all trash). Page 0 is
    NaN-poisoned."""
    rng = np.random.RandomState(seed)
    P = B * T + 1
    if kind == "float32":
        pool = {"k": rng.randn(P, KV, ps, hd).astype(np.float32),
                "v": rng.randn(P, KV, ps, hd).astype(np.float32)}
        pool["k"][0] = pool["v"][0] = np.nan
    else:
        lo, hi, dt, row = ((-127, 128, np.int8, hd) if kind == "int8"
                           else (0, 256, np.uint8, hd // 2))
        pool = {"k": rng.randint(lo, hi, (P, KV, ps, row)).astype(dt),
                "v": rng.randint(lo, hi, (P, KV, ps, row)).astype(dt),
                "k_scale": (rng.rand(P, KV, ps) * 0.1 + 0.01).astype(np.float32),
                "v_scale": (rng.rand(P, KV, ps) * 0.1 + 0.01).astype(np.float32)}
        pool["k_scale"][0] = pool["v_scale"][0] = np.nan
    table = np.zeros((B, T), np.int32)
    table[0, :2] = [1, 2]
    pos1 = T * ps - qn - 1
    n1 = (pos1 + qn - 1) // ps + 1
    table[1, :n1] = np.arange(3, 3 + n1)
    n2 = (qn - 1) // ps + 1
    table[2, :n2] = np.arange(3 + n1, 3 + n1 + n2)
    pos = np.array([ps + 3, pos1, 0, 0], np.int32)
    dev = torch.device("cuda")
    tpool = {k: torch.from_numpy(v).to(dev) for k, v in pool.items()}
    args = [torch.from_numpy(a).to(dev) for a in (table, pos)]
    args += [torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(dev).to(torch.bfloat16)
             for sh in ((B, qn, H, hd), (B, qn, KV, hd), (B, qn, KV, hd))]
    return tpool, args


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(32, 2), (4, 2)], ids=["rep16", "rep2"])
@pytest.mark.parametrize("qn", [2, 5, 17])
@pytest.mark.parametrize("kind", ["float32", "int8", "int4"])
def test_paged_attention_cuda_multirow(kind, qn, heads):
    """B2's Q > 1 rows (speculative verify), tiled over query rows: pools
    bitwise the plain version's (the trash page, written by several rows
    and never read, aside), outputs within ``B2_ATOL``, the retired lane
    exact zeros; every row bitwise the sequential Q = 1 launches at its
    position, which leave the pools bitwise alike. A Q > 1 call counts on
    ``launches_verify``, a Q = 1 call on ``launches``."""
    cuda_or_skip()
    H, KV = heads
    pool, (table, pos, q, kn, vn) = _multirow_case(kind, qn, H, KV, qn * 3 + H)
    want_o, want_p = tpa.paged_attention_plain(pool, table, pos, q, kn, vn)
    n0 = (tpa.launches, tpa.launches_verify)
    got_o, got_p = tpa.paged_attention_cuda({k: v.clone() for k, v in pool.items()},
                                            table, pos, q, kn, vn)
    seq_p, outs = {k: v.clone() for k, v in pool.items()}, []
    for j in range(qn):
        o, seq_p = tpa.paged_attention_cuda(seq_p, table, pos + j, q[:, j:j + 1].contiguous(),
                                            kn[:, j:j + 1].contiguous(),
                                            vn[:, j:j + 1].contiguous())
        outs.append(o)
    torch.cuda.synchronize()
    assert (tpa.launches, tpa.launches_verify) == (n0[0] + qn, n0[1] + 1)
    assert torch.isfinite(got_o).all() and (got_o[3] == 0).all()
    torch.testing.assert_close(got_o, want_o, atol=B2_ATOL, rtol=0)
    assert _same_bits(torch.cat(outs, 1), got_o)
    for key in want_p:
        assert _same_bits(got_p[key][1:], want_p[key][1:]), key
        assert _same_bits(seq_p[key][1:], got_p[key][1:]), key


def _check_gqa_heads(kind, qn, H, KV):
    """B2 at ``H`` query heads over ``KV`` KV heads, Q = ``qn``, on
    ``test_paged_attention_cuda_multirow``'s lanes: pools bitwise the plain
    version's (the trash page aside), every row bitwise the sequential
    Q = 1 launches, the retired lane zeros; the outputs, up to ~14 on these
    int8 pools (scales up to 0.11), within ``B2_ATOL`` of the largest
    output magnitude (float32 sums in another order: 2.3e-5 absolute,
    1.7e-6 relative, was read on an H100 at rep 7, Q = 2)."""
    cuda_or_skip()
    pool, (table, pos, q, kn, vn) = _multirow_case(kind, qn, H, KV, qn * (H // KV) + 1)
    want_o, want_p = tpa.paged_attention_plain(pool, table, pos, q, kn, vn)
    got_o, got_p = tpa.paged_attention_cuda({k: v.clone() for k, v in pool.items()},
                                            table, pos, q, kn, vn)
    seq_p, outs = {k: v.clone() for k, v in pool.items()}, []
    for j in range(qn):
        o, seq_p = tpa.paged_attention_cuda(seq_p, table, pos + j, q[:, j:j + 1].contiguous(),
                                            kn[:, j:j + 1].contiguous(),
                                            vn[:, j:j + 1].contiguous())
        outs.append(o)
    torch.cuda.synchronize()
    assert torch.isfinite(got_o).all() and (got_o[3] == 0).all()
    scale = max(1.0, want_o.abs().max().item())
    torch.testing.assert_close(got_o, want_o, atol=B2_ATOL * scale, rtol=0)
    assert _same_bits(torch.cat(outs, 1), got_o)
    for key in want_p:
        assert _same_bits(got_p[key][1:], want_p[key][1:]), key
        assert _same_bits(seq_p[key][1:], got_p[key][1:]), key


@pytest.mark.cuda
@pytest.mark.parametrize("qn", [1, 2, 5, 17])
@pytest.mark.parametrize("kind", ["float32", "int8", "int4"])
def test_paged_attention_cuda_rep7(kind, qn):
    """B2 at qwen2-vl-7b's heads (28 query heads over 4 KV heads, rep 7),
    Q = 1 and the Q > 1 rows of a verify (:func:`_check_gqa_heads`)."""
    _check_gqa_heads(kind, qn, 28, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("qn", [1, 2, 5, 17])
@pytest.mark.parametrize("kind", ["float32", "int8", "int4"])
def test_paged_attention_cuda_rep4(kind, qn):
    """B2 at minitron-8b's heads (32 query heads over 8 KV heads, rep 4),
    Q = 1 and the Q > 1 rows of a verify (:func:`_check_gqa_heads`)."""
    _check_gqa_heads(kind, qn, 32, 8)


def _row_independence_cases():
    """(name, fn of x [M, 4096] bf16): ``dense`` on glm4-9b-sized leaves
    quantized on the card in each mode (dequant through B4 and, for the
    clip-only leaf, B5; w8a8 through B1; w4a8 through B6), and ``rms_norm``."""
    from repro_torch.models import layers

    rng = np.random.RandomState(3)
    w = rng.randn(4096, 4096).astype(np.float32) / 64.0
    w[17] *= 8.0  # an outlier channel
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True, pad_to=1)
    ocs = quantize_params({"w": torch.from_numpy(w)}, recipe, device="cuda")["w"]
    clip = quantize_params({"w": torch.from_numpy(w)},
                           QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.0,
                                       per_channel=True, pad_to=1), device="cuda")["w"]
    w4 = to_w4a8(ocs, 0.05)
    scale = torch.rand(4096, device="cuda") + 0.5
    return [
        ("dequant", lambda x: layers.dense(ocs, x, mode="dequant")),
        ("dequant-clip-only", lambda x: layers.dense(clip, x, mode="dequant")),
        ("w8a8", lambda x: layers.dense(ocs, x, mode="w8a8")),
        ("w4a8", lambda x: layers.dense(w4, x, mode="w4a8")),
        ("rms_norm", lambda x: layers.rms_norm(scale, x)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [40, 64, 256])
def test_rows_independent_of_row_count_cuda(m):
    """The verify contract's base: a row's bits do not depend on how many
    rows the call holds. Rows of calls of 8 (a decode step's lanes), 1 and
    17 rows are bitwise the same rows of a call of ``m`` rows (40: a verify
    of 8 lanes x 5 tokens; 256: a prefill, which B4/B5 run in two row
    chunks), for ``dense`` in every mode and ``rms_norm``."""
    cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((m, 4096), generator=g, device="cuda") * 2.0).to(torch.bfloat16)
    for name, fn in _row_independence_cases():
        full = fn(x)
        for lo, n in ((0, 8), (16, 8), (5, 1), (3, 17), (m - 8, 8)):
            assert _same_bits(fn(x[lo:lo + n]), full[lo:lo + n]), (name, m, lo, n)


@pytest.mark.cuda
@pytest.mark.parametrize("s,declared", [(82, False), (0, False), (82, True)],
                         ids=["B4", "B5", "B4-tensor-cores"])
def test_weight_only_row_chunks_cuda(monkeypatch, s, declared):
    """A weight-only call whose split-K workspace passes its bound runs in
    row chunks: with the bound cut so 40 rows take chunks of 12, 12, 12, 4,
    the output is bitwise that of one launch, and one wrapper call counts
    one launch; B4's all-ones tail takes the tensor cores when it is
    declared a mask and the CUDA cores when it is not."""
    cuda_or_skip()
    x, w8, ws, src, mult = _ocs_case(40, 4096, 256, s, torch.bfloat16, "ones" if s else None, 7)

    def call():
        return tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult, tail_is_mask=declared)

    want = call()
    # B4's CUDA-core plan over K + S rows, or the tensor-core plan of B5's K
    # rows or B4's Kb + S virtual rows.
    cuda_cores = s and not declared
    nsplit = (tqm.wo_split_plan(4096 + s, 256) if cuda_cores
              else tqm.tc_split_plan(tqm.tc_rows(4096, s), 256))[1]
    monkeypatch.setattr(tqm, "_MAX_PART_BYTES", 4 * nsplit * 12 * 256)
    assert tqm.wo_row_chunk(40, 256, nsplit) == 12
    n0 = (tom.launches + tqm.launches, tom.launches_cuda_cores)
    got = call()
    assert tom.launches + tqm.launches - n0[0] == 1
    assert tom.launches_cuda_cores - n0[1] == int(bool(cuda_cores))
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kv_bits", [("dequant", None), ("w8a8", 8), ("w4a8", 4)])
def test_verify_step_cuda_bitwise_sequential(mode, kv_bits):
    """On the card, ``verify_step`` over 5 tokens is bitwise 5 sequential
    ``decode_step`` calls (logits, every layer's pools, positions), on a
    two-layer glm4-9b-shaped model (32/2 heads of 128, d_model 4096) at
    ragged lane positions."""
    import copy
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear
    from repro_torch.models import transformer as T
    from repro_torch.serving import kv_cache as kvc

    cuda_or_skip()
    cfg = dataclasses.replace(smoke_config("glm4-9b"), d_model=4096, n_heads=32,
                              n_kv_heads=2, head_dim=128, d_ff=1024, vocab=2048,
                              kv_bits=kv_bits)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = quantize_params(T.init_params(cfg, gen, device="cuda"),
                        QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02,
                                    per_channel=True, pad_to=1), device="cuda")
    if mode == "w4a8":
        q = map_with_path(lambda _p, leaf: to_w4a8(leaf, 0.05)
                          if isinstance(leaf, OCSQuantLinear) else leaf, q)
    B, T_, ps = 3, 4, 16
    caches = kvc.init_paged_cache(cfg, B, B * T_ + 1, ps, T_, device="cuda")
    caches["table"] = torch.arange(1, B * T_ + 1, dtype=torch.int32,
                                   device="cuda").reshape(B, T_)
    caches["pos"] = torch.tensor([0, 9, 30], dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for t in rng.integers(0, cfg.vocab, (6, B)):
            _, caches = T.decode_step(q, torch.as_tensor(t[:, None], dtype=torch.int32,
                                                         device="cuda"), caches, cfg, mode=mode)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, 5)), dtype=torch.int32,
                               device="cuda")
        seq, outs = copy.deepcopy(caches), []
        for j in range(5):
            lg, seq = T.decode_step(q, toks[:, j:j + 1].contiguous(), seq, cfg, mode=mode)
            outs.append(lg)
        lg_v, ver = T.verify_step(q, toks, copy.deepcopy(caches), cfg, mode=mode)
    torch.cuda.synchronize()
    assert _same_bits(torch.stack(outs, 1).float(), lg_v.float())
    assert torch.equal(ver["pos"], seq["pos"])
    for i in range(cfg.n_layers):
        for key, val in ver["layers"][i]["attn"].items():
            assert _same_bits(val, seq["layers"][i]["attn"][key]), (i, key)


def _chunk_edge_case(kind, ps, seed, B=4, H=32, KV=2, hd=128, qn=17):
    """Lanes around B2's chunk edges (E = pages a chunk x ps): Q = 1 lanes at
    E - 1, E and E + 1 and a retired lane; a ``qn``-token window from E - 8
    (crossing the edge), one from 2E - 4, one from 0 and a retired lane.
    Page 0 is NaN-poisoned; every lane owns the pages its positions reach;
    the table has room past the third chunk."""
    rng = np.random.RandomState(seed)
    edge = tpa.chunk_plan(1, ps, hd)[0] * ps
    T = (2 * edge + qn) // ps + 2
    P = B * T + 1
    if kind == "float32":
        pool = {"k": rng.randn(P, KV, ps, hd).astype(np.float32),
                "v": rng.randn(P, KV, ps, hd).astype(np.float32)}
        pool["k"][0] = pool["v"][0] = np.nan
    else:
        lo, hi, dt, row = ((-127, 128, np.int8, hd) if kind == "int8"
                           else (0, 256, np.uint8, hd // 2))
        pool = {"k": rng.randint(lo, hi, (P, KV, ps, row)).astype(dt),
                "v": rng.randint(lo, hi, (P, KV, ps, row)).astype(dt),
                "k_scale": (rng.rand(P, KV, ps) * 0.02 + 0.002).astype(np.float32),
                "v_scale": (rng.rand(P, KV, ps) * 0.02 + 0.002).astype(np.float32)}
        pool["k_scale"][0] = pool["v_scale"][0] = np.nan
    dev = torch.device("cuda")

    def lanes(first):
        table = np.zeros((B, T), np.int32)
        nxt = 1
        for b, p in enumerate(first):
            if p is None:
                continue
            n = (p + qn - 1) // ps + 1
            table[b, :n] = np.arange(nxt, nxt + n)
            nxt += n
        pos = np.array([0 if p is None else p for p in first], np.int32)
        return torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev)

    def inputs(q_tokens):
        return [torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(dev).to(torch.bfloat16)
                for sh in ((B, q_tokens, H, hd), (B, q_tokens, KV, hd), (B, q_tokens, KV, hd))]

    tpool = {k: torch.from_numpy(v).to(dev) for k, v in pool.items()}
    return tpool, edge, lanes, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [1, 2, 8, 16])
@pytest.mark.parametrize("kind", ["float32", "int8", "int4"])
def test_paged_attention_cuda_chunk_edges(kind, ps):
    """B2 split over chunks of pages, at the chunk edges: decode rows at
    positions E - 1, E and E + 1 (E = a chunk's positions) within
    ``B2_ATOL`` of the plain version with pools bitwise; a Q = 17 window
    crossing an edge bitwise 17 sequential Q = 1 calls (outputs and pools),
    within ``B2_ATOL`` of the plain version; the retired (all-trash) lane
    exact zeros and the NaN-poisoned trash page never read."""
    cuda_or_skip()
    pool, edge, lanes, inputs = _chunk_edge_case(kind, ps, 11 + ps)
    table, pos = lanes([edge - 1, edge, edge + 1, None])
    args = [table, pos] + inputs(1)
    want_o, want_p = tpa.paged_attention_plain(pool, *args)
    got_o, got_p = tpa.paged_attention_cuda({k: v.clone() for k, v in pool.items()}, *args)
    torch.cuda.synchronize()
    assert torch.isfinite(got_o).all() and (got_o[3] == 0).all()
    torch.testing.assert_close(got_o, want_o, atol=B2_ATOL, rtol=0)
    for key in want_p:
        assert _same_bits(got_p[key], want_p[key]), key

    qn = 17
    table, pos = lanes([edge - 8, 2 * edge - 4, 0, None])
    q, kn, vn = inputs(qn)
    want_o, want_p = tpa.paged_attention_plain(pool, table, pos, q, kn, vn)
    got_o, got_p = tpa.paged_attention_cuda({k: v.clone() for k, v in pool.items()},
                                            table, pos, q, kn, vn)
    seq_p, outs = {k: v.clone() for k, v in pool.items()}, []
    for j in range(qn):
        o, seq_p = tpa.paged_attention_cuda(seq_p, table, pos + j, q[:, j:j + 1].contiguous(),
                                            kn[:, j:j + 1].contiguous(),
                                            vn[:, j:j + 1].contiguous())
        outs.append(o)
    torch.cuda.synchronize()
    assert torch.isfinite(got_o).all() and (got_o[3] == 0).all()
    torch.testing.assert_close(got_o, want_o, atol=B2_ATOL, rtol=0)
    assert _same_bits(torch.cat(outs, 1), got_o)
    for key in want_p:
        assert _same_bits(got_p[key][1:], want_p[key][1:]), key
        assert _same_bits(seq_p[key][1:], got_p[key][1:]), key


# B5's bf16 tensor-core GEMM at (K, N) with a ragged K tail (K % 32 != 0)
# and N not a multiple of the 128-column tile. The TMA path (N % 16 == 0
# and K % 8 == 0; every serving shape takes it): (1000, 208), three splits
# of K, the last ragged, and 80 columns in the last tile; (4104, 400), 15
# splits, 16 columns in the last tile. The TMA zero-fills what lies past K,
# N and M. The path that reads global memory directly (no serving shape):
# (1000, 200) with N % 16 != 0, and (130, 336) with K % 8 != 0.
TC_SHAPES = [(1000, 208), (4104, 400), (1000, 200), (130, 336)]


def _tc_case(m, k, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((m, k), generator=g, device="cuda") * 2.0).to(torch.bfloat16)
    w8 = torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device="cuda") * 0.01 + 1e-4
    return x, w8, ws


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", TC_SHAPES)
@pytest.mark.parametrize("m", [1, 3, 8, 13, 40, 256])
def test_quant_matmul_tc_cuda(m, k, n):
    """B5's bf16 tensor-core GEMM (bf16 x): f32 outputs within the
    summation-order bound of the plain version, bf16 outputs within it plus
    one bf16 ulp, with and without x_scale; one launch counted a call; the
    same call gives the same bits."""
    cuda_or_skip()
    x, w8, ws = _tc_case(m, k, n, m * 17 + k + n)
    xsc = torch.rand((m,), device="cuda") + 0.5
    bound = WO_TOL_FACTOR * (k + 2) * 2.0 ** -24 * tref.float_matmul(x.abs(), w8.abs()) * ws
    for x_scale in (None, xsc):
        lim = bound if x_scale is None else bound * x_scale[:, None]
        n0 = tqm.launches
        got = tqm.quant_matmul_cuda(x, w8, ws, x_scale, out_dtype=torch.float32)
        want = tqm.quant_matmul_plain(x, w8, ws, x_scale, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert tqm.launches == n0 + 1
        assert torch.isfinite(got).all()
        assert ((got - want).abs() <= lim).all()
        g16 = tqm.quant_matmul_cuda(x, w8, ws, x_scale, out_dtype=torch.bfloat16).float()
        p16 = tqm.quant_matmul_plain(x, w8, ws, x_scale, out_dtype=torch.bfloat16).float()
        assert ((g16 - p16).abs() <= lim + _bf16_ulp(torch.maximum(g16.abs(), p16.abs()))).all()
        again = tqm.quant_matmul_cuda(x, w8, ws, x_scale, out_dtype=torch.float32)
        assert _same_bits(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", TC_SHAPES + [(4096, 256)])
def test_quant_matmul_tc_rows_independent_cuda(k, n):
    """The tensor-core GEMM's rows do not depend on the call's row count: 8
    rows (a decode step) bitwise the same rows inside 40- and 256-row calls
    (other token tiles, a ragged last tile, a split K meeting through the
    workspace), and a lone row bitwise its row in the 8-row call."""
    cuda_or_skip()
    x, w8, ws = _tc_case(256, k, n, k + n)
    for m in (40, 256):
        full = tqm.quant_matmul_cuda(x[:m], w8, ws, out_dtype=torch.float32)
        for lo in (0, 16, m - 8):
            eight = tqm.quant_matmul_cuda(x[lo:lo + 8].contiguous(), w8, ws,
                                          out_dtype=torch.float32)
            assert _same_bits(eight, full[lo:lo + 8]), (m, lo)
    one = tqm.quant_matmul_cuda(x[5:6].contiguous(), w8, ws, out_dtype=torch.float32)
    assert _same_bits(one, tqm.quant_matmul_cuda(x[:8], w8, ws, out_dtype=torch.float32)[5:6])


@pytest.mark.cuda
def test_quant_matmul_f32_x_takes_the_cuda_core_path(monkeypatch):
    """f32 x (no serving caller: its products are not exact in bf16) runs
    the CUDA-core weight-only entry point, bf16 x the tensor-core one."""
    cuda_or_skip()
    fns = tqm._bind()
    calls = []
    for name in ("wo", "tc"):
        monkeypatch.setitem(fns, name, lambda *a, _f=fns[name], _n=name: (calls.append(_n),
                                                                          _f(*a))[1])
    x, w8, ws = _tc_case(8, 1000, 200, 3)
    got = tqm.quant_matmul_cuda(x.float(), w8, ws, out_dtype=torch.float32)
    want = tqm.quant_matmul_plain(x.float(), w8, ws, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert calls == ["wo"]
    bound = WO_TOL_FACTOR * (1000 + 2) * 2.0 ** -24 * tref.float_matmul(x.abs(), w8.abs()) * ws
    assert ((got - want).abs() <= bound).all()
    tqm.quant_matmul_cuda(x, w8, ws)
    assert calls == ["wo", "tc"]


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [1, 2])
def test_engine_refuses_pages_the_kernel_cannot_copy_cuda(page_size):
    """A card engine refuses pages whose rows B2 cannot copy -- a head width
    not a multiple of 16 -- when it is built, not at its first decode, at
    any page size (pages of 1 and 2 rows are served: see
    test_cuda_engine_serves_short_pages_cuda)."""
    import dataclasses

    cuda_or_skip()
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServingEngine

    cfg = smoke_config("glm4-9b")
    cfg = dataclasses.replace(cfg, head_dim=24)
    params = init_params(cfg, seed=0, device="cpu")
    ecfg = EngineConfig(max_batch=2, max_len=32, page_size=page_size)
    with pytest.raises(ValueError, match="head width % 16"):
        ServingEngine(cfg, params, ecfg, device="cuda")


def _smoke_tree(matmul_mode, arch="glm4-9b"):
    """The smoke ``arch`` quantized on the CPU with the serving recipe (the
    W4A8 tier converted as the engine converts it)."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import map_with_path
    from repro_torch.core.ocs import OCSQuantLinear
    from repro_torch.models.transformer import init_params

    cfg = smoke_config(arch)
    q = quantize_params(init_params(cfg, seed=0, device="cpu"),
                        QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True,
                                    pad_to=1), device="cpu")
    if matmul_mode == "w4a8":
        q = map_with_path(lambda _p, leaf: to_w4a8(leaf, 0.05)
                          if isinstance(leaf, OCSQuantLinear) else leaf, q)
    return cfg, q


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_mode,kv_bits", [("dequant", None), ("w8a8", 8), ("w4a8", 4)])
def test_cuda_engine_serves_short_pages_cuda(matmul_mode, kv_bits):
    """A card engine with pages of 2 rows serves the smoke glm4-9b token
    for token as the CPU engine does, in each tier (float32, int8 and int4
    pages), B2 launched once a layer per decode step, and ends with the
    same allocator state."""
    cuda_or_skip()
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    cfg, q = _smoke_tree("w8a8")  # the engine converts a w4a8 tree itself
    ecfg = EngineConfig(max_batch=3, max_len=64, page_size=2, matmul_mode=matmul_mode,
                        kv_bits=kv_bits)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(5, 30))).tolist() for _ in range(4)]
    outs, allocs = [], []
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, q, ecfg, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        n0 = tpa.launches
        done = eng.run()
        if dev == "cuda":
            assert tpa.launches - n0 == cfg.n_layers * eng.stats()["decode_steps"]
        outs.append({r.uid: list(r.output) for r in done})
        a = eng.allocator
        allocs.append((a.in_use(), a.available(), dict(a._ref), a.peak_in_use))
    assert all(len(o) == 8 for o in outs[1].values())
    assert outs[1] == outs[0]
    assert allocs[1] == allocs[0]


# Card vs CPU logits of the smoke model, relative to the largest logit: the
# limit of chip_smoke.py's reference check (about one bf16 ulp of it).
MODEL_RTOL = 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_mode,kv_bits", [("dequant", None), ("w8a8", 8), ("w4a8", 4)])
@pytest.mark.parametrize("page_size", [1, 2])
def test_short_pages_logits_match_cpu_cuda(page_size, matmul_mode, kv_bits):
    """Pages of 1 and 2 rows through the whole model: the smoke glm4-9b's
    prefill into pages, 4 teacher-forced decode steps and a teacher-forced
    verify of 5 on the card (kernels) are bitwise the card's at pages of 16
    (a chunk holds the same positions at every page size) and agree with
    the CPU (plain versions) within ``MODEL_RTOL`` of the largest logit, in
    each tier. Logits, not greedy tokens: on random weights a near-tie
    flips a token at float rounding (the CPU's int4 plain version takes its
    online softmax page by page, so at pages of one row it sums in an order
    far from the kernel's)."""
    import dataclasses

    cuda_or_skip()
    from repro_torch.models import transformer as T
    from repro_torch.serving import kv_cache as kvc

    cfg, q = _smoke_tree(matmul_mode)
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    rng = np.random.default_rng(page_size)
    n, bucket = 27, 32
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :n] = rng.integers(0, cfg.vocab, n)
    follow = rng.integers(0, cfg.vocab, 4)
    window = rng.integers(0, cfg.vocab, (1, 5))

    def logits(dev, qp, ps):
        t = 64 // ps  # table width: 64 positions
        pools = [kvc.init_page_pool(cfg, t + 1, ps, device=dev) for _ in range(cfg.n_layers)]
        ids = torch.arange(1, bucket // ps + 1, dtype=torch.int32, device=dev)
        with torch.no_grad():
            lg, pools = T.prefill_into_pages(
                qp, torch.as_tensor(toks, device=dev), cfg, pools, ids,
                length=torch.tensor([n], device=dev),
                prefix_ids=torch.zeros(0, dtype=torch.int32, device=dev), mode=matmul_mode)
            out = [lg]
            caches = {"layers": [{"attn": p} for p in pools],
                      "table": torch.arange(1, t + 1, dtype=torch.int32, device=dev)[None],
                      "pos": torch.tensor([n], dtype=torch.int32, device=dev)}
            for tok in follow:
                lg, caches = T.decode_step(
                    qp, torch.tensor([[int(tok)]], dtype=torch.int32, device=dev), caches, cfg,
                    mode=matmul_mode)
                out.append(lg)
            lg, caches = T.verify_step(qp, torch.as_tensor(window, dtype=torch.int32,
                                                           device=dev), caches, cfg,
                                       mode=matmul_mode)
            out.append(lg[0])
        return torch.cat(out).float().cpu()

    cpu = logits("cpu", q, page_size)
    qc = tree_to(q, torch.device("cuda"))
    n0 = tpa.launches + tpa.launches_verify
    card = logits("cuda", qc, page_size)
    assert tpa.launches + tpa.launches_verify - n0 == 5 * cfg.n_layers
    assert torch.isfinite(card).all()
    assert _same_bits(card, logits("cuda", qc, 16))
    assert (card - cpu).abs().max().item() <= MODEL_RTOL * cpu.abs().max().item()


# B4 on the tensor cores (bf16 x, tail_mult None or declared a 0/1 mask):
# (K, S, N) on the TMA path with K % 32 != 0, S % 32 != 0 and N % 128 != 0
# (1000, 70, 208): a base stage ragged at K, tail stages ragged at S;
# (4104, 130, 400): 15 splits, one of them across base and tail stages),
# and two that read global memory directly: N % 16 != 0, and K % 8 != 0.
B4_TC_SHAPES = [(1000, 70, 208), (4104, 130, 400), (1000, 70, 200), (130, 7, 336)]


def _b4_tc_case(m, k, s, n, mult_kind, seed):
    x, w8, ws, src, mult = _ocs_case(m, k, n, s, torch.bfloat16, mult_kind, seed)
    if mult_kind == "mask":
        mult[::3] = 0.0  # zeros for sure, ones beside them
        mult[1::3] = 1.0
    return x, w8, ws, src, mult


@pytest.mark.cuda
@pytest.mark.parametrize("mult_kind", ["mask", "ones", None])
@pytest.mark.parametrize("k,s,n", B4_TC_SHAPES)
@pytest.mark.parametrize("m", [1, 3, 8, 13, 40, 256])
def test_ocs_matmul_tc_cuda(m, k, s, n, mult_kind):
    """B4's tensor-core route with the OCS tail gathered in the kernel: f32
    outputs within the summation-order bound of the plain version, bf16
    outputs within it plus one bf16 ulp, with and without x_scale; one
    launch counted a call, none on the CUDA-core route and none on B5's
    count; the same call gives the same bits."""
    cuda_or_skip()
    x, w8, ws, src, mult = _b4_tc_case(m, k, s, n, mult_kind, m * 19 + k + s + n)
    xsc = torch.rand((m,), device="cuda") + 0.5
    tail = x[:, src.long()].float() * (1.0 if mult is None else mult)
    xe = torch.cat([x.float(), tail], 1)
    bound = WO_TOL_FACTOR * (k + s + 2) * 2.0 ** -24 * tref.float_matmul(xe.abs(), w8.abs()) * ws
    for x_scale in (None, xsc):
        lim = bound if x_scale is None else bound * x_scale[:, None]
        n0 = (tom.launches, tom.launches_cuda_cores, tqm.launches)
        got = tom.ocs_quant_matmul_cuda(x, w8, ws, src, x_scale, mult, tail_is_mask=True,
                                        out_dtype=torch.float32)
        want = tom.ocs_quant_matmul_plain(x, w8, ws, src, x_scale, mult, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert (tom.launches, tom.launches_cuda_cores, tqm.launches) == (n0[0] + 1, *n0[1:])
        assert torch.isfinite(got).all()
        assert ((got - want).abs() <= lim).all()
        g16 = tom.ocs_quant_matmul_cuda(x, w8, ws, src, x_scale, mult, tail_is_mask=True,
                                        out_dtype=torch.bfloat16).float()
        p16 = tom.ocs_quant_matmul_plain(x, w8, ws, src, x_scale, mult,
                                         out_dtype=torch.bfloat16).float()
        assert ((g16 - p16).abs() <= lim + _bf16_ulp(torch.maximum(g16.abs(), p16.abs()))).all()
        again = tom.ocs_quant_matmul_cuda(x, w8, ws, src, x_scale, mult, tail_is_mask=True,
                                          out_dtype=torch.float32)
        assert _same_bits(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,n", B4_TC_SHAPES + [(4096, 82, 256), (13696, 274, 4096)])
def test_ocs_matmul_tc_rows_independent_cuda(k, s, n):
    """B4's tensor-core rows do not depend on the call's row count: 8 rows
    (a decode step) bitwise the same rows inside 40- and 256-row calls, and
    a lone row bitwise its row in the 8-row call; none of them on the
    CUDA-core route."""
    cuda_or_skip()
    x, w8, ws, src, mult = _b4_tc_case(256, k, s, n, "mask", k + s + n)

    def call(xx):
        return tom.ocs_quant_matmul_cuda(xx, w8, ws, src, tail_mult=mult, tail_is_mask=True,
                                         out_dtype=torch.float32)

    n0 = tom.launches_cuda_cores
    for m in (40, 256):
        full = call(x[:m])
        for lo in (0, 16, m - 8):
            assert _same_bits(call(x[lo:lo + 8].contiguous()), full[lo:lo + 8]), (m, lo)
    assert _same_bits(call(x[5:6].contiguous()), call(x[:8])[5:6])
    assert tom.launches_cuda_cores == n0


@pytest.mark.cuda
def test_ocs_matmul_other_multipliers_take_the_cuda_core_path(monkeypatch):
    """bf16 x with a fractional multiplier (0.5: the product need not be
    exact in bf16), with a mask not declared one (the route reads nothing
    back), or f32 x, runs B4's CUDA-core entry point and is counted there,
    within the summation-order bound, also at glm4-9b's ``w_down`` shape;
    bf16 x with a declared mask runs the tensor-core one."""
    cuda_or_skip()
    fns = tom._bind()
    calls = []
    for name in ("wo", "tc"):
        monkeypatch.setitem(fns, name, lambda *a, _f=fns[name], _n=name: (calls.append(_n),
                                                                          _f(*a))[1])
    n0 = tom.launches_cuda_cores
    for m, k, n, s in ((8, 1000, 208, 70), (8, 13696, 4096, 274)):
        x, w8, ws, src, half = _ocs_case(m, k, n, s, torch.bfloat16, "half", 5)
        got = tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=half, out_dtype=torch.float32)
        want = tom.ocs_quant_matmul_plain(x, w8, ws, src, tail_mult=half,
                                          out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert calls[-1:] == ["wo"]
        xe = torch.cat([x.float(), x[:, src.long()].float() * half], 1)
        bound = (WO_TOL_FACTOR * (k + s + 2) * 2.0 ** -24
                 * tref.float_matmul(xe.abs(), w8.abs()) * ws)
        assert torch.isfinite(got).all() and ((got - want).abs() <= bound).all()
    assert calls == ["wo", "wo"] and tom.launches_cuda_cores == n0 + 2
    mask = (half != 0.5).float()
    tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mask, tail_is_mask=True)
    tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mask)
    tom.ocs_quant_matmul_cuda(x.float(), w8, ws, src, tail_mult=mask, tail_is_mask=True)
    assert calls == ["wo", "wo", "tc", "wo", "wo"] and tom.launches_cuda_cores == n0 + 4


def _paged(logical, blocks, ps):
    """Lay per-lane logical rows out in pages of ``ps`` rows: ``logical``
    maps pool keys to ``[B, KV, L, ...]`` arrays; lane b owns its first
    ``blocks[b]`` x 16 positions, page by page in order, the rest of its
    table is the trash page 0 (NaN in float values and in scales, zeros in
    int values). Returns (pool, table) on the card."""
    b, kvh, length = logical["k"].shape[:3]
    t = length // ps
    table = np.zeros((b, t), np.int32)
    nxt = 1
    for lane in range(b):
        n = blocks[lane] * 16 // ps
        table[lane, :n] = np.arange(nxt, nxt + n)
        nxt += n
    pool = {}
    for key, arr in logical.items():
        out = np.zeros((nxt, kvh, ps) + arr.shape[3:], arr.dtype)
        if arr.dtype == np.float32:
            out[0] = np.nan
        for lane in range(b):
            for i in range(blocks[lane] * 16 // ps):
                out[table[lane, i]] = arr[lane, :, i * ps:(i + 1) * ps]
        pool[key] = torch.from_numpy(out).cuda()
    return pool, torch.from_numpy(table).cuda()


def _logical(pool, table, ps, blocks):
    """The readable rows of each lane back in logical order (``_paged``'s
    inverse): key -> [B, KV, 16 * max(blocks), ...], zeros past a lane's."""
    got = {}
    for key, arr in pool.items():
        arr, tab = arr.cpu(), table.cpu()
        rows = torch.zeros((tab.shape[0], arr.shape[1], 16 * max(blocks)) + arr.shape[3:],
                           dtype=arr.dtype)
        for lane in range(tab.shape[0]):
            for i in range(blocks[lane] * 16 // ps):
                rows[lane, :, i * ps:(i + 1) * ps] = arr[tab[lane, i]]
        got[key] = rows
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 16])
@pytest.mark.parametrize("qn", [1, 5])
@pytest.mark.parametrize("ps", [1, 2])
@pytest.mark.parametrize("kind", ["float32", "int8", "int4"])
def test_paged_attention_cuda_short_pages(kind, ps, qn, hd):
    """B2 on pages of 1 and 2 rows (their f32 scales copied 4 bytes a
    piece; an int4 page of one 16-channel row, 8 bytes, in 8-byte pieces),
    over three chunks of positions, with the KV scales of ``chip_smoke``'s
    cases (at which ``B2_ATOL`` was measured): pools bitwise the plain
    version's (the trash page, which several rows write, aside), outputs
    within ``B2_ATOL``, the retired lane exact zeros, every row bitwise the
    sequential Q = 1 launches; and outputs and appended rows bitwise those
    of the same rows laid out in pages of 16 (a chunk holds the same
    positions at every page size, so the page size changes no row's
    arithmetic)."""
    cuda_or_skip()
    rng = np.random.RandomState(ps * 10 + qn + hd)
    B, KV, H = 4, 2, 32 if hd == 128 else 4
    length = 3 * tpa.chunk_plan(1, 16, hd)[0] * 16  # three chunks of positions
    blocks = [2, length // 16, 1, 0]  # lane 3 retired (all trash)
    if kind == "float32":
        logical = {"k": rng.randn(B, KV, length, hd).astype(np.float32),
                   "v": rng.randn(B, KV, length, hd).astype(np.float32)}
    else:
        lo, hi, dt, row = ((-127, 128, np.int8, hd) if kind == "int8"
                           else (0, 256, np.uint8, hd // 2))
        logical = {"k": rng.randint(lo, hi, (B, KV, length, row)).astype(dt),
                   "v": rng.randint(lo, hi, (B, KV, length, row)).astype(dt),
                   "k_scale": (rng.rand(B, KV, length) * 0.02 + 0.002).astype(np.float32),
                   "v_scale": (rng.rand(B, KV, length) * 0.02 + 0.002).astype(np.float32)}
    pos = torch.tensor([19, length - qn - 1, 0, 0], dtype=torch.int32, device="cuda")
    q, kn, vn = [torch.from_numpy(rng.randn(*sh).astype(np.float32)).cuda().to(torch.bfloat16)
                 for sh in ((B, qn, H, hd), (B, qn, KV, hd), (B, qn, KV, hd))]
    pool, table = _paged(logical, blocks, ps)
    want_o, want_p = tpa.paged_attention_plain(pool, table, pos, q, kn, vn)
    got_o, got_p = tpa.paged_attention_cuda({k: v.clone() for k, v in pool.items()},
                                            table, pos, q, kn, vn)
    seq_p, outs = {k: v.clone() for k, v in pool.items()}, []
    for j in range(qn):
        o, seq_p = tpa.paged_attention_cuda(seq_p, table, pos + j, q[:, j:j + 1].contiguous(),
                                            kn[:, j:j + 1].contiguous(),
                                            vn[:, j:j + 1].contiguous())
        outs.append(o)
    pool16, table16 = _paged(logical, blocks, 16)
    o16, p16 = tpa.paged_attention_cuda(pool16, table16, pos, q, kn, vn)
    torch.cuda.synchronize()
    assert torch.isfinite(got_o).all() and (got_o[3] == 0).all()
    torch.testing.assert_close(got_o, want_o, atol=B2_ATOL, rtol=0)
    assert _same_bits(torch.cat(outs, 1), got_o)
    for key in want_p:  # the trash page, which several rows write, aside
        assert _same_bits(got_p[key][1:], want_p[key][1:]), key
        assert _same_bits(seq_p[key][1:], got_p[key][1:]), key
    assert _same_bits(got_o, o16)
    short, sixteen = _logical(got_p, table, ps, blocks), _logical(p16, table16, 16, blocks)
    for key in short:
        assert _same_bits(short[key], sixteen[key]), key


# glm4-9b's linear shapes (K, N) for the tensor-core GEMM's two tiles (B5,
# S = 0; B4 with the serving recipe's tails, S = 82, 274 at w_down), and
# ragged ones (K % 32 != 0, S % 32 != 0, N % 128 != 0) that take the prefill
# tile when its tile threshold is lowered.
WO_TILE_SHAPES = {"wq/wo": (4096, 82, 4096), "wk/wv": (4096, 82, 256),
                  "w_gate/w_up": (4096, 82, 13696), "w_down": (13696, 274, 4096),
                  "lm_head": (4096, 82, 151552)}
WO_TILE_RAGGED = [(1000, 70, 208), (4104, 130, 400)]
WO_TILE_MS = (24, 40, 63, 64, 65, 128, 256, 512)


def _wo_tile_rows_check(k, s, n, b4, seed, mult_kind="mask"):
    """Rows of calls of every WO_TILE_MS row count, whichever tile each takes,
    bitwise the same rows of 8-row calls (the decode tile) and of one-row
    calls; returns the tiles taken."""
    x, w8, ws, src, mult = _b4_tc_case(512, k, s, n, mult_kind, seed)
    x[3] = -0.0  # a row of negative zeros
    if not b4:
        w8 = w8[:k].contiguous()

    def call(xx):
        if b4:
            return tom.ocs_quant_matmul_cuda(xx, w8, ws, src, tail_mult=mult, tail_is_mask=True,
                                             out_dtype=torch.float32)
        return tqm.quant_matmul_cuda(xx, w8, ws, out_dtype=torch.float32)

    eight = torch.cat([call(x[lo:lo + 8].contiguous()) for lo in range(0, 512, 8)])
    ones = {r: call(x[r:r + 1].contiguous()) for r in (0, 3, 63, 64, 255, 511)}
    tiles = set()
    for m in WO_TILE_MS:
        tiles.add(tqm.tc_plan(m, k, tqm.tc_rows(k, s if b4 else 0), n, tqm._MAX_PART_BYTES)[0])
        full = call(x[:m])
        assert _same_bits(full, eight[:m]), (k, s, n, b4, m)
        for r, one in ones.items():
            if r < m:
                assert _same_bits(full[r:r + 1], one), (k, s, n, b4, m, r)
    return tiles


@pytest.mark.cuda
@pytest.mark.parametrize("b4", [False, True], ids=["B5", "B4"])
@pytest.mark.parametrize("name", list(WO_TILE_SHAPES))
def test_wo_tiles_rows_bitwise_the_decode_tile_cuda(name, b4):
    """At every glm4-9b shape, for B5 and B4, the rows of calls of 24 to 512
    rows are bitwise those of 8-row calls (the decode tile's) and of one-row
    calls, across the prefill tile's thresholds (M0 = 64 rows and its tile
    count): the prefill tile walks the splits in time, the decode tile
    splits in space, and both sum every element in the decode tile's
    order."""
    cuda_or_skip()
    k, s, n = WO_TILE_SHAPES[name]
    tiles = _wo_tile_rows_check(k, s, n, b4, k + s + n)
    assert (tqm.TC_PREFILL in tiles) == (name != "wk/wv") and tqm.TC_DECODE in tiles


@pytest.mark.cuda
@pytest.mark.parametrize("b4,mult_kind", [(False, None), (True, "mask"), (True, None)],
                         ids=["B5", "B4-mask", "B4-no-multipliers"])
@pytest.mark.parametrize("k,s,n", WO_TILE_RAGGED)
def test_wo_prefill_tile_ragged_rows_bitwise_the_decode_tile_cuda(monkeypatch, k, s, n, b4,
                                                                  mult_kind):
    """With the prefill tile's tile threshold at 1, shapes ragged in K, S and
    N take it from M0 on: their rows, the tail stages' gathered tokens (a
    0/1 mask or no multipliers) and the zeros past K included, are bitwise
    those of 8-row and one-row calls."""
    cuda_or_skip()
    monkeypatch.setattr(tqm, "_TC_PREFILL_MIN_TILES", 1)
    tiles = _wo_tile_rows_check(k, s, n, b4, k + s + n + 1, mult_kind)
    assert tiles == {tqm.TC_DECODE, tqm.TC_PREFILL}  # below M0, and from it on


@pytest.mark.cuda
@pytest.mark.parametrize("b4", [False, True], ids=["B5", "B4"])
def test_wo_tiles_launch_scratch_and_graph_replay_cuda(b4):
    """A prefill-tile call (wq/wo at M = 256) is one launch that needs no
    workspace and no counter, and replays bitwise from a CUDA graph; a
    decode-tile call with its splits in space (wk/wv at M = 256) leaves
    the split-K counters at zero, reuses its kept scratch and replays
    bitwise from a CUDA graph."""
    from repro_torch.kernels import scratch

    cuda_or_skip()
    for name, tile in (("wq/wo", tqm.TC_PREFILL), ("wk/wv", tqm.TC_DECODE)):
        k, s, n = WO_TILE_SHAPES[name]
        x, w8, ws, src, mult = _b4_tc_case(256, k, s, n, "mask", 5)
        s = s if b4 else 0
        w8 = w8[:k + s].contiguous()

        def call():
            if b4:
                return tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult,
                                                 tail_is_mask=True, out_dtype=torch.bfloat16)
            return tqm.quant_matmul_cuda(x, w8, ws, out_dtype=torch.bfloat16)

        plan = tqm.tc_plan(256, k, tqm.tc_rows(k, s), n, tqm._MAX_PART_BYTES)
        assert plan[0] == tile and (plan[4] == 0) == (tile == tqm.TC_PREFILL)
        first = call()
        kept = {key: buf.data_ptr() for key, buf in scratch._bufs.items()}
        n0 = tom.launches + tqm.launches
        again = call()
        assert tom.launches + tqm.launches == n0 + 1
        assert _same_bits(again, first)
        assert {key: buf.data_ptr() for key, buf in scratch._bufs.items()} == kept
        torch.cuda.synchronize()
        counters = scratch._bufs.get(("split_k_counters", x.device))
        if counters is not None:
            assert int(counters.count_nonzero()) == 0
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = call()
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(replayed, first), name
        if counters is not None:
            assert int(counters.count_nonzero()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile,n,k", [(1, 200, 4096), (1, 256, 4100), (2, 256, 4096)])
def test_wo_prefill_tile_refuses_what_it_cannot_take_cuda(tile, n, k):
    """B5's entry point refuses a prefill-tile call the TMA cannot take (N %
    16 != 0, K % 8 != 0) or an unknown tile with cudaErrorInvalidValue (1)
    and launches nothing; the wrapper raises on any nonzero code."""
    cuda_or_skip()
    x = torch.zeros((64, k), dtype=torch.bfloat16, device="cuda")
    w8 = torch.zeros((k, n), dtype=torch.int8, device="cuda")
    ws = torch.ones(n, device="cuda")
    out = torch.full((64, n), 7.0, device="cuda")
    k_chunk, nsplit = tqm.tc_split_plan(k, n)
    err = tqm._bind()["tc"](x.data_ptr(), 1, 64, k, w8.data_ptr(), None, ws.data_ptr(), n,
                            k_chunk, nsplit, tile, None, None, out.data_ptr(), 0,
                            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 1
    assert bool((out == 7.0).all())


def _serve_cuda(cfg, q, reqs, **conf):
    """Serve ``reqs`` on a card engine; returns (engine, {uid: tokens})."""
    from repro_torch.serving import EngineConfig, ServingEngine

    eng = ServingEngine(cfg, q, EngineConfig(**conf), device="cuda")
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, {r.uid: list(r.output) for r in reqs}


def _lifecycle_reqs(cfg, seed, lengths, max_new, sampled=()):
    from repro_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_new_tokens=max_new,
                    sampling=(SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=i)
                              if i in sampled else None))
            for i, n in enumerate(lengths)]


@pytest.mark.cuda
def test_sampled_lane_solo_vs_batched_cuda():
    """A sampled request draws bitwise the same tokens on the card alone
    and beside other lanes (its draws depend on its seed and positions
    only; every kernel's row is independent of the batch)."""
    cuda_or_skip()
    cfg, q = _smoke_tree("w8a8")
    conf = dict(max_len=64, page_size=8, matmul_mode="w8a8", kv_bits=8)
    reqs = _lifecycle_reqs(cfg, 4, (9, 14, 6), 10, sampled=(0, 1, 2))
    _, batched = _serve_cuda(cfg, q, reqs, max_batch=3, **conf)
    for r in _lifecycle_reqs(cfg, 4, (9, 14, 6), 10, sampled=(0, 1, 2)):
        _, solo = _serve_cuda(cfg, q, [r], max_batch=1, **conf)
        assert solo[r.uid] == batched[r.uid]
    assert len({tuple(t) for t in batched.values()}) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_mode,kv_bits", [("dequant", None), ("w8a8", 8)])
def test_greedy_lanes_of_a_mixed_batch_cuda(matmul_mode, kv_bits):
    """Greedy lanes beside sampled ones give bitwise the tokens of a
    greedy-only batch of the same requests, and the sampler runs on the
    card only for steps with a sampled lane."""
    cuda_or_skip()
    from repro_torch.serving import sampling

    cfg, q = _smoke_tree("w8a8")
    conf = dict(max_batch=4, max_len=64, page_size=8, matmul_mode=matmul_mode,
                kv_bits=kv_bits)
    lengths = (7, 12, 20, 5)
    _, greedy = _serve_cuda(cfg, q, _lifecycle_reqs(cfg, 6, lengths, 12), **conf)
    calls = []
    real = sampling.sample_tokens

    def spy(logits, samp, pos):
        assert logits.is_cuda and pos.is_cuda
        calls.append(logits.shape[0])
        return real(logits, samp, pos)

    sampling.sample_tokens = spy
    try:
        _, mixed = _serve_cuda(cfg, q, _lifecycle_reqs(cfg, 6, lengths, 12, sampled=(1, 3)),
                               **conf)
    finally:
        sampling.sample_tokens = real
    assert mixed[0] == greedy[0] and mixed[2] == greedy[2]
    assert calls and set(calls) <= {1, 4}


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_mode,kernel", [("dequant", "ocs"), ("w8a8", "fused")])
def test_chunked_prefill_launch_count_cuda(matmul_mode, kernel):
    """Budgeted chunked prefill on the card: every chunk is one prefill
    call, the mode's matmul kernel runs 7*L+1 times per decode step and per
    prefill call, B2 L times per decode step (mid-prefill lanes ride the
    decode step's launch), and every page comes back."""
    cuda_or_skip()
    cfg, q = _smoke_tree("w8a8")
    mod = {"ocs": tom, "fused": tfq}[kernel]
    reqs = _lifecycle_reqs(cfg, 7, (40, 7, 23), 8)
    for m in (tom, tfq, tqm, tw4, tpa):
        m.reset_launches()
    eng, _ = _serve_cuda(cfg, q, reqs, max_batch=3, max_len=96, page_size=8,
                         matmul_mode=matmul_mode, kv_bits=8 if matmul_mode == "w8a8" else None,
                         prefill_budget=16, chunk_size=16)
    s = eng.stats()
    L = cfg.n_layers
    assert s["prefill_calls"] == s["sched_chunks"] == 3 + 1 + 2
    assert s["sched_peak_step_prefill_tokens"] <= 16
    assert mod.launches == (7 * L + 1) * (s["decode_steps"] + s["prefill_calls"])
    assert tpa.launches == L * s["decode_steps"]
    others = [m for m in (tom, tfq, tqm, tw4) if m is not mod]
    assert all(m.launches == 0 for m in others)
    assert eng.allocator.in_use() == 0
    assert all(r.finish_reason == "length" and len(r.output) == 8 for r in reqs)


@pytest.mark.cuda
def test_preempt_resume_cycle_cuda():
    """Optimistic admission on a pool too small for the lanes' growth: the
    card engine preempts, resumes by re-prefilling only the prompt past its
    prefix hits and replaying the committed tokens through the decode path
    (B2's Q > 1 rows when the tail is longer than one token; every call
    counted in the launches), finishes every request token for token as the
    uncontended card engine does, and ends with the allocator empty."""
    cuda_or_skip()
    cfg, q = _smoke_tree("w8a8")
    conf = dict(max_batch=3, max_len=96, page_size=8, matmul_mode="w8a8", kv_bits=8)
    _, want = _serve_cuda(cfg, q, _lifecycle_reqs(cfg, 7, (7, 5, 3), 20), **conf)
    reqs = _lifecycle_reqs(cfg, 7, (7, 5, 3), 20)
    for m in (tom, tfq, tpa):
        m.reset_launches()
    eng, got = _serve_cuda(cfg, q, reqs, n_pages=9, admission="optimistic", **conf)
    s = eng.stats()
    L = cfg.n_layers
    reps = eng.replay_lengths
    assert s["preempted"] >= 1 and reps
    assert s["prefill_calls"] <= 3 + s["preempted"]
    assert got == want
    assert tfq.launches == (7 * L + 1) * (s["decode_steps"] + s["prefill_calls"] + len(reps))
    assert tpa.launches == L * (s["decode_steps"] + sum(1 for n in reps if n == 1))
    assert tpa.launches_verify == L * sum(1 for n in reps if n > 1)
    a = eng.allocator
    assert a.in_use() == 0 and a.available() == a.capacity
    assert a.peak_in_use <= a.capacity
    assert all(r.finish_reason == "length" and len(r.output) == 20 for r in reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_mode,kv_bits", [("dequant", None), ("w8a8", 8),
                                                 ("w4a8", 4)])
def test_drift_sample_restores_pools_cuda(matmul_mode, kv_bits):
    """On the card a decode step appends to the pools in place: a drift
    sample restores the rows it wrote, so every pool byte and the positions
    are unchanged, and an engine sampling every step gives the tokens of
    one that never samples."""
    cuda_or_skip()
    from repro_torch.serving import EngineConfig, ServingEngine

    cfg, q = _smoke_tree("w8a8")
    conf = dict(max_batch=3, max_len=64, page_size=8, matmul_mode=matmul_mode,
                kv_bits=kv_bits)
    eng = ServingEngine(cfg, q, EngineConfig(drift_every=1000, **conf), device="cuda")
    for r in _lifecycle_reqs(cfg, 3, (5, 9), 10):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    before = [{k: t.clone() for k, t in layer["attn"].items()} for layer in eng.caches["layers"]]
    pos = eng.caches["pos"].clone()
    eng._drift_sample()
    torch.cuda.synchronize()
    assert eng._drift.samples == 1 and not eng._drift_broken
    for layer, old in zip(eng.caches["layers"], before):
        for k, t in layer["attn"].items():
            assert _same_bits(t, old[k]), k
    assert torch.equal(eng.caches["pos"], pos)
    _, want = _serve_cuda(cfg, q, _lifecycle_reqs(cfg, 3, (5, 9, 4), 10), **conf)
    _, got = _serve_cuda(cfg, q, _lifecycle_reqs(cfg, 3, (5, 9, 4), 10), drift_every=1, **conf)
    assert got == want


@pytest.mark.cuda
def test_router_kill_migrate_exact_cuda():
    """Two card replicas sharing one tree: a replica killed mid-decode
    hands its lanes to the survivor, which resumes them bit-exactly (the
    single-engine oracle's tokens), and no page leaks."""
    cuda_or_skip()
    from repro_torch.serving import EngineConfig, ReplicaSet, Router, RouterConfig

    cfg, q = _smoke_tree("w8a8")
    conf = dict(max_batch=2, max_len=64, page_size=8, matmul_mode="w8a8", kv_bits=8)
    _, want = _serve_cuda(cfg, q, _lifecycle_reqs(cfg, 7, (7, 5, 3, 6), 10), **conf)
    reqs = _lifecycle_reqs(cfg, 7, (7, 5, 3, 6), 10)
    router = Router(ReplicaSet.build(cfg, q, EngineConfig(**conf), 2, device="cuda"),
                    RouterConfig(placement="round_robin"))
    p0 = router.replicas[0].engine.params["layers"]["mlp"]["w_up"].weight.values
    p1 = router.replicas[1].engine.params["layers"]["mlp"]["w_up"].weight.values
    assert p0.data_ptr() == p1.data_ptr()
    for r in reqs:
        router.submit(r)
    for _ in range(4):
        router.step()
    router.kill(0)
    router.run()
    assert router.stats()["router_migrated"] >= 1
    assert {r.uid: list(r.output) for r in reqs} == want
    for rep in router.replicas:
        a = rep.engine.allocator
        assert a.in_use() + a.available() == a.capacity


# The expert axis: a MoE layer's stacked matrices, one launch over all E
# experts. deepseek-moe-16b's expert shapes (K, N) = (2048, 1408) and
# (1408, 2048) with S as the serving recipe leaves it (r = 0.02), E = 64 at
# C = 8 (decode) and E = 8 at larger capacities (verify 40, a prefill bucket
# of 72 rows: the 64-token tiles and a ragged last tile), and a small stack
# whose N = 72 is stored zero-padded to 80 (as ``core.ocs.pad_out_cols``
# stores a leaf's columns).
STACK_CASES = [(64, 8, 2048, 41, 1408), (64, 8, 1408, 29, 2048), (8, 32, 2048, 41, 1408),
               (8, 72, 1408, 29, 2048), (4, 40, 296, 7, 72)]


def _stack_case(e, c, k, s, n, seed, *, w4a8=False):
    """Random stacked operands: x [E, C, K] bf16 with its last rows zero
    (empty capacity slots) and expert 1 all zero; int8 weights [E, K+S, N]
    with [E, N] scales and [E, S] tails whose last entry is a pad row (src
    0, mult 0, zero weights); or W4A8 operands with [E, T] outlier rows. An
    N that is not a multiple of 16 is stored with zero columns (weights and
    scales) up to the next one, as ``core.ocs.pad_out_cols`` stores it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    npad = tqm.padded_cols(n, 16)
    x = (torch.randn((e, c, k), generator=g, device="cuda") * 2.0).to(torch.bfloat16)
    x[:, c - 3:] = 0
    x[1] = 0
    src = torch.randint(0, k, (e, s), generator=g, device="cuda", dtype=torch.int32)
    src[:, -1] = 0
    if w4a8:
        ke = k + s + (k + s) % 2
        if ke > k + s:
            src = torch.cat([src, torch.zeros((e, 1), dtype=torch.int32, device="cuda")], 1)
        t = max(1, (ke * 5) // 100)
        w4 = torch.randint(0, 256, (e, ke // 2, n), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
        s4 = torch.rand((e, n), generator=g, device="cuda") * 0.01 + 1e-4
        w8 = torch.randint(-127, 128, (e, t, n), generator=g, device="cuda", dtype=torch.int8)
        s8 = torch.rand((e, n), generator=g, device="cuda") * 0.001 + 1e-5
        oidx = torch.stack([torch.sort(torch.randperm(ke, generator=g, device="cuda")[:t]).values
                            for _ in range(e)]).to(torch.int32)
        w4, s4, w8, s8 = (tqm.pad_cols(a, npad) for a in (w4, s4, w8, s8))
        return x, (w4, s4, w8, s8, src, oidx)
    w8 = torch.randint(-127, 128, (e, k + s, n), generator=g, device="cuda", dtype=torch.int8)
    w8[:, -1] = 0
    ws = torch.rand((e, n), generator=g, device="cuda") * 0.01 + 1e-4
    mult = torch.ones((e, s), device="cuda")
    mult[:, -1] = 0
    return x, (tqm.pad_cols(w8, npad), tqm.pad_cols(ws, npad), src, mult)


def _stack_calls(kind, x, ops, out_dtype):
    """``(stacked call, [2-D call of expert e], plain stacked call)`` of one
    kernel on one stack."""
    if kind == "b1":
        w8, ws, src, _ = ops
        return (lambda: tfq.fused_quant_matmul_cuda(x, w8, ws, src, out_dtype=out_dtype),
                [lambda i=i: tfq.fused_quant_matmul_cuda(x[i], w8[i], ws[i], src[i],
                                                         out_dtype=out_dtype)
                 for i in range(x.shape[0])],
                lambda: tfq.fused_quant_matmul_plain(x, w8, ws, src, out_dtype=out_dtype))
    if kind == "b6":
        return (lambda: tw4.w4a8_matmul_cuda(x, *ops, out_dtype=out_dtype),
                [lambda i=i: tw4.w4a8_matmul_cuda(x[i], *(o[i] for o in ops),
                                                  out_dtype=out_dtype)
                 for i in range(x.shape[0])],
                lambda: tw4.w4a8_matmul_plain(x, *ops, out_dtype=out_dtype))
    w8, ws, src, mult = ops
    k = x.shape[2]
    if kind == "b5":
        w8 = w8[:, :k].contiguous()
        return (lambda: tqm.quant_matmul_cuda(x, w8, ws, out_dtype=out_dtype),
                [lambda i=i: tqm.quant_matmul_cuda(x[i], w8[i], ws[i], out_dtype=out_dtype)
                 for i in range(x.shape[0])],
                lambda: tqm.quant_matmul_plain(x, w8, ws, out_dtype=out_dtype))
    return (lambda: tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult, tail_is_mask=True,
                                              out_dtype=out_dtype),
            [lambda i=i: tom.ocs_quant_matmul_cuda(x[i], w8[i], ws[i], src[i],
                                                   tail_mult=mult[i], tail_is_mask=True,
                                                   out_dtype=out_dtype)
             for i in range(x.shape[0])],
            lambda: tom.ocs_quant_matmul_plain(x, w8, ws, src, tail_mult=mult, tail_is_mask=True,
                                               out_dtype=out_dtype))


def _force_tile(monkeypatch, tile):
    """Make ``quant_matmul.tc_plan`` give ``tile`` (None: its own choice);
    operands the prefill tile's TMA cannot take stay on the decode tile."""
    if tile is None:
        return
    plan = tqm.tc_plan

    def forced(m, k, kv, n, max_part):
        if tile == tqm.TC_PREFILL and n % 16 == 0 and k % 8 == 0:  # what its TMA takes
            return (tqm.TC_PREFILL, *tqm.tc_split_plan(kv, n), m, 0, 0)
        return (tqm.TC_DECODE, *tqm._tc_launch_plan(m, kv, n, max_part))

    monkeypatch.setattr(tqm, "tc_plan", forced)
    assert plan(8, 2048, 2048, 1408, tqm._MAX_PART_BYTES)[0] == tqm.TC_DECODE


# (kernel, tile): B1 and B6 have one plan (their integer sums are exact in
# any order); B4 and B5 run planned and on each of their two tiles.
STACK_KINDS = [("b4", None), ("b4", 0), ("b4", 1), ("b5", None), ("b5", 0), ("b5", 1),
               ("b1", None), ("b6", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STACK_CASES, ids=lambda c: "E{}-C{}-K{}-N{}".format(*c[:3], c[4]))
@pytest.mark.parametrize("kind,tile", STACK_KINDS,
                         ids=lambda v: {None: "planned", 0: "decode-tile",
                                        1: "prefill-tile"}.get(v, v))
def test_expert_stack_bitwise_per_slice_cuda(kind, tile, case, monkeypatch):
    """One launch over an expert stack (one count) is, expert by expert,
    bitwise the 2-D launch on that expert's slice, f32 and bf16 outputs,
    zero rows and an all-zero expert included (finite, and zero); against
    the plain stacked call bitwise for B1 and B6, within the weight-only
    bound for B4 and B5 (both of their tiles)."""
    cuda_or_skip()
    _force_tile(monkeypatch, tile)
    e, c, k, s, n = case
    x, ops = _stack_case(e, c, k, s, n, e * 1000 + c + k, w4a8=kind == "b6")
    mod = {"b4": tom, "b5": tqm, "b1": tfq, "b6": tw4}[kind]
    for out_dtype in (torch.float32, torch.bfloat16):
        stacked, per_expert, plain = _stack_calls(kind, x, ops, out_dtype)
        n0, s0 = mod.launches, mod.launches_stack
        got = stacked()
        torch.cuda.synchronize()
        assert (mod.launches, mod.launches_stack) == (n0 + 1, s0 + 1)
        assert got.shape == (e, c, tqm.padded_cols(n, 16)) and bool(torch.isfinite(got).all())
        assert bool((got[:, c - 3:] == 0).all()) and bool((got[1] == 0).all())
        for i, one in enumerate(per_expert):
            assert _same_bits(got[i], one()), (out_dtype, i)
        want = plain()
        if kind in ("b1", "b6"):
            assert _same_bits(got, want)
        else:
            w8 = ops[0] if kind == "b4" else ops[0][:, :k]
            ws = ops[1]
            xe = x.float()
            if kind == "b4":
                tail = torch.gather(xe, 2, ops[2].long()[:, None, :].expand(e, c, s))
                xe = torch.cat([xe, tail * ops[3][:, None, :]], 2)
            bound = WO_TOL_FACTOR * (xe.shape[2] + 2) * 2.0 ** -24 * torch.stack(
                [tref.float_matmul(xe[i].abs(), w8[i].abs()) for i in range(e)]) * ws[:, None, :]
            if out_dtype == torch.bfloat16:
                bound = bound + _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
            assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.cuda
def test_expert_stack_refuses_cuda():
    """A stacked call the kernels do not take raises before any launch: f32
    x on B4/B5 (their CUDA-core route has no stack), K % 8 != 0 on B4/B5
    (the stacked launch reads x through the TMA only), mismatched expert
    counts, undeclared tail multipliers."""
    cuda_or_skip()
    x, (w8, ws, src, mult) = _stack_case(4, 8, 296, 7, 72, 0)
    xr, (w8r, wsr, srcr, multr) = _stack_case(4, 8, 300, 7, 72, 0)
    n0 = (tom.launches, tqm.launches, tfq.launches)
    with pytest.raises(ValueError):
        tom.ocs_quant_matmul_cuda(x.float(), w8, ws, src, tail_mult=mult, tail_is_mask=True)
    with pytest.raises(ValueError):
        tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult)  # not declared a mask
    with pytest.raises(ValueError, match="K % 8"):
        tom.ocs_quant_matmul_cuda(xr, w8r, wsr, srcr, tail_mult=multr, tail_is_mask=True)
    with pytest.raises(ValueError, match="K % 8"):
        tqm.quant_matmul_cuda(xr, w8r[:, :300].contiguous(), wsr)
    with pytest.raises(ValueError):
        tfq.fused_quant_matmul_cuda(x[:3], w8, ws, src)
    with pytest.raises(ValueError):
        tqm.quant_matmul_cuda(x, w8[:, :296].contiguous(), ws[:2])
    assert (tom.launches, tqm.launches, tfq.launches) == n0


# A MoE replay's K/V rows on the card against the CPU's, of the largest.
MOE_KV_RTOL = 0.01


@pytest.mark.cuda
def test_moe_replay_routes_the_bucket_cuda(monkeypatch):
    """A MoE resume replay on the card (the phi3.5-moe smoke config,
    dequant, float32 pages), every token forced onto the first k experts
    so capacity decides the drops: a 40-token tail runs as the reference's
    64-row bucket with that bucket's capacity, one stacked launch per
    expert matrix and layer, and writes the tail's K/V rows as the CPU
    engine's replay does, within ``MOE_KV_RTOL``."""
    cuda_or_skip()
    from repro_torch.models import moe
    from repro_torch.serving import EngineConfig, ServingEngine

    cfg, q = _smoke_tree("dequant", "phi3.5-moe-42b-a6.6b")
    L = cfg.n_layers
    own_dispatch = moe.dispatch
    rows = []

    def forced(router_w, xf, k):
        probs = torch.softmax(xf.float() @ router_w.float(), -1)
        gate = probs[:, :k]
        idx = torch.arange(k, device=xf.device).expand(xf.shape[0], k)
        return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), idx

    def counting(top_idx, n_experts, cap):
        rows.append((top_idx.shape[0], cap))
        return own_dispatch(top_idx, n_experts, cap)

    monkeypatch.setattr(moe, "route", forced)
    monkeypatch.setattr(moe, "dispatch", counting)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, 40).astype(np.int32)
    pages = list(range(1, 9))
    kv = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, q, EngineConfig(max_batch=2, max_len=128, page_size=16,
                                                 matmul_mode="dequant", kv_bits=None),
                            device=dev)
        eng._set_row(0, pages)
        for m in (tom, tqm):
            m.reset_launches()
        eng._run_replay(0, toks, 0)
        assert eng.replay_lengths == [64]
        kv[dev] = [torch.stack([lay["attn"][name][pages].float().cpu() for name in ("k", "v")])
                   for lay in eng.caches["layers"]]
    assert tom.launches_stack + tqm.launches_stack == 3 * L
    cap = moe.capacity(64, cfg.moe.top_k, cfg.moe.capacity_factor, cfg.moe.n_experts)
    assert rows == [(64, cap)] * (2 * L)
    for want, got in zip(kv["cpu"], kv["cuda"]):
        # [2, pages, KV, ps, hd] -> [2, positions, KV, hd], the tail's rows
        want = want.transpose(2, 3).reshape(2, -1, *want.shape[2:3], want.shape[-1])[:, :40]
        got = got.transpose(2, 3).reshape(2, -1, *got.shape[2:3], got.shape[-1])[:, :40]
        err = (got - want).abs().max().item()
        assert torch.isfinite(got).all() and err <= MOE_KV_RTOL * want.abs().max().item(), err


# ---------------------------------------------------------------------------
# The SSM and hybrid decoders (mamba2-1.3b, hymba-1.5b) and the unpaged
# engine's dense caches.

# mamba2-1.3b's and hymba-1.5b's linear shapes (K, S, N), S as the serving
# recipe leaves it (r = 0.02): the SSM in_proj/out_proj of each, hymba's
# attention, MLP and lm_head. hymba's in_proj (6482) and lm_head (32001)
# are stored zero-padded to 6496 and 32016.
SSM_SHAPES = {
    "mamba2 in_proj": (2048, 41, 8512), "mamba2 out_proj": (4096, 82, 2048),
    "hymba wq/wo": (1600, 32, 1600), "hymba wk/wv": (1600, 32, 320),
    "hymba w_gate/w_up": (1600, 32, 5504), "hymba w_down": (5504, 111, 1600),
    "hymba in_proj": (1600, 32, 6482), "hymba out_proj": (3200, 64, 1600),
    "hymba lm_head": (1600, 32, 32001),
}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("name", list(SSM_SHAPES))
def test_gemms_at_the_ssm_and_hybrid_shapes_cuda(name, m):
    """B1, B4, B5 and B6 at every mamba2-1.3b and hymba-1.5b linear shape,
    a decode row, a decode step and a 64-row prefill call, on weights
    stored as ``quantize_params`` and ``to_w4a8`` store them (zero columns
    past a ragged N): B1 and B6 bitwise their plain versions, B4 and B5
    within the weight-only bound (bf16 outputs plus one bf16 ulp); each one
    launch."""
    cuda_or_skip()
    _gemms_checked(*SSM_SHAPES[name], m)


def _gemms_checked(k, s, n, m, outlier_ratios=(0.05,)):
    """B1, B4, B5 and B6 at (K, S, N) and M rows against their plain
    versions, as ``test_gemms_at_the_ssm_and_hybrid_shapes_cuda`` states;
    B6 with the outlier rows ``to_w4a8`` keeps at each of
    ``outlier_ratios`` (its default 0.05)."""
    npad = tqm.padded_cols(n, 16)
    g, w8, ws, src = _b1_weights(k, s, n, m + k + n)
    w8, ws = tqm.pad_cols(w8, npad), tqm.pad_cols(ws, npad)
    x = (torch.randn((m, k), generator=g, device="cuda") * 2.0).to(torch.bfloat16)
    mult = torch.ones((s,), device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        n0 = tfq.launches
        got = tfq.fused_quant_matmul_cuda(x, w8, ws, src, out_dtype=dt)
        assert tfq.launches == n0 + 1 and got.shape == (m, npad)
        assert _same_bits(got, tfq.fused_quant_matmul_plain(x, w8, ws, src, out_dtype=dt))
    xe = torch.cat([x.float(), x[:, src.long()].float()], 1)
    for label, call, plain, xk, wk in (
            ("B4", lambda dt: tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult,
                                                        tail_is_mask=True, out_dtype=dt),
             lambda dt: tom.ocs_quant_matmul_plain(x, w8, ws, src, tail_mult=mult,
                                                   out_dtype=dt), xe, w8),
            ("B5", lambda dt: tqm.quant_matmul_cuda(x, w8[:k].contiguous(), ws, out_dtype=dt),
             lambda dt: tqm.quant_matmul_plain(x, w8[:k].contiguous(), ws, out_dtype=dt),
             x.float(), w8[:k])):
        bound = (WO_TOL_FACTOR * (xk.shape[1] + 2) * 2.0 ** -24
                 * tref.float_matmul(xk.abs(), wk.abs()) * ws)
        n0 = tom.launches_cuda_cores
        got, want = call(torch.float32), plain(torch.float32)
        assert tom.launches_cuda_cores == n0  # the tensor-core route
        assert torch.isfinite(got).all() and ((got - want).abs() <= bound).all(), label
        g16, p16 = call(torch.bfloat16).float(), plain(torch.bfloat16).float()
        ulp = _bf16_ulp(torch.maximum(g16.abs(), p16.abs()))
        assert ((g16 - p16).abs() <= bound + ulp).all(), label
    for ratio in outlier_ratios:
        # to_w4a8's outlier rows: ceil(ratio * K_exp), K_exp = K + S made even.
        t = math.ceil(ratio * (k + s + (k + s) % 2))
        args = _w4a8_case(m, k, n, s, t, torch.bfloat16, m * 7 + k + t)
        for dt in (torch.float32, torch.bfloat16):
            assert _same_bits(tw4.w4a8_matmul_cuda(*args, out_dtype=dt),
                              tw4.w4a8_matmul_plain(*args, out_dtype=dt)), (dt, t)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dequant", "w8a8", "w4a8"])
@pytest.mark.parametrize("leaf,k,n", [("lm_head", 1600, 32001), ("ssm in_proj", 1600, 6482)])
def test_padded_leaf_bitwise_the_per_call_pad_cuda(leaf, k, n, mode):
    """hymba-1.5b's two ragged leaves, quantized on the card (stored padded
    once, ``n_out`` the true N): ``layers.dense`` in each matmul mode is
    bitwise what the wrappers gave when they padded the weights on every
    call (the unpadded leaf's arrays zero-padded to 16 columns, the kernel,
    the output sliced), and the pad columns of the stored leaf, its w4a8
    conversion included, are zero."""
    cuda_or_skip()
    from repro_torch.core.ocs import W4A8Linear
    from repro_torch.models import layers

    g = torch.Generator(device="cuda").manual_seed(n)
    w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True, pad_to=1)
    lin = quantize_params({"w": w}, recipe, device="cuda")["w"]
    npad = tqm.padded_cols(n, 16)
    assert lin.n_out == n and lin.weight.values.shape[1] == npad
    assert not lin.weight.values[:, n:].any() and not lin.weight.scale[n:].any()
    if mode == "w4a8":
        lin = to_w4a8(lin, 0.05)
        assert isinstance(lin, W4A8Linear) and lin.n_out == n and lin.w4.shape[1] == npad
        assert not lin.w4[:, n:].any() and not lin.w8[:, n:].any()
    x = (torch.randn((8, 1, k), generator=g, device="cuda") * 2.0).to(torch.bfloat16)
    got = layers.dense(lin, x, mode=mode)
    assert got.shape == (8, 1, n)
    x2 = x.reshape(8, k)
    pc = lambda t: tqm.pad_cols(t[..., :n].contiguous(), npad)  # noqa: E731
    tail = lin.spec.src[lin.n_orig:]
    if mode == "w4a8":
        want = tw4.w4a8_matmul_cuda(x2, pc(lin.w4), pc(lin.s4), pc(lin.w8), pc(lin.s8), tail,
                                    lin.outlier_idx, out_dtype=torch.bfloat16)
    elif mode == "w8a8":
        want = tfq.fused_quant_matmul_cuda(x2, pc(lin.weight.values), pc(lin.weight.scale),
                                           tail, out_dtype=torch.bfloat16)
    else:
        want = tom.ocs_quant_matmul_cuda(x2, pc(lin.weight.values), pc(lin.weight.scale), tail,
                                         tail_mult=lin.spec.mult[lin.n_orig:],
                                         tail_is_mask=True, out_dtype=torch.bfloat16)
    assert _same_bits(got.reshape(8, n), want[:, :n].contiguous())


def _ssm_cases():
    return [(a, m) for a in ("mamba2-1.3b", "hymba-1.5b") for m in ("dequant", "w8a8", "w4a8")]


def _ssm_card_rtol(mode):
    """``chip_smoke.SSM_CARD_RTOL``: the smoke SSM and hybrid models' card
    vs CPU logits, of the largest logit, by matmul mode."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SSM_CARD_RTOL[mode]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode", _ssm_cases())
def test_ssm_and_hybrid_decode_card_vs_cpu_cuda(arch, mode):
    """The smoke mamba2-1.3b and hymba-1.5b (its window 32 passed: 40
    steps) decoded teacher-forced from fresh dense caches on the card and
    on the CPU (int8 caches in w8a8): logits within the mode's
    ``chip_smoke.SSM_CARD_RTOL`` at every step, the SSM states finite, and
    one launch of the mode's kernel per quantized matrix a step (2 a mamba2
    layer; 9 a hymba layer and the lm_head)."""
    cuda_or_skip()
    import dataclasses
    from repro_torch.models import transformer as T

    cfg, q = _smoke_tree(mode, arch)
    if mode == "w8a8":
        cfg = dataclasses.replace(cfg, kv_bits=8)
    kernel = {"dequant": tom, "w8a8": tfq, "w4a8": tw4}[mode]
    toks = np.random.default_rng(4).integers(0, cfg.vocab, 40)
    logits = {}
    for dev in ("cpu", "cuda"):
        params = tree_to(q, dev)
        caches = T.init_cache(cfg, 2, 64, device=dev)
        kernel.reset_launches()
        out = []
        with torch.no_grad():
            for t in toks:
                lg, caches = T.decode_step(params, torch.full((2, 1), int(t), device=dev),
                                           caches, cfg, mode=mode)
                out.append(lg.float().cpu())
        if dev == "cuda":
            per = 2 * cfg.n_layers if arch.startswith("mamba2") else 9 * cfg.n_layers + 1
            assert kernel.launches == per * len(toks)
        states = [layer["ssm"]["state"] for layer in caches["layers"]]
        assert all(bool(torch.isfinite(s_).all()) for s_ in states)
        logits[dev] = torch.stack(out)
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    top = logits["cpu"].abs().max().item()
    print(f"{arch} {mode}: card vs CPU max |d logits| {err:.4g} of {top:.4g}")
    assert err <= _ssm_card_rtol(mode) * top, (err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 32], ids=["full", "ring"])
def test_dense_cache_int8_attention_card_vs_cpu_cuda(window):
    """The unpaged engine's int8 cache attention on the card: its two dots
    (``int_dot``, summed exactly) bitwise the CPU's on the same int8
    operands, at a key count past float32's exact range; a decode step's
    row writes bitwise the CPU's (B1 and the row quantizer are), the output
    within 1% of the largest (softmax exp differs in float32 ulps on either
    side, which can flip a quantized softmax weight)."""
    cuda_or_skip()
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models import attention as TA

    g = torch.Generator().manual_seed(window)
    q8 = torch.randint(-127, 128, (2, 1, 2, 3, 64), generator=g, dtype=torch.int8)
    k8 = torch.randint(-127, 128, (2, 2, 2048, 64), generator=g, dtype=torch.int8)
    p8 = torch.randint(-127, 128, (2, 1, 2, 3, 2048), generator=g, dtype=torch.int8)
    for eq, a, b in (("bqgrd,bgsd->bqgrs", q8, k8), ("bqgrs,bgsd->bqgrd", p8, k8)):
        assert torch.equal(TA.int_dot(eq, a.cuda(), b.cuda()).cpu(), TA.int_dot(eq, a, b))
    arch = "hymba-1.5b" if window else "glm4-9b"
    cfg, q = _smoke_tree("w8a8", arch)
    cfg = dataclasses.replace(cfg, kv_bits=8)
    p = {key: v.layer(0) for key, v in q["layers"]["attn"].items()}
    x = (torch.randn((3, 1, cfg.d_model), generator=g) * 2.0).to(torch.bfloat16)
    pos = torch.tensor([5, 31, 45], dtype=torch.int32)
    cache = TA.init_kv_cache(cfg, 3, 48, window=window)
    for key in ("k", "v"):
        cache[key].copy_(torch.randint(-127, 128, cache[key].shape, generator=g,
                                       dtype=torch.int8))
        cache[key + "_scale"].copy_(torch.rand(cache[key + "_scale"].shape, generator=g) * 0.02)
    meta = None
    if window:
        shape = (3, cfg.hymba.n_meta_tokens, cfg.n_kv_heads, cfg.hd)
        meta = (torch.randn(shape, generator=g), torch.randn(shape, generator=g))
    outs = {}
    for dev in ("cpu", "cuda"):
        c = {key: t.clone().to(dev) for key, t in cache.items()}
        with torch.no_grad():
            y, c = TA.attention_decode(
                tree_to(p, dev), x.to(dev), c, pos.to(dev), cfg, mode="w8a8", window=window,
                kv_prefix=None if meta is None else tuple(t.to(dev) for t in meta))
        outs[dev] = (y.float().cpu(), {key: t.cpu() for key, t in c.items()})
    for key in cache:
        assert _same_bits(outs["cuda"][1][key], outs["cpu"][1][key]), key
    err = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item()
    assert err <= 0.01 * outs["cpu"][0].abs().max().item(), err


# ---------------------------------------------------------------------------
# The slice of the full-sequence entry point and the last configs: their
# GEMM shapes, the unpaged engine's Q > 1 rows, forward card vs CPU.

# (K, S, N) of qwen2-vl-7b, minitron-8b and hubert-xlarge, S as the serving
# recipe leaves it (r = 0.02); hubert's lm_head (N 504) is stored padded to
# 512.
SLICE_SHAPES = {
    "qwen2-vl wq/wo": (3584, 72, 3584), "qwen2-vl wk/wv": (3584, 72, 512),
    "qwen2-vl w_gate/w_up": (3584, 72, 18944), "qwen2-vl w_down": (18944, 379, 3584),
    "qwen2-vl lm_head": (3584, 72, 152064),
    "minitron wq/wo": (4096, 82, 4096), "minitron wk/wv": (4096, 82, 1024),
    "minitron w_gate/w_up": (4096, 82, 16384), "minitron w_down": (16384, 328, 4096),
    "minitron lm_head": (4096, 82, 256000),
    "hubert wq/wk/wv/wo": (1280, 26, 1280), "hubert w_in": (1280, 26, 5120),
    "hubert w_out2": (5120, 103, 1280), "hubert lm_head": (1280, 26, 504),
}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 257])
@pytest.mark.parametrize("name", list(SLICE_SHAPES))
def test_gemms_at_the_slice_shapes_cuda(name, m):
    """B1, B4, B5 and B6 at every qwen2-vl-7b, minitron-8b and
    hubert-xlarge linear shape, a decode row, a decode step and a ragged
    257-row full-sequence call (the prefill tile's class), against their
    plain versions as at the SSM shapes."""
    cuda_or_skip()
    _gemms_checked(*SLICE_SHAPES[name], m)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kv_bits", [("dequant", None), ("w8a8", 8)])
def test_verify_step_dense_cache_cuda_bitwise_sequential(mode, kv_bits):
    """The unpaged engine's verify on the card: ``verify_step`` over 5
    tokens on float32 and int8 dense caches is bitwise 5 sequential
    ``decode_step`` calls (logits, every layer's cache, positions) on a
    two-layer glm4-9b-shaped model, lanes at ragged positions inside the
    cache; and a window run past the cache's end writes the rows the CPU
    writes (the rows clipped onto the last slot carry the last query's
    row, whatever order the card takes the writes in)."""
    import copy
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T

    cuda_or_skip()
    cfg = dataclasses.replace(smoke_config("glm4-9b"), d_model=4096, n_heads=32,
                              n_kv_heads=2, head_dim=128, d_ff=1024, vocab=2048,
                              kv_bits=kv_bits)
    q = quantize_params(T.init_params(cfg, seed=0, device="cpu"),
                        QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02,
                                    per_channel=True, pad_to=1), device="cpu")
    rng = np.random.default_rng(5)
    ctx = rng.integers(0, cfg.vocab, (6, 3))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 5)), dtype=torch.int32)
    runs = {}
    for dev, start in (("cuda", [0, 9, 30]), ("cuda-past", [0, 9, 39]),
                       ("cpu-past", [0, 9, 39])):
        d = dev.split("-")[0]
        params = tree_to(q, d)
        caches = T.init_cache(cfg, 3, 48, device=d)
        caches["pos"] = torch.tensor(start, dtype=torch.int32, device=d)
        with torch.no_grad():
            for t in ctx:
                _, caches = T.decode_step(params, torch.as_tensor(t[:, None], dtype=torch.int32,
                                                                  device=d), caches, cfg,
                                          mode=mode)
            tk = toks.to(d)
            seq, outs = copy.deepcopy(caches), []
            if dev == "cuda":
                for j in range(5):
                    lg, seq = T.decode_step(params, tk[:, j:j + 1].contiguous(), seq, cfg,
                                            mode=mode)
                    outs.append(lg)
            lg_v, ver = T.verify_step(params, tk, caches, cfg, mode=mode)
        runs[dev] = (outs, seq, lg_v, ver)
    torch.cuda.synchronize()
    outs, seq, lg_v, ver = runs["cuda"]
    assert _same_bits(torch.stack(outs, 1).float(), lg_v.float())
    assert torch.equal(ver["pos"], seq["pos"])
    for i in range(cfg.n_layers):
        for key, val in ver["layers"][i]["attn"].items():
            assert _same_bits(val, seq["layers"][i]["attn"][key]), (i, key)
    if mode == "w8a8":  # B1 and the row quantizer are bitwise the CPU's
        card, cpu = runs["cuda-past"][3], runs["cpu-past"][3]
        for i in range(cfg.n_layers):
            for key, val in card["layers"][i]["attn"].items():
                assert _same_bits(val, cpu["layers"][i]["attn"][key]), (i, key)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dequant", "w8a8", "w4a8"])
@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-7b", "hymba-1.5b"])
def test_forward_card_vs_cpu_cuda(arch, mode):
    """``transformer.forward`` of the smoke hubert-xlarge (frame
    embeddings, LayerNorm, GELU, unmasked attention), qwen2-vl-7b (M-RoPE)
    and hymba-1.5b (meta tokens, the skipped-chunk window) on the card and
    on the CPU from one quantized tree: finite logits within
    ``chip_smoke.FORWARD_CARD_RTOL`` of the mode of the largest, and one
    launch of the mode's kernel per quantized matrix (``B * S`` rows a
    call)."""
    cuda_or_skip()
    from repro_torch.models import transformer as T

    cfg, q = _smoke_tree(mode, arch)
    kernel = {"dequant": tom, "w8a8": tfq, "w4a8": tw4}[mode]
    rng = np.random.default_rng(6)
    tokens = embeds = None
    if cfg.frontend == "audio":
        embeds = torch.as_tensor(rng.normal(size=(2, 40, cfg.d_model)), dtype=torch.float32)
    else:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)))
    # Quantized matrices a layer: attention 4, the MLP 3 (SwiGLU) or 2
    # (GELU), hymba's SSM projections 2; then the lm_head.
    per = 4 + (3 if cfg.act == "swiglu" else 2) + (2 if cfg.block == "hymba" else 0)
    logits = {}
    for dev in ("cpu", "cuda"):
        kernel.reset_launches()
        with torch.no_grad():
            out = T.forward(tree_to(q, dev), None if tokens is None else tokens.to(dev), cfg,
                            mode=mode, embeds=None if embeds is None else embeds.to(dev))
        logits[dev] = out.float().cpu()
        if dev == "cuda":
            assert kernel.launches == per * cfg.n_layers + 1
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    top = logits["cpu"].abs().max().item()
    print(f"{arch} {mode}: forward card vs CPU max |d logits| {err:.4g} of {top:.4g}")
    assert torch.isfinite(logits["cuda"]).all()
    assert err <= _forward_card_rtol(mode) * top, (err, top)


def _forward_card_rtol(mode):
    """``chip_smoke.FORWARD_CARD_RTOL``: ``forward``'s card vs CPU logits of
    the smoke models, of the largest logit, by matmul mode."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FORWARD_CARD_RTOL[mode]


# ---------------------------------------------------------------------------
# The paper's weight-PTQ experiments and the precision-tier gate: the bench
# LM's GEMM shapes, training on the card, ACIQ/KL quantization at full
# width.

# The bench LM's linear shapes (K, S, N) under the gate's recipe (r = 0.02,
# pad_to=1): K + S = 131 and 262. to_w4a8 pads the odd 131 with a dead row
# and keeps ceil(0.1 K_exp) rows at 8 bits in the gate's w4a8_ocs tier (14
# and 27), none in w4a8_naive.
BENCH_LM_SHAPES = {"wq/wo": (128, 3, 128), "wk/wv": (128, 3, 64),
                   "w_gate/w_up": (128, 3, 256), "w_down": (256, 6, 128),
                   "lm_head": (128, 3, 512)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 1024])
@pytest.mark.parametrize("name", list(BENCH_LM_SHAPES))
def test_gemms_at_the_bench_lm_shapes_cuda(name, m):
    """B1, B4, B5 and B6 at every bench-LM linear shape (M = 1024 is one
    gate batch, 16 x 64), B6 with the gate's outlier counts (ratio 0.1 and
    0), against their plain versions as at the SSM shapes."""
    cuda_or_skip()
    _gemms_checked(*BENCH_LM_SHAPES[name], m, outlier_ratios=(0.1, 0.0))


# The subjects' training steps, card against CPU from the same init and
# batches (the port on both). The first step's gradients, each leaf's
# largest difference within TRAIN_CARD_GRAD of the leaf's largest
# gradient; the loss at every step within TRAIN_CARD_LOSS relative; each
# leaf's change over the steps (trained minus init), the root sum of
# squares of the difference within TRAIN_CARD_DELTA of the change's own.
# AdamW's first steps move an element by about the learning rate whatever
# its gradient's size, so an element on a noise-level gradient can move
# either way: the change is held by its root sum of squares, not its
# largest element. A tree that did not move, or moved along other
# gradients, reads 1 or more. Seen on an H100 (gradient, loss, change):
# convnet 3.2e-6, 4.8e-7, 9.3e-4; LSTM 6.8e-6, 7.7e-8, 9.1e-6; bench LM
# (bfloat16 activations) 0.011, 1.3e-4, 0.066.
TRAIN_CARD_GRAD = {"convnet": 1e-4, "lstm": 1e-4, "lm": 0.05}
TRAIN_CARD_LOSS = {"convnet": 1e-5, "lstm": 1e-5, "lm": 1e-3}
TRAIN_CARD_DELTA = {"convnet": 5e-3, "lstm": 5e-3, "lm": 0.12}


@pytest.mark.cuda
@pytest.mark.parametrize("subject", ["convnet", "lstm", "lm"])
def test_train_steps_card_vs_cpu_cuda(subject, monkeypatch):
    """Five ``train_loop`` steps of each experiment subject (a five-step
    schedule, all warmup: learning rates 0, 0.2, 0.4, 0.6 and 0.8 of the
    subject's; the loss logged at every step) on the card and on the CPU
    from the same seeded init (drawn on the CPU) and batches: the first
    step's gradients, the loss at every step and each leaf's change, within
    ``TRAIN_CARD_GRAD``, ``TRAIN_CARD_LOSS`` and ``TRAIN_CARD_DELTA``."""
    cuda_or_skip()
    from repro_torch.core.apply import map_with_path
    from repro_torch.experiments import common
    from repro_torch.optim.adamw import tree_map

    for mod, flag, val in ((torch.backends.cuda.matmul, "allow_tf32", False),
                           (torch.backends.cudnn, "allow_tf32", False),
                           (torch.backends.cudnn, "deterministic", True),
                           (torch.backends.cudnn, "benchmark", False)):
        monkeypatch.setattr(mod, flag, val)  # as common.float32_deterministic
    init = common.init_subject(subject, "cpu")
    _, batches, loss_fn, lr, _ = common.SUBJECTS[subject]

    def flat(tree):
        out = []
        map_with_path(lambda p, t: out.append(("/".join(map(str, p)), t.detach().cpu())), tree)
        return out

    grads, out, hist = {}, {}, {}
    for dev in ("cpu", "cuda"):
        b = batches(5, dev)
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), init)
        loss_fn(p, b[0]).backward()
        grads[dev] = flat(tree_map(lambda t: t.grad, p))
        hist[dev] = []
        out[dev] = flat(common.train_loop(tree_to(init, dev), loss_fn, b, lr=lr,
                                          history=hist[dev]))
    reads = {"grad": 0.0, "loss": 0.0, "delta": 0.0}
    for (path, a), (_, g) in zip(grads["cpu"], grads["cuda"]):
        reads["grad"] = max(reads["grad"], ((g - a).abs().max() / a.abs().max()).item())
    assert [h["step"] for h in hist["cuda"]] == list(range(5))
    for a, g in zip(hist["cpu"], hist["cuda"]):
        reads["loss"] = max(reads["loss"], abs(a["loss"] - g["loss"]) / abs(a["loss"]))
    for (path, a), (_, g), (_, i) in zip(out["cpu"], out["cuda"], flat(init)):
        d_cpu, d_card = a.double() - i.double(), g.double() - i.double()
        assert d_cpu.abs().max() > 0, path
        reads["delta"] = max(reads["delta"],
                             ((d_card - d_cpu).norm() / d_cpu.norm()).item())
    print(f"train card vs CPU {subject}: {reads}")
    assert reads["grad"] <= TRAIN_CARD_GRAD[subject], reads
    assert reads["loss"] <= TRAIN_CARD_LOSS[subject], reads
    assert reads["delta"] <= TRAIN_CARD_DELTA[subject], reads


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["aciq", "kl"])
def test_glm4_9b_layer0_aciq_kl_card_vs_cpu_cuda(method):
    """glm4-9b's layer-0 leaves at full width (d_model 4096, d_ff 13696),
    quantized on the card with ACIQ or KL clipping (w8, OCS r=0.02,
    per-tensor: the threshold is the grid's range) and fake-quantized: the
    split tables, int grids and scales, and the fake-quantized leaves,
    bitwise the same on the CPU."""
    cuda_or_skip()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.apply import fake_quantize_params
    from repro_torch.core.ocs import OCSQuantLinear
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=1, vocab=1024)
    params = T.init_params(cfg, seed=0, device="cuda")
    sub = {"layers": params["layers"]}
    cpu = tree_to(sub, "cpu")
    recipe = QuantRecipe(w_bits=8, w_clip=method, ocs_ratio=0.02)
    qc, qh = quantize_params(sub, recipe, device="cuda"), quantize_params(cpu, recipe,
                                                                         device="cpu")
    n = 0
    for part in ("attn", "mlp"):
        for name, a in qc["layers"][part].items():
            b = qh["layers"][part][name]
            if not isinstance(a, OCSQuantLinear):
                continue
            n += 1
            for x, y in ((a.weight.values, b.weight.values), (a.weight.scale, b.weight.scale),
                         (a.spec.src, b.spec.src)):
                assert x.shape == y.shape and _same_bits(x, y), name
    assert n == 7
    recipe4 = QuantRecipe(w_bits=4, w_clip=method, ocs_ratio=0.02)
    fc, fh = fake_quantize_params(sub, recipe4), fake_quantize_params(cpu, recipe4)
    for part in ("attn", "mlp"):
        for name, a in fc["layers"][part].items():
            assert _same_bits(a, fh["layers"][part][name]), name
