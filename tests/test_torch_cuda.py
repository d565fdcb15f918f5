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
    cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(m * 31 + k)
    dt = torch.bfloat16 if bf16 else torch.float32
    x = (torch.randn((m, k), generator=g, device="cuda") * 2.5).to(dt)
    w8 = torch.randint(-127, 128, (k + s, n), generator=g, device="cuda", dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device="cuda") * 0.01 + 1e-4
    src = torch.randint(0, k, (s,), generator=g, device="cuda", dtype=torch.int32)
    got = tfq.fused_quant_matmul_cuda(x, w8, ws, src, out_dtype=dt)
    want = tfq.fused_quant_matmul_plain(x, w8, ws, src, out_dtype=dt)
    assert torch.equal(got, want)


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
    with pytest.raises(ValueError, match="N % 4"):  # 4-column weight words
        tom.ocs_quant_matmul_cuda(x, torch.zeros((10, 6), dtype=torch.int8, device=dev),
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
# and glm4-9b's K+S = 4178 (T = 209) and 13970 (T = 699).
W4A8_CASES = [
    (5, 300, 72, 8, 0, torch.float32),
    (33, 250, 52, 6, 13, torch.bfloat16),
    (3, 130, 36, 0, 7, torch.float32),
    (1, 4096, 4096, 82, 209, torch.bfloat16),
    (8, 13696, 256, 274, 699, torch.bfloat16),
    (256, 4096, 512, 82, 209, torch.bfloat16),
]


def _w4a8_case(m, k, n, s, t, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((m, k), generator=g, device="cuda") * 2.0).to(dt)
    w4 = torch.randint(0, 256, ((k + s) // 2, n), generator=g, device="cuda",
                       dtype=torch.int32).to(torch.uint8)
    s4 = torch.rand((n,), generator=g, device="cuda") * 0.01 + 1e-4
    w8 = torch.randint(-127, 128, (t, n), generator=g, device="cuda", dtype=torch.int8)
    s8 = torch.rand((n,), generator=g, device="cuda") * 0.001 + 1e-5
    src = torch.randint(0, k, (s,), generator=g, device="cuda", dtype=torch.int32)
    oidx = torch.sort(torch.randperm(k + s, generator=g, device="cuda")[:t]).values
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
    with pytest.raises(ValueError, match="N % 4"):
        tw4.w4a8_matmul_cuda(x, w4[:, :6].contiguous(), s4[:6], w8[:, :6].contiguous(),
                             s8[:6], src, oidx)
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
@pytest.mark.parametrize("m", [40, 256])
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
@pytest.mark.parametrize("s", [82, 0], ids=["B4", "B5"])
def test_weight_only_row_chunks_cuda(monkeypatch, s):
    """A weight-only call whose split-K workspace passes its bound runs in
    row chunks: with the bound cut so 40 rows take chunks of 12, 12, 12, 4,
    the output is bitwise that of one launch, and one wrapper call counts
    one launch."""
    cuda_or_skip()
    x, w8, ws, src, mult = _ocs_case(40, 4096, 256, s, torch.bfloat16, "ones" if s else None, 7)
    want = tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult)
    nsplit = tqm.wo_split_plan(4096 + s, 256)[1]
    monkeypatch.setattr(tqm, "_MAX_PART_BYTES", 4 * nsplit * 12 * 256)
    assert tqm.wo_row_chunk(40, 256, nsplit) == 12
    n0 = tom.launches + tqm.launches
    got = tom.ocs_quant_matmul_cuda(x, w8, ws, src, tail_mult=mult)
    assert tom.launches + tqm.launches - n0 == 1
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
