"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where
``torch.cuda.is_available()`` is false, as on CPU-only machines. On a
machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This module imports torch and ``repro_torch`` only (no JAX), so it runs
where the JAX package is not installed. Tolerances: ``fused_qmatmul``,
``dynamic_quant`` and the int8 paths of ``ocs_matmul`` / ``quant_matmul``
are bitwise; ``paged_attention`` pools are bitwise and outputs within
``B2_ATOL`` (float32 summation order and ``expf`` vs torch's softmax); the
weight-only paths within the float32 summation-order bound
(``WO_TOL_FACTOR``, as in ``tests/test_torch_ocs_matmul.py``) for f32
outputs and within it plus one bf16 ulp for bf16 outputs (outputs near zero
after cancellation can be several bf16 steps apart within the f32 bound).
"""
import numpy as np
import pytest
import torch

from _torch_interop import cuda_or_skip, torch_threads  # noqa: F401

from repro_torch.kernels import dynamic_quant as tdq
from repro_torch.kernels import fused_qmatmul as tfq
from repro_torch.kernels import ocs_matmul as tom
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref

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
