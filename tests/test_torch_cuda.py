"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where
``torch.cuda.is_available()`` is false, as on CPU-only machines. On a
machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This module imports torch and ``repro_torch`` only (no JAX), so it runs
where the JAX package is not installed. Tolerances: ``fused_qmatmul`` is
bitwise; ``paged_attention`` pools are bitwise and outputs within
``B2_ATOL`` (float32 summation order and ``expf`` vs torch's softmax).
"""
import numpy as np
import pytest
import torch

from _torch_interop import cuda_or_skip, torch_threads  # noqa: F401

from repro_torch.kernels import fused_qmatmul as tfq
from repro_torch.kernels import paged_attention as tpa

B2_ATOL = 2e-5


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
