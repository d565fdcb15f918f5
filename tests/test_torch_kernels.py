"""Port parity, kernels: the plain PyTorch versions of ``fused_qmatmul``
(B1) and ``paged_attention`` (B2) against the reference's Pallas kernels,
run the way the reference's own tests run them on the CPU (interpret mode),
and against the reference oracles.

* B1 is bitwise: the integer product is exact and the float steps (scale,
  quantize, epilogue) are the same IEEE operations in the same grouping.
* B2's appended pools are bitwise (one quantization grid for every pool
  writer). Its outputs agree to ``B2_ATOL``: both sides are float32 after
  dequantization, but the reference's kernel runs an online softmax page by
  page while the plain version takes a one-shot softmax, and the two exp
  implementations differ in the last ulps (observed ~3e-6).

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against these plain versions there.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import to_np, torch_threads  # noqa: F401

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.kernels.fused_qmatmul import fused_quant_matmul as j_fused
from repro.serving import kv_cache as jkvc

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.serving import kv_cache as tkvc

B2_ATOL = 2e-5


def _b1_case(m, k, n, s, bf16, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 2.5).astype(np.float32)
    x[:, rng.randint(0, k)] *= 7.0  # an outlier column sets the row scale
    w8 = rng.randint(-127, 128, (k + s, n)).astype(np.int8)
    ws = (rng.rand(n) * 0.01 + 1e-4).astype(np.float32)
    src = rng.randint(0, k, s).astype(np.int32)
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    xt = xt.to(torch.bfloat16) if bf16 else xt
    return xj, xt, w8, ws, src


B1_CASES = [
    # (M, K, N, S, bf16 x)
    (48, 1000, 72, 13, False),  # K not a multiple of 128, OCS tail
    (5, 384, 64, 0, False),  # S == 0
    (33, 130, 36, 7, True),  # ragged M/N, bf16 activations
    (1, 256, 200, 6, True),  # a decode row
    (17, 96, 8, 3, False),
]


@pytest.mark.parametrize("m,k,n,s,bf16", B1_CASES)
def test_fused_qmatmul_plain_bitwise(m, k, n, s, bf16):
    xj, xt, w8, ws, src = _b1_case(m, k, n, s, bf16, seed=m * 31 + k)
    out_j = xj.dtype
    kern = j_fused(xj, jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(src),
                   interpret=True, out_dtype=out_j)
    oracle = jax.jit(jref.fused_quant_matmul_ref, static_argnums=(4, 5))(
        xj, jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(src), 8, out_j)
    got = ops.fused_quant_matmul(xt, torch.from_numpy(w8), torch.from_numpy(ws),
                                 torch.from_numpy(src), out_dtype=xt.dtype)
    assert got.dtype == xt.dtype and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(to_np(got), np.asarray(kern.astype(jnp.float32)))
    np.testing.assert_array_equal(to_np(got), np.asarray(oracle.astype(jnp.float32)))


def test_dynamic_quant_scale_is_compiled_reference_form():
    """The row scale is ``amax * float32(1/qmax)``: the form XLA compiles
    ``amax / qmax`` into, which the reference's jitted paths compute."""
    x = np.random.RandomState(4).randn(64, 300).astype(np.float32)
    q_j, s_j = jax.jit(jref.dynamic_quant_ref, static_argnums=1)(jnp.asarray(x), 8)
    q_t, s_t = tref.dynamic_quant_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))


def test_quant_rows_bitwise():
    x = np.random.RandomState(2).randn(5, 3, 2, 16).astype(np.float32) * 3.0
    q_j, s_j = jax.jit(jpa.quant_rows)(jnp.asarray(x))
    q_t, s_t = tpa.quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def _b2_case(seed, int8, ps, B=3, T=4, KV=2, rep=2, hd=16, poison=False):
    """Ragged lanes (lane b owns min(T, b+2) pages), lane B-1 retired to an
    all-trash table; optionally page 0 NaN-poisoned."""
    rng = np.random.RandomState(seed)
    P = B * T + 1
    H = KV * rep
    if int8:
        pool = {
            "k": rng.randint(-127, 128, (P, KV, ps, hd)).astype(np.int8),
            "v": rng.randint(-127, 128, (P, KV, ps, hd)).astype(np.int8),
            "k_scale": (rng.rand(P, KV, ps) * 0.1 + 0.01).astype(np.float32),
            "v_scale": (rng.rand(P, KV, ps) * 0.1 + 0.01).astype(np.float32),
        }
    else:
        pool = {
            "k": rng.randn(P, KV, ps, hd).astype(np.float32),
            "v": rng.randn(P, KV, ps, hd).astype(np.float32),
        }
    if poison:
        for key in ("k_scale", "v_scale") if int8 else ("k", "v"):
            pool[key][0] = np.nan
    table = np.zeros((B, T), np.int32)
    pages = iter(range(1, P))
    pos = []
    for b in range(B - 1):
        npg = min(T, b + 2)
        for t in range(npg):
            table[b, t] = next(pages)
        pos.append(max((npg - 1) * ps - 1 - b, 0))
    pos.append(0)  # the retired lane
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    kn = rng.randn(B, 1, KV, hd).astype(np.float32)
    vn = rng.randn(B, 1, KV, hd).astype(np.float32)
    return pool, table, np.asarray(pos, np.int32), q, kn, vn


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("ps", [1, 2, 8, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_plain_vs_interpreted_kernel(int8, ps):
    """Ragged lanes, a retired all-trash lane, and page 0 NaN-poisoned
    (values of float pools, scales of int8 pools); pages of 1 and 2 rows
    too, which the engine takes and the CUDA kernel serves."""
    pool, table, pos, q, kn, vn = _b2_case(ps + 2 * int8, int8, ps, poison=True)
    jargs = ({k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(table),
             jnp.asarray(pos), jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn))
    o_j, p_j = jops.paged_attention(*jargs, force="interpret")
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    o_t, p_t = ops.paged_attention(
        tpool, torch.from_numpy(table), torch.from_numpy(pos), torch.from_numpy(q),
        torch.from_numpy(kn), torch.from_numpy(vn))
    assert o_t.dtype == torch.float32 and tuple(o_t.shape) == q.shape
    assert np.isfinite(o_t.numpy()).all()  # the trash page never leaks
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=B2_ATOL, rtol=0)
    assert (o_t.numpy()[-1] == 0).all()  # retired lane: exact zeros
    for key in p_j:
        assert _same_bits(p_t[key].numpy(), p_j[key]), key


def test_append_rows_matches_append_tokens():
    """The plain append is bitwise the reference's pool scatter."""
    pool, table, pos, q, kn, vn = _b2_case(21, True, 16)
    want = jax.jit(jkvc.append_tokens)(
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(table), jnp.asarray(pos))
    got = tpa.append_rows({k: torch.from_numpy(v) for k, v in pool.items()},
                          torch.from_numpy(kn), torch.from_numpy(vn),
                          torch.from_numpy(table), torch.from_numpy(pos))
    for key in want:
        assert _same_bits(got[key].numpy(), want[key]), key


@pytest.mark.parametrize("int8", [False, True])
def test_write_prompt_pages_and_gather_prefix_bitwise(int8):
    """Prefill page writes from the same K/V are bitwise the reference's;
    the dequantized prefix gather too."""
    rng = np.random.RandomState(5)
    pool, *_ = _b2_case(6, int8, 8)
    k = rng.randn(1, 24, 2, 16).astype(np.float32) * 2
    v = rng.randn(1, 24, 2, 16).astype(np.float32)
    ids = np.array([4, 7, 0], np.int32)
    want = jax.jit(jkvc.write_prompt_pages)(
        {kk: jnp.asarray(vv) for kk, vv in pool.items()}, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(ids))
    got = tkvc.write_prompt_pages({kk: torch.from_numpy(vv.copy()) for kk, vv in pool.items()},
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(ids))
    for key in want:  # page 0 (trash) takes the pad rows: compare real pages
        assert _same_bits(got[key].numpy()[1:], np.asarray(want[key])[1:]), key
    pre = np.array([7, 4], np.int32)
    gk_j, gv_j = jkvc.gather_prefix(want, jnp.asarray(pre))
    gk_t, gv_t = tkvc.gather_prefix(got, torch.from_numpy(pre))
    np.testing.assert_array_equal(gk_t.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(gv_t.numpy(), np.asarray(gv_j))
