"""Port parity, int4 KV pages (the precision tier's ``kv_bits=4``): the
packed-nibble helpers, the int4 pool writers and B2's int4 branch in its
plain PyTorch version, against the reference.

* ``pack_int4`` / ``unpack_int4`` are bitwise over the whole nibble range
  [-8, 7] (every byte value); ``quant_rows`` at qmax 7 and the pool bytes
  written by the decode append and by prefill are bitwise; the prefix
  gather is bitwise.
* Attention outputs agree to ``B2_ATOL``: the plain version runs the
  reference's page-blocked recurrence (``_int4_flash_step``) on bitwise
  equal dequantized pages, but torch's and XLA's einsum sums and ``exp``
  differ in the last float32 ulps (observed ~1e-6).
* A NaN-poisoned trash page never reaches an output, and a retired lane's
  all-trash table gives exact zeros.

The CUDA kernel runs only on the card: ``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from _torch_interop import torch_threads  # noqa: F401

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.serving import kv_cache as jkvc

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.serving import kv_cache as tkvc

B2_ATOL = 2e-5


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_pack_unpack_whole_nibble_range():
    """Every (low, high) pair of [-8, 7] packs to the reference's byte, and
    every byte value unpacks to the reference's two nibbles."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()], axis=-1).astype(np.int8)  # [256, 2]
    packed_t = tpa.pack_int4(torch.from_numpy(q))
    packed_j = np.asarray(jpa.pack_int4(jnp.asarray(q)))
    assert _same_bits(packed_t.numpy(), packed_j)
    assert sorted(packed_t.numpy().ravel().tolist()) == list(range(256))
    b = np.arange(256, dtype=np.uint8).reshape(-1, 1)
    un_t = tpa.unpack_int4(torch.from_numpy(b))
    assert _same_bits(un_t.numpy(), np.asarray(jpa.unpack_int4(jnp.asarray(b))))
    assert torch.equal(tpa.unpack_int4(packed_t), torch.from_numpy(q))


@settings(deadline=None, database=None, max_examples=60)
@given(hnp.arrays(np.int8, st.tuples(st.integers(1, 4), st.integers(1, 8).map(lambda c: 2 * c)),
                  elements=st.integers(-8, 7)))
def test_pack_int4_property(q):
    """Random rows: pack is bitwise the reference's and unpack inverts it."""
    packed = tpa.pack_int4(torch.from_numpy(q))
    assert _same_bits(packed.numpy(), np.asarray(jpa.pack_int4(jnp.asarray(q))))
    assert np.array_equal(tpa.unpack_int4(packed).numpy(), q)


def test_quant_rows_int4_bitwise():
    x = np.random.RandomState(3).randn(6, 2, 4, 32).astype(np.float32) * 2.5
    q_j, s_j = jax.jit(lambda a: jpa.quant_rows(a, qmax=jpa.KV4_QMAX))(jnp.asarray(x))
    q_t, s_t = tpa.quant_rows(torch.from_numpy(x), tpa.KV4_QMAX)
    assert tpa.KV4_QMAX == jpa.KV4_QMAX
    assert _same_bits(q_t.numpy(), q_j) and _same_bits(s_t.numpy(), s_j)
    assert q_t.abs().max() <= 7


def _int4_case(seed, ps, B=3, T=4, KV=2, rep=2, hd=16, poison=False):
    """Packed int4 pools, ragged lanes (lane b owns min(T, b+2) pages), lane
    B-1 retired to an all-trash table; optionally page 0 NaN-poisoned."""
    rng = np.random.RandomState(seed)
    P = B * T + 1
    pool = {
        "k": rng.randint(0, 256, (P, KV, ps, hd // 2)).astype(np.uint8),
        "v": rng.randint(0, 256, (P, KV, ps, hd // 2)).astype(np.uint8),
        "k_scale": (rng.rand(P, KV, ps) * 0.2 + 0.02).astype(np.float32),
        "v_scale": (rng.rand(P, KV, ps) * 0.2 + 0.02).astype(np.float32),
    }
    if poison:
        pool["k_scale"][0] = np.nan
        pool["v_scale"][0] = np.nan
    table = np.zeros((B, T), np.int32)
    pages = iter(range(1, P))
    pos = []
    for b in range(B - 1):
        npg = min(T, b + 2)
        for t in range(npg):
            table[b, t] = next(pages)
        pos.append(max((npg - 1) * ps - 1 - b, 0))
    pos.append(0)  # the retired lane
    q = rng.randn(B, 1, KV * rep, hd).astype(np.float32)
    kn = rng.randn(B, 1, KV, hd).astype(np.float32)
    vn = rng.randn(B, 1, KV, hd).astype(np.float32)
    return pool, table, np.asarray(pos, np.int32), q, kn, vn


def _jax_args(pool, table, pos, q, kn, vn):
    return ({k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(table),
            jnp.asarray(pos), jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn))


def _torch_args(pool, table, pos, q, kn, vn):
    return ({k: torch.from_numpy(v.copy()) for k, v in pool.items()},
            torch.from_numpy(table), torch.from_numpy(pos), torch.from_numpy(q),
            torch.from_numpy(kn), torch.from_numpy(vn))


def test_append_rows_int4_bitwise():
    """The decode append's int4 pool bytes and scales are bitwise the
    reference's (``append_rows`` and the engine's ``append_tokens``)."""
    case = _int4_case(11, 16)
    jargs = _jax_args(*case)
    want = jax.jit(jpa.append_rows)(jargs[0], jargs[4], jargs[5], jargs[1], jargs[2])
    want_tok = jax.jit(jkvc.append_tokens)(jargs[0], jargs[4], jargs[5], jargs[1], jargs[2])
    targs = _torch_args(*case)
    got = tpa.append_rows(targs[0], targs[4], targs[5], targs[1], targs[2])
    assert tpa.pool_kind(got) == "int4"
    for key in want:
        assert _same_bits(got[key].numpy(), want[key]), key
        assert _same_bits(got[key].numpy(), want_tok[key]), key


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan-trash"])
@pytest.mark.parametrize("ps", [1, 2, 8, 16])
def test_paged_attention_int4_plain_vs_reference(ps, poison):
    """The plain int4 branch against the reference's gather oracle and its
    interpret-mode kernel: pools bitwise, outputs within ``B2_ATOL``, finite
    (the poisoned trash page dies), the retired lane exact zeros; pages of
    1 and 2 rows too."""
    case = _int4_case(ps + 7 * poison, ps, poison=poison)
    jargs = _jax_args(*case)
    o_g, p_g = jax.jit(jpa.paged_attention_gather_ref)(*jargs)
    o_k, p_k = jops.paged_attention(*jargs, force="interpret")
    o_t, p_t = ops.paged_attention(*_torch_args(*case))
    assert o_t.dtype == torch.float32 and tuple(o_t.shape) == case[3].shape
    assert np.isfinite(o_t.numpy()).all()
    assert (o_t.numpy()[-1] == 0).all()
    for want in (o_g, o_k):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(want), atol=B2_ATOL, rtol=0)
    for key in p_g:
        assert _same_bits(p_t[key].numpy(), p_g[key]), key
        assert _same_bits(p_t[key].numpy(), p_k[key]), key


def test_all_trash_lane_is_exact_zeros_even_with_nan_pages():
    """A lane whose whole table is the (NaN-poisoned) trash page attends to
    nothing: its output is exact zeros, not NaN."""
    pool, table, pos, q, kn, vn = _int4_case(5, 8, poison=True)
    pool["k"][0] = 0xFF  # poison the bytes too (nibbles -1, -1)
    table[:] = 0
    o_t, _ = ops.paged_attention(*_torch_args(pool, table, pos, q, kn, vn))
    assert (o_t.numpy() == 0).all()


def test_write_prompt_pages_and_gather_prefix_int4_bitwise():
    """Prefill page writes (quant_rows at qmax 7, packed) are bitwise the
    reference's; so is the dequantized prefix gather."""
    from repro.configs import smoke_config as j_smoke
    from repro_torch.configs import smoke_config as t_smoke

    rng = np.random.RandomState(9)
    cfg = dataclasses.replace(j_smoke("glm4-9b"), kv_bits=4)
    j_pool = jkvc.init_page_pool(cfg, 8, 8)
    assert j_pool["k"].dtype == jnp.uint8
    k = rng.randn(1, 24, cfg.n_kv_heads, cfg.hd).astype(np.float32) * 2
    v = rng.randn(1, 24, cfg.n_kv_heads, cfg.hd).astype(np.float32)
    ids = np.array([4, 7, 0], np.int32)
    want = jax.jit(jkvc.write_prompt_pages)(j_pool, jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(ids))
    t_cfg = dataclasses.replace(t_smoke("glm4-9b"), kv_bits=4)
    t_pool = tkvc.init_page_pool(t_cfg, 8, 8, device="cpu")
    assert {k_: (tuple(t.shape), t.dtype) for k_, t in t_pool.items()} == {
        "k": ((8, cfg.n_kv_heads, 8, cfg.hd // 2), torch.uint8),
        "v": ((8, cfg.n_kv_heads, 8, cfg.hd // 2), torch.uint8),
        "k_scale": ((8, cfg.n_kv_heads, 8), torch.float32),
        "v_scale": ((8, cfg.n_kv_heads, 8), torch.float32)}
    got = tkvc.write_prompt_pages(t_pool, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(ids))
    for key in want:  # page 0 (trash) takes the pad rows: compare real pages
        assert _same_bits(got[key].numpy()[1:], np.asarray(want[key])[1:]), key
    pre = np.array([7, 4], np.int32)
    gk_j, gv_j = jkvc.gather_prefix(want, jnp.asarray(pre))
    gk_t, gv_t = tkvc.gather_prefix(got, torch.from_numpy(pre))
    assert tuple(gk_t.shape) == (1, 16, cfg.n_kv_heads, cfg.hd)
    assert _same_bits(gk_t.numpy(), gk_j) and _same_bits(gv_t.numpy(), gv_j)


def test_int4_pool_shape_rules():
    """Odd head dims cannot be nibble-packed; the bytes per token are half
    the int8 tier's values plus the same scales."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config("glm4-9b")
    with pytest.raises(ValueError, match="even head dim"):
        tkvc.init_page_pool(dataclasses.replace(cfg, kv_bits=4, head_dim=15), 4, 8,
                            device="cpu")
    b4 = tkvc.kv_bytes_per_token(dataclasses.replace(cfg, kv_bits=4))
    b8 = tkvc.kv_bytes_per_token(dataclasses.replace(cfg, kv_bits=8))
    assert b4 == cfg.n_layers * cfg.n_kv_heads * (cfg.hd + 8) < b8
