"""Port parity, the W4A8 tier: ``to_w4a8`` (the OCS-ranked split of an int8
``OCSQuantLinear`` into packed int4 rows and int8 outlier rows), the plain
PyTorch version of the W4A8 kernel (B6) and ``dense`` in mode ``w4a8``,
against the reference.

* ``to_w4a8`` is bitwise the reference's numpy conversion in all five
  arrays and the (padded) spec, for odd ``K_exp`` and stacked leaves.
* ``w4a8_matmul_plain`` is bitwise the reference's jitted
  ``w4a8_matmul_ref`` (``ops.w4a8_matmul(force="ref")``) and its
  interpret-mode Pallas kernel, for f32 and bf16 outputs. Their compiled
  epilogue contracts ``acc4 * (a_s * s4) + t8`` into one fused
  multiply-add, which the port computes exactly (``ref.fma_f32``).

The CUDA kernel runs only on the card: ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import jax_tree_to_numpy, to_np, torch_threads  # noqa: F401

from repro.core import ocs as jocs
from repro.kernels import ops as jops
from repro.models import layers as JL

from repro_torch.core import ocs as tocs
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _ref_linear(cin, cout, ocs_ratio, seed, layers=None):
    """A reference OCSQuantLinear (per-channel int8, MSE clip), stacked
    ``[layers, ...]`` when ``layers`` is given, and the port's copy of it."""
    rng = np.random.RandomState(seed)
    if layers is None:
        w = rng.randn(cin, cout).astype(np.float32)
        w[rng.randint(0, cin)] *= 6.0  # an outlier row
        lin = jocs.make_ocs_quant_linear(jnp.asarray(w), ocs_ratio, 8, clip_method="mse",
                                         per_channel=True)
    else:
        from repro.core.apply import quantize_params
        from repro.core.recipe import QuantRecipe

        w = rng.randn(layers, cin, cout).astype(np.float32)
        tree = quantize_params({"w": jnp.asarray(w)},
                               QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=ocs_ratio,
                                           per_channel=True, pad_to=1))
        lin = tree["w"]
    t_lin = params_from_numpy({"w": jax_tree_to_numpy(lin)}, "cpu")["w"]
    return lin, t_lin


@pytest.mark.parametrize("ratio", [0.0, 0.05, 0.25])
@pytest.mark.parametrize("layers,cin,ocs", [(None, 37, 0.05), (3, 48, 0.04)],
                         ids=["odd-Kexp", "stacked"])
def test_to_w4a8_bitwise(layers, cin, ocs, ratio):
    lin, t_lin = _ref_linear(cin, 24, ocs, seed=cin + int(100 * ratio), layers=layers)
    k_exp = lin.weight.values.shape[-2]
    if layers is None:
        assert k_exp % 2 == 1  # the dead-row padding path
    j = jocs.to_w4a8(lin, ratio)
    t = tocs.to_w4a8(t_lin, ratio)
    for name in ("w4", "s4", "w8", "s8", "outlier_idx"):
        assert _same_bits(getattr(t, name).numpy(), getattr(j, name)), name
    for name in ("src", "mult", "bias"):
        assert _same_bits(getattr(t.spec, name).numpy(), getattr(j.spec, name)), name
    assert (t.n_orig, t.a_bits) == (j.n_orig, j.a_bits)
    k_even = k_exp + k_exp % 2
    assert t.w4.shape[-2] * 2 == k_even
    assert t.w8.shape[-2] == (0 if ratio == 0 else int(np.ceil(ratio * k_even)))
    if layers is not None:
        one = t.layer(1)
        assert torch.equal(one.w4, t.w4[1]) and torch.equal(one.outlier_idx, t.outlier_idx[1])
    with pytest.raises(ValueError, match="ratio"):
        tocs.to_w4a8(t_lin, 1.5)


def _w4a8_case(k, n, s, t, seed):
    """A reference W4A8Linear with S OCS duplicates and T outlier rows."""
    ocs = 0.0 if s == 0 else s / k
    lin, _ = _ref_linear(k, n, ocs, seed)
    assert lin.weight.values.shape[0] - k == s
    ratio = 0.0 if t == 0 else t / lin.weight.values.shape[0]
    jw = jocs.to_w4a8(lin, ratio)
    assert jw.n_outliers == t
    return jw, params_from_numpy({"w": jax_tree_to_numpy(jw)}, "cpu")["w"]


W4A8_CASES = [
    # (M, K, N, S, T)
    (5, 96, 40, 0, 0),
    (17, 96, 40, 0, 5),
    (9, 120, 64, 4, 0),
    (33, 120, 64, 4, 7),
    (1, 250, 48, 6, 13),  # a decode row
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n,s,t", W4A8_CASES)
def test_w4a8_plain_bitwise_vs_reference(m, k, n, s, t, bf16):
    jw, tw = _w4a8_case(k, n, s, t, seed=m + k + s + t)
    rng = np.random.RandomState(m * 7 + t)
    x = (rng.randn(m, k) * 2.5).astype(np.float32)
    x[:, rng.randint(0, k)] *= 8.0  # an outlier column sets the row scale
    dt = jnp.bfloat16 if bf16 else jnp.float32
    xj = jnp.asarray(x, dt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    xt = xt.to(torch.bfloat16) if bf16 else xt
    src_j = jw.spec.src[jw.n_orig:]
    args_j = (jw.w4, jw.s4, jw.w8, jw.s8, src_j, jw.outlier_idx)
    got = ops.w4a8_matmul(xt, tw.w4, tw.s4, tw.w8, tw.s8, tw.spec.src[tw.n_orig:],
                          tw.outlier_idx, out_dtype=xt.dtype)
    assert got.dtype == xt.dtype and tuple(got.shape) == (m, n)
    for force in ("ref", "interpret"):
        want = jops.w4a8_matmul(xj, *args_j, force=force, out_dtype=dt)
        assert _same_bits(to_np(got), np.asarray(want.astype(jnp.float32))), force


def test_fma_f32_rounds_once():
    """``fma_f32`` rounds the exact ``a * b + c``, also where the float64 sum
    lands exactly halfway between two float32 values: (2^30 + 1) * 2^-24
    + 2^30 is 2^30 + 2^6 + 2^-24, just above the midpoint 2^30 + 2^6, so
    it rounds up (a float64 sum rounded again would give 2^30)."""
    a = torch.tensor([1321.0 * 61 * 41, -1321.0 * 61 * 41, 3.0])
    b = torch.tensor([325.0 * 2.0 ** -24, 325.0 * 2.0 ** -24, 0.5])
    c = torch.tensor([2.0 ** 30, -(2.0 ** 30), 1.0])
    got = tref.fma_f32(a, b, c)
    want = torch.tensor([2.0 ** 30 + 2 ** 7, -(2.0 ** 30 + 2 ** 7), 2.5])
    assert torch.equal(got, want)
    assert float((a[:1].double() * b[:1].double() + c[:1].double()).float()) == 2.0 ** 30


def test_dense_w4a8_matches_reference():
    """``dense`` on a W4A8Linear in mode ``w4a8`` (3-D bf16 activations, as
    the model calls it) is bitwise the reference's XLA route; other modes
    and an OCSQuantLinear in ``w4a8`` raise."""
    jw, tw = _w4a8_case(120, 64, 4, 7, seed=3)
    x = np.random.RandomState(4).randn(2, 3, 120).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    with JL.serving_mode("w4a8", kernel="xla"):
        want = jax.jit(lambda w, a: JL.dense(w, a))(jw, xj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = TL.dense(tw, xt, mode="w4a8")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 64)
    assert _same_bits(to_np(got), np.asarray(want.astype(jnp.float32)))
    for mode in ("dequant", "w8a8"):
        with pytest.raises(ValueError, match="W4A8Linear weights serve in matmul mode"):
            TL.dense(tw, xt, mode=mode)
    _, t_lin = _ref_linear(120, 64, 0.05, seed=5)
    with pytest.raises(ValueError, match="to_w4a8"):
        TL.dense(t_lin, xt, mode="w4a8")
