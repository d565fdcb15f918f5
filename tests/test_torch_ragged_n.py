"""Port parity at a ragged N (N % 4 != 0): the plain PyTorch versions of the
four GEMMs -- ``fused_qmatmul`` (B1), ``ocs_matmul`` (B4), ``quant_matmul``
(B5) and ``w4a8_qmatmul`` (B6) -- against the reference's wrappers, which
pad N to their tile and slice the result, on the same numpy inputs.

The card's kernels take such an N too (B1 in its kernel, B4/B5/B6 zero-padded
to a multiple of 16 in their wrappers); ``tests/test_torch_cuda.py`` holds
them against these plain versions there. Shapes: a small ragged N (37),
against the interpret-mode Pallas kernels, and hymba-1.5b's lm_head (K 1600,
N 32001), against the reference's oracles (``force="ref"``), which its
serving path runs on a machine without a TPU.

* B1, B6 and the int8 paths of B4/B5 are **bitwise**, as at any other N
  (B4's int8 path within ``rtol=1e-6`` of the oracle, whose epilogue is
  grouped otherwise, as in ``tests/test_torch_ocs_matmul.py``).
* The weight-only paths agree within the float32 summation-order bound of
  ``tests/test_torch_ocs_matmul.py`` (``WO_TOL_FACTOR``).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import jax_tree_to_numpy, to_np, torch_threads  # noqa: F401

from repro.core import ocs as jocs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_qmatmul import fused_quant_matmul as j_fused

from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops

WO_TOL_FACTOR = 2.0

# (M, K, S, N): a small ragged N at a decode row and at a prefill, and
# hymba-1.5b's lm_head at a decode step (its vocab, 32001 columns).
SMALL = [(5, 300, 7, 37), (33, 130, 0, 37)]
HYMBA = (8, 1600, 32, 32001)


def _case(m, k, s, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 2.5).astype(np.float32)
    x[:, rng.randint(0, k)] *= 7.0  # an outlier column sets the row scale
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16 values
    x8 = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w8 = rng.randint(-127, 128, (k + s, n)).astype(np.int8)
    ws = (rng.rand(n) * 0.01 + 1e-4).astype(np.float32)
    xs = (rng.rand(m) * 0.05 + 1e-3).astype(np.float32)
    src = rng.randint(0, k, s).astype(np.int32)
    mask = rng.randint(0, 2, s).astype(np.float32)
    return x, x8, w8, ws, xs, src, mask


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize("m,k,s,n", SMALL + [HYMBA])
def test_fused_qmatmul_plain_ragged_n_bitwise(m, k, s, n):
    """B1's plain version at a ragged N: bitwise the reference's kernel
    (interpret mode, which pads N to its 128-column tile) at N = 37, and its
    jitted oracle at both shapes, with bf16 and f32 outputs."""
    x, _, w8, ws, _, src, _ = _case(m, k, s, n, m + k + n)
    xj = jnp.asarray(x, jnp.bfloat16)
    for out_j, out_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = ops.fused_quant_matmul(_t(x).to(torch.bfloat16), _t(w8), _t(ws), _t(src),
                                     out_dtype=out_t)
        assert tuple(got.shape) == (m, n)
        oracle = jax.jit(jref.fused_quant_matmul_ref, static_argnums=(4, 5))(
            xj, jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(src), 8, out_j)
        np.testing.assert_array_equal(_bits(to_np(got)), _bits(oracle.astype(jnp.float32)))
        if n < 128:
            kern = j_fused(xj, jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(src),
                           interpret=True, out_dtype=out_j)
            np.testing.assert_array_equal(_bits(to_np(got)), _bits(kern.astype(jnp.float32)))


@pytest.mark.parametrize("m,k,s,n", SMALL + [HYMBA])
def test_ocs_quant_matmul_plain_ragged_n(m, k, s, n):
    """B4 (B5 when S == 0) at a ragged N: the int8 path with a 0/1 tail
    mask bitwise the reference's interpret-mode kernel at N = 37, and within
    ``rtol=1e-6`` of its oracle at hymba-1.5b's lm_head (the oracle groups
    the epilogue ``(acc * x_scale) * w_scale``, the kernels ``acc * (x_scale
    * w_scale)``); the weight-only path (bf16 x) within the summation-order
    bound of either."""
    x, x8, w8, ws, xs, src, mask = _case(m, k, s, n, 3 * m + k + n)
    force = "interpret" if n < 128 else "ref"
    want8 = jops.ocs_quant_matmul(jnp.asarray(x8), jnp.asarray(w8), jnp.asarray(ws),
                                  jnp.asarray(src), jnp.asarray(xs), jnp.asarray(mask),
                                  tail_is_mask=True, force=force)
    got8 = ops.ocs_quant_matmul(_t(x8), _t(w8), _t(ws), _t(src), _t(xs), _t(mask))
    assert tuple(got8.shape) == (m, n)
    if force == "interpret":
        np.testing.assert_array_equal(_bits(got8.numpy()), _bits(want8))
    else:  # the oracle groups the epilogue (acc * x_scale) * w_scale
        np.testing.assert_allclose(got8.numpy(), np.asarray(want8), rtol=1e-6)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jops.ocs_quant_matmul(xj, jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(src),
                                 None, jnp.asarray(mask), force=force, out_dtype=jnp.float32)
    got = ops.ocs_quant_matmul(_t(x).to(torch.bfloat16), _t(w8), _t(ws), _t(src), None,
                               _t(mask), out_dtype=torch.float32)
    xe = np.concatenate([x, x[:, src] * mask], 1)
    bound = (WO_TOL_FACTOR * (k + s + 2) * 2.0 ** -24
             * (np.abs(xe) @ np.abs(w8).astype(np.float32)) * ws)
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


@pytest.mark.parametrize("m,k,n", [(5, 300, 37), (17, 150, 37)])
def test_quant_matmul_plain_ragged_n(m, k, n):
    """B5 through its own entry at a ragged N: int8 bitwise the reference's
    interpret-mode kernel, weight-only within the summation-order bound."""
    _, x8, w8, ws, xs, _, _ = _case(m, k, 0, n, 5 * m + k)
    want8 = jops.quant_matmul(jnp.asarray(x8), jnp.asarray(w8), jnp.asarray(ws),
                              jnp.asarray(xs), force="interpret")
    got8 = ops.quant_matmul(_t(x8), _t(w8), _t(ws), _t(xs))
    np.testing.assert_array_equal(_bits(got8.numpy()), _bits(want8))
    x = _case(m, k, 0, n, 7 * m + k)[0]
    want = jops.quant_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w8), jnp.asarray(ws),
                             force="interpret", out_dtype=jnp.float32)
    got = ops.quant_matmul(_t(x).to(torch.bfloat16), _t(w8), _t(ws), out_dtype=torch.float32)
    bound = WO_TOL_FACTOR * (k + 2) * 2.0 ** -24 * (np.abs(x) @ np.abs(w8).astype(np.float32)) * ws
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


@pytest.mark.parametrize("k,n,ratio", [(96, 37, 0.05), (120, 37, 0.0), (1600, 32001, 0.05)])
def test_w4a8_plain_ragged_n_bitwise(k, n, ratio):
    """B6's plain version at a ragged N, on a reference W4A8 leaf (per-channel
    int8 with MSE clipping, OCS r = 0.02, converted by ``to_w4a8``): bitwise
    the reference's oracle, and its interpret-mode kernel at N = 37, with f32
    and bf16 outputs."""
    rng = np.random.RandomState(k + n)
    w = rng.randn(k, n).astype(np.float32)
    w[rng.randint(0, k)] *= 6.0  # an outlier row
    lin = jocs.make_ocs_quant_linear(jnp.asarray(w), 0.02, 8, clip_method="mse",
                                     per_channel=True)
    jw = jocs.to_w4a8(lin, ratio)
    tw = params_from_numpy({"w": jax_tree_to_numpy(jw)}, "cpu")["w"]
    x = (rng.randn(3, k) * 2.5).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    args_j = (jw.w4, jw.s4, jw.w8, jw.s8, jw.spec.src[jw.n_orig:], jw.outlier_idx)
    args_t = (tw.w4, tw.s4, tw.w8, tw.s8, tw.spec.src[tw.n_orig:], tw.outlier_idx)
    for out_j, out_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = ops.w4a8_matmul(xt, *args_t, out_dtype=out_t)
        assert tuple(got.shape) == (3, n)
        for force in ("ref", "interpret") if n < 128 else ("ref",):
            want = jops.w4a8_matmul(xj, *args_j, force=force, out_dtype=out_j)
            np.testing.assert_array_equal(_bits(to_np(got)), _bits(want.astype(jnp.float32)))
