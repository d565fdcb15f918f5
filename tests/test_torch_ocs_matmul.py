"""Port parity, the weight-only / OCS matmul kernels: the plain PyTorch
versions of ``dynamic_quant`` (B3), ``ocs_matmul`` (B4) and ``quant_matmul``
(B5), called through ``repro_torch.kernels.ops``, against the reference's
Pallas wrappers run the way its own tests run them on the CPU (interpret
mode), on the same numpy inputs at ragged shapes.

* B3 and the int8 paths of B4/B5 are **bitwise**: the quantization is the
  same IEEE arithmetic, int32 sums are exact, and the epilogue is grouped
  ``acc * (x_scale * w_scale)`` like the kernels'. They are within
  ``rtol=1e-6`` of the reference's oracles, which group it ``(acc *
  x_scale) * w_scale`` (the reference's own test tolerance).
* The weight-only paths sum the same float32 products in another order
  (the interpret-mode kernel by 128-row K blocks, the plain version in one
  matmul). Elementwise they must agree within ``WO_TOL_FACTOR * (K + 2) *
  2**-24 * (|x_exp| @ |w|) * |w_scale|``, twice the classic bound on the
  rounding error of one float32 sum of K terms (the products of bf16
  activations and int8 weights are exact; of f32 activations, rounded once
  each, which the bound covers). Measured here: 0.10% to 0.49% of the
  bound (``test_weight_only_within_summation_bound`` prints the share).
  bf16 outputs are within that bound plus one bf16 ulp (an output near
  zero after cancellation can be several bf16 steps apart within it).

The CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import to_np, torch_threads  # noqa: F401

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ocs_matmul as tom
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref

WO_TOL_FACTOR = 2.0


def _bf16_ulp(v):
    """One bf16 step at each value of ``v``."""
    _, e = np.frexp(np.maximum(np.abs(v), 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


def _case(seed, m, k, n, s, xkind, mult_kind):
    """x [M, K] (f32, bf16 or int8), w8 [K+S, N], w_scale [N], src_tail
    [S], x_scale [M], tail_mult [S] (None, a 0/1 mask, or 0.5/1/0)."""
    rng = np.random.RandomState(seed)
    if xkind == "int8":
        x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    else:
        x = (rng.randn(m, k) * 2.0).astype(np.float32)
        if xkind == "bf16":  # bf16-representable values
            x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w8 = rng.randint(-127, 128, (k + s, n)).astype(np.int8)
    ws = (rng.rand(n) * 0.01 + 1e-4).astype(np.float32)
    src = rng.randint(0, k, s).astype(np.int32)
    xs = (rng.rand(m) * 0.05 + 1e-3).astype(np.float32)
    mult = None
    if mult_kind == "mask":
        mult = rng.randint(0, 2, s).astype(np.float32)
    elif mult_kind == "half":
        mult = rng.choice([0.0, 0.5, 1.0], s).astype(np.float32)
    return x, w8, ws, src, xs, mult


def _jx(x, xkind):
    return jnp.asarray(x, jnp.bfloat16) if xkind == "bf16" else jnp.asarray(x)


def _tx(x, xkind):
    t = torch.from_numpy(x.copy())
    return t.to(torch.bfloat16) if xkind == "bf16" else t


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a).copy())


def _x_exp(x, src, mult):
    tail = x[:, src].astype(np.float32)
    if mult is not None:
        tail = tail * mult
    return np.concatenate([x.astype(np.float32), tail], 1)


# (M, K, N, S): S = 0 (B5 through B4's wrapper), a small tail, and a tail
# of two 128-row tiles; no dimension a multiple of anything.
SHAPES = [(5, 300, 72, 7), (33, 130, 36, 130), (3, 200, 52, 0)]


@pytest.mark.parametrize("m,k,n,s", SHAPES)
def test_int8_paths_bitwise(m, k, n, s):
    """B4's int8 path (B5 when S == 0) with a 0/1 tail mask and per-row
    activation scales: bitwise the interpret-mode kernel."""
    x, w8, ws, src, xs, mult = _case(m * 7 + s, m, k, n, s, "int8", "mask")
    # The reference's jitted dispatch cannot inspect a traced mask: it is
    # declared (tail_is_mask), as its own serving callers declare it.
    want = jops.ocs_quant_matmul(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(ws),
                                 jnp.asarray(src), jnp.asarray(xs), jnp.asarray(mult),
                                 tail_is_mask=True, force="interpret")
    got = ops.ocs_quant_matmul(_t(x), _t(w8), _t(ws), _t(src), _t(xs), _t(mult))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = jref.ocs_quant_matmul_ref(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(ws),
                                       jnp.asarray(src), jnp.asarray(xs),
                                       jnp.asarray(mult.astype(np.int8)))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-6)


def test_quant_matmul_int8_bitwise():
    x, w8, ws, _, xs, _ = _case(3, 17, 150, 44, 0, "int8", None)
    want = jops.quant_matmul(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(ws),
                             jnp.asarray(xs), force="interpret")
    got = ops.quant_matmul(_t(x), _t(w8), _t(ws), _t(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(xs),
                                   jnp.asarray(ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-6)


@pytest.mark.parametrize(
    "m,k,n,s,xkind,mult_kind",
    [(5, 300, 72, 7, "bf16", "half"), (33, 130, 36, 130, "f32", "mask"),
     (3, 200, 52, 0, "bf16", None), (9, 140, 20, 5, "f32", "half")],
)
def test_weight_only_within_summation_bound(m, k, n, s, xkind, mult_kind, capsys):
    """Weight-only B4 (B5 when S == 0) with 0/1 and 0.5 tail multipliers:
    f32 outputs within the summation-order bound of the interpret-mode
    kernel's, bf16 outputs within it plus one bf16 ulp."""
    x, w8, ws, src, _, mult = _case(k + s, m, k, n, s, xkind, mult_kind)
    jm = None if mult is None else jnp.asarray(mult)
    args_j = (_jx(x, xkind), jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(src))
    args_t = (_tx(x, xkind), _t(w8), _t(ws), _t(src))
    want = jops.ocs_quant_matmul(*args_j, None, jm, force="interpret", out_dtype=jnp.float32)
    got = ops.ocs_quant_matmul(*args_t, None, _t(mult), out_dtype=torch.float32)
    xe = _x_exp(x, src, mult)
    bound = (WO_TOL_FACTOR * (k + s + 2) * 2.0 ** -24
             * (np.abs(xe) @ np.abs(w8).astype(np.float32)) * ws)
    err = np.abs(got.numpy() - np.asarray(want))
    share = float((err / bound).max())
    with capsys.disabled():
        print(f"\n  weight-only M={m} K={k}+{s} {xkind}: max |d| {err.max():.3g}, "
              f"{share:.4f} of the bound")
    assert share <= 1.0
    want16 = jops.ocs_quant_matmul(*args_j, None, jm, force="interpret")
    got16 = ops.ocs_quant_matmul(*args_t, None, _t(mult))
    assert got16.dtype == args_t[0].dtype  # out_dtype defaults to x.dtype
    if xkind == "bf16":
        a, b = to_np(got16), np.asarray(want16.astype(jnp.float32))
        assert np.all(np.abs(a - b) <= bound + _bf16_ulp(np.maximum(np.abs(a), np.abs(b))))


def test_weight_only_ref_and_quant_matmul_weight_only():
    """``ref.weight_only_ref`` (the port of ``ops._weight_only_ref``) and
    ``ops.quant_matmul`` on float x against the reference's oracle and
    interpret-mode kernel, within the summation bound."""
    x, w8, ws, _, _, _ = _case(11, 6, 260, 40, 0, "bf16", None)
    xj = _jx(x, "bf16")
    bound = (WO_TOL_FACTOR * 262 * 2.0 ** -24
             * (np.abs(x) @ np.abs(w8).astype(np.float32)) * ws)
    for want, got in (
        (jops._weight_only_ref(xj, jnp.asarray(w8), jnp.asarray(ws), jnp.float32),
         tref.weight_only_ref(_tx(x, "bf16"), _t(w8), _t(ws), torch.float32)),
        (jops.quant_matmul(xj, jnp.asarray(w8), jnp.asarray(ws), force="interpret",
                           out_dtype=jnp.float32),
         ops.quant_matmul(_tx(x, "bf16"), _t(w8), _t(ws), out_dtype=torch.float32)),
    ):
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


@pytest.mark.parametrize("m,k,bits,xkind", [(130, 96, 8, "f32"), (1, 2048, 8, "bf16"),
                                            (7, 300, 4, "bf16")])
def test_dynamic_quant_bitwise(m, k, bits, xkind):
    x = (np.random.RandomState(m + k).randn(m, k) * 3.0).astype(np.float32)
    q_j, s_j = jops.dynamic_quant(_jx(x, xkind), bits=bits, force="interpret")
    q_t, s_t = ops.dynamic_quant(_tx(x, xkind), bits=bits)
    assert q_t.dtype == torch.int8 and s_t.shape == (m,)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_int8_path_refuses_fractional_tail_mult():
    x, w8, ws, src, xs, _ = _case(1, 4, 40, 8, 3, "int8", None)
    with pytest.raises(ValueError, match="fractional tail_mult"):
        ops.ocs_quant_matmul(_t(x), _t(w8), _t(ws), _t(src), _t(xs),
                             torch.tensor([1.0, 0.5, 0.0]))
    # A declared 0/1 mask is taken as is, and equals the checked one.
    mask = torch.tensor([1.0, 0.0, 1.0])
    a = ops.ocs_quant_matmul(_t(x), _t(w8), _t(ws), _t(src), _t(xs), mask)
    b = ops.ocs_quant_matmul(_t(x), _t(w8), _t(ws), _t(src), _t(xs), mask, tail_is_mask=True)
    assert torch.equal(a, b)


def test_no_split_takes_quant_matmul(monkeypatch):
    """S == 0 goes to B5's plain version, as the reference falls back to
    its plain kernel."""
    calls = []
    real = tqm.quant_matmul_plain
    monkeypatch.setattr(tqm, "quant_matmul_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w8, ws, src, _, _ = _case(2, 3, 20, 8, 0, "bf16", None)
    ops.ocs_quant_matmul(_tx(x, "bf16"), _t(w8), _t(ws), _t(src))
    assert calls == [1]
    x2, w2, ws2, src2, _, _ = _case(2, 3, 20, 8, 2, "bf16", None)
    ops.ocs_quant_matmul(_tx(x2, "bf16"), _t(w2), _t(ws2), _t(src2))
    assert calls == [1]  # S > 0: B4's own plain version


def test_scalar_scales_broadcast():
    x, w8, ws, src, xs, mult = _case(5, 6, 50, 12, 4, "int8", "mask")
    n, m = w8.shape[1], x.shape[0]
    a = ops.ocs_quant_matmul(_t(x), _t(w8), torch.tensor(0.25), _t(src), 0.5, _t(mult))
    b = ops.ocs_quant_matmul(_t(x), _t(w8), torch.full((n,), 0.25), _t(src),
                             torch.full((m,), 0.5), _t(mult))
    assert torch.equal(a, b)
    xf = _tx(np.abs(x).astype(np.float32), "f32")
    a = ops.quant_matmul(xf, _t(w8[:50]), 0.125)
    b = ops.quant_matmul(xf, _t(w8[:50]), torch.full((n,), 0.125), torch.ones(m))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="w_scale"):
        ops.quant_matmul(xf, _t(w8[:50]), torch.ones(n + 1))


def test_wrong_shapes_raise():
    x, w8, ws, src, _, _ = _case(9, 4, 30, 8, 3, "bf16", None)
    with pytest.raises(ValueError, match="w8 rows"):
        ops.ocs_quant_matmul(_tx(x, "bf16"), _t(w8[:-1]), _t(ws), _t(src))
    assert tom.launches == 0 and tqm.launches == 0  # the CPU launches nothing
