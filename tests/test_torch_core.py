"""Port parity, core: quantizer, clipping, OCS splits and the quantized tree
of ``repro_torch`` against ``repro`` on the same numpy inputs.

Every contract here is bitwise: integer grids, scales, clip thresholds,
split tables and expanded weights are exact functions of their inputs in
both packages (the port's on-device split and histogram compute the same
float32 values as the reference's host numpy).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from _torch_interop import (  # noqa: F401
    SERVE_RECIPE, glm_smoke, glm_smoke_served, jax_tree_to_numpy, torch_threads)

from repro.core import clipping as jclip
from repro.core import ocs as jocs
from repro.core import quantizer as jq
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.recipe import QuantRecipe as JRecipe

from repro_torch.core import clipping as tclip
from repro_torch.core import ocs as tocs
from repro_torch.core import quantizer as tq
from repro_torch.core.apply import quantize_params as t_quantize_params
from repro_torch.core.ocs import OCSQuantLinear
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.interop import params_from_numpy


def _outlier_matrix(seed, cin, cout):
    rng = np.random.RandomState(seed)
    w = rng.randn(cin, cout).astype(np.float32)
    w[rng.randint(0, cin, 4), rng.randint(0, cout, 4)] *= 9.0
    return w


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("channel_axis", [None, 1])
def test_quantize_tensor_bitwise(bits, channel_axis):
    w = _outlier_matrix(bits + 7 * (channel_axis or 0), 96, 40)
    want = jq.quantize_tensor(jnp.asarray(w), bits, channel_axis=channel_axis)
    got = tq.quantize_tensor(torch.from_numpy(w), bits, channel_axis=channel_axis)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_quantize_int_ties_round_up():
    """floor(v + 1/2): grid midpoints round up, never to even."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    got = tq.quantize_int(x, torch.tensor(1.0), 8)
    want = jq.quantize_int(jnp.asarray(x.numpy()), jnp.float32(1.0), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1, 2, 3, 0, -1, -2]


@pytest.mark.parametrize("method", [None, "mse"])
def test_find_clip_on_tensor_bitwise(method):
    """The port bins a tensor on its own device; thresholds equal the
    reference's host-numpy histogram sweep exactly."""
    w = _outlier_matrix(3, 200, 64)
    want = jclip.find_clip(w, 8, method)
    got = tclip.find_clip(torch.from_numpy(w), 8, method)
    assert got == want
    h_t = tclip._tensor_to_hist(torch.from_numpy(w))
    h_j = jclip._tensor_to_hist(w)
    np.testing.assert_array_equal(h_t.counts, h_j.counts)


@pytest.mark.parametrize("qa", [True, False])
@pytest.mark.parametrize("ratio", [0.0, 0.02, 0.1])
def test_split_weights_bitwise(ratio, qa):
    w = _outlier_matrix(int(ratio * 100) + qa, 150, 48)
    w_j, spec_j, t_j = jocs.split_weights(w, ratio, 8, qa=qa, clip_method="mse")
    w_t, spec_t, t_t = tocs.split_weights(torch.from_numpy(w), ratio, 8, qa=qa,
                                          clip_method="mse")
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    np.testing.assert_array_equal(spec_t.src.numpy(), np.asarray(spec_j.src))
    assert t_t == t_j


@settings(max_examples=12, deadline=None, database=None)
@given(
    cin=st.integers(2, 40),
    cout=st.integers(1, 12),
    ratio=st.sampled_from([0.05, 0.2, 0.5]),
    seed=st.integers(0, 2**16),
    ties=st.booleans(),
)
def test_split_weights_property_bitwise(cin, cout, ratio, seed, ties):
    """Random shapes, including exact row-max ties (first-index argmax)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(cin, cout).astype(np.float32)
    if ties:
        w = np.round(w * 2) / 2  # many equal |values|
    w_j, spec_j, t_j = jocs.split_weights(w, ratio, 8, qa=True, clip_method=None)
    w_t, spec_t, t_t = tocs.split_weights(torch.from_numpy(w), ratio, 8, qa=True)
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    np.testing.assert_array_equal(spec_t.src.numpy(), np.asarray(spec_j.src))
    assert t_t == t_j


@pytest.mark.parametrize("pad_to", [1, 32])
def test_make_ocs_quant_linear_bitwise(pad_to):
    w = _outlier_matrix(11, 100, 36)
    want = jocs.make_ocs_quant_linear(w, 0.05, 8, clip_method="mse",
                                      per_channel=True, pad_to=pad_to)
    got = tocs.make_ocs_quant_linear(torch.from_numpy(w), 0.05, 8, clip_method="mse",
                                     per_channel=True, pad_to=pad_to)
    np.testing.assert_array_equal(got.weight.values.numpy(), np.asarray(want.weight.values))
    np.testing.assert_array_equal(got.weight.scale.numpy(), np.asarray(want.weight.scale))
    for f in ("src", "mult", "bias"):
        np.testing.assert_array_equal(getattr(got.spec, f).numpy(),
                                      np.asarray(getattr(want.spec, f)))
    assert got.n_orig == want.n_orig


@pytest.mark.parametrize("ratio", [0.0, 0.02, 0.1])
def test_quantized_tree_bitwise(ratio, glm_smoke, glm_smoke_served):
    """quantize_params over the reference's init_params weights (converted
    through numpy) with the serving launcher's recipe: every quantized leaf
    (src, mult, bias, int8 values, scales) and every float leaf is equal."""
    _, params = glm_smoke
    kw = dict(SERVE_RECIPE, ocs_ratio=ratio)
    if ratio == SERVE_RECIPE["ocs_ratio"]:  # the shared pair (the engine test's)
        qj, got = glm_smoke_served
        want = jax_tree_to_numpy(qj)
    else:
        want = jax_tree_to_numpy(j_quantize_params(params, JRecipe(**kw)))
        got = t_quantize_params(params_from_numpy(jax_tree_to_numpy(params), "cpu"),
                                TRecipe(**kw), device="cpu")
    n_quant = 0

    def cmp(w, g, path):
        nonlocal n_quant
        if isinstance(w, dict) and "values" in w:
            assert isinstance(g, OCSQuantLinear), path
            n_quant += 1
            np.testing.assert_array_equal(g.weight.values.numpy(), w["values"], path)
            np.testing.assert_array_equal(g.weight.scale.numpy(), w["scale"], path)
            np.testing.assert_array_equal(g.spec.src.numpy(), w["src"], path)
            np.testing.assert_array_equal(g.spec.mult.numpy(), w["mult"], path)
            np.testing.assert_array_equal(g.spec.bias.numpy(), w["bias"], path)
            assert g.n_orig == w["n_orig"]
            if ratio > 0:
                assert g.spec.src.shape[-1] > g.n_orig, path  # splits happened
        elif isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                cmp(w[k], g[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, path)

    cmp(want, got, "")
    assert n_quant == 8  # wq wk wv wo w_gate w_up w_down lm_head


def test_params_from_numpy_round_trip():
    """Quantized leaves given as numpy dicts become OCSQuantLinear leaves
    equal to the reference's."""
    w = np.stack([_outlier_matrix(s, 64, 16) for s in range(2)])
    params = {"layers": {"attn": {"wq": jnp.asarray(w)}}}
    q = j_quantize_params(params, JRecipe(w_bits=8, ocs_ratio=0.05, per_channel=True))
    tree = params_from_numpy(jax_tree_to_numpy(q), "cpu")
    lin = tree["layers"]["attn"]["wq"]
    assert isinstance(lin, OCSQuantLinear)
    np.testing.assert_array_equal(lin.weight.values.numpy(),
                                  np.asarray(q["layers"]["attn"]["wq"].weight.values))
    one = lin.layer(1)
    assert one.weight.values.shape == lin.weight.values.shape[1:]
    assert one.is_packed()
