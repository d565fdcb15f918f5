"""Port parity, clipping and fake quantization: ``core.quantizer.fake_quant``,
``core.clipping`` (none, mse, aciq, kl) and ``core.ocs.split_weights`` with
each clip method against ``repro.core`` on the same numpy inputs.

Every comparison is exact (tolerance 0): the grids are the integer path's,
the thresholds come from the same host-side arithmetic on equal histogram
counts, and the splits are the same float32 operations.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_interop import torch_threads  # noqa: F401

from repro.core import clipping as JC
from repro.core import ocs as JO
from repro.core import quantizer as JQ
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.recipe import QuantRecipe as JRecipe

from repro_torch.core import clipping as TC
from repro_torch.core import fake_quant as t_fake_quant
from repro_torch.core import ocs as TO
from repro_torch.core.apply import quantize_params as t_quantize_params
from repro_torch.core.histogram import StreamingHistogram
from repro_torch.core.recipe import QuantRecipe as TRecipe

from _torch_interop import jax_tree_to_numpy

METHODS = [None, "mse", "aciq", "kl"]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _gauss_outliers(seed, shape=(96, 160)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    idx = rng.choice(x.size, 12, replace=False)
    x.reshape(-1)[idx] *= rng.uniform(6, 12, 12).astype(np.float32)
    return x


def _laplace(seed, shape=(96, 160)):
    return np.random.default_rng(seed).laplace(0, 0.3, shape).astype(np.float32)


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("channel_axis,clip", [(None, None), (None, 1.7), (1, None), (0, None)])
def test_fake_quant_bitwise(bits, channel_axis, clip):
    """Quantize-dequantize per tensor (with and without a clip threshold)
    or per channel on either axis: bitwise the reference's."""
    x = _gauss_outliers(bits)
    want = JQ.fake_quant(jnp.asarray(x), bits, channel_axis=channel_axis, clip=clip)
    got = t_fake_quant(torch.from_numpy(x), bits, channel_axis=channel_axis, clip=clip)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("dist", ["gauss", "laplace"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_find_clip_exact(dist, method, bits):
    """The threshold of each method equals the reference's exactly, on a
    tensor (binned in torch) and on a streamed histogram."""
    x = _gauss_outliers(7) if dist == "gauss" else _laplace(7)
    want = JC.find_clip(x, bits, method)
    assert TC.find_clip(torch.from_numpy(x), bits, method) == want
    assert TC.find_clip(x, bits, method) == want
    h = StreamingHistogram()
    for part in np.array_split(x.reshape(-1), 3):
        h.update(part)
    from repro.core.histogram import StreamingHistogram as JH

    jh = JH()
    for part in np.array_split(x.reshape(-1), 3):
        jh.update(part)
    assert TC.find_clip(h, bits, method) == JC.find_clip(jh, bits, method)


def test_kl_aciq_helpers_exact():
    """The KL pieces (smoothing, divergence) and ACIQ's closed-form MSEs and
    golden-section search equal the reference's."""
    rng = np.random.default_rng(3)
    p = rng.integers(0, 5, 300).astype(np.float64)
    q = rng.integers(0, 5, 300).astype(np.float64)
    np.testing.assert_array_equal(TC._smooth_distribution(p), JC._smooth_distribution(p))
    assert TC._kl(TC._smooth_distribution(p), TC._smooth_distribution(q)) == JC._kl(
        JC._smooth_distribution(p), JC._smooth_distribution(q))
    for a in (0.0, 0.3, 1.7, 4.0):
        assert TC._gauss_clip_mse(a, 0.8, 4) == JC._gauss_clip_mse(a, 0.8, 4)
        assert TC._laplace_clip_mse(a, 0.5, 3) == JC._laplace_clip_mse(a, 0.5, 3)
    f = lambda a: (a - 1.234) ** 2  # noqa: E731
    assert TC._golden_min(f, 0.0, 5.0) == JC._golden_min(f, 0.0, 5.0)


def test_clip_methods_and_refusal():
    assert set(TC.CLIP_METHODS) == set(JC.CLIP_METHODS) == {"mse", "aciq", "kl"}
    with pytest.raises(ValueError, match="unknown clip method"):
        TC.find_clip(np.ones(4, np.float32), 8, "percentile")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("qa", [True, False])
@pytest.mark.parametrize("ratio,bits", [(0.0, 4), (0.05, 3), (0.1, 6)])
def test_split_weights_bitwise(method, qa, ratio, bits):
    """``split_weights`` with each clip method: the expanded weights, the
    split table and the post-split threshold bitwise the reference's."""
    w = _gauss_outliers(11, (80, 48))
    wj, sj, tj = JO.split_weights(w, ratio, bits, qa=qa, clip_method=method)
    wt, st, tt = TO.split_weights(torch.from_numpy(w), ratio, bits, qa=qa, clip_method=method)
    np.testing.assert_array_equal(_bits(wt.numpy()), _bits(wj))
    np.testing.assert_array_equal(st.src.numpy(), np.asarray(sj.src))
    np.testing.assert_array_equal(st.mult.numpy(), np.asarray(sj.mult))
    np.testing.assert_array_equal(st.bias.numpy(), np.asarray(sj.bias))
    assert tt == tj


@pytest.mark.parametrize("method", ["aciq", "kl"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_params_aciq_kl(method, per_channel):
    """``QuantRecipe(w_clip="aciq"|"kl")`` builds serving trees (no longer
    refused), each leaf's int grid, scale and split table bitwise the
    reference's."""
    rng = np.random.default_rng(5)
    tree = {"layers": {"mlp": {"w_up": _gauss_outliers(1, (2, 64, 48)),
                               "w_down": _laplace(2, (2, 48, 64))}},
            "lm_head": _gauss_outliers(3, (64, 32)),
            "final_norm": {"scale": rng.standard_normal(64).astype(np.float32)}}
    kw = dict(w_bits=8, w_clip=method, ocs_ratio=0.05, per_channel=per_channel, pad_to=1)
    want = jax_tree_to_numpy(j_quantize_params(
        {"layers": {"mlp": {k: jnp.asarray(v) for k, v in tree["layers"]["mlp"].items()}},
         "lm_head": jnp.asarray(tree["lm_head"]),
         "final_norm": {"scale": jnp.asarray(tree["final_norm"]["scale"])}}, JRecipe(**kw)))
    got = t_quantize_params({"layers": {"mlp": {k: torch.from_numpy(v) for k, v in
                                                tree["layers"]["mlp"].items()}},
                             "lm_head": torch.from_numpy(tree["lm_head"]),
                             "final_norm": {"scale": torch.from_numpy(
                                 tree["final_norm"]["scale"])}},
                            TRecipe(**kw), device="cpu")
    for leaf_w, leaf_t in ((want["lm_head"], got["lm_head"]),
                           (want["layers"]["mlp"]["w_up"], got["layers"]["mlp"]["w_up"]),
                           (want["layers"]["mlp"]["w_down"], got["layers"]["mlp"]["w_down"])):
        np.testing.assert_array_equal(leaf_t.weight.values.numpy(), leaf_w["values"])
        np.testing.assert_array_equal(_bits(leaf_t.weight.scale.numpy()), _bits(leaf_w["scale"]))
        np.testing.assert_array_equal(leaf_t.spec.src.numpy(), leaf_w["src"])
