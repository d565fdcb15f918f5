"""Port parity, the Mamba2 block (``repro_torch.models.ssm`` against
``repro.models.ssm``) on the same numpy inputs, seeded.

* ``_ssd_chunked``: the chunked SSD scan in float32, at a length that is a
  multiple of the chunk, one that is not (the chunk drops to the largest
  divisor, 12 for 24) and a prime one (chunks of 1). Both sides sum the
  same float32 products in another order (torch's einsum and XLA's dot),
  so outputs and final states agree to ``SSD_RTOL`` of their range.
* ``mamba2`` over a sequence and ``mamba2_decode`` step by step (outputs,
  the scan's final state, the decode state and conv window), on the smoke
  model's layer 0: float weights with float32 activations (``F32_RTOL``)
  and with bfloat16 activations, the serving dtype (``BF16_RTOL``: a
  flipped bf16 rounding moves a value by one bf16 step; observed 0.5%),
  and the quantized layer in each matmul mode (``QUANT_RTOL``: dynamic
  W8A8 turns such a flip into a whole int8 quantum, as in
  ``test_torch_model.py``; observed 1.7%). The scan's and the decode's
  float32 states agree to ~1e-6 of their range.
* ``quantize_params`` on the smoke mamba2 and hymba trees against the
  reference's, with the ragged SSM ``in_proj`` padded once, and
  ``to_w4a8`` on the padded leaf.
* The port's decode steps against the port's own chunked scan (the
  counterpart of the reference's
  ``test_models.py::test_mamba2_state_decode_matches_chunked``, at its
  tolerance), with the scan's final state against the decode state.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import SERVE_RECIPE, jax_tree_to_numpy, to_np, torch_threads  # noqa: F401

from repro.configs import smoke_config as j_smoke
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.ocs import OCSQuantLinear as JOCS
from repro.core.ocs import to_w4a8 as j_to_w4a8
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.ocs import OCSQuantLinear as TOCS
from repro_torch.core.ocs import to_w4a8 as t_to_w4a8
from repro_torch.interop import params_from_numpy
from repro_torch.models import ssm as TS

SSD_RTOL = 1e-5
F32_RTOL = 1e-4
BF16_RTOL = 0.01
QUANT_RTOL = 0.04
W4A8_RATIO = 0.05


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("s_len", [32, 24, 37])
def test_ssd_chunked_matches_reference(s_len):
    rng = np.random.default_rng(s_len)
    b, h, p, g, n = 2, 8, 16, 2, 16
    ins = (
        rng.normal(size=(b, s_len, h, p)).astype(np.float32),
        np.log1p(np.exp(rng.normal(size=(b, s_len, h)))).astype(np.float32),
        -rng.uniform(1, 4, size=(h,)).astype(np.float32),
        rng.normal(size=(b, s_len, g, n)).astype(np.float32),
        rng.normal(size=(b, s_len, g, n)).astype(np.float32),
    )
    y_j, st_j = JS._ssd_chunked(*(jnp.asarray(a) for a in ins), 16)
    y_t, st_t = TS._ssd_chunked(*(torch.as_tensor(a) for a in ins), 16)
    assert y_t.shape == y_j.shape and st_t.shape == st_j.shape
    assert np.isfinite(to_np(y_t)).all()
    assert _rel_err(to_np(y_t), y_j) <= SSD_RTOL
    assert _rel_err(to_np(st_t), st_j) <= SSD_RTOL


@pytest.fixture(scope="module")
def mamba_smoke():
    """The smoke mamba2-1.3b (the same config in both packages) and the
    reference's seed-0 params."""
    cfg = j_smoke("mamba2-1.3b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(t_smoke("mamba2-1.3b"))
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _layer0(tree):
    """Layer 0's ``ssm`` subtree of a reference tree (quantized leaves
    sliced too)."""
    return jax.tree.map(lambda a: a[0], tree["layers"]["ssm"])


def _run_both(cfg, pj, pt, u, mode, steps=8):
    """Reference and port on layer params ``pj``/``pt`` and input ``u``
    (a jax array; bf16 or f32): (y of mamba2 over ``u``, its final state,
    ``steps`` decode outputs over the first tokens, the decode state and
    conv window), each side as a tuple of numpy arrays."""
    kernel = "pallas" if mode == "dequant" else "xla"

    def jseq(p, x):
        with JL.serving_mode(mode, kernel=kernel):
            return JS.mamba2(p, x, cfg, return_state=True)

    def jdec(p, x, c):
        with JL.serving_mode(mode, kernel=kernel):
            return JS.mamba2_decode(p, x, c, cfg)

    jdec = jax.jit(jdec)
    yj, stj = jax.jit(jseq)(pj, u)
    cj = JS.init_ssm_cache(cfg, u.shape[0], dtype=jnp.float32)
    ut = torch.as_tensor(np.array(u.astype(jnp.float32))).to(
        torch.bfloat16 if u.dtype == jnp.bfloat16 else torch.float32)
    dj, dt_ = [], []
    with torch.no_grad():
        yt, stt = TS.mamba2(pt, ut, cfg, mode=mode, return_state=True)
        ct = TS.init_ssm_cache(cfg, u.shape[0], torch.float32, device="cpu")
        for t in range(steps):
            o, cj = jdec(pj, u[:, t:t + 1], cj)
            dj.append(np.asarray(o.astype(jnp.float32)))
            o, ct = TS.mamba2_decode(pt, ut[:, t:t + 1], ct, cfg, mode=mode)
            dt_.append(to_np(o))
    want = (np.asarray(yj.astype(jnp.float32)), np.asarray(stj), np.concatenate(dj, 1),
            np.asarray(cj["state"]), np.asarray(cj["conv"]))
    got = (to_np(yt), to_np(stt), np.concatenate(dt_, 1), to_np(ct["state"]),
           to_np(ct["conv"]))
    return want, got


def _assert_close(want, got, tol):
    for name, w, g in zip(("y", "state", "decode", "decode state", "conv"), want, got):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = _rel_err(g, w)
        print(f"{name}: {err:.3g}")
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_mamba2_float_weights_match_reference(mamba_smoke, dtype):
    cfg, params = mamba_smoke
    pj = _layer0(params)
    pt = params_from_numpy(jax_tree_to_numpy(pj), "cpu")
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32), dtype)
    want, got = _run_both(cfg, pj, pt, u, "dequant")
    _assert_close(want, got, F32_RTOL if dtype == jnp.float32 else BF16_RTOL)


@pytest.mark.parametrize("mode", ["dequant", "w8a8", "w4a8"])
def test_mamba2_quantized_matches_reference(mamba_smoke, mode):
    """The serving path: ``in_proj``/``out_proj`` quantized with the serving
    recipe (the conv, ``A_log``, ``D``, ``dt_bias`` and the norm skipped by
    the recipe's patterns), bfloat16 activations, in each matmul mode."""
    cfg, params = mamba_smoke
    qj = _layer0(j_quantize_params(params, JRecipe(**SERVE_RECIPE)))
    assert isinstance(qj["in_proj"], JOCS) and isinstance(qj["out_proj"], JOCS)
    assert not isinstance(qj["conv_w"], JOCS)
    if mode == "w4a8":
        qj = {k: (j_to_w4a8(v, W4A8_RATIO) if isinstance(v, JOCS) else v)
              for k, v in qj.items()}
    qt = params_from_numpy(jax_tree_to_numpy(qj), "cpu")
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32), jnp.bfloat16)
    want, got = _run_both(cfg, qj, qt, u, mode)
    _assert_close(want, got, QUANT_RTOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_quantize_params_ssm_trees_match_reference(arch):
    """The SSM and hybrid trees quantize as the reference's do: the same
    leaves (``in_proj``/``out_proj``, hymba's attention, MLP and lm_head;
    never ``conv_w``, ``A_log``, ``D``, ``dt_bias``, the norms or the meta
    tokens, by the recipe's skip patterns), each bitwise the reference's on
    its true columns. A ragged N (the SSM ``in_proj``'s 296 at this size)
    is stored zero-padded to a multiple of 16 with ``n_out`` the true
    count, and ``to_w4a8`` converts the padded leaf to one whose true
    columns are bitwise the reference's conversion and whose pad columns
    stay zero."""
    from repro.core.apply import path_str as j_path_str
    from repro_torch.core.apply import quantize_params as t_quantize_params
    from repro_torch.core.recipe import QuantRecipe as TRecipe

    cfg = j_smoke(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    qj = j_quantize_params(params, JRecipe(**SERVE_RECIPE))
    qt = t_quantize_params(params_from_numpy(jax_tree_to_numpy(params), "cpu"),
                           TRecipe(**SERVE_RECIPE), device="cpu")
    flat_j = {j_path_str(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(qj, is_leaf=lambda x: isinstance(x, JOCS))[0]}
    quantized = sorted(k for k, v in flat_j.items() if isinstance(v, JOCS))
    want = ["layers/ssm/in_proj", "layers/ssm/out_proj"]
    if arch == "hymba-1.5b":
        want += ["layers/attn/" + w for w in ("wk", "wo", "wq", "wv")]
        want += ["layers/mlp/" + w for w in ("w_down", "w_gate", "w_up")] + ["lm_head"]
    assert quantized == sorted(want)
    padded = 0
    for key in quantized:
        node = qt
        for part in key.split("/"):
            node = node[part]
        assert isinstance(node, TOCS), key
        a = jax_tree_to_numpy(flat_j[key])
        n = a["values"].shape[-1]
        assert node.out_features == n
        cols = node.weight.values.shape[-1]
        assert cols % 16 == 0 and cols - n < 16 and (node.n_out is not None) == (cols != n)
        padded += cols != n
        np.testing.assert_array_equal(node.weight.values.numpy()[..., :n], a["values"])
        np.testing.assert_array_equal(node.weight.scale.numpy()[..., :n], a["scale"])
        assert not node.weight.values[..., n:].any()
        for name in ("src", "mult", "bias"):
            np.testing.assert_array_equal(getattr(node.spec, name).numpy(), a[name])
        if key.startswith("layers/ssm"):
            b = t_to_w4a8(node.layer(0), W4A8_RATIO)
            c = jax_tree_to_numpy(j_to_w4a8(jax.tree.map(lambda x: x[0], flat_j[key]),
                                            W4A8_RATIO))
            assert b.out_features == n and b.w4.shape[-1] == cols
            for name in ("w4", "w8", "s4", "s8"):
                np.testing.assert_array_equal(getattr(b, name).numpy()[..., :n], c[name])
            assert not b.w4[..., n:].any() and not b.w8[..., n:].any()
            np.testing.assert_array_equal(b.outlier_idx.numpy(), c["outlier_idx"])
    assert padded == 1  # the SSM in_proj (N 296)


def test_decode_matches_chunked_scan():
    """The port's sequential O(1) state updates equal its chunked scan (the
    same recurrence), at the reference test's inputs and tolerance; the
    scan's final state is the decode state."""
    cfg = t_smoke("mamba2-1.3b")
    rng = np.random.default_rng(5)
    p = {}
    for k, sh in TS.ssm_params_shape(cfg).items():
        if k == "A_log":
            p[k] = torch.as_tensor(np.log(rng.uniform(1, 4, size=sh)).astype(np.float32))
        elif k in ("dt_bias", "conv_b"):
            p[k] = torch.zeros(sh)
        elif k in ("D", "norm_scale"):
            p[k] = torch.ones(sh)
        else:
            p[k] = torch.as_tensor(rng.normal(size=sh).astype(np.float32)) * 0.2
    s_len = 24
    u = torch.as_tensor(rng.normal(size=(1, s_len, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_full, state = TS.mamba2(p, u, cfg, return_state=True)
        cache = TS.init_ssm_cache(cfg, 1, torch.float32, device="cpu")
        ys = []
        for t in range(s_len):
            y_t, cache = TS.mamba2_decode(p, u[:, t:t + 1], cache, cfg)
            ys.append(y_t[:, 0])
    np.testing.assert_allclose(to_np(y_full), to_np(torch.stack(ys, 1)), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(to_np(state), to_np(cache["state"]), rtol=2e-2, atol=2e-2)
