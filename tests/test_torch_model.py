"""Port parity, model: ``prefill_into_pages`` and teacher-forced
``decode_step`` logits of ``repro_torch`` against ``repro`` on float32
page pools, from the same weights, in each matmul mode.

Both run bf16 activations with float32 attention math, but bitwise
agreement stops at float ulps: torch's and XLA's exp and reduction orders
differ in the last bits of float32 results, which now and then flips a
bf16 rounding. Tolerances, relative to the largest reference logit:

* ``FLOAT_RTOL`` (float weights): bf16 flips alone; observed 1.0%.
* ``W8A8_RTOL`` (the serving path): every matmul requantizes its input per
  row to int8, and a flipped bf16 value near an int8 rounding midpoint
  flips the int8 value, moving that row's outputs by a whole quantum;
  observed 3.4% (glm4-9b) and 2.4% (qwen3-14b) at this size, seed 0.
* ``DEQUANT_RTOL`` (weight-only ``dequant``, the engine's default): the
  reference runs its kernel route (``serving_mode("dequant",
  kernel="pallas")``, on the CPU ``ref.ocs_quant_matmul_ref``), the port
  the plain B4/B5: the same float32 products summed in another order, then
  rounded to bf16. No requantization amplifies a flip; observed 0.97% (OCS
  tree) and 0.96% (clip-only tree, ``ocs_ratio=0``), the float case's
  level.

The pools the two prefill-and-decode runs write are compared bitwise for
layer 0 (its K/V inputs are bitwise equal); deeper layers inherit the
flips above.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import (  # noqa: F401
    SERVE_RECIPE, glm_smoke, glm_smoke_served, jax_tree_to_numpy, to_np, torch_threads)

from repro.configs import smoke_config as j_smoke
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import kv_cache as jkvc

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.apply import quantize_params as t_quantize_params
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.serving import kv_cache as tkvc

FLOAT_RTOL = 0.02
W8A8_RTOL = 0.06
DEQUANT_RTOL = 0.02


def _run_reference(cfg, params, toks, n, follow, ids, table, mode="w8a8"):
    pools = [jkvc.init_page_pool(cfg, 8, 16) for _ in range(cfg.n_layers)]
    # w8a8: the XLA composition, bitwise the fused kernel; dequant: the
    # kernel route (the XLA route rounds the dequantized weights to bf16).
    kernel = "pallas" if mode == "dequant" else "xla"

    @jax.jit
    def prefill(params, toks, pools):
        with JL.serving_mode(mode, kernel=kernel):
            return JT.prefill_into_pages(
                params, toks, cfg, pools, jnp.asarray(ids), length=jnp.asarray([n]),
                prefix_ids=jnp.zeros((0,), jnp.int32))

    @jax.jit
    def decode(params, tok, caches):
        with JL.serving_mode(mode, kernel=kernel):
            return JT.decode_step(params, tok, caches, cfg, attn_kernel="xla")

    lg, pools = prefill(params, jnp.asarray(toks), pools)
    out = [lg]
    caches = {"layers": [{"attn": p} for p in pools], "table": jnp.asarray(table),
              "pos": jnp.asarray([n], jnp.int32)}
    for t in follow:
        lg, caches = decode(params, jnp.asarray([[t]], jnp.int32), caches)
        out.append(lg)
    return np.concatenate([np.asarray(o.astype(jnp.float32)) for o in out]), caches


def _run_port(cfg, params, toks, n, follow, ids, table, mode="w8a8"):
    pools = [tkvc.init_page_pool(cfg, 8, 16, device="cpu") for _ in range(cfg.n_layers)]
    with torch.no_grad():
        lg, pools = TT.prefill_into_pages(
            params, torch.as_tensor(toks), cfg, pools, torch.as_tensor(ids),
            length=torch.tensor([n]), prefix_ids=torch.zeros(0, dtype=torch.int32),
            mode=mode)
        out = [lg]
        caches = {"layers": [{"attn": p} for p in pools],
                  "table": torch.as_tensor(table), "pos": torch.tensor([n], dtype=torch.int32)}
        for t in follow:
            lg, caches = TT.decode_step(params, torch.tensor([[int(t)]], dtype=torch.int32),
                                        caches, cfg, mode=mode)
            out.append(lg)
    return np.concatenate([to_np(o) for o in out]), caches


@pytest.mark.parametrize(
    "arch,quantized", [("glm4-9b", False), ("glm4-9b", True), ("qwen3-14b", True)]
)
def test_prefill_and_decode_logits_match_reference(arch, quantized, glm_smoke,
                                                    glm_smoke_served):
    cfg_j = j_smoke(arch)
    cfg_t = t_smoke(arch)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    if arch == "glm4-9b":  # seed 0, shared with the core and engine tests
        params = glm_smoke[1]
    else:
        params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    if quantized and arch == "glm4-9b":
        params, params_t = glm_smoke_served
    elif quantized:
        params = j_quantize_params(params, JRecipe(**SERVE_RECIPE))
        params_t = t_quantize_params(params_t, TRecipe(**SERVE_RECIPE), device="cpu")
    _check_against_reference(cfg_j, cfg_t, params, params_t,
                             W8A8_RTOL if quantized else FLOAT_RTOL, "w8a8")


def _check_against_reference(cfg_j, cfg_t, params, params_t, rtol, mode):
    rng = np.random.default_rng(7)
    n = 27
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = rng.integers(0, cfg_j.vocab, n)
    follow = rng.integers(0, cfg_j.vocab, 4).tolist()  # teacher-forced
    ids = np.array([1, 2], np.int32)
    table = np.array([[1, 2, 3, 0]], np.int32)
    want, caches_j = _run_reference(cfg_j, params, toks, n, follow, ids, table, mode)
    got, caches_t = _run_port(cfg_t, params_t, toks, n, follow, ids, table, mode)
    assert got.shape == want.shape == (1 + len(follow), cfg_j.vocab)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"{mode}: max |d logits| {err:.4g} = {err / np.abs(want).max():.4f} of the range")
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())
    # Layer 0 pools: prompt rows (prefill) and the 4 decode rows, bitwise.
    for key in ("k", "v"):
        a = np.asarray(caches_j["layers"][0]["attn"][key])
        b = caches_t["layers"][0]["attn"][key].numpy()
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("ocs_ratio", [0.02, 0.0], ids=["ocs", "clip-only"])
def test_dequant_logits_match_reference_kernel_route(ocs_ratio, glm_smoke, glm_smoke_served):
    """The engine's default ``dequant`` mode on the smoke glm4-9b (seed 0):
    the serving tree, and the clip-only tree whose matmuls have no OCS tail
    (B5), converted from the reference's quantized tree through numpy."""
    cfg = j_smoke("glm4-9b")
    if ocs_ratio:
        params, params_t = glm_smoke_served
    else:
        params = j_quantize_params(glm_smoke[1], JRecipe(**dict(SERVE_RECIPE, ocs_ratio=0.0)))
        params_t = params_from_numpy(jax_tree_to_numpy(params), "cpu")
        assert params_t["lm_head"].spec.src.shape[0] == params_t["lm_head"].n_orig
    _check_against_reference(cfg, t_smoke("glm4-9b"), params, params_t, DEQUANT_RTOL,
                             "dequant")
