"""Port parity, engine: the greedy paged ``ServingEngine`` of ``repro_torch``
against ``repro``'s, configured alike (reserve admission, monolithic
prefill) in each matmul mode. The reference runs ``KernelConfig(attn="xla")``
(f32-after-dequant paged attention) and ``matmul="xla"`` for ``w8a8`` (the
XLA W8A8 composition, bitwise the fused kernel) and ``w4a8`` (its compiled
``w4a8_matmul_ref``, bitwise the W4A8 kernel), or ``matmul="pallas"`` for
``dequant`` (the kernel route, whose numerics the port follows).

* Allocator state (free list, refcounts, prefix-cache keys, LRU) is
  identical after every engine step, retirements included: it is host code
  driven by the same request lengths.
* Greedy tokens are equal until a near-tie: the two stacks' logits differ
  by float ulps (amplified by dynamic W8A8; see test_torch_model.py), so
  at the first position where a request's tokens differ the reference's
  top-2 logit margin, under the same mode and kernel route, must be within
  ``TIE_TOL``: about twice the largest port-vs-reference logit difference
  seen in the model test (0.109), since a flip needs the margin inside
  both sides' error. With the pinned seed, w8a8 on float pools parts at
  two near-ties and on int8 pools at four (margins <= 0.031, one an exact
  tie); the other requests match token for token.
* On int8 and int4 pools, the bytes prefill wrote into layer 0's pages
  are bitwise equal (deeper layers inherit the ulp flips).
* The ``w4a8`` tier on int4 pages (each engine converts its own int8 tree
  with its ``to_w4a8``) reports ``kv_bits`` 4 and fewer KV bytes per token
  than the int8 tier.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from _torch_interop import (  # noqa: F401
    SERVE_RECIPE, glm_smoke, glm_smoke_served, jax_tree_to_numpy, torch_threads)

from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import EngineConfig as JConfig
from repro.serving import KernelConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine

from repro_torch.serving import EngineConfig as TConfig
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine

TIE_TOL = 0.25  # logits; max |logit| ~3.5 at this size


def _alloc_state(a):
    return (list(a._free), dict(a._ref), dict(a._key_of), dict(a._page_of),
            list(a._lru), a.peak_in_use, a.prefix_hit_pages, a.prefix_lookup_pages)


def _prompts(vocab, seed):
    """Prompts of 17-32 tokens (one prefill bucket, so the reference
    compiles once per prefix-hit count); the last one starts with the two
    full pages the second one registers (a prefix hit)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(rng.integers(17, 33))).tolist() for _ in range(5)]
    shared = prompts[0][:16] + prompts[1][:16]
    return [prompts[0], shared] + prompts[1:] + [shared + [5, 6]]


@pytest.fixture(scope="module")
def quantized(glm_smoke, glm_smoke_served):
    """The smoke glm4-9b (seed 0) quantized with the serving recipe by both
    packages (shared with test_torch_core.py)."""
    return (glm_smoke[0],) + tuple(glm_smoke_served)


def _matmul_kernel(mode):
    return "pallas" if mode == "dequant" else "xla"


@functools.lru_cache(maxsize=None)
def _forward(cfg, mode):
    def fwd(params, toks):
        with JL.serving_mode(mode, kernel=_matmul_kernel(mode)):
            return JT.forward(params, toks, cfg)

    return jax.jit(fwd)


def _top2_margin(cfg, params, tokens, mode, pad=64):
    """The reference's top-2 logit margin after ``tokens`` (its own causal
    full-sequence forward, the same matmul numerics as its engine in
    ``mode``; zero-padded to one length so it compiles once)."""
    toks = np.zeros((1, pad), np.int32)
    toks[0, : len(tokens)] = tokens
    lg = _forward(cfg, mode)(params, jnp.asarray(toks))
    top = np.sort(np.asarray(lg[0, len(tokens) - 1].astype(jnp.float32)))[::-1]
    return float(top[0] - top[1])


# The w8a8 cases keep the ids they had before the dequant cases came.
@pytest.mark.parametrize("kv_bits,matmul_mode", [
    pytest.param(None, "w8a8", id="None"),
    pytest.param(8, "w8a8", id="8"),
    pytest.param(None, "dequant", id="dequant-None"),
    pytest.param(8, "dequant", id="dequant-8"),
    pytest.param(4, "w4a8", id="w4a8-4"),
])
def test_engine_matches_reference(kv_bits, matmul_mode, quantized):
    cfg, qj, qt = quantized
    te = _serve_both(cfg, qj, qt, dict(max_batch=3, max_len=64, matmul_mode=matmul_mode,
                                       kv_bits=kv_bits))
    st = te.stats()
    assert st["kv_bits"] == float(kv_bits or 0) and st["matmul_mode"] == matmul_mode
    if kv_bits == 4:
        from repro_torch.serving import kv_cache as tkvc

        int8_bytes = tkvc.kv_bytes_per_token(dataclasses.replace(cfg, kv_bits=8))
        assert st["kv_bytes_per_token"] < int8_bytes


def _serve_both(cfg, qj, qt, common, prompts=None):
    """Serve the same requests on both engines; allocator state identical
    after every step, tokens equal up to near-ties. Returns the port's
    engine."""
    mode = common["matmul_mode"]
    kv_bits = common["kv_bits"]
    kernels = KernelConfig(matmul=_matmul_kernel(mode), attn="xla")
    je = JEngine(cfg, qj, JConfig(**common, kernels=kernels))
    te = TEngine(cfg, qt, TConfig(**common), device="cpu")
    prompts = prompts or _prompts(cfg.vocab, seed=0)
    for i, p in enumerate(prompts):
        je.submit(JRequest(uid=i, prompt=p, max_new_tokens=8))
        te.submit(TRequest(uid=i, prompt=p, max_new_tokens=8))
    steps = 0
    while True:
        a, b = je.step(), te.step()
        steps += 1
        assert a == b
        assert _alloc_state(je.allocator) == _alloc_state(te.allocator), steps
        if steps == 1 and kv_bits in (4, 8):
            # Layer 0's prompt rows, written by the first three prefills.
            for slot, tslot in zip(je.slots, te.slots):
                assert slot.pages == tslot.pages
                n = len(slot.req.prompt)
                for key in ("k", "v", "k_scale", "v_scale"):
                    pj = np.asarray(je.caches["layers"][0]["attn"][key])
                    pt = te.caches["layers"][0]["attn"][key].numpy()
                    for j in range(n):
                        page, row = slot.pages[j // 16], j % 16
                        np.testing.assert_array_equal(pt[page, :, row], pj[page, :, row])
        if not a and not je.queue:
            break
    assert steps < 100
    assert te.stats()["completed"] == len(prompts) == je.stats()["completed"]
    assert te.stats()["prefix_hit_pages"] == je.stats()["prefix_hit_pages"] > 0
    out_j = {r.uid: r.output for r in je.done}
    out_t = {r.uid: r.output for r in te.done}
    assert all(r.finish_reason == "length" for r in te.done)
    for uid, want in out_j.items():
        got = out_t[uid]
        assert len(got) == len(want)
        diverge = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), None)
        if diverge is not None:  # a near-tie: both candidates nearly equal
            # The reference engine's own tree (W4A8Linear leaves in w4a8).
            margin = _top2_margin(cfg, je.params, prompts[uid] + want[:diverge], mode)
            assert margin <= TIE_TOL, (uid, diverge, margin)
    return te


def test_clip_only_tree_serves_dequant(glm_smoke):
    """An ``ocs_ratio=0`` tree (no OCS split: every matmul is B5), converted
    from the reference's through numpy, serves in ``dequant`` mode like the
    reference's engine."""
    from repro.core.apply import quantize_params as j_quantize_params
    from repro.core.recipe import QuantRecipe as JRecipe
    from repro_torch.interop import params_from_numpy

    cfg, params = glm_smoke
    qj = j_quantize_params(params, JRecipe(**dict(SERVE_RECIPE, ocs_ratio=0.0)))
    qt = params_from_numpy(jax_tree_to_numpy(qj), "cpu")
    wq = qt["layers"]["attn"]["wq"]
    assert wq.weight.values.shape[1] == wq.n_orig  # [L, K, N]: no duplicate rows
    _serve_both(cfg, qj, qt, dict(max_batch=3, max_len=64, matmul_mode="dequant",
                                  kv_bits=None), prompts=_prompts(cfg.vocab, seed=0)[:4])


def test_default_engine_config_serves(quantized):
    """``EngineConfig()`` defaults (dequant matmuls, float32 pages) serve to
    completion."""
    cfg, _, qt = quantized
    eng = TEngine(cfg, qt, TConfig(max_batch=3, max_len=64), device="cpu")
    prompts = _prompts(cfg.vocab, seed=1)
    for i, p in enumerate(prompts):
        eng.submit(TRequest(uid=i, prompt=p, max_new_tokens=6))
    done = eng.run()
    st = eng.stats()
    assert st["matmul_mode"] == "dequant" and st["kv_bits"] == 0.0
    assert st["completed"] == len(done) == len(prompts)
    assert all(r.finish_reason == "length" and len(r.output) == 6 for r in done)
