"""Port parity, engine: the greedy paged ``ServingEngine`` of ``repro_torch``
against ``repro``'s, configured alike (``matmul_mode="w8a8"``, reserve
admission, monolithic prefill; the reference with
``KernelConfig(matmul="xla", attn="xla")``: the XLA W8A8 composition,
bitwise the fused kernel, and f32-after-dequant paged attention).

* Allocator state (free list, refcounts, prefix-cache keys, LRU) is
  identical after every engine step, retirements included: it is host code
  driven by the same request lengths.
* Greedy tokens are equal until a near-tie: the two stacks' logits differ
  by float ulps amplified by dynamic W8A8 (see test_torch_model.py), so
  at the first position where a request's tokens differ the reference's
  top-2 logit margin must be within ``TIE_TOL``: about twice the largest
  port-vs-reference logit difference seen in the model test (0.109),
  since a flip needs the margin inside both sides' error. With the pinned
  seed, float pools part at two near-ties and int8 pools at four (margins
  <= 0.031, one an exact tie); the other requests match token for token.
* On int8 pools, the bytes prefill wrote into layer 0's pages are
  bitwise equal (deeper layers inherit the ulp flips).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from _torch_interop import glm_smoke, glm_smoke_served, torch_threads  # noqa: F401

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


@functools.lru_cache(maxsize=None)
def _w8a8_forward(cfg):
    def fwd(params, toks):
        with JL.serving_mode("w8a8", kernel="xla"):
            return JT.forward(params, toks, cfg)

    return jax.jit(fwd)


def _top2_margin(cfg, params, tokens, pad=64):
    """The reference's top-2 logit margin after ``tokens`` (its own causal
    full-sequence forward, the same W8A8 numerics; zero-padded to one
    length so it compiles once)."""
    toks = np.zeros((1, pad), np.int32)
    toks[0, : len(tokens)] = tokens
    lg = _w8a8_forward(cfg)(params, jnp.asarray(toks))
    top = np.sort(np.asarray(lg[0, len(tokens) - 1].astype(jnp.float32)))[::-1]
    return float(top[0] - top[1])


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_engine_matches_reference(kv_bits, quantized):
    cfg, qj, qt = quantized
    common = dict(max_batch=3, max_len=64, matmul_mode="w8a8", kv_bits=kv_bits)
    je = JEngine(cfg, qj, JConfig(**common, kernels=KernelConfig(matmul="xla", attn="xla")))
    te = TEngine(cfg, qt, TConfig(**common), device="cpu")
    prompts = _prompts(cfg.vocab, seed=0)
    for i, p in enumerate(prompts):
        je.submit(JRequest(uid=i, prompt=p, max_new_tokens=8))
        te.submit(TRequest(uid=i, prompt=p, max_new_tokens=8))
    steps = 0
    while True:
        a, b = je.step(), te.step()
        steps += 1
        assert a == b
        assert _alloc_state(je.allocator) == _alloc_state(te.allocator), steps
        if steps == 1 and kv_bits == 8:
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
            margin = _top2_margin(cfg, qj, prompts[uid] + want[:diverge])
            assert margin <= TIE_TOL, (uid, diverge, margin)
