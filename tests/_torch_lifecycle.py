"""Helpers for the port's request-lifecycle tests (sampling, scheduler,
overload): a smoke-size quantized tree made by the port alone, serving
shortcuts, and the near-tie rule that holds two token streams against each
other.

Chunked prefill and the monolithic prefill sum the same attention in
different orders (the prefill attention's key chunk follows the call's key
count, the reference's own rule), and the port and the reference sum in
different orders too, so such greedy tokens are equal only up to a
near-tie: at the first position where two streams part, the oracle's own
top-2 logit margin must be within ``TIE_TOL`` (the engine parity tests'
bound, ``tests/test_torch_engine.py``). A resume after preemption is not
held this way: it is bitwise (``tests/test_torch_overload.py``). No test
pins a seed to avoid a parting.
"""
import numpy as np
import pytest
import torch

TIE_TOL = 0.25  # logits; max |logit| ~3.5 at this size


@pytest.fixture(scope="module")
def port_smoke():
    """``(cfg, tree)``: the smoke glm4-9b, the port's own seed-0 weights,
    quantized with the serving launcher's recipe on the CPU."""
    from _torch_interop import SERVE_RECIPE
    from repro_torch.configs import smoke_config
    from repro_torch.core.apply import quantize_params
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    cfg = smoke_config("glm4-9b")
    params = T.init_params(cfg, seed=0, device="cpu")
    return cfg, quantize_params(params, QuantRecipe(**SERVE_RECIPE), device="cpu")


def serve(cfg, params, reqs, **conf):
    """Serve ``reqs`` to completion on a CPU engine; returns (engine,
    {uid: (finish_reason, output)})."""
    from repro_torch.serving import EngineConfig, ServingEngine

    eng = ServingEngine(cfg, params, EngineConfig(**conf), device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, {r.uid: (r.finish_reason, list(r.output)) for r in reqs}


def port_top2_margin(cfg, params, tokens, mode="dequant"):
    """The port's top-2 logit margin after ``tokens``: one monolithic
    prefill of the whole sequence on fresh float32 pages."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import kv_cache as kvc

    ps = 8
    n = len(tokens)
    nb = kvc.pages_needed(n, ps)
    caches = kvc.init_paged_cache(cfg, 1, nb + 1, ps, nb, device="cpu")
    toks = torch.zeros((1, nb * ps), dtype=torch.int64)
    toks[0, :n] = torch.as_tensor(tokens)
    with torch.no_grad():
        logits, _ = T.prefill_into_pages(
            params, toks, cfg, [layer["attn"] for layer in caches["layers"]],
            torch.arange(1, nb + 1, dtype=torch.int32),
            length=torch.tensor([n], dtype=torch.int32),
            prefix_ids=torch.zeros((0,), dtype=torch.int32), mode=mode)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def ref_top2_margin(cfg, params, mode):
    """``tokens -> margin``: the reference's top-2 logit margin after
    ``tokens`` (its causal full-sequence forward, with its engine's matmul
    numerics in ``mode``; padded to one length so it compiles once)."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro.models import transformer as JT

    def forward(p, toks):
        with JL.serving_mode(mode, kernel="pallas" if mode == "dequant" else "xla"):
            return JT.forward(p, toks, cfg)

    fwd = jax.jit(forward)

    def margin(tokens, pad=128):
        toks = np.zeros((1, pad), np.int32)
        toks[0, :len(tokens)] = tokens
        lg = np.asarray(fwd(params, jnp.asarray(toks))[0, len(tokens) - 1].astype(jnp.float32))
        top = np.sort(lg)[::-1]
        return float(top[0] - top[1])

    return margin


def assert_held(got, want, prompts, margin, tol=TIE_TOL):
    """``got`` and ``want`` ({uid: (reason, tokens)}) agree in reasons and
    lengths, and token for token up to a near-tie: where a request's tokens
    first part, ``margin(prompt + common prefix)`` (the oracle's top-2
    margin there) is at most ``tol``. Returns the partings."""
    partings = []
    assert got.keys() == want.keys()
    for uid, (reason, w) in want.items():
        g = got[uid][1]
        assert got[uid][0] == reason and len(g) == len(w), uid
        d = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if d is not None:
            m = margin(list(prompts[uid]) + w[:d])
            assert m <= tol, (uid, d, m)
            partings.append((uid, d, m))
    return partings


def prompts_of(rng, vocab, lengths):
    return [rng.integers(0, vocab, int(n)).tolist() for n in lengths]


def alloc_pids(a):
    """A PageAllocator's state by page id: free list, refcounts, registered
    pages, LRU, peak and prefix counters (not the chain keys, which hash the
    tokens)."""
    return (list(a._free), dict(a._ref), sorted(a._key_of), list(a._lru), a.peak_in_use,
            a.prefix_hit_pages, a.prefix_lookup_pages)


def serve_both(cfg, qj, qt, conf, prompts, max_new=8):
    """Serve the same greedy requests on the reference's engine and the
    port's, configured alike (the reference with f32-after-dequant
    attention, and its ``dequant`` matmuls through the kernel route whose
    numerics the port follows). Both step in lockstep: every step returns
    alike and leaves the allocator in the same state by page id. Returns
    (reference engine, port engine, {uid: (reason, tokens)} of each)."""
    from repro.serving import EngineConfig as JConfig
    from repro.serving import KernelConfig
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine
    from repro_torch.serving import EngineConfig as TConfig
    from repro_torch.serving import Request as TRequest
    from repro_torch.serving import ServingEngine as TEngine

    mode = conf.get("matmul_mode", "dequant")
    kernels = KernelConfig(matmul="pallas" if mode == "dequant" else "xla", attn="xla")
    je = JEngine(cfg, qj, JConfig(**conf, kernels=kernels))
    te = TEngine(cfg, qt, TConfig(**conf), device="cpu")
    for i, p in enumerate(prompts):
        je.submit(JRequest(uid=i, prompt=list(p), max_new_tokens=max_new))
        te.submit(TRequest(uid=i, prompt=list(p), max_new_tokens=max_new))
    for steps in range(1, 200):
        a, b = je.step(), te.step()
        assert a == b, steps
        assert alloc_pids(je.allocator) == alloc_pids(te.allocator), steps
        if not a and not je.queue:
            break
    assert not te.queue and not any(s.req for s in te.slots)
    out = lambda e: {r.uid: (r.finish_reason, list(r.output)) for r in e.done}  # noqa: E731
    return je, te, out(je), out(te)
