"""Port parity, self-speculative decoding on the unpaged engine's dense
per-lane caches, against ``repro`` on the same weights and numpy inputs.

* ``attention_decode`` at Q = 5 on the dense cache (float32 and int8):
  the rows it writes are bitwise the reference's, the rows clipped onto
  the last slot past the cache included, and its output agrees to
  ``ATTN_RTOL`` (torch's and XLA's exp and sums differ in float32 ulps).
  A ring buffer or meta keys refuse Q > 1 with the reference's message.
* ``verify_step`` over 5 tokens on float32 and int8 dense caches is
  bitwise 5 sequential ``decode_step`` calls of the port (logits, every
  layer's cache, positions) in dequant, w8a8 and w4a8, and within
  ``QUANT_RTOL`` of the reference's ``verify_step`` on the same caches.
* The drafter: ``decode_tokens(layers_limit=1)`` on dense caches against
  the reference's, logits to ``QUANT_RTOL``, the skipped layer's cache
  untouched.
* The unpaged spec engine (glm4-9b): token for token the port's plain
  unpaged greedy engine in each tier (dequant on float32 caches, w8a8 on
  int8 caches drafting with one layer, w4a8 drafting in w4a8), and the
  reference's unpaged spec engine on float32 caches token for token up to
  the near-ties of ``_torch_lifecycle`` (the same rule as the plain
  unpaged engines are held by, ``test_torch_unpaged.py``).
* deepseek-moe-16b on the unpaged engine: ``verify_step`` logits against
  the reference's on dense caches with the port routing as the reference
  did (its own choice may part only at a near-tie; MoE greedy exactness
  is a knife edge), and spec token for token plain greedy where no
  decode or verify drops an assignment.
* SSM and hybrid models keep the reference's refusals: ``verify_step``
  and ``layers_limit`` raise ``NotImplementedError``, a spec engine
  ``ValueError``.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import SERVE_RECIPE, jax_tree_to_numpy, to_np, torch_threads  # noqa: F401
from _torch_lifecycle import assert_held, prompts_of

from repro.configs import smoke_config as j_smoke
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.ocs import OCSQuantLinear as JOCS
from repro.core.ocs import to_w4a8 as j_to_w4a8
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import EngineConfig as JConfig
from repro.serving import KernelConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.spec_decode import SpecConfig as JSpecConfig

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import EngineConfig, Request, ServingEngine, SpecConfig

ATTN_RTOL = 0.01  # test_torch_unpaged.py's
QUANT_RTOL = 0.06  # logits, quantized (test_torch_unpaged.py's)
ROUTE_TIE = 0.01  # a routing flip is a near-tie (test_torch_moe.py's)
W4A8_RATIO = 0.05

_TREES = {}


def _served(arch):
    """``(cfg, reference tree, port tree)``: the reference's seed-0 smoke
    ``arch`` quantized with the serving recipe, and the port's copy."""
    if arch not in _TREES:
        cfg = j_smoke(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(t_smoke(arch))
        qj = j_quantize_params(JT.init_params(cfg, jax.random.PRNGKey(0)),
                               JRecipe(**SERVE_RECIPE))
        _TREES[arch] = (cfg, qj, params_from_numpy(jax_tree_to_numpy(qj), "cpu"))
    return _TREES[arch]


def _tier(arch, mode):
    """The trees a mode serves: W4A8 leaves for w4a8, on both sides."""
    cfg, qj, qt = _served(arch)
    if mode != "w4a8":
        return cfg, qj, qt
    pj = jax.tree.map(lambda a: j_to_w4a8(a, W4A8_RATIO) if isinstance(a, JOCS) else a, qj,
                      is_leaf=lambda a: isinstance(a, JOCS))
    return cfg, pj, params_from_numpy(jax_tree_to_numpy(pj), "cpu")


def _kernel(mode):
    return "pallas" if mode == "dequant" else "xla"


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# The Q > 1 write and attention on the dense cache


@pytest.mark.parametrize("kv_bits", [None, 8], ids=["f32", "int8"])
@pytest.mark.parametrize("pos", [(5, 20, 9), (44, 46, 47)], ids=["inside", "clipped"])
def test_attention_decode_multirow_dense_matches_reference(pos, kv_bits):
    """Q = 5 rows per lane in w8a8 on a random 48-row dense cache. The
    "clipped" lanes run past the cache (positions 44..51): their rows past
    row 47 clip onto it, where the reference's in-order scatter leaves the
    last query's row, and so does the port."""
    cfg, qj, qt = _served("glm4-9b")
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    rng = np.random.default_rng(21 + sum(pos))
    b, qn = len(pos), 5
    x = rng.normal(size=(b, qn, cfg.d_model)).astype(np.float32)
    shape = (b, cfg.n_kv_heads, 48, cfg.hd)
    if kv_bits:
        cache = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "k_scale": rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32),
                 "v_scale": rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)}
    else:
        cache = {"k": rng.normal(size=shape).astype(np.float32),
                 "v": rng.normal(size=shape).astype(np.float32)}
    pj = jax.tree.map(lambda a: a[0], qj["layers"]["attn"])
    pt = {k: v.layer(0) for k, v in qt["layers"]["attn"].items()}
    posa = np.asarray(pos, np.int32)

    @jax.jit
    def ref(p, xx, c, pp):
        with JL.serving_mode("w8a8", kernel="xla"):
            return JA.attention_decode(p, xx, c, pp, cfg)

    xb = jnp.asarray(x, jnp.bfloat16)
    yj, cj = ref(pj, xb, jax.tree.map(jnp.asarray, cache), jnp.asarray(posa))
    ct = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        yt, ct2 = TA.attention_decode(pt, torch.as_tensor(np.array(xb.astype(jnp.float32)))
                                      .to(torch.bfloat16), ct, torch.as_tensor(posa), cfg,
                                      mode="w8a8")
    assert ct2 is ct and yt.shape == (b, qn, cfg.d_model)
    for key in cache:
        np.testing.assert_array_equal(ct[key].numpy(), np.asarray(cj[key]), err_msg=key)
    assert _rel_err(to_np(yt), np.asarray(yj.astype(jnp.float32))) <= ATTN_RTOL


def test_multirow_refuses_ring_and_meta_keys():
    """Q > 1 on a ring buffer or with meta keys raises the reference's
    refusal (hymba's layers are never speculated)."""
    cfg = t_smoke("hymba-1.5b")
    params = TT.init_params(cfg, seed=0, device="cpu")
    p = TT.layer_params(params, 1)["attn"]
    cache = TA.init_kv_cache(cfg, 1, 48, window=32, device="cpu")
    meta = torch.zeros((1, cfg.hymba.n_meta_tokens, cfg.n_kv_heads, cfg.hd))
    x = torch.zeros((1, 3, cfg.d_model), dtype=torch.bfloat16)
    for kw in (dict(window=32), dict(kv_prefix=(meta, meta))):
        with pytest.raises(NotImplementedError, match="SSM/hybrid archs can't verify"):
            TA.attention_decode(p, x, cache, torch.zeros(1, dtype=torch.int32), cfg,
                                mode="dequant", **kw)


# ---------------------------------------------------------------------------
# verify_step and the drafter on dense caches


def _context(cfg, params, caches, mode, rng, steps=6):
    with torch.no_grad():
        for t in rng.integers(0, cfg.vocab, (steps, caches["pos"].shape[0])):
            _, caches = TT.decode_step(params, torch.as_tensor(t[:, None], dtype=torch.int32),
                                       caches, cfg, mode=mode)
    return caches


@pytest.mark.parametrize("mode,kv_bits", [("dequant", None), ("w8a8", 8), ("w4a8", None),
                                          ("dequant", 8)])
def test_verify_step_bitwise_sequential_decode_dense(mode, kv_bits):
    """verify_step over 5 tokens (3 lanes at ragged positions) is bitwise 5
    sequential decode_step calls on the dense caches: logits, every layer's
    cache, positions. The third lane runs past the 48-row cache (positions
    45-49): its queries at 47 and past read the last slot, which both runs
    leave holding the last query's row (in sequence, each later write
    replaces the one before), so those logits are never committed (a spec
    engine needs a request's whole budget inside ``max_len``) and are left
    out; every other logit and every cache row is bitwise."""
    cfg0, _, params = _tier("glm4-9b", mode)
    cfg = dataclasses.replace(cfg0, kv_bits=kv_bits)
    caches = TT.init_cache(cfg, 3, 48, device="cpu")
    caches["pos"] = torch.tensor([0, 9, 39], dtype=torch.int32)
    rng = np.random.default_rng(5)
    caches = _context(cfg, params, caches, mode, rng)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 5)), dtype=torch.int32)
    seq, outs = copy.deepcopy(caches), []
    with torch.no_grad():
        for j in range(5):
            lg, seq = TT.decode_step(params, toks[:, j:j + 1], seq, cfg, mode=mode)
            outs.append(lg)
        lg_v, ver = TT.verify_step(params, toks, copy.deepcopy(caches), cfg, mode=mode)
    assert lg_v.shape == (3, 5, cfg.vocab)
    want, got = to_np(torch.stack(outs, 1)), to_np(lg_v)
    assert _same_bits(want[:2], got[:2]) and _same_bits(want[2, :2], got[2, :2])
    assert ver["pos"].tolist() == seq["pos"].tolist() == [11, 20, 50]
    for i in range(cfg.n_layers):
        for key, val in ver["layers"][i]["attn"].items():
            assert _same_bits(val.numpy(), seq["layers"][i]["attn"][key].numpy()), (i, key)


@pytest.mark.parametrize("mode,kv_bits", [("dequant", None), ("w8a8", 8)])
def test_verify_step_dense_matches_reference(mode, kv_bits):
    """The port's verify_step against the reference's on dense caches of
    the same context: logits within ``QUANT_RTOL``, layer 0's cache rows
    bitwise (its inputs are)."""
    cfg, qj, qt = _served("glm4-9b")
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    rng = np.random.default_rng(13)
    ctx = rng.integers(0, cfg.vocab, (4, 2))
    toks = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)

    @jax.jit
    def jstep(params, t, caches):
        with JL.serving_mode(mode, kernel=_kernel(mode)):
            return JT.verify_step(params, t, caches, cfg)

    jc = JT.init_cache(cfg, 2, 48, dtype=jnp.float32)
    jc["pos"] = jnp.asarray([3, 17], jnp.int32)
    tc = TT.init_cache(cfg, 2, 48, device="cpu")
    tc["pos"] = torch.tensor([3, 17], dtype=torch.int32)
    with torch.no_grad():
        for t in ctx:
            _, jc = jstep(qj, jnp.asarray(t[:, None], jnp.int32), jc)
            _, tc = TT.verify_step(qt, torch.as_tensor(t[:, None], dtype=torch.int32), tc, cfg,
                                   mode=mode)
        want, jc = jstep(qj, jnp.asarray(toks), jc)
        got, tc = TT.verify_step(qt, torch.as_tensor(toks), tc, cfg, mode=mode)
    assert _rel_err(to_np(got), np.asarray(want.astype(jnp.float32))) <= QUANT_RTOL
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [12, 26]
    for key, val in tc["layers"][0]["attn"].items():
        np.testing.assert_array_equal(val.numpy(), np.asarray(jc["layers"][0]["attn"][key]),
                                      err_msg=key)


def test_drafter_layers_limit_dense_matches_reference():
    """``layers_limit=1`` on dense caches: the first layer and the lm_head
    run (logits against the reference's drafter), the second layer's cache
    passes through untouched, and ``pos`` advances."""
    cfg, qj, qt = _served("glm4-9b")
    mode = "w8a8"

    @jax.jit
    def jdraft(params, t, caches):
        with JL.serving_mode(mode, kernel="xla"):
            return JT.decode_step(params, t, caches, cfg, layers_limit=1)

    jc = JT.init_cache(cfg, 2, 32, dtype=jnp.float32)
    tc = TT.init_cache(cfg, 2, 32, device="cpu")
    before = copy.deepcopy(tc)
    toks = np.array([[37], [5]], np.int32)
    with torch.no_grad():
        full, _ = TT.decode_step(qt, torch.as_tensor(toks), copy.deepcopy(tc), cfg, mode=mode)
        got, tc = TT.decode_step(qt, torch.as_tensor(toks), tc, cfg, mode=mode, layers_limit=1)
    want, jc = jdraft(qj, jnp.asarray(toks), jc)
    assert (full - got).abs().max() > 0
    assert _rel_err(to_np(got), np.asarray(want.astype(jnp.float32))) <= QUANT_RTOL
    for key, val in tc["layers"][1]["attn"].items():
        assert torch.equal(val, before["layers"][1]["attn"][key])
    assert not torch.equal(tc["layers"][0]["attn"]["k"], before["layers"][0]["attn"]["k"])
    np.testing.assert_array_equal(tc["layers"][0]["attn"]["k"].numpy(),
                                  np.asarray(jc["layers"][0]["attn"]["k"]))
    assert tc["pos"].tolist() == [1, 1]


# ---------------------------------------------------------------------------
# The unpaged spec engine


def _serve(cfg, params, prompts, conf, max_new=8):
    eng = ServingEngine(cfg, params, EngineConfig(**conf), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=max_new))
    eng.run()
    return eng, {r.uid: (r.finish_reason, list(r.output)) for r in eng.done}


@pytest.mark.parametrize("mode,kv_bits,spec", [
    ("dequant", None, SpecConfig(k=3)),
    ("w8a8", 8, SpecConfig(k=3, draft_layers=1)),
    ("w4a8", None, SpecConfig(k=3, draft_mode="w4a8")),
], ids=["dequant-f32", "w8a8-int8-draft1", "w4a8-f32"])
def test_unpaged_spec_matches_plain_greedy(mode, kv_bits, spec):
    """The reference's unpaged spec contract in each tier: every request's
    stream is token for token the plain unpaged engine's, and the rounds
    show in the stats."""
    cfg, _, qt = _served("glm4-9b")
    prompts = prompts_of(np.random.default_rng(7), cfg.vocab, (3, 11, 6, 21, 16))
    conf = dict(max_batch=5, max_len=64, paged=False, matmul_mode=mode, kv_bits=kv_bits)
    _, plain = _serve(cfg, qt, prompts, conf)
    eng, got = _serve(cfg, qt, prompts, dict(conf, spec=spec))
    assert got == plain and all(len(o) == 8 for _, o in got.values())
    s = eng.stats()
    assert eng.paged is False and s["spec_rounds"] > 0 and s["decode_steps"] == s["spec_rounds"]
    assert 0.0 < s["spec_acceptance_rate"] <= 1.0
    assert s["spec_tokens_per_target_step"] >= 1.0


def test_unpaged_spec_matches_reference_spec_engine():
    """The port's unpaged spec engine against the reference's (dequant, the
    w8a8 drafter, float32 caches): the same streams up to the near-ties of
    the reference's plain model, as the plain unpaged engines are held."""
    cfg, qj, qt = _served("glm4-9b")
    prompts = prompts_of(np.random.default_rng(9), cfg.vocab, (21, 9, 30))
    conf = dict(max_batch=3, max_len=64, paged=False, spec=SpecConfig(k=3))
    je = JEngine(cfg, qj, JConfig(max_batch=3, max_len=64, paged=False,
                                  spec=JSpecConfig(k=3),
                                  kernels=KernelConfig(matmul="pallas")))
    for i, p in enumerate(prompts):
        je.submit(JRequest(uid=i, prompt=list(p), max_new_tokens=8))
    je.run()
    want = {r.uid: (r.finish_reason, list(r.output)) for r in je.done}
    eng, got = _serve(cfg, qt, prompts, conf)
    assert je.stats()["spec_rounds"] > 0 and eng.stats()["spec_rounds"] > 0

    @jax.jit
    def jprefill(params, toks):
        with JL.serving_mode("dequant", kernel="pallas"):
            return JT.prefill_with_cache(params, toks, cfg, 64)

    def margin(tokens):
        lg, _ = jprefill(qj, jnp.asarray([tokens], jnp.int32))
        top = np.sort(np.asarray(lg[0].astype(jnp.float32)))[::-1]
        return float(top[0] - top[1])

    assert_held(got, want, dict(enumerate(prompts)), margin)


def _reference_routes(cfg, params, caches, toks_seq, mode):
    """The reference's verify steps over ``toks_seq`` on dense caches,
    recording every routing's ``top_idx`` in call order. Returns (logits of
    the last step, routes)."""
    routes = []
    route = JM._route

    def recording_route(router_w, xf, k):
        gate, top_idx = route(router_w, xf, k)
        jax.debug.callback(lambda t: routes.append(np.asarray(t)), top_idx, ordered=True)
        return gate, top_idx

    JM._route = recording_route
    try:
        @jax.jit
        def step(p, t, c):
            with JL.serving_mode(mode, kernel=_kernel(mode)):
                return JT.verify_step(p, t, c, cfg)

        for t in toks_seq:
            lg, caches = step(params, jnp.asarray(t), caches)
        jax.effects_barrier()
    finally:
        JM._route = route
    return np.asarray(lg.astype(jnp.float32)), routes


def test_unpaged_moe_verify_logits_match_reference(monkeypatch):
    """deepseek-moe-16b: 4 one-token steps of context, then a 5-token
    verify_step on float32 dense caches, the port routing every call as
    the reference did (its own probabilities as gates; where its own top-k
    differs, the k-th and (k+1)-th probabilities are within ``ROUTE_TIE``):
    the verify logits within ``QUANT_RTOL``."""
    cfg, qj, qt = _served("deepseek-moe-16b")
    mode = "dequant"
    rng = np.random.default_rng(17)
    seq = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32) for _ in range(4)]
    seq.append(rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32))
    jc = JT.init_cache(cfg, 2, 32, dtype=jnp.float32)
    want, routes = _reference_routes(cfg, qj, jc, seq, mode)
    assert len(routes) == cfg.n_layers * len(seq)
    calls, margins = iter(routes), []
    own_route = TM.route

    def forced_route(router_w, xf, k):
        probs = torch.softmax(xf.to(torch.float32) @ router_w.to(torch.float32), dim=-1)
        _, own = own_route(router_w, xf, k)
        want_idx = torch.from_numpy(np.array(next(calls))).long()
        srt = torch.sort(probs, dim=-1, descending=True, stable=True).values
        differ = (own.sort(-1).values != want_idx.sort(-1).values).any(-1)
        for r in torch.nonzero(differ).reshape(-1).tolist():
            margins.append(float(srt[r, k - 1] - srt[r, k]))
        gate = probs.gather(1, want_idx)
        return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), want_idx

    monkeypatch.setattr(TM, "route", forced_route)
    tc = TT.init_cache(cfg, 2, 32, device="cpu")
    with torch.no_grad():
        for t in seq:
            got, tc = TT.verify_step(qt, torch.as_tensor(t), tc, cfg, mode=mode)
    assert next(calls, None) is None
    assert all(m <= ROUTE_TIE for m in margins), margins
    assert got.shape == (2, 5, cfg.vocab)
    assert _rel_err(to_np(got), want) <= QUANT_RTOL


def test_unpaged_moe_spec_matches_plain_greedy(monkeypatch):
    """deepseek-moe-16b on the unpaged engine (2 lanes, k = 3, the first
    layer drafting): decodes and verifies drop no assignment, so the spec
    stream is token for token plain greedy's."""
    cfg, _, qt = _served("deepseek-moe-16b")
    prompts = prompts_of(np.random.default_rng(2), cfg.vocab, (4, 13))
    drops = {}
    own_dispatch = TM.dispatch

    def counting_dispatch(top_idx, n_experts, cap):
        out = own_dispatch(top_idx, n_experts, cap)
        n = top_idx.shape[0]
        drops[n] = drops.get(n, 0) + int((~out[2]).sum())
        return out

    monkeypatch.setattr(TM, "dispatch", counting_dispatch)
    conf = dict(max_batch=2, max_len=64, paged=False)
    _, plain = _serve(cfg, qt, prompts, conf, max_new=6)
    eng, got = _serve(cfg, qt, prompts, dict(conf, spec=SpecConfig(k=3, draft_layers=1)),
                      max_new=6)
    assert drops[2] == 0 and all(d == 0 for n, d in drops.items() if n < 16)
    assert got == plain and eng.stats()["spec_rounds"] > 0


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_and_hybrid_refuse_speculation(arch):
    """The reference's refusals: a multi-token decode and an early-exit
    drafter on an SSM or hybrid state, and a spec engine (a rejected tail
    cannot be rolled back)."""
    cfg = t_smoke(arch)
    params = TT.init_params(cfg, seed=0, device="cpu")
    caches = TT.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-token decode"):
        TT.verify_step(params, torch.zeros((1, 3), dtype=torch.int32), caches, cfg)
    with pytest.raises(NotImplementedError, match="layers_limit"):
        TT.decode_step(params, torch.zeros((1, 1), dtype=torch.int32), caches, cfg,
                       layers_limit=1)
    with pytest.raises(ValueError, match="roll back"):
        ServingEngine(cfg, params, EngineConfig(spec=SpecConfig(k=2)), device="cpu")
