"""Port parity, the unpaged engine and its dense caches, and the Mamba2 and
hymba decoders served on it, against ``repro`` on the
same weights and the same numpy inputs.

* ``init_cache``: the per-layer trees, shapes and dtypes of the
  reference's, float32 and int8, for a dense, a Mamba2 and a hymba model
  (a ring buffer of ``min(max_len, window)`` rows on a window layer, the
  meta K/V, the SSM state and conv window).
* ``attention_decode`` on the dense cache at Q = 1: the rows it writes are
  bitwise the reference's (float32 and int8, a ring slot included), and its
  output agrees to ``ATTN_RTOL`` (torch's and XLA's exp and sums differ in
  float32 ulps, which flip a bf16 rounding now and then). The int8 path's
  two integer dots (``int_dot``) are bitwise the reference's
  ``preferred_element_type=int32`` einsums, at a key count where a
  float32 sum would be inexact.
* The hymba ring buffer across a wrap: the whole smoke model decoded
  teacher-forced past its window (32) from a fresh cache, logits to
  ``QUANT_RTOL`` every step and layer 0's attention rows bitwise.
* ``prefill_with_cache`` and ``prefill_chunk_with_cache``: last-token
  logits to ``QUANT_RTOL`` and layer 0's cache rows bitwise, on float32
  and int8 caches. ``QUANT_RTOL`` is ``test_torch_model.py``'s w8a8
  tolerance: dynamic W8A8 (and the int8 cache's quantized q and softmax
  weights) turn a flipped bf16 rounding into a whole int8 quantum.
* The unpaged dense engine's greedy tokens against the reference engine's
  (float32 caches), its chunked prefill against its monolithic prefill
  (the counterpart of ``test_scheduler.py::test_chunked_prefill_exactness_unpaged``),
  both up to the near-ties of ``_torch_lifecycle`` (``TIE_TOL``), and the
  replay's one prefill call per prompt token (the counterpart of
  ``test_serving.py::test_ssm_replay_fallback``).
* The mamba2 and hymba engines against the reference's in each matmul mode
  (hymba's w8a8 on int8 caches too), prompts of 40 and 7 tokens (the
  40-token one wraps hymba's ring): the model's logits, decoded
  teacher-forced on the dense caches, agree to ``QUANT_RTOL`` of their
  range (observed 1.3% for mamba2 in dequant to 5.4% for hymba in w8a8
  on int8 caches), and the engines' greedy tokens are equal wherever the
  reference's top-2 margin exceeds twice that (the most the two sides'
  logits can differ by). At this seed they part three times (mamba2 w8a8
  once, hymba w4a8 twice), each at a margin of one to four bf16 steps of
  the logits (0.0078 with logits within 0.47, 0.0156 within 2.9).
* The unpaged engine's refusals and policies: ``kv_bits=4`` raises
  ``ConfigError``, admission is always ``reserve``, a dense model
  speculates while an SSM model refuses to (the reference's
  ``ValueError``), and a paged SSM engine is refused; ``launch.serve`` on the
  unpaged engine at smoke size; and the reference's paged == unpaged
  sampling case (``test_sampling.py``): a fixed-seed sampled request is
  bit-reproducible and the two engines sample it alike.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import SERVE_RECIPE, jax_tree_to_numpy, to_np, torch_threads  # noqa: F401
from _torch_lifecycle import assert_held, prompts_of, ref_top2_margin

from repro.configs import smoke_config as j_smoke
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import EngineConfig as JConfig
from repro.serving import KernelConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import ConfigError, EngineConfig, Request, ServingEngine, SpecConfig

ATTN_RTOL = 0.01
QUANT_RTOL = 0.06


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _kernel(mode):
    return "pallas" if mode == "dequant" else "xla"


_TREES = {}


def _served(arch, seed=0):
    """``(cfg, reference tree, port tree)``: the reference's seed-``seed``
    params of the smoke ``arch`` quantized with the serving recipe, and the
    port's copy of that tree through numpy."""
    key = (arch, seed)
    if key not in _TREES:
        cfg = j_smoke(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(t_smoke(arch))
        qj = j_quantize_params(JT.init_params(cfg, jax.random.PRNGKey(seed)),
                               JRecipe(**SERVE_RECIPE))
        _TREES[key] = (cfg, qj, params_from_numpy(jax_tree_to_numpy(qj), "cpu"))
    return _TREES[key]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _same_tree(port, ref, *, bitwise_layers=None):
    """Port and reference cache trees have the same leaves, shapes and
    dtypes; with ``bitwise_layers`` the leaves of those layers are
    bitwise equal."""
    tp, jp = dict(_leaves(port)), dict(_leaves(ref))
    assert tp.keys() == jp.keys()
    for path, t in tp.items():
        j = np.asarray(jp[path])
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
        if bitwise_layers is not None and path[0] == "layers" and path[1] in bitwise_layers:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))


# ---------------------------------------------------------------------------
# Dense caches


@pytest.mark.parametrize("kv_bits", [None, 8], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-1.3b", "hymba-1.5b"])
def test_init_cache_layouts_match_reference(arch, kv_bits):
    cfg = dataclasses.replace(j_smoke(arch), kv_bits=kv_bits)
    want = JT.init_cache(cfg, 3, 48, dtype=jnp.float32)
    got = TT.init_cache(dataclasses.replace(t_smoke(arch), kv_bits=kv_bits), 3, 48,
                        device="cpu")
    _same_tree(got, want, bitwise_layers=range(cfg.n_layers))
    if arch == "hymba-1.5b":  # layer 0 global (48 rows), layer 1 a ring of 32
        assert [tuple(layer["attn"]["k"].shape)[2] for layer in got["layers"]] == [48, 32]


def _attn_case(arch, kv_bits, pos, seed):
    """Layer 0's attention params (quantized, both sides), an input row
    per lane, and a random dense cache of ``max_len`` 48 (a ring of 32 on a
    hymba window layer) with meta K/V, as numpy."""
    cfg, qj, qt = _served(arch)
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    rng = np.random.default_rng(seed)
    b = len(pos)
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    window = 32 if arch == "hymba-1.5b" else 0
    s = 32 if window else 48
    shape = (b, cfg.n_kv_heads, s, cfg.hd)
    if kv_bits:
        cache = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "k_scale": rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32),
                 "v_scale": rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)}
    else:
        cache = {"k": rng.normal(size=shape).astype(np.float32),
                 "v": rng.normal(size=shape).astype(np.float32)}
    meta = None
    if window:
        m = (b, cfg.hymba.n_meta_tokens, cfg.n_kv_heads, cfg.hd)
        meta = (rng.normal(size=m).astype(np.float32), rng.normal(size=m).astype(np.float32))
    pj = jax.tree.map(lambda a: a[0], qj["layers"]["attn"])
    pt = {k: v.layer(0) for k, v in qt["layers"]["attn"].items()}
    return cfg, pj, pt, x, cache, meta, window


@pytest.mark.parametrize("kv_bits", [None, 8], ids=["f32", "int8"])
@pytest.mark.parametrize("arch,pos", [("glm4-9b", (5, 47, 30)),
                                      ("hymba-1.5b", (5, 31, 32, 45))],
                         ids=["dense", "hymba-ring"])
def test_attention_decode_dense_cache_matches_reference(arch, pos, kv_bits):
    """Q = 1 on the dense cache in w8a8: lanes at different positions (the
    last row of a full cache; on hymba's window layer, the ring before,
    at and past its wrap), with meta keys before the sequence on hymba."""
    cfg, pj, pt, x, cache, meta, window = _attn_case(arch, kv_bits, pos, 11 + len(pos))
    posa = np.asarray(pos, np.int32)

    @jax.jit
    def ref(p, xx, c, pp, mk):
        with JL.serving_mode("w8a8", kernel="xla"):
            return JA.attention_decode(p, xx, c, pp, cfg, window=window, kv_prefix=mk)

    yj, cj = ref(pj, jnp.asarray(x, jnp.bfloat16), jax.tree.map(jnp.asarray, cache),
                 jnp.asarray(posa), None if meta is None else tuple(map(jnp.asarray, meta)))
    xt = torch.as_tensor(np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))
    ct = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        yt, ct2 = TA.attention_decode(
            pt, xt.to(torch.bfloat16), ct, torch.as_tensor(posa), cfg, mode="w8a8",
            window=window, kv_prefix=None if meta is None else tuple(map(torch.as_tensor, meta)))
    assert ct2 is ct  # written in place
    for key in cache:
        np.testing.assert_array_equal(ct[key].numpy(), np.asarray(cj[key]), err_msg=key)
    err = _rel_err(to_np(yt), np.asarray(yj.astype(jnp.float32)))
    assert err <= ATTN_RTOL, err


@pytest.mark.parametrize("s", [48, 2048])
def test_int_dot_bitwise_reference(s):
    """The int8 cache's dots summed exactly: q8 . k8 over hd and p8 . v8
    over S keys (at S = 2048 a sum reaches 127 * 127 * 2048 > 2^24, past
    float32's exact integers), bitwise the reference's int32 einsums."""
    rng = np.random.default_rng(s)
    q8 = rng.integers(-127, 128, (2, 1, 2, 3, 16)).astype(np.int8)
    k8 = rng.integers(-127, 128, (2, 2, s, 16)).astype(np.int8)
    p8 = np.full((2, 1, 2, 3, s), 127, np.int8)
    v8 = np.full((2, 2, s, 16), 127, np.int8)
    v8[0, 0, 0, 0] = 1
    for eq, a, b in (("bqgrd,bgsd->bqgrs", q8, k8), ("bqgrs,bgsd->bqgrd", p8, v8)):
        want = jnp.einsum(eq, jnp.asarray(a), jnp.asarray(b), preferred_element_type=jnp.int32)
        got = TA.int_dot(eq, torch.as_tensor(a), torch.as_tensor(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) == 127 * 127 * s


def _ref_decode_fn(cfg, mode):
    @jax.jit
    def dec(params, tok, caches):
        with JL.serving_mode(mode, kernel=_kernel(mode)):
            return JT.decode_step(params, tok, caches, cfg)

    return dec


def _decode_both(cfg, qj, qt, tokens, mode, b=1):
    """Teacher-forced ``decode_step`` of ``tokens`` from fresh float32 dense
    caches on both sides: (reference logits [S, V], port logits, the
    reference's caches, the port's)."""
    dec = _ref_decode_fn(cfg, mode)
    cj = JT.init_cache(cfg, b, 64, dtype=jnp.float32)
    ct = TT.init_cache(cfg, b, 64, device="cpu")
    lj, lt = [], []
    with torch.no_grad():
        for t in tokens:
            g, cj = dec(qj, jnp.full((b, 1), t, jnp.int32), cj)
            lj.append(np.asarray(g[0].astype(jnp.float32)))
            g, ct = TT.decode_step(qt, torch.full((b, 1), int(t), dtype=torch.int32), ct,
                                   cfg, mode=mode)
            lt.append(to_np(g[0]))
    return np.stack(lj), np.stack(lt), cj, ct


def test_hymba_ring_buffer_across_a_wrap():
    """The smoke hymba (window 32, layer 0 global, layer 1 windowed) decodes
    45 tokens from a fresh cache: the window layer's ring wraps at 32. The
    logits agree every step, and layer 0's K/V rows are bitwise the
    reference's (its inputs are)."""
    cfg, qj, qt = _served("hymba-1.5b")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, 45).tolist()
    lj, lt, cj, ct = _decode_both(cfg, qj, qt, tokens, "dequant")
    for i in range(len(tokens)):
        assert _rel_err(lt[i], lj[i]) <= QUANT_RTOL, i
    assert ct["pos"].tolist() == [45]
    ring = ct["layers"][1]["attn"]["k"]
    assert ring.shape[2] == 32 and bool(ring.abs().sum(-1).gt(0).all())  # every slot written
    _same_tree(ct, cj, bitwise_layers=[])
    for key in ("k", "v"):
        np.testing.assert_array_equal(ct["layers"][0]["attn"][key].numpy(),
                                      np.asarray(cj["layers"][0]["attn"][key]))


# ---------------------------------------------------------------------------
# Prefill into the dense cache (dense and MoE)


@pytest.mark.parametrize("kv_bits", [None, 8], ids=["f32", "int8"])
@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_prefill_with_cache_matches_reference(mode, kv_bits):
    cfg, qj, qt = _served("glm4-9b")
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    rng = np.random.default_rng(5)
    n = np.array([27, 19], np.int32)
    toks = np.zeros((2, 32), np.int32)
    for i in range(2):
        toks[i, :n[i]] = rng.integers(0, cfg.vocab, n[i])

    @jax.jit
    def ref(p, tk, ln):
        with JL.serving_mode(mode, kernel=_kernel(mode)):
            return JT.prefill_with_cache(p, tk, cfg, 48, length=ln, cache_dtype=jnp.float32)

    lj, cj = ref(qj, jnp.asarray(toks), jnp.asarray(n))
    with torch.no_grad():
        lt, ct = TT.prefill_with_cache(qt, torch.as_tensor(toks), cfg, 48,
                                       length=torch.as_tensor(n), mode=mode)
    assert lt.shape == (2, cfg.vocab)
    assert _rel_err(to_np(lt), np.asarray(lj.astype(jnp.float32))) <= QUANT_RTOL
    assert ct["pos"].tolist() == n.tolist()
    _same_tree(ct, cj, bitwise_layers=[0])


@pytest.mark.parametrize("kv_bits", [None, 8], ids=["f32", "int8"])
def test_prefill_chunk_with_cache_matches_reference(kv_bits):
    """Two chunks of a 24-token prompt into a b = 1 cache: 13 tokens (no
    prefix), then 11 reading the first 13 rows through a prefix padded to
    16 (the engine's power-of-two bucket), its pad rows masked out."""
    cfg, qj, qt = _served("glm4-9b")
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    mode = "w8a8"
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, 24).astype(np.int32)
    cj = JT.init_cache(cfg, 1, 48, dtype=jnp.float32)
    ct = TT.init_cache(cfg, 1, 48, device="cpu")
    for start, end, pad in ((0, 13, 0), (13, 24, 16)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :end - start] = prompt[start:end]

        def ref(p, tk, c, st, ln, _pad=pad):
            with JL.serving_mode(mode, kernel="xla"):
                return JT.prefill_chunk_with_cache(p, tk, cfg, c, start=st, length=ln,
                                                   prefix_pad=_pad)

        lj, cj = jax.jit(ref)(qj, jnp.asarray(toks), cj, jnp.asarray(start, jnp.int32),
                              jnp.asarray([end - start], jnp.int32))
        with torch.no_grad():
            lt, ct = TT.prefill_chunk_with_cache(
                qt, torch.as_tensor(toks), cfg, ct, start=start,
                length=torch.tensor([end - start], dtype=torch.int32), prefix_pad=pad,
                mode=mode)
        assert _rel_err(to_np(lt), np.asarray(lj.astype(jnp.float32))) <= QUANT_RTOL, start
        assert int(ct["pos"][0]) == end
        _same_tree(ct, cj, bitwise_layers=[0])


# ---------------------------------------------------------------------------
# The unpaged engine


def _serve_ref(cfg, qj, prompts, conf, max_new):
    mode = conf.get("matmul_mode", "dequant")
    je = JEngine(cfg, qj, JConfig(**conf, kernels=KernelConfig(matmul=_kernel(mode))))
    for i, p in enumerate(prompts):
        je.submit(JRequest(uid=i, prompt=list(p), max_new_tokens=max_new))
    je.run()
    return je, {r.uid: (r.finish_reason, list(r.output)) for r in je.done}


def _serve_port(cfg, qt, prompts, conf, max_new):
    te = ServingEngine(cfg, qt, EngineConfig(**conf), device="cpu")
    for i, p in enumerate(prompts):
        te.submit(Request(uid=i, prompt=list(p), max_new_tokens=max_new))
    te.run()
    return te, {r.uid: (r.finish_reason, list(r.output)) for r in te.done}


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_unpaged_dense_engine_matches_reference(mode):
    """``paged=False`` on the smoke glm4-9b: monolithic prefill into the
    scratch cache, adopted into the lane's row; greedy tokens equal the
    reference engine's up to its near-ties, and the page stats read 0."""
    cfg, qj, qt = _served("glm4-9b")
    prompts = prompts_of(np.random.default_rng(8), cfg.vocab, (21, 9, 30))
    conf = dict(max_batch=2, max_len=64, paged=False, matmul_mode=mode)
    je, want = _serve_ref(cfg, qj, prompts, conf, 8)
    te, got = _serve_port(cfg, qt, prompts, conf, 8)
    assert te.paged is False and te.allocator is None
    assert_held(got, want, dict(enumerate(prompts)), ref_top2_margin(cfg, je.params, mode))
    st, sj = te.stats(), je.stats()
    for key in ("completed", "decoded_tokens", "prefill_calls", "prefill_tokens",
                "kv_page_size", "kv_pages_capacity", "kv_pool_occupancy",
                "kv_bytes_per_token", "kv_pool_capacity_tokens"):
        assert st[key] == sj[key], key
    assert st["kv_page_size"] == 0.0 and st["prefill_calls_per_request"] == 1.0


def test_chunked_prefill_exactness_unpaged():
    """The unpaged chunk path (scratch caches, ``chunk_size`` free of the
    page size) against the unpaged monolithic engine: tokens equal up to a
    near-tie of the monolithic oracle (the chunk's key count sets its key
    chunk, ``_torch_lifecycle``), and 21 tokens take >= 4 chunks of 6."""
    cfg, _, qt = _served("glm4-9b")
    prompts = prompts_of(np.random.default_rng(7), cfg.vocab, (21, 6, 4))
    conf = dict(max_batch=3, max_len=64, paged=False)
    _, oracle = _serve_port(cfg, qt, prompts, conf, 10)
    eng, got = _serve_port(cfg, qt, prompts, dict(conf, prefill_budget=12, chunk_size=6), 10)

    def margin(tokens):
        with torch.no_grad():
            lg, _ = TT.prefill_with_cache(qt, torch.as_tensor([tokens]), cfg, 64)
        top = torch.topk(lg[0].float(), 2).values
        return float(top[0] - top[1])

    assert_held(got, oracle, dict(enumerate(prompts)), margin)
    assert eng.stats()["sched_chunks"] >= 4


def test_ssm_replay_fallback():
    """An SSM engine prefills by decode-step replay: one prefill call per
    prompt token (4 + 6), and serves to completion."""
    cfg = t_smoke("mamba2-1.3b")
    params = TT.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    prompts = prompts_of(rng, cfg.vocab, (4, 6))
    eng, got = _serve_port(cfg, params, prompts, dict(max_batch=2, max_len=32), 3)
    assert eng.paged is False
    assert [reason for reason, _ in got.values()] == ["length", "length"]
    assert eng.stats()["prefill_calls"] == 10


def _ref_margin_fn(cfg, qj, mode):
    """``tokens -> (top-2 margin, max |logit|)`` of the reference after
    ``tokens``, decoded from a fresh dense cache (its engine's replay)."""
    dec = _ref_decode_fn(cfg, mode)

    def margin(tokens):
        c = JT.init_cache(cfg, 1, 64, dtype=jnp.float32)
        for t in tokens:
            lg, c = dec(qj, jnp.asarray([[t]], jnp.int32), c)
        lg = np.asarray(lg[0].astype(jnp.float32))
        top = np.sort(lg)[::-1]
        return float(top[0] - top[1]), float(np.abs(lg).max())

    return margin


@pytest.mark.parametrize("arch,mode,kv_bits", [
    ("mamba2-1.3b", "dequant", None), ("mamba2-1.3b", "w8a8", None),
    ("mamba2-1.3b", "w4a8", None), ("hymba-1.5b", "dequant", None),
    ("hymba-1.5b", "w8a8", 8), ("hymba-1.5b", "w4a8", None),
])
def test_ssm_and_hybrid_engines_match_reference(arch, mode, kv_bits):
    cfg, qj, qt = _served(arch)
    prompts = prompts_of(np.random.default_rng(0), cfg.vocab, (40, 7))
    conf = dict(max_batch=2, max_len=64, matmul_mode=mode, kv_bits=kv_bits)
    je, want = _serve_ref(cfg, qj, prompts, conf, 6)
    te, got = _serve_port(cfg, qt, prompts, conf, 6)
    assert te.paged is False and te.admission == "reserve"
    assert te.stats()["prefill_calls"] == je.stats()["prefill_calls"] == 47
    cfg_k = te.cfg
    # The model's logits, teacher-forced along the reference's stream.
    toks = prompts[0] + want[0][1]
    lj, lt, _, _ = _decode_both(cfg_k, je.params, te.params, toks, mode)
    err = max(_rel_err(lt[i], lj[i]) for i in range(len(toks)))
    print(arch, mode, kv_bits, f"logits {err:.4f} of the range")
    assert err <= QUANT_RTOL, err
    margin = _ref_margin_fn(cfg_k, je.params, mode)
    partings = []
    for uid, (reason, w) in want.items():
        g = got[uid][1]
        assert got[uid][0] == reason and len(g) == len(w)
        d = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if d is not None:
            m, top = margin(list(prompts[uid]) + w[:d])
            assert m <= 2 * QUANT_RTOL * top, (uid, d, m, top)
            partings.append((uid, d, m))
    print(arch, mode, "partings:", partings)


def test_unpaged_engine_refusals_and_policies():
    cfg = t_smoke("mamba2-1.3b")
    params = TT.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ConfigError, match="int4"):
        EngineConfig(kv_bits=4, paged=False)
    with pytest.raises(ConfigError, match="unpaged"):  # resolved unpaged
        ServingEngine(cfg, params, EngineConfig(kv_bits=4), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, params, EngineConfig(paged=True), device="cpu")
    # Speculation on the unpaged engine: a dense model serves (held token for
    # token in test_torch_unpaged_spec.py); an SSM model keeps the
    # reference's refusal.
    glm = t_smoke("glm4-9b")
    spec_eng = ServingEngine(glm, TT.init_params(glm, device="cpu"),
                             EngineConfig(paged=False, max_len=32, spec=SpecConfig(k=2)),
                             device="cpu")
    spec_eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=5))
    (r,) = spec_eng.run()
    assert r.finish_reason == "length" and len(r.output) == 5
    assert spec_eng.stats()["spec_rounds"] > 0
    with pytest.raises(ValueError, match="roll back"):
        ServingEngine(cfg, params, EngineConfig(spec=SpecConfig(k=2)), device="cpu")
    eng = ServingEngine(cfg, params, EngineConfig(max_len=32, admission="optimistic"),
                        device="cpu")
    assert eng.admission == "reserve" and eng.paged is False
    # chunk_size need not align to the page size on an unpaged engine.
    EngineConfig(paged=False, prefill_budget=12, chunk_size=6)
    with pytest.raises(ValueError, match="multiple of page_size"):
        EngineConfig(prefill_budget=12, chunk_size=6)


@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2-1.3b"],
    ["--arch", "hymba-1.5b", "--matmul-mode", "w8a8", "--kv-bits", "8"],
    ["--arch", "hymba-1.5b", "--matmul-mode", "w4a8"],
    ["--arch", "glm4-9b", "--paged", "off", "--prefill-budget", "12", "--chunk-size", "6"],
], ids=["mamba2", "hymba-w8a8", "hymba-w4a8", "glm-unpaged-chunked"])
def test_launch_serve_unpaged_on_cpu(argv):
    """``launch.serve`` end to end at smoke size on the unpaged engine: the
    SSM and hybrid archs (unpaged by default) and a dense one with
    ``--paged off``."""
    from repro_torch.launch import serve

    stats = serve.main(argv + ["--smoke", "--device", "cpu", "--n-requests", "3",
                               "--max-new", "4", "--max-len", "64"])
    assert stats["completed"] == 3 and stats["errors"] == 0
    assert stats["decoded_tokens"] == 3 * 3
    assert stats["kv_page_size"] == 0.0 and stats["kv_pages_capacity"] == 0.0


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_fixed_seed_bit_reproducible_and_paged_matches_unpaged(mode):
    """The counterpart of the reference's ``test_sampling.py`` case: a
    fixed-seed sampled request gives the same tokens run twice, and the
    paged and unpaged engines sample it identically (a draw depends on
    (seed, position) only; on the CPU the dense cache's float32 attention
    gives the paged plain version's logits)."""
    from repro_torch.serving import SamplingParams

    cfg, _, qt = _served("glm4-9b")
    sp = SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=123)

    def run(paged):
        rng = np.random.default_rng(11)
        eng = ServingEngine(cfg, qt, EngineConfig(max_batch=2, max_len=64, paged=paged,
                                                  matmul_mode=mode), device="cpu")
        for i, n in enumerate((5, 11, 3)):
            eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).tolist(),
                               max_new_tokens=6, sampling=sp))
        return {r.uid: list(r.output) for r in eng.run()}

    a = run(True)
    assert run(True) == a, "fixed-seed sampling must be bit-reproducible"
    assert run(False) == a, "paged and unpaged engines must sample identically"
