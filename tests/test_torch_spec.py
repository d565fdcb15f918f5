"""Port parity, self-speculative decoding: B2's multi-row (Q > 1) path,
``verify_step``, the rollback and the engine's spec rounds.

* B2's plain version at Q in {2, 5, 17} against the reference's
  interpret-mode kernel (and, for int4 pools, its gather oracle) on the same
  numpy inputs: appended pools bitwise, outputs within ``B2_ATOL`` (as in
  test_torch_kernels.py). Each row is also bitwise the sequential Q = 1
  calls of the plain version (pages of 16; on the CPU, PyTorch picks its
  GEMM path by shape, and the plain versions send a lone row through as
  two rows, so the contraction shapes the model uses sum a row in one
  order).
* ``verify_step`` over k + 1 tokens is bitwise k + 1 sequential
  ``decode_step`` calls of the port (logits, every layer's pools,
  positions) in dequant, w8a8 and w4a8, and within the model tests'
  tolerances of the reference's ``verify_step`` on float32 pools.
* ``committed_tokens`` and ``AdaptiveK`` equal the reference's on the same
  sequences.
* The engine ports of ``tests/test_spec_decode.py``'s contracts: spec
  output equals plain greedy in every matmul mode and pool kind, eos and
  the length budget inside a window, continuous batching, allocator state
  after rollback equal to a plain run's, the overlong-budget refusal, the
  stats schema, and a window of 16.
* The repairs the verify contract needs: ``rms_norm`` and ``dense`` give a
  row the same bits in a call of 8 rows and one of 40; the weight-only
  GEMM's split plan and its row chunks.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from _torch_interop import (  # noqa: F401
    SERVE_RECIPE, glm_smoke, glm_smoke_served, jax_tree_to_numpy, to_np, torch_threads)

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import kv_cache as jkvc
from repro.serving.spec_decode import AdaptiveK as JAdaptiveK
from repro.serving.spec_decode import SpecConfig as JSpecConfig
from repro.serving.spec_decode import committed_tokens as j_committed_tokens

from repro_torch.configs import smoke_config
from repro_torch.core.apply import map_with_path, quantize_params
from repro_torch.core.ocs import OCSQuantLinear, to_w4a8
from repro_torch.core.recipe import QuantRecipe
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import (EngineConfig, PageAllocator, Request, ServingEngine,
                                 add_engine_config_args, engine_config_from_args)
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving.spec_decode import AdaptiveK, SpecConfig, committed_tokens

B2_ATOL = 2e-5
# The model tests' tolerances (test_torch_model.py), relative to the
# largest reference logit.
W8A8_RTOL = 0.06
DEQUANT_RTOL = 0.02


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# B2's multi-row path


def _multirow_case(seed, kind, qn, ps, B=3, T=6, KV=2, rep=2, hd=16):
    """``qn`` query tokens per lane over ragged lanes: lane 0's window runs
    past its two pages into trash table entries, lane 1 owns every page it
    reaches, lane 2 is retired (all trash). Page 0 is NaN-poisoned."""
    rng = np.random.RandomState(seed)
    P = B * T + 1
    if kind == "float":
        pool = {"k": rng.randn(P, KV, ps, hd).astype(np.float32),
                "v": rng.randn(P, KV, ps, hd).astype(np.float32)}
        pool["k"][0] = pool["v"][0] = np.nan
    else:
        lo, hi, dt, row = ((-127, 128, np.int8, hd) if kind == "int8"
                           else (0, 256, np.uint8, hd // 2))
        pool = {"k": rng.randint(lo, hi, (P, KV, ps, row)).astype(dt),
                "v": rng.randint(lo, hi, (P, KV, ps, row)).astype(dt),
                "k_scale": (rng.rand(P, KV, ps) * 0.1 + 0.01).astype(np.float32),
                "v_scale": (rng.rand(P, KV, ps) * 0.1 + 0.01).astype(np.float32)}
        pool["k_scale"][0] = pool["v_scale"][0] = np.nan
    table = np.zeros((B, T), np.int32)
    table[0, :2] = [1, 2]
    pos1 = T * ps - qn - 3
    n1 = (pos1 + qn - 1) // ps + 1
    table[1, :n1] = np.arange(3, 3 + n1)
    pos = np.array([ps + 3, pos1, 0], np.int32)
    q = rng.randn(B, qn, KV * rep, hd).astype(np.float32)
    kn = rng.randn(B, qn, KV, hd).astype(np.float32)
    vn = rng.randn(B, qn, KV, hd).astype(np.float32)
    return pool, table, pos, q, kn, vn


def _jax_args(pool, table, pos, q, kn, vn):
    return ({k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(table),
            jnp.asarray(pos), jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn))


def _torch_args(pool, table, pos, q, kn, vn):
    return ({k: torch.from_numpy(v.copy()) for k, v in pool.items()},
            torch.from_numpy(table), torch.from_numpy(pos), torch.from_numpy(q),
            torch.from_numpy(kn), torch.from_numpy(vn))


@pytest.mark.parametrize("qn", [2, 5, 17])
@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_multirow_plain_vs_reference(kind, qn):
    """Pools bitwise (the trash page, which several rows write and nothing
    reads, aside), outputs within ``B2_ATOL`` and finite, the retired lane
    exact zeros."""
    case = _multirow_case(qn * 7 + len(kind), kind, qn, ps=8)
    jargs = _jax_args(*case)
    want = [jops.paged_attention(*jargs, force="interpret")]
    if kind == "int4":
        want.append(jax.jit(jpa.paged_attention_gather_ref)(*jargs))
    o_t, p_t = ops.paged_attention(*_torch_args(*case))
    assert tuple(o_t.shape) == case[3].shape and o_t.dtype == torch.float32
    assert np.isfinite(o_t.numpy()).all()
    assert (o_t.numpy()[2] == 0).all()
    for o_j, p_j in want:
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=B2_ATOL, rtol=0)
        for key in p_j:
            assert _same_bits(p_t[key].numpy()[1:], np.asarray(p_j[key])[1:]), key


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_multirow_rows_equal_sequential_calls(kind):
    """Each of a Q = 5 call's rows is bitwise the Q = 1 call at its
    position, and the pools end bitwise alike."""
    qn = 5
    pool, table, pos, q, kn, vn = _torch_args(*_multirow_case(3, kind, qn, ps=16))
    out, got_pool = tpa.paged_attention_plain(pool, table, pos, q, kn, vn)
    seq_pool, outs = pool, []
    for j in range(qn):
        o, seq_pool = tpa.paged_attention_plain(seq_pool, table, pos + j, q[:, j:j + 1],
                                                kn[:, j:j + 1], vn[:, j:j + 1])
        outs.append(o)
    assert _same_bits(torch.cat(outs, 1).numpy(), out.numpy())
    for key in got_pool:
        assert _same_bits(seq_pool[key].numpy()[1:], got_pool[key].numpy()[1:]), key


def test_tile_rows():
    """Whole query tokens a tile; a Q = 1 call is one tile (its fused
    append); the tile fits shared memory; one token's rows that cannot fit
    raise."""
    assert tpa.tile_rows(1, 16, 128, 16) == 16
    assert tpa.tile_rows(17, 16, 128, 16) == 16
    assert tpa.tile_rows(1, 1, 128, 16) == 1
    assert tpa.tile_rows(5, 4, 128, 16) == 16
    assert tpa.tile_rows(3, 4, 128, 16) == 12
    for qn, rep, hd, ps in ((64, 2, 256, 64), (9, 32, 128, 16), (3, 7, 64, 32)):
        rows = tpa.tile_rows(qn, rep, hd, ps)
        assert rows % rep == 0 and tpa._smem_bytes(rows, hd, ps) <= tpa._MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        tpa.tile_rows(2, 512, 128, 16)


def test_multirow_cuda_request_never_gets_the_plain_result(monkeypatch):
    """A Q > 1 call on tensors that claim to be CUDA reaches the CUDA
    wrapper, which raises here; the plain version never runs and no count
    moves."""
    monkeypatch.setattr(ops, "_device_kind", lambda t: "cuda")
    calls = []
    monkeypatch.setattr(tpa, "paged_attention_plain", lambda *a, **k: calls.append(1))
    n0 = (tpa.launches, tpa.launches_verify)
    pool = {"k": torch.zeros((2, 1, 4, 8)), "v": torch.zeros((2, 1, 4, 8))}
    kn = torch.zeros((1, 3, 1, 8), dtype=torch.bfloat16)
    with pytest.raises((ValueError, RuntimeError)):
        ops.paged_attention(pool, torch.ones((1, 2), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros((1, 3, 2, 8), dtype=torch.bfloat16), kn, kn)
    assert not calls and (tpa.launches, tpa.launches_verify) == n0


# ---------------------------------------------------------------------------
# Row-count independence of the layers


def test_rms_norm_and_dense_rows_independent_of_row_count():
    """A row's bits do not depend on how many rows the call holds: rows of
    an 8-row (and a 1-row) call equal the same rows inside a 40-row call,
    for ``rms_norm`` and for ``dense`` in each mode."""
    cfg = smoke_config("glm4-9b")
    q = quantize_params(TT.init_params(cfg, seed=1, device="cpu"),
                        QuantRecipe(**SERVE_RECIPE), device="cpu")
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((40, cfg.d_model), generator=g) * 2).to(torch.bfloat16)
    scale = torch.rand(cfg.d_model, generator=g) + 0.5
    full = TL.rms_norm(scale, x)
    for lo, n in ((0, 8), (16, 8), (5, 1)):
        assert torch.equal(TL.rms_norm(scale, x[lo:lo + n]), full[lo:lo + n])
    want = torch.mean(x.float() ** 2, dim=-1, keepdim=True)
    got = TL._row_sum(x.float() ** 2) / cfg.d_model
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    w = q["lm_head"]
    for mode, leaf in (("dequant", w), ("w8a8", w), ("w4a8", to_w4a8(w, 0.05))):
        full = TL.dense(leaf, x, mode=mode)
        for lo, n in ((0, 8), (16, 8), (5, 1)):
            assert torch.equal(TL.dense(leaf, x[lo:lo + n], mode=mode), full[lo:lo + n]), mode


def test_weight_only_split_plan_and_row_chunks():
    """B4/B5's weight-only split K follows from K and N alone, and a call
    with many rows runs in row chunks whose workspace stays within 64 MiB
    (240 rows at w_down); at glm4-9b's shapes every verify step of 8 lanes
    and a window of 16 (136 rows) runs in one chunk, and an 8192-token
    prompt in chunks."""
    from repro_torch.kernels import quant_matmul as qm

    assert qm._MAX_PART_BYTES == 64 << 20
    shapes = {"wq/wo": (4096 + 82, 4096), "wk/wv": (4096 + 82, 256),
              "w_gate/w_up": (4096 + 82, 13696), "w_down": (13696 + 274, 4096),
              "clip w_down": (13696, 4096), "lm_head": (4096 + 82, 151552)}
    for name, (ke, n) in shapes.items():
        k_chunk, nsplit = qm.wo_split_plan(ke, n)
        assert k_chunk % 16 == 0 and (nsplit - 1) * k_chunk < ke <= nsplit * k_chunk, name
        for m in (1, 8, 40, 136, EngineConfig().max_len, 8192):
            rows = qm.wo_row_chunk(m, n, nsplit)
            assert 1 <= rows <= m and 4 * nsplit * rows * n <= 64 << 20, (name, m)
            if m <= 136 and name != "lm_head":
                assert rows == m, (name, m)
    nsplit = qm.wo_split_plan(13696 + 274, 4096)[1]
    assert nsplit == 17 and qm.wo_row_chunk(8192, 4096, nsplit) == 240


# ---------------------------------------------------------------------------
# verify_step


@pytest.fixture(scope="module")
def port_model():
    """The smoke glm4-9b, seed 0, quantized by the port on the CPU with the
    serving recipe (fast: the engine contracts need no reference)."""
    cfg = smoke_config("glm4-9b")
    params = TT.init_params(cfg, seed=0, device="cpu")
    return cfg, params, quantize_params(params, QuantRecipe(**SERVE_RECIPE), device="cpu")


def _tier(q, mode):
    """The tree a mode serves: W4A8 leaves (to_w4a8 at 0.05) for w4a8."""
    if mode != "w4a8":
        return q
    return map_with_path(lambda _p, leaf: to_w4a8(leaf, 0.05)
                         if isinstance(leaf, OCSQuantLinear) else leaf, q)


# (matmul mode, KV bits) of the three serving tiers.
TIERS = [("dequant", None), ("w8a8", 8), ("w4a8", 4)]


def _caches(cfg, kv_bits, B, T, ps, pos):
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    caches = tkvc.init_paged_cache(cfg, B, B * T + 1, ps, T, device="cpu")
    caches["table"] = torch.arange(1, B * T + 1, dtype=torch.int32).reshape(B, T)
    caches["pos"] = torch.tensor(pos, dtype=torch.int32)
    return cfg, caches


@pytest.mark.parametrize("mode,kv_bits", TIERS)
def test_verify_step_bitwise_sequential_decode(port_model, mode, kv_bits):
    """verify_step over 5 tokens (3 lanes at ragged positions, after 6
    teacher-forced decode steps of context) is bitwise 5 sequential
    decode_step calls: logits, every layer's pools, positions."""
    cfg0, _, q = port_model
    params = _tier(q, mode)
    cfg, caches = _caches(cfg0, kv_bits, B=3, T=4, ps=16, pos=[0, 9, 30])
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for t in rng.integers(0, cfg.vocab, (6, 3)):
            _, caches = TT.decode_step(params, torch.as_tensor(t[:, None], dtype=torch.int32),
                                       caches, cfg, mode=mode)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 5)), dtype=torch.int32)
        seq_caches, outs = copy.deepcopy(caches), []
        for j in range(5):
            lg, seq_caches = TT.decode_step(params, toks[:, j:j + 1], seq_caches, cfg, mode=mode)
            outs.append(lg)
        lg_v, ver_caches = TT.verify_step(params, toks, copy.deepcopy(caches), cfg, mode=mode)
    assert lg_v.shape == (3, 5, cfg.vocab)
    assert _same_bits(to_np(torch.stack(outs, 1)), to_np(lg_v))
    assert torch.equal(ver_caches["pos"], seq_caches["pos"])
    assert ver_caches["pos"].tolist() == [11, 20, 41]
    for i in range(cfg.n_layers):
        for key, val in ver_caches["layers"][i]["attn"].items():
            assert _same_bits(val.numpy(), seq_caches["layers"][i]["attn"][key].numpy()), (i, key)


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_verify_step_matches_reference(glm_smoke_served, mode):
    """The port's verify_step against the reference's on float32 pools,
    from the same quantized tree (the reference runs its kernel route in
    dequant and the XLA composition in w8a8, f32-after-dequant attention,
    as test_torch_model.py): logits within the model tests' tolerance,
    layer 0's pools bitwise."""
    from repro.configs import smoke_config as j_smoke

    qj, qt = glm_smoke_served
    cfg = j_smoke("glm4-9b")
    B, T, ps, qn = 2, 4, 16, 5
    rng = np.random.default_rng(11)
    ctx = rng.integers(0, cfg.vocab, (3, B))
    toks = rng.integers(0, cfg.vocab, (B, qn)).astype(np.int32)
    table = np.arange(1, B * T + 1, dtype=np.int32).reshape(B, T)
    pos = np.array([2, 17], np.int32)
    kernel = "pallas" if mode == "dequant" else "xla"

    def jstep(params, t, caches):
        with JL.serving_mode(mode, kernel=kernel):
            return JT.verify_step(params, t, caches, cfg, attn_kernel="xla")

    jstep = jax.jit(jstep)
    jc = jkvc.init_paged_cache(cfg, B, B * T + 1, ps, T, dtype=jnp.float32)
    jc["table"], jc["pos"] = jnp.asarray(table), jnp.asarray(pos)
    for t in ctx:
        _, jc = jstep(qj, jnp.asarray(t[:, None], jnp.int32), jc)
    want, jc = jstep(qj, jnp.asarray(toks), jc)

    tcfg, tc = _caches(smoke_config("glm4-9b"), None, B, T, ps, pos.tolist())
    with torch.no_grad():
        for t in ctx:
            _, tc = TT.verify_step(qt, torch.as_tensor(t[:, None], dtype=torch.int32), tc,
                                   tcfg, mode=mode)
        got, tc = TT.verify_step(qt, torch.as_tensor(toks), tc, tcfg, mode=mode)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(to_np(got) - want).max()
    rtol = DEQUANT_RTOL if mode == "dequant" else W8A8_RTOL
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    for key in ("k", "v"):
        np.testing.assert_array_equal(tc["layers"][0]["attn"][key].numpy(),
                                      np.asarray(jc["layers"][0]["attn"][key]))


def test_truncated_draft_runs_prefix_only(port_model):
    """layers_limit: the drafter runs the first L layers (other logits) and
    leaves the skipped layers' pools untouched."""
    cfg0, _, q = port_model
    cfg, caches = _caches(cfg0, 8, B=2, T=2, ps=16, pos=[3, 5])
    before = copy.deepcopy(caches)
    tok = torch.tensor([[37], [5]], dtype=torch.int32)
    with torch.no_grad():
        full, _ = TT.decode_step(q, tok, copy.deepcopy(caches), cfg, mode="w8a8")
        part, c2 = TT.decode_step(q, tok, caches, cfg, mode="w8a8", layers_limit=1)
    assert (full - part).abs().max() > 0
    for key, val in c2["layers"][-1]["attn"].items():
        assert torch.equal(val, before["layers"][-1]["attn"][key])
    assert not torch.equal(c2["layers"][0]["attn"]["k"], before["layers"][0]["attn"]["k"])
    assert c2["pos"].tolist() == [4, 6]


def test_rewind_positions():
    pos = torch.tensor([5, 9, 0], dtype=torch.int32)
    out = tkvc.rewind_positions(pos, np.array([3, 9, 0]))
    assert out.dtype == torch.int32 and out.tolist() == [3, 9, 0]


# ---------------------------------------------------------------------------
# Acceptance and the window controller against the reference


@settings(deadline=None, database=None, max_examples=40)
@given(st.integers(0, 6), st.data())
def test_committed_tokens_equal_reference(k, data):
    draft = data.draw(st.lists(st.integers(0, 3), min_size=k, max_size=k))
    greedy = data.draw(st.lists(st.integers(0, 3), min_size=k + 1, max_size=k + 1))
    assert committed_tokens(draft, greedy, k) == j_committed_tokens(draft, greedy, k)


@settings(deadline=None, database=None, max_examples=30)
@given(st.integers(1, 6), st.integers(1, 6), st.booleans(),
       st.lists(st.tuples(st.integers(0, 10), st.integers(0, 10)), max_size=25))
def test_adaptive_k_equals_reference(k, k_min, adaptive, rounds):
    k_min = min(k_min, k)
    kw = dict(k=k, k_min=k_min, adaptive=adaptive, ema=0.5)
    a, b = AdaptiveK(SpecConfig(**kw)), JAdaptiveK(JSpecConfig(**kw))
    assert a.k == b.k
    for acc, prop in rounds:
        acc = min(acc, prop)
        assert a.update(acc, prop) == b.update(acc, prop)
        assert a.acc_ema == b.acc_ema


def test_spec_config_checks_and_defaults():
    assert dataclasses.asdict(SpecConfig()) == dataclasses.asdict(JSpecConfig())
    for kw in (dict(k=0), dict(k=2, k_min=3), dict(k_min=0), dict(draft_layers=0)):
        with pytest.raises(ValueError):
            SpecConfig(**kw)
    SpecConfig(k=16)  # any window: the kernel tiles its rows
    with pytest.raises(ValueError, match="draft_mode='w4a8'"):
        EngineConfig(matmul_mode="w4a8", spec=SpecConfig(k=2))
    EngineConfig(matmul_mode="w4a8", spec=SpecConfig(k=2, draft_mode="w4a8"))
    with pytest.raises(TypeError):
        EngineConfig(spec={"k": 2})


def test_spec_flags_round_trip():
    import argparse

    ap = argparse.ArgumentParser()
    add_engine_config_args(ap)
    assert engine_config_from_args(ap.parse_args([])).spec is None
    ec = engine_config_from_args(ap.parse_args(["--spec-k", "5", "--draft-layers", "2"]))
    assert ec.spec == SpecConfig(k=5, draft_layers=2)
    ec = engine_config_from_args(ap.parse_args(["--spec-k", "3"]))
    assert ec.spec == SpecConfig(k=3)


# ---------------------------------------------------------------------------
# The engine: spec output equals plain greedy


def _alloc_state(a):
    """What rollback must leave as a plain run does once the requests have
    retired: pages in use, free and cached, refcounts, the prefix cache's
    chain keys and the prefix counters. (Which page ids sit where on the
    free list follows the order the lanes retire in, which speculation
    changes.)"""
    return (a.in_use(), a.available(), a.cached_pages(), dict(a._ref), sorted(a._page_of),
            a.prefix_hit_pages, a.prefix_lookup_pages)


def _run(cfg, params, prompts, *, max_new=6, spec=None, max_batch=3, max_len=64,
         matmul_mode="dequant", kv_bits=None, eos=None):
    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=max_batch, max_len=max_len, matmul_mode=matmul_mode, kv_bits=kv_bits,
        spec=spec), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=max_new, eos_id=eos))
    done = {r.uid: r.output for r in eng.run()}
    return done, eng


def _prompts(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


@pytest.mark.parametrize("mode,kv_bits,spec", [
    ("dequant", None, SpecConfig(k=3)),
    ("w8a8", 8, SpecConfig(k=3, draft_layers=1)),
    ("w4a8", 4, SpecConfig(k=3, draft_mode="w4a8")),
], ids=["dequant-f32", "w8a8-int8-draft1", "w4a8-int4"])
def test_spec_matches_plain_greedy(port_model, mode, kv_bits, spec):
    """A real draft/target split in each tier: drafts get rejected, yet the
    stream is token-identical to plain greedy, and the allocator ends in
    the plain run's state (every request's footprint, no stray refcount,
    the same prefix cache)."""
    cfg, _, q = port_model
    prompts = _prompts(cfg.vocab, 7, [3, 11, 6, 21, 16])
    common = dict(max_new=8, max_batch=5, matmul_mode=mode, kv_bits=kv_bits)
    plain, eng_p = _run(cfg, q, prompts, **common)
    got, eng_s = _run(cfg, q, prompts, spec=spec, **common)
    assert got == plain and all(len(o) == 8 for o in got.values())
    s = eng_s.stats()
    assert s["spec_rounds"] > 0 and s["spec_proposed"] > 0
    assert 0.0 <= s["spec_acceptance_rate"] <= 1.0
    assert s["spec_tokens_per_target_step"] >= 1.0
    assert s["decode_steps"] == s["spec_rounds"]
    assert _alloc_state(eng_s.allocator) == _alloc_state(eng_p.allocator)
    assert eng_s.allocator.peak_in_use == eng_p.allocator.peak_in_use  # all admitted at once
    assert eng_s.allocator.in_use() == 0 and eng_s.allocator._ref == {}


def test_spec_identical_draft_accepts_everything(port_model):
    """Drafting in the target's own mode with every layer, the draft IS the
    target: a verify row is bitwise its decode step, so acceptance is
    exactly 1.0 and target steps are fewer than tokens."""
    cfg, _, q = port_model
    prompts = _prompts(cfg.vocab, 3, [5, 9])
    plain, _ = _run(cfg, q, prompts, max_new=7, max_batch=2)
    got, eng = _run(cfg, q, prompts, max_new=7, max_batch=2,
                    spec=SpecConfig(k=3, draft_mode="dequant"))
    assert got == plain
    s = eng.stats()
    assert s["spec_acceptance_rate"] == 1.0
    assert s["decode_steps"] < s["decoded_tokens"]


def test_spec_eos_mid_window(port_model):
    """eos inside an accepted window retires the lane with the tail
    dropped: the tokens of the plain engine with the same eos, pages
    reclaimed."""
    cfg, _, q = port_model
    prompts = _prompts(cfg.vocab, 17, [9])
    probe, _ = _run(cfg, q, prompts, max_new=10, max_batch=1)
    eos = probe[0][len(probe[0]) // 2]
    plain, _ = _run(cfg, q, prompts, max_new=10, max_batch=1, eos=eos)
    got, eng = _run(cfg, q, prompts, max_new=10, max_batch=1, eos=eos,
                    spec=SpecConfig(k=3, draft_mode="dequant", adaptive=False))
    assert got == plain
    assert got[0][-1] == eos and len(got[0]) < 10
    assert eng.stats()["kv_pages_in_use"] == 0


@pytest.mark.parametrize("max_new", [2, 3, 4, 5])
def test_spec_max_new_boundary_inside_window(port_model, max_new):
    """The budget lands at every offset inside a fully accepted window
    (k=3: windows commit up to 4 tokens): the output stops exactly at
    max_new_tokens, as the plain engine's."""
    cfg, _, q = port_model
    prompts = _prompts(cfg.vocab, 23, [6])
    plain, _ = _run(cfg, q, prompts, max_new=max_new, max_batch=1)
    got, _ = _run(cfg, q, prompts, max_new=max_new, max_batch=1,
                  spec=SpecConfig(k=3, draft_mode="dequant", adaptive=False))
    assert got == plain and len(got[0]) == max_new


def test_spec_mixed_continuous_batching(port_model):
    """More requests than lanes, mixed lengths and budgets: all complete,
    all token-identical to plain serving."""
    cfg, _, q = port_model
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in rng.integers(3, 24, 6)]
    plain, _ = _run(cfg, q, prompts, max_new=5, max_batch=2)
    got, eng = _run(cfg, q, prompts, max_new=5, max_batch=2, spec=SpecConfig(k=3))
    assert got == plain and len(got) == 6
    assert eng.stats()["completed"] == 6


def test_spec_nonfinite_lane_commits_nothing(port_model, monkeypatch):
    """A lane whose verify logits go nonfinite commits nothing from the
    window and retires with ``error``; the other lane is untouched."""
    cfg, _, q = port_model
    prompts = _prompts(cfg.vocab, 41, [7, 12])
    plain, _ = _run(cfg, q, prompts, max_new=6, max_batch=2)
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=2, max_len=64, spec=SpecConfig(k=3)),
                        device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    from repro_torch.serving import spec_decode

    verify = spec_decode.T.verify_step

    def poisoned(*args, **kw):  # lane 0's verify logits go NaN at one position
        logits, caches = verify(*args, **kw)
        logits[0, -1, 3] = float("nan")
        return logits, caches

    eng.step()  # admit both; the first round is clean
    n0 = len(eng.slots[0].req.output)
    monkeypatch.setattr(spec_decode.T, "verify_step", poisoned)
    eng.step()
    monkeypatch.setattr(spec_decode.T, "verify_step", verify)
    done = {r.uid: r for r in eng.run()}
    assert done[0].finish_reason == "error" and len(done[0].output) == n0
    assert done[0].output == plain[0][:n0]
    assert done[1].output == plain[1] and done[1].finish_reason == "length"
    assert eng.stats()["errors"] == 1 and eng.allocator.in_use() == 0


def test_spec_submit_rejects_overlong_budget(port_model):
    """Spec engines need prompt + max_new_tokens <= max_len (committed
    positions must live in real cache slots)."""
    cfg, _, q = port_model
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=32, spec=SpecConfig(k=2)),
                        device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(uid=0, prompt=list(range(20)), max_new_tokens=20))
    eng.submit(Request(uid=1, prompt=list(range(20)), max_new_tokens=12))


def test_spec_stats_schema(port_model):
    cfg, _, q = port_model
    done, eng = _run(cfg, q, [[1, 2, 3], [4, 5, 6, 7]], max_new=5, max_batch=2,
                     spec=SpecConfig(k=2))
    s = eng.stats()
    for key in ("spec_enabled", "spec_rounds", "spec_k", "spec_proposed", "spec_accepted",
                "spec_acceptance_rate", "spec_tokens_per_target_step",
                "spec_draft_time_s", "spec_verify_time_s", "spec_compile_s"):
        assert key in s, key
    assert s["spec_enabled"] == 1.0 and s["spec_compile_s"] == 0.0
    assert s["decoded_tokens"] == 8  # 2 requests x (5 - 1): the first is prefill's
    assert all(len(o) == 5 for o in done.values())
    assert s["decode_steps"] <= s["decoded_tokens"]
    assert s["decode_time_s"] == pytest.approx(s["spec_draft_time_s"] + s["spec_verify_time_s"])
    _, plain = _run(cfg, q, [[1, 2, 3]], max_new=3, max_batch=1)
    ps = plain.stats()
    assert ps["spec_enabled"] == 0.0 and ps["spec_rounds"] == 0.0
    assert ({k for k in s if k.startswith("spec_")} == {k for k in ps if k.startswith("spec_")})


def test_spec_window_of_16_serves(port_model):
    """SpecConfig(k=16), no window cap: every lane's window (verify Q = 17)
    runs, and the output equals plain greedy."""
    cfg, _, q = port_model
    prompts = _prompts(cfg.vocab, 51, [5, 14])
    plain, _ = _run(cfg, q, prompts, max_new=20, max_batch=2, max_len=64)
    got, eng = _run(cfg, q, prompts, max_new=20, max_batch=2, max_len=64,
                    spec=SpecConfig(k=16, draft_mode="dequant", adaptive=False))
    assert got == plain
    s = eng.stats()
    assert s["spec_k"] == 16.0 and s["spec_acceptance_rate"] == 1.0
    assert s["decode_steps"] == 2  # 19 tokens a lane: a window of 16 + 1, then 2


def test_spec_engine_allocator_after_rollback(port_model):
    """Rollback leaves the allocator as a run that never speculated, with
    more requests than lanes and a prefix hit: nothing in use, no stray
    refcount, the same cached pages and prefix-cache keys."""
    cfg, _, q = port_model
    prompts = _prompts(cfg.vocab, 31, [17, 5, 33, 12])
    prompts.append(prompts[0][:16] + [3, 4])  # a prefix hit on the first page
    _, eng_p = _run(cfg, q, prompts, max_new=6)
    _, eng_s = _run(cfg, q, prompts, max_new=6, spec=SpecConfig(k=3, draft_layers=1))
    assert _alloc_state(eng_s.allocator) == _alloc_state(eng_p.allocator)
    assert eng_s.stats()["prefix_hit_pages"] == eng_p.stats()["prefix_hit_pages"] > 0


def test_allocator_truncate():
    """The port's PageAllocator.truncate: releases exactly the tail past the
    committed token count; registered pages stay hit-able."""
    a = PageAllocator(n_pages=8, page_size=4)
    ids = a.alloc(5)
    kept = a.truncate(ids, 10)
    assert kept == ids[:3] and a.in_use() == 3 and a.available() == 4
    assert a.truncate(kept, 12) == kept
    key = a.chain_keys([1, 2, 3, 4], 1)[0]
    a.register(key, kept[0])
    assert a.truncate(kept, 0) == []
    assert a.in_use() == 0 and a.cached_pages() == 1
    hits, _ = a.match_prefix([1, 2, 3, 4], max_pages=1)
    assert hits == [kept[0]]
