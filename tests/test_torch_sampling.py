"""Port parity, sampling and the streaming API: ``repro_torch.serving.sampling``
against ``repro.serving.sampling`` on the same numpy logits, and the port's
engine under the reference's sampling, cancellation and streaming tests
(``tests/test_sampling.py``, ``tests/test_engine_api.py``).

* The temperature-scaled logits and the kept set (top-k widened by ties,
  then the nucleus) are bitwise the reference's: its ``masked`` operand of
  ``jax.random.categorical`` is read by wrapping ``jax.vmap`` while its
  ``sample_tokens`` runs. The one exception is a token whose nucleus
  decision float32 rounding settles (the mass before it within 4 ulps of
  ``top_p``): the two stacks' ``exp`` differ by an ulp now and then. With
  ``top_p < 1`` the cases have no such token; at ``top_p = 1`` it is the
  far tail, which the reference drops where its float32 cumulative sum
  reaches 1.0, and which holds under 1e-5 of the mass.
* Greedy lanes are the exact argmax; every draw lies in the kept set; a
  draw depends on ``(seed, position)`` only (fixed seeds reproduce, a row
  draws alike alone or in a batch, lanes can be permuted); over 4,000 seeds
  the draw frequencies pass a chi-square test against the masked softmax
  at the 0.999 quantile.
* The port's draws are not the reference's (Threefry's key stream is not a
  goal), so engine tests hold sampled streams against the port itself.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import stats as sps

from _torch_interop import torch_threads  # noqa: F401
from _torch_lifecycle import port_smoke, serve  # noqa: F401

from repro.serving import sampling as jsampling
from repro.serving import SamplingParams as JSamplingParams

from repro_torch.serving import (
    EngineConfig, Request, SamplingParams, ServingEngine, TokenEvent)
from repro_torch.serving import sampling as tsampling
from repro_torch.serving.spec_decode import SpecConfig


def _case(b=4, v=64, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, v) * 3).astype(np.float32)
    if ties:  # repeated values: top-k and the nucleus must widen alike
        logits = np.round(logits)
    pos = rng.randint(1, 50, b).astype(np.int32)
    return logits, pos


def _params(b, seed0=0, **kw):
    return [SamplingParams(**kw, seed=seed0 + i) for i in range(b)]


def _ref_masked(logits, params, pos, monkeypatch):
    """The reference's masked, scaled logits (the operand its
    ``categorical`` draws from) for ``params``."""
    seen = {}
    real_vmap = jax.vmap

    def spy(fn, *a, **kw):
        mapped = real_vmap(fn, *a, **kw)
        if fn is jax.random.categorical:
            def wrapped(keys, masked):
                seen["masked"] = np.asarray(masked)
                return mapped(keys, masked)
            return wrapped
        return mapped

    monkeypatch.setattr(jax, "vmap", spy)
    samp = jsampling.params_to_arrays(
        [JSamplingParams(temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
                         seed=p.seed) for p in params])
    jsampling.sample_tokens(jnp.asarray(logits), samp, jnp.asarray(pos))
    monkeypatch.setattr(jax, "vmap", real_vmap)
    return seen["masked"]


def _nucleus_edge(scaled, top_p):
    """Tokens whose nucleus decision rounding may settle: those whose value
    sits at a sorted position where the mass before it is within 4 float32
    ulps of ``top_p`` (computed in float64). The two stacks' ``exp`` and
    sums round differently, so only there may ``cum - p < top_p`` fall
    apart. At ``top_p = 1`` that is the low tail the reference's float32
    cumulative sum reaches 1.0 before (it drops some of it); below 1 the
    cases here have no such token."""
    edge = np.zeros(scaled.shape, bool)
    for b, row in enumerate(scaled.astype(np.float64)):
        srt = np.sort(row)[::-1]
        p = np.exp(srt - srt[0])
        p /= p.sum()
        before = np.cumsum(p) - p
        near = np.abs(before - top_p[b]) <= 4 * np.spacing(np.float32(top_p[b]))
        edge[b] = np.isin(row, srt[near])
    return edge


@pytest.mark.parametrize("kw,ties", [
    (dict(temperature=1.0), False),
    (dict(temperature=0.7, top_k=5), False),
    (dict(temperature=1.3, top_p=0.8), False),
    (dict(temperature=0.8, top_k=50, top_p=0.9), False),
    (dict(temperature=2.0, top_k=3, top_p=0.5), True),
    (dict(temperature=1.0, top_k=7), True),
], ids=["temp", "top_k", "top_p", "all", "ties-all", "ties-top_k"])
def test_scaled_logits_and_kept_set_bitwise_reference(kw, ties, monkeypatch):
    logits, pos = _case(b=6, v=64, seed=3, ties=ties)
    params = _params(6, **kw)
    want = _ref_masked(logits, params, pos, monkeypatch)
    scaled, keep = tsampling.scaled_and_kept(
        torch.from_numpy(logits), tsampling.params_to_arrays(params))
    scaled, keep = scaled.numpy(), keep.numpy()
    kept_ref = np.isfinite(want)
    edge = _nucleus_edge(scaled, [p.top_p for p in params])
    if kw.get("top_p", 1.0) < 1.0:
        assert not edge.any()  # bitwise, no exception
    np.testing.assert_array_equal(keep[~edge], kept_ref[~edge])
    # Scaled logits bit for bit wherever both keep a token.
    both = keep & kept_ref
    assert both.sum() >= 6 and np.array_equal(scaled[both], want[both])
    if edge.any():  # the reference's rounding-settled tail holds no mass
        z = scaled.astype(np.float64)
        mass = np.exp(z - z.max(1, keepdims=True))
        mass /= mass.sum(1, keepdims=True)
        assert mass[keep != kept_ref].sum() < 1e-5


def test_greedy_lanes_are_the_exact_argmax():
    logits, pos = _case(b=4)
    params = [SamplingParams(), SamplingParams(temperature=1.5, seed=9), SamplingParams(),
              SamplingParams(temperature=0.7, seed=9)]
    toks = tsampling.sample_tokens(torch.from_numpy(logits),
                                   tsampling.params_to_arrays(params), torch.from_numpy(pos))
    assert toks.dtype == torch.int32
    argmax = np.argmax(logits, -1)
    assert toks[0] == argmax[0] and toks[2] == argmax[2]
    greedy = tsampling.sample_tokens(torch.from_numpy(logits),
                                     tsampling.greedy_sampling_arrays(4), torch.from_numpy(pos))
    np.testing.assert_array_equal(greedy.numpy(), argmax)


def test_degenerate_limits_equal_argmax():
    """top_k = 1, top_p -> 0 and temperature -> 0 all reproduce the argmax
    (tests/test_sampling.py:79)."""
    logits, pos = _case()
    lg, p = torch.from_numpy(logits), torch.from_numpy(pos)
    argmax = np.argmax(logits, -1)
    for kw in (dict(temperature=1.0, top_k=1), dict(temperature=1.0, top_p=1e-9),
               dict(temperature=1e-4)):
        toks = tsampling.sample_tokens(lg, tsampling.params_to_arrays(_params(4, 7, **kw)), p)
        np.testing.assert_array_equal(toks.numpy(), argmax, err_msg=str(kw))


def test_every_draw_lies_in_the_kept_set():
    """Across many positions, sampled tokens stay in the reference's kept
    set (the top-k support check of tests/test_sampling.py:99, widened to
    the nucleus)."""
    logits, pos = _case(b=3, v=32, seed=1)
    params = _params(3, 11, temperature=2.0, top_k=6, top_p=0.9)
    samp = tsampling.params_to_arrays(params)
    _, keep = tsampling.scaled_and_kept(torch.from_numpy(logits), samp)
    for p0 in range(40):
        toks = tsampling.sample_tokens(torch.from_numpy(logits), samp,
                                       torch.from_numpy(pos + p0))
        for b in range(3):
            assert keep[b, toks[b]], (b, p0)


def test_draws_depend_on_seed_and_position_only():
    """Fixed seeds reproduce; a lane draws alike alone, in a batch and at
    another lane index; another position or seed draws anew."""
    logits, pos = _case(b=5, v=48, seed=2)
    params = _params(5, 100, temperature=1.2, top_k=20, top_p=0.95)
    lg, p = torch.from_numpy(logits), torch.from_numpy(pos)
    samp = tsampling.params_to_arrays(params)
    a = tsampling.sample_tokens(lg, samp, p)
    assert torch.equal(a, tsampling.sample_tokens(lg, samp, p))
    for i in range(5):
        solo = tsampling.sample_tokens(lg[i:i + 1], tsampling.params_to_arrays(params[i:i + 1]),
                                       p[i:i + 1])
        assert solo[0] == a[i]
    perm = [3, 0, 4, 1, 2]
    b = tsampling.sample_tokens(lg[perm], tsampling.params_to_arrays([params[i] for i in perm]),
                                p[perm])
    assert torch.equal(b, a[perm])
    u = tsampling.uniforms(samp["seed"], p, 48)
    assert not torch.equal(u, tsampling.uniforms(samp["seed"], p + 1, 48))
    assert not torch.equal(u, tsampling.uniforms(samp["seed"] + 1, p, 48))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


@pytest.mark.parametrize("over", ["seeds", "positions"])
def test_draw_frequencies_follow_the_masked_softmax(over):
    """4,000 draws from one row (over seeds at one position, or over
    positions of one seed): the chi-square statistic against the masked
    softmax of the scaled logits stays below its 0.999 quantile."""
    n, v = 4000, 12
    rng = np.random.RandomState(5)
    row = (rng.randn(v) * 1.5).astype(np.float32)
    sp = dict(temperature=1.3, top_k=9, top_p=0.97)
    logits = torch.from_numpy(np.repeat(row[None], n, 0))
    if over == "seeds":
        params, pos = _params(n, 0, **sp), torch.full((n,), 17, dtype=torch.int32)
    else:
        params, pos = [SamplingParams(**sp, seed=42)] * n, torch.arange(n, dtype=torch.int32)
    samp = tsampling.params_to_arrays(params)
    toks = tsampling.sample_tokens(logits, samp, pos).numpy()
    scaled, keep = tsampling.scaled_and_kept(logits[:1], samp)
    kept = keep[0].numpy()
    z = scaled[0].double().numpy()[kept]
    prob = np.exp(z - z.max())
    prob /= prob.sum()
    counts = np.bincount(toks, minlength=v)
    assert counts[~kept].sum() == 0
    chi2 = float(((counts[kept] - n * prob) ** 2 / (n * prob)).sum())
    assert chi2 < sps.chi2.ppf(0.999, kept.sum() - 1), (chi2, counts[kept], n * prob)


# ---------------------------------------------------------------------------
# The engine (tests/test_sampling.py:123-312)


def _reqs(rng, vocab, lengths, max_new=6, sampling=None):
    return [Request(uid=i, prompt=rng.integers(0, vocab, n).tolist(), max_new_tokens=max_new,
                    sampling=sampling) for i, n in enumerate(lengths)]


@pytest.mark.parametrize("matmul_mode", ["dequant", "w8a8"])
def test_fixed_seed_reproducible_in_any_submission_order(port_smoke, matmul_mode):
    cfg, q = port_smoke
    sp = SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=123)

    def run(reverse):
        reqs = _reqs(np.random.default_rng(11), cfg.vocab, [5, 11, 3], 6, sp)
        return serve(cfg, q, reqs[::-1] if reverse else reqs, max_batch=2, max_len=64,
                     matmul_mode=matmul_mode)[1]

    a = run(False)
    assert a == run(False), "fixed-seed sampling must reproduce"
    assert a == run(True), "submission order must not change a request's draws"


def test_sampled_request_identical_solo_or_batched(port_smoke):
    cfg, q = port_smoke
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, 6).tolist()
    sp = SamplingParams(temperature=1.1, top_k=0, top_p=0.9, seed=5)
    _, solo = serve(cfg, q, [Request(uid=0, prompt=list(prompt), max_new_tokens=5,
                                     sampling=sp)], max_batch=1, max_len=64)
    neighbours = _reqs(np.random.default_rng(8), cfg.vocab, [4, 9], 5,
                       SamplingParams(temperature=0.8, seed=99))
    for i, r in enumerate(neighbours):
        r.uid = 10 + i
    _, batched = serve(cfg, q, neighbours + [Request(uid=0, prompt=list(prompt),
                                                     max_new_tokens=5, sampling=sp)],
                       max_batch=3, max_len=64)
    assert batched[0] == solo[0]


def test_temperature_to_zero_converges_to_greedy(port_smoke):
    cfg, q = port_smoke
    lengths = [5, 9]
    _, greedy = serve(cfg, q, _reqs(np.random.default_rng(2), cfg.vocab, lengths),
                      max_batch=2, max_len=64)
    for temp in (0.0, 1e-4):
        sp = SamplingParams(temperature=temp, seed=7)
        _, out = serve(cfg, q, _reqs(np.random.default_rng(2), cfg.vocab, lengths,
                                     sampling=sp), max_batch=2, max_len=64)
        assert out == greedy, f"temperature={temp} must reproduce argmax"


def test_mixed_batch_greedy_lane_is_exact(port_smoke):
    cfg, q = port_smoke
    rng = np.random.default_rng(13)
    gprompt = rng.integers(0, cfg.vocab, 7).tolist()
    _, solo = serve(cfg, q, [Request(uid=0, prompt=list(gprompt), max_new_tokens=6)],
                    max_batch=1, max_len=64)
    sp = SamplingParams(temperature=1.3, seed=3)
    mixed = [Request(uid=0, prompt=list(gprompt), max_new_tokens=6)]
    mixed += [Request(uid=1 + i, prompt=rng.integers(0, cfg.vocab, 5).tolist(),
                      max_new_tokens=6, sampling=sp) for i in range(2)]
    _, out = serve(cfg, q, mixed, max_batch=3, max_len=64)
    assert out[0] == solo[0]


def test_greedy_steps_never_reach_the_sampler(port_smoke, monkeypatch):
    """A greedy-only workload never calls ``sample_tokens``; one sampled
    request brings it in for its prefill and its steps only."""
    cfg, q = port_smoke
    calls = []
    real = tsampling.sample_tokens
    monkeypatch.setattr(tsampling, "sample_tokens",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    serve(cfg, q, _reqs(np.random.default_rng(1), cfg.vocab, [5, 9], 4), max_batch=2,
          max_len=64)
    assert calls == []
    reqs = _reqs(np.random.default_rng(1), cfg.vocab, [5, 9], 4)
    reqs[1].sampling = SamplingParams(temperature=1.0, seed=1)
    reqs[1].max_new_tokens = 2
    serve(cfg, q, reqs, max_batch=2, max_len=64)
    assert calls == [1, 2]  # its prefill (one row), then one decode step of both lanes


def test_spec_engine_sampled_fallback_matches_plain(port_smoke):
    cfg, q = port_smoke
    sp = SamplingParams(temperature=0.8, top_k=30, seed=21)

    def run(spec):
        return serve(cfg, q, _reqs(np.random.default_rng(4), cfg.vocab, [5, 8], 5, sp),
                     max_batch=2, max_len=32, spec=spec)

    _, plain = run(None)
    eng, specd = run(SpecConfig(k=3))
    assert specd == plain  # the fallback is the ordinary sampled decode
    assert eng.stats()["spec_rounds"] == 0


def test_spec_engine_still_speculates_greedy_workloads(port_smoke):
    cfg, q = port_smoke
    eng, out = serve(cfg, q, _reqs(np.random.default_rng(6), cfg.vocab, [5, 9], 6),
                     max_batch=2, max_len=32, spec=SpecConfig(k=2))
    _, plain = serve(cfg, q, _reqs(np.random.default_rng(6), cfg.vocab, [5, 9], 6),
                     max_batch=2, max_len=32)
    assert out == plain
    assert eng.stats()["spec_rounds"] > 0


def test_spec_engine_mixed_greedy_sampled_batch(port_smoke):
    """Greedy requests keep their exact stream when a sampled neighbour
    forces plain rounds mid-flight; rounds speculate again after it."""
    cfg, q = port_smoke
    rng = np.random.default_rng(9)
    gprompt = rng.integers(0, cfg.vocab, 6).tolist()
    _, solo = serve(cfg, q, [Request(uid=0, prompt=list(gprompt), max_new_tokens=6)],
                    max_batch=1, max_len=32, spec=SpecConfig(k=2))
    mixed = [
        Request(uid=0, prompt=list(gprompt), max_new_tokens=6),
        Request(uid=1, prompt=rng.integers(0, cfg.vocab, 4).tolist(), max_new_tokens=3,
                sampling=SamplingParams(temperature=1.0, seed=17)),
    ]
    eng, out = serve(cfg, q, mixed, max_batch=2, max_len=32, spec=SpecConfig(k=2))
    assert out[0] == solo[0]
    assert eng.stats()["spec_rounds"] > 0


def _alloc_state(eng):
    a = eng.allocator
    return (a.in_use(), a.available(), a.cached_pages())


def test_cancel_mid_decode_reclaims_lane(port_smoke):
    cfg, q = port_smoke
    rng = np.random.default_rng(3)
    # Short prompts (< page_size): no full prompt pages get registered, so
    # allocator parity is exact across every counter.
    victim = Request(uid=0, prompt=rng.integers(0, cfg.vocab, 5).tolist(), max_new_tokens=40)
    other_prompt = rng.integers(0, cfg.vocab, 7).tolist()
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=2, max_len=64), device="cpu")
    eng.submit(victim)
    eng.submit(Request(uid=1, prompt=list(other_prompt), max_new_tokens=6))
    for _ in range(3):
        eng.step()
    assert 0 < len(victim.output) < 40  # genuinely mid-decode
    assert eng.cancel(0)
    assert victim.finish_reason == "cancelled"
    eng.run()
    ref, _ = serve(cfg, q, [Request(uid=1, prompt=list(other_prompt), max_new_tokens=6)],
                   max_batch=2, max_len=64)
    out = {r.uid: r.output for r in eng.done}
    assert out[1] == ref.done[0].output  # the survivor's stream is untouched
    assert all(s.req is None for s in eng.slots)
    assert _alloc_state(eng) == _alloc_state(ref)
    assert eng.stats()["kv_pages_in_use"] == 0.0
    assert (eng.caches["table"] == 0).all()
    s = eng.stats()
    assert s["cancelled"] == 1 and s["completed"] == 1


def test_cancel_inside_generate_stream(port_smoke):
    cfg, q = port_smoke
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64), device="cpu")
    events = []
    uid = None
    for ev in eng.generate([1, 2, 3, 4], max_new_tokens=30):
        events.append(ev)
        uid = ev.uid
        if ev.index == 2:
            assert eng.cancel(uid)
    assert len(events) == 3  # the stream stopped right at the cancel
    cancelled = next(r for r in eng.done if r.uid == uid)
    assert cancelled.finish_reason == "cancelled"
    assert eng.stats()["kv_pages_in_use"] == 0.0
    assert eng.stats()["cancelled"] == 1


# ---------------------------------------------------------------------------
# Streaming (tests/test_engine_api.py:291-353)


def test_generate_streams_before_batch_completion(port_smoke):
    cfg, q = port_smoke
    rng = np.random.default_rng(5)
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=3, max_len=64), device="cpu")
    for i in range(2):  # background traffic with a bigger budget
        eng.submit(Request(uid=100 + i, prompt=rng.integers(0, cfg.vocab, 6).tolist(),
                           max_new_tokens=12))
    events = []
    for ev in eng.generate(rng.integers(0, cfg.vocab, 5).tolist(), max_new_tokens=4):
        assert isinstance(ev, TokenEvent)
        if ev.index == 0:
            assert any(s.req is not None for s in eng.slots)  # the batch is mid-flight
        events.append(ev)
    assert [e.index for e in events] == [0, 1, 2, 3]
    assert events[-1].finished and events[-1].finish_reason == "length"
    assert all(not e.finished for e in events[:-1])
    ts = [e.t for e in events]
    assert ts == sorted(ts)
    assert events[0].uid == 102  # auto uids start past the submitted ones
    assert len(eng.run()) == 3  # the background requests still completed


def test_generate_eos_finish_reason(port_smoke):
    cfg, q = port_smoke
    prompt = [3, 1, 4, 1, 5]
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64), device="cpu")
    ref = list(eng.generate(list(prompt), max_new_tokens=6))
    eos = ref[2].token  # eos at (the latest) the third generated token
    eng2 = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64), device="cpu")
    evs = list(eng2.generate(list(prompt), max_new_tokens=6, eos_id=eos))
    n = len(evs)  # eos may match an earlier token too
    assert [e.token for e in evs] == [e.token for e in ref[:n]]
    assert evs[-1].token == eos
    assert evs[-1].finished and evs[-1].finish_reason == "eos"


def test_cancel_queued_request(port_smoke):
    cfg, q = port_smoke
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64), device="cpu")
    r0 = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4)
    r1 = Request(uid=1, prompt=[4, 5, 6], max_new_tokens=4)
    eng.submit(r0)
    eng.submit(r1)
    assert eng.cancel(1)  # still queued: removed before taking a lane
    assert not eng.cancel(42)
    done = eng.run()
    assert {r.uid for r in done} == {0, 1}
    assert r1.finish_reason == "cancelled" and r1.output == []
    s = eng.stats()
    assert s["completed"] == 1 and s["cancelled"] == 1


def test_sampling_params_validate():
    with pytest.raises(ValueError, match="temperature"):
        SamplingParams(temperature=-1.0)
    with pytest.raises(ValueError, match="top_k"):
        SamplingParams(top_k=-1)
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(top_p=0.0)
    assert SamplingParams().greedy and not SamplingParams(temperature=0.5).greedy
    eng = ServingEngine(*_tiny(), EngineConfig(max_batch=1, max_len=32), device="cpu")
    with pytest.raises(TypeError, match="SamplingParams"):
        eng.submit(Request(uid=0, prompt=[1, 2], sampling={"temperature": 1.0}))


def _tiny():
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T

    cfg = smoke_config("glm4-9b")
    return cfg, T.init_params(cfg, seed=0, device="cpu")
