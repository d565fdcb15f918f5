"""Port parity, the step scheduler and budgeted chunked prefill:
``repro_torch.serving.scheduler.StepScheduler`` against the reference's on
the same inputs, chunked prefill against one-call prefill and against the
reference's chunks, the port's chunked engine against the reference's
configured alike, and the reference's scheduler tests
(``tests/test_scheduler.py:121-300``) on the port.

Chunked and one-call prefill are not bitwise: the prefill attention's key
chunk follows the call's key count, so a query row sums in another order
(``models/attention.py``, ``_pick_chunk``), and a float32 ulp now and then
flips a bf16 activation. Teacher-forced last-token logits are held within
the model test's tolerances, relative to the largest logit
(``tests/test_torch_model.py``: ``DEQUANT_RTOL`` 0.02, ``W8A8_RTOL``
0.06; observed 0.8% and 3.0% at this size); greedy token streams are held
up to a near-tie (``_torch_lifecycle.TIE_TOL``). The port's chunks are
bitwise the reference's chunks in ``dequant`` (the same numerics per
call).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_interop import glm_smoke, glm_smoke_served, torch_threads  # noqa: F401
from _torch_lifecycle import (  # noqa: F401
    assert_held, port_smoke, port_top2_margin, prompts_of, ref_top2_margin, serve, serve_both)

from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import kv_cache as jkvc
from repro.serving.scheduler import StepScheduler as JScheduler

from repro_torch.models import transformer as T
from repro_torch.serving import (
    EngineConfig, EngineOverloaded, Request, ServingEngine, StepScheduler)
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving.spec_decode import SpecConfig

RTOL = {"dequant": 0.02, "w8a8": 0.06}  # tests/test_torch_model.py


def _req(uid, n):
    return SimpleNamespace(uid=uid, prompt=[0] * n)


# ---------------------------------------------------------------------------
# StepScheduler against the reference's


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=200), min_size=0, max_size=10),
       st.integers(min_value=1, max_value=8),
       st.sampled_from(["fifo", "sjf"]),
       st.lists(st.integers(min_value=0, max_value=3), min_size=1, max_size=12),
       st.sets(st.integers(min_value=0, max_value=9)))
def test_order_queue_matches_reference(lengths, aging, policy, step_gaps, resumes):
    """A queue drained one admission per call over a run of engine steps
    (with a fresh arrival now and then): the same order and counters at
    every call."""
    t, j = StepScheduler(policy=policy, aging_steps=aging), JScheduler(policy=policy,
                                                                      aging_steps=aging)
    queue = [_req(i, n) for i, n in enumerate(lengths)]
    is_resume = lambda r: r.uid in resumes  # noqa: E731
    step, uid = 0, len(queue)
    for gap in step_gaps:
        step += gap
        if gap == 2:
            queue.append(_req(uid, 1 + uid % 7))
            uid += 1
        a = t.order_queue(list(queue), step, is_resume)
        b = j.order_queue(list(queue), step, is_resume)
        assert [r.uid for r in a] == [r.uid for r in b]
        assert t.aging_promotions == j.aging_promotions
        if a and gap != 1:
            queue.remove(a[0])
            t.note_admitted(a[0].uid)
            j.note_admitted(a[0].uid)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(min_value=1, max_value=300),
                          st.integers(min_value=0, max_value=50)), min_size=0, max_size=8),
       st.integers(min_value=1, max_value=64),
       st.integers(min_value=1, max_value=256),
       st.sampled_from(["fifo", "sjf"]))
def test_plan_chunks_matches_reference(lanes, chunk, budget, policy):
    budget = max(budget, chunk)  # config guarantees budget >= chunk_size
    t = StepScheduler(policy=policy, prefill_budget=budget, chunk_size=chunk)
    j = JScheduler(policy=policy, prefill_budget=budget, chunk_size=chunk)
    lanes = [(i, rem, seq) for i, (rem, seq) in enumerate(lanes)]
    for _ in range(2):
        assert t.plan_chunks(lanes) == j.plan_chunks(lanes)
    assert (t.chunks, t.budget_limited_steps, t.peak_step_tokens) == (
        j.chunks, j.budget_limited_steps, j.peak_step_tokens)


def test_order_queue_fifo_matches_arrival_order():
    sched = StepScheduler(policy="fifo", aging_steps=4)
    q = [_req(i, n) for i, n in enumerate((9, 1, 5))]
    assert sched.order_queue(q, 0, lambda r: False) == q
    assert sched.order_queue(q, 0, lambda r: r.uid == 2)[0] is q[2]  # resumes first


def test_order_queue_sjf_shortest_first_then_aged_fifo():
    sched = StepScheduler(policy="sjf", aging_steps=3)
    q = [_req(i, n) for i, n in enumerate((9, 1, 5))]
    assert [r.uid for r in sched.order_queue(q, 0, lambda r: False)] == [1, 2, 0]
    assert [r.uid for r in sched.order_queue(q, 3, lambda r: False)] == [0, 1, 2]


def test_plan_chunks_drains_head_first():
    sched = StepScheduler(policy="fifo", prefill_budget=32, chunk_size=8)
    assert sched.plan_chunks([(0, 20, 0), (1, 20, 1)]) == [(0, 8), (0, 8), (0, 4), (1, 8)]
    assert sched.budget_limited_steps == 1
    assert sched.peak_step_tokens == 28


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=200), min_size=0, max_size=10),
       st.integers(min_value=1, max_value=64),
       st.integers(min_value=1, max_value=256),
       st.sampled_from(["fifo", "sjf"]))
def test_property_plan_never_exceeds_budget(remainings, chunk, budget, policy):
    budget = max(budget, chunk)
    sched = StepScheduler(policy=policy, prefill_budget=budget, chunk_size=chunk)
    plan = sched.plan_chunks([(i, r, i) for i, r in enumerate(remainings)])
    assert sum(g for _, g in plan) <= budget
    assert all(0 < g <= chunk for _, g in plan)
    granted = {}
    for s, g in plan:
        granted[s] = granted.get(s, 0) + g
    for i, r in enumerate(remainings):
        assert granted.get(i, 0) <= r
    assert sched.peak_step_tokens <= budget
    if remainings:
        assert plan, "budget >= chunk_size guarantees progress"


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=1, max_value=30), st.integers(min_value=2, max_value=50))
def test_property_aging_bounds_starvation(aging, long_len):
    """A long prompt with a fresh shorter rival every step is admitted
    within aging_steps + 1 under sjf, and the promotion is counted."""
    sched = StepScheduler(policy="sjf", aging_steps=aging, prefill_budget=8, chunk_size=8)
    long_req = _req(-1, long_len)
    queue = [long_req]
    admitted = None
    for step in range(aging + 10):
        queue.append(_req(step, 1))
        head = sched.order_queue(list(queue), step, lambda r: False)[0]
        queue.remove(head)
        sched.note_admitted(head.uid)
        if head is long_req:
            admitted = step
            break
    assert admitted is not None and admitted <= aging + 1
    assert sched.aging_promotions >= 1


# ---------------------------------------------------------------------------
# Chunked prefill at the model level


def _port_prefill(cfg, qt, toks, chunk, mode, ps=8):
    """Prefill ``toks`` into fresh float32 pages in chunks of ``chunk``
    tokens (each reading the earlier pages as its prefix); the last
    chunk's logits."""
    n = len(toks)
    nb = -(-n // ps) + 8
    pools = [layer["attn"] for layer in
             tkvc.init_paged_cache(cfg, 1, nb + 1, ps, nb, device="cpu")["layers"]]
    start = 0
    while start < n:
        g = min(chunk, n - start)
        b = max(8, ps)
        while b < g:
            b *= 2
        p0 = start // ps
        t = torch.zeros((1, b), dtype=torch.int64)
        t[0, :g] = torch.tensor(toks[start:start + g])
        with torch.no_grad():
            lg, pools = T.prefill_into_pages(
                qt, t, cfg, pools, torch.arange(1 + p0, 1 + p0 + b // ps, dtype=torch.int32),
                length=torch.tensor([g], dtype=torch.int32),
                prefix_ids=torch.arange(1, 1 + p0, dtype=torch.int32), mode=mode)
        start += g
    return lg[0].float().numpy()


def _ref_prefill(cfg, qj, toks, chunk, mode, ps=8):
    n = len(toks)
    nb = -(-n // ps) + 8
    pools = [layer["attn"] for layer in
             jkvc.init_paged_cache(cfg, 1, nb + 1, ps, nb, dtype=jnp.float32)["layers"]]
    start = 0
    while start < n:
        g = min(chunk, n - start)
        b = max(8, ps)
        while b < g:
            b *= 2
        p0 = start // ps
        t = np.zeros((1, b), np.int32)
        t[0, :g] = toks[start:start + g]
        with JL.serving_mode(mode, kernel="pallas" if mode == "dequant" else "xla"):
            lg, pools = JT.prefill_into_pages(
                qj, jnp.asarray(t), cfg, pools, jnp.arange(1 + p0, 1 + p0 + b // ps,
                                                           dtype=jnp.int32),
                length=jnp.asarray([g], jnp.int32),
                prefix_ids=jnp.arange(1, 1 + p0, dtype=jnp.int32))
        start += g
    return np.asarray(lg[0].astype(jnp.float32))


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_chunked_prefill_logits_hold(glm_smoke, glm_smoke_served, mode):
    """40- and 57-token prompts in 16-token chunks: the last logits within
    ``RTOL`` of one-call prefill's; the 40-token one also within it of the
    reference's own chunks, and in ``dequant`` bitwise them."""
    cfg = glm_smoke[0]
    qj, qt = glm_smoke_served
    rng = np.random.default_rng(0)
    for n in (40, 57):
        toks = rng.integers(0, cfg.vocab, n).tolist()
        mono = _port_prefill(cfg, qt, toks, 1000, mode)
        chunked = _port_prefill(cfg, qt, toks, 16, mode)
        scale = np.abs(mono).max()
        assert np.abs(chunked - mono).max() <= RTOL[mode] * scale
        if n == 40:
            ref_chunked = _ref_prefill(cfg, qj, toks, 16, mode)
            assert np.abs(chunked - ref_chunked).max() <= RTOL[mode] * scale
            if mode == "dequant":
                np.testing.assert_array_equal(chunked, ref_chunked)


# ---------------------------------------------------------------------------
# The engine against the reference's, configured alike


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_chunked_engine_matches_reference(glm_smoke, glm_smoke_served, mode):
    """``prefill_budget=16, chunk_size=16, sched_policy="sjf"`` on float32
    pages: the same step results and allocator state (by page id) as the
    reference's engine after every step, the same chunk counters, and
    greedy tokens up to the reference's near-ties."""
    cfg = glm_smoke[0]
    qj, qt = glm_smoke_served
    prompts = prompts_of(np.random.default_rng(7), cfg.vocab, (40, 7, 5, 23))
    prompts.append(prompts[0][:16] + [3, 4])  # hits the first prompt's two pages
    conf = dict(max_batch=3, max_len=96, page_size=8, matmul_mode=mode,
                prefill_budget=16, chunk_size=16, sched_policy="sjf")
    je, te, out_j, out_t = serve_both(cfg, qj, qt, conf, prompts)
    sj, stt = je.stats(), te.stats()
    for key in ("sched_chunks", "sched_budget_limited_steps", "sched_peak_step_prefill_tokens",
                "prefix_hit_pages", "decode_steps", "completed"):
        assert stt[key] == sj[key], key
    assert stt["sched_chunks"] >= 3 + 1 + 1 + 2 + 1
    assert_held(out_t, out_j, dict(enumerate(prompts)), ref_top2_margin(cfg, je.params, mode))


# ---------------------------------------------------------------------------
# The reference's scheduler tests on the port (tests/test_scheduler.py)


@pytest.mark.parametrize("spec", [None, SpecConfig(k=3)], ids=["None", "spec1"])
def test_chunked_prefill_matches_monolithic(port_smoke, spec):
    """A 40-token prompt runs as 3 chunks interleaved with two short lanes;
    tokens equal the monolithic engine's up to its near-ties, spec on and
    off (speculation pauses while a lane is mid-prefill, then resumes)."""
    cfg, q = port_smoke
    prompts = prompts_of(np.random.default_rng(7), cfg.vocab, (40, 7, 5))

    def reqs():
        return [Request(uid=i, prompt=list(p), max_new_tokens=12) for i, p in enumerate(prompts)]

    conf = dict(max_batch=3, max_len=96, page_size=8, spec=spec)
    _, oracle = serve(cfg, q, reqs(), **conf)
    eng, got = serve(cfg, q, reqs(), prefill_budget=16, chunk_size=16, sched_policy="sjf",
                     **conf)
    assert_held(got, oracle, dict(enumerate(prompts)),
                lambda toks: port_top2_margin(cfg, q, toks))
    s = eng.stats()
    assert s["sched_chunks"] >= 3
    assert s["sched_peak_step_prefill_tokens"] <= 16
    assert s["kv_pages_in_use"] == 0.0
    if spec is not None:
        assert s["spec_rounds"] > 0


def test_budget_zero_keeps_monolithic_prefill(port_smoke):
    cfg, q = port_smoke
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).tolist(), max_new_tokens=4)
            for i, n in enumerate((20, 6))]
    eng, _ = serve(cfg, q, reqs, max_batch=2, max_len=64)
    s = eng.stats()
    assert s["sched_chunks"] == 0.0
    assert s["sched_prefill_budget"] == 0.0
    assert s["prefill_calls_per_request"] == 1.0


def test_sched_counters_and_queue_wait_stats(port_smoke):
    cfg, q = port_smoke
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).tolist(), max_new_tokens=4)
            for i, n in enumerate((20, 6, 5))]
    eng, _ = serve(cfg, q, reqs, max_batch=2, max_len=64, page_size=8, prefill_budget=8,
                   chunk_size=8, sched_policy="sjf")
    s = eng.stats()
    assert s["sched_policy"] == "sjf"
    assert s["sched_prefill_budget"] == 8.0
    assert s["sched_chunks"] >= 3  # the 20-token prompt alone needs 3
    assert 0 < s["sched_peak_step_prefill_tokens"] <= 8
    assert s["prefill_calls"] == s["sched_chunks"]  # every chunk is one prefill call
    assert s["queue_wait_p50_s"] >= 0.0
    assert s["queue_wait_p95_s"] >= s["queue_wait_p50_s"]


def test_mid_prefill_preemption_resumes(port_smoke):
    """A lane preempted halfway through its chunked prefill (optimistic
    admission, a small pool) requeues with no output, resumes off its
    registered prompt pages, and matches the uncontended monolithic engine
    up to its near-ties."""
    cfg, q = port_smoke
    rng = np.random.default_rng(17)
    # The short one fills page 1 exactly, so its 2-page optimistic grant
    # runs dry after 8 decode tokens, while the 88-token long one is still
    # mid-prefill (11 chunks of 8): the short one's growth must evict it.
    short = rng.integers(0, cfg.vocab, 8).tolist()
    long = rng.integers(0, cfg.vocab, 88).tolist()

    def reqs():
        return [Request(uid=0, prompt=list(short), max_new_tokens=24),
                Request(uid=1, prompt=list(long), max_new_tokens=6)]

    _, oracle = serve(cfg, q, reqs(), max_batch=2, max_len=96, page_size=8)
    eng = ServingEngine(cfg, q, EngineConfig(
        max_batch=2, max_len=96, page_size=8, n_pages=15, admission="optimistic",
        admission_headroom=1, prefill_budget=8, chunk_size=8, sched_policy="fifo"),
        device="cpu")
    rs = reqs()
    for r in rs:
        eng.submit(r)
    saw_mid_prefill_victim = False
    while eng.queue or any(s.req for s in eng.slots):
        eng.step()
        if eng.preempted and any(r.uid == 1 and not r.output for r in eng.queue):
            saw_mid_prefill_victim = True
    assert eng.preempted > 0
    assert saw_mid_prefill_victim
    assert eng.allocator.prefix_hit_pages > 0  # the resume took its chunks' pages back
    got = {r.uid: (r.finish_reason, list(r.output)) for r in rs}
    assert_held(got, oracle, {0: short, 1: long}, lambda toks: port_top2_margin(cfg, q, toks))
    assert eng.stats()["kv_pages_in_use"] == 0.0


@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=5), min_size=1, max_size=18))
def test_property_chunked_lifecycle_never_leaks_pages(ops):
    """Random submit / step / cancel / deadline interleavings with chunking
    on (lanes can be preempted mid-prefill) keep ``in_use + available ==
    capacity`` at every point and drain to zero. A forced expiry sets a
    deadline already past."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as TT

    cfg = smoke_config("glm4-9b")
    params = _PARAMS.setdefault("p", TT.init_params(cfg, seed=0, device="cpu"))
    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=2, max_len=64, page_size=8, n_pages=7, admission="optimistic",
        max_queue=4, prefill_budget=8, chunk_size=8, sched_policy="sjf",
        sched_aging_steps=4), device="cpu")
    rng = np.random.default_rng(sum(ops) + len(ops))
    uid = 0
    live = []
    for op in ops:
        if op in (0, 1):  # submit (short / long enough to chunk)
            r = Request(uid=uid, prompt=rng.integers(0, cfg.vocab, 3 + op * 17).tolist(),
                        max_new_tokens=4 + op * 12)
            uid += 1
            try:
                eng.submit(r)
                live.append(r)
            except EngineOverloaded:
                assert r.finish_reason == "shed"
        elif op == 2 and live:
            eng.cancel(live[rng.integers(0, len(live))].uid)
        elif op == 3 and live:
            live[rng.integers(0, len(live))].deadline_s = -1.0
        else:
            eng.step()
        a = eng.allocator
        assert a.in_use() + a.available() == a.capacity
        live = [r for r in live if r.t_done == 0.0]
    eng.run()
    a = eng.allocator
    assert a.in_use() == 0
    assert a.in_use() + a.available() == a.capacity


_PARAMS = {}


def test_chunk_config_validation():
    with pytest.raises(ValueError, match="prefill_budget must be >= chunk_size"):
        EngineConfig(prefill_budget=32, chunk_size=64)
    with pytest.raises(ValueError, match="multiple of page_size"):
        EngineConfig(prefill_budget=64, chunk_size=24, page_size=16)
    with pytest.raises(ValueError, match="sched_policy"):
        EngineConfig(sched_policy="lifo")
    with pytest.raises(ValueError, match="sched_aging_steps"):
        EngineConfig(sched_aging_steps=0)
    EngineConfig(chunk_size=24, page_size=16)  # unused without a budget
