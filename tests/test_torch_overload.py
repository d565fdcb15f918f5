"""Port parity, overload: optimistic admission with preemption and resume,
deadlines, the bounded queue and the serving watchdog of
``repro_torch.serving.engine``, against the reference's engine configured
alike and under the reference's overload tests (``tests/test_overload.py:
111-435``, without fault injection and the kernel fallback, which the port
does not have).

A resume re-prefills only the prompt past its prefix hits and replays the
committed output tokens through the decode path, as the reference does, so
a resumed lane's K/V rows and greedy tokens are bitwise the uncontended
run's. Against the reference's engine, tokens are held up to the
reference's near-ties (``_torch_lifecycle.TIE_TOL``): the two packages sum
in different orders. Deadlines in these tests are already past when they
are checked, so no test depends on the machine's speed.
"""
import numpy as np
import pytest
import torch

from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_interop import glm_smoke, glm_smoke_served, torch_threads  # noqa: F401
from _torch_lifecycle import (  # noqa: F401
    assert_held, port_smoke, prompts_of, ref_top2_margin, serve, serve_both)

from repro.runtime import health as jhealth
from repro.serving import PageAllocator as JAllocator

from repro_torch.runtime import health as thealth
from repro_torch.serving import (
    FINISH_REASONS, EngineConfig, EngineOverloaded, PageAllocator, Request, ServingEngine,
    pages_needed)
from repro_torch.serving.spec_decode import SpecConfig


def _alloc_state(eng):
    a = eng.allocator
    return (a.in_use(), a.available(), a.cached_pages())


# ---------------------------------------------------------------------------
# Preemption and resume


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_optimistic_engine_matches_reference(glm_smoke, glm_smoke_served, mode):
    """A pool of 9 pages against a worst case of 3 lanes x 4 pages: the
    same preemptions, step results and allocator state (by page id) as the
    reference's engine after every step, and greedy tokens up to the
    reference's near-ties."""
    cfg = glm_smoke[0]
    qj, qt = glm_smoke_served
    prompts = prompts_of(np.random.default_rng(7), cfg.vocab, (7, 5, 3))
    conf = dict(max_batch=3, max_len=96, page_size=8, n_pages=9, admission="optimistic",
                matmul_mode=mode)
    je, te, out_j, out_t = serve_both(cfg, qj, qt, conf, prompts, max_new=20)
    assert te.stats()["preempted"] == je.stats()["preempted"] > 0
    assert te.stats()["kv_pages_in_use"] == 0.0
    assert_held(out_t, out_j, dict(enumerate(prompts)), ref_top2_margin(cfg, je.params, mode))


@pytest.mark.parametrize("spec", [None, SpecConfig(k=3)], ids=["None", "spec1"])
def test_preemption_matches_uncontended(port_smoke, spec):
    """A small pool forces mid-decode preemption under optimistic admission;
    every preempted and resumed greedy stream equals the uncontended
    engine's token for token, every request ends eos/length and every page
    comes back."""
    cfg, q = port_smoke
    prompts = prompts_of(np.random.default_rng(7), cfg.vocab, (7, 5, 3))

    def reqs():
        return [Request(uid=i, prompt=list(p), max_new_tokens=20) for i, p in enumerate(prompts)]

    _, oracle = serve(cfg, q, reqs(), max_batch=3, max_len=96, page_size=8, spec=spec)
    eng, got = serve(cfg, q, reqs(), max_batch=3, max_len=96, page_size=8, n_pages=9,
                     admission="optimistic", spec=spec)
    s = eng.stats()
    assert s["preempted"] > 0
    assert got == oracle
    assert all(r[0] in ("eos", "length") for r in got.values())
    assert s["kv_pages_in_use"] == 0.0
    # A resume makes at most one prefill call, over the prompt past its
    # hits only (none when the hits cover the prompt), and replays the
    # decoded tokens through the decode path.
    assert s["prefill_calls"] <= 3 + s["preempted"]
    assert s["prefill_tokens"] - sum(map(len, prompts)) <= s["preempted"] * max(map(len, prompts))
    assert eng.replay_lengths and all(n >= 1 for n in eng.replay_lengths)


def _lane_rows(eng, slot_idx, n_rows):
    """Every layer's pool rows (K, V and any row scales) at positions
    ``0 .. n_rows - 1`` of lane ``slot_idx``, gathered through its table
    row."""
    ps = eng.page_size
    pos = np.arange(n_rows)
    page = eng.caches["table"][slot_idx].long()[pos // ps]
    row = torch.as_tensor(pos % ps)
    return [{key: t[page, :, row].clone() for key, t in layer["attn"].items()}
            for layer in eng.caches["layers"]]


@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["float32", "int8", "int4"])
def test_resumed_lane_kv_rows_bitwise(port_smoke, kv_bits):
    """A preempted and resumed lane's K/V rows, gathered through its table
    row, are bitwise the uncontended run's at every committed position, in
    every pool kind: the prompt rows re-prefilled as a fresh install writes
    them, the decoded rows replayed through the decode path as the decode
    steps wrote them. Each request is read one step before its last."""
    cfg, q = port_smoke
    prompts = prompts_of(np.random.default_rng(7), cfg.vocab, (7, 5, 3))
    max_new = 20
    mode = "w4a8" if kv_bits == 4 else "dequant"

    def rows_by_uid(**conf):
        eng = ServingEngine(cfg, q, EngineConfig(max_batch=3, max_len=96, page_size=8,
                                                 kv_bits=kv_bits, matmul_mode=mode,
                                                 trace=True, **conf), device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=max_new))
        got = {}
        while eng.step() or eng.queue:
            for i, slot in enumerate(eng.slots):
                r = slot.req
                if r is not None and not slot.prefilling and len(r.output) == max_new - 1 \
                        and r.uid not in got:
                    got[r.uid] = _lane_rows(eng, i, len(r.prompt) + len(r.output) - 1)
        return eng, got

    _, want = rows_by_uid()
    eng, got = rows_by_uid(n_pages=9, admission="optimistic")
    # At least one lane was preempted before it was read, then resumed.
    resumed = {e.track for e in eng.trace.events()
               if e.kind == "preempt" and e.args.get("committed", max_new) < max_new - 1}
    assert eng.preempted > 0 and resumed and eng.replay_lengths
    assert got.keys() == want.keys() == {0, 1, 2}
    for uid in want:
        for layer_got, layer_want in zip(got[uid], want[uid]):
            for key in layer_want:
                assert torch.equal(layer_got[key], layer_want[key]), (uid, key)


def test_preemption_evicts_youngest_and_requeues_head(port_smoke):
    cfg, q = port_smoke
    rng = np.random.default_rng(11)
    old = Request(uid=0, prompt=rng.integers(0, cfg.vocab, 8).tolist(), max_new_tokens=30)
    young = Request(uid=1, prompt=rng.integers(0, cfg.vocab, 8).tolist(), max_new_tokens=30)
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=2, max_len=96, page_size=8, n_pages=6,
                                             admission="optimistic", admission_headroom=1),
                        device="cpu")
    eng.submit(old)
    eng.submit(young)
    while eng.preempted == 0 and (eng.queue or any(s.req for s in eng.slots)):
        eng.step()
    assert eng.preempted > 0
    # The younger request was evicted mid-decode, keeping its output.
    assert eng.queue and eng.queue[0] is young and len(young.output) > 0
    assert old.finish_reason is None  # the oldest lane was never starved
    eng.run()
    assert old.finish_reason == "length" and young.finish_reason == "length"
    assert len(young.output) == 30


def test_optimistic_admission_reserves_less(port_smoke):
    cfg, q = port_smoke
    req = Request(uid=0, prompt=list(range(1, 9)), max_new_tokens=64)
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=96, page_size=8,
                                             admission="optimistic", admission_headroom=1),
                        device="cpu")
    eng.submit(req)
    eng.step()
    # An 8-token prompt is 1 page, + 1 of headroom; reserve would take 9.
    assert len(eng.slots[0].pages) == 2
    eng.run()
    assert req.finish_reason == "length" and len(req.output) == 64


# ---------------------------------------------------------------------------
# Deadlines and the bounded queue


def test_deadline_sheds_queued_request(port_smoke):
    cfg, q = port_smoke
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64), device="cpu")
    r = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4, deadline_s=-1.0)
    eng.submit(r)
    events = list(eng.stream(r))
    assert r.finish_reason == "timeout" and r.t_done > 0.0 and r.output == []
    # The sentinel event: a streaming caller never hangs on a shed request.
    assert len(events) == 1 and events[-1].finished
    assert events[-1].finish_reason == "timeout" and events[-1].token == -1
    assert eng.stats()["timed_out"] == 1 and eng.stats()["completed"] == 0


def test_deadline_retires_active_lane_mid_decode(port_smoke):
    cfg, q = port_smoke
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64), device="cpu")
    r = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=10_000)
    eng.submit(r)
    eng.step()
    eng.step()  # admitted and decoding
    n = len(r.output)
    r.deadline_s = -1.0
    eng.step()
    assert r.finish_reason == "timeout"
    assert len(r.output) == n >= 2  # the partial output survives
    assert eng.stats()["kv_pages_in_use"] == 0.0
    assert eng.stats()["timed_out"] == 1


def test_bounded_queue_sheds_with_typed_error(port_smoke):
    cfg, q = port_smoke
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64, max_queue=1),
                        device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=6))
    eng.step()  # uid 0 takes the lane
    eng.submit(Request(uid=1, prompt=[4, 5, 6], max_new_tokens=6))
    shed = Request(uid=2, prompt=[7, 8, 9], max_new_tokens=6)
    with pytest.raises(EngineOverloaded) as exc:
        eng.submit(shed)
    assert exc.value.queue_depth == 1
    # The rolling median step time times the queue depth.
    assert exc.value.retry_after_hint_s == eng._step_timer.percentile(50) * 1 > 0.0
    assert shed.finish_reason == "shed" and shed.t_done > 0.0
    assert eng.stats()["shed"] == 1
    events = list(eng.stream(shed))
    assert len(events) == 1 and events[0].finish_reason == "shed"
    assert events[0].finished and events[0].token == -1
    eng.run()  # the two admitted requests are unharmed
    assert eng.stats()["completed"] == 2


def test_cold_engine_retry_hint_is_zero(port_smoke):
    cfg, q = port_smoke
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64, max_queue=1),
                        device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(EngineOverloaded) as exc:
        eng.submit(Request(uid=1, prompt=[1, 2, 3], max_new_tokens=2))
    assert exc.value.retry_after_hint_s == 0.0  # never stepped: no information


def test_generate_swallows_shed_into_sentinel_stream(port_smoke):
    cfg, q = port_smoke
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64, max_queue=1),
                        device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=6))
    eng.step()
    eng.submit(Request(uid=1, prompt=[4, 5, 6], max_new_tokens=6))
    events = list(eng.generate([7, 8, 9], max_new_tokens=6))
    assert [e.finish_reason for e in events] == ["shed"]
    assert events[0].finished and events[0].token == -1


def test_finish_reason_vocabulary(port_smoke):
    cfg, q = port_smoke
    assert FINISH_REASONS == ("eos", "length", "cancelled", "timeout", "error", "shed")
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=2, max_len=64), device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4))
    eng.submit(Request(uid=1, prompt=[4, 5, 6], max_new_tokens=40))
    eng.step()
    eng.cancel(1)
    eng.run()
    assert {r.finish_reason for r in eng.done} == {"length", "cancelled"}
    for r in eng.done:
        assert r.finish_reason in FINISH_REASONS


# ---------------------------------------------------------------------------
# The serving watchdog


def test_watchdog_percentiles_and_heartbeat(port_smoke, tmp_path):
    cfg, q = port_smoke
    hb = tmp_path / "heartbeat.json"
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=1, max_len=64, heartbeat_path=str(hb)),
                        device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=8))
    eng.run()
    s = eng.stats()
    assert s["step_p50_ms"] > 0.0
    assert s["step_p95_ms"] >= s["step_p50_ms"]
    assert s["step_stalled"] == 0.0
    rec = eng._heartbeat.read()
    assert rec is not None and rec["step"] == eng.steps
    assert rec["active"] == 0 and rec["queued"] == 0


def test_step_timer_matches_reference(monkeypatch):
    """The same step times (a steady run, then a straggling stretch) give
    the same percentiles, median and straggler flag after every step."""
    rng = np.random.default_rng(3)
    dts = np.concatenate([rng.uniform(0.01, 0.02, 60), rng.uniform(0.05, 0.06, 8),
                          rng.uniform(0.01, 0.02, 5)])
    # Both modules read the one time.perf_counter: each timer's start and
    # stop take the next two stamps.
    stamps = iter([x for dt in dts for x in (100.0, 100.0 + float(dt)) * 2])
    monkeypatch.setattr(thealth.time, "perf_counter", lambda: next(stamps))
    assert jhealth.time is thealth.time
    t, j = thealth.StepTimer(window=50), jhealth.StepTimer(window=50)
    flags = []
    for _ in dts:
        for timer in (t, j):
            timer.start()
            timer.stop()
        for qq in (5, 50, 95, 100):
            assert t.percentile(qq) == j.percentile(qq)
        assert t.median() == j.median()
        assert t.is_straggling == j.is_straggling
        flags.append(t.is_straggling)
    assert any(flags) and not flags[-1]


def test_heartbeat_monitor_throttles_and_goes_stale(tmp_path):
    mon = thealth.HeartbeatMonitor(str(tmp_path / "hb" / "beat.json"), timeout=1e9,
                                   min_interval=1e9)
    assert mon.read() is None and not mon.stale()  # cold, not dead
    mon.beat(1, {"active": 1})
    mon.beat(2)  # throttled
    assert mon.read()["step"] == 1 and (mon.beats, mon.writes) == (2, 1)
    mon.beat(3, force=True)
    assert mon.read()["step"] == 3 and not mon.stale()
    assert mon.stale(timeout=-1.0)
    assert mon.stale_hosts([str(tmp_path / "missing.json")]) == [-1]


# ---------------------------------------------------------------------------
# Cancel mid-speculation


def test_cancel_mid_spec_round_allocator_parity(port_smoke):
    """cancel() of an active lane between speculation rounds releases its
    pages: allocator state equals an engine that never saw the request."""
    cfg, q = port_smoke
    rng = np.random.default_rng(5)
    victim = Request(uid=0, prompt=rng.integers(0, cfg.vocab, 5).tolist(), max_new_tokens=40)
    other_prompt = rng.integers(0, cfg.vocab, 7).tolist()
    conf = EngineConfig(max_batch=2, max_len=64, spec=SpecConfig(k=3))
    eng = ServingEngine(cfg, q, conf, device="cpu")
    eng.submit(victim)
    eng.submit(Request(uid=1, prompt=list(other_prompt), max_new_tokens=12))
    for _ in range(2):
        eng.step()  # at least one committed spec round for the victim
    assert eng.stats()["spec_rounds"] > 0
    assert 0 < len(victim.output) < 40
    assert eng.cancel(0)
    eng.run()
    ref = ServingEngine(cfg, q, conf, device="cpu")
    ref.submit(Request(uid=1, prompt=list(other_prompt), max_new_tokens=12))
    ref.run()
    out = {r.uid: r.output for r in eng.done}
    assert out[1] == ref.done[0].output  # the survivor's stream is untouched
    assert _alloc_state(eng) == _alloc_state(ref)
    assert eng.stats()["kv_pages_in_use"] == 0.0
    assert (eng.caches["table"] == 0).all()


def test_optimistic_spec_engine_grows_before_the_round(port_smoke):
    """Under optimistic admission a speculation round first grows every
    lane for its k + 1 positions (preempting if it must), then snapshots
    the positions: the streams equal the plain optimistic engine's token
    for token (both resume bit-exactly), and every page comes back."""
    cfg, q = port_smoke
    prompts = prompts_of(np.random.default_rng(3), cfg.vocab, (6, 9, 4))

    def reqs():
        return [Request(uid=i, prompt=list(p), max_new_tokens=16) for i, p in enumerate(prompts)]

    conf = dict(max_batch=3, max_len=64, page_size=8, n_pages=8, admission="optimistic")
    _, plain = serve(cfg, q, reqs(), **conf)
    eng, got = serve(cfg, q, reqs(), spec=SpecConfig(k=3), **conf)
    assert eng.stats()["spec_rounds"] > 0
    assert got == plain
    assert eng.stats()["kv_pages_in_use"] == 0.0


# ---------------------------------------------------------------------------
# Property tests


_PARAMS = {}


@settings(max_examples=12, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=5), min_size=1, max_size=24))
def test_property_lifecycle_never_leaks_pages(ops):
    """Random interleavings of submit / step / cancel / preempt pressure /
    deadline expiry keep ``in_use + available == capacity`` at every point
    and drain to zero pages in use."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T

    cfg = smoke_config("glm4-9b")
    params = _PARAMS.setdefault("p", T.init_params(cfg, seed=0, device="cpu"))
    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=2, max_len=64, page_size=8, n_pages=7, admission="optimistic",
        max_queue=4), device="cpu")
    rng = np.random.default_rng(sum(ops) + len(ops))
    uid = 0
    live = []
    for op in ops:
        if op in (0, 1):  # submit (short / long budget)
            r = Request(uid=uid, prompt=rng.integers(0, cfg.vocab, 1 + op * 6).tolist(),
                        max_new_tokens=4 + op * 20, deadline_s=None if op == 0 else 1e9)
            uid += 1
            try:
                eng.submit(r)
                live.append(r)
            except EngineOverloaded:
                assert r.finish_reason == "shed"
        elif op == 2 and live:
            eng.cancel(live[rng.integers(0, len(live))].uid)
        elif op == 3 and live:  # force an expiry: a deadline already past
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
    for r in eng.done:
        assert r.finish_reason in FINISH_REASONS


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=30), min_size=1, max_size=8),
       st.integers(min_value=0, max_value=10_000))
def test_property_allocator_truncate_register_invariant(lengths, seed):
    """Alloc / register / truncate / release sequences (the call mix
    preemption makes) hold the capacity invariant, never double-free, and
    leave the port's allocator in the reference's state after every call."""
    rng = np.random.default_rng(seed)
    allocs = (PageAllocator(n_pages=12, page_size=4), JAllocator(n_pages=12, page_size=4))

    def state(a):
        return (list(a._free), dict(a._ref), dict(a._key_of), list(a._lru), a.in_use(),
                a.available())

    lanes = []
    for n_tok in lengths:
        need = pages_needed(n_tok, 4)
        if allocs[0].available() < need:
            if not lanes:
                break
            pages, toks = lanes.pop(int(rng.integers(0, len(lanes))))
            for a, p in zip(allocs, pages):
                keys = a.chain_keys(toks, len(toks) // 4)
                for j, key in enumerate(keys[: len(p)]):
                    a.register(key, p[j])
                a.truncate(p, 0)  # preemption: release every page
        if allocs[0].available() >= need:
            toks = rng.integers(0, 97, n_tok).tolist()
            lanes.append(([a.alloc(need) for a in allocs], toks))
        assert state(allocs[0]) == state(allocs[1])
        assert allocs[0].in_use() + allocs[0].available() == allocs[0].capacity
    for pages, toks in lanes:
        keep = int(rng.integers(0, len(toks) + 1))
        for a, p in zip(allocs, pages):
            p[:] = a.truncate(p, keep)
            a.truncate(p, 0)
        assert state(allocs[0]) == state(allocs[1])
    assert allocs[0].in_use() == 0


def test_overload_config_validation():
    with pytest.raises(ValueError, match="admission_headroom"):
        EngineConfig(admission_headroom=0)
    with pytest.raises(ValueError, match="max_queue"):
        EngineConfig(max_queue=-1)
    with pytest.raises(ValueError, match="heartbeat_interval_s"):
        EngineConfig(heartbeat_interval_s=-1.0)
