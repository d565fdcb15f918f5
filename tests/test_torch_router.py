"""Port parity, the replica router and its chaos harness
(``repro_torch.serving.router`` / ``chaos``): the reference's router tests
(``tests/test_router.py``) on the port's engines, plus the router's pure
logic (backoff, jitter, the breaker's score, configuration) against
``repro``'s on the same inputs.

The acceptance bar is the reference's: a request migrated off a killed
replica mid-decode completes on a survivor token for token the
uncontended single-engine oracle's (greedy and seeded sampling, at every
migration offset); random interleavings of the router lifecycle never
leak pages on any replica; one FaultPlan replayed twice gives the same
outputs. Migration resumes through the engine's bit-exact resume (prompt
re-prefill, committed tokens replayed through the decode path). The
reference's MoE parametrisations (``arch`` in glm4-9b and
deepseek-moe-16b, with the reference's prompt seeds) run on the port's
MoE engines. Its unpaged-replica case runs on the port's unpaged engines: a dense one built
with ``paged=False``, and the Mamba2 and hymba ones, which resolve to
unpaged.
"""
import time
import types

import numpy as np
import pytest
import torch

from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_interop import torch_threads  # noqa: F401
from _torch_lifecycle import port_smoke  # noqa: F401

from repro.serving import chaos as jchaos
from repro.serving import router as jrouter

from repro_torch.configs import smoke_config
from repro_torch.core.ocs import OCSQuantLinear, W4A8Linear
from repro_torch.models import transformer as T
from repro_torch.serving import (
    DEAD,
    DRAINING,
    HEALTHY,
    ChaosHarness,
    DrainReplica,
    EngineConfig,
    EngineOverloaded,
    FaultPlan,
    InjectNaN,
    KillReplica,
    PagePressure,
    ReplicaSet,
    Request,
    Router,
    RouterConfig,
    SamplingParams,
    ServingEngine,
    StallSteps,
)
from repro_torch.serving import router as trouter

_PARAMS = {}


def _setup(arch="glm4-9b"):
    """A smoke model and the port's seed-0 float weights (the reference's
    router tests serve its float init params): glm4-9b, or the MoE
    deepseek-moe-16b of the reference's MoE parametrisations."""
    if arch not in _PARAMS:
        cfg = smoke_config(arch)
        _PARAMS[arch] = (cfg, T.init_params(cfg, seed=0, device="cpu"))
    return _PARAMS[arch]


# The reference's prompt seeds: 7, and 3 for the MoE model ("MoE smoke
# models have argmax knife-edges at some seeds; pinned to a well-posed
# region", tests/test_router.py).
_PROMPT_SEED = {"glm4-9b": 7, "deepseek-moe-16b": 3}


@pytest.fixture(scope="module")
def dense_setup():
    return _setup()


_ECONF = dict(max_batch=2, max_len=64, page_size=8)


def _router(cfg, params, n=2, rconf=None, **conf):
    kw = dict(_ECONF, **conf)
    return Router(ReplicaSet.build(cfg, params, EngineConfig(**kw), n, device="cpu"),
                  rconf or RouterConfig(placement="round_robin"))


def _engine(cfg, params, **conf):
    return ServingEngine(cfg, params, EngineConfig(**dict(_ECONF, **conf)), device="cpu")


def _oracle(cfg, params, reqs, **conf):
    """The single uncontended engine every exactness claim compares to."""
    eng = _engine(cfg, params, **conf)
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.finish_reason in ("eos", "length") for r in reqs)
    return {r.uid: list(r.output) for r in reqs}


def _mk(rng, vocab, lengths, max_new=8, sampling=None):
    return [Request(uid=i, prompt=rng.integers(0, vocab, n).tolist(), max_new_tokens=max_new,
                    sampling=sampling) for i, n in enumerate(lengths)]


def _clone(reqs):
    return [Request(uid=r.uid, prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                    sampling=r.sampling) for r in reqs]


def _assert_no_leaks(router):
    for rep in router.replicas:
        a = rep.engine.allocator
        assert a.in_use() + a.available() == a.capacity, (
            f"replica {rep.rid} ({rep.state}) leaked pages")


# ---------------------------------------------------------------------------
# The router's pure logic against the reference's


def test_router_config_matches_reference():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(RouterConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jrouter.RouterConfig)]
    for bad in (dict(placement="random"), dict(degraded_after=5, dead_after=2),
                dict(backoff_jitter=1.5), dict(max_retries=-1), dict(backoff_cap_s=-1.0),
                dict(fallback_forget_steps=0), dict(straggle_factor=1.0),
                dict(heartbeat_timeout_s=0.0)):
        with pytest.raises(ValueError) as et:
            RouterConfig(**bad)
        with pytest.raises(ValueError) as ej:
            jrouter.RouterConfig(**bad)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("uid", [0, 1, 7, 12345, "req-abc", ("a", 3)])
def test_backoff_and_jitter_match_reference(uid):
    """Deterministic jitter and capped exponential backoff: the same
    delays for the same (uid, attempt, hint)."""
    conf = dict(backoff_base_s=0.02, backoff_cap_s=1.0, backoff_jitter=0.25)
    rt = Router.__new__(Router)
    rt.config = RouterConfig(**conf)
    rj = jrouter.Router.__new__(jrouter.Router)
    rj.config = jrouter.RouterConfig(**conf)
    for attempt in range(8):
        assert trouter._jitter_unit(uid, attempt) == jrouter._jitter_unit(uid, attempt)
        for hint in (0.0, 0.3, 5.0):
            assert rt._backoff(attempt, hint, uid) == rj._backoff(attempt, hint, uid)


def test_fault_score_matches_reference():
    """The breaker's score (quarantine streak + windowed fallback strikes)
    over the same engine readings: the port keeps the reference's strike
    bookkeeping although its engines never fall back."""
    def stand_in():
        return types.SimpleNamespace(paged=True, kv_bits=8, matmul_mode="w8a8",
                                     kernel_fallbacks=0, steps=0, _fault_streak=0)

    et, ej = stand_in(), stand_in()
    rt = trouter.Replica(0, et, RouterConfig(fallback_forget_steps=10))
    rj = jrouter.Replica(0, ej, jrouter.RouterConfig(fallback_forget_steps=10))
    rng = np.random.default_rng(0)
    for _ in range(200):
        d = dict(steps=et.steps + int(rng.integers(0, 8)),
                 kernel_fallbacks=et.kernel_fallbacks + int(rng.random() < 0.05),
                 _fault_streak=int(rng.integers(0, 3)))
        for e in (et, ej):
            e.__dict__.update(d)
        assert rt.fault_score() == rj.fault_score()
    assert rt.tier == rj.tier == (8, "w8a8")


def test_chaos_plan_validation():
    with pytest.raises(TypeError):
        FaultPlan(("kill",))
    with pytest.raises(ValueError):
        FaultPlan((KillReplica(step=-1, replica=0),))
    plan = FaultPlan((KillReplica(step=3, replica=0), InjectNaN(step=1, replica=1, uid=4)))
    assert plan.last_step == 3
    assert [f.step for f in plan.at(1)] == [1]
    jplan = jchaos.FaultPlan((jchaos.KillReplica(step=3, replica=0),
                              jchaos.InjectNaN(step=1, replica=1, uid=4)))
    assert jplan.last_step == plan.last_step


# ---------------------------------------------------------------------------
# Placement


def test_round_robin_rotates_over_healthy(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=3)
    reqs = _mk(np.random.default_rng(0), cfg.vocab, [4, 5, 6, 7, 4, 5])
    for r in reqs:
        router.submit(r)
    by_rep = [[r.uid for r in rep.engine.queue] for rep in router.replicas]
    assert by_rep == [[0, 3], [1, 4], [2, 5]]
    router.run()
    assert all(r.finish_reason == "length" for r in reqs)


def test_least_loaded_prefers_empty_replica(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=2, rconf=RouterConfig(placement="least_loaded"))
    heavy = Request(uid=0, prompt=list(range(1, 20)), max_new_tokens=30)
    light = Request(uid=1, prompt=[1, 2], max_new_tokens=2)
    router.submit(heavy)  # replica 0 (tie -> lowest rid)
    router.submit(light)  # replica 1 is strictly emptier now
    assert [r.uid for r in router.replicas[0].engine.queue] == [0]
    assert [r.uid for r in router.replicas[1].engine.queue] == [1]
    router.run()
    assert heavy.finish_reason == "length" and light.finish_reason == "length"


def test_draining_and_dead_take_no_placements(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=3)
    router.drain(0)
    router.kill(1)
    reqs = _mk(np.random.default_rng(1), cfg.vocab, [4, 5], max_new=2)
    for r in reqs:
        router.submit(r)
    assert not router.replicas[0].engine.queue and not router.replicas[1].engine.queue
    assert len(router.replicas[2].engine.queue) == 2
    router.run()
    assert all(r.finish_reason == "length" for r in reqs)


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-1.3b", "hymba-1.5b"])
def test_router_rejects_unpaged_replicas(dense_setup, arch):
    """An unpaged engine is refused as a replica (migration resumes through
    the paged replay): the reference's case, a dense engine built with
    ``paged=False``, and the SSM and hybrid engines, unpaged by default."""
    if arch == "glm4-9b":
        cfg, params = dense_setup
        paged = _engine(cfg, params)
        assert paged.paged is True and paged.kernel_fallbacks == 0
        eng = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=64, paged=False),
                            device="cpu")
    else:
        cfg = smoke_config(arch)
        eng = ServingEngine(cfg, T.init_params(cfg, seed=0, device="cpu"),
                            EngineConfig(max_batch=2, max_len=64), device="cpu")
    assert eng.paged is False
    with pytest.raises(ValueError, match="paged"):
        ReplicaSet([eng])


def test_replica_set_shares_one_tree(port_smoke):
    """``ReplicaSet.build`` moves the tree to the device once and converts
    it once to the w4a8 tier: every replica's leaves share its tensors."""
    cfg, q = port_smoke
    for mode, kv in (("w8a8", 8), ("w4a8", 4)):
        reps = ReplicaSet.build(cfg, q, EngineConfig(**_ECONF, matmul_mode=mode, kv_bits=kv),
                                3, device="cpu")
        leaves = [rep.engine.params["layers"]["mlp"]["w_up"] for rep in reps]
        if mode == "w4a8":
            assert all(isinstance(w, W4A8Linear) for w in leaves)
            ptrs = {w.w4.data_ptr() for w in leaves}
        else:
            assert all(isinstance(w, OCSQuantLinear) for w in leaves)
            ptrs = {w.weight.values.data_ptr() for w in leaves}
            assert leaves[0].weight.values.data_ptr() == \
                q["layers"]["mlp"]["w_up"].weight.values.data_ptr()
        assert len(ptrs) == 1
        assert len({rep.engine.params["embed"].data_ptr() for rep in reps}) == 1
        assert len({id(rep.engine.caches["layers"][0]["attn"]["k"]) for rep in reps}) == 3


def test_replica_set_build_runs_on_the_card_by_default(dense_setup, monkeypatch):
    cfg, params = dense_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaSet.build(cfg, params, EngineConfig(**_ECONF), 2)


# ---------------------------------------------------------------------------
# Crash-and-migrate is oracle-exact


@pytest.mark.parametrize("arch,tree", [
    pytest.param("glm4-9b", "float", id="float"),
    pytest.param("glm4-9b", "w8a8-int8", id="w8a8-int8"),
    pytest.param("glm4-9b", "w4a8-int4", id="w4a8-int4"),
    pytest.param("deepseek-moe-16b", "float", id="deepseek-moe-16b-float"),
])
def test_kill_migrate_greedy_exact(port_smoke, arch, tree):
    """Kill a replica mid-decode: every request, the harvested in-flight
    lanes carrying committed tokens included, completes on the survivor
    token for token the uncontended oracle's; the survivor replayed the
    committed tails through the decode path. The reference's MoE case
    (deepseek-moe-16b, float weights) too."""
    if tree == "float":
        cfg, params = _setup(arch)
        conf = {}
    else:
        cfg, params = port_smoke
        conf = (dict(matmul_mode="w8a8", kv_bits=8) if tree == "w8a8-int8"
                else dict(matmul_mode="w4a8", kv_bits=4))
    rng = np.random.default_rng(_PROMPT_SEED[arch])
    reqs = _mk(rng, cfg.vocab, [7, 5, 3, 6])
    oracle = _oracle(cfg, params, _clone(reqs), **conf)
    router = _router(cfg, params, n=2, **conf)
    for r in reqs:
        router.submit(r)
    for _ in range(4):  # prefill + a few decode steps on both replicas
        router.step()
    assert any(len(r.output) > 0 for r in reqs)
    router.kill(0)
    assert router.stats()["router_migrated"] > 0
    router.run()
    assert {r.uid: list(r.output) for r in reqs} == oracle
    assert all(r.finish_reason in ("eos", "length") for r in reqs)
    _assert_no_leaks(router)
    assert router.replicas[0].state == DEAD
    assert router.replicas[1].engine.replay_lengths


@pytest.mark.parametrize("arch,kill_at", [
    pytest.param(arch, kill_at, id=str(kill_at) if arch == "glm4-9b" else f"{arch}-{kill_at}")
    for arch in ("glm4-9b", "deepseek-moe-16b") for kill_at in (1, 2, 3, 4, 5)])
def test_migration_offset_sweep_seeded_sampling_exact(arch, kill_at):
    """Seeded (non-greedy) sampling migrated at every offset reproduces the
    oracle stream bit for bit: a draw depends on (seed, position) only. The
    reference's ``arch`` x ``kill_at`` grid, its MoE model included."""
    cfg, params = _setup(arch)
    rng = np.random.default_rng(_PROMPT_SEED[arch])
    sampling = SamplingParams(temperature=0.8, top_k=20, seed=123)
    reqs = _mk(rng, cfg.vocab, [6, 4], max_new=6, sampling=sampling)
    oracle = _oracle(cfg, params, _clone(reqs))
    router = _router(cfg, params, n=2)
    for r in reqs:
        router.submit(r)
    for _ in range(kill_at):
        router.step()
    router.kill(0)
    router.run()
    assert {r.uid: list(r.output) for r in reqs} == oracle, (
        f"migration at step {kill_at} changed a sampled stream")
    _assert_no_leaks(router)


def test_drain_finishes_active_lanes_in_place(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=2, max_batch=1)
    rng = np.random.default_rng(3)
    active = Request(uid=0, prompt=rng.integers(0, cfg.vocab, 5).tolist(), max_new_tokens=6)
    queued = Request(uid=1, prompt=rng.integers(0, cfg.vocab, 4).tolist(), max_new_tokens=6)
    router.submit(active)  # replica 0
    router.submit(queued)  # replica 1 (round robin)
    router.step()  # active takes replica 0's lane
    router.replicas[1].engine.queue.clear()  # re-stage: both on replica 0
    router.replicas[0].engine.queue.append(queued)
    router.drain(0)
    assert [r.uid for r in router.replicas[1].engine.queue] == [1]
    assert router.replicas[0].active() == 1
    assert router.replicas[0].state == DRAINING
    router.run()
    assert active.finish_reason == "length" and queued.finish_reason == "length"
    assert router.replicas[0].engine.stats()["completed"] == 1
    assert router.replicas[0].state == DRAINING  # pinned: the gate never healed it
    router.undrain(0)
    assert router.replicas[0].state == HEALTHY


def test_step_exception_kills_replica_not_router(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=2)
    reqs = _mk(np.random.default_rng(4), cfg.vocab, [5, 4], max_new=4)
    for r in reqs:
        router.submit(r)

    def boom():
        raise RuntimeError("device went away")

    router.replicas[0].engine.step = boom
    router.run()
    assert router.replicas[0].state == DEAD
    assert all(r.finish_reason == "length" for r in reqs)
    assert router.stats()["router_dead_replicas"] == 1.0


# ---------------------------------------------------------------------------
# Health gate (faults, stragglers, heartbeat)


def test_fault_streak_opens_then_kills_breaker(dense_setup):
    """Quarantines on one replica walk it healthy -> draining -> dead
    through the breaker; bystanders complete oracle-exact on the
    survivor."""
    cfg, params = dense_setup
    rng = np.random.default_rng(5)
    reqs = _mk(rng, cfg.vocab, [5, 6, 4, 7], max_new=6)
    oracle = _oracle(cfg, params, _clone(reqs))
    router = _router(cfg, params, n=2,
                     rconf=RouterConfig(placement="round_robin", degraded_after=1,
                                        dead_after=2))
    for r in reqs:
        router.submit(r)
    # Poison both requests routed to replica 0 (uids 0 and 2): the first
    # quarantine drains it, the second kills it.
    router.replicas[0].engine.inject_fault(0, 1)
    router.replicas[0].engine.inject_fault(2, 2)
    router.run()
    assert router.replicas[0].state == DEAD
    got = {r.uid: r.finish_reason for r in reqs}
    assert got[0] == "error" and got[2] == "error"
    for uid in (1, 3):
        r = next(x for x in reqs if x.uid == uid)
        assert r.finish_reason in ("eos", "length") and list(r.output) == oracle[uid]
    s = router.stats()
    assert s["router_drained"] >= 1.0 and s["router_dead_replicas"] == 1.0
    _assert_no_leaks(router)


def test_injected_fault_quarantines_through_the_finite_check(dense_setup):
    """The NaN of ``inject_fault`` reaches the same finite check as a real
    fault, in a plain and in a speculative engine: the poisoned request
    ends "error" with its earlier tokens booked, its neighbour is unharmed,
    and the streak counts it."""
    from repro_torch.serving.spec_decode import SpecConfig

    cfg, params = dense_setup
    rng = np.random.default_rng(2)
    base = _mk(rng, cfg.vocab, [5, 6], max_new=6)
    oracle = _oracle(cfg, params, _clone(base))
    for spec in (None, SpecConfig(k=2)):
        eng = _engine(cfg, params, spec=spec, trace=True)
        reqs = _clone(base)
        for r in reqs:
            eng.submit(r)
        eng.inject_fault(0, 3)
        eng.run()
        assert reqs[0].finish_reason == "error" and len(reqs[0].output) <= 3
        assert reqs[0].output == oracle[0][:len(reqs[0].output)]
        assert reqs[1].output == oracle[1]
        assert eng.stats()["errors"] == 1 and eng._fault_streak == 0  # uid 1 healed it
        assert "quarantine" in eng.trace.summary()
        assert not eng._fault_at


def test_straggler_drains_then_heals(dense_setup):
    cfg, params = dense_setup
    rng = np.random.default_rng(6)
    router = _router(cfg, params, n=2,
                     rconf=RouterConfig(placement="round_robin", straggle_factor=3.0,
                                        straggle_patience=2))
    warm = _mk(rng, cfg.vocab, [5, 4], max_new=6)
    oracle = _oracle(cfg, params, _clone(warm))
    for r in warm:
        router.submit(r)
    router.run()  # fills the step-time windows
    drained_before = router.stats()["router_drained"]
    reqs = _clone(warm)
    for r in reqs:
        router.submit(r)
    harness = ChaosHarness(router, FaultPlan((StallSteps(step=2, replica=0, steps=3,
                                                         seconds=0.25),)))
    harness.run()
    s = router.stats()
    assert s["router_drained"] - drained_before >= 1.0
    assert router.replicas[0].state == HEALTHY  # healed
    assert {r.uid: list(r.output) for r in reqs} == oracle
    _assert_no_leaks(router)


def test_fallback_strikes_decay_not_lifetime(dense_setup):
    """The reference's windowed fallback strikes, fed by hand: the port's
    engines never fall back, but the breaker keeps the logic."""
    cfg, params = dense_setup
    router = _router(cfg, params, n=2, rconf=RouterConfig(fallback_forget_steps=10))
    rep = router.replicas[0]
    assert rep.fault_score() == 0
    rep.engine.kernel_fallbacks = 4  # lifetime total >= dead_after
    rep.engine.steps = 100
    assert rep.fault_score() == 4  # fresh strikes count in full
    rep.engine.steps = 120  # 20 clean steps -> 2 strikes forgiven
    assert rep.fault_score() == 2
    rep.engine.steps = 140  # all forgiven
    assert rep.fault_score() == 0
    rep.engine.kernel_fallbacks = 5
    assert rep.fault_score() == 1
    router._health_gate()
    assert rep.state != DEAD


def test_stale_heartbeat_kills_replica(dense_setup, tmp_path):
    cfg, params = dense_setup
    hb = tmp_path / "hb.json"
    engines = [_engine(cfg, params, heartbeat_path=str(hb) if i == 0 else "")
               for i in range(2)]
    router = Router(ReplicaSet(engines), RouterConfig(heartbeat_timeout_s=0.05, trace=True))
    reqs = _mk(np.random.default_rng(8), cfg.vocab, [4, 5], max_new=3)
    for r in reqs:
        router.submit(r)
    router.step()  # replica 0 beats once
    engines[0]._heartbeat.beat = lambda *a, **k: None  # the writer wedges
    time.sleep(0.08)  # the last written beat ages past the timeout
    router.run()
    assert router.replicas[0].state == DEAD
    assert all(r.finish_reason == "length" for r in reqs)
    dead = [e for e in router.trace.events() if e.kind == "replica_dead"]
    assert [e.args["why"] for e in dead] == ["heartbeat_stale"]
    _assert_no_leaks(router)


# ---------------------------------------------------------------------------
# Retry / timeout / backoff


def test_overloaded_carries_informed_retry_context(dense_setup):
    cfg, params = dense_setup
    eng = ServingEngine(cfg, params, EngineConfig(max_batch=1, max_len=64, max_queue=2),
                        device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=8))
    eng.run()  # populate the step-time window
    eng.submit(Request(uid=1, prompt=[1, 2, 3], max_new_tokens=8))
    eng.submit(Request(uid=2, prompt=[4, 5, 6], max_new_tokens=8))
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(Request(uid=3, prompt=[7, 8, 9], max_new_tokens=8))
    assert ei.value.queue_depth == 2
    assert ei.value.retry_after_hint_s > 0.0
    assert ei.value.retry_after_hint_s == pytest.approx(eng._step_timer.percentile(50) * 2)


def test_router_retries_sheds_until_capacity_frees(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=2, max_queue=1,
                     rconf=RouterConfig(max_retries=10, backoff_base_s=0.01,
                                        backoff_cap_s=0.1))
    reqs = _mk(np.random.default_rng(9), cfg.vocab, [4, 5, 6, 4, 5, 6], max_new=4)
    oracle = _oracle(cfg, params, _clone(reqs))
    for r in reqs:
        router.submit(r)
    router.run(max_steps=100_000)
    s = router.stats()
    assert s["router_retried"] > 0 and s["router_shed"] == 0.0
    assert {r.uid: list(r.output) for r in reqs} == oracle
    _assert_no_leaks(router)


def test_stream_survives_transient_shed(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=1, max_queue=1, max_batch=1,
                     rconf=RouterConfig(max_retries=20, backoff_base_s=0.001,
                                        backoff_cap_s=0.01))
    first = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4)
    burst = Request(uid=1, prompt=[4, 5, 6], max_new_tokens=4)
    router.submit(first)
    router.submit(burst)  # engine queue full -> shed -> router retry
    assert router.stats()["router_retried"] >= 1.0
    assert burst.t_done == 0.0 and burst.finish_reason is None
    events = list(router.stream(burst))
    assert burst.finish_reason == "length"
    assert [e.token for e in events] == list(burst.output)
    assert events[-1].finished and events[-1].finish_reason == "length"
    assert all(e.token != -1 for e in events), "false shed sentinel"
    assert first.finish_reason == "length"
    _assert_no_leaks(router)


def test_retries_exhaust_to_terminal_shed(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=1, rconf=RouterConfig(max_retries=2, backoff_base_s=0.001,
                                                          backoff_cap_s=0.002))
    router.kill(0)
    req = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4)
    router.submit(req)
    events = list(router.stream(req))
    assert req.finish_reason == "shed" and req.t_done > 0.0 and req in router.done
    assert [e.finish_reason for e in events] == ["shed"]
    assert events[0].finished and events[0].token == -1
    assert router.stats()["router_shed"] == 1.0 and router.stats()["router_retried"] == 2.0


def test_end_to_end_deadline_survives_hops(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=1,
                     rconf=RouterConfig(max_retries=50, backoff_base_s=0.05,
                                        backoff_cap_s=0.05, backoff_jitter=0.0))
    router.kill(0)
    req = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4, deadline_s=0.12)
    router.submit(req)
    t0 = time.perf_counter()
    router.run(max_steps=100_000)
    assert req.finish_reason == "timeout"
    assert router.stats()["router_timed_out"] == 1.0
    assert time.perf_counter() - t0 < 1.0


def test_generate_streams_across_migration(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=2)
    events = []
    for ev in router.generate([1, 2, 3, 4], max_new_tokens=5):
        events.append(ev)
        if len(events) == 2:
            router.kill(router._placed[ev.uid])
    assert len(events) == 5
    assert events[-1].finished and events[-1].finish_reason == "length"
    assert [e.index for e in events] == list(range(5))
    _assert_no_leaks(router)


# ---------------------------------------------------------------------------
# Stats schema and metrics exposition


def test_router_stats_schema_v9(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=2)
    router.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=3))
    router.run()
    s = router.stats()
    for key in ("router_steps", "router_placed", "router_retried", "router_migrated",
                "router_drained", "router_dead_replicas", "router_shed", "router_timed_out",
                "router_replicas", "router_healthy_replicas", "router_pending_retries",
                "router_migrate_p50_ms", "router_migrate_p95_ms", "router_tier_rejected"):
        assert isinstance(s[key], float), key
    for rid in range(2):
        assert s[f"replica{rid}_health"] == 1.0
        assert f"replica{rid}_step_p50_ms" in s
    assert s["router_placed"] == 1.0
    assert not any(k.startswith("router_") for k in router.replicas[0].engine.stats())
    text = router.metrics_text()
    assert "router_placed" in text and "replica_health_0" in text
    assert "router_migrate_seconds_bucket" in text


# ---------------------------------------------------------------------------
# Chaos determinism


def test_chaos_same_plan_replays_bit_identical(dense_setup):
    cfg, params = dense_setup
    base = _mk(np.random.default_rng(10), cfg.vocab, [6, 5, 4, 7], max_new=6)
    plan = FaultPlan((InjectNaN(step=0, replica=1, uid=1), DrainReplica(step=1, replica=2),
                      KillReplica(step=3, replica=0)))

    def run_once():
        router = _router(cfg, params, n=3)
        reqs = _clone(base)
        for r in reqs:
            router.submit(r)
        ChaosHarness(router, plan).run()
        _assert_no_leaks(router)
        s = router.stats()
        return ({r.uid: (r.finish_reason, list(r.output)) for r in reqs},
                (s["router_placed"], s["router_migrated"], s["router_dead_replicas"]))

    out1, counters1 = run_once()
    out2, counters2 = run_once()
    assert out1 == out2 and counters1 == counters2
    assert counters1[2] == 1.0  # the scripted kill landed both times
    assert out1[1][0] == "error"


def test_chaos_page_pressure_forces_preemption_under_router(dense_setup):
    cfg, params = dense_setup
    router = _router(cfg, params, n=1, n_pages=9, admission="optimistic")
    reqs = _mk(np.random.default_rng(12), cfg.vocab, [5, 5], max_new=14)
    oracle = _oracle(cfg, params, _clone(reqs))
    for r in reqs:
        router.submit(r)
    harness = ChaosHarness(router, FaultPlan((PagePressure(step=2, replica=0, pages=3,
                                                           hold_steps=30),)))
    harness.run()
    eng = router.replicas[0].engine
    assert eng.stats()["preempted"] > 0, "held pages never starved the pool"
    assert all(r.finish_reason == "length" for r in reqs)
    assert {r.uid: list(r.output) for r in reqs} == oracle  # resumes are bit-exact
    assert not harness._held and eng.allocator.in_use() == 0
    _assert_no_leaks(router)


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=6), min_size=1, max_size=20))
def test_property_router_lifecycle_never_leaks_pages(ops):
    """Random interleavings of submit / step / kill / drain / undrain /
    deadline expiry hold ``in_use + available == capacity`` on every
    replica after every event, and drain to zero pages on live replicas."""
    cfg, params = _setup()
    router = Router(
        ReplicaSet.build(cfg, params, EngineConfig(max_batch=2, max_len=64, page_size=8,
                                                   max_queue=3), 2, device="cpu"),
        RouterConfig(max_retries=2, backoff_base_s=0.001, backoff_cap_s=0.005))
    rng = np.random.default_rng(sum(ops) + len(ops))
    uid = 0
    live = []
    for op in ops:
        if op in (0, 1):
            r = Request(uid=uid, prompt=rng.integers(0, cfg.vocab, 2 + op * 5).tolist(),
                        max_new_tokens=3 + op * 10, deadline_s=None if op == 0 else 10.0)
            uid += 1
            router.submit(r)  # never raises
            live.append(r)
        elif op == 2:
            router.kill(int(rng.integers(0, 2)))
        elif op == 3:
            router.drain(int(rng.integers(0, 2)))
        elif op == 4:
            router.undrain(int(rng.integers(0, 2)))
        elif op == 5 and live:
            live[int(rng.integers(0, len(live)))].deadline_s = 0.0
        else:
            router.step()
        _assert_no_leaks(router)
        live = [r for r in live if r.t_done == 0.0]
    router.run(max_steps=50_000)
    _assert_no_leaks(router)
    for rep in router.replicas:
        if rep.state != DEAD:
            assert rep.engine.allocator.in_use() == 0
    for r in live:
        assert r.t_done > 0.0, (r.uid, r.finish_reason)


# ---------------------------------------------------------------------------
# Precision tiers: cross-tier migration is rejected, never resumed


def _mixed_router(cfg, params, tiers, rconf=None):
    """One replica per (kv_bits, matmul_mode) entry in ``tiers``."""
    engines = [_engine(cfg, params, kv_bits=kv, matmul_mode=mm) for kv, mm in tiers]
    return Router(ReplicaSet(engines), rconf or RouterConfig(placement="round_robin"))


def test_replica_tier_identity(dense_setup):
    cfg, params = dense_setup
    router = _mixed_router(cfg, params, [(8, "dequant"), (4, "dequant"), (None, "dequant")])
    assert [rep.tier for rep in router.replicas] == [(8, "dequant"), (4, "dequant"),
                                                     (0, "dequant")]


def test_cross_tier_migration_rejected_when_tier_extinct(dense_setup):
    cfg, params = dense_setup
    router = _mixed_router(cfg, params, [(8, "dequant"), (4, "dequant")])
    reqs = _mk(np.random.default_rng(3), cfg.vocab, [5, 6], max_new=8)
    for r in reqs:
        router.submit(r)  # round_robin: uid 0 -> rep 0 (kv8), uid 1 -> rep 1
    for _ in range(4):
        router.step()
    assert len(reqs[0].output) > 0  # committed tokens pin the tier
    router.kill(0)
    assert reqs[0].finish_reason == "tier_mismatch" and reqs[0].t_done > 0.0
    s = router.stats()
    assert s["router_tier_rejected"] == 1.0 and s["router_migrated"] == 0.0
    router.run()
    assert reqs[1].finish_reason in ("eos", "length")
    _assert_no_leaks(router)


def test_fresh_requests_cross_tiers_freely(dense_setup):
    cfg, params = dense_setup
    router = _mixed_router(cfg, params, [(8, "dequant"), (4, "dequant")])
    req = Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=4)
    router.submit(req)  # round_robin -> rep 0 (kv8)
    router.kill(0)  # nothing committed yet: migrates to the int4 replica
    assert router.stats()["router_tier_rejected"] == 0.0
    assert router.stats()["router_migrated"] == 1.0
    router.run()
    assert req.finish_reason == "length"
    _assert_no_leaks(router)


def test_same_tier_migration_still_exact_in_mixed_set(dense_setup):
    cfg, params = dense_setup
    router = _mixed_router(cfg, params, [(8, "dequant"), (8, "dequant"), (4, "dequant")])
    reqs = _mk(np.random.default_rng(7), cfg.vocab, [7, 5, 3], max_new=8)
    oracle = _oracle(cfg, params, _clone(reqs), kv_bits=8)
    for r in reqs:
        router.submit(r)  # uid i -> replica i (round_robin)
    for _ in range(4):
        router.step()
    assert len(reqs[0].output) > 0
    router.kill(0)
    assert router._placed.get(0) == 1, "must resume on the int8 peer"
    assert router.stats()["router_tier_rejected"] == 0.0
    router.run()
    assert {r.uid: list(r.output) for r in reqs[:2]} == {u: oracle[u] for u in (0, 1)}
    assert reqs[2].finish_reason in ("eos", "length")
    _assert_no_leaks(router)


def test_stream_emits_tier_mismatch_sentinel(dense_setup):
    cfg, params = dense_setup
    router = _mixed_router(cfg, params, [(8, "dequant"), (4, "dequant")])
    it = router.generate([1, 2, 3], max_new_tokens=16)  # -> rep 0 (kv8)
    events = [next(it)]  # at least one committed token pins the tier
    router.kill(0)
    events.extend(it)
    assert events[-1].finished and events[-1].finish_reason == "tier_mismatch"
    _assert_no_leaks(router)


def test_launch_serve_replicated(tmp_path):
    """``launch.serve --replicas 2`` serves through the router: the
    replicas' counters are summed, the router's layer added, and
    ``--metrics-out`` writes the router's registry before replica 0's."""
    from repro_torch.launch import serve

    prom = tmp_path / "m.prom"
    stats = serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--replicas", "2",
                        "--placement", "round_robin", "--n-requests", "3", "--max-new", "4",
                        "--max-len", "64", "--metrics-out", str(prom), "--log-level",
                        "WARNING"])
    assert stats["completed"] == 3 and stats["router_placed"] == 3.0
    assert stats["router_replicas"] == 2.0 and stats["decoded_tokens"] == 3 * 3
    text = prom.read_text()
    assert text.index("router_placed") < text.index("engine_steps_total")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--replicas", "2",
                    "--trace", "--trace-out", str(tmp_path / "t.json")])
