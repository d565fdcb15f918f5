"""Port parity, observability: ``repro_torch.obs`` (the metrics registry,
the span ring and its Chrome-trace export, the quant-drift monitor),
``core.tap`` and ``core.histogram.ChannelStats`` against ``repro`` on the
same operation sequences and numpy arrays, and the engine's observability
wiring against the reference engine's.

Registry text, snapshots, Chrome traces and drift reports are compared
with ``==`` (the port's code is the reference's, and the inputs are
identical, so nothing may differ at all). The engines' per-request span
sequences are compared kind by kind; their timestamps are each machine's
own.
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from _torch_interop import glm_smoke, glm_smoke_served, torch_threads  # noqa: F401
from _torch_lifecycle import port_smoke, prompts_of, serve  # noqa: F401

from repro.core import histogram as jhist
from repro.core import tap as jtap
from repro.obs import drift as jdrift
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace

from repro_torch.core import histogram as thist
from repro_torch.core import tap as ttap
from repro_torch.models import transformer as T
from repro_torch.obs import drift as tdrift
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving.spec_decode import SpecConfig


# ---------------------------------------------------------------------------
# The metrics registry


def _registry_script(seed, n=60):
    """A seeded sequence of registry operations: (op, name, labels, value)."""
    rng = np.random.default_rng(seed)
    names = ["steps_total", "tokens_total", "depth", "lat_seconds", "site_rate"]
    ops = []
    for _ in range(n):
        k = int(rng.integers(0, len(names)))
        name = names[k]
        labels = {"site": f"s{int(rng.integers(0, 3))}"} if name == "site_rate" else None
        if k < 2:
            ops.append(("counter", name, labels, float(rng.integers(0, 5))))
        elif k in (2, 4):
            ops.append(("gauge", name, labels, float(rng.standard_normal())))
        else:
            ops.append(("histogram", name, labels, float(rng.exponential(0.05))))
    return ops


def _apply(mod, ops, window=4096):
    m = mod.MetricsRegistry()
    for op, name, labels, v in ops:
        if op == "counter":
            m.counter(name, f"help {name}", labels).inc(v)
        elif op == "gauge":
            g = m.gauge(name, f"help {name}", labels)
            g.set(v) if v >= 0 else g.inc(v)
        else:
            m.histogram(name, f"help {name}", labels, window=window).observe(v)
    return m


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("window", [4096, 5])
def test_registry_matches_reference(seed, window):
    """The same operations give the same Prometheus text, snapshot and flat
    view, and the same histogram percentiles and means."""
    ops = _registry_script(seed)
    mj, mt = _apply(jmetrics, ops, window), _apply(tmetrics, ops, window)
    assert mt.prometheus_text() == mj.prometheus_text()
    assert mt.snapshot() == mj.snapshot()
    assert json.dumps(mt.snapshot()) == json.dumps(mj.snapshot())
    assert mt.as_dict() == mj.as_dict()
    assert len(mt) == len(mj)
    hj, ht = mj.get("lat_seconds"), mt.get("lat_seconds")
    if hj is not None:
        for q in (0, 5, 50, 95, 100):
            assert ht.percentile(q) == hj.percentile(q)
        assert ht.mean == hj.mean and ht.count == hj.count


@pytest.mark.parametrize("mod", ["repro", "repro_torch"])
def test_registry_semantics(mod):
    """The reference's registry unit cases, on both packages."""
    m = (jmetrics if mod == "repro" else tmetrics)
    c = m.Counter("requests_total", "help")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    c.set_(10.0)
    with pytest.raises(ValueError):
        c.inc(-1.0)
    with pytest.raises(ValueError):
        c.set_(5.0)
    h = m.Histogram("lat", "help", buckets=(0.1, 1.0, 10.0))
    for v in [0.05, 0.2, 0.3, 5.0]:
        h.observe(v)
    assert (h.percentile(0), h.percentile(50), h.percentile(100)) == (0.05, 0.2, 5.0)
    h = m.Histogram("lat", "help", window=8)
    for i in range(100):
        h.observe(float(i))
    assert h.count == 100 and h.percentile(0) == 92.0
    reg = m.MetricsRegistry()
    c1 = reg.counter("steps_total", "h")
    assert reg.counter("steps_total") is c1
    with pytest.raises(TypeError):
        reg.gauge("steps_total")
    with pytest.raises(ValueError):
        reg.counter("bad name!")
    a = reg.gauge("site_rate", "h", labels={"site": "a"})
    assert reg.gauge("site_rate", labels={"site": "a"}) is a
    assert reg.gauge("site_rate", labels={"site": "b"}) is not a


# ---------------------------------------------------------------------------
# The span ring


def _trace_script(seed, n=40):
    rng = np.random.default_rng(seed)
    kinds = ["step", "decode_step", "admit", "prefill", "first_token", "retire",
             "preempt", "resume", "shed"]
    out, ts = [], 10.0
    for i in range(n):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        ts += float(rng.exponential(0.01))
        track = -1 if kind in ("step", "decode_step") else int(rng.integers(0, 4))
        if seed % 2 and track == 2:
            track = "req-abc"  # uids need not be ints
        dur = float(rng.exponential(0.005)) if kind in ("step", "decode_step", "prefill") \
            else 0.0
        out.append((kind, dict(track=track, ts=ts, dur=dur, step=i, tokens=i % 7)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [8192, 16])
def test_trace_ring_matches_reference(seed, capacity, tmp_path):
    """The same emits give the same Chrome trace (events, metadata tracks,
    dropped count), per-request timelines and summary; the export
    validates."""
    rj, rt = jtrace.TraceRing(capacity), ttrace.TraceRing(capacity)
    for kind, kw in _trace_script(seed):
        rj.emit(kind, **kw)
        rt.emit(kind, **kw)
    assert rt.chrome_trace() == rj.chrome_trace()
    assert (len(rt), rt.dropped, rt.emitted) == (len(rj), rj.dropped, rj.emitted)
    assert rt.summary() == rj.summary()
    for uid in (0, 1, 3, "req-abc", -1):
        assert rt.trace_request(uid) == rj.trace_request(uid)
    assert ttrace.validate_chrome_trace(rt.chrome_trace()) is None
    rt.export(str(tmp_path / "t.json"))
    rj.export(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("doc", [
    {}, {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0}]},
    {"traceEvents": [{"name": "a", "ph": "i", "pid": 1, "tid": 0}]},
    {"traceEvents": [{"ph": "i", "pid": 1, "tid": 0, "ts": 1.0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0, "dur": -1}]},
    {"traceEvents": [{"name": "m", "ph": "M", "pid": 1, "tid": 0}]},
], ids=["empty", "no-dur", "no-ts", "no-name", "neg-dur", "meta"])
def test_validate_chrome_trace_matches_reference(doc):
    assert ttrace.validate_chrome_trace(doc) == jtrace.validate_chrome_trace(doc)


def test_trace_ph_and_auto_timestamp():
    tr = ttrace.TraceRing()
    tr.emit("step", ts=1.0, dur=0.5)
    tr.emit("admit", track=3)
    evs = tr.events()
    assert evs[0].ph == "X" and evs[1].ph == "i" and evs[1].ts > 0.0


# ---------------------------------------------------------------------------
# Quant-drift monitor, tap and channel stats


def _drift_feed(seed):
    """(site, array) pairs: calibration traffic, then live traffic with some
    sites blown up."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(12):
        for site, scale in (("mlp_up#0", 1.0), ("attn_q#0", 1.0), ("lm_head#0", 0.5)):
            s = scale * (8.0 if b >= 6 and site == "mlp_up#0" else 1.0)
            out.append((site, (rng.standard_normal(700) * s).astype(np.float32)))
    return out


@pytest.mark.parametrize("kw", [
    dict(calib_samples=4, min_values=512),
    dict(calib_samples=4, min_values=512, factor=2.0, grid_bits=4),
    dict(clips={"attn_q#0": 2.0}, calib_samples=2, min_values=128, quantile=0.99),
], ids=["default", "int4-floor", "grid-clip"])
@pytest.mark.parametrize("seed", [0, 1])
def test_drift_monitor_matches_reference(kw, seed):
    """The same arrays give the same stats(), report(), flagged sites and
    published gauges."""
    mj, mt = jdrift.QuantDriftMonitor(**kw), tdrift.QuantDriftMonitor(**kw)
    for site, a in _drift_feed(seed):
        mj.observe(site, a)
        mt.observe(site, a)
    assert mt.stats() == mj.stats()
    assert mt.report() == mj.report()
    assert mt.flagged() == mj.flagged()
    rj, rt = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    mj.publish(rj)
    mt.publish(rt)
    assert rt.prometheus_text() == rj.prometheus_text()
    if "grid_bits" not in kw and "clips" not in kw:
        assert "mlp_up#0" in mt.flagged()


def test_drift_sample_through_tap_matches_reference():
    """``sample`` routes tapped activations into the monitor with the
    ``name#ordinal`` keying: the same tagged arrays, through each package's
    ``tap.tag``, give the same report."""
    rng = np.random.default_rng(4)
    batches = [[rng.standard_normal((3, 64)).astype(np.float32) for _ in range(3)]
               for _ in range(6)]
    mj = jdrift.QuantDriftMonitor(calib_samples=2, min_values=64)
    mt = tdrift.QuantDriftMonitor(calib_samples=2, min_values=64)
    for xs in batches:
        mj.sample(lambda: [jtap.tag(n, x) for n, x in zip(("mlp_up", "mlp_up", "lm_head"), xs)])
        mt.sample(lambda: [ttap.tag(n, torch.from_numpy(x))
                           for n, x in zip(("mlp_up", "mlp_up", "lm_head"), xs)])
    assert sorted(mt.sites) == ["lm_head#0", "mlp_up#0", "mlp_up#1"]
    assert mt.report() == mj.report() and mt.stats() == mj.stats()


def _with_grids(tree, leaves, mod):
    """``tree`` with a static activation grid (a_bits 8, a per-column
    a_scale) set on the named attention and MLP leaves."""
    out = dict(tree)
    out["layers"] = {k: dict(v) for k, v in tree["layers"].items()}
    rng = np.random.default_rng(9)
    for block, name in leaves:
        leaf = out["layers"][block][name]
        a = rng.uniform(0.01, 0.05, (1, 1, 1)).astype(np.float32)
        if mod == "repro":
            import jax.numpy as jnp
            scale = jnp.asarray(a)
        else:
            scale = torch.from_numpy(a)
        out["layers"][block][name] = dataclasses.replace(leaf, a_bits=8, a_scale=scale)
    return out


def test_clips_from_params_matches_reference(glm_smoke_served):
    """Both packages derive the same per-site clips from the same
    quantized trees given the same activation grids; trees without grids
    (the serving trees) give {} in both."""
    qj, qt = glm_smoke_served
    assert tdrift.clips_from_params(qt) == jdrift.clips_from_params(qj) == {}
    leaves = [("attn", "wq"), ("attn", "wo"), ("mlp", "w_up"), ("mlp", "w_down")]
    cj = jdrift.clips_from_params(_with_grids(qj, leaves, "repro"))
    ct = tdrift.clips_from_params(_with_grids(qt, leaves, "repro_torch"))
    assert ct == cj
    assert sorted(ct) == ["attn_o#0", "attn_q#0", "mlp_down#0", "mlp_up#0"]


def test_channel_stats_and_collector_match_reference():
    rng = np.random.default_rng(5)
    cj, ct = jtap.Collector(), ttap.Collector()
    for _ in range(4):
        cj.begin_batch()
        ct.begin_batch()
        # bfloat16 activations, as the models tag them (widened exactly).
        xs = [torch.from_numpy((rng.standard_normal((5, 32)) * rng.uniform(0.5, 4.0, 32))
                               .astype(np.float32)).to(torch.bfloat16) for _ in range(3)]
        with jtap.collecting(cj):
            for n, x in zip(("mlp_in", "mlp_in", "attn_q"), xs):
                jtap.tag(n, x.to(torch.float32).numpy())
        with ttap.collecting(ct):
            for n, x in zip(("mlp_in", "mlp_in", "attn_q"), xs):
                ttap.tag(n, x)
                assert ttap.active_collector() is ct
        assert ttap.active_collector() is None
    assert sorted(ct.sites) == sorted(cj.sites) == ["attn_q#0", "mlp_in#0", "mlp_in#1"]
    for key in cj.sites:
        j, t = cj[key], ct[key]
        assert isinstance(t, thist.ChannelStats)
        np.testing.assert_array_equal(t.abs_max, j.abs_max)
        np.testing.assert_array_equal(t.exceed_counts, j.exceed_counts)
        np.testing.assert_array_equal(t.split_order(), j.split_order())
        np.testing.assert_array_equal(t.hist.counts, j.hist.counts)
    st = thist.ChannelStats(n_channels=3)
    sj = jhist.ChannelStats(n_channels=3)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    st.update(x, channel_axis=1)
    sj.update(x, channel_axis=1)
    np.testing.assert_array_equal(st.exceed_counts, sj.exceed_counts)


def test_tag_is_inert_without_a_collector(monkeypatch):
    """With no collector active ``tag`` touches nothing: no copy, no
    ``.cpu()`` (which would synchronise the card), and a serving step's
    operations run exactly as without the tap sites."""
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"tag touched .{name}")

    assert ttap.active_collector() is None
    ttap.tag("mlp_up", Untouchable())

    def no_cpu(self, *a, **k):
        raise AssertionError("a tensor went to the host")

    from repro_torch.configs import smoke_config

    cfg = smoke_config("glm4-9b")
    params = T.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=32), device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=3))
    eng.step()
    calls = []
    real = ttap.Collector.add
    monkeypatch.setattr(ttap.Collector, "add", lambda *a: calls.append(a) or real(*a))
    with torch.no_grad():
        monkeypatch.setattr(torch.Tensor, "numpy", no_cpu)
        T.decode_step(eng.params, eng.tokens, eng.caches, cfg, mode="dequant")
    assert calls == []


# ---------------------------------------------------------------------------
# Engine wiring


def _reqs(cfg, lengths, max_new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_new_tokens=max_new) for i, n in enumerate(lengths)]


def _span_kinds(ring, uids):
    return {u: [e["kind"] for e in ring.trace_request(u)] for u in uids}


@pytest.mark.parametrize("case", ["reserve", "optimistic", "chunked"])
def test_engine_span_sequences_match_reference(glm_smoke, glm_smoke_served, case):
    """Both engines, tracing, stepped in lockstep over the same requests:
    every request's span kinds in order, the engine lane's kinds in order
    and the ring's summary are the reference engine's."""
    from _torch_lifecycle import serve_both

    cfg = glm_smoke[0]
    qj, qt = glm_smoke_served
    conf = dict(max_batch=3, max_len=96, page_size=8, trace=True, trace_capacity=4096)
    lengths, max_new = (7, 5, 3), 12
    if case == "optimistic":
        conf.update(n_pages=9, admission="optimistic")
        max_new = 20
    elif case == "chunked":
        conf.update(prefill_budget=16, chunk_size=16)
        lengths = (40, 7, 5)
    prompts = prompts_of(np.random.default_rng(7), cfg.vocab, lengths)
    je, te, _, _ = serve_both(cfg, qj, qt, conf, prompts, max_new=max_new)
    uids = range(len(prompts))
    assert _span_kinds(te.trace, uids) == _span_kinds(je.trace, uids)
    assert _span_kinds(te.trace, [-1]) == _span_kinds(je.trace, [-1])
    assert te.trace.summary() == je.trace.summary()
    if case == "optimistic":
        assert te.preempted > 0 and "resume" in te.trace.summary()
    if case == "chunked":
        assert "sched_budget_limited" in te.trace.summary()
    assert ttrace.validate_chrome_trace(te.trace.chrome_trace()) is None
    st = te.stats()
    assert st["trace_enabled"] == 1.0 and st["trace_events"] == float(len(te.trace))


def test_engine_spec_spans(port_smoke):
    """A speculative engine's rounds land on the engine lane as one
    ``spec_draft`` and one ``spec_verify`` span each, inside their step."""
    cfg, q = port_smoke
    eng, _ = serve(cfg, q, _reqs(cfg, [4, 6], max_new=8), max_batch=2, max_len=64,
                   spec=SpecConfig(k=3), trace=True)
    summary = eng.trace.summary()
    rounds = eng.stats()["spec_rounds"]
    assert rounds > 0 and summary["spec_draft"] == summary["spec_verify"] == rounds
    steps = {}
    for e in eng.trace.events():  # the step that moved the count to e.step
        if e.kind == "step":
            steps.setdefault(e.step, e)
    for e in eng.trace.events():
        if e.kind == "spec_verify":
            st = steps[e.step + 1]  # stamped before the round's step count moves
            assert st.ts <= e.ts and e.ts + e.dur <= st.ts + st.dur


def test_engine_trace_export_and_ring_bound(port_smoke, tmp_path):
    cfg, q = port_smoke
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=2, max_len=64, trace=True,
                                             trace_capacity=512), device="cpu")
    for r in _reqs(cfg, [4, 6, 9]):
        eng.submit(r)
    eng.run()
    path = tmp_path / "trace.json"
    eng.trace.export(str(path))
    assert ttrace.validate_chrome_trace(json.loads(path.read_text())) is None
    for uid in (0, 1, 2):
        tl = [e["kind"] for e in eng.trace.trace_request(uid)]
        assert tl[0] == "admit" and tl[-1] == "retire"
        assert tl.index("prefill") < tl.index("first_token")
    small = ServingEngine(cfg, q, EngineConfig(max_batch=2, max_len=64, trace=True,
                                               trace_capacity=8), device="cpu")
    for r in _reqs(cfg, [4, 6], max_new=8):
        small.submit(r)
    small.run()
    assert len(small.trace) == 8 and small.stats()["trace_dropped"] > 0


def test_engine_stats_come_from_the_registry(glm_smoke, glm_smoke_served):
    """The stats fields read the registry: counters are the attribute
    facade, percentiles the registry histograms; every metric the port's
    engine exposes is one the reference's exposes, under the same type."""
    from repro.serving import EngineConfig as JConfig
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine

    cfg = glm_smoke[0]
    qj, qt = glm_smoke_served
    eng = ServingEngine(cfg, qt, EngineConfig(max_batch=2, max_len=64), device="cpu")
    for r in _reqs(cfg, [4, 6]):
        eng.submit(r)
    eng.run()
    s = eng.stats()
    for k in ("trace_enabled", "trace_events", "trace_dropped", "drift_enabled",
              "drift_samples", "drift_sites", "drift_flagged_sites", "drift_max_ratio"):
        assert s[k] == 0.0, k
    m = eng.metrics
    assert eng.steps == m.counter("engine_steps_total").value == s["decode_steps"]
    assert m.counter("engine_completed_total").value == float(s["completed"]) == 2.0
    assert s["ttft_p50_s"] == m.get("request_ttft_seconds").percentile(50) > 0.0
    assert s["itl_p95_s"] == m.get("request_itl_seconds").percentile(95)
    assert s["mean_latency_s"] == m.get("request_latency_seconds").mean
    assert s["kv_pages_in_use"] == m.gauge("kv_pages_in_use").value == 0.0
    text = eng.metrics_text()
    assert "# TYPE engine_steps_total counter" in text
    assert "request_ttft_seconds_count 2" in text
    json.dumps(eng.metrics_snapshot())
    je = JEngine(cfg, qj, JConfig(max_batch=2, max_len=64))
    for r in _reqs(cfg, [4, 6]):
        je.submit(JRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    je.run()
    types = lambda t: {ln for ln in t.splitlines() if ln.startswith("# TYPE")}  # noqa: E731
    assert types(text) <= types(je.metrics_text())
    assert {k for k in s if k != "device"} <= set(je.stats())


def test_engine_drift_monitor_samples(port_smoke):
    """drift_every=1 samples a tapped forward per productive step; the
    sites are the model's dense calls and in-profile traffic stays
    unflagged; the tokens are those of an engine without the monitor."""
    cfg, q = port_smoke
    reqs = lambda: _reqs(cfg, [4, 6], max_new=6)  # noqa: E731
    eng, got = serve(cfg, q, reqs(), max_batch=2, max_len=64, drift_every=1)
    _, want = serve(cfg, q, reqs(), max_batch=2, max_len=64)
    assert got == want
    s = eng.stats()
    assert s["drift_enabled"] == 1.0 and s["drift_samples"] > 0
    assert s["drift_sites"] == 7 * cfg.n_layers + 1
    assert s["drift_flagged_sites"] == 0.0
    assert "quant_drift_sites" in eng.metrics_text()
    rep = eng.drift_report()
    assert set(rep) == {f"{n}#{i}" for n in ("attn_q", "attn_k", "attn_v", "attn_o",
                                             "mlp_gate", "mlp_up", "mlp_down")
                        for i in range(cfg.n_layers)} | {"lm_head#0"}


@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["float32", "int8", "int4"])
def test_drift_sample_leaves_pools_bitwise(port_smoke, kv_bits):
    """An explicit drift sample mid-run leaves every pool byte and the lane
    positions as they were, and its snapshot covers every row a decode step
    writes (the rows a functional decode step changes are exactly the ones
    ``_pool_rows`` names)."""
    cfg, q = port_smoke
    mode = "w4a8" if kv_bits == 4 else "dequant"
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=3, max_len=64, page_size=8,
                                             kv_bits=kv_bits, matmul_mode=mode,
                                             drift_every=1000), device="cpu")
    for r in _reqs(cfg, [4, 9], max_new=10):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    before = [{k: t.clone() for k, t in layer["attn"].items()} for layer in eng.caches["layers"]]
    pos = eng.caches["pos"].clone()
    eng._drift_sample()
    assert eng._drift.samples == 1 and not eng._drift_broken
    for layer, old in zip(eng.caches["layers"], before):
        for k, t in layer["attn"].items():
            assert torch.equal(t, old[k]), k
    assert torch.equal(eng.caches["pos"], pos)
    page, row = eng._pool_rows()
    with torch.no_grad():
        _, new = T.decode_step(eng.params, eng.tokens, eng.caches, cfg, mode=mode)
    written = set(zip(page.tolist(), row.tolist()))
    for layer, old in zip(new["layers"], before):
        for k, t in layer["attn"].items():
            diff = (t != old[k]).reshape(t.shape[0], t.shape[1], t.shape[2], -1).any(-1)
            pages, _, rows = torch.nonzero(diff, as_tuple=True)
            assert set(zip(pages.tolist(), rows.tolist())) <= written, k


def test_profile_dir_writes_a_trace(port_smoke, tmp_path):
    cfg, q = port_smoke
    out = tmp_path / "prof"
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=2, max_len=64, profile_dir=str(out)),
                        device="cpu")
    for r in _reqs(cfg, [4], max_new=3):
        eng.submit(r)
    eng.run()
    assert eng._profiler is None  # the window closed with run()
    files = glob.glob(os.path.join(str(out), "*.json"))
    assert files
    doc = json.loads(open(files[0]).read())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "serving_decode_step" in names and "serving_prefill" in names


def test_observability_config_validation():
    with pytest.raises(ValueError, match="trace_capacity"):
        EngineConfig(trace_capacity=0)
    with pytest.raises(ValueError, match="drift_every"):
        EngineConfig(drift_every=-1)
    with pytest.raises(ValueError, match="drift_threshold"):
        EngineConfig(drift_threshold=1.0)
    from repro.serving import EngineConfig as JConfig

    for f in ("trace", "trace_capacity", "profile_dir", "drift_every", "drift_threshold",
              "attn_probe"):
        jf = next(x for x in dataclasses.fields(JConfig) if x.name == f)
        tf = next(x for x in dataclasses.fields(EngineConfig) if x.name == f)
        assert tf.default == jf.default, f
        # The port's window is torch.profiler's; its probe compiles nothing.
        if f not in ("profile_dir", "attn_probe"):
            assert tf.metadata["help"] == jf.metadata["help"], f


def test_launch_serve_trace_and_metrics(tmp_path):
    from repro_torch.launch import serve

    tr, prom, jl = tmp_path / "t.json", tmp_path / "m.prom", tmp_path / "m.jsonl"
    stats = serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--n-requests",
                        "2", "--max-new", "4", "--max-len", "64", "--trace", "--trace-out",
                        str(tr), "--metrics-out", str(prom), "--metrics-jsonl", str(jl),
                        "--metrics-every", "2", "--drift-every", "2", "--log-level",
                        "WARNING"])
    assert stats["completed"] == 2 and stats["drift_samples"] > 0
    assert ttrace.validate_chrome_trace(json.loads(tr.read_text())) is None
    assert "# TYPE engine_steps_total counter" in prom.read_text()
    lines = [json.loads(ln) for ln in jl.read_text().splitlines()]
    assert len(lines) >= 2 and "engine_steps_total" in lines[-1]["metrics"]
    with pytest.raises(SystemExit):
        serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--trace-out",
                    str(tr)])
