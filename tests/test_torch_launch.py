"""Port parity, the launcher's float arms, the attention probe and the
port's examples: ``launch/serve.py``'s ``--float-serve`` and
``--compare-float`` against ``repro.launch.serve`` at smoke size,
``EngineConfig.attn_probe`` / ``stats()["attn_step_ms"]``, and
``repro_torch.examples.*`` run end to end on the CPU.

Tolerances:

* the float serve's greedy tokens on float32 pages: equal to the
  reference's float serve (the float tree's logits agree to float32 and
  bfloat16 rounding; at smoke size no greedy choice sits at a near-tie);
* ``--compare-float``'s agreement figure in ``w8a8``: equal to the
  reference's. In ``dequant`` the two figures differ by design: the port
  follows the reference's kernel route (float32 sums of exact products)
  where the reference's launcher takes its XLA route (weights rounded to
  bfloat16 first), so only the figure's presence is held there;
* the probe: the live pools' bytes, the positions, the page table and the
  allocator state bitwise unchanged across ``stats()``.
"""
import logging

import numpy as np
import pytest
import torch

from _torch_interop import (SERVE_RECIPE, glm_smoke, jax_tree_to_numpy,  # noqa: F401
                            torch_threads)

from repro_torch.core.apply import quantize_params
from repro_torch.core.recipe import QuantRecipe
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as TS
from repro_torch.serving import EngineConfig, Request, ServingEngine

ARGS = ["--arch", "glm4-9b", "--smoke", "--n-requests", "3", "--max-new", "5", "--max-len",
        "64"]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logged(logger_name, fn):
    """``fn()``'s result and the messages its launcher logged."""
    h = _Lines()
    lg = logging.getLogger(logger_name)
    lg.addHandler(h)
    try:
        out = fn()
    finally:
        lg.removeHandler(h)
    return out, h.lines


def _agreement(lines):
    return [ln for ln in lines if ln.startswith("int8-vs-float token agreement")]


def test_compare_float_agreement_matches_reference():
    from repro.launch import serve as JS

    mode = ["--matmul-mode", "w8a8", "--kv-bits", "8", "--compare-float"]
    _, want = _logged("repro.launch.serve", lambda: JS.main(ARGS + mode))
    stats, got = _logged("repro_torch.launch.serve",
                         lambda: TS.main(ARGS + mode + ["--device", "cpu"]))
    assert len(_agreement(want)) == 1
    assert _agreement(got) == _agreement(want)
    assert stats["matmul_mode"] == "w8a8" and stats["completed"] == 3
    _, dq = _logged("repro_torch.launch.serve",
                    lambda: TS.main(ARGS + ["--compare-float", "--device", "cpu"]))
    assert len(_agreement(dq)) == 1


def test_float_serve_tokens_match_reference(glm_smoke):
    """``--float-serve`` serves the float tree in ``dequant`` whatever the
    mode asked for; its tokens are the reference's float serve's."""
    from repro.launch import serve as JS
    from repro.serving import EngineConfig as JConfig

    cfg, jp = glm_smoke
    tp = params_from_numpy(jax_tree_to_numpy(jp), "cpu")

    def reqs(mod):
        return mod._make_requests(3, cfg.vocab, np.random.default_rng(0), 6)

    jd, _, _ = JS.serve_once(cfg, jp, reqs(JS), JConfig(max_batch=4, max_len=64))
    td, ts, _ = TS.serve_once(cfg, tp, reqs(TS), EngineConfig(max_batch=4, max_len=64),
                              device="cpu")
    assert sorted((r.uid, r.output) for r in td) == sorted((r.uid, r.output) for r in jd)
    stats, lines = _logged("repro_torch.launch.serve", lambda: TS.main(
        ARGS + ["--float-serve", "--matmul-mode", "w8a8", "--device", "cpu"]))
    assert stats["matmul_mode"] == "dequant" and stats["completed"] == 3
    assert not _agreement(lines) and stats["attn_step_ms"] > 0.0


def _alloc_state(a):
    """Every field of the page allocator: the free list in order, the
    refcounts, the prefix cache and its counters."""
    return (list(a._free), dict(a._ref), dict(a._page_of), a.prefix_hit_pages,
            a.prefix_lookup_pages, a.peak_in_use)


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_attn_probe_leaves_the_pool(glm_smoke, mode):
    """With ``attn_probe`` the stats carry a positive ``attn_step_ms``; the
    probe runs on a copy of layer 0's pool, so every live pool byte, the
    table, the positions and the allocator are as they were (mid-decode,
    with lanes holding pages). Off, or on an unpaged engine, it reads 0."""
    cfg, jp = glm_smoke
    q = quantize_params(params_from_numpy(jax_tree_to_numpy(jp), "cpu"),
                        QuantRecipe(**SERVE_RECIPE), device="cpu")
    kv = 8 if mode == "w8a8" else None
    eng = ServingEngine(cfg, q, EngineConfig(max_batch=3, max_len=64, matmul_mode=mode,
                                             kv_bits=kv, attn_probe=True), device="cpu")
    rng = np.random.default_rng(3)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, 9 + i).tolist(),
                           max_new_tokens=12))
    for _ in range(4):
        eng.step()
    assert any(s.req is not None for s in eng.slots)
    pools = [{k: t.clone() for k, t in layer["attn"].items()} for layer in eng.caches["layers"]]
    table, pos = eng.caches["table"].clone(), eng.caches["pos"].clone()
    alloc = _alloc_state(eng.allocator)
    st = eng.stats()
    assert st["attn_step_ms"] > 0.0
    for layer, old in zip(eng.caches["layers"], pools):
        for k, t in layer["attn"].items():
            assert torch.equal(t, old[k]), k
    assert torch.equal(eng.caches["table"], table) and torch.equal(eng.caches["pos"], pos)
    assert _alloc_state(eng.allocator) == alloc
    done = eng.run()
    assert len(done) == 3
    off = ServingEngine(cfg, q, EngineConfig(max_batch=3, max_len=64, matmul_mode=mode,
                                             kv_bits=kv), device="cpu")
    assert off.stats()["attn_step_ms"] == 0.0
    unpaged = ServingEngine(cfg, q, EngineConfig(max_batch=3, max_len=64, paged=False,
                                                 attn_probe=True), device="cpu")
    assert unpaged.attn_probe is False and unpaged.stats()["attn_step_ms"] == 0.0


def test_attn_probe_flag():
    from repro.serving import EngineConfig as JConfig

    assert EngineConfig().attn_probe is JConfig().attn_probe is False
    args = TS.build_parser().parse_args(["--attn-probe"])
    from repro_torch.serving import engine_config_from_args

    assert engine_config_from_args(args).attn_probe is True


def test_example_quickstart_cpu(capsys):
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "float ppl" in text and "serving tree" in text
    assert set(out) == {"float", "int8_weights", "w5 linear (no clip)", "w5 MSE clip",
                        "w5 OCS r=0.02 (paper)", "w5 OCS+MSE (paper best)"}
    assert all(np.isfinite(v) for v in out.values())
    assert out["float"] < 256  # trained below the uniform perplexity of its vocabulary


def test_example_serve_quantized_cpu(capsys):
    from repro_torch.examples import serve_quantized

    out = serve_quantized.main(["--device", "cpu", "--spec", "--inject-nan", "3"])
    text = capsys.readouterr().out
    assert len(out["streamed"]) == 8 and len(out["sampled"]) == 8
    assert "first token streamed with 3 lanes still busy" in text
    assert "quarantined" in text and "served 3/3 requests on hymba" in text
    assert "tokens committed per target step" in text


def test_example_calibrate_activations_cpu(tmp_path, capsys):
    """The walkthrough on a cached convnet (the reference's seeded init,
    carried across)."""
    import jax
    from repro.models import convnet as JCN
    from repro_torch.examples import calibrate_activations
    from repro_torch.experiments import common as TC

    jp = JCN.init_convnet(JCN.ConvNetConfig(n_classes=16), jax.random.PRNGKey(0))
    path = TC.Bench("cpu", out_dir=tmp_path).cache_path("convnet")
    path.parent.mkdir(parents=True)
    torch.save(params_from_numpy(jax_tree_to_numpy(jp), "cpu"), path)
    out = calibrate_activations.main(["--device", "cpu", "--out", str(tmp_path)])
    text = capsys.readouterr().out
    assert out["sites"] == 19 and "top outlier channels" in text
    assert list(out["rows"]) == ["no clip", "MSE clip", "static OCS r=0.02",
                                 "Oracle OCS (bs=8)"]
    assert all(0.0 <= v <= 100.0 for v in out["rows"].values())
