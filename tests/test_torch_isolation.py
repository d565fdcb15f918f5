"""Port isolation: ``repro_torch`` and ``chip_smoke.py`` import neither JAX
nor the JAX package, the entry points refuse to run on the CPU unless asked
to, and a kernel wrapper never answers a CUDA request with its plain
version.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_interop import torch_threads  # noqa: F401

from repro_torch.configs import smoke_config
from repro_torch.core.apply import quantize_params
from repro_torch.core.recipe import QuantRecipe
from repro_torch.kernels import dynamic_quant as tdq
from repro_torch.kernels import fused_qmatmul as tfq
from repro_torch.kernels import ocs_matmul as tom
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import w4a8_qmatmul as tw4
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _all_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_imports_without_jax_or_repro():
    """Every repro_torch module and chip_smoke.py import with JAX blocked
    (``sys.modules["jax"] = None`` makes any ``import jax`` raise), and no
    module of the JAX package gets loaded."""
    mods = _all_modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) > 20
    assert "repro_torch.serving.spec_decode" in mods
    for m in ("repro_torch.serving.sampling", "repro_torch.serving.scheduler",
              "repro_torch.runtime.health", "repro_torch.obs", "repro_torch.obs.log",
              "repro_torch.obs.metrics", "repro_torch.obs.trace", "repro_torch.obs.drift",
              "repro_torch.core.tap", "repro_torch.serving.router",
              "repro_torch.serving.chaos", "repro_torch.models.moe",
              "repro_torch.configs.deepseek_moe_16b", "repro_torch.configs.phi35_moe_42b",
              "repro_torch.models.ssm", "repro_torch.configs.mamba2_1p3b",
              "repro_torch.configs.hymba_1p5b", "repro_torch.configs.qwen2_vl_7b",
              "repro_torch.configs.minitron_8b", "repro_torch.configs.hubert_xlarge",
              "repro_torch.core.allocate", "repro_torch.data.pipeline",
              "repro_torch.optim.adamw", "repro_torch.models.convnet",
              "repro_torch.models.lstm", "repro_torch.experiments.common",
              "repro_torch.experiments.table1", "repro_torch.experiments.table2",
              "repro_torch.experiments.table5", "repro_torch.experiments.table6",
              "repro_torch.experiments.table7", "repro_torch.experiments.run",
              "repro_torch.launch.quality_eval"):
        assert m in mods
    code = (
        "import sys, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "bad = sorted(k for k in sys.modules if k == 'repro' or k.startswith('repro.')"
        " or (k.startswith('jax') and sys.modules[k] is not None))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_no_import_statement_names_jax_or_repro():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            assert not pat.match(line), f"{p}:{i}: {line}"


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """Without ``device="cpu"`` the entry points want the card; with no
    card they raise instead of running on the CPU."""
    _no_gpu(monkeypatch)
    cfg = smoke_config("glm4-9b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, seed=0)
    params = T.init_params(cfg, seed=0, device="cpu")
    recipe = QuantRecipe(w_bits=8, ocs_ratio=0.02, per_channel=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_params(params, recipe)
    q = quantize_params(params, recipe, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, q, EngineConfig(max_len=64))
    from repro_torch.serving.spec_decode import SpecConfig

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, q, EngineConfig(max_len=64, spec=SpecConfig(k=3)))
    ServingEngine(cfg, q, EngineConfig(max_len=64, spec=SpecConfig(k=3)), device="cpu")
    from repro_torch.serving import ReplicaSet

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaSet.build(cfg, q, EngineConfig(max_len=64), 2)
    ReplicaSet.build(cfg, q, EngineConfig(max_len=64), 2, device="cpu")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "glm4-9b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "glm4-9b", "--smoke", "--replicas", "2"])


def test_experiment_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """The experiments' and the gate's entry points (the subjects' inits,
    the bench, ``experiments.run``, ``launch.quality_eval``) want the card
    unless given ``device="cpu"``; with no card they raise."""
    _no_gpu(monkeypatch)
    from repro_torch.experiments import common, run
    from repro_torch.launch import quality_eval
    from repro_torch.models import convnet, lstm

    for fn in (lambda: convnet.init_convnet(common.CONV_CFG, seed=0),
               lambda: lstm.init_lstm(common.LSTM_CFG, seed=0),
               lambda: common.init_subject("lm"), lambda: common.Bench(),
               lambda: run.main(["--only", "table5", "--out", str(tmp_path)]),
               lambda: quality_eval.main(["--quick", "--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert not (tmp_path / "cache").exists()
    convnet.init_convnet(common.CONV_CFG, seed=0, device="cpu")
    common.Bench("cpu", out_dir=tmp_path)


def test_ops_refuse_devices_without_a_kernel():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_quant_matmul(x, x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_attention({}, x, x, x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        ops.ocs_quant_matmul(x, x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        ops.quant_matmul(x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        ops.dynamic_quant(x)
    with pytest.raises(ValueError, match="no kernel"):
        ops.w4a8_matmul(x, x, x, x, x, x, x)


def test_cuda_request_never_gets_the_plain_result(monkeypatch):
    """Tensors that claim to be CUDA (the device check mocked) reach the
    CUDA wrapper, which raises here (no card, no nvcc): the plain version
    is never substituted."""
    monkeypatch.setattr(ops, "_device_kind", lambda t: "cuda")
    plain_calls = []
    monkeypatch.setattr(tfq, "fused_quant_matmul_plain",
                        lambda *a, **k: plain_calls.append(1))
    monkeypatch.setattr(tpa, "paged_attention_plain",
                        lambda *a, **k: plain_calls.append(1))
    for mod, name in ((tom, "ocs_quant_matmul_plain"), (tqm, "quant_matmul_plain"),
                      (tdq, "dynamic_quant_plain")):
        monkeypatch.setattr(mod, name, lambda *a, **k: plain_calls.append(1))
    mods = (tfq, tpa, tom, tqm, tdq)
    launches0 = [m.launches for m in mods]
    x = torch.zeros((2, 8))
    w8 = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises((ValueError, RuntimeError)):
        ops.fused_quant_matmul(x, w8, torch.ones(4), torch.zeros(0, dtype=torch.int32))
    for xx in (x, x.to(torch.int8)):
        with pytest.raises((ValueError, RuntimeError)):
            ops.quant_matmul(xx, w8, torch.ones(4))
        for s in (0, 2):  # S == 0 routes to quant_matmul's wrapper
            with pytest.raises((ValueError, RuntimeError)):
                ops.ocs_quant_matmul(xx[:, : 8 - s], w8, torch.ones(4),
                                     torch.zeros(s, dtype=torch.int32))
    with pytest.raises((ValueError, RuntimeError)):
        ops.dynamic_quant(x)
    pool = {"k": torch.zeros((2, 1, 4, 8)), "v": torch.zeros((2, 1, 4, 8))}
    q = torch.zeros((1, 1, 2, 8))
    kn = torch.zeros((1, 1, 1, 8))
    with pytest.raises((ValueError, RuntimeError)):
        ops.paged_attention(pool, torch.zeros((1, 1), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32), q, kn, kn)
    assert not plain_calls
    assert [m.launches for m in mods] == launches0  # refusals launch nothing


def test_cuda_w4a8_request_never_gets_the_plain_result(monkeypatch):
    """The W4A8 tier's two kernels: tensors that claim to be CUDA reach
    B6's CUDA wrapper and B2's on an int4 pool, which raise here; neither
    plain version runs and nothing launches."""
    monkeypatch.setattr(ops, "_device_kind", lambda t: "cuda")
    plain_calls = []
    monkeypatch.setattr(tw4, "w4a8_matmul_plain", lambda *a, **k: plain_calls.append(1))
    monkeypatch.setattr(tpa, "paged_attention_plain", lambda *a, **k: plain_calls.append(1))
    launches0 = (tw4.launches, tpa.launches)
    x = torch.zeros((2, 8))
    w4 = torch.zeros((4, 4), dtype=torch.uint8)
    i32 = torch.zeros(0, dtype=torch.int32)
    for t in (0, 2):
        with pytest.raises((ValueError, RuntimeError)):
            ops.w4a8_matmul(x, w4, torch.ones(4), torch.zeros((t, 4), dtype=torch.int8),
                            torch.ones(4), i32, torch.arange(t, dtype=torch.int32))
    pool = {"k": torch.zeros((2, 1, 4, 4), dtype=torch.uint8),
            "v": torch.zeros((2, 1, 4, 4), dtype=torch.uint8),
            "k_scale": torch.zeros((2, 1, 4)), "v_scale": torch.zeros((2, 1, 4))}
    kn = torch.zeros((1, 1, 1, 8), dtype=torch.bfloat16)
    with pytest.raises((ValueError, RuntimeError)):
        ops.paged_attention(pool, torch.ones((1, 1), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros((1, 1, 2, 8), dtype=torch.bfloat16), kn, kn)
    assert not plain_calls
    assert (tw4.launches, tpa.launches) == launches0


def test_dense_refuses_unported_modes():
    """``dense`` takes the mode as an argument: ``w4a8`` on an int8 leaf
    raises ``ValueError`` naming ``to_w4a8`` (the W4A8 leaf it converts to
    serves there, and only there); a mode it does not know raises; float
    weights ignore the mode."""
    from repro_torch.core.ocs import to_w4a8

    cfg = smoke_config("glm4-9b")
    params = T.init_params(cfg, seed=0, device="cpu")
    q = quantize_params(params, QuantRecipe(w_bits=8, ocs_ratio=0.02, per_channel=True),
                        device="cpu")
    w = q["lm_head"]
    x = torch.zeros((1, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="to_w4a8"):
        layers.dense(w, x, mode="w4a8")
    with pytest.raises(ValueError, match="matmul mode"):
        layers.dense(w, x, mode="int4")
    w4 = to_w4a8(w, 0.05)
    for mode in layers.MODES:
        leaf = w4 if mode == "w4a8" else w
        assert layers.dense(leaf, x, mode=mode).shape == (1, cfg.vocab)
    with pytest.raises(ValueError, match="'w4a8'"):
        layers.dense(w4, x, mode="w8a8")
    assert torch.equal(layers.dense(params["lm_head"], x, mode="w4a8"),
                       x @ params["lm_head"].to(x.dtype))


def test_unported_modes_raise_at_engine_construction():
    """The A9 policies (optimistic admission, budgeted chunked prefill)
    construct and serve; a model with qwen2-vl's M-RoPE constructs and
    serves, and an encoder raises the reference's ``ValueError``; the A12
    tier (``matmul_mode="w4a8"``, ``kv_bits=4``) constructs, converting the
    int8 leaves once."""
    import dataclasses

    from repro_torch.core.ocs import W4A8Linear
    from repro_torch.serving import Request

    cfg = smoke_config("glm4-9b")
    params = T.init_params(cfg, seed=0, device="cpu")
    for kw in (dict(matmul_mode="w8a8", admission="optimistic"),
               dict(matmul_mode="w8a8", prefill_budget=64)):
        eng = ServingEngine(cfg, params, EngineConfig(max_len=64, page_size=16, **kw),
                            device="cpu")
        eng.submit(Request(uid=0, prompt=list(range(1, 21)), max_new_tokens=3))
        (r,) = eng.run()
        assert r.finish_reason == "length" and len(r.output) == 3
        assert eng.stats()["kv_pages_in_use"] == 0.0
    eng = ServingEngine(dataclasses.replace(cfg, mrope_sections=(2, 3, 3)), params,
                        EngineConfig(max_len=64), device="cpu")
    eng.submit(Request(uid=0, prompt=list(range(1, 21)), max_new_tokens=3))
    (r,) = eng.run()
    assert r.finish_reason == "length" and len(r.output) == 3
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(dataclasses.replace(cfg, causal=False), params,
                      EngineConfig(max_len=64), device="cpu")
    q = quantize_params(params, QuantRecipe(w_bits=8, ocs_ratio=0.02, per_channel=True),
                        device="cpu")
    for kw in (dict(matmul_mode="w4a8"), dict(matmul_mode="w8a8", kv_bits=4),
               dict(matmul_mode="w4a8", kv_bits=4)):
        eng = ServingEngine(cfg, q, EngineConfig(max_len=64, **kw), device="cpu")
        assert isinstance(eng.params["lm_head"], W4A8Linear) == (kw["matmul_mode"] == "w4a8")
        assert (eng.caches["layers"][0]["attn"]["k"].dtype == torch.uint8) == ("kv_bits" in kw)
    with pytest.raises(ValueError, match="w4a8_outlier_ratio"):
        EngineConfig(w4a8_outlier_ratio=1.5)


def test_launch_serve_smoke_on_cpu(capsys):
    """``launch.serve`` end to end at smoke size on the plain path."""
    from repro_torch.launch import serve

    stats = serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                        "--matmul-mode", "w8a8", "--kv-bits", "8",
                        "--n-requests", "3", "--max-new", "4", "--max-len", "64"])
    assert stats["completed"] == 3
    assert stats["decoded_tokens"] == 3 * 3  # the first token comes from prefill
    assert stats["kv_bits"] == 8.0


@pytest.mark.parametrize("extra", [[], ["--ocs-ratio", "0"]], ids=["default", "clip-only"])
def test_launch_serve_defaults_on_cpu(extra):
    """With no ``--matmul-mode`` the launcher serves the engine default,
    ``dequant`` on float32 pages; ``--ocs-ratio 0`` serves the clip-only
    tree."""
    from repro_torch.launch import serve

    stats = serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                        "--n-requests", "3", "--max-new", "4", "--max-len", "64", *extra])
    assert stats["completed"] == 3 and stats["errors"] == 0
    assert stats["matmul_mode"] == "dequant" and stats["kv_bits"] == 0.0


def test_launch_serve_w4a8_int4_on_cpu():
    """``launch.serve`` serves the sub-8-bit tier (W4A8 weights, int4 KV
    pages) end to end at smoke size on the plain path."""
    from repro_torch.launch import serve

    stats = serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                        "--matmul-mode", "w4a8", "--kv-bits", "4",
                        "--w4a8-outlier-ratio", "0.1",
                        "--n-requests", "3", "--max-new", "4", "--max-len", "64"])
    assert stats["completed"] == 3 and stats["errors"] == 0
    assert stats["matmul_mode"] == "w4a8" and stats["kv_bits"] == 4.0
