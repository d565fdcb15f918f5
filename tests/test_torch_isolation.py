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
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "glm4-9b", "--smoke"])


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


def test_dense_refuses_unported_modes():
    """``dense`` takes the mode as an argument: ``w4a8`` names its ROADMAP
    item; a mode it does not know raises; float weights ignore the mode."""
    cfg = smoke_config("glm4-9b")
    params = T.init_params(cfg, seed=0, device="cpu")
    q = quantize_params(params, QuantRecipe(w_bits=8, ocs_ratio=0.02, per_channel=True),
                        device="cpu")
    w = q["lm_head"]
    x = torch.zeros((1, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A12"):
        layers.dense(w, x, mode="w4a8")
    with pytest.raises(ValueError, match="matmul mode"):
        layers.dense(w, x, mode="int4")
    for mode in layers.MODES:
        assert layers.dense(w, x, mode=mode).shape == (1, cfg.vocab)
    assert torch.equal(layers.dense(params["lm_head"], x, mode="w4a8"),
                       x @ params["lm_head"].to(x.dtype))


def test_unported_modes_raise_at_engine_construction():
    cfg = smoke_config("glm4-9b")
    params = T.init_params(cfg, seed=0, device="cpu")
    for kw, item in (
        (dict(matmul_mode="w4a8"), "A12"),
        (dict(matmul_mode="w8a8", admission="optimistic"), "A9"),
        (dict(matmul_mode="w8a8", prefill_budget=64), "A9"),
        (dict(matmul_mode="w8a8", kv_bits=4), "A12"),
    ):
        with pytest.raises(NotImplementedError, match=item):
            ServingEngine(cfg, params, EngineConfig(max_len=64, **kw), device="cpu")


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
