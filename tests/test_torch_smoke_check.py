"""The reference check of ``chip_smoke.py`` (card kernels vs CPU plain
versions on the smoke glm4-9b) can see a subtly wrong kernel.

Each case swaps one plain version for a faulty one and runs the check's
own forward (``chip_smoke.smoke_logits``) on the CPU; its logits must part
from the sound run by more than ``MODEL_RTOL`` of the largest logit, while
two sound runs agree exactly. Readings (this test, CPU, seed 0): sound 0;
B1 rounding half to even 0.039; B2 masking the newest token 0.31. Faults
of one float32 ulp in a scale (division instead of reciprocal form) read 0
here: the kernel phase's bitwise checks are what catch those.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from _torch_interop import torch_threads  # noqa: F401

from repro_torch.kernels import fused_qmatmul as tfq
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels.ref import int8_matmul, inv_qmax

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    cs = _chip_smoke()
    cfg, qp = cs.smoke_model(0)
    return cs, cfg, qp, cs.smoke_logits(qp, cfg, 0, "cpu")


def _b1_round_half_even(x, w8, w_scale, src_tail, *, bits=8, out_dtype=None):
    """B1 with torch.round (ties to even) in place of floor(x/s + 1/2)."""
    xf = x.float()
    scale = xf.abs().amax(1).clamp_min(1e-30) * inv_qmax(127)
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127).to(torch.int8)
    q = torch.cat([q, q[:, src_tail.long()]], 1)
    acc = int8_matmul(q, w8)
    return (acc.float() * (scale[:, None] * w_scale.reshape(1, -1))).to(out_dtype)


_sound_b2 = tpa.paged_attention_plain


def _b2_newest_masked(pool, table, pos, q, k_new, v_new):
    """B2 appending the newest token but attending only up to pos - 1."""
    _, new_pool = _sound_b2(pool, table, pos, q, k_new, v_new)
    out, _ = _sound_b2(new_pool, table, pos - 1, q, k_new, v_new)
    return out, new_pool


def test_sound_runs_agree_exactly(smoke):
    cs, cfg, qp, base = smoke
    assert torch.equal(cs.smoke_logits(qp, cfg, 0, "cpu"), base)
    assert torch.isfinite(base).all()


@pytest.mark.parametrize(
    "module,name,fault",
    [(tfq, "fused_quant_matmul_plain", _b1_round_half_even),
     (tpa, "paged_attention_plain", _b2_newest_masked)],
    ids=["b1-round-half-even", "b2-newest-token-masked"],
)
def test_reference_check_sees_fault(smoke, monkeypatch, module, name, fault):
    cs, cfg, qp, base = smoke
    monkeypatch.setattr(module, name, fault)
    got = cs.smoke_logits(qp, cfg, 0, "cpu")
    assert (got - base).abs().max() > cs.MODEL_RTOL * base.abs().max()
