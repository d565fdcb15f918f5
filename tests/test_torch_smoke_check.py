"""The reference check of ``chip_smoke.py`` (card kernels vs CPU plain
versions on the smoke glm4-9b) can see a subtly wrong kernel.

Each case swaps one plain version for a faulty one and runs the check's
own forward (``chip_smoke.smoke_logits``) on the CPU; its logits must part
from the sound run by more than ``MODEL_RTOL`` of the largest logit, while
two sound runs agree exactly. Readings (this test, CPU, seed 0), as shares
of the largest logit:

* w8a8, int8 pages: sound 0; B1 rounding half to even 0.039; B2 masking
  the newest token 0.31. Faults of one float32 ulp in a scale (division
  instead of reciprocal form) read 0 here: the kernel phase's bitwise
  checks are what catch those.
* dequant, float32 pages: a sound B4 that sums in another order (float64
  sums, rounded once: what a card kernel's different f32 order stands for)
  reads 0 (no bf16 activation flips at this size); B4 dropping the OCS
  tail rows 0.62; B4 ignoring ``w_scale`` 389.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from _torch_interop import torch_threads  # noqa: F401

from repro_torch.kernels import fused_qmatmul as tfq
from repro_torch.kernels import ocs_matmul as tom
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
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


@pytest.fixture(scope="module")
def smoke_dequant():
    cs = _chip_smoke()
    cfg, qp = cs.smoke_model(0, kv_bits=None)
    return cs, cfg, qp, cs.smoke_logits(qp, cfg, 0, "cpu", "dequant")


_sound_b4 = tom.ocs_quant_matmul_plain


def _b4_f64_sums(x, w8, w_scale, src_tail, x_scale=None, tail_mult=None, *,
                 tail_is_mask=False, out_dtype=None):
    """A sound B4 summing in float64 (each output rounded once to f32)."""
    tail = x[:, src_tail.long()].double() * tail_mult.double()
    acc = (torch.cat([x.double(), tail], 1) @ w8.double()).float()
    return (acc * w_scale.reshape(1, -1)).to(out_dtype or x.dtype)


def _b4_tail_dropped(x, w8, w_scale, src_tail, x_scale=None, tail_mult=None, *,
                     tail_is_mask=False, out_dtype=None):
    """B4 that leaves out the OCS duplicate rows."""
    return tqm.quant_matmul_plain(x, w8[: x.shape[1]], w_scale, x_scale, out_dtype=out_dtype)


def _b4_w_scale_ignored(x, w8, w_scale, src_tail, x_scale=None, tail_mult=None, **kw):
    return _sound_b4(x, w8, torch.ones_like(w_scale), src_tail, x_scale, tail_mult, **kw)


def _reading(cs, cfg, qp, base, monkeypatch, fault):
    monkeypatch.setattr(tom, "ocs_quant_matmul_plain", fault)
    got = cs.smoke_logits(qp, cfg, 0, "cpu", "dequant")
    return float((got - base).abs().max() / base.abs().max())


def test_dequant_sound_runs_agree_and_another_order_is_within_limit(smoke_dequant,
                                                                     monkeypatch):
    cs, cfg, qp, base = smoke_dequant
    assert torch.equal(cs.smoke_logits(qp, cfg, 0, "cpu", "dequant"), base)
    assert torch.isfinite(base).all()
    share = _reading(cs, cfg, qp, base, monkeypatch, _b4_f64_sums)
    print(f"dequant, float64 sums: {share:.4g} of the largest logit")
    assert share < cs.MODEL_RTOL


@pytest.mark.parametrize("fault", [_b4_tail_dropped, _b4_w_scale_ignored],
                         ids=["b4-tail-dropped", "b4-w-scale-ignored"])
def test_reference_check_sees_dequant_fault(smoke_dequant, monkeypatch, fault):
    cs, cfg, qp, base = smoke_dequant
    share = _reading(cs, cfg, qp, base, monkeypatch, fault)
    print(f"{fault.__name__}: {share:.4g} of the largest logit")
    assert share > cs.MODEL_RTOL
