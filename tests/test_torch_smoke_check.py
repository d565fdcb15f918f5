"""The reference check of ``chip_smoke.py`` (card kernels vs CPU plain
versions on the smoke glm4-9b) can see a subtly wrong kernel.

Each case swaps one plain version for a faulty one and runs the check's
own forward (``chip_smoke.smoke_logits``: prefill, 4 teacher-forced
decode steps and a teacher-forced verify of 5 tokens) on the CPU; its
logits must part from the sound run by more than ``MODEL_RTOL`` of the
largest logit, while two sound runs agree exactly. Readings (this test,
CPU, seed 0), as shares of the largest logit:

* w8a8, int8 pages: sound 0; B1 rounding half to even 0.035; B2 masking
  the newest token 0.27. Faults of one float32 ulp in a scale (division
  instead of reciprocal form) read 0 here: the kernel phase's bitwise
  checks are what catch those.
* dequant, float32 pages: a sound B4 that sums in another order (float64
  sums, rounded once: what a card kernel's different f32 order stands for)
  reads 0 (no bf16 activation flips at this size); B4 dropping the OCS
  tail rows 0.55; B4 ignoring ``w_scale`` 426.
* w4a8, int4 pages: sound 0; B6 with an unfused epilogue (a product and
  an add, each rounded, in place of the fused multiply-add: one-ulp
  faults, which the kernel phase's bitwise checks catch) 0; B6 dropping
  the int8 outlier rows 1.03; B6 dropping the OCS tail 0.55; B2's int4
  branch masking the newest token 0.32.
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
from repro_torch.kernels import w4a8_qmatmul as tw4
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


@pytest.fixture(scope="module")
def smoke_w4a8():
    cs = _chip_smoke()
    cfg, qp = cs.smoke_model(0, kv_bits=4, w4a8=True)
    return cs, cfg, qp, cs.smoke_logits(qp, cfg, 0, "cpu", "w4a8")


_sound_b6 = tw4.w4a8_matmul_plain


def _b6_unfused_epilogue(x, w4, s4, w8, s8, src_tail, outlier_idx, *, bits=8,
                         out_dtype=None):
    """B6 whose epilogue rounds the product and the add apart."""
    q, a_s = tpa.quant_rows(x, 127.0)
    q_exp = torch.cat([q, q[:, src_tail.long()]], 1)
    acc4 = int8_matmul(q_exp, tpa.unpack_int4(w4.T).T).float()
    acc8 = int8_matmul(q_exp[:, outlier_idx.long()], w8).float()
    y = acc4 * (a_s[:, None] * s4[None, :]) + acc8 * (a_s[:, None] * s8[None, :])
    return y.to(out_dtype)


def _b6_outliers_dropped(x, w4, s4, w8, s8, src_tail, outlier_idx, **kw):
    return _sound_b6(x, w4, s4, w8[:0], s8, src_tail, outlier_idx[:0], **kw)


def _b6_tail_dropped(x, w4, s4, w8, s8, src_tail, outlier_idx, **kw):
    """B6 that leaves out the OCS duplicate rows (their int4 and int8
    weight rows zeroed)."""
    k = x.shape[1]
    wq = tpa.unpack_int4(w4.T).T.clone()
    wq[k:] = 0
    w8 = torch.where((outlier_idx >= k)[:, None], torch.zeros_like(w8), w8)
    return _sound_b6(x, tpa.pack_int4(wq.T).T.contiguous(), s4, w8, s8, src_tail,
                     outlier_idx, **kw)


def _w4a8_reading(cs, cfg, qp, base, monkeypatch, module, name, fault):
    monkeypatch.setattr(module, name, fault)
    got = cs.smoke_logits(qp, cfg, 0, "cpu", "w4a8")
    return float((got - base).abs().max() / base.abs().max())


def test_w4a8_sound_runs_agree_and_an_unfused_epilogue_is_within_limit(smoke_w4a8,
                                                                        monkeypatch):
    cs, cfg, qp, base = smoke_w4a8
    assert torch.equal(cs.smoke_logits(qp, cfg, 0, "cpu", "w4a8"), base)
    assert torch.isfinite(base).all()
    share = _w4a8_reading(cs, cfg, qp, base, monkeypatch, tw4, "w4a8_matmul_plain",
                          _b6_unfused_epilogue)
    print(f"w4a8, unfused B6 epilogue: {share:.4g} of the largest logit")
    assert share < cs.MODEL_RTOL


@pytest.mark.parametrize(
    "module,name,fault",
    [(tw4, "w4a8_matmul_plain", _b6_outliers_dropped),
     (tw4, "w4a8_matmul_plain", _b6_tail_dropped),
     (tpa, "paged_attention_plain", _b2_newest_masked)],
    ids=["b6-outliers-dropped", "b6-tail-dropped", "b2-int4-newest-token-masked"],
)
def test_reference_check_sees_w4a8_fault(smoke_w4a8, monkeypatch, module, name, fault):
    cs, cfg, qp, base = smoke_w4a8
    share = _w4a8_reading(cs, cfg, qp, base, monkeypatch, module, name, fault)
    print(f"w4a8, {fault.__name__}: {share:.4g} of the largest logit")
    assert share > cs.MODEL_RTOL


def test_ssm_phase_helpers_on_cpu():
    """The SSM and hybrid phases' reckoning: the quantized leaves of layer 0
    and the lm_head each model runs (mamba2-1.3b's lm_head is the tied
    float embedding), the launches of one decode step at full depth, a
    cut hymba keeping only its global layers below the cut, and the
    smoke-size reference forward giving the same logits twice on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.apply import quantize_params
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import transformer as T

    cs = _chip_smoke()
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True, pad_to=1)
    want = {"mamba2-1.3b": ["in_proj", "out_proj"],
            "hymba-1.5b": ["wq", "wk", "wv", "wo", "in_proj", "out_proj", "w_gate", "w_up",
                           "w_down", "lm_head"]}
    steps = {"mamba2-1.3b": 96, "hymba-1.5b": 289, "glm4-9b": 281}
    for arch, calls in steps.items():
        assert cs.matmuls_per_step(get_config(arch)) == calls
    for arch, names in want.items():
        cfg = smoke_config(arch)
        q = quantize_params(T.init_params(cfg, seed=0, device="cpu"), recipe, device="cpu")
        assert sorted(cs.layer_weights(q)) == sorted(names)
        a = cs.ssm_smoke_logits(q, cfg, 0, "cpu", "w8a8")
        assert a.shape == (40, 2, cfg.vocab) and torch.isfinite(a).all()
        assert torch.equal(cs.ssm_smoke_logits(q, cfg, 0, "cpu", "w8a8"), a)
    cut = cs.ssm_model("hymba-1.5b", 10)
    assert cut.n_layers == 10 and cut.hymba.global_layers == (0,)
    full = cs.ssm_model("hymba-1.5b", None)
    assert dataclasses.asdict(full) == dataclasses.asdict(get_config("hymba-1.5b"))
