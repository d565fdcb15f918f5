"""Port parity, training: the data pipeline, AdamW and the gradients of the
three experiment subjects against the reference's on the same inputs.

* ``data.pipeline`` (``SyntheticLM``, ``make_batch_iterator``,
  ``CalibrationSampler``, ``DataState``) and ``make_synthetic_images``:
  bitwise, every (seed, step, shard) tried.
* ``cosine_schedule`` within 1e-6 relative; three ``adamw_update`` steps on
  the same gradients within ``ADAMW_RTOL`` (1e-6) of each leaf's largest
  magnitude.
* Losses and gradients (``torch.autograd`` against ``jax.value_and_grad``)
  of the convnet and the LSTM (float32: ``F32_RTOL``) and of the bench LM
  at 2 layers (float32 weights, bfloat16 activations: the loss within
  ``LM_LOSS_RTOL``, each gradient leaf within ``LM_GRAD_RTOL`` of its
  largest magnitude, ~1.7% seen: the bf16 roundings of the two packages
  part now and then). The reference's bf16 gradient runs on XLA:CPU.
* XLA's ``"SAME"`` padding of the convolutions, stride 1 and 2, on even
  and odd sizes, against ``lax.conv_general_dilated``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from functools import partial

from _torch_interop import jax_tree_to_numpy, torch_threads  # noqa: F401

from repro import data as JD
from repro.configs.base import ModelConfig as JMC
from repro.models import convnet as JCN
from repro.models import lstm as JLS
from repro.models import transformer as JT
from repro.optim import adamw as JAW

from repro_torch import data as TD
from repro_torch.configs.base import ModelConfig as TMC
from repro_torch.interop import params_from_numpy
from repro_torch.models import convnet as TCN
from repro_torch.models import lstm as TLS
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TAW

F32_RTOL = 1e-5  # float32 losses and gradients, of the largest magnitude
ADAMW_RTOL = 1e-6
LM_LOSS_RTOL = 1e-3
LM_GRAD_RTOL = 0.05
LM_KW = dict(name="bench-lm", block="dense", n_layers=2, d_model=128, n_heads=4,
             n_kv_heads=2, d_ff=256, vocab=512, attn_chunk=64, remat=False)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# Data


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_synthetic_lm_bitwise(seed, n_hosts):
    """Every shard of steps 0, 1, 50_000 and 60_000 bitwise the reference's;
    the chain coefficients and Zipf weights equal."""
    j = JD.SyntheticLM(512, 64, 16, seed=seed)
    t = TD.SyntheticLM(512, 64, 16, seed=seed)
    assert (t.a, t.b) == (j.a, j.b)
    np.testing.assert_array_equal(t.zipf_p, j.zipf_p)
    for step in (0, 1, 50_000, 60_000):
        for host in range(n_hosts):
            got = t.batch_at(step, host_id=host, n_hosts=n_hosts)
            want = j.batch_at(step, host_id=host, n_hosts=n_hosts)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_batch_iterator_state_and_calibration_bitwise():
    """``make_batch_iterator`` resumes exactly from a ``DataState`` (its
    dict round trip too), and ``CalibrationSampler`` replays the
    reference's training batches."""
    j = JD.SyntheticLM(128, 16, 4, seed=3)
    t = TD.SyntheticLM(128, 16, 4, seed=3)
    jit = JD.make_batch_iterator(j, JD.DataState(seed=3, step=5), host_id=1, n_hosts=2)
    tit = TD.make_batch_iterator(t, TD.DataState(seed=3, step=5), host_id=1, n_hosts=2)
    for _ in range(3):
        (js, jb), (ts, tb) = next(jit), next(tit)
        assert ts.to_dict() == js.to_dict()
        assert TD.DataState.from_dict(ts.to_dict()) == ts
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    for jb, tb in zip(JD.CalibrationSampler(j, 3, start_step=2),
                      TD.CalibrationSampler(t, 3, start_step=2)):
        np.testing.assert_array_equal(tb["labels"], jb["labels"])


@pytest.mark.parametrize("seed", [0, 777, 100_003])
def test_synthetic_images_bitwise(seed):
    jc = JCN.ConvNetConfig(n_classes=16, width=16, n_blocks=3, img=16)
    tc = TCN.ConvNetConfig(n_classes=16, width=16, n_blocks=3, img=16)
    want, got = JCN.make_synthetic_images(40, jc, seed), TCN.make_synthetic_images(40, tc, seed)
    for k in ("images", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shape", [(3, 3, 5, 7), (1, 1, 16, 32)])
def test_conv_matricization_bitwise(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(TCN.conv_w_to_2d(w), JCN.conv_w_to_2d(w))
    np.testing.assert_array_equal(TCN.conv_w_to_2d(torch.from_numpy(w)).numpy(),
                                  JCN.conv_w_to_2d(w))
    w2 = JCN.conv_w_to_2d(w)
    np.testing.assert_array_equal(TCN.conv_w_from_2d(w2, shape[:2], shape[3]), w)
    np.testing.assert_array_equal(
        TCN.conv_w_from_2d(torch.from_numpy(w2), shape[:2], shape[3]).numpy(), w)


# ---------------------------------------------------------------------------
# SAME padding


@pytest.mark.parametrize("size", [7, 8, 15, 16])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2), (1, 1)])
def test_same_padding_against_xla(size, k, stride):
    """The port's explicit ``F.pad`` + ``padding=0`` against XLA's
    ``"SAME"`` at stride 1 and 2 on even and odd sizes (at stride 2 on an
    even size XLA pads (0, 1), not (1, 1)): float32 within ``F32_RTOL``."""
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride),
                                        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = TCN._conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w), stride)
    got = got.permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= F32_RTOL


# ---------------------------------------------------------------------------
# AdamW


def test_cosine_schedule():
    for total, warm in ((400, 20), (100, 5), (7, 5)):
        for step in (0, 1, warm - 1, warm, warm + 1, total // 2, total - 1, total, total + 3):
            want = float(JAW.cosine_schedule(jnp.asarray(step, jnp.int32), 3e-3, warm, total))
            got = float(TAW.cosine_schedule(torch.tensor(step, dtype=torch.int32), 3e-3,
                                            warm, total))
            assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (total, step)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_three_steps(clip_norm):
    """Three steps on the same gradients (clipped by the global norm or
    not): params, m, v and the count within ``ADAMW_RTOL``; decay only on
    leaves with ndim >= 2."""
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32),
         "sub": {"k": rng.standard_normal((3, 4, 2)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, "cpu")
    js, ts = JAW.adamw_init(jp), TAW.adamw_init(tp)
    for step in range(3):
        g = {"w": rng.standard_normal((6, 5)).astype(np.float32) * 3,
             "b": rng.standard_normal(5).astype(np.float32),
             "sub": {"k": rng.standard_normal((3, 4, 2)).astype(np.float32)}}
        lr = float(JAW.cosine_schedule(js.count, 1e-2, 2, 10))
        jp, js = JAW.adamw_update(jax.tree.map(jnp.asarray, g), js, jp, lr=lr,
                                  weight_decay=0.01, clip_norm=clip_norm)
        tp, ts = TAW.adamw_update(params_from_numpy(g, "cpu"), ts, tp,
                                  lr=TAW.cosine_schedule(ts.count, 1e-2, 2, 10),
                                  weight_decay=0.01, clip_norm=clip_norm)
        assert int(ts.count) == int(js.count) == step + 1
        for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for (path, a), (_, b) in zip(_flat(tree_t), _flat(tree_j)):
                assert _rel(a, b) <= ADAMW_RTOL, (step, path)


# ---------------------------------------------------------------------------
# Losses and gradients


def _req(tree):
    if isinstance(tree, dict):
        return {k: _req(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _loss_and_grads(fn, tree, batch):
    tree = _req(tree)
    loss = fn(tree, batch)
    loss.backward()
    return loss, {p: t.grad for p, t in _flat(tree)}


def _compare(jfn, tfn, jparams, batch_np, loss_rtol, grad_rtol):
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    jl, jg = jax.value_and_grad(jfn)(jparams, jb)
    tl, tg = _loss_and_grads(tfn, params_from_numpy(jax_tree_to_numpy(jparams), "cpu"), tb)
    assert abs(float(tl.detach()) - float(jl)) <= loss_rtol * abs(float(jl))
    for path, g in _flat(jg):
        assert _rel(tg[path], g) <= grad_rtol, (path, _rel(tg[path], g))


@pytest.mark.parametrize("seed", [0, 1])
def test_convnet_loss_and_grads(seed):
    cfg = JCN.ConvNetConfig(n_classes=16, width=8, n_blocks=2, img=16)
    tcfg = TCN.ConvNetConfig(n_classes=16, width=8, n_blocks=2, img=16)
    params = JCN.init_convnet(cfg, jax.random.PRNGKey(seed))
    batch = JCN.make_synthetic_images(6, cfg, seed=seed + 5)
    _compare(partial(JCN.convnet_loss, cfg=cfg), partial(TCN.convnet_loss, cfg=tcfg), params,
             batch, F32_RTOL, F32_RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_loss_and_grads(seed):
    cfg, tcfg = JLS.LSTMConfig(vocab=96, hidden=32), TLS.LSTMConfig(vocab=96, hidden=32)
    params = JLS.init_lstm(cfg, jax.random.PRNGKey(seed))
    batch = JD.SyntheticLM(96, 12, 3, seed=seed).batch_at(0)
    _compare(partial(JLS.lstm_loss, cfg=cfg), partial(TLS.lstm_loss, cfg=tcfg), params,
             batch, F32_RTOL, F32_RTOL)


def test_lm_loss_and_grads():
    """The bench LM at 2 layers: float32 weights, bfloat16 activations."""
    jc, tc = JMC(**LM_KW), TMC(**LM_KW)
    params = JT.init_params(jc, jax.random.PRNGKey(2))
    batch = JD.SyntheticLM(512, 64, 2, seed=7).batch_at(0)
    _compare(partial(JT.loss_fn, cfg=jc), partial(TT.loss_fn, cfg=tc), params, batch,
             LM_LOSS_RTOL, LM_GRAD_RTOL)


def test_convnet_and_lstm_forward_shapes():
    """``convnet_forward`` and ``lstm_forward`` logits equal the
    reference's within ``F32_RTOL`` (the full subjects' configs)."""
    jc = JCN.ConvNetConfig(n_classes=16, width=16, n_blocks=3, img=16)
    tc = TCN.ConvNetConfig(n_classes=16, width=16, n_blocks=3, img=16)
    p = JCN.init_convnet(jc, jax.random.PRNGKey(0))
    x = JCN.make_synthetic_images(4, jc, seed=1)["images"]
    want = JCN.convnet_forward(p, jnp.asarray(x), jc)
    with torch.no_grad():
        got = TCN.convnet_forward(params_from_numpy(jax_tree_to_numpy(p), "cpu"),
                                  torch.from_numpy(x), tc)
    assert got.shape == want.shape and _rel(got, want) <= F32_RTOL
    jl, tl = JLS.LSTMConfig(vocab=512, hidden=160), TLS.LSTMConfig(vocab=512, hidden=160)
    p = JLS.init_lstm(jl, jax.random.PRNGKey(1))
    tok = JD.SyntheticLM(512, 64, 2, seed=11).batch_at(0)["tokens"]
    want = JLS.lstm_forward(p, jnp.asarray(tok), jl)
    with torch.no_grad():
        got = TLS.lstm_forward(params_from_numpy(jax_tree_to_numpy(p), "cpu"),
                               torch.from_numpy(tok), tl)
    assert got.shape == want.shape and _rel(got, want) <= F32_RTOL
