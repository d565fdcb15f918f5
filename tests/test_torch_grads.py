"""Port parity, gradients: ``torch.autograd`` through the port's
``transformer.loss_fn`` against ``jax.value_and_grad`` of the reference's,
on the same numpy weights and batch, for every smoke config: the dense
decoders, qwen2-vl's M-RoPE, the two MoE models, mamba2's SSD scan, hymba
(meta tokens, window and global layers, the fused SSM heads) and the
hubert encoder (LayerNorm, GELU, unmasked attention, frame embeddings).

The loss within ``LOSS_RTOL``; every gradient leaf within ``GRAD_RTOL`` of
that leaf's largest |grad| (bfloat16 activations: the two packages' bf16
roundings part now and then; worst ~2.8% seen, hymba's ``ssm/D``).
A MoE model runs with the port's routing forced to the reference's
experts (``forced_routing``): a routing flip moves every leaf downstream
of it (13% on deepseek-moe-16b's ``experts/w_up`` with the port's own
routing, ~2% forced), and each flip the port would have made is a
near-tie (``ROUTE_TIE``).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import (ROUTE_TIE, forced_routing, jax_tree_to_numpy,  # noqa: F401
                            recording_routes, torch_threads)
from _torch_steps import flat

from repro.configs import list_archs
from repro.configs import smoke_config as j_smoke
from repro.models import transformer as JT

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import transformer as TT

LOSS_RTOL = 2e-3
GRAD_RTOL = 0.05  # a leaf's max |Δgrad| over its max |grad|


def smoke_batch(cfg, b=2, s=40, seed=0):
    """Seeded numpy inputs: tokens, or frame embeddings for the audio
    frontend; labels."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return batch


def rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_value_and_grad(arch, monkeypatch):
    cfg = j_smoke(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(t_smoke(arch))
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    batch = smoke_batch(cfg)
    routes = []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with recording_routes(routes):
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, bb: JT.loss_fn(p, bb, cfg, scan=False)))(params, jb)
        jax.effects_barrier()
    moe = cfg.block == "moe"
    assert len(routes) == (cfg.n_layers if moe else 0)
    margins = []
    if moe:
        calls = forced_routing(monkeypatch, routes, margins)
    pt = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    got_loss, got = value_and_grad(t_smoke(arch), pt,
                                   {k: torch.as_tensor(v) for k, v in batch.items()})
    if moe:
        assert next(calls, None) is None
        assert all(m <= ROUTE_TIE for m in margins), margins
    assert abs(float(got_loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    got_flat = dict(flat(got))
    want_flat = flat(jax_tree_to_numpy(want))
    assert sorted(got_flat) == [k for k, _ in want_flat]
    errs = {}
    for path, w in want_flat:
        g = got_flat[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        assert torch.isfinite(g).all(), path
        errs[path] = rel_err(g, w)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-moe-16b", "mamba2-1.3b",
                                  "hymba-1.5b"])
def test_remat_gives_the_same_gradients(arch):
    """``cfg.remat`` (the full configs' default; the smoke configs turn it
    off) keeps only each layer's input for the backward and runs the layer
    again there: the loss and every gradient bitwise those without it
    (the MoE block routes again, to the same experts)."""
    cfg = t_smoke(arch)
    params = TT.init_params(cfg, seed=1, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in smoke_batch(cfg, seed=2).items()}
    outs = {}
    for remat in (False, True):
        outs[remat] = value_and_grad(dataclasses.replace(cfg, remat=remat), params, batch)
    assert torch.equal(outs[True][0], outs[False][0])
    for (path, a), (_, b) in zip(flat(outs[True][1]), flat(outs[False][1])):
        assert torch.equal(a, b), path
