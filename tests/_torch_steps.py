"""Shared machinery of ``test_torch_steps.py`` and
``test_torch_steps_blocks.py``: three steps of the port's
``launch.steps.make_train_step`` against three of the reference's
``jax.jit(make_train_step(...))`` (outside ``use_rules``) from the same
weights and AdamW state, on ``SyntheticLM`` batches (the encoder: seeded
frame embeddings and the stream's labels), and the tolerances they are
held to.

A MoE model runs with the port's routing forced to the experts the
reference chose in its step (each flip the port would have made a
near-tie, ``ROUTE_TIE``); its capacity follows the microbatch's token
count, so the loss moves with ``n_micro`` in both packages.

Held: ``count`` and ``lr`` equal (``lr`` to float32 rounding), the loss
within ``LOSS_RTOL`` and the grad norm within ``GNORM_RTOL`` at every
step; after the third step each leaf of ``m`` within ``M_RTOL`` of its
largest magnitude (worst ~6.3% seen, phi3.5-moe's ``embed``), of ``v``
within ``V_RTOL`` (~12.1%, the same leaf); the parameters as a whole
within ``DELTA_RTOL`` of the reference's change, ``||p_port - p_ref|| /
||p_ref - p_init||`` over every weight (~1.3-4.1% seen), and each weight
within ``PARAM_TOL`` learning-rate units of the reference's: the largest
difference over the sum of the three steps' ``lr`` (~1.26 seen). Adam's
update ``m / sqrt(v)`` is about one in size even where a gradient is
near zero, so a bf16 rounding that flips such a gradient's sign moves
that weight by up to two updates a step (so the per-weight bound is
loose, and the whole tree's is the tight one); the moments, being sums
of gradients, part only as the gradients do (each within 5% of its
leaf's largest at equal weights, ``test_torch_grads.py``), plus what
three steps of slightly different weights add.
"""
import dataclasses

import numpy as np
import torch
import jax
import jax.numpy as jnp

from _torch_interop import ROUTE_TIE, forced_routing, jax_tree_to_numpy, recording_routes

from repro.configs import smoke_config as j_smoke
from repro.data import SyntheticLM
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw_init as j_adamw_init

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch import steps as TS
from repro_torch.optim import adamw_init

STEPS = 3
LOSS_RTOL = 2e-3
GNORM_RTOL = 0.02
LR_RTOL = 1e-6
M_RTOL = 0.1
V_RTOL = 0.2
PARAM_TOL = 2.0  # learning-rate units
DELTA_RTOL = 0.08
HYPER = dict(lr=3e-3, warmup=2, total_steps=10)


def flat(tree, path=()):
    """``[(path, leaf)]`` in ``jax.tree_util``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def as_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


def batches(cfg, n, b=4, s=32, seed=0):
    """``n`` seeded numpy batches: the synthetic stream's tokens and labels
    (the encoder: seeded frame embeddings with the stream's labels)."""
    ds = SyntheticLM(cfg.vocab, s, b, seed=seed)
    out = []
    for step in range(n):
        batch = ds.batch_at(step)
        if cfg.frontend == "audio":
            rng = np.random.default_rng(step)
            batch = {"embeds": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
                     "labels": batch["labels"]}
        out.append(batch)
    return out


def tree_delta(got, want, init) -> float:
    """``||got - want|| / ||want - init||`` over every parameter: ``got``
    the port's weights by path (``dict(flat(tree))``), ``want`` and
    ``init`` the reference's trees."""
    want, init = dict(flat(jax_tree_to_numpy(want))), dict(flat(jax_tree_to_numpy(init)))
    num = den = 0.0
    for path, leaf in got.items():
        w = np.asarray(want[path], np.float64)
        num += float(((as_np(leaf).astype(np.float64) - w) ** 2).sum())
        den += float(((w - init[path]) ** 2).sum())
    return (num / den) ** 0.5


def check_train_steps(arch, n_micro, grad_dtype, monkeypatch):
    """Run both packages' three steps and hold every quantity above."""
    cfg = j_smoke(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(t_smoke(arch))
    hyper = dict(HYPER, n_micro=n_micro, grad_dtype=grad_dtype)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    pt = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    ot = adamw_init(pt)
    pj, oj = params, j_adamw_init(params)
    data = batches(cfg, STEPS)

    routes = []
    jstep = jax.jit(JS.make_train_step(cfg, JS.TrainHyper(**hyper)))
    want = []
    with recording_routes(routes):
        for b in data:
            pj, oj, m = jstep(pj, oj, {k: jnp.asarray(v) for k, v in b.items()})
            want.append({k: float(v) for k, v in m.items()})
        jax.effects_barrier()
    moe = cfg.block == "moe"
    assert len(routes) == (STEPS * n_micro * cfg.n_layers if moe else 0)
    margins = []
    if moe:
        calls = forced_routing(monkeypatch, routes, margins)
    tstep = TS.make_train_step(t_smoke(arch), TS.TrainHyper(**hyper))
    got = []
    for b in data:
        pt, ot, m = tstep(pt, ot, {k: torch.as_tensor(v) for k, v in b.items()})
        got.append({k: float(v) for k, v in m.items()})
    if moe:
        assert next(calls, None) is None
        assert all(m <= ROUTE_TIE for m in margins), margins

    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"]), (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= GNORM_RTOL * w["grad_norm"], (g, w)
        assert abs(g["lr"] - w["lr"]) <= LR_RTOL * max(w["lr"], 1e-30), (g, w)
    assert int(ot.count) == int(oj.count) == STEPS
    lr_sum = sum(w["lr"] for w in want)
    assert tree_delta(dict(flat(pt)), pj, params) <= DELTA_RTOL
    bad = {}
    for name, tree_t, tree_j, tol in (("params", pt, pj, PARAM_TOL), ("m", ot.m, oj.m, M_RTOL),
                                      ("v", ot.v, oj.v, V_RTOL)):
        tj = dict(flat(jax_tree_to_numpy(tree_j)))
        assert sorted(tj) == [p for p, _ in flat(tree_t)]
        for path, leaf in flat(tree_t):
            assert leaf.dtype == torch.float32 and leaf.shape == tj[path].shape, path
            assert torch.isfinite(leaf).all(), path
            d = np.abs(as_np(leaf) - tj[path].astype(np.float64)).max()
            e = d / lr_sum if name == "params" else d / max(np.abs(tj[path]).max(), 1e-30)
            if not e <= tol:
                bad[(name, path)] = e
    assert not bad, bad
    return got
