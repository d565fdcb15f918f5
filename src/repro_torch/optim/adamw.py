"""AdamW with cosine schedule, global-norm clipping, f32 state (the port of
``repro.optim.adamw``).

Functional, like the reference: :func:`adamw_update` takes the gradients,
the state and the parameters (nested dicts of tensors, the port's trees)
and returns new parameters and a new state, so two implementations can be
compared step by step. The state holds float32 ``m`` and ``v`` trees shaped
like the parameters and an int32 step count, all on the parameters'
device; nothing is read back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule", "global_norm",
           "tree_map", "tree_leaves"]


def tree_leaves(tree):
    """The tensors of a nested dict/list tree, dict keys sorted (the order
    ``jax.tree_util`` visits them in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (shaped alike), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    m: object  # tree like params (f32)
    v: object  # tree like params (f32)
    count: torch.Tensor  # scalar int32


def adamw_init(params) -> AdamWState:
    dev = tree_leaves(params)[0].device
    return AdamWState(
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def global_norm(tree) -> torch.Tensor:
    sq = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def cosine_schedule(step: torch.Tensor, base_lr: float, warmup: int, total: int) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``, in float32 (the reference's arithmetic)."""
    step = step.to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)


def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Tuple[object, AdamWState]:
    """One AdamW step: gradients clipped to ``clip_norm`` by their global
    norm, bias-corrected moments, decoupled weight decay on leaves with
    ``ndim >= 2`` only. ``lr`` is a float or a scalar tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
    count = state.count + 1
    c = count.to(torch.float32)
    m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, grads)
    v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, state.v, grads)
    mhat_s = 1.0 / (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c))
    vhat_s = 1.0 / (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c))

    def upd(p, mm, vv):
        u = (mm * mhat_s) / (torch.sqrt(vv * vhat_s) + eps)
        pf = p.detach().to(torch.float32)
        step = u + weight_decay * pf if p.ndim >= 2 else u
        return (pf - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, AdamWState(m=m, v=v, count=count)
