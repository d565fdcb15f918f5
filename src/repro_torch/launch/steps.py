"""Train, serve and prefill step functions (the port of
``repro.launch.steps``): plain functions on the port's trees.

``make_train_step`` — forward + backward (``torch.autograd`` through
``transformer.loss_fn``, every block kind) + AdamW, with microbatch
gradient accumulation in the reference's order: the batch is reshaped to
``[n_micro, B / n_micro, ...]``, each microbatch's gradients are cast to
the gradient dtype and added to a running sum of that dtype in
microbatch order, and the sum is multiplied by ``gdt(1 / n_micro)``. A
MoE layer's capacity follows each microbatch's own token count, so the
loss depends on ``n_micro`` there, as in the reference. ``grad_dtype
="bfloat16"`` is the reference's compressed-collective format; on one
device it only rounds the gradients (the optimizer stays float32).

``make_serve_step`` — one greedy token against the decode caches, on a
float or quantized tree.

``make_prefill_step`` — the full-sequence forward's last-position logits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..optim import adamw_update, cosine_schedule, global_norm
from ..optim.adamw import tree_leaves, tree_map

__all__ = ["TrainHyper", "make_train_step", "make_serve_step", "make_prefill_step",
           "value_and_grad"]


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    n_micro: int = 1  # gradient-accumulation microbatches
    grad_dtype: str = "float32"  # 'bfloat16' rounds the gradients to bf16
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def value_and_grad(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """``(loss, grads)`` of ``transformer.loss_fn`` at ``params`` (a float
    tree), the counterpart of ``jax.value_and_grad``: ``grads`` is shaped
    like ``params``, a leaf the loss does not reach gets zeros."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = T.loss_fn(leaves, batch, cfg)
    flat = tree_leaves(leaves)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(t): g for t, g in zip(flat, got)}
    grads = tree_map(lambda t: by_id[id(t)] if by_id[id(t)] is not None
                     else torch.zeros_like(t), leaves)
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, hyper: TrainHyper):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``metrics`` holds ``loss``, ``grad_norm`` (of the cast
    gradients) and ``lr`` (the schedule at the step count before the
    update) as scalar tensors. The step writes the new parameters and
    optimizer state into the tensors it was given and returns those trees
    (the reference's launcher donates them to its jitted step): a
    full-width tree is held once, with its gradients and moments, not
    twice. A caller that needs the old values keeps a copy."""
    gdt = torch.bfloat16 if hyper.grad_dtype == "bfloat16" else torch.float32

    def train_step(params, opt_state, batch):
        if hyper.n_micro > 1:
            micro = {k: v.reshape((hyper.n_micro, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt, device=p.device), params)
            dev = micro["labels"].device
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(hyper.n_micro):
                li, gi = value_and_grad(cfg, params, {k: v[i] for k, v in micro.items()})
                gsum = tree_map(lambda a, g: a + g.to(gdt), gsum, gi)
                lsum = lsum + li
                del gi  # one microbatch's gradients alive at a time
            scale = 1.0 / hyper.n_micro
            gscale = torch.tensor(scale, dtype=gdt, device=dev)
            grads = tree_map(lambda g: g.to(gdt) * gscale, gsum)
            loss = lsum * scale
        else:
            loss, grads = value_and_grad(cfg, params, batch)
            grads = tree_map(lambda g: g.to(gdt), grads)

        lr = cosine_schedule(opt_state.count, hyper.lr, hyper.warmup, hyper.total_steps)
        gnorm = global_norm(grads)
        new_params, new_opt = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=hyper.weight_decay,
            clip_norm=hyper.clip_norm, inplace=True,
        )
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_serve_step(cfg: ModelConfig, *, mode: str = "dequant"):
    def serve_step(params, caches, token):
        """token: ``[B, 1]`` -> (next token ``[B, 1]`` int32, logits ``[B,
        V]``, new caches)."""
        logits, new_caches = T.decode_step(params, token, caches, cfg, mode=mode)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, new_caches

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, mode: str = "dequant"):
    def prefill_step(params, batch):
        logits = T.forward(params, batch.get("tokens"), cfg, mode=mode,
                           embeds=batch.get("embeds"))
        return logits[:, -1, :]

    return prefill_step
