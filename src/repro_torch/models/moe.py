"""Mixture-of-Experts block: top-k routing, capacity, sort-based dispatch,
the expert SwiGLU and the gated combine, and the fused shared experts (the
port of ``repro.models.moe``, single-device path).

Dispatch is sort-based with per-expert capacity, as in the reference: each
(token, expert) assignment is ranked within its expert by a stable sort,
assignments past the expert's capacity are dropped, the kept tokens are
scattered into an ``[E, C, d]`` buffer (empty slots are zero rows), every
expert's SwiGLU runs on its ``[C, d]`` slice, and the outputs are combined
back with the routing gates. The expert matmuls are one ``layers.dense``
call per stacked matrix: on the card one kernel launch covers all E
experts (the counterpart of the reference's ``jax.vmap`` over the expert
stack, which puts an expert axis on the Pallas kernels' grid).

The router stays float32 (the recipe skips ``router``); the expert and
shared matrices are quantized per slice. The reference's shard_map path
(``_moe_sharded``, ``_shardmap_axes``, ``_pack_experts``) partitions
experts over a device mesh and has no counterpart on one GPU.

Numerics that must match the reference bit for bit:

* top-k ties break to the lower expert index (``jax.lax.top_k``): a stable
  descending sort;
* capacity follows the call's row count (:func:`capacity`), so the port
  routes the rows the reference routes: every lane at decode, idle ones
  included, and a prefill's whole bucket;
* the combine adds a token's k contributions in the reference's order
  (by expert id, the stable sort's order), each ``bf16(y * gate)``, into a
  bfloat16 zero, rounding after every add (XLA:CPU's scatter-add), with
  no atomics: the result does not depend on the device;
* a dropped assignment is removed with a select, never multiplied by a
  zero (a NaN row times zero is NaN).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import dense, swiglu

__all__ = ["moe_params_shape", "moe", "route", "capacity", "dispatch", "combine"]


def moe_params_shape(cfg: ModelConfig) -> Dict:
    d, m = cfg.d_model, cfg.moe
    shapes = {
        "router": (d, m.n_experts),
        "experts": {
            "w_gate": (m.n_experts, d, m.expert_ff),
            "w_up": (m.n_experts, d, m.expert_ff),
            "w_down": (m.n_experts, m.expert_ff, d),
        },
    }
    if m.n_shared:
        f = m.n_shared * m.expert_ff
        shapes["shared"] = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return shapes


def route(router_w: torch.Tensor, xf: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with renormalized gates (float32 router and softmax).
    Returns ``(gate [N, k] f32, top_idx [N, k] int64)``, experts in
    descending probability, ties to the lower index."""
    logits = dense(router_w, xf.to(torch.float32), mode="dequant", name="router")
    probs = torch.softmax(logits, dim=-1)
    gate, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, top_idx = gate[:, :k], top_idx[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return gate, top_idx


def capacity(n_tokens: int, k: int, cf: float, e: int) -> int:
    """Slots per expert: ``ceil(N * k * cf / E)``, at least 8, rounded up to
    a multiple of 8 (the reference's ``_capacity``)."""
    cap = int(-(-(n_tokens * k) * cf // e))
    return max(8, -(-cap // 8) * 8)


def dispatch(top_idx: torch.Tensor, n_experts: int, cap: int):
    """Sort-based dispatch of ``top_idx [N, k]``: ``(order, sorted_t, keep,
    dest)`` over the ``N * k`` assignments in stable expert order; ``dest``
    is the slot ``e * cap + rank`` of a kept one and the sink ``E * cap``
    of a dropped one."""
    n, k = top_idx.shape
    dev = top_idx.device
    flat_e = top_idx.reshape(-1)
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_t = flat_t[order]
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(pos_in_e, n_experts * cap))
    return order, sorted_t, keep, dest


def combine(yd: torch.Tensor, gate: torch.Tensor, top_idx: torch.Tensor,
            order: torch.Tensor, sorted_t: torch.Tensor, keep: torch.Tensor,
            dest: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gated combine, ``zeros(dtype).at[sorted_t].add(bf16(contrib *
    gate))`` of the reference, with each token's k contributions added in
    sorted order (a token's assignments sort by expert id), rounding to
    ``dtype`` after every add. ``yd [E, C, d]`` -> ``[N, d]``."""
    n, k = top_idx.shape
    e, cap, d = yd.shape
    y_flat = yd.reshape(e * cap, d)
    sorted_g = gate.reshape(-1)[order]
    rows = y_flat[torch.clamp_max(dest, e * cap - 1)]
    contrib = torch.where(keep[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    contrib = (contrib.to(torch.float32) * sorted_g[:, None]).to(dtype)  # [N*k, d]
    # The rank of each assignment among its token's (ascending expert id):
    # slot[rank, token] holds it, each (rank, token) once.
    rank = torch.argsort(torch.argsort(top_idx, dim=-1), dim=-1).reshape(-1)[order]
    slot = torch.zeros((k, n, d), dtype=dtype, device=yd.device)
    slot[rank, sorted_t] = contrib
    out = torch.zeros((n, d), dtype=dtype, device=yd.device)
    for r in range(k):
        out = out + slot[r]
    return out


def _expert_mlp(experts, xd: torch.Tensor, mode: str) -> torch.Tensor:
    """Every expert's SwiGLU on its capacity slice, ``xd [E, C, d]``: one
    ``dense`` call per stacked matrix."""
    g = dense(experts["w_gate"], xd, mode=mode, name="moe_gate")
    u = dense(experts["w_up"], xd, mode=mode, name="moe_up")
    return dense(experts["w_down"], swiglu(g, u), mode=mode, name="moe_down")


def moe(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str) -> torch.Tensor:
    """The MoE block on ``x [B, S, d]``: routed experts over all B * S rows
    (capacity from that count), plus the shared experts' SwiGLU."""
    b, s, d = x.shape
    m = cfg.moe
    xf = x.reshape(b * s, d)
    n = xf.shape[0]
    gate, top_idx = route(params["router"], xf, m.top_k)
    cap = capacity(n, m.top_k, m.capacity_factor, m.n_experts)
    order, sorted_t, keep, dest = dispatch(top_idx, m.n_experts, cap)
    buf = torch.zeros((m.n_experts * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, dest, xf[sorted_t])  # dropped rows land on the sink, discarded
    xd = buf[: m.n_experts * cap].reshape(m.n_experts, cap, d)
    yd = _expert_mlp(params["experts"], xd, mode)
    y = combine(yd, gate, top_idx, order, sorted_t, keep, dest, xf.dtype)
    if "shared" in params:
        sh = params["shared"]
        g = dense(sh["w_gate"], xf, mode=mode, name="moe_shared_gate")
        u = dense(sh["w_up"], xf, mode=mode, name="moe_shared_up")
        y = y + dense(sh["w_down"], swiglu(g, u), mode=mode, name="moe_shared_down")
    return y.reshape(b, s, d)
