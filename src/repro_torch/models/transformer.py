"""The language model (the port of ``repro.models.transformer``: the dense,
MoE, Mamba2 and hymba blocks; RMSNorm or LayerNorm, SwiGLU or GELU, RoPE or
M-RoPE, causal decoders and the encoder).

Parameters are a nested dict of tensors laid out like the reference's
``init_params``: per-layer leaves are stacked ``[L, ...]`` under
``params["layers"]``, quantized leaves are ``OCSQuantLinear`` (or
``W4A8Linear`` in the ``w4a8`` tier). The entry points:

* :func:`forward` / :func:`loss_fn` — full-sequence logits and their mean
  cross-entropy (evaluation, an encoder's only path, and training: on a
  float dense tree both are differentiable by ``torch.autograd``), every
  block kind, from tokens or from a stub frontend's embeddings;
* :func:`prefill_into_pages` — one request's prompt suffix through the
  full-sequence block, its K/V written straight into the page pools (the
  paged engine; dense and MoE);
* :func:`prefill_with_cache` / :func:`prefill_chunk_with_cache` — a
  prompt, or one budgeted chunk of it, into a b = 1 dense cache of
  :func:`init_cache` (the unpaged engine; dense and MoE: SSM and hybrid
  prompts replay through :func:`decode_step`, as the reference's do);
* :func:`decode_step` — one token per lane against the paged caches or
  against the dense caches of :func:`init_cache` (every block kind; a
  ``mamba2`` layer carries its SSM state and conv window, a ``hymba``
  layer its attention cache, a ring buffer on a sliding-window layer, its
  meta K/V and its SSM state); ``layers_limit`` runs only the first layers
  (the early-exit drafter of self-speculative decoding; dense and MoE);
* :func:`verify_step` — the k + 1 tokens of a speculative window per lane
  in one call on either cache (dense and MoE), each token's logits bitwise
  those of sequential :func:`decode_step` calls.

All take ``mode``, the quantized-matmul mode every ``layers.dense`` call
of the model runs (``"dequant"``, the reference's default, ``"w8a8"`` or
``"w4a8"``). A ``moe`` block (:mod:`repro_torch.models.moe`) replaces the
dense block's MLP where the reference's does; it routes all the rows of
its call (every lane of a decode or verify step, a prefill's whole
bucket), as the reference's does. A ``hymba`` layer runs attention and the
SSM heads on one input and fuses them as ``0.5 * (rms_norm(a) +
rms_norm(s))``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.apply import map_with_path, path_str
from ..core.ocs import OCSQuantLinear, W4A8Linear
from ..device import resolve_device
from ..kernels.paged_attention import quant_rows
from .attention import (attention, attention_decode, attention_params_shape, init_kv_cache,
                        rope_positions)
from .layers import dense, embed, layer_norm, rms_norm
from .mlp import mlp, mlp_params_shape
from .moe import moe, moe_params_shape
from .ssm import init_ssm_cache, mamba2, mamba2_decode, ssm_params_shape

__all__ = [
    "forward",
    "loss_fn",
    "init_params",
    "model_params_shape",
    "layer_params",
    "init_cache",
    "decode_tokens",
    "decode_step",
    "verify_step",
    "prefill_into_pages",
    "prefill_with_cache",
    "prefill_chunk_with_cache",
]

ATTN_BLOCKS = ("dense", "moe")  # blocks whose caches page and whose prompts prefill


BLOCKS = ATTN_BLOCKS + ("mamba2", "hymba")


def check_block(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block kind the model has no code for (the
    reference's own refusal)."""
    if cfg.block not in BLOCKS:
        raise ValueError(cfg.block)


def _norm(cfg: ModelConfig, p, x):
    """The config's norm: RMSNorm, or LayerNorm (``cfg.norm == "ln"``)
    with its bias."""
    if cfg.norm == "rms":
        return rms_norm(p["scale"], x, cfg.norm_eps)
    return layer_norm(p["scale"], p["bias"], x, cfg.norm_eps)


def _norm_shape(cfg: ModelConfig, d: int):
    if cfg.norm == "rms":
        return {"scale": (d,)}
    return {"scale": (d,), "bias": (d,)}


def _is_shape(x) -> bool:
    return isinstance(x, tuple)


def layer_params_shape(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    shapes: Dict[str, Any] = {"norm1": _norm_shape(cfg, d)}
    if cfg.block == "mamba2":
        shapes["ssm"] = ssm_params_shape(cfg)
        return shapes
    shapes["attn"] = attention_params_shape(cfg)
    if cfg.block == "hymba":
        shapes["ssm"] = ssm_params_shape(cfg)
        shapes["attn_fuse_norm"] = {"scale": (d,)}
        shapes["ssm_fuse_norm"] = {"scale": (d,)}
    shapes["norm2"] = _norm_shape(cfg, d)
    if cfg.block == "moe":
        shapes["moe"] = moe_params_shape(cfg)
    else:
        shapes["mlp"] = mlp_params_shape(cfg)
    return shapes


def model_params_shape(cfg: ModelConfig) -> Dict:
    check_block(cfg)
    d = cfg.d_model
    shapes: Dict[str, Any] = {
        "embed": (cfg.vocab, d),
        "final_norm": _norm_shape(cfg, d),
        "layers": map_with_path(
            lambda _p, s: (cfg.n_layers,) + s, layer_params_shape(cfg),
            is_leaf=_is_shape,
        ),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    if cfg.block == "hymba":
        shapes["meta_tokens"] = (cfg.hymba.n_meta_tokens, d)
    return shapes


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device=None,
    lazy: bool = False,
):
    """Random parameters (same layout and scales as the reference: norms 1,
    embeddings and meta tokens N(0, 0.02^2), matrices N(0, 1/fan_in); the
    SSM's ``A_log`` ``log(linspace(1, 16, heads))``, ``dt_bias`` and
    ``conv_b`` 0 and ``D`` 1, in float32). ``generator``
    defaults to ``torch.Generator(device).manual_seed(seed)``; leaves are
    drawn in the tree's order.

    With ``lazy`` every leaf is a zero-argument callable that draws it:
    :func:`repro_torch.core.apply.quantize_params` draws, quantizes and
    drops one leaf at a time in the tree's order, so the full float tree
    (67.5 GB for deepseek-moe-16b in float32) is never held, and the leaves
    are those an eager call draws."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)

    def init_one(path, shape):
        p = path_str(path).lower()
        vector = len(shape) == 1 or (len(shape) == 2 and shape[0] == cfg.n_layers)
        if "scale" in p or "norm" in p:
            return torch.ones(shape, dtype=dtype, device=dev)
        if "a_log" in p:
            base = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32,
                                            device=dev))
            return base.expand(shape).contiguous()
        if "dt_bias" in p or p.endswith("conv_b"):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        if p.endswith("/d"):
            return torch.ones(shape, dtype=torch.float32, device=dev)
        if vector:
            return torch.zeros(shape, dtype=dtype, device=dev)
        std = 0.02 if ("embed" in p or "meta_tokens" in p) else 1.0 / math.sqrt(shape[-2])
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.mul_(std).to(dtype)

    if lazy:
        return map_with_path(lambda path, shape: functools.partial(init_one, path, shape),
                             model_params_shape(cfg), is_leaf=_is_shape)
    return map_with_path(init_one, model_params_shape(cfg), is_leaf=_is_shape)


def layer_params(params, i: int):
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views)."""

    def take(_path, leaf):
        if isinstance(leaf, (OCSQuantLinear, W4A8Linear)):
            return leaf.layer(i)
        return leaf[i]

    return map_with_path(take, params["layers"])


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _block(cfg: ModelConfig, p, x, positions, *, mode: str, kv_prefix=None,
           prefix_len=None):
    """One dense or MoE layer over a full sequence (causal, or unmasked in
    an encoder); returns (x, (k, v))."""
    h = _norm(cfg, p["norm1"], x)
    a, kv = attention(
        p["attn"], h, cfg, positions=positions, mode=mode,
        kind="causal" if cfg.causal else "full", kv_prefix=kv_prefix,
        prefix_len=prefix_len, return_kv=True,
    )
    x = x + a
    h = _norm(cfg, p["norm2"], x)
    return x + _ffn(cfg, p, h, mode), kv


def _forward_block(cfg: ModelConfig, p, x, positions, *, mode: str, is_global=None):
    """One layer of any block kind over a full sequence (:func:`forward`).
    ``is_global``: a hymba layer's static global/window choice."""
    if cfg.block in ATTN_BLOCKS:
        return _block(cfg, p, x, positions, mode=mode)[0]
    h = _norm(cfg, p["norm1"], x)
    if cfg.block == "mamba2":
        return x + mamba2(p["ssm"], h, cfg, mode=mode)
    a = attention(p["attn"], h, cfg, positions=positions, mode=mode,
                  kind="causal" if is_global else "window", window=cfg.hymba.swa_window,
                  n_prefix=cfg.hymba.n_meta_tokens)
    s_out = mamba2(p["ssm"], h, cfg, mode=mode)
    x = x + 0.5 * (rms_norm(p["attn_fuse_norm"]["scale"], a, cfg.norm_eps)
                   + rms_norm(p["ssm_fuse_norm"]["scale"], s_out, cfg.norm_eps))
    h = _norm(cfg, p["norm2"], x)
    return x + mlp(p["mlp"], h, cfg, mode=mode)


def _segments(flags: np.ndarray):
    """Contiguous same-flag runs ``[(lo, hi, flag), ...]`` covering every
    layer (hymba's window and global layers, each run's choice static)."""
    out = []
    lo = 0
    for i in range(1, len(flags) + 1):
        if i == len(flags) or flags[i] != flags[lo]:
            out.append((lo, i, bool(flags[lo])))
            lo = i
    return out


def _positions(cfg: ModelConfig, b: int, s: int, offset: int = 0, device=None):
    """Sequence positions ``offset .. offset + s - 1`` per row, ``[b, s]``
    (``[b, s, 3]`` under M-RoPE)."""
    pos = (torch.arange(s, device=device) + offset)[None, :].expand(b, s)
    return rope_positions(cfg, pos)


def forward(params, tokens: Optional[torch.Tensor], cfg: ModelConfig, *,
            mode: str = "dequant", embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence logits ``[B, S, V]`` (the encoder's, and a decoder's
    for evaluation). tokens: ``[B, S]``; or ``embeds`` ``[B, S, d]``, the
    stub frontends' precomputed frame or patch embeddings (cast to
    bfloat16). Every block kind: a hymba model's learnt meta tokens are
    prepended (positions 0 .. M - 1, visible to every query) and stripped
    before the final norm, and its layers run in segments whose
    window/global choice is static (the skipped-chunk window path). The
    layer loop is the reference's unrolled one (``scan=False``); every
    linear layer runs in ``mode`` at M = B * S."""
    check_block(cfg)
    if embeds is not None:
        x = embeds.to(torch.bfloat16)
    else:
        x = embed(params["embed"], tokens)
    b, s = x.shape[0], x.shape[1]
    n_meta = cfg.hymba.n_meta_tokens if cfg.block == "hymba" else 0
    if n_meta:
        meta = params["meta_tokens"].to(x.dtype)[None].expand(b, n_meta, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
    positions = _positions(cfg, b, s + n_meta, device=x.device)
    if cfg.block == "hymba":
        for lo, hi, glob in _segments(_hymba_flags(cfg)):
            for i in range(lo, hi):
                x = _forward_block(cfg, layer_params(params, i), x, positions, mode=mode,
                                   is_global=glob)
    else:
        for i in range(cfg.n_layers):
            x = _forward_block(cfg, layer_params(params, i), x, positions, mode=mode)
    if n_meta:
        x = x[:, n_meta:]
    x = _norm(cfg, params["final_norm"], x)
    return dense(_head(params, cfg), x, mode=mode, name="lm_head")


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            mode: str = "dequant") -> torch.Tensor:
    """Mean token cross-entropy in float32 (``logsumexp`` minus the gold
    logit). batch: ``labels`` ``[B, S]`` and ``tokens`` or ``embeds``.

    On a float tree of the dense block (the experiments' bench LM) it is
    differentiable by ``torch.autograd`` when the leaves require grad: the
    path has no in-place operation and no host read-back. Quantized leaves
    are evaluation-only (no kernel has a backward, as the reference trains
    only float trees); gradients through the MoE, SSM and hybrid blocks are
    not held against the reference (ROADMAP A15)."""
    logits = forward(params, batch.get("tokens"), cfg, mode=mode,
                     embeds=batch.get("embeds")).to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def _ffn(cfg: ModelConfig, p, h, mode: str):
    """The block's feed-forward half: the MoE block (routing over all of
    ``h``'s rows) or the dense MLP."""
    if cfg.block == "moe":
        return moe(p["moe"], h, cfg, mode=mode)
    return mlp(p["mlp"], h, cfg, mode=mode)


def _hymba_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer is-global flags of a hymba model (its full-attention
    layers; the rest attend over a sliding window)."""
    flags = np.zeros(cfg.n_layers, dtype=bool)
    for i in cfg.hymba.global_layers:
        flags[i] = True
    return flags


def _hymba_window(cfg: ModelConfig, flags: np.ndarray, i: int) -> int:
    return 0 if bool(flags[i]) else cfg.hymba.swa_window


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32, *,
               device=None):
    """The unpaged engine's per-layer decode caches, and the per-lane
    position vector ``pos`` ``[batch]``: a list of per-layer trees (not
    stacked), as the reference lays them out. A dense or MoE layer holds
    ``{"attn"}`` (:func:`attention.init_kv_cache`, ``max_len`` rows), a
    Mamba2 layer ``{"ssm"}`` (:func:`ssm.init_ssm_cache`), a hymba layer
    ``{"attn", "meta_k", "meta_v", "ssm"}``: a ring buffer of
    ``min(max_len, window)`` rows on a sliding-window layer, and meta K/V
    ``[batch, n_meta, KV, hd]`` of zeros that serving never writes, as in
    the reference. An encoder has none (``ValueError``)."""
    check_block(cfg)
    if not cfg.causal:
        raise ValueError("encoder-only models have no decode step")
    dev = resolve_device(device)
    if cfg.block in ATTN_BLOCKS:
        layers = [{"attn": init_kv_cache(cfg, batch, max_len, dtype=dtype, device=dev)}
                  for _ in range(cfg.n_layers)]
    elif cfg.block == "mamba2":
        layers = [{"ssm": init_ssm_cache(cfg, batch, dtype, device=dev)}
                  for _ in range(cfg.n_layers)]
    else:
        flags = _hymba_flags(cfg)
        meta = (batch, cfg.hymba.n_meta_tokens, cfg.n_kv_heads, cfg.hd)
        layers = [
            {
                "attn": init_kv_cache(cfg, batch, max_len, window=_hymba_window(cfg, flags, i),
                                      dtype=dtype, device=dev),
                "meta_k": torch.zeros(meta, dtype=dtype, device=dev),
                "meta_v": torch.zeros(meta, dtype=dtype, device=dev),
                "ssm": init_ssm_cache(cfg, batch, dtype, device=dev),
            }
            for i in range(cfg.n_layers)
        ]
    return {"layers": layers, "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _decode_layer_unpaged(cfg: ModelConfig, p, x, cache, pos, window: int, mode: str):
    """One layer, one token against the dense caches of :func:`init_cache`.
    Returns (x, the layer's new cache tree)."""
    h = _norm(cfg, p["norm1"], x)
    if cfg.block == "mamba2":
        s_out, new_ssm = mamba2_decode(p["ssm"], h, cache["ssm"], cfg, mode=mode)
        return x + s_out, {"ssm": new_ssm}
    if cfg.block in ATTN_BLOCKS:
        a, new_attn = attention_decode(p["attn"], h, cache["attn"], pos, cfg, mode=mode)
        x = x + a
        h = _norm(cfg, p["norm2"], x)
        return x + _ffn(cfg, p, h, mode), {"attn": new_attn}
    a, new_attn = attention_decode(p["attn"], h, cache["attn"], pos, cfg, mode=mode,
                                   window=window, kv_prefix=(cache["meta_k"], cache["meta_v"]))
    s_out, new_ssm = mamba2_decode(p["ssm"], h, cache["ssm"], cfg, mode=mode)
    fused = 0.5 * (rms_norm(p["attn_fuse_norm"]["scale"], a, cfg.norm_eps)
                   + rms_norm(p["ssm_fuse_norm"]["scale"], s_out, cfg.norm_eps))
    x = x + fused
    h = _norm(cfg, p["norm2"], x)
    x = x + mlp(p["mlp"], h, cfg, mode=mode)
    return x, {"attn": new_attn, "meta_k": cache["meta_k"], "meta_v": cache["meta_v"],
               "ssm": new_ssm}


def decode_tokens(params, tokens: torch.Tensor, caches, cfg: ModelConfig, *,
                  mode: str = "dequant", layers_limit: Optional[int] = None):
    """Q tokens per lane ``[B, Q]`` against the caches -> (logits ``[B, Q,
    V]``, caches with ``pos`` advanced by Q).

    The Q tokens take positions ``pos .. pos + Q - 1``; query ``j`` attends
    over positions ``<= pos + j``, so the logits equal Q sequential
    one-token calls. Paged caches (dense and MoE) hold
    ``layers[i]["attn"]`` (page pools), ``table`` ``[B, T]`` and ``pos``
    ``[B]``; dense caches (:func:`init_cache`, no ``table``) hold every
    block kind's per-layer trees. Either is updated in place.
    ``layers_limit`` runs only the first L layers and projects their output
    through the final norm and the lm_head (the speculative drafter); the
    skipped layers' caches pass through untouched. Q > 1 and
    ``layers_limit`` take dense and MoE models only, as in the reference:
    an SSM or hybrid state cannot roll back a rejected tail."""
    check_block(cfg)
    pos = caches["pos"]
    table = caches.get("table")
    qn = tokens.shape[1]
    if qn > 1 and cfg.block not in ATTN_BLOCKS:
        raise NotImplementedError(
            f"multi-token decode: attention archs only, got {cfg.block} "
            "(SSM/hybrid decode states cannot roll back a rejected tail)")
    n_run = cfg.n_layers
    if layers_limit is not None:
        if cfg.block not in ATTN_BLOCKS:
            raise NotImplementedError("layers_limit: dense/moe drafters only")
        n_run = max(1, min(layers_limit, cfg.n_layers))
    x = embed(params["embed"], tokens)
    flags = _hymba_flags(cfg) if cfg.block == "hymba" else None
    new_layers = []
    for i in range(cfg.n_layers):
        if i >= n_run:
            new_layers.append(caches["layers"][i])  # the drafter skips the tail
            continue
        p = layer_params(params, i)
        if table is None:
            window = _hymba_window(cfg, flags, i) if flags is not None else 0
            x, nc = _decode_layer_unpaged(cfg, p, x, caches["layers"][i], pos, window, mode)
            new_layers.append(nc)
            continue
        h = _norm(cfg, p["norm1"], x)
        a, pool = attention_decode(
            p["attn"], h, caches["layers"][i]["attn"], pos, cfg, table=table, mode=mode
        )
        x = x + a
        h = _norm(cfg, p["norm2"], x)
        x = x + _ffn(cfg, p, h, mode)
        new_layers.append({"attn": pool})
    x = _norm(cfg, params["final_norm"], x)
    logits = dense(_head(params, cfg), x, mode=mode, name="lm_head")
    new_caches = {"layers": new_layers, "pos": pos + qn}
    if table is not None:
        new_caches["table"] = table
    return logits, new_caches


def decode_step(params, token: torch.Tensor, caches, cfg: ModelConfig, *,
                mode: str = "dequant", layers_limit: Optional[int] = None):
    """serve_step: one new token ``[B, 1]`` -> (logits ``[B, V]``, caches),
    on the paged or the dense caches; ``layers_limit`` truncates to the
    first L layers (see :func:`decode_tokens`)."""
    logits, new_caches = decode_tokens(params, token, caches, cfg, mode=mode,
                                       layers_limit=layers_limit)
    return logits[:, 0, :], new_caches


def verify_step(params, tokens: torch.Tensor, caches, cfg: ModelConfig, *,
                mode: str = "dequant"):
    """Speculative verify: score Q proposed tokens in one call.

    tokens: ``[B, Q]``, each lane's current token followed by its Q - 1
    draft proposals. Returns (logits ``[B, Q, V]``, caches with ``pos``
    advanced by Q): ``logits[:, j]`` is bitwise what a plain decode loop
    gives after consuming ``tokens[:, :j+1]`` (every kernel sums a row in
    one order whatever the row count; B2 gives a query row what its
    one-token call gives it, and the dense cache attends each query row
    alone), so greedy acceptance commits exactly the tokens plain greedy
    decode emits. The caller rolls a rejected tail back
    by rewinding ``pos`` (``serving.kv_cache.rewind_positions``): K/V
    written past the committed position is invisible to the causal mask and
    overwritten later.
    """
    return decode_tokens(params, tokens, caches, cfg, mode=mode)


def prefill_into_pages(
    params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    pools,
    page_ids: torch.Tensor,
    *,
    length: torch.Tensor,
    prefix_ids: torch.Tensor,
    mode: str = "dequant",
):
    """Prefill one request's prompt suffix straight into the page pools.

    tokens: ``[1, S_bucket]`` — the suffix past the shared prefix, zero
    padded (``S_bucket % page_size == 0``); ``length``: ``[1]`` real suffix
    length; ``page_ids``: ``[S_bucket // page_size]`` pages receiving the
    suffix K/V (trash-padded past the allocation); ``prefix_ids``:
    ``[n_hit_pages]`` pages of the already-prefilled prefix, gathered
    read-only and attended through the key-side ``kv_prefix``. ``pools``:
    per-layer page pools (written in place). Returns (last-token logits
    ``[1, V]``, pools).
    """
    from ..serving import kv_cache as _kvc  # serving builds on models

    _check_attention_block(cfg, "paged prefill")
    b, s = tokens.shape
    if b != 1:
        raise ValueError("paged prefill is per-request (page_ids are per-seq)")
    n_hit = prefix_ids.shape[0] * pools[0]["k"].shape[2]
    positions = _positions(cfg, 1, s, n_hit, device=tokens.device)
    x = embed(params["embed"], tokens)
    new_pools = []
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        kv_prefix = _kvc.gather_prefix(pools[i], prefix_ids) if n_hit else None
        x, (k, v) = _block(cfg, p, x, positions, mode=mode, kv_prefix=kv_prefix)
        new_pools.append(_kvc.write_prompt_pages(pools[i], k, v, page_ids))
    x = _norm(cfg, params["final_norm"], x)
    # Only the last real token goes through the lm_head (the widest matmul).
    last_h = x[:, length.long() - 1]  # [1, 1, d]
    return dense(_head(params, cfg), last_h, mode=mode, name="lm_head")[:, 0, :], new_pools


def _check_attention_block(cfg: ModelConfig, what: str) -> None:
    check_block(cfg)
    if cfg.block not in ATTN_BLOCKS:
        raise NotImplementedError(
            f"{what}: attention archs only, got {cfg.block} (SSM and hybrid prompts "
            "replay through decode_step)")


def _last_logits(params, x, length, cfg: ModelConfig, mode: str):
    """The final norm, then the lm_head on each sequence's last real token
    only (the widest matmul): ``[B, V]``."""
    x = _norm(cfg, params["final_norm"], x)
    rows = torch.arange(x.shape[0], device=x.device)
    last_h = x[rows, length.long() - 1][:, None]  # [B, 1, d]
    return dense(_head(params, cfg), last_h, mode=mode, name="lm_head")[:, 0, :]


def _write_kv(cache, k, v, idx: torch.Tensor) -> None:
    """Write K/V ``[B, S, KV, hd]`` into rows ``idx`` ``[S]`` of a dense
    cache ``[B, KV, S_cache, hd]``, in place: int8-quantized per row (the
    decode append's grid) on an int8 cache. Rows of ``idx`` past the
    cache are dropped."""
    keep = idx < cache["k"].shape[2]
    idx = idx[keep].long()
    k_t = k.transpose(1, 2)[:, :, keep]  # [B, KV, S', hd]
    v_t = v.transpose(1, 2)[:, :, keep]
    if cache["k"].dtype == torch.int8:
        k_q, k_s = quant_rows(k_t)
        v_q, v_s = quant_rows(v_t)
        cache["k"][:, :, idx] = k_q
        cache["v"][:, :, idx] = v_q
        cache["k_scale"][:, :, idx] = k_s
        cache["v_scale"][:, :, idx] = v_s
    else:
        cache["k"][:, :, idx] = k_t.to(cache["k"].dtype)
        cache["v"][:, :, idx] = v_t.to(cache["v"].dtype)


def prefill_with_cache(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int, *,
                       length: Optional[torch.Tensor] = None, cache_dtype=torch.float32,
                       mode: str = "dequant"):
    """Prefill a padded prompt into a fresh dense cache (the unpaged engine;
    dense and MoE): one full-sequence forward that also writes every
    layer's K/V into :func:`init_cache` rows ``[0, S)``.

    tokens: ``[B, S]``, zero-padded; ``length`` (``[B]``; default S): the
    real prompt lengths, where the logits are taken and ``pos`` starts.
    Rows past a prompt's length hold pad-token K/V, invisible to decode
    (which masks on the lane's position) and overwritten as it goes.
    Returns (last-real-token logits ``[B, V]``, caches)."""
    _check_attention_block(cfg, "prefill_with_cache")
    b, s = tokens.shape
    dev = tokens.device
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=dev)
    length = length.to(torch.int32).reshape(-1).expand(b)
    positions = _positions(cfg, b, s, device=dev)
    caches = init_cache(cfg, b, max_len, dtype=cache_dtype, device=dev)
    x = embed(params["embed"], tokens)
    idx = torch.arange(s, device=dev)
    for i in range(cfg.n_layers):
        x, (k, v) = _block(cfg, layer_params(params, i), x, positions, mode=mode)
        _write_kv(caches["layers"][i]["attn"], k, v, idx)
    caches["pos"] = length.clone()
    return _last_logits(params, x, length, cfg, mode), caches


def prefill_chunk_with_cache(params, tokens: torch.Tensor, cfg: ModelConfig, caches, *,
                             start: int, length: torch.Tensor, prefix_pad: int,
                             mode: str = "dequant"):
    """One budgeted prefill chunk against a b = 1 dense cache (the unpaged
    engine's chunked prefill; dense and MoE).

    tokens: ``[1, S_bucket]``, the chunk's prompt tokens zero-padded;
    ``start``: tokens already committed to ``caches`` (the chunk's offset);
    ``length``: ``[1]`` the chunk's real length; ``prefix_pad``: cache rows
    ``[0, prefix_pad)`` are attended as the chunk's prefix, rows at or past
    ``start`` zero-selected and masked out (the reference's engine pads the
    prefix to a power of two so that chunks share a trace; the port's
    passes the same pad, so the key count, and with it the key chunk of
    the sums, is the reference's). The chunk's K/V rows land at ``[start, start +
    S_bucket)`` (rows past the cache dropped), written in place; pad rows
    past the real length are overwritten before any read sees them.
    Returns (last-real-token logits ``[1, V]``, caches with ``pos`` at
    ``start + length``)."""
    _check_attention_block(cfg, "prefill_chunk_with_cache")
    b, s = tokens.shape
    if b != 1:
        raise ValueError("chunked prefill is per-request (b=1 scratch cache)")
    dev = tokens.device
    length = length.to(torch.int32).reshape(1)
    positions = _positions(cfg, 1, s, start, device=dev)
    idx = start + torch.arange(s, device=dev)
    st = torch.tensor(start, device=dev)
    row_ok = (torch.arange(prefix_pad, device=dev) < start)[None, :, None, None]
    x = embed(params["embed"], tokens)
    new_layers = []
    for i in range(cfg.n_layers):
        cache = caches["layers"][i]["attn"]
        kv_prefix = None
        if prefix_pad:
            pk = cache["k"][:, :, :prefix_pad].transpose(1, 2)
            pv = cache["v"][:, :, :prefix_pad].transpose(1, 2)
            if cache["k"].dtype == torch.int8:
                ks = cache["k_scale"][:, :, :prefix_pad].transpose(1, 2)
                vs = cache["v_scale"][:, :, :prefix_pad].transpose(1, 2)
                pk = pk.to(torch.float32) * ks[..., None]
                pv = pv.to(torch.float32) * vs[..., None]
            # Rows past the commit point are stale: zero-selected, so the
            # masked softmax sees finite scores.
            kv_prefix = (torch.where(row_ok, pk, 0.0), torch.where(row_ok, pv, 0.0))
        x, (k, v) = _block(cfg, layer_params(params, i), x, positions, mode=mode,
                           kv_prefix=kv_prefix, prefix_len=st if prefix_pad else None)
        _write_kv(cache, k, v, idx)
        new_layers.append({"attn": cache})
    new_caches = {"layers": new_layers,
                  "pos": torch.full((1,), start, dtype=torch.int32, device=dev) + length}
    return _last_logits(params, x, length, cfg, mode), new_caches
