"""Dense decoder LM (the port of ``repro.models.transformer``, dense block).

Parameters are a nested dict of tensors laid out like the reference's
``init_params``: per-layer leaves are stacked ``[L, ...]`` under
``params["layers"]``, quantized leaves are ``OCSQuantLinear``. Serving
runs two functions:

* :func:`prefill_into_pages` — one request's prompt suffix through the
  full-sequence block, its K/V written straight into the page pools;
* :func:`decode_step` — one token per lane against the paged caches.

Both take ``mode``, the quantized-matmul mode every ``layers.dense`` call
of the model runs (``"dequant"``, the reference's default, or
``"w8a8"``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..core.apply import map_with_path, path_str
from ..core.ocs import OCSQuantLinear
from ..device import resolve_device
from .attention import attention, attention_decode, attention_params_shape
from .layers import dense, embed, rms_norm
from .mlp import mlp, mlp_params_shape

__all__ = [
    "init_params",
    "model_params_shape",
    "layer_params",
    "decode_tokens",
    "decode_step",
    "prefill_into_pages",
]


def _check_block(cfg: ModelConfig) -> None:
    if cfg.block != "dense" or cfg.norm != "rms" or not cfg.causal:
        raise NotImplementedError(
            f"{cfg.name}: the port has the dense causal RMSNorm decoder "
            "(other blocks: ROADMAP A13)"
        )
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE: ROADMAP A13")


def _is_shape(x) -> bool:
    return isinstance(x, tuple)


def layer_params_shape(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "norm1": {"scale": (d,)},
        "attn": attention_params_shape(cfg),
        "norm2": {"scale": (d,)},
        "mlp": mlp_params_shape(cfg),
    }


def model_params_shape(cfg: ModelConfig) -> Dict:
    _check_block(cfg)
    d = cfg.d_model
    shapes: Dict[str, Any] = {
        "embed": (cfg.vocab, d),
        "final_norm": {"scale": (d,)},
        "layers": map_with_path(
            lambda _p, s: (cfg.n_layers,) + s, layer_params_shape(cfg),
            is_leaf=_is_shape,
        ),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device=None,
):
    """Random parameters (same layout and scales as the reference: norms 1,
    embeddings N(0, 0.02^2), matrices N(0, 1/fan_in)). ``generator``
    defaults to ``torch.Generator(device).manual_seed(seed)``; leaves are
    drawn in the tree's order."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)

    def init_one(path, shape):
        p = path_str(path).lower()
        vector = len(shape) == 1 or (len(shape) == 2 and shape[0] == cfg.n_layers)
        if "scale" in p or "norm" in p:
            return torch.ones(shape, dtype=dtype, device=dev)
        if vector:
            return torch.zeros(shape, dtype=dtype, device=dev)
        std = 0.02 if "embed" in p else 1.0 / math.sqrt(shape[-2])
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (w * std).to(dtype)

    return map_with_path(init_one, model_params_shape(cfg), is_leaf=_is_shape)


def layer_params(params, i: int):
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views)."""

    def take(_path, leaf):
        if isinstance(leaf, OCSQuantLinear):
            return leaf.layer(i)
        return leaf[i]

    return map_with_path(take, params["layers"])


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _block(cfg: ModelConfig, p, x, positions, *, mode: str, kv_prefix=None):
    """One layer over a full sequence; returns (x, (k, v))."""
    h = rms_norm(p["norm1"]["scale"], x, cfg.norm_eps)
    a, kv = attention(
        p["attn"], h, cfg, positions=positions, mode=mode, kv_prefix=kv_prefix,
        return_kv=True,
    )
    x = x + a
    h = rms_norm(p["norm2"]["scale"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg, mode=mode), kv


def decode_tokens(params, tokens: torch.Tensor, caches, cfg: ModelConfig, *,
                  mode: str = "dequant"):
    """Q tokens per lane ``[B, Q]`` against the paged caches -> (logits
    ``[B, Q, V]``, caches with ``pos`` advanced by Q). ``caches`` holds
    ``layers[i]["attn"]`` (page pools), ``table`` ``[B, T]`` and ``pos``
    ``[B]``; on the card the pools are updated in place."""
    _check_block(cfg)
    pos = caches["pos"]
    table = caches["table"]
    qn = tokens.shape[1]
    x = embed(params["embed"], tokens)
    new_layers = []
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        h = rms_norm(p["norm1"]["scale"], x, cfg.norm_eps)
        a, pool = attention_decode(
            p["attn"], h, caches["layers"][i]["attn"], pos, cfg, table=table, mode=mode
        )
        x = x + a
        h = rms_norm(p["norm2"]["scale"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h, cfg, mode=mode)
        new_layers.append({"attn": pool})
    x = rms_norm(params["final_norm"]["scale"], x, cfg.norm_eps)
    logits = dense(_head(params, cfg), x, mode=mode, name="lm_head")
    return logits, {"layers": new_layers, "table": table, "pos": pos + qn}


def decode_step(params, token: torch.Tensor, caches, cfg: ModelConfig, *,
                mode: str = "dequant"):
    """serve_step: one new token ``[B, 1]`` -> (logits ``[B, V]``, caches)."""
    logits, new_caches = decode_tokens(params, token, caches, cfg, mode=mode)
    return logits[:, 0, :], new_caches


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

    _check_block(cfg)
    b, s = tokens.shape
    if b != 1:
        raise ValueError("paged prefill is per-request (page_ids are per-seq)")
    n_hit = prefix_ids.shape[0] * pools[0]["k"].shape[2]
    positions = (torch.arange(s, device=tokens.device) + n_hit)[None, :]
    x = embed(params["embed"], tokens)
    new_pools = []
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        kv_prefix = _kvc.gather_prefix(pools[i], prefix_ids) if n_hit else None
        x, (k, v) = _block(cfg, p, x, positions, mode=mode, kv_prefix=kv_prefix)
        new_pools.append(_kvc.write_prompt_pages(pools[i], k, v, page_ids))
    x = rms_norm(params["final_norm"]["scale"], x, cfg.norm_eps)
    # Only the last real token goes through the lm_head (the widest matmul).
    last_h = x[:, length.long() - 1]  # [1, 1, d]
    return dense(_head(params, cfg), last_h, mode=mode, name="lm_head")[:, 0, :], new_pools
