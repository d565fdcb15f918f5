"""2-layer LSTM language model, the paper's Table 6 subject (the port of
``repro.models.lstm``).

Weights per layer: ``wx [input, 4H]`` and ``wh [H, 4H]`` with gates in the
order i, f, g, o, and a bias ``b [4H]``: both matrices are plain ``[Cin,
Cout]`` linear weights, so the OCS/clip/quantize core applies unchanged.
Activations and the hidden state stay float (paper §6). The reference's
``lax.scan`` over time is ``torch.lstm`` here (cuDNN's fused recurrence on
the card), which computes the same cell in the same gate order with
``wx``/``wh`` viewed in its ``[4H, Cin]`` layout; the state starts at zero
for every sequence.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.apply import map_with_path, path_str
from ..device import resolve_device

__all__ = [
    "LSTMConfig",
    "lstm_params_shape",
    "init_lstm",
    "lstm_forward",
    "lstm_loss",
    "lstm_perplexity",
]


class LSTMConfig:
    def __init__(self, vocab: int = 1024, hidden: int = 128, n_layers: int = 2,
                 embed: int = 0):
        self.vocab = vocab
        self.hidden = hidden
        self.n_layers = n_layers
        self.embed = embed or hidden  # paper: embed dim == hidden (650)


def lstm_params_shape(cfg: LSTMConfig) -> Dict:
    shapes: Dict = {"embed": (cfg.vocab, cfg.embed)}
    for i in range(cfg.n_layers):
        d_in = cfg.embed if i == 0 else cfg.hidden
        shapes[f"l{i}"] = {
            "wx": (d_in, 4 * cfg.hidden),
            "wh": (cfg.hidden, 4 * cfg.hidden),
            "b": (4 * cfg.hidden,),
        }
    shapes["head"] = (cfg.hidden, cfg.vocab)
    return shapes


def init_lstm(cfg: LSTMConfig, generator: Optional[torch.Generator] = None, *,
              seed: int = 0, device=None) -> Dict:
    """Uniform weights in ``[-0.08, 0.08]`` (the embedding ``[-0.05,
    0.05]``), biases 0 but the forget gate's 1, drawn from ``generator``
    (default: seeded with ``seed`` on the device) in the tree's order."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)

    def init_one(path, shape):
        if len(shape) == 1:
            b = torch.zeros(shape, dtype=torch.float32, device=dev)
            h = shape[0] // 4
            b[h:2 * h] = 1.0
            return b
        scale = 0.05 if "embed" in path_str(path) else 0.08
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device=dev)
        return u * (2 * scale) - scale

    return map_with_path(init_one, lstm_params_shape(cfg),
                         is_leaf=lambda s: isinstance(s, tuple))


def lstm_forward(params: Dict, tokens: torch.Tensor, cfg: LSTMConfig) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (zero initial state per sequence)."""
    x = params["embed"][tokens.long()]  # [B, S, E]
    weights = []
    for i in range(cfg.n_layers):
        layer = params[f"l{i}"]
        # torch's layout: [4H, Cin] matrices (contiguous: cuDNN copies them
        # into its flat buffer by views) and two biases (the second 0).
        weights += [layer["wx"].t().contiguous(), layer["wh"].t().contiguous(), layer["b"],
                    torch.zeros_like(layer["b"])]
    h0 = x.new_zeros((cfg.n_layers, x.shape[0], cfg.hidden))
    # Training mode (no dropout at 0.0), so that cuDNN keeps what its
    # backward needs.
    hs, _, _ = torch.lstm(x, (h0, h0), weights, True, cfg.n_layers, 0.0, True, False, True)
    return hs @ params["head"]


def lstm_loss(params, batch, cfg: LSTMConfig) -> torch.Tensor:
    logits = lstm_forward(params, batch["tokens"], cfg).to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def lstm_perplexity(params, batches, cfg: LSTMConfig) -> float:
    with torch.no_grad():
        losses = [float(lstm_loss(params, b, cfg)) for b in batches]
    return float(np.exp(np.mean(losses)))
