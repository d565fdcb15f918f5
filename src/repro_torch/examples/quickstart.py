"""Quickstart: OCS post-training quantization in a few minutes, the port of
``examples/quickstart.py``.

1. Build a small transformer LM from the model zoo and train it briefly
   (AdamW, 120 steps on the synthetic token stream).
2. Quantize the weights to 5 bits four ways: plain linear, MSE clipping,
   OCS (the paper's method) and OCS + MSE; no retraining, no data for the
   weights.
3. Compare held-out perplexity, then build the integer serving tree.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.apply import fake_quantize_params, quantize_params
from repro_torch.core.ocs import OCSQuantLinear
from repro_torch.core.recipe import QuantRecipe
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.experiments.common import batch_to
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map

CFG = ModelConfig(name="quickstart", block="dense", n_layers=2, d_model=96,
                  n_heads=4, n_kv_heads=2, d_ff=192, vocab=256,
                  attn_chunk=32, remat=False)
BITS = 5
STEPS = 120


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ds = SyntheticLM(CFG.vocab, 48, 8, seed=0)
    params = T.init_params(CFG, seed=0, device=dev)
    opt = adamw_init(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"training {CFG.name} ({n_params:,} params) on {dev}...")
    t0 = time.time()
    for i in range(STEPS):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = T.loss_fn(p, batch_to(ds.batch_at(i), dev), CFG)
        loss.backward()
        grads = tree_map(lambda t: t.grad, p)
        params, opt = adamw_update(grads, opt, params, lr=3e-3)
        params = tree_map(lambda t: t.detach(), params)
    print(f"  {STEPS} steps in {time.time() - t0:.0f}s, final loss {float(loss.detach()):.3f}")

    def ppl(p):
        with torch.no_grad():
            losses = [float(T.loss_fn(p, batch_to(ds.batch_at(9000 + i), dev), CFG))
                      for i in range(4)]
        return float(np.exp(np.mean(losses)))

    out = {"float": ppl(params)}
    print(f"\nfloat ppl: {out['float']:.3f}")
    for name, recipe in [
        (f"w{BITS} linear (no clip)", QuantRecipe(w_bits=BITS)),
        (f"w{BITS} MSE clip", QuantRecipe(w_bits=BITS, w_clip="mse")),
        (f"w{BITS} OCS r=0.02 (paper)", QuantRecipe(w_bits=BITS, ocs_ratio=0.02)),
        (f"w{BITS} OCS+MSE (paper best)", QuantRecipe(w_bits=BITS, ocs_ratio=0.02, w_clip="mse")),
    ]:
        out[name] = ppl(fake_quantize_params(params, recipe))
        print(f"{name:>28}: ppl {out[name]:.3f}")

    # The integer tree for serving: int8 storage + scales + split tables.
    qtree = quantize_params(params, QuantRecipe(w_bits=8, ocs_ratio=0.02), device=dev)
    n_int8 = sum(leaf.weight.values.numel() for leaf in _quant_leaves(qtree))
    print(f"\nserving tree: {n_int8:,} int8 weights "
          f"(OCS-expanded, ~{100 * 0.02:.0f}% size overhead by design)")
    out["int8_weights"] = n_int8
    return out


def _quant_leaves(tree):
    if isinstance(tree, OCSQuantLinear):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _quant_leaves(v)]
    return []


if __name__ == "__main__":
    main()
