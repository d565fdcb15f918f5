"""Precision-tier quality gate on the port (the port of
``tools/quality_eval.py``): score every serving tier of the trained bench
LM against the float and int8 oracles and fail on quality regressions.

    python -m repro_torch.launch.quality_eval [--quick] [--batches 8]
        [--outlier-ratio 0.1] [--json] [--device cpu] [--out DIR]

The trained bench LM (``experiments.common``, trained on first use and
cached like the tables' subjects) runs each tier's serving numerics:

* ``float``      : the unquantized forward;
* ``int8``       : ``quantize_params`` (w8, OCS r=0.02, per-channel,
                   ``pad_to=1``) in matmul mode ``w8a8`` (B1 on the card);
* ``w4a8_ocs``   : that tree through ``to_w4a8(., outlier_ratio)``, the
                   OCS-ranked outlier rows kept at 8 bits (B6);
* ``w4a8_naive`` : the same conversion with no outlier rows (B6);
* ``int8_dequant``: the int8 tree in mode ``dequant`` (B4). The reference
                   has no such tier; its row is printed and not gated.

Per tier: logit MSE and top-1 agreement against both oracles and the
pseudo-perplexity on held-out batches (``batch_at(60_000 + i)``), and the
same against the float oracle on uniform-random "stress" tokens, where the
trained LM's margins are slim enough that 4-bit error flips argmaxes.

The gate (:func:`gate`, the reference's, unchanged; exit 1 on a
violation): every tier clears its top-1-vs-float floor (``FLOORS``),
``w4a8_ocs`` beats ``w4a8_naive`` on stress top-1 agreement, and its logit
MSE vs float is below naive's on both sets. The reference calibrated its
floors and the OCS-beats-naive margins on its own trained LM; the port's
is trained from its own seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.apply import map_with_path, quantize_params
from ..core.ocs import OCSQuantLinear, to_w4a8
from ..core.recipe import QuantRecipe
from ..experiments import common
from ..models import transformer as T

__all__ = ["FLOORS", "RECIPE", "eval_batches", "stress_batches", "tier_logits", "convert",
           "tier_trees", "run", "tier_metrics", "gate", "format_tiers", "main"]

# Tier -> minimum top-1 agreement vs the float oracle (the reference's).
FLOORS = {
    "int8": 0.95,
    "w4a8_ocs": 0.90,
    "w4a8_naive": 0.50,
}

RECIPE = QuantRecipe(w_bits=8, ocs_ratio=0.02, per_channel=True, pad_to=1)

def eval_batches(n: int, device=None):
    """Held out: training reads batch_at(0 .. steps - 1), the perplexities
    50_000 on; the gate reads 60_000 on."""
    return [common.batch_to(common.LM_DS.batch_at(60_000 + i), device) for i in range(n)]


def stress_batches(n: int, vocab: int, seed: int = 11, device=None):
    """Uniform-random token sequences (the reference's draws)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, vocab, (16, 64)).astype(np.int32)
        labels = rng.integers(0, vocab, (16, 64)).astype(np.int32)
        out.append(common.batch_to({"tokens": tokens, "labels": labels}, device))
    return out


def tier_logits(params, cfg, batches, mode):
    """float32 logits ``[B, S, V]`` (host numpy) of each batch in ``mode``."""
    with torch.no_grad():
        return [T.forward(params, b["tokens"], cfg, mode=mode).to(torch.float32).cpu().numpy()
                for b in batches]


def convert(qparams, ratio: float):
    return map_with_path(
        lambda _p, leaf: to_w4a8(leaf, ratio) if isinstance(leaf, OCSQuantLinear) else leaf,
        qparams)


def tier_trees(params, outlier_ratio: float):
    """tier -> (tree, matmul mode), the int8 tree quantized on the params'
    device."""
    q = quantize_params(params, RECIPE, device=params["embed"].device)
    return {"float": (params, "dequant"), "int8": (q, "w8a8"),
            "w4a8_ocs": (convert(q, outlier_ratio), "w4a8"),
            "w4a8_naive": (convert(q, 0.0), "w4a8"), "int8_dequant": (q, "dequant")}


def _pseudo_ppl(logits, batches) -> float:
    losses = []
    for lg, b in zip(logits, batches):
        lg = torch.from_numpy(lg)
        labels = b["labels"].long().cpu()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None])[..., 0]
        losses.append(float(torch.mean(logz - gold)))
    return float(np.exp(np.mean(losses)))


def _mse(a, b) -> float:
    return float(np.mean([np.mean((x - y) ** 2) for x, y in zip(a, b)]))


def _top1_agree(a, b) -> float:
    return float(np.mean([np.mean(np.argmax(x, -1) == np.argmax(y, -1))
                          for x, y in zip(a, b)]))


def tier_metrics(logits, slogits, batches) -> dict:
    """The reference's metrics from each tier's logits on the eval
    (``logits``) and stress (``slogits``) sets."""
    tiers = {}
    for name in logits:
        lg, sl = logits[name], slogits[name]
        tiers[name] = {
            "logit_mse_vs_float": _mse(lg, logits["float"]),
            "logit_mse_vs_int8": _mse(lg, logits["int8"]),
            "top1_vs_float": _top1_agree(lg, logits["float"]),
            "top1_vs_int8": _top1_agree(lg, logits["int8"]),
            "pseudo_ppl": _pseudo_ppl(lg, batches),
            "top1_stress_vs_float": _top1_agree(sl, slogits["float"]),
            "logit_mse_stress_vs_float": _mse(sl, slogits["float"]),
        }
    return tiers


def run(params, batches_n: int = 8, outlier_ratio: float = 0.1, cfg=None) -> dict:
    """Tier metrics of the bench LM ``params`` (on their device)."""
    cfg = cfg or common.LM_CFG
    dev = params["embed"].device
    batches = eval_batches(batches_n, dev)
    stress = stress_batches(batches_n, cfg.vocab, device=dev)
    trees = tier_trees(params, outlier_ratio)
    logits = {name: tier_logits(p, cfg, batches, mode) for name, (p, mode) in trees.items()}
    slogits = {name: tier_logits(p, cfg, stress, mode) for name, (p, mode) in trees.items()}
    return tier_metrics(logits, slogits, batches)


def gate(tiers: dict) -> list:
    """Return the list of violated invariants (empty = pass)."""
    bad = []
    for name, floor in FLOORS.items():
        got = tiers[name]["top1_vs_float"]
        if got < floor:
            bad.append(f"{name}: top1_vs_float {got:.4f} < floor {floor:.2f}")
    ocs, naive = tiers["w4a8_ocs"], tiers["w4a8_naive"]
    if not ocs["top1_stress_vs_float"] > naive["top1_stress_vs_float"]:
        bad.append(
            "outlier separation must beat naive W4A8 on stress top-1 "
            f"agreement: ocs {ocs['top1_stress_vs_float']:.4f} <= "
            f"naive {naive['top1_stress_vs_float']:.4f}"
        )
    for m in ("logit_mse_vs_float", "logit_mse_stress_vs_float"):
        if not ocs[m] < naive[m]:
            bad.append(
                f"outlier separation must beat naive W4A8 on {m}: "
                f"ocs {ocs[m]:.4g} >= naive {naive[m]:.4g}"
            )
    return bad


def format_tiers(tiers: dict) -> str:
    hdr = (f"{'tier':<13} {'top1_vs_f':>10} {'top1_stress':>12} "
           f"{'mse_vs_f':>10} {'mse_stress':>11} {'ppl':>8}")
    lines = [hdr, "-" * len(hdr)]
    for name, t in tiers.items():
        lines.append(f"{name:<13} {t['top1_vs_float']:>10.4f} "
                     f"{t['top1_stress_vs_float']:>12.4f} "
                     f"{t['logit_mse_vs_float']:>10.4g} "
                     f"{t['logit_mse_stress_vs_float']:>11.4g} "
                     f"{t['pseudo_ppl']:>8.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="2 eval batches")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--outlier-ratio", type=float, default=0.1,
                    help="fraction of channels kept at 8 bit (w4a8_ocs)")
    ap.add_argument("--json", action="store_true", help="print the artifact to stdout too")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--out", default=None, help=f"output directory (default {common.OUT_DIR})")
    args = ap.parse_args(argv)

    common.float32_deterministic()
    bench = common.Bench(args.device, out_dir=args.out)
    n = 2 if args.quick else args.batches
    tiers = run(bench.params("lm"), n, args.outlier_ratio)
    violations = gate(tiers)
    artifact = {
        "created_unix": time.time(),
        "tiers": tiers,
        "floors": FLOORS,
        "gate_passed": not violations,
        "violations": violations,
        "meta": {
            "subject": "bench-lm",
            "device": str(bench.device),
            "eval_batches": n,
            "outlier_ratio": args.outlier_ratio,
            "recipe": {"w_bits": 8, "ocs_ratio": 0.02, "per_channel": True},
            "quick": bool(args.quick),
        },
    }
    bench.save_json("QUALITY_tiers", artifact)
    print(format_tiers(tiers))
    if args.json:
        print(json.dumps(artifact, indent=1, default=float))
    for v in violations:
        print(f"GATE VIOLATION: {v}", file=sys.stderr)
    print("quality gate:", "PASS" if not violations else "FAIL")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
