"""§3.4 variant: knapsack channel allocation vs the simple ``ceil(r*C)``
rule, the port of ``benchmarks/table7_knapsack.py``.

The paper: the knapsack approach "is experimentally not better than the
simple method" and shows no numbers. At matched overhead the bench LM's
perplexity should be about equal (the knapsack wins its own objective,
total range reduction, which does not carry over to end quality).
"""
from __future__ import annotations

import argparse

from ..core.apply import fake_quantize_params
from ..core.recipe import QuantRecipe
from . import common


def run(quick: bool = False, bench: common.Bench = None):
    bench = bench or common.Bench()
    lm_params = bench.params("lm")
    float_ppl = bench.lm_ppl(lm_params)
    bits_list = [3] if quick else [3, 2]
    ratios = [0.02] if quick else [0.02, 0.05]
    bench.log(f"[table7] float ppl {float_ppl:.2f}")
    rows = []
    for bits in bits_list:
        for r in ratios:
            ppl = {}
            for alloc in ("uniform", "knapsack"):
                recipe = QuantRecipe(w_bits=bits, ocs_ratio=r, w_clip="mse", alloc=alloc)
                ppl[alloc] = bench.lm_ppl(fake_quantize_params(lm_params, recipe))
            rows.append({"bits": bits, "ratio": r, **ppl})
            bench.log(f"  w{bits} r={r}: uniform {ppl['uniform']:.2f} | "
                      f"knapsack {ppl['knapsack']:.2f}")

    bench.save_json("table7", rows)
    close = sum(abs(x["knapsack"] - x["uniform"]) <= 0.15 * x["uniform"] for x in rows)
    bench.log(f"\nclaim check (knapsack ~ uniform within 15%): {close}/{len(rows)} cells")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    run(**vars(ap.parse_args()))
