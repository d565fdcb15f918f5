"""Table 1: quantization-aware vs naive splitting (paper §5.1), the port of
``benchmarks/table1_qa_split.py``.

Paper setup: ResNet-20 / CIFAR-10, weight bits {6,5,4,3} x expand ratio
{0.01, 0.05, 0.1, 0.2}, each cell (QA / naive). Claim: QA >= naive, with
the gap opening at low bits (4-3). Subject: the ResNet-20-shaped convnet
on synthetic images.
"""
from __future__ import annotations

import argparse

from ..core.recipe import QuantRecipe
from . import common


def run(quick: bool = False, bench: common.Bench = None):
    bench = bench or common.Bench()
    params = bench.params("convnet")
    float_acc = bench.convnet_accuracy(params)

    bits_list = [6, 4, 3] if quick else [6, 5, 4, 3]
    ratios = [0.05, 0.2] if quick else [0.01, 0.05, 0.1, 0.2]

    cells = {}
    records = []
    for bits in bits_list:
        for r in ratios:
            accs = {}
            for qa in (True, False):
                recipe = QuantRecipe(w_bits=bits, ocs_ratio=r, qa_split=qa, w_clip=None)
                accs[qa] = bench.convnet_accuracy(common.fake_quant_convnet(params, recipe))
            cells[(f"{bits} bits", f"r={r}")] = accs[True]
            cells[(f"{bits} bits", f"r={r} naive")] = accs[False]
            records.append({"bits": bits, "ratio": r, "qa": accs[True], "naive": accs[False]})
            bench.log(f"  w{bits} r={r}: QA {accs[True]:.1f} / naive {accs[False]:.1f}")

    cols = []
    for r in ratios:
        cols += [f"r={r}", f"r={r} naive"]
    bench.log(common.render_table(
        f"Table 1 analog — QA vs naive OCS splitting (convnet, float={float_acc:.1f}%)",
        [f"{b} bits" for b in bits_list], cols, cells,
    ))
    bench.save_json("table1", {"float_acc": float_acc, "cells": records})
    low = [rec for rec in records if rec["bits"] <= 4]
    qa_wins = sum(rec["qa"] >= rec["naive"] - 0.5 for rec in low)
    bench.log(f"\nclaim check (<=4 bits): QA >= naive-0.5 in {qa_wins}/{len(low)} cells")
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    run(**vars(ap.parse_args()))
