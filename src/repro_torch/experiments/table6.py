"""Table 6: LSTM LM perplexity with quantized weights (§6), the port of
``benchmarks/table6_lstm.py``.

Paper setup: 2-layer LSTM on WikiText-2; weight bits x OCS expand ratio
{0, 0.01, 0.02, 0.05} x clip {none, mse, aciq, kl}; activations and hidden
state stay float. Claims: clipping does not improve this model (none is
the best column); OCS lowers perplexity monotonically with r, beating
every clip method. Subject: the 2-layer LSTM on the synthetic stream.
"""
from __future__ import annotations

import argparse

from ..core.apply import fake_quantize_params
from ..core.recipe import QuantRecipe
from . import common

CLIPS = [None, "mse", "aciq", "kl"]
RATIOS = [0.0, 0.01, 0.02, 0.05]


def run(quick: bool = False, bench: common.Bench = None):
    bench = bench or common.Bench()
    params = bench.params("lstm")
    float_ppl = bench.lstm_ppl(params)
    bench.log(f"[table6] float ppl: {float_ppl:.2f}")

    # Degradation onset for this subject is w4-w3 (the reference's choice).
    bits_list = [4] if quick else [5, 4, 3]
    ratios = [0.0, 0.05] if quick else RATIOS
    cells, records = {}, []
    for bits in bits_list:
        for r in ratios:
            row = f"w{bits} r={r}"
            for clip in CLIPS:
                recipe = QuantRecipe(w_bits=bits, w_clip=clip, ocs_ratio=r)
                cells[(row, f"clip:{clip or 'none'}")] = bench.lstm_ppl(
                    fake_quantize_params(params, recipe))
            records.append({"bits": bits, "ratio": r,
                            **{k: v for (rr, k), v in cells.items() if rr == row}})
            bench.log(f"  {row}: " + " ".join(
                f"{c or 'none'}={cells[(row, 'clip:' + (c or 'none'))]:.2f}" for c in CLIPS))

    rows = [f"w{b} r={r}" for b in bits_list for r in ratios]
    cols = [f"clip:{c or 'none'}" for c in CLIPS]
    bench.log(common.render_table(
        f"Table 6 analog — LSTM LM perplexity (float={float_ppl:.2f}, lower=better)",
        rows, cols, cells, fmt="{:.2f}"))
    bench.save_json("table6", {"float_ppl": float_ppl, "rows": records})
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    run(**vars(ap.parse_args()))
