"""Table 2: weight quantization, clipping methods vs OCS vs OCS + clip
(§5.2), the port of ``benchmarks/table2_weight_quant.py``.

Columns: clip {none, mse, aciq, kl, best}, OCS r {0.01, 0.02, 0.05}, and
OCS + the best clip; activations stay float to isolate the weights.
Claims: no clipping needed at high bits (none ~ best); clipping wins at
lower bits; OCS (small r) >= the best clip at the onset bits; OCS + clip
is the best at the lowest bits. Subjects: the convnet (accuracy %) and the
bench LM (perplexity).
"""
from __future__ import annotations

import argparse

from ..core.apply import fake_quantize_params
from ..core.recipe import QuantRecipe
from . import common

CLIPS = [None, "mse", "aciq", "kl"]
RATIOS = [0.01, 0.02, 0.05]


def _recipe(bits, clip=None, ratio=0.0):
    return QuantRecipe(w_bits=bits, w_clip=clip, ocs_ratio=ratio)


def run_subject(name, evaluate, better, bits_list, fmt="{:.1f}", log=print):
    """better: +1 if higher is better (accuracy), -1 for perplexity."""
    float_score = evaluate(None)
    log(f"[{name}] float score: {fmt.format(float_score)}")
    cells, records = {}, []
    for bits in bits_list:
        row = f"w{bits}"
        clip_scores = {}
        for clip in CLIPS:
            s = evaluate(_recipe(bits, clip=clip))
            clip_scores[clip or "none"] = s
            cells[(row, f"clip:{clip or 'none'}")] = s
        best_clip = max(clip_scores, key=lambda k: better * clip_scores[k])
        cells[(row, "clip:best")] = clip_scores[best_clip]
        for r in RATIOS:
            cells[(row, f"ocs:{r}")] = evaluate(_recipe(bits, ratio=r))
        for r in RATIOS:
            bc = None if best_clip == "none" else best_clip
            cells[(row, f"ocs+clip:{r}")] = evaluate(_recipe(bits, clip=bc, ratio=r))
        records.append({"bits": bits, "best_clip": best_clip,
                        **{f"{k}": v for (rr, k), v in cells.items() if rr == row}})
        log(f"  {row}: " + " ".join(
            f"{k.split(':')[-1]}={fmt.format(cells[(row, k)])}"
            for k in [f"clip:{c or 'none'}" for c in CLIPS]
            + [f"ocs:{r}" for r in RATIOS] + [f"ocs+clip:{r}" for r in RATIOS]))

    cols = ([f"clip:{c or 'none'}" for c in CLIPS] + ["clip:best"]
            + [f"ocs:{r}" for r in RATIOS] + [f"ocs+clip:{r}" for r in RATIOS])
    rows = [f"w{b}" for b in bits_list]
    title = f"Table 2 analog — weight PTQ, {name} (float={fmt.format(float_score)})"
    log(common.render_table(title, rows, cols, cells, fmt=fmt))
    return {"float": float_score, "rows": records}


def run(quick: bool = False, bench: common.Bench = None):
    # Bit ranges sit at each subject's degradation onset (the reference's
    # choice: the small subjects are more robust than ImageNet CNNs, so the
    # paper's 8-4 bit window shifts down).
    bench = bench or common.Bench()
    conv_bits = [6, 4, 3] if quick else [8, 6, 5, 4, 3]
    lm_bits = [4, 3] if quick else [5, 4, 3, 2]

    params = bench.params("convnet")

    def eval_conv(recipe):
        p = params if recipe is None else common.fake_quant_convnet(params, recipe)
        return bench.convnet_accuracy(p)

    conv = run_subject("convnet", eval_conv, +1, conv_bits, log=bench.log)

    lm_params = bench.params("lm")

    def eval_lm(recipe):
        p = lm_params if recipe is None else fake_quantize_params(lm_params, recipe)
        return bench.lm_ppl(p)

    lm = run_subject("transformer-lm", eval_lm, -1, lm_bits, fmt="{:.2f}", log=bench.log)

    bench.save_json("table2", {"convnet": conv, "lm": lm})
    return {"convnet": conv, "lm": lm}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    run(**vars(ap.parse_args()))
