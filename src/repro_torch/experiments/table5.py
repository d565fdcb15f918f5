"""Table 5: model size overhead of OCS (§5.4), the port of
``benchmarks/table5_overhead.py``.

Claim: the weight size overhead tracks the expand ratio r closely
(``ceil(r*C)`` rows a layer, so slightly above r for narrow layers).
Measured two ways: exactly, by counting the parameters of the convnet and
the bench LM after the per-layer input-channel expansion; arithmetically,
for full-size deepseek-7b and qwen3-14b, from ``ocs.expanded_channels``
(unpadded, and padded to 128 rows).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config
from ..core.apply import map_with_path, path_str
from ..core.ocs import expanded_channels, n_splits_for_ratio
from ..models import transformer as T
from . import common

RATIOS = [0.01, 0.02, 0.05, 0.1]


def _leaves(tree, is_leaf=None):
    out = []
    map_with_path(lambda p, leaf: out.append((path_str(p).lower(), leaf)), tree,
                  is_leaf=is_leaf)
    return out


def measured_overhead(params, ratio: float, *, skip=("stem", "embed", "norm",
                                                     "scale", "bias")) -> float:
    """Parameter-count ratio after real per-layer input-channel expansion."""
    base = expanded = 0
    for p, leaf in _leaves(params):
        shape = tuple(leaf.shape)
        n = int(np.prod(shape))
        base += n
        if len(shape) < 2 or any(s in p for s in skip):
            expanded += n
            continue
        cin = shape[2] if len(shape) == 4 else shape[-2]  # HWIO conv: Cin is axis 2
        per_row = n // cin
        expanded += n + n_splits_for_ratio(cin, ratio) * per_row
    return expanded / base


def arch_overhead(arch: str, ratio: float, pad_to: int = 1) -> float:
    """Shape-arithmetic overhead for a full architecture."""
    cfg = get_config(arch)
    shapes = T.model_params_shape(cfg)
    base = expanded = 0
    for p, shape in _leaves(shapes, is_leaf=lambda s: isinstance(s, tuple)):
        n = int(np.prod(shape))
        base += n
        if len(shape) < 2 or "embed" in p or "norm" in p or "router" in p:
            expanded += n
            continue
        cin = shape[-2]
        per_row = n // cin
        expanded += expanded_channels(cin, ratio, pad_to=pad_to) * per_row
    return expanded / base


def run(quick: bool = False, bench: common.Bench = None):
    bench = bench or common.Bench()
    cells, records = {}, []
    conv_params = bench.params("convnet")
    lm_params = bench.params("lm")
    subjects = [("convnet (measured)", lambda r: measured_overhead(conv_params, r)),
                ("bench-lm (measured)", lambda r: measured_overhead(lm_params, r)),
                ("deepseek-7b (arith)", lambda r: arch_overhead("deepseek-7b", r)),
                ("qwen3-14b (arith)", lambda r: arch_overhead("qwen3-14b", r)),
                ("deepseek-7b pad128", lambda r: arch_overhead("deepseek-7b", r, 128))]
    ratios = RATIOS[:2] if quick else RATIOS
    for name, fn in subjects:
        for r in ratios:
            v = fn(r)
            cells[(name, f"r={r}")] = v
            records.append({"subject": name, "ratio": r, "rel_size": v})
    bench.log(common.render_table(
        "Table 5 analog — relative weight size vs OCS expand ratio",
        [s for s, _ in subjects], [f"r={r}" for r in ratios], cells, fmt="{:.3f}"))
    bench.save_json("table5", records)
    # Claim: overhead ~ 1 + r (within ceil() granularity) for the unpadded runs.
    for rec in records:
        if "pad128" in rec["subject"]:
            continue
        assert rec["rel_size"] < 1 + 2.5 * rec["ratio"] + 0.02, rec
    bench.log("\nclaim check: unpadded overhead tracks r (< 1 + 2.5r + 0.02) — OK")
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    run(**vars(ap.parse_args()))
