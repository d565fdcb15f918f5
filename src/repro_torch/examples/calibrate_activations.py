"""Activation calibration walkthrough (paper §3.4, §5.3, Table 4), the port
of ``examples/calibrate_activations.py``.

The profiling flow the paper builds on:

1. run a few *training* batches through the float convnet under a tap
   collector (per-site histograms and per-channel outlier counts);
2. derive per-site clip thresholds (MSE) and activation-OCS split specs
   from the collected stats;
3. evaluate activation PTQ at 4 bits with 8-bit weights: no clip, the MSE
   clip, static OCS and Oracle OCS (per-batch channel selection), the
   paper's finding being that the oracle recovers what static profiling
   loses.

Run:  python -m repro_torch.examples.calibrate_activations [--device cpu]

The convnet is the experiments' trained subject (``experiments.common``:
trained on first use, cached under ``--out``).
"""
import argparse

from repro_torch.core.recipe import QuantRecipe
from repro_torch.experiments import common
from repro_torch.experiments.table4 import oracle_accuracy

BITS = 4  # this subject's activation-degradation onset (experiments/table3.py)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--out", default=None, help=f"subject cache and results (default "
                                                f"{common.OUT_DIR})")
    args = ap.parse_args(argv)
    common.float32_deterministic()
    bench = common.Bench(args.device, out_dir=args.out)
    params = bench.params("convnet")
    w8 = common.fake_quant_convnet(params, QuantRecipe(w_bits=8))
    print("calibrating on 3 training batches...")
    coll = common.calibrate_convnet(params, n_batches=3)
    print(f"  {len(coll)} activation sites profiled")
    site, stats = next(iter(coll.sites.items()))
    order = stats.split_order()[:3]
    print(f"  e.g. site {site}: top outlier channels {[int(c) for c in order]} "
          f"(99th pct = {stats.hist.quantile(0.99):.2f}, max = {stats.hist.max_seen:.2f})")

    float_acc = bench.convnet_accuracy(params)
    print(f"\nfloat accuracy: {float_acc:.1f}%   (activations at {BITS} bits below)")
    rows = {}
    for name, clip, ratio in (("no clip", None, 0.0), ("MSE clip", "mse", 0.0),
                              ("static OCS r=0.02", None, 0.02)):
        ctx = common.build_ctx(coll, BITS, clip, ratio, device=bench.device)
        rows[name] = common.eval_under_ctx(bench, w8, ctx)
        print(f"  {name:>18}: {rows[name]:.1f}%")
    rows["Oracle OCS (bs=8)"] = oracle_accuracy(bench, w8, BITS, 0.02, batch_size=8, coll=coll,
                                                n=512)
    print(f"  {'Oracle OCS (bs=8)':>18}: {rows['Oracle OCS (bs=8)']:.1f}%")
    return {"float": float_acc, "sites": len(coll), "rows": rows}


if __name__ == "__main__":
    main()
