"""Run the paper's weight-PTQ tables on the port.

    python -m repro_torch.experiments.run [--quick] [--only table2,table6]
        [--device cpu] [--out DIR]

Trains the three subjects on first use (on the card unless ``--device
cpu``; cached under ``<out>/cache``, ``experiments_out`` at the repository
root by default, keyed on the code that trained them), then
prints each table with its claim checks and writes ``<out>/results/
tableN.json`` and ``tables.json`` (each table's seconds, -1 if it failed).
Exits non-zero if a table failed.
"""
from __future__ import annotations

import argparse
import time
import traceback

from . import common, table1, table2, table5, table6, table7

TABLES = {
    "table1": table1.run,
    "table2": table2.run,
    "table5": table5.run,
    "table6": table6.run,
    "table7": table7.run,  # §3.4 knapsack variant (the paper's negative result)
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="", help="comma-separated table names")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--out", default=None, help=f"output directory (default {common.OUT_DIR})")
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.only.split(",") if n.strip()] or list(TABLES)
    unknown = [n for n in names if n not in TABLES]
    if unknown:
        raise SystemExit(f"unknown tables {unknown}; have {list(TABLES)}")

    common.float32_deterministic()
    bench = common.Bench(args.device, out_dir=args.out)
    failures = []
    timings = {}
    for name in names:
        print(f"\n{'=' * 72}\n== {name}\n{'=' * 72}", flush=True)
        t0 = time.perf_counter()
        try:
            TABLES[name](quick=args.quick, bench=bench)
            timings[name] = time.perf_counter() - t0
            print(f"[{name}] done in {timings[name]:.1f}s", flush=True)
        except Exception:
            failures.append(name)
            timings[name] = -1.0
            traceback.print_exc()
    bench.save_json("tables", {"seconds": timings, "train_seconds": bench.train_seconds,
                               "train_history": bench.histories, "quick": bool(args.quick),
                               "failed": failures, "only": names,
                               "device": str(bench.device)})
    if failures:
        raise SystemExit(f"failed tables: {failures}")
    print("\nall tables completed")


if __name__ == "__main__":
    main()
