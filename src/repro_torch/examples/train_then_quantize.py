"""End to end: train an LM for a few hundred steps, checkpoint it, then
run the paper's post-training pipeline (weight OCS x clipping) and report
the quality of every recipe (the port of ``examples/train_then_quantize.py``).

This is the "ML service provider" scenario of the paper's introduction:
the training side produces a float checkpoint; the quantization side never
sees training data (weight OCS is data-free, §3.4).

Run:  python -m repro_torch.examples.train_then_quantize [--steps 300] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as train_launcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--bits", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)

    argv = ["--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "96",
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
            "--ptq-after", "--ptq-bits", str(args.bits), "--ptq-ratio", "0.02"]
    if args.device:
        argv += ["--device", args.device]
    results = train_launcher.main(argv)
    print("\n== end-to-end summary (eval loss; lower is better) ==")
    for k, v in (results or {}).items():
        print(f"  {k:>10}: {v}")
    if results:
        assert results["ocs+clip"] <= results["clip_mse"] + 0.05, (
            "OCS+clip should match or beat clipping alone")
        print("\nclaim check: OCS+clip <= clip alone (+0.05 tolerance) — OK")
    return results


if __name__ == "__main__":
    main()
