"""Training launcher: data -> train step -> checkpoint/restart -> PTQ (the
port of ``repro.launch.train``).

Trains a float LM of the registry (``--arch``, ``--smoke`` for the
reduced config) on the seeded synthetic stream, then, with
``--ptq-after``, quantizes it with OCS (no retraining) and reports the
evaluation loss of three recipes. Fault tolerance, as in the reference:

* auto-restore from the newest complete checkpoint in ``--ckpt-dir``,
  the data stream resumed at the step its meta records
  (``--simulate-failure N`` exits with code 1 after step N, once the
  pending checkpoint writes are on disk; rerunning the same command
  resumes, and ends bitwise where an uninterrupted run ends);
* async atomic checkpoints every ``--ckpt-every`` steps, keep-3, in the
  reference's format (:mod:`repro_torch.checkpoint`);
* a heartbeat file after every step, and a straggler line on stderr from
  the rolling step times.

Runs on the card unless given ``--device cpu``. Products are plain
float32 (no TF32) with deterministic cuDNN
(``experiments.common.float32_deterministic``), so a resumed run repeats
the uninterrupted one bit for bit. ``--mesh`` takes ``single`` only: the
reference's ``debug`` and ``production`` meshes shard the step with
GSPMD, which has no counterpart on one device.

    python -m repro_torch.launch.train --arch deepseek-7b --smoke --steps 10 \\
        --batch 2 --seq 32 --ckpt-dir ckpt --ckpt-every 3 --device cpu
    python -m repro_torch.launch.train --arch deepseek-7b --smoke --steps 10 \\
        --batch 2 --seq 32 --ckpt-dir ckpt --ckpt-every 3 --simulate-failure 6
    python -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 300 \\
        --ptq-after --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager, place
from ..configs import get_config, list_archs, smoke_config
from ..core.apply import fake_quantize_params
from ..core.recipe import QuantRecipe
from ..data import DataState, SyntheticLM
from ..device import resolve_device
from ..experiments.common import batch_to, float32_deterministic
from ..models import transformer as T
from ..optim import adamw_init
from ..runtime.health import HeartbeatMonitor, StepTimer
from .steps import TrainHyper, make_train_step

__all__ = ["build_parser", "evaluate", "hyper_for", "main"]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="single", choices=["single", "debug", "production"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="exit(1) after this step (fault-tolerance drill)")
    ap.add_argument("--ptq-after", action="store_true",
                    help="run OCS PTQ + eval after training (paper pipeline)")
    ap.add_argument("--ptq-bits", type=int, default=5)
    ap.add_argument("--ptq-ratio", type=float, default=0.02)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def hyper_for(args) -> TrainHyper:
    """The launcher's ``TrainHyper`` for parsed ``args`` (the reference's
    warmup: a twentieth of the steps, at least 5)."""
    return TrainHyper(lr=args.lr, warmup=max(args.steps // 20, 5), total_steps=args.steps,
                      n_micro=args.n_micro)


def evaluate(params, cfg, ds, dev, n_batches: int = 4, start: int = 10_000) -> float:
    """Mean eval loss on held-out steps (beyond any training step index)."""
    losses = []
    with torch.no_grad():
        for i in range(n_batches):
            losses.append(float(T.loss_fn(params, batch_to(ds.batch_at(start + i), dev), cfg)))
    return float(np.mean(losses))


def ptq_recipes(bits: int, ratio: float):
    """The three post-training recipes the launcher reports."""
    return [("clip_mse", QuantRecipe(w_bits=bits, w_clip="mse")),
            ("ocs", QuantRecipe(w_bits=bits, ocs_ratio=ratio)),
            ("ocs+clip", QuantRecipe(w_bits=bits, w_clip="mse", ocs_ratio=ratio))]


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh != "single":
        raise SystemExit(
            f"train: --mesh {args.mesh} shards the step over a device mesh with GSPMD "
            "(the reference's sharding/specs.py, sharding/compat.py and launch/mesh.py); "
            "the port trains on one device and records those modules as not applicable "
            "(CHANGES.md); use --mesh single")
    dev = resolve_device(args.device)
    float32_deterministic()
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)

    ds = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)
    step_fn = make_train_step(cfg, hyper_for(args))

    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    hb = HeartbeatMonitor(os.path.join(args.ckpt_dir or tempfile.gettempdir(), "heartbeat.json"))
    timer = StepTimer()

    params = T.init_params(cfg, seed=args.seed, device=dev)
    opt_state = adamw_init(params)
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        restored, meta = ckpt.restore((params, opt_state))
        params, opt_state = place(restored, dev)
        start_step = int(meta["data"]["step"])
        print(f"[train] restored step {start_step} from {args.ckpt_dir}")

    metrics_f = open(args.metrics_out, "a") if args.metrics_out else None
    t_start = time.time()
    for step in range(start_step, args.steps):
        timer.start()
        batch = batch_to(ds.batch_at(step), dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])
        dt = timer.stop()
        hb.beat(step, {"loss": loss})
        if timer.is_straggling:
            print(f"[health] step {step}: straggling "
                  f"({dt:.3f}s vs median {timer.median():.3f}s)", file=sys.stderr)
        if step % args.log_every == 0 or step == args.steps - 1:
            rec = {"step": step, "loss": round(loss, 4),
                   "grad_norm": round(float(m["grad_norm"]), 3),
                   "lr": float(m["lr"]), "dt_s": round(dt, 3)}
            print(f"[train] {rec}")
            if metrics_f:
                metrics_f.write(json.dumps(rec) + "\n")
                metrics_f.flush()
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state),
                      meta={"data": DataState(args.seed, step + 1).to_dict(), "arch": cfg.name})
        if args.simulate_failure and step + 1 >= args.simulate_failure:
            print(f"[train] SIMULATED FAILURE at step {step + 1}", file=sys.stderr)
            if ckpt:
                ckpt.wait()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
    if metrics_f:
        metrics_f.close()

    if ckpt:
        ckpt.save(args.steps, (params, opt_state),
                  meta={"data": DataState(args.seed, args.steps).to_dict(), "arch": cfg.name})
        ckpt.wait()
        ckpt.close()
    wall = time.time() - t_start
    print(f"[train] done: {args.steps - start_step} steps in {wall:.1f}s")

    if args.ptq_after:
        # The paper's pipeline: float model -> OCS PTQ (no retraining).
        results = {"float": round(evaluate(params, cfg, ds, dev), 4)}
        for name, recipe in ptq_recipes(args.ptq_bits, args.ptq_ratio):
            qp = fake_quantize_params(params, recipe)
            results[name] = round(evaluate(qp, cfg, ds, dev), 4)
        print(f"[ptq] w{args.ptq_bits} eval loss: {results}")
        return results
    return None


if __name__ == "__main__":
    main()
