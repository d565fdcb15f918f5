"""Serving launcher: random model -> OCS PTQ -> batched greedy serving.

The port of ``repro.launch.serve`` for the path the port has: a freshly
initialized dense model (weights from ``--seed``), quantized once with the
reference launcher's recipe (``QuantRecipe(w_bits=--bits, w_clip=--clip,
ocs_ratio=--ocs-ratio, per_channel=True, pad_to=1)``), then served through
:class:`repro_torch.serving.ServingEngine`. Engine flags are generated from
``EngineConfig``: with none given it serves the engine defaults,
weight-only ``dequant`` matmuls on float32 KV pages; ``--matmul-mode w8a8
--kv-bits 8`` serves dynamic W8A8 on int8 pages, and ``--ocs-ratio 0`` the
clip-only tree (no OCS split). Runs on the card; ``--device cpu`` runs the
plain PyTorch path at smoke size.

    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu \
        --matmul-mode w8a8 --kv-bits 8
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from ..configs import get_config, list_archs, smoke_config
from ..core.apply import quantize_params
from ..core.recipe import QuantRecipe
from ..device import resolve_device
from ..models import transformer as T
from ..serving import (
    EngineConfig,
    Request,
    ServingEngine,
    add_engine_config_args,
    engine_config_from_args,
)

log = logging.getLogger("repro_torch.launch.serve")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--ocs-ratio", type=float, default=0.02)
    ap.add_argument("--clip", default="mse")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    add_engine_config_args(ap, defaults=EngineConfig(max_batch=4, max_len=128))
    return ap


def _make_requests(n, vocab, rng, max_new):
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(0, vocab, plen).tolist()
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=max_new))
    return reqs


def serve_once(cfg, params, reqs, ecfg: EngineConfig, *, device=None):
    eng = ServingEngine(cfg, params, ecfg, device=device)
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    done = eng.run()
    wall = time.time() - t0
    s = eng.stats()
    s["wall_s"] = round(wall, 2)
    s["tokens_per_s"] = round(s["decoded_tokens"] / max(wall, 1e-9), 1)
    return done, s, eng


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(args.seed)

    params = T.init_params(cfg, seed=args.seed, device=dev)
    recipe = QuantRecipe(
        w_bits=args.bits, w_clip=args.clip, ocs_ratio=args.ocs_ratio,
        per_channel=True, pad_to=1,
    )
    t0 = time.time()
    qparams = quantize_params(params, recipe, device=dev)
    logging.getLogger("repro_torch.launch.ptq").info(
        "quantized in %.1fs (w%d, ocs r=%s, clip=%s)",
        time.time() - t0, args.bits, args.ocs_ratio, args.clip)

    ecfg = engine_config_from_args(args)
    reqs = _make_requests(args.n_requests, cfg.vocab, rng, args.max_new)
    done, stats, _eng = serve_once(cfg, qparams, reqs, ecfg, device=dev)
    log.info("%s", stats)
    reasons = {}
    for r in done:
        reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
    log.info("finish reasons: %s",
             " ".join(f"{k}={v}" for k, v in sorted(reasons.items(), key=str)))
    log.info(
        "latency: ttft p50 %.0f ms / p95 %.0f ms | itl p50 %.1f ms / p95 %.1f ms",
        stats["ttft_p50_s"] * 1e3, stats["ttft_p95_s"] * 1e3,
        stats["itl_p50_s"] * 1e3, stats["itl_p95_s"] * 1e3,
    )
    log.info(
        "throughput: prefill %.1f tok/s | decode %.1f tok/s | errors %d",
        stats["prefill_tok_per_s"], stats["decode_tok_per_s"], stats["errors"],
    )
    return stats


if __name__ == "__main__":
    main()
