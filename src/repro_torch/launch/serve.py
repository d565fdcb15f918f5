"""Serving launcher: random model -> OCS PTQ -> batched serving.

The port of ``repro.launch.serve``: a freshly initialized dense, MoE,
Mamba2 or hymba model (weights from ``--seed``; ``--arch`` any of the
registry's decoders: ``glm4-9b``, ``minitron-8b``, ``deepseek-7b``,
``qwen3-14b``, ``qwen2-vl-7b`` (M-RoPE; served text tokens),
``deepseek-moe-16b``, ``phi3.5-moe-42b-a6.6b``, ``mamba2-1.3b`` and
``hymba-1.5b``; the encoder ``hubert-xlarge`` has no decode step, and the
engine refuses it as the reference's does: it runs through
``models.transformer.forward``; each leaf is drawn and quantized before
the next), quantized once with the
reference launcher's recipe (``QuantRecipe(w_bits=--bits, w_clip=--clip,
ocs_ratio=--ocs-ratio, per_channel=True, pad_to=1)``), then served through
:class:`repro_torch.serving.ServingEngine`. Engine flags are generated from
``EngineConfig``: with none given it serves the engine defaults,
weight-only ``dequant`` matmuls on float32 KV pages; ``--matmul-mode w8a8
--kv-bits 8`` serves dynamic W8A8 on int8 pages, ``--matmul-mode w4a8
--kv-bits 4`` the sub-8-bit tier (packed int4 weights with OCS-ranked int8
outlier rows, ``--w4a8-outlier-ratio`` of them; int4 KV pages), and
``--ocs-ratio 0`` the clip-only tree (no OCS split). ``--spec-k K``
serves with self-speculative decoding (K draft tokens per round, drafted
in ``w8a8``; ``--draft-layers L`` cuts the drafter to the first L layers);
its output is token-identical to plain greedy. ``--temperature T``
(with ``--top-k`` / ``--top-p``) makes every request sampled, seeded with
``--seed``. The scheduler and overload flags come from ``EngineConfig``
too: ``--prefill-budget B --chunk-size C`` chunks prefill, ``--admission
optimistic`` admits on prompt pages and preempts under pool pressure,
``--max-queue``, ``--sched-policy``, ``--heartbeat-path``. ``--paged
{auto,on,off}`` picks the KV cache: ``auto`` pages dense and MoE models and
serves Mamba2 and hymba on the unpaged engine's dense caches (their prompts
replay through the decode step, one call a token), ``off`` serves a dense
or MoE model unpaged too (``--spec-k`` included). Runs on the card; ``--device cpu`` runs the
plain PyTorch path at smoke size.

``--ckpt-dir DIR`` serves the newest checkpoint's parameters (the ``0/...``
arrays of a ``launch.train`` checkpoint, or of the reference's) in place
of the random ones; the memory-mapped arrays are the lazy leaves of
``quantize_params``, each moved to the device when it is quantized, so the
float tree is never whole on the card.

``--float-serve`` skips PTQ and serves the float weights (in ``dequant``:
float leaves run ``x @ w``, attention B2 on float32 pages);
``--compare-float`` serves the same requests again on the float weights
and logs the token agreement ("int8-vs-float token agreement: a/t (p%)"),
the serving-side analogue of the paper's accuracy tables. A dense or MoE
engine probes its attention step (``EngineConfig.attn_probe``), as the
reference's launcher does, and logs it.

``--replicas N`` serves through N engine replicas (one shared quantized
tree) behind the fault-tolerant router (``--placement``). Observability:
``--trace`` records the engine's span ring and ``--trace-out`` exports it
as Chrome trace JSON, ``--metrics-out`` writes the Prometheus text after
the run, ``--metrics-jsonl`` streams a registry snapshot every
``--metrics-every`` engine steps, ``--drift-every N`` samples the
quant-drift monitor, ``--profile-dir`` opens a ``torch.profiler`` window
around the run; progress is logged at ``--log-level``.

    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu \
        --matmul-mode w8a8 --kv-bits 8
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu \
        --matmul-mode w4a8 --kv-bits 4
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu \
        --spec-k 4 --draft-layers 1
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu \
        --matmul-mode w8a8 --kv-bits 8 --compare-float
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu --float-serve
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu \
        --temperature 0.8 --top-k 40 --prefill-budget 16 --chunk-size 16 \
        --admission optimistic
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu \
        --trace --trace-out trace.json --metrics-out metrics.prom --drift-every 2
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu \
        --replicas 2 --placement round_robin
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --smoke --device cpu
    python -m repro_torch.launch.serve --arch hymba-1.5b --smoke --device cpu \
        --matmul-mode w8a8 --kv-bits 8
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --device cpu --paged off \
        --spec-k 4
    python -m repro_torch.launch.serve --arch qwen2-vl-7b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek-7b --smoke --device cpu \
        --ckpt-dir ckpt   # a launch.train checkpoint
    python -m repro_torch.launch.serve --arch deepseek-moe-16b   # the card, full size
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager, place
from ..configs import get_config, list_archs, smoke_config
from ..core.apply import map_with_path, quantize_params
from ..core.recipe import QuantRecipe
from ..device import resolve_device
from ..models import transformer as T
from ..obs.log import add_log_level_arg, get_logger, setup_logging
from ..serving import (
    EngineConfig,
    ReplicaSet,
    Request,
    Router,
    RouterConfig,
    SamplingParams,
    ServingEngine,
    add_engine_config_args,
    engine_config_from_args,
)

log = get_logger("launch.serve")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--ocs-ratio", type=float, default=0.02)
    ap.add_argument("--clip", default="mse")
    ap.add_argument("--float-serve", action="store_true",
                    help="skip PTQ, serve float weights")
    ap.add_argument("--compare-float", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="request top-k restriction (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="request nucleus restriction (1 = off)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through N engine replicas behind the "
                         "fault-tolerant router (1 = the plain single-engine path)")
    ap.add_argument("--placement", default="least_loaded",
                    choices=["least_loaded", "round_robin"],
                    help="router placement policy (only with --replicas > 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="serve the newest checkpoint's parameters (launch.train's format)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--trace-out", default="",
                    help="export the span ring as Chrome trace JSON (requires --trace)")
    ap.add_argument("--metrics-out", default="",
                    help="write Prometheus text exposition after the run")
    ap.add_argument("--metrics-jsonl", default="",
                    help="stream periodic registry snapshots (JSONL)")
    ap.add_argument("--metrics-every", type=int, default=50,
                    help="engine steps between --metrics-jsonl snapshots")
    add_log_level_arg(ap)
    add_engine_config_args(ap, defaults=EngineConfig(max_batch=4, max_len=128))
    return ap


def _make_requests(n, vocab, rng, max_new, sampling=None):
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(0, vocab, plen).tolist()
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=max_new,
                            sampling=sampling))
    return reqs


# Additive per-replica counters the replicated report sums; point-in-time
# percentiles report the worst replica instead (summing a p95 is nonsense).
_SUM_STATS = (
    "completed", "cancelled", "decoded_tokens", "decode_steps", "preempted",
    "shed", "timed_out", "errors", "prefill_tokens", "prefill_calls",
    "prefill_requests", "kv_pages_capacity", "kv_pages_in_use", "sched_chunks",
    "sched_budget_limited_steps", "sched_aging_promotions",
)
_MAX_STATS = (
    "ttft_p50_s", "ttft_p95_s", "itl_p50_s", "itl_p95_s", "mean_latency_s",
    "step_p50_ms", "step_p95_ms", "step_stalled", "queue_wait_p50_s",
    "queue_wait_p95_s", "kv_pool_peak_occupancy",
)


def restore_params(cfg, ckpt_dir: str, device, *, lazy: bool):
    """The newest checkpoint's parameters in ``cfg``'s tree, restored by
    their ``0/...`` paths (a checkpoint of ``(params, opt_state)``; the
    optimizer state is not read). ``lazy``: each leaf a zero-argument
    callable that places its memory-mapped array on ``device``; otherwise
    the whole tree placed."""
    ckpt = CheckpointManager(ckpt_dir, async_write=False)
    shapes = map_with_path(lambda _p, s: torch.empty(s, device="meta"),
                           T.model_params_shape(cfg), is_leaf=lambda x: isinstance(x, tuple))
    (arrays,), meta = ckpt.restore((shapes,))
    log.info("restored %s step %s from %s", meta.get("arch"), ckpt.latest_step(), ckpt_dir)
    if lazy:
        return map_with_path(lambda _p, a: functools.partial(place, a, device), arrays)
    return place(arrays, device)


def serve_replicated(cfg, params, reqs, ecfg: EngineConfig, n: int, placement: str, *,
                     device=None):
    """Serve through the fault-tolerant router (``--replicas N``): stats are
    replica 0's view with additive counters summed (and percentiles taken
    from the worst replica) plus the router's ``router_*`` layer."""
    router = Router(ReplicaSet.build(cfg, params, ecfg, n, device=device),
                    RouterConfig(placement=placement))
    for r in reqs:
        router.submit(r)
    t0 = time.time()
    router.run(max_steps=100_000)
    wall = time.time() - t0
    per = [rep.engine.stats() for rep in router.replicas]
    s = dict(per[0])
    for key in _SUM_STATS:
        s[key] = sum(p[key] for p in per)
    for key in _MAX_STATS:
        s[key] = max(p[key] for p in per)
    s.update(router.stats())
    s["wall_s"] = round(wall, 2)
    s["tokens_per_s"] = round(s["decoded_tokens"] / max(wall, 1e-9), 1)
    return reqs, s, router


def serve_once(cfg, params, reqs, ecfg: EngineConfig, *, device=None,
               metrics_jsonl: str = "", metrics_every: int = 50):
    eng = ServingEngine(cfg, params, ecfg, device=device)
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    if metrics_jsonl:
        # Step by step, so registry snapshots stream while serving (run() is
        # the same loop without the snapshot hook).
        eng.start_profile()
        try:
            with open(metrics_jsonl, "w") as f:
                for _ in range(10_000):
                    busy = eng.step()
                    if eng.steps % max(metrics_every, 1) == 0:
                        f.write(json.dumps({"step": eng.steps, "time": time.time(),
                                            "metrics": eng.metrics_snapshot()}) + "\n")
                    if not busy and not eng.queue:
                        break
                f.write(json.dumps({"step": eng.steps, "time": time.time(),
                                    "metrics": eng.metrics_snapshot()}) + "\n")
        finally:
            eng.stop_profile()
        done = eng.done
    else:
        done = eng.run()
    wall = time.time() - t0
    s = eng.stats()
    s["wall_s"] = round(wall, 2)
    s["tokens_per_s"] = round(s["decoded_tokens"] / max(wall, 1e-9), 1)
    return done, s, eng


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    if args.trace_out and not args.trace:
        raise SystemExit("serve: --trace-out requires --trace")
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(args.seed)

    # Drawn leaf by leaf and quantized as drawn: a full-size MoE tree never
    # holds all of its float32 weights (deepseek-moe-16b: 67.5 GB). The
    # float arms keep the float tree (the same draws, eagerly).
    keep_float = args.float_serve or args.compare_float
    if args.ckpt_dir:
        params = restore_params(cfg, args.ckpt_dir, dev, lazy=not keep_float)
    else:
        params = T.init_params(cfg, seed=args.seed, device=dev, lazy=not keep_float)
    if args.float_serve:
        qparams = params
    else:
        recipe = QuantRecipe(
            w_bits=args.bits, w_clip=args.clip, ocs_ratio=args.ocs_ratio,
            per_channel=True, pad_to=1,
        )
        t0 = time.time()
        qparams = quantize_params(params, recipe, device=dev)
        get_logger("launch.ptq").info(
            "quantized in %.1fs (w%d, ocs r=%s, clip=%s)",
            time.time() - t0, args.bits, args.ocs_ratio, args.clip)

    ecfg = engine_config_from_args(args)
    if cfg.block in ("dense", "moe") and not ecfg.attn_probe:
        ecfg = ecfg.replace(attn_probe=True)  # the probed attention step in the report
    if args.float_serve and ecfg.matmul_mode != "dequant":
        ecfg = ecfg.replace(matmul_mode="dequant")
    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                  top_p=args.top_p, seed=args.seed)
    elif args.top_k or args.top_p < 1.0:
        # temperature == 0 is exact greedy; silently dropping the
        # restriction flags would pass greedy off as sampled decode.
        raise SystemExit("serve: --top-k/--top-p only apply to sampled decode; "
                         "set --temperature > 0")
    reqs = _make_requests(args.n_requests, cfg.vocab, rng, args.max_new,
                          sampling=sampling)
    if args.replicas > 1:
        if args.trace_out or args.metrics_jsonl:
            raise SystemExit(
                "serve: --trace-out/--metrics-jsonl export one engine's telemetry; "
                "with --replicas > 1 use --metrics-out (router registry) instead")
        done, stats, router = serve_replicated(cfg, qparams, reqs, ecfg, args.replicas,
                                               args.placement, device=dev)
        eng = router.replicas[0].engine
    else:
        done, stats, eng = serve_once(cfg, qparams, reqs, ecfg, device=dev,
                                      metrics_jsonl=args.metrics_jsonl,
                                      metrics_every=args.metrics_every)
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
    if stats["kv_page_size"]:
        log.info("paged attention: probed attn step %.3f ms/layer", stats["attn_step_ms"])
    log.info(
        "scheduler: %s, %d chunks, peak %d prefill tokens a step | preempted %d, "
        "shed %d, timed out %d | queue wait p50 %.1f ms / p95 %.1f ms",
        stats["sched_policy"], stats["sched_chunks"],
        stats["sched_peak_step_prefill_tokens"], stats["preempted"], stats["shed"],
        stats["timed_out"], stats["queue_wait_p50_s"] * 1e3,
        stats["queue_wait_p95_s"] * 1e3,
    )
    if stats["spec_enabled"]:
        log.info(
            "speculation: %d rounds, acceptance %.3f, %.2f tokens per target step, "
            "window k=%d", stats["spec_rounds"], stats["spec_acceptance_rate"],
            stats["spec_tokens_per_target_step"], stats["spec_k"],
        )
    if args.replicas > 1:
        log.info(
            "router: %d replicas (%d healthy) | placed %.0f | retried %.0f | migrated "
            "%.0f | drained %.0f | dead %.0f | migrate p50 %.1f ms",
            args.replicas, int(stats["router_healthy_replicas"]), stats["router_placed"],
            stats["router_retried"], stats["router_migrated"], stats["router_drained"],
            stats["router_dead_replicas"], stats["router_migrate_p50_ms"],
        )
    if stats.get("drift_enabled"):
        log.info(
            "quant drift: %.0f samples over %.0f sites | flagged %.0f | max live/calib "
            "ratio %.2f", stats["drift_samples"], stats["drift_sites"],
            stats["drift_flagged_sites"], stats["drift_max_ratio"],
        )
        for site, info in sorted(eng.drift_report().items()):
            if info["ratio"] > 1.0:
                log.warning(
                    "drift site %s: live rate %.2e vs calib %.2e (ratio %.1f, clip %.3g)",
                    site, info["live_rate"], info["calib_rate"], info["ratio"],
                    info["clip"])
    if args.trace_out:
        eng.trace.export(args.trace_out)
        log.info("trace: %d events (%d dropped) -> %s", len(eng.trace), eng.trace.dropped,
                 args.trace_out)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            if args.replicas > 1:
                f.write(router.metrics_text())  # router_* / replica_health_*
            f.write(eng.metrics_text())
        log.info("metrics: Prometheus exposition -> %s", args.metrics_out)
    if args.metrics_jsonl:
        log.info("metrics: JSONL snapshots -> %s", args.metrics_jsonl)

    if args.compare_float and not args.float_serve:
        freqs = _make_requests(args.n_requests, cfg.vocab, np.random.default_rng(args.seed),
                               args.max_new, sampling=sampling)
        fdone, _, _ = serve_once(cfg, params, freqs,
                                 ecfg.replace(matmul_mode="dequant", spec=None), device=dev)
        by_uid = {r.uid: r.output for r in fdone}
        agree = total = 0
        for r in done:
            for a, b in zip(r.output, by_uid.get(r.uid, [])):
                agree += int(a == b)
                total += 1
        log.info("int8-vs-float token agreement: %d/%d (%.1f%%)",
                 agree, total, 100.0 * agree / max(total, 1))
    return stats


if __name__ == "__main__":
    main()
