"""Serve an OCS-quantized model through the streaming request lifecycle,
the port of ``examples/serve_quantized.py``.

Builds a smoke-scale model, quantizes its weights with OCS + MSE to int8,
and drives :class:`repro_torch.serving.ServingEngine` through the typed
serving API:

* ``EngineConfig``: one validated config object;
* ``engine.generate(prompt, SamplingParams(...)) -> Iterator[TokenEvent]``:
  tokens stream as they land (the first arrives while other requests are
  still decoding), greedy and sampled side by side;
* ``engine.cancel(uid)``: a long request is cancelled mid-decode and its
  pages are reclaimed on the spot;
* ``--inject-nan STEP``: the overload-safety demo. A NaN is injected into
  the step producing one request's output token ``STEP``; the finite check
  quarantines exactly that lane (``finish_reason="error"``) while its
  co-resident lanes' outputs stay bit-identical to a clean run;
* a hybrid (hymba) engine and, with ``--spec``, the self-speculative
  engine, through the same config surface.

Run:  python -m repro_torch.examples.serve_quantized [--device cpu]
      python -m repro_torch.examples.serve_quantized --spec
      python -m repro_torch.examples.serve_quantized --inject-nan 3
"""
import argparse
import time

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.core.apply import quantize_params
from repro_torch.core.recipe import QuantRecipe
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, Request, SamplingParams, ServingEngine


def build_engine(arch, dev, *, bits=8, spec=None, max_batch=3, max_len=96):
    cfg = smoke_config(arch)
    params = T.init_params(cfg, seed=0, device=dev)
    recipe = QuantRecipe(w_bits=bits, w_clip="mse", ocs_ratio=0.02, per_channel=True, pad_to=1)
    qparams = quantize_params(params, recipe, device=dev)
    ecfg = EngineConfig(max_batch=max_batch, max_len=max_len, spec=spec)
    return cfg, ServingEngine(cfg, qparams, ecfg, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--spec", action="store_true",
                    help="also demo self-speculative decoding (dense arch)")
    ap.add_argument("--spec-k", type=int, default=3)
    ap.add_argument("--inject-nan", type=int, default=0, metavar="STEP",
                    help="demo the nonfinite guard: poison the step that "
                         "produces output token STEP of one request (>= 1)")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    cfg, eng = build_engine(args.arch, dev, bits=args.bits)

    # Background traffic: two batch requests keep lanes busy while we stream
    # (the engine has 3 lanes), so first tokens arrive before the batch
    # completes.
    for i in range(2):
        eng.submit(Request(uid=100 + i, prompt=rng.integers(0, cfg.vocab, 7).tolist(),
                           max_new_tokens=16))

    print(f"--- streaming (greedy) off the int8 {cfg.name} engine on {dev} ---")
    t0 = time.perf_counter()
    toks = []
    for ev in eng.generate(rng.integers(0, cfg.vocab, 5).tolist(), max_new_tokens=8):
        toks.append(ev.token)
        stamp = (ev.t - t0) * 1e3
        print(f"  token[{ev.index}] = {ev.token:5d}  (+{stamp:6.0f} ms"
              f"{', finished: ' + str(ev.finish_reason) if ev.finished else ''})")
        if ev.index == 0:
            busy = sum(1 for s in eng.slots if s.req is not None)
            print(f"  ... first token streamed with {busy} lanes still busy")
    assert len(toks) == 8

    print("--- streaming (sampled: temperature=0.8, top_k=40) ---")
    sampled = list(eng.generate(rng.integers(0, cfg.vocab, 5).tolist(),
                                SamplingParams(temperature=0.8, top_k=40, seed=7),
                                max_new_tokens=8))
    print("  sampled tokens:", [e.token for e in sampled])
    assert len(sampled) == 8 and sampled[-1].finished

    print("--- cancellation mid-decode ---")
    victim = Request(uid=999, prompt=rng.integers(0, cfg.vocab, 6).tolist(), max_new_tokens=64)
    eng.submit(victim)
    for _ in range(4):
        eng.step()
    assert eng.cancel(999)
    eng.run()  # drain everything else
    s = eng.stats()
    print(f"  cancelled after {len(victim.output)} tokens (reason={victim.finish_reason}); "
          f"kv pages in use: {s['kv_pages_in_use']:.0f}")
    assert victim.finish_reason == "cancelled"
    assert s["kv_pages_in_use"] == 0 and s["cancelled"] == 1
    print(f"  ttft p50 {s['ttft_p50_s'] * 1e3:.0f} ms | itl p50 {s['itl_p50_s'] * 1e3:.1f} ms | "
          f"matmul mode: {s['matmul_mode']}")

    if args.inject_nan:
        print(f"--- nonfinite guard (NaN injected at output step {args.inject_nan}) ---")
        # Fresh engines, three co-resident lanes; the clean run is the oracle.
        fcfg, clean_eng = build_engine(args.arch, dev, bits=args.bits)
        frng = np.random.default_rng(42)
        prompts = [frng.integers(0, fcfg.vocab, 5 + i).tolist() for i in range(3)]

        def fresh_reqs():
            return [Request(uid=i, prompt=list(p), max_new_tokens=10)
                    for i, p in enumerate(prompts)]

        clean = fresh_reqs()
        for r in clean:
            clean_eng.submit(r)
        clean_eng.run()

        _, fault_eng = build_engine(args.arch, dev, bits=args.bits)
        faulty = fresh_reqs()
        for r in faulty:
            fault_eng.submit(r)
        fault_eng.inject_fault(1, args.inject_nan)
        fault_eng.run()

        errored = [r for r in faulty if r.finish_reason == "error"]
        assert len(errored) == 1 and errored[0].uid == 1, (
            "exactly the poisoned lane must be quarantined")
        for r in faulty:
            if r.uid != 1:
                ref = next(c for c in clean if c.uid == r.uid)
                assert r.output == ref.output, f"co-resident lane {r.uid} diverged"
        fs = fault_eng.stats()
        assert fs["errors"] == 1 and fs["kv_pages_in_use"] == 0
        print(f"  lane uid=1 quarantined after {len(errored[0].output)} tokens "
              f"(reason={errored[0].finish_reason}); co-resident lanes bit-identical to "
              f"the clean run; errors counter: {fs['errors']:.0f}")

    print("--- hybrid (hymba) engine through the same config surface ---")
    hcfg, heng = build_engine("hymba-1.5b", dev, bits=args.bits)
    for i in range(3):
        heng.submit(Request(uid=i, prompt=rng.integers(0, hcfg.vocab, 6).tolist(),
                            max_new_tokens=4))
    hdone = heng.run()
    assert len(hdone) == 3
    print(f"  served {len(hdone)}/3 requests on {hcfg.name} (unpaged: {heng.paged is False})")

    if args.spec:
        from repro_torch.serving import SpecConfig

        print("--- self-speculative decoding (the quantized model drafts for itself) ---")
        scfg, seng = build_engine(args.arch, dev, bits=args.bits, spec=SpecConfig(k=args.spec_k))
        for i in range(6):
            seng.submit(Request(uid=i, prompt=rng.integers(0, scfg.vocab, 7).tolist(),
                                max_new_tokens=8))
        sdone = seng.run()
        ss = seng.stats()
        assert len(sdone) == 6 and ss["spec_rounds"] > 0
        print(f"  {ss['spec_acceptance_rate']:.0%} of drafts accepted, "
              f"{ss['spec_tokens_per_target_step']:.2f} tokens committed per target step "
              f"({ss['decode_steps']:.0f} target steps for {ss['decoded_tokens']:.0f} decode "
              "tokens)")

    print("\nserved all requests through the int8 OCS engine")
    return {"streamed": toks, "sampled": [e.token for e in sampled]}


if __name__ == "__main__":
    main()
