"""The port's training launcher (``python -m repro_torch.launch.train``,
``--device cpu``), its checkpoints served by ``launch.serve --ckpt-dir``,
and the ``train_then_quantize`` example.

* The reference's kill-and-restart drill (``tests/test_substrates.py``):
  deepseek-7b smoke, 10 steps of batch 2 x 32, a checkpoint every 3;
  one run uninterrupted, one killed after step 6 (exit code 1) and rerun
  (exit code 0, "restored step 6"): every array of the two final
  checkpoints bitwise equal (the reference's test allows 1e-6).
* The uninterrupted run's final parameters against the reference's
  ``make_train_step`` looped 10 steps with the launcher's ``TrainHyper``
  from the same initial weights and batches: the weights as a whole
  within ``DELTA_RTOL`` of the reference's change (~3.9% seen), each leaf
  within ``PARAM_TOL`` learning-rate units (the largest difference over
  the sum of the ten steps' ``lr``, ~0.77 seen on ``embed``; see
  ``_torch_steps.py``), the logged losses within ``LOSS_RTOL``.
* ``--ptq-after``: the float and the three recipes' evaluation losses
  against the reference's ``fake_quantize_params`` and ``loss_fn`` on the
  same trained tree, within ``LOSS_RTOL`` (the fake-quantized weights are
  bitwise the reference's, ``test_torch_fake_quant.py``; bf16
  activations differ) plus the printed rounding.
* ``launch.serve --ckpt-dir``: the tokens served from a checkpoint (its
  memory-mapped arrays the lazy leaves of ``quantize_params``) bitwise
  those served from the trained tree held in memory.
* ``train_then_quantize``: the reference's claim check (OCS + clip within
  0.05 of clipping alone) on its default 300 steps.
* ``--mesh debug`` and ``production`` refuse, naming the decision.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import jax_tree_to_numpy, torch_threads  # noqa: F401
from _torch_steps import DELTA_RTOL, flat, tree_delta

from repro.core.apply import fake_quantize_params as j_fake_quantize_params
from repro.core.recipe import QuantRecipe as JRecipe
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw_init as j_adamw_init

from repro_torch.checkpoint import CheckpointManager, place
from repro_torch.configs import smoke_config
from repro_torch.core.apply import quantize_params
from repro_torch.core.recipe import QuantRecipe
from repro_torch.launch import serve as S
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 2e-3
PARAM_TOL = 2.0  # learning-rate units
ARGS = ["--arch", "deepseek-7b", "--smoke", "--steps", "10", "--batch", "2", "--seq", "32",
        "--ckpt-every", "3", "--log-every", "1", "--device", "cpu"]


def _to_np(tree):
    """The port's float tree as numpy (dicts of arrays)."""
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _final(d):
    """(manifest, {path: array}) of the newest checkpoint in ``d``."""
    mgr = CheckpointManager(d, async_write=False)
    step = mgr.latest_step()
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        man = json.load(f)
    arrays = {p: np.load(os.path.join(d, f"step_{step:08d}", r["file"]))
              for p, r in man["arrays"].items()}
    return man, arrays


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The drill's three runs: (run directories, their completed
    processes). The uninterrupted run also does ``--ptq-after``."""
    root = tmp_path_factory.mktemp("drill")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "2"}
    base = [sys.executable, "-m", "repro_torch.launch.train"] + ARGS
    a, b = str(root / "a"), str(root / "b")

    def start(*extra):
        return subprocess.Popen(base + list(extra), env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    pa = start("--ckpt-dir", a, "--ptq-after", "--metrics-out", str(root / "a.jsonl"))
    pb = start("--ckpt-dir", b, "--simulate-failure", "6")
    runs = {"a": pa, "b1": pb}
    out = {k: p.communicate(timeout=600) + (p.returncode,) for k, p in runs.items()}
    p2 = start("--ckpt-dir", b)
    out["b2"] = p2.communicate(timeout=600) + (p2.returncode,)
    return {"a": a, "b": b, "metrics": str(root / "a.jsonl")}, out


def test_kill_and_restart_drill_bitwise(drill):
    dirs, out = drill
    assert out["a"][2] == 0, out["a"][1][-2000:]
    assert out["b1"][2] == 1, out["b1"][1][-2000:]
    assert "SIMULATED FAILURE at step 6" in out["b1"][1]
    assert out["b2"][2] == 0, out["b2"][1][-2000:]
    assert "restored step 6" in out["b2"][0]
    assert CheckpointManager(dirs["b"], async_write=False).all_steps() == [6, 9, 10]
    ma, xa = _final(dirs["a"])
    mb, xb = _final(dirs["b"])
    assert ma == mb and ma["step"] == 10
    assert ma["meta"] == {"data": {"seed": 0, "step": 10}, "arch": "deepseek-7b-smoke"}
    assert list(ma["arrays"])[0] == "0/embed" and list(ma["arrays"])[-1] == "1/.count"
    for p in xa:
        assert xa[p].dtype == xb[p].dtype and np.array_equal(xa[p], xb[p]), p
    assert int(xa["1/.count"]) == 10
    beat = json.load(open(os.path.join(dirs["b"], "heartbeat.json")))
    assert beat["step"] == 9


def test_uninterrupted_run_matches_reference_steps(drill):
    """The reference's jitted step, looped 10 times from the port's initial
    weights with the launcher's hyperparameters, on the same stream."""
    dirs, _ = drill
    args = TR.build_parser().parse_args(ARGS)
    hyper = TR.hyper_for(args)
    cfg = smoke_config("deepseek-7b")
    init = T.init_params(cfg, seed=0, device="cpu")
    pj = jax.tree.map(jnp.asarray, _to_np(init))
    oj = j_adamw_init(pj)
    step = jax.jit(JS.make_train_step(cfg, JS.TrainHyper(**vars(hyper))))
    ds = JSyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)
    want = []
    for i in range(args.steps):
        pj, oj, m = step(pj, oj, {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()})
        want.append({k: float(v) for k, v in m.items()})
    got = [json.loads(line) for line in open(dirs["metrics"])]
    assert [r["step"] for r in got] == list(range(10))
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * w["loss"] + 5e-5, (g, w)
        assert abs(g["lr"] - w["lr"]) <= 1e-6 * max(w["lr"], 1e-30)
    _, xa = _final(dirs["a"])
    lr_sum = sum(w["lr"] for w in want)
    got = {p[2:]: v for p, v in xa.items() if p.startswith("0/")}
    assert tree_delta(got, pj, _to_np(init)) <= DELTA_RTOL
    for path, leaf in flat(jax_tree_to_numpy(pj)):
        d = np.abs(got[path].astype(np.float64) - leaf).max()
        assert d <= PARAM_TOL * lr_sum, (path, d / lr_sum)


def test_ptq_after_matches_reference(drill):
    dirs, out = drill
    line = next(ln for ln in out["a"][0].splitlines() if ln.startswith("[ptq]"))
    got = ast.literal_eval(line.split("eval loss: ", 1)[1])
    assert list(got) == ["float", "clip_mse", "ocs", "ocs+clip"]
    _, xa = _final(dirs["a"])
    cfg = smoke_config("deepseek-7b")
    shapes = T.model_params_shape(cfg)
    pj = _unflat(shapes, {p[2:]: v for p, v in xa.items() if p.startswith("0/")})
    ds = JSyntheticLM(cfg.vocab, 32, 2, seed=0)
    loss = jax.jit(lambda p, b: JT.loss_fn(p, b, cfg))

    def evaluate(p):
        return float(np.mean([float(loss(p, {k: jnp.asarray(v) for k, v in
                                             ds.batch_at(10_000 + i).items()}))
                              for i in range(4)]))

    want = {"float": evaluate(pj)}
    for name, recipe in TR.ptq_recipes(5, 0.02):
        jr = JRecipe(w_bits=recipe.w_bits, w_clip=recipe.w_clip, ocs_ratio=recipe.ocs_ratio)
        want[name] = evaluate(j_fake_quantize_params(pj, jr))
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_RTOL * w + 5e-5, (k, got[k], w)


def _unflat(shapes, arrays, path=()):
    if isinstance(shapes, dict):
        return {k: _unflat(v, arrays, path + (k,)) for k, v in shapes.items()}
    return jnp.asarray(arrays["/".join(path)])


def test_serve_from_checkpoint_equals_in_memory_tree(tmp_path, monkeypatch):
    """Train in this process (the launcher's loop), keep the trained tree,
    then serve the checkpoint through ``launch.serve --ckpt-dir`` and the
    kept tree through the same engine: the same tokens."""
    kept = {}
    make = TR.make_train_step

    def keeping(cfg, hyper):
        step = make(cfg, hyper)

        def run(params, opt_state, batch):
            kept["params"], kept["opt"], m = step(params, opt_state, batch)
            return kept["params"], kept["opt"], m

        return run

    monkeypatch.setattr(TR, "make_train_step", keeping)
    ck = str(tmp_path / "ck")
    TR.main(ARGS + ["--ckpt-dir", ck, "--log-every", "50"])
    served = {}
    serve_once = S.serve_once

    def recording(cfg, params, reqs, ecfg, **kw):
        done, stats, eng = serve_once(cfg, params, reqs, ecfg, **kw)
        served.update(cfg=cfg, ecfg=ecfg, outputs={r.uid: list(r.output) for r in done})
        return done, stats, eng

    monkeypatch.setattr(S, "serve_once", recording)
    S.main(["--arch", "deepseek-7b", "--smoke", "--device", "cpu", "--ckpt-dir", ck,
            "--n-requests", "4", "--max-new", "8", "--seed", "3"])
    recipe = QuantRecipe(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True, pad_to=1)
    q = quantize_params(kept["params"], recipe, device="cpu")
    reqs = S._make_requests(4, served["cfg"].vocab, np.random.default_rng(3), 8)
    done, _, _ = serve_once(served["cfg"], q, reqs, served["ecfg"], device="cpu")
    assert {r.uid: list(r.output) for r in done} == served["outputs"]
    assert all(len(v) == 8 for v in served["outputs"].values())
    # The checkpoint holds the kept tree bitwise (and restores into it).
    (params, _), _ = CheckpointManager(ck, async_write=False).restore(
        (kept["params"], adamw_init(kept["params"])))
    for (p, a), (_, b) in zip(flat(place(params, "cpu")), flat(kept["params"])):
        assert torch.equal(a, b), p


def test_train_then_quantize_claim_check(tmp_path, capsys):
    from repro_torch.examples import train_then_quantize

    res = train_then_quantize.main(["--device", "cpu", "--ckpt-dir", str(tmp_path / "e2e")])
    assert res["ocs+clip"] <= res["clip_mse"] + 0.05
    assert "claim check: OCS+clip <= clip alone" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path / "e2e"), async_write=False).latest_step() == 300


@pytest.mark.parametrize("mesh", ["debug", "production"])
def test_mesh_other_than_single_refuses(mesh):
    with pytest.raises(SystemExit, match="not applicable"):
        TR.main(ARGS + ["--mesh", mesh])
