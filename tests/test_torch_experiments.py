"""Port parity, the experiments slice as a whole: ``experiments.common``'s
training loop, the quick arms of Tables 1, 2, 6 and 7, and the
precision-tier gate (``launch/quality_eval.py``) against the reference's
``benchmarks/`` and ``tools/quality_eval.py`` functions on the same
weights (the reference's seeded inits, carried across with
``params_from_numpy``; no 400-step training here).

Tolerances:

* ``train_loop``: five steps of each subject at its reference settings
  from the same init and batches. Each leaf's change over the steps
  (trained minus init) against the reference's: the root sum of squares of
  the difference within ``DELTA_L2`` of the change's own (seen on the CPU
  at 1 to 8 threads: convnet 5.0e-6 to 5.9e-4, LSTM 1.8e-6, bench LM 0.066
  on its embedding and 0.03 at most elsewhere). AdamW's first steps move an
  element by about the learning rate whatever its gradient's size, so an
  element on a noise-level gradient (the convnet's, whose sums part with
  the thread count; the embedding rows of the LM's rarely seen tokens,
  whose bfloat16 roundings part) can move either way: a leaf's largest
  difference reaches the change's own size, its root sum of squares does
  not. A tree that did not move, or moved along other gradients, reads 1
  or more.
* Table cells on ``Bench(conv_n=256, ppl_batches=1)`` against the
  reference's table code run on the same weights with the same eval sizes
  (its ``convnet_accuracy(n=256)``, ``lm_ppl`` and ``lstm_ppl`` on one
  batch, its ``save_json`` kept from writing): accuracy within one image
  (100 / 256 %), perplexity within ``PPL_RTOL`` relative (the LM) or
  ``LSTM_PPL_RTOL`` (float32), and the same best-clip column per row of
  Table 2 unless the two columns' reference scores are within that
  tolerance of each other (a near-tie).
* The gate's tier metrics (2 batches): top-1 agreements within
  ``TOP1_ATOL``, logit MSEs within ``MSE_RTOL``, pseudo-perplexity within
  ``PPL_RTOL``; the gate's verdict and its violated criteria equal (the
  port follows the kernel route's numerics, the reference's gate its XLA
  route).
"""
import importlib.util
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import jax_tree_to_numpy, torch_threads  # noqa: F401

from repro.models import convnet as JCN
from repro.models import lstm as JLS
from repro.models import transformer as JT

from repro_torch.experiments import common as TC
from repro_torch.experiments import table1 as T1
from repro_torch.experiments import table2 as T2
from repro_torch.experiments import table6 as T6
from repro_torch.experiments import table7 as T7
from repro_torch.interop import params_from_numpy
from repro_torch.launch import quality_eval as TQ

ROOT = Path(__file__).resolve().parents[1]
CONV_N = 256
ONE_IMAGE = 100.0 / CONV_N
PPL_RTOL = 0.01
LSTM_PPL_RTOL = 1e-4
DELTA_L2 = {"convnet": 5e-3, "lstm": 5e-3, "lm": 0.12}
TOP1_ATOL = 0.01
MSE_RTOL = 0.02
_W = {}


def _ref_common():
    import benchmarks.common as JC

    return JC


def _weights(subject):
    """(reference tree, port tree on the CPU): the reference's seeded init
    of the subject at its experiment config."""
    if subject not in _W:
        JC = _ref_common()
        if subject == "convnet":
            p = JCN.init_convnet(JC.CONV_CFG, jax.random.PRNGKey(0))
        elif subject == "lstm":
            p = JLS.init_lstm(JC.LSTM_CFG, jax.random.PRNGKey(1))
        else:
            p = JT.init_params(JC.LM_CFG, jax.random.PRNGKey(2))
        _W[subject] = (p, params_from_numpy(jax_tree_to_numpy(p), "cpu"))
    return _W[subject]


def test_configs_equal_the_reference():
    JC = _ref_common()
    assert vars(TC.CONV_CFG) == vars(JC.CONV_CFG)
    assert vars(TC.LSTM_CFG) == vars(JC.LSTM_CFG)
    import dataclasses

    assert dataclasses.asdict(TC.LM_CFG) == dataclasses.asdict(JC.LM_CFG)
    for t, j in ((TC.LM_DS, JC._LM_DS), (TC.LSTM_DS, JC._LSTM_DS)):
        assert (t.vocab, t.seq_len, t.global_batch, t.seed) == (
            j.vocab, j.seq_len, j.global_batch, j.seed)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [("/".join(path), tree)]


@pytest.mark.parametrize("subject", ["convnet", "lstm", "lm"])
def test_train_loop_five_steps(subject):
    """Five steps of ``common.train_loop`` (the subject's lr, the 400-step
    schedule, weight decay 0.01, clip 1.0) against the reference's jitted
    ``train_loop`` on the same init and batches: each leaf's change."""
    JC = _ref_common()
    jp, tp = _weights(subject)
    if subject == "convnet":
        jb = JC.conv_batches(5)
        jloss, lr = partial(JCN.convnet_loss, cfg=JC.CONV_CFG), 2e-3
    elif subject == "lstm":
        jb = [{k: jnp.asarray(v) for k, v in JC._LSTM_DS.batch_at(i).items()} for i in range(5)]
        jloss, lr = partial(JLS.lstm_loss, cfg=JC.LSTM_CFG), 4e-3
    else:
        jb = [{k: jnp.asarray(v) for k, v in JC._LM_DS.batch_at(i).items()} for i in range(5)]
        jloss, lr = partial(JT.loss_fn, cfg=JC.LM_CFG), 3e-3
    _, batches, tloss, tlr, _ = TC.SUBJECTS[subject]
    assert tlr == lr
    tb = batches(5, "cpu")
    for a, b in zip(tb, jb):  # the same batches
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    want = JC.train_loop(jp, jloss, jb, lr=lr, total=400)
    got = TC.train_loop(tp, tloss, tb, lr=lr, total=400)
    for (path, g), (_, w), (_, i) in zip(_flat(got), _flat(jax_tree_to_numpy(want)),
                                         _flat(jax_tree_to_numpy(jp))):
        d_got, d_want = g.numpy().astype(np.float64) - i, w.astype(np.float64) - i
        err = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
        assert err <= DELTA_L2[subject], (path, err)


@pytest.fixture
def ref_tables(monkeypatch):
    """The reference's table modules with ``benchmarks.common`` serving the
    carried weights, evaluating at the test's sizes and writing nothing."""
    JC = _ref_common()
    conv_acc, lstm_ppl, lm_ppl = JC.convnet_accuracy, JC.lstm_ppl, JC.lm_ppl
    lm_eval = jax.jit(partial(JT.loss_fn, cfg=JC.LM_CFG, scan=True))
    monkeypatch.setattr(JC, "get_convnet", lambda steps=400: (_weights("convnet")[0],
                                                              JC.CONV_CFG))
    monkeypatch.setattr(JC, "get_lstm", lambda steps=400: (_weights("lstm")[0], JC.LSTM_CFG))
    monkeypatch.setattr(JC, "get_lm", lambda steps=400: (_weights("lm")[0], JC.LM_CFG))
    monkeypatch.setattr(JC, "convnet_accuracy", lambda p, **kw: conv_acc(p, n=CONV_N))
    monkeypatch.setattr(JC, "lstm_ppl", lambda p, n_batches=8: lstm_ppl(p, n_batches=1))
    monkeypatch.setattr(JC, "lm_ppl", lambda p, **kw: lm_ppl(p, n_batches=1, eval_fn=lm_eval))
    monkeypatch.setattr(JC, "save_json", lambda name, obj: None)
    import benchmarks.table1_qa_split as J1
    import benchmarks.table2_weight_quant as J2
    import benchmarks.table6_lstm as J6
    import benchmarks.table7_knapsack as J7

    return {"table1": J1, "table2": J2, "table6": J6, "table7": J7}


@pytest.fixture
def bench(tmp_path):
    return TC.Bench("cpu", params={s: _weights(s)[1] for s in ("convnet", "lstm", "lm")},
                    conv_n=CONV_N, ppl_batches=1, out_dir=tmp_path, log=lambda *a: None)


def _close(got, want, subject):
    if subject == "convnet":
        return abs(got - want) <= ONE_IMAGE + 1e-9
    tol = LSTM_PPL_RTOL if subject == "lstm" else PPL_RTOL
    return abs(got - want) <= tol * abs(want)


def test_table1_quick(ref_tables, bench, capsys):
    want = ref_tables["table1"].run(quick=True)
    got = T1.run(quick=True, bench=bench)
    assert [(r["bits"], r["ratio"]) for r in got] == [(r["bits"], r["ratio"]) for r in want]
    for g, w in zip(got, want):
        assert _close(g["qa"], w["qa"], "convnet") and _close(g["naive"], w["naive"], "convnet")
    assert (bench.out_dir / "results" / "table1.json").exists()


def test_table2_quick(ref_tables, bench, capsys):
    want = ref_tables["table2"].run(quick=True)
    got = T2.run(quick=True, bench=bench)
    for subject, key in (("convnet", "convnet"), ("lm", "lm")):
        assert _close(got[key]["float"], want[key]["float"], subject)
        for g, w in zip(got[key]["rows"], want[key]["rows"]):
            assert g["bits"] == w["bits"]
            cols = [k for k in w if k.startswith(("clip:", "ocs"))]
            assert set(cols) == {k for k in g if k.startswith(("clip:", "ocs"))}
            for c in cols:
                assert _close(g[c], w[c], subject), (subject, g["bits"], c, g[c], w[c])
            if g["best_clip"] != w["best_clip"]:  # only at a near-tie of the two columns
                assert _close(w[f"clip:{g['best_clip']}"], w[f"clip:{w['best_clip']}"], subject)


def test_table6_quick(ref_tables, bench, capsys):
    want = ref_tables["table6"].run(quick=True)
    got = T6.run(quick=True, bench=bench)
    for g, w in zip(got, want):
        assert (g["bits"], g["ratio"]) == (w["bits"], w["ratio"])
        for c in [k for k in w if k.startswith("clip:")]:
            assert _close(g[c], w[c], "lstm"), (c, g[c], w[c])


def test_table7_quick(ref_tables, bench, capsys):
    want = ref_tables["table7"].run(quick=True)
    got = T7.run(quick=True, bench=bench)
    for g, w in zip(got, want):
        assert (g["bits"], g["ratio"]) == (w["bits"], w["ratio"])
        for c in ("uniform", "knapsack"):
            assert _close(g[c], w[c], "lm"), (c, g[c], w[c])


def _ref_quality_eval():
    spec = importlib.util.spec_from_file_location("ref_quality_eval",
                                                  ROOT / "tools" / "quality_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quality_gate_against_reference():
    """The gate's tier metrics on the plain versions (2 eval and 2 stress
    batches, outlier ratio 0.1) against ``tools/quality_eval.py``'s
    functions on the same weights, and the same verdict."""
    JQ = _ref_quality_eval()
    JC = _ref_common()
    jp, tp = _weights("lm")
    n = 2
    batches, stress = JQ._eval_batches(n), JQ._stress_batches(n, JC.LM_CFG.vocab)
    for a, b in zip(TQ.eval_batches(n, "cpu") + TQ.stress_batches(n, JC.LM_CFG.vocab,
                                                                  device="cpu"),
                    batches + stress):
        np.testing.assert_array_equal(a["tokens"].numpy(), np.asarray(b["tokens"]))
    q = JQ.quantize_params(jp, JQ._RECIPE)
    trees = {"float": (jp, "dequant"), "int8": (q, "w8a8"),
             "w4a8_ocs": (JQ._convert(q, 0.1), "w4a8"), "w4a8_naive": (JQ._convert(q, 0.0), "w4a8")}
    lg = {k: JQ._tier_logits(p, JC.LM_CFG, batches, m) for k, (p, m) in trees.items()}
    sl = {k: JQ._tier_logits(p, JC.LM_CFG, stress, m) for k, (p, m) in trees.items()}
    want = {}
    for name in trees:
        want[name] = {
            "logit_mse_vs_float": JQ._mse(lg[name], lg["float"]),
            "logit_mse_vs_int8": JQ._mse(lg[name], lg["int8"]),
            "top1_vs_float": JQ._top1_agree(lg[name], lg["float"]),
            "top1_vs_int8": JQ._top1_agree(lg[name], lg["int8"]),
            "pseudo_ppl": JQ._pseudo_ppl(lg[name], batches),
            "top1_stress_vs_float": JQ._top1_agree(sl[name], sl["float"]),
            "logit_mse_stress_vs_float": JQ._mse(sl[name], sl["float"]),
        }
    got = TQ.run(tp, n, 0.1)
    assert set(got) == set(want) | {"int8_dequant"}
    for name, metrics in want.items():
        for k, w in metrics.items():
            g = got[name][k]
            if k.startswith("top1"):
                assert abs(g - w) <= TOP1_ATOL, (name, k, g, w)
            elif k == "pseudo_ppl":
                assert abs(g - w) <= PPL_RTOL * w, (name, k, g, w)
            else:
                assert abs(g - w) <= MSE_RTOL * w, (name, k, g, w)
    assert TQ.FLOORS == JQ.FLOORS

    def criteria(violations):
        return sorted(v.split(":")[0] if " on " not in v else v.split(" on ")[1].split(":")[0]
                      for v in violations)

    assert criteria(TQ.gate(got)) == criteria(JQ.gate(want))
    assert TQ.gate({k: v for k, v in want.items()}) == JQ.gate(want)


def test_quality_eval_cli_cpu(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.quality_eval --device cpu`` on a
    cached bench LM (the carried init): prints every tier and the verdict,
    writes its JSON and exits 1 on this untrained LM's violations."""
    (tmp_path / "cache").mkdir()
    torch.save(_weights("lm")[1], tmp_path / "cache" / "lm.pt")
    rc = TQ.main(["--quick", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    for tier in ("float", "int8", "w4a8_ocs", "w4a8_naive", "int8_dequant"):
        assert tier in out
    assert "quality gate: FAIL" in out and rc == 1
    assert (tmp_path / "results" / "QUALITY_tiers.json").exists()


def test_experiments_run_cli_cpu(tmp_path, capsys):
    """``python -m repro_torch.experiments.run --quick --only table5
    --device cpu`` on cached subjects: the table printed, its JSON and the
    run's timings written; an unknown table refused."""
    (tmp_path / "cache").mkdir()
    for s in ("convnet", "lm"):
        torch.save(_weights(s)[1], tmp_path / "cache" / f"{s}.pt")
    from repro_torch.experiments import run as R

    R.main(["--quick", "--only", "table5", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Table 5 analog" in out and "all tables completed" in out
    assert (tmp_path / "results" / "table5.json").exists()
    assert (tmp_path / "results" / "tables.json").exists()
    with pytest.raises(SystemExit):
        R.main(["--only", "table9", "--device", "cpu", "--out", str(tmp_path)])
