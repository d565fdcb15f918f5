"""Port parity, the activation side of the paper's experiments:
``core.actquant``, activation OCS and Oracle OCS (``core.ocs``),
``act_scales_from_collector``, ``dense``'s static-grid W8A8 branch and its
float-weight site, the convnet's activation sites, Tables 3 and 4, against
``repro`` on the same inputs (seeded numpy, weights carried with
``params_from_numpy``).

Tolerances:

* bitwise: the split specs, the duplicated and folded weight rows, the
  oracle's expansion and ``src`` (ties included), ``post_ocs_clip`` and
  ``act_scales_from_collector`` (the same ``ChannelStats``), the fake-quant
  codes against the reference's *jitted* form at crafted ties, ``act_quant``
  against the reference's with a runtime clip, and ``dense`` in ``w8a8`` on
  calibrated ``a_scale`` leaves (stacked ``[L, 1, 1]``, sliced per layer):
  int8 codes, int32 sums and the ``acc * (a_scale * w_scale)`` epilogue are
  exact.
* the convnet's logits under static-OCS, clip-only and oracle contexts:
  ``CONV_RTOL`` of the largest logit (float32 convolutions sum in another
  order than XLA's; a code on the fixed grid can then flip at a tie);
* the bench LM's ``forward`` under a context: ``LM_RTOL`` of the largest
  logit (bfloat16 activations, ``tests/test_torch_forward.py``'s
  tolerance);
* Tables 3 and 4's quick arms on the reference's table code run on the
  same weights (``Bench(conv_n=256)``): every cell within one image
  (100 / 256 %; the oracle's rows over 512 images, 100 / 512 %).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import (glm_smoke, glm_smoke_served, jax_tree_to_numpy,  # noqa: F401
                            to_np, torch_threads)

from repro.core import actquant as JA
from repro.core import apply as JAP
from repro.core import ocs as JO
from repro.core import tap as JTAP
from repro.core.histogram import ChannelStats as JStats
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import convnet as JCN
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch.core import actquant as TA
from repro_torch.core import ocs as TO
from repro_torch.core import tap as TTAP
from repro_torch.core.apply import act_scales_from_collector
from repro_torch.core.histogram import ChannelStats as TStats
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models import convnet as TCN
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

CONV_RTOL = 1e-3
LM_RTOL = 0.02


def _stats(seed, n_channels=24, batches=3, ties=False):
    """(reference, port) ChannelStats updated with the same seeded batches;
    ``ties`` makes channels with equal exceedance counts and abs-maxima."""
    rng = np.random.default_rng(seed)
    js, ts = JStats(n_channels), TStats(n_channels)
    for _ in range(batches):
        x = rng.standard_normal((16, 5, n_channels)).astype(np.float32)
        x[..., 3] *= 6.0
        x[..., 11] *= 4.0
        if ties:
            x[..., 7] = x[..., 3]
            x[..., 13:17] = 0.0  # ReLU'd-off channels tie at 0
        js.update(x)
        ts.update(x)
    np.testing.assert_array_equal(js.split_order(), ts.split_order())
    return js, ts


def _same_spec(t, j):
    for a in ("src", "mult", "bias"):
        np.testing.assert_array_equal(getattr(t, a).numpy(), np.asarray(getattr(j, a)), a)
        assert getattr(t, a).dtype == (torch.int32 if a == "src" else torch.float32)


@pytest.mark.parametrize("ratio", [0.01, 0.05, 0.2, 0.5])
@pytest.mark.parametrize("qa", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_split_activations_spec_bitwise(ratio, qa, ties):
    js, ts = _stats(1, ties=ties)
    kw = dict(act_delta=0.123456789, qa=True) if qa else {}
    _same_spec(TO.split_activations_spec(ts, ratio, **kw), JO.split_activations_spec(js, ratio, **kw))


def test_duplicate_and_fold_bitwise():
    js, ts = _stats(2)
    jspec, tspec = JO.split_activations_spec(js, 0.1), TO.split_activations_spec(ts, 0.1)
    w = np.random.default_rng(3).standard_normal((24, 10)).astype(np.float32)
    dj = np.asarray(JO.duplicate_weight_rows(jnp.asarray(w), jspec))
    dt = TO.duplicate_weight_rows(torch.from_numpy(w), tspec)
    np.testing.assert_array_equal(dt.numpy(), dj)
    fj, pj = JO.fold_expansion_mult(dj, jspec)
    ft, pt = TO.fold_expansion_mult(dt, tspec)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    _same_spec(pt, pj)
    assert bool((pt.mult == 1.0).all())
    # A QA split's -/+ delta/4 bias cannot move into the weights: both refuse.
    qj = JO.split_activations_spec(js, 0.1, act_delta=0.5, qa=True)
    qt = TO.split_activations_spec(ts, 0.1, act_delta=0.5, qa=True)
    with pytest.raises(ValueError, match="bias == 0"):
        JO.fold_expansion_mult(dj, qj)
    with pytest.raises(ValueError, match="bias == 0"):
        TO.fold_expansion_mult(dt, qt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 6])
def test_oracle_expand_ties_bitwise(dtype, n_split):
    """Channels 2, 5 and 7 share the batch maximum and channels 0, 1, 4, 8
    and 9 are all zero (ReLU'd off): the selection and the duplicates'
    order are ``lax.top_k``'s (largest first, ties to the lower index)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0, 1.0, (3, 4, 10)).astype(np.float32)
    x[..., [0, 1, 4, 8, 9]] = 0.0
    for c in (2, 5, 7):
        x[..., c] = np.clip(x[..., c], -2.0, 2.0)
        x[1, 2, c] = -3.0
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    je, jsrc = JO.oracle_expand(jx, n_split)
    te, tsrc = TO.oracle_expand(tx, n_split)
    np.testing.assert_array_equal(tsrc.numpy(), np.asarray(jsrc))
    assert te.dtype == tx.dtype and str(je.dtype) == dtype
    np.testing.assert_array_equal(to_np(te), np.asarray(je.astype(jnp.float32)))


@pytest.mark.parametrize("method", [None, "mse", "aciq", "kl"])
@pytest.mark.parametrize("ratio", [0.0, 0.05])
def test_post_ocs_clip_bitwise(method, ratio):
    js, ts = _stats(6)
    jspec = JO.split_activations_spec(js, ratio) if ratio else None
    tspec = TO.split_activations_spec(ts, ratio) if ratio else None
    for bits in (4, 8):
        assert TA.post_ocs_clip(ts, tspec, method, bits) == JA.post_ocs_clip(js, jspec, method,
                                                                             bits)


@pytest.mark.parametrize("a_clip", [None, "mse", "aciq", "kl"])
def test_act_scales_from_collector_bitwise(a_clip):
    rng = np.random.default_rng(7)
    jc, tc = JTAP.Collector(), TTAP.Collector()
    for _ in range(3):
        xs = [rng.standard_normal((6, 32)).astype(np.float32) * s for s in (1.0, 3.0, 0.5)]
        jc.begin_batch()
        tc.begin_batch()
        with JTAP.collecting(jc):
            for n, x in zip(("mlp_up", "mlp_up", "lm_head"), xs):
                JTAP.tag(n, jnp.asarray(x))
        with TTAP.collecting(tc):
            for n, x in zip(("mlp_up", "mlp_up", "lm_head"), xs):
                TTAP.tag(n, torch.from_numpy(x))
    for bits in (None, 4, 8):
        jr, tr = JRecipe(a_bits=bits, a_clip=a_clip), TRecipe(a_bits=bits, a_clip=a_clip)
        want = JAP.act_scales_from_collector(jc, jr)
        assert act_scales_from_collector(tc, tr) == want
        assert sorted(want) == ([] if bits is None else ["lm_head#0", "mlp_up#0", "mlp_up#1"])


def _tie_inputs(bits, clip):
    """Values on both sides of every rounding boundary of the grid (the
    exact midpoints of the reciprocal and of the division form, and 20 ulps
    around each), then seeded normals."""
    q = (1 << (bits - 1)) - 1
    step = np.float32(np.float32(clip) / np.float32(q))
    rcp = np.float32(1.0) / step
    xs = []
    for k in range(-q - 1, q + 2):
        for centre in (np.float32((k - 0.5) / float(rcp)), np.float32((k - 0.5) * float(step))):
            v = centre
            for _ in range(20):
                v = np.nextafter(v, np.float32(-np.inf))
            for _ in range(41):
                xs.append(v)
                v = np.nextafter(v, np.float32(np.inf))
    rng = np.random.default_rng(bits)
    return np.concatenate([np.array(xs, np.float32),
                           rng.standard_normal(20000).astype(np.float32) * clip])


@pytest.mark.parametrize("bits,clip", [(4, 0.7310585), (3, 2.3456789), (6, 0.0123),
                                       (8, 5.123), (4, 10.241313934326172)])
def test_fake_quant_fixed_codes_match_jitted_reference(bits, clip):
    """The reference's tables run ``_fake_quant_fixed`` under ``jax.jit``
    with the clip a constant: XLA folds the step's reciprocal and contracts
    the ``+ 0.5`` into a fused multiply-add. The port's codes equal that
    compiled form at ties, where the IEEE division form parts from it."""
    x = _tie_inputs(bits, clip)
    jf = jax.jit(lambda v: JA._fake_quant_fixed(v, bits, clip))
    want = np.asarray(jf(jnp.asarray(x)))
    got = TA._fake_quant_fixed(torch.from_numpy(x), bits, clip).numpy()
    np.testing.assert_array_equal(got, want)
    q = (1 << (bits - 1)) - 1
    step = np.float32(np.float32(clip) / np.float32(q))
    ieee = np.clip(np.floor(x / step + np.float32(0.5)), -q, q) * step
    assert (ieee != want).any()  # the crafted ties discriminate the two forms
    xb = x.astype(jnp.bfloat16)
    wb = np.asarray(jf(jnp.asarray(xb)).astype(jnp.float32))
    gb = TA._fake_quant_fixed(torch.from_numpy(x).to(torch.bfloat16), bits, clip)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_array_equal(gb.float().numpy(), wb)


def test_act_quant_runtime_clip_bitwise():
    x = _tie_inputs(4, 0.7310585)
    jf = jax.jit(lambda v, c: JL.act_quant(v, 4, c))
    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(0.7310585, jnp.float32)))
    got = TL.act_quant(torch.from_numpy(x), 4, torch.tensor(0.7310585))
    np.testing.assert_array_equal(got.numpy(), want)
    assert TL.act_quant(torch.ones(3), None, 1.0).equal(torch.ones(3))


def test_site_key_without_context_is_free():
    assert TA.active_ctx() is None and TA.site_key("mlp_up") is None
    ctx = TA.ActQuantCtx(bits=4, clips={})
    with TA.act_quant_ctx(ctx):
        assert [TA.site_key(n) for n in ("a", "a", "b")] == ["a#0", "a#1", "b#0"]
        ctx.reset()
        assert TA.site_key("a") == "a#0"
    assert TA.active_ctx() is None


def _with_a_scale(qj, seed=11):
    """The reference tree with a calibrated grid (a_bits 8, a_scale [L, 1,
    1]) on every stacked attention and MLP leaf."""
    rng = np.random.default_rng(seed)
    out = dict(qj)
    out["layers"] = {k: dict(v) for k, v in qj["layers"].items()}
    for block, leaves in out["layers"].items():
        for name, leaf in list(leaves.items()):
            if isinstance(leaf, JO.OCSQuantLinear):
                L = leaf.weight.values.shape[0]
                a = rng.uniform(0.005, 0.05, (L, 1, 1)).astype(np.float32)
                leaves[name] = dataclasses.replace(leaf, a_bits=8, a_scale=jnp.asarray(a))
    return out


def test_dense_w8a8_static_grid_bitwise(glm_smoke_served):
    """``dense`` in w8a8 on calibrated ``a_scale`` leaves, sliced per layer
    from the stack, on the plain path (B5's int8 route): bitwise the
    reference's ``dense``."""
    qj, _ = glm_smoke_served
    qa = _with_a_scale(qj)
    qt = params_from_numpy(jax_tree_to_numpy(qa), "cpu")
    rng = np.random.default_rng(12)
    tqm.reset_launches()
    for block in ("attn", "mlp"):
        for name, jleaf in qa["layers"][block].items():
            if not isinstance(jleaf, JO.OCSQuantLinear):
                continue
            tleaf = qt["layers"][block][name]
            assert tuple(tleaf.a_scale.shape) == tuple(jleaf.a_scale.shape)
            k = jleaf.n_orig
            for layer in range(jleaf.weight.values.shape[0]):
                x = (rng.standard_normal((2, 3, k)) * 0.4).astype(np.float32)
                jl = jax.tree.map(lambda a: a[layer], jleaf)
                want = JL.dense(jl, jnp.asarray(x, jnp.bfloat16), mode="w8a8")
                got = TL.dense(tleaf.layer(layer), torch.from_numpy(x).to(torch.bfloat16),
                               mode="w8a8")
                assert got.dtype == torch.bfloat16 and got.shape == want.shape
                np.testing.assert_array_equal(to_np(got), np.asarray(want.astype(jnp.float32)),
                                              f"{block}/{name} layer {layer}")
    # The dequant mode ignores the grid, as the reference's does.
    jl = jax.tree.map(lambda a: a[0], qa["layers"]["mlp"]["w_up"])
    tl = qt["layers"]["mlp"]["w_up"].layer(0)
    x = torch.randn(4, jl.n_orig, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    y_static = TL.dense(dataclasses.replace(tl, a_scale=None), x, mode="dequant")
    assert torch.equal(TL.dense(tl, x, mode="dequant"), y_static)


def test_static_grid_plain_route_is_b5_int8():
    """The static branch's GEMM is ``ops.quant_matmul`` on int8 x (B5's
    int8 route) with ``a_scale`` as the row scale; a per-column a_scale and
    an expert stack with a grid are refused."""
    from repro_torch.core.quantizer import QuantParams
    from repro_torch.core.ocs import OCSQuantLinear, OCSSpec
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(1)
    w8 = torch.randint(-127, 128, (12, 8), generator=g, dtype=torch.int8)
    ws = torch.rand(1, 8, generator=g) * 0.01
    spec = OCSSpec(src=torch.tensor(list(range(10)) + [3, 7], dtype=torch.int32),
                   mult=torch.tensor([1.0] * 10 + [0.5, 0.5]), bias=torch.zeros(12))
    leaf = OCSQuantLinear(QuantParams(w8, ws, 8), spec, n_orig=10, a_bits=8,
                          a_scale=torch.tensor([[0.02]]))
    x = torch.randn(5, 10, generator=g).to(torch.bfloat16)
    got = TL.dense(leaf, x, mode="w8a8")
    xe = TO.expand_activations(x, spec)
    x8 = torch.clamp(torch.floor(xe / torch.tensor(0.02) + 0.5), -127, 127).to(torch.int8)
    want = ref.quant_matmul_ref(x8, w8, torch.full((5,), 0.02), ws.reshape(-1), torch.bfloat16)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="one a_scale per tensor"):
        TL.dense(dataclasses.replace(leaf, a_scale=torch.full((1, 8), 0.02)), x, mode="w8a8")


def _conv_trees(seed=0):
    p = JCN.init_convnet(JCN.ConvNetConfig(n_classes=16), jax.random.PRNGKey(seed))
    return p, params_from_numpy(jax_tree_to_numpy(p), "cpu")


def _calibrate_both(jp, tp, cfg):
    jc, tc = JTAP.Collector(), TTAP.Collector()
    for i in range(2):
        d = JCN.make_synthetic_images(16, cfg, seed=10_000 + i)
        jc.begin_batch()
        tc.begin_batch()
        with JTAP.collecting(jc):
            JCN.convnet_forward(jp, jnp.asarray(d["images"]), cfg)
        with TTAP.collecting(tc), torch.no_grad():
            TCN.convnet_forward(tp, torch.from_numpy(d["images"]), cfg)
    return jc, tc


@pytest.mark.parametrize("kind", ["clip", "static_ocs", "oracle"])
def test_convnet_under_context(kind):
    """The convnet's logits under a clip-only (mse, a4), a static-OCS (r
    0.05, a4, no clip beyond the halved max) and an oracle (r 0.05, a4)
    context, the reference jitted with the same clips and specs: within
    ``CONV_RTOL`` of the largest logit."""
    cfg = JCN.ConvNetConfig(n_classes=16)
    jp, tp = _conv_trees()
    jc, tc = _calibrate_both(jp, tp, cfg)
    assert sorted(tc.sites) == sorted(jc.sites) and len(jc.sites) == 19
    jclips, tclips, jspecs, tspecs = {}, {}, {}, {}
    for site in jc.sites:
        js, ts = jc.sites[site], tc.sites[site]
        if kind == "static_ocs":
            jspecs[site] = JO.split_activations_spec(js, 0.05)
            tspecs[site] = TO.split_activations_spec(ts, 0.05)
        # One set of clips for both (the calibrations part at float32 ulps).
        jclips[site] = tclips[site] = JA.post_ocs_clip(js, jspecs.get(site),
                                                     "mse" if kind == "clip" else None, 4)
    ratio = 0.05 if kind == "oracle" else 0.0
    jctx = JA.ActQuantCtx(bits=4, clips=jclips, specs=jspecs, oracle_ratio=ratio)
    tctx = TA.ActQuantCtx(bits=4, clips=tclips, specs=tspecs, oracle_ratio=ratio)
    x = JCN.make_synthetic_images(8, cfg, seed=777)["images"]

    def jfwd(p, v):
        jctx.reset()
        return JCN.convnet_forward(p, v, cfg)

    with JA.act_quant_ctx(jctx):
        want = np.asarray(jax.jit(jfwd)(jp, jnp.asarray(x)))
    with TA.act_quant_ctx(tctx), torch.no_grad():
        got = TCN.convnet_forward(tp, torch.from_numpy(x), cfg).numpy()
    with torch.no_grad():
        plain = TCN.convnet_forward(tp, torch.from_numpy(x), cfg).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= CONV_RTOL, err
    assert np.abs(got - plain).max() > 0  # the context changed the logits


def test_bench_lm_forward_under_context():
    """The bench LM's ``forward`` under an a6 mse-clip + static-OCS (r
    0.05) context against the reference's ``forward(scan=False)`` jitted
    with the same clips and specs."""
    import benchmarks.common as JC

    cfg = JC.LM_CFG
    jp = JT.init_params(cfg, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax_tree_to_numpy(jp), "cpu")
    toks = JC._LM_DS.batch_at(50_000)["tokens"][:2]
    jc = JTAP.Collector()
    with JTAP.collecting(jc):
        jc.begin_batch()
        JT.forward(jp, jnp.asarray(toks), cfg, scan=False)
    jclips, tclips, jspecs, tspecs = {}, {}, {}, {}
    for site, st in jc.sites.items():
        jspecs[site] = JO.split_activations_spec(st, 0.05)
        tspecs[site] = TO.split_activations_spec(st, 0.05)
        jclips[site] = tclips[site] = JA.post_ocs_clip(st, jspecs[site], "mse", 6)
    jctx = JA.ActQuantCtx(bits=6, clips=jclips, specs=jspecs)
    tctx = TA.ActQuantCtx(bits=6, clips=tclips, specs=tspecs)

    def jfwd(p, t):
        jctx.reset()
        return JT.forward(p, t, cfg, scan=False)

    with JA.act_quant_ctx(jctx):
        want = np.asarray(jax.jit(jfwd)(jp, jnp.asarray(toks)).astype(jnp.float32))
    with TA.act_quant_ctx(tctx), torch.no_grad():
        got = to_np(TT.forward(tp, torch.from_numpy(toks), cfg))
    assert len(jc.sites) == 7 * cfg.n_layers + 1
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LM_RTOL, err


CONV_N = 256


@pytest.fixture
def ref_act_tables(monkeypatch):
    """The reference's Table 3 and 4 modules with ``benchmarks.common``
    serving the carried convnet (the reference's seeded init), evaluating
    ``CONV_N`` images (its ``forward`` kept) and writing nothing."""
    import benchmarks.common as JC

    jp = JCN.init_convnet(JC.CONV_CFG, jax.random.PRNGKey(0))
    conv_acc = JC.convnet_accuracy
    monkeypatch.setattr(JC, "get_convnet", lambda steps=400: (jp, JC.CONV_CFG))
    monkeypatch.setattr(JC, "convnet_accuracy",
                        lambda p, forward=None, **kw: conv_acc(p, n=CONV_N, forward=forward))
    monkeypatch.setattr(JC, "save_json", lambda name, obj: None)
    import benchmarks.table3_act_quant as J3
    import benchmarks.table4_oracle_ocs as J4

    return jp, J3, J4


@pytest.fixture
def act_bench(ref_act_tables, tmp_path):
    from repro_torch.experiments import common as TC

    tp = params_from_numpy(jax_tree_to_numpy(ref_act_tables[0]), "cpu")
    return TC.Bench("cpu", params={"convnet": tp}, conv_n=CONV_N, out_dir=tmp_path,
                    log=lambda *a: None)


def test_table3_quick(ref_act_tables, act_bench):
    from repro_torch.experiments import table3 as T3

    want = ref_act_tables[1].run(quick=True)
    got = T3.run(quick=True, bench=act_bench)
    assert [r["bits"] for r in got] == [r["bits"] for r in want] == [4, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for c in w:
            assert abs(g[c] - w[c]) <= 100.0 / CONV_N + 1e-9, (g["bits"], c, g[c], w[c])
    assert (act_bench.out_dir / "results" / "table3.json").exists()


def test_table4_quick(ref_act_tables, act_bench):
    from repro_torch.experiments import table4 as T4

    want = ref_act_tables[2].run(quick=True)
    got = T4.run(quick=True, bench=act_bench)
    assert [r["batch"] for r in got] == [r["batch"] for r in want] == [1, 8, 128]
    for g, w in zip(got, want):
        assert abs(g["acc"] - w["acc"]) <= 100.0 / 512 + 1e-9, (g, w)
    import json

    saved = json.loads((act_bench.out_dir / "results" / "table4.json").read_text())
    assert set(saved) == {"rows", "no_ocs", "static_ocs", "best_clip"}


def test_oracle_clip_bitwise():
    from repro_torch.experiments import table4 as T4
    import benchmarks.table4_oracle_ocs as J4

    js, ts = _stats(8)
    for r in (0.01, 0.02, 0.3):
        assert T4._oracle_clip(ts, r) == J4._oracle_clip(js, r)


STATIC_RTOL = 0.06  # logits in w8a8 (tests/test_torch_forward.py's QUANT_RTOL["w8a8"])
TIE_TOL = 0.25  # a greedy parting's top-2 margin (tests/test_torch_engine.py's)


def test_engine_serves_a_scale_tree_w8a8(glm_smoke_served, monkeypatch):
    """A smoke glm4-9b tree with calibrated grids served in w8a8 on float32
    pages by both engines: the same tokens (a parting only at a near-tie
    of the reference's logits), every w8a8 matmul on the static branch
    (B5's int8 route), and ``forward``'s logits within ``STATIC_RTOL``."""
    from repro.serving import EngineConfig as JConfig
    from repro.serving import KernelConfig
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine
    from repro_torch.serving import EngineConfig as TConfig
    from repro_torch.serving import Request as TRequest
    from repro_torch.serving import ServingEngine as TEngine
    from repro.configs import smoke_config

    cfg = smoke_config("glm4-9b")
    qj, _ = glm_smoke_served
    qa = _with_a_scale(qj)
    qt = params_from_numpy(jax_tree_to_numpy(qa), "cpu")
    common = dict(max_batch=3, max_len=64, matmul_mode="w8a8")
    je = JEngine(cfg, qa, JConfig(**common, kernels=KernelConfig(matmul="xla", attn="xla")))
    te = TEngine(cfg, qt, TConfig(**common), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(9, 30))).tolist() for _ in range(4)]
    for i, p in enumerate(prompts):
        je.submit(JRequest(uid=i, prompt=p, max_new_tokens=8))
        te.submit(TRequest(uid=i, prompt=p, max_new_tokens=8))
    calls = {"static": 0, "dynamic": 0}

    def counted(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TL, "_static_w8a8", counted(TL._static_w8a8, "static"))
    monkeypatch.setattr(TL, "_fused_w8a8", counted(TL._fused_w8a8, "dynamic"))
    je.run()
    te.run()
    assert te.stats()["completed"] == 4 == je.stats()["completed"]
    # Every call runs the 7 gridded matmuls of each layer on the static
    # branch and the lm_head (quantized, no grid) on the dynamic one.
    assert calls["static"] > 0 and calls["static"] == 7 * cfg.n_layers * calls["dynamic"]

    def fwd(params, toks):
        with JL.serving_mode("w8a8"):
            return JT.forward(params, toks, cfg)

    jfwd = jax.jit(fwd)
    out_j = {r.uid: r.output for r in je.done}
    for r in te.done:
        want = out_j[r.uid]
        cut = next((j for j, (x, y) in enumerate(zip(r.output, want)) if x != y), None)
        if cut is not None:
            toks = np.array([prompts[r.uid] + want[:cut]], np.int32)
            top = np.sort(np.asarray(jfwd(qa, jnp.asarray(toks))[0, -1].astype(jnp.float32)))
            assert top[-1] - top[-2] <= TIE_TOL, (r.uid, cut)
    toks = np.array([prompts[0][:9], prompts[1][:9]], np.int32)
    want = np.asarray(jfwd(qa, jnp.asarray(toks)).astype(jnp.float32))
    with torch.no_grad():
        got = to_np(TT.forward(qt, torch.from_numpy(toks), cfg, mode="w8a8"))
    assert np.abs(got - want).max() / np.abs(want).max() <= STATIC_RTOL
