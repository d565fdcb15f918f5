"""Port parity, fake-quant evaluation: ``core.ocs.collapse_expanded``,
``core.allocate`` (knapsack), ``core.apply.fake_quantize_params`` and Table
5's overhead counts against the reference's on the same weights.

Every comparison is exact. The trees are the three experiment subjects'
layouts at reduced width (the convnet with one block a stage, the LSTM at
hidden 64 and vocab 128, the bench LM at 2 layers, d_model 64, d_ff 128,
vocab 128: every split count of r = 0.02 and r = 0.05 still differs; the
convnet's HWIO leaves are stacks of 9 slices), drawn by the reference's own
inits and carried across with ``params_from_numpy``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import jax_tree_to_numpy, torch_threads  # noqa: F401

from repro.configs.base import ModelConfig as JMC
from repro.core import allocate as JAL
from repro.core import ocs as JO
from repro.core.apply import fake_quantize_params as j_fake_quantize_params
from repro.core.apply import knapsack_splits as j_knapsack_splits
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import convnet as JCN
from repro.models import lstm as JLS
from repro.models import transformer as JT

from repro_torch.core import allocate as TAL
from repro_torch.core import ocs as TO
from repro_torch.core.apply import fake_quantize_params as t_fake_quantize_params
from repro_torch.core.apply import knapsack_splits as t_knapsack_splits
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.experiments import table5 as TT5
from repro_torch.interop import params_from_numpy

LM_KW = dict(name="bench-lm", block="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab=128, attn_chunk=64, remat=False)
_TREES = {}


def _trees(subject):
    """(reference tree, port tree on the CPU) for a subject at test width."""
    if subject not in _TREES:
        if subject == "convnet":
            cfg = JCN.ConvNetConfig(n_classes=16, width=16, n_blocks=1, img=16)
            p = JCN.init_convnet(cfg, jax.random.PRNGKey(0))
        elif subject == "lstm":
            p = JLS.init_lstm(JLS.LSTMConfig(vocab=128, hidden=64), jax.random.PRNGKey(1))
        else:
            p = JT.init_params(JMC(**LM_KW), jax.random.PRNGKey(2))
        _TREES[subject] = (p, params_from_numpy(jax_tree_to_numpy(p), "cpu"))
    return _TREES[subject]


@pytest.fixture(scope="module")
def memo_ref_clip():
    """The reference's ``find_clip`` as called by its ``split_weights``,
    memoized on the array's bytes for this module: a pure function of its
    inputs, which the cross product below calls with equal arguments many
    times over (per-channel scales and the knapsack's equal split counts
    do not change the split); its 8-bit KL search takes ~50 ms a call."""
    import repro.core.ocs as jocs

    orig = jocs.find_clip
    cache = {}

    def find_clip(x, bits, method):
        if not isinstance(x, np.ndarray):
            return orig(x, bits, method)
        key = (x.shape, x.dtype.str, x.tobytes(), bits, method)
        if key not in cache:
            cache[key] = orig(x, bits, method)
        return cache[key]

    jocs.find_clip = find_clip
    yield
    jocs.find_clip = orig


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _assert_trees_bitwise(got, want):
    got, want = _flat(got), _flat(jax_tree_to_numpy(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=path)


@pytest.mark.parametrize("subject", ["convnet", "lstm", "lm"])
@pytest.mark.parametrize("clip", [None, "mse", "aciq", "kl"])
@pytest.mark.parametrize("bits", [3, 4, 6, 8])
def test_fake_quantize_params_bitwise(subject, clip, bits, memo_ref_clip):
    """Every leaf bitwise the reference's, for each expand ratio {0, 0.02,
    0.05} x per-channel scales on/off x allocation {uniform, knapsack} at
    this subject, clip method and bit width (at r = 0 the knapsack's
    budget is 0, the uniform allocation)."""
    jp, tp = _trees(subject)
    for ratio in (0.0, 0.02, 0.05):
        for per_channel in (False, True):
            for alloc in ("uniform", "knapsack") if ratio else ("uniform",):
                kw = dict(w_bits=bits, w_clip=clip, ocs_ratio=ratio, per_channel=per_channel,
                          alloc=alloc)
                got = t_fake_quantize_params(tp, TRecipe(**kw))
                want = j_fake_quantize_params(jp, JRecipe(**kw))
                _assert_trees_bitwise(got, want)


def test_fake_quantize_params_keeps_dtype_and_skips():
    """A bfloat16 leaf stays bfloat16 (bitwise the reference's), skipped
    leaves are returned as they are, and w_bits >= 32 returns the tree."""
    jp, tp = _trees("lm")
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tb = params_from_numpy(jax_tree_to_numpy(jax.tree.map(lambda x: x.astype(jnp.float32), jb)),
                           "cpu")
    tb = jax.tree.map(lambda t: t.to(torch.bfloat16), tb)
    kw = dict(w_bits=4, w_clip="mse", ocs_ratio=0.05)
    got = t_fake_quantize_params(tb, TRecipe(**kw))
    want = j_fake_quantize_params(jb, JRecipe(**kw))
    for (path, g), (_, w) in zip(_flat(got), _flat(want)):
        assert g.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16), err_msg=path)
    assert got["embed"] is tb["embed"]
    assert t_fake_quantize_params(tp, TRecipe(w_bits=32)) is tp


@pytest.mark.parametrize("subject", ["convnet", "lstm", "lm"])
@pytest.mark.parametrize("ratio", [0.01, 0.02, 0.05, 0.2])
def test_knapsack_splits_equal(subject, ratio):
    """``knapsack_splits`` (and ``knapsack_allocate`` under it) gives the
    reference's dict."""
    jp, tp = _trees(subject)
    got = t_knapsack_splits(tp, TRecipe(ocs_ratio=ratio, alloc="knapsack"))
    want = j_knapsack_splits(jp, JRecipe(ocs_ratio=ratio, alloc="knapsack"))
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_knapsack_allocate_and_curve(seed):
    """``range_reduction_curve`` and ``knapsack_allocate`` on numpy and on
    torch weights equal the reference's, tied channel maxima included."""
    rng = np.random.default_rng(seed)
    layers = []
    for i, (cin, cout) in enumerate([(64, 32), (48, 96), (128, 16), (32, 32)]):
        w = rng.standard_normal((cin, cout)).astype(np.float32)
        if i == 3:
            w[:4] = w[0]  # tied maxima: a zero marginal reward, then a positive one
        layers.append((f"l{i}", w))
    for name, w in layers:
        np.testing.assert_array_equal(TAL.range_reduction_curve(torch.from_numpy(w), 12),
                                      JAL.range_reduction_curve(w, 12))
    for ratio in (0.01, 0.05, 0.3):
        want = JAL.knapsack_allocate(layers, ratio)
        assert TAL.knapsack_allocate(layers, ratio) == want
        assert TAL.knapsack_allocate([(n, torch.from_numpy(w)) for n, w in layers],
                                     ratio) == want


def _random_spec(rng, n_orig, n_exp, with_bias):
    src = np.concatenate([np.arange(n_orig), rng.integers(0, n_orig, n_exp - n_orig)])
    mult = rng.choice([0.5, 1.0, 0.25, -1.0], n_exp).astype(np.float32)
    bias = (rng.standard_normal(n_exp).astype(np.float32) if with_bias
            else np.zeros(n_exp, np.float32))
    return src.astype(np.int32), mult, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_collapse_expanded_bitwise(with_bias, seed):
    """``collapse_expanded`` on a spec that sends several rows (up to a
    row's fourth copy) to one channel, with mult != 1 and, optionally, a
    bias: the effective weights and output bias bitwise the reference's
    float64 ``np.add.at`` order."""
    rng = np.random.default_rng(seed)
    n_orig, n_exp, cout = 40, 64, 24
    src, mult, bias = _random_spec(rng, n_orig, n_exp, with_bias)
    src[n_orig:n_orig + 3] = 7  # channel 7 gets four terms
    w_exp = (rng.standard_normal((n_exp, cout)) * np.exp(rng.uniform(-8, 8, (n_exp, 1)))
             ).astype(np.float32)
    jspec = JO.OCSSpec(src=jnp.asarray(src), mult=jnp.asarray(mult), bias=jnp.asarray(bias))
    tspec = TO.OCSSpec(src=torch.from_numpy(src), mult=torch.from_numpy(mult),
                       bias=torch.from_numpy(bias))
    we, yb = JO.collapse_expanded(w_exp, jspec, n_orig)
    ge, gb = TO.collapse_expanded(torch.from_numpy(w_exp), tspec, n_orig)
    np.testing.assert_array_equal(_bits(ge.numpy()), _bits(we))
    np.testing.assert_array_equal(_bits(gb.numpy()), _bits(yb))


@pytest.mark.parametrize("bits,ratio,qa", [(3, 0.05, True), (4, 0.1, False), (6, 0.2, True)])
def test_collapse_of_split_bitwise(bits, ratio, qa):
    """The split -> quantize -> collapse chain of one matrix: the collapsed
    effective weights bitwise the reference's."""
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[5, 3] = 9.0
    wj, sj, tj = JO.split_weights(w, ratio, bits, qa=qa)
    wt, st, tt = TO.split_weights(torch.from_numpy(w), ratio, bits, qa=qa)
    from repro.core.quantizer import fake_quant as jfq
    from repro_torch.core.quantizer import fake_quant as tfq

    want = JO.collapse_expanded(np.asarray(jfq(jnp.asarray(wj), bits, clip=tj)), sj, 96)[0]
    got = TO.collapse_expanded(tfq(wt, bits, clip=tt), st, 96)[0]
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_expanded_channels():
    for cin in (1, 3, 64, 128, 4096, 13696):
        for ratio in (0.0, 0.01, 0.02, 0.05, 0.1):
            for pad in (1, 8, 128):
                assert TO.expanded_channels(cin, ratio, pad_to=pad) == JO.expanded_channels(
                    cin, ratio, pad_to=pad)


@pytest.mark.parametrize("ratio", TT5.RATIOS)
def test_table5_overheads_equal(ratio):
    """Table 5's measured overheads (on the convnet and bench-LM trees) and
    arithmetic ones (deepseek-7b, qwen3-14b, padded and not) equal the
    reference's."""
    import benchmarks.table5_overhead as J5

    for subject in ("convnet", "lm"):
        jp, tp = _trees(subject)
        assert TT5.measured_overhead(tp, ratio) == J5.measured_overhead(jp, ratio)
    for arch, pad in (("deepseek-7b", 1), ("qwen3-14b", 1), ("deepseek-7b", 128)):
        assert TT5.arch_overhead(arch, ratio, pad) == J5.arch_overhead(arch, ratio, pad)
