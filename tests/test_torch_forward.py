"""Port parity, the full-sequence entry point: ``transformer.forward`` and
``loss_fn`` against ``repro.models.transformer``'s on the same weights and
numpy inputs, and the pieces they add.

* ``forward`` and ``loss_fn`` for all ten smoke configs (the dense
  decoders, qwen2-vl's M-RoPE, the two MoE models, mamba2, hymba with its
  meta tokens and window/global segments, and the hubert encoder from
  frame embeddings) on the float tree and on the serving recipe's
  quantized tree in dequant, w8a8 and w4a8: logits within the port's
  stated tolerances of their largest magnitude (``FLOAT_RTOL``,
  ``QUANT_RTOL``: ~1-3% seen), the loss within ``LOSS_RTOL``. The
  reference runs its unrolled layer loop (``scan=False``), which
  ``tests/test_models.py::test_scan_unroll_equivalence`` holds equal to
  its scan. A MoE model routes as the reference did (its own choice may
  part only at a near-tie, ``ROUTE_TIE``; MoE greedy exactness is a knife
  edge), as in ``test_torch_moe.py``.
* The attention kinds: ``window`` over four key chunks with hymba's meta
  prefix (the statically skipped path; ``causal`` for the global switch),
  ``full`` (the encoder's), against the reference's ``attention`` to
  ``ATTN_RTOL``.
* M-RoPE with distinct (t, h, w) positions, ``apply_rope`` against the
  reference's; with text positions (one value in the three streams) it is
  bitwise plain RoPE. ``layer_norm`` and ``gelu`` on bfloat16 against the
  reference's (``gelu`` bitwise).
* qwen2-vl and hubert through ``embeds`` (the stub frontends' patch and
  frame embeddings); ``forward``'s last logits bitwise
  ``prefill_with_cache``'s; hubert's ragged vocab (504) padded once in the
  tree; the LayerNorm biases and ``w_in``/``w_out2`` through
  ``quantize_params`` and ``params_from_numpy``; the encoder's refusals
  (no decode cache, no engine).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import (ROUTE_TIE, SERVE_RECIPE, forced_routing, jax_tree_to_numpy,  # noqa: F401
                            recording_routes, to_np, torch_threads)

from repro.configs import list_archs
from repro.configs import smoke_config as j_smoke
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.ocs import OCSQuantLinear as JOCS
from repro.core.ocs import to_w4a8 as j_to_w4a8
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.apply import quantize_params as t_quantize_params
from repro_torch.core.ocs import OCSQuantLinear
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import EngineConfig, ServingEngine

FLOAT_RTOL = 0.02  # logits, float weights (test_torch_model.py's)
QUANT_RTOL = {"dequant": 0.02, "w8a8": 0.06, "w4a8": 0.06}  # logits (test_torch_moe.py's)
LOSS_RTOL = 0.01  # the mean cross-entropy, relative
ATTN_RTOL = 0.01  # an attention output, of its largest magnitude
W4A8_RATIO = 0.05

_TREES = {}


def _trees(arch):
    """``(cfg, reference float tree, reference quantized tree)``, seed 0."""
    if arch not in _TREES:
        cfg = j_smoke(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(t_smoke(arch))
        params = JT.init_params(cfg, jax.random.PRNGKey(0))
        _TREES[arch] = (cfg, params, j_quantize_params(params, JRecipe(**SERVE_RECIPE)))
    return _TREES[arch]


def _tree(arch, tree):
    """(cfg, reference tree, port tree, matmul mode) of a test case."""
    cfg, params, qj = _trees(arch)
    if tree == "float":
        pj, mode = params, "dequant"
    elif tree == "w4a8":
        pj = jax.tree.map(lambda a: j_to_w4a8(a, W4A8_RATIO) if isinstance(a, JOCS) else a,
                          qj, is_leaf=lambda a: isinstance(a, JOCS))
        mode = "w4a8"
    else:
        pj, mode = qj, tree
    return cfg, pj, params_from_numpy(jax_tree_to_numpy(pj), "cpu"), mode


def _batch(cfg, b=2, s=40, seed=0):
    """Seeded numpy inputs: tokens, or frame embeddings for the audio
    frontend; labels."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return batch


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _kernel(mode):
    return "pallas" if mode == "dequant" else "xla"


def _ref_forward(cfg, pj, batch, mode, routes=None):
    """The reference's forward logits and loss (unrolled layers) in
    ``mode``; each MoE routing's ``top_idx`` appended to ``routes``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p, bb):
        with JL.serving_mode(mode, kernel=_kernel(mode)):
            logits = JT.forward(p, bb.get("tokens"), cfg, scan=False, embeds=bb.get("embeds"))
            return logits, JT.loss_fn(p, bb, cfg, scan=False)

    if routes is None:
        logits, loss = jax.jit(run)(pj, jb)
    else:
        with recording_routes(routes):
            logits, loss = jax.jit(run)(pj, jb)
            jax.effects_barrier()
    return np.asarray(logits.astype(jnp.float32)), float(loss)


def _port_forward(cfg, pt, batch, mode):
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = TT.forward(pt, tb.get("tokens"), cfg, mode=mode, embeds=tb.get("embeds"))
        loss = TT.loss_fn(pt, tb, cfg, mode=mode)
    return logits, float(loss)


@pytest.mark.parametrize("tree", ["float", "dequant", "w8a8", "w4a8"])
@pytest.mark.parametrize("arch", list_archs())
def test_forward_and_loss_match_reference(arch, tree, monkeypatch):
    cfg, pj, pt, mode = _tree(arch, tree)
    batch = _batch(cfg)
    moe = cfg.block == "moe"
    routes = [] if moe else None
    want, want_loss = _ref_forward(cfg, pj, batch, mode, routes)
    margins = []
    if moe:
        # forward, then loss_fn's forward: the same routings twice.
        assert len(routes) == 2 * cfg.n_layers
        calls = forced_routing(monkeypatch, routes, margins)
    got, got_loss = _port_forward(t_smoke(arch), pt, batch, mode)
    if moe:
        assert next(calls, None) is None
        assert all(m <= ROUTE_TIE for m in margins), margins
    b, s = batch["labels"].shape
    assert got.shape == (b, s, cfg.vocab) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    rtol = FLOAT_RTOL if tree == "float" else QUANT_RTOL[tree]
    assert _rel_err(to_np(got), want) <= rtol
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss), (got_loss, want_loss)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "glm4-9b"])
def test_forward_from_embeds(arch):
    """The vision stub: ``forward(embeds=...)`` takes precomputed patch
    embeddings (cast to bfloat16) in place of the token embedding, as the
    reference's does; the same tokens' embeddings give the tokens' logits
    bitwise."""
    cfg, pj, pt, mode = _tree(arch, "dequant")
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)

    @jax.jit
    def ref(p, e):
        with JL.serving_mode(mode, kernel=_kernel(mode)):
            return JT.forward(p, None, cfg, scan=False, embeds=e)

    want = np.asarray(ref(pj, jnp.asarray(emb)).astype(jnp.float32))
    with torch.no_grad():
        got = TT.forward(pt, None, cfg, mode=mode, embeds=torch.as_tensor(emb))
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)))
        by_tok = TT.forward(pt, toks, cfg, mode=mode)
        by_emb = TT.forward(pt, None, cfg, mode=mode, embeds=pt["embed"][toks.long()])
    assert _rel_err(to_np(got), want) <= QUANT_RTOL[mode]
    assert torch.equal(by_tok, by_emb)


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-vl-7b", "deepseek-7b"])
def test_forward_last_logits_equal_prefill(arch):
    """``forward``'s logits at each prompt's last token are bitwise
    ``prefill_with_cache``'s (one block body, and every kernel and norm
    sums a row alike whatever the call's row count)."""
    cfg, _, pt, mode = _tree(arch, "w8a8")
    rng = np.random.default_rng(4)
    n = np.array([27, 19], np.int32)
    toks = np.zeros((2, 32), np.int32)
    for i in range(2):
        toks[i, :n[i]] = rng.integers(0, cfg.vocab, n[i])
    with torch.no_grad():
        full = TT.forward(pt, torch.as_tensor(toks), cfg, mode=mode)
        last, _ = TT.prefill_with_cache(pt, torch.as_tensor(toks), cfg, 48,
                                        length=torch.as_tensor(n), mode=mode)
    assert torch.equal(full[torch.arange(2), torch.as_tensor(n).long() - 1], last)


# ---------------------------------------------------------------------------
# The attention kinds


def _attn_both(arch, x, tkw=None, **kw):
    """Layer 0's float attention on ``x`` through both packages: the
    reference with ``kw``, the port with ``tkw`` (default ``kw``)."""
    cfg, params, _ = _trees(arch)
    pj = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    pt = params_from_numpy(jax_tree_to_numpy(pj), "cpu")
    b, s, _ = x.shape
    positions = np.broadcast_to(np.arange(s), (b, s))
    want = jax.jit(lambda p, xx, pos: JA.attention(p, xx, cfg, positions=pos, **kw))(
        pj, jnp.asarray(x, jnp.bfloat16), jnp.asarray(positions))
    with torch.no_grad():
        got = TA.attention(pt, torch.as_tensor(x).to(torch.bfloat16), cfg,
                           positions=torch.as_tensor(positions.copy()), mode="dequant",
                           **(kw if tkw is None else tkw))
    return to_np(got), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("is_global", [None, False, True])
def test_window_attention_over_chunks_with_meta_prefix(is_global):
    """hymba's window (32) over 128 keys in chunks of 32, the first 8 (the
    meta tokens) visible to every query, against the reference's statically
    skipped path (``is_global`` None) and its masked one with the global
    switch off and on. The port chooses per layer statically: its
    ``window`` kind (the skipped path) for the first two, ``causal`` for
    the third."""
    cfg = t_smoke("hymba-1.5b")
    assert cfg.attn_chunk == 32 and cfg.hymba.swa_window == 32
    x = np.random.default_rng(5).normal(size=(2, 128, cfg.d_model)).astype(np.float32)
    kw = dict(kind="window", window=32, n_prefix=cfg.hymba.n_meta_tokens)
    tkw = dict(kw, kind="causal" if is_global else "window")
    if is_global is not None:
        kw["is_global"] = jnp.asarray(is_global)
    got, want = _attn_both("hymba-1.5b", x, tkw=tkw, **kw)
    assert _rel_err(got, want) <= ATTN_RTOL
    if is_global:  # the global switch is the causal kind: later keys differ from the window
        window, _ = _attn_both("hymba-1.5b", x, tkw=dict(tkw, kind="window"), **kw)
        assert np.abs(got[:, 64:] - window[:, 64:]).max() > 0


def test_window_attention_refuses_a_prefix():
    """The window runs over self-attention only: a cached prefix (Sk > Sq)
    raises."""
    cfg = t_smoke("hymba-1.5b")
    q = torch.zeros((1, 32, cfg.n_heads, cfg.hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, cfg.n_kv_heads, cfg.hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="self-attention only"):
        TA._flash_over_kv(q, k, k, "window", torch.arange(32) + 32, 32, 32, 0)


@pytest.mark.parametrize("kind", ["full", "causal"])
def test_full_and_causal_attention_match_reference(kind):
    """The encoder's unmasked attention (hubert's smoke, 4 heads of 16) and
    the causal one, over two key chunks."""
    cfg = t_smoke("hubert-xlarge")
    x = np.random.default_rng(6).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    got, want = _attn_both("hubert-xlarge", x, kind=kind)
    assert _rel_err(got, want) <= ATTN_RTOL
    if kind == "full":
        causal, _ = _attn_both("hubert-xlarge", x, kind="causal")
        assert np.abs(got[:, :-1] - causal[:, :-1]).max() > 0  # later keys are seen
        assert np.array_equal(got[:, -1], causal[:, -1])  # the last query sees all alike


# ---------------------------------------------------------------------------
# M-RoPE, LayerNorm, GELU


def test_mrope_distinct_positions_match_reference():
    """Qwen2-VL's M-RoPE at hd 16, sections (2, 3, 3): distinct (t, h, w)
    positions (a patch grid) rotate each frequency slot by its owner's
    position, as the reference's ``apply_rope``; with one position in the
    three streams it is bitwise plain RoPE."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = np.stack([rng.integers(0, 50, (2, 12)) for _ in range(3)], -1).astype(np.int32)
    want = JA.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, (2, 3, 3))
    got = TA.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    for j in range(3):  # each stream moves only the slots it owns
        moved = pos.copy()
        moved[..., j] += 7
        d = (TA.apply_rope(torch.as_tensor(x), torch.as_tensor(moved), 10000.0, (2, 3, 3))
             - got).abs().amax(dim=(0, 1, 2)).numpy()
        owned = np.zeros(8, bool)
        owned[[0, 2, 5][j]:[2, 5, 8][j]] = True
        assert (d[:8][owned] > 0).all() and (d[:8][~owned] == 0).all()
    text = torch.as_tensor(pos[..., 0])
    cfg = dataclasses.replace(t_smoke("qwen2-vl-7b"))
    assert torch.equal(TA.apply_rope(xb, TA.rope_positions(cfg, text), 10000.0, (2, 3, 3)),
                       TA.apply_rope(xb, text, 10000.0))
    with pytest.raises(ValueError, match="sum"):
        TA.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0, (2, 3, 4))


def test_layer_norm_and_gelu_match_reference():
    """``layer_norm`` (f32 statistics, ``* scale + bias``) within one bf16
    ulp of the reference's (its mean sums in another order), ``gelu`` (the
    tanh approximation) bitwise, on bfloat16 rows of 1280 (hubert's
    width)."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(16, 1280)) * 3).astype(np.float32)
    scale = rng.normal(size=1280).astype(np.float32)
    bias = rng.normal(size=1280).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.as_tensor(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    want = np.asarray(jax.jit(lambda a, b, c: JL.layer_norm(a, b, c, 1e-5))(
        jnp.asarray(scale), jnp.asarray(bias), xb).astype(jnp.float32))
    got = to_np(TL.layer_norm(torch.as_tensor(scale), torch.as_tensor(bias), xt, 1e-5))
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - want) <= ulp).all()
    want_g = np.asarray(jax.jit(JL.gelu)(xb).astype(jnp.float32))
    assert np.array_equal(to_np(TL.gelu(xt)), want_g)


# ---------------------------------------------------------------------------
# The encoder's tree and refusals


def test_hubert_tree_quantizes_like_the_reference():
    """hubert's smoke tree through both packages' ``quantize_params``: the
    same leaves quantized (``w_in``/``w_out2`` and the attention; never the
    LayerNorm scales and biases, kept float), each bitwise the reference's
    on its true columns; at the published vocab of 504 the lm_head's
    columns are stored padded to 512 once and ``forward`` gives 504."""
    cfg = dataclasses.replace(j_smoke("hubert-xlarge"), vocab=504)
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    qj = j_quantize_params(params, JRecipe(**SERVE_RECIPE))
    qt = t_quantize_params(params_from_numpy(jax_tree_to_numpy(params), "cpu"),
                           TRecipe(**SERVE_RECIPE), device="cpu")
    lay_j, lay_t = qj["layers"], qt["layers"]
    assert set(lay_t["mlp"]) == {"w_in", "w_out2"} and set(lay_t["norm1"]) == {"scale", "bias"}
    for name in ("norm1", "norm2"):
        for key in ("scale", "bias"):
            leaf = lay_t[name][key]
            assert isinstance(leaf, torch.Tensor) and leaf.shape == (cfg.n_layers, cfg.d_model)
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(lay_j[name][key]))
    assert isinstance(qt["final_norm"]["bias"], torch.Tensor)
    for path, leaf_t, leaf_j in (("w_in", lay_t["mlp"]["w_in"], lay_j["mlp"]["w_in"]),
                                 ("w_out2", lay_t["mlp"]["w_out2"], lay_j["mlp"]["w_out2"]),
                                 ("lm_head", qt["lm_head"], qj["lm_head"])):
        assert isinstance(leaf_t, OCSQuantLinear) and isinstance(leaf_j, JOCS), path
        n = np.asarray(leaf_j.weight.values).shape[-1]
        np.testing.assert_array_equal(leaf_t.weight.values.numpy()[..., :n],
                                      np.asarray(leaf_j.weight.values), err_msg=path)
    assert tuple(qt["lm_head"].weight.values.shape)[-1] == 512 and qt["lm_head"].n_out == 504
    emb = torch.as_tensor(np.random.default_rng(9).normal(size=(1, 8, cfg.d_model)),
                          dtype=torch.float32)
    with torch.no_grad():
        assert TT.forward(qt, None, cfg, mode="w8a8", embeds=emb).shape == (1, 8, 504)


def test_encoder_has_no_decode_step():
    """The reference's refusals: an encoder has no decode cache, and no
    serving engine takes it."""
    cfg = t_smoke("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only models have no decode step"):
        TT.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="encoder-only arch"):
        ServingEngine(cfg, TT.init_params(cfg, seed=0, device="cpu"), EngineConfig(max_len=32),
                      device="cpu")
    with pytest.raises(ValueError):
        JT.init_cache(j_smoke("hubert-xlarge"), 1, 16)
