"""Port parity, MoE: ``repro_torch.models.moe`` and the MoE decoder against
``repro.models.moe`` on the CPU, at the smoke sizes of both MoE archs
(deepseek-moe-16b: 8 experts, top-3, one shared expert, MHA;
phi3.5-moe-42b-a6.6b: 8 experts, top-2, no shared expert, GQA), from
seeded inputs run through both.

* Routing: ``top_idx``, ``keep`` and ``dest`` are equal exactly, on random
  routers, on one built to drop (every token's first choice is one expert,
  past its capacity) and on tied router probabilities (``jax.lax.top_k``
  takes the lower index); gates within ``GATE_ATOL`` (float32 softmax ulps
  differ between torch and XLA).
* The combine is bitwise the reference's bfloat16 scatter-add on the same
  expert outputs and gates.
* The block on float weights is bitwise the reference's; on quantized
  weights within ``BLOCK_RTOL`` of its largest output in each matmul mode
  (one bf16 rounding of a differently ordered float32 sum, or of a
  requantized int8 value, as for the dense MLP).
* ``dense`` on an expert stack is each expert's 2-D call, bitwise, in every
  mode (the plain stacked call loops over the 2-D plain version).
* The engine: logits of ``prefill_into_pages`` and teacher-forced
  ``decode_step`` against the reference's on float32 pages within the
  model test's tolerances; spec == plain greedy at the reference's smoke
  size (``tests/test_spec_decode.py``: no assignment is dropped there) in
  ``dequant``, ``w8a8`` and ``w4a8``.
* Quantization: a lazy tree (``init_params(lazy=True)``) quantizes to the
  bits of the eager one, and an ``[L, E, K, N]`` leaf is each slice's
  ``make_ocs_quant_linear``; ``to_w4a8`` converts the expert stacks slice
  by slice.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import SERVE_RECIPE, jax_tree_to_numpy, to_np, torch_threads  # noqa: F401

from repro.configs import smoke_config as j_smoke
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.ocs import OCSQuantLinear as JQ
from repro.core.ocs import to_w4a8 as j_to_w4a8
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import EngineConfig as JConfig
from repro.serving import KernelConfig
from repro.serving import ServingEngine as JEngine
from repro.serving import kv_cache as jkvc

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.apply import map_with_path
from repro_torch.core.apply import quantize_params as t_quantize_params
from repro_torch.core.ocs import OCSQuantLinear, W4A8Linear, make_ocs_quant_linear, to_w4a8
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving.spec_decode import SpecConfig

ARCHS = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
GATE_ATOL = 1e-6  # renormalized top-k gates, float32
BLOCK_RTOL = 0.02  # the quantized block's output, of its largest magnitude
FLOAT_RTOL = 0.02  # logits, float weights (test_torch_model.py's)
QUANT_RTOL = {"dequant": 0.02, "w8a8": 0.06, "w4a8": 0.06}  # logits, quantized
W4A8_RATIO = 0.05


def _kernel(mode):
    return "pallas" if mode == "dequant" else "xla"


@pytest.fixture(scope="module", params=ARCHS)
def moe_model(request):
    """``(arch, cfg, reference params, reference quantized tree, port
    quantized tree)``: seed 0, the serving recipe (the port's tree is the
    reference's through numpy)."""
    arch = request.param
    cfg = j_smoke(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(t_smoke(arch))
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qj = j_quantize_params(params, JRecipe(**SERVE_RECIPE))
    qt = params_from_numpy(jax_tree_to_numpy(qj), "cpu")
    return arch, cfg, params, qj, qt


def _reference_dispatch(top_idx, n_experts, cap):
    """``keep`` and ``dest`` as the reference's ``_dispatch_mlp_combine``
    computes them (``repro/models/moe.py:111-123``, single device)."""
    n, k = top_idx.shape
    flat_e = top_idx.reshape(-1)
    key = flat_e
    order = jnp.argsort(key, stable=True)
    sorted_e = key[order]
    counts = jnp.bincount(key, length=n_experts)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(n * k) - starts[jnp.minimum(sorted_e, n_experts - 1)]
    keep = (sorted_e < n_experts) & (pos_in_e < cap)
    dest = jnp.where(keep, sorted_e * cap + pos_in_e, n_experts * cap)
    return np.asarray(order), np.asarray(keep), np.asarray(dest)


def _routers(cfg, rng):
    d, e = cfg.d_model, cfg.moe.n_experts
    rand = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    drop = np.zeros((d, e), np.float32)
    drop[:, 0] = 1.0  # with positive x, expert 0 first for every token
    tied = np.zeros((d, e), np.float32)  # every probability 1/E
    return {"random": rand, "drop": drop, "tied": tied}


@pytest.mark.parametrize("router", ["random", "drop", "tied"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [8, 40])
def test_routing_matches_reference(arch, router, n):
    cfg = j_smoke(arch)
    m = cfg.moe
    rng = np.random.default_rng(3)
    w = _routers(cfg, rng)[router]
    x = np.abs(rng.standard_normal((n, cfg.d_model))).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    gate_j, idx_j = JM._route(jnp.asarray(w), xj, m.top_k)
    gate_t, idx_t = TM.route(torch.from_numpy(w), torch.from_numpy(x).to(torch.bfloat16),
                             m.top_k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(gate_t.numpy(), np.asarray(gate_j), rtol=0, atol=GATE_ATOL)
    cap = JM._capacity(n, m.top_k, m.capacity_factor, m.n_experts)
    assert TM.capacity(n, m.top_k, m.capacity_factor, m.n_experts) == cap
    order_j, keep_j, dest_j = _reference_dispatch(idx_j, m.n_experts, cap)
    order, sorted_t, keep, dest = TM.dispatch(idx_t, m.n_experts, cap)
    np.testing.assert_array_equal(order.numpy(), order_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    np.testing.assert_array_equal(dest.numpy(), dest_j)
    if router == "tied":  # lax.top_k's tie rule: the lowest indices, in order
        assert (idx_t.numpy() == np.arange(m.top_k)).all()
    if router == "drop" and n == 40:
        assert (~keep).sum() > 0  # expert 0 takes every token, past its capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_bitwise(arch):
    """The gated combine on bf16 expert outputs with random gates and some
    dropped assignments: bitwise the reference's ``zeros(bf16).at[t].add``
    (a token's k contributions added in sorted order, rounding each)."""
    cfg = j_smoke(arch)
    m = cfg.moe
    n = 40
    rng = np.random.default_rng(5)
    w = _routers(cfg, rng)["drop"]
    w += (rng.standard_normal(w.shape) * 0.05).astype(np.float32)
    x = np.abs(rng.standard_normal((n, cfg.d_model))).astype(np.float32)
    gate_j, idx_j = JM._route(jnp.asarray(w), jnp.asarray(x, jnp.bfloat16), m.top_k)
    cap = JM._capacity(n, m.top_k, m.capacity_factor, m.n_experts)
    order_j, keep_j, dest_j = _reference_dispatch(idx_j, m.n_experts, cap)
    assert (~keep_j).sum() > 0
    yd = rng.standard_normal((m.n_experts, cap, cfg.d_model)).astype(np.float32)
    yd_j = jnp.asarray(yd, jnp.bfloat16)
    # The reference's combine, repro/models/moe.py:131-138.
    sorted_t = jnp.repeat(jnp.arange(n), m.top_k)[order_j]
    sorted_g = gate_j.reshape(-1)[order_j]
    y_flat = yd_j.reshape(m.n_experts * cap, -1)
    contrib = jnp.where(keep_j[:, None], y_flat[jnp.minimum(dest_j, m.n_experts * cap - 1)], 0.0)
    want = jnp.zeros((n, cfg.d_model), jnp.bfloat16).at[sorted_t].add(
        (contrib * sorted_g[:, None]).astype(jnp.bfloat16))
    gate_t = torch.from_numpy(np.array(gate_j))
    idx_t = torch.from_numpy(np.array(idx_j)).long()
    order, st, keep, dest = TM.dispatch(idx_t, m.n_experts, cap)
    got = TM.combine(torch.from_numpy(yd).to(torch.bfloat16), gate_t, idx_t, order, st, keep,
                     dest, torch.bfloat16)
    np.testing.assert_array_equal(to_np(got), np.asarray(want.astype(jnp.float32)))


def _layer0(tree):
    return map_with_path(lambda _p, a: a.layer(0) if hasattr(a, "layer") else a[0], tree)


@pytest.mark.parametrize("mode", ["float", "dequant", "w8a8", "w4a8"])
def test_block_matches_reference(moe_model, mode):
    """Layer 0's MoE block on seeded bf16 input (16 tokens) against the
    reference's: bitwise on float weights, within ``BLOCK_RTOL`` quantized."""
    arch, cfg, params, qj, qt = moe_model
    tcfg = t_smoke(arch)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if mode == "float":
        pj = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
        pt = params_from_numpy(jax_tree_to_numpy(pj), "cpu")
        want = JM.moe(pj, xj, cfg)
        got = TM.moe(pt, xt, tcfg, mode="dequant")
        np.testing.assert_array_equal(to_np(got), np.asarray(want.astype(jnp.float32)))
        return
    jtree, ttree = qj, qt
    if mode == "w4a8":
        jtree = jax.tree.map(lambda a: j_to_w4a8(a, W4A8_RATIO) if isinstance(a, JQ) else a,
                             qj, is_leaf=lambda a: isinstance(a, JQ))
        ttree = params_from_numpy(jax_tree_to_numpy(jtree), "cpu")
    pj = jax.tree.map(lambda a: a[0], jtree["layers"]["moe"])
    pt = _layer0(ttree["layers"]["moe"])
    with JL.serving_mode(mode, kernel=_kernel(mode)):
        want = np.asarray(jax.jit(lambda p, x: JM.moe(p, x, cfg))(pj, xj).astype(jnp.float32))
    got = to_np(TM.moe(pt, xt, tcfg, mode=mode))
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= BLOCK_RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("mode", ["dequant", "w8a8", "w4a8"])
def test_dense_expert_stack_is_each_experts_call(moe_model, mode):
    """``dense`` on an expert stack (x ``[E, C, K]``, one call) equals the
    2-D ``dense`` on each expert's slice bitwise, zero rows included."""
    _, cfg, _, _, qt = moe_model
    experts = _layer0(qt["layers"]["moe"]["experts"])
    if mode == "w4a8":
        experts = {k: to_w4a8(v, W4A8_RATIO) for k, v in experts.items()}
    e = cfg.moe.n_experts
    rng = np.random.default_rng(2)
    for name, k in (("w_gate", cfg.d_model), ("w_down", cfg.moe.expert_ff)):
        x = torch.from_numpy(rng.standard_normal((e, 8, k)).astype(np.float32)).to(
            torch.bfloat16)
        x[:, 5:] = 0  # empty capacity slots
        w = experts[name]
        got = TL.dense(w, x, mode=mode)
        n_cols = (w.w4 if mode == "w4a8" else w.weight.values).shape[-1]
        assert got.shape == (e, 8, n_cols)
        for i in range(e):
            one = w.layer(i)
            np.testing.assert_array_equal(to_np(got[i]), to_np(TL.dense(one, x[i], mode=mode)))
        assert bool(torch.isfinite(got).all()) and bool((got[:, 5:] == 0).all())


def test_dense_refuses_other_stacks(moe_model):
    """A stacked leaf with x that is not its expert stack still raises."""
    _, cfg, _, _, qt = moe_model
    w = qt["layers"]["moe"]["experts"]["w_gate"]  # [L, E, K, N]
    with pytest.raises(ValueError, match="slice stacked"):
        TL.dense(w, torch.zeros((2, 3, cfg.d_model), dtype=torch.bfloat16), mode="dequant")
    one = w.layer(0)  # [E, K, N] against x of another expert count
    with pytest.raises(ValueError, match="slice stacked"):
        TL.dense(one, torch.zeros((cfg.moe.n_experts + 1, 8, cfg.d_model),
                                  dtype=torch.bfloat16), mode="w8a8")


ROUTE_TIE = 0.01  # a routing flip is a near-tie: the k-th and (k+1)-th probabilities


def _run_reference(cfg, params, toks, n, follow, mode, routes):
    """The reference's prefill and teacher-forced decodes; every routing's
    ``top_idx`` is appended to ``routes`` in call order."""
    pools = [jkvc.init_page_pool(cfg, 8, 16) for _ in range(cfg.n_layers)]
    ids = np.array([1, 2], np.int32)
    table = np.array([[1, 2, 3, 0]], np.int32)
    route = JM._route

    def recording_route(router_w, xf, k):
        gate, top_idx = route(router_w, xf, k)
        jax.debug.callback(lambda t: routes.append(np.asarray(t)), top_idx, ordered=True)
        return gate, top_idx

    JM._route = recording_route
    try:
        @jax.jit
        def prefill(params, toks, pools):
            with JL.serving_mode(mode, kernel=_kernel(mode)):
                return JT.prefill_into_pages(
                    params, toks, cfg, pools, jnp.asarray(ids), length=jnp.asarray([n]),
                    prefix_ids=jnp.zeros((0,), jnp.int32))

        @jax.jit
        def decode(params, tok, caches):
            with JL.serving_mode(mode, kernel=_kernel(mode)):
                return JT.decode_step(params, tok, caches, cfg, attn_kernel="xla")

        lg, pools = prefill(params, jnp.asarray(toks), pools)
        out = [lg]
        caches = {"layers": [{"attn": p} for p in pools], "table": jnp.asarray(table),
                  "pos": jnp.asarray([n], jnp.int32)}
        for t in follow:
            lg, caches = decode(params, jnp.asarray([[t]], jnp.int32), caches)
            out.append(lg)
        jax.effects_barrier()
    finally:
        JM._route = route
    return np.concatenate([np.asarray(o.astype(jnp.float32)) for o in out])


def _run_port(cfg, params, toks, n, follow, mode, routes, monkeypatch):
    """The port's prefill and teacher-forced decodes, each routing taking
    the reference's experts (``routes``, in call order) with the port's own
    renormalized probabilities for them. Returns ``(logits, margins)``:
    the port's own top-k where it differs from the reference's is allowed
    only at a near-tie, whose probability gap (k-th minus (k+1)-th) each
    such row reports in ``margins``."""
    calls = iter(routes)
    margins = []
    own_route = TM.route

    def forced_route(router_w, xf, k):
        logits = xf.to(torch.float32) @ router_w.to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        _, own = own_route(router_w, xf, k)
        want = torch.from_numpy(np.array(next(calls))).long()
        srt = torch.sort(probs, dim=-1, descending=True, stable=True).values
        differ = (own.sort(-1).values != want.sort(-1).values).any(-1)  # as sets
        for r in torch.nonzero(differ).reshape(-1).tolist():
            margins.append(float(srt[r, k - 1] - srt[r, k]))
        gate = probs.gather(1, want)
        return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), want

    monkeypatch.setattr(TM, "route", forced_route)
    pools = [tkvc.init_page_pool(cfg, 8, 16, device="cpu") for _ in range(cfg.n_layers)]
    with torch.no_grad():
        lg, pools = TT.prefill_into_pages(
            params, torch.as_tensor(toks), cfg, pools, torch.tensor([1, 2], dtype=torch.int32),
            length=torch.tensor([n]), prefix_ids=torch.zeros(0, dtype=torch.int32), mode=mode)
        out = [lg]
        caches = {"layers": [{"attn": p} for p in pools],
                  "table": torch.tensor([[1, 2, 3, 0]], dtype=torch.int32),
                  "pos": torch.tensor([n], dtype=torch.int32)}
        for t in follow:
            lg, caches = TT.decode_step(params, torch.tensor([[int(t)]], dtype=torch.int32),
                                        caches, cfg, mode=mode)
            out.append(lg)
    assert next(calls, None) is None  # the same routings, one for one
    return np.concatenate([to_np(o) for o in out]), margins


@pytest.mark.parametrize("mode", ["float", "dequant", "w8a8", "w4a8"])
def test_engine_logits_match_reference(moe_model, mode, monkeypatch):
    """``prefill_into_pages`` (a 27-token prompt in a 32-row bucket, its
    capacity from all 32 rows) and 4 teacher-forced ``decode_step``s on
    float32 pages, both packages on the same weights. MoE greedy exactness
    is a knife edge (ROADMAP C): a bf16 ulp in a router's input can flip an
    expert at a near-tie and move the logits by far more than an ulp. So
    the port routes as the reference did (its own probabilities as gates),
    its own choice may differ only at a near-tie (``ROUTE_TIE``), and the
    logits agree within the model test's tolerances."""
    arch, cfg, params, qj, qt = moe_model
    if mode == "float":
        pj, pt, run_mode, rtol = params, params_from_numpy(jax_tree_to_numpy(params),
                                                           "cpu"), "dequant", FLOAT_RTOL
    else:
        pj, pt, run_mode, rtol = qj, qt, mode, QUANT_RTOL[mode]
        if mode == "w4a8":
            pj = jax.tree.map(lambda a: j_to_w4a8(a, W4A8_RATIO) if isinstance(a, JQ) else a,
                              qj, is_leaf=lambda a: isinstance(a, JQ))
            pt = params_from_numpy(jax_tree_to_numpy(pj), "cpu")
    rng = np.random.default_rng(7)
    n = 27
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = rng.integers(0, cfg.vocab, n)
    follow = rng.integers(0, cfg.vocab, 4).tolist()
    routes = []
    want = _run_reference(cfg, pj, toks, n, follow, run_mode, routes)
    assert len(routes) == cfg.n_layers * (1 + len(follow))
    got, margins = _run_port(t_smoke(arch), pt, toks, n, follow, run_mode, routes,
                             monkeypatch)
    assert got.shape == want.shape == (5, cfg.vocab) and np.isfinite(got).all()
    assert all(m <= ROUTE_TIE for m in margins), margins
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("tail", [5, 40])
def test_replay_routes_the_reference_bucket(moe_model, tail, monkeypatch):
    """A resume's replay (``_run_replay``) of a ``tail``-token tail from
    position 0 on both engines, float weights and float32 pages, every
    token forced onto the first k experts (so capacity decides every drop,
    as in ``test_routing_matches_reference``'s drop case). The reference
    pads the tail to its bucket (8 rows for 5, 64 for 40), and capacity
    follows the call's rows (at 40, the bare tail's capacity would keep
    fewer of them), so the port routes the same rows with the same
    capacity, keeps the same assignments, and writes the tail's K/V rows
    within ``FLOAT_RTOL`` of the reference's."""
    arch, cfg, params, _, _ = moe_model
    pt = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    k, n_exp = cfg.moe.top_k, cfg.moe.n_experts
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, tail).astype(np.int32)
    bucket = 8 if tail <= 8 else 64
    pages = list(range(1, 9))  # 8 pages of 16: max_len 128
    common = dict(max_batch=2, max_len=128, page_size=16, matmul_mode="dequant", kv_bits=None)

    j_rows = []
    j_route = JM._route

    def j_forced(router_w, xf, kk):
        j_rows.append(xf.shape[0])
        probs = jax.nn.softmax(xf.astype(jnp.float32) @ router_w.astype(jnp.float32), -1)
        gate = probs[:, :kk]
        return gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9), jnp.broadcast_to(
            jnp.arange(kk, dtype=jnp.int32), (xf.shape[0], kk))

    je = JEngine(cfg, params, JConfig(**common, kernels=KernelConfig(matmul="xla", attn="xla")))
    je.caches["table"] = je.caches["table"].at[0].set(jnp.asarray(pages, jnp.int32))
    JM._route = j_forced
    try:
        je._run_replay(0, toks, 0)
    finally:
        JM._route = j_route

    t_rows = []
    own_dispatch = TM.dispatch

    def t_forced(router_w, xf, kk):
        probs = torch.softmax(xf.to(torch.float32) @ router_w.to(torch.float32), -1)
        gate = probs[:, :kk]
        idx = torch.arange(kk).expand(xf.shape[0], kk)
        return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), idx

    def t_dispatch(top_idx, n_e, cap):
        out = own_dispatch(top_idx, n_e, cap)
        t_rows.append((top_idx.shape[0], cap, out[2].clone()))
        return out

    monkeypatch.setattr(TM, "route", t_forced)
    monkeypatch.setattr(TM, "dispatch", t_dispatch)
    te = ServingEngine(cfg, pt, EngineConfig(**common), device="cpu")
    te._set_row(0, pages)
    te._run_replay(0, toks, 0)

    assert j_rows == [bucket] * cfg.n_layers
    assert [n for n, _, _ in t_rows] == j_rows and te.replay_lengths == [bucket]
    cap = TM.capacity(bucket, k, cfg.moe.capacity_factor, n_exp)
    assert all(c == cap for _, c, _ in t_rows)
    # Assignments sort by expert, then token: each of the k experts keeps
    # its first ``cap`` tokens, the tail's first.
    want_keep = np.concatenate([np.arange(bucket) < cap for _ in range(k)])
    for _, _, keep in t_rows:
        assert np.array_equal(keep.numpy(), want_keep)
    if tail > 8:
        assert cap > TM.capacity(tail, k, cfg.moe.capacity_factor, n_exp)
    for jl, tl in zip(je.caches["layers"], te.caches["layers"]):
        for name in ("k", "v"):
            want = np.asarray(jl["attn"][name], np.float32)[pages].swapaxes(1, 2)
            got = to_np(tl["attn"][name])[pages].swapaxes(1, 2)
            want = want.reshape(-1, *want.shape[2:])[:tail]  # [positions, KV, hd]
            got = got.reshape(-1, *got.shape[2:])[:tail]
            err = np.abs(got - want).max()
            assert np.isfinite(got).all() and err <= FLOAT_RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("mode,kv_bits,spec", [
    ("dequant", None, SpecConfig(k=3, draft_layers=1)),
    ("w8a8", 8, SpecConfig(k=3, draft_layers=1)),
    ("w4a8", 4, SpecConfig(k=3, draft_mode="w4a8")),
], ids=["dequant-f32", "w8a8-int8", "w4a8-int4"])
def test_spec_matches_plain_greedy(moe_model, mode, kv_bits, spec, monkeypatch):
    """The reference's MoE spec test at its size (2 lanes, k = 3: a verify
    routes 8 rows, a decode 2, and neither drops), on the quantized tree in
    each tier: the stream is token-identical to plain greedy."""
    arch, _, _, _, qt = moe_model
    cfg = t_smoke(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in [4, 13]]

    def run(spec_cfg):
        eng = ServingEngine(cfg, qt, EngineConfig(max_batch=2, max_len=64, matmul_mode=mode,
                                                  kv_bits=kv_bits, spec=spec_cfg),
                            device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        return {r.uid: r.output for r in eng.run()}, eng

    drops = {}  # rows a call -> dropped assignments (8 rows: a verify; 2: a decode)

    own_dispatch = TM.dispatch

    def counting_dispatch(top_idx, n_experts, cap):
        out = own_dispatch(top_idx, n_experts, cap)
        n_rows = top_idx.shape[0]
        drops[n_rows] = drops.get(n_rows, 0) + int((~out[2]).sum())
        return out

    monkeypatch.setattr(TM, "dispatch", counting_dispatch)
    plain, _ = run(None)
    got, eng = run(spec)
    # Decodes (2 rows) and verifies (2 x the live window + 1) drop nothing;
    # prefills (16-row buckets) may, alike in both runs.
    assert drops[2] == 0 and any(2 < n < 16 for n in drops)
    assert all(d == 0 for n, d in drops.items() if n < 16)
    assert got == plain and all(len(o) == 6 for o in got.values())
    assert eng.stats()["spec_rounds"] > 0


def test_lazy_tree_quantizes_like_the_eager_one():
    """``init_params(lazy=True)`` through ``quantize_params`` gives the bits
    of the eager tree's quantization (the same draws, in the same order)."""
    cfg = t_smoke("deepseek-moe-16b")
    recipe = TRecipe(**SERVE_RECIPE)
    eager = t_quantize_params(TT.init_params(cfg, seed=3, device="cpu"), recipe, device="cpu")
    lazy_tree = TT.init_params(cfg, seed=3, device="cpu", lazy=True)
    assert callable(lazy_tree["layers"]["moe"]["experts"]["w_up"])
    lazy = t_quantize_params(lazy_tree, recipe, device="cpu")

    def leaves(tree):
        out = []

        def visit(path, leaf):
            if isinstance(leaf, OCSQuantLinear):
                out.extend([leaf.weight.values, leaf.weight.scale, leaf.spec.src,
                            leaf.spec.mult, leaf.spec.bias])
            else:
                out.append(leaf)
            return leaf

        map_with_path(visit, tree)
        return out

    a, b = leaves(eager), leaves(lazy)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_expert_stack_quantizes_per_slice():
    """An ``[L, E, K, N]`` leaf: each slice's values, scales and split table
    are its own ``make_ocs_quant_linear``; ``to_w4a8`` converts the stack to
    each slice's conversion."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((2, 3, 64, 32), generator=g) / 8
    recipe = TRecipe(**SERVE_RECIPE)
    q = t_quantize_params({"experts": {"w_up": w}}, recipe, device="cpu")["experts"]["w_up"]
    assert q.weight.values.shape[:2] == (2, 3) and q.spec.src.shape[:2] == (2, 3)
    for i in range(2):
        for e in range(3):
            one = make_ocs_quant_linear(w[i, e], recipe.ocs_ratio, recipe.w_bits,
                                        qa=recipe.qa_split, clip_method=recipe.w_clip,
                                        per_channel=True, pad_to=1)
            got = q.layer(i).layer(e)
            assert torch.equal(got.weight.values, one.weight.values)
            assert torch.equal(got.weight.scale.reshape(-1), one.weight.scale)
            assert torch.equal(got.spec.src, one.spec.src)
    w4 = to_w4a8(q, W4A8_RATIO)
    assert isinstance(w4, W4A8Linear) and w4.w4.shape[:2] == (2, 3)
    one = to_w4a8(q.layer(1).layer(2), W4A8_RATIO)
    for a, b in ((w4.w4[1, 2], one.w4), (w4.s4[1, 2], one.s4), (w4.w8[1, 2], one.w8),
                 (w4.outlier_idx[1, 2], one.outlier_idx)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [[], ["--matmul-mode", "w8a8", "--kv-bits", "8"],
                                  ["--matmul-mode", "w4a8", "--kv-bits", "4"]],
                         ids=["dequant", "w8a8", "w4a8"])
def test_launch_serve_moe_smoke_on_cpu(mode):
    """``launch.serve --arch deepseek-moe-16b`` end to end at smoke size on
    the plain path (the lazy tree, quantized leaf by leaf), in each tier."""
    from repro_torch.launch import serve

    stats = serve.main(["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
                        "--n-requests", "3", "--max-new", "4", "--max-len", "64", *mode])
    assert stats["completed"] == 3 and stats["errors"] == 0
    assert stats["decoded_tokens"] == 3 * 3


def test_engine_refuses_unreached_blocks():
    """Every causal block the reference serves, the port serves: a MoE
    model with qwen2-vl's M-RoPE sections and one with a ``gelu`` act (the
    MoE block's experts are SwiGLU whatever ``act`` says, in both packages)
    construct and serve a request; an encoder-only model (hubert's
    LayerNorm, not causal) keeps the reference's refusal, a
    ``ValueError``."""
    cfg = t_smoke("deepseek-moe-16b")
    for change in (dict(mrope_sections=(2, 3, 3)), dict(act="gelu")):
        c = dataclasses.replace(cfg, **change)
        eng = ServingEngine(c, TT.init_params(c, seed=0, device="cpu"),
                            EngineConfig(max_len=64), device="cpu")
        eng.submit(Request(uid=0, prompt=list(range(1, 12)), max_new_tokens=3))
        (r,) = eng.run()
        assert r.finish_reason == "length" and len(r.output) == 3
    enc = dataclasses.replace(cfg, causal=False, norm="ln")
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(enc, TT.init_params(enc, seed=0, device="cpu"),
                      EngineConfig(max_len=64), device="cpu")


def test_stack_plans_follow_one_expert(monkeypatch):
    """A stacked launch takes the plan of one expert's shapes (so every
    slice sums as its 2-D call) and sizes its workspaces for E experts:
    B4/B5's split-K partials and counters, B1's and B6's row scratch,
    accumulators and counters (stand-in entry points record the calls;
    nothing launches)."""
    from repro_torch.kernels import fused_qmatmul as tfq
    from repro_torch.kernels import quant_matmul as tqm
    from repro_torch.kernels import scratch
    from repro_torch.kernels import w4a8_qmatmul as tw4

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("Stream", (), {"cuda_stream": 7}))
    scratch.clear()
    dev = torch.device("cpu")
    e, c, k, s, n = 64, 8, 2048, 41, 1408
    kv = tqm.tc_rows(k, s)
    tile, k_chunk, nsplit, part_b, count_b = tqm.tc_stack_plan(e, c, k, kv, n)
    assert (tile, k_chunk, nsplit) == tqm.tc_plan(c, k, kv, n, tqm._MAX_PART_BYTES)[:3]
    assert part_b == 4 * e * nsplit * c * n and count_b == 4 * e * 1 * 11
    x = torch.zeros((e, c, k), dtype=torch.bfloat16)
    out = torch.empty((e, c, n), dtype=torch.bfloat16)
    calls = []
    assert tqm.launch_tc_stack(lambda *a: calls.append(a) or 0, x, out, None,
                               torch.ones((e, n)), kv, s, 11, 22, 33) == 0
    (a,) = calls
    assert a[1:4] == (e, c, k) and a[4:8] == (s, 11, 22, 33)
    assert a[10:13] == (n, k_chunk, nsplit) and a[13] == tile
    assert scratch.buffer("split_k", dev, 0).numel() >= part_b
    # The prefill tile at a prefill's capacity: no workspace.
    assert tqm.tc_stack_plan(8, 640, k, kv, n)[0] == tqm.TC_PREFILL
    assert tqm.tc_stack_plan(8, 640, k, kv, n)[3:] == (0, 0)
    # B1: one expert's plan, E times its scratch.
    w8 = torch.zeros((e, k + s, n), dtype=torch.int8)
    src = torch.zeros((e, s), dtype=torch.int32)
    calls = []
    assert tfq.launch(lambda *a: calls.append(a) or 0, x, w8, torch.ones((e, n)), src,
                      out, 127.0) == 0
    (a,) = calls
    kp = (k + s) + (-(k + s)) % 16
    plan = tfq.launch_plan(c, kp, n)
    assert a[2:7] == (e, c, k, s, kp) and a[15:18] == plan[:3]
    assert scratch.buffer("b1_q_exp", dev, 0).numel() >= e * c * kp
    if plan[2] > 1:
        assert scratch.buffer("b1_acc", dev, 0).numel() >= e * plan[3]
    # B6 likewise, with its outlier rows.
    t = 105
    w4 = torch.zeros((e, (k + s + 1) // 2, n), dtype=torch.uint8)
    w8o = torch.zeros((e, t, n), dtype=torch.int8)
    oidx = torch.zeros((e, t), dtype=torch.int32)
    src6 = torch.zeros((e, s + 1), dtype=torch.int32)
    calls = []
    assert tw4.launch(lambda *a: calls.append(a) or 0, x, w4, torch.ones((e, n)), w8o,
                      torch.ones((e, n)), src6, oidx, out, 127.0) == 0
    (a,) = calls
    hp, tp = tw4.row_layout(w4.shape[1], t)
    plan = tw4.launch_plan(c, hp // 32, tp // 32, n)
    assert a[2:6] == (e, c, k, s + 1) and a[8] == t and a[21:24] == plan[:3]
    assert scratch.buffer("b6_q2", dev, 0).numel() >= e * c * 2 * hp
    scratch.clear()
