"""Test helpers for the port's tests: the JAX -> numpy flattening of the
reference's trees (``repro_torch.interop.params_from_numpy`` takes numpy;
the JAX side of the hand-off lives here, with the tests), comparison and
thread-limit fixtures, the shared smoke-size weights, MoE routing forced to
the reference's choice (:func:`forced_routing`, :func:`recording_routes`),
and the GPU skip.

``repro`` and ``jax`` are imported inside functions only, so the card's
tests (``test_torch_cuda.py``) use this module where JAX is not installed.
"""
import numpy as np
import pytest
import torch


def jax_tree_to_numpy(tree):
    """repro params (dicts of jax arrays / OCSQuantLinear / W4A8Linear) ->
    nested dicts of numpy arrays, quantized leaves as ``{values, scale, src,
    mult, bias, n_orig, a_bits, bits, a_scale}``, W4A8 leaves as ``{w4, s4, w8, s8,
    outlier_idx, src, mult, bias, n_orig, a_bits}``."""
    from repro.core.ocs import OCSQuantLinear, W4A8Linear

    if isinstance(tree, W4A8Linear):
        return {
            "w4": np.asarray(tree.w4),
            "s4": np.asarray(tree.s4, np.float32),
            "w8": np.asarray(tree.w8),
            "s8": np.asarray(tree.s8, np.float32),
            "outlier_idx": np.asarray(tree.outlier_idx, np.int32),
            "src": np.asarray(tree.spec.src, np.int32),
            "mult": np.asarray(tree.spec.mult, np.float32),
            "bias": np.asarray(tree.spec.bias, np.float32),
            "n_orig": tree.n_orig,
            "a_bits": tree.a_bits,
        }

    if isinstance(tree, OCSQuantLinear):
        return {
            "values": np.asarray(tree.weight.values),
            "scale": np.asarray(tree.weight.scale, np.float32),
            "src": np.asarray(tree.spec.src, np.int32),
            "mult": np.asarray(tree.spec.mult, np.float32),
            "bias": np.asarray(tree.spec.bias, np.float32),
            "n_orig": tree.n_orig,
            "a_bits": tree.a_bits,
            "bits": tree.weight.bits,
            "a_scale": None if tree.a_scale is None else np.asarray(tree.a_scale, np.float32),
        }
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_tree_to_numpy(v) for v in tree)
    return np.asarray(tree)


def to_np(t):
    """torch tensor (any dtype, bf16 included) -> numpy for comparison."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads per test module: the suite runs under several
    pytest-xdist workers, and torch's default (all cores) oversubscribes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# The serving launcher's recipe (``launch/serve.py``), as QuantRecipe kwargs.
SERVE_RECIPE = dict(w_bits=8, w_clip="mse", ocs_ratio=0.02, per_channel=True, pad_to=1)


@pytest.fixture(scope="session")
def glm_smoke():
    """``(cfg, params)``: the reference's ``init_params`` for the smoke
    glm4-9b, seed 0. Shared by the modules that need it: the reference's
    initialization and quantization take seconds on this CPU."""
    import jax
    from repro.configs import smoke_config
    from repro.models import transformer as JT

    cfg = smoke_config("glm4-9b")
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="session")
def glm_smoke_served(glm_smoke):
    """``(reference tree, port tree)``: ``glm_smoke``'s weights quantized by
    each package with :data:`SERVE_RECIPE` (the port's on the CPU, from the
    same weights through numpy)."""
    from repro.core.apply import quantize_params as j_quantize_params
    from repro.core.recipe import QuantRecipe as JRecipe
    from repro_torch.core.apply import quantize_params as t_quantize_params
    from repro_torch.core.recipe import QuantRecipe as TRecipe
    from repro_torch.interop import params_from_numpy

    _, params = glm_smoke
    qj = j_quantize_params(params, JRecipe(**SERVE_RECIPE))
    qt = t_quantize_params(params_from_numpy(jax_tree_to_numpy(params), "cpu"),
                           TRecipe(**SERVE_RECIPE), device="cpu")
    return qj, qt


ROUTE_TIE = 0.01  # a routing flip is a near-tie (test_torch_moe.py's)


class recording_routes:
    """Context: every ``repro.models.moe._route`` call inside (traced, then
    run under ``jax.jit``) appends its ``top_idx`` to ``routes`` as a numpy
    array, in execution order; call ``jax.effects_barrier()`` before
    reading them."""

    def __init__(self, routes):
        self.routes = routes

    def __enter__(self):
        import jax
        from repro.models import moe as JM

        self._route = route = JM._route
        routes = self.routes

        def recording_route(router_w, xf, k):
            gate, top_idx = route(router_w, xf, k)
            jax.debug.callback(lambda t: routes.append(np.asarray(t)), top_idx, ordered=True)
            return gate, top_idx

        JM._route = recording_route
        return routes

    def __exit__(self, *exc):
        from repro.models import moe as JM

        JM._route = self._route


def forced_routing(monkeypatch, routes, margins):
    """The port's ``moe.route`` takes the reference's experts (``routes``,
    in call order) with its own renormalized probabilities; where its own
    top-k differs, the k-th minus (k+1)-th probability goes to
    ``margins``. Returns the iterator over ``routes`` (exhausted once
    every recorded call was replayed)."""
    from repro_torch.models import moe as TM

    calls = iter(routes)
    own_route = TM.route

    def forced_route(router_w, xf, k):
        probs = torch.softmax(xf.to(torch.float32) @ router_w.to(torch.float32), dim=-1)
        _, own = own_route(router_w, xf, k)
        want = torch.from_numpy(np.array(next(calls))).long().to(xf.device)
        srt = torch.sort(probs, dim=-1, descending=True, stable=True).values
        differ = (own.sort(-1).values != want.sort(-1).values).any(-1)
        for r in torch.nonzero(differ).reshape(-1).tolist():
            margins.append(float((srt[r, k - 1] - srt[r, k]).detach()))
        gate = probs.gather(1, want)
        return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), want

    monkeypatch.setattr(TM, "route", forced_route)
    return calls


def cuda_or_skip():
    """Skip the calling test unless a CUDA device is available (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
