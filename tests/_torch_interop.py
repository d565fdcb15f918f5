"""Test helpers for the port's tests: the JAX -> numpy flattening of the
reference's trees (``repro_torch.interop.params_from_numpy`` takes numpy;
the JAX side of the hand-off lives here, with the tests), comparison and
thread-limit fixtures, the shared smoke-size weights, and the GPU skip.

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


def cuda_or_skip():
    """Skip the calling test unless a CUDA device is available (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
