"""Port parity, the step functions of ``launch/steps.py`` against
``repro.launch.steps`` on the same numpy weights and inputs.

* ``make_train_step``: three steps against the reference's jitted step
  (``_torch_steps.check_train_steps``, which states what is held and to
  what tolerance) for the dense decoders, qwen2-vl (M-RoPE) and the hubert
  encoder at ``n_micro=1`` with float32 gradients, and deepseek-7b at
  ``n_micro=2`` with bfloat16 gradients (the reference's order: each
  microbatch's gradients cast, summed in bf16 in order, then scaled by
  ``bf16(1/2)``). The MoE, SSM and hybrid configs are in
  ``test_torch_steps_blocks.py``.
* ``make_serve_step``: greedy decode steps on float32 dense caches of
  ``init_cache``, teacher-forced with the reference's tokens: logits
  within ``SERVE_RTOL`` of the largest; the port's token the reference's
  except at a near-tie (the reference's top-2 margin within
  ``TIE_RTOL`` of its largest logit).
* ``make_prefill_step``: the last position's logits within
  ``SERVE_RTOL``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import jax_tree_to_numpy, torch_threads  # noqa: F401
from _torch_steps import as_np, check_train_steps

from repro.configs import smoke_config as j_smoke
from repro.launch import steps as JS
from repro.models import transformer as JT

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT

SERVE_RTOL = 0.02
TIE_RTOL = 2 * SERVE_RTOL


@pytest.mark.parametrize("arch,n_micro,grad_dtype", [
    ("glm4-9b", 1, "float32"), ("minitron-8b", 1, "float32"), ("deepseek-7b", 1, "float32"),
    ("qwen3-14b", 1, "float32"), ("qwen2-vl-7b", 1, "float32"),
    ("hubert-xlarge", 1, "float32"), ("deepseek-7b", 2, "bfloat16")])
def test_train_step_matches_reference(arch, n_micro, grad_dtype, monkeypatch):
    check_train_steps(arch, n_micro, grad_dtype, monkeypatch)


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-1.3b", "hymba-1.5b", "qwen2-vl-7b"])
def test_serve_and_prefill_steps_match_reference(arch):
    cfg = j_smoke(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    pt = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)

    want = np.asarray(jax.jit(JS.make_prefill_step(cfg))(
        params, {"tokens": jnp.asarray(toks)}).astype(jnp.float32))
    with torch.no_grad():
        got = TS.make_prefill_step(t_smoke(arch))(pt, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, cfg.vocab)
    assert np.abs(as_np(got) - want).max() <= SERVE_RTOL * np.abs(want).max()

    jserve = jax.jit(JS.make_serve_step(cfg))
    tserve = TS.make_serve_step(t_smoke(arch))
    jc = JT.init_cache(cfg, 2, 16, dtype=jnp.float32)
    tc = TT.init_cache(t_smoke(arch), 2, 16, dtype=torch.float32, device="cpu")
    tok = toks[:, :1]
    for _ in range(6):
        jt, jl, jc = jserve(params, jc, jnp.asarray(tok))
        with torch.no_grad():
            tt, tl, tc = tserve(pt, tc, torch.as_tensor(tok))
        jl = np.asarray(jl.astype(jnp.float32))
        top = np.abs(jl).max()
        assert np.abs(as_np(tl) - jl).max() <= SERVE_RTOL * top
        assert tt.dtype == torch.int32 and tt.shape == (2, 1)
        srt = np.sort(jl, axis=-1)
        for r in np.nonzero(tt.numpy()[:, 0] != np.asarray(jt)[:, 0])[0]:
            assert srt[r, -1] - srt[r, -2] <= TIE_RTOL * top, (r, srt[r, -2:])
        tok = np.array(jt)  # teacher-forced with the reference's tokens
