"""Port parity, the last dense configs served: qwen2-vl-7b (M-RoPE sections
(2, 3, 3) at smoke size; text tokens, one position in all three streams)
and minitron-8b, greedy on the paged engine against the reference's
engine on float32 pages, from the same quantized tree through numpy.

Both engines step in lockstep (``_torch_lifecycle.serve_both``): every
step returns alike and leaves the allocator in the same state by page
id; the streams are token for token equal up to the reference's near-ties
(``assert_held``, a top-2 margin within ``TIE_TOL``), the rule every
port-vs-reference stream is held by. The port's own copies of the configs
are the reference's, field for field, at full size and at smoke size.
"""
import dataclasses

import numpy as np
import pytest
import jax

from _torch_interop import SERVE_RECIPE, jax_tree_to_numpy, torch_threads  # noqa: F401
from _torch_lifecycle import assert_held, prompts_of, ref_top2_margin, serve_both

from repro.configs import get_config as j_config
from repro.configs import smoke_config as j_smoke
from repro.core.apply import quantize_params as j_quantize_params
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import transformer as JT

from repro_torch.configs import get_config as t_config
from repro_torch.configs import list_archs
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.interop import params_from_numpy

ARCHS = ("qwen2-vl-7b", "minitron-8b")


def test_configs_are_the_references():
    """All ten of the reference's configs, full and smoke, field for field."""
    from repro.configs import list_archs as j_list

    assert sorted(list_archs()) == sorted(j_list())
    for arch in list_archs():
        assert dataclasses.asdict(t_config(arch)) == dataclasses.asdict(j_config(arch)), arch
        assert dataclasses.asdict(t_smoke(arch)) == dataclasses.asdict(j_smoke(arch)), arch


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_matches_reference(arch, mode):
    cfg = j_smoke(arch)
    qj = j_quantize_params(JT.init_params(cfg, jax.random.PRNGKey(0)), JRecipe(**SERVE_RECIPE))
    qt = params_from_numpy(jax_tree_to_numpy(qj), "cpu")
    prompts = prompts_of(np.random.default_rng(11), cfg.vocab, (21, 9, 30, 17))
    conf = dict(max_batch=2, max_len=64, page_size=16, matmul_mode=mode)
    je, te, want, got = serve_both(cfg, qj, qt, conf, prompts)
    assert te.paged and te.stats()["completed"] == len(prompts) == je.stats()["completed"]
    assert all(reason == "length" and len(toks) == 8 for reason, toks in got.values())
    assert_held(got, want, dict(enumerate(prompts)), ref_top2_margin(cfg, je.params, mode))
