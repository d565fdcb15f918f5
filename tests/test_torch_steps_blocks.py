"""Port parity, ``launch.steps.make_train_step`` through the MoE, SSM and
hybrid blocks: three steps against the reference's jitted step
(``_torch_steps.check_train_steps``, which states what is held and to
what tolerance) for deepseek-moe-16b and phi3.5-moe (routing forced to
the reference's, each flip a near-tie), mamba2 and hymba (meta tokens,
window and global layers) at ``n_micro=1`` with float32 gradients, and
deepseek-moe-16b at ``n_micro=2`` with bfloat16 gradients.

A MoE layer's capacity follows the token count of the call, so the
microbatch's: the loss of one batch depends on ``n_micro``, in the
reference as in the port, and the port reproduces the reference's value
at each (not the full batch's).
"""
import numpy as np
import pytest
import torch

from _torch_interop import torch_threads  # noqa: F401
from _torch_steps import LOSS_RTOL, batches, check_train_steps

from repro.configs import smoke_config as j_smoke

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_map


@pytest.mark.parametrize("arch,n_micro,grad_dtype", [
    ("deepseek-moe-16b", 1, "float32"), ("phi3.5-moe-42b-a6.6b", 1, "float32"),
    ("mamba2-1.3b", 1, "float32"), ("hymba-1.5b", 1, "float32"),
    ("deepseek-moe-16b", 2, "bfloat16")])
def test_train_step_matches_reference(arch, n_micro, grad_dtype, monkeypatch):
    check_train_steps(arch, n_micro, grad_dtype, monkeypatch)


def test_moe_loss_follows_the_microbatch():
    """deepseek-moe-16b's first-step loss: at ``n_micro=1`` the full
    batch's ``loss_fn``; at ``n_micro=2`` the mean of the two halves'
    (each routed with its own capacity), which differs; a dense model's
    loss does not depend on the split beyond rounding."""
    for arch, moe in (("deepseek-moe-16b", True), ("deepseek-7b", False)):
        cfg = t_smoke(arch)
        params = TT.init_params(cfg, seed=0, device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in batches(j_smoke(arch), 1)[0].items()}
        losses = {}
        for n in (1, 2):
            step = TS.make_train_step(cfg, TS.TrainHyper(n_micro=n))
            p = tree_map(torch.clone, params)  # the step updates its input in place
            losses[n] = float(step(p, adamw_init(p), batch)[2]["loss"])
        with torch.no_grad():
            whole = float(TT.loss_fn(params, batch, cfg))
            halves = np.mean([float(TT.loss_fn(params, {k: v[i * 2:(i + 1) * 2]
                                                        for k, v in batch.items()}, cfg))
                              for i in range(2)])
        assert abs(losses[1] - whole) <= 1e-6 * abs(whole)
        assert abs(losses[2] - halves) <= 1e-6 * abs(halves)
        if moe:
            assert abs(losses[1] - losses[2]) > LOSS_RTOL * abs(losses[1]), losses
        else:
            assert abs(losses[1] - losses[2]) <= LOSS_RTOL * abs(losses[1]), losses

