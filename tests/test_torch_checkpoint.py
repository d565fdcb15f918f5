"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), and the reference's own checkpoint
tests run on the port's.

* The reference's tests (``tests/test_substrates.py``): roundtrip and
  keep-k, async writes and ``wait``, a partial write ignored and removed,
  a shape mismatch raising; plus a missing path raising, a writer's error
  raised by ``wait``, and a host tensor snapshotted at ``save`` (a step
  that then updates it in place does not reach the checkpoint).
* The format crosses both ways, bitwise: the reference's ``(params,
  adamw_init(params))`` of the smoke hymba-1.5b restores into the port's
  tree (keys ``0/...``, ``1/.m/...``, ``1/.count``), and the port's
  restores through the reference's manager; the two manifests' paths,
  files, dtypes and shapes are equal, and so is every array file.
* A template of shapes (meta tensors, nothing allocated) restores like a
  full one; ``place`` puts the restored arrays on a device
  (``tests/test_torch_cuda.py`` writes from the card and restores onto
  the CPU and back).
"""
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_interop import jax_tree_to_numpy, torch_threads  # noqa: F401

from repro.checkpoint import CheckpointManager as JCM
from repro.checkpoint.manager import _path_str
from repro.configs import smoke_config as j_smoke
from repro.models import transformer as JT
from repro.optim import adamw_init as j_adamw_init

from repro_torch.checkpoint import CheckpointManager, flatten_with_path, place
from repro_torch.checkpoint import manager as M
from repro_torch.configs import smoke_config
from repro_torch.core.apply import map_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWState, adamw_init


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (10, 20, 30):
        mgr.save(s, _tree(s), meta={"data": {"seed": 0, "step": s}})
    assert mgr.all_steps() == [20, 30]  # keep-2 retention
    restored, meta = mgr.restore(_tree())
    assert meta["data"]["step"] == 30
    np.testing.assert_array_equal(restored["w"], _tree(30)["w"].numpy())
    np.testing.assert_array_equal(restored["nested"]["b"], np.arange(5, dtype=np.int32))
    assert restored["nested"]["b"].dtype == np.int32
    old, _ = mgr.restore(_tree(), step=20)
    np.testing.assert_array_equal(old["w"], _tree(20)["w"].numpy())


def test_checkpoint_async_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    for s in range(3):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert mgr.all_steps() == [0, 1, 2]
    mgr.close()


def test_checkpoint_atomicity_partial_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    mgr.save(1, _tree(1), meta={"ok": True})
    # A crash mid-write: a stale .tmp directory with garbage.
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "a00000.npy").write_bytes(b"partial")
    assert mgr.latest_step() == 1  # .tmp is invisible to readers
    mgr2 = CheckpointManager(str(tmp_path), async_write=False)  # a fresh process
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    _, meta = mgr2.restore(_tree())
    assert meta["ok"] is True


def test_checkpoint_shape_mismatch_and_missing_path_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())
    mgr.save(1, _tree())
    bad = {"w": torch.zeros((9, 4)), "nested": {"b": torch.zeros(5, dtype=torch.int32)}}
    with pytest.raises(ValueError, match="stored shape"):
        mgr.restore(bad)
    with pytest.raises(KeyError, match="missing array 'extra'"):
        mgr.restore(dict(_tree(), extra=torch.zeros(1)))
    # Arrays the template does not name are ignored.
    part, _ = mgr.restore({"w": torch.zeros((8, 4))})
    assert sorted(part) == ["w"]


def test_writer_error_raised_by_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_write=True)

    def broken_save(f, arr):
        raise OSError("disk full")

    monkeypatch.setattr(M.np, "save", broken_save)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []
    monkeypatch.undo()
    mgr.save(2, _tree())
    mgr.close()
    assert mgr.all_steps() == [2]


def test_save_snapshots_host_tensors(tmp_path):
    """A queued write holds its own copy of a host tensor: updating the
    tensor in place after ``save`` (as a donated train step does) does not
    reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    tree = _tree(3)
    want = tree["w"].clone()
    mgr.save(1, tree)
    tree["w"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(_tree())
    np.testing.assert_array_equal(got["w"], want.numpy())


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def hymba_state():
    """``(cfg, reference (params, adamw_init(params)) with distinct
    moments, the port's tree of the same numbers)``."""
    cfg = j_smoke("hymba-1.5b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    opt = j_adamw_init(params)
    opt = opt._replace(m=jax.tree.map(lambda p: p * 0.5, params),
                       v=jax.tree.map(lambda p: p * p, params),
                       count=jnp.asarray(3, jnp.int32))
    pt = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    ot = AdamWState(m=params_from_numpy(jax_tree_to_numpy(opt.m), "cpu"),
                    v=params_from_numpy(jax_tree_to_numpy(opt.v), "cpu"),
                    count=torch.tensor(3, dtype=torch.int32))
    return cfg, (params, opt), (pt, ot)


def test_paths_are_the_reference_flattening(hymba_state):
    _, (params, opt), (pt, ot) = hymba_state
    want = [_path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path((params, opt))[0]]
    got = [p for p, _ in flatten_with_path((pt, ot))]
    assert got == want
    assert got[0] == "0/embed" and "1/.m/embed" in got and got[-1] == "1/.count"
    assert "0/layers/attn/wq" in got and len(got) == 70


def test_reference_checkpoint_restores_into_port_bitwise(tmp_path, hymba_state):
    cfg, (params, opt), (pt, ot) = hymba_state
    meta = {"data": {"seed": 0, "step": 3}, "arch": cfg.name}
    jm = JCM(str(tmp_path / "ref"), async_write=False)
    jm.save(3, (params, opt), meta=meta)
    template = T.init_params(smoke_config("hymba-1.5b"), seed=1, device="cpu")
    (rp, ro), got_meta = CheckpointManager(str(tmp_path / "ref"), async_write=False).restore(
        (template, adamw_init(template)))
    assert got_meta == meta
    assert isinstance(ro, AdamWState) and ro.count.dtype == np.int32 and int(ro.count) == 3
    rp, ro = place((rp, ro), "cpu")
    for (path, a), (_, b) in zip(flatten_with_path((rp, ro)), flatten_with_path((pt, ot))):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    # Port-written, the same numbers: the manifests and files equal.
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(3, (pt, ot), meta=meta)
    mj, mt = _manifest(tmp_path / "ref", 3), _manifest(tmp_path / "port", 3)
    assert mj == mt
    for rec in mj["arrays"].values():
        a = (tmp_path / "ref" / "step_00000003" / rec["file"]).read_bytes()
        assert a == (tmp_path / "port" / "step_00000003" / rec["file"]).read_bytes()


def test_port_checkpoint_restores_through_reference_bitwise(tmp_path, hymba_state):
    cfg, (params, opt), (pt, ot) = hymba_state
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(7, (pt, ot), meta={"data": {"seed": 0, "step": 7}, "arch": cfg.name})
    mgr.close()
    (rp, ro), meta = JCM(str(tmp_path), async_write=False).restore(
        (params, j_adamw_init(params)))
    assert meta["data"]["step"] == 7
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path((rp, ro))[0],
                                 jax.tree_util.tree_flatten_with_path((params, opt))[0]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_shape_template_and_placement(tmp_path):
    """A template of meta tensors (``model_params_shape``: nothing
    allocated) restores the parameters of a ``(params, opt_state)``
    checkpoint by their ``0/...`` paths; ``place`` gives tensors on the
    named device equal to what was saved."""
    cfg = smoke_config("deepseek-moe-16b")
    params = T.init_params(cfg, seed=5, device="cpu")
    CheckpointManager(str(tmp_path), async_write=False).save(1, (params, adamw_init(params)))
    shapes = map_with_path(lambda _p, s: torch.empty(s, device="meta"),
                           T.model_params_shape(cfg), is_leaf=lambda x: isinstance(x, tuple))
    (arrays,), _ = CheckpointManager(str(tmp_path), async_write=False).restore((shapes,))
    assert all(isinstance(a, np.memmap) for _, a in flatten_with_path(arrays))
    placed = place(arrays, "cpu")
    for (path, a), (_, b) in zip(flatten_with_path(placed), flatten_with_path(params)):
        assert a.device.type == "cpu" and torch.equal(a, b), path
