"""Atomic, async, keep-k checkpoints in the reference's format (the port
of ``repro.checkpoint.manager``).

* **Format** — a checkpoint is a directory ``step_<N:08d>/`` holding one
  ``.npy`` per leaf (``a00000.npy``, ... in the tree's flattening order)
  and ``manifest.json``: ``{"step", "meta", "arrays": {path: {"file",
  "dtype", "shape"}}}``. Trees flatten as ``jax.tree_util`` flattens the
  reference's: dict keys sorted, list and tuple items by index, a
  NamedTuple's fields (``AdamWState``) spelled ``.m``, ``.v``, ``.count``,
  ``None`` holding nothing. A checkpoint of ``(params, opt_state)`` has the
  paths ``0/embed``, ``0/layers/attn/wq``, ..., ``1/.m/embed``,
  ``1/.count``, as the reference writes them, so either package restores
  the other's.
* **Atomicity** — a checkpoint is staged in ``step_<N>.tmp/``, every file
  fsynced, then committed with ``os.replace``. Readers see only complete
  directories; a ``.tmp`` left by a crash is removed when a manager is
  constructed.
* **Async** — ``save`` copies every leaf to host numpy on the caller's
  thread (a device tensor's copy is the snapshot; a host tensor is copied
  too, so a step that then updates the tree in place cannot reach it) and
  hands the disk writes to a writer thread. ``wait`` drains the queue and
  ``close`` stops the thread; both raise a writer's error, as the next
  ``save`` does.
* **Keep-k** — after each commit the oldest steps beyond ``keep`` are
  deleted.
* **Placement** — ``restore(template)`` returns numpy arrays
  (memory-mapped) in the template's structure; :func:`place` puts them on
  a device. Arrays are stored whole, so a checkpoint written from one
  device restores onto any other (the reference's ``runtime/elastic.py``
  re-shards restored arrays onto a new mesh; on one device that is this
  placement).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten_with_path", "place"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in ``jax.tree_util.tree_flatten_with_path``'s
    order, each path spelled as the reference's manager spells it."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [x for f in tree._fields
                for x in flatten_with_path(getattr(tree, f), path + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flatten_with_path(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _map_with_path(fn: Callable[[str, Any], Any], tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over ``tree``, keeping its structure
    (NamedTuples included); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _host(x) -> np.ndarray:
    """A leaf's host copy: a tensor's through ``.cpu()`` (a device tensor's
    copy is the snapshot; a host tensor is copied)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.cpu().numpy() if x.device.type != "cpu" else x.numpy().copy()
    return np.array(x, copy=True)


def place(tree, device):
    """Restored numpy arrays (memory-mapped or not) -> tensors on
    ``device``, in the same structure."""
    dev = torch.device(device)
    return _map_with_path(
        lambda _p, a: torch.from_numpy(np.array(a, copy=True, order="C")).to(dev), tree)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = int(keep)
        os.makedirs(self.dir, exist_ok=True)
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        if async_write:
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()
        # A partial write of a crashed process is never read; remove it.
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree, *, meta: Optional[Dict[str, Any]] = None):
        """Snapshot to host memory now; write to disk (a)synchronously."""
        items = [(p, _host(x)) for p, x in flatten_with_path(tree)]
        payload = (int(step), items, dict(meta or {}))
        if self._thread is None:
            self._write(payload)
        else:
            self._raise_pending()
            self._q.put(payload)

    def _writer(self):
        while True:
            payload = self._q.get()
            try:
                if payload is None:
                    return
                self._write(payload)
            except BaseException as e:  # raised by the next save(), wait() or close()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, payload):
        step, items, meta = payload
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "meta": meta, "arrays": {}}
        for i, (path, arr) in enumerate(items):
            fname = f"a{i:05d}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["arrays"][path] = {"file": fname, "dtype": str(arr.dtype),
                                        "shape": list(arr.shape)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # the commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, *,
                mmap: bool = True) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``template`` (by path): its leaves
        are anything with a ``shape`` (tensors, meta tensors, numpy
        arrays). Returns (tree of numpy arrays, meta). A path missing from
        the checkpoint raises ``KeyError``, a stored shape other than the
        template's ``ValueError``; arrays the template does not name are
        ignored."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = manifest["arrays"]

        def load(path, leaf):
            if path not in arrays:
                raise KeyError(f"checkpoint {step} missing array {path!r}")
            arr = np.load(os.path.join(d, arrays[path]["file"]), mmap_mode="r" if mmap else None)
            want = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))
            if tuple(arr.shape) != want:
                raise ValueError(f"{path}: stored shape {tuple(arr.shape)} != template {want}")
            return arr

        return _map_with_path(load, template), manifest["meta"]

    # ------------------------------------------------------------------ misc

    def wait(self):
        """Drain pending async writes (and raise a writer's error)."""
        if self._thread is not None:
            self._q.join()
        self._raise_pending()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=30)
            self._thread = None
        self._raise_pending()
