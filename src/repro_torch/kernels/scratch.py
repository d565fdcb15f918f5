"""Device scratch memory that the kernel wrappers keep between calls.

A wrapper asks for ``nbytes`` of scratch under its own key and device: the
buffer it got last time is reused when it is large enough and replaced by a
larger one when it is not, so a steady serving loop allocates nothing per
call. **Reuse relies on stream ordering**: every wrapper launches on the
device's current stream, and a call's kernels are done with the buffer
before the next call's kernels, queued behind them on that stream, start.
Two streams that ran one wrapper's kernels at once would need buffers of
their own.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["buffer", "clear"]

_bufs: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def buffer(key: str, device, nbytes: int, *, zeroed: bool = False) -> torch.Tensor:
    """A uint8 tensor of at least ``nbytes`` bytes on ``device``, kept under
    ``key``. With ``zeroed``, a new buffer starts as zeros (for counters the
    kernels return to zero themselves); the contents of a reused buffer are
    whatever the last call left."""
    dev = torch.device(device)
    k = (key, dev)
    buf = _bufs.get(k)
    if buf is None or buf.numel() < nbytes:
        make = torch.zeros if zeroed else torch.empty
        buf = make((max(nbytes, 1),), dtype=torch.uint8, device=dev)
        _bufs[k] = buf
    return buf


def clear() -> None:
    """Drop every kept buffer (the next call allocates anew)."""
    _bufs.clear()
