"""Device resolution for the port's entry points.

Every entry point (``init_params``, ``quantize_params``, ``ServingEngine``,
``launch.serve``) runs on the card unless the caller asks for the CPU with
``device="cpu"``. There is no silent fallback: without a usable CUDA device
and without an explicit CPU request, :func:`resolve_device` raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); otherwise the named
    device, which must be ``cpu`` or an available ``cuda`` device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path "
                "on the CPU"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev
