"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (``configs/``, ``core/``,
``kernels/``, ``models/``, ``serving/``, ``launch/``) and imports neither
JAX nor anything of ``repro``. Its main path is the reference's: quantize a
dense decoder once with OCS (``core.apply.quantize_params``), then serve it
greedily on the paged engine (``serving.ServingEngine``) in dynamic W8A8
with int8 (or float) KV pages. On the card every linear layer runs the
hand-written ``fused_qmatmul`` CUDA kernel and every decode-attention layer
the ``paged_attention`` CUDA kernel (``csrc/``); on the CPU the same
wrappers run their plain PyTorch versions.
"""
from .device import resolve_device  # noqa: F401
