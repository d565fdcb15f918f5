"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions, and
the by-device dispatch in :mod:`.ops`. Nothing here builds at import."""
