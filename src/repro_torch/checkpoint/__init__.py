"""Checkpoints in the reference's on-disk format (the port of
``repro.checkpoint``)."""
from .manager import CheckpointManager, flatten_with_path, place  # noqa: F401
