"""Optimizer: AdamW with a cosine schedule (the port of ``repro.optim``)."""
from .adamw import AdamWState, adamw_init, adamw_update, cosine_schedule, global_norm  # noqa: F401
