"""Synthetic, seeded data (nothing is downloaded)."""
from .pipeline import (  # noqa: F401
    CalibrationSampler,
    DataState,
    SyntheticLM,
    make_batch_iterator,
)
