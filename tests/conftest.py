"""Shared test setup.

The container does not ship ``hypothesis``; the property tests only use a
small slice of its API, so a deterministic stub (``_hypothesis_stub``) is
installed into ``sys.modules`` before collection when the real package is
missing. With the real package installed the stub is inert.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test (make test-fast skips)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false"
    )


try:  # pragma: no cover - exercised only where hypothesis exists
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies
