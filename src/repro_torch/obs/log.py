"""Per-component loggers for launchers and benches (the port of
``repro.obs.log``).

Components log through ``logging`` with per-component names under the
``repro_torch`` root (``repro_torch.launch.serve``, ...), configured once
via :func:`setup_logging` from a ``--log-level`` flag. Anything that must
stay machine-parseable on stdout (JSON results) keeps using ``print``.
"""
from __future__ import annotations

import logging

__all__ = ["add_log_level_arg", "get_logger", "setup_logging"]

_FORMAT = "%(levelname)s %(name)s: %(message)s"
_ROOT = "repro_torch"


def get_logger(component: str) -> logging.Logger:
    """Logger named ``repro_torch.<component>`` (idempotent)."""
    name = component if component.startswith(_ROOT) else f"{_ROOT}.{component}"
    return logging.getLogger(name)


def setup_logging(level: str = "INFO") -> None:
    """Configure the ``repro_torch`` logger tree to emit to stderr at ``level``.

    Only touches the ``repro_torch`` root logger (no ``basicConfig``), so library
    users embedding the engine keep full control of the global logging
    config. Calling twice replaces the handler rather than duplicating it.
    """
    root = logging.getLogger(_ROOT)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False


def add_log_level_arg(ap) -> None:
    """Attach the shared ``--log-level`` flag to an argparse parser."""
    ap.add_argument(
        "--log-level", default="INFO",
        choices=("DEBUG", "INFO", "WARNING", "ERROR"),
        help="logging verbosity for repro_torch.* components (default INFO)",
    )
