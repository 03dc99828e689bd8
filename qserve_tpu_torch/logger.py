"""Stdout logger (reference: qserve/logger.py — vLLM-style formatter)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(levelname)s %(asctime)s [%(name)s:%(lineno)d] %(message)s"
_DATEFMT = "%m-%d %H:%M:%S"

_root_configured = False


def _configure_root() -> None:
    global _root_configured
    if _root_configured:
        return
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    root = logging.getLogger("qserve_tpu_torch")
    root.setLevel(logging.INFO)
    root.addHandler(handler)
    root.propagate = False
    _root_configured = True


def init_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("qserve_tpu_torch"):
        name = f"qserve_tpu_torch.{name}"
    return logging.getLogger(name)
