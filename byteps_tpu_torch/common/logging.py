"""Leveled logging, analogous to the reference's BPS_LOG / BPS_CHECK
(reference: byteps/common/logging.{h,cc}, BYTEPS_LOG_LEVEL env control).

The port's own copy of ``byteps_tpu/common/logging.py``.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER: logging.Logger | None = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("byteps_tpu_torch")
        level = os.environ.get("BPS_LOG_LEVEL", os.environ.get("BYTEPS_LOG_LEVEL", "INFO"))
        logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "[%(asctime)s] BPS %(levelname)s %(message)s", "%H:%M:%S"))
            logger.addHandler(h)
        logger.propagate = False
        _LOGGER = logger
    return _LOGGER


def bps_check(cond: bool, msg: str = "") -> None:
    """Hard invariant check (reference: BPS_CHECK, logging.h)."""
    if not cond:
        raise AssertionError(f"BPS_CHECK failed: {msg}")
