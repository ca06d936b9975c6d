"""Leveled logging.

Analog of the reference's WHOLEMEMORY_ERROR/WARN/INFO/DEBUG/TRACE macro family
(reference: cpp/src/logger.hpp:70-87). Built on :mod:`logging`; the level is
settable via :func:`set_log_level` or the ``WGTPU_LOG_LEVEL`` env var.
"""

from __future__ import annotations

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": TRACE,
}

logger = logging.getLogger("wholegraph_tpu_torch")

if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("[%(levelname)s][wholegraph_tpu_torch] %(message)s")
    )
    logger.addHandler(_h)
    logger.propagate = False
    logger.setLevel(_LEVELS.get(os.environ.get("WGTPU_LOG_LEVEL", "info").lower(), logging.INFO))


def set_log_level(level: str | int) -> None:
    """Set the library log level ('error'|'warn'|'info'|'debug'|'trace' or int)."""
    if isinstance(level, str):
        level = _LEVELS[level.lower()]
    logger.setLevel(level)


def error(msg: str, *args) -> None:
    logger.error(msg, *args)


def warn(msg: str, *args) -> None:
    logger.warning(msg, *args)


def info(msg: str, *args) -> None:
    logger.info(msg, *args)


def debug(msg: str, *args) -> None:
    logger.debug(msg, *args)


def trace(msg: str, *args) -> None:
    logger.log(TRACE, msg, *args)
