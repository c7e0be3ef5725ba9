"""Leveled logging on stderr, gated by the runtime ``verbose`` knob.

A copy of the JAX package's ``log.py`` under the port's own logger name:
the reference's printk wrappers (`kmod/nvme_strom.c:75-78,122-137`) over
the stdlib logger.  ``config.set("verbose", 2)`` (or the
``STROM_TPU_VERBOSE`` tier) turns the debug lines on at run time.

Levels: 0 = warnings and errors only (default), 1 = info, 2 = debug.
"""

from __future__ import annotations

import logging
import sys

from .config import config

__all__ = ["pr_debug", "pr_info", "pr_warn", "pr_error", "logger"]


class _StderrHandler(logging.StreamHandler):
    """Resolves ``sys.stderr`` at emit time, so a redirection or a capture
    made after the import sees the line."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):  # StreamHandler.__init__ assigns it
        pass


logger = logging.getLogger("nvme_strom_tpu_torch")
if not logger.handlers:
    _h = _StderrHandler()
    _h.setFormatter(logging.Formatter(
        "nvme_strom_tpu_torch: %(levelname)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.DEBUG)     # each call is gated by `verbose`
    logger.propagate = False


def pr_debug(msg: str, *args) -> None:
    if config.get("verbose") >= 2:
        logger.debug(msg, *args)


def pr_info(msg: str, *args) -> None:
    if config.get("verbose") >= 1:
        logger.info(msg, *args)


def pr_warn(msg: str, *args) -> None:
    logger.warning(msg, *args)


def pr_error(msg: str, *args) -> None:
    logger.error(msg, *args)
