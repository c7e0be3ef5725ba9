"""Warnings on stderr under the package's own logger name."""

from __future__ import annotations

import logging

__all__ = ["pr_warn", "logger"]

logger = logging.getLogger("nvme_strom_tpu_torch")


def pr_warn(msg: str, *args) -> None:
    logger.warning(msg, *args)
