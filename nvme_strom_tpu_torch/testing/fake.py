"""Fault injection of the device backend (the JAX package's
``testing/fake.py`` :class:`backend_fault`, its hang and error modes).

``FaultPlan`` and ``FakeNvmeSource`` are not ported yet.
"""

from __future__ import annotations

import time

__all__ = ["backend_fault"]


class backend_fault:
    """Context manager injecting a device-backend failure at the bounded
    fence: ``mode="hang"`` makes the next fence outlast its timeout
    (config ``backend_fence_timeout``), ``mode="error"`` raises a runtime
    error from it.  Either way the monitor latches loss and the fence
    raises ENODEV: a loader or restore fails instead of hanging.

    On exit the latch is reset; buffers already revoked stay revoked."""

    def __init__(self, mode: str = "hang", *, hang_s: float = 30.0):
        if mode not in ("hang", "error"):
            raise ValueError(f"backend_fault mode {mode!r}")
        self.mode = mode
        self.hang_s = hang_s

    def __enter__(self):
        from ..hbm.backend import monitor

        def hook(what: str) -> None:
            if self.mode == "error":
                raise RuntimeError(f"injected device failure during {what}")
            time.sleep(self.hang_s)   # the bounded fence times out first

        monitor._set_fault(hook)
        return self

    def __exit__(self, *exc):
        from ..hbm.backend import monitor
        monitor._set_fault(None)
        monitor.reset()
        return False
