"""Process-wide counters of the SSD→GPU path.

A plain dictionary of integers under one lock, with the names the JAX
package's registry uses for the same events:

* ``nr_ssd2dev`` — memcpy tasks that completed (one per engine command);
* ``nr_submit_dma`` / ``total_dma_length`` — direct read requests issued
  and their bytes;
* ``nr_kernel_dispatch`` — filter calls the scan pipeline made;
* ``h2d_depth_reached`` — gauge: deepest H2D pipeline any load or scan
  reached.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["Stats", "stats"]


class Stats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {}

    def add(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + delta

    def gauge_max(self, name: str, value: int) -> None:
        with self._lock:
            if value > self._c.get(name, 0):
                self._c[name] = value

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def reset(self) -> None:
        with self._lock:
            self._c.clear()


#: process-wide counters
stats = Stats()
