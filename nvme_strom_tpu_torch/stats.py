"""Process-wide counters of the SSD→GPU path.

A plain dictionary of integers under one lock, with the names the JAX
package's registry uses for the same events:

* ``nr_ssd2dev`` — memcpy tasks that completed (one per engine command);
* ``nr_submit_dma`` / ``total_dma_length`` — direct read requests issued
  and their bytes;
* ``nr_kernel_dispatch`` — filter calls the scan pipeline made;
* ``h2d_depth_reached`` — gauge: deepest H2D pipeline any load or scan
  reached;
* ``nr_shard_load`` / ``bytes_shard_load`` — per-host reads of the
  multi-host sharded loader and their bytes;
* ``nr_ici_permute`` / ``bytes_ici`` — ring steps of the on-device shard
  redistribution and all-gather, and the bytes they moved;
* ``clk_shard_load`` / ``clk_ici_redistribute`` / ``clk_ici_gather`` —
  wall ns of the multi-host loader's read phase, redistribution and
  gather (the port's stand-in for the JAX package's trace spans);
* ``nr_shard_wait`` / ``clk_shard_wait`` — per-shard submit→completion
  waits of the sharded batch stream, with one log2-ns histogram per shard
  (:meth:`Stats.shard_snapshot`).
"""

from __future__ import annotations

import threading
from typing import Dict, List

__all__ = ["Stats", "stats", "hist_percentiles"]

LAT_HIST_BUCKETS = 64


def hist_percentiles(hist, qs=(0.50, 0.95, 0.99)):
    """Percentile estimates (ns) from a log2 histogram, one per q in *qs*:
    each bucket's mass sits at its geometric midpoint (1.5 * 2^b); None
    per q when the histogram is empty."""
    total = sum(hist)
    out = []
    for q in qs:
        val = None
        if total > 0:
            acc = 0
            for b, n in enumerate(hist):
                acc += n
                if acc >= q * total and n:
                    val = (1 << b) + ((1 << b) >> 1)
                    break
        out.append(val)
    return out


class Stats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {}
        self._shard_hist: Dict[int, List[int]] = {}

    def add(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + delta

    def gauge_max(self, name: str, value: int) -> None:
        with self._lock:
            if value > self._c.get(name, 0):
                self._c[name] = value

    def shard_wait(self, shard: int, ns: int) -> None:
        """Account one shard's submit→completion wait: the ``nr_/
        clk_shard_wait`` pair and the shard's own log2-ns histogram, so a
        straggling shard is not smeared into the aggregate."""
        b = min(max(int(ns), 1).bit_length() - 1, LAT_HIST_BUCKETS - 1)
        with self._lock:
            self._c["nr_shard_wait"] = self._c.get("nr_shard_wait", 0) + 1
            self._c["clk_shard_wait"] = self._c.get("clk_shard_wait", 0) + ns
            h = self._shard_hist.setdefault(int(shard),
                                            [0] * LAT_HIST_BUCKETS)
            h[b] += 1

    def shard_snapshot(self) -> Dict[int, dict]:
        """``{shard: {"n", "p50_ns", "p95_ns"}}`` from the per-shard wait
        histograms (percentile keys only when the histogram has mass)."""
        with self._lock:
            hists = {k: list(h) for k, h in sorted(self._shard_hist.items())}
        out = {}
        for k, h in hists.items():
            d = {"n": sum(h)}
            p50, p95, _ = hist_percentiles(h)
            if p50 is not None:
                d["p50_ns"] = p50
            if p95 is not None:
                d["p95_ns"] = p95
            out[k] = d
        return out

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def reset(self) -> None:
        with self._lock:
            self._c.clear()
            self._shard_hist.clear()


#: process-wide counters
stats = Stats()
