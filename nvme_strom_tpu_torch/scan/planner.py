"""Scan planning: the access path, the cost model, and where a packed
(``.cpk``) scan expands its rows.

Ported from the JAX package's ``scan/planner.py``.  The pgsql extension's
planner integration (`pgsql/nvme_strom.c:217-633`):

* **capability cache** — CHECK_FILE's directory-scoped facts (can this
  filesystem load direct, the backing's verdict, NUMA node, DMA64, the
  request cap) cached per directory with a TTL, a one-entry MRU and
  ``invalidate()`` (the reference's per-tablespace cache and syscache
  callback, `:217-348`).  A file's size is read fresh on every probe.
* **size threshold** — the direct path pays off only for a table the host
  page cache cannot hold: ``(RAM − buffer_size)·⅔ + buffer_size``
  (`:1544-1559`, ``shared_buffers`` there), RAM from ``/proc/meminfo``;
  config ``debug_no_threshold`` plans direct whatever the size, and
  ``enabled`` off never does.
* **cost model** — a per-page cost reduced by config ``seq_page_cost``
  (¼ of the conventional cost by default, `:1614-1625`), a per-tuple CPU
  cost, and worker processes dividing both by PostgreSQL's parallel
  divisor, the disk component by at most 4 (`:491-517`), so I/O cost does
  not shrink linearly with workers.

The pushdown rule: when the
host→device link is slower than the SSD, packed bytes must cross the link
packed and expand on the device (``chip``); when the SSD is the slower
leg, packed bytes leave the disk and expand on the host (``host``), which
keeps the decode off the device; a codec that saves too little is not
worth either (``raw``, the heap scan).

The rates come from, in order: config ``pushdown_h2d_gbps`` /
``pushdown_ssd_gbps``; the live host→device meter of the scan pipeline
(:data:`..hbm.staging.h2d_meter`, h2d only); the defaults below.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from ..api import FileInfo, FsKind
from ..config import config
from ..engine import PAGE_SIZE, check_file, fs_class

__all__ = ["CapabilityCache", "capability_cache", "direct_scan_threshold",
           "should_use_direct_scan", "ScanCost", "cost_direct_scan",
           "cost_vfs_scan", "H2D_GBPS_DEFAULT", "SSD_GBPS_DEFAULT",
           "transport_rates", "PushdownDecision", "decide_pushdown"]

# conventional-path cost per 8 KiB page (PostgreSQL's seq_page_cost = 1.0)
VFS_PAGE_COST = 1.0
CPU_TUPLE_COST = 0.01
_MAX_PARALLEL_DISK_DIVISOR = 4.0   # the reference caps at 4 (:491-517)


class CapabilityCache:
    """Directory-level capability cache (a TTL and explicit invalidation).

    It caches only facts of the directory's filesystem and device; the
    file's size is stat'ed on every probe and the size rule (a file under
    a page is not direct-load capable) applied to it there, so one file's
    size, or its verdict, is never given for another of the same
    directory."""

    def __init__(self, ttl_s: float = 60.0):
        self._lock = threading.Lock()
        self._cache: Dict[str, Tuple[FileInfo, float]] = {}
        self._mru: Optional[Tuple[str, FileInfo, float]] = None  # (:233)
        self.ttl_s = ttl_s

    @staticmethod
    def _fresh(path: str, cap: FileInfo) -> FileInfo:
        size = os.stat(path).st_size
        kind = cap.fs_kind if size >= PAGE_SIZE else FsKind.UNSUPPORTED
        # replace(): a field added to FileInfo flows through unchanged
        return dataclasses.replace(cap, path=path, file_size=size,
                                   fs_kind=kind)

    def probe(self, path: str) -> FileInfo:
        d = os.path.dirname(os.path.abspath(path)) or "/"
        now = time.monotonic()
        with self._lock:
            if self._mru is not None and self._mru[0] == d \
                    and now - self._mru[2] < self.ttl_s:
                return self._fresh(path, self._mru[1])
            hit = self._cache.get(d)
            if hit is not None and now - hit[1] < self.ttl_s:
                self._mru = (d, hit[0], hit[1])
                return self._fresh(path, hit[0])
        # the facts only (strict=False): should_use_direct_scan applies the
        # policy live, so require_nvme_backing takes effect at once
        cap = check_file(path, strict=False)
        if cap.file_size < PAGE_SIZE:
            # the directory's entry holds its filesystem's class, not this
            # file's size verdict (_fresh applies that to each file)
            cap = dataclasses.replace(cap, fs_kind=fs_class(path))
        with self._lock:
            self._cache[d] = (cap, now)
            self._mru = (d, cap, now)
        return self._fresh(path, cap)

    def invalidate(self, directory: Optional[str] = None) -> None:
        """The syscache callback's counterpart (`:340-348`): forget one
        directory, or all."""
        with self._lock:
            if directory is None:
                self._cache.clear()
            else:
                self._cache.pop(os.path.abspath(directory), None)
            self._mru = None


capability_cache = CapabilityCache()


def _mem_total_bytes() -> int:
    """Physical RAM, which the reference's threshold counts (`:1544-1559`);
    8 GiB when ``/proc/meminfo`` cannot be read."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) << 10
    except OSError:
        pass
    return 8 << 30


def direct_scan_threshold() -> int:
    """Table size at or above which the direct path is planned:
    ``(RAM − buffer_size)·⅔ + buffer_size`` (`:1544-1559`)."""
    ram = _mem_total_bytes()
    shared = config.get("buffer_size")
    return int((max(ram - shared, 0) * 2) // 3 + shared)


def should_use_direct_scan(path: str, *,
                           table_size: Optional[int] = None) -> bool:
    """The add-path gate (``nvmestrom_add_scan_path``, `:555-596`):
    ``enabled``, a direct-load capable file (CHECK_FILE through the
    capability cache), the strict-eligibility policy when
    ``require_nvme_backing`` is set (read live, not cached), then
    ``debug_no_threshold`` or the size threshold.  *table_size* is the
    whole table's (a multi-file set's), *path* the file probed."""
    if not config.get("enabled"):
        return False
    info = capability_cache.probe(path)
    if not info.supported:
        return False
    if config.get("require_nvme_backing") and not info.strict_eligible:
        return False
    size = table_size if table_size is not None else info.file_size
    if config.get("debug_no_threshold"):
        return True
    return size >= direct_scan_threshold()


@dataclass(frozen=True)
class ScanCost:
    startup: float
    total: float
    pages: int
    workers: int


def _parallel_divisor(workers: int) -> float:
    """PostgreSQL's parallel divisor, the leader's share included."""
    d = float(max(workers, 1))
    if workers >= 1:
        d += 0.3 * min(workers, 4) / 4
    return d


def _scan_cost(n_pages: int, n_tuples: int, page_cost: float,
               workers: int) -> ScanCost:
    disk = n_pages * page_cost / min(_parallel_divisor(workers),
                                     _MAX_PARALLEL_DISK_DIVISOR)
    cpu = n_tuples * CPU_TUPLE_COST / _parallel_divisor(workers)
    return ScanCost(startup=0.0, total=disk + cpu, pages=n_pages,
                    workers=workers)


def cost_direct_scan(n_pages: int, n_tuples: int, *,
                     workers: int = 0) -> ScanCost:
    """``cost_nvmestrom_scan`` (:451-520): the per-page cost reduced by
    config ``seq_page_cost``."""
    return _scan_cost(n_pages, n_tuples,
                      float(config.get("seq_page_cost")) * VFS_PAGE_COST,
                      workers)


def cost_vfs_scan(n_pages: int, n_tuples: int, *,
                  workers: int = 0) -> ScanCost:
    """The buffered scan's cost, at the conventional per-page cost."""
    return _scan_cost(n_pages, n_tuples, VFS_PAGE_COST, workers)

# measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit: pinned host->device copies ("pinned h2d") and the scanner's
# read-only pass over a cold 1 GiB heap table ("read-only pass")
H2D_GBPS_DEFAULT = 49.3
SSD_GBPS_DEFAULT = 7.3


def transport_rates() -> Tuple[float, float]:
    """``(h2d_gbps, ssd_gbps)`` the pushdown decision runs on."""
    h2d = float(config.get("pushdown_h2d_gbps"))
    ssd = float(config.get("pushdown_ssd_gbps"))
    if not h2d:
        from ..hbm.staging import h2d_meter
        h2d = h2d_meter.observed_gbps() or H2D_GBPS_DEFAULT
    return h2d, ssd or SSD_GBPS_DEFAULT


@dataclass(frozen=True)
class PushdownDecision:
    """Where a packed scan expands, and the wire-byte prediction EXPLAIN
    reports."""

    mode: str                    # "chip" | "host" | "raw"
    wire_bytes: int              # predicted bytes crossing host->device
    logical_bytes: int           # bytes the query logically consumes
    per_column: Tuple[tuple, ...]   # (col, codec, ratio, "chip"|"host"|"raw")
    reason: str

    def explain(self) -> str:
        cols = ", ".join(
            f"col{c}={where}({codec}" +
            (f" {ratio:.1f}x)" if codec != "raw" else ")")
            for c, codec, ratio, where in self.per_column)
        codecs = "+".join(sorted({codec for _c, codec, _r, _w
                                  in self.per_column})) or "none"
        return (f"pushdown {self.mode}: predicted wire bytes: "
                f"{self.wire_bytes} ({self.logical_bytes} logical, "
                f"codec={codecs}); {cols}; {self.reason}")


def decide_pushdown(meta, need_cols: Optional[Sequence[int]] = None
                    ) -> PushdownDecision:
    """Per-column host/chip/raw decision for a packed sidecar (*meta*, a
    ``scan/colpack.py`` PackedMeta); *need_cols* restricts it to the
    columns the query reads.  ``pushdown=on`` forces chip, ``off`` raw;
    ``auto`` keys on the codec ratio against ``pushdown_chip_ratio`` and
    on which transport is the slower."""
    mode_cfg = config.get("pushdown")
    h2d, ssd = transport_rates()
    thresh = float(config.get("pushdown_chip_ratio"))
    need = set(range(len(meta.cols))) if need_cols is None \
        else set(need_cols)
    h2d_bound = ssd > h2d
    per_col = []
    for c, cm in enumerate(meta.cols):
        if c not in need:
            continue
        ratio = cm.ratio
        if mode_cfg == "on" or (ratio >= thresh and h2d_bound):
            where = "chip"
        elif ratio >= thresh:
            where = "host"
        else:
            where = "raw"
        per_col.append((c, cm.codec, round(ratio, 3), where))
    logical = 4 * meta.n_rows * len(per_col)
    # the file is one representation: page headers and unread columns'
    # regions ride along, so the wire prediction is whole packed pages
    wire_pages = meta.packed_bytes
    scan_ratio = logical / wire_pages if wire_pages else 1.0
    if mode_cfg == "off":
        mode, why = "raw", "pushdown=off"
    elif mode_cfg == "on":
        mode, why = "chip", "pushdown=on (forced)"
    elif not per_col:
        mode, why = "raw", "no packable columns in the projection"
    elif scan_ratio < thresh:
        mode, why = "raw", (f"whole-scan codec ratio {scan_ratio:.2f}x "
                            f"below chip threshold {thresh:.2f}x")
    elif h2d_bound:
        mode, why = "chip", (f"h2d is the slower leg ({h2d:.2f} vs SSD "
                             f"{ssd:.2f} GB/s): packed bytes cross the "
                             f"link, expand on the device")
    else:
        mode, why = "host", (f"SSD is the slower leg ({ssd:.2f} vs h2d "
                             f"{h2d:.2f} GB/s): packed off disk, "
                             f"expanded on the host")
    return PushdownDecision(
        mode=mode,
        wire_bytes=int(wire_pages if mode != "raw"
                       else 4 * meta.n_rows * len(meta.cols)),
        logical_bytes=int(logical),
        per_column=tuple(per_col), reason=why)
