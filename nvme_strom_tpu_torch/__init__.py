"""nvme_strom_tpu_torch — SSD→GPU direct loading and page scans in PyTorch.

The PyTorch/CUDA port of ``nvme_strom_tpu``: the same SSD → pinned host →
device pipeline and heap-page scan, with torch tensors on an NVIDIA GPU and
hand-written CUDA kernels in place of the Pallas TPU kernels.  The package
imports ``torch`` and ``numpy`` and nothing of the JAX package.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``;
with no CUDA device they raise ``StromError(ENODEV)``.

* :mod:`.engine` — file check, sources, pinned buffers, async read and
  write tasks, executed by :mod:`._native` (the io_uring engine, built
  with ``g++`` at first use) or a Python thread pool;
  :mod:`.eligibility`, the backing device's verdict from sysfs (NVMe,
  md-RAID-0 of NVMe, NUMA node, DMA64) that ``check_file`` reports.
* :mod:`.trace` — the flight recorder: per-task spans, Chrome-trace dumps
  (``tools/strom_trace.py``), the Prometheus rendering of :mod:`.stats`.
* :mod:`.hbm` — device registry, bounded fences, the staging pipeline.
* :mod:`.scan` — heap page format, DMA pool, table scanner, the planner
  (direct-scan threshold, capability cache, cost model), the query
  layer over a path, a stripe set or an open Source, dictionary-encoded
  string columns and the SQL facade (``sql_query``, ``parse_sql``,
  ``create_table_as``; the ``strom_query_gpu`` CLI).
* :mod:`.ops` — the kernels (page filter, GROUP BY, packed decode, ring
  permute): plain PyTorch versions and the CUDA kernels.
* :mod:`.parallel` — the ring of members: sharded and multi-host loading,
  the ring permute, all-gather and the ring multi-query scan.
"""

from .api import BufferInfo, FileInfo, FsKind, MemCopyResult, StromError
from .config import config
from .eligibility import BackingInfo, probe_backing
from .engine import DmaBuffer, PlainSource, SegmentedSource, Session, \
    Source, StripedSource, check_file, open_source
from .stats import stats
from .trace import recorder

__all__ = ["BackingInfo", "BufferInfo", "DmaBuffer", "FileInfo", "FsKind",
           "MemCopyResult", "PlainSource", "SegmentedSource", "Session", "Source",
           "StringDict", "StripedSource", "StromError", "check_file", "config",
           "create_table_as", "dict_path_for", "encode_strings", "load_dict",
           "open_source", "parse_sql", "probe_backing", "recorder",
           "save_dict", "sql_query", "stats"]

_SCAN = ("StringDict", "create_table_as", "dict_path_for", "encode_strings",
         "load_dict", "parse_sql", "save_dict", "sql_query")


def __getattr__(name):
    # the scan layer loads on first use: importing the package stays light
    if name in _SCAN:
        from . import scan
        return getattr(scan, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
