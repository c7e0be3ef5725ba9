"""nvme_strom_tpu_torch — SSD→GPU direct loading and page scans in PyTorch.

The PyTorch/CUDA port of ``nvme_strom_tpu``: the same SSD → pinned host →
device pipeline and heap-page scan, with torch tensors on an NVIDIA GPU and
hand-written CUDA kernels in place of the Pallas TPU kernels.  The package
imports ``torch`` and ``numpy`` and nothing of the JAX package.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``;
with no CUDA device they raise ``StromError(ENODEV)``.

* :mod:`.engine` — file check, sources, pinned buffers, async read tasks.
* :mod:`.hbm` — device registry, bounded fences, the staging pipeline.
* :mod:`.scan` — heap page format, DMA pool, table scanner.
* :mod:`.ops` — the page filter: plain PyTorch and the CUDA kernel.
"""

from .api import BufferInfo, FileInfo, FsKind, MemCopyResult, StromError
from .config import config
from .engine import DmaBuffer, PlainSource, Session, Source, check_file, \
    open_source
from .stats import stats

__all__ = ["BufferInfo", "DmaBuffer", "FileInfo", "FsKind", "MemCopyResult",
           "PlainSource", "Session", "Source", "StromError", "check_file",
           "config", "open_source", "stats"]
