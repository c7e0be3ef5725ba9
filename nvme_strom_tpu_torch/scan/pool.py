"""DMA staging buffer pool with leak recovery.

Capability analog of the pgsql extension's shared DMA buffer pool
(`pgsql/nvme_strom.c:56-111,1123-1526`): a freelist of fixed-size chunks
carved from one pinned :class:`~..engine.DmaBuffer`, blocking allocation,
and **leak recovery** through :class:`ResourceOwner` scopes — chunks still
held when a scan aborts are returned automatically, and clean-exit leaks
are warned about (``NVMEStromCleanupDMABuffer``, `:1302-1351`).

Per-NUMA-node freelists are left out: the pool is one node's worth.
"""

from __future__ import annotations

import errno as _errno
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api import StromError
from ..config import config
from ..engine import DmaBuffer

__all__ = ["DmaChunk", "DmaBufferPool", "ResourceOwner"]


@dataclass
class DmaChunk:
    pool: "DmaBufferPool"
    view: memoryview
    owner: Optional["ResourceOwner"] = None
    allocated: bool = False

    def release(self) -> None:
        self.pool.free(self)


class ResourceOwner:
    """Scoped owner of pool chunks (PG ResourceOwner analog).  On normal
    exit still-held chunks are a leak, returned with a warning; on
    exception exit they are returned silently (abort recovery)."""

    def __init__(self, name: str = "scan"):
        self.name = name
        self._chunks: Dict[int, DmaChunk] = {}
        self._lock = threading.Lock()

    def _attach(self, chunk: DmaChunk) -> None:
        with self._lock:
            self._chunks[id(chunk)] = chunk
            chunk.owner = self

    def _detach(self, chunk: DmaChunk) -> None:
        with self._lock:
            self._chunks.pop(id(chunk), None)
            chunk.owner = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        with self._lock:
            leaked = list(self._chunks.values())
            self._chunks.clear()
        if leaked and exc_type is None:
            warnings.warn(f"ResourceOwner {self.name!r}: {len(leaked)} DMA "
                          f"chunk(s) leaked at clean exit; returning to pool",
                          ResourceWarning, stacklevel=2)
        for c in leaked:
            c.owner = None
            c.pool.free(c)


class DmaBufferPool:
    """Freelist of ``chunk_size`` chunks of one pinned buffer."""

    def __init__(self, *, total_size: int, chunk_size: Optional[int] = None):
        self.chunk_size = chunk_size or config.get("chunk_size")
        if total_size % self.chunk_size:
            raise StromError(_errno.EINVAL,
                             "pool size must be a multiple of chunk_size")
        self.n_chunks = max(total_size // self.chunk_size, 1)
        self.buffer = DmaBuffer(self.n_chunks * self.chunk_size)
        view = self.buffer.view()
        self._free: List[DmaChunk] = [
            DmaChunk(self, view[i * self.chunk_size:
                                   (i + 1) * self.chunk_size])
            for i in range(self.n_chunks)]
        self._lock = threading.Condition()
        self._outstanding = 0
        self._closed = False

    def alloc(self, *, timeout: Optional[float] = None,
              owner: Optional[ResourceOwner] = None) -> DmaChunk:
        """Allocate one chunk, blocking until one is free (reference
        NVMEStromAllocDMABuffer, `pgsql/nvme_strom.c:1186-1260`)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._closed:
                    raise StromError(_errno.EBADF, "pool closed")
                if self._free:
                    chunk = self._free.pop()
                    chunk.allocated = True
                    self._outstanding += 1
                    if owner is not None:
                        owner._attach(chunk)
                    return chunk
                remain = None if deadline is None \
                    else deadline - time.monotonic()
                if (remain is not None and remain <= 0) \
                        or not self._lock.wait(remain):
                    raise StromError(_errno.ETIMEDOUT, "pool alloc timeout")

    def free(self, chunk: DmaChunk) -> None:
        """Return a chunk.  Idempotent: abort paths may race the owner's
        cleanup with the consumer's."""
        if chunk.owner is not None:
            chunk.owner._detach(chunk)
        with self._lock:
            if not chunk.allocated:
                return
            chunk.allocated = False
            self._free.append(chunk)
            self._outstanding -= 1
            self._lock.notify()

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            if self._outstanding:
                warnings.warn(f"DmaBufferPool closed with "
                              f"{self._outstanding} outstanding chunk(s)",
                              ResourceWarning)
            self._closed = True
            self._lock.notify_all()
        self._free.clear()
        self.buffer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
