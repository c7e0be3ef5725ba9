"""NUMA-aware DMA staging buffer pool with leak recovery.

Capability analog of the pgsql extension's shared DMA buffer pool
(`pgsql/nvme_strom.c:56-111,1123-1526`): per-NUMA-node freelists of
fixed-size chunks, each node's carved from one pinned
:class:`~..engine.DmaBuffer` placed on that node, with the preferred
node first and the others
round-robin after it; blocking allocation; and **leak recovery** through
:class:`ResourceOwner` scopes — chunks still held when a scan aborts are
returned automatically, and clean-exit leaks are warned about
(``NVMEStromCleanupDMABuffer``, `:1302-1351`).  The nodes are config
``numa_node_mask`` intersected with the nodes that have memory
(:func:`..numa.allowed_nodes`); a host without NUMA sysfs has one, node 0.
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
from ..numa import allowed_nodes

__all__ = ["DmaChunk", "DmaBufferPool", "ResourceOwner"]


@dataclass
class DmaChunk:
    pool: "DmaBufferPool"
    node: int
    index: int
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
    """Per-node freelists of ``chunk_size`` chunks: *total_size* split
    evenly over the allowed nodes, rounded up so the pool never holds
    fewer chunks than its caller sized, one pinned :class:`DmaBuffer` a
    node, placed there.  ``numa_mask`` (default config
    ``numa_node_mask``, -1 every node) picks the nodes."""

    def __init__(self, *, total_size: int, chunk_size: Optional[int] = None,
                 numa_mask: Optional[int] = None):
        self.chunk_size = chunk_size or config.get("chunk_size")
        if total_size % self.chunk_size:
            raise StromError(_errno.EINVAL,
                             "pool size must be a multiple of chunk_size")
        mask = int(config.get("numa_node_mask")) if numa_mask is None \
            else int(numa_mask)
        self.nodes: List[int] = allowed_nodes(mask)
        per_node = max(-(-(total_size // self.chunk_size)
                         // len(self.nodes)), 1)
        self._free: Dict[int, List[DmaChunk]] = {}
        self.buffers: List[DmaBuffer] = []
        try:
            for node in self.nodes:
                buf = DmaBuffer(per_node * self.chunk_size, numa_node=node)
                self.buffers.append(buf)
                view = buf.view()
                self._free[node] = [
                    DmaChunk(self, node, i,
                             view[i * self.chunk_size:
                                  (i + 1) * self.chunk_size])
                    for i in range(per_node)]
        except BaseException:
            for buf in self.buffers:
                buf.close()
            raise
        self.n_chunks = per_node * len(self.nodes)
        self._lock = threading.Condition()
        self._outstanding = 0
        self._closed = False

    def backing_buffer(self, node: int) -> DmaBuffer:
        """The buffer a chunk of *node* is carved from: a scan maps each
        chunk with it as the backing, so a session registers one io_uring
        fixed buffer a node."""
        return self.buffers[self.nodes.index(node)]

    def pin_cuda(self) -> None:
        """``cudaHostRegister`` every node's buffer (idempotent)."""
        for buf in self.buffers:
            buf.pin_cuda()

    def alloc(self, *, preferred_node: int = -1,
              timeout: Optional[float] = None,
              owner: Optional[ResourceOwner] = None) -> DmaChunk:
        """Allocate one chunk, *preferred_node* first, then the other
        nodes in order, blocking until one is free (reference
        NVMEStromAllocDMABuffer, `pgsql/nvme_strom.c:1186-1260`)."""
        order = list(self.nodes)
        if preferred_node in self._free:
            order.remove(preferred_node)
            order.insert(0, preferred_node)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._closed:
                    raise StromError(_errno.EBADF, "pool closed")
                for node in order:
                    if self._free[node]:
                        chunk = self._free[node].pop()
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
            self._free[chunk.node].append(chunk)
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
        for buf in self.buffers:
            buf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
