"""Table scan executor: async DMA ring + direct-to-device filter pipeline.

Capability analog of the pgsql scan executor (`pgsql/nvme_strom.c:
636-1055`): a ring of ``async_depth`` in-flight DMA tasks kept full by
claiming chunk ranges from a cursor and waiting on the oldest
(``nvmestrom_next_chunk``, `:846-936`).  Batches land in pinned pool
chunks, are copied to the device on a copy stream, and the filter runs on
the compute stream overlapped with the next batches' reads and copies;
per-tuple visibility is masked by the filter.

Left out against the JAX package: NUMA binding for the scan's duration,
multi-file (segmented) sources, and the jitted K-wide ``CoalescedFold`` —
PyTorch dispatches eagerly, so batches fold one call at a time.
"""

from __future__ import annotations

import errno as _errno
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..api import StromError
from ..config import config
from ..engine import Session, Source, open_source
from ..stats import stats
from .heap import PAGE_SIZE, HeapSchema
from .pool import DmaBufferPool, DmaChunk, ResourceOwner

__all__ = ["LocalCursor", "Batch", "TableScanner", "fold_results",
           "cursor_chunk_count"]


def cursor_chunk_count(size: int, chunk_size: int) -> int:
    """Cursor positions for a source of *size* bytes: whole chunks plus one
    tail position when the remainder still holds whole pages."""
    n_chunks = size // chunk_size
    tail = size - n_chunks * chunk_size
    return n_chunks + (1 if (tail and tail % PAGE_SIZE == 0) else 0)


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_add(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor) and a.dtype == torch.uint32:
        # no uint32 arithmetic in torch: add the bits as int32 (mod 2^32)
        return (a.view(torch.int32) + b.view(torch.int32)).view(torch.uint32)
    return a + b


def fold_results(acc, out, combine: Optional[Callable] = None):
    """Fold one batch result into the accumulator: a sum per leaf of
    nested dicts and lists, or *combine*."""
    if acc is None:
        return out
    if combine is not None:
        return combine(acc, out)
    return _add(acc, out)


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).cpu().numpy().view(np.uint32)
        return x.cpu().numpy()
    return np.asarray(x)


class LocalCursor:
    """In-process atomic chunk-range cursor (the shared ``nsp_cblock``
    atomic, `pgsql/nvme_strom.c:883-885`, for one process)."""

    def __init__(self, n_chunks: int, start: int = 0):
        self.n_chunks = n_chunks
        self._next = start
        self._lock = threading.Lock()

    def claim(self, count: int) -> Tuple[int, int]:
        """Claim up to *count* chunks; returns (first, n), n == 0 at end."""
        with self._lock:
            first = self._next
            n = min(count, self.n_chunks - first)
            if n <= 0:
                return first, 0
            self._next += n
            return first, n


@dataclass
class Batch:
    """One completed scan batch: pages resident in a pool chunk.

    ``pages`` is a zero-copy view into pinned memory, valid until the
    batch is recycled."""

    pages: np.ndarray          # (n_pages, PAGE_SIZE) uint8 view
    chunk_ids: List[int]
    first_page: int
    nr_ssd: int
    nr_wb: int
    _chunk: DmaChunk = None
    _handle: int = 0


class TableScanner:
    """Direct-load scan over a heap source."""

    def __init__(self, source: Union[str, Source],
                 schema: Optional[HeapSchema] = None, *,
                 session: Optional[Session] = None,
                 pool: Optional[DmaBufferPool] = None,
                 cursor: Optional[LocalCursor] = None,
                 chunk_size: Optional[int] = None,
                 async_depth: Optional[int] = None):
        self.schema = schema
        self.chunk_size = chunk_size or config.get("chunk_size")
        if self.chunk_size % PAGE_SIZE:
            raise StromError(_errno.EINVAL,
                             f"chunk_size must be a multiple of {PAGE_SIZE}")
        if self.chunk_size & (self.chunk_size - 1):
            raise StromError(_errno.EINVAL, f"chunk_size {self.chunk_size} "
                                            f"must be a power of 2")
        self.pages_per_chunk = self.chunk_size // PAGE_SIZE
        self.async_depth = async_depth or config.get("async_depth")
        self._own_session = session is None
        self.session = session or Session()
        self._own_source = not isinstance(source, Source)
        self.source = open_source(source) if self._own_source else source
        self.n_chunks = self.source.size // self.chunk_size
        tail = self.source.size - self.n_chunks * self.chunk_size
        self._tail_pages = tail // PAGE_SIZE if tail % PAGE_SIZE == 0 else 0
        self.cursor = cursor or LocalCursor(
            cursor_chunk_count(self.source.size, self.chunk_size))
        self._own_pool = pool is None
        # + h2d_depth_max: scan_filter keeps that many batches alive with
        # their H2D copies in flight, on top of the DMA ring and the
        # batch being drawn
        self.pool = pool or DmaBufferPool(
            chunk_size=self.chunk_size,
            total_size=self.chunk_size *
            max(self.async_depth + int(config.get("h2d_depth_max")) + 1, 2))
        self.last_h2d_depth = 0
        self.last_batches = 0

    # -- core ring ----------------------------------------------------------
    def batches(self, owner: Optional[ResourceOwner] = None, *,
                auto_recycle: bool = True) -> Iterator[Batch]:
        """Yield completed batches, keeping ``async_depth`` DMAs in flight.

        With ``auto_recycle`` the previous batch's chunk is recycled when
        the next one is requested (one live batch); otherwise the consumer
        calls :meth:`recycle` on each batch when done with its bytes."""
        ring: List[Tuple[int, DmaChunk, int, int]] = []   # task 0 = tail
        prev: Optional[Batch] = None

        def submit_next() -> bool:
            first, n = self.cursor.claim(1)
            if n == 0:
                return False
            chunk = self.pool.alloc(owner=owner)
            handle = None
            try:
                handle = self.session.map_buffer(chunk.view,
                                                 kind="pinned_host")
                if first < self.n_chunks:
                    res = self.session.memcpy_ssd2ram(
                        self.source, handle, [first], self.chunk_size)
                    ring.append((res.dma_task_id, chunk, handle, first))
                else:
                    # tail: whole pages past the chunk grid, read buffered
                    nbytes = self._tail_pages * PAGE_SIZE
                    self.source.read_buffered(
                        self.n_chunks * self.chunk_size, chunk.view[:nbytes])
                    ring.append((0, chunk, handle, first))
            except BaseException:
                if handle is not None:
                    self.session.unmap_buffer(handle)
                chunk.release()
                raise
            return True

        try:
            for _ in range(self.async_depth):
                if not submit_next():
                    break
            while ring:
                task_id, chunk, handle, first = ring.pop(0)
                if task_id:
                    result = self.session.memcpy_wait(task_id)
                    n_pages = self.pages_per_chunk
                    nr_ssd, nr_wb = result.nr_ssd2dev, result.nr_ram2dev
                    ids = result.chunk_ids
                else:
                    n_pages = self._tail_pages
                    nr_ssd, nr_wb, ids = 0, 1, [first]
                # recycle the previous batch BEFORE the next submission:
                # the pool holds ring + current + previous at steady state
                if auto_recycle and prev is not None:
                    self._recycle(prev)
                    prev = None
                submit_next()
                pages = np.frombuffer(chunk.view[:n_pages * PAGE_SIZE],
                                      dtype=np.uint8).reshape(n_pages,
                                                              PAGE_SIZE)
                batch = Batch(pages=pages, chunk_ids=ids,
                              first_page=first * self.pages_per_chunk,
                              nr_ssd=nr_ssd, nr_wb=nr_wb,
                              _chunk=chunk, _handle=handle)
                if auto_recycle:
                    prev = batch
                yield batch
        finally:
            if prev is not None:
                self._recycle(prev)
            # wait out in-flight reads before their chunks go back
            for task_id, chunk, handle, _first in ring:
                if task_id:
                    try:
                        self.session.memcpy_wait(task_id, timeout=30.0)
                    except StromError:
                        pass
                self.session.unmap_buffer(handle)
                chunk.release()

    def _recycle(self, batch: Batch) -> None:
        self.session.unmap_buffer(batch._handle)
        batch._chunk.release()

    def recycle(self, batch: Batch) -> None:
        """Return a consumer-held batch's chunk to the pool."""
        self._recycle(batch)

    # -- device-filter pipeline --------------------------------------------
    def scan_filter(self, filter_fn: Callable, *, device=None,
                    combine: Optional[Callable] = None) -> dict:
        """Copy every batch to *device* (default ``cuda:0``; ``"cpu"`` for
        the host) and fold ``filter_fn(pages_u8) -> dict`` over it.
        Results are summed per leaf (or folded with *combine*) and
        returned as numpy values.

        On CUDA each batch's host→device copy runs on a copy stream and
        records an event; ``filter_fn`` runs on the current stream after
        waiting on that event.  Fences are deferred (adaptive depth,
        :class:`..hbm.staging.AdaptiveH2DDepth`): a batch's pool chunk is
        recycled only once its copy's event has completed, and the fence on
        batch *k* waits until the pipeline is ``depth`` batches deep.  On
        the CPU each batch is cloned off its pool chunk before the filter
        sees it — the chunk is refilled while results may still be held."""
        from ..hbm.staging import (AdaptiveH2DDepth, bounded_fence,
                                   h2d_meter, resolve_device)
        dev = resolve_device(device)
        cuda = dev.type == "cuda"
        stream = torch.cuda.Stream(device=dev) if cuda else None
        if cuda:
            self.pool.buffer.pin_cuda()
        acc = None
        depth_cap = max(1, min(int(config.get("h2d_depth_max")),
                               self.pool.n_chunks - self.async_depth - 1))
        ad = AdaptiveH2DDepth(depth_cap)
        self.last_h2d_depth = ad.depth
        self.last_batches = 0
        stats.gauge_max("h2d_depth_reached", ad.depth)
        inflight: List[tuple] = []   # (dev_pages, event|None, batch)

        def to_device(batch: Batch):
            host = torch.from_numpy(batch.pages)
            if not cuda:
                return host.clone(), None
            if not host.is_pinned():
                raise StromError(_errno.EFAULT, "scan chunk is not pinned: "
                                                "the copy would run "
                                                "synchronously")
            cur = torch.cuda.current_stream(dev)
            dev_pages = torch.empty(host.shape, dtype=torch.uint8,
                                    device=dev)
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                dev_pages.copy_(host, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            dev_pages.record_stream(stream)
            return dev_pages, ev

        def retire_oldest() -> None:
            nonlocal acc
            dev_pages, ev, b = inflight.pop(0)
            t0 = time.monotonic_ns()
            if ev is not None:
                bounded_fence(ev, "scan-h2d")
                torch.cuda.current_stream(dev).wait_event(ev)
            blocked_ns = time.monotonic_ns() - t0
            h2d_meter.note(int(dev_pages.numel()), blocked_ns)
            self.recycle(b)
            acc = fold_results(acc, filter_fn(dev_pages), combine)
            stats.add("nr_kernel_dispatch")
            self.last_batches += 1
            if ad.observe(blocked_ns) > self.last_h2d_depth:
                self.last_h2d_depth = ad.depth
                stats.gauge_max("h2d_depth_reached", ad.depth)

        with ResourceOwner("scan_filter") as owner:
            gen = self.batches(owner=owner, auto_recycle=False)
            try:
                for batch in gen:
                    inflight.append((*to_device(batch), batch))
                    # release below the depth budget BEFORE drawing the
                    # next batch, or the pool alloc deadlocks
                    while len(inflight) >= ad.depth:
                        retire_oldest()
                while inflight:
                    retire_oldest()
            finally:
                # consumer-held batches: fence + recycle before the ring
                # drain, so no chunk returns while a copy still reads it
                for _dev_pages, ev, b in inflight:
                    if ev is not None:
                        try:
                            bounded_fence(ev, "scan-teardown")
                        except StromError:
                            pass
                    self.recycle(b)
                inflight.clear()
                gen.close()
        return {} if acc is None else _to_numpy(acc)

    def close(self) -> None:
        if self._own_pool:
            self.pool.close()
        if self._own_session:
            self.session.close()
        if self._own_source:
            self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
