"""Sharded direct loading: stripe a source across the ring's members.

A reduced copy of the JAX package's ``parallel/stream.py``.  The RAID-0
fan-out analog over the ring: where the reference stripes one stream
across NVMe members in-kernel (`kmod/nvme_strom.c:823-910`), here the
*destination* is striped — member *i* owns a disjoint page range, read
through the engine's direct path into pinned buffers and landed on its
device.  A sharded array is a list of per-member tensors.  On an ``(sp,
dp)`` mesh the pages split over dp and each dp shard is read once and
replicated over the sp lanes (:meth:`.mesh.RingMesh.replicate`), the
reference's ``P("dp", None)``.

Landing on a card uses the port's own mechanism (:mod:`..hbm.staging`):
``cudaHostRegister``'d engine buffers, a copy stream per device, and
``torch.cuda.Event`` fences waited through the bounded backend fence.

Over ranks (:mod:`.dist`) a process reads only the dp shards its own
members hold — each host reads its own rows — and the members of other
ranks come back as None.
"""

from __future__ import annotations

import errno as _errno
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import StromError
from ..engine import Session, Source, reorder_chunks
from ..hbm.staging import bounded_fence
from ..scan.executor import _to_numpy, fold_results
from ..scan.heap import PAGE_SIZE
from ..stats import stats
from ..trace import recorder as _trace
from .mesh import RingMesh

__all__ = ["load_pages_sharded", "ShardedBatchStream",
           "distributed_scan_filter"]


def _cuda_session(mesh: RingMesh) -> Session:
    return Session(device=mesh.home() if mesh.device_type == "cuda"
                   else None)


def load_pages_sharded(source: Source, mesh: RingMesh, *,
                       session: Optional[Session] = None
                       ) -> List[torch.Tensor]:
    """Direct-load a page-formatted source into per-member ``(n_pages /
    dp, PAGE_SIZE)`` uint8 shards: member ``(s, d)`` holds rows ``[d * r,
    (d + 1) * r)``.  ``n_pages`` must divide evenly by dp.  Only this
    process's members' rows are read; another rank's member is None."""
    n = mesh.dp
    if source.size % PAGE_SIZE:
        raise StromError(_errno.EINVAL, f"source size {source.size} not "
                                        f"page-aligned")
    n_pages = source.size // PAGE_SIZE
    if n_pages % n:
        raise StromError(_errno.EINVAL, f"{n_pages} pages not divisible by "
                                        f"{n} dp shards; pad the source")
    rows = n_pages // n
    own = session is None
    sess = session or _cuda_session(mesh)
    shards: List[Optional[torch.Tensor]] = [None] * n
    try:
        for i in mesh.local_columns():
            dev = mesh.column_device(i)
            nbytes = rows * PAGE_SIZE
            handle, buf = sess.alloc_dma_buffer(nbytes)
            try:
                want = list(range(i * rows, (i + 1) * rows))
                res = sess.memcpy_ssd2ram(source, handle, want, PAGE_SIZE)
                sess.memcpy_wait(res.dma_task_id)
                host = reorder_chunks(
                    np.frombuffer(buf.view()[:nbytes], np.uint8), PAGE_SIZE,
                    res.chunk_ids, want).reshape(rows, PAGE_SIZE)
                # an owned copy on the member's device, made before the
                # pinned buffer unmaps
                shards[i] = torch.from_numpy(host).to(dev, copy=True)
            finally:
                sess.unmap_buffer(handle)
                buf.close()
        return mesh.replicate(shards)
    finally:
        if own:
            sess.close()


class ShardedBatchStream:
    """Stream fixed-size page batches to the ring with submit-ahead DMA.

    While the consumer works on batch *b*, batch *b+1*'s SSD reads are in
    flight into a second set of pinned buffers (one double-buffered pair
    per member).  A buffer is refilled only after the device copy that
    last read it is fenced.  Shards complete independently, so each
    member's copy starts as soon as its own reads land (completion fan-in),
    and each shard's submit→completion wait goes to its own histogram
    (``stats.shard_wait``).

    Yields ``(first_page, shards)``: a :class:`.mesh.Shards` of one
    ``(batch_pages / dp, PAGE_SIZE)`` uint8 tensor per member, on its
    device, member ``(s, d)`` holding dp shard *d* (read once, the lanes
    sharing it; only the shards of this process's members are read, and
    another rank's member is None).  ``batch_pages`` must divide by dp; a
    final partial batch is not yielded (callers scan tails themselves)."""

    def __init__(self, source: Source, mesh: RingMesh, *, batch_pages: int,
                 session: Optional[Session] = None):
        n = mesh.dp
        if batch_pages <= 0 or batch_pages % n:
            raise StromError(_errno.EINVAL, f"batch_pages {batch_pages} must "
                                            f"divide by {n} dp shards")
        if source.size % PAGE_SIZE:
            raise StromError(_errno.EINVAL, "source size not page-aligned")
        self.source = source
        self.mesh = mesh
        self.batch_pages = batch_pages
        self.rows = batch_pages // n
        self.n_pages = source.size // PAGE_SIZE
        self.n_batches = self.n_pages // batch_pages
        self._own_session = session is None
        self.session = session or _cuda_session(mesh)
        self._cuda = mesh.device_type == "cuda"
        per_shard = self.rows * PAGE_SIZE
        #: the dp columns this process reads
        self._cols = mesh.local_columns()
        self._bufs = {k: [self.session.alloc_dma_buffer(per_shard)
                          for _ in range(2)] for k in self._cols}
        self._copy: Dict[torch.device, torch.cuda.Stream] = {}
        if self._cuda:
            for pair in self._bufs.values():
                for _, buf in pair:
                    buf.pin_cuda()
            self._copy = {d: torch.cuda.Stream(device=d)
                          for d in dict.fromkeys(mesh.devices[i]
                                                 for i in mesh.local)}
        # per ring slot: the events of the copies that read its buffers
        self._fence: List[List[torch.cuda.Event]] = [[], []]

    def _submit(self, b: int):
        slot = b % 2
        for ev in self._fence[slot]:
            bounded_fence(ev, "mesh-h2d")
        self._fence[slot] = []
        tasks = {}
        base = b * self.batch_pages
        for k in self._cols:
            r0 = base + k * self.rows
            handle, _buf = self._bufs[k][slot]
            res = self.session.memcpy_ssd2ram(
                self.source, handle, list(range(r0, r0 + self.rows)),
                PAGE_SIZE)
            tasks[k] = (res, time.monotonic_ns())
        return slot, tasks

    def _place(self, k: int, slot: int, done) -> torch.Tensor:
        _handle, buf = self._bufs[k][slot]
        host = reorder_chunks(np.frombuffer(buf.view(), np.uint8)
                              [:self.rows * PAGE_SIZE], PAGE_SIZE,
                              done.chunk_ids, sorted(done.chunk_ids)) \
            .reshape(self.rows, PAGE_SIZE)
        dev = self.mesh.column_device(k)
        if not self._cuda:
            return torch.from_numpy(host.copy())
        cur = torch.cuda.current_stream(dev)
        cs = self._copy[dev]
        dst = torch.empty((self.rows, PAGE_SIZE), dtype=torch.uint8,
                          device=dev)
        # the destination was allocated on the current stream; the copy
        # stream must not overtake that
        cs.wait_stream(cur)
        with torch.cuda.stream(cs):
            dst.copy_(torch.from_numpy(host), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(cs)
        dst.record_stream(cs)
        cur.wait_event(ev)
        self._fence[slot].append(ev)
        return dst

    def _collect(self, slot: int, tasks) -> List[Optional[torch.Tensor]]:
        shards: List[Optional[torch.Tensor]] = [None] * self.mesh.dp

        def land(k: int, done) -> None:
            # the batch waits on its slowest shard: one log2-ns histogram
            # a shard, and a flight-recorder span
            t1 = time.monotonic_ns()
            stats.shard_wait(k, t1 - tasks[k][1])
            if _trace.active:
                _trace.span("shard_wait", tasks[k][1], t1,
                            args={"shard": k})
            shards[k] = self._place(k, slot, done)

        remaining = list(tasks)
        while remaining:
            progressed = False
            for k in list(remaining):
                try:
                    done = self.session.memcpy_wait(tasks[k][0].dma_task_id,
                                                    timeout=0.0)
                except StromError as e:
                    if e.errno == _errno.ETIMEDOUT:
                        continue
                    raise
                land(k, done)
                remaining.remove(k)
                progressed = True
            if remaining and not progressed:
                k = remaining.pop(0)
                land(k, self.session.memcpy_wait(tasks[k][0].dma_task_id))
        return shards

    def __iter__(self):
        if self.n_batches == 0:
            return
        pending = self._submit(0)
        for b in range(self.n_batches):
            nxt = self._submit(b + 1) if b + 1 < self.n_batches else None
            shards = self._collect(*pending)
            yield b * self.batch_pages, self.mesh.replicate(shards)
            pending = nxt

    def close(self) -> None:
        for slot in self._fence:
            for ev in slot:
                try:
                    bounded_fence(ev, "mesh-h2d-close")
                except StromError:
                    pass    # a latched loss fails the rest at once anyway
        self._fence = [[], []]
        for pair in self._bufs.values():
            for handle, buf in pair:
                try:
                    self.session.unmap_buffer(handle)
                except StromError:
                    pass
                buf.close()
        self._bufs = {}
        if self._own_session:
            self.session.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def distributed_scan_filter(source: Source, mesh: RingMesh, step, *,
                            batch_pages: int,
                            session: Optional[Session] = None,
                            combine=None) -> dict:
    """Fold ``step(shards) -> dict`` over the source, streamed batch-wise
    through :class:`ShardedBatchStream` (*shards*: one a member, the sp
    lanes replicating the dp shards); results are summed per key (or
    folded with *combine*) and returned as numpy.  Bounded memory: two
    pinned buffers per member plus one resident batch."""
    acc = None
    with ShardedBatchStream(source, mesh, batch_pages=batch_pages,
                            session=session) as stream:
        for _first, shards in stream:
            acc = fold_results(acc, step(shards), combine)
    return {} if acc is None else _to_numpy(acc)
