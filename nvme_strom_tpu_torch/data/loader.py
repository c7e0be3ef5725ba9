"""DeviceLoader: shuffled, double-buffered, direct-to-device record batches.

The training-input generalisation of the benchmark's segment streaming
(`utils/ssd2gpu_test.c:282-375`), the JAX package's ``DeviceLoader`` over
torch tensors: each *batch* claims a set of engine chunks, and because the
engine's command vocabulary takes arbitrary ``chunk_ids``, a shuffled
epoch is a permuted id list riding the same merge-planned async read path.
Chunk-granular shuffling (shuffle buckets = chunks) with a per-epoch
reshuffle; epoch *e* of seed *s* is ``np.random.default_rng(s + e)``'s
permutation, so a seed gives the JAX package's batches bit for bit.

Overlap: while the consumer holds batch *b*, the next ``prefetch - 1``
batches' SSD reads are in flight into the other pinned buffers of the
ring (default 2 = double buffering).  A batch crosses to the device as
the pinned, stride-padded bytes (an H2D from pinned memory is an
asynchronous DMA; ``RecordDataset.decode`` would copy into pageable
memory first), and the padding is stripped on the device.  Each buffer's
reuse is fenced on the CUDA event of the copy that last read it, through
the bounded fence: a wedged backend fails the epoch with ENODEV.
"""

from __future__ import annotations

import errno as _errno
from collections import deque
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..api import StromError
from ..config import config
from ..engine import Session, Source, open_source, reorder_chunks
from ..hbm.staging import bounded_fence, resolve_device, safe_device_put
from .dtypes import torch_dtype
from .records import RecordDataset

__all__ = ["DeviceLoader"]


class DeviceLoader:
    """Iterate device-resident record batches from a :class:`RecordDataset`.

    Parameters
    ----------
    dataset : RecordDataset (or path string)
    batch_records : records per yielded batch; must be a whole number of
        engine chunks (``batch_records % records_per_chunk == 0``)
    shuffle : None for file order, or an int seed for per-epoch chunk
        shuffling (epoch *e* uses ``seed + e``)
    mesh : optional :class:`..parallel.mesh.RingMesh` — each batch is a
        list of per-member tensors, member ``(s, d)`` holding rows
        ``[d·b/dp, (d+1)·b/dp)`` (the sp lanes replicate the dp split,
        one tensor where they share a device); otherwise ``device``
        (default ``cuda:0``; ``"cpu"`` for the host) gets whole batches
    prefetch : pinned batch buffers / batches kept in flight (default 2 =
        double buffering)
    drop_remainder : trailing records that do not fill a batch (or a chunk)
        are skipped, as with every fixed-geometry input pipeline
    """

    def __init__(self, dataset, batch_records: int, *,
                 shuffle: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 mesh=None, device=None,
                 session: Optional[Session] = None,
                 source: Optional[Source] = None,
                 prefetch: int = 2,
                 drop_remainder: bool = True):
        if isinstance(dataset, str):
            dataset = RecordDataset(dataset)
        self.ds = dataset
        if not drop_remainder:
            raise StromError(_errno.EINVAL,
                             "drop_remainder=False is not supported: batches "
                             "are fixed-geometry device tensors")
        if chunk_size is None:
            # largest chunk that (a) holds whole records, (b) divides the
            # batch evenly, (c) stays within the configured chunk budget —
            # so any batch_records geometry works out of the box
            cap = max(self.ds.stride, min(config.get("chunk_size"), 1 << 20))
            p = batch_records & -batch_records if batch_records > 0 else 1
            chunk_size = self.ds.stride * p
            while chunk_size > cap and p > 1:
                p //= 2
                chunk_size = self.ds.stride * p
        self.chunk_size = chunk_size
        self.rpc = self.ds.records_per_chunk(chunk_size)
        if batch_records <= 0 or batch_records % self.rpc:
            raise StromError(
                _errno.EINVAL,
                f"batch_records {batch_records} must be a positive multiple "
                f"of records-per-chunk {self.rpc} (chunk {chunk_size}, "
                f"stride {self.ds.stride})")
        self.batch_records = batch_records
        self.chunks_per_batch = batch_records // self.rpc
        file_bytes = self.ds.count * self.ds.stride
        self.n_chunks = file_bytes // chunk_size
        self.batches_per_epoch = self.n_chunks // self.chunks_per_batch
        self.shuffle = shuffle
        self.mesh = mesh
        if mesh is not None and batch_records % mesh.dp:
            raise StromError(_errno.EINVAL,
                             f"batch_records {batch_records} not divisible "
                             f"by the mesh's {mesh.dp} dp shards")
        if prefetch < 1:
            raise StromError(_errno.EINVAL, "prefetch must be >= 1")
        # where batches go, resolved before anything is allocated: with no
        # card the default cuda:0 is ENODEV, never the CPU
        self.devices: List[torch.device] = (
            list(mesh.devices) if mesh is not None
            else [resolve_device(device)])
        self._dtype = torch_dtype(self.ds.dtype)
        self._streams = {}
        self._own_source = source is None
        self.source = source or open_source(dataset.path)
        self._own_session = session is None
        self.session = session or Session(device=self.devices[0])
        # prefetch = number of pinned batch buffers = batches in flight
        self.prefetch = prefetch
        nbytes = self.chunks_per_batch * chunk_size
        self._bufs = [self.session.alloc_dma_buffer(nbytes)
                      for _ in range(prefetch)]
        if self.devices[0].type == "cuda":
            for _, buf in self._bufs:
                buf.pin_cuda()
        self._fence: List[list] = [[] for _ in range(prefetch)]
        self._epoch = 0
        self._closed = False

    # -- iteration -----------------------------------------------------------
    def _stream(self, dev: torch.device):
        if dev.type != "cuda":
            return None
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def _epoch_ids(self, epoch: int) -> np.ndarray:
        ids = np.arange(self.n_chunks, dtype=np.int64)
        if self.shuffle is not None:
            rng = np.random.default_rng(self.shuffle + epoch)
            rng.shuffle(ids)
        return ids

    def _submit(self, ring: int, ids: Sequence[int]):
        # bounded: a dead backend fails the epoch with ENODEV instead of
        # hanging the prefetch rotation
        for f in self._fence[ring]:
            bounded_fence(f, "loader-h2d")
        self._fence[ring] = []
        handle, _ = self._bufs[ring]
        # plain ints: np.int64 ids would reach ctypes
        req = [int(c) for c in ids]
        return req, self.session.memcpy_ssd2ram(self.source, handle, req,
                                                self.chunk_size)

    def _strip(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """Stride-padded uint8 rows -> ``(n, *shape)`` records, on the
        tensor's device (a view when the stride has no padding)."""
        ds = self.ds
        if ds.stride != ds.record_bytes:
            t = t.view(n, ds.stride)[:, :ds.record_bytes].contiguous()
        return t.view(self._dtype).reshape((n,) + tuple(ds.shape))

    def _collect(self, ring: int, req, res):
        self.session.memcpy_wait(res.dma_task_id)
        _, buf = self._bufs[ring]
        nbytes = self.chunks_per_batch * self.chunk_size
        raw = np.frombuffer(buf.view()[:nbytes], np.uint8)
        # restore the *requested* order: a seeded shuffle must not depend
        # on the order the engine completed the chunks in
        raw = reorder_chunks(raw, self.chunk_size, res.chunk_ids, req)
        ndp = self.mesh.dp if self.mesh is not None else 1
        per = self.batch_records // ndp
        span = per * self.ds.stride
        out, placed = [], {}
        for i, dev in enumerate(self.devices):
            k = i % ndp
            if (k, dev) not in placed:
                t, fence = safe_device_put(raw[k * span:(k + 1) * span], dev,
                                           stream=self._stream(dev))
                # the pinned buffer is refilled only after this copy is done
                self._fence[ring].append(fence)
                placed[k, dev] = self._strip(t, per)
            out.append(placed[k, dev])
        return out if self.mesh is not None else out[0]

    def _reap(self, pending) -> None:
        # an abandoned epoch (break / exception) must reap prefetched
        # tasks: done/failed tasks are retained in the session table until
        # waited (engine error-retention contract)
        for item in pending:
            try:
                self.session.memcpy_wait(item[2].dma_task_id, timeout=30.0)
            except StromError:
                pass

    def epoch(self, epoch: Optional[int] = None) -> Iterator:
        """Yield one epoch of device batches (len == batches_per_epoch)."""
        if self._closed:
            raise StromError(_errno.EBADF, "loader closed")
        e = self._epoch if epoch is None else epoch
        if epoch is None:
            self._epoch += 1
        ids = self._epoch_ids(e)
        k = self.chunks_per_batch
        n = self.batches_per_epoch
        if n == 0:
            return
        pending = deque()
        next_b = 0

        def submit_batch(b):
            ring = b % self.prefetch
            return (ring, *self._submit(ring, ids[b * k:(b + 1) * k]))

        try:
            while next_b < n and len(pending) < self.prefetch:
                pending.append(submit_batch(next_b))
                next_b += 1
            while pending:
                arr = self._collect(*pending.popleft())
                if next_b < n:
                    # refill before yielding: if the consumer abandons the
                    # generator mid-yield, the finally below reaps it
                    pending.append(submit_batch(next_b))
                    next_b += 1
                yield arr
        finally:
            self._reap(pending)

    def epochs(self, n: Optional[int] = None) -> Iterator:
        """Yield device batches for *n* epochs (forever when ``None``) with
        the prefetch pipeline held full ACROSS epoch boundaries: the first
        batches of epoch *e+1* are in flight while the tail of epoch *e* is
        consumed, so the SSD queue never drains at the boundary."""
        if self._closed:
            raise StromError(_errno.EBADF, "loader closed")
        k = self.chunks_per_batch
        if self.batches_per_epoch == 0:
            return

        def batch_ids():
            done = 0
            while n is None or done < n:
                e = self._epoch
                self._epoch += 1
                ids = self._epoch_ids(e)
                for b in range(self.batches_per_epoch):
                    yield ids[b * k:(b + 1) * k]
                done += 1

        pending = deque()
        g = 0  # global batch index: ring rotation ignores epoch boundaries
        try:
            for bid in batch_ids():
                if len(pending) >= self.prefetch:
                    # the next submit reuses the oldest ring's buffer, so
                    # that batch must land on device first
                    yield self._collect(*pending.popleft())
                ring = g % self.prefetch
                pending.append((ring, *self._submit(ring, bid)))
                g += 1
            while pending:
                yield self._collect(*pending.popleft())
        finally:
            self._reap(pending)

    def __iter__(self):
        return self.epoch()

    def __len__(self) -> int:
        return self.batches_per_epoch

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fences in self._fence:
            for f in fences:
                try:
                    bounded_fence(f, "loader-drain")
                except StromError:
                    # keep draining the other buffers: a latched loss
                    # makes every later fence fail at once anyway
                    continue
        self._fence = [[] for _ in range(self.prefetch)]
        for handle, buf in self._bufs:
            try:
                self.session.unmap_buffer(handle)
            except StromError:
                pass
            buf.close()
        self._bufs = []
        if self._own_session:
            self.session.close()
        if self._own_source:
            self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
