"""SSD→pinned-host→device staging pipeline.

The reference's headline capability is peer-to-peer DMA: the SSD writes
straight into GPU BAR1 (`kmod/nvme_strom.c:1518-1589`).  This package keeps
the JAX package's two-hop shape instead: O_DIRECT reads into pinned
(``cudaHostRegister``'d) host buffers, overlapped with asynchronous
host→device copies on a dedicated copy stream, so the extra hop hides
behind the SSD reads.

The pipeline keeps ``staging_buffers`` (default 3) pinned buffers in
flight: while buffer *k* receives SSD reads, buffer *k−1*'s copy to the
device is in flight.  Each slot's copy records a ``torch.cuda.Event`` on
the copy stream, and the slot is refilled only after that event is fenced
(bounded, :mod:`.backend`) — the correctness fence the reference got from
DMA completion interrupts.

Device writes land in place: ``dest[off:off+n].copy_(src,
non_blocking=True)`` into the preallocated destination tensor.  Offsets are
64-bit byte offsets, so no destination is too large to address (the JAX
package's int32 element ceiling and its EOVERFLOW do not exist here).  On
the CPU the copy is synchronous and owns its bytes, so the reused slot is
never aliased.
"""

from __future__ import annotations

import errno as _errno
from typing import List, Optional, Sequence

import torch

from ..api import MemCopyResult, StromError
from ..config import config
from ..engine import Session, Source
from ..log import pr_warn
from ..stats import stats
from .backend import default_device, resolve_device
from .registry import HbmRegistry, LandingBuffer, registry as global_registry

__all__ = ["StagingPipeline", "load_file_to_device", "AdaptiveH2DDepth",
           "plan_landing", "H2DRateMeter", "h2d_meter", "bounded_fence",
           "default_device", "resolve_device"]


class AdaptiveH2DDepth:
    """Depth controller for deferred-fence H2D pipelining (scan executor).

    Grow by one whenever the consumer actually blocked on a transfer fence;
    decay by one after ``decay_after`` consecutive fence-free retirements,
    so a deepened pipeline releases its pool chunks once transfers keep up.
    ``observe(blocked_ns)`` after each fence; read ``depth`` before each
    dispatch."""

    BLOCK_NS = 200_000    # a fence wait above 0.2ms counts as blocking

    def __init__(self, cap: int, *, start: int = 2, floor: int = 2,
                 decay_after: int = 4):
        self.cap = max(1, int(cap))
        self.floor = min(max(1, floor), self.cap)
        self.depth = min(max(1, start), self.cap)
        self.decay_after = max(1, decay_after)
        self._streak = 0

    def observe(self, blocked_ns: int) -> int:
        if blocked_ns > self.BLOCK_NS:
            self._streak = 0
            if self.depth < self.cap:
                self.depth += 1
        else:
            self._streak += 1
            if self._streak >= self.decay_after and self.depth > self.floor:
                self.depth -= 1
                self._streak = 0
        return self.depth


class H2DRateMeter:
    """EWMA of the host→device rate, fed only by transfer-bound (blocking)
    fence waits: a fence that returned at once says nothing about the
    link."""

    _ALPHA = 0.2

    def __init__(self) -> None:
        self.rate_gbps = 0.0
        self.samples = 0

    def note(self, nbytes: int, blocked_ns: int) -> None:
        if nbytes <= 0 or blocked_ns <= AdaptiveH2DDepth.BLOCK_NS:
            return
        gbps = nbytes / blocked_ns * (1e9 / (1 << 30))
        self.rate_gbps = gbps if self.samples == 0 else \
            (1 - self._ALPHA) * self.rate_gbps + self._ALPHA * gbps
        self.samples += 1

    def observed_gbps(self) -> Optional[float]:
        return self.rate_gbps if self.samples else None


h2d_meter = H2DRateMeter()


def bounded_fence(event, what: str = "h2d"):
    """Wait on a CUDA event through the backend monitor (bounded by config
    ``backend_fence_timeout``; a miss latches loss and raises ENODEV)."""
    from .backend import monitor
    return monitor.fence(event, what=what)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def plan_landing(hbm, chunk_ids: Sequence[int], chunk_size: int,
                 dest_offset: int, device_dtype, tail_len: int):
    """Landing route of one pipeline command: ``(mode, reason)``.

    *mode* is ``"direct"`` or ``"staged"``; *reason* names why a command
    the configuration allowed to land direct could not (``"alignment"`` |
    ``"dtype"`` | ``"backend"``), else None.  Direct landing replaces the
    destination with a tensor aliasing the landed host buffer, so the
    command must cover the destination exactly, the geometry must be whole
    elements of the destination dtype, and the destination must live on the
    CPU: a CUDA destination pays a host→device copy either way, and the
    staged ring overlaps that copy with the SSD reads."""
    if config.get("landing") == "staged":
        return "staged", None
    t = hbm.tensor
    if t.device.type != "cpu":
        return "staged", "backend"
    itemsize = _itemsize(device_dtype)
    if (t.dim() != 1 or t.dtype != device_dtype
            or chunk_size % itemsize or tail_len % itemsize):
        return "staged", "dtype"
    total = (len(chunk_ids) - 1) * chunk_size + tail_len
    if dest_offset != 0 or total != hbm.nbytes:
        return "staged", "alignment"
    return "direct", None


class StagingPipeline:
    """Overlapped SSD→device chunk mover (MEMCPY_SSD2GPU analog)."""

    def __init__(self, session: Session, *, n_buffers: Optional[int] = None,
                 staging_bytes: Optional[int] = None,
                 hbm_registry: Optional[HbmRegistry] = None):
        self.session = session
        self.n_buffers = n_buffers or config.get("staging_buffers")
        self.staging_bytes = staging_bytes or config.get("chunk_size")
        self.registry = hbm_registry or global_registry
        self._bufs = [session.alloc_dma_buffer(self.staging_bytes)
                      for _ in range(self.n_buffers)]
        # one uint8 tensor per slot, aliasing the pinned mapping
        self._host = [torch.frombuffer(buf.view(), dtype=torch.uint8)
                      for _, buf in self._bufs]
        self._barriers: List[Optional[torch.cuda.Event]] = \
            [None] * self.n_buffers
        self._copy_stream: Optional[torch.cuda.Stream] = None
        #: deepest number of slots with an H2D copy in flight
        self.depth_reached = 0

    def _stream_for(self, dev: torch.device) -> torch.cuda.Stream:
        if self._copy_stream is None or self._copy_stream.device != dev:
            self._copy_stream = torch.cuda.Stream(device=dev)
        return self._copy_stream

    def memcpy_ssd2dev(self, source: Source, hbm_handle: int,
                       chunk_ids: Sequence[int], chunk_size: int, *,
                       dest_offset: int = 0,
                       device_dtype: torch.dtype = torch.uint8
                       ) -> MemCopyResult:
        """Move ``chunk_ids`` (units of ``chunk_size`` bytes of *source*)
        into the registered destination, starting at byte ``dest_offset``.
        Entry *i* of the result's ``chunk_ids`` names the chunk at device
        bytes ``dest_offset + i*chunk_size``.  Every chunk must be whole
        except a partial file tail in the last position."""
        if chunk_size > self.staging_bytes:
            raise StromError(_errno.EINVAL, f"chunk_size {chunk_size} exceeds "
                                            f"staging buffer "
                                            f"{self.staging_bytes}")
        if not chunk_ids:
            raise StromError(_errno.EINVAL, "no chunks")
        tail_len = chunk_size
        last = len(chunk_ids) - 1
        for pos, cid in enumerate(chunk_ids):
            if cid * chunk_size >= source.size:
                raise StromError(_errno.EINVAL, f"chunk {cid} beyond EOF "
                                                f"(source size {source.size})")
            if (cid + 1) * chunk_size > source.size:
                if pos != last:
                    raise StromError(_errno.EINVAL,
                                     f"chunk {cid} is partial (source size "
                                     f"{source.size}) but not last; only the "
                                     f"final slot may be partial")
                tail_len = source.size - cid * chunk_size
        hbm = self.registry.acquire(hbm_handle)
        try:
            itemsize = _itemsize(device_dtype)
            if dest_offset % itemsize:
                raise StromError(_errno.EINVAL,
                                 "dest_offset not aligned to device dtype")
            if tail_len % itemsize:
                raise StromError(_errno.EINVAL,
                                 f"partial tail ({tail_len} bytes) not a "
                                 f"multiple of device dtype itemsize "
                                 f"{itemsize}")
            mode, why = plan_landing(hbm, chunk_ids, chunk_size, dest_offset,
                                     device_dtype, tail_len)
            if mode == "direct":
                return self._memcpy_direct(source, hbm, list(chunk_ids),
                                           chunk_size, tail_len, device_dtype)
            if why is not None and config.get("landing") == "direct":
                pr_warn("landing=direct but command ineligible (%s); "
                        "falling back to the staged ring", why)
            total_bytes = dest_offset + (len(chunk_ids) - 1) * chunk_size \
                + tail_len
            if total_bytes > hbm.nbytes:
                raise StromError(_errno.ERANGE, f"device buffer too small: "
                                                f"need {total_bytes} > "
                                                f"{hbm.nbytes}")
            return self._memcpy_staged(source, hbm, list(chunk_ids),
                                       chunk_size, tail_len, dest_offset)
        finally:
            self.registry.release(hbm)

    def _memcpy_staged(self, source: Source, hbm, chunk_ids: List[int],
                       chunk_size: int, tail_len: int,
                       dest_offset: int) -> MemCopyResult:
        dest = hbm.tensor
        if not dest.is_contiguous():
            raise StromError(_errno.EINVAL,
                             "destination tensor must be contiguous")
        dest_bytes = dest.view(-1).view(torch.uint8)
        dev = dest.device
        cuda = dev.type == "cuda"
        stream = None
        if cuda:
            stream = self._stream_for(dev)
            # the destination was allocated (and zeroed) on the current
            # stream; the copy stream must not overtake that
            stream.wait_stream(torch.cuda.current_stream(dev))
            dest.record_stream(stream)
            for _, buf in self._bufs:
                buf.pin_cuda()
        per_batch = self.staging_bytes // chunk_size
        full = chunk_ids if tail_len == chunk_size else chunk_ids[:-1]
        batches = [full[i:i + per_batch]
                   for i in range(0, len(full), per_batch)]
        if tail_len != chunk_size:
            batches.append([chunk_ids[-1]])   # the partial-tail slot
        inflight = []   # (bufidx, task_id, batch, byte_start, nbytes, pos)
        out_ids: List[Optional[int]] = [None] * len(chunk_ids)
        nr_ssd = nr_ram = 0

        def retire(slot) -> None:
            nonlocal nr_ssd, nr_ram
            bufidx, task_id, batch, start, nbytes, pos = slot
            res = self.session.memcpy_wait(task_id)
            out_ids[pos:pos + len(batch)] = res.chunk_ids
            nr_ssd += res.nr_ssd2dev
            nr_ram += res.nr_ram2dev
            host = self._host[bufidx][:nbytes]
            part = dest_bytes[start:start + nbytes]
            if not cuda:
                part.copy_(host)
                return
            if not host.is_pinned():
                raise StromError(_errno.EFAULT, "staging slot is not pinned: "
                                                "the copy would run "
                                                "synchronously")
            with torch.cuda.stream(stream):
                part.copy_(host, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            self._barriers[bufidx] = ev
            depth = sum(b is not None for b in self._barriers)
            if depth > self.depth_reached:
                self.depth_reached = depth
                stats.gauge_max("h2d_depth_reached", depth)

        start, pos = dest_offset, 0
        try:
            for bi, batch in enumerate(batches):
                if len(inflight) >= self.n_buffers:
                    retire(inflight.pop(0))
                used = {s[0] for s in inflight}
                bufidx = next(i for i in range(self.n_buffers)
                              if i not in used)
                # the copy that last read this slot must be done before
                # the SSD overwrites it; a dead device fails the command
                if self._barriers[bufidx] is not None:
                    bounded_fence(self._barriers[bufidx], "staging-reuse")
                    self._barriers[bufidx] = None
                nbytes = len(batch) * chunk_size
                if tail_len != chunk_size and bi == len(batches) - 1:
                    nbytes = tail_len
                handle, _ = self._bufs[bufidx]
                task = self.session.memcpy_ssd2ram(source, handle, batch,
                                                   chunk_size)
                inflight.append((bufidx, task.dma_task_id, batch, start,
                                 nbytes, pos))
                start += nbytes
                pos += len(batch)
            while inflight:
                retire(inflight.pop(0))
        except BaseException:
            # reap in-flight SSD tasks, bounded, then surface the first
            # error (kmod/nvme_strom.c:770-776)
            for slot in inflight:
                try:
                    self.session.memcpy_wait(slot[1], timeout=5.0)
                except StromError:
                    pass
            raise
        if cuda:
            # consumers on the current stream see the landed bytes
            torch.cuda.current_stream(dev).wait_stream(stream)
        return MemCopyResult(dma_task_id=0, nr_chunks=len(out_ids),
                             nr_ssd2dev=nr_ssd, nr_ram2dev=nr_ram,
                             chunk_ids=out_ids, landing="staged")

    def _memcpy_direct(self, source: Source, hbm, chunk_ids: List[int],
                       chunk_size: int, tail_len: int,
                       device_dtype: torch.dtype) -> MemCopyResult:
        """Zero-copy landing (CPU): the engine reads straight into an owned
        :class:`LandingBuffer` and the destination becomes a tensor
        aliasing it.  Full chunks ride one engine command; a partial tail
        rides its own command pinned to the final slot."""
        n = len(chunk_ids)
        landing = LandingBuffer(self.session, (n - 1) * chunk_size + tail_len)
        adopted = False
        tasks: List[int] = []
        try:
            full = chunk_ids if tail_len == chunk_size else chunk_ids[:-1]
            if full:
                tasks.append(self.session.memcpy_ssd2ram(
                    source, landing.handle, full, chunk_size).dma_task_id)
            if tail_len != chunk_size:
                tasks.append(self.session.memcpy_ssd2ram(
                    source, landing.handle, [chunk_ids[-1]], chunk_size,
                    dest_offset=(n - 1) * chunk_size).dma_task_id)
            out_ids: List[int] = []
            nr_ssd = nr_ram = 0
            first_err: Optional[StromError] = None
            for tid in tasks:
                try:
                    res = self.session.memcpy_wait(tid)
                except StromError as e:
                    first_err = first_err or e
                    continue
                out_ids.extend(res.chunk_ids)
                nr_ssd += res.nr_ssd2dev
                nr_ram += res.nr_ram2dev
            tasks.clear()
            if first_err is not None:
                raise first_err
            hbm.adopt(landing.adopt_tensor(device_dtype), landing)
            adopted = True
            return MemCopyResult(dma_task_id=0, nr_chunks=n,
                                 nr_ssd2dev=nr_ssd, nr_ram2dev=nr_ram,
                                 chunk_ids=out_ids, landing="direct")
        finally:
            for tid in tasks:       # submit failed midway: reap, bounded
                try:
                    self.session.memcpy_wait(tid, timeout=5.0)
                except StromError:
                    pass
            if not adopted:
                landing.release()

    def drain(self) -> None:
        """Block until every slot's outstanding copy has completed."""
        for i, ev in enumerate(self._barriers):
            if ev is not None:
                bounded_fence(ev, "staging-drain")
                self._barriers[i] = None

    def close(self) -> None:
        for i, ev in enumerate(self._barriers):
            if ev is not None:
                try:
                    bounded_fence(ev, "staging-close")
                except StromError:
                    pass    # a latched loss fails the rest at once anyway
                self._barriers[i] = None
        self._host.clear()
        for handle, buf in self._bufs:
            try:
                self.session.unmap_buffer(handle)
            except StromError:
                pass
            buf.close()
        self._bufs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_file_to_device(source: Source, *, chunk_size: Optional[int] = None,
                        session: Optional[Session] = None, device=None,
                        dtype: torch.dtype = torch.uint8,
                        staging_bytes: Optional[int] = None,
                        hbm_registry: Optional[HbmRegistry] = None
                        ) -> torch.Tensor:
    """One-call SSD→device load of a whole source: allocates a destination
    of the source's size in *dtype* on *device* (default ``cuda:0``;
    ``device="cpu"`` for the host), streams every chunk through the staging
    pipeline and returns the tensor once the bytes have landed."""
    dev = resolve_device(device)
    chunk_size = chunk_size or min(config.get("chunk_size"), 1 << 20)
    reg = hbm_registry or global_registry
    itemsize = _itemsize(dtype)
    if source.size % itemsize:
        raise StromError(_errno.EINVAL, f"source size {source.size} not a "
                                        f"multiple of dtype itemsize "
                                        f"{itemsize}")
    own_session = session is None
    sess = session or Session(device=dev)
    try:
        handle = reg.map_device_memory(source.size // itemsize, dtype=dtype,
                                       device=dev)
        try:
            n_chunks = (source.size + chunk_size - 1) // chunk_size
            with StagingPipeline(sess, staging_bytes=staging_bytes,
                                 hbm_registry=reg) as pipe:
                pipe.memcpy_ssd2dev(source, handle, list(range(n_chunks)),
                                    chunk_size, device_dtype=dtype)
            out = reg.get(handle).tensor
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                bounded_fence(ev, "load")
            return out
        finally:
            reg.unmap(handle)
    finally:
        if own_session:
            sess.close()
