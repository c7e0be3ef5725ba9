"""Host data-path engine: file check, sources, pinned buffers, task table.

A deliberately reduced copy of the JAX package's engine: the reference's
kernel-module commands (`kmod/nvme_strom.c`) as an in-process engine that
reads with ``O_DIRECT`` ``os.preadv`` on a thread pool (the JAX engine's
``io_backend=python`` lane):

* ``check_file`` — O_DIRECT probe, fs class, logical block size, request
  cap (reference ``ioctl_check_file``, :188-583);
* ``PlainSource`` — one regular file, direct and buffered fds;
* ``StripedSource`` — a read-only RAID-0 set of member files
  (:mod:`.stripe`), and the host-ownership planner of the multi-host
  sharded loader (``plan_shard_ownership``);
* ``DmaBuffer`` — page-aligned anonymous mmap (hugepages when the length
  allows), optionally mlock'd, and registered with the CUDA runtime
  (``cudaHostRegister``) so host→device copies from it run asynchronously;
* ``Session`` — buffer handle table, one task per memcpy command, first
  error latched and retained until a wait reaps it (reference design memo
  :612-626).

Mirrors, writable stripes, segmented sources, the fault ladder, hedging,
residency tiers, integrity, autotune, NVMe passthrough, the native
io_uring engine and page-cache (mincore) arbitration are not part of this
copy: every chunk is read direct, in the caller's order.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import mmap
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .api import BufferInfo, FileInfo, FsKind, MemCopyResult, StromError
from .config import config
from .log import pr_warn
from .stats import stats

__all__ = ["check_file", "Source", "PlainSource", "StripedSource",
           "open_source", "reorder_chunks", "plan_shard_ownership",
           "DmaBuffer", "Session", "Request", "plan_requests"]

PAGE_SIZE = mmap.PAGESIZE
_libc = ctypes.CDLL(None, use_errno=True)

_EXT4_SUPER_MAGIC = 0xEF53
_XFS_SUPER_MAGIC = 0x58465342


def _fs_magic(path: str) -> int:
    """f_type from statfs(2)."""
    class _Statfs(ctypes.Structure):
        _fields_ = [("f_type", ctypes.c_long), ("f_bsize", ctypes.c_long),
                    ("_pad", ctypes.c_byte * 256)]
    buf = _Statfs()
    if _libc.statfs(os.fsencode(path), ctypes.byref(buf)) != 0:
        return 0
    return buf.f_type & 0xFFFFFFFF


def _probe_odirect(path: str) -> bool:
    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    except OSError:
        return False
    os.close(fd)
    return True


def _logical_block_size(path: str) -> int:
    """The backing block device's logical block size from sysfs (a
    partition reads its parent's queue); 512 when it cannot be found."""
    st = os.stat(path)
    base = f"/sys/dev/block/{os.major(st.st_dev)}:{os.minor(st.st_dev)}"
    for q in (f"{base}/queue/logical_block_size",
              f"{base}/../queue/logical_block_size"):
        try:
            with open(q) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            continue
    return 512


def check_file(path: str, *, dma_max_size: Optional[int] = None) -> FileInfo:
    """CHECK_FILE: classify *path* for the direct-load path.  A file
    smaller than one page is UNSUPPORTED (inline-data risk, reference
    kmod/nvme_strom.c:503-518)."""
    st = os.stat(path)
    if not os.access(path, os.R_OK):
        raise StromError(_errno.EACCES, f"no read permission: {path}")
    direct = _probe_odirect(path)
    magic = _fs_magic(path)
    if magic == _EXT4_SUPER_MAGIC:
        kind = FsKind.EXT4
    elif magic == _XFS_SUPER_MAGIC:
        kind = FsKind.XFS
    else:
        kind = FsKind.OTHER_DIRECT
    if not direct or st.st_size < PAGE_SIZE:
        kind = FsKind.UNSUPPORTED
    return FileInfo(path=path, file_size=st.st_size, fs_kind=kind,
                    logical_block_size=_logical_block_size(path),
                    dma_max_size=dma_max_size or config.get("dma_max_size"))


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Extent:
    """Physically contiguous piece of a logical range on one member fd."""

    member: int
    file_off: int
    length: int
    logical_off: int


class Source:
    """A logical byte stream resolvable to physical extents."""

    size: int
    block_size: int

    def extents(self, offset: int, length: int) -> List[Extent]:
        raise NotImplementedError

    def member_fds(self) -> List[int]:
        """O_DIRECT fds, one per member (-1 where O_DIRECT is refused)."""
        raise NotImplementedError

    def read_buffered(self, offset: int, dest: memoryview) -> None:
        """Page-cache copy path (reference memcpy_pgcache_to_ubuffer,
        kmod/nvme_strom.c:1344-1401)."""
        raise NotImplementedError

    def read_member_buffered(self, member: int, file_off: int,
                             dest: memoryview) -> None:
        raise NotImplementedError

    def read_member_direct(self, member: int, file_off: int,
                           dest: memoryview) -> None:
        """O_DIRECT read of one planned request."""
        fd = self.member_fds()[member]
        if fd < 0:
            raise StromError(_errno.EINVAL, "member has no O_DIRECT fd")
        done, length = 0, len(dest)
        while done < length:
            n = os.preadv(fd, [dest[done:length]], file_off + done)
            if n <= 0:
                raise StromError(_errno.EIO,
                                 f"short direct read at {file_off + done}")
            done += n

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PlainSource(Source):
    """A single regular file."""

    def __init__(self, path: str, block_size: int = 512):
        self.path = path
        self.size = os.stat(path).st_size
        self.block_size = block_size
        try:
            self._fd_direct = os.open(path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            self._fd_direct = -1
        self._fd_buffered = os.open(path, os.O_RDONLY)

    def extents(self, offset: int, length: int) -> List[Extent]:
        if offset < 0 or offset + length > self.size:
            raise StromError(_errno.EINVAL,
                             f"range [{offset},{offset + length}) outside "
                             f"file of {self.size}")
        return [Extent(0, offset, length, offset)]

    def member_fds(self) -> List[int]:
        return [self._fd_direct]

    def read_buffered(self, offset: int, dest: memoryview) -> None:
        n = os.preadv(self._fd_buffered, [dest], offset)
        if n != len(dest):
            raise StromError(_errno.EIO,
                             f"short buffered read {n} != {len(dest)}")

    def read_member_buffered(self, member: int, file_off: int,
                             dest: memoryview) -> None:
        self.read_buffered(file_off, dest)

    def close(self) -> None:
        for fd in (self._fd_direct, self._fd_buffered):
            if fd >= 0:
                os.close(fd)
        self._fd_direct = self._fd_buffered = -1


class _FileMember:
    """One member file of a striped source: a direct and a buffered fd."""

    def __init__(self, path: str):
        self.path = path
        self.size = os.stat(path).st_size
        try:
            self.fd_direct = os.open(path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            self.fd_direct = -1
        self.fd_buffered = os.open(path, os.O_RDONLY)

    def close(self) -> None:
        for fd in (self.fd_direct, self.fd_buffered):
            if fd >= 0:
                os.close(fd)
        self.fd_direct = self.fd_buffered = -1


class StripedSource(Source):
    """A read-only RAID-0 member set resolved with
    :class:`..stripe.StripeMap` (BASELINE's md0 configuration as plain
    member files)."""

    def __init__(self, paths: Sequence[str], stripe_chunk_size: int,
                 block_size: int = 512):
        from .stripe import StripeMap
        self.members = [_FileMember(p) for p in paths]
        try:
            self.map = StripeMap([m.size for m in self.members],
                                 stripe_chunk_size)
        except ValueError as e:
            self.close()
            raise StromError(_errno.EINVAL, str(e)) from None
        self.size = self.map.total_size
        self.block_size = block_size
        self.stripe_chunk_size = stripe_chunk_size

    def extents(self, offset: int, length: int) -> List[Extent]:
        try:
            pieces = self.map.map_range(offset, length)
        except ValueError as e:
            raise StromError(_errno.EINVAL, str(e)) from None
        return [Extent(e.member, e.member_offset, e.length, e.logical_offset)
                for e in pieces]

    def member_fds(self) -> List[int]:
        return [m.fd_direct for m in self.members]

    def read_buffered(self, offset: int, dest: memoryview) -> None:
        for e in self.extents(offset, len(dest)):
            rel = e.logical_off - offset
            self.read_member_buffered(e.member, e.file_off,
                                      dest[rel:rel + e.length])

    def read_member_buffered(self, member: int, file_off: int,
                             dest: memoryview) -> None:
        n = os.preadv(self.members[member].fd_buffered, [dest], file_off)
        if n != len(dest):
            raise StromError(_errno.EIO, "short buffered read")

    def close(self) -> None:
        for m in self.members:
            m.close()


def open_source(spec: Union[str, Sequence[str]], *,
                stripe_chunk_size: Optional[int] = None) -> Source:
    """Open a plain file (a path), aligned to its device's block size, or
    a striped member set (a list of paths and ``stripe_chunk_size``)."""
    if isinstance(spec, str):
        info = check_file(spec)
        return PlainSource(spec, info.logical_block_size)
    if not stripe_chunk_size:
        raise StromError(_errno.EINVAL,
                         "a multi-path source needs stripe_chunk_size")
    return StripedSource(list(spec), stripe_chunk_size)


def reorder_chunks(raw: "np.ndarray", chunk_size: int,
                   got_ids: Sequence[int],
                   want_ids: Sequence[int]) -> "np.ndarray":
    """Rearrange a chunk-strided buffer from the engine's completion order
    back to the caller's requested order (the reference's chunk_ids
    contract, kmod/nvme_strom.h:99-101).  Returns *raw* unchanged when the
    orders already match, else an owned copy."""
    import numpy as np
    got = list(got_ids)
    want = list(want_ids)
    if got == want:
        return raw
    pos = {cid: j for j, cid in enumerate(want)}
    blocks = raw.reshape(len(got), chunk_size)
    ordered = np.empty_like(blocks)
    ordered[[pos[c] for c in got]] = blocks
    return ordered.reshape(raw.shape)


def plan_shard_ownership(source: Source, chunk_ids: Sequence[int],
                         chunk_size: int, n_hosts: int
                         ) -> Dict[int, List[int]]:
    """Partition a chunk list by host for the multi-host sharded loader:
    host → the chunks whose first extent lives on a member that host
    holds (:func:`..stripe.host_of`, member % n_hosts).  A single-member
    source has no placement to follow, so it splits into contiguous
    near-equal ranges.  Every chunk lands in exactly one host's list;
    hosts owning no member of a narrow stripe get empty lists."""
    from .stripe import host_of
    n_hosts = max(int(n_hosts), 1)
    ids = [int(c) for c in chunk_ids]
    owned: Dict[int, List[int]] = {h: [] for h in range(n_hosts)}
    if n_hosts < 2:
        owned[0] = ids
        return owned
    if len(source.member_fds()) < 2:
        q, r = divmod(len(ids), n_hosts)
        pos = 0
        for h in range(n_hosts):
            take = q + (1 if h < r else 0)
            owned[h] = ids[pos:pos + take]
            pos += take
        return owned
    for cid in ids:
        off = cid * chunk_size
        length = min(chunk_size, max(source.size - off, 0))
        if length <= 0:
            owned[host_of(0, n_hosts)].append(cid)
            continue
        member = source.extents(off, length)[0].member
        owned[host_of(member, n_hosts)].append(cid)
    return owned


# ---------------------------------------------------------------------------
# DMA buffers
# ---------------------------------------------------------------------------

class DmaBuffer:
    """Pinned, page-aligned host buffer.

    Anonymous mmap, MAP_HUGETLB tried first, mlock'd when ``pin`` (config
    ``pin_memory``), prefaulted.  :meth:`pin_cuda` registers the range with
    the CUDA runtime so ``copy_(..., non_blocking=True)`` from it is a true
    asynchronous DMA; the unregistration runs as a close callback BEFORE the
    munmap, so a registration can never outlive the mapping."""

    def __init__(self, length: int, *, pin: Optional[bool] = None):
        if length <= 0:
            raise StromError(_errno.EINVAL, "buffer length must be positive")
        length = (length + PAGE_SIZE - 1) & ~(PAGE_SIZE - 1)
        self.length = length
        self.hugepages = False
        mm = None
        flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
        if hasattr(mmap, "MAP_HUGETLB") and length % (2 << 20) == 0:
            try:
                mm = mmap.mmap(-1, length, flags=flags | mmap.MAP_HUGETLB)
                self.hugepages = True
            except OSError:
                mm = None
        if mm is None:
            mm = mmap.mmap(-1, length, flags=flags)
        self._mm = mm
        self.addr = ctypes.addressof(ctypes.c_char.from_buffer(mm))
        self.pinned = False
        if pin if pin is not None else config.get("pin_memory"):
            self.pinned = _libc.mlock(ctypes.c_void_p(self.addr),
                                      ctypes.c_size_t(length)) == 0
        mm[0:length:PAGE_SIZE] = b"\0" * len(range(0, length, PAGE_SIZE))
        self.cuda_registered = False
        self._close_cbs: List = []
        self._lock = threading.Lock()
        self._closing = False

    def pin_cuda(self) -> None:
        """``cudaHostRegister`` the whole buffer (idempotent).  Raises
        when CUDA refuses: an unregistered source would turn every
        asynchronous copy into a silent synchronous one."""
        with self._lock:
            if self.cuda_registered:
                return
            if self._mm is None or self._closing:
                raise StromError(_errno.EBADF, "buffer closed")
            import torch
            err = int(torch.cuda.cudart().cudaHostRegister(
                self.addr, self.length, 0))
            if err != 0:
                raise StromError(_errno.ENOMEM,
                                 f"cudaHostRegister of {self.length} bytes "
                                 f"failed with cudaError {err}")
            self.cuda_registered = True
            self._close_cbs.insert(0, self._unpin_cuda)

    def _unpin_cuda(self) -> None:
        import torch
        torch.cuda.synchronize()      # no copy may still read the range
        torch.cuda.cudart().cudaHostUnregister(self.addr)
        self.cuda_registered = False

    def on_close(self, cb) -> bool:
        """Run *cb* when this buffer closes, before the munmap.  False when
        the buffer is already closed: the caller cleans up itself."""
        with self._lock:
            if self._mm is None or self._closing:
                return False
            self._close_cbs.append(cb)
            return True

    def view(self) -> memoryview:
        return memoryview(self._mm)

    def close(self) -> None:
        with self._lock:
            if self._mm is None or self._closing:
                return
            self._closing = True
            cbs, self._close_cbs = self._close_cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception as e:  # noqa: BLE001 - teardown must finish
                pr_warn("dma buffer close callback failed: %s", e)
        if self.pinned:
            _libc.munlock(ctypes.c_void_p(self.addr),
                          ctypes.c_size_t(self.length))
        try:
            self._mm.close()
        except BufferError:
            pass    # a tensor still aliases the mapping; it dies with it
        with self._lock:
            self._mm = None

    def __del__(self):  # pragma: no cover - GC backstop
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# Request planner
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Request:
    """One merged read request (<= dma_max_size bytes, one member)."""

    member: int
    file_off: int
    length: int
    dest_off: int
    buffered: bool = False   # misaligned piece O_DIRECT cannot express


def plan_requests(source: Source, chunk_entries: Sequence[Tuple[int, int]],
                  chunk_size: int, dest_base: int, *,
                  dma_max_size: Optional[int] = None) -> List[Request]:
    """Merge chunk reads into requests of at most ``dma_max_size`` bytes.

    *chunk_entries* is ``[(chunk_id, dest_slot), ...]``; chunk ``cid``
    covers logical bytes ``[cid*chunk_size, ...+chunk_size)`` (clamped to
    the source size) and lands at ``dest_base + dest_slot*chunk_size``.
    Requests merge when file- and destination-contiguous on one member
    (reference merge condition, kmod/nvme_strom.c:1473-1505); pieces not
    aligned to the block size are planned buffered."""
    cap = dma_max_size or config.get("dma_max_size")
    bs = max(source.block_size, 512)
    pieces: List[Request] = []
    for cid, slot in chunk_entries:
        base = cid * chunk_size
        length = min(chunk_size, source.size - base)
        if length <= 0:
            raise StromError(_errno.EINVAL, f"chunk {cid} beyond EOF")
        dest = dest_base + slot * chunk_size
        for e in source.extents(base, length):
            rel = e.logical_off - base
            aligned = (e.file_off % bs == 0 and e.length % bs == 0
                       and (dest + rel) % bs == 0)
            off = 0
            while off < e.length:
                take = min(cap, e.length - off)
                pieces.append(Request(e.member, e.file_off + off, take,
                                      dest + rel + off, buffered=not aligned))
                off += take
    out: List[Request] = []
    for r in pieces:
        if out:
            p = out[-1]
            if (p.member == r.member and not p.buffered and not r.buffered
                    and p.file_off + p.length == r.file_off
                    and p.dest_off + p.length == r.dest_off
                    and p.length + r.length <= cap):
                out[-1] = Request(p.member, p.file_off, p.length + r.length,
                                  p.dest_off)
                continue
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

class _Task:
    __slots__ = ("task_id", "pending", "done", "errno_", "errmsg", "result",
                 "buf_handle")

    def __init__(self, task_id: int):
        self.task_id = task_id
        self.pending = 1       # creator's reference, dropped after submit
        self.done = False
        self.errno_ = 0
        self.errmsg = ""
        self.result: Optional[MemCopyResult] = None
        self.buf_handle: Optional[int] = None


class Session:
    """Engine session: buffer registry + task table + error retention.

    ``device`` is where loaded bytes go next: with a CUDA device every
    buffer :meth:`alloc_dma_buffer` hands out is registered with the CUDA
    runtime.  Failed tasks are retained until a wait reaps them, and force-
    reaped at :meth:`close` (reference ``strom_proc_release``,
    kmod/nvme_strom.c:2138-2166)."""

    def __init__(self, *, max_workers: Optional[int] = None, device=None):
        self.device = device
        self._buffers: Dict[int, Tuple[memoryview, BufferInfo]] = {}
        self._buf_lock = threading.Condition(threading.Lock())
        self._next_handle = 1
        self._tasks: Dict[int, _Task] = {}
        self._task_cv = threading.Condition(threading.Lock())
        self._next_task = 1
        self._closed = False
        self._pool = ThreadPoolExecutor(max_workers=max_workers or 32,
                                        thread_name_prefix="strom-io")

    # -- buffers -----------------------------------------------------------
    def alloc_dma_buffer(self, length: int) -> Tuple[int, DmaBuffer]:
        """ALLOC_DMA_BUFFER: a new pinned buffer, mapped; returns
        ``(handle, buffer)``."""
        buf = DmaBuffer(length)
        if self.device is not None and str(self.device).startswith("cuda"):
            buf.pin_cuda()
        return self.map_buffer(buf.view(), kind="pinned_host"), buf

    def map_buffer(self, view: memoryview, *, kind: str = "user") -> int:
        view = view.cast("B")
        with self._buf_lock:
            handle = self._next_handle
            self._next_handle += 1
            self._buffers[handle] = (view, BufferInfo(
                handle=handle, length=len(view), page_size=PAGE_SIZE,
                n_pages=(len(view) + PAGE_SIZE - 1) // PAGE_SIZE,
                owner_uid=os.getuid(), refcount=0, kind=kind))
        return handle

    def _get_buffer(self, handle: int, need: int) -> memoryview:
        with self._buf_lock:
            try:
                view, info = self._buffers[handle]
            except KeyError:
                raise StromError(_errno.ENOENT,
                                 f"no mapped buffer {handle}") from None
            if info.owner_uid != os.getuid():
                raise StromError(_errno.EPERM, "buffer owned by another uid")
            if need > info.length:
                raise StromError(_errno.ERANGE, f"buffer {handle} too small: "
                                                f"{need} > {info.length}")
            self._buffers[handle] = (view, BufferInfo(
                **{**info.__dict__, "refcount": info.refcount + 1}))
            return view

    def _put_buffer(self, handle: int) -> None:
        with self._buf_lock:
            if handle in self._buffers:
                view, info = self._buffers[handle]
                info = BufferInfo(**{**info.__dict__,
                                     "refcount": info.refcount - 1})
                self._buffers[handle] = (view, info)
                if info.refcount == 0:
                    self._buf_lock.notify_all()

    def unmap_buffer(self, handle: int, *, timeout: float = 30.0) -> None:
        """Unmap, blocking until in-flight DMA into the buffer drains (the
        reference's revocation callback, kmod/pmemmap.c:149-208)."""
        deadline = time.monotonic() + timeout
        with self._buf_lock:
            while True:
                if handle not in self._buffers:
                    raise StromError(_errno.ENOENT,
                                     f"no mapped buffer {handle}")
                if self._buffers[handle][1].refcount == 0:
                    del self._buffers[handle]
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise StromError(_errno.ETIMEDOUT,
                                     f"buffer {handle} busy")
                self._buf_lock.wait(remaining)

    def info_buffer(self, handle: int) -> BufferInfo:
        with self._buf_lock:
            try:
                return self._buffers[handle][1]
            except KeyError:
                raise StromError(_errno.ENOENT,
                                 f"no mapped buffer {handle}") from None

    # -- tasks -------------------------------------------------------------
    def _task_put(self, task: _Task, err: Optional[StromError] = None) -> None:
        with self._task_cv:
            if err is not None and task.errno_ == 0:
                task.errno_, task.errmsg = err.errno, str(err)   # first wins
            task.pending -= 1
            finished = task.pending == 0
            if finished:
                task.done = True
                self._task_cv.notify_all()
        if finished:
            stats.add("nr_ssd2dev")
            if task.buf_handle is not None:
                self._put_buffer(task.buf_handle)

    def _do_request(self, task: _Task, source: Source, r: Request,
                    dest: memoryview) -> None:
        err = None
        try:
            if not task.errno_:       # a failed task cancels the rest
                piece = dest[r.dest_off:r.dest_off + r.length]
                if r.buffered or source.member_fds()[r.member] < 0:
                    source.read_member_buffered(r.member, r.file_off, piece)
                else:
                    source.read_member_direct(r.member, r.file_off, piece)
        except StromError as e:
            err = e
        except OSError as e:
            err = StromError(e.errno or _errno.EIO, str(e))
        except Exception as e:  # noqa: BLE001 - must latch, never go DONE
            err = StromError(_errno.EIO, f"{type(e).__name__}: {e}")
        self._task_put(task, err)

    def memcpy_wait(self, task_id: int,
                    timeout: Optional[float] = None) -> MemCopyResult:
        """MEMCPY_WAIT: block until the task completes, then reap it.
        Raises the latched first error of a failed task."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._task_cv:
            while True:
                task = self._tasks.get(task_id)
                if task is None:
                    raise StromError(_errno.ENOENT,
                                     f"unknown dma task {task_id}")
                if task.done:
                    del self._tasks[task_id]
                    break
                remain = None if deadline is None \
                    else deadline - time.monotonic()
                if remain is not None and remain <= 0:
                    raise StromError(_errno.ETIMEDOUT,
                                     f"dma task {task_id} timeout")
                self._task_cv.wait(remain)
        if task.errno_:
            raise StromError(task.errno_, task.errmsg or "async DMA failed")
        return task.result

    def memcpy_ssd2ram(self, source: Source, buf_handle: int,
                       chunk_ids: Sequence[int], chunk_size: int, *,
                       dest_offset: int = 0) -> MemCopyResult:
        """MEMCPY_SSD2RAM: plan and submit asynchronously; chunk *i* lands
        at ``dest_offset + i*chunk_size`` of the mapped buffer.  A chunk at
        or beyond EOF is EINVAL; a single-chunk task needs only the
        chunk's true length, which may be a partial file tail."""
        if self._closed:
            raise StromError(_errno.EBADF, "session closed")
        if chunk_size <= 0 or (chunk_size & (chunk_size - 1)):
            raise StromError(_errno.EINVAL,
                             f"chunk_size {chunk_size} must be pow2")
        chunk_ids = list(chunk_ids)
        n = len(chunk_ids)
        if n == 0:
            raise StromError(_errno.EINVAL, "no chunks")
        need = dest_offset + n * chunk_size
        if n == 1:
            tail = min(chunk_size, source.size - chunk_ids[0] * chunk_size)
            if tail > 0:
                need = dest_offset + tail
        dest = self._get_buffer(buf_handle, need)
        with self._task_cv:
            task = _Task(self._next_task)
            self._next_task += 1
            self._tasks[task.task_id] = task
        try:
            for cid in chunk_ids:
                if cid * chunk_size >= source.size:
                    raise StromError(_errno.EINVAL, f"chunk {cid} beyond EOF")
            reqs = plan_requests(source, [(c, i) for i, c in
                                          enumerate(chunk_ids)],
                                 chunk_size, dest_offset)
            for r in reqs:
                with self._task_cv:
                    task.pending += 1
                stats.add("nr_submit_dma")
                stats.add("total_dma_length", r.length)
                self._pool.submit(self._do_request, task, source, r, dest)
        except BaseException:
            self._task_put(task, StromError(_errno.ECANCELED,
                                            "submit aborted"))
            try:      # wait out what was already submitted
                self.memcpy_wait(task.task_id, timeout=30.0)
            except StromError:
                pass
            self._put_buffer(buf_handle)
            raise
        task.result = MemCopyResult(dma_task_id=task.task_id, nr_chunks=n,
                                    nr_ssd2dev=n, nr_ram2dev=0,
                                    chunk_ids=chunk_ids)
        task.buf_handle = buf_handle
        self._task_put(task)      # creator ref; completion drops the buffer
        return task.result

    def close(self, timeout: float = 30.0) -> List[int]:
        """Wait out running tasks and reap retained failures; returns the
        ids of tasks force-reaped with errors."""
        with self._task_cv:
            if self._closed:
                return []
            self._closed = True
            deadline = time.monotonic() + timeout
            while any(not t.done for t in self._tasks.values()):
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                self._task_cv.wait(remain)
            reaped = [tid for tid, t in self._tasks.items() if t.errno_]
            self._tasks.clear()
        self._pool.shutdown(wait=True)
        return reaped

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
