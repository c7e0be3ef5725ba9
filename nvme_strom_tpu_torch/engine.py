"""Host data-path engine: file check, sources, pinned buffers, task table.

A reduced copy of the JAX package's engine: the reference's kernel-module
commands (`kmod/nvme_strom.c`) as an in-process engine.

* ``check_file`` — O_DIRECT probe, fs class, the backing device's
  verdict (:mod:`.eligibility`), logical block size, NUMA node, DMA64,
  request cap (reference ``ioctl_check_file``, :188-583);
* sources — ``PlainSource`` (one file), ``SegmentedSource`` (fixed-size
  segment files, a PostgreSQL relation's shape) and ``StripedSource`` (a
  RAID-0 member set, or with ``mirror='paired'`` a RAID-10 one,
  :mod:`.stripe`), each readable and, opened with ``writable=True``,
  writable; their page-cache residency probe (one batched ``mincore(2)``
  a task, with the ``/proc/kpageflags`` dirty check); the host-ownership
  planner of the multi-host loader (``plan_shard_ownership``);
* ``DmaBuffer`` — page-aligned anonymous mmap (hugepages when the length
  allows), optionally mlock'd, registered with the CUDA runtime
  (``cudaHostRegister``) so host→device copies from it run asynchronously;
* the request planner — merges of file- and destination-contiguous reads
  up to ``dma_max_size`` (reference :1473-1505), then, for the native
  engine, coalescing beyond that cap up to ``coalesce_limit`` under a
  per-member :class:`AdaptiveChunkSizer`;
* ``Session`` — buffer handle table, one task per memcpy command, first
  error latched and retained until a wait reaps it (reference design memo
  :612-626).  With config ``cache_arbitration`` (on) a read's hot, dirty
  or cached chunks take the write-back leg (a page-cache copy, after the
  direct chunks, reference :1639-1663), except on a filesystem whose
  residency probe cannot see an eviction.  Planned direct requests execute
  on the native engine (:mod:`._native`: io_uring, else its pread thread
  pool), submitted in ``submit_window`` slices and one lane a stripe
  member, landing straight into pinned buffers registered as io_uring
  fixed buffers; a member the health machine routes away is read from its
  mirror's fd and lane.  With ``io_backend=python`` or a source whose
  read leg is overridden they run on Python pools (one a stripe member)
  through the fault ladder (:mod:`.fault`): retry with backoff, the
  mirror, the buffered leg, hedged reads.  A watchdog latches ETIMEDOUT
  on a task past ``task_deadline_s``; a canary thread probes FAILED and
  REJOINING members and replays what a rejoiner missed.  The write leg
  (``memcpy_ram2ssd``) mirrors the read path: retries, PERSISTENT errors
  (ENOSPC) latched at once, every aligned leg of a paired sink written to
  both partners (a partner routed away is journaled for resync), and the
  ``write_verify`` read-back.

With config ``checksum_verify`` each landed heap page's crc32c is checked
where it lands (the python pools after each request, the native engine's
synchronous legs at submit, its zero-copy batches at wait time on the
retired task): a bad page is re-read up to ``checksum_retries`` times,
then the task latches EBADMSG.  The residency tiers of
:mod:`.tiering` sit in front of the lanes: a task's chunks are looked up
in the HBM tier, then the RAM tier, when it is planned; a hit is copied
out with no submission, after the write-back chunks, and only the misses
go on to arbitration and the lanes.  The misses fill the RAM tier at wait
time, once the fault ladder healed them; a write invalidates every tier
before any byte moves and again at wait time.  Each Session runs the
integrity domain's scrubber (:mod:`.integrity`) over the tiers.

With config ``autotune`` or ``readahead`` a Session runs its controller
(:mod:`.autotune`): the tuned submit window, request cap, hedge delay and
member pool widths replace the static knobs at their sites, the tuner
hosts the adaptive chunk sizers, and a demand read trains the readahead
predictor, whose speculative reads (``memcpy_ssd2ram(...,
speculative=True)``) fill the RAM tier.  With both off each site costs
one branch.

The NVMe passthrough lane: a task on a source with a passthrough channel
splits each planned direct request per extent (:meth:`Session.
_passthru_split`, :mod:`.blockmap`): runs that resolve to LBA-aligned
device ranges become sub-requests carrying ``passthru_off`` (a device byte
offset), the rest (holes, ineligible FIEMAP flags, misaligned heads and
tails) ride the O_DIRECT lanes of the same task.  The channel is the
source's own (the emulator, :mod:`.testing.passthru_emu`, serving the
python pools, where every recovery rung that leaves the lane is counted
``nr_passthru_fallback``), else the native engine's when it came up on
the passthrough rung (flagged requests, raw NVMe READs through
``IORING_OP_URING_CMD``; a member whose file sysfs does not place on
that device's namespace reads O_DIRECT, and one on a partition adds the
partition's start).  Config ``engine_backend`` places the rung on
the ladder; ``uring`` and ``threadpool`` probe nothing and move no
passthrough counter.  A write drops the sink's cached extent maps.

NUMA: after the lane scale-out each lane's threads are pinned to the CPUs
of its member device's node (config ``numa_policy``, :mod:`.numa`), and a
:class:`DmaBuffer` given a node is faulted in by a thread bound to it.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import mmap
import os
import random
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from . import blockmap
from . import numa as _numa
from .api import (BufferInfo, ErrorClass, FileInfo, FsKind, MemCopyResult,
                  StromError)
from .autotune import AutoTuner
from .config import config
from .eligibility import probe_backing
from .fault import (DirtyExtentJournal, HealthState, MemberHealthMachine,
                    RetryPolicy)
from .integrity import Scrubber, domain as _integrity, \
    verify_and_reread
from .log import pr_info, pr_warn
from .stats import stats
from .tiering import extent_space as _tiers
from .trace import recorder as _trace

__all__ = ["check_file", "Source", "PlainSource", "SegmentedSource",
           "StripedSource", "open_source", "reorder_chunks",
           "read_chunk_ids", "plan_shard_ownership", "DmaBuffer", "Session",
           "Request", "plan_requests", "AdaptiveChunkSizer"]

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


def fs_class(path: str) -> FsKind:
    """The class of *path*'s filesystem for the direct-load path: ext4 or
    xfs when it honours O_DIRECT there, another filesystem that honours
    it, else UNSUPPORTED.  A fact of the filesystem, whatever the file's
    size (the size rule is :func:`check_file`'s)."""
    kind = {_EXT4_SUPER_MAGIC: FsKind.EXT4, _XFS_SUPER_MAGIC: FsKind.XFS} \
        .get(_fs_magic(path), FsKind.OTHER_DIRECT)
    return kind if _probe_odirect(path) else FsKind.UNSUPPORTED


def check_file(path: str, *, dma_max_size: Optional[int] = None,
               strict: Optional[bool] = None,
               sysfs_root: str = "/sys") -> FileInfo:
    """CHECK_FILE: classify *path* for the direct-load path (reference
    kmod/nvme_strom.c:188-583): read permission, the filesystem's class
    (ext4, xfs, or another that honours O_DIRECT), a file of at least one
    page (inline-data risk, :503-518), then the backing walk of
    :mod:`.eligibility` over *sysfs_root*: NVMe or md-RAID-0 of NVMe,
    NUMA node, DMA64, the device's request cap (which clamps
    ``dma_max_size``).

    The engine drives any O_DIRECT file, so the backing verdict is always
    reported (``backing_supported``, ``backing_reason``) and only gates
    under strict eligibility (*strict*, default config
    ``require_nvme_backing``): an unverified backing, or one without
    64-bit DMA, then sets ``policy_rejected`` and the file is not
    ``supported``.  ``fs_kind`` stays the fact, so a cached probe and a
    live policy compose."""
    st = os.stat(path)
    if not os.access(path, os.R_OK):
        raise StromError(_errno.EACCES, f"no read permission: {path}")
    kind = fs_class(path)
    backing = probe_backing(path, sysfs_root=sysfs_root)
    if strict is None:
        strict = config.get("require_nvme_backing")
    policy_rejected = bool(strict and not (backing.supported
                                           and backing.support_dma64))
    if st.st_size < PAGE_SIZE:
        kind = FsKind.UNSUPPORTED
    cap = dma_max_size or config.get("dma_max_size")
    if backing.dma_max_size:
        cap = min(cap, backing.dma_max_size)
    return FileInfo(path=path, file_size=st.st_size, fs_kind=kind,
                    logical_block_size=backing.logical_block_size or 512,
                    dma_max_size=cap,
                    numa_node_id=backing.numa_node_id,
                    support_dma64=backing.support_dma64,
                    n_members=max(1, len(backing.members)),
                    stripe_chunk_size=backing.stripe_chunk_size,
                    backing_kind=backing.kind,
                    backing_supported=backing.supported,
                    backing_reason=backing.reason,
                    policy_rejected=policy_rejected)


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
    """A logical byte stream resolvable to physical extents.

    Read-only by default; opened with ``writable=True`` it also carries the
    RAM→SSD write legs."""

    size: int
    block_size: int
    writable: bool = False

    def extents(self, offset: int, length: int) -> List[Extent]:
        raise NotImplementedError

    def member_fds(self) -> List[int]:
        """O_DIRECT fds, one per member (-1 where O_DIRECT is refused)."""
        raise NotImplementedError

    def member_buffered_fds(self) -> List[int]:
        """Buffered (page-cache) fds, one per member."""
        raise NotImplementedError

    def mirror_of(self, member: int) -> Optional[int]:
        """The member holding a byte-identical replica of *member* at the
        same offsets, or None when the source has no redundancy (a
        striped source opened with ``mirror='paired'`` has one)."""
        return None

    # -- page-cache residency (the arbitration probe) -----------------------
    def cached_fraction(self, offset: int, length: int) -> float:
        """Fraction of the range resident in the page cache (the
        reference's find_lock_page probe, kmod/nvme_strom.c:1639-1645;
        here mincore(2))."""
        return 0.0

    def probe_file(self) -> "Optional[_FileMember]":
        """The file whose mincore(2) answers :meth:`residency`, or None
        where the verdict is not the kernel's (no file; a forced one)."""
        return None

    def hint_hot_range(self, offset: int, length: int) -> None:
        """Declare ``[offset, offset + length)`` hot (being written): a
        chunk overlapping it takes the write-back leg (the reference's
        one-dirty-page rule, :1643)."""
        if length <= 0:
            return
        hints = getattr(self, "_hot_hints", None)
        if hints is None:
            hints = self._hot_hints = []
        hints.append((offset, offset + length))

    def clear_hot_hints(self) -> None:
        self._hot_hints = []

    def hot_fraction(self, offset: int, length: int) -> float:
        """Fraction of the range under hot hints (a file source adds its
        measured dirty pages); any value above 0 routes the chunk
        write-back."""
        hints = getattr(self, "_hot_hints", None)
        if not hints or length <= 0:
            return 0.0
        covered = 0
        for h0, h1 in hints:
            lo, hi = max(offset, h0), min(offset + length, h1)
            if hi > lo:
                covered += hi - lo
        return min(covered / length, 1.0)

    def residency(self, spans: Sequence[Tuple[int, int]]
                  ) -> List[Tuple[float, float]]:
        """``(cached_fraction, hot_fraction)`` of each ``(offset, length)``
        span: the arbitration probe of one task.  This default asks the
        scalar probes, so a subclass that overrides them (a test fake's
        forced verdict) decides; a plain file answers with one batched
        mincore(2)."""
        return [(self.cached_fraction(o, n), self.hot_fraction(o, n))
                for o, n in spans]

    def read_buffered(self, offset: int, dest: memoryview) -> None:
        """Page-cache copy of a logical range (reference
        memcpy_pgcache_to_ubuffer, kmod/nvme_strom.c:1344-1401)."""
        for e in self.extents(offset, len(dest)):
            rel = e.logical_off - offset
            self.read_member_buffered(e.member, e.file_off,
                                      dest[rel:rel + e.length])

    def read_member_buffered(self, member: int, file_off: int,
                             dest: memoryview) -> None:
        """Buffered read addressed by (member, member offset): misaligned
        pieces O_DIRECT cannot express."""
        n = os.preadv(self.member_buffered_fds()[member], [dest], file_off)
        if n != len(dest):
            raise StromError(_errno.EIO,
                             f"short buffered read {n} != {len(dest)}")

    def read_member_direct(self, member: int, file_off: int,
                           dest: memoryview) -> None:
        """O_DIRECT read of one planned request (the python pool's leg;
        test fakes override it, which keeps their reads off the native
        engine)."""
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

    # -- write legs (RAM→SSD; need writable=True) ---------------------------
    def _check_writable(self) -> None:
        if not self.writable:
            raise StromError(_errno.EBADF, "source opened read-only; "
                                           "open_source(..., writable=True)")

    def write_member_direct(self, member: int, file_off: int,
                            src: memoryview) -> None:
        """O_DIRECT write of one planned request (the python pool's leg)."""
        self._check_writable()
        fd = self.member_fds()[member]
        if fd < 0:
            raise StromError(_errno.EINVAL, "member has no O_DIRECT fd")
        done, length = 0, len(src)
        while done < length:
            n = os.pwritev(fd, [src[done:length]], file_off + done)
            if n <= 0:
                raise StromError(_errno.EIO,
                                 f"short direct write at {file_off + done}")
            done += n

    def write_member_buffered(self, member: int, file_off: int,
                              src: memoryview) -> None:
        """Buffered write: misaligned pieces O_DIRECT cannot express."""
        self._check_writable()
        fd = self.member_buffered_fds()[member]
        done, length = 0, len(src)
        while done < length:       # partial buffered writes are legal
            n = os.pwritev(fd, [src[done:length]], file_off + done)
            if n <= 0:
                raise StromError(_errno.EIO,
                                 f"short buffered write at {file_off + done}")
            done += n

    def sync(self) -> None:
        """fsync every member: durability of the buffered write legs (and
        of the file's metadata after direct writes)."""
        for fd in self.member_buffered_fds():
            os.fsync(fd)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# mincore(2) defines bit 0 of each residency byte only: translate through
# this table before counting so reserved high bits never skew a probe
_MINCORE_LSB = bytes((i & 1) for i in range(256))


class _FileMember:
    """One underlying file: a direct and a buffered fd, and a private
    read mapping for the mincore(2) residency probe."""

    def __init__(self, path: str, writable: bool = False):
        self.path = path
        st = os.stat(path)
        self.size = st.st_size
        self.st_dev = st.st_dev
        self.writable = writable
        mode = os.O_RDWR if writable else os.O_RDONLY
        try:
            self.fd_direct = os.open(path, mode | os.O_DIRECT)
        except OSError:
            self.fd_direct = -1
        self.fd_buffered = os.open(path, mode)
        self._mm: Optional[mmap.mmap] = None
        self._mm_addr = 0
        self._mincore_buf = None      # grown on demand, one a member
        self._mincore_cap = 0
        self._probe_lock = threading.Lock()

    def _map(self) -> Optional[mmap.mmap]:
        if self._mm is None and self.size > 0:
            # a private mapping: its pages stay the page cache's until
            # written, and ctypes can take its address for mincore(2)
            self._mm = mmap.mmap(self.fd_buffered, self.size,
                                 flags=mmap.MAP_PRIVATE,
                                 prot=mmap.PROT_READ | mmap.PROT_WRITE)
            self._mm_addr = ctypes.addressof(
                ctypes.c_char.from_buffer(self._mm))
        return self._mm

    def _mincore(self, lo: int, end: int) -> Optional[bytes]:
        """Residency bits (0/1 a page) of ``[lo, end)``, *lo* page-aligned;
        None when the probe is refused."""
        if self._map() is None or end <= lo:
            return None
        npages = max((end - lo + PAGE_SIZE - 1) // PAGE_SIZE, 1)
        with self._probe_lock:
            if npages > self._mincore_cap:
                self._mincore_cap = max(npages, self._mincore_cap * 2, 256)
                self._mincore_buf = (ctypes.c_ubyte * self._mincore_cap)()
            if _libc.mincore(ctypes.c_void_p(self._mm_addr + lo),
                             ctypes.c_size_t(end - lo),
                             self._mincore_buf) != 0:
                return None
            return ctypes.string_at(self._mincore_buf, npages) \
                .translate(_MINCORE_LSB)

    def cached_fraction(self, offset: int, length: int) -> float:
        lo = offset & ~(PAGE_SIZE - 1)
        bits = self._mincore(lo, min(offset + length, self.size))
        return bits.count(1) / len(bits) if bits else 0.0

    def probe_sees_eviction(self) -> Optional[bool]:
        """Whether mincore(2) on this file's filesystem reports a dropped
        page as gone: the last page is probed and, when resident, the
        file's last 2 MiB (the largest page-cache folio on x86-64, which
        is only dropped whole) are unmapped from the probe's own mapping,
        written back, dropped (fadvise DONTNEED) and the page probed
        again.  None when the probe is refused."""
        if self.size <= 0:
            return None
        lo = (self.size - 1) & ~(PAGE_SIZE - 1)
        bits = self._mincore(lo, self.size)
        if not bits:
            return None
        if not bits[0]:
            return True
        tail = (self.size - 1) & ~((2 << 20) - 1)
        # the dirty check read-faults pages into the mapping, and a mapped
        # or dirty page is not dropped
        self._mm.madvise(mmap.MADV_DONTNEED, tail, self.size - tail)
        # SYNC_FILE_RANGE_WAIT_BEFORE | WRITE | WAIT_AFTER, to EOF
        _libc.sync_file_range(self.fd_buffered, ctypes.c_int64(tail),
                              ctypes.c_int64(0), 7)
        os.posix_fadvise(self.fd_buffered, tail, 0, os.POSIX_FADV_DONTNEED)
        bits = self._mincore(lo, self.size)
        return None if not bits else not bits[0]

    def cached_spans(self, spans: Sequence[Tuple[int, int]]
                     ) -> List[Tuple[float, bool]]:
        """``(cached_fraction, any page resident)`` of each span from ONE
        mincore(2) over the range enclosing them all."""
        if not spans:
            return []
        lo = min(o for o, _ in spans) & ~(PAGE_SIZE - 1)
        bits = self._mincore(lo, min(max(o + n for o, n in spans),
                                     self.size))
        if bits is None:
            return [(0.0, False)] * len(spans)
        out = []
        for o, n in spans:
            p0 = ((o & ~(PAGE_SIZE - 1)) - lo) // PAGE_SIZE
            p1 = (min(o + n, self.size) - lo + PAGE_SIZE - 1) // PAGE_SIZE
            res = bits[p0:p1].count(1)
            out.append((res / max(p1 - p0, 1), res > 0))
        return out

    def dirty_fraction(self, offset: int, length: int) -> float:
        """Fraction of the range's pages that are dirty in the page cache
        (the reference's PageDirty, kmod/nvme_strom.c:1643), read through
        /proc/self/pagemap and /proc/kpageflags for the resident pages
        only; 0.0 where those files cannot be read (the hint API is then
        the only dirty signal)."""
        lo = offset & ~(PAGE_SIZE - 1)
        bits = self._mincore(lo, min(offset + length, self.size))
        if not bits or 1 not in bits:
            return 0.0
        try:
            pm = os.open("/proc/self/pagemap", os.O_RDONLY)
        except OSError:
            return 0.0
        try:
            try:
                kf = os.open("/proc/kpageflags", os.O_RDONLY)
            except OSError:
                return 0.0
            try:
                dirty = 0
                for i, b in enumerate(bits):
                    if not b:
                        continue
                    va = self._mm_addr + lo + i * PAGE_SIZE
                    # a read fault maps the resident page without
                    # dirtying it, so pagemap shows its frame
                    ctypes.c_ubyte.from_address(va).value
                    ent = os.pread(pm, 8, (va // PAGE_SIZE) * 8)
                    if len(ent) != 8:
                        continue
                    word = int.from_bytes(ent, "little")
                    pfn = word & ((1 << 55) - 1)
                    if not word >> 63 or pfn == 0:
                        continue
                    flags = os.pread(kf, 8, pfn * 8)
                    if len(flags) == 8 and \
                            (int.from_bytes(flags, "little") >> 4) & 1:
                        dirty += 1      # KPF_DIRTY
                return dirty / len(bits)
            finally:
                os.close(kf)
        finally:
            os.close(pm)

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass    # a ctypes view still holds it; it dies with it
            self._mm = None
        for fd in (self.fd_direct, self.fd_buffered):
            if fd >= 0:
                os.close(fd)
        self.fd_direct = self.fd_buffered = -1


class PlainSource(Source):
    """A single regular file."""

    def __init__(self, path: str, block_size: int = 512,
                 writable: bool = False):
        self._m = _FileMember(path, writable)
        self.path = path
        self.size = self._m.size
        self.block_size = block_size
        self.writable = writable

    def extents(self, offset: int, length: int) -> List[Extent]:
        if offset < 0 or offset + length > self.size:
            raise StromError(_errno.EINVAL,
                             f"range [{offset},{offset + length}) outside "
                             f"file of {self.size}")
        return [Extent(0, offset, length, offset)]

    def member_fds(self) -> List[int]:
        return [self._m.fd_direct]

    def member_buffered_fds(self) -> List[int]:
        return [self._m.fd_buffered]

    def cached_fraction(self, offset: int, length: int) -> float:
        return self._m.cached_fraction(offset, length)

    def probe_file(self) -> "Optional[_FileMember]":
        if type(self).cached_fraction is not PlainSource.cached_fraction:
            return None     # a subclass forces the verdict
        return self._m

    def hot_fraction(self, offset: int, length: int) -> float:
        # hints, then the measured dirty pages, whichever is louder
        hinted = super().hot_fraction(offset, length)
        if hinted >= 1.0:
            return hinted
        return max(hinted, self._m.dirty_fraction(offset, length))

    def residency(self, spans: Sequence[Tuple[int, int]]
                  ) -> List[Tuple[float, float]]:
        # one batched mincore for the task, unless a subclass overrides a
        # scalar probe (a test fake's forced verdict owns arbitration)
        if (type(self).cached_fraction is not PlainSource.cached_fraction
                or type(self).hot_fraction is not PlainSource.hot_fraction):
            return super().residency(spans)
        out = []
        for (off, ln), (frac, any_res) in zip(spans,
                                              self._m.cached_spans(spans)):
            hot = Source.hot_fraction(self, off, ln)
            if hot < 1.0 and any_res:
                # a dirty page is resident: probe /proc only there
                hot = max(hot, self._m.dirty_fraction(off, ln))
            out.append((frac, hot))
        return out

    def read_buffered(self, offset: int, dest: memoryview) -> None:
        self.read_member_buffered(0, offset, dest)

    def close(self) -> None:
        self._m.close()


class SegmentedSource(Source):
    """A PostgreSQL-style segmented relation: one logical stream split
    across fixed-size segment files (reference per-segment fd table,
    pgsql/nvme_strom.c:124-130, 692-714).  Every segment but the last is
    exactly ``segment_size`` bytes."""

    def __init__(self, paths: Sequence[str], segment_size: int,
                 block_size: int = 512, writable: bool = False):
        if segment_size <= 0:
            raise StromError(_errno.EINVAL, "segment_size must be positive")
        self.members = [_FileMember(p, writable) for p in paths]
        for m in self.members[:-1]:
            if m.size != segment_size:
                self.close()
                raise StromError(_errno.EINVAL,
                                 f"non-final segment {m.path} has size "
                                 f"{m.size} != {segment_size}")
        self.segment_size = segment_size
        self.size = sum(m.size for m in self.members)
        self.block_size = block_size
        self.writable = writable

    def extents(self, offset: int, length: int) -> List[Extent]:
        if offset < 0 or offset + length > self.size:
            raise StromError(_errno.EINVAL,
                             "range outside segmented relation")
        out: List[Extent] = []
        pos, rem = offset, length
        while rem > 0:
            seg, soff = divmod(pos, self.segment_size)
            take = min(self.segment_size - soff, rem)
            out.append(Extent(seg, soff, take, pos))
            pos += take
            rem -= take
        return out

    def member_fds(self) -> List[int]:
        return [m.fd_direct for m in self.members]

    def member_buffered_fds(self) -> List[int]:
        return [m.fd_buffered for m in self.members]

    def cached_fraction(self, offset: int, length: int) -> float:
        return _members_cached(self, offset, length)

    def probe_file(self) -> "Optional[_FileMember]":
        if type(self).cached_fraction is not \
                SegmentedSource.cached_fraction:
            return None     # a subclass forces the verdict
        return self.members[0]

    def close(self) -> None:
        for m in self.members:
            m.close()


def _members_cached(src: Source, offset: int, length: int) -> float:
    """Length-weighted cached fraction of a range over its extents."""
    total, weight = 0.0, 0
    for e in src.extents(offset, length):
        total += src.members[e.member].cached_fraction(e.file_off,
                                                       e.length) * e.length
        weight += e.length
    return total / weight if weight else 0.0


class StripedSource(Source):
    """A RAID-0 member set resolved with :class:`..stripe.StripeMap`
    (BASELINE's md0 configuration as plain member files); with
    ``mirror='paired'`` (default config ``mirror``) member 2k+1 is a
    replica of member 2k, the RAID-10 shape the fault ladder reads a
    failed member's extents from.  A writable paired set gets every
    aligned write on both partners."""

    def __init__(self, paths: Sequence[str], stripe_chunk_size: int,
                 block_size: int = 512, writable: bool = False,
                 mirror: Optional[str] = None):
        from .stripe import StripeMap
        if mirror is None:
            mirror = str(config.get("mirror"))
        self.members = [_FileMember(p, writable) for p in paths]
        try:
            self.map = StripeMap([m.size for m in self.members],
                                 stripe_chunk_size, mirror=mirror)
        except ValueError as e:
            self.close()
            raise StromError(_errno.EINVAL, str(e)) from None
        self.size = self.map.total_size
        self.block_size = block_size
        self.stripe_chunk_size = stripe_chunk_size
        self.writable = writable

    def mirror_of(self, member: int) -> Optional[int]:
        return self.map.mirror_of(member)

    def cached_fraction(self, offset: int, length: int) -> float:
        return _members_cached(self, offset, length)

    def probe_file(self) -> "Optional[_FileMember]":
        if type(self).cached_fraction is not \
                StripedSource.cached_fraction:
            return None     # a subclass forces the verdict
        return self.members[0]

    def extents(self, offset: int, length: int) -> List[Extent]:
        try:
            pieces = self.map.map_range(offset, length)
        except ValueError as e:
            raise StromError(_errno.EINVAL, str(e)) from None
        return [Extent(e.member, e.member_offset, e.length, e.logical_offset)
                for e in pieces]

    def member_fds(self) -> List[int]:
        return [m.fd_direct for m in self.members]

    def member_buffered_fds(self) -> List[int]:
        return [m.fd_buffered for m in self.members]

    def close(self) -> None:
        for m in self.members:
            m.close()


def open_source(spec: Union[str, Sequence[str]], *,
                stripe_chunk_size: Optional[int] = None,
                segment_size: Optional[int] = None,
                block_size: Optional[int] = None,
                writable: bool = False,
                mirror: Optional[str] = None) -> Source:
    """Open a plain file (a path), aligned to its device's block size, a
    striped member set (a list of paths and ``stripe_chunk_size``; *mirror*
    ``none`` or ``paired``, default config ``mirror``) or a segmented
    relation (a list of paths and ``segment_size``)."""
    if isinstance(spec, str):
        info = check_file(spec)
        return PlainSource(spec, block_size or info.logical_block_size,
                           writable)
    paths = list(spec)
    if stripe_chunk_size:
        return StripedSource(paths, stripe_chunk_size, block_size or 512,
                             writable, mirror=mirror)
    if segment_size:
        return SegmentedSource(paths, segment_size, block_size or 512,
                               writable)
    raise StromError(_errno.EINVAL, "a multi-path source needs "
                                    "stripe_chunk_size or segment_size")


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


def read_chunk_ids(sess: "Session", source: Source,
                   chunk_ids: Sequence[int], chunk_size: int,
                   buf_handle: int, buf_view: memoryview) -> "np.ndarray":
    """One synchronous read of *chunk_ids* through a mapped pinned buffer,
    returned in CALLER order: the submit/wait/reorder protocol every
    point read (a lookup, a checkpoint restore) shares."""
    import numpy as np
    ids = [int(c) for c in chunk_ids]
    res = sess.memcpy_ssd2ram(source, buf_handle, ids, chunk_size)
    sess.memcpy_wait(res.dma_task_id)
    return reorder_chunks(
        np.frombuffer(buf_view[:len(ids) * chunk_size], np.uint8),
        chunk_size, res.chunk_ids, ids)


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
    asynchronous DMA.  :meth:`close` tears down in a fixed order: the close
    callbacks (a session's io_uring fixed-buffer unregistration), then the
    CUDA unregistration, then the munmap — no registration outlives the
    mapping.  With ``numa_node`` >= 0 the pages are locked and faulted in
    by a thread bound to that node's CPUs, so the kernel's default local
    policy places them there (the reference binds its pool chunks to a
    node, pgsql/nvme_strom.c:1454-1526); :attr:`placed` says whether the
    bind took.  -1 (the default) faults them in on the calling thread."""

    def __init__(self, length: int, *, numa_node: int = -1,
                 pin: Optional[bool] = None):
        if length <= 0:
            raise StromError(_errno.EINVAL, "buffer length must be positive")
        length = (length + PAGE_SIZE - 1) & ~(PAGE_SIZE - 1)
        self.length = length
        self.numa_node = numa_node
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
        #: True when the pages were faulted in on numa_node's CPUs
        self.placed = False
        pin = pin if pin is not None else config.get("pin_memory")
        if numa_node >= 0:
            t = threading.Thread(target=self._fault_in, args=(pin, numa_node),
                                 name="strom-numa-place")
            t.start()
            t.join()
        else:
            self._fault_in(pin, -1)
        self.cuda_registered = False
        self._close_cbs: List = []
        self._lock = threading.Lock()
        self._closing = False

    def _fault_in(self, pin: bool, node: int) -> None:
        # the thread that faults a page in decides its node: bind first
        if node >= 0:
            self.placed = _numa.bind_to_node(node)
        if pin:
            self.pinned = _libc.mlock(ctypes.c_void_p(self.addr),
                                      ctypes.c_size_t(self.length)) == 0
        self._mm[0:self.length:PAGE_SIZE] = \
            b"\0" * len(range(0, self.length, PAGE_SIZE))

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

    def _unpin_cuda(self) -> None:
        import torch
        torch.cuda.synchronize()      # no copy may still read the range
        torch.cuda.cudart().cudaHostUnregister(self.addr)
        self.cuda_registered = False

    def on_close(self, cb) -> bool:
        """Run *cb* when this buffer closes, before the CUDA unregistration
        and the munmap.  False when the buffer is already closed: the
        caller cleans up itself."""
        with self._lock:
            if self._mm is None or self._closing:
                return False
            self._close_cbs.append(cb)
            return True

    def remove_close_cb(self, cb) -> None:
        """Detach a callback added by :meth:`on_close` (a closing session
        whose engine already dropped the registration)."""
        with self._lock:
            try:
                self._close_cbs.remove(cb)
            except ValueError:
                pass

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
        if self.cuda_registered:
            try:
                self._unpin_cuda()
            except Exception as e:  # noqa: BLE001 - teardown must finish
                pr_warn("cudaHostUnregister failed: %s", e)
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
    """One merged I/O request (<= dma_max_size bytes, one member; up to
    coalesce_limit when the second merge pass ran)."""

    member: int
    file_off: int
    length: int
    dest_off: int
    buffered: bool = False   # misaligned piece O_DIRECT cannot express
    # stripe-coalesced read: when non-empty, the file-contiguous span
    # scatters into these (dest_off, length) segments (dest_off above is
    # then the first segment's, length the span's total)
    dest_segs: Tuple[Tuple[int, int], ...] = ()
    # the passthrough lane: the blockmap-resolved DEVICE byte offset of a
    # request that rides raw NVMe READs; None rides O_DIRECT.  Set only by
    # Session._passthru_split, never by plan_requests
    passthru_off: Optional[int] = None


def plan_requests(source: Source, chunk_entries: Sequence[Tuple[int, int]],
                  chunk_size: int, dest_base: int, *,
                  dma_max_size: Optional[int] = None,
                  dest_segment_shift: Optional[int] = None,
                  coalesce_limit: Union[int, Dict[int, int], None] = None
                  ) -> List[Request]:
    """Merge chunk reads into requests.

    *chunk_entries* is ``[(chunk_id, dest_slot), ...]``; chunk ``cid``
    covers logical bytes ``[cid*chunk_size, ...+chunk_size)`` (clamped to
    the source size) and lands at ``dest_base + dest_slot*chunk_size``.
    Requests merge when file- and destination-contiguous on one member, up
    to ``dma_max_size``, and never across a destination segment boundary
    when ``dest_segment_shift`` is given (reference merge condition,
    kmod/nvme_strom.c:1473-1505); pieces not aligned to the block size are
    planned buffered.

    ``coalesce_limit`` runs a second merge pass beyond the dma_max cap:
    file-contiguous neighbours within one member merge up to that many
    bytes, into vectored requests (:attr:`Request.dest_segs`) when the
    stripe interleave scatters their destinations.  A ``{member: limit}``
    dict gives each member its own cap; members missing from it do not
    coalesce."""
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
                if dest_segment_shift is not None:
                    seg_end = (((dest + rel + off) >> dest_segment_shift)
                               + 1) << dest_segment_shift
                    take = min(take, seg_end - (dest + rel + off))
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
                    and p.length + r.length <= cap
                    and (dest_segment_shift is None
                         or (p.dest_off >> dest_segment_shift)
                         == ((r.dest_off + r.length - 1)
                             >> dest_segment_shift))):
                out[-1] = Request(p.member, p.file_off, p.length + r.length,
                                  p.dest_off)
                continue
        out.append(r)
    if coalesce_limit:
        if isinstance(coalesce_limit, dict):
            if any(v > cap for v in coalesce_limit.values()):
                out = _coalesce_requests(out, coalesce_limit,
                                         dest_segment_shift)
        elif coalesce_limit > cap:
            out = _coalesce_requests(out, coalesce_limit, dest_segment_shift)
    return out


def _coalesce_requests(reqs: List[Request], limit: Union[int, Dict[int, int]],
                       dest_segment_shift: Optional[int]) -> List[Request]:
    """Second merge pass (the reference's request-merge window beyond the
    per-command cap, kmod/nvme_strom.c:1473-1505): direct requests that
    are file-contiguous within one member merge up to *limit* bytes even
    when the stripe interleave scatters their destinations, as a vectored
    request in :attr:`Request.dest_segs`.  Requests read into disjoint
    destinations, so pulling a later one forward never reorders observable
    writes.  A buffered piece breaks its member's run."""
    caps = limit if isinstance(limit, dict) else None
    out: List[Request] = []
    last: dict = {}  # member -> index in out of its last direct request
    for r in reqs:
        idx = last.get(r.member)
        if idx is not None and not r.buffered:
            lim = caps.get(r.member, 0) if caps is not None else limit
            p = out[idx]
            if (p.file_off + p.length == r.file_off
                    and p.length + r.length <= lim):
                segs = p.dest_segs or ((p.dest_off, p.length),)
                d, ln = segs[-1]
                if d + ln == r.dest_off and (
                        dest_segment_shift is None
                        or (d >> dest_segment_shift)
                        == ((r.dest_off + r.length - 1)
                            >> dest_segment_shift)):
                    segs = segs[:-1] + ((d, ln + r.length),)
                else:
                    segs = segs + ((r.dest_off, r.length),)
                out[idx] = Request(p.member, p.file_off,
                                   p.length + r.length, p.dest_off,
                                   dest_segs=segs if len(segs) > 1 else ())
                continue
        out.append(r)
        if r.buffered:
            last.pop(r.member, None)
        else:
            last[r.member] = len(out) - 1
    return out


class AdaptiveChunkSizer:
    """Adaptive coalesced-request cap: starts at ``limit``, halves toward
    ``floor`` whenever a request's observed service time blows the latency
    budget (an oversized request monopolises its ring and starves the
    submission window), and doubles back after ``decay_after`` in-budget
    completions in a row."""

    #: per-request service-time budget
    LAT_BUDGET_NS = 100_000_000

    def __init__(self, floor: int, limit: int, decay_after: int = 4):
        self.floor = max(int(floor), 1)
        self.limit = max(int(limit), self.floor)
        self.decay_after = decay_after
        self._eff = self.limit
        self._streak = 0

    @property
    def effective(self) -> int:
        return self._eff

    def observe(self, service_ns: int) -> None:
        if service_ns > self.LAT_BUDGET_NS:
            self._streak = 0
            if self._eff > self.floor:
                self._eff = max(self._eff >> 1, self.floor)
        else:
            self._streak += 1
            if self._streak >= self.decay_after and self._eff < self.limit:
                self._eff = min(self._eff << 1, self.limit)
                self._streak = 0


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

class _Task:
    __slots__ = ("task_id", "pending", "frozen", "done", "errno_", "errmsg",
                 "result", "buf_handle", "t_submit", "trace_id", "deadline",
                 "expired", "write_verify", "verify_reqs", "verify_src",
                 "verify_dest", "cache_fill", "cache_invalidate",
                 "passthru")

    def __init__(self, task_id: int, deadline_s: float = 0.0):
        self.task_id = task_id
        self.pending = 1       # creator's reference, dropped after submit
        self.frozen = False    # submission loop done: no new references
        self.done = False      # a waiter may reap it (all refs dropped,
        #                        or the watchdog latched ETIMEDOUT)
        self.errno_ = 0
        self.errmsg = ""
        self.result: Optional[MemCopyResult] = None
        self.buf_handle: Optional[int] = None
        self.t_submit = time.monotonic_ns()
        self.trace_id = 0      # nonzero when the flight recorder traces it
        # watchdog deadline (monotonic seconds, 0 = none); an expired task
        # is latched ETIMEDOUT and its unstarted requests cancel
        self.deadline = (time.monotonic() + deadline_s) if deadline_s > 0 \
            else 0.0
        self.expired = False
        # (sink, requests, source view) read back at wait time under
        # write_verify
        self.write_verify: Optional[tuple] = None
        # native requests whose landed pages are checksum-verified at wait
        # time (checksum_verify), with their source and destination view
        self.verify_reqs: Optional[List["Request"]] = None
        self.verify_src: Optional["Source"] = None
        self.verify_dest: Optional[memoryview] = None
        # (source key, [(base, length, dest offset)], dest, logical scale,
        # source weakref): the misses that fill the RAM tier at wait time
        self.cache_fill: Optional[tuple] = None
        # (source key, extents) a write invalidates again at wait time
        self.cache_invalidate: Optional[tuple] = None
        # the passthrough channel of a task whose requests were split onto
        # the lane: the pools' direct leg reads their passthru_off through
        # it, and every rung that leaves the lane is counted
        self.passthru = None


#: the engine ladder, top rung first
_RUNGS = ("nvme_passthru", "io_uring", "threadpool", "python")

#: the most LBAs one NVMe READ carries: cdw12's NLB is 0-based in 16 bits
_NVME_MAX_NLB = 1 << 16


def _resolve_passthru_dev() -> Optional[str]:
    """The NVMe char device the passthrough rung opens: env
    ``NSTPU_PASSTHRU_DEV``, else the first match of config
    ``passthru_dev_glob`` (None on a host without one: the rung then
    refuses with ``nodev``)."""
    dev = os.environ.get("NSTPU_PASSTHRU_DEV")
    if dev:
        return dev
    import glob
    matches = sorted(glob.glob(str(config.get("passthru_dev_glob"))))
    return matches[0] if matches else None


def _member_path(source: "Source", member: int) -> Optional[str]:
    """The file path of one member of *source*, or None when the member
    has none (the blockmap needs a path)."""
    members = getattr(source, "members", None)
    if members:
        if 0 <= member < len(members):
            p = getattr(members[member], "path", None)
            return str(p) if p else None
        return None
    m = getattr(source, "_m", None)
    p = getattr(m, "path", None) if m is not None and member == 0 else None
    return str(p) if p else None


class _NativePassthruChannel:
    """The channel of a native engine on the passthrough rung: requests
    carrying ``passthru_off`` are flagged ``NSTPU_REQ_PASSTHRU`` at the
    native submit and become URING_CMD NVMe READs in the engine.  Not
    ``pool_ok``: the python pools have no char-device access, their
    recovery legs read O_DIRECT.

    The engine reads one namespace, the char device *dev*.  A member
    rides the lane only when sysfs places its file on that namespace
    (:func:`.blockmap.namespace_base`), at the partition's start added
    to FIEMAP's offsets.  Any other member is counted once per block
    device as ``nr_passthru_member_<reason>`` and read O_DIRECT."""

    pool_ok = False
    native = True

    def __init__(self, lba_shift: int, dev: str):
        self.lba_shift = lba_shift
        self.lba_size = 1 << lba_shift
        self.dev = dev
        self._bases: Dict[int, Optional[int]] = {}
        self._lock = threading.Lock()

    def device_base(self, path: str) -> Optional[int]:
        """The byte offset to add to *path*'s physical offsets on this
        channel's namespace, or None when the file is not on it."""
        try:
            devno = blockmap.file_devno(path)
        except OSError:
            return None
        with self._lock:
            if devno in self._bases:
                return self._bases[devno]
            base, reason = blockmap.namespace_base(path, self.dev)
            if base is not None and base % self.lba_size:
                base, reason = None, "otherdev"
            self._bases[devno] = base
        if base is None:
            stats.add("nr_passthru_member_" + reason)
            pr_warn("passthrough: %s is not on %s's namespace (%s); its "
                    "extents read O_DIRECT", path, self.dev, reason)
        return base


def _passthru_left_lane(task: "_Task", r: "Request") -> None:
    """A blockmap-resolved extent served off the passthrough lane (a
    mirror or buffered rung, a hedge win): counted, so the lane's share
    stays observable."""
    stats.add("nr_passthru_fallback")
    if _trace.active and task.trace_id:
        _trace.instant("passthru_fallback", tid=task.trace_id,
                       member=r.member, offset=r.file_off, length=r.length,
                       args={"reason": "ladder"})


#: the live sessions whose engine counters the stats exporter folds before
#: each publish (weak: the exporter never keeps a closed session alive)
_live_sessions: "weakref.WeakSet" = weakref.WeakSet()


def _fold_live_native_stats() -> None:
    """The exporter's fold (:attr:`.stats.Stats.export_fold`): each live
    Session's native counter deltas into :data:`stats`, under the
    Session's fold lock, so an engine that :meth:`Session.close` is
    destroying is never read."""
    for sess in list(_live_sessions):
        try:
            with sess._fold_lock:
                if sess._native is not None and not sess._closed:
                    sess._fold_native_stats()
        except Exception:   # noqa: BLE001 - observability, not control
            pass


stats.export_fold = _fold_live_native_stats


class Session:
    """Engine session: buffer registry + task table + error retention.

    ``device`` is where loaded bytes go next: with a CUDA device every
    buffer :meth:`alloc_dma_buffer` hands out is registered with the CUDA
    runtime.  ``io_backend`` (default: config) picks the top rung of the
    engine ladder — ``io_uring``, then the native ``threadpool``, then the
    ``python`` pool; ``auto`` starts where config ``engine_backend`` says,
    and its ``auto`` and ``passthru`` start on the NVMe passthrough rung.
    A passthrough refusal is counted ``nr_passthru_refusal_<reason>``;
    under ``auto`` the ladder then goes on below it silently, under
    ``passthru`` it counts ``nr_passthru_fallback`` too.  Each step down
    from io_uring is logged with its errno, counted in
    ``nr_backend_fallback`` and named by :attr:`backend_name`; with
    ``io_fallback`` off the first refusal raises (a passthrough one only
    when demanded).  A failed build of the engine always raises.  Failed
    tasks are retained until a wait reaps them, and force-reaped at
    :meth:`close` (reference
    ``strom_proc_release``, kmod/nvme_strom.c:2138-2166).

    Each session owns its fault state: a retry policy read from config at
    open, the members' health machine (``_member_health``), the
    dirty-extent journal (``_resync``), a watchdog thread and a canary
    thread; both threads stop at :meth:`close`.

    Construction also re-reads the residency tiers' capacities and the
    integrity mode from config, and starts the scrubber thread, which
    stops at :meth:`close` too.  The tiers are process-wide, so a
    Session's ``device`` is not where the HBM tier places extents: that
    is the tier's own (``cuda:0`` unless
    :meth:`.tiering.ExtentSpace.configure` names another)."""

    def __init__(self, *, max_workers: Optional[int] = None, device=None,
                 io_backend: Optional[str] = None):
        self.device = device
        self._buffers: Dict[int, Tuple[memoryview, BufferInfo]] = {}
        self._buf_lock = threading.Condition(threading.Lock())
        self._next_handle = 1
        self._tasks: Dict[int, _Task] = {}
        self._task_cv = threading.Condition(threading.Lock())
        self._next_task = 1
        self._closed = False
        # trace_policy is read here, once: event sites then cost one
        # `_trace.active` test when tracing is off
        _trace.configure()
        # the tiers' capacities and the integrity mode are read here too:
        # the hit and fill sites then cost one branch each when off
        _tiers.configure()
        _integrity.configure()
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or min(int(config.get("queue_depth")),
                                           32),
            thread_name_prefix="strom-io")
        self._abandon_native = False
        self._members_used: set = set()
        # io_uring fixed-buffer registrations: id(backing) -> (slot or -1,
        # backing, close callback)
        self._fixed_regs: Dict[int, tuple] = {}
        self._fixed_lock = threading.Lock()
        # the self-driving data path: `autotune` / `readahead` are read
        # here, and the sites test `self._tuner.enabled` / `.ra_active`
        # (one branch each when off).  It hosts the adaptive sizers (one a
        # stripe member; single files: member 0), so the effective cap has
        # one writer; its thread starts once the backend is final
        self._tuner = AutoTuner(self)
        self._chunk_sizers: Dict[int, AdaptiveChunkSizer] = \
            self._tuner.chunk_sizers
        # lane scale-out: one-shot at the first striped submit; engines
        # swapped out stay alive until close so in-flight waits complete
        # against the engine that accepted them
        self._lane_lock = threading.Lock()
        self._lanes_sized = False
        self._old_engines: List[object] = []
        #: errno io_uring_setup refused with when the ladder stepped past
        #: io_uring (0: not refused)
        self.uring_errno = 0
        #: lanes the last NUMA pass pinned (:meth:`_pin_lanes`)
        self.lanes_pinned = 0
        # the fault ladder: retry policy, member health, the journal of
        # extents a degraded member missed (replayed by the canary thread
        # before the machine lets it back to HEALTHY), per-member python
        # pools, the canary's striped sources (weak: a probe never keeps
        # a closed source alive), the watchdog and the canary threads
        self._retry = RetryPolicy.from_config()
        self._member_health = MemberHealthMachine()
        self._retry_rng = random.Random(os.getpid() ^ id(self))
        self._resync = DirtyExtentJournal()
        self._member_health.attach_resync(self._resync)
        self._member_pools: Dict[int, ThreadPoolExecutor] = {}
        # st_dev -> whether mincore(2) there sees an eviction (_arbitrate)
        self._probe_sighted: Dict[int, bool] = {}
        self._canary_sources: "weakref.WeakSet" = weakref.WeakSet()
        self._canary_buf: Optional[mmap.mmap] = None
        self._canary_stop = threading.Event()
        self._watchdog_stop = threading.Event()
        # the passthrough rung: the char device it opened, and the native
        # channel when the engine came up on it
        self._passthru_dev: Optional[str] = None
        self._pt_channel: Optional[_NativePassthruChannel] = None
        self._fold_lock = threading.RLock()
        self._native = self._open_engine(io_backend
                                         or config.get("io_backend"))
        self.backend_name = (self._native.backend_name if self._native
                             else "python")
        stats.set_backend(self.backend_name)
        # an unmodified workload is visible to `gpu_stat -l` / `-p PID`
        # (STROM_STAT_EXPORT=0 opts out), its engine's counters folded in
        # before each publish (stats.export_fold)
        stats.default_export_start()
        _live_sessions.add(self)
        if _trace.active and self._native is not None:
            # the engine's per-lane rings measure each request's device
            # window; _await_native drains them into the recorder
            self._native.trace_enable(True)
        self._watchdog = threading.Thread(target=self._watchdog_loop,
                                          daemon=True,
                                          name="strom-task-watchdog")
        self._watchdog.start()
        self._canary = threading.Thread(target=self._canary_loop,
                                        daemon=True, name="strom-canary")
        self._canary.start()
        # the resident extents' scrubber: idles on one wait a tick while
        # scrub_bytes_per_sec is 0 or the integrity domain is off
        self._scrubber = Scrubber(self)
        self._tuner.start()

    # -- the engine ladder --------------------------------------------------
    def _open_engine(self, want: str):
        """The native engine on the highest rung that comes up, or None
        for the python pool."""
        if want not in ("auto", *_RUNGS[1:]):
            # the passthrough rung is config engine_backend's to ask for
            raise StromError(_errno.EINVAL, f"io_backend {want!r} is not one "
                                            f"of auto|{'|'.join(_RUNGS[1:])}")
        if want == "python":
            return None
        eng_backend = config.get("engine_backend")
        top = want if want in ("io_uring", "threadpool") else \
            {"auto": "nvme_passthru", "passthru": "nvme_passthru",
             "uring": "io_uring", "threadpool": "threadpool"}[eng_backend]
        from . import _native
        _native._load()        # a failed build raises, whatever the rung
        fallback = bool(config.get("io_fallback"))
        rungs = _RUNGS[_RUNGS.index(top):]
        for rung, below in zip(rungs, rungs[1:]):
            if rung == "nvme_passthru":
                eng = self._open_passthru(_native, eng_backend == "passthru",
                                          fallback)
                if eng is not None:
                    return eng
                continue
            try:
                return _native.NativeEngine(
                    rung, int(config.get("queue_depth")),
                    rings=max(int(config.get("engine_rings")), 1))
            except StromError as e:
                err = e.errno
                if rung == "io_uring":
                    err = _native.uring_probe() or e.errno
                    self.uring_errno = err
                if not fallback:
                    raise StromError(err, f"{rung} engine refused "
                                          f"({os.strerror(err)}) and "
                                          f"io_fallback is off") from None
                stats.add("nr_backend_fallback")
                pr_warn("%s engine refused (errno %d: %s); falling back to "
                        "the %s backend", rung, err, os.strerror(err), below)
        return None

    def _open_passthru(self, nat, demanded: bool, fallback: bool):
        """The passthrough rung: an engine on it (and the native channel,
        with the LBA geometry the split needs), or None with the refusal
        counted by reason, as the JAX package counts it.  A demanded rung
        (``engine_backend=passthru``) counts ``nr_passthru_fallback`` and,
        with ``io_fallback`` off, raises; under ``auto`` the ladder steps
        on below it."""
        self._passthru_dev = _resolve_passthru_dev()
        # the probe the engine's create runs, first: a host without the
        # device (or with NSTPU_DISABLE_PASSTHRU) creates no engine here
        reason = nat.passthru_probe(self._passthru_dev)
        if reason >= 0:
            try:
                eng = nat.NativeEngine(
                    "nvme_passthru", int(config.get("queue_depth")),
                    rings=max(int(config.get("engine_rings")), 1),
                    passthru_dev=self._passthru_dev)
            except StromError:
                reason = nat.passthru_refusal(self._passthru_dev)
            else:
                # the probe's LBA shift is the split's geometry
                self._pt_channel = _NativePassthruChannel(
                    reason, self._passthru_dev)
                return eng
        name = nat.PASSTHRU_REASONS.get(reason, "nodev")
        stats.add("nr_passthru_refusal_" + name)
        if _trace.active:
            _trace.instant("passthru_fallback", args={"reason": name})
        if demanded:
            if not fallback:
                raise StromError(_errno.ENODEV,
                                 f"nvme passthrough rung refused ({name}) "
                                 f"and io_fallback is off")
            stats.add("nr_passthru_fallback")
            pr_warn("nvme passthrough rung refused (%s); falling back down "
                    "the ladder", name)
        return None

    # -- the passthrough lane ---------------------------------------------
    def _passthru_channel(self, source: Source):
        """The channel a task on *source* splits through: None when config
        ``engine_backend`` pins a lower rung (the plain path, no counter
        moves), else the source's own (the emulator attaches one), else
        the native channel when the engine came up on the rung."""
        if config.get("engine_backend") in ("uring", "threadpool"):
            return None
        chan = getattr(source, "passthru_channel", None)
        if chan is not None:
            return chan
        return self._pt_channel

    def _passthru_split(self, task: _Task, source: Source,
                        reqs: List[Request], chan,
                        remap: Dict[int, int]) -> List[Request]:
        """Split planned requests onto the passthrough lane, per extent:
        each plain direct request whose span the blockmap resolves to
        LBA-aligned device ranges becomes one sub-request a physical run
        carrying ``passthru_off``, each at most 65536 LBAs (one NVMe READ:
        cdw12's 0-based NLB is 16 bits, and data_len 32); everything else
        (buffered pieces, vectored stripe merges, members read from their
        mirror, unresolved or ineligible spans, files that are not on
        the channel's namespace) rides the O_DIRECT lanes of the same task
        untouched.  A channel's ``device_base(path)`` is added to the
        blockmap's offsets (None: the file is not on its device)."""
        out: List[Request] = []
        lba = chan.lba_size
        cap = min(_NVME_MAX_NLB, ((1 << 32) - 1) // lba) * lba
        for r in reqs:
            if r.buffered or r.dest_segs or r.passthru_off is not None \
                    or r.member in remap:
                out.append(r)
                continue
            path = _member_path(source, r.member)
            base = chan.device_base(path) if path is not None else None
            runs = blockmap.resolve_split(path, r.file_off, r.length, lba) \
                if base is not None else [(r.file_off, r.length, None)]
            if all(dev is None for _f, _l, dev in runs):
                stats.add("nr_passthru_refused_extent")
                if _trace.active and task.trace_id:
                    _trace.instant("passthru_refuse", tid=task.trace_id,
                                   member=r.member, offset=r.file_off,
                                   length=r.length)
                out.append(r)
                continue
            for foff, ln, dev_off in runs:
                doff = r.dest_off + (foff - r.file_off)
                if dev_off is None:
                    stats.add("nr_passthru_refused_extent")
                    if _trace.active and task.trace_id:
                        _trace.instant("passthru_refuse",
                                       tid=task.trace_id, member=r.member,
                                       offset=foff, length=ln)
                    out.append(Request(member=r.member, file_off=foff,
                                       length=ln, dest_off=doff))
                    continue
                stats.add("bytes_passthru", ln)
                for k in range(0, ln, cap):
                    out.append(Request(member=r.member, file_off=foff + k,
                                       length=min(cap, ln - k),
                                       dest_off=doff + k,
                                       passthru_off=base + dev_off + k))
        return out

    # -- buffers -----------------------------------------------------------
    def alloc_dma_buffer(self, length: int, *, numa_node: int = -1
                         ) -> Tuple[int, DmaBuffer]:
        """ALLOC_DMA_BUFFER: a new pinned buffer (placed on *numa_node*),
        mapped (and registered with the native engine as a fixed buffer);
        returns ``(handle, buffer)``."""
        buf = DmaBuffer(length, numa_node=numa_node)
        if self.device is not None and str(self.device).startswith("cuda"):
            buf.pin_cuda()
        return self.map_buffer(buf.view(), kind="pinned_host",
                               backing=buf), buf

    def map_buffer(self, view: memoryview, *, kind: str = "user",
                   backing: object = None) -> int:
        """Map *view* for memcpy commands.  A ``pinned_host`` view backed
        by a :class:`DmaBuffer` is registered with the native engine as an
        io_uring fixed buffer, once per buffer."""
        view = view.cast("B")
        if (kind == "pinned_host" and self._native is not None
                and isinstance(backing, DmaBuffer)):
            self._register_fixed(backing)
        with self._buf_lock:
            handle = self._next_handle
            self._next_handle += 1
            self._buffers[handle] = (view, BufferInfo(
                handle=handle, length=len(view), page_size=PAGE_SIZE,
                n_pages=(len(view) + PAGE_SIZE - 1) // PAGE_SIZE,
                owner_uid=os.getuid(), refcount=0, kind=kind))
        return handle

    def _register_fixed(self, backing: DmaBuffer) -> None:
        """Register *backing* as an io_uring fixed buffer, once per buffer
        per session (reference ``_register_fixed``, the PRP-pool analog).
        The buffer's own close releases it first, before its CUDA
        unregistration and munmap.  A refusal (threadpool backend, kernel,
        RLIMIT_MEMLOCK) is kept as slot -1: requests into the buffer take
        the plain opcode."""
        key = id(backing)
        with self._fixed_lock:
            if key in self._fixed_regs:
                return
            slot = self._native.buf_register(backing.addr, backing.length)
            cb = lambda: self._unregister_fixed(key)  # noqa: E731
            self._fixed_regs[key] = (-1 if slot is None else slot,
                                     backing, cb)
        if not backing.on_close(cb):
            self._unregister_fixed(key)

    def _unregister_fixed(self, key: int) -> None:
        with self._fixed_lock:
            entry = self._fixed_regs.pop(key, None)
            if entry and entry[0] >= 0 and self._native is not None:
                self._native.buf_unregister(entry[0])

    def is_fixed(self, backing: DmaBuffer) -> bool:
        """True when *backing* rides io_uring fixed-buffer reads."""
        with self._fixed_lock:
            entry = self._fixed_regs.get(id(backing))
            return entry is not None and entry[0] >= 0

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

    def unmap_buffer(self, handle: int, *, wait: bool = True,
                     timeout: float = 30.0) -> None:
        """Unmap, blocking until in-flight DMA into the buffer drains (the
        reference's revocation callback, kmod/pmemmap.c:149-208); a task
        the watchdog failed still holds its buffer until its last request
        returns.  ``wait=False`` raises EBUSY instead of waiting."""
        deadline = time.monotonic() + timeout
        with self._buf_lock:
            while True:
                if handle not in self._buffers:
                    raise StromError(_errno.ENOENT,
                                     f"no mapped buffer {handle}")
                if self._buffers[handle][1].refcount == 0:
                    del self._buffers[handle]
                    return
                if not wait:
                    raise StromError(_errno.EBUSY, f"buffer {handle} has "
                                                   f"in-flight DMA")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise StromError(_errno.ETIMEDOUT,
                                     f"buffer {handle} busy")
                self._buf_lock.wait(remaining)

    def list_buffers(self) -> List[int]:
        """Handles of the mapped buffers (LIST_GPU_MEMORY analog)."""
        with self._buf_lock:
            return sorted(self._buffers)

    def info_buffer(self, handle: int) -> BufferInfo:
        with self._buf_lock:
            try:
                return self._buffers[handle][1]
            except KeyError:
                raise StromError(_errno.ENOENT,
                                 f"no mapped buffer {handle}") from None

    # -- tasks -------------------------------------------------------------
    def _create_task(self) -> _Task:
        deadline_s = float(config.get("task_deadline_s"))
        with self._task_cv:
            task = _Task(self._next_task, deadline_s)
            self._next_task += 1
            self._tasks[task.task_id] = task
        if _trace.active:
            task.trace_id = _trace.task_begin(task.task_id)
        return task

    # -- the watchdog and the canary ------------------------------------------
    def _watchdog_loop(self) -> None:
        """Latch ETIMEDOUT on a task running past its deadline: its
        waiters wake at once, its unstarted requests cancel, and a pool
        thread awaiting its native batch lets go (``_await_native``).  The
        requests in flight still hold the task's buffer, so no pinned
        buffer is unmapped under a copy."""
        while not self._watchdog_stop.wait(0.05):
            now = time.monotonic()
            expired: List[str] = []
            with self._task_cv:
                for task in self._tasks.values():
                    if task.done or not task.deadline or now <= task.deadline:
                        continue
                    task.expired = True
                    if task.errno_ == 0:
                        task.errno_ = _errno.ETIMEDOUT
                        task.errmsg = (
                            f"dma task {task.task_id} exceeded its "
                            f"{config.get('task_deadline_s')} s deadline "
                            f"({task.pending} references outstanding)")
                        stats.add("nr_task_timeout")
                        if _trace.active and task.trace_id:
                            _trace.instant("task_timeout", tid=task.trace_id,
                                           args={"pending": task.pending})
                    task.done = True
                    expired.append(task.errmsg)
                if expired:
                    self._task_cv.notify_all()
            for msg in expired:
                pr_warn("watchdog: %s", msg)

    def _canary_loop(self) -> None:
        """Every ``canary_interval_s``: replay what REJOINING members owe
        the journal, then one small direct read of each FAILED or
        REJOINING member of every striped source seen (FAILED answering
        moves to REJOINING; successes warm a rejoiner to HEALTHY)."""
        while True:
            interval = float(config.get("canary_interval_s"))
            if self._canary_stop.wait(interval if interval > 0 else 0.5):
                return
            if interval <= 0:
                continue
            cands = self._member_health.canary_candidates()
            if not cands:
                continue
            self._resync_replay(cands)
            for src in list(self._canary_sources):
                nmem = len(getattr(src, "members", ()))
                for m in cands:
                    if m >= nmem or self._canary_stop.is_set():
                        continue
                    self._canary_probe(src, m)

    def _canary_probe(self, source: Source, member: int) -> None:
        """One canary: a direct read of up to a page at member offset 0
        into a page-aligned scratch."""
        try:
            size = getattr(source.members[member], "size", 0)
            blk = max(int(getattr(source, "block_size", 512)), 512)
            length = min(PAGE_SIZE, size // blk * blk)
            if length <= 0:
                return
            if self._canary_buf is None:
                self._canary_buf = mmap.mmap(-1, PAGE_SIZE)
            source.read_member_direct(
                member, 0, memoryview(self._canary_buf)[:length])
        except (StromError, OSError) as e:
            if getattr(e, "errno", None) == _errno.EBADF:
                return      # the source closed under the prober
            self._member_health.record_canary(member, False)
        except Exception:   # noqa: BLE001 - a probe never kills the thread
            return
        else:
            self._member_health.record_canary(member, True)

    # -- the dirty-extent journal -------------------------------------------
    def _journal_skipped(self, sink: Source, member: int, file_off: int,
                         length: int, trace_id: int = 0) -> None:
        """Journal an extent a degraded member missed (the write landed
        on its partner only)."""
        self._resync.record(sink, member, file_off, length)
        if _trace.active:
            _trace.instant("resync_skip", tid=trace_id, member=member,
                           offset=file_off, length=length)

    def _resync_replay(self, members: Sequence[int]) -> None:
        """Replay the journal onto REJOINING members, mirror → rejoiner,
        one rejoin token an extent; a failed replay puts the extent back
        and debits the member that failed."""
        health, jrn = self._member_health, self._resync
        for member in members:
            if member not in jrn.members() or \
                    health.state(member) is not HealthState.REJOINING:
                continue
            for ref in jrn.sink_refs(member):
                sink = ref()
                if sink is None:
                    continue
                mirror = sink.mirror_of(member)
                if mirror is None:      # nothing to replay from
                    jrn.drop_sink(ref)
                    continue
                while not self._canary_stop.is_set():
                    if not health.take_rejoin_token(member):
                        break           # budget spent: the next tick
                    ext = jrn.take_extent(ref, member)
                    if ext is None:
                        break
                    if not self._replay_extent(sink, mirror, member, *ext):
                        break

    def _replay_extent(self, sink: Source, mirror: int, member: int,
                       file_off: int, length: int) -> bool:
        """One journaled extent, read from *mirror* and written to
        *member* through a page-aligned scratch (aligned spans on the
        direct legs, the rest buffered).  False when replay must pause."""
        t0 = time.monotonic_ns()
        sz = (max(length, PAGE_SIZE) + PAGE_SIZE - 1) // PAGE_SIZE * PAGE_SIZE
        scratch = mmap.mmap(-1, sz)
        buf = memoryview(scratch)[:length]
        bs = max(int(getattr(sink, "block_size", 512)), 512)
        aligned = file_off % bs == 0 and length % bs == 0
        try:
            for who, leg in ((mirror, "read"), (member, "write")):
                try:
                    if leg == "read":
                        (sink.read_member_direct if aligned
                         else sink.read_member_buffered)(mirror, file_off,
                                                         buf)
                    else:
                        (sink.write_member_direct if aligned
                         else sink.write_member_buffered)(member, file_off,
                                                          buf)
                except (StromError, OSError) as e:
                    if getattr(e, "errno", None) == _errno.EBADF:
                        return False    # the sink closed under the replay
                    se = _as_strom(e)
                    self._member_health.record_failure(
                        who, fatal=se.error_class is ErrorClass.PERSISTENT)
                    stats.member_error(who)
                    self._resync.put_back(sink, member, file_off, length)
                    return False
                except Exception:   # noqa: BLE001 - the debt must survive
                    self._resync.put_back(sink, member, file_off, length)
                    return False
        finally:
            buf.release()
            scratch.close()
        stats.add("nr_resync_extent")
        stats.member_add(member, length, time.monotonic_ns() - t0)
        if _trace.active:
            _trace.span("resync", t0, time.monotonic_ns(), member=member,
                        offset=file_off, length=length,
                        args={"mirror": mirror})
        return True

    def _task_get(self, task: _Task) -> None:
        with self._task_cv:
            if task.frozen:
                raise StromError(_errno.EINVAL, "reference taken on a "
                                                "frozen task")
            task.pending += 1

    def _task_put(self, task: _Task, err: Optional[StromError] = None) -> None:
        latched = None
        with self._task_cv:
            if err is not None and task.errno_ == 0:
                task.errno_, task.errmsg = err.errno, str(err)   # first wins
                latched = err
            task.pending -= 1
            finished = task.pending == 0
            if finished:
                task.done = True
                self._task_cv.notify_all()
        if latched is not None:
            if _trace.active and task.trace_id:
                _trace.instant("task_failed", tid=task.trace_id,
                               args={"errno": latched.errno,
                                     "error": str(latched)[:160]})
            pr_warn("dma task %d latched error: %s", task.task_id, latched)
        if finished:
            stats.add("nr_ssd2dev")
            if task.buf_handle is not None:
                self._put_buffer(task.buf_handle)

    def memcpy_wait(self, task_id: int,
                    timeout: Optional[float] = None) -> MemCopyResult:
        """MEMCPY_WAIT: block until the task completes, then reap it.
        Raises the latched first error of a failed task."""
        t0 = time.monotonic_ns()
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
        # the reference's MEMCPY_WAIT ioctl count and clock (a reaped task,
        # failed or not)
        stats.add("nr_ioctl_memcpy_wait")
        stats.add("clk_ioctl_memcpy_wait", time.monotonic_ns() - t0)
        if _trace.active and task.trace_id:
            _trace.span("wait", t0, time.monotonic_ns(), tid=task.trace_id,
                        args=({"errno": task.errno_} if task.errno_
                              else None))
        if task.errno_:
            if _trace.active:
                # the flight-recorder moment: what the engine did just
                # before this task latched
                _trace.dump_on_failure(f"task {task_id} errno {task.errno_}")
            raise StromError(task.errno_, task.errmsg or "async DMA failed")
        if task.verify_reqs:
            # the native engine read straight into the destination: its
            # pages are checked here, on the retired task, off the
            # submission path, with the pools' re-read-then-EBADMSG ladder
            reqs, task.verify_reqs = task.verify_reqs, None
            for r in reqs:
                self._verify_request_checksums(task, task.verify_src, r,
                                               task.verify_dest)
        if task.cache_fill is not None:
            # the misses fill the RAM tier here, once the fault ladder
            # (retry, hedge, mirror, checksum re-read) healed their bytes,
            # so a degraded member still fills it through its mirror; a
            # latched failure raised above and fills nothing
            skey, fills, fdest, lscale, src_ref, spec = task.cache_fill
            task.cache_fill = None
            for base, length, doff in fills:
                tf0 = time.monotonic_ns()
                if _tiers.fault_fill(skey, base, length,
                                     fdest[doff:doff + length],
                                     logical_length=int(length * lscale),
                                     source_ref=src_ref, speculative=spec) \
                        and _trace.active and task.trace_id:
                    _trace.span("cache_fill", tf0, time.monotonic_ns(),
                                tid=task.trace_id, offset=base,
                                length=length)
        if task.cache_invalidate is not None:
            # the write path's invalidation again, after the write retired:
            # a racing read may have filled a written extent from the
            # bytes before the write
            skey, extents = task.cache_invalidate
            task.cache_invalidate = None
            _tiers.invalidate_extents(skey, extents)
        if task.write_verify is not None:
            # write_verify: the retired write legs read back here, off the
            # submission path; a torn or misdirected write raises EBADMSG
            wsink, wreqs, wsrc = task.write_verify
            task.write_verify = None
            self._verify_writes(wsink, wreqs, wsrc, task)
        return task.result

    def pending_tasks(self) -> List[int]:
        """Ids of the tasks still in the table: running, or failed and not
        reaped yet."""
        with self._task_cv:
            return sorted(self._tasks)

    def _abort_submit(self, task: _Task, buf_handle: int) -> None:
        """A submit raised midway: latch ECANCELED, wait out what was
        already submitted (reference :1781-1784), drop the buffer ref."""
        self._task_put(task, StromError(_errno.ECANCELED, "submit aborted"))
        try:
            self.memcpy_wait(task.task_id, timeout=30.0)
        except StromError:
            pass
        self._put_buffer(buf_handle)

    def _finish_submit(self, task: _Task, result: MemCopyResult,
                       buf_handle: int) -> MemCopyResult:
        task.result = result
        with self._task_cv:
            task.frozen = True
        task.buf_handle = buf_handle
        self._task_put(task)      # creator ref; completion drops the buffer
        return result

    # -- reads -------------------------------------------------------------
    def _arbitrate(self, source: Source, chunk_ids: List[int],
                   spans: List[Tuple[int, int]]
                   ) -> Tuple[List[int], List[int]]:
        """Page-cache arbitration of one task (reference :1639-1663):
        ``(direct chunk ids, write-back chunk ids)``.  A hot or dirty
        chunk, or one cached above ``cache_threshold``, goes write-back.

        A filesystem whose probe cannot see an eviction (mincore(2) still
        reports a page resident after fadvise DONTNEED dropped it, as
        under gVisor) would send every chunk write-back: the first task on
        a device whose chunks all read fully resident checks that, once a
        Session, and on a blind device every chunk stays direct
        (``nr_arb_blind`` counts those tasks)."""
        if not config.get("cache_arbitration"):
            return chunk_ids, []
        fm = source.probe_file()
        dev = fm.st_dev if fm is not None else None
        if fm is not None and self._probe_sighted.get(dev) is False:
            stats.add("nr_arb_blind")
            return chunk_ids, []
        res = source.residency(spans)
        if fm is not None and dev not in self._probe_sighted:
            if any(cached < 1.0 for cached, _hot in res):
                self._probe_sighted[dev] = True
            else:
                seen = fm.probe_sees_eviction()
                if seen is not None:
                    self._probe_sighted[dev] = seen
                if seen is False:
                    stats.add("nr_arb_blind")
                    return chunk_ids, []
        threshold = float(config.get("cache_threshold"))
        direct_ids, wb_ids = [], []
        # a hot or dirty chunk is decisive: the reference scores one dirty
        # page at threshold + 1 (:1643)
        for cid, (cached, hot) in zip(chunk_ids, res):
            if hot > 0.0 or cached > threshold:
                wb_ids.append(cid)
            else:
                direct_ids.append(cid)
        return direct_ids, wb_ids

    def memcpy_ssd2ram(self, source: Source, buf_handle: int,
                       chunk_ids: Sequence[int], chunk_size: int, *,
                       dest_offset: int = 0,
                       wb_buffer: Optional[memoryview] = None,
                       speculative: bool = False) -> MemCopyResult:
        """MEMCPY_SSD2RAM: plan and submit asynchronously.  A chunk at or
        beyond EOF is EINVAL; a single-chunk task needs only the chunk's
        true length, which may be a partial file tail.

        With config ``cache_arbitration`` one residency probe of the task
        sends each chunk that is hot or dirty, or cached above
        ``cache_threshold``, through the write-back leg (reference
        :1639-1663).  The result's ``chunk_ids`` lists the direct chunks
        first, then the write-back ones (``nr_ram2dev`` of them), and slot
        *i* at ``dest_offset + i*chunk_size`` holds ``chunk_ids[i]``.  A
        write-back chunk is copied from the page cache synchronously,
        after the direct requests are submitted, into the destination, or
        tail-packed into *wb_buffer* from its offset 0 when one is given
        (the SSD2GPU contract, :1647-1663).

        With a residency tier on, each chunk is first looked up in the
        unified extent space (HBM, then RAM): a hit takes a lease, skips
        arbitration and the lanes, and is copied out of its tier after the
        write-back chunks, into the slots after theirs (``nr_ram2dev``
        counts write-back chunks and hits).  A hit whose extent was
        invalidated between the lookup and the copy is read buffered.
        Each direct miss fills the RAM tier at wait time.

        The direct chunks are planned and submitted in slices
        (:func:`_window_chunks`), so the first slice's I/O is in flight
        while later slices are planned.  On the native engine each slice
        is one batch (coalesced up to the member's adaptive cap, one lane
        a member; a member the health machine routes away is read from
        its mirror's fd and lane), awaited in a pool thread; misaligned
        pieces are read buffered, synchronously, before the call returns.
        On the python pools each request walks the fault ladder.

        ``speculative`` marks a readahead prefetch: no tier lookup (the
        issuer checked residency), no predictor training, and its fills
        carry the tier's speculative provenance."""
        t0 = time.monotonic_ns()
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
        task = self._create_task()
        if _trace.active and task.trace_id:
            _trace.instant("submit", tid=task.trace_id, ts_ns=t0,
                           length=n * chunk_size,
                           args={"task": task.task_id, "chunks": n})
        cache_hits: List[tuple] = []   # (cid, base, length, lease, hbm)
        try:
            spans = []
            for cid in chunk_ids:
                base = cid * chunk_size
                if base >= source.size:
                    raise StromError(_errno.EINVAL, f"chunk {cid} beyond EOF")
                spans.append((base, min(chunk_size, source.size - base)))
            if self._tuner.ra_active and not speculative:
                # readahead training: every demand span, a wholly
                # resident one too, so a warm stream keeps its model
                self._tuner.observe_submit(source, chunk_size, chunk_ids)
            # -- the residency tiers: one top-down lookup a chunk (HBM
            #    outranks RAM); a hit holds a lease until it is served,
            #    only the misses go on to arbitration and the lanes ------
            skey = None
            miss_ids, miss_spans = chunk_ids, spans
            if _tiers.lookup_active and not speculative:
                skey = _tiers.source_key(source)
                miss_ids, miss_spans = [], []
                nr_hbm = 0
                for cid, (base, length) in zip(chunk_ids, spans):
                    hit = _tiers.lookup(skey, base, length)
                    if hit is None:
                        miss_ids.append(cid)
                        miss_spans.append((base, length))
                        continue
                    lease, tname = hit
                    nr_hbm += tname == "hbm"
                    cache_hits.append((cid, base, length, lease,
                                       tname == "hbm"))
                if nr_hbm:
                    stats.add("nr_hbm_hit", nr_hbm)
                if len(cache_hits) > nr_hbm:
                    stats.add("nr_cache_hit", len(cache_hits) - nr_hbm)
                if cache_hits:
                    stats.add("bytes_cache_hit",
                              sum(h[2] for h in cache_hits))
                if miss_ids:
                    stats.add("nr_cache_miss", len(miss_ids))
                if not _tiers.fill_active:
                    skey = None      # no RAM tier: nothing fills at wait
            elif speculative and _tiers.fill_active:
                # a prefetch: no lookup, but its misses fill at wait time
                skey = _tiers.source_key(source)
            hit_ids = [h[0] for h in cache_hits]
            direct_ids, wb_ids = self._arbitrate(source, miss_ids,
                                                 miss_spans) \
                if miss_ids else ([], [])
            if len(getattr(source, "members", ())) > 1:
                # a striped source becomes a canary target: its FAILED
                # members are probed, its journal replayed
                self._canary_sources.add(source)
            use_native = (self._native is not None and bool(direct_ids)
                          and type(source).read_member_direct
                          is Source.read_member_direct)
            if use_native:
                self._ensure_member_lanes(source)
            dma_max = int(config.get("dma_max_size"))
            window = max(int(config.get("submit_window")), 1)
            if self._tuner.enabled:
                # the tuned request cap (inside dma_max_size's bounds) and
                # window; the window still goes through _window_chunks
                dma_max = self._tuner.dma_cap(dma_max)
                window = max(self._tuner.submit_window(window), 1)
            # coalescing beyond dma_max is the native queue's lever; the
            # pool path keeps per-extent planning so the ladder sees every
            # extent
            climit = int(config.get("coalesce_limit")) if use_native else 0
            if climit and config.get("chunk_adaptive"):
                nmem = len(getattr(source, "members", ())) or 1
                climit = ({m: self._adaptive_cap(dma_max, climit, m)
                           for m in range(nmem)} if nmem > 1
                          else self._adaptive_cap(dma_max, climit))
            window = _window_chunks(chunk_size, window)
            entries = [(cid, i) for i, cid in enumerate(direct_ids)]
            fds = source.member_fds() if use_native else None
            # degraded striping on the native path: a member routed away
            # (QUARANTINED, FAILED, or a rejoiner still owing resync) reads
            # through its mirror's fd and lane at direct speed
            remap: Dict[int, int] = {}
            if use_native:
                health = self._member_health
                for m in range(len(fds)):
                    if health.routes_away(m):
                        mir = source.mirror_of(m)
                        if mir is not None and not health.routes_away(mir):
                            remap[m] = mir
            # the passthrough split: one channel a task, and it must suit
            # the executing path (native batches need the engine's own
            # rung, the python pools a channel that serves them)
            pt_chan = self._passthru_channel(source) if direct_ids else None
            if pt_chan is not None and not getattr(
                    pt_chan, "native" if use_native else "pool_ok", False):
                pt_chan = None
            task.passthru = pt_chan
            native_failed = False
            verify = bool(config.get("checksum_verify"))
            for w in range(0, len(entries), window):
                tp0 = time.monotonic_ns()
                reqs = plan_requests(source, entries[w:w + window],
                                     chunk_size, dest_offset,
                                     dma_max_size=dma_max,
                                     coalesce_limit=climit or None)
                tp1 = time.monotonic_ns()
                stats.count_clock("setup_prps", tp1 - tp0)
                if _trace.active and task.trace_id:
                    _trace.span("plan", tp0, tp1,
                                tid=task.trace_id,
                                args={"window": w // window,
                                      "requests": len(reqs)})
                if pt_chan is not None:
                    reqs = self._passthru_split(task, source, reqs, pt_chan,
                                                remap)
                if not use_native or native_failed:
                    self._submit_pool_requests(task, source, reqs, dest)
                    continue
                native_reqs, native_members, native_rs = [], [], []
                native_pt: List[bool] = []
                for r in reqs:
                    if r.buffered or fds[r.member] < 0:
                        # misaligned pieces: a synchronous buffered copy,
                        # like the reference's in-ioctl page-cache memcpy
                        tb = time.monotonic_ns()
                        source.read_member_buffered(
                            r.member, r.file_off,
                            dest[r.dest_off:r.dest_off + r.length])
                        stats.member_add(r.member, r.length,
                                         time.monotonic_ns() - tb)
                        stats.add("total_dma_length", r.length)
                        if verify:
                            # synchronous legs are checked here: only the
                            # native batches reach the wait-time check
                            self._verify_request_checksums(
                                task, source, r, dest, buffered=True)
                        continue
                    m_eff = remap.get(r.member, r.member)
                    if m_eff != r.member:
                        stats.add("nr_mirror_read")
                        if _trace.active and task.trace_id:
                            _trace.instant("mirror_read", tid=task.trace_id,
                                           member=r.member,
                                           offset=r.file_off,
                                           length=r.length,
                                           args={"mirror": m_eff})
                    if r.passthru_off is not None:
                        # a raw NVMe READ at the resolved device offset;
                        # the member's fd rides along for bookkeeping
                        native_reqs.append((fds[m_eff], r.passthru_off,
                                            r.length, r.dest_off))
                        native_members.append(m_eff)
                        native_pt.append(True)
                        native_rs.append(r)
                        continue
                    # a vectored (stripe-coalesced) request splits back
                    # into its segments: the lane's deep queue holds them
                    foff = r.file_off
                    for dseg, lseg in (r.dest_segs or
                                       ((r.dest_off, r.length),)):
                        native_reqs.append((fds[m_eff], foff, lseg, dseg))
                        native_members.append(m_eff)
                        native_pt.append(False)
                        foff += lseg
                    native_rs.append(r)
                if not native_reqs:
                    continue
                try:
                    self._submit_native(task, dest, native_reqs,
                                        native_members,
                                        passthru=native_pt
                                        if any(native_pt) else None)
                    if verify:
                        if task.verify_reqs is None:
                            task.verify_src, task.verify_dest = source, dest
                            task.verify_reqs = []
                        task.verify_reqs.extend(native_rs)
                except StromError as e:
                    # a failed native submit degrades to the python pool
                    # for this batch and the rest of the task
                    if not config.get("io_fallback"):
                        raise
                    stats.add("nr_backend_fallback")
                    pr_warn("native submit failed (%s); the batch falls "
                            "back to the python pool", e)
                    native_failed = True
                    self._submit_pool_requests(task, source, native_rs, dest)
            # -- write-back copies, after the direct submits so the device
            #    queue fills first and these copies overlap its I/O --------
            for i, cid in enumerate(wb_ids):
                base = cid * chunk_size
                length = min(chunk_size, source.size - base)
                slot = len(direct_ids) + i
                if wb_buffer is not None:
                    target, off = wb_buffer, slot * chunk_size
                else:
                    target, off = dest, dest_offset + slot * chunk_size
                tw0 = time.monotonic_ns()
                source.read_buffered(base, target[off:off + length])
                if _trace.active and task.trace_id:
                    _trace.span("writeback", tw0, time.monotonic_ns(),
                                tid=task.trace_id, offset=base,
                                length=length)
            # -- the hits, tail-packed after the write-back slots: a copy
            #    out of the tier, no submission (a task wholly resident
            #    submits nothing at all) ---------------------------------
            first = len(direct_ids) + len(wb_ids)
            j = 0
            while cache_hits:
                cid, base, length, lease, hbm = cache_hits.pop(0)
                slot = first + j
                j += 1
                if wb_buffer is not None:
                    target, off = wb_buffer, slot * chunk_size
                else:
                    target, off = dest, dest_offset + slot * chunk_size
                th0 = time.monotonic_ns()
                try:
                    if not lease.copy_into(target[off:off + length]):
                        # invalidated (or rotted) between the lookup and
                        # the copy: the write that staled it wins, read
                        # the bytes fresh
                        source.read_buffered(base, target[off:off + length])
                finally:
                    lease.release()
                if _trace.active and task.trace_id:
                    _trace.span("cache_hit", th0, time.monotonic_ns(),
                                tid=task.trace_id, offset=base,
                                length=length,
                                args=({"tier": "hbm"} if hbm else None))
            # -- the misses to fill at wait time, once the fault ladder
            #    healed them (direct chunks land in `dest` even when a
            #    wb_buffer is given) -------------------------------------
            if skey is not None and direct_ids:
                fills = []
                for i, cid in enumerate(direct_ids):
                    base = cid * chunk_size
                    fills.append((base, min(chunk_size, source.size - base),
                                  dest_offset + i * chunk_size))
                task.cache_fill = (skey, fills, dest,
                                   getattr(source, "logical_scale", 1.0),
                                   weakref.ref(source), speculative)
        except BaseException:
            while cache_hits:        # leases not served yet: unpin them
                cache_hits.pop()[3].release()
            self._abort_submit(task, buf_handle)
            raise
        result = self._finish_submit(task, MemCopyResult(
            dma_task_id=task.task_id, nr_chunks=n,
            nr_ssd2dev=len(direct_ids), nr_ram2dev=n - len(direct_ids),
            chunk_ids=list(direct_ids) + wb_ids + hit_ids), buf_handle)
        stats.count_clock("ioctl_memcpy_submit", time.monotonic_ns() - t0)
        return result

    def _submit_native(self, task: _Task, buf: memoryview,
                       native_reqs: List[Tuple[int, int, int, int]],
                       members: List[int], write_ctx=None,
                       passthru: Optional[List[bool]] = None) -> None:
        """One batch to the native engine (``passthru[i]`` flags request
        *i* a raw NVMe READ); a pool thread awaits it."""
        self._members_used.update(members)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        # capture the engine: a concurrent lane scale-out may swap
        # self._native, and the wait must run against the one that
        # accepted the batch
        nat = self._native
        nid = nat.submit(addr, native_reqs, write=write_ctx is not None,
                         members=members, passthru=passthru)
        if _trace.active and task.trace_id:
            _trace.instant("native_submit", tid=task.trace_id,
                           length=sum(q[2] for q in native_reqs),
                           args={"requests": len(native_reqs), "batch": nid})
        self._task_get(task)
        try:
            self._pool.submit(self._await_native, task, nat, nid, write_ctx)
        except BaseException as e:
            self._task_put(task, StromError(_errno.ESHUTDOWN, str(e)))
            raise

    def _member_pool(self, member: int, legs: bool = False
                     ) -> ThreadPoolExecutor:
        """The python pool of one stripe member: a slow or failing
        member's requests queue behind each other, never ahead of its
        siblings' (the python twin of the native per-member lanes).  With
        *legs*, the member's pool of hedged primaries, which may outlive
        their request."""
        key = (member, legs)
        pool = self._member_pools.get(key)
        if pool is None:
            with self._lane_lock:
                pool = self._member_pools.get(key)
                if pool is None:
                    width = int(config.get("member_queue_depth")) \
                        or int(config.get("queue_depth"))
                    width = max(1, min(width, 8))
                    if self._tuner.enabled and not legs:
                        # the tuned window is the member's pool width,
                        # its real concurrency on this path
                        width = self._tuner.pool_width(member, width)
                    pool = ThreadPoolExecutor(
                        max_workers=width,
                        thread_name_prefix=f"strom-"
                                           f"{'leg' if legs else 'io'}"
                                           f"-m{member}")
                    self._member_pools[key] = pool
        return pool

    def _submit_member(self, member: int, fn, *args, legs: bool = False
                       ) -> None:
        """Queue ``fn(*args)`` on *member*'s pool.  A window step retires
        the pool (:meth:`_retire_member_pool`) on the tuner's thread; one
        retired between the fetch and the submit refuses the work, and
        the member's current pool takes it instead.  A refusal after
        close stands."""
        while True:
            pool = self._member_pool(member, legs)
            try:
                pool.submit(fn, *args)
                return
            except RuntimeError:
                if self._closed or \
                        self._member_pools.get((member, legs)) is pool:
                    raise

    def _submit_pool_requests(self, task: _Task, source: Source,
                              reqs: Sequence[Request],
                              dest: memoryview) -> None:
        """Queue planned requests on the python pools (the executor of
        ``io_backend=python``, of sources that override the direct-read
        leg, and of a failed native submit); a striped source's requests
        go to their member's own pool."""
        multi = len(getattr(source, "members", ())) > 1
        for r in reqs:
            self._task_get(task)
            cur = stats.gauge_add("cur_dma_count", 1)
            stats.gauge_max("max_dma_count", cur)
            stats.add("nr_submit_dma")
            stats.add("total_dma_length", r.length)
            try:
                if multi:
                    self._submit_member(r.member, self._do_request,
                                        task, source, r, dest)
                else:
                    self._pool.submit(self._do_request, task, source, r,
                                      dest)
            except BaseException as e:
                stats.gauge_add("cur_dma_count", -1)
                self._task_put(task, StromError(_errno.ESHUTDOWN, str(e)))
                raise

    def _do_request(self, task: _Task, source: Source, r: Request,
                    dest: memoryview) -> None:
        if task.errno_:
            # the task already failed (its first error, or the watchdog):
            # cancel this request, its waiter has been woken
            stats.add("nr_chunk_cancelled")
            stats.gauge_add("cur_dma_count", -1)
            self._task_put(task, None)
            return
        err = None
        t0 = time.monotonic_ns()
        try:
            if r.buffered or source.member_fds()[r.member] < 0:
                source.read_member_buffered(
                    r.member, r.file_off,
                    dest[r.dest_off:r.dest_off + r.length])
            else:
                self._read_direct_resilient(task, source, r, dest)
                if config.get("checksum_verify"):
                    self._verify_request_checksums(task, source, r, dest)
        except BaseException as e:  # noqa: BLE001 - must latch, never DONE
            err = _as_strom(e) if isinstance(e, OSError) else \
                StromError(_errno.EIO, f"{type(e).__name__}: {e}")
        elapsed = time.monotonic_ns() - t0
        stats.member_add(r.member, r.length, elapsed)
        if _trace.active and task.trace_id:
            eargs = {}
            if r.buffered:
                eargs["buffered"] = True
            if err is not None:
                eargs["errno"] = err.errno
            _trace.span("extent", t0, t0 + elapsed, tid=task.trace_id,
                        member=r.member, offset=r.file_off, length=r.length,
                        args=eargs or None)
        if not r.buffered:
            stats.observe_latency(elapsed)
            if err is None:
                # the health machine's latency feed: a member's p99 past
                # suspect_ratio x the stripe median marks it SUSPECT
                self._member_health.observe_latency(r.member, elapsed)
            szr = self._chunk_sizers.get(r.member)
            if szr is not None:
                szr.observe(elapsed)
        stats.gauge_add("cur_dma_count", -1)
        self._task_put(task, err)

    def _read_direct_resilient(self, task: _Task, source: Source,
                               r: Request, dest: memoryview) -> None:
        """One direct extent through the fault ladder (reference
        ``_read_direct_resilient``): a member routed away reads from its
        mirror at direct speed, else buffered; with ``hedge_policy`` on, a
        plain extent still in flight past the latch races a hedge leg;
        a TRANSIENT error retries with backoff, then degrades to the
        mirror, then to the buffered leg (``io_fallback``); a PERSISTENT
        one fails the member and goes to the mirror at once.  A vectored
        request is one unit of the ladder.

        A request split onto the passthrough lane reads its direct leg
        through the task's channel (a raw NVMe READ at ``passthru_off``);
        every rung that serves it elsewhere (the mirror, the buffered leg)
        counts ``nr_passthru_fallback``: the ladder itself is the same."""
        health = self._member_health
        mirror = source.mirror_of(r.member)
        segs = r.dest_segs or ((r.dest_off, r.length),)
        views = [dest[d:d + ln] for d, ln in segs]
        pt = task.passthru if (r.passthru_off is not None and getattr(
            task.passthru, "pool_ok", False)) else None

        def _read(member: int, buffered: bool = False) -> None:
            if pt is not None:
                if member == r.member and not buffered:
                    pt.read(r.member, r.file_off, r.passthru_off, views[0])
                    stats.add("nr_passthru_dma")
                    return
                _passthru_left_lane(task, r)
            off = r.file_off
            for v in views:
                if buffered:
                    source.read_member_buffered(member, off, v)
                else:
                    source.read_member_direct(member, off, v)
                off += len(v)

        fallback_ok = bool(config.get("io_fallback"))

        def _try_mirror() -> bool:
            # degraded striping: the partner at direct speed; its failure
            # counts against it and falls through to the next rung
            if mirror is None or not health.allow_direct(mirror):
                return False
            tm = time.monotonic_ns()
            try:
                _read(mirror)
            except (StromError, OSError) as e:
                health.record_failure(
                    mirror,
                    fatal=_as_strom(e).error_class is ErrorClass.PERSISTENT)
                stats.member_error(mirror)
                return False
            stats.add("nr_mirror_read")
            if _trace.active and task.trace_id:
                _trace.span("mirror_read", tm, time.monotonic_ns(),
                            tid=task.trace_id, member=r.member,
                            offset=r.file_off, length=r.length,
                            args={"mirror": mirror})
            health.record_success(mirror)
            health.observe_latency(mirror, time.monotonic_ns() - tm)
            return True

        def _buffered() -> None:
            stats.add("nr_io_fallback")
            if _trace.active and task.trace_id:
                _trace.instant("fallback_buffered", tid=task.trace_id,
                               member=r.member, offset=r.file_off,
                               length=r.length)
            _read(r.member, buffered=True)

        if (mirror is not None or fallback_ok) \
                and not health.allow_direct(r.member):
            # routed away: the mirror first, the buffered leg next
            if _trace.active and task.trace_id:
                _trace.instant("route_away", tid=task.trace_id,
                               member=r.member, offset=r.file_off,
                               length=r.length)
            if _try_mirror():
                return
            if fallback_ok:
                _buffered()
                return
        if not r.dest_segs and len(getattr(source, "members", ())) > 1:
            hd = health.hedge_delay_s(r.member)
            if hd is not None and self._tuner.enabled:
                # the tuned delay replaces hedge_ms; whether to hedge stays
                # the health machine's call
                hd = self._tuner.hedge_delay(r.member, hd)
            if hd is not None and self._read_hedged(task, source, r,
                                                    views[0], hd, mirror):
                return
        attempt = 0
        while True:
            try:
                _read(r.member)
                health.record_success(r.member)
                return
            except (StromError, OSError) as e:
                se = _as_strom(e)
                if not se.transient:
                    # fail-stop: the mirror keeps the task alive at direct
                    # speed (byte identity across a member lost mid-task)
                    health.record_failure(
                        r.member,
                        fatal=se.error_class is ErrorClass.PERSISTENT)
                    stats.member_error(r.member)
                    if _try_mirror():
                        return
                    raise se
                health.record_failure(r.member)
                # stop burning attempts once the task failed or expired
                if attempt < self._retry.attempts and not task.errno_:
                    stats.add("nr_io_retry")
                    stats.member_error(r.member, retried=True)
                    if _trace.active and task.trace_id:
                        _trace.instant("retry", tid=task.trace_id,
                                       member=r.member, offset=r.file_off,
                                       length=r.length,
                                       args={"attempt": attempt + 1,
                                             "errno": se.errno})
                    self._retry.sleep(attempt, self._retry_rng)
                    attempt += 1
                    continue
                stats.member_error(r.member)
                if task.errno_:
                    raise se
                if _try_mirror():
                    return
                if fallback_ok:
                    _buffered()
                    return
                raise se

    def _read_hedged(self, task: _Task, source: Source, r: Request,
                     piece: memoryview, delay_s: float,
                     mirror: Optional[int]) -> bool:
        """Hedged read of one plain extent: the primary direct read races
        a hedge leg armed after *delay_s* (the mirror at direct speed, or
        the buffered leg).  Both legs read into their own page-aligned
        scratch and the first to finish copies into *piece* under the
        winner lock, so a loser never writes a destination that a
        host→device copy may already be reading.

        True when a leg delivered the extent, False when there is nothing
        to hedge onto (the caller runs the plain ladder); raises when the
        primary failed and nothing saved it.  The primary of a request on
        the passthrough lane reads through the task's channel; the hedge
        leg is off the lane by construction, so its win is counted
        ``nr_passthru_fallback``."""
        health = self._member_health
        use_mirror = mirror is not None and health.allow_direct(mirror)
        fallback_ok = bool(config.get("io_fallback"))
        if not use_mirror and not fallback_ok:
            return False
        pt = task.passthru if (r.passthru_off is not None and getattr(
            task.passthru, "pool_ok", False)) else None
        lock = threading.Lock()
        won = threading.Event()
        hedge_settled = threading.Event()
        prim_settled = threading.Event()
        state = {"winner": None, "prim_ok": False, "prim_err": None}
        leg = f"mirror:{mirror}" if use_mirror else "buffered"

        def _finish(who: str, scratch) -> bool:
            with lock:
                if state["winner"] is None and not task.errno_:
                    state["winner"] = who
                    piece[:] = scratch
                    won.set()
                    return True
            return False

        def _hedge_leg() -> None:
            scratch = mv = None
            try:
                if won.wait(delay_s) or task.errno_:
                    return          # the primary beat the latch
                with lock:
                    if state["winner"] is not None:
                        return
                stats.add("nr_hedge_issued")
                stats.add("bytes_hedge_dup", r.length)
                th0 = time.monotonic_ns()
                if _trace.active and task.trace_id:
                    _trace.instant("hedge_issued", tid=task.trace_id,
                                   member=r.member, offset=r.file_off,
                                   length=r.length, args={"leg": leg})
                scratch = mmap.mmap(-1, max(r.length, 1))
                mv = memoryview(scratch)[:r.length]
                try:
                    if use_mirror:
                        source.read_member_direct(mirror, r.file_off, mv)
                    else:
                        source.read_member_buffered(r.member, r.file_off, mv)
                except (StromError, OSError):
                    if use_mirror:
                        health.record_failure(mirror)
                    stats.add("nr_hedge_cancelled")
                    return
                if use_mirror:
                    health.record_success(mirror)
                    stats.add("nr_mirror_read")
                if _finish("hedge", mv):
                    stats.add("nr_hedge_won")
                    if pt is not None:
                        _passthru_left_lane(task, r)
                    if _trace.active and task.trace_id:
                        _trace.span("hedge_won", th0, time.monotonic_ns(),
                                    tid=task.trace_id, member=r.member,
                                    offset=r.file_off, length=r.length,
                                    args={"leg": leg})
                else:
                    stats.add("nr_hedge_cancelled")
            finally:
                if mv is not None:
                    mv.release()
                if scratch is not None:
                    scratch.close()
                hedge_settled.set()

        def _primary_leg() -> None:
            scratch = mmap.mmap(-1, max(r.length, 1))   # O_DIRECT-aligned
            mv = memoryview(scratch)[:r.length]
            attempt = 0
            try:
                while True:
                    try:
                        if pt is not None:
                            pt.read(r.member, r.file_off, r.passthru_off, mv)
                            stats.add("nr_passthru_dma")
                        else:
                            source.read_member_direct(r.member, r.file_off,
                                                      mv)
                        health.record_success(r.member)
                        break
                    except (StromError, OSError) as e:
                        se = _as_strom(e)
                        if se.transient and attempt < self._retry.attempts \
                                and not task.errno_ and not won.is_set():
                            health.record_failure(r.member)
                            stats.add("nr_io_retry")
                            stats.member_error(r.member, retried=True)
                            self._retry.sleep(attempt, self._retry_rng)
                            attempt += 1
                            continue
                        # one health debit for the chunk, even when the
                        # hedge already won
                        health.record_failure(
                            r.member,
                            fatal=se.error_class is ErrorClass.PERSISTENT)
                        stats.member_error(r.member)
                        state["prim_err"] = se
                        return
                state["prim_ok"] = True
                _finish("primary", mv)
            finally:
                mv.release()
                scratch.close()
                prim_settled.set()

        # the primary races on its member's pool of legs, so the extent
        # completes at the first landing, not behind a slow primary, and
        # a slow member's primaries, which outlive the requests their
        # hedge won, queue behind each other only; the hedge leg waits
        # out the latch on this thread, which waits anyway, and holds no
        # pool thread
        self._submit_member(r.member, _primary_leg, legs=True)
        _hedge_leg()
        while not won.wait(0.05):
            if prim_settled.is_set() and hedge_settled.is_set():
                break
        with lock:
            if state["winner"] is not None:
                return True
        if state["prim_ok"]:
            return True
        if fallback_ok and not task.errno_:
            stats.add("nr_io_fallback")
            source.read_member_buffered(r.member, r.file_off, piece)
            return True
        raise state["prim_err"] or StromError(
            task.errno_ or _errno.EIO, "hedged read abandoned")

    def _verify_request_checksums(self, task: _Task, source: Source,
                                  r: Request, dest: memoryview,
                                  buffered: bool = False) -> None:
        """Checksum-verify one planned request's landed bytes: a plain
        request as one extent, a vectored one segment by segment (each a
        file-contiguous piece from ``file_off`` on).  A bad page is read
        again the way its bytes were served: a *buffered* leg from its
        member's page cache, a direct one through the fault ladder, which
        sends a member routed away to its mirror as the first read did
        (a raw read of the routed-away member could fail where the mirror
        heals, or return bytes its skipped writes left stale)."""
        from .scan.heap import PAGE_SIZE as HEAP_PAGE
        foff = r.file_off
        for d, ln in (r.dest_segs or ((r.dest_off, r.length),)):
            if foff % HEAP_PAGE == 0:
                # an extent at an offset that is not page-aligned is
                # skipped: its pages are not addressable (a buffered leg)
                self._verify_extent(task, source, r.member, foff,
                                    dest[d:d + ln], buffered)
            foff += ln

    def _verify_extent(self, task: _Task, source: Source, member: int,
                       file_off: int, piece: memoryview,
                       buffered: bool) -> None:
        from .scan.heap import PAGE_SIZE as HEAP_PAGE

        def reread(page: int, view: memoryview) -> None:
            off = file_off + page * HEAP_PAGE
            if buffered:
                source.read_member_buffered(member, off, view)
            else:
                self._read_direct_resilient(
                    task, source, Request(member, off, len(view), 0), view)

        verify_and_reread(piece, reread,
                          lambda page: file_off + page * HEAP_PAGE,
                          trace_args={"member": member, "offset": file_off,
                                      "length": len(piece)})

    def _scrub_refill(self, source: Optional[Source], base: int,
                      length: int) -> Optional[bytes]:
        """The scrubber's heal: read one resident extent again from the
        SSD through the ordinary submit path, so the whole fault ladder
        heals it and the wait-time fill puts it back under its key (the
        corrupt entry was dropped, so this read misses).  None when the
        source is gone or the extent is off its chunk grid."""
        if source is None:
            return None
        size = getattr(source, "size", 0)
        # the chunk grid from (base, length): a whole chunk is its own
        # power-of-two grid; a tail's is the least power of two that
        # covers it and divides base
        cs = length
        if cs & (cs - 1):
            cs = 1 << (length - 1).bit_length()
        while cs < size and base % cs:
            cs <<= 1
        if cs <= 0 or base % cs or min(cs, size - base) != length:
            return None
        handle = buf = None
        try:
            handle, buf = self.alloc_dma_buffer(max(length, PAGE_SIZE))
            res = self.memcpy_ssd2ram(source, handle, [base // cs], cs)
            self.memcpy_wait(res.dma_task_id)
            return bytes(buf.view()[:length])
        except (StromError, OSError):
            return None
        finally:
            if handle is not None:
                try:
                    self.unmap_buffer(handle)
                    buf.close()
                except StromError:  # pragma: no cover - a closing session
                    pass

    def _await_native(self, task: _Task, eng, native_id: int,
                      write_ctx: Optional[tuple] = None) -> None:
        """Pool thread: wait for one native batch (outside the GIL, in
        500 ms slices so a closing session or the watchdog can abandon
        it), then drain the engine's trace ring.  A failed write batch is
        redriven request by request through the write ladder."""
        err: Optional[StromError] = None
        while True:
            try:
                eng.wait(native_id, 500)
                break
            except StromError as e:
                if e.errno == _errno.ETIMEDOUT:
                    if self._abandon_native:
                        err = StromError(_errno.ETIMEDOUT, "native I/O "
                                         "abandoned at session close")
                        break
                    if task.expired:
                        # the watchdog latched ETIMEDOUT and woke the
                        # waiters; stop pinning this thread (the latch
                        # stays as it is)
                        break
                    continue
                err = e
                break
        if _trace.active:
            self._drain_native_trace(eng)
        if write_ctx is not None:
            sink, w_reqs, w_src, n_mirror = write_ctx
            if err is None and not task.expired:
                if n_mirror:
                    stats.add("nr_mirror_write", n_mirror)
            elif err is not None and not self._abandon_native \
                    and not task.expired and not task.errno_:
                stats.add("nr_backend_fallback")
                pr_warn("native write batch failed (%s); redriving %d "
                        "request(s) on the write ladder", err, len(w_reqs))
                err = None
                for r in w_reqs:
                    if task.errno_:
                        break
                    stats.add("nr_write_retry")
                    e2 = self._write_request_resilient(task, sink, r, w_src)
                    if e2 is not None and err is None:
                        err = e2
        self._task_put(task, err)

    def _drain_native_trace(self, eng=None) -> int:
        """Drain an engine's per-lane event ring into the recorder: each
        request's measured device window, on the clock of the Python
        spans."""
        eng = eng if eng is not None else self._native
        if eng is None:
            return 0
        evs = eng.trace_drain()
        for ev in evs:
            _trace.native_event(ev["submit_ns"], ev["complete_ns"],
                                member=ev["member"], lane=ev["lane"],
                                offset=ev["file_off"], length=ev["len"],
                                result=ev["result"])
        return len(evs)

    def _adaptive_cap(self, floor: int, limit: int, member: int = 0) -> int:
        """The effective coalescing cap of *member*'s sizer (made lazily,
        remade when the bounds change), through the tuner, its one writer
        (:meth:`.autotune.AutoTuner.chunk_cap`: with ``autotune`` off the
        sizer's own)."""
        return self._tuner.chunk_cap(floor, limit, member)

    def _retire_member_pool(self, member: int) -> None:
        """Drop *member*'s python pool so its next submit makes one at the
        tuned width; queued work runs on in the old pool's threads."""
        with self._lane_lock:
            pool = self._member_pools.pop((member, False), None)
        if pool is not None:
            pool.shutdown(wait=False)

    def _autotune_scale_lanes(self, want: int) -> None:
        """Rebuild the native engine with more lanes when the tuned window
        has outgrown them (at most 16, as :meth:`_ensure_member_lanes`);
        nothing on the python path or when wide enough."""
        want = max(1, min(int(want), 16))
        with self._lane_lock:
            if self._native is None or self._native.nlanes() >= want:
                return
            self._scale_out_lanes(want, len(self._members_used) or 1)

    # -- lanes -------------------------------------------------------------
    def _ensure_member_lanes(self, source: Source) -> None:
        """One-shot at the first striped submit: rebuild the native engine
        with one queue pair a stripe member (member i → lane i % nlanes,
        :func:`..stripe.lane_of`), so a slow member queues behind itself,
        never behind siblings (the per-NVMe-device hardware-queue analog,
        kmod/nvme_strom.c:1201-1223).  An explicit config
        ``engine_rings`` keeps the operator's lane count.  After sizing,
        the lanes are NUMA-pinned per config ``numa_policy``."""
        if self._native is None or self._lanes_sized:
            return
        members = getattr(source, "members", None) or ()
        nmem = len(members)
        if nmem <= 1:
            return
        with self._lane_lock:
            if self._lanes_sized or self._native is None:
                return
            self._lanes_sized = True
            want = min(nmem, 16)
            if int(config.get("engine_rings")) == 0 \
                    and self._native.nlanes() < want:
                self._scale_out_lanes(want, nmem)
            self._pin_lanes(members)

    def _pin_lanes(self, members) -> int:
        """Pin each lane's threads (reaper and workers) to the CPUs of a
        NUMA node per config ``numa_policy``: ``auto`` the node of the
        backing device of the lane's first member (member % lanes), whose
        unknown node (-1: no sysfs topology, a set across nodes) leaves
        the lane floating; ``node:N`` node N for every lane; ``off``
        nothing.  The reference places its DMA buffers device-locally
        (pgsql/nvme_strom.c:1454-1526); pinning the completion path keeps
        the reaping and the landing copy on that node.  A pin the kernel
        refuses is logged, never raised.  Returns the lanes pinned."""
        policy = str(config.get("numa_policy"))
        if policy == "off" or self._native is None:
            return 0
        nlanes = self._native.nlanes()
        fixed = int(policy.split(":", 1)[1]) \
            if policy.startswith("node:") else -1
        from .stripe import lane_members
        pinned = 0
        for lane in range(nlanes):
            node = fixed
            if node < 0:
                served = lane_members(lane, len(members), nlanes)
                path = getattr(members[served[0]], "path", None) \
                    if served else None
                if not path:
                    continue
                try:
                    node = _numa.device_numa_node(str(path))
                except (OSError, ValueError):
                    node = -1
            if node < 0:
                continue
            cpus = _numa.node_cpus(node)
            if cpus and self._native.lane_pin(lane, cpus):
                pinned += 1
            else:
                pr_warn("NUMA: lane %d not pinned to node %d (cpus %s)",
                        lane, node, cpus)
        if pinned:
            pr_info("NUMA: pinned %d/%d lane(s) (policy=%s)", pinned,
                    nlanes, policy)
        self.lanes_pinned = pinned
        return pinned

    def _scale_out_lanes(self, nlanes: int, nmem: int) -> None:
        """Swap in a fresh native engine with *nlanes* queue pairs: fixed
        buffers re-registered on it under the fixed lock, the old engine's
        counters folded and the old engine kept until close (in-flight
        batches hold it and drain there).  The caller holds the lane
        lock."""
        from . import _native
        depth = int(config.get("member_queue_depth")) \
            or int(config.get("queue_depth"))
        try:
            eng = _native.NativeEngine(self.backend_name, depth,
                                       rings=nlanes,
                                       passthru_dev=self._passthru_dev)
        except StromError as e:
            pr_warn("lane scale-out to %d lanes failed (%s); keeping the "
                    "single-lane engine", nlanes, e)
            return
        self._fold_native_stats()
        with self._fixed_lock:
            for key, (_slot, backing, cb) in list(self._fixed_regs.items()):
                nslot = eng.buf_register(backing.addr, backing.length)
                self._fixed_regs[key] = (-1 if nslot is None else nslot,
                                         backing, cb)
            old, self._native = self._native, eng
        self._old_engines.append(old)
        if _trace.active:
            eng.trace_enable(True)

    # -- writes ------------------------------------------------------------
    def memcpy_ram2ssd(self, sink: Source, buf_handle: int,
                       chunk_ids: Sequence[int], chunk_size: int, *,
                       src_offset: int = 0) -> MemCopyResult:
        """MEMCPY_RAM2SSD: buffer slot *i* (``src_offset + i*chunk_size``)
        is written to sink chunk ``chunk_ids[i]`` (a chunk at the sink's
        end may be partial; the sink has its final size).  Planning is the
        read side's (same extents, same <= dma_max requests, buffered legs
        for misaligned pieces).  Aligned legs run on the native engine
        (IORING_OP_WRITE) when there is one; misaligned pieces, and every
        leg of a sink whose write leg is overridden, walk the python write
        ladder: transient retries, PERSISTENT errors (ENOSPC, EDQUOT,
        EROFS) latched at once.  On a paired sink every aligned leg lands
        on both partners; a partner the health machine routes away is
        skipped and its extent journaled for resync.  Under
        ``write_verify`` the wait reads every leg back.  Durability of
        buffered legs needs ``sink.sync()`` after the wait."""
        t0 = time.monotonic_ns()
        if self._closed:
            raise StromError(_errno.EBADF, "session closed")
        if chunk_size <= 0 or (chunk_size & (chunk_size - 1)):
            raise StromError(_errno.EINVAL,
                             f"chunk_size {chunk_size} must be pow2")
        sink._check_writable()
        chunk_ids = list(chunk_ids)
        n = len(chunk_ids)
        if n == 0:
            raise StromError(_errno.EINVAL, "no chunks")
        src = self._get_buffer(buf_handle, src_offset + n * chunk_size)
        task = self._create_task()
        try:
            # a write may relocate extents (copy-on-write filesystems): the
            # sink's cached file -> LBA maps go with the tiers' extents,
            # so the next passthrough split resolves the written layout
            blockmap.invalidate_source(sink)
            if _tiers.lookup_active:
                # coherency: every tier drops the extents the write
                # touches before any byte moves, and again at wait time
                # (a racing read may fill one from the bytes before it)
                wkey = _tiers.source_key(sink)
                extents = [(cid * chunk_size, chunk_size)
                           for cid in chunk_ids]
                _tiers.invalidate_extents(wkey, extents)
                task.cache_invalidate = (wkey, extents)
            tp0 = time.monotonic_ns()
            reqs = plan_requests(sink, [(cid, i) for i, cid in
                                        enumerate(chunk_ids)],
                                 chunk_size, src_offset)
            stats.count_clock("setup_prps", time.monotonic_ns() - tp0)
            if len(getattr(sink, "members", ())) > 1:
                # a written stripe set is a canary target too: the canary
                # replays its journal while a degraded member rejoins
                self._canary_sources.add(sink)
            if config.get("write_verify"):
                task.write_verify = (sink, list(reqs), src)
            use_native = (self._native is not None and bool(reqs)
                          and type(sink).write_member_direct
                          is Source.write_member_direct)
            pool_reqs = list(reqs) if not use_native else []
            if use_native:
                self._ensure_member_lanes(sink)
                fds = sink.member_fds()
                health = self._member_health
                native_reqs, native_members, native_rs = [], [], []
                n_mirror_legs = 0
                for r in reqs:
                    mirror = sink.mirror_of(r.member)
                    if r.buffered or fds[r.member] < 0 or \
                            (mirror is not None and fds[mirror] < 0):
                        pool_reqs.append(r)
                        continue
                    # mirror-coherent fan-out: primary and partner, or the
                    # survivor alone with the other journaled
                    legs = [r.member]
                    if mirror is not None:
                        away_p = health.routes_away(r.member)
                        away_m = health.routes_away(mirror)
                        if away_p and not away_m:
                            self._journal_skipped(sink, r.member, r.file_off,
                                                  r.length, task.trace_id)
                            legs = [mirror]
                            n_mirror_legs += 1
                        elif away_m and not away_p:
                            self._journal_skipped(sink, mirror, r.file_off,
                                                  r.length, task.trace_id)
                        else:
                            legs.append(mirror)
                            n_mirror_legs += 1
                    native_rs.append(r)
                    for m in legs:
                        native_reqs.append((fds[m], r.file_off, r.length,
                                            r.dest_off))
                        native_members.append(m)
                if native_reqs:
                    try:
                        self._submit_native(
                            task, src, native_reqs, native_members,
                            write_ctx=(sink, native_rs, src, n_mirror_legs))
                    except StromError as e:
                        if not config.get("io_fallback"):
                            raise
                        stats.add("nr_backend_fallback")
                        pr_warn("native write submit failed (%s); the batch "
                                "falls back to the python pool", e)
                        pool_reqs.extend(native_rs)
            for r in pool_reqs:
                self._task_get(task)
                cur = stats.gauge_add("cur_dma_count", 1)
                stats.gauge_max("max_dma_count", cur)
                stats.add("nr_submit_dma")
                stats.add("total_dma_length", r.length)
                stats.add("nr_write_dma")
                stats.add("total_write_length", r.length)
                try:
                    self._pool.submit(self._do_write_request, task, sink, r,
                                      src)
                except BaseException as e:
                    stats.gauge_add("cur_dma_count", -1)
                    self._task_put(task, StromError(_errno.ESHUTDOWN, str(e)))
                    raise
        except BaseException:
            self._abort_submit(task, buf_handle)
            raise
        result = self._finish_submit(task, MemCopyResult(
            dma_task_id=task.task_id, nr_chunks=n, nr_ssd2dev=n,
            nr_ram2dev=0, chunk_ids=chunk_ids), buf_handle)
        stats.count_clock("ioctl_memcpy_submit", time.monotonic_ns() - t0)
        return result

    def _do_write_request(self, task: _Task, sink: Source, r: Request,
                          src: memoryview) -> None:
        if task.errno_:
            stats.add("nr_chunk_cancelled")
            err = None
        else:
            err = self._write_request_resilient(task, sink, r, src)
        stats.gauge_add("cur_dma_count", -1)
        self._task_put(task, err)

    def _write_request_resilient(self, task: _Task, sink: Source,
                                 r: Request, src: memoryview
                                 ) -> Optional[StromError]:
        """One write request through the write ladder: a paired sink's
        request goes to both partners (:meth:`_write_mirrored`), any other
        to its member with retries.  Returns the error to latch, or
        None."""
        err: Optional[StromError] = None
        t0 = time.monotonic_ns()
        try:
            piece = src[r.dest_off:r.dest_off + r.length]
            mirror = sink.mirror_of(r.member)
            if mirror is None:
                self._write_leg(task, sink, r, r.member, piece)
            else:
                err = self._write_mirrored(task, sink, r, mirror, piece)
        except BaseException as e:  # noqa: BLE001 - must latch, never DONE
            err = _as_strom(e) if isinstance(e, OSError) else \
                StromError(_errno.EIO, f"unexpected write failure: {e!r}")
        if _trace.active and task.trace_id:
            eargs: dict = {"write": True}
            if r.buffered:
                eargs["buffered"] = True
            if err is not None:
                eargs["errno"] = err.errno
            _trace.span("extent", t0, time.monotonic_ns(), tid=task.trace_id,
                        member=r.member, offset=r.file_off, length=r.length,
                        args=eargs)
        return err

    def _write_leg(self, task: _Task, sink: Source, r: Request, member: int,
                   piece: memoryview) -> None:
        """One write leg with transient retries (never degraded to the
        buffered leg: a half-direct write would need a sync to be
        durable).  A failure debits the health machine by its class, so
        ENOSPC fails the member and latches at once; a success feeds the
        member's latency into SUSPECT detection and its adaptive sizer,
        so write-only traffic drives the ladder too."""
        health = self._member_health
        attempt = 0
        t0 = time.monotonic_ns()
        try:
            while True:
                try:
                    if r.buffered:
                        sink.write_member_buffered(member, r.file_off, piece)
                    else:
                        sink.write_member_direct(member, r.file_off, piece)
                    break
                except (StromError, OSError) as e:
                    se = _as_strom(e)
                    if not se.transient or r.buffered \
                            or attempt >= self._retry.attempts \
                            or task.errno_:
                        health.record_failure(
                            member,
                            fatal=se.error_class is ErrorClass.PERSISTENT)
                        stats.member_error(member)
                        # the verdict this failure left, read at once: the
                        # canary may move the member on before the partner
                        # leg ends
                        se.routed_away = health.routes_away(member)
                        raise se
                    stats.add("nr_io_retry")
                    stats.add("nr_write_retry")
                    stats.member_error(member, retried=True)
                    if _trace.active and task.trace_id:
                        _trace.instant("retry", tid=task.trace_id,
                                       member=member,
                                       args={"attempt": attempt + 1,
                                             "errno": se.errno,
                                             "write": True})
                    self._retry.sleep(attempt, self._retry_rng)
                    attempt += 1
        finally:
            elapsed = time.monotonic_ns() - t0
            stats.member_add(member, r.length, elapsed)
        if not r.buffered:
            self._observe_write(member, elapsed)
        health.record_success(member)

    def _observe_write(self, member: int, elapsed_ns: int) -> None:
        """A direct write leg's service time into the latency histogram,
        the health machine and the member's adaptive sizer (made here
        under the read planner's config gates)."""
        stats.observe_latency(elapsed_ns)
        self._member_health.observe_latency(member, elapsed_ns)
        climit = int(config.get("coalesce_limit"))
        if config.get("chunk_adaptive") and climit:
            self._adaptive_cap(int(config.get("dma_max_size")), climit,
                               member)
        szr = self._chunk_sizers.get(member)
        if szr is not None:
            szr.observe(elapsed_ns)

    def _write_mirrored(self, task: _Task, sink: Source, r: Request,
                        mirror: int, piece: memoryview
                        ) -> Optional[StromError]:
        """Both legs of a paired request must land.  A partner routed away
        is skipped and journaled up front; a leg that fails and leaves its
        member routed away degrades the same way, so the stream goes on
        on the survivor.  A failure on a member still serving direct
        latches: swallowing it would leave readable stale bytes with no
        resync owner.  "Leaves routed away" is read when the leg fails,
        not after the partner's leg: the reference reads it after, and a
        canary that moves the member to REJOINING meanwhile turns a
        journaled miss into a latched error with the pair diverged and
        no resync owner."""
        health = self._member_health
        away_p = health.routes_away(r.member)
        away_m = health.routes_away(mirror)
        do_p = do_m = True
        if away_p and not away_m:
            self._journal_skipped(sink, r.member, r.file_off, r.length,
                                  task.trace_id)
            do_p = False
        elif away_m and not away_p:
            self._journal_skipped(sink, mirror, r.file_off, r.length,
                                  task.trace_id)
            do_m = False
        p_err = m_err = None
        if do_p:
            try:
                self._write_leg(task, sink, r, r.member, piece)
            except StromError as e:
                p_err = e
        if do_m:
            tm = time.monotonic_ns()
            try:
                self._write_leg(task, sink, r, mirror, piece)
            except StromError as e:
                m_err = e
            else:
                stats.add("nr_mirror_write")
                if _trace.active and task.trace_id:
                    _trace.span("mirror_write", tm, time.monotonic_ns(),
                                tid=task.trace_id, member=r.member,
                                offset=r.file_off, length=r.length,
                                args={"mirror": mirror})
        if p_err is not None and m_err is None and do_m \
                and (getattr(p_err, "routed_away", False)
                     or health.routes_away(r.member)):
            self._journal_skipped(sink, r.member, r.file_off, r.length,
                                  task.trace_id)
            p_err = None
        if m_err is not None and p_err is None and do_p \
                and (getattr(m_err, "routed_away", False)
                     or health.routes_away(mirror)):
            self._journal_skipped(sink, mirror, r.file_off, r.length,
                                  task.trace_id)
            m_err = None
        return p_err or m_err

    def _verify_writes(self, sink: Source, reqs: List[Request],
                       src: memoryview, task: _Task) -> None:
        """``write_verify``: read every retired leg back and compare its
        crc32c with the bytes submitted; EBADMSG on a mismatch.  A leg
        whose member routes away was journaled (its bytes are stale until
        the replay) and is skipped."""
        from .scan.heap import crc32c
        health = self._member_health
        scratch: Optional[mmap.mmap] = None
        try:
            for r in reqs:
                want = crc32c(src[r.dest_off:r.dest_off + r.length])
                members = [r.member]
                mirror = sink.mirror_of(r.member)
                if mirror is not None:
                    members.append(mirror)
                for m in members:
                    if health.routes_away(m):
                        continue
                    if r.buffered:
                        back = bytearray(r.length)
                        sink.read_member_buffered(m, r.file_off,
                                                  memoryview(back))
                        got = crc32c(back)
                    else:
                        if scratch is None or len(scratch) < r.length:
                            if scratch is not None:
                                scratch.close()
                            scratch = mmap.mmap(-1, -(-r.length // PAGE_SIZE)
                                                * PAGE_SIZE)
                        mv = memoryview(scratch)[:r.length]
                        try:
                            sink.read_member_direct(m, r.file_off, mv)
                            got = crc32c(mv)
                        finally:
                            mv.release()   # before any raise below
                    stats.add("bytes_verify_reread", r.length)
                    if got != want:
                        stats.add("nr_write_verify_fail")
                        if _trace.active and task.trace_id:
                            _trace.instant("csum_fail", tid=task.trace_id,
                                           member=m, offset=r.file_off,
                                           length=r.length,
                                           args={"write_verify": True})
                        raise StromError(
                            _errno.EBADMSG,
                            f"write_verify: crc32c mismatch on member {m} at "
                            f"file offset {r.file_off} ({r.length} bytes): "
                            f"wrote {want:#010x}, read back {got:#010x}")
        finally:
            if scratch is not None:
                scratch.close()

    # -- stats + lifecycle -------------------------------------------------
    def _fold_native_stats(self, eng=None) -> dict:
        """Fold a native engine's counter deltas into :data:`stats`;
        returns the raw delta.  Called from :meth:`stat_info`, lane
        scale-out, the autotune controller's thread, the stats exporter's
        thread (before each publish) and :meth:`close`, so no session
        takes its I/O accounting to the grave; one fold at a time."""
        with self._fold_lock:
            eng = eng if eng is not None else self._native
            d = eng.stats_delta()
            # nr/clk_ssd2dev and the waits are counted per Python task
            # already; continuations, full-queue stalls and fixed-buffer
            # requests ride the reference's spare debug counters
            stats.merge_native({
                "nr_submit_dma": d.get("nr_submit_dma", 0),
                "clk_submit_dma": d.get("clk_submit_dma", 0),
                "total_dma_length": d.get("total_dma_length", 0),
                "nr_write_dma": d.get("nr_write_dma", 0),
                "total_write_length": d.get("total_write_length", 0),
                "nr_enter_dma": d.get("nr_enter_dma", 0),
                "nr_debug1": d.get("nr_resubmit", 0),
                "nr_debug2": d.get("nr_sq_full", 0),
                "nr_debug4": d.get("nr_fixed_dma", 0),
                "occ_integral_ns": d.get("occ_integral_ns", 0),
                "occ_busy_ns": d.get("occ_busy_ns", 0),
            })
            used = sorted(self._members_used)
            for m, (nreq, nbytes, ns) in eng.member_stats_delta(used).items():
                stats.member_add(m, nbytes, ns, n=nreq)
            # latency histograms; their mean service time feeds the adaptive
            # sizers (native requests never pass through _do_request)
            hd = eng.lat_hist_delta()
            if any(hd):
                stats.merge_native_hist(hd)
                fed = False
                for m, h in eng.member_lat_hist_delta(used).items():
                    stats.merge_member_hist(m, h)
                    # SUSPECT detection covers the native path: the lanes'
                    # per-member histograms feed the health machine too
                    self._member_health.observe_hist(m, h)
                    szr = self._chunk_sizers.get(m)
                    if szr is not None:
                        szr.observe(_hist_mean(h))
                        fed = True
                if not fed:
                    for szr in self._chunk_sizers.values():
                        szr.observe(_hist_mean(hd))
            for m, (dint, dbusy) in eng.member_occ_delta(used).items():
                stats.member_occ_add(m, dint, dbusy)
            return d

    def stat_info(self, *, debug: bool = False) -> Dict[str, int]:
        """STAT_INFO: the counters (the ``*debug*`` pairs only with
        *debug*), with the live engine's deltas folded in and its
        in-flight gauges combined."""
        if self._native is None:
            return stats.snapshot(debug=debug)
        d = self._fold_native_stats()
        snap = stats.snapshot(debug=debug)
        snap["cur_dma_count"] = snap.get("cur_dma_count", 0) \
            + d.get("cur_dma_count", 0)
        snap["max_dma_count"] = max(snap.get("max_dma_count", 0),
                                    d.get("max_dma_count", 0))
        return snap

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
        self._abandon_native = True   # bound the pool's shutdown
        self._watchdog_stop.set()
        self._canary_stop.set()
        self._watchdog.join(timeout=2.0)
        self._canary.join(timeout=2.0)
        self._scrubber.stop()
        self._tuner.close()
        self._pool.shutdown(wait=True)
        with self._lane_lock:
            pools, self._member_pools = self._member_pools, {}
        for p in pools.values():
            p.shutdown(wait=True)
        if self._canary_buf is not None:
            try:
                self._canary_buf.close()
            except BufferError:
                pass      # a late probe still holds a view
        # detach close hooks from buffers that outlive the session: the
        # engine's destroy below frees every kernel-side fixed slot
        with self._fixed_lock:
            regs, self._fixed_regs = list(self._fixed_regs.values()), {}
        for _slot, backing, cb in regs:
            backing.remove_close_cb(cb)
        with self._lane_lock:
            engines = [e for e in (self._native,) if e is not None] \
                + self._old_engines
            self._old_engines = []
        for eng in engines:
            eng.reap(timeout_ms=int(timeout * 1000))
            if _trace.active:
                self._drain_native_trace(eng)
            with self._fold_lock:   # the exporter's fold sees _closed
                self._fold_native_stats(eng)
                eng.close()
        return reaped

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _as_strom(e: BaseException) -> StromError:
    """*e* as a :class:`StromError` (an OSError keeps its errno)."""
    if isinstance(e, StromError):
        return e
    return StromError(getattr(e, "errno", None) or _errno.EIO, str(e))


def _window_chunks(chunk_size: int, window: Optional[int] = None) -> int:
    """Chunks in one submission slice of a read: *window* chunks (default
    ``submit_window``; the tuned window under autotune) of at least 1 MiB
    each, the reference's design point (16 x 1 MiB).  Smaller chunks fill
    the slice up to *window* MiB: at 8 KiB pages a 16-chunk slice is a
    128 KiB native batch, and the per-batch submit and await cost halved
    the page-grained reads of the multi-host loader and the ring scan
    (ROADMAP Queue C)."""
    if window is None:
        window = int(config.get("submit_window"))
    window = max(int(window), 1)
    return max(window, (window << 20) // max(chunk_size, 1))


def _hist_mean(h: Sequence[int]) -> int:
    """Mean of a log2-ns histogram, each bucket at 1.5 x 2^b."""
    total = sum(h)
    return sum(((1 << b) + ((1 << b) >> 1)) * c
               for b, c in enumerate(h)) // max(total, 1)
