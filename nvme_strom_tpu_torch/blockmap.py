"""File -> device-LBA extent resolution for the NVMe passthrough backend.

The port's own copy of the JAX package's ``blockmap``: the same extents,
splits and counters.  The reference resolves every file block to a device
block inside the kernel before building raw NVMe commands
(``kmod/nvme_strom.c:1136-1224``, the ``file block -> device block``
walk).  Userspace gets the same answer from
the FIEMAP ioctl: each planned extent maps to one or more physical device
byte ranges, which the engine turns into SLBA/NLB pairs for
``IORING_OP_URING_CMD`` READ commands.

Three properties matter and are all enforced here:

* **Refuse what FIEMAP cannot promise.**  Unwritten, inline, delalloc,
  compressed/encoded, encrypted, or unaligned extents do NOT have the
  bytes-on-device the command would read; any request touching one rides
  the O_DIRECT lanes of the same task instead (the per-extent split,
  like the residency tiers' hit/miss split).  A filesystem that lies in
  FIEMAP is caught by the passthrough gate's byte-identity check
  (:mod:`.testing.passthru_gate`), not trusted here.
* **Cache per generation.**  Mappings are cached per path keyed on
  ``(st_ino, st_size, st_mtime_ns)``; a write-back through the framework's
  own ladder calls :func:`invalidate` at the same site that invalidates
  the resident cache, and out-of-band writers are caught by the
  generation key changing.
* **Deterministic without a device.**  The passthrough emulator
  (:mod:`.testing.passthru_emu`) registers synthetic extent maps
  (:func:`register_synthetic`); those take priority over the ioctl so
  every SLBA/NLB computation is testable against a known oracle on hosts
  with no NVMe device at all.

FIEMAP's physical offsets are relative to the file's own block device.
Before a real char device reads them, :func:`namespace_base` checks
through sysfs that the file lives on the namespace that device addresses
and gives the partition's start to add. A file on another drive, or one
under a dm, md or other stacked device, is refused.
"""

from __future__ import annotations

import os
import struct
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .stats import stats

__all__ = [
    "Extent", "map_file", "resolve", "resolve_split", "invalidate",
    "invalidate_source", "register_synthetic", "unregister_synthetic",
    "fiemap_supported", "fragmentation", "namespace_base",
    "MEMBER_REASONS",
]

# ioctl + wire layout (linux/fiemap.h); values are ABI, not configuration
_FS_IOC_FIEMAP = 0xC020660B
_FIEMAP_FLAG_SYNC = 0x1
_FIEMAP_EXTENT_LAST = 0x1

# extent flags that make passthrough unsafe: the physical range either
# does not exist, is not yet the data, or is not the raw bytes
_FIEMAP_EXTENT_UNKNOWN = 0x2
_FIEMAP_EXTENT_DELALLOC = 0x4
_FIEMAP_EXTENT_ENCODED = 0x8
_FIEMAP_EXTENT_DATA_ENCRYPTED = 0x80
_FIEMAP_EXTENT_NOT_ALIGNED = 0x100
_FIEMAP_EXTENT_DATA_INLINE = 0x200
_FIEMAP_EXTENT_DATA_TAIL = 0x400
_FIEMAP_EXTENT_UNWRITTEN = 0x800

INELIGIBLE_FLAGS = (_FIEMAP_EXTENT_UNKNOWN | _FIEMAP_EXTENT_DELALLOC
                    | _FIEMAP_EXTENT_ENCODED | _FIEMAP_EXTENT_DATA_ENCRYPTED
                    | _FIEMAP_EXTENT_NOT_ALIGNED | _FIEMAP_EXTENT_DATA_INLINE
                    | _FIEMAP_EXTENT_DATA_TAIL | _FIEMAP_EXTENT_UNWRITTEN)

_HDR = struct.Struct("=QQIIII")          # fiemap header, 32 bytes
# fiemap_extent, 56 bytes: fe_logical, fe_physical, fe_length,
# fe_reserved64[2], fe_flags, fe_reserved[3] (the JAX package's "=QQQQQIII"
# is 52 bytes: it misreads every extent after the first, and a map of 119
# or more extents overruns its buffer)
_EXT = struct.Struct("=QQQQQIIII")
assert _EXT.size == 56, _EXT.size
_EXTENTS_PER_CALL = 128


@dataclass(frozen=True)
class Extent:
    """One mapped extent: file byte range -> device byte range."""
    logical: int    # file byte offset
    physical: int   # device byte offset
    length: int     # bytes
    flags: int      # raw FIEMAP_EXTENT_* flags

    @property
    def eligible(self) -> bool:
        return (self.flags & INELIGIBLE_FLAGS) == 0


def _generation(path: str) -> Optional[Tuple[int, int, int]]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_ino, st.st_size, st.st_mtime_ns)


_lock = threading.Lock()
# path -> (generation, extents sorted by logical)
_cache: Dict[str, Tuple[Tuple[int, int, int], List[Extent]]] = {}
# path -> extents; the emulator's oracle, generation-exempt (it owns writes)
_synthetic: Dict[str, List[Extent]] = {}


def _fiemap_ioctl(path: str) -> Optional[List[Extent]]:
    """Raw FIEMAP walk of one file; None when the ioctl is unsupported."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-Linux stub
        return None
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        size = os.fstat(fd).st_size
        out: List[Extent] = []
        start = 0
        while start < size or (size == 0 and not out):
            buf = bytearray(_HDR.size + _EXTENTS_PER_CALL * _EXT.size)
            _HDR.pack_into(buf, 0, start, size - start or 1,
                           _FIEMAP_FLAG_SYNC, 0, _EXTENTS_PER_CALL, 0)
            try:
                fcntl.ioctl(fd, _FS_IOC_FIEMAP, buf)
            except OSError:
                return None  # FS without FIEMAP (or blocked by seccomp)
            n = _HDR.unpack_from(buf, 0)[3]  # fm_mapped_extents
            if n == 0:
                break
            last = False
            for i in range(min(n, _EXTENTS_PER_CALL)):
                (fe_logical, fe_physical, fe_length, _r0, _r1, fe_flags,
                 _r2, _r3, _r4) = _EXT.unpack_from(buf,
                                                   _HDR.size + i * _EXT.size)
                out.append(Extent(fe_logical, fe_physical, fe_length,
                                  fe_flags))
                if fe_flags & _FIEMAP_EXTENT_LAST:
                    last = True
            if last:
                break
            start = out[-1].logical + out[-1].length
        out.sort(key=lambda e: e.logical)
        return out
    finally:
        os.close(fd)


def register_synthetic(path: str, extents: List[Extent]) -> None:
    """Install an emulator-provided extent map for ``path`` (the FIEMAP
    oracle on hosts without an NVMe device).  Takes priority over the
    real ioctl and over the generation cache."""
    with _lock:
        _synthetic[path] = sorted(extents, key=lambda e: e.logical)
        _cache.pop(path, None)


def unregister_synthetic(path: str) -> None:
    with _lock:
        _synthetic.pop(path, None)
        _cache.pop(path, None)


def map_file(path: str) -> Optional[List[Extent]]:
    """Extent map for ``path`` (generation-cached), or None when FIEMAP
    is unavailable for it."""
    with _lock:
        syn = _synthetic.get(path)
        if syn is not None:
            return list(syn)
        gen = _generation(path)
        cached = _cache.get(path)
        if cached is not None and gen is not None and cached[0] == gen:
            return list(cached[1])
    exts = _fiemap_ioctl(path)
    stats.add("nr_blockmap_resolve")
    if exts is None or gen is None:
        return exts
    with _lock:
        # re-stat under the lock: a write racing the walk must not pin a
        # stale map under the NEW generation key
        gen2 = _generation(path)
        if gen2 == gen:
            _cache[path] = (gen, exts)
    return list(exts)


def resolve(path: str, file_off: int, length: int,
            lba_size: int) -> Optional[List[Tuple[int, int]]]:
    """Resolve ``[file_off, file_off+length)`` of ``path`` to device byte
    ranges ``[(dev_off, length), ...]`` safe for raw NVMe READ commands.

    Returns None — refuse passthrough for this span, ride O_DIRECT —
    when any covering extent is missing/ineligible, when the span falls
    in a hole, or when a resolved device range is not LBA-aligned."""
    if length <= 0:
        return None
    exts = map_file(path)
    if exts is None:
        return None
    mask = lba_size - 1
    out: List[Tuple[int, int]] = []
    pos = file_off
    end = file_off + length
    for e in exts:
        if e.logical + e.length <= pos:
            continue
        if e.logical > pos:
            return None  # hole at pos
        if not e.eligible:
            return None
        take = min(end, e.logical + e.length) - pos
        dev_off = e.physical + (pos - e.logical)
        if (dev_off & mask) or (take & mask):
            return None
        out.append((dev_off, take))
        pos += take
        if pos >= end:
            return out
    return None  # span extends past the last extent (hole at EOF)


def resolve_split(path: str, file_off: int, length: int,
                  lba_size: int) -> List[Tuple[int, int, Optional[int]]]:
    """Partition ``[file_off, file_off+length)`` into maximal runs
    ``[(file_off, length, dev_off-or-None), ...]`` — the per-extent
    split: runs with a device offset are passthrough-safe, runs with
    None (hole, ineligible flags, misalignment, no map at all) ride
    O_DIRECT.  Run boundaries stay LBA-aligned in FILE space so the
    refused neighbours remain O_DIRECT-legal."""
    if length <= 0:
        return []
    exts = map_file(path)
    if exts is None:
        return [(file_off, length, None)]
    mask = lba_size - 1
    out: List[Tuple[int, int, Optional[int]]] = []

    def emit(fo: int, ln: int, dev: Optional[int]) -> None:
        if ln <= 0:
            return
        if dev is None and out and out[-1][2] is None:
            po, pl, _ = out[-1]
            out[-1] = (po, pl + ln, None)   # merge refused neighbours
            return
        out.append((fo, ln, dev))

    pos, end = file_off, file_off + length
    for e in exts:
        if e.logical + e.length <= pos:
            continue
        if e.logical >= end:
            break
        if e.logical > pos:                 # hole before this extent
            emit(pos, min(e.logical, end) - pos, None)
            pos = min(e.logical, end)
            if pos >= end:
                break
        take = min(end, e.logical + e.length) - pos
        if not e.eligible:
            emit(pos, take, None)
            pos += take
            continue
        if pos & mask:                      # shave head to LBA alignment
            head = min(take, lba_size - (pos & mask))
            emit(pos, head, None)
            pos += head
            take -= head
            if take <= 0:
                continue
        dev = e.physical + (pos - e.logical)
        body = take & ~mask
        if (dev & mask) or body == 0:
            emit(pos, take, None)
            pos += take
            continue
        emit(pos, body, dev)
        pos += body
        if take - body:                     # unaligned tail of the extent
            emit(pos, take - body, None)
            pos += take - body
    if pos < end:                           # hole at/after EOF
        emit(pos, end - pos, None)
    return out


def invalidate(path: str) -> None:
    """Drop the cached mapping for one path (write-ladder contract: called
    at the same site that invalidates the resident cache)."""
    with _lock:
        dropped = _cache.pop(path, None)
    if dropped is not None:
        stats.add("nr_blockmap_invalidate")


def invalidate_source(source) -> None:
    """Invalidate every member path of a source (best effort: sources
    without path-bearing members have nothing cached here)."""
    for path in _member_paths(source):
        invalidate(path)


def _member_paths(source) -> List[str]:
    paths = []
    members = getattr(source, "members", None)
    if members:
        for m in members:
            p = getattr(m, "path", None)
            if p:
                paths.append(str(p))
    else:
        m = getattr(source, "_m", None)
        p = getattr(m, "path", None) if m is not None else None
        if p:
            paths.append(str(p))
    return paths


def fiemap_supported(path: str) -> bool:
    """True when FIEMAP answers for ``path`` (strom_check's blockmap row)."""
    return map_file(path) is not None


def fragmentation(path: str) -> Optional[Tuple[int, int, int]]:
    """(extent count, mapped bytes, passthrough-eligible bytes) for one
    file, or None when FIEMAP is unavailable — feeds strom_check's
    extents/GB and %-eligible summary."""
    exts = map_file(path)
    if exts is None:
        return None
    total = sum(e.length for e in exts)
    eligible = sum(e.length for e in exts if e.eligible)
    return (len(exts), total, eligible)


#: where :func:`namespace_base` reads the block layer
SYSFS = "/sys"

#: why :func:`namespace_base` keeps a file off a char device's lane
MEMBER_REASONS = ("otherdev", "stacked", "nosysfs")


def file_devno(path: str) -> int:
    """The block device number *path* lives on (``st_dev``)."""
    return os.stat(path).st_dev


def _sysfs_read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def namespace_base(path: str, chardev: str) -> Tuple[Optional[int], str]:
    """Whether the NVMe generic char device *chardev* (``/dev/ngXnY``)
    addresses *path*'s physical offsets, read from sysfs.

    Returns ``(base, "")`` when the file's block device is namespace
    ``nvmeXnY`` beside ``ngXnY``, or a partition of it. *base* is then
    the partition's start in bytes, which a FIEMAP physical offset needs
    added (0 for the whole namespace). Otherwise it returns
    ``(None, reason)``. The reason is ``stacked`` when a dm, md or other
    device with slaves sits between the file and the drive, ``otherdev``
    when the file is on another namespace or drive, and ``nosysfs`` when
    sysfs has no answer, as for a btrfs volume's anonymous device."""
    try:
        dev = file_devno(path)
    except OSError:
        return None, "nosysfs"
    blk = os.path.realpath(os.path.join(
        SYSFS, "dev", "block", f"{os.major(dev)}:{os.minor(dev)}"))
    if not os.path.isdir(blk):
        return None, "nosysfs"
    base = 0
    if os.path.exists(os.path.join(blk, "partition")):
        start = _sysfs_read(os.path.join(blk, "start"))
        if start is None or not start.isdigit():
            return None, "nosysfs"
        # sysfs counts a partition's start in 512-byte sectors, whatever
        # the LBA size: a partition table places it on an LBA boundary
        base = int(start) * 512
        blk = os.path.dirname(blk)
    try:
        if os.listdir(os.path.join(blk, "slaves")):
            return None, "stacked"
    except OSError:
        pass
    ng = os.path.realpath(os.path.join(SYSFS, "class", "nvme-generic",
                                       os.path.basename(chardev)))
    if not os.path.isdir(ng):
        return None, "nosysfs"
    name, ngname = os.path.basename(blk), os.path.basename(ng)
    # a namespace's block and char devices sit side by side under one
    # controller (or one subsystem, with native multipath) as nvmeXnY
    # and ngXnY
    if (os.path.dirname(blk) != os.path.dirname(ng)
            or not name.startswith("nvme") or not ngname.startswith("ng")
            or name[4:] != ngname[2:]):
        return None, "otherdev"
    return base, ""
