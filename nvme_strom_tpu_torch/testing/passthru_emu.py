"""Deterministic in-process NVMe passthrough emulator.

The port's own copy of the JAX package's emulator: the same 72-byte
commands, the same images and extent maps for the same calls.  Hosts
without ``/dev/ngXnY`` (CPU test hosts, containers, files on a network
filesystem) cannot run the real rung, so the passthrough data path —
blockmap resolution, per-extent eligibility splits, SLBA/NLB command
math, and the whole fault ladder (retries, health debits, hedged legs,
mirror fallback, per-member histograms feeding the autotuner) — is
exercised against this emulator instead: a flat "namespace" image file
served through the SAME 72-byte ``nvme_uring_cmd`` wire format the native
backend builds (csrc/strom_engine.cc, the userspace mirror of
``kmod/nvme_strom.c:1518-1589``).

The emulator is also its own oracle: :meth:`PassthruEmulator.provision`
copies a test file's bytes to gapped, deliberately-fragmented physical
ranges on the image and registers the matching synthetic extent map with
:mod:`..blockmap`.  Every command is validated against that
table — an SLBA/NLB pair that does not reverse-map to exactly the file
bytes the planner asked for is a hard error, never a wrong-bytes read.

The image is served from a shared, prefaulted mapping of its file
(remapped when it grows): a command costs no system call, as a device's
DMA costs the host none, and a large command's copy runs outside the
interpreter lock, so the pool's threads copy in parallel.  Writes go
through the file (``provision``, ``rewrite``), which the mapping sees.

Fault injection rides the attached source's :class:`FaultPlan` keyed by
*file* offset (reverse-mapped from the device offset), so a fault tier
fires identically whether the request went passthrough or O_DIRECT —
the property the passthrough gate's fail-stop leg depends on.
"""

from __future__ import annotations

import bisect
import ctypes
import mmap
import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import blockmap
from ..api import StromError

__all__ = ["PassthruEmulator", "NVME_CMD_READ"]

NVME_CMD_READ = 0x02

# struct nvme_uring_cmd — must stay layout-identical to the C mirror
# (nstpu_nvme_uring_cmd in csrc/strom_engine.cc)
_CMD = struct.Struct("=BBHIIIQQIIIIIIIIII")
assert _CMD.size == 72, _CMD.size

# a command at least this long copies with ctypes.memmove (the
# interpreter lock released); a shorter one by slice assignment
_MEMMOVE_MIN = 64 << 10


def pack_uring_cmd(*, nsid: int, slba: int, nlb0: int, data_len: int,
                   opcode: int = NVME_CMD_READ) -> bytes:
    """Build the 72-byte ``nvme_uring_cmd`` for a READ (nlb0 is 0-based)."""
    return _CMD.pack(opcode, 0, 0, nsid, 0, 0, 0, 0, 0, data_len,
                     slba & 0xFFFFFFFF, (slba >> 32) & 0xFFFFFFFF,
                     nlb0, 0, 0, 0, 0, 0)


class PassthruEmulator:
    """One emulated NVMe namespace backed by a flat image file."""

    def __init__(self, image_path: str, *, lba_shift: int = 9,
                 nsid: int = 1):
        if not 9 <= lba_shift <= 16:
            raise ValueError(f"lba_shift {lba_shift} outside NVMe range")
        self.image_path = image_path
        self.lba_shift = lba_shift
        self.lba_size = 1 << lba_shift
        self.nsid = nsid
        self._fd = os.open(image_path, os.O_RDWR | os.O_CREAT, 0o600)
        self._lock = threading.Lock()
        # provisioned ranges: dev_off -> (length, path, logical file off),
        # sorted, with their dev_offs apart for the lookup's bisection
        self._table: List[Tuple[int, int, str, int]] = []
        self._starts: List[int] = []
        self._paths: Dict[str, List[blockmap.Extent]] = {}
        self._alloc = self.lba_size  # LBA 0 left unprovisioned on purpose
        # the image's read mapping; mappings it outgrew stay open until
        # close(), as a command may still be copying from one
        self._view = memoryview(b"")
        self._base = 0          # the view's address
        self._maps: List[mmap.mmap] = []
        self._addrs: List[np.ndarray] = []   # each map's address holder
        self.commands_served = 0
        self.bytes_served = 0

    # ---- provisioning ----------------------------------------------------

    def provision(self, path: str, *, frag: int = 1,
                  gap: Optional[int] = None,
                  ineligible: Tuple[Tuple[int, int, int], ...] = ()
                  ) -> List[blockmap.Extent]:
        """Copy ``path``'s bytes onto the image at ``frag`` gapped physical
        ranges and register the synthetic extent map as the FIEMAP oracle.

        ``ineligible`` marks file ranges ``(logical_off, length, flags)``
        as their own extents carrying the given FIEMAP flags (e.g.
        UNWRITTEN/INLINE) — the planner must route those through O_DIRECT,
        and the emulator refuses commands touching them.
        """
        size = os.path.getsize(path)
        lba = self.lba_size
        gap = lba if gap is None else gap
        frag = max(1, min(frag, max(1, size // lba)))
        # logical cut points, LBA-aligned, then further cut at ineligible
        # range boundaries so flags apply to whole extents
        cuts = {0, size}
        step = (size // frag) & ~(lba - 1) or lba
        for c in range(step, size, step):
            cuts.add(c)
        for (off, length, _flags) in ineligible:
            cuts.add(max(0, min(off, size)))
            cuts.add(max(0, min(off + length, size)))
        points = sorted(cuts)

        def flags_for(lo: int) -> int:
            for (off, length, flags) in ineligible:
                if off <= lo < off + length:
                    return flags
            return 0

        exts: List[blockmap.Extent] = []
        with self._lock, open(path, "rb") as f:
            for lo, hi in zip(points, points[1:]):
                length = hi - lo
                if length <= 0:
                    continue
                dev_off = self._alloc
                # physical ranges stay LBA-aligned even when an ineligible
                # cut is not: eligibility, not alignment, excludes them
                self._alloc += (length + lba - 1) & ~(lba - 1)
                self._alloc += gap
                f.seek(lo)
                data = f.read(length)
                os.pwrite(self._fd, data, dev_off)
                flags = flags_for(lo)
                exts.append(blockmap.Extent(lo, dev_off, length, flags))
                if not flags:  # only eligible ranges are servable
                    self._table.append((dev_off, length, path, lo))
            self._table.sort()
            self._starts = [t[0] for t in self._table]
            self._paths[path] = exts
        blockmap.register_synthetic(path, exts)
        return exts

    def rewrite(self, path: str, file_off: int, data: bytes) -> None:
        """Mirror an out-of-band write into the image so the oracle and
        the device stay consistent (used by write-back tests AFTER the
        blockmap invalidation they exercise)."""
        with self._lock:
            for dev_off, length, p, lo in self._table:
                if p != path or not (lo <= file_off < lo + length):
                    continue
                span = min(len(data), lo + length - file_off)
                os.pwrite(self._fd, data[:span], dev_off + (file_off - lo))
                data = data[span:]
                file_off += span
                if not data:
                    return
        if data:
            raise StromError(5, f"rewrite outside provisioned ranges "
                                f"({path}@{file_off})")

    # ---- command service -------------------------------------------------

    def _lookup(self, dev_off: int, length: int) -> Tuple[str, int]:
        """Reverse-map a device range to (path, file_off); ERROR unless it
        sits wholly inside ONE eligible provisioned range — the SLBA/NLB
        oracle check."""
        i = bisect.bisect_right(self._starts, dev_off) - 1
        if i >= 0:
            toff, tlen, path, lo = self._table[i]
            if dev_off + length <= toff + tlen:
                return path, lo + (dev_off - toff)
        raise StromError(5, f"passthru cmd outside provisioned extents "
                            f"(dev_off={dev_off:#x} len={length})")

    def _mapped(self, end: int) -> memoryview:
        """The read view of the image, mapped anew when *end* lies past
        it and the image has grown since; the caller holds the lock."""
        if end > len(self._view):
            size = os.fstat(self._fd).st_size
            if size > len(self._view):
                mm = mmap.mmap(self._fd, size,
                               mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE",
                                                         0),
                               mmap.PROT_READ)
                self._maps.append(mm)
                self._addrs.append(np.frombuffer(mm, dtype=np.uint8))
                self._view = memoryview(mm)
                self._base = self._addrs[-1].ctypes.data
        return self._view

    def execute(self, cmd: bytes, dest: memoryview) -> Tuple[str, int]:
        """Serve one URING_CMD-shaped command into ``dest``.

        Validates the full command the way the device+kernel would —
        opcode, NSID, SLBA/NLB against data_len, containment in a
        provisioned eligible extent — then serves the bytes from the
        image.  Returns the reverse-mapped (path, file_off) so callers
        can key fault plans by file offset."""
        if len(cmd) != _CMD.size:
            raise StromError(22, f"bad nvme_uring_cmd size {len(cmd)}")
        f = _CMD.unpack(cmd)
        opcode, nsid, data_len = f[0], f[3], f[9]
        if opcode != NVME_CMD_READ:
            raise StromError(22, f"unsupported NVMe opcode {opcode:#x}")
        if nsid != self.nsid:
            raise StromError(22, f"wrong NSID {nsid} (ns is {self.nsid})")
        nblocks = (f[12] & 0xFFFF) + 1
        length = nblocks << self.lba_shift
        if data_len != length or dest.nbytes != length:
            raise StromError(22, f"NLB/data_len mismatch: {nblocks} blocks "
                                 f"vs data_len={data_len} dest={len(dest)}")
        dev_off = (f[10] | (f[11] << 32)) << self.lba_shift
        end = dev_off + length
        with self._lock:
            path, file_off = self._lookup(dev_off, length)
            view = self._view if end <= len(self._view) \
                else self._mapped(end)
            base = self._base
            self.commands_served += 1
            self.bytes_served += length
        have = max(0, min(length, len(view) - dev_off))
        if have >= _MEMMOVE_MIN:
            ctypes.memmove(np.frombuffer(dest, dtype=np.uint8).ctypes.data,
                           base + dev_off, have)
        else:
            dest[:have] = view[dev_off:dev_off + have]
        if have < length:      # provisioned past image EOF: zero-fill
            dest[have:] = bytes(length - have)
        return path, file_off

    # ---- source attachment ----------------------------------------------

    def attach(self, source) -> "_EmuChannel":
        """Attach this emulator to a (fake) source: memcpy_ssd2ram will
        split eligible extents onto the passthrough lane served here."""
        chan = _EmuChannel(self, source)
        source.passthru_channel = chan
        return chan

    def close(self) -> None:
        with self._lock:
            for path in list(self._paths):
                blockmap.unregister_synthetic(path)
            self._paths.clear()
            self._table.clear()
            self._view.release()
            self._view = memoryview(b"")
            self._base = 0
            self._addrs.clear()
            for mm in self._maps:
                try:
                    mm.close()
                except BufferError:
                    pass       # a view still held: it dies with it
            self._maps.clear()
            if self._fd >= 0:
                os.close(self._fd)
                self._fd = -1

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class _EmuChannel:
    """The session-facing passthrough channel the emulator provides.

    ``pool_ok=True`` routes passthrough requests down the Python pool
    lanes (where the fault ladder lives): a task on the native engine
    drops this channel and reads O_DIRECT, so a source with an emulator
    attached is read under ``io_backend="python"`` (or is a fake, whose
    overridden legs ride the pools anyway).  The native channel of a real
    host sets pool_ok=False and the engine submits flagged requests."""

    pool_ok = True
    native = False

    def __init__(self, emu: PassthruEmulator, source):
        self.emu = emu
        self.source = source
        self.lba_size = emu.lba_size
        self.lba_shift = emu.lba_shift
        self._paths: Dict[int, Optional[str]] = {}

    def device_base(self, path: str) -> int:
        """The image's offsets are the blockmap's own: nothing to add."""
        return 0

    def member_path(self, member: int) -> Optional[str]:
        try:
            return self._paths[member]
        except KeyError:
            from ..engine import _member_path
            path = self._paths[member] = _member_path(self.source, member)
            return path

    def read(self, member: int, file_off: int, dev_off: int,
             dest: memoryview) -> None:
        """One passthrough read, byte-for-byte through the wire format,
        with the source's FaultPlan applied exactly like the O_DIRECT
        lane (same file-offset keying, same corruption hook)."""
        n = dest.nbytes
        plan = getattr(self.source, "fault_plan", None)
        if plan is not None:
            plan.check(file_off, n, member=member)
        slba = dev_off >> self.lba_shift
        # pack_uring_cmd's bytes, packed in place (one call a command)
        cmd = _CMD.pack(NVME_CMD_READ, 0, 0, self.emu.nsid, 0, 0, 0, 0, 0,
                        n, slba & 0xFFFFFFFF, (slba >> 32) & 0xFFFFFFFF,
                        (n >> self.lba_shift) - 1, 0, 0, 0, 0, 0)
        path, mapped_off = self.emu.execute(cmd, dest)
        want = self.member_path(member)
        if want is not None and (path != want or mapped_off != file_off):
            raise StromError(5, f"SLBA math drift: cmd mapped to "
                                f"{path}@{mapped_off}, planner meant "
                                f"{want}@{file_off}")
        if plan is not None:
            plan.apply_corruption(file_off, dest)
