"""Fake backends for hardware-free tests: the JAX package's
``testing/fake.py``.

* :func:`make_test_file` / :func:`expected_bytes` — deterministic content
  (every 8-byte word is its own offset xor a seed hash), so a wrong byte
  names its offset;
* :class:`FaultPlan` — seeded fault injection on the read and write legs,
  mapped onto the engine's error taxonomy;
* :class:`FakeNvmeSource` / :class:`FakeStripedNvmeSource` — a file, or a
  striped (optionally paired) member set, whose read and write legs
  consult a plan.  Overriding the legs routes every request down the
  engine's python pools, where the fault ladder runs;
* :class:`backend_fault` — a device-backend failure at the bounded fence;
* :func:`flip_resident_host` / :func:`flip_resident_hbm` — bit rot seeded
  in a RAM-tier slab or an HBM-tier tensor, and :func:`reset_residency`,
  which empties both tiers between tests.
"""

from __future__ import annotations

import errno as _errno
import hashlib
import os
import random
import time
from dataclasses import dataclass, field
from typing import Optional, Set

import numpy as np

from ..api import ErrorClass, StromError
from ..engine import PlainSource, Source, StripedSource

__all__ = ["make_test_file", "expected_bytes", "FaultPlan", "FakeNvmeSource",
           "FakeStripedNvmeSource", "backend_fault", "flip_resident_host",
           "flip_resident_hbm", "reset_residency"]


def _seed_hash(seed: int) -> np.uint64:
    return np.uint64(int.from_bytes(hashlib.blake2b(
        str(seed).encode(), digest_size=8).digest(), "little"))


def _words(first_word: int, n_words: int, seed: int) -> bytes:
    offs = np.arange(first_word, first_word + n_words, dtype=np.uint64) \
        * np.uint64(8)
    return (offs ^ _seed_hash(seed)).astype("<u8").tobytes()


def make_test_file(path: str, size: int, *, seed: int = 0) -> None:
    """A file of *size* bytes whose every 8-byte word encodes its own
    offset xor a seed hash."""
    with open(path, "wb") as f:
        piece = 1 << 20
        for off in range(0, size, piece):
            n = min(piece, size - off)
            f.write(_words(off // 8, (n + 7) // 8, seed)[:n])


def expected_bytes(offset: int, length: int, *, seed: int = 0) -> bytes:
    """The bytes :func:`make_test_file` wrote at ``[offset, offset +
    length)``."""
    w0 = offset // 8
    w1 = (offset + length + 7) // 8
    head = offset - w0 * 8
    return _words(w0, w1 - w0, seed)[head:head + length]


@dataclass
class FaultPlan:
    """Deterministic fault injection.

    Read tiers (the direct-read count ``_count``):

    * ``fail_offsets`` — PERSISTENT dead regions: the direct read and the
      buffered fallback both fail, so the task latches EIO;
    * ``fail_every_nth`` / ``fail_rate`` — TRANSIENT EIO on the direct leg
      only (``fail_rate`` draws from ``random.Random(seed)``);
    * ``latency_s`` / ``slow_member`` + ``slow_s`` — a slow device, a slow
      member;
    * ``corrupt_offsets`` / ``corrupt_once_offsets`` — a byte flipped on
      every read, or on the first read only;
    * ``failstop_member`` + ``failstop_after`` [+ ``rejoin_after``] — from
      that read count every read of the member (direct and buffered)
      raises PERSISTENT EIO; from ``rejoin_after`` it answers again.

    Write tiers, on their own count ``_wcount``:

    * ``write_fail_every_nth`` / ``write_fail_rate`` — write faults of
      ``write_errno`` (EIO, TRANSIENT; ENOSPC for a PERSISTENT storm);
    * ``write_failstop_member`` + ``write_failstop_after``
      [+ ``write_rejoin_after``] — the member's writes hard-fail, its
      reads keep answering;
    * ``torn_write_offsets`` — one byte at each listed member offset is
      flipped on disk after the covering write lands (once each), for the
      ``write_verify`` read-back;
    * ``slow_write_member`` + ``slow_write_s``.

    The resident-corruption tier: ``corrupt_member_offsets`` —
    ``{member: {offsets}}``, one byte at each listed offset of that
    member's file flipped on disk after the covering write lands (once
    each), so one leg of a mirrored pair rots and its partner stays
    clean.  Rot in a RAM slab or an HBM extent has no disk form: seed it
    with :func:`flip_resident_host` / :func:`flip_resident_hbm`.
    """

    fail_offsets: Set[int] = field(default_factory=set)
    fail_every_nth: int = 0
    fail_rate: float = 0.0
    seed: int = 0
    latency_s: float = 0.0
    slow_member: Optional[int] = None
    slow_s: float = 0.0
    corrupt_offsets: Set[int] = field(default_factory=set)
    corrupt_once_offsets: Set[int] = field(default_factory=set)
    failstop_member: Optional[int] = None
    failstop_after: int = 0
    rejoin_after: Optional[int] = None
    write_fail_every_nth: int = 0
    write_fail_rate: float = 0.0
    write_errno: int = _errno.EIO
    write_failstop_member: Optional[int] = None
    write_failstop_after: int = 0
    write_rejoin_after: Optional[int] = None
    torn_write_offsets: Set[int] = field(default_factory=set)
    corrupt_member_offsets: dict = field(default_factory=dict)
    slow_write_member: Optional[int] = None
    slow_write_s: float = 0.0
    _count: int = 0
    _wcount: int = 0
    _rng: object = field(default=None, repr=False)
    _wrng: object = field(default=None, repr=False)

    def failstopped(self, member: Optional[int]) -> bool:
        """Is *member* inside its read fail-stop window now?"""
        return (self.failstop_member is not None
                and member == self.failstop_member
                and self._count >= self.failstop_after
                and (self.rejoin_after is None
                     or self._count < self.rejoin_after))

    def write_failstopped(self, member: Optional[int]) -> bool:
        """Is *member* inside its write fail-stop window now?"""
        return (self.write_failstop_member is not None
                and member == self.write_failstop_member
                and self._wcount >= self.write_failstop_after
                and (self.write_rejoin_after is None
                     or self._wcount < self.write_rejoin_after))

    def check_write(self, file_off: int, length: int,
                    member: Optional[int] = None) -> None:
        """The write legs' gate (the engine's ladder and the journal
        replay both write through it)."""
        self._wcount += 1
        if self.latency_s:
            time.sleep(self.latency_s)
        if self.slow_write_s and member is not None \
                and member == self.slow_write_member:
            time.sleep(self.slow_write_s)
        if self.write_failstopped(member):
            raise StromError(_errno.EIO,
                             f"injected write fail-stop of member {member}",
                             error_class=ErrorClass.PERSISTENT)
        if self.write_fail_every_nth \
                and self._wcount % self.write_fail_every_nth == 0:
            raise StromError(self.write_errno,
                             f"injected periodic write fault #{self._wcount}")
        if self.write_fail_rate > 0.0:
            if self._wrng is None:
                self._wrng = random.Random(self.seed ^ 0x5A5A5A5A)
            if self._wrng.random() < self.write_fail_rate:
                raise StromError(self.write_errno, f"injected random write "
                                                   f"fault #{self._wcount}")

    def take_torn(self, file_off: int, length: int) -> list:
        """Pop the torn offsets a landed write covers."""
        hit = [off for off in self.torn_write_offsets
               if file_off <= off < file_off + length]
        for off in hit:
            self.torn_write_offsets.discard(off)
        return hit

    def take_member_corrupt(self, member: Optional[int], file_off: int,
                            length: int) -> list:
        """Pop *member*'s rot offsets a landed write covers."""
        offs = self.corrupt_member_offsets.get(member)
        if not offs:
            return []
        hit = [off for off in offs if file_off <= off < file_off + length]
        for off in hit:
            offs.discard(off)
        return hit

    def check(self, file_off: int, length: int,
              member: Optional[int] = None) -> None:
        """The direct read leg's gate."""
        self._count += 1
        if self.latency_s:
            time.sleep(self.latency_s)
        if self.slow_s and member is not None and member == self.slow_member:
            time.sleep(self.slow_s)
        if self.failstopped(member):
            raise StromError(_errno.EIO,
                             f"injected fail-stop of member {member}",
                             error_class=ErrorClass.PERSISTENT)
        if self.fail_every_nth and self._count % self.fail_every_nth == 0:
            raise StromError(_errno.EIO,
                             f"injected periodic fault #{self._count}")
        if self.fail_rate > 0.0:
            if self._rng is None:
                self._rng = random.Random(self.seed)
            if self._rng.random() < self.fail_rate:
                raise StromError(_errno.EIO,
                                 f"injected random fault #{self._count}")
        self.check_buffered(file_off, length, member=member)

    def check_buffered(self, file_off: int, length: int,
                       member: Optional[int] = None) -> None:
        """The persistent tier only, consulted by the buffered leg: dead
        regions and fail-stopped members stay dead on every path."""
        if self.failstopped(member):
            raise StromError(_errno.EIO,
                             f"injected fail-stop of member {member}",
                             error_class=ErrorClass.PERSISTENT)
        for off in self.fail_offsets:
            if file_off <= off < file_off + length:
                raise StromError(_errno.EIO, f"injected fault at {off}")

    def apply_corruption(self, file_off: int, dest: memoryview) -> None:
        for off in self.corrupt_offsets:
            if file_off <= off < file_off + len(dest):
                dest[off - file_off] ^= 0xFF
        hit = [off for off in self.corrupt_once_offsets
               if file_off <= off < file_off + len(dest)]
        for off in hit:
            dest[off - file_off] ^= 0xFF
            self.corrupt_once_offsets.discard(off)


def _tear_landed(member_obj, plan: FaultPlan, file_off: int,
                 length: int, member: Optional[int] = None) -> None:
    """Flip each torn offset a write just landed, and each of *member*'s
    rot offsets, on disk through the member's buffered fd, and fsync: an
    O_DIRECT read-back sees them."""
    hit = plan.take_torn(file_off, length) \
        + plan.take_member_corrupt(member, file_off, length)
    if not hit:
        return
    fd = member_obj.fd_buffered
    for off in hit:
        b = os.pread(fd, 1, off)
        os.pwrite(fd, bytes([b[0] ^ 0xFF]), off)
    os.fsync(fd)


class _FaultLegs:
    """The read and write legs of a fake: each consults the plan, then
    runs the real O_DIRECT or buffered leg, so alignment stays real."""

    fault_plan: FaultPlan
    force_cached_fraction: Optional[float]

    def _member_obj(self, member: int):
        raise NotImplementedError

    def read_member_direct(self, member: int, file_off: int,
                           dest: memoryview) -> None:
        self.fault_plan.check(file_off, len(dest), member=member)
        super().read_member_direct(member, file_off, dest)
        self.fault_plan.apply_corruption(file_off, dest)

    def read_member_buffered(self, member: int, file_off: int,
                             dest: memoryview) -> None:
        # the ladder's buffered rung reads through here: dead regions fail
        # it too, transient plans do not
        self.fault_plan.check_buffered(file_off, len(dest), member=member)
        super().read_member_buffered(member, file_off, dest)

    def write_member_direct(self, member: int, file_off: int,
                            src: memoryview) -> None:
        self.fault_plan.check_write(file_off, len(src), member=member)
        super().write_member_direct(member, file_off, src)
        _tear_landed(self._member_obj(member), self.fault_plan, file_off,
                     len(src), member)

    def write_member_buffered(self, member: int, file_off: int,
                              src: memoryview) -> None:
        self.fault_plan.check_write(file_off, len(src), member=member)
        super().write_member_buffered(member, file_off, src)
        _tear_landed(self._member_obj(member), self.fault_plan, file_off,
                     len(src), member)

    def cached_fraction(self, offset: int, length: int) -> float:
        if self.force_cached_fraction is not None:
            return self.force_cached_fraction
        return super().cached_fraction(offset, length)

    def probe_file(self):
        # a forced verdict is no kernel probe to check; else the file's
        if self.force_cached_fraction is not None:
            return None
        return self._member_obj(0)

    def hot_fraction(self, offset: int, length: int) -> float:
        # a forced cache verdict owns arbitration: only explicit hints
        # count, not the dirty pages of a freshly written test file
        if self.force_cached_fraction is not None:
            return Source.hot_fraction(self, offset, length)
        return super().hot_fraction(offset, length)


class FakeNvmeSource(_FaultLegs, PlainSource):
    """A file as a loopback 'NVMe device' with injected faults."""

    def __init__(self, path: str, *, fault_plan: Optional[FaultPlan] = None,
                 block_size: int = 512,
                 force_cached_fraction: Optional[float] = None,
                 writable: bool = False):
        PlainSource.__init__(self, path, block_size, writable=writable)
        self.fault_plan = fault_plan or FaultPlan()
        self.force_cached_fraction = force_cached_fraction

    def _member_obj(self, member: int):
        return self._m


class FakeStripedNvmeSource(_FaultLegs, StripedSource):
    """A striped (``mirror='paired'``: RAID-10) set of member files with
    per-member injected faults: the member index flows into the plan, so
    a slow or failing member stalls only its own python pool."""

    def __init__(self, paths, stripe_chunk_size: int, *,
                 fault_plan: Optional[FaultPlan] = None,
                 block_size: int = 512,
                 force_cached_fraction: Optional[float] = None,
                 mirror: Optional[str] = None, writable: bool = False):
        StripedSource.__init__(self, paths, stripe_chunk_size, block_size,
                               writable=writable, mirror=mirror)
        self.fault_plan = fault_plan or FaultPlan()
        self.force_cached_fraction = force_cached_fraction

    def _member_obj(self, member: int):
        return self.members[member]


def flip_resident_host(skey, base: int, length: int, pos: int = 0) -> bool:
    """Flip one byte of a resident RAM-tier slab in place; False when the
    extent is not resident."""
    from ..cache import residency_cache
    return residency_cache._flip_resident_byte(skey, base, length, pos)


def flip_resident_hbm(skey, base: int, length: int, pos: int = 0) -> bool:
    """Flip one byte of a resident HBM-tier extent on its device; False
    when the extent is not resident."""
    from ..serving.hbm_tier import hbm_tier
    return hbm_tier._flip_resident_byte(skey, base, length, pos)


def reset_residency(device="cpu") -> None:
    """Empty both residency tiers, then re-read their capacities and the
    integrity mode from config, the HBM tier placing on *device*: a
    test's isolation (the tiers and the domain are process-wide)."""
    from ..cache import residency_cache
    from ..integrity import domain
    from ..serving.hbm_tier import hbm_tier
    from ..tiering import extent_space
    residency_cache.clear()
    hbm_tier.clear()
    extent_space.configure(device=device)
    domain.configure()


class backend_fault:
    """Context manager injecting a device-backend failure at the bounded
    fence: ``mode="hang"`` makes the next fence outlast its timeout
    (config ``backend_fence_timeout``), ``mode="error"`` raises a runtime
    error from it.  Either way the monitor latches loss and the fence
    raises ENODEV: a loader or restore fails instead of hanging.

    On exit the latch is reset; buffers already revoked stay revoked."""

    def __init__(self, mode: str = "hang", *, hang_s: float = 30.0):
        if mode not in ("hang", "error"):
            raise ValueError(f"backend_fault mode {mode!r}")
        self.mode = mode
        self.hang_s = hang_s

    def __enter__(self):
        from ..hbm.backend import monitor

        def hook(what: str) -> None:
            if self.mode == "error":
                raise RuntimeError(f"injected device failure during {what}")
            time.sleep(self.hang_s)   # the bounded fence times out first

        monitor._set_fault(hook)
        return self

    def __exit__(self, *exc):
        from ..hbm.backend import monitor
        monitor._set_fault(None)
        monitor.reset()
        return False
