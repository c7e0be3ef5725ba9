"""The RAM tier of the residency hierarchy: the JAX package's
``cache.py``.

An owned capacity tier between the SSD and the card: page-aligned
anonymous host slabs keyed by ``(source key, base, length)``, sized by
config ``tier_ram_bytes`` (``cache_bytes``) and evicted by byte-weighted
ARC, so one streaming scan cannot flush the hot set.  A Session consults
it when it plans a read: a hit is copied straight into the destination (no
submission, no residency probe), a miss is filled into a slab at wait
time, after the fault ladder (retry, hedge, mirror, checksum re-read)
healed its bytes, so a quarantined member still fills the tier through
its mirror.  The slabs are plain host memory, as in the JAX package: a hit
lands in the Session's pinned staging buffer and goes on to the card as
any other chunk does.

* **Keying** — a source's identity is the tuple of its members' real
  paths (:func:`.tiering.source_key`); an extent is ``(base, length)`` in
  the source's logical bytes.  Lookups are exact: a task reads on a fixed
  chunk grid, so fills and hits agree.
* **ARC** — ``t1`` holds extents touched once, ``t2`` twice or more; the
  ghosts ``b1`` / ``b2`` remember recently evicted keys (their lengths
  only) and steer the target ``p`` (bytes granted to recency), which
  starts at 0, so scan-once traffic evicts itself first.
* **Leases** — a hit returns a refcounted :class:`CacheLease`; eviction
  skips a leased entry and invalidation marks it stale, so a task in the
  middle of a copy never reads a recycled slab.  A stale entry is never
  served and is freed at its last release.
* **Coherency** — the write path and the checkpoint savers invalidate
  through :data:`.tiering.extent_space`.  A write through another framing
  of a shared file (a plain source over one stripe member) drops every
  entry over that file, because offsets do not map across framings.
* **Integrity and pinning** — each slab carries the crc32c of the
  integrity domain (:mod:`.integrity`) and is mlocked where the host
  allows it: a refused mlock is counted (``nr_cache_mlock_fail``) and the
  slab runs unpinned; ``memlock_budget`` bounds the pinned bytes, past it
  fills pass through to the SSD and a shrink sheds slabs.

The module-global :data:`residency_cache` keeps the one-branch-when-off
contract: ``configure()`` reads the capacity once, and the hot paths test
the plain ``active`` attribute.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

from .config import config
from .stats import stats
from .trace import recorder as _trace
from .integrity import domain as _integrity
from .tiering import TierLease, extent_space, source_key as _source_key

__all__ = ["ResidencyCache", "CacheLease", "residency_cache"]

#: MAP_POPULATE where the platform has it (a slab's pages are faulted in
#: by the mmap itself)
_POPULATE = getattr(mmap, "MAP_POPULATE", 0)

_libc = None
try:  # pragma: no cover - platform probe
    _libc = ctypes.CDLL(None, use_errno=True)
except OSError:  # pragma: no cover
    _libc = None


class _Entry:
    __slots__ = ("key", "mm", "view", "length", "logical_length", "refs",
                 "stale", "crc", "source_ref", "pinned", "spec", "detached")

    def __init__(self, key, mm, length: int,
                 logical_length: int = 0, crc=None, source_ref=None) -> None:
        self.key = key
        self.mm = mm
        self.view = memoryview(mm)
        self.length = length
        # packed extents (compute pushdown) serve more logical bytes
        # than they occupy; capacity is charged at `length`, service
        # credited at `logical_length`
        self.logical_length = logical_length or length
        self.refs = 0
        self.stale = False
        # integrity domain: fill-time crc32c (None under
        # integrity=off), a weakref to the source for scrub healing, and
        # whether mlock(2) actually pinned this slab
        self.crc = crc
        self.source_ref = source_ref
        self.pinned = False
        # readahead provenance: speculative fills carry
        # spec=True until the first demand touch, keeping ARC's ghost
        # lists and target pointer blind to speculation
        self.spec = False
        # exclusive migration: an entry surrendered to the
        # tier above while a lease still pins it — NOT stale (the
        # promoted bytes are identical, the reader's copy stays valid),
        # but gone from the maps and freed at the last release
        self.detached = False

    def free(self) -> None:
        try:
            self.view.release()
        except BufferError:  # pragma: no cover - defensive
            pass
        try:
            self.mm.close()
        except BufferError:  # pragma: no cover - mlock address export
            pass


class CacheLease(TierLease):
    """Refcounted pin on a RAM-resident slab: the unified
    :class:`.tiering.TierLease` contract under the RAM tier's name."""

    __slots__ = ()


class ResidencyCache:
    """Byte-weighted ARC over pinned anonymous slabs."""

    def __init__(self) -> None:
        self.active = False
        # placement-engine hook (tiering.extent_space arms it): the ARC
        # second-touch transition hands the extent's bytes UP the
        # hierarchy.  None until the space rewires with the HBM tier on
        # and unified — the one-branch-when-off contract holds for the
        # promotion leg too.
        self.promote_hook = None
        self._lock = threading.Lock()
        self._cap = 0
        self._p = 0  # adaptive target for t1 (recency), in bytes
        self._bytes = 0
        # memlock accounting: bytes mlock(2) actually pinned
        # vs slabs running unpinned (RLIMIT_MEMLOCK refusals), and the
        # operator budget fills must stay under (0 = unlimited)
        self._pinned_bytes = 0
        self._unpinned_bytes = 0
        self._mlock_budget = 0
        self._t1: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._t2: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._b1: "OrderedDict[tuple, int]" = OrderedDict()
        self._b2: "OrderedDict[tuple, int]" = OrderedDict()
        self._b1_bytes = 0
        self._b2_bytes = 0

    # -- configuration ------------------------------------------------

    def configure(self) -> None:
        """Re-read ``tier_ram_bytes`` (0 disables the tier and frees it;
        ``cache_bytes`` aliases it) and ``memlock_budget``; shrinking the
        budget below the bytes already pinned sheds slabs — the pressure
        registry's holders first — instead of ever surfacing ENOMEM to a
        reader."""
        cap = int(config.get("tier_ram_bytes"))
        budget = int(config.get("memlock_budget"))
        excess = 0
        with self._lock:
            self._cap = cap
            self._mlock_budget = budget
            self.active = cap > 0
            if not self.active:
                self._clear_locked()
            else:
                while self._bytes > cap and self._evict_one(False):
                    pass
                self._p = min(self._p, cap)
                if budget:
                    excess = max(0, self._pinned_bytes - budget)
        if excess:
            # the registered holders shed first; the registry import is
            # deferred, integrity imports this module back for scrubbing
            from .integrity import request_shed
            request_shed(excess, reason="memlock")
            with self._lock:
                while self._mlock_budget and \
                        self._pinned_bytes > self._mlock_budget:
                    if not self._shed_one():
                        break

    def clear(self) -> None:
        with self._lock:
            self._clear_locked()

    def _clear_locked(self) -> None:
        for od in (self._t1, self._t2):
            for e in od.values():
                if e.refs:
                    e.stale = True  # freed at last release
                else:
                    e.free()
            od.clear()
        self._b1.clear()
        self._b2.clear()
        self._b1_bytes = self._b2_bytes = 0
        self._bytes = 0
        self._p = 0
        self._pinned_bytes = 0
        self._unpinned_bytes = 0
        stats.gauge_set("cache_resident_bytes", 0)
        stats.gauge_set("cache_unpinned_bytes", 0)

    # -- identity (one identity across the unified space) -------------

    source_key = staticmethod(_source_key)

    # -- read side ----------------------------------------------------

    def lookup(self, skey: tuple, base: int,
               length: int) -> Optional[CacheLease]:
        """Return a pinned lease on the extent, or None on a miss.
        Bumps ARC recency/frequency state on the hit."""
        if not self.active:
            return None
        key = (skey, base, length)
        hot = False
        with self._lock:
            e = self._t1.get(key)
            if e is not None and e.spec and not e.stale:
                # first DEMAND touch of a speculative fill becomes a
                # plain first touch: clear the provenance tag and stay
                # in t1, so readahead can never fake frequency
                e.spec = False
                self._t1.move_to_end(key)
                stats.add("nr_readahead_hit")
            elif e is not None:
                self._t1.pop(key)
                self._t2[key] = e  # second touch: promote to frequency
                hot = True
            else:
                e = self._t2.get(key)
                if e is not None:
                    self._t2.move_to_end(key)
            if e is None or e.stale:
                return None
            e.refs += 1
        lease = CacheLease(self, e)
        if hot and self.promote_hook is not None:  # never fires on a
            # still-speculative slab: spec entries take the t1 path above
            # the t1→t2 transition IS the hotness signal: hand the bytes
            # up to the HBM tier outside our lock (the hook copies to the card,
            # and its eviction demotes back through fill(), which relocks).
            # The lease's ref pins the slab, so the view is stable here.
            data = bytes(e.view)
            if _integrity.active and not _integrity.verify(data, e.crc):
                # promote is a tier transition: a rotted slab must neither
                # go up to HBM nor be served — drop it and report a miss
                # so the engine re-reads through the fault ladder
                self._drop_corrupt(e)
                lease.release()
                return None
            try:
                self.promote_hook(skey, base, length, data,
                                  crc=e.crc, source_ref=e.source_ref)
            except Exception:  # noqa: BLE001 - promotion is best-effort
                pass
        return lease

    def peek(self, skey: tuple, base: int, length: int) -> bool:
        """Residency probe with no ARC side effect (a probe is not an
        access and must not train recency)."""
        if not self.active:
            return False
        key = (skey, base, length)
        with self._lock:
            e = self._t1.get(key) or self._t2.get(key)
            return e is not None and not e.stale

    def _release(self, e: _Entry) -> None:
        with self._lock:
            e.refs -= 1
            if e.refs <= 0 and (e.stale or e.detached):
                # dropped (or migrated up) while pinned; free it now
                e.free()

    def _copy_out(self, e: _Entry, dest) -> bool:
        """TierLease owner hook: the slab's first ``len(dest)`` bytes into
        *dest*."""
        dest[:] = e.view[:len(dest)]
        return True

    # -- fill side ----------------------------------------------------

    def fill(self, skey: tuple, base: int, length: int, data, *,
             logical_length: int = 0, source_ref=None,
             speculative: bool = False) -> bool:
        """Install healed bytes for an extent.  Returns True when the
        extent is now resident (skipped when the tier is off, the
        extent exceeds capacity, every candidate victim is pinned, or
        the memlock budget is exhausted — the pass-through degradation).
        ``logical_length`` — logical bytes this extent serves when it
        holds a compressed representation (defaults to *length*);
        ``source_ref`` — weakref to the source, kept so the scrubber can
        heal a rotted slab through the fault ladder;
        ``speculative`` — readahead provenance: the fill
        neither trains the ARC ghost lists nor refreshes an existing
        entry, and the slab stays tagged until its first demand hit."""
        if not self.active or length <= 0:
            return False
        key = (skey, base, length)
        crc = _integrity.checksum(data)
        with self._lock:
            cap = self._cap
            if length > cap:
                return False
            e = self._t1.get(key) or self._t2.get(key)
            if e is not None:
                # already resident (a racing task filled it); refresh
                # the bytes unless a reader is mid-copy on the slab —
                # a speculative refill never touches demand state
                if not e.refs and not speculative:
                    e.view[:length] = data
                    e.crc = crc
                    if source_ref is not None:
                        e.source_ref = source_ref
                return True
            if self._mlock_budget and \
                    self._pinned_bytes + length > self._mlock_budget:
                # memlock pressure: refuse the fill and let the read pass
                # through to SSD — degraded, never ENOMEM
                stats.add("nr_pressure_passthrough")
                return False
            # ghost hits steer the recency/frequency balance — but a
            # prefetch is not a demand re-reference, so speculation
            # must not move the target pointer or consume a ghost
            in_b1 = not speculative and key in self._b1
            in_b2 = not speculative and key in self._b2
            if in_b1:
                self._b1_bytes -= self._b1.pop(key)
                self._p = min(cap, self._p + length)
            elif in_b2:
                self._b2_bytes -= self._b2.pop(key)
                self._p = max(0, self._p - length)
            while self._bytes + length > cap:
                if not self._evict_one(in_b2):
                    return False  # everything evictable is pinned
            try:
                # populated at mmap: one call faults the slab in, where
                # the copy below would take a fault a page (slow under a
                # sandboxed kernel)
                mm = mmap.mmap(-1, length, flags=mmap.MAP_SHARED | _POPULATE)
            except (OSError, ValueError):  # pragma: no cover
                return False
            e = _Entry(key, mm, length, logical_length, crc, source_ref)
            e.spec = speculative
            e.pinned = self._try_pin(mm, length)
            if e.pinned:
                self._pinned_bytes += length
            else:
                self._unpinned_bytes += length
                stats.gauge_set("cache_unpinned_bytes",
                                self._unpinned_bytes)
            e.view[:length] = data
            if in_b1 or in_b2:
                self._t2[key] = e
            else:
                self._t1[key] = e
            self._bytes += length
            stats.add("nr_cache_fill")
            stats.gauge_set("cache_resident_bytes", self._bytes)
        # (the engine emits the `cache_fill` span with the task's trace
        # id; evict/invalidate have no task context and instant here)
        if in_b1 and self.promote_hook is not None:
            # a b1-ghost refault IS a second touch: the extent was
            # evicted from recency before its re-reference, so under
            # capacity pressure it would thrash in RAM forever — hand
            # it up instead (outside our lock, same contract as the
            # lookup-time hook).  Only b1: yield_up and HBM demotion
            # ghost into b2, so promoting b2 refills would ping-pong
            # an extent between the tiers.
            try:
                self.promote_hook(skey, base, length, bytes(data),
                                  crc=crc, source_ref=source_ref)
            except Exception:  # noqa: BLE001 - promotion is best-effort
                pass
        return True

    def yield_up(self, skey: tuple, base: int, length: int) -> bool:
        """Exclusive migration: the extent was promoted into
        the tier above — surrender the RAM copy so HBM + RAM pool their
        capacity instead of double-caching.  The key ghosts into b2 (a
        later demotion re-enters as frequency, which it is); a live
        lease keeps the detached slab readable until its last release,
        never stale — the promoted bytes are identical."""
        key = (skey, base, length)
        with self._lock:
            for od in (self._t1, self._t2):
                e = od.get(key)
                if e is None:
                    continue
                del od[key]
                self._bytes -= e.length
                self._unaccount_pin(e)
                if not e.spec:
                    self._b2[key] = e.length
                    self._b2_bytes += e.length
                    self._trim_ghosts()
                if e.refs:
                    e.detached = True
                else:
                    e.free()
                stats.gauge_set("cache_resident_bytes", self._bytes)
                return True
        return False

    @staticmethod
    def _try_pin(mm, length: int) -> bool:
        """mlock(2) the slab, *checking the result*: a refusal (typically
        RLIMIT_MEMLOCK) runs the slab unpinned — counted in
        ``nr_cache_mlock_fail`` and gauged in ``cache_unpinned_bytes`` by
        the caller, never raised (fail-open)."""
        if _libc is None:
            return False
        rc = -1
        try:
            buf = (ctypes.c_char * length).from_buffer(mm)
            # c_void_p: a bare int would marshal as a 32-bit C int and
            # truncate the 64-bit slab address
            rc = _libc.mlock(ctypes.c_void_p(ctypes.addressof(buf)),
                             ctypes.c_size_t(length))
        except Exception:  # pragma: no cover - ctypes failure == unpinned
            rc = -1
        finally:
            try:
                del buf
            except UnboundLocalError:
                pass
        if rc != 0:
            stats.add("nr_cache_mlock_fail")
            return False
        return True

    def _evict_one(self, prefer_t2: bool) -> bool:
        """ARC REPLACE: evict one unpinned LRU entry, ghosting its key.
        Returns False when nothing is evictable (all pinned/empty)."""
        from_t1 = bool(self._t1) and (
            self._t1_bytes() > self._p
            or (prefer_t2 and self._t1_bytes() == self._p))
        for od, ghost in ((self._t1, self._b1), (self._t2, self._b2)) \
                if from_t1 else ((self._t2, self._b2), (self._t1, self._b1)):
            for key, e in od.items():  # LRU first
                if e.refs:
                    continue
                del od[key]
                e.free()
                self._bytes -= e.length
                self._unaccount_pin(e)
                if not e.spec:
                    # an untouched speculative slab leaves no ghost:
                    # its later demand miss must read as a cold miss,
                    # not a capacity signal
                    ghost[key] = e.length
                    if ghost is self._b1:
                        self._b1_bytes += e.length
                    else:
                        self._b2_bytes += e.length
                    self._trim_ghosts()
                stats.add("nr_cache_evict")
                # in the unified space a RAM eviction IS the demotion to
                # the SSD-backed tier: the data's next copy comes from
                # the file through the fault ladder
                stats.add("nr_tier_ram_demote")
                stats.gauge_set("cache_resident_bytes", self._bytes)
                if _trace.active:
                    _trace.instant("cache_evict", offset=e.key[1],
                                   length=e.length)
                return True
        return False

    def _unaccount_pin(self, e: _Entry) -> None:
        """Entry left the tier: release its memlock accounting."""
        if e.pinned:
            self._pinned_bytes -= e.length
        else:
            self._unpinned_bytes -= e.length
            stats.gauge_set("cache_unpinned_bytes",
                            max(0, self._unpinned_bytes))

    def _shed_one(self) -> bool:
        """Memlock pressure: free one unreferenced pinned slab (LRU,
        recency list first — pressure evictions do not train the ARC
        ghosts).  Returns False when every pinned slab is leased."""
        for od in (self._t1, self._t2):
            for key, e in list(od.items()):
                if e.refs or not e.pinned:
                    continue
                del od[key]
                e.free()
                self._bytes -= e.length
                self._pinned_bytes -= e.length
                stats.add("nr_pressure_shed")
                stats.add("nr_tier_ram_shed")
                stats.gauge_set("cache_resident_bytes", self._bytes)
                if _trace.active:
                    _trace.instant("pressure_shed", offset=key[1],
                                   length=e.length,
                                   args={"tier": "ram",
                                         "reason": "memlock"})
                return True
        return False

    def _t1_bytes(self) -> int:
        return sum(e.length for e in self._t1.values())

    def _trim_ghosts(self) -> None:
        while self._b1_bytes > self._cap and self._b1:
            _, ln = self._b1.popitem(last=False)
            self._b1_bytes -= ln
        while self._b2_bytes > self._cap and self._b2:
            _, ln = self._b2.popitem(last=False)
            self._b2_bytes -= ln

    # -- coherency ----------------------------------------------------

    def invalidate_extents(self, skey: tuple,
                           extents: Sequence[Tuple[int, int]]) -> int:
        """Drop every RAM-resident extent the write touches.  Same-key
        entries are matched by byte overlap; entries under a different
        key that shares a file are dropped wholesale (offsets do not
        map across framings).  Returns the number dropped.  The write
        ladder invalidates through ``extent_space``, which fans the one
        contract out over every tier — this is the RAM leg."""
        if not self.active:
            return 0
        pathset = set(skey)
        dropped = 0
        with self._lock:
            for od in (self._t1, self._t2):
                for key in list(od):
                    ks, kb, kl = key
                    if ks == skey:
                        if not any(kb < b + l and b < kb + kl
                                   for b, l in extents):
                            continue
                    elif not (pathset & set(ks)):
                        continue
                    self._drop_locked(od, key)
                    dropped += 1
        self._note_invalidated(dropped, extents)
        return dropped

    def invalidate_paths(self, paths: Sequence[str]) -> int:
        """Drop every RAM-resident extent over any of *paths* (the
        checkpoint savers invalidate through ``extent_space`` after an
        atomic rename installs new bytes)."""
        if not self.active:
            return 0
        want = {os.path.realpath(p) for p in paths}
        dropped = 0
        with self._lock:
            for od in (self._t1, self._t2):
                for key in list(od):
                    if want & set(key[0]):
                        self._drop_locked(od, key)
                        dropped += 1
        self._note_invalidated(dropped, [])
        return dropped

    def _drop_locked(self, od, key) -> None:
        e = od.pop(key)
        self._bytes -= e.length
        self._unaccount_pin(e)
        if e.refs:
            e.stale = True  # pinned: freed at the last lease release
        else:
            e.free()
        stats.gauge_set("cache_resident_bytes", self._bytes)

    def _drop_corrupt(self, e: _Entry) -> None:
        """Integrity mismatch on a resident slab: drop it under its lease
        rules (stale while any lease pins it, freed otherwise)."""
        with self._lock:
            for od in (self._t1, self._t2):
                if od.get(e.key) is e:
                    self._drop_locked(od, e.key)
                    return

    def _note_invalidated(self, dropped: int, extents) -> None:
        if not dropped:
            return
        stats.add("nr_cache_invalidate", dropped)
        if _trace.active:
            off = extents[0][0] if extents else -1
            _trace.instant("cache_invalidate", offset=off, length=dropped)

    # -- integrity scrub -----------------------------------

    def scrub_keys(self) -> list:
        """Snapshot of verifiable resident keys for the scrubber walk."""
        with self._lock:
            return [k for od in (self._t1, self._t2)
                    for k, e in od.items()
                    if not e.stale and e.crc is not None]

    def scrub_extent(self, key: tuple):
        """Verify one resident slab against its fill-time crc.  Returns
        ``(ok, length, source_ref)`` or None when the entry is gone or
        unverifiable.  A mismatch drops the entry under its lease rules
        (stale while pinned) so it is never served again."""
        with self._lock:
            e = self._t1.get(key) or self._t2.get(key)
            if e is None or e.stale or e.crc is None:
                return None
            e.refs += 1  # pin the slab while hashing outside the lock
        ok = _integrity.verify(e.view[:e.length], e.crc)
        src = e.source_ref
        with self._lock:
            e.refs -= 1
            if not ok and not e.stale:
                for od in (self._t1, self._t2):
                    if od.get(key) is e:
                        self._drop_locked(od, key)
                        break
            elif (e.stale or e.detached) and e.refs <= 0:
                e.free()  # invalidated/migrated under the scrub pin
        return ok, e.length, src

    def _flip_resident_byte(self, skey: tuple, base: int, length: int,
                            pos: int = 0) -> bool:
        """Testing hook (FaultPlan resident-corruption tiers): flip one
        byte of a resident slab in place, as host-RAM bit-rot would."""
        key = (skey, base, length)
        with self._lock:
            e = self._t1.get(key) or self._t2.get(key)
            if e is None or e.stale:
                return False
            i = pos % e.length
            e.view[i] = e.view[i] ^ 0xFF
            return True

    # -- introspection ------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def unpinned_bytes(self) -> int:
        with self._lock:
            return self._unpinned_bytes

    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned_bytes

    def logical_resident_bytes(self) -> int:
        """Logical bytes the tier can serve — equals
        :meth:`resident_bytes` unless packed (compressed) extents are
        resident, which serve more logical bytes than they pin."""
        with self._lock:
            return sum(e.logical_length
                       for od in (self._t1, self._t2)
                       for e in od.values() if not e.stale)

    def resident_fraction(self, paths: Sequence[str],
                          total_bytes: int) -> float:
        """Fraction of a table's bytes currently resident — the
        planner's expected hit ratio for a scan over *paths*."""
        if not self.active or total_bytes <= 0 or not paths:
            return 0.0
        want = {os.path.realpath(p) for p in paths if isinstance(p, str)}
        if not want:
            return 0.0
        got = 0
        with self._lock:
            for od in (self._t1, self._t2):
                for (ks, _b, ln), e in od.items():
                    if not e.stale and (want & set(ks)):
                        got += ln
        return min(1.0, got / float(total_bytes))


#: process-wide tier; ``configure()`` is called at Session construction
#: and by tests after flipping ``cache_bytes``/``tier_ram_bytes``
residency_cache = ResidencyCache()

#: the unified extent space owns every transition in and out of this
#: tier (promotion, demotion, demand faults, invalidation fan-out)
extent_space.register_tier("ram", residency_cache)
