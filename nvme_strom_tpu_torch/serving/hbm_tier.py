"""The HBM tier of the residency hierarchy: the JAX package's
``serving/hbm_tier.py``, on the card.

A capacity-bounded extent tier above the RAM tier (:mod:`..cache`):
extents the RAM tier sees touched twice (its ARC t1→t2 transition) are
promoted into uint8 CUDA tensors registered with :mod:`..hbm.registry`
(so a backend loss's ``revoke_all`` reaches them), a Session looks here
first when it plans a read, and eviction demotes the bytes back into the
RAM tier, so capacity pressure moves data down the hierarchy instead of
dropping it.

The contract is the RAM tier's:

* **Keying** — ``(source key, base, length)``, exact extents.
* **Leases** — :meth:`HbmResidencyTier.lookup` returns a refcounted
  :class:`HbmLease` (the unified :class:`..tiering.TierLease`); eviction
  skips a leased entry, invalidation marks it stale, and a stale entry is
  never served and is freed (unmapped from the registry) at its last
  release.  A lease's copy out of the card is synchronous, so the tensor
  cannot be freed while a copy still reads it.
* **Coherency** — the unified extent space fans every invalidation out
  over this tier too.
* **One branch when off** — ``configure()`` reads ``tier_hbm_bytes``
  once; the hot paths test the plain ``active`` attribute.

Eviction is byte-weighted LRU: admission is already filtered by the RAM
tier's second-touch rule, so recency suffices.  Where the extents live is
the tier's device: ``cuda:0`` unless :meth:`HbmResidencyTier.configure`
names another, ``"cpu"`` in the tests.  A Session's own ``device`` does
not move it: the tier is process-wide and outlives any one Session.  The crc32c of an extent is checked on the host, after a copy out
of the card, as the JAX package does.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import StromError
from ..config import config
from ..stats import stats
from ..trace import recorder as _trace
from ..integrity import domain as _integrity
from ..tiering import TierLease, extent_space, source_key as _source_key

__all__ = ["HbmLease", "HbmResidencyTier", "hbm_tier"]


class _Entry:
    __slots__ = ("key", "handle", "length", "refs", "stale", "crc",
                 "source_ref")

    def __init__(self, key, handle: int, length: int,
                 crc=None, source_ref=None) -> None:
        self.key = key
        self.handle = handle        # hbm.registry handle of the tensor
        self.length = length
        self.refs = 0
        self.stale = False
        # integrity domain: the extent's fill-time crc32c and
        # a source weakref so the scrubber can heal a rotted extent
        self.crc = crc
        self.source_ref = source_ref

    @property
    def array(self) -> Optional[torch.Tensor]:
        """The extent's uint8 tensor, or None once the registry revoked
        or unmapped it."""
        return _tensor(self.handle)


def _tensor(handle: int) -> Optional[torch.Tensor]:
    if not handle:
        return None
    from ..hbm.registry import registry
    try:
        return registry.get(handle).tensor
    except StromError:
        return None


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes on the host: a synchronous copy out of the card
    (the caller holds a reference, so the tensor outlives the copy)."""
    return t.cpu().numpy()


class _Entries(OrderedDict):
    """The tier's LRU of entries, indexed by source key as well, so that a
    write's invalidation visits only the entries of the sources whose
    files it shares (a pool's thousands of pinned KV blocks sit under a
    ``#kvpool`` key no file write can touch)."""

    def __init__(self) -> None:
        super().__init__()
        self.by_skey: dict = {}

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self.by_skey.setdefault(key[0], set()).add(key)

    def __delitem__(self, key) -> None:
        super().__delitem__(key)
        self._unindex(key)

    def pop(self, key, *default):
        if key in self:
            self._unindex(key)
        return super().pop(key, *default)

    def clear(self) -> None:
        super().clear()
        self.by_skey.clear()

    def _unindex(self, key) -> None:
        keys = self.by_skey.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self.by_skey[key[0]]

    def keys_sharing(self, paths: set, skey=None) -> list:
        """The keys of every source key that is *skey* or shares a path
        with *paths*."""
        return [k for ks, keys in self.by_skey.items()
                if ks == skey or paths & set(ks) for k in keys]


class HbmLease(TierLease):
    """Refcounted pin on an HBM-resident extent: the unified
    :class:`..tiering.TierLease` holder contract under its
    tier's name.  ``device_array()`` hands a zero-copy consumer the
    extent's tensor without the bytes leaving the device."""

    __slots__ = ()


class HbmResidencyTier:
    """Byte-weighted LRU over device-resident extent buffers."""

    def __init__(self) -> None:
        self.active = False
        self._lock = threading.Lock()
        self._cap = 0
        self._bytes = 0
        self._entries: "_Entries" = _Entries()
        self._device: Optional[torch.device] = None

    # -- configuration ------------------------------------------------

    def configure(self, device=None) -> None:
        """Re-read ``tier_hbm_bytes`` (``hbm_cache_bytes`` aliases it);
        0 disables the tier, frees it, and rewires the extent space's
        moves between tiers (the RAM tier's promotion hook).  *device*
        (None keeps the current one) is where extents placed from now on
        live; those already resident stay where they are."""
        if device is not None:
            self._device = torch.device(device)
        cap = int(config.get("tier_hbm_bytes"))
        demoted = []
        with self._lock:
            self._cap = cap
            self.active = cap > 0
            if not self.active:
                demoted = self._clear_locked()
            else:
                while self._bytes > cap:
                    d = self._evict_one_locked()
                    if d is None:
                        break
                    demoted.append(d)
        self._demote_to_host(demoted)
        # ONE placement engine: the extent space arms the RAM tier's
        # second-touch promotion hook iff this tier is on and the space
        # is unified — one branch when either is off
        extent_space.rewire()

    def clear(self) -> None:
        with self._lock:
            self._clear_locked()

    def _clear_locked(self):
        demoted = []
        for e in self._entries.values():
            if e.refs:
                e.stale = True
            else:
                demoted.append((e.key, self._take_bytes(e), e.source_ref))
                self._free_entry(e)
        self._entries.clear()
        self._bytes = 0
        stats.gauge_set("hbm_resident_bytes", 0)
        return demoted

    # -- identity (one identity across the unified space) -------------

    source_key = staticmethod(_source_key)

    # -- read side ----------------------------------------------------

    def lookup(self, skey: tuple, base: int,
               length: int) -> Optional[HbmLease]:
        """Return a pinned lease on the extent, or None.  Bumps LRU
        recency on the hit."""
        if not self.active:
            return None
        key = (skey, base, length)
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.stale:
                return None
            self._entries.move_to_end(key)
            e.refs += 1
            return HbmLease(self, e)

    def _release(self, e: _Entry) -> None:
        drop = False
        with self._lock:
            e.refs -= 1
            if e.refs <= 0 and e.stale:
                drop = True
        if drop:
            self._free_entry(e)

    def _copy_out(self, e: _Entry, dest) -> bool:
        """TierLease owner hook: the extent's first ``len(dest)`` bytes
        copied out of the card straight into *dest* (a pinned staging
        slot takes them at the link's rate), synchronously, so the entry
        is never freed under a copy; False when the registry revoked the
        tensor."""
        t = e.array
        if t is None:
            return False
        n = len(dest)
        try:
            torch.frombuffer(dest, dtype=torch.uint8, count=n).copy_(t[:n])
        except Exception:  # pragma: no cover - a lost backend
            return False
        return True

    # -- fill / promotion side -----------------------------------------

    def admit(self, skey: tuple, base: int, length: int, data, *,
              crc=None, source_ref=None) -> bool:
        """Promote healed host bytes into a device-resident buffer.
        Called by the host tier on its second-touch transition (outside
        its lock) and by :meth:`..tiering.ExtentSpace.pin`.  Returns
        True when the extent is now HBM-resident; evicted victims are
        demoted into the host tier, never dropped.  ``crc`` is the
        extent's fill-time crc32c when the caller already has one
        (verified here — admit is a tier transition); ``source_ref``
        lets the scrubber heal the extent later."""
        if not self.active or length <= 0:
            return False
        key = (skey, base, length)
        # the copy to the card happens outside the tier lock: it may be
        # slow and needs no tier state
        host = np.frombuffer(data, dtype=np.uint8, count=length).copy()
        if _integrity.active:
            if crc is None:
                crc = _integrity.checksum(host)
            elif not _integrity.verify(host, crc):
                return False  # corrupt promote: never lands in HBM
        handle = self._place(host)
        if not handle:
            return False
        demoted = []
        installed = False
        with self._lock:
            cap = self._cap
            if length > cap or key in self._entries:
                pass  # oversized, or a racing admit won
            else:
                ok = True
                while self._bytes + length > cap:
                    d = self._evict_one_locked()
                    if d is None:
                        ok = False  # everything evictable is pinned
                        break
                    demoted.append(d)
                if ok:
                    self._entries[key] = _Entry(key, handle, length,
                                                crc, source_ref)
                    self._bytes += length
                    installed = True
                    stats.add("nr_hbm_promote")
                    stats.gauge_set("hbm_resident_bytes", self._bytes)
        self._demote_to_host(demoted)
        if not installed:
            self._unmap(handle)
        return installed

    def _place(self, host: np.ndarray) -> int:
        """Host bytes -> a uint8 tensor on the tier's device, registered
        with :mod:`..hbm.registry` (a backend loss revokes it there);
        returns the registry handle, 0 when there is no device to place
        on (the admit fails open)."""
        try:
            from ..hbm.backend import resolve_device
            from ..hbm.registry import registry
            if self._device is None:
                self._device = resolve_device(None)
            t = torch.from_numpy(host)
            if self._device.type != "cpu":
                t = t.to(self._device)      # synchronous from pageable
            return registry.map_device_memory(t)
        except Exception:  # pragma: no cover - no device, a lost backend
            return 0

    # -- eviction / demotion -------------------------------------------

    def _evict_one_locked(self):
        """Evict one unpinned LRU entry; returns ``(key, bytes)`` for
        host demotion, or None when everything evictable is pinned."""
        for key, e in self._entries.items():  # LRU first
            if e.refs:
                continue
            del self._entries[key]
            data = self._take_bytes(e)
            if data is not None and _integrity.active and \
                    not _integrity.verify(data, e.crc):
                data = None  # corrupt demote: never poisons the host tier
            self._bytes -= e.length
            self._free_entry(e)
            stats.add("nr_hbm_demote")
            stats.gauge_set("hbm_resident_bytes", self._bytes)
            if _trace.active:
                _trace.instant("cache_evict", offset=key[1],
                               length=e.length, args={"tier": "hbm"})
            return key, data, e.source_ref
        return None

    @staticmethod
    def _take_bytes(e: _Entry) -> Optional[bytes]:
        t = e.array
        if t is None:
            return None
        try:
            return _host_copy(t).tobytes()
        except Exception:  # pragma: no cover - a lost backend
            return None

    def _demote_to_host(self, demoted) -> None:
        """Demoted extents move DOWN through the unified space: capacity
        pressure migrates data into the RAM tier instead of dropping it
        (a failed fill just means a future SSD re-read).  In split mode
        (``tier_unified=false``) the space drops them — isolated tiers
        do not migrate."""
        extent_space.demote_from_hbm(demoted)

    def _free_entry(self, e: _Entry) -> None:
        handle, e.handle = e.handle, 0
        self._unmap(handle)

    @staticmethod
    def _unmap(handle: int) -> None:
        if not handle:
            return
        try:
            from ..hbm.registry import registry
            registry.unmap(handle, timeout=5.0)
        except Exception:  # pragma: no cover - already revoked/unmapped
            pass

    def drop(self, skey: tuple, base: int, length: int) -> bool:
        """Remove one extent WITHOUT demoting it to the host tier (an
        :meth:`..tiering.ExtentSpace.unpin`: the caller owns the bytes'
        next home).  Pinned entries go stale and free at last release."""
        if not self.active:
            return False
        key = (skey, base, length)
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return False
            self._bytes -= e.length
            stats.gauge_set("hbm_resident_bytes", self._bytes)
            if e.refs:
                e.stale = True
                return True
        self._free_entry(e)
        return True

    # -- integrity scrub ------------------------------------

    def scrub_keys(self) -> list:
        """Snapshot of verifiable resident keys.  Leased (pinned) entries
        are skipped: their holder checks its own blocks at its
        transitions, and under exclusive placement dropping one here
        would lose the only copy."""
        with self._lock:
            return [k for k, e in self._entries.items()
                    if not e.stale and e.crc is not None and not e.refs]

    def scrub_extent(self, key: tuple):
        """Verify one HBM-resident extent (one D2H copy) against its
        fill-time crc.  Returns ``(ok, length, source_ref)`` or None.
        A mismatch drops the entry WITHOUT host demotion — corrupt bytes
        never move down the hierarchy."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.stale or e.crc is None or e.refs:
                return None
            e.refs += 1  # pin while the D2H copy + hash run unlocked
        data = self._take_bytes(e)
        ok = data is not None and _integrity.verify(data, e.crc)
        src = e.source_ref
        drop = None
        with self._lock:
            e.refs -= 1
            if not ok and not e.stale:
                if self._entries.get(key) is e:
                    del self._entries[key]
                    self._bytes -= e.length
                    stats.gauge_set("hbm_resident_bytes", self._bytes)
                    if e.refs:
                        e.stale = True
                    else:
                        drop = e
            elif e.stale and e.refs <= 0:
                drop = e  # invalidated under the scrub pin
        if drop is not None:
            self._free_entry(drop)
        return ok, e.length, src

    def _drop_corrupt(self, e: _Entry) -> None:
        """Integrity mismatch on a leased extent: drop it under its
        lease rules (the caller holds a ref, so it goes stale and frees
        at the last release)."""
        with self._lock:
            if self._entries.get(e.key) is e:
                del self._entries[e.key]
                self._bytes -= e.length
                stats.gauge_set("hbm_resident_bytes", self._bytes)
                e.stale = True

    def _flip_resident_byte(self, skey: tuple, base: int, length: int,
                            pos: int = 0) -> bool:
        """Testing hook (the resident-corruption tier of the fault plans):
        flip one byte of the extent's tensor in place, on its device, as
        HBM bit rot would."""
        key = (skey, base, length)
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.stale:
                return False
            e.refs += 1        # pinned: the tensor outlives the flip
        try:
            t = e.array
            if t is None:
                return False
            i = pos % t.numel()
            t[i:i + 1].bitwise_xor_(0xFF)
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            return True
        except Exception:  # pragma: no cover - a lost backend
            return False
        finally:
            self._release(e)

    # -- coherency (forwarded by the host tier) ------------------------

    def invalidate_extents(self, skey: tuple,
                           extents: Sequence[Tuple[int, int]]) -> int:
        """Same matching rule as the host tier: byte overlap under the
        same key, wholesale drop across framings that share a file."""
        if not self.active:
            return 0
        pathset = set(skey)
        victims = []
        with self._lock:
            for key in self._entries.keys_sharing(pathset, skey):
                ks, kb, kl = key
                if ks == skey and not any(kb < b + l and b < kb + kl
                                          for b, l in extents):
                    continue
                victims.append(self._invalidate_locked(key))
        return self._note_invalidated(victims, extents)

    def invalidate_paths(self, paths: Sequence[str]) -> int:
        if not self.active:
            return 0
        want = {os.path.realpath(p) for p in paths}
        victims = []
        with self._lock:
            for key in self._entries.keys_sharing(want):
                victims.append(self._invalidate_locked(key))
        return self._note_invalidated(victims, [])

    def _invalidate_locked(self, key) -> Optional[_Entry]:
        e = self._entries.pop(key)
        self._bytes -= e.length
        stats.gauge_set("hbm_resident_bytes", self._bytes)
        if e.refs:
            e.stale = True
            return None
        return e

    def _note_invalidated(self, victims, extents) -> int:
        for e in victims:
            if e is not None:
                self._free_entry(e)
        n = len(victims)
        if n:
            stats.add("nr_cache_invalidate", n)
            if _trace.active:
                off = extents[0][0] if extents else -1
                _trace.instant("cache_invalidate", offset=off, length=n,
                               args={"tier": "hbm"})
        return n

    # -- introspection ------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def resident_fraction(self, paths: Sequence[str],
                          total_bytes: int) -> float:
        """Fraction of a table's bytes HBM-resident — the planner's
        expected device-hit ratio for a scan over *paths*."""
        if not self.active or total_bytes <= 0 or not paths:
            return 0.0
        want = {os.path.realpath(p) for p in paths if isinstance(p, str)}
        if not want:
            return 0.0
        got = 0
        with self._lock:
            for (ks, _b, ln), e in self._entries.items():
                if not e.stale and (want & set(ks)):
                    got += ln
        return min(1.0, got / float(total_bytes))


#: the process-wide device tier; ``configure()`` runs at Session
#: construction (through extent_space.configure()) and after a change of
#: ``tier_hbm_bytes``
hbm_tier = HbmResidencyTier()

#: the unified extent space owns every transition in and out of this
#: tier (second-touch promotion in, demotion to the RAM tier out,
#: invalidation fan-out, pins)
extent_space.register_tier("hbm", hbm_tier)
