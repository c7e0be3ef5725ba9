"""The unified extent space: the JAX package's ``tiering.py``.

One placement and migration engine over the capacity hierarchy
HBM → pinned RAM → SSD.  Each tier keeps its own store — :mod:`.cache` is
the RAM tier (byte-weighted ARC), :mod:`.serving.hbm_tier` the HBM tier
(byte-weighted LRU over CUDA tensors) — and every move between tiers is
decided here, in :class:`ExtentSpace`:

* **demand faults** — a miss, filled at wait time once the fault ladder
  (retry, hedge, mirror, checksum re-read) healed its bytes, enters the
  RAM tier through :meth:`ExtentSpace.fault_fill`;
* **promotion** — the RAM tier's second touch (ARC t1→t2) hands the
  extent up; under ``tier_unified`` (the default) the move is exclusive:
  the RAM copy is given up (the tier's ``yield_up``), so the two tiers
  pool their capacity instead of holding the hot set twice;
* **demotion** — HBM victims move down into the RAM tier; RAM victims
  drop to the SSD (a later read is a demand fault, not a loss);
* **invalidation** — the write path and the checkpoint savers call one
  contract (:meth:`invalidate_extents` / :meth:`invalidate_paths`) that
  fans out over every tier;
* **pins** — :meth:`pin` / :meth:`unpin` place an extent in HBM and hold
  it there (the KV block pool's HBM tier, :mod:`.serving.kvcache`).

Every lease a tier hands out is a :class:`TierLease`: one refcounted type
with one holder contract (``copy_into`` fails open on a stale or corrupt
extent, ``device_array`` where the bytes live on a device, freed at the
last release).

``tier_unified = false`` reverts to isolated tiers: no promotion, and HBM
victims drop instead of demoting.

The module-global :data:`extent_space` keeps the tiers' one-branch-when-
off contract: :meth:`ExtentSpace.configure` re-reads the capacities once,
and the hot paths test each tier's plain ``active`` attribute.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

from .config import config
from .stats import stats
from .trace import recorder as _trace
from .integrity import domain as _integrity

__all__ = ["TierLease", "ExtentSpace", "extent_space", "source_key"]


def source_key(source) -> tuple:
    """Stable identity for a source in the unified space: the tuple of
    its members' real paths (works for plain, segmented and striped
    sources, and the loopback fakes, which subclass them)."""
    # representation tags (e.g. a packed .cpk sidecar's
    # "#repr=cpk"/"#gen=..." pair) extend the identity so a re-encoded
    # file can never alias a stale cached extent; tags start with '#'
    # and thus never collide with real paths
    extra = tuple(getattr(source, "cache_key_extra", ()) or ())
    members = getattr(source, "members", None)
    if members:
        try:
            return tuple(os.path.realpath(m.path)
                         for m in members) + extra
        except AttributeError:
            pass
    path = getattr(source, "path", None)
    if isinstance(path, str):
        return (os.path.realpath(path),) + extra
    return ("<anon:%d>" % id(source),) + extra


class TierLease:
    """Refcounted pin on a resident extent, in ANY tier.

    Taken under the owning tier's lock by its ``lookup``; the holder
    copies out with :meth:`copy_into` and must :meth:`release` (eviction
    skips the entry, invalidation only marks it stale while the lease is
    live, stale entries are never served and free at the last release).

    The owning tier supplies three hooks: ``_copy_out(entry, dest)`` —
    copy the first ``len(dest)`` bytes into *dest* (False when the
    backing is gone), ``_drop_corrupt(entry)`` — drop a rotted entry
    under its lease rules, and ``_release(entry)`` — refcount
    bookkeeping.
    """

    __slots__ = ("_owner", "_entry", "_released")

    def __init__(self, owner, entry) -> None:
        self._owner = owner
        self._entry = entry
        self._released = False

    @property
    def length(self) -> int:
        return self._entry.length

    @property
    def stale(self) -> bool:
        return self._entry.stale

    def device_array(self):
        """The extent as its device-resident uint8 array (no copy) when
        the owning tier keeps one, else None; None too when the entry
        was invalidated after the lookup."""
        e = self._entry
        return None if e.stale else getattr(e, "array", None)

    def copy_into(self, dest) -> bool:
        """Copy the extent into *dest* (a writable buffer no longer than
        the extent).  Returns False when the entry was invalidated after
        the lookup, or (integrity=always) when the copied bytes fail the
        extent's crc32c; *dest* then holds no promise and the caller
        re-reads it in full through the fault ladder.  Under
        integrity=always only a whole-extent copy can be held to the crc,
        so a shorter one returns False too.  Fail-open: never EBADMSG
        from a cached copy."""
        e = self._entry
        if e.stale or not self._owner._copy_out(e, dest):
            return False
        if _integrity.verify_reads:
            if len(dest) != e.length:
                return False
            if not _integrity.verify(dest, e.crc):
                self._owner._drop_corrupt(e)
                return False
        return not e.stale

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._owner._release(self._entry)


class ExtentSpace:
    """The one placement/migration engine over the registered tiers.

    Tiers self-register at import (module bottom of :mod:`.cache` and
    :mod:`.serving.hbm_tier`), keeping this module import-light — it
    never imports a tier at top level, the tiers import it for
    :class:`TierLease`.
    """

    #: lookup order, top of the hierarchy first
    _ORDER = ("hbm", "ram")

    def __init__(self) -> None:
        self.unified = True
        self._tiers: Dict[str, object] = {}

    # -- registry ------------------------------------------------------

    def register_tier(self, name: str, tier) -> None:
        self._tiers[name] = tier

    def tier(self, name: str):
        return self._tiers.get(name)

    def tier_active(self, name: str) -> bool:
        t = self._tiers.get(name)
        return bool(t is not None and t.active)

    def tier_capacity(self, name: str) -> int:
        t = self._tiers.get(name)
        return int(getattr(t, "_cap", 0)) if t is not None else 0

    # -- configuration -------------------------------------------------

    def configure(self, device=None) -> None:
        """(Re)configure every tier from config ``tier_ram_bytes`` and
        ``tier_hbm_bytes`` (``cache_bytes`` and ``hbm_cache_bytes`` alias
        them) and rewire the moves between tiers.  *device* is where the
        HBM tier places its extents (None keeps the one it has, at first
        ``cuda:0``; ``"cpu"`` for the host, as the tests do)."""
        # deferred imports: the tier modules import this one for the
        # shared lease type, so the space pulls them in lazily
        from .cache import residency_cache            # registers "ram"
        from .serving.hbm_tier import hbm_tier        # registers "hbm"
        residency_cache.configure()
        hbm_tier.configure(device=device)   # calls rewire() itself

    def clear_tiers(self) -> None:
        """Drop every resident extent in every tier (a test's or a
        gate's reset)."""
        for t in self._tiers.values():
            t.clear()

    def rewire(self) -> None:
        """Re-arm the moves between tiers after any tier's
        ``configure()``: the RAM tier's second-touch hook points at
        :meth:`_promote_from_ram` only while the HBM tier is on and the
        space is unified — one branch when off."""
        self.unified = bool(config.get("tier_unified"))
        ram = self._tiers.get("ram")
        hbm = self._tiers.get("hbm")
        if ram is None:
            return
        on = hbm is not None and hbm.active and self.unified
        ram.promote_hook = self._promote_from_ram if on else None

    # -- identity ------------------------------------------------------

    source_key = staticmethod(source_key)

    # -- read side -----------------------------------------------------

    @property
    def lookup_active(self) -> bool:
        """Any tier can serve a hit (the engine's plan-time branch)."""
        return any(t.active for t in self._tiers.values())

    @property
    def fill_active(self) -> bool:
        """The RAM tier accepts demand-fault fills (the engine's
        wait-time branch)."""
        return self.tier_active("ram")

    def lookup(self, skey: tuple, base: int,
               length: int) -> Optional[Tuple[TierLease, str]]:
        """Top-down exact-extent lookup: returns ``(lease, tier_name)``
        from the highest tier holding the extent, or None on a full
        miss.  An HBM hit outranks a RAM hit — it costs one device→dest
        copy and no host-slab touch at all."""
        for name in self._ORDER:
            t = self._tiers.get(name)
            if t is None or not t.active:
                continue
            lease = t.lookup(skey, base, length)
            if lease is not None:
                return lease, name
        return None

    # -- placement / migration -----------------------------------------

    def fault_fill(self, skey: tuple, base: int, length: int, data, *,
                   logical_length: int = 0, source_ref=None,
                   speculative: bool = False) -> bool:
        """Demand-fault fill: healed bytes from the fault ladder enter
        the hierarchy at the RAM tier.  Speculative (readahead) fills
        ride the same path but are provenance-tagged by the tier and
        never counted as faults — and, since a still-speculative extent
        takes the first-touch path on its first demand hit, they can
        never promote either."""
        ram = self._tiers.get("ram")
        if ram is None:
            return False
        ok = ram.fill(skey, base, length, data,
                      logical_length=logical_length, source_ref=source_ref,
                      speculative=speculative)
        if ok and not speculative:
            stats.add("nr_tier_ram_fault")
            if _trace.active:
                _trace.instant("tier_fault", offset=base, length=length,
                               args={"tier": "ram"})
        return ok

    def _promote_from_ram(self, skey: tuple, base: int, length: int,
                          data, *, crc=None, source_ref=None) -> bool:
        """Second-touch promotion (the RAM tier's ARC t1→t2 transition,
        invoked outside its lock): admit the bytes into HBM, then —
        exclusive migration — surrender the RAM copy so the two tiers
        pool capacity instead of double-caching.  The surrendered key is
        ghosted, so a later demotion re-enters RAM as frequency."""
        hbm = self._tiers.get("hbm")
        if hbm is None or not hbm.admit(skey, base, length, data,
                                        crc=crc, source_ref=source_ref):
            return False
        stats.add("nr_tier_hbm_promote")
        if _trace.active:
            _trace.instant("tier_promote", offset=base, length=length,
                           args={"tier": "hbm"})
        ram = self._tiers.get("ram")
        if ram is not None:
            ram.yield_up(skey, base, length)
        return True

    def demote_from_hbm(self, demoted) -> None:
        """HBM eviction victims move DOWN: each ``(key, data,
        source_ref)`` re-enters the RAM tier (a failed fill just means a
        future SSD re-read — the fault ladder is the floor of the
        hierarchy).  Split mode drops instead: isolated tiers do not
        migrate, which is exactly the baseline the tier gate beats."""
        if not self.unified:
            return
        ram = self._tiers.get("ram")
        if ram is None:
            return
        for key, data, source_ref in demoted:
            if data is None:
                continue
            skey, base, length = key
            if ram.fill(skey, base, length, data, source_ref=source_ref):
                stats.add("nr_tier_hbm_demote")
                if _trace.active:
                    _trace.instant("tier_demote", offset=base,
                                   length=length, args={"tier": "hbm"})

    # -- pinned placement ----------------------------------------------

    def pin(self, skey: tuple, base: int, length: int, data, *,
            crc=None, source_ref=None) -> Optional[TierLease]:
        """Place an extent in HBM and pin it there: admit + lookup as
        one transition.  Returns the holding lease, or None when the
        tier is off, capacity is pinned solid, or a racing drop won.
        The pin IS a promotion — it counts in the tier scoreboard."""
        hbm = self._tiers.get("hbm")
        if hbm is None or not hbm.active:
            return None
        if not hbm.admit(skey, base, length, data,
                         crc=crc, source_ref=source_ref):
            return None
        lease = hbm.lookup(skey, base, length)
        if lease is None:  # racing invalidation/drop won
            hbm.drop(skey, base, length)
            return None
        stats.add("nr_tier_hbm_promote")
        if _trace.active:
            _trace.instant("tier_promote", offset=base, length=length,
                           args={"tier": "hbm"})
        return lease

    def unpin(self, lease: Optional[TierLease], skey: tuple, base: int,
              length: int) -> None:
        """Release a pin taken with :meth:`pin` and drop the extent
        WITHOUT demotion — the caller owns the bytes' next home."""
        if lease is not None:
            lease.release()
        hbm = self._tiers.get("hbm")
        if hbm is not None:
            hbm.drop(skey, base, length)

    # -- coherency (ONE invalidation contract) -------------------------

    def invalidate_extents(self, skey: tuple,
                           extents: Sequence[Tuple[int, int]]) -> int:
        """The write ladder's invalidation contract: drop every resident
        copy the write touches, in EVERY tier.  Same-key entries match
        by byte overlap; entries under a different key that shares a
        file drop wholesale (offsets do not map across framings).
        Returns the number dropped across the hierarchy."""
        n = 0
        for name in self._ORDER:
            t = self._tiers.get(name)
            if t is not None:
                n += t.invalidate_extents(skey, extents)
        return n

    def invalidate_paths(self, paths: Sequence[str]) -> int:
        """Drop every resident extent over any of *paths*, in every tier
        (the checkpoint savers' contract after an atomic rename)."""
        n = 0
        for name in self._ORDER:
            t = self._tiers.get(name)
            if t is not None:
                n += t.invalidate_paths(paths)
        return n

    # -- integrity scrub -----------------------------------------------

    def scrub_tiers(self):
        """``(name, tier)`` pairs the background scrubber walks, bottom
        up (RAM first)."""
        out = []
        for name in reversed(self._ORDER):
            t = self._tiers.get(name)
            if t is not None and t.active:
                out.append((name, t))
        return out

    # -- the ONE residency surface -------------------------------------

    def residency(self) -> Dict[str, int]:
        """Resident bytes per tier (the scoreboard's gauges)."""
        return {name: t.resident_bytes()
                for name, t in self._tiers.items()}

    def resident_fraction(self, paths: Sequence[str],
                          total_bytes: int) -> Dict[str, float]:
        """Fraction of a table's bytes resident, per tier — the surface
        the planner and EXPLAIN consume (expected hit ratio per tier
        for a scan over *paths*)."""
        return {name: t.resident_fraction(paths, total_bytes)
                for name, t in self._tiers.items()}


#: the process-wide space; the tiers register at import, a Session calls
#: ``configure()`` at construction, and a tier's own ``configure()`` ends
#: in ``extent_space.rewire()``
extent_space = ExtentSpace()
