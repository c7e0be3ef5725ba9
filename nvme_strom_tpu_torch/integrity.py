"""The resident-data integrity domain: the JAX package's ``integrity.py``.

Once an extent lands in the RAM tier (:mod:`.cache`) or the HBM tier
(:mod:`.serving.hbm_tier`), nothing else re-reads it from the SSD; bit rot
there would be served forever.  Three pieces, each gated by config so the
default pays one branch:

* :data:`domain` — the process-wide mode (config ``integrity``:
  ``off|transitions|always``) and the crc32c the tiers share.  A tier
  stores the crc32c of an extent when it fills it and checks it at every
  tier transition (promote, demote), and under ``always`` at every
  lease-served read.  A mismatch drops the entry under its lease rules and
  the reader falls back to the SSD: a cached copy never raises EBADMSG.
* :class:`Scrubber` — one thread a Session (the canary's pattern) that
  walks the tiers' resident extents checking their crc32c, at most
  ``scrub_bytes_per_sec``.  A corrupt extent is dropped and read again
  from the SSD through the whole fault ladder; an HBM extent is admitted
  again with the healed bytes.
* the pressure registry (:func:`register_pool`, :func:`pools`,
  :func:`request_shed`) through which memlock pressure in the RAM tier
  asks other holders of resident bytes to shed first: the KV block pool
  (:class:`.serving.kvcache.KvBlockPool`) registers at construction, and
  the scrubber walks its spill blocks too.

:func:`verify_and_reread` is the checksum verify on read (config
``checksum_verify``) that the engine's read sites and the staging ring's
write-back tail share: the heap pages' own crc32c, checked on bytes just
landed from the SSD.
"""

from __future__ import annotations

import errno as _errno
import threading
import time
import weakref
from typing import Callable, Optional

from .api import StromError
from .config import config
from .stats import stats
from .trace import recorder as _trace

__all__ = ["crc32c", "IntegrityDomain", "domain", "register_pool", "pools",
           "request_shed", "Scrubber", "verify_and_reread"]


def crc32c(data) -> int:
    """crc32c of a resident buffer, by the page checksum's implementation
    (:func:`.scan.heap.crc32c`: ``google_crc32c``, else the port's C
    library).  Imported at the call: the tiers import this module, and
    the scan package must not load with them."""
    from .scan.heap import crc32c as f
    return f(data)


class IntegrityDomain:
    """The process-wide integrity mode and the verify the tiers share.

    ``active`` is False under ``integrity=off``, so each tier's hot path
    costs one attribute test; ``verify_reads`` adds the check of every
    lease-served read under ``integrity=always``."""

    def __init__(self) -> None:
        self.mode = "off"
        self.active = False
        self.verify_reads = False

    def configure(self) -> None:
        """Re-read config ``integrity`` (at Session construction)."""
        mode = str(config.get("integrity"))
        self.mode = mode
        self.active = mode != "off"
        self.verify_reads = mode == "always"

    def checksum(self, data) -> Optional[int]:
        """crc32c of a resident buffer, or None while the domain is off
        (such an entry carries no checksum and is never verified)."""
        if not self.active:
            return None
        return crc32c(data)

    def verify(self, data, crc: Optional[int]) -> bool:
        """Check a resident buffer against its fill-time crc32c, counting
        each check; an entry filled while the domain was off (crc None)
        passes."""
        if crc is None:
            return True
        stats.add("nr_integrity_verify")
        if crc32c(data) == crc:
            return True
        stats.add("nr_integrity_fail")
        return False


#: the process-wide domain
domain = IntegrityDomain()


# -- checksum verify on read --------------------------------------------------

def verify_and_reread(view, reread: Callable[[int, memoryview], None],
                      file_offset: Callable[[int], int], *, where: str = "",
                      trace_args: Optional[dict] = None) -> None:
    """Check the crc32c of each heap page of a region just landed from the
    SSD (header word 7; pages with no heap magic or a zero word are
    skipped).  A bad page is read again into place by ``reread(page,
    page_view)`` up to ``checksum_retries`` times, then EBADMSG
    (CORRUPTION) is raised, naming ``file_offset(page)`` of the first bad
    page.  Moves ``nr_csum_fail``, ``nr_csum_reread`` and
    ``bytes_verify_reread``; with *trace_args* each failed pass records a
    ``csum_fail`` instant."""
    from .scan.heap import PAGE_SIZE, verify_page_checksums
    bad = verify_page_checksums(view)
    rereads = int(config.get("checksum_retries"))
    while bad:
        stats.add("nr_csum_fail", len(bad))
        if trace_args is not None and _trace.active:
            _trace.instant("csum_fail", **trace_args,
                           args={"bad_pages": len(bad)})
        if rereads <= 0:
            raise StromError(
                _errno.EBADMSG,
                f"page checksum mismatch{where} at file offset "
                f"{file_offset(bad[0])} ({len(bad)} bad page(s), re-reads "
                f"exhausted)")
        rereads -= 1
        stats.add("nr_csum_reread", len(bad))
        stats.add("bytes_verify_reread", len(bad) * PAGE_SIZE)
        for p in bad:
            off = p * PAGE_SIZE
            reread(p, view[off:off + PAGE_SIZE])
        bad = verify_page_checksums(view)


# -- the pressure registry ----------------------------------------------------
# holders of resident bytes register so that memlock pressure in one tier
# can ask them to shed; a WeakSet, so a dropped holder leaves by itself
_pools: "weakref.WeakSet" = weakref.WeakSet()


def register_pool(pool) -> None:
    _pools.add(pool)


def pools() -> list:
    return list(_pools)


def request_shed(nbytes: int, reason: str = "memlock") -> int:
    """Ask the registered holders to shed about *nbytes*; returns the
    bytes they shed.  Never raises: pressure relief must not put a new
    error on a reader's path."""
    shed = 0
    for pool in pools():
        if shed >= nbytes:
            break
        try:
            shed += pool.shed(nbytes - shed, reason=reason)
        except Exception:
            continue
    return shed


# -- the background scrubber --------------------------------------------------

def _rotate(keys: list, cursor) -> list:
    """Round-robin: resume after the last key scrubbed, so a rate-limited
    walk comes round to every resident extent."""
    if cursor is None or cursor not in keys:
        return keys
    i = keys.index(cursor) + 1
    return keys[i:] + keys[:i]


class Scrubber:
    """The rate-limited scrub thread of one Session.

    Started at Session construction and stopped at close, as the canary
    is; it re-reads ``scrub_bytes_per_sec`` every tick, so a live session
    can be retuned, and idles on one Event wait a tick while that is 0 or
    the domain is off.  Its reads of HBM extents run with the HBM tier's
    card as the thread's CUDA device."""

    INTERVAL = 0.05              # seconds a token-bucket tick

    def __init__(self, session) -> None:
        self._session = session
        self._stop = threading.Event()
        self._carry = 0.0        # unspent budget carried between ticks
        self._cursor: dict = {}  # tier name -> last key scrubbed
        self._device = None      # the CUDA device this thread was set to
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="strom-scrub")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    # -- pacing -------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.INTERVAL):
            try:
                rate = int(config.get("scrub_bytes_per_sec"))
            except Exception:  # pragma: no cover - config torn down at exit
                return
            try:
                self._tick(rate)
            except Exception:  # pragma: no cover - must never kill the thread
                continue

    def _tick(self, rate: int) -> int:
        """One tick of the token bucket at *rate* bytes a second; returns
        the bytes scrubbed (0 while the rate is 0 or the domain off)."""
        if rate <= 0 or not domain.active:
            self._carry = 0.0
            return 0
        budget = int(rate * self.INTERVAL + self._carry)
        if budget <= 0:
            self._carry += rate * self.INTERVAL
            return 0
        done = self._scrub_round(budget)
        # carry what is unspent, at most a second of rate, so a long idle
        # stretch cannot bankroll a burst
        self._carry = min(budget - done, rate)
        return done

    def _scrub_round(self, budget: int) -> int:
        """One walk of every active tier, bottom up (RAM before HBM, so a
        healed host extent is in place before the device tier admits it
        again), within *budget* bytes; returns the bytes scrubbed."""
        from .tiering import extent_space
        done = 0
        for name, tier in extent_space.scrub_tiers():
            if done >= budget or self._stop.is_set():
                break
            done += self._scrub_tier(name, tier, budget - done)
        if done < budget and not self._stop.is_set():
            done += self._scrub_pools(budget - done)
        return done

    # -- the resident tiers ---------------------------------------------------
    def _scrub_tier(self, name: str, tier, budget: int) -> int:
        dev = getattr(tier, "_device", None) if name == "hbm" else None
        if dev is not None and dev.type == "cuda" and dev != self._device:
            # the thread's D2H copies out of HBM extents run on the
            # tier's card (the tier is process-wide: not the Session's)
            import torch
            torch.cuda.set_device(dev.index or 0)   # "cuda" is cuda:0
            self._device = dev
        scanned = 0
        for key in _rotate(tier.scrub_keys(), self._cursor.get(name)):
            if scanned >= budget or self._stop.is_set():
                break
            res = tier.scrub_extent(key)
            if res is None:
                continue
            ok, length, source_ref = res
            self._cursor[name] = key
            scanned += length
            t0 = time.monotonic_ns()
            stats.add("nr_scrub_extent")
            stats.add("bytes_scrubbed", length)
            if _trace.active:
                _trace.span("scrub", t0, time.monotonic_ns(),
                            offset=key[1], length=length,
                            args={"tier": name, "ok": ok})
            if not ok:
                healed = self._heal(key, source_ref, tier=name)
                # the healed bytes go back up, so the extent stays
                # HBM-resident (the RAM tier was refilled by the wait-time
                # fill of the healing read)
                if healed is not None and name == "hbm":
                    tier.admit(key[0], key[1], key[2], healed,
                               crc=domain.checksum(healed),
                               source_ref=source_ref)
        return scanned

    def _scrub_pools(self, budget: int) -> int:
        """The resident blocks of the KV pools this Session serves (their
        spill blocks); their debits are stripe members whose copy rotted.
        Another Session's pool is its own scrubber's: healed here, its
        debits would land on this Session's members, never on the pool's."""
        scanned = 0
        for pool in pools():
            if scanned >= budget or self._stop.is_set():
                break
            if getattr(pool, "_session", None) is not self._session:
                continue
            try:
                done, debits = pool.scrub_spill(budget - scanned)
            except Exception:
                continue
            scanned += done
            for member in debits:
                self._debit(member)
        return scanned

    # -- healing ----------------------------------------------------------------
    def _heal(self, key, source_ref, *, tier: str) -> Optional[bytes]:
        """Read one corrupt (already dropped) extent again from the SSD
        through the Session's whole fault ladder; the read's wait-time
        fill puts the healed bytes back under the same key."""
        _skey, base, length = key
        src = source_ref() if source_ref is not None else None
        t0 = time.monotonic_ns()
        data = self._session._scrub_refill(src, base, length)
        if data is None:
            stats.add("nr_scrub_fail")
            return None
        stats.add("nr_scrub_repair")
        if _trace.active:
            _trace.span("repair", t0, time.monotonic_ns(),
                        offset=base, length=length, args={"tier": tier})
        return data

    def _debit(self, member: int) -> None:
        """A scrub failure of one stripe member: debit its health machine
        (repeated debits quarantine it)."""
        stats.member_error(member)
        try:
            self._session._member_health.record_failure(member)
        except Exception:  # pragma: no cover - session tearing down
            pass
