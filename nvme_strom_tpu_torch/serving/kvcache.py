"""SSD-backed KV-cache paging over the HBM tier: the JAX package's
``serving/kvcache.py``.

Serving long contexts means the KV cache outgrows the card; fixed-size
blocks with per-sequence block tables (vLLM's PagedAttention) solve the
fragmentation, and this pool adds the tiers below: a block that falls out
of the card's working set demotes to pinned host RAM, and out of that to
an SSD spill extent, through the session's write ladder, so a mirrored
spill source keeps paging byte-identical through a member's fail-stop
(page-ins heal through the mirror, writes keep both legs coherent).

Placement is exclusive; a block lives in exactly ONE of:

* **HBM** — pinned through the unified extent space
  (:meth:`..tiering.ExtentSpace.pin` / ``unpin``): a uint8 CUDA tensor of
  the HBM tier held by a :class:`..tiering.TierLease`, whose reference
  keeps the tier's own LRU off it; only the pool demotes its blocks, and
  ``unpin`` drops them without a RAM-tier demotion, because the pool owns
  the bytes' next home;
* **pinned RAM** — a slot of one session DMA buffer (registered with CUDA
  when the session's device is a card, so a demotion's copy out of the
  card lands by DMA);
* **SSD** — a ``block_bytes`` chunk of the writable spill source.

Moves down follow the pool's LRU and are counted and traced:
``nr_kv_pageout`` and a ``kv_page`` span a RAM -> SSD write,
``nr_kv_pagein`` and a span an SSD -> RAM read; :meth:`KvBlockPool.resume`
prefetches a parked sequence's spilled blocks with one asynchronous
submit a block.  Under the integrity domain every transition checks the
block's crc32c, and a rotten spill block is healed from its mirror leg
with the rotten member debited.

Two faults of the JAX pool are not copied.  A block whose HBM copy was
revoked is lost (the reference then serves a stale RAM slot's bytes at
its next read); here every later read raises EIO until the block is
written again.  A pressure shed demotes an HBM block through a transit
slot of its own, so it pages out no other sequence's RAM block (the
reference's demotion can put a latency block on the SSD before the bulk
ones).  A failed page-in or resume gives its RAM slots back.

Keys in the HBM tier are a per-pool synthetic source key (``#kvpool:N``,
the ``#`` tag convention of :func:`..tiering.source_key`), so KV extents
never collide with a file's and path invalidation never touches them.
"""

from __future__ import annotations

import errno as _errno
import itertools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from ..api import StromError
from ..config import config
from ..stats import stats
from ..trace import recorder as _trace
from ..integrity import domain as _integrity, register_pool
from ..tiering import extent_space

__all__ = ["KvBlockPool"]

_pool_ids = itertools.count(1)

#: pressure-shed priority: bulk chains demote first, the latency class
#: last (the QoS ordering applied to residency)
_SHED_ORDER = {"bulk": 0, "normal": 1, "latency": 2}


class _Block:
    __slots__ = ("seq", "idx", "gid", "tier", "slot", "lease", "crc",
                 "lost")

    def __init__(self, seq, idx: int, gid: int) -> None:
        self.seq = seq
        self.idx = idx
        self.gid = gid      # pool-global id; HBM-tier base = gid*block_bytes
        self.tier = "ram"   # "hbm" | "ram" | "ssd"
        self.slot = -1      # ram slot or ssd slot, by tier
        self.lease = None   # TierLease pin while tier == "hbm"
        self.crc = None     # fill-time crc32c (None under integrity=off)
        self.lost = False   # its only copy was revoked: EIO until written


class KvBlockPool:
    """Fixed-size KV block pool with per-sequence block tables.

    *spill* is a writable Source (mirror it to survive a fail-stop) whose
    size bounds the SSD tier; *ram_blocks* bounds the pinned-RAM tier; the
    HBM share defaults to half the HBM tier's capacity (``tier_hbm_bytes``),
    leaving room for the scan promotions the tier also serves."""

    def __init__(self, session, spill, *, block_bytes: Optional[int] = None,
                 ram_blocks: int = 16, hbm_blocks: Optional[int] = None,
                 durable: bool = False) -> None:
        bb = int(block_bytes or config.get("kv_block_bytes"))
        if bb <= 0 or (bb & (bb - 1)):
            raise StromError(_errno.EINVAL,
                             f"block_bytes {bb} must be a power of two")
        if ram_blocks < 2:
            raise StromError(_errno.EINVAL, "need at least 2 RAM blocks")
        spill._check_writable()
        self.block_bytes = bb
        self._session = session
        self._spill = spill
        self._durable = durable
        # one slot past the RAM tier's: the transit slot of a pressure
        # shed's HBM -> SSD move, never in the free list
        self._transit = ram_blocks
        self._handle, self._dma = session.alloc_dma_buffer(
            (ram_blocks + 1) * bb)
        self._ram_free = list(range(ram_blocks))
        self._ssd_free = list(range(spill.size // bb))
        if not self._ssd_free:
            session.unmap_buffer(self._handle)
            raise StromError(_errno.EINVAL,
                             f"spill source smaller than one {bb}B block")
        if hbm_blocks is None:
            hbm_blocks = (extent_space.tier_capacity("hbm") // 2 // bb
                          if extent_space.tier_active("hbm") else 0)
        self._hbm_budget = hbm_blocks
        self._hbm_used = 0
        self._skey = ("#kvpool:%d" % next(_pool_ids),)
        self._tables: Dict[object, List[_Block]] = {}
        self._classes: Dict[object, str] = {}  # seq -> QoS class
        self._lru: "OrderedDict[int, _Block]" = OrderedDict()  # ram+hbm
        # the RAM-tier blocks of _lru in _lru's order: an eviction finds
        # its victim without walking past the pinned HBM blocks
        self._ram_lru: "OrderedDict[int, _Block]" = OrderedDict()
        self._gids = itertools.count()
        self._lock = threading.RLock()
        self._closed = False
        # the integrity domain: the scrubber walks this pool's spill
        # blocks, and memlock pressure can ask it to shed
        register_pool(self)

    # -- introspection -------------------------------------------------

    def residency(self) -> Dict[str, int]:
        """Block counts per tier."""
        with self._lock:
            out = {"hbm": 0, "ram": 0, "ssd": 0}
            for table in self._tables.values():
                for b in table:
                    out[b.tier] += 1
            return out

    def sequences(self) -> List[object]:
        with self._lock:
            return list(self._tables)

    def blocks(self, seq) -> int:
        with self._lock:
            return len(self._tables.get(seq, ()))

    # -- block table ops ----------------------------------------------

    def append(self, seq, data, *, qos_class: Optional[str] = None) -> int:
        """Append *data* (at most ``block_bytes``; a short block is
        zero-padded) as the sequence's next block; returns its index.
        ``qos_class`` sets the sequence's pressure-shed priority (bulk
        sheds first); default config ``qos_default_class``."""
        with self._lock:
            self._check_open()
            table = self._tables.setdefault(seq, [])
            if seq not in self._classes:
                self._classes[seq] = qos_class or \
                    str(config.get("qos_default_class"))
            elif qos_class:
                self._classes[seq] = qos_class
            blk = _Block(seq, len(table), next(self._gids))
            blk.slot = self._get_ram_slot()
            self._lru[blk.gid] = blk
            self._ram_lru[blk.gid] = blk
            table.append(blk)
            self._fill_ram(blk, data)
            return blk.idx

    def write(self, seq, idx: int, data) -> None:
        """Overwrite block *idx* in place (a decode step's KV update).  An
        HBM-resident block demotes to RAM first (the device copy is
        immutable) and promotes again at its next read."""
        with self._lock:
            self._check_open()
            blk = self._get_block(seq, idx)
            if blk.tier == "hbm":
                self._demote_hbm(blk)
            elif blk.tier == "ssd":
                self._page_in(blk)
            self._touch(blk)
            self._fill_ram(blk, data)

    def read(self, seq, idx: int) -> bytes:
        """The block's bytes, paged in and promoted as a side effect: an
        SSD block pages into RAM (healed through the mirror when a member
        is down), a RAM block promotes into the pool's HBM share while
        the budget allows.  EIO for a lost block."""
        with self._lock:
            self._check_open()
            blk = self._get_block(seq, idx)
            self._check_lost(blk)
            if blk.tier == "ssd":
                self._page_in(blk)
            if blk.tier == "ram":
                self._promote(blk)
            self._touch(blk)
            if blk.tier == "hbm":
                out = bytearray(self.block_bytes)
                if not blk.lease.copy_into(memoryview(out)):
                    # revoked between pin and copy: placement is
                    # exclusive, so the bytes have no other home
                    self._drop_hbm(blk)
                    blk.tier, blk.slot = "ram", self._get_ram_slot()
                    self._touch(blk)
                    self._lose(blk)
                    raise StromError(
                        _errno.EIO,
                        f"KV block {blk.idx} lost to HBM revocation")
                return bytes(out)
            return bytes(self._ram_view(blk.slot))

    def device_array(self, seq, idx: int):
        """The block as its uint8 tensor on the HBM tier's device
        (attention kernels read it without a host round trip), promoting
        it if needed; None when the HBM share is spent or the tier is
        off.  EIO for a lost block."""
        with self._lock:
            self._check_open()
            blk = self._get_block(seq, idx)
            self._check_lost(blk)
            if blk.tier == "ssd":
                self._page_in(blk)
            if blk.tier == "ram":
                self._promote(blk)
            self._touch(blk)
            return blk.lease.device_array() if blk.tier == "hbm" else None

    def resume(self, seq) -> int:
        """Prefetch on sequence resume: page every spilled block of *seq*
        back into RAM with one asynchronous submit a block, waiting once at
        the end.  Returns the number of blocks paged in."""
        with self._lock:
            self._check_open()
            table = self._tables.get(seq, [])
            spilled = [b for b in table if b.tier == "ssd"]
            # cap at what RAM can hold without evicting this sequence
            budget = len(self._ram_free) + sum(
                1 for b in self._ram_lru.values() if b.seq != seq)
            spilled = spilled[:max(0, budget)]
            inflight = []
            try:
                for blk in spilled:
                    slot = self._get_ram_slot(avoid_seq=seq)
                    inflight.append([blk, slot, None, time.monotonic_ns()])
                    inflight[-1][2] = self._session.memcpy_ssd2ram(
                        self._spill, self._handle, [blk.slot],
                        self.block_bytes,
                        dest_offset=slot * self.block_bytes)
                while inflight:
                    blk, slot, res, ts = inflight[0]
                    self._session.memcpy_wait(res.dma_task_id)
                    self._verify_landed(blk, blk.slot, self._ram_view(slot))
                    inflight.pop(0)
                    self._ssd_free.append(blk.slot)
                    blk.tier, blk.slot = "ram", slot
                    self._lru[blk.gid] = blk
                    self._touch(blk)
                    stats.add("nr_kv_pagein")
                    stats.add("nr_tier_ram_fault")  # SSD->RAM demand fault
                    if _trace.active:
                        _trace.span("kv_page", ts, time.monotonic_ns(),
                                    offset=blk.gid * self.block_bytes,
                                    length=self.block_bytes,
                                    args={"dir": "in", "block": blk.idx,
                                          "resume": True})
            except BaseException:
                # the blocks not landed stay on the SSD; their slots
                # come back once their reads are done with them
                for _blk, slot, res, _ts in inflight:
                    if res is not None:
                        try:
                            self._session.memcpy_wait(res.dma_task_id,
                                                      timeout=30.0)
                        except StromError:
                            pass
                    self._ram_free.append(slot)
                raise
            return len(spilled)

    def release(self, seq) -> None:
        """Drop a finished sequence: every slot returns to its free list,
        HBM pins release and drop."""
        with self._lock:
            table = self._tables.pop(seq, [])
            self._classes.pop(seq, None)
            for blk in table:
                if blk.tier == "hbm":
                    extent_space.unpin(blk.lease, self._skey,
                                       blk.gid * self.block_bytes,
                                       self.block_bytes)
                    self._hbm_used -= 1
                elif blk.tier == "ram":
                    self._ram_free.append(blk.slot)
                else:
                    self._ssd_free.append(blk.slot)
                self._lru.pop(blk.gid, None)
                self._ram_lru.pop(blk.gid, None)

    def migrate(self, seq, peer: "KvBlockPool", *,
                release: bool = True) -> int:
        """Move sequence *seq*'s whole chain into *peer*'s pool (on a
        serving mesh each host runs its own pool over its own spill, and a
        hot host sheds chains to a cold peer).

        All or nothing: blocks are copied out through :meth:`read` (so
        spilled blocks page in through the fault ladder) while the source
        chain stays whole, then appended to the peer in order with the
        sequence's QoS class.  A peer failure midway rolls the peer back
        (``peer.release``) and raises; the source is untouched.  Only
        after the peer holds every block is the source chain released
        (``release=False`` keeps it).  Returns the bytes migrated."""
        if not bool(config.get("kv_migrate")):
            raise StromError(_errno.EOPNOTSUPP,
                             "cross-host KV migration disabled (kv_migrate)")
        if peer is self:
            raise StromError(_errno.EINVAL,
                             "cannot migrate a sequence onto its own pool")
        if self.block_bytes > peer.block_bytes:
            raise StromError(
                _errno.EINVAL,
                f"peer blocks ({peer.block_bytes}B) smaller than "
                f"ours ({self.block_bytes}B)")
        t0 = time.monotonic_ns()
        with self._lock:
            self._check_open()
            if seq not in self._tables:
                raise StromError(_errno.ENOENT, f"no sequence {seq!r}")
            qos = self._classes.get(seq,
                                    str(config.get("qos_default_class")))
            n = len(self._tables[seq])
        if peer.blocks(seq):
            raise StromError(_errno.EEXIST,
                             f"peer already holds sequence {seq!r}")
        # copy-out holds OUR lock a block at a time and peer.append the
        # peer's only: never both, so two pools migrating toward each
        # other cannot deadlock
        try:
            for i in range(n):
                peer.append(seq, self.read(seq, i), qos_class=qos)
        except BaseException:
            stats.add("nr_kv_migrate_fail")
            try:
                peer.release(seq)
            except Exception:  # noqa: BLE001 - rollback is best-effort
                pass
            raise
        if release:
            self.release(seq)
        stats.add("nr_kv_migrate")
        if _trace.active:
            _trace.span("kv_migrate", t0, time.monotonic_ns(),
                        length=n * self.block_bytes,
                        args={"blocks": n, "class": qos,
                              "released": release})
        return n * self.block_bytes

    def shed_to_peer(self, peer: "KvBlockPool", nbytes: int, *,
                     reason: str = "pressure") -> int:
        """Pressure relief to a cold peer: migrate whole chains until
        about *nbytes* moved, bulk sequences first.  A chain the peer
        cannot take is skipped, never raised.  Returns the bytes moved."""
        with self._lock:
            if self._closed:
                return 0
            seqs = sorted(
                self._tables,
                key=lambda s: _SHED_ORDER.get(
                    self._classes.get(s, "normal"), 1))
        shed = 0
        for seq in seqs:
            if shed >= nbytes:
                break
            try:
                moved = self.migrate(seq, peer)
            except StromError:
                continue
            shed += moved
            if _trace.active:
                _trace.instant("pressure_shed", length=moved,
                               args={"tier": "kv-peer", "reason": reason})
        return shed

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            for seq in list(self._tables):
                self.release(seq)
            self._closed = True
            try:
                self._session.unmap_buffer(self._handle)
            except StromError:
                pass
            self._dma.close()

    # -- internals (pool lock held) ------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise StromError(_errno.EBADF, "KV pool closed")

    def _get_block(self, seq, idx: int) -> _Block:
        try:
            return self._tables[seq][idx]
        except (KeyError, IndexError):
            raise StromError(
                _errno.ENOENT, f"no KV block {idx} for sequence {seq!r}"
            ) from None

    def _touch(self, blk: _Block) -> None:
        """Most recently used: to the end of the LRU (and of the RAM-tier
        LRU when the block is in RAM)."""
        self._lru.move_to_end(blk.gid)
        if blk.tier == "ram":
            self._ram_lru[blk.gid] = blk
            self._ram_lru.move_to_end(blk.gid)

    def _ram_lru_rebuild(self) -> None:
        """After a block entered RAM at its place in the LRU (a demotion
        not followed by a touch): the RAM-tier LRU from the LRU."""
        self._ram_lru = OrderedDict(
            (g, b) for g, b in self._lru.items() if b.tier == "ram")

    @staticmethod
    def _check_lost(blk: _Block) -> None:
        if blk.lost:
            raise StromError(_errno.EIO, f"KV block {blk.idx} was lost to "
                                         f"an HBM revocation")

    @staticmethod
    def _lose(blk: _Block) -> None:
        """The block's only copy is gone: its slot holds no promise and
        no checksum holds it, until a write fills it again."""
        blk.lost = True
        blk.crc = None

    def _ram_view(self, slot: int) -> memoryview:
        base = slot * self.block_bytes
        return self._dma.view()[base:base + self.block_bytes]

    def _fill_ram(self, blk: _Block, data) -> None:
        n = len(data)
        if n > self.block_bytes:
            raise StromError(_errno.EINVAL,
                             f"{n}B exceeds the {self.block_bytes}B block")
        view = self._ram_view(blk.slot)
        view[:n] = bytes(data) if not isinstance(data, (bytes, bytearray,
                                                        memoryview)) else data
        if n < self.block_bytes:
            view[n:] = b"\0" * (self.block_bytes - n)
        # the crc covers the whole (zero-padded) block: page-out writes
        # and page-in reads move whole blocks
        blk.crc = _integrity.checksum(view)
        blk.lost = False

    def _get_ram_slot(self, avoid_seq=None) -> int:
        """A free RAM slot, paging out the pool-LRU RAM block when none is
        free (HBM blocks are pinned and SSD blocks hold no slot, so only
        ``tier == "ram"`` entries are candidates)."""
        if self._ram_free:
            return self._ram_free.pop()
        for blk in self._ram_lru.values():
            if avoid_seq is None or blk.seq != avoid_seq:
                self._page_out(blk)
                break
        if not self._ram_free:
            raise StromError(_errno.ENOSPC,
                             "KV RAM tier exhausted and nothing evictable")
        return self._ram_free.pop()

    def _page_out(self, blk: _Block, *, slot: Optional[int] = None) -> None:
        """RAM -> SSD over the session's write ladder (a mirrored spill
        keeps both legs coherent), from the block's slot or, for a shed
        HBM block, the transit *slot*."""
        if not self._ssd_free:
            raise StromError(_errno.ENOSPC, "KV spill extent full")
        src_slot = blk.slot if slot is None else slot
        if _integrity.active:
            # page-out is a tier transition: RAM rot is caught before it
            # is made durable (counted; the write proceeds, this is the
            # only copy and the counter is the operator's signal)
            _integrity.verify(self._ram_view(src_slot), blk.crc)
        ssd_slot = self._ssd_free.pop()
        ts = time.monotonic_ns()
        try:
            res = self._session.memcpy_ram2ssd(
                self._spill, self._handle, [ssd_slot], self.block_bytes,
                src_offset=src_slot * self.block_bytes)
            self._session.memcpy_wait(res.dma_task_id)
        except BaseException:
            self._ssd_free.append(ssd_slot)
            raise
        if self._durable:
            self._spill.sync()
        if slot is None:
            self._ram_free.append(blk.slot)
        self._lru.pop(blk.gid, None)
        self._ram_lru.pop(blk.gid, None)
        blk.tier, blk.slot = "ssd", ssd_slot
        stats.add("nr_kv_pageout")
        if _trace.active:
            _trace.span("kv_page", ts, time.monotonic_ns(),
                        offset=blk.gid * self.block_bytes,
                        length=self.block_bytes,
                        args={"dir": "out", "block": blk.idx})

    def _page_in(self, blk: _Block) -> None:
        """SSD -> RAM; the engine's fault ladder (hedges, mirror reads)
        serves it with a spill member fail-stopped.  Under the integrity
        domain the landed bytes are checked against the page-out crc, and
        a mismatch is healed from the mirror leg (written back to the
        corrupt primary) or raises EBADMSG."""
        slot = self._get_ram_slot()
        ts = time.monotonic_ns()
        ssd_slot = blk.slot
        try:
            res = self._session.memcpy_ssd2ram(
                self._spill, self._handle, [ssd_slot], self.block_bytes,
                dest_offset=slot * self.block_bytes)
            self._session.memcpy_wait(res.dma_task_id)
            self._verify_landed(blk, ssd_slot, self._ram_view(slot))
        except BaseException:
            self._ram_free.append(slot)  # the block stays on the SSD
            raise
        self._ssd_free.append(ssd_slot)
        self._lru[blk.gid] = blk
        self._ram_lru[blk.gid] = blk
        blk.tier, blk.slot = "ram", slot
        stats.add("nr_kv_pagein")
        stats.add("nr_tier_ram_fault")  # SSD->RAM demand fault
        if _trace.active:
            _trace.span("kv_page", ts, time.monotonic_ns(),
                        offset=blk.gid * self.block_bytes,
                        length=self.block_bytes,
                        args={"dir": "in", "block": blk.idx})

    def _promote(self, blk: _Block) -> None:
        """RAM -> HBM while the pool's share allows; the extent space
        places and pins the block in one transition."""
        if not extent_space.tier_active("hbm") \
                or self._hbm_used >= self._hbm_budget:
            return
        base = blk.gid * self.block_bytes
        data = self._ram_view(blk.slot)
        # pin checks data against the crc (a promotion is a transition):
        # a rotten RAM block stays in RAM, counted
        lease = extent_space.pin(self._skey, base, self.block_bytes,
                                 data, crc=blk.crc)
        if lease is None:
            return
        self._ram_free.append(blk.slot)
        self._ram_lru.pop(blk.gid, None)
        blk.tier, blk.slot, blk.lease = "hbm", -1, lease
        self._hbm_used += 1

    def _copy_down(self, blk: _Block, slot: int) -> bool:
        """The HBM block's bytes into RAM *slot*, checked under the
        integrity domain (a rotten device copy is the only copy: counted,
        not raised), then the pin dropped WITHOUT a RAM-tier demotion (the
        pool is the bytes' home).  False when the copy was revoked."""
        ok = blk.lease.copy_into(self._ram_view(slot))
        if ok and _integrity.active:
            _integrity.verify(self._ram_view(slot), blk.crc)
        self._drop_hbm(blk)
        return ok

    def _demote_hbm(self, blk: _Block) -> None:
        """HBM -> RAM, into a fresh RAM slot; EIO, the block lost, when
        the device copy was revoked."""
        slot = self._get_ram_slot()
        ok = self._copy_down(blk, slot)
        blk.tier, blk.slot = "ram", slot
        if not ok:
            self._lose(blk)
            self._ram_lru_rebuild()
            raise StromError(_errno.EIO,
                             f"KV block {blk.idx} lost to HBM revocation")

    def _shed_hbm(self, blk: _Block) -> None:
        """A pressure shed's HBM -> SSD: through a free RAM slot as the
        reference moves it, else through the transit slot, so that no
        other block leaves RAM for it.  A revoked copy ends as
        :meth:`_demote_hbm`'s does (the block lost, in RAM, EIO)."""
        if self._ram_free or self._transit is None:
            # a free slot displaces nothing: the reference's own move
            self._demote_hbm(blk)
            try:
                self._page_out(blk)
            except BaseException:
                self._ram_lru_rebuild()   # it stays in RAM, at its place
                raise
            return
        if not self._ssd_free:
            raise StromError(_errno.ENOSPC, "KV spill extent full")
        if not self._copy_down(blk, self._transit):
            blk.tier, blk.slot = "ram", self._get_ram_slot()
            self._lose(blk)
            self._ram_lru_rebuild()
            raise StromError(_errno.EIO,
                             f"KV block {blk.idx} lost to HBM revocation")
        blk.tier, blk.slot = "ram", -1
        self._lru.pop(blk.gid, None)
        try:
            self._page_out(blk, slot=self._transit)
        except BaseException:
            # the spill refused it: the block takes a RAM slot after all,
            # the transit slot itself when no other can be had
            try:
                blk.slot = self._get_ram_slot()
                self._ram_view(blk.slot)[:] = self._ram_view(self._transit)
            except StromError:
                blk.slot, self._transit = self._transit, None
            self._lru[blk.gid] = blk
            self._ram_lru[blk.gid] = blk
            raise

    def _drop_hbm(self, blk: _Block) -> None:
        extent_space.unpin(blk.lease, self._skey,
                           blk.gid * self.block_bytes, self.block_bytes)
        blk.lease = None
        self._hbm_used -= 1

    # -- the integrity domain ------------------------------------------

    def _verify_landed(self, blk: _Block, ssd_slot: int, view) -> None:
        """A page-in's landed bytes against the page-out crc; a mismatch
        heals from the mirror leg (fixing the corrupt primary on disk
        too) or raises EBADMSG: a spill block has no other copy."""
        if blk.crc is None or not _integrity.active:
            return
        if _integrity.verify(view, blk.crc):
            return
        t0 = time.monotonic_ns()
        debits = self._heal_spill(blk, ssd_slot, view)
        if debits is None:
            stats.add("nr_scrub_fail")
            raise StromError(
                _errno.EBADMSG,
                f"KV block {blk.idx} corrupt on spill and unhealable")
        stats.add("nr_scrub_repair")
        if _trace.active:
            _trace.span("repair", t0, time.monotonic_ns(),
                        offset=ssd_slot * self.block_bytes,
                        length=self.block_bytes,
                        args={"tier": "ssd", "block": blk.idx})
        for m in debits:
            self._debit(m)

    def _heal_spill(self, blk: _Block, ssd_slot: int, view):
        """Re-assemble the block from each extent's mirror leg into
        *view*, verify, and write the healed bytes back to the corrupt
        primary members.  Returns the primary members healed over (for
        health debits), or None when unhealable (no mirror, or the mirror
        leg is corrupt too)."""
        spill = self._spill
        if getattr(spill, "mirror_of", None) is None:
            return None
        base = ssd_slot * self.block_bytes
        try:
            spans = spill.extents(base, self.block_bytes)
        except Exception:  # noqa: BLE001 - unhealable, said by None
            return None
        for ext in spans:
            mirror = spill.mirror_of(ext.member)
            if mirror is None:
                return None
            off = ext.logical_off - base
            try:
                spill.read_member_buffered(
                    mirror, ext.file_off, view[off:off + ext.length])
            except Exception:  # noqa: BLE001
                return None
        if not _integrity.verify(view, blk.crc):
            return None  # both legs rotted: the data is gone
        debits = []
        for ext in spans:
            try:
                spill.write_member_buffered(
                    ext.member, ext.file_off,
                    view[ext.logical_off - base:
                         ext.logical_off - base + ext.length])
                debits.append(ext.member)
            except Exception:  # noqa: BLE001 - the RAM copy is good anyway
                continue
        if self._durable:
            try:
                spill.sync()
            except Exception:  # noqa: BLE001
                pass
        return debits

    def _debit(self, member: int) -> None:
        """A scrub or page-in failure attributable to a spill member."""
        stats.member_error(member)
        try:
            self._session._member_health.record_failure(member)
        except Exception:  # noqa: BLE001 - session tearing down
            pass

    def scrub_spill(self, budget: int):
        """The scrubber's entry point: SSD-resident blocks against their
        page-out crcs, mismatches healed from the mirror leg.  Returns
        ``(bytes_scanned, member_debits)``; never raises."""
        with self._lock:
            if self._closed:
                return 0, []
            blocks = [b for t in self._tables.values() for b in t
                      if b.tier == "ssd" and b.crc is not None]
        scanned = 0
        debits: List[int] = []
        buf = memoryview(bytearray(self.block_bytes))
        for blk in blocks:
            if scanned >= budget:
                break
            with self._lock:
                if self._closed:
                    break
                if blk.tier != "ssd" or blk.crc is None:
                    continue
                ssd_slot = blk.slot
                t0 = time.monotonic_ns()
                try:
                    self._spill.read_buffered(
                        ssd_slot * self.block_bytes, buf)
                except Exception:  # noqa: BLE001
                    continue
                scanned += self.block_bytes
                stats.add("nr_scrub_extent")
                stats.add("bytes_scrubbed", self.block_bytes)
                ok = _integrity.verify(buf, blk.crc)
                if _trace.active:
                    _trace.span("scrub", t0, time.monotonic_ns(),
                                offset=ssd_slot * self.block_bytes,
                                length=self.block_bytes,
                                args={"tier": "ssd", "ok": ok})
                if ok:
                    continue
                t0 = time.monotonic_ns()
                healed = self._heal_spill(blk, ssd_slot, buf)
                if healed is None:
                    stats.add("nr_scrub_fail")
                    continue
                stats.add("nr_scrub_repair")
                if _trace.active:
                    _trace.span("repair", t0, time.monotonic_ns(),
                                offset=ssd_slot * self.block_bytes,
                                length=self.block_bytes,
                                args={"tier": "ssd", "block": blk.idx})
                debits.extend(healed)
        return scanned, debits

    def shed(self, nbytes: int, *, reason: str = "memlock") -> int:
        """Pressure relief: demote resident (HBM and RAM) blocks to the
        SSD, bulk sequences first, never raising — a full spill just
        bounds what can shed."""
        shed = 0
        with self._lock:
            if self._closed:
                return 0
            cands = [b for t in self._tables.values() for b in t
                     if b.tier != "ssd"]
            cands.sort(key=lambda b: _SHED_ORDER.get(
                self._classes.get(b.seq, "normal"), 1))
            for blk in cands:
                if shed >= nbytes:
                    break
                try:
                    if blk.tier == "hbm":
                        self._shed_hbm(blk)
                    else:
                        self._page_out(blk)
                except StromError:
                    break  # spill full / revoked: shed what we could
                shed += self.block_bytes
                stats.add("nr_pressure_shed")
                if _trace.active:
                    _trace.instant(
                        "pressure_shed", offset=blk.gid * self.block_bytes,
                        length=self.block_bytes,
                        args={"tier": "kv", "reason": reason,
                              "class": self._classes.get(blk.seq,
                                                         "normal")})
        return shed
