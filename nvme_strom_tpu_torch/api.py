"""Command and result types of the SSD→GPU path.

The reference's ioctl ABI (`kmod/nvme_strom.h:17-171`) survives as plain
dataclasses: an error type carrying an errno, the CHECK_FILE verdict, the
INFO geometry of a registered buffer, and the out-fields of a memcpy
command.  Only the fields the load-then-scan path fills are kept.
"""

from __future__ import annotations

import enum
import errno as _errno
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["StromError", "ErrorClass", "FsKind", "FileInfo", "BufferInfo",
           "MemCopyResult", "RESIDENCY_COUNTERS", "PASSTHRU_COUNTERS",
           "SERVING_COUNTERS", "STAT_FIELDS", "StatInfo"]


#: counters of checksum verify on read, the residency tiers and the
#: integrity domain, under the JAX package's ``STAT_FIELDS`` names
RESIDENCY_COUNTERS = (
    "nr_csum_fail",           # page checksum mismatches observed
    "nr_csum_reread",         # pages re-read to heal a mismatch
    "bytes_verify_reread",    # bytes of those re-reads
    "nr_cache_hit",           # chunks served from the RAM tier
    "nr_cache_miss",          # chunks that went to the engine instead
    "nr_cache_fill",          # extents installed into RAM slabs
    "nr_cache_evict",         # extents ARC-evicted to make room
    "nr_cache_invalidate",    # extents dropped by a write or a save
    "bytes_cache_hit",        # bytes served from either tier
    "cache_resident_bytes",   # gauge: RAM-tier bytes resident
    "nr_hbm_hit",             # chunks served from HBM extents
    "nr_hbm_promote",         # extents placed in the HBM tier
    "nr_hbm_demote",          # extents evicted out of the HBM tier
    "hbm_resident_bytes",     # gauge: HBM-tier bytes resident
    "nr_integrity_verify",    # resident checksums verified
    "nr_integrity_fail",      # resident checksum mismatches
    "nr_scrub_extent",        # extents the scrubber walked
    "bytes_scrubbed",         # bytes the scrubber verified
    "nr_scrub_repair",        # corrupt extents refilled from the SSD
    "nr_scrub_fail",          # corrupt extents that could not be refilled
    "nr_cache_mlock_fail",    # mlock(2) refusals: the slab runs unpinned
    "cache_unpinned_bytes",   # gauge: resident bytes not mlocked
    "nr_pressure_shed",       # slabs shed under the memlock budget
    "nr_pressure_passthrough",  # fills refused under it (read from SSD)
    "nr_tier_hbm_promote",    # second-touch promotions RAM -> HBM
    "nr_tier_hbm_demote",     # HBM victims demoted into RAM
    "nr_tier_ram_fault",      # demand faults filled SSD -> RAM
    "nr_tier_ram_demote",     # RAM victims dropped to the SSD tier
    "nr_tier_ram_shed",       # RAM residents shed under memlock pressure
)


#: counters of serving (weight streaming and the KV block pool), under the
#: JAX package's ``STAT_FIELDS`` names
SERVING_COUNTERS = (
    "nr_kv_pagein",           # KV blocks paged SSD -> RAM
    "nr_kv_pageout",          # KV blocks spilled RAM -> SSD (write ladder)
    "nr_kv_migrate",          # KV chains migrated to a peer pool
    "nr_kv_migrate_fail",     # migrations rolled back (a peer append failed)
    "coldstart_bytes_per_sec",  # gauge: the last weight stream's rate
)


#: counters of the NVMe passthrough lane and the blockmap, under the JAX
#: package's ``STAT_FIELDS`` names, and the port's own per-member
#: namespace refusals (``nr_passthru_member_<reason>``)
PASSTHRU_COUNTERS = (
    "nr_passthru_dma",        # requests served as raw NVMe READ commands
    "bytes_passthru",         # bytes routed onto the passthrough lane
    "nr_passthru_refused_extent",  # spans refused per extent (hole,
    #                           ineligible flags, unaligned, no path)
    "nr_passthru_fallback",   # resolved extents served off the lane
    #                           (ladder rung, hedge win, create failure)
    "nr_passthru_refusal_disabled",   # rung refused: NSTPU_DISABLE_PASSTHRU
    "nr_passthru_refusal_nodev",      # rung refused: no NVMe char device
    "nr_passthru_refusal_nouring",    # rung refused: io_uring unavailable
    "nr_passthru_refusal_nouringcmd",  # rung refused: no URING_CMD opcode
    "nr_passthru_refusal_lbafmt",     # rung refused: unusable LBA format
    "nr_passthru_member_otherdev",    # a block device off the rung's
    #                                   namespace (another drive or ns)
    "nr_passthru_member_stacked",     # a dm/md device over the drive
    "nr_passthru_member_nosysfs",     # sysfs could not place the file
    "nr_blockmap_resolve",    # real FIEMAP walks (cache misses)
    "nr_blockmap_invalidate",  # cached file->LBA maps dropped by writes
)


class ErrorClass(enum.Enum):
    """What the fault ladder does with an error: TRANSIENT retries (then a
    read degrades to its mirror or the buffered leg), CORRUPTION is
    re-read then latched EBADMSG, TIMEOUT is the watchdog's latch, and
    PERSISTENT fails fast with no retry."""

    TRANSIENT = "transient"
    PERSISTENT = "persistent"
    CORRUPTION = "corruption"
    TIMEOUT = "timeout"


_TRANSIENT_ERRNOS = frozenset((_errno.EIO, _errno.EAGAIN, _errno.EBUSY,
                               _errno.EINTR, _errno.ENOMEM))
_CORRUPTION_ERRNOS = frozenset((_errno.EBADMSG, _errno.EILSEQ))


def classify_errno(errno_: int) -> ErrorClass:
    """The default class of an errno: ETIMEDOUT timeout, EBADMSG/EILSEQ
    corruption, EIO/EAGAIN/EBUSY/EINTR/ENOMEM transient, every other
    (ENOSPC, EROFS, EBADF, ...) persistent."""
    if errno_ == _errno.ETIMEDOUT:
        return ErrorClass.TIMEOUT
    if errno_ in _CORRUPTION_ERRNOS:
        return ErrorClass.CORRUPTION
    if errno_ in _TRANSIENT_ERRNOS:
        return ErrorClass.TRANSIENT
    return ErrorClass.PERSISTENT


class StromError(OSError):
    """Engine error carrying an errno-style code (the reference returns
    ``-errno`` from every ioctl) and the recovery class the fault ladder
    reads: :func:`classify_errno` of the errno unless the raiser pins
    one."""

    def __init__(self, errno_: int, msg: str,
                 error_class: Optional[ErrorClass] = None):
        super().__init__(errno_, msg)
        self.error_class = error_class or classify_errno(errno_)

    @property
    def transient(self) -> bool:
        return self.error_class is ErrorClass.TRANSIENT


class FsKind(enum.IntEnum):
    """Filesystem classification from :func:`..engine.check_file`."""

    UNSUPPORTED = 0
    EXT4 = 1
    XFS = 2
    OTHER_DIRECT = 3   # O_DIRECT probe succeeded on some other fs


@dataclass(frozen=True)
class FileInfo:
    """Result of CHECK_FILE (reference ``ioctl_check_file``,
    kmod/nvme_strom.c:188-583)."""

    path: str
    file_size: int
    fs_kind: FsKind
    logical_block_size: int      # the backing's sector size (:274-295)
    dma_max_size: int            # merged-request cap, clamped (:297-314)
    numa_node_id: int = -1       # (:316-328); -1 unknown or spans nodes
    support_dma64: bool = False  # from the device chain (:330-336)
    n_members: int = 1           # RAID-0 member count (1 = plain file)
    stripe_chunk_size: int = 0   # RAID-0 chunk in bytes (0 = plain)
    backing_kind: str = ""       # "nvme" | "md-raid0" | "md" (failed
                                 # RAID-0 validation) | "other" | "none"
    backing_supported: bool = False  # raw NVMe or RAID-0 of NVMe verified
    backing_reason: str = ""     # why not, for tools and the planner
    policy_rejected: bool = False    # strict eligibility said no (policy,
                                     # apart from the fs_kind fact)

    @property
    def supported(self) -> bool:
        return self.fs_kind != FsKind.UNSUPPORTED and not self.policy_rejected

    @property
    def strict_eligible(self) -> bool:
        """The strict-eligibility predicate: a verified NVMe backing with
        64-bit DMA (the reference's hard gate, kmod/nvme_strom.c:229-438
        and pgsql/nvme_strom.c:313-318).  ``check_file``'s
        ``policy_rejected`` and the planner's gate both derive from it."""
        return self.backing_supported and self.support_dma64


@dataclass(frozen=True)
class BufferInfo:
    """Geometry of one registered buffer (INFO_GPU_MEMORY analog)."""

    handle: int
    length: int
    page_size: int
    n_pages: int
    owner_uid: int
    refcount: int
    kind: str            # 'hbm' | 'pinned_host' | 'user'
    device: Optional[str] = None


@dataclass
class MemCopyResult:
    """Out-fields of MEMCPY_SSD2GPU/RAM (reference kmod/nvme_strom.h:85-117).

    ``chunk_ids[i]`` names the chunk resident at destination slot *i*: the
    ``nr_ssd2dev`` chunks read by direct I/O first, then the
    ``nr_ram2dev`` chunks page-cache arbitration sent through the
    write-back (buffered) leg, each group in the caller's order.  With
    arbitration off (config ``cache_arbitration``) every chunk is direct
    and the order is the caller's."""

    dma_task_id: int
    nr_chunks: int
    nr_ssd2dev: int
    nr_ram2dev: int
    chunk_ids: List[int]
    landing: str = ""    # "direct" | "staged" for pipeline commands

    def __post_init__(self) -> None:
        if self.nr_ssd2dev + self.nr_ram2dev != self.nr_chunks:
            raise ValueError(f"chunk conservation violated: "
                             f"{self.nr_ssd2dev}+{self.nr_ram2dev}"
                             f"!={self.nr_chunks}")


#: every counter and gauge the registry starts at 0 (:mod:`.stats`): the
#: JAX package's ``STAT_FIELDS`` (count + clock pairs a stage, after the
#: reference's 26 counters, kmod/nvme_strom.c:83-106; monotonic ns), in
#: its order, then the port's own
STAT_FIELDS: Tuple[str, ...] = (
    # the reference's stages and gauges
    "nr_ioctl_memcpy_submit", "clk_ioctl_memcpy_submit",
    "nr_ioctl_memcpy_wait", "clk_ioctl_memcpy_wait",
    "nr_ssd2dev", "clk_ssd2dev",
    "nr_setup_prps", "clk_setup_prps",      # the request build
    "nr_submit_dma", "clk_submit_dma",
    "nr_wait_dtask", "clk_wait_dtask",
    "nr_wrong_wakeup", "total_dma_length", "cur_dma_count", "max_dma_count",
    "nr_enter_dma", "h2d_depth_reached", "nr_kernel_dispatch",
    # the fault ladder
    "nr_io_retry", "nr_io_fallback", "nr_backend_fallback",
    "nr_task_timeout", "nr_chunk_cancelled", "nr_csum_fail",
    "nr_csum_reread", "nr_member_quarantine", "nr_member_failed",
    "nr_member_rejoin", "nr_canary_probe", "nr_hedge_issued",
    "nr_hedge_won", "nr_hedge_cancelled", "nr_mirror_read",
    # bytes touched beyond the payload
    "bytes_staging_copy", "bytes_verify_reread", "bytes_hedge_dup",
    # the landing route
    "nr_landing_direct", "nr_landing_staged", "nr_landing_fallback",
    "nr_landing_fallback_alignment", "nr_landing_fallback_dtype",
    "nr_landing_fallback_backend",
    # queue occupancy: the mean depth while busy is integral / busy
    "occ_integral_ns", "occ_busy_ns",
    # the RAM tier
    "nr_cache_hit", "nr_cache_miss", "nr_cache_fill", "nr_cache_evict",
    "nr_cache_invalidate", "bytes_cache_hit", "cache_resident_bytes",
    # the write ladder
    "nr_mirror_write", "nr_write_retry", "nr_resync_extent",
    "nr_write_verify_fail", "resync_pending_bytes",
    # the shared serving daemon
    "nr_session_attach", "nr_session_detach", "nr_session_reap",
    "nr_admission_reject", "nr_qos_wait", "clk_qos_wait", "nr_qos_throttle",
    "daemon_sessions", "qos_queue_depth",
    # packed pushdown
    "nr_pushdown_decode_chip", "nr_pushdown_decode_host", "bytes_wire_saved",
    # serving and the HBM tier
    "nr_hbm_hit", "nr_hbm_promote", "nr_hbm_demote", "nr_kv_pagein",
    "nr_kv_pageout", "hbm_resident_bytes", "coldstart_bytes_per_sec",
    # the integrity domain and memlock pressure
    "nr_integrity_verify", "nr_integrity_fail", "nr_scrub_extent",
    "bytes_scrubbed", "nr_scrub_repair", "nr_scrub_fail",
    "nr_cache_mlock_fail", "cache_unpinned_bytes", "nr_pressure_shed",
    "nr_pressure_passthrough",
    # several hosts
    "nr_shard_load", "bytes_shard_load", "nr_ici_permute", "bytes_ici",
    "nr_shard_wait", "clk_shard_wait", "nr_kv_migrate", "nr_kv_migrate_fail",
    # autotune and readahead
    "nr_autotune_step", "nr_autotune_revert", "nr_autotune_freeze",
    "nr_readahead_fill", "nr_readahead_hit", "nr_readahead_skip",
    "bytes_readahead",
    # NVMe passthrough and the blockmap
    "nr_passthru_dma", "bytes_passthru", "nr_passthru_refused_extent",
    "nr_passthru_fallback", "nr_passthru_refusal_disabled",
    "nr_passthru_refusal_nodev", "nr_passthru_refusal_nouring",
    "nr_passthru_refusal_nouringcmd", "nr_passthru_refusal_lbafmt",
    "nr_blockmap_resolve", "nr_blockmap_invalidate",
    # the unified extent space
    "nr_tier_hbm_promote", "nr_tier_hbm_demote", "nr_tier_ram_fault",
    "nr_tier_ram_demote", "nr_tier_ram_shed",
    # the spare debug pairs: 1 the engine's continuations, 2 its
    # full-queue stalls, 3 the staging pipeline's H2D landings, 4 its
    # requests on fixed buffers
    "nr_debug1", "clk_debug1", "nr_debug2", "clk_debug2",
    "nr_debug3", "clk_debug3", "nr_debug4", "clk_debug4",
    # the port's own: write requests and bytes, read tasks whose
    # arbitration the residency probe could not see, and the members a
    # passthrough namespace does not hold, by reason
    "nr_write_dma", "total_write_length", "nr_arb_blind",
    "nr_passthru_member_otherdev", "nr_passthru_member_stacked",
    "nr_passthru_member_nosysfs",
)


@dataclass
class StatInfo:
    """One STAT_INFO snapshot (reference ``StromCmd__StatInfo``,
    kmod/nvme_strom.h:141-171), the JAX package's ``stats.snapshot()``
    type: the port's ``snapshot()`` returns the counters dict, and its
    export payload carries the same ``version``, ``timestamp_ns`` and
    ``counters`` keys."""

    version: int = 1
    has_debug: bool = False
    timestamp_ns: int = 0
    counters: dict = field(default_factory=dict)
