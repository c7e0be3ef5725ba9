"""Runtime knobs of the SSD→GPU path.

A reduced copy of the JAX package's GUC-style registry: only the knobs this
package reads, under the same names, defaults and bounds.  Values are set
at run time with :meth:`Config.set`; there is no file or environment tier.
A knob may answer to a second, older name (``cache_bytes`` for
``tier_ram_bytes``, ``hbm_cache_bytes`` for ``tier_hbm_bytes``): one stored
value, two names, as in the JAX package.
"""

from __future__ import annotations

import errno as _errno
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["ConfigError", "Config", "config", "parse_size"]


class ConfigError(ValueError):
    """A refused value: EINVAL, as the engine's own refusals."""

    errno = _errno.EINVAL


_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_size(s: str) -> int:
    """Parse '256k', '16m', '1g' or a plain integer (bytes)."""
    v = s.strip().lower()
    if v and v[-1] in _SUFFIX:
        return int(float(v[:-1]) * _SUFFIX[v[-1]])
    return int(v, 0)


def _pow2(val: int) -> None:
    if val & (val - 1):
        raise ConfigError(f"value {val} must be a power of two")


def _landing(val: str) -> None:
    if val not in ("auto", "direct", "staged"):
        raise ConfigError(f"landing must be auto|direct|staged, got {val!r}")


def _pushdown(val: str) -> None:
    if val not in ("auto", "on", "off"):
        raise ConfigError(f"pushdown must be auto|on|off, got {val!r}")


def _pushdown_codecs(val: str) -> None:
    bad = [c for c in val.split(",") if c.strip()
           and c.strip() not in ("bitpack", "dict", "rle")]
    if bad:
        raise ConfigError(f"pushdown_codecs must be a comma list of "
                          f"bitpack|dict|rle, got {bad[0]!r}")


def _ici_permute(val: str) -> None:
    if val not in ("auto", "cuda", "plain"):
        raise ConfigError(f"ici_permute must be auto|cuda|plain, got {val!r}")


def _io_backend(val: str) -> None:
    if val not in ("auto", "io_uring", "threadpool", "python"):
        raise ConfigError(f"io_backend must be auto|io_uring|threadpool|"
                          f"python, got {val!r}")


def _engine_backend(val: str) -> None:
    if val not in ("auto", "passthru", "uring", "threadpool"):
        raise ConfigError(f"engine_backend must be auto|passthru|uring|"
                          f"threadpool, got {val!r}")


def _numa_policy(val: str) -> None:
    if val in ("auto", "off"):
        return
    if val.startswith("node:"):
        try:
            if int(val[5:]) >= 0:
                return
        except ValueError:
            pass
    raise ConfigError(f"numa_policy must be auto|off|node:N, got {val!r}")


def _trace_policy(val: str) -> None:
    if val not in ("off", "sampled", "all"):
        raise ConfigError(f"trace_policy must be off|sampled|all, "
                          f"got {val!r}")


def _hedge_policy(val: str) -> None:
    if val not in ("off", "fixed", "p99"):
        raise ConfigError(f"hedge_policy must be off|fixed|p99, got {val!r}")


def _mirror(val: str) -> None:
    if val not in ("none", "paired"):
        raise ConfigError(f"mirror must be none|paired, got {val!r}")


def _qos_class(val: str) -> None:
    if val not in ("latency", "normal", "bulk"):
        raise ConfigError(f"qos_default_class must be latency|normal|bulk, "
                          f"got {val!r}")


def _integrity(val: str) -> None:
    if val not in ("off", "transitions", "always"):
        raise ConfigError(f"integrity must be off|transitions|always, "
                          f"got {val!r}")


def _buffer_multiple(val: int, cfg: "Config") -> None:
    chunk = cfg.get("chunk_size")
    if chunk and val % chunk:
        raise ConfigError(f"buffer_size {val} must be a multiple of "
                          f"chunk_size {chunk}")


def _coalesce_limit(val: int, cfg: "Config") -> None:
    # 0 = coalescing off; otherwise the merge window must cover at least
    # one dma_max_size request or planning could emit nothing mergeable
    if val and val < cfg.get("dma_max_size"):
        raise ConfigError(f"coalesce_limit {val} below dma_max_size "
                          f"{cfg.get('dma_max_size')} (set 0 to disable)")


@dataclass(frozen=True)
class _Var:
    default: Any
    kind: type
    minval: Optional[float] = None
    maxval: Optional[float] = None
    check: Optional[Callable[[Any], None]] = None
    #: validation against the other knobs' current values
    cross: Optional[Callable[[Any, "Config"], None]] = None
    #: another name of the knob *alias_of*: one stored value, two names
    alias_of: Optional[str] = None

    def parse(self, name: str, raw: Any) -> Any:
        if self.kind is bool:
            if isinstance(raw, str):
                raw = raw.strip().lower() in ("1", "true", "on", "yes")
            return bool(raw)
        if self.kind is int and isinstance(raw, str):
            val = parse_size(raw)
        else:
            val = self.kind(raw)
        if self.minval is not None and val < self.minval:
            raise ConfigError(f"{name}={val} below minimum {self.minval}")
        if self.maxval is not None and val > self.maxval:
            raise ConfigError(f"{name}={val} above maximum {self.maxval}")
        if self.check is not None:
            self.check(val)
        return val


_VARS: Dict[str, _Var] = {
    # -- the planner (the pgsql extension's GUCs, :1561-1635) -----------
    # the direct-load scan path on/off (off: every scan reads buffered)
    "enabled": _Var(True, bool),
    # the staging pool the direct-scan threshold counts as
    # shared_buffers: (RAM - buffer_size) * 2/3 + buffer_size
    "buffer_size": _Var(1 << 30, int, 1 << 20, cross=_buffer_multiple),
    # the direct path's cost a page, a fraction of the buffered path's
    "seq_page_cost": _Var(0.25, float, 0.0),
    # plan the direct path whatever the table's size (a test hook)
    "debug_no_threshold": _Var(False, bool),
    # strict eligibility: CHECK_FILE reports UNSUPPORTED, and the planner
    # never plans direct, unless the file sits on raw NVMe or
    # md-RAID-0 of NVMe with 64-bit DMA (the reference's hard
    # requirement, kmod/nvme_strom.c:229-438)
    "require_nvme_backing": _Var(False, bool),
    # scan chunk size and staging batch (default 16MB)
    "chunk_size": _Var(16 << 20, int, 1 << 16, 1 << 30, _pow2),
    # in-flight DMA tasks per scan ring
    "async_depth": _Var(8, int, 1, 1024),
    # ceiling of the adaptive H2D pipeline depth of a scan
    "h2d_depth_max": _Var(4, int, 1, 64),
    # staged spans a streamed checkpoint restore lands between two fences
    # (one CUDA event covers this many in-place copies)
    "scan_dispatch_batch": _Var(4, int, 1, 64),
    # pinned host staging buffers of the SSD->device pipeline
    "staging_buffers": _Var(3, int, 2, 16),
    # seconds a device fence may block before the backend is declared
    # lost (0 = unbounded)
    "backend_fence_timeout": _Var(60.0, float, 0.0),
    # mlock DMA buffers so the kernel cannot migrate pages mid-I/O
    "pin_memory": _Var(False, bool),
    # largest merged read request
    "dma_max_size": _Var(1 << 20, int, 4 << 10, 16 << 20, _pow2),
    # destination landing: auto | direct (CPU only) | staged
    "landing": _Var("auto", str, check=_landing),
    # packed-sidecar (.cpk) scans of aggregates: auto | on | off
    "pushdown": _Var("auto", str, check=_pushdown),
    # codecs the packed-extent encoder may choose (raw is always there)
    "pushdown_codecs": _Var("bitpack,dict,rle", str,
                            check=_pushdown_codecs),
    # least codec ratio (logical / packed bytes) for on-device expansion
    "pushdown_chip_ratio": _Var(1.15, float, 1.0),
    # planner's host->device and SSD read rates in GB/s (0 = measured)
    "pushdown_h2d_gbps": _Var(0.0, float, 0.0),
    "pushdown_ssd_gbps": _Var(0.0, float, 0.0),
    # host count the multi-host sharded loader plans ownership for
    # (member % shard_hosts); 0 = one host unless a call passes hosts
    "shard_hosts": _Var(0, int, 0, 4096),
    # largest on-disk join build table loaded whole (one projection scan)
    # when partitioning it; above it the build streams in one
    # hash-predicate scan a partition (host RAM bounded to a partition)
    "join_build_host_max": _Var(256 << 20, int, 1 << 12),
    # largest build side (keys + values bytes) a join broadcasts; above it
    # the planner switches to the partitioned (Grace) hash join
    "join_broadcast_max": _Var(64 << 20, int, 1 << 10),
    # ring permute transport: auto (from the members' device type) |
    # cuda (the hand-written kernel) | plain (PyTorch copies)
    "ici_permute": _Var("auto", str, check=_ici_permute),
    # -- the I/O engine ------------------------------------------------
    # executor of planned requests: auto (the native engine's io_uring,
    # then its threadpool) | io_uring | threadpool | python (the thread
    # pool of blocking preads in engine.py)
    "io_backend": _Var("auto", str, check=_io_backend),
    # rung of the native engine's ladder when io_backend is auto:
    # auto (NVMe passthrough, then io_uring, then threadpool) | passthru
    # (the raw NVMe rung demanded: a refusal is counted and, under
    # io_fallback, the ladder goes on below it) | uring | threadpool
    # (no passthrough probe, no passthrough counter: the plain ladder)
    "engine_backend": _Var("auto", str, check=_engine_backend),
    # NVMe character device the passthrough rung probes: the first match
    # of this glob (env NSTPU_PASSTHRU_DEV names one exactly)
    "passthru_dev_glob": _Var("/dev/ng*n*", str),
    # step down the ladder (io_uring -> native threadpool -> python pool)
    # when an engine cannot be created or a native submit fails, and
    # degrade a read to the buffered leg once its retries are spent; off
    # raises (latches) instead
    "io_fallback": _Var(True, bool),
    # io_uring submission queue depth / outstanding requests
    "queue_depth": _Var(32, int, 1, 4096),
    # engine lanes (queue pairs), member % lanes; 0 = one lane, scaled
    # out to one a stripe member (at most 16) at the first striped submit
    "engine_rings": _Var(0, int, 0, 16),
    # per-lane in-flight window after that scale-out; 0 = queue_depth
    "member_queue_depth": _Var(0, int, 0, 4096),
    # NUMA placement of the engine's lanes after that scale-out: auto
    # (each lane's threads on the CPUs of its member device's node; an
    # unknown node leaves it floating) | node:N (every lane on node N) |
    # off (affinity never touched)
    "numa_policy": _Var("auto", str, check=_numa_policy),
    # NUMA nodes a DmaBufferPool carves its per-node freelists on, as a
    # bitmask (-1 = every node with memory)
    "numa_node_mask": _Var(-1, int),
    # chunks planned and submitted per slice of a multi-chunk read
    "submit_window": _Var(16, int, 1, 256),
    # largest coalesced native read: file-contiguous requests of one member
    # merge beyond dma_max_size up to this; 0 = no coalescing
    "coalesce_limit": _Var(8 << 20, int, 0, 256 << 20,
                           cross=_coalesce_limit),
    # adapt the coalesced cap between dma_max_size and coalesce_limit from
    # observed per-request service latency; off pins it at coalesce_limit
    "chunk_adaptive": _Var(True, bool),
    # -- page-cache arbitration (kmod/nvme_strom.c:1639-1663) ----------
    # probe each read's chunks with mincore(2) and send hot, dirty or
    # cached chunks through the write-back (page-cache copy) leg; a
    # filesystem whose probe cannot see an eviction keeps every chunk
    # direct (engine.Session._arbitrate)
    "cache_arbitration": _Var(True, bool),
    # cached-page fraction above which a chunk takes the write-back leg
    "cache_threshold": _Var(0.5, float, 0.0, 1.0),
    # -- the fault ladder ----------------------------------------------
    # re-attempts of a direct read or write after a TRANSIENT error
    # before the read degrades to its mirror or the buffered leg
    "io_retries": _Var(3, int, 0, 64),
    # exponential backoff between retries: base, ceiling, jitter fraction
    "retry_backoff_ms": _Var(5.0, float, 0.0),
    "retry_backoff_max_ms": _Var(1000.0, float, 0.0),
    "retry_jitter": _Var(0.5, float, 0.0, 1.0),
    # per-task deadline: the watchdog latches ETIMEDOUT on a task running
    # past it and its unstarted requests cancel (0 = no deadline)
    "task_deadline_s": _Var(60.0, float, 0.0),
    # consecutive direct failures of one member before it is quarantined,
    # and the seconds it stays off the direct path
    "quarantine_after": _Var(8, int, 1, 1 << 20),
    "quarantine_s": _Var(30.0, float, 0.0),
    # a member whose p99 passes suspect_ratio x the stripe median p99 is
    # SUSPECT (still direct, hedge-eligible); it recovers at half
    "suspect_ratio": _Var(6.0, float, 1.0),
    # hedged reads on the python member pools: off | fixed (re-issue on
    # the mirror or the buffered leg after hedge_ms) | p99 (the member's
    # own p99, hedge_ms the floor); first completion wins
    "hedge_policy": _Var("off", str, check=_hedge_policy),
    "hedge_ms": _Var(20.0, float, 0.0, 60000.0),
    # default mirror map of a striped source: none (RAID-0) | paired
    # (member 2k+1 replicates member 2k, RAID-10)
    "mirror": _Var("none", str, check=_mirror),
    # period of the canary prober of FAILED and REJOINING members
    # (0 = no canaries)
    "canary_interval_s": _Var(1.0, float, 0.0),
    # warmup successes a REJOINING member needs before HEALTHY, and the
    # token rate of direct reads (and resync replays) it takes meanwhile
    # (0 = no throttle)
    "rejoin_successes": _Var(8, int, 1, 1 << 20),
    "rejoin_tokens_s": _Var(16.0, float, 0.0),
    # read each retired write leg back at wait time and compare crc32c
    # (EBADMSG on a mismatch)
    "write_verify": _Var(False, bool),
    # verify each landed heap page's crc32c (header word 7); a mismatch is
    # re-read up to checksum_retries times, then the task latches EBADMSG
    "checksum_verify": _Var(False, bool),
    "checksum_retries": _Var(2, int, 0, 16),
    # -- the residency tiers (the unified extent space, tiering.py) -----
    # capacity of the RAM tier (pinned-host ARC slabs, cache.py): hits are
    # copied out with no submission, misses fill at wait time after the
    # fault ladder healed them; 0 = off.  Read at Session construction
    "tier_ram_bytes": _Var(0, int, 0, 1 << 50),
    "cache_bytes": _Var(0, int, 0, 1 << 50, alias_of="tier_ram_bytes"),
    # capacity of the HBM tier (CUDA-tensor extents, serving/hbm_tier.py):
    # the RAM tier's second touch promotes an extent there; 0 = off
    "tier_hbm_bytes": _Var(0, int, 0, 1 << 50),
    "hbm_cache_bytes": _Var(0, int, 0, 1 << 50, alias_of="tier_hbm_bytes"),
    # one placement engine over HBM -> RAM -> SSD: promotion moves an
    # extent up exclusively and HBM victims demote into RAM; off = three
    # isolated tiers (no promotion, evictions drop)
    "tier_unified": _Var(True, bool),
    # the KV block pool's block (serving/kvcache.py): the unit of HBM
    # pinning, RAM slotting and SSD spill I/O, a power of two
    "tier_kv_block_bytes": _Var(64 << 10, int, 4 << 10, 16 << 20, _pow2),
    "kv_block_bytes": _Var(64 << 10, int, 4 << 10, 16 << 20,
                           alias_of="tier_kv_block_bytes"),
    # -- serving (serving/weights.py, serving/kvcache.py) ---------------
    # layers of a streamed checkpoint in flight at once during a cold start
    "weight_stream_depth": _Var(2, int, 1, 16),
    # KvBlockPool.migrate / shed_to_peer allowed (off: EOPNOTSUPP)
    "kv_migrate": _Var(True, bool),
    # QoS class of a KV sequence appended without one: latency | normal |
    # bulk (a pressure shed takes bulk first, latency last)
    "qos_default_class": _Var("normal", str, check=_qos_class),
    # -- the shared serving daemon (daemon/) ----------------------------
    # its Unix socket; empty = the per-uid default under the temp dir
    # (daemon.protocol.default_socket_path)
    "daemon_socket": _Var("", str),
    # attached sessions at most (0 = unlimited); more attaches get EAGAIN
    "daemon_max_sessions": _Var(64, int, 0),
    # dispatcher threads draining the QoS queue into the engine (0 = none
    # until start_dispatchers(), the deterministic-test idiom)
    "daemon_dispatch": _Var(2, int, 0, 64),
    # a tenant's in-flight tasks and bytes at most (0 = unlimited): a
    # submit past either is EAGAIN, never queued without bound
    "daemon_quota_tasks": _Var(0, int, 0),
    "daemon_quota_bytes": _Var(0, int, 0),
    # deficit-round-robin quantum: the bytes one round earns a weight-1.0
    # tenant (fairness holds within one quantum a tenant)
    "qos_quantum": _Var(256 << 10, int, 4 << 10),
    # DRR weight of a tenant that asks for none
    "qos_default_weight": _Var(1.0, float, 0.001),
    # a tenant's token-bucket rate in bytes/s (0 = unshaped) and burst
    "qos_rate": _Var(0, int, 0),
    "qos_burst": _Var(8 << 20, int, 64 << 10),
    # -- the integrity domain (integrity.py) ----------------------------
    # crc32c of resident extents: off (none stored) | transitions (stored
    # at fill, checked at promote and demote) | always (and at every
    # lease-served read); a mismatch fails open to the SSD.  Read at
    # Session construction
    "integrity": _Var("off", str, check=_integrity),
    # the background scrubber's rate (0 = off; needs integrity != off),
    # re-read every tick
    "scrub_bytes_per_sec": _Var(0, int, 0),
    # bytes the RAM tier may mlock (0 = no budget): fills past it pass
    # through to the SSD, a shrink sheds pinned slabs
    "memlock_budget": _Var(0, int, 0),
    # -- the self-driving data path (autotune.py) ----------------------
    # a Session's online controller: each epoch it reads the per-member
    # latency histograms and the delivered bytes and hill-climbs, inside
    # each knob's bounds here, the submit window (the python member pools'
    # width), the request cap and the hedge delay (and the native lane
    # count when the window grows), stepping back when p99 regresses and
    # freezing while a member is off HEALTHY.  Off: the static knobs and
    # the adaptive chunk sizer behave exactly as before, one branch a site
    "autotune": _Var(False, bool),
    # the controller's epoch: how often it samples and takes one step (also
    # the readahead predictor's issue cadence)
    "autotune_interval_ms": _Var(250.0, float, 10.0, 60000.0),
    # predictive readahead: a predictor a source watches demand reads
    # (stride and successor detection) and prefetches the next span into
    # the RAM tier through the fault ladder; needs tier_ram_bytes > 0.
    # Prefetched extents are tagged speculative, so the ARC's ghost lists
    # never learn from a guess
    "readahead": _Var(False, bool),
    # prefetch budget in MB/s (a token bucket): a prediction whose bytes
    # the bucket cannot pay is skipped (nr_readahead_skip), never queued,
    # so prefetch cannot starve demand reads (0 = predict, issue nothing)
    "readahead_budget_mb_s": _Var(64.0, float, 0.0, 65536.0),
    # -- aggregate accumulators ----------------------------------------
    # 64-bit accumulators for every aggregate (the JAX package's
    # jax_enable_x64): counts and 4-byte int sums widen to 8 bytes (uint32
    # sums to uint64 on the host) in the filter, join, star, expression,
    # packed and GROUP BY folds, every GROUP BY sum of squares is float64,
    # and a Python int literal meets a uint32 column in [-2^31, 2^32) and
    # a float32 one at any size.  Such a plan takes the torch route where
    # a schema holds a 4-byte int column (B1-B3 sum in 32 bits).  A schema
    # with an 8-byte column accumulates in 64 bits whatever this says
    # (ops.filter.wide_sums)
    "x64": _Var(False, bool),
    # torch-route / B3 time ratio of a float32 GROUP BY batch that
    # groupby_kernel_auto routes by: below 1.0 float aggregation takes
    # the torch route (0 = the card's measured ratio,
    # ops.groupby.GROUPBY_CUDA_RATIO)
    "groupby_cuda_ratio": _Var(0.0, float, 0.0),
    # -- the flight recorder -------------------------------------------
    # per-task span tracing: off (one attribute test a site) | sampled
    # (1 task in round(1 / trace_sample_rate)) | all; read when a Session
    # is built (trace.recorder.configure())
    "trace_policy": _Var("off", str, check=_trace_policy),
    "trace_sample_rate": _Var(0.01, float, 0.0, 1.0),
    # events a thread's ring holds; the oldest are overwritten
    "trace_ring_events": _Var(8192, int, 256, 1 << 20),
    # directory of trace dumps; empty = the temporary directory
    "trace_dir": _Var("", str),
}


class Config:
    """Thread-safe knob store."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values = {k: v.default for k, v in _VARS.items()
                        if v.alias_of is None}

    def get(self, name: str) -> Any:
        var = _VARS.get(name)
        if var is None:
            raise ConfigError(f"unknown config var {name}")
        with self._lock:
            return self._values[var.alias_of or name]

    def set(self, name: str, raw: Any) -> None:
        var = _VARS.get(name)
        if var is None:
            raise ConfigError(f"unknown config var {name}")
        if var.alias_of is not None:
            name, var = var.alias_of, _VARS[var.alias_of]
        val = var.parse(name, raw)
        if var.cross is not None:
            var.cross(val, self)
        with self._lock:
            self._values[name] = val

    def bounds(self, name: str) -> Tuple[Optional[float], Optional[float]]:
        """A knob's declared ``(minval, maxval)`` (None where unbounded):
        the bounds a controller may move it within."""
        var = _VARS.get(name)
        if var is None:
            raise ConfigError(f"unknown config var {name}")
        if var.alias_of is not None:
            var = _VARS[var.alias_of]
        return var.minval, var.maxval

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._values)

    def restore(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            self._values = dict(snap)


#: process-wide store
config = Config()
