"""Process-wide counters of the SSD→GPU path, and their export.

A dictionary of integers under one lock, every name of
:data:`.api.STAT_FIELDS` starting at 0 (the JAX package's names for the
same events, then the port's own).  With config ``stat_info`` off,
:meth:`Stats.add`, :meth:`~Stats.count_clock`,
:meth:`~Stats.observe_latency`, :meth:`~Stats.member_add`,
:meth:`~Stats.member_error` and :meth:`~Stats.shard_wait` count nothing:

* ``nr_ioctl_memcpy_submit`` / ``nr_setup_prps`` (and their ``clk_``
  pairs) — ``Session.memcpy_ssd2ram`` / ``memcpy_ram2ssd`` calls, from
  entry to return, and the request builds of their planning windows;
* ``nr_debug3`` / ``clk_debug3`` — the staging pipeline's H2D landings
  and the host time each took to queue;
* ``nr_ssd2dev`` — memcpy tasks that completed (one per engine command);
* ``nr_submit_dma`` / ``total_dma_length`` — read requests issued and
  their bytes (the native engine's own counts fold in through
  :meth:`Stats.merge_native` when a session's ``stat_info`` or ``close``
  runs, and before each export), ``nr_enter_dma`` its ``io_uring_enter``
  calls, ``nr_debug1`` / ``nr_debug2`` / ``nr_debug4`` its continuations,
  full-queue stalls and requests that rode a fixed buffer (the
  reference's spare debug pairs);
* ``nr_ioctl_memcpy_wait`` / ``clk_ioctl_memcpy_wait`` — tasks reaped by
  ``Session.memcpy_wait`` and the time spent waiting for them;
* ``nr_write_dma`` / ``total_write_length`` — write requests and bytes;
* ``nr_backend_fallback`` — steps down the engine ladder (io_uring →
  native threadpool → python pool) and native submits that failed over;
* ``nr_kernel_dispatch`` — filter calls the scan pipeline made;
* ``h2d_depth_reached`` — gauge: deepest H2D pipeline any load or scan
  reached;
* ``nr_shard_load`` / ``bytes_shard_load`` — per-host reads of the
  multi-host sharded loader and their bytes;
* ``nr_ici_permute`` / ``bytes_ici`` — ring steps of the on-device shard
  redistribution and all-gather, and the bytes they moved;
* ``nr_shard_wait`` / ``clk_shard_wait`` — per-shard submit→completion
  waits of the sharded batch stream, with one log2-ns histogram per shard
  (:meth:`Stats.shard_snapshot`);
* the fault ladder: ``nr_io_retry`` (direct attempts repeated after a
  transient error; ``nr_write_retry`` the writes among them),
  ``nr_io_fallback`` (reads degraded to the buffered leg),
  ``nr_task_timeout`` (tasks the watchdog latched ETIMEDOUT),
  ``nr_chunk_cancelled`` (requests skipped because their task had failed),
  ``nr_member_quarantine`` / ``nr_member_failed`` / ``nr_member_rejoin``
  (health transitions), ``nr_canary_probe``, ``nr_hedge_issued`` /
  ``nr_hedge_won`` / ``nr_hedge_cancelled`` and ``bytes_hedge_dup``,
  ``nr_mirror_read`` / ``nr_mirror_write`` (extents served from, or
  written to, a pair partner), ``nr_resync_extent`` and the gauge
  ``resync_pending_bytes`` (the dirty-extent journal),
  ``nr_write_verify_fail`` and ``bytes_verify_reread`` (``write_verify``);
* ``nr_arb_blind`` — read tasks whose page-cache arbitration was skipped
  because the filesystem's residency probe cannot see an eviction;
* checksum verify on read: ``nr_csum_fail`` (page checksum mismatches),
  ``nr_csum_reread`` (pages re-read to heal one) and
  ``bytes_verify_reread``;
* the residency tiers (:data:`.api.RESIDENCY_COUNTERS`): ``nr_cache_hit``
  / ``nr_hbm_hit`` (chunks served from the RAM / HBM tier),
  ``bytes_cache_hit``, ``nr_cache_miss``, ``nr_cache_fill``,
  ``nr_cache_evict``, ``nr_cache_invalidate``, ``nr_cache_mlock_fail``,
  ``nr_hbm_promote`` / ``nr_hbm_demote``, the unified space's
  ``nr_tier_hbm_promote``, ``nr_tier_hbm_demote``, ``nr_tier_ram_fault``,
  ``nr_tier_ram_demote`` and ``nr_tier_ram_shed``, the integrity domain's
  ``nr_integrity_verify`` / ``nr_integrity_fail``, the scrubber's
  ``nr_scrub_extent``, ``bytes_scrubbed``, ``nr_scrub_repair`` and
  ``nr_scrub_fail``, memlock pressure's ``nr_pressure_shed`` and
  ``nr_pressure_passthrough``, and the gauges ``cache_resident_bytes``,
  ``cache_unpinned_bytes`` and ``hbm_resident_bytes``
  (:meth:`Stats.gauge_set`).

* the landing route of each pipeline command: ``nr_landing_direct`` /
  ``nr_landing_staged``, ``nr_landing_fallback`` and its reason
  (``nr_landing_fallback_alignment`` / ``_dtype`` / ``_backend``), and
  ``bytes_staging_copy`` (bytes the staged ring copied a second time);
* the self-driving data path (:mod:`.autotune`): ``nr_autotune_step``,
  ``nr_autotune_revert`` and ``nr_autotune_freeze`` (controller
  decisions), ``nr_readahead_fill`` / ``nr_readahead_skip`` (prefetches
  issued, predictions the budget skipped), ``bytes_readahead`` and
  ``nr_readahead_hit`` (demand hits on prefetched extents, counted by the
  RAM tier);
* serving (:data:`.api.SERVING_COUNTERS`): the KV block pool's
  ``nr_kv_pagein`` / ``nr_kv_pageout`` (blocks paged SSD -> RAM and
  spilled RAM -> SSD), ``nr_kv_migrate`` / ``nr_kv_migrate_fail`` (chains
  moved to a peer pool, migrations rolled back), and the gauge
  ``coldstart_bytes_per_sec`` (the last weight stream's landing rate);
* the NVMe passthrough lane (:data:`.api.PASSTHRU_COUNTERS`):
  ``nr_passthru_dma`` / ``bytes_passthru`` (raw READ commands served, bytes
  split onto the lane), ``nr_passthru_refused_extent`` (spans the blockmap
  refused, read O_DIRECT), ``nr_passthru_fallback`` (resolved extents
  served off the lane), ``nr_passthru_refusal_<reason>`` (why a ladder
  that held the rung fell past it), ``nr_passthru_member_<reason>`` (a
  member's block device the rung's namespace does not hold: ``otherdev``,
  ``stacked``, ``nosysfs``), ``nr_blockmap_resolve`` /
  ``nr_blockmap_invalidate`` (FIEMAP walks, cached maps a write dropped).

The export: a thread publishes :meth:`Stats.export_payload` every 0.5 s
to a JSON file that ``tools/gpu_stat.py`` reads from another process (the
reference's ``/proc/nvme-strom`` read by ``nvme_stat``).  Every Session
starts one on the per-pid file (:func:`pid_export_path`, under
``STROM_STAT_EXPORT_DIR``, default ``/dev/shm``) unless
``STROM_STAT_EXPORT=0``; the tools publish to :data:`DEFAULT_STAT_EXPORT`
(``STROM_TPU_STAT_EXPORT``).  The files are ``strom_gpu_stat.<pid>.json``
and ``strom_gpu_stat.<uid>.json``: the JAX package's prefix is
``strom_stat.``, so both packages' registries in one process keep apart.

Beside the counters: the resolved engine backend (:meth:`Stats.backend`),
a log2-ns request-latency histogram (``LAT_HIST_BUCKETS`` buckets, fed by
the python pool and the native engine's deltas), and per-member request,
latency, queue-occupancy and fault accounting (errors, retries,
quarantines, the health state and its age, and the autotune controller's
knobs: :meth:`Stats.member_snapshot`).
The phases' wall times are flight-recorder spans (:mod:`.trace`), not
counters.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .api import STAT_FIELDS
from .config import config

__all__ = ["Stats", "stats", "hist_percentiles", "bytes_touched_ratio",
           "LAT_HIST_BUCKETS", "DEFAULT_STAT_EXPORT", "STAT_EXPORT_DIR",
           "pid_export_path", "list_exports"]

LAT_HIST_BUCKETS = 64


def hist_percentiles(hist, qs=(0.50, 0.95, 0.99)):
    """Percentile estimates (ns) from a log2 histogram, one per q in *qs*:
    each bucket's mass sits at its geometric midpoint (1.5 * 2^b); None
    per q when the histogram is empty."""
    total = sum(hist)
    out = []
    for q in qs:
        val = None
        if total > 0:
            acc = 0
            for b, n in enumerate(hist):
                acc += n
                if acc >= q * total and n:
                    val = (1 << b) + ((1 << b) >> 1)
                    break
        out.append(val)
    return out


def bytes_touched_ratio(counters: dict) -> Optional[float]:
    """Bytes touched per byte delivered: ``(payload + staging copies +
    verify re-reads + hedge duplicates) / payload``; None until any payload
    was delivered."""
    delivered = counters.get("total_dma_length", 0)
    if delivered <= 0:
        return None
    touched = (delivered + counters.get("bytes_staging_copy", 0)
               + counters.get("bytes_verify_reread", 0)
               + counters.get("bytes_hedge_dup", 0))
    return touched / delivered


def _bucket(ns: int) -> int:
    return min(max(int(ns), 1).bit_length() - 1, LAT_HIST_BUCKETS - 1)


#: gauges: combined at snapshot time, never summed from an engine's deltas
_GAUGES = ("cur_dma_count", "max_dma_count")

#: the well-known file a tool publishes to
DEFAULT_STAT_EXPORT = os.environ.get(
    "STROM_TPU_STAT_EXPORT",
    os.path.join(tempfile.gettempdir(),
                 f"strom_gpu_stat.{os.getuid()}.json"))

#: the directory of the per-pid files every Session publishes
STAT_EXPORT_DIR = os.environ.get(
    "STROM_STAT_EXPORT_DIR",
    "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir())

_PID_FILE = re.compile(r"strom_gpu_stat\.(\d+)\.json")


def pid_export_path(pid: Optional[int] = None) -> str:
    return os.path.join(STAT_EXPORT_DIR,
                        f"strom_gpu_stat.{pid or os.getpid()}.json")


def list_exports() -> List[Tuple[int, str, bool]]:
    """The per-pid export files: ``[(pid, path, alive)]``, *alive* while
    ``/proc/<pid>`` exists (a killed process leaves its file behind)."""
    try:
        names = os.listdir(STAT_EXPORT_DIR)
    except OSError:
        return []
    out = []
    for name in sorted(names):
        m = _PID_FILE.fullmatch(name)
        path = os.path.join(STAT_EXPORT_DIR, name)
        if m is None or path == DEFAULT_STAT_EXPORT:
            continue
        pid = int(m.group(1))
        out.append((pid, path, os.path.exists(f"/proc/{pid}")))
    return out


class Stats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: Dict[str, int] = dict.fromkeys(STAT_FIELDS, 0)
        self._shard_hist: Dict[int, List[int]] = {}
        self._hist = [0] * LAT_HIST_BUCKETS
        # member -> [nreq, bytes, ns]; latency histograms; [integral, busy]
        self._members: Dict[int, List[int]] = {}
        self._member_hist: Dict[int, List[int]] = {}
        self._member_occ: Dict[int, List[int]] = {}
        # member -> [errors, retries, quarantines entered, quarantined now]
        self._member_health: Dict[int, list] = {}
        # member -> (health state name, monotonic entry time)
        self._member_state: Dict[int, tuple] = {}
        # member -> the autotune controller's applied knobs
        self._member_knobs: Dict[int, dict] = {}
        # tenant -> its QoS configuration and delivery (the daemon's)
        self._tenants: Dict[str, dict] = {}
        self._occ_last_ns = 0
        self._backend = ""
        # the exporter: (thread, stop event, path)
        self._exporter: Optional[tuple] = None
        self._cleanup_registered = False
        #: what :meth:`export` runs before each publish: the engine sets
        #: its fold of every live Session's native counters here
        self.export_fold: Optional[Callable[[], None]] = None
        #: publishes written, and writes that failed
        self.exports = 0
        self.export_errors = 0

    @staticmethod
    def enabled() -> bool:
        """Config ``stat_info``, read without the config's lock (these
        sites run once a request)."""
        return config.peek("stat_info")

    def add(self, name: str, delta: int = 1) -> None:
        if not self.enabled():
            return
        with self._lock:
            self._c[name] = self._c.get(name, 0) + delta

    def gauge_set(self, name: str, value: int) -> None:
        with self._lock:
            self._c[name] = int(value)

    def gauge_max(self, name: str, value: int) -> None:
        with self._lock:
            if value > self._c.get(name, 0):
                self._c[name] = value

    def gauge_add(self, name: str, delta: int) -> int:
        """Move a gauge; ``cur_dma_count`` also integrates its occupancy
        (``occ_integral_ns`` / ``occ_busy_ns``: the mean in-flight depth
        while busy is their ratio)."""
        with self._lock:
            if name == "cur_dma_count":
                now = time.monotonic_ns()
                cur = self._c.get(name, 0)
                if self._occ_last_ns and cur > 0:
                    dt = now - self._occ_last_ns
                    self._c["occ_integral_ns"] = \
                        self._c.get("occ_integral_ns", 0) + cur * dt
                    self._c["occ_busy_ns"] = \
                        self._c.get("occ_busy_ns", 0) + dt
                self._occ_last_ns = now
            self._c[name] = self._c.get(name, 0) + delta
            return self._c[name]

    def count_clock(self, name: str, ns: int, n: int = 1) -> None:
        """One ``nr_<name>`` / ``clk_<name>`` pair: *n* events, *ns*
        nanoseconds spent in them."""
        if not self.enabled():
            return
        with self._lock:
            self._c["nr_" + name] = self._c.get("nr_" + name, 0) + n
            self._c["clk_" + name] = self._c.get("clk_" + name, 0) + int(ns)

    def set_backend(self, name: str) -> None:
        """Record the engine rung the newest session landed on
        (``io_uring`` | ``threadpool`` | ``python``)."""
        with self._lock:
            self._backend = str(name)

    def backend(self) -> str:
        with self._lock:
            return self._backend

    def merge_native(self, native_counters: Dict[str, int]) -> None:
        """Fold a native engine's monotonic counter delta; its gauges are
        left out (callers combine them at snapshot time)."""
        with self._lock:
            for k, v in native_counters.items():
                if k not in _GAUGES:
                    self._c[k] = self._c.get(k, 0) + v

    def observe_latency(self, ns: int, n: int = 1) -> None:
        """*n* request completions of service time *ns* into the log2
        latency histogram."""
        if not self.enabled():
            return
        with self._lock:
            self._hist[_bucket(ns)] += n

    def merge_native_hist(self, deltas: Sequence[int]) -> None:
        with self._lock:
            for i, v in enumerate(deltas[:LAT_HIST_BUCKETS]):
                self._hist[i] += v

    def lat_hist_snapshot(self) -> List[int]:
        with self._lock:
            return list(self._hist)

    def member_add(self, member: int, nbytes: int, ns: int,
                   n: int = 1) -> None:
        """Account requests against a stripe member (the reference's
        per-disk ``part_stat_add``)."""
        if not self.enabled():
            return
        with self._lock:
            m = self._members.setdefault(member, [0, 0, 0])
            m[0] += n
            m[1] += nbytes
            m[2] += ns

    def merge_member_hist(self, member: int, deltas: Sequence[int]) -> None:
        with self._lock:
            h = self._member_hist.setdefault(member, [0] * LAT_HIST_BUCKETS)
            for i, v in enumerate(deltas[:LAT_HIST_BUCKETS]):
                h[i] += v

    def member_hist_snapshot(self) -> Dict[int, List[int]]:
        """``{member: [LAT_HIST_BUCKETS counts]}``, a copy of the
        per-member latency histograms (the autotune controller reads their
        epoch deltas)."""
        with self._lock:
            return {m: list(h) for m, h in self._member_hist.items()}

    def member_knobs(self, member: int, *, window=None, cap=None,
                     hedge_ms=None, step=None, freeze=None) -> None:
        """Publish the autotune controller's applied knobs of *member*
        (``knob_window``, ``knob_cap``, ``knob_hedge_ms``, ``knob_step``,
        ``knob_freeze`` in its :meth:`member_snapshot` row); None leaves a
        field as it was."""
        with self._lock:
            d = self._member_knobs.setdefault(member, {})
            for k, v in (("knob_window", window), ("knob_cap", cap),
                         ("knob_hedge_ms", hedge_ms), ("knob_step", step),
                         ("knob_freeze", freeze)):
                if v is not None:
                    d[k] = v

    def member_occ_add(self, member: int, integral_ns: int,
                       busy_ns: int) -> None:
        with self._lock:
            o = self._member_occ.setdefault(member, [0, 0])
            o[0] += integral_ns
            o[1] += busy_ns

    def member_error(self, member: int, *, retried: bool = False) -> None:
        """Account one failed direct leg of *member* (and the retry it
        took), the per-disk error half of the reference's part_stat."""
        if not self.enabled():
            return
        with self._lock:
            h = self._member_health.setdefault(member, [0, 0, 0, False])
            h[0] += 1
            if retried:
                h[1] += 1

    def member_quarantine(self, member: int, active: bool) -> None:
        """A quarantine transition: entry counts ``nr_member_quarantine``
        and the member's ``quarantines``; exit clears the live flag."""
        with self._lock:
            h = self._member_health.setdefault(member, [0, 0, 0, False])
            if active and not h[3]:
                h[2] += 1
                self._c["nr_member_quarantine"] = \
                    self._c.get("nr_member_quarantine", 0) + 1
            h[3] = active

    def member_state(self, member: int, state: str) -> None:
        """A health transition: the state's name and its entry time."""
        with self._lock:
            self._member_state[member] = (state, time.monotonic())

    def member_snapshot(self) -> Dict[int, dict]:
        """``{member: {"nreq", "bytes", "clk_ns"[, "p50_ns", "p95_ns",
        "occ_integral_ns", "occ_busy_ns", "errors", "retries",
        "quarantines", "quarantined", "state", "state_s", "knob_window",
        "knob_cap", "knob_hedge_ms", "knob_step", "knob_freeze"]}}``."""
        with self._lock:
            out = {k: {"nreq": v[0], "bytes": v[1], "clk_ns": v[2]}
                   for k, v in sorted(self._members.items())}
            hists = {k: list(h) for k, h in self._member_hist.items()}
            occ = {k: list(o) for k, o in self._member_occ.items()}
            health = {k: list(h) for k, h in self._member_health.items()}
            states = dict(self._member_state)
            knobs = {k: dict(v) for k, v in self._member_knobs.items()}
        now = time.monotonic()
        for k, h in health.items():
            d = out.setdefault(k, {"nreq": 0, "bytes": 0, "clk_ns": 0})
            d.update(errors=h[0], retries=h[1], quarantines=h[2],
                     quarantined=bool(h[3]))
        for k, (st, since) in states.items():
            d = out.setdefault(k, {"nreq": 0, "bytes": 0, "clk_ns": 0})
            d["state"] = st
            d["state_s"] = round(now - since, 3)
        for k, h in hists.items():
            d = out.setdefault(k, {"nreq": 0, "bytes": 0, "clk_ns": 0})
            p50, p95, _ = hist_percentiles(h)
            if p50 is not None:
                d["p50_ns"] = p50
            if p95 is not None:
                d["p95_ns"] = p95
        for k, o in occ.items():
            d = out.setdefault(k, {"nreq": 0, "bytes": 0, "clk_ns": 0})
            d["occ_integral_ns"], d["occ_busy_ns"] = o
        for k, kn in knobs.items():
            out.setdefault(k, {"nreq": 0, "bytes": 0, "clk_ns": 0}).update(kn)
        return out

    def shard_wait(self, shard: int, ns: int) -> None:
        """Account one shard's submit→completion wait: the ``nr_/
        clk_shard_wait`` pair and the shard's own log2-ns histogram, so a
        straggling shard is not smeared into the aggregate."""
        if not self.enabled():
            return
        b = _bucket(ns)
        with self._lock:
            self._c["nr_shard_wait"] = self._c.get("nr_shard_wait", 0) + 1
            self._c["clk_shard_wait"] = self._c.get("clk_shard_wait", 0) + ns
            h = self._shard_hist.setdefault(int(shard),
                                            [0] * LAT_HIST_BUCKETS)
            h[b] += 1

    def shard_snapshot(self) -> Dict[int, dict]:
        """``{shard: {"n", "p50_ns", "p95_ns"}}`` from the per-shard wait
        histograms (percentile keys only when the histogram has mass)."""
        with self._lock:
            hists = {k: list(h) for k, h in sorted(self._shard_hist.items())}
        out = {}
        for k, h in hists.items():
            d = {"n": sum(h)}
            p50, p95, _ = hist_percentiles(h)
            if p50 is not None:
                d["p50_ns"] = p50
            if p95 is not None:
                d["p95_ns"] = p95
            out[k] = d
        return out

    def _tenant(self, tenant: str) -> dict:
        # caller holds self._lock
        return self._tenants.setdefault(tenant, {
            "class": "normal", "weight": 1.0, "rate": 0.0,
            "quota_tasks": 0, "quota_bytes": 0,
            "tasks": 0, "bytes": 0, "rejects": 0, "throttles": 0,
            "inflight_tasks": 0, "inflight_bytes": 0,
            "wait_hist": [0] * LAT_HIST_BUCKETS,
        })

    def tenant_configure(self, tenant: str, *, qos_class: str = None,
                         weight: float = None, rate: float = None,
                         quota_tasks: int = None,
                         quota_bytes: int = None) -> None:
        """Record a tenant's QoS configuration (the attach or configure
        echo), so the scoreboard shows policy beside delivery; None keeps
        the field."""
        with self._lock:
            t = self._tenant(tenant)
            if qos_class is not None:
                t["class"] = qos_class
            if weight is not None:
                t["weight"] = float(weight)
            if rate is not None:
                t["rate"] = float(rate)
            if quota_tasks is not None:
                t["quota_tasks"] = int(quota_tasks)
            if quota_bytes is not None:
                t["quota_bytes"] = int(quota_bytes)

    def tenant_inflight(self, tenant: str, dtasks: int, dbytes: int) -> None:
        """Move a tenant's in-flight gauges (admission +, finalize -)."""
        with self._lock:
            t = self._tenant(tenant)
            t["inflight_tasks"] += dtasks
            t["inflight_bytes"] += dbytes

    def tenant_task(self, tenant: str, nbytes: int, wait_ns: int) -> None:
        """One delivered task: its bytes, and its queue wait into the
        tenant's log2-ns histogram (p50/p95 by :func:`hist_percentiles`)."""
        with self._lock:
            t = self._tenant(tenant)
            t["tasks"] += 1
            t["bytes"] += nbytes
            t["wait_hist"][_bucket(wait_ns)] += 1

    def tenant_reject(self, tenant: str) -> None:
        with self._lock:
            self._tenant(tenant)["rejects"] += 1

    def tenant_throttle(self, tenant: str) -> None:
        with self._lock:
            self._tenant(tenant)["throttles"] += 1

    def tenant_snapshot(self) -> Dict[str, dict]:
        """``{tenant: {class, weight, rate, quota_tasks, quota_bytes,
        tasks, bytes, rejects, throttles, inflight_tasks, inflight_bytes,
        wait_hist}}``, copied so callers can diff intervals."""
        with self._lock:
            return {k: dict(v, wait_hist=list(v["wait_hist"]))
                    for k, v in sorted(self._tenants.items())}

    def snapshot(self, *, debug: bool = False,
                 reset_max: bool = False) -> Dict[str, int]:
        """The counters, a copy; the ``*debug*`` pairs only with *debug*.
        *reset_max* sets ``max_dma_count`` back to ``cur_dma_count`` after
        the read, as the reference's STAT_INFO does (kmod/nvme_strom.c:
        2087); only the exporter passes it, so every reader sees the
        same high-water mark of an export interval."""
        with self._lock:
            counters = dict(self._c)
            if reset_max:
                self._c["max_dma_count"] = self._c["cur_dma_count"]
        if not debug:
            counters = {k: v for k, v in counters.items()
                        if "debug" not in k}
        return counters

    def export_payload(self, *, reset_max: bool = False) -> dict:
        """One snapshot in the shape of the JAX package's per-process
        export (what ``gpu_stat`` and :func:`..trace.render_prometheus`
        read), the debug pairs included."""
        return {"timestamp_ns": time.monotonic_ns(), "pid": os.getpid(),
                "version": 1,
                "counters": self.snapshot(debug=True, reset_max=reset_max),
                "backend": self.backend(),
                "members": self.member_snapshot(),
                "lat_hist": self.lat_hist_snapshot(),
                "tenants": self.tenant_snapshot(),
                "shards": self.shard_snapshot()}

    # -- the export ---------------------------------------------------------
    def default_export_start(self) -> None:
        """A Session's hook: publish to :func:`pid_export_path` unless
        ``STROM_STAT_EXPORT`` is ``0``/``off``/``false`` (idempotent); the
        file goes at a clean exit, and a killed process leaves it for
        ``gpu_stat -l`` to flag stale."""
        if os.environ.get("STROM_STAT_EXPORT", "1").lower() \
                in ("0", "off", "false"):
            return
        path = pid_export_path()
        self.start_export(path)
        with self._lock:
            if self._cleanup_registered:
                return
            self._cleanup_registered = True

        def cleanup() -> None:
            self.stop_export()
            try:
                os.unlink(path)
            except OSError:
                pass

        import atexit
        atexit.register(cleanup)

    def start_export(self, path: Optional[str] = None,
                     interval: float = 0.5) -> None:
        """Start the exporter thread on *path* (default
        :data:`DEFAULT_STAT_EXPORT`); a second start while one runs does
        nothing."""
        path = path or DEFAULT_STAT_EXPORT
        stop = threading.Event()

        def loop() -> None:
            while not stop.wait(interval):
                self.export(path)

        t = threading.Thread(target=loop, daemon=True,
                             name="strom-stat-export")
        with self._lock:
            if self._exporter is not None:
                return
            self._exporter = (t, stop, path)
        t.start()

    def stop_export(self) -> None:
        """Stop the exporter, then write one last snapshot on this thread:
        the file's final content is a postcondition of the call."""
        with self._lock:
            exp, self._exporter = self._exporter, None
        if exp is not None:
            t, stop, path = exp
            stop.set()
            t.join(timeout=5.0)    # outside the lock: export() takes it
            self.export(path)

    def export(self, path: Optional[str] = None) -> None:
        """Publish one snapshot to *path*: a private ``mkstemp`` file
        renamed over it, so a reader never sees half a file.  The export
        is the one reader that resets ``max_dma_count``.  A publish is
        counted in :attr:`exports`, a failed write in :attr:`export_errors`,
        never raised."""
        path = path or DEFAULT_STAT_EXPORT
        fold = self.export_fold
        if fold is not None:
            try:
                fold()
            except Exception:   # noqa: BLE001 - a publish must not die
                pass
        payload = self.export_payload(reset_max=True)
        try:
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                       prefix=os.path.basename(path) + ".")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, path)
            except BaseException:
                os.unlink(tmp)
                raise
        except OSError:
            self.export_errors += 1
        else:
            self.exports += 1

    def reset(self) -> None:
        """Every counter back to 0 (each :data:`.api.STAT_FIELDS` name
        stays), the histograms and tables emptied."""
        with self._lock:
            self._c = dict.fromkeys(STAT_FIELDS, 0)
            self._shard_hist.clear()
            self._hist = [0] * LAT_HIST_BUCKETS
            self._members.clear()
            self._member_hist.clear()
            self._member_occ.clear()
            self._member_health.clear()
            self._member_state.clear()
            self._member_knobs.clear()
            self._tenants.clear()
            self._occ_last_ns = 0


#: process-wide counters
stats = Stats()
