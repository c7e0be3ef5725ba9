"""Flight recorder and end-to-end task tracing.

The port's copy of the JAX package's ``trace.py``, whole.  Counters cannot
say *which stage* of one task ate the latency or what the engine did in
the seconds before a failure; this module adds the per-request layer:

* every DMA task gets a **trace id** at submit (``trace_policy=all``, or
  1 in N under ``sampled``; ``off`` costs one attribute read and branch
  per event site and records nothing);
* event sites record **span and instant events** (plan, per-extent
  service, the native engine's measured submit→complete windows, staging
  retire, landing, the multi-host phases, each kernel wrapper's launch)
  into bounded per-thread rings (the **flight recorder**: no lock on the
  hot path, oldest events overwritten, kept until dumped);
* dumps render as **Chrome trace-event JSON** (Perfetto-loadable: one
  track per member and lane, flow arrows from submit to landing) on
  demand and automatically on task failure, and the stats snapshot
  renders as a **Prometheus textfile**.

Timestamps are CLOCK_MONOTONIC nanoseconds end to end: the native
engine's rings use the same clock, so device windows interleave with
Python spans without skew correction.  Dumps go to config ``trace_dir``
(default: the temporary directory).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from .config import config

__all__ = ["FlightRecorder", "recorder", "trace_dir", "trace_dump_path",
           "list_dumps", "chrome_trace_from_events", "validate_chrome_trace",
           "render_prometheus", "summarize_chrome_trace"]

#: auto-dumps written on task failure are bounded per process so a
#: failure storm cannot fill the trace directory
MAX_FAILURE_DUMPS = 8

#: event tuple layout (internal ring schema):
#: (ts_ns, dur_ns|None, name, trace_id, member, lane, offset, length, args|None)
_TS, _DUR, _NAME, _TID, _MEMBER, _LANE, _OFF, _LEN, _ARGS = range(9)

#: the recorder's event-kind contract: every event name emitted anywhere
#: in the package, mapped to how it records — "span" (has a duration),
#: "instant" (a point), or "any" (legitimately emitted both ways).
#: stromlint's surface.trace-* rules enforce this map in both directions:
#: an emission missing here fails the lint, and an entry nothing emits is
#: stale.  Names ending in ``_begin``/``_end`` must pair.
EVENT_SCHEMA: Dict[str, str] = {
    # task pipeline spans
    "plan": "span",              # planner builds the request list
    "nvme": "span",              # one extent's device service window
    "extent": "span",            # python-pool extent service
    "wait": "span",              # caller's wait window
    "writeback": "span",         # write path device window
    "landing": "span",           # direct/staged H2D landing
    "staging_retire": "span",    # staging buffer retire/copy
    "cache_hit": "span",         # residency-tier memcpy service
    "cache_fill": "span",        # residency-tier slab fill
    "hedge_won": "span",         # hedge leg that delivered the extent
    # mirror reads are a span on the python pool path (service window)
    # and an instant on the native path (completion attribution)
    "mirror_read": "any",
    # mirror-coherent writes: the pool path emits the mirror
    # leg's service window as a span; the native path records fan-out at
    # submit as an instant
    "mirror_write": "any",
    "resync": "span",            # one dirty-extent replay (read+write)
    # point events
    "submit": "instant",         # task accepted
    "native_submit": "instant",  # handed to the native engine
    "task_failed": "instant",
    "task_timeout": "instant",
    "retry": "instant",
    "route_away": "instant",     # unhealthy member avoided at plan time
    "fallback_buffered": "instant",
    "hedge_issued": "instant",
    "hedge_cancelled": "instant",
    "csum_fail": "instant",
    "health": "instant",         # member health-machine transition
    "landing_fallback": "instant",
    "cache_evict": "instant",
    "cache_invalidate": "instant",
    "resync_skip": "instant",    # degraded write leg journaled for resync
    # shared serving daemon: stromd session lifecycle and the
    # QoS scheduler in front of the lanes
    "session_attach": "instant",   # client attached (tenant/class in args)
    "session_detach": "instant",   # clean detach released the session
    "session_reap": "instant",     # orphan reaped after client disconnect
    "admission_reject": "instant",  # submit bounced by per-tenant quota
    "qos_enqueue": "instant",      # task admitted into the QoS queue
    "qos_throttle": "instant",     # tenant token-bucket-gated (edge)
    "qos_wait": "span",            # enqueue -> scheduler-dispatch window
    # compute pushdown: one span per packed scan — the whole
    # decode->filter->project window over the compressed representation
    # (wire/logical byte counts ride in args)
    "pushdown_decode": "span",
    # LLM serving: cold-start weight streaming and KV-cache
    # paging over the HBM residency tier
    "weight_stream": "span",   # one layer span: submit -> crc -> adopt
    "kv_page": "span",         # one KV block crossing a tier boundary
    # resident-data integrity domain
    "scrub": "span",           # one resident extent verified (tier in args)
    "repair": "span",          # corrupt resident healed (SSD/mirror re-fill)
    "pressure_shed": "instant",  # resident shed under memlock/HBM pressure
    # multi-host scale-out
    "shard_load": "span",      # one host's local owned-chunk read window
    "ici_permute": "span",     # on-fabric ring redistribution/gather window
    "shard_wait": "span",      # one shard's submit->completion fan-in wait
    "kv_migrate": "span",      # one KV chain's cross-host migration
    # self-driving data path
    "autotune_step": "instant",  # one controller decision (step/revert/
    #                              freeze; knob + per-member values in args)
    "readahead_fill": "span",  # one speculative fill: predict -> resident
    # raw NVMe passthrough
    "passthru_refuse": "instant",    # span refused per-extent at plan time
    "passthru_fallback": "instant",  # resolved extent left the lane, or
    #                                  the whole rung was refused (reason
    #                                  in args)
    # unified extent address space: migration engine edges
    "tier_promote": "instant",   # extent moved up one tier (tier in args)
    "tier_demote": "instant",    # extent moved down one tier (tier in args)
    "tier_fault": "instant",     # demand fault filled the RAM tier
    # the port's own: host time of each CUDA kernel wrapper's launch (not
    # device time), so a trace separates wrapper time from fences and
    # copies
    "b1_filter": "span",
    "b2_decode": "span",
    "b3_groupby": "span",
    "b4_permute": "span",
}


def trace_dir() -> str:
    """Directory flight-recorder dumps land in: config ``trace_dir``, else
    the temporary directory."""
    return str(config.get("trace_dir")) or tempfile.gettempdir()


def trace_dump_path(seq: int, pid: int = None) -> str:
    return os.path.join(trace_dir(),
                        f"strom_trace.{pid or os.getpid()}.{seq}.json")


def list_dumps(directory: str = None) -> List[str]:
    """Flight-recorder dump files, oldest first (mtime order)."""
    d = directory or trace_dir()
    try:
        names = [n for n in os.listdir(d)
                 if n.startswith("strom_trace.") and n.endswith(".json")]
    except OSError:
        return []
    paths = [os.path.join(d, n) for n in names]
    paths.sort(key=lambda p: (os.path.getmtime(p) if os.path.exists(p) else 0, p))
    return paths


class _Ring:
    """Bounded single-writer event ring: the owning thread appends with no
    lock (CPython list ops are atomic enough for a torn-read-free snapshot
    via ``list()``); readers copy-and-sort at dump time."""

    __slots__ = ("buf", "cap", "w", "dropped", "thread_name")

    def __init__(self, cap: int, thread_name: str):
        self.buf: List[tuple] = []
        self.cap = max(16, int(cap))
        self.w = 0
        self.dropped = 0
        self.thread_name = thread_name

    def append(self, ev: tuple) -> None:
        buf = self.buf
        if len(buf) < self.cap:
            buf.append(ev)
        else:
            buf[self.w] = ev
            self.w = (self.w + 1) % self.cap
            self.dropped += 1

    def snapshot(self) -> List[tuple]:
        return list(self.buf)


class FlightRecorder:
    """Process-global trace-event sink.

    Hot-path contract: when ``trace_policy=off`` every instrumented site
    costs exactly one attribute read + branch (``if recorder.active``);
    no allocation, no lock, no counter.  When on, events go to the
    calling thread's own bounded ring — the only lock is taken once per
    thread (ring registration) and at dump/clear time.
    """

    def __init__(self) -> None:
        self.active = False
        self.policy = "off"
        self.capacity = 8192
        self._sample_n = 100
        self._lock = threading.Lock()
        self._rings: Dict[int, _Ring] = {}
        self._tls = threading.local()
        # task_id -> trace_id for live traced tasks, bounded (staging and
        # the waiters look trace ids up by task id)
        self._traced: "OrderedDict[int, int]" = OrderedDict()
        self._traced_cap = 4096
        self._next_trace = 0
        self._task_seq = 0
        self._dump_seq = 0
        self._failure_dumps = 0

    # -- configuration ------------------------------------------------------
    def configure(self) -> None:
        """Re-read the trace config (Session construction, tools, tests).

        Reading config per event would defeat the one-branch-when-off
        contract, so activation is explicit: set ``trace_policy`` *before*
        building the Session (or call this after changing it)."""
        policy = config.get("trace_policy")
        rate = float(config.get("trace_sample_rate"))
        self.capacity = int(config.get("trace_ring_events"))
        self._sample_n = max(1, int(round(1.0 / rate))) if rate > 0 else 0
        self.policy = policy
        self.active = policy != "off"

    # -- per-thread rings ---------------------------------------------------
    def _ring(self) -> _Ring:
        r = getattr(self._tls, "ring", None)
        if r is None or r.cap != max(16, self.capacity):
            t = threading.current_thread()
            r = _Ring(self.capacity, t.name)
            self._tls.ring = r
            with self._lock:
                self._rings[id(r)] = r
        return r

    # -- task lifecycle -----------------------------------------------------
    def task_begin(self, task_id: int) -> int:
        """Sampling decision at submit: returns a nonzero trace id when
        this task is traced, 0 otherwise."""
        with self._lock:
            self._task_seq += 1
            if self.policy == "sampled":
                if not self._sample_n or (self._task_seq - 1) % self._sample_n:
                    return 0
            elif self.policy != "all":
                return 0
            self._next_trace += 1
            tid = self._next_trace
            self._traced[task_id] = tid
            while len(self._traced) > self._traced_cap:
                self._traced.popitem(last=False)
        return tid

    def traced_id(self, task_id: int) -> int:
        """Trace id of a live traced task (0 = untraced/unknown)."""
        return self._traced.get(task_id, 0)

    def task_end(self, task_id: int) -> None:
        with self._lock:
            self._traced.pop(task_id, None)

    # -- event sites --------------------------------------------------------
    def instant(self, name: str, *, tid: int = 0, member: int = -1,
                lane: int = -1, offset: int = -1, length: int = 0,
                args: Optional[dict] = None, ts_ns: Optional[int] = None) -> None:
        self._ring().append((ts_ns if ts_ns is not None
                             else time.monotonic_ns(),
                             None, name, tid, member, lane, offset, length,
                             args))

    def span(self, name: str, t0_ns: int, t1_ns: int, *, tid: int = 0,
             member: int = -1, lane: int = -1, offset: int = -1,
             length: int = 0, args: Optional[dict] = None) -> None:
        self._ring().append((t0_ns, max(0, t1_ns - t0_ns), name, tid,
                             member, lane, offset, length, args))

    def native_event(self, submit_ns: int, complete_ns: int, *, member: int,
                     lane: int, offset: int, length: int,
                     result: int = 0) -> None:
        """One device-window event from the engine's per-lane ring: the
        measured native submit→complete interval for a request."""
        args = {"result": result} if result else None
        self.span("nvme", submit_ns, complete_ns, member=member, lane=lane,
                  offset=offset, length=length, args=args)

    # -- dumping ------------------------------------------------------------
    def snapshot_events(self) -> List[tuple]:
        """Merged, time-sorted copy of every thread's ring."""
        with self._lock:
            rings = list(self._rings.values())
        evs: List[tuple] = []
        for r in rings:
            evs.extend(r.snapshot())
        evs.sort(key=lambda e: e[_TS])
        return evs

    def dropped_events(self) -> int:
        with self._lock:
            return sum(r.dropped for r in self._rings.values())

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._traced.clear()
        self._tls = threading.local()

    def chrome_trace(self, reason: str = "manual") -> dict:
        return chrome_trace_from_events(self.snapshot_events(), reason=reason,
                                        dropped=self.dropped_events())

    def dump(self, path: Optional[str] = None, *, reason: str = "manual") -> str:
        """Write the flight recorder as Chrome trace-event JSON; returns
        the path.  Atomic (tempfile + replace), same discipline as the
        stats exporter."""
        doc = self.chrome_trace(reason=reason)
        if path is None:
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            path = trace_dump_path(seq)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   prefix=os.path.basename(path) + ".")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def dump_on_failure(self, reason: str) -> Optional[str]:
        """Bounded automatic dump when a task latches its first error —
        the flight-recorder moment: the ring holds what the engine did
        just before the failure."""
        if not self.active:
            return None
        with self._lock:
            if self._failure_dumps >= MAX_FAILURE_DUMPS:
                return None
            self._failure_dumps += 1
        try:
            return self.dump(reason=reason)
        except OSError:
            return None


#: process-global recorder (event sites and tools share it, like ``stats``)
recorder = FlightRecorder()


# -- Chrome trace-event export ----------------------------------------------
#
# Track model: Perfetto renders one row ("thread") per (pid, tid).  Events
# carrying a member land on tid 100+member, lane-only events on 200+lane,
# everything else on the task track (tid 1).  Flow arrows connect each
# traced task's first event (submit) to its last span end (landing).

_TID_TASKS = 1
_TID_MEMBER0 = 100
_TID_LANE0 = 200


def _track_of(ev: tuple) -> Tuple[int, str]:
    if ev[_MEMBER] >= 0:
        return _TID_MEMBER0 + ev[_MEMBER], f"member {ev[_MEMBER]}"
    if ev[_LANE] >= 0:
        return _TID_LANE0 + ev[_LANE], f"lane {ev[_LANE]}"
    return _TID_TASKS, "tasks"


def chrome_trace_from_events(events: List[tuple], *, reason: str = "manual",
                             dropped: int = 0) -> dict:
    """Render internal ring events as a Chrome trace-event document."""
    pid = os.getpid()
    out: List[dict] = []
    tracks: Dict[int, str] = {}
    first_of: Dict[int, tuple] = {}
    last_of: Dict[int, tuple] = {}
    for ev in events:
        tid, tname = _track_of(ev)
        tracks.setdefault(tid, tname)
        args: Dict[str, Any] = {}
        if ev[_TID]:
            args["trace_id"] = ev[_TID]
        if ev[_MEMBER] >= 0:
            args["member"] = ev[_MEMBER]
        if ev[_LANE] >= 0:
            args["lane"] = ev[_LANE]
        if ev[_OFF] >= 0:
            args["offset"] = ev[_OFF]
        if ev[_LEN]:
            args["length"] = ev[_LEN]
        if ev[_ARGS]:
            args.update(ev[_ARGS])
        rec = {"name": ev[_NAME], "ph": "X" if ev[_DUR] is not None else "i",
               "ts": ev[_TS] / 1000.0, "pid": pid, "tid": tid, "args": args}
        if ev[_DUR] is not None:
            rec["dur"] = ev[_DUR] / 1000.0
        else:
            rec["s"] = "t"          # instant scope: thread
        out.append(rec)
        if ev[_TID]:
            if ev[_TID] not in first_of or ev[_TS] < first_of[ev[_TID]][_TS]:
                first_of[ev[_TID]] = ev
            end = ev[_TS] + (ev[_DUR] or 0)
            prev = last_of.get(ev[_TID])
            if prev is None or end >= prev[_TS] + (prev[_DUR] or 0):
                last_of[ev[_TID]] = ev
    # flow arrows: submit -> landing per traced task
    for tid_, first in first_of.items():
        last = last_of.get(tid_)
        if last is None or last is first:
            continue
        ftid, _ = _track_of(first)
        ltid, _ = _track_of(last)
        out.append({"name": "task", "cat": "task", "ph": "s", "id": tid_,
                    "ts": first[_TS] / 1000.0, "pid": pid, "tid": ftid})
        out.append({"name": "task", "cat": "task", "ph": "f", "bp": "e",
                    "id": tid_,
                    "ts": (last[_TS] + (last[_DUR] or 0)) / 1000.0,
                    "pid": pid, "tid": ltid})
    meta: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": "strom_tpu"}}]
    for tid_, tname in sorted(tracks.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid_, "args": {"name": tname}})
        meta.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                     "tid": tid_, "args": {"sort_index": tid_}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ns",
            "otherData": {"tool": "strom_tpu flight recorder",
                          "reason": reason, "dropped_events": dropped}}


_PHASES_REQUIRED_DUR = {"X"}
_PHASES_KNOWN = {"X", "i", "I", "B", "E", "M", "s", "t", "f", "C"}


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema-check a Chrome trace-event document; returns a list of
    problems (empty = loads in Perfetto).  This is the test gate behind
    the acceptance criterion, so it checks what the importers actually
    require: the JSON-object format with a ``traceEvents`` array, every
    event carrying name/ph/ts/pid/tid, ``dur`` on complete events, and
    flow events paired by id."""
    errs: List[str] = []
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        return ["document is not an object with a traceEvents array"]
    flows: Dict[Any, set] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES_KNOWN:
            errs.append(f"event {i}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"event {i}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errs.append(f"event {i}: missing integer {key}")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i}: missing ts")
        if ph in _PHASES_REQUIRED_DUR and not isinstance(
                ev.get("dur"), (int, float)):
            errs.append(f"event {i}: complete event without dur")
        if ph in ("s", "t", "f"):
            if "id" not in ev:
                errs.append(f"event {i}: flow event without id")
            else:
                flows.setdefault(ev["id"], set()).add(ph)
    for fid, phases in flows.items():
        if "f" in phases and "s" not in phases:
            errs.append(f"flow {fid}: finish without start")
    return errs


def summarize_chrome_trace(doc: dict) -> str:
    """Human summary of a dump: per-track span/instant counts and the
    traced-task flow count (the `strom_trace PATH` default view)."""
    events = doc.get("traceEvents", [])
    names: Dict[int, str] = {}
    per_track: Dict[int, List[int]] = {}
    cache_ops = {"cache_hit": 0, "cache_fill": 0, "cache_evict": 0,
                 "cache_invalidate": 0}
    t0 = t1 = None
    tasks = set()
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "thread_name":
                names[ev.get("tid")] = ev.get("args", {}).get("name", "?")
            continue
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            t0 = ts if t0 is None else min(t0, ts)
            te = ts + ev.get("dur", 0)
            t1 = te if t1 is None else max(t1, te)
        if ph == "s":
            tasks.add(ev.get("id"))
            continue
        if ph in ("f", "t"):
            continue
        nm = ev.get("name")
        if nm in cache_ops:
            cache_ops[nm] += 1
        row = per_track.setdefault(ev.get("tid", -1), [0, 0])
        row[0 if ph == "X" else 1] += 1
    lines = []
    span_ms = (t1 - t0) / 1000.0 if (t0 is not None and t1 is not None) else 0.0
    lines.append(f"{sum(a + b for a, b in per_track.values())} events, "
                 f"{len(tasks)} traced task(s), {span_ms:.3f} ms window")
    other = doc.get("otherData", {})
    if other.get("dropped_events"):
        lines.append(f"ring overwrote {other['dropped_events']} event(s)")
    if any(cache_ops.values()):
        lines.append("cache: " + "  ".join(
            f"{k.split('_', 1)[1]} {v}" for k, v in cache_ops.items()))
    for tid in sorted(per_track):
        spans, insts = per_track[tid]
        lines.append(f"  {names.get(tid, f'tid {tid}'):<12} "
                     f"{spans:6d} span(s) {insts:6d} instant(s)")
    return "\n".join(lines)


# -- Prometheus textfile exposition ------------------------------------------

def _prom_name(counter: str) -> str:
    return "strom_tpu_" + counter


_PROM_GAUGES = ("cur_dma_count", "max_dma_count", "h2d_depth_reached",
                "occ_integral_ns", "occ_busy_ns", "cache_resident_bytes",
                "resync_pending_bytes", "daemon_sessions",
                "qos_queue_depth", "hbm_resident_bytes",
                "coldstart_bytes_per_sec", "cache_unpinned_bytes")


def render_prometheus(payload: dict) -> str:
    """Render one stats payload (:meth:`..stats.Stats.export_payload`:
    counters + members + lat_hist) in Prometheus textfile
    exposition format — drop the output in a node_exporter textfile
    directory and the stats surface scrapes."""
    from .stats import LAT_HIST_BUCKETS, bytes_touched_ratio
    counters = payload.get("counters", {})
    members = payload.get("members", {})
    hist = payload.get("lat_hist") or []
    pid = payload.get("pid", 0)
    out: List[str] = []

    def emit(name, mtype, value, labels=""):
        out.append(f"# TYPE {name} {mtype}")
        out.append(f"{name}{labels} {value}")

    for k in sorted(counters):
        if "debug" in k or k.startswith("nr_landing_") \
                or k.startswith("nr_cache_") \
                or k.startswith("nr_integrity_") \
                or k.startswith("nr_scrub_") \
                or k.startswith("nr_pressure_") \
                or k.startswith("nr_autotune_") \
                or k.startswith("nr_readahead_") \
                or k.startswith("nr_tier_") \
                or k in ("nr_mirror_write", "nr_write_retry",
                         "nr_resync_extent", "nr_write_verify_fail",
                         "bytes_readahead"):
            continue    # landing/cache/write/integrity counters render
            #             as labeled series
        mtype = "gauge" if k in _PROM_GAUGES else "counter"
        emit(_prom_name(k if k in _PROM_GAUGES else k + "_total"),
             mtype, counters[k])
    # landing-path attribution: one series per path / per
    # fallback reason, so dashboards can plot direct-vs-staged routing
    # and what is blocking the zero-copy tier
    paths = [(p, counters.get(f"nr_landing_{p}", 0))
             for p in ("direct", "staged")]
    if any(v for _, v in paths):
        out.append("# TYPE strom_tpu_landing_total counter")
        for p, v in paths:
            out.append(f'strom_tpu_landing_total{{path="{p}"}} {v}')
    reasons = [(r, counters.get(f"nr_landing_fallback_{r}", 0))
               for r in ("alignment", "dtype", "backend")]
    if counters.get("nr_landing_fallback", 0) or any(v for _, v in reasons):
        out.append("# TYPE strom_tpu_landing_fallback_total counter")
        for r, v in reasons:
            out.append(
                f'strom_tpu_landing_fallback_total{{reason="{r}"}} {v}')
    # residency-tier attribution: one series per cache op, so
    # dashboards can plot hit ratio and churn against resident bytes
    ops = [(op, counters.get(f"nr_cache_{op}", 0))
           for op in ("hit", "miss", "fill", "evict", "invalidate",
                      "mlock_fail")]
    if any(v for _, v in ops):
        out.append("# TYPE strom_tpu_cache_ops_total counter")
        for op, v in ops:
            out.append(f'strom_tpu_cache_ops_total{{op="{op}"}} {v}')
    # resident-integrity attribution: verify/scrub/repair and
    # the pressure degradations as one labeled family, so dashboards can
    # plot detection vs healing vs capacity shed
    iops = [("verify", counters.get("nr_integrity_verify", 0)),
            ("fail", counters.get("nr_integrity_fail", 0)),
            ("scrub", counters.get("nr_scrub_extent", 0)),
            ("repair", counters.get("nr_scrub_repair", 0)),
            ("scrub_fail", counters.get("nr_scrub_fail", 0)),
            ("shed", counters.get("nr_pressure_shed", 0)),
            ("passthrough", counters.get("nr_pressure_passthrough", 0))]
    if any(v for _, v in iops):
        out.append("# TYPE strom_tpu_integrity_ops_total counter")
        for op, v in iops:
            out.append(f'strom_tpu_integrity_ops_total{{op="{op}"}} {v}')
    # write-ladder attribution: mirror fan-out, transient
    # retries, resync replays and read-back verification failures as one
    # labeled family, so dashboards can plot write-path degradation
    wops = [("mirror", counters.get("nr_mirror_write", 0)),
            ("retry", counters.get("nr_write_retry", 0)),
            ("resync", counters.get("nr_resync_extent", 0)),
            ("verify_fail", counters.get("nr_write_verify_fail", 0))]
    if any(v for _, v in wops):
        out.append("# TYPE strom_tpu_write_ops_total counter")
        for op, v in wops:
            out.append(f'strom_tpu_write_ops_total{{op="{op}"}} {v}')
    # self-driving data path: controller decisions and the
    # speculative-fill funnel as labeled families, so dashboards can
    # plot tuning activity and prefetch accuracy (hit/fill) vs waste
    aops = [(op, counters.get(f"nr_autotune_{op}", 0))
            for op in ("step", "revert", "freeze")]
    if any(v for _, v in aops):
        out.append("# TYPE strom_tpu_autotune_ops_total counter")
        for op, v in aops:
            out.append(f'strom_tpu_autotune_ops_total{{op="{op}"}} {v}')
    rops = [(op, counters.get(f"nr_readahead_{op}", 0))
            for op in ("fill", "hit", "skip")]
    if any(v for _, v in rops):
        out.append("# TYPE strom_tpu_readahead_ops_total counter")
        for op, v in rops:
            out.append(f'strom_tpu_readahead_ops_total{{op="{op}"}} {v}')
        emit("strom_tpu_readahead_bytes_total", "counter",
             counters.get("bytes_readahead", 0))
    # unified extent space: one {tier,op} family for the
    # placement/migration engine, so dashboards can plot promotion and
    # demotion churn per tier against the resident-bytes gauges
    tops = [(key, counters.get(f"nr_tier_{key}", 0))
            for key in ("hbm_promote", "hbm_demote", "ram_fault",
                        "ram_demote", "ram_shed")]
    if any(v for _, v in tops):
        out.append("# TYPE strom_tpu_tier_ops_total counter")
        for key, v in tops:
            tier, _, op = key.partition("_")
            out.append(
                f'strom_tpu_tier_ops_total{{tier="{tier}",op="{op}"}} {v}')
    ratio = bytes_touched_ratio(counters)
    if ratio is not None:
        emit("strom_tpu_bytes_touched_per_byte_delivered", "gauge",
             f"{ratio:.6f}")
    # per-member request accounting (labels, one series per member)
    for metric, key, mtype in (
            ("strom_tpu_member_requests_total", "nreq", "counter"),
            ("strom_tpu_member_bytes_total", "bytes", "counter"),
            ("strom_tpu_member_busy_ns_total", "clk_ns", "counter"),
            ("strom_tpu_member_errors_total", "errors", "counter"),
            ("strom_tpu_member_quarantines_total", "quarantines", "counter"),
            ("strom_tpu_member_knob_window", "knob_window", "gauge"),
            ("strom_tpu_member_knob_cap_bytes", "knob_cap", "gauge"),
            ("strom_tpu_member_knob_hedge_ms", "knob_hedge_ms", "gauge")):
        rows = [(m, d[key]) for m, d in sorted(members.items(),
                                               key=lambda kv: int(kv[0]))
                if key in d]
        if not rows:
            continue
        out.append(f"# TYPE {metric} {mtype}")
        for m, v in rows:
            out.append(f'{metric}{{member="{m}"}} {v}')
    states = [(m, d["state"]) for m, d in sorted(members.items(),
                                                 key=lambda kv: int(kv[0]))
              if "state" in d]
    if states:
        out.append("# TYPE strom_tpu_member_state gauge")
        for m, st in states:
            out.append(f'strom_tpu_member_state{{member="{m}",'
                       f'state="{st}"}} 1')
    # per-tenant QoS attribution: one series per tenant so
    # dashboards can plot delivered bandwidth, quota pressure and queue
    # wait per tenant of a shared stromd — mirrors the member family
    tenants = payload.get("tenants", {})
    for metric, key, mtype in (
            ("strom_tpu_tenant_tasks_total", "tasks", "counter"),
            ("strom_tpu_tenant_bytes_total", "bytes", "counter"),
            ("strom_tpu_tenant_rejects_total", "rejects", "counter"),
            ("strom_tpu_tenant_throttles_total", "throttles", "counter"),
            ("strom_tpu_tenant_inflight_tasks", "inflight_tasks", "gauge"),
            ("strom_tpu_tenant_inflight_bytes", "inflight_bytes", "gauge"),
            ("strom_tpu_tenant_weight", "weight", "gauge")):
        rows = [(t, d.get(key, 0)) for t, d in sorted(tenants.items())]
        if not any(v for _, v in rows):
            continue
        out.append(f"# TYPE {metric} {mtype}")
        for t, v in rows:
            out.append(f'{metric}{{tenant="{t}"}} {v}')
    for t, d in sorted(tenants.items()):
        whist = d.get("wait_hist") or []
        if not any(whist):
            continue
        name = "strom_tpu_tenant_wait_seconds"
        out.append(f"# TYPE {name} histogram")
        acc = 0
        total = sum(whist)
        wsum_ns = 0
        for b in range(min(len(whist), LAT_HIST_BUCKETS)):
            n = whist[b]
            acc += n
            wsum_ns += n * ((1 << b) + ((1 << b) >> 1))
            if n:
                le = (1 << (b + 1)) / 1e9
                out.append(f'{name}_bucket{{tenant="{t}",le="{le:g}"}} {acc}')
        out.append(f'{name}_bucket{{tenant="{t}",le="+Inf"}} {total}')
        out.append(f'{name}_sum{{tenant="{t}"}} {wsum_ns / 1e9:.9f}')
        out.append(f'{name}_count{{tenant="{t}"}} {total}')
    # request-latency histogram: cumulative le buckets in seconds
    if any(hist):
        name = "strom_tpu_request_latency_seconds"
        out.append(f"# TYPE {name} histogram")
        acc = 0
        total = sum(hist)
        approx_sum_ns = 0
        for b in range(min(len(hist), LAT_HIST_BUCKETS)):
            n = hist[b]
            acc += n
            approx_sum_ns += n * ((1 << b) + ((1 << b) >> 1))
            if n:
                le = (1 << (b + 1)) / 1e9
                out.append(f'{name}_bucket{{le="{le:g}"}} {acc}')
        out.append(f'{name}_bucket{{le="+Inf"}} {total}')
        out.append(f"{name}_sum {approx_sum_ns / 1e9:.9f}")
        out.append(f"{name}_count {total}")
    if "timestamp_ns" in payload:
        emit("strom_tpu_export_timestamp_ns", "gauge",
             payload["timestamp_ns"], f'{{pid="{pid}"}}')
    return "\n".join(out) + "\n"
