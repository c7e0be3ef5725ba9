"""ctypes binding of the native async I/O engine (``csrc/strom_engine.cc``).

The port's own copy of the JAX package's ``_native`` binding, over its own
copy of the engine: the library is compiled at first use by
:func:`._build.engine_library` (``g++`` into ``_build/``), never taken from
the JAX package's build.  The engine executes planned request batches with
io_uring (or, one rung down, its own pread thread pool) entirely outside
the GIL, with the same task-table semantics as the Python pool in
:mod:`.engine`.

The whole C ABI of ``csrc/strom_tpu.h`` (API v4) is bound.
``NativeEngine`` walks its ``auto`` ladder from Python, one rung a create:
the NVMe passthrough rung first (``nstpu_engine_create3`` with the char
device, ``/dev/ngXnY``), then io_uring, then the threadpool.  Why the
passthrough rung refused is kept (:meth:`NativeEngine.passthru_reason`,
:data:`PASSTHRU_REASONS`), as the JAX package's engine keeps it for the
same ladder walked in C.  ``nstpu_engine_lane_pin`` pins a lane's threads
to a CPU set (the NUMA lever of ``Session._pin_lanes``).
"""

from __future__ import annotations

import ctypes
import errno as _errno
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .api import StromError

__all__ = ["NativeEngine", "native_available", "native_api_version",
           "native_signature", "uring_probe", "passthru_probe",
           "passthru_refusal",
           "API_VERSION", "NATIVE_COUNTERS", "LAT_HIST_BUCKETS",
           "TRACE_RING_EVENTS", "PASSTHRU_REASONS"]

#: NSTPU_BACKEND_* of ``csrc/strom_tpu.h`` (NSTPU_BACKEND_AUTO is never
#: asked for: the ladder is walked here, a rung a create)
BACKEND_IO_URING, BACKEND_THREADPOOL, BACKEND_NVME_PASSTHRU = 1, 2, 3
_BACKEND_NAMES = {BACKEND_IO_URING: "io_uring",
                  BACKEND_THREADPOOL: "threadpool",
                  BACKEND_NVME_PASSTHRU: "nvme_passthru"}
_BACKENDS = {"io_uring": BACKEND_IO_URING,
             "threadpool": BACKEND_THREADPOOL,
             "nvme_passthru": BACKEND_NVME_PASSTHRU}

#: ``nstpu_passthru_probe`` / ``nstpu_engine_passthru_reason`` refusal
#: reasons (negative NSTPU_PASSTHRU_*), keyed to the counter suffix a
#: Session counts (``nr_passthru_refusal_<reason>``)
PASSTHRU_REASONS = {-1: "disabled", -2: "nodev", -3: "nouring",
                    -4: "nouringcmd", -5: "lbafmt"}
_PASSTHRU_ENOURING = -3

#: NSTPU_API_VERSION of ``csrc/strom_tpu.h``
API_VERSION = 4

#: counter order of enum NSTPU_CTR_* in ``csrc/strom_tpu.h``
NATIVE_COUNTERS = (
    "nr_submit_dma", "clk_submit_dma",
    "nr_ssd2dev", "clk_ssd2dev",
    "nr_wait_dtask", "clk_wait_dtask",
    "nr_wrong_wakeup",
    "total_dma_length",
    "cur_dma_count",
    "max_dma_count",
    "nr_resubmit",
    "nr_sq_full",
    "nr_write_dma",
    "total_write_length",
    "nr_fixed_dma",
    "nr_enter_dma",
    "occ_integral_ns",
    "occ_busy_ns",
    "nr_passthru_dma",
)

#: NSTPU_LAT_BUCKETS: log2-ns latency histogram depth (stats.LAT_HIST_BUCKETS)
LAT_HIST_BUCKETS = 64

REQ_WRITE = 0x1        # NSTPU_REQ_WRITE
REQ_PASSTHRU = 0x2     # NSTPU_REQ_PASSTHRU: file_off is a device offset
REQ_MEMBER_SHIFT = 8   # NSTPU_REQ_MEMBER_SHIFT
MAX_MEMBERS = 64       # NSTPU_MAX_MEMBERS

#: NSTPU_TRACE_RING_EVENTS: one drain can empty a full lane ring
TRACE_RING_EVENTS = 4096


class _Req(ctypes.Structure):
    # nstpu_req in csrc/strom_tpu.h
    _fields_ = [("fd", ctypes.c_int32), ("flags", ctypes.c_int32),
                ("file_off", ctypes.c_uint64), ("len", ctypes.c_uint64),
                ("dest_off", ctypes.c_uint64)]


class _TraceEvent(ctypes.Structure):
    # nstpu_trace_event in csrc/strom_tpu.h
    _fields_ = [("submit_ns", ctypes.c_uint64),
                ("complete_ns", ctypes.c_uint64),
                ("file_off", ctypes.c_uint64), ("len", ctypes.c_uint64),
                ("member", ctypes.c_uint32), ("lane", ctypes.c_uint32),
                ("result", ctypes.c_int32), ("seq", ctypes.c_uint32)]


_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)
#: (symbol, restype, argtypes) of every bound function
_SIGNATURES = (
    ("nstpu_engine_create", ctypes.c_uint64, [ctypes.c_int, ctypes.c_int]),
    ("nstpu_engine_create2", ctypes.c_uint64,
     [ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    ("nstpu_engine_create3", ctypes.c_uint64,
     [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p]),
    ("nstpu_engine_destroy", None, [ctypes.c_uint64]),
    ("nstpu_engine_backend", ctypes.c_int, [ctypes.c_uint64]),
    ("nstpu_engine_version", ctypes.c_int, []),
    ("nstpu_signature", ctypes.c_char_p, []),
    ("nstpu_submit", ctypes.c_int64,
     [ctypes.c_uint64, ctypes.c_void_p, ctypes.POINTER(_Req),
      ctypes.c_int32]),
    ("nstpu_wait", ctypes.c_int,
     [ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64]),
    ("nstpu_pending", ctypes.c_int,
     [ctypes.c_uint64, _I64P, ctypes.c_int32]),
    ("nstpu_engine_reap", ctypes.c_int,
     [ctypes.c_uint64, _I64P, ctypes.c_int32, ctypes.c_int64]),
    ("nstpu_engine_stats", ctypes.c_int,
     [ctypes.c_uint64, _U64P, ctypes.c_int32]),
    ("nstpu_engine_lat_hist", ctypes.c_int,
     [ctypes.c_uint64, _U64P, ctypes.c_int32]),
    ("nstpu_engine_member_stats", ctypes.c_int,
     [ctypes.c_uint64, ctypes.c_int32, _U64P]),
    ("nstpu_engine_nlanes", ctypes.c_int, [ctypes.c_uint64]),
    ("nstpu_engine_member_lat_hist", ctypes.c_int,
     [ctypes.c_uint64, ctypes.c_int32, _U64P, ctypes.c_int32]),
    ("nstpu_engine_member_occ", ctypes.c_int,
     [ctypes.c_uint64, ctypes.c_int32, _U64P]),
    ("nstpu_buf_register", ctypes.c_int,
     [ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64]),
    ("nstpu_buf_unregister", ctypes.c_int, [ctypes.c_uint64, ctypes.c_int32]),
    ("nstpu_engine_trace", ctypes.c_int, [ctypes.c_uint64, ctypes.c_int]),
    ("nstpu_engine_trace_drain", ctypes.c_int,
     [ctypes.c_uint64, ctypes.POINTER(_TraceEvent), ctypes.c_int32]),
    ("nstpu_engine_lane_pin", ctypes.c_int,
     [ctypes.c_uint64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
      ctypes.c_int32]),
    ("nstpu_passthru_probe", ctypes.c_int, [ctypes.c_char_p]),
    ("nstpu_engine_passthru_reason", ctypes.c_int, [ctypes.c_uint64]),
)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    """The engine library, built at first use.  A failed build raises."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ._build import engine_library
            lib = ctypes.CDLL(engine_library())
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def native_available() -> bool:
    """True once the engine's library is built and loaded."""
    try:
        _load()
    except (StromError, OSError):
        return False
    return True


def native_api_version() -> int:
    """The ABI version the loaded library reports (:data:`API_VERSION`)."""
    return int(_load().nstpu_engine_version())


def native_signature() -> str:
    """Build signature of the loaded library (version, toolchain, time)."""
    return _load().nstpu_signature().decode()


_NR_IO_URING_SETUP = 425      # the same number on x86_64 and aarch64


def uring_probe() -> int:
    """0 when the kernel lets this process create an io_uring, else the
    errno ``io_uring_setup(2)`` refused it with (containers may block the
    syscall: EPERM or ENOSYS)."""
    libc = ctypes.CDLL(None, use_errno=True)
    params = (ctypes.c_uint8 * 120)()     # struct io_uring_params, zeroed
    fd = libc.syscall(ctypes.c_long(_NR_IO_URING_SETUP), ctypes.c_uint(1),
                      params)
    if fd < 0:
        return ctypes.get_errno() or _errno.ENOSYS
    libc.close(fd)
    return 0


def _passthru_dev_arg(dev: Optional[str]) -> Optional[bytes]:
    """The char device a passthrough create or probe names: *dev*, else
    env ``NSTPU_PASSTHRU_DEV`` (the engine's own fallback)."""
    dev = dev or os.environ.get("NSTPU_PASSTHRU_DEV")
    return dev.encode() if dev else None


def passthru_probe(dev_path: Optional[str]) -> int:
    """Capability-probe one NVMe char device for the passthrough rung:
    its LBA shift (>= 9) when every step of the probe passes (open,
    ``NVME_IOCTL_ID``, an SQE128|CQE32 ring, ``IORING_OP_URING_CMD``, the
    namespace's LBA format), else a negative refusal reason
    (:data:`PASSTHRU_REASONS`).  Leaves no engine behind."""
    return int(_load().nstpu_passthru_probe(
        dev_path.encode() if dev_path else None))


def passthru_refusal(dev_path: Optional[str]) -> int:
    """Why a passthrough create on *dev_path* (else env
    ``NSTPU_PASSTHRU_DEV``) failed: the probe's reason, or ``nouring``
    when the probe passes and the create's rings did not come up."""
    pr = int(_load().nstpu_passthru_probe(_passthru_dev_arg(dev_path)))
    return pr if pr < 0 else _PASSTHRU_ENOURING


class NativeEngine:
    """One native engine instance (the 'loaded kernel module' analog).

    *backend* is ``nvme_passthru``, ``io_uring``, ``threadpool`` or
    ``auto`` (the passthrough rung, then io_uring, then the threadpool);
    *rings* is the lane count (``<= 0``: one); *passthru_dev* names the
    NVMe char device the passthrough rung opens (else env
    ``NSTPU_PASSTHRU_DEV``; with neither it refuses with ``nodev``)."""

    def __init__(self, backend: str = "auto", queue_depth: int = 32,
                 rings: int = 0, passthru_dev: Optional[str] = None):
        if backend not in ("auto", *_BACKENDS):
            raise StromError(_errno.EINVAL,
                             f"native backend {backend!r} is not one of "
                             f"auto|{'|'.join(_BACKENDS)}")
        lib = _load()
        self._lib = lib
        rungs = [BACKEND_NVME_PASSTHRU, BACKEND_IO_URING,
                 BACKEND_THREADPOOL] if backend == "auto" \
            else [_BACKENDS[backend]]
        nrings = max(int(rings), 1)
        self._h = 0
        # why the passthrough rung refused (None: the ladder never held it)
        self._pt_reason: Optional[int] = None
        for want in rungs:
            if want == BACKEND_NVME_PASSTHRU:
                dev = _passthru_dev_arg(passthru_dev)
                self._h = lib.nstpu_engine_create3(want, queue_depth,
                                                   nrings, dev)
                if not self._h:
                    self._pt_reason = passthru_refusal(passthru_dev)
            else:
                self._h = lib.nstpu_engine_create2(want, queue_depth,
                                                   nrings)
            if self._h:
                break
        if not self._h:
            raise StromError(_errno.EIO,
                             f"native engine init failed (backend={backend})")
        self.backend_name = _BACKEND_NAMES.get(
            lib.nstpu_engine_backend(self._h), "unknown")
        self._prev_stats: Dict[str, int] = {}
        self._prev_members: Dict[int, Tuple[int, int, int]] = {}
        self._prev_hist: List[int] = [0] * LAT_HIST_BUCKETS
        self._prev_member_hist: Dict[int, List[int]] = {}
        self._prev_member_occ: Dict[int, Tuple[int, int]] = {}
        self._stats_lock = threading.Lock()

    def submit(self, dest_addr: int,
               reqs: Sequence[Tuple[int, int, int, int]], *,
               write: bool = False,
               members: Optional[Sequence[int]] = None,
               passthru: Optional[Sequence[bool]] = None) -> int:
        """Submit one task of ``(fd, file_off, len, dest_off)`` requests;
        returns its native task id.  ``write=True`` writes the buffer span
        at dest_off to the fd instead.  ``members[i]`` attributes request
        *i* to a stripe member for per-member accounting and its lane.
        ``passthru[i]`` marks request *i* a raw NVMe READ: its file_off is
        a device byte offset (blockmap-resolved) and its fd is ignored;
        the engine refuses the whole submit (EINVAL) unless it runs the
        passthrough rung."""
        arr = (_Req * len(reqs))()
        base_flags = REQ_WRITE if write else 0
        for i, (fd, off, ln, doff) in enumerate(reqs):
            m = members[i] if members is not None else 0
            pt = REQ_PASSTHRU if passthru is not None and passthru[i] else 0
            arr[i].fd = fd
            arr[i].flags = base_flags | pt | (min(max(m, 0), MAX_MEMBERS - 1)
                                              << REQ_MEMBER_SHIFT)
            arr[i].file_off = off
            arr[i].len = ln
            arr[i].dest_off = doff
        tid = self._lib.nstpu_submit(self._h, ctypes.c_void_p(dest_addr),
                                     arr, len(reqs))
        if tid < 0:
            raise StromError(-tid, f"native submit failed ({-tid})")
        return tid

    def buf_register(self, addr: int, length: int) -> Optional[int]:
        """Register a pinned region as an io_uring fixed buffer; returns
        the slot, or None when the backend, the kernel or RLIMIT_MEMLOCK
        refuses (requests into it then take the plain opcode).  The region
        must stay mapped until :meth:`buf_unregister` or :meth:`close`."""
        slot = self._lib.nstpu_buf_register(self._h, ctypes.c_void_p(addr),
                                            ctypes.c_uint64(length))
        return slot if slot >= 0 else None

    def buf_unregister(self, slot: int) -> None:
        if self._h:
            self._lib.nstpu_buf_unregister(self._h, slot)

    def nlanes(self) -> int:
        """Lane (queue-pair) count of this engine."""
        n = self._lib.nstpu_engine_nlanes(self._h)
        return n if n > 0 else 1

    def passthru_reason(self) -> int:
        """0 when the passthrough rung is this engine's backend, else why
        the ladder passed it (a negative key of :data:`PASSTHRU_REASONS`;
        ``disabled`` for an engine asked for a lower rung by name)."""
        if self._pt_reason is not None and \
                self.backend_name != "nvme_passthru":
            return self._pt_reason
        return int(self._lib.nstpu_engine_passthru_reason(self._h))

    def lane_pin(self, lane: int, cpus: Sequence[int]) -> bool:
        """Pin one lane's service threads (reaper and workers) to *cpus*.
        False for a bad lane, an empty set, or a kernel that refuses the
        affinity: the lane keeps floating, only locality is lost."""
        if not cpus:
            return False
        arr = (ctypes.c_int32 * len(cpus))(*cpus)
        return self._lib.nstpu_engine_lane_pin(self._h, lane, arr,
                                               len(cpus)) == 0

    def member_stats(self, member: int) -> Tuple[int, int, int]:
        """(completed requests, bytes, busy ns) for one stripe member."""
        out = (ctypes.c_uint64 * 3)()
        rc = self._lib.nstpu_engine_member_stats(self._h, member, out)
        if rc < 0:
            raise StromError(-rc, f"member_stats({member}) failed")
        return out[0], out[1], out[2]

    def wait(self, task_id: int, timeout_ms: int = -1) -> None:
        rc = self._lib.nstpu_wait(self._h, task_id, timeout_ms)
        if rc < 0:
            raise StromError(-rc, f"native task {task_id} failed ({-rc})")

    def pending(self, cap: int = 4096) -> List[int]:
        out = (ctypes.c_int64 * cap)()
        n = self._lib.nstpu_pending(self._h, out, cap)
        if n < 0:
            raise StromError(-n, "native pending failed")
        return list(out[:min(n, cap)])

    def reap(self, timeout_ms: int = 30000, cap: int = 4096) -> List[int]:
        out = (ctypes.c_int64 * cap)()
        n = self._lib.nstpu_engine_reap(self._h, out, cap, timeout_ms)
        if n < 0:
            raise StromError(-n, "native reap failed")
        return list(out[:min(n, cap)])

    def stats(self) -> Dict[str, int]:
        out = (ctypes.c_uint64 * len(NATIVE_COUNTERS))()
        n = self._lib.nstpu_engine_stats(self._h, out, len(NATIVE_COUNTERS))
        return {NATIVE_COUNTERS[i]: out[i] for i in range(max(n, 0))}

    def stats_delta(self) -> Dict[str, int]:
        """Counters since the previous call (gauges passed through).
        Serialized: concurrent callers must not double-count a delta."""
        with self._stats_lock:
            cur = self.stats()
            prev, self._prev_stats = self._prev_stats, dict(cur)
            return {k: v if k in ("cur_dma_count", "max_dma_count")
                    else v - prev.get(k, 0) for k, v in cur.items()}

    def lat_hist(self) -> List[int]:
        """Absolute per-request service-latency histogram (log2 ns)."""
        out = (ctypes.c_uint64 * LAT_HIST_BUCKETS)()
        n = self._lib.nstpu_engine_lat_hist(self._h, out, LAT_HIST_BUCKETS)
        if n < 0:
            raise StromError(-n, "native lat_hist failed")
        return list(out[:min(n, LAT_HIST_BUCKETS)]) \
            + [0] * (LAT_HIST_BUCKETS - min(n, LAT_HIST_BUCKETS))

    def lat_hist_delta(self) -> List[int]:
        """Histogram bucket deltas since the previous call."""
        with self._stats_lock:
            cur = self.lat_hist()
            prev, self._prev_hist = self._prev_hist, list(cur)
            return [c - p for c, p in zip(cur, prev)]

    def member_lat_hist(self, member: int) -> List[int]:
        """Absolute per-member latency histogram (log2 ns)."""
        out = (ctypes.c_uint64 * LAT_HIST_BUCKETS)()
        n = self._lib.nstpu_engine_member_lat_hist(self._h, member, out,
                                                   LAT_HIST_BUCKETS)
        if n < 0:
            raise StromError(-n, f"member_lat_hist({member}) failed")
        return list(out[:min(n, LAT_HIST_BUCKETS)]) \
            + [0] * (LAT_HIST_BUCKETS - min(n, LAT_HIST_BUCKETS))

    def member_lat_hist_delta(self, members: Sequence[int]
                              ) -> Dict[int, List[int]]:
        """Per-member histogram deltas since the previous call; members
        with no new completions are omitted."""
        with self._stats_lock:
            out: Dict[int, List[int]] = {}
            for m in sorted({min(max(m, 0), MAX_MEMBERS - 1)
                             for m in members}):
                cur = self.member_lat_hist(m)
                prev = self._prev_member_hist.get(m, [0] * LAT_HIST_BUCKETS)
                delta = [c - p for c, p in zip(cur, prev)]
                if any(delta):
                    out[m] = delta
                    self._prev_member_hist[m] = cur
            return out

    def member_occ(self, member: int) -> Tuple[int, int]:
        """Monotonic (occ_integral_ns, occ_busy_ns) for one member: its
        mean in-flight depth over a window is d(integral) / d(busy)."""
        out = (ctypes.c_uint64 * 2)()
        rc = self._lib.nstpu_engine_member_occ(self._h, member, out)
        if rc < 0:
            raise StromError(-rc, f"member_occ({member}) failed")
        return out[0], out[1]

    def member_occ_delta(self, members: Sequence[int]
                         ) -> Dict[int, Tuple[int, int]]:
        """Per-member occupancy deltas since the previous call."""
        with self._stats_lock:
            out: Dict[int, Tuple[int, int]] = {}
            for m in sorted({min(max(m, 0), MAX_MEMBERS - 1)
                             for m in members}):
                cur = self.member_occ(m)
                prev = self._prev_member_occ.get(m, (0, 0))
                if cur != prev:
                    out[m] = (cur[0] - prev[0], cur[1] - prev[1])
                    self._prev_member_occ[m] = cur
            return out

    def member_stats_delta(self, members: Sequence[int]
                           ) -> Dict[int, Tuple[int, int, int]]:
        """Per-member (nreq, bytes, ns) deltas since the previous call."""
        with self._stats_lock:
            out: Dict[int, Tuple[int, int, int]] = {}
            for m in sorted({min(max(m, 0), MAX_MEMBERS - 1)
                             for m in members}):
                cur = self.member_stats(m)
                prev = self._prev_members.get(m, (0, 0, 0))
                if cur != prev:
                    out[m] = tuple(c - p for c, p in zip(cur, prev))
                    self._prev_members[m] = cur
            return out

    def trace_enable(self, on: bool = True) -> bool:
        """Turn the per-lane event ring on or off; returns the previous
        state."""
        return self._lib.nstpu_engine_trace(self._h, 1 if on else 0) > 0

    def trace_drain(self, cap: int = TRACE_RING_EVENTS
                    ) -> List[Dict[str, int]]:
        """Drain recorded device events (oldest first per lane): each the
        measured submit→complete window in CLOCK_MONOTONIC ns, the clock
        of ``time.monotonic_ns()``."""
        if not self._h:
            return []
        out = (_TraceEvent * cap)()
        n = self._lib.nstpu_engine_trace_drain(self._h, out, cap)
        if n <= 0:
            return []
        return [{"submit_ns": e.submit_ns, "complete_ns": e.complete_ns,
                 "file_off": e.file_off, "len": e.len, "member": e.member,
                 "lane": e.lane, "result": e.result, "seq": e.seq}
                for e in out[:min(n, cap)]]

    def close(self) -> None:
        # swap the handle out under the lock: two racing closers (close()
        # and __del__) must not destroy twice
        with self._stats_lock:
            h, self._h = self._h, 0
        if h:
            self._lib.nstpu_engine_destroy(h)

    def __del__(self):  # pragma: no cover - GC backstop
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
