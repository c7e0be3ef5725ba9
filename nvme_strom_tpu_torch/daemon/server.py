"""stromd: the shared serving daemon.

A port of the JAX package's ``daemon/server.py``.  The reference is a
*shared kernel service*: every process on the host submits DMA through
one ``/proc/nvme-strom`` ioctl entry and the kernel arbitrates across
them.  :class:`StromDaemon` is that arbiter in userspace:

* one long-running process owns ONE engine :class:`~nvme_strom_tpu_torch.
  engine.Session` (the lanes, buffers, cache tier and fault ladder);
* clients attach over the Unix socket (:mod:`.protocol`), get a
  **session handle** with an explicit lifecycle — attach → configure →
  map/open/submit/wait → detach — and share destination memory by
  passing ``memfd`` descriptors the daemon mmaps and registers with the
  engine (DMA lands directly in client-visible pages, no socket copy);
  a client on a GPU host copies those pages into its CUDA tensors itself
  (``tools/ssd2gpu_test.py --daemon``);
* **admission control** bounds the daemon: max attached sessions, and
  per-tenant in-flight task/byte quotas answered with EAGAIN
  *backpressure* instead of unbounded queueing;
* the **QoS scheduler** (:mod:`.qos`) orders admitted work by priority
  class, token-bucket shaping and byte-weighted DRR before any byte
  reaches the engine's lanes;
* **orphan reaping**: a client that disconnects without detaching — a
  crash, a SIGKILL — has its queued work cancelled, its in-flight tasks
  drained, its buffer registrations revoked (blocking until engine DMA
  refcounts drain) and its sources closed, so a dead client can never
  wedge a lane or leak a mapping.

Every hop is attributed: per-tenant counters, quota gauges and queue-wait
histograms in ``stats`` (the Prometheus rendering of :mod:`..trace` reads
them) and ``session_*`` / ``qos_*`` / ``admission_reject`` events in the
flight recorder.
"""

from __future__ import annotations

import base64
import errno as _errno
import mmap
import os
import secrets
import socket
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from ..api import StromError
from ..config import config
from ..stats import stats
from ..trace import recorder as _trace
from .protocol import PROTOCOL_VERSION, Framer, default_socket_path, send_msg
from .qos import QOS_CLASSES, QosScheduler, WorkItem

__all__ = ["StromDaemon"]

#: ops a session may issue after attach
_OPS = ("configure", "map", "unmap", "open", "close_source", "submit",
        "wait", "stat", "ping", "detach", "kv_open", "kv")

#: live lease records kept after an unclean disconnect (the re-attach
#: window) — bounded so a flapping client cannot grow the daemon
_MAX_LEASES = 256
#: per-lease idempotency window: submit_ids remembered for dedup
_MAX_LEASE_SUBMITS = 1024


class _Lease:
    """Session identity that survives the connection.

    Attach mints a lease token and returns it; a client that loses its
    connection — or outlives a daemon restart — RE-attaches presenting
    the token and gets its tenant/QoS identity back plus its unacked
    task table, so idempotent resubmission (``submit_id`` dedup) cannot
    double-run work the daemon already holds.  After a daemon restart
    the presented token is unknown; it is adopted as a fresh record
    (single-host trust domain — the socket mode is the privilege
    boundary), which makes the client's replay re-execute, exactly the
    recovery the restart lost."""

    __slots__ = ("token", "tenant", "qos_class", "weight", "submits")

    def __init__(self, token: str, tenant: str, qos_class: str,
                 weight: float) -> None:
        self.token = token
        self.tenant = tenant
        self.qos_class = qos_class
        self.weight = weight
        #: submit_id -> WorkItem (done items keep results until waited)
        self.submits: "OrderedDict[str, WorkItem]" = OrderedDict()

    def remember(self, submit_id: str, item: WorkItem) -> None:
        self.submits[submit_id] = item
        while len(self.submits) > _MAX_LEASE_SUBMITS:
            # oldest acked-or-done first; never drop an in-flight item
            for k, it in self.submits.items():
                if it.done.is_set():
                    del self.submits[k]
                    break
            else:
                break


class _MappedBuffer:
    """A client memfd mapped into the daemon and registered with the
    engine — the MAP_GPU_MEMORY analog: both processes see the same
    pages, so engine DMA lands in client memory with no copy."""

    def __init__(self, fd: int, length: int, engine):
        self._fd = fd
        self._mm = mmap.mmap(fd, length)
        try:
            self.handle = engine.map_buffer(memoryview(self._mm))
        except BaseException:
            self._mm.close()
            raise
        self.length = length

    def release(self, engine, *, timeout: float = 30.0) -> None:
        """Revoke the engine registration (blocking until in-flight DMA
        refcounts drain) and drop the mapping + descriptor."""
        try:
            engine.unmap_buffer(self.handle, wait=True, timeout=timeout)
        except StromError:
            pass                # already unmapped, or drain timed out
        self._mm.close()
        try:
            os.close(self._fd)
        except OSError:
            pass


class _ClientSession:
    """Per-connection state.  Only the connection's handler thread mutates
    the resource tables; cross-thread counters (in-flight quota usage) are
    guarded by the daemon lock."""

    def __init__(self, sid: int, tenant: str, qos_class: str, weight: float,
                 lease: Optional[_Lease] = None):
        self.sid = sid
        self.tenant = tenant
        self.qos_class = qos_class
        self.weight = weight
        self.lease = lease
        self.buffers: Dict[int, _MappedBuffer] = {}
        self.sources: Dict[int, object] = {}
        self.tasks: Dict[int, WorkItem] = {}
        self.inflight_tasks = 0
        self.inflight_bytes = 0
        self.next_handle = 1


class StromDaemon:
    """The stromd server.  ``start()`` binds the socket and spawns the
    accept, per-connection and dispatcher threads; ``close()`` tears the
    whole thing down (reaping every live session).

    ``allow_fake`` additionally accepts dict source specs naming the
    loopback :class:`~nvme_strom_tpu_torch.testing.FakeNvmeSource` — the
    deterministic latency-bound backend the qos-gate and tests schedule
    against; never enable it on a production socket.

    *device* is where the HBM tier (and so a shared KV pool's HBM blocks)
    places its extents; None keeps the tier's own (``cuda:0`` at first
    use).
    """

    def __init__(self, socket_path: Optional[str] = None, *,
                 allow_fake: bool = False,
                 max_sessions: Optional[int] = None,
                 dispatchers: Optional[int] = None,
                 engine_session=None, device=None):
        from .. import engine as _engine_mod
        self.socket_path = socket_path or config.get("daemon_socket") \
            or default_socket_path()
        self._lock = threading.Lock()
        self._allow_fake = allow_fake
        self._max_sessions = int(config.get("daemon_max_sessions")
                                 if max_sessions is None else max_sessions)
        self._quota_tasks = int(config.get("daemon_quota_tasks"))
        self._quota_bytes = int(config.get("daemon_quota_bytes"))
        self._n_dispatch = int(config.get("daemon_dispatch")
                               if dispatchers is None else dispatchers)
        self._default_class = str(config.get("qos_default_class"))
        self._default_weight = float(config.get("qos_default_weight"))
        self._default_rate = int(config.get("qos_rate"))
        self._default_burst = int(config.get("qos_burst"))
        self._own_engine = engine_session is None
        self._engine = (engine_session if engine_session is not None
                        else _engine_mod.Session(device=device))
        if device is not None:
            from ..tiering import extent_space
            extent_space.configure(device=device)
        self._sched = QosScheduler(quantum=int(config.get("qos_quantum")),
                                   on_throttle=self._throttled)
        self._sessions: Dict[int, _ClientSession] = {}
        self._leases: "OrderedDict[str, _Lease]" = OrderedDict()
        self._kv_pool = None
        self._kv_spill = None
        self._next_sid = 0
        self._next_task = 0
        self._sock: Optional[socket.socket] = None
        self._live_conns: Dict[int, socket.socket] = {}
        self._threads: List[threading.Thread] = []
        self._dispatch_threads: List[threading.Thread] = []
        self._started = False
        self._closed = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "StromDaemon":
        with self._lock:
            if self._started:
                raise StromError(_errno.EBUSY, "daemon already started")
            self._started = True
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        sock.bind(self.socket_path)
        # owner-only by default: the socket IS the privilege boundary
        # (deploy checklist item 17 widens it deliberately per host)
        os.chmod(self.socket_path, 0o600)
        sock.listen(64)
        self._sock = sock
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="stromd-accept")
        with self._lock:
            self._threads.append(t)
        t.start()
        self.start_dispatchers(self._n_dispatch)
        return self

    def start_dispatchers(self, n: int) -> None:
        """Spawn *n* more dispatcher threads.  ``daemon_dispatch=0`` plus
        a later explicit call is the deterministic-test idiom: stall
        dispatch, queue a known workload, then turn the crank."""
        for _ in range(max(0, int(n))):
            t = threading.Thread(target=self._dispatch_loop, daemon=True,
                                 name="stromd-dispatch")
            with self._lock:
                self._dispatch_threads.append(t)
            t.start()

    def __enter__(self) -> "StromDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            sids = list(self._sessions)
            threads = list(self._threads) + list(self._dispatch_threads)
            conns = list(self._live_conns.values())
        self._sched.close()
        if self._sock is not None:
            try:
                # shutdown() before close(): close() alone does not wake
                # a thread blocked in accept() on Linux
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        for c in conns:
            # wake handler threads blocked in recv() on still-attached
            # clients so the joins below do not burn their timeout
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for sid in sids:
            self._release_session(sid, clean=False)
        for t in threads:
            t.join(timeout=10.0)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        if self._kv_pool is not None:
            self._kv_pool.close()
            self._kv_spill.close()
        if self._own_engine:
            self._engine.close()

    def session_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def queue_depth(self) -> int:
        return self._sched.depth()

    # -- accept / serve -----------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return          # socket closed: daemon shutting down
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="stromd-conn")
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._threads.append(t)
                self._live_conns[id(conn)] = conn
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        framer = Framer(conn)
        sid = None
        clean = False
        try:
            sess = self._attach(conn, framer)
            if sess is None:
                return
            sid = sess.sid
            while True:
                got = framer.recv()
                if got is None:
                    return      # EOF without detach: orphan, reap below
                msg, fds = got
                op = msg.get("op")
                if op != "map":
                    # only map consumes descriptors; drop strays so a
                    # confused client cannot leak fds into the daemon
                    for fd in fds:
                        os.close(fd)
                    fds = []
                try:
                    if op == "detach":
                        clean = True
                        send_msg(conn, {"ok": True})
                        return
                    if op not in _OPS:
                        raise StromError(_errno.EINVAL,
                                         f"unknown op {op!r}")
                    # the op owns fds from here (map closes on failure)
                    send_msg(conn, dict(
                        getattr(self, "_op_" + op)(sess, msg, fds), ok=True))
                except StromError as e:
                    send_msg(conn, {"ok": False, "errno": e.errno,
                                    "error": str(e)})
        except (OSError, StromError, ValueError):
            pass                # connection died mid-frame: reap below
        finally:
            with self._lock:
                self._live_conns.pop(id(conn), None)
            try:
                conn.close()
            except OSError:
                pass
            if sid is not None:
                self._release_session(sid, clean=clean)

    def _attach(self, conn: socket.socket,
                framer: Framer) -> Optional[_ClientSession]:
        """Mandatory first message.  A version mismatch fails CLOSED: an
        EPROTO reply, then the connection drops before any resource is
        allocated (the reference's ABI-mismatch ioctl failure analog)."""
        got = framer.recv()
        if got is None:
            return None
        msg, fds = got
        for fd in fds:
            os.close(fd)
        if msg.get("op") != "attach":
            send_msg(conn, {"ok": False, "errno": _errno.EPROTO,
                            "error": "first message must be attach"})
            return None
        if msg.get("version") != PROTOCOL_VERSION:
            send_msg(conn, {"ok": False, "errno": _errno.EPROTO,
                            "error": f"protocol version "
                                     f"{msg.get('version')!r} != "
                                     f"{PROTOCOL_VERSION}"})
            return None
        tenant = str(msg.get("tenant") or f"pid{msg.get('pid', '?')}")
        qos_class = str(msg.get("class") or self._default_class)
        weight = float(msg.get("weight") or self._default_weight)
        rate = float(msg.get("rate") if msg.get("rate") is not None
                     else self._default_rate)
        if qos_class not in QOS_CLASSES:
            send_msg(conn, {"ok": False, "errno": _errno.EINVAL,
                            "error": f"class must be one of {QOS_CLASSES}"})
            return None
        token = msg.get("lease")
        with self._lock:
            if self._closed:
                send_msg(conn, {"ok": False, "errno": _errno.ESHUTDOWN,
                                "error": "daemon shutting down"})
                return None
            if self._max_sessions and \
                    len(self._sessions) >= self._max_sessions:
                send_msg(conn, {"ok": False, "errno": _errno.EAGAIN,
                                "error": f"max sessions "
                                         f"({self._max_sessions}) attached"})
                return None
            # lease-renewal handshake: a presented token re-adopts the
            # surviving record (reconnect) or is adopted fresh (daemon
            # restarted and lost it); no token mints one
            reattach = False
            lease = self._leases.get(token) if token else None
            if lease is not None:
                reattach = True
                self._leases.move_to_end(token)
                tenant = lease.tenant       # identity rides the lease
                qos_class = str(msg.get("class") or lease.qos_class)
                weight = float(msg.get("weight") or lease.weight)
            else:
                lease = _Lease(token or secrets.token_hex(8), tenant,
                               qos_class, weight)
                self._leases[lease.token] = lease
                while len(self._leases) > _MAX_LEASES:
                    # oldest lease with no live session goes first
                    live = {s.lease.token for s in self._sessions.values()
                            if s.lease is not None}
                    for k in self._leases:
                        if k not in live:
                            del self._leases[k]
                            break
                    else:
                        break
            lease.qos_class, lease.weight = qos_class, weight
            self._next_sid += 1
            sess = _ClientSession(self._next_sid, tenant, qos_class, weight,
                                  lease=lease)
            # re-adopt the lease's surviving tasks so a wait issued after
            # the re-attach finds work submitted before the disconnect;
            # cancelled ones are forgotten so a resubmit re-runs them
            for sub_id in list(lease.submits):
                item = lease.submits[sub_id]
                if item.cancelled:
                    del lease.submits[sub_id]
                else:
                    item.session_id = sess.sid
                    sess.tasks[item.task_id] = item
            self._sessions[sess.sid] = sess
        self._sched.register_tenant(tenant, qos_class=qos_class,
                                    weight=weight, rate=rate,
                                    burst=self._default_burst)
        stats.add("nr_session_attach")
        stats.gauge_add("daemon_sessions", 1)
        stats.tenant_configure(tenant, qos_class=qos_class, weight=weight,
                               rate=rate, quota_tasks=self._quota_tasks,
                               quota_bytes=self._quota_bytes)
        if _trace.active:
            _trace.instant("session_attach",
                           args={"session": sess.sid, "tenant": tenant,
                                 "class": qos_class, "reattach": reattach})
        send_msg(conn, {"ok": True, "session": sess.sid, "tenant": tenant,
                        "version": PROTOCOL_VERSION,
                        "lease": sess.lease.token, "reattach": reattach})
        return sess

    # -- session ops --------------------------------------------------------
    def _op_ping(self, sess, msg, fds) -> dict:
        return {"pong": True, "session": sess.sid}

    def _op_configure(self, sess, msg, fds) -> dict:
        qos_class = str(msg.get("class") or sess.qos_class)
        weight = float(msg.get("weight") or sess.weight)
        rate = msg.get("rate")
        if qos_class not in QOS_CLASSES:
            raise StromError(_errno.EINVAL,
                             f"class must be one of {QOS_CLASSES}")
        sess.qos_class = qos_class
        sess.weight = weight
        self._sched.register_tenant(
            sess.tenant, qos_class=qos_class, weight=weight,
            rate=float(self._default_rate if rate is None else rate),
            burst=self._default_burst)
        stats.tenant_configure(sess.tenant, qos_class=qos_class,
                               weight=weight,
                               rate=None if rate is None else float(rate))
        return {"class": qos_class, "weight": weight}

    def _op_map(self, sess, msg, fds) -> dict:
        if not fds:
            raise StromError(_errno.EINVAL, "map needs an SCM_RIGHTS fd")
        fd, extra = fds[0], fds[1:]
        for f in extra:
            os.close(f)
        length = int(msg.get("length", 0))
        if length <= 0:
            os.close(fd)
            raise StromError(_errno.EINVAL, f"bad map length {length}")
        try:
            mb = _MappedBuffer(fd, length, self._engine)
        except (OSError, ValueError) as e:
            os.close(fd)
            raise StromError(_errno.EINVAL, f"cannot map client fd: {e}")
        sess.buffers[mb.handle] = mb
        return {"handle": mb.handle, "length": length}

    def _op_unmap(self, sess, msg, fds) -> dict:
        handle = int(msg.get("handle", -1))
        mb = sess.buffers.pop(handle, None)
        if mb is None:
            raise StromError(_errno.ENOENT, f"no mapped buffer {handle}")
        mb.release(self._engine)
        return {}

    def _op_open(self, sess, msg, fds) -> dict:
        spec = msg.get("spec")
        if isinstance(spec, dict):
            src = self._open_fake(spec)
        else:
            from ..engine import open_source
            kw = {}
            if msg.get("stripe_chunk_size"):
                kw["stripe_chunk_size"] = int(msg["stripe_chunk_size"])
            if msg.get("segment_size"):
                kw["segment_size"] = int(msg["segment_size"])
            if msg.get("mirror"):
                kw["mirror"] = str(msg["mirror"])
            src = open_source(spec, **kw)
        handle = sess.next_handle
        sess.next_handle += 1
        sess.sources[handle] = src
        return {"handle": handle, "size": src.size}

    def _open_fake(self, spec: dict):
        if not self._allow_fake:
            raise StromError(_errno.EPERM,
                             "fake sources need a daemon started with "
                             "allow_fake=True (test/gate only)")
        from ..testing import FakeNvmeSource, FaultPlan
        plan = None
        if spec.get("latency_s"):
            plan = FaultPlan(latency_s=float(spec["latency_s"]))
        kw = {}
        if spec.get("force_cached_fraction") is not None:
            kw["force_cached_fraction"] = float(spec["force_cached_fraction"])
        return FakeNvmeSource(str(spec["path"]), fault_plan=plan, **kw)

    def _op_close_source(self, sess, msg, fds) -> dict:
        handle = int(msg.get("handle", -1))
        src = sess.sources.pop(handle, None)
        if src is None:
            raise StromError(_errno.ENOENT, f"no open source {handle}")
        src.close()
        return {}

    def _op_submit(self, sess, msg, fds) -> dict:
        """Admission control then QoS enqueue.  The reply carries the
        daemon task id immediately — the engine runs the command later,
        when the scheduler dispatches it; WAIT returns the authoritative
        result (including the engine's chunk-id reordering)."""
        src = sess.sources.get(int(msg.get("source", -1)))
        if src is None:
            raise StromError(_errno.ENOENT, "unknown source handle")
        buf_handle = int(msg.get("buffer", -1))
        if buf_handle not in sess.buffers:
            raise StromError(_errno.ENOENT, "unknown buffer handle")
        chunk_ids = [int(c) for c in msg.get("chunk_ids", ())]
        chunk_size = int(msg.get("chunk_size", 0))
        if not chunk_ids or chunk_size <= 0:
            raise StromError(_errno.EINVAL, "need chunk_ids and chunk_size")
        submit_id = msg.get("submit_id")
        if submit_id is not None:
            # idempotent resubmission: a replayed submit_id the lease
            # already holds returns the live task instead of running the
            # DMA twice (a restarted daemon has an empty table, so the
            # replay genuinely re-executes — the recovery case)
            with self._lock:
                prior = sess.lease.submits.get(str(submit_id))
                if prior is not None and not prior.cancelled:
                    return {"task_id": prior.task_id,
                            "nr_chunks": len(prior.chunk_ids),
                            "dedup": True}
        nbytes = len(chunk_ids) * chunk_size
        with self._lock:
            if (self._quota_tasks
                    and sess.inflight_tasks + 1 > self._quota_tasks) or \
               (self._quota_bytes
                    and sess.inflight_bytes + nbytes > self._quota_bytes):
                rejected = True
            else:
                rejected = False
                sess.inflight_tasks += 1
                sess.inflight_bytes += nbytes
                self._next_task += 1
                task_id = self._next_task
        if rejected:
            stats.add("nr_admission_reject")
            stats.tenant_reject(sess.tenant)
            if _trace.active:
                _trace.instant("admission_reject",
                               args={"tenant": sess.tenant,
                                     "session": sess.sid, "nbytes": nbytes})
            raise StromError(_errno.EAGAIN,
                             f"tenant {sess.tenant} over quota "
                             f"({sess.inflight_tasks} tasks / "
                             f"{sess.inflight_bytes} bytes in flight): "
                             f"back off and retry")
        stats.tenant_inflight(sess.tenant, 1, nbytes)
        item = WorkItem(session_id=sess.sid, tenant=sess.tenant,
                        task_id=task_id, source_handle=id(src),
                        buf_handle=buf_handle, chunk_ids=chunk_ids,
                        chunk_size=chunk_size,
                        dest_offset=int(msg.get("dest_offset", 0)),
                        submit_id=None if submit_id is None
                        else str(submit_id))
        item.source = src       # resolved object rides the item
        sess.tasks[task_id] = item
        if item.submit_id is not None:
            with self._lock:
                sess.lease.remember(item.submit_id, item)
        if _trace.active:
            item.trace_tid = task_id
            _trace.instant("qos_enqueue",
                           args={"tenant": sess.tenant, "session": sess.sid,
                                 "task": task_id, "nbytes": nbytes})
        self._sched.enqueue(item)
        stats.gauge_set("qos_queue_depth", self._sched.depth())
        return {"task_id": task_id, "nr_chunks": len(chunk_ids)}

    def _op_wait(self, sess, msg, fds) -> dict:
        task_id = int(msg.get("task_id", -1))
        item = sess.tasks.get(task_id)
        if item is None:
            raise StromError(_errno.ENOENT, f"unknown daemon task {task_id}")
        timeout = msg.get("timeout")
        if not item.done.wait(None if timeout is None else float(timeout)):
            raise StromError(_errno.ETIMEDOUT,
                             f"daemon task {task_id} timeout")
        sess.tasks.pop(task_id, None)
        if item.submit_id is not None:
            # the wait IS the ack: the idempotency window closes here
            with self._lock:
                sess.lease.submits.pop(item.submit_id, None)
        if item.cancelled:
            raise StromError(_errno.ECANCELED,
                             f"daemon task {task_id} cancelled by session "
                             f"teardown")
        if item.error is not None:
            raise StromError(item.error[0], item.error[1])
        res = item.result
        if isinstance(res, dict):       # KV-pool item: payload as-is
            return dict(res, task_id=task_id,
                        wait_ns=item.dispatch_ns - item.enqueue_ns)
        return {"task_id": task_id, "nr_chunks": res.nr_chunks,
                "nr_ssd2dev": res.nr_ssd2dev, "nr_ram2dev": res.nr_ram2dev,
                "chunk_ids": list(res.chunk_ids), "landing": res.landing,
                "wait_ns": item.dispatch_ns - item.enqueue_ns}

    # -- KV-cache paging: one shared pool, QoS-scheduled --------------------
    def _op_kv_open(self, sess, msg, fds) -> dict:
        """Open (or join) the daemon's shared KV block pool.  The first
        caller supplies the spill spec; later callers just get the pool
        geometry — one pool, many sequences, every tenant's page
        traffic ordered by the same QoS classes as its DMA.  The first
        caller may ask for ``hbm_blocks`` (None: the HBM tier's share)."""
        with self._lock:
            pool = self._kv_pool
        if pool is None:
            from ..serving.kvcache import KvBlockPool
            spill = self._open_spill(msg.get("spill"), msg)
            try:
                pool = KvBlockPool(
                    self._engine, spill,
                    block_bytes=msg.get("block_bytes"),
                    ram_blocks=int(msg.get("ram_blocks", 16)),
                    hbm_blocks=None if msg.get("hbm_blocks") is None
                    else int(msg["hbm_blocks"]))
            except BaseException:
                spill.close()
                raise
            with self._lock:
                if self._kv_pool is None:
                    self._kv_pool, self._kv_spill = pool, spill
                else:           # racing open won; keep theirs
                    pool.close()
                    spill.close()
                    pool = self._kv_pool
        return {"block_bytes": pool.block_bytes,
                "residency": pool.residency()}

    def _open_spill(self, spec, msg):
        if isinstance(spec, dict):
            if not self._allow_fake:
                raise StromError(_errno.EPERM,
                                 "fake spill needs allow_fake=True")
            from ..testing import FakeNvmeSource, FakeStripedNvmeSource
            if "paths" in spec:
                return FakeStripedNvmeSource(
                    [str(p) for p in spec["paths"]],
                    int(spec["stripe_chunk_size"]),
                    mirror=str(spec.get("mirror") or "none"),
                    writable=True, force_cached_fraction=0.0)
            return FakeNvmeSource(str(spec["path"]), writable=True,
                                  force_cached_fraction=0.0)
        if not spec:
            raise StromError(_errno.EINVAL, "kv_open needs a spill spec")
        from ..engine import open_source
        kw = {k: msg[k] for k in ("stripe_chunk_size", "segment_size",
                                  "mirror") if msg.get(k)}
        return open_source(spec, writable=True, **kw)

    def _op_kv(self, sess, msg, fds) -> dict:
        """One KV-pool operation, admitted and QoS-scheduled exactly
        like a DMA submit (the block's bytes are the shaping weight),
        then answered synchronously — the page-in a latency tenant
        issues overtakes a bulk tenant's queued scan traffic."""
        with self._lock:
            pool = self._kv_pool
        if pool is None:
            raise StromError(_errno.ENXIO, "no KV pool: kv_open first")
        kvop = str(msg.get("kv_op"))
        if kvop not in ("append", "read", "write", "resume", "release",
                        "residency"):
            raise StromError(_errno.EINVAL, f"unknown kv_op {kvop!r}")
        args = {"seq": msg.get("seq"), "idx": msg.get("idx")}
        if msg.get("data") is not None:
            args["data"] = base64.b64decode(msg["data"])
        nbytes = pool.block_bytes if kvop in ("append", "read",
                                              "write") else 0
        with self._lock:
            if (self._quota_tasks
                    and sess.inflight_tasks + 1 > self._quota_tasks) or \
               (self._quota_bytes and nbytes
                    and sess.inflight_bytes + nbytes > self._quota_bytes):
                rejected = True
            else:
                rejected = False
                sess.inflight_tasks += 1
                sess.inflight_bytes += nbytes
                self._next_task += 1
                task_id = self._next_task
        if rejected:
            stats.add("nr_admission_reject")
            stats.tenant_reject(sess.tenant)
            raise StromError(_errno.EAGAIN,
                             f"tenant {sess.tenant} over quota: back off")
        stats.tenant_inflight(sess.tenant, 1, nbytes)
        item = WorkItem(session_id=sess.sid, tenant=sess.tenant,
                        task_id=task_id, source_handle=0, buf_handle=0,
                        chunk_ids=[0], chunk_size=max(1, nbytes),
                        kv=(kvop, args))
        sess.tasks[task_id] = item
        self._sched.enqueue(item)
        stats.gauge_set("qos_queue_depth", self._sched.depth())
        if not item.done.wait(float(msg.get("timeout", 60.0))):
            raise StromError(_errno.ETIMEDOUT, f"kv {kvop} timeout")
        sess.tasks.pop(task_id, None)
        if item.cancelled:
            raise StromError(_errno.ECANCELED, f"kv {kvop} cancelled")
        if item.error is not None:
            raise StromError(item.error[0], item.error[1])
        return dict(item.result)

    def _kv_execute(self, kvop: str, args: dict) -> dict:
        pool = self._kv_pool
        seq = args.get("seq")
        if kvop == "append":
            return {"idx": pool.append(seq, args["data"])}
        if kvop == "read":
            data = pool.read(seq, int(args["idx"]))
            return {"data": base64.b64encode(data).decode("ascii")}
        if kvop == "write":
            pool.write(seq, int(args["idx"]), args["data"])
            return {}
        if kvop == "resume":
            return {"paged_in": pool.resume(seq)}
        if kvop == "release":
            pool.release(seq)
            return {}
        return {"residency": pool.residency()}

    def _op_stat(self, sess, msg, fds) -> dict:
        # the engine's own counts (its native deltas) fold in here
        snap = self._engine.stat_info()
        with self._lock:
            nsess = len(self._sessions)
        return {"counters": snap, "timestamp_ns": time.monotonic_ns(),
                "tenants": stats.tenant_snapshot(), "sessions": nsess,
                "queue_depth": self._sched.depth(),
                "lat_hist": stats.lat_hist_snapshot()}

    # -- dispatch -----------------------------------------------------------
    def _throttled(self, tenant: str) -> None:
        stats.add("nr_qos_throttle")
        stats.tenant_throttle(tenant)
        if _trace.active:
            _trace.instant("qos_throttle", args={"tenant": tenant})

    def _dispatch_loop(self) -> None:
        while not self._closed:
            item = self._sched.next_item(timeout=0.2)
            if item is None:
                continue
            self._execute(item)
            stats.gauge_set("qos_queue_depth", self._sched.depth())

    def _execute(self, item: WorkItem) -> None:
        wait_ns = item.dispatch_ns - item.enqueue_ns
        stats.count_clock("qos_wait", wait_ns)
        if _trace.active:
            _trace.span("qos_wait", item.enqueue_ns, item.dispatch_ns,
                        tid=item.trace_tid,
                        args={"tenant": item.tenant,
                              "session": item.session_id})
        try:
            if item.kv is not None:
                item.result = self._kv_execute(*item.kv)
            else:
                res = self._engine.memcpy_ssd2ram(
                    item.source, item.buf_handle, list(item.chunk_ids),
                    item.chunk_size, dest_offset=item.dest_offset)
                item.result = self._engine.memcpy_wait(res.dma_task_id)
        except StromError as e:
            item.error = (e.errno or _errno.EIO, str(e))
        except Exception as e:          # noqa: BLE001 — must not kill the
            item.error = (_errno.EIO, f"dispatch failed: {e}")  # dispatcher
        finally:
            self._finalize(item)

    def _finalize(self, item: WorkItem) -> None:
        """Single completion path for executed AND cancelled items:
        quota release, tenant accounting, then the done event (last, so a
        waiter observing done sees final accounting)."""
        with self._lock:
            sess = self._sessions.get(item.session_id)
            if sess is not None:
                sess.inflight_tasks -= 1
                sess.inflight_bytes -= item.nbytes
        stats.tenant_inflight(item.tenant, -1, -item.nbytes)
        if item.error is None and not item.cancelled:
            stats.tenant_task(item.tenant, item.nbytes,
                              item.dispatch_ns - item.enqueue_ns)
        item.done.set()

    # -- teardown / reaping -------------------------------------------------
    def _release_session(self, sid: int, *, clean: bool) -> None:
        """Release everything a session holds.  Runs on the connection
        handler's way out — for a clean detach AND for the orphan case
        (crash, SIGKILL, dropped socket), so a dead client can never
        wedge a lane: queued work is cancelled, dispatched work is
        drained, buffer registrations are revoked after the drain, and
        sources close last."""
        with self._lock:
            sess = self._sessions.pop(sid, None)
        if sess is None:
            return
        for item in self._sched.drop_session(sid):
            item.error = (_errno.ECONNRESET, "session torn down")
            self._finalize(item)
        stats.gauge_set("qos_queue_depth", self._sched.depth())
        # dispatched items still run on the engine; wait them out so the
        # buffer revocation below cannot race in-flight DMA
        for item in list(sess.tasks.values()):
            item.done.wait(timeout=60.0)
        for mb in list(sess.buffers.values()):
            mb.release(self._engine)
        sess.buffers.clear()
        for src in list(sess.sources.values()):
            try:
                src.close()
            except (OSError, StromError):
                pass
        sess.sources.clear()
        stats.gauge_add("daemon_sessions", -1)
        stats.add("nr_session_detach" if clean else "nr_session_reap")
        if _trace.active:
            if clean:
                _trace.instant("session_detach",
                               args={"session": sid, "tenant": sess.tenant})
            else:
                _trace.instant("session_reap",
                               args={"session": sid, "tenant": sess.tenant})
