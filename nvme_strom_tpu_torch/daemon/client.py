"""stromd thin client: the engine-shaped API over the daemon socket.

:class:`DaemonSession` mirrors the in-process engine Session's command
surface — ``alloc_dma_buffer`` / ``open_source`` / ``memcpy_ssd2ram`` /
``memcpy_wait`` / ``unmap_buffer`` / ``stat_info`` — so callers written
against the engine (``ssd2gpu_test``, the scan path) run unmodified
against a shared daemon: swap the constructor, keep the loop.  A port of
the JAX package's ``daemon/client.py``; it speaks the same frames, so it
attaches to either package's daemon.

Destination memory is genuinely shared, not copied: ``alloc_dma_buffer``
backs the buffer with ``memfd_create`` pages, ships the descriptor to the
daemon via SCM_RIGHTS, and the daemon registers its own mapping of the
SAME pages with the engine — DMA completions appear in :meth:`DaemonBuffer
.view` with zero socket traffic (the MAP_GPU_MEMORY handle-passing analog).

This module stays import-light on purpose (no engine, no torch, no numpy):
a subprocess client in the SIGKILL-reap test must start in milliseconds,
and a monitoring tool must not drag the whole engine in to ping a socket.
"""

from __future__ import annotations

import errno as _errno
import mmap
import os
import socket
import threading
from typing import List, Optional, Tuple

from ..api import MemCopyResult, StromError
from ..config import config
from .protocol import PROTOCOL_VERSION, Framer, default_socket_path, send_msg

__all__ = ["DaemonBuffer", "DaemonSource", "DaemonSession"]


class DaemonBuffer:
    """Client-side shared DMA destination: memfd pages both processes map.

    ``view()`` exposes the bytes the daemon's engine lands into; ``close``
    is idempotent and the session closes any still-registered buffers on
    teardown, so leak-free either way."""

    def __init__(self, length: int):
        if length <= 0:
            raise StromError(_errno.EINVAL, f"bad buffer length {length}")
        self.length = int(length)
        self._fd = os.memfd_create("strom-daemon-buf")
        try:
            os.ftruncate(self._fd, self.length)
            self._mm = mmap.mmap(self._fd, self.length)
        except BaseException:
            os.close(self._fd)
            raise
        self._open = True

    def fileno(self) -> int:
        return self._fd

    def view(self) -> memoryview:
        return memoryview(self._mm)

    def close(self) -> None:
        if not self._open:
            return
        self._open = False
        try:
            self._mm.close()
        except BufferError:
            pass    # live view()s pin the mapping; it unmaps when they die
        try:
            os.close(self._fd)
        except OSError:
            pass


class DaemonSource:
    """Handle to a source the daemon opened on this session's behalf.
    The opening spec rides along so :meth:`DaemonSession.reattach` can
    re-open it against a restarted daemon (``handle`` is updated in
    place — callers keep using the same object)."""

    def __init__(self, sess: "DaemonSession", handle: int, size: int,
                 spec=None, kw=None):
        self._sess = sess
        self.handle = handle
        self.size = int(size)
        self._spec = spec
        self._kw = dict(kw or {})

    def close(self) -> None:
        self._sess._close_source(self.handle)


class DaemonSession:
    """One attached client session.

    Thread-safe the way the engine Session is: one lock serializes the
    socket (request/reply protocol — one RPC in flight per session), and
    submitted tasks are waited via their daemon task id, so a submit-ahead
    /wait-behind pipeline works exactly as against the engine."""

    def __init__(self, socket_path: Optional[str] = None, *,
                 tenant: Optional[str] = None,
                 qos_class: Optional[str] = None,
                 weight: Optional[float] = None,
                 rate: Optional[float] = None,
                 timeout: float = 30.0):
        path = socket_path or config.get("daemon_socket") \
            or default_socket_path()
        self._path = path
        self._timeout = timeout
        self._lock = threading.Lock()
        self._closed = False
        self._buffers: dict = {}
        self._server_handle: dict = {}   # caller handle -> current server
        self._sources: dict = {}         # id(src) -> DaemonSource
        self.tenant = tenant or f"pid{os.getpid()}"
        self._qos_class = qos_class
        self._weight = weight
        self._rate = rate
        self.lease: Optional[str] = None
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self._sock.settimeout(timeout)
            self._sock.connect(path)
            self._framer = Framer(self._sock)
            reply = self._rpc(self._attach_msg())
        except BaseException:
            self._sock.close()
            raise
        self.session_id = int(reply["session"])
        self.lease = reply.get("lease")

    def _attach_msg(self) -> dict:
        attach = {"op": "attach", "version": PROTOCOL_VERSION,
                  "tenant": self.tenant, "pid": os.getpid()}
        if self._qos_class is not None:
            attach["class"] = self._qos_class
        if self._weight is not None:
            attach["weight"] = float(self._weight)
        if self._rate is not None:
            attach["rate"] = float(self._rate)
        if self.lease is not None:
            attach["lease"] = self.lease
        return attach

    def reattach(self, socket_path: Optional[str] = None) -> bool:
        """Reconnect after a dropped connection or daemon restart,
        presenting the lease token from the original attach.  Mapped
        buffers are re-shipped (same memfd pages — the data survives)
        and sources re-opened in place, so caller-held handles keep
        working; returns True when the daemon still knew the lease
        (reconnect) and False when it adopted it fresh (restart —
        replay unacked submits with their ``submit_id``s; dedup makes
        the replay idempotent either way)."""
        if self.lease is None:
            raise StromError(_errno.EINVAL, "no lease to present")
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self._timeout)
        sock.connect(socket_path or self._path)
        with self._lock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = sock
            self._framer = Framer(sock)
            self._closed = False
        reply = self._rpc(self._attach_msg())
        with self._lock:
            self.session_id = int(reply["session"])
            self.lease = reply.get("lease", self.lease)
            buffers = dict(self._buffers)
        for handle, buf in buffers.items():
            mapped = self._rpc({"op": "map", "length": buf.length},
                               fds=(buf.fileno(),))
            with self._lock:
                self._server_handle[handle] = int(mapped["handle"])
        for src in list(self._sources.values()):
            if src._spec is None:
                continue
            msg = {"op": "open", "spec": src._spec}
            msg.update(src._kw)
            opened = self._rpc(msg)
            src.handle = int(opened["handle"])
        return bool(reply.get("reattach"))

    # -- plumbing -----------------------------------------------------------
    def _rpc(self, msg: dict, fds: Tuple[int, ...] = ()) -> dict:
        with self._lock:
            if self._closed:
                raise StromError(_errno.EBADF, "session closed")
            send_msg(self._sock, msg, fds)
            got = self._framer.recv()
        if got is None:
            raise StromError(_errno.ECONNRESET,
                             "daemon closed the connection")
        reply, stray = got
        for fd in stray:        # this protocol never sends fds back
            os.close(fd)
        if not reply.get("ok"):
            raise StromError(int(reply.get("errno", _errno.EIO)),
                             reply.get("error", "daemon error"))
        return reply

    # -- engine-shaped API --------------------------------------------------
    def ping(self) -> bool:
        return bool(self._rpc({"op": "ping"}).get("pong"))

    def configure(self, *, qos_class: Optional[str] = None,
                  weight: Optional[float] = None,
                  rate: Optional[float] = None) -> dict:
        msg = {"op": "configure"}
        if qos_class is not None:
            msg["class"] = qos_class
        if weight is not None:
            msg["weight"] = float(weight)
        if rate is not None:
            msg["rate"] = float(rate)
        return self._rpc(msg)

    def alloc_dma_buffer(self, length: int, *,
                         numa_node: int = -1) -> Tuple[int, DaemonBuffer]:
        """Engine ``alloc_dma_buffer`` analog: returns (daemon buffer
        handle, shared :class:`DaemonBuffer`).  *numa_node* is accepted
        for signature parity; placement is the daemon's concern."""
        buf = DaemonBuffer(length)
        try:
            reply = self._rpc({"op": "map", "length": buf.length},
                              fds=(buf.fileno(),))
        except BaseException:
            buf.close()
            raise
        handle = int(reply["handle"])
        with self._lock:
            self._buffers[handle] = buf
            self._server_handle[handle] = handle
        return handle, buf

    def unmap_buffer(self, handle: int, *, wait: bool = True,
                     timeout: float = 30.0) -> None:
        with self._lock:
            server = self._server_handle.get(handle, handle)
        self._rpc({"op": "unmap", "handle": int(server)})
        with self._lock:
            buf = self._buffers.pop(handle, None)
            self._server_handle.pop(handle, None)
        if buf is not None:
            buf.close()

    def open_source(self, spec, **kw) -> DaemonSource:
        """Open a source daemon-side.  *spec* is a path/url string (the
        engine ``open_source`` forms) or — against an ``allow_fake``
        daemon — a dict naming the loopback test source."""
        msg = {"op": "open", "spec": spec}
        for k in ("stripe_chunk_size", "segment_size", "mirror"):
            if kw.get(k) is not None:
                msg[k] = kw[k]
        reply = self._rpc(msg)
        src = DaemonSource(self, int(reply["handle"]), reply["size"],
                           spec=spec,
                           kw={k: v for k, v in msg.items()
                               if k not in ("op", "spec")})
        with self._lock:
            self._sources[id(src)] = src
        return src

    def _close_source(self, handle: int) -> None:
        self._rpc({"op": "close_source", "handle": int(handle)})
        with self._lock:
            for key, src in list(self._sources.items()):
                if src.handle == handle:
                    del self._sources[key]
                    break

    def memcpy_ssd2ram(self, source: DaemonSource, buf_handle: int,
                       chunk_ids: List[int], chunk_size: int, *,
                       dest_offset: int = 0, wb_buffer=None,
                       submit_id: Optional[str] = None) -> MemCopyResult:
        """Submit one DMA command through the daemon's QoS queue.

        Returns the submit-time result (task id + preliminary routing,
        like the engine's async submit); :meth:`memcpy_wait` returns the
        authoritative result including the engine's chunk reordering.
        *submit_id* is the idempotency key for replay after
        :meth:`reattach`: resubmitting the same id to a daemon that
        already holds the task returns the live task instead of
        double-running it."""
        ids = [int(c) for c in chunk_ids]
        with self._lock:
            server_buf = self._server_handle.get(int(buf_handle),
                                                 int(buf_handle))
        msg = {"op": "submit", "source": source.handle,
               "buffer": server_buf, "chunk_ids": ids,
               "chunk_size": int(chunk_size),
               "dest_offset": int(dest_offset)}
        if submit_id is not None:
            msg["submit_id"] = str(submit_id)
        reply = self._rpc(msg)
        return MemCopyResult(dma_task_id=int(reply["task_id"]),
                             nr_chunks=len(ids), nr_ssd2dev=len(ids),
                             nr_ram2dev=0, chunk_ids=ids)

    def memcpy_wait(self, task_id: int,
                    timeout: Optional[float] = None) -> MemCopyResult:
        msg = {"op": "wait", "task_id": int(task_id)}
        if timeout is not None:
            msg["timeout"] = float(timeout)
        reply = self._rpc(msg)
        return MemCopyResult(dma_task_id=int(reply["task_id"]),
                             nr_chunks=int(reply["nr_chunks"]),
                             nr_ssd2dev=int(reply["nr_ssd2dev"]),
                             nr_ram2dev=int(reply["nr_ram2dev"]),
                             chunk_ids=[int(c) for c in reply["chunk_ids"]],
                             landing=reply.get("landing", ""))

    def stat_info(self, *, debug: bool = False) -> dict:
        """The daemon's counters, as the engine Session's ``stat_info``."""
        return dict(self._rpc({"op": "stat", "debug": debug})["counters"])

    # -- KV-cache paging ----------------------------------------------------
    def kv_open(self, spill, *, block_bytes: Optional[int] = None,
                ram_blocks: int = 16, hbm_blocks: Optional[int] = None,
                **kw) -> dict:
        """Open (or join) the daemon's shared KV block pool.  *spill* is
        a writable source spec — a path/path-list, or a dict naming a
        fake spill against an ``allow_fake`` daemon.  *hbm_blocks* pins
        that many blocks in the daemon's HBM tier (None: the tier's
        share)."""
        msg = {"op": "kv_open", "spill": spill, "ram_blocks": ram_blocks}
        if block_bytes is not None:
            msg["block_bytes"] = int(block_bytes)
        if hbm_blocks is not None:
            msg["hbm_blocks"] = int(hbm_blocks)
        for k in ("stripe_chunk_size", "segment_size", "mirror"):
            if kw.get(k) is not None:
                msg[k] = kw[k]
        return self._rpc(msg)

    def _kv(self, kv_op: str, **fields) -> dict:
        msg = {"op": "kv", "kv_op": kv_op}
        msg.update({k: v for k, v in fields.items() if v is not None})
        return self._rpc(msg)

    def kv_append(self, seq, data) -> int:
        import base64
        return int(self._kv("append", seq=seq,
                            data=base64.b64encode(bytes(data))
                            .decode("ascii"))["idx"])

    def kv_read(self, seq, idx: int) -> bytes:
        import base64
        return base64.b64decode(self._kv("read", seq=seq,
                                         idx=int(idx))["data"])

    def kv_write(self, seq, idx: int, data) -> None:
        import base64
        self._kv("write", seq=seq, idx=int(idx),
                 data=base64.b64encode(bytes(data)).decode("ascii"))

    def kv_resume(self, seq) -> int:
        return int(self._kv("resume", seq=seq)["paged_in"])

    def kv_release(self, seq) -> None:
        self._kv("release", seq=seq)

    def kv_residency(self) -> dict:
        return self._kv("residency")["residency"]

    def daemon_stat(self, *, debug: bool = False) -> dict:
        """Full daemon scoreboard: counters + per-tenant table + session
        count + queue depth."""
        return self._rpc({"op": "stat", "debug": debug})

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            bufs, self._buffers = dict(self._buffers), {}
            try:
                send_msg(self._sock, {"op": "detach"})
                self._framer.recv()
            except (OSError, StromError):
                pass            # daemon already gone: nothing to detach
            try:
                self._sock.close()
            except OSError:
                pass
        for buf in bufs.values():
            buf.close()

    def __enter__(self) -> "DaemonSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
