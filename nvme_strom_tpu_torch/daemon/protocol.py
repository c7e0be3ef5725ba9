"""stromd wire protocol: versioned, length-prefixed JSON frames over a
Unix domain socket, with SCM_RIGHTS file-descriptor passing.

A copy of the JAX package's ``daemon/protocol.py``, frame for frame: a
client of either package talks to a daemon of either.

The reference's IPC boundary is the ``/proc/nvme-strom`` ioctl entry —
fixed-layout argument structs, a version handshake via
``STROM_IOCTL__CHECK_FILE``'s ABI, and fd-based resource passing (the
caller's file descriptor IS the ioctl argument).  Here the boundary is a
SOCK_STREAM Unix socket:

* every message is ``!I`` big-endian length + a JSON object body;
* the FIRST client message must be ``{"op": "attach", "version": N}`` —
  a version mismatch fails closed (EPROTO reply, connection dropped)
  before any resource is touched;
* shared memory travels as SCM_RIGHTS descriptors (the client's
  ``memfd_create`` region is the MAP_GPU_MEMORY analog: the daemon mmaps
  the SAME pages and registers them with the engine, so DMA lands
  directly in client-visible memory with no socket copy);
* replies are ``{"ok": true, ...}`` or ``{"ok": false, "errno": n,
  "error": msg}`` — the client re-raises the errno as a
  :class:`~nvme_strom_tpu_torch.api.StromError`, preserving the reference's
  -errno error model across the process boundary.
"""

from __future__ import annotations

import errno as _errno
import json
import os
import socket
import struct
import tempfile
from typing import List, Optional, Tuple

from ..api import StromError

__all__ = ["PROTOCOL_VERSION", "MAX_FRAME", "MAX_FDS_PER_FRAME",
           "default_socket_path", "send_msg", "Framer"]

#: bumped on any incompatible message-schema change; the attach handshake
#: pins it on both sides (tests drive the mismatch path)
PROTOCOL_VERSION = 1

#: ceiling on one frame body — a corrupt/hostile length prefix must not
#: make the daemon allocate unbounded memory
MAX_FRAME = 16 << 20

#: descriptors accepted per recv segment (one buffer fd per map op today)
MAX_FDS_PER_FRAME = 8

_LEN = struct.Struct("!I")


def default_socket_path(uid: Optional[int] = None) -> str:
    """Per-uid default socket path (the ``/proc/nvme-strom`` well-known
    entry analog; per-uid so unprivileged test runs cannot collide)."""
    return os.path.join(tempfile.gettempdir(),
                        f"stromd.{os.getuid() if uid is None else uid}.sock")


def send_msg(sock: socket.socket, obj: dict, fds: Tuple[int, ...] = ()) -> None:
    """Send one framed message, attaching *fds* via SCM_RIGHTS on the
    first segment (ancillary data rides exactly one sendmsg)."""
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise StromError(_errno.EMSGSIZE,
                         f"frame body {len(body)} exceeds {MAX_FRAME}")
    data = _LEN.pack(len(body)) + body
    if fds:
        sent = socket.send_fds(sock, [data], list(fds))
    else:
        sent = sock.send(data)
    while sent < len(data):
        sent += sock.send(data[sent:])


class Framer:
    """Buffered frame reader for one connection.

    Accumulates stream bytes and any SCM_RIGHTS descriptors arriving with
    them; descriptors are attributed to the frame whose body completes on
    (or after) the segment that carried them — sufficient for this
    protocol, where the sender attaches fds to the frame's own first
    segment.  The caller owns returned fds (must close them).
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()
        self._fds: List[int] = []

    def recv(self) -> Optional[Tuple[dict, List[int]]]:
        """Next (message, fds) pair, or None on clean EOF.  Raises
        :class:`StromError` (EPROTO) on a malformed frame."""
        while True:
            if len(self._buf) >= _LEN.size:
                (n,) = _LEN.unpack_from(self._buf)
                if n > MAX_FRAME:
                    self._drop_fds()
                    raise StromError(_errno.EPROTO,
                                     f"frame length {n} exceeds {MAX_FRAME}")
                if len(self._buf) >= _LEN.size + n:
                    body = bytes(self._buf[_LEN.size:_LEN.size + n])
                    del self._buf[:_LEN.size + n]
                    fds, self._fds = self._fds, []
                    try:
                        msg = json.loads(body.decode("utf-8"))
                    except (UnicodeDecodeError, json.JSONDecodeError) as e:
                        for fd in fds:
                            os.close(fd)
                        raise StromError(_errno.EPROTO,
                                         f"undecodable frame: {e}") from None
                    if not isinstance(msg, dict):
                        for fd in fds:
                            os.close(fd)
                        raise StromError(_errno.EPROTO,
                                         "frame body is not an object")
                    return msg, fds
            try:
                data, fds, _flags, _addr = socket.recv_fds(
                    self._sock, 1 << 16, MAX_FDS_PER_FRAME)
            except OSError as e:
                self._drop_fds()
                if e.errno in (_errno.ECONNRESET, _errno.EPIPE):
                    return None
                raise
            if fds:
                self._fds.extend(fds)
            if not data:
                # EOF mid-frame loses nothing the peer still owns; any
                # stray descriptors must not leak into this process
                self._drop_fds()
                return None
            self._buf += data

    def _drop_fds(self) -> None:
        fds, self._fds = self._fds, []
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass
