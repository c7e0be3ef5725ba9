"""stromd: the shared serving daemon (the JAX package's ``daemon/``).

One daemon owns the engine; clients attach over a Unix socket with an
explicit session lifecycle, admission control and per-tenant QoS
(:mod:`.server`, :mod:`.qos`), and land DMA in shared memfd pages
(:mod:`.client`).  The frames are the JAX package's (:mod:`.protocol`),
so a client of either package attaches to a daemon of either.

This namespace stays import-light (protocol and client only): a client
subprocess or a monitoring tool must not pull in the engine's threads or
torch just to talk to a socket.  The server imports explicitly: ``from
nvme_strom_tpu_torch.daemon.server import StromDaemon``.
"""

from .client import DaemonBuffer, DaemonSession, DaemonSource
from .protocol import PROTOCOL_VERSION, default_socket_path

__all__ = ["DaemonBuffer", "DaemonSession", "DaemonSource",
           "PROTOCOL_VERSION", "default_socket_path"]
