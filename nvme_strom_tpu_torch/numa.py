"""NUMA topology discovery and affinity binding.

The port's own copy of the JAX package's ``numa``.  Capability analog of
the reference's NUMA handling: the kernel module reports the SSD's NUMA
node from the device (`kmod/nvme_strom.c:316-328`); ``ssd2ram_test``
parses the node's sysfs cpulist and binds the process CPU affinity to it
(`utils/ssd2ram_test.c:66-119`); the pgsql extension binds the backend
during scans and round-robins DMA buffers across allowed nodes
(`pgsql/nvme_strom.c:353-446,1126-1181`).  ``os.sched_setaffinity(0, ...)``
binds the calling thread: a scan binds the thread that drives it.

Everything here degrades gracefully on machines without NUMA sysfs (returns
node 0 / no-ops), which also covers containers.  Users: config
``numa_policy`` (the engine's ``Session._pin_lanes``), config
``numa_node_mask`` (:class:`.scan.pool.DmaBufferPool`'s per-node
freelists) and ``TableScanner(numa_bind=True)``.
"""

from __future__ import annotations

import os
from typing import List, Optional

__all__ = [
    "device_numa_node", "nodes_with_memory", "node_cpus", "bind_to_node",
    "parse_cpulist", "allowed_nodes",
]

_SYS_NODE = "/sys/devices/system/node"


def parse_cpulist(text: str) -> List[int]:
    """Parse sysfs cpulist syntax: '0-3,8,10-11'."""
    cpus: List[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            cpus.extend(range(int(lo), int(hi) + 1))
        else:
            cpus.append(int(part))
    return cpus


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def device_numa_node(path: str) -> int:
    """NUMA node of the block device backing *path* (kmod/nvme_strom.c:316-328
    analog), via the eligibility classifier's sysfs walk.  Returns -1 for
    unknown or spans-nodes — callers must never bind to a negative node
    (bind_to_node guards this)."""
    from .eligibility import probe_backing
    return probe_backing(path).numa_node_id


def nodes_with_memory() -> List[int]:
    """Nodes that actually have memory (pgsql/nvme_strom.c:1126-1181 reads
    sysfs ``has_memory``)."""
    text = _read(os.path.join(_SYS_NODE, "has_memory")) or \
        _read(os.path.join(_SYS_NODE, "online"))
    if text:
        return parse_cpulist(text)
    return [0]


def node_cpus(node: int) -> List[int]:
    text = _read(os.path.join(_SYS_NODE, f"node{node}", "cpulist"))
    if text:
        return parse_cpulist(text)
    return list(range(os.cpu_count() or 1))


def bind_to_node(node: int) -> bool:
    """Bind the calling thread's CPU affinity to *node*'s CPUs
    (utils/ssd2ram_test.c:66-119 analog).  Returns True on success, False
    when the node is unknown or the kernel refuses the set.

    node < 0 means unknown or spans-nodes (RAID0 across sockets,
    kmod/nvme_strom.c:322-326): never touch affinity for those."""
    if node < 0:
        return False
    cpus = node_cpus(node)
    if not cpus:
        return False
    try:
        os.sched_setaffinity(0, cpus)
        return True
    except (OSError, AttributeError):
        return False


def allowed_nodes(mask: int) -> List[int]:
    """Intersect a numa_node_mask config bitmask with nodes that have memory
    (pgsql/nvme_strom.c:1126-1181 analog).  mask == -1 means all."""
    nodes = nodes_with_memory()
    if mask == -1:
        return nodes
    return [n for n in nodes if mask & (1 << n)] or nodes
