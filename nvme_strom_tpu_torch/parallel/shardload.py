"""Multi-host sharded loading: per-host local reads + on-device shard moves.

A reduced copy of the JAX package's ``parallel/shardload.py``: the
reference's "add another SSD" made into "add another host".  The file's
chunk grid is split by a host→member ownership map
(:func:`..engine.plan_shard_ownership` over :func:`..stripe.host_of`, the
userspace mirror of md-RAID-0 member math, ``kmod/nvme_strom.c:823-910``);
each host reads only its own chunks through its own engine session, the
host's rows land on its group of ring members, and the rows then move
member to member with the ring permute (:func:`.ring.ring_permute_step`,
kernel B4 on a card) until every member holds its file-order row range.

A "host" here is a planning unit: one reader thread and one engine
session, which is also what a real multi-host deployment runs per
process.  On one card the ring's members are N × ``cuda:0``.
"""

from __future__ import annotations

import errno as _errno
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..api import StromError
from ..config import config
from ..engine import Session, Source, plan_shard_ownership, reorder_chunks
from ..hbm.staging import bounded_fence
from ..scan.heap import PAGE_SIZE
from ..stats import stats
from ..trace import recorder as _trace
from .mesh import RingMesh
from .ring import (permute_backend, ring_all_gather, ring_finish,
                   ring_permute_step)

__all__ = ["load_pages_multihost", "shard_ownership"]


def shard_ownership(source: Source, n_hosts: int,
                    *, chunk_size: int = PAGE_SIZE) -> Dict[int, List[int]]:
    """Host → owned chunk ids for the whole of *source*: disjoint,
    exhaustive, member-aligned on striped sources, contiguous ranges on
    single-member ones."""
    n_chunks = source.size // chunk_size
    return plan_shard_ownership(source, range(n_chunks), chunk_size, n_hosts)


def _read_host_shard(host: int, ids: List[int], source: Source,
                     session: Optional[Session]) -> np.ndarray:
    """One host's local read of its chunk list through its own engine
    session; an owned ``(len(ids), PAGE_SIZE)`` array in caller order.
    Traced as a ``shard_load`` span."""
    if not ids:
        return np.empty((0, PAGE_SIZE), np.uint8)
    ts = time.monotonic_ns()
    own = session is None
    sess = session or Session()
    try:
        nbytes = len(ids) * PAGE_SIZE
        handle, buf = sess.alloc_dma_buffer(nbytes)
        try:
            res = sess.memcpy_ssd2ram(source, handle, ids, PAGE_SIZE)
            sess.memcpy_wait(res.dma_task_id)
            rows = np.array(reorder_chunks(
                np.frombuffer(buf.view()[:nbytes], np.uint8), PAGE_SIZE,
                res.chunk_ids, ids)).reshape(len(ids), PAGE_SIZE)
        finally:
            sess.unmap_buffer(handle)
            buf.close()
    finally:
        if own:
            sess.close()
    stats.add("nr_shard_load")
    stats.add("bytes_shard_load", len(ids) * PAGE_SIZE)
    if _trace.active:
        _trace.span("shard_load", ts, time.monotonic_ns(),
                    length=len(ids) * PAGE_SIZE,
                    args={"host": host, "chunks": len(ids)})
    return rows


def _fence(mesh: RingMesh, what: str) -> None:
    if mesh.device_type != "cuda":
        return
    for d in dict.fromkeys(mesh.devices):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        bounded_fence(ev, what)


def _redistribute(data: List[torch.Tensor], idx: List[torch.Tensor],
                  mesh: RingMesh, rows_per_dev: int,
                  backend: Optional[str]) -> List[torch.Tensor]:
    """Each member starts with one padded (data, idx) block of its host's
    pages; the blocks rotate around the ring and every member scatters the
    rows whose file position lands in its own range.  Rows of other
    members (and the -1 padding) scatter into one extra drop row, so the
    write stays dense.  After N − 1 rotations every row has visited its
    destination."""
    n = mesh.size
    outs = [torch.zeros((rows_per_dev + 1, PAGE_SIZE), dtype=torch.uint8,
                        device=d) for d in mesh.devices]
    for s in range(n):
        for i in range(n):
            ids = idx[i].long()
            dest = ids - i * rows_per_dev
            ok = (ids >= 0) & (dest >= 0) & (dest < rows_per_dev)
            outs[i].index_copy_(0, torch.where(ok, dest, rows_per_dev),
                                data[i])
        if s < n - 1:
            data = ring_permute_step(data, ring=n, backend=backend,
                                     finish=False)
            idx = ring_permute_step(idx, ring=n, backend=backend,
                                    finish=False)
    ring_finish(mesh.devices, backend=backend)
    return [o[:rows_per_dev] for o in outs]


def load_pages_multihost(source: Source, mesh: RingMesh, *,
                         hosts: Optional[int] = None,
                         session: Optional[Session] = None,
                         source_factory: Optional[Callable[[int], Source]]
                         = None,
                         backend: Optional[str] = None,
                         gather: bool = False) -> List[torch.Tensor]:
    """Load a page-formatted source through *hosts* sharded engine
    sessions and redistribute it over the ring.

    Phase 1: each host's reader thread submits only its own chunks through
    its own session (``source_factory(h)`` opens that host's view of the
    source; default: share *source*).  Phase 2: the host's rows are split
    over its ``N / hosts`` members and rotate around the ring (``config
    ici_permute`` transport) until every member holds its file-order rows.

    Returns the per-member ``(n_pages / N, PAGE_SIZE)`` shards,
    byte-identical to :func:`.stream.load_pages_sharded` of the same
    source, or with ``gather=True`` one full ``(n_pages, PAGE_SIZE)``
    replica per member.  With the flight recorder on, each host's read is
    a ``shard_load`` span, and the redistribution and the gather are each
    an ``ici_permute`` span (``gather`` in its args for the second).

    On an ``(sp, dp)`` mesh the load runs over lane 0's dp ring and every
    lane's member of dp column *d* holds what lane 0's does (the
    reference's ``P("dp", None)``); *hosts* then divides dp."""
    if mesh.sp > 1:
        return mesh.replicate(load_pages_multihost(
            source, mesh.lane(0), hosts=hosts, session=session,
            source_factory=source_factory, backend=backend, gather=gather))
    if source.size % PAGE_SIZE:
        raise StromError(_errno.EINVAL, f"source size {source.size} not "
                                        f"page-aligned")
    n_pages = source.size // PAGE_SIZE
    n_dev = mesh.size
    if n_pages % n_dev:
        raise StromError(_errno.EINVAL, f"{n_pages} pages not divisible by "
                                        f"{n_dev} ring members; pad the "
                                        f"source")
    hosts = int(hosts or config.get("shard_hosts") or 1)
    if hosts < 1 or n_dev % hosts:
        raise StromError(_errno.EINVAL, f"host count {hosts} must divide the "
                                        f"{n_dev}-member ring")
    rows_per_dev = n_pages // n_dev
    dev_per_host = n_dev // hosts
    owned = shard_ownership(source, hosts)

    # -- phase 1: per-host local reads, one engine session each --------
    host_rows: List[Optional[np.ndarray]] = [None] * hosts
    errors: List[BaseException] = []

    def _run(h: int) -> None:
        src = source_factory(h) if source_factory else source
        try:
            host_rows[h] = _read_host_shard(
                h, owned[h], src,
                session if (session is not None and hosts == 1) else None)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
        finally:
            if source_factory:
                src.close()

    if hosts == 1:
        _run(0)
    else:
        threads = [threading.Thread(target=_run, args=(h,),
                                    name=f"strom-shardload-{h}")
                   for h in range(hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]

    # -- each host's rows onto its group of members, padded ------------
    per_dev = []      # ring position -> (pages, ids)
    for h in range(hosts):
        rows, ids = host_rows[h], owned[h]
        q, r = divmod(len(ids), dev_per_host)
        pos = 0
        for k in range(dev_per_host):
            take = q + (1 if k < r else 0)
            per_dev.append((rows[pos:pos + take], ids[pos:pos + take]))
            pos += take
    rows_max = max(1, max(len(ids) for _, ids in per_dev))
    data, idx = [], []
    for (pages, ids), dev in zip(per_dev, mesh.devices):
        block = torch.zeros((rows_max, PAGE_SIZE), dtype=torch.uint8,
                            device=dev)
        block[:len(ids)].copy_(torch.from_numpy(pages))
        index = torch.full((rows_max,), -1, dtype=torch.int32, device=dev)
        index[:len(ids)].copy_(torch.from_numpy(np.asarray(ids, np.int32)))
        data.append(block)
        idx.append(index)
    del host_rows, per_dev

    # -- phase 2: on-device redistribution -----------------------------
    _fence(mesh, "shard-land")
    transport = permute_backend(backend, device=mesh.device_type)
    ts = time.monotonic_ns()
    out = _redistribute(data, idx, mesh, rows_per_dev, backend)
    del data, idx
    _fence(mesh, "ici-permute")
    moved = (n_dev - 1) * n_dev * rows_max * (PAGE_SIZE + 4)
    stats.add("nr_ici_permute", n_dev - 1)
    stats.add("bytes_ici", moved)
    if _trace.active:
        _trace.span("ici_permute", ts, time.monotonic_ns(), length=moved,
                    args={"steps": n_dev - 1, "ring": n_dev,
                          "backend": transport, "hosts": hosts})
    if not gather:
        return out
    ts = time.monotonic_ns()
    gathered = ring_all_gather(out, mesh, backend=backend)
    _fence(mesh, "ici-gather")
    moved = (n_dev - 1) * n_dev * rows_per_dev * PAGE_SIZE
    stats.add("nr_ici_permute", n_dev - 1)
    stats.add("bytes_ici", moved)
    if _trace.active:
        _trace.span("ici_permute", ts, time.monotonic_ns(), length=moved,
                    args={"steps": n_dev - 1, "ring": n_dev,
                          "backend": transport, "hosts": hosts,
                          "gather": True})
    return gathered
