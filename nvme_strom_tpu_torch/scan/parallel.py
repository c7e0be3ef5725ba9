"""Multi-worker parallel scan: one chunk cursor shared across processes.

A port of the JAX package's ``scan/parallel.py``, the analog of the pgsql
Gather integration (`pgsql/nvme_strom.c:582-595,1057-1112`): a DSM segment
carries the scan descriptor (the relation, its block count, a shared
atomic cursor, shared DMA counters) and every worker claims disjoint block
ranges from it.  Here the cursor lives in ``multiprocessing.shared_memory``
and the workers are processes, each running its own
:class:`~.executor.TableScanner` (its own :class:`~..engine.Session` and
pinned ring) against the shared cursor.

``Query(..., workers=N).run()`` (or ``run(workers=N)``) ships a picklable
spec (the filter's :class:`~..ops.filter.FilterPred` terms, the
structured filter, the terminal, the route the leader's plan chose, the
leader's device and config, resolved GROUP BY keys) to N processes
started with ``spawn`` through :func:`run_query_workers`; each rebuilds the
query (``Query._from_worker_spec``), scans the chunks it claims, and
returns numpy partials, which the leader folds (``Query._run_workers``).
``spawn`` because ``fork`` is unusable once the leader has touched CUDA;
numpy because a CUDA tensor sent through a queue travels by CUDA IPC and
dies with the worker that made it.
"""

from __future__ import annotations

import errno as _errno
import multiprocessing as mp
import os
import queue as _queue
import struct
import time
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

from ..api import StromError

__all__ = ["SharedCursor", "run_query_workers", "parallel_scan"]

_HDR = struct.Struct("<qq")  # next_chunk, n_chunks


class SharedCursor:
    """Cross-process atomic chunk cursor (the DSM ``nsp_cblock`` analog),
    with :class:`~.executor.LocalCursor`'s ``claim`` contract.

    Safe under ``spawn``: workers re-attach by name and share the lock the
    leader passes them."""

    def __init__(self, n_chunks: int, *, name: Optional[str] = None,
                 create: bool = True, lock=None):
        if create:
            self._shm = shared_memory.SharedMemory(create=True,
                                                   size=_HDR.size)
            _HDR.pack_into(self._shm.buf, 0, 0, n_chunks)
        else:
            if name is None:
                raise ValueError("attaching to a SharedCursor needs its name")
            self._shm = shared_memory.SharedMemory(name=name)
        self._lock = lock if lock is not None else mp.Lock()
        self.name = self._shm.name

    @property
    def n_chunks(self) -> int:
        return _HDR.unpack_from(self._shm.buf, 0)[1]

    def claim(self, count: int) -> Tuple[int, int]:
        """Claim up to *count* chunks; returns (first, n), n == 0 at end."""
        with self._lock:
            nxt, total = _HDR.unpack_from(self._shm.buf, 0)
            n = min(count, total - nxt)
            if n <= 0:
                return nxt, 0
            _HDR.pack_into(self._shm.buf, 0, nxt + n, total)
            return nxt, n

    def reset(self) -> None:
        """Rewind for a rescan (ExecReScan in parallel mode reinitialises
        the DSM block counter)."""
        with self._lock:
            _, total = _HDR.unpack_from(self._shm.buf, 0)
            _HDR.pack_into(self._shm.buf, 0, 0, total)

    def close(self, *, unlink: bool = False) -> None:
        self._shm.close()
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


def _query_worker(spec: dict, cursor_name: str, lock, start, out_q) -> None:
    """Worker entry (a spawned process): mirror the leader's config,
    rebuild the query from the spec, wait at the *start* barrier until
    every worker has its device up, scan shared-cursor chunks, report the
    numpy partial."""
    if spec.get("_test_crash_worker"):
        # test hook: die like an OOM kill or a segfault, with no report and
        # no clean-up, so the leader's death detection can be tested
        os._exit(42)
    cursor = None
    try:
        from ..config import config
        config.restore(spec["config"])
        # the x64 switch sets the accumulators' widths (acc_dtypes)
        config.set("x64", bool(spec.get("x64")))
        cursor = SharedCursor(0, name=cursor_name, create=False, lock=lock)
        from .query import Query
        q = Query._from_worker_spec(spec)
        out_q.put(("ok", q._run_worker_partial(
            spec, cursor, ready=lambda: start.wait(spec["timeout_s"]))))
    except BaseException as e:  # noqa: BLE001 — a worker always reports
        start.abort()       # the others stop waiting for this one
        out_q.put(("err", repr(e)))
    finally:
        if cursor is not None:
            cursor.close()


def run_query_workers(spec: dict, n_workers: int, *,
                      timeout_s: float = 600.0) -> List[dict]:
    """Fan *spec* out to *n_workers* spawned processes sharing one cursor;
    returns each worker's partial (the leader folds them).  The cursor is
    sized by :func:`.executor.cursor_chunk_count`, the formula a
    ``TableScanner`` sizes its own cursor with.  A worker that dies
    without reporting fails the call within seconds; so does a worker's
    exception, with its ``repr``.  The workers start claiming together
    (a barrier after each has its device up), so the first to start does
    not scan a small table alone."""
    from .executor import cursor_chunk_count
    if n_workers < 2:
        raise ValueError("run_query_workers needs >= 2 workers")
    if not isinstance(spec["source"], str):
        raise StromError(_errno.EINVAL, "workers: a parallel scan takes one "
                                        "table file path")
    size = os.path.getsize(spec["source"])
    total = cursor_chunk_count(size, spec["chunk_size"])
    ctx = mp.get_context("spawn")
    lock = ctx.Lock()
    start = ctx.Barrier(n_workers)
    spec = dict(spec, timeout_s=timeout_s)
    cursor = SharedCursor(total, lock=lock)
    q = ctx.Queue()
    procs = [ctx.Process(target=_query_worker,
                         args=(spec, cursor.name, lock, start, q))
             for _ in range(n_workers)]
    try:
        for p in procs:
            p.start()
        results: List[dict] = []
        errors: List[str] = []
        # poll rather than block: a worker killed by the OOM killer (or a
        # segfault) never reports, and one long get would sit out the
        # whole deadline.  Short gets and liveness checks surface the
        # death in seconds, with a grace window for the queue's feeder
        # thread to flush a report that raced the exit.
        deadline = time.monotonic() + timeout_s
        grace_until = None
        while len(results) + len(errors) < len(procs):
            try:
                kind, payload = q.get(timeout=0.25)
            except _queue.Empty:
                now = time.monotonic()
                reported = len(results) + len(errors)
                if now > deadline:
                    raise RuntimeError(
                        f"parallel scan timed out after {timeout_s:.0f}s: "
                        f"{len(procs) - reported} worker(s) never reported")
                alive = sum(p.is_alive() for p in procs)
                if alive < len(procs) - reported:
                    if grace_until is None:
                        grace_until = now + 2.0
                    elif now > grace_until:
                        dead = [(p.pid, p.exitcode) for p in procs
                                if not p.is_alive()]
                        raise RuntimeError(
                            "parallel scan worker died without reporting "
                            f"(pid, exitcode of exited workers: {dead}); "
                            f"{reported}/{len(procs)} partials received")
                else:
                    grace_until = None
                continue
            (results if kind == "ok" else errors).append(payload)
        for p in procs:
            p.join(timeout=60)
        if errors:
            raise RuntimeError(f"parallel scan worker failed: {errors[0]}")
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        q.close()
        cursor.close(unlink=True)


def parallel_scan(path: str, *, n_workers: int = 2,
                  chunk_size: int = 1 << 20, threshold: int = 0,
                  device=None) -> dict:
    """The demo face: scan *path* (a two-column heap table) with
    *n_workers* processes sharing one cursor, counting rows with ``col0 >
    threshold`` and summing ``col1`` over them, through ``Query(...,
    workers=N)``.  Returns ``{"count", "sum", "workers"}``."""
    from ..config import config
    from .heap import HeapSchema
    from .query import Query
    schema = HeapSchema(n_cols=2, visibility=True)
    q = Query(path, schema).where_range(0, threshold + 1, None) \
        .aggregate(cols=[1])
    prev = config.get("chunk_size")
    config.set("chunk_size", chunk_size)
    try:
        out = q.run(workers=n_workers, device=device)
    finally:
        config.set("chunk_size", prev)
    return {"count": int(out["count"]), "sum": int(out["sums"][0]),
            "workers": n_workers}
