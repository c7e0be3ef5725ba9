"""The RAM-tier gate: the JAX package's ``testing/cache_gate.py``.

Holds the RAM tier's three contracts on seeded synthetics:

* **Speedup** — with a per-request latency injected into the loopback
  fake, a hot rescan (every chunk a RAM-tier hit, no submission) beats
  the cold scan by at least ``STROM_CACHE_GATE_RATIO`` (default 2x).  The
  cold pass pays the injected latency a chunk and the hot one is a copy,
  so the ratio is latency-bound and holds on any host.
* **Eviction identity** — with the capacity far below the table, both
  passes churn the ARC lists and stay byte-identical to the pattern.
* **Write-back coherency** — an extent written by ``memcpy_ram2ssd`` is
  dropped from the tier and the next read returns the new bytes.

The Sessions are built on the device the gate names (default ``cuda:0``:
their staging buffers are registered with the CUDA runtime); ``-d cpu``
runs it on the host.

Usage: python -m nvme_strom_tpu_torch.testing.cache_gate [-d DEVICE]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

RATIO_LIMIT = float(os.environ.get("STROM_CACHE_GATE_RATIO", "2.0"))
ROUNDS = int(os.environ.get("STROM_CACHE_GATE_ROUNDS", "3"))

CHUNK = 64 << 10

__all__ = ["main", "RATIO_LIMIT"]


def _read_pass(sess, src, nchunks: int) -> bytes:
    """The first *nchunks* chunks of *src*, in the source's order: the
    tiers' hits land after the submitted chunks, so the slots are put
    back by the result's ``chunk_ids``."""
    import numpy as np

    from ..engine import reorder_chunks
    want = list(range(nchunks))
    handle, buf = sess.alloc_dma_buffer(nchunks * CHUNK)
    try:
        res = sess.memcpy_ssd2ram(src, handle, want, CHUNK)
        sess.memcpy_wait(res.dma_task_id, timeout=120.0)
        return bytes(reorder_chunks(
            np.frombuffer(buf.view()[:nchunks * CHUNK], np.uint8), CHUNK,
            res.chunk_ids, want))
    finally:
        sess.unmap_buffer(handle)


def _arm(config, cache_bytes: int) -> None:
    config.set("cache_bytes", cache_bytes)
    config.set("cache_arbitration", False)
    config.set("dma_max_size", CHUNK)   # one tier decision a chunk


def _leg_speedup(dirpath: str, device) -> None:
    """Hot rescan >= RATIO_LIMIT x cold on the latency-injected fake."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from .fake import FakeNvmeSource, FaultPlan, expected_bytes, \
        make_test_file

    nchunks, lat = 24, 0.002
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "speed.bin")
    make_test_file(path, size)
    _arm(config, 64 << 20)
    src = FakeNvmeSource(path, fault_plan=FaultPlan(latency_s=lat),
                         force_cached_fraction=0.0)
    cold, hot = [], []
    try:
        with Session(device=device) as sess:
            for r in range(ROUNDS):
                residency_cache.clear()
                t0 = time.perf_counter()
                got_cold = _read_pass(sess, src, nchunks)
                cold.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                got_hot = _read_pass(sess, src, nchunks)
                hot.append(time.perf_counter() - t0)
                assert got_cold == expected_bytes(0, size), \
                    f"cold pass bytes diverged (round {r})"
                assert got_hot == expected_bytes(0, size), \
                    f"hot pass bytes diverged (round {r})"
    finally:
        src.close()
    c, h = statistics.median(cold), statistics.median(hot)
    ratio = c / h if h > 0 else float("inf")
    assert ratio >= RATIO_LIMIT, \
        f"hot rescan only {ratio:.2f}x cold (limit {RATIO_LIMIT}x; " \
        f"cold {c * 1e3:.1f} ms, hot {h * 1e3:.1f} ms)"
    print(f"cache-gate speedup leg ok: hot {ratio:.1f}x cold (cold "
          f"{c * 1e3:.1f} ms, hot {h * 1e3:.1f} ms, {ROUNDS} interleaved "
          f"rounds)")


def _leg_eviction_identity(dirpath: str, device) -> int:
    """Capacity a quarter of the table: constant ARC churn, bytes
    identical.  Returns the evictions."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from ..stats import stats
    from .fake import FakeNvmeSource, expected_bytes, make_test_file

    nchunks = 16
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "evict.bin")
    make_test_file(path, size)
    _arm(config, 4 * CHUNK)
    src = FakeNvmeSource(path, force_cached_fraction=0.0)
    before = stats.snapshot().get("nr_cache_evict", 0)
    try:
        with Session(device=device) as sess:
            for r in range(3):
                got = _read_pass(sess, src, nchunks)
                assert got == expected_bytes(0, size), \
                    f"bytes diverged under eviction pressure (pass {r})"
    finally:
        src.close()
    evicted = stats.snapshot().get("nr_cache_evict", 0) - before
    assert evicted > 0, "the eviction leg never evicted"
    resident = residency_cache.resident_bytes()
    assert resident <= 4 * CHUNK, \
        f"resident {resident} exceeds the capacity {4 * CHUNK}"
    print(f"cache-gate eviction leg ok: {evicted} evictions, bytes "
          f"identical, resident {resident} <= capacity")
    return evicted


def _leg_writeback_invalidation(dirpath: str, device) -> int:
    """A written extent is never served stale after memcpy_ram2ssd.
    Returns the invalidations."""
    from ..config import config
    from ..engine import Session, open_source
    from ..stats import stats
    from .fake import expected_bytes, make_test_file

    nchunks = 8
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "wb.bin")
    make_test_file(path, size)
    _arm(config, 64 << 20)
    new0 = bytes(range(256))[::-1] * (CHUNK // 256)
    before = stats.snapshot().get("nr_cache_invalidate", 0)
    with Session(device=device) as sess:
        with open_source(path) as src:
            got = _read_pass(sess, src, nchunks)      # warm the tier
        assert got == expected_bytes(0, size)
        handle, buf = sess.alloc_dma_buffer(CHUNK)
        try:
            buf.view()[:CHUNK] = new0
            with open_source(path, writable=True) as sink:
                res = sess.memcpy_ram2ssd(sink, handle, [0], CHUNK)
                sess.memcpy_wait(res.dma_task_id)
                sink.sync()
        finally:
            sess.unmap_buffer(handle)
        with open_source(path) as src:
            got = _read_pass(sess, src, nchunks)
    inval = stats.snapshot().get("nr_cache_invalidate", 0) - before
    assert got[:CHUNK] == new0, "a written extent was served stale"
    assert got[CHUNK:] == expected_bytes(CHUNK, size - CHUNK), \
        "the extents the write missed diverged"
    assert inval > 0, "the write dropped nothing from the tier"
    print(f"cache-gate write-back leg ok: {inval} invalidation(s), fresh "
          f"bytes served")
    return inval


def main(argv=None) -> int:
    from ..api import StromError
    from ..cache import residency_cache
    from ..config import config
    from ..hbm.backend import resolve_device

    ap = argparse.ArgumentParser(prog="cache_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="the Sessions' device (default cuda:0; 'cpu' "
                         "runs on the host)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"cache-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    try:
        with tempfile.TemporaryDirectory(prefix="strom_cache_") as d:
            _leg_speedup(d, dev)
            _leg_eviction_identity(d, dev)
            _leg_writeback_invalidation(d, dev)
    except AssertionError as e:
        print(f"cache-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
        residency_cache.clear()
        residency_cache.configure()
    print("cache-gate ok: the hot rescan beats the cold one, identity holds "
          "under eviction pressure, a write is never served stale")
    return 0


if __name__ == "__main__":
    sys.exit(main())
