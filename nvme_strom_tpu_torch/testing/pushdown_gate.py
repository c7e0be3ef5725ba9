"""The compute-pushdown gate: the JAX package's
``testing/pushdown_gate.py``.

Holds the pushdown's transport contract on seeded synthetics:

* **Throughput** — with a per-request latency injected into the loopback
  fake, the packed scan (decode and filter on the device side of the
  link) delivers at least ``--ratio`` (1.2) × the raw scan's logical rate
  in the same run.  Both legs pay the latency a chunk; the packed one
  reads fewer chunks for the same rows, so the ratio is latency-bound
  and holds on any host.
* **Identity under eviction churn** — through ``Query`` with a RAM tier
  far smaller than the packed file, the pushdown answer equals the
  unpacked scan's over repeated passes while the ARC lists churn, and
  the tier counts packed extents in logical bytes
  (``logical_resident_bytes``).
* **Chaos fail-stop** — the packed file striped over a mirrored pair, a
  member failing mid-scan: its extents come from the partner and the
  aggregate stays the same, so the fault ladder serves packed extents.

The predicate is the :class:`..ops.filter.FilterPred` ``c0 > 3`` (the
JAX package's is a callable), so on a card the steps are the kernels: B2
over the packed pages, B1 over the raw ones.  The Sessions and the scans
run on the device the gate names (default ``cuda:0``; ``-d cpu`` runs
the plain versions on the host).

Usage: python -m nvme_strom_tpu_torch.testing.pushdown_gate [-d DEVICE]
       [--ratio R] [--rounds N]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

#: the JAX package's limit and rounds
RATIO_LIMIT = 1.2
ROUNDS = 3

CHUNK = 64 << 10          # scan chunk: one injected latency a chunk
STRIPE = 64 << 10         # the chaos leg's stripe chunk
N_ROWS = 200_000
LATENCY_S = 0.002

__all__ = ["main", "RATIO_LIMIT", "ROUNDS"]


def _pred():
    from ..ops.filter import FilterPred
    return FilterPred(((0, "gt", 3),))


def _make_table(dirpath: str, tag: str):
    """A compressible table of three int32 columns and its packed
    sidecar: column 0 cycles 0..15 (bitpack), column 1 holds 1024-long
    runs (rle), column 2 draws from 200 small values (dict) — small
    enough that the int32 sums never wrap."""
    import numpy as np

    from ..scan.colpack import build_packed
    from ..scan.heap import HeapSchema, build_heap_file

    schema = HeapSchema(3, dtypes=("i4", "i4", "i4"))
    rng = np.random.default_rng(14)
    c0 = (np.arange(N_ROWS, dtype=np.int64) % 16).astype(np.int32)
    c1 = np.repeat(np.arange((N_ROWS + 1023) // 1024, dtype=np.int32) % 8,
                   1024)[:N_ROWS]
    c2 = rng.integers(0, 200, N_ROWS).astype(np.int32)
    path = os.path.join(dirpath, f"{tag}.tbl")
    build_heap_file(path, [c0, c1, c2], schema)
    meta = build_packed(path, schema)
    mask = c0 > 3
    truth = (int(mask.sum()), int(c1[mask].sum()), int(c2[mask].sum()))
    return path, schema, meta, truth


def _project(out):
    return (int(out["count"]), int(out["sums"][1]), int(out["sums"][2]))


def _steps(schema, meta):
    """The raw and packed scan steps: the kernels' wrappers (the plain
    versions on a CPU batch)."""
    from ..ops.decode_cuda import decode_filter_pages_cuda
    from ..ops.filter_cuda import filter_pages_cuda
    pred = _pred()
    return ((lambda pages: filter_pages_cuda(pages, 0, schema, pred)),
            (lambda pages: decode_filter_pages_cuda(pages, 0, meta, pred)))


def _leg_throughput(dirpath: str, device, limit: float, rounds: int) -> None:
    """The packed leg's logical rate >= *limit* x the raw leg's."""
    import statistics

    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from ..scan.executor import TableScanner
    from .fake import FakeNvmeSource, FaultPlan

    path, schema, meta, truth = _make_table(dirpath, "speed")
    cpk = meta.path or (path + ".cpk")
    config.set("cache_bytes", 0)          # no RAM tier: link bytes only
    config.set("cache_arbitration", False)
    config.set("dma_max_size", CHUNK)
    residency_cache.configure()
    residency_cache.clear()
    raw_fn, dec_fn = _steps(schema, meta)
    heap_bytes = os.path.getsize(path)
    raw_t, packed_t = [], []
    with Session(device=device) as sess:
        def scan(fpath, fn):
            src = FakeNvmeSource(fpath,
                                 fault_plan=FaultPlan(latency_s=LATENCY_S),
                                 force_cached_fraction=0.0)
            try:
                return TableScanner(src, schema, session=sess,
                                    chunk_size=CHUNK).scan_filter(
                                        fn, device=device)
            finally:
                src.close()

        # untimed warm-up (the kernels' builds and first launches)
        assert _project(scan(path, raw_fn)) == truth, "raw warm-up diverged"
        assert _project(scan(cpk, dec_fn)) == truth, \
            "packed warm-up diverged from the unpacked truth"
        for r in range(rounds):
            t0 = time.perf_counter()
            got_raw = scan(path, raw_fn)
            raw_t.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got_packed = scan(cpk, dec_fn)
            packed_t.append(time.perf_counter() - t0)
            assert _project(got_raw) == _project(got_packed) == truth, \
                f"the legs diverged (round {r})"
    rt, pt = statistics.median(raw_t), statistics.median(packed_t)
    logical_gb = meta.logical_bytes / 1e9
    raw_rate, packed_rate = logical_gb / rt, logical_gb / pt
    ratio = packed_rate / raw_rate if raw_rate > 0 else float("inf")
    assert ratio >= limit, \
        f"packed only {ratio:.2f}x the raw logical rate (limit {limit}x; " \
        f"raw {raw_rate:.3f}, packed {packed_rate:.3f} GB/s logical)"
    print(f"pushdown-gate throughput leg ok: packed {packed_rate:.3f} GB/s "
          f"logical against raw {raw_rate:.3f} ({ratio:.1f}x, codec "
          f"{meta.ratio:.1f}x, link {meta.packed_bytes >> 10} KiB against "
          f"{heap_bytes >> 10} KiB, {rounds} interleaved rounds)")


def _leg_identity_eviction(dirpath: str, device) -> None:
    """``Query``'s pushdown equals the unpacked scan while the RAM tier
    churns, and packed extents count in logical bytes."""
    from ..cache import residency_cache
    from ..config import config
    from ..scan.query import Query
    from ..stats import stats

    path, schema, meta, truth = _make_table(dirpath, "evict")
    q = Query(path, schema).where(_pred()).aggregate([1, 2])
    config.set("pushdown", "off")
    base = q.run(device=device)
    got = (int(base["count"]), int(base["sums"][0]), int(base["sums"][1]))
    assert got == truth, f"the unpacked baseline diverged: {got} != {truth}"
    # 64 KiB scan chunks (the fill extents), a capacity well below the
    # packed file: every pass churns the ARC lists
    config.set("chunk_size", CHUNK)
    config.set("cache_bytes", 4 * CHUNK)
    config.set("cache_arbitration", False)
    residency_cache.configure()
    residency_cache.clear()
    config.set("pushdown", "on")
    before = stats.snapshot()
    for r in range(3):
        out = q.run(device=device)
        got = (int(out["count"]), int(out["sums"][0]), int(out["sums"][1]))
        assert got == truth, \
            f"pushdown pass {r} diverged under churn: {got} != {truth}"
    after = stats.snapshot()

    def moved(*names):
        return sum(after.get(n, 0) - before.get(n, 0) for n in names)

    decodes = moved("nr_pushdown_decode_chip", "nr_pushdown_decode_host")
    saved = moved("bytes_wire_saved")
    evicted = moved("nr_cache_evict")
    assert decodes > 0, "the pushdown path never decoded (the plan fell back?)"
    assert saved > 0, "the pushdown moved no fewer link bytes than raw"
    assert evicted > 0, "eviction never churned (capacity not binding?)"
    res = residency_cache.resident_bytes()
    lres = residency_cache.logical_resident_bytes()
    assert lres > res > 0, \
        f"packed extents not counted in logical bytes ({lres} !> {res})"
    print(f"pushdown-gate identity leg ok: 3 churned passes identical "
          f"({evicted} evictions), {decodes} packed batches, "
          f"{saved >> 10} KiB of link saved, resident {res >> 10} KiB "
          f"serves {lres >> 10} KiB logical")


def _leg_chaos_failstop(dirpath: str, device) -> None:
    """A member of the packed file's mirrored pair fails mid-scan: its
    extents come from the partner and the aggregate stays the same."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from ..scan.executor import TableScanner
    from ..stats import stats
    from .fake import FakeStripedNvmeSource, FaultPlan

    path, schema, meta, truth = _make_table(dirpath, "chaos")
    cpk = meta.path or (path + ".cpk")
    with open(cpk, "rb") as f:
        blob = f.read()
    blob += b"\0" * ((-len(blob)) % STRIPE)   # zero pages hold no rows
    m0 = os.path.join(dirpath, "pk0.bin")
    m1 = os.path.join(dirpath, "pk1.bin")
    with open(m0, "wb") as f:
        f.write(blob)
    shutil.copyfile(m0, m1)
    config.set("cache_bytes", 0)
    config.set("cache_arbitration", False)
    config.set("dma_max_size", CHUNK)
    config.set("io_retries", 1)
    config.set("canary_interval_s", 0.0)
    residency_cache.configure()
    residency_cache.clear()
    plan = FaultPlan(failstop_member=0, failstop_after=4)
    src = FakeStripedNvmeSource([m0, m1], stripe_chunk_size=STRIPE,
                                fault_plan=plan, force_cached_fraction=0.0,
                                mirror="paired")
    _raw_fn, dec_fn = _steps(schema, meta)
    before = stats.snapshot()
    try:
        with Session(device=device) as sess:
            out = TableScanner(src, schema, session=sess,
                               chunk_size=CHUNK).scan_filter(
                                   dec_fn, device=device)
    finally:
        src.close()
    after = stats.snapshot()
    got = _project(out)
    assert got == truth, f"the degraded packed scan diverged: {got} != " \
                         f"{truth}"
    mirror = after.get("nr_mirror_read", 0) - before.get("nr_mirror_read", 0)
    failed = after.get("nr_member_failed", 0) \
        - before.get("nr_member_failed", 0)
    assert mirror > 0, "the fail-stop never sent packed extents to the mirror"
    assert failed >= 1, "the failed member never latched FAILED"
    print(f"pushdown-gate chaos leg ok: a member failed mid-scan, {mirror} "
          f"mirror reads, the aggregate identical")


def main(argv=None) -> int:
    from ..api import StromError
    from ..cache import residency_cache
    from ..config import config
    from ..hbm.backend import resolve_device

    ap = argparse.ArgumentParser(prog="pushdown_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="the scans' device (default cuda:0; 'cpu' runs "
                         "the plain versions on the host)")
    ap.add_argument("--ratio", type=float, default=RATIO_LIMIT,
                    help=f"least packed / raw logical rate (default "
                         f"{RATIO_LIMIT})")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"timed rounds of each leg (default {ROUNDS})")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"pushdown-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    try:
        with tempfile.TemporaryDirectory(prefix="strom_pushdown_") as d:
            _leg_throughput(d, dev, args.ratio, args.rounds)
            _leg_identity_eviction(d, dev)
            _leg_chaos_failstop(d, dev)
    except AssertionError as e:
        print(f"pushdown-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
        residency_cache.clear()
        residency_cache.configure()
    print("pushdown-gate ok: packed beats the raw transport, identity holds "
          "under churn and fail-stop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
