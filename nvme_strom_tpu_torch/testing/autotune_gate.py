"""The self-driving data path's gate: the JAX package's
``testing/autotune_gate.py``.

Holds the controller's contracts on seeded synthetics:

* **Convergence** — from bad static knobs (``submit_window`` 2, 256 KiB
  requests) on a latency-injected loopback stripe, the controller reaches
  at least ``--ratio`` (1.5) × the static throughput within ``--epochs``
  (20) epochs, every pass byte-identical, and settles: no step reverted
  in the last 5 epochs (the hysteresis).  The ratio needs a host with
  CPU to spare: where other processes keep every core busy, more
  requests in flight stretch the tail of each epoch's service times, and
  the climber's p99 guard (log2 buckets, ``p99_tol`` 1.5) steps every
  window probe back, in the JAX package's controller too.
* **Health freeze** — a member fail-stop mid-run freezes the tuning
  (``nr_autotune_freeze`` moves, no knob step while frozen) while the
  mirror serves identical bytes, no pass slower than ``--degraded-x``
  (15) × the healthy median.
* **Readahead** — an ordered scan in spans reaches a RAM-tier hit ratio
  of at least ``--hit-ratio`` (0.5); with a starved budget the bucket
  skips predictions and the prefetched bytes stay within rate × elapsed
  + burst.
* **Off is off** — ``readahead`` off leaves every readahead counter at 0
  and the scan's tier numbers at their cold values.

The epochs are driven synchronously (``step_epoch`` after each pass, the
controller thread stopped), so the trajectory is deterministic.  The
Sessions are built on the device the gate names (default ``cuda:0``);
``-d cpu`` runs it on the host.

Usage: python -m nvme_strom_tpu_torch.testing.autotune_gate [-d DEVICE]
       [--ratio R] [--epochs N] [--degraded-x X] [--hit-ratio H]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

#: the JAX package's limits
RATIO = 1.5
EPOCHS = 20
DEGRADED_X = 15.0
HIT_RATIO = 0.5

CHUNK = 64 << 10
# the convergence leg's injected latency a request (the reference's)
LATENCY_S = 0.02

__all__ = ["main", "RATIO", "EPOCHS", "DEGRADED_X", "HIT_RATIO"]


def _counter(name: str) -> int:
    from ..stats import stats
    return stats.snapshot().get(name, 0)


def _read_pass(sess, src, chunk_ids) -> bytes:
    """*chunk_ids* of *src* in the order asked (RAM-tier hits land after
    the submitted chunks, so the slots are put back by the result)."""
    import numpy as np

    from ..engine import reorder_chunks
    want = list(chunk_ids)
    handle, buf = sess.alloc_dma_buffer(len(want) * CHUNK)
    try:
        res = sess.memcpy_ssd2ram(src, handle, want, CHUNK)
        sess.memcpy_wait(res.dma_task_id, timeout=120.0)
        return bytes(reorder_chunks(
            np.frombuffer(buf.view()[:len(want) * CHUNK], np.uint8), CHUNK,
            res.chunk_ids, want))
    finally:
        sess.unmap_buffer(handle)


def _bad_statics(config) -> None:
    """The bad static knobs: a window of 2 and 256 KiB requests on a
    device whose injected latency is charged a request, so small windows
    and small requests both multiply the latency bill."""
    config.set("io_backend", "python")   # the fake's latency rides the pools
    config.set("submit_window", 2)
    config.set("member_queue_depth", 2)
    config.set("dma_max_size", 256 << 10)
    config.set("cache_bytes", 0)
    config.set("cache_arbitration", False)
    config.set("hedge_policy", "off")
    config.set("readahead", False)


def _converge(dirpath: str, device, epochs_n: int,
              latency_s: float = LATENCY_S):
    """The convergence leg's runs: 4 passes at the bad statics, then
    *epochs_n* passes with the controller on, an epoch after each, every
    pass byte-identical, each request charged *latency_s*.  Returns
    ``(static s, tuned s, the climber's history)``."""
    from ..config import config
    from ..engine import Session
    from .fake import FakeStripedNvmeSource, FaultPlan, make_test_file

    # a 2-member stripe: the member pools are the concurrency the window
    # drives (a single file rides the session's shared pool), and the
    # per-request latency makes both knobs count
    nchunks, lat = 64, latency_s
    paths = []
    for i in range(2):
        p = os.path.join(dirpath, f"conv{i}.bin")
        make_test_file(p, nchunks // 2 * CHUNK, seed=i)
        paths.append(p)
    _bad_statics(config)
    expect = None

    def one_pass(sess, src) -> float:
        nonlocal expect
        t0 = time.perf_counter()
        got = _read_pass(sess, src, range(nchunks))
        el = time.perf_counter() - t0
        if expect is None:
            expect = got
        assert got == expect, "bytes diverged during tuning"
        return el

    config.set("autotune", False)
    src = FakeStripedNvmeSource(paths, CHUNK,
                                fault_plan=FaultPlan(latency_s=lat),
                                force_cached_fraction=0.0)
    try:
        with Session(device=device) as sess:
            static = [one_pass(sess, src) for _ in range(4)]
        config.set("autotune", True)
        epochs = []
        with Session(device=device) as sess:
            sess._tuner.stop()   # the gate drives the epochs
            for _ in range(epochs_n):
                epochs.append(one_pass(sess, src))
                sess._tuner.step_epoch()
            history = sess._tuner._climber.history
    finally:
        src.close()
        config.set("autotune", False)
    return static, epochs, history


def _leg_convergence(dirpath: str, device, ratio_limit: float,
                     epochs_n: int, latency_s: float = LATENCY_S):
    """Controller >= *ratio_limit* x static within *epochs_n* epochs,
    byte identity every pass, no step reverted in the last 5 epochs.
    Returns :func:`_converge`'s runs."""
    static, epochs, history = _converge(dirpath, device, epochs_n,
                                        latency_s)
    s_med = statistics.median(static)
    conv = statistics.median(epochs[-5:])
    ratio = s_med / conv if conv > 0 else float("inf")
    tail_reverts = sum(1 for epoch in history[-5:]
                       for (kind, *_rest) in epoch if kind == "revert")
    kinds = [kind for epoch in history for (kind, *_rest) in epoch]
    assert ratio >= ratio_limit, \
        f"converged only {ratio:.2f}x static (limit {ratio_limit}x; " \
        f"static {s_med * 1e3:.0f} ms, converged {conv * 1e3:.0f} ms; " \
        f"{kinds.count('step')} steps, {kinds.count('revert')} reverts, " \
        f"{kinds.count('freeze')} frozen epochs)"
    assert tail_reverts == 0, \
        f"the knobs did not settle: {tail_reverts} reversal(s) in the " \
        f"last 5 epochs"
    print(f"autotune-gate convergence leg ok: {ratio:.1f}x static (static "
          f"{s_med * 1e3:.0f} ms -> converged {conv * 1e3:.0f} ms, "
          f"{len(epochs)} epochs, settled)")
    return static, epochs, history


def _leg_health_freeze(dirpath: str, device, degraded_x: float) -> None:
    """A member fail-stop mid-run: tuning freezes, the mirror serves
    identical bytes, no pass past the degraded floor."""
    from ..config import config
    from ..engine import Session
    from .fake import FakeStripedNvmeSource, FaultPlan, make_test_file

    nchunks, lat = 32, 0.003
    paths = []
    for i in range(2):
        p = os.path.join(dirpath, f"frz{i}.bin")
        # a paired mirror holds one member's worth
        make_test_file(p, nchunks * CHUNK)
        paths.append(p)
    _bad_statics(config)
    config.set("autotune", True)
    config.set("quarantine_after", 2)
    config.set("quarantine_s", 60.0)
    plan = FaultPlan(latency_s=lat)
    src = FakeStripedNvmeSource(paths, CHUNK, fault_plan=plan,
                                force_cached_fraction=0.0, mirror="paired")
    try:
        with Session(device=device) as sess:
            sess._tuner.stop()   # the gate drives the epochs
            reference = _read_pass(sess, src, range(nchunks))
            healthy = []
            for _ in range(6):
                t0 = time.perf_counter()
                got = _read_pass(sess, src, range(nchunks))
                healthy.append(time.perf_counter() - t0)
                assert got == reference, "bytes diverged while healthy"
                sess._tuner.step_epoch()
            # from here every member-0 read fails (direct and buffered:
            # the device is gone); the ladder serves the mirror
            plan.failstop_member = 0
            plan.failstop_after = 0
            freeze0 = _counter("nr_autotune_freeze")
            nhist = len(sess._tuner._climber.history)
            degraded = []
            for _ in range(5):
                t0 = time.perf_counter()
                got = _read_pass(sess, src, range(nchunks))
                degraded.append(time.perf_counter() - t0)
                assert got == reference, "bytes diverged after fail-stop"
                sess._tuner.step_epoch()
            frozen = _counter("nr_autotune_freeze") - freeze0
            # the quarantine lands in the first degraded pass, so no epoch
            # after the failure may step a knob
            frozen_steps = sum(
                1 for epoch in sess._tuner._climber.history[nhist:]
                for (k, *_r) in epoch if k == "step")
            reason = sess._tuner.freeze_reason
    finally:
        src.close()
        config.set("autotune", False)
    floor = statistics.median(healthy) * degraded_x
    worst = max(degraded[1:])   # the first degraded pass pays detection
    assert frozen > 0, "the fail-stop never froze the controller"
    assert frozen_steps == 0, \
        f"{frozen_steps} knob step(s) taken in frozen epochs"
    assert worst <= floor, \
        f"degraded pass {worst * 1e3:.0f} ms beyond the floor " \
        f"({floor * 1e3:.0f} ms = {degraded_x}x the healthy median)"
    print(f"autotune-gate freeze leg ok: {frozen} frozen epoch(s) "
          f"({reason or 'recovered'}), the mirror served identical bytes, "
          f"worst degraded pass {worst * 1e3:.0f} ms <= floor")


def _strided_scan(sess, src, tuner, nchunks: int, span: int,
                  expect: bytes) -> None:
    """Demand-read the file in order in *span*-chunk spans, one readahead
    pass after each (the controller thread's job, synchronous here)."""
    for first in range(0, nchunks, span):
        got = _read_pass(sess, src, range(first, first + span))
        assert got == expect[first * CHUNK:(first + span) * CHUNK], \
            f"bytes diverged at span {first}"
        tuner.step_epoch()


def _leg_readahead(dirpath: str, device, hit_limit: float) -> None:
    """Ordered scan: hit ratio >= *hit_limit*; a starved budget skips
    predictions and bounds the prefetched bytes."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from .fake import FakeNvmeSource, FaultPlan, expected_bytes, \
        make_test_file

    nchunks, span, lat = 64, 4, 0.002
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "ra.bin")
    make_test_file(path, size)
    expect = expected_bytes(0, size)
    _bad_statics(config)
    config.set("cache_bytes", 64 << 20)
    config.set("readahead", True)
    config.set("readahead_budget_mb_s", 64.0)
    residency_cache.configure()
    src = FakeNvmeSource(path, fault_plan=FaultPlan(latency_s=lat),
                         force_cached_fraction=0.0)
    h0, m0 = _counter("nr_cache_hit"), _counter("nr_cache_miss")
    try:
        with Session(device=device) as sess:
            sess._tuner.stop()   # the gate drives the issue loop
            _strided_scan(sess, src, sess._tuner, nchunks, span, expect)
        hits = _counter("nr_cache_hit") - h0
        misses = _counter("nr_cache_miss") - m0
        ratio = hits / max(hits + misses, 1)
        assert ratio >= hit_limit, \
            f"ordered scan hit ratio {ratio:.2f} < {hit_limit} " \
            f"({hits} hits / {misses} misses)"
        # the budget's ceiling: cold again with a starved bucket, which
        # must skip (never block) and stay under rate * elapsed + burst
        residency_cache.clear()
        config.set("readahead_budget_mb_s", 2.0)
        b0 = _counter("bytes_readahead")
        s0 = _counter("nr_readahead_skip")
        t0 = time.perf_counter()
        with Session(device=device) as sess:
            sess._tuner.stop()
            burst = sess._tuner._bucket.burst
            _strided_scan(sess, src, sess._tuner, nchunks, span, expect)
        elapsed = time.perf_counter() - t0
        spent = _counter("bytes_readahead") - b0
        ceiling = 2.0 * (1 << 20) * elapsed + burst
        assert spent <= ceiling, \
            f"prefetch spent {spent} bytes over the {ceiling:.0f} budget"
        assert _counter("nr_readahead_skip") > s0, \
            "the starved bucket never skipped a prediction"
    finally:
        src.close()
        config.set("readahead", False)
        residency_cache.clear()
    print(f"autotune-gate readahead leg ok: hit ratio {ratio:.2f} (>= "
          f"{hit_limit}), budget held ({spent} bytes <= {ceiling:.0f} "
          f"over {elapsed:.1f} s)")


def _leg_off_is_off(dirpath: str, device) -> None:
    """``readahead`` off: every readahead counter still, and the scan's
    tier numbers cold (no hits, one fill a chunk)."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from .fake import FakeNvmeSource, expected_bytes, make_test_file

    nchunks, span = 32, 4
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "off.bin")
    make_test_file(path, size)
    expect = expected_bytes(0, size)
    _bad_statics(config)
    config.set("cache_bytes", 64 << 20)
    config.set("readahead", False)
    config.set("autotune", False)
    residency_cache.configure()
    residency_cache.clear()
    names = ("nr_readahead_fill", "nr_readahead_hit", "nr_readahead_skip",
             "bytes_readahead")
    before = {n: _counter(n) for n in names + ("nr_cache_hit",
                                               "nr_cache_fill")}
    src = FakeNvmeSource(path, force_cached_fraction=0.0)
    try:
        with Session(device=device) as sess:
            assert not sess._tuner.active, "controller armed while off"
            assert sess._tuner._thread is None, "a thread started while off"
            _strided_scan(sess, src, sess._tuner, nchunks, span, expect)
    finally:
        src.close()
        residency_cache.clear()
    for n in names:
        delta = _counter(n) - before[n]
        assert delta == 0, f"readahead off still moved {n} by {delta}"
    hits = _counter("nr_cache_hit") - before["nr_cache_hit"]
    fills = _counter("nr_cache_fill") - before["nr_cache_fill"]
    assert hits == 0, f"the off scan saw {hits} RAM-tier hits (cold expected)"
    assert fills == nchunks, \
        f"the off scan filled {fills} extents (expected {nchunks})"
    print(f"autotune-gate off leg ok: no readahead counter moved, the cold "
          f"scan's numbers unchanged ({fills} fills, 0 hits)")


def main(argv=None) -> int:
    from ..api import StromError
    from ..cache import residency_cache
    from ..config import config
    from ..hbm.backend import resolve_device

    ap = argparse.ArgumentParser(prog="autotune_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="the Sessions' device (default cuda:0; 'cpu' "
                         "runs on the host)")
    ap.add_argument("--ratio", type=float, default=RATIO,
                    help=f"convergence: tuned / static throughput "
                         f"(default {RATIO})")
    ap.add_argument("--epochs", type=int, default=EPOCHS,
                    help=f"convergence: epochs the controller gets "
                         f"(default {EPOCHS})")
    ap.add_argument("--degraded-x", type=float, default=DEGRADED_X,
                    help=f"freeze: slowest degraded pass / healthy median "
                         f"(default {DEGRADED_X})")
    ap.add_argument("--hit-ratio", type=float, default=HIT_RATIO,
                    help=f"readahead: least RAM-tier hit ratio "
                         f"(default {HIT_RATIO})")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"autotune-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    try:
        with tempfile.TemporaryDirectory(prefix="strom_autotune_") as d:
            _leg_convergence(d, dev, args.ratio, args.epochs)
            _leg_health_freeze(d, dev, args.degraded_x)
            _leg_readahead(d, dev, args.hit_ratio)
            _leg_off_is_off(d, dev)
    except AssertionError as e:
        print(f"autotune-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
        residency_cache.clear()
        residency_cache.configure()
    print("autotune-gate ok: the controller converges and settles, freezes "
          "for the health machine, readahead hits under its budget, off is "
          "off")
    return 0


if __name__ == "__main__":
    sys.exit(main())
