"""QoS fairness gate of the port's daemon (the JAX package's
``testing/qos_gate.py``).

Holds stromd's two scheduling contracts end-to-end (real daemon, real
socket, real engine) on the deterministic latency-injected loopback:

* **Weighted fairness** — two tenants at 3:1 DRR weights, both
  saturating a single dispatcher, must receive bytes within
  ``STROM_QOS_GATE_TOL`` (default 25%) of the 3:1 configured share
  while both are still backlogged.  The fake's per-request latency
  makes the lane the bottleneck, so the measurement is scheduler-bound
  and reproduces on any machine.
* **Latency-class isolation** — a latency-class tenant's p95 queue
  wait (from its per-tenant wait histogram) stays bounded under a
  bulk-class antagonist that keeps the queue full: strict priority
  caps the latency tenant's wait at roughly one in-service item, never
  the antagonist's whole backlog.

Run: ``python -m nvme_strom_tpu_torch.testing.qos_gate`` (exit 0 when
both legs hold).  ``STROM_QOS_GATE_RATIO`` / ``_TOL`` / ``_P95_MS`` set
the target ratio, its tolerance and the latency tenant's p95 ceiling.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

TARGET_RATIO = float(os.environ.get("STROM_QOS_GATE_RATIO", "3.0"))
TOLERANCE = float(os.environ.get("STROM_QOS_GATE_TOL", "0.25"))
#: p95 queue-wait ceiling for the latency tenant under a bulk antagonist
WAIT_P95_NS = int(float(os.environ.get("STROM_QOS_GATE_P95_MS", "150")) * 1e6)

CHUNK = 64 << 10


def _start_daemon(dirpath: str, **kw):
    from ..daemon.server import StromDaemon
    sock = os.path.join(dirpath, "stromd.sock")
    return StromDaemon(sock, allow_fake=True, **kw).start()


def _fake_spec(path: str, latency_s: float) -> dict:
    return {"kind": "fake", "path": path, "latency_s": latency_s,
            "force_cached_fraction": 0.0}


def _leg_fairness(dirpath: str) -> float:
    """3:1-weighted tenants within TOLERANCE of 3:1 bytes while both
    are backlogged behind one dispatcher; returns the byte ratio."""
    from ..daemon import DaemonSession
    from .fake import make_test_file

    n_tasks, per_task, lat = 128, 4, 0.002   # 256KB tasks, ~2ms service
    path = os.path.join(dirpath, "fair.bin")
    make_test_file(path, n_tasks * per_task * CHUNK)

    daemon = _start_daemon(dirpath, dispatchers=0)
    try:
        a = DaemonSession(daemon.socket_path, tenant="heavy", weight=3.0)
        b = DaemonSession(daemon.socket_path, tenant="light", weight=1.0)
        mon = DaemonSession(daemon.socket_path, tenant="_monitor")
        try:
            # queue EVERYTHING before the first dispatch so both tenants
            # are saturated from the scheduler's point of view throughout
            for sess in (a, b):
                src = sess.open_source(_fake_spec(path, lat))
                h, _buf = sess.alloc_dma_buffer(per_task * CHUNK)
                for t in range(n_tasks):
                    ids = list(range(t * per_task, (t + 1) * per_task))
                    sess.memcpy_ssd2ram(src, h, ids, CHUNK)
            daemon.start_dispatchers(1)
            # measure while BOTH are still backlogged: at 3:1 the heavy
            # tenant drains around total = 4/3 * n_tasks, after which the
            # light one owns the lane and the ratio decays toward 1 —
            # sample well before that point
            want = n_tasks
            deadline = time.monotonic() + 120.0
            while True:
                st = mon.daemon_stat()["tenants"]
                done = sum(st[t]["tasks"] for t in ("heavy", "light"))
                if done >= want:
                    break
                assert time.monotonic() < deadline, \
                    f"fairness leg stalled at {done}/{want} tasks"
                time.sleep(0.002)
            hb, lb = st["heavy"]["bytes"], st["light"]["bytes"]
            assert lb > 0, "light tenant starved outright"
            ratio = hb / lb
            lo = TARGET_RATIO * (1.0 - TOLERANCE)
            hi = TARGET_RATIO * (1.0 + TOLERANCE)
            assert lo <= ratio <= hi, \
                f"3:1 weights delivered {ratio:.2f}:1 bytes " \
                f"(heavy {hb} / light {lb}), outside [{lo:.2f}, {hi:.2f}]"
            print(f"qos-gate fairness leg ok: {ratio:.2f}:1 bytes at 3:1 "
                  f"weights after {done} tasks")
            return ratio
        finally:
            for sess in (a, b, mon):
                sess.close()
    finally:
        daemon.close()


def _leg_latency_isolation(dirpath: str) -> int:
    """A latency-class tenant's p95 queue wait stays under WAIT_P95_NS
    while a bulk-class antagonist keeps the only dispatcher saturated;
    returns that p95 in ns."""
    from ..daemon import DaemonSession
    from ..stats import hist_percentiles
    from .fake import make_test_file

    lat = 0.002
    path = os.path.join(dirpath, "iso.bin")
    make_test_file(path, 256 * CHUNK)

    daemon = _start_daemon(dirpath, dispatchers=0)
    try:
        bulk = DaemonSession(daemon.socket_path, tenant="bulk",
                             qos_class="bulk")
        lowlat = DaemonSession(daemon.socket_path, tenant="lowlat",
                               qos_class="latency")
        stop = threading.Event()

        def antagonist():
            src = bulk.open_source(_fake_spec(path, lat))
            h, _buf = bulk.alloc_dma_buffer(16 * CHUNK)
            pending = []
            t = 0
            while not stop.is_set():
                # strided ids defeat extent merging: each bulk task is
                # many latency-charged requests, a fat in-service item
                ids = [(t * 16 + i * 2) % 224 for i in range(8)]
                r = bulk.memcpy_ssd2ram(src, h, ids, CHUNK)
                pending.append(r.dma_task_id)
                t += 1
                if len(pending) >= 6:
                    bulk.memcpy_wait(pending.pop(0), timeout=60)
            for tid in pending:
                bulk.memcpy_wait(tid, timeout=60)

        ant = threading.Thread(target=antagonist, daemon=True)
        ant.start()
        daemon.start_dispatchers(1)
        time.sleep(0.05)        # let the antagonist build a backlog
        src = lowlat.open_source(_fake_spec(path, lat))
        h, _buf = lowlat.alloc_dma_buffer(CHUNK)
        for i in range(20):
            r = lowlat.memcpy_ssd2ram(src, h, [i % 224], CHUNK)
            lowlat.memcpy_wait(r.dma_task_id, timeout=60)
            time.sleep(0.005)
        st = lowlat.daemon_stat()["tenants"]
        stop.set()
        ant.join(timeout=60)
        (p95,) = hist_percentiles(st["lowlat"]["wait_hist"], qs=(0.95,))
        bulk_bytes = st["bulk"]["bytes"]
        ll_bytes = st["lowlat"]["bytes"]
        assert p95 is not None, "latency tenant recorded no waits"
        assert p95 < WAIT_P95_NS, \
            f"latency-class p95 wait {p95 / 1e6:.1f}ms exceeds " \
            f"{WAIT_P95_NS / 1e6:.0f}ms under the bulk antagonist"
        assert bulk_bytes > ll_bytes, \
            "antagonist moved less than the latency tenant — the queue " \
            "was never contended, the leg proves nothing"
        print(f"qos-gate isolation leg ok: latency p95 wait "
              f"{p95 / 1e6:.1f}ms under a bulk antagonist "
              f"({bulk_bytes >> 20}MB bulk vs {ll_bytes >> 10}KB latency)")
        lowlat.close()
        bulk.close()
        return p95
    finally:
        daemon.close()


def main() -> int:
    from ..config import config

    snap = config.snapshot()
    try:
        config.set("trace_policy", "off")
        with tempfile.TemporaryDirectory(prefix="strom_qos_") as d:
            _leg_fairness(d)
            _leg_latency_isolation(d)
    except AssertionError as e:
        print(f"qos-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
    print("qos-gate ok: 3:1 weights deliver 3:1 bytes, latency class "
          "stays bounded under bulk pressure")
    return 0


if __name__ == "__main__":
    sys.exit(main())
