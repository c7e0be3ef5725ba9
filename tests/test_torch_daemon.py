"""The port's shared serving daemon (``nvme_strom_tpu_torch.daemon``).

The JAX package's ``tests/test_daemon.py`` held against the port: session
lifecycle with byte identity through the shared memfd buffer, protocol
version fail-closed, admission rejection under quota, orphan reaping (an
abrupt disconnect and a SIGKILLed subprocess client), max sessions,
token-bucket shaping, the QoS scheduler's class and weight policy, the
stats, trace and Prometheus surface, leases and the KV pool.  Beside
them, the JAX package as the oracle: both schedulers fed one work-item
sequence under one fake clock dispatch in the same order, both packages'
frames are the same bytes, and a client of either package lands the same
bytes through a daemon of the other.
"""

from __future__ import annotations

import errno
import json
import os
import random
import signal
import socket as socket_mod
import subprocess
import sys
import time
import types

import pytest

from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.daemon import (DaemonBuffer, DaemonSession,
                                         PROTOCOL_VERSION)
from nvme_strom_tpu_torch.daemon import client as tclient
from nvme_strom_tpu_torch.daemon import protocol as tproto
from nvme_strom_tpu_torch.daemon import qos as tqos
from nvme_strom_tpu_torch.daemon.protocol import Framer, send_msg
from nvme_strom_tpu_torch.daemon.qos import (QosScheduler, TokenBucket,
                                             WorkItem)
from nvme_strom_tpu_torch.daemon.server import StromDaemon
from nvme_strom_tpu_torch.stats import stats
from nvme_strom_tpu_torch.testing.fake import expected_bytes, make_test_file

pytestmark = pytest.mark.daemon

CHUNK = 64 << 10
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_config():
    """The port's config is its own: snapshot and restore it here."""
    snap = config.snapshot()
    yield
    config.restore(snap)


@pytest.fixture
def daemon(tmp_path):
    d = StromDaemon(str(tmp_path / "stromd.sock"), allow_fake=True).start()
    yield d
    d.close()


@pytest.fixture
def data_file(tmp_path):
    path = str(tmp_path / "data.bin")
    make_test_file(path, 32 * CHUNK)
    return path


def _item(tenant: str, sid: int = 1, task: int = 1, nchunks: int = 4,
          mod=tqos):
    return mod.WorkItem(session_id=sid, tenant=tenant, task_id=task,
                        source_handle=0, buf_handle=0,
                        chunk_ids=list(range(nchunks)), chunk_size=CHUNK)


def _counters():
    return stats.snapshot()


# -- lifecycle ---------------------------------------------------------------

def test_lifecycle_byte_identity(daemon, data_file):
    """attach -> map -> open -> submit -> wait -> detach, with the DMA
    landing in the client's own memfd pages byte-identically."""
    with DaemonSession(daemon.socket_path, tenant="t-life") as sess:
        assert sess.ping()
        src = sess.open_source(data_file)
        assert src.size == 32 * CHUNK
        handle, buf = sess.alloc_dma_buffer(16 * CHUNK)
        res = sess.memcpy_ssd2ram(src, handle, list(range(16)), CHUNK)
        assert res.nr_chunks == 16
        out = sess.memcpy_wait(res.dma_task_id, timeout=60)
        assert out.nr_chunks == 16
        assert sorted(out.chunk_ids) == list(range(16))
        assert bytes(buf.view()[:16 * CHUNK]) == expected_bytes(0, 16 * CHUNK)
        assert sess.stat_info()["nr_ssd2dev"] >= 1
        sess.unmap_buffer(handle)
        src.close()
    time.sleep(0.1)
    assert daemon.session_count() == 0


def test_wait_unknown_task_and_source(daemon, data_file):
    with DaemonSession(daemon.socket_path) as sess:
        with pytest.raises(StromError) as e:
            sess.memcpy_wait(9999, timeout=1)
        assert e.value.errno == errno.ENOENT
        handle, _buf = sess.alloc_dma_buffer(CHUNK)
        with pytest.raises(StromError) as e:
            sess._rpc({"op": "submit", "source": 77, "buffer": handle,
                       "chunk_ids": [0], "chunk_size": CHUNK})
        assert e.value.errno == errno.ENOENT


def test_protocol_version_mismatch_fails_closed(daemon):
    """A wrong-version attach gets EPROTO and the connection drops before
    any resource is allocated."""
    sock = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    sock.settimeout(10)
    sock.connect(daemon.socket_path)
    try:
        send_msg(sock, {"op": "attach", "version": PROTOCOL_VERSION + 1,
                        "tenant": "t-old"})
        framer = Framer(sock)
        reply, _fds = framer.recv()
        assert reply["ok"] is False
        assert reply["errno"] == errno.EPROTO
        assert framer.recv() is None        # daemon hung up
    finally:
        sock.close()
    assert daemon.session_count() == 0


def test_first_message_must_be_attach(daemon):
    sock = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    sock.settimeout(10)
    sock.connect(daemon.socket_path)
    try:
        send_msg(sock, {"op": "ping"})
        reply, _ = Framer(sock).recv()
        assert reply["ok"] is False and reply["errno"] == errno.EPROTO
    finally:
        sock.close()


# -- admission control -------------------------------------------------------

def test_admission_quota_rejects_with_eagain(tmp_path, data_file):
    config.set("daemon_quota_tasks", 2)
    try:
        d = StromDaemon(str(tmp_path / "q.sock"), allow_fake=True,
                        dispatchers=0).start()
    finally:
        config.set("daemon_quota_tasks", 0)
    try:
        before = _counters()
        with DaemonSession(d.socket_path, tenant="t-quota") as sess:
            src = sess.open_source(data_file)
            handle, _buf = sess.alloc_dma_buffer(4 * CHUNK)
            sess.memcpy_ssd2ram(src, handle, [0], CHUNK)
            sess.memcpy_ssd2ram(src, handle, [1], CHUNK)
            with pytest.raises(StromError) as e:   # third in flight: bounced
                sess.memcpy_ssd2ram(src, handle, [2], CHUNK)
            assert e.value.errno == errno.EAGAIN
        after = _counters()
        assert after["nr_admission_reject"] - \
            before.get("nr_admission_reject", 0) == 1
        assert stats.tenant_snapshot()["t-quota"]["rejects"] >= 1
    finally:
        d.close()


def test_max_sessions(tmp_path):
    d = StromDaemon(str(tmp_path / "m.sock"), max_sessions=1,
                    allow_fake=True).start()
    try:
        with DaemonSession(d.socket_path):
            with pytest.raises(StromError) as e:
                DaemonSession(d.socket_path)
            assert e.value.errno == errno.EAGAIN
    finally:
        d.close()


# -- orphan reaping ----------------------------------------------------------

def test_abrupt_disconnect_reaps_everything(daemon, data_file):
    """Dropping the socket without detach releases the session's engine
    buffer registrations and sources: no leaked leases."""
    engine = daemon._engine
    before = _counters()
    sess = DaemonSession(daemon.socket_path, tenant="t-crash")
    src = sess.open_source(data_file)
    handle, _buf = sess.alloc_dma_buffer(4 * CHUNK)
    res = sess.memcpy_ssd2ram(src, handle, list(range(4)), CHUNK)
    sess.memcpy_wait(res.dma_task_id, timeout=60)
    n_before = len(engine.list_buffers())
    sess._sock.close()                       # a crash, not close(): no detach
    deadline = time.monotonic() + 30
    while daemon.session_count() > 0:
        assert time.monotonic() < deadline, "orphan never reaped"
        time.sleep(0.01)
    deadline = time.monotonic() + 30
    while len(engine.list_buffers()) >= n_before:
        assert time.monotonic() < deadline, "buffer lease leaked after reap"
        time.sleep(0.01)
    after = _counters()
    assert after["nr_session_reap"] - before.get("nr_session_reap", 0) == 1
    assert after["daemon_sessions"] == 0
    t = stats.tenant_snapshot()["t-crash"]
    assert t["inflight_tasks"] == 0 and t["inflight_bytes"] == 0


def test_reap_cancels_queued_work(tmp_path, data_file):
    """Queued, undispatched items of a dead session are cancelled and
    their quota released: a crashed client cannot wedge the lane."""
    d = StromDaemon(str(tmp_path / "r.sock"), allow_fake=True,
                    dispatchers=0).start()
    try:
        sess = DaemonSession(d.socket_path, tenant="t-wedge")
        src = sess.open_source(data_file)
        handle, _buf = sess.alloc_dma_buffer(4 * CHUNK)
        for i in range(8):
            sess.memcpy_ssd2ram(src, handle, [i], CHUNK)
        assert d.queue_depth() == 8
        sess._sock.close()
        deadline = time.monotonic() + 30
        while d.session_count() > 0 or d.queue_depth() > 0:
            assert time.monotonic() < deadline, "queued orphan work stuck"
            time.sleep(0.01)
        t = stats.tenant_snapshot()["t-wedge"]
        assert t["inflight_tasks"] == 0 and t["inflight_bytes"] == 0
    finally:
        d.close()


def test_sigkilled_client_is_reaped(daemon, data_file):
    """A client process SIGKILLed mid-session is fully reaped: session
    gone, no leaked engine buffers."""
    engine = daemon._engine
    n_before = len(engine.list_buffers())
    child = subprocess.Popen(
        [sys.executable, "-c", f"""
import sys, time
from nvme_strom_tpu_torch.daemon import DaemonSession
assert "torch" not in sys.modules
sess = DaemonSession({daemon.socket_path!r}, tenant="t-kill9")
src = sess.open_source({data_file!r})
h, buf = sess.alloc_dma_buffer({4 * CHUNK})
r = sess.memcpy_ssd2ram(src, h, [0, 1, 2, 3], {CHUNK})
sess.memcpy_wait(r.dma_task_id, timeout=60)
print("READY", flush=True)
time.sleep(120)
"""],
        stdout=subprocess.PIPE, text=True, cwd=_REPO)
    try:
        line = child.stdout.readline()
        assert "READY" in line, f"client never came up: {line!r}"
        assert daemon.session_count() == 1
        assert len(engine.list_buffers()) == n_before + 1
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=30)
        deadline = time.monotonic() + 30
        while daemon.session_count() > 0 \
                or len(engine.list_buffers()) > n_before:
            assert time.monotonic() < deadline, \
                "SIGKILLed client left leases behind"
            time.sleep(0.02)
        t = stats.tenant_snapshot()["t-kill9"]
        assert t["inflight_tasks"] == 0 and t["inflight_bytes"] == 0
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()


# -- QoS: shaping and the scheduler's policy ---------------------------------

def test_token_bucket():
    bkt = TokenBucket(rate=1 << 20, burst=1 << 20)   # 1MB/s, 1MB burst
    now = bkt._t_last                                 # deterministic clock
    assert bkt.ready_in(1 << 20, now=now) == 0.0
    bkt.consume(1 << 20, now=now)
    wait = bkt.ready_in(1 << 20, now=now)
    assert 0.9 < wait <= 1.0                          # full refill ~1s out
    assert bkt.ready_in(1 << 20, now=now + 2.0) == 0.0
    unshaped = TokenBucket(rate=0, burst=1)
    assert unshaped.ready_in(1 << 30, now=now) == 0.0


def test_scheduler_weighted_fairness_unit():
    """40 equal-size dispatches across 3:1-weighted tenants land within
    one quantum of 3:1: deterministic, no I/O, no sleeping."""
    sched = QosScheduler(quantum=256 << 10)
    sched.register_tenant("a", weight=3.0)
    sched.register_tenant("b", weight=1.0)
    for i in range(40):
        sched.enqueue(_item("a", sid=1, task=i))
        sched.enqueue(_item("b", sid=2, task=100 + i))
    got = {"a": 0, "b": 0}
    for _ in range(40):
        item = sched.next_item(timeout=1)
        got[item.tenant] += 1
    assert 28 <= got["a"] <= 32, got                  # 3:1 of 40 = 30/10
    sched.close()


def test_scheduler_strict_class_priority():
    sched = QosScheduler()
    sched.register_tenant("bulk", qos_class="bulk")
    sched.register_tenant("lat", qos_class="latency")
    for i in range(4):
        sched.enqueue(_item("bulk", sid=1, task=i))
    sched.enqueue(_item("lat", sid=2, task=99))
    assert sched.next_item(timeout=1).tenant == "lat"
    assert sched.next_item(timeout=1).tenant == "bulk"
    sched.close()


def test_scheduler_drop_session():
    sched = QosScheduler()
    sched.register_tenant("a")
    sched.register_tenant("b")
    for i in range(3):
        sched.enqueue(_item("a", sid=1, task=i))
    sched.enqueue(_item("b", sid=2, task=9))
    dropped = sched.drop_session(1)
    assert len(dropped) == 3 and all(w.cancelled for w in dropped)
    assert sched.depth() == 1
    assert sched.next_item(timeout=1).tenant == "b"
    sched.close()


class _FakeClock:
    """``time``'s two clocks, advanced only by the test."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def monotonic_ns(self):
        return int(self.now * 1e9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_dispatch_order_matches_jax(monkeypatch, seed):
    """One work-item sequence — tenants of every class, weights, token
    rates, sizes, readahead items, a session dropped midway and a
    reconfigure — fed to both packages' schedulers under one fake clock:
    every dispatch decision (item or gated wait) is the same."""
    from nvme_strom_tpu.daemon import qos as jqos
    clocks = {}
    for mod in (tqos, jqos):
        clk = _FakeClock()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clk.monotonic, monotonic_ns=clk.monotonic_ns))
        clocks[mod] = clk
    rng = random.Random(seed)
    tenants = [(f"t{i}", rng.choice(tqos.QOS_CLASSES),
                rng.choice([0.5, 1.0, 2.0, 3.0]),
                rng.choice([0.0, 0.0, float(1 << 20), float(4 << 20)]))
               for i in range(5)]
    script = []
    for step in range(160):
        r = rng.random()
        if step == 80:
            name, _c, w, rate = tenants[1]
            script.append(("reconf", name, "latency", w * 2, rate))
        elif step == 100:
            script.append(("drop", 3))
        elif r < 0.55:
            k = rng.randrange(len(tenants))
            script.append(("enq", k, rng.choice([1, 2, 4, 16]),
                           rng.random() < 0.1))
        else:
            script.append(("pick", rng.choice([0.0, 0.001, 0.05])))
    script += [("pick", 0.25)] * 200

    def run(mod):
        clk = clocks[mod]
        sched = mod.QosScheduler(quantum=64 << 10)
        for name, cls, w, rate in tenants:
            sched.register_tenant(name, qos_class=cls, weight=w, rate=rate,
                                  burst=256 << 10)
        out, task = [], 0
        for op in script:
            if op[0] == "enq":
                _tag, k, n, spec = op
                task += 1
                it = mod.WorkItem(session_id=k, tenant=tenants[k][0],
                                  task_id=task, source_handle=0,
                                  buf_handle=0, chunk_ids=list(range(n)),
                                  chunk_size=CHUNK, speculative=spec)
                sched.enqueue(it)
            elif op[0] == "drop":
                out.append(("drop", sorted(i.task_id for i in
                                           sched.drop_session(op[1]))))
            elif op[0] == "reconf":
                _tag, name, cls, w, rate = op
                sched.register_tenant(name, qos_class=cls, weight=w,
                                      rate=rate, burst=256 << 10)
            else:
                clk.now += op[1]
                with sched._cv:
                    item, wake = sched._pick(clk.now)
                if item is not None:
                    sched._depth -= 1
                out.append(("pick", None if item is None else
                            (item.tenant, item.task_id),
                            None if wake is None else round(wake, 9)))
        out.append(("depth", sched.depth()))
        sched.close()
        return out

    got, want = run(tqos), run(jqos)
    assert got == want
    assert sum(1 for o in got if o[0] == "pick" and o[1]) > 50


def test_token_bucket_shaping_throttles_end_to_end(tmp_path, data_file):
    """A shaped tenant takes at least the shaped time and trips the
    throttle accounting."""
    d = StromDaemon(str(tmp_path / "s.sock"), allow_fake=True,
                    dispatchers=1).start()
    try:
        before = _counters()
        # 512KB at 1MB/s with a 256KB burst => >= ~0.25s shaped
        with DaemonSession(d.socket_path, tenant="t-shaped",
                           rate=float(1 << 20)) as sess:
            sess.configure(rate=float(1 << 20))
            d._sched.register_tenant("t-shaped", rate=float(1 << 20),
                                     burst=float(256 << 10))
            src = sess.open_source(data_file)
            handle, _buf = sess.alloc_dma_buffer(4 * CHUNK)
            t0 = time.monotonic()
            tids = [sess.memcpy_ssd2ram(src, handle,
                                        [i * 4 + j for j in range(4)],
                                        CHUNK).dma_task_id
                    for i in range(2)]
            for tid in tids:
                sess.memcpy_wait(tid, timeout=60)
            elapsed = time.monotonic() - t0
        after = _counters()
        assert elapsed >= 0.2, \
            f"shaped 512KB at 1MB/s finished in {elapsed:.3f}s"
        assert after["nr_qos_throttle"] > before.get("nr_qos_throttle", 0)
        assert stats.tenant_snapshot()["t-shaped"]["throttles"] >= 1
    finally:
        d.close()


# -- observability -----------------------------------------------------------

def test_trace_events_within_schema(tmp_path, data_file):
    from nvme_strom_tpu_torch.trace import EVENT_SCHEMA, recorder
    config.set("trace_policy", "all")
    recorder.configure()
    try:
        d = StromDaemon(str(tmp_path / "t.sock"), allow_fake=True).start()
        try:
            with DaemonSession(d.socket_path, tenant="t-trace") as sess:
                src = sess.open_source(data_file)
                handle, _buf = sess.alloc_dma_buffer(4 * CHUNK)
                r = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK)
                sess.memcpy_wait(r.dma_task_id, timeout=60)
            time.sleep(0.1)
        finally:
            d.close()
        names = {ev[2] for ev in recorder.snapshot_events()}
        assert names <= set(EVENT_SCHEMA), names - set(EVENT_SCHEMA)
        for want in ("session_attach", "qos_enqueue", "qos_wait",
                     "session_detach"):
            assert want in names, f"{want} never emitted"
    finally:
        config.set("trace_policy", "off")
        recorder.configure()
        recorder.clear()


def test_prometheus_tenant_series(daemon, data_file):
    from nvme_strom_tpu_torch.trace import render_prometheus
    with DaemonSession(daemon.socket_path, tenant="t-prom") as sess:
        src = sess.open_source(data_file)
        handle, _buf = sess.alloc_dma_buffer(4 * CHUNK)
        r = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK)
        sess.memcpy_wait(r.dma_task_id, timeout=60)
    text = render_prometheus(stats.export_payload())
    assert 'strom_tpu_tenant_bytes_total{tenant="t-prom"}' in text
    assert 'strom_tpu_tenant_wait_seconds_bucket{tenant="t-prom"' in text
    assert "strom_tpu_daemon_sessions" in text
    assert "strom_tpu_nr_session_attach_total" in text


def test_daemon_buffer_roundtrip():
    buf = DaemonBuffer(1 << 16)
    view = buf.view()
    view[:4] = b"abcd"
    assert bytes(buf.view()[:4]) == b"abcd"
    buf.close()
    buf.close()                                       # idempotent


# -- leases and restart survival ---------------------------------------------

def test_attach_mints_lease_and_submit_id_dedups(daemon, data_file):
    """Every attach carries a lease token; resubmitting a submit_id
    returns the SAME task instead of enqueuing again."""
    with DaemonSession(daemon.socket_path, tenant="t-lease") as sess:
        assert sess.lease
        src = sess.open_source(data_file)
        handle, buf = sess.alloc_dma_buffer(4 * CHUNK)
        r1 = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK,
                                 submit_id="job-a")
        r2 = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK,
                                 submit_id="job-a")
        assert r2.dma_task_id == r1.dma_task_id
        sess.memcpy_wait(r1.dma_task_id, timeout=60)
        assert bytes(buf.view()[:4 * CHUNK]) == expected_bytes(0, 4 * CHUNK)
        # the wait acked the submit: the same id now names a fresh task
        r3 = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK,
                                 submit_id="job-a")
        assert r3.dma_task_id != r1.dma_task_id
        sess.memcpy_wait(r3.dma_task_id, timeout=60)


def test_lease_reattach_same_daemon(daemon, data_file):
    """A dropped connection re-attaches under its lease token: the daemon
    recognizes it (reattach=True) and handles keep working."""
    with DaemonSession(daemon.socket_path, tenant="t-re") as sess:
        src = sess.open_source(data_file)
        handle, buf = sess.alloc_dma_buffer(4 * CHUNK)
        token = sess.lease
        sess._sock.close()
        assert sess.reattach() is True
        assert sess.lease == token
        r = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK)
        sess.memcpy_wait(r.dma_task_id, timeout=60)
        assert bytes(buf.view()[:4 * CHUNK]) == expected_bytes(0, 4 * CHUNK)


def test_daemon_restart_reattach_and_idempotent_replay(tmp_path, data_file):
    """The daemon dies and restarts on the same socket: reattach() is False
    (the lease adopted fresh), remapped buffers keep their handles, and
    replaying the unacked submit_id re-runs it byte-identically."""
    sock = str(tmp_path / "stromd.sock")
    d1 = StromDaemon(sock, allow_fake=True).start()
    sess = DaemonSession(sock, tenant="t-restart")
    try:
        src = sess.open_source(data_file)
        handle, buf = sess.alloc_dma_buffer(4 * CHUNK)
        r = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK,
                                submit_id="job-1")
        sess.memcpy_wait(r.dma_task_id, timeout=60)
        buf.view()[:4 * CHUNK] = b"\0" * (4 * CHUNK)
        d1.close()
        d2 = StromDaemon(sock, allow_fake=True).start()
        try:
            assert sess.reattach() is False
            r2 = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK,
                                     submit_id="job-1")
            sess.memcpy_wait(r2.dma_task_id, timeout=60)
            assert bytes(buf.view()[:4 * CHUNK]) == \
                expected_bytes(0, 4 * CHUNK)
        finally:
            sess.close()
            d2.close()
    finally:
        d1.close()


def test_kv_pool_over_daemon_qos(daemon, tmp_path):
    """The shared KV pool rides the same admission and QoS path as DMA:
    append/read/write/resume/release round-trip byte-identically through
    stromd with a paired-mirror fake spill."""
    bb = 16 << 10
    paths = []
    for i in range(4):
        p = str(tmp_path / f"spill{i}.bin")
        with open(p, "wb") as f:
            f.truncate(16 * bb)
        paths.append(p)
    with DaemonSession(daemon.socket_path, tenant="t-kv",
                       qos_class="latency") as sess:
        geo = sess.kv_open({"paths": paths, "stripe_chunk_size": bb,
                            "mirror": "paired"}, block_bytes=bb,
                           ram_blocks=4, hbm_blocks=0)
        assert geo["block_bytes"] == bb
        blobs = [bytes([i + 1]) * bb for i in range(8)]
        for i, b in enumerate(blobs):
            assert sess.kv_append("s0", b) == i
        res = sess.kv_residency()
        assert sum(res.values()) == 8 and res["ssd"] > 0
        for i, b in enumerate(blobs):
            assert sess.kv_read("s0", i) == b
        sess.kv_write("s0", 3, b"\xAB" * bb)
        assert sess.kv_read("s0", 3) == b"\xAB" * bb
        assert sess.kv_resume("s0") >= 0
        sess.kv_release("s0")
        assert sum(sess.kv_residency().values()) == 0


def test_strom_daemon_cli_serves_until_sigterm(tmp_path, data_file):
    """``tools/strom_daemon.py`` as its own process: a client lands bytes
    through it, and SIGTERM shuts it down with exit 0."""
    sock = str(tmp_path / "cli.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nvme_strom_tpu_torch.tools.strom_daemon",
         "--socket", sock, "--dispatch", "1", "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, cwd=_REPO)
    try:
        assert "stromd listening on" in proc.stdout.readline()
        with DaemonSession(sock, tenant="t-cli") as sess:
            src = sess.open_source(data_file)
            h, buf = sess.alloc_dma_buffer(8 * CHUNK)
            r = sess.memcpy_ssd2ram(src, h, list(range(8)), CHUNK)
            sess.memcpy_wait(r.dma_task_id, timeout=60)
            assert bytes(buf.view()[:8 * CHUNK]) == \
                expected_bytes(0, 8 * CHUNK)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "shutting down" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


@pytest.fixture
def export_dir(tmp_path, monkeypatch):
    """The port's per-pid export directory under *tmp_path*: a Session
    that starts the process's exporter publishes there (list it before
    ``daemon``, whose Sessions start it)."""
    import importlib
    tstats = importlib.import_module("nvme_strom_tpu_torch.stats")
    d = tmp_path / "exports"
    d.mkdir()
    monkeypatch.setattr(tstats, "STAT_EXPORT_DIR", str(d))
    return d


def test_gpu_stat_daemon_scoreboard(export_dir, daemon, data_file, capsys):
    """``gpu_stat --daemon SOCK`` attaches a monitor tenant and prints the
    daemon's per-tenant scoreboard, as the JAX package's ``tpu_stat
    --daemon`` does against its daemon."""
    from nvme_strom_tpu_torch.tools import gpu_stat
    with DaemonSession(daemon.socket_path, tenant="t-board") as sess:
        src = sess.open_source(data_file)
        handle, _buf = sess.alloc_dma_buffer(4 * CHUNK)
        r = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK)
        sess.memcpy_wait(r.dma_task_id, timeout=60)
        rc = gpu_stat.main(["--daemon", daemon.socket_path])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"stromd @ {daemon.socket_path}: 2 session(s)" in out
    # the scoreboard is the process's: tenants of earlier daemons stay
    rows = {ln.split()[0]: ln.split() for ln in out.splitlines()[2:]}
    assert {"t-board", "_gpu_stat"} <= set(rows)
    assert rows["t-board"][1] == "normal"


def test_strom_daemon_cli_publishes_its_scoreboard(tmp_path, export_dir,
                                                   data_file, capsys):
    """``tools/strom_daemon.py`` exports to the well-known file while it
    serves and once more as it shuts down; ``gpu_stat --daemon`` without a
    socket renders that export's tenants."""
    from nvme_strom_tpu_torch.tools import gpu_stat
    sock, export = str(tmp_path / "cli.sock"), str(tmp_path / "stromd.json")
    env = dict(os.environ, STROM_TPU_STAT_EXPORT=export,
               STROM_STAT_EXPORT_DIR=str(export_dir))
    proc = subprocess.Popen(
        [sys.executable, "-m", "nvme_strom_tpu_torch.tools.strom_daemon",
         "--socket", sock, "--dispatch", "1", "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, cwd=_REPO, env=env)
    try:
        assert "stromd listening on" in proc.stdout.readline()
        with DaemonSession(sock, tenant="t-export") as sess:
            src = sess.open_source(data_file)
            h, buf = sess.alloc_dma_buffer(8 * CHUNK)
            r = sess.memcpy_ssd2ram(src, h, list(range(8)), CHUNK)
            sess.memcpy_wait(r.dma_task_id, timeout=60)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    snap = json.load(open(export))
    assert snap["pid"] == proc.pid
    assert snap["tenants"]["t-export"]["bytes"] == 8 * CHUNK
    assert snap["counters"]["nr_session_attach"] == 1
    rc = gpu_stat.main(["--daemon", "-f", export])
    out = capsys.readouterr().out
    assert rc == 0 and f"pid {proc.pid} tenants:" in out
    assert [ln.split()[0] for ln in out.splitlines()[2:]] == ["t-export"]


# -- the JAX package as the oracle: frames and cross-package wire ------------

def _raw_frames(send, msgs):
    a, b = socket_mod.socketpair()
    try:
        for m in msgs:
            send(a, m)
        a.shutdown(socket_mod.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def test_frames_are_the_jax_packages_bytes():
    from nvme_strom_tpu.daemon import protocol as jproto
    msgs = [{"op": "attach", "version": 1, "tenant": "t", "pid": 7},
            {"op": "submit", "chunk_ids": [3, 1, 2], "chunk_size": 65536,
             "dest_offset": 0, "submit_id": "é"},
            {"ok": False, "errno": 11, "error": "over quota"}]
    assert _raw_frames(tproto.send_msg, msgs) == \
        _raw_frames(jproto.send_msg, msgs)
    assert tproto.PROTOCOL_VERSION == jproto.PROTOCOL_VERSION
    assert tproto.MAX_FRAME == jproto.MAX_FRAME
    assert tproto.default_socket_path(5) == jproto.default_socket_path(5)


def _land(sess, data_file, n=12):
    src = sess.open_source(data_file)
    h, buf = sess.alloc_dma_buffer(n * CHUNK)
    r = sess.memcpy_ssd2ram(src, h, list(range(n)), CHUNK)
    out = sess.memcpy_wait(r.dma_task_id, timeout=60)
    view = bytes(buf.view()[:n * CHUNK])
    # the engine may land chunks out of order: put them back
    got = b"".join(view[out.chunk_ids.index(c) * CHUNK:
                        (out.chunk_ids.index(c) + 1) * CHUNK]
                   for c in range(n))
    sess.unmap_buffer(h)
    src.close()
    return got


def test_port_client_lands_through_a_jax_daemon(tmp_path, data_file):
    from nvme_strom_tpu.daemon.server import StromDaemon as JDaemon
    jd = JDaemon(str(tmp_path / "j.sock"), allow_fake=True).start()
    try:
        with DaemonSession(jd.socket_path, tenant="t-port") as sess:
            assert sess.ping()
            got = _land(sess, data_file)
            assert sess.daemon_stat()["tenants"]["t-port"]["tasks"] == 1
    finally:
        jd.close()
    with StromDaemon(str(tmp_path / "t.sock"), allow_fake=True) as td:
        with DaemonSession(td.socket_path, tenant="t-port") as sess:
            assert _land(sess, data_file) == got
    assert got == expected_bytes(0, 12 * CHUNK)


def test_jax_client_lands_through_a_port_daemon(tmp_path, data_file):
    from nvme_strom_tpu.daemon import DaemonSession as JSession
    with StromDaemon(str(tmp_path / "t.sock"), allow_fake=True) as td:
        with JSession(td.socket_path, tenant="t-jax") as sess:
            assert sess.ping()
            got = _land(sess, data_file)
            info = sess.stat_info()
            assert info.counters["nr_ssd2dev"] >= 1
            assert stats.tenant_snapshot()["t-jax"]["tasks"] == 1
    assert got == expected_bytes(0, 12 * CHUNK)


def test_version_mismatch_fails_closed_across_packages(tmp_path,
                                                       monkeypatch):
    """A port client of another protocol version is refused by a JAX
    daemon, and a JAX client of another version by a port daemon: EPROTO,
    and no session is left behind on either."""
    from nvme_strom_tpu.api import StromError as JStromError
    from nvme_strom_tpu.daemon import client as jclient
    from nvme_strom_tpu.daemon.server import StromDaemon as JDaemon
    jd = JDaemon(str(tmp_path / "j.sock"), allow_fake=True).start()
    try:
        monkeypatch.setattr(tclient, "PROTOCOL_VERSION",
                            PROTOCOL_VERSION + 1)
        with pytest.raises(StromError) as e:
            DaemonSession(jd.socket_path, tenant="t-new")
        assert e.value.errno == errno.EPROTO
        assert jd.session_count() == 0
    finally:
        jd.close()
    monkeypatch.undo()
    with StromDaemon(str(tmp_path / "t.sock"), allow_fake=True) as td:
        monkeypatch.setattr(jclient, "PROTOCOL_VERSION",
                            PROTOCOL_VERSION + 1)
        with pytest.raises(JStromError) as e:
            jclient.DaemonSession(td.socket_path, tenant="t-new")
        assert e.value.errno == errno.EPROTO
        assert td.session_count() == 0


def test_ssd2gpu_daemon_mode_on_the_cpu(daemon, tmp_path, capsys):
    """``ssd2gpu_test --daemon`` with a CPU destination: every segment
    cycles through the memfd ring and lands byte-exact (``-c``), the
    tenant's bytes on the daemon's scoreboard."""
    from nvme_strom_tpu_torch.tools import ssd2gpu_test
    path = str(tmp_path / "big.bin")
    make_test_file(path, 9 * (256 << 10) + 1000)
    rc = ssd2gpu_test.main(["--daemon", daemon.socket_path, "--tenant",
                            "t-ring", "-c", "-d", "cpu", "-s", "512k",
                            "--chunk", "256k", "-n", "2", path])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "all 2359296 bytes OK" in out and "2 memfd ring slots" in out
    assert stats.tenant_snapshot()["t-ring"]["tasks"] == 5
    res = ssd2gpu_test.run_daemon_load(daemon.socket_path, path,
                                       device="cpu", tenant="t-ring",
                                       segment_size=512 << 10,
                                       chunk=256 << 10, drop_cache=False)
    got, ck = res["tensor"].numpy(), 256 << 10
    assert sorted(res["result"].chunk_ids) == list(range(9))
    for slot, cid in enumerate(res["result"].chunk_ids):
        assert bytes(got[slot * ck:(slot + 1) * ck]) == \
            expected_bytes(cid * ck, ck)
    assert res["daemon"]["tenants"]["t-ring"]["tasks"] == 10


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_daemon_landing_into_a_cuda_tensor(daemon, data_file, cuda_device,
                                           tmp_path):
    """``ssd2gpu_test --daemon``: the daemon's DMA lands in memfd ring
    slots, and the client copies them into one CUDA tensor, byte-exact."""
    from nvme_strom_tpu_torch.tools import ssd2gpu_test
    rc = ssd2gpu_test.main(["--daemon", daemon.socket_path, "--tenant",
                            "t-cuda", "-c", "-s", str(4 * CHUNK),
                            data_file])
    assert rc == 0
    assert stats.tenant_snapshot()["t-cuda"]["bytes"] == 32 * CHUNK
