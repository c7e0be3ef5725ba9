"""The write side of the port's fault ladder against the JAX package on
the same ``FaultPlan`` write tiers: the counterparts of
``tests/test_write_faults.py`` (transient retry, the PERSISTENT ENOSPC
latch, mirror fan-out, degraded writes and their journal, the rejoin
replay, ``write_verify``, SUSPECT from write-only traffic, the watchdog,
the adaptive sizer, the buffered tail), each test run on both packages
(``pkg``), plus the native engine's mirrored writes over real files.

SUSPECT is driven by injected service times (the health machine's
``observe_latency`` sees a fixed latency a member), never by the
wall-clock latency of a loaded host.  Backoffs are 0."""

import errno
import os
import types

import pytest

import nvme_strom_tpu.api as japi
import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.stats import stats as jstats
import nvme_strom_tpu_torch.api as tapi
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing.chaos import (STRIPE,
                                                assert_pairs_identical,
                                                await_healthy,
                                                make_mirrored_members,
                                                read_all, write_all)

CHUNK = 64 << 10

PKGS = {
    "jax": types.SimpleNamespace(
        eng=jeng, fake=jfake, cfg=jcfg, api=japi,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters)),
    "torch": types.SimpleNamespace(
        eng=teng, fake=tfake, cfg=tcfg, api=tapi, counters=tstats.snapshot),
}


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    for cfg in (jcfg, tcfg):
        cfg.set("retry_backoff_ms", 0.0)
    yield
    tcfg.restore(snap)


def _set(p, **kw):
    for k, v in kw.items():
        p.cfg.set(k, v)


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


def _writable_fake(p, path, plan=None, size=8 * CHUNK):
    tfake.make_test_file(path, size)
    return p.fake.FakeNvmeSource(path, fault_plan=plan or p.fake.FaultPlan(),
                                 force_cached_fraction=0.0, writable=True)


def _mirrored_writable(p, tmp_path, plan):
    paths = make_mirrored_members(str(tmp_path))
    return paths, p.fake.FakeStripedNvmeSource(
        paths, stripe_chunk_size=STRIPE, fault_plan=plan,
        force_cached_fraction=0.0, mirror="paired", writable=True)


PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


# ---------------------------------------------------------------------------
# transient retry, the persistent latch
# ---------------------------------------------------------------------------

@PKG
def test_transient_write_eio_retries_heal(tmp_path, pkg):
    p = PKGS[pkg]
    _set(p, dma_max_size=CHUNK)
    path = str(tmp_path / "w.bin")
    sink = _writable_fake(p, path, p.fake.FaultPlan(write_fail_every_nth=3))
    payload = os.urandom(8 * CHUNK)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            write_all(sess, sink, payload, chunk=CHUNK)
    finally:
        sink.close()
    with open(path, "rb") as f:
        assert f.read(len(payload)) == payload
    after = p.counters()
    assert _delta(before, after, "nr_write_retry") > 0
    assert _delta(before, after, "nr_io_retry") > 0


@PKG
def test_enospc_latches_first_error_no_retry(tmp_path, pkg):
    p = PKGS[pkg]
    _set(p, io_retries=3, dma_max_size=CHUNK)
    sink = _writable_fake(p, str(tmp_path / "full.bin"),
                          p.fake.FaultPlan(write_fail_every_nth=1,
                                           write_errno=errno.ENOSPC))
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            with pytest.raises(p.api.StromError) as e:
                write_all(sess, sink, os.urandom(4 * CHUNK), chunk=CHUNK,
                          timeout=30.0)
            assert e.value.errno == errno.ENOSPC
            assert e.value.error_class.value == "persistent"
            assert sess._member_health.state(0).value == "failed"
    finally:
        sink.close()
    assert _delta(before, p.counters(), "nr_write_retry") == 0


# ---------------------------------------------------------------------------
# mirror fan-out, degraded journal, rejoin replay
# ---------------------------------------------------------------------------

@PKG
def test_mirror_fanout_byte_identity(tmp_path, pkg):
    p = PKGS[pkg]
    _set(p, dma_max_size=STRIPE)
    paths, sink = _mirrored_writable(p, tmp_path, p.fake.FaultPlan())
    payload = os.urandom(2 << 20)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            write_all(sess, sink, payload, chunk=STRIPE)
            got, total = read_all(sess, sink, chunk=STRIPE)
            assert got == payload[:total]
    finally:
        sink.close()
    assert _delta(before, p.counters(), "nr_mirror_write") == \
        len(payload) // STRIPE
    assert_pairs_identical(paths, "mirror_fanout")


@PKG
def test_degraded_write_journals_skipped_extents(tmp_path, pkg):
    """A primary whose writes fail for good degrades the stream to
    mirror-only: the task retires, the victim's share of the stream is in
    its journal, it routes away, and the mirror serves the payload."""
    p = PKGS[pkg]
    _set(p, io_retries=1, dma_max_size=STRIPE, quarantine_s=60.0,
         canary_interval_s=60.0)
    plan = p.fake.FaultPlan(write_failstop_member=0, write_failstop_after=0)
    paths, sink = _mirrored_writable(p, tmp_path, plan)
    payload = os.urandom(2 << 20)
    try:
        with p.eng.Session() as sess:
            write_all(sess, sink, payload, chunk=STRIPE)
            health = sess._member_health
            assert health.state(0).value != "healthy"
            assert health.routes_away(0)
            want = [(x.file_off, x.file_off + x.length)
                    for x in sink.extents(0, len(payload)) if x.member == 0]
            got = sess._resync.pending_extents(0)
            assert sess._resync.pending_bytes(0) == \
                sum(e - s for s, e in want)
            assert (min(s for s, _ in got), max(s + n for s, n in got)) == \
                (min(s for s, _ in want), max(e for _, e in want))
            got_bytes, total = read_all(sess, sink, chunk=STRIPE)
            assert got_bytes == payload[:total]
    finally:
        sink.close()


@PKG
def test_rejoin_replay_drains_journal_before_healthy(tmp_path, pkg):
    """The canary starts once the write retired (a canary moving the
    victim to REJOINING mid-write races the reference's degraded-write
    check; ``test_write_failure_verdict_is_read_when_the_leg_fails``
    holds the port's repair)."""
    p = PKGS[pkg]
    _set(p, io_retries=1, task_deadline_s=30.0, canary_interval_s=0.0,
         quarantine_s=0.1, rejoin_successes=2, rejoin_tokens_s=1000.0,
         dma_max_size=STRIPE, member_queue_depth=1)
    # a window of 40 write calls surely holds some of member 2's legs
    plan = p.fake.FaultPlan(write_failstop_member=2, write_failstop_after=3,
                            write_rejoin_after=43)
    paths, sink = _mirrored_writable(p, tmp_path, plan)
    payload = os.urandom(2 << 20)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            write_all(sess, sink, payload, chunk=STRIPE)
            p.cfg.set("canary_interval_s", 0.05)
            await_healthy(sess, 2, "rejoin_replay")
            assert sess._resync.pending_bytes(2) == 0
            steps = [(f, t) for _m, f, t, _ts
                     in sess._member_health.transitions(2)]
            assert ("rejoining", "healthy") in steps
            got, total = read_all(sess, sink, chunk=STRIPE)
            assert got == payload[:total]
    finally:
        sink.close()
    assert _delta(before, p.counters(), "nr_resync_extent") > 0
    assert_pairs_identical(paths, "rejoin_replay")


# ---------------------------------------------------------------------------
# write_verify
# ---------------------------------------------------------------------------

@PKG
def test_write_verify_detects_torn_write(tmp_path, pkg):
    p = PKGS[pkg]
    _set(p, write_verify=True)
    sink = _writable_fake(p, str(tmp_path / "torn.bin"),
                          p.fake.FaultPlan(torn_write_offsets={100}),
                          size=2 * CHUNK)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            with pytest.raises(p.api.StromError) as e:
                write_all(sess, sink, os.urandom(2 * CHUNK), chunk=CHUNK,
                          timeout=30.0)
            assert e.value.errno == errno.EBADMSG
            assert e.value.error_class.value == "corruption"
    finally:
        sink.close()
    assert _delta(before, p.counters(), "nr_write_verify_fail") > 0


@PKG
def test_write_verify_clean_pass_counts_reread(tmp_path, pkg):
    p = PKGS[pkg]
    _set(p, write_verify=True)
    path = str(tmp_path / "clean.bin")
    sink = _writable_fake(p, path, size=4 * CHUNK)
    payload = os.urandom(4 * CHUNK)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            write_all(sess, sink, payload, chunk=CHUNK)
    finally:
        sink.close()
    with open(path, "rb") as f:
        assert f.read(len(payload)) == payload
    after = p.counters()
    assert _delta(before, after, "nr_write_verify_fail") == 0
    assert _delta(before, after, "bytes_verify_reread") >= len(payload)


# ---------------------------------------------------------------------------
# SUSPECT, the watchdog and the sizer from write-only traffic
# ---------------------------------------------------------------------------

#: the service time each member's write legs report to the health machine
_INJECTED_NS = {0: 200_000, 1: 8_000_000}


@PKG
def test_write_only_traffic_drives_suspect(tmp_path, pkg):
    """A member that is only ever written, never read, turns SUSPECT:
    write legs feed the same per-member histograms as reads.  Each leg's
    measured time is replaced by a fixed one a member (member 1 forty
    times member 0), so the verdict is the machine's, not the host's
    load."""
    p = PKGS[pkg]
    _set(p, suspect_ratio=3.0, dma_max_size=STRIPE)
    size = 512 << 10
    paths = [str(tmp_path / f"s{i}.bin") for i in range(2)]
    for q in paths:
        tfake.make_test_file(q, size)
    sink = p.fake.FakeStripedNvmeSource(paths, stripe_chunk_size=STRIPE,
                                        force_cached_fraction=0.0,
                                        writable=True)
    payload = os.urandom(2 * size)
    try:
        with p.eng.Session() as sess:
            health = sess._member_health
            real = health.observe_latency
            seen = []

            def injected(member, ns):
                seen.append(member)
                real(member, _INJECTED_NS[member])

            health.observe_latency = injected
            # the predicate runs every 32 samples of a member once both
            # members hold 32: stream until it has run (8 legs a member a
            # pass)
            for _ in range(10):
                write_all(sess, sink, payload, chunk=STRIPE)
                if health.state(1).value == "suspect":
                    break
            assert sorted(set(seen)) == [0, 1]
            assert health.state(1).value == "suspect"
            assert health.state(0).value == "healthy"
            assert [(f, t) for _m, f, t, _ts in health.transitions()] == \
                [("healthy", "suspect")]
    finally:
        sink.close()


@PKG
def test_write_deadline_rides_watchdog(tmp_path, pkg):
    p = PKGS[pkg]
    _set(p, task_deadline_s=0.25, dma_max_size=CHUNK)
    sink = _writable_fake(p, str(tmp_path / "slow.bin"),
                          p.fake.FaultPlan(slow_write_member=0,
                                           slow_write_s=0.8),
                          size=4 * CHUNK)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            with pytest.raises(p.api.StromError) as e:
                write_all(sess, sink, os.urandom(4 * CHUNK), chunk=CHUNK,
                          timeout=30.0)
            assert e.value.errno == errno.ETIMEDOUT
    finally:
        sink.close()
    assert _delta(before, p.counters(), "nr_task_timeout") == 1


@PKG
def test_write_latency_shrinks_adaptive_sizer(tmp_path, pkg):
    """Write service times feed the member's adaptive sizer: a write leg
    past the sizer's 100 ms budget (0.12 s injected; a loaded host only
    makes it slower) halves the coalescing cap."""
    p = PKGS[pkg]
    _set(p, chunk_adaptive=True, dma_max_size=CHUNK,
         coalesce_limit=4 * CHUNK)
    sink = _writable_fake(p, str(tmp_path / "adapt.bin"),
                          p.fake.FaultPlan(slow_write_member=0,
                                           slow_write_s=0.12),
                          size=2 * CHUNK)
    try:
        with p.eng.Session() as sess:
            write_all(sess, sink, os.urandom(2 * CHUNK), chunk=CHUNK,
                      timeout=30.0)
            szr = sess._chunk_sizers.get(0)
            assert szr is not None and szr.effective < 4 * CHUNK
    finally:
        sink.close()


@PKG
def test_buffered_tail_rides_pool_ladder(tmp_path, pkg):
    """A misaligned file tail plans as a buffered write leg on the same
    policed ladder: it lands exactly and its traced extent span says
    buffered."""
    p = PKGS[pkg]
    trace = __import__(f"{p.eng.__name__.rsplit('.', 1)[0]}.trace",
                       fromlist=["recorder"])
    _set(p, trace_policy="all")
    trace.recorder.configure()
    trace.recorder.clear()
    tail = 1000
    path = str(tmp_path / "tail.bin")
    sink = _writable_fake(p, path, size=CHUNK + tail)
    payload = os.urandom(CHUNK + tail)
    try:
        with p.eng.Session() as sess:
            handle, buf = sess.alloc_dma_buffer(2 * CHUNK)
            try:
                buf.view()[:len(payload)] = payload
                res = sess.memcpy_ram2ssd(sink, handle, [0, 1], CHUNK)
                sess.memcpy_wait(res.dma_task_id)
                sink.sync()
            finally:
                sess.unmap_buffer(handle)
    finally:
        sink.close()
        spans = [e for e in trace.recorder.snapshot_events()
                 if e[trace._NAME] == "extent"
                 and (e[trace._ARGS] or {}).get("write")]
        p.cfg.set("trace_policy", "off")
        trace.recorder.configure()
        trace.recorder.clear()
    with open(path, "rb") as f:
        assert f.read() == payload
    assert any((e[trace._ARGS] or {}).get("buffered") for e in spans)


# ---------------------------------------------------------------------------
# the native engine's mirrored writes (real files, no fake legs)
# ---------------------------------------------------------------------------

def test_native_paired_write_lands_on_both_partners(tmp_path):
    """A plain paired StripedSource writes through the native engine:
    every aligned leg lands on both partners (the pairs identical,
    nr_mirror_write one a request), and reads back as the payload."""
    paths = make_mirrored_members(str(tmp_path))
    payload = os.urandom(2 << 20)
    before = tstats.snapshot()
    with teng.StripedSource(paths, STRIPE, writable=True,
                            mirror="paired") as sink, \
            teng.Session() as sess:
        if sess._native is None:
            pytest.skip("the native engine did not come up here")
        write_all(sess, sink, payload, chunk=256 << 10)
        got, total = read_all(sess, sink)
        assert got == payload[:total]
    assert _delta(before, tstats.snapshot(), "nr_mirror_write") == \
        len(payload) // STRIPE
    assert_pairs_identical(paths, "native_paired_write")


def test_native_degraded_write_journals_the_routed_away_member(tmp_path):
    """On the native engine a member routed away is skipped and its
    extents journaled: the partner holds the payload, the failed member
    the old bytes, until a replay."""
    paths = make_mirrored_members(str(tmp_path))
    with open(paths[2], "rb") as f:
        old = f.read()
    payload = os.urandom(2 << 20)
    tcfg.set("canary_interval_s", 0.0)
    with teng.StripedSource(paths, STRIPE, writable=True,
                            mirror="paired") as sink, \
            teng.Session() as sess:
        if sess._native is None:
            pytest.skip("the native engine did not come up here")
        sess._member_health.record_failure(2, fatal=True)
        write_all(sess, sink, payload, chunk=256 << 10)
        assert sess._resync.pending_bytes(2) == 1 << 20
        got, total = read_all(sess, sink)
        assert got == payload[:total]
    with open(paths[2], "rb") as f:
        assert f.read() == old
    with open(paths[3], "rb") as f:
        assert f.read() != old


class _RejoinMidLeg:
    """Mixed into each package's FaultPlan: the first write of member 0
    fails PERSISTENT (FAILED), and while member 1's partner leg of that
    request is in flight a canary success moves member 0 to REJOINING,
    as the canary thread can."""

    def __init__(self, health_box):
        super().__init__()
        self._box = health_box
        self._done = False

    def check_write(self, file_off, length, member=None):
        if member == 0 and not self._done:
            self._done = True
            raise self._err(errno.EIO, "injected fail-stop",
                            error_class=self._cls.PERSISTENT)
        if member == 1 and self._done and self._box:
            self._box.pop().record_canary(0, True)
        super().check_write(file_off, length, member=member)


@PKG
def test_write_failure_verdict_is_read_when_the_leg_fails(tmp_path, pkg):
    """† A paired write whose primary leg fails for good lands on the
    mirror and journals the primary's miss, even when the canary moves
    the primary to REJOINING before the mirror leg ends: the port reads
    the verdict when the leg fails.  The reference reads it after the
    mirror leg, finds REJOINING (no debt yet, so not routed away) and
    latches the error, leaving the pair diverged with nothing
    journaled."""
    p = PKGS[pkg]
    _set(p, io_retries=0, dma_max_size=STRIPE, canary_interval_s=0.0,
         member_queue_depth=1)
    paths = make_mirrored_members(str(tmp_path), n_pairs=1)
    box = []
    plan = type("Plan", (_RejoinMidLeg, p.fake.FaultPlan),
                {"_err": staticmethod(p.api.StromError),
                 "_cls": p.api.ErrorClass})(box)
    sink = p.fake.FakeStripedNvmeSource(
        paths, stripe_chunk_size=STRIPE, fault_plan=plan,
        force_cached_fraction=0.0, mirror="paired", writable=True)
    payload = os.urandom(STRIPE)
    try:
        with p.eng.Session() as sess:
            box.append(sess._member_health)
            err = None
            try:
                write_all(sess, sink, payload, chunk=STRIPE)
            except p.api.StromError as e:
                err = e
            pending = sess._resync.pending_bytes(0)
    finally:
        sink.close()
    with open(paths[1], "rb") as f:
        assert f.read(STRIPE) == payload          # the mirror leg landed
    if pkg == "torch":
        assert err is None and pending == STRIPE
    else:
        assert err is not None and err.errno == errno.EIO and pending == 0
