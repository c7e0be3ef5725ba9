"""The fault ladder of the PyTorch port (``fault.py``, the read side of
``engine.Session``) against the JAX package on the same bytes and the same
``FaultPlan``s: the counterparts of ``tests/test_faults.py`` (retry,
buffered degradation, the watchdog, quarantine, hedging, the stress
harness), and the health machine held step by step against the
reference's on seeded event sequences with one injected clock.

What is compared: landed bytes (exact), the latched errno and its class,
and which counters moved.  Backoffs are 0 in every test; no assertion
reads a wall-clock latency."""

import errno
import types

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import nvme_strom_tpu.api as japi
import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.fault as jfault
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.stats import stats as jstats
import nvme_strom_tpu_torch.api as tapi
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.fault as tfault
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.stats import stats as tstats

CHUNK = 64 << 10

PKGS = {
    "jax": types.SimpleNamespace(
        eng=jeng, fake=jfake, cfg=jcfg, api=japi, fault=jfault,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters),
        members=jstats.member_snapshot),
    "torch": types.SimpleNamespace(
        eng=teng, fake=tfake, cfg=tcfg, api=tapi, fault=tfault,
        counters=tstats.snapshot, members=tstats.member_snapshot),
}


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    for cfg in (jcfg, tcfg):
        cfg.set("retry_backoff_ms", 0.0)
    yield
    tcfg.restore(snap)


@pytest.fixture()
def data_file(tmp_path):
    path = str(tmp_path / "data.bin")
    tfake.make_test_file(path, 4 << 20)
    return path


def _both(**kw):
    for cfg in (jcfg, tcfg):
        for k, v in kw.items():
            cfg.set(k, v)


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


def _copy(p, src, ids, timeout=30.0):
    """memcpy + wait through package *p*: ``(bytes or None, errno, error
    class name or None, counter deltas, the session's health transitions
    of member 0)``."""
    before = p.counters()
    got = err = cls = None
    with p.eng.Session() as sess:
        handle, buf = sess.alloc_dma_buffer(len(ids) * CHUNK)
        res = sess.memcpy_ssd2ram(src, handle, ids, CHUNK)
        try:
            sess.memcpy_wait(res.dma_task_id, timeout=timeout)
            got = bytes(buf.view()[:len(ids) * CHUNK])
        except p.api.StromError as e:
            err, cls = e.errno, e.error_class.value
        steps = [(f, t) for _m, f, t, _ts
                 in sess._member_health.transitions(0)]
    return got, err, cls, {k: _delta(before, p.counters(), k)
                           for k in ("nr_io_retry", "nr_io_fallback",
                                     "nr_task_timeout")}, steps


def _run_plan(path, ids, **plan):
    """The same FaultPlan through both packages."""
    out = {}
    for name, p in PKGS.items():
        src = p.fake.FakeNvmeSource(path, fault_plan=p.fake.FaultPlan(**plan),
                                    force_cached_fraction=0.0)
        try:
            out[name] = _copy(p, src, ids)
        finally:
            src.close()
    return out


# ---------------------------------------------------------------------------
# the taxonomy and the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", sorted({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.ENOMEM,
    errno.EBADMSG, errno.EILSEQ, errno.ETIMEDOUT, errno.ENOSPC,
    errno.EDQUOT, errno.EROFS, errno.EBADF, errno.EINVAL, errno.ENODEV}))
def test_errno_classes_match_reference(code):
    mine = tapi.StromError(code, "x")
    ref = japi.StromError(code, "x")
    assert mine.error_class.value == ref.error_class.value
    assert mine.transient == ref.transient
    pinned = tapi.StromError(code, "x",
                             error_class=tapi.ErrorClass.PERSISTENT)
    assert pinned.error_class is tapi.ErrorClass.PERSISTENT


def test_retry_policy_schedule_matches_reference():
    import random
    _both(io_retries=5, retry_backoff_ms=3.0, retry_backoff_max_ms=20.0,
          retry_jitter=0.25)
    mine, ref = tfault.RetryPolicy.from_config(), \
        jfault.RetryPolicy.from_config()
    assert (mine.attempts, mine.backoff_s, mine.backoff_max_s,
            mine.jitter) == (ref.attempts, ref.backoff_s, ref.backoff_max_s,
                             ref.jitter)
    for attempt in range(8):
        assert mine.delay(attempt, random.Random(attempt)) == \
            ref.delay(attempt, random.Random(attempt))


_FAULT_VARS = ("io_retries", "retry_backoff_ms", "retry_backoff_max_ms",
               "retry_jitter", "task_deadline_s", "quarantine_after",
               "quarantine_s", "suspect_ratio", "hedge_policy", "hedge_ms",
               "mirror", "canary_interval_s", "rejoin_successes",
               "rejoin_tokens_s", "write_verify", "io_fallback",
               "cache_threshold")


@pytest.mark.parametrize("name", _FAULT_VARS)
def test_fault_config_defaults_and_bounds_match_reference(name):
    assert tcfg.get(name) == jcfg.get(name)
    bad = {"hedge_policy": "sometimes", "mirror": "triple",
           "retry_jitter": 1.5, "io_retries": 65, "quarantine_after": 0,
           "suspect_ratio": 0.5, "hedge_ms": -1.0, "rejoin_successes": 0,
           "cache_threshold": 1.5, "retry_backoff_ms": -1.0,
           "retry_backoff_max_ms": -1.0, "task_deadline_s": -1.0,
           "quarantine_s": -1.0, "canary_interval_s": -1.0,
           "rejoin_tokens_s": -1.0}.get(name)
    if bad is not None:
        for cfg in (tcfg, jcfg):
            with pytest.raises(ValueError):
                cfg.set(name, bad)


# ---------------------------------------------------------------------------
# transient retry, buffered degradation, the persistent latch
# ---------------------------------------------------------------------------

def test_transient_eio_retries_to_success(data_file):
    _both(dma_max_size=CHUNK)
    out = _run_plan(data_file, list(range(8)), fail_every_nth=3)
    want = tfake.expected_bytes(0, 8 * CHUNK)
    for name, (got, err, _cls, d, _steps) in out.items():
        assert err is None and got == want, name
        assert d["nr_io_retry"] > 0, name


def test_random_eio_load_byte_identical(data_file):
    _both(dma_max_size=CHUNK)
    out = _run_plan(data_file, list(range(32)), fail_rate=0.10, seed=7)
    want = tfake.expected_bytes(0, 32 * CHUNK)
    for name, (got, err, _cls, d, _steps) in out.items():
        assert err is None and got == want, name
        assert d["nr_io_retry"] + d["nr_io_fallback"] > 0, name


def test_persistent_eio_latches_errno(data_file):
    _both(io_retries=1)
    out = _run_plan(data_file, list(range(8)),
                    fail_offsets={3 * CHUNK + 100})
    assert out["torch"][1:3] == out["jax"][1:3] == (errno.EIO, "transient")


def test_buffered_fallback_byte_identical(data_file):
    _both(io_retries=0, dma_max_size=CHUNK)
    out = _run_plan(data_file, list(range(8)), fail_every_nth=1)
    want = tfake.expected_bytes(0, 8 * CHUNK)
    for name, (got, err, _cls, d, _steps) in out.items():
        assert err is None and got == want, name
        assert d["nr_io_fallback"] == 8 and d["nr_io_retry"] == 0, name


def test_fallback_disabled_surfaces_error(data_file):
    _both(io_retries=0, io_fallback=False)
    out = _run_plan(data_file, [0], fail_every_nth=1)
    assert out["torch"][1:3] == out["jax"][1:3] == (errno.EIO, "transient")


def test_failstop_latches_without_retry(data_file):
    """A plan's fail-stop raises PERSISTENT: no retry, no buffered rescue
    (the device is gone), the member FAILED and its EIO latched.  The
    wait re-raises the latched errno, whose class is the errno's own
    (transient), in both packages."""
    out = _run_plan(data_file, list(range(4)), failstop_member=0)
    assert out["torch"][1:3] == out["jax"][1:3] == (errno.EIO, "transient")
    for name, (got, err, cls, d, steps) in out.items():
        assert d["nr_io_retry"] == 0 and d["nr_io_fallback"] == 0, name
        assert steps == [("healthy", "failed")], name


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def test_deadline_expiry_latches_etimedout(data_file):
    _both(task_deadline_s=0.25, dma_max_size=CHUNK)
    out = _run_plan(data_file, list(range(4)), latency_s=0.8)
    for name, (got, err, cls, d, _steps) in out.items():
        assert (err, cls) == (errno.ETIMEDOUT, "timeout"), name
        assert d["nr_task_timeout"] == 1, name


def test_deadline_disabled_no_timeout(data_file):
    _both(task_deadline_s=0.0)
    out = _run_plan(data_file, list(range(4)), latency_s=0.05)
    for name, (got, err, _cls, d, _steps) in out.items():
        assert err is None and got == tfake.expected_bytes(0, 4 * CHUNK)
        assert d["nr_task_timeout"] == 0, name


def test_watchdog_keeps_the_buffer_until_requests_return(data_file):
    """ETIMEDOUT wakes the waiter at once, but a request still reading
    holds the task's buffer: unmap without waiting is EBUSY, unmap with
    waiting drains first (no pinned buffer is unmapped under a copy)."""
    tcfg.set("task_deadline_s", 0.1)
    src = tfake.FakeNvmeSource(data_file,
                               fault_plan=tfake.FaultPlan(latency_s=0.6),
                               force_cached_fraction=0.0)
    try:
        with teng.Session() as sess:
            handle, _buf = sess.alloc_dma_buffer(CHUNK)
            res = sess.memcpy_ssd2ram(src, handle, [0], CHUNK)
            with pytest.raises(tapi.StromError) as e:
                sess.memcpy_wait(res.dma_task_id, timeout=30.0)
            assert e.value.errno == errno.ETIMEDOUT
            assert sess.info_buffer(handle).refcount == 1
            with pytest.raises(tapi.StromError) as e:
                sess.unmap_buffer(handle, wait=False)
            assert e.value.errno == errno.EBUSY
            sess.unmap_buffer(handle)          # drains, then unmaps
            assert handle not in sess.list_buffers()
    finally:
        src.close()


# ---------------------------------------------------------------------------
# quarantine, hedging
# ---------------------------------------------------------------------------

def test_member_quarantine_enters_and_routes_buffered(data_file):
    _both(io_retries=0, dma_max_size=CHUNK, quarantine_after=2,
          quarantine_s=60.0)
    out = _run_plan(data_file, list(range(8)), fail_every_nth=1)
    want = tfake.expected_bytes(0, 8 * CHUNK)
    for name, (got, err, _cls, d, steps) in out.items():
        assert err is None and got == want, name
        assert steps == [("healthy", "quarantined")], name
        assert d["nr_io_fallback"] == 8, name
        assert any(v.get("quarantines", 0) >= 1
                   for v in PKGS[name].members().values()), name
    snap = tstats.member_snapshot()[0]
    assert snap["state"] == "quarantined" and snap["errors"] >= 2


class _FailFirstOnMember:
    """Mixed into each package's FaultPlan: exactly one direct read of
    *member* sleeps past the hedge latch, then raises a transient EIO."""

    def __init__(self, member, delay_s):
        super().__init__()
        self._fail_member, self._delay_s, self._seen = member, delay_s, 0

    def check(self, file_off, length, member=None):
        if member == self._fail_member:
            self._seen += 1
            if self._seen == 1:
                import time
                time.sleep(self._delay_s)
                raise self._err(errno.EIO, "injected primary loss")
        super().check(file_off, length, member=member)


def _plan_class(p):
    return type("Plan", (_FailFirstOnMember, p.fake.FaultPlan),
                {"_err": staticmethod(p.api.StromError)})


def _mirrored(p, tmp_path, plan):
    from nvme_strom_tpu_torch.testing.chaos import (STRIPE,
                                                    make_mirrored_members)
    paths = make_mirrored_members(str(tmp_path))
    return paths, p.fake.FakeStripedNvmeSource(
        paths, stripe_chunk_size=STRIPE, fault_plan=plan,
        force_cached_fraction=0.0, mirror="paired")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_hedged_primary_failure_counts_once(tmp_path, pkg):
    """A hedged chunk whose primary fails after the hedge won takes ONE
    health debit: with quarantine_after=2 and one failing read no
    interleaving can quarantine the member."""
    from nvme_strom_tpu_torch.testing.chaos import (expected_mirrored_stream,
                                                    read_all)
    p = PKGS[pkg]
    _both(io_retries=0, quarantine_after=2, quarantine_s=60.0,
          hedge_policy="fixed", hedge_ms=2.0)
    paths, src = _mirrored(p, tmp_path, _plan_class(p)(0, 0.05))
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            got, total = read_all(sess, src)
            assert got == expected_mirrored_stream(paths)[:total]
            assert sess._member_health.state(0).value != "quarantined"
    finally:
        src.close()
    after = p.counters()
    assert _delta(before, after, "nr_hedge_won") >= 1
    assert _delta(before, after, "nr_member_quarantine") == 0


def test_hedged_reads_take_no_shared_pool_thread(tmp_path):
    """A hedged request's primary runs on its member's pool of legs and
    its hedge leg on the requesting thread: the session's shared pool
    takes neither, so a slow member's primaries, which outlive the
    requests their hedge won, never queue the other members' work."""
    from nvme_strom_tpu_torch.testing.chaos import (expected_mirrored_stream,
                                                    read_all)
    p = PKGS["torch"]
    _both(hedge_policy="fixed", hedge_ms=2.0)
    paths, src = _mirrored(p, tmp_path,
                           p.fake.FaultPlan(slow_member=0, slow_s=0.05))
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            def _refuse(*_a, **_kw):
                raise AssertionError("a hedged leg took a shared thread")
            shared_submit, sess._pool.submit = sess._pool.submit, _refuse
            try:
                got, total = read_all(sess, src)
            finally:
                sess._pool.submit = shared_submit
            assert got == expected_mirrored_stream(paths)[:total]
            legs = [k for k in sess._member_pools if k[1]]
            assert legs and all(m in (0, 1, 2, 3) for m, _ in legs)
    finally:
        src.close()
    assert _delta(before, p.counters(), "nr_hedge_won") >= 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_watchdog_fires_once_with_both_legs_in_flight(tmp_path, pkg):
    from nvme_strom_tpu_torch.testing.chaos import read_all
    p = PKGS[pkg]
    _both(io_retries=0, task_deadline_s=0.25, hedge_policy="fixed",
          hedge_ms=2.0)
    paths, src = _mirrored(p, tmp_path, p.fake.FaultPlan(latency_s=0.8))
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            with pytest.raises(p.api.StromError) as e:
                read_all(sess, src, timeout=30.0)
            assert e.value.errno == errno.ETIMEDOUT
    finally:
        src.close()
    assert _delta(before, p.counters(), "nr_task_timeout") == 1


def test_hedge_p99_latch_from_injected_latencies():
    """hedge_policy=p99 latches at the member's own p99 with hedge_ms the
    floor: the same injected service times give the reference's latch."""
    _both(hedge_policy="p99", hedge_ms=5.0)
    for lat in (1_000_000, 40_000_000):
        mine, ref = tfault.MemberHealthMachine(), \
            jfault.MemberHealthMachine()
        for m in (mine, ref):
            for i in range(64):
                m.observe_latency(0, lat + 1000 * i)
        assert mine.hedge_delay_s(0) == ref.hedge_delay_s(0)
        assert mine.hedge_delay_s(1) == ref.hedge_delay_s(1) == 0.005
    _both(hedge_policy="off")
    assert tfault.MemberHealthMachine().hedge_delay_s(0) is None


# ---------------------------------------------------------------------------
# the health machine, step by step against the reference
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


_EVENT = st.one_of(
    st.tuples(st.just("fail"), st.integers(0, 2), st.booleans()),
    st.tuples(st.just("ok"), st.integers(0, 2), st.just(False)),
    st.tuples(st.just("canary"), st.integers(0, 2), st.booleans()),
    st.tuples(st.just("lat"), st.integers(0, 2),
              st.sampled_from([2_000, 30_000, 900_000, 5_000_000])),
    st.tuples(st.just("allow"), st.integers(0, 2), st.just(False)),
    st.tuples(st.just("away"), st.integers(0, 2), st.just(False)),
    st.tuples(st.just("tick"), st.just(0),
              st.sampled_from([0.01, 0.05, 0.3, 2.0])),
)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(events=st.lists(_EVENT, max_size=120), after=st.integers(1, 4),
       succ=st.integers(1, 3), rate=st.sampled_from([0.0, 4.0, 50.0]))
def test_health_machine_matches_reference_step_by_step(monkeypatch, events,
                                                       after, succ, rate):
    clock = _Clock()
    monkeypatch.setattr(jfault, "time",
                        types.SimpleNamespace(monotonic=clock,
                                              sleep=lambda s: None))
    _both(quarantine_after=after, quarantine_s=0.25, rejoin_successes=succ,
          rejoin_tokens_s=rate, suspect_ratio=3.0)
    mine = tfault.MemberHealthMachine(clock=clock)
    ref = jfault.MemberHealthMachine()
    for kind, m, arg in events:
        if kind == "tick":
            clock.t += arg
            continue
        if kind == "fail":
            res = (mine.record_failure(m, fatal=arg),
                   ref.record_failure(m, fatal=arg))
        elif kind == "ok":
            res = (mine.record_success(m), ref.record_success(m))
        elif kind == "canary":
            res = (mine.record_canary(m, arg), ref.record_canary(m, arg))
        elif kind == "lat":
            for _ in range(8):
                mine.observe_latency(m, arg)
                ref.observe_latency(m, arg)
            res = (None, None)
        elif kind == "allow":
            res = (mine.allow_direct(m), ref.allow_direct(m))
        else:
            res = (mine.routes_away(m), ref.routes_away(m))
        assert res[0] == res[1], (kind, m, arg)
        for k in range(3):
            assert mine.state(k).value == ref.state(k).value
    assert mine.transitions() == ref.transitions()
    assert mine.canary_candidates() == ref.canary_candidates()
    allowed = {(a.value, b.value) for a, b in tfault.ALLOWED_TRANSITIONS}
    assert all((f, t) in allowed for _m, f, t, _ts in mine.transitions())


def test_allowed_transitions_match_reference():
    assert {(a.value, b.value) for a, b in tfault.ALLOWED_TRANSITIONS} == \
        {(a.value, b.value) for a, b in jfault.ALLOWED_TRANSITIONS}


def test_dirty_extent_journal_matches_reference():
    """Records merge, takes come in 1 MiB pieces, put_back re-journals,
    and the pending gauge tracks it, as the reference's."""
    class Sink:
        pass

    sinks = {"torch": Sink(), "jax": Sink()}
    out = {}
    for name, mod in (("torch", tfault), ("jax", jfault)):
        j = mod.DirtyExtentJournal()
        s = sinks[name]
        for off, ln in ((0, 4096), (4096, 8192), (1 << 21, 3 << 20),
                        (100, 10), (1 << 22, 512)):
            j.record(s, 2, off, ln)
        ref = j.sink_refs(2)[0]
        taken = [j.take_extent(ref, 2) for _ in range(3)]
        j.put_back(s, 2, *taken[1])
        out[name] = (taken, j.pending_extents(2), j.pending_bytes(2),
                     j.members())
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# randomized stress (a short slice of the stress harness)
# ---------------------------------------------------------------------------

def test_randomized_fault_plans_short(monkeypatch):
    from nvme_strom_tpu_torch.testing import stress_faults
    monkeypatch.setenv("STROM_STRESS_ROUNDS", "6")
    assert stress_faults.main() == 0


# ---------------------------------------------------------------------------
# checksum verify on read (the counterparts of test_faults.py's checksum
# tests and test_saturation.py's zero-copy one)
# ---------------------------------------------------------------------------

def _heap_file(tmp_path, name="csum.heap", n_pages=4):
    """A checksummed 4-page heap table: ``(path, bytes)``."""
    import numpy as np

    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
    schema = HeapSchema(n_cols=2, visibility=False)
    n = schema.tuples_per_page * n_pages
    path = str(tmp_path / name)
    build_heap_file(path, [np.arange(n, dtype=np.int32),
                           (n - np.arange(n)).astype(np.int32)], schema)
    with open(path, "rb") as f:
        return path, f.read()


def _flip_on_disk(path, off):
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


_CSUM = ("nr_csum_fail", "nr_csum_reread", "bytes_verify_reread")


def _csum_copy(p, path, nbytes, plan):
    """Every 8 KiB page of *path* through a fake under *plan*: ``(bytes
    or None, errno, error class, checksum counters' moves)``."""
    src = p.fake.FakeNvmeSource(path, fault_plan=p.fake.FaultPlan(**plan),
                                force_cached_fraction=0.0)
    before = p.counters()
    got = err = cls = None
    try:
        with p.eng.Session() as sess:
            handle, buf = sess.alloc_dma_buffer(nbytes)
            res = sess.memcpy_ssd2ram(src, handle,
                                      list(range(nbytes // 8192)), 8192)
            try:
                sess.memcpy_wait(res.dma_task_id, timeout=30.0)
                got = bytes(buf.view()[:nbytes])
            except p.api.StromError as e:
                err, cls = e.errno, e.error_class.value
    finally:
        src.close()
    return got, err, cls, {k: _delta(before, p.counters(), k) for k in _CSUM}


@pytest.mark.parametrize("verify,plan", [
    (True, {"corrupt_once_offsets": {8192 + 200}}),
    (True, {"corrupt_offsets": {2 * 8192 + 300}}),
    (False, {"corrupt_offsets": {2 * 8192 + 300}}),
], ids=["once_heals", "persistent_latches", "off_passes"])
def test_checksum_verify_on_the_pools_matches_reference(tmp_path, verify,
                                                        plan):
    """A torn read heals by a re-read; a persistent flip latches EBADMSG
    (CORRUPTION) after ``checksum_retries``; with the verify off the flip
    sails through: the same bytes, errno and counter moves as the JAX
    package."""
    path, data = _heap_file(tmp_path)
    _both(checksum_verify=verify, checksum_retries=2)
    out = {name: _csum_copy(p, path, len(data),
                            {k: set(v) for k, v in plan.items()})
           for name, p in PKGS.items()}
    assert out["torch"] == out["jax"]
    got, err, cls, moved = out["torch"]
    if "corrupt_once_offsets" in plan:
        assert got == data and err is None
        assert moved["nr_csum_fail"] == 1 and moved["nr_csum_reread"] == 1
        assert moved["bytes_verify_reread"] == 8192
    elif verify:
        assert got is None and err == errno.EBADMSG and cls == "corruption"
        assert moved["nr_csum_fail"] == 3 and moved["nr_csum_reread"] == 2
    else:
        assert got != data and len(got) == len(data)
        assert not any(moved.values())


def _staging_verify(p, path, nbytes):
    if p is PKGS["torch"]:
        from nvme_strom_tpu_torch.hbm import HbmRegistry, StagingPipeline
        kw = {"device": "cpu"}
    else:
        from nvme_strom_tpu.hbm import HbmRegistry, StagingPipeline
        kw = {}
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=1.0)
    reg = HbmRegistry()
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            h = reg.map_device_memory(nbytes, **kw)
            try:
                with StagingPipeline(sess, staging_bytes=2 * 8192,
                                     hbm_registry=reg) as pipe:
                    try:
                        pipe.memcpy_ssd2dev(src, h,
                                            list(range(nbytes // 8192)),
                                            8192)
                        err = cls = None
                    except p.api.StromError as e:
                        err, cls = e.errno, e.error_class.value
            finally:
                reg.unmap(h)
    finally:
        src.close()
    return err, cls, {k: _delta(before, p.counters(), k) for k in _CSUM}


def test_staging_ring_verify_catches_writeback_corruption(tmp_path):
    """A flip on disk riding the write-back (page-cache) leg skips the
    engine's direct-read check; the staging ring's check, the last one
    before the card, latches EBADMSG."""
    path, data = _heap_file(tmp_path)
    _flip_on_disk(path, 8192 + 500)
    _both(checksum_verify=True, checksum_retries=1)
    out = {name: _staging_verify(p, path, len(data))
           for name, p in PKGS.items()}
    assert out["torch"] == out["jax"]
    err, cls, moved = out["torch"]
    assert err == errno.EBADMSG and cls == "corruption"
    assert moved["nr_csum_reread"] == 1 and moved["nr_csum_fail"] == 2


def test_staging_ring_verify_heals_a_torn_writeback_read(tmp_path):
    """A write-back chunk torn once is re-read buffered by the ring's
    check and lands whole on the destination."""
    import torch

    from nvme_strom_tpu_torch.hbm import HbmRegistry, StagingPipeline
    path, data = _heap_file(tmp_path)
    tcfg.set("checksum_verify", True)

    class _TornOnce(tfake.FakeNvmeSource):
        torn = False

        def read_buffered(self, offset, dest):
            super().read_buffered(offset, dest)
            if not self.torn and offset <= 3 * 8192 + 7 < offset + len(dest):
                dest[3 * 8192 + 7 - offset] ^= 0xFF
                type(self).torn = True

    src = _TornOnce(path, force_cached_fraction=1.0)
    reg = HbmRegistry()
    before = tstats.snapshot()
    with teng.Session() as sess:
        h = reg.map_device_memory(len(data), device="cpu")
        with StagingPipeline(sess, staging_bytes=2 * 8192,
                             hbm_registry=reg) as pipe:
            pipe.memcpy_ssd2dev(src, h, list(range(len(data) // 8192)), 8192)
        got = bytes(reg.get(h).tensor.numpy())
        reg.unmap(h)
    src.close()
    assert got == data
    assert _delta(before, tstats.snapshot(), "nr_csum_reread") == 1
    assert torch.equal(torch.frombuffer(bytearray(got), dtype=torch.uint8),
                       torch.frombuffer(bytearray(data), dtype=torch.uint8))


def _native_zero_copy(p, path, nbytes):
    p.cfg.set("cache_arbitration", False)
    src = p.eng.PlainSource(path)
    calls = []
    orig = src.read_member_direct

    def traced(member, file_off, buf):
        calls.append((member, file_off, len(buf)))
        return orig(member, file_off, buf)

    # an instance attribute: the type's leg is unchanged, so the native
    # path stays open, and the wait-time re-reads go through the trace
    src.read_member_direct = traced
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            if sess._native is None:
                return None
            handle, _ = sess.alloc_dma_buffer(nbytes)
            res = sess.memcpy_ssd2ram(src, handle,
                                      list(range(nbytes // 8192)), 8192)
            try:
                sess.memcpy_wait(res.dma_task_id, timeout=30.0)
                err = cls = None
            except p.api.StromError as e:
                err, cls = e.errno, e.error_class.value
    finally:
        src.close()
    return err, cls, {k: _delta(before, p.counters(), k) for k in _CSUM}, \
        calls


def test_native_zero_copy_checksum_latches_ebadmsg(tmp_path):
    """A mismatch on a natively landed batch walks the ladder at wait
    time, on the retired task: re-read up to ``checksum_retries``, then
    EBADMSG.  Only the heal re-reads go through the Python read leg."""
    path, data = _heap_file(tmp_path)
    _flip_on_disk(path, 2 * 8192 + 300)
    _both(checksum_verify=True, checksum_retries=2)
    mine = _native_zero_copy(PKGS["torch"], path, len(data))
    if mine is None:
        pytest.skip("the port's Session came up without the native engine")
    err, cls, moved, calls = mine
    assert err == errno.EBADMSG and cls == "corruption"
    assert moved["nr_csum_fail"] == 3 and moved["nr_csum_reread"] == 2
    assert calls == [(0, 2 * 8192, 8192)] * 2
    ref = _native_zero_copy(PKGS["jax"], path, len(data))
    if ref is not None:
        assert ref == mine


def test_native_sync_legs_verify_at_submit(tmp_path):
    """A misaligned tail read buffered beside a native batch is checked
    at submit (it never reaches the wait-time check): a page of it that
    stays corrupt latches EBADMSG there."""
    path, data = _heap_file(tmp_path, n_pages=5)
    with open(path, "ab") as f:      # 5 pages + 100 bytes: the last chunk
        f.write(b"\0" * 100)         # (page 4 and the 100) reads buffered
    _flip_on_disk(path, 4 * 8192 + 50)
    tcfg.set("checksum_verify", True)
    tcfg.set("checksum_retries", 1)
    tcfg.set("cache_arbitration", False)
    before = tstats.snapshot()
    with teng.PlainSource(path) as src, teng.Session() as sess:
        if sess._native is None:
            pytest.skip("the Session came up without the native engine")
        handle, _ = sess.alloc_dma_buffer(3 * 16384)
        with pytest.raises(tapi.StromError) as ei:
            sess.memcpy_ssd2ram(src, handle, [0, 1, 2], 16384)
        assert ei.value.errno == errno.EBADMSG
    assert _delta(before, tstats.snapshot(), "nr_csum_reread") == 1


def _paired_heap(tmp_path, n_pages=8):
    """One mirrored pair of checksummed heap members (member 1 a copy of
    member 0): ``(paths, bytes of the logical stream)``."""
    import shutil
    p0, data = _heap_file(tmp_path, "m0.heap", n_pages=n_pages)
    p1 = str(tmp_path / "m1.heap")
    shutil.copyfile(p0, p1)
    return [p0, p1], data


def _paired_csum_copy(p, paths, nbytes, plan):
    src = p.fake.FakeStripedNvmeSource(
        paths, stripe_chunk_size=16384, fault_plan=plan,
        force_cached_fraction=0.0, mirror="paired")
    before = p.counters()
    got = err = None
    try:
        with p.eng.Session() as sess:
            handle, buf = sess.alloc_dma_buffer(nbytes)
            res = sess.memcpy_ssd2ram(src, handle,
                                      list(range(nbytes // 8192)), 8192)
            try:
                sess.memcpy_wait(res.dma_task_id, timeout=30.0)
                got = bytes(buf.view()[:nbytes])
            except p.api.StromError as e:
                err = e.errno
    finally:
        src.close()
    return got, err, {k: _delta(before, p.counters(), k)
                      for k in _CSUM + ("nr_mirror_read",)}


def test_checksum_reread_heals_from_the_mirror_of_a_routed_away_member(
        tmp_path):
    """Member 0 of a mirrored pair is fail-stopped, so its pages are read
    from member 1, and one of them comes back torn once.  The port reads
    the bad page again through the fault ladder, which routes member 0
    away to member 1 as the first read did, and the bytes heal.  The JAX
    package reads it again from member 0 itself, whose fail-stop latches
    EIO: a divergence the port does not copy."""
    paths, data = _paired_heap(tmp_path)
    _both(checksum_verify=True, checksum_retries=2, io_retries=0,
          dma_max_size=8192)
    out = {name: _paired_csum_copy(
        p, paths, len(data),
        p.fake.FaultPlan(failstop_member=0, failstop_after=0,
                         corrupt_once_offsets={3 * 8192 + 77}))
        for name, p in PKGS.items()}
    got, err, moved = out["torch"]
    assert err is None and got == data
    assert moved["nr_csum_fail"] == 1 and moved["nr_csum_reread"] == 1
    assert moved["bytes_verify_reread"] == 8192
    # every page and the re-read came from the partner
    assert moved["nr_mirror_read"] == len(data) // 8192 + 1
    ref_got, ref_err, ref_moved = out["jax"]
    assert ref_got is None and ref_err == errno.EIO
    assert ref_moved["nr_csum_reread"] == 1


def test_native_checksum_reread_follows_the_mirror_remap(tmp_path):
    """On the native engine a member routed away is read through its
    mirror's fd.  A page torn once there is read again at wait time from
    the mirror, never from the routed-away member, and heals."""
    paths, data = _paired_heap(tmp_path)
    _flip_on_disk(paths[1], 2 * 8192 + 300)
    tcfg.set("checksum_verify", True)
    tcfg.set("checksum_retries", 2)
    tcfg.set("cache_arbitration", False)
    src = teng.StripedSource(paths, 16384, mirror="paired")
    calls = []
    orig = src.read_member_direct

    def torn_once(member, file_off, buf):
        # the flip was a torn read: the disk is whole again by the time
        # the first re-read arrives
        if member == 1 and not calls:
            _flip_on_disk(paths[1], 2 * 8192 + 300)
        calls.append((member, file_off, len(buf)))
        return orig(member, file_off, buf)

    src.read_member_direct = torn_once
    before = tstats.snapshot()
    try:
        with teng.Session() as sess:
            if sess._native is None:
                pytest.skip("the Session came up without the native engine")
            sess._member_health.record_failure(0, fatal=True)
            handle, buf = sess.alloc_dma_buffer(len(data))
            res = sess.memcpy_ssd2ram(src, handle,
                                      list(range(len(data) // 8192)), 8192)
            sess.memcpy_wait(res.dma_task_id, timeout=30.0)
            got = bytes(buf.view()[:len(data)])
    finally:
        src.close()
    assert got == data
    assert calls == [(1, 2 * 8192, 8192)]
    assert _delta(before, tstats.snapshot(), "nr_csum_reread") == 1
