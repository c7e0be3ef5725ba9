"""Deterministic chaos harness of the member-health stack: the JAX
package's ``testing/chaos.py``.

Each scenario drives a seeded fault schedule through a mirrored striped
loopback set (and one native-engine leg against real files) and checks
the survival contract:

* the copy is byte-identical to the healthy stream (the mirror served a
  failed member's extents at direct speed, or the retry and buffered rungs
  healed the damage);
* the run stays inside a bounded deadline: never a hang;
* every health transition walks an edge of
  :data:`..fault.ALLOWED_TRANSITIONS`.

Read scenarios: ``fail_stop`` (slow, hedged, then dead mid-task, traced),
``flaky`` (random transient EIO), ``slow_hedge`` (hedges beat a slow
member), ``corrupt_once`` (a torn read caught by the page checksums and
healed by a re-read), ``rejoin`` (fail-stop, then back through canary
probes alone), ``native_degraded`` (the native lanes read a FAILED
member's extents from its mirror's fd), ``cache_churn`` (the RAM tier far
below the stream, filling and evicting while a member fail-stops and a
write invalidates, traced) and ``scrub_heal`` (a byte flipped in a RAM
slab, caught and healed by the scrubber; then a KV spill block's rotten
primary leg healed from its mirror at page-in, the member debited).
Write scenarios: ``write_failstop`` (mirror-only writes, then the journal
replayed before HEALTHY), ``write_enospc`` (the first ENOSPC latches, no
retry), ``write_torn_mirror`` (a replica dies between the legs, healed
under ``write_verify``) and ``ckpt_crash`` (a SIGKILL mid-save leaves the
installed checkpoint whole).

``python -m nvme_strom_tpu_torch.testing.chaos [read|write|all]
[-d DEVICE]``; the schedule is fixed by ``STROM_CHAOS_SEED`` (default
1234), ``STROM_CHAOS_ROUNDS`` sweeps it again with derived seeds.  The
checkpoint scenario restores to ``-d`` (default ``cuda:0``).
"""

from __future__ import annotations

import os
import random
import shutil
import sys
import tempfile
import time

STRIPE = 64 << 10
CHUNK = 256 << 10
MEMBER_SIZE = 1 << 20          # a member: 4 members -> 2 MiB logical, paired


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def make_mirrored_members(dirpath: str, n_pairs: int = 2,
                          size: int = MEMBER_SIZE, tag: str = "m"):
    """2 * n_pairs member files, member 2k+1 a byte-identical copy of
    member 2k: the ``mirror='paired'`` layout on disk."""
    from .fake import make_test_file
    paths = []
    for k in range(n_pairs):
        p = os.path.join(dirpath, f"{tag}{2 * k}.bin")
        make_test_file(p, size, seed=100 + k)
        q = os.path.join(dirpath, f"{tag}{2 * k + 1}.bin")
        shutil.copyfile(p, q)
        paths += [p, q]
    return paths


def expected_mirrored_stream(paths, stripe_chunk: int = STRIPE) -> bytes:
    """The logical stream of a paired set: RAID-0 over the even members
    (the odd ones are replicas, not address space)."""
    parts = []
    for p in paths[::2]:
        with open(p, "rb") as f:
            parts.append(f.read())
    nm = len(parts)
    total = sum(len(p) for p in parts)
    out = bytearray(total)
    for i in range(total // stripe_chunk):
        m, row = i % nm, i // nm
        out[i * stripe_chunk:(i + 1) * stripe_chunk] = \
            parts[m][row * stripe_chunk:(row + 1) * stripe_chunk]
    return bytes(out)


def read_all(sess, src, chunk: int = CHUNK, timeout: float = 60.0):
    """A whole-source memcpy; returns ``(bytes in chunk order, total)``."""
    import numpy as np

    from ..engine import reorder_chunks
    total = src.size // chunk * chunk
    handle, buf = sess.alloc_dma_buffer(total)
    want = list(range(total // chunk))
    res = sess.memcpy_ssd2ram(src, handle, want, chunk)
    sess.memcpy_wait(res.dma_task_id, timeout=timeout)
    host = reorder_chunks(np.frombuffer(buf.view()[:total], np.uint8),
                          chunk, res.chunk_ids, want)
    return bytes(host), total


def write_all(sess, sink, payload: bytes, chunk: int = CHUNK,
              timeout: float = 60.0) -> None:
    """A whole-stream RAM→SSD write of *payload*, waited and synced."""
    handle, buf = sess.alloc_dma_buffer(len(payload))
    try:
        buf.view()[:len(payload)] = payload
        res = sess.memcpy_ram2ssd(sink, handle,
                                  list(range(len(payload) // chunk)), chunk)
        sess.memcpy_wait(res.dma_task_id, timeout=timeout)
        sink.sync()
    finally:
        sess.unmap_buffer(handle)


def assert_transitions_legal(sess, scenario: str) -> None:
    """Every logged health transition is an ALLOWED_TRANSITIONS edge."""
    from ..fault import ALLOWED_TRANSITIONS
    allowed = {(a.value, b.value) for a, b in ALLOWED_TRANSITIONS}
    for member, frm, to, _t in sess._member_health.transitions():
        if (frm, to) not in allowed:
            raise AssertionError(f"{scenario}: illegal health transition "
                                 f"{frm}->{to} on member {member}")


def assert_pairs_identical(paths, scenario: str) -> None:
    """Every mirror pair holds byte-identical files."""
    for pri in range(0, len(paths), 2):
        with open(paths[pri], "rb") as a, open(paths[pri + 1], "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{scenario}: mirror pair {pri}/"
                                     f"{pri + 1} diverged after resync")


def await_healthy(sess, member: int, scenario: str,
                  deadline_s: float = 20.0) -> None:
    """Wait for *member* to reach HEALTHY, else raise."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if sess._member_health.state(member).value == "healthy":
            return
        time.sleep(0.05)
    raise AssertionError(f"{scenario}: member {member} stuck in "
                         f"{sess._member_health.state(member)} with "
                         f"{sess._resync.pending_bytes(member)} resync bytes "
                         f"pending")


def _counter(name: str) -> int:
    from ..stats import stats
    return stats.snapshot().get(name, 0)


def _paired_fake(paths, plan, **kw):
    from .fake import FakeStripedNvmeSource
    return FakeStripedNvmeSource(paths, stripe_chunk_size=STRIPE,
                                 fault_plan=plan, force_cached_fraction=0.0,
                                 mirror="paired", **kw)


# ---------------------------------------------------------------------------
# read scenarios: each returns a short tag for the tally
# ---------------------------------------------------------------------------

def scenario_fail_stop(rng: random.Random, dirpath: str,
                       device=None) -> str:
    """A mirrored member turns slow, loses a hedge race or two, then
    fail-stops mid-task: the copy is byte-identical with the dead member's
    extents served by its mirror, the member lands in FAILED, and the
    flight recorder (``trace_policy=all`` here) dumps a valid trace with
    the hedge and the mirror read on the victim's track."""
    from ..config import config
    from ..engine import Session
    from ..fault import HealthState
    from ..trace import recorder, validate_chrome_trace
    from .fake import FaultPlan

    config.set("io_retries", 1)
    config.set("task_deadline_s", 30.0)
    config.set("canary_interval_s", 0.0)   # no probes: FAILED must hold
    config.set("hedge_policy", "fixed")
    config.set("hedge_ms", 5.0)
    # one request at a time a member: the fail-stop bites mid-stream and
    # the later extents walk the route-away/mirror rung
    config.set("member_queue_depth", 1)
    config.set("trace_policy", "all")
    recorder.configure()
    recorder.clear()
    victim = rng.choice([0, 2])
    plan = FaultPlan(failstop_member=victim,
                     failstop_after=rng.randrange(2, 8),
                     slow_member=victim, slow_s=0.05)
    paths = make_mirrored_members(dirpath,
                                  tag=f"fs{rng.randrange(1 << 16)}-")
    src = _paired_fake(paths, plan)
    mirrors_before = _counter("nr_mirror_read")
    try:
        with Session() as sess:
            got, total = read_all(sess, src)
            assert got == expected_mirrored_stream(paths)[:total], \
                "fail_stop: degraded copy diverged from healthy stream"
            # a straggler success from a read issued before the fail-stop
            # may have begun a doomed warmup: REJOINING is legal too
            assert sess._member_health.state(victim) in \
                (HealthState.FAILED, HealthState.REJOINING), \
                f"fail_stop: member {victim} ended " \
                f"{sess._member_health.state(victim)}"
            assert_transitions_legal(sess, "fail_stop")
    finally:
        src.close()
        doc = recorder.chrome_trace("chaos fail_stop")
        config.set("trace_policy", "off")
        recorder.configure()
        recorder.clear()
    errs = validate_chrome_trace(doc)
    assert not errs, f"fail_stop: trace fails its schema check: {errs[:5]}"
    names = {(e.get("name"), e.get("tid")) for e in doc["traceEvents"]}
    vt = 100 + victim
    assert ("hedge_issued", vt) in names or ("hedge_won", vt) in names, \
        "fail_stop: no hedge event on the victim's track"
    assert ("mirror_read", vt) in names, \
        "fail_stop: no mirror_read on the victim's track"
    assert _counter("nr_mirror_read") > mirrors_before, \
        "fail_stop: no extent was served from the mirror"
    return "fail_stop"


def scenario_flaky(rng: random.Random, dirpath: str, device=None) -> str:
    """Random transient EIO across the set: the retry ladder (and the
    mirror legs) heal every chunk."""
    from ..config import config
    from ..engine import Session
    from .fake import FaultPlan

    config.set("io_retries", rng.choice([2, 3]))
    config.set("retry_backoff_ms", 1.0)
    config.set("task_deadline_s", 30.0)
    plan = FaultPlan(fail_rate=rng.choice([0.05, 0.1, 0.2]),
                     seed=rng.randrange(1 << 30))
    paths = make_mirrored_members(dirpath,
                                  tag=f"fl{rng.randrange(1 << 16)}-")
    src = _paired_fake(paths, plan)
    try:
        with Session() as sess:
            got, total = read_all(sess, src)
            assert got == expected_mirrored_stream(paths)[:total], \
                "flaky: healed copy diverged from healthy stream"
            assert_transitions_legal(sess, "flaky")
    finally:
        src.close()
    return "flaky"


def scenario_slow_hedge(rng: random.Random, dirpath: str,
                        device=None) -> str:
    """One member serves every read slowly: hedges re-issue its chunks on
    the mirror and the task ends well inside the primaries' serial
    cost."""
    from ..config import config
    from ..engine import Session
    from .fake import FaultPlan

    slow_s = 0.15
    config.set("io_retries", 1)
    config.set("task_deadline_s", 30.0)
    config.set("hedge_policy", "fixed")
    config.set("hedge_ms", 5.0)
    victim = rng.choice([0, 2])
    plan = FaultPlan(slow_member=victim, slow_s=slow_s)
    paths = make_mirrored_members(dirpath,
                                  tag=f"sl{rng.randrange(1 << 16)}-")
    src = _paired_fake(paths, plan)
    issued_before = _counter("nr_hedge_issued")
    won_before = _counter("nr_hedge_won")
    try:
        with Session() as sess:
            t0 = time.monotonic()
            got, total = read_all(sess, src)
            wall = time.monotonic() - t0
            assert got == expected_mirrored_stream(paths)[:total], \
                "slow: hedged copy diverged from healthy stream"
            n_victim = (total // STRIPE) // 2
            assert wall < n_victim * slow_s, \
                f"slow: {wall:.2f} s suggests hedges never won (serial " \
                f"primary cost ~{n_victim * slow_s:.2f} s)"
            assert_transitions_legal(sess, "slow")
    finally:
        src.close()
    assert _counter("nr_hedge_issued") > issued_before, \
        "slow: no hedge was ever issued"
    assert _counter("nr_hedge_won") > won_before, \
        f"slow: hedges issued but none won against a member " \
        f"{slow_s * 1e3:.0f} ms slow"
    return "slow"


def scenario_corrupt_once(rng: random.Random, dirpath: str,
                          device=None) -> str:
    """A torn read (a bit flip that heals on a re-read): the page
    checksums catch it and the re-read repairs it transparently."""
    import numpy as np

    from ..config import config
    from ..engine import Session
    from ..scan.heap import PAGE_SIZE, HeapSchema, build_heap_file
    from .fake import FakeNvmeSource, FaultPlan

    config.set("checksum_verify", True)
    config.set("task_deadline_s", 30.0)
    schema = HeapSchema(n_cols=2, visibility=False)
    n = schema.tuples_per_page * 4
    path = os.path.join(dirpath, f"co{rng.randrange(1 << 16)}.heap")
    build_heap_file(path, [np.arange(n, dtype=np.int32),
                           (n - np.arange(n)).astype(np.int32)], schema)
    with open(path, "rb") as f:
        data = f.read()
    page = rng.randrange(len(data) // PAGE_SIZE)
    plan = FaultPlan(corrupt_once_offsets={page * PAGE_SIZE
                                           + rng.randrange(64, PAGE_SIZE)})
    src = FakeNvmeSource(path, fault_plan=plan, force_cached_fraction=0.0)
    rereads_before = _counter("nr_csum_reread")
    try:
        with Session() as sess:
            handle, buf = sess.alloc_dma_buffer(len(data))
            res = sess.memcpy_ssd2ram(src, handle,
                                      list(range(len(data) // PAGE_SIZE)),
                                      PAGE_SIZE)
            sess.memcpy_wait(res.dma_task_id, timeout=30.0)
            assert bytes(buf.view()[:len(data)]) == data, \
                "corrupt_once: repaired copy diverged"
    finally:
        src.close()
    assert _counter("nr_csum_reread") > rereads_before, \
        "corrupt_once: the flip was never detected and re-read"
    return "corrupt_once"


def scenario_rejoin(rng: random.Random, dirpath: str, device=None) -> str:
    """Fail-stop, then recovery: the member walks healthy -> failed in
    the task, then, through canary probes alone, failed -> rejoining ->
    healthy once the device answers."""
    from ..config import config
    from ..engine import Session
    from ..fault import HealthState
    from .fake import FaultPlan

    config.set("io_retries", 1)
    config.set("task_deadline_s", 30.0)
    config.set("canary_interval_s", 0.05)
    config.set("quarantine_s", 0.2)
    config.set("rejoin_successes", 2)
    config.set("rejoin_tokens_s", 1000.0)
    victim = rng.choice([0, 2])
    after = rng.randrange(2, 6)
    # the dead window outlives the task's own reads: recovery is the
    # canaries' doing
    plan = FaultPlan(failstop_member=victim, failstop_after=after,
                     rejoin_after=after + rng.randrange(45, 65))
    paths = make_mirrored_members(dirpath,
                                  tag=f"rj{rng.randrange(1 << 16)}-")
    src = _paired_fake(paths, plan)
    canaries_before = _counter("nr_canary_probe")
    rejoins_before = _counter("nr_member_rejoin")
    try:
        with Session() as sess:
            got, total = read_all(sess, src)
            assert got == expected_mirrored_stream(paths)[:total], \
                "rejoin: degraded copy diverged from healthy stream"
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and \
                    sess._member_health.state(victim) \
                    is not HealthState.HEALTHY:
                time.sleep(0.05)
            assert sess._member_health.state(victim) is \
                HealthState.HEALTHY, f"rejoin: member {victim} stuck in " \
                f"{sess._member_health.state(victim)}"
            steps = [(frm, to) for _m, frm, to, _t
                     in sess._member_health.transitions(victim)]
            for edge in [("failed", "rejoining"), ("rejoining", "healthy")]:
                assert edge in steps, \
                    f"rejoin: member {victim} never took {edge}: {steps}"
            assert_transitions_legal(sess, "rejoin")
    finally:
        src.close()
    assert _counter("nr_canary_probe") > canaries_before, \
        "rejoin: no canary probe ever ran"
    assert _counter("nr_member_rejoin") > rejoins_before, \
        "rejoin: warmup never completed"
    return "rejoin"


def scenario_native_degraded(rng: random.Random, dirpath: str,
                             device=None) -> str:
    """With a primary FAILED before submit, the native lanes read its
    extents through the mirror's fd and lane and still deliver the
    healthy stream."""
    from ..config import config
    from ..engine import Session, StripedSource

    class _Direct(StripedSource):
        def cached_fraction(self, offset, length):
            return 0.0

    config.set("task_deadline_s", 30.0)
    paths = make_mirrored_members(dirpath,
                                  tag=f"nd{rng.randrange(1 << 16)}-")
    src = _Direct(paths, stripe_chunk_size=STRIPE, mirror="paired")
    mirrors_before = _counter("nr_mirror_read")
    try:
        with Session() as sess:
            if sess._native is None:
                return "native_skipped"
            victim = rng.choice([0, 2])
            sess._member_health.record_failure(victim, fatal=True)
            got, total = read_all(sess, src)
            assert got == expected_mirrored_stream(paths)[:total], \
                "native_degraded: remapped copy diverged"
            assert_transitions_legal(sess, "native_degraded")
    finally:
        src.close()
    assert _counter("nr_mirror_read") > mirrors_before, \
        "native_degraded: no request was remapped to the mirror fd"
    return "native_degraded"


def _tiers_off(config) -> None:
    """Turn the RAM tier off again and empty it (a scenario's cleanup)."""
    from ..cache import residency_cache
    config.set("cache_bytes", 0)
    residency_cache.clear()
    residency_cache.configure()


def scenario_scrub_heal(rng: random.Random, dirpath: str,
                        device=None) -> str:
    """Seeded bit rot across the hierarchy.  Phase A: a byte flipped in a
    resident RAM slab; the background scrubber detects it, drops the slab
    and fills it again from the SSD through the fault ladder.  Phase B: a
    KV spill block whose primary mirror leg rots on disk is healed from
    the surviving replica at page-in, the rotten member debited into
    QUARANTINED (``quarantine_after=1``).  Every read stays
    byte-identical throughout."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from ..fault import HealthState
    from ..serving.kvcache import KvBlockPool
    from .fake import FakeStripedNvmeSource, FaultPlan, flip_resident_host

    config.set("io_retries", 2)
    config.set("task_deadline_s", 30.0)
    config.set("integrity", "always")
    config.set("scrub_bytes_per_sec", 1 << 30)
    config.set("cache_arbitration", False)
    config.set("cache_bytes", 16 * CHUNK)   # the whole stream stays resident
    config.set("dma_max_size", CHUNK)
    config.set("canary_interval_s", 0.0)    # the debit must hold
    config.set("quarantine_after", 1)
    config.set("quarantine_s", 60.0)
    residency_cache.clear()
    paths = make_mirrored_members(dirpath, tag=f"sh{rng.randrange(1 << 16)}-")
    src = FakeStripedNvmeSource(paths, stripe_chunk_size=STRIPE,
                                force_cached_fraction=0.0, mirror="paired")
    # the KV spill set: every member-0 block row carries one seeded rotten
    # byte (flipped once the covering page-out landed); the mirror leg on
    # member 1 stays clean, so each page-in heal is the mirror's
    bbk = 16 << 10
    rows = 4
    rot = rng.randrange(64, bbk - 64)
    spaths = []
    for i in range(4):
        sp = os.path.join(dirpath, f"kv{rng.randrange(1 << 16)}-{i}.bin")
        with open(sp, "wb") as f:
            f.truncate(rows * bbk)
        spaths.append(sp)
    plan = FaultPlan(corrupt_member_offsets={
        0: {row * bbk + rot for row in range(rows)}})
    spill = FakeStripedNvmeSource(spaths, bbk, fault_plan=plan,
                                  force_cached_fraction=0.0,
                                  mirror="paired", writable=True)
    want = expected_mirrored_stream(paths)
    fails0 = _counter("nr_integrity_fail")
    repairs0 = _counter("nr_scrub_repair")
    try:
        with Session(device=device) as sess:
            # phase A: RAM-slab rot, caught and healed by the scrubber
            got, total = read_all(sess, src)
            assert got == want[:total], "scrub_heal: clean pass diverged"
            keys = residency_cache.scrub_keys()
            assert keys, "scrub_heal: nothing resident to corrupt"
            key = rng.choice(keys)
            assert flip_resident_host(key[0], key[1], key[2],
                                      pos=rng.randrange(key[2])), \
                "scrub_heal: the resident flip missed"
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline \
                    and _counter("nr_scrub_repair") <= repairs0:
                time.sleep(0.02)
            assert _counter("nr_scrub_repair") > repairs0, \
                "scrub_heal: the scrubber never repaired the flipped slab"
            assert _counter("nr_integrity_fail") > fails0, \
                "scrub_heal: the flip was never detected"
            got, total = read_all(sess, src)
            assert got == want[:total], \
                "scrub_heal: the stream diverged after the heal"
            # phase B: KV spill rot healed from the mirror at page-in and
            # debited to its member; the scrubber stops, so the debit
            # comes from the page-in's verify
            config.set("scrub_bytes_per_sec", 0)
            repairs_a = _counter("nr_scrub_repair")
            pool = KvBlockPool(sess, spill, block_bytes=bbk, ram_blocks=2,
                               hbm_blocks=0)
            try:
                for i in range(6):
                    pool.append("chaos", _kv_pat(i, bbk))
                for i in range(6):
                    assert pool.read("chaos", i) == _kv_pat(i, bbk), \
                        f"scrub_heal: KV block {i} diverged after the heal"
                assert _counter("nr_scrub_repair") > repairs_a, \
                    "scrub_heal: no spill block was mirror-healed"
                assert sess._member_health.state(0) is \
                    HealthState.QUARANTINED, \
                    f"scrub_heal: rotten member 0 ended " \
                    f"{sess._member_health.state(0)}, wanted QUARANTINED"
                assert_transitions_legal(sess, "scrub_heal")
            finally:
                pool.close()
    finally:
        src.close()
        spill.close()
        _tiers_off(config)
    return "scrub_heal"


def _kv_pat(i: int, n: int) -> bytes:
    return bytes([(i * 7 + 1) % 256]) * n


def scenario_cache_churn(rng: random.Random, dirpath: str,
                         device=None) -> str:
    """The RAM tier far below the stream while a mirrored member
    fail-stops mid-schedule and a write invalidates between passes: every
    pass byte-identical to the healthy stream, and the trace dump
    schema-valid with fill -> evict -> refill in causal order on at least
    one extent."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session, open_source
    from ..trace import recorder, validate_chrome_trace
    from .fake import FaultPlan

    config.set("io_retries", 2)
    config.set("task_deadline_s", 30.0)
    config.set("cache_arbitration", False)
    # 3 chunks of capacity under an 8-chunk stream: every pass churns the
    # ARC lists end to end
    config.set("cache_bytes", 3 * CHUNK)
    config.set("dma_max_size", CHUNK)
    config.set("trace_policy", "all")
    recorder.configure()
    recorder.clear()
    residency_cache.clear()
    victim = rng.choice([0, 2])
    plan = FaultPlan(failstop_member=victim,
                     failstop_after=rng.randrange(4, 12))
    paths = make_mirrored_members(dirpath, tag=f"cc{rng.randrange(1 << 16)}-")
    src = _paired_fake(paths, plan)
    fills0, evicts0 = _counter("nr_cache_fill"), _counter("nr_cache_evict")
    inval0 = _counter("nr_cache_invalidate")
    want = expected_mirrored_stream(paths)
    try:
        with Session(device=device) as sess:
            for rnd in range(3):
                got, total = read_all(sess, src)
                assert got == want[:total], \
                    f"cache_churn: pass {rnd} diverged from the healthy " \
                    f"stream"
                if rnd == 1:
                    # the same bytes written through another framing of a
                    # shared member file: the stream is unchanged, but
                    # the tier must drop the extents over that file
                    wpath = paths[victim + 1]      # the surviving mirror
                    with open(wpath, "rb") as f:
                        head = f.read(CHUNK)
                    handle, buf = sess.alloc_dma_buffer(CHUNK)
                    try:
                        buf.view()[:CHUNK] = head
                        with open_source(wpath, writable=True) as sink:
                            res = sess.memcpy_ram2ssd(sink, handle, [0],
                                                      CHUNK)
                            sess.memcpy_wait(res.dma_task_id)
                            sink.sync()
                    finally:
                        sess.unmap_buffer(handle)
    finally:
        src.close()
        doc = recorder.chrome_trace("chaos cache_churn")
        dump_path = recorder.dump(os.path.join(dirpath, "cache_churn.json"),
                                  reason="chaos cache_churn")
        config.set("trace_policy", "off")
        recorder.configure()
        recorder.clear()
        _tiers_off(config)
    assert _counter("nr_cache_fill") > fills0, "cache_churn: no fills"
    assert _counter("nr_cache_evict") > evicts0, "cache_churn: no evictions"
    assert _counter("nr_cache_invalidate") > inval0, \
        "cache_churn: the write dropped nothing"
    errs = validate_chrome_trace(doc)
    assert not errs, \
        f"cache_churn: the trace dump fails its schema check: {errs[:5]}"
    by_off: dict = {}
    for ev in doc["traceEvents"]:
        nm = ev.get("name")
        if nm in ("cache_fill", "cache_evict"):
            off = ev.get("args", {}).get("offset")
            if off is not None:
                by_off.setdefault(off, []).append((ev["ts"], nm))
    cycled = 0
    for evs in by_off.values():
        names = [nm for _, nm in sorted(evs)]
        if any(names[i:i + 3] == ["cache_fill", "cache_evict", "cache_fill"]
               for i in range(len(names) - 2)):
            cycled += 1
    assert cycled > 0, \
        f"cache_churn: no extent shows fill->evict->refill (dump: " \
        f"{dump_path})"
    return "cache_churn"


# ---------------------------------------------------------------------------
# write scenarios
# ---------------------------------------------------------------------------

#: write calls a write fail-stop window spans: every member's legs come
#: round within it, so the victim surely misses writes (a window of 4-8
#: calls, the JAX package's, misses it in about one run in six)
_WRITE_WINDOW = 40


def _write_rejoin_config(config) -> None:
    config.set("io_retries", 1)
    config.set("task_deadline_s", 30.0)
    config.set("canary_interval_s", 0.05)
    config.set("quarantine_s", 0.1)
    config.set("rejoin_successes", 2)
    config.set("rejoin_tokens_s", 1000.0)
    config.set("dma_max_size", STRIPE)     # one request a stripe extent
    config.set("member_queue_depth", 1)    # the fail-stop bites mid-stream


def scenario_write_failstop(rng: random.Random, dirpath: str,
                            device=None) -> str:
    """A mirrored primary fail-stops for writes mid-stream (its reads keep
    answering): the stream retires with the victim's extents on the
    mirror and journaled, the replay copies them back once the member
    writes again, HEALTHY comes only after the journal drains, and then
    both files of each pair are identical and the stream reads back as
    the payload."""
    from ..config import config
    from ..engine import Session
    from .fake import FaultPlan

    _write_rejoin_config(config)
    victim = rng.choice([0, 2])
    after = rng.randrange(2, 5)
    plan = FaultPlan(write_failstop_member=victim,
                     write_failstop_after=after,
                     write_rejoin_after=after + _WRITE_WINDOW)
    paths = make_mirrored_members(dirpath,
                                  tag=f"wf{rng.randrange(1 << 16)}-")
    sink = _paired_fake(paths, plan, writable=True)
    payload = rng.randbytes(2 * MEMBER_SIZE)
    resyncs_before = _counter("nr_resync_extent")
    try:
        with Session() as sess:
            write_all(sess, sink, payload)
            await_healthy(sess, victim, "write_failstop")
            assert sess._resync.pending_bytes(victim) == 0, \
                "write_failstop: HEALTHY with resync debt outstanding"
            got, total = read_all(sess, sink)
            assert got == payload[:total], \
                "write_failstop: logical read-back diverged from payload"
            assert_transitions_legal(sess, "write_failstop")
    finally:
        sink.close()
    assert _counter("nr_resync_extent") > resyncs_before, \
        "write_failstop: nothing was ever replayed from the journal"
    assert_pairs_identical(paths, "write_failstop")
    return "write_failstop"


def scenario_write_enospc(rng: random.Random, dirpath: str,
                          device=None) -> str:
    """An ENOSPC storm on an unmirrored sink: the first error latches
    (PERSISTENT), with no retry against a full disk."""
    import errno as _errno

    from ..api import StromError
    from ..config import config
    from ..engine import Session
    from .fake import FakeNvmeSource, FaultPlan, make_test_file

    config.set("io_retries", 3)
    config.set("task_deadline_s", 30.0)
    config.set("dma_max_size", STRIPE)
    path = os.path.join(dirpath, f"en{rng.randrange(1 << 16)}.bin")
    make_test_file(path, MEMBER_SIZE)
    plan = FaultPlan(write_fail_every_nth=rng.choice([2, 3]),
                     write_errno=_errno.ENOSPC)
    sink = FakeNvmeSource(path, fault_plan=plan, force_cached_fraction=0.0,
                          writable=True)
    retries_before = _counter("nr_write_retry")
    try:
        with Session() as sess:
            handle, buf = sess.alloc_dma_buffer(MEMBER_SIZE)
            try:
                buf.view()[:MEMBER_SIZE] = rng.randbytes(MEMBER_SIZE)
                res = sess.memcpy_ram2ssd(sink, handle,
                                          list(range(MEMBER_SIZE // CHUNK)),
                                          CHUNK)
                try:
                    sess.memcpy_wait(res.dma_task_id, timeout=30.0)
                    raise AssertionError(
                        "write_enospc: a full disk did not fail the task")
                except StromError as e:
                    assert e.errno == _errno.ENOSPC, \
                        f"write_enospc: latched {e.errno}, wanted ENOSPC"
            finally:
                sess.unmap_buffer(handle)
    finally:
        sink.close()
    assert _counter("nr_write_retry") == retries_before, \
        "write_enospc: a PERSISTENT errno was retried"
    return "write_enospc"


def scenario_write_torn_mirror(rng: random.Random, dirpath: str,
                               device=None) -> str:
    """A replica dies for writes after the primary legs landed, tearing
    the pair: the journal owns what the replica missed and the replay
    heals it from the primary, ``write_verify`` on throughout."""
    from ..config import config
    from ..engine import Session
    from .fake import FaultPlan

    _write_rejoin_config(config)
    config.set("write_verify", True)
    victim = rng.choice([1, 3])
    after = rng.randrange(2, 5)
    plan = FaultPlan(write_failstop_member=victim,
                     write_failstop_after=after,
                     write_rejoin_after=after + _WRITE_WINDOW)
    paths = make_mirrored_members(dirpath,
                                  tag=f"tn{rng.randrange(1 << 16)}-")
    sink = _paired_fake(paths, plan, writable=True)
    payload = rng.randbytes(2 * MEMBER_SIZE)
    try:
        with Session() as sess:
            write_all(sess, sink, payload)
            await_healthy(sess, victim, "write_torn_mirror")
            got, total = read_all(sess, sink)
            assert got == payload[:total], \
                "write_torn_mirror: logical read-back diverged"
            assert_transitions_legal(sess, "write_torn_mirror")
    finally:
        sink.close()
    assert_pairs_identical(paths, "write_torn_mirror")
    return "write_torn_mirror"


_CKPT_CRASH_CHILD = r"""
import sys, time
import numpy as np
import nvme_strom_tpu_torch.data.checkpoint as ck
_orig = ck._leaf_bytes
def _slow(*a, **kw):
    time.sleep(0.08)           # widen the window the temp file exists in
    return _orig(*a, **kw)
ck._leaf_bytes = _slow
tree = {f"leaf{i:02d}": np.full(1024, i, np.float32) for i in range(48)}
ck.save_checkpoint(sys.argv[1], tree)
print("child save finished (should have been killed)")
"""


def scenario_ckpt_crash(rng: random.Random, dirpath: str,
                        device=None) -> str:
    """A child SIGKILLed mid-save over an existing checkpoint: the prior
    one restores byte-identical (crc-verified), the child's temp litter
    survives a save while young and is reaped once it ages out, and
    ``strom_ckpt verify`` passes on the final file."""
    import glob
    import signal
    import subprocess

    import numpy as np

    from ..data.checkpoint import (_TMP_SWEEP_AGE_S, restore_checkpoint,
                                   save_checkpoint)
    from ..tools.strom_ckpt import main as ckpt_cli

    dev = str(device) if device is not None else "cuda:0"
    path = os.path.join(dirpath, "model.strom")
    prior = {f"leaf{i:02d}": np.full(1024, 1000 + i, np.float32)
             for i in range(48)}
    save_checkpoint(path, prior)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen([sys.executable, "-c", _CKPT_CRASH_CHILD, path],
                             env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120.0
        tmps = []
        while time.monotonic() < deadline:
            tmps = glob.glob(path + ".tmp.*")
            if tmps:
                break
            if child.poll() is not None:
                raise AssertionError(f"ckpt_crash: child exited rc="
                                     f"{child.returncode} before its temp "
                                     f"file appeared")
            time.sleep(0.02)
        assert tmps, "ckpt_crash: no temp file ever appeared"
        time.sleep(0.3)        # some leaves deep
        child.send_signal(signal.SIGKILL)
        rc = child.wait(timeout=30.0)
        assert rc == -signal.SIGKILL, f"ckpt_crash: child rc {rc}"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30.0)
    out = restore_checkpoint(path, verify=True, device=dev)
    for k, v in prior.items():
        got = out[f"['{k}']"].cpu().numpy()
        assert np.array_equal(got, v), f"ckpt_crash: leaf {k} diverged"
    litter = glob.glob(path + ".tmp.*")
    assert litter, "ckpt_crash: the SIGKILL left no temp litter to test"
    final = {f"leaf{i:02d}": np.full(1024, 2000 + i, np.float32)
             for i in range(48)}
    save_checkpoint(path, final)
    assert set(glob.glob(path + ".tmp.*")) >= set(litter), \
        "ckpt_crash: young litter was swept (a concurrent save's hazard)"
    old = time.time() - _TMP_SWEEP_AGE_S - 60.0
    for t in litter:
        os.utime(t, (old, old))
    save_checkpoint(path, final)
    assert not glob.glob(path + ".tmp.*"), \
        "ckpt_crash: aged litter survived the sweep"
    assert ckpt_cli(["verify", path, "-d", dev]) == 0, \
        "ckpt_crash: strom_ckpt verify failed on the final checkpoint"
    return "ckpt_crash"


SCENARIOS = (scenario_fail_stop, scenario_flaky, scenario_slow_hedge,
             scenario_corrupt_once, scenario_rejoin,
             scenario_native_degraded, scenario_cache_churn,
             scenario_scrub_heal)

SCENARIOS_WRITE = (scenario_write_failstop, scenario_write_enospc,
                   scenario_write_torn_mirror, scenario_ckpt_crash)


def flaky_mirrored_round(rng: random.Random, dirpath: str) -> str:
    """The stress harness's entry: one mirrored flaky round."""
    return scenario_flaky(rng, dirpath)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def run_all(seed: int, rounds: int = 1, verbose: bool = True,
            scenarios=SCENARIOS, device=None) -> dict:
    """Run *scenarios* *rounds* times, each with its own derived seed and
    temporary directory and the config restored after it; returns the
    tally of tags."""
    from ..config import config
    tally: dict = {}
    for r in range(rounds):
        for i, scenario in enumerate(scenarios):
            # an integer-derived seed: hash() of a str changes per process
            rng = random.Random(seed * 1_000_003 + r * 101 + i)
            snap = config.snapshot()
            with tempfile.TemporaryDirectory() as d:
                t0 = time.monotonic()
                try:
                    tag = scenario(rng, d, device=device)
                finally:
                    config.restore(snap)
                if verbose:
                    print(f"  chaos[{r}] {scenario.__name__}: {tag} "
                          f"({time.monotonic() - t0:.1f}s)", flush=True)
            tally[tag] = tally.get(tag, 0) + 1
    return tally


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = None
    if "-d" in argv:
        i = argv.index("-d")
        if i + 1 >= len(argv):
            print("chaos: -d needs a device", file=sys.stderr)
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    sets = {"read": SCENARIOS, "write": SCENARIOS_WRITE,
            "all": SCENARIOS + SCENARIOS_WRITE}
    which = argv[0] if argv else "read"
    if which not in sets:
        print(f"usage: chaos [{'|'.join(sets)}] [-d DEVICE]",
              file=sys.stderr)
        return 2
    seed = int(os.environ.get("STROM_CHAOS_SEED", "1234"))
    rounds = int(os.environ.get("STROM_CHAOS_ROUNDS", "1"))
    t0 = time.monotonic()
    tally = run_all(seed, rounds, scenarios=sets[which], device=device)
    from ..stats import stats
    c = stats.snapshot()
    print(f"chaos OK: {sum(tally.values())} scenarios in "
          f"{time.monotonic() - t0:.1f}s (seed={seed}) — "
          + ", ".join(f"{k}={v}" for k, v in sorted(tally.items()))
          + f"; hedges won {c.get('nr_hedge_won', 0)}/"
          f"{c.get('nr_hedge_issued', 0)}, "
          f"mirror reads {c.get('nr_mirror_read', 0)}, "
          f"mirror writes {c.get('nr_mirror_write', 0)}, "
          f"resync extents {c.get('nr_resync_extent', 0)}, "
          f"canaries {c.get('nr_canary_probe', 0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
