"""The native io_uring engine of the PyTorch port against the JAX package's.

The port builds its own copy of the engine (``csrc/strom_engine.cc``) with
``g++``; each test hands the same seeded bytes and the same request
batches to both packages:
- the two ``NativeEngine``s, once per backend (io_uring, threadpool), with
  fixed and plain buffers: landed bytes, API version, struct layouts, the
  stats and histogram keys;
- request shaping: ``_coalesce_requests``, ``plan_requests`` with its
  coalescing arguments and ``AdaptiveChunkSizer`` on generated inputs;
- reads through the two ``Session``s over a 4-member ``StripedSource`` and
  a ``SegmentedSource``: bytes and ``chunk_ids`` order;
- the engine ladder and the native submit's failover, counted in
  ``nr_backend_fallback``, and the parts of the reference's engine this
  copy leaves out.

An io_uring case skips where ``io_uring_setup`` is refused, as
``tests/test_native.py`` does."""

import ctypes
import errno
import mmap
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import nvme_strom_tpu._native as jnat
import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.stripe as jstripe
import nvme_strom_tpu_torch._native as tnat
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.stripe as tstripe
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import ConfigError, config as tcfg
from nvme_strom_tpu_torch.stats import stats

CHUNK = 64 << 10
FILE_BYTES = 2 << 20


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    # the direct path, as the JAX package's tests pin it: arbitration
    # would send this freshly written, page-cache-warm file write-back
    tcfg.set("cache_arbitration", False)
    yield
    tcfg.restore(snap)


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "data.bin")
    data = np.random.default_rng(21).integers(0, 256, FILE_BYTES,
                                              dtype=np.uint8)
    data.tofile(path)
    return path, data.tobytes()


def _needs(backend):
    if backend == "io_uring" and tnat.uring_probe():
        pytest.skip(f"io_uring_setup refused "
                    f"({os.strerror(tnat.uring_probe())})")


def test_api_version_signature_and_struct_layouts():
    assert tnat.native_available() and jnat.native_available()
    assert tnat.native_api_version() == jnat.native_api_version() == 4
    assert tnat.API_VERSION == jnat.API_VERSION
    assert tnat.native_signature().startswith("strom_tpu native engine api v4")
    for name in ("_Req", "_TraceEvent"):
        mine, ref = getattr(tnat, name), getattr(jnat, name)
        assert ctypes.sizeof(mine) == ctypes.sizeof(ref), name
        assert [(f, getattr(mine, f).offset) for f, _ in mine._fields_] == \
            [(f, getattr(ref, f).offset) for f, _ in ref._fields_], name


@pytest.mark.parametrize("backend", ["io_uring", "threadpool"])
def test_stats_and_histogram_keys_match_reference(backend):
    _needs(backend)
    mine = tnat.NativeEngine(backend, 8)
    ref = jnat.NativeEngine(backend, 8)
    try:
        assert mine.backend_name == ref.backend_name == backend
        assert mine.stats().keys() == ref.stats().keys()
        assert tnat.NATIVE_COUNTERS == jnat.NATIVE_COUNTERS
        assert len(mine.lat_hist()) == len(ref.lat_hist()) \
            == tnat.LAT_HIST_BUCKETS
        assert len(mine.member_lat_hist(0)) == len(ref.member_lat_hist(0))
        assert mine.member_occ(0) == ref.member_occ(0) == (0, 0)
        assert mine.nlanes() == ref.nlanes()
        assert mine.pending() == ref.pending() == []
    finally:
        mine.close()
        ref.close()


def _batch(seed, n):
    """Seeded request batch: (file_off, len, dest_off), 4 KiB aligned,
    disjoint destinations."""
    rng = np.random.default_rng(seed)
    out, dest = [], 0
    for _ in range(n):
        ln = int(rng.integers(1, 33)) * 4096
        off = int(rng.integers(0, (FILE_BYTES - ln) // 4096)) * 4096
        out.append((off, ln, dest))
        dest += ln
    return out, dest


@pytest.mark.parametrize("fixed", [False, True], ids=["plain", "fixed"])
@pytest.mark.parametrize("backend", ["io_uring", "threadpool"])
def test_engines_land_the_same_bytes(data_file, backend, fixed):
    _needs(backend)
    path, data = data_file
    landed = {}
    for tag, nat in (("mine", tnat), ("ref", jnat)):
        eng = nat.NativeEngine(backend, 16, rings=2)
        fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
        reqs, nbytes = _batch(7, 24)
        buf = mmap.mmap(-1, nbytes)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        try:
            slot = eng.buf_register(addr, nbytes) if fixed else None
            if fixed and backend == "threadpool":
                assert slot is None        # no fixed buffers without rings
            elif fixed and slot is None:
                pytest.skip("fixed buffers refused (RLIMIT_MEMLOCK)")
            tid = eng.submit(addr, [(fd, o, ln, d) for o, ln, d in reqs],
                             members=[i % 2 for i in range(len(reqs))])
            eng.wait(tid, 10000)
            landed[tag] = (bytes(buf[:nbytes]),
                           eng.stats()["nr_fixed_dma"],
                           eng.stats()["total_dma_length"])
            if slot is not None:
                eng.buf_unregister(slot)
        finally:
            eng.close()
            os.close(fd)
    assert landed["mine"] == landed["ref"]
    want = b"".join(data[o:o + ln] for o, ln, _ in reqs)
    assert landed["mine"][0] == want
    assert landed["mine"][1] == (len(reqs) if fixed
                                 and backend == "io_uring" else 0)


def test_native_write_and_trace_ring_match_reference(tmp_path):
    """One write batch through each engine with the event ring on: equal
    files, equal event fields (bar the clocks)."""
    data = np.random.default_rng(2).integers(0, 256, 256 << 10,
                                             dtype=np.uint8).tobytes()
    events = {}
    for tag, nat in (("mine", tnat), ("ref", jnat)):
        path = str(tmp_path / f"{tag}.bin")
        with open(path, "wb") as f:
            f.truncate(len(data))
        eng = nat.NativeEngine("threadpool", 8)
        eng.trace_enable(True)
        buf = mmap.mmap(-1, len(data))
        buf[:] = data
        fd = os.open(path, os.O_RDWR | os.O_DIRECT)
        try:
            addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
            tid = eng.submit(addr, [(fd, i * (64 << 10), 64 << 10,
                                     i * (64 << 10)) for i in range(4)],
                             write=True)
            eng.wait(tid, 10000)
            evs = eng.trace_drain()
            events[tag] = sorted((e["file_off"], e["len"], e["member"],
                                  e["result"]) for e in evs)
            assert all(e["complete_ns"] >= e["submit_ns"] for e in evs)
        finally:
            os.close(fd)
            eng.close()
        assert open(path, "rb").read() == data
    assert events["mine"] == events["ref"] and len(events["mine"]) == 4


# -- request shaping ---------------------------------------------------------

_REQ = st.tuples(st.integers(0, 3), st.integers(0, 64),
                 st.integers(1, 16), st.integers(0, 64), st.booleans())


def _reqs(mod, raw):
    return [mod.Request(m, fo * 4096, ln * 4096, do * 4096, buffered=b)
            for m, fo, ln, do, b in raw]


def _shape(reqs):
    return [(r.member, r.file_off, r.length, r.dest_off, r.buffered,
             r.dest_segs) for r in reqs]


@settings(max_examples=150, deadline=None)
@given(raw=st.lists(_REQ, max_size=24),
       limit=st.one_of(st.integers(1, 64).map(lambda k: k * 4096),
                       st.dictionaries(st.integers(0, 3),
                                       st.integers(1, 64).map(
                                           lambda k: k * 4096))),
       shift=st.one_of(st.none(), st.integers(12, 20)))
def test_coalesce_requests_matches_reference(raw, limit, shift):
    mine = teng._coalesce_requests(_reqs(teng, raw), limit, shift)
    ref = jeng._coalesce_requests(_reqs(jeng, raw), limit, shift)
    assert _shape(mine) == _shape(ref)


@settings(max_examples=150, deadline=None)
@given(floor=st.integers(1, 1 << 20), span=st.integers(0, 8),
       decay=st.integers(1, 6),
       obs=st.lists(st.integers(0, 300_000_000), max_size=60))
def test_adaptive_chunk_sizer_matches_reference(floor, span, decay, obs):
    mine = teng.AdaptiveChunkSizer(floor, floor << span, decay_after=decay)
    ref = jeng.AdaptiveChunkSizer(floor, floor << span, decay_after=decay)
    seen = []
    for ns in obs:
        mine.observe(ns)
        ref.observe(ns)
        seen.append((mine.effective, ref.effective))
    assert all(a == b for a, b in seen)


@pytest.fixture()
def striped(tmp_path):
    """A 4-member RAID-0 set of 64 KiB stripes plus the same bytes as one
    file, and as 192 KiB segments."""
    data = np.random.default_rng(9).integers(0, 256, 1536 << 10,
                                             dtype=np.uint8).tobytes()
    members = [bytearray() for _ in range(4)]
    for i in range(0, len(data), CHUNK):
        members[(i // CHUNK) % 4] += data[i:i + CHUNK]
    paths = []
    for k, m in enumerate(members):
        p = str(tmp_path / f"md0.m{k}")
        open(p, "wb").write(bytes(m))
        paths.append(p)
    segs = []
    for k in range(0, len(data), 192 << 10):
        p = str(tmp_path / f"rel.{k // (192 << 10)}")
        open(p, "wb").write(data[k:k + (192 << 10)])
        segs.append(p)
    return paths, segs, data


@pytest.mark.parametrize("climit", [None, 512 << 10, "per-member"])
def test_plan_requests_coalescing_matches_reference(striped, climit):
    paths, _, _ = striped
    entries = [(c, i) for i, c in enumerate([0, 1, 2, 3, 4, 5, 9, 8, 12])]
    limit = {0: 256 << 10, 2: 512 << 10} if climit == "per-member" \
        else climit
    with teng.open_source(paths, stripe_chunk_size=CHUNK) as ts, \
            jeng.open_source(paths, stripe_chunk_size=CHUNK) as js:
        mine = teng.plan_requests(ts, entries, CHUNK, 0,
                                  dma_max_size=CHUNK, coalesce_limit=limit)
        ref = jeng.plan_requests(js, entries, CHUNK, 0,
                                 dma_max_size=CHUNK, coalesce_limit=limit)
    assert _shape(mine) == _shape(ref)


# -- reads through the two Sessions -------------------------------------------

def _session_read(mod, src, ids, chunk, **kw):
    with mod.Session(**kw) as sess:
        handle, buf = sess.alloc_dma_buffer(len(ids) * chunk)
        try:
            res = sess.memcpy_ssd2ram(src, handle, ids, chunk)
            sess.memcpy_wait(res.dma_task_id)
            info = sess.stat_info()
            return (bytes(buf.view()[:len(ids) * chunk]), res.chunk_ids,
                    sess.backend_name, info)
        finally:
            sess.unmap_buffer(handle)
            buf.close()


@pytest.mark.parametrize("backend", ["auto", "threadpool", "python"])
@pytest.mark.parametrize("kind", ["striped", "segmented"])
def test_session_reads_match_reference(striped, kind, backend):
    paths, segs, data = striped
    ids = [5, 0, 7, 3, 3, 11, 1, 2, 4, 6, 8, 9, 10, 23, 12]
    chunk = CHUNK
    jcfg.set("cache_arbitration", False)
    jcfg.set("engine_backend", "uring")
    tcfg.set("submit_window", 4)
    kw = {"stripe_chunk_size": CHUNK} if kind == "striped" \
        else {"segment_size": 192 << 10}
    spec = paths if kind == "striped" else segs
    with teng.open_source(spec, **kw) as ts:
        mine = _session_read(teng, ts, ids, chunk, io_backend=backend)
    with jeng.open_source(spec, **kw) as js:
        ref = _session_read(jeng, js, ids, chunk)
    assert mine[0] == ref[0] == b"".join(data[c * chunk:(c + 1) * chunk]
                                         for c in ids)
    assert mine[1] == ref[1] == ids
    want = {"auto": "io_uring" if not tnat.uring_probe() else "threadpool",
            "threadpool": "threadpool", "python": "python"}[backend]
    assert mine[2] == want
    assert mine[3]["total_dma_length"] >= len(ids) * chunk


def test_striped_read_scales_out_one_lane_a_member(striped):
    paths, _, data = striped
    with teng.open_source(paths, stripe_chunk_size=CHUNK) as src, \
            teng.Session(io_backend="threadpool") as sess:
        assert sess._native.nlanes() == 1
        handle, buf = sess.alloc_dma_buffer(8 * CHUNK)
        got = teng.read_chunk_ids(sess, src, range(8), CHUNK, handle,
                                  buf.view())
        assert got.tobytes() == data[:8 * CHUNK]
        assert sess._native.nlanes() == 4
        assert [tstripe.lane_of(m, 4) for m in range(6)] == \
            [jstripe.lane_of(m, 4) for m in range(6)]
        assert tstripe.lane_members(1, 6, 4) == \
            jstripe.lane_members(1, 6, 4) == [1, 5]
        members = stats.member_snapshot()
        sess.stat_info()
        assert all(stats.member_snapshot().get(m, {}).get("nreq", 0)
                   > members.get(m, {}).get("nreq", 0) for m in range(4))
        sess.unmap_buffer(handle)
        buf.close()


def test_fixed_buffers_register_and_release_with_the_buffer():
    if tnat.uring_probe():
        pytest.skip("io_uring_setup refused")
    with teng.Session(io_backend="io_uring") as sess:
        handle, buf = sess.alloc_dma_buffer(256 << 10)
        if not sess.is_fixed(buf):
            pytest.skip("fixed buffers refused (RLIMIT_MEMLOCK)")
        assert sess.list_buffers() == [handle]
        sess.unmap_buffer(handle)
        buf.close()           # its close callback unregisters the slot
        assert not sess.is_fixed(buf) and sess.list_buffers() == []


# -- the ladder and the failover ---------------------------------------------

@pytest.mark.parametrize("refuse,fallback,want", [
    (("io_uring",), True, "threadpool"),
    (("io_uring", "threadpool"), True, "python"),
    (("io_uring",), False, None),
])
def test_engine_ladder_counts_each_step(monkeypatch, refuse, fallback, want):
    real = tnat.NativeEngine.__init__

    def init(self, backend="auto", queue_depth=32, rings=0):
        if backend in refuse:
            raise StromError(errno.EIO, f"{backend} refused (injected)")
        real(self, backend, queue_depth, rings)

    monkeypatch.setattr(tnat.NativeEngine, "__init__", init)
    tcfg.set("io_fallback", fallback)
    before = stats.snapshot().get("nr_backend_fallback", 0)
    if want is None:
        with pytest.raises(StromError):
            teng.Session()
        return
    with teng.Session() as sess:
        assert sess.backend_name == want
        assert stats.backend() == want
        assert sess.uring_errno != 0
    assert stats.snapshot().get("nr_backend_fallback", 0) - before \
        == len(refuse)


@pytest.mark.parametrize("fallback", [True, False])
def test_failed_native_submit_falls_back_or_raises(data_file, monkeypatch,
                                                   fallback):
    path, data = data_file

    def refuse(self, *a, **kw):
        raise StromError(errno.EIO, "injected submit failure")

    monkeypatch.setattr(tnat.NativeEngine, "submit", refuse)
    tcfg.set("io_fallback", fallback)
    before = stats.snapshot().get("nr_backend_fallback", 0)
    with teng.open_source(path) as src:
        if fallback:
            got = _session_read(teng, src, [0, 1, 2], CHUNK)[0]
            assert got == data[:3 * CHUNK]
        else:
            with pytest.raises(StromError) as e:
                _session_read(teng, src, [0, 1, 2], CHUNK)
            assert e.value.errno == errno.EIO
    assert stats.snapshot().get("nr_backend_fallback", 0) - before \
        == (1 if fallback else 0)


def test_failed_build_raises_and_passthru_is_refused(monkeypatch):
    from nvme_strom_tpu_torch import _build

    def broken():
        raise StromError(errno.EIO, "build failed (injected)")

    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(_build, "engine_library", broken)
    with pytest.raises(StromError) as e:
        teng.Session()
    assert e.value.errno == errno.EIO
    assert teng.Session(io_backend="python").backend_name == "python"
    # the passthrough rung is a config value now, and refused with the
    # engine it needs: a failed build raises on it as on every rung
    tcfg.set("engine_backend", "passthru")
    with pytest.raises(StromError) as e:
        teng.Session()
    assert e.value.errno == errno.EIO
    with pytest.raises(StromError):
        tnat.NativeEngine("nvme_passthru")
    with pytest.raises(StromError) as e:
        teng.Session(io_backend="nvme_passthru")
    assert e.value.errno == errno.EINVAL


@pytest.mark.parametrize("key", ["io_backend", "engine_backend",
                                 "io_fallback", "queue_depth",
                                 "engine_rings", "member_queue_depth",
                                 "submit_window", "coalesce_limit",
                                 "chunk_adaptive", "trace_policy",
                                 "trace_sample_rate", "trace_ring_events"])
def test_engine_knobs_default_like_reference(key):
    assert tcfg.get(key) == jcfg.get(key)


def test_coalesce_limit_cross_check_matches_reference():
    for cfg in (tcfg, jcfg):
        with pytest.raises(ValueError):
            cfg.set("coalesce_limit", 4096)
        cfg.set("coalesce_limit", 0)
    jcfg.set("coalesce_limit", 8 << 20)


#: parts of the reference's Session the port has since ported (the fault
#: ladder A1.6, mirrors A1.4, checksum verify and the scrubber A1.7,
#: autotune A1.9, NVMe passthrough A1.10, NUMA lane pinning A1.11)
_PORTED_SESSION_PARTS = {"_read_hedged", "_read_direct_resilient",
                         "_canary_loop", "_watchdog_loop", "_resync_replay",
                         "_write_mirrored", "_verify_writes",
                         "_verify_request_checksums", "_scrub_refill",
                         "_autotune_scale_lanes", "_passthru_split",
                         "_pin_lanes"}


@pytest.mark.parametrize("name", [
    "_read_hedged",                 # hedged reads (A1.6)
    "_read_direct_resilient",       # retries beyond the engine's (A1.6)
    "_canary_loop",                 # member health machine (A1.6)
    "_watchdog_loop",               # task watchdog (A1.6)
    "_verify_request_checksums",    # checksum verify (A1.7)
    "_scrub_refill",                # resident scrubber (A1.7, A1.8)
    "_resync_replay",               # mirror resync journal (A1.4)
    "_write_mirrored",              # mirror-coherent writes (A1.4)
    "_verify_writes",               # write_verify (A1.6)
    "_passthru_split",              # blockmap + NVMe passthrough (A1.10)
    "_pin_lanes",                   # NUMA lane pinning (A1.11)
    "_autotune_scale_lanes",        # autotune (A1.9)
])
def test_left_out_parts_of_the_reference_session(name):
    """The port's Session carries the parts its slices ported and none
    of the others; each of those waits for its ROADMAP item."""
    assert hasattr(jeng.Session, name)
    assert hasattr(teng.Session, name) is (name in _PORTED_SESSION_PARTS)


def test_pending_tasks_and_list_buffers_match_reference(data_file):
    path, _ = data_file
    out = {}
    for mod in (teng, jeng):
        with mod.open_source(path) as src, mod.Session() as sess:
            handle, buf = sess.alloc_dma_buffer(2 * CHUNK)
            res = sess.memcpy_ssd2ram(src, handle, [0, 1], CHUNK)
            during = sess.pending_tasks()
            sess.memcpy_wait(res.dma_task_id)
            out[mod] = (during, sess.pending_tasks(), sess.list_buffers())
            sess.unmap_buffer(handle)
            buf.close()
    assert out[teng] == out[jeng] == ([1], [], [1])


@pytest.mark.parametrize("chunk,n,want", [(8192, 4096, 2), (1 << 20, 32, 2),
                                          (1 << 20, 40, 3), (4 << 20, 8, 1)])
def test_submission_slices_cover_submit_window_mib(tmp_path, monkeypatch,
                                                   chunk, n, want):
    """A read is submitted in slices of ``submit_window`` chunks of at
    least 1 MiB: 8 KiB pages fill a slice up to 16 MiB (a divergence from
    the reference's 16 chunks, whatever their size: ROADMAP Queue C)."""
    path = str(tmp_path / "w.bin")
    data = np.random.default_rng(4).integers(0, 256, n * chunk,
                                             dtype=np.uint8)
    data.tofile(path)
    real = tnat.NativeEngine.submit
    batches = []

    def submit(self, addr, reqs, **kw):
        batches.append(sum(r[2] for r in reqs))
        return real(self, addr, reqs, **kw)

    monkeypatch.setattr(tnat.NativeEngine, "submit", submit)
    with teng.open_source(path) as src:
        got = _session_read(teng, src, list(range(n)), chunk)[0]
    assert got == data.tobytes()
    assert len(batches) == want and sum(batches) == n * chunk
    assert teng._window_chunks(chunk) * chunk >= 16 << 20
