"""The RAM tier of the PyTorch port (``cache.py``, the engine's hit/miss
split) against the JAX package on the same bytes: the counterparts of
``tests/test_cache.py`` (hit/miss split, the partial-hit order, ARC scan
resistance, leases against eviction and invalidation, a write's
invalidation, fills through a fail-stopped member's mirror, the tier off),
the ARC held step by step against the reference's on seeded access
sequences, and the port's cache gate.

What is compared: landed bytes (exact), the result's chunk order, and the
moves of the hit, miss, fill, evict and invalidate counters.  No
assertion reads a wall-clock time."""

import os
import shutil
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import nvme_strom_tpu.cache as jcache
import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.testing.chaos as jchaos
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.stats import stats as jstats
import nvme_strom_tpu_torch.cache as tcache
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.testing.chaos as tchaos
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing import cache_gate, reset_residency

CHUNK = 64 << 10

PKGS = {
    "jax": types.SimpleNamespace(
        eng=jeng, fake=jfake, cfg=jcfg, cache=jcache, chaos=jchaos,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters)),
    "torch": types.SimpleNamespace(
        eng=teng, fake=tfake, cfg=tcfg, cache=tcache, chaos=tchaos,
        counters=tstats.snapshot),
}

_MOVED = ("nr_cache_hit", "nr_cache_miss", "nr_cache_fill",
          "nr_cache_evict", "nr_cache_invalidate", "bytes_cache_hit",
          "total_dma_length")


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    reset_residency()
    yield
    tcfg.restore(snap)
    reset_residency()


def _enable(p, nbytes=16 << 20):
    p.cfg.set("cache_bytes", nbytes)
    p.cfg.set("cache_arbitration", False)     # the direct path
    p.cfg.set("dma_max_size", CHUNK)
    p.cache.residency_cache.configure()


def _moves(before, after, names=_MOVED):
    return {k: after.get(k, 0) - before.get(k, 0) for k in names}


def _both(fn, *args):
    """``fn(p, *args)`` through each package; asserts they agree and
    returns the port's result."""
    out = {name: fn(p, *args) for name, p in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# ---------------------------------------------------------------------------
# the engine's hit/miss split
# ---------------------------------------------------------------------------

def _hit_miss(p, path):
    _enable(p)
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            handle, buf = sess.alloc_dma_buffer(8 * CHUNK)
            res1 = sess.memcpy_ssd2ram(src, handle, list(range(8)), CHUNK)
            sess.memcpy_wait(res1.dma_task_id)
            got1 = bytes(buf.view()[:8 * CHUNK])
            mid = p.counters()
            res2 = sess.memcpy_ssd2ram(src, handle, list(range(8)), CHUNK)
            sess.memcpy_wait(res2.dma_task_id)
            got2 = bytes(buf.view()[:8 * CHUNK])
    finally:
        src.close()
    after = p.counters()
    return (got1, got2, (res1.nr_ssd2dev, res1.nr_ram2dev),
            (res2.nr_ssd2dev, res2.nr_ram2dev, list(res2.chunk_ids)),
            _moves(before, mid), _moves(mid, after))


def test_hit_miss_split_and_identity(tmp_data_file):
    got1, got2, r1, r2, cold, hot = _both(_hit_miss, tmp_data_file)
    want = tfake.expected_bytes(0, 8 * CHUNK)
    assert got1 == want and got2 == want
    assert r1 == (8, 0)
    assert cold["nr_cache_miss"] == 8 and cold["nr_cache_fill"] == 8
    # the hot pass submits nothing: every chunk a RAM-tier tail slot
    assert r2 == (0, 8, list(range(8)))
    assert hot["nr_cache_hit"] == 8 and hot["nr_cache_miss"] == 0
    assert hot["total_dma_length"] == 0
    assert hot["bytes_cache_hit"] == 8 * CHUNK


def _partial(p, path):
    _enable(p)
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
    try:
        with p.eng.Session() as sess:
            handle, buf = sess.alloc_dma_buffer(8 * CHUNK)
            res = sess.memcpy_ssd2ram(src, handle, [0, 2, 4, 6], CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            want = list(range(8))
            res = sess.memcpy_ssd2ram(src, handle, want, CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            host = p.eng.reorder_chunks(
                np.frombuffer(buf.view()[:8 * CHUNK], np.uint8),
                CHUNK, res.chunk_ids, want)
            return res.nr_ssd2dev, list(res.chunk_ids), bytes(host)
    finally:
        src.close()


def test_partial_hit_reorder(tmp_data_file):
    nr_ssd, order, host = _both(_partial, tmp_data_file)
    assert nr_ssd == 4                       # the odd chunks submitted
    assert order == [1, 3, 5, 7, 0, 2, 4, 6]  # the hits tail-packed
    assert host == tfake.expected_bytes(0, 8 * CHUNK)


# ---------------------------------------------------------------------------
# the ARC policy
# ---------------------------------------------------------------------------

def _mk_cache(p, nbytes):
    p.cfg.set("cache_bytes", nbytes)
    c = p.cache.ResidencyCache()
    c.configure()
    return c


def _scan_resistance(p):
    L = 4096
    c = _mk_cache(p, 8 * L)
    skey = ("/hot",)
    for i in range(4):
        assert c.fill(skey, i * L, L, bytes([i]) * L)
    for i in range(4):                 # the second touch promotes to t2
        c.lookup(skey, i * L, L).release()
    for i in range(100):               # a one-touch stream of 50x capacity
        c.fill(("/scan",), i * L, L, b"s" * L)
    hot = []
    for i in range(4):
        lease = c.lookup(skey, i * L, L)
        if lease is not None:
            out = bytearray(L)
            hot.append(lease.copy_into(out) and out == bytes([i]) * L)
            lease.release()
    return hot


def test_arc_scan_resistance():
    assert _both(_scan_resistance) == [True] * 4


def _pins(p):
    L = 4096
    c = _mk_cache(p, 3 * L)
    skey = ("/pin",)
    steps = [c.fill(skey, i * L, L, bytes([i]) * L) for i in range(3)]
    leases = [c.lookup(skey, i * L, L) for i in range(3)]
    # every resident byte leased: the fill is refused, never evicts
    # under a reader
    steps.append(c.fill(skey, 99 * L, L, b"x" * L))
    for i, lease in enumerate(leases):
        out = bytearray(L)
        steps.append(lease.copy_into(out) and out == bytes([i]) * L)
        lease.release()
    steps.append(c.fill(skey, 99 * L, L, b"x" * L))    # evictable now
    return steps


def test_lease_pins_against_eviction():
    assert _both(_pins) == [True, True, True, False, True, True, True, True]


def _stale(p):
    L = 4096
    c = _mk_cache(p, 4 * L)
    skey = ("/stale",)
    steps = [c.fill(skey, 0, L, b"a" * L)]
    lease = c.lookup(skey, 0, L)
    steps.append(c.invalidate_extents(skey, [(0, L)]))
    steps.append(lease.copy_into(bytearray(L)))
    lease.release()
    steps.append(c.lookup(skey, 0, L) is None)
    steps.append(c.fill(skey, 0, L, b"b" * L))
    lease = c.lookup(skey, 0, L)
    out = bytearray(L)
    steps.append(lease.copy_into(out) and out == b"b" * L)
    lease.release()
    return steps


def test_invalidate_marks_pinned_stale():
    assert _both(_stale) == [True, 1, False, True, True, True]


def _arc_state(c):
    return (list(c._t1), list(c._t2), list(c._b1), list(c._b2), c._p,
            c._bytes, c._b1_bytes, c._b2_bytes)


_OPS = st.lists(st.tuples(st.sampled_from(["fill", "lookup", "inval",
                                           "spec"]),
                          st.integers(0, 11), st.sampled_from([1, 2, 3])),
                min_size=1, max_size=60)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ops=_OPS, cap=st.integers(3, 10))
def test_arc_steps_match_reference(ops, cap):
    """The same access sequence through both ARCs: the same hits, the
    same victims and ghosts, the same t1/t2 bytes and target after every
    step (byte-weighted: extents of 1 to 3 units of 512 bytes)."""
    U = 512
    caches = {name: _mk_cache(p, cap * U) for name, p in PKGS.items()}
    for op, k, units in ops:
        length = units * U
        res = {}
        for name, c in caches.items():
            skey = ("/arc",)
            if op == "fill":
                res[name] = c.fill(skey, k * 4 * U, length, b"\1" * length)
            elif op == "spec":
                res[name] = c.fill(skey, k * 4 * U, length, b"\2" * length,
                                   speculative=True)
            elif op == "lookup":
                lease = c.lookup(skey, k * 4 * U, length)
                res[name] = lease is not None
                if lease is not None:
                    lease.release()
            else:
                res[name] = c.invalidate_extents(skey, [(k * 4 * U, U)])
        assert res["torch"] == res["jax"], (op, k, units)
        assert _arc_state(caches["torch"]) == _arc_state(caches["jax"]), \
            (op, k, units)
    for c in caches.values():
        c.clear()


# ---------------------------------------------------------------------------
# a write's coherency through the engine
# ---------------------------------------------------------------------------

def _write_back(p, path):
    _enable(p)
    before = p.counters()
    with p.eng.Session() as sess:
        handle, buf = sess.alloc_dma_buffer(4 * CHUNK)
        with p.eng.open_source(path) as src:
            res = sess.memcpy_ssd2ram(src, handle, list(range(4)), CHUNK)
            sess.memcpy_wait(res.dma_task_id)
        new0 = bytes(range(256)) * (CHUNK // 256)
        buf.view()[:CHUNK] = new0
        with p.eng.open_source(path, writable=True) as sink:
            res = sess.memcpy_ram2ssd(sink, handle, [0], CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            sink.sync()
        with p.eng.open_source(path) as src:
            res = sess.memcpy_ssd2ram(src, handle, list(range(4)), CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            got = bytes(buf.view()[:4 * CHUNK])
    return got, _moves(before, p.counters(),
                       ("nr_cache_invalidate", "nr_cache_hit"))


def test_invalidation_on_write_back(tmp_data_file, tmp_path):
    out = {}
    for name, p in PKGS.items():
        path = str(tmp_path / f"{name}.bin")
        shutil.copyfile(tmp_data_file, path)
        out[name] = _write_back(p, path)
    assert out["torch"] == out["jax"]
    got, moved = out["torch"]
    assert got[:CHUNK] == bytes(range(256)) * (CHUNK // 256)
    assert got[CHUNK:] == tfake.expected_bytes(CHUNK, 3 * CHUNK)
    assert moved["nr_cache_invalidate"] > 0
    assert moved["nr_cache_hit"] == 3        # the chunks the write missed


# ---------------------------------------------------------------------------
# fills through a fail-stopped member's mirror
# ---------------------------------------------------------------------------

def _degraded(p, dirpath):
    os.makedirs(dirpath)
    stripe = 64 << 10
    paths = p.chaos.make_mirrored_members(dirpath, n_pairs=2,
                                          size=512 << 10, tag="cm")
    _enable(p)
    want = p.chaos.expected_mirrored_stream(paths, stripe)
    src = p.fake.FakeStripedNvmeSource(
        paths, stripe_chunk_size=stripe,
        fault_plan=p.fake.FaultPlan(failstop_member=0, failstop_after=0),
        force_cached_fraction=0.0, mirror="paired")
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            got1, total = p.chaos.read_all(sess, src, chunk=stripe)
            mid = p.counters()
            got2, _ = p.chaos.read_all(sess, src, chunk=stripe)
    finally:
        src.close()
    return (got1 == want[:total], got2 == want[:total], total // stripe,
            _moves(before, mid), _moves(mid, p.counters()))


def test_degraded_fill_through_mirror(tmp_path):
    ok1, ok2, n, cold, hot = _both(
        lambda p: _degraded(p, str(tmp_path / p.eng.__name__)))
    assert ok1 and ok2
    assert cold["nr_cache_fill"] > 0
    assert hot["nr_cache_hit"] == n and hot["nr_cache_miss"] == 0


# ---------------------------------------------------------------------------
# the tier off
# ---------------------------------------------------------------------------

def _off(p, path):
    assert int(p.cfg.get("cache_bytes")) == 0
    p.cfg.set("cache_arbitration", False)
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            handle, buf = sess.alloc_dma_buffer(8 * CHUNK)
            res = sess.memcpy_ssd2ram(src, handle, list(range(8)), CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            got = bytes(buf.view()[:8 * CHUNK])
    finally:
        src.close()
    moved = _moves(before, p.counters(), _MOVED[:5])
    return got, res.nr_ssd2dev, moved, \
        p.cache.residency_cache.resident_bytes()


def test_cache_disabled_is_noop(tmp_data_file):
    got, nr_ssd, moved, resident = _both(_off, tmp_data_file)
    assert got == tfake.expected_bytes(0, 8 * CHUNK)
    assert nr_ssd == 8
    assert not any(moved.values()) and resident == 0


# ---------------------------------------------------------------------------
# the port's gate (its timed leg is left to the card)
# ---------------------------------------------------------------------------

def test_cache_gate_legs_on_the_cpu(tmp_path):
    import torch
    dev = torch.device("cpu")
    assert cache_gate._leg_eviction_identity(str(tmp_path), dev) > 0
    assert cache_gate._leg_writeback_invalidation(str(tmp_path), dev) > 0


def test_cache_gate_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the gate would run on it")
    assert cache_gate.main([]) == 2
