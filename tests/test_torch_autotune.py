"""The self-driving data path of the PyTorch port (``autotune.py``,
``daemon/qos.py``, the engine's knob sites) against the JAX package: the
counterparts of the 17 tests of ``tests/test_autotune.py`` (the hill-climb
to the bound, the p99 step-back, the hysteresis, the freeze, idle epochs,
the knob bounds, stride and successor prediction, the speculative fills'
ARC provenance, off is inert, the chunk cap with autotune off, the zero
budget, the declared bounds, the disarmed hedge family), each run through
both packages on the same inputs; ``HillClimber``, ``ReadaheadPredictor``,
``TokenBucket`` and ``AutoTuner``'s knob application held step by step
against the reference's on seeded sequences; the engine's knob sites;
and the three gates of this slice (autotune, landing, pushdown), every
leg, on the CPU.

What is compared: decisions, knob values and predictions (exact), landed
bytes (exact), counter moves.  Only the gates' legs read wall-clock time
(latency injected into the loopback fakes, so their ratios are
latency-bound)."""

import types

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import nvme_strom_tpu.autotune as jat
import nvme_strom_tpu.cache as jcache
import nvme_strom_tpu.daemon.qos as jqos
import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.stats import stats as jstats
import nvme_strom_tpu_torch.autotune as tat
import nvme_strom_tpu_torch.cache as tcache
import nvme_strom_tpu_torch.daemon.qos as tqos
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.config import _VARS as TVARS
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing import (autotune_gate, landing_gate,
                                          pushdown_gate, reset_residency)

CHUNK = 64 << 10
CPU = torch.device("cpu")

PKGS = {
    "jax": types.SimpleNamespace(
        at=jat, eng=jeng, fake=jfake, cfg=jcfg, cache=jcache,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters),
        session=lambda: jeng.Session()),
    "torch": types.SimpleNamespace(
        at=tat, eng=teng, fake=tfake, cfg=tcfg, cache=tcache,
        counters=tstats.snapshot,
        session=lambda: teng.Session(device="cpu")),
}

_MOVED = ("nr_autotune_step", "nr_autotune_revert", "nr_autotune_freeze",
          "nr_readahead_fill", "nr_readahead_hit", "nr_readahead_skip",
          "bytes_readahead")


@pytest.fixture(autouse=True)
def _configs():
    snap, jsnap = tcfg.snapshot(), jcfg.snapshot()
    reset_residency()
    yield
    tcfg.restore(snap)
    jcfg.restore(jsnap)
    reset_residency()
    jcache.residency_cache.clear()
    jcache.residency_cache.configure()


def _both(fn):
    """*fn(p)* through each package; asserts the two agree, returns the
    port's."""
    out = {name: fn(p) for name, p in PKGS.items()}
    assert out["torch"] == out["jax"], out
    return out["torch"]


# ---------------------------------------------------------------------------
# the hill-climb policy (pure)
# ---------------------------------------------------------------------------

def _fam(at, lo=1, hi=256, v0=2, name="window"):
    f = at.KnobFamily(name, lo, hi)
    f.ensure(0, v0)
    return f


def _kinds(c):
    return [k for ep in c.history for (k, *_r) in ep]


def _climb(p):
    fam = _fam(p.at, lo=1, hi=16, v0=2)
    c = p.at.HillClimber([fam])
    for _ in range(20):
        c.step(p.at.Reading(fam.values[0], 1000, 10))
    return fam.values[0], "step" in _kinds(c), fam.stepped("up"), c.history


def test_monotone_climb_reaches_bound():
    """Throughput proportional to the knob: the climber doubles to the
    declared maxval and stops there."""
    value, stepped, up, _h = _both(_climb)
    assert value == 16.0 and stepped and not up


def _p99_back(p):
    fam = _fam(p.at, lo=1, hi=64, v0=4)
    c = p.at.HillClimber([fam], p99_tol=1.5)
    for _ in range(12):
        v = fam.values[0]
        # a bigger knob moves more bytes, but the tail explodes
        c.step(p.at.Reading(v, int(1000 * (v / 4.0) ** 2), 10))
    return fam.values[0], "revert" in _kinds(c), c.history


def test_p99_regression_steps_back():
    value, reverted, _h = _both(_p99_back)
    assert value == 4.0 and reverted


def _flat(p):
    fam = _fam(p.at, lo=1, hi=64, v0=8)
    c = p.at.HillClimber([fam])
    for _ in range(40):
        c.step(p.at.Reading(100.0, 1000, 10))
    tail = [k for ep in c.history[-10:] for (k, *_r) in ep]
    return fam.values[0], tail, c.history


def test_hysteresis_settles_without_oscillation():
    """A flat response: each direction rejected once, then quiet."""
    value, tail, _h = _both(_flat)
    assert value == 8.0 and tail == []


def _freeze(p):
    fam = _fam(p.at, lo=1, hi=64, v0=4)
    c = p.at.HillClimber([fam])
    c.step(p.at.Reading(100.0, 1000, 10))          # baseline + probe
    probed = fam.values[0]
    ev = c.step(p.at.Reading(100.0, 1000, 10), frozen=True)
    again = c.step(p.at.Reading(100.0, 1000, 10), frozen=True)
    return probed, [k for (k, *_r) in ev], fam.values[0], \
        [k for (k, *_r) in again]


def test_freeze_reverts_outstanding_probe():
    probed, kinds, value, again = _both(_freeze)
    assert probed != 4.0 and kinds == ["revert", "freeze"]
    assert value == 4.0 and again == ["freeze"]


def _idle(p):
    fam = _fam(p.at, lo=1, hi=64, v0=4)
    c = p.at.HillClimber([fam])
    c.step(p.at.Reading(100.0, 1000, 10))
    probed = fam.values[0]
    idle = c.step(p.at.Reading(0.0, None, 0))
    held = fam.values[0]
    c.step(p.at.Reading(500.0, 1000, 10))           # traffic: evaluate
    return probed, idle, held, _kinds(c)


def test_idle_epoch_defers_evaluation():
    probed, idle, held, kinds = _both(_idle)
    assert idle == [] and held == probed
    assert kinds.count("step") >= 2 or "revert" in kinds


def _clamp(p):
    fam = p.at.KnobFamily("cap", 64 << 10, 1 << 20)
    fam.ensure(0, 1)
    fam.ensure(1, 1 << 30)
    first = dict(fam.values)
    up = fam.stepped("up")
    for _ in range(16):
        fam.values.update(fam.stepped("up") or {})
    return first, up, dict(fam.values)


def test_knob_bounds_clamp():
    first, up, last = _both(_clamp)
    assert first == {0: 64 << 10, 1: 1 << 20}
    assert 1 not in up and up[0] == 128 << 10
    assert all(v <= 1 << 20 for v in last.values())


_READING = st.tuples(st.floats(0.0, 1e4, allow_nan=False),
                     st.one_of(st.none(), st.integers(1, 10 ** 9)),
                     st.integers(0, 50), st.booleans())


@settings(max_examples=80, deadline=None)
@given(seq=st.lists(_READING, min_size=1, max_size=60),
       v0=st.sampled_from([1, 2, 3, 8, 100, 256]),
       members=st.integers(1, 3), tol=st.sampled_from([1.2, 1.5, 3.0]))
def test_hill_climber_steps_match_reference(seq, v0, members, tol):
    """The same readings (frozen epochs among them) through both
    climbers over two families: the same events, knob values and
    history after every epoch."""
    climbers = {}
    for name, p in PKGS.items():
        fams = [p.at.KnobFamily("window", 1, 256),
                p.at.KnobFamily("hedge_ms", 1.0, 60000.0, integral=False)]
        for m in range(members):
            fams[0].ensure(m, v0 + m)
            fams[1].ensure(m, v0 * 1.5)
        climbers[name] = (p, fams, p.at.HillClimber(fams, p99_tol=tol))
    for thr, p99, nreq, frozen in seq:
        ev = {}
        for name, (p, fams, c) in climbers.items():
            ev[name] = (c.step(p.at.Reading(thr, p99, nreq), frozen=frozen),
                        [dict(f.values) for f in fams])
        assert ev["torch"] == ev["jax"]
    assert climbers["torch"][2].history == climbers["jax"][2].history


# ---------------------------------------------------------------------------
# readahead prediction (pure)
# ---------------------------------------------------------------------------

def _stride(p):
    r = p.at.ReadaheadPredictor()
    for first in (0, 8, 16):
        r.observe(first, 4)
    a = r.predict()
    r.observe(24, 4)
    return a, r.predict()


def test_stride_detection():
    assert _both(_stride) == ((24, 4), (32, 4))


def _successor(p):
    r = p.at.ReadaheadPredictor()
    for first, n in [(0, 2), (100, 2), (7, 2), (0, 2)]:
        r.observe(first, n)
    return r.predict()


def test_successor_fallback():
    """A repeating walk that is not strided replays the last follower."""
    assert _both(_successor) == (100, 2)


def _three(p):
    r = p.at.ReadaheadPredictor()
    r.observe(0, 4)
    a = r.predict()
    r.observe(8, 4)
    return a, r.predict()


def test_stride_requires_three_spans():
    assert _both(_three) == (None, None)


@settings(max_examples=80, deadline=None)
@given(seq=st.lists(st.tuples(st.integers(0, 40), st.integers(1, 6)),
                    min_size=1, max_size=80),
       strided=st.booleans())
def test_readahead_predictor_matches_reference(seq, strided):
    """The same spans (random walks, or strided runs broken by jumps)
    through both predictors: the same prediction after every span."""
    if strided:
        seq = [(i * 4 + (j % 3) * 37, 4) for i, (j, _n) in enumerate(seq)]
    preds = {name: p.at.ReadaheadPredictor() for name, p in PKGS.items()}
    for first, n in seq:
        out = {}
        for name, r in preds.items():
            r.observe(first, n)
            out[name] = r.predict()
        assert out["torch"] == out["jax"], (first, n)


@settings(max_examples=60, deadline=None)
@given(rate=st.sampled_from([0.0, 1000.0, 1 << 20, 64.0 * (1 << 20)]),
       burst=st.sampled_from([1.0, 4096.0, 1 << 20]),
       ops=st.lists(st.tuples(st.integers(1, 3 << 20),
                              st.floats(0.0, 0.5, allow_nan=False)),
                    min_size=1, max_size=40))
def test_token_bucket_matches_reference(rate, burst, ops):
    """``daemon/qos.py``'s bucket against the reference's: the same
    admissions and waits on the same clock."""
    buckets = {"jax": jqos.TokenBucket(rate, burst),
               "torch": tqos.TokenBucket(rate, burst)}
    now = 1000.0
    for b in buckets.values():
        b._t_last = now
    for nbytes, dt in ops:
        now += dt
        out = {}
        for name, b in buckets.items():
            wait = b.ready_in(nbytes, now)
            if wait == 0.0:
                b.consume(nbytes, now)
            out[name] = (wait, b._tokens)
        assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# speculative fills and the ARC
# ---------------------------------------------------------------------------

def _mk_cache(p, nbytes):
    p.cfg.set("cache_bytes", nbytes)
    c = p.cache.ResidencyCache()
    c.configure()
    return c


def _ghosts(p):
    L = 4096
    c = _mk_cache(p, 2 * L)
    skey = ("/ra",)
    c.fill(skey, 0, L, b"a" * L, speculative=True)
    c.fill(skey, L, L, b"b" * L)
    c.fill(skey, 2 * L, L, b"c" * L)
    c.fill(skey, 3 * L, L, b"d" * L)
    ghosts = set(c._b1) | set(c._b2)
    out = ((skey, 0, L) in ghosts, (skey, L, L) in ghosts)
    c.clear()
    return out


def test_speculative_fill_never_trains_ghosts():
    """An evicted speculative extent leaves no ghost; a demand one does."""
    assert _both(_ghosts) == (False, True)


def _first_touch(p):
    L = 4096
    c = _mk_cache(p, 4 * L)
    skey = ("/ra",)
    c.fill(skey, 0, L, b"a" * L, speculative=True)
    before = p.counters().get("nr_readahead_hit", 0)
    lease = c.lookup(skey, 0, L)
    lease.release()
    hits = p.counters().get("nr_readahead_hit", 0) - before
    t1 = (skey, 0, L) in c._t1 and not c._t1[(skey, 0, L)].spec
    c.lookup(skey, 0, L).release()      # second touch: frequency
    out = (hits, t1, (skey, 0, L) in c._t2)
    c.clear()
    return out


def test_speculative_hit_counts_and_stays_recency():
    """The first demand touch of a prefetched extent counts
    ``nr_readahead_hit`` and clears its provenance in t1; the second
    promotes as usual."""
    assert _both(_first_touch) == (1, True, True)


def _no_clobber(p):
    L = 4096
    c = _mk_cache(p, 4 * L)
    skey = ("/ra",)
    a = c.fill(skey, 0, L, b"x" * L)
    b = c.fill(skey, 0, L, b"y" * L, speculative=True)
    lease = c.lookup(skey, 0, L)
    out = bytearray(L)
    lease.copy_into(out)
    lease.release()
    c.clear()
    return a, b, bytes(out) == b"x" * L


def test_speculative_refresh_does_not_clobber_demand_entry():
    assert _both(_no_clobber) == (True, True, True)


# ---------------------------------------------------------------------------
# AutoTuner in a Session (loopback fake)
# ---------------------------------------------------------------------------

def _off(p, path):
    p.cfg.set("autotune", False)
    p.cfg.set("readahead", False)
    before = p.counters()
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
    try:
        with p.session() as sess:
            t = sess._tuner
            knobs = (t.active, t._thread is None,
                     t.submit_window(7) == 7 or t._windows == {},
                     t.dma_cap(123456), t.pool_width(0, 3),
                     t.hedge_delay(0, 0.25))
            handle, buf = sess.alloc_dma_buffer(8 * CHUNK)
            res = sess.memcpy_ssd2ram(src, handle, list(range(8)), CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            sess.unmap_buffer(handle)
    finally:
        src.close()
    after = p.counters()
    return knobs, {k: after.get(k, 0) - before.get(k, 0) for k in _MOVED}


def test_off_is_inert(tmp_path):
    """Both halves off: no controller thread, the knob accessors give the
    caller's defaults, and a read moves no autotune or readahead
    counter."""
    path = str(tmp_path / "off.bin")
    tfake.make_test_file(path, 8 * CHUNK)
    knobs, moved = _both(lambda p: _off(p, path))
    assert knobs == (False, True, True, 123456, 3, 0.25)
    assert not any(moved.values())


def _cap_off(p):
    p.cfg.set("autotune", False)
    with p.session() as sess:
        t = sess._tuner
        ref = p.eng.AdaptiveChunkSizer(64 << 10, 4 << 20)
        first = (t.chunk_cap(64 << 10, 4 << 20, 0), ref.effective)
        szr = t.chunk_sizers[0]
        bounds = (szr.floor, szr.limit)
        t.chunk_cap(64 << 10, 8 << 20, 0)
        # the session's dict is the tuner's
        return first, bounds, t.chunk_sizers[0].limit, \
            sess._chunk_sizers is t.chunk_sizers, \
            sess._adaptive_cap(64 << 10, 8 << 20, 0)


def test_chunk_cap_off_matches_sizer():
    """With autotune off the tuner's chunk cap is the AdaptiveChunkSizer's
    own, the sizer remade when its bounds change."""
    first, bounds, limit, alias, cap = _both(_cap_off)
    assert first[0] == first[1] and bounds == (64 << 10, 4 << 20)
    assert limit == 8 << 20 and alias and cap == 8 << 20


def test_adaptive_cap_off_is_the_sizer_bit_for_bit():
    """``_adaptive_cap`` with autotune off follows an AdaptiveChunkSizer
    fed the same service times, halving and restoring exactly."""
    tcfg.set("autotune", False)
    with teng.Session(device="cpu") as sess:
        ref = teng.AdaptiveChunkSizer(64 << 10, 4 << 20)
        caps = []
        for ns in [10 ** 9, 10 ** 9, 10 ** 6, 10 ** 6, 10 ** 6, 10 ** 6,
                   10 ** 9, 10 ** 6] * 3:
            got = sess._adaptive_cap(64 << 10, 4 << 20, 1)
            caps.append((got, ref.effective))
            sess._chunk_sizers[1].observe(ns)
            ref.observe(ns)
    assert all(a == b for a, b in caps)
    assert len({a for a, _b in caps}) > 1


def _budget0(p, path):
    p.cfg.set("readahead", True)
    p.cfg.set("readahead_budget_mb_s", 0.0)
    p.cfg.set("cache_bytes", 16 << 20)
    p.cfg.set("cache_arbitration", False)
    p.cfg.set("dma_max_size", CHUNK)
    p.cache.residency_cache.configure()
    before = p.counters()
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
    try:
        with p.session() as sess:
            sess._tuner.stop()      # the issue loop, synchronously
            handle, buf = sess.alloc_dma_buffer(4 * CHUNK)
            for first in (0, 4, 8, 12):
                res = sess.memcpy_ssd2ram(src, handle,
                                          list(range(first, first + 4)),
                                          CHUNK)
                sess.memcpy_wait(res.dma_task_id)
                sess._tuner.readahead_tick()
            sess.unmap_buffer(handle)
    finally:
        src.close()
        p.cache.residency_cache.clear()
    after = p.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in _MOVED}


def test_budget_zero_is_predict_only(tmp_path):
    """``readahead_budget_mb_s=0``: predictions are made and every issue
    is skipped; no speculative byte moves."""
    path = str(tmp_path / "ra0.bin")
    tfake.make_test_file(path, 32 * CHUNK)
    moved = _both(lambda p: _budget0(p, path))
    assert moved["bytes_readahead"] == moved["nr_readahead_fill"] == 0
    assert moved["nr_readahead_skip"] > 0


def _oversized(p, path):
    p.cfg.set("readahead", True)
    p.cfg.set("readahead_budget_mb_s", 1.0)
    p.cfg.set("cache_bytes", 16 << 20)
    p.cfg.set("cache_arbitration", False)
    p.cfg.set("dma_max_size", CHUNK)
    p.cache.residency_cache.configure()
    before = p.counters().get("bytes_readahead", 0)
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
    try:
        with p.session() as sess:
            sess._tuner.stop()
            burst = sess._tuner._bucket.burst
            handle, buf = sess.alloc_dma_buffer(32 * CHUNK)
            for first in (0, 32, 64):
                res = sess.memcpy_ssd2ram(src, handle,
                                          list(range(first, first + 32)),
                                          CHUNK)
                sess.memcpy_wait(res.dma_task_id)
            sess._tuner.readahead_tick()
            sess.unmap_buffer(handle)
    finally:
        src.close()
        p.cache.residency_cache.clear()
    return p.counters().get("bytes_readahead", 0) - before, burst


def test_oversized_prediction_is_cut_to_the_burst(tmp_path):
    """A predicted span of 2 MiB against a 1 MB/s budget (a 1 MiB burst):
    the port prefetches the span's first 1 MiB, within rate x elapsed +
    burst; the JAX package issues the whole span once its bucket is full
    (the recorded divergence)."""
    path = str(tmp_path / "big.bin")
    tfake.make_test_file(path, 128 * CHUNK)
    got = {name: _oversized(p, path) for name, p in PKGS.items()}
    (tbytes, tburst), (jbytes, jburst) = got["torch"], got["jax"]
    assert tburst == jburst == 1 << 20
    assert tbytes == 16 * CHUNK == tburst
    assert jbytes == 32 * CHUNK > jburst


def test_knob_families_inherit_declared_bounds():
    """The climber's bounds are the knobs' declared ones, the same as
    the reference's ``config.describe()``."""
    tcfg.set("autotune", True)
    desc = jcfg.describe()
    with teng.Session(device="cpu") as sess:
        sess._tuner.stop()
        c = sess._tuner._climber
        win, hedge, cap = (c.family("window"), c.family("hedge_ms"),
                           c.family("cap"))
    assert (win.lo, win.hi) == tcfg.bounds("submit_window") == \
        (float(desc["submit_window"].minval),
         float(desc["submit_window"].maxval))
    assert hedge.hi == tcfg.bounds("hedge_ms")[1] == \
        float(desc["hedge_ms"].maxval)
    assert cap.hi == tcfg.bounds("coalesce_limit")[1] == \
        float(desc["coalesce_limit"].maxval)
    assert cap.lo >= tcfg.bounds("dma_max_size")[0] == \
        float(desc["dma_max_size"].minval)
    for name in ("autotune", "autotune_interval_ms", "readahead",
                 "readahead_budget_mb_s"):
        assert TVARS[name].default == desc[name].default
        assert tcfg.bounds(name) == (desc[name].minval, desc[name].maxval)


def _disarmed(p):
    p.cfg.set("autotune", True)
    p.cfg.set("hedge_policy", "off")
    with p.session() as sess:
        sess._tuner.stop()
        sess._tuner._seed_members()
        return sess._tuner._climber.family("hedge_ms").armed


def test_hedge_family_disarmed_under_policy_off():
    assert _both(_disarmed) is False


class _Probe:
    """A stand-in Session for the tuners' knob application: records the
    pool retirements and lane scale-outs the tuner asks for."""

    def __init__(self):
        self.calls = []

    def _retire_member_pool(self, m):
        self.calls.append(("retire", m))

    def _autotune_scale_lanes(self, want):
        self.calls.append(("lanes", want))


@settings(max_examples=50, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seq=st.lists(_READING, min_size=1, max_size=40),
       window=st.sampled_from([1, 2, 16]),
       hedge=st.sampled_from(["off", "fixed"]))
def test_autotuner_epochs_match_reference(monkeypatch, seq, window, hedge):
    """Both AutoTuners over two members, fed the same readings and freeze
    verdicts: after every epoch the same applied windows, caps and hedge
    delays, the same effective knobs at the engine's sites, the same
    pools retired and lane counts asked, the same published knobs."""
    tuners = {}
    for name, p in PKGS.items():
        p.cfg.set("autotune", True)
        p.cfg.set("submit_window", window)
        p.cfg.set("dma_max_size", 256 << 10)
        p.cfg.set("hedge_policy", hedge)
        probe = _Probe()
        t = p.at.AutoTuner(probe)
        tuners[name] = (t, probe)
    monkeypatch.setattr(tstats, "member_snapshot", lambda: {0: {}, 1: {}})
    monkeypatch.setattr(jstats, "member_snapshot", lambda: {0: {}, 1: {}})
    for thr, p99, nreq, frozen in seq:
        out = {}
        for name, (t, probe) in tuners.items():
            reading = PKGS[name].at.Reading(thr, p99, nreq)
            t._read_sensors = lambda r=reading: r
            t._health_freeze = lambda f=frozen: f
            t._tune_epoch()
            out[name] = (dict(t._windows), dict(t._caps), dict(t._hedges),
                         t.last_step, list(probe.calls),
                         t.submit_window(3), t.dma_cap(1 << 20),
                         t.pool_width(1, 5), t.hedge_delay(0, 0.02),
                         t.chunk_cap(64 << 10, 8 << 20, 1))
        assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the engine's knob sites and the speculative read
# ---------------------------------------------------------------------------

def test_tuned_knobs_reach_the_engine(tmp_path):
    """With the controller on, the tuned request cap is what the planner
    merges up to and the tuned window the member pools' width (a window
    step retires them; they come back at the tuned width), and the bytes
    stay the file's."""
    tcfg.set("autotune", True)
    tcfg.set("io_backend", "python")
    tcfg.set("cache_arbitration", False)
    tcfg.set("dma_max_size", 64 << 10)
    path = str(tmp_path / "one.bin")
    tfake.make_test_file(path, 32 * CHUNK)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"m{i}.bin")
        tfake.make_test_file(p, 16 * CHUNK, seed=i)
        paths.append(p)
    one = tfake.FakeNvmeSource(path, force_cached_fraction=0.0)
    two = tfake.FakeStripedNvmeSource(paths, CHUNK,
                                      force_cached_fraction=0.0)
    try:
        with teng.Session(device="cpu") as sess:
            t = sess._tuner
            t.stop()
            handle, buf = sess.alloc_dma_buffer(32 * CHUNK)

            def read(src):
                before = tstats.snapshot().get("nr_submit_dma", 0)
                res = sess.memcpy_ssd2ram(src, handle, list(range(32)),
                                          CHUNK)
                sess.memcpy_wait(res.dma_task_id)
                return (tstats.snapshot().get("nr_submit_dma", 0) - before,
                        bytes(buf.view()[:32 * CHUNK]))

            # the controller arms the members the stats have seen: the
            # striped source's first read shows it member 1, whatever ran
            # before in this process
            read(two)
            t._seed_members()
            for m in (0, 1):
                sess._retire_member_pool(m)
            static, want = read(one)
            assert want == tfake.expected_bytes(0, 32 * CHUNK)
            read(two)
            # seeded at the static window: the member pools' width
            assert sess._member_pools[(1, False)]._max_workers == \
                tcfg.get("submit_window")
            t._caps.update({0: 4 * CHUNK, 1: 4 * CHUNK})
            t._apply("window", "up", {0: 32, 1: 32}, "step")
            assert (1, False) not in sess._member_pools
            tuned, got = read(one)
            assert got == want
            read(two)
            assert sess._member_pools[(1, False)]._max_workers == 32
            sess.unmap_buffer(handle)
    finally:
        one.close()
        two.close()
    assert (static, tuned) == (32, 8)


def test_read_survives_a_pool_retired_before_its_submit(tmp_path):
    """A window step that retires a member's pool between the fetch and
    the submit (the tuner's thread against a demand read) costs the read
    nothing: the member's current pool takes the request."""
    tcfg.set("autotune", True)
    tcfg.set("io_backend", "python")
    tcfg.set("cache_arbitration", False)
    tcfg.set("dma_max_size", 64 << 10)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"m{i}.bin")
        tfake.make_test_file(p, 16 * CHUNK, seed=i)
        paths.append(p)
    two = tfake.FakeStripedNvmeSource(paths, CHUNK,
                                      force_cached_fraction=0.0)
    retired = []
    try:
        with teng.Session(device="cpu") as sess:
            sess._tuner.stop()
            fetch = sess._member_pool

            def fetch_then_retire(member, legs=False):
                pool = fetch(member, legs)
                if not legs and member not in retired:
                    retired.append(member)
                    sess._retire_member_pool(member)
                return pool

            sess._member_pool = fetch_then_retire
            handle, buf = sess.alloc_dma_buffer(32 * CHUNK)
            res = sess.memcpy_ssd2ram(two, handle, list(range(32)), CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            got = bytes(buf.view()[:32 * CHUNK])
            sess.unmap_buffer(handle)
    finally:
        two.close()
    members = [tfake.expected_bytes(0, 16 * CHUNK, seed=i)
               for i in range(2)]
    want = b"".join(members[c % 2][(c // 2) * CHUNK:(c // 2 + 1) * CHUNK]
                    for c in range(32))
    assert sorted(retired) == [0, 1]
    assert got == want


def test_window_chunks_takes_the_tuned_window():
    """The tuned window goes through the same slice rule: at least 1 MiB
    a slice at small chunks."""
    tcfg.set("submit_window", 2)
    assert teng._window_chunks(1 << 20) == 2
    assert teng._window_chunks(8192) == 256
    assert teng._window_chunks(8192, 8) == 1024
    assert teng._window_chunks(4 << 20, 8) == 8


def test_hedge_delay_follows_the_tuner(tmp_path):
    """A hedged read's delay is the tuned one under autotune, hedge_ms
    otherwise."""
    tcfg.set("autotune", True)
    tcfg.set("hedge_policy", "fixed")
    tcfg.set("hedge_ms", 20.0)
    seen = []
    with teng.Session(device="cpu") as sess:
        sess._tuner.stop()
        sess._tuner._hedges[0] = 3.0

        def fake_hedged(task, source, r, piece, delay_s, mirror):
            seen.append(delay_s)
            return False

        sess._read_hedged = fake_hedged
        paths = []
        for i in range(2):
            p = str(tmp_path / f"h{i}.bin")
            tfake.make_test_file(p, 4 * CHUNK)
            paths.append(p)
        tcfg.set("io_backend", "python")
        src = tfake.FakeStripedNvmeSource(paths, CHUNK,
                                          force_cached_fraction=0.0,
                                          mirror="paired")
        try:
            handle, buf = sess.alloc_dma_buffer(2 * CHUNK)
            res = sess.memcpy_ssd2ram(src, handle, [0, 1], CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            sess.unmap_buffer(handle)
        finally:
            src.close()
    assert seen and 0.003 in seen and all(d in (0.003, 0.02) for d in seen)


def _speculative(p, path):
    p.cfg.set("readahead", True)
    p.cfg.set("readahead_budget_mb_s", 0.0)
    p.cfg.set("cache_bytes", 16 << 20)
    p.cfg.set("cache_arbitration", False)
    p.cfg.set("dma_max_size", CHUNK)
    p.cache.residency_cache.configure()
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
    try:
        with p.session() as sess:
            sess._tuner.stop()
            handle, buf = sess.alloc_dma_buffer(4 * CHUNK)
            before = p.counters()
            res = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK,
                                      speculative=True)
            sess.memcpy_wait(res.dma_task_id)
            spec = res.nr_ssd2dev
            trained = len(sess._tuner._predictors)
            mid = p.counters()
            res = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK,
                                      speculative=True)
            sess.memcpy_wait(res.dma_task_id)
            again = res.nr_ssd2dev
            provenance = [e.spec for e in
                          p.cache.residency_cache._t1.values()]
            sess.unmap_buffer(handle)
            after = p.counters()
    finally:
        src.close()
        p.cache.residency_cache.clear()
    d1 = {k: mid.get(k, 0) - before.get(k, 0)
          for k in ("nr_cache_hit", "nr_cache_miss", "nr_cache_fill")}
    d2 = {k: after.get(k, 0) - mid.get(k, 0)
          for k in ("nr_cache_hit", "nr_cache_miss")}
    return (spec, trained, d1, again, d2, provenance)


def test_speculative_read_skips_the_tiers_and_tags_its_fills(tmp_path):
    """``memcpy_ssd2ram(speculative=True)``: no lookup (a resident chunk
    is read again, no hit or miss counted), no predictor training, and
    its fills carry the speculative provenance."""
    path = str(tmp_path / "sp.bin")
    tfake.make_test_file(path, 8 * CHUNK)
    n, trained, d1, again, d2, prov = _both(lambda p: _speculative(p, path))
    assert n == 4 and trained == 0 and again == 4
    assert d1 == {"nr_cache_hit": 0, "nr_cache_miss": 0, "nr_cache_fill": 4}
    assert d2 == {"nr_cache_hit": 0, "nr_cache_miss": 0}
    assert prov == [True] * 4


def test_controller_thread_runs_epochs_and_stops(tmp_path):
    """With autotune on, the thread steps epochs on its own while reads
    run (steps or reverts counted, knobs published in the member rows)
    and is gone after close."""
    import time
    tcfg.set("autotune", True)
    tcfg.set("autotune_interval_ms", 10.0)
    tcfg.set("io_backend", "python")
    tcfg.set("cache_arbitration", False)
    tcfg.set("dma_max_size", CHUNK)
    tcfg.set("submit_window", 2)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"t{i}.bin")
        tfake.make_test_file(p, 16 * CHUNK, seed=i)
        paths.append(p)
    src = tfake.FakeStripedNvmeSource(
        paths, CHUNK, fault_plan=tfake.FaultPlan(latency_s=0.002),
        force_cached_fraction=0.0)
    before = tstats.snapshot()
    try:
        sess = teng.Session(device="cpu")
        thread = sess._tuner._thread
        assert thread is not None and thread.name == "strom-autotune"
        handle, buf = sess.alloc_dma_buffer(32 * CHUNK)
        t_end = time.monotonic() + 1.0
        while time.monotonic() < t_end:
            res = sess.memcpy_ssd2ram(src, handle, list(range(32)), CHUNK)
            sess.memcpy_wait(res.dma_task_id)
        sess.unmap_buffer(handle)
        sess.close()
    finally:
        src.close()
    after = tstats.snapshot()
    moved = sum(after.get(k, 0) - before.get(k, 0)
                for k in ("nr_autotune_step", "nr_autotune_revert"))
    assert moved > 0
    assert not thread.is_alive() and sess._tuner._thread is None
    rows = tstats.member_snapshot()
    assert "knob_window" in rows[0] and "knob_cap" in rows[1]


def test_readahead_prefetches_into_the_ram_tier(tmp_path):
    """An ordered scan in spans with readahead on: the predicted spans
    are filled before they are asked (``nr_readahead_fill``,
    ``bytes_readahead``), later spans hit the RAM tier
    (``nr_readahead_hit``), and every span's bytes are the file's."""
    tcfg.set("readahead", True)
    tcfg.set("readahead_budget_mb_s", 1024.0)
    tcfg.set("cache_bytes", 16 << 20)
    tcfg.set("cache_arbitration", False)
    tcfg.set("dma_max_size", CHUNK)
    tcache.residency_cache.configure()
    path = str(tmp_path / "ra.bin")
    tfake.make_test_file(path, 32 * CHUNK)
    expect = tfake.expected_bytes(0, 32 * CHUNK)
    before = tstats.snapshot()
    src = tfake.FakeNvmeSource(path, force_cached_fraction=0.0)
    try:
        with teng.Session(device="cpu") as sess:
            sess._tuner.stop()
            for first in range(0, 32, 4):
                got = autotune_gate._read_pass(sess, src,
                                               range(first, first + 4))
                assert got == expect[first * CHUNK:(first + 4) * CHUNK]
                sess._tuner.readahead_tick()
    finally:
        src.close()
    after = tstats.snapshot()
    d = {k: after.get(k, 0) - before.get(k, 0)
         for k in ("nr_readahead_fill", "bytes_readahead",
                   "nr_readahead_hit", "nr_cache_hit")}
    # spans 4..7 arrive prefetched: the first three only train the model
    assert d["nr_readahead_fill"] >= 4
    assert d["bytes_readahead"] == d["nr_readahead_fill"] * 4 * CHUNK
    assert d["nr_readahead_hit"] >= 16 and d["nr_cache_hit"] >= 16


# ---------------------------------------------------------------------------
# the three gates of this slice, every leg, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gate", [landing_gate, pushdown_gate],
                         ids=["landing", "pushdown"])
def test_gate_passes_on_the_cpu(gate, capsys):
    """The landing and pushdown gates, every leg, through the module's
    entry on the host (the pushdown gate's throughput ratio is
    latency-bound: each chunk pays the injected latency)."""
    assert gate.main(["-d", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and out.count(" leg ok") >= 3


@pytest.mark.parametrize("leg", ["freeze", "readahead", "off"])
def test_autotune_gate_legs_on_the_cpu(tmp_path, leg, capsys):
    """The autotune gate's freeze, readahead and off-is-off legs with the
    reference's limits, on the host."""
    run = {"freeze": lambda d: autotune_gate._leg_health_freeze(
               d, CPU, autotune_gate.DEGRADED_X),
           "readahead": lambda d: autotune_gate._leg_readahead(
               d, CPU, autotune_gate.HIT_RATIO),
           "off": lambda d: autotune_gate._leg_off_is_off(d, CPU)}[leg]
    run(str(tmp_path))
    assert " leg ok" in capsys.readouterr().out


def test_autotune_gate_convergence_runs_on_the_cpu(tmp_path, capsys):
    """The convergence leg on the host, with its limits: 1.5x the static
    throughput within 20 epochs, every pass byte-identical (checked
    inside), settled, the controller probing the knobs from the bad
    statics.  Each request is charged 70 ms, not the module's 20 ms:
    beside a parallel test suite a thread's wake-up can come tens of ms
    late, and at 20 ms that is past the next log2 latency bucket, so
    the p99 guard steps a good probe back (in both packages); 70 ms sits
    64 ms inside its bucket."""
    static, epochs, history = autotune_gate._leg_convergence(
        str(tmp_path), CPU, autotune_gate.RATIO, autotune_gate.EPOCHS,
        latency_s=0.07)
    assert " leg ok" in capsys.readouterr().out
    kinds = [k for ep in history for (k, *_r) in ep]
    assert len(static) == 4 and len(epochs) == len(history) == 20
    assert kinds and kinds[0] == "step" and "freeze" not in kinds


@pytest.mark.parametrize("gate", [autotune_gate, landing_gate,
                                  pushdown_gate],
                         ids=["autotune", "landing", "pushdown"])
def test_gate_refuses_without_a_card(gate):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the gate would run on it")
    assert gate.main([]) == 2


def test_autotune_gate_limits_are_the_references():
    assert (autotune_gate.RATIO, autotune_gate.EPOCHS,
            autotune_gate.DEGRADED_X, autotune_gate.HIT_RATIO) == \
        (1.5, 20, 15.0, 0.5)
    assert landing_gate.RATIO_LIMIT == 1.05
    assert (pushdown_gate.RATIO_LIMIT, pushdown_gate.ROUNDS) == (1.2, 3)
