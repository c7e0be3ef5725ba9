"""The integrity domain of the PyTorch port (``integrity.py``: the domain,
the scrubber, the pressure registry; the tiers' checksums) against the JAX
package: the counterparts of ``tests/test_integrity.py`` but its four KV
block pool tests (the pool is not part of the port): the mode knob and its
off state, rot in a RAM slab under a lease and under the scrubber, a
corrupt promote refused, a corrupt demote never reaching the RAM tier,
leased HBM extents left alone, the scrubber's rate and its idling, mlock
refusals, the memlock budget, the registry, and a heal whose source is
gone.  Also the counter names against the reference's ``STAT_FIELDS`` and
the port's scrub gate.

The scrubber's rate is held by driving its token bucket tick by tick;
a test that waits on the background thread waits on a counter with a
deadline, never for a fixed time."""

import types
import weakref

import pytest

import nvme_strom_tpu.cache as jcache
import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.integrity as jint
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.api import STAT_FIELDS
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.serving.hbm_tier import hbm_tier as jhbm_tier
from nvme_strom_tpu.stats import stats as jstats
import nvme_strom_tpu_torch.cache as tcache
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.integrity as tint
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.api import RESIDENCY_COUNTERS
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.serving.hbm_tier import hbm_tier as thbm_tier
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing import reset_residency, scrub_gate

CHUNK = 64 << 10

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", eng=jeng, fake=jfake, cfg=jcfg, cache=jcache,
        hbm=types.SimpleNamespace(hbm_tier=jhbm_tier),
        integ=jint,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters)),
    "torch": types.SimpleNamespace(
        name="torch", eng=teng, fake=tfake, cfg=tcfg, cache=tcache,
        hbm=types.SimpleNamespace(hbm_tier=thbm_tier), integ=tint,
        counters=tstats.snapshot),
}


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    reset_residency()
    yield
    tcfg.restore(snap)
    reset_residency()


def _both(fn, *args):
    out = {name: fn(p, *args) for name, p in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _delta(p, before, name):
    return p.counters().get(name, 0) - before.get(name, 0)


def _cache_on(p, nbytes=64 << 20, mode="always"):
    p.cfg.set("integrity", mode)
    p.integ.domain.configure()
    p.cfg.set("cache_bytes", nbytes)
    p.cache.residency_cache.clear()
    p.cache.residency_cache.configure()


def _hbm_on(p, nbytes):
    p.cfg.set("hbm_cache_bytes", nbytes)
    if p.name == "torch":
        p.hbm.hbm_tier.configure(device="cpu")
    else:
        p.hbm.hbm_tier.configure()


def _pat(i: int, n: int = CHUNK) -> bytes:
    return bytes([(i * 11 + 3) % 256]) * n


def _copy(lease, n=CHUNK):
    out = bytearray(n)
    return bytes(out) if lease.copy_into(out) else False


# -- configuration and the off mode -------------------------------------------

@pytest.mark.parametrize("name,value,ok", [
    ("integrity", "off", True), ("integrity", "transitions", True),
    ("integrity", "always", True), ("integrity", "paranoid", False),
    ("scrub_bytes_per_sec", -1, False), ("scrub_bytes_per_sec", "1g", True),
    ("memlock_budget", -1, False), ("memlock_budget", 4096, True),
    ("checksum_verify", True, True), ("checksum_retries", 17, False),
    ("checksum_retries", 0, True), ("tier_unified", False, True)])
def test_integrity_knobs_validate_like_the_reference(name, value, ok):
    for cfg in (jcfg, tcfg):
        if ok:
            cfg.set(name, value)
        else:
            with pytest.raises(Exception):
                cfg.set(name, value)
    if ok:
        assert tcfg.get(name) == jcfg.get(name)


def test_defaults_match_the_reference():
    names = ("checksum_verify", "checksum_retries", "tier_ram_bytes",
             "cache_bytes", "tier_hbm_bytes", "hbm_cache_bytes",
             "tier_unified", "integrity", "scrub_bytes_per_sec",
             "memlock_budget")
    assert {n: tcfg.get(n) for n in names} == {n: jcfg.get(n) for n in names}


def test_counter_names_are_the_reference_stat_fields():
    assert set(RESIDENCY_COUNTERS) <= set(STAT_FIELDS)
    assert len(set(RESIDENCY_COUNTERS)) == len(RESIDENCY_COUNTERS)


def _off(p):
    _cache_on(p, mode="off")
    before = p.counters()
    steps = [p.integ.domain.checksum(b"abc"),
             p.cache.residency_cache.fill(("#off",), 0, CHUNK, _pat(0))]
    lease = p.cache.residency_cache.lookup(("#off",), 0, CHUNK)
    steps.append(_copy(lease) == _pat(0))
    lease.release()
    steps.append(_delta(p, before, "nr_integrity_verify"))
    return steps


def test_integrity_off_is_zero_overhead():
    assert _both(_off) == [None, True, True, 0]


def test_crc32c_matches_the_reference():
    data = bytes(range(256)) * 97 + b"tail"
    assert tint.crc32c(data) == jint.crc32c(data)
    tcfg.set("integrity", "transitions")
    tint.domain.configure()
    assert tint.domain.checksum(data) == jint.crc32c(data)


# -- the RAM tier ---------------------------------------------------------------

def _host_leased(p):
    _cache_on(p)
    skey = ("#rot",)
    p.cache.residency_cache.fill(skey, 0, CHUNK, _pat(1))
    before = p.counters()
    lease = p.cache.residency_cache.lookup(skey, 0, CHUNK)
    steps = [p.fake.flip_resident_host(skey, 0, CHUNK, pos=123),
             _copy(lease)]
    lease.release()
    steps += [_delta(p, before, "nr_integrity_fail"),
              p.cache.residency_cache.lookup(skey, 0, CHUNK) is None]
    return steps


def test_host_corruption_detected_on_leased_read():
    assert _both(_host_leased) == [True, False, 1, True]


def _host_scrub(p):
    _cache_on(p)
    skey = ("#scrub",)
    rc = p.cache.residency_cache
    rc.fill(skey, 0, CHUNK, _pat(2))
    key = (skey, 0, CHUNK)
    steps = [key in rc.scrub_keys(), rc.scrub_extent(key)[:2]]
    lease = rc.lookup(skey, 0, CHUNK)
    steps += [p.fake.flip_resident_host(skey, 0, CHUNK),
              rc.scrub_extent(key)[:2], rc.lookup(skey, 0, CHUNK) is None,
              _copy(lease)]
    lease.release()
    return steps


def test_host_scrub_extent_drops_stale_under_lease():
    assert _both(_host_scrub) == [True, (True, CHUNK), True, (False, CHUNK),
                                  True, False]


# -- the HBM tier ---------------------------------------------------------------

def _promote_refused(p):
    p.cfg.set("integrity", "always")
    p.integ.domain.configure()
    _hbm_on(p, 4 * CHUNK)
    tier = p.hbm.hbm_tier
    skey = ("#promote",)
    bad = p.integ.domain.checksum(b"not the payload")
    steps = [tier.admit(skey, 0, CHUNK, _pat(3), crc=bad),
             tier.lookup(skey, 0, CHUNK) is None,
             tier.admit(skey, 0, CHUNK, _pat(3))]
    lease = tier.lookup(skey, 0, CHUNK)
    steps.append(_copy(lease) == _pat(3))
    lease.release()
    return steps


def test_hbm_corrupt_promote_refused():
    assert _both(_promote_refused) == [False, True, True, True]


def _demote_poison(p):
    _cache_on(p)
    _hbm_on(p, 2 * CHUNK)
    tier, rc = p.hbm.hbm_tier, p.cache.residency_cache
    skey = ("#demote",)
    before = p.counters()
    steps = [tier.admit(skey, 0, CHUNK, _pat(4)),
             tier.admit(skey, CHUNK, CHUNK, _pat(5)),
             p.fake.flip_resident_hbm(skey, 0, CHUNK, pos=9),
             tier.admit(skey, 2 * CHUNK, CHUNK, _pat(6)),   # evicts 0
             tier.admit(skey, 3 * CHUNK, CHUNK, _pat(7))]   # evicts 1
    steps += [_delta(p, before, "nr_integrity_fail"),
              _delta(p, before, "nr_hbm_demote"),
              rc.lookup(skey, 0, CHUNK) is None]
    lease = rc.lookup(skey, CHUNK, CHUNK)
    steps.append(_copy(lease) == _pat(5))
    lease.release()
    return steps


def test_hbm_corrupt_demote_never_poisons_host():
    assert _both(_demote_poison) == [True, True, True, True, True, 1, 2,
                                     True, True]


def _hbm_leased(p):
    p.cfg.set("integrity", "always")
    p.integ.domain.configure()
    _hbm_on(p, 4 * CHUNK)
    tier = p.hbm.hbm_tier
    skey = ("#pinned",)
    key = (skey, 0, CHUNK)
    steps = [tier.admit(skey, 0, CHUNK, _pat(8)), key in tier.scrub_keys()]
    lease = tier.lookup(skey, 0, CHUNK)
    steps += [key in tier.scrub_keys(), tier.scrub_extent(key)]
    lease.release()
    steps.append(key in tier.scrub_keys())
    return steps


def test_hbm_scrub_skips_leased_working_set():
    assert _both(_hbm_leased) == [True, True, False, None, True]


def test_hbm_extents_are_registered_tensors_and_revocable():
    """The port's HBM extents are uint8 tensors in the device registry:
    a backend loss's revoke_all reaches them, and a lease on a revoked
    extent fails open."""
    import torch

    from nvme_strom_tpu_torch.hbm.registry import registry
    _hbm_on(PKGS["torch"], 4 * CHUNK)
    tier = thbm_tier
    skey = ("#revoke",)
    assert tier.admit(skey, 0, CHUNK, _pat(9))
    lease = tier.lookup(skey, 0, CHUNK)
    t = lease.device_array()
    assert t.dtype == torch.uint8 and t.device.type == "cpu"
    assert lease._entry.handle in registry.list()
    assert bytes(t.numpy()) == _pat(9)
    lease.release()
    registry.revoke_all("test: backend lost")
    lease = tier.lookup(skey, 0, CHUNK)
    assert lease.device_array() is None and _copy(lease) is False
    lease.release()
    assert tier.drop(skey, 0, CHUNK)
    assert all(h != lease._entry.handle for h in registry.list())


# -- the scrubber ----------------------------------------------------------------

def _stopped_scrubber(sess):
    """The Session's scrubber with its thread stopped, to be driven by
    hand."""
    sc = sess._scrubber
    sc.stop()
    sc._stop.clear()
    return sc


def _rate(p, ticks):
    """The bytes each tick of a Session's scrubber scrubs at one extent a
    second over eight resident extents (the thread itself stopped)."""
    _cache_on(p)
    skey = ("#rate",)
    for i in range(8):
        p.cache.residency_cache.fill(skey, i * CHUNK, CHUNK, _pat(i))
    with p.eng.Session() as sess:
        sc = _stopped_scrubber(sess)
        if p.name == "torch":
            return [sc._tick(CHUNK) for _ in range(ticks)]
        # the reference's loop body, one tick at a time
        out = []
        for _ in range(ticks):
            budget = int(CHUNK * sc.INTERVAL + sc._carry)
            if budget <= 0:
                sc._carry += CHUNK * sc.INTERVAL
                out.append(0)
                continue
            done = sc._scrub_round(budget)
            sc._carry = min(budget - done, CHUNK)
            out.append(done)
        return out


def test_scrubber_rate_limited():
    """At one extent's worth a second, twelve ticks (0.6 s of them) walk
    one extent and no more; forty (two seconds) walk two."""
    per_tick = _both(_rate, 40)
    assert sum(per_tick[:12]) == CHUNK
    assert sum(per_tick) == 2 * CHUNK


def test_scrubber_idle_when_domain_off():
    _cache_on(PKGS["torch"], mode="off")
    for i in range(4):
        tcache.residency_cache.fill(("#idle",), i * CHUNK, CHUNK, _pat(i))
    with teng.Session() as sess:
        sc = _stopped_scrubber(sess)
        before = tstats.snapshot().get("bytes_scrubbed", 0)
        assert [sc._tick(1 << 30) for _ in range(5)] == [0] * 5
        assert tstats.snapshot().get("bytes_scrubbed", 0) == before


def _round_robin(p):
    _cache_on(p)
    skey = ("#rr",)
    for i in range(6):
        p.cache.residency_cache.fill(skey, i * CHUNK, CHUNK, _pat(i))
    with p.eng.Session() as sess:
        sc = _stopped_scrubber(sess)
        rounds = []
        for _ in range(4):
            sc._scrub_round(2 * CHUNK)
            rounds.append(sc._cursor.get("ram"))
        return rounds


def test_scrubber_walks_round_robin_like_the_reference():
    rounds = _both(_round_robin)
    assert [k[1] // CHUNK for k in rounds] == [1, 3, 5, 1]


def _source_gone(p):
    import time
    _cache_on(p)
    p.cfg.set("scrub_bytes_per_sec", 1 << 30)
    skey = ("#gone",)

    class _Closed:
        closed = True
        size = 0

    src = _Closed()
    with p.eng.Session():
        p.cache.residency_cache.fill(skey, 0, CHUNK, _pat(1),
                                     source_ref=weakref.ref(src))
        before = p.counters()
        p.fake.flip_resident_host(skey, 0, CHUNK)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and \
                _delta(p, before, "nr_scrub_fail") == 0:
            time.sleep(0.02)
        failed = _delta(p, before, "nr_scrub_fail") > 0
    return failed, p.cache.residency_cache.lookup(skey, 0, CHUNK) is None


def test_scrub_refill_source_gone_counts_fail():
    assert _both(_source_gone) == (True, True)


# -- pressure -------------------------------------------------------------------

def _mlock_refused(p, monkeypatch):
    class _NoLock:
        def mlock(self, addr, length):
            return -1

    monkeypatch.setattr(p.cache, "_libc", _NoLock())
    _cache_on(p, mode="off")
    before = p.counters()
    steps = [p.cache.residency_cache.fill(("#nolock",), 0, CHUNK, _pat(9)),
             _delta(p, before, "nr_cache_mlock_fail"),
             p.cache.residency_cache.unpinned_bytes(),
             p.counters().get("cache_unpinned_bytes", 0)]
    lease = p.cache.residency_cache.lookup(("#nolock",), 0, CHUNK)
    steps.append(_copy(lease) == _pat(9))
    lease.release()
    return steps


def test_mlock_failure_counted_and_fails_open(monkeypatch):
    assert _both(_mlock_refused, monkeypatch) == [True, 1, CHUNK, CHUNK,
                                                  True]


def _budget(p, monkeypatch):
    monkeypatch.setattr(p.cache.ResidencyCache, "_try_pin",
                        staticmethod(lambda mm, length: True))
    _cache_on(p, mode="off")
    rc = p.cache.residency_cache
    skey = ("#budget",)
    steps = [rc.fill(skey, i * CHUNK, CHUNK, _pat(i)) for i in range(4)]
    steps.append(rc.pinned_bytes())
    before = p.counters()
    p.cfg.set("memlock_budget", CHUNK)
    rc.configure()
    steps += [rc.pinned_bytes(), _delta(p, before, "nr_pressure_shed"),
              _delta(p, before, "nr_tier_ram_shed"),
              rc.fill(skey, 8 * CHUNK, CHUNK, _pat(8)),
              _delta(p, before, "nr_pressure_passthrough")]
    return steps


def test_memlock_budget_sheds_and_passes_through(monkeypatch):
    assert _both(_budget, monkeypatch) == [True] * 4 + [
        4 * CHUNK, CHUNK, 3, 3, False, 1]


def test_request_shed_registry_never_raises():
    class _Broken:
        def shed(self, nbytes, *, reason="memlock"):
            raise RuntimeError("boom")

    class _Good:
        def __init__(self):
            self.asked = 0

        def shed(self, nbytes, *, reason="memlock"):
            self.asked += nbytes
            return nbytes

    broken, good = _Broken(), _Good()
    tint.register_pool(broken)
    tint.register_pool(good)
    assert set(tint.pools()) >= {broken, good}
    assert tint.request_shed(4096) >= 4096
    assert good.asked >= 4096
    del broken, good
    import gc
    gc.collect()
    assert not any(type(x).__name__ in ("_Broken", "_Good")
                   for x in tint.pools())


# -- the port's gate -------------------------------------------------------------

def test_scrub_gate_legs_on_the_cpu(tmp_path):
    import torch
    dev = torch.device("cpu")
    assert scrub_gate._leg_host_heal(str(tmp_path), dev) > 0
    scrub_gate._leg_hbm_heal(str(tmp_path), dev)
    assert scrub_gate._leg_pressure(str(tmp_path), dev) in (
        "ok", "mlock refused")
