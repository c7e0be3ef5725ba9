"""Member survival of the PyTorch port against the JAX package: the paired
mirror geometry on the same member sizes, degraded striping across a
mid-task fail-stop, the canary-driven rejoin, hedged reads against a slow
member, the native lanes' mirror remap, and the port's chaos harness
(``testing/chaos.py``) with each scenario it carries.  The counterparts of
``tests/test_chaos.py``.  Backoffs are 0; hedge tests read counters, never
wall-clock ratios."""

import random
import types

import pytest

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.stats import stats as jstats
from nvme_strom_tpu.stripe import StripeMap as JStripeMap
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.fault import ALLOWED_TRANSITIONS, HealthState
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.stripe import StripeMap
from nvme_strom_tpu_torch.testing import chaos, reset_residency
from nvme_strom_tpu_torch.testing.chaos import (STRIPE,
                                                assert_transitions_legal,
                                                expected_mirrored_stream,
                                                make_mirrored_members,
                                                read_all)

PKGS = {
    "jax": types.SimpleNamespace(
        eng=jeng, fake=jfake, cfg=jcfg,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters)),
    "torch": types.SimpleNamespace(
        eng=teng, fake=tfake, cfg=tcfg, counters=tstats.snapshot),
}
PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    reset_residency()
    for cfg in (jcfg, tcfg):
        cfg.set("retry_backoff_ms", 0.0)
    yield
    tcfg.restore(snap)
    reset_residency()


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


def _mirrored_fake(p, tmp_path, plan, tag="m"):
    paths = make_mirrored_members(str(tmp_path), tag=tag)
    return paths, p.fake.FakeStripedNvmeSource(
        paths, stripe_chunk_size=STRIPE, fault_plan=plan,
        force_cached_fraction=0.0, mirror="paired")


# ---------------------------------------------------------------------------
# the paired map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [
    [1 << 20, 1 << 20, 1 << 20, 768 << 10],
    [1 << 20] * 2,
    [512 << 10, 1 << 20, 1 << 20, 256 << 10, 192 << 10, 640 << 10],
])
def test_paired_map_geometry_matches_reference(sizes):
    mine = StripeMap(sizes, chunk_size=64 << 10, mirror="paired")
    ref = JStripeMap(sizes, chunk_size=64 << 10, mirror="paired")
    assert mine.total_size == ref.total_size
    assert mine.zones == [type(mine.zones[0])(*z.__dict__.values())
                          for z in ref.zones]
    for m in range(len(sizes) + 2):
        assert mine.mirror_of(m) == ref.mirror_of(m)
    got = [(e.member, e.member_offset, e.length, e.logical_offset)
           for e in mine.map_range(0, mine.total_size)]
    want = [(e.member, e.member_offset, e.length, e.logical_offset)
            for e in ref.map_range(0, ref.total_size)]
    assert got == want and all(m % 2 == 0 for m, *_ in got)
    assert StripeMap(sizes, 64 << 10).mirror_of(0) is None


def test_paired_geometry_in_detail():
    m = StripeMap([1 << 20, 1 << 20, 1 << 20, 768 << 10],
                  chunk_size=64 << 10, mirror="paired")
    assert m.total_size == (1 << 20) + (768 << 10)
    assert (m.mirror_of(0), m.mirror_of(1), m.mirror_of(2),
            m.mirror_of(3), m.mirror_of(7)) == (1, 0, 3, 2, None)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_paired_needs_even_member_count(tmp_path, n):
    with pytest.raises(ValueError, match="even member"):
        StripeMap([1 << 20] * n, chunk_size=64 << 10, mirror="paired")
    with pytest.raises(ValueError, match="even member"):
        JStripeMap([1 << 20] * n, chunk_size=64 << 10, mirror="paired")
    paths = []
    for i in range(n):
        paths.append(str(tmp_path / f"o{i}.bin"))
        tfake.make_test_file(paths[-1], 1 << 20)
    with pytest.raises(StromError) as e:
        teng.StripedSource(paths, STRIPE, mirror="paired")
    assert e.value.errno == 22


def test_writable_paired_accepted_and_config_mirror_default(tmp_path):
    paths = make_mirrored_members(str(tmp_path))
    with teng.StripedSource(paths, STRIPE, writable=True,
                            mirror="paired") as src:
        assert src.mirror_of(0) == 1 and src.mirror_of(1) == 0
        src._check_writable()
    tcfg.set("mirror", "paired")
    with teng.open_source(paths, stripe_chunk_size=STRIPE) as src:
        assert src.mirror_of(2) == 3 and src.size == 2 << 20
    with teng.open_source(paths, stripe_chunk_size=STRIPE,
                          mirror="none") as src:
        assert src.mirror_of(2) is None and src.size == 4 << 20


# ---------------------------------------------------------------------------
# degraded striping on the python pools
# ---------------------------------------------------------------------------

@PKG
def test_failstop_serves_from_mirror_byte_identical(tmp_path, pkg):
    p = PKGS[pkg]
    for k, v in (("io_retries", 1), ("canary_interval_s", 0.0)):
        p.cfg.set(k, v)
    paths, src = _mirrored_fake(p, tmp_path, p.fake.FaultPlan(
        failstop_member=0, failstop_after=4))
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            got, total = read_all(sess, src)
            assert got == expected_mirrored_stream(paths)[:total]
            assert sess._member_health.state(0).value in ("failed",
                                                          "rejoining")
            steps = [(f, t) for _m, f, t, _ts
                     in sess._member_health.transitions(0)]
            assert ("healthy", "failed") in steps
            assert_transitions_legal(sess, "failstop")
    finally:
        src.close()
    after = p.counters()
    assert _delta(before, after, "nr_mirror_read") > 0
    assert _delta(before, after, "nr_member_failed") >= 1


@PKG
def test_canary_probes_rejoin_failed_member(tmp_path, pkg):
    import time
    p = PKGS[pkg]
    for k, v in (("io_retries", 1), ("canary_interval_s", 0.05),
                 ("quarantine_s", 0.2), ("rejoin_successes", 2),
                 ("rejoin_tokens_s", 1000.0)):
        p.cfg.set(k, v)
    paths, src = _mirrored_fake(p, tmp_path, p.fake.FaultPlan(
        failstop_member=0, failstop_after=3, rejoin_after=60))
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            got, total = read_all(sess, src)
            assert got == expected_mirrored_stream(paths)[:total]
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and \
                    sess._member_health.state(0).value != "healthy":
                time.sleep(0.05)
            assert sess._member_health.state(0).value == "healthy"
            steps = [(f, t) for _m, f, t, _ts
                     in sess._member_health.transitions(0)]
            assert ("failed", "rejoining") in steps
            assert ("rejoining", "healthy") in steps
            assert_transitions_legal(sess, "rejoin")
    finally:
        src.close()
    after = p.counters()
    assert _delta(before, after, "nr_canary_probe") > 0
    assert _delta(before, after, "nr_member_rejoin") >= 1


@PKG
@pytest.mark.parametrize("policy", ["off", "p99"])
def test_hedge_policy_against_a_slow_member(tmp_path, pkg, policy):
    """A member 150 ms slow on every read: with ``hedge_policy=p99`` the
    mirror legs win hedges (counters), with ``off`` none is issued; the
    copy is byte-identical either way."""
    p = PKGS[pkg]
    for k, v in (("io_retries", 1), ("member_queue_depth", 1),
                 ("task_deadline_s", 60.0), ("hedge_policy", policy),
                 ("hedge_ms", 5.0)):
        p.cfg.set(k, v)
    paths, src = _mirrored_fake(p, tmp_path, p.fake.FaultPlan(
        slow_member=0, slow_s=0.15), tag=policy)
    before = p.counters()
    try:
        with p.eng.Session() as sess:
            got, total = read_all(sess, src)
            assert got == expected_mirrored_stream(paths)[:total]
    finally:
        src.close()
    after = p.counters()
    if policy == "off":
        assert _delta(before, after, "nr_hedge_issued") == 0
    else:
        assert _delta(before, after, "nr_hedge_issued") > 0
        assert _delta(before, after, "nr_hedge_won") > 0


# ---------------------------------------------------------------------------
# the native lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("victim", [0, 2])
def test_native_lanes_remap_failed_member_to_mirror(tmp_path, victim):
    """With a primary FAILED before submit, the native engine reads its
    extents through the mirror partner's fd and lane; the reference's
    io_uring lanes deliver the same bytes."""
    paths = make_mirrored_members(str(tmp_path))
    for cfg in (jcfg, tcfg):
        cfg.set("cache_arbitration", False)
    out = {}
    for name, p in PKGS.items():
        before = p.counters()
        with p.eng.StripedSource(paths, stripe_chunk_size=STRIPE,
                                 mirror="paired") as src, \
                p.eng.Session() as sess:
            if sess._native is None:
                pytest.skip(f"{name}: the native engine is not active")
            sess._member_health.record_failure(victim, fatal=True)
            out[name] = read_all(sess, src)[0]
            if name == "torch":
                used = sorted(sess._members_used)
        assert _delta(before, p.counters(), "nr_mirror_read") > 0
    assert out["torch"] == out["jax"] == expected_mirrored_stream(paths)
    assert victim not in used and victim + 1 in used


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------

def test_flaky_mirrored_round_heals(tmp_path):
    assert chaos.flaky_mirrored_round(random.Random(99),
                                      str(tmp_path)) == "flaky"


@pytest.mark.parametrize("scenario", [
    chaos.scenario_fail_stop, chaos.scenario_flaky,
    chaos.scenario_slow_hedge, chaos.scenario_rejoin,
    chaos.scenario_native_degraded, chaos.scenario_write_failstop,
    chaos.scenario_write_enospc, chaos.scenario_write_torn_mirror,
    chaos.scenario_ckpt_crash, chaos.scenario_corrupt_once,
    chaos.scenario_cache_churn, chaos.scenario_scrub_heal],
    ids=lambda f: f.__name__[9:])
def test_chaos_scenario(scenario):
    tally = chaos.run_all(1234, scenarios=(scenario,), verbose=False,
                          device="cpu")
    assert sum(tally.values()) == 1 and "native_skipped" not in tally


def test_chaos_corrupt_once_matches_reference(tmp_path):
    """The same seeded torn read through both packages' scenario: the
    same page re-read, the same tag."""
    from nvme_strom_tpu.testing import chaos as jchaos
    out = {}
    for name, mod, counters, cfg in (
            ("jax", jchaos, PKGS["jax"].counters, jcfg),
            ("torch", chaos, PKGS["torch"].counters, tcfg)):
        snap = cfg.snapshot()
        before = counters()
        d = tmp_path / name
        d.mkdir()
        try:
            tag = mod.scenario_corrupt_once(random.Random(7), str(d))
        finally:
            cfg.restore(snap)
        out[name] = (tag, {k: _delta(before, counters(), k)
                           for k in ("nr_csum_fail", "nr_csum_reread")})
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["nr_csum_reread"] == 1


def test_read_scenarios_follow_the_reference_order():
    from nvme_strom_tpu.testing import chaos as jchaos
    assert [f.__name__ for f in chaos.SCENARIOS] == \
        [f.__name__ for f in jchaos.SCENARIOS]


def test_chaos_main_rejects_an_unknown_set(capsys):
    assert chaos.main(["sideways"]) == 2
    assert "usage" in capsys.readouterr().err


def test_allowed_transitions_closed_over_states():
    states = set(HealthState)
    for a, b in ALLOWED_TRANSITIONS:
        assert a in states and b in states and a is not b
