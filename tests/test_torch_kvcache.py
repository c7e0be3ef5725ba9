"""The port's KV block pool (``serving/kvcache.py``) against the JAX
package's, each on the same bytes: the counterparts of
``tests/test_serving.py``'s KV tests (three tiers, a mirrored member's
fail-stop, resume, spill exhaustion), ``tests/test_integrity.py``'s
(crc round trip, spill rot healed from the mirror with the member
debited, rot without a mirror, the bulk-first shed),
``tests/test_tiering.py``'s block-size alias and
``tests/test_shardload.py``'s migration tests; a hypothesis sequence of
operations on both pools with the same bytes, ``residency()`` and counter
deltas after every step; the reference faults the port does not copy
(each run on both packages); and the chaos ``scrub_heal`` scenario and
the scrub gate's KV leg.

Both packages' Sessions run the python pool (config ``io_backend``), so
nothing here waits on the JAX package's native library."""

import errno
import os
import random
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.integrity as jint
import nvme_strom_tpu.serving.kvcache as jkv
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.api import StromError as JStromError
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.fault import HealthState as JHealth
from nvme_strom_tpu.serving.hbm_tier import hbm_tier as jhbm
from nvme_strom_tpu.stats import stats as jstats
from nvme_strom_tpu.trace import recorder as jrec
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.integrity as tint
import nvme_strom_tpu_torch.serving.kvcache as tkv
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.fault import HealthState as THealth
from nvme_strom_tpu_torch.serving.hbm_tier import hbm_tier as thbm
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing import chaos, reset_residency, scrub_gate
from nvme_strom_tpu_torch.trace import recorder as trec

BB = 16 << 10            # KV block size

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", eng=jeng, fake=jfake, cfg=jcfg, kv=jkv, hbm=jhbm,
        integ=jint, rec=jrec, err=JStromError, health=JHealth,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters)),
    "torch": types.SimpleNamespace(
        name="torch", eng=teng, fake=tfake, cfg=tcfg, kv=tkv, hbm=thbm,
        integ=tint, rec=trec, err=StromError, health=THealth,
        counters=tstats.snapshot),
}
PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])

#: the counters a pool moves, compared between the packages
POOL_COUNTERS = ("nr_kv_pagein", "nr_kv_pageout", "nr_kv_migrate",
                 "nr_kv_migrate_fail", "nr_tier_ram_fault",
                 "nr_tier_hbm_promote", "nr_hbm_promote",
                 "nr_pressure_shed")


@pytest.fixture(autouse=True)
def _port_state():
    snap = tcfg.snapshot()
    reset_residency()
    for cfg in (jcfg, tcfg):
        cfg.set("io_backend", "python")
        cfg.set("retry_backoff_ms", 0.0)
    yield
    tcfg.restore(snap)
    reset_residency()
    trec.configure()
    trec.clear()


def _deltas(p, before, names=POOL_COUNTERS):
    after = p.counters()
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


def _hbm_on(p, nbytes):
    p.cfg.set("hbm_cache_bytes", nbytes)
    if p.name == "torch":
        p.hbm.configure(device="cpu")
    else:
        p.hbm.configure()


def _integrity(p, mode):
    p.cfg.set("integrity", mode)
    p.integ.domain.configure()


def _trace_all(p):
    p.cfg.set("trace_policy", "all")
    p.rec.configure()
    p.rec.clear()


def _spill_paths(d, nbytes, n=4, tag="sp"):
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        path = os.path.join(d, f"{tag}{i}.bin")
        with open(path, "wb") as f:
            f.truncate(nbytes)
        paths.append(path)
    return paths


def _striped(p, paths, **kw):
    return p.fake.FakeStripedNvmeSource(paths, BB, writable=True,
                                        force_cached_fraction=0.0, **kw)


def _pattern(s, i):
    return bytes([(s * 13 + i * 7 + 1) % 256]) * BB


def _kv(i):
    return bytes([(i * 7 + 1) % 256]) * BB


def _both(fn, tmp_path, *args):
    """*fn* on each package in a directory of its own; the results must
    be equal."""
    out = {name: fn(p, str(tmp_path / name), *args)
           for name, p in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- configuration ------------------------------------------------------------

@pytest.mark.parametrize("name,value,ok", [
    ("kv_block_bytes", 32 << 10, True), ("kv_block_bytes", 3 << 10, False),
    ("tier_kv_block_bytes", 48 << 10, False),
    ("tier_kv_block_bytes", 32 << 20, False),
    ("tier_kv_block_bytes", "16m", True), ("kv_migrate", False, True),
    ("qos_default_class", "bulk", True),
    ("qos_default_class", "latency", True),
    ("qos_default_class", "realtime", False)])
def test_kv_knobs_validate_like_the_reference(name, value, ok):
    for cfg in (jcfg, tcfg):
        if ok:
            cfg.set(name, value)
        else:
            with pytest.raises(Exception):
                cfg.set(name, value)
    if ok:
        assert tcfg.get(name) == jcfg.get(name)


def test_kv_block_bytes_alias_resolves():
    """tests/test_tiering.py::test_kv_block_bytes_alias_resolves, on both
    packages (the defaults first): the older name aliases the tier knob
    both ways."""
    names = ("tier_kv_block_bytes", "kv_block_bytes", "kv_migrate",
             "qos_default_class", "weight_stream_depth")
    assert {n: tcfg.get(n) for n in names} == {n: jcfg.get(n) for n in names}
    for cfg in (jcfg, tcfg):
        cfg.set("kv_block_bytes", 32 << 10)
        assert cfg.get("tier_kv_block_bytes") == 32 << 10
        cfg.set("tier_kv_block_bytes", 128 << 10)
        assert cfg.get("kv_block_bytes") == 128 << 10


@PKG
@pytest.mark.parametrize("kw,what", [
    ({"block_bytes": 3 << 10}, "power of two"),
    ({"ram_blocks": 1}, "2 RAM blocks"),
    ({"spill_bytes": BB // 2}, "smaller than one")])
def test_pool_refusals(pkg, kw, what, tmp_path):
    p = PKGS[pkg]
    kw = dict(kw)
    paths = _spill_paths(str(tmp_path), kw.pop("spill_bytes", 4 * BB), n=1)
    with p.eng.Session() as sess, \
            p.eng.PlainSource(paths[0], writable=True) as spill:
        with pytest.raises(p.err) as e:
            p.kv.KvBlockPool(sess, spill, **{"block_bytes": BB, **kw})
        assert e.value.errno == errno.EINVAL and what in str(e.value)
    with p.eng.Session() as sess, p.eng.PlainSource(paths[0]) as ro:
        with pytest.raises(p.err):
            p.kv.KvBlockPool(sess, ro, block_bytes=BB)


# -- tests/test_serving.py's KV tests -----------------------------------------

def _three_tiers(p, d):
    ws_blocks = 32
    _hbm_on(p, ws_blocks * BB // 4)
    paths = _spill_paths(d, ws_blocks * BB)
    before = p.counters()
    out = {}
    with p.eng.Session() as sess, \
            _striped(p, paths, mirror="paired") as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=4,
                                hbm_blocks=ws_blocks // 4)
        out["idx"] = [pool.append(f"seq{s}", _pattern(s, i))
                      for s in range(4) for i in range(8)]
        out["filled"] = pool.residency()
        out["same"] = all(pool.read(f"seq{s}", i) == _pattern(s, i)
                          for s in range(4) for i in range(8))
        out["read"] = pool.residency()
        hot = next((s, i) for s in range(4) for i in range(8)
                   if pool._tables[f"seq{s}"][i].tier == "hbm")
        pool.write(f"seq{hot[0]}", hot[1], b"\xEE" * BB)
        out["hot"] = (hot, pool.read(f"seq{hot[0]}", hot[1]) == b"\xEE" * BB)
        out["counters"] = _deltas(p, before)
        pool.close()
        with pytest.raises(p.err) as e:
            pool.read("seq0", 0)
        out["closed"] = e.value.errno
    return out


def test_kv_pool_pages_through_all_three_tiers(tmp_path):
    """test_serving.py:214 on both packages: a working set 4x the HBM
    share spills, reads page in and promote byte-identically, a write
    through an HBM block demotes and reads back fresh; the same residency
    and counters on both."""
    out = _both(_three_tiers, tmp_path)
    assert out["idx"] == [i for _ in range(4) for i in range(8)]
    assert out["filled"]["ssd"] > 0 and sum(out["filled"].values()) == 32
    assert out["same"] and out["read"]["hbm"] == 8
    assert out["hot"][1] and out["closed"] == errno.EBADF
    assert out["counters"]["nr_kv_pagein"] > 0
    assert out["counters"]["nr_kv_pageout"] > 0


def _failstop(p, d):
    ws_blocks = 32
    _hbm_on(p, ws_blocks * BB // 4)
    paths = _spill_paths(d, ws_blocks * BB)
    with p.eng.Session() as sess, \
            _striped(p, paths, mirror="paired") as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=4,
                                hbm_blocks=ws_blocks // 4)
        for s in range(4):
            for i in range(8):
                pool.append(f"seq{s}", _pattern(s, i))
        before = p.counters()
        spill.fault_plan = p.fake.FaultPlan(failstop_member=0,
                                            failstop_after=0)
        try:
            same = all(pool.read(f"seq{s}", i) == _pattern(s, i)
                       for s in range(4) for i in range(8))
        finally:
            spill.fault_plan = p.fake.FaultPlan()
        res = pool.residency()
        pagein = _deltas(p, before)["nr_kv_pagein"]
        pool.close()
    return same, res, pagein


def test_kv_pool_failstop_member_heals_via_mirror(tmp_path):
    """test_serving.py:253: a spill member fail-stops; page-ins are
    served from its mirror byte-identically on both packages."""
    same, res, pagein = _both(_failstop, tmp_path)
    assert same and pagein > 0 and res["hbm"] == 8


def _resume(p, d):
    _hbm_on(p, 0)
    paths = _spill_paths(d, 16 * BB, n=2)
    _trace_all(p)
    with p.eng.Session() as sess, _striped(p, paths) as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=4,
                                hbm_blocks=0)
        for s in range(2):
            for i in range(8):
                pool.append(f"seq{s}", _pattern(s, i))
        spilled = all(b.tier == "ssd" for b in pool._tables["seq0"])
        n = pool.resume("seq0")
        spans = [e for e in p.rec.snapshot_events()
                 if e[2] == "kv_page" and (e[8] or {}).get("resume")]
        same = all(pool.read("seq0", i) == _pattern(0, i) for i in range(8))
        pool.release("seq0")
        gone = "seq0" not in pool.sequences()
        res = pool.residency()
        pool.close()
    return spilled, n, len(spans), same, gone, res


def test_kv_pool_resume_prefetches_async(tmp_path):
    """test_serving.py:282: a fully spilled sequence resumes with one
    submit a block (a ``kv_page`` span with ``resume`` each), reads back,
    and releases."""
    spilled, n, spans, same, gone, _res = _both(_resume, tmp_path)
    assert spilled and n > 0 and spans == n and same and gone


@PKG
def test_kv_pool_spill_exhaustion_is_enospc(pkg, tmp_path):
    """test_serving.py:313."""
    p = PKGS[pkg]
    _hbm_on(p, 0)
    paths = _spill_paths(str(tmp_path), 4 * BB, n=2)   # 8 SSD slots
    with p.eng.Session() as sess, _striped(p, paths) as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=0)
        with pytest.raises(p.err) as e:
            for i in range(16):
                pool.append("big", _pattern(0, i))
        assert e.value.errno == errno.ENOSPC
        pool.close()


# -- tests/test_integrity.py's KV tests ---------------------------------------

def _crc_roundtrip(p, d):
    _integrity(p, "always")
    paths = _spill_paths(d, 4 * BB)
    before = p.counters()
    with p.eng.Session() as sess, \
            _striped(p, paths, mirror="paired") as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=0)
        for i in range(6):
            pool.append("seq", _kv(i))
        same = all(pool.read("seq", i) == _kv(i) for i in range(6))
        pool.close()
    d = _deltas(p, before, ("nr_integrity_verify", "nr_integrity_fail"))
    return same, d["nr_integrity_verify"] > 0, d["nr_integrity_fail"]


def test_kv_pageout_pagein_crc_roundtrip(tmp_path):
    """test_integrity.py:202: every page-out and page-in checks the block
    crc; a clean spill round-trips with no failure."""
    assert _both(_crc_roundtrip, tmp_path) == (True, True, 0)


def _rot_healed(p, d):
    _integrity(p, "always")
    for k, v in (("canary_interval_s", 0.0), ("quarantine_after", 1),
                 ("quarantine_s", 60.0)):
        p.cfg.set(k, v)
    rows = 4
    paths = _spill_paths(d, rows * BB)
    plan = p.fake.FaultPlan(corrupt_member_offsets={
        0: {r * BB + 41 for r in range(rows)}})
    before = p.counters()
    with p.eng.Session() as sess, \
            _striped(p, paths, mirror="paired", fault_plan=plan) as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=0)
        for i in range(6):
            pool.append("seq", _kv(i))
        same = all(pool.read("seq", i) == _kv(i) for i in range(6))
        state = sess._member_health.state(0).name
        pool.close()
    return same, state, _deltas(p, before, ("nr_scrub_repair",))


def test_kv_spill_rot_healed_from_mirror_with_member_debit(tmp_path):
    """test_integrity.py:229: a rotten primary leg heals from the mirror
    at page-in, the member debited into QUARANTINED, the same repairs on
    both packages."""
    same, state, d = _both(_rot_healed, tmp_path)
    assert same and state == "QUARANTINED" and d["nr_scrub_repair"] > 0


@PKG
def test_kv_spill_rot_without_mirror_raises_ebadmsg(pkg, tmp_path):
    """test_integrity.py:263."""
    p = PKGS[pkg]
    _integrity(p, "always")
    rows = 4
    paths = _spill_paths(str(tmp_path), rows * BB)
    plan = p.fake.FaultPlan(corrupt_member_offsets={
        m: {r * BB + 13 for r in range(rows)} for m in range(4)})
    before = p.counters()
    with p.eng.Session() as sess, _striped(p, paths, fault_plan=plan) \
            as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=0)
        for i in range(6):
            pool.append("seq", _kv(i))
        spilled = next(i for i, b in enumerate(pool._tables["seq"])
                       if b.tier == "ssd")
        with pytest.raises(p.err) as e:
            pool.read("seq", spilled)
        assert e.value.errno == errno.EBADMSG
        pool.close()
    assert _deltas(p, before, ("nr_scrub_fail",))["nr_scrub_fail"] > 0


def _shed_order(p, d):
    _integrity(p, "transitions")
    paths = _spill_paths(d, 4 * BB)
    with p.eng.Session() as sess, \
            _striped(p, paths, mirror="paired") as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=4,
                                hbm_blocks=0)
        for i in range(2):
            pool.append("lat", _kv(i), qos_class="latency")
        for i in range(2):
            pool.append("blk", _kv(i + 2), qos_class="bulk")
        before = p.counters()
        shed = pool.shed(BB)
        tiers = {s: [b.tier for b in pool._tables[s]] for s in ("lat", "blk")}
        d = _deltas(p, before)
        same = all(pool.read("blk", i) == _kv(i + 2) for i in range(2))
        pool.close()
    return shed, tiers, d, same


def test_pressure_shed_orders_bulk_before_latency(tmp_path):
    """test_integrity.py:380: bulk sequences shed before latency ones,
    the same blocks on both packages, and the shed blocks read back."""
    shed, tiers, d, same = _both(_shed_order, tmp_path)
    assert shed >= BB and "ssd" in tiers["blk"]
    assert "ssd" not in tiers["lat"]
    assert d["nr_pressure_shed"] > 0 and same


@PKG
def test_pool_registers_with_the_pressure_registry(pkg, tmp_path):
    """The pool joins the integrity domain's registry at construction:
    ``request_shed`` reaches it, and the scrubber's entry point walks its
    spill blocks."""
    p = PKGS[pkg]
    _integrity(p, "transitions")
    paths = _spill_paths(str(tmp_path), 4 * BB, n=2)
    with p.eng.Session() as sess, _striped(p, paths) as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=0)
        assert pool in p.integ.pools()
        for i in range(3):
            pool.append("s", _kv(i))
        assert p.integ.request_shed(BB) >= BB
        scanned, debits = pool.scrub_spill(1 << 20)
        assert scanned == pool.residency()["ssd"] * BB and debits == []
        pool.close()
        assert pool.shed(BB) == 0 and pool.scrub_spill(BB) == (0, [])


# -- tests/test_shardload.py's migration tests --------------------------------

def _mk_pool(p, session, d, name, blocks=32, bb=4096):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.spill")
    with open(path, "wb") as f:
        f.write(b"\0" * bb * blocks)
    src = p.eng.PlainSource(path, writable=True)
    return p.kv.KvBlockPool(session, src, block_bytes=bb, ram_blocks=4), src


def _migrate(p, d):
    rng = np.random.default_rng(23)
    bb = 4096
    blobs = [rng.integers(0, 256, bb, dtype=np.uint8).tobytes()
             for _ in range(8)]
    _trace_all(p)
    out = {}
    with p.eng.Session() as s1, p.eng.Session() as s2:
        hot, src_a = _mk_pool(p, s1, d, "hot", bb=bb)
        cold, src_b = _mk_pool(p, s2, d, "cold", bb=bb)
        try:
            for x in blobs:
                hot.append("chain", x, qos_class="bulk")
            out["spilled"] = hot.residency()["ssd"]
            real_append = cold.append
            fails = {"left": 3}

            def dying_append(seq, data, qos_class=None):
                if fails["left"] == 0:
                    raise OSError("peer host fail-stopped mid-migration")
                fails["left"] -= 1
                return real_append(seq, data, qos_class=qos_class)

            cold.append = dying_append
            before = p.counters()
            with pytest.raises(OSError):
                hot.migrate("chain", cold)
            cold.append = real_append
            out["fail"] = _deltas(p, before)["nr_kv_migrate_fail"]
            out["after_fail"] = (cold.blocks("chain"), hot.blocks("chain"))
            hot.shed(1 << 30, reason="test")
            out["shed_ram"] = hot.residency()["ram"]
            out["resumed"] = hot.resume("chain")
            out["same"] = [hot.read("chain", i) for i in range(8)] == blobs
            before = p.counters()
            out["moved"] = hot.migrate("chain", cold)
            out["ok"] = _deltas(p, before)["nr_kv_migrate"]
            out["left"] = hot.blocks("chain")
            out["peer"] = [cold.read("chain", i) for i in range(8)] == blobs
            out["class"] = cold._classes["chain"]
            spans = [e for e in p.rec.snapshot_events()
                     if e[2] == "kv_migrate"]
            out["span"] = spans[-1][8]["blocks"] if spans else None
        finally:
            hot.close()
            cold.close()
            src_a.close()
            src_b.close()
    return out


def test_kv_migrate_byte_identity_and_failed_host_resume(tmp_path):
    """test_shardload.py:206: a peer failing mid-migration rolls back
    (counted), the source chain survives a full shed and an SSD resume,
    and a clean migration moves every byte with its QoS class."""
    out = _both(_migrate, tmp_path)
    assert out["spilled"] > 0 and out["fail"] == 1
    assert out["after_fail"] == (0, 8) and out["shed_ram"] == 0
    assert out["resumed"] > 0 and out["same"]
    assert out["moved"] == 8 * 4096 and out["ok"] == 1
    assert out["left"] == 0 and out["peer"] and out["class"] == "bulk"
    assert out["span"] == 8


def _migrate_gate(p, d):
    rng = np.random.default_rng(29)
    bb = 4096
    out = {}
    with p.eng.Session() as s1, p.eng.Session() as s2:
        hot, src_a = _mk_pool(p, s1, d, "hot2", bb=bb)
        cold, src_b = _mk_pool(p, s2, d, "cold2", bb=bb)
        try:
            for seq, qos in (("bulk0", "bulk"), ("lat0", "latency")):
                for _ in range(2):
                    hot.append(seq, rng.integers(0, 256, bb,
                                                 dtype=np.uint8).tobytes(),
                               qos_class=qos)
            p.cfg.set("kv_migrate", False)
            with pytest.raises(p.err) as ei:
                hot.migrate("bulk0", cold)
            out["gate"] = ei.value.errno
            p.cfg.set("kv_migrate", True)
            with pytest.raises(p.err) as ei:
                hot.migrate("bulk0", hot)
            out["self"] = ei.value.errno
            with pytest.raises(p.err) as ei:
                hot.migrate("nope", cold)
            out["missing"] = ei.value.errno
            out["shed"] = hot.shed_to_peer(cold, bb)
            out["blocks"] = (cold.blocks("bulk0"), hot.blocks("lat0"),
                             cold.blocks("lat0"))
        finally:
            hot.close()
            cold.close()
            src_a.close()
            src_b.close()
    return out


def test_kv_migrate_config_gate_and_shed_to_peer(tmp_path):
    """test_shardload.py:267: ``kv_migrate`` off is EOPNOTSUPP; a shed to
    a peer moves the bulk chain and keeps the latency one local."""
    out = _both(_migrate_gate, tmp_path)
    assert out["gate"] == errno.EOPNOTSUPP and out["self"] == errno.EINVAL
    assert out["missing"] == errno.ENOENT
    assert out["shed"] == 2 * 4096 and out["blocks"] == (2, 2, 0)


# -- the tiers' device face ---------------------------------------------------

def test_device_array_is_the_hbm_tiers_tensor(tmp_path):
    """``device_array`` hands out the HBM tier's uint8 tensor of the
    block (the JAX package's device array on the same bytes), and None
    with the tier off."""
    import torch

    got = {}
    for name, p in PKGS.items():
        _hbm_on(p, 8 * BB)
        paths = _spill_paths(str(tmp_path / name), 8 * BB, n=2)
        with p.eng.Session() as sess, _striped(p, paths) as spill:
            pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB,
                                    ram_blocks=2, hbm_blocks=2)
            for i in range(4):
                pool.append("s", _pattern(1, i))
            arrs = [pool.device_array("s", i) for i in range(4)]
            got[name] = ([None if a is None else bytes(np.asarray(a))
                          for a in arrs], pool.residency())
            if name == "torch":
                assert all(isinstance(a, torch.Tensor) for a in arrs[:2])
            pool.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][0][:2] == [_pattern(1, 0), _pattern(1, 1)]
    assert got["torch"][0][2:] == [None, None]


# -- the reference's faults, not copied ---------------------------------------

def _stale_slot(pool):
    """Leave the RAM slot the next demotion takes holding other bytes: a
    block appended into it and released."""
    pool.append("t", _pattern(9, 9))
    pool.release("t")


def _revoked_read(p, d):
    _hbm_on(p, 8 * BB)
    paths = _spill_paths(d, 8 * BB, n=2)
    out = {}
    with p.eng.Session() as sess, _striped(p, paths) as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=2)
        for i in range(3):
            pool.append("s", _pattern(2, i))
        assert pool.read("s", 0) == _pattern(2, 0)    # promoted
        assert pool._tables["s"][0].tier == "hbm"
        _stale_slot(pool)
        p.hbm.clear()               # a revocation: the leased extent is stale
        with pytest.raises(p.err) as e:
            pool.read("s", 0)
        out["first"] = e.value.errno
        try:
            again = pool.read("s", 0)
            out["second"] = "same" if again == _pattern(2, 0) else "stale"
        except p.err as e2:
            out["second"] = e2.errno
        pool.write("s", 0, _pattern(3, 0))
        out["rewritten"] = pool.read("s", 0) == _pattern(3, 0)
        out["residency"] = pool.residency()
        pool.close()
    return out


def test_lost_block_after_revocation_raises_eio_again(tmp_path):
    """A block whose HBM copy is revoked has no other home: both
    packages raise EIO at the read that finds it.  The reference then
    serves a stale RAM slot at the next read (ROADMAP Queue C, †); the
    port raises EIO again until the block is written, and a write makes
    it whole in both."""
    out = {name: _revoked_read(p, str(tmp_path / name))
           for name, p in PKGS.items()}
    assert out["jax"]["first"] == out["torch"]["first"] == errno.EIO
    assert out["jax"]["second"] == "stale"
    assert out["torch"]["second"] == errno.EIO
    assert out["jax"]["rewritten"] and out["torch"]["rewritten"]
    assert out["jax"]["residency"] == out["torch"]["residency"]


def _revoked_shed(p, d):
    _hbm_on(p, 8 * BB)
    paths = _spill_paths(d, 8 * BB, n=2)
    with p.eng.Session() as sess, _striped(p, paths) as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=2)
        pool.append("s", _pattern(4, 0), qos_class="bulk")
        pool.read("s", 0)
        _stale_slot(pool)
        p.hbm.clear()
        shed = pool.shed(BB)
        try:
            got = "same" if pool.read("s", 0) == _pattern(4, 0) else "stale"
        except p.err as e:
            got = e.errno
        pool.close()
    return shed, got


def test_revoked_block_shed_is_not_served_stale(tmp_path):
    """A shed that meets a revoked HBM block sheds nothing (both); the
    reference then serves that block's stale RAM slot without an error
    (ROADMAP Queue C, †), the port raises EIO."""
    out = {name: _revoked_shed(p, str(tmp_path / name))
           for name, p in PKGS.items()}
    assert out["jax"] == (0, "stale")
    assert out["torch"] == (0, errno.EIO)


def _shed_from_hbm(p, d):
    _hbm_on(p, 8 * BB)
    paths = _spill_paths(d, 16 * BB, n=2)
    with p.eng.Session() as sess, _striped(p, paths) as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=1)
        pool.append("bulk", _pattern(5, 0), qos_class="bulk")
        pool.read("bulk", 0)                       # promoted to HBM
        for i in range(2):                         # RAM full of latency
            pool.append("lat", _pattern(6, i), qos_class="latency")
        before = p.counters()
        shed = pool.shed(BB)
        tiers = {s: [b.tier for b in pool._tables[s]]
                 for s in ("bulk", "lat")}
        d = _deltas(p, before)
        same = (pool.read("bulk", 0) == _pattern(5, 0)
                and all(pool.read("lat", i) == _pattern(6, i)
                        for i in range(2)))
        pool.close()
    return shed, tiers, d["nr_kv_pageout"], same


def test_shed_of_an_hbm_block_keeps_latency_blocks_resident(tmp_path):
    """Shedding one bulk block that sits in HBM while RAM is full: the
    reference's demotion pages out the LRU RAM block, a latency one, and
    counts one shed for two page-outs (ROADMAP Queue C, †); the port's
    transit slot sheds the bulk block alone.  Every byte reads back on
    both."""
    out = {name: _shed_from_hbm(p, str(tmp_path / name))
           for name, p in PKGS.items()}
    assert out["jax"][0] == out["torch"][0] == BB
    assert out["jax"][1] == {"bulk": ["ssd"], "lat": ["ssd", "ram"]}
    assert out["jax"][2] == 2
    assert out["torch"][1] == {"bulk": ["ssd"], "lat": ["ram", "ram"]}
    assert out["torch"][2] == 1
    assert out["jax"][3] and out["torch"][3]


def _failed_pagein(p, d, op):
    paths = _spill_paths(d, 8 * BB, n=2)
    with p.eng.Session() as sess, _striped(p, paths) as spill:
        pool = p.kv.KvBlockPool(sess, spill, block_bytes=BB, ram_blocks=2,
                                hbm_blocks=0)
        for i in range(2):
            pool.append("s", _pattern(7, i))
        for i in range(2):          # "s" spilled: block 1 on member 0
            pool.append("o", _pattern(8, i))
        assert [spill.extents(b.slot * BB, BB)[0].member
                for b in pool._tables["s"]] == [1, 0]
        spill.fault_plan = p.fake.FaultPlan(failstop_member=0,
                                            failstop_after=0)
        with pytest.raises(p.err) as e:
            pool.read("s", 1) if op == "read" else pool.resume("s")
        spill.fault_plan = p.fake.FaultPlan()
        slots = len(pool._ram_free) + sum(
            1 for b in pool._lru.values() if b.tier == "ram")
        pool.close()
    return e.value.errno, slots


@pytest.mark.parametrize("op", ["read", "resume"])
def test_failed_pagein_gives_its_ram_slots_back(op, tmp_path):
    """A page-in or a resume whose read fails (an unmirrored member
    fail-stopped) raises EIO on both packages; the reference keeps the
    RAM slot the read took, so its RAM tier shrinks for good (ROADMAP
    Queue C, †), while the port's still holds all of its slots."""
    out = {name: _failed_pagein(p, str(tmp_path / name), op)
           for name, p in PKGS.items()}
    assert out["jax"][0] == out["torch"][0] == errno.EIO
    assert out["torch"][1] == 2
    assert out["jax"][1] < 2


# -- a hypothesis sequence on both pools --------------------------------------

_TRANSIT = -7


class _JaxShedCorrected(jkv.KvBlockPool):
    """The reference pool with the shed fault the port does not copy
    corrected as the port corrects it: with RAM full, a shed's HBM block
    moves to the SSD through a transit buffer of its own, displacing no
    RAM block.  Everything else is the reference's own code."""

    def __init__(self, session, spill, **kw):
        super().__init__(session, spill, **kw)
        self._t_handle, self._t_dma = session.alloc_dma_buffer(
            self.block_bytes)
        self._in_shed = False

    def shed(self, nbytes, *, reason="memlock"):
        self._in_shed = True
        try:
            return super().shed(nbytes, reason=reason)
        finally:
            self._in_shed = False

    def _demote_hbm(self, blk):
        if not self._in_shed or self._ram_free:
            return super()._demote_hbm(blk)
        if not self._ssd_free:
            raise JStromError(errno.ENOSPC, "KV spill extent full")
        view = self._t_dma.view()[:self.block_bytes]
        assert blk.lease.copy_into(view)
        if jint.domain.active:
            jint.domain.verify(view, blk.crc)
        self._drop_hbm(blk)
        blk.tier, blk.slot = "ram", _TRANSIT

    def _page_out(self, blk):
        if blk.slot != _TRANSIT:
            return super()._page_out(blk)
        if jint.domain.active:
            jint.domain.verify(self._t_dma.view()[:self.block_bytes],
                               blk.crc)
        ssd_slot = self._ssd_free.pop()
        res = self._session.memcpy_ram2ssd(self._spill, self._t_handle,
                                           [ssd_slot], self.block_bytes)
        self._session.memcpy_wait(res.dma_task_id)
        self._lru.pop(blk.gid, None)
        blk.tier, blk.slot = "ssd", ssd_slot
        jstats.add("nr_kv_pageout")


_SEQS = ("a", "b", "c")
_CLASSES = ("bulk", "normal", "latency")
_OPS = st.lists(st.tuples(
    st.sampled_from(("append", "append", "read", "read", "write",
                     "resume", "release", "shed")),
    st.integers(0, 2), st.integers(0, 7), st.integers(0, 255)),
    min_size=4, max_size=24)


def _placement(pool):
    """Block for block: each block's tier and slot, and the LRU order."""
    return ({(seq, b.idx): (b.tier, b.slot if b.tier != "hbm" else None)
             for seq, table in pool._tables.items() for b in table},
            [(b.seq, b.idx) for b in pool._lru.values()],
            list(pool._ram_free), list(pool._ssd_free))


def _apply(pool, op, s, i, v):
    seq = _SEQS[s]
    n = pool.blocks(seq)
    if op == "append":
        return pool.append(seq, bytes([v]) * (BB - 8 * i),
                           qos_class=_CLASSES[s] if i % 3 == 0 else None)
    if op == "read":
        return pool.read(seq, i % n) if n else None
    if op == "write":
        return pool.write(seq, i % n, bytes([v]) * BB) if n else None
    if op == "resume":
        return pool.resume(seq)
    if op == "release":
        return pool.release(seq)
    return pool.shed((i % 4 + 1) * BB)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(ops=_OPS, mode=st.sampled_from(("off", "transitions")),
       hbm=st.sampled_from((0, 2, 3)))
def test_random_sequences_agree_with_the_reference(tmp_path, ops, mode, hbm):
    """Random append / read / write / resume / release / shed sequences on
    a port pool and a reference pool (its shed fault corrected, as the
    port does) over the same bytes: the same result or errno, the same
    ``residency()``, the same counter deltas, and the same placement block
    for block (tier, slot, LRU order, free slots) after every operation."""
    d = tmp_path / f"h{random.getrandbits(48):x}"
    pools, srcs, sessions = {}, [], []
    try:
        for name, p in PKGS.items():
            _integrity(p, mode)
            _hbm_on(p, 8 * BB)
            paths = _spill_paths(str(d / name), 8 * BB, n=2)
            sess = p.eng.Session()
            sessions.append(sess)
            spill = _striped(p, paths)
            srcs.append(spill)
            cls = _JaxShedCorrected if name == "jax" else p.kv.KvBlockPool
            pools[name] = cls(sess, spill, block_bytes=BB, ram_blocks=3,
                              hbm_blocks=hbm)
        for step, (op, s, i, v) in enumerate(ops):
            got = {}
            for name, p in PKGS.items():
                before = p.counters()
                try:
                    r = ("ok", _apply(pools[name], op, s, i, v))
                except (JStromError, StromError) as e:
                    r = ("err", e.errno)
                got[name] = (r, pools[name].residency(), _deltas(p, before),
                             _placement(pools[name]))
            assert got["torch"] == got["jax"], (step, op, s, i, v)
        for name in PKGS:
            pools[name].close()
    finally:
        for src in srcs:
            src.close()
        for sess in sessions:
            sess.close()
        for p in PKGS.values():
            _hbm_on(p, 0)


# -- the chaos scenario and the scrub gate ------------------------------------

def test_chaos_scrub_heal_runs_its_kv_phase(tmp_path):
    """The chaos ``scrub_heal`` scenario with its phase B: spill rot
    healed from the mirror at page-in, the rotten member QUARANTINED."""
    before = tstats.snapshot()
    assert chaos.scenario_scrub_heal(random.Random(1234), str(tmp_path),
                                     device="cpu") == "scrub_heal"
    after = tstats.snapshot()
    assert after.get("nr_kv_pagein", 0) > before.get("nr_kv_pagein", 0)


def test_scrub_gate_kv_leg_on_the_cpu(tmp_path):
    """The scrub gate's KV leg: the scrubber heals two rotten spill blocks
    from the mirror and its debits quarantine the member."""
    import torch

    scrub_gate._leg_kv_mirror_heal(str(tmp_path), torch.device("cpu"))


def test_scrub_gate_kv_leg_beside_another_session(tmp_path):
    """The KV leg with a second live Session in the process: that
    Session's scrubber must leave the pool alone (its debits would land on
    its own members), so the pool's Session still heals both rotten
    blocks and quarantines its member 0."""
    import torch

    other = teng.Session(device="cpu")
    try:
        scrub_gate._leg_kv_mirror_heal(str(tmp_path), torch.device("cpu"))
    finally:
        other.close()
