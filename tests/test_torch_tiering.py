"""The unified extent space of the PyTorch port (``tiering.py``, the HBM
tier in ``serving/hbm_tier.py``) against the JAX package: the counterparts
of ``tests/test_tiering.py`` (second-touch promotion and its exclusive
migration, split mode, demand faults through a fail-stopped member's
mirror, demotion keeping the checksum, one invalidation contract over
both tiers, speculative fills), the capacity knobs' second names, a
checkpoint save's invalidation, the plan's expected hit ratios, queries
over a resident table, and the port's tier gate.

The reference's HBM tier places on the JAX CPU device, the port's on
``device="cpu"`` here.  What is compared: landed bytes, which tier served
a lookup, and the moves of the hit, fault, promote and demote counters."""

import os
import types

import numpy as np
import pytest

import nvme_strom_tpu.cache as jcache
import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.integrity as jint
import nvme_strom_tpu.testing.chaos as jchaos
import nvme_strom_tpu.testing.fake as jfake
import nvme_strom_tpu.tiering as jtier
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.stats import stats as jstats
import nvme_strom_tpu_torch.cache as tcache
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.integrity as tint
import nvme_strom_tpu_torch.testing.chaos as tchaos
import nvme_strom_tpu_torch.testing.fake as tfake
import nvme_strom_tpu_torch.tiering as ttier
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing import reset_residency, tier_gate

EXT = 64 << 10

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", eng=jeng, fake=jfake, cfg=jcfg, cache=jcache,
        tier=jtier, integ=jint, chaos=jchaos,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters)),
    "torch": types.SimpleNamespace(
        name="torch", eng=teng, fake=tfake, cfg=tcfg, cache=tcache,
        tier=ttier, integ=tint, chaos=tchaos, counters=tstats.snapshot),
}

_MOVED = ("nr_tier_hbm_promote", "nr_tier_hbm_demote", "nr_tier_ram_fault",
          "nr_tier_ram_demote", "nr_cache_hit", "nr_hbm_hit",
          "nr_cache_miss", "nr_cache_invalidate")


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    reset_residency()
    yield
    tcfg.restore(snap)
    reset_residency()


def _space_on(p, ram_exts=4, hbm_exts=4, unified=True):
    p.cfg.set("tier_ram_bytes", ram_exts * EXT)
    p.cfg.set("tier_hbm_bytes", hbm_exts * EXT)
    p.cfg.set("tier_unified", unified)
    if p.name == "torch":
        p.tier.extent_space.configure(device="cpu")
    else:
        p.tier.extent_space.configure()


def _moves(before, after, names=_MOVED):
    return {k: after.get(k, 0) - before.get(k, 0) for k in names}


def _both(fn, *args):
    out = {name: fn(p, *args) for name, p in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _read_chunks(p, sess, src, order, chunk=EXT):
    total = len(order) * chunk
    handle, buf = sess.alloc_dma_buffer(total)
    try:
        res = sess.memcpy_ssd2ram(src, handle, list(order), chunk)
        sess.memcpy_wait(res.dma_task_id, timeout=60.0)
        return bytes(p.eng.reorder_chunks(
            np.frombuffer(buf.view()[:total], np.uint8), chunk,
            res.chunk_ids, sorted(order)))
    finally:
        sess.unmap_buffer(handle)


def _lookup(p, skey, base, length=EXT):
    """``(tier name, bytes)`` of a lookup, or None on a miss."""
    hit = p.tier.extent_space.lookup(skey, base, length)
    if hit is None:
        return None
    lease, name = hit
    out = bytearray(length)
    ok = lease.copy_into(out)
    lease.release()
    return name, bytes(out) if ok else None


# -- second-touch promotion ---------------------------------------------------

def _promotion(p):
    _space_on(p)
    space = p.tier.extent_space
    skey, data = ("#tp1",), bytes([7]) * EXT
    before = p.counters()
    steps = [space.fault_fill(skey, 0, EXT, data),
             _lookup(p, skey, 0)]                    # the second touch
    moved = _moves(before, p.counters())
    hit = space.lookup(skey, 0, EXT)
    lease, name = hit
    on_device = lease.device_array() is not None
    out = bytearray(EXT)
    steps += [name, on_device, lease.copy_into(out) and bytes(out) == data]
    lease.release()
    steps += [p.cache.residency_cache.peek(skey, 0, EXT),
              space.residency()]
    return steps, moved


def test_second_touch_promotion_exclusive_migrates():
    steps, moved = _both(_promotion)
    data = bytes([7]) * EXT
    assert steps == [True, ("ram", data), "hbm", True, True, False,
                     {"ram": 0, "hbm": EXT}]
    assert moved["nr_tier_hbm_promote"] == 1


def _split(p):
    _space_on(p, unified=False)
    skey, data = ("#tp2",), bytes([9]) * EXT
    before = p.counters()
    steps = [p.tier.extent_space.fault_fill(skey, 0, EXT, data)]
    steps += [_lookup(p, skey, 0) for _ in range(3)]
    return steps, _moves(before, p.counters()), \
        p.tier.extent_space.residency()["hbm"]


def test_split_mode_never_promotes():
    steps, moved, hbm = _both(_split)
    assert steps == [True] + [("ram", bytes([9]) * EXT)] * 3
    assert moved["nr_tier_hbm_promote"] == 0 and hbm == 0


# -- demand faults through the fault ladder -----------------------------------

def _quarantined(p, dirpath):
    os.makedirs(dirpath)
    _space_on(p, ram_exts=64, hbm_exts=0)
    paths = p.chaos.make_mirrored_members(dirpath, tag="tq")
    src = p.fake.FakeStripedNvmeSource(
        paths, 64 << 10,
        fault_plan=p.fake.FaultPlan(failstop_member=0, failstop_after=0),
        force_cached_fraction=0.0, mirror="paired")
    want = p.chaos.expected_mirrored_stream(paths)
    n = src.size // EXT
    try:
        with p.eng.Session() as sess:
            before = p.counters()
            got1 = _read_chunks(p, sess, src, range(n))
            mid = p.counters()
            got2 = _read_chunks(p, sess, src, range(n))
            after = p.counters()
    finally:
        src.close()
    return (got1 == want[:n * EXT], got2 == want[:n * EXT], n,
            _moves(before, mid), _moves(mid, after))


def test_demand_fault_fills_through_quarantined_members_mirror(tmp_path):
    ok1, ok2, n, cold, warm = _both(
        lambda p: _quarantined(p, str(tmp_path / p.name)))
    assert ok1 and ok2
    assert cold["nr_tier_ram_fault"] == n
    assert warm["nr_tier_ram_fault"] == 0 and warm["nr_cache_hit"] == n


# -- demotion ----------------------------------------------------------------

def _demotion(p):
    p.cfg.set("integrity", "always")
    p.integ.domain.configure()
    _space_on(p, ram_exts=8, hbm_exts=2)
    space, ram = p.tier.extent_space, p.cache.residency_cache
    skey = ("#td1",)
    blobs = {i: bytes([i + 1]) * EXT for i in range(3)}
    before = p.counters()
    for i in range(3):
        assert space.fault_fill(skey, i * EXT, EXT, blobs[i])
        space.lookup(skey, i * EXT, EXT)[0].release()     # promote
    moved = _moves(before, p.counters())
    demoted = [i for i in range(3) if ram.peek(skey, i * EXT, EXT)]
    crcs = []
    for i in demoted:
        lease = ram.lookup(skey, i * EXT, EXT)
        crc = lease._entry.crc
        out = bytearray(EXT)
        crcs.append((crc is not None and p.integ.domain.verify(blobs[i], crc),
                     lease.copy_into(out) and bytes(out) == blobs[i]))
        lease.release()
    # fail-open: a lease taken before an invalidation reads False, never
    # stale bytes and never an exception
    i = demoted[0]
    lease = ram.lookup(skey, i * EXT, EXT)
    dropped = space.invalidate_extents(skey, [(i * EXT, EXT)])
    tail = [lease.stale, lease.copy_into(bytearray(EXT))]
    lease.release()
    return moved, demoted, crcs, dropped >= 1, tail


def test_demotion_preserves_crc_and_lease_fails_open():
    moved, demoted, crcs, dropped, tail = _both(_demotion)
    assert moved["nr_tier_hbm_promote"] == 3
    assert moved["nr_tier_hbm_demote"] >= 1
    assert demoted and all(a and b for a, b in crcs)
    assert dropped and tail == [True, False]


# -- one invalidation contract ------------------------------------------------

def _write_ladder(p, path):
    _space_on(p, ram_exts=8, hbm_exts=8)
    p.cfg.set("cache_arbitration", False)
    p.cfg.set("dma_max_size", EXT)
    space = p.tier.extent_space
    n = 4
    new0 = bytes(range(256))[::-1] * (EXT // 256)
    with p.eng.Session() as sess:
        with p.eng.open_source(path) as src:
            skey = space.source_key(src)
            first = _read_chunks(p, sess, src, range(n))       # fill RAM
            space.lookup(skey, 0, EXT)[0].release()            # promote 0
        tiers = [_lookup(p, skey, 0)[0],
                 p.cache.residency_cache.peek(skey, EXT, EXT)]
        handle, buf = sess.alloc_dma_buffer(2 * EXT)
        try:
            buf.view()[:EXT] = new0
            buf.view()[EXT:2 * EXT] = new0
            with p.eng.open_source(path, writable=True) as sink:
                res = sess.memcpy_ram2ssd(sink, handle, [0, 1], EXT)
                sess.memcpy_wait(res.dma_task_id)
                sink.sync()
        finally:
            sess.unmap_buffer(handle)
        gone = [space.lookup(skey, 0, EXT) is None,
                space.lookup(skey, EXT, EXT) is None]
        with p.eng.open_source(path) as src:
            got = _read_chunks(p, sess, src, range(n))
    return first, tiers, gone, got


def test_write_ladder_invalidates_across_tiers(tmp_path):
    out = {}
    for name, p in PKGS.items():
        path = str(tmp_path / f"{name}.bin")
        tfake.make_test_file(path, 4 * EXT)
        out[name] = _write_ladder(p, path)
    assert out["torch"] == out["jax"]
    first, tiers, gone, got = out["torch"]
    new0 = bytes(range(256))[::-1] * (EXT // 256)
    assert first == tfake.expected_bytes(0, 4 * EXT)
    assert tiers == ["hbm", True] and gone == [True, True]
    assert got[:2 * EXT] == new0 + new0
    assert got[2 * EXT:] == tfake.expected_bytes(2 * EXT, 2 * EXT)


# -- speculative fills --------------------------------------------------------

def _speculative(p):
    _space_on(p)
    space = p.tier.extent_space
    skey, data = ("#ts1",), bytes([5]) * EXT
    before = p.counters()
    steps = [space.fault_fill(skey, 0, EXT, data, speculative=True)]
    steps.append(_moves(before, p.counters()))
    steps.append(_lookup(p, skey, 0)[0])     # a first touch: stays in RAM
    steps.append(_moves(before, p.counters()))
    steps.append(space.residency()["hbm"])
    steps.append(_lookup(p, skey, 0)[0])     # the second: promotes
    steps.append(_moves(before, p.counters()))
    return steps


def test_speculative_fills_never_promote_or_count_as_faults():
    steps = _both(_speculative)
    assert steps[0] is True
    assert steps[1]["nr_tier_ram_fault"] == 0
    assert steps[2] == "ram" and steps[3]["nr_tier_hbm_promote"] == 0
    assert steps[4] == 0
    assert steps[5] == "ram" and steps[6]["nr_tier_hbm_promote"] == 1


# -- the capacity knobs' second names -----------------------------------------

@pytest.mark.parametrize("canon,alias", [("tier_ram_bytes", "cache_bytes"),
                                         ("tier_hbm_bytes", "hbm_cache_bytes")])
def test_capacity_aliases_resolve_like_the_reference(canon, alias):
    for cfg in (jcfg, tcfg):
        cfg.set(alias, 32 << 10)
        assert cfg.get(canon) == 32 << 10
        cfg.set(canon, "1m")
        assert cfg.get(alias) == 1 << 20
    assert alias not in tcfg.snapshot()
    snap = tcfg.snapshot()
    tcfg.set(alias, 0)
    tcfg.restore(snap)
    assert tcfg.get(alias) == 1 << 20
    with pytest.raises(ValueError):
        tcfg.set(alias, -1)


# -- a checkpoint save's invalidation -----------------------------------------

def _ckpt(p, dirpath, sharded):
    from nvme_strom_tpu.data import checkpoint as jck
    from nvme_strom_tpu_torch.data import checkpoint as tck
    ck = tck if p.name == "torch" else jck
    os.makedirs(dirpath)
    path = os.path.join(dirpath, "state.strom")
    tree = {"w": np.arange(4096, dtype=np.float32)}
    ck.save_checkpoint(path, tree)
    _space_on(p, ram_exts=16, hbm_exts=0)
    p.cfg.set("cache_arbitration", False)
    with p.eng.Session() as sess, p.eng.open_source(path) as src:
        n = src.size // 4096
        handle, _ = sess.alloc_dma_buffer(n * 4096)
        res = sess.memcpy_ssd2ram(src, handle, list(range(n)), 4096)
        sess.memcpy_wait(res.dma_task_id)
        sess.unmap_buffer(handle)
    space = p.tier.extent_space
    before = space.resident_fraction([path], os.path.getsize(path))["ram"]
    inval0 = p.counters().get("nr_cache_invalidate", 0)
    tree["w"] = tree["w"] + 1
    if sharded:
        ck.save_checkpoint_sharded(path, tree)
    else:
        ck.save_checkpoint(path, tree)
    after = space.resident_fraction([path], os.path.getsize(path))["ram"]
    return before, after, \
        p.counters().get("nr_cache_invalidate", 0) - inval0 > 0


@pytest.mark.parametrize("sharded", [False, True], ids=["save", "sharded"])
def test_checkpoint_save_drops_resident_extents(tmp_path, sharded):
    before, after, counted = _both(
        lambda p: _ckpt(p, str(tmp_path / p.name), sharded))
    assert before == 1.0 and after == 0.0 and counted


# -- the plan's expected hit ratios, queries over a resident table -------------

def _table(dirpath, n_pages=16):
    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
    schema = HeapSchema(n_cols=2)
    rng = np.random.default_rng(5)
    n = schema.tuples_per_page * n_pages
    path = os.path.join(dirpath, "t.heap")
    build_heap_file(path, [rng.integers(-500, 500, n, dtype=np.int32),
                           rng.integers(0, 1000, n, dtype=np.int32)],
                    schema)
    return path, n_pages


def _query(p, path):
    if p.name == "torch":
        from nvme_strom_tpu_torch.scan.heap import HeapSchema
        from nvme_strom_tpu_torch.scan.query import Query
        run = {"device": "cpu"}
    else:
        from nvme_strom_tpu.scan.heap import HeapSchema
        from nvme_strom_tpu.scan.query import Query
        run = {}
    return Query(path, HeapSchema(n_cols=2)), run


def _ratios(p, path, n_pages):
    _space_on(p, ram_exts=64, hbm_exts=64)
    p.cfg.set("cache_arbitration", False)
    space = p.tier.extent_space
    q, run = _query(p, path)
    q.aggregate([1])
    plans = [q.explain(**run)]
    with p.eng.Session() as sess, p.eng.open_source(path) as src:
        skey = space.source_key(src)
        n = n_pages * 8192 // EXT
        _read_chunks(p, sess, src, range(n))              # fill RAM
        plans.append(q.explain(**run))
        for i in range(n // 2):                           # promote half
            space.lookup(skey, i * EXT, EXT)[0].release()
        plans.append(q.explain(**run))
    return [(pl.cache_hit_ratio, pl.hbm_hit_ratio, pl.access_path)
            for pl in plans], [str(pl).count("-resident: ~") for pl in plans]


def test_plan_hit_ratios_match_reference(tmp_path):
    path, n_pages = _table(str(tmp_path))
    ratios, shown = _both(_ratios, path, n_pages)
    assert [r[:2] for r in ratios] == [(0.0, 0.0), (1.0, 0.0), (0.5, 0.5)]
    assert shown == [0, 1, 2]


def _resident_runs(p, path):
    _space_on(p, ram_exts=64, hbm_exts=64)
    for k, v in (("cache_arbitration", False), ("debug_no_threshold", True),
                 ("chunk_size", EXT)):
        p.cfg.set(k, v)
    q, run = _query(p, path)
    q.where(lambda c: c[0] > 0).aggregate([1])
    out = []
    for _ in range(3):                 # cold, RAM hits, HBM hits
        before = p.counters()
        res = q.run(**run)
        out.append((int(res["count"]), int(res["sums"][0]),
                    _moves(before, p.counters(),
                           ("nr_cache_hit", "nr_hbm_hit",
                            "nr_tier_ram_fault"))))
    return out, q.explain(**run).access_path


def test_query_over_the_resident_table_matches_reference(tmp_path):
    path, n_pages = _table(str(tmp_path))
    (cold, ram, hbm), access = _both(_resident_runs, path)
    n = n_pages * 8192 // EXT
    assert access == "direct"
    assert cold[:2] == ram[:2] == hbm[:2]
    assert cold[2]["nr_tier_ram_fault"] == n
    assert ram[2]["nr_cache_hit"] == n
    assert hbm[2]["nr_hbm_hit"] == n


# -- the port's gate (its timed leg is left to the card) ----------------------

def test_tier_gate_legs_on_the_cpu(tmp_path):
    import torch
    dev = torch.device("cpu")
    moved = tier_gate._leg_churn_identity(str(tmp_path), dev)
    assert moved["nr_tier_hbm_promote"] > 0
    tier_gate._leg_failstop_faults(str(tmp_path), dev)


def test_a_session_device_never_moves_the_hbm_tier():
    """The HBM tier is process-wide: where it places extents is its own
    setting, so a Session opened for the host (or another card) leaves a
    tier placed on ``cuda:0`` where it is, and a tier placed on the host
    stays there under a Session for ``cuda:0``."""
    import torch

    from nvme_strom_tpu_torch.serving.hbm_tier import hbm_tier
    tcfg.set("tier_hbm_bytes", 4 * EXT)
    for tier_dev, sess_dev in (("cuda:0", "cpu"), ("cpu", "cuda:0"),
                               ("cuda:0", "cuda:1")):
        ttier.extent_space.configure(device=tier_dev)
        with teng.Session(device=sess_dev):
            assert hbm_tier._device == torch.device(tier_dev)
        assert hbm_tier._device == torch.device(tier_dev)
