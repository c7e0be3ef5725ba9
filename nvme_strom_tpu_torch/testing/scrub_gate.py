"""The resident-integrity gate: the JAX package's
``testing/scrub_gate.py``, every leg.

* **RAM slab** — a byte flipped in a RAM-tier slab while a reader holds a
  lease on it: the scrubber detects the rot, drops the slab under its
  lease rules (the lease taken before the flip fails open and serves
  nothing), fills it again from the SSD through the fault ladder, and a
  re-read is byte-identical.
* **HBM extent** — the same for an extent in the HBM tier (a CUDA tensor
  on the card): the scrubber detects, the healed bytes are admitted
  again, and a new lease serves them byte-identical.
* **KV spill** — a KV block pool over a mirrored spill set whose primary
  legs rot on disk once paged out: the scrubber heals the rotten blocks
  from the mirror leg, writes the primary again, and its debits move the
  rotten member into QUARANTINED; every block reads back identical.
* **Pressure** — shrinking ``memlock_budget`` mid-run sheds pinned slabs
  (``nr_pressure_shed``, ``pressure_shed`` instants in the flight
  recorder) and makes later fills pass through to the SSD
  (``nr_pressure_passthrough``), with no ENOMEM for any reader.  Where
  the host refuses every mlock the leg checks that the refusals were
  counted and ran unpinned, and says so.

Usage: python -m nvme_strom_tpu_torch.testing.scrub_gate [-d DEVICE]
(default ``cuda:0``; ``-d cpu`` runs it on the host).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import weakref

CHUNK = 64 << 10

__all__ = ["main"]


def _counter(name: str) -> int:
    from ..stats import stats
    return stats.snapshot().get(name, 0)


def _await(pred, what: str, timeout_s: float = 15.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _read_pass(sess, src, nchunks: int) -> bytes:
    """The first *nchunks* chunks of *src*, in the source's order: the
    tiers' hits land after the submitted chunks, so the slots are put
    back by the result's ``chunk_ids``."""
    import numpy as np

    from ..engine import reorder_chunks
    want = list(range(nchunks))
    handle, buf = sess.alloc_dma_buffer(nchunks * CHUNK)
    try:
        res = sess.memcpy_ssd2ram(src, handle, want, CHUNK)
        sess.memcpy_wait(res.dma_task_id, timeout=60.0)
        return bytes(reorder_chunks(
            np.frombuffer(buf.view()[:nchunks * CHUNK], np.uint8), CHUNK,
            res.chunk_ids, want))
    finally:
        sess.unmap_buffer(handle)


def _arm(config, **extra) -> None:
    """The integrity domain armed for a leg."""
    config.set("integrity", "always")
    config.set("scrub_bytes_per_sec", 1 << 30)
    config.set("task_deadline_s", 30.0)
    config.set("cache_arbitration", False)
    config.set("dma_max_size", CHUNK)
    for k, v in extra.items():
        config.set(k, v)


def _leg_host_heal(dirpath: str, device) -> int:
    """RAM-slab rot under a live lease: detected, the lease fails open,
    healed from the SSD, the re-read identical.  Returns the
    detections."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from .fake import (FakeNvmeSource, expected_bytes, flip_resident_host,
                       make_test_file)

    nchunks = 8
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "host.bin")
    make_test_file(path, size)
    _arm(config, cache_bytes=64 << 20)
    residency_cache.clear()
    src = FakeNvmeSource(path, force_cached_fraction=0.0)
    fails0 = _counter("nr_integrity_fail")
    repairs0 = _counter("nr_scrub_repair")
    try:
        with Session(device=device) as sess:
            got = _read_pass(sess, src, nchunks)
            assert got == expected_bytes(0, size), "host: cold pass diverged"
            keys = residency_cache.scrub_keys()
            assert keys, "host: nothing resident to corrupt"
            key = sorted(keys, key=lambda k: k[1])[0]
            lease = residency_cache.lookup(*key)
            assert lease is not None, "host: no lease on the resident slab"
            try:
                assert flip_resident_host(key[0], key[1], key[2], pos=17), \
                    "host: the resident flip missed"
                _await(lambda: _counter("nr_scrub_repair") > repairs0,
                       "the RAM-slab scrub repair")
                # the lease taken before the flip sees the slab stale (or
                # rotted) and fails open: never the rotted bytes
                out = bytearray(key[2])
                assert lease.copy_into(out) is False, \
                    "host: a corrupt leased slab served bytes"
            finally:
                lease.release()
            got = _read_pass(sess, src, nchunks)
            assert got == expected_bytes(0, size), \
                "host: the re-read after the heal diverged"
    finally:
        src.close()
    fails = _counter("nr_integrity_fail") - fails0
    assert fails > 0, "host: the flip was never detected"
    print(f"scrub-gate host leg ok: flip detected ({fails} fail(s)), slab "
          f"healed from the SSD, the stale lease failed open, re-read "
          f"identical")
    return fails


def _leg_hbm_heal(dirpath: str, device) -> None:
    """HBM-extent rot: detected by the scrubber, healed from the SSD,
    admitted again, a new lease serves identical bytes.  *device* is a
    ``torch.device``."""
    from ..config import config
    from ..engine import Session
    from ..serving.hbm_tier import hbm_tier
    from .fake import (FakeNvmeSource, expected_bytes, flip_resident_hbm,
                       make_test_file)

    size = 4 * CHUNK
    path = os.path.join(dirpath, "hbm.bin")
    make_test_file(path, size)
    _arm(config, cache_bytes=0, hbm_cache_bytes=8 * CHUNK)
    src = FakeNvmeSource(path, force_cached_fraction=0.0)
    skey = ("#scrub-gate-hbm",)
    repairs0 = _counter("nr_scrub_repair")
    try:
        with Session(device=device):
            assert hbm_tier.admit(skey, 0, CHUNK, expected_bytes(0, CHUNK),
                                  source_ref=weakref.ref(src)), \
                "hbm: the admit was refused"
            lease = hbm_tier.lookup(skey, 0, CHUNK)
            t = lease.device_array()
            lease.release()
            assert t is not None and t.device.type == device.type, \
                f"hbm: the extent is not on {device}"
            assert flip_resident_hbm(skey, 0, CHUNK, pos=33), \
                "hbm: the resident flip missed"
            _await(lambda: _counter("nr_scrub_repair") > repairs0,
                   "the HBM-extent scrub repair")
            _await(lambda: hbm_tier.lookup(skey, 0, CHUNK) is not None,
                   "the healed extent admitted to HBM again")
            lease = hbm_tier.lookup(skey, 0, CHUNK)
            out = bytearray(CHUNK)
            try:
                assert lease.copy_into(out), "hbm: the healed lease failed"
            finally:
                lease.release()
            assert bytes(out) == expected_bytes(0, CHUNK), \
                "hbm: the healed extent diverged"
    finally:
        src.close()
        hbm_tier.clear()
    print("scrub-gate hbm leg ok: flip detected, extent healed from the "
          "SSD and admitted again, served identical")


def _leg_kv_mirror_heal(dirpath: str, device) -> None:
    """KV spill rot on the primary leg: the scrubber heals it from the
    mirror, rewrites the primary, and its debits move the member into
    QUARANTINED at ``quarantine_after=2``."""
    from ..config import config
    from ..engine import Session
    from ..fault import HealthState
    from ..serving.kvcache import KvBlockPool
    from .fake import FakeStripedNvmeSource, FaultPlan

    bbk = 16 << 10
    rows = 4
    # the scrubber starts once every block is appended: a page-out's
    # write to member 0 between two heals would reset its failure count
    _arm(config, cache_bytes=0, canary_interval_s=0.0,
         quarantine_after=2, quarantine_s=60.0, scrub_bytes_per_sec=0)
    spaths = []
    for i in range(4):
        p = os.path.join(dirpath, f"kv{i}.bin")
        with open(p, "wb") as f:
            f.truncate(rows * bbk)
        spaths.append(p)
    # every member-0 block row carries one rotten byte, flipped once the
    # covering page-out landed; the member-1 mirror leg stays clean
    plan = FaultPlan(corrupt_member_offsets={
        0: {r * bbk + 97 for r in range(rows)}})
    spill = FakeStripedNvmeSource(spaths, bbk, fault_plan=plan,
                                  force_cached_fraction=0.0,
                                  mirror="paired", writable=True)
    repairs0 = _counter("nr_scrub_repair")
    try:
        with Session(device=device) as sess:
            pool = KvBlockPool(sess, spill, block_bytes=bbk, ram_blocks=2,
                               hbm_blocks=0)
            try:
                for i in range(6):
                    pool.append("gate", _pat(i, bbk))
                config.set("scrub_bytes_per_sec", 1 << 30)
                # two of the four spilled blocks landed on the rotten
                # member: the scrubber heals both from the mirror, and
                # the second debit quarantines member 0
                _await(lambda: _counter("nr_scrub_repair") >= repairs0 + 2,
                       "two mirror heals of rotten spill blocks")
                _await(lambda: sess._member_health.state(0)
                       is HealthState.QUARANTINED,
                       "member 0 quarantined by scrub debits")
                for i in range(6):
                    assert pool.read("gate", i) == _pat(i, bbk), \
                        f"kv: block {i} diverged after the mirror heal"
            finally:
                pool.close()
    finally:
        spill.close()
    print(f"scrub-gate kv leg ok: "
          f"{_counter('nr_scrub_repair') - repairs0} spill block(s) "
          f"healed from the mirror, the rotten member quarantined, reads "
          f"identical")


def _pat(i: int, n: int) -> bytes:
    return bytes([(i * 7 + 1) % 256]) * n


def _leg_pressure(dirpath: str, device) -> str:
    """A memlock budget shrunk mid-run: shed and pass-through, no ENOMEM,
    shown by the counters and the flight recorder's instants.  Returns
    ``"ok"`` or ``"mlock refused"``."""
    from ..cache import residency_cache
    from ..config import config
    from ..engine import Session
    from ..trace import recorder, validate_chrome_trace
    from .fake import FakeNvmeSource, expected_bytes, make_test_file

    nchunks = 8
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "pressure.bin")
    make_test_file(path, size)
    _arm(config, cache_bytes=64 << 20, memlock_budget=64 << 20,
         scrub_bytes_per_sec=0, trace_policy="all")
    recorder.configure()
    recorder.clear()
    residency_cache.clear()
    residency_cache.configure()
    src = FakeNvmeSource(path, force_cached_fraction=0.0)
    shed0 = _counter("nr_pressure_shed")
    pass0 = _counter("nr_pressure_passthrough")
    try:
        with Session(device=device) as sess:
            got = _read_pass(sess, src, nchunks)
            assert got == expected_bytes(0, size), \
                "pressure: the warm pass diverged"
            if residency_cache.pinned_bytes() == 0:
                # the host refused every mlock: the budget has nothing
                # pinned to govern; the fail-open half held above
                assert _counter("nr_cache_mlock_fail") > 0
                print("scrub-gate pressure leg: mlock refused on this host "
                      "(counted, slabs unpinned); the shed and pass-through "
                      "contract needs pinned slabs and was not run")
                return "mlock refused"
            config.set("memlock_budget", CHUNK)
            residency_cache.configure()
            assert residency_cache.pinned_bytes() <= CHUNK, \
                f"pressure: {residency_cache.pinned_bytes()} bytes still " \
                f"pinned over a {CHUNK} budget"
            got = _read_pass(sess, src, nchunks)   # no exception: no ENOMEM
            assert got == expected_bytes(0, size), \
                "pressure: the pass-through read diverged"
    finally:
        src.close()
        doc = recorder.chrome_trace("scrub-gate pressure")
        config.set("trace_policy", "off")
        recorder.configure()
        recorder.clear()
    shed = _counter("nr_pressure_shed") - shed0
    passed = _counter("nr_pressure_passthrough") - pass0
    assert shed > 0, "pressure: the budget shrink shed nothing"
    assert passed > 0, "pressure: no fill passed through"
    errs = validate_chrome_trace(doc)
    assert not errs, f"pressure: the trace fails its schema check: {errs[:5]}"
    assert "pressure_shed" in {e.get("name") for e in doc["traceEvents"]}, \
        "pressure: no pressure_shed instant in the flight recorder"
    print(f"scrub-gate pressure leg ok: {shed} slab(s) shed, {passed} "
          f"fill(s) passed through, no reader ENOMEM, instants traced")
    return "ok"


def main(argv=None) -> int:
    from ..api import StromError
    from ..config import config
    from ..hbm.backend import resolve_device
    from ..integrity import domain
    from ..tiering import extent_space

    ap = argparse.ArgumentParser(prog="scrub_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="the Sessions' device and the HBM tier's (default "
                         "cuda:0; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"scrub-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    # the HBM tier places on the gate's device (a Session's device
    # never moves the process-wide tier)
    extent_space.configure(device=dev)
    try:
        with tempfile.TemporaryDirectory(prefix="strom_scrub_") as d:
            _leg_host_heal(d, dev)
            _leg_hbm_heal(d, dev)
            _leg_kv_mirror_heal(d, dev)
            _leg_pressure(d, dev)
    except AssertionError as e:
        print(f"scrub-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
        extent_space.clear_tiers()
        extent_space.configure()
        domain.configure()
    print("scrub-gate ok: rot in all three tiers detected and healed "
          "byte-identically, scrub debits quarantine the rotten member, "
          "memlock pressure passes through without ENOMEM")
    return 0


if __name__ == "__main__":
    sys.exit(main())
