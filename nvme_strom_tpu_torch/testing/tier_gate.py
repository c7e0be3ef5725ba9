"""The unified-tiering gate: the JAX package's ``testing/tier_gate.py``.

Holds the unified extent space's contracts on seeded synthetics:

* **Unified beats split on the thrash set** — a seeded shuffled scan over
  a working set of about 0.8x the combined capacity (RAM + HBM) with a
  per-chunk latency injected.  Unified (``tier_unified`` on) pools both
  tiers: second-touch promotion moves hot extents into HBM and gives the
  RAM copy up, so the set fits and the steady passes stop paying the
  latency.  Split (``tier_unified`` off) strands HBM (no promotion,
  demotions drop), the set thrashes the RAM tier alone and every pass
  pays.  The split/unified time ratio must be at least
  ``STROM_TIER_GATE_RATIO`` (default 1.3x).
* **Byte identity under migration churn** — capacities far below the set
  keep promotion, demotion and eviction running; every pass stays
  byte-identical to the pattern.
* **Fail-stop demand faults** — a mirrored stripe set loses a member from
  the first read; demand faults fill the tiers through the surviving
  mirror and the bytes stay identical.

The HBM tier places its extents on the gate's device (default ``cuda:0``:
CUDA tensors); ``-d cpu`` runs it on the host.

Usage: python -m nvme_strom_tpu_torch.testing.tier_gate [-d DEVICE]
"""

from __future__ import annotations

import argparse
import os
import random
import statistics
import sys
import tempfile
import time

RATIO_LIMIT = float(os.environ.get("STROM_TIER_GATE_RATIO", "1.3"))
PASSES = int(os.environ.get("STROM_TIER_GATE_PASSES", "3"))

CHUNK = 64 << 10

__all__ = ["main", "RATIO_LIMIT"]


def _arm(config, *, ram_chunks: int, hbm_chunks: int, unified: bool) -> None:
    """One tier geometry; the Session's construction reads it and re-arms
    the moves between tiers."""
    config.set("tier_ram_bytes", ram_chunks * CHUNK)
    config.set("tier_hbm_bytes", hbm_chunks * CHUNK)
    config.set("tier_unified", unified)
    config.set("cache_arbitration", False)
    config.set("dma_max_size", CHUNK)   # one tier decision a chunk


def _shuffled_pass(sess, src, order) -> bytes:
    """Read the set in one shuffled order; the bytes back in order."""
    import numpy as np

    from ..engine import reorder_chunks
    total = len(order) * CHUNK
    handle, buf = sess.alloc_dma_buffer(total)
    try:
        res = sess.memcpy_ssd2ram(src, handle, list(order), CHUNK)
        sess.memcpy_wait(res.dma_task_id, timeout=120.0)
        host = reorder_chunks(np.frombuffer(buf.view()[:total], np.uint8),
                              CHUNK, res.chunk_ids, sorted(order))
        return bytes(host)
    finally:
        sess.unmap_buffer(handle)


def _timed_leg(dirpath: str, tag: str, device, *, unified: bool,
               orders) -> float:
    """Median steady-pass time of one mode over the thrash set."""
    from ..config import config
    from ..engine import Session
    from ..tiering import extent_space
    from .fake import FakeNvmeSource, FaultPlan, expected_bytes, \
        make_test_file

    nchunks, lat = 13, 0.002           # ~0.8 x (8 + 8) chunks of capacity
    size = nchunks * CHUNK
    path = os.path.join(dirpath, f"thrash-{tag}.bin")
    make_test_file(path, size)
    _arm(config, ram_chunks=8, hbm_chunks=8, unified=unified)
    src = FakeNvmeSource(path, fault_plan=FaultPlan(latency_s=lat),
                         force_cached_fraction=0.0)
    times = []
    try:
        with Session(device=device) as sess:
            for order in orders[:2]:   # warm the hierarchy
                _shuffled_pass(sess, src, order)
            for order in orders[2:]:
                t0 = time.perf_counter()
                got = _shuffled_pass(sess, src, order)
                times.append(time.perf_counter() - t0)
                assert got == expected_bytes(0, size), \
                    f"{tag} leg bytes diverged"
    finally:
        src.close()
        extent_space.clear_tiers()
    return statistics.median(times)


def _leg_thrash_ab(dirpath: str, device) -> float:
    """Unified >= RATIO_LIMIT x split on the same seeded visit orders;
    returns the ratio."""
    rng = random.Random(17)
    orders = []
    for _ in range(2 + PASSES):
        order = list(range(13))
        rng.shuffle(order)
        orders.append(order)
    unified_t = _timed_leg(dirpath, "unified", device, unified=True,
                           orders=orders)
    split_t = _timed_leg(dirpath, "split", device, unified=False,
                         orders=orders)
    ratio = split_t / unified_t if unified_t > 0 else float("inf")
    assert ratio >= RATIO_LIMIT, \
        f"unified only {ratio:.2f}x split (limit {RATIO_LIMIT}x; split " \
        f"{split_t * 1e3:.1f} ms, unified {unified_t * 1e3:.1f} ms)"
    print(f"tier-gate thrash leg ok: unified {ratio:.1f}x split (split "
          f"{split_t * 1e3:.1f} ms, unified {unified_t * 1e3:.1f} ms, "
          f"median of {PASSES} steady passes)")
    return ratio


def _leg_churn_identity(dirpath: str, device) -> dict:
    """Capacities far below the set: promotion, demotion and eviction
    all churn, the bytes identical every pass.  Returns the counters'
    moves."""
    from ..config import config
    from ..engine import Session
    from ..stats import stats
    from ..tiering import extent_space
    from .fake import FakeNvmeSource, expected_bytes, make_test_file

    nchunks = 13
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "churn.bin")
    make_test_file(path, size)
    _arm(config, ram_chunks=4, hbm_chunks=4, unified=True)
    src = FakeNvmeSource(path, force_cached_fraction=0.0)
    rng = random.Random(23)
    before = stats.snapshot()
    try:
        with Session(device=device) as sess:
            for r in range(4):
                order = list(range(nchunks))
                rng.shuffle(order)
                got = _shuffled_pass(sess, src, order)
                assert got == expected_bytes(0, size), \
                    f"bytes diverged under migration churn (pass {r})"
    finally:
        src.close()
        extent_space.clear_tiers()
    after = stats.snapshot()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("nr_tier_hbm_promote", "nr_tier_hbm_demote",
                       "nr_tier_ram_demote", "nr_tier_ram_fault")}
    assert moved["nr_tier_hbm_promote"] > 0, \
        "the churn leg never promoted (hook not armed?)"
    assert moved["nr_tier_hbm_demote"] + moved["nr_tier_ram_demote"] > 0, \
        "the churn leg never demoted (capacity not binding?)"
    assert moved["nr_tier_ram_fault"] > 0, \
        "the churn leg never demand-faulted"
    print(f"tier-gate churn leg ok: {moved['nr_tier_hbm_promote']} "
          f"promotions, {moved['nr_tier_hbm_demote']} HBM and "
          f"{moved['nr_tier_ram_demote']} RAM demotions, "
          f"{moved['nr_tier_ram_fault']} faults, bytes identical")
    return moved


def _leg_failstop_faults(dirpath: str, device) -> None:
    """A member fail-stops from the first read: demand faults fill
    through the surviving mirror, the tiers stay byte-identical."""
    from ..config import config
    from ..engine import Session
    from ..tiering import extent_space
    from .chaos import (STRIPE, expected_mirrored_stream,
                        make_mirrored_members, read_all)
    from .fake import FakeStripedNvmeSource, FaultPlan

    _arm(config, ram_chunks=8, hbm_chunks=8, unified=True)
    paths = make_mirrored_members(dirpath, tag="tg")
    plan = FaultPlan(failstop_member=0, failstop_after=0)
    src = FakeStripedNvmeSource(paths, stripe_chunk_size=STRIPE,
                                fault_plan=plan, force_cached_fraction=0.0,
                                mirror="paired")
    want = expected_mirrored_stream(paths)
    try:
        with Session(device=device) as sess:
            got, total = read_all(sess, src)
            assert got == want[:total], \
                "fail-stop leg: the degraded cold read diverged"
            got, total = read_all(sess, src)
            assert got == want[:total], \
                "fail-stop leg: the tier-served rescan diverged"
    finally:
        src.close()
        extent_space.clear_tiers()
    print("tier-gate fail-stop leg ok: member 0 dead from the first read, "
          "faults through its mirror byte-identical across both passes")


def main(argv=None) -> int:
    from ..api import StromError
    from ..config import config
    from ..hbm.backend import resolve_device
    from ..tiering import extent_space

    ap = argparse.ArgumentParser(prog="tier_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="where the HBM tier places extents (default "
                         "cuda:0; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"tier-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    # the HBM tier places on the gate's device (a Session's device
    # never moves the process-wide tier)
    extent_space.configure(device=dev)
    try:
        with tempfile.TemporaryDirectory(prefix="strom_tier_") as d:
            _leg_thrash_ab(d, dev)
            _leg_churn_identity(d, dev)
            _leg_failstop_faults(d, dev)
    except AssertionError as e:
        print(f"tier-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
        extent_space.clear_tiers()
        extent_space.configure()
    print("tier-gate ok: unified beats split on the thrash set, identity "
          "holds under migration churn and a member's fail-stop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
