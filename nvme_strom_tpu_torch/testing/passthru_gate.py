"""The NVMe passthrough lane's gate: the JAX package's
``testing/passthru_gate.py``.

Holds the raw-command data path's contracts on the deterministic
in-process emulator (:mod:`.passthru_emu`; no NVMe char device needed):

* **Byte identity across the split** — a fragmented file with ineligible
  (UNWRITTEN / INLINE) ranges reads byte-identical through the mixed
  passthrough + O_DIRECT plan, with both lanes exercised
  (``nr_passthru_dma`` > 0 and ``nr_passthru_refused_extent`` > 0), and
  lands on the gate's device equal to the file.  An extent map that lies
  is caught here, not trusted.
* **Identity under fail-stop** — a seeded fail-stop of a mirrored member
  fires on the passthrough lane and the ladder's mirror rung serves the
  same bytes, every lane exit counted (``nr_passthru_fallback`` > 0):
  passthrough never weakens the fault ladder.
* **Zero counters when disabled** — ``engine_backend`` ``uring`` or
  ``threadpool`` with an emulator attached reads the same bytes and moves
  no passthrough counter: the pinned ladder is the plain path.
* **Submit overhead A/B** — the service cost of a request on the
  passthrough lane (a resolved SLBA, one raw command) against the O_DIRECT
  lane on the same bytes; the row is printed as one JSON line (the gate
  writes no journal).  The emulator serves its commands from a
  prefaulted RAM image while the O_DIRECT lane reads the file, so the
  row holds the lane's host path against a read from the file system,
  not one device lane against another.

The Sessions are built on the device the gate names (default ``cuda:0``:
the split leg's buffer is registered with CUDA and its bytes land there);
``-d cpu`` runs it on the host.  Files live in a temporary directory.

Usage: python -m nvme_strom_tpu_torch.testing.passthru_gate [-d DEVICE]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

__all__ = ["main", "ab_submit_overhead", "CHUNK"]

CHUNK = 64 << 10

# FIEMAP flag values (the blockmap's ABI constants, restated for layouts)
_UNWRITTEN = 0x800
_INLINE = 0x200


def _counters() -> dict:
    from ..stats import stats
    return stats.snapshot()


def _delta(before: dict, after: dict, key: str) -> int:
    return after.get(key, 0) - before.get(key, 0)


def _base_config(config) -> None:
    config.set("cache_bytes", 0)
    config.set("cache_arbitration", False)
    config.set("dma_max_size", CHUNK)
    config.set("hedge_policy", "off")
    config.set("autotune", False)


def _read_pass(sess, src, nchunks: int, device=None, chunk: int = CHUNK):
    """One memcpy of *nchunks* chunks; the bytes, and with *device* the
    buffer copied there (a ``uint8`` tensor)."""
    handle, buf = sess.alloc_dma_buffer(nchunks * chunk)
    try:
        res = sess.memcpy_ssd2ram(src, handle, list(range(nchunks)), chunk)
        sess.memcpy_wait(res.dma_task_id, timeout=120.0)
        got = bytes(buf.view()[:nchunks * chunk])
        landed = None
        if device is not None:
            import torch
            landed = torch.frombuffer(bytearray(got), dtype=torch.uint8) \
                .to(device)
        return got, landed
    finally:
        sess.unmap_buffer(handle)


def _leg_split_identity(dirpath: str, device) -> None:
    """Fragmented and partly ineligible layout: a mixed-lane plan whose
    bytes equal the O_DIRECT-only read, the generator's oracle and, on
    the device, the file."""
    import torch

    from ..config import config
    from ..engine import Session
    from . import FakeNvmeSource, make_test_file
    from .fake import expected_bytes
    from .passthru_emu import PassthruEmulator

    nchunks = 8
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "split.bin")
    make_test_file(path, size)
    _base_config(config)
    emu = PassthruEmulator(os.path.join(dirpath, "split.img"))
    # 4 gapped physical runs; an UNWRITTEN hole in chunk 1 and an INLINE
    # tail in chunk 5, both of which must ride O_DIRECT
    emu.provision(path, frag=4,
                  ineligible=((CHUNK, 4096, _UNWRITTEN),
                              (5 * CHUNK + 512, 8192, _INLINE)))
    before = _counters()
    try:
        ref_src = FakeNvmeSource(path, force_cached_fraction=0.0)
        try:
            with Session(device=device) as sess:
                got_odirect, _ = _read_pass(sess, ref_src, nchunks)
        finally:
            ref_src.close()
        src = FakeNvmeSource(path, force_cached_fraction=0.0)
        emu.attach(src)
        try:
            with Session(device=device) as sess:
                got_passthru, landed = _read_pass(sess, src, nchunks, device)
        finally:
            src.close()
    finally:
        emu.close()
    after = _counters()
    want = expected_bytes(0, size)
    assert got_odirect == want, "O_DIRECT reference pass diverged"
    assert got_passthru == want, \
        "passthrough split pass diverged from the oracle"
    with open(path, "rb") as f:
        on_disk = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8)
    assert torch.equal(landed.cpu(), on_disk), \
        f"split pass landed on {device} unequal to the file"
    dma = _delta(before, after, "nr_passthru_dma")
    refused = _delta(before, after, "nr_passthru_refused_extent")
    moved = _delta(before, after, "bytes_passthru")
    assert dma > 0, "split leg never issued a passthrough command"
    assert refused > 0, \
        "split leg never refused an ineligible extent (layout not mixed?)"
    assert 0 < moved < size, \
        f"passthrough moved {moved} of {size} bytes: the split is not mixed"
    print(f"passthru-gate split leg ok: {dma} commands, "
          f"{moved >> 10}KB passthrough / {size >> 10}KB total, "
          f"{refused} refused extent(s), bytes identical on {device}")


def _leg_failstop_mirror(dirpath: str, device) -> None:
    """A seeded fail-stop of a mirrored member under passthrough: the
    ladder's mirror rung answers, the bytes stay identical, the lane exits
    are counted."""
    from ..config import config
    from ..engine import Session
    from . import FakeStripedNvmeSource, FaultPlan, make_test_file
    from .chaos import STRIPE, expected_mirrored_stream, read_all
    from .passthru_emu import PassthruEmulator

    _base_config(config)
    config.set("io_retries", 0)
    member = 256 << 10
    paths = []
    for k in range(2):
        p = os.path.join(dirpath, f"fs{2 * k}.bin")
        make_test_file(p, member, seed=300 + k)
        q = os.path.join(dirpath, f"fs{2 * k + 1}.bin")
        shutil.copyfile(p, q)
        paths += [p, q]
    emu = PassthruEmulator(os.path.join(dirpath, "fs.img"))
    for p in paths:
        emu.provision(p, frag=2)
    plan = FaultPlan(failstop_member=0, failstop_after=0)
    before = _counters()
    try:
        src = FakeStripedNvmeSource(paths, STRIPE, fault_plan=plan,
                                    force_cached_fraction=0.0,
                                    mirror="paired")
        emu.attach(src)
        try:
            with Session(device=device) as sess:
                got, total = read_all(sess, src, chunk=CHUNK)
        finally:
            src.close()
    finally:
        emu.close()
    after = _counters()
    assert got == expected_mirrored_stream(paths)[:total], \
        "bytes diverged through the fail-stop + mirror fallback"
    fell = _delta(before, after, "nr_passthru_fallback")
    mirrored = _delta(before, after, "nr_mirror_read")
    served = _delta(before, after, "nr_passthru_dma")
    assert fell > 0, \
        "fail-stop never exited the passthrough lane (fallback uncounted)"
    assert mirrored > 0, "mirror rung never served the fail-stopped member"
    assert served > 0, "healthy members never rode passthrough"
    print(f"passthru-gate fail-stop leg ok: {fell} lane exit(s), "
          f"{mirrored} mirror read(s), {served} passthrough command(s), "
          f"bytes identical")


def _leg_disabled_zero_counters(dirpath: str, device) -> None:
    """``engine_backend`` pinned below the passthrough rung: emulator
    attached, bytes identical, every passthrough counter still."""
    from ..config import config
    from ..engine import Session
    from . import FakeNvmeSource, make_test_file
    from .fake import expected_bytes
    from .passthru_emu import PassthruEmulator

    nchunks = 4
    size = nchunks * CHUNK
    path = os.path.join(dirpath, "off.bin")
    make_test_file(path, size)
    _base_config(config)
    emu = PassthruEmulator(os.path.join(dirpath, "off.img"))
    emu.provision(path, frag=2)
    try:
        for pinned in ("uring", "threadpool"):
            config.set("engine_backend", pinned)
            before = _counters()
            src = FakeNvmeSource(path, force_cached_fraction=0.0)
            emu.attach(src)
            try:
                with Session(device=device) as sess:
                    got, _ = _read_pass(sess, src, nchunks)
            finally:
                src.close()
            after = _counters()
            assert got == expected_bytes(0, size), \
                f"bytes diverged with engine_backend={pinned!r}"
            dirty = {k: _delta(before, after, k) for k in after
                     if (k.startswith("nr_passthru")
                         or k == "bytes_passthru")
                     and _delta(before, after, k)}
            assert not dirty, \
                f"engine_backend={pinned!r} still touched passthrough: {dirty}"
            assert emu.commands_served == 0, \
                f"emulator served {emu.commands_served} commands while " \
                f"disabled"
    finally:
        emu.close()
    print("passthru-gate disabled leg ok: uring/threadpool pins move the "
          "same bytes with zero passthrough counters")


def ab_submit_overhead(dirpath: str, *, nreqs: int = 256,
                       rounds: int = 5) -> dict:
    """Per-request submit and service cost, passthrough lane against
    O_DIRECT lane, over the same resolved extents (emulator-backed).  The
    passthrough side issues the pre-resolved raw command, with no
    per-request fd or alignment machinery: the submit-path work the raw
    rung removes.  Returns the A/B row."""
    import mmap

    from .. import blockmap
    from . import FakeNvmeSource, make_test_file
    from .fake import expected_bytes
    from .passthru_emu import PassthruEmulator

    req = 4 << 10
    size = nreqs * req
    path = os.path.join(dirpath, "ab.bin")
    make_test_file(path, size)
    emu = PassthruEmulator(os.path.join(dirpath, "ab.img"))
    emu.provision(path, frag=1)
    src = FakeNvmeSource(path, force_cached_fraction=0.0)
    chan = emu.attach(src)
    buf = mmap.mmap(-1, req)   # page-aligned: O_DIRECT-legal on both lanes
    mv = memoryview(buf)
    # resolved once up front: the lane's steady state (generation-cached)
    runs = blockmap.resolve_split(path, 0, size, emu.lba_size)
    plan = []
    for fo, ln, dev in runs:
        if dev is None:
            continue
        for i in range(0, ln, req):
            plan.append((fo + i, dev + i))
    assert len(plan) == nreqs, f"A/B plan resolved {len(plan)}/{nreqs} reqs"
    pt_s, od_s = [], []
    try:
        for _ in range(rounds):
            t0 = time.perf_counter_ns()
            for fo, dev in plan:
                chan.read(0, fo, dev, mv)
            pt_s.append(time.perf_counter_ns() - t0)
            assert bytes(mv) == expected_bytes(size - req, req)
            t0 = time.perf_counter_ns()
            for fo, _dev in plan:
                src.read_member_direct(0, fo, mv)
            od_s.append(time.perf_counter_ns() - t0)
            assert bytes(mv) == expected_bytes(size - req, req)
    finally:
        mv.release()
        buf.close()
        src.close()
        emu.close()
    pt_ns = statistics.median(pt_s) / nreqs
    od_ns = statistics.median(od_s) / nreqs
    return {"row": "passthru_submit_overhead",
            "passthru_ns_per_req": round(pt_ns),
            "odirect_ns_per_req": round(od_ns),
            "reduction": round(od_ns / pt_ns, 2) if pt_ns else 0.0,
            "reqs": nreqs, "req_bytes": req, "rounds": rounds,
            "passthru_bytes_from": "prefaulted RAM image",
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime())}


def _leg_ab(dirpath: str) -> dict:
    row = ab_submit_overhead(dirpath)
    print(json.dumps(row))
    assert row["passthru_ns_per_req"] < row["odirect_ns_per_req"], \
        f"passthrough submit path is not cheaper: {row}"
    print(f"passthru-gate A/B leg ok: {row['passthru_ns_per_req']}ns/req "
          f"passthrough vs {row['odirect_ns_per_req']}ns/req O_DIRECT "
          f"({row['reduction']}x)")
    return row


def main(argv=None) -> int:
    from ..api import StromError
    from ..config import config
    from ..hbm.backend import resolve_device

    ap = argparse.ArgumentParser(prog="passthru_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="the Sessions' device (default cuda:0; 'cpu' "
                         "runs on the host)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"passthru-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    try:
        with tempfile.TemporaryDirectory(prefix="strom_passthru_") as d:
            _leg_split_identity(d, dev)
            _leg_failstop_mirror(d, dev)
            _leg_disabled_zero_counters(d, dev)
            _leg_ab(d)
    except AssertionError as e:
        print(f"passthru-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
    print("passthru-gate ok: mixed split identical, fail-stop falls back "
          "counted, pinned ladders stay passthrough-free, submit A/B row "
          "printed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
