"""The zero-copy landing gate: the JAX package's
``testing/landing_gate.py``.

Holds the landing's two contracts on synthetics:

* **Ratio** — with ``landing=direct`` a pipeline command delivers its
  payload touching at most ``--ratio`` (1.05) bytes a byte delivered
  (:func:`..stats.bytes_touched_ratio` over the run's counter delta): the
  engine's reads land in the owned buffer the destination tensor
  aliases, so the staging ring's second touch is gone.
* **Identity** — ``landing=direct`` and ``landing=staged`` land the same
  bytes, on the clean path and down the fault ladder: transient EIO healed
  by retries, a torn read healed by the checksum re-read, and hedged legs
  racing a slow member of a mirrored stripe.

Direct landing exists for a CPU destination only (a CUDA destination pays
the host→device copy either way, and the ring overlaps it with the
reads), so the direct legs land on the CPU; the staged legs land on the
device the gate names (default ``cuda:0``; ``-d cpu`` runs it all on the
host), where its Sessions are built too.

Usage: python -m nvme_strom_tpu_torch.testing.landing_gate [-d DEVICE]
       [--ratio R]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

#: the JAX package's limit of bytes touched a byte delivered
RATIO_LIMIT = 1.05

__all__ = ["main", "RATIO_LIMIT"]


def _load(mode: str, source, nbytes: int, chunk: int, device) -> bytes:
    """One pipeline command under *mode*; the destination's bytes.  The
    direct leg lands on the CPU, the staged one on *device*."""
    import torch

    from ..config import config
    from ..engine import Session
    from ..hbm import HbmRegistry, StagingPipeline

    config.set("landing", mode)
    reg = HbmRegistry()
    dest = torch.device("cpu") if mode == "direct" else device
    with Session(device=device) as sess:
        handle = reg.map_device_memory(nbytes, device=dest)
        try:
            with StagingPipeline(sess, hbm_registry=reg) as pipe:
                res = pipe.memcpy_ssd2dev(
                    source, handle,
                    list(range((nbytes + chunk - 1) // chunk)), chunk)
            assert res.landing == mode, \
                f"landing={mode} but the command took {res.landing!r}"
            got = reg.get(handle).tensor.cpu().numpy().tobytes()
        finally:
            reg.unmap(handle)
    return got


def _leg_ratio_and_identity(dirpath: str, device, limit: float) -> None:
    """Clean path: the direct ratio within *limit*, byte-identical to the
    staged landing."""
    from ..config import config
    from ..engine import PlainSource
    from ..stats import bytes_touched_ratio, stats
    from .fake import make_test_file

    size, chunk = 16 << 20, 1 << 20
    path = os.path.join(dirpath, "landing.bin")
    make_test_file(path, size)
    # a fresh file is page-cached, and arbitration would send every chunk
    # through the write-back leg: the gate measures the direct reads
    config.set("cache_arbitration", False)
    with PlainSource(path) as src:
        staged = _load("staged", src, size, chunk, device)
    before = stats.snapshot()
    with PlainSource(path) as src:
        direct = _load("direct", src, size, chunk, device)
    after = stats.snapshot()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert direct == staged, "direct and staged bytes differ (clean path)"
    assert delta.get("nr_landing_direct", 0) >= 1, \
        f"an eligible command did not land direct: {delta}"
    assert delta.get("nr_landing_fallback", 0) == 0, \
        f"an eligible command fell back: {delta}"
    ratio = bytes_touched_ratio(delta)
    assert ratio is not None, "no DMA bytes moved in the direct leg"
    assert ratio <= limit, \
        f"bytes touched a byte delivered {ratio:.4f} > {limit}"
    print(f"landing-gate ratio leg ok: {ratio:.4f} <= {limit} "
          f"({size >> 20} MiB, direct {delta.get('nr_landing_direct', 0)})")


def _leg_transient_faults(dirpath: str, device) -> None:
    """Every 3rd direct read EIOs (transient): the retries heal both
    landings to the same bytes."""
    from .fake import FakeStripedNvmeSource, FaultPlan, make_test_file

    nmem, msize, chunk = 2, 2 << 20, 256 << 10
    paths = []
    for m in range(nmem):
        p = os.path.join(dirpath, f"tm{m}.bin")
        make_test_file(p, msize, seed=m)
        paths.append(p)
    total = nmem * msize

    def load(mode):
        src = FakeStripedNvmeSource(
            paths, stripe_chunk_size=chunk,
            fault_plan=FaultPlan(fail_every_nth=3),
            force_cached_fraction=0.0)
        try:
            return _load(mode, src, total, chunk, device)
        finally:
            src.close()

    staged, direct = load("staged"), load("direct")
    assert direct == staged, "direct and staged differ under transient EIO"
    print("landing-gate fault leg ok: transient EIO heals byte-identically")


def _leg_corrupt_once(dirpath: str, device) -> None:
    """A torn read (a byte flipped once, right when read again): the
    checksum re-read repairs it on both landings."""
    import numpy as np

    from ..config import config
    from ..scan.heap import PAGE_SIZE, HeapSchema, build_heap_file
    from .fake import FakeNvmeSource, FaultPlan

    config.set("checksum_verify", True)
    schema = HeapSchema(n_cols=2, visibility=False)
    n = schema.tuples_per_page * 8
    path = os.path.join(dirpath, "co.heap")
    build_heap_file(path, [np.arange(n, dtype=np.int32),
                           (n - np.arange(n)).astype(np.int32)], schema)
    size = os.path.getsize(path)

    def load(mode):
        src = FakeNvmeSource(
            path,
            fault_plan=FaultPlan(corrupt_once_offsets={2 * PAGE_SIZE + 99}),
            force_cached_fraction=0.0)
        try:
            return _load(mode, src, size, PAGE_SIZE, device)
        finally:
            src.close()

    with open(path, "rb") as f:
        want = f.read()
    try:
        staged, direct = load("staged"), load("direct")
    finally:
        config.set("checksum_verify", False)
    assert staged == want, "the staged repair differs from the disk"
    assert direct == want, "the direct repair differs from the disk"
    print("landing-gate corrupt leg ok: the torn read healed on both "
          "landings")


def _leg_hedged(dirpath: str, device) -> None:
    """Hedged legs racing a slow member of a mirrored stripe land the
    same bytes on both landings."""
    from ..config import config
    from .chaos import make_mirrored_members
    from .fake import FakeStripedNvmeSource, FaultPlan

    chunk = 128 << 10
    paths = make_mirrored_members(dirpath, n_pairs=1, size=1 << 20,
                                  tag="hm")
    config.set("hedge_policy", "fixed")
    config.set("hedge_ms", 2.0)

    def load(mode):
        src = FakeStripedNvmeSource(
            paths, stripe_chunk_size=chunk,
            fault_plan=FaultPlan(slow_member=1, slow_s=0.02),
            force_cached_fraction=0.0, mirror="paired")
        try:
            return _load(mode, src, src.size, chunk, device)
        finally:
            src.close()

    try:
        staged, direct = load("staged"), load("direct")
    finally:
        config.set("hedge_policy", "off")
    assert direct == staged, "direct and staged differ under hedged reads"
    print("landing-gate hedge leg ok: hedged legs byte-identical")


def main(argv=None) -> int:
    from ..api import StromError
    from ..config import config
    from ..hbm.backend import resolve_device

    ap = argparse.ArgumentParser(prog="landing_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="the Sessions' and the staged destinations' device "
                         "(default cuda:0; 'cpu' runs on the host)")
    ap.add_argument("--ratio", type=float, default=RATIO_LIMIT,
                    help=f"most bytes touched a byte delivered on the "
                         f"direct landing (default {RATIO_LIMIT})")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"landing-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    try:
        with tempfile.TemporaryDirectory(prefix="strom_landing_") as d:
            _leg_ratio_and_identity(d, dev, args.ratio)
            _leg_transient_faults(d, dev)
            _leg_corrupt_once(d, dev)
            _leg_hedged(d, dev)
    except AssertionError as e:
        print(f"landing-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
    print("landing-gate ok: the ratio within its bound, the fault ladder "
          "byte-identical direct and staged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
