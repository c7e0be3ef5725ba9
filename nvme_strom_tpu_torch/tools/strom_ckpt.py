"""strom_ckpt — inspect / verify / benchmark strom checkpoint files.

The JAX package's ``strom_ckpt`` over the port: ``info`` dumps the leaf
table, ``verify`` restores to the device and compares every leaf with a
buffered read of the file and with the header's crc32c (the ``-c``
corruption-oracle pattern of `utils/ssd2gpu_test.c:342-372`), ``bench``
times a direct-to-device restore from a cold page cache.  The device is
``cuda:0`` unless ``-d`` names another (``-d cpu`` for the host); with no
CUDA device the default raises ENODEV.

Usage (``python -m nvme_strom_tpu_torch.tools.strom_ckpt``):
  strom_ckpt info FILE
  strom_ckpt verify [-d DEV] FILE
  strom_ckpt bench [-d DEV] FILE [--loops N]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..data.checkpoint import checkpoint_info, restore_checkpoint
from ..hbm.staging import resolve_device
from ..scan.heap import crc32c
from .common import drop_page_cache


def _info(path: str) -> int:
    meta = checkpoint_info(path)
    total = 0
    print(f"{path}: strom checkpoint v{meta['version']}, "
          f"{len(meta['leaves'])} leaves, data at {meta['data_offset']:#x}")
    for e in meta["leaves"]:
        shape = "x".join(map(str, e["shape"])) or "scalar"
        print(f"  {e['key']:<40} {e['dtype']:<6} {shape:<16} "
              f"{e['nbytes']:>12} B @ {meta['data_offset'] + e['offset']:#x}")
        total += e["nbytes"]
    print(f"  total tensor bytes: {total}")
    return 0


def _verify(path: str, device) -> int:
    meta = checkpoint_info(path)
    out = restore_checkpoint(path, device=resolve_device(device))
    bad = 0
    with_crc = 0
    with open(path, "rb") as f:
        for e in meta["leaves"]:
            f.seek(meta["data_offset"] + e["offset"])
            raw = f.read(e["nbytes"])
            got = out[e["key"]].reshape(-1).view(torch.uint8).cpu().numpy()
            if not np.array_equal(got, np.frombuffer(raw, np.uint8)):
                print(f"  CORRUPT: {e['key']} (direct != buffered)",
                      file=sys.stderr)
                bad += 1
                continue
            # the header's crc32c pins the bytes the SAVER intended: a
            # torn write that both read paths agree on still fails here
            if "crc32c" in e:
                with_crc += 1
                if crc32c(raw) != e["crc32c"]:
                    print(f"  CORRUPT: {e['key']} (crc32c mismatch, "
                          f"header {e['crc32c']:#010x})", file=sys.stderr)
                    bad += 1
    if bad:
        print(f"verify: {bad}/{len(meta['leaves'])} leaves corrupt",
              file=sys.stderr)
        return 1
    crc_note = f", {with_crc} crc32c-checked" if with_crc else ""
    print(f"verify: all {len(meta['leaves'])} leaves OK "
          f"(direct restore == buffered read{crc_note})")
    return 0


def _bench(path: str, loops: int, device) -> int:
    dev = resolve_device(device)
    meta = checkpoint_info(path)
    nbytes = sum(e["nbytes"] for e in meta["leaves"])
    # first-touch the device outside the timed region
    torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
    best = None
    for loop in range(loops):
        drop_page_cache(path)
        t0 = time.monotonic()
        out = restore_checkpoint(path, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.monotonic() - t0
        del out
        if loops > 1:
            print(f"  loop {loop + 1}: {nbytes / dt / 1e9:.3f} GB/s")
        best = dt if best is None else min(best, dt)
    print(f"restored {len(meta['leaves'])} leaves, {nbytes} B in "
          f"{best:.3f} s => {nbytes / best / 1e9:.3f} GB/s on {dev}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="strom_ckpt", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("info", "verify", "bench"):
        p = sub.add_parser(name)
        p.add_argument("file")
        if name != "info":
            p.add_argument("-d", "--device", default=None,
                           help="device to restore to (default cuda:0)")
        if name == "bench":
            p.add_argument("--loops", type=int, default=1)
    args = ap.parse_args(argv)
    if args.cmd == "info":
        return _info(args.file)
    if args.cmd == "verify":
        return _verify(args.file, args.device)
    return _bench(args.file, max(args.loops, 1), args.device)


def cli() -> int:
    from ..api import StromError
    try:
        return main()
    except (StromError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(cli())
