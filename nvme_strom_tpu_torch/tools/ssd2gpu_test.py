"""ssd2gpu_test — SSD→GPU throughput benchmark (the load path).

Mirror of the reference's `utils/ssd2gpu_test.c`: one device destination
registered once, segment-pipelined transfers through pinned staging
buffers, and an optional byte-exact check against the file (`-c`,
`:342-372`).  Reports GB/s (10^9 bytes per second), the read requests
issued, and the host→device copy ceiling measured with CUDA events.

Usage: ssd2gpu_test [-c] [-n SEGS] [-s SEG_SZ] [-d DEV] [--chunk SZ]
                    [--loops N] [--no-drop-cache] FILE
"""

from __future__ import annotations

import argparse
import mmap
import os
import sys
import time

import torch

from ..api import StromError
from ..engine import Session, check_file, open_source
from ..hbm import StagingPipeline, registry
from ..hbm.staging import resolve_device
from ..stats import stats
from .common import (drop_page_cache, first_mismatch, memdump_on_corruption,
                     parse_size)

__all__ = ["run_load", "measure_raw", "measure_h2d", "main", "cli"]


def measure_raw(path: str, nbytes: int, block: int = 4 << 20) -> float:
    """Sequential O_DIRECT pread of *path* with no framework, in GB/s: the
    disk's own ceiling for the load."""
    buf = mmap.mmap(-1, block)
    fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    try:
        t0 = time.monotonic()
        off = 0
        while off < nbytes:
            n = os.preadv(fd, [buf], off)
            if n <= 0:
                break
            off += n
        dt = time.monotonic() - t0
    finally:
        os.close(fd)
        buf.close()
    return off / dt / 1e9


def measure_h2d(dev: torch.device, nbytes: int = 64 << 20,
                piece: int = 16 << 20) -> float:
    """Pinned host→device copy rate in GB/s, timed with CUDA events over
    *nbytes* moved in *piece*-byte copies."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out[:piece].copy_(host[:piece], non_blocking=True)    # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for off in range(0, nbytes, piece):
        out[off:off + piece].copy_(host[off:off + piece], non_blocking=True)
    end.record()
    end.synchronize()
    return nbytes / (start.elapsed_time(end) * 1e-3) / 1e9


def run_load(path: str, *, device=None, segments: int = 6,
             segment_size: int = 16 << 20, chunk: int = 1 << 20,
             loops: int = 1, drop_cache: bool = True) -> dict:
    """Load the whole chunks of *path* into one preallocated tensor on
    *device* (default ``cuda:0``) through the staging pipeline.

    Returns ``{"tensor", "nbytes", "seconds" (best loop), "result" (last
    MemCopyResult), "depth" (deepest H2D ring), "counters" (stats delta of
    the timed loops)}``."""
    dev = resolve_device(device)
    info = check_file(path)
    if not info.supported:
        raise StromError(22, f"{path}: not supported for direct load")
    with open_source(path) as src, Session(device=dev) as sess:
        n_chunks = src.size // chunk
        if n_chunks == 0:
            raise StromError(22, f"{path}: smaller than one chunk")
        nbytes = n_chunks * chunk
        handle = registry.map_device_memory(nbytes, device=dev)
        try:
            with StagingPipeline(sess, n_buffers=segments,
                                 staging_bytes=segment_size) as pipe:
                # warm-up: one full staged batch creates the copy stream
                # and first-touches the device path, outside the timing
                warm = min(segment_size // chunk, n_chunks)
                pipe.memcpy_ssd2dev(src, handle, list(range(warm)), chunk)
                pipe.drain()
                before = stats.snapshot()
                best = None
                for _ in range(loops):
                    if drop_cache:
                        drop_page_cache(path)
                    t0 = time.monotonic()
                    res = pipe.memcpy_ssd2dev(src, handle,
                                              list(range(n_chunks)), chunk)
                    pipe.drain()
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    dt = time.monotonic() - t0
                    best = dt if best is None else min(best, dt)
                after = stats.snapshot()
                depth = pipe.depth_reached
            tensor = registry.get(handle).tensor
        finally:
            registry.unmap(handle)
    return {"tensor": tensor, "nbytes": nbytes, "seconds": best,
            "result": res, "depth": depth,
            "counters": {k: v - before.get(k, 0) for k, v in after.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ssd2gpu_test", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("file")
    ap.add_argument("-d", "--device", default=None,
                    help="cuda ordinal, 'cuda:N' or 'cpu' (default cuda:0)")
    ap.add_argument("-n", "--segments", type=int, default=6,
                    help="staging buffers in flight (default 6)")
    ap.add_argument("-s", "--segment-size", type=parse_size, default=16 << 20,
                    help="staging segment size (default 16MB)")
    ap.add_argument("--chunk", type=parse_size, default=1 << 20)
    ap.add_argument("-c", "--check", action="store_true",
                    help="verify every byte against a read of the file")
    ap.add_argument("--no-drop-cache", action="store_true")
    ap.add_argument("--loops", type=int, default=1,
                    help="repeat the transfer and report the best loop")
    args = ap.parse_args(argv)
    if args.loops < 1:
        ap.error("--loops must be >= 1")
    device = int(args.device) if (args.device or "").isdigit() \
        else args.device
    dev = resolve_device(device)
    out = run_load(args.file, device=dev, segments=args.segments,
                   segment_size=args.segment_size, chunk=args.chunk,
                   loops=args.loops, drop_cache=not args.no_drop_cache)
    nbytes, secs, c = out["nbytes"], out["seconds"], out["counters"]
    print(f"file: {args.file} ({nbytes / (1 << 20):.1f} MB)  device: {dev}")
    print(f"transferred: {nbytes / 1e9:.3f} GB in {secs:.3f}s  => "
          f"{nbytes / secs / 1e9:.3f} GB/s")
    nsub = max(c.get("nr_submit_dma", 0), 1)
    print(f"avg dma size: {c.get('total_dma_length', 0) / nsub / 1024:.0f}KB"
          f"  requests: {c.get('nr_submit_dma', 0)}  "
          f"tasks: {c.get('nr_ssd2dev', 0)}  "
          f"h2d ring depth reached: {out['depth']}")
    if not args.no_drop_cache:
        drop_page_cache(args.file)
    print(f"raw O_DIRECT read: {measure_raw(args.file, nbytes):.3f} GB/s")
    if dev.type == "cuda":
        print(f"h2d ceiling (pinned, CUDA events): "
              f"{measure_h2d(dev):.3f} GB/s")
    if args.check:
        bad = first_mismatch(out["tensor"], args.file, nbytes)
        if bad is not None:
            memdump_on_corruption(bad[1], bad[2], bad[0])
            print("CORRUPTION", file=sys.stderr)
            return 1
        print(f"corruption check: all {nbytes} bytes OK")
    return 0


def cli() -> int:
    try:
        return main()
    except (StromError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(cli())
