"""ssd2gpu_test — SSD→GPU throughput benchmark (the load path).

Mirror of the reference's `utils/ssd2gpu_test.c`: one device destination
registered once, segment-pipelined transfers through pinned staging
buffers, and an optional byte-exact check against the file (`-c`,
`:342-372`).  Reports GB/s (10^9 bytes per second), the engine backend
that ran (``--backend`` picks the top rung of the ladder: auto, io_uring,
threadpool or python), the read requests issued, the chunks page-cache
arbitration sent through the write-back leg, and the host→device copy
ceiling measured with CUDA events.  Several files form a striped set
(``--stripe-chunk``, the md-RAID-0 shape; ``--mirror paired`` for
RAID-10), read as one logical stream.  ``--daemon SOCK`` routes the SSD
leg through a shared stromd (``tools/strom_daemon.py``): the daemon
schedules each segment's DMA into memfd ring slots both processes map,
and this client copies the slots into the CUDA tensor
(:func:`run_daemon_load`).

Usage: ssd2gpu_test [-c] [-n SEGS] [-s SEG_SZ] [-d DEV] [--chunk SZ]
                    [--backend B] [--loops N] [--no-drop-cache]
                    [--stripe-chunk SZ] [--mirror none|paired]
                    [--daemon SOCK [--tenant T]] FILE...
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import errno as _errno
import mmap
import os
import sys
import time
from typing import Optional, Sequence, Union

import torch

from ..api import StromError
from ..engine import Session, Source, check_file, open_source
from ..hbm import StagingPipeline, registry
from ..hbm.staging import resolve_device
from .common import (chunks_mismatch, drop_page_cache, memdump_on_corruption,
                     parse_size)

__all__ = ["run_load", "run_daemon_load", "measure_raw", "measure_h2d",
           "main", "cli"]


def measure_raw(path: Union[str, Sequence[str]], nbytes: int,
                block: int = 4 << 20) -> float:
    """Sequential O_DIRECT pread with no framework, in GB/s: the disk's own
    ceiling for the load.  A list of files reads them one after another,
    *nbytes* in all."""
    paths = [path] if isinstance(path, str) else list(path)
    buf = mmap.mmap(-1, block)
    total = 0
    try:
        t0 = time.monotonic()
        for p in paths:
            fd = os.open(p, os.O_RDONLY | os.O_DIRECT)
            try:
                off = 0
                while total < nbytes:
                    n = os.preadv(fd, [buf], off)
                    if n <= 0:
                        break
                    off += n
                    total += n
            finally:
                os.close(fd)
        dt = time.monotonic() - t0
    finally:
        buf.close()
    return total / dt / 1e9


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


def run_load(path: Union[str, Sequence[str], Source], *, device=None,
             segments: int = 6, segment_size: int = 16 << 20,
             chunk: int = 1 << 20, loops: int = 1, drop_cache: bool = True,
             backend: Optional[str] = None, stripe_chunk: int = 512 << 10,
             mirror: Optional[str] = None,
             session: Optional[Session] = None,
             warmup: bool = True) -> dict:
    """Load the whole chunks of *path* (a file, a list of files read as
    one striped set of *stripe_chunk* chunks, *mirror* ``none`` or
    ``paired``, default config ``mirror``, or an open Source, read as it
    is and left open, its page cache never dropped) into one preallocated
    tensor on *device* (default ``cuda:0``) through the staging pipeline,
    on the engine *backend* (default config ``io_backend``), or in
    *session*, an open Session of the caller's (its engine and member
    health).  A warm-up load of the first staged batch precedes the timed
    loops unless *warmup* is off (with a residency tier on, the warm-up
    would fill and touch the first chunks before the timed load).

    Returns ``{"tensor", "nbytes", "seconds" (best loop), "result" (last
    MemCopyResult: slot *i* of the tensor holds its ``chunk_ids[i]``),
    "depth" (deepest H2D ring), "counters" (stats delta of the timed
    loops, the engine's own counts folded in), "backend" (the rung that
    ran), "fixed" (staging buffers that became io_uring fixed buffers),
    "uring_errno" (why io_uring was refused, 0 if it was not)}``.
    """
    dev = resolve_device(device)
    if isinstance(path, Source):
        paths, opened = [], contextlib.nullcontext(path)
    else:
        paths = [path] if isinstance(path, str) else list(path)
        for p in paths:
            if not check_file(p).supported:
                raise StromError(22, f"{p}: not supported for direct load")
        spec = paths[0] if len(paths) == 1 else paths
        opened = open_source(spec, stripe_chunk_size=stripe_chunk
                             if len(paths) > 1 else None, mirror=mirror)
    with opened as src, \
            (contextlib.nullcontext(session) if session is not None
             else Session(device=dev, io_backend=backend)) as sess:
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
                if warmup:
                    warm = min(segment_size // chunk, n_chunks)
                    pipe.memcpy_ssd2dev(src, handle, list(range(warm)),
                                        chunk)
                    pipe.drain()
                fixed = sum(sess.is_fixed(buf) for _, buf in pipe._bufs)
                before = sess.stat_info()
                best = None
                for _ in range(loops):
                    if drop_cache:
                        for p in paths:
                            drop_page_cache(p)
                    t0 = time.monotonic()
                    res = pipe.memcpy_ssd2dev(src, handle,
                                              list(range(n_chunks)), chunk)
                    pipe.drain()
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    dt = time.monotonic() - t0
                    best = dt if best is None else min(best, dt)
                after = sess.stat_info()
                depth = pipe.depth_reached
            tensor = registry.get(handle).tensor
        finally:
            registry.unmap(handle)
        backend_name, uring_errno = sess.backend_name, sess.uring_errno
    return {"tensor": tensor, "nbytes": nbytes, "seconds": best,
            "result": res, "depth": depth, "backend": backend_name,
            "fixed": fixed, "uring_errno": uring_errno,
            "counters": {k: v - before.get(k, 0) for k, v in after.items()}}


class _RingSlot:
    """One memfd ring slot of a daemon session, ``cudaHostRegister``'d
    once when it is mapped (on a CUDA destination), with the event of the
    last copy that read it: the slot is refilled only after that event."""

    def __init__(self, dsess, nbytes: int, dev: torch.device):
        self.handle, self.buf = dsess.alloc_dma_buffer(nbytes)
        self.host = torch.frombuffer(self.buf.view(), dtype=torch.uint8)
        self.event: Optional[torch.cuda.Event] = None
        self._ref = None
        if dev.type == "cuda":
            self._ref = ctypes.c_char.from_buffer(self.buf._mm)
            err = int(torch.cuda.cudart().cudaHostRegister(
                ctypes.addressof(self._ref), self.buf.length, 0))
            if err != 0:
                self._ref = None
                raise StromError(_errno.ENOMEM,
                                 f"cudaHostRegister of a {self.buf.length}-"
                                 f"byte memfd ring slot failed with "
                                 f"cudaError {err}")

    def ready(self) -> None:
        """Block until the copy that last read this slot is done."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None

    def close(self, dsess) -> None:
        self.ready()
        if self._ref is not None:
            torch.cuda.cudart().cudaHostUnregister(ctypes.addressof(self._ref))
            self._ref = None
        self.host = None
        dsess.unmap_buffer(self.handle)


def run_daemon_load(socket_path: str, path: Union[str, Sequence[str]], *,
                    device=None, tenant: Optional[str] = None,
                    qos_class: Optional[str] = None, segments: int = 4,
                    segment_size: int = 16 << 20, chunk: int = 1 << 20,
                    loops: int = 1, drop_cache: bool = True,
                    stripe_chunk: int = 512 << 10,
                    mirror: Optional[str] = None) -> dict:
    """Load the whole chunks of *path* into one preallocated tensor on
    *device* (default ``cuda:0``) through the daemon at *socket_path*, as
    tenant *tenant* (class *qos_class*).  The daemon DMAs each
    *segment_size* segment into one of ``min(segments, 4)`` memfd ring
    slots; this client copies a landed slot into the tensor on its copy
    stream, and resubmits into the slot only after that copy's event.

    Returns :func:`run_load`'s dict (``backend`` is ``"daemon"``,
    ``counters`` the daemon's stats delta, ``depth`` the ring depth) plus
    ``daemon`` (the daemon's scoreboard after the last loop)."""
    from types import SimpleNamespace
    from ..daemon import DaemonSession
    dev = resolve_device(device)
    paths = [path] if isinstance(path, str) else list(path)
    striped = len(paths) > 1
    seg = max(segment_size // chunk, 1) * chunk
    per_seg = seg // chunk
    with DaemonSession(socket_path, tenant=tenant,
                       qos_class=qos_class) as dsess:
        kw = {"stripe_chunk_size": stripe_chunk, "mirror": mirror} \
            if striped else {}
        dsrc = dsess.open_source(paths if striped else paths[0], **kw)
        try:
            n_chunks = dsrc.size // chunk
            if n_chunks == 0:
                raise StromError(_errno.EINVAL,
                                 f"{path}: smaller than one chunk")
            nbytes = n_chunks * chunk
            n_segs = -(-n_chunks // per_seg)
            out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            cuda = dev.type == "cuda"
            copy = torch.cuda.Stream(device=dev) if cuda else None
            slots = []
            try:
                for _ in range(max(1, min(segments, 4))):
                    slots.append(_RingSlot(dsess, seg, dev))
                before = dsess.stat_info()
                best, order, wbc = None, [], 0
                for _ in range(loops):
                    if drop_cache:
                        for p in paths:
                            drop_page_cache(p)
                    order, wbc, inflight = [], 0, []

                    def retire():
                        nonlocal wbc
                        tid, slot, off, nb = inflight.pop(0)
                        r = dsess.memcpy_wait(tid)
                        order.extend(r.chunk_ids)
                        wbc += r.nr_ram2dev
                        if not cuda:
                            out[off:off + nb].copy_(slot.host[:nb])
                            return
                        with torch.cuda.stream(copy):
                            out[off:off + nb].copy_(slot.host[:nb],
                                                    non_blocking=True)
                            slot.event = torch.cuda.Event()
                            slot.event.record(copy)

                    t0 = time.monotonic()
                    for s in range(n_segs):
                        if len(inflight) >= len(slots):
                            retire()
                        slot = slots[s % len(slots)]
                        slot.ready()        # never refill under a copy
                        ids = list(range(s * per_seg,
                                         min((s + 1) * per_seg, n_chunks)))
                        r = dsess.memcpy_ssd2ram(dsrc, slot.handle, ids,
                                                 chunk)
                        inflight.append((r.dma_task_id, slot,
                                         s * per_seg * chunk,
                                         len(ids) * chunk))
                    while inflight:
                        retire()
                    if cuda:
                        copy.synchronize()
                    dt = time.monotonic() - t0
                    best = dt if best is None else min(best, dt)
                after = dsess.stat_info()
                board = dsess.daemon_stat()
            finally:
                for slot in slots:
                    slot.close(dsess)
        finally:
            dsrc.close()
    res = SimpleNamespace(chunk_ids=order, nr_ram2dev=wbc,
                          nr_chunks=n_chunks)
    return {"tensor": out, "nbytes": nbytes, "seconds": best,
            "result": res, "depth": len(slots), "backend": "daemon",
            "fixed": 0, "uring_errno": 0, "daemon": board,
            "counters": {k: v - before.get(k, 0) for k, v in after.items()
                         if isinstance(v, int)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ssd2gpu_test", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("file", nargs="+",
                    help="source file; several files form a striped set "
                         "(see --stripe-chunk)")
    ap.add_argument("--stripe-chunk", type=parse_size, default=512 << 10,
                    help="stripe chunk of a multi-file source (default "
                         "512KB, the md-raid0 shape)")
    ap.add_argument("--mirror", default=None, choices=("none", "paired"),
                    help="a multi-file source's mirror map (default: "
                         "config mirror); paired reads member 2k+1 as the "
                         "replica of member 2k")
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
    ap.add_argument("--backend", default=None,
                    choices=("auto", "io_uring", "threadpool", "python"),
                    help="top rung of the engine ladder (default: config "
                         "io_backend)")
    ap.add_argument("--daemon", metavar="SOCK", default=None,
                    help="route the SSD leg through the stromd at SOCK "
                         "(its DMA lands in shared memfd slots, the H2D "
                         "copy stays here)")
    ap.add_argument("--tenant", default=None,
                    help="tenant name in --daemon mode (default pid<N>)")
    args = ap.parse_args(argv)
    if args.loops < 1:
        ap.error("--loops must be >= 1")
    device = int(args.device) if (args.device or "").isdigit() \
        else args.device
    dev = resolve_device(device)
    files = args.file
    spec = files if len(files) > 1 else files[0]
    if args.daemon:
        out = run_daemon_load(args.daemon, spec, device=dev,
                              tenant=args.tenant, segments=args.segments,
                              segment_size=args.segment_size,
                              chunk=args.chunk, loops=args.loops,
                              drop_cache=not args.no_drop_cache,
                              stripe_chunk=args.stripe_chunk,
                              mirror=args.mirror)
    else:
        out = run_load(spec, device=dev, segments=args.segments,
                       segment_size=args.segment_size, chunk=args.chunk,
                       loops=args.loops, drop_cache=not args.no_drop_cache,
                       backend=args.backend, stripe_chunk=args.stripe_chunk,
                       mirror=args.mirror)
    nbytes, secs, c = out["nbytes"], out["seconds"], out["counters"]
    label = files[0] if len(files) == 1 else \
        f"{len(files)}-way stripe ({args.stripe_chunk >> 10}KB chunks)"
    if args.daemon:
        print(f"file: {label} ({nbytes / (1 << 20):.1f} MB)  device: {dev}  "
              f"daemon: {args.daemon} ({out['depth']} memfd ring slots of "
              f"{args.segment_size >> 20}MB)")
    else:
        print(f"file: {label} ({nbytes / (1 << 20):.1f} MB)  device: {dev}  "
              f"engine: {out['backend']} ({out['fixed']} of "
              f"{args.segments} staging buffers fixed)")
    print(f"transferred: {nbytes / 1e9:.3f} GB in {secs:.3f}s  => "
          f"{nbytes / secs / 1e9:.3f} GB/s")
    nsub = max(c.get("nr_submit_dma", 0), 1)
    print(f"avg dma size: {c.get('total_dma_length', 0) / nsub / 1024:.0f}KB"
          f"  requests: {c.get('nr_submit_dma', 0)}  "
          f"tasks: {c.get('nr_ssd2dev', 0)}  "
          f"h2d ring depth reached: {out['depth']}  "
          f"wb chunks: {out['result'].nr_ram2dev}/{out['result'].nr_chunks}")
    if c.get("nr_mirror_read"):
        print(f"mirror reads: {c['nr_mirror_read']}")
    if not args.no_drop_cache:
        for p in files:
            drop_page_cache(p)
    print(f"raw O_DIRECT read: {measure_raw(files, nbytes):.3f} GB/s")
    if dev.type == "cuda":
        print(f"h2d ceiling (pinned, CUDA events): "
              f"{measure_h2d(dev):.3f} GB/s")
    if args.check:
        with open_source(files if len(files) > 1 else files[0],
                         stripe_chunk_size=args.stripe_chunk
                         if len(files) > 1 else None,
                         mirror=args.mirror) as src:
            bad = chunks_mismatch(out["tensor"], src,
                                  out["result"].chunk_ids, args.chunk)
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
