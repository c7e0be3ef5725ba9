#!/usr/bin/env python3
"""Chip smoke test of nvme_strom_tpu_torch on one CUDA card.

Drives the port's main path — load, then scan — at full size and holds
every CUDA kernel of that path against its plain PyTorch version:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: every ``nvme_strom_tpu_torch/csrc/*.cu`` with ``nvcc`` (sm_90a);
3. kernel vs plain on the card: the page-filter kernel over seeded random
   heap pages (4096 pages and odd counts) for several schemas and
   predicates; counts and integer sums bit-exact, float sums within
   ``1e-5 * sum(|selected x|) + 1e-6`` (atomics sum in a varying order);
4. load: a file of ``--load-gib`` GiB (>= 1) through ``ssd2gpu_test``'s
   path into one CUDA tensor, checked against the file in 64 MiB pieces;
5. scan: a heap table of ``--scan-pages`` pages (>= 131072, 1 GiB) through
   ``TableScanner.scan_filter`` with the kernel, checked against numpy
   truth; the kernel must have launched once per batch;
6. times: the kernel at the scan's batch shape with CUDA events, its
   memory bound, and the plain version's time.

Any failure raises and the exit code is non-zero.  With no CUDA device it
exits 2 and prints no result.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernel table.

Usage: python3 chip_smoke.py [--load-gib G] [--scan-pages N] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
SCAN_BATCH_PAGES = 2048            # 16 MiB chunk_size / 8 KiB pages


def _random_columns(rng, schema, n):
    cols = []
    for c in range(schema.n_cols):
        dt = schema.col_dtype(c)
        if dt.kind == "f":
            cols.append(rng.standard_normal(n).astype(dt))
        elif dt == np.dtype(np.uint32):
            cols.append(rng.integers(0xF000_0000, 0xFFFF_FFFF, n,
                                     dtype=np.uint32))
        else:
            cols.append(rng.integers(-1000, 1000, n).astype(dt))
    return cols


def _kernel_cases(torch, dev, seed):
    """Phase 3: kernel vs plain on the card.  Returns max |error|."""
    from nvme_strom_tpu_torch.ops import filter_cuda
    from nvme_strom_tpu_torch.ops.filter import (FilterPred, decode_pages,
                                                 make_filter_fn)
    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_pages
    rng = np.random.default_rng(seed)
    gt = FilterPred(((0, "gt", None),))
    cases = [
        ("int32+vis gt", HeapSchema(2, True), gt, 0, 4096),
        ("int32 novis 2-term", HeapSchema(2, False),
         FilterPred(((0, "gt", None), (1, "lt", 500))), -10, 4096),
        ("f32/u32/i32+vis gt", HeapSchema(3, True,
                                          ("float32", "uint32", "int32")),
         gt, 0.25, 1237),
        ("f32/u32/i32 2-term", HeapSchema(3, False,
                                          ("float32", "uint32", "int32")),
         FilterPred(((2, "ge", None), (0, "le", 1.5))), -300, 4096),
        ("uint32 wrap all", HeapSchema(1, False, ("uint32",)),
         FilterPred(()), 0, 4099),
        ("int32+vis all", HeapSchema(2, True), FilterPred(()), 0, 1237),
    ]
    worst = 0.0
    before = filter_cuda.launches
    for name, schema, pred, th, n_pages in cases:
        n = schema.tuples_per_page * n_pages - 7
        vis = (rng.random(n) > 0.25).astype(np.int32) \
            if schema.visibility else None
        pages_np = build_pages(_random_columns(rng, schema, n), schema,
                               visibility=vis)
        pages = torch.from_numpy(pages_np).to(dev)
        got = filter_cuda.make_filter_fn_cuda(schema, pred)(pages, th)
        want = make_filter_fn(schema, pred)(pages, th)
        torch.cuda.synchronize(dev)
        if int(got["count"]) != int(want["count"]):
            raise AssertionError(f"{name}: count {int(got['count'])} != "
                                 f"plain {int(want['count'])}")
        cols, valid = decode_pages(pages, schema)
        sel = pred.mask(cols, valid, schema, th)
        for c in range(schema.n_cols):
            g, w = got["sums"][c], want["sums"][c]
            if schema.col_dtype(c).kind == "f":
                a, b = float(g), float(w)
                mag = float(torch.where(sel, cols[c].abs(), 0.0)
                            .sum(dtype=torch.float64))
                tol = 1e-5 * mag + 1e-6
                worst = max(worst, abs(a - b))
                if abs(a - b) > tol:
                    raise AssertionError(f"{name}: col {c} float sum {a} vs "
                                         f"plain {b} (tol {tol})")
            else:
                gb = int(g.view(torch.int32)) if g.dtype == torch.uint32 \
                    else int(g)
                wb = int(w.view(torch.int32)) if w.dtype == torch.uint32 \
                    else int(w)
                if gb != wb:
                    raise AssertionError(f"{name}: col {c} int sum bits "
                                         f"{gb} != plain {wb}")
        print(f"  kernel == plain: {name} ({n_pages} pages, count "
              f"{int(got['count'])})")
    if filter_cuda.launches - before != len(cases):
        raise AssertionError(f"kernel launches moved by "
                             f"{filter_cuda.launches - before}, expected "
                             f"{len(cases)}")
    return worst


def _write_random_file(path, nbytes, seed, piece=64 << 20):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for off in range(0, nbytes, piece):
            f.write(rng.bytes(min(piece, nbytes - off)))


def _time_ms(torch, fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--load-gib", type=float, default=1.0)
    ap.add_argument("--scan-pages", type=int, default=131072)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.load_gib < 1.0 or args.scan_pages < 131072:
        ap.error("the load is at least 1 GiB and the scan 131072 pages")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nvme_strom_tpu_torch import _build
    from nvme_strom_tpu_torch.ops import filter_cuda
    from nvme_strom_tpu_torch.ops.filter import (DEFAULT_SCHEMA, STEP_PRED,
                                                 scan_filter_step)
    from nvme_strom_tpu_torch.scan.executor import TableScanner
    from nvme_strom_tpu_torch.scan.heap import (PAGE_SIZE, HeapSchema,
                                                build_heap_file)
    from nvme_strom_tpu_torch.stats import stats
    from nvme_strom_tpu_torch.tools.common import (drop_page_cache,
                                                   first_mismatch)
    from nvme_strom_tpu_torch.tools.ssd2gpu_test import (measure_h2d,
                                                         measure_raw,
                                                         run_load)

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[1] nvidia-smi: {card}")
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"device: {kind}")

    t0 = time.monotonic()
    logs = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"[2] build: {sorted(logs) or 'cached'} in {build_s:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    worst = _kernel_cases(torch, dev, args.seed)
    print(f"[3] kernel vs plain: all cases agree (max |float err| "
          f"{worst:.3g})")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # -- main path: load, then scan; counts read after both ----------
        filter_cuda.launches = 0
        stats.reset()
        load_path = os.path.join(tmp, "load.bin")
        load_bytes = int(args.load_gib * (1 << 30))
        _write_random_file(load_path, load_bytes, args.seed)
        drop_page_cache(load_path)
        out = run_load(load_path, device=dev)
        load_gbs = out["nbytes"] / out["seconds"] / 1e9
        bad = first_mismatch(out["tensor"], load_path, out["nbytes"])
        if bad is not None:
            raise AssertionError(f"load: landed bytes differ from the file "
                                 f"at offset {bad[0]}")
        print(f"[4] load: {out['nbytes']} bytes in {out['seconds']:.3f} s "
              f"= {load_gbs:.3f} GB/s, byte-identical; nr_ssd2dev "
              f"{out['counters'].get('nr_ssd2dev', 0)}, requests "
              f"{out['counters'].get('nr_submit_dma', 0)}, h2d ring depth "
              f"reached {out['depth']}")
        del out
        drop_page_cache(load_path)
        print(f"    yardstick: raw O_DIRECT read of the same file "
              f"{measure_raw(load_path, load_bytes):.3f} GB/s")
        os.unlink(load_path)

        schema = HeapSchema(n_cols=2, visibility=True)
        rng = np.random.default_rng(args.seed + 1)
        n_rows = schema.tuples_per_page * args.scan_pages
        c0 = rng.integers(-1000, 1000, n_rows, dtype=np.int32)
        c1 = rng.integers(-(1 << 31), (1 << 31) - 1, n_rows, dtype=np.int32)
        vis = (rng.random(n_rows) > 0.25).astype(np.int32)
        heap_path = os.path.join(tmp, "table.heap")
        t0 = time.monotonic()
        build_heap_file(heap_path, [c0, c1], schema, visibility=vis)
        heap_build_s = time.monotonic() - t0
        drop_page_cache(heap_path)
        th = 100
        sel = (vis != 0) & (c0 > th)
        want_count = int(sel.sum())
        want_sum = int(np.uint32(c1[sel].astype(np.int64).sum()
                                 & 0xFFFFFFFF).view(np.int32))
        del c0, c1, vis, sel
        table_bytes = os.path.getsize(heap_path)
        # read-only pass (SSD -> pinned pool, no device work), then the
        # counted scan, each from a cold page cache
        with TableScanner(heap_path) as sc:
            t0 = time.monotonic()
            n_read = sum(len(b.pages) for b in sc.batches())
            read_s = time.monotonic() - t0
        if n_read != args.scan_pages:
            raise AssertionError(f"read pass saw {n_read} pages")
        drop_page_cache(heap_path)
        filter_cuda.launches = 0
        stats.reset()
        with TableScanner(heap_path) as sc:
            t0 = time.monotonic()
            res = sc.scan_filter(
                lambda p: filter_cuda.scan_filter_step_cuda(p, th))
            scan_s = time.monotonic() - t0
            n_batches = sc.last_batches
            depth = sc.last_h2d_depth
        main_launches = filter_cuda.launches
        if int(res["count"]) != want_count or int(res["sum"]) != want_sum:
            raise AssertionError(f"scan: got count {int(res['count'])} sum "
                                 f"{int(res['sum'])}, numpy truth "
                                 f"{want_count} / {want_sum}")
        if main_launches != n_batches or n_batches == 0:
            raise AssertionError(f"scan: {main_launches} kernel launches "
                                 f"for {n_batches} batches")
        print(f"[5] scan: {table_bytes} bytes ({args.scan_pages} pages, "
              f"table built in {heap_build_s:.1f} s) in {scan_s:.3f} s = "
              f"{table_bytes / scan_s / 1e9:.3f} GB/s; count {want_count} "
              f"and sum {want_sum} match numpy; {main_launches} launches = "
              f"{n_batches} batches; h2d depth reached {depth}")
        print(f"    yardstick: read-only pass of the scanner (no device) "
              f"{table_bytes / read_s / 1e9:.3f} GB/s")

        # -- times at the scan's batch shape ------------------------------
        first = bytearray(SCAN_BATCH_PAGES * PAGE_SIZE)
        with open(heap_path, "rb") as f:
            f.readinto(first)
        batch = torch.frombuffer(first, dtype=torch.uint8) \
            .view(-1, PAGE_SIZE).to(dev)
        # 8 distinct copies (128 MiB > 50 MB L2): each launch reads cold
        ring = [batch.clone() for _ in range(8)]
        for b in ring:
            filter_cuda.scan_filter_step_cuda(b, th)
        # the bare launch (prebuilt spec and outputs) times the kernel;
        # the wrapper's time adds its per-call host work
        spec = filter_cuda._spec(DEFAULT_SCHEMA, STEP_PRED, th)
        outb = torch.zeros(4, dtype=torch.int32, device=dev)
        kernel_ms = _time_ms(
            torch, lambda i: filter_cuda.launch(
                ring[i % 8], spec, outb[:1], outb[1:3],
                outb[3:].view(torch.float32)), 256)
        wrapper_ms = _time_ms(
            torch, lambda i: filter_cuda.scan_filter_step_cuda(ring[i % 8],
                                                               th), 64)
        scan_filter_step(ring[0], th)
        plain_ms = _time_ms(
            torch, lambda i: scan_filter_step(ring[i % 8], th), 16)
        in_bytes = batch.numel()
        out_bytes = 4 + 4 * 2 + 4          # count, isums[2], fsums[1]
        bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        h2d = measure_h2d(dev)
        print(f"[6] filter kernel at ({SCAN_BATCH_PAGES}, {PAGE_SIZE}) "
              f"uint8: {kernel_ms:.4f} ms (bound {bound_ms:.4f} ms by "
              f"bytes at 3.35 TB/s = {bound_ms / kernel_ms:.1%}); wrapper "
              f"call {wrapper_ms:.4f} ms; plain "
              f"version {plain_ms:.4f} ms (not a yardstick); pinned h2d "
              f"{h2d:.3f} GB/s; total {time.monotonic() - t_start:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    table = {"kernels": [{
        "name": "filter_pages",
        "route": "cuda",
        "source": "nvme_strom_tpu_torch/csrc/filter.cu",
        "replaces": "nvme_strom_tpu/ops/filter_pallas.py:140",
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
