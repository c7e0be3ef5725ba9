#!/usr/bin/env python3
"""Chip smoke test of nvme_strom_tpu_torch on one CUDA card.

Drives the port's main paths — load, scan, GROUP BY and the packed-sidecar
(pushdown) aggregate — at full size and holds every CUDA kernel of those
paths against its plain PyTorch version:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: every ``nvme_strom_tpu_torch/csrc/*.cu`` with ``nvcc`` (sm_90a),
   all sources at once;
3. kernel vs plain on the card, over seeded random pages:
   a. the page filter (B1) for several schemas and predicates, and the
      jnp-promotion cases (float values against an int32 column);
   b. GROUP BY (B3): int32, uint32 (wrapping sums) and float32 with
      NaN/±inf, G in {1, 7, 64, the kernel's cap}, keys with INT_MIN/INT_MAX,
      negatives and out-of-range ids, with and without predicates;
   c. the packed decode-filter (B2): every codec (bitpack at 1/2/4/8/16
      bits, dict, rle, raw), 512- to 32768-row blocks, ``need_cols``, the
      file's header page and zero padding;
   counts, integer sums, mins and maxs exact; float sums within
   ``1e-5 * sum(|x|) + 1e-6`` (sums of squares ``1e-5 * sum(x^2) + 1e-6``)
   because atomics add in a varying order;
4. load: a file of ``--load-gib`` GiB (>= 1) through ``ssd2gpu_test``'s
   path into one CUDA tensor, checked against the file in 64 MiB pieces;
5. scan: a heap table of ``--scan-pages`` pages (>= 131072, 1 GiB) through
   ``TableScanner.scan_filter`` with B1, checked against numpy truth;
6. GROUP BY: a cold 1 GiB six-column heap table through ``Query.run()``
   (two queries), checked against numpy truth with the IEEE cases;
7. pushdown: a cold 1 GiB four-column heap table, encoded with
   ``build_packed``, aggregated through ``Query.run()`` over the heap (B1),
   the chip leg (B2) and the host leg (decode on the host, then B1);
8. main-path batches: B3 (both GROUP BY queries) and B2 against their
   plain versions on the first batch of their main path, under the rules
   of phase 3; then each kernel timed at that batch shape with CUDA events
   over a ring of distinct batches, its bound from the bytes it must read
   (the regions its query touches, not the whole page), and the plain
   version's time.

Every main path sets the kernels' launch counts to 0 just before it runs
and reads them just after; each kernel of a path must have launched once
per batch.  Any failure raises and the exit code is non-zero.  With no
CUDA device it exits 2 and prints no result.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it is the
kernel table.

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
F32_OPS_PER_S = 67e12              # H100 SXM 32-bit rate outside tensor cores
SCAN_BATCH_PAGES = 2048            # 16 MiB chunk_size / 8 KiB pages
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
# float results of a main path against float64 numpy truth: within
# TRUTH_REL * sum(|x|) (sum(x^2) for sums of squares) + 1e-6, because the
# port accumulates in float32, as the TPU kernels do, over millions of rows
# a group (the kernel-vs-plain checks hold 1e-5)
TRUTH_REL = 1e-4


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


def _int_bits(t):
    """A scalar int32/uint32 tensor's 32 bits as a Python int."""
    import torch
    return int(t.view(torch.int32)) if t.dtype == torch.uint32 else int(t)


def _filter_cases(torch, dev, seed):
    """Phase 3a: B1 vs plain on the card.  Returns max |float error|."""
    from nvme_strom_tpu_torch.ops import filter_cuda
    from nvme_strom_tpu_torch.ops.filter import (FilterPred, decode_pages,
                                                 make_filter_fn)
    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_pages
    rng = np.random.default_rng(seed)
    gt = FilterPred(((0, "gt", None),))
    cases = [
        ("int32+vis gt", HeapSchema(2, True), gt, 0, 4096, None),
        ("int32 novis 2-term", HeapSchema(2, False),
         FilterPred(((0, "gt", None), (1, "lt", 500))), -10, 4096, None),
        ("f32/u32/i32+vis gt", HeapSchema(3, True,
                                          ("float32", "uint32", "int32")),
         gt, 0.25, 1237, None),
        ("f32/u32/i32 2-term", HeapSchema(3, False,
                                          ("float32", "uint32", "int32")),
         FilterPred(((2, "ge", None), (0, "le", 1.5))), -300, 4096, None),
        ("uint32 wrap all", HeapSchema(1, False, ("uint32",)),
         FilterPred(()), 0, 4099, None),
        ("int32+vis all", HeapSchema(2, True), FilterPred(()), 0, 1237, None),
    ]
    # jnp promotion: a float value against an int32 column in [-5, 5)
    # compares in float32; above 2^24 the column's values round too
    numpy_op = {"ge": np.greater_equal, "lt": np.less, "eq": np.equal,
                "ne": np.not_equal}
    for value in (0.25, -0.5, (1 << 24) + 0.5):
        for op in ("ge", "lt", "eq", "ne"):
            cases.append((f"int32 {op} {value}", HeapSchema(1, False),
                          FilterPred(((0, op, value),)), 0, 63,
                          (numpy_op[op], value)))
    worst = 0.0
    before = filter_cuda.launches
    for name, schema, pred, th, n_pages, promo in cases:
        n = schema.tuples_per_page * n_pages - 7
        vis = (rng.random(n) > 0.25).astype(np.int32) \
            if schema.visibility else None
        if promo is None:
            cols = _random_columns(rng, schema, n)
        else:
            cols = [rng.integers(-5, 5, n).astype(np.int32)]
            if promo[1] > 1 << 24:
                cols[0] += np.int32((1 << 24) + 2)
        pages_np = build_pages(cols, schema, visibility=vis)
        pages = torch.from_numpy(pages_np).to(dev)
        got = filter_cuda.make_filter_fn_cuda(schema, pred)(pages, th)
        want = make_filter_fn(schema, pred)(pages, th)
        torch.cuda.synchronize(dev)
        if int(got["count"]) != int(want["count"]):
            raise AssertionError(f"{name}: count {int(got['count'])} != "
                                 f"plain {int(want['count'])}")
        if promo is not None:
            truth = promo[0](cols[0].astype(np.float32), np.float32(promo[1]))
            if int(got["count"]) != int(truth.sum()):
                raise AssertionError(f"{name}: count {int(got['count'])} != "
                                     f"numpy float32 truth "
                                     f"{int(truth.sum())}")
        dcols, valid = decode_pages(pages, schema)
        sel = pred.mask(dcols, valid, schema, th)
        for c in range(schema.n_cols):
            g, w = got["sums"][c], want["sums"][c]
            if schema.col_dtype(c).kind == "f":
                a, b = float(g), float(w)
                mag = float(torch.where(sel, dcols[c].abs(), 0.0)
                            .sum(dtype=torch.float64))
                tol = 1e-5 * mag + 1e-6
                worst = max(worst, abs(a - b))
                if abs(a - b) > tol:
                    raise AssertionError(f"{name}: col {c} float sum {a} vs "
                                         f"plain {b} (tol {tol})")
            elif _int_bits(g) != _int_bits(w):
                raise AssertionError(f"{name}: col {c} int sum bits "
                                     f"{_int_bits(g)} != plain {_int_bits(w)}")
        print(f"  B1 == plain: {name} ({n_pages} pages, count "
              f"{int(got['count'])})")
    if filter_cuda.launches - before != len(cases):
        raise AssertionError(f"B1 launches moved by "
                             f"{filter_cuda.launches - before}, expected "
                             f"{len(cases)}")
    return worst


def _same_groups(torch, name, got, want, mag1, mag2):
    """B3 result vs plain: count, integer sums, mins and maxs exact (NaN
    matches NaN); float sums and sums of squares within ``1e-5 * mag +
    1e-6`` where finite, the same NaN/±inf elsewhere.  Returns the largest
    float error and the largest error over its tolerance."""
    worst, share = 0.0, 0.0
    for f in ("count", "sums", "sumsqs", "mins", "maxs"):
        a, b = got[f], want[f]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {f} is {tuple(a.shape)} {a.dtype}"
                                 f", plain {tuple(b.shape)} {b.dtype}")
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.dtype != torch.float32:
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: {f} differs from plain")
            continue
        if f in ("mins", "maxs"):
            same = (a == b) | (a.isnan() & b.isnan())
            if not bool(same.all()):
                raise AssertionError(f"{name}: {f} differs from plain")
            continue
        mag = mag1 if f == "sums" else mag2
        fin = torch.isfinite(b)
        if not torch.equal(a.isnan(), b.isnan()) or \
                not bool(((a == b) | fin | b.isnan()).all()):
            raise AssertionError(f"{name}: {f} NaN/inf differ from plain")
        err = torch.where(fin, (a.double() - b.double()).abs(), 0.0)
        tol = 1e-5 * mag + 1e-6
        if bool((err > tol).any()):
            raise AssertionError(f"{name}: {f} off by up to "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
        share = max(share, float((err / tol).max()))
    return worst, share


def _group_mags(torch, pages, schema, key, G, agg, pred):
    """Per group sum(|x|) and sum(x^2) of the selected finite values."""
    from nvme_strom_tpu_torch.ops.filter import decode_pages
    cols, valid = decode_pages(pages, schema)
    ids = key.ids(cols, schema)
    sel = valid & (ids >= 0) & (ids < G)
    if pred is not None:
        sel = pred.mask(cols, sel, schema, 0)
    k = ids[sel]
    m1, m2 = [], []
    for c in agg:
        x = cols[c][sel].double()
        x = torch.where(torch.isfinite(x), x, 0.0)
        z = torch.zeros(G, dtype=torch.float64, device=pages.device)
        m1.append(z.index_add(0, k, x.abs()))
        m2.append(z.index_add(0, k, x * x))
    return torch.stack(m1), torch.stack(m2)


def _groupby_cases(torch, dev, seed):
    """Phase 3b: B3 vs plain on the card.  Returns max |float error| and
    the largest error over its tolerance."""
    from nvme_strom_tpu_torch.ops import groupby_cuda
    from nvme_strom_tpu_torch.ops.filter import FilterPred
    from nvme_strom_tpu_torch.ops.groupby import GroupKey, make_groupby_fn
    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_pages
    rng = np.random.default_rng(seed + 1)
    schema = HeapSchema(5, True, ("int32", "int32", "int32", "uint32",
                                  "float32"))
    cap = groupby_cuda.MAX_GROUPS
    cases = [
        ("i32 G=1 all rows", GroupKey(2, 1), 1, [0, 2], None, 1237),
        ("i32 G=7 abs(c1) where c0 > 0.25", GroupKey(1, 7, True), 7, [0, 2],
         FilterPred(((0, "gt", 0.25),)), 4099),
        ("u32 G=64 c1 % 64 where c0 >= -2", GroupKey(1, 64), 64, [3],
         FilterPred(((0, "ge", -2),)), 4096),
        ("f32 G=64 abs(c1) 2-term", GroupKey(1, 64, True), 64, [4],
         FilterPred(((0, "ne", 0), (3, "lt", np.uint32(3_000_000_000)))),
         2049),
        (f"f32 G={cap} c1 % {cap}", GroupKey(1, cap), cap, [4], None, 4099),
        (f"i32 G={cap} u32 key where c4 < 0.5", GroupKey(3, cap), cap,
         [0, 2], FilterPred(((4, "lt", 0.5),)), 1237),
        ("i32 G=7 value key c0 (ids out of range)", GroupKey(0), 7, [2],
         None, 513),
        ("u32 G=64 value key c3", GroupKey(3), 64, [3], None, 513),
        ("f32 G=7 value key c0 (ids out of range)", GroupKey(0), 7, [4],
         FilterPred(((1, "lt", 0),)), 777),
    ]
    # every aggregated column of one dtype: 15 float32 columns beside an
    # int32 key take dynamic shared memory above 48 KiB at G = cap
    wide = HeapSchema(16, True, ("int32",) + ("float32",) * 15)
    cases.append((f"f32 G={cap} V=15 (shared memory above 48 KiB)",
                  GroupKey(0, cap, True), cap, list(range(1, 16)), None, 513))
    worst, share = 0.0, 0.0
    before = groupby_cuda.launches
    for name, key, G, agg, pred, n_pages in cases:
        sch = wide if len(agg) == 15 else schema
        n = sch.tuples_per_page * n_pages - 5
        c1 = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int32, endpoint=True)
        c1[:6] = [INT_MIN, INT_MAX, -7, -1, 5, 0]
        floats = []
        for _ in range(15 if sch is wide else 1):
            f = (rng.standard_normal(n) * 10).astype(np.float32)
            for v, p in ((np.nan, 2e-5), (np.inf, 2e-5), (-np.inf, 2e-5)):
                f[rng.random(n) < p] = v
            floats.append(f)
        if sch is wide:
            cols = [c1] + floats
        else:
            c0 = rng.integers(-6, 6, n).astype(np.int32)
            c2 = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int32,
                              endpoint=True)
            c3 = rng.integers(0, 0xFFFF_FFFF, n, dtype=np.uint32,
                              endpoint=True)
            c3[:2] = [0, 7]
            small = rng.random(n) < 0.02          # value-key ids 0..99
            c3[small] %= 100
            cols = [c0, c1, c2, c3] + floats
        vis = (rng.random(n) > 0.2).astype(np.int32)
        pages = torch.from_numpy(build_pages(cols, sch,
                                             visibility=vis)).to(dev)
        got = groupby_cuda.groupby_pages_cuda(pages, 0, sch, key, G,
                                              agg_cols=agg, predicate=pred)
        want = make_groupby_fn(sch, key, G, agg_cols=agg,
                               predicate=pred)(pages)
        torch.cuda.synchronize(dev)
        m1, m2 = _group_mags(torch, pages, sch, key, G, agg, pred)
        w, r = _same_groups(torch, name, got, want, m1, m2)
        worst, share = max(worst, w), max(share, r)
        print(f"  B3 == plain: {name} ({n_pages} pages, "
              f"{int(got['count'].sum())} rows in groups)")
    if groupby_cuda.launches - before != len(cases):
        raise AssertionError(f"B3 launches moved by "
                             f"{groupby_cuda.launches - before}, expected "
                             f"{len(cases)}")
    return worst, share


def _same_decode(torch, name, got, want, pages, meta, pred, need):
    """B2 result vs plain: count and integer sums exact, float sums within
    ``1e-5 * sum(|x|) + 1e-6``.  Returns the largest float error."""
    from nvme_strom_tpu_torch.ops.decode import decode_block_words
    from nvme_strom_tpu_torch.ops.filter import page_words
    if int(got["count"]) != int(want["count"]):
        raise AssertionError(f"{name}: count {int(got['count'])} != "
                             f"plain {int(want['count'])}")
    dcols, valid = decode_block_words(page_words(pages), meta, need)
    sel = valid if pred is None else pred.mask(dcols, valid, meta.dtypes, 0)
    worst = 0.0
    for c, dt in enumerate(meta.dtypes):
        g, w = got["sums"][c], want["sums"][c]
        if np.dtype(dt).kind == "f":
            mag = float(torch.where(sel, dcols[c].abs(), 0.0)
                        .sum(dtype=torch.float64))
            err = abs(float(g) - float(w))
            worst = max(worst, err)
            if err > 1e-5 * mag + 1e-6:
                raise AssertionError(f"{name}: col {c} float sum "
                                     f"{float(g)} vs plain {float(w)}")
        elif _int_bits(g) != _int_bits(w):
            raise AssertionError(f"{name}: col {c} int sum bits "
                                 f"{_int_bits(g)} != plain {_int_bits(w)}")
    return worst


def _groupby_bytes(schema, key, agg, pred, n_pages):
    """Bytes B3 must read of *n_pages* full pages: each page's first
    32-byte sector (its tuple count) and the column regions the query
    touches (visibility, key, predicate and aggregated columns)."""
    regions = {key.col, *agg, *(t[0] for t in (pred.terms if pred else ()))}
    if schema.visibility:
        regions.add(schema.n_cols)
    return n_pages * (32 + 4 * schema.tuples_per_page * len(regions))


def _decode_bytes(torch, pages, meta, need):
    """Bytes B2 must read of a batch: a data page's 64-byte header and the
    regions of the columns it decodes (the rest is padding); any other
    page's first 32-byte sector, where the kernel finds no CPK_MAGIC."""
    from nvme_strom_tpu_torch.ops.filter import page_words
    from nvme_strom_tpu_torch.scan.colpack import CPK_MAGIC
    from nvme_strom_tpu_torch.scan.heap import HEADER_WORDS
    n_data = int((page_words(pages)[:, 0] == CPK_MAGIC).sum())
    words = HEADER_WORDS + sum(cm.nwords for c, cm in enumerate(meta.cols)
                               if need is None or c in need)
    return n_data * 4 * words + (pages.shape[0] - n_data) * 32


def _decode_cases(torch, dev, seed, tmp):
    """Phase 3c: B2 vs plain on the card, over packed files built from
    seeded heap tables.  Returns max |float error|."""
    from nvme_strom_tpu_torch.ops import decode_cuda
    from nvme_strom_tpu_torch.ops.decode import make_decode_filter_fn
    from nvme_strom_tpu_torch.ops.filter import FilterPred
    from nvme_strom_tpu_torch.scan.colpack import build_packed
    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
    rng = np.random.default_rng(seed + 2)
    n = 300_001
    vals8 = np.array([-1_000_000_007, -77, 0, 5, 1234, 99_999,
                      2_000_000_000, -2_000_000_000], np.int32)
    u32 = rng.integers(0, 0xFFFF_FFFF, n, dtype=np.uint32, endpoint=True)
    f32 = rng.standard_normal(n).astype(np.float32)
    runs_u = (np.arange(n) // 600 + (1 << 31) - 50).astype(np.uint32)
    runs_i = (np.arange(n) // 1300 - 100).astype(np.int32)
    cases = []
    for bits in (1, 4):              # one column: 32768 / 8192-row blocks
        c0 = rng.integers(0, 1 << bits, n).astype(np.int32)
        cases.append((f"bitpack {bits}b alone", ("int32",), [c0],
                      ("bitpack",), FilterPred(((0, "ge", (1 << bits) // 2),)),
                      None))
    for bits in (2, 8, 16):          # beside raw columns: small blocks
        c0 = rng.integers(0, 1 << bits, n).astype(np.int32)
        cases.append((f"bitpack {bits}b + raw u32/f32",
                      ("int32", "uint32", "float32"), [c0, u32, f32],
                      ("bitpack",), FilterPred(((0, "lt", (1 << bits) // 3),
                                                (2, "gt", -0.5))), None))
    dict_cols = [vals8[rng.integers(0, 8, n)], f32]
    cases += [
        ("dict + raw f32", ("int32", "float32"), dict_cols, None,
         FilterPred(((0, "ne", 5),)), None),
        ("dict need_cols=(1,)", ("int32", "float32"), dict_cols, None,
         None, (1,)),
        ("rle u32 + rle i32", ("uint32", "int32"), [runs_u, runs_i], ("rle",),
         FilterPred(((0, "lt", np.uint32((1 << 31) + 100)),
                     (1, "le", -0.5))), None),
        ("raw i32/u32/f32", ("int32", "uint32", "float32"),
         [rng.integers(-9, 9, n).astype(np.int32), u32, f32], (),
         FilterPred(((0, "gt", 0.25), (1, "ge", np.uint32(1 << 31)))), None),
        ("bitpack/dict/rle/raw need_cols=(0, 2)",
         ("int32", "int32", "int32", "float32"),
         [rng.integers(0, 16, n).astype(np.int32), dict_cols[0], runs_i,
          f32], None, None, (0, 2)),
    ]
    worst = 0.0
    before = decode_cuda.launches
    for i, (name, dtypes, cols, codecs, pred, need) in enumerate(cases):
        schema = HeapSchema(len(dtypes), False, dtypes)
        path = os.path.join(tmp, f"dec{i}.heap")
        build_heap_file(path, cols, schema)
        kw = {} if codecs is None else {"codecs": codecs}
        meta = build_packed(path, schema, **kw)
        raw = np.fromfile(meta.path, np.uint8).reshape(-1, 8192)
        # the file's header page leads; three zero pages of padding trail
        raw = np.concatenate([raw, np.zeros((3, 8192), np.uint8)])
        pages = torch.from_numpy(raw).to(dev)
        got = decode_cuda.decode_filter_pages_cuda(pages, 0, meta, pred,
                                                   need_cols=need)
        want = make_decode_filter_fn(meta, pred, need_cols=need)(pages)
        torch.cuda.synchronize(dev)
        worst = max(worst, _same_decode(torch, name, got, want, pages, meta,
                                        pred, need))
        codec = "/".join(f"{cm.codec}{cm.bits or ''}" for cm in meta.cols)
        print(f"  B2 == plain: {name} ({codec}, {meta.rows_per_block} rows a "
              f"block, {len(raw)} pages, count {int(got['count'])})")
        os.unlink(path)
        os.unlink(meta.path)
    if decode_cuda.launches - before != len(cases):
        raise AssertionError(f"B2 launches moved by "
                             f"{decode_cuda.launches - before}, expected "
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


def _first_batch(torch, dev, path):
    """The first 16 MiB scan batch of *path*, on the card, as 8 distinct
    copies (128 MiB > the 50 MB L2): each timed launch reads cold."""
    from nvme_strom_tpu_torch.scan.heap import PAGE_SIZE
    first = bytearray(SCAN_BATCH_PAGES * PAGE_SIZE)
    with open(path, "rb") as f:
        f.readinto(first)
    batch = torch.frombuffer(first, dtype=torch.uint8) \
        .view(-1, PAGE_SIZE).to(dev)
    return [batch.clone() for _ in range(8)]


def _group_truth(k, sel, G, columns):
    """Per-group numpy truth of the selected rows: counts, and for each
    column the list of its per-group value arrays."""
    k = k[sel]
    order = np.argsort(k, kind="stable")
    bounds = np.searchsorted(k[order], np.arange(G + 1))
    per = []
    for v in columns:
        vs = v[sel][order]
        per.append([vs[bounds[g]:bounds[g + 1]] for g in range(G)])
    return np.diff(bounds), per


def _check_group_result(name, res, G, counts, per, is_float):
    """A ``Query.run()`` GROUP BY result against numpy truth."""
    if not np.array_equal(res["count"], counts):
        raise AssertionError(f"{name}: counts differ from numpy")
    for v, segs in enumerate(per):
        for g in range(G):
            x = segs[g]
            s, sq = res["sums"][v, g], res["sumsqs"][v, g]
            mn, mx = res["mins"][v, g], res["maxs"][v, g]
            if not is_float:
                want = np.int64(x.astype(np.int64).sum()) & 0xFFFFFFFF
                if int(np.asarray(s).view(np.uint32)) != int(want) or \
                        mn != x.min() or mx != x.max():
                    raise AssertionError(f"{name}: col {v} group {g} sum/min"
                                         f"/max differ from numpy")
                x2 = np.square(x.astype(np.float32).astype(np.float64))
                if abs(sq - x2.sum()) > TRUTH_REL * x2.sum() + 1e-6:
                    raise AssertionError(f"{name}: col {v} group {g} sumsq "
                                         f"{sq} vs numpy {x2.sum()}")
                continue
            nan, pinf, ninf = np.isnan(x).any(), (x == np.inf).any(), \
                (x == -np.inf).any()
            fin = x[np.isfinite(x)].astype(np.float64)
            if nan or (pinf and ninf):
                ok = np.isnan(s)
            elif pinf or ninf:
                ok = s == (np.inf if pinf else -np.inf)
            else:
                ok = abs(s - fin.sum()) <= TRUTH_REL * np.abs(fin).sum() + 1e-6
            if nan:
                ok = ok and np.isnan(sq) and np.isnan(mn) and np.isnan(mx)
            elif pinf or ninf:
                ok = ok and sq == np.inf and mn == x.min() and mx == x.max()
            else:
                ok = ok and mn == x.min() and mx == x.max() and \
                    abs(sq - np.square(fin).sum()) <= \
                    TRUTH_REL * np.square(fin).sum() + 1e-6
            if not ok:
                raise AssertionError(f"{name}: col {v} group {g}: sum {s} "
                                     f"sumsq {sq} min {mn} max {mx} vs numpy "
                                     f"(nan {nan} +inf {pinf} -inf {ninf})")


def _groupby_path(torch, dev, tmp, seed, n_pages):
    """Phase 6: GROUP BY over a cold 1 GiB heap table through Query.run().
    Returns (B3 launches, first batch ring, timing spec inputs)."""
    from nvme_strom_tpu_torch.ops import groupby_cuda
    from nvme_strom_tpu_torch.ops.filter import FilterPred
    from nvme_strom_tpu_torch.ops.groupby import GroupKey
    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
    from nvme_strom_tpu_torch.scan.query import Query
    from nvme_strom_tpu_torch.stats import stats
    from nvme_strom_tpu_torch.tools.common import drop_page_cache
    schema = HeapSchema(6, True, ("int32", "int32", "int32", "uint32",
                                  "float32", "float32"))
    rng = np.random.default_rng(seed + 3)
    n = schema.tuples_per_page * n_pages
    c0 = rng.integers(-1000, 1000, n, dtype=np.int32)
    c1 = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int32, endpoint=True)
    c1[:4] = [INT_MIN, INT_MAX, -1, 0]
    c2 = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int32, endpoint=True)
    c3 = rng.integers(0, 0xFFFF_FFFF, n, dtype=np.uint32, endpoint=True)
    c4 = rng.standard_normal(n, dtype=np.float32)
    c5 = rng.standard_normal(n, dtype=np.float32) * np.float32(100)
    vis = (rng.random(n) > 0.25).astype(np.int32)
    g8 = np.abs(c1.astype(np.int64)) % 8      # abs(INT_MIN) % 8 == 0 too
    # a sprinkle of NaN/±inf into chosen groups of the float query:
    # c4: NaN in group 0, +inf in 1, -inf in 2, both infinities in 3;
    # c5: +inf in 5, NaN in 6, -inf in 7; the other groups stay finite
    for col, g, vals in ((c4, 0, [np.nan] * 3), (c4, 1, [np.inf] * 3),
                         (c4, 2, [-np.inf] * 3),
                         (c4, 3, [np.inf, np.inf, -np.inf]),
                         (c5, 5, [np.inf] * 2), (c5, 6, [np.nan] * 2),
                         (c5, 7, [-np.inf] * 2)):
        rows = np.flatnonzero((g8 == g) & (vis != 0))
        col[rng.choice(rows, len(vals), replace=False)] = vals
    path = os.path.join(tmp, "group.heap")
    t0 = time.monotonic()
    build_heap_file(path, [c0, c1, c2, c3, c4, c5], schema, visibility=vis)
    build_s = time.monotonic() - t0
    table_bytes = os.path.getsize(path)
    n_batches = -(-n_pages // SCAN_BATCH_PAGES)
    q1_pred = FilterPred(((0, "gt", 100),))
    queries = [
        ("where c0 > 100 group_by c1 % 64 agg [0, 2]",
         lambda: Query(path, schema).where(q1_pred).group_by(
             GroupKey(1, 64), 64, agg_cols=[0, 2]),
         (vis != 0) & (c0 > 100), c1.astype(np.int64) % 64, 64,
         [c0, c2], False),
        ("group_by abs(c1) % 8 agg [4, 5]",
         lambda: Query(path, schema).group_by(
             GroupKey(1, 8, absolute=True), 8, agg_cols=[4, 5]),
         vis != 0, g8, 8, [c4, c5], True),
    ]
    launches = 0
    for name, make, sel, k, G, cols, is_float in queries:
        counts, per = _group_truth(k, sel, G, cols)
        q = make()
        plan = q.explain(device=dev)
        if plan.kernel != "cuda" or "B3" not in plan.reason:
            raise AssertionError(f"{name}: plan {plan}")
        drop_page_cache(path)
        groupby_cuda.launches = 0
        stats.reset()
        t0 = time.monotonic()
        res = q.run(device=dev)
        run_s = time.monotonic() - t0
        got = groupby_cuda.launches
        batches = stats.snapshot().get("nr_kernel_dispatch", 0)
        if got != batches or got != n_batches:
            raise AssertionError(f"{name}: {got} B3 launches for {batches} "
                                 f"batches ({n_batches} expected)")
        launches += got
        _check_group_result(name, res, G, counts, per, is_float)
        print(f"[6] group by: {name}: {table_bytes} bytes in {run_s:.3f} s "
              f"= {table_bytes / run_s / 1e9:.3f} GB/s; {int(counts.sum())} "
              f"rows in {G} groups match numpy; {got} B3 launches = "
              f"{batches} batches")
    print(f"    table: {n_pages} pages, {schema.tuples_per_page} tuples a "
          f"page, built in {build_s:.1f} s")
    ring = _first_batch(torch, dev, path)
    os.unlink(path)
    return launches, ring, schema, q1_pred


def _pushdown_path(torch, dev, tmp, seed, n_pages, read_gbs, h2d_gbs):
    """Phase 7: aggregate over a cold 1 GiB heap table and its packed
    sidecar through Query.run(): the heap scan (B1), the chip leg (B2)
    and the host leg.  Returns (B2 launches, first packed batch ring,
    meta, predicate)."""
    from nvme_strom_tpu_torch.config import config
    from nvme_strom_tpu_torch.ops import decode_cuda, filter_cuda
    from nvme_strom_tpu_torch.ops.filter import FilterPred
    from nvme_strom_tpu_torch.scan.colpack import build_packed
    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
    from nvme_strom_tpu_torch.scan.query import Query
    from nvme_strom_tpu_torch.stats import stats
    from nvme_strom_tpu_torch.tools.common import drop_page_cache
    schema = HeapSchema(4, False, ("int32", "int32", "int32", "float32"))
    rng = np.random.default_rng(seed + 4)
    n = schema.tuples_per_page * n_pages
    vals8 = np.array([-1_000_000_007, -77, 0, 5, 1234, 99_999,
                      2_000_000_000, -2_000_000_000], np.int32)
    c0 = rng.integers(0, 16, n, dtype=np.int32)           # bitpack
    c1 = vals8[rng.integers(0, 8, n)]                      # dict
    c2 = (np.arange(n) // 4099 - 8000).astype(np.int32)    # rle
    c3 = rng.standard_normal(n, dtype=np.float32)          # raw
    path = os.path.join(tmp, "push.heap")
    build_heap_file(path, [c0, c1, c2, c3], schema)
    t0 = time.monotonic()
    meta = build_packed(path, schema, codecs=("bitpack", "dict", "rle"))
    encode_s = time.monotonic() - t0
    codecs = [cm.codec for cm in meta.cols]
    if codecs != ["bitpack", "dict", "rle", "raw"]:
        raise AssertionError(f"pushdown table encoded as {codecs}")
    pred = FilterPred(((0, "ge", 8), (1, "ne", 5), (3, "lt", 1.0)))
    sel = (c0 >= 8) & (c1 != 5) & (c3 < np.float32(1.0))
    want_count = int(sel.sum())
    want_ints = [int(np.int64(c[sel].astype(np.int64).sum()) & 0xFFFFFFFF)
                 for c in (c0, c1, c2)]
    want_f = float(c3[sel].astype(np.float64).sum())
    tol_f = TRUTH_REL * float(np.abs(c3[sel]).astype(np.float64).sum()) \
        + 1e-6
    del c0, c1, c2, c3, sel
    heap_bytes = os.path.getsize(path)
    cpk_bytes = os.path.getsize(meta.path)

    def leg(mode, **rates):
        config.set("pushdown", mode)
        config.set("pushdown_h2d_gbps", rates.get("h2d", 0.0))
        config.set("pushdown_ssd_gbps", rates.get("ssd", 0.0))
        q = Query(path, schema).where(pred).aggregate([0, 1, 2, 3])
        plan = q.explain(device=dev)
        drop_page_cache(path)
        drop_page_cache(meta.path)
        filter_cuda.launches = 0
        decode_cuda.launches = 0
        stats.reset()
        t0 = time.monotonic()
        res = q.run(device=dev)
        run_s = time.monotonic() - t0
        counts = dict(stats.snapshot(), b1=filter_cuda.launches,
                      b2=decode_cuda.launches)
        bits = [int(np.asarray(s).view(np.uint32)) for s in res["sums"][:3]]
        if int(res["count"]) != want_count or bits != want_ints or \
                abs(float(res["sums"][3]) - want_f) > tol_f:
            raise AssertionError(f"pushdown {plan.pushdown} leg: count "
                                 f"{int(res['count'])} sums {bits} "
                                 f"{float(res['sums'][3])} vs numpy "
                                 f"{want_count} {want_ints} {want_f}")
        return plan, res, run_s, counts, bits

    snap = config.snapshot()
    try:
        plan_h, _r, heap_s, cnt_h, bits_h = leg("off")
        if plan_h.pushdown != "raw" or cnt_h["b1"] == 0 or cnt_h["b2"]:
            raise AssertionError(f"heap leg: {plan_h}; launches {cnt_h}")
        plan_c, _r, chip_s, cnt_c, bits_c = leg("on")
        if plan_c.pushdown != "chip" or cnt_c["b1"] or \
                cnt_c["b2"] != cnt_c.get("nr_pushdown_decode_chip", -1) or \
                cnt_c["b2"] != cnt_c.get("nr_kernel_dispatch", -1) or \
                cnt_c["b2"] == 0:
            raise AssertionError(f"chip leg: {plan_c}; launches {cnt_c}")
        # what the rule picks on this run's measured rates, then the host
        # leg itself (forced when the rule picked otherwise)
        config.set("pushdown", "auto")
        config.set("pushdown_h2d_gbps", h2d_gbs)
        config.set("pushdown_ssd_gbps", read_gbs)
        auto = Query(path, schema).where(pred).aggregate([0, 1, 2, 3]) \
            .explain(device=dev).pushdown
        rates = dict(h2d=h2d_gbs, ssd=read_gbs) if auto == "host" \
            else dict(h2d=1000.0, ssd=1.0)
        plan_o, _r, host_s, cnt_o, bits_o = leg("auto", **rates)
        if plan_o.pushdown != "host" or cnt_o["b2"] or cnt_o["b1"] == 0 or \
                cnt_o["b1"] != cnt_o.get("nr_pushdown_decode_host", -1):
            raise AssertionError(f"host leg: {plan_o}; launches {cnt_o}")
    finally:
        config.restore(snap)
    if not bits_h == bits_c == bits_o:
        raise AssertionError(f"integer sums differ between legs: heap "
                             f"{bits_h} chip {bits_c} host {bits_o}")
    print(f"[7] pushdown: heap {heap_bytes} bytes, packed {cpk_bytes} bytes "
          f"({meta.rows_per_block} rows a block, "
          f"{'/'.join(codecs)}, ratio {meta.ratio:.3f}), encoded in "
          f"{encode_s:.2f} s")
    print(f"    heap leg (B1): {heap_s:.3f} s = {heap_bytes / heap_s / 1e9:.3f}"
          f" GB/s of table; {cnt_h['b1']} B1 launches")
    print(f"    chip leg (B2): {chip_s:.3f} s = {heap_bytes / chip_s / 1e9:.3f}"
          f" GB/s of table; {cnt_c['b2']} B2 launches = "
          f"{cnt_c['nr_kernel_dispatch']} batches")
    print(f"    host leg (host decode, B1): {host_s:.3f} s = "
          f"{heap_bytes / host_s / 1e9:.3f} GB/s of table; {cnt_o['b1']} B1 "
          f"launches")
    print(f"    rule on this run's rates (h2d {h2d_gbs:.3f}, SSD "
          f"{read_gbs:.3f} GB/s): {auto}; faster leg: "
          f"{'chip' if chip_s < host_s else 'host'}; count {want_count} and "
          f"integer sums match numpy and are identical on all three legs")
    ring = _first_batch(torch, dev, meta.path)
    os.unlink(path)
    os.unlink(meta.path)
    return cnt_c["b2"], ring, meta, pred


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
    from nvme_strom_tpu_torch.ops import decode_cuda, filter_cuda, groupby_cuda
    from nvme_strom_tpu_torch.ops.decode import make_decode_filter_fn
    from nvme_strom_tpu_torch.ops.filter import (DEFAULT_SCHEMA, STEP_PRED,
                                                 FilterPred, scan_filter_step)
    from nvme_strom_tpu_torch.ops.groupby import GroupKey, make_groupby_fn
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

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        worst_f = _filter_cases(torch, dev, args.seed)
        print(f"[3a] B1 vs plain: all cases agree (max |float err| "
              f"{worst_f:.3g})")
        worst_g, share_g = _groupby_cases(torch, dev, args.seed)
        print(f"[3b] B3 vs plain: all cases agree (max |float err| "
              f"{worst_g:.3g}; the largest error is {share_g:.1%} of its "
              f"tolerance)")
        worst_d = _decode_cases(torch, dev, args.seed, tmp)
        print(f"[3c] B2 vs plain: all cases agree (max |float err| "
              f"{worst_d:.3g})")

        # -- main path: load -------------------------------------------
        filter_cuda.launches = groupby_cuda.launches = 0
        decode_cuda.launches = 0
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
              f"reached {out['depth']}; kernel launches "
              f"{filter_cuda.launches + groupby_cuda.launches + decode_cuda.launches}"
              f" (none on this path)")
        del out
        drop_page_cache(load_path)
        print(f"    yardstick: raw O_DIRECT read of the same file "
              f"{measure_raw(load_path, load_bytes):.3f} GB/s")
        os.unlink(load_path)

        # -- main path: scan -------------------------------------------
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
        read_gbs = table_bytes / read_s / 1e9
        drop_page_cache(heap_path)
        filter_cuda.launches = groupby_cuda.launches = 0
        decode_cuda.launches = 0
        stats.reset()
        # the scanner's set-up (session, pinned pool) is timed apart: a
        # Query.run() pays it inside its own time
        t0 = time.monotonic()
        with TableScanner(heap_path) as sc:
            setup_s = time.monotonic() - t0
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
              f"{read_gbs:.3f} GB/s; scanner set-up, not in the scan's "
              f"time: {setup_s * 1e3:.1f} ms")
        filter_ring = _first_batch(torch, dev, heap_path)
        os.unlink(heap_path)
        h2d = measure_h2d(dev)

        # -- main paths: GROUP BY, then the packed-sidecar aggregate -----
        gb_launches, gb_ring, gb_schema, gb_pred = _groupby_path(
            torch, dev, tmp, args.seed, args.scan_pages)
        dec_launches, dec_ring, meta, dec_pred = _pushdown_path(
            torch, dev, tmp, args.seed, args.scan_pages, read_gbs, h2d)

        # -- times at the main paths' batch shapes ------------------------
        # the bare launch (prebuilt spec and outputs) times each kernel;
        # the wrapper's time adds its per-call host work
        for b in filter_ring:
            filter_cuda.scan_filter_step_cuda(b, th)
        spec = filter_cuda._spec(DEFAULT_SCHEMA, STEP_PRED, th)
        outb = torch.zeros(4, dtype=torch.int32, device=dev)
        f_ms = _time_ms(
            torch, lambda i: filter_cuda.launch(
                filter_ring[i % 8], spec, outb[:1], outb[1:3],
                outb[3:].view(torch.float32)), 256)
        f_wrap_ms = _time_ms(
            torch, lambda i: filter_cuda.scan_filter_step_cuda(
                filter_ring[i % 8], th), 64)
        scan_filter_step(filter_ring[0], th)
        f_plain_ms = _time_ms(
            torch, lambda i: scan_filter_step(filter_ring[i % 8], th), 16)
        # B1 reads every region of the default schema's pages, and writes
        # its count and sum banks (four words)
        f_bytes = _groupby_bytes(DEFAULT_SCHEMA, GroupKey(0),
                                 range(DEFAULT_SCHEMA.n_cols), None,
                                 SCAN_BATCH_PAGES) + 16
        f_bound_ms = f_bytes / HBM_BYTES_PER_S * 1e3

        # B3 at both GROUP BY queries' batches: the kernel against the
        # plain version on the first batch, then timed; the first query
        # goes in the table
        i32, f32 = np.dtype(np.int32), np.dtype(np.float32)
        gb_times = []
        for name, key, G, agg, dt, pred in (
                ("i32 G=64 c1 % 64 where c0 > 100", GroupKey(1, 64), 64,
                 [0, 2], i32, gb_pred),
                ("f32 G=8 abs(c1) % 8", GroupKey(1, 8, absolute=True), 8,
                 [4, 5], f32, None)):
            plain = make_groupby_fn(gb_schema, key, G, agg_cols=agg,
                                    predicate=pred)
            want = plain(gb_ring[0])
            got = groupby_cuda.groupby_pages_cuda(
                gb_ring[0], 0, gb_schema, key, G, agg_cols=agg,
                predicate=pred)
            torch.cuda.synchronize(dev)
            m1, m2 = _group_mags(torch, gb_ring[0], gb_schema, key, G, agg,
                                 pred)
            w, r = _same_groups(torch, f"[8] B3 {name}", got, want, m1, m2)
            worst_g, share_g = max(worst_g, w), max(share_g, r)
            gspec = groupby_cuda._spec(gb_schema, key, G, agg, dt,
                                       pred or FilterPred(), 0)
            buf = groupby_cuda.new_outputs(G, len(agg), dt, dev)
            for b in gb_ring:
                groupby_cuda.launch(b, gspec, dt, buf)
            g_ms = _time_ms(torch, lambda i: groupby_cuda.launch(
                gb_ring[i % 8], gspec, dt, buf), 128)
            g_plain_ms = _time_ms(torch, lambda i: plain(gb_ring[i % 8]), 8)
            tuples = SCAN_BATCH_PAGES * gb_schema.tuples_per_page
            g_bytes = _groupby_bytes(gb_schema, key, agg, pred,
                                     SCAN_BATCH_PAGES) \
                + 4 * G + 4 * 4 * G * len(agg)
            # per tuple: visibility, key (abs, mod), each predicate term,
            # the count; per aggregated value sum, square, sumsq, min, max
            ops = tuples * (3 + (len(pred.terms) if pred else 0) + 1
                            + 5 * len(agg))
            g_bound_ms = max(g_bytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3
            gb_times.append((name, g_ms, g_plain_ms, g_bound_ms, g_bytes))

        # B2 over the packed table's first batch (its header page leads):
        # the kernel against the plain version, then timed
        dplain = make_decode_filter_fn(meta, dec_pred)
        want = dplain(dec_ring[0])
        got = decode_cuda.decode_filter_pages_cuda(dec_ring[0], 0, meta,
                                                   dec_pred)
        torch.cuda.synchronize(dev)
        worst_d = max(worst_d, _same_decode(
            torch, "[8] B2 main-path batch", got, want, dec_ring[0], meta,
            dec_pred, None))
        ni = sum(np.dtype(d).kind != "f" for d in meta.dtypes)
        dspec = decode_cuda._spec(meta, dec_pred, None, 0)
        dout = torch.zeros(1 + ni + 1, dtype=torch.int32, device=dev)
        for b in dec_ring:
            decode_cuda.launch(b, dspec, dout[:1], dout[1:1 + ni],
                               dout[1 + ni:].view(torch.float32))
        d_ms = _time_ms(torch, lambda i: decode_cuda.launch(
            dec_ring[i % 8], dspec, dout[:1], dout[1:1 + ni],
            dout[1 + ni:].view(torch.float32)), 256)
        d_plain_ms = _time_ms(torch, lambda i: dplain(dec_ring[i % 8]), 8)
        rows = SCAN_BATCH_PAGES * meta.rows_per_block
        n_c = len(meta.cols)
        # per row: each column's decode (shift, mask, add), each term, the
        # count, each column's masked add
        d_ops = rows * (3 * n_c + len(dec_pred.terms) + 1 + n_c)
        d_bytes = _decode_bytes(torch, dec_ring[0], meta, None) \
            + 4 * (1 + n_c)
        d_bound_ms = max(d_bytes / HBM_BYTES_PER_S,
                         d_ops / F32_OPS_PER_S) * 1e3

        print(f"[8] main-path batches: B3 (both queries) and B2 agree with "
              f"their plain versions (B3 max |float err| {worst_g:.3g}, "
              f"{share_g:.1%} of its tolerance at most; B2 max |float err| "
              f"{worst_d:.3g})")
        print(f"    times at the main paths' batch shape ({SCAN_BATCH_PAGES}"
              f", {PAGE_SIZE}) uint8, bare launches over 8 distinct batches;"
              f" bounds from the bytes each kernel must read:")
        print(f"    B1 filter_pages: {f_ms:.4f} ms (bound {f_bound_ms:.4f} ms "
              f"by {f_bytes} bytes = {f_bound_ms / f_ms:.1%}); wrapper call "
              f"{f_wrap_ms:.4f} ms; plain {f_plain_ms:.4f} ms")
        for name, g_ms, g_plain_ms, g_bound_ms, g_bytes in gb_times:
            print(f"    B3 groupby_pages {name}: {g_ms:.4f} ms (bound "
                  f"{g_bound_ms:.4f} ms by {g_bytes} bytes = "
                  f"{g_bound_ms / g_ms:.1%}); plain {g_plain_ms:.4f} ms")
        print(f"    B2 decode_filter_pages ({meta.rows_per_block} rows a "
              f"block): {d_ms:.4f} ms (bound {d_bound_ms:.4f} ms by "
              f"{d_bytes} bytes = {d_bound_ms / d_ms:.1%}); plain "
              f"{d_plain_ms:.4f} ms")
        print(f"    pinned h2d {h2d:.3f} GB/s; total "
              f"{time.monotonic() - t_start:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    g = gb_times[0]
    table = {"kernels": [{
        "name": "filter_pages",
        "route": "cuda",
        "source": "nvme_strom_tpu_torch/csrc/filter.cu",
        "replaces": "nvme_strom_tpu/ops/filter_pallas.py:140",
        "launches": main_launches,
        "max_abs_err": worst_f,
        "ms": f_ms,
        "plain_ms": f_plain_ms,
        "bound_ms": f_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "groupby_pages",
        "route": "cuda",
        "source": "nvme_strom_tpu_torch/csrc/groupby.cu",
        "replaces": "nvme_strom_tpu/ops/groupby_pallas.py:270",
        "launches": gb_launches,
        "max_abs_err": worst_g,
        "ms": g[1],
        "plain_ms": g[2],
        "bound_ms": g[3],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "decode_filter_pages",
        "route": "cuda",
        "source": "nvme_strom_tpu_torch/csrc/decode.cu",
        "replaces": "nvme_strom_tpu/ops/decode_pallas.py:103",
        "launches": dec_launches,
        "max_abs_err": worst_d,
        "ms": d_ms,
        "plain_ms": d_plain_ms,
        "bound_ms": d_bound_ms,
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
