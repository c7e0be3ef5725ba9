"""Table scan of the PyTorch port against the JAX package on the same
heap file: ``TableScanner.scan_filter`` with the port's filter (the CUDA
wrapper, which runs its plain version for CPU tensors) against the JAX
scanner folding the Pallas kernel in interpret mode.  A multi-chunk table
at a 64 KB chunk size with a page tail past the chunk grid; counts and
integer sums exact, float sums within ``1e-5 * sum(|selected x|) +
1e-6`` (different summation order)."""

import errno
import warnings

import numpy as np
import pytest

from nvme_strom_tpu.ops.filter_pallas import (make_filter_fn_pallas,
                                              scan_filter_step_pallas)
from nvme_strom_tpu.scan.executor import TableScanner as JScanner
from nvme_strom_tpu.scan.executor import \
    cursor_chunk_count as j_cursor_chunk_count
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.filter_cuda import (make_filter_fn_cuda,
                                                  scan_filter_step_cuda)
from nvme_strom_tpu_torch.scan.executor import (TableScanner,
                                                cursor_chunk_count)
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.pool import DmaBufferPool, ResourceOwner

CHUNK = 64 << 10                  # 8 pages per chunk


def _table(tmp_path, schema, n_pages, seed):
    rng = np.random.default_rng(seed)
    n = schema.tuples_per_page * n_pages - 9
    cols = []
    for c in range(schema.n_cols):
        dt = schema.col_dtype(c)
        if dt.kind == "f":
            cols.append(rng.standard_normal(n).astype(dt))
        elif dt.kind == "u":
            cols.append(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                        .astype(dt))
        else:
            cols.append(rng.integers(-(1 << 30), 1 << 30, n).astype(dt))
    vis = (rng.random(n) > 0.25).astype(np.int32) \
        if schema.visibility else None
    path = str(tmp_path / "t.heap")
    build_heap_file(path, cols, schema, visibility=vis)
    return path, cols, vis


def test_scan_filter_matches_reference_scan(tmp_path):
    schema = HeapSchema(n_cols=2, visibility=True)
    path, (c0, c1), vis = _table(tmp_path, schema, 3 * 8 + 3, seed=2)
    th = 1 << 28
    with TableScanner(path, chunk_size=CHUNK, async_depth=2) as sc:
        got = sc.scan_filter(lambda p: scan_filter_step_cuda(p, th),
                             device="cpu")
        assert sc.last_batches == 4               # 3 chunks + the tail
    with JScanner(path, chunk_size=CHUNK, async_depth=2) as sc:
        ref = sc.scan_filter(lambda p: scan_filter_step_pallas(
            p, np.int32(th), interpret=True))
    sel = (vis != 0) & (c0 > th)
    assert int(got["count"]) == int(ref["count"]) == int(sel.sum())
    assert got["sum"].dtype == np.int32
    assert int(got["sum"]) == int(ref["sum"]) == int(
        np.uint32(c1[sel].astype(np.int64).sum() & 0xFFFFFFFF)
        .view(np.int32))


def test_typed_scan_folds_like_reference(tmp_path):
    kw = dict(n_cols=3, visibility=True,
              dtypes=("float32", "uint32", "int32"))
    schema = HeapSchema(**kw)
    path, (f, u, i), vis = _table(tmp_path, schema, 2 * 8 + 5, seed=3)
    run = make_filter_fn_cuda(schema, FilterPred(((0, "gt", None),)))
    with TableScanner(path, chunk_size=CHUNK) as sc:
        got = sc.scan_filter(lambda p: run(p, -0.5), device="cpu")
    jrun = make_filter_fn_pallas(JSchema(**kw), lambda c, th: c[0] > th,
                                 interpret=True)
    with JScanner(path, chunk_size=CHUNK) as sc:
        ref = sc.scan_filter(lambda p: jrun(p, np.float32(-0.5)))
    sel = (vis != 0) & (f > np.float32(-0.5))
    assert int(got["count"]) == int(ref["count"]) == int(sel.sum())
    assert got["sums"][1].dtype == np.uint32
    assert int(got["sums"][1]) == int(ref["sums"][1]) == int(
        u[sel].astype(np.uint64).sum() & 0xFFFFFFFF)
    assert int(got["sums"][2]) == int(ref["sums"][2])
    tol = 1e-5 * float(np.abs(f[sel].astype(np.float64)).sum()) + 1e-6
    assert abs(float(got["sums"][0]) - float(ref["sums"][0])) <= tol


def test_batches_deliver_file_pages_in_order(tmp_path):
    schema = HeapSchema(n_cols=1)
    path, _, _ = _table(tmp_path, schema, 2 * 8 + 2, seed=4)
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8).reshape(-1, 8192)
    seen = []
    with TableScanner(path, chunk_size=CHUNK, async_depth=3) as sc:
        for b in sc.batches():
            assert np.array_equal(b.pages, raw[b.first_page:b.first_page
                                               + len(b.pages)])
            seen.append((b.first_page, len(b.pages)))
        assert sc.pool.outstanding == 0
    assert seen == [(0, 8), (8, 8), (16, 2)]


@pytest.mark.parametrize("size", [0, CHUNK, 3 * CHUNK + 8192,
                                  3 * CHUNK + 100, 3 * CHUNK + 8192 + 1])
def test_cursor_chunk_count_matches_reference(size):
    assert cursor_chunk_count(size, CHUNK) == \
        j_cursor_chunk_count(size, CHUNK)


def test_scanner_rejects_bad_chunk_sizes(tmp_path):
    path, _, _ = _table(tmp_path, HeapSchema(n_cols=1), 8, seed=5)
    for bad in (CHUNK + 8192, 4096):
        with pytest.raises(StromError) as e:
            TableScanner(path, chunk_size=bad)
        assert e.value.errno == errno.EINVAL


def test_resource_owner_returns_leaked_chunks():
    with DmaBufferPool(total_size=4 * CHUNK, chunk_size=CHUNK) as pool:
        with pytest.raises(RuntimeError):
            with ResourceOwner("abort") as owner:
                pool.alloc(owner=owner)
                raise RuntimeError("scan aborted")
        assert pool.outstanding == 0
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with ResourceOwner("leak") as owner:
                pool.alloc(owner=owner)
        assert pool.outstanding == 0
        assert any(issubclass(x.category, ResourceWarning) for x in w)
        with pytest.raises(StromError) as e:
            for _ in range(5):
                pool.alloc(timeout=0.01)
        assert e.value.errno == errno.ETIMEDOUT
