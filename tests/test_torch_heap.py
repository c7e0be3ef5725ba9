"""Heap format of the PyTorch port against the JAX package: the schema
carried across with ``from_fields``, the same layout, and byte-identical
files from the same numpy columns (one file then serves both packages)."""

import dataclasses

import numpy as np
import pytest

from nvme_strom_tpu.scan import heap as jheap
from nvme_strom_tpu_torch.scan import heap as theap

SCHEMAS = {
    "int32_vis": dict(n_cols=2, visibility=True),
    "int32_novis": dict(n_cols=3),
    "typed_vis": dict(n_cols=3, visibility=True,
                      dtypes=("float32", "uint32", "int32")),
    "uint32": dict(n_cols=1, dtypes=("uint32",)),
    "nullable": dict(n_cols=2, visibility=True, dtypes=("int32", "float32"),
                     nullable=(True, False)),
    "int64_wide": dict(n_cols=2, visibility=True, dtypes=("int64", "int32")),
}


def _pair(kw):
    js = jheap.HeapSchema(**kw)
    return js, theap.HeapSchema.from_fields(dataclasses.asdict(js))


def _columns(rng, schema, n):
    cols = []
    for c in range(schema.n_cols):
        dt = schema.col_dtype(c)
        if dt.kind == "f":
            cols.append(rng.standard_normal(n).astype(dt))
        elif dt.kind == "u":
            cols.append(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                        .astype(dt))
        else:
            cols.append(rng.integers(-(1 << 20), 1 << 20, n).astype(dt))
    return cols


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_from_fields_layout_matches(name):
    js, ts = _pair(SCHEMAS[name])
    assert ts.tuples_per_page == js.tuples_per_page
    for c in range(js.n_cols):
        assert ts.col_word_range(c) == js.col_word_range(c)
        assert ts.col_dtype(c) == js.col_dtype(c)
        if js.col_nullable(c):
            assert ts.validity_word_range(c) == js.validity_word_range(c)
    if js.visibility:
        assert ts.col_word_range(js.n_cols) == js.col_word_range(js.n_cols)
    assert (ts.wide_mask, ts.null_mask) == (js.wide_mask, js.null_mask)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_build_heap_file_byte_identical(name, tmp_path):
    js, ts = _pair(SCHEMAS[name])
    rng = np.random.default_rng(sorted(SCHEMAS).index(name))
    n = js.tuples_per_page * 3 + 17          # a partial last page
    cols = _columns(rng, js, n)
    vis = (rng.random(n) > 0.3).astype(np.int32) if js.visibility else None
    nulls = {c: rng.random(n) < 0.2 for c in range(js.n_cols)
             if js.col_nullable(c)} or None
    pj, pt = tmp_path / "j.heap", tmp_path / "t.heap"
    nj = jheap.build_heap_file(str(pj), cols, js, visibility=vis,
                               nulls=nulls)
    nt = theap.build_heap_file(str(pt), cols, ts, visibility=vis,
                               nulls=nulls)
    assert nj == nt == 4
    assert pj.read_bytes() == pt.read_bytes()


def test_empty_table_byte_identical():
    js, ts = _pair(SCHEMAS["int32_vis"])
    cols = [np.zeros(0, np.int32)] * 2
    assert theap.build_pages(cols, ts).tobytes() == \
        jheap.build_pages(cols, js).tobytes()


def test_numpy_crc32c_matches_reference_checksum():
    """The vectorised slicing-by-4 crc32c (used where no C crc32c is
    installed) equals the JAX package's per-page checksum."""
    rng = np.random.default_rng(3)
    pages = rng.integers(0, 256, (5, theap.PAGE_SIZE), dtype=np.uint8)
    got = theap.crc32c_rows(pages, block=2)
    assert [int(x) for x in got] == \
        [jheap.crc32c(p.tobytes()) for p in pages]


@pytest.mark.parametrize("name", ["typed_vis", "int64_wide"])
def test_read_column_and_pages_from_bytes_match_reference(name):
    js, ts = _pair(SCHEMAS[name])
    rng = np.random.default_rng(8)
    n = ts.tuples_per_page * 3 + 17
    cols = [rng.integers(-9, 9, n).astype(ts.col_dtype(c))
            for c in range(ts.n_cols)]
    raw = theap.build_pages(cols, ts).tobytes()
    tp, jp = theap.pages_from_bytes(raw), jheap.pages_from_bytes(raw)
    assert tp.shape == jp.shape == (4, theap.PAGE_SIZE)
    for c in range(ts.n_cols):
        got = theap.read_column(tp, ts, c)
        want = jheap.read_column(jp, js, c)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want) and np.array_equal(got, cols[c])
