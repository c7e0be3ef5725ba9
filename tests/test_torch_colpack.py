"""Packed (.cpk) format of the PyTorch port against the JAX package: the
port's vectorised encoder writes byte-identical files to the JAX
``build_packed`` on the same table and codecs, and the two numpy decoders
return the same rows.  Everything here is exact."""

import os

import numpy as np
import pytest

from nvme_strom_tpu.scan import colpack as jcp
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.scan import colpack as tcp
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file


def _cols(rng, n):
    return {
        "mix": ((rng.integers(0, 16, n).astype(np.int32),
                 (rng.integers(0, 8, n) * 100).astype(np.int32),
                 (np.arange(n) // 700).astype(np.uint32),
                 rng.standard_normal(n).astype(np.float32)),
                ("int32", "int32", "uint32", "float32")),
        "bits1_32768": ((rng.integers(0, 2, n).astype(np.int32),),
                        ("int32",)),
        "runs": (((np.arange(n) // 3000).astype(np.int32),
                  (np.arange(n) // 5000 + 7).astype(np.int32)),
                 ("int32", "int32")),
        "wide_span": ((rng.integers(-100, 100, n).astype(np.int32),
                       rng.integers(0, 1 << 32, n, dtype=np.uint64)
                       .astype(np.uint32)), ("int32", "uint32")),
        "bits16": ((rng.integers(1000, 60000, n).astype(np.int32),
                    rng.integers(0, 250, n).astype(np.int32),
                    rng.integers(0, 4, n).astype(np.int32)),
                   ("int32", "int32", "int32")),
    }


def _table(tmp_path, name, n=23000, seed=0, vis=True):
    rng = np.random.default_rng(seed)
    cols, dts = _cols(rng, n)[name]
    kw = dict(n_cols=len(cols), visibility=vis, dtypes=dts)
    path = str(tmp_path / f"{name}.heap")
    build_heap_file(path, list(cols), HeapSchema(**kw),
                    visibility=(rng.random(n) > 0.2).astype(np.int32)
                    if vis else None)
    return path, HeapSchema(**kw), JSchema(**kw)


@pytest.mark.parametrize("codecs", [None, ("bitpack",), ("dict",), ("rle",),
                                    ()])
@pytest.mark.parametrize("name", ["mix", "bits1_32768", "runs", "wide_span",
                                  "bits16"])
def test_build_packed_bytes_identical_to_jax(tmp_path, name, codecs):
    path, ts, js = _table(tmp_path, name)
    kw = {} if codecs is None else {"codecs": codecs}
    tm = tcp.build_packed(path, ts, out_path=path + ".t", **kw)
    jm = jcp.build_packed(path, js, out_path=path + ".j", **kw)
    with open(path + ".t", "rb") as a, open(path + ".j", "rb") as b:
        assert a.read() == b.read()
    assert tm.rows_per_block == jm.rows_per_block
    assert [c.codec for c in tm.cols] == [c.codec for c in jm.cols]
    raw = np.fromfile(path + ".t", np.uint8)
    got, n = tcp.decode_pages_numpy(raw, tm)
    want, m = jcp.decode_pages_numpy(raw, jm, verify=True)   # block crcs
    assert n == m == tm.n_rows
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_32768_row_blocks_and_partial_tail(tmp_path):
    path, ts, js = _table(tmp_path, "bits1_32768", n=70001, vis=False)
    tm = tcp.build_packed(path, ts)
    assert tm.rows_per_block == 32768 and tm.n_blocks == 3
    jm = jcp.build_packed(path, js, out_path=path + ".j")
    with open(tm.path, "rb") as a, open(path + ".j", "rb") as b:
        assert a.read() == b.read()


def test_empty_and_tiny_tables(tmp_path):
    for n in (0, 5):
        kw = dict(n_cols=1, dtypes=("int32",))
        path = str(tmp_path / f"t{n}.heap")
        build_heap_file(path, [np.arange(n, dtype=np.int32)],
                        HeapSchema(**kw))
        tcp.build_packed(path, HeapSchema(**kw), out_path=path + ".t")
        jcp.build_packed(path, JSchema(**kw), out_path=path + ".j")
        with open(path + ".t", "rb") as a, open(path + ".j", "rb") as b:
            assert a.read() == b.read()


def test_default_codecs_come_from_config(tmp_path):
    path, ts, _js = _table(tmp_path, "mix")
    snap = config.snapshot()
    try:
        config.set("pushdown_codecs", "rle")
        m = tcp.build_packed(path, ts)
        assert [c.codec for c in m.cols] == ["raw", "raw", "rle", "raw"]
        with pytest.raises(ValueError):
            config.set("pushdown_codecs", "zstd")
    finally:
        config.restore(snap)


def test_meta_roundtrip_and_freshness(tmp_path):
    path, ts, _js = _table(tmp_path, "runs")
    assert tcp.probe_packed(path) is None
    m = tcp.build_packed(path, ts)
    assert m.path == tcp.packed_path_for(path)
    got = tcp.probe_packed(path)
    assert got == m
    assert got.ratio > 1 and got.cols[0].ratio > 1
    jm = jcp.load_meta(m.path)
    assert (jm.rows_per_block, jm.n_rows, jm.dtypes) == \
        (m.rows_per_block, m.n_rows, m.dtypes)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    assert tcp.probe_packed(path) is None


# ---------------------------------------------------------------------------
# packed extents in the residency tiers (the counterparts of
# test_pushdown.py's residency tests)
# ---------------------------------------------------------------------------

@pytest.fixture()
def _tiers_reset():
    from nvme_strom_tpu.cache import residency_cache as jrc
    from nvme_strom_tpu.config import config as jcfg
    from nvme_strom_tpu_torch.testing import reset_residency
    snap, jsnap = config.snapshot(), jcfg.snapshot()
    reset_residency()
    yield
    config.restore(snap)
    jcfg.restore(jsnap)
    jrc.clear()
    jrc.configure()
    reset_residency()


def _mixed(dirpath, n):
    rng = np.random.default_rng(3)
    cols = [(np.arange(n) % 16).astype(np.int32),
            np.repeat(np.arange((n + 511) // 512, dtype=np.int32) % 6,
                      512)[:n],
            rng.integers(0, 50, n).astype(np.int32)]
    schema = HeapSchema(3, dtypes=("i4",) * 3)
    path = os.path.join(dirpath, "t.tbl")
    build_heap_file(path, cols, schema)
    return path, cols


def _packed_churn(pkg, path, cols):
    """The reference's churn-then-recover pass through package *pkg*:
    ``(results, evictions in churn, hits on the resident pass, resident
    bytes, logical resident bytes)``."""
    if pkg == "torch":
        from nvme_strom_tpu_torch.cache import residency_cache as rc
        from nvme_strom_tpu_torch.config import config as cfg
        from nvme_strom_tpu_torch.scan.query import Query
        from nvme_strom_tpu_torch.stats import stats
        schema, run = HeapSchema(3, dtypes=("i4",) * 3), {"device": "cpu"}
        counters = stats.snapshot
        meta = tcp.build_packed(path, schema)
    else:
        from nvme_strom_tpu.cache import residency_cache as rc
        from nvme_strom_tpu.config import config as cfg
        from nvme_strom_tpu.scan.query import Query
        from nvme_strom_tpu.stats import stats
        schema, run = JSchema(3, dtypes=("i4",) * 3), {}

        def counters():
            return dict(stats.snapshot(reset_max=False).counters)
        meta = jcp.build_packed(path, schema)
    q = Query(path, schema).where(lambda c: c[0] > 7).aggregate([1, 2])
    for k, v in (("pushdown", "on"), ("chunk_size", 64 << 10),
                 ("cache_arbitration", False), ("debug_no_threshold", True),
                 ("cache_bytes", 2 * (64 << 10))):
        cfg.set(k, v)
    rc.configure()
    rc.clear()
    results, b = [], counters()
    for _ in range(2):
        out = q.run(**run)
        results.append((int(out["count"]), int(out["sums"][0]),
                        int(out["sums"][1])))
    evicted = counters().get("nr_cache_evict", 0) - b.get("nr_cache_evict", 0)
    cfg.set("cache_bytes", 2 * meta.packed_bytes + (1 << 20))
    rc.configure()
    q.run(**run)
    b = counters()
    out = q.run(**run)
    results.append((int(out["count"]), int(out["sums"][0]),
                    int(out["sums"][1])))
    hits = counters().get("nr_cache_hit", 0) - b.get("nr_cache_hit", 0)
    return (results, evicted > 0, hits, rc.resident_bytes(),
            rc.logical_resident_bytes(), q.explain(**run).pushdown)


def test_packed_cache_hit_after_eviction_churn(tmp_path, _tiers_reset):
    """Packed extents are cached under a representation-tagged key: churn
    evicts them, a rescan fills them again and the next pass hits, with
    the tier crediting the logical bytes they serve."""
    path, cols = _mixed(str(tmp_path), 200_000)
    mask = cols[0] > 7
    want = (int(mask.sum()), int(cols[1][mask].sum()),
            int(cols[2][mask].sum()))
    ref = _packed_churn("jax", path, cols)
    mine = _packed_churn("torch", path, cols)
    results, churned, hits, res, lres, pd = mine
    assert results == [want] * 3
    assert churned and hits > 0
    assert lres > res > 0
    assert (results, churned, hits, res, lres, pd) == ref


def test_packed_and_heap_cache_keys_disjoint(tmp_path):
    """The representation tag keeps a table's packed and heap extents
    apart in the tiers, under the reference's key."""
    from nvme_strom_tpu.engine import open_source as jopen
    from nvme_strom_tpu.tiering import source_key as jkey
    from nvme_strom_tpu_torch.engine import open_source
    from nvme_strom_tpu_torch.scan.query import _tag_packed
    from nvme_strom_tpu_torch.tiering import source_key
    path, _ = _mixed(str(tmp_path), 20_000)
    meta = tcp.build_packed(path, HeapSchema(3, dtypes=("i4",) * 3))
    with open_source(path) as heap_src, jopen(path) as jheap:
        hk = source_key(heap_src)
        assert hk == jkey(jheap)
    with open_source(tcp.packed_path_for(path)) as pk_src, \
            jopen(tcp.packed_path_for(path)) as jpk:
        _tag_packed(pk_src, meta)
        jpk.cache_key_extra = ("#repr=cpk", f"#gen={meta.table_mtime_ns}")
        pk = source_key(pk_src)
        assert pk == jkey(jpk)
        assert pk_src.logical_scale == meta.logical_bytes / meta.packed_bytes
    assert hk != pk and "#repr=cpk" in pk
