"""The port's index access paths (``scan/index.py``: the sorted sidecars,
``build_index``/``open_index``/``probe_index``/``SortedIndex``;
``scan/query.py``: ``where_eq``/``where_in``/``where_range``, the residual
recheck, ``QueryPlan.access_path``, the index runners, the sidecar-served
terminals) against the JAX package's on the same heap file and the same
sidecars.  Each test mirrors one of ``tests/test_index.py``; the two mesh
builds (``:197``, ``:997``) run over the port's ``(sp, dp)`` meshes of CPU
members against the JAX package's virtual-device meshes.  The port runs with ``device="cpu"``
(its ``torch`` route), the JAX package on its CPU backend, both at 64 KiB
chunks, the JAX package with ``debug_no_threshold`` so that it plans the
direct scan as the port does.

Tolerances: counts, integer sums (int32 wraps mod 2^32), values,
positions and row orders bit-identical (positions compared as int64: the
port's dtype, the JAX package's under x64); float32 sums within
``1e-5 * sum(|x|) + 1e-6``."""

import errno
import os

import numpy as np
import pytest
import torch

from nvme_strom_tpu.api import StromError as JStromError
from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.index import build_index as jbuild_index
from nvme_strom_tpu.scan.index import open_index as jopen_index
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.groupby import GroupKey
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.index import (build_index, index_path_for,
                                             open_index, pack_pair,
                                             probe_index)
from nvme_strom_tpu_torch.scan.query import Query
from nvme_strom_tpu_torch.stats import stats

CPU = "cpu"


@pytest.fixture(autouse=True)
def configs():
    """64 KiB chunks and the direct scan on both sides, restored after."""
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    config.set("chunk_size", 1 << 16)
    jconfig.set("chunk_size", 1 << 16)
    config.set("debug_no_threshold", True)
    jconfig.set("debug_no_threshold", True)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


def _schemas(**kw):
    return HeapSchema(**kw), JSchema(**kw)


@pytest.fixture()
def table(tmp_path):
    """16 pages of two int32 columns: c0 200 values (many duplicates),
    c1 -1000..999."""
    rng = np.random.default_rng(23)
    schema, js = _schemas(n_cols=2, visibility=False)
    n = schema.tuples_per_page * 16
    c0 = rng.integers(0, 200, n).astype(np.int32)
    c1 = rng.integers(-1000, 1000, n).astype(np.int32)
    path = str(tmp_path / "t.heap")
    build_heap_file(path, [c0, c1], schema)
    return path, schema, js, c0, c1


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iu" and b.dtype.kind in "iu" and \
            {a.dtype.itemsize, b.dtype.itemsize} == {4, 8}:
        a, b = a.astype(np.int64), b.astype(np.int64)   # positions
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same(got: dict, want: dict, keys=None):
    """Every key of the JAX result (or *keys*) equal in the port's."""
    for k in keys or want:
        if isinstance(want[k], list):
            assert len(got[k]) == len(want[k]), k
            for a, b in zip(got[k], want[k]):
                _eq(a, b)
        else:
            _eq(got[k], want[k])


def _f_close(got, want, mag):
    """float32 sums within 1e-5 * sum(|x|) + 1e-6."""
    assert np.all(np.abs(np.asarray(got, np.float64)
                         - np.asarray(want, np.float64))
                  <= 1e-5 * np.asarray(mag, np.float64) + 1e-6)


def _cold(path):
    fd = os.open(path, os.O_RDONLY)
    os.fsync(fd)
    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    os.close(fd)


def _both(path, schema, js, make):
    """``make(q)`` on a port Query and a JAX Query of *path*: (port plan,
    port result, JAX plan, JAX result)."""
    q, jq = make(Query(path, schema)), make(JQuery(path, js))
    plan, jplan = q.explain(device=CPU), jq.explain()
    return plan, q.run(device=CPU), jplan, jq.run()


# -- the sidecar --------------------------------------------------------------

def test_build_lookup_range_fetch(table):
    path, schema, js, c0, c1 = table
    ipath = build_index(path, schema, 0, device=CPU)
    assert ipath == path + ".idx0"
    idx = open_index(ipath, table_path=path)
    jidx = jopen_index(ipath, table_path=path)
    assert idx.col == jidx.col == 0 and len(idx.keys) == len(c0)
    for key in (0, 57, 199):
        got = idx.lookup([key])
        _eq(got, jidx.lookup([key]))
        _eq(np.sort(got), np.flatnonzero(c0 == key))
    _eq(idx.lookup([3, 5]), jidx.lookup([3, 5]))
    _eq(np.sort(idx.lookup([3, 5])), np.flatnonzero((c0 == 3) | (c0 == 5)))
    assert len(idx.lookup([10**6])) == 0
    for inc, m in (("both", (c0 >= 50) & (c0 <= 60)),
                   ("left", (c0 >= 50) & (c0 < 60)),
                   ("right", (c0 > 50) & (c0 <= 60)),
                   ("neither", (c0 > 50) & (c0 < 60))):
        got = idx.range(50, 60, inclusive=inc)
        _eq(got, jidx.range(50, 60, inclusive=inc))
        _eq(np.sort(got), np.flatnonzero(m))
    _eq(np.sort(idx.range(190, None)), np.flatnonzero(c0 >= 190))
    with pytest.raises(StromError) as e:
        idx.range(1, 2, inclusive="half")
    assert e.value.errno == errno.EINVAL
    # index scan: positions, then a page-targeted fetch of the rows
    out = idx.fetch(Query(path, schema), values=[57], device=CPU)
    want = jidx.fetch(JQuery(path, js), values=[57])
    _same(out, want)
    sel = np.flatnonzero(c0 == 57)
    _eq(np.sort(out["positions"]), sel)
    _eq(out["col1"][np.argsort(out["positions"])], c1[sel])
    assert out["valid"].all()


def test_index_scan_reads_only_matching_pages(table):
    """I/O proportional to the matches, not the table: the engine's byte
    counter against the unique pages touched, through one session."""
    from nvme_strom_tpu_torch.engine import Session
    path, schema, _js, c0, _c1 = table
    idx = open_index(build_index(path, schema, 0, device=CPU),
                     table_path=path)
    _cold(path)
    t = schema.tuples_per_page
    pos = idx.lookup([42])
    before = stats.snapshot().get("total_dma_length", 0)
    with Session() as sess:
        out = idx.fetch(Query(path, schema), values=[42], device=CPU,
                        session=sess)
    read = stats.snapshot().get("total_dma_length", 0) - before
    assert 0 < read <= len(np.unique(pos // t)) * 8192
    assert int(out["valid"].sum()) == int((c0 == 42).sum())


def test_index_staleness_and_float_nan(tmp_path):
    schema, js = _schemas(n_cols=1, visibility=False, dtypes=("float32",))
    rng = np.random.default_rng(5)
    n = schema.tuples_per_page * 2
    f = rng.standard_normal(n).astype(np.float32)
    f[::50] = np.nan                        # NaN keys are left out
    f[1], f[2] = -0.0, 0.0                  # equal keys, build order
    path = str(tmp_path / "f.heap")
    build_heap_file(path, [f], schema)
    ipath = build_index(path, schema, 0, device=CPU)
    idx = open_index(ipath, table_path=path)
    assert len(idx.keys) == int((~np.isnan(f)).sum())
    got = idx.range(0.0, None)
    _eq(got, jopen_index(ipath, table_path=path).range(0.0, None))
    _eq(np.sort(got), np.flatnonzero(f >= 0.0))
    _eq(idx.lookup([0.0]), np.array([1, 2]))     # -0.0 == 0.0
    # the table rewritten: the stale index is detected by both
    build_heap_file(path, [f * 2], schema)
    with pytest.raises(StromError, match="stale") as e:
        open_index(ipath, table_path=path)
    assert e.value.errno == errno.ESTALE
    with pytest.raises(JStromError, match="stale"):
        jopen_index(ipath, table_path=path)
    assert not probe_index(ipath, path)
    # an explicit opt-out still opens it
    assert open_index(ipath, table_path=path, check_stale=False).col == 0


# -- where_eq and the planner ----------------------------------------------

def test_where_eq_planner_picks_index_scan(table):
    path, schema, js, c0, c1 = table

    def sel(q):
        return q.where_eq(0, 42).select()

    plan, seq, jplan, jseq = _both(path, schema, js, sel)
    assert plan.access_path == jplan.access_path == "direct"
    _same(seq, jseq)
    build_index(path, schema, 0, device=CPU)
    plan, out, jplan, jout = _both(path, schema, js, sel)
    assert plan.access_path == jplan.access_path == "index"
    assert "index" in plan.reason and "42" in plan.reason
    assert "[index path" in str(plan)
    _same(out, jout)
    _eq(np.sort(out["positions"]), np.sort(seq["positions"]))
    _eq(np.sort(out["col1"]), np.sort(seq["col1"]))
    # limit slices the index order
    _p, lim, _jp, jlim = _both(path, schema, js,
                               lambda q: q.where_eq(0, 42).select(limit=3))
    _same(lim, jlim)
    assert int(lim["count"]) == 3 and (c0[lim["positions"]] == 42).all()
    # a join rides the index too
    keys = np.arange(0, 1000, dtype=np.int32)
    plan, jout, jplan, jjout = _both(
        path, schema, js, lambda q: q.where_eq(0, 42).join(1, keys, keys))
    assert plan.access_path == jplan.access_path == "index"
    _same(jout, jjout)
    assert int(jout["matched"]) == int(((c0 == 42) & (c1 >= 0)
                                        & (c1 < 1000)).sum())
    # a rewritten table: the stale index falls back to the scan silently
    build_heap_file(path, [c0, c1 + 1], schema)
    plan, out3, jplan, jout3 = _both(path, schema, js, sel)
    assert plan.access_path == jplan.access_path == "direct"
    _same(out3, jout3)
    _eq(out3["positions"], np.flatnonzero(c0 == 42))


def test_where_after_where_eq_composes_with_recheck(table):
    path, schema, js, c0, c1 = table
    build_index(path, schema, 0, device=CPU)
    q = Query(path, schema).where_eq(0, 42) \
        .where(FilterPred(((0, "gt", 100),))).select()
    jq = JQuery(path, js).where_eq(0, 42).where(lambda c: c[0] > 100) \
        .select()
    assert q.explain(device=CPU).access_path == "index" \
        == jq.explain().access_path
    out = q.run(device=CPU)
    assert len(out["positions"]) == 0
    _same(out, jq.run())
    q2 = Query(path, schema).where_eq(0, 42).where(lambda c: c[1] > 0) \
        .select()
    jq2 = JQuery(path, js).where_eq(0, 42).where(lambda c: c[1] > 0) \
        .select()
    out2 = q2.run(device=CPU)
    _same(out2, jq2.run())
    _eq(np.sort(out2["positions"]), np.flatnonzero((c0 == 42) & (c1 > 0)))


def test_corrupt_sidecar_falls_back_silently(table):
    path, schema, js, c0, _c1 = table
    ipath = build_index(path, schema, 0, device=CPU)
    with open(ipath, "wb") as f:
        f.write(b"garbage")
    plan, out, jplan, jout = _both(path, schema, js,
                                   lambda q: q.where_eq(0, 42).select())
    assert plan.access_path == jplan.access_path == "direct"
    _same(out, jout)
    _eq(out["positions"], np.flatnonzero(c0 == 42))


def test_where_eq_float_and_nonintegral_semantics(tmp_path):
    schema, js = _schemas(n_cols=2, visibility=False,
                          dtypes=("float32", "int32"))
    n = schema.tuples_per_page
    f = np.zeros(n, np.float32)
    f[5] = np.float32(0.1)
    i = np.arange(n, dtype=np.int32)
    path = str(tmp_path / "fe.heap")
    build_heap_file(path, [f, i], schema)

    def point(q):
        return q.where_eq(0, 0.1).select()

    plan, seq, _jp, jseq = _both(path, schema, js, point)
    assert plan.kernel == "torch"
    _same(seq, jseq)
    assert int(seq["count"]) == 1 and seq["positions"][0] == 5
    build_index(path, schema, 0, device=CPU)
    plan, out, jplan, jout = _both(path, schema, js, point)
    assert plan.access_path == jplan.access_path == "index"
    _same(out, jout)
    assert int(out["count"]) == 1 and out["positions"][0] == 5
    # a non-integral literal against an int column: empty on both paths
    build_index(path, schema, 1, device=CPU)
    for make in (lambda q: q.where_eq(1, 7.5).select(),
                 lambda q: q.where_eq(1, 2**32).select()):
        plan, out, jplan, jout = _both(path, schema, js, make)
        assert plan.access_path == jplan.access_path == "index"
        assert int(out["count"]) == 0
        _same(out, jout)
    os.unlink(path + ".idx1")
    plan, out, _jp, jout = _both(path, schema, js,
                                 lambda q: q.where_eq(1, 7.5).select())
    assert plan.access_path == "direct" and int(out["count"]) == 0
    _same(out, jout)
    # out-of-range bounds clamp to open or to no row, never overflow
    for lo, hi, want in ((-2**40, 2**40, n), (2**40, None, 0),
                         (None, -2**40, 0)):
        _p, out, _jp, jout = _both(
            path, schema, js, lambda q: q.where_range(1, lo, hi).select())
        assert int(out["count"]) == want
        _same(out, jout)


def test_where_range_index_and_seqscan_agree(table):
    path, schema, js, c0, c1 = table
    cases = [(50, 60), (None, 10), (190, None), (7.5, 60.5)]

    def run_all():
        outs = []
        for lo, hi in cases:
            plan, out, jplan, jout = _both(
                path, schema, js,
                lambda q: q.where_range(0, lo, hi).select())
            assert plan.access_path == jplan.access_path
            _same(out, jout)
            outs.append((plan.access_path, out["positions"]))
        return outs

    seq = run_all()
    assert all(p == "direct" for p, _ in seq)
    build_index(path, schema, 0, device=CPU)
    idx = run_all()
    assert all(p == "index" for p, _ in idx)
    for (lo, hi), (_, s), (_, i) in zip(cases, seq, idx):
        m = np.ones(len(c0), bool)
        if lo is not None:
            m &= c0 >= lo
        if hi is not None:
            m &= c0 <= hi
        _eq(s, np.flatnonzero(m))
        _eq(np.sort(i), np.flatnonzero(m))
        # the index order: ascending key, physical order within a key
        _eq(i, np.flatnonzero(m)[np.argsort(c0[m], kind="stable")])
    _p, agg, _jp, jagg = _both(
        path, schema, js, lambda q: q.where_range(0, 50, 60).aggregate([1]))
    _same(agg, jagg)
    assert int(agg["count"]) == int(((c0 >= 50) & (c0 <= 60)).sum())
    with pytest.raises(StromError) as e:
        Query(path, schema).where_range(0)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(JStromError):
        JQuery(path, js).where_range(0)


def test_where_range_float_boundary_agrees_across_paths(tmp_path):
    schema, js = _schemas(n_cols=1, visibility=False, dtypes=("float32",))
    n = schema.tuples_per_page
    f = np.linspace(-1, 1, n).astype(np.float32)
    f[7] = np.float32(0.1)
    f[9], f[11] = -0.0, 0.0
    path = str(tmp_path / "fb.heap")
    build_heap_file(path, [f], schema)

    def upto(q):
        return q.where_range(0, None, 0.1).select()

    _p, seq, _jp, jseq = _both(path, schema, js, upto)
    _same(seq, jseq)
    build_index(path, schema, 0, device=CPU)
    plan, idx, jplan, jidx = _both(path, schema, js, upto)
    assert plan.access_path == jplan.access_path == "index"
    _same(idx, jidx)
    _eq(np.sort(idx["positions"]), seq["positions"])
    assert 7 in idx["positions"]
    # -0.0 and 0.0 are one key on both paths
    for make in (lambda q: q.where_eq(0, 0.0).select(),
                 lambda q: q.where_range(0, -0.0, 0.0).select()):
        plan, out, _jp, jout = _both(path, schema, js, make)
        assert plan.access_path == "index"
        _same(out, jout)
        assert {9, 11} <= set(out["positions"].tolist())


# -- the terminals over the index -------------------------------------------

def test_aggregate_rides_index_and_matches_seqscan(table):
    path, schema, js, c0, c1 = table

    def agg(q):
        return q.where_eq(0, 42).aggregate(cols=[1])

    plan, seq, jplan, jseq = _both(path, schema, js, agg)
    assert plan.access_path == jplan.access_path == "direct"
    _same(seq, jseq)
    build_index(path, schema, 0, device=CPU)
    q = agg(Query(path, schema))
    assert q.explain(device=CPU).access_path == "index"
    _cold(path)
    before = stats.snapshot().get("total_dma_length", 0)
    out = q.run(device=CPU)
    read = stats.snapshot().get("total_dma_length", 0) - before
    _same(out, seq)
    _same(out, agg(JQuery(path, js)).run())
    assert out["sums"][0].dtype == np.int32
    t = schema.tuples_per_page
    assert read <= len(np.unique(np.flatnonzero(c0 == 42) // t)) * 8192
    plan, rout, jplan, jrout = _both(
        path, schema, js, lambda q: q.where_range(0, 10, 20).aggregate(
            cols=[0, 1]))
    assert plan.access_path == jplan.access_path == "index"
    _same(rout, jrout)
    m = (c0 >= 10) & (c0 <= 20)
    assert int(rout["count"]) == int(m.sum())
    assert int(rout["sums"][1]) == int(c1[m].sum())


def test_topk_rides_index_and_matches_seqscan(table):
    path, schema, js, c0, c1 = table
    makes = {"k=8": lambda q: q.where_range(0, 40, 44).top_k(1, 8),
             "few": lambda q: q.where_eq(0, 42).top_k(1, 10**4),
             "smallest": lambda q: q.where_range(0, 40, 44).top_k(
                 1, 5, largest=False)}
    seq = {k: m(Query(path, schema)).run(device=CPU)
           for k, m in makes.items()}
    build_index(path, schema, 0, device=CPU)
    m = (c0 >= 40) & (c0 <= 44)
    for k, make in makes.items():
        plan, out, jplan, jout = _both(path, schema, js, make)
        assert plan.access_path == jplan.access_path == "index", k
        _same(out, jout)
        _eq(np.sort(out["values"]), np.sort(seq[k]["values"]))
    _eq(makes["k=8"](Query(path, schema)).run(device=CPU)["values"],
        np.sort(c1[m])[::-1][:8])
    few = makes["few"](Query(path, schema)).run(device=CPU)
    n = int((c0 == 42).sum())
    assert (few["positions"][n:] == -1).all()
    assert (few["values"][n:] == np.iinfo(np.int32).min).all()


def test_topk_index_tie_break_and_sentinel_match_kernel(tmp_path):
    schema, js = _schemas(n_cols=2, visibility=False)
    n = schema.tuples_per_page
    c0 = np.full(n, 3, np.int32)
    c1 = np.full(n, 77, np.int32)
    c1[10] = np.iinfo(np.int32).min            # a real sentinel value
    path = str(tmp_path / "tie.heap")
    build_heap_file(path, [c0, c1], schema)
    seq = Query(path, schema).where_eq(0, 3).top_k(1, 5).run(device=CPU)
    build_index(path, schema, 0, device=CPU)
    plan, out, jplan, jout = _both(path, schema, js,
                                   lambda q: q.where_eq(0, 3).top_k(1, 5))
    assert plan.access_path == jplan.access_path == "index"
    _same(out, seq)
    _same(out, jout)
    _eq(out["positions"], np.arange(5, dtype=np.int64))
    _p, few, _jp, jfew = _both(
        path, schema, js,
        lambda q: q.where_eq(0, 3).top_k(1, n + 5, largest=True))
    _same(few, jfew)
    assert int((few["positions"] == -1).sum()) == 5
    assert 10 in few["positions"]


@pytest.mark.parametrize("largest", [True, False],
                         ids=["largest", "smallest"])
@pytest.mark.parametrize("k", [9, 700])
def test_topk_index_face_ranks_special_floats_as_jax(tmp_path, largest, k):
    """The index face's top_k over a float32 column of NaN, -NaN, +-0.0,
    +-inf and normals ranks in XLA's total order, as the JAX package's
    index face and the port's own seqscan face do (k=700 passes the rows
    the filter keeps, so pads follow)."""
    schema, js = _schemas(n_cols=2, visibility=False,
                          dtypes=("int32", "float32"))
    n = schema.tuples_per_page * 3
    rng = np.random.default_rng(31)
    c0 = rng.integers(0, 20, n).astype(np.int32)
    special = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf],
                       np.float32)
    c1 = (rng.standard_normal(n) * 10).astype(np.float32)
    pick = rng.random(n) < 0.6
    c1[pick] = rng.choice(special, int(pick.sum()))
    assert (c1.view(np.uint32) == 0xFFC00000).any()      # a -NaN row
    path = str(tmp_path / "f.heap")
    build_heap_file(path, [c0, c1], schema)

    def make(q):
        return q.where_range(0, 3, 9).top_k(1, k, largest=largest)
    seq = make(Query(path, schema)).run(device=CPU)
    build_index(path, schema, 0, device=CPU)
    plan, out, jplan, jout = _both(path, schema, js, make)
    assert plan.access_path == jplan.access_path == "index"
    assert out["values"].dtype == jout["values"].dtype == np.float32
    _eq(out["values"].view(np.uint32), jout["values"].view(np.uint32))
    _eq(out["positions"], jout["positions"])
    _eq(out["values"].view(np.uint32), seq["values"].view(np.uint32))
    _eq(out["positions"], seq["positions"])


def test_nan_filter_keys_excluded_on_both_paths(tmp_path):
    schema, js = _schemas(n_cols=2, visibility=False,
                          dtypes=("float32", "int32"))
    n = schema.tuples_per_page
    f = np.linspace(0, 100, n).astype(np.float32)
    f[3] = f[17] = np.nan
    i = np.arange(n, dtype=np.int32)
    path = str(tmp_path / "nf.heap")
    build_heap_file(path, [f, i], schema)

    def agg(q):
        return q.where_range(0, 10, None).aggregate(cols=[1])

    _p, seq, _jp, jseq = _both(path, schema, js, agg)
    _same(seq, jseq)
    build_index(path, schema, 0, device=CPU)
    plan, out, jplan, jout = _both(path, schema, js, agg)
    assert plan.access_path == jplan.access_path == "index"
    _same(out, seq)
    _same(out, jout)
    m = np.nan_to_num(f, nan=-1) >= 10
    assert int(seq["count"]) == int(m.sum())
    assert int(seq["sums"][0]) == int(i[m].sum())


def test_quantiles_and_distinct_ride_index(table):
    path, schema, js, c0, c1 = table
    qs = [0.0, 0.5, 0.99]
    makes = {"q": lambda q: q.where_range(0, 40, 60).quantiles(1, qs),
             "d": lambda q: q.where_range(0, 40, 60).count_distinct(1),
             "empty": lambda q: q.where_eq(0, 500).quantiles(1, [0.5])}
    seq = {k: m(Query(path, schema)).run(device=CPU)
           for k, m in makes.items()}
    build_index(path, schema, 0, device=CPU)
    for k, make in makes.items():
        plan, out, jplan, jout = _both(path, schema, js, make)
        assert plan.access_path == jplan.access_path == "index", k
        _same(out, jout)
        _same(out, seq[k])
    m = (c0 >= 40) & (c0 <= 60)
    sv = np.sort(c1[m])
    _eq(seq["q"]["quantiles"],
        sv[[min(len(sv) - 1, max(0, int(np.ceil(q * len(sv))) - 1))
            for q in qs]])
    assert int(seq["d"]["distinct"]) == len(np.unique(c1[m]))
    assert int(seq["empty"]["n"]) == 0
    assert np.isnan(seq["empty"]["quantiles"]).all()


def _same_groups(got, want):
    for k in ("count", "sums", "mins", "maxs", "sumsqs"):
        _eq(got[k], want[k]) if np.asarray(want[k]).dtype.kind != "f" \
            else np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                            atol=1e-6)
    for k in ("avgs", "vars"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["GroupKey", "callable"])
def test_group_by_rides_index_and_matches_seqscan(table, key):
    path, schema, js, c0, c1 = table
    pkey = GroupKey(1, mod=4) if key == "GroupKey" \
        else (lambda c: torch.remainder(c[1], 4))

    def port(q):
        return q.where_range(0, 40, 60).group_by(
            pkey, 4, agg_cols=[1], having=lambda g: g["count"] > 0)

    def jax(q):
        return q.where_range(0, 40, 60).group_by(
            lambda c: c[1] % 4, 4, agg_cols=[1],
            having=lambda g: g["count"] > 0)

    seq = port(Query(path, schema)).run(device=CPU)
    build_index(path, schema, 0, device=CPU)
    q, jq = port(Query(path, schema)), jax(JQuery(path, js))
    assert q.explain(device=CPU).access_path == "index" \
        == jq.explain().access_path
    out, jout = q.run(device=CPU), jq.run()
    _eq(out["groups"], seq["groups"])
    _eq(out["groups"], jout["groups"])
    _same_groups(out, seq)
    _same_groups(out, jout)
    m = (c0 >= 40) & (c0 <= 60)
    for grp in range(4):
        mm = m & (c1 % 4 == grp)
        assert out["count"][grp] == int(mm.sum())
        assert out["sums"][0][grp] == int(c1[mm].sum())
    # an empty selection: every group empty, NaN averages
    e = Query(path, schema).where_eq(0, 2**30).group_by(
        pkey, 4, agg_cols=[1]).run(device=CPU)
    je = JQuery(path, js).where_eq(0, 2**30).group_by(
        lambda c: c[1] % 4, 4, agg_cols=[1]).run()
    assert (np.asarray(e["count"]) == 0).all() and np.isnan(e["avgs"]).all()
    _eq(e["mins"], je["mins"])
    _eq(e["maxs"], je["maxs"])


def test_group_by_indexed_float_agg_close(tmp_path):
    schema, js = _schemas(n_cols=2, visibility=False,
                          dtypes=("int32", "float32"))
    rng = np.random.default_rng(41)
    n = schema.tuples_per_page * 4
    c0 = rng.integers(0, 50, n).astype(np.int32)
    c1 = rng.standard_normal(n).astype(np.float32)
    path = str(tmp_path / "fg.heap")
    build_heap_file(path, [c0, c1], schema)

    def port(q):
        return q.where_range(0, 10, 30).group_by(GroupKey(0, mod=4), 4,
                                                 agg_cols=[1])

    seq = port(Query(path, schema)).run(device=CPU)
    build_index(path, schema, 0, device=CPU)
    q = port(Query(path, schema))
    jq = JQuery(path, js).where_range(0, 10, 30).group_by(
        lambda c: c[0] % 4, 4, agg_cols=[1])
    assert q.explain(device=CPU).access_path == "index" \
        == jq.explain().access_path
    out, jout = q.run(device=CPU), jq.run()
    m = (c0 >= 10) & (c0 <= 30)
    mag = np.array([[np.abs(c1[m & (c0 % 4 == g)]).sum() for g in range(4)]])
    mag2 = np.array([[(c1[m & (c0 % 4 == g)] ** 2).sum() for g in range(4)]])
    for want in (seq, jout):
        _eq(out["count"], want["count"])
        _f_close(out["sums"], want["sums"], mag)
        _f_close(out["sumsqs"], want["sumsqs"], mag2)
        _eq(out["mins"], want["mins"])
        _eq(out["maxs"], want["maxs"])


def test_where_in_rides_index_and_matches_seqscan(table):
    path, schema, js, c0, c1 = table
    members = [3, 57, 199, 7.5, 10**12]   # the last two cannot match

    def sel(q):
        return q.where_in(0, members).select()

    plan, seq, _jp, jseq = _both(path, schema, js, sel)
    assert plan.kernel == "torch"
    # the seqscan predicate is a callable, which no kernel takes
    assert "callable" in Query(path, schema).where_in(0, members) \
        .aggregate()._cuda_refusal()
    _same(seq, jseq)
    build_index(path, schema, 0, device=CPU)
    plan, out, jplan, jout = _both(path, schema, js, sel)
    assert plan.access_path == jplan.access_path == "index"
    assert "IN (3 values)" in plan.reason
    _same(out, jout)
    m = np.isin(c0, [3, 57, 199])
    _eq(np.sort(out["positions"]), np.flatnonzero(m))
    _eq(seq["positions"], np.flatnonzero(m))
    plan, aout, jplan, jaout = _both(
        path, schema, js, lambda q: q.where_in(0, [3, 57]).aggregate([1]))
    assert plan.access_path == jplan.access_path == "index"
    _same(aout, jaout)
    mm = np.isin(c0, [3, 57])
    assert int(aout["sums"][0]) == int(c1[mm].sum())
    _p, e, _jp, je = _both(path, schema, js,
                           lambda q: q.where_in(0, []).select())
    assert int(e["count"]) == 0
    _same(e, je)


def test_where_in_empty_members_float_nan(tmp_path):
    schema, js = _schemas(n_cols=1, visibility=False, dtypes=("float32",))
    n = schema.tuples_per_page
    f = np.zeros(n, np.float32)
    f[5] = np.nan
    path = str(tmp_path / "inn.heap")
    build_heap_file(path, [f], schema)
    _p, out, _jp, jout = _both(path, schema, js,
                               lambda q: q.where_in(0, []).select())
    assert int(out["count"]) == 0
    _same(out, jout)


def test_where_in_nan_member_matches_nothing(tmp_path):
    schema, js = _schemas(n_cols=1, visibility=False, dtypes=("float32",))
    n = schema.tuples_per_page
    f = np.zeros(n, np.float32)
    f[3] = np.nan
    f[7] = np.float32(1.5)
    path = str(tmp_path / "nanin.heap")
    build_heap_file(path, [f], schema)

    def sel(q):
        return q.where_in(0, [np.nan, 1.5]).select()

    _p, seq, _jp, jseq = _both(path, schema, js, sel)
    _same(seq, jseq)
    assert int(seq["count"]) == 1 and seq["positions"][0] == 7
    build_index(path, schema, 0, device=CPU)
    plan, out, jplan, jout = _both(path, schema, js, sel)
    assert plan.access_path == jplan.access_path == "index"
    _same(out, jout)
    assert int(out["count"]) == 1 and out["positions"][0] == 7


def test_join_rides_index_both_faces(table):
    path, schema, js, c0, c1 = table
    keys = np.arange(-500, 500, dtype=np.int32)
    vals = (keys * 3).astype(np.int32)
    makes = {"agg": lambda q: q.where_range(0, 40, 60).join(1, keys, vals),
             "rows": lambda q: q.where_range(0, 40, 60).join(
                 1, keys, vals, materialize=True),
             "left rows": lambda q: q.where_range(0, 40, 60).join(
                 1, keys, vals, materialize=True, how="left"),
             "anti": lambda q: q.where_range(0, 40, 60).join(
                 1, keys, vals, how="anti"),
             "limit": lambda q: q.where_range(0, 40, 60).join(
                 1, keys, vals, materialize=True, limit=5, offset=2)}
    seq = {k: m(Query(path, schema)).run(device=CPU)
           for k, m in makes.items()}
    build_index(path, schema, 0, device=CPU)
    for k, make in makes.items():
        plan, out, jplan, jout = _both(path, schema, js, make)
        assert plan.access_path == jplan.access_path == "index", k
        _same(out, jout)
        # the index reads rows in position order: the scan's own order
        _same(out, seq[k])
    m = (c0 >= 40) & (c0 <= 60) & (c1 >= -500) & (c1 < 500)
    assert int(seq["agg"]["matched"]) == int(m.sum())
    assert int(seq["agg"]["payload_sum"]) == int((c1[m] * 3).sum())
    _eq(seq["limit"]["payload"], c1[seq["limit"]["positions"]] * 3)


# -- composite sidecars ------------------------------------------------------

def test_composite_index_parity_and_packing(tmp_path):
    rng = np.random.default_rng(31)
    schema, js = _schemas(n_cols=3, visibility=False,
                          dtypes=("int32", "uint32", "int32"))
    n = schema.tuples_per_page * 12
    c0 = rng.integers(-50, 50, n).astype(np.int32)
    c1 = rng.integers(0, 40, n).astype(np.uint32)
    c2 = np.arange(n, dtype=np.int32)
    path = str(tmp_path / "comp.heap")
    build_heap_file(path, [c0, c1, c2], schema)
    a0 = np.array([-(1 << 31), (1 << 31) - 1, -1, 0, 1], np.int32)
    a1 = np.array([0, (1 << 32) - 1, 5, 5, 5], np.uint32)
    packed = pack_pair(a0, a1, np.dtype(np.int32), np.dtype(np.uint32))
    tuples = list(zip(a0.astype(np.int64), a1.astype(np.int64)))
    assert [int(x) for x in np.argsort(packed)] == \
        sorted(range(len(tuples)), key=lambda i: tuples[i])
    probe = (int(c0[7]), int(c1[7]))

    def sel(q):
        return q.where_eq((0, 1), probe).select([2])

    plan, seq, jplan, jseq = _both(path, schema, js, sel)
    assert plan.access_path == jplan.access_path == "direct"
    _same(seq, jseq)
    ipath = build_index(path, schema, (0, 1), device=CPU)
    assert ipath == index_path_for(path, (0, 1)) == path + ".idx0_1"
    idx = open_index(ipath, table_path=path)
    assert idx.composite and idx.col == (0, 1)
    plan, r, jplan, jr = _both(path, schema, js, sel)
    assert plan.access_path == jplan.access_path == "index"
    _same(r, jr)
    oracle = np.flatnonzero((c0 == probe[0]) & (c1 == probe[1]))
    _eq(r["positions"], oracle)
    assert int(r["count"]) > 0
    _p, ia, _jp, jia = _both(path, schema, js,
                             lambda q: q.where_eq((0, 1), probe).aggregate(
                                 [2]))
    _same(ia, jia)
    assert int(ia["sums"][0]) == int(c2[oracle].sum())
    for bad in ((0.5, 3), (3, -1), (2 ** 40, 3)):
        plan, out, _jp, jout = _both(
            path, schema, js, lambda q: q.where_eq((0, 1), bad).select([2]))
        assert plan.access_path == "index" and int(out["count"]) == 0
        _same(out, jout)


@pytest.mark.parametrize("case", ["nullable", "8-byte", "float pair",
                                  "triple"])
def test_build_refusals_match_jax(tmp_path, case):
    """The same EINVAL refusals as the JAX package's build_index."""
    kw = {"nullable": dict(n_cols=2, visibility=False,
                           nullable=(True, False)),
          "8-byte": dict(n_cols=2, visibility=False,
                         dtypes=("int64", "int32")),
          "float pair": dict(n_cols=2, visibility=False,
                             dtypes=("float32", "int32")),
          "triple": dict(n_cols=3, visibility=False)}[case]
    col = {"nullable": 0, "8-byte": 0, "float pair": (0, 1),
           "triple": (0, 1, 2)}[case]
    schema, js = _schemas(**kw)
    n = schema.tuples_per_page
    cols = [np.arange(n).astype(schema.col_dtype(c))
            for c in range(schema.n_cols)]
    path = str(tmp_path / "r.heap")
    build_heap_file(path, cols, schema)
    with pytest.raises(StromError) as e:
        build_index(path, schema, col, device=CPU)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(JStromError) as je:
        jbuild_index(path, js, col)
    assert je.value.errno == errno.EINVAL
    assert not os.path.exists(index_path_for(path, col[:2] if isinstance(
        col, tuple) else col))


def test_composite_index_staleness_and_lookup_batch(tmp_path):
    schema, js = _schemas(n_cols=2, visibility=False)
    n = schema.tuples_per_page * 4
    c0 = np.repeat(np.arange(8, dtype=np.int32), n // 8)
    c1 = np.tile(np.arange(n // 8, dtype=np.int32), 8)
    path = str(tmp_path / "s.heap")
    build_heap_file(path, [c0, c1], schema)
    ipath = build_index(path, schema, (0, 1), device=CPU)
    idx = open_index(ipath, table_path=path)
    probes = [(3, 5), (0, 0), (7.5, 1)]     # the last matches nothing
    pos = idx.lookup(probes)
    _eq(pos, jopen_index(ipath, table_path=path).lookup(probes))
    _eq(pos, np.concatenate([np.flatnonzero((c0 == 3) & (c1 == 5)),
                             np.flatnonzero((c0 == 0) & (c1 == 0))]))
    with open(path, "r+b") as f:
        f.seek(0)
        f.write(f.read(1))
    os.utime(path, ns=(1, 1))
    with pytest.raises(StromError) as e:
        open_index(ipath, table_path=path)
    assert e.value.errno == errno.ESTALE
    with pytest.raises(JStromError):
        jopen_index(ipath, table_path=path)


# -- terminals the sidecar serves alone --------------------------------------

def test_order_by_rides_single_and_composite_index(table):
    path, schema, js, c0, c1 = table
    variants = (dict(), dict(limit=7, offset=3), dict(descending=True,
                                                      limit=5),
                dict(descending=True))
    seq = [Query(path, schema).order_by(0, **kw).run(device=CPU)
           for kw in variants]
    build_index(path, schema, 0, device=CPU)
    for kw, s in zip(variants, seq):
        plan, r, jplan, jr = _both(path, schema, js,
                                   lambda q: q.order_by(0, **kw))
        assert plan.access_path == jplan.access_path == "index", kw
        assert "no sort" in plan.reason
        _same(r, s)
        _same(r, jr)
    # a filter takes the index ORDER BY away (the row set differs)
    qf = Query(path, schema).where(FilterPred(((0, "gt", 0),))).order_by(0)
    assert qf.explain(device=CPU).access_path == "direct"
    seq2 = Query(path, schema).order_by([0, 1], limit=11).run(device=CPU)
    build_index(path, schema, (0, 1), device=CPU)
    plan, r2, jplan, jr2 = _both(path, schema, js,
                                 lambda q: q.order_by([0, 1], limit=11))
    assert plan.access_path == jplan.access_path == "index"
    _same(r2, seq2)
    _same(r2, jr2)
    assert Query(path, schema).order_by([0, 1, 1]).explain(
        device=CPU).access_path == "direct"


def test_order_by_never_serves_float_index(tmp_path):
    schema, js = _schemas(n_cols=1, visibility=False, dtypes=("float32",))
    vals = np.array([3.0, np.nan, 1.0, 2.0, np.nan, 0.5] * 50, np.float32)
    path = str(tmp_path / "f.heap")
    build_heap_file(path, [vals], schema)
    seq = Query(path, schema).order_by(0).run(device=CPU)
    assert len(seq["values"]) == len(vals)
    build_index(path, schema, 0, device=CPU)
    plan, r, jplan, jr = _both(path, schema, js, lambda q: q.order_by(0))
    assert plan.access_path == jplan.access_path == "direct"
    _same(r, seq)
    _same(r, jr)
    plan, qe, jplan, jqe = _both(path, schema, js,
                                 lambda q: q.where_eq(0, 2.0).select([0]))
    assert plan.access_path == jplan.access_path == "index"
    assert int(qe["count"]) == 50
    _same(qe, jqe)


def test_quantiles_and_count_distinct_from_sidecar(table):
    path, schema, js, c0, _c1 = table
    qs = [0.1, 0.5, 0.99]
    makes = {"q": lambda q: q.quantiles(0, qs),
             "d": lambda q: q.count_distinct(0)}
    seq = {k: m(Query(path, schema)).run(device=CPU)
           for k, m in makes.items()}
    build_index(path, schema, 0, device=CPU)
    _cold(path)
    for k, make in makes.items():
        before = stats.snapshot().get("total_dma_length", 0)
        plan, out, jplan, jout = _both(path, schema, js, make)
        assert plan.access_path == jplan.access_path == "index"
        assert "no table I/O" in plan.reason
        _same(out, seq[k])
        _same(out, jout)
    assert int(seq["d"]["distinct"]) == len(np.unique(c0))
    plan, fq, jplan, jfq = _both(
        path, schema, js,
        lambda q: q.where_eq(0, int(c0[0])).quantiles(0, [0.5]))
    assert plan.access_path == jplan.access_path == "index"
    _same(fq, jfq)
    assert int(fq["n"]) == int((c0 == c0[0]).sum())


def test_topk_from_sidecar_matches_scan(table):
    path, schema, js, c0, _c1 = table
    big_k = len(c0) + 5
    cases = [(9, True), (9, False), (big_k, True), (big_k, False)]
    scan = {c: Query(path, schema).top_k(0, c[0], largest=c[1])
            .run(device=CPU) for c in cases}
    build_index(path, schema, 0, device=CPU)
    for (k, largest), seq in scan.items():
        plan, r, jplan, jr = _both(
            path, schema, js, lambda q: q.top_k(0, k, largest=largest))
        assert plan.access_path == jplan.access_path == "index"
        assert "no table I/O" in plan.reason
        _same(r, seq)
        _same(r, jr)


def test_leftmost_prefix_rule_over_composite_sidecar(table):
    path, schema, js, c0, c1 = table
    probes = {
        "eq": lambda q: q.where_eq(0, 42),
        "range": lambda q: q.where_range(0, 50, 70),
        "range_frac": lambda q: q.where_range(0, 49.5, 70.5),
        "in": lambda q: q.where_in(0, [3, 42, 199, 10**6]),
    }
    seq = {k: f(Query(path, schema)).select([1]).run(device=CPU)
           for k, f in probes.items()}
    build_index(path, schema, (0, 1), device=CPU)   # composite only
    for k, f in probes.items():
        plan, r, jplan, jr = _both(path, schema, js,
                                   lambda q: f(q).select([1]))
        assert plan.access_path == jplan.access_path == "index", k
        _same(r, jr)
        _eq(np.sort(r["positions"]), seq[k]["positions"])
    _p, sa, _jp, jsa = _both(path, schema, js,
                             lambda q: q.where_eq(0, 42).aggregate([1]))
    _same(sa, jsa)
    assert int(sa["sums"][0]) == int(c1[c0 == 42].sum())
    plan, _o, jplan, _jo = _both(path, schema, js,
                                 lambda q: q.where_eq(1, 5).select([0]))
    assert plan.access_path == jplan.access_path == "direct"


def test_prefix_candidate_hygiene(table):
    path, schema, js, c0, _c1 = table
    # an index on (1, 0) saved under the 0_* name: its header says (1, 0)
    build_index(path, schema, (1, 0), index_path=path + ".idx0_9",
                device=CPU)
    _p, out, _jp, jout = _both(path, schema, js,
                               lambda q: q.where_eq(0, 42).select([1]))
    _eq(np.sort(out["positions"]), np.flatnonzero(c0 == 42))
    _same(out, jout)
    os.unlink(path + ".idx0_9")
    with open(path + ".idx0_1.tmp", "wb") as f:
        f.write(b"garbage")
    plan, out2, jplan, jout2 = _both(
        path, schema, js, lambda q: q.where_eq(0, 42).select([1]))
    assert plan.access_path == jplan.access_path == "direct"
    _same(out2, jout2)


def test_where_eq_order_by_rides_composite_prefix(table):
    path, schema, js, c0, _c1 = table
    v = int(c0[5])
    variants = (dict(), dict(limit=3), dict(limit=4, offset=2),
                dict(descending=True, limit=5))
    seq = [Query(path, schema).where_eq(0, v).order_by(1, **kw)
           .run(device=CPU) for kw in variants]
    build_index(path, schema, (0, 1), device=CPU)
    for kw, s in zip(variants, seq):
        plan, r, jplan, jr = _both(
            path, schema, js, lambda q: q.where_eq(0, v).order_by(1, **kw))
        assert plan.access_path == jplan.access_path == "index", kw
        assert "pinned-prefix" in plan.reason
        _same(r, s)
        _same(r, jr)
    _p, qe, _jp, jqe = _both(path, schema, js,
                             lambda q: q.where_eq(0, 7.5).order_by(1))
    assert len(qe["values"]) == 0
    _same(qe, jqe)
    assert "pinned-prefix" not in Query(path, schema).where_eq(0, v) \
        .order_by(0).explain(device=CPU).reason


def test_prefix_order_by_descending_tie_stability(tmp_path):
    schema, js = _schemas(n_cols=2, visibility=False)
    rng = np.random.default_rng(77)
    n = schema.tuples_per_page * 6
    c0 = rng.integers(0, 3, n).astype(np.int32)
    c1 = rng.integers(0, 4, n).astype(np.int32)
    path = str(tmp_path / "tie.heap")
    build_heap_file(path, [c0, c1], schema)
    seq = Query(path, schema).where_eq(0, 1).order_by(
        1, descending=True).run(device=CPU)
    build_index(path, schema, (0, 1), device=CPU)
    plan, r, jplan, jr = _both(
        path, schema, js,
        lambda q: q.where_eq(0, 1).order_by(1, descending=True))
    assert plan.access_path == jplan.access_path == "index"
    _same(r, seq)
    _same(r, jr)


# -- the residual recheck -----------------------------------------------------

def test_index_cond_plus_residual_filter(table):
    path, schema, js, c0, c1 = table
    keys = np.arange(-500, 500, dtype=np.int32)
    ports = {"agg": lambda q: q.aggregate(cols=[1]),
             "sel": lambda q: q.select([1]),
             "join": lambda q: q.join(1, keys, (keys * 3).astype(np.int32))}
    seq = {k: m(Query(path, schema).where_range(0, 40, 60)
                .where(lambda c: c[1] > 0)).run(device=CPU)
           for k, m in ports.items()}
    build_index(path, schema, 0, device=CPU)
    for k, make in ports.items():
        q = make(Query(path, schema).where_range(0, 40, 60)
                 .where(FilterPred(((1, "gt", 0),))))
        jq = make(JQuery(path, js).where_range(0, 40, 60)
                  .where(lambda c: c[1] > 0))
        plan = q.explain(device=CPU)
        assert plan.access_path == jq.explain().access_path == "index"
        assert "RECHECKED" in plan.reason
        out = q.run(device=CPU)
        _same(out, jq.run())
        if k == "sel":
            _eq(np.sort(out["positions"]), seq[k]["positions"])
        else:
            _same(out, seq[k])
    m = (c0 >= 40) & (c0 <= 60) & (c1 > 0)
    assert int(seq["agg"]["count"]) == int(m.sum())
    assert int(seq["join"]["matched"]) == int((m & (c1 < 500)).sum())


def test_residual_semantics_and_staleness(table):
    path, schema, js, c0, _c1 = table
    build_index(path, schema, 0, device=CPU)
    q = Query(path, schema).where(lambda c: c[1] > 0).where_eq(0, 57)
    assert not q._has_residual() and not q._callables
    out = q.aggregate(cols=[1]).run(device=CPU)
    assert int(out["count"]) == int((c0 == 57).sum())
    q2 = Query(path, schema).where_range(0, 40, 60) \
        .where(lambda c: c[1] > 0).where_eq(0, 57)
    assert not q2._has_residual()
    out2 = q2.aggregate(cols=[1]).run(device=CPU)
    jout2 = JQuery(path, js).where_range(0, 40, 60) \
        .where(lambda c: c[1] > 0).where_eq(0, 57).aggregate(cols=[1]).run()
    _same(out2, jout2)
    assert int(out2["count"]) == int((c0 == 57).sum())


def test_residual_disqualifies_prefix_span_shortcut(tmp_path):
    rng = np.random.default_rng(3)
    schema, js = _schemas(n_cols=3, visibility=False)
    n = schema.tuples_per_page * 4
    c0 = rng.integers(0, 8, n).astype(np.int32)
    c1 = rng.integers(-100, 100, n).astype(np.int32)
    c2 = rng.integers(0, 2, n).astype(np.int32)
    path = str(tmp_path / "rs.heap")
    build_heap_file(path, [c0, c1, c2], schema)
    build_index(path, schema, (0, 1), device=CPU)
    q = Query(path, schema).where_eq(0, 3).where(
        FilterPred(((2, "gt", 0),))).order_by(1)
    assert q.explain(device=CPU).access_path == "direct"
    out = q.run(device=CPU)
    m = (c0 == 3) & (c2 > 0)
    _eq(out["values"], np.sort(c1[m]))
    _eq(np.sort(out["positions"]), np.flatnonzero(m))
    _same(out, JQuery(path, js).where_eq(0, 3).where(lambda c: c[2] > 0)
          .order_by(1).run())


# -- where the port departs from the reference -----------------------------

def test_index_runs_only_what_it_serves(table, tmp_path):
    """Expression aggregates and a partitioned-sized on-disk join build
    never ride the index: the port's EXPLAIN says direct (the JAX
    package's says index, then its run() scans), and both results equal
    the JAX package's."""
    path, schema, js, c0, c1 = table
    build_index(path, schema, 0, device=CPU)
    tree = ("bin", "*", ("col", 1), ("lit", 3))
    plan, out, jplan, jout = _both(
        path, schema, js, lambda q: q.where_eq(0, 42).aggregate_exprs([tree]))
    assert plan.access_path == "direct" and jplan.access_path == "index"
    _same(out, jout)
    assert int(out["esums"][0]) == int((c1[c0 == 42] * 3).sum())
    dschema, djs = _schemas(n_cols=2, visibility=False)
    keys = np.arange(-500, -500 + 2 * dschema.tuples_per_page,
                     dtype=np.int32)
    dpath = str(tmp_path / "d.heap")
    build_heap_file(dpath, [keys, keys * 3], dschema)
    config.set("join_broadcast_max", 1024)
    jconfig.set("join_broadcast_max", 1024)
    plan, out, jplan, jout = _both(
        path, schema, js, lambda q: q.where_range(0, 40, 60).join_table(
            1, dpath, dschema if isinstance(q, Query) else djs, 0, 1))
    assert plan.access_path == "direct" and jplan.access_path == "index"
    assert plan.join_strategy.startswith("partitioned")
    _same(out, jout)


def test_index_select_keeps_null_masks(tmp_path):
    """The index face of ``select`` returns the NULL masks of nullable
    columns, as the seqscan face does; the JAX package's index face drops
    them (its seqscan face has them)."""
    schema, js = _schemas(n_cols=2, visibility=False,
                          dtypes=("int32", "float32"),
                          nullable=(False, True))
    rng = np.random.default_rng(9)
    n = schema.tuples_per_page * 3
    c0 = rng.integers(0, 20, n).astype(np.int32)
    c1 = rng.standard_normal(n).astype(np.float32)
    nul = rng.random(n) < 0.3
    path = str(tmp_path / "n.heap")
    build_heap_file(path, [c0, c1], schema, nulls={1: nul})
    seq = Query(path, schema).where_eq(0, 7).select().run(device=CPU)
    jseq = JQuery(path, js).where_eq(0, 7).select().run()
    _same(seq, jseq)
    build_index(path, schema, 0, device=CPU)
    plan, out, jplan, jout = _both(path, schema, js,
                                   lambda q: q.where_eq(0, 7).select())
    assert plan.access_path == jplan.access_path == "index"
    _same(out, seq)
    _eq(out["null1"], nul[c0 == 7])
    assert "null1" not in jout
    _same(out, jout, [k for k in jout])


def test_composite_where_eq_never_matches_nan_rows(tmp_path):
    """A pair literal the second column cannot hold matches no row on the
    port's seqscan; the JAX package's seqscan predicate (``c0 != c0``)
    selects the NaN rows of a float first column, which its index face
    does not."""
    schema, js = _schemas(n_cols=2, visibility=False,
                          dtypes=("float32", "int32"))
    n = schema.tuples_per_page
    f = np.ones(n, np.float32)
    f[[3, 8]] = np.nan
    path = str(tmp_path / "p.heap")
    build_heap_file(path, [f, np.arange(n, dtype=np.int32)], schema)
    _p, out, _jp, jout = _both(path, schema, js,
                               lambda q: q.where_eq((0, 1), (1.0, 7.5))
                               .select())
    assert int(out["count"]) == 0
    _eq(jout["positions"], np.array([3, 8]))


# -- both packages' sidecars ---------------------------------------------------

def _sidecar_table(tmp_path, kind):
    rng = np.random.default_rng(17)
    if kind == "float":
        schema, js = _schemas(n_cols=2, visibility=True,
                              dtypes=("float32", "int32"))
    else:
        schema, js = _schemas(n_cols=3, visibility=True,
                              dtypes=("int32", "uint32", "int32"))
    n = schema.tuples_per_page * 10
    cols = [rng.integers(-20, 20, n).astype(np.int32),
            rng.integers(0, 15, n).astype(np.uint32),
            np.arange(n, dtype=np.int32)]
    if kind == "float":
        f = (rng.integers(-30, 30, n) / 4).astype(np.float32)
        f[::37] = np.nan
        f[5::41] = -0.0
        cols = [f, cols[2]]
    else:
        cols[0][:4] = [-(1 << 31), (1 << 31) - 1, -(1 << 31), (1 << 31) - 1]
        cols[1][:4] = [0, (1 << 32) - 1, (1 << 32) - 1, 0]
    vis = (rng.random(n) > 0.1).astype(np.int32)
    path = str(tmp_path / f"{kind}.heap")
    build_heap_file(path, cols, schema, visibility=vis)
    col = {"single": 1, "composite": (0, 1), "float": 0}[kind]
    return path, schema, js, col


@pytest.mark.parametrize("kind", ["single", "composite", "float"])
def test_sidecars_byte_identical(tmp_path, kind):
    """The JAX package's build_index and the port's write the same bytes
    on the same table: header, keys and positions (physical order within
    equal keys, NaN keys left out, visible rows only)."""
    path, schema, js, col = _sidecar_table(tmp_path, kind)
    mine = build_index(path, schema, col, index_path=path + ".port",
                       device=CPU)
    theirs = jbuild_index(path, js, col, index_path=path + ".jax")
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read(), g.read()
    assert len(a) == len(b) and a == b
    assert not os.path.exists(mine + ".tmp")


def test_each_package_opens_the_others_sidecar(tmp_path):
    """A sidecar of either package serves the other's planner and
    lookups: the same plans and results from the port's sidecar and from
    the JAX package's."""
    path, schema, js, col = _sidecar_table(tmp_path, "composite")
    ip = index_path_for(path, col)
    results = []
    for maker in ("port", "jax"):
        if maker == "port":
            build_index(path, schema, col, device=CPU)
        else:
            jbuild_index(path, js, col)
        idx, jidx = open_index(ip, table_path=path), \
            jopen_index(ip, table_path=path)
        _eq(idx.keys, jidx.keys)
        _eq(idx.positions, jidx.positions)
        assert idx.col == jidx.col == (0, 1)
        assert idx.key_dtypes == jidx.key_dtypes
        plan, out, jplan, jout = _both(
            path, schema, js, lambda q: q.where_range(0, -5, 5).select())
        assert plan.access_path == jplan.access_path == "index"
        _same(out, jout)
        results.append(out)
        os.unlink(ip)
    _same(results[0], results[1])


# -- on the card ----------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the seqscan face runs the "
                    "kernels there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_index_face_matches_seqscan_face_on_card(table, cuda_device):
    """On the card the seqscan face of where_range / where_eq plans cuda
    (B1 and B3 serve it) and the index face launches no kernel; both
    equal each other and the CPU route."""
    from nvme_strom_tpu_torch.ops import filter_cuda, groupby_cuda
    path, schema, _js, c0, _c1 = table
    makes = [lambda q: q.where_range(0, 40, 60).aggregate([0, 1]),
             lambda q: q.where_eq(0, 42).aggregate([1]),
             lambda q: q.where_range(0, 40, 60).group_by(
                 GroupKey(1, mod=64), 64, agg_cols=[1])]
    scan = []
    for make in makes:
        q = make(Query(path, schema))
        assert q.explain(device=cuda_device).kernel == "cuda"
        before = filter_cuda.launches + groupby_cuda.launches
        scan.append(q.run(device=cuda_device))
        assert filter_cuda.launches + groupby_cuda.launches > before
    build_index(path, schema, 0, device=cuda_device)
    for make, s in zip(makes, scan):
        q = make(Query(path, schema))
        assert q.explain(device=cuda_device).access_path == "index"
        before = filter_cuda.launches + groupby_cuda.launches
        out = q.run(device=cuda_device)
        assert filter_cuda.launches + groupby_cuda.launches == before
        for k in s:
            if k in ("avgs", "vars", "stds", "sumsqs"):
                np.testing.assert_allclose(out[k], s[k], rtol=1e-5)
            else:
                _same(out, s, [k])
        _same(out, make(Query(path, schema)).run(device=CPU))


# -- the mesh builds (tests/test_index.py:197, :997) ---------------------------

def _meshes(sp):
    import jax

    from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jmesh
    from nvme_strom_tpu_torch.parallel.mesh import make_scan_mesh
    return make_scan_mesh(["cpu"] * 4, sp=sp), jmesh(jax.devices()[:4], sp=sp)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("sp", [1, 2])
def test_build_index_over_mesh_matches_local(table, sp):
    """``tests/test_index.py:197``: a single-column build over a mesh
    rides the distributed sample sort; its sidecar is byte-identical to
    the local build's and to the JAX package's mesh build, and answers
    lookups identically."""
    path, schema, js, c0, c1 = table
    mesh, jm = _meshes(sp)
    for col in (0, 1):
        mp = build_index(path, schema, col, mesh=mesh,
                         index_path=path + ".meshidx")
        lp = build_index(path, schema, col, device="cpu",
                         index_path=path + ".localidx")
        jp = jbuild_index(path, js, col, mesh=jm,
                          index_path=path + ".jaxidx")
        assert _bytes(mp) == _bytes(lp) == _bytes(jp)
    idx, local = open_index(mp, table_path=path), open_index(
        lp, table_path=path)
    for key in (0, 42, 199, -1000):
        np.testing.assert_array_equal(np.sort(idx.lookup([key])),
                                      np.sort(local.lookup([key])))


@pytest.mark.parametrize("sp", [1, 2])
def test_composite_build_over_mesh_bit_identical(tmp_path, sp):
    """``tests/test_index.py:997``: a composite build over a mesh (two
    stable uint32 radix passes) writes the host build's sidecar byte for
    byte, the words at 0 / 0xFFFFFFFF included, and the JAX package's."""
    rng = np.random.default_rng(17)
    schema, js = _schemas(n_cols=3, visibility=False,
                          dtypes=("int32", "uint32", "int32"))
    n = schema.tuples_per_page * 10
    c0 = rng.integers(-20, 20, n).astype(np.int32)
    c1 = rng.integers(0, 15, n).astype(np.uint32)
    c2 = np.arange(n, dtype=np.int32)
    c0[:4] = [-(1 << 31), (1 << 31) - 1, -(1 << 31), (1 << 31) - 1]
    c1[:4] = [0, (1 << 32) - 1, (1 << 32) - 1, 0]
    path = str(tmp_path / "mcomp.heap")
    build_heap_file(path, [c0, c1, c2], schema)
    mesh, jm = _meshes(sp)
    for col in ((0, 1), (1, 0)):
        host = build_index(path, schema, col, device="cpu",
                           index_path=path + ".hostidx")
        meshp = build_index(path, schema, col, mesh=mesh,
                            index_path=path + ".meshidx")
        jp = jbuild_index(path, js, col, mesh=jm,
                          index_path=path + ".jaxidx")
        assert _bytes(host) == _bytes(meshp) == _bytes(jp)


@pytest.mark.parametrize("sp", [1, 2])
def test_float_mesh_build_with_nan_is_the_local_builds(tmp_path, sp):
    """A float column with ±0.0 and NaN (both signs): the mesh sidecar is
    byte-identical to the local build's, NaN keys left out and no entry a
    pad's (+inf, -1); without a NaN it is the JAX package's mesh sidecar
    too.  (The reference's mesh build keeps pad entries where NaN rows
    share a bucket with pads: ROADMAP Queue C slice 19.)"""
    rng = np.random.default_rng(5)
    schema, js = _schemas(n_cols=1, visibility=False, dtypes=("float32",))
    n = schema.tuples_per_page * 6
    f = rng.integers(-5, 5, n).astype(np.float32)
    f[rng.random(n) < 0.1] = np.nan
    f[:4] = [np.nan, -0.0, 0.0, -np.nan]
    path = str(tmp_path / "f.heap")
    build_heap_file(path, [f], schema)
    mesh, jm = _meshes(sp)
    mp = build_index(path, schema, 0, mesh=mesh, index_path=path + ".m")
    lp = build_index(path, schema, 0, device="cpu", index_path=path + ".l")
    assert _bytes(mp) == _bytes(lp)
    idx = open_index(mp, table_path=path)
    assert len(idx.keys) == int((~np.isnan(f)).sum())
    assert (np.asarray(idx.positions) >= 0).all()
    assert not np.isinf(np.asarray(idx.keys)).any()
    f[np.isnan(f)] = 1.0           # without a NaN: the reference's too
    build_heap_file(path, [f], schema)
    mp = build_index(path, schema, 0, mesh=mesh, index_path=path + ".m")
    lp = build_index(path, schema, 0, device="cpu", index_path=path + ".l")
    jp = jbuild_index(path, js, 0, mesh=jm, index_path=path + ".j")
    assert _bytes(mp) == _bytes(lp) == _bytes(jp)
