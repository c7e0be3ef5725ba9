"""Property tests of the port's ``Query`` against the JAX package's on the
same heap file: the ports of ``tests/test_property.py``'s query and index
properties, each drawing random tables, predicates, limits and probes, and
a float32 column from a palette that holds NaN, -NaN, +0.0, -0.0, +inf and
-inf beside random floats, ranked by ``top_k`` on every path (the scan, the
index face) in XLA's total order.  The index face ranks only the rows the
filter keeps, so below the pads' sentinel (a -NaN row in a largest-k, a
+NaN row in a smallest-k) it can differ from the scan, which ranks the
filtered-out rows' sentinels: in both packages alike, so each face is held
to the JAX package's same face.  The port runs with ``device="cpu"``,
the JAX package on its CPU backend, both at 64 KiB chunks and on the
direct scan.

Tolerances: values (floats bit for bit), positions (as int64), row orders,
counts and integer sums exact."""

import math

import numpy as np
from hypothesis import given, settings, strategies as st

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.index import build_index
from nvme_strom_tpu_torch.scan.query import Query

CPU = "cpu"
SPECIALS = [math.nan, -math.nan, 0.0, -0.0, math.inf, -math.inf]

#: the float column's values: specials and random float32s, drawn into a
#: palette the column samples from (so special values repeat and tie)
palettes = st.lists(st.one_of(st.sampled_from(SPECIALS),
                              st.floats(width=32)),
                    min_size=1, max_size=12)


def _floats(rng, palette, n):
    return np.array(palette, np.float32)[rng.integers(0, len(palette), n)]


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iu" and b.dtype.kind in "iu" and \
            {a.dtype.itemsize, b.dtype.itemsize} == {4, 8}:
        a, b = a.astype(np.int64), b.astype(np.int64)   # positions
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    np.testing.assert_array_equal(a, b)


def _same(got, want, keys=None):
    for k in keys or want:
        _eq(got[k], want[k])


class _Configs:
    """64 KiB chunks and the direct scan on both sides, for
    the body of one example (hypothesis runs many in one test call)."""

    def __enter__(self):
        self.snap, self.jsnap = config.snapshot(), jconfig.snapshot()
        config.set("chunk_size", 1 << 16)
        jconfig.set("chunk_size", 1 << 16)
        config.set("debug_no_threshold", True)
        jconfig.set("debug_no_threshold", True)

    def __exit__(self, *exc):
        config.restore(self.snap)
        jconfig.restore(self.jsnap)


@given(n_pages=st.integers(1, 5),
       thresh=st.integers(-50, 50),
       limit=st.one_of(st.none(), st.integers(0, 40)),
       offset=st.integers(0, 10),
       k=st.integers(0, 60), largest=st.booleans(),
       palette=palettes,
       seed=st.integers(0, 2**31 - 1))
@settings(max_examples=5, deadline=None)
def test_query_select_order_join_match_oracle(tmp_path_factory, n_pages,
                                              thresh, limit, offset, k,
                                              largest, palette, seed):
    """select / order_by / the join's row face agree with numpy and the
    JAX package for random data, predicates and limit/offset, and top_k
    over the special-valued float column ranks as the JAX package's."""
    kw = dict(n_cols=3, visibility=False, dtypes=("int32", "int32",
                                                  "float32"))
    schema, js = HeapSchema(**kw), JSchema(**kw)
    rng = np.random.default_rng(seed)
    n = schema.tuples_per_page * n_pages
    c0 = rng.integers(-100, 100, n).astype(np.int32)
    c1 = rng.integers(0, 10, n).astype(np.int32)
    c2 = _floats(rng, palette, n)
    path = str(tmp_path_factory.mktemp("q") / "p.heap")
    build_heap_file(path, [c0, c1, c2], schema)
    sel = c0 > thresh
    end = None if limit is None else offset + limit

    def both(make):
        return (make(Query(path, schema).where(
                    FilterPred(((0, "gt", thresh),)))).run(device=CPU),
                make(JQuery(path, js).where(lambda c: c[0] > thresh)).run())

    with _Configs():
        out, jout = both(lambda q: q.select(limit=limit, offset=offset))
        want_pos = np.flatnonzero(sel)[offset:end]
        _eq(out["positions"], want_pos)
        _eq(out["col2"], c2[want_pos])
        _same(out, jout, ["positions", "col0", "col1", "col2"])

        o, jo = both(lambda q: q.order_by([1, 0], limit=limit,
                                          offset=offset))
        order = np.lexsort((c0[sel], c1[sel]))[offset:end]
        _eq(o["values"], c1[sel][order])
        _eq(c0[o["positions"]], c0[sel][order])
        _same(o, jo)

        keys = np.arange(0, 5, dtype=np.int32)
        j, jj = both(lambda q: q.join(1, keys, keys * 7, materialize=True,
                                      limit=limit, offset=offset))
        jpos = np.flatnonzero(sel & (c1 < 5))[offset:end]
        _eq(j["positions"], jpos)
        _eq(j["payload"], c1[jpos] * 7)
        _same(j, jj, ["positions", "payload"])

        t, jt = both(lambda q: q.top_k(2, k, largest=largest))
        _same(t, jt)


@given(n_pages=st.integers(1, 4),
       kind=st.sampled_from(["eq", "range", "in"]),
       a=st.integers(-60, 60), b=st.integers(-60, 60),
       k=st.integers(1, 80), largest=st.booleans(),
       palette=palettes,
       seed=st.integers(0, 2**31 - 1))
@settings(max_examples=5, deadline=None)
def test_index_and_seqscan_answers_identical(tmp_path_factory, n_pages,
                                             kind, a, b, k, largest,
                                             palette, seed):
    """For any random table and structured filter, the index scan and the
    filtered seqscan return identical select rows and aggregate sums, as
    the JAX package's index scan over the same sidecar does; top_k over
    the special-valued float column equals the JAX package's on each
    face."""
    kw = dict(n_cols=3, visibility=False, dtypes=("int32", "int32",
                                                  "float32"))
    schema, js = HeapSchema(**kw), JSchema(**kw)
    rng = np.random.default_rng(seed)
    n = schema.tuples_per_page * n_pages
    c0 = rng.integers(-50, 50, n).astype(np.int32)
    c1 = rng.integers(-1000, 1000, n).astype(np.int32)
    c2 = _floats(rng, palette, n)
    path = str(tmp_path_factory.mktemp("ix") / "p.heap")
    build_heap_file(path, [c0, c1, c2], schema)

    def q(cls, s):
        qq = cls(path, s)
        if kind == "eq":
            return qq.where_eq(0, a)
        if kind == "range":
            return qq.where_range(0, min(a, b), max(a, b))
        return qq.where_in(0, [a, b, a])

    faces = {"select": lambda x: x.select(),
             "aggregate": lambda x: x.aggregate(cols=[1]),
             "top_k": lambda x: x.top_k(2, k, largest=largest)}
    with _Configs():
        seq = {f: m(q(Query, schema)).run(device=CPU)
               for f, m in faces.items()}
        _same(seq["top_k"], faces["top_k"](q(JQuery, js)).run())
        build_index(path, schema, 0, device=CPU)
        assert q(Query, schema).select().explain(device=CPU) \
            .access_path == "index"
        idx = {f: m(q(Query, schema)).run(device=CPU)
               for f, m in faces.items()}
        jidx = {f: m(q(JQuery, js)).run() for f, m in faces.items()}
    assert jidx and q(JQuery, js).select().explain().access_path == "index"
    # rows, not per-column multisets: values stay paired with positions
    io = np.argsort(idx["select"]["positions"], kind="stable")
    so = np.argsort(seq["select"]["positions"], kind="stable")
    for c in ("positions", "col1", "col2"):
        _eq(idx["select"][c][io], seq["select"][c][so])
    _same(idx["select"], jidx["select"], ["positions", "col1", "col2"])
    _same(idx["aggregate"], seq["aggregate"])
    for f in ("aggregate", "top_k"):
        _same(idx[f], jidx[f])


@given(n_rows=st.integers(20, 400),
       n_vals=st.integers(1, 6),
       k=st.integers(1, 40), largest=st.booleans(),
       palette=palettes,
       seed=st.integers(0, 10**6))
@settings(max_examples=5, deadline=None)
def test_composite_eq_index_equals_seqscan_random(tmp_path_factory, n_rows,
                                                  n_vals, k, largest,
                                                  palette, seed):
    """Random tables and composite probes: the index scan and the seqscan
    return identical row sets for ``where_eq((c0, c1), ...)`` across
    select and aggregate, as the JAX package's index scan does, and top_k
    over a special-valued float column equals the JAX package's index
    face; the leftmost-prefix rule and the pinned-prefix ORDER BY hold."""
    kw = dict(n_cols=4, visibility=False, dtypes=("int32", "uint32",
                                                  "int32", "float32"))
    schema, js = HeapSchema(**kw), JSchema(**kw)
    rng = np.random.default_rng(seed)
    c0 = rng.integers(-5, 5, n_rows).astype(np.int32)
    c1 = rng.integers(0, max(1, n_vals), n_rows).astype(np.uint32)
    c2 = np.arange(n_rows, dtype=np.int32)
    c3 = _floats(rng, palette, n_rows)
    path = str(tmp_path_factory.mktemp("comp") / "t.heap")
    build_heap_file(path, [c0, c1, c2, c3], schema)
    probe = (int(c0[rng.integers(0, n_rows)]),
             int(c1[rng.integers(0, n_rows)]))
    oracle = np.flatnonzero((c0 == probe[0]) & (c1 == probe[1]))

    def eq(cls, s):
        return cls(path, s).where_eq((0, 1), probe)

    with _Configs():
        seq = eq(Query, schema).select([2]).run(device=CPU)
        build_index(path, schema, (0, 1), device=CPU)
        qq = eq(Query, schema).select([2])
        assert qq.explain(device=CPU).access_path == "index"
        idxr = qq.run(device=CPU)
        _eq(np.sort(idxr["positions"]), oracle)
        _eq(np.sort(idxr["positions"]), np.sort(seq["positions"]))
        _same(idxr, eq(JQuery, js).select([2]).run(), ["positions", "col2"])
        agg = eq(Query, schema).aggregate([2]).run(device=CPU)
        assert int(agg["count"]) == len(oracle)
        assert int(agg["sums"][0]) == int(c2[oracle].sum())
        _same(eq(Query, schema).top_k(3, k, largest=largest).run(
            device=CPU), eq(JQuery, js).top_k(3, k, largest=largest).run())

        # the leftmost-prefix rule over the same sidecar
        pr = Query(path, schema).where_eq(0, probe[0]).select([2])
        assert pr.explain(device=CPU).access_path == "index"
        _eq(np.sort(pr.run(device=CPU)["positions"]),
            np.flatnonzero(c0 == probe[0]))
        rr = Query(path, schema).where_range(0, -2, 2).select([2]) \
            .run(device=CPU)
        _eq(np.sort(rr["positions"]),
            np.flatnonzero((c0 >= -2) & (c0 <= 2)))

        # WHERE c0 = v ORDER BY c2 from a (c0, c2) sidecar: the stable
        # seqscan sort
        build_index(path, schema, (0, 2), device=CPU)
        po = Query(path, schema).where_eq(0, probe[0]).order_by(2)
        assert po.explain(device=CPU).access_path == "index"
        ro = po.run(device=CPU)
        s = np.flatnonzero(c0 == probe[0])
        order = s[np.argsort(c2[s], kind="stable")]
        _eq(ro["positions"], order)
        _eq(ro["values"], c2[order])
