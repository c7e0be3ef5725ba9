"""The port's worker processes (``scan/parallel.py``, ``Query(...,
workers=N)`` / ``run(workers=N)``, the Gather analog) against the JAX
package's one-process ``Query.run()`` on the same heap bytes.  Each case
mirrors one of ``tests/test_parallel_query.py``, ``test_nulls_wide.py``
or ``test_sql_star.py`` in its ``Query``-API form (the SQL facade is not
ported).  Every worker runs on ``device="cpu"`` (the ``torch`` route);
each ``run(workers=N)`` spawns N processes, so every case checks several
things of one run.

Tolerances: counts, integer sums (int32 wraps mod 2^32), mins, maxs,
keys, values and positions exact (positions compared as int64, the
port's dtype), and row order equal to the one-process scan's; float32
sums within ``1e-5 * sum(|x|) + 1e-6``, sums of squares within ``1e-5 *
sum(x^2) + 1e-6`` (the workers' partials add in another order)."""

import errno
import os

import numpy as np
import pytest

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.groupby import GroupKey
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.parallel import SharedCursor, \
    run_query_workers
from nvme_strom_tpu_torch.scan.query import Query

CPU = "cpu"
KW = dict(n_cols=4, dtypes=("int32", "int32", "int32", "float32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)


@pytest.fixture(autouse=True)
def configs():
    """64 KiB chunks on both sides (many chunks to share), both packages
    on their direct scan, restored after."""
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    config.set("chunk_size", 1 << 16)
    jconfig.set("chunk_size", 1 << 16)
    config.set("debug_no_threshold", True)
    jconfig.set("debug_no_threshold", True)
    # the direct path, as the JAX package's tests pin it: arbitration
    # would send the freshly written, page-cache-warm tables write-back
    config.set("cache_arbitration", False)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """tests/test_parallel_query.py's table: 50,000 rows, c0 in
    [-1000, 1000), c1 in [0, 100), c2 40 values, c3 normal float32."""
    rng = np.random.default_rng(11)
    n = 50_000
    cols = [rng.integers(-1000, 1000, n).astype(np.int32),
            rng.integers(0, 100, n).astype(np.int32),
            rng.integers(0, 40, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32)]
    path = str(tmp_path_factory.mktemp("pq") / "t.heap")
    build_heap_file(path, cols, SCHEMA)
    return path, cols


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iu" and b.dtype.kind in "iu" and \
            {a.dtype.itemsize, b.dtype.itemsize} == {4, 8}:
        a, b = a.astype(np.int64), b.astype(np.int64)   # positions
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same(got: dict, want: dict, mags=None):
    """Every key of the JAX result equal in the port's; keys in *mags*
    (``{key: magnitude}``) within 1e-5 of their magnitude + 1e-6."""
    mags = mags or {}
    assert set(want) <= set(got), (sorted(got), sorted(want))
    for k, w in want.items():
        gs, ws = (got[k], w) if isinstance(w, list) else ([got[k]], [w])
        assert len(gs) == len(ws), k
        ms = mags.get(k)
        ms = [None] * len(ws) if ms is None else \
            (ms if isinstance(w, list) else [ms])
        for g1, w1, m in zip(gs, ws, ms):
            if m is None:
                _eq(g1, w1)
            else:
                np.testing.assert_array_less(
                    np.abs(np.asarray(g1, np.float64)
                           - np.asarray(w1, np.float64)),
                    1e-5 * np.asarray(m, np.float64) + 1e-6 + 1e-12)


def _check_info(out, n):
    info = out["_workers"]
    assert info["n"] == n and len(info["scan_s"]) == n
    assert all(s > 0 for s in info["scan_s"])
    # the torch route on the CPU: no kernel launches anywhere
    assert info["launches"] == [{"filter_pages": 0,
                                 "groupby_pages": 0}] * n


def _group_mags(cols, keys, sel, key_col, agg_col):
    """Per-group sum(|x|) and sum(x^2) of *agg_col* over *sel*."""
    v = cols[agg_col].astype(np.float64)
    grp = [sel & (cols[key_col] == k) for k in keys]
    return (np.array([[np.abs(v[m]).sum() for m in grp]]),
            np.array([[(v[m] ** 2).sum() for m in grp]]))


# -- the aggregate, its plan, and analyze under workers -----------------------

def test_workers_aggregate_matches_serial_and_analyzes(table):
    """workers=2 equals the JAX one-process run and numpy; the workers'
    engine counters fold into the leader's, so ``analyze`` reads the
    bytes the one-process run reads."""
    path, (c0, c1, *_rest) = table

    def make(q):
        return q.where_range(0, 101, None).aggregate(cols=[1])
    serial = make(Query(path, SCHEMA)).run(device=CPU, analyze=True)
    out = make(Query(path, SCHEMA)).run(device=CPU, workers=2,
                                        analyze=True)
    want = make(JQuery(path, JS)).run()
    _same(out, want)
    sel = c0 > 100
    assert int(out["count"]) == int(sel.sum())
    assert int(out["sums"][0]) == int(c1[sel].sum())
    _check_info(out, 2)
    a, s = out["_analyze"], serial["_analyze"]
    assert a["bytes_direct"] == s["bytes_direct"] > 0
    assert a["requests"] == s["requests"]
    assert a["waits"] == s["waits"] > 0
    assert a["kernel_dispatches"] == s["kernel_dispatches"]
    assert a["h2d_depth_reached"] >= 1


def test_workers_explain_shows_plan(table):
    path, _cols = table
    q = Query(path, SCHEMA, workers=3).where_eq(2, 7).aggregate()
    plan = q.explain(device=CPU)
    assert plan.workers == 3 and plan.mode == "local"
    assert "workers=3" in str(plan)
    assert "cost divisor 3.2" in plan.reason
    # the worker-aware cost model: 3 workers cost less than 1
    serial = Query(path, SCHEMA).where_eq(2, 7).aggregate() \
        .explain(device=CPU)
    assert serial.workers == 0 and "workers=" not in str(serial)
    assert plan.cost_direct < serial.cost_direct
    assert serial.cost_direct < serial.cost_vfs     # seq_page_cost 0.25


def test_planner_cost_terms_match_jax():
    from nvme_strom_tpu.scan import planner as jplanner
    from nvme_strom_tpu_torch.scan import planner
    for w in (0, 1, 2, 3, 4, 8):
        assert planner._parallel_divisor(w) == jplanner._parallel_divisor(w)
        for f in ("cost_direct_scan", "cost_vfs_scan"):
            got = getattr(planner, f)(1000, 680_000, workers=w)
            want = getattr(jplanner, f)(1000, 680_000, workers=w)
            assert (got.total, got.pages, got.workers) == \
                (want.total, want.pages, want.workers)


# -- the other terminals: one spawn a case ------------------------------------

_CASES = {
    # tests/test_parallel_query.py
    "group_by_cols shared key space": (
        3, lambda q: q.where_range(0, 0, None).group_by_cols(
            2, agg_cols=[1])),
    "select all": (2, lambda q: q.where_range(0, 901, None).select([0, 1])),
    "select limit offset": (2, lambda q: q.where_range(0, 901, None)
                            .select([0, 3], limit=7, offset=3)),
    "top_k ties": (2, lambda q: q.top_k(2, 50)),
    "top_k smallest float": (2, lambda q: q.where_range(0, 0, None)
                             .top_k(3, 9, largest=False)),
    "where_in travels": (2, lambda q: q.where_in(2, [1, 5, 7, 39])
                         .aggregate(cols=[1, 3])),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_workers_terminal_matches_serial(table, case):
    path, cols = table
    n, make = _CASES[case]
    out = make(Query(path, SCHEMA)).run(device=CPU, workers=n)
    want = make(JQuery(path, JS)).run()
    mags = {}
    if case == "group_by_cols shared key space":
        sel = cols[0] >= 0
        keys = np.unique(cols[2][sel])
        _eq(out["key_cols"][0], keys)
        _, sq = _group_mags(cols, keys, sel, 2, 1)
        mags = {"sumsqs": sq, "vars": sq / np.maximum(out["count"], 1),
                "stds": np.sqrt(sq / np.maximum(out["count"], 1))}
    if case == "where_in travels":
        sel = np.isin(cols[2], [1, 5, 7, 39])
        mags = {"sums": [None, np.abs(cols[3][sel]).sum()]}
    _same(out, want, mags)
    _check_info(out, n)
    if case.startswith("select"):
        # the one-process scan's row order, not the workers' arrival order
        p = out["positions"]
        assert (np.diff(p) > 0).all()


def _spill_table(tmp_path, n=60_000, distinct=70_000):
    rng = np.random.default_rng(5)
    k = rng.integers(0, distinct, n).astype(np.int32)
    v = rng.integers(-50, 50, n).astype(np.int32)
    kw = dict(n_cols=2)
    path = str(tmp_path / "spill.heap")
    build_heap_file(path, [k, v], HeapSchema(**kw))
    return path, HeapSchema(**kw), JSchema(**kw), k, v


def test_spill_groupby_under_workers(tmp_path):
    """Past max_groups the workers sort-aggregate and the leader merges:
    the JAX one-process spill's result, key_cols included."""
    path, schema, js, k, v = _spill_table(tmp_path)
    out = Query(path, schema).group_by_cols(0, agg_cols=[1],
                                            max_groups=1000) \
        .run(device=CPU, workers=2)
    want = JQuery(path, js).group_by_cols(0, agg_cols=[1],
                                          max_groups=1000).run()
    keys = np.unique(k)
    assert len(keys) > 1000                       # the spill ran
    _eq(out["key_cols"][0], keys)
    sq = np.array([np.bincount(np.searchsorted(keys, k),
                               weights=v.astype(np.float64) ** 2)])
    cnt = np.maximum(out["count"], 1)
    _same(out, want, {"sumsqs": sq, "vars": sq / cnt,
                      "stds": np.sqrt(sq / cnt)})
    _check_info(out, 2)


# -- predicates that travel, and nullable schemas ---------------------------

def test_filterpred_and_null_guard_travel(tmp_path):
    """test_nulls_wide.py's workers cases in their Query-API form: the
    aggregate of a nullable column (``nncounts``) and ``c1 != 0`` on it
    (a NULL row never matches: the guard rebuilt from the FilterPred in
    each worker)."""
    rng = np.random.default_rng(3)
    kw = dict(n_cols=3, dtypes=("int32", "int32", "float32"),
              nullable=(False, True, True))
    schema, js = HeapSchema(**kw), JSchema(**kw)
    n = 30_000
    c0 = rng.integers(0, 100, n).astype(np.int32)
    c1 = rng.integers(-3, 4, n).astype(np.int32)
    c2 = rng.normal(size=n).astype(np.float32)
    n1, n2 = rng.random(n) < 0.3, rng.random(n) < 0.2
    path = str(tmp_path / "n.heap")
    build_heap_file(path, [c0, c1, c2], schema, nulls={1: n1, 2: n2})
    out = Query(path, schema).where(FilterPred(((1, "ne", 0),))) \
        .aggregate(cols=[1, 2]).run(device=CPU, workers=2)
    want = JQuery(path, js).where(lambda c: c[1] != 0) \
        .aggregate(cols=[1, 2]).run()
    sel = (c1 != 0) & ~n1
    assert int(out["count"]) == int(sel.sum())
    assert int(out["nncounts"][0]) == int(sel.sum())
    assert int(out["sums"][0]) == int(c1[sel].sum())
    _same(out, want, {"sums": [None, np.abs(c2[sel & ~n2]).sum()]})
    _check_info(out, 2)


@pytest.fixture(scope="module")
def star(tmp_path_factory):
    """test_sql_star.py's star: a 30,000-row fact, d1 (100 int32 keys,
    int32 payload), d2 (60 keys, float32 payload)."""
    d = tmp_path_factory.mktemp("star")
    rng = np.random.default_rng(1)
    n = 30_000
    c0 = rng.integers(0, 120, n).astype(np.int32)
    c1 = rng.integers(0, 80, n).astype(np.int32)
    c2 = rng.integers(-50, 50, n).astype(np.int32)
    c3 = rng.normal(size=n).astype(np.float32)
    fact = str(d / "fact.heap")
    build_heap_file(fact, [c0, c1, c2, c3], SCHEMA)
    dims = {}
    for name, keys, vals, dts in (
            ("d1", np.arange(100, dtype=np.int32),
             rng.integers(0, 1000, 100).astype(np.int32), None),
            ("d2", np.arange(60, dtype=np.int32),
             rng.normal(size=60).astype(np.float32), ("int32", "float32"))):
        kw = dict(n_cols=2, dtypes=dts)
        p = str(d / f"{name}.heap")
        build_heap_file(p, [keys, vals], HeapSchema(**kw))
        dims[name] = (p, HeapSchema(**kw), JSchema(**kw), keys, vals)
    return fact, (c0, c1, c2, c3), dims


def _star_specs(dims, jax_side):
    i = 2 if jax_side else 1
    return [dict(probe_col=0, table=dims["d1"][0], schema=dims["d1"][i],
                 key_col=0, value_col=1, how="inner"),
            dict(probe_col=1, table=dims["d2"][0], schema=dims["d2"][i],
                 key_col=0, value_col=None, how="semi")]


_SQ = ("bin", "*", ("col", 2), ("col", 2))


@pytest.mark.parametrize("case", ["star", "expressions"])
def test_star_and_expression_aggregates_under_workers(star, case):
    """test_sql_star.py:178 and :190 in their Query-API form: the star
    join's aggregate face with an expression, and ``SUM(c2 * c1)`` over
    ``c2 > 0``, at workers=2."""
    fact, (c0, c1, c2, c3), dims = star
    if case == "star":
        out = Query(fact, SCHEMA).star_join(
            _star_specs(dims, False), exprs=[_SQ]).run(device=CPU,
                                                        workers=2)
        want = JQuery(fact, JS).star_join(
            _star_specs(dims, True), exprs=[_SQ]).run()
        m = np.isin(c0, dims["d1"][3]) & np.isin(c1, dims["d2"][3])
        assert int(out["count"]) == int(m.sum())
        assert int(out["pay_sums"][0]) == int(dims["d1"][4][c0[m]].sum())
        assert int(out["esums"][0]) == int(np.sum(c2[m] * c2[m]))
        mags = {"sums": [None, None, None, np.abs(c3[m]).sum()]}
    else:
        expr = ("bin", "*", ("col", 2), ("col", 1))
        out = Query(fact, SCHEMA).where(FilterPred(((2, "gt", 0),))) \
            .aggregate_exprs([expr]).run(device=CPU, workers=2)
        want = JQuery(fact, JS).where(lambda c: c[2] > 0) \
            .aggregate_exprs([expr]).run()
        m = c2 > 0
        assert int(out["esums"][0]) == int(np.sum(c2[m] * c1[m]))
        mags = {}
    _same(out, want, mags)
    _check_info(out, 2)


def test_star_avg_nullable_fact_under_workers(tmp_path, star):
    """test_sql_star.py:253: ``nncounts`` of a 40%-NULL fact column fold
    additively across the workers' partials."""
    _fact, _cols, dims = star
    rng = np.random.default_rng(7)
    n = 20_000
    c0 = rng.integers(0, 120, n).astype(np.int32)
    c1 = rng.integers(0, 80, n).astype(np.int32)
    c2 = rng.integers(1, 100, n).astype(np.int32)
    nn = rng.random(n) < 0.4
    kw = dict(n_cols=3, nullable=(False, False, True))
    fact = str(tmp_path / "nf.heap")
    build_heap_file(fact, [c0, c1, c2], HeapSchema(**kw), nulls={2: nn})
    specs = [dict(s, how="inner") for s in _star_specs(dims, False)]
    jspecs = [dict(s, how="inner") for s in _star_specs(dims, True)]
    specs[1]["value_col"] = jspecs[1]["value_col"] = 1
    out = Query(fact, HeapSchema(**kw)).star_join(specs) \
        .run(device=CPU, workers=2)
    want = JQuery(fact, JSchema(**kw)).star_join(jspecs).run()
    hit = np.isin(c0, dims["d1"][3]) & np.isin(c1, dims["d2"][3])
    assert int(out["count"]) == int(hit.sum())
    assert int(out["nncounts"][2]) == int((hit & ~nn).sum())
    assert int(out["sums"][2]) == int(c2[hit & ~nn].sum())
    _same(out, want, {"pay_sums": [None, np.abs(dims["d2"][4][c1[hit]])
                                   .sum()]})
    _check_info(out, 2)


# -- refusals (no process starts) ---------------------------------------------

_REFUSALS = {
    "callable where": (lambda q: q.where(lambda c: c[0] > 0).aggregate(),
                       "opaque"),
    "terminal order_by": (lambda q: q.order_by(0), "not worker-servable"),
    "terminal quantiles": (lambda q: q.quantiles(0, [0.5]),
                           "not worker-servable"),
    "invalid plan": (lambda q: q.aggregate(cols=[9]), "out of range"),
    "join": (lambda q: q.join(2, np.arange(4, dtype=np.int32),
                              np.arange(4, dtype=np.int32)),
             "JOIN is not worker-servable"),
    "group_by key": (lambda q: q.group_by(GroupKey(2, 8), 8,
                                          agg_cols=[1]),
                     "group_by_cols"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_workers_refusals(table, case):
    """Each refusal is EINVAL with the reference's cause, raised by the
    leader before any worker starts."""
    path, _cols = table
    make, word = _REFUSALS[case]
    with pytest.raises(StromError) as ei:
        make(Query(path, SCHEMA)).run(device=CPU, workers=2)
    assert ei.value.errno == errno.EINVAL
    assert word in str(ei.value)


def test_workers_star_row_face_and_striped_source_refused(star):
    fact, _cols, dims = star
    with pytest.raises(StromError) as ei:
        Query(fact, SCHEMA).star_join(_star_specs(dims, False),
                                      materialize=True) \
            .run(device=CPU, workers=2)
    assert ei.value.errno == errno.EINVAL and "row face" in str(ei.value)
    # a striped set is a Query source, but never a parallel scan's: it is
    # refused before any process starts
    with pytest.raises(StromError) as ei:
        Query([fact, fact], SCHEMA, workers=2).aggregate().run(device=CPU)
    assert ei.value.errno == errno.EINVAL and "one table file" in str(ei.value)


# -- the fan-out itself -------------------------------------------------------

def test_shared_cursor_claims_disjoint_ranges():
    cur = SharedCursor(10)
    try:
        assert cur.n_chunks == 10
        assert [cur.claim(4), cur.claim(4), cur.claim(4), cur.claim(1)] == \
            [(0, 4), (4, 4), (8, 2), (10, 0)]
        other = SharedCursor(0, name=cur.name, create=False,
                             lock=cur._lock)
        cur.reset()
        assert other.claim(3) == (0, 3) and cur.claim(1) == (3, 1)
        other.close()
    finally:
        cur.close(unlink=True)


@pytest.mark.parametrize("fault", ["crash", "error"])
def test_a_failed_worker_fails_the_query(table, fault):
    """A worker that dies without reporting (the ``_test_crash_worker``
    hook) or raises before the start barrier fails the call within
    seconds, and no worker is left behind."""
    import time
    path, _cols = table
    q = Query(path, SCHEMA).where_range(0, 101, None).aggregate(cols=[1])
    spec = q._worker_spec(q.explain(device=CPU).device, "torch", None,
                          False)
    if fault == "crash":
        spec["_test_crash_worker"] = True
        match = "died without reporting"
    else:
        spec["op"] = "no such terminal"
        match = "worker failed"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        run_query_workers(spec, 2, timeout_s=120)
    assert time.monotonic() - t0 < 60
    assert not [p for p in __import__("multiprocessing")
                .active_children() if p.is_alive()]


def test_parallel_scan_demo_face(table):
    """``parallel_scan``: count of col0 > threshold, sum of col1."""
    from nvme_strom_tpu_torch.scan.parallel import parallel_scan
    path, (c0, c1, *_r) = table
    kw = dict(n_cols=2, visibility=True)
    two = os.path.join(os.path.dirname(path), "two.heap")
    vis = (np.arange(len(c0)) % 5 != 0).astype(np.int32)
    build_heap_file(two, [c0, c1], HeapSchema(**kw), visibility=vis)
    out = parallel_scan(two, n_workers=2, chunk_size=1 << 16,
                        threshold=100, device=CPU)
    sel = (c0 > 100) & (vis != 0)
    assert out == {"count": int(sel.sum()), "sum": int(c1[sel].sum()),
                   "workers": 2}
