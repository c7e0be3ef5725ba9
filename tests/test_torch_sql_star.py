"""Star statements, arithmetic expressions, the WHERE lowering onto
FilterPred terms and worker processes through the port's SQL facade,
against the JAX package's on the same heap bytes (the port on
``device="cpu"``; both at 64 KiB chunks).  Integers, positions and strings
exact, floats within ``1e-4 * sum(|x|) + 1e-6``.

* Every case of ``tests/test_sql_star.py``.
* The lowering: the port turns the plain leaves of a top-level AND into
  FilterPred terms (at most 8 with the structured filter's), so a SQL
  statement takes the CUDA route exactly where the same ``Query``-API form
  does.  Each case holds the rows to the JAX facade's (which evaluates
  every leaf in jnp), the lowered terms to the expected ones, and the
  port's CUDA refusal to the API form's (empty where the card would run
  B1).  Where the JAX facade raises OverflowError (a literal outside what
  a jnp compare takes), the port raises EINVAL.
* The ``workers=2`` forms of the reference's worker tests: predicate trees
  travel to the workers (OR, NOT, IS NULL, a string IN), and the answer
  equals the port's one-process run and the JAX package's one-process
  ``sql_query`` (JAX workers are not spawned here)."""

import errno

import numpy as np
import pytest

from nvme_strom_tpu.api import StromError as JStromError
from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan import sql as jsql
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.heap import build_heap_file
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.scan import sql as tsql
from nvme_strom_tpu_torch.scan.heap import HeapSchema
from nvme_strom_tpu_torch.scan.query import Query
from nvme_strom_tpu_torch.testing.sql_results import assert_same_result


@pytest.fixture()
def configs():
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    for c in (config, jconfig):
        c.set("chunk_size", 1 << 16)
        c.set("debug_no_threshold", True)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


def _tables(tables, cls):
    return {k: (p, cls(**kw)) for k, (p, kw) in (tables or {}).items()}


def port(sql, path, kw, tables=None, **run):
    return tsql.sql_query(sql, path, HeapSchema(**kw),
                          tables=_tables(tables, HeapSchema), device="cpu",
                          **run)


def jax_(sql, path, kw, tables=None):
    return jsql.sql_query(sql, path, JSchema(**kw),
                          tables=_tables(tables, JSchema))


def both(sql, path, kw, tables=None, scale=None, **run):
    got = port(sql, path, kw, tables, **run)
    assert_same_result(got, _null_sums(got, jax_(sql, path, kw, tables)),
                       scale=scale, what=sql)
    return got


def _null_sums(got, want):
    """*want* with the JAX package's SUM over no row (0) read as the
    port's NULL: the † divergence of slice 22, taken only where the
    statement selected no row at all."""
    want = dict(want)
    for k, v in got.items():
        if k.startswith("sum(") and v is None:
            assert want.get("count(*)") == 0 and want[k] == 0, (k, want)
            want[k] = None
    return want


def on_workers(sql, path, kw, tables=None, scale=None):
    """``workers=2`` against the one-process run and the JAX package's
    one-process answer; trees shipped, not refused."""
    got = port(sql, path, kw, tables, workers=2)
    assert got["_workers"]["n"] == 2
    assert_same_result(got, port(sql, path, kw, tables), scale=scale,
                       what=sql)
    assert_same_result(got, _null_sums(got, jax_(sql, path, kw, tables)),
                       scale=scale, what=sql)
    return got


# ---------------------------------------------------------------------------
# the cases of tests/test_sql_star.py
# ---------------------------------------------------------------------------

FKW = dict(n_cols=4, dtypes=("int32", "int32", "int32", "float32"))
D1KW = dict(n_cols=2)
D2KW = dict(n_cols=2, dtypes=("int32", "float32"))


@pytest.fixture(scope="module")
def star(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsqlstar")
    rng = np.random.default_rng(1)
    n = 30_000
    c0 = rng.integers(0, 120, n).astype(np.int32)   # dim1 key (some miss)
    c1 = rng.integers(0, 80, n).astype(np.int32)    # dim2 key (some miss)
    c2 = rng.integers(-50, 50, n).astype(np.int32)
    c3 = rng.normal(size=n).astype(np.float32)
    fact = str(d / "fact.heap")
    build_heap_file(fact, [c0, c1, c2, c3], JSchema(**FKW))
    # dimensions padded to whole pages with keys no fact row carries
    t1, t2 = JSchema(**D1KW).tuples_per_page, JSchema(**D2KW).tuples_per_page
    d1k = np.arange(100, dtype=np.int32)
    d1v = rng.integers(0, 1000, 100).astype(np.int32)
    dim1 = str(d / "d1.heap")
    build_heap_file(dim1, [np.concatenate([d1k, 9000 + np.arange(
        t1 - 100, dtype=np.int32)]), np.concatenate(
        [d1v, np.zeros(t1 - 100, np.int32)])], JSchema(**D1KW))
    d2k = np.arange(60, dtype=np.int32)
    d2v = rng.normal(size=60).astype(np.float32)
    dim2 = str(d / "d2.heap")
    build_heap_file(dim2, [np.concatenate([d2k, 9000 + np.arange(
        t2 - 60, dtype=np.int32)]), np.concatenate(
        [d2v, np.zeros(t2 - 60, np.float32)])], JSchema(**D2KW))
    tables = {"d1": (dim1, D1KW), "d2": (dim2, D2KW)}
    scale = float(np.abs(c3).sum() * 3 + np.abs(d2v).sum() * n)
    return fact, tables, scale, c0, c1, c2, c3, d1k, d1v, d2k, d2v


@pytest.fixture(scope="module")
def nullable_fact(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsqlstar_null")
    rng = np.random.default_rng(7)
    n = 20_000
    c0 = rng.integers(0, 120, n).astype(np.int32)
    c1 = rng.integers(0, 80, n).astype(np.int32)
    c2 = rng.integers(1, 100, n).astype(np.int32)
    nn = rng.random(n) < 0.4
    kw = dict(n_cols=3, nullable=(False, False, True))
    fact = str(d / "nf.heap")
    build_heap_file(fact, [c0, c1, c2], JSchema(**kw), nulls={2: nn})
    return fact, kw


def _expr_scalar_aggregates(s, _nf):
    fact, tables, scale, *_ = s
    both("SELECT COUNT(*) AS n, SUM(c2 * c2) AS s2, AVG(c3 * 2.0 + 1.0) AS "
         "a FROM t WHERE c2 > c0 - 60", fact, FKW, scale=scale)


def _expr_column_vs_column_where(s, _nf):
    both("SELECT COUNT(*) AS n FROM t WHERE c2 > c1 + 5 AND c0 < 100",
         s[0], FKW)


def _refused(sql, path, kw, tables=None):
    with pytest.raises(StromError) as ei:
        port(sql, path, kw, tables)
    with pytest.raises(OSError) as ej:
        jax_(sql, path, kw, tables)
    assert ei.value.errno == ej.value.errno == errno.EINVAL, sql
    return ei.value


def _expr_int_division_refused(s, _nf):
    assert "division" in str(_refused("SELECT SUM(c2 / c1) FROM t", s[0],
                                      FKW))


def _expr_float_division_allowed(s, _nf):
    both("SELECT SUM(c3 / 2.0) AS h FROM t WHERE c2 = 0", s[0], FKW,
         scale=s[2])


def _expr_under_group_by_refused(s, _nf):
    _refused("SELECT c0, SUM(c2 * c2) FROM t GROUP BY c0", s[0], FKW)


def _star_aggregate_two_dims(s, _nf):
    fact, tables, scale, *_ = s
    both("SELECT COUNT(*) AS n, SUM(c2) AS s, SUM(d1.c1) AS p1, "
         "AVG(d2.c1) AS p2 FROM t JOIN d1 ON c0 = d1.c0 "
         "JOIN d2 ON c1 = d2.c0 WHERE c2 >= 0", fact, FKW, tables, scale)


def _star_left_and_anti_faces(s, _nf):
    fact, tables, *_ = s
    both("SELECT COUNT(*) AS n, SUM(d1.c1) AS p1 FROM t "
         "LEFT JOIN d1 ON c0 = d1.c0 ANTI JOIN d2 ON c1 = d2.c0",
         fact, FKW, tables)


def _star_row_face_with_limit(s, _nf):
    fact, tables, *_ = s
    both("SELECT c2, d1.c1, d2.c1 FROM t JOIN d1 ON c0 = d1.c0 "
         "LEFT JOIN d2 ON c1 = d2.c0 WHERE c2 > 45 LIMIT 50",
         fact, FKW, tables)


def _star_expr_aggregate(s, _nf):
    fact, tables, *_ = s
    both("SELECT SUM(c2 * 2) AS s FROM t JOIN d1 ON c0 = d1.c0 "
         "JOIN d2 ON c1 = d2.c0", fact, FKW, tables)


def _star_explain_names_the_plan(s, _nf):
    fact, tables, *_ = s
    sql = ("SELECT COUNT(*) FROM t JOIN d1 ON c0 = d1.c0 "
           "JOIN d2 ON c1 = d2.c0")
    q, _ = tsql.parse_sql(sql, fact, HeapSchema(**FKW),
                          tables=_tables(tables, HeapSchema))
    jq, _ = jsql.parse_sql(sql, fact, JSchema(**FKW),
                           tables=_tables(tables, JSchema))
    plan, jplan = q.explain(device="cpu"), jq.explain()
    assert plan.operator == jplan.operator == "star"
    assert "2 broadcast dimensions" in plan.reason
    assert "2 broadcast dimensions" in jplan.reason


def _star_refusals(s, _nf):
    fact, tables, *_ = s
    for sql in (
            "SELECT c2, COUNT(*) FROM t JOIN d1 ON c0 = d1.c0 "
            "JOIN d2 ON c1 = d2.c0 GROUP BY c2",
            "SELECT d1.c1 FROM t SEMI JOIN d1 ON c0 = d1.c0 "
            "JOIN d2 ON c1 = d2.c0",
            "SELECT COUNT(*) FROM t JOIN d1 ON c0 = d1.c0 "
            "JOIN d1 ON c1 = d1.c0",
            "SELECT d1.c0, d1.c1 FROM t JOIN d1 ON c0 = d1.c0 "
            "JOIN d2 ON c1 = d2.c0"):
        _refused(sql, fact, FKW, tables)


def _star_under_workers(s, _nf):
    fact, tables, *_ = s
    on_workers("SELECT COUNT(*) AS n, SUM(d1.c1) AS p1, SUM(c2 * c2) AS sq "
               "FROM t JOIN d1 ON c0 = d1.c0 JOIN d2 ON c1 = d2.c0",
               fact, FKW, tables)


def _expr_aggregate_under_workers(s, _nf):
    on_workers("SELECT SUM(c2 * c1) AS s FROM t WHERE c2 > c1", s[0], FKW)


def _star_query_builder_direct(s, _nf):
    fact, tables, _scale, c0, c1, *_r = s
    specs = [dict(probe_col=0, table=tables["d1"][0],
                  schema=HeapSchema(**D1KW), key_col=0, value_col=1,
                  how="inner"),
             dict(probe_col=1, table=tables["d2"][0],
                  schema=HeapSchema(**D2KW), key_col=0, value_col=None,
                  how="semi")]
    jspecs = [dict(sp, schema=JSchema(**(D1KW if i == 0 else D2KW)))
              for i, sp in enumerate(specs)]
    out = Query(fact, HeapSchema(**FKW)).star_join(specs).run(device="cpu")
    jout = JQuery(fact, JSchema(**FKW)).star_join(jspecs).run()
    assert int(out["count"]) == int(jout["count"])
    assert int(out["pay_sums"][0]) == int(jout["pay_sums"][0])
    config.set("join_broadcast_max", 1024)
    with pytest.raises(StromError) as ei:
        Query(fact, HeapSchema(**FKW)).star_join(specs)
    assert ei.value.errno == errno.EINVAL
    assert "join_broadcast_max" in str(ei.value)


def _star_avg_nullable_fact(s, nf):
    fact, kw = nf
    both("SELECT COUNT(*) AS n, SUM(c2) AS s, AVG(c2) AS a FROM t "
         "JOIN d1 ON c0 = d1.c0 JOIN d2 ON c1 = d2.c0", fact, kw, s[1])


def _star_avg_nullable_fact_under_workers(s, nf):
    fact, kw = nf
    on_workers("SELECT AVG(c2) AS a FROM t JOIN d1 ON c0 = d1.c0 "
               "JOIN d2 ON c1 = d2.c0", fact, kw, s[1])


STAR_CASES = (
    _expr_scalar_aggregates, _expr_column_vs_column_where,
    _expr_int_division_refused, _expr_float_division_allowed,
    _expr_under_group_by_refused, _star_aggregate_two_dims,
    _star_left_and_anti_faces, _star_row_face_with_limit,
    _star_expr_aggregate, _star_explain_names_the_plan, _star_refusals,
    _star_under_workers, _expr_aggregate_under_workers,
    _star_query_builder_direct, _star_avg_nullable_fact,
    _star_avg_nullable_fact_under_workers)


@pytest.mark.parametrize("case", STAR_CASES,
                         ids=[f.__name__[1:] for f in STAR_CASES])
def test_sql_star_against_jax(star, nullable_fact, configs, case):
    case(star, nullable_fact)


# ---------------------------------------------------------------------------
# the lowering of plain leaves onto FilterPred terms
# ---------------------------------------------------------------------------

LKW = dict(n_cols=4, visibility=False,
           dtypes=("int32", "uint32", "float32", "int32"))
LNKW = dict(LKW, nullable=(False, False, False, True))


@pytest.fixture(scope="module")
def low(tmp_path_factory):
    d = tmp_path_factory.mktemp("tlower")
    rng = np.random.default_rng(23)
    n = JSchema(**LKW).tuples_per_page * 3
    c0 = rng.integers(-60, 60, n).astype(np.int32)
    c0[:6] = [23, 24, 0, 16777217, -2 ** 31, 2 ** 31 - 1]
    c1 = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    c1[:4] = [0, 0xFFFFFFFF, 5, 0xFFFFFFFE]
    c2 = rng.uniform(0.0, 0.1, n).astype(np.float32)
    c2[:4] = [np.float32(0.05), np.nan, -0.0, np.float32(0.07)]
    c3 = rng.integers(0, 10, n).astype(np.int32)
    path = str(d / "l.heap")
    build_heap_file(path, [c0, c1, c2, c3], JSchema(**LKW))
    npath = str(d / "ln.heap")
    build_heap_file(npath, [c0, c1, c2, c3], JSchema(**LNKW),
                    nulls={3: np.arange(n) % 3 == 0})
    return path, npath


# (WHERE, the FilterPred terms the port lowers it to (the structured
#  filter's first), whether a callable with its tree is left)
LOWERING = [
    ("c0 > 23.5", ((0, "gt", 23.5),), False),
    ("c0 > -0.0", ((0, "gt", -0.0),), False),
    ("c0 < 1.0e10", ((0, "lt", 1e10),), False),
    ("c0 >= 16777216.0", ((0, "ge", 16777216.0),), False),
    ("c0 = 23.5 AND c3 < 5", ((0, "ge", 1), (0, "le", 0), (3, "lt", 5)),
     False),
    ("c1 > -1", ((1, "gt", -1),), False),
    ("c1 != -1", ((1, "ne", -1),), False),
    ("c1 < -1 AND c0 > 0", ((1, "lt", -1), (0, "gt", 0)), False),
    ("c2 > 0.05", ((2, "gt", 0.05),), False),
    ("c2 BETWEEN 0.05 AND 0.07 AND c0 < 24 AND c0 >= -30",
     ((2, "ge", np.float32(0.05)), (2, "le", np.float32(0.07)),
      (0, "lt", 24), (0, "ge", -30)), False),
    ("c2 < 0.0 / 0.0", (), True),
    ("c2 != 0.0 / 0.0 AND c0 > 0", ((0, "gt", 0),), True),
    ("c0 > 0 OR c1 < 5", (), True),
    ("NOT c0 > 0", (), True),
    ("c0 > -50 AND c0 < 50 AND c1 > 5 AND c2 > 0.01 AND c2 < 0.09 AND "
     "c3 >= 1 AND c3 <= 8 AND c0 != 7 AND c1 != 9",
     ((0, "gt", -50), (0, "lt", 50), (1, "gt", 5), (2, "gt", 0.01),
      (2, "lt", 0.09), (3, "ge", 1), (3, "le", 8), (0, "ne", 7)), True),
]


@pytest.mark.parametrize("where,terms,tree", LOWERING,
                         ids=[w for w, _t, _b in LOWERING])
def test_lowering_same_rows_and_route(low, configs, where, terms, tree):
    path, _npath = low
    sql = f"SELECT COUNT(*), SUM(c3), SUM(c1) FROM t WHERE {where}"
    both(sql, path, LKW)
    q, _ = tsql.parse_sql(sql, path, HeapSchema(**LKW))
    assert q._terms == FilterPred(terms).terms
    assert bool(q._callables) == tree and bool(q._trees) == tree
    assert not q._opaque
    # the route: the same as the Query-API form's (B1 takes terms only)
    api = Query(path, HeapSchema(**LKW))
    if terms:
        api = api.where(FilterPred(terms))
    if tree:
        api = api.where(lambda cols: cols[0] > 0)
    assert q._cuda_refusal() == api.aggregate([3, 1])._cuda_refusal()
    assert (q._cuda_refusal() == "") == (not tree)


def test_lowering_nullable_ne(low, configs):
    """A lowered term never selects a NULL row (SQL's UNKNOWN), as the JAX
    facade's leaf does; B1 refuses the nullable schema in both forms."""
    _path, npath = low
    for where in ("c3 != 5", "c3 != 5 AND c0 > 0", "NOT c3 = 5",
                  "c3 IS NULL OR c3 != 5"):
        both(f"SELECT COUNT(*), SUM(c3), COUNT(c3) FROM t WHERE {where}",
             npath, LNKW)
    q, _ = tsql.parse_sql("SELECT COUNT(*) FROM t WHERE c3 != 5", npath,
                          HeapSchema(**LNKW))
    assert q._terms == ((3, "ne", 5),) and not q._callables
    assert "nullable" in q._cuda_refusal()


@pytest.mark.parametrize("where,jax_raises", [
    ("c0 < 1e10", JStromError), ("c0 < 2147483648", OverflowError),
    ("c1 > 4294967295", OverflowError),
    ("c0 < 2147483648 OR c0 > 0", OverflowError),
    ("c0 + 1 > 2147483648", JStromError)])
def test_lowering_refusals(low, configs, where, jax_raises):
    """Where the JAX facade raises (EINVAL, or jnp's OverflowError for a
    literal no int32 compare takes), the port raises EINVAL."""
    path, _npath = low
    sql = f"SELECT COUNT(*) FROM t WHERE {where}"
    with pytest.raises(StromError) as ei:
        port(sql, path, LKW)
    assert ei.value.errno == errno.EINVAL
    with pytest.raises(jax_raises):
        jax_(sql, path, LKW)


def test_lowering_q6_shape_matches_api_form(tmp_path, configs):
    """TPC-H Q6's WHERE on lineitem's 15 four-byte columns: BETWEEN takes
    ``where_range``, the other leaves three terms, and the plan is the
    API form's (B1 takes it on the card)."""
    kw = dict(n_cols=15, visibility=False,
              dtypes=("int32",) * 5 + ("float32",) * 3 + ("uint32",) * 2
              + ("int32",) * 3 + ("uint32",) * 2)
    rng = np.random.default_rng(6)
    n = JSchema(**kw).tuples_per_page * 4
    cols = [rng.integers(0, 50, n).astype(dt) for dt in kw["dtypes"]]
    cols[6] = rng.uniform(0, 0.1, n).astype(np.float32)
    cols[10] = rng.integers(8700, 9200, n).astype(np.int32)
    path = str(tmp_path / "li.heap")
    build_heap_file(path, cols, JSchema(**kw))
    where = ("c10 >= 8766 AND c10 < 9131 AND c6 BETWEEN 0.05 AND 0.07 AND "
             "c4 < 24")
    sql = f"SELECT COUNT(*), SUM(c5), SUM(c6) FROM t WHERE {where}"
    both(sql, path, kw, scale=float(np.abs(cols[5]).sum()))
    q, _ = tsql.parse_sql(sql, path, HeapSchema(**kw))
    api = Query(path, HeapSchema(**kw)).where_range(6, 0.05, 0.07).where(
        FilterPred(((10, "ge", 8766), (10, "lt", 9131), (4, "lt", 24))))
    assert q._terms == api._terms and not q._callables
    assert q._cuda_refusal() == api.aggregate([5, 6])._cuda_refusal() == ""


# ---------------------------------------------------------------------------
# the workers=2 forms of the reference's worker tests
# ---------------------------------------------------------------------------

PKW = dict(n_cols=4, dtypes=("int32", "int32", "int32", "float32"))
NKW = dict(n_cols=3, dtypes=("int32", "int32", "float32"),
           nullable=(False, True, True))


@pytest.fixture(scope="module")
def ptable(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpq")
    rng = np.random.default_rng(11)
    n = 50_000
    cols = [rng.integers(-1000, 1000, n).astype(np.int32),
            rng.integers(0, 100, n).astype(np.int32),
            rng.integers(0, 40, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32)]
    path = str(d / "t.heap")
    build_heap_file(path, cols, JSchema(**PKW))
    rng = np.random.default_rng(4)
    m = 20_000
    ncols = [rng.integers(0, 100, m).astype(np.int32),
             rng.integers(-50, 50, m).astype(np.int32),
             rng.normal(size=m).astype(np.float32)]
    npath = str(d / "n.heap")
    build_heap_file(npath, ncols, JSchema(**NKW),
                    nulls={1: rng.random(m) < 0.25, 2: rng.random(m) < 0.1})
    return path, npath


def test_workers_predicate_trees_travel(ptable, configs):
    """``tests/test_parallel_query.py:96``: an OR and a NOT tree."""
    on_workers("SELECT COUNT(*) AS n, SUM(c1) AS s FROM t "
               "WHERE (c0 > 500 OR c0 < -500) AND NOT c2 = 3",
               ptable[0], PKW)


def test_workers_cpu_bound_or_filter(ptable, configs):
    """``tests/test_parallel_query.py:131``'s 30-branch OR statement (at
    2 workers over the 50 000-row table): every worker scans."""
    stmt = ("SELECT COUNT(*) AS n FROM t WHERE " + " OR ".join(
        f"(c0 > {k * 60 - 1000} AND c0 < {k * 60 - 970})"
        for k in range(30)))
    out = on_workers(stmt, ptable[0], PKW)
    assert all(s > 0 for s in out["_workers"]["scan_s"])


def test_workers_string_in_tree(tmp_path, configs):
    """A string IN inside an OR tree: translated to codes on the leader,
    so the shipped tree opens no sidecar in a worker."""
    from nvme_strom_tpu.scan.strings import encode_strings, save_dict
    kw = dict(n_cols=2, dtypes=("uint32", "int32"))
    rng = np.random.default_rng(2)
    n = 30_000
    names = np.array(["MAIL", "SHIP", "AIR", "RAIL", "TRUCK"],
                     object)[rng.integers(0, 5, n)]
    codes, d = encode_strings(names.tolist())
    c1 = rng.integers(-100, 100, n).astype(np.int32)
    path = str(tmp_path / "s.heap")
    build_heap_file(path, [codes, c1], JSchema(**kw))
    save_dict(path, 0, d)
    on_workers("SELECT COUNT(*) AS n, SUM(c1) AS s FROM t WHERE "
               "c0 IN ('MAIL', 'SHIP', 'ZEPPELIN') OR c1 < -90", path, kw)
    out = on_workers("SELECT c0, COUNT(*) FROM t WHERE c0 IN ('MAIL', "
                     "'SHIP') AND c1 > 0 GROUP BY c0", path, kw)
    assert list(out["c0"]) == ["MAIL", "SHIP"]


def test_workers_ctas_drops_telemetry(ptable, configs, tmp_path):
    """``tests/test_parallel_query.py:284``."""
    path = ptable[0]
    dest = str(tmp_path / "roll.heap")
    dsch, n = tsql.create_table_as(dest, "SELECT COUNT(*) AS n FROM t "
                                         "WHERE c0 > 0", path,
                                   HeapSchema(**PKW), workers=2,
                                   device="cpu")
    assert (n, dsch.n_cols) == (1, 1)
    got = tsql.sql_query("SELECT c0 FROM t", dest, dsch, device="cpu")
    want = jsql.sql_query("SELECT COUNT(*) AS n FROM t WHERE c0 > 0", path,
                          JSchema(**PKW))
    assert int(got["c0"][0]) == want["n"]


def test_workers_nullable_schema_and_kleene_not(ptable, configs):
    """``tests/test_nulls_wide.py:182`` and ``:435``: NULL-aware counts
    and a NOT over a nullable column, rebuilt from the shipped tree."""
    npath = ptable[1]
    on_workers("SELECT COUNT(c1) AS nn, SUM(c1) AS s FROM t", npath, NKW)
    on_workers("SELECT COUNT(*) AS k FROM t WHERE NOT c1 = 0", npath, NKW)
    on_workers("SELECT COUNT(*) AS k FROM t WHERE c1 IS NULL OR c2 > 0.5",
               npath, NKW)
