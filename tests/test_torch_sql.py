"""The port's SQL facade (``scan/sql.py``) against the JAX package's, on
the same heap bytes: every statement of ``tests/test_sql.py`` runs through
both packages' ``sql_query`` (the port on ``device="cpu"``, its ``torch``
route) and the assembled dicts compare: integers, positions and strings
exact, floats within ``1e-4 * sum(|x|) + 1e-6``.  A refusal raises EINVAL
(EEXIST for CREATE TABLE AS over an existing table) in both packages, with
the same words.  Tables derived by ``create_table_as`` are compared by
their schema and by requerying them in both packages.  The mesh case runs
over ``make_scan_mesh(["cpu"] * 4)`` against the JAX package's CPU mesh.

Two wrong answers of the JAX package's facade are not copied, and are
held here against numpy truth and the JAX package's right face of the
same rows: its ORDER BY assembler drops the NULLs of its projected
columns (its plain select face keeps them), and its NOT over a leaf that
is TRUE on every row borrows column 0's NULLs as UNKNOWN (its ``IS NOT
NULL`` face is right)."""

import errno

import numpy as np
import pytest

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan import sql as jsql
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.heap import build_heap_file
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.scan import sql as tsql
from nvme_strom_tpu_torch.scan.heap import HeapSchema
from nvme_strom_tpu_torch.testing.sql_results import assert_same_result


@pytest.fixture()
def configs():
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    config.set("debug_no_threshold", True)
    jconfig.set("debug_no_threshold", True)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


class Env:
    """One table (and an optional dimension) seen by both packages."""

    def __init__(self, path, kw, tables=None, scale=None, **cols):
        self.path, self.kw, self.scale = path, kw, scale
        self.tables = tables or {}
        self.__dict__.update(cols)

    def ts(self, kw=None):
        return HeapSchema(**(kw or self.kw))

    def js(self, kw=None):
        return JSchema(**(kw or self.kw))

    def _tables(self, port: bool):
        cls = HeapSchema if port else JSchema
        return {k: (p, cls(**kw)) for k, (p, kw) in self.tables.items()}

    def port(self, sql, path=None, kw=None, **run):
        return tsql.sql_query(sql, path or self.path, self.ts(kw),
                              tables=self._tables(True), device="cpu", **run)

    def jax(self, sql, path=None, kw=None, **run):
        return jsql.sql_query(sql, path or self.path, self.js(kw),
                              tables=self._tables(False), **run)

    def both(self, sql, path=None, kw=None, scale=None, **run):
        got = self.port(sql, path, kw, **run)
        want = self.jax(sql, path, kw, **run)
        assert_same_result(got, want, scale=scale or self.scale, what=sql)
        return got

    def refuse(self, sql, needle, path=None, kw=None):
        with pytest.raises(StromError) as ei:
            self.port(sql, path, kw)
        with pytest.raises(OSError) as ej:
            self.jax(sql, path, kw)
        assert ei.value.errno == ej.value.errno, sql
        for e in (ei.value, ej.value):
            assert needle.lower() in str(e).lower(), (sql, str(e))
        return ei.value


TKW = dict(n_cols=3, visibility=False, dtypes=("int32", "int32", "float32"))


@pytest.fixture()
def table(tmp_path, configs):
    rng = np.random.default_rng(42)
    n = JSchema(**TKW).tuples_per_page * 8
    c0 = rng.integers(0, 50, n).astype(np.int32)
    c1 = rng.integers(-100, 100, n).astype(np.int32)
    c2 = rng.standard_normal(n).astype(np.float32)
    path = str(tmp_path / "t.heap")
    build_heap_file(path, [c0, c1, c2], JSchema(**TKW))
    return Env(path, TKW, scale=float(np.abs(c2).sum()), c0=c0, c1=c1,
               c2=c2, tmp=tmp_path)


JKW = dict(n_cols=2, visibility=False)


@pytest.fixture()
def joined(tmp_path, configs):
    rng = np.random.default_rng(77)
    n = JSchema(**JKW).tuples_per_page * 6
    c0 = rng.integers(-50, 50, n).astype(np.int32)
    c1 = rng.integers(0, 16, n).astype(np.int32)
    fpath = str(tmp_path / "fact.heap")
    build_heap_file(fpath, [c0, c1], JSchema(**JKW))
    keys = np.arange(0, 8, dtype=np.int32)
    dpath = str(tmp_path / "dim.heap")
    build_heap_file(dpath, [keys, (keys * 100).astype(np.int32)],
                    JSchema(**JKW))
    return Env(fpath, JKW, tables={"d": (dpath, JKW)}, c0=c0, c1=c1,
               dpath=dpath, tmp=tmp_path)


# --- the cases of tests/test_sql.py over the 3-column table ---------------

def _scalar_aggregates(e):
    out = e.both("SELECT COUNT(*), SUM(c1), AVG(c1) FROM t WHERE c0 < 10")
    assert out["count(*)"] == int((e.c0 < 10).sum())


def _where_forms(e):
    for sql in ("SELECT COUNT(*) FROM t WHERE c0 = 7",
                "SELECT COUNT(*) FROM t WHERE c0 BETWEEN 10 AND 19 AND "
                "c1 > 0",
                "SELECT COUNT(*) FROM t WHERE c0 IN (1, 2, 3)",
                "SELECT COUNT(*) FROM t WHERE 0 < c1"):
        e.both(sql)


def _group_by_with_having(e):
    e.both("SELECT c0, COUNT(*), SUM(c1), MIN(c1) FROM t WHERE c1 > 0 "
           "GROUP BY c0 HAVING COUNT(*) >= 20")


def _select_order_limit(e):
    out = e.both("SELECT c0, c1 FROM t WHERE c0 = 3 LIMIT 5")
    np.testing.assert_array_equal(out["c1"], e.c1[out["positions"]])
    out = e.both("SELECT c1 FROM t ORDER BY c1 DESC LIMIT 10")
    np.testing.assert_array_equal(out["c1"], np.sort(e.c1)[::-1][:10])


def _min_max_count_distinct(e):
    e.both("SELECT MAX(c1) FROM t")
    e.both("SELECT MIN(c1) FROM t WHERE c0 = 3")
    e.both("SELECT COUNT(DISTINCT c0) FROM t")


def _star_projection(e):
    out = e.both("SELECT * FROM t WHERE c1 > 95")
    np.testing.assert_array_equal(np.sort(out["positions"]),
                                  np.flatnonzero(e.c1 > 95))


def _rides_the_index(e):
    from nvme_strom_tpu_torch.scan.index import build_index
    build_index(e.path, e.ts(), 0, device="cpu")
    sql = "SELECT COUNT(*), SUM(c1) FROM t WHERE c0 = 7"
    q, _ = tsql.parse_sql(sql, e.path, e.ts())
    assert q.explain(device="cpu").access_path == "index"
    e.both(sql)


def _mesh_mode(e):
    import jax

    from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jmesh
    from nvme_strom_tpu_torch.parallel.mesh import make_scan_mesh
    sql = "SELECT COUNT(*), SUM(c1) FROM t WHERE c1 > 0"
    got = tsql.sql_query(sql, e.path, e.ts(),
                         mesh=make_scan_mesh(["cpu"] * 4), batch_pages=8)
    want = jsql.sql_query(sql, e.path, e.js(), mesh=jmesh(jax.devices()),
                          batch_pages=8)
    assert_same_result(got, want, what=sql)


def _rejects_out_of_subset(e):
    for sql, needle in [
        ("SELECT c0 FROM t WHERE c0 = 1 OR", "end of statement"),
        ("SELECT c0 FROM t WHERE (c0 = 1 OR c1 = 2", "expected ')'"),
        ("SELECT c9 FROM t", "out of range"),
        ("SELECT c0, SUM(c1) FROM t", "GROUP BY"),
        ("SELECT SUM(c1) FROM t GROUP BY c0 HAVING SUM(c2) > 0", "dtype"),
        ("SELECT MAX(c1), SUM(c0) FROM t", "cannot combine"),
        ("SELECT SUM(c0) FROM t ORDER BY c1", "requires GROUP BY"),
        ("SELECT c0 FROM t ORDER BY COUNT(*)", "requires GROUP BY"),
        ("SELECT AVG(*) FROM t", "name a column"),
        ("SELECT c0 FROM t; DROP TABLE t", "tokenize"),
        ("SELECT c0 FROM t LIMIT 5 EXTRA", "trailing"),
        ("SELECT SUM(c0) FROM t HAVING COUNT(*) > 1", "GROUP BY"),
    ]:
        assert e.refuse(sql, needle).errno == errno.EINVAL


def _order_by_projection(e):
    out = e.both("SELECT c0, c1 FROM t ORDER BY c1 DESC LIMIT 12")
    np.testing.assert_array_equal(out["c0"], e.c0[out["positions"]])


def _top_n_groups(e):
    e.both("SELECT c0, COUNT(*) FROM t GROUP BY c0 "
           "ORDER BY COUNT(*) DESC LIMIT 5")
    e.both("SELECT c0 FROM t GROUP BY c0 ORDER BY SUM(c1) DESC LIMIT 3")


def _having_over_unselected_aggregate(e):
    e.both("SELECT c0, COUNT(*) FROM t GROUP BY c0 HAVING SUM(c1) > 100")


def _empty_results(e):
    assert e.both("SELECT MAX(c1) FROM t WHERE c0 = 999")["max(c1)"] is None
    assert len(e.both("SELECT c0 FROM t WHERE c0 = 999")["c0"]) == 0
    assert len(e.both("SELECT c0, COUNT(*) FROM t WHERE c0 = 999 "
                      "GROUP BY c0")["c0"]) == 0


def _or_and_parentheses(e):
    from nvme_strom_tpu_torch.scan.index import build_index
    e.both("SELECT COUNT(*) FROM t WHERE c0 = 7 OR c0 = 9")
    e.both("SELECT COUNT(*) FROM t WHERE c0 = 7 OR c0 = 9 AND c1 > 0")
    e.both("SELECT COUNT(*) FROM t WHERE (c0 = 7 OR c0 = 9) AND c1 > 0")
    build_index(e.path, e.ts(), 1, device="cpu")
    sql = ("SELECT COUNT(*) FROM t WHERE c1 BETWEEN 0 AND 50 AND "
           "(c0 = 7 OR c0 = 9)")
    q, _ = tsql.parse_sql(sql, e.path, e.ts())
    plan = q.explain(device="cpu")
    assert plan.access_path == "index" and "RECHECKED" in plan.reason
    e.both(sql)


def _review_fixes(e):
    full = e.both("SELECT c0 FROM t GROUP BY c0")
    off2 = e.both("SELECT c0 FROM t GROUP BY c0 OFFSET 2")
    np.testing.assert_array_equal(off2["c0"], full["c0"][2:])
    for sql, needle in [
        ("SELECT c0 FROM t GROUP BY c0 ORDER BY COUNT(c1)",
         "COUNT takes (*)"),
        ("SELECT d.c0 FROM t ORDER BY c0", "no JOIN"),
        ("SELECT SUM(d.c1) FROM t", "no JOIN"),
    ]:
        e.refuse(sql, needle)


def _mixed_where_rides_the_index(e):
    from nvme_strom_tpu_torch.scan.index import build_index
    build_index(e.path, e.ts(), 0, device="cpu")
    sql = "SELECT COUNT(*), SUM(c1) FROM t WHERE c0 = 7 AND c1 > 0"
    q, _ = tsql.parse_sql(sql, e.path, e.ts())
    plan = q.explain(device="cpu")
    assert plan.access_path == "index" and "RECHECKED" in plan.reason
    e.both(sql)


def _not(e):
    e.both("SELECT COUNT(*) FROM t WHERE NOT c0 = 7")
    e.both("SELECT COUNT(*) FROM t WHERE NOT (c0 = 7 OR c0 = 9) AND c1 > 0")
    e.both("SELECT COUNT(*) FROM t WHERE NOT NOT c0 = 7")


def _distinct_alias_multikey_order(e):
    e.both("SELECT DISTINCT c0 FROM t WHERE c1 > 0")
    e.both("SELECT DISTINCT c0 FROM t ORDER BY c0 DESC LIMIT 4")
    out = e.both("SELECT COUNT(*) AS n, SUM(c1) AS total FROM t")
    assert out["n"] == len(e.c0)
    e.both("SELECT c0 AS grp, COUNT(*) AS n FROM t "
           "GROUP BY c0 ORDER BY COUNT(*) DESC LIMIT 2")
    out = e.both("SELECT c0, c1 FROM t ORDER BY c0, c1 LIMIT 20")
    order = np.lexsort((e.c1, e.c0))[:20]
    np.testing.assert_array_equal(out["c1"], e.c1[order])
    e.refuse("SELECT c0 FROM t GROUP BY c0 ORDER BY c0, c1", "multi-key")


def _group_by_three_columns(e):
    rng = np.random.default_rng(51)
    kw = dict(n_cols=4, visibility=False)
    n = JSchema(**kw).tuples_per_page * 4
    cols = [rng.integers(0, k, n).astype(np.int32) for k in (3, 4, 2)]
    c3 = rng.integers(0, 50, n).astype(np.int32)
    path = str(e.tmp / "g3.heap")
    build_heap_file(path, cols + [c3], JSchema(**kw))
    e.both("SELECT c0, c1, c2, COUNT(*), SUM(c3) FROM t "
           "GROUP BY c0, c1, c2 HAVING COUNT(*) > 5", path, kw)


def _requery(e, dest, dschema, jdschema, sqls):
    for sql in sqls:
        got = tsql.sql_query(sql, dest, dschema, device="cpu")
        want = jsql.sql_query(sql, dest, jdschema)
        assert_same_result(got, want, scale=e.scale, what=sql)


def _ctas_pair(e, name, sql, path=None, kw=None, **k):
    """CREATE TABLE AS through both packages, to sibling files; the
    derived schemas equal, and both tables answer *requery* alike."""
    dest, jdest = str(e.tmp / f"{name}.heap"), str(e.tmp / f"j{name}.heap")
    ts = tsql.create_table_as(dest, sql, path or e.path, e.ts(kw),
                              tables=e._tables(True), device="cpu", **k)
    js = jsql.create_table_as(jdest, sql, path or e.path, e.js(kw),
                              tables=e._tables(False), **k)
    assert ts[1] == js[1]
    assert ts[0].n_cols == js[0].n_cols and ts[0].dtypes == js[0].dtypes \
        and ts[0].nullable == js[0].nullable
    assert open(dest, "rb").read() == open(jdest, "rb").read()
    return dest, ts[0]


def _create_table_as(e):
    dest, ds = _ctas_pair(e, "derived", "SELECT c0, c1 FROM t WHERE c0 < 10")
    _requery(e, dest, ds, JSchema(**{"n_cols": 2, "visibility": False,
                                     "dtypes": ds.dtypes}),
             ["SELECT COUNT(*), SUM(c1) FROM t"])
    dest2, g2 = _ctas_pair(e, "grouped",
                           "SELECT c0 AS k, COUNT(*) AS n, AVG(c1) AS m "
                           "FROM t GROUP BY c0")
    assert g2.col_dtype(2).kind == "f"
    _ctas_pair(e, "scalar", "SELECT COUNT(*), SUM(c1) FROM t")
    # an existing destination is EEXIST unless overwrite=True
    with pytest.raises(StromError) as ei:
        tsql.create_table_as(dest, "SELECT c0 FROM t", e.path, e.ts(),
                             device="cpu")
    assert ei.value.errno == errno.EEXIST
    tsql.create_table_as(dest, "SELECT c0 FROM t WHERE c0 < 5", e.path,
                         e.ts(), overwrite=True, device="cpu")
    out = tsql.sql_query("SELECT COUNT(*) FROM t", dest,
                         HeapSchema(n_cols=1, visibility=False),
                         device="cpu")
    assert out["count(*)"] == int((e.c0 < 5).sum())


def _create_table_as_strings(e):
    from nvme_strom_tpu.scan.strings import encode_strings, save_dict
    kw = dict(n_cols=2, visibility=False, dtypes=("uint32", "int32"))
    names = ["b", "a", "c", "a", "b", "a"] * 100
    codes, d = encode_strings(names)
    src = str(e.tmp / "src.heap")
    build_heap_file(src, [codes, np.arange(len(names), dtype=np.int32)],
                    JSchema(**kw))
    save_dict(src, 0, d)
    dest, g = _ctas_pair(e, "agg", "SELECT c0, COUNT(*) FROM t GROUP BY c0",
                         src, kw)
    # both derived tables carry equal sidecars, and requery through them
    assert open(dest + ".dict0").read().split('"table_mtime_ns"')[0] == \
        open(str(e.tmp / "jagg.heap.dict0")).read().split(
            '"table_mtime_ns"')[0]
    got = tsql.sql_query("SELECT c1 FROM t WHERE c0 = 'a'", dest, g,
                         device="cpu")
    assert got["c1"][0] == names.count("a")


def _join_aggregate_faces(e):
    e.both("SELECT COUNT(*), SUM(c0), SUM(d.c1) FROM t JOIN d ON c1 = d.c0")
    e.both("SELECT COUNT(*) FROM t ANTI JOIN d ON c1 = d.c0")
    e.both("SELECT COUNT(*), SUM(d.c1) FROM t LEFT JOIN d ON c1 = d.c0 "
           "WHERE c0 > 0")
    e.both("SELECT COUNT(*) FROM t SEMI JOIN d ON c1 = d.c0")


def _join_row_face(e):
    out = e.both("SELECT c1, d.c1 FROM t JOIN d ON c1 = d.c0")
    partner = e.c1 < 8
    np.testing.assert_array_equal(np.sort(out["positions"]),
                                  np.flatnonzero(partner))
    out = e.both("SELECT c1, d.c1 FROM t LEFT JOIN d ON c1 = d.c0 LIMIT 20")
    assert len(out["c1"]) == 20 and (out["d.c1"][~out["matched"]] == 0).all()


def _join_rejections(e):
    for sql, needle in [
        ("SELECT COUNT(*) FROM t JOIN x ON c1 = x.c0", "not bound"),
        ("SELECT COUNT(*) FROM t JOIN d ON c1 = c0", "equate"),
        ("SELECT d.c1 FROM t SEMI JOIN d ON c1 = d.c0", "EXISTS"),
        ("SELECT c0, d.c1 FROM t JOIN d ON c1 = d.c0", "probe column"),
        ("SELECT c1, COUNT(*) FROM t JOIN d ON c1 = d.c0",
         "mixes aggregates"),
        ("SELECT COUNT(*) FROM t JOIN d ON c1 = d.c0 GROUP BY c0",
         "outside this subset"),
        ("SELECT AVG(c0) FROM t JOIN d ON c1 = d.c0", "outside this subset"),
        ("SELECT COUNT(*) FROM t LEFT d ON c1 = d.c0", "JOIN"),
    ]:
        assert e.refuse(sql, needle).errno == errno.EINVAL


def _create_table_as_left_join_real_nulls(e):
    dest, g = _ctas_pair(e, "lj", "SELECT c1, d.c1 FROM t LEFT JOIN d ON "
                                  "c1 = d.c0")
    assert g.nullable == (False, True)
    _requery(e, dest, g, JSchema(n_cols=2, visibility=False,
                                 nullable=(False, True)),
             ["SELECT COUNT(*), COUNT(c1) FROM t"])


def _join_float_payload(e):
    kw = dict(n_cols=2, visibility=False, dtypes=("int32", "float32"))
    keys = np.arange(0, 8, dtype=np.int32)
    fv = (keys * 0.5).astype(np.float32)
    d2 = str(e.tmp / "fdim.heap")
    build_heap_file(d2, [keys, fv], JSchema(**kw))
    e.tables = {"d": (d2, kw)}
    out = e.both("SELECT COUNT(*), SUM(d.c1) FROM t JOIN d ON c1 = d.c0")
    assert isinstance(out["sum(d.c1)"], float)


TABLE_CASES = (
    _scalar_aggregates, _where_forms, _group_by_with_having,
    _select_order_limit, _min_max_count_distinct, _star_projection,
    _rides_the_index, _mesh_mode, _rejects_out_of_subset,
    _order_by_projection, _top_n_groups, _having_over_unselected_aggregate,
    _empty_results, _or_and_parentheses, _review_fixes,
    _mixed_where_rides_the_index, _not, _distinct_alias_multikey_order,
    _group_by_three_columns, _create_table_as, _create_table_as_strings)
JOIN_CASES = (_join_aggregate_faces, _join_row_face, _join_rejections,
              _create_table_as_left_join_real_nulls, _join_float_payload)


@pytest.mark.parametrize("case", TABLE_CASES,
                         ids=[f.__name__[1:] for f in TABLE_CASES])
def test_sql_against_jax(table, case):
    case(table)


@pytest.mark.parametrize("case", JOIN_CASES,
                         ids=[f.__name__[1:] for f in JOIN_CASES])
def test_sql_join_against_jax(joined, case):
    case(joined)


# --- the JAX package's ORDER BY drops projected NULLs; the port does not --

NKW = dict(n_cols=2, visibility=False, dtypes=("int32", "int32"),
           nullable=(True, False))


def test_fault_order_by_projection_keeps_nulls(tmp_path, configs):
    """``SELECT c0, c1 ... ORDER BY c1`` over a nullable ``c0``: the port's
    projected ``c0`` is None at NULL rows, as numpy's truth and as the JAX
    package's plain select face of the same rows (its ORDER BY face
    returns the stored word); with a dictionary on ``c0``, None where the
    JAX package returns the dictionary's first string."""
    from nvme_strom_tpu.scan.strings import encode_strings, save_dict
    rng = np.random.default_rng(5)
    n = 2000
    c0 = rng.integers(1, 10, n).astype(np.int32)
    nulls = np.arange(n) % 4 == 0
    # the 5 smallest c1 sit at rows 0, 5, 8 (two NULL c0) and 2 others
    order = np.concatenate([[0, 5, 8], rng.permutation(
        np.setdiff1d(np.arange(n), [0, 5, 8]))])
    c1 = np.empty(n, np.int32)
    c1[order] = np.arange(n, dtype=np.int32)
    path = str(tmp_path / "o.heap")
    build_heap_file(path, [c0, c1], JSchema(**NKW), nulls={0: nulls})
    got = tsql.sql_query("SELECT c0, c1 FROM t ORDER BY c1 LIMIT 5", path,
                         HeapSchema(**NKW), device="cpu")
    pos = got["positions"]
    np.testing.assert_array_equal(pos, np.argsort(c1)[:5])
    truth = [None if nulls[p] else int(c0[p]) for p in pos]
    assert list(got["c0"]) == truth and None in truth
    plain = jsql.sql_query("SELECT c0, c1 FROM t", path, JSchema(**NKW))
    assert [plain["c0"][p] for p in pos] == truth
    # a dictionary column: None, never the first string
    kw = dict(NKW, dtypes=("uint32", "int32"))
    names = np.array(["Ams", "Ber", "Chi"], object)[c0 % 3]
    codes, d = encode_strings(names.tolist())
    spath = str(tmp_path / "s.heap")
    build_heap_file(spath, [codes, c1], JSchema(**kw), nulls={0: nulls})
    save_dict(spath, 0, d)
    got = tsql.sql_query("SELECT c0, c1 FROM t ORDER BY c1 LIMIT 5", spath,
                         HeapSchema(**kw), device="cpu")
    assert list(got["c0"]) == [None if nulls[p] else names[p] for p in pos]


def test_fault_not_of_folded_leaf_is_false_not_unknown(tmp_path, configs):
    """``NOT (c1 IS NOT NULL)`` over a non-nullable ``c1`` folds to FALSE
    on every row, never UNKNOWN: ``NOT NOT (c1 IS NOT NULL)`` keeps all
    2000 rows, numpy's truth and the JAX package's ``c1 IS NOT NULL`` face
    (its own NOT-of-NOT face borrows c0's NULLs as UNKNOWN and keeps
    1500)."""
    kw = dict(n_cols=2, visibility=False, nullable=(True, False))
    n = 2000
    path = str(tmp_path / "f.heap")
    build_heap_file(path, [np.arange(n, dtype=np.int32)] * 2, JSchema(**kw),
                    nulls={0: np.arange(n) % 4 == 0})
    for where, truth in (("NOT (NOT (c1 IS NOT NULL))", n),
                         ("NOT (c1 IS NOT NULL)", 0),
                         ("NOT (NOT (c1 IS NOT NULL)) AND c0 > 5",
                          int(((np.arange(n) % 4 != 0)
                               & (np.arange(n) > 5)).sum()))):
        got = tsql.sql_query(f"SELECT COUNT(*) FROM t WHERE {where}", path,
                             HeapSchema(**kw), device="cpu")
        assert got["count(*)"] == truth, where
    assert jsql.sql_query("SELECT COUNT(*) FROM t WHERE c1 IS NOT NULL",
                          path, JSchema(**kw))["count(*)"] == n


# --- SUM over no non-NULL row is NULL in the port, 0 in the JAX package --

ZKW = dict(n_cols=3, visibility=False, dtypes=("int32", "int32", "float32"),
           nullable=(False, True, True))
DZKW = dict(n_cols=2, visibility=False)


@pytest.fixture()
def zero_sums(tmp_path, configs):
    """ROADMAP's nullable 20000-row table: c0 in [0, 100), c1 and c2 NULL
    on every c0 = 99 row and on a fifth of the others; dimension d keyed
    0..99 (payload 10·k), e keyed 0..89 (payload 3·k)."""
    rng = np.random.default_rng(22)
    n = 20000
    c0 = rng.integers(0, 100, n).astype(np.int32)
    c1 = rng.integers(-50, 50, n).astype(np.int32)
    c2 = rng.standard_normal(n).astype(np.float32)
    nulls = {1: (c0 == 99) | (rng.random(n) < 0.2),
             2: (c0 == 99) | (rng.random(n) < 0.2)}
    path = str(tmp_path / "z.heap")
    build_heap_file(path, [c0, c1, c2], JSchema(**ZKW), nulls=nulls)
    tables = {}
    for name, hi, mul in (("d", 100, 10), ("e", 90, 3)):
        k = np.arange(hi, dtype=np.int32)
        p = str(tmp_path / f"{name}.heap")
        build_heap_file(p, [k, k * mul], JSchema(**DZKW))
        tables[name] = (p, DZKW)
    return Env(path, ZKW, tables=tables, c0=c0, c1=c1, c2=c2, nulls=nulls)


def _zero_sum_truth(e, face):
    """The statements of a face with numpy's answer: each label's SUM over
    its non-NULL cells, None where there is none."""
    def total(vals, rows):
        return None if not rows.any() else vals[rows].sum().item()
    nn1, nn2 = ~e.nulls[1], ~e.nulls[2]
    eq99, none = e.c0 == 99, e.c0 > 1000
    if face == "scalar":
        return [("SELECT SUM(c1), AVG(c1), SUM(c2) FROM t WHERE c0 = 99",
                 {"sum(c1)": total(e.c1, eq99 & nn1), "avg(c1)": None,
                  "sum(c2)": total(e.c2, eq99 & nn2)}),
                ("SELECT SUM(c0), AVG(c0) FROM t WHERE c0 > 1000",
                 {"sum(c0)": None, "avg(c0)": None})]
    if face == "join":
        ge90 = e.c0 >= 90
        return [("SELECT COUNT(*), SUM(c1), SUM(d.c1) FROM t JOIN d ON "
                 "c0 = d.c0 WHERE c0 = 99",
                 {"count(*)": int(eq99.sum()), "sum(c1)": total(
                     e.c1, eq99 & nn1), "sum(d.c1)": 990 * int(eq99.sum())}),
                ("SELECT COUNT(*), SUM(e.c1) FROM t LEFT JOIN e ON c0 = e.c0 "
                 "WHERE c0 >= 90", {"count(*)": int(ge90.sum()),
                                    "sum(e.c1)": None}),
                ("SELECT COUNT(*), SUM(c0), SUM(d.c1) FROM t JOIN d ON "
                 "c0 = d.c0 WHERE c0 > 1000",
                 {"count(*)": 0, "sum(c0)": None, "sum(d.c1)": None})]
    return [("SELECT COUNT(*), SUM(c1), AVG(c1), SUM(d.c1), SUM(e.c1) FROM t "
             "JOIN d ON c0 = d.c0 LEFT JOIN e ON c0 = e.c0 WHERE c0 = 99",
             {"count(*)": int(eq99.sum()), "sum(c1)": total(e.c1, eq99 & nn1),
              "avg(c1)": None, "sum(d.c1)": 990 * int(eq99.sum()),
              "sum(e.c1)": None}),
            ("SELECT COUNT(*), SUM(c2), SUM(d.c1), SUM(e.c1) FROM t JOIN d ON "
             "c0 = d.c0 LEFT JOIN e ON c0 = e.c0 WHERE c0 > 1000",
             {"count(*)": 0, "sum(c2)": None, "sum(d.c1)": None,
              "sum(e.c1)": None})]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("face", ["scalar", "join", "star"])
def test_fault_sum_over_no_non_null_rows_is_null(zero_sums, face, workers):
    """SQL's SUM over no non-NULL cell is NULL: the port's scalar, join and
    star faces return None there, as numpy's truth, where the JAX package
    returns 0 (its AVG in the same statement is None already).  A JOIN at
    ``workers=2`` is refused by both packages (EINVAL), so that case
    holds the refusal."""
    e = zero_sums
    for sql, truth in _zero_sum_truth(e, face):
        assert None in truth.values() and sql
        if face == "join" and workers:
            with pytest.raises(StromError) as ei:
                e.port(sql, workers=workers)
            with pytest.raises(OSError) as ej:
                e.jax(sql, workers=workers)
            assert ei.value.errno == ej.value.errno == errno.EINVAL
            assert "worker-servable" in str(ei.value)
            continue
        got = e.port(sql, workers=workers)
        want = e.jax(sql, workers=workers)
        got.pop("_workers", None)
        want.pop("_workers", None)
        assert set(got) == set(truth) == set(want), sql
        for k, v in truth.items():
            if v is None:
                assert got[k] is None, (sql, k, got[k])
                if k.startswith("sum("):
                    assert want[k] == 0, (sql, k, want[k])
                else:
                    assert want[k] is None, (sql, k, want[k])
            else:
                assert_same_result({k: got[k]}, {k: v}, what=sql)
                assert_same_result({k: got[k]}, {k: want[k]}, what=sql)
