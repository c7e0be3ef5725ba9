"""The port's dictionary-encoded string columns (``scan/strings.py``) and
their SQL face against the JAX package's, on the same heap bytes and the
same sidecars.  Every case of ``tests/test_strings.py`` runs its
statements through both packages' ``sql_query`` (the port on
``device="cpu"``): counts, sums, strings and positions exact, floats
within ``1e-4 * sum(|x|) + 1e-6``.  A refusal raises in both packages,
with the same errno and the same words.

Two faults of the JAX package's facade on a nullable string column are
not copied, and are held against numpy truth here: ``!=`` against an
absent string keeps its NULL rows UNKNOWN (the JAX package counts them;
its ``IS NOT NULL`` face gives the right rows), and selecting the column
decodes None at the NULL rows (the JAX package raises TypeError)."""

import errno

import numpy as np
import pytest

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan import strings as jstr
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.heap import build_heap_file
from nvme_strom_tpu.scan.sql import sql_query as jsql
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.scan import strings as tstr
from nvme_strom_tpu_torch.scan.heap import HeapSchema
from nvme_strom_tpu_torch.scan.sql import parse_sql, sql_query
from nvme_strom_tpu_torch.testing.sql_results import assert_same_result

CITIES = ["Berlin", "Amsterdam", "Chicago", "Berlin", "Austin",
          "Boston", "Chicago", "Berlin"]
KW = dict(n_cols=2, visibility=False, dtypes=("uint32", "int32"))


@pytest.fixture()
def configs():
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    config.set("debug_no_threshold", True)
    jconfig.set("debug_no_threshold", True)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


@pytest.fixture()
def table(tmp_path, configs):
    """The reference test's table: written by the JAX package, its
    dictionary sidecar by the JAX package's ``save_dict``."""
    rng = np.random.default_rng(8)
    n = JSchema(**KW).tuples_per_page * 2
    names = [CITIES[i % len(CITIES)] for i in range(n)]
    codes, d = jstr.encode_strings(names)
    c1 = rng.integers(0, 100, n).astype(np.int32)
    path = str(tmp_path / "s.heap")
    build_heap_file(path, [codes, c1], JSchema(**KW))
    jstr.save_dict(path, 0, d)
    return path, np.array(names, object), c1


def both(sql, path, **kw):
    """The statement through both packages; the port's answer."""
    got = sql_query(sql, path, HeapSchema(**KW), device="cpu", **kw)
    want = jsql(sql, path, JSchema(**KW), **kw)
    assert_same_result(got, want, what=sql)
    return got


def both_refuse(sql, path, needle, **kw):
    with pytest.raises(StromError) as ei:
        sql_query(sql, path, HeapSchema(**KW), device="cpu", **kw)
    with pytest.raises(OSError) as ej:
        jsql(sql, path, JSchema(**KW), **kw)
    assert ei.value.errno == ej.value.errno, sql
    assert needle.lower() in str(ei.value).lower(), sql
    assert needle.lower() in str(ej.value).lower(), sql
    return ei.value


def _dict_roundtrip_and_order(_path, _names, _c1):
    codes, d = tstr.encode_strings(CITIES)
    jcodes, jd = jstr.encode_strings(CITIES)
    np.testing.assert_array_equal(codes, jcodes)
    assert codes.dtype == np.uint32
    assert list(d.decode(codes)) == list(jd.decode(jcodes)) == CITIES
    assert d.values == jd.values == sorted(set(CITIES))
    assert d.code_of("nope") is None and d.code_of("Boston") == \
        jd.code_of("Boston")
    for lo, hi in (("B", "Bz"), ("A", None), (None, "Bo"), ("Z", "Zz"),
                   ("Berlin", "Berlin"), ("", "C")):
        assert d.range_codes(lo, hi) == jd.range_codes(lo, hi), (lo, hi)
    lo, hi = d.range_codes("B", "Bz")
    assert [d.values[c] for c in range(lo, hi + 1)] == ["Berlin", "Boston"]
    with pytest.raises(StromError) as ei:
        d.encode(["Berlin", "Paris"])
    assert ei.value.errno == errno.EINVAL
    with pytest.raises(StromError) as ei:
        d.decode([0, len(d.values)])
    assert ei.value.errno == errno.EINVAL


def _string_equality_and_group(path, names, c1):
    out = both("SELECT COUNT(*), SUM(c1) FROM t WHERE c0 = 'Berlin'", path)
    m = names == "Berlin"
    assert out["count(*)"] == int(m.sum())
    assert out["sum(c1)"] == int(c1[m].sum())
    assert both("SELECT COUNT(*) FROM t WHERE c0 = 'Nowhere'",
                path)["count(*)"] == 0
    out = both("SELECT c0, COUNT(*) FROM t GROUP BY c0 "
               "ORDER BY COUNT(*) DESC LIMIT 3", path)
    assert all(isinstance(x, str) for x in out["c0"])


def _string_ranges_and_order(path, names, c1):
    sn = names.astype(str)
    assert both("SELECT COUNT(*) FROM t WHERE c0 BETWEEN 'A' AND 'Bz'",
                path)["count(*)"] == int(((sn >= "A") & (sn <= "Bz")).sum())
    both("SELECT COUNT(*) FROM t WHERE c0 < 'Boston'", path)
    both("SELECT COUNT(*) FROM t WHERE c0 >= 'Boston' AND c1 > 50", path)
    both("SELECT COUNT(*) FROM t WHERE c0 IN ('Austin', 'Boston', "
         "'Nowhere')", path)
    out = both("SELECT c0 FROM t ORDER BY c0 LIMIT 5", path)
    np.testing.assert_array_equal(out["c0"], np.sort(sn)[:5])
    assert both("SELECT COUNT(*) FROM t WHERE c0 != 'Berlin'",
                path)["count(*)"] == int((sn != "Berlin").sum())
    assert both("SELECT COUNT(*) FROM t WHERE c0 <> 'Nowhere'",
                path)["count(*)"] == len(sn)


def _string_minmax_and_rejections(path, names, c1):
    sn = names.astype(str)
    assert both("SELECT MAX(c0) FROM t", path)["max(c0)"] == max(sn)
    assert both("SELECT MIN(c0) FROM t WHERE c1 > 50",
                path)["min(c0)"] == min(sn[c1 > 50])
    assert both("SELECT COUNT(DISTINCT c0) FROM t",
                path)["count(distinct c0)"] == len(set(sn))
    for sql, needle in [
        ("SELECT SUM(c0) FROM t", "string column"),
        ("SELECT c0, AVG(c0) FROM t GROUP BY c0", "string column"),
        ("SELECT COUNT(*) FROM t WHERE c0 = 5", "comparing"),
        ("SELECT COUNT(*) FROM t WHERE c1 = 'x'", "no string dict"),
        ("SELECT COUNT(*) FROM t WHERE c0 BETWEEN 'A' AND 5", "mixes"),
        ("SELECT COUNT(*) FROM t WHERE c0 IN ('A', 5)", "mixes"),
        ("SELECT c0, MIN(c1) FROM t GROUP BY c0 HAVING MIN(c1) > 'x'",
         "outside this subset"),
    ]:
        assert both_refuse(sql, path, needle).errno == errno.EINVAL


def _string_index_scan(path, names, c1):
    from nvme_strom_tpu_torch.scan.index import build_index
    build_index(path, HeapSchema(**KW), 0, device="cpu")
    sql = "SELECT COUNT(*) FROM t WHERE c0 = 'Chicago'"
    q, _ = parse_sql(sql, path, HeapSchema(**KW))
    assert q.explain(device="cpu").access_path == "index"
    assert both(sql, path)["count(*)"] == int((names == "Chicago").sum())


def _stale_dict_fails_loudly(path, names, c1):
    codes2, _d2 = jstr.encode_strings(["x"] * len(names))
    build_heap_file(path, [codes2, np.zeros(len(names), np.int32)],
                    JSchema(**KW))
    err = both_refuse("SELECT COUNT(*) FROM t WHERE c0 = 'Berlin'", path,
                      "STALE")
    assert err.errno == errno.EIO
    with pytest.raises(StromError) as ei:
        tstr.load_dict(path, 0)
    assert ei.value.errno == errno.EIO
    assert tstr.load_dict(path, 0, check_stale=False).values == \
        sorted(set(CITIES))
    # a stale sidecar never decodes, on the select face either
    both_refuse("SELECT c0 FROM t LIMIT 3", path, "STALE")


def _string_join_rejected(path, names, c1):
    dcodes, dd = jstr.encode_strings(["Berlin", "Boston"])
    dpath = path + ".dim"
    build_heap_file(dpath, [dcodes, np.arange(2, dtype=np.int32)],
                    JSchema(**KW))
    jstr.save_dict(dpath, 0, dd)
    with pytest.raises(StromError) as ei:
        sql_query("SELECT COUNT(*) FROM t JOIN d ON c0 = d.c0", path,
                  HeapSchema(**KW), tables={"d": (dpath, HeapSchema(**KW))},
                  device="cpu")
    with pytest.raises(OSError) as ej:
        jsql("SELECT COUNT(*) FROM t JOIN d ON c0 = d.c0", path,
             JSchema(**KW), tables={"d": (dpath, JSchema(**KW))})
    assert "incomparable" in str(ei.value) and "incomparable" in str(ej.value)


def _string_index_cond_plus_residual(path, names, c1):
    from nvme_strom_tpu_torch.scan.index import build_index
    build_index(path, HeapSchema(**KW), 0, device="cpu")
    sql = "SELECT COUNT(*) FROM t WHERE c0 = 'Chicago' AND c1 > 50"
    q, _ = parse_sql(sql, path, HeapSchema(**KW))
    plan = q.explain(device="cpu")
    assert plan.access_path == "index" and "RECHECKED" in plan.reason
    assert both(sql, path)["count(*)"] == \
        int(((names == "Chicago") & (c1 > 50)).sum())


CASES = {f.__name__[1:]: f for f in (
    _dict_roundtrip_and_order, _string_equality_and_group,
    _string_ranges_and_order, _string_minmax_and_rejections,
    _string_index_scan, _stale_dict_fails_loudly, _string_join_rejected,
    _string_index_cond_plus_residual)}


@pytest.mark.parametrize("case", list(CASES))
def test_strings_against_jax(table, case):
    CASES[case](*table)


def test_sidecars_round_trip_both_ways(tmp_path):
    """Each package reads the other's sidecar, and both write it byte for
    byte alike (same JSON, same stamp)."""
    names = ["b", "a", "é", "c", "a", "b''", ""] * 50
    codes, d = tstr.encode_strings(names)
    jcodes, jd = jstr.encode_strings(names)
    np.testing.assert_array_equal(codes, jcodes)
    path = str(tmp_path / "t.heap")
    build_heap_file(path, [codes, np.arange(len(names), dtype=np.int32)],
                    JSchema(**KW))
    p = tstr.save_dict(path, 0, d)
    port_bytes = open(p, "rb").read()
    assert jstr.load_dict(path, 0).values == d.values
    assert jstr.dict_path_for(path, 0) == p == tstr.dict_path_for(path, 0)
    jstr.save_dict(path, 0, jd)
    assert open(p, "rb").read() == port_bytes
    loaded = tstr.load_dict(path, 0)
    assert loaded.values == jd.values
    assert list(loaded.decode(codes)) == names


NULL_KW = dict(n_cols=2, visibility=False, dtypes=("uint32", "int32"),
               nullable=(True, False))


@pytest.fixture()
def null_table(tmp_path, configs):
    """2000 rows of a nullable string column (every 4th row NULL) and an
    int32 column, written by the JAX package."""
    rng = np.random.default_rng(13)
    n = 2000
    names = np.array([CITIES[i % 7] for i in range(n)], object)
    nulls = np.arange(n) % 4 == 0
    codes, d = jstr.encode_strings(names.tolist())
    c1 = rng.integers(-100, 100, n).astype(np.int32)
    path = str(tmp_path / "n.heap")
    build_heap_file(path, [codes, c1], JSchema(**NULL_KW), nulls={0: nulls})
    jstr.save_dict(path, 0, d)
    return path, names, nulls, c1


def _count(sql, path):
    return sql_query(sql, path, HeapSchema(**NULL_KW),
                     device="cpu")["count(*)"]


def test_fault_absent_string_ne_keeps_nulls_unknown(null_table):
    """``c0 != 'absent'`` is UNKNOWN on a NULL row: the port selects the
    1500 non-NULL rows, numpy's truth and the JAX package's ``IS NOT
    NULL`` face (its ``!=`` face counts the NULL rows too)."""
    path, names, nulls, c1 = null_table
    truth = int((~nulls).sum())
    assert truth == 1500
    assert _count("SELECT COUNT(*) FROM t WHERE c0 != 'absent string'",
                  path) == truth
    assert jsql("SELECT COUNT(*) FROM t WHERE c0 IS NOT NULL", path,
                JSchema(**NULL_KW))["count(*)"] == truth
    assert _count("SELECT COUNT(*) FROM t WHERE c0 <> 'absent' OR c1 < 0",
                  path) == int((~nulls | (c1 < 0)).sum())
    # NOT of UNKNOWN stays UNKNOWN, NOT of TRUE is FALSE: no row
    assert _count("SELECT COUNT(*) FROM t WHERE NOT c0 != 'absent'",
                  path) == 0
    # a present string was right in both packages
    sql = "SELECT COUNT(*) FROM t WHERE c0 != 'Berlin'"
    truth = int((~nulls & (names != "Berlin")).sum())
    assert _count(sql, path) == truth
    assert jsql(sql, path, JSchema(**NULL_KW))["count(*)"] == truth


def test_fault_nullable_string_select_decodes_none(null_table):
    """Selecting a nullable string column gives None at its NULL rows and
    the strings elsewhere (the JAX package raises TypeError)."""
    path, names, nulls, c1 = null_table
    out = sql_query("SELECT c0, c1 FROM t LIMIT 6", path,
                    HeapSchema(**NULL_KW), device="cpu")
    pos = out["positions"]
    assert len(pos) == 6
    want = [None if nulls[p] else names[p] for p in pos]
    assert list(out["c0"]) == want and want[0] is None
    np.testing.assert_array_equal(out["c1"], c1[pos])
    # where the JAX package's select face is right (a non-NULL row), the
    # port agrees with it
    sql = "SELECT c0, c1 FROM t WHERE c0 IS NOT NULL LIMIT 6"
    assert_same_result(sql_query(sql, path, HeapSchema(**NULL_KW),
                                 device="cpu"),
                       jsql(sql, path, JSchema(**NULL_KW)), what=sql)
