"""The port's expression grammar (``scan/sql.py``), ``aggregate_exprs``
and ``star_join`` (``ops/join.py`` star steps, ``scan/query.py``) against
the JAX package's on the same heap bytes.  The port runs with
``device="cpu"`` (its ``torch`` route), the JAX package on its CPU
backend, both through their table scanners at 64 KiB chunks.

Tolerances: counts, integer sums (int32 and uint32 wrap mod 2^32),
per-dimension counts, payloads, masks, positions and row orders
bit-identical (positions compared as int64); an expression over 4-byte
columns evaluates bit for bit as the JAX package's (NaN where it has NaN);
float32 sums within ``1e-5 * sum(|x|) + 1e-6``.  Expressions over 8-byte
columns are held against numpy (float64 sums within ``1e-12 * sum(|x|)``,
int64 exact): the recorded divergence from the JAX package, which types
them by its 4-byte rule."""

import errno

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
KW = dict(n_cols=5, visibility=True,
          dtypes=("int32", "int32", "int32", "float32", "uint32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)


def col(c):
    return ("col", c)


def lit(v):
    return ("lit", v)


def b(op, left, right):
    return ("bin", op, left, right)


@pytest.fixture()
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


def _dim(d, name, keys, vals, dtypes):
    """A dimension heap file written by the JAX package, padded to whole
    pages with keys no fact row carries."""
    kw = dict(n_cols=2, visibility=False, dtypes=dtypes)
    t = JSchema(**kw).tuples_per_page
    pad = (-len(keys)) % t
    pk = np.concatenate([keys, np.arange(90_000, 90_000 + pad,
                                         dtype=np.int32)])
    pv = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    path = str(d / f"{name}.heap")
    build_heap_file(path, [pk, pv], JSchema(**kw))
    return path, HeapSchema(**kw), JSchema(**kw)


@pytest.fixture(scope="module")
def star(tmp_path_factory):
    """A fact table (c0 the d1 key in [0, 120), c1 the d2 key in [0, 80),
    c2 int32 in [-50, 50) with INT_MIN/INT_MAX, c3 float32 with NaN and
    ±inf, c4 uint32; 15% invisible) and three dimensions: d1 keys 0..99
    with int32 payloads, d2 keys 0..59 with float32 payloads, d3 the even
    keys of [0, 120) with uint32 payloads."""
    d = tmp_path_factory.mktemp("star")
    rng = np.random.default_rng(1)
    n = SCHEMA.tuples_per_page * 9 + 31
    c0 = rng.integers(0, 120, n).astype(np.int32)
    c1 = rng.integers(0, 80, n).astype(np.int32)
    c2 = rng.integers(-50, 50, n).astype(np.int32)
    c2[:4] = [INT_MIN, INT_MAX, INT_MAX, -1]
    c3 = rng.normal(size=n).astype(np.float32)
    c3[4:8] = [np.nan, np.inf, -np.inf, 0.0]
    c4 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    vis = (rng.random(n) > 0.15).astype(np.int32)
    fact = str(d / "fact.heap")
    cols = [c0, c1, c2, c3, c4]
    build_heap_file(fact, cols, JS, visibility=vis)
    d1k = np.arange(100, dtype=np.int32)
    d1v = rng.integers(0, 1000, 100).astype(np.int32)
    d2k = np.arange(60, dtype=np.int32)
    d2v = rng.normal(size=60).astype(np.float32)
    d3k = np.arange(0, 120, 2, dtype=np.int32)
    d3v = rng.integers(0, 1 << 32, 60, dtype=np.uint64).astype(np.uint32)
    dims = {"d1": _dim(d, "d1", d1k, d1v, ("int32", "int32")),
            "d2": _dim(d, "d2", d2k, d2v, ("int32", "float32")),
            "d3": _dim(d, "d3", d3k, d3v, ("int32", "uint32"))}
    arrays = {"d1": (d1k, d1v), "d2": (d2k, d2v), "d3": (d3k, d3v)}
    return fact, cols, vis != 0, dims, arrays


def _np(x):
    return np.asarray(x)


def _same(got, want, mag=None, what=""):
    g, w = _np(got), _np(want)
    if {g.dtype.itemsize, w.dtype.itemsize} == {4, 8} \
            and g.dtype.kind in "iu" and w.dtype.kind in "iu":
        g, w = g.astype(np.int64), w.astype(np.int64)   # positions
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    if g.dtype.kind == "f":
        tol = 1e-5 * (np.abs(w).sum() if mag is None else mag) + 1e-6
        with np.errstate(invalid="ignore"):     # inf - inf, NaN
            close = np.abs(g.astype(np.float64) - w) <= tol
        both_nan = np.isnan(g) & np.isnan(w)
        same_inf = np.isinf(w) & (g == w)
        assert np.all(close | both_nan | same_inf), (what, g, w)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def _same_result(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], (list, tuple)):
            assert len(got[k]) == len(want[k]), k
            for i, (g, w) in enumerate(zip(got[k], want[k])):
                _same(g, w, what=f"{k}[{i}]")
        else:
            _same(got[k], want[k], what=k)


# -- the grammar --------------------------------------------------------------

_REFUSED = {
    "uint32 in arithmetic": b("+", col(4), lit(1)),
    "uint32 on the right": b("*", col(0), col(4)),
    "negating uint32": ("neg", col(4)),
    "int / int": b("/", col(0), col(2)),
    "int / int literal": b("/", col(0), lit(2)),
    "literal above int32": b("+", col(0), lit(1 << 31)),
    "literal below int32": b("-", col(0), lit(-(1 << 31) - 1)),
    "string literal": "str",
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_expr_info_refusals_match_jax(case):
    """The same trees are refused with the same EINVAL message."""
    tree = _REFUSED[case]
    if tree == "str":
        trees = (b("+", col(0), lit(tsql._Str("x"))),
                 b("+", col(0), lit(jsql._Str("x"))))
    else:
        trees = (tree, tree)
    with pytest.raises(StromError) as e:
        tsql._expr_info(trees[0], SCHEMA)
    with pytest.raises(Exception) as je:
        jsql._expr_info(trees[1], JS)
    assert e.value.errno == errno.EINVAL == je.value.errno
    assert e.value.strerror == je.value.strerror


_EXPRS = {
    "INT_MAX * 2 wraps": b("*", col(2), lit(2)),
    "-INT_MIN wraps": ("neg", col(2)),
    "int + int": b("+", col(0), col(2)),
    "int - literal": b("-", col(2), lit(INT_MAX)),
    "x / 0.0": b("/", col(3), lit(0.0)),
    "int / 0.0": b("/", col(2), lit(0.0)),
    "NaN operands": b("*", col(3), col(3)),
    "float literal promotes": b("+", col(0), lit(0.5)),
    "nested": b("-", b("*", col(0), col(1)), ("neg", b("/", col(3),
                                                       lit(4.0)))),
    "lone uint32": col(4),
    "lone literal": lit(7),
    "float column": col(3),
}


@pytest.mark.parametrize("case", sorted(_EXPRS))
def test_eval_expr_matches_jax_bit_for_bit(star, case):
    """Each tree evaluates to the JAX package's values, bit for bit, in
    the dtype both ``_expr_info``s name."""
    _fact, cols, _vis, _dims, _arrays = star
    tree = _EXPRS[case]
    dt, cs = tsql._expr_info(tree, SCHEMA)
    jdt, jcs = jsql._expr_info(tree, JS)
    assert dt == jdt and cs == jcs
    tcols = [torch.from_numpy(c.astype(np.int64) if c.dtype == np.uint32
                              else c) for c in cols]
    got = np.broadcast_to(tsql._eval_expr(tree, tcols).numpy(),
                          cols[0].shape)
    want = np.broadcast_to(np.asarray(jsql._eval_expr(
        tree, [jnp.asarray(c) for c in cols])), cols[0].shape)
    if dt == np.dtype(np.uint32):
        got = got.astype(np.uint32)
    assert got.dtype == want.dtype == dt
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))
    assert tsql._expr_str(tree) == jsql._expr_str(tree)


# -- aggregate_exprs ----------------------------------------------------------

_AGG = {
    "all": (None, None, lambda c: True),
    "c2 > 0": (FilterPred(((2, "gt", 0),)), lambda c: c[2] > 0,
               lambda c: c[2] > 0),
}
_AGG_EXPRS = [b("*", col(2), lit(2)), b("+", col(0), col(1)),
              b("*", col(3), lit(2.0)), b("/", col(0), lit(4.0)),
              ("neg", col(2)), col(4), b("-", col(1), lit(0.5))]


@pytest.mark.parametrize("pname", sorted(_AGG))
def test_aggregate_exprs_matches_jax(configs, star, pname):
    fact, cols, vis, _dims, _arrays = star
    p, jp, npred = _AGG[pname]
    q, jq = Query(fact, SCHEMA), JQuery(fact, JS)
    if p is not None:
        q, jq = q.where(p), jq.where(jp)
    q.aggregate_exprs(_AGG_EXPRS)
    plan = q.explain(device="cpu")
    assert plan.kernel == "torch" and "expression" in plan.reason
    assert "no CUDA kernel computes them" in q._cuda_refusal()
    got, want = q.run(device="cpu"), jq.aggregate_exprs(_AGG_EXPRS).run()
    sel = vis & npred(cols)
    assert int(got["count"]) == int(sel.sum())
    assert sorted(got) == sorted(want) == ["count", "esums"]
    _same(got["count"], want["count"])
    for i, (g, w) in enumerate(zip(got["esums"], want["esums"])):
        dt, _cs = tsql._expr_info(_AGG_EXPRS[i], SCHEMA)
        assert _np(g).dtype == _np(w).dtype == dt
        vals = np.asarray(jsql._eval_expr(_AGG_EXPRS[i], [
            jnp.asarray(c) for c in cols]))
        mag = np.abs(np.broadcast_to(vals, sel.shape)[sel]
                     .astype(np.float64)).sum()
        _same(g, w, mag, f"esums[{i}]")


def test_aggregate_exprs_refusals(configs, tmp_path, star):
    """A nullable operand, an empty list and a second terminal are
    refused; kernel='cuda' is EINVAL; the pushdown never takes it."""
    fact, *_ = star
    kw = dict(n_cols=2, nullable=(False, True))
    path = str(tmp_path / "n.heap")
    n = JSchema(**kw).tuples_per_page
    build_heap_file(path, [np.arange(n, dtype=np.int32)] * 2,
                    JSchema(**kw), nulls={1: np.arange(n) % 2 == 0})
    tree = b("+", col(0), col(1))
    with pytest.raises(StromError, match="nullable c1") as e:
        Query(path, HeapSchema(**kw)).aggregate_exprs([tree])
    assert e.value.errno == errno.EINVAL
    with pytest.raises(Exception, match="nullable c1"):
        JQuery(path, JSchema(**kw)).aggregate_exprs([tree])
    got = Query(path, HeapSchema(**kw)).aggregate_exprs(
        [b("*", col(0), lit(3))]).run(device="cpu")
    want = JQuery(path, JSchema(**kw)).aggregate_exprs(
        [b("*", col(0), lit(3))]).run()
    _same_result(got, want)
    with pytest.raises(StromError):
        Query(fact, SCHEMA).aggregate_exprs([])
    q = Query(fact, SCHEMA).aggregate_exprs([col(0)])
    assert q._pushdown_probe() is None
    with pytest.raises(StromError):
        q.aggregate([0])
    with pytest.raises(StromError) as e:
        q.run(device="cpu", kernel="cuda")
    assert e.value.errno == errno.EINVAL


def test_expressions_over_8_byte_columns_sum_in_64_bits(configs, tmp_path):
    """The recorded divergence: an int64 or float64 operand makes a node
    64-bit (int64 for integers, float64 with a float or ``/``), held
    against numpy.  The JAX package types ``c * 3`` over a float64 column
    as int32 and sums it so under x64."""
    kw = dict(n_cols=4, visibility=False,
              dtypes=("int32", "int64", "float64", "float32"))
    rng = np.random.default_rng(23)
    n = JSchema(**kw).tuples_per_page * 5 + 11
    c0 = rng.integers(-1000, 1000, n).astype(np.int32)
    c1 = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    c2 = rng.normal(size=n) * 1e3
    c3 = rng.normal(size=n).astype(np.float32)
    path = str(tmp_path / "w.heap")
    build_heap_file(path, [c0, c1, c2, c3], JSchema(**kw))
    exprs = {
        "f64 * 3": (b("*", col(2), lit(3)), c2 * 3.0),
        "i64 * 2": (b("*", col(1), lit(2)), c1 * 2),
        "i32 + i64": (b("+", col(0), col(1)), c0.astype(np.int64) + c1),
        "f64 / 2": (b("/", col(2), lit(2)), c2 / 2.0),
        "i64 / 4.0": (b("/", col(1), lit(4.0)), c1 / 4.0),
        "f32 * f64": (b("*", col(3), col(2)), c3.astype(np.float64) * c2),
        "i64 + 0.5": (b("+", col(1), lit(0.5)), c1 + 0.5),
        "-f64": (("neg", col(2)), -c2),
        "i64 - i32 * 3": (b("-", col(1), b("*", col(0), lit(3))),
                          c1 - (c0 * np.int32(3)).astype(np.int64)),
    }
    schema = HeapSchema(**kw)
    got = Query(path, schema).aggregate_exprs(
        [t for t, _v in exprs.values()]).run(device="cpu")
    assert int(got["count"]) == n
    for (name, (tree, vals)), s in zip(exprs.items(), got["esums"]):
        dt, _cs = tsql._expr_info(tree, schema)
        assert dt == vals.dtype and _np(s).dtype == vals.dtype, name
        if dt.kind == "f":
            assert abs(float(s) - vals.sum()) <= 1e-12 * np.abs(vals).sum(),\
                name
        else:
            assert int(s) == int(vals.sum()), name
    # the reference's typing of the same trees: 4-byte rules only
    assert jsql._expr_info(exprs["f64 * 3"][0], JSchema(**kw))[0] \
        == np.dtype(np.int32)
    jax.config.update("jax_enable_x64", True)
    try:
        want = JQuery(path, JSchema(**kw)).aggregate_exprs(
            [exprs["f64 * 3"][0], exprs["i64 * 2"][0]]).run()
    finally:
        jax.config.update("jax_enable_x64", False)
    assert int(want["esums"][1]) == int(got["esums"][1])
    assert int(want["esums"][0]) != round(float(got["esums"][0]))


# -- star_join ----------------------------------------------------------------

def _specs(dims, hows=("inner", "semi", "left")):
    (p1, s1, _j1), (p2, s2, _j2), (p3, s3, _j3) = \
        dims["d1"], dims["d2"], dims["d3"]
    out = [dict(probe_col=0, table=p1, schema=s1, key_col=0, value_col=1,
                how=hows[0]),
           dict(probe_col=1, table=p2, schema=s2, key_col=0,
                value_col=None if hows[1] in ("semi", "anti") else 1,
                how=hows[1]),
           dict(probe_col=0, table=p3, schema=s3, key_col=0,
                value_col=None if hows[2] in ("semi", "anti") else 1,
                how=hows[2])]
    return out


def _jspecs(specs, dims):
    js = {id(dims[k][1]): dims[k][2] for k in dims}
    return [dict(s, schema=js[id(s["schema"])]) for s in specs]


_STAR_CASES = {
    "inner semi left": (("inner", "semi", "left"), None),
    "left anti inner": (("left", "anti", "inner"), None),
    "inner inner semi, where": (("inner", "inner", "semi"),
                                (FilterPred(((2, "gt", -10),)),
                                 lambda c: c[2] > -10)),
}


@pytest.mark.parametrize("case", sorted(_STAR_CASES))
def test_star_join_matches_jax(configs, star, case):
    """The aggregate face with mixed faces and expressions, and the row
    face, against the JAX package's and numpy's counts."""
    fact, cols, vis, dims, arrays = star
    hows, pred = _STAR_CASES[case]
    specs = _specs(dims, hows)
    exprs = [b("*", col(2), lit(3)), b("+", col(3), lit(0.5))]
    q, jq = Query(fact, SCHEMA), JQuery(fact, JS)
    if pred is not None:
        q, jq = q.where(pred[0]), jq.where(pred[1])
    q.star_join(specs, exprs=exprs)
    plan = q.explain(device="cpu")
    assert plan.kernel == "torch" and "3 broadcast dimensions" in \
        plan.reason
    assert "no CUDA kernel" in q._cuda_refusal()
    got = q.run(device="cpu")
    want = jq.star_join(_jspecs(specs, dims), exprs=exprs).run()
    _same_result(got, want)
    sel = vis if pred is None else vis & (cols[2] > -10)
    emit = sel.copy()
    for s, key in zip(specs, ("d1", "d2", "d3")):
        hit = np.isin(cols[s["probe_col"]], arrays[key][0])
        emit &= {"inner": hit, "semi": hit, "anti": ~hit,
                 "left": True}[s["how"]]
    assert int(got["count"]) == int(emit.sum())
    q2, jq2 = Query(fact, SCHEMA), JQuery(fact, JS)
    if pred is not None:
        q2, jq2 = q2.where(pred[0]), jq2.where(pred[1])
    rows = q2.star_join(specs, materialize=True,
                        fact_cols=[2, 4, 3]).run(device="cpu")
    jrows = jq2.star_join(_jspecs(specs, dims), materialize=True,
                          fact_cols=[2, 4, 3]).run()
    _same_result(rows, jrows)
    np.testing.assert_array_equal(rows["positions"], np.flatnonzero(emit))


@pytest.mark.parametrize("limit,offset", [(6, 4), (0, 0), (None, 11)])
def test_star_rows_limit_offset(configs, star, limit, offset):
    fact, _cols, _vis, dims, _arrays = star
    specs = _specs(dims)
    got = Query(fact, SCHEMA).star_join(
        specs, materialize=True, fact_cols=[0], limit=limit,
        offset=offset).run(device="cpu")
    want = JQuery(fact, JS).star_join(
        _jspecs(specs, dims), materialize=True, fact_cols=[0],
        limit=limit, offset=offset).run()
    _same_result(got, want)


def test_star_join_refusals(configs, star):
    """semi/anti with a value column, a bad probe column, limit without
    materialize, a bad how and an oversized dimension (EINVAL naming
    join_broadcast_max) are refused on both packages."""
    fact, _cols, _vis, dims, _arrays = star
    bad = {
        "semi with a value": [dict(_specs(dims)[1], value_col=1)],
        "float probe": [dict(_specs(dims)[0], probe_col=3)],
        "probe out of range": [dict(_specs(dims)[0], probe_col=7)],
        "bad how": [dict(_specs(dims)[0], how="full")],
        "no dimension": [],
    }
    for name, specs in bad.items():
        with pytest.raises(StromError) as e:
            Query(fact, SCHEMA).star_join(specs)
        assert e.value.errno == errno.EINVAL, name
        with pytest.raises(Exception):
            JQuery(fact, JS).star_join(_jspecs(specs, dims))
    with pytest.raises(StromError, match="materialize"):
        Query(fact, SCHEMA).star_join(_specs(dims), limit=3)
    with pytest.raises(StromError, match="nullable|c9"):
        Query(fact, SCHEMA).star_join(_specs(dims), exprs=[col(9)])
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    config.set("join_broadcast_max", 1024)
    jconfig.set("join_broadcast_max", 1024)
    try:
        with pytest.raises(StromError) as e:
            Query(fact, SCHEMA).star_join(_specs(dims))
        assert e.value.errno == errno.EINVAL
        assert "join_broadcast_max" in str(e.value)
        with pytest.raises(Exception, match="join_broadcast_max"):
            JQuery(fact, JS).star_join(_jspecs(_specs(dims), dims))
    finally:
        config.restore(snap)
        jconfig.restore(jsnap)


def test_star_join_direct_api(configs, star):
    """The reference's direct-API case: an inner and a semi dimension."""
    fact, cols, vis, dims, arrays = star
    specs = _specs(dims)[:2]
    out = Query(fact, SCHEMA).star_join(specs).run(device="cpu")
    (d1k, d1v), (d2k, _d2v) = arrays["d1"], arrays["d2"]
    m = vis & np.isin(cols[0], d1k) & np.isin(cols[1], d2k)
    assert int(out["count"]) == int(m.sum())
    assert int(out["pay_sums"][0]) == int(d1v[cols[0][m]].sum())
    assert [int(x) for x in out["null_counts"]] == [0, 0]
    _same_result(out, JQuery(fact, JS).star_join(
        _jspecs(specs, dims)).run())


def test_star_join_nullable_fact_nncounts(configs, tmp_path, star):
    """AVG denominators: a nullable fact column's nncount is its emitted
    non-NULL count, as the JAX package's."""
    _fact, _cols, _vis, dims, arrays = star
    kw = dict(n_cols=3, nullable=(False, False, True))
    rng = np.random.default_rng(7)
    n = JSchema(**kw).tuples_per_page * 4 + 3
    c0 = rng.integers(0, 120, n).astype(np.int32)
    c1 = rng.integers(0, 80, n).astype(np.int32)
    c2 = rng.integers(1, 100, n).astype(np.int32)
    nn = rng.random(n) < 0.4
    path = str(tmp_path / "nf.heap")
    build_heap_file(path, [c0, c1, c2], JSchema(**kw), nulls={2: nn})
    specs = _specs(dims)[:2]
    got = Query(path, HeapSchema(**kw)).star_join(specs).run(device="cpu")
    want = JQuery(path, JSchema(**kw)).star_join(
        _jspecs(specs, dims)).run()
    _same_result(got, want)
    m = np.isin(c0, arrays["d1"][0]) & np.isin(c1, arrays["d2"][0])
    assert int(got["nncounts"][2]) == int((m & ~nn).sum())
    assert int(got["sums"][2]) == int(c2[m & ~nn].sum())
