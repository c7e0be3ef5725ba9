"""Nullable and wide (8-byte) schemas in the port's ``Query`` against the
JAX package's on the same heap files: the NULL guard on predicate terms,
NULL-aware ``aggregate`` (``nncounts``) and ``group_by`` (non-NULL
denominators, all-NULL groups as NaN), NULL masks from ``select`` and
``fetch``, int64/float64 columns summed in 64 bits and compared at full
width, and the refusals of this subset.  The JAX side runs wide schemas
under ``jax_enable_x64`` (the ``x64`` fixture); the port serves them with
no switch, a deliberate divergence held by
:func:`test_wide_served_without_x64`.

Tolerances: counts, non-NULL counts, integer sums (int64 exact; int32
wraps mod 2^32), mins, maxs, masks and positions bit-identical; float32
sums within ``1e-5 * sum(|x|) + 1e-6``; float64 sums and sums of squares
within ``1e-12`` relative."""

import errno

import jax
import numpy as np
import pytest

from nvme_strom_tpu.api import StromError as JStromError
from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.groupby import GroupKey
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.query import Query


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture()
def configs():
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    config.set("chunk_size", 1 << 16)
    jconfig.set("chunk_size", 1 << 16)
    config.set("debug_no_threshold", True)
    jconfig.set("debug_no_threshold", True)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


NKW = dict(n_cols=3, dtypes=("int32", "int32", "float32"),
           nullable=(False, True, True))


@pytest.fixture(scope="module")
def ntable(tmp_path_factory):
    """c0 0..99, c1 int32 with 25% NULLs (every row of c0 == 99 NULL),
    c2 float32 with 10% NULLs."""
    rng = np.random.default_rng(4)
    n = 20_000
    c0 = rng.integers(0, 100, n).astype(np.int32)
    c1 = rng.integers(-50, 50, n).astype(np.int32)
    c2 = rng.normal(size=n).astype(np.float32)
    n1 = rng.random(n) < 0.25
    n1[c0 == 99] = True
    n2 = rng.random(n) < 0.1
    path = str(tmp_path_factory.mktemp("nulls") / "t.heap")
    build_heap_file(path, [c0, c1, c2], HeapSchema(**NKW),
                    nulls={1: n1, 2: n2})
    return path, (c0, c1, c2), (n1, n2)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iu" and b.dtype.kind in "iu":
        a, b = a.astype(np.int64), b.astype(np.int64)
    np.testing.assert_array_equal(a, b)


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert (np.abs(got[ok] - want[ok])
            <= rel * np.abs(want[ok]) + 1e-6).all()


# -- the NULL guard and NULL-aware aggregates ---------------------------------

_GUARD_CASES = {
    # port terms, JAX predicate (NULLs excluded explicitly), numpy mask
    "c1 == 0": (((1, "eq", 0),), lambda c: (c[1] == 0) & ~c.nulls[1],
                lambda c, n: (c[1] == 0) & ~n[0]),
    "c1 < 5": (((1, "lt", 5),), lambda c: (c[1] < 5) & ~c.nulls[1],
               lambda c, n: (c[1] < 5) & ~n[0]),
    "c1 != 0": (((1, "ne", 0),), lambda c: (c[1] != 0) & ~c.nulls[1],
                lambda c, n: (c[1] != 0) & ~n[0]),
    "c2 <= 0.0 and c0 >= 50": (
        ((2, "le", 0.0), (0, "ge", 50)),
        lambda c: (c[2] <= 0.0) & ~c.nulls[2] & (c[0] >= 50),
        lambda c, n: (c[2] <= 0) & ~n[1] & (c[0] >= 50)),
    "both nullable": (((1, "ge", -3), (2, "gt", -0.5)),
                      lambda c: (c[1] >= -3) & (c[2] > -0.5)
                      & ~c.nulls[1] & ~c.nulls[2],
                      lambda c, n: (c[1] >= -3) & (c[2] > np.float32(-0.5))
                      & ~n[0] & ~n[1]),
}


@pytest.mark.parametrize("case", sorted(_GUARD_CASES))
def test_null_guard_and_nncounts_match_jax(configs, ntable, case):
    """A term on a nullable column never selects a NULL row (its stored
    word is 0); sums skip NULLs and nncounts count the rest."""
    path, cols, nulls = ntable
    terms, jpred, npred = _GUARD_CASES[case]
    got = Query(path, HeapSchema(**NKW)).where(FilterPred(terms)) \
        .aggregate().run(device="cpu")
    want = JQuery(path, JSchema(**NKW)).where(jpred).aggregate().run()
    sel = npred(cols, nulls)
    assert int(got["count"]) == int(want["count"]) == int(sel.sum())
    _eq(got["nncounts"], want["nncounts"])
    _eq(got["nncounts"][1], (sel & ~nulls[0]).sum())
    _eq(got["sums"][:2], want["sums"][:2])
    x = cols[2][sel & ~nulls[1]].astype(np.float64)
    assert abs(float(got["sums"][2]) - x.sum()) \
        <= 1e-5 * np.abs(x).sum() + 1e-6


def test_aggregate_projection_keeps_nncounts(configs, ntable):
    path, *_ = ntable
    got = Query(path, HeapSchema(**NKW)).aggregate([2, 1]) \
        .run(device="cpu")
    want = JQuery(path, JSchema(**NKW)).aggregate([2, 1]).run()
    _eq(got["count"], want["count"])
    _eq(got["nncounts"], want["nncounts"])
    _eq(got["sums"][1], want["sums"][1])


_NGROUP_CASES = {
    # port key, JAX key, G, agg cols, port where, JAX where, having
    "int agg, all-NULL group": (GroupKey(0), lambda c: c[0], 100, [1],
                                None, None, None),
    "int agg where": (GroupKey(0, 7), lambda c: c[0] % 7, 7, [1],
                      FilterPred(((0, "lt", 60),)), lambda c: c[0] < 60,
                      None),
    "float agg having": (GroupKey(0, 5), lambda c: c[0] % 5, 5, [2], None,
                         None, lambda g: g["nncounts"][0] > 1700),
    "nullable term": (GroupKey(0, 4), lambda c: c[0] % 4, 4, [2],
                      FilterPred(((1, "gt", 0),)),
                      lambda c: (c[1] > 0) & ~c.nulls[1], None),
}


@pytest.mark.parametrize("case", sorted(_NGROUP_CASES))
def test_null_aware_group_by_matches_jax(configs, ntable, case):
    """NULL rows leave sums, sumsqs, mins and maxs of their column and its
    nncounts; avgs divide by nncounts; an all-NULL group reports NaN."""
    path, *_ = ntable
    key, jkey, G, agg, pred, jpred, having = _NGROUP_CASES[case]
    q, jq = Query(path, HeapSchema(**NKW)), JQuery(path, JSchema(**NKW))
    if pred is not None:
        q, jq = q.where(pred), jq.where(jpred)
    got = q.group_by(key, G, agg_cols=agg, having=having).run(device="cpu")
    want = jq.group_by(jkey, G, agg_cols=agg, having=having).run()
    assert sorted(got) == sorted(want)
    for k in ("count", "nncounts", "groups") if having else \
            ("count", "nncounts"):
        _eq(got[k], want[k])
    if agg == [1]:
        for k in ("sums", "mins", "maxs"):
            np.testing.assert_array_equal(got[k], want[k])
        if G == 100:
            assert np.isnan(got["sums"][0, 99]) and got["count"][99] > 0
    else:
        for k in ("mins", "maxs"):
            np.testing.assert_array_equal(got[k], want[k])
        # 1e-5 * sum(|x|) + 1e-6 per group, sum(|x|) from numpy
        _path, (c0, _c1, c2), (_n1, n2) = ntable
        m = ~n2 if pred is None else ~n2 & (_c1 > 0) & ~_n1
        mag = np.bincount(c0[m] % G, np.abs(c2[m].astype(np.float64)),
                          minlength=G)[got["groups"] if having else
                                       slice(None)]
        assert (np.abs(got["sums"][0] - want["sums"][0])
                <= 1e-5 * mag + 1e-6).all()
        assert (np.abs(got["avgs"][0] - want["avgs"][0])
                <= (1e-5 * mag + 1e-6) / got["nncounts"][0]).all()
        return
    _close(got["avgs"], want["avgs"], 1e-12)
    _close(got["vars"], want["vars"], 1e-12)


def test_value_keyed_group_by_over_a_nullable_aggregate(configs, ntable):
    path, *_ = ntable
    got = Query(path, HeapSchema(**NKW)).group_by_cols(
        0, agg_cols=[1]).run(device="cpu")
    want = JQuery(path, JSchema(**NKW)).group_by_cols(0, agg_cols=[1]).run()
    for k in ("groups", "count", "nncounts", "sums", "mins", "maxs"):
        np.testing.assert_array_equal(got[k], want[k])
    _eq(got["key_cols"][0], want["key_cols"][0])
    # past max_groups the sorted spill refuses nullable aggregates
    with pytest.raises(StromError) as e:
        Query(path, HeapSchema(**NKW)).group_by_cols(
            0, agg_cols=[1], max_groups=10).run(device="cpu")
    assert e.value.errno == errno.EINVAL
    with pytest.raises(JStromError):
        JQuery(path, JSchema(**NKW)).group_by_cols(
            0, agg_cols=[1], max_groups=10).run()


@pytest.mark.parametrize("limit", [None, 30])
def test_select_null_masks_match_jax(configs, ntable, limit):
    path, cols, nulls = ntable
    got = Query(path, HeapSchema(**NKW)).where(FilterPred(((0, "eq", 7),))) \
        .select(limit=limit).run(device="cpu")
    want = JQuery(path, JSchema(**NKW)).where(lambda c: c[0] == 7) \
        .select(limit=limit).run()
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k])
    p = got["positions"]
    _eq(got["null1"], nulls[0][p])
    _eq(got["col1"], np.where(nulls[0][p], 0, cols[1][p]))


def test_fetch_null_masks_match_jax(configs, ntable):
    path, cols, nulls = ntable
    pos = np.array([19_999, 0, 7, 7, 12_345, 3])
    got = Query(path, HeapSchema(**NKW)).fetch(pos, device="cpu")
    want = JQuery(path, JSchema(**NKW)).fetch(pos)
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k])
    _eq(got["null2"], nulls[1][pos])


# -- wide (8-byte) columns ---------------------------------------------------

WKW = dict(n_cols=4, visibility=True,
           dtypes=("int32", "int64", "float64", "int32"))


@pytest.fixture(scope="module")
def wtable(tmp_path_factory):
    rng = np.random.default_rng(9)
    n = 12_000
    c0 = rng.integers(0, 50, n).astype(np.int32)
    w = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    w[:3] = [np.iinfo(np.int64).max // 4, -(1 << 50), 2]
    f = (rng.normal(size=n) * 1e3).astype(np.float64)
    c3 = rng.integers(-5, 5, n).astype(np.int32)
    vis = (rng.random(n) > 0.1).astype(np.int32)
    path = str(tmp_path_factory.mktemp("wide") / "w.heap")
    build_heap_file(path, [c0, w, f, c3], HeapSchema(**WKW), visibility=vis)
    return path, (c0, w, f, c3), vis != 0


_WIDE_PRED = {
    "all": (None, None, lambda c: True),
    "c0 < 40": (((0, "lt", 40),), lambda c: c[0] < 40, lambda c: c[0] < 40),
    "int64 past 2^31": (((1, "gt", 1 << 39),), lambda c: c[1] > (1 << 39),
                        lambda c: c[1] > (1 << 39)),
    "int64 ge a float": (((1, "ge", 2.5), (1, "lt", 1 << 41)),
                         lambda c: (c[1] >= 2.5) & (c[1] < (1 << 41)),
                         lambda c: (c[1] >= 3) & (c[1] < (1 << 41))),
    "int64 eq a fraction": (((1, "eq", 2.5),), lambda c: c[1] == 2.5,
                            lambda c: c[1] != c[1]),
    "float64 le": (((2, "le", 250.125),), lambda c: c[2] <= 250.125,
                   lambda c: c[2] <= 250.125),
}


def _wide_queries(path, pname):
    terms, jp, _n = _WIDE_PRED[pname]
    q, jq = Query(path, HeapSchema(**WKW)), JQuery(path, JSchema(**WKW))
    if terms is not None:
        q, jq = q.where(FilterPred(terms)), jq.where(jp)
    return q, jq


@pytest.mark.parametrize("pname", sorted(_WIDE_PRED))
def test_wide_aggregate_matches_jax(configs, x64, wtable, pname):
    """int64 sums beyond 2^31 exact, float64 sums within 1e-12, and
    8-byte compares at full width (a float against an int64 column in
    float64, as jnp promotes under x64)."""
    path, cols, vis = wtable
    q, jq = _wide_queries(path, pname)
    got = q.aggregate([1, 2]).run(device="cpu")
    want = jq.aggregate([1, 2]).run()
    sel = vis & _WIDE_PRED[pname][2](cols)
    assert int(got["count"]) == int(want["count"]) == int(sel.sum())
    assert np.asarray(got["sums"][0]).dtype == np.int64
    assert int(got["sums"][0]) == int(want["sums"][0]) \
        == int(cols[1][sel].sum())
    if sel.any() and pname == "all":
        assert abs(int(got["sums"][0])) > (1 << 31)
    _close(got["sums"][1], want["sums"][1], 1e-12)
    _close(got["sums"][1], cols[2][sel].sum(), 1e-12)


_WIDE_GROUP = {
    "int64 by key": (GroupKey(0, 6), lambda c: c[0] % 6, 6, [1], "all"),
    "float64 by key where": (GroupKey(3), lambda c: c[3], 5, [2],
                             "int64 past 2^31"),
    "int64 value-keyed": ("cols", None, 0, [1], "c0 < 40"),
    "float64 spill": ("spill", None, 0, [2], "all"),
}


@pytest.mark.parametrize("case", sorted(_WIDE_GROUP))
def test_wide_group_by_matches_jax(configs, x64, wtable, case):
    path, cols, vis = wtable
    key, jkey, G, agg, pname = _WIDE_GROUP[case]
    q, jq = _wide_queries(path, pname)
    if key == "cols":
        got = q.group_by_cols(0, agg_cols=agg).run(device="cpu")
        want = jq.group_by_cols(0, agg_cols=agg).run()
    elif key == "spill":
        got = q.group_by_cols(0, agg_cols=agg, max_groups=8) \
            .run(device="cpu")
        want = jq.group_by_cols(0, agg_cols=agg, max_groups=8).run()
    else:
        got = q.group_by(key, G, agg_cols=agg).run(device="cpu")
        want = jq.group_by(jkey, G, agg_cols=agg).run()
    assert sorted(got) == sorted(want)
    _eq(got["count"], want["count"])
    for k in ("mins", "maxs"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    if agg == [1]:
        assert got["sums"].dtype == np.int64
        np.testing.assert_array_equal(got["sums"], want["sums"])
    else:
        _close(got["sums"], want["sums"], 1e-12)
    _close(got["sumsqs"], want["sumsqs"], 1e-12)
    if "key_cols" in want:
        _eq(got["key_cols"][0], want["key_cols"][0])


def test_wide_select_and_fetch_match_jax(configs, x64, wtable):
    path, cols, vis = wtable
    q, jq = _wide_queries(path, "int64 past 2^31")
    got = q.select([1, 2], limit=500).run(device="cpu")
    want = jq.select([1, 2], limit=500).run()
    for k in want:
        _eq(got[k], want[k])
    assert got["col1"].dtype == np.int64 and got["col2"].dtype == np.float64
    pos = np.array([11_999, 0, 1, 2, 5000, 5000])
    got = Query(path, HeapSchema(**WKW)).fetch(pos, [1, 2], device="cpu")
    want = JQuery(path, JSchema(**WKW)).fetch(pos, [1, 2])
    for k in want:
        _eq(got[k], want[k])
    _eq(got["col1"], cols[1][pos])


def test_wide_served_without_x64(configs, wtable):
    """Deliberate divergence: the JAX package refuses 64-bit GROUP BY
    aggregates without jax_enable_x64; the port has no such switch and
    serves them, equal to numpy."""
    path, cols, vis = wtable
    with pytest.raises(JStromError) as e:
        JQuery(path, JSchema(**WKW)).group_by(
            lambda c: c[0] % 3, 3, agg_cols=[1]).run()
    assert "x64" in str(e.value)
    got = Query(path, HeapSchema(**WKW)).group_by(
        GroupKey(0, 3), 3, agg_cols=[1]).run(device="cpu")
    for g in range(3):
        m = vis & (cols[0] % 3 == g)
        assert int(got["sums"][0, g]) == int(cols[1][m].sum())
        assert int(got["mins"][0, g]) == int(cols[1][m].min())


# -- what this subset refuses -----------------------------------------------

_REFUSALS = {
    "order_by nullable": lambda q, w: q.order_by(1),
    "quantiles nullable": lambda q, w: q.quantiles(2, [0.5]),
    "count_distinct nullable": lambda q, w: q.count_distinct(1),
    "top_k nullable": lambda q, w: q.top_k(1, 3),
    "group_by_cols nullable key": lambda q, w: q.group_by_cols(1),
    "top_k 8-byte": lambda q, w: w.top_k(1, 1),
    "order_by 8-byte": lambda q, w: w.order_by(2),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_subset_refusals(configs, x64, ntable, wtable, case):
    """Order terminals and group keys over nullable columns, and top_k or
    order terminals over 8-byte ones, are EINVAL on both packages (when
    the terminal is set or at run)."""
    build = _REFUSALS[case]
    with pytest.raises(StromError) as e:
        build(Query(ntable[0], HeapSchema(**NKW)),
              Query(wtable[0], HeapSchema(**WKW))).run(device="cpu")
    assert e.value.errno == errno.EINVAL
    with pytest.raises(JStromError):
        build(JQuery(ntable[0], JSchema(**NKW)),
              JQuery(wtable[0], JSchema(**WKW))).run()


_WIDE17 = dict(n_cols=17, visibility=True)


@pytest.mark.parametrize("which,kw,word", [
    ("nullable", NKW, "nullable"), ("wide", WKW, "int64"),
    ("17 columns", _WIDE17, "17 columns")])
def test_nullable_and_wide_plan_torch(configs, ntable, wtable, which, kw,
                                      word):
    """B1/B3 take the 4-byte non-null layout of at most 16 columns only:
    these schemas plan the torch route, the refusal names the reason, and
    kernel='cuda' is invalid."""
    path = wtable[0] if which == "wide" else ntable[0]
    q = Query(path, HeapSchema(**kw)).aggregate()
    assert q.explain(device="cpu").kernel == "torch"
    assert word in q._cuda_refusal()
    g = Query(path, HeapSchema(**kw)).group_by(GroupKey(0, 4), 4,
                                               agg_cols=[0])
    assert word in g._cuda_refusal()
    assert q.explain(device="cpu", kernel="cuda").kernel == "invalid"
