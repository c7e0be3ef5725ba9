"""The port's joins (``ops/join.py``; ``scan/query.py`` ``join`` and
``join_table``, broadcast and the local Grace join) against the JAX
package's on the same heap bytes.  The port runs with ``device="cpu"``
(its ``torch`` route), the JAX package on its CPU backend, both through
their table scanners at 64 KiB chunks.

Tolerances: counts, integer sums (int32 and uint32 wrap mod 2^32), keys,
payloads, masks, positions and row orders bit-identical (positions
compared as int64: the port's dtype, the JAX package's under x64); float32
sums within ``1e-5 * sum(|x|) + 1e-6``.  The Grace join's rows equal the
broadcast join's as a set (its order is partition order, unspecified as
SQL without ORDER BY)."""

import errno
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.ops import join as jjoin
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops import join as tjoin
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.scan.executor import TableScanner
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.query import Query

HOWS = ("inner", "left", "semi", "anti")
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
KW = dict(n_cols=4, visibility=True,
          dtypes=("int32", "int32", "float32", "uint32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)
# the build side covers half the probe key space, so every face is
# populated
KEYS = np.arange(0, 512, dtype=np.int32)
VALS = {"int32": (KEYS * 10).astype(np.int32),
        "uint32": (KEYS.astype(np.uint32) * np.uint32(9_000_001)),
        "float32": (KEYS.astype(np.float32) * 0.25 + 0.125)}


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


def _columns(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(-1000, 1000, n).astype(np.int32),
            rng.integers(0, 1024, n).astype(np.int32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """c0 int32 in [-1000, 1000), c1 the int32 probe key in [0, 1024),
    c2 float32, c3 full-range uint32; 20% invisible rows; 12 pages plus a
    partial page."""
    n = SCHEMA.tuples_per_page * 12 + 77
    cols = _columns(31, n)
    vis = (np.random.default_rng(32).random(n) > 0.2).astype(np.int32)
    path = str(tmp_path_factory.mktemp("join") / "fact.heap")
    build_heap_file(path, cols, SCHEMA, visibility=vis)
    return path, cols, vis


def _np(x):
    """A result leaf as numpy (a torch.uint32 through its int32 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _i64(a):
    a = _np(a)
    return a.astype(np.int64) if a.dtype.kind in "iu" else a


def _same(got, want, mag=None, what=""):
    """One result leaf: dtype kind equal; ints exact; floats within
    1e-5 * mag + 1e-6 (mag = sum(|x|) of the summed values)."""
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype or {g.dtype.itemsize, w.dtype.itemsize} \
        == {4, 8} and g.dtype.kind == w.dtype.kind, (what, g.dtype, w.dtype)
    if g.dtype.kind == "f":
        tol = 1e-5 * (mag if mag is not None else np.abs(w).sum()) + 1e-6
        assert np.all(np.abs(g.astype(np.float64) - w) <= tol), (what, g, w)
    else:
        np.testing.assert_array_equal(_i64(g), _i64(w), err_msg=what)


def _same_agg(got, want, cols=None, emit=None):
    assert sorted(got) == sorted(want)
    _same(got["matched"], want["matched"], what="matched")
    for c, (g, w) in enumerate(zip(got["sums"], want["sums"])):
        mag = None if cols is None else np.abs(
            cols[c][emit].astype(np.float64)).sum()
        _same(g, w, mag, f"sums[{c}]")
    for k in ("payload_sum", "null_count"):
        if k in want:
            _same(got[k], want[k], what=k)


def _oracle(cols, vis, how, pred=None):
    """(emit, partner) masks of the numpy oracle over every row."""
    sel = vis != 0
    if pred is not None:
        sel = sel & pred(cols)
    partner = sel & (cols[1] < 512)
    emit = {"inner": partner, "semi": partner, "anti": sel & ~partner,
            "left": sel}[how]
    return emit, partner


# -- the ops level ---------------------------------------------------------

def test_key_hash32_matches_jax():
    """Numpy, torch and jnp give the same hash, and the same partition
    ids, for negative keys, INT_MIN, INT_MAX and 0."""
    keys = np.concatenate([np.array([INT_MIN, INT_MAX, 0, -1, 1,
                                     INT_MIN + 1], np.int32),
                           np.random.default_rng(5).integers(
                               INT_MIN, INT_MAX, 4000, dtype=np.int64)
                           .astype(np.int32)])
    want = jjoin.key_hash32(keys)
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(tjoin.key_hash32(keys), want)
    got = tjoin.key_hash32(torch.from_numpy(keys))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(jjoin.key_hash32(jnp.asarray(keys))), want)
    for n_parts in (2, 3, 7, 16):
        np.testing.assert_array_equal(
            (got % n_parts).numpy(), (want % np.uint32(n_parts))
            .astype(np.int64))
    assert int(tjoin.key_hash32(np.int32(-7))) == int(jjoin.key_hash32(
        np.int32(-7)))


@pytest.mark.parametrize("vdt", sorted(VALS))
@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_hash_split_build_matches_jax(vdt, n_parts):
    rng = np.random.default_rng(n_parts)
    keys = rng.permutation(np.arange(-3000, 3000, dtype=np.int32))[:1500]
    vals = np.resize(VALS[vdt], 1500)
    got = tjoin.hash_split_build(keys, vals, n_parts)
    want = jjoin.hash_split_build(keys, vals, n_parts)
    assert len(got) == len(want) == n_parts
    for (gk, gv), (wk, wv) in zip(got, want):
        assert gk.dtype == wk.dtype and gv.dtype == wv.dtype
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)
    assert sum(len(k) for k, _v in got) == 1500
    # a Python-int payload lands as int32 on both
    _k, v = tjoin.hash_split_build([1, 2], [3, 4], 1)[0]
    assert v.dtype == np.int32 == jjoin.hash_split_build(
        [1, 2], [3, 4], 1)[0][1].dtype


#: (port predicate, JAX predicate, numpy predicate)
PREDS = {"all": (None, None, None),
         "c0>0": (FilterPred(((0, "gt", 0),)), lambda c: c[0] > 0,
                  lambda c: c[0] > 0)}

_OPS_CASES = [(how, p, vdt, "keys", None) for how in HOWS for p in PREDS
              for vdt in sorted(VALS)] \
    + [(how, "c0>0", "float32", "empty", None) for how in HOWS] \
    + [(how, "all", "int32", "keys", (3, 1)) for how in HOWS]


@pytest.mark.parametrize("how,pname,vdt,build,owner", _OPS_CASES)
def test_join_fns_match_jax(table, how, pname, vdt, build, owner):
    """``make_join_fn`` and ``make_join_rows_fn`` against the JAX
    package's on the same pages: the four faces, with and without a
    predicate, int32/uint32/float32 payloads, an empty build side and a
    Grace pass's ownership."""
    path, cols, vis = table
    pages = np.fromfile(path, np.uint8).reshape(-1, 8192)
    p, jp, _np = PREDS[pname]
    keys, vals = (KEYS, VALS[vdt]) if build == "keys" else \
        (np.zeros(0, np.int32), VALS[vdt][:0])
    kw = dict(how=how, owner_part=owner)
    got = tjoin.make_join_fn(SCHEMA, 1, keys, vals, predicate=p, **kw)(
        torch.from_numpy(pages))
    want = jjoin.make_join_fn(JS, 1, keys, vals, predicate=jp, **kw)(pages)
    _same_agg(got, want)
    rows = tjoin.make_join_rows_fn(SCHEMA, 1, keys, vals, predicate=p,
                                   **kw)(torch.from_numpy(pages))
    jrows = jjoin.make_join_rows_fn(JS, 1, keys, vals, predicate=jp,
                                    **kw)(pages)
    assert sorted(rows) == sorted(jrows)
    for k in jrows:
        np.testing.assert_array_equal(_i64(rows[k]), _i64(jrows[k]),
                                      err_msg=k)
    if build == "keys" and owner is None:
        emit, _partner = _oracle(cols, vis, how, _np)
        assert int(got["matched"]) == int(emit.sum())


def test_join_fn_payload_dtypes_follow_acc_dtypes(table):
    """The payload sum keeps its acc dtype (float32 stays float32, uint32
    wraps mod 2^32) on both packages."""
    path, _cols, _vis = table
    pages = np.fromfile(path, np.uint8).reshape(-1, 8192)
    for vdt, tdt in (("float32", torch.float32), ("uint32", torch.uint32),
                     ("int32", torch.int32)):
        got = tjoin.make_join_fn(SCHEMA, 1, KEYS, VALS[vdt])(
            torch.from_numpy(pages))
        want = jjoin.make_join_fn(JS, 1, KEYS, VALS[vdt])(pages)
        assert got["payload_sum"].dtype == tdt
        assert np.asarray(want["payload_sum"]).dtype == np.dtype(vdt)
        assert [s.dtype for s in got["sums"]] == [
            torch.int32, torch.int32, torch.float32, torch.uint32]


def test_sorted_build_refusals():
    """Duplicate keys and a probe column that is not int32 raise the
    same ValueErrors on both packages."""
    dup = np.array([1, 1], np.int32), np.array([2, 3], np.int32)
    for mod, schema in ((tjoin, SCHEMA), (jjoin, JS)):
        with pytest.raises(ValueError, match="unique"):
            mod.make_join_fn(schema, 1, *dup)
        with pytest.raises(ValueError, match="int32"):
            mod.make_join_rows_fn(schema, 2, KEYS, VALS["int32"])
        with pytest.raises(ValueError, match="int32"):
            mod._sorted_build(KEYS, KEYS, schema, 3)
        with pytest.raises(ValueError):
            mod.check_join_how("outer")
    k, v = tjoin._sorted_build(np.array([5, -2, 9], np.int32),
                               np.array([1.5, 2.5, 3.5], np.float32),
                               SCHEMA, 1)
    np.testing.assert_array_equal(k, [-2, 5, 9])
    np.testing.assert_array_equal(v, np.float32([2.5, 1.5, 3.5]))


def test_join_step_folds_through_the_scanner(configs, tmp_path):
    """A broadcast inner join over a scanned table equals the numpy
    oracle, folded across streamed batches with its dtypes kept."""
    rng = np.random.default_rng(81)
    schema = HeapSchema(n_cols=2, visibility=True)
    n = schema.tuples_per_page * 10
    fk = rng.integers(0, 50, n).astype(np.int32)
    amt = rng.integers(1, 100, n).astype(np.int32)
    path = str(tmp_path / "join.heap")
    build_heap_file(path, [fk, amt], schema)
    dim_keys = np.array([3, 7, 11, 42], np.int32)
    dim_vals = np.array([100, 200, 300, 400], np.int32)
    fn = tjoin.make_join_fn(schema, 0, dim_keys, dim_vals)
    with TableScanner(path, schema) as sc:
        out = sc.scan_filter(fn, device="cpu")
    hit = np.isin(fk, dim_keys)
    assert int(out["matched"]) == int(hit.sum())
    assert int(out["sums"][1]) == int(amt[hit].sum())
    assert out["sums"][1].dtype == np.int32
    lut = dict(zip(dim_keys.tolist(), dim_vals.tolist()))
    assert int(out["payload_sum"]) == sum(lut[k] for k in fk[hit].tolist())


def test_fold_keeps_join_and_star_leaf_dtypes(table):
    """Batches of the join and star steps fold per leaf (the per-column
    sums lists, the per-dimension lists), each leaf in its acc dtype:
    int32 and uint32 wrap, float32 stays float32."""
    from nvme_strom_tpu_torch.scan.executor import _to_numpy, fold_results
    path, _cols, _vis = table
    pages = torch.from_numpy(np.fromfile(path, np.uint8).reshape(-1, 8192))
    halves = (pages[:6], pages[6:])
    star = [(1, KEYS, VALS["uint32"], "left"), (1, KEYS, None, "semi")]
    for fn in (tjoin.make_join_fn(SCHEMA, 1, KEYS, VALS["uint32"],
                                  how="left"),
               tjoin.make_star_fn(SCHEMA, star, expr_fns=[
                   lambda c: c[2] * 2.0], expr_dtypes=[np.dtype("float32")])):
        acc = None
        for h in halves:
            acc = fold_results(acc, fn(h))
        got, whole = _to_numpy(acc), _to_numpy(fn(pages))
        assert sorted(got) == sorted(whole)
        for k in whole:
            g = got[k] if isinstance(got[k], list) else [got[k]]
            w = whole[k] if isinstance(whole[k], list) else [whole[k]]
            assert len(g) == len(w)
            for a, b in zip(g, w):
                _same(a, b, None, k)
                assert a.dtype == b.dtype, k


@pytest.mark.parametrize("case", ["missing", "short", "not a heap",
                                  "column count", "visibility", "wide mask",
                                  "nullable mask", "valid"])
def test_validate_heap_header_matches_jax(tmp_path, case):
    """The same error class and message as the JAX package's check."""
    from nvme_strom_tpu.scan.heap import validate_heap_header as jvalidate
    from nvme_strom_tpu_torch.scan.heap import validate_heap_header
    path = str(tmp_path / "h.heap")
    kw = dict(n_cols=2, visibility=False, dtypes=("int32", "float32"))
    build_heap_file(path, [KEYS, VALS["float32"]], HeapSchema(**kw))
    other = dict(kw)
    if case == "missing":
        path += ".gone"
    elif case == "short":
        with open(path, "r+b") as f:
            f.truncate(40)
    elif case == "not a heap":
        with open(path, "r+b") as f:
            f.write(b"\1" * 64)
    elif case == "column count":
        other = dict(n_cols=3, visibility=False)
    elif case == "visibility":
        other = dict(kw, visibility=True)
    elif case == "wide mask":
        other = dict(kw, dtypes=("int32", "float64"))
    elif case == "nullable mask":
        other = dict(kw, nullable=(False, True))
    errs = []
    for check, schema in ((validate_heap_header, HeapSchema(**other)),
                          (jvalidate, JSchema(**other))):
        try:
            check(path, schema)
            errs.append(None)
        except (OSError, ValueError) as e:
            errs.append((type(e), str(e)))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (case == "valid")


# -- Query.join with host arrays ---------------------------------------------

def _queries(path, pname):
    p, jp, _np = PREDS[pname]
    q, jq = Query(path, SCHEMA), JQuery(path, JS)
    if p is not None:
        q, jq = q.where(p), jq.where(jp)
    return q, jq


def _same_rows(got, want, ordered=True):
    assert sorted(got) == sorted(want)
    o_g = np.argsort(got["positions"], kind="stable")
    o_w = np.argsort(want["positions"], kind="stable")
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k != "count" and not ordered:
            g, w = g[o_g], w[o_w]
        if k in ("positions", "count"):
            g, w = _i64(g), _i64(w)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("pname", sorted(PREDS))
@pytest.mark.parametrize("how", HOWS)
def test_join_matches_jax(configs, table, how, pname):
    """Both faces of a broadcast join: the aggregate and the rows (in
    arrival order) equal the JAX package's, and the numpy oracle's."""
    path, cols, vis = table
    q, jq = _queries(path, pname)
    q.join(1, KEYS, VALS["int32"], how=how)
    jq.join(1, KEYS, VALS["int32"], how=how)
    plan = q.explain(device="cpu")
    assert plan.kernel == "torch" and plan.join_strategy == "broadcast"
    assert f"join type {how}" in plan.reason
    emit, partner = _oracle(cols, vis, how, PREDS[pname][2])
    got, want = q.run(device="cpu"), jq.run()
    _same_agg(got, want, cols, emit)
    assert int(got["matched"]) == int(emit.sum())
    q, jq = _queries(path, pname)
    rows = q.join(1, KEYS, VALS["int32"], how=how,
                  materialize=True).run(device="cpu")
    jrows = jq.join(1, KEYS, VALS["int32"], how=how,
                    materialize=True).run()
    _same_rows(rows, jrows)
    np.testing.assert_array_equal(rows["positions"], np.flatnonzero(emit))
    if how == "left":
        np.testing.assert_array_equal(rows["matched"], partner[emit])


@pytest.mark.parametrize("limit,offset", [(5, 3), (0, 0), (None, 7),
                                          (10_000, 2)])
def test_join_rows_limit_offset(configs, table, limit, offset):
    """``limit``/``offset`` slice the row face as select does, equal to
    the JAX package's slice and to the full result's."""
    path, _cols, _vis = table
    full = Query(path, SCHEMA).join(1, KEYS, VALS["float32"], how="left",
                                    materialize=True).run(device="cpu")
    got = Query(path, SCHEMA).join(1, KEYS, VALS["float32"], how="left",
                                   materialize=True, limit=limit,
                                   offset=offset).run(device="cpu")
    want = JQuery(path, JS).join(1, KEYS, VALS["float32"], how="left",
                                 materialize=True, limit=limit,
                                 offset=offset).run()
    _same_rows(got, want)
    end = None if limit is None else offset + limit
    for k in ("positions", "keys", "payload", "matched"):
        np.testing.assert_array_equal(got[k], full[k][offset:end])


def test_join_empty_build_joins_nothing(configs, table):
    path, _cols, _vis = table
    ek = np.zeros(0, np.int32)
    agg = Query(path, SCHEMA).join(1, ek, ek).run(device="cpu")
    jagg = JQuery(path, JS).join(1, ek, ek).run()
    _same_agg(agg, jagg)
    assert int(agg["matched"]) == 0 and int(agg["payload_sum"]) == 0
    rows = Query(path, SCHEMA).join(1, ek, ek, materialize=True) \
        .run(device="cpu")
    assert int(rows["count"]) == 0 and len(rows["payload"]) == 0
    _same_rows(rows, JQuery(path, JS).join(1, ek, ek,
                                           materialize=True).run())


_REFUSALS = {
    "invalid how": lambda q: q.join(1, KEYS, KEYS, how="outer"),
    "limit without materialize": lambda q: q.join(1, KEYS, KEYS, limit=5),
    "offset without materialize": lambda q: q.join(1, KEYS, KEYS, offset=1),
    "negative limit": lambda q: q.join(1, KEYS, KEYS, materialize=True,
                                       limit=-1),
    "negative offset": lambda q: q.join(1, KEYS, KEYS, materialize=True,
                                        offset=-2),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_join_refuses_bad_arguments(configs, table, case):
    """Each is EINVAL on the port where the JAX package raises, and the
    refused call leaves the query reusable."""
    path, _cols, _vis = table
    q = Query(path, SCHEMA)
    with pytest.raises(StromError) as e:
        _REFUSALS[case](q)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(Exception):
        _REFUSALS[case](JQuery(path, JS))
    q.join(1, KEYS, KEYS, how="anti")     # still takes a terminal
    with pytest.raises(StromError):       # and only one
        q.select()


def test_join_refuses_a_nullable_probe_column(configs, tmp_path):
    kw = dict(n_cols=2, nullable=(True, False))
    schema = HeapSchema(**kw)
    path = str(tmp_path / "n.heap")
    n = schema.tuples_per_page * 2
    build_heap_file(path, [np.arange(n, dtype=np.int32)] * 2, schema,
                    nulls={0: np.arange(n) % 3 == 0})
    with pytest.raises(StromError, match="nullable") as e:
        Query(path, schema).join(0, KEYS, KEYS)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(Exception, match="nullable"):
        JQuery(path, JSchema(**kw)).join(0, KEYS, KEYS)
    # a nullable fact column that is not the probe is summed as stored;
    # the port adds each column's non-NULL count over the emitted rows
    # (SQL's SUM over none of them is NULL), which the JAX package lacks
    got = Query(path, schema).join(1, KEYS, KEYS).run(device="cpu")
    want = JQuery(path, JSchema(**kw)).join(1, KEYS, KEYS).run()
    nn = [int(x) for x in got.pop("nncounts")]
    _same_agg(got, want)
    emit = np.isin(np.arange(n), KEYS)
    assert nn == [int((emit & (np.arange(n) % 3 != 0)).sum()),
                  int(emit.sum())]


@pytest.mark.parametrize("case", ["probe out of range", "float probe",
                                  "duplicate keys"])
def test_join_invalid_plans(configs, table, case):
    """What the JAX package finds only inside run() the port names in the
    plan: EXPLAIN shows it, run() is EINVAL."""
    path, _cols, _vis = table
    q = Query(path, SCHEMA)
    if case == "probe out of range":
        q.join(9, KEYS, KEYS)
    elif case == "float probe":
        q.join(2, KEYS, KEYS)
    else:
        q.join(1, np.array([1, 1], np.int32), np.array([1, 2], np.int32))
    plan = q.explain(device="cpu")
    assert plan.kernel == "invalid"
    with pytest.raises(StromError) as e:
        q.run(device="cpu")
    assert e.value.errno == errno.EINVAL


def test_join_plans_torch_and_refuses_cuda(configs, table):
    """A join plans the torch route with a reason; kernel='cuda' is
    EINVAL; the refusal a card's plan names says no kernel computes it."""
    path, _cols, _vis = table
    q = Query(path, SCHEMA).join(1, KEYS, KEYS)
    assert "no CUDA kernel computes it" in q._cuda_refusal()
    assert "searchsorted" in q.explain(device="cpu").reason
    assert q.explain(device="cpu", kernel="cuda").kernel == "invalid"
    with pytest.raises(StromError) as e:
        q.run(device="cpu", kernel="cuda")
    assert e.value.errno == errno.EINVAL


# -- local Grace passes and join_table ---------------------------------------

@pytest.mark.parametrize("how", HOWS)
def test_grace_join_matches_broadcast(configs, table, how):
    """Grace passes emit the same face as broadcast (left and anti rows
    exactly once: the per-pass ownership) on both result faces, and the
    same as the JAX package's Grace join."""
    path, cols, vis = table
    vals = VALS["uint32"]
    base = Query(path, SCHEMA).join(1, KEYS, vals, how=how).run(device="cpu")
    base_m = Query(path, SCHEMA).join(1, KEYS, vals, how=how,
                                      materialize=True).run(device="cpu")
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    config.set("join_broadcast_max", 1024)
    jconfig.set("join_broadcast_max", 1024)
    try:
        q = Query(path, SCHEMA).join(1, KEYS, vals, how=how)
        plan = q.explain(device="cpu")
        assert plan.join_strategy == "partitioned(4)"
        assert "Grace" in plan.reason and f"join type {how}" in plan.reason
        assert plan.join_strategy == JQuery(path, JS).join(
            1, KEYS, vals, how=how).explain().join_strategy
        got = q.run(device="cpu")
        _same_agg(got, base, cols, _oracle(cols, vis, how)[0])
        _same_agg(got, JQuery(path, JS).join(1, KEYS, vals, how=how).run())
        rows = Query(path, SCHEMA).join(1, KEYS, vals, how=how,
                                        materialize=True).run(device="cpu")
        _same_rows(rows, base_m, ordered=False)
        _same_rows(rows, JQuery(path, JS).join(
            1, KEYS, vals, how=how, materialize=True).run(), ordered=False)
        lim = Query(path, SCHEMA).join(1, KEYS, vals, how=how,
                                       materialize=True, limit=9,
                                       offset=2).run(device="cpu")
        assert int(lim["count"]) == min(9, max(int(base_m["count"]) - 2, 0))
        assert np.isin(lim["positions"], base_m["positions"]).all()
    finally:
        config.restore(snap)
        jconfig.restore(jsnap)


def _dim_table(tmp_path, name, keys, vals, dtypes=("int32", "int32")):
    """A build table on disk, padded to whole pages with keys outside the
    fact key space (unique across the pads)."""
    schema = HeapSchema(n_cols=2, visibility=False, dtypes=dtypes)
    pad = (-len(keys)) % schema.tuples_per_page
    pk = np.concatenate([keys, np.arange(50_000, 50_000 + pad,
                                         dtype=np.int32)])
    pv = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    path = str(tmp_path / f"{name}.heap")
    build_heap_file(path, [pk, pv], schema)
    return path, schema, JSchema(n_cols=2, visibility=False, dtypes=dtypes), \
        pk, pv


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("how", HOWS)
def test_join_table_all_faces(configs, table, tmp_path, how, streamed):
    """``join_table``: a broadcast-sized build loads by one scan and
    equals ``join`` on the same arrays; above join_broadcast_max the local
    Grace join (its partitions from one projection scan, or streamed by
    one hash-predicate scan each past join_build_host_max) gives the same
    aggregate and the same rows as a set; both equal the JAX package's."""
    path, cols, vis = table
    rng = np.random.default_rng(41)
    keys = rng.permutation(np.arange(-600, 900, dtype=np.int32))[:900]
    bpath, bs, jbs, pk, pv = _dim_table(tmp_path, "dim", keys, keys * 3)
    base = Query(path, SCHEMA).join(1, pk, pv, how=how).run(device="cpu")
    base_m = Query(path, SCHEMA).join(1, pk, pv, how=how,
                                      materialize=True).run(device="cpu")

    def jt(**kw):
        return Query(path, SCHEMA).join_table(1, bpath, bs, 0, 1, how=how,
                                              **kw)

    def jjt(**kw):
        return JQuery(path, JS).join_table(1, bpath, jbs, 0, 1, how=how,
                                           **kw)

    assert jt().explain(device="cpu").join_strategy == "broadcast"
    _same_agg(jt().run(device="cpu"), base)
    _same_rows(jt(materialize=True).run(device="cpu"), base_m)
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    # one page of build rows (8128 bytes) over 4 KiB: two partitions
    config.set("join_broadcast_max", 4096)
    jconfig.set("join_broadcast_max", 4096)
    if streamed:
        config.set("join_build_host_max", 4096)
        jconfig.set("join_build_host_max", 4096)
    try:
        plan = jt().explain(device="cpu")
        assert plan.join_strategy == "partitioned(2)"
        assert "STREAMED" in plan.reason
        assert ("hash-predicate" in plan.reason) == streamed
        got = jt().run(device="cpu")
        _same_agg(got, base)
        _same_agg(got, jjt().run())
        rows = jt(materialize=True).run(device="cpu")
        _same_rows(rows, base_m, ordered=False)
        _same_rows(rows, jjt(materialize=True).run(), ordered=False)
        lm = jt(materialize=True, limit=7).run(device="cpu")
        assert int(lm["count"]) == min(7, int(base_m["count"]))
        assert np.isin(lm["positions"], base_m["positions"]).all()
    finally:
        config.restore(snap)
        jconfig.restore(jsnap)


def test_join_table_float_value_col(configs, table, tmp_path):
    """A float32 value column (a dimension's price) sums in float32,
    broadcast and streamed, on both packages."""
    path, cols, vis = table
    keys = np.arange(0, 512, dtype=np.int32)
    dvals = (keys * 0.5).astype(np.float32)
    bpath, bs, jbs, _pk, _pv = _dim_table(tmp_path, "fdim", keys, dvals,
                                          ("int32", "float32"))
    sel = (vis != 0) & (cols[1] < 512)
    want = dvals[cols[1][sel]].astype(np.float64)
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    try:
        for cap in (64 << 20, 1024):
            config.set("join_broadcast_max", cap)
            jconfig.set("join_broadcast_max", cap)
            out = Query(path, SCHEMA).join_table(1, bpath, bs, 0, 1) \
                .run(device="cpu")
            jout = JQuery(path, JS).join_table(1, bpath, jbs, 0, 1).run()
            assert np.asarray(out["payload_sum"]).dtype == np.float32
            _same(out["payload_sum"], jout["payload_sum"],
                  np.abs(want).sum(), "payload_sum")
            _same(out["payload_sum"], want.sum(), np.abs(want).sum())
            rows = Query(path, SCHEMA).join_table(
                1, bpath, bs, 0, 1, materialize=True).run(device="cpu")
            assert rows["payload"].dtype == np.float32
    finally:
        config.restore(snap)
        jconfig.restore(jsnap)


def test_join_table_refusals(configs, table, tmp_path):
    """Bad columns and dtypes, a missing file, a file that is not a heap
    and a column count that disagrees are refused before the terminal is
    claimed (the query stays reusable)."""
    path, _cols, _vis = table
    bpath, bs, _jbs, _pk, _pv = _dim_table(tmp_path, "d", KEYS, KEYS)
    q = Query(path, SCHEMA)
    fbs = HeapSchema(n_cols=2, dtypes=("float32", "int32"))
    wbs = HeapSchema(n_cols=2, dtypes=("int32", "int64"))
    junk = tmp_path / "junk.heap"
    junk.write_bytes(b"\0" * 8192)
    for args, code in (((bpath, bs, 0, 9), errno.EINVAL),
                       ((bpath, fbs, 0, 1), errno.EINVAL),
                       ((bpath, wbs, 0, 1), errno.EINVAL),
                       ((str(tmp_path / "missing.heap"), bs, 0, 1),
                        errno.ENOENT),
                       ((str(junk), bs, 0, 1), errno.EINVAL),
                       ((bpath, HeapSchema(n_cols=3), 0, 1), errno.EINVAL)):
        with pytest.raises(StromError) as e:
            q.join_table(1, *args)
        assert e.value.errno == code, args
    q.join_table(1, bpath, bs, 0, 1)
    assert int(q.run(device="cpu")["matched"]) > 0


def test_streamed_build_fails_when_the_table_changes(configs, table,
                                                     tmp_path):
    """The streamed Grace join checks the build table's size and mtime
    between partition passes: a table changed mid-query is EIO."""
    path, _cols, _vis = table
    bpath, bs, _jbs, _pk, _pv = _dim_table(tmp_path, "m", KEYS, KEYS)
    touched = []

    def touch(cols):
        if not touched:
            st = os.stat(bpath)
            os.utime(bpath, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
            touched.append(1)
        return torch.ones(cols[0].shape, dtype=torch.bool)

    snap = config.snapshot()
    config.set("join_broadcast_max", 1024)
    config.set("join_build_host_max", 4096)
    try:
        q = Query(path, SCHEMA).where(touch).join_table(1, bpath, bs, 0, 1)
        with pytest.raises(StromError) as e:
            q.run(device="cpu")
        assert e.value.errno == errno.EIO and touched
    finally:
        config.restore(snap)


def test_join_sums_cover_float_and_uint_columns(configs, table):
    """Join aggregates sum every fact column in its acc dtype (int32,
    float32, uint32) on the broadcast and Grace paths alike."""
    path, cols, vis = table
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    try:
        for how in ("inner", "anti"):
            for cap in (64 << 20, 1024):
                config.set("join_broadcast_max", cap)
                jconfig.set("join_broadcast_max", cap)
                got = Query(path, SCHEMA).join(1, KEYS, VALS["int32"],
                                               how=how).run(device="cpu")
                want = JQuery(path, JS).join(1, KEYS, VALS["int32"],
                                             how=how).run()
                emit, _p = _oracle(cols, vis, how)
                assert [np.asarray(s).dtype for s in got["sums"]] == [
                    np.int32, np.int32, np.float32, np.uint32]
                _same_agg(got, want, cols, emit)
                assert int(np.asarray(got["sums"][3])) == int(
                    cols[3][emit].sum(dtype=np.uint64) & 0xFFFFFFFF)
    finally:
        config.restore(snap)
        jconfig.restore(jsnap)


# -- on the card --------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the join runs on the card there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_join_and_star_on_card_match_the_cpu(configs, table, tmp_path,
                                             cuda_device):
    """A join (both faces, broadcast and Grace) and a star join on the
    card plan torch with the refusal named, launch no kernel, and equal
    the CPU route."""
    from nvme_strom_tpu_torch.ops import decode_cuda, filter_cuda, \
        groupby_cuda
    path, _cols, _vis = table
    bpath, bs, _jbs, _pk, _pv = _dim_table(tmp_path, "c", KEYS,
                                           VALS["float32"],
                                           ("int32", "float32"))
    before = (filter_cuda.launches, groupby_cuda.launches,
              decode_cuda.launches)
    star = [dict(probe_col=1, table=bpath, schema=bs, key_col=0,
                 value_col=1, how="inner")]
    makers = [lambda: Query(path, SCHEMA).join(1, KEYS, VALS["uint32"],
                                               how="left"),
              lambda: Query(path, SCHEMA).join(1, KEYS, VALS["uint32"],
                                               how="left",
                                               materialize=True),
              lambda: Query(path, SCHEMA).star_join(
                  star, exprs=[("bin", "*", ("col", 2), ("lit", 2.0))]),
              lambda: Query(path, SCHEMA).star_join(
                  star, materialize=True, fact_cols=[0, 3])]
    for make in makers:
        plan = make().explain(device=cuda_device)
        assert plan.kernel == "torch" and "no CUDA kernel" in plan.reason
        with pytest.raises(StromError) as e:
            make().run(device=cuda_device, kernel="cuda")
        assert e.value.errno == errno.EINVAL
        got, want = make().run(device=cuda_device), make().run(device="cpu")
        for k in want:
            if k in ("sums", "esums", "pay_sums"):
                for g, w in zip(got[k], want[k]):
                    _same(g, w, None, k)
            elif k in ("nncounts", "null_counts"):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                _same(got[k], want[k], None, k)
    snap = config.snapshot()
    config.set("join_broadcast_max", 1024)
    try:
        got = Query(path, SCHEMA).join(1, KEYS, VALS["int32"], how="anti") \
            .run(device=cuda_device)
        want = Query(path, SCHEMA).join(1, KEYS, VALS["int32"],
                                        how="anti").run(device="cpu")
        _same_agg(got, want)
    finally:
        config.restore(snap)
    assert (filter_cuda.launches, groupby_cuda.launches,
            decode_cuda.launches) == before


def test_partitioned_join_surfaces_injected_faults(configs, tmp_path):
    """A read fault mid-pass of the local partitioned join (a FaultPlan
    dead region under the probe table) surfaces as StromError in both
    packages, and the session and process go on: the healthy table
    joins as numpy says (``tests/test_query.py:1062``, its local face)."""
    from nvme_strom_tpu.api import StromError as JStromError
    from nvme_strom_tpu.testing import FakeNvmeSource as JFake
    from nvme_strom_tpu.testing import FaultPlan as JPlan
    from nvme_strom_tpu_torch.scan.heap import PAGE_SIZE
    from nvme_strom_tpu_torch.testing import FakeNvmeSource, FaultPlan
    schema = HeapSchema(n_cols=2, visibility=True)
    js = JSchema(n_cols=2, visibility=True)
    rng = np.random.default_rng(3)
    n = schema.tuples_per_page * 32
    c0 = rng.integers(-100, 100, n).astype(np.int32)
    c1 = rng.integers(0, 50, n).astype(np.int32)
    path = str(tmp_path / "pj.heap")
    build_heap_file(path, [c0, c1], schema)
    keys = np.arange(-100, 100, dtype=np.int32)
    vals = keys * 2
    for cfg in (config, jconfig):
        cfg.set("debug_no_threshold", True)
        cfg.set("join_broadcast_max", 1024)
        cfg.set("chunk_size", 64 << 10)
    plan = Query(path, schema).join(0, keys, vals).explain(device="cpu")
    assert plan.join_strategy.startswith("partitioned")
    src = FakeNvmeSource(path, force_cached_fraction=0.0,
                         fault_plan=FaultPlan(fail_offsets={4 * PAGE_SIZE}))
    try:
        with pytest.raises(StromError) as e:
            Query(src, schema).join(0, keys, vals).run(device="cpu")
    finally:
        src.close()
    jsrc = JFake(path, force_cached_fraction=0.0,
                 fault_plan=JPlan(fail_offsets={4 * PAGE_SIZE}))
    try:
        with pytest.raises(JStromError) as je:
            JQuery(jsrc, js).join(0, keys, vals).run()
    finally:
        jsrc.close()
    assert e.value.errno == je.value.errno == errno.EIO
    out = Query(path, schema).join(0, keys, vals).run(device="cpu")
    assert int(out["matched"]) == int(np.isin(c0, keys).sum())
