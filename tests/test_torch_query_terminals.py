"""The port's row and order terminals and its value-keyed GROUP BY
(``scan/query.py`` ``select``, ``fetch``, ``top_k``, ``order_by``,
``quantiles``, ``count_distinct``, ``group_by_cols`` with its sorted
spill, ``ops/topk.py``, ``scan/index.py``'s key packing and the scan's
early stop) against the JAX package's ``Query`` on the same heap table.
The port runs with ``device="cpu"`` (its ``torch`` route); the JAX
package on its CPU backend (its XLA route), both through their table
scanners at 64 KiB chunks.

Tolerances: values, positions, orders, keys, counts, integer sums (int32
and uint32 wrap mod 2^32), mins, maxs and HAVING's groups bit-identical
(positions compared as int64: the port's dtype, the JAX package's under
x64); float sums within ``1e-5 * sum(|x|) + 1e-6`` per group, sums of
squares within ``1e-5 * sum(x^2) + 1e-6``."""

import errno

import numpy as np
import pytest

from nvme_strom_tpu.api import StromError as JStromError
from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.index import pack_pair as jpack_pair
from nvme_strom_tpu.scan.index import unpack_second as junpack_second
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops import groupby_cuda
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.groupby import GroupKey
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.index import build_index, pack_pair, \
    unpack_first, unpack_second
from nvme_strom_tpu_torch.scan.query import Query
from nvme_strom_tpu_torch.stats import stats

KW = dict(n_cols=7, visibility=True,
          dtypes=("int32", "int32", "uint32", "float32", "int32", "int32",
                  "uint32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)


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


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """c0 13 values (many ties), c1 full int32, c2 full uint32, c3 float32,
    c4 1000 values, c5 5 values, c6 4 uint32 values above 2^31."""
    rng = np.random.default_rng(17)
    n = SCHEMA.tuples_per_page * 37 + 5
    cols = [rng.integers(-6, 7, n).astype(np.int32),
            rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            .astype(np.int32),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
            (rng.standard_normal(n) * 10).astype(np.float32),
            rng.integers(0, 1000, n).astype(np.int32),
            rng.integers(-2, 3, n).astype(np.int32),
            (rng.integers(0, 4, n) + (1 << 31) + 5).astype(np.uint32)]
    cols[1][:4] = [-(1 << 31), (1 << 31) - 1, -1, 0]
    vis = (rng.random(n) > 0.2).astype(np.int32)
    path = str(tmp_path_factory.mktemp("terminals") / "t.heap")
    build_heap_file(path, cols, SCHEMA, visibility=vis)
    return path, cols, vis


#: (port predicate, JAX predicate, numpy mask over the columns)
PREDS = {
    "all": (None, None, lambda c: True),
    "c0>2": (FilterPred(((0, "gt", 2),)), lambda c: c[0] > 2,
             lambda c: c[0] > 2),
    "c3<0.5&c5!=0": (FilterPred(((3, "lt", 0.5), (5, "ne", 0))),
                     lambda c: (c[3] < 0.5) & (c[5] != 0),
                     lambda c: (c[3] < np.float32(0.5)) & (c[5] != 0)),
    "none": (FilterPred(((0, "gt", 100),)), lambda c: c[0] > 100,
             lambda c: c[0] > 100),
}


class _Queries:
    """``queries(pred) -> (port Query, JAX Query)`` over one table, with
    the named predicate of :data:`PREDS` applied to both."""

    def __init__(self, path, schemas=(SCHEMA, JS)):
        self.path = path
        self.schemas = schemas

    def __call__(self, pred_name: str):
        p, jp, _np = PREDS[pred_name]
        q, jq = Query(self.path, self.schemas[0]), \
            JQuery(self.path, self.schemas[1])
        if p is not None:
            q, jq = q.where(p), jq.where(jp)
        return q, jq


@pytest.fixture()
def queries(configs, table):
    return _Queries(table[0])


SPECIAL_KW = dict(n_cols=2, visibility=True, dtypes=("int32", "float32"))
SPECIAL_PAGES = 20
SPECIAL_FLOATS = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf],
                          np.float32)


@pytest.fixture(scope="module")
def special_table(tmp_path_factory):
    """20 pages (three scan batches): c0 13 values, c1 float32 of which
    60% are NaN, -NaN (bits 0xFFC00000), +0.0, -0.0, +inf or -inf."""
    schema = HeapSchema(**SPECIAL_KW)
    rng = np.random.default_rng(29)
    n = schema.tuples_per_page * SPECIAL_PAGES - 3
    c0 = rng.integers(-6, 7, n).astype(np.int32)
    c1 = (rng.standard_normal(n) * 10).astype(np.float32)
    pick = rng.random(n) < 0.6
    c1[pick] = rng.choice(SPECIAL_FLOATS, int(pick.sum()))
    assert (c1.view(np.uint32) == 0xFFC00000).any()
    vis = (rng.random(n) > 0.2).astype(np.int32)
    path = str(tmp_path_factory.mktemp("special") / "f.heap")
    build_heap_file(path, [c0, c1], schema, visibility=vis)
    return path


@pytest.fixture()
def special(configs, special_table):
    return _Queries(special_table, (HeapSchema(**SPECIAL_KW),
                                    JSchema(**SPECIAL_KW)))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iu" and b.dtype.kind in "iu" and \
            {a.dtype.itemsize, b.dtype.itemsize} == {4, 8}:
        a, b = a.astype(np.int64), b.astype(np.int64)   # positions
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# -- explain and the route ----------------------------------------------------

_ROUTE_CASES = {
    "select": lambda q: q.select([0]),
    "top_k": lambda q: q.top_k(0, 3),
    "order_by": lambda q: q.order_by(0),
    "quantiles": lambda q: q.quantiles(0, [0.5]),
    "count_distinct": lambda q: q.count_distinct(0),
    "group_by_cols": lambda q: q.group_by_cols(4, agg_cols=[0]),
    "G above the cap": lambda q: q.group_by(
        GroupKey(4), groupby_cuda.MAX_GROUPS + 1, agg_cols=[0]),
    "callable where": lambda q: q.where(lambda c: c[0] > 0).aggregate([0]),
    "callable key": lambda q: q.group_by(lambda c: c[5] + 2, 5,
                                         agg_cols=[0]),
}
_REFUSAL = {"select": "row/order terminal", "top_k": "row/order terminal",
            "order_by": "row/order terminal",
            "quantiles": "row/order terminal",
            "count_distinct": "row/order terminal",
            "group_by_cols": "value-keyed",
            "G above the cap": str(groupby_cuda.MAX_GROUPS),
            "callable where": "callable", "callable key": "callable"}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_explain_routes_what_the_kernels_refuse_to_torch(queries, case):
    """On the CPU every query plans the torch route; kernel='cuda' is an
    invalid plan and run() raises EINVAL; the refusal the card's plan
    would name is computed before any I/O."""
    q = _ROUTE_CASES[case](Query(queries.path, SCHEMA))
    plan = q.explain(device="cpu")
    assert plan.kernel == "torch" and "PyTorch ops on cpu" in plan.reason
    assert q.explain(device="cpu", kernel="torch").kernel == "torch"
    bad = q.explain(device="cpu", kernel="cuda")
    assert bad.kernel == "invalid" and "CUDA" in bad.reason
    with pytest.raises(StromError) as e:
        q.run(device="cpu", kernel="cuda")
    assert e.value.errno == errno.EINVAL
    assert _REFUSAL[case] in q._cuda_refusal()
    with pytest.raises(StromError):
        q.explain(device="cpu", kernel="plain")


def test_kernels_take_what_they_can(queries):
    """What B1/B3 accept carries no refusal, so auto on a card plans
    cuda for it."""
    assert Query(queries.path, SCHEMA).where(FilterPred(((0, "gt", 1),))) \
        .aggregate([0, 3])._cuda_refusal() == ""
    assert Query(queries.path, SCHEMA).group_by(
        GroupKey(4, 64), 64, agg_cols=[0, 1])._cuda_refusal() == ""


# -- select, the early stop, fetch --------------------------------------------

_SELECT_CASES = {
    "all cols": (None, None, 0, "all"),
    "where, two cols": ([0, 3], None, 0, "c0>2"),
    "limit offset": ([2], 10, 5, "all"),
    "limit 0": ([1, 0], 0, 0, "c0>2"),
    "limit past the end": ([3, 6], 100000, 3, "c3<0.5&c5!=0"),
    "empty": ([4], None, 0, "none"),
    "offset only": ([5], None, 9000, "c0>2"),
}


@pytest.mark.parametrize("case", sorted(_SELECT_CASES))
def test_select_matches_jax(queries, table, case):
    cols, limit, offset, pname = _SELECT_CASES[case]
    q, jq = queries(pname)
    got = q.select(cols, limit=limit, offset=offset).run(device="cpu")
    want = jq.select(cols, limit=limit, offset=offset).run()
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k])
    path, c, vis = table
    sel = (vis != 0) & PREDS[pname][2](c)
    rows = np.flatnonzero(sel)[offset:None if limit is None
                               else offset + limit]
    _eq(got["positions"], rows.astype(np.int64))


def _cold_table(tmp_path, n_pages=64):
    import os
    schema = HeapSchema(n_cols=1, visibility=False)
    n = schema.tuples_per_page * n_pages
    path = str(tmp_path / "big.heap")
    build_heap_file(path, [np.arange(n, dtype=np.int32)], schema)
    fd = os.open(path, os.O_RDONLY)
    os.fsync(fd)
    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    os.close(fd)
    config.set("chunk_size", 1 << 16)
    config.set("async_depth", 2)        # a ring much smaller than the table
    return path, schema


def test_select_limit_stops_io_early(configs, tmp_path):
    """The scan issues no read once the limit is met: bytes read stay
    within the ring (2 in flight + resubmits), not the 8 chunks."""
    path, schema = _cold_table(tmp_path)
    before = stats.snapshot().get("total_dma_length", 0)
    out = Query(path, schema).select(limit=4).run(device="cpu")
    read = stats.snapshot().get("total_dma_length", 0) - before
    assert int(out["count"]) == 4
    _eq(out["col0"], np.arange(4, dtype=np.int32))
    assert 0 < read <= 4 * 65536
    full_before = stats.snapshot().get("total_dma_length", 0)
    Query(path, schema).select().run(device="cpu")
    assert stats.snapshot().get("total_dma_length", 0) - full_before \
        >= 8 * 65536


def test_select_limit_drains_ring_before_owner_recovery(configs, tmp_path,
                                                        monkeypatch):
    """The early stop waits out the reads and copies in flight and
    returns every chunk inside the scan's resource owner: no chunk is
    still attached when its __exit__ runs."""
    from nvme_strom_tpu_torch.scan import pool as pool_mod
    path, schema = _cold_table(tmp_path)
    attached_at_exit = []
    orig_exit = pool_mod.ResourceOwner.__exit__

    def spy_exit(self, exc_type, exc, tb):
        attached_at_exit.append(len(self._chunks))
        return orig_exit(self, exc_type, exc, tb)

    monkeypatch.setattr(pool_mod.ResourceOwner, "__exit__", spy_exit)
    out = Query(path, schema).select(limit=4).run(device="cpu")
    assert int(out["count"]) == 4
    assert attached_at_exit and all(n == 0 for n in attached_at_exit)


def test_select_rejects_bad_args(queries):
    plan = Query(queries.path, SCHEMA).select([9]).explain(device="cpu")
    assert plan.kernel == "invalid" and "out of range" in plan.reason
    with pytest.raises(StromError):
        Query(queries.path, SCHEMA).select([9]).run(device="cpu")
    for kw in (dict(limit=-1), dict(offset=-1)):
        with pytest.raises(StromError):
            Query(queries.path, SCHEMA).select(**kw)
    with pytest.raises(StromError):   # still one terminal per query
        Query(queries.path, SCHEMA).select().order_by(0)


_FETCH_CASES = {
    "duplicates, unsorted": ([5, 3, 5, 0, 1000, 3], None),
    "invisible and past the last tuple": (
        [0, 1, 2, 3, SCHEMA.tuples_per_page * 37 + 6,
         SCHEMA.tuples_per_page * 38 - 1], [2, 3]),
    "every page": (list(range(7, SCHEMA.tuples_per_page * 38,
                              SCHEMA.tuples_per_page // 3)), [6, 0]),
    "empty": ([], [1]),
}


@pytest.mark.parametrize("case", sorted(_FETCH_CASES))
def test_fetch_matches_jax(queries, table, case):
    pos, cols = _FETCH_CASES[case]
    got = Query(queries.path, SCHEMA).fetch(pos, cols, device="cpu")
    want = JQuery(queries.path, JS).fetch(pos, cols)
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k])
    path, c, vis = table
    ok = [p < len(vis) and vis[p] != 0 for p in pos]
    _eq(got["valid"], np.array(ok, bool))


def test_fetch_refuses_positions_outside_the_table(queries):
    n = SCHEMA.tuples_per_page * 38
    for pos in ([n], [-1]):
        with pytest.raises(StromError) as e:
            Query(queries.path, SCHEMA).fetch(pos, device="cpu")
        assert e.value.errno == errno.ERANGE
        with pytest.raises(JStromError):
            JQuery(queries.path, JS).fetch(pos)
    with pytest.raises(StromError) as e:
        Query(queries.path, SCHEMA).fetch([0], [7], device="cpu")
    assert e.value.errno == errno.EINVAL


# -- top_k, order_by, quantiles, count_distinct -------------------------------

_SLOTS = HeapSchema(**SPECIAL_KW).tuples_per_page * SPECIAL_PAGES
#: (column, k, largest, predicate[, "special": the special_table])
_TOPK_CASES = {
    "i32 ties largest": (0, 50, True, "all"),
    "i32 ties smallest where": (0, 40, False, "c0>2"),
    "u32 largest": (2, 9, True, "all"),
    "u32 smallest": (2, 9, False, "c3<0.5&c5!=0"),
    "f32 largest": (3, 17, True, "c0>2"),
    "f32 smallest": (3, 5, False, "all"),
    "k past the rows (pads)": (1, 10, True, "none"),
    "k = 0": (4, 0, True, "all"),
    "f32 NaN/-0/inf largest": (1, 40, True, "all", "special"),
    "f32 NaN/-0/inf smallest": (1, 40, False, "all", "special"),
    "f32 NaN/-0/inf largest to +-0": (1, _SLOTS // 2, True, "all",
                                      "special"),
    "f32 NaN/-0/inf smallest to +-0": (1, _SLOTS // 2, False, "c0>2",
                                       "special"),
    "f32 NaN/-0/inf largest, -NaN below filtered rows":
        (1, _SLOTS + 5, True, "c0>2", "special"),
    "f32 NaN/-0/inf smallest, +NaN below filtered rows":
        (1, _SLOTS + 5, False, "c0>2", "special"),
}


def _bits_eq(a, b):
    """Equal dtypes and values, floats bit for bit (NaN signs, -0.0)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f" and a.dtype == b.dtype:
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    _eq(a, b)


@pytest.mark.parametrize("case", sorted(_TOPK_CASES))
def test_top_k_matches_jax(queries, special, case):
    col, k, largest, pname, *on = _TOPK_CASES[case]
    q, jq = (special if on else queries)(pname)
    got = q.top_k(col, k, largest=largest).run(device="cpu")
    want = jq.top_k(col, k, largest=largest).run()
    _bits_eq(got["values"], want["values"])
    _eq(got["positions"], want["positions"])


@pytest.mark.parametrize("k", [3, 50, 300])
@pytest.mark.parametrize("largest", [True, False],
                         ids=["largest", "smallest"])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_rank_and_combine_topk_total_order_match_jax(dt, largest, k):
    """``ops.topk``'s selection and batch fold over float32 and float64
    candidates of NaN, -NaN, +-0.0, +-inf and normals, against the JAX
    package's (``lax.top_k``, under x64 for float64): values bit for bit
    and positions (a Query's top_k takes 4-byte columns only)."""
    import jax
    import jax.numpy as jnp
    import torch

    from nvme_strom_tpu.ops.topk import combine_topk as jcombine
    from nvme_strom_tpu.ops.topk import rank_topk as jrank
    from nvme_strom_tpu.ops.topk import topk_key as jkey
    from nvme_strom_tpu_torch.ops.topk import combine_topk, rank_topk
    rng = np.random.default_rng(k)
    d = np.dtype(dt)
    v = (rng.standard_normal(257) * 10).astype(d)
    pick = rng.random(257) < 0.7
    v[pick] = rng.choice(SPECIAL_FLOATS.astype(d), int(pick.sum()))
    assert np.signbit(v[np.isnan(v)]).any()
    pos = np.arange(257, dtype=np.int64)
    tv, tp = torch.from_numpy(v), torch.from_numpy(pos)
    with jax.enable_x64(True):
        jv, jp = jnp.asarray(v), jnp.asarray(pos)
        halves = []
        for sl in (slice(0, 130), slice(130, None)):
            got = rank_topk(tv[sl], tp[sl], k, d, largest)
            want = jrank(jv[sl], jp[sl], k, d, largest)
            _bits_eq(got[0].numpy(), np.asarray(want[0]))
            _eq(got[1].numpy(), np.asarray(want[1]))
            halves.append((got, want))
        (g0, w0), (g1, w1) = halves
        got = combine_topk({"values": g0[0], "positions": g0[1]},
                           {"values": g1[0], "positions": g1[1]}, dt=d,
                           largest=largest)
        want = jcombine({"values": w0[0], "positions": w0[1]},
                        {"values": w1[0], "positions": w1[1]},
                        largest=largest,
                        key_of=lambda x: jkey(x, d, largest))
        _bits_eq(got["values"].numpy(), np.asarray(want["values"]))
        _eq(got["positions"].numpy(), np.asarray(want["positions"]))


_ORDER_CASES = {
    "i32 asc (ties by arrival)": (0, False, None, 0, "all"),
    "i32 desc": (0, True, None, 0, "c3<0.5&c5!=0"),
    "two cols": ([5, 4], False, None, 0, "all"),
    "two cols desc limit offset": ([0, 1], True, 25, 7, "all"),
    "three cols": ([5, 0, 2], False, 300, 0, "c0>2"),
    "u32 limit": (2, False, 9, 0, "all"),
    "f32 desc offset": (3, True, None, 100, "c0>2"),
    "empty": ([0, 3], False, 5, 0, "none"),
    "limit 0": (4, False, 0, 3, "all"),
}


@pytest.mark.parametrize("case", sorted(_ORDER_CASES))
def test_order_by_matches_jax(queries, case):
    cols, desc, limit, offset, pname = _ORDER_CASES[case]
    q, jq = queries(pname)
    got = q.order_by(cols, descending=desc, limit=limit,
                     offset=offset).run(device="cpu")
    want = jq.order_by(cols, descending=desc, limit=limit,
                       offset=offset).run()
    assert sorted(got) == sorted(want)
    _eq(got["values"], want["values"])
    _eq(got["positions"], want["positions"])


_COLUMN_CASES = {
    "i32": (4, "all"), "i32 where": (0, "c0>2"), "u32": (6, "all"),
    "u32 full range": (2, "c3<0.5&c5!=0"), "f32": (3, "c0>2"),
    "empty": (1, "none"),
}


@pytest.mark.parametrize("case", sorted(_COLUMN_CASES))
def test_quantiles_and_count_distinct_match_jax(queries, case):
    col, pname = _COLUMN_CASES[case]
    qs = [0.0, 0.01, 0.5, 0.99, 1.0]
    q, jq = queries(pname)
    got = q.quantiles(col, qs).run(device="cpu")
    want = jq.quantiles(col, qs).run()
    _eq(got["quantiles"], want["quantiles"])
    assert int(got["n"]) == int(want["n"])
    q, jq = queries(pname)
    got = q.count_distinct(col).run(device="cpu")
    want = jq.count_distinct(col).run()
    _eq(got["distinct"], want["distinct"])


def test_uint32_ordered_terminals(configs, tmp_path):
    """Every ordered terminal on a uint32 column with values above
    2^31, against numpy truth and the JAX package."""
    kw = dict(n_cols=1, visibility=False, dtypes=("uint32",))
    schema, js = HeapSchema(**kw), JSchema(**kw)
    rng = np.random.default_rng(21)
    u = rng.integers(0, 1 << 32, schema.tuples_per_page * 8,
                     dtype=np.uint64).astype(np.uint32)
    path = str(tmp_path / "u.heap")
    build_heap_file(path, [u], schema)
    srt = np.sort(u)
    ob = Query(path, schema).order_by(0, limit=9).run(device="cpu")
    _eq(ob["values"], srt[:9])
    tk = Query(path, schema).top_k(0, 5).run(device="cpu")
    _eq(tk["values"], srt[-5:][::-1])
    _eq(tk["values"], JQuery(path, js).top_k(0, 5).run()["values"])
    qt = Query(path, schema).quantiles(0, [0.5]).run(device="cpu")
    _eq(qt["quantiles"],
        JQuery(path, js).quantiles(0, [0.5]).run()["quantiles"])
    cd = Query(path, schema).count_distinct(0).run(device="cpu")
    assert int(cd["distinct"]) == len(np.unique(u))


@pytest.mark.parametrize("case", ["out of range", "int64", "float64"])
def test_order_terminals_refuse_unsortable_columns(configs, tmp_path, case):
    kw = dict(n_cols=2, dtypes=("int32", "int64" if case == "int64"
                                else "float64"))
    schema = HeapSchema(**kw)
    path = str(tmp_path / "s.heap")
    build_heap_file(path, [np.arange(10, dtype=np.int32),
                           np.arange(10).astype(schema.col_dtype(1))],
                    schema)
    col = 5 if case == "out of range" else 1
    for q in (Query(path, schema).order_by(col),
              Query(path, schema).quantiles(col, [0.5]),
              Query(path, schema).count_distinct(col)):
        plan = q.explain(device="cpu")
        assert plan.kernel == "invalid"
        with pytest.raises(StromError) as e:
            q.run(device="cpu")
        assert e.value.errno == errno.EINVAL
    with pytest.raises(JStromError):
        JQuery(path, JSchema(**kw)).order_by(col).run()


# -- value-keyed GROUP BY -----------------------------------------------------

def _same_groups(got, want, agg_dt):
    assert sorted(got) == sorted(want)
    _eq(got["groups"], want["groups"])
    assert len(got["key_cols"]) == len(want["key_cols"])
    for a, b in zip(got["key_cols"], want["key_cols"]):
        _eq(a, b)
    _eq(got["count"].astype(np.int64), want["count"].astype(np.int64))
    for k in ("mins", "maxs"):
        _eq(got[k], want[k])
    if np.dtype(agg_dt).kind == "f":
        cnt = np.maximum(want["count"], 1)
        sq = np.asarray(want["sumsqs"], np.float64)
        mag = np.abs(want["avgs"]) * cnt + np.sqrt(sq * cnt)
        assert (np.abs(got["sums"] - want["sums"]) <= 1e-5 * mag + 1e-6).all()
    else:
        _eq(got["sums"], want["sums"])
    assert (np.abs(got["sumsqs"] - want["sumsqs"])
            <= 1e-5 * np.asarray(want["sumsqs"]) + 1e-6).all()


_GBC_CASES = {
    # name: (key cols, agg cols, predicate, having, max_groups)
    "one col": ([4], [0, 1], "all", None, 1 << 16),
    "one u32 col where": ([6], [3], "c0>2", None, 1 << 16),
    "one col having": ([5], [2], "all",
                       lambda g: g["count"] > np.median(g["count"]), 1 << 16),
    "two cols": ([0, 5], [1], "c3<0.5&c5!=0", None, 1 << 16),
    "two cols u32 having": ([6, 0], [3], "all",
                            lambda g: g["avgs"][0] > 0, 1 << 16),
    "three cols": ([5, 0, 6], [4], "c0>2", None, 1 << 16),
    "four cols": ([5, 6, 0, 4], [1], "c3<0.5&c5!=0", None, 1 << 16),
    "empty": ([4], [0], "none", None, 1 << 16),
    "spill one col": ([4], [0, 1], "c0>2", None, 50),
    "spill one col having": ([4], [3], "all",
                             lambda g: g["count"] >= 8, 10),
    "spill two cols": ([4, 5], [2], "c3<0.5&c5!=0", None, 300),
    "spill two cols having": ([0, 4], [1], "all",
                              lambda g: g["sums"][0] > 0, 2000),
}


@pytest.mark.parametrize("sidecar", [False, True])
@pytest.mark.parametrize("case", sorted(_GBC_CASES))
def test_group_by_cols_matches_jax(queries, table, case, sidecar,
                                   monkeypatch):
    """Key discovery by a projection scan, and (``sidecar``) from a fresh
    index sidecar on exactly the 1-2 key columns with no table I/O: the
    discovery may not scan, and both packages read the port's sidecar."""
    import os
    key_cols, agg, pname, having, mg = _GBC_CASES[case]
    ipath = None
    if sidecar and len(key_cols) <= 2:
        ipath = build_index(queries.path, SCHEMA, key_cols[0] if len(
            key_cols) == 1 else tuple(key_cols), device="cpu")
        discover = Query._discover_group_keys

        def no_scan(*_a):
            raise AssertionError("key discovery scanned the table")

        def spy(self, dev):
            self._stream_collect = no_scan
            try:
                return discover(self, dev)
            finally:
                del self._stream_collect
        monkeypatch.setattr(Query, "_discover_group_keys", spy)
    try:
        q, jq = queries(pname)
        got = q.group_by_cols(key_cols, agg_cols=agg, having=having,
                              max_groups=mg).run(device="cpu")
        want = jq.group_by_cols(key_cols, agg_cols=agg, having=having,
                                max_groups=mg).run()
    finally:
        if ipath is not None:
            os.unlink(ipath)
    _same_groups(got, want, SCHEMA.col_dtype(agg[0]))
    # the distinct selected keys, in key order, against numpy
    path, c, vis = table
    sel = (vis != 0) & PREDS[pname][2](c)
    keys = np.unique(np.stack([c[k][sel].astype(np.int64)
                               for k in key_cols], 1), axis=0)
    if having is None:
        for j, k in enumerate(key_cols):
            _eq(got["key_cols"][j], keys[:, j].astype(c[k].dtype))
        assert int(got["count"].sum()) == int(sel.sum())


@pytest.mark.parametrize("case", ["no key", "five keys", "out of range",
                                  "float key", "max_groups 0",
                                  "three keys past max_groups"])
def test_group_by_cols_validation(queries, case):
    def build(q):
        if case == "no key":
            return q.group_by_cols([])
        if case == "five keys":
            return q.group_by_cols([0, 1, 2, 4, 5])
        if case == "out of range":
            return q.group_by_cols(7)
        if case == "float key":
            return q.group_by_cols(3)
        if case == "max_groups 0":
            return q.group_by_cols(0, max_groups=0)
        return q.group_by_cols([0, 5, 4], agg_cols=[1], max_groups=20)
    if case == "three keys past max_groups":
        with pytest.raises(StromError) as e:
            build(Query(queries.path, SCHEMA)).run(device="cpu")
        assert e.value.errno == errno.ENOMEM
        with pytest.raises(JStromError):
            build(JQuery(queries.path, JS)).run()
        return
    with pytest.raises(StromError) as e:
        build(Query(queries.path, SCHEMA))
    assert e.value.errno == errno.EINVAL
    with pytest.raises(JStromError):
        build(JQuery(queries.path, JS))


@pytest.mark.parametrize("dts", [("int32", "int32"), ("int32", "uint32"),
                                 ("uint32", "int32"), ("uint32", "uint32")])
def test_pack_pair_matches_the_index_module(dts):
    rng = np.random.default_rng(3)
    a = [rng.integers(-(1 << 31) if d == "int32" else 0,
                      (1 << 31) if d == "int32" else (1 << 32), 500,
                      dtype=np.int64).astype(d) for d in dts]
    a[0][:2] = np.iinfo(dts[0]).min, np.iinfo(dts[0]).max
    got = pack_pair(a[0], a[1], np.dtype(dts[0]), np.dtype(dts[1]))
    _eq(got, jpack_pair(a[0], a[1], np.dtype(dts[0]), np.dtype(dts[1])))
    _eq(unpack_second(got, np.dtype(dts[1])),
        junpack_second(got, np.dtype(dts[1])))
    _eq(unpack_first(got, np.dtype(dts[0])), a[0])
    # packed order is (a0, a1) tuple order
    order = np.argsort(got, kind="stable")
    _eq(order, np.lexsort((a[1], a[0])))
