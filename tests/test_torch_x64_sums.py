"""64-bit scalar sums and wide literals: the port under config ``x64``
against the JAX package under ``jax.enable_x64(True)``, on the same heap
bytes, and the port's wide-schema rule against the JAX package's only
answer for such a table.

The table's 4-byte integer sums pass 2^31: two int32 columns near
2.05e9 and a uint32 column near 3.5e9.  Every integer sum and count is
held exactly, against the reference and against numpy int64 / uint64
truth; dtypes too (int64 sums and counts, uint64 for a uint32 column on
the host); float sums within ``1e-5 * sum(|x|) + 1e-6``.

Without ``x64`` on a schema of 4-byte columns nothing changes: the sums
wrap mod 2^32 in both packages.  A Python int literal outside the
column's own range stays EINVAL under ``x64``, where jnp wraps it into
the column's type and answers for the wrapped value (a recorded
divergence; the reference's wrapped rows are the evidence below)."""

import errno
import math

import jax
import numpy as np
import pytest
import torch

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan import sql as jsql
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops import decode_cuda, filter_cuda
from nvme_strom_tpu_torch.ops.filter import FilterPred, term_value, wide_sums
from nvme_strom_tpu_torch.ops.groupby import GroupKey
from nvme_strom_tpu_torch.scan import sql as tsql
from nvme_strom_tpu_torch.scan.colpack import build_packed, probe_packed
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.query import Query
from nvme_strom_tpu_torch.testing.sql_results import (_close,
                                                      assert_same_result)

KW = dict(n_cols=4, visibility=True,
          dtypes=("int32", "int32", "uint32", "float32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)
CUDA = torch.device("cuda")


@pytest.fixture()
def configs():
    """64 KiB chunks (several batches to fold) on both sides, the switch
    off; everything restored after the test."""
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    for c in (config, jconfig):
        c.set("chunk_size", 1 << 16)
        c.set("debug_no_threshold", True)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


@pytest.fixture()
def x64(configs):
    config.set("x64", True)
    yield


def _columns(n, seed=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(2_000_000_000, 2_100_000_000, n).astype(np.int32),
            rng.integers(-2_100_000_000, -2_000_000_000, n).astype(np.int32),
            rng.integers(3_400_000_000, 3_600_000_000, n,
                         dtype=np.int64).astype(np.uint32),
            (rng.standard_normal(n) * 100).astype(np.float32)]


@pytest.fixture()
def table(tmp_path):
    n = SCHEMA.tuples_per_page * 23 + 7
    cols = _columns(n)
    rng = np.random.default_rng(5)
    vis = (rng.random(n) > 0.1).astype(np.int32)
    path = str(tmp_path / "x.heap")
    build_heap_file(path, cols, SCHEMA, visibility=vis)
    return path, cols, vis != 0


def _truth(col, sel):
    wide = np.uint64 if col.dtype == np.uint32 else np.int64
    return col[sel].astype(wide).sum(dtype=wide)


def _agg_dtypes(x64_on):
    return [np.dtype(np.int64 if x64_on else np.int32)] * 2 + \
        [np.dtype(np.uint64 if x64_on else np.uint32), np.dtype(np.float32)]


def _check_sums(got, want, cols, sel, x64_on):
    assert np.asarray(got["count"]).dtype == np.asarray(want["count"]).dtype
    assert int(got["count"]) == int(want["count"]) == int(sel.sum())
    for c, (g, w) in enumerate(zip(got["sums"], want["sums"])):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype == _agg_dtypes(x64_on)[c], c
        if g.dtype.kind == "f":
            tol = 1e-5 * float(np.abs(cols[c][sel]).astype(np.float64)
                               .sum()) + 1e-6
            assert abs(float(g) - float(w)) <= tol
            continue
        assert int(g) == int(w), c
        truth = int(_truth(cols[c], sel))
        assert int(g) == (truth if x64_on else
                          int(np.array(truth).astype(g.dtype))), c


@pytest.mark.parametrize("x64_on", [True, False], ids=["x64", "32-bit"])
def test_aggregate_sums_match_jax(configs, table, x64_on):
    """``Query.aggregate``: under x64 the count and the int sums are
    64-bit and exact, as the reference's; without it both wrap."""
    path, cols, sel = table
    config.set("x64", x64_on)
    got = Query(path, SCHEMA).aggregate().run(device="cpu")
    with jax.enable_x64(x64_on):
        want = JQuery(path, JS).aggregate().run()
        want = {"count": np.asarray(want["count"]),
                "sums": [np.asarray(s) for s in want["sums"]]}
    _check_sums(got, want, cols, sel, x64_on)
    # a projection and a predicate keep the widths
    got = Query(path, SCHEMA).where(FilterPred(((3, "gt", 0.0),))) \
        .aggregate([2, 0]).run(device="cpu")
    with jax.enable_x64(x64_on):
        want = JQuery(path, JS).where(lambda c: c[3] > 0.0) \
            .aggregate([2, 0]).run()
    assert [np.asarray(s).dtype for s in got["sums"]] == \
        [np.asarray(s).dtype for s in want["sums"]]
    assert [int(s) for s in got["sums"]] == [int(s) for s in want["sums"]]


def test_expression_sums_keep_row_arithmetic(x64, table):
    """``aggregate_exprs([c0 * 2])``: each row's product stays int32 (it
    wraps, as the reference's ``_bin_dtype`` says), only the sum widens."""
    path, cols, sel = table
    e = ("bin", "*", ("col", 0), ("lit", 2))
    f = ("bin", "+", ("col", 3), ("lit", 1.5))
    got = Query(path, SCHEMA).aggregate_exprs([e, f]).run(device="cpu")
    with jax.enable_x64(True):
        want = JQuery(path, JS).aggregate_exprs([e, f]).run()
    rows = (cols[0][sel] * np.int32(2)).astype(np.int64)   # wrapped rows
    assert np.asarray(got["esums"][0]).dtype == np.int64
    assert int(got["esums"][0]) == int(want["esums"][0]) == int(rows.sum())
    assert int(got["count"]) == int(want["count"])
    assert np.asarray(got["count"]).dtype == np.int64
    tol = 1e-5 * float(np.abs(cols[3][sel] + 1.5).sum()) + 1e-6
    assert abs(float(got["esums"][1]) - float(want["esums"][1])) <= tol


_SQL = [
    "SELECT COUNT(*), SUM(c0), SUM(c1), SUM(c2), AVG(c0), AVG(c2) FROM t",
    "SELECT SUM(c0 * 2), AVG(c1 - 7) FROM t WHERE c3 > 0",
    "SELECT COUNT(*), SUM(c2) FROM t WHERE c2 > 3500000000",
    "SELECT SUM(c1), COUNT(c2), AVG(c3) FROM t WHERE c1 < -2050000000",
]


@pytest.mark.parametrize("stmt", _SQL)
def test_sql_sums_and_averages_match_jax(x64, table, stmt):
    """SQL ``SUM`` / ``AVG`` (and a uint32 literal above 2^31) through
    both facades under 64-bit mode, on the same table."""
    path, cols, sel = table
    got = tsql.sql_query(stmt, path, SCHEMA, device="cpu")
    with jax.enable_x64(True):
        want = jsql.sql_query(stmt, path, JS)
    assert_same_result(got, want, what=stmt)
    if stmt == _SQL[0]:
        assert int(got["sum(c0)"]) == int(_truth(cols[0], sel))
        assert int(got["sum(c2)"]) == int(_truth(cols[2], sel))
        assert abs(float(got["avg(c0)"])
                   - float(_truth(cols[0], sel)) / sel.sum()) < 1e-3


def _probe_table(tmp_path):
    """A fact table whose column 1 probes a dimension (small keys) and
    whose other columns pass 2^31 in their sums."""
    n = SCHEMA.tuples_per_page * 11 + 3
    cols = _columns(n, seed=3)
    cols[1] = np.random.default_rng(4).integers(0, 40, n).astype(np.int32)
    path = str(tmp_path / "f.heap")
    build_heap_file(path, cols, SCHEMA)
    return path, cols


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_sums_widen_under_x64(x64, tmp_path, how):
    """A broadcast join's column sums, payload sum and counts: 64-bit and
    exact, equal to the reference's under jax_enable_x64."""
    path, cols = _probe_table(tmp_path)
    keys = np.arange(0, 40, 2, dtype=np.int32)
    vals = np.random.default_rng(9).integers(
        2_000_000_000, 2_100_000_000, len(keys)).astype(np.int32)
    got = Query(path, SCHEMA).join(1, keys, vals, how=how).run(device="cpu")
    with jax.enable_x64(True):
        want = JQuery(path, JS).join(1, keys, vals, how=how).run()
    for k in ("matched", "payload_sum", "null_count"):
        if k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            assert int(got[k]) == int(want[k]), k
    for c, (g, w) in enumerate(zip(got["sums"], want["sums"])):
        assert np.asarray(g).dtype == np.asarray(w).dtype, c
        if c != 3:
            assert int(g) == int(w), c
    hit = np.isin(cols[1], keys)
    emit = hit if how == "inner" else np.ones_like(hit)
    assert int(got["sums"][0]) == int(_truth(cols[0], emit))
    assert int(got["sums"][2]) == int(_truth(cols[2], emit))
    lut = dict(zip(keys.tolist(), vals.astype(np.int64).tolist()))
    assert int(got["payload_sum"]) == sum(lut[k] for k in cols[1][hit])


def test_star_join_sums_widen_under_x64(x64, tmp_path):
    """A star join's fact sums, payload sums, counts and expression sums
    under 64-bit mode against the reference's."""
    path, cols = _probe_table(tmp_path)
    dims = []
    for i, (lo, hi) in enumerate(((0, 40), (10, 30))):
        k = np.arange(lo, hi, dtype=np.int32)
        v = np.full(len(k), 2_000_000_000 + i, np.int32)
        dschema = dict(n_cols=2, visibility=False, dtypes=("int32", "int32"))
        dp = str(tmp_path / f"d{i}.heap")
        build_heap_file(dp, [k, v], HeapSchema(**dschema))
        dims.append((dp, dschema))
    specs = [dict(probe_col=1, table=dims[0][0], key_col=0, value_col=1,
                  how="inner"),
             dict(probe_col=1, table=dims[1][0], key_col=0, value_col=1,
                  how="left")]
    exprs = [("bin", "+", ("col", 0), ("lit", 1))]
    got = Query(path, SCHEMA).star_join(
        [dict(s, schema=HeapSchema(**dims[i][1]))
         for i, s in enumerate(specs)], exprs=exprs).run(device="cpu")
    with jax.enable_x64(True):
        want = JQuery(path, JS).star_join(
            [dict(s, schema=JSchema(**dims[i][1]))
             for i, s in enumerate(specs)], exprs=exprs).run()
    for k in ("count", "pay_sums", "null_counts", "esums", "nncounts"):
        g = np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for c in (0, 1, 2):
        assert np.asarray(got["sums"][c]).dtype == \
            np.asarray(want["sums"][c]).dtype
        assert int(got["sums"][c]) == int(want["sums"][c])


def _packed(tmp_path):
    n = 40_000
    rng = np.random.default_rng(21)
    cols = [(2_000_000_000 + rng.integers(0, 16, n)).astype(np.int32),
            (np.arange(n) // 700).astype(np.int32),
            (3_500_000_000 + np.arange(n) // 900).astype(np.uint32),
            rng.standard_normal(n).astype(np.float32)]
    path = str(tmp_path / "p.heap")
    build_heap_file(path, cols, HeapSchema(**KW))
    build_packed(path, HeapSchema(**KW))
    return path, cols


@pytest.mark.parametrize("leg", ["chip", "host"])
def test_packed_legs_widen_under_x64(x64, tmp_path, leg):
    """The pushdown legs (the chip leg's plain version on the CPU, and
    the host leg) sum in 64 bits as the heap scan does, equal to the
    reference's packed legs under jax_enable_x64."""
    path, cols = _packed(tmp_path)
    assert probe_packed(path) is not None
    for cfg in (config, jconfig):
        if leg == "chip":
            cfg.set("pushdown", "on")
        else:
            cfg.set("pushdown", "auto")
            cfg.set("pushdown_h2d_gbps", 40.0)
            cfg.set("pushdown_ssd_gbps", 4.0)
    q = Query(path, SCHEMA).where(FilterPred(((1, "gt", 3),))) \
        .aggregate([0, 2, 3])
    assert q.explain(device="cpu").pushdown == leg
    got = q.run(device="cpu")
    with jax.enable_x64(True):
        want = JQuery(path, JS).where(lambda c: c[1] > 3) \
            .aggregate([0, 2, 3]).run()
    sel = cols[1] > 3
    assert int(got["count"]) == int(want["count"]) == int(sel.sum())
    assert np.asarray(got["count"]).dtype == np.int64
    for j, c in enumerate((0, 2)):
        assert np.asarray(got["sums"][j]).dtype == \
            np.asarray(want["sums"][j]).dtype
        assert int(got["sums"][j]) == int(want["sums"][j]) \
            == int(_truth(cols[c], sel))


@pytest.mark.parametrize("switch", [False, True], ids=["x64-off", "x64-on"])
def test_wide_schema_sums_in_64_bits_whatever_the_switch(configs, tmp_path,
                                                         switch):
    """The decision for a schema with an 8-byte column: its 4-byte integer
    sums and its counts are 64-bit whatever config ``x64`` says, because
    the reference serves such a table only under jax_enable_x64; the
    port's answer is that one (aggregate and GROUP BY)."""
    kw = dict(n_cols=4, visibility=False,
              dtypes=("int32", "uint32", "int64", "float32"))
    n = JSchema(**kw).tuples_per_page * 9 + 5
    base = _columns(n, seed=7)
    cols = [base[0], base[2],
            np.arange(n, dtype=np.int64) << 33, base[3]]
    path = str(tmp_path / "w.heap")
    build_heap_file(path, cols, JSchema(**kw))
    schema = HeapSchema(**kw)
    config.set("x64", switch)
    assert wide_sums(schema)
    got = Query(path, schema).aggregate().run(device="cpu")
    with jax.enable_x64(True):
        want = JQuery(path, JSchema(**kw)).aggregate().run()
        wgrp = JQuery(path, JSchema(**kw)).group_by(
            lambda c: c[0] % 3, 3, agg_cols=[1]).run()
    allrows = np.ones(n, bool)
    assert np.asarray(got["count"]).dtype == np.asarray(want["count"]).dtype
    for c in range(3):
        g, w = np.asarray(got["sums"][c]), np.asarray(want["sums"][c])
        assert g.dtype == w.dtype, c
        assert int(g) == int(w) == int(_truth(cols[c], allrows)
                                       if c < 2 else cols[2].sum())
    grp = Query(path, schema).group_by(GroupKey(0, 3), 3, agg_cols=[1]) \
        .run(device="cpu")
    for k in ("count", "sums"):
        assert np.asarray(grp[k]).dtype == np.asarray(wgrp[k]).dtype, k
        np.testing.assert_array_equal(grp[k], wgrp[k], err_msg=k)


@pytest.mark.parametrize("x64_on", [True, False], ids=["x64", "32-bit"])
def test_uint32_literal_above_2_31(configs, table, x64_on):
    """A uint32 column against 3e9: ``where_range`` (a numpy bound) under
    both switches, a SQL leaf and a FilterPred term with a Python int
    under x64 only — without it both packages refuse (OverflowError in
    the reference, EINVAL in the port)."""
    path, cols, sel = table
    config.set("x64", x64_on)
    v = 3_000_000_000
    truth = int((sel & (cols[2] >= v)).sum())
    got = Query(path, SCHEMA).where_range(2, v, None).aggregate([2]) \
        .run(device="cpu")
    with jax.enable_x64(x64_on):
        want = JQuery(path, JS).where_range(2, v, None).aggregate([2]) \
            .run()
    assert int(got["count"]) == int(want["count"]) == truth
    assert int(got["sums"][0]) == int(want["sums"][0])
    stmt = f"SELECT COUNT(*) FROM t WHERE c2 >= {v}"
    q = Query(path, SCHEMA).where(FilterPred(((2, "ge", v),))).aggregate()
    if not x64_on:
        with pytest.raises(StromError) as ei:
            q.run(device="cpu")
        assert ei.value.errno == errno.EINVAL
        with pytest.raises(StromError):
            tsql.sql_query(stmt, path, SCHEMA, device="cpu")
        with pytest.raises(OverflowError):
            jsql.sql_query(stmt, path, JS)
        return
    assert int(q.run(device="cpu")["count"]) == truth
    got = tsql.sql_query(stmt, path, SCHEMA, device="cpu")
    with jax.enable_x64(True):
        want = jsql.sql_query(stmt, path, JS)
    assert_same_result(got, want, what=stmt)
    assert int(got["count(*)"]) == truth


def test_literal_ranges_under_x64(x64, table):
    """Under x64: a uint32 column takes any int in [-2^31, 2^32) (a
    negative wraps), a float32 column any int, an int32 column its own
    range.  Outside the column's range the port refuses; the reference
    wraps the literal into the column's type (``int32_col > 2**31`` is
    True on every row, ``uint32_col > 2**32`` too) and answers for the
    wrapped value, the recorded divergence."""
    path, cols, sel = table
    u32, i32, f32 = (np.dtype(np.uint32), np.dtype(np.int32),
                     np.dtype(np.float32))
    assert term_value(u32, (1 << 32) - 1) == ("u", np.uint32(0xFFFFFFFF))
    assert term_value(u32, -1) == ("u", np.uint32(0xFFFFFFFF))
    assert term_value(f32, 1 << 40) == ("f", np.float32(1 << 40))
    for dt, v in ((i32, 1 << 31), (i32, -(1 << 31) - 1), (u32, 1 << 32),
                  (u32, -(1 << 31) - 1), (f32, 10 ** 400)):
        with pytest.raises(StromError) as ei:
            term_value(dt, v)
        assert ei.value.errno == errno.EINVAL, (dt, v)
    config.set("x64", False)
    for dt, v in ((u32, 1 << 31), (f32, 1 << 40)):
        with pytest.raises(StromError):
            term_value(dt, v)
    config.set("x64", True)
    # the reference's wrapped rows (the divergence's evidence)
    with jax.enable_x64(True):
        n_i32 = int(JQuery(path, JS).where(lambda c: c[0] > 2 ** 31)
                    .aggregate([0]).run()["count"])
        n_u32 = int(JQuery(path, JS).where(lambda c: c[2] > 2 ** 32)
                    .aggregate([0]).run()["count"])
        n_f32 = int(JQuery(path, JS).where(lambda c: c[3] < 2 ** 40)
                    .aggregate([0]).run()["count"])
    assert n_i32 == n_u32 == int(sel.sum())
    for term in ((0, "gt", 1 << 31), (2, "gt", 1 << 32)):
        with pytest.raises(StromError) as ei:
            Query(path, SCHEMA).where(FilterPred((term,))).aggregate() \
                .run(device="cpu")
        assert ei.value.errno == errno.EINVAL
    got = Query(path, SCHEMA).where(FilterPred(((3, "lt", 1 << 40),))) \
        .aggregate([0]).run(device="cpu")
    assert int(got["count"]) == n_f32 == int(sel.sum())


def test_kernels_refuse_integer_schemas_under_x64(configs, table, tmp_path):
    """B1 and B2 refuse a layout with a 4-byte integer column under x64,
    naming it, so the plan names ``torch`` (planned for a CUDA device
    without one); a float-only schema stays on them.  Without x64 nothing
    changes."""
    path = table[0]
    fschema = HeapSchema(n_cols=2, visibility=False,
                         dtypes=("float32", "float32"))
    pred = FilterPred(((0, "gt", 5),))
    ppath, _cols = _packed(tmp_path)
    meta = probe_packed(ppath)
    assert filter_cuda.kernel_refusal(SCHEMA, pred) == ""
    assert decode_cuda.kernel_refusal(meta, pred) == ""
    plan = Query(path, SCHEMA).where(pred).aggregate() \
        ._plan(CUDA, "auto", None, 0)
    assert plan.kernel == "cuda"
    config.set("x64", True)
    why = filter_cuda.kernel_refusal(SCHEMA, pred)
    assert why.startswith("x64") and "int32" in why
    assert decode_cuda.kernel_refusal(meta, pred).startswith("x64")
    assert filter_cuda.kernel_refusal(fschema, pred) == ""
    q = Query(path, SCHEMA).where(pred).aggregate()
    plan = q._plan(CUDA, "auto", None, 0)
    assert plan.kernel == "torch" and "x64" in plan.reason
    assert "x64" in q._cuda_refusal()
    with pytest.raises(StromError) as ei:
        q.run(device="cpu", kernel="cuda")
    assert ei.value.errno == errno.EINVAL


def test_float_only_schema_counts_widen_under_x64(x64, tmp_path):
    """A float-only table under x64: the count is int64 (the kernel's
    route widens it after the launch), the float sums stay float32, as
    the reference's."""
    kw = dict(n_cols=2, visibility=False, dtypes=("float32", "float32"))
    n = JSchema(**kw).tuples_per_page * 4 + 1
    rng = np.random.default_rng(2)
    cols = [rng.standard_normal(n).astype(np.float32) for _ in range(2)]
    path = str(tmp_path / "f.heap")
    build_heap_file(path, cols, JSchema(**kw))
    got = Query(path, HeapSchema(**kw)).aggregate().run(device="cpu")
    with jax.enable_x64(True):
        want = JQuery(path, JSchema(**kw)).aggregate().run()
    assert np.asarray(got["count"]).dtype == np.asarray(want["count"]).dtype \
        == np.int64
    assert [np.asarray(s).dtype for s in got["sums"]] == \
        [np.asarray(s).dtype for s in want["sums"]] == [np.float32] * 2
    assert int(got["count"]) == n
    pages = torch.from_numpy(np.fromfile(path, np.uint8).reshape(-1, 8192))
    out = filter_cuda.filter_pages_cuda(pages, 0, HeapSchema(**kw),
                                        FilterPred(()))
    assert out["count"].dtype == torch.int64 and int(out["count"]) == n


def test_the_width_is_read_where_the_step_is_built(configs, table,
                                                  tmp_path):
    """B1's and B2's wrappers and refusals take the accumulators' width
    their step's builder read: a step built with ``x64`` off keeps 32-bit
    sums after the switch turns on, and one built with it on keeps 64-bit
    ones after it turns off."""
    path, cols, sel = table
    pages = torch.from_numpy(np.fromfile(path, np.uint8).reshape(-1, 8192))
    pred = FilterPred(())
    narrow = filter_cuda.make_filter_fn_cuda(SCHEMA, pred)
    config.set("x64", True)
    wide = filter_cuda.make_filter_fn_cuda(SCHEMA, pred)
    got32 = narrow(pages)
    config.set("x64", False)
    got64 = wide(pages)
    assert got32["count"].dtype == torch.int32
    assert got64["count"].dtype == torch.int64
    assert int(got32["count"]) == int(got64["count"]) == int(sel.sum())
    assert got32["sums"][0].dtype == torch.int32
    assert int(got32["sums"][0]) == \
        (int(_truth(cols[0], sel)) + (1 << 31)) % (1 << 32) - (1 << 31)
    assert int(got64["sums"][0]) == int(_truth(cols[0], sel))
    ppath, _pcols = _packed(tmp_path)
    meta = probe_packed(ppath)
    assert filter_cuda.kernel_refusal(SCHEMA, pred, True).startswith("x64")
    assert filter_cuda.kernel_refusal(SCHEMA, pred, False) == ""
    assert decode_cuda.kernel_refusal(meta, pred, True).startswith("x64")
    ppages = torch.from_numpy(np.fromfile(meta.path, np.uint8)
                              .reshape(-1, 8192))
    out = decode_cuda.decode_filter_pages_cuda(ppages, 0, meta, pred,
                                               wide=True)
    assert out["count"].dtype == torch.int64


def test_workers_fold_in_64_bits(x64, table):
    """Worker processes carry the switch and their partials fold in 64
    bits: the same sums as one process."""
    path, cols, sel = table
    one = Query(path, SCHEMA).aggregate([0, 2]).run(device="cpu")
    two = Query(path, SCHEMA).aggregate([0, 2]).run(device="cpu", workers=2)
    assert [np.asarray(s).dtype for s in two["sums"]] == \
        [np.dtype(np.int64), np.dtype(np.uint64)]
    assert [int(s) for s in two["sums"]] == [int(s) for s in one["sums"]] \
        == [int(_truth(cols[0], sel)), int(_truth(cols[2], sel))]
    assert int(two["count"]) == int(one["count"]) == int(sel.sum())


@pytest.mark.parametrize("a,b,same", [
    (math.inf, math.inf, True), (-math.inf, -math.inf, True),
    (math.inf, -math.inf, False), (math.inf, 1e30, False),
    (-math.inf, 0.0, False), (1e30, math.inf, False),
    (math.nan, math.nan, True), (math.nan, math.inf, False),
    (1.0, 1.0 + 1e-9, True)])
def test_close_on_infinities(a, b, same):
    """The SQL result comparer: equal infinities compare equal, opposite
    ones and an infinity against a finite value do not (whatever the
    scale); NaN as before."""
    assert _close(a, b, None) is same
    assert _close(a, b, 1e40) is same
    assert_same_result({"x": np.float32(a)}, {"x": np.float32(a)})
