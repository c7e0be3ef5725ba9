"""The port's partitioned join over the mesh (``parallel/pjoin.py`` and
``Query``'s mesh partitioned join, both faces, every ``how``) against the
JAX package's on the conftest's virtual CPU devices, on the same heap
bytes.  Mirrors ``tests/test_query.py:980`` (parity), ``:1062`` (faults),
``:1161`` (the streamed build) and ``tests/test_join_faces.py:137``.  The
port's members are N × ``"cpu"``.

Tolerances: counts, integer sums, keys, payloads and positions exact, and
the row face in the reference's order (owner, then sender, then arrival);
float32 sums within ``1e-5 * sum(|x|) + 1e-6``."""

import errno
import os

import jax
import numpy as np
import pytest
import torch

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.parallel import pjoin as jpjoin
from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jax_mesh
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.parallel import pjoin
from nvme_strom_tpu_torch.parallel.mesh import make_scan_mesh
from nvme_strom_tpu_torch.scan.heap import PAGE_SIZE, HeapSchema, \
    build_heap_file
from nvme_strom_tpu_torch.scan.query import Query
from nvme_strom_tpu_torch.testing.fake import FakeNvmeSource, FaultPlan

HOWS = ("inner", "left", "semi", "anti")
KW = dict(n_cols=3, visibility=True, dtypes=("int32", "float32", "uint32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)


@pytest.fixture(autouse=True)
def configs():
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    for c in (config, jconfig):
        c.set("chunk_size", 1 << 16)
        c.set("debug_no_threshold", True)
    config.set("cache_arbitration", False)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


@pytest.fixture()
def fact(tmp_path):
    rng = np.random.default_rng(3)
    n = SCHEMA.tuples_per_page * 21            # a tail past whole batches
    c0 = rng.integers(-300, 300, n).astype(np.int32)
    c1 = rng.standard_normal(n).astype(np.float32)
    c2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    vis = (rng.random(n) > 0.2).astype(np.int32)
    path = str(tmp_path / "f.heap")
    build_heap_file(path, [c0, c1, c2], SCHEMA, visibility=vis)
    keys = rng.permutation(np.arange(-400, 400, dtype=np.int32))[:500]
    return path, keys, c0, vis != 0


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _same(got, want, approx=False):
    g, w = _np(got), np.asarray(want)
    if approx and w.dtype.kind == "f":
        assert np.all(np.abs(g.astype(np.float64) - w.astype(np.float64))
                      <= 1e-5 * np.abs(w.astype(np.float64)) + 1e-6)
        return
    if g.dtype.kind in "iu" and w.dtype.kind in "iu" and \
            g.dtype.itemsize != w.dtype.itemsize:
        g, w = g.astype(np.int64), w.astype(np.int64)      # positions
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _pages(path):
    return np.fromfile(path, np.uint8).reshape(-1, PAGE_SIZE)


@pytest.mark.parametrize("vdt", [np.int32, np.uint32, np.float32])
def test_partition_build_is_the_references(fact, vdt):
    path, keys, *_ = fact
    vals = (keys.astype(np.int64) * 3).astype(vdt)
    for n in (1, 2, 4):
        got = pjoin.partition_build_sharded(
            keys, vals, make_scan_mesh(["cpu"] * n), SCHEMA, 0)
        want = jpjoin.partition_build_sharded(
            keys, vals, jax_mesh(jax.devices()[:n]), JS, 0)
        for g, w in zip(got.host_arrays(), want):
            _same(g, w)
    with pytest.raises(ValueError):
        pjoin.partition_build_sharded(np.array([1, 1], np.int32),
                                      np.array([2, 3], np.int32),
                                      make_scan_mesh(["cpu"] * 2), SCHEMA, 0)


@pytest.mark.parametrize("how", HOWS)
def test_steps_are_the_references(fact, how):
    """Both steps on one page batch: the aggregate face's folds and the
    row face's per-routed-row outcomes, bit for bit."""
    path, keys, *_ = fact
    vals = keys * 3
    pages = _pages(path)[:16]
    mesh, jm = make_scan_mesh(["cpu"] * 4), jax_mesh(jax.devices()[:4])
    step = pjoin.make_partitioned_join_step(
        mesh, SCHEMA, 0, keys, vals, predicate=FilterPred(((0, "gt", -200),)),
        how=how)
    jstep = jpjoin.make_partitioned_join_step(
        jm, JS, 0, keys, vals, predicate=lambda c: c[0] > -200, how=how)
    got, want = step(pages), jax.tree.map(np.asarray, jstep(pages))
    assert set(got) == set(want)
    for k in want:
        if k == "sums":
            for g, w in zip(got[k], want[k]):
                _same(g, w, approx=True)
        else:
            _same(got[k], want[k])
    rows = pjoin.make_partitioned_join_rows_step(mesh, SCHEMA, 0, keys, vals,
                                                 how=how)
    jrows = jpjoin.make_partitioned_join_rows_step(jm, JS, 0, keys, vals,
                                                   how=how)
    got, want = rows(pages), jax.tree.map(np.asarray, jrows(pages))
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])


def test_combine_pos_words_is_the_references():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 1 << 40, 100)
    lo = (pos & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (pos >> 32).astype(np.int32)
    np.testing.assert_array_equal(pjoin.combine_pos_words(lo, hi), pos)
    np.testing.assert_array_equal(pjoin.combine_pos_words(lo, hi),
                                  jpjoin.combine_pos_words(lo, hi))


def _q(pkg, path, keys, **kw):
    Q, S = (Query, SCHEMA) if pkg == "port" else (JQuery, JS)
    return Q(path, S).join(0, keys, keys * 3, **kw)


@pytest.mark.parametrize("how", HOWS)
def test_mesh_partitioned_join_is_the_references(fact, how):
    """tests/test_query.py:980 and tests/test_join_faces.py:137: above
    ``join_broadcast_max`` the mesh join's plan names the all_to_all
    exchange, and both faces equal the JAX mesh run's (the row face in its
    order, and with limit/offset) and the broadcast answer."""
    path, keys, c0, vis = fact
    base = _q("port", path, keys, how=how).run(device="cpu")
    base_m = _q("port", path, keys, how=how, materialize=True).run(
        device="cpu")
    for c in (config, jconfig):
        c.set("join_broadcast_max", 1024)
    mesh, jm = make_scan_mesh(["cpu"] * 4), jax_mesh(jax.devices()[:4])
    plan = _q("port", path, keys, how=how).explain(mesh=mesh)
    assert plan.join_strategy.startswith("partitioned(")
    assert "all_to_all" in plan.reason and plan.kernel == "torch"
    for bp in (8, None):
        agg = _q("port", path, keys, how=how).run(mesh=mesh, batch_pages=bp)
        jagg = _q("jax", path, keys, how=how).run(mesh=jm, batch_pages=bp)
        assert set(agg) == set(jagg)
        for k in jagg:
            if k == "sums":
                for g, w, b in zip(agg[k], jagg[k], base[k]):
                    _same(g, w, approx=True)
                    _same(g, b, approx=True)
            else:
                _same(agg[k], jagg[k])
                _same(agg[k], base[k])
        for lim, off in ((None, 0), (7, 2), (0, 0)):
            rows = _q("port", path, keys, how=how, materialize=True,
                      limit=lim, offset=off).run(mesh=mesh, batch_pages=bp)
            jrows = _q("jax", path, keys, how=how, materialize=True,
                       limit=lim, offset=off).run(mesh=jm, batch_pages=bp)
            assert set(rows) == set(jrows)
            for k in jrows:
                _same(rows[k], jrows[k])
    full = _q("port", path, keys, how=how, materialize=True).run(
        mesh=mesh, batch_pages=8)
    np.testing.assert_array_equal(np.sort(full["positions"]),
                                  np.sort(base_m["positions"]))


@pytest.mark.parametrize("sp", [2])
def test_mesh_partitioned_join_on_an_sp_mesh(fact, sp):
    """An ``(sp, dp)`` mesh joins over its dp axis: the same answer as the
    JAX package's ``(sp, dp)`` mesh."""
    path, keys, *_ = fact
    for c in (config, jconfig):
        c.set("join_broadcast_max", 1024)
    mesh = make_scan_mesh(["cpu"] * 4, sp=sp)
    jm = jax_mesh(jax.devices()[:4], sp=sp)
    got = _q("port", path, keys, materialize=True).run(mesh=mesh,
                                                       batch_pages=8)
    want = _q("jax", path, keys, materialize=True).run(mesh=jm,
                                                       batch_pages=8)
    for k in want:
        _same(got[k], want[k])


def test_streamed_build_is_bounded_and_bit_identical(tmp_path):
    """tests/test_query.py:1161, bounded by the build's own accounting
    (not a tracemalloc peak): above the budget the host holds one
    partition at a time (``host_rows_peak`` at most ``cap``, against the
    in-memory build's ``dp × cap``), the partitions equal the in-memory
    and the JAX builds, the fast path too, and the step consumes them."""
    bschema = HeapSchema(n_cols=2, visibility=False)
    jbs = JSchema(n_cols=2, visibility=False)
    t = bschema.tuples_per_page
    n = t * 64
    rng = np.random.default_rng(23)
    keys = rng.permutation(n).astype(np.int32)
    vals = (keys * 3).astype(np.int32)
    bpath = str(tmp_path / "build.heap")
    build_heap_file(bpath, [keys, vals], bschema)
    mesh = make_scan_mesh(["cpu"] * 4)
    ref = pjoin.partition_build_sharded(keys, vals, mesh, bschema, 0)
    cap = len(ref.keys[0])
    assert ref.host_rows_peak == 4 * cap
    parts = pjoin.partition_build_sharded_from_table(
        bpath, bschema, 0, 1, mesh, device="cpu", budget=1 << 12)
    assert 0 < parts.host_rows_peak <= cap < 4 * cap
    jref = jpjoin.partition_build_sharded_from_table(
        bpath, jbs, 0, 1, jax_mesh(jax.devices()[:4]), budget=1 << 12)
    for got, want, jw in zip(parts.host_arrays(), ref.host_arrays(), jref):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jw))
    fast = pjoin.partition_build_sharded_from_table(
        bpath, bschema, 0, 1, mesh, device="cpu",
        budget=os.path.getsize(bpath) + 1)
    for got, want in zip(fast.host_arrays(), ref.host_arrays()):
        np.testing.assert_array_equal(got, want)
    fpath = str(tmp_path / "fact.heap")
    fkeys = rng.integers(0, n, t * 16).astype(np.int32)
    build_heap_file(fpath, [fkeys, np.ones(t * 16, np.int32)], bschema)
    step = pjoin.make_partitioned_join_step(mesh, bschema, 0,
                                            build_parts=parts)
    assert int(step(_pages(fpath))["matched"]) == t * 16


def test_mesh_join_table_streams_the_build(fact, tmp_path):
    """``join_table`` above both caps: the mesh join streams its build
    from disk in partition passes and answers as the in-memory build."""
    path, keys, *_ = fact
    bschema = HeapSchema(n_cols=2, visibility=False)
    bpath = str(tmp_path / "dim.heap")
    build_heap_file(bpath, [keys, keys * 3], bschema)
    config.set("join_broadcast_max", 1024)
    config.set("join_build_host_max", 4096)     # the table: 8 KiB
    mesh = make_scan_mesh(["cpu"] * 4)
    plan = Query(path, SCHEMA).join_table(0, bpath, bschema, 0, 1) \
        .explain(mesh=mesh)
    assert "STREAMED" in plan.reason
    for mat in (False, True):
        got = Query(path, SCHEMA).join_table(0, bpath, bschema, 0, 1,
                                             materialize=mat) \
            .run(mesh=mesh, batch_pages=8)
        want = _q("port", path, keys, materialize=mat).run(mesh=mesh,
                                                           batch_pages=8)
        for k in want:
            if k == "sums":
                for g, w in zip(got[k], want[k]):
                    _same(g, w, approx=True)
            else:
                _same(got[k], want[k])


def test_partitioned_join_surfaces_injected_faults(tmp_path):
    """tests/test_query.py:1062: a read fault under the mesh exchange
    surfaces as StromError, and the process keeps working."""
    schema = HeapSchema(n_cols=2, visibility=True)
    rng = np.random.default_rng(3)
    n = schema.tuples_per_page * 32
    c0 = rng.integers(-100, 100, n).astype(np.int32)
    path = str(tmp_path / "pj.heap")
    build_heap_file(path, [c0, rng.integers(0, 50, n).astype(np.int32)],
                    schema)
    keys = np.arange(-100, 100, dtype=np.int32)
    config.set("join_broadcast_max", 1024)
    mesh = make_scan_mesh(["cpu"] * 4)
    src = FakeNvmeSource(path, force_cached_fraction=0.0,
                         fault_plan=FaultPlan(fail_offsets={4 * PAGE_SIZE}))
    try:
        with pytest.raises(StromError):
            Query(src, schema).join(0, keys, keys * 2).run(mesh=mesh,
                                                           batch_pages=8)
    finally:
        src.close()
    out = Query(path, schema).join(0, keys, keys * 2).run(mesh=mesh,
                                                          batch_pages=8)
    assert int(out["matched"]) == int(np.isin(c0, keys).sum())


def test_eight_byte_columns_refused():
    schema = HeapSchema(n_cols=2, visibility=False,
                        dtypes=("int32", "int64"))
    with pytest.raises(StromError) as e:
        pjoin.make_partitioned_join_step(make_scan_mesh(["cpu"] * 2), schema,
                                         0, np.arange(4, dtype=np.int32),
                                         np.arange(4, dtype=np.int32))
    assert e.value.errno == errno.EINVAL
