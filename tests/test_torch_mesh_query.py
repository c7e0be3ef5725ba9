"""The port's mesh scan face (``Query.run(mesh=, batch_pages=)`` and
``explain(mesh=)`` over ``parallel/stream.py``'s
``distributed_scan_filter``) and ``run(analyze=True)``, against the JAX
package's one-device ``Query.run()`` and the port's local run on the same
heap bytes.  Each test mirrors one of ``tests/test_query.py`` (mesh cases,
:411) or ``tests/test_scan_engine.py`` (:567).  The ring is
``make_scan_mesh(["cpu"] * 4)`` (the port's ``torch`` route on each
member), the JAX side on its CPU backend, both at 64 KiB chunks.

Tolerances: counts, integer sums (int32 wraps mod 2^32), mins, maxs, keys,
values and positions exact (positions compared as int64); float32 sums
within ``1e-5 * sum(|x|) + 1e-6``, sums of squares within ``1e-5 *
sum(x^2) + 1e-6``."""

import errno
import os

import numpy as np
import pytest

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.engine import Session
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.groupby import GroupKey
from nvme_strom_tpu_torch.parallel.mesh import make_scan_mesh
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.index import build_index
from nvme_strom_tpu_torch.scan.query import Query

CPU = "cpu"
KW = dict(n_cols=3, visibility=True, dtypes=("int32", "int32", "float32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)
N_PAGES = 24
ANALYZE_KEYS = {"elapsed_s", "bytes_direct", "requests", "avg_dma_bytes",
                "waits", "submit_syscalls", "kernel_dispatches",
                "h2d_depth_reached", "scan_GBps"}


@pytest.fixture(autouse=True)
def configs():
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


@pytest.fixture()
def heap(tmp_path):
    """tests/test_query.py's heap: 24 pages (three 64 KiB chunks), c0 in
    [-1000, 1000), c1 in [0, 16), a fifth of the rows invisible; plus a
    float32 column with ties."""
    rng = np.random.default_rng(5)
    n = SCHEMA.tuples_per_page * N_PAGES
    c0 = rng.integers(-1000, 1000, n).astype(np.int32)
    c1 = rng.integers(0, 16, n).astype(np.int32)
    c2 = rng.integers(-20, 20, n).astype(np.float32) / 4
    vis = (rng.random(n) > 0.2).astype(np.int32)
    path = str(tmp_path / "t.heap")
    build_heap_file(path, [c0, c1, c2], SCHEMA, visibility=vis)
    return path, c0, c1, c2, vis != 0


def _mesh():
    return make_scan_mesh([CPU] * 4)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iu" and b.dtype.kind in "iu" and \
            {a.dtype.itemsize, b.dtype.itemsize} == {4, 8}:
        a, b = a.astype(np.int64), b.astype(np.int64)   # positions
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same(got, want, approx=()):
    assert set(want) <= set(got), (sorted(got), sorted(want))
    for k, w in want.items():
        gs, ws = (got[k], w) if isinstance(w, list) else ([got[k]], [w])
        for g1, w1 in zip(gs, ws):
            if k in approx:
                g1, w1 = np.asarray(g1, np.float64), np.asarray(w1,
                                                                 np.float64)
                assert np.all(np.abs(g1 - w1) <= 1e-5 * np.abs(w1) + 1e-6), k
            else:
                _eq(g1, w1)


# -- the scan terminals over the ring -----------------------------------------

_CASES = {
    "aggregate where": (
        lambda q: q.where(FilterPred(((0, "gt", 0),))).aggregate([0, 1]),
        lambda q: q.where(lambda c: c[0] > 0).aggregate([0, 1])),
    "aggregate float": (lambda q: q.aggregate([2]),
                        lambda q: q.aggregate([2])),
    "group_by GroupKey": (
        lambda q: q.group_by(GroupKey(1, 8), 8, agg_cols=[0]),
        lambda q: q.group_by(lambda c: c[1] % 8, 8, agg_cols=[0])),
    "group_by callable key": (
        lambda q: q.group_by(lambda c: c[1] % 8, 8, agg_cols=[0]),
        lambda q: q.group_by(lambda c: c[1] % 8, 8, agg_cols=[0])),
    "group_by_cols": (lambda q: q.group_by_cols(1, agg_cols=[0]),
                      lambda q: q.group_by_cols(1, agg_cols=[0])),
    "top_k ties": (lambda q: q.top_k(2, 300), lambda q: q.top_k(2, 300)),
    "top_k smallest where": (
        lambda q: q.where(FilterPred(((1, "lt", 3),))).top_k(
            0, 25, largest=False),
        lambda q: q.where(lambda c: c[1] < 3).top_k(0, 25, largest=False)),
    "select": (lambda q: q.where(FilterPred(((1, "eq", 5),))).select(),
               lambda q: q.where(lambda c: c[1] == 5).select()),
    "select limit offset": (
        lambda q: q.select([0, 2], limit=40, offset=1000),
        lambda q: q.select([0, 2], limit=40, offset=1000)),
    "expressions": (
        lambda q: q.aggregate_exprs([("bin", "*", ("col", 1), ("lit", 3))]),
        lambda q: q.aggregate_exprs([("bin", "*", ("col", 1),
                                      ("lit", 3))])),
    "join aggregate": (
        lambda q: q.join(1, np.arange(0, 16, 2, dtype=np.int32),
                         np.arange(8, dtype=np.int32) * 7),
        lambda q: q.join(1, np.arange(0, 16, 2, dtype=np.int32),
                         np.arange(8, dtype=np.int32) * 7)),
}


@pytest.mark.parametrize("batch_pages", [8, 12, 7, None],
                         ids=["whole batches", "a tail", "odd, rounded",
                              "default, larger than the table"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_mesh_matches_local_and_jax(heap, case, batch_pages):
    """Every scan terminal over a 4-member ring equals the local run and
    the JAX package's, whole batches, a tail scanned on the first member,
    a batch_pages rounded down to the ring, and one larger than the table
    (all tail); group_by's per-group mins are the min of batch mins."""
    path, *_cols = heap
    make, jmake = _CASES[case]
    mesh = _mesh()
    q = make(Query(path, SCHEMA))
    plan = q.explain(mesh=mesh)
    assert plan.mode == "mesh" and plan.kernel == "torch"
    assert plan.access_path == "direct" and "mesh of 4 members" in \
        plan.reason
    got = q.run(mesh=mesh, batch_pages=batch_pages)
    local = make(Query(path, SCHEMA)).run(device=CPU)
    want = jmake(JQuery(path, JS)).run()
    approx = ("sumsqs", "vars", "stds") + \
        (("sums",) if case == "aggregate float" else ())
    _same(got, local, approx)
    _same(got, want, approx)


def test_mesh_tail_reads_every_page(heap):
    """24 pages at batch_pages 16: one batch of 16, an 8-page tail."""
    path, c0, c1, c2, vis = heap
    out = Query(path, SCHEMA).run(mesh=_mesh(), batch_pages=16)
    assert int(out["count"]) == int(vis.sum())
    assert int(out["sums"][0]) == int(c0[vis].sum())


def test_mesh_explain_also_reports_invalid(tmp_path):
    """The 'invalid' plan holds under a mesh too, and run() refuses with
    the same reason."""
    rng = np.random.default_rng(7)
    kw = dict(n_cols=2, dtypes=("int32", "float32"))
    schema = HeapSchema(**kw)
    n = schema.tuples_per_page * 2
    path = str(tmp_path / "mix.heap")
    build_heap_file(path, [rng.integers(0, 9, n).astype(np.int32),
                           rng.random(n).astype(np.float32)], schema)
    q = Query(path, schema).group_by(GroupKey(0), 4)   # mixed agg dtypes
    plan = q.explain(mesh=_mesh())
    assert plan.kernel == "invalid" and plan.mode == "mesh"
    assert "share one dtype" in plan.reason
    with pytest.raises(StromError, match="not executable") as ei:
        q.run(mesh=_mesh())
    assert ei.value.errno == errno.EINVAL


_A62 = {
    "order_by": lambda q: q.order_by(0),
    "quantiles": lambda q: q.quantiles(0, [0.5]),
    "count_distinct": lambda q: q.count_distinct(1),
    "partitioned join": lambda q: q.join(1, np.arange(600, dtype=np.int32),
                                         np.arange(600, dtype=np.int32)),
}


@pytest.mark.parametrize("face", sorted(_A62))
def test_mesh_faces_waiting_for_a6_2_refused(heap, face):
    """The faces that waited for ROADMAP A6.2 (refused until it) run over
    the mesh now: the mesh sort terminals and the mesh partitioned join
    plan the torch route in mesh mode and answer as the JAX package's mesh
    run (``tests/test_query.py:327``, ``:440``, ``:837``, ``:980``) and
    the port's local run."""
    import jax

    from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jmesh
    path, *_cols = heap
    config.set("join_broadcast_max", 1 << 12)     # 4,800 bytes: 2 parts
    jconfig.set("join_broadcast_max", 1 << 12)
    q = _A62[face](Query(path, SCHEMA))
    plan = q.explain(mesh=_mesh())
    assert plan.kernel == "torch" and plan.mode == "mesh", plan.reason
    got = q.run(mesh=_mesh())
    want = {k: v for k, v in _A62[face](JQuery(path, JS)).run(
        mesh=jmesh(jax.devices()[:4])).items()}
    _same(got, want, approx={"sums"} if face == "partitioned join" else ())
    local = _A62[face](Query(path, SCHEMA)).run(device=CPU)
    _same(got, {k: v for k, v in local.items() if k != "positions"},
          approx={"sums"})
    if "positions" in local:
        _eq(got["positions"], local["positions"])


def test_mesh_plans_skip_index_and_take_a_session(heap):
    """Under a mesh the plan scans even with a fresh sidecar (the
    reference's index paths are local), and ``session=`` reads through
    the caller's session."""
    path, c0, c1, c2, vis = heap
    build_index(path, SCHEMA, 1, device=CPU)
    q = Query(path, SCHEMA).where_eq(1, 5).aggregate([0])
    assert q.explain(device=CPU).access_path == "index"
    assert q.explain(mesh=_mesh()).access_path == "direct"
    with Session() as sess:
        out = q.run(mesh=_mesh(), session=sess, analyze=True)
        local = Query(path, SCHEMA).where_eq(1, 5).aggregate([0]).run(
            device=CPU, session=sess)
    m = vis & (c1 == 5)
    assert int(out["count"]) == int(local["count"]) == int(m.sum())
    assert int(out["sums"][0]) == int(c0[m].sum())
    assert out["_analyze"]["bytes_direct"] == os.path.getsize(path)


# -- run(analyze=True) --------------------------------------------------------

def _cold(path):
    fd = os.open(path, os.O_RDONLY)
    os.fsync(fd)
    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    os.close(fd)


@pytest.mark.parametrize("where", ["local", "mesh", "session"])
def test_run_analyze_reports_io_breakdown(heap, where):
    """tests/test_query.py:411: ``analyze=True`` attaches the run's wall
    time and engine counters; a full scan of a table of whole chunks reads
    every byte direct, one wait a chunk; the result is unchanged."""
    path, c0, c1, c2, vis = heap
    _cold(path)
    q = Query(path, SCHEMA).where(FilterPred(((0, "gt", 0),)))
    if where == "session":
        with Session() as sess:
            out = q.run(device=CPU, session=sess, analyze=True)
    else:
        out = q.run(device=CPU, analyze=True,
                    **({"mesh": _mesh(), "batch_pages": 8}
                       if where == "mesh" else {}))
    a = out["_analyze"]
    assert set(a) == ANALYZE_KEYS
    assert a["elapsed_s"] > 0 and a["scan_GBps"] > 0
    assert a["bytes_direct"] == os.path.getsize(path) == N_PAGES * 8192
    assert a["requests"] >= 3 and a["waits"] >= 3
    assert 0 < a["avg_dma_bytes"] <= config.get("dma_max_size")
    # one step a batch (three 8-page chunks), or one a shard (4 x 3)
    assert a["kernel_dispatches"] == (12 if where == "mesh" else 3)
    assert a["h2d_depth_reached"] == (0 if where == "mesh" else 2)
    sel = vis & (c0 > 0)
    assert int(out["count"]) == int(sel.sum())
    assert int(out["sums"][1]) == int(c1[sel].sum())


def test_analyze_kernel_dispatches_and_index_depth(heap):
    """tests/test_scan_engine.py:567: the run's dispatch count is one a
    batch (the port folds eagerly: no coalescing to divide it); an
    index-served run reports h2d depth 0, not the last scan's."""
    path, c0, c1, c2, vis = heap
    counts = {}
    for cs in (1 << 16, 1 << 17):
        config.set("chunk_size", cs)
        out = Query(path, SCHEMA).where(FilterPred(((0, "gt", 100),))) \
            .run(device=CPU, analyze=True)
        counts[cs] = out["_analyze"]["kernel_dispatches"]
    # 128 KiB: one whole chunk and the 8-page tail
    assert counts == {1 << 16: 3, 1 << 17: 2}
    build_index(path, SCHEMA, 1, device=CPU)
    out = Query(path, SCHEMA).where_eq(1, 5).aggregate([0]).run(
        device=CPU, analyze=True)
    a = out["_analyze"]
    assert a["h2d_depth_reached"] == 0 and a["kernel_dispatches"] == 0
    m = vis & (c1 == 5)
    assert int(out["count"]) == int(m.sum())


# -- the mesh sort faces (tests/test_query.py) --------------------------------

def _jmesh(n=4, sp=1):
    import jax

    from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jmesh
    return jmesh(jax.devices()[:n], sp=sp)


_SORTS = {
    "order_by where": (
        lambda q: q.where(FilterPred(((0, "gt", 0),))).order_by(0),
        lambda q: q.where(lambda c: c[0] > 0).order_by(0)),
    "order_by descending": (lambda q: q.order_by(0, descending=True),
                            lambda q: q.order_by(0, descending=True)),
    "order_by float": (lambda q: q.order_by(2), lambda q: q.order_by(2)),
    "order_by float descending": (
        lambda q: q.order_by(2, descending=True),
        lambda q: q.order_by(2, descending=True)),
    "order_by limit offset": (
        lambda q: q.order_by(1, limit=50, offset=300),
        lambda q: q.order_by(1, limit=50, offset=300)),
    "order_by limit 0": (lambda q: q.order_by(0, limit=0),
                         lambda q: q.order_by(0, limit=0)),
    "quantiles": (lambda q: q.quantiles(0, [0.0, 0.1, 0.5, 0.99, 1.0]),
                  lambda q: q.quantiles(0, [0.0, 0.1, 0.5, 0.99, 1.0])),
    "quantiles float": (lambda q: q.quantiles(2, [0.25, 0.75]),
                        lambda q: q.quantiles(2, [0.25, 0.75])),
    "count_distinct where": (
        lambda q: q.where(FilterPred(((0, "gt", 0),))).count_distinct(1),
        lambda q: q.where(lambda c: c[0] > 0).count_distinct(1)),
    "count_distinct float": (lambda q: q.count_distinct(2),
                             lambda q: q.count_distinct(2)),
    "empty order_by": (
        lambda q: q.where(FilterPred(((0, "gt", 10 ** 6),))).order_by(0),
        lambda q: q.where(lambda c: c[0] > 10 ** 6).order_by(0)),
    "empty count_distinct": (
        lambda q: q.where(FilterPred(((0, "gt", 10 ** 6),)))
        .count_distinct(0),
        lambda q: q.where(lambda c: c[0] > 10 ** 6).count_distinct(0)),
    "empty quantiles": (
        lambda q: q.where(FilterPred(((0, "gt", 10 ** 6),)))
        .quantiles(0, [0.5]),
        lambda q: q.where(lambda c: c[0] > 10 ** 6).quantiles(0, [0.5])),
}


@pytest.mark.parametrize("sp", [1, 2], ids=["ring", "sp=2"])
@pytest.mark.parametrize("case", sorted(_SORTS))
def test_mesh_sort_faces_match_jax_and_local(heap, case, sp):
    """``tests/test_query.py:327`` (order_by), ``:383`` (an ``(sp=2, dp)``
    caller mesh keeps every bucket), ``:397`` (empty: the info keys),
    ``:440`` (count_distinct), ``:583`` (limit/offset) and ``:837``
    (quantiles): values, positions, per-member counts and drops equal the
    JAX mesh run's, and the values and quantiles equal the local run's."""
    path, c0, c1, c2, vis = heap
    port, ref = _SORTS[case]
    mesh = make_scan_mesh([CPU] * 4, sp=sp)
    plan = port(Query(path, SCHEMA)).explain(mesh=mesh)
    assert plan.mode == "mesh" and plan.kernel == "torch"
    assert "sample sort" in plan.reason
    got = port(Query(path, SCHEMA)).run(mesh=mesh)
    want = ref(JQuery(path, JS)).run(mesh=_jmesh(4, sp))
    _same(got, want)
    local = port(Query(path, SCHEMA)).run(device=CPU)
    _same(got, {k: v for k, v in local.items() if k != "positions"})
    if "per_device_count" in got:
        assert len(got["per_device_count"]) == 4      # every member
        assert int(got["n_dropped"]) == 0


def test_mesh_order_by_positions_name_their_rows(heap):
    path, c0, c1, c2, vis = heap
    out = Query(path, SCHEMA).where(FilterPred(((0, "gt", 0),))) \
        .order_by(0).run(mesh=_mesh())
    sel = vis & (c0 > 0)
    np.testing.assert_array_equal(out["values"], np.sort(c0[sel]))
    assert sel[out["positions"]].all()
    np.testing.assert_array_equal(c0[out["positions"]], out["values"])
    assert out["positions"].dtype == np.int32


def test_mesh_sort_capacity_loop_doubles_on_skew(tmp_path):
    """Every key equal: the first capacity drops, the loop doubles it
    until nothing drops, as the reference's ``_mesh_sort_loop``."""
    schema = HeapSchema(n_cols=1, visibility=False)
    n = schema.tuples_per_page * 8
    path = str(tmp_path / "same.heap")
    build_heap_file(path, [np.full(n, 7, np.int32)], schema)
    out = Query(path, schema).order_by(0).run(mesh=_mesh())
    assert int(out["n_dropped"]) == 0 and len(out["values"]) == n
    assert int(np.asarray(out["per_device_count"]).max()) == n
    want = JQuery(path, JSchema(n_cols=1, visibility=False)).order_by(0) \
        .run(mesh=_jmesh())
    _same(out, want)


_NAN_FACES = {
    "order_by": lambda q: q.order_by(0),
    "order_by descending": lambda q: q.order_by(0, descending=True),
    "order_by limit offset": lambda q: q.order_by(0, limit=1000, offset=10000),
    "quantiles": lambda q: q.quantiles(0, [0.0, 0.5, 0.9, 0.99, 1.0]),
    "count_distinct": lambda q: q.count_distinct(0),
}


@pytest.fixture()
def nan_heap(tmp_path):
    """A float32 column with NaN (both signs), ±0.0 and ±inf among small
    integers, the NaNs a tenth of the rows: enough to share a bucket with
    its pad slots."""
    schema = HeapSchema(n_cols=1, visibility=False, dtypes=("float32",))
    rng = np.random.default_rng(29)
    n = schema.tuples_per_page * 6
    f = rng.integers(-50, 50, n).astype(np.float32)
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.05] = -np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[:4] = [np.inf, -np.inf, 0.0, -np.nan]
    assert (f.view(np.uint32) == 0xFFC00000).any()
    path = str(tmp_path / "nan.heap")
    build_heap_file(path, [f], schema)
    return path, schema, f


@pytest.mark.parametrize("sp", [1, 2], ids=["ring", "sp=2"])
@pytest.mark.parametrize("face", sorted(_NAN_FACES))
def test_mesh_sort_faces_with_nan_match_local(nan_heap, face, sp):
    """A NaN sorts after every number and never after a pad slot: the
    mesh order, quantiles and distinct count of a float column holding
    NaNs equal the local run's (values as bits, positions too) and
    numpy's, and no position is a pad's -1."""
    path, schema, f = nan_heap
    got = _NAN_FACES[face](Query(path, schema)).run(
        mesh=make_scan_mesh([CPU] * 4, sp=sp))
    local = _NAN_FACES[face](Query(path, schema)).run(device=CPU)
    if face == "count_distinct":
        assert int(got["distinct"]) == int(local["distinct"]) == len(
            np.unique(f, equal_nan=False))
        return
    key = "quantiles" if face == "quantiles" else "values"
    np.testing.assert_array_equal(np.asarray(got[key]).view(np.int32),
                                  np.asarray(local[key]).view(np.int32))
    if face == "quantiles":
        assert np.isnan(got[key][-2:]).all()
        return
    _eq(got["positions"], local["positions"])
    assert (np.asarray(got["positions"]) >= 0).all()
    order = np.argsort(-f if "descending" in face else f, kind="stable")
    if "limit" in face:
        order = order[10000:11000]
        assert np.isnan(got["values"]).any() and not np.isnan(
            got["values"]).all()        # the slice spans the first NaN
    _eq(got["positions"], order)


def test_order_by_multi_column_mesh_refused(heap):
    """``tests/test_query.py:757``: one key column over a mesh
    (EOPNOTSUPP, as the reference), any number locally."""
    path, *_ = heap
    with pytest.raises(StromError) as e:
        Query(path, SCHEMA).order_by([0, 1]).run(mesh=_mesh())
    assert e.value.errno == errno.EOPNOTSUPP
    assert len(Query(path, SCHEMA).order_by([0, 1]).run(device=CPU)
               ["values"])
