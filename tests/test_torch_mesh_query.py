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
    """The mesh sort faces and the mesh partitioned join are not ported:
    an invalid plan naming ROADMAP A6.2, EINVAL at run(); the query runs
    without the mesh."""
    path, *_cols = heap
    config.set("join_broadcast_max", 1 << 12)     # 4,800 bytes: 2 parts
    q = _A62[face](Query(path, SCHEMA))
    plan = q.explain(mesh=_mesh())
    assert plan.kernel == "invalid" and "A6.2" in plan.reason
    with pytest.raises(StromError) as ei:
        q.run(mesh=_mesh())
    assert ei.value.errno == errno.EINVAL and "A6.2" in str(ei.value)
    assert _A62[face](Query(path, SCHEMA)).run(device=CPU)


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
