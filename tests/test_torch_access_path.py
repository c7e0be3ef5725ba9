"""The port's access path against the JAX package's: the planner's gate
(``scan/planner.py``: the direct-scan threshold, ``enabled``, the
capability cache, the cost model), ``explain()``'s ``direct`` / ``vfs``
choice and its reason, the buffered scan (``vfs``) under every terminal,
join and star face, and the three kinds of source a ``Query`` takes (a
path or ``PathLike``, a list of paths as a RAID-0 stripe set, a live
``Source`` such as a segmented relation).

Each query runs in both packages on the same heap bytes: the port with
``device="cpu"`` (its ``torch`` route), the JAX package on its CPU
backend (its XLA route), both at 64 KiB chunks.  The ``vfs`` face is the
default for these small tables (``debug_no_threshold`` off in both); the
``direct`` face sets it in both.  The fact table is 1120 pages, so the
buffered scan folds two batches (1024 and 96 pages).

Tolerances: counts, integer sums (int32 and uint32 wrap mod 2^32), keys,
mins, maxs, positions and row orders exact (positions compared as int64);
float results within ``1e-5 * |x| + 1e-6`` element by element (the float
column holds non-negative quarters, so its sums do not cancel)."""

import errno
import os
import pathlib

import numpy as np
import pytest

from nvme_strom_tpu import engine as jengine
from nvme_strom_tpu.api import StromError as JStromError
from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan import planner as jplanner
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch import engine as tengine
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.engine import open_source
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.groupby import GroupKey
from nvme_strom_tpu_torch.parallel.mesh import make_scan_mesh
from nvme_strom_tpu_torch.scan import planner as tplanner
from nvme_strom_tpu_torch.scan.heap import PAGE_SIZE, HeapSchema, \
    build_heap_file
from nvme_strom_tpu_torch.scan.index import build_index, index_path_for
from nvme_strom_tpu_torch.scan.query import Query

CPU = "cpu"
KW = dict(n_cols=5, visibility=True,
          dtypes=("int32", "int32", "float32", "int32", "uint32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)
N_PAGES = 1120      # 35 chunks of 64 KiB a stripe member
DIRECT_BYTES = N_PAGES * 8192
DIM_KW = dict(n_cols=2, visibility=False)
KEYS = np.arange(0, 512, dtype=np.int32)
VALS = KEYS * 10
THRESHOLD_PREFIX = "table below the direct-scan threshold"
DIRECT_PREFIX = "table above the direct-scan threshold"
CHECK_FILE_PREFIX = "source not direct-load capable (CHECK_FILE)"


def _set_both(name, value):
    config.set(name, value)
    jconfig.set(name, value)


@pytest.fixture()
def configs():
    """64 KiB chunks on both sides, both capability caches empty; the
    flags each test sets are restored after."""
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    _set_both("chunk_size", 1 << 16)
    # the direct path, as the JAX package's tests pin it: arbitration
    # would send the freshly written, page-cache-warm tables write-back
    config.set("cache_arbitration", False)
    tplanner.capability_cache.invalidate()
    jplanner.capability_cache.invalidate()
    yield
    config.restore(snap)
    jconfig.restore(jsnap)
    tplanner.capability_cache.invalidate()
    jplanner.capability_cache.invalidate()


def _face(face):
    """``vfs``: both packages at their default threshold (a small table
    reads through the page cache); ``direct``: ``debug_no_threshold``."""
    _set_both("debug_no_threshold", face == "direct")


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """1120 pages: c0 in [-6, 7) (ties), c1 full-range int32, c2 float32
    quarters in [0, 10), c3 in [0, 1000) (join and group key), c4
    full-range uint32; 20% invisible.  Also the table cut into a 4-member
    stripe set at 64 KiB (members of equal size, as md-RAID-0 keeps them)
    and into 4 segments of 300 pages (the last 220)."""
    d = tmp_path_factory.mktemp("access")
    rng = np.random.default_rng(12)
    n = SCHEMA.tuples_per_page * N_PAGES - 9
    cols = [rng.integers(-6, 7, n).astype(np.int32),
            rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            .astype(np.int32),
            (rng.integers(0, 40, n) / 4).astype(np.float32),
            rng.integers(0, 1000, n).astype(np.int32),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)]
    vis = rng.random(n) > 0.2
    path = str(d / "fact.heap")
    build_heap_file(path, cols, SCHEMA, visibility=vis.astype(np.int32))
    raw = open(path, "rb").read()
    chunk = 64 << 10
    stripes = [str(d / f"stripe{i}") for i in range(4)]
    outs = [open(p, "wb") for p in stripes]
    for i, off in enumerate(range(0, len(raw), chunk)):
        outs[i % 4].write(raw[off:off + chunk])
    for o in outs:
        o.close()
    seg = 300 * PAGE_SIZE
    segments = []
    for i, off in enumerate(range(0, len(raw), seg)):
        segments.append(str(d / f"seg{i}"))
        with open(segments[-1], "wb") as f:
            f.write(raw[off:off + seg])
    return dict(path=path, cols=cols, vis=vis, stripes=stripes,
                chunk=chunk, segments=segments, seg=seg, dir=str(d))


def _dim(d, name, keys, vals, dtypes):
    """A dimension table on disk in both packages' schemas."""
    kw = dict(DIM_KW, dtypes=dtypes)
    path = os.path.join(d, f"{name}.heap")
    build_heap_file(path, [keys, vals], HeapSchema(**kw))
    return path, HeapSchema(**kw), JSchema(**kw)


@pytest.fixture(scope="module")
def dims(table):
    d = table["dir"]
    k1 = np.arange(0, 500, dtype=np.int32)
    k2 = np.arange(0, 1000, 2, dtype=np.int32)
    return {"d1": _dim(d, "d1", k1, k1 * 7, ("int32", "int32")),
            "d2": _dim(d, "d2", k2, (k2 % 13 / 4).astype(np.float32),
                       ("int32", "float32"))}


def _same_leaf(g, w, what):
    g, w = np.asarray(g), np.asarray(w)
    if g.dtype.kind in "iub" and w.dtype.kind in "iub":
        assert g.dtype.kind == w.dtype.kind or \
            {g.dtype.itemsize, w.dtype.itemsize} == {4, 8}, (what, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g.astype(np.int64) if g.dtype.kind
                                      != "b" else g,
                                      w.astype(np.int64) if w.dtype.kind
                                      != "b" else w, err_msg=what)
        return
    assert g.shape == w.shape, (what, g.shape, w.shape)
    g64, w64 = g.astype(np.float64), w.astype(np.float64)
    same_nan = np.isnan(g64) == np.isnan(w64)
    assert same_nan.all(), what
    ok = np.isnan(w64) | (np.abs(g64 - w64) <= 1e-5 * np.abs(w64) + 1e-6)
    assert ok.all(), (what, g, w)


def _same(got, want, keys=None):
    """*got* equal to *want* on every key of *want* (or *keys*)."""
    for k in keys or want:
        if k.startswith("_"):
            continue
        w = want[k]
        if isinstance(w, (list, tuple)):
            assert len(got[k]) == len(w), k
            for i, (g1, w1) in enumerate(zip(got[k], w)):
                _same_leaf(g1, w1, f"{k}[{i}]")
        else:
            _same_leaf(got[k], w, k)


# -- the planner's gate ---------------------------------------------------

def test_threshold_gate_matches_jax(configs, table):
    """A small table is far below the threshold; ``debug_no_threshold``
    plans it direct (tests/test_scan_engine.py's threshold gate)."""
    path = table["path"]
    for flag in (False, True):
        _set_both("debug_no_threshold", flag)
        assert tplanner.should_use_direct_scan(path) == flag \
            == jplanner.should_use_direct_scan(path)
    # the gate reads table_size for the table, the path for the facts
    _set_both("debug_no_threshold", False)
    big = tplanner.direct_scan_threshold()
    assert tplanner.should_use_direct_scan(path, table_size=big) \
        == jplanner.should_use_direct_scan(path, table_size=big) is True
    assert tplanner.should_use_direct_scan(path, table_size=big - 1) \
        == jplanner.should_use_direct_scan(path, table_size=big - 1) \
        is False


def test_enabled_gate_matches_jax(configs, table):
    _set_both("debug_no_threshold", True)
    _set_both("enabled", False)
    assert not tplanner.should_use_direct_scan(table["path"])
    assert not jplanner.should_use_direct_scan(table["path"])


@pytest.mark.parametrize("buffer_mib", [1024, 64, 4096])
def test_threshold_formula_matches_jax(configs, monkeypatch, buffer_mib):
    """``(RAM − buffer_size)·⅔ + buffer_size`` on the same RAM, and
    buffer_size's bound and chunk-multiple rule."""
    ram = 96 << 30
    monkeypatch.setattr(tplanner, "_mem_total_bytes", lambda: ram)
    monkeypatch.setattr(jplanner, "_mem_total_bytes", lambda: ram)
    _set_both("buffer_size", buffer_mib << 20)
    want = (ram - (buffer_mib << 20)) * 2 // 3 + (buffer_mib << 20)
    assert tplanner.direct_scan_threshold() == want \
        == jplanner.direct_scan_threshold()
    assert tplanner.direct_scan_threshold() >= config.get("buffer_size")
    with pytest.raises(ValueError):
        config.set("buffer_size", (1 << 16) * 3 + 1)
    with pytest.raises(ValueError):
        config.set("buffer_size", 1 << 19)


def test_mem_total_matches_jax():
    assert tplanner._mem_total_bytes() == jplanner._mem_total_bytes() > 0


@pytest.mark.parametrize("seq_page_cost", [0.25, 1.0, 0.0])
@pytest.mark.parametrize("workers", [0, 2, 4, 16])
def test_cost_model_matches_jax(configs, seq_page_cost, workers):
    """The reduced per-page cost from config ``seq_page_cost``; the disk
    component's parallel divisor capped at 4."""
    _set_both("seq_page_cost", seq_page_cost)
    for f in ("cost_direct_scan", "cost_vfs_scan"):
        got = getattr(tplanner, f)(100_000, 1_000_000, workers=workers)
        want = getattr(jplanner, f)(100_000, 1_000_000, workers=workers)
        assert got.total == pytest.approx(want.total, rel=1e-12)
        assert (got.pages, got.workers) == (want.pages, want.workers)
    if seq_page_cost < 1.0:
        assert tplanner.cost_direct_scan(100_000, 1_000_000).total < \
            tplanner.cost_vfs_scan(100_000, 1_000_000).total
    d4 = tplanner.cost_direct_scan(100_000, 0, workers=4).total
    d16 = tplanner.cost_direct_scan(100_000, 0, workers=16).total
    assert d16 == pytest.approx(d4)


def test_capability_cache_matches_jax(configs, table, tmp_path):
    """Facts cached per directory, the file's size always fresh, a file
    of another directory never answered from this one's entry, and
    ``invalidate()`` (all, or one directory)."""
    path = table["path"]
    for cache in (tplanner.capability_cache, jplanner.capability_cache):
        cache.invalidate()
        info1 = cache.probe(path)
        info2 = cache.probe(path)
        assert info2.fs_kind == info1.fs_kind
        assert info2.file_size == os.path.getsize(path)
        other = tmp_path / "other.heap"
        other.write_bytes(b"\0" * 16384)
        assert cache.probe(str(other)).file_size == 16384
        tiny = tmp_path / "sub" / "tiny"
        tiny.parent.mkdir(exist_ok=True)
        tiny.write_bytes(b"\0" * 100)
        t = cache.probe(str(tiny))
        assert (t.path, t.file_size, t.supported) == (str(tiny), 100, False)
        # the MRU holds the other directory now: this one still answers
        # with its own file
        assert cache.probe(path).path == path
        cache.invalidate(str(tmp_path))
        cache.invalidate()
        assert cache.probe(path).supported == info1.supported
    a = tplanner.capability_cache.probe(path)
    b = jplanner.capability_cache.probe(path)
    for f in ("file_size", "numa_node_id", "support_dma64", "n_members",
              "backing_kind", "backing_supported", "backing_reason",
              "dma_max_size", "logical_block_size"):
        assert getattr(a, f) == getattr(b, f), f
    assert int(a.fs_kind) == int(b.fs_kind)


def test_capability_cache_sub_page_file_first(configs, tmp_path,
                                              monkeypatch):
    """A file under a page probed first leaves its directory's class
    alone: the next file of the directory gets the verdict its own
    ``check_file`` gives, the small file still none.  O_DIRECT is taken
    as honoured, so the class is one a table could be read directly
    from."""
    monkeypatch.setattr(tengine, "_probe_odirect", lambda p: True)
    tiny = tmp_path / "tiny"
    tiny.write_bytes(b"\0" * 100)
    big = tmp_path / "big.heap"
    big.write_bytes(b"\0" * 16384)
    cache = tplanner.CapabilityCache()
    assert not cache.probe(str(tiny)).supported
    want = tengine.check_file(str(big), strict=False)
    got = cache.probe(str(big))
    assert want.supported
    assert (got.fs_kind, got.supported) == (want.fs_kind, want.supported)
    assert not cache.probe(str(tiny)).supported


def test_capability_cache_ttl(configs, table, monkeypatch):
    """A fact older than the TTL is probed again."""
    calls = []
    real = tplanner.check_file
    monkeypatch.setattr(tplanner, "check_file",
                        lambda p, **kw: calls.append(p) or real(p, **kw))
    cache = tplanner.CapabilityCache(ttl_s=0.0)
    cache.probe(table["path"])
    cache.probe(table["path"])
    assert len(calls) == 2
    cache = tplanner.CapabilityCache(ttl_s=60.0)
    cache.probe(table["path"])
    cache.probe(table["path"])
    assert len(calls) == 3


# -- explain ----------------------------------------------------------------

_EXPLAIN = {
    "flag off": (dict(debug_no_threshold=False), "vfs", THRESHOLD_PREFIX),
    "flag on": (dict(debug_no_threshold=True), "direct", DIRECT_PREFIX),
    "enabled off": (dict(debug_no_threshold=True, enabled=False), "vfs",
                    THRESHOLD_PREFIX),
}

_OPS = {
    "aggregate": (lambda q: q.aggregate([0]), lambda q: q.aggregate([0])),
    "group_by_cols": (lambda q: q.group_by_cols(0, agg_cols=[1]),
                      lambda q: q.group_by_cols(0, agg_cols=[1])),
    "select": (lambda q: q.select([0], limit=3),
               lambda q: q.select([0], limit=3)),
    "join": (lambda q: q.join(3, KEYS, VALS), lambda q: q.join(3, KEYS,
                                                               VALS)),
}


@pytest.mark.parametrize("op", sorted(_OPS))
@pytest.mark.parametrize("case", sorted(_EXPLAIN))
def test_explain_matches_jax(configs, table, case, op):
    knobs, access, prefix = _EXPLAIN[case]
    for k, v in knobs.items():
        _set_both(k, v)
    mk, jmk = _OPS[op]
    plan = mk(Query(table["path"], SCHEMA)).explain(device=CPU)
    jplan = jmk(JQuery(table["path"], JS)).explain()
    assert plan.access_path == jplan.access_path == access
    assert plan.reason.startswith(prefix) and jplan.reason.startswith(prefix)
    assert plan.reason.split(";")[0] == jplan.reason.split(";")[0]
    assert f"[{access} path" in str(plan)
    assert plan.cost_direct == pytest.approx(jplan.cost_direct)
    assert plan.cost_vfs == pytest.approx(jplan.cost_vfs)


@pytest.mark.parametrize("flag", [False, True])
def test_check_file_refusal_plans_vfs(configs, table, monkeypatch, flag):
    """A filesystem that refuses O_DIRECT (tmpfs, overlay) makes CHECK_FILE
    say UNSUPPORTED: both packages plan vfs, whatever the threshold flag,
    with the reference's reason, and the query still runs (buffered)."""
    monkeypatch.setattr(tengine, "_probe_odirect", lambda p: False)
    monkeypatch.setattr(jengine, "_probe_odirect", lambda p: False)
    _set_both("debug_no_threshold", flag)
    path = table["path"]
    assert not tengine.check_file(path).supported
    q = Query(path, SCHEMA).aggregate([0, 2])
    plan = q.explain(device=CPU)
    jq = JQuery(path, JS).aggregate([0, 2])
    jplan = jq.explain()
    assert plan.access_path == jplan.access_path == "vfs"
    assert plan.reason.startswith(CHECK_FILE_PREFIX)
    assert jplan.reason.startswith(CHECK_FILE_PREFIX)
    got = q.run(device=CPU, analyze=True)
    assert got["_analyze"]["bytes_direct"] == 0
    _same(got, jq.run())


def test_require_nvme_backing_gate_matches_jax(configs, table):
    """Strict eligibility reads this host's backing: whatever it is, both
    packages plan the same path, and direct only for a verified NVMe
    backing with 64-bit DMA."""
    _set_both("debug_no_threshold", True)
    _set_both("require_nvme_backing", True)
    plan = Query(table["path"], SCHEMA).aggregate().explain(device=CPU)
    jplan = JQuery(table["path"], JS).aggregate().explain()
    assert plan.access_path == jplan.access_path
    info = tengine.check_file(table["path"], strict=False)
    assert (plan.access_path == "direct") == info.strict_eligible
    assert tplanner.should_use_direct_scan(table["path"]) \
        == info.strict_eligible


# -- the vfs face of every terminal, join and star ---------------------------

def _p(terms):
    return FilterPred(terms)


_VFS = {
    "aggregate where": (
        lambda q: q.where(_p(((0, "gt", 0),))).aggregate([1, 2, 4]),
        lambda q: q.where(lambda c: c[0] > 0).aggregate([1, 2, 4])),
    "aggregate all": (lambda q: q.aggregate(), lambda q: q.aggregate()),
    "group_by": (
        lambda q: q.where(_p(((2, "lt", 7.5),))).group_by(
            GroupKey(3, 16), 16, agg_cols=[2]),
        lambda q: q.where(lambda c: c[2] < 7.5).group_by(
            lambda c: c[3] % 16, 16, agg_cols=[2])),
    "group_by int": (
        lambda q: q.group_by(GroupKey(0, 8, absolute=True), 8,
                             agg_cols=[0, 1]),
        lambda q: q.group_by(lambda c: abs(c[0]) % 8, 8,
                             agg_cols=[0, 1])),
    "group_by_cols": (lambda q: q.group_by_cols(0, agg_cols=[1]),
                      lambda q: q.group_by_cols(0, agg_cols=[1])),
    "group_by_cols pair": (lambda q: q.group_by_cols([0, 3], agg_cols=[2]),
                           lambda q: q.group_by_cols([0, 3], agg_cols=[2])),
    "group_by_cols spill": (
        lambda q: q.group_by_cols(3, agg_cols=[1], max_groups=64),
        lambda q: q.group_by_cols(3, agg_cols=[1], max_groups=64)),
    "select": (lambda q: q.where(_p(((3, "lt", 3),))).select([0, 4]),
               lambda q: q.where(lambda c: c[3] < 3).select([0, 4])),
    "select limit offset": (
        lambda q: q.select([1], limit=700, offset=250_000),
        lambda q: q.select([1], limit=700, offset=250_000)),
    "select limit across batches": (
        lambda q: q.where(_p(((3, "eq", 7),))).select(limit=400,
                                                      offset=20),
        lambda q: q.where(lambda c: c[3] == 7).select(limit=400,
                                                      offset=20)),
    "top_k": (lambda q: q.top_k(2, 900), lambda q: q.top_k(2, 900)),
    "top_k smallest where": (
        lambda q: q.where(_p(((0, "lt", 0),))).top_k(1, 50, largest=False),
        lambda q: q.where(lambda c: c[0] < 0).top_k(1, 50, largest=False)),
    "order_by": (
        lambda q: q.order_by([0, 2], descending=True, limit=500,
                             offset=100),
        lambda q: q.order_by([0, 2], descending=True, limit=500,
                             offset=100)),
    "order_by where": (
        lambda q: q.where(_p(((3, "lt", 5),))).order_by(2),
        lambda q: q.where(lambda c: c[3] < 5).order_by(2)),
    "quantiles": (lambda q: q.quantiles(2, [0.0, 0.1, 0.5, 0.99, 1.0]),
                  lambda q: q.quantiles(2, [0.0, 0.1, 0.5, 0.99, 1.0])),
    "count_distinct": (lambda q: q.count_distinct(3),
                       lambda q: q.count_distinct(3)),
    "join": (lambda q: q.join(3, KEYS, VALS), lambda q: q.join(3, KEYS,
                                                               VALS)),
    "join left": (lambda q: q.join(3, KEYS, VALS, how="left"),
                  lambda q: q.join(3, KEYS, VALS, how="left")),
    "join rows limit offset": (
        lambda q: q.join(3, KEYS, VALS, materialize=True, limit=600,
                         offset=300),
        lambda q: q.join(3, KEYS, VALS, materialize=True, limit=600,
                         offset=300)),
    "join anti rows": (
        lambda q: q.join(3, KEYS, VALS, how="anti", materialize=True),
        lambda q: q.join(3, KEYS, VALS, how="anti", materialize=True)),
}


@pytest.mark.parametrize("case", sorted(_VFS))
def test_vfs_face_matches_jax(configs, table, case):
    """Each terminal on its vfs face (the default for a small table)
    against the JAX package's vfs face on the same bytes."""
    _face("vfs")
    mk, jmk = _VFS[case]
    q, jq = mk(Query(table["path"], SCHEMA)), jmk(JQuery(table["path"], JS))
    plan, jplan = q.explain(device=CPU), jq.explain()
    assert plan.access_path == jplan.access_path == "vfs"
    got = q.run(device=CPU, analyze=True)
    assert got["_analyze"]["bytes_direct"] == 0
    assert got["_analyze"]["h2d_depth_reached"] == 0
    want = jq.run()
    assert sorted(k for k in got if not k.startswith("_")) == sorted(want)
    _same(got, want)


def test_vfs_batches_and_counters(configs, table):
    """The buffered scan folds 1024-page batches (the reference's grid):
    two for 1120 pages, a step each; the engine reads nothing.  The direct
    face reads every byte through the engine."""
    _face("vfs")
    q = Query(table["path"], SCHEMA).aggregate([2])
    a = q.run(device=CPU, analyze=True)["_analyze"]
    assert (a["bytes_direct"], a["requests"], a["kernel_dispatches"]) \
        == (0, 0, 2)
    _face("direct")
    d = q.run(device=CPU, analyze=True)
    assert d["_analyze"]["bytes_direct"] == DIRECT_BYTES
    assert d["_analyze"]["kernel_dispatches"] == -(-N_PAGES // 8)


@pytest.mark.parametrize("how", ["inner", "semi", "left", "anti"])
@pytest.mark.parametrize("materialize", [False, True])
def test_vfs_join_table_and_grace_match_jax(configs, table, dims, how,
                                            materialize):
    """``join_table`` broadcast, then the local Grace join (the build
    above join_broadcast_max: a vfs scan a partition), against the JAX
    package's vfs faces."""
    _face("vfs")
    bpath, bs, jbs = dims["d1"]
    kw = dict(how=how, materialize=materialize)
    if materialize:
        kw.update(limit=2000, offset=10)
    for cap in (64 << 20, 1024):
        _set_both("join_broadcast_max", cap)
        q = Query(table["path"], SCHEMA).join_table(3, bpath, bs, 0, 1, **kw)
        jq = JQuery(table["path"], JS).join_table(3, bpath, jbs, 0, 1, **kw)
        plan, jplan = q.explain(device=CPU), jq.explain()
        assert plan.access_path == jplan.access_path == "vfs"
        assert plan.join_strategy == jplan.join_strategy
        got, want = q.run(device=CPU), jq.run()
        if materialize and cap == 1024:
            # partition order, then arrival: compared as a set of rows
            assert int(got["count"]) == int(want["count"])
            o, jo = np.argsort(got["positions"]), np.argsort(
                want["positions"])
            _same({k: np.asarray(v)[o] for k, v in got.items()
                   if k != "count"},
                  {k: np.asarray(v)[jo] for k, v in want.items()
                   if k != "count"})
        else:
            _same(got, want)


@pytest.mark.parametrize("materialize", [False, True])
def test_vfs_star_join_matches_jax(configs, table, dims, materialize):
    _face("vfs")
    specs = [dict(probe_col=3, table=dims["d1"][0], schema=dims["d1"][1],
                  key_col=0, value_col=1, how="inner"),
             dict(probe_col=3, table=dims["d2"][0], schema=dims["d2"][1],
                  key_col=0, value_col=1, how="left")]
    jspecs = [dict(s, schema=dims[k][2]) for s, k in zip(specs,
                                                         ("d1", "d2"))]
    kw = dict(materialize=True, fact_cols=[0, 2], limit=3000, offset=7) \
        if materialize else {}
    q = Query(table["path"], SCHEMA).where(_p(((0, "ne", 0),))) \
        .star_join(specs, **kw)
    jq = JQuery(table["path"], JS).where(lambda c: c[0] != 0) \
        .star_join(jspecs, **kw)
    assert q.explain(device=CPU).access_path == jq.explain().access_path \
        == "vfs"
    _same(q.run(device=CPU), jq.run())


def test_vfs_expression_aggregate_matches_jax(configs, table):
    _face("vfs")
    exprs = [("bin", "*", ("col", 2), ("lit", 4)),
             ("bin", "+", ("col", 0), ("lit", 3))]
    got = Query(table["path"], SCHEMA).aggregate_exprs(exprs).run(device=CPU)
    want = JQuery(table["path"], JS).aggregate_exprs(exprs).run()
    _same(got, want)


# -- stripe sets, PathLike and live Sources ------------------------------------

def _sources(table, kind):
    """``(port source, JAX source, opened)`` of one kind over the table's
    bytes; *opened* are live Sources to close."""
    if kind == "path":
        return table["path"], table["path"], []
    if kind == "pathlike":
        return pathlib.Path(table["path"]), pathlib.Path(table["path"]), []
    if kind == "stripe list":
        return list(table["stripes"]), tuple(table["stripes"]), []
    src = open_source(table["segments"], segment_size=table["seg"])
    jsrc = jengine.open_source(table["segments"], segment_size=table["seg"])
    return src, jsrc, [src, jsrc]


_MULTI = {
    "aggregate": (lambda q: q.where(_p(((0, "gt", 1),))).aggregate([1, 2]),
                  lambda q: q.where(lambda c: c[0] > 1).aggregate([1, 2])),
    "group_by": (lambda q: q.group_by(GroupKey(3, 64), 64, agg_cols=[0]),
                 lambda q: q.group_by(lambda c: c[3] % 64, 64,
                                      agg_cols=[0])),
    "group_by_cols": (lambda q: q.group_by_cols(0, agg_cols=[2]),
                      lambda q: q.group_by_cols(0, agg_cols=[2])),
    "top_k": (lambda q: q.top_k(1, 100), lambda q: q.top_k(1, 100)),
    "select": (lambda q: q.select([0, 1], limit=1000, offset=500),
               lambda q: q.select([0, 1], limit=1000, offset=500)),
    "join": (lambda q: q.join(3, KEYS, VALS), lambda q: q.join(3, KEYS,
                                                               VALS)),
}


@pytest.mark.parametrize("op", sorted(_MULTI))
@pytest.mark.parametrize("face", ["vfs", "direct"])
@pytest.mark.parametrize("kind", ["path", "pathlike", "stripe list",
                                  "segmented Source"])
def test_multi_file_sources_match_jax(configs, table, kind, face, op):
    """Every kind of source on both faces equals the single-file run, and
    the JAX package's run over the same source.  A list opens as a stripe
    set at the query's ``stripe_chunk_size``."""
    _face(face)
    mk, jmk = _MULTI[op]
    src, jsrc, opened = _sources(table, kind)
    kw = dict(stripe_chunk_size=table["chunk"]) if kind == "stripe list" \
        else {}
    try:
        q = mk(Query(src, SCHEMA, **kw))
        plan = q.explain(device=CPU)
        want_path = face
        if kind == "segmented Source":
            # the port's segmented Source names its first member for the
            # gate; the JAX package's has no path and always plans vfs
            assert JQuery(jsrc, JS).explain().access_path == "vfs"
        else:
            assert plan.access_path == jmk(JQuery(jsrc, JS, **kw)) \
                .explain().access_path
        assert plan.access_path == want_path
        got = q.run(device=CPU, analyze=True)
        assert (got["_analyze"]["bytes_direct"] > 0) == (face == "direct")
        single = mk(Query(table["path"], SCHEMA)).run(device=CPU)
        _same(got, single)
        _same(got, jmk(JQuery(jsrc, JS, **kw)).run())
    finally:
        for s in opened:
            s.close()


def test_live_source_stays_open(configs, table):
    _face("vfs")
    with open_source(table["segments"], segment_size=table["seg"]) as src:
        q = Query(src, SCHEMA).aggregate([0])
        a = q.run(device=CPU)
        b = q.run(device=CPU)
        _same(a, b)
        Query(src, SCHEMA).fetch([0, 5], device=CPU)
        # the query never closes a Source its caller passed
        assert all(m.fd_buffered >= 0 for m in src.members)


def test_query_refuses_other_sources():
    with pytest.raises(StromError) as e:
        Query(42, SCHEMA)
    assert e.value.errno == errno.EINVAL


@pytest.mark.parametrize("face", ["vfs", "direct"])
def test_mesh_over_stripe_set_matches_local(configs, table, face):
    """A ring of 4 CPU members over the stripe set (whole batches sharded,
    the tail on the first member) equals the local run."""
    _face(face)
    mesh = make_scan_mesh([CPU] * 4)
    for mk in (lambda q: q.aggregate([1, 2]),
               lambda q: q.group_by(GroupKey(3, 32), 32, agg_cols=[2])):
        q = mk(Query(table["stripes"], SCHEMA,
                     stripe_chunk_size=table["chunk"]))
        got = q.run(mesh=mesh, batch_pages=4 * 60)
        _same(got, mk(Query(table["path"], SCHEMA)).run(device=CPU))


@pytest.mark.parametrize("kind", ["stripe list", "segmented Source"])
def test_workers_refuse_a_multi_file_source(configs, table, kind):
    """``workers=2`` over anything but one table path is EINVAL, before
    any process starts, in both packages."""
    src, jsrc, opened = _sources(table, kind)
    kw = dict(stripe_chunk_size=table["chunk"]) if kind == "stripe list" \
        else {}
    try:
        with pytest.raises(StromError) as e:
            Query(src, SCHEMA, workers=2, **kw).aggregate().run(device=CPU)
        assert e.value.errno == errno.EINVAL
        with pytest.raises(JStromError) as je:
            JQuery(jsrc, JS, workers=2, **kw).aggregate().run()
        assert je.value.errno == errno.EINVAL
    finally:
        for s in opened:
            s.close()
    from nvme_strom_tpu_torch.scan.parallel import run_query_workers
    with pytest.raises(StromError) as e:
        run_query_workers({"source": list(table["stripes"]),
                           "chunk_size": 1 << 16}, 2)
    assert e.value.errno == errno.EINVAL


@pytest.mark.parametrize("kind", ["stripe list", "segmented Source"])
def test_fetch_over_multi_file_sources_matches_jax(configs, table, kind):
    t = SCHEMA.tuples_per_page
    pos = [0, 5, t * 8 - 1, t * 8, t * 300 + 3, t * 900, t * 1119 - 10,
           7, 5]
    src, jsrc, opened = _sources(table, kind)
    kw = dict(stripe_chunk_size=table["chunk"]) if kind == "stripe list" \
        else {}
    try:
        got = Query(src, SCHEMA, **kw).fetch(pos, [0, 2, 3], device=CPU)
        want = JQuery(jsrc, JS, **kw).fetch(pos, [0, 2, 3])
        single = Query(table["path"], SCHEMA).fetch(pos, [0, 2, 3],
                                                    device=CPU)
    finally:
        for s in opened:
            s.close()
    _same(got, want)
    _same(got, single)


def test_stripe_member_without_o_direct_reads_true_bytes(configs, table):
    """A member whose O_DIRECT open was refused (fd -1) is read buffered
    by the engine on the direct face: the result is the table's, never
    garbage."""
    _face("direct")
    src = open_source(table["stripes"], stripe_chunk_size=table["chunk"])
    try:
        m = src.members[2]
        os.close(m.fd_direct)
        m.fd_direct = -1
        q = Query(src, SCHEMA).aggregate([1, 2])
        assert q.explain(device=CPU).access_path == "direct"
        got = q.run(device=CPU, analyze=True)
        assert got["_analyze"]["bytes_direct"] == DIRECT_BYTES
    finally:
        src.close()
    _same(got, Query(table["path"], SCHEMA).aggregate([1, 2])
          .run(device=CPU))


# -- the sidecar gone before run() ---------------------------------------------

@pytest.mark.parametrize("face", ["vfs", "direct"])
def test_replan_when_the_sidecar_vanishes(configs, table, tmp_path, face):
    """EXPLAIN promised the index; the sidecar is gone at run(): the scan
    runs on the access path the gate chooses afresh — vfs below the
    threshold, direct above it — as the JAX package's replan chooses."""
    path = str(tmp_path / "t.heap")
    os.link(table["path"], path)
    build_index(path, SCHEMA, 3, device=CPU)
    _face(face)
    q = Query(path, SCHEMA).where_eq(3, 17).aggregate([1])
    jq = JQuery(path, JS).where_eq(3, 17).aggregate([1])
    plan = q.explain(device=CPU)
    assert plan.access_path == jq.explain().access_path == "index"
    os.unlink(index_path_for(path, 3))
    replanned = q._replan_scan(plan)
    assert replanned.access_path == jq._replan_scan(jq.explain()) \
        .access_path == face
    assert f"{face} scan" in replanned.reason
    got = q.run(device=CPU, analyze=True)
    assert got["_analyze"]["bytes_direct"] == \
        (DIRECT_BYTES if face == "direct" else 0)
    sel = table["vis"] & (table["cols"][3] == 17)
    assert int(got["count"]) == int(sel.sum())
    _same(got, jq.run())
