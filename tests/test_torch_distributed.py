"""Ranks over ``torch.distributed``: the port's multi-process harness.

``testing.distributed.launch(2, 2)`` runs two real processes joined by a
``gloo`` process group, each owning two CPU members of one four-member
mesh, through the nine checks of the JAX package's harness (whose own
multi-process test cannot run on this jaxlib's CPU backend).  Each rank's
outputs — its addressable shards, counts, sums, sorted buckets, join
outcomes and GROUP BY keys — are then held against the JAX package's
single-process results over 4 of conftest's 8 virtual devices on the same
bytes; the rows split across ranks add up to the whole.

The same launch runs every ``Query`` face over the ranks' mesh (the
``q_*`` checks).  Each face's outputs, the same on both ranks, are held
against the JAX package's one-process ``Query`` on the query fixture's
bytes (over 4 virtual devices where the reference's face takes a mesh:
the sort faces and the partitioned join): counts, integer sums, keys,
positions and orders exact, float32 sums within ``1e-4 * sum(|x|) +
1e-6`` (sum over the whole column), derived float64 statistics within a
relative 1e-6.  Each rank's engine bytes stay within its members' share.
"""

import os
import time

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.data.checkpoint import \
    restore_checkpoint as jrestore
from nvme_strom_tpu.engine import open_source as jopen
from nvme_strom_tpu.parallel.dscan import \
    make_distributed_scan_step as jscan_step
from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jmesh
from nvme_strom_tpu.parallel.pjoin import \
    make_partitioned_join_rows_step as jrows_step, \
    make_partitioned_join_step as jjoin_step
from nvme_strom_tpu.parallel.sort import make_distributed_sort as jsort
from nvme_strom_tpu.parallel.stream import \
    distributed_scan_filter as jfold, load_pages_sharded as jload
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.testing.distributed import (
    BUILD_NAME, CHECKS, CKPT_NAME, DIM_NAMES, HEAP_NAME, JOIN_BROADCAST_MAX,
    QUERY_CHECKS, QUERY_NAME, SPILL_MAX_GROUPS, launch)

NPROC, DPP = 2, 2
N = NPROC * DPP


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """One launch(2, 2) for the module: the ranks' results and outputs."""
    work = str(tmp_path_factory.mktemp("dist"))
    results = launch(NPROC, DPP, work, timeout=120.0)
    outs = [dict(np.load(os.path.join(work, f"out_{r}.npz")))
            for r in range(NPROC)]
    return work, results, outs


def _pages(work):
    return _pages_of(os.path.join(work, HEAP_NAME))


def _pages_of(path):
    return np.fromfile(path, np.uint8).reshape(-1, 8192)


def _local(rank):
    """The members of *rank*: ranks own consecutive members."""
    return list(range(rank * DPP, (rank + 1) * DPP))


def test_multi_process_distributed(ran):
    _work, results, _outs = ran
    assert len(results) == NPROC
    for rank, r in enumerate(results):
        assert r["ok"], r
        assert r["process_id"] == rank
        assert r["n_global"] == N and r["n_local"] == DPP
        assert r["backend"] == "gloo"
        assert set(r["checks"]) == set(CHECKS)
    # the row face partitions over the ranks and covers every match
    assert sum(r["checks"]["pjoin_rows"] for r in results) \
        == results[0]["checks"]["pjoin"]
    # each rank loaded exactly its share of the rows (2 pages a member)
    assert all(r["checks"]["sharded_load"] == 2 * N // NPROC
               for r in results)


def test_each_rank_loaded_the_jax_shards(ran):
    work, _results, outs = ran
    jm = jmesh(jax.devices()[:N])
    with jopen(os.path.join(work, HEAP_NAME)) as src:
        arr = jload(src, jm)
    devs = list(jm.devices.reshape(-1))
    want = {devs.index(s.device): np.asarray(s.data)
            for s in arr.addressable_shards}
    for rank, out in enumerate(outs):
        got = {int(k[6:]): v for k, v in out.items()
               if k.startswith("load_m")}
        assert sorted(got) == _local(rank)
        for i, v in got.items():
            np.testing.assert_array_equal(v, want[i])


def test_scan_step_and_fold_are_the_jax_psum(ran):
    work, _results, outs = ran
    schema = JSchema(n_cols=2, visibility=True)
    run, smesh = jscan_step(jax.devices()[:N], sp=2, schema=schema)
    jout = run(_pages(work), np.int32(0))
    with jopen(os.path.join(work, HEAP_NAME)) as src:
        jf = jfold(src, smesh, lambda a: run(a, np.int32(0)),
                   batch_pages=N)
    for out in outs:
        assert int(out["scan_count"]) == int(np.asarray(jout["count"]))
        np.testing.assert_array_equal(out["scan_sums"],
                                      np.asarray(jout["sums"]))
        assert int(out["fold_count"]) == int(np.asarray(jf["count"]))
        np.testing.assert_array_equal(out["fold_sums"],
                                      np.asarray(jf["sums"]))


def test_sort_buckets_are_the_jax_sorts(ran):
    _work, _results, outs = ran
    svals = np.random.default_rng(99).integers(
        -10_000, 10_000, 64 * N).astype(np.int32)
    jrun, _ = jsort(jax.devices()[:N], capacity=len(svals))
    jout = jrun(svals)
    jcount = np.asarray(jout["count"]).reshape(-1)
    jvals = np.asarray(jout["values"]).reshape(N, -1)
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["sort_count"], jcount)
        got = sorted(int(k[6:]) for k in out if k.startswith("sort_m"))
        assert got == _local(rank)
        for b in got:
            np.testing.assert_array_equal(out[f"sort_m{b}"],
                                          jvals[b][:jcount[b]])
    assert sum(len(out[k]) for out in outs for k in out
               if k.startswith("sort_m")) == len(svals)


def test_exchange_buckets_are_the_jax_exchange(ran):
    """The bucket exchange across ranks: each rank's buckets (padded
    slabs included) and the whole mesh's counts are the JAX exchange's."""
    from nvme_strom_tpu.parallel.exchange import make_bucket_exchange
    _work, _results, outs = ran
    rng = np.random.default_rng(99)
    rng.integers(-10_000, 10_000, 64 * N)       # the sort's draw comes first
    rows = rng.integers(-1000, 1000, (32 * N, 2)).astype(np.int32)
    keys = rng.integers(0, N, 32 * N).astype(np.int32)
    jrun, _ = make_bucket_exchange(jax.devices()[:N], capacity=len(keys),
                                   width=2)
    jout = jrun(rows, keys)
    jrows = np.asarray(jout["rows"])
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["xch_count"],
                                      np.asarray(jout["count"]))
        got = sorted(int(k[5:]) for k in out if k.startswith("xch_m"))
        assert got == _local(rank)
        for b in got:
            np.testing.assert_array_equal(out[f"xch_m{b}"], jrows[b])


def test_restored_shards_are_the_jax_restore(ran):
    work, _results, outs = ran
    jm = jmesh(jax.devices()[:N])
    back = jrestore(os.path.join(work, CKPT_NAME),
                    shardings={"['w']": NamedSharding(jm, P("dp", None))})
    devs = list(jm.devices.reshape(-1))
    want = {devs.index(s.device): np.asarray(s.data)
            for s in back["['w']"].addressable_shards}
    for rank, out in enumerate(outs):
        got = sorted(int(k[6:]) for k in out if k.startswith("ckpt_m"))
        assert got == _local(rank)
        for i in got:
            np.testing.assert_array_equal(out[f"ckpt_m{i}"], want[i])


def test_join_faces_are_the_jax_join(ran):
    work, _results, outs = ran
    pages = _pages(work)
    schema = JSchema(n_cols=2, visibility=True)
    jm = jmesh(jax.devices()[:N])
    keys = np.arange(-60, 60, dtype=np.int32)
    vals = (keys * 3).astype(np.int32)
    jout = jax.tree.map(np.asarray,
                        jjoin_step(jm, schema, 0, keys, vals)(pages))
    jr = jax.tree.map(np.asarray,
                      jrows_step(jm, schema, 0, keys, vals)(pages))
    for rank, out in enumerate(outs):
        assert int(out["pjoin_matched"]) == int(jout["matched"])
        np.testing.assert_array_equal(
            out["pjoin_sums"], [int(s) for s in jout["sums"]])
        assert int(out["pjoin_payload_sum"]) == int(jout["payload_sum"])
        # the row face: the JAX outcomes of the owners this rank holds
        for k, v in jr.items():
            mine = v.reshape(N, -1)[_local(rank)].reshape(-1)
            np.testing.assert_array_equal(out[f"pjr_{k}"], mine)
    hits = sum(int(out["pjr_hit"].astype(bool).sum()) for out in outs)
    assert hits == int(jr["hit"].astype(bool).sum()) == int(jout["matched"])


def test_group_by_cols_is_the_jax_result_on_every_rank(ran):
    work, _results, outs = ran
    jm = jmesh(jax.devices()[:N])
    snap = jconfig.snapshot()
    try:
        jconfig.set("debug_no_threshold", True)
        want = JQuery(os.path.join(work, HEAP_NAME),
                      JSchema(n_cols=2, visibility=True)) \
            .group_by_cols(1, agg_cols=[0]).run(mesh=jm)
    finally:
        jconfig.restore(snap)
    for out in outs:
        np.testing.assert_array_equal(out["gb_key0"],
                                      np.asarray(want["key_cols"][0]))
        np.testing.assert_array_equal(out["gb_count"],
                                      np.asarray(want["count"]))
        np.testing.assert_array_equal(out["gb_sums"],
                                      np.asarray(want["sums"]))
    np.testing.assert_array_equal(outs[0]["gb_sums"], outs[1]["gb_sums"])


def test_launch_surfaces_worker_failure(tmp_path):
    """A worker that fails right after init (no members a rank) fails
    launch() promptly with that worker's log, not at the timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="0 members a rank"):
        launch(2, 0, str(tmp_path), timeout=60.0)
    assert time.monotonic() - t0 < 60.0


def test_launch_attributes_midrun_death_not_hung_peer(tmp_path,
                                                      monkeypatch):
    """Rank 1 dies between init and the first collective while rank 0
    blocks in it: rank 1 is blamed, promptly, and rank 0 is killed."""
    monkeypatch.setenv("STROM_TEST_DIE_AFTER_INIT", "1")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        launch(2, 2, str(tmp_path), timeout=100.0)
    assert "worker 1" in str(ei.value) and "rc=41" in str(ei.value)
    assert time.monotonic() - t0 < 60.0


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_launch_with_cuda_members(tmp_path, cuda_device):
    """launch(2, 2) with each rank's members on cuda:0 over gloo: the
    nine checks exact, B1 launched in each rank and equal to its plain
    version on a member batch."""
    results = launch(2, 2, str(tmp_path), timeout=120.0, device="cuda",
                     backend="gloo")
    for r in results:
        assert set(r["checks"]) == set(CHECKS)
        assert r["members"] == ["cuda:0", "cuda:0"]
        assert r["b1_launches"]["scan_step"] > 0
        assert r["b1_launches"]["stream_fold"] > 0
        assert r["b1_vs_plain_max_abs_err"] == 0


# -- the single-process faces of the rank layer ------------------------------

def test_dist_is_the_identity_without_a_group():
    import torch
    from nvme_strom_tpu_torch.parallel import dist
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert not dist.is_initialized() and dist.backend() is None
    t = torch.arange(4, dtype=torch.int32).view(torch.uint32)
    assert dist.all_reduce(t) is t
    assert dist.all_gather(t) == [t]
    assert dist.all_gather_object({"a": 1}) == [{"a": 1}]
    parts = {0: torch.tensor([1]), 1: torch.tensor([2])}
    assert [int(x) for x in dist.gather_members([0, 0], parts)] == [1, 2]
    dist.barrier("nothing")


def test_nccl_without_a_card_a_rank_is_refused():
    """nccl is never chosen, or taken, without a card a rank: EINVAL
    before any group exists (no silent gloo)."""
    import errno
    from nvme_strom_tpu_torch.api import StromError
    from nvme_strom_tpu_torch.parallel import dist
    with pytest.raises(StromError) as e:
        dist.init_process_group(0, 2, init_method="tcp://127.0.0.1:1",
                                backend="nccl")
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError) as e:
        dist.init_process_group(0, 1, init_method="tcp://127.0.0.1:1",
                                backend="mpi", device_type="cpu")
    assert e.value.errno == errno.EINVAL
    assert not dist.is_initialized()


def test_mesh_with_other_ranks_members(tmp_path):
    """A mesh whose members 2-3 belong to rank 1, seen from rank 0: its
    local members, the shards it holds (None for rank 1's), the refusals
    of what needs the whole leaf, and every Query face (and
    ``build_index``, ``sql_query``) refused with ENOTCONN while no
    process group joins rank 1."""
    import errno
    import torch
    from nvme_strom_tpu_torch.api import StromError
    from nvme_strom_tpu_torch.parallel import (RingSharding, ShardedTensor,
                                               shard_pages)
    from nvme_strom_tpu_torch.parallel.mesh import RingMesh
    from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
    from nvme_strom_tpu_torch.scan.query import Query
    mesh = RingMesh([torch.device("cpu")] * 4, owners=[0, 0, 1, 1])
    assert mesh.multi_process and mesh.local == (0, 1)
    assert mesh.local_columns() == [0, 1]
    assert mesh.lane(0).owners == (0, 0, 1, 1)
    assert mesh.regrid(2).local_columns() == [0, 1]
    pages = torch.arange(8 * 8192, dtype=torch.int32).to(torch.uint8) \
        .view(8, 8192)
    got = shard_pages(pages, mesh)
    assert [t is None for t in got] == [False, False, True, True]
    assert torch.equal(got[1], pages[2:4])
    with pytest.raises(StromError):
        got.lane0()
    sh = RingSharding(mesh)
    leaf = ShardedTensor([torch.zeros(2, 3), torch.ones(2, 3), None, None],
                         sh)
    assert leaf.shape == (8, 3)
    assert [i for i, _idx, _t in leaf.addressable_shards()] == [0, 1]
    with pytest.raises(StromError):
        leaf.full()
    schema = HeapSchema(n_cols=2, visibility=True)
    path = str(tmp_path / "t.heap")
    rng = np.random.default_rng(3)
    n = schema.tuples_per_page * 8
    build_heap_file(path, [rng.integers(0, 9, n).astype(np.int32)
                           for _ in range(2)], schema)
    # with no process group up, every face over a mesh with another
    # rank's members is refused: this process alone reads only its half
    from nvme_strom_tpu_torch.ops.filter import FilterPred
    from nvme_strom_tpu_torch.ops.groupby import GroupKey
    from nvme_strom_tpu_torch.scan.index import build_index
    from nvme_strom_tpu_torch.scan.sql import sql_query
    keys = np.arange(4, dtype=np.int32)
    faces = [lambda q: q.select([0]), lambda q: q.select(limit=3),
             lambda q: q.order_by([0]), lambda q: q.quantiles(0, [0.5]),
             lambda q: q.count_distinct(0), lambda q: q.top_k(0, 3),
             lambda q: q.aggregate(),
             lambda q: q.where(FilterPred(((0, "gt", 3),))).aggregate([1]),
             lambda q: q.group_by(GroupKey(1, mod=4), 4, agg_cols=[0]),
             lambda q: q.group_by_cols(1, agg_cols=[0]),
             lambda q: q.group_by_cols(1, agg_cols=[0], max_groups=2),
             lambda q: q.join(0, keys, keys),
             lambda q: q.join(0, keys, keys, materialize=True),
             lambda q: q.star_join([{"probe_col": 0, "table": path,
                                     "schema": schema, "key_col": 1,
                                     "value_col": None, "how": "semi"}]),
             lambda q: q.where_eq(0, 3).select(),
             lambda q: q.where_in(0, [1, 2]).aggregate(),
             lambda q: q.where_range(0, 1, 2).aggregate()]
    for face in faces:
        with pytest.raises(StromError) as e:
            face(Query(path, schema)).run(mesh=mesh)
        assert e.value.errno == errno.ENOTCONN
    for call in (lambda: build_index(path, schema, 0, mesh=mesh),
                 lambda: sql_query("SELECT COUNT(*) FROM t", path, schema,
                                   mesh=mesh)):
        with pytest.raises(StromError) as e:
            call()
        assert e.value.errno == errno.ENOTCONN


# -- every Query face over the ranks' mesh -----------------------------------

QKW = dict(n_cols=3, visibility=True, dtypes=("int32", "int32", "float32"))
DKW = (dict(n_cols=2, visibility=False),
       dict(n_cols=2, visibility=False, dtypes=("int32", "float32")))
#: full scans of the query fixture a face runs over the mesh (<= where a
#: LIMIT may stop a rank early)
SCANS = {"q_select": 3, "q_order_by": 2, "q_quantiles": 1,
         "q_count_distinct": 2, "q_top_k": 2, "q_group_by": 1, "q_join": 2,
         "q_join_rows": 2, "q_pjoin_query": 2, "q_star": 2,
         "q_where_eq": 6, "q_build_index": 2, "q_groupby_spill": 4,
         "q_sql": 11}
EXACT_SCANS = {"q_order_by", "q_quantiles", "q_count_distinct", "q_top_k",
               "q_group_by", "q_join", "q_pjoin_query", "q_star",
               "q_build_index", "q_groupby_spill"}


def _jflat(prefix, out):
    flat = {}
    for k, v in out.items():
        if k.startswith("_"):
            continue
        if isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                flat[f"{prefix}_{k}{i}"] = np.asarray(x)
        else:
            flat[f"{prefix}_{k}"] = np.asarray(v)
    return flat


def _jq(work):
    return JQuery(os.path.join(work, QUERY_NAME), JSchema(**QKW))


def _jfaces(work, named, mesh=None):
    out = {}
    for tag, build in named.items():
        q = build(_jq(work).where(lambda c: c[0] > 0))
        out.update(_jflat(tag, q.run(mesh=mesh) if mesh is not None
                          else q.run()))
    return out


def _jstar_specs(work):
    return [{"probe_col": 0, "table": os.path.join(work, DIM_NAMES[0]),
             "schema": JSchema(**DKW[0]), "key_col": 0, "value_col": 1,
             "how": "inner"},
            {"probe_col": 1, "table": os.path.join(work, DIM_NAMES[1]),
             "schema": JSchema(**DKW[1]), "key_col": 0, "value_col": 1,
             "how": "left"}]


def _want(face, work):
    """The JAX package's one-process result of *face* on the query
    fixture, flattened as the harness saves the port's."""
    from nvme_strom_tpu.scan.index import build_index as jbuild
    jm = jmesh(jax.devices()[:N])
    dk = np.arange(-40, 40, dtype=np.int32)
    dv = (dk * 7).astype(np.int32)
    build = os.path.join(work, BUILD_NAME)
    if face == "q_select":
        return _jfaces(work, {
            "all": lambda q: q.select(),
            "win": lambda q: q.select(limit=700, offset=1000),
            "head": lambda q: q.select([1], limit=50, offset=7)})
    if face == "q_order_by":
        return _jfaces(work, {
            "asc": lambda q: q.order_by(1),
            "desc": lambda q: q.order_by(1, descending=True, limit=1000,
                                         offset=500)}, jm)
    if face == "q_quantiles":
        return _jfaces(work, {"q": lambda q: q.quantiles(
            1, [0.0, 0.25, 0.5, 0.99, 1.0])}, jm)
    if face == "q_count_distinct":
        got = _jfaces(work, {"d0": lambda q: q.count_distinct(0),
                             "d1": lambda q: q.count_distinct(1)}, jm)
        return {k: v for k, v in got.items() if k.endswith("_distinct")}
    if face == "q_top_k":
        return _jfaces(work, {"max": lambda q: q.top_k(1, 10),
                              "min": lambda q: q.top_k(0, 5, largest=False)})
    if face == "q_group_by":
        return _jfaces(work, {"g": lambda q: q.group_by(
            lambda c: c[1] % 16, 16, agg_cols=[0])})
    if face == "q_join":
        return _jfaces(work, {"inner": lambda q: q.join(0, dk, dv),
                              "left": lambda q: q.join(0, dk, dv,
                                                       how="left")})
    if face == "q_join_rows":
        return _jfaces(work, {
            "inner": lambda q: q.join(0, dk, dv, materialize=True, limit=300,
                                      offset=20),
            "left": lambda q: q.join(0, dk, dv, materialize=True,
                                     how="left")})
    if face == "q_pjoin_query":
        bs = JSchema(**DKW[0])
        return _jfaces(work, {
            "agg": lambda q: q.join_table(0, build, bs, 0, 1),
            "rows": lambda q: q.join_table(0, build, bs, 0, 1,
                                           materialize=True, limit=400,
                                           offset=10)}, jm)
    if face == "q_star":
        return _jfaces(work, {
            "agg": lambda q: q.star_join(_jstar_specs(work)),
            "rows": lambda q: q.star_join(_jstar_specs(work),
                                          materialize=True,
                                          fact_cols=[0, 1], limit=100,
                                          offset=5)})
    if face == "q_where_eq":
        out = {}
        eq = _jq(work).where_eq(0, 7).aggregate().run()
        for tag in ("eq_agg", "sidecar_mesh", "index"):
            out.update(_jflat(tag, eq))
        out.update(_jflat("eq_rows", _jq(work).where_eq(0, 7).select()
                          .run()))
        out.update(_jflat("in_agg", _jq(work).where_in(0, [3, 5, 7])
                          .aggregate().run()))
        out.update(_jflat("range_agg", _jq(work).where_range(0, -5, 5)
                          .aggregate().run()))
        return out
    if face == "q_build_index":
        out = {}
        for tag, col in (("c1", 1), ("pair", (0, 1))):
            p = jbuild(os.path.join(work, QUERY_NAME), JSchema(**QKW), col,
                       index_path=os.path.join(work, f"j_{tag}.idx"))
            out[tag] = np.fromfile(p, np.uint8)
        return out
    if face == "q_groupby_spill":
        out = {}
        for tag, key, agg in (("one", 1, [0]), ("pair", [0, 1], [2])):
            r = _jq(work).group_by_cols(key, agg_cols=agg,
                                        max_groups=SPILL_MAX_GROUPS).run()
            for i, k in enumerate(r.pop("key_cols")):
                out[f"{tag}_key{i}"] = np.asarray(k)
            out.update(_jflat(tag, r))
        return out
    raise KeyError(face)


def _close(face, key, got, want, scale, scale2, float_agg=False):
    """One output: exact, or within the float tolerances (*scale* = the
    float column's sum(|x|), *scale2* its sum(x^2); *float_agg*: a GROUP
    BY over it, whose float64 statistics carry its float32 sums)."""
    got, want = np.asarray(got), np.asarray(want)
    what = f"{face}: {key}"
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if "f" in (got.dtype.kind, want.dtype.kind):
        g, w = got.astype(np.float64), want.astype(np.float64)
        if float_agg and key.endswith(("sumsqs", "vars")):
            tol = 1e-4 * scale2 + 1e-6
        elif got.dtype == np.float32 or want.dtype == np.float32 \
                or float_agg:
            tol = 1e-4 * scale + 1e-6
        else:
            tol = 1e-6 * np.maximum(np.abs(w), 1.0)
        ok = (np.abs(g - w) <= tol) | (np.isnan(g) & np.isnan(w))
        assert ok.all(), (what, g, w)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)


@pytest.mark.parametrize("face", QUERY_CHECKS)
def test_query_face_over_ranks_is_the_jax_result(ran, face):
    """Each face over the two ranks' mesh: both ranks saved the same
    outputs, each the JAX package's one-process result on the same bytes;
    each rank read only its members' pages (the tail goes buffered on
    rank 0), both together the table once a scan."""
    work, results, outs = ran
    import torch
    from nvme_strom_tpu_torch.ops.filter import decode_pages
    from nvme_strom_tpu_torch.scan.heap import HeapSchema
    pages = _pages_of(os.path.join(work, QUERY_NAME))
    cols, valid = decode_pages(torch.from_numpy(pages), HeapSchema(**QKW))
    scale = float(np.abs(cols[2].numpy()).sum())
    scale2 = float(np.square(cols[2].numpy().astype(np.float64)).sum())
    snap = jconfig.snapshot()
    try:
        jconfig.set("join_broadcast_max", JOIN_BROADCAST_MAX)
        if face == "q_sql":
            _sql_face(work, results)
        else:
            want = _want(face, work)
            pre = f"{face}__"
            got = [{k[len(pre):]: v for k, v in out.items()
                    if k.startswith(pre)} for out in outs]
            assert sorted(got[0]) == sorted(got[1])
            for k in got[0]:
                np.testing.assert_array_equal(got[0][k], got[1][k])
            extra = {"index_dma"} if face == "q_where_eq" else set()
            assert set(got[0]) - extra == set(want), \
                sorted(set(got[0]) ^ set(want))
            for k, w in want.items():
                fagg = face == "q_groupby_spill" and k.startswith("pair_")
                if fagg and k.endswith("stds"):
                    # sqrt near 0 magnifies the float32 sums' rounding:
                    # the port's stds are its vars' roots, held above
                    np.testing.assert_allclose(
                        got[0][k], np.sqrt(got[0]["pair_vars"]))
                    continue
                _close(face, k, got[0][k], w, scale, scale2, fagg)
    finally:
        jconfig.restore(snap)
    # the engine's bytes: a rank's share of every scan, the body once a
    # scan over both ranks (the tail reads buffered, on rank 0)
    share = 2 * 2 * 8192                    # two members, two pages each
    dma = [r["dma"][face] for r in results]
    if face == "q_where_eq":                # the local index face's pages
        dma = [d - int(o["q_where_eq__index_dma"])
               for d, o in zip(dma, outs)]
    assert dma[0] == dma[1], dma
    assert dma[0] <= SCANS[face] * share, (face, dma)
    if face in EXACT_SCANS:
        assert sum(dma) == SCANS[face] * NPROC * share, (face, dma)
    if face == "q_where_eq":
        # the index face read only the pages holding c0 == 7 rows
        t = JSchema(**QKW).tuples_per_page
        hit = np.unique(np.flatnonzero(
            ((cols[0] == 7) & valid).numpy().reshape(-1)) // t)
        assert all(int(o["q_where_eq__index_dma"]) == len(hit) * 8192
                   for o in outs)


def _sql_face(work, results):
    """The SQL statements over the ranks, against the JAX package's
    one-process answers; a SUM over no non-NULL row is None in the port
    and 0 in the JAX package (the † divergence of slice 22)."""
    from nvme_strom_tpu.scan.sql import sql_query as jsql
    from nvme_strom_tpu_torch.testing.sql_results import assert_same_result
    tables = {"d": (os.path.join(work, DIM_NAMES[0]), JSchema(**DKW[0])),
              "e": (os.path.join(work, DIM_NAMES[1]), JSchema(**DKW[1]))}
    stmts = [results[0]["checks"]["q_sql"], results[1]["checks"]["q_sql"]]
    assert stmts[0] == stmts[1]
    for sql, got in stmts[0]:
        want = jsql(sql, os.path.join(work, QUERY_NAME), JSchema(**QKW),
                    tables=tables)
        if "c0 > 1000" in sql:
            assert got["count(*)"] == 0
            for k in got:
                if k.startswith("sum("):
                    assert got[k] is None and want[k] == 0, (sql, k)
                    want[k] = None
        assert_same_result(got, want, what=sql)
