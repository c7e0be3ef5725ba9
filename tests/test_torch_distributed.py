"""Ranks over ``torch.distributed``: the port's multi-process harness.

``testing.distributed.launch(2, 2)`` runs two real processes joined by a
``gloo`` process group, each owning two CPU members of one four-member
mesh, through the nine checks of the JAX package's harness (whose own
multi-process test cannot run on this jaxlib's CPU backend).  Each rank's
outputs — its addressable shards, counts, sums, sorted buckets, join
outcomes and GROUP BY keys — are then held against the JAX package's
single-process results over 4 of conftest's 8 virtual devices on the same
bytes; the rows split across ranks add up to the whole.
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
from nvme_strom_tpu_torch.testing.distributed import (CHECKS, CKPT_NAME,
                                                      HEAP_NAME, launch)

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
    return np.fromfile(os.path.join(work, HEAP_NAME), np.uint8) \
        .reshape(-1, 8192)


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
    of what needs the whole leaf, and the Query terminals that gather."""
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
    for q in (Query(path, schema).select([0]),
              Query(path, schema).order_by([0])):
        with pytest.raises(StromError) as e:
            q.run(mesh=mesh)
        assert e.value.errno == errno.EOPNOTSUPP
