"""Sharded and multi-host loading of the PyTorch port against the JAX
package: the port's 8-member CPU ring against the JAX
``load_pages_sharded`` on the 8-device CPU mesh, shard by shard, and
against the file's bytes.  The JAX ``load_pages_multihost`` does not run on
this JAX (it passes ``check_rep`` to ``shard_map``), so the single-host
JAX load is the oracle, as the JAX package's own tests use it."""

import errno

import jax
import numpy as np
import pytest
import torch

from nvme_strom_tpu.engine import PlainSource as JPlainSource
from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jax_mesh
from nvme_strom_tpu.parallel.stream import \
    load_pages_sharded as jax_load_sharded
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.engine import PlainSource, StripedSource
from nvme_strom_tpu_torch.parallel import (ShardedBatchStream,
                                           distributed_scan_filter,
                                           load_pages_multihost,
                                           load_pages_sharded,
                                           make_scan_mesh)
from nvme_strom_tpu_torch.scan.heap import PAGE_SIZE
from nvme_strom_tpu_torch.stats import stats

N_PAGES = 32


@pytest.fixture
def page_file(tmp_path):
    rng = np.random.default_rng(17)
    path = tmp_path / "pages.dat"
    path.write_bytes(rng.integers(0, 256, N_PAGES * PAGE_SIZE,
                                  dtype=np.uint8).tobytes())
    return str(path)


@pytest.fixture
def striped_pages(tmp_path):
    """4-member stripe, chunk = PAGE_SIZE: page i lives on member i % 4."""
    rng = np.random.default_rng(18)
    data = rng.integers(0, 256, N_PAGES * PAGE_SIZE,
                        dtype=np.uint8).tobytes()
    members = [tmp_path / f"m{k}.dat" for k in range(4)]
    for k, m in enumerate(members):
        m.write_bytes(b"".join(data[i * PAGE_SIZE:(i + 1) * PAGE_SIZE]
                               for i in range(N_PAGES) if i % 4 == k))
    return [str(m) for m in members], data


def _jax_reference(path):
    with JPlainSource(path) as src:
        arr = jax_load_sharded(src, jax_mesh(jax.devices()[:8]))
    return [np.asarray(s.data) for s in sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start or 0)]


def test_load_pages_sharded_matches_jax_shard_by_shard(page_file):
    ref = _jax_reference(page_file)
    with PlainSource(page_file) as src:
        got = load_pages_sharded(src, make_scan_mesh(["cpu"] * 8))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert g.dtype == torch.uint8 and g.shape == (N_PAGES // 8, PAGE_SIZE)
        assert np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
def test_multihost_load_identical_to_jax_single_host(page_file, hosts):
    ref = _jax_reference(page_file)
    before = stats.snapshot()
    with PlainSource(page_file) as src:
        out = load_pages_multihost(src, make_scan_mesh(["cpu"] * 8),
                                   hosts=hosts)
    for g, r in zip(out, ref):
        assert np.array_equal(g.numpy(), r), f"hosts={hosts}"
    after = stats.snapshot()
    assert after["nr_shard_load"] - before.get("nr_shard_load", 0) == hosts
    assert after["bytes_shard_load"] - before.get("bytes_shard_load", 0) \
        == N_PAGES * PAGE_SIZE
    assert after["nr_ici_permute"] - before.get("nr_ici_permute", 0) == 7


def test_multihost_gather_is_the_file(page_file):
    data = open(page_file, "rb").read()
    with PlainSource(page_file) as src:
        out = load_pages_multihost(src, make_scan_mesh(["cpu"] * 4),
                                   hosts=2, gather=True)
    assert len(out) == 4
    for replica in out:
        assert replica.shape == (N_PAGES, PAGE_SIZE)
        assert replica.numpy().tobytes() == data


def test_multihost_striped_gather_and_counters(striped_pages):
    """As tests/test_shardload.py's striped case: four hosts over a
    4-member stripe, gathered, equal the file; one read per host; the
    ring counters move, and the phases are the reference's flight-recorder
    spans: one ``shard_load`` a host, an ``ici_permute`` for the
    redistribution and one for the gather."""
    from nvme_strom_tpu_torch.config import config
    from nvme_strom_tpu_torch.trace import recorder
    paths, data = striped_pages
    before = stats.snapshot()
    opened = []

    def factory(h):
        opened.append(h)
        return StripedSource(paths, PAGE_SIZE)

    saved = config.get("trace_policy")
    config.set("trace_policy", "all")
    recorder.configure()
    recorder.clear()
    try:
        with StripedSource(paths, PAGE_SIZE) as src:
            out = load_pages_multihost(src, make_scan_mesh(["cpu"] * 8),
                                       hosts=4, gather=True,
                                       source_factory=factory)
        spans = [e for e in recorder.snapshot_events()
                 if e[2] in ("shard_load", "ici_permute")]
    finally:
        config.set("trace_policy", saved)
        recorder.configure()
        recorder.clear()
    assert sorted(opened) == [0, 1, 2, 3]
    for replica in out:
        assert replica.numpy().tobytes() == data
    after = stats.snapshot()
    assert after["nr_shard_load"] - before.get("nr_shard_load", 0) == 4
    assert after["bytes_shard_load"] - before.get("bytes_shard_load", 0) \
        == N_PAGES * PAGE_SIZE
    assert after["nr_ici_permute"] > before.get("nr_ici_permute", 0)
    assert after["bytes_ici"] > before.get("bytes_ici", 0)
    loads = [e for e in spans if e[2] == "shard_load"]
    assert sorted(e[8]["host"] for e in loads) == [0, 1, 2, 3]
    assert sum(e[7] for e in loads) == N_PAGES * PAGE_SIZE
    permutes = [e for e in spans if e[2] == "ici_permute"]
    assert [bool((e[8] or {}).get("gather")) for e in permutes] == \
        [False, True]
    assert all(e[1] > 0 for e in loads + permutes)
    assert sum(e[7] for e in permutes) == \
        after["bytes_ici"] - before.get("bytes_ici", 0)


@pytest.mark.parametrize("case", ["unaligned", "indivisible", "hosts"])
def test_multihost_einval_cases(tmp_path, page_file, case):
    mesh = make_scan_mesh(["cpu"] * 8)
    path = page_file
    hosts = 2
    if case == "unaligned":
        path = str(tmp_path / "odd.dat")
        open(path, "wb").write(b"\1" * (3 * PAGE_SIZE + 100))
    elif case == "indivisible":
        path = str(tmp_path / "short.dat")
        open(path, "wb").write(b"\1" * (12 * PAGE_SIZE))
    else:
        hosts = 3
    with PlainSource(path) as src:
        with pytest.raises(StromError) as e:
            load_pages_multihost(src, mesh, hosts=hosts)
    assert e.value.errno == errno.EINVAL


def test_sharded_batch_stream_bytes_and_wait_histogram(page_file):
    data = np.fromfile(page_file, np.uint8).reshape(N_PAGES, PAGE_SIZE)
    mesh = make_scan_mesh(["cpu"] * 4)
    before = stats.snapshot().get("nr_shard_wait", 0)
    seen = []
    with PlainSource(page_file) as src:
        with ShardedBatchStream(src, mesh, batch_pages=12) as stream:
            for first, shards in stream:
                seen.append(first)
                assert len(shards) == 4
                assert np.array_equal(torch.cat(shards).numpy(),
                                      data[first:first + 12])
    # 32 pages: two whole batches of 12, the tail is the caller's
    assert seen == [0, 12]
    after = stats.snapshot()
    assert after["nr_shard_wait"] - before == 8
    assert after["clk_shard_wait"] > 0
    shards = stats.shard_snapshot()
    assert set(range(4)) <= set(shards)
    for d in shards.values():
        assert d["n"] >= 1 and d["p50_ns"] > 0
    with PlainSource(page_file) as src:
        with pytest.raises(StromError):
            ShardedBatchStream(src, mesh, batch_pages=6)


def test_distributed_scan_filter_folds_every_batch(page_file):
    data = np.fromfile(page_file, np.uint8).reshape(N_PAGES, PAGE_SIZE)
    mesh = make_scan_mesh(["cpu"] * 2)

    def step(shards):
        return {"bytes": torch.stack([s.to(torch.int64).sum()
                                      for s in shards]).sum(),
                "pages": torch.tensor(sum(s.shape[0] for s in shards))}

    with PlainSource(page_file) as src:
        out = distributed_scan_filter(src, mesh, step, batch_pages=8)
    assert int(out["pages"]) == N_PAGES
    assert int(out["bytes"]) == int(data.astype(np.int64).sum())


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_multihost_on_card_matches_the_file(cuda_device, page_file):
    from nvme_strom_tpu_torch.ops import permute_cuda
    data = open(page_file, "rb").read()
    before = permute_cuda.launches
    with PlainSource(page_file) as src:
        out = load_pages_multihost(src, make_scan_mesh([cuda_device] * 4),
                                   hosts=2, gather=True)
    torch.cuda.synchronize()
    # 2 x 3 redistribution steps and 3 gather steps, 4 members each
    assert permute_cuda.launches - before == 4 * (2 * 3 + 3)
    for replica in out:
        assert replica.cpu().numpy().tobytes() == data


@pytest.mark.parametrize("hosts,gather", [(1, False), (2, False),
                                          (2, True)])
def test_sp_mesh_loads_replicate_dp_shards(page_file, hosts, gather):
    """On an ``(sp=2, dp=4)`` mesh the loads split over dp and the lanes
    hold the same shard, as the JAX package's ``load_pages_sharded`` over
    its ``(sp, dp)`` mesh (``P("dp", None)``, device by device); on one
    device the lanes share a tensor.  The gather runs each lane's ring."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    jm = jax_mesh(jax.devices()[:8], sp=2)
    with JPlainSource(page_file) as src:
        ref = jax_load_sharded(src, jm)
    assert ref.sharding == NamedSharding(jm, P("dp", None))
    by_dev = {s.device: np.asarray(s.data) for s in ref.addressable_shards}
    want = [by_dev[d] for d in jm.devices.reshape(-1)]
    mesh = make_scan_mesh(["cpu"] * 8, sp=2)
    with PlainSource(page_file) as src:
        loaded = load_pages_sharded(src, mesh)
        multi = load_pages_multihost(src, mesh, hosts=hosts, gather=gather)
    data = open(page_file, "rb").read()
    for i, (a, b, w) in enumerate(zip(loaded, multi, want)):
        np.testing.assert_array_equal(a.numpy(), w)
        if gather:
            assert b.numpy().tobytes() == data
        else:
            np.testing.assert_array_equal(b.numpy(), w)
    assert loaded[4] is loaded[0] and multi[5] is multi[1]
