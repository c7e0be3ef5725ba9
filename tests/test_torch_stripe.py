"""Stripe maps, striped sources and host ownership of the PyTorch port
against the JAX package on the same member sizes and files: extents,
ownership dicts and bytes must be identical."""

import errno

import numpy as np
import pytest

from nvme_strom_tpu import stripe as jstripe
from nvme_strom_tpu.engine import PlainSource as JPlainSource
from nvme_strom_tpu.engine import StripedSource as JStripedSource
from nvme_strom_tpu.engine import plan_shard_ownership as jplan
from nvme_strom_tpu.engine import reorder_chunks as jreorder
from nvme_strom_tpu.parallel.shardload import shard_ownership as jown
from nvme_strom_tpu_torch import stripe
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.engine import (PlainSource, Session, StripedSource,
                                         open_source, plan_requests,
                                         plan_shard_ownership,
                                         reorder_chunks)
from nvme_strom_tpu_torch.parallel import shard_ownership
from nvme_strom_tpu_torch.scan.heap import PAGE_SIZE

KIB = 1024


@pytest.mark.parametrize("sizes,chunk", [
    ([64 * KIB] * 4, 4 * KIB),                       # one zone
    ([64 * KIB, 40 * KIB, 24 * KIB], 8 * KIB),       # three zones
    ([48 * KIB, 48 * KIB + 1000, 16 * KIB, 80 * KIB], 3 * KIB),  # non-pow2
])
def test_map_range_matches_jax_over_random_ranges(sizes, chunk):
    mine = stripe.StripeMap(sizes, chunk)
    ref = jstripe.StripeMap(sizes, chunk)
    assert mine.total_size == ref.total_size
    assert [tuple(z.__dict__.values()) for z in mine.zones] == \
        [tuple(z.__dict__.values()) for z in ref.zones]
    rng = np.random.default_rng(len(sizes))
    for _ in range(300):
        off = int(rng.integers(0, mine.total_size))
        length = int(rng.integers(0, mine.total_size - off + 1))
        got = [(e.member, e.member_offset, e.length, e.logical_offset)
               for e in mine.map_range(off, length)]
        want = [(e.member, e.member_offset, e.length, e.logical_offset)
                for e in ref.map_range(off, length)]
        assert got == want, (off, length)
        assert mine.map_offset(off) == ref.map_offset(off)
    with pytest.raises(ValueError):
        mine.map_range(mine.total_size - 1, 2)
    with pytest.raises(ValueError):
        stripe.StripeMap(sizes, 1000)


def test_host_maps_match_jax():
    for n_hosts in (0, 1, 2, 3, 4, 8):
        for member in range(12):
            assert stripe.host_of(member, n_hosts) == \
                jstripe.host_of(member, n_hosts)
        for host in range(-1, 9):
            assert stripe.host_members(host, 12, n_hosts) == \
                jstripe.host_members(host, 12, n_hosts)


def _members(tmp_path, n_pages, n_members, chunk_pages, seed):
    """A striped member set holding *n_pages* random pages, and the
    logical bytes."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, n_pages * PAGE_SIZE, dtype=np.uint8)
    chunk = chunk_pages * PAGE_SIZE
    parts = [[] for _ in range(n_members)]
    for c in range(n_pages // chunk_pages):
        parts[c % n_members].append(data[c * chunk:(c + 1) * chunk])
    paths = []
    for k, p in enumerate(parts):
        path = tmp_path / f"m{k}.dat"
        path.write_bytes(b"".join(x.tobytes() for x in p))
        paths.append(str(path))
    return paths, data.tobytes(), chunk


@pytest.mark.parametrize("hosts", [1, 2, 3, 4, 8])
def test_shard_ownership_matches_jax_plain_and_striped(tmp_path, hosts):
    paths, data, chunk = _members(tmp_path, 48, 4, 2, seed=hosts)
    plain = tmp_path / "plain.dat"
    plain.write_bytes(data)
    with PlainSource(str(plain)) as src, JPlainSource(str(plain)) as jsrc:
        assert shard_ownership(src, hosts) == jown(jsrc, hosts)
    with StripedSource(paths, chunk) as src, \
            JStripedSource(paths, stripe_chunk_size=chunk) as jsrc:
        got = shard_ownership(src, hosts)
        assert got == jown(jsrc, hosts)
        ids = [5, 1, 44, 17, 30]
        assert plan_shard_ownership(src, ids, PAGE_SIZE, hosts) == \
            jplan(jsrc, ids, PAGE_SIZE, hosts)
        # member-aligned: no host owns a chunk of another host's member
        for h, owned in got.items():
            for cid in owned:
                m = src.extents(cid * PAGE_SIZE, PAGE_SIZE)[0].member
                assert stripe.host_of(m, hosts) == h


def test_striped_source_reads_spread_over_members(tmp_path):
    paths, data, chunk = _members(tmp_path, 64, 4, 4, seed=3)
    with open_source(paths, stripe_chunk_size=chunk) as src, \
            JStripedSource(paths, stripe_chunk_size=chunk) as jsrc:
        assert src.size == jsrc.size == len(data)
        assert [(e.member, e.file_off, e.length, e.logical_off)
                for e in src.extents(3000, 200_000)] == \
            [(e.member, e.file_off, e.length, e.logical_off)
             for e in jsrc.extents(3000, 200_000)]
        reqs = plan_requests(src, [(c, c) for c in range(64)], PAGE_SIZE, 0)
        assert {r.member for r in reqs} == {0, 1, 2, 3}
        view = bytearray(70_001)
        src.read_buffered(12_345, memoryview(view))
        assert bytes(view) == data[12_345:12_345 + 70_001]
        with Session() as sess:
            handle, buf = sess.alloc_dma_buffer(len(data))
            try:
                res = sess.memcpy_ssd2ram(src, handle, range(64), PAGE_SIZE)
                sess.memcpy_wait(res.dma_task_id)
                assert bytes(buf.view()[:len(data)]) == data
            finally:
                sess.unmap_buffer(handle)
                buf.close()
    with pytest.raises(StromError) as e:
        open_source(paths)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError):
        StripedSource(paths, 1000)


def test_reorder_chunks_matches_jax():
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, 6 * 16, dtype=np.uint8)
    want = [4, 9, 2, 7, 1, 3]
    got = [9, 4, 7, 3, 2, 1]
    assert np.array_equal(reorder_chunks(raw, 16, got, want),
                          jreorder(raw, 16, got, want))
    assert reorder_chunks(raw, 16, want, want) is raw
