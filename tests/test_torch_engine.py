"""Engine of the PyTorch port against the JAX package's Session on the
same files: landed bytes, the partial-tail rule, and the EINVAL contracts
(chunk beyond EOF, chunk size not a power of two)."""

import errno
import os

import numpy as np
import pytest

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu_torch.engine as teng
from nvme_strom_tpu_torch.api import FsKind, StromError

CHUNK = 64 << 10


@pytest.fixture()
def data_file(tmp_path):
    path = str(tmp_path / "data.bin")
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 5 * CHUNK + 3000, dtype=np.uint8)
    data.tofile(path)
    return path, data


def _read(mod, path, ids, chunk=CHUNK):
    """memcpy_ssd2ram + memcpy_wait through *mod*'s Session; returns the
    landed bytes (or raises the engine's StromError)."""
    with mod.open_source(path) as src, mod.Session() as sess:
        handle, buf = sess.alloc_dma_buffer(max(len(ids), 1) * chunk)
        try:
            res = sess.memcpy_ssd2ram(src, handle, ids, chunk)
            got = sess.memcpy_wait(res.dma_task_id)
            n = min(len(ids) * chunk, src.size - min(ids) * chunk)
            return got, bytes(buf.view()[:n])
        finally:
            sess.unmap_buffer(handle)
            buf.close()


def test_memcpy_bytes_equal_file_and_reference(data_file):
    path, data = data_file
    ids = [0, 1, 2, 3]
    res, got = _read(teng, path, ids)
    _, ref = _read(jeng, path, ids)
    assert got == ref == data[:4 * CHUNK].tobytes()
    assert res.nr_ssd2dev == 4 and res.chunk_ids == ids


def test_partial_tail_chunk_matches_reference(data_file):
    path, data = data_file
    _, got = _read(teng, path, [5])
    _, ref = _read(jeng, path, [5])
    assert got == ref == data[5 * CHUNK:].tobytes()
    assert len(got) == 3000


@pytest.mark.parametrize("ids,chunk", [([6], CHUNK), ([0, 9], CHUNK),
                                       ([0], CHUNK + 4096)])
def test_einval_contracts_match_reference(data_file, ids, chunk):
    path, _ = data_file
    for mod in (teng, jeng):
        with pytest.raises(StromError if mod is teng else OSError) as e:
            _read(mod, path, ids, chunk)
        assert e.value.errno == errno.EINVAL, mod.__name__


def test_plan_requests_match_reference(data_file):
    path, _ = data_file
    entries = [(c, i) for i, c in enumerate([0, 1, 2, 4, 5])]
    with teng.open_source(path) as ts, jeng.open_source(path) as js:
        ts.block_size = js.block_size
        mine = teng.plan_requests(ts, entries, CHUNK, 0,
                                  dma_max_size=128 << 10)
        ref = jeng.plan_requests(js, entries, CHUNK, 0,
                                 dma_max_size=128 << 10)
    assert [(r.member, r.file_off, r.length, r.dest_off, r.buffered)
            for r in mine] == \
        [(r.member, r.file_off, r.length, r.dest_off, r.buffered)
         for r in ref]


def test_check_file_matches_reference(data_file, tmp_path):
    path, data = data_file
    mine, ref = teng.check_file(path), jeng.check_file(path)
    assert mine.file_size == ref.file_size == data.size
    assert int(mine.fs_kind) == int(ref.fs_kind)
    tiny = str(tmp_path / "tiny")
    with open(tiny, "wb") as f:
        f.write(b"x" * 100)
    assert teng.check_file(tiny).fs_kind == FsKind.UNSUPPORTED
    assert not teng.check_file(tiny).supported


class _FailingSource(teng.PlainSource):
    def read_member_direct(self, member, file_off, dest):
        raise OSError(errno.EIO, "injected")


def test_read_error_latches_and_is_reaped(data_file):
    path, _ = data_file
    with teng.Session() as sess:
        src = _FailingSource(path)
        handle, buf = sess.alloc_dma_buffer(2 * CHUNK)
        res = sess.memcpy_ssd2ram(src, handle, [0, 1], CHUNK)
        with pytest.raises(StromError) as e:
            sess.memcpy_wait(res.dma_task_id)
        assert e.value.errno == errno.EIO
        with pytest.raises(StromError) as e:       # reaped by the wait
            sess.memcpy_wait(res.dma_task_id)
        assert e.value.errno == errno.ENOENT
        sess.unmap_buffer(handle)                  # refcount drained
        buf.close()
        src.close()


def test_buffer_table_contract(data_file):
    path, _ = data_file
    with teng.Session() as sess:
        handle, buf = sess.alloc_dma_buffer(CHUNK)
        info = sess.info_buffer(handle)
        assert (info.length, info.kind, info.refcount) == \
            (CHUNK, "pinned_host", 0)
        with pytest.raises(StromError) as e:       # too small for 2 chunks
            with teng.open_source(path) as src:
                sess.memcpy_ssd2ram(src, handle, [0, 1], CHUNK)
        assert e.value.errno == errno.ERANGE
        sess.unmap_buffer(handle)
        with pytest.raises(StromError) as e:
            sess.unmap_buffer(handle)
        assert e.value.errno == errno.ENOENT
        buf.close()
    with pytest.raises(StromError) as e:
        with teng.open_source(path) as src:
            sess.memcpy_ssd2ram(src, 1, [0], CHUNK)
    assert e.value.errno == errno.EBADF


def test_dma_buffer_close_runs_callbacks_before_unmap():
    buf = teng.DmaBuffer(12345)
    assert buf.length % os.sysconf("SC_PAGE_SIZE") == 0
    seen = []
    assert buf.on_close(lambda: seen.append(len(buf.view())))
    buf.close()
    assert seen == [buf.length]
    assert not buf.on_close(lambda: None)
