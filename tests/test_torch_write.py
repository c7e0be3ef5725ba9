"""The write path of the PyTorch port (``Session.memcpy_ram2ssd``) against
the JAX package's on the same seeded bytes: byte-identical files, the
misaligned tail on the buffered leg, segmented and striped sinks, the
read-only refusal, and the native write batch's failover."""

import errno
import os

import numpy as np
import pytest

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu_torch.engine as teng
from nvme_strom_tpu_torch import _native
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.stats import stats

CHUNK = 64 << 10


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    yield
    tcfg.restore(snap)


def _seeded(n, seed=11):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _write(mod, sink, data, chunk=CHUNK, **session_kw):
    """memcpy_ram2ssd of *data* (chunk i -> sink chunk i) through *mod*'s
    Session, then wait and sync."""
    n = -(-len(data) // chunk)
    with mod.Session(**session_kw) as sess:
        handle, buf = sess.alloc_dma_buffer(n * chunk)
        try:
            buf.view()[:len(data)] = data.tobytes()
            res = sess.memcpy_ram2ssd(sink, handle, list(range(n)), chunk)
            sess.memcpy_wait(res.dma_task_id)
            sink.sync()
            return res, sess.stat_info() if mod is teng else None
        finally:
            sess.unmap_buffer(handle)
            buf.close()


def _fresh(path, size):
    with open(path, "wb") as f:
        f.truncate(size)


@pytest.mark.parametrize("size", [5 * CHUNK, 5 * CHUNK + 4096 + 17,
                                  CHUNK - 100 + 4096])
@pytest.mark.parametrize("backend", ["auto", "threadpool", "python"])
def test_written_files_equal_reference(tmp_path, size, backend):
    data = _seeded(size)
    mine, ref = str(tmp_path / "mine.bin"), str(tmp_path / "ref.bin")
    for p in (mine, ref):
        _fresh(p, size)
    with teng.open_source(mine, writable=True) as sink:
        res, info = _write(teng, sink, data, io_backend=backend)
    with jeng.open_source(ref, writable=True) as sink:
        _write(jeng, sink, data)
    got, want = open(mine, "rb").read(), open(ref, "rb").read()
    assert got == want == data.tobytes()
    assert res.chunk_ids == list(range(-(-size // CHUNK)))
    assert info["nr_write_dma"] >= 1
    assert info["total_write_length"] >= size


@pytest.mark.parametrize("kind", ["segmented", "striped"])
def test_multi_member_sinks_equal_reference(tmp_path, kind):
    n_mem, seg = 4, 2 * CHUNK
    data = _seeded(n_mem * seg, seed=3)
    files = {}
    for tag, mod in (("mine", teng), ("ref", jeng)):
        paths = [str(tmp_path / f"{tag}.{k}") for k in range(n_mem)]
        for p in paths:
            _fresh(p, seg)
        kw = ({"segment_size": seg} if kind == "segmented"
              else {"stripe_chunk_size": CHUNK})
        with mod.open_source(paths, writable=True, **kw) as sink:
            _write(mod, sink, data)
        files[tag] = [open(p, "rb").read() for p in paths]
    assert files["mine"] == files["ref"]
    with teng.open_source([str(tmp_path / f"mine.{k}") for k in range(4)],
                          **({"segment_size": seg} if kind == "segmented"
                             else {"stripe_chunk_size": CHUNK})) as src, \
            teng.Session() as sess:
        handle, buf = sess.alloc_dma_buffer(len(data))
        got = teng.read_chunk_ids(sess, src, range(len(data) // CHUNK),
                                  CHUNK, handle, buf.view())
        assert got.tobytes() == data.tobytes()
        sess.unmap_buffer(handle)
        buf.close()


def test_read_only_sink_is_ebadf_like_reference(tmp_path):
    path = str(tmp_path / "ro.bin")
    _fresh(path, 2 * CHUNK)
    data = _seeded(2 * CHUNK)
    for mod in (teng, jeng):
        with mod.open_source(path) as sink, pytest.raises(OSError) as e:
            _write(mod, sink, data)
        assert e.value.errno == errno.EBADF, mod.__name__


@pytest.mark.parametrize("fallback", [True, False])
def test_failed_native_write_submit_falls_back_or_raises(tmp_path,
                                                         monkeypatch,
                                                         fallback):
    path = str(tmp_path / "w.bin")
    size = 3 * CHUNK
    _fresh(path, size)
    data = _seeded(size, seed=5)
    tcfg.set("io_fallback", fallback)

    def refuse(self, *a, **kw):
        raise StromError(errno.EIO, "injected submit failure")

    monkeypatch.setattr(_native.NativeEngine, "submit", refuse)
    before = stats.snapshot().get("nr_backend_fallback", 0)
    with teng.open_source(path, writable=True) as sink:
        if fallback:
            _write(teng, sink, data)
        else:
            with pytest.raises(StromError) as e:
                _write(teng, sink, data)
            assert e.value.errno == errno.EIO
    moved = stats.snapshot().get("nr_backend_fallback", 0) - before
    if fallback:
        assert open(path, "rb").read() == data.tobytes()
        assert moved == 1
    else:
        assert moved == 0


def test_failed_native_write_batch_is_redriven(tmp_path, monkeypatch):
    """A write batch the engine fails is redriven request by request on
    the python leg; the file ends up right and the step is counted."""
    path = str(tmp_path / "w.bin")
    size = 4 * CHUNK
    _fresh(path, size)
    data = _seeded(size, seed=6)
    real_wait = _native.NativeEngine.wait
    failed = []

    def wait(self, task_id, timeout_ms=-1):
        real_wait(self, task_id, timeout_ms)
        if not failed:
            failed.append(task_id)
            raise StromError(errno.EIO, "injected batch failure")

    monkeypatch.setattr(_native.NativeEngine, "wait", wait)
    before = stats.snapshot().get("nr_backend_fallback", 0)
    with teng.open_source(path, writable=True) as sink:
        _write(teng, sink, data)
    assert failed
    assert open(path, "rb").read() == data.tobytes()
    assert stats.snapshot().get("nr_backend_fallback", 0) - before == 1


def test_write_then_load_round_trips_through_the_port(tmp_path):
    """The checkpoint shape: seeded bytes written through the native leg,
    read back by the load path (``load_file_to_device`` on the CPU)."""
    from nvme_strom_tpu_torch.hbm.staging import load_file_to_device
    size = 6 * CHUNK + 4096 + 17
    path = str(tmp_path / "rt.bin")
    _fresh(path, size)
    data = _seeded(size, seed=8)
    with teng.open_source(path, writable=True) as sink:
        _write(teng, sink, data)
    with teng.open_source(path) as src:
        out = load_file_to_device(src, chunk_size=CHUNK, device="cpu")
    assert out.numpy().tobytes() == data.tobytes()
    assert os.path.getsize(path) == size
