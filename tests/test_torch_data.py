"""The data tier of the PyTorch port against the JAX package's on the same
seeded numpy inputs: record files byte-identical both ways, DeviceLoader
batches bit-exact (sequential, shuffled, ring-sharded, across an epoch
boundary, every prefetch depth, the dropped tail), its geometry refusals,
the reaping of an abandoned epoch, a read error and a wedged backend
surfacing from the iterator, and the port's C crc32c against the
reference's."""

import errno
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import nvme_strom_tpu.data as jdata
from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jax_mesh
from nvme_strom_tpu.scan import heap as jheap
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.data import (DeviceLoader, RecordDataset,
                                       RecordWriter, write_records)
from nvme_strom_tpu_torch.data.records import next_pow2
from nvme_strom_tpu_torch.engine import Session, open_source
from nvme_strom_tpu_torch.parallel import make_scan_mesh
from nvme_strom_tpu_torch.scan import heap as theap

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    yield
    tcfg.restore(snap)


def _records(n=64, rec_shape=(128,), dtype=np.int32, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1000, (n,) + rec_shape).astype(dtype)


# -- records ------------------------------------------------------------------

_ARRAYS = {
    "padded f32 (300 B records)": lambda: np.random.default_rng(0)
    .standard_normal((17, 3, 25)).astype(np.float32),
    "pow2 i32 (1 KiB records)": lambda: np.arange(
        16 * 256, dtype=np.int32).reshape(16, 256),
    "cifar u8 (3073 B records)": lambda: np.random.default_rng(1).integers(
        0, 256, (9, 3073), dtype=np.uint8),
    "one-f64 records": lambda: np.random.default_rng(2)
    .standard_normal((11, 1)),
    "bool records": lambda: np.random.default_rng(3).random((5, 7)) > 0.5,
}


@pytest.mark.parametrize("name", sorted(_ARRAYS))
def test_record_files_byte_identical_both_ways(tmp_path, name):
    """Either package writes the same data file and meta file for the same
    array, and reads the other's."""
    a = _ARRAYS[name]()
    mine = write_records(str(tmp_path / "mine.rec"), a)
    ref = jdata.write_records(str(tmp_path / "ref.rec"), a)
    for suffix in ("", ".meta.json"):
        assert (tmp_path / f"mine.rec{suffix}").read_bytes() == \
            (tmp_path / f"ref.rec{suffix}").read_bytes()
    assert (mine.record_bytes, mine.stride, mine.count, mine.dtype,
            mine.shape) == (ref.record_bytes, ref.stride, ref.count,
                            ref.dtype, ref.shape)
    cross_mine = RecordDataset(str(tmp_path / "ref.rec"))
    cross_ref = jdata.RecordDataset(str(tmp_path / "mine.rec"))
    for ds, path in ((cross_mine, "ref.rec"), (cross_ref, "mine.rec")):
        raw = np.frombuffer((tmp_path / path).read_bytes(), np.uint8)
        np.testing.assert_array_equal(ds.decode(raw), a)


def test_record_writer_refuses_a_wrong_shape(tmp_path):
    w = RecordWriter(str(tmp_path / "x.rec"), np.float32, (4,))
    with pytest.raises(StromError) as e:
        w.write(np.zeros((5,), np.float32))
    assert e.value.errno == errno.EINVAL
    w.close()
    with pytest.raises(StromError) as e:
        RecordDataset(str(tmp_path / "missing.rec"))
    assert e.value.errno == errno.ENOENT


def test_next_pow2_matches_reference():
    ns = (1, 2, 3, 300, 512, 513, 3073, 4096)
    assert [next_pow2(n) for n in ns] == \
        [jdata.records.next_pow2(n) for n in ns]


# -- loader -------------------------------------------------------------------

def _pair(tmp_path, a=None, name="d.rec"):
    a = _records() if a is None else a
    write_records(str(tmp_path / name), a)
    return a, str(tmp_path / name)


def _port_batches(it):
    return [b.numpy() if isinstance(b, torch.Tensor)
            else np.concatenate([s.numpy() for s in b]) for b in it]


def _same(mine, ref):
    assert len(mine) == len(ref)
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shuffle,epoch", [(None, 0), (3, 0), (3, 1),
                                           (3, 5), (9, 2)])
def test_loader_batches_equal_reference(tmp_path, shuffle, epoch):
    """Sequential and shuffled epochs: the same seed gives the reference's
    chunk order bit for bit (numpy's default_rng, not torch.randperm)."""
    a, path = _pair(tmp_path)
    with DeviceLoader(path, batch_records=16, chunk_size=4096,
                      shuffle=shuffle, device="cpu") as dl:
        assert dl.rpc == 8 and dl.batches_per_epoch == 4
        mine = _port_batches(dl.epoch(epoch))
    with jdata.DeviceLoader(path, batch_records=16, chunk_size=4096,
                            shuffle=shuffle) as dl:
        ref = [np.asarray(b) for b in dl.epoch(epoch)]
    _same(mine, ref)
    if shuffle is None:
        np.testing.assert_array_equal(np.concatenate(mine), a)


def test_loader_ring_sharded_equals_reference(tmp_path):
    """On a ring of 8 x cpu each batch is a list of per-member tensors,
    member i holding rows [i*b/8, (i+1)*b/8) — the reference's P("dp")
    shards."""
    _, path = _pair(tmp_path)
    mesh = make_scan_mesh(["cpu"] * 8)
    with DeviceLoader(path, batch_records=16, chunk_size=4096, shuffle=4,
                      mesh=mesh) as dl:
        mine = list(dl.epoch(0))
    jm = jax_mesh(jax.devices()[:8], sp=1)
    with jdata.DeviceLoader(path, batch_records=16, chunk_size=4096,
                            shuffle=4, mesh=jm) as dl:
        ref = list(dl.epoch(0))
    assert len(mine) == len(ref) == 4
    for shards, arr in zip(mine, ref):
        assert len(shards) == 8
        by_row = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start)
        for mine_s, ref_s in zip(shards, by_row):
            assert mine_s.device.type == "cpu" and mine_s.shape == (2, 128)
            np.testing.assert_array_equal(mine_s.numpy(),
                                          np.asarray(ref_s.data))


def test_loader_sp_mesh_replicates_dp_shards(tmp_path):
    """On an ``(sp=2, dp=4)`` mesh of 8 x cpu member ``(s, d)`` holds rows
    ``[d*b/4, (d+1)*b/4)``, the JAX loader's shard on the same mesh
    position (``P("dp")`` replicated over sp); the lanes share a tensor."""
    _, path = _pair(tmp_path)
    mesh = make_scan_mesh(["cpu"] * 8, sp=2)
    with DeviceLoader(path, batch_records=16, chunk_size=4096, shuffle=4,
                      mesh=mesh) as dl:
        mine = list(dl.epoch(0))
    jm = jax_mesh(jax.devices()[:8], sp=2)
    with jdata.DeviceLoader(path, batch_records=16, chunk_size=4096,
                            shuffle=4, mesh=jm) as dl:
        ref = list(dl.epoch(0))
    assert len(mine) == len(ref) == 4
    for shards, arr in zip(mine, ref):
        by_dev = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        assert len(shards) == 8 and shards[4] is shards[0]
        for mine_s, dev in zip(shards, jm.devices.reshape(-1)):
            assert mine_s.shape == (4, 128)
            np.testing.assert_array_equal(mine_s.numpy(), by_dev[dev])


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_loader_epochs_across_the_boundary_equal_reference(tmp_path,
                                                           prefetch):
    """epochs() keeps the prefetch ring full across epoch boundaries and
    yields the reference's batches, epoch numbering continuing after an
    epoch() call."""
    _, path = _pair(tmp_path)
    outs = []
    for mod, kw in ((None, {"device": "cpu"}), (jdata, {})):
        cls = DeviceLoader if mod is None else mod.DeviceLoader
        with cls(path, batch_records=16, chunk_size=4096, shuffle=2,
                 prefetch=prefetch, **kw) as dl:
            first = list(dl.epoch())
            rest = list(dl.epochs(3))
        outs.append([np.asarray(b) for b in first + rest])
    assert len(outs[0]) == 16
    _same(*outs)


@pytest.mark.parametrize("n", [20, 63])
def test_loader_drops_the_tail_like_reference(tmp_path, n):
    a, path = _pair(tmp_path, _records(n=n))
    with DeviceLoader(path, batch_records=8, chunk_size=4096,
                      device="cpu") as dl:
        mine = _port_batches(dl)
        assert (dl.n_chunks, dl.batches_per_epoch) == (n // 8, n // 8)
    with jdata.DeviceLoader(path, batch_records=8, chunk_size=4096) as dl:
        ref = [np.asarray(b) for b in dl]
    _same(mine, ref)
    np.testing.assert_array_equal(np.concatenate(mine), a[:n // 8 * 8])


@pytest.mark.parametrize("batch_records", [1, 8, 16, 24, 256, 1024, 3072])
def test_loader_default_chunk_geometry_equals_reference(tmp_path,
                                                        batch_records):
    _, path = _pair(tmp_path, _records(n=4096, rec_shape=(64,)))
    with DeviceLoader(path, batch_records=batch_records,
                      device="cpu") as mine, \
            jdata.DeviceLoader(path, batch_records=batch_records) as ref:
        assert (mine.chunk_size, mine.rpc, mine.chunks_per_batch,
                mine.n_chunks, mine.batches_per_epoch) == \
            (ref.chunk_size, ref.rpc, ref.chunks_per_batch, ref.n_chunks,
             ref.batches_per_epoch)


@pytest.mark.parametrize("kw", [
    {"batch_records": 12, "chunk_size": 4096},       # not whole chunks
    {"batch_records": 0, "chunk_size": 4096},
    {"batch_records": 16, "chunk_size": 4096, "drop_remainder": False},
    {"batch_records": 16, "chunk_size": 4096, "prefetch": 0},
    {"batch_records": 16, "chunk_size": 6144},       # not whole strides
    {"batch_records": 12, "chunk_size": 2048, "mesh": 8},
])
def test_loader_geometry_refusals(tmp_path, kw):
    _, path = _pair(tmp_path)
    kw = dict(kw)
    if kw.pop("mesh", None):
        kw["mesh"] = make_scan_mesh(["cpu"] * 8)
    else:
        kw["device"] = "cpu"
    with pytest.raises(StromError) as e:
        DeviceLoader(path, **kw)
    assert e.value.errno == errno.EINVAL


def test_loader_abandoned_epoch_reaps_prefetch(tmp_path):
    """A break with prefetches in flight leaves no task in a caller-owned
    session."""
    _, path = _pair(tmp_path)
    with Session() as sess:
        with DeviceLoader(path, batch_records=16, chunk_size=4096,
                          session=sess, prefetch=3, device="cpu") as dl:
            for _ in dl:
                break
            assert sess.pending_tasks() == []
            for _ in dl.epochs(2):
                break
            assert sess.pending_tasks() == []
            # the loader still works after both abandons
            assert len(list(dl.epoch(0))) == 4


def test_loader_over_segmented_source_equals_reference(tmp_path):
    a, path = _pair(tmp_path)
    raw = Path(path).read_bytes()
    seg = 8192
    paths = []
    for i in range(0, len(raw), seg):
        p = tmp_path / f"seg.{i // seg}"
        p.write_bytes(raw[i:i + seg])
        paths.append(str(p))
    src = open_source(paths, segment_size=seg)
    try:
        with DeviceLoader(RecordDataset(path), batch_records=16,
                          chunk_size=4096, source=src, shuffle=5,
                          device="cpu") as dl:
            mine = _port_batches(dl.epoch(0))
    finally:
        src.close()
    with jdata.DeviceLoader(path, batch_records=16, chunk_size=4096,
                            shuffle=5) as dl:
        ref = [np.asarray(b) for b in dl.epoch(0)]
    _same(mine, ref)


def test_loader_surfaces_a_read_error(tmp_path):
    """A dead region under the loader (FaultPlan ``fail_offsets``: the
    direct leg and the buffered fallback both fail) latches EIO into the
    task and surfaces from the iterator, as the JAX package's loader does
    on the same plan (``tests/test_data.py:259-276``); no task is left
    behind."""
    from nvme_strom_tpu.api import StromError as JStromError
    from nvme_strom_tpu.testing import FakeNvmeSource as JFake
    from nvme_strom_tpu.testing import FaultPlan as JPlan
    from nvme_strom_tpu_torch.testing import FakeNvmeSource, FaultPlan
    _, path = _pair(tmp_path)
    src = FakeNvmeSource(path, fault_plan=FaultPlan(fail_offsets={8192}),
                         force_cached_fraction=0.0)
    try:
        with DeviceLoader(RecordDataset(path), batch_records=16,
                          chunk_size=4096, source=src, device="cpu") as dl:
            with pytest.raises(StromError) as e:
                for _ in dl:
                    pass
            assert e.value.errno == errno.EIO
            assert dl.session.pending_tasks() == []
    finally:
        src.close()
    jsrc = JFake(path, fault_plan=JPlan(fail_offsets={8192}),
                 force_cached_fraction=0.0)
    try:
        with jdata.DeviceLoader(jdata.RecordDataset(path), batch_records=16,
                                chunk_size=4096, source=jsrc) as dl:
            with pytest.raises(JStromError) as je:
                for _ in dl:
                    pass
    finally:
        jsrc.close()
    assert je.value.errno == e.value.errno


def test_backend_loss_fails_loader_not_hangs(tmp_path):
    """The prefetch fences ride the bounded path: an injected wedge fails
    the epoch with ENODEV (no hang) and close() still frees the ring."""
    from nvme_strom_tpu_torch.testing import backend_fault

    path = str(tmp_path / "l.rec")
    write_records(path, np.random.default_rng(1).standard_normal((64, 64))
                  .astype(np.float32))
    tcfg.set("backend_fence_timeout", 0.2)
    with backend_fault(mode="hang", hang_s=5.0):
        dl = DeviceLoader(path, batch_records=8, prefetch=2, device="cpu")
        with pytest.raises(StromError) as e:
            for _ in dl:
                pass
        assert e.value.errno == errno.ENODEV
        bufs = [b for _, b in dl._bufs]
        dl.close()
    assert all(b._mm is None for b in bufs)
    # the latch was reset on exit: a fresh loader runs
    with DeviceLoader(path, batch_records=8, device="cpu") as dl:
        assert len(list(dl)) == 8


def test_entry_points_default_to_the_card_and_refuse_the_cpu(tmp_path):
    """With no CUDA device, DeviceLoader, restore_checkpoint and
    strom_ckpt bench default to cuda:0 and raise ENODEV; none runs on the
    CPU instead."""
    path = str(tmp_path / "r.rec")
    write_records(path, _records())
    ck = str(tmp_path / "c.strom")
    jdata.save_checkpoint(ck, {"w": np.arange(8, dtype=np.float32)})
    script = textwrap.dedent("""
        import errno, sys
        from nvme_strom_tpu_torch.api import StromError
        from nvme_strom_tpu_torch.data import DeviceLoader, restore_checkpoint
        from nvme_strom_tpu_torch.tools import strom_ckpt
        codes = []
        for call in (lambda: DeviceLoader(sys.argv[1], batch_records=16),
                     lambda: restore_checkpoint(sys.argv[2]),
                     lambda: strom_ckpt.main(["bench", sys.argv[2]])):
            try:
                call()
            except StromError as e:
                codes.append(e.errno)
        assert codes == [errno.ENODEV] * 3, codes
        print("REFUSED")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", script, path, ck],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "REFUSED" in out.stdout


# -- crc32c -------------------------------------------------------------------

_LENGTHS = [0, 1, 3, 4095, 4096, (1 << 20) + 7]


@pytest.mark.parametrize("n", _LENGTHS)
@pytest.mark.parametrize("start", [0, 1, 3, 5])
def test_crc32c_c_library_equals_reference(n, start):
    """The port's C crc32c (the SSE4.2 instruction and the slicing-by-8
    tables) and crc32c() against the reference's, at unaligned starts."""
    buf = np.random.default_rng(n + start).integers(0, 256, n + 8,
                                                    dtype=np.uint8)
    view = buf[start:start + n]
    want = jheap.crc32c(view.tobytes())
    assert theap.crc32c_update_native(0, view) == want
    assert theap.crc32c_update_native(0, view, hw=False) == want
    assert theap.crc32c(view) == want
    assert theap.crc32c(view.tobytes()) == want
    assert theap.crc32c(memoryview(view.tobytes())) == want


@pytest.mark.parametrize("n", [0, 1, 3, 4095, 4096])
def test_crc32c_plain_version_equals_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert theap.crc32c_update_py(0, data) == jheap.crc32c(data.tobytes())


@pytest.mark.parametrize("split", [0, 1, 7, 4096, 65537])
def test_crc32c_incremental_identity(split):
    data = np.random.default_rng(5).integers(0, 256, 100_003,
                                             dtype=np.uint8)
    a, b = data[:split], data[split:]
    whole = jheap.crc32c(data.tobytes())
    for update in (theap.crc32c_update,
                   lambda c, d: theap.crc32c_update_native(c, d, hw=False),
                   theap.crc32c_update_native):
        assert update(theap.crc32c(a), b) == whole
    assert theap.crc32c_update(jheap.crc32c(a.tobytes()), b) == \
        jheap.crc32c_update(jheap.crc32c(a.tobytes()), b.tobytes())
    assert theap.crc32c_update_py(theap.crc32c(a), b[:999]) == \
        theap.crc32c(data[:split + 999]) if len(b) >= 999 else True


def test_crc32c_names_its_implementation():
    impl = theap.crc32c_impl()
    assert impl in ("google_crc32c", "native sse4.2",
                    "native slicing-by-8")
    try:
        import google_crc32c
        assert (impl == "google_crc32c") == (
            google_crc32c.implementation == "c")
    except ImportError:
        assert impl.startswith("native")


def test_crc32c_library_builds_from_the_ports_own_source():
    from nvme_strom_tpu_torch import _build
    cmd = _build._command(_build.CRC32C, _build._OUT / "x.so")
    assert cmd[-1] == str(ROOT / "nvme_strom_tpu_torch" / "csrc"
                          / "strom_crc32c.cc")
    assert tuple(cmd[1:6]) == _build.GXX_FLAGS
    assert _build.CRC32C in _build.HOST_SOURCES
    lib = _build.host_library(_build.CRC32C)
    assert lib.startswith(str(_build._OUT)) and os.path.exists(lib)
    assert json.dumps(theap.crc32c(b"123456789")) == str(0xE3069283)
