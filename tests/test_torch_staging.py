"""Staging pipeline, registry and backend monitor of the PyTorch port
against the JAX package: ``load_file_to_device(device="cpu")`` lands the
same bytes as the JAX load, and ``plan_landing`` gives the same reasons."""

import errno
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu_torch.engine as teng
from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.hbm import registry as jregistry
from nvme_strom_tpu.hbm.staging import AdaptiveH2DDepth as JDepth
from nvme_strom_tpu.hbm.staging import load_file_to_device as jload
from nvme_strom_tpu.hbm.staging import plan_landing as jplan
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.hbm.backend import BackendMonitor
from nvme_strom_tpu_torch.hbm.registry import HbmRegistry
from nvme_strom_tpu_torch.hbm.staging import (AdaptiveH2DDepth,
                                              StagingPipeline,
                                              load_file_to_device,
                                              plan_landing)

CHUNK = 64 << 10


@pytest.fixture(autouse=True)
def _restore_port_config():
    snap = config.snapshot()
    yield
    config.restore(snap)


def _file(tmp_path, size, seed=1):
    path = str(tmp_path / f"f{size}.bin")
    np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8) \
        .tofile(path)
    return path


@pytest.mark.parametrize("landing", ["auto", "staged"])
@pytest.mark.parametrize("size", [6 * CHUNK, 6 * CHUNK + 4096 + 100])
def test_load_file_to_device_matches_reference(tmp_path, size, landing):
    path = _file(tmp_path, size)
    config.set("landing", landing)
    jconfig.set("landing", landing)
    with teng.open_source(path) as src:
        got = load_file_to_device(src, device="cpu", chunk_size=CHUNK,
                                  staging_bytes=4 * CHUNK)
    with jeng.open_source(path) as src:
        ref = jload(src, chunk_size=CHUNK, staging_bytes=4 * CHUNK)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()
    with open(path, "rb") as f:
        assert got.numpy().tobytes() == f.read()


def test_load_int32_dtype_matches_reference(tmp_path):
    path = _file(tmp_path, 3 * CHUNK + 8, seed=2)
    with teng.open_source(path) as src:
        got = load_file_to_device(src, device="cpu", chunk_size=CHUNK,
                                  dtype=torch.int32)
    with jeng.open_source(path) as src:
        ref = jload(src, chunk_size=CHUNK, dtype=jnp.int32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))


def _hbm_pair(treg, n, tdtype, jdtype, shape2d=False):
    t = torch.zeros((n // 2, 2) if shape2d else n, dtype=tdtype)
    th = treg.map_device_memory(t)
    jh = jregistry.map_device_memory(
        jnp.zeros((n // 2, 2) if shape2d else n, dtype=jdtype))
    return treg.get(th), jregistry.get(jh), jh


@pytest.mark.parametrize("case", ["exact", "offset", "short", "dtype",
                                  "shape", "staged"])
def test_plan_landing_reasons_match_reference(case):
    treg = HbmRegistry()
    n = 4 * CHUNK
    ids, off, tail, tdt, jdt = [0, 1, 2, 3], 0, CHUNK, torch.uint8, jnp.uint8
    if case == "offset":
        off = 4096
    elif case == "short":
        ids = [0, 1, 2]
    elif case == "dtype":
        tdt, jdt = torch.int32, jnp.int32
    elif case == "staged":
        config.set("landing", "staged")
        jconfig.set("landing", "staged")
    tb, jb, jh = _hbm_pair(treg, n if case != "dtype" else n // 4, tdt, jdt,
                           shape2d=case == "shape")
    try:
        mine = plan_landing(tb, ids, CHUNK, off, torch.uint8, tail)
        ref = jplan(jb, ids, CHUNK, off, jnp.uint8, tail)
        assert mine == ref
    finally:
        jregistry.unmap(jh)


def test_plan_landing_backend_reason_for_device_tensor():
    treg = HbmRegistry()
    buf = treg.get(treg.map_device_memory(
        torch.zeros(CHUNK, dtype=torch.uint8, device="meta")))
    assert plan_landing(buf, [0], CHUNK, 0, torch.uint8, CHUNK) == \
        ("staged", "backend")


@pytest.mark.parametrize("ids,err", [([0, 5, 1], errno.EINVAL),
                                     ([9], errno.EINVAL),
                                     ([0, 1, 2, 3], errno.ERANGE)])
def test_memcpy_ssd2dev_errors(tmp_path, ids, err):
    path = _file(tmp_path, 5 * CHUNK + 512)
    treg = HbmRegistry()
    h = treg.map_device_memory(2 * CHUNK, device="cpu")
    with teng.open_source(path) as src, teng.Session() as sess, \
            StagingPipeline(sess, staging_bytes=2 * CHUNK,
                            hbm_registry=treg) as pipe:
        with pytest.raises(StromError) as e:
            pipe.memcpy_ssd2dev(src, h, ids, CHUNK)
        assert e.value.errno == err
    assert treg.get(h).refcount == 0


def test_adaptive_depth_tracks_reference():
    mine, ref = AdaptiveH2DDepth(6), JDepth(6)
    for blocked in [0, 10 ** 6, 10 ** 6, 0, 0, 0, 0, 5 * 10 ** 5, 0, 0, 0,
                    0, 0]:
        assert mine.observe(blocked) == ref.observe(blocked)


class _Event:
    """Stand-in for a torch.cuda.Event that never completes by itself."""

    def __init__(self, hang=0.0, error=None):
        self.hang, self.error = hang, error

    def query(self):
        return False

    def synchronize(self):
        time.sleep(self.hang)
        if self.error is not None:
            raise self.error


def test_fence_deadline_latches_loss_and_revokes():
    mon, reg = BackendMonitor(), HbmRegistry()
    mon.register_registry(reg)
    h = reg.map_device_memory(16, device="cpu")
    with pytest.raises(StromError) as e:
        mon.fence(_Event(hang=2.0), timeout_s=0.05)
    assert e.value.errno == errno.ENODEV and mon.lost()
    with pytest.raises(StromError) as e:           # revoked with the loss
        reg.get(h).tensor
    assert e.value.errno == errno.ENODEV
    with pytest.raises(StromError):                # later fences fail fast
        mon.fence(_Event(), timeout_s=0.05)
    reg.unmap(h)                                   # revoked: no drain wait


def test_fence_out_of_memory_is_enomem_not_loss():
    mon = BackendMonitor()
    with pytest.raises(StromError) as e:
        mon.fence(_Event(error=torch.cuda.OutOfMemoryError("oom")),
                  timeout_s=1.0)
    assert e.value.errno == errno.ENOMEM and mon.lost() is None
    with pytest.raises(StromError) as e:
        mon.fence(_Event(error=RuntimeError("illegal address")),
                  timeout_s=1.0)
    assert e.value.errno == errno.ENODEV and mon.lost()


def test_registry_unmap_waits_for_release():
    reg = HbmRegistry()
    h = reg.map_device_memory(64, device="cpu")
    buf = reg.acquire(h)
    with pytest.raises(StromError) as e:
        reg.unmap(h, timeout=0.05)
    assert e.value.errno == errno.ETIMEDOUT
    t = threading.Timer(0.05, reg.release, args=(buf,))
    t.start()
    reg.unmap(h, timeout=5.0)
    t.join(5.0)
    assert not t.is_alive() and reg.list() == []
    info_reg = HbmRegistry()
    h2 = info_reg.map_device_memory(8192, device="cpu")
    info = info_reg.info(h2)
    assert (info.length, info.kind, info.device) == (8192, "hbm", "cpu")
