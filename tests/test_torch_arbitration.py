"""Page-cache arbitration of the PyTorch port against the JAX package on
the same files: the write-back split of ``memcpy_ssd2ram`` (forced
verdicts, hot hints, the threshold, ``wb_buffer``), the residency probe
(one batched ``mincore(2)``, the kpageflags dirty check) against the
reference's on a warm and a cold file, and the landing of a write-back
tail through the staging pipeline and the one-call load.  The
counterparts of ``tests/test_engine.py:147-250``."""

import os
import types

import numpy as np
import pytest

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.hbm.staging as jstaging
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.config import config as jcfg
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.hbm.staging import (StagingPipeline,
                                              load_file_to_device)
from nvme_strom_tpu_torch.hbm import registry
from nvme_strom_tpu_torch.tools.common import (chunks_mismatch,
                                               drop_page_cache)

CHUNK = 64 << 10

PKGS = {"jax": types.SimpleNamespace(eng=jeng, fake=jfake, cfg=jcfg),
        "torch": types.SimpleNamespace(eng=teng, fake=tfake, cfg=tcfg)}


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    for cfg in (jcfg, tcfg):
        cfg.set("cache_arbitration", True)
    yield
    tcfg.restore(snap)


@pytest.fixture()
def data_file(tmp_path):
    path = str(tmp_path / "data.bin")
    tfake.make_test_file(path, 4 << 20)
    return path


def _run_copy(p, source, ids, **kw):
    with p.eng.Session() as sess:
        handle, buf = sess.alloc_dma_buffer(len(ids) * CHUNK)
        res = sess.memcpy_ssd2ram(source, handle, ids, CHUNK, **kw)
        sess.memcpy_wait(res.dma_task_id)
        return res, bytes(buf.view()[:len(ids) * CHUNK])


def _both(path, ids, *, hints=(), **src_kw):
    """The same copy through both packages' fake sources: ``{name: (nr
    ssd, nr ram, chunk_ids)}``, every slot checked against the file."""
    out = {}
    for name, p in PKGS.items():
        src = p.fake.FakeNvmeSource(path, **src_kw)
        try:
            for off, ln in hints:
                src.hint_hot_range(off, ln)
            res, data = _run_copy(p, src, ids)
        finally:
            src.close()
        for slot, cid in enumerate(res.chunk_ids):
            assert data[slot * CHUNK:(slot + 1) * CHUNK] == \
                tfake.expected_bytes(cid * CHUNK, CHUNK), (name, slot)
        out[name] = (res.nr_ssd2dev, res.nr_ram2dev, list(res.chunk_ids))
    return out


def test_cache_arbitration_writeback(data_file):
    out = _both(data_file, [0, 1, 2, 3], force_cached_fraction=1.0)
    assert out["torch"] == out["jax"] == (0, 4, [0, 1, 2, 3])


def test_hot_hint_forces_writeback(data_file):
    """One hot page is decisive: the chunk holding it goes write-back
    though nothing is cached, and rides the tail of chunk_ids."""
    out = _both(data_file, [0, 1, 2, 3], force_cached_fraction=0.0,
                hints=[(2 * CHUNK + 4096, 4096)])
    assert out["torch"] == out["jax"] == (3, 1, [0, 1, 3, 2])


def test_hints_cleared_restore_the_direct_path(data_file):
    for p in PKGS.values():
        src = p.fake.FakeNvmeSource(data_file, force_cached_fraction=0.0)
        try:
            src.hint_hot_range(0, 4096)
            src.clear_hot_hints()
            res, _ = _run_copy(p, src, [0, 1])
            assert (res.nr_ssd2dev, res.nr_ram2dev) == (2, 0)
        finally:
            src.close()


def test_hot_fraction_overlap_math(data_file):
    for p in PKGS.values():
        src = p.fake.FakeNvmeSource(data_file, force_cached_fraction=0.0)
        try:
            assert src.hot_fraction(0, CHUNK) == 0.0
            src.hint_hot_range(0, CHUNK // 2)
            assert src.hot_fraction(0, CHUNK) == pytest.approx(0.5)
            assert src.hot_fraction(CHUNK, CHUNK) == 0.0
            src.hint_hot_range(CHUNK // 2, CHUNK // 2)
            assert src.hot_fraction(0, CHUNK) == pytest.approx(1.0)
            src.hint_hot_range(0, 0)              # empty hints add nothing
            src.clear_hot_hints()
            assert src.hot_fraction(0, CHUNK) == 0.0
        finally:
            src.close()


@pytest.mark.parametrize("frac,want_wb", [(0.5, 0), (0.51, 4)])
def test_threshold_is_strict(data_file, frac, want_wb):
    """A chunk goes write-back only above cache_threshold (0.5)."""
    out = _both(data_file, [0, 1, 2, 3], force_cached_fraction=frac)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == want_wb


def test_cache_arbitration_off(data_file):
    for cfg in (jcfg, tcfg):
        cfg.set("cache_arbitration", False)
    out = _both(data_file, [0, 1], force_cached_fraction=1.0)
    assert out["torch"] == out["jax"] == (2, 0, [0, 1])


def test_writeback_to_separate_wb_buffer(data_file):
    """The SSD2GPU contract: write-back chunks land tail-packed in the
    caller's wb_buffer from its offset 0, the direct ones in the mapped
    buffer."""
    got = {}
    for name, p in PKGS.items():
        src = p.fake.FakeNvmeSource(data_file, force_cached_fraction=0.0)
        src.hint_hot_range(CHUNK, 10)
        src.hint_hot_range(3 * CHUNK, 10)
        wb = bytearray(4 * CHUNK)
        try:
            with p.eng.Session() as sess:
                handle, buf = sess.alloc_dma_buffer(4 * CHUNK)
                res = sess.memcpy_ssd2ram(src, handle, [0, 1, 2, 3], CHUNK,
                                          wb_buffer=memoryview(wb))
                sess.memcpy_wait(res.dma_task_id)
                direct = bytes(buf.view()[:res.nr_ssd2dev * CHUNK])
        finally:
            src.close()
        assert (res.nr_ssd2dev, res.nr_ram2dev) == (2, 2)
        assert list(res.chunk_ids) == [0, 2, 1, 3]
        for slot, cid in enumerate(res.chunk_ids):
            want = tfake.expected_bytes(cid * CHUNK, CHUNK)
            if slot < res.nr_ssd2dev:
                assert direct[slot * CHUNK:(slot + 1) * CHUNK] == want
            else:
                assert wb[slot * CHUNK:(slot + 1) * CHUNK] == want
        got[name] = list(res.chunk_ids)
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# the residency probe of real files
# ---------------------------------------------------------------------------

def _warm(path):
    with open(path, "rb") as f:
        while f.read(1 << 20):
            pass


def test_residency_probe_matches_reference_warm_and_cold(data_file):
    spans = [(i * CHUNK, CHUNK) for i in range(64)] + [(100, 5000)]
    _warm(data_file)
    with teng.PlainSource(data_file) as mine, \
            jeng.PlainSource(data_file) as ref:
        warm = mine.residency(spans)
        assert [round(c, 6) for c, _h in warm] == \
            [round(c, 6) for c, _h in ref.residency(spans)]
        assert all(c == 1.0 for c, _h in warm)
        assert mine.cached_fraction(0, 4 << 20) == \
            ref.cached_fraction(0, 4 << 20) == 1.0
        # the batched probe equals the scalar one, span by span
        assert [c for c, _h in warm] == \
            [mine.cached_fraction(o, n) for o, n in spans]
    drop_page_cache(data_file)
    with teng.PlainSource(data_file) as mine, \
            jeng.PlainSource(data_file) as ref:
        cold = [c for c, _h in mine.residency(spans)]
        if any(cold):
            pytest.skip("the page cache kept the file (fadvise ignored)")
        assert cold == [c for c, _h in ref.residency(spans)]
        assert all(h == 0.0 for _c, h in mine.residency(spans))


@pytest.mark.skipif(not os.access("/proc/kpageflags", os.R_OK),
                    reason="/proc/kpageflags is not readable here")
def test_dirty_pages_detected_via_kpageflags(tmp_path):
    """Pages written through the page cache and not yet written back read
    as dirty, so they feed hot_fraction without a hint, in both
    packages."""
    path = str(tmp_path / "d.bin")
    with open(path, "wb") as f:
        f.write(b"\0" * (1 << 20))
        f.flush()
        os.fsync(f.fileno())
    for mod in (teng, jeng):
        with mod.PlainSource(path) as src:
            clean = src.hot_fraction(0, 1 << 20)
            fd = os.open(path, os.O_WRONLY)
            os.pwrite(fd, b"x" * (64 << 10), 0)
            os.close(fd)
            dirty = src.hot_fraction(0, 1 << 20)
            res = src.residency([(0, 64 << 10), (512 << 10, 64 << 10)])
        assert dirty > clean and dirty > 0.0, mod.__name__
        assert res[0][1] > 0.0
        os.fsync(os.open(path, os.O_RDONLY))


def test_warm_file_reads_write_back_cold_reads_direct(data_file):
    """On a real file: warm in the page cache every chunk goes
    write-back, cold every chunk goes direct, the bytes the same, as the
    reference's."""
    ids = list(range(16))
    for warm in (True, False):
        if warm:
            _warm(data_file)
        else:
            drop_page_cache(data_file)
        out = {}
        for name, p in PKGS.items():
            with p.eng.open_source(data_file) as src:
                if not warm and src.cached_fraction(0, src.size) > 0.5:
                    pytest.skip("the page cache kept the file")
                res, data = _run_copy(p, src, ids)
            out[name] = (res.nr_ssd2dev, res.nr_ram2dev)
            assert data == tfake.expected_bytes(0, 16 * CHUNK)
        assert out["torch"] == out["jax"]
        assert out["torch"] == ((0, 16) if warm else (16, 0))


def test_arbitration_default_is_on_as_the_reference(data_file):
    """The port's default is the reference's (on): a warm file reads
    write-back through both packages unless arbitration is turned off."""
    import importlib
    tconfig_mod = importlib.import_module("nvme_strom_tpu_torch.config")
    assert tconfig_mod._VARS["cache_arbitration"].default is True
    tcfg.restore({**tcfg.snapshot(), "cache_arbitration": True})
    _warm(data_file)
    for p in PKGS.values():
        with p.eng.open_source(data_file) as src:
            res, data = _run_copy(p, src, [0, 1, 2])
        assert (res.nr_ssd2dev, res.nr_ram2dev) == (0, 3)
        assert data == tfake.expected_bytes(0, 3 * CHUNK)


def _blind_mincore(self, lo, end):
    """mincore(2) as a probe that cannot see an eviction answers."""
    if self._map() is None or end <= lo:
        return None
    return b"\x01" * max((end - lo + 4095) // 4096, 1)


def test_blind_probe_keeps_every_chunk_direct(data_file, monkeypatch):
    """Where mincore(2) still reports a dropped page resident, the first
    fully resident task checks the probe once, finds it blind, and every
    task of the Session on that device stays direct (nr_arb_blind counts
    them); a forced verdict is no kernel probe and still arbitrates."""
    from nvme_strom_tpu_torch.stats import stats
    monkeypatch.setattr(teng._FileMember, "_mincore", _blind_mincore)
    checks = []
    real = teng._FileMember.probe_sees_eviction
    monkeypatch.setattr(teng._FileMember, "probe_sees_eviction",
                        lambda self: checks.append(1) or real(self))
    before = stats.snapshot().get("nr_arb_blind", 0)
    p = PKGS["torch"]
    with teng.Session() as sess, teng.open_source(data_file) as src:
        for ids in ([0, 1, 2], [3, 4]):
            handle, buf = sess.alloc_dma_buffer(len(ids) * CHUNK)
            res = sess.memcpy_ssd2ram(src, handle, ids, CHUNK)
            sess.memcpy_wait(res.dma_task_id)
            assert (res.nr_ssd2dev, res.nr_ram2dev) == (len(ids), 0)
            assert bytes(buf.view()[:len(ids) * CHUNK]) == \
                tfake.expected_bytes(ids[0] * CHUNK, len(ids) * CHUNK)
            sess.unmap_buffer(handle)
            buf.close()
        assert sess._probe_sighted == {os.stat(data_file).st_dev: False}
    assert checks == [1]
    assert stats.snapshot().get("nr_arb_blind", 0) - before == 2
    forced = tfake.FakeNvmeSource(data_file, force_cached_fraction=1.0)
    try:
        res, _ = _run_copy(p, forced, [0, 1])
    finally:
        forced.close()
    assert (res.nr_ssd2dev, res.nr_ram2dev) == (0, 2)


def test_probe_sees_eviction_agrees_with_a_whole_file_drop(data_file):
    """The one-page check answers as dropping the whole file does: where
    a dropped file reads cold it sees the eviction, where it still reads
    resident it is blind."""
    drop_page_cache(data_file)
    with teng.PlainSource(data_file) as src:
        host_sees = src.cached_fraction(0, src.size) < 1.0
    _warm(data_file)
    with teng.PlainSource(data_file) as src:
        assert src.probe_file().probe_sees_eviction() is host_sees


# ---------------------------------------------------------------------------
# a write-back tail through the staging pipeline and the one-call load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("landing", ["auto", "staged"])
def test_staging_lands_a_write_back_tail_by_chunk_ids(data_file, landing):
    """Mixed direct and write-back chunks through the pipeline: each slot
    of the destination holds the result's chunk_ids entry.  The staged
    ring lands them in the request's order (a repeated chunk too); the
    host's zero-copy landing in the engine's, write-back chunks last."""
    tcfg.set("landing", landing)
    src = tfake.FakeNvmeSource(data_file, force_cached_fraction=0.0)
    for cid in (1, 6, 9, 15):
        src.hint_hot_range(cid * CHUNK + 17, 3)
    ids = list(range(16)) if landing == "auto" else \
        [2, 1, 6, 6, 0, 9, 15, 3, 4, 5, 8, 7, 1, 10, 11, 12]
    n = len(ids)
    with teng.Session(device="cpu") as sess:
        handle = registry.map_device_memory(n * CHUNK, device="cpu")
        try:
            with StagingPipeline(sess, n_buffers=2,
                                 staging_bytes=4 * CHUNK) as pipe:
                res = pipe.memcpy_ssd2dev(src, handle, ids, CHUNK)
            out = registry.get(handle).tensor
            assert res.nr_ram2dev == sum(c in (1, 6, 9, 15) for c in ids)
            assert res.landing == ("direct" if landing == "auto"
                                   else "staged")
            assert (res.chunk_ids == ids) == (landing == "staged")
            assert chunks_mismatch(out, src, res.chunk_ids, CHUNK) is None
        finally:
            registry.unmap(handle)
    src.close()


def test_request_order_runs_merge_and_repeat():
    from nvme_strom_tpu_torch.hbm.staging import _request_order_runs
    c = CHUNK
    assert _request_order_runs([0, 2, 3, 1], [0, 1, 2, 3], c) == \
        [(0, 0, c), (c, 2 * c, 2 * c), (3 * c, c, c)]
    assert _request_order_runs([5, 6, 5], [5, 5, 6], c) == \
        [(0, 0, c), (c, 2 * c, c), (2 * c, c, c)]


def test_one_call_load_restores_source_order(data_file):
    """The one-call load returns the file's bytes whatever arbitration
    reordered (slot order put back on the device).  The reference's
    returns the slots as landed: a write-back chunk amid direct ones
    comes back out of place."""
    import jax
    want = np.frombuffer(tfake.expected_bytes(0, 4 << 20), np.uint8)
    src = tfake.FakeNvmeSource(data_file, force_cached_fraction=0.0)
    src.hint_hot_range(3 * CHUNK, 10)
    try:
        got = load_file_to_device(src, chunk_size=CHUNK, device="cpu",
                                  staging_bytes=16 * CHUNK)
    finally:
        src.close()
    np.testing.assert_array_equal(got.numpy(), want)
    jsrc = jfake.FakeNvmeSource(data_file, force_cached_fraction=0.0)
    jsrc.hint_hot_range(3 * CHUNK, 10)
    try:
        ref = np.asarray(jstaging.load_file_to_device(
            jsrc, chunk_size=CHUNK, staging_bytes=16 * CHUNK,
            device=jax.devices("cpu")[0]))
    finally:
        jsrc.close()
    assert not np.array_equal(ref, want)
    np.testing.assert_array_equal(ref[:3 * CHUNK], want[:3 * CHUNK])
    np.testing.assert_array_equal(ref[3 * CHUNK:15 * CHUNK],
                                  want[4 * CHUNK:16 * CHUNK])
