"""The zero-copy landing of the PyTorch port (``hbm/staging.py``
``plan_landing`` and the pipeline's direct and staged routes) against the
JAX package's on the same files: the counterparts of the 7 tests of
``tests/test_landing.py`` — an eligible command lands direct and is
counted, a partial tail rides the direct route, ``landing=staged`` pins
the ring, a fallback counts its reason, a non-CPU destination is
``backend``, a landing buffer's fixed registration survives a lane
scale-out mid-command, and direct and staged land the same bytes under
transient EIO.

What is compared: landed bytes (exact), the route each command took, and
the moves of the ``nr_landing_*`` counters.  The port's direct route
exists for a CPU destination only (a CUDA destination pays its
host→device copy either way), as the reference's for a CPU array."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.hbm as jhbm
import nvme_strom_tpu.testing.fake as jfake
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.stats import stats as jstats
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.hbm as thbm
import nvme_strom_tpu_torch.testing.fake as tfake
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing import reset_residency

CHUNK = 256 << 10
_COUNTED = ("nr_landing_direct", "nr_landing_staged", "nr_landing_fallback",
            "nr_landing_fallback_alignment", "nr_landing_fallback_dtype",
            "nr_landing_fallback_backend")


def _jax_map(reg, n, dtype=np.uint8):
    return reg.map_device_memory(n // np.dtype(dtype).itemsize,
                                 dtype=jnp.dtype(dtype))


def _torch_map(reg, n, dtype=np.uint8):
    tdt = {np.uint8: torch.uint8, np.int32: torch.int32}[dtype]
    return reg.map_device_memory(n // np.dtype(dtype).itemsize, dtype=tdt,
                                 device="cpu")


PKGS = {
    "jax": types.SimpleNamespace(
        eng=jeng, hbm=jhbm, fake=jfake, cfg=jcfg, map=_jax_map,
        bytes=lambda reg, h: np.asarray(reg.get(h).array).tobytes(),
        dtype=lambda d: jnp.dtype(d),
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters),
        session=lambda: jeng.Session()),
    "torch": types.SimpleNamespace(
        eng=teng, hbm=thbm, fake=tfake, cfg=tcfg, map=_torch_map,
        bytes=lambda reg, h: reg.get(h).tensor.numpy().tobytes(),
        dtype=lambda d: {np.uint8: torch.uint8, np.int32: torch.int32}[d],
        counters=tstats.snapshot,
        session=lambda: teng.Session(device="cpu")),
}


@pytest.fixture(autouse=True)
def _configs():
    snap, jsnap = tcfg.snapshot(), jcfg.snapshot()
    reset_residency()
    yield
    tcfg.restore(snap)
    jcfg.restore(jsnap)


def _delta(p, before):
    after = p.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in _COUNTED}


def _pipeline_load(p, sess, reg, source, nbytes, chunk, dtype=np.uint8):
    handle = p.map(reg, nbytes, dtype)
    try:
        with p.hbm.StagingPipeline(sess, hbm_registry=reg) as pipe:
            res = pipe.memcpy_ssd2dev(
                source, handle, list(range((nbytes + chunk - 1) // chunk)),
                chunk, device_dtype=p.dtype(dtype))
        got = p.bytes(reg, handle)
    finally:
        reg.unmap(handle)
    return res, got


def _both(fn):
    out = {name: fn(p) for name, p in PKGS.items()}
    assert out["torch"] == out["jax"], out
    return out["torch"]


def _load_plain(p, path, size):
    before = p.counters()
    reg = p.hbm.HbmRegistry()
    with p.session() as sess, p.eng.PlainSource(path) as src:
        res, got = _pipeline_load(p, sess, reg, src, size, CHUNK)
    return res.landing, res.nr_chunks, got, _delta(p, before)


def test_eligible_command_lands_direct(tmp_path):
    """``landing=auto``, a CPU destination the command covers exactly: the
    direct route, counted, with the file's bytes."""
    size = 4 * CHUNK
    path = str(tmp_path / "d.bin")
    tfake.make_test_file(path, size)
    landing, _n, got, d = _both(lambda p: _load_plain(p, path, size))
    assert landing == "direct"
    with open(path, "rb") as f:
        assert got == f.read()
    assert d["nr_landing_direct"] == 1 and d["nr_landing_staged"] == 0
    assert d["nr_landing_fallback"] == 0


def test_partial_tail_rides_the_direct_path(tmp_path):
    """A tail shorter than a chunk lands as the last slot, direct too."""
    size = 2 * CHUNK + 4096
    path = str(tmp_path / "t.bin")
    tfake.make_test_file(path, size)
    landing, n, got, _d = _both(lambda p: _load_plain(p, path, size))
    assert landing == "direct" and n == 3
    with open(path, "rb") as f:
        assert got == f.read()


def test_landing_config_staged_pins_the_ring(tmp_path):
    """``landing=staged`` is the operator's choice, not a fallback."""
    size = 2 * CHUNK
    path = str(tmp_path / "s.bin")
    tfake.make_test_file(path, size)

    def run(p):
        p.cfg.set("landing", "staged")
        return _load_plain(p, path, size)

    landing, _n, got, d = _both(run)
    assert landing == "staged"
    with open(path, "rb") as f:
        assert got == f.read()
    assert d["nr_landing_staged"] >= 1 and d["nr_landing_fallback"] == 0


def _fallbacks(p, path, size):
    out = []
    reg = p.hbm.HbmRegistry()
    with p.session() as sess, p.eng.PlainSource(path) as src:
        # an oversized destination: the command covers a prefix only
        before = p.counters()
        handle = p.map(reg, size + CHUNK)
        try:
            with p.hbm.StagingPipeline(sess, hbm_registry=reg) as pipe:
                res = pipe.memcpy_ssd2dev(src, handle, [0, 1], CHUNK)
        finally:
            reg.unmap(handle)
        out.append((res.landing, _delta(p, before)))
        # a 2-D destination: a geometry the alias cannot express (the
        # ring lands it row by row)
        before = p.counters()
        if p is PKGS["jax"]:
            import jax
            handle = reg.map_device_memory(
                jax.device_put(jnp.zeros((2, CHUNK), dtype=jnp.uint8)))
        else:
            handle = reg.map_device_memory(
                torch.zeros((2, CHUNK), dtype=torch.uint8))
        try:
            with p.hbm.StagingPipeline(sess, staging_bytes=CHUNK,
                                       hbm_registry=reg) as pipe:
                res = pipe.memcpy_ssd2dev(src, handle, [0, 1], CHUNK)
            got = p.bytes(reg, handle)
        finally:
            reg.unmap(handle)
        out.append((res.landing, _delta(p, before), got))
    return out


def test_fallback_reasons_are_attributed(tmp_path):
    """An ineligible command falls back to the ring with its cause
    counted: a destination it does not cover exactly is ``alignment``, a
    geometry the alias cannot express ``dtype``."""
    size = 2 * CHUNK
    path = str(tmp_path / "f.bin")
    tfake.make_test_file(path, size)
    (l1, d1), (l2, d2, got) = _both(lambda p: _fallbacks(p, path, size))
    assert l1 == l2 == "staged"
    assert d1["nr_landing_fallback"] == d1["nr_landing_fallback_alignment"] \
        == 1
    assert d2["nr_landing_fallback"] == d2["nr_landing_fallback_dtype"] == 1
    with open(path, "rb") as f:
        assert got == f.read()


def test_plan_landing_backend_reason():
    """A destination off the CPU routes staged with reason ``backend``: a
    card pays its host→device copy either way, and the ring overlaps it
    with the reads."""
    class _Dev:
        platform = "tpu"

    class _Arr:
        ndim, dtype, nbytes = 1, np.dtype(np.uint8), CHUNK

        def devices(self):
            return [_Dev()]

    class _JHbm:
        array = _Arr()

    class _THbm:
        tensor = torch.empty(CHUNK, dtype=torch.uint8, device="meta")
        nbytes = CHUNK

    want = jhbm.plan_landing(_JHbm(), [0], CHUNK, 0, jnp.uint8, CHUNK)
    got = thbm.plan_landing(_THbm(), [0], CHUNK, 0, torch.uint8, CHUNK)
    assert got == want == ("staged", "backend")


class _DirectStripe:
    """Fresh members are page-cached: this verdict keeps every chunk on
    the direct (native) path."""

    def cached_fraction(self, offset, length):
        return 0.0


def _expected_stream(paths, stripe_chunk):
    parts = [open(p, "rb").read() for p in paths]
    nm = len(parts)
    total = sum(len(p) for p in parts)
    out = bytearray(total)
    for i in range(total // stripe_chunk):
        m, row = i % nm, i // nm
        out[i * stripe_chunk:(i + 1) * stripe_chunk] = \
            parts[m][row * stripe_chunk:(row + 1) * stripe_chunk]
    return bytes(out)


def _scale_out(p, paths, stripe, total):
    cls = type("DS", (_DirectStripe, p.eng.StripedSource), {})
    p.cfg.set("cache_arbitration", False)
    src = cls(paths, stripe_chunk_size=stripe)
    reg = p.hbm.HbmRegistry()
    sess = p.session()
    try:
        if sess._native is None:
            pytest.skip("native engine not active")
        lanes0 = sess._native.nlanes()
        handle = p.map(reg, total)
        try:
            with p.hbm.StagingPipeline(sess, hbm_registry=reg) as pipe:
                res = pipe.memcpy_ssd2dev(
                    src, handle, list(range(total // stripe)), stripe)
            swapped = (sess._native.nlanes(), len(sess._old_engines) >= 1)
            fixed = sess.backend_name != "io_uring" or any(
                slot >= 0 for slot, _b, _cb in sess._fixed_regs.values())
            got = p.bytes(reg, handle)
        finally:
            reg.unmap(handle)
    finally:
        src.close()
        sess.close()
    return lanes0, res.landing, swapped, fixed, got, sess._old_engines


def test_fixed_registration_survives_lane_scale_out(tmp_path):
    """The first striped submit of a direct command swaps the native
    engine mid-command (one lane, then one a member): the landing
    buffer's fixed registration carries to the new engine, the bytes are
    the stripe's, and close drains the retired engine."""
    nmem, msize, stripe = 4, 512 << 10, 128 << 10
    paths = []
    for m in range(nmem):
        p = str(tmp_path / f"lm{m}.bin")
        tfake.make_test_file(p, msize, seed=m)
        paths.append(p)
    total = nmem * msize
    lanes0, landing, swapped, fixed, got, old = \
        _both(lambda p: _scale_out(p, paths, stripe, total))
    assert lanes0 == 1 and landing == "direct"
    assert swapped == (nmem, True) and fixed
    assert got == _expected_stream(paths, stripe)
    assert old == []


def test_direct_vs_staged_identity_under_transient_faults(tmp_path):
    """EIO every 3rd read: the retries heal both routes to the same
    bytes, the file's, in both packages."""
    size = 1 << 20
    path = str(tmp_path / "fault.bin")
    tfake.make_test_file(path, size)

    def load(p, mode):
        p.cfg.set("landing", mode)
        src = p.fake.FakeNvmeSource(
            path, fault_plan=p.fake.FaultPlan(fail_every_nth=3),
            force_cached_fraction=0.0)
        reg = p.hbm.HbmRegistry()
        try:
            with p.session() as sess:
                res, got = _pipeline_load(p, sess, reg, src, size, CHUNK)
        finally:
            src.close()
        return res.landing, got

    out = _both(lambda p: (load(p, "staged"), load(p, "direct")))
    (ls, staged), (ld, direct) = out
    assert (ls, ld) == ("staged", "direct") and direct == staged
    with open(path, "rb") as f:
        assert direct == f.read()


def test_int32_destination_lands_direct(tmp_path):
    """A 1-D int32 destination whose chunks are whole elements lands
    direct and aliases the landed bytes as int32 in both packages."""
    size = 4 * CHUNK
    path = str(tmp_path / "i.bin")
    tfake.make_test_file(path, size)

    def run(p):
        reg = p.hbm.HbmRegistry()
        with p.session() as sess, p.eng.PlainSource(path) as src:
            res, got = _pipeline_load(p, sess, reg, src, size, CHUNK,
                                      dtype=np.int32)
        return res.landing, got

    landing, got = _both(run)
    assert landing == "direct"
    with open(path, "rb") as f:
        assert got == f.read()
