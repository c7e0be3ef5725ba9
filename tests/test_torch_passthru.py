"""The NVMe passthrough lane of the PyTorch port (``blockmap.py``, the
engine's passthrough rung and split, ``testing/passthru_emu.py``,
``testing/passthru_gate.py``) against the JAX package: the counterparts
of the 15 tests of ``tests/test_passthru.py`` (the blockmap against the
emulator's SLBA/NLB oracle, each refusing FIEMAP flag, alignment shaving,
holes, the generation cache, the write-back invalidation, the probe's
refusal reasons, the ladder's counted refusal, the disabled reason, the
hedge win's lane exit, fail-stop health, autotuner epochs, zero counters
when pinned, SLBA drift, command validation), each run through both
packages on the same bytes, plus the 72-byte commands, the emulator's
extents, seeded random extent maps, the gate's layouts' counter deltas,
the flagged native submit, and the NLB cap the port adds.

The JAX oracle comes from its pure functions and its python pool path
(``io_backend="python"``): nothing here needs the JAX package's native
library.  What is compared: resolved runs, command bytes and extents
(exact), landed bytes (exact), counter deltas."""

import errno
import os
import random
import shutil
import types

import pytest
import torch

import nvme_strom_tpu.blockmap as jbm
import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.testing.chaos as jchaos
import nvme_strom_tpu.testing.fake as jfake
import nvme_strom_tpu.testing.passthru_emu as jemu
from nvme_strom_tpu.api import STAT_FIELDS
from nvme_strom_tpu.api import StromError as JStromError
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.stats import stats as jstats
import nvme_strom_tpu_torch._native as tnat
import nvme_strom_tpu_torch.blockmap as tbm
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.testing.chaos as tchaos
import nvme_strom_tpu_torch.testing.fake as tfake
import nvme_strom_tpu_torch.testing.passthru_emu as temu
from nvme_strom_tpu_torch.api import PASSTHRU_COUNTERS
from nvme_strom_tpu_torch.api import StromError as TStromError
from nvme_strom_tpu_torch.config import ConfigError
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.hbm.staging import load_file_to_device
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing import passthru_gate, reset_residency

pytestmark = pytest.mark.passthru

CHUNK = 64 << 10
LBA = 512

PKGS = {
    "jax": types.SimpleNamespace(
        bm=jbm, eng=jeng, fake=jfake, emu=jemu, chaos=jchaos, cfg=jcfg,
        err=JStromError,
        counters=lambda: dict(jstats.snapshot(reset_max=False).counters),
        session=lambda: jeng.Session(io_backend="python")),
    "torch": types.SimpleNamespace(
        bm=tbm, eng=teng, fake=tfake, emu=temu, chaos=tchaos, cfg=tcfg,
        err=TStromError, counters=tstats.snapshot,
        session=lambda: teng.Session(device="cpu", io_backend="python")),
}

_PT_KEYS = ("nr_passthru_dma", "bytes_passthru",
            "nr_passthru_refused_extent", "nr_passthru_fallback")


@pytest.fixture(autouse=True)
def _configs():
    snap, jsnap = tcfg.snapshot(), jcfg.snapshot()
    reset_residency()
    yield
    tcfg.restore(snap)
    jcfg.restore(jsnap)
    reset_residency()


def _delta(before, after, key):
    return after.get(key, 0) - before.get(key, 0)


def _pt_delta(before, after):
    return {k: _delta(before, after, k) for k in _PT_KEYS}


def _base_config(cfg):
    cfg.set("cache_bytes", 0)
    cfg.set("cache_arbitration", False)
    cfg.set("dma_max_size", CHUNK)
    cfg.set("hedge_policy", "off")
    cfg.set("autotune", False)


def _read_pass(sess, src, nchunks, chunk=CHUNK):
    handle, buf = sess.alloc_dma_buffer(nchunks * chunk)
    try:
        res = sess.memcpy_ssd2ram(src, handle, list(range(nchunks)), chunk)
        sess.memcpy_wait(res.dma_task_id, timeout=60.0)
        return bytes(buf.view()[:nchunks * chunk])
    finally:
        sess.unmap_buffer(handle)


def _register_both(path, extents):
    for p in PKGS.values():
        p.bm.register_synthetic(path, [p.bm.Extent(*e) for e in extents])


def _unregister_both(path):
    for p in PKGS.values():
        p.bm.unregister_synthetic(path)


def _splits(path, off, length, lba=LBA):
    """Both packages' resolve_split and resolve of one span, asserted
    equal; returns the port's."""
    got = {n: (p.bm.resolve_split(path, off, length, lba),
               p.bm.resolve(path, off, length, lba))
           for n, p in PKGS.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


# ---------------------------------------------------------------------------
# the wire format and the emulator's extents
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nsid,slba,nlb0,data_len,opcode", [
    (1, 0, 0, 512, 0x02),
    (1, 1, 7, 4096, 0x02),
    (7, 0x1_2345_6789, 0xFFFF, 32 << 20, 0x02),
    (1, (1 << 48) - 1, 255, 1 << 17, 0x02),
    (2, 4096, 15, 8192, 0x01),
    (0xFFFFFFFF, 0xFFFF_FFFF_FFFF, 0, 512, 0x02),
])
def test_pack_uring_cmd_bytes_equal(nsid, slba, nlb0, data_len, opcode):
    kw = dict(nsid=nsid, slba=slba, nlb0=nlb0, data_len=data_len,
              opcode=opcode)
    mine = temu.pack_uring_cmd(**kw)
    assert len(mine) == 72
    assert mine == jemu.pack_uring_cmd(**kw)


@pytest.mark.parametrize("size,frag,gap,inel,shift", [
    (4 * CHUNK, 4, None, (), 9),
    (8 * CHUNK, 4, None, ((CHUNK, 4096, 0x800), (5 * CHUNK + 512, 8192,
                                                 0x200)), 9),
    (3 * CHUNK + 4096, 7, 8192, ((100, 300, 0x100),), 12),
    (CHUNK, 64, 0, ((0, CHUNK, 0x2),), 9),
])
def test_provision_extents_and_image_match_reference(tmp_path, size, frag,
                                                     gap, inel, shift):
    """The same file provisioned onto each package's emulator gives the
    same extent map and the same image bytes."""
    path = str(tmp_path / "prov.bin")
    tfake.make_test_file(path, size, seed=3)
    got = {}
    for name, p in PKGS.items():
        img = str(tmp_path / f"{name}.img")
        emu = p.emu.PassthruEmulator(img, lba_shift=shift)
        try:
            exts = emu.provision(path, frag=frag, gap=gap, ineligible=inel)
            maps = [tuple(e.__dict__.values())
                    for e in p.bm.map_file(path)]
        finally:
            emu.close()
        with open(img, "rb") as f:
            got[name] = ([tuple(e.__dict__.values()) for e in exts], maps,
                         f.read())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == got["torch"][1]


def test_resolve_split_matches_emulator_oracle(tmp_path):
    """Every device run resolve_split emits round-trips through the
    emulator's wire format to exactly the file bytes it claims, in each
    package, and the two packages' runs agree."""
    size = 4 * CHUNK
    path = str(tmp_path / "oracle.bin")
    tfake.make_test_file(path, size)
    runs = {}
    for name, p in PKGS.items():
        emu = p.emu.PassthruEmulator(str(tmp_path / f"{name}.img"))
        try:
            emu.provision(path, frag=4)
            runs[name] = p.bm.resolve_split(path, 0, size, emu.lba_size)
            assert sum(ln for _fo, ln, _d in runs[name]) == size
            assert all(dev is not None for _fo, _ln, dev in runs[name])
            for fo, ln, dev in runs[name]:
                buf = bytearray(ln)
                cmd = p.emu.pack_uring_cmd(
                    nsid=emu.nsid, slba=dev >> emu.lba_shift,
                    nlb0=(ln >> emu.lba_shift) - 1, data_len=ln)
                assert emu.execute(cmd, memoryview(buf)) == (path, fo)
                assert bytes(buf) == tfake.expected_bytes(fo, ln)
        finally:
            emu.close()
    assert runs["torch"] == runs["jax"]


@pytest.mark.parametrize("flag", [0x2, 0x4, 0x8, 0x80, 0x100, 0x200, 0x400,
                                  0x800])
def test_resolve_split_refuses_each_ineligible_flag(flag):
    """Each FIEMAP flag in the refusal mask forces its extent, and only
    its extent, off the passthrough lane."""
    path = "/synthetic/flags.bin"
    _register_both(path, [(0, 1 << 20, CHUNK, 0),
                          (CHUNK, (1 << 20) + CHUNK, CHUNK, flag),
                          (2 * CHUNK, (1 << 20) + 2 * CHUNK, CHUNK, 0)])
    try:
        runs, whole = _splits(path, 0, 3 * CHUNK)
        assert [(fo, ln, dev is not None) for fo, ln, dev in runs] == [
            (0, CHUNK, True), (CHUNK, CHUNK, False),
            (2 * CHUNK, CHUNK, True)]
        assert whole is None
        assert _splits(path, 0, CHUNK)[1] is not None
    finally:
        _unregister_both(path)


def test_resolve_split_alignment_shaving():
    """Unaligned heads and tails of an eligible extent ride O_DIRECT at
    LBA boundaries in file space; a device-misaligned extent is refused
    whole."""
    path = "/synthetic/align.bin"
    _register_both(path, [(0, 4096, 8192, 0)])
    try:
        assert _splits(path, 100, 2000)[0] == [
            (100, 412, None), (512, 1536, 4096 + 512), (2048, 52, None)]
        _register_both(path, [(0, 4096 + 7, 8192, 0)])
        assert _splits(path, 0, 8192)[0] == [(0, 8192, None)]
    finally:
        _unregister_both(path)


def test_resolve_split_holes_ride_odirect():
    path = "/synthetic/hole.bin"
    _register_both(path, [(0, 1 << 16, 4096, 0),
                          (8192, (1 << 16) + 8192, 4096, 0)])
    try:
        runs, whole = _splits(path, 0, 16384)
        assert runs == [(0, 4096, 1 << 16), (4096, 4096, None),
                        (8192, 4096, (1 << 16) + 8192), (12288, 4096, None)]
        assert whole is None
    finally:
        _unregister_both(path)


@pytest.mark.parametrize("seed", range(5))
def test_resolve_split_random_maps_match_reference(seed):
    """Seeded random extent maps (holes, every flag, misaligned physical
    and logical bounds) and random spans at 512 B and 4 KiB LBAs: the two
    blockmaps agree on every run and every whole-span verdict."""
    rng = random.Random(seed)
    flags = [0, 0, 0, 0x1, 0x2, 0x4, 0x8, 0x80, 0x100, 0x200, 0x400, 0x800]
    exts, pos = [], 0
    for _ in range(rng.randint(1, 12)):
        pos += rng.choice([0, 0, 512, 4096, rng.randint(1, 9000)])
        ln = rng.choice([4096, 8192, CHUNK, rng.randint(1, 3 * CHUNK)])
        phys = rng.randint(1, 1 << 30) * rng.choice([1, 512, 4096])
        exts.append((pos, phys, ln, rng.choice(flags)))
        pos += ln
    path = f"/synthetic/random{seed}.bin"
    _register_both(path, exts)
    try:
        for _ in range(40):
            off = rng.randint(0, pos)
            length = rng.randint(0, pos - off + 4096)
            for lba in (512, 4096):
                runs, _whole = _splits(path, off, length, lba)
                assert sum(ln for _f, ln, _d in runs) == max(length, 0)
    finally:
        _unregister_both(path)


# ---------------------------------------------------------------------------
# the generation cache and the write-back invalidation
# ---------------------------------------------------------------------------

def _fake_walk(path):
    """A deterministic FIEMAP walk: one extent of the file's size."""
    st = os.stat(path)
    return [tbm.Extent(0, (st.st_ino % 4096 + 1) << 20, st.st_size, 1)]


@pytest.fixture()
def fake_fiemap(monkeypatch):
    """Both blockmaps walk the fake FIEMAP above (each its own Extent)."""
    for p in PKGS.values():
        mod = p.bm
        monkeypatch.setattr(
            mod, "_fiemap_ioctl",
            lambda path, mod=mod: [mod.Extent(*e.__dict__.values())
                                   for e in _fake_walk(path)])


def test_generation_cache_and_out_of_band_writer(tmp_path, fake_fiemap):
    """A second map_file is served from the generation cache; an
    out-of-band rewrite changes the key and walks again; invalidate()
    drops the entry and counts once: the same counts in both packages."""
    out = {}
    for name, p in PKGS.items():
        path = str(tmp_path / f"gen_{name}.bin")
        tfake.make_test_file(path, CHUNK)
        p.bm.invalidate(path)
        steps = []
        before = p.counters()
        assert p.bm.map_file(path) is not None       # cold: walks
        assert p.bm.map_file(path) is not None       # cached
        mid = p.counters()
        steps.append(_delta(before, mid, "nr_blockmap_resolve"))
        os.truncate(path, CHUNK // 2)                # out-of-band writer
        assert p.bm.map_file(path)[0].length == CHUNK // 2
        after = p.counters()
        steps.append(_delta(mid, after, "nr_blockmap_resolve"))
        p.bm.invalidate(path)
        end = p.counters()
        steps.append(_delta(after, end, "nr_blockmap_invalidate"))
        p.bm.invalidate(path)                        # gone: no count
        steps.append(_delta(end, p.counters(), "nr_blockmap_invalidate"))
        out[name] = steps
    assert out["torch"] == out["jax"] == [1, 1, 1, 0]


def test_real_fiemap_walk(tmp_path):
    """On this filesystem the port's walk of a real fsync'd file maps it
    from offset 0, in order, to the LAST extent, covering every byte; the
    JAX package sees the same first extent (None in both where FIEMAP does
    not answer)."""
    path = str(tmp_path / "real.bin")
    with open(path, "wb") as f:
        for k in range(16):
            f.write(tfake.expected_bytes(k * CHUNK, CHUNK))
            f.flush()
            os.fsync(f.fileno())
    for p in PKGS.values():
        p.bm.invalidate(path)
    mine, ref = tbm.map_file(path), jbm.map_file(path)
    assert (mine is None) == (ref is None) == (not tbm.fiemap_supported(path))
    if mine is None:
        assert tbm.fragmentation(path) is None
        return
    assert tuple(mine[0].__dict__.values()) == tuple(ref[0].__dict__.values())
    assert mine[0].logical == 0 and mine[-1].flags & 0x1
    pos = 0
    for e in mine:
        assert e.logical == pos and e.length > 0
        pos += e.length
    assert pos >= 16 * CHUNK
    n, total, eligible = tbm.fragmentation(path)
    assert (n, total) == (len(mine), pos) and eligible <= total


def test_fiemap_records_are_56_bytes(tmp_path, monkeypatch):
    """The kernel answers FS_IOC_FIEMAP with 56-byte ``fiemap_extent``
    records.  The port reads each one; the JAX package's 52-byte record
    (``"=QQQQQIII"``) reads the first right and misreads every later one
    (a fault of the reference, ROADMAP Queue C, slice 17)."""
    import fcntl
    import struct
    truth = [(0, 1 << 20, 4096, 0), (4096, 8 << 20, 8192, 0x800),
             (12288, 16 << 20, 4096, 0x1)]

    def kernel(fd, req, buf):
        assert req == 0xC020660B
        struct.pack_into("=I", buf, 20, len(truth))   # fm_mapped_extents
        for i, (lo, ph, ln, fl) in enumerate(truth):
            struct.pack_into("=QQQQQIIII", buf, 32 + 56 * i, lo, ph, ln,
                             0, 0, fl, 0, 0, 0)
        return 0

    path = str(tmp_path / "fm.bin")
    tfake.make_test_file(path, 16384)
    monkeypatch.setattr(fcntl, "ioctl", kernel)
    mine = [tuple(e.__dict__.values()) for e in tbm._fiemap_ioctl(path)]
    ref = [tuple(e.__dict__.values()) for e in jbm._fiemap_ioctl(path)]
    assert mine == truth
    assert ref[0] == truth[0] and ref[1] != truth[1]


def test_writeback_invalidates_blockmap(tmp_path, fake_fiemap):
    """memcpy_ram2ssd drops the sink's cached extent maps at the tiers'
    invalidation site, in both packages."""
    out = {}
    for name, p in PKGS.items():
        _base_config(p.cfg)
        path = str(tmp_path / f"wb_{name}.bin")
        tfake.make_test_file(path, 2 * CHUNK)
        assert p.bm.map_file(path) is not None       # populate the cache
        before = p.counters()
        with p.session() as sess:
            handle, buf = sess.alloc_dma_buffer(CHUNK)
            try:
                buf.view()[:CHUNK] = b"\xa5" * CHUNK
                with p.eng.open_source(path, writable=True) as sink:
                    res = sess.memcpy_ram2ssd(sink, handle, [0], CHUNK)
                    sess.memcpy_wait(res.dma_task_id)
            finally:
                sess.unmap_buffer(handle)
        out[name] = _delta(before, p.counters(), "nr_blockmap_invalidate")
    assert out["torch"] == out["jax"] >= 1


# ---------------------------------------------------------------------------
# the probe and the ladder's refusal reasons
# ---------------------------------------------------------------------------

def test_probe_refusal_reasons(monkeypatch):
    import nvme_strom_tpu._native as jnat
    assert tnat.PASSTHRU_REASONS == jnat.PASSTHRU_REASONS
    monkeypatch.delenv("NSTPU_DISABLE_PASSTHRU", raising=False)
    monkeypatch.delenv("NSTPU_PASSTHRU_DEV", raising=False)
    assert tnat.passthru_probe("/nonexistent/ng0n1") == -2      # nodev
    assert tnat.passthru_probe(None) == -2
    assert tnat.passthru_refusal("/nonexistent/ng0n1") == -2
    monkeypatch.setenv("NSTPU_DISABLE_PASSTHRU", "1")
    assert tnat.passthru_probe("/nonexistent/ng0n1") == -1      # disabled
    assert tnat.PASSTHRU_REASONS[-1] == "disabled"
    assert tnat.PASSTHRU_REASONS[-2] == "nodev"


def _no_device(monkeypatch):
    """No char device, whatever the host has: the glob matches nothing."""
    monkeypatch.delenv("NSTPU_PASSTHRU_DEV", raising=False)
    monkeypatch.delenv("NSTPU_DISABLE_PASSTHRU", raising=False)
    tcfg.set("passthru_dev_glob", "/nonexistent/ng*n*")


def test_session_counts_ladder_refusal(monkeypatch):
    """The JAX package's counts: a ladder that held the rung counts why
    it fell (``nodev`` once under ``auto``); demanding the rung with
    ``io_fallback`` counts the fallback and the reason, and the session
    opens on a lower rung."""
    _no_device(monkeypatch)
    _base_config(tcfg)
    tcfg.set("engine_backend", "auto")
    before = tstats.snapshot()
    with teng.Session() as sess:
        assert sess.backend_name in ("io_uring", "threadpool")
        assert sess._pt_channel is None
    mid = tstats.snapshot()
    assert _delta(before, mid, "nr_passthru_refusal_nodev") == 1
    assert _delta(before, mid, "nr_passthru_fallback") == 0
    assert _delta(before, mid, "nr_backend_fallback") == \
        (1 if sess.backend_name == "threadpool" else 0)
    tcfg.set("engine_backend", "passthru")
    with teng.Session() as sess:
        assert sess.backend_name in ("io_uring", "threadpool")
    after = tstats.snapshot()
    assert _delta(mid, after, "nr_passthru_fallback") == 1
    assert _delta(mid, after, "nr_passthru_refusal_nodev") == 1


def test_demanded_rung_without_fallback_raises(monkeypatch):
    """``engine_backend=passthru`` with ``io_fallback`` off raises ENODEV
    on a host without the device (the refusal still counted)."""
    _no_device(monkeypatch)
    tcfg.set("engine_backend", "passthru")
    tcfg.set("io_fallback", False)
    before = tstats.snapshot()
    with pytest.raises(TStromError) as e:
        teng.Session()
    assert e.value.errno == errno.ENODEV
    assert _delta(before, tstats.snapshot(),
                  "nr_passthru_refusal_nodev") == 1


def test_disable_env_counts_disabled_reason(monkeypatch):
    _no_device(monkeypatch)
    monkeypatch.setenv("NSTPU_DISABLE_PASSTHRU", "1")
    _base_config(tcfg)
    tcfg.set("engine_backend", "auto")
    before = tstats.snapshot()
    with teng.Session():
        pass
    after = tstats.snapshot()
    assert _delta(before, after, "nr_passthru_refusal_disabled") == 1
    assert _delta(before, after, "nr_passthru_refusal_nodev") == 0


@pytest.mark.parametrize("io_backend,engine_backend", [
    ("io_uring", "auto"), ("threadpool", "passthru"), ("auto", "uring"),
    ("auto", "threadpool"), ("python", "auto")])
def test_ladder_without_the_rung_probes_nothing(monkeypatch, io_backend,
                                                engine_backend):
    """An explicit io_backend, or engine_backend pinned below the rung:
    no probe, no passthrough counter (the JAX package's guarantee)."""
    _no_device(monkeypatch)
    calls = []
    monkeypatch.setattr(tnat, "passthru_probe",
                        lambda dev: calls.append(dev) or -2)
    tcfg.set("engine_backend", engine_backend)
    before = tstats.snapshot()
    with teng.Session(io_backend=io_backend):
        pass
    after = tstats.snapshot()
    assert calls == []
    assert not {k: _delta(before, after, k) for k in PASSTHRU_COUNTERS
                if _delta(before, after, k)}


# ---------------------------------------------------------------------------
# the fault ladder over the passthrough lane
# ---------------------------------------------------------------------------

def _mirrored_emulated(p, tmp_path, plan, tag):
    paths = []
    for k in range(2):
        a = str(tmp_path / f"{tag}m{2 * k}.bin")
        tfake.make_test_file(a, 4 * CHUNK, seed=50 + k)
        b = str(tmp_path / f"{tag}m{2 * k + 1}.bin")
        shutil.copyfile(a, b)
        paths += [a, b]
    emu = p.emu.PassthruEmulator(str(tmp_path / f"{tag}mirror.img"))
    for q in paths:
        emu.provision(q, frag=2)
    src = p.fake.FakeStripedNvmeSource(paths, CHUNK, fault_plan=plan,
                                       force_cached_fraction=0.0,
                                       mirror="paired")
    emu.attach(src)
    return paths, emu, src


def test_hedge_win_over_passthru_counts_lane_exit(tmp_path):
    """A hedged chunk whose slow primary rode the passthrough lane exits
    it when the hedge leg wins: counted, bytes identical, in both."""
    for name, p in PKGS.items():
        _base_config(p.cfg)
        p.cfg.set("io_retries", 0)
        p.cfg.set("hedge_policy", "fixed")
        p.cfg.set("hedge_ms", 2.0)
        plan = p.fake.FaultPlan(slow_member=0, slow_s=0.1)
        paths, emu, src = _mirrored_emulated(p, tmp_path, plan, name)
        before = p.counters()
        try:
            with p.session() as sess:
                got, total = p.chaos.read_all(sess, src, chunk=CHUNK)
        finally:
            src.close()
            emu.close()
        after = p.counters()
        assert got == tchaos.expected_mirrored_stream(paths, CHUNK)[:total]
        assert _delta(before, after, "nr_hedge_won") >= 1, name
        assert _delta(before, after, "nr_passthru_dma") >= 1, name
        assert _delta(before, after, "nr_passthru_fallback") >= 1, name


def test_failstop_member_health_under_passthru(tmp_path):
    """A fail-stopped member's passthrough reads fall to the mirror rung
    and debit the health machine, in both packages, with equal counts."""
    out = {}
    for name, p in PKGS.items():
        _base_config(p.cfg)
        p.cfg.set("io_retries", 0)
        p.cfg.set("quarantine_after", 1)
        p.cfg.set("quarantine_s", 60.0)
        plan = p.fake.FaultPlan(failstop_member=0, failstop_after=0)
        paths, emu, src = _mirrored_emulated(p, tmp_path, plan, name)
        before = p.counters()
        try:
            with p.session() as sess:
                got, total = p.chaos.read_all(sess, src, chunk=CHUNK)
                assert sess._member_health.state(0).name != "HEALTHY"
        finally:
            src.close()
            emu.close()
        after = p.counters()
        assert got == tchaos.expected_mirrored_stream(paths, CHUNK)[:total]
        out[name] = {**_pt_delta(before, after),
                     "nr_mirror_read": _delta(before, after,
                                              "nr_mirror_read")}
    assert out["torch"] == out["jax"]
    assert out["torch"]["nr_passthru_fallback"] >= 1
    assert out["torch"]["nr_mirror_read"] >= 1


def test_autotuner_epochs_on_passthru_lane(tmp_path):
    """The controller tunes a passthrough workload like any other: epochs
    observe traffic, knobs move, bytes stay identical."""
    _base_config(tcfg)
    tcfg.set("autotune", True)
    tcfg.set("submit_window", 2)
    size = 8 * CHUNK
    path = str(tmp_path / "tune.bin")
    tfake.make_test_file(path, size)
    emu = temu.PassthruEmulator(str(tmp_path / "tune.img"))
    emu.provision(path, frag=2)
    src = tfake.FakeNvmeSource(path, fault_plan=tfake.FaultPlan(
        latency_s=0.002), force_cached_fraction=0.0)
    emu.attach(src)
    before = tstats.snapshot()
    try:
        with teng.Session(device="cpu") as sess:
            sess._tuner.stop()          # drive epochs synchronously
            for _ in range(6):
                assert _read_pass(sess, src, 8) == \
                    tfake.expected_bytes(0, size)
                sess._tuner.step_epoch()
            hist = sess._tuner._climber.history
    finally:
        src.close()
        emu.close()
    assert _delta(before, tstats.snapshot(), "nr_passthru_dma") > 0
    assert any(ev for ep in hist for ev in ep), \
        "controller saw a passthrough workload but never acted"


# ---------------------------------------------------------------------------
# zero counters when pinned; drift; command validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pinned", ["uring", "threadpool"])
def test_pinned_ladder_moves_zero_passthru_counters(tmp_path, pinned):
    size = 2 * CHUNK
    for name, p in PKGS.items():
        _base_config(p.cfg)
        p.cfg.set("engine_backend", pinned)
        path = str(tmp_path / f"pin_{name}.bin")
        tfake.make_test_file(path, size)
        emu = p.emu.PassthruEmulator(str(tmp_path / f"pin_{name}.img"))
        emu.provision(path, frag=2)
        src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
        emu.attach(src)
        before = p.counters()
        try:
            with (teng.Session(device="cpu") if name == "torch"
                  else p.session()) as sess:
                got = _read_pass(sess, src, 2)
        finally:
            src.close()
            emu.close()
        after = p.counters()
        assert got == tfake.expected_bytes(0, size)
        assert emu.commands_served == 0
        assert not {k: _delta(before, after, k) for k in after
                    if (k.startswith("nr_passthru") or k == "bytes_passthru")
                    and _delta(before, after, k)}, name


def test_slba_drift_is_a_hard_error(tmp_path):
    """A device offset that reverse-maps to the wrong file offset is an
    error, never a wrong-bytes read, in both packages."""
    path = str(tmp_path / "drift.bin")
    tfake.make_test_file(path, CHUNK)
    for name, p in PKGS.items():
        emu = p.emu.PassthruEmulator(str(tmp_path / f"drift_{name}.img"))
        try:
            exts = emu.provision(path, frag=1)
            src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
            chan = emu.attach(src)
            with pytest.raises(p.err, match="drift"):
                chan.read(0, 0, exts[0].physical + LBA,
                          memoryview(bytearray(LBA)))
            src.close()
        finally:
            emu.close()


def test_emulator_validates_commands(tmp_path):
    path = str(tmp_path / "val.bin")
    tfake.make_test_file(path, CHUNK)
    for name, p in PKGS.items():
        emu = p.emu.PassthruEmulator(str(tmp_path / f"val_{name}.img"))
        try:
            exts = emu.provision(path, frag=1)
            slba = exts[0].physical >> emu.lba_shift
            buf = memoryview(bytearray(LBA))
            pack = p.emu.pack_uring_cmd
            for cmd, what in (
                    (b"\x00" * 16, "size"),
                    (pack(nsid=1, slba=slba, nlb0=0, data_len=LBA,
                          opcode=0x01), "opcode"),
                    (pack(nsid=7, slba=slba, nlb0=0, data_len=LBA), "NSID"),
                    (pack(nsid=1, slba=slba, nlb0=0, data_len=4096),
                     "data_len"),
                    (pack(nsid=1, slba=0, nlb0=0, data_len=LBA),
                     "provisioned")):
                with pytest.raises(p.err, match=what):
                    emu.execute(cmd, buf)
            ok = pack(nsid=1, slba=slba, nlb0=0, data_len=LBA)
            assert emu.execute(ok, buf) == (path, 0)
            assert bytes(buf) == tfake.expected_bytes(0, LBA)
        finally:
            emu.close()
    with pytest.raises(ValueError):
        temu.PassthruEmulator(str(tmp_path / "x.img"), lba_shift=8)


def test_emulator_tail_and_rewrite_match_reference(tmp_path):
    """A file that ends inside an LBA: a command over its whole LBAs is
    served, one that rounds its tail up is refused (the tail is the
    blockmap's O_DIRECT piece); a rewrite after the image was read lands
    in the next command (the port serves the image from a mapping, the
    JAX package with pread): the same bytes and refusals from both."""
    size = 3 * CHUNK + 100
    path = str(tmp_path / "tail.bin")
    tfake.make_test_file(path, size, seed=6)
    out = {}
    for name, p in PKGS.items():
        emu = p.emu.PassthruEmulator(str(tmp_path / f"tail_{name}.img"))
        try:
            ext = emu.provision(path, frag=1)[0]
            whole = size // LBA

            def cmd(nlb):
                return p.emu.pack_uring_cmd(
                    nsid=1, slba=ext.physical // LBA, nlb0=nlb - 1,
                    data_len=nlb * LBA)
            first = bytearray(whole * LBA)
            emu.execute(cmd(whole), memoryview(first))
            with pytest.raises(p.err, match="provisioned"):
                emu.execute(cmd(whole + 1),
                            memoryview(bytearray((whole + 1) * LBA)))
            emu.rewrite(path, CHUNK + 7, b"\x5a" * 1000)
            second = bytearray(whole * LBA)
            emu.execute(cmd(whole), memoryview(second))
            out[name] = (bytes(first), bytes(second))
        finally:
            emu.close()
    assert out["torch"] == out["jax"]
    first, second = out["torch"]
    want = tfake.expected_bytes(0, size, seed=6)
    assert first == want[:len(first)]
    assert second[CHUNK + 7:CHUNK + 1007] == b"\x5a" * 1000
    assert second[:CHUNK + 7] == want[:CHUNK + 7]


# ---------------------------------------------------------------------------
# the gate's layouts, landed bytes, the native submit, the NLB cap
# ---------------------------------------------------------------------------

def _split_layout(p, tmp_path, name):
    path = str(tmp_path / f"split_{name}.bin")
    tfake.make_test_file(path, 8 * CHUNK)
    emu = p.emu.PassthruEmulator(str(tmp_path / f"split_{name}.img"))
    emu.provision(path, frag=4, ineligible=((CHUNK, 4096, 0x800),
                                            (5 * CHUNK + 512, 8192, 0x200)))
    src = p.fake.FakeNvmeSource(path, force_cached_fraction=0.0)
    emu.attach(src)
    with p.session() as sess:
        got = _read_pass(sess, src, 8)
    src.close()
    emu.close()
    return got, 8 * CHUNK


def _failstop_layout(p, tmp_path, name):
    p.cfg.set("io_retries", 0)
    paths = []
    for k in range(2):
        a = str(tmp_path / f"fs_{name}{2 * k}.bin")
        tfake.make_test_file(a, 256 << 10, seed=300 + k)
        b = str(tmp_path / f"fs_{name}{2 * k + 1}.bin")
        shutil.copyfile(a, b)
        paths += [a, b]
    emu = p.emu.PassthruEmulator(str(tmp_path / f"fs_{name}.img"))
    for q in paths:
        emu.provision(q, frag=2)
    src = p.fake.FakeStripedNvmeSource(
        paths, p.chaos.STRIPE, fault_plan=p.fake.FaultPlan(
            failstop_member=0, failstop_after=0),
        force_cached_fraction=0.0, mirror="paired")
    emu.attach(src)
    with p.session() as sess:
        got, total = p.chaos.read_all(sess, src, chunk=CHUNK)
    src.close()
    emu.close()
    return got, total


@pytest.mark.parametrize("layout", [_split_layout, _failstop_layout])
def test_gate_layout_counter_deltas_match_reference(tmp_path, layout):
    """The gate's split and fail-stop layouts through both packages' pool
    paths: the same bytes and the same passthrough counter deltas."""
    out = {}
    for name, p in PKGS.items():
        _base_config(p.cfg)
        before = p.counters()
        got, total = layout(p, tmp_path, name)
        out[name] = (got, total, _pt_delta(before, p.counters()))
    assert out["torch"] == out["jax"]
    deltas = out["torch"][2]
    assert deltas["nr_passthru_dma"] > 0
    assert deltas["nr_passthru_refused_extent"] + \
        deltas["nr_passthru_fallback"] > 0


@pytest.mark.parametrize("mode", ["python", "native"])
def test_plain_source_lane_follows_the_executor(tmp_path, mode):
    """An emulator attached to a plain (unfaked) source: a python-pool
    Session reads through the lane, a native one drops the channel and
    reads O_DIRECT (the JAX package's rule), same bytes either way; the
    port's ``load_file_to_device`` lands the file exactly."""
    _base_config(tcfg)
    size = 16 * CHUNK
    path = str(tmp_path / "plain.bin")
    tfake.make_test_file(path, size, seed=9)
    emu = temu.PassthruEmulator(str(tmp_path / "plain.img"))
    emu.provision(path, frag=5, ineligible=((3 * CHUNK, 8192, 0x800),))
    before = tstats.snapshot()
    try:
        with teng.open_source(path) as src:
            emu.attach(src)
            sess = teng.Session(device="cpu", io_backend=mode
                                if mode == "python" else "auto")
            try:
                assert _read_pass(sess, src, 16) == \
                    tfake.expected_bytes(0, size, seed=9)
                out = load_file_to_device(src, session=sess, device="cpu",
                                          chunk_size=CHUNK)
            finally:
                sess.close()
    finally:
        emu.close()
    with open(path, "rb") as f:
        assert torch.equal(out, torch.frombuffer(bytearray(f.read()),
                                                 dtype=torch.uint8))
    d = _pt_delta(before, tstats.snapshot())
    if mode == "python":
        assert d["nr_passthru_dma"] > 0 and d["bytes_passthru"] > 0
        assert d["nr_passthru_refused_extent"] > 0
        assert emu.commands_served == d["nr_passthru_dma"]
    else:
        assert d == dict.fromkeys(_PT_KEYS, 0)
        assert emu.commands_served == 0


def test_native_submit_flags_split_requests(tmp_path, monkeypatch):
    """A native channel (the real rung's) splits a task's requests and
    flags the resolved ones at the native submit; an engine off that rung
    refuses the flagged batch (EINVAL), which falls back to the python
    pool and reads the same bytes O_DIRECT."""
    _base_config(tcfg)
    size = 8 * CHUNK
    path = str(tmp_path / "native.bin")
    tfake.make_test_file(path, size, seed=4)
    emu = temu.PassthruEmulator(str(tmp_path / "native.img"))
    emu.provision(path, frag=3, ineligible=((CHUNK, 4096, 0x800),))
    seen = []
    real = tnat.NativeEngine.submit

    def spy(self, addr, reqs, **kw):
        seen.append(list(kw.get("passthru") or []))
        return real(self, addr, reqs, **kw)

    monkeypatch.setattr(tnat.NativeEngine, "submit", spy)
    before = tstats.snapshot()
    try:
        with teng.open_source(path) as src, \
                teng.Session(device="cpu") as sess:
            if sess._native is None:
                pytest.fail("the port's native engine did not come up")
            # sysfs places the file on the channel's namespace
            monkeypatch.setattr(tbm, "namespace_base",
                                lambda path, dev: (0, ""))
            sess._pt_channel = teng._NativePassthruChannel(9, "/dev/ng0n1")
            assert _read_pass(sess, src, 8) == \
                tfake.expected_bytes(0, size, seed=4)
    finally:
        emu.close()
    after = tstats.snapshot()
    assert seen and any(seen[0]) and not all(seen[0])
    assert _delta(before, after, "nr_backend_fallback") >= 1
    assert _delta(before, after, "bytes_passthru") == size - 4096
    assert emu.commands_served == 0


@pytest.mark.parametrize("shift", [9, 12])
def test_split_caps_a_command_at_65536_lbas(tmp_path, shift, monkeypatch):
    """A coalesced request past 65536 LBAs (64 MiB at 512 B): the JAX
    package's split keeps it one run, whose 0-based NLB does not fit
    cdw12's 16 bits, and its own emulator refuses the command; the port
    cuts it into commands of at most 65536 LBAs, each served exactly."""
    lba = 1 << shift
    length = (1 << 16) * lba * 2 if shift == 9 else (1 << 16) * lba + CHUNK
    path = "/synthetic/long.bin"
    _register_both(path, [(0, 1 << 20, length, 0)])
    # the synthetic file sits on the whole namespace the channel reads
    monkeypatch.setattr(tbm, "file_devno", lambda path: 1)
    monkeypatch.setattr(tbm, "namespace_base", lambda path, dev: (0, ""))
    chan = teng._NativePassthruChannel(shift, "/dev/ng0n1")
    req = {n: p.eng.Request(member=0, file_off=0, length=length, dest_off=0)
           for n, p in PKGS.items()}
    src = types.SimpleNamespace(_m=types.SimpleNamespace(path=path))
    try:
        with jeng.Session(io_backend="python") as js:
            jout = js._passthru_split(jeng.DmaTask(0), src, [req["jax"]],
                                      chan, {})
        with teng.Session(device="cpu", io_backend="python") as ts:
            tout = ts._passthru_split(teng._Task(0), src, [req["torch"]],
                                      chan, {})
    finally:
        _unregister_both(path)
    assert [(r.file_off, r.length, r.passthru_off) for r in jout] == \
        [(0, length, 1 << 20)]
    assert (length >> shift) - 1 > 0xFFFF
    cap = (1 << 16) * lba
    assert [(r.file_off, r.length, r.passthru_off) for r in tout] == \
        [(k, min(cap, length - k), (1 << 20) + k)
         for k in range(0, length, cap)]
    assert sum(r.length for r in tout) == length
    # the command each split makes, through each package's emulator
    jcmd = jemu.pack_uring_cmd(nsid=1, slba=(1 << 20) >> shift,
                               nlb0=(length >> shift) - 1, data_len=length)
    with pytest.raises(JStromError, match="NLB"):
        jemu.PassthruEmulator.execute(
            types.SimpleNamespace(lba_shift=shift, nsid=1), jcmd,
            memoryview(bytearray(length)))
    for r in tout:
        assert (r.length >> shift) - 1 <= 0xFFFF


# ---------------------------------------------------------------------------
# which namespace the real rung's char device reads (a fake sysfs)
# ---------------------------------------------------------------------------

#: block devices of the fake sysfs: name -> (devno, sysfs dir under /sys)
_BLOCK = {
    "nvme0n1": (os.makedev(259, 0), "devices/pci0/nvme/nvme0/nvme0n1"),
    "nvme0n1p2": (os.makedev(259, 1),
                  "devices/pci0/nvme/nvme0/nvme0n1/nvme0n1p2"),
    "nvme0n2": (os.makedev(259, 2), "devices/pci0/nvme/nvme0/nvme0n2"),
    "nvme1n1": (os.makedev(259, 3), "devices/pci1/nvme/nvme1/nvme1n1"),
    "dm-0": (os.makedev(253, 0), "devices/virtual/block/dm-0"),
    "mpath": (os.makedev(259, 4),
              "devices/virtual/nvme-subsystem/nvme-subsys2/nvme2n1"),
}
_CHARS = {"ng0n1": "devices/pci0/nvme/nvme0/ng0n1",
          "ng0n2": "devices/pci0/nvme/nvme0/ng0n2",
          "ng1n1": "devices/pci1/nvme/nvme1/ng1n1",
          "ng2n1": "devices/virtual/nvme-subsystem/nvme-subsys2/ng2n1"}
_PART_START = 2048          # sectors of 512 bytes


@pytest.fixture()
def fake_sysfs(tmp_path, monkeypatch):
    """A sysfs with two drives, a partition, a second namespace, a dm
    device over the partition and a multipath head; the port's blockmap
    reads it, and ``file_devno`` takes a file's block device from its
    name (``<device>.bin``)."""
    root = tmp_path / "sys"
    for name, (devno, rel) in _BLOCK.items():
        d = root / rel
        (d / "slaves").mkdir(parents=True)
        link = root / "dev" / "block" / f"{os.major(devno)}:{os.minor(devno)}"
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(d)
    part = root / _BLOCK["nvme0n1p2"][1]
    (part / "partition").write_text("2\n")
    (part / "start").write_text(f"{_PART_START}\n")
    (root / _BLOCK["dm-0"][1] / "slaves" / "nvme0n1p2").symlink_to(part)
    for name, rel in _CHARS.items():
        (root / rel).mkdir(parents=True)
        link = root / "class" / "nvme-generic" / name
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(root / rel)
    monkeypatch.setattr(tbm, "SYSFS", str(root))

    def devno(path):
        name = os.path.basename(path).rsplit(".", 1)[0]
        if name not in _BLOCK:
            raise FileNotFoundError(path)
        return _BLOCK[name][0]

    monkeypatch.setattr(tbm, "file_devno", devno)
    return root


@pytest.mark.parametrize("member,chardev,want", [
    ("nvme0n1", "/dev/ng0n1", (0, "")),
    ("nvme0n1p2", "/dev/ng0n1", (_PART_START * 512, "")),
    ("nvme0n2", "/dev/ng0n1", (None, "otherdev")),
    ("nvme0n1", "/dev/ng0n2", (None, "otherdev")),
    ("nvme1n1", "/dev/ng0n1", (None, "otherdev")),
    ("nvme1n1", "/dev/ng1n1", (0, "")),
    ("dm-0", "/dev/ng0n1", (None, "stacked")),
    ("mpath", "/dev/ng2n1", (0, "")),
    ("mpath", "/dev/ng0n1", (None, "otherdev")),
    ("nvme0n1", "/dev/ng9n1", (None, "nosysfs")),
    ("btrfs", "/dev/ng0n1", (None, "nosysfs")),
])
def test_namespace_base_over_fake_sysfs(fake_sysfs, member, chardev, want):
    """A file rides a char device's lane only on that device's namespace,
    at its partition's start; another namespace or drive, a stacked
    device and an unreadable sysfs are refused by reason."""
    assert tbm.namespace_base(f"/data/{member}.bin", chardev) == want


def test_split_places_each_member_by_its_namespace(fake_sysfs):
    """A stripe over a partition of the rung's namespace, another drive, a
    dm device and the whole namespace: the port's split puts the
    partition's extents on the lane at its start plus FIEMAP's offset,
    the whole namespace's at FIEMAP's offset, and reads the other two
    O_DIRECT, each device counted once by reason.  The JAX package's
    split sends all four to the one namespace at FIEMAP's raw offsets:
    the partition's land 1 MiB short of its data, and the other drive's
    and the dm device's on bytes of another device (ROADMAP Queue C
    slice 17 item 6, †)."""
    names = ["nvme0n1p2", "nvme1n1", "dm-0", "nvme0n1"]
    paths = [f"/data/{n}.bin" for n in names]
    phys = 64 << 20
    for i, path in enumerate(paths):
        _register_both(path, [(0, phys * (i + 1), 4 * CHUNK, 0)])
    src = types.SimpleNamespace(
        members=[types.SimpleNamespace(path=p) for p in paths])
    chan = teng._NativePassthruChannel(9, "/dev/ng0n1")
    before = tstats.snapshot()
    try:
        with teng.Session(device="cpu", io_backend="python") as ts:
            touts = [ts._passthru_split(
                teng._Task(0), src,
                [teng.Request(member=m, file_off=0, length=4 * CHUNK,
                              dest_off=m * 4 * CHUNK) for m in range(4)],
                chan, {}) for _ in range(2)]
        with jeng.Session(io_backend="python") as js:
            jout = js._passthru_split(
                jeng.DmaTask(0), src,
                [jeng.Request(member=m, file_off=0, length=4 * CHUNK,
                              dest_off=m * 4 * CHUNK) for m in range(4)],
                chan, {})
    finally:
        for path in paths:
            _unregister_both(path)
    after = tstats.snapshot()
    want = [(0, 4 * CHUNK, _PART_START * 512 + phys), (1, 4 * CHUNK, None),
            (2, 4 * CHUNK, None), (3, 4 * CHUNK, 4 * phys)]
    for tout in touts:
        assert [(r.member, r.length, r.passthru_off) for r in tout] == want
    assert [(r.member, r.passthru_off) for r in jout] == \
        [(m, phys * (m + 1)) for m in range(4)]
    assert _delta(before, after, "nr_passthru_member_otherdev") == 1
    assert _delta(before, after, "nr_passthru_member_stacked") == 1
    assert _delta(before, after, "nr_passthru_refused_extent") == 4
    assert _delta(before, after, "bytes_passthru") == 4 * 4 * CHUNK


def test_native_rung_session_builds_the_checked_channel(monkeypatch):
    """A Session that comes up on the passthrough rung reads the device
    it opened through a channel that checks each member's namespace."""
    class _Eng:
        backend_name = "nvme_passthru"

        def __init__(self, *a, **kw):
            self.dev = kw.get("passthru_dev")

        def close(self):
            pass

    monkeypatch.setenv("NSTPU_PASSTHRU_DEV", "/dev/ng3n1")
    monkeypatch.setattr(tnat, "passthru_probe", lambda dev: 9)
    monkeypatch.setattr(tnat, "NativeEngine", _Eng)
    monkeypatch.setattr(tnat, "_load", lambda: None)
    tcfg.set("engine_backend", "passthru")
    sess = teng.Session.__new__(teng.Session)
    sess._passthru_dev = None
    sess._pt_channel = None
    eng = sess._open_passthru(tnat, True, True)
    assert isinstance(eng, _Eng) and eng.dev == "/dev/ng3n1"
    chan = sess._pt_channel
    assert (chan.dev, chan.lba_size) == ("/dev/ng3n1", 512)
    assert chan.device_base("/no/such/file") is None


def test_pool_lane_commands_fit_cdw12(tmp_path, monkeypatch):
    """Over the emulator (the python pools) neither package coalesces, so
    with ``coalesce_limit`` at 64 MiB every command stays within
    ``dma_max_size`` (16 MiB, 32768 LBAs): the reference's uncapped split
    shows only on the native rung."""
    size = 32 << 20
    path = str(tmp_path / "nlb.bin")
    tfake.make_test_file(path, size, seed=8)
    out = {}
    for name, p in PKGS.items():
        _base_config(p.cfg)
        p.cfg.set("coalesce_limit", 64 << 20)
        p.cfg.set("dma_max_size", 16 << 20)
        emu = p.emu.PassthruEmulator(str(tmp_path / f"nlb_{name}.img"))
        emu.provision(path, frag=1)
        nlbs = []
        real = p.emu.PassthruEmulator.execute

        def spy(self, cmd, dest, real=real, p=p):
            nlbs.append(p.emu._CMD.unpack(cmd)[12] + 1)
            return real(self, cmd, dest)

        monkeypatch.setattr(p.emu.PassthruEmulator, "execute", spy)
        try:
            with p.eng.open_source(path) as src, p.session() as sess:
                emu.attach(src)
                got = _read_pass(sess, src, 2, chunk=16 << 20)
        finally:
            emu.close()
        assert got == tfake.expected_bytes(0, size, seed=8)
        out[name] = sorted(nlbs)
    assert out["torch"] == out["jax"] == [32768, 32768]


def test_passthru_gate_legs_pass_on_cpu(capsys):
    """Every leg of the port's gate passes on the CPU and the gate writes
    no journal into the repo."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    journal = os.path.join(repo, "PASSTHRU_AB.jsonl")
    stamp = os.stat(journal) if os.path.exists(journal) else None
    assert passthru_gate.main(["-d", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "passthru_submit_overhead" in out and "FAIL" not in out
    now = os.stat(journal) if os.path.exists(journal) else None
    assert (stamp is None) == (now is None)
    if stamp is not None:
        assert (stamp.st_size, stamp.st_mtime_ns) == \
            (now.st_size, now.st_mtime_ns)


def test_passthru_counters_named_like_reference():
    """The JAX package's names, and the port's own namespace refusals."""
    own = {"nr_passthru_member_" + r for r in tbm.MEMBER_REASONS}
    assert own <= set(PASSTHRU_COUNTERS)
    assert set(PASSTHRU_COUNTERS) - own <= set(STAT_FIELDS)
    assert not own & set(STAT_FIELDS)
    assert len(set(PASSTHRU_COUNTERS)) == len(PASSTHRU_COUNTERS)


@pytest.mark.parametrize("key,values", [
    ("engine_backend", ["auto", "passthru", "uring", "threadpool",
                        "io_uring", "nvme"]),
    ("passthru_dev_glob", ["/dev/ng*n*", "/dev/ng0n1"]),
])
def test_passthru_knobs_like_reference(key, values):
    """Same default, same accepted and refused values."""
    assert tcfg.get(key) == jcfg.get(key)
    for v in values:
        verdicts = []
        for cfg in (tcfg, jcfg):
            try:
                cfg.set(key, v)
                verdicts.append(True)
            except (ConfigError, ValueError):
                verdicts.append(False)
        assert verdicts[0] == verdicts[1], (key, v)
