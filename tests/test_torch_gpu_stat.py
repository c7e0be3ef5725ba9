"""The port's stats export and ``tools/gpu_stat.py`` against the JAX
package's export and ``tools/tpu_stat.py``: the registry's names and
gates, the export's payload and its one resetter, the stage counts the
engine and the staging pipeline add, the per-pid files of an unmodified
process (and of one in which both packages run), and the tool's output on
one payload beside ``tpu_stat``'s."""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu_torch.engine as teng
from nvme_strom_tpu.api import STAT_FIELDS as J_FIELDS
from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.hbm.staging import load_file_to_device as jload
from nvme_strom_tpu.stats import StatRegistry
from nvme_strom_tpu.stats import stats as jstats
from nvme_strom_tpu.tools import tpu_stat
from nvme_strom_tpu_torch.api import STAT_FIELDS
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.hbm.staging import load_file_to_device
from nvme_strom_tpu_torch.stats import Stats, stats
from nvme_strom_tpu_torch.tools import gpu_stat

tstats_mod = importlib.import_module("nvme_strom_tpu_torch.stats")
jstats_mod = importlib.import_module("nvme_strom_tpu.stats")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1 << 20

#: the port's counters beyond the JAX package's
PORT_ONLY = ("nr_write_dma", "total_write_length", "nr_arb_blind",
             "nr_passthru_member_otherdev", "nr_passthru_member_stacked",
             "nr_passthru_member_nosysfs")

#: the payload of
#: tests/test_member_stats.py::test_tpu_stat_verbose_shows_members
MEMBER_PAYLOAD = {
    "timestamp_ns": 1, "pid": 1234, "version": 1,
    "counters": {"nr_submit_dma": 8, "total_dma_length": 8 << 20,
                 "cur_dma_count": 0, "max_dma_count": 4},
    "members": {"0": {"nreq": 4, "bytes": 4 << 20, "clk_ns": 4_000_000},
                "1": {"nreq": 4, "bytes": 4 << 20, "clk_ns": 40_000_000}},
}


@pytest.fixture(autouse=True)
def _port_config():
    """The port's config is its own: snapshot and restore it here."""
    snap = config.snapshot()
    yield
    config.restore(snap)


@pytest.fixture(autouse=True)
def export_dir(tmp_path, monkeypatch):
    """Both packages' per-pid directory and well-known file under
    *tmp_path*, for every test here: a Session that starts its process's
    exporter publishes there, not in the shared default directory (an
    exporter already running keeps the path it started with)."""
    d = tmp_path / "exports"
    d.mkdir()
    for mod, name in ((tstats_mod, "strom_gpu_stat.wk.json"),
                      (jstats_mod, "strom_tpu_stat.wk.json")):
        monkeypatch.setattr(mod, "STAT_EXPORT_DIR", str(d))
        monkeypatch.setattr(mod, "DEFAULT_STAT_EXPORT", str(tmp_path / name))
    monkeypatch.setattr(gpu_stat, "_warned_unpinned", False)
    monkeypatch.setattr(tpu_stat, "_warned_unpinned", False)
    return d


def _file(tmp_path, nbytes, seed=3):
    path = str(tmp_path / f"data{nbytes}.bin")
    np.random.default_rng(seed).integers(0, 256, nbytes, dtype=np.uint8) \
        .tofile(path)
    return path


def _tool(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# -- the registry ------------------------------------------------------------

def test_stat_fields_are_the_references_then_the_ports_own():
    assert STAT_FIELDS[:len(J_FIELDS)] == J_FIELDS
    assert STAT_FIELDS[len(J_FIELDS):] == PORT_ONLY
    assert len(set(STAT_FIELDS)) == len(STAT_FIELDS)


def test_every_field_starts_at_zero_and_reset_keeps_them():
    reg = Stats()
    snap = reg.snapshot(debug=True)
    assert set(snap) == set(STAT_FIELDS) and not any(snap.values())
    reg.add("nr_ssd2dev", 5)
    reg.count_clock("debug3", 100)
    reg.reset()
    assert reg.snapshot(debug=True) == dict.fromkeys(STAT_FIELDS, 0)
    # the plain read leaves the debug pairs out, as the reference's does
    plain = reg.snapshot()
    assert set(plain) == {n for n in STAT_FIELDS if "debug" not in n}
    assert set(StatRegistry().snapshot().counters) <= set(plain)


def _drive(reg):
    reg.add("nr_ssd2dev", 2)
    reg.count_clock("setup_prps", 1000, n=3)
    reg.observe_latency(5000, n=4)
    reg.member_add(0, 4096, 700)
    reg.member_error(1, retried=True)
    reg.shard_wait(0, 900)


def _state(reg, snap):
    return (snap, reg.lat_hist_snapshot(), reg.member_snapshot(),
            reg.shard_snapshot())


@pytest.mark.parametrize("on", [False, True])
def test_stat_info_gates_the_counting_sites_as_the_reference(on):
    """With ``stat_info`` off, ``add``, ``count_clock``,
    ``observe_latency``, ``member_add``, ``member_error`` and
    ``shard_wait`` count nothing in either package; on, they count the
    same."""
    config.set("stat_info", on)
    jconfig.set("stat_info", on)
    mine, ref = Stats(), StatRegistry()
    _drive(mine)
    _drive(ref)
    m = _state(mine, mine.snapshot())
    r = _state(ref, ref.snapshot().counters)
    assert {k: m[0][k] for k in r[0]} == r[0]
    assert m[1:] == r[1:]
    if not on:
        assert not any(m[0].values()) and not any(m[1])
        assert m[2] == {} and m[3] == {}
    else:
        assert m[0]["nr_setup_prps"] == 3 and m[2][1]["errors"] == 1


def test_stat_info_off_moves_no_stage_count_of_a_read(tmp_path):
    path = _file(tmp_path, 4 * CHUNK)
    config.set("cache_arbitration", False)
    config.set("stat_info", False)
    names = ("nr_ioctl_memcpy_submit", "nr_setup_prps",
             "nr_ioctl_memcpy_wait", "nr_ssd2dev")
    before = {k: stats.snapshot()[k] for k in names}
    with teng.open_source(path) as src, \
            teng.Session(io_backend="python") as sess:
        h, buf = sess.alloc_dma_buffer(4 * CHUNK)
        r = sess.memcpy_ssd2ram(src, h, range(4), CHUNK)
        sess.memcpy_wait(r.dma_task_id)
        assert bytes(buf.view()) == open(path, "rb").read()
        sess.unmap_buffer(h)
        buf.close()
    assert {k: stats.snapshot()[k] for k in names} == before


# -- the export --------------------------------------------------------------

def test_export_carries_every_field_in_the_references_shape(tmp_path):
    tmp_path = tmp_path / "out"
    tmp_path.mkdir()
    mine, theirs = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    stats.export(mine)
    jstats.export(theirs)
    got, ref = json.load(open(mine)), json.load(open(theirs))
    assert set(got) == set(ref)
    assert got["pid"] == ref["pid"] == os.getpid()
    assert set(STAT_FIELDS) <= set(got["counters"])
    assert set(ref["counters"]) <= set(got["counters"])
    assert sorted(os.listdir(tmp_path)) == ["j.json", "p.json"]


def test_export_counts_its_publishes_and_failed_writes(tmp_path):
    """``exports`` counts what was written and ``export_errors`` what was
    not: a reader of one window tells from them whether a publish fell
    inside it."""
    tmp_path = tmp_path / "out"
    tmp_path.mkdir()
    reg = Stats()
    reg.export(str(tmp_path / "a.json"))
    reg.export(str(tmp_path / "a.json"))
    reg.export(str(tmp_path / "missing" / "a.json"))
    assert (reg.exports, reg.export_errors) == (2, 1)
    assert os.listdir(tmp_path) == ["a.json"]


def test_export_runs_the_engines_fold_first(tmp_path):
    """Each publish runs :attr:`Stats.export_fold` before its snapshot;
    the engine sets it to its fold of the live Sessions, and a fold that
    raises does not stop the publish."""
    assert stats.export_fold is teng._fold_live_native_stats
    reg, seen = Stats(), []

    def fold():
        seen.append(reg.exports)
        reg.add("nr_ssd2dev", 1)
        raise RuntimeError("a fold that fails")

    reg.export_fold = fold
    path = str(tmp_path / "f.json")
    reg.export(path)
    reg.export(path)
    assert seen == [0, 1] and reg.exports == 2
    assert json.load(open(path))["counters"]["nr_ssd2dev"] == 2


def test_only_the_exporter_resets_max_dma_count(tmp_path):
    """Reads leave the high-water mark; the export publishes it, then sets
    it back to the in-flight count, as the reference's exporter does."""
    out = {}
    for name, reg, read in (
            ("port", Stats(), lambda r, **kw: r.snapshot(**kw)),
            ("jax", StatRegistry(),
             lambda r, **kw: r.snapshot(**kw).counters)):
        reg.gauge_add("cur_dma_count", 2)
        reg.gauge_max("max_dma_count", 7)
        seen = [read(reg)["max_dma_count"],
                read(reg, debug=True)["max_dma_count"]]
        path = str(tmp_path / f"{name}.json")
        reg.export(path)
        seen.append(json.load(open(path))["counters"]["max_dma_count"])
        seen.append(read(reg)["max_dma_count"])
        reg.export(path)
        seen.append(json.load(open(path))["counters"]["max_dma_count"])
        out[name] = seen
    assert out["port"] == out["jax"] == [7, 7, 7, 2, 2]


def test_both_packages_in_one_process_write_two_files(export_dir):
    """One pid, two registries: the port's per-pid file is not the
    reference's, each package lists only its own, and neither's file
    holds the other's counters."""
    mine, theirs = tstats_mod.pid_export_path(), jstats_mod.pid_export_path()
    assert mine != theirs
    assert os.path.basename(mine) == f"strom_gpu_stat.{os.getpid()}.json"
    stats.export(mine)
    jstats.export(theirs)
    assert tstats_mod.list_exports() == [(os.getpid(), mine, True)]
    assert jstats_mod.list_exports() == [(os.getpid(), theirs, True)]
    assert "nr_arb_blind" in json.load(open(mine))["counters"]
    assert "nr_arb_blind" not in json.load(open(theirs))["counters"]


def test_list_exports_skips_the_well_known_file(export_dir, monkeypatch):
    """The well-known file's uid-suffixed name matches the per-pid
    pattern; where both share a directory, it is not a session."""
    wk = str(export_dir / f"strom_gpu_stat.{os.getuid()}.json")
    monkeypatch.setattr(tstats_mod, "DEFAULT_STAT_EXPORT", wk)
    stats.export(wk)
    stats.export(tstats_mod.pid_export_path())
    assert [p for p, _f, _a in tstats_mod.list_exports()] == [os.getpid()]


def _child(code, env_dir, **env):
    e = dict(os.environ, PYTHONPATH=REPO, STROM_STAT_EXPORT_DIR=env_dir,
             JAX_PLATFORMS="cpu", **env)
    return subprocess.Popen([sys.executable, "-c", code], env=e, cwd=REPO,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


#: a child with a bare Session of each package; "ready" once both
#: exporters have published, then it waits for a line on stdin
_BOTH = """
import os, sys, time
import nvme_strom_tpu.engine as jeng
from nvme_strom_tpu_torch.engine import Session
t, j = Session(io_backend="python"), jeng.Session(io_backend="python")
d, pid = os.environ["STROM_STAT_EXPORT_DIR"], os.getpid()
want = [os.path.join(d, f"strom_gpu_stat.{pid}.json"),
        os.path.join(d, f"strom_stat.{pid}.json")]
end = time.monotonic() + 60
while not all(os.path.exists(w) for w in want) and time.monotonic() < end:
    time.sleep(0.05)
print("ready", flush=True)
sys.stdin.readline()
t.close(); j.close()
"""

#: a child with a bare port Session; "ready" once it has published
_PORT = """
import os, sys, time
from nvme_strom_tpu_torch.engine import Session
from nvme_strom_tpu_torch.stats import stats, pid_export_path
s = Session(io_backend="python")
end = time.monotonic() + 60
while stats._exporter is not None and not os.path.exists(pid_export_path()) \\
        and time.monotonic() < end:
    time.sleep(0.05)
print("ready", stats._exporter is None, flush=True)
sys.stdin.readline()
s.close()
"""


def test_unmodified_process_is_listed_read_and_cleaned_up(export_dir,
                                                          capsys):
    """A process with a bare Session of each package, and no stats code of
    its own, is ``live`` to ``gpu_stat -l`` and to ``tpu_stat -l``, each
    through its own file; ``gpu_stat -p PID --json`` reads the port's; a
    clean exit removes both files, neither package's exit the other's."""
    proc = _child(_BOTH, str(export_dir))
    try:
        assert proc.stdout.readline().strip() == "ready", proc.stderr.read()
        pid = proc.pid
        assert sorted(os.listdir(export_dir)) == sorted(
            [f"strom_gpu_stat.{pid}.json", f"strom_stat.{pid}.json"])
        rc, out, _ = _tool(gpu_stat.main, ["-l"], capsys)
        assert rc == 0
        row = [ln for ln in out.splitlines() if ln.split()[:1] == [str(pid)]]
        assert len(row) == 1 and "live" in row[0]
        assert f"strom_gpu_stat.{pid}.json" in row[0]
        rc, out, _ = _tool(tpu_stat.main, ["-l"], capsys)
        assert rc == 0 and f"strom_stat.{pid}.json" in out
        assert "strom_gpu_stat" not in out
        rc, out, _ = _tool(gpu_stat.main, ["-p", str(pid), "--json"], capsys)
        snap = json.loads(out)
        assert rc == 0 and snap["pid"] == pid
        assert set(STAT_FIELDS) <= set(snap["counters"])
        assert snap["backend"] == "python"
        proc.stdin.write("\n")
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert os.listdir(export_dir) == []


def test_killed_process_is_stale_and_pruned(export_dir, capsys):
    proc = _child(_PORT, str(export_dir))
    try:
        assert proc.stdout.readline().split() == ["ready", "False"]
        path = tstats_mod.pid_export_path(proc.pid)
        assert os.path.exists(path)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    assert os.path.exists(path)          # a kill leaves the file behind
    rc, out, _ = _tool(gpu_stat.main, ["-l"], capsys)
    assert rc == 0 and "stale" in out and "(pruned)" in out
    assert not os.path.exists(path)
    rc, _, err = _tool(gpu_stat.main, ["-l"], capsys)
    assert rc == 1 and "no exporting sessions" in err


def test_opt_out_starts_no_exporter(export_dir):
    proc = _child(_PORT, str(export_dir), STROM_STAT_EXPORT="0")
    try:
        assert proc.stdout.readline().split() == ["ready", "True"]
        proc.stdin.write("\n")
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert os.listdir(export_dir) == []


def test_export_fold_runs_concurrently_with_reads(tmp_path):
    """The exporter's hook folds a live Session's native counters on its
    own thread while the main thread reads and asks ``stat_info``: every
    byte is counted once, and a close during the folds is safe."""
    path = _file(tmp_path, 8 * CHUNK)
    config.set("cache_arbitration", False)
    out = str(tmp_path / "fold.json")
    stop, errors = threading.Event(), []
    sess = teng.Session(io_backend="threadpool")
    assert sess._native is not None

    def publish():
        while not stop.is_set():
            try:
                teng._fold_live_native_stats()
                stats.export(out)       # runs the same hook first
            except Exception as e:     # noqa: BLE001 - reported below
                errors.append(e)

    th = threading.Thread(target=publish)
    sess.stat_info()
    before = stats.snapshot()["total_dma_length"]
    th.start()
    try:
        with teng.open_source(path) as src:
            h, buf = sess.alloc_dma_buffer(8 * CHUNK)
            for i in range(24):
                r = sess.memcpy_ssd2ram(src, h, [i % 8, (i + 3) % 8], CHUNK)
                sess.memcpy_wait(r.dma_task_id)
                if i % 5 == 0:
                    sess.stat_info()
            sess.stat_info()
            moved = stats.snapshot()["total_dma_length"] - before
            sess.unmap_buffer(h)
            buf.close()
        sess.close()
    finally:
        stop.set()
        th.join(timeout=30)
    assert not errors, errors
    assert moved == 24 * 2 * CHUNK
    assert json.load(open(out))["counters"]["total_dma_length"] >= \
        before + moved


# -- the stage counts against the reference ----------------------------------

_STAGES = ("nr_ioctl_memcpy_submit", "nr_setup_prps", "nr_ioctl_memcpy_wait")


def _stage_run(eng, mod_stats, snap, path, wpath, backend):
    before = snap(mod_stats)
    with eng.Session(io_backend=backend) as sess:
        h, buf = sess.alloc_dma_buffer(8 * CHUNK)
        with eng.open_source(path) as src:
            for ids in ([0, 1, 2, 3, 4], [7], [2, 6, 5]):
                r = sess.memcpy_ssd2ram(src, h, ids, CHUNK)
                sess.memcpy_wait(r.dma_task_id)
        with eng.open_source(wpath, writable=True) as sink:
            r = sess.memcpy_ram2ssd(sink, h, [1, 0], CHUNK)
            sess.memcpy_wait(r.dma_task_id)
        sess.unmap_buffer(h)
        buf.close()
    after = snap(mod_stats)
    return {k: after[k] - before[k] for k in _STAGES}


@pytest.mark.parametrize("backend", ["python", "threadpool"])
def test_stage_counts_equal_the_references(tmp_path, backend):
    """``ioctl_memcpy_submit`` (one a read or write submit), ``setup_prps``
    (one a planning window, ``submit_window`` 2 here, and one a write) and
    ``ioctl_memcpy_wait`` count as the reference's python pool counts the
    same reads and write, on the python pool and the native rung."""
    path = _file(tmp_path, 8 * CHUNK)
    wpath = str(tmp_path / "w.bin")
    for cfg in (config, jconfig):
        cfg.set("cache_arbitration", False)
        cfg.set("submit_window", 2)
    with open(wpath, "wb") as f:
        f.truncate(2 * CHUNK)
    mine = _stage_run(teng, stats, lambda s: s.snapshot(), path, wpath,
                      backend)
    with open(wpath, "wb") as f:
        f.truncate(2 * CHUNK)
    ref = _stage_run(jeng, jstats, lambda s: s.snapshot().counters, path,
                     wpath, "python")
    assert mine == ref == {"nr_ioctl_memcpy_submit": 4, "nr_setup_prps": 7,
                           "nr_ioctl_memcpy_wait": 4}


def test_staging_landings_count_debug3_as_the_reference(tmp_path):
    """The staged pipeline counts one ``debug3`` a landed batch, as the
    reference's counts its H2D transfers: 6 chunks in batches of 4, then
    the partial tail."""
    chunk = 64 << 10
    path = _file(tmp_path, 6 * chunk + 4096 + 100)
    for cfg in (config, jconfig):
        cfg.set("landing", "staged")
    before = (stats.snapshot(debug=True)["nr_debug3"],
              jstats.snapshot(debug=True).counters["nr_debug3"])
    with teng.open_source(path) as src, \
            teng.Session(io_backend="python") as sess:
        got = load_file_to_device(src, device="cpu", chunk_size=chunk,
                                  staging_bytes=4 * chunk, session=sess)
    with jeng.open_source(path) as src, \
            jeng.Session(io_backend="python") as sess:
        ref = jload(src, chunk_size=chunk, staging_bytes=4 * chunk,
                    session=sess)
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()
    moved = (stats.snapshot(debug=True)["nr_debug3"] - before[0],
             jstats.snapshot(debug=True).counters["nr_debug3"] - before[1])
    assert moved == (3, 3)


# -- gpu_stat against tpu_stat -----------------------------------------------

def _full_payload():
    """A payload in which every scoreboard line of ``-v`` has something to
    say."""
    c = {n: i + 1 for i, n in enumerate(J_FIELDS)}
    c.update(nr_passthru_refusal_nodev=2, cache_unpinned_bytes=1 << 21)
    hist = [0] * 64
    hist[10], hist[20], hist[24] = 5, 3, 1
    return {
        "timestamp_ns": 7, "pid": 4321, "version": 1, "counters": c,
        "backend": "threadpool", "lat_hist": hist,
        "members": {
            "0": {"nreq": 4, "bytes": 4 << 20, "clk_ns": 4_000_000,
                  "p50_ns": 1536, "p95_ns": 3072, "occ_integral_ns": 90,
                  "occ_busy_ns": 30, "errors": 1, "retries": 1,
                  "quarantines": 1, "quarantined": True, "state": "failed",
                  "state_s": 1.5, "knob_window": 8, "knob_cap": 1 << 20,
                  "knob_hedge_ms": 4.0, "knob_step": "window+",
                  "knob_freeze": "member 0 failed"},
            "1": {"nreq": 4, "bytes": 4 << 20, "clk_ns": 40_000_000}},
        "shards": {"0": {"n": 3, "p50_ns": 1536, "p95_ns": 6144},
                   "1": {"n": 1}},
        "tenants": {"t-a": {"class": "latency", "weight": 2.0,
                            "rate": float(1 << 30), "quota_tasks": 4,
                            "quota_bytes": 64 << 20, "tasks": 3,
                            "bytes": 3 << 20, "rejects": 1, "throttles": 2,
                            "inflight_tasks": 1, "inflight_bytes": 1 << 20,
                            "wait_hist": hist},
                    "t-b": {"class": "bulk", "weight": 1.0, "rate": 0.0,
                            "quota_tasks": 0, "quota_bytes": 0, "tasks": 0,
                            "bytes": 0, "rejects": 0, "throttles": 0,
                            "inflight_tasks": 0, "inflight_bytes": 0,
                            "wait_hist": [0] * 64}},
    }


@pytest.mark.parametrize("payload", ["member_stats", "full"])
@pytest.mark.parametrize("argv", [["-v"], [], ["--daemon"]])
def test_one_shot_prints_the_same_lines_as_tpu_stat(tmp_path, capsys,
                                                    monkeypatch, payload,
                                                    argv):
    """``-v``, one-shot and ``--daemon`` without a socket over one payload
    (the one of ``tests/test_member_stats.py``, and one with every
    scoreboard) print what ``tpu_stat`` prints."""
    monkeypatch.setattr(gpu_stat, "_warned_unpinned", False)
    monkeypatch.setattr(tpu_stat, "_warned_unpinned", False)
    path = str(tmp_path / "stat.json")
    with open(path, "w") as f:
        json.dump(MEMBER_PAYLOAD if payload == "member_stats"
                  else _full_payload(), f)
    mine = _tool(gpu_stat.main, argv + ["-f", path], capsys)
    ref = _tool(tpu_stat.main, argv + ["-f", path], capsys)
    assert mine == ref
    assert mine[0] == 0 and mine[1]
    if argv == ["-v"] and payload == "member_stats":
        assert "per-member" in mine[1]
        assert "10.0ms" in mine[1] and " 1.0ms" in mine[1]


@pytest.mark.parametrize("verbose", [False, True])
def test_interval_rows_are_tpu_stats(verbose):
    prev = _full_payload()
    cur = json.loads(json.dumps(prev))
    for k in cur["counters"]:
        cur["counters"][k] *= 3
    cur["lat_hist"][12] += 7
    assert gpu_stat._header(verbose) == tpu_stat._header(verbose)
    assert gpu_stat._row(cur, prev, verbose) == \
        tpu_stat._row(cur, prev, verbose)


def test_usage_errors_and_missing_files(tmp_path, capsys, export_dir):
    path = str(tmp_path / "s.json")
    with open(path, "w") as f:
        json.dump(MEMBER_PAYLOAD, f)
    for argv in (["-f", path, "--json", "1"], ["-l", "-p", "1"],
                 ["-f", path, "-p", "1"]):
        for main in (gpu_stat.main, tpu_stat.main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 2
    capsys.readouterr()
    missing = str(tmp_path / "nope.json")
    for main in (gpu_stat.main, tpu_stat.main):
        rc, _, err = _tool(main, ["-f", missing], capsys)
        assert rc == 1 and "lists sessions" in err
    rc, out, _ = _tool(gpu_stat.main, ["-f", path, "--json"], capsys)
    assert rc == 0 and json.loads(out) == MEMBER_PAYLOAD


def test_no_selector_picks_the_sole_live_session(export_dir, capsys):
    stats.export(tstats_mod.pid_export_path())
    rc, out, err = _tool(gpu_stat.main, ["--json"], capsys)
    assert rc == 0 and json.loads(out)["pid"] == os.getpid()
    assert f"watching pid {os.getpid()}" in err


def test_backends_are_the_engines_rungs():
    assert gpu_stat._BACKENDS == teng._RUNGS


def test_trace_lists_the_ports_dumps(tmp_path, capsys):
    config.set("trace_dir", str(tmp_path))
    rc, _, err = _tool(gpu_stat.main, ["--trace"], capsys)
    assert rc == 1 and str(tmp_path) in err


def test_strom_trace_prom_finds_the_export(export_dir, capsys):
    """``strom_trace --prom`` with no path renders the sole live per-pid
    export, else the well-known file, as the reference's ``prom_cmd``."""
    from nvme_strom_tpu_torch.tools import strom_trace
    rc, _, err = _tool(strom_trace.main, ["--prom"], capsys)
    assert rc == 1 and "no live stats export" in err
    for path, n in ((tstats_mod.DEFAULT_STAT_EXPORT, 11),
                    (tstats_mod.pid_export_path(), 22)):
        with open(path, "w") as f:
            json.dump({"counters": {"nr_ssd2dev": n}, "pid": os.getpid(),
                       "timestamp_ns": 1}, f)
        rc, out, _ = _tool(strom_trace.main, ["--prom"], capsys)
        assert rc == 0 and f"strom_tpu_nr_ssd2dev_total {n}\n" in out


def test_ssd2gpu_test_publishes_the_well_known_file(tmp_path, export_dir,
                                                    capsys):
    """``ssd2gpu_test`` exports to the well-known file while it runs and
    writes its last snapshot there on the way out, as ``ssd2tpu_test``."""
    from nvme_strom_tpu_torch.tools import ssd2gpu_test
    stats.stop_export()     # this process's own exporter, if one runs
    path = _file(tmp_path, 4 * CHUNK)
    rc = ssd2gpu_test.main(["-d", "cpu", "-s", "2m", "-n", "2",
                            "--no-drop-cache", path])
    assert rc == 0, capsys.readouterr()
    snap = json.load(open(tstats_mod.DEFAULT_STAT_EXPORT))
    assert snap["pid"] == os.getpid()
    assert snap["counters"]["nr_ioctl_memcpy_submit"] > 0
    assert stats._exporter is None
    rc, out, _ = _tool(gpu_stat.main, [], capsys)
    assert rc == 0 and "nr_ioctl_memcpy_submit" in out
