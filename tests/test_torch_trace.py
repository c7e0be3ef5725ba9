"""The flight recorder of the PyTorch port against the JAX package's.

The same event tuples and stats payloads go through both packages' export
functions (``chrome_trace_from_events``, ``validate_chrome_trace``,
``summarize_chrome_trace``, ``render_prometheus``); the same seeded file
goes through both loads with ``trace_policy=all`` and must yield the same
span names.  Also: the sampling policy, the dump and its tool, the
multi-host spans, and that every event the port emits is in the
recorder's schema."""

import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

import nvme_strom_tpu.engine as jeng
import nvme_strom_tpu.trace as jtrace
import nvme_strom_tpu_torch.engine as teng
import nvme_strom_tpu_torch.trace as ttrace
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu_torch.config import config as tcfg

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    # the direct path, as the JAX package's tests pin it: arbitration
    # would send the freshly written, page-cache-warm files write-back
    tcfg.set("cache_arbitration", False)
    yield
    tcfg.restore(snap)
    ttrace.recorder.configure()
    ttrace.recorder.clear()


def _events(seed=0, n=40):
    """Seeded ring tuples: (ts, dur|None, name, trace id, member, lane,
    offset, length, args)."""
    rng = np.random.default_rng(seed)
    names = ["plan", "nvme", "wait", "landing", "submit", "native_submit",
             "staging_retire", "cache_hit", "shard_load"]
    out = []
    for i in range(n):
        name = names[int(rng.integers(0, len(names)))]
        span = name not in ("submit", "native_submit")
        out.append((int(rng.integers(0, 10 ** 9)),
                    int(rng.integers(0, 10 ** 6)) if span else None, name,
                    int(rng.integers(0, 4)), int(rng.integers(-1, 4)),
                    int(rng.integers(-1, 3)), int(rng.integers(-1, 1 << 20)),
                    int(rng.integers(0, 1 << 20)),
                    {"k": int(rng.integers(0, 9))} if i % 3 else None))
    return sorted(out, key=lambda e: e[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_summary_and_validation_match_reference(seed):
    evs = _events(seed)
    mine = ttrace.chrome_trace_from_events(evs, reason="r", dropped=seed)
    ref = jtrace.chrome_trace_from_events(evs, reason="r", dropped=seed)
    assert mine == ref
    assert ttrace.validate_chrome_trace(mine) == []
    assert ttrace.summarize_chrome_trace(mine) == \
        jtrace.summarize_chrome_trace(ref)


@pytest.mark.parametrize("doc", [
    [], {"traceEvents": "x"},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"ph": "f", "id": 3, "name": "t", "pid": 1, "tid": 1,
                      "ts": 1}, {"ph": "?"}, 7]},
    {"traceEvents": [{"ph": "i", "name": 5, "pid": "p", "tid": 1}]},
])
def test_validation_errors_match_reference(doc):
    assert ttrace.validate_chrome_trace(doc) == \
        jtrace.validate_chrome_trace(doc)


def test_render_prometheus_matches_reference():
    rng = np.random.default_rng(4)
    hist = [int(x) for x in rng.integers(0, 50, 64)]
    payload = {"timestamp_ns": 123, "pid": 9,
               "counters": {"nr_submit_dma": 10, "total_dma_length": 4096,
                            "cur_dma_count": 2, "nr_backend_fallback": 1,
                            "nr_debug1": 3, "bytes_staging_copy": 4096,
                            "occ_busy_ns": 55},
               "members": {"0": {"nreq": 3, "bytes": 30, "clk_ns": 7},
                           "1": {"nreq": 1, "bytes": 8, "clk_ns": 2}},
               "lat_hist": hist}
    assert ttrace.render_prometheus(payload) == \
        jtrace.render_prometheus(payload)


def test_port_payload_renders_like_reference(tmp_path):
    """The port's own stats payload through both renderers."""
    from nvme_strom_tpu_torch.stats import stats
    stats.observe_latency(5000)
    stats.member_add(0, 4096, 100)
    payload = json.loads(json.dumps(stats.export_payload()))
    assert ttrace.render_prometheus(payload) == \
        jtrace.render_prometheus(payload)


def test_sampling_policy_matches_reference():
    picked = {}
    for mod, cfg in ((ttrace, tcfg), (jtrace, jcfg)):
        cfg.set("trace_policy", "sampled")
        cfg.set("trace_sample_rate", 0.25)
        rec = mod.FlightRecorder()
        rec.configure()
        picked[mod] = [rec.task_begin(t) for t in range(1, 21)]
        cfg.set("trace_policy", "off")
        rec.configure()
        assert not rec.active and rec.task_begin(99) == 0
    assert picked[ttrace] == picked[jtrace]
    assert sum(1 for t in picked[ttrace] if t) == 5


def _load(mod, cfg, path, engine_backend="uring"):
    cfg.set("trace_policy", "all")
    cfg.set("landing", "staged")
    cfg.set("cache_arbitration", False)   # every chunk direct
    # uring: no passthrough probe, both; auto: the rung probed first
    cfg.set("engine_backend", engine_backend)
    mod_trace = ttrace if mod is teng else jtrace
    mod_trace.recorder.configure()
    mod_trace.recorder.clear()
    if mod is teng:
        from nvme_strom_tpu_torch.hbm.staging import load_file_to_device
        kw = {"device": "cpu"}
    else:
        from nvme_strom_tpu.hbm.staging import load_file_to_device
        kw = {}
    with mod.open_source(path) as src:
        out = load_file_to_device(src, chunk_size=1 << 20, **kw)
    evs = mod_trace.recorder.snapshot_events()
    mod_trace.recorder.clear()
    return np.asarray(out).view(np.uint8).ravel().tobytes(), evs


def test_traced_load_yields_the_reference_spans(tmp_path):
    path = str(tmp_path / "f.bin")
    data = np.random.default_rng(1).integers(0, 256, (4 << 20) + 8192,
                                             dtype=np.uint8)
    data.tofile(path)
    got, mine = _load(teng, tcfg, path)
    want, ref = _load(jeng, jcfg, path)
    assert got == want == data.tobytes()
    names = sorted({e[2] for e in mine})
    assert names == sorted({e[2] for e in ref})
    assert {"submit", "plan", "native_submit", "nvme", "wait", "landing",
            "staging_retire"} <= set(names)
    doc = ttrace.chrome_trace_from_events(mine)
    assert ttrace.validate_chrome_trace(doc) == []
    assert sum(e[7] for e in mine if e[2] == "nvme") == data.size


def _fallback_reasons(evs):
    return sorted((e[8] or {}).get("reason") for e in evs
                  if e[2] == "passthru_fallback")


def test_auto_load_yields_the_reference_spans_and_rung_refusal(tmp_path):
    """Under the default ``engine_backend=auto`` both packages probe the
    passthrough rung first: on a host where it refuses, the traced load
    carries the same spans and one ``passthru_fallback`` instant with the
    same reason.  Without the JAX package's native library its Session
    opens no engine and probes nothing, so the port's auto load is then
    held against its own uring load plus that instant, and its reason
    against the JAX package's name for the port's probe."""
    import nvme_strom_tpu._native as jnat
    import nvme_strom_tpu_torch._native as tnat
    path = str(tmp_path / "a.bin")
    data = np.random.default_rng(2).integers(0, 256, (2 << 20) + 4096,
                                             dtype=np.uint8)
    data.tofile(path)
    got, mine = _load(teng, tcfg, path, "auto")
    if jnat.native_available():
        want, ref = _load(jeng, jcfg, path, "auto")
    else:
        want, ref = _load(teng, tcfg, path)
        probe = tnat.passthru_probe(teng._resolve_passthru_dev())
        ref.append((0, None, "passthru_fallback", 0, -1, -1, -1, 0,
                    {"reason": jnat.PASSTHRU_REASONS.get(probe, "nodev")}))
    assert got == want == data.tobytes()
    assert sorted({e[2] for e in mine}) == sorted({e[2] for e in ref})
    if tnat.passthru_probe(teng._resolve_passthru_dev()) < 0:
        assert len(_fallback_reasons(mine)) == 1
        assert _fallback_reasons(mine) == _fallback_reasons(ref)


def test_dump_list_and_strom_trace_tool(tmp_path, capsys):
    from nvme_strom_tpu_torch.tools import strom_trace
    tcfg.set("trace_dir", str(tmp_path))
    tcfg.set("trace_policy", "all")
    rec = ttrace.recorder
    rec.configure()
    rec.span("plan", 10, 20, tid=1)
    first = rec.dump(reason="one")
    os.utime(first, (1, 1))                 # older
    rec.instant("submit", tid=2)
    second = rec.dump(reason="two")
    assert ttrace.list_dumps() == [first, second]
    assert strom_trace.main(["--check", second]) == 0
    assert strom_trace.main(["--last"]) == 0
    out = capsys.readouterr().out
    # the newest dump: the reference's --last takes list_dumps()[0], the
    # oldest, against its own help text (ROADMAP Queue C)
    assert f"{second}:" in out and f"{first}:" not in out
    assert strom_trace.main(["-l"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith(second) and lines[1].endswith(first)
    stat = tmp_path / "payload.json"
    from nvme_strom_tpu_torch.stats import stats
    stat.write_text(json.dumps(stats.export_payload()))
    assert strom_trace.main(["--prom", str(stat)]) == 0
    assert "strom_tpu_export_timestamp_ns" in capsys.readouterr().out


def test_trace_gate_runs_on_the_cpu(tmp_path):
    from nvme_strom_tpu_torch.testing.trace_gate import gate
    path = str(tmp_path / "g.bin")
    np.random.default_rng(0).integers(0, 256, 8 << 20,
                                      dtype=np.uint8).tofile(path)
    res = gate(path, device="cpu", runs=1, limit_pct=1e9)
    assert res["ok"] and res["off_median"] > 0 and res["sampled_median"] > 0
    assert tcfg.get("trace_policy") == "off"


def _emitted_names():
    pat = re.compile(r"""\.(span|instant)\(\s*["']([a-z0-9_]+)["']""")
    out = {}
    for p in (ROOT / "nvme_strom_tpu_torch").rglob("*.py"):
        for kind, name in pat.findall(p.read_text()):
            out.setdefault(name, set()).add(kind)
    return out


def test_every_emitted_event_is_in_the_schema():
    emitted = _emitted_names()
    assert {"plan", "wait", "landing", "staging_retire", "shard_load",
            "ici_permute", "shard_wait", "pushdown_decode", "b1_filter",
            "b2_decode", "b3_groupby", "b4_permute"} <= set(emitted)
    for name, kinds in emitted.items():
        assert name in ttrace.EVENT_SCHEMA, name
        want = ttrace.EVENT_SCHEMA[name]
        assert want == "any" or kinds == {want}, (name, kinds)
    for name, kind in jtrace.EVENT_SCHEMA.items():
        assert ttrace.EVENT_SCHEMA[name] == kind


def test_trace_off_records_nothing(tmp_path):
    path = str(tmp_path / "f.bin")
    np.random.default_rng(2).integers(0, 256, 1 << 20,
                                      dtype=np.uint8).tofile(path)
    tcfg.set("trace_policy", "off")
    ttrace.recorder.clear()
    from nvme_strom_tpu_torch.hbm.staging import load_file_to_device
    with teng.open_source(path) as src:
        load_file_to_device(src, chunk_size=1 << 18, device="cpu")
    assert not ttrace.recorder.active
    assert ttrace.recorder.snapshot_events() == []
