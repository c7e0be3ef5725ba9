"""``ssd2gpu_test`` of the PyTorch port, driven on the CPU."""

import errno
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.tools.ssd2gpu_test import main, run_load

ROOT = Path(__file__).resolve().parents[1]


def test_ssd2gpu_test_check_on_cpu_exits_zero(tmp_path):
    path = tmp_path / "f.bin"
    np.random.default_rng(0).integers(0, 256, (3 << 20) + 777,
                                      dtype=np.uint8).tofile(path)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "nvme_strom_tpu_torch.tools.ssd2gpu_test",
         "-c", "-d", "cpu", "-s", "1m", str(path)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "corruption check: all 3145728 bytes OK" in out.stdout
    assert "GB/s" in out.stdout


def test_run_load_reports_counters_and_lands_bytes(tmp_path):
    path = tmp_path / "g.bin"
    data = np.random.default_rng(1).integers(0, 256, 4 << 20,
                                             dtype=np.uint8)
    data.tofile(path)
    # every chunk direct: arbitration would send the warm file write-back
    snap = config.snapshot()
    config.set("cache_arbitration", False)
    try:
        out = run_load(str(path), device="cpu", segments=2,
                       segment_size=1 << 20, chunk=256 << 10, loops=2,
                       drop_cache=False)
    finally:
        config.restore(snap)
    assert out["nbytes"] == 4 << 20 and out["seconds"] > 0
    assert np.array_equal(out["tensor"].numpy(), data)
    assert out["counters"]["nr_ssd2dev"] >= 2
    assert out["counters"]["total_dma_length"] == 2 * (4 << 20)


def test_ssd2gpu_test_without_cuda_raises_enodev(tmp_path):
    path = tmp_path / "h.bin"
    path.write_bytes(b"\0" * (1 << 20))
    with pytest.raises(StromError) as e:
        main([str(path)])
    assert e.value.errno == errno.ENODEV


def test_phase_clock_times_each_phase_from_its_lines(tmp_path):
    """The phase clock splits a run into its tagged phases: a phase
    lasts from the last line before it to its own last line, untagged
    lines belong to the phase before them, and a phase that comes back
    later adds its second block.  Run as a script, it passes the output
    through and keeps the command's exit code."""
    import json

    from nvme_strom_tpu_torch.tools.phase_clock import phase_times
    stamped = [(0.5, "[1] nvidia-smi\n"), (2.0, "[2] build\n"),
               (2.5, "   detail\n"), (4.0, "[3a] B1 ok\n"),
               (4.5, "    [3] took\n"), (7.0, "[2] again\n"),
               (7.5, "total\n")]
    phases, order = phase_times(stamped)
    assert order == ["1", "2", "3"]
    assert phases == {"1": 0.5, "2": 2.0 + 3.0, "3": 2.0}
    script = tmp_path / "phased.py"
    script.write_text("import sys\nprint('[1] a')\nprint('[2] b')\n"
                      "sys.exit(3)\n")
    out = tmp_path / "times.json"
    tool = Path(__file__).resolve().parents[1] / "nvme_strom_tpu_torch" \
        / "tools" / "phase_clock.py"
    r = subprocess.run([sys.executable, str(tool), "--json", str(out),
                        "--", sys.executable, str(script)],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 3 and r.stdout == "[1] a\n[2] b\n"
    got = json.loads(out.read_text())
    assert got["order"] == ["1", "2"] and got["rc"] == 3
    assert set(got["phases"]) == {"1", "2"}
