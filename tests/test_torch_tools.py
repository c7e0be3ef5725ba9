"""``ssd2gpu_test`` of the PyTorch port, driven on the CPU."""

import errno
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nvme_strom_tpu_torch.api import StromError
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
    out = run_load(str(path), device="cpu", segments=2,
                   segment_size=1 << 20, chunk=256 << 10, loops=2,
                   drop_cache=False)
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
