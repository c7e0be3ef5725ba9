"""The PyTorch port stands alone: every module imports with JAX and the
JAX package refused, and with no CUDA device the entry points raise ENODEV
instead of running on the CPU."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "nvme_strom_tpu_torch"
PY_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) \
    + ["chip_smoke.py"]

_SCRIPT = textwrap.dedent("""
    import errno, importlib, pkgutil, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "nvme_strom_tpu"):
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    import nvme_strom_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "nvme_strom_tpu")]
    assert not leaked, leaked
    assert not torch.cuda.is_available()

    from nvme_strom_tpu_torch.api import StromError
    from nvme_strom_tpu_torch.engine import open_source
    from nvme_strom_tpu_torch.hbm.staging import load_file_to_device
    from nvme_strom_tpu_torch.scan.executor import TableScanner
    path = sys.argv[1]
    codes = []
    with open_source(path) as src:
        try:
            load_file_to_device(src)
        except StromError as e:
            codes.append(e.errno)
    with TableScanner(path, chunk_size=1 << 16) as sc:
        try:
            sc.scan_filter(lambda p: {"n": p.shape[0]})
        except StromError as e:
            codes.append(e.errno)
    assert codes == [errno.ENODEV, errno.ENODEV], codes
    print("ISOLATED", len(names))
""")


def test_port_imports_without_jax_and_refuses_cpu_fallback(tmp_path):
    data = tmp_path / "d.bin"
    data.write_bytes(os.urandom(3 << 16))
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(data)],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED" in out.stdout


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|nvme_strom_tpu)\b"
                     r"(?!_torch)", re.M)


@pytest.mark.parametrize("rel", PY_FILES)
def test_no_source_imports_jax_or_the_jax_package(rel):
    assert not _IMPORT.search((ROOT / rel).read_text()), rel
