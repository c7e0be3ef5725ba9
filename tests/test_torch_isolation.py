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
    for mod in ("ops.groupby", "ops.groupby_cuda", "ops.decode",
                "ops.decode_cuda", "scan.colpack", "scan.planner",
                "scan.query", "stripe", "ops.permute", "ops.permute_cuda",
                "parallel", "parallel.mesh", "parallel.ring",
                "parallel.stream", "parallel.shardload", "_native", "trace",
                "tools.strom_trace", "testing", "testing.trace_gate",
                "testing.fake", "data", "data.records", "data.loader",
                "data.checkpoint", "data.dtypes", "tools.strom_ckpt",
                "ops.topk", "scan.index", "scan.executor", "ops.join",
                "scan.sql", "scan.parallel", "eligibility", "scan.strings",
                "tools.strom_query", "fault", "testing.chaos",
                "testing.stress_faults", "integrity", "tiering", "cache",
                "serving", "serving.hbm_tier", "testing.cache_gate",
                "testing.tier_gate", "testing.scrub_gate",
                "tools.phase_clock", "autotune", "daemon", "daemon.qos",
                "testing.autotune_gate", "testing.landing_gate",
                "testing.pushdown_gate", "blockmap", "numa",
                "testing.passthru_emu", "testing.passthru_gate",
                "serving.weights", "serving.kvcache",
                "testing.coldstart_gate", "parallel.dscan",
                "parallel.exchange", "parallel.sort", "parallel.pjoin",
                "testing.multichip_gate", "parallel.dist",
                "daemon.protocol", "daemon.client", "daemon.server",
                "testing.distributed", "testing.qos_gate",
                "tools.strom_daemon",
                # the stat tool reads export files and a daemon's socket
                # and touches no device, so it runs where there is no
                # card, as the reference's tpu_stat does: it is not among
                # the entry points below that must raise ENODEV
                "tools.gpu_stat"):
        assert pkg.__name__ + "." + mod in names, mod
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
    from nvme_strom_tpu_torch.scan.heap import HeapSchema
    from nvme_strom_tpu_torch.scan.query import Query
    try:
        Query(path, HeapSchema(n_cols=2)).aggregate([0]).run()
    except StromError as e:
        codes.append(e.errno)
    from nvme_strom_tpu_torch.parallel import make_ring_multi_query_scan
    try:
        make_ring_multi_query_scan()
    except StromError as e:
        codes.append(e.errno)
    try:
        Query(path, HeapSchema(n_cols=2)).fetch([0])
    except StromError as e:
        codes.append(e.errno)
    try:    # before any worker process starts
        Query(path, HeapSchema(n_cols=2)).aggregate([0]).run(workers=2)
    except StromError as e:
        codes.append(e.errno)
    assert codes == [errno.ENODEV] * 6, codes
    # the HBM tier places on the card or nowhere: no CPU stand-in
    from nvme_strom_tpu_torch.config import config
    from nvme_strom_tpu_torch.serving.hbm_tier import hbm_tier
    config.set("tier_hbm_bytes", 1 << 20)
    hbm_tier.configure()
    assert hbm_tier.admit(("#x",), 0, 4096, bytes(4096)) is False
    from nvme_strom_tpu_torch.testing import cache_gate, scrub_gate, tier_gate
    assert [g.main([]) for g in (cache_gate, tier_gate, scrub_gate)] \
        == [2, 2, 2]
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


def _meta_pages(n=2):
    import torch
    return torch.zeros((n, 8192), dtype=torch.uint8, device="meta")


@pytest.mark.parametrize("case", ["callable key", "callable predicate",
                                  "G above the cap", "decode callable",
                                  "ring permute"])
def test_non_cpu_tensor_never_reaches_a_plain_version(case):
    """A tensor that is not on the CPU (a meta tensor here, a CUDA tensor
    on the card) goes to the kernel or raises EINVAL: a callable key or
    predicate and a G above the kernel's cap are refused, never run by the
    plain version."""
    import errno

    from nvme_strom_tpu_torch.api import StromError
    from nvme_strom_tpu_torch.ops import decode_cuda, groupby_cuda, \
        permute_cuda
    from nvme_strom_tpu_torch.ops.filter import FilterPred
    from nvme_strom_tpu_torch.ops.groupby import GroupKey
    from nvme_strom_tpu_torch.scan.colpack import ColCodec, PackedMeta
    from nvme_strom_tpu_torch.scan.heap import HeapSchema
    schema = HeapSchema(n_cols=2)
    before = (groupby_cuda.launches, decode_cuda.launches,
              permute_cuda.launches)
    with pytest.raises(StromError) as e:
        if case == "callable key":
            groupby_cuda.groupby_pages_cuda(
                _meta_pages(), 0, schema, lambda c, t: c[1] % 4, 4,
                agg_cols=[0])
        elif case == "callable predicate":
            groupby_cuda.groupby_pages_cuda(
                _meta_pages(), 0, schema, GroupKey(1, 4), 4, agg_cols=[0],
                predicate=lambda c, t: c[0] > t)
        elif case == "G above the cap":
            g = groupby_cuda.MAX_GROUPS + 1
            groupby_cuda.groupby_pages_cuda(
                _meta_pages(), 0, schema, GroupKey(1, g), g, agg_cols=[0],
                predicate=FilterPred(((0, "gt", 1),)))
        elif case == "ring permute":
            permute_cuda.ring_permute_cuda([_meta_pages()] * 2)
        else:
            meta = PackedMeta(1, 32, 1, 32, ("int32",),
                              (ColCodec("raw", 16, 32),), 0, 0)
            decode_cuda.decode_filter_pages_cuda(
                _meta_pages(), 0, meta, lambda c, t: c[0] > t)
    assert e.value.errno == errno.EINVAL
    if case == "G above the cap":
        assert str(groupby_cuda.MAX_GROUPS) in str(e.value)
    elif case == "ring permute":
        assert "CUDA tensors" in str(e.value)
    else:
        assert "callable" in str(e.value)
    assert (groupby_cuda.launches, decode_cuda.launches,
            permute_cuda.launches) == before


#: what names the JAX package's native build: its library, its directory,
#: its Makefile (and the make that runs it)
_JAX_BUILD = re.compile(r"nvme_strom_tpu[/.]_native|libstrom_tpu\.so|"
                        r"csrc/Makefile|make\s+-C|[\"']\.\./csrc|"
                        r"parents?\[\d\]\s*/\s*[\"']csrc")

#: the port's native sources, its build file and chip_smoke.py
_NATIVE_FILES = sorted(
    [str(p.relative_to(ROOT)) for p in (PORT / "csrc").iterdir()]
    + PY_FILES)


@pytest.mark.parametrize("rel", _NATIVE_FILES)
def test_no_port_file_names_the_jax_packages_native_build(rel):
    """The port builds its own engine from its own csrc/: no file names
    the root csrc/ or the JAX package's _native build."""
    assert not _JAX_BUILD.search((ROOT / rel).read_text()), rel


def test_engine_builds_from_the_ports_own_sources():
    from nvme_strom_tpu_torch import _build
    assert _build._SRC == PORT / "csrc"
    assert _build._OUT == PORT / "_build"
    cmd = _build._command(_build.ENGINE, _build._OUT / "x.so")
    assert cmd[-1] == str(PORT / "csrc" / "strom_engine.cc")
    assert tuple(cmd[1:6]) == _build.GXX_FLAGS == \
        ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")
    assert str(_build._engine_target()).startswith(str(PORT / "_build"))
