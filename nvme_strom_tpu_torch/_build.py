"""Build the package's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers) compiles
on its own into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``), loaded with ``ctypes``.  Outputs go to ``_build/`` beside this file, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads at once.  Builds of several sources run in parallel, one ``nvcc``
each.  A failed build raises: nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

from .api import StromError

__all__ = ["NVCC_FLAGS", "sources", "build_all", "load", "launcher",
           "grid_cap"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in _SRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise StromError(_errno.ENOENT, "nvcc not found (PATH or $CUDA_HOME/bin)")


def _target(name: str) -> Path:
    src = (_SRC / f"{name}.cu").read_bytes()
    # the shared headers are part of every source
    for hdr in sorted(_SRC.glob("*.cuh")):
        src += hdr.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _OUT / f"lib{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes started together.  Returns ``{name: compiler
    output}`` for the sources built by this call."""
    names = list(sources() if names is None else names)
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise StromError(_errno.EIO, "nvcc failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all([name])
            lib = ctypes.CDLL(str(target))
            lib.strom_cuda_error_string.argtypes = [ctypes.c_int]
            lib.strom_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launcher(name: str, symbol: str, argtypes) -> Callable[..., None]:
    """A caller of the launch function *symbol* of ``csrc/<name>.cu`` (a
    C function that returns the launch's ``cudaError_t``).  The library is
    built and bound on the first call, never before; a nonzero return
    raises :class:`StromError` EIO with CUDA's message."""
    bound: list = []

    def call(*args) -> None:
        if not bound:
            lib = load(name)
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            bound[:] = [lib, fn]
        lib, fn = bound
        err = fn(*args)
        if err:
            raise StromError(_errno.EIO, f"{name} kernel launch failed: "
                             + lib.strom_cuda_error_string(err).decode())

    return call


@functools.lru_cache(maxsize=None)
def grid_cap(device_index: int, blocks_per_sm: int) -> int:
    """The most blocks a grid-stride kernel launches on the card: its
    multiprocessors times *blocks_per_sm*."""
    import torch
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count * blocks_per_sm
