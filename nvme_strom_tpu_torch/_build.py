"""Build the package's native code at first use.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers) compiles
on its own with ``nvcc`` into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``), loaded with ``ctypes``.  The
native I/O engine, ``csrc/strom_engine.cc`` with its C ABI header
``csrc/strom_tpu.h``, and the host crc32c, ``csrc/strom_crc32c.cc``,
compile with ``g++`` (the flags of the JAX package's engine build:
``-O2 -std=c++17 -fPIC -pthread -shared``).
Outputs go to ``_build/`` beside this file, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads at once.  Builds of several sources run in parallel, one compiler
process each.  A failed build raises: nothing falls back to a plain
version or to another engine.
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
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

from .api import StromError

__all__ = ["NVCC_FLAGS", "GXX_FLAGS", "ENGINE", "CRC32C", "HOST_SOURCES",
           "sources", "build_all", "build_times", "engine_library",
           "host_library", "load", "launcher", "grid_cap", "smem_optin"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the native I/O engine: its name in :func:`build_all`'s logs and
#: :data:`build_times`
ENGINE = "strom_engine"
#: the host crc32c (SSE4.2 or slicing-by-8), for checkpoint checksums
CRC32C = "strom_crc32c"
#: the ``csrc/<name>.cc`` sources ``g++`` builds
HOST_SOURCES = (ENGINE, CRC32C)
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds from the start of the last :func:`build_all` to each of its
#: compiler processes' end, by source name
build_times: Dict[str, float] = {}


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in _SRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise StromError(_errno.ENOENT, "nvcc not found (PATH or $CUDA_HOME/bin)")


def _gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise StromError(_errno.ENOENT, "g++ not found on PATH")
    return cand


def _host_target(name: str) -> Path:
    src = (_SRC / f"{name}.cc").read_bytes()
    if name == ENGINE:
        src += (_SRC / "strom_tpu.h").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return _OUT / f"lib{name}-{digest[:16]}.so"


def _engine_target() -> Path:
    return _host_target(ENGINE)


def _target(name: str) -> Path:
    if name in HOST_SOURCES:
        return _host_target(name)
    src = (_SRC / f"{name}.cu").read_bytes()
    # the shared headers are part of every source
    for hdr in sorted(_SRC.glob("*.cuh")):
        src += hdr.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _OUT / f"lib{name}-{digest[:16]}.so"


def _command(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        return [_gxx(), *GXX_FLAGS, "-o", str(out),
                str(_SRC / f"{name}.cc")]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_SRC / f"{name}.cu")]


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, all
    compiler processes started together.  *names* are kernel sources and
    :data:`HOST_SOURCES`; the default is every kernel and host source.
    Returns ``{name: compiler output}`` for the sources built by this
    call, and sets :data:`build_times`."""
    names = list([*sources(), *HOST_SOURCES] if names is None else names)
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    build_times.clear()
    # the g++ builds end first: waiting on them first times them alone
    for name, (proc, tmp, target) in sorted(
            procs.items(), key=lambda kv: kv[0] not in HOST_SOURCES):
        out, _ = proc.communicate()
        build_times[name] = time.monotonic() - t0
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise StromError(_errno.EIO, "build failed: " + "\n".join(failed))
    return logs


def host_library(name: str) -> str:
    """Path of the library of ``csrc/<name>.cc`` (one of
    :data:`HOST_SOURCES`), built first if needed."""
    with _lock:
        target = _host_target(name)
        if not target.exists():
            build_all([name])
        return str(target)


def engine_library() -> str:
    """Path of the native engine's library, built first if needed."""
    return host_library(ENGINE)


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
def smem_optin(device_index: int) -> int:
    """The most shared memory, in bytes, one block may opt into on the
    card (232,448 on an H100), read from the CUDA runtime."""
    lib = load("filter")
    fn = lib.strom_smem_optin
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    nbytes = ctypes.c_int(0)
    err = fn(device_index, ctypes.byref(nbytes))
    if err or nbytes.value <= 0:
        raise StromError(_errno.EIO, "shared-memory limit query failed: "
                         + lib.strom_cuda_error_string(err).decode())
    return nbytes.value


@functools.lru_cache(maxsize=None)
def grid_cap(device_index: int, blocks_per_sm: int) -> int:
    """The most blocks a grid-stride kernel launches on the card: its
    multiprocessors times *blocks_per_sm*."""
    import torch
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count * blocks_per_sm
