"""Runtime knobs of the SSD→GPU path.

A reduced copy of the JAX package's GUC-style registry: only the knobs this
package reads, under the same names, defaults and bounds.  Values are set
at run time with :meth:`Config.set`; there is no file or environment tier.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = ["ConfigError", "Config", "config", "parse_size"]


class ConfigError(ValueError):
    pass


_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_size(s: str) -> int:
    """Parse '256k', '16m', '1g' or a plain integer (bytes)."""
    v = s.strip().lower()
    if v and v[-1] in _SUFFIX:
        return int(float(v[:-1]) * _SUFFIX[v[-1]])
    return int(v, 0)


def _pow2(val: int) -> None:
    if val & (val - 1):
        raise ConfigError(f"value {val} must be a power of two")


def _landing(val: str) -> None:
    if val not in ("auto", "direct", "staged"):
        raise ConfigError(f"landing must be auto|direct|staged, got {val!r}")


def _pushdown(val: str) -> None:
    if val not in ("auto", "on", "off"):
        raise ConfigError(f"pushdown must be auto|on|off, got {val!r}")


def _pushdown_codecs(val: str) -> None:
    bad = [c for c in val.split(",") if c.strip()
           and c.strip() not in ("bitpack", "dict", "rle")]
    if bad:
        raise ConfigError(f"pushdown_codecs must be a comma list of "
                          f"bitpack|dict|rle, got {bad[0]!r}")


@dataclass(frozen=True)
class _Var:
    default: Any
    kind: type
    minval: Optional[float] = None
    maxval: Optional[float] = None
    check: Optional[Callable[[Any], None]] = None

    def parse(self, name: str, raw: Any) -> Any:
        if self.kind is bool:
            if isinstance(raw, str):
                raw = raw.strip().lower() in ("1", "true", "on", "yes")
            return bool(raw)
        if self.kind is int and isinstance(raw, str):
            val = parse_size(raw)
        else:
            val = self.kind(raw)
        if self.minval is not None and val < self.minval:
            raise ConfigError(f"{name}={val} below minimum {self.minval}")
        if self.maxval is not None and val > self.maxval:
            raise ConfigError(f"{name}={val} above maximum {self.maxval}")
        if self.check is not None:
            self.check(val)
        return val


_VARS: Dict[str, _Var] = {
    # scan chunk size and staging batch (default 16MB)
    "chunk_size": _Var(16 << 20, int, 1 << 16, 1 << 30, _pow2),
    # in-flight DMA tasks per scan ring
    "async_depth": _Var(8, int, 1, 1024),
    # ceiling of the adaptive H2D pipeline depth of a scan
    "h2d_depth_max": _Var(4, int, 1, 64),
    # pinned host staging buffers of the SSD->device pipeline
    "staging_buffers": _Var(3, int, 2, 16),
    # seconds a device fence may block before the backend is declared
    # lost (0 = unbounded)
    "backend_fence_timeout": _Var(60.0, float, 0.0),
    # mlock DMA buffers so the kernel cannot migrate pages mid-I/O
    "pin_memory": _Var(False, bool),
    # largest merged read request
    "dma_max_size": _Var(1 << 20, int, 4 << 10, 16 << 20, _pow2),
    # destination landing: auto | direct (CPU only) | staged
    "landing": _Var("auto", str, check=_landing),
    # packed-sidecar (.cpk) scans of aggregates: auto | on | off
    "pushdown": _Var("auto", str, check=_pushdown),
    # codecs the packed-extent encoder may choose (raw is always there)
    "pushdown_codecs": _Var("bitpack,dict,rle", str,
                            check=_pushdown_codecs),
    # least codec ratio (logical / packed bytes) for on-device expansion
    "pushdown_chip_ratio": _Var(1.15, float, 1.0),
    # planner's host->device and SSD read rates in GB/s (0 = measured)
    "pushdown_h2d_gbps": _Var(0.0, float, 0.0),
    "pushdown_ssd_gbps": _Var(0.0, float, 0.0),
}


class Config:
    """Thread-safe knob store."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values = {k: v.default for k, v in _VARS.items()}

    def get(self, name: str) -> Any:
        with self._lock:
            try:
                return self._values[name]
            except KeyError:
                raise ConfigError(f"unknown config var {name}") from None

    def set(self, name: str, raw: Any) -> None:
        var = _VARS.get(name)
        if var is None:
            raise ConfigError(f"unknown config var {name}")
        val = var.parse(name, raw)
        with self._lock:
            self._values[name] = val

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._values)

    def restore(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            self._values = dict(snap)


#: process-wide store
config = Config()
