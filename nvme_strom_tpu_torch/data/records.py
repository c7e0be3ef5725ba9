"""Fixed-stride record files: the on-disk unit of the training-input path.

Records are padded to a power-of-two stride so that (a) a record never
straddles an engine chunk — chunks are the shuffle and DMA unit — and
(b) every record offset is O_DIRECT-alignable.  The same trade the
reference makes with PostgreSQL's pow2 BLCKSZ pages (`utils/utils_common.h:
26-27`): alignment buys the direct path, padding is the price.

Layout: ``path`` holds ``count`` records at ``stride`` bytes each
(record payload first, zero pad after); ``path + ".meta.json"`` holds
``{record_bytes, stride, count, dtype, shape, version}``.

The JAX package's format byte for byte (numpy only): either package
writes the same data file and meta file for the same array, and reads the
other's.
"""

from __future__ import annotations

import errno as _errno
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..api import StromError

__all__ = ["RecordDataset", "RecordWriter", "write_records", "next_pow2"]

_META_SUFFIX = ".meta.json"
_VERSION = 1
_MIN_STRIDE = 512  # O_DIRECT logical-block floor


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


class RecordWriter:
    """Stream records of one dtype/shape into a record file."""

    def __init__(self, path: str, dtype, shape: Sequence[int]):
        self.path = path
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.record_bytes = int(self.dtype.itemsize * np.prod(self.shape, dtype=np.int64)) \
            if self.shape else self.dtype.itemsize
        if self.record_bytes <= 0:
            raise StromError(_errno.EINVAL, "empty record shape")
        self.stride = max(next_pow2(self.record_bytes), _MIN_STRIDE)
        self._pad = b"\0" * (self.stride - self.record_bytes)
        self._f = open(path, "wb")
        self.count = 0

    def write(self, record: np.ndarray) -> None:
        rec = np.ascontiguousarray(record, dtype=self.dtype)
        if rec.shape != self.shape:
            raise StromError(_errno.EINVAL,
                             f"record shape {rec.shape} != {self.shape}")
        self._f.write(rec.tobytes())
        if self._pad:
            self._f.write(self._pad)
        self.count += 1

    def write_batch(self, batch: np.ndarray) -> None:
        for rec in batch:
            self.write(rec)

    def close(self) -> None:
        if self._f is None:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = None
        with open(self.path + _META_SUFFIX, "w") as m:
            json.dump({"version": _VERSION,
                       "record_bytes": self.record_bytes,
                       "stride": self.stride,
                       "count": self.count,
                       "dtype": self.dtype.str,
                       "shape": list(self.shape)}, m)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str, array: np.ndarray) -> "RecordDataset":
    """Write ``array[i]`` as record *i*; returns the opened dataset."""
    with RecordWriter(path, array.dtype, array.shape[1:]) as w:
        w.write_batch(array)
    return RecordDataset(path)


class RecordDataset:
    """Metadata handle over a record file (no fds held; sources are opened
    by the loader so striped/segmented specs work unchanged)."""

    def __init__(self, path: str):
        self.path = path
        try:
            with open(path + _META_SUFFIX) as m:
                meta = json.load(m)
        except FileNotFoundError:
            raise StromError(_errno.ENOENT, f"no record meta for {path}")
        if meta.get("version") != _VERSION:
            raise StromError(_errno.EINVAL,
                             f"record meta version {meta.get('version')}")
        self.record_bytes = int(meta["record_bytes"])
        self.stride = int(meta["stride"])
        self.count = int(meta["count"])
        self.dtype = np.dtype(meta["dtype"])
        self.shape: Tuple[int, ...] = tuple(meta["shape"])

    def __len__(self) -> int:
        return self.count

    def records_per_chunk(self, chunk_size: int) -> int:
        if chunk_size % self.stride:
            raise StromError(_errno.EINVAL,
                             f"chunk {chunk_size} not a multiple of record "
                             f"stride {self.stride}")
        return chunk_size // self.stride

    def decode(self, raw: np.ndarray, n_records: Optional[int] = None) -> np.ndarray:
        """Strip stride padding from a raw byte block of whole records."""
        rows = raw.reshape(-1, self.stride)[:, :self.record_bytes]
        if n_records is not None:
            rows = rows[:n_records]
        return np.ascontiguousarray(rows).view(self.dtype).reshape(
            (-1,) + self.shape)
