"""Dictionary-encoded string columns over the numeric heap.

A port of the JAX package's ``scan/strings.py``.  The heap format is
4-byte numeric by design.  Strings ride it as **sorted-dictionary codes**:
a string column stores uint32 ranks into a per-column dictionary sidecar
(``<table>.dict<col>``), and because the dictionary is sorted, code order
is lexicographic string order, so every numeric machine of the scan tier
works on strings unchanged:

* equality: ``WHERE city = 'Berlin'`` -> ``code == rank('Berlin')`` (an
  absent string matches nothing, the ``where_eq`` unrepresentable rule)
* ranges: ``WHERE city BETWEEN 'A' AND 'C'`` -> a code range through
  ``np.searchsorted`` bounds (absent endpoints bind to their rank
  position, which keeps the lexicographic meaning)
* ORDER BY, GROUP BY, index sidecars on a string column: the codes are
  the keys; results decode back to strings at the edge

The dictionary is static per table build.  It is stamped against the
table (size and ``st_mtime_ns``) like an index sidecar, so a stale
dictionary fails loudly instead of decoding wrong strings.  The sidecar's
JSON layout and stamp are the JAX package's: each package reads the
other's files.

Unlike the JAX package, :meth:`StringDict.decode` takes NULL rows (a mask,
or None entries) and returns None there.  The module is numpy-only: it
runs at the result's edge, on the host.
"""

from __future__ import annotations

import errno as _errno
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..api import StromError

__all__ = ["StringDict", "encode_strings", "dict_path_for",
           "save_dict", "load_dict"]

_MAGIC = "strom-strdict-v1"


def dict_path_for(table_path: str, col: int) -> str:
    return f"{table_path}.dict{int(col)}"


class StringDict:
    """A sorted string dictionary: ``code = rank`` (lexicographic)."""

    def __init__(self, values: Sequence[str]):
        vals = sorted(set(str(v) for v in values))
        if len(vals) >= (1 << 32):
            raise StromError(_errno.ENOMEM, "string dictionary exceeds "
                                            "uint32 codes")
        self._set(vals)

    def _set(self, vals: List[str]) -> None:
        self.values: List[str] = vals
        self._rank = {v: i for i, v in enumerate(vals)}

    def __len__(self) -> int:
        return len(self.values)

    def encode(self, strings) -> np.ndarray:
        """uint32 codes; an unknown string raises EINVAL (the build-time
        API)."""
        try:
            return np.fromiter((self._rank[str(s)] for s in strings),
                               np.uint32, count=len(strings))
        except KeyError as e:
            raise StromError(_errno.EINVAL, f"string {e.args[0]!r} not in "
                                            f"the dictionary") from None

    def code_of(self, s: str) -> Optional[int]:
        """Rank of *s*, or None when absent (query-time equality: the
        match-nothing rule, like an unrepresentable numeric literal)."""
        return self._rank.get(str(s))

    def range_codes(self, lo: Optional[str],
                    hi: Optional[str]) -> Tuple[Optional[int],
                                                Optional[int]]:
        """Inclusive code bounds equivalent to the string range ``lo <= s
        <= hi``: absent endpoints bind through searchsorted, so
        ``hi='C'`` excludes 'Ca' and includes 'C' itself when present."""
        vals = np.asarray(self.values)
        clo = None if lo is None else \
            int(np.searchsorted(vals, str(lo), side="left"))
        chi = None if hi is None else \
            int(np.searchsorted(vals, str(hi), side="right")) - 1
        return clo, chi

    def decode(self, codes, nulls=None) -> np.ndarray:
        """Object array of the strings of *codes*, None at NULL rows: where
        *nulls* (a bool mask, True = NULL) is set, or where *codes* holds
        None or NaN.  A code outside the dictionary raises EINVAL."""
        raw = np.asarray(codes)
        if raw.dtype.kind == "O" or raw.ndim == 0:
            raw = np.asarray(codes, dtype=object).reshape(-1)
            null = np.array([c is None for c in raw], bool)
        else:
            raw = raw.reshape(-1)
            null = np.zeros(len(raw), bool)
        if raw.dtype.kind == "f":
            null |= np.isnan(raw)   # MIN/MAX of an all-NULL group
        if nulls is not None:
            null |= np.asarray(nulls, bool).reshape(-1)
        idx = np.zeros(len(raw), np.int64)
        live = ~null
        idx[live] = np.asarray(raw[live].tolist() if raw.dtype.kind == "O"
                               else raw[live], np.int64)
        if live.any() and (idx[live].min() < 0
                           or idx[live].max() >= len(self.values)):
            raise StromError(_errno.EINVAL, "code outside the dictionary "
                                            "(stale sidecar?)")
        # one vectorised take: a select face can decode millions of rows
        out = np.array(self.values, dtype=object)[idx] if len(self.values) \
            else np.full(len(raw), None, object)
        out[null] = None
        return out


def encode_strings(strings) -> Tuple[np.ndarray, StringDict]:
    """Build-time helper: ``(uint32 codes, dict)`` for a string column."""
    d = StringDict(strings)
    return d.encode(strings), d


def _table_stamp(table_path: str) -> Tuple[int, int]:
    st = os.stat(table_path)
    return int(st.st_size), int(st.st_mtime_ns)


def save_dict(table_path: str, col: int, d: StringDict) -> str:
    """Write the sidecar, stamped against the current table file (written
    to a temporary file, fsynced, then renamed over the sidecar)."""
    size, mtime = _table_stamp(table_path)
    path = dict_path_for(table_path, col)
    body = json.dumps({"magic": _MAGIC, "col": int(col),
                       "table_size": size, "table_mtime_ns": mtime,
                       "values": d.values})
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_dict(table_path: str, col: int, *,
              check_stale: bool = True) -> StringDict:
    """Load a column's dictionary.  FileNotFoundError when there is none;
    EIO when it is unreadable, or when the table was rewritten since it
    was saved (stale codes would decode to wrong strings)."""
    path = dict_path_for(table_path, col)
    try:
        with open(path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise
    except (OSError, json.JSONDecodeError) as e:
        raise StromError(_errno.EIO, f"string dictionary {path}: {e}") from e
    if meta.get("magic") != _MAGIC or meta.get("col") != int(col):
        raise StromError(_errno.EIO, f"string dictionary {path}: wrong "
                                     f"header")
    if check_stale:
        size, mtime = _table_stamp(table_path)
        if (meta.get("table_size"), meta.get("table_mtime_ns")) \
                != (size, mtime):
            raise StromError(_errno.EIO, f"string dictionary {path} is STALE "
                                         f"(table rewritten); rebuild it")
    d = StringDict.__new__(StringDict)
    d._set([str(v) for v in meta["values"]])
    return d
