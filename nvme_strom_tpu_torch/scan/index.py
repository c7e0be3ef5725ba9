"""Sorted secondary index: the index access method over heap tables.

A port of the JAX package's ``scan/index.py``.  A sorted ``(key,
position)`` sidecar is built by one scan; after it, equality and range
lookups touch only the pages holding matching rows (binary search on the
sidecar, then :meth:`.query.Query.fetch`'s page reads).  The sidecar is
two dense arrays, so every probe is a ``searchsorted`` — the sorted-probe
discipline of the broadcast join (:mod:`..ops.join`) — rather than a
pointer-chasing B-tree.

Sidecar layout (``<table>.idx<c>`` by convention), byte for byte the JAX
package's, so each package opens the other's files::

    [ magic u64 | json_len u64 | header json, padded to 4096 ]
    [ sorted keys array ][ positions array (int64) ]

Header json: ``{version, col, dtype, count, table_size,
table_mtime_ns}``; the table's size and mtime, taken before the build's
scan, let :func:`open_index` detect a stale index after the table changed.

**Composite keys**: ``col`` may be a pair ``(c0, c1)`` of 4-byte integer
columns.  The sidecar then stores one ``uint64`` key a row, the two
values packed so that the packed keys order like the ``(c0, c1)`` tuples
(each mapped to uint32 by an order-preserving bias, ``c0`` in the high
word): equality on the pair is one searchsorted probe, and the rows of
one ``c0`` value are one contiguous span sorted by ``c1``.  Float columns
are refused (build one index per float column).  The header gains
``key_dtypes``, the pair's column dtypes.

**Mesh build**: ``build_index(..., mesh=)`` sorts through the distributed
sample sort over the mesh's members (:mod:`..parallel.sort`) — a single
column through the mesh ``order_by``, a pair's packed keys through two
stable uint32 radix passes — and writes the same sidecar, byte for byte,
as the local build.
"""

from __future__ import annotations

import errno as _errno
import json
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..api import StromError

__all__ = ["build_index", "open_index", "probe_index", "SortedIndex",
           "pack_pair", "unpack_first", "unpack_second", "index_path_for",
           "exact_int"]

_MAGIC = 0x53545258_49445831  # "STRX" "IDX1"
_VERSION = 1
_ALIGN = 4096


def _table_stamp(path: str) -> Tuple[int, int]:
    st = os.stat(path)
    return int(st.st_size), int(st.st_mtime_ns)


def exact_int(v, dt: np.dtype):
    """*v* as an exact ``dt`` scalar, or None when no such value exists
    (NaN/inf, fractional, or outside the dtype's range): the one
    representability check of every composite-key probe."""
    f = float(v)
    info = np.iinfo(dt)
    if not np.isfinite(f) or f != int(f) \
            or not info.min <= int(v) <= info.max:
        return None
    return dt.type(int(v))


def _to_u32_order(a: np.ndarray, dt: np.dtype) -> np.ndarray:
    """Order-preserving map of a 4-byte integer column onto uint64 in
    [0, 2^32): int32 biases by +2^31, uint32 passes through."""
    if dt == np.dtype(np.int32):
        return (a.astype(np.int64) + (1 << 31)).astype(np.uint64)
    return a.astype(np.uint64)


def pack_pair(a0, a1, dt0: np.dtype, dt1: np.dtype) -> np.ndarray:
    """Lexicographic uint64 packing of an integer column pair: compares
    like ``(a0, a1)`` tuple order.  Arrays or scalars."""
    u0 = _to_u32_order(np.asarray(a0), np.dtype(dt0))
    u1 = _to_u32_order(np.asarray(a1), np.dtype(dt1))
    return (u0 << np.uint64(32)) | u1


def _from_u32_order(word: np.ndarray, dt: np.dtype) -> np.ndarray:
    if np.dtype(dt) == np.dtype(np.int32):
        return (word.astype(np.int64) - (1 << 31)).astype(np.int32)
    return word.astype(np.uint32)


def unpack_first(keys: np.ndarray, dt0: np.dtype) -> np.ndarray:
    """First-column values back out of packed keys (the high word)."""
    return _from_u32_order(keys >> np.uint64(32), dt0)


def unpack_second(keys: np.ndarray, dt1: np.dtype) -> np.ndarray:
    """Second-column values back out of packed composite keys (inverse
    of the low word of :func:`pack_pair`)."""
    return _from_u32_order(keys & np.uint64(0xFFFFFFFF), dt1)


def index_path_for(table_path: str, col) -> str:
    """Default sidecar path: ``.idx{c}`` single, ``.idx{c0}_{c1}``
    composite."""
    if isinstance(col, (tuple, list)):
        return f"{table_path}.idx{int(col[0])}_{int(col[1])}"
    return f"{table_path}.idx{int(col)}"


def build_index(table_path: str, schema, col, *,
                index_path: Optional[str] = None, device=None,
                mesh=None) -> str:
    """One scan of the table -> a sorted (key, position) sidecar.

    Returns the index path (``<table>.idx<col>`` by default).  A single
    column builds from the port's own ``Query.order_by`` (ascending key,
    physical order within equal keys) on *device* (default ``cuda:0``,
    ``"cpu"`` on the host); NaN float keys are left out (they compare
    unordered; SQL indexes skip NULLs the same way).  A pair ``(c0, c1)``
    of integer columns builds from one projection scan and a stable
    argsort of the packed keys (module docstring).  With *mesh* the sorts
    run over its members (the gather on its first), the sidecar
    byte-identical.  The file goes through ``.tmp`` + ``fsync`` +
    ``os.replace``.

    Over a mesh of several ranks every rank calls this: each gathers its
    own members' rows (the composite's projection is the mesh ``select``),
    the sorts run over every member, and only the owner of member 0 writes
    the file; the ranks then meet, so every rank returns the same path
    once the sidecar is in place (a failed write fails every rank).

    Refused with EINVAL: a nullable or 8-byte key column, a float column
    in a composite key, and a composite key that is not a pair."""
    from .query import Query

    for c in (col if isinstance(col, (tuple, list)) else [col]):
        if 0 <= int(c) < schema.n_cols:
            if schema.col_nullable(int(c)):
                raise StromError(_errno.EINVAL,
                                 f"build_index: c{c} is nullable — "
                                 f"sidecars hold no NULL entries and "
                                 f"the scan paths could disagree")
            if schema.col_dtype(int(c)).itemsize != 4:
                raise StromError(_errno.EINVAL,
                                 f"build_index: c{c} is 8-byte — "
                                 f"sidecar keys are 4-byte words")
    # stamp BEFORE the scan: a table modified mid-build then mismatches
    # the stamp and open_index fails stale
    size, mtime = _table_stamp(table_path)
    key_dtypes = None
    if isinstance(col, (tuple, list)):
        if len(col) != 2:
            raise StromError(_errno.EINVAL,
                             "composite index keys are column PAIRS")
        c0, c1 = int(col[0]), int(col[1])
        dt0, dt1 = schema.col_dtype(c0), schema.col_dtype(c1)
        for c, dt in ((c0, dt0), (c1, dt1)):
            if dt.kind not in "iu":
                raise StromError(
                    _errno.EINVAL,
                    f"composite index col{c} is {dt}: only integer "
                    f"columns pack order-preservingly (build a single-"
                    f"column index for float keys)")
        # one process gathers on the mesh's first member, the sort not;
        # over ranks each gathers its own members' rows
        ranks = mesh is not None and mesh.multi_process
        out = Query(table_path, schema).select([c0, c1]).run(
            mesh=mesh if ranks else None,
            device=mesh.devices[0] if mesh is not None and device is None
            else device)
        packed = pack_pair(out[f"col{c0}"], out[f"col{c1}"], dt0, dt1)
        pos_in = np.asarray(out["positions"], np.int64)
        if mesh is not None:
            from ..parallel.sort import distributed_sort_u64
            keys, poss = distributed_sort_u64(mesh, packed, pos_in)
        else:
            # stable: duplicates keep build (physical) order, the
            # contract of the single-column build
            from ..hbm.backend import resolve_device
            from .query import stable_order
            order = stable_order(packed, resolve_device(device))
            keys, poss = packed[order], pos_in[order]
        col_field = [c0, c1]
        key_dtypes = [dt0.str, dt1.str]
    else:
        out = Query(table_path, schema).order_by(col).run(device=device,
                                                           mesh=mesh)
        keys = np.asarray(out["values"])
        poss = np.asarray(out["positions"], np.int64)
        if keys.dtype.kind == "f":
            finite = ~np.isnan(keys)
            keys, poss = keys[finite], poss[finite]
        col_field = int(col)
    header = json.dumps({
        "version": _VERSION, "col": col_field, "dtype": keys.dtype.str,
        "count": int(len(keys)),
        "table_size": size,
        "table_mtime_ns": mtime,
        **({"key_dtypes": key_dtypes} if key_dtypes else {}),
    }).encode()
    hlen = (16 + len(header) + _ALIGN - 1) // _ALIGN * _ALIGN
    path = index_path or index_path_for(table_path, col)
    if mesh is not None and mesh.multi_process:
        from ..parallel import dist
        err = None
        if dist.process_index() == mesh.owners[0]:
            try:
                _write_sidecar(path, header, hlen, keys, poss)
            except Exception as e:      # every rank learns of it
                err = f"{type(e).__name__}: {e}"
        failed = [e for e in dist.all_gather_object(err) if e is not None]
        if failed:
            raise StromError(_errno.EIO, f"build_index: the sidecar write "
                                         f"failed: {failed[0]}")
        return path
    _write_sidecar(path, header, hlen, keys, poss)
    return path


def _write_sidecar(path: str, header: bytes, hlen: int, keys: np.ndarray,
                   poss: np.ndarray) -> None:
    """The sidecar through ``.tmp`` + ``fsync`` + ``os.replace``."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<QQ", _MAGIC, len(header)))
            f.write(header)
            f.write(b"\0" * (hlen - 16 - len(header)))
            f.write(np.ascontiguousarray(keys).tobytes())
            f.write(np.ascontiguousarray(poss).tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclass
class SortedIndex:
    """An opened sidecar: dense sorted keys + row positions."""

    path: str
    col: object             # int, or (c0, c1) tuple for composite keys
    keys: np.ndarray        # sorted, ascending
    positions: np.ndarray   # int64 global row positions, aligned to keys
    key_dtypes: Optional[Tuple[np.dtype, np.dtype]] = None  # composite only

    @property
    def composite(self) -> bool:
        return self.key_dtypes is not None

    def _pack_probes(self, values) -> np.ndarray:
        """(v0, v1) probe pairs -> packed uint64 keys; pairs with a value
        the column dtype cannot represent exactly match nothing."""
        dt0, dt1 = self.key_dtypes
        out = []
        for pair in values:
            n0 = exact_int(pair[0], dt0)
            n1 = exact_int(pair[1], dt1)
            if n0 is not None and n1 is not None:
                out.append(int(pack_pair(n0, n1, dt0, dt1)))
        return np.asarray(out, np.uint64)

    def _prefix_bracket(self, lo0, hi0) -> Tuple[int, int]:
        """[a, b) sidecar bracket of first-key-column range [lo0, hi0]
        (either bound open; a bound c0 cannot represent exactly empties
        the bracket): the one implementation behind every leftmost-prefix
        read."""
        dt0, dt1 = self.key_dtypes
        i1 = np.iinfo(dt1)
        a = 0
        b = len(self.keys)
        if lo0 is not None:
            n0 = exact_int(lo0, dt0)
            if n0 is None:
                return 0, 0
            lo = pack_pair(n0, dt1.type(i1.min), dt0, dt1)
            a = int(np.searchsorted(self.keys, lo, side="left"))
        if hi0 is not None:
            n0 = exact_int(hi0, dt0)
            if n0 is None:
                return 0, 0
            hi = pack_pair(n0, dt1.type(i1.max), dt0, dt1)
            b = int(np.searchsorted(self.keys, hi, side="right"))
        return a, max(a, b)

    def prefix_span(self, v0) -> Tuple[int, int]:
        """Composite index only: the [a, b) sidecar span whose first key
        column equals *v0* (empty when unrepresentable); within it the
        keys are sorted by the second column, which makes ``WHERE c0 = v
        ORDER BY c1`` one contiguous read."""
        return self._prefix_bracket(v0, v0)

    def prefix_range(self, lo0=None, hi0=None) -> np.ndarray:
        """Composite index only: positions of the rows whose first key
        column lies in ``[lo0, hi0]`` (either bound open) — SQL's
        leftmost-prefix rule."""
        a, b = self._prefix_bracket(lo0, hi0)
        return self.positions[a:b]

    def lookup(self, values) -> np.ndarray:
        """Row positions of rows whose key equals any of *values* (every
        duplicate matches; ascending key, then index order within equal
        keys).  A probe the key dtype cannot represent exactly (7.5
        against int32 keys) matches nothing.  Composite index: *values*
        is a sequence of ``(v0, v1)`` pairs."""
        if self.composite:
            vals = self._pack_probes(values)
        else:
            raw = np.asarray(values).reshape(-1)
            vals = raw.astype(self.keys.dtype)
            exact = vals.astype(raw.dtype) == raw \
                if raw.dtype != vals.dtype else np.ones(len(raw), bool)
            vals = vals[exact]
        parts = []
        for v in vals:
            lo = int(np.searchsorted(self.keys, v, side="left"))
            hi = int(np.searchsorted(self.keys, v, side="right"))
            if hi > lo:
                parts.append(self.positions[lo:hi])
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def range(self, lo=None, hi=None, *,
              inclusive: str = "both") -> np.ndarray:
        """Row positions with key in the given range (``inclusive`` one
        of both|left|right|neither), in ascending key order."""
        if inclusive not in ("both", "left", "right", "neither"):
            raise StromError(_errno.EINVAL,
                             f"inclusive={inclusive!r} invalid")
        i0 = 0 if lo is None else int(np.searchsorted(
            self.keys, lo, side="left" if inclusive in ("both", "left")
            else "right"))
        i1 = len(self.keys) if hi is None else int(np.searchsorted(
            self.keys, hi, side="right" if inclusive in ("both", "right")
            else "left"))
        return self.positions[i0:max(i0, i1)]

    def fetch(self, query, values=None, *, lo=None, hi=None,
              cols=None, device=None, session=None,
              inclusive: str = "both") -> dict:
        """Index scan: positions of equality *values* or a [lo, hi]
        range, then only their pages read by ``query.fetch``.  Adds
        ``"positions"`` to the fetch result."""
        pos = self.lookup(values) if values is not None \
            else self.range(lo, hi, inclusive=inclusive)
        out = query.fetch(pos, cols=cols, device=device, session=session)
        out["positions"] = pos
        return out


def _read_header(f, path: str) -> Tuple[dict, int]:
    """(header json, aligned header length); raises on any malformation."""
    magic, jlen = struct.unpack("<QQ", f.read(16))
    if magic != _MAGIC:
        raise StromError(_errno.EINVAL, f"{path}: not a strom index")
    meta = json.loads(f.read(jlen))
    if meta.get("version") != _VERSION:
        raise StromError(_errno.EINVAL,
                         f"{path}: index version {meta.get('version')}")
    return meta, (16 + jlen + _ALIGN - 1) // _ALIGN * _ALIGN


def probe_index(index_path: str, table_path: str, *,
                expect_col=None, allow_prefix: bool = True) -> bool:
    """Header-only freshness check for the planner (one small read, no
    key/position load).  False for a missing, stale, corrupt or
    unreadable sidecar: the planner never fails a query over an optional
    accelerator.

    *expect_col* also checks the header's column field (the filename is
    not authoritative): an int accepts a single-column sidecar on that
    column or — with ``allow_prefix`` (filters; not the terminals that
    read the keys as values) — a composite whose leading column matches;
    a tuple demands that exact pair."""
    try:
        with open(index_path, "rb") as f:
            meta, _ = _read_header(f, index_path)
        size, mtime = _table_stamp(table_path)
        if size != meta["table_size"] or mtime != meta["table_mtime_ns"]:
            return False
        if expect_col is not None:
            mcol = meta["col"]
            if isinstance(expect_col, (tuple, list)):
                return (isinstance(mcol, list)
                        and tuple(mcol) == tuple(expect_col))
            if isinstance(mcol, list):
                return allow_prefix and mcol[0] == int(expect_col)
            return mcol == int(expect_col)
        return True
    except Exception:
        return False


def open_index(index_path: str, *, table_path: Optional[str] = None,
               check_stale: bool = True) -> SortedIndex:
    """Open a sidecar with one buffered read of the whole file (outside
    the engine and its byte counters).  With *table_path* and
    ``check_stale``, a size/mtime mismatch against the stamped table
    raises ESTALE — rebuild with :func:`build_index`."""
    with open(index_path, "rb") as f:
        meta, hlen = _read_header(f, index_path)
        if check_stale and table_path is not None:
            size, mtime = _table_stamp(table_path)
            if (size != meta["table_size"]
                    or mtime != meta["table_mtime_ns"]):
                raise StromError(_errno.ESTALE,
                                 f"{index_path} is stale: table changed "
                                 f"since the index was built")
        f.seek(hlen)
        n = meta["count"]
        kdt = np.dtype(meta["dtype"])
        keys = np.frombuffer(f.read(n * kdt.itemsize), kdt)
        poss = np.frombuffer(f.read(n * 8), np.int64)
    if len(keys) != n or len(poss) != n:
        raise StromError(_errno.EIO, f"{index_path}: truncated index")
    col = meta["col"]
    kdts = meta.get("key_dtypes")
    return SortedIndex(path=index_path,
                       col=tuple(col) if isinstance(col, list) else col,
                       keys=keys, positions=poss,
                       key_dtypes=(np.dtype(kdts[0]), np.dtype(kdts[1]))
                       if kdts else None)
