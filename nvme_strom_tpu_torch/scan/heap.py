"""Heap page format (numpy only).

The on-disk table format is shared with the JAX package byte for byte, so
one file on disk serves both: 8KB pages laid out columnar within the page,
fixed width, so a batch of pages views as typed tensors.

``page[8192] = header[64B] | col regions | visibility | validity | pad``

header words (int32): [0]=magic [1]=page_id [2]=n_tuples [3]=n_cols
[4]=visibility_mode [5]=wide-column bitmask [6]=nullable bitmask
[7]=crc32c of the page with this word zeroed [8..15]=reserved.

Column regions sit in schema order, ``T`` values each (4 or 8 bytes wide,
8-byte regions start 8-aligned).  A visibility schema appends a per-tuple
int32 mask; each nullable column appends a ``ceil(T/32)``-word validity
bitmap (bit i set = row i holds a value).

Page packing is vectorised over pages, so tables of a gigabyte and more
build in seconds; the page checksum runs slicing-by-4 crc32c across all
pages at once where no C implementation is installed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

__all__ = ["PAGE_SIZE", "HEAP_MAGIC", "HEADER_BYTES", "HEADER_WORDS",
           "CHECKSUM_WORD", "HeapSchema", "build_pages", "build_heap_file",
           "page_checksums", "crc32c_rows", "pages_from_bytes",
           "read_column"]

PAGE_SIZE = 8192                  # BLCKSZ, matching the reference
HEADER_BYTES = 64
HEADER_WORDS = HEADER_BYTES // 4
HEAP_MAGIC = 0x53545250           # 'PRTS'
CHECKSUM_WORD = 7

_DTS_4 = (np.dtype(np.int32), np.dtype(np.uint32), np.dtype(np.float32))
_DTS_8 = (np.dtype(np.int64), np.dtype(np.float64))


# -- crc32c (Castagnoli) ------------------------------------------------------

def _crc_tables() -> np.ndarray:
    t0 = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        t0[i] = c
    tabs = [t0]
    for _ in range(3):
        prev = tabs[-1]
        tabs.append((prev >> np.uint32(8)) ^ t0[prev & np.uint32(0xFF)])
    return np.stack(tabs)


def crc32c_rows(rows: np.ndarray, block: int = 8192) -> np.ndarray:
    """crc32c of every row of a (n, L) uint8 array (L a multiple of 4),
    slicing-by-4, vectorised across rows (one pass over the row's
    words)."""
    t = _crc_tables()
    t0, t1, t2, t3 = t[0], t[1], t[2], t[3]
    m = np.uint32(0xFF)
    out = np.empty(rows.shape[0], dtype=np.uint32)
    for lo in range(0, rows.shape[0], block):
        words = np.ascontiguousarray(
            rows[lo:lo + block].view("<u4").T)         # (L/4, nb)
        crc = np.full(words.shape[1], 0xFFFFFFFF, dtype=np.uint32)
        for w in words:
            crc ^= w
            crc = (t3[crc & m] ^ t2[(crc >> np.uint32(8)) & m]
                   ^ t1[(crc >> np.uint32(16)) & m]
                   ^ t0[crc >> np.uint32(24)])
        out[lo:lo + block] = crc ^ np.uint32(0xFFFFFFFF)
    return out


def page_checksums(pages: np.ndarray) -> np.ndarray:
    """crc32c of each page of a (n, PAGE_SIZE) uint8 array, as uint32."""
    try:
        from google_crc32c import value
    except ImportError:
        return crc32c_rows(pages)
    return np.fromiter((value(p.tobytes()) for p in pages),
                       dtype=np.uint32, count=pages.shape[0])


# -- schema and layout --------------------------------------------------------

@lru_cache(maxsize=256)
def _layout(schema: "HeapSchema"):
    """(tuples_per_page, col word offsets, visibility offset|None,
    validity word offsets {col: off}) — the one layout derivation the
    page packer and the device decode share."""
    widths = [schema.col_dtype(c).itemsize for c in range(schema.n_cols)]
    nullable = schema.nullable or (False,) * schema.n_cols
    fixed_words = sum(w // 4 for w in widths) \
        + (1 if schema.visibility else 0)

    def fits(t: int) -> Optional[tuple]:
        off = HEADER_WORDS
        col_off = []
        for w in widths:
            if w == 8 and off % 2:
                off += 1          # 8-byte regions start 8-aligned
            col_off.append(off)
            off += (w // 4) * t
        vis_off = None
        if schema.visibility:
            vis_off = off
            off += t
        nb = (t + 31) // 32
        valid_off = {}
        for c in range(schema.n_cols):
            if nullable[c]:
                valid_off[c] = off
                off += nb
        if off > PAGE_SIZE // 4:
            return None
        return t, tuple(col_off), vis_off, dict(valid_off)

    t = (PAGE_SIZE - HEADER_BYTES) * 8 // \
        (fixed_words * 32 + sum(nullable))
    while t > 0:
        got = fits(t)
        if got is not None:
            return got
        t -= 1
    raise ValueError("schema too wide for one page")


@dataclass(frozen=True)
class HeapSchema:
    """Fixed-width column schema.

    ``dtypes`` — optional per-column dtype strings (default: all int32):
    int32/uint32/float32/int64/float64.  ``nullable`` — optional
    per-column bools; nullable columns carry a validity bitmap per page."""

    n_cols: int
    visibility: bool = False
    dtypes: Optional[tuple] = None
    nullable: Optional[tuple] = None

    def __post_init__(self):
        if self.dtypes is not None:
            if len(self.dtypes) != self.n_cols:
                raise ValueError(f"{len(self.dtypes)} dtypes for "
                                 f"{self.n_cols} columns")
            for d in self.dtypes:
                if np.dtype(d) not in _DTS_4 + _DTS_8:
                    raise ValueError(f"column dtype {d} not supported "
                                     f"(int32/uint32/float32/int64/"
                                     f"float64)")
            object.__setattr__(self, "dtypes", tuple(self.dtypes))
        if self.nullable is not None:
            if len(self.nullable) != self.n_cols:
                raise ValueError(f"{len(self.nullable)} nullable flags "
                                 f"for {self.n_cols} columns")
            object.__setattr__(self, "nullable",
                               tuple(bool(b) for b in self.nullable))
        if (self.has_wide or any(self.nullable or ())) \
                and self.n_cols > 31:
            raise ValueError("wide/nullable schemas support up to 31 "
                             "columns (header bitmask width)")

    @classmethod
    def from_fields(cls, d: dict) -> "HeapSchema":
        """Schema from ``dataclasses.asdict`` of the JAX package's
        ``HeapSchema`` (same four fields, same meaning)."""
        return cls(n_cols=int(d["n_cols"]),
                   visibility=bool(d.get("visibility", False)),
                   dtypes=(None if d.get("dtypes") is None
                           else tuple(d["dtypes"])),
                   nullable=(None if d.get("nullable") is None
                             else tuple(d["nullable"])))

    def col_dtype(self, c: int) -> np.dtype:
        return np.dtype(self.dtypes[c]) if self.dtypes else np.dtype(np.int32)

    def col_nullable(self, c: int) -> bool:
        return bool(self.nullable[c]) if self.nullable else False

    @property
    def has_wide(self) -> bool:
        return self.dtypes is not None and \
            any(np.dtype(d).itemsize == 8 for d in self.dtypes)

    @property
    def tuples_per_page(self) -> int:
        return _layout(self)[0]

    def col_word_range(self, c: int):
        """(start, stop) word offsets of column *c* within a page
        (``c == n_cols`` addresses the visibility column)."""
        t, col_off, vis_off, _valid = _layout(self)
        if c == self.n_cols:
            if vis_off is None:
                raise ValueError("schema has no visibility column")
            return vis_off, vis_off + t
        w = self.col_dtype(c).itemsize // 4
        return col_off[c], col_off[c] + w * t

    def validity_word_range(self, c: int):
        """(start, stop) word offsets of column *c*'s validity bitmap."""
        t, _col_off, _vis, valid = _layout(self)
        if c not in valid:
            raise ValueError(f"column {c} is not nullable")
        nb = (t + 31) // 32
        return valid[c], valid[c] + nb

    def _bitmask(self, pred) -> int:
        return sum(1 << c for c in range(self.n_cols) if pred(c))

    @property
    def wide_mask(self) -> int:
        return self._bitmask(lambda c: self.col_dtype(c).itemsize == 8)

    @property
    def null_mask(self) -> int:
        return self._bitmask(self.col_nullable)


# -- page packing -------------------------------------------------------------

def _paged(vals: np.ndarray, n_pages: int, t: int) -> np.ndarray:
    """(n,) values -> (n_pages, t) zero-padded rows."""
    out = np.zeros(n_pages * t, dtype=vals.dtype)
    out[:len(vals)] = vals
    return out.reshape(n_pages, t)


def build_pages(columns: Sequence[np.ndarray], schema: HeapSchema, *,
                visibility: Optional[np.ndarray] = None,
                nulls: Optional[dict] = None,
                start_page_id: int = 0,
                checksum: bool = True) -> np.ndarray:
    """Pack column arrays (each shape (n_rows,), schema dtypes) into pages.
    ``nulls`` — optional ``{col: (n_rows,) bool}`` NULL masks for nullable
    columns (True = NULL; stored word zeroed, validity bit cleared).
    ``checksum=False`` leaves the checksum word 0 (pages that are scanned
    at once and never stored).  Returns a uint8 array of shape
    (n_pages, PAGE_SIZE)."""
    if len(columns) != schema.n_cols:
        raise ValueError(f"expected {schema.n_cols} columns, "
                         f"got {len(columns)}")
    nulls = dict(nulls or {})
    for c in nulls:
        if not schema.col_nullable(c):
            raise ValueError(f"column {c} is not nullable in the schema")
    n_rows = len(columns[0])
    for ci, c in enumerate(columns):
        if len(c) != n_rows:
            raise ValueError("ragged columns")
        if schema.dtypes is not None and c.dtype != schema.col_dtype(ci):
            raise ValueError(f"column {ci} dtype {c.dtype} != schema "
                             f"{schema.col_dtype(ci)}")
        if schema.dtypes is None and c.dtype.itemsize != 4:
            raise ValueError("columns must be 4-byte dtypes")
    if schema.visibility:
        if visibility is None:
            visibility = np.ones(n_rows, dtype=np.int32)
        if len(visibility) != n_rows:
            raise ValueError("visibility length mismatch")
    t, col_off, vis_off, valid_off = _layout(schema)
    n_pages = max((n_rows + t - 1) // t, 1)
    pages = np.zeros((n_pages, PAGE_SIZE // 4), dtype=np.int32)
    pages[:, 0] = HEAP_MAGIC
    pages[:, 1] = np.arange(start_page_id, start_page_id + n_pages)
    pages[:, 2] = t
    pages[-1, 2] = n_rows - (n_pages - 1) * t
    pages[:, 3] = schema.n_cols
    pages[:, 4] = 1 if schema.visibility else 0
    pages[:, 5] = schema.wide_mask
    pages[:, 6] = schema.null_mask
    for ci in range(schema.n_cols):
        vals = np.asarray(columns[ci])
        if ci in nulls:
            vals = np.where(nulls[ci], vals.dtype.type(0), vals)
        w = schema.col_dtype(ci).itemsize // 4
        s = col_off[ci]
        pages[:, s:s + t * w] = _paged(vals, n_pages, t).view(np.int32)
    if schema.visibility:
        pages[:, vis_off:vis_off + t] = _paged(
            np.asarray(visibility).astype(np.int32), n_pages, t)
    nb = (t + 31) // 32
    for ci, s in valid_off.items():
        present = np.ones(n_rows, dtype=bool)
        if ci in nulls:
            present = ~np.asarray(nulls[ci], dtype=bool)
        bits = np.zeros((n_pages, nb * 32), dtype=bool)
        bits[:, :t] = _paged(present, n_pages, t)
        packed = np.packbits(bits, axis=1, bitorder="little")
        pages[:, s:s + nb] = packed.view("<u4").astype(np.uint32) \
            .view(np.int32)
    out = pages.view(np.uint8).reshape(n_pages, PAGE_SIZE)
    if checksum:
        # checksum word is still zero here: the crc covers the page with
        # it zeroed, exactly what a verifier recomputes
        pages.view(np.uint32)[:, CHECKSUM_WORD] = page_checksums(out)
    return out


def build_heap_file(path: str, columns: Sequence[np.ndarray],
                    schema: HeapSchema, *,
                    visibility: Optional[np.ndarray] = None,
                    nulls: Optional[dict] = None) -> int:
    """Write a heap file; returns number of pages."""
    pages = build_pages(columns, schema, visibility=visibility, nulls=nulls)
    with open(path, "wb") as f:
        f.write(memoryview(pages).cast("B"))
    return len(pages)



def pages_from_bytes(raw) -> np.ndarray:
    """View raw bytes as (n_pages, PAGE_SIZE) uint8 without copying."""
    arr = np.frombuffer(raw, dtype=np.uint8) \
        if not isinstance(raw, np.ndarray) else raw
    if arr.size % PAGE_SIZE:
        raise ValueError(f"byte length {arr.size} not page-aligned")
    return arr.reshape(-1, PAGE_SIZE)


def read_column(pages: np.ndarray, schema: HeapSchema, c: int,
                dtype=None) -> np.ndarray:
    """Host-side column extraction: column *c*'s live values (the first
    n_tuples of each page), in page order."""
    dtype = np.dtype(dtype if dtype is not None else schema.col_dtype(c))
    words = pages.view(np.int32).reshape(pages.shape[0], PAGE_SIZE // 4)
    t = schema.tuples_per_page
    s, _e = schema.col_word_range(c)
    w = dtype.itemsize // 4
    region = np.ascontiguousarray(words[:, s:s + t * w]).view(dtype)
    n = np.clip(words[:, 2], 0, t)
    return region[np.arange(t)[None, :] < n[:, None]]
