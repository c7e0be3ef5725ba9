"""Packed columnar extents: the compressed wire format for compute pushdown.

The port's own copy of the JAX package's ``scan/colpack.py`` format: a
``<table>.cpk`` sidecar holding the same rows as a heap table, re-encoded
so each 8KB page carries ``rows_per_block`` rows instead of the heap's
``tuples_per_page``.  The encoder writes byte-identical files to the JAX
package's on the same table and codecs; it is vectorised across blocks, so
a gigabyte table encodes in seconds.

Layout — every page is PAGE_SIZE bytes, so the packed file rides the scan
pipeline unchanged:

* page 0: file header — ``CPK_FILE_MAGIC``, then a length-prefixed JSON
  blob (per-column codec and fixed region layout, the source table's
  size and mtime stamp, packed and logical byte counts).
* pages 1..n_blocks: data blocks — a 64-byte header (``CPK_MAGIC``, block
  id, n_rows, payload crc32c), then per-column regions at the word offsets
  the file header declared.  Every block shares one layout, so the decode
  kernels take the geometry once per file.

Codecs, chosen per column for the whole file:

* ``raw``      — 32-bit words verbatim (bitcast for float32).
* ``bitpack``  — frame-of-reference base (region word 0) + deltas packed
  at a width dividing 32 (1/2/4/8/16), planar: value ``j`` lives in word
  ``j % nw`` at shift ``(j // nw) * bits``.
* ``dict``     — per-block dictionary (``dsize`` slots, a power of two)
  then bit-packed indices.
* ``rle``      — run count, run values and cumulative run ends, ``rmax``
  slots; padded runs are empty intervals ``[n, n)``.

:func:`decode_pages_numpy` is the numpy decoder, the oracle of the decode
kernels (``ops/decode.py``, ``ops/decode_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .heap import (HEADER_WORDS, PAGE_SIZE, HeapSchema, crc32c_rows,
                   pages_from_bytes, read_column)

__all__ = [
    "CPK_MAGIC", "CPK_FILE_MAGIC", "DICT_MAX", "RLE_MAX",
    "ColCodec", "PackedMeta", "packed_path_for", "build_packed",
    "load_meta", "probe_packed", "decode_pages_numpy",
]

CPK_MAGIC = 0x43504B31        # 'CPK1' — data-block header word 0
CPK_FILE_MAGIC = 0x43504B46   # 'CPKF' — file-header page word 0

_WORDS = PAGE_SIZE // 4

# bounds of the per-block dictionary and run tables
DICT_MAX = 64
RLE_MAX = 64
# rows_per_block candidates, largest first: 32768 .. 32
_RPB_CANDIDATES = tuple(1 << k for k in range(15, 4, -1))


@dataclasses.dataclass(frozen=True)
class ColCodec:
    """One column's codec + fixed region geometry (identical every block)."""

    codec: str            # raw | bitpack | dict | rle
    off: int              # region word offset within the page
    nwords: int           # region length in words
    bits: int = 0         # packed value/index width (bitpack/dict)
    dsize: int = 0        # dictionary capacity (dict; power of two)
    rmax: int = 0         # max runs per block (rle)
    packed_bytes: int = 0   # region bytes summed over all blocks
    logical_bytes: int = 0  # n_rows * 4

    @property
    def ratio(self) -> float:
        """Observed codec ratio: logical bytes per packed byte."""
        return self.logical_bytes / self.packed_bytes \
            if self.packed_bytes else 1.0


@dataclasses.dataclass(frozen=True)
class PackedMeta:
    """Parsed ``.cpk`` file header: what the planner and the decode
    kernels need."""

    version: int
    rows_per_block: int
    n_blocks: int
    n_rows: int
    dtypes: Tuple[str, ...]
    cols: Tuple[ColCodec, ...]
    table_size: int        # staleness stamp of the source table
    table_mtime_ns: int
    path: str = ""

    @property
    def packed_bytes(self) -> int:
        """Wire bytes for a full scan: header page + data pages."""
        return (1 + self.n_blocks) * PAGE_SIZE

    @property
    def logical_bytes(self) -> int:
        return self.n_rows * 4 * len(self.dtypes)

    @property
    def ratio(self) -> float:
        return self.logical_bytes / self.packed_bytes \
            if self.packed_bytes else 1.0


def packed_path_for(table_path: str) -> str:
    return table_path + ".cpk"


# -- encode ---------------------------------------------------------------

def _pow2_width(span: int) -> int:
    """Smallest width in {1,2,4,8,16,32} holding *span* distinct deltas."""
    for b in (1, 2, 4, 8, 16):
        if span < (1 << b):
            return b
    return 32


def _pack_rows(vals: np.ndarray, bits: int, nw: int) -> np.ndarray:
    """Planar bit-pack of each row of (nb, n) uint32 *vals* (each value
    below 2^bits) into (nb, nw) words: value ``j`` goes to word
    ``j % nw`` at shift ``(j // nw) * bits``."""
    vpw = 32 // bits
    v = np.zeros((vals.shape[0], nw * vpw), np.uint32)
    v[:, :vals.shape[1]] = vals
    planes = v.reshape(vals.shape[0], vpw, nw) \
        << (np.arange(vpw, dtype=np.uint32) * np.uint32(bits))[None, :, None]
    return np.bitwise_or.reduce(planes, axis=1)


def _unpack_rows(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of :func:`_pack_rows`: (nb, nw) words -> (nb, n) uint32."""
    vpw = 32 // bits
    mask = np.uint32((1 << bits) - 1) if bits < 32 else np.uint32(0xFFFFFFFF)
    shifts = np.arange(vpw, dtype=np.uint32) * np.uint32(bits)
    planes = (words.astype(np.uint32)[:, None, :] >> shifts[None, :, None]) \
        & mask
    return planes.reshape(words.shape[0], -1)[:, :n]


def _blocks(u: np.ndarray, rpb: int) -> Tuple[np.ndarray, np.ndarray]:
    """(full blocks as an (nb, rpb) view, the partial last block)."""
    nb = len(u) // rpb
    return u[:nb * rpb].reshape(nb, rpb), u[nb * rpb:]


def _runs_per_block(u: np.ndarray, rpb: int) -> int:
    """Max run count over rpb-row blocks (block boundaries break runs)."""
    if len(u) == 0:
        return 0
    start = np.empty(len(u), bool)
    start[0] = True
    np.not_equal(u[1:], u[:-1], out=start[1:])
    start[::rpb] = True
    return int(np.add.reduceat(start, np.arange(0, len(u), rpb),
                               dtype=np.int64).max())


def _distinct(rows: np.ndarray) -> np.ndarray:
    """Distinct values in each row of a 2-D array."""
    if rows.shape[1] == 0:
        return np.zeros(rows.shape[0], np.int64)
    s = np.sort(rows, axis=1)
    return 1 + np.count_nonzero(s[:, 1:] != s[:, :-1], axis=1)


def _distinct_per_block(u: np.ndarray, rpb: int) -> int:
    if len(u) == 0:
        return 0
    full, tail = _blocks(u, rpb)
    d = int(_distinct(full).max()) if len(full) else 0
    return max(d, len(np.unique(tail)))


def _dict_cost(d: int, rpb: int):
    dsize = 1 << max(int(np.ceil(np.log2(d))), 0)
    bi = max(_pow2_width(dsize - 1), 1)
    return dsize + (rpb * bi + 31) // 32, bi, dsize


def _cheap_pick(u: np.ndarray, span: int, is_float: bool, rpb: int,
                allowed: Sequence[str]):
    """``(best, dict_lb)`` for one column at *rpb*: the cheapest
    ``(words, codec, bits, dsize, rmax)`` among raw, bitpack and rle, and
    a lower bound of the dict region's words (None when no block can be
    dict-coded).  The first block's distinct and run counts bound the
    per-block maxima from below, so they rule codecs out cheaply."""
    best = (rpb, "raw", 0, 0, 0)
    if len(u) == 0:
        return best, None
    if "bitpack" in allowed and not is_float:
        b = _pow2_width(span)
        if b < 32:
            best = min(best, (1 + (rpb * b + 31) // 32, "bitpack", b, 0, 0))
    head = u[:rpb]
    if "rle" in allowed and \
            1 + np.count_nonzero(head[1:] != head[:-1]) <= RLE_MAX:
        r = _runs_per_block(u, rpb)
        if 0 < r <= RLE_MAX:
            best = min(best, (1 + 2 * r, "rle", 0, 0, r))
    if "dict" not in allowed:
        return best, None
    d0 = len(np.unique(head))
    return best, (_dict_cost(d0, rpb)[0] if d0 <= DICT_MAX else None)


def _choose_layout(cols_u32: List[np.ndarray], floats: List[bool],
                   allowed: Sequence[str]):
    """Largest rows_per_block whose per-column best codecs fit one page
    (rows_per_block is the compression ratio).  The exact dict count, a
    sort of the column, is taken only where the dictionary can still win
    and the page can still fit."""
    spans = [int(u.max()) - int(u.min()) if len(u) else 0 for u in cols_u32]
    for rpb in _RPB_CANDIDATES:
        cheap = [_cheap_pick(u, sp, isf, rpb, allowed)
                 for u, sp, isf in zip(cols_u32, spans, floats)]
        if HEADER_WORDS + sum(best[0] if lb is None else min(best[0], lb)
                              for best, lb in cheap) > _WORDS:
            continue
        picks = []
        for u, (best, lb) in zip(cols_u32, cheap):
            if lb is not None and lb <= best[0]:
                d = _distinct_per_block(u, rpb)
                if 0 < d <= DICT_MAX:
                    words, bi, dsize = _dict_cost(d, rpb)
                    best = min(best, (words, "dict", bi, dsize, 0))
            picks.append(best)
        if HEADER_WORDS + sum(p[0] for p in picks) <= _WORDS:
            return rpb, picks
    raise ValueError(f"schema too wide to pack ({len(cols_u32)} columns)")


def _encode_rows(m: np.ndarray, pick, rpb: int) -> np.ndarray:
    """Regions of (nb, n) blocks of n rows each -> (nb, nwords) uint32."""
    nwords, codec, bits, dsize, rmax = pick
    nb, n = m.shape
    out = np.zeros((nb, nwords), np.uint32)
    if nb == 0 or n == 0:
        return out
    if codec == "raw":
        out[:, :n] = m
    elif codec == "bitpack":
        base = m.min(axis=1)
        out[:, 0] = base
        out[:, 1:] = _pack_rows(m - base[:, None], bits, nwords - 1)
    elif codec == "dict":
        order = np.argsort(m, axis=1, kind="stable")
        srt = np.take_along_axis(m, order, axis=1)
        new = np.ones((nb, n), bool)
        new[:, 1:] = srt[:, 1:] != srt[:, :-1]
        rank = np.cumsum(new, axis=1, dtype=np.int64) - 1
        bi, ji = np.nonzero(new)
        out[bi, rank[bi, ji]] = srt[bi, ji]
        inv = np.empty((nb, n), np.uint32)
        np.put_along_axis(inv, order, rank.astype(np.uint32), axis=1)
        out[:, dsize:] = _pack_rows(inv, bits, nwords - dsize)
    else:   # rle
        start = np.ones((nb, n), bool)
        start[:, 1:] = m[:, 1:] != m[:, :-1]
        nr = start.sum(axis=1)
        bi, ji = np.nonzero(start)
        k = (np.cumsum(start, axis=1) - 1)[bi, ji]
        ends = np.full(len(ji), n, np.int64)
        same = bi[1:] == bi[:-1]
        ends[:-1][same] = ji[1:][same]
        out[:, 0] = nr
        out[bi, 1 + k] = m[bi, ji]
        # padded runs are empty intervals [n, n)
        out[:, 1 + rmax:1 + 2 * rmax] = n
        out[bi, 1 + rmax + k] = ends
    return out


def build_packed(table_path: str, schema: HeapSchema, *,
                 out_path: Optional[str] = None,
                 codecs: Optional[Sequence[str]] = None) -> PackedMeta:
    """Encode a heap table into its ``.cpk`` packed twin (atomic rename).

    MVCC-invisible rows are dropped at encode time: the packed file holds
    exactly the rows a scan would aggregate, and the staleness stamp makes
    any later table write retire the sidecar.  ``codecs`` defaults to
    config ``pushdown_codecs``."""
    if schema.has_wide or any(schema.nullable or ()):
        raise ValueError("packed extents serve the 4-byte non-null layout")
    if codecs is not None:
        allowed = tuple(codecs)
    else:
        from ..config import config
        allowed = tuple(c.strip()
                        for c in config.get("pushdown_codecs").split(",")
                        if c.strip())
    st = os.stat(table_path)
    with open(table_path, "rb") as f:
        pages = pages_from_bytes(f.read())
    cols = [read_column(pages, schema, c) for c in range(schema.n_cols)]
    if schema.visibility:
        keep = read_column(pages, schema, schema.n_cols, np.int32) != 0 \
            if len(pages) else np.zeros(0, bool)
        cols = [c[keep] for c in cols]
    del pages
    n_rows = len(cols[0]) if cols else 0
    floats = [schema.col_dtype(c).kind == "f" for c in range(schema.n_cols)]
    cols_u32 = [np.ascontiguousarray(c).view(np.uint32) for c in cols]
    rpb, picks = _choose_layout(cols_u32, floats, allowed)
    n_blocks = (n_rows + rpb - 1) // rpb

    col_metas, off = [], HEADER_WORDS
    for nwords, codec, bits, dsize, rmax in picks:
        col_metas.append(ColCodec(
            codec=codec, off=off, nwords=int(nwords), bits=int(bits),
            dsize=int(dsize), rmax=int(rmax),
            packed_bytes=int(nwords) * 4 * n_blocks,
            logical_bytes=n_rows * 4))
        off += int(nwords)

    blocks = np.zeros((n_blocks, _WORDS), np.uint32)
    blocks[:, 0] = CPK_MAGIC
    blocks[:, 1] = np.arange(n_blocks, dtype=np.uint32)
    blocks[:, 2] = rpb
    nfull = n_rows // rpb
    if nfull < n_blocks:
        blocks[-1, 2] = n_rows - nfull * rpb
    for u, pick, cm in zip(cols_u32, picks, col_metas):
        full, tail = _blocks(u, rpb)
        region = blocks[:, cm.off:cm.off + cm.nwords]
        region[:nfull] = _encode_rows(full, pick, rpb)
        if len(tail):
            region[nfull] = _encode_rows(tail[None, :], pick, rpb)[0]
    if n_blocks:
        blocks[:, 3] = crc32c_rows(np.ascontiguousarray(
            blocks[:, HEADER_WORDS:]).view(np.uint8))

    meta = PackedMeta(
        version=1, rows_per_block=rpb, n_blocks=n_blocks, n_rows=n_rows,
        dtypes=tuple(np.dtype(schema.col_dtype(c)).name
                     for c in range(schema.n_cols)),
        cols=tuple(col_metas), table_size=st.st_size,
        table_mtime_ns=st.st_mtime_ns)
    head = np.zeros(_WORDS, np.uint32)
    head[0] = CPK_FILE_MAGIC
    blob = json.dumps(_meta_to_json(meta)).encode()
    head[1] = len(blob)
    head_bytes = bytearray(head.tobytes())
    head_bytes[8:8 + len(blob)] = blob
    if len(blob) > PAGE_SIZE - 8:
        raise ValueError("packed metadata blob exceeds the header page")

    dest = out_path or packed_path_for(table_path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest) or ".",
                               prefix=".cpk-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(bytes(head_bytes))
            if n_blocks:
                f.write(memoryview(blocks).cast("B"))
        os.replace(tmp, dest)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return dataclasses.replace(meta, path=dest)


def _meta_to_json(m: PackedMeta) -> dict:
    return {
        "version": m.version, "page_size": PAGE_SIZE,
        "rows_per_block": m.rows_per_block, "n_blocks": m.n_blocks,
        "n_rows": m.n_rows, "dtypes": list(m.dtypes),
        "cols": [dataclasses.asdict(c) for c in m.cols],
        "table_size": m.table_size, "table_mtime_ns": m.table_mtime_ns,
    }


def load_meta(path: str) -> PackedMeta:
    """Parse a ``.cpk`` file header (no freshness check)."""
    with open(path, "rb") as f:
        head = f.read(PAGE_SIZE)
    if len(head) < PAGE_SIZE:
        raise ValueError(f"{path}: short packed header page")
    w = np.frombuffer(head[:8], np.uint32)
    if int(w[0]) != CPK_FILE_MAGIC:
        raise ValueError(f"{path}: bad packed-file magic 0x{int(w[0]):08x}")
    d = json.loads(head[8:8 + int(w[1])].decode())
    return PackedMeta(
        version=int(d["version"]), rows_per_block=int(d["rows_per_block"]),
        n_blocks=int(d["n_blocks"]), n_rows=int(d["n_rows"]),
        dtypes=tuple(d["dtypes"]),
        cols=tuple(ColCodec(**c) for c in d["cols"]),
        table_size=int(d["table_size"]),
        table_mtime_ns=int(d["table_mtime_ns"]), path=path)


def probe_packed(table_path: str) -> Optional[PackedMeta]:
    """Fresh packed sidecar for *table_path*, or None: the stamp (source
    size + mtime_ns) must match the live table exactly, so any write to
    the table retires the packed representation."""
    try:
        meta = load_meta(packed_path_for(table_path))
        st = os.stat(table_path)
    except (OSError, ValueError):
        return None
    if meta.table_size != st.st_size \
            or meta.table_mtime_ns != st.st_mtime_ns:
        return None
    return meta


# -- numpy decoder (the kernels' oracle) ----------------------------------

def _decode_region(words: np.ndarray, cm: ColCodec, rpb: int) -> np.ndarray:
    """(nb, 2048) uint32 block words -> (nb, rpb) uint32 values of one
    column (rows past a block's n_rows are don't-care)."""
    r = words[:, cm.off:cm.off + cm.nwords]
    nb = r.shape[0]
    if cm.codec == "raw":
        return r[:, :rpb]
    if cm.codec == "bitpack":
        return _unpack_rows(r[:, 1:], cm.bits, rpb) + r[:, :1]
    if cm.codec == "dict":
        idx = _unpack_rows(r[:, cm.dsize:], cm.bits, rpb).astype(np.int64)
        vals = r[np.arange(nb)[:, None], np.minimum(idx, cm.dsize - 1)]
        return np.where(idx < cm.dsize, vals, np.uint32(0))
    # rle: row j belongs to the first run whose cumulative end is past j
    ends = r[:, 1 + cm.rmax:1 + 2 * cm.rmax].astype(np.int64)
    j = np.arange(rpb)
    k = np.zeros((nb, rpb), np.int64)
    for s in range(cm.rmax):
        k += ends[:, s:s + 1] <= j[None, :]
    return r[np.arange(nb)[:, None], 1 + np.minimum(k, cm.rmax - 1)]


def decode_pages_numpy(pages_u8: np.ndarray, meta: PackedMeta
                       ) -> Tuple[List[np.ndarray], int]:
    """Decode packed pages to logical columns.  Pages without the
    data-block magic (the file header, zero padding) contribute no rows.
    Returns ``([col arrays in schema dtypes], n_rows)``."""
    pages = pages_from_bytes(pages_u8)
    words = pages.view(np.uint32).reshape(len(pages), _WORDS)
    words = words[words[:, 0] == CPK_MAGIC]
    rpb = meta.rows_per_block
    n = np.minimum(words[:, 2].astype(np.int64), rpb)
    live = np.arange(rpb)[None, :] < n[:, None]
    cols = [_decode_region(words, cm, rpb)[live]
            .view(np.dtype(meta.dtypes[c]))
            for c, cm in enumerate(meta.cols)]
    return cols, int(n.sum())
