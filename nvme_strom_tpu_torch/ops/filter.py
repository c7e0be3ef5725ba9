"""Plain PyTorch scan/filter over device-resident heap pages.

The general path of the page-batch filter, and the plain version the CUDA
kernel (:mod:`.filter_cuda`) is held against.  A batch of 8KB pages views
as int32 words; columns are word ranges reinterpreted in their dtype,
invalid and invisible tuples are masks, never branches, and the result is
a masked count plus per-column masked sums.

Types: int32 sums wrap mod 2^32 (int32 accumulation, as on the TPU);
uint32 columns decode to int64 holding the unsigned value (torch has no
uint32 arithmetic) and their sums come back as ``torch.uint32`` wrapped mod
2^32; float32 sums accumulate in float32; int64/float64 columns decode from
word pairs and sum in their own dtype.

A predicate is either a :class:`FilterPred` (a conjunction of column
comparisons, the form the CUDA kernel takes) or a callable
``predicate(cols, threshold) -> bool (B, T)`` built from torch ops.

A term compares as ``jnp`` would compare the column with the same value
(jnp type promotion, 32-bit mode): a float value against an int32 or
uint32 column compares in float32, both sides converted; a Python int
outside the int32 range is refused (EINVAL) wherever jnp raises
OverflowError, against a uint32 column too, and a negative one wraps
against a uint32 column; numpy integer scalars are not weak types, so
they wrap to 32 bits and a signed one turns a uint32 column's compare
signed (``np.uint32(3_000_000_000)`` is how a uint32 column meets a value
above 2^31).  A float16 value is refused: jnp would compare in float16.
"""

from __future__ import annotations

import errno as _errno
from dataclasses import dataclass
from typing import Callable, Union

import numpy as np
import torch

from ..api import StromError
from ..scan.heap import PAGE_SIZE, HeapSchema

__all__ = ["DEFAULT_SCHEMA", "FilterPred", "Cols", "page_words",
           "decode_pages", "make_filter_fn", "scan_filter_step",
           "term_value", "compare_view"]

#: default demo schema: two int32 data columns + visibility
DEFAULT_SCHEMA = HeapSchema(n_cols=2, visibility=True)

OPS = ("gt", "ge", "lt", "le", "eq", "ne")
_CMP = {"gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
        "eq": torch.eq, "ne": torch.ne}
MAX_TERMS = 8


_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def _wrap32(v: int, signed: bool):
    u = int(v) & 0xFFFFFFFF
    return np.uint32(u).view(np.int32) if signed else np.uint32(u)


def term_value(dt: np.dtype, value):
    """``(kind, value)`` of one comparison against a column of dtype *dt*:
    ``kind`` is "i" (int32 compare), "u" (uint32) or "f" (float32, the
    column converted to float32), and ``value`` the comparison value as a
    numpy scalar of that type — the promotion ``jnp`` applies.  An 8-byte
    column gives "w": the value cast to the column's dtype."""
    if isinstance(value, np.ndarray) and value.ndim == 0:
        value = value[()]
    if dt.itemsize == 8:
        # wide columns (plain version only) compare in their own dtype
        return "w", np.asarray(value).astype(dt)[()]
    if isinstance(value, (bool, np.bool_)):
        value = int(value)
    if isinstance(value, np.floating):
        if value.dtype.itemsize < 4:
            raise StromError(_errno.EINVAL, f"comparison value of dtype "
                                            f"{value.dtype}: jnp would compare "
                                            f"in it; use float32")
        return "f", np.float32(value)
    if isinstance(value, float):
        return "f", np.float32(value)
    if isinstance(value, int):
        # a weak type: jnp converts it to the column's type through int32
        # and refuses what int32 cannot hold, whatever the column's type
        if not _INT32_MIN <= value <= _INT32_MAX:
            raise StromError(_errno.EINVAL, f"comparison value {value} "
                                            f"outside the range a {dt} "
                                            f"compare takes (jnp raises "
                                            f"OverflowError)")
        if dt.kind == "f":
            return "f", np.float32(value)
        if dt == np.dtype(np.uint32):
            return "u", _wrap32(value, False)
        return "i", np.int32(value)
    if isinstance(value, np.integer):
        # not weak: canonicalised to 32 bits (wrapping), then promoted
        # with the column (u32 with a signed type promotes to int32)
        signed = value.dtype.kind == "i"
        if dt.kind == "f":
            return "f", np.float32(_wrap32(value, signed))
        if dt == np.dtype(np.uint32) and not signed:
            return "u", _wrap32(value, False)
        return "i", _wrap32(value, True)
    raise StromError(_errno.EINVAL, f"comparison value {value!r}: a Python "
                                    f"or numpy int or float")


def compare_view(col: torch.Tensor, kind: str) -> torch.Tensor:
    """A decoded column (int32, uint32 as int64, float32) in the type a
    term of *kind* compares in."""
    if kind == "f":
        return col.to(torch.float32)
    if kind == "i" and col.dtype == torch.int64:
        return col.to(torch.int32)          # uint32 bits, read signed
    return col


def _scalar(value, kind: str, device) -> torch.Tensor:
    if kind == "w":
        return torch.from_numpy(np.asarray(value)).to(device)
    if kind == "f":
        return torch.tensor(float(value), dtype=torch.float32, device=device)
    return torch.tensor(int(value), dtype=torch.int64 if kind == "u"
                        else torch.int32, device=device)


@dataclass(frozen=True)
class FilterPred:
    """Conjunction of at most 8 terms ``(col, op, value)``: ``op`` one of
    gt/ge/lt/le/eq/ne, ``value`` a Python or numpy int or float compared
    with jnp's promotion (:func:`term_value`), or None for the run-time
    ``threshold``.  No terms selects every valid row."""

    terms: tuple = ()

    def __post_init__(self):
        terms = tuple(tuple(t) for t in self.terms)
        if len(terms) > MAX_TERMS:
            raise StromError(_errno.EINVAL, f"{len(terms)} predicate terms; "
                                            f"at most {MAX_TERMS}")
        for col, op, _value in terms:
            if op not in OPS:
                raise StromError(_errno.EINVAL, f"predicate op {op!r} not "
                                                f"one of {OPS}")
            if not isinstance(col, (int, np.integer)) or col < 0:
                raise StromError(_errno.EINVAL, f"bad predicate column "
                                                f"{col!r}")
        object.__setattr__(self, "terms", terms)

    def values(self, dtypes, threshold) -> list:
        """Each term's ``(kind, value)`` (:func:`term_value`) against its
        column; *dtypes* is a :class:`HeapSchema` or a sequence of column
        dtypes."""
        if isinstance(dtypes, HeapSchema):
            dtypes = [dtypes.col_dtype(c) for c in range(dtypes.n_cols)]
        out = []
        for col, _op, value in self.terms:
            if col >= len(dtypes):
                raise StromError(_errno.EINVAL, f"predicate column {col} "
                                                f"outside the schema")
            out.append(term_value(np.dtype(dtypes[col]),
                                  threshold if value is None else value))
        return out

    def mask(self, cols, valid: torch.Tensor, dtypes,
             threshold) -> torch.Tensor:
        sel = valid
        for (col, op, _), (kind, v) in zip(self.terms,
                                           self.values(dtypes, threshold)):
            sel = sel & _CMP[op](compare_view(cols[col], kind),
                                 _scalar(v, kind, valid.device))
        return sel


class Cols(list):
    """Decoded column list; ``cols.nulls`` maps each nullable column to its
    (B, T) NULL mask (True = NULL)."""

    def __init__(self, items, nulls=None):
        super().__init__(items)
        self.nulls = dict(nulls or {})


def page_words(pages_u8: torch.Tensor) -> torch.Tensor:
    """(B, 8192) uint8 pages -> (B, 2048) int32 words, without a copy."""
    if (pages_u8.dtype != torch.uint8 or pages_u8.dim() != 2
            or pages_u8.shape[1] != PAGE_SIZE):
        raise StromError(_errno.EINVAL, f"pages must be (B, {PAGE_SIZE}) "
                                        f"uint8, got {tuple(pages_u8.shape)} "
                                        f"{pages_u8.dtype}")
    return pages_u8.contiguous().view(torch.int32)


_WIDE = {np.dtype(np.int64): torch.int64, np.dtype(np.float64): torch.float64}


def decode_pages(pages_u8: torch.Tensor,
                 schema: HeapSchema = DEFAULT_SCHEMA):
    """(B, 8192) uint8 pages -> (columns, valid mask): views and masks, no
    data movement beyond the 8-byte and uint32 widenings."""
    words = page_words(pages_u8)
    b = words.shape[0]
    t = schema.tuples_per_page
    idx = torch.arange(t, dtype=torch.int32, device=words.device)[None, :]
    valid = idx < words[:, 2:3]
    cols = []
    for c in range(schema.n_cols):
        s, e = schema.col_word_range(c)
        col = words[:, s:e]
        dt = schema.col_dtype(c)
        if dt.itemsize == 8:
            col = col.contiguous().view(_WIDE[dt])
        elif dt == np.dtype(np.float32):
            col = col.view(torch.float32)
        elif dt == np.dtype(np.uint32):
            col = col.to(torch.int64) & 0xFFFFFFFF
        cols.append(col)
    nulls = {}
    for c in range(schema.n_cols):
        if schema.col_nullable(c):
            s, e = schema.validity_word_range(c)
            vw = words[:, s:e]
            bits = (vw[:, (idx // 32).reshape(-1)].reshape(b, t)
                    >> (idx % 32)) & 1
            nulls[c] = bits == 0
    if schema.visibility:
        s, e = schema.col_word_range(schema.n_cols)
        valid = valid & (words[:, s:e] != 0)
    return Cols(cols, nulls), valid


def _masked_sum(col: torch.Tensor, mask: torch.Tensor,
                dt: np.dtype) -> torch.Tensor:
    picked = torch.where(mask, col, torch.zeros((), dtype=col.dtype,
                                                device=col.device))
    if dt == np.dtype(np.int32):
        return picked.sum(dtype=torch.int32)          # wraps mod 2^32
    if dt == np.dtype(np.uint32):
        wrapped = picked.sum() & 0xFFFFFFFF
        return wrapped.to(torch.int32).view(torch.uint32)
    return picked.sum(dtype=col.dtype)


def make_filter_fn(schema: HeapSchema,
                   predicate: Union[FilterPred, Callable]) -> Callable:
    """Build ``run(pages_u8, threshold=0) -> {"count", "sums"}``: the
    selected-row count and per-column masked sums, NULL-aware (a nullable
    column's sum skips its NULL rows, and ``nncounts`` — per-column
    non-NULL selected counts — appears when the schema has nullable
    columns)."""
    any_null = any(schema.col_nullable(c) for c in range(schema.n_cols))

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        cols, valid = decode_pages(pages_u8, schema)
        if isinstance(predicate, FilterPred):
            sel = predicate.mask(cols, valid, schema, threshold)
        else:
            sel = valid & predicate(cols, threshold)

        def colmask(c):
            n = cols.nulls.get(c)
            return sel if n is None else sel & ~n

        out = {"count": sel.sum(dtype=torch.int32),
               "sums": [_masked_sum(v, colmask(c), schema.col_dtype(c))
                        for c, v in enumerate(cols)]}
        if any_null:
            out["nncounts"] = [colmask(c).sum(dtype=torch.int32)
                               for c in range(schema.n_cols)]
        return out

    return run


#: the flagship predicate: col0 > threshold
STEP_PRED = FilterPred(((0, "gt", None),))


def scan_filter_step(pages_u8: torch.Tensor, threshold) -> dict:
    """Flagship step: predicate ``col0 > threshold`` over a page batch of
    the default schema; returns the selected count and the sum of col1."""
    out = make_filter_fn(DEFAULT_SCHEMA, STEP_PRED)(pages_u8, threshold)
    return {"count": out["count"], "sum": out["sums"][1]}
