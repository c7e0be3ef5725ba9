"""Fused decode → filter → aggregate over packed pages (plain PyTorch).

The plain version of the pushdown kernel (:mod:`.decode_cuda`), ported
from the JAX package's ``ops/decode_xla.py``: a batch of ``.cpk`` pages
(``scan/colpack.py``) expands to logical rows — planar bit-unpack plus
base, a dictionary select, run-length intervals, raw words — and folds a
masked count plus per-column sums, the same result as the heap filter
(:mod:`.filter`) over the same rows.

Columns outside ``need_cols`` decode as zeros (projection); pages without
``CPK_MAGIC`` (the file's header page, zero padding) hold no rows.  Sums
follow the filter's banks: int32 sums wrap mod 2^32, uint32 sums come back
as ``torch.uint32`` bit patterns, float32 sums add in float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..scan.colpack import CPK_MAGIC, ColCodec, PackedMeta
from .filter import Cols, FilterPred, _masked_sum, page_words

__all__ = ["decode_block_words", "make_decode_filter_fn"]

_MASK32 = 0xFFFFFFFF


def _unpack_bits(packed: torch.Tensor, bits: int, rpb: int) -> torch.Tensor:
    """Planar bit-unpack: (bp, nw) words (int64, 32-bit values) -> (bp,
    rpb); value ``j`` lives in word ``j % nw`` at shift ``(j // nw) *
    bits``, so plane k is one shift and mask of the whole region."""
    mask = (1 << bits) - 1
    planes = [(packed >> (k * bits)) & mask for k in range(32 // bits)]
    return torch.cat(planes, dim=1)[:, :rpb]


def _decode_col(wu: torch.Tensor, cm: ColCodec, rpb: int,
                iota: torch.Tensor) -> torch.Tensor:
    """One column's region -> (bp, rpb) int64 holding the 32-bit
    patterns."""
    r = wu[:, cm.off:cm.off + cm.nwords]
    if cm.codec == "raw":
        return r[:, :rpb]
    if cm.codec == "bitpack":
        return (_unpack_bits(r[:, 1:], cm.bits, rpb) + r[:, 0:1]) & _MASK32
    if cm.codec == "dict":
        idx = _unpack_bits(r[:, cm.dsize:], cm.bits, rpb)
        acc = torch.zeros_like(idx)
        for d in range(cm.dsize):
            acc = acc + torch.where(idx == d, r[:, d:d + 1], 0)
        return acc
    # rle: run values + cumulative ends; padded runs are empty [n, n)
    vals = r[:, 1:1 + cm.rmax]
    ends = r[:, 1 + cm.rmax:1 + 2 * cm.rmax]
    ends = torch.where(ends >= 1 << 31, ends - (1 << 32), ends)  # int32
    acc = torch.zeros(iota.shape, dtype=torch.int64, device=wu.device)
    prev = torch.zeros((iota.shape[0], 1), dtype=torch.int64,
                       device=wu.device)
    for k in range(cm.rmax):
        end = ends[:, k:k + 1]
        acc = acc + torch.where((iota >= prev) & (iota < end),
                                vals[:, k:k + 1], 0)
        prev = end
    return acc


def decode_block_words(words: torch.Tensor, meta: PackedMeta,
                       need: Optional[Sequence[int]] = None):
    """(bp, 2048) int32 packed-page words -> (columns, valid mask).

    Columns come as the filter decodes heap columns: int32 and float32 in
    their dtype, uint32 as int64 holding the unsigned value.  Pages without
    the data-block magic decode to an all-False mask; columns outside
    *need* are zeros."""
    rpb = meta.rows_per_block
    bp = words.shape[0]
    wu = words.to(torch.int64) & _MASK32
    iota = torch.arange(rpb, device=words.device)[None, :].expand(bp, rpb)
    valid = (wu[:, 0:1] == CPK_MAGIC) & (iota < words[:, 2:3])
    cols = []
    for c, cm in enumerate(meta.cols):
        dt = np.dtype(meta.dtypes[c])
        if need is not None and c not in need:
            u = torch.zeros((bp, rpb), dtype=torch.int64, device=words.device)
        else:
            u = _decode_col(wu, cm, rpb, iota)
        if dt == np.dtype(np.uint32):
            cols.append(u)
            continue
        i32 = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
        cols.append(i32.view(torch.float32) if dt.kind == "f" else i32)
    return Cols(cols), valid


def make_decode_filter_fn(meta: PackedMeta,
                          predicate: Union[FilterPred, Callable, None] = None,
                          *, need_cols: Optional[Sequence[int]] = None
                          ) -> Callable:
    """Build ``run(pages_u8, threshold=0) -> {"count", "sums"}`` over a
    batch of packed pages: the selected-row count and one masked sum per
    column (index = absolute column).  ``predicate`` is a
    :class:`FilterPred` or ``predicate(cols, threshold) -> bool``; it sees
    every column, the un-needed ones as zeros."""
    need = tuple(need_cols) if need_cols is not None else None
    dtypes = [np.dtype(d) for d in meta.dtypes]

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        cols, valid = decode_block_words(page_words(pages_u8), meta, need)
        if isinstance(predicate, FilterPred):
            sel = predicate.mask(cols, valid, dtypes, threshold)
        elif predicate is not None:
            sel = valid & predicate(cols, threshold)
        else:
            sel = valid
        return {"count": sel.sum(dtype=torch.int32),
                "sums": [_masked_sum(v, sel, dt)
                         for v, dt in zip(cols, dtypes)]}

    return run
