"""Top-k over device-resident heap pages (ORDER BY col LIMIT k), in
PyTorch ops on the pages' device.

A port of the JAX package's ``ops/topk.py``: a per-batch selection plus a
fold that merges batch winners, so the scan streams any table while the
device holds only ``k`` candidates.  The selection is a stable descending
sort of the ranking key, which keeps ``jax.lax.top_k``'s rules: ties go to
the lower index (the earlier row), and floats rank in XLA's total order
(:func:`float_order_key`): −NaN < −inf < … < −0.0 < +0.0 < … < +inf < +NaN.

Row identity travels with the values: ``positions`` are global row numbers
(``page_id * tuples_per_page + slot``, :func:`.filter.global_row_positions`),
int64 (the JAX package's dtype under x64).  Values come in the decoded
dtype (a uint32 column as int64 holding the unsigned value); the caller
casts them back.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from ..scan.heap import HeapSchema
from .filter import FilterPred, decode_pages, global_row_positions, \
    select_rows

__all__ = ["worst_sentinel", "float_order_key", "topk_key", "rank_topk",
           "make_topk_fn", "combine_topk"]


def worst_sentinel(dt: np.dtype, largest: bool) -> np.ndarray:
    """The pad value that can never beat a real candidate."""
    if dt.kind == "f":
        return np.array(-np.inf if largest else np.inf, dt)
    info = np.iinfo(dt)
    return np.array(info.min if largest else info.max, dt)


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def float_order_key(v: torch.Tensor) -> torch.Tensor:
    """The integer key that orders floats as XLA's total order does:
    the bits as a signed integer, with every bit but the sign flipped
    where the sign is set.  −NaN < −inf < … < −0.0 < +0.0 < … < +inf <
    +NaN, NaN payloads in bit order."""
    bits = v.contiguous().view(_BITS[v.dtype])
    mask = torch.iinfo(bits.dtype).max
    return torch.where(bits < 0, bits ^ mask, bits)


def topk_key(v: torch.Tensor, dt: np.dtype, largest: bool) -> torch.Tensor:
    """The key whose *k* largest entries are the answer: floats by
    :func:`float_order_key` (negated as ``~key`` for smallest-k, which is
    ``-v`` under XLA's order: −NaN first, +NaN last, −0.0 before +0.0);
    integers as they are, or ``~v`` for smallest-k, which cannot overflow
    (a uint32 column decodes to int64, where ``~v`` reverses it too)."""
    key = float_order_key(v) if dt.kind == "f" else v
    return key if largest else ~key


def _first_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the *k* largest keys, ties to the lower index:
    ``lax.top_k``'s selection."""
    return torch.sort(key, descending=True, stable=True).indices[:k]


def rank_topk(flat_v: torch.Tensor, flat_p: torch.Tensor, k: int,
              dt: np.dtype, largest: bool):
    """Select, then pad to *k* with the worst sentinel and position -1.
    A real row whose value equals the sentinel keeps its position."""
    kk = min(k, int(flat_v.numel()))
    idx = _first_k(topk_key(flat_v, dt, largest), kk)
    vals, positions = flat_v[idx], flat_p[idx]
    if kk < k:
        worst = torch.tensor(worst_sentinel(dt, largest).item(),
                             dtype=flat_v.dtype, device=flat_v.device)
        vals = torch.cat([vals, worst.expand(k - kk)])
        positions = torch.cat([positions, torch.full(
            (k - kk,), -1, dtype=flat_p.dtype, device=flat_p.device)])
    return vals, positions


def make_topk_fn(schema: HeapSchema, col: int, k: int, *,
                 largest: bool = True,
                 predicate: Union[FilterPred, Callable, None] = None
                 ) -> Callable:
    """Build ``run(pages_u8, threshold=0) -> {"values", "positions"}``:
    the *k* largest (or smallest) values of column *col* among valid and
    predicate-passing rows of the batch, with their global row numbers.
    Rows that fail the predicate rank as the worst sentinel at position
    -1, as in the JAX kernel; fewer than *k* rows pad the same way.
    ``run.combine`` is the matching batch fold."""
    dt = schema.col_dtype(col)
    worst = worst_sentinel(dt, largest).item()

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        cols, valid = decode_pages(pages_u8, schema)
        sel = select_rows(predicate, cols, valid, schema, threshold)
        v = cols[col]
        pos = global_row_positions(pages_u8, schema)
        flat_v = torch.where(sel, v, torch.tensor(
            worst, dtype=v.dtype, device=v.device)).reshape(-1)
        flat_p = torch.where(sel, pos, -1).reshape(-1)
        vals, positions = rank_topk(flat_v, flat_p, k, dt, largest)
        return {"values": vals, "positions": positions}

    run.k = k
    run.largest = largest
    run.combine = lambda a, b: combine_topk(a, b, dt=dt, largest=largest)
    return run


def combine_topk(acc: dict, out: dict, *, dt: np.dtype,
                 largest: bool = True) -> dict:
    """Batch fold: the best ``k`` of two candidate sets, the earlier set
    first among ties."""
    vals = torch.cat([acc["values"], out["values"]])
    poss = torch.cat([acc["positions"], out["positions"]])
    idx = _first_k(topk_key(vals, dt, largest), acc["values"].shape[0])
    return {"values": vals[idx], "positions": poss[idx]}
