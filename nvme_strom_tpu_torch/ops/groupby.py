"""Grouped aggregation over device-resident heap pages (plain PyTorch).

The plain version of the GROUP BY kernel (:mod:`.groupby_cuda`) and its
contract, ported from the JAX package's ``ops/groupby.py`` with the types
and results of its Pallas kernel (``ops/groupby_pallas.py``): per group a
count and, per aggregated column, sum, sum of squares, min and max, in one
pass over a page batch.

Result: ``count (G,)`` int32; ``sums``, ``sumsqs``, ``mins``, ``maxs`` of
shape ``(V, G)`` for ``V`` aggregated columns of one 4-byte dtype.

* int32 sums wrap mod 2^32; ``sumsqs`` are always float32 (this version
  adds the float32 terms in float64 and rounds once, the reference any
  float32 accumulation order is held to).
* uint32 sums, mins and maxs come back as ``torch.uint32`` bit patterns
  (torch has no uint32 arithmetic; view them as int32 to compute).
* float32 sums and sums of squares follow IEEE per group: a NaN in the
  group gives NaN, +inf and -inf together give NaN, one-signed infinity
  wins; float min/max propagate NaN as ``jnp.min``/``jnp.max`` do.
* Empty groups report count 0, sums 0 and the dtype's sentinels: min is
  the largest value (+inf for floats), max the smallest.

The group key is a :class:`GroupKey` descriptor, the form the CUDA kernel
takes, or a callable ``key(cols, threshold) -> (B, T)`` integer ids (CPU
tensors only).  Ids outside ``[0, G)`` fall into no group.  The 64-bit
accumulators the JAX package takes under ``jax_enable_x64`` are not
ported.
"""

from __future__ import annotations

import errno as _errno
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..api import StromError
from ..scan.heap import HeapSchema
from .filter import FilterPred, decode_pages

__all__ = ["GroupKey", "acc_dtypes", "make_groupby_fn", "combine_groupby"]

_I32 = np.dtype(np.int32)
_U32 = np.dtype(np.uint32)
_F32 = np.dtype(np.float32)
_INT_MIN = -(1 << 31)


@dataclass(frozen=True)
class GroupKey:
    """Group id ``(abs(c) if absolute else c) % mod`` of int32 or uint32
    column ``c = cols[col]``; ``mod=None`` takes the value itself.  ``%``
    is jnp's floor modulo (the result has the sign of ``mod``, here always
    positive) and ``abs`` wraps as jnp's does (``abs(INT_MIN)`` stays
    negative); a uint32 column takes the unsigned modulo."""

    col: int
    mod: Optional[int] = None
    absolute: bool = False

    def __post_init__(self):
        if not isinstance(self.col, (int, np.integer)) or self.col < 0:
            raise StromError(_errno.EINVAL, f"bad group key column "
                                            f"{self.col!r}")
        if self.mod is not None and not (
                isinstance(self.mod, (int, np.integer))
                and 1 <= self.mod < (1 << 31)):
            raise StromError(_errno.EINVAL, f"group key mod {self.mod!r}: "
                                            f"an int in [1, 2^31)")

    def check(self, schema: HeapSchema) -> None:
        if self.col >= schema.n_cols:
            raise StromError(_errno.EINVAL, f"group key column {self.col} "
                                            f"outside the schema")
        if schema.col_dtype(self.col) not in (_I32, _U32):
            raise StromError(_errno.EINVAL, f"group key column {self.col} "
                                            f"is {schema.col_dtype(self.col)};"
                                            f" keys are int32 or uint32")

    def ids(self, cols, schema: HeapSchema) -> torch.Tensor:
        """(B, T) int64 group ids (any value; the caller masks the
        range)."""
        self.check(schema)
        x = cols[self.col].to(torch.int64)    # int32, or uint32 as int64
        if self.absolute and schema.col_dtype(self.col) == _I32:
            x = (x.abs() - _INT_MIN) % (1 << 32) + _INT_MIN
        if self.mod is not None:
            x = torch.remainder(x, int(self.mod))
        return x


def acc_dtypes(agg_dt: np.dtype):
    """The accumulation convention: ``(sum dtype, sumsq dtype, lo, hi)``
    where ``lo`` is the dtype's lowest value (the MAX sentinel) and ``hi``
    its highest (the MIN sentinel).  Sums stay in the column dtype (int32
    sums wrap), sums of squares are float32."""
    if agg_dt.kind == "f":
        return agg_dt, _F32, agg_dt.type(-np.inf), agg_dt.type(np.inf)
    info = np.iinfo(agg_dt)
    return agg_dt, _F32, agg_dt.type(info.min), agg_dt.type(info.max)


def _check_agg_cols(schema: HeapSchema, agg_cols):
    """Resolve aggregation columns: one shared dtype, int32, uint32 or
    float32.  Returns (indices, dtype)."""
    cols_idx = list(agg_cols) if agg_cols is not None else \
        list(range(schema.n_cols))
    if not cols_idx:
        raise StromError(_errno.EINVAL, "groupby needs at least one "
                                        "aggregation column")
    for ci in cols_idx:
        if not 0 <= ci < schema.n_cols:
            raise StromError(_errno.EINVAL, f"aggregation column {ci} out of "
                                            f"range — this schema has "
                                            f"columns 0..{schema.n_cols - 1}")
    dts = {schema.col_dtype(ci) for ci in cols_idx}
    if len(dts) > 1:
        raise StromError(_errno.EINVAL, f"groupby aggregation columns must "
                                        f"share one dtype, got "
                                        f"{sorted(str(d) for d in dts)}; "
                                        f"split into one groupby per dtype")
    dt = dts.pop()
    if dt not in (_I32, _U32, _F32):
        raise StromError(_errno.EINVAL, f"groupby aggregates int32, uint32 "
                                        f"or float32 columns (got {dt}; the "
                                        f"64-bit accumulators are not "
                                        f"ported)")
    return cols_idx, dt


def _wrap_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 mod 2^32."""
    return ((s - _INT_MIN) % (1 << 32) + _INT_MIN).to(torch.int32)


def ieee_sums(fin: torch.Tensor, fin_sq: torch.Tensor, n_nan: torch.Tensor,
              n_pinf: torch.Tensor, n_ninf: torch.Tensor):
    """Per-group IEEE sums from finite sums and NaN/+inf/-inf counts: NaN
    dominates, mixed infinities are NaN, one-signed infinity wins; a sum
    of squares with any infinity is +inf."""
    nan = torch.tensor(float("nan"), dtype=fin.dtype, device=fin.device)
    inf = torch.tensor(float("inf"), dtype=fin.dtype, device=fin.device)
    sums = torch.where((n_nan > 0) | ((n_pinf > 0) & (n_ninf > 0)), nan,
                       torch.where(n_pinf > 0, inf,
                                   torch.where(n_ninf > 0, -inf, fin)))
    sqs = torch.where(n_nan > 0, nan,
                      torch.where((n_pinf > 0) | (n_ninf > 0), inf, fin_sq))
    return sums, sqs


def make_groupby_fn(schema: HeapSchema,
                    key: Union[GroupKey, Callable], n_groups: int, *,
                    agg_cols: Optional[Sequence[int]] = None,
                    predicate: Union[FilterPred, Callable, None] = None
                    ) -> Callable:
    """Build ``run(pages_u8, threshold=0) -> dict``, the grouped aggregate
    of the module's contract.  ``predicate`` is a :class:`FilterPred` or
    ``predicate(cols, threshold) -> bool``; ``threshold`` feeds a term
    whose value is None, and the callables."""
    cols_idx, agg_dt = _check_agg_cols(schema, agg_cols)
    G = int(n_groups)
    if G < 1:
        raise StromError(_errno.EINVAL, f"n_groups {G}: at least 1")
    if isinstance(key, GroupKey):
        key.check(schema)
    elif not callable(key):
        raise StromError(_errno.EINVAL, "key must be a GroupKey or a callable")
    _acc, _sq, lo, hi = acc_dtypes(agg_dt)

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        cols, valid = decode_pages(pages_u8, schema)
        ids = key.ids(cols, schema) if isinstance(key, GroupKey) \
            else key(cols, threshold).to(torch.int64)
        sel = valid & (ids >= 0) & (ids < G)
        if isinstance(predicate, FilterPred):
            sel = predicate.mask(cols, sel, schema, threshold)
        elif predicate is not None:
            sel = sel & predicate(cols, threshold)
        k = ids[sel]
        dev = pages_u8.device
        out = {"count": torch.bincount(k, minlength=G)[:G]
               .to(torch.int32)}
        z64 = torch.zeros(G, dtype=torch.float64, device=dev)

        def f32_sum(idx, v):
            # float32 terms added in float64 and rounded once: the
            # reference every float32 accumulation order is held to
            return z64.index_add(0, idx, v.double()).to(torch.float32)

        sums, sqs, mins, maxs = [], [], [], []
        for ci in cols_idx:
            x = cols[ci][sel]
            if agg_dt.kind == "f":
                isn, pin, nin = x.isnan(), x == float("inf"), \
                    x == float("-inf")
                fin = ~(isn | pin | nin)
                s = f32_sum(k[fin], x[fin])
                s2 = f32_sum(k[fin], x[fin] * x[fin])
                cnt = [torch.bincount(k[m], minlength=G)[:G]
                       for m in (isn, pin, nin)]
                s, s2 = ieee_sums(s, s2, *cnt)
                ok = ~isn
                mn = torch.full((G,), float(hi), device=dev).scatter_reduce(
                    0, k[ok], x[ok], "amin")
                mx = torch.full((G,), float(lo), device=dev).scatter_reduce(
                    0, k[ok], x[ok], "amax")
                nan = torch.tensor(float("nan"), device=dev)
                mn = torch.where(cnt[0] > 0, nan, mn)
                mx = torch.where(cnt[0] > 0, nan, mx)
            else:
                x64 = x.to(torch.int64)       # uint32 decodes as int64
                s = _wrap_i32(torch.zeros(G, dtype=torch.int64, device=dev)
                              .index_add(0, k, x64))
                xf = x64.to(torch.float32)
                s2 = f32_sum(k, xf * xf)
                mn = torch.full((G,), int(hi), dtype=torch.int64,
                                device=dev).scatter_reduce(0, k, x64, "amin")
                mx = torch.full((G,), int(lo), dtype=torch.int64,
                                device=dev).scatter_reduce(0, k, x64, "amax")
                mn, mx = _wrap_i32(mn), _wrap_i32(mx)
                if agg_dt == _U32:
                    s, mn, mx = (t.view(torch.uint32) for t in (s, mn, mx))
            sums.append(s)
            sqs.append(s2)
            mins.append(mn)
            maxs.append(mx)
        out.update(sums=torch.stack(sums), sumsqs=torch.stack(sqs),
                   mins=torch.stack(mins), maxs=torch.stack(maxs))
        return out

    return run


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _meet(a: torch.Tensor, b: torch.Tensor, fn) -> torch.Tensor:
    if a.dtype != torch.uint32:
        return fn(a, b)
    # unsigned order in sign-flipped int32 space
    return (fn(a.view(torch.int32) ^ _INT_MIN,
               b.view(torch.int32) ^ _INT_MIN) ^ _INT_MIN).view(torch.uint32)


def combine_groupby(acc: dict, out: dict) -> dict:
    """Batch-fold combiner for grouped results (pass as
    ``TableScanner.scan_filter(..., combine=combine_groupby)``):
    counts, sums and sumsqs add, mins and maxs meet."""
    sums = _as_i32(acc["sums"]) + _as_i32(out["sums"])
    if acc["sums"].dtype == torch.uint32:
        sums = sums.view(torch.uint32)
    return {"count": acc["count"] + out["count"], "sums": sums,
            "sumsqs": acc["sumsqs"] + out["sumsqs"],
            "mins": _meet(acc["mins"], out["mins"], torch.minimum),
            "maxs": _meet(acc["maxs"], out["maxs"], torch.maximum)}
