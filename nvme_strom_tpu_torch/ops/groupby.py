"""Grouped aggregation over device-resident heap pages (plain PyTorch).

The plain version of the GROUP BY kernel (:mod:`.groupby_cuda`) and its
contract, ported from the JAX package's ``ops/groupby.py`` with the types
and results of its Pallas kernel (``ops/groupby_pallas.py``): per group a
count and, per aggregated column, sum, sum of squares, min and max, in one
pass over a page batch.

Result: ``count (G,)`` int32; ``sums``, ``sumsqs``, ``mins``, ``maxs`` of
shape ``(V, G)`` for ``V`` aggregated columns of one dtype; ``nncounts
(V, G)``, the per-column non-NULL counts, when an aggregated column is
nullable.

* int32 sums wrap mod 2^32; ``sumsqs`` of 4-byte columns are float32
  (this version adds the float32 terms in float64 and rounds once, the
  reference any float32 accumulation order is held to).
* With config ``x64`` (the JAX package's ``jax_enable_x64``) 4-byte int
  sums widen to 8 bytes, every ``sumsqs`` is float64 and the counts are
  int64; float sums stay in the column's dtype.  Such a plan takes the
  torch route (B3 holds 32-bit accumulators).  A uint32 column's widened
  sums come back as ``torch.int64`` (torch has no uint64 arithmetic),
  which :func:`acc_dtypes` names uint64 on the host.
* int64 and float64 columns (this version only; the CUDA kernel takes
  4-byte columns) accumulate in 64 bits with float64 ``sumsqs``, as the
  JAX package does under ``jax_enable_x64``; the port serves them
  without any switch, and a schema holding one accumulates as under
  ``x64`` whatever the switch says (:func:`.filter.wide_sums`): the JAX
  package serves such a table only in 64-bit mode.
* A nullable column's NULL rows add nothing to its sums, sums of squares,
  mins and maxs, and are left out of its ``nncounts``; ``count`` stays
  the row count (SQL ``COUNT(*)``).
* uint32 sums, mins and maxs come back as ``torch.uint32`` bit patterns
  (torch has no uint32 arithmetic; view them as int32 to compute).
* float32 sums and sums of squares follow IEEE per group: a NaN in the
  group gives NaN, +inf and -inf together give NaN, one-signed infinity
  wins; float min/max propagate NaN as ``jnp.min``/``jnp.max`` do.
* Empty groups report count 0, sums 0 and the dtype's sentinels: min is
  the largest value (+inf for floats), max the smallest.

The group key is a :class:`GroupKey` descriptor, the form the CUDA kernel
takes, or a callable ``key(cols, threshold) -> (B, T)`` integer ids in
torch ops (this version only).  Ids outside ``[0, G)`` fall into no
group.
"""

from __future__ import annotations

import errno as _errno
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..api import StromError
from ..scan.heap import HeapSchema
from .filter import FilterPred, decode_pages, select_rows, wide_sums

__all__ = ["GroupKey", "acc_dtypes", "make_groupby_fn", "make_groupby_fold",
           "combine_groupby", "groupby_kernel_auto", "GROUPBY_CUDA_RATIO"]

#: time of a float32 G=8 GROUP BY batch (2048 pages, abs(c1) % 8 over two
#: float32 columns) on the torch route's step over its time through B3's
#: wrapper, both as issued: 6.8790 ms against 0.8296 ms, measured by
#: chip_smoke.py [8] on an NVIDIA H100 80GB HBM3 at a 700 W power limit.
#: groupby_kernel_auto routes float aggregation to the torch route below
#: 1.0; config ``groupby_cuda_ratio`` overrides it.
GROUPBY_CUDA_RATIO = 8.292

_I32 = np.dtype(np.int32)
_U32 = np.dtype(np.uint32)
_F32 = np.dtype(np.float32)
_I64 = np.dtype(np.int64)
_F64 = np.dtype(np.float64)
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


def acc_dtypes(agg_dt: np.dtype, schema: Optional[HeapSchema] = None):
    """The accumulation convention: ``(sum dtype, sumsq dtype, lo, hi)``
    where ``lo`` is the dtype's lowest value (the MAX sentinel) and ``hi``
    its highest (the MIN sentinel).  Sums stay in the column dtype (int32
    sums wrap), sums of squares are float32 for 4-byte columns and float64
    for 8-byte ones.  Under 64-bit accumulation (config ``x64``, or a
    *schema* with an 8-byte column: :func:`.filter.wide_sums`) int sums
    are 8 bytes wide (int64, uint64) and every sum of squares is float64,
    as the JAX package's under ``jax_enable_x64``."""
    x64 = wide_sums(schema)
    sq = _F64 if x64 or agg_dt.itemsize == 8 else _F32
    if agg_dt.kind == "f":
        return agg_dt, sq, agg_dt.type(-np.inf), agg_dt.type(np.inf)
    acc = np.dtype(agg_dt.kind + "8") if x64 else agg_dt
    info = np.iinfo(agg_dt)
    return acc, sq, agg_dt.type(info.min), agg_dt.type(info.max)


def _cuda_ratio() -> float:
    from ..config import config
    return float(config.get("groupby_cuda_ratio")) or GROUPBY_CUDA_RATIO


def groupby_kernel_auto(agg_kind: str):
    """The measured route of a GROUP BY: ``(kernel, why)`` with kernel
    ``cuda`` (B3) or ``torch``.  Int accumulation stays on B3; float
    accumulation goes to the torch route when B3 is not faster than it on
    the card (the ratio :data:`GROUPBY_CUDA_RATIO`, or config
    ``groupby_cuda_ratio``, below 1.0), as the JAX package sends it to XLA
    below its TPU's ratio."""
    if agg_kind != "f":
        return "cuda", "int accumulators keep B3"
    ratio = _cuda_ratio()
    if ratio < 1.0:
        return "torch", (f"float aggregation routes to the torch route "
                         f"(measured torch/B3 time ratio {ratio:g} < 1.0)")
    return "cuda", (f"measured torch/B3 time ratio {ratio:g} >= 1.0: B3 "
                    f"wins float aggregation on this card")


def _check_agg_cols(schema: HeapSchema, agg_cols):
    """Resolve aggregation columns: one shared dtype, int32, uint32,
    float32, int64 or float64.  Returns (indices, dtype)."""
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
    if dt not in (_I32, _U32, _F32, _I64, _F64):
        raise StromError(_errno.EINVAL, f"groupby aggregates int32, uint32, "
                                        f"float32, int64 or float64 columns "
                                        f"(got {dt})")
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
    fold = make_groupby_fold(schema, key, n_groups, agg_cols=agg_cols,
                             predicate=predicate)

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        return fold(*decode_pages(pages_u8, schema), threshold)

    return run


def make_groupby_fold(schema: HeapSchema,
                      key: Union[GroupKey, Callable], n_groups: int, *,
                      agg_cols: Optional[Sequence[int]] = None,
                      predicate: Union[FilterPred, Callable, None] = None
                      ) -> Callable:
    """The step of :func:`make_groupby_fn` on decoded columns:
    ``fold(cols, valid, threshold=0) -> dict``, any shape (the index
    access path folds fetched rows with it)."""
    cols_idx, agg_dt = _check_agg_cols(schema, agg_cols)
    G = int(n_groups)
    if G < 1:
        raise StromError(_errno.EINVAL, f"n_groups {G}: at least 1")
    if isinstance(key, GroupKey):
        key.check(schema)
    elif not callable(key):
        raise StromError(_errno.EINVAL, "key must be a GroupKey or a callable")
    acc, sq, lo, hi = acc_dtypes(agg_dt, schema)
    wide = acc.itemsize == 8      # 8-byte columns, or 4-byte ones under x64
    sq_t = torch.float64 if sq == _F64 else torch.float32
    # the row counts are int64 under 64-bit accumulation (the non-NULL
    # counts stay int32), as the reference's
    cnt_t = torch.int64 if wide_sums(schema) else torch.int32
    nullable = [schema.col_nullable(ci) for ci in cols_idx]
    any_null = any(nullable)

    def fold(cols, valid: torch.Tensor, threshold=0) -> dict:
        ids = key.ids(cols, schema) if isinstance(key, GroupKey) \
            else key(cols, threshold).to(torch.int64)
        sel = valid & (ids >= 0) & (ids < G)
        sel = select_rows(predicate, cols, sel, schema, threshold)
        dev = valid.device
        out = {"count": torch.bincount(ids[sel], minlength=G)[:G]
               .to(cnt_t)}
        z64 = torch.zeros(G, dtype=torch.float64, device=dev)

        def f_sum(idx, v, dtype):
            # float terms added in float64 and rounded once: the
            # reference every float accumulation order is held to
            return z64.index_add(0, idx, v.double()).to(dtype)

        sums, sqs, mins, maxs, nns = [], [], [], [], []
        for ci, nul in zip(cols_idx, nullable):
            m = sel & ~cols.nulls[ci] if nul else sel
            k = ids[m]
            x = cols[ci][m]
            if any_null:
                nns.append(torch.bincount(k, minlength=G)[:G]
                           .to(torch.int32))
            if agg_dt.kind == "f":
                isn, pin, nin = x.isnan(), x == float("inf"), \
                    x == float("-inf")
                fin = ~(isn | pin | nin)
                s = f_sum(k[fin], x[fin], x.dtype)
                xs = x[fin].to(sq_t)
                s2 = f_sum(k[fin], xs * xs, sq_t)
                cnt = [torch.bincount(k[c], minlength=G)[:G]
                       for c in (isn, pin, nin)]
                s, s2 = ieee_sums(s, s2, *cnt)
                ok = ~isn
                mn = torch.full((G,), float(hi), dtype=x.dtype,
                                device=dev).scatter_reduce(
                    0, k[ok], x[ok], "amin")
                mx = torch.full((G,), float(lo), dtype=x.dtype,
                                device=dev).scatter_reduce(
                    0, k[ok], x[ok], "amax")
                nan = torch.tensor(float("nan"), dtype=x.dtype, device=dev)
                mn = torch.where(cnt[0] > 0, nan, mn)
                mx = torch.where(cnt[0] > 0, nan, mx)
            else:
                x64 = x.to(torch.int64)       # uint32 decodes as int64
                s = torch.zeros(G, dtype=torch.int64,
                                device=dev).index_add(0, k, x64)
                xf = x64.to(sq_t)
                s2 = f_sum(k, xf * xf, sq_t)
                mn = torch.full((G,), int(hi), dtype=torch.int64,
                                device=dev).scatter_reduce(0, k, x64, "amin")
                mx = torch.full((G,), int(lo), dtype=torch.int64,
                                device=dev).scatter_reduce(0, k, x64, "amax")
                if agg_dt.itemsize == 4:
                    # mins and maxs keep the column's dtype; sums widen
                    # under x64
                    mn, mx = _wrap_i32(mn), _wrap_i32(mx)
                    if not wide:
                        s = _wrap_i32(s)
                if agg_dt == _U32:
                    mn, mx = mn.view(torch.uint32), mx.view(torch.uint32)
                    if not wide:
                        s = s.view(torch.uint32)
            sums.append(s)
            sqs.append(s2)
            mins.append(mn)
            maxs.append(mx)
        out.update(sums=torch.stack(sums), sumsqs=torch.stack(sqs),
                   mins=torch.stack(mins), maxs=torch.stack(maxs))
        if any_null:
            out["nncounts"] = torch.stack(nns)
        return out

    return fold


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
    counts, sums, sumsqs and non-NULL counts add, mins and maxs meet."""
    sums = _as_i32(acc["sums"]) + _as_i32(out["sums"])
    if acc["sums"].dtype == torch.uint32:
        sums = sums.view(torch.uint32)
    folded = {"count": acc["count"] + out["count"], "sums": sums,
              "sumsqs": acc["sumsqs"] + out["sumsqs"],
              "mins": _meet(acc["mins"], out["mins"], torch.minimum),
              "maxs": _meet(acc["maxs"], out["maxs"], torch.maximum)}
    if "nncounts" in acc:
        folded["nncounts"] = acc["nncounts"] + out["nncounts"]
    return folded
