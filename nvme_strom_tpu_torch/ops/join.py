"""Broadcast joins over device-resident heap pages, in PyTorch ops.

A port of the JAX package's ``ops/join.py``.  A small *build side* (a
dimension table of unique int32 keys and one payload column) is sorted
once on the host, moved to the pages' device once per join function and
probed by every scanned batch with ``torch.searchsorted``: no hash table,
the same sorted probe as the reference.  No hand-written kernel computes
a join; the reference runs these steps through XLA, and the port runs them
as PyTorch ops on the query's device (the ``torch`` route of
:mod:`..scan.query`).

The aggregate steps fold across batches like every other scan step (a sum
per leaf); the row steps return per-row outcomes that the query
compresses.  Accumulators follow :func:`.groupby.acc_dtypes`: int32 sums
wrap mod 2^32, uint32 payloads and columns (int64 holding the unsigned
value, as the decode gives them) sum as ``torch.uint32`` wrapped mod 2^32,
float32 in float32, 8-byte columns in their own dtype.  Under 64-bit
accumulation (:func:`.filter.wide_sums`) the counts and the 4-byte integer
sums widen to 64 bits, as the filter's.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..scan.heap import HeapSchema
from .filter import (FilterPred, _masked_sum, decode_pages,
                     global_row_positions, row_count, select_rows,
                     wide_sums)

__all__ = ["make_join_fn", "make_join_rows_fn", "make_star_fn",
           "make_star_rows_fn", "key_hash32", "hash_split_build",
           "check_join_how", "JOIN_HOWS"]

# Knuth multiplicative constant: scrambles int32 keys so hash % P spreads
# adjacent and striped key spaces evenly across partitions
_KNUTH = 2654435761

# The join faces every strategy serves: inner = rows with a partner, plus
# its payload; semi = EXISTS (payload not exposed); anti = NOT EXISTS;
# left = every selected probe row, payload where partnered and a NULL
# indicator where not.
JOIN_HOWS = ("inner", "left", "semi", "anti")

Predicate = Union[FilterPred, Callable, None]


def check_join_how(how: str) -> str:
    if how not in JOIN_HOWS:
        raise ValueError(f"join how={how!r} (expected one of {JOIN_HOWS})")
    return how


def _emit_mask(how, sel, hit):
    """The rows a join emits under *how*, from the selected mask and the
    has-a-partner mask: the one derivation every strategy uses."""
    if how in ("inner", "semi"):
        return hit
    if how == "anti":
        return sel & ~hit
    return sel            # left: every selected probe row


def _owner_mask(probe, owner_part):
    """Grace-pass ownership: each probe row belongs to exactly one pass of
    a partitioned join, so left and anti rows are emitted once, not once a
    pass.  ``owner_part=(n_parts, p)``; None = no restriction."""
    if owner_part is None:
        return None
    n_parts, p = owner_part
    return key_hash32(probe) % int(n_parts) == int(p)


def key_hash32(k):
    """Order-scrambling hash of int32 keys: ``uint32(k) * 2654435761 mod
    2^32``.  A numpy array or scalar gives uint32 (the host build split);
    a tensor gives int64 holding the same unsigned value (the probe side's
    ownership), so both sides agree on every key's partition.  Torch has
    no uint32 multiply on CUDA, and an int64 product would overflow, so
    the constant is applied in two 16-bit halves."""
    if isinstance(k, np.ndarray) or np.isscalar(k):
        return (np.asarray(k).astype(np.uint32, casting="unsafe")
                * np.uint32(_KNUTH))
    u = k.to(torch.int64) & 0xFFFFFFFF
    lo = u * (_KNUTH & 0xFFFF)
    hi = ((u * (_KNUTH >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


_VALUE_DTS = (np.dtype(np.int32), np.dtype(np.uint32),
              np.dtype(np.float32))


def _value_dtype(build_values) -> np.dtype:
    """Payload dtype: int32/uint32/float32 pass through, anything else
    (Python int lists, int64) lands as int32, as in the JAX package."""
    dt = np.asarray(build_values).dtype
    return dt if dt in _VALUE_DTS else np.dtype(np.int32)


def hash_split_build(build_keys, build_values, n_parts: int):
    """Host-side hash partitioning of the build table: a list of ``(keys,
    vals)`` a partition.  Every key lands in exactly one partition, so
    per-partition join results add up to the broadcast answer."""
    bk = np.asarray(build_keys, np.int32)
    bv = np.asarray(build_values, _value_dtype(build_values))
    part = (key_hash32(bk) % np.uint32(n_parts)).astype(np.int64)
    return [(bk[part == p], bv[part == p]) for p in range(n_parts)]


def sorted_has_duplicates(keys: np.ndarray) -> bool:
    """True when sorted *keys* hold a value twice."""
    return bool(len(keys) > 1 and (keys[1:] == keys[:-1]).any())


def _sorted_build(build_keys, build_values, schema: HeapSchema,
                  probe_col: int):
    """The build side's host preparation: the sort and the unique-key
    check on the sorted keys (equal neighbours; one sort, where
    ``np.unique`` would sort or hash again).  Keys are int32; values keep
    their dtype (int32/uint32/float32)."""
    keys = np.asarray(build_keys)
    order = np.argsort(keys, kind="stable")
    if sorted_has_duplicates(keys[order]):
        raise ValueError("build_keys must be unique (inner join on a "
                         "dimension key)")
    if schema.col_dtype(probe_col) != np.dtype(np.int32):
        raise ValueError("probe column must be int32")
    return (np.asarray(build_keys, np.int32)[order],
            np.asarray(build_values, _value_dtype(build_values))[order])


class _Build:
    """A sorted build side (host arrays), moved to a device once.  uint32
    values travel as int64 holding the unsigned value, the decode's form."""

    def __init__(self, keys: np.ndarray, vals: Optional[np.ndarray]):
        self.keys, self.vals = keys, vals
        self.vdt = None if vals is None else vals.dtype
        self._on = None

    def on(self, device):
        if self._on is None or self._on[0] != device:
            v = self.vals
            if v is not None and v.dtype == np.dtype(np.uint32):
                v = v.astype(np.int64)
            self._on = (device, torch.from_numpy(np.ascontiguousarray(
                self.keys)).to(device),
                None if v is None else torch.from_numpy(
                    np.ascontiguousarray(v)).to(device))
        return self._on[1], self._on[2]


def _probe(keys, vals, probe, sel):
    """(hit mask, per-row payload) for one batch; an empty build table
    joins nothing instead of gathering from zero rows."""
    if keys.shape[0] == 0:
        return torch.zeros_like(sel), torch.zeros(probe.shape,
                                                  dtype=vals.dtype,
                                                  device=probe.device)
    idx = torch.searchsorted(keys, probe.contiguous()) \
        .clamp_(0, keys.shape[0] - 1)
    return sel & (keys[idx] == probe), vals[idx]


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _select(schema, predicate, pages_u8, threshold):
    cols, valid = decode_pages(pages_u8, schema)
    return cols, select_rows(predicate, cols, valid, schema, threshold)


def _join_step(schema, probe_col, build, predicate, how, owner_part,
               cols, valid, threshold):
    """The probe of one batch of decoded columns: ``(probe, hit, pay,
    emit)``."""
    sel = select_rows(predicate, cols, valid, schema, threshold)
    probe = cols[probe_col]
    own = _owner_mask(probe, owner_part)
    if own is not None:
        sel = sel & own
    keys, vals = build.on(valid.device)
    hit, pay = _probe(keys, vals, probe, sel)
    return probe, hit, pay, _emit_mask(how, sel, hit)


def make_join_fn(schema: HeapSchema, probe_col: int,
                 build_keys: np.ndarray, build_values: np.ndarray, *,
                 predicate: Predicate = None, how: str = "inner",
                 owner_part=None):
    """Build ``run(pages_u8, threshold=0) -> dict``, one join step.

    ``build_keys``/``build_values``: the dimension table (unique int32
    keys, sorted here).  A scanned row has a partner when column
    *probe_col* equals a build key (and *predicate* passes); *how* picks
    the rows the join emits (:data:`JOIN_HOWS`).

    Per batch: ``matched`` (emitted rows, int32), ``sums`` (a list over
    EVERY fact column, ``run.sum_cols``, each in its acc dtype), and for
    a schema with a nullable column ``nncounts`` (per column, emitted
    non-NULL rows, as :func:`make_star_fn`'s); inner/left add
    ``payload_sum`` (matched build values, in their acc dtype), left adds
    ``null_count`` (emitted rows without a partner).
    ``owner_part``: see :func:`_owner_mask` (Grace passes only).
    ``run.fold(cols, valid, threshold=0)`` is the same step on decoded
    columns of any shape (the index access path's fetched rows)."""
    check_join_how(how)
    build = _Build(*_sorted_build(build_keys, build_values, schema,
                                  probe_col))
    sum_cols = list(range(schema.n_cols))
    wide = wide_sums(schema)

    def fold(cols, valid: torch.Tensor, threshold=0) -> dict:
        _key, hit, pay, emit = _join_step(
            schema, probe_col, build, predicate, how, owner_part, cols,
            valid, threshold)
        out = {"matched": row_count(emit, wide),
               "sums": [_masked_sum(cols[c], emit, schema.col_dtype(c),
                                    wide)
                        for c in sum_cols]}
        if cols.nulls:
            out["nncounts"] = [row_count(emit & ~cols.nulls[c], wide)
                               if c in cols.nulls else out["matched"]
                               for c in sum_cols]
        if how in ("inner", "left"):
            out["payload_sum"] = _masked_sum(pay, hit, build.vdt, wide)
        if how == "left":
            out["null_count"] = row_count(emit & ~hit, wide)
        return out

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        return fold(*decode_pages(pages_u8, schema), threshold)

    run.fold = fold
    run.sum_cols = sum_cols
    return run


def make_join_rows_fn(schema: HeapSchema, probe_col: int,
                      build_keys: np.ndarray, build_values: np.ndarray, *,
                      predicate: Predicate = None, how: str = "inner",
                      owner_part=None):
    """Row twin of :func:`make_join_fn`: per batch, flat per-row outcomes —
    ``hit`` (the emit mask), ``partner`` (has a build partner; differs
    from ``hit`` only for left), the probed ``key``, the matched build
    ``payload`` (0 where unpartnered; uint32 as int64) and the rows'
    global ``positions`` (int64).  ``run.fold(cols, valid, positions,
    threshold=0)`` is the same step on decoded columns and their
    positions."""
    check_join_how(how)
    build = _Build(*_sorted_build(build_keys, build_values, schema,
                                  probe_col))

    def fold(cols, valid: torch.Tensor, positions: torch.Tensor,
             threshold=0) -> dict:
        probe, hit, pay, emit = _join_step(
            schema, probe_col, build, predicate, how, owner_part, cols,
            valid, threshold)
        return {"hit": emit.reshape(-1),
                "partner": hit.reshape(-1),
                "key": probe.reshape(-1),
                "payload": torch.where(hit, pay, _zero(pay)).reshape(-1),
                "positions": positions.reshape(-1)}

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        return fold(*decode_pages(pages_u8, schema),
                    global_row_positions(pages_u8, schema), threshold)

    run.fold = fold
    return run


# -- star joins: several broadcast dimensions probed in one pass -------------

def _star_builds(joins):
    """``(probe_col, _Build, how)`` per dimension of ``(probe_col,
    sorted keys, sorted values or None, how)``."""
    return [(int(pc), _Build(keys, vals), how)
            for pc, keys, vals, how in joins]


def _star_probe_all(builds, cols, sel):
    """(emit mask, [(hit_i, pay_i)]): inner/semi dimensions restrict the
    emitted rows to partnered ones, anti to unpartnered ones, left never
    restricts (its NULL indicator is the dimension's hit mask)."""
    probes = []
    emit = sel
    for pc, build, how in builds:
        keys, vals = build.on(sel.device)
        # payload-less dimensions (semi/anti) probe with the keys as a
        # stand-in payload, never read
        hit, pay = _probe(keys, keys if vals is None else vals, cols[pc],
                          sel)
        emit = emit & _emit_mask(how, sel, hit)
        probes.append((hit, pay))
    return emit, probes


def make_star_fn(schema: HeapSchema, joins, *, predicate: Predicate = None,
                 expr_fns=(), expr_dtypes=()):
    """Build a star-join aggregate step over *joins*, a list of
    ``(probe_col, build_keys, build_values or None, how)`` dimensions
    (build arrays sorted by :func:`_sorted_build`).

    Per batch: ``count`` (emitted rows), ``sums`` (every fact column, acc
    dtypes), ``nncounts`` (per column, emitted non-NULL rows: ``count``
    for a non-nullable column), ``pay_sums`` (per dimension, the payload
    over emitted rows that hit it; int32 0 for a payload-less one),
    ``null_counts`` (per dimension, emitted rows without a partner
    there), and ``esums`` (masked sums of ``expr_fns[i](cols)``, each in
    the acc dtype of ``expr_dtypes[i]``).  Everything adds across batches."""
    builds = _star_builds(joins)
    sum_cols = list(range(schema.n_cols))
    wide = wide_sums(schema)

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        cols, sel = _select(schema, predicate, pages_u8, threshold)
        emit, probes = _star_probe_all(builds, cols, sel)
        count = row_count(emit, wide)
        out = {"count": count,
               "sums": [_masked_sum(cols[c], emit, schema.col_dtype(c),
                                    wide)
                        for c in sum_cols],
               # NULL cells decode as 0, so the sums skip them already;
               # the AVG denominators must too
               "nncounts": [row_count(emit & ~cols.nulls[c], wide)
                            if c in cols.nulls else count
                            for c in sum_cols]}
        pay_sums, null_counts = [], []
        for (_pc, build, _how), (hit, pay) in zip(builds, probes):
            if build.vals is None:
                pay_sums.append(torch.zeros((), dtype=torch.int32,
                                            device=emit.device))
            else:
                pay_sums.append(_masked_sum(pay, emit & hit, build.vdt,
                                            wide))
            null_counts.append(row_count(emit & ~hit, wide))
        out["pay_sums"] = pay_sums
        out["null_counts"] = null_counts
        if expr_fns:
            out["esums"] = [_masked_sum(f(cols), emit, dt, wide)
                            for f, dt in zip(expr_fns, expr_dtypes)]
        return out

    run.sum_cols = sum_cols
    return run


def make_star_rows_fn(schema: HeapSchema, joins, *,
                      predicate: Predicate = None, fact_cols=()):
    """Row twin of :func:`make_star_fn`: per batch, flat ``hit`` (the emit
    mask), the requested fact columns (``c<c>``), each dimension's matched
    payload (``pay<i>``, 0 where unpartnered) and partner mask (``m<i>``),
    and global ``positions``."""
    builds = _star_builds(joins)
    fact_cols = [int(c) for c in fact_cols]

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        cols, sel = _select(schema, predicate, pages_u8, threshold)
        emit, probes = _star_probe_all(builds, cols, sel)
        out = {"hit": emit.reshape(-1),
               "positions": global_row_positions(
                   pages_u8, schema).reshape(-1)}
        for c in fact_cols:
            out[f"c{c}"] = cols[c].reshape(-1)
        for i, ((_pc, build, _how), (hit, pay)) in \
                enumerate(zip(builds, probes)):
            if build.vals is not None:
                out[f"pay{i}"] = torch.where(hit, pay, _zero(pay)) \
                    .reshape(-1)
            out[f"m{i}"] = hit.reshape(-1)
        return out

    return run
