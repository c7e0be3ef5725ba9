"""Key packing of the JAX package's ``scan/index.py``, reduced.

Only the composite-key packing that value-keyed GROUP BY uses
(:meth:`.query.Query.group_by_cols`): a pair of 4-byte integer columns
packed into one uint64 that orders like the ``(a0, a1)`` tuple.  The
sorted index sidecars themselves (``build_index``, ``open_index``, the
index access paths) are not ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_pair", "unpack_first", "unpack_second"]


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
