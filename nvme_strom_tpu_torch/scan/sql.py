"""The expression grammar of the SQL facade, in torch.

A reduced port of the JAX package's ``scan/sql.py``: only the arithmetic
expressions that ``Query.aggregate_exprs`` and ``Query.star_join(exprs=)``
take.  The SQL parser and ``sql_query`` are not ported yet.

Trees are picklable tuples — ``("col", c) | ("lit", v) | ("neg", e) |
("bin", op, l, r)`` with ``op`` one of ``+ - * /``.  Over 4-byte columns
the semantics are the JAX package's, bit for bit: int arithmetic runs at
int32 (it wraps at the storage width), float math at float32, a float32
operand or ``/`` casts both sides to float32, and integer / integer is
refused.  uint32 columns take no arithmetic (they may stand alone), and a
literal is an int32 or a float32.

An int64 or float64 operand makes the whole node 64-bit: int64 when every
operand is an integer, float64 when one is a float or the operator is
``/``.  The JAX package types such a node by its 4-byte rule alone, so it
sums ``SUM(c * 3)`` over a float64 column as an int32; the port sums
8-byte columns in 64 bits as its aggregates do.
"""

from __future__ import annotations

import errno as _errno
from typing import Tuple

import numpy as np
import torch

from ..api import StromError

__all__ = ["_EXPR_DTS", "_Str", "_expr_info", "_eval_expr", "_expr_str"]

_EXPR_DTS = (np.dtype(np.int32), np.dtype(np.float32))
_U32 = np.dtype(np.uint32)
_I64, _F64 = np.dtype(np.int64), np.dtype(np.float64)
_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
          _I64: torch.int64, _F64: torch.float64}
_NUMPY = {t: d for d, t in _TORCH.items()}


class _Str(str):
    """Marker for a parsed SQL string literal ('...'); it never takes part
    in arithmetic."""


def _bin_dtype(ld: np.dtype, rd: np.dtype, op: str) -> np.dtype:
    """The type a binary node computes in (both operands cast to it)."""
    if 8 in (ld.itemsize, rd.itemsize):
        return _F64 if op == "/" or "f" in (ld.kind, rd.kind) else _I64
    if op == "/" or np.dtype(np.float32) in (ld, rd):
        return np.dtype(np.float32)
    return np.dtype(np.int32)


def _expr_info(e, schema) -> Tuple[np.dtype, set]:
    """(result dtype, referenced columns) of an expression tree, raising
    EINVAL for shapes outside the subset: strings in arithmetic, uint32
    operands, negated uint32, integer / integer, literals outside int32,
    columns outside the schema."""
    k = e[0]
    if k == "col":
        c = int(e[1])
        if not 0 <= c < schema.n_cols:
            raise StromError(_errno.EINVAL, f"SQL: column c{c} out of range "
                                            f"(table has {schema.n_cols})")
        dt = schema.col_dtype(c)
        if dt.kind not in "iuf":
            raise StromError(_errno.EINVAL, f"SQL: c{c} ({dt}) in an "
                                            f"expression")
        return dt, {c}
    if k == "lit":
        v = e[1]
        if isinstance(v, _Str):
            raise StromError(_errno.EINVAL, "SQL: string literals cannot "
                                            "appear in arithmetic")
        if isinstance(v, int):
            if not -(1 << 31) <= v < (1 << 31):
                raise StromError(_errno.EINVAL, f"SQL: integer literal {v} "
                                                f"outside int32 in an "
                                                f"expression")
            return np.dtype(np.int32), set()
        return np.dtype(np.float32), set()
    if k == "neg":
        dt, cs = _expr_info(e[1], schema)
        if dt == _U32:
            raise StromError(_errno.EINVAL, "SQL: negating a uint32 column "
                                            "is outside this subset")
        return dt, cs
    _k, op, l, r = e
    ld, lc = _expr_info(l, schema)
    rd, rc = _expr_info(r, schema)
    if _U32 in (ld, rd):
        raise StromError(_errno.EINVAL, "SQL: uint32 columns in arithmetic "
                                        "are outside this subset (no SQL "
                                        "unsigned type to map the "
                                        "wraparound onto)")
    if op == "/" and ld.kind != "f" and rd.kind != "f":
        raise StromError(_errno.EINVAL, "SQL: integer / integer is outside "
                                        "this subset (PostgreSQL truncates; "
                                        "use a float operand for float "
                                        "division)")
    return _bin_dtype(ld, rd, op), lc | rc


def _eval(e, cols, device) -> Tuple[torch.Tensor, np.dtype]:
    k = e[0]
    if k == "col":
        # a uint32 column (int64 here) only ever stands alone
        a = cols[int(e[1])]
        return a, _NUMPY[a.dtype]
    if k == "lit":
        v = e[1]
        dt = np.dtype(np.float32) if isinstance(v, float) \
            else np.dtype(np.int32)
        return torch.tensor(v, dtype=_TORCH[dt], device=device), dt
    if k == "neg":
        a, dt = _eval(e[1], cols, device)
        return -a, dt
    _k, op, l, r = e
    (a, ld), (b, rd) = _eval(l, cols, device), _eval(r, cols, device)
    dt = _bin_dtype(ld, rd, op)
    # explicit casts, as the JAX package's: a Python scalar would take
    # the tensor's dtype, and torch's own promotion differs from jnp's
    a, b = a.to(_TORCH[dt]), b.to(_TORCH[dt])
    if op == "+":
        return a + b, dt
    if op == "-":
        return a - b, dt
    if op == "*":
        return a * b, dt
    return a / b, dt


def _eval_expr(e, cols) -> torch.Tensor:
    """Torch evaluation of an expression tree over decoded columns, in
    the dtype :func:`_expr_info` names (a lone uint32 column comes back as
    its decode: int64 holding the unsigned value)."""
    return _eval(e, cols, cols[0].device)[0]


def _expr_str(e) -> str:
    k = e[0]
    if k == "col":
        return f"c{e[1]}"
    if k == "lit":
        return str(e[1])
    if k == "neg":
        return f"-{_expr_str(e[1])}"
    _k, op, l, r = e
    return f"({_expr_str(l)} {op} {_expr_str(r)})"
