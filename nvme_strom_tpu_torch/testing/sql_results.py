"""Comparison of SQL facade results: the port's against another answer.

A result is ``sql_query``'s dict (labels to scalars or arrays, strings as
object arrays, None for NULL).  Integers, positions, booleans, strings and
None compare exactly (by value, whatever the integer dtype); floats within
``1e-4 * scale + 1e-6``, *scale* a bound of ``sum(|x|)`` over the rows a
float aggregate reads (default: the larger magnitude of the two values,
at least 1), NaN equal to NaN, an infinity equal only to the same
infinity (never to the other sign's, nor to a finite value, whatever the
scale).  ``_analyze`` and ``_workers`` are
telemetry: either side may carry them, and their values do not compare.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["assert_same_result"]

_TELEMETRY = ("_analyze", "_workers")


def _close(a: float, b: float, scale: Optional[float]) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if math.isinf(a) or math.isinf(b):
        return a == b
    s = max(abs(a), abs(b), 1.0) if scale is None else scale
    return abs(a - b) <= 1e-4 * s + 1e-6


def _same_scalar(g, w, scale) -> bool:
    if g is None or w is None:
        return g is None and w is None
    if isinstance(g, str) or isinstance(w, str):
        return isinstance(g, str) and isinstance(w, str) and g == w
    if isinstance(g, (float, np.floating)) or isinstance(w, (float,
                                                            np.floating)):
        return _close(float(g), float(w), scale)
    return int(g) == int(w)


def _same(g, w, scale) -> bool:
    if g is None or w is None or np.isscalar(g) or np.isscalar(w):
        return _same_scalar(g, w, scale)
    ga, wa = np.asarray(g), np.asarray(w)
    if ga.shape != wa.shape:
        return False
    if ga.dtype.kind == "O" or wa.dtype.kind == "O":
        return all(_same_scalar(x, y, scale)
                   for x, y in zip(ga.reshape(-1).tolist(),
                                   wa.reshape(-1).tolist()))
    if "f" in (ga.dtype.kind, wa.dtype.kind):
        return all(_close(float(x), float(y), scale)
                   for x, y in zip(ga.reshape(-1), wa.reshape(-1)))
    if ga.dtype.kind in "US" or wa.dtype.kind in "US":
        return ga.astype(str).tolist() == wa.astype(str).tolist()
    return np.array_equal(ga.astype(np.int64), wa.astype(np.int64))


def assert_same_result(got: dict, want: dict, *,
                       scale: Optional[float] = None, what: str = "") -> None:
    """AssertionError naming the first label where *got* differs from
    *want* (see the module docstring for the tolerances)."""
    keys = set(want) - set(_TELEMETRY)
    assert set(got) - set(_TELEMETRY) == keys, (what, sorted(got),
                                                sorted(want))
    for k in keys:
        assert _same(got[k], want[k], scale), (what, k, got[k], want[k])
