"""numpy dtype strings <-> torch dtypes for the data tier.

Record metas and checkpoint headers store numpy's ``dtype.str`` (``<f4``,
``|u1`` …), as the JAX package writes them.  bfloat16 and the float8
types have no numpy dtype: the JAX package cannot save them either (its
``dtype.str`` would be an ambiguous ``<V2``), so they are refused with
EINVAL.
"""

from __future__ import annotations

import errno as _errno

import numpy as np
import torch

from ..api import StromError

__all__ = ["torch_dtype", "numpy_dtype"]

_PAIRS = (
    (np.float16, torch.float16), (np.float32, torch.float32),
    (np.float64, torch.float64), (np.complex64, torch.complex64),
    (np.complex128, torch.complex128), (np.int8, torch.int8),
    (np.int16, torch.int16), (np.int32, torch.int32),
    (np.int64, torch.int64), (np.uint8, torch.uint8),
    (np.uint16, torch.uint16), (np.uint32, torch.uint32),
    (np.uint64, torch.uint64), (np.bool_, torch.bool),
)
_TO_TORCH = {np.dtype(n).str: t for n, t in _PAIRS}
_TO_NUMPY = {t: np.dtype(n) for n, t in _PAIRS}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or its ``.str``)."""
    d = np.dtype(dtype)
    try:
        return _TO_TORCH[d.str]
    except KeyError:
        raise StromError(_errno.EINVAL, f"dtype {d.str} has no torch "
                                        f"counterpart") from None


def numpy_dtype(dtype: torch.dtype, what: str = "tensor") -> np.dtype:
    """The numpy dtype of a torch dtype; EINVAL naming *what* for the
    dtypes numpy lacks (bfloat16, float8)."""
    try:
        return _TO_NUMPY[dtype]
    except KeyError:
        raise StromError(_errno.EINVAL, f"{what}: dtype {dtype} has no "
                                        f"numpy counterpart, so no header "
                                        f"dtype string (the JAX package "
                                        f"cannot save it either)") from None
