"""CUDA kernel for GROUP BY over heap pages.

Replaces the Pallas TPU kernel ``nvme_strom_tpu/ops/groupby_pallas.py``
(``make_groupby_fn_pallas``, the ``make_kernel`` closure) with
``csrc/groupby.cu``, hand-written for sm_90a and bound with ``ctypes``.

Bound: bytes.  The kernel reads, once, each page's header sector and the
column regions the query touches (visibility, key, predicate and
aggregated columns); per tuple it does a few integer ops and shared-memory
atomics, so its least time is those bytes over device-memory bandwidth
(for the 290-tuple page of a six-column table and four of its seven
regions, 2048 pages are 9.6 MB: 2.9 us at 3.35 TB/s on an H100 SXM).
Its design (see the source) keeps the per-group
accumulators of a block in shared memory and touches device memory only
for coalesced column loads and one atomic per touched group and output.

The key is a :class:`~.groupby.GroupKey` and the predicate a
:class:`~.filter.FilterPred`: CUDA cannot take the callables Pallas traces
into its body.  Group counts up to :data:`MAX_GROUPS` (512, above the
TPU kernel's 64) fit one block's shared memory for up to 16 aggregated
columns; a larger G raises EINVAL, it never runs the plain version.

The wrapper follows the tensor: a CPU tensor goes through the plain
version (:mod:`.groupby`); a CUDA tensor launches the kernel or raises
(:class:`~..api.StromError` EINVAL for a callable, a schema or a G the
kernel does not take, EIO for a launch error).  ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import errno as _errno
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import _build
from ..api import StromError
from ..scan.heap import PAGE_SIZE, HeapSchema
from .filter import FilterPred
from .filter_cuda import _KIND, MAX_COLS, _Terms, encode_terms, \
    kernel_refusal as filter_refusal
from .groupby import GroupKey, _check_agg_cols, ieee_sums, make_groupby_fn

__all__ = ["launches", "launch", "MAX_GROUPS", "groupby_pages_cuda",
           "kernel_refusal"]

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: largest G the kernel takes (MAX_GROUPS in csrc/groupby.cu)
MAX_GROUPS = 512
_BLOCKS_PER_SM = 4
_INT_MIN, _INT_MAX = -(1 << 31), (1 << 31) - 1
# order-preserving int32 images of +inf / -inf (csrc/groupby.cu)
_F_MIN_INIT = int(np.float32(np.inf).view(np.int32))
_F_MAX_INIT = int(np.float32(-np.inf).view(np.int32)) ^ 0x7FFFFFFF


class _Spec(ctypes.Structure):
    """Field-for-field mirror of ``GroupSpec`` in csrc/groupby.cu."""

    _fields_ = [("n_cols", ctypes.c_int), ("tuples", ctypes.c_int),
                ("vis_off", ctypes.c_int),
                ("col_off", ctypes.c_int * MAX_COLS),
                ("col_kind", ctypes.c_int * MAX_COLS),
                ("terms", _Terms),
                ("key_col", ctypes.c_int), ("key_abs", ctypes.c_int),
                ("key_mod", ctypes.c_uint), ("n_groups", ctypes.c_int),
                ("n_agg", ctypes.c_int), ("agg_kind", ctypes.c_int),
                ("agg_col", ctypes.c_int * MAX_COLS)]


_launch = _build.launcher("groupby", "strom_groupby_pages", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p])


def kernel_refusal(schema: HeapSchema, key, n_groups: int,
                   predicate=None) -> str:
    """Why the kernel cannot run this GROUP BY ('' = it can)."""
    if not isinstance(key, GroupKey):
        return "the CUDA kernel takes a GroupKey, not a callable"
    if predicate is not None and not isinstance(predicate, FilterPred):
        return "the CUDA kernel takes a FilterPred, not a callable"
    why = filter_refusal(schema, predicate or FilterPred())
    if why:
        return why
    if not 1 <= int(n_groups) <= MAX_GROUPS:
        return f"G={n_groups}: the kernel takes 1..{MAX_GROUPS} groups"
    return ""


def _spec(schema: HeapSchema, key: GroupKey, n_groups: int, cols_idx,
          agg_dt: np.dtype, pred: FilterPred, threshold) -> _Spec:
    spec = _Spec()
    spec.n_cols = schema.n_cols
    spec.tuples = schema.tuples_per_page
    spec.vis_off = schema.col_word_range(schema.n_cols)[0] \
        if schema.visibility else -1
    for c in range(schema.n_cols):
        spec.col_off[c] = schema.col_word_range(c)[0]
        spec.col_kind[c] = _KIND[schema.col_dtype(c)]
    spec.terms = encode_terms(pred, schema, threshold)
    spec.key_col = key.col
    spec.key_abs = int(bool(key.absolute))
    spec.key_mod = int(key.mod or 0)
    spec.n_groups = int(n_groups)
    spec.n_agg = len(cols_idx)
    spec.agg_kind = _KIND[agg_dt]
    for i, c in enumerate(cols_idx):
        spec.agg_col[i] = c
    return spec


def _inits(agg_dt: np.dtype):
    """(min_init, max_init): the sentinels' int32 order images."""
    if agg_dt.kind == "f":
        return _F_MIN_INIT, _F_MAX_INIT
    return _INT_MAX, _INT_MIN       # int32 as is; uint32 sign-flipped


def new_outputs(n_groups: int, n_agg: int, agg_dt: np.dtype, device):
    """One int32 buffer [count G | sums VG | sumsq VG | mins VG | maxs VG
    | nonf 3VG], initialised as the kernel expects."""
    G, VG = n_groups, n_agg * n_groups
    buf = torch.zeros(G + 7 * VG, dtype=torch.int32, device=device)
    mn, mx = _inits(agg_dt)
    buf[G + 2 * VG:G + 3 * VG].fill_(mn)
    buf[G + 3 * VG:G + 4 * VG].fill_(mx)
    return buf


def launch(pages_u8: torch.Tensor, spec: _Spec, agg_dt: np.dtype,
           buf: torch.Tensor) -> None:
    """Launch the kernel on the current stream over validated CUDA inputs
    into *buf* (:func:`new_outputs`); the one place ``launches`` moves."""
    global launches
    n_pages = pages_u8.shape[0]
    dev = pages_u8.device
    G, VG = spec.n_groups, spec.n_agg * spec.n_groups
    ptr = buf.data_ptr()
    mn, mx = _inits(agg_dt)
    _launch(pages_u8.data_ptr(), n_pages, ctypes.addressof(spec), mn, mx,
            ptr, ptr + 4 * G, ptr + 4 * (G + VG), ptr + 4 * (G + 2 * VG),
            ptr + 4 * (G + 3 * VG), ptr + 4 * (G + 4 * VG),
            min(n_pages, _build.grid_cap(dev.index or 0, _BLOCKS_PER_SM)),
            torch.cuda.current_stream(dev).cuda_stream)
    launches += 1


def unpack_outputs(buf: torch.Tensor, n_groups: int, n_agg: int,
                   agg_dt: np.dtype) -> dict:
    """The module's result dict from the kernel's output buffer."""
    G, V = n_groups, n_agg
    VG = V * G
    part = [buf[G + i * VG:G + (i + 1) * VG].view(V, G) for i in range(7)]
    sums, sq, mins, maxs = part[0], part[1].view(torch.float32), \
        part[2], part[3]
    if agg_dt.kind == "f":
        n_nan, n_pinf, n_ninf = part[4], part[5], part[6]
        sums, sq = ieee_sums(sums.view(torch.float32), sq, n_nan, n_pinf,
                             n_ninf)
        mins, maxs = (torch.where(k >= 0, k, k ^ 0x7FFFFFFF)
                      .view(torch.float32) for k in (mins, maxs))
        nan = torch.tensor(float("nan"), device=buf.device)
        mins = torch.where(n_nan > 0, nan, mins)
        maxs = torch.where(n_nan > 0, nan, maxs)
    elif agg_dt.kind == "u":
        sums = sums.view(torch.uint32)
        mins, maxs = ((k ^ _INT_MIN).view(torch.uint32) for k in (mins, maxs))
    return {"count": buf[:G], "sums": sums, "sumsqs": sq, "mins": mins,
            "maxs": maxs}


def groupby_pages_cuda(pages_u8: torch.Tensor, threshold,
                       schema: HeapSchema, key: Union[GroupKey, Callable],
                       n_groups: int, *,
                       agg_cols: Optional[Sequence[int]] = None,
                       predicate: Union[FilterPred, Callable, None] = None
                       ) -> dict:
    """The grouped aggregate of a (B, 8192) uint8 page batch: the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if pages_u8.device.type == "cpu":
        return make_groupby_fn(schema, key, n_groups, agg_cols=agg_cols,
                               predicate=predicate)(pages_u8, threshold)
    why = kernel_refusal(schema, key, n_groups, predicate)
    if why:
        raise StromError(_errno.EINVAL, why)
    key.check(schema)
    cols_idx, agg_dt = _check_agg_cols(schema, agg_cols)
    if pages_u8.device.type != "cuda":
        raise StromError(_errno.EINVAL, f"pages on {pages_u8.device}: the "
                                        f"groupby runs on cuda or cpu")
    if (pages_u8.dtype != torch.uint8 or pages_u8.dim() != 2
            or pages_u8.shape[1] != PAGE_SIZE):
        raise StromError(_errno.EINVAL, f"pages must be (B, {PAGE_SIZE}) "
                                        f"uint8, got {tuple(pages_u8.shape)} "
                                        f"{pages_u8.dtype}")
    if not pages_u8.is_contiguous() or pages_u8.data_ptr() % 4:
        raise StromError(_errno.EINVAL, "pages must be contiguous and "
                                        "4-byte aligned (int32 word view)")
    G, V = int(n_groups), len(cols_idx)
    buf = new_outputs(G, V, agg_dt, pages_u8.device)
    if pages_u8.shape[0]:
        launch(pages_u8, _spec(schema, key, G, cols_idx, agg_dt,
                               predicate or FilterPred(), threshold),
               agg_dt, buf)
    return unpack_outputs(buf, G, V, agg_dt)
