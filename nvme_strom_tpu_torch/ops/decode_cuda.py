"""CUDA kernel for the fused decode → filter → aggregate over packed pages.

Replaces the Pallas TPU kernel ``nvme_strom_tpu/ops/decode_pallas.py``
(``make_decode_filter_fn_pallas``, kernel ``_make_kernel``) with
``csrc/decode.cu``, hand-written for sm_90a and bound with ``ctypes``.

Bound: bytes.  The kernel reads, once, each packed page's header and the
regions of the columns it decodes (the rest of a page is padding) and
spends a few integer ops per row and column, so its least time is those
bytes over device-memory bandwidth.  Its design (see the
source) expands rows in registers only, one row per thread per step with
coalesced loads of the planar regions, and touches device memory for
nothing else but one atomic per block and output.

The codec geometry is static per file (:class:`~..scan.colpack.PackedMeta`)
and goes to the kernel as a spec struct, with the predicate's
:class:`~.filter.FilterPred` terms.  A CUDA tensor launches the kernel or
raises (EINVAL for a callable predicate or a layout the kernel does not
take, EIO for a launch error); a CPU tensor goes through the plain version
(:mod:`.decode`).  ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import errno as _errno
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import _build
from ..api import StromError
from ..scan.colpack import PackedMeta
from ..scan.heap import PAGE_SIZE
from .decode import make_decode_filter_fn
from .filter import FilterPred
from .filter_cuda import _KIND, MAX_COLS, _Terms, encode_terms

__all__ = ["launches", "launch", "decode_filter_pages_cuda",
           "kernel_refusal"]

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

_CODEC = {"raw": 1, "bitpack": 2, "dict": 3, "rle": 4}
_BLOCKS_PER_SM = 8


class _Spec(ctypes.Structure):
    """Field-for-field mirror of ``DecodeSpec`` in csrc/decode.cu."""

    _fields_ = [("n_cols", ctypes.c_int), ("rpb", ctypes.c_int)] + [
        (name, ctypes.c_int * MAX_COLS)
        for name in ("codec", "off", "nwords", "bits", "dsize", "rmax",
                     "col_kind", "col_slot")] + [("terms", _Terms)]


_launch = _build.launcher("decode", "strom_decode_filter_pages", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def kernel_refusal(meta: PackedMeta, predicate) -> str:
    """Why the kernel cannot run *predicate* over *meta* ('' = it can)."""
    if predicate is not None and not isinstance(predicate, FilterPred):
        return "the CUDA kernel takes a FilterPred, not a callable"
    if len(meta.cols) > MAX_COLS:
        return f"{len(meta.cols)} columns; the kernel takes {MAX_COLS}"
    for c, dt in enumerate(meta.dtypes):
        if np.dtype(dt) not in _KIND:
            return f"column {c} is {dt}; the kernel takes " \
                   f"int32/uint32/float32"
        if meta.cols[c].codec not in _CODEC:
            return f"column {c} has codec {meta.cols[c].codec!r}"
    return ""


def _slots(meta: PackedMeta):
    kinds, slots, ni, nf = [], [], 0, 0
    for dt in meta.dtypes:
        if np.dtype(dt).kind == "f":
            kinds.append("f")
            slots.append(nf)
            nf += 1
        else:
            kinds.append("i")
            slots.append(ni)
            ni += 1
    return kinds, slots, ni, nf


def _spec(meta: PackedMeta, pred: FilterPred, need, threshold) -> _Spec:
    spec = _Spec()
    spec.n_cols = len(meta.cols)
    spec.rpb = meta.rows_per_block
    _, slots, _, _ = _slots(meta)
    for c, cm in enumerate(meta.cols):
        spec.codec[c] = 0 if need is not None and c not in need \
            else _CODEC[cm.codec]
        spec.off[c] = cm.off
        spec.nwords[c] = cm.nwords
        spec.bits[c] = cm.bits
        spec.dsize[c] = cm.dsize
        spec.rmax[c] = cm.rmax
        spec.col_kind[c] = _KIND[np.dtype(meta.dtypes[c])]
        spec.col_slot[c] = slots[c]
    spec.terms = encode_terms(pred, [np.dtype(d) for d in meta.dtypes],
                              threshold)
    return spec


def launch(pages_u8: torch.Tensor, spec: _Spec, count: torch.Tensor,
           isums: torch.Tensor, fsums: torch.Tensor) -> None:
    """Launch the kernel on the current stream over validated CUDA inputs
    (outputs zeroed by the caller); the one place ``launches`` moves."""
    global launches
    n_pages = pages_u8.shape[0]
    dev = pages_u8.device
    _launch(pages_u8.data_ptr(), n_pages, ctypes.addressof(spec),
            count.data_ptr(), isums.data_ptr(), fsums.data_ptr(),
            min(n_pages, _build.grid_cap(dev.index or 0, _BLOCKS_PER_SM)),
            torch.cuda.current_stream(dev).cuda_stream)
    launches += 1


def decode_filter_pages_cuda(pages_u8: torch.Tensor, threshold,
                             meta: PackedMeta,
                             predicate: Union[FilterPred, Callable, None]
                             = None, *,
                             need_cols: Optional[Sequence[int]] = None
                             ) -> dict:
    """``{"count", "sums"}`` over a (B, 8192) uint8 batch of packed
    pages: the kernel for a CUDA tensor, the plain version for a CPU
    tensor.  ``sums[c]`` is column c's masked sum (zero outside
    ``need_cols``)."""
    if pages_u8.device.type == "cpu":
        return make_decode_filter_fn(meta, predicate, need_cols=need_cols)(
            pages_u8, threshold)
    why = kernel_refusal(meta, predicate)
    if why:
        raise StromError(_errno.EINVAL, why)
    if pages_u8.device.type != "cuda":
        raise StromError(_errno.EINVAL, f"pages on {pages_u8.device}: the "
                                        f"decode runs on cuda or cpu")
    if (pages_u8.dtype != torch.uint8 or pages_u8.dim() != 2
            or pages_u8.shape[1] != PAGE_SIZE):
        raise StromError(_errno.EINVAL, f"pages must be (B, {PAGE_SIZE}) "
                                        f"uint8, got {tuple(pages_u8.shape)} "
                                        f"{pages_u8.dtype}")
    if not pages_u8.is_contiguous() or pages_u8.data_ptr() % 4:
        raise StromError(_errno.EINVAL, "pages must be contiguous and "
                                        "4-byte aligned (int32 word view)")
    kinds, slots, ni, nf = _slots(meta)
    ni, nf = max(ni, 1), max(nf, 1)
    out = torch.zeros(1 + ni + nf, dtype=torch.int32, device=pages_u8.device)
    count, isums = out[:1], out[1:1 + ni]
    fsums = out[1 + ni:].view(torch.float32)
    if pages_u8.shape[0]:
        need = tuple(need_cols) if need_cols is not None else None
        launch(pages_u8, _spec(meta, predicate or FilterPred(), need,
                               threshold), count, isums, fsums)
    sums = []
    for c, dt in enumerate(meta.dtypes):
        if kinds[c] == "f":
            sums.append(fsums[slots[c]])
        elif np.dtype(dt) == np.dtype(np.uint32):
            sums.append(isums[slots[c]].view(torch.uint32))
        else:
            sums.append(isums[slots[c]])
    return {"count": count[0], "sums": sums}
