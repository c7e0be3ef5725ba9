"""CUDA kernel for the fused heap-page filter scan.

Replaces the Pallas TPU kernel ``nvme_strom_tpu/ops/filter_pallas.py``
(``_make_kernel`` via ``_run_filter``, faces ``scan_filter_step_pallas``
and ``make_filter_fn_pallas``) with ``csrc/filter.cu``, hand-written for
sm_90a and bound with ``ctypes``.

Bound: bytes.  The kernel reads each page once and does a few compares and
adds per tuple, so its least time is the batch's bytes over device-memory
bandwidth (16 MiB over 3.35 TB/s is 5.0 us on an H100 SXM).  Its design
(see the source) keeps every tuple's work in registers and touches device
memory only for coalesced column loads and one atomic per block and
output.

A CUDA kernel cannot take a Python callable the way Pallas traces one
into its body (``filter_pallas.py:104``), so the predicate is a
:class:`~.filter.FilterPred` descriptor.  The kernel takes 4-byte,
non-nullable columns (int32/uint32/float32), as the TPU kernel does.

The wrapper follows the tensor: a CPU tensor goes through the plain
version (:mod:`.filter`); a CUDA tensor launches the kernel or raises
(:class:`~..api.StromError` EINVAL for a callable predicate or a schema the
kernel does not take, EIO for a launch error).  ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import errno as _errno
from typing import Callable, Union

import numpy as np
import torch

from .. import _build
from ..api import StromError
from ..scan.heap import PAGE_SIZE, HeapSchema
from .filter import (DEFAULT_SCHEMA, MAX_TERMS, STEP_PRED, FilterPred,
                     make_filter_fn)

__all__ = ["launches", "launch", "scan_filter_step_cuda",
           "make_filter_fn_cuda", "filter_pages_cuda", "kernel_refusal",
           "encode_terms"]

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

MAX_COLS = 16
_KIND = {np.dtype(np.int32): 0, np.dtype(np.uint32): 1,
         np.dtype(np.float32): 2}
_OP = {"gt": 0, "ge": 1, "lt": 2, "le": 3, "eq": 4, "ne": 5}
_TERM_KIND = {"i": 0, "u": 1, "f": 2}
_BLOCKS_PER_SM = 8


class _Terms(ctypes.Structure):
    """Field-for-field mirror of ``Terms`` in csrc/strom_common.cuh."""

    _fields_ = [("n", ctypes.c_int),
                ("col", ctypes.c_int * MAX_TERMS),
                ("op", ctypes.c_int * MAX_TERMS),
                ("kind", ctypes.c_int * MAX_TERMS),
                ("val", ctypes.c_uint * MAX_TERMS)]


class _Spec(ctypes.Structure):
    """Field-for-field mirror of ``FilterSpec`` in csrc/filter.cu."""

    _fields_ = [("n_cols", ctypes.c_int), ("tuples", ctypes.c_int),
                ("vis_off", ctypes.c_int),
                ("col_off", ctypes.c_int * MAX_COLS),
                ("col_kind", ctypes.c_int * MAX_COLS),
                ("col_slot", ctypes.c_int * MAX_COLS),
                ("terms", _Terms)]


def encode_terms(pred: FilterPred, dtypes, threshold) -> _Terms:
    """The predicate's terms as the kernels take them: per term the
    column, op, compare kind and value bits (jnp promotion, see
    :func:`.filter.term_value`)."""
    terms = _Terms()
    terms.n = len(pred.terms)
    for k, ((col, op, _), (kind, v)) in enumerate(
            zip(pred.terms, pred.values(dtypes, threshold))):
        terms.col[k] = col
        terms.op[k] = _OP[op]
        terms.kind[k] = _TERM_KIND[kind]
        terms.val[k] = int(np.asarray(v).view(np.uint32))
    return terms


_launch = _build.launcher("filter", "strom_filter_pages", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def kernel_refusal(schema: HeapSchema, predicate) -> str:
    """Why the kernel cannot run *predicate* over *schema* ('' = it can)."""
    if not isinstance(predicate, FilterPred):
        return "the CUDA kernel takes a FilterPred, not a callable"
    if schema.n_cols > MAX_COLS:
        return f"{schema.n_cols} columns; the kernel takes {MAX_COLS}"
    for c in range(schema.n_cols):
        if schema.col_dtype(c) not in _KIND:
            return f"column {c} is {schema.col_dtype(c)}; the kernel takes " \
                   f"int32/uint32/float32"
        if schema.col_nullable(c):
            return f"column {c} is nullable; the kernel takes none"
    return ""


def _slots(schema: HeapSchema):
    kinds, slots, ni, nf = [], [], 0, 0
    for c in range(schema.n_cols):
        if schema.col_dtype(c).kind == "f":
            kinds.append("f")
            slots.append(nf)
            nf += 1
        else:
            kinds.append("i")
            slots.append(ni)
            ni += 1
    return kinds, slots, ni, nf


def _spec(schema: HeapSchema, pred: FilterPred, threshold) -> _Spec:
    spec = _Spec()
    spec.n_cols = schema.n_cols
    spec.tuples = schema.tuples_per_page
    spec.vis_off = schema.col_word_range(schema.n_cols)[0] \
        if schema.visibility else -1
    _, slots, _, _ = _slots(schema)
    for c in range(schema.n_cols):
        spec.col_off[c] = schema.col_word_range(c)[0]
        spec.col_kind[c] = _KIND[schema.col_dtype(c)]
        spec.col_slot[c] = slots[c]
    spec.terms = encode_terms(pred, schema, threshold)
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


def filter_pages_cuda(pages_u8: torch.Tensor, threshold, schema: HeapSchema,
                      predicate: Union[FilterPred, Callable]) -> dict:
    """``{"count", "sums"}`` over a (B, 8192) uint8 page batch: the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if pages_u8.device.type == "cpu":
        return make_filter_fn(schema, predicate)(pages_u8, threshold)
    if pages_u8.device.type != "cuda":
        raise StromError(_errno.EINVAL, f"pages on {pages_u8.device}: the "
                                        f"filter runs on cuda or cpu")
    why = kernel_refusal(schema, predicate)
    if why:
        raise StromError(_errno.EINVAL, why)
    if (pages_u8.dtype != torch.uint8 or pages_u8.dim() != 2
            or pages_u8.shape[1] != PAGE_SIZE):
        raise StromError(_errno.EINVAL, f"pages must be (B, {PAGE_SIZE}) "
                                        f"uint8, got {tuple(pages_u8.shape)} "
                                        f"{pages_u8.dtype}")
    if not pages_u8.is_contiguous() or pages_u8.data_ptr() % 4:
        raise StromError(_errno.EINVAL, "pages must be contiguous and "
                                        "4-byte aligned (int32 word view)")
    kinds, slots, ni, nf = _slots(schema)
    # one zeroed output buffer: [count | isums | fsums] (zero bits are
    # 0.0f, so the float tail needs no separate fill)
    ni, nf = max(ni, 1), max(nf, 1)
    out = torch.zeros(1 + ni + nf, dtype=torch.int32, device=pages_u8.device)
    count, isums = out[:1], out[1:1 + ni]
    fsums = out[1 + ni:].view(torch.float32)
    if pages_u8.shape[0]:
        launch(pages_u8, _spec(schema, predicate, threshold), count, isums,
               fsums)
    sums = []
    for c in range(schema.n_cols):
        if kinds[c] == "f":
            sums.append(fsums[slots[c]])
        elif schema.col_dtype(c) == np.dtype(np.uint32):
            sums.append(isums[slots[c]].view(torch.uint32))
        else:
            sums.append(isums[slots[c]])
    return {"count": count[0], "sums": sums}


def make_filter_fn_cuda(schema: HeapSchema,
                        predicate: Union[FilterPred, Callable]) -> Callable:
    """CUDA face of :func:`.filter.make_filter_fn`: ``run(pages_u8,
    threshold=0) -> {"count", "sums"}``."""
    if not isinstance(predicate, FilterPred) and not callable(predicate):
        raise StromError(_errno.EINVAL, "predicate must be a FilterPred "
                                        "or a callable")

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        return filter_pages_cuda(pages_u8, threshold, schema, predicate)

    return run


def scan_filter_step_cuda(pages_u8: torch.Tensor, threshold) -> dict:
    """CUDA face of :func:`.filter.scan_filter_step`: ``col0 > threshold``
    over the default schema; returns the count and the sum of col1."""
    out = filter_pages_cuda(pages_u8, threshold, DEFAULT_SCHEMA, STEP_PRED)
    return {"count": out["count"], "sum": out["sums"][1]}
