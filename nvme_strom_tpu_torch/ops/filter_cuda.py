"""CUDA kernel for the fused heap-page filter scan.

Replaces the Pallas TPU kernel ``nvme_strom_tpu/ops/filter_pallas.py``
(``_make_kernel`` via ``_run_filter``, faces ``scan_filter_step_pallas``
and ``make_filter_fn_pallas``) with ``csrc/filter.cu``, hand-written for
sm_90a and bound with ``ctypes``.

Bound: bytes.  The kernel reads each page once and does a few compares and
adds per tuple, so its least time is the batch's bytes over device-memory
bandwidth (16 MiB over 3.35 TB/s is 5.0 us on an H100 SXM).  Its design
(see the source): persistent CTAs (:func:`filter_grid`, from the kernel's
occupancy), whole pages brought into shared memory by TMA bulk copies,
accumulators in registers sized by a template on the column count
(:func:`column_template`), and one reduction per CTA and output.  A bulk
copy needs 16-byte-aligned pages (:func:`check_pages`).

A CUDA kernel cannot take a Python callable the way Pallas traces one
into its body (``filter_pallas.py:104``), so the predicate is a
:class:`~.filter.FilterPred` descriptor.  The kernel takes 4-byte,
non-nullable columns (int32/uint32/float32), as the TPU kernel does.

The wrapper follows the tensor: a CPU tensor goes through the plain
version (:mod:`.filter`); a CUDA tensor launches the kernel or raises
(:class:`~..api.StromError` EINVAL for a callable predicate, a schema the
kernel does not take or pages it cannot copy, EIO for a launch error).
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import functools
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from .. import _build
from ..api import StromError
from ..trace import recorder as _trace
from ..scan.heap import PAGE_SIZE, HeapSchema
from .filter import (DEFAULT_SCHEMA, MAX_TERMS, STEP_PRED, FilterPred,
                     make_filter_fn, wide_sums)

__all__ = ["launches", "launch", "scan_filter_step_cuda",
           "make_filter_fn_cuda", "filter_pages_cuda", "kernel_refusal",
           "encode_terms", "column_template", "filter_grid", "check_pages",
           "new_outputs", "x64_refusal"]

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

MAX_COLS = 16
_KIND = {np.dtype(np.int32): 0, np.dtype(np.uint32): 1,
         np.dtype(np.float32): 2}
_OP = {"gt": 0, "ge": 1, "lt": 2, "le": 3, "eq": 4, "ne": 5}
_TERM_KIND = {"i": 0, "u": 1, "f": 2}
#: the kernel's variants: accumulators for up to this many columns
TEMPLATES = (4, 8, 16)
#: the bulk copies' alignment rule for the page batch
ALIGN = 16


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
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])


def column_template(n_cols: int) -> int:
    """The kernel variant for *n_cols* columns: the fewest accumulator
    slots of :data:`TEMPLATES` that hold them (EINVAL above the last)."""
    for nc in TEMPLATES:
        if n_cols <= nc:
            return nc
    raise StromError(_errno.EINVAL, f"{n_cols} columns; the kernel takes "
                                    f"{TEMPLATES[-1]}")


def filter_grid(n_pages: int, blocks_per_sm: int, sms: int) -> int:
    """CTAs of a launch over *n_pages*: as many as fit on the card at once
    (*blocks_per_sm* on each of *sms*), never more than the pages."""
    return max(1, min(n_pages, blocks_per_sm * sms))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, nc: int) -> int:
    lib = _build.load("filter")
    fn = lib.strom_filter_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(nc, ctypes.byref(blocks))
    if err or blocks.value < 1:
        raise StromError(_errno.EIO, f"filter kernel occupancy query failed: "
                         + lib.strom_cuda_error_string(err).decode())
    return blocks.value


def check_pages(pages_u8: torch.Tensor) -> None:
    """EINVAL unless *pages_u8* is a contiguous (B, 8192) uint8 batch that
    starts on a 16-byte boundary (the bulk copies' rule; every caller
    passes page-granular slices of allocator or staging memory)."""
    if (pages_u8.dtype != torch.uint8 or pages_u8.dim() != 2
            or pages_u8.shape[1] != PAGE_SIZE):
        raise StromError(_errno.EINVAL, f"pages must be (B, {PAGE_SIZE}) "
                                        f"uint8, got {tuple(pages_u8.shape)} "
                                        f"{pages_u8.dtype}")
    if not pages_u8.is_contiguous() or pages_u8.data_ptr() % ALIGN:
        raise StromError(_errno.EINVAL, f"pages must be contiguous and "
                                        f"{ALIGN}-byte aligned (the kernel's "
                                        f"bulk copies), got address "
                                        f"{pages_u8.data_ptr():#x}")


def kernel_refusal(schema: HeapSchema, predicate,
                   wide: Optional[bool] = None) -> str:
    """Why the kernel cannot run *predicate* over *schema* ('' = it can).
    Under 64-bit accumulation (*wide*, or :func:`.filter.wide_sums` when
    None) an int32 or uint32 column's sum is 64-bit, which the kernel's
    32-bit sums do not give; a float-only schema stays on the kernel,
    its count widened."""
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
    return x64_refusal((schema.col_dtype(c) for c in range(schema.n_cols)),
                       wide)


def x64_refusal(dtypes, wide: Optional[bool] = None) -> str:
    """The ``x64`` reason B1 and B2 refuse a layout with a 4-byte integer
    column for ('' when the sums are 32-bit or every column is a float).
    *wide*: :func:`.filter.wide_sums` as the caller read it (None: read
    it now; the kernels' layouts hold 4-byte columns only, so it is
    config ``x64``)."""
    if not (wide_sums() if wide is None else wide):
        return ""
    for c, dt in enumerate(dtypes):
        if np.dtype(dt).kind in "iu":
            return (f"x64 accumulators: column {c} ({np.dtype(dt)}) sums "
                    f"in 64 bits, beyond the kernel's 32-bit sums")
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


def new_outputs(schema: HeapSchema, device) -> torch.Tensor:
    """The zeroed int32 output words of a launch over *schema*: ``[count |
    isums | fsums]`` (zero bits are 0.0f; at least one sum slot of each
    kind)."""
    _, _, ni, nf = _slots(schema)
    return torch.zeros(1 + max(ni, 1) + max(nf, 1), dtype=torch.int32,
                       device=device)


def launch(pages_u8: torch.Tensor, spec: _Spec, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream over a validated CUDA batch;
    it adds its results to *out* (:func:`new_outputs`).  The one place
    ``launches`` moves."""
    global launches
    t0 = time.monotonic_ns() if _trace.active else 0
    n_pages = pages_u8.shape[0]
    dev = pages_u8.device
    index = dev.index or 0
    nc = column_template(spec.n_cols)
    grid = filter_grid(n_pages, _blocks_per_sm(index, nc),
                       _build.grid_cap(index, 1))
    # out's words: count, the int sums (one slot at least), the float sums
    n_isums = max(sum(spec.col_kind[c] != _KIND[np.dtype(np.float32)]
                      for c in range(spec.n_cols)), 1)
    base = out.data_ptr()
    _launch(pages_u8.data_ptr(), n_pages, ctypes.addressof(spec), base,
            base + 4, base + 4 * (1 + n_isums), nc, grid,
            torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    if t0:       # host time of the launch, not device time
        _trace.span("b1_filter", t0, time.monotonic_ns(),
                    args={"pages": n_pages})


def filter_pages_cuda(pages_u8: torch.Tensor, threshold, schema: HeapSchema,
                      predicate: Union[FilterPred, Callable], *,
                      wide: Optional[bool] = None) -> dict:
    """``{"count", "sums"}`` over a (B, 8192) uint8 page batch: the kernel
    for a CUDA tensor, the plain version for a CPU tensor.  *wide*: the
    accumulators' width as the step's builder read it
    (:func:`.filter.wide_sums`; None: read it now)."""
    if wide is None:
        wide = wide_sums(schema)
    if pages_u8.device.type == "cpu":
        return make_filter_fn(schema, predicate, wide=wide)(pages_u8,
                                                             threshold)
    if pages_u8.device.type != "cuda":
        raise StromError(_errno.EINVAL, f"pages on {pages_u8.device}: the "
                                        f"filter runs on cuda or cpu")
    why = kernel_refusal(schema, predicate, wide)
    if why:
        raise StromError(_errno.EINVAL, why)
    check_pages(pages_u8)
    kinds, slots, ni, _ = _slots(schema)
    out = new_outputs(schema, pages_u8.device)
    count, isums = out[:1], out[1:1 + max(ni, 1)]
    fsums = out[1 + max(ni, 1):].view(torch.float32)
    if pages_u8.shape[0]:
        launch(pages_u8, _spec(schema, predicate, threshold), out)
    sums = []
    for c in range(schema.n_cols):
        if kinds[c] == "f":
            sums.append(fsums[slots[c]])
        elif schema.col_dtype(c) == np.dtype(np.uint32):
            sums.append(isums[slots[c]].view(torch.uint32))
        else:
            sums.append(isums[slots[c]])
    # under x64 only float-only schemas reach the kernel: their count
    # widens as the plain version's (a batch's count fits 32 bits)
    return {"count": count[0].to(torch.int64) if wide else count[0],
            "sums": sums}


def make_filter_fn_cuda(schema: HeapSchema,
                        predicate: Union[FilterPred, Callable]) -> Callable:
    """CUDA face of :func:`.filter.make_filter_fn`: ``run(pages_u8,
    threshold=0) -> {"count", "sums"}``."""
    if not isinstance(predicate, FilterPred) and not callable(predicate):
        raise StromError(_errno.EINVAL, "predicate must be a FilterPred "
                                        "or a callable")

    wide = wide_sums(schema)

    def run(pages_u8: torch.Tensor, threshold=0) -> dict:
        return filter_pages_cuda(pages_u8, threshold, schema, predicate,
                                 wide=wide)

    return run


def scan_filter_step_cuda(pages_u8: torch.Tensor, threshold) -> dict:
    """CUDA face of :func:`.filter.scan_filter_step`: ``col0 > threshold``
    over the default schema; returns the count and the sum of col1."""
    out = filter_pages_cuda(pages_u8, threshold, DEFAULT_SCHEMA, STEP_PRED)
    return {"count": out["count"], "sum": out["sums"][1]}
