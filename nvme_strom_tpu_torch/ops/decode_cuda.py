"""CUDA kernel for the fused decode → filter → aggregate over packed pages.

Replaces the Pallas TPU kernel ``nvme_strom_tpu/ops/decode_pallas.py``
(``make_decode_filter_fn_pallas``, kernel ``_make_kernel``) with
``csrc/decode.cu``, hand-written for sm_90a and bound with ``ctypes``.

Bound: bytes.  The kernel reads, once, each packed page's header and the
regions of the columns it decodes (the rest of a page is padding) and
spends a few integer ops per row and column, so its least time is those
bytes over device-memory bandwidth.  Its design (see the source):
persistent CTAs sized from the kernel's occupancy, each page brought into
shared memory by one bulk copy of :func:`staged_span` bytes, the packed
slot of a row found by a shift and a mask (:func:`column_geometry`,
:func:`row_slot`), a row mask per chunk of :data:`CHUNK_ROWS` rows
(:func:`row_chunks`) folded column by column, accumulators templated on
the column count (``filter_cuda.column_template``).  A bulk copy needs
16-byte-aligned pages (``filter_cuda.check_pages``).

The codec geometry is static per file (:class:`~..scan.colpack.PackedMeta`)
and goes to the kernel as a spec struct, with the predicate's
:class:`~.filter.FilterPred` terms.  A CUDA tensor launches the kernel or
raises (EINVAL for a callable predicate, a layout the kernel does not take
or pages it cannot copy, EIO for a launch error); a CPU tensor goes through
the plain version (:mod:`.decode`).  ``launches`` counts kernel launches
and nothing else.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import functools
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import _build
from ..api import StromError
from ..trace import recorder as _trace
from ..scan.colpack import ColCodec, PackedMeta
from ..scan.heap import HEADER_WORDS, PAGE_SIZE
from .decode import make_decode_filter_fn
from .filter import FilterPred, wide_sums
from .filter_cuda import _KIND, MAX_COLS, _Terms, check_pages, \
    column_template, encode_terms, filter_grid, x64_refusal

__all__ = ["launches", "launch", "decode_filter_pages_cuda",
           "kernel_refusal", "column_geometry", "row_slot", "staged_span",
           "row_chunks", "CHUNK_ROWS"]

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

_CODEC = {"raw": 1, "bitpack": 2, "dict": 3, "rle": 4}
#: threads a CTA (THREADS in csrc/decode.cu)
THREADS = 128
#: rows one mask covers, 8 a thread (CHUNK_ROWS in csrc/decode.cu)
CHUNK_ROWS = 8 * THREADS
#: pages in flight per CTA
STAGES = 2
_BAR_BYTES = 128               # BAR_BYTES in csrc/decode.cu


class _Spec(ctypes.Structure):
    """Field-for-field mirror of ``DecodeSpec`` in csrc/decode.cu."""

    _fields_ = [("n_cols", ctypes.c_int), ("rpb", ctypes.c_int)] + [
        (name, ctypes.c_int * MAX_COLS)
        for name in ("codec", "off", "lg_nw", "bits", "dsize", "rmax",
                     "col_kind", "col_slot")] + [
        ("terms", _Terms), ("span_bytes", ctypes.c_int),
        ("stages", ctypes.c_int)]


_launch = _build.launcher("decode", "strom_decode_filter_pages", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])


def column_geometry(cm: ColCodec) -> dict:
    """What the kernel needs of a bit-packed (bitpack or dict) region:
    ``nw`` packed words (a power of two, since rows_per_block and the
    widths are), ``lg_nw`` = log2 nw, the packed words' first word in the
    region (``data``), the width and the value mask."""
    data = 1 if cm.codec == "bitpack" else cm.dsize
    nw = cm.nwords - data
    if nw < 1 or nw & (nw - 1):
        raise StromError(_errno.EINVAL, f"{cm.codec} region of {nw} packed "
                                        f"words: the kernel takes a power "
                                        f"of two")
    return {"nw": nw, "lg_nw": nw.bit_length() - 1, "data": data,
            "bits": cm.bits, "vmask": (1 << cm.bits) - 1}


def row_slot(r: int, lg_nw: int, bits: int):
    """(word, shift) of row *r* in a packed region of 2^lg_nw words, as
    the kernel computes it: ``r & (nw - 1)``, ``(r >> lg_nw) * bits``."""
    return r & ((1 << lg_nw) - 1), (r >> lg_nw) * bits


def staged_span(meta: PackedMeta, need: Optional[Sequence[int]]) -> int:
    """Bytes of a page the kernel's one bulk copy brings in: from word 0
    to the end of the last decoded region, rounded up to 16 (the header
    alone when no column is decoded)."""
    end = HEADER_WORDS
    for c, cm in enumerate(meta.cols):
        if need is None or c in need:
            end = max(end, cm.off + cm.nwords)
    return min(-(-4 * end // 16) * 16, PAGE_SIZE)


def row_chunks(n_rows: int):
    """The kernel's row chunks of a page holding *n_rows* rows: ``(first
    row, rows)``, each at most :data:`CHUNK_ROWS` (a thread's rows of a
    chunk are the bits of one mask)."""
    return [(c0, min(CHUNK_ROWS, n_rows - c0))
            for c0 in range(0, n_rows, CHUNK_ROWS)]


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, nc: int, smem: int) -> int:
    lib = _build.load("decode")
    fn = lib.strom_decode_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(nc, smem, ctypes.byref(blocks))
    if err or blocks.value < 1:
        raise StromError(_errno.EIO, f"decode kernel occupancy query failed: "
                         + lib.strom_cuda_error_string(err).decode())
    return blocks.value


def kernel_refusal(meta: PackedMeta, predicate,
                   wide: Optional[bool] = None) -> str:
    """Why the kernel cannot run *predicate* over *meta* ('' = it can);
    under 64-bit accumulation (*wide*, or config ``x64`` when None), a
    4-byte integer column (B1's rule, :func:`.filter_cuda.x64_refusal`)."""
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
    return x64_refusal(meta.dtypes, wide)


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
        decoded = need is None or c in need
        spec.codec[c] = _CODEC[cm.codec] if decoded else 0
        spec.off[c] = cm.off
        if decoded and cm.codec in ("bitpack", "dict"):
            spec.lg_nw[c] = column_geometry(cm)["lg_nw"]
        spec.bits[c] = cm.bits
        spec.dsize[c] = cm.dsize
        spec.rmax[c] = cm.rmax
        spec.col_kind[c] = _KIND[np.dtype(meta.dtypes[c])]
        spec.col_slot[c] = slots[c]
    spec.terms = encode_terms(pred, [np.dtype(d) for d in meta.dtypes],
                              threshold)
    spec.span_bytes = staged_span(meta, need)
    spec.stages = STAGES
    return spec


def launch(pages_u8: torch.Tensor, spec: _Spec, count: torch.Tensor,
           isums: torch.Tensor, fsums: torch.Tensor) -> None:
    """Launch the kernel on the current stream over a validated CUDA batch
    (outputs zeroed by the caller); the one place ``launches`` moves."""
    global launches
    t0 = time.monotonic_ns() if _trace.active else 0
    n_pages = pages_u8.shape[0]
    dev = pages_u8.device
    index = dev.index or 0
    nc = column_template(spec.n_cols)
    smem = _BAR_BYTES + spec.stages * spec.span_bytes
    grid = filter_grid(n_pages, _blocks_per_sm(index, nc, smem),
                       _build.grid_cap(index, 1))
    _launch(pages_u8.data_ptr(), n_pages, ctypes.addressof(spec),
            count.data_ptr(), isums.data_ptr(), fsums.data_ptr(), nc, grid,
            torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    if t0:       # host time of the launch, not device time
        _trace.span("b2_decode", t0, time.monotonic_ns(),
                    args={"pages": n_pages})


def decode_filter_pages_cuda(pages_u8: torch.Tensor, threshold,
                             meta: PackedMeta,
                             predicate: Union[FilterPred, Callable, None]
                             = None, *,
                             need_cols: Optional[Sequence[int]] = None,
                             wide: Optional[bool] = None) -> dict:
    """``{"count", "sums"}`` over a (B, 8192) uint8 batch of packed
    pages: the kernel for a CUDA tensor, the plain version for a CPU
    tensor.  ``sums[c]`` is column c's masked sum (zero outside
    ``need_cols``).  *wide*: the accumulators' width as the step's
    builder read it (:func:`.filter.wide_sums`; None: read it now)."""
    if wide is None:
        wide = wide_sums()
    if pages_u8.device.type == "cpu":
        return make_decode_filter_fn(meta, predicate, need_cols=need_cols,
                                     wide=wide)(pages_u8, threshold)
    why = kernel_refusal(meta, predicate, wide)
    if why:
        raise StromError(_errno.EINVAL, why)
    if pages_u8.device.type != "cuda":
        raise StromError(_errno.EINVAL, f"pages on {pages_u8.device}: the "
                                        f"decode runs on cuda or cpu")
    check_pages(pages_u8)
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
    # under x64 only float-only layouts reach the kernel: their count
    # widens as the plain version's
    return {"count": count[0].to(torch.int64) if wide else count[0],
            "sums": sums}
