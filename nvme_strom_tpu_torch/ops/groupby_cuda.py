"""CUDA kernel for GROUP BY over heap pages.

Replaces the Pallas TPU kernel ``nvme_strom_tpu/ops/groupby_pallas.py``
(``make_groupby_fn_pallas``, the ``make_kernel`` closure) with
``csrc/groupby.cu``, hand-written for sm_90a and bound with ``ctypes``.

Bound: bytes.  The kernel reads, once, each page's header sector and the
column regions the query touches (visibility, key, predicate and
aggregated columns); per tuple it does a few integer ops and shared-memory
updates, so its least time is those bytes over device-memory bandwidth
(for the 290-tuple page of a six-column table and four of its seven
regions, 2048 pages are 9.6 MB: 2.9 us at 3.35 TB/s on an H100 SXM).

Its design (see the source) is planned here, on the host, by pure
functions the CPU tests reach: :func:`plan_segments` lists the bulk copies
that bring only those regions of a page into shared memory (16-byte
rounded, merged where they touch); :func:`plan_groupby` picks how a CTA
keeps its per-group accumulators (:data:`STRATEGIES`: a copy per lane or
one per CTA in shared memory) from G, V and the card's shared memory, its
threads and how many pages it keeps in flight; the grid is the kernel's
occupancy at that shared memory, capped by the pages.
A bulk copy needs 16-byte-aligned pages (``filter_cuda.check_pages``).

The key is a :class:`~.groupby.GroupKey` and the predicate a
:class:`~.filter.FilterPred`: CUDA cannot take the callables Pallas traces
into its body.  Group counts up to :data:`MAX_GROUPS` (512, above the
TPU kernel's 64) fit one block's shared memory for up to 16 aggregated
columns; a larger G raises EINVAL, it never runs the plain version.

The wrapper follows the tensor: a CPU tensor goes through the plain
version (:mod:`.groupby`); a CUDA tensor launches the kernel or raises
(:class:`~..api.StromError` EINVAL for a callable, a schema or a G the
kernel does not take or pages it cannot copy, EIO for a launch error).
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import errno as _errno
import functools
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _build
from ..api import StromError
from ..trace import recorder as _trace
from ..scan.heap import HeapSchema
from .filter import MAX_TERMS, FilterPred
from .filter_cuda import _KIND, MAX_COLS, _Terms, check_pages, \
    encode_terms, filter_grid, kernel_refusal as filter_refusal
from .groupby import GroupKey, _check_agg_cols, ieee_sums, make_groupby_fn

__all__ = ["launches", "launch", "MAX_GROUPS", "STRATEGIES",
           "groupby_pages_cuda", "kernel_refusal", "plan_segments",
           "plan_groupby", "GroupPlan", "new_outputs", "unpack_outputs"]

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

#: largest G the kernel takes (MAX_GROUPS in csrc/groupby.cu)
MAX_GROUPS = 512
#: the strategies the plan chooses from, in order: the accumulators in
#: shared memory as one copy per lane (atomics that never collide within a
#: warp), taken while they fit LANE_CAP, else one copy per CTA
STRATEGIES = ("lane", "cta")
#: accumulator copies a CTA keeps, by strategy
COPIES = {"lane": 32, "cta": 1}
#: the most accumulator bytes the per-lane strategy takes (beyond it the
#: copies crowd the pages out of shared memory and CTAs off the SMs)
LANE_CAP = 32 << 10
#: the kernel's variants: threads a CTA
THREAD_CHOICES = (256, 512)
#: threads a CTA and the most pages in flight per CTA, by strategy: the
#: per-CTA copy takes larger CTAs that hold all their pages at once, since
#: its atomics are few per tuple but its merge is one atomic per word and
#: CTA
THREADS = {"lane": 256, "cta": 512}
STAGES = {"lane": 4, "cta": 16}
#: shared memory one block may opt into on an H100 (the CPU tests' card)
H100_SMEM_OPTIN = 232448
_BAR_BYTES = 128               # BAR_BYTES in csrc/groupby.cu
_MAX_SEGS = MAX_COLS + 2       # MAX_SEGS in csrc/groupby.cu
_HEADER_BYTES = 16             # the sector holding n_tuples (word 2)
_INT_MIN, _INT_MAX = -(1 << 31), (1 << 31) - 1
# order-preserving int32 images of +inf / -inf (csrc/groupby.cu)
_F_MIN_INIT = int(np.float32(np.inf).view(np.int32))
_F_MAX_INIT = int(np.float32(-np.inf).view(np.int32)) ^ 0x7FFFFFFF


class _Spec(ctypes.Structure):
    """Field-for-field mirror of ``GroupSpec`` in csrc/groupby.cu."""

    _fields_ = [("tuples", ctypes.c_int), ("t_magic", ctypes.c_uint),
                ("vis_soff", ctypes.c_int), ("key_soff", ctypes.c_int),
                ("key_col", ctypes.c_int), ("key_kind", ctypes.c_int),
                ("key_abs", ctypes.c_int), ("key_mod", ctypes.c_uint),
                ("key_pow2", ctypes.c_int),
                ("terms", _Terms),
                ("term_soff", ctypes.c_int * MAX_TERMS),
                ("term_ckind", ctypes.c_int * MAX_TERMS),
                ("n_groups", ctypes.c_int), ("n_agg", ctypes.c_int),
                ("agg_kind", ctypes.c_int),
                ("agg_col", ctypes.c_int * MAX_COLS),
                ("agg_soff", ctypes.c_int * MAX_COLS),
                ("threads", ctypes.c_int),
                ("copies", ctypes.c_int), ("stages", ctypes.c_int),
                ("window", ctypes.c_int), ("stage_bytes", ctypes.c_int),
                ("n_seg", ctypes.c_int),
                ("seg_src", ctypes.c_int * _MAX_SEGS),
                ("seg_bytes", ctypes.c_int * _MAX_SEGS),
                ("seg_dst", ctypes.c_int * _MAX_SEGS)]


_launch = _build.launcher("groupby", "strom_groupby_pages", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """How one GROUP BY runs on the card (see :func:`plan_groupby`)."""

    strategy: str          # one of STRATEGIES
    threads: int           # threads a CTA
    copies: int            # accumulator copies a CTA (R)
    stages: int            # pages in flight a CTA
    window: int            # pages folded together
    segments: Tuple[Tuple[int, int, int], ...]   # (src, bytes, dst)
    soff: Dict[int, int]   # region -> staged word of its tuple 0
    stage_bytes: int       # one stage: the bytes the bulk copies bring in
    acc_words: int         # words of one accumulator copy
    smem: int              # dynamic shared memory of a CTA


def acc_words(n_groups: int, n_agg: int) -> int:
    """Words of one accumulator copy: count G, then sum, sum of squares,
    min and max per column (a float column's NaN/+inf/-inf counts go
    straight to the output buffer: they are rare)."""
    return n_groups + 4 * n_agg * n_groups


def plan_segments(schema: HeapSchema, regions: Sequence[int]):
    """The bulk copies of one page that bring in its header sector and the
    *regions* (column indexes; ``schema.n_cols`` is visibility): each
    region rounded out to 16 bytes, touching ones merged, packed in page
    order from stage byte 0.  Returns ``(segments, soff)``: ``(src byte,
    bytes, dst byte)`` triples, and each region's staged word."""
    t = schema.tuples_per_page
    spans = sorted((4 * schema.col_word_range(c)[0], c) for c in set(regions))
    segs = [[0, _HEADER_BYTES, []]]
    for start, c in spans:
        lo, hi = start // 16 * 16, -(-(start + 4 * t) // 16) * 16
        if lo <= segs[-1][0] + segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], hi - segs[-1][0])
            segs[-1][2].append((start, c))
        else:
            segs.append([lo, hi - lo, [(start, c)]])
    out, soff, dst = [], {}, 0
    for src, n, cols in segs:
        out.append((src, n, dst))
        for start, c in cols:
            soff[c] = (dst + start - src) // 4
        dst += n
    return tuple(out), soff


def plan_groupby(schema: HeapSchema, regions: Sequence[int], n_groups: int,
                 n_agg: int, *, smem_optin: int = H100_SMEM_OPTIN,
                 strategy: Optional[str] = None,
                 threads: Optional[int] = None) -> GroupPlan:
    """The kernel's plan for a GROUP BY reading *regions* of *schema*'s
    pages: the first strategy of :data:`STRATEGIES` that fits (per lane
    while its copies stay under :data:`LANE_CAP`), its :data:`THREADS` and
    as many stages as fit *smem_optin*, up to its :data:`STAGES`, halving;
    a window is half the stages (the other half loads meanwhile).
    *strategy* and *threads* force a choice (EINVAL if it does not fit),
    for timing one against the other."""
    if threads is not None and threads not in THREAD_CHOICES:
        raise StromError(_errno.EINVAL, f"{threads} threads a CTA; the "
                                        f"kernel takes {THREAD_CHOICES}")
    segments, soff = plan_segments(schema, regions)
    stage_bytes = sum(n for _, n, _ in segments)
    words = acc_words(n_groups, n_agg)
    for name in (strategy,) if strategy else STRATEGIES:
        copies = COPIES[name]
        acc = 4 * copies * words
        if strategy is None and name == "lane" and acc > LANE_CAP:
            continue
        s = STAGES[name]
        while s >= 1:
            smem = _BAR_BYTES + s * stage_bytes + acc
            if smem <= smem_optin:
                return GroupPlan(name, threads or THREADS[name], copies, s,
                                 max(s // 2, 1), segments, soff, stage_bytes,
                                 words, smem)
            s //= 2
    raise StromError(_errno.EINVAL, f"G={n_groups}, V={n_agg}: the "
                                    f"accumulators and a page do not fit "
                                    f"{smem_optin} bytes of shared memory"
                                    + (f" as {strategy!r}" if strategy
                                       else ""))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, threads: int, is_float: bool,
                   smem: int) -> int:
    lib = _build.load("groupby")
    fn = lib.strom_groupby_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(threads, int(is_float), smem, ctypes.byref(blocks))
    if err or blocks.value < 1:
        raise StromError(_errno.EIO, f"groupby kernel occupancy query "
                         f"failed: " + lib.strom_cuda_error_string(err)
                         .decode())
    return blocks.value


def kernel_refusal(schema: HeapSchema, key, n_groups: int,
                   predicate=None) -> str:
    """Why the kernel cannot run this GROUP BY ('' = it can)."""
    from ..config import config
    if config.get("x64"):
        return ("x64 accumulators (8-byte int sums, float64 sums of "
                "squares) exceed the kernel's 32-bit accumulators")
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


def _regions(schema: HeapSchema, key: GroupKey, cols_idx,
             pred: FilterPred):
    regions = {key.col, *cols_idx, *(t[0] for t in pred.terms)}
    if schema.visibility:
        regions.add(schema.n_cols)
    return sorted(regions)


def _spec(schema: HeapSchema, key: GroupKey, n_groups: int, cols_idx,
          agg_dt: np.dtype, pred: FilterPred, threshold, *,
          smem_optin: int = H100_SMEM_OPTIN, strategy: Optional[str] = None,
          threads: Optional[int] = None) -> _Spec:
    plan = plan_groupby(schema, _regions(schema, key, cols_idx, pred),
                        n_groups, len(cols_idx), smem_optin=smem_optin,
                        strategy=strategy, threads=threads)
    spec = _Spec()
    t = schema.tuples_per_page
    spec.tuples = t
    spec.t_magic = -(-(1 << 32) // t) & 0xFFFFFFFF
    spec.vis_soff = plan.soff[schema.n_cols] if schema.visibility else -1
    spec.key_soff = plan.soff[key.col]
    spec.key_col = key.col
    spec.key_kind = _KIND[schema.col_dtype(key.col)]
    spec.key_abs = int(bool(key.absolute))
    spec.key_mod = int(key.mod or 0)
    spec.key_pow2 = int(bool(key.mod) and key.mod & (key.mod - 1) == 0)
    spec.terms = encode_terms(pred, schema, threshold)
    for q, (c, _op, _v) in enumerate(pred.terms):
        spec.term_soff[q] = plan.soff[c]
        spec.term_ckind[q] = _KIND[schema.col_dtype(c)]
    spec.n_groups = int(n_groups)
    spec.n_agg = len(cols_idx)
    spec.agg_kind = _KIND[agg_dt]
    for i, c in enumerate(cols_idx):
        spec.agg_col[i] = c
        spec.agg_soff[i] = plan.soff[c]
    spec.threads, spec.copies = plan.threads, plan.copies
    spec.stages, spec.window = plan.stages, plan.window
    spec.stage_bytes = plan.stage_bytes
    spec.n_seg = len(plan.segments)
    for q, (src, n, dst) in enumerate(plan.segments):
        spec.seg_src[q], spec.seg_bytes[q], spec.seg_dst[q] = src, n, dst
    return spec


def spec_smem(spec: _Spec) -> int:
    """The dynamic shared memory a launch of *spec* takes."""
    return _BAR_BYTES + spec.stages * spec.stage_bytes + 4 * spec.copies \
        * acc_words(spec.n_groups, spec.n_agg)


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
    """Launch the kernel on the current stream over a validated CUDA batch;
    it adds into *buf* (:func:`new_outputs`).  The one place ``launches``
    moves."""
    global launches
    t0 = time.monotonic_ns() if _trace.active else 0
    n_pages = pages_u8.shape[0]
    dev = pages_u8.device
    index = dev.index or 0
    smem = spec_smem(spec)
    grid = filter_grid(n_pages, _blocks_per_sm(
        index, spec.threads, agg_dt.kind == "f", smem),
        _build.grid_cap(index, 1))
    mn, mx = _inits(agg_dt)
    _launch(pages_u8.data_ptr(), n_pages, ctypes.addressof(spec), mn, mx,
            buf.data_ptr(), grid, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    if t0:       # host time of the launch, not device time
        _trace.span("b3_groupby", t0, time.monotonic_ns(),
                    args={"pages": n_pages})


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
    check_pages(pages_u8)
    G, V = int(n_groups), len(cols_idx)
    buf = new_outputs(G, V, agg_dt, pages_u8.device)
    if pages_u8.shape[0]:
        launch(pages_u8, _spec(
            schema, key, G, cols_idx, agg_dt, predicate or FilterPred(),
            threshold, smem_optin=_build.smem_optin(
                pages_u8.device.index or 0)), agg_dt, buf)
    return unpack_outputs(buf, G, V, agg_dt)
