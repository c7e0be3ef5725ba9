"""Declarative query layer over one heap table: plan → stream → fold.

A port of the JAX package's ``scan/query.py``: one fluent :class:`Query`
over one heap table, with a conjunctive ``where``, one terminal operator,
``explain``, ``run`` and the point lookup ``fetch``.  The table is a file
path (or ``PathLike``), a list of paths (a RAID-0 stripe set at the
query's ``stripe_chunk_size``) or an open :class:`..engine.Source` (a
segmented relation, say), which the query never closes.

The plan's ``access_path`` is ``direct``, ``vfs`` or ``index``.  The scan
goes direct (the engine's O_DIRECT reads through the pinned ring,
:class:`.executor.TableScanner`) when the planner's gate says so
(:func:`.planner.should_use_direct_scan`: config ``enabled``, a
direct-load capable file by CHECK_FILE, ``require_nvme_backing``'s
strict eligibility, then a table at or above the direct-scan threshold
``(RAM − buffer_size)·⅔ + buffer_size`` or ``debug_no_threshold``); else
it reads ``vfs``, through the page cache in 1024-page batches, each
copied to the query's device and folded by the same step, kernels
included.  Sidecar and packed-sidecar plans need a table path.
Terminals: ``aggregate``, ``aggregate_exprs`` (sums of expression
trees), ``group_by`` (a key descriptor or function), ``group_by_cols``
(value-keyed, keys discovered by a first scan, a sorted spill past
``max_groups``), ``select``, ``top_k``, ``order_by``, ``quantiles``,
``count_distinct``, ``join`` / ``join_table`` (a dimension table from host
arrays or a heap file: broadcast, or local Grace passes above
``join_broadcast_max``; inner, left, semi and anti; an aggregate or a row
face) and ``star_join`` (several dimensions probed in one pass).  ``run``
streams the table through
the scan pipeline (:class:`.executor.TableScanner`) and folds or gathers
each batch on one of two routes, chosen at plan time (``kernel=``):

* ``cuda`` — the hand-written kernels: ``aggregate`` through the heap
  filter (B1, ``csrc/filter.cu``), ``group_by`` through the GROUP BY
  kernel (B3, ``csrc/groupby.cu``), and the packed sidecar's ``chip``
  pushdown leg through the decode-filter (B2, ``csrc/decode.cu``);
* ``torch`` — PyTorch ops on the query's device, card or CPU: the plain
  versions of those kernels, the gather the row and order terminals ride
  on, and the joins' sorted probes (``ops/join.py``).  It is the port's
  counterpart of the JAX package's XLA route; no kernel computes a join,
  a star join or an expression aggregate.

``auto`` picks ``cuda`` whenever the kernels take the query (their
``kernel_refusal`` is empty) and ``torch`` for what they refuse, and the
plan's reason names the refusal.  ``kernel="cuda"`` on a refused query is
an invalid plan (EINVAL at ``run``); a kernel wrapper never hands a CUDA
tensor to a plain version.  On the CPU every query runs ``torch``.

Predicates are :class:`~..ops.filter.FilterPred` descriptors (the form the
kernels take) or callables ``predicate(cols) -> bool``; a term on a
nullable column never matches a NULL row.  Row positions are int64.

The structured filters ``where_eq`` (a column, or a column pair),
``where_in`` and ``where_range`` are filters the planner can see.  Their
seqscan predicate is ``FilterPred`` terms (``where_in``'s is a callable,
so it runs ``torch``); with a fresh sorted sidecar of :mod:`.index` for
the column (or a composite one led by it) the plan's ``access_path`` is
``index``: positions come from the sidecar and only their pages are read
(:meth:`Query.fetch`), then ``select``, ``aggregate``, ``group_by``,
``top_k``, ``quantiles``, ``count_distinct`` and ``join`` fold the
fetched rows in PyTorch ops on the query's device — no kernel runs on
that path.  A later ``where`` becomes a residual that the index path
rechecks on the fetched rows.  Unfiltered ``order_by``, ``top_k``,
``quantiles`` and ``count_distinct`` over an integer column with a fresh
sidecar read the sidecar alone (``WHERE c0 = v ORDER BY c1`` one span of a
``(c0, c1)`` sidecar), and ``group_by_cols`` takes its distinct keys from
one.  A missing, stale or corrupt sidecar means the scan, on the access
path the gate chooses.

Three ways to run a scan besides the one-process scan:

* ``workers=N`` (``Query(..., workers=N)`` or ``run(workers=N)``, over a
  table path only): N worker processes, started with ``spawn``, claim
  chunks from one shared cursor (:mod:`.parallel`, the Gather analog) and
  read them direct, each with its own session, and the leader folds their
  numpy partials.  ``aggregate`` (expression aggregates
  too), ``group_by_cols`` (its sorted spill too), ``top_k``, ``select`` and
  the star join's aggregate face travel; a worker runs the route the
  leader's plan chose, B1/B3 on the card included.  FilterPred terms, the
  structured filters and the SQL facade's predicate trees travel; a
  callable ``where`` without a tree, a ``group_by`` key without
  ``group_by_cols``, joins, the star row face and the other terminals are
  refused (EINVAL).  ``select`` and ``top_k`` come
  back in the serial scan's order.
* ``mesh=`` (a :class:`..parallel.mesh.RingMesh`): batches stream sharded
  over the mesh's dp axis (:class:`..parallel.stream.ShardedBatchStream`),
  the plan's step runs on each dp shard and the results fold with the
  operator's combine; the pages past the last whole batch scan on the
  first member.  The sort terminals (``order_by``, ``quantiles``,
  ``count_distinct``) gather on the first member and sort with the
  distributed sample sort over every member (:mod:`..parallel.sort`); a
  join whose build side is above ``join_broadcast_max`` hash-partitions
  the build over dp and routes each batch's rows to their key's owner
  (:mod:`..parallel.pjoin`), both faces; the broadcast join and star row
  faces run on the first member.

  A mesh whose members belong to several ranks (:mod:`..parallel.dist`)
  runs every terminal, and every rank returns the same result, the one
  process's over a mesh of the same size.  Each rank reads only its own
  members' shards of each batch (the owner of member 0 reads the tail):
  the folding terminals meet in one gather of the ranks' folds; the row
  faces (``select``, the broadcast join and star row faces) gather each
  rank's rows tagged with their (batch, member) place and merge them in
  the one process's order, a rank stopping once it holds ``offset +
  limit`` of its own; the sort terminals sort the ranks' rows, joined in
  that order, over every member, and the rows of other ranks' members
  come back through :func:`..parallel.dist.gather_members`; the
  partitioned join routes across ranks, its row face decides the early
  stop on all ranks together; and GROUP BY's sorted spill merges the
  ranks' sorted states in rank order.  As in one process, a fresh sidecar
  does not serve a mesh query: both packages plan the index only for a
  local run, so a structured filter over a mesh is the seqscan face; the
  index face is the local run, which reads the sidecar and the fetched
  pages and no table scan.
* ``analyze=True``: the result gains ``"_analyze"``, the run's wall time and
  engine counters (EXPLAIN ANALYZE).

The SQL facade (:mod:`.sql`) builds on this class: its plain WHERE leaves
become FilterPred terms, and the rest a ``where`` callable carrying its
picklable predicate tree, which worker processes rebuild.

With a residency tier on, the plan reports each tier's expected hit ratio
for the table (``cache_hit_ratio`` for RAM, ``hbm_hit_ratio`` for HBM: the
fraction of the table's bytes resident there), and the packed leg keys its
extents apart from the heap's (``cache_key_extra``), so the two never
alias in a tier.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno as _errno
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..api import StromError
from ..trace import recorder as _trace
from ..ops.filter import FilterPred, decode_pages, global_row_positions, \
    select_rows
from ..ops.groupby import GroupKey, _check_agg_cols, acc_dtypes, \
    combine_groupby, groupby_kernel_auto
from ..ops.join import _VALUE_DTS
from ..stats import stats
from .heap import PAGE_SIZE, HeapSchema

__all__ = ["Query", "QueryPlan"]

_KERNELS = ("auto", "cuda", "torch")
_ROW_OPS = ("select", "top_k", "order_by", "quantiles", "count_distinct")
_SORTABLE = (np.dtype(np.int32), np.dtype(np.uint32), np.dtype(np.float32))
# threads that read one batch of the buffered scan (_buffered_batches)
_VFS_READERS = 4
_I32 = np.dtype(np.int32)


class _GroupSpill(Exception):
    """Key discovery passed ``max_groups`` on a shape the sorted spill
    serves (1-2 key columns): ``run`` reroutes instead of failing."""

    def __init__(self, seen: int):
        self.seen = seen
        super().__init__(f"group key discovery passed {seen} distinct")


class _SortedGroupAcc:
    """Running sorted-aggregation state of the GROUP BY spill: a sorted
    packed-key array plus per-key count/sums/sumsqs/mins/maxs, merged
    batch by batch — footprint O(distinct keys).  Accumulator dtypes
    follow :func:`..ops.groupby.acc_dtypes`, so int sums wrap at the
    width the one-pass GROUP BY wraps at."""

    def __init__(self, n_vals: int, acc_np, sq_np, lo, hi, cap: int):
        self.V, self.cap = n_vals, cap
        self.acc_np, self.sq_np, self.lo, self.hi = acc_np, sq_np, lo, hi
        self.keys: Optional[np.ndarray] = None
        self.count = self.sums = self.sumsqs = None
        self.mins = self.maxs = None

    def _batch_partial(self, kv: np.ndarray, vals: np.ndarray):
        """Sort one batch's (keys, (V, n) values) and segment-reduce."""
        order = np.argsort(kv, kind="stable")
        kv, vals = kv[order], vals[:, order]
        uk, starts = np.unique(kv, return_index=True)
        count = np.diff(np.append(starts, len(kv))).astype(np.int64)
        sums = np.add.reduceat(vals.astype(self.acc_np), starts, axis=1)
        fv = vals.astype(np.float64)
        sumsqs = np.add.reduceat(fv * fv, starts, axis=1).astype(self.sq_np)
        mins = np.minimum.reduceat(vals, starts, axis=1)
        maxs = np.maximum.reduceat(vals, starts, axis=1)
        return uk, count, sums, sumsqs, mins, maxs

    def add_batch(self, kv: np.ndarray, vals: np.ndarray) -> None:
        if len(kv):
            self.merge_state(dict(zip(
                ("keys", "count", "sums", "sumsqs", "mins", "maxs"),
                self._batch_partial(kv, vals))))

    def merge_state(self, st: dict) -> None:
        """Merge another sorted partial into this one."""
        uk = st["keys"]
        if self.keys is None:
            self.keys = uk
            self.count, self.sums = st["count"], st["sums"]
            self.sumsqs = st["sumsqs"]
            self.mins, self.maxs = st["mins"], st["maxs"]
            return
        merged = np.union1d(self.keys, uk)
        if len(merged) > self.cap:
            raise StromError(_errno.ENOMEM, f"group_by_cols: {len(merged)} "
                                            f"distinct keys exceed even the "
                                            f"sorted-aggregation cap "
                                            f"{self.cap} (unbounded key set)")
        # both key sets are sorted and unique, so each merged slot is hit
        # at most once from either side: plain fancy-index updates give
        # the JAX package's ufunc.at results
        io = np.searchsorted(merged, self.keys)
        i_n = np.searchsorted(merged, uk)
        g = len(merged)
        count = np.zeros(g, np.int64)
        count[io] = self.count
        count[i_n] += st["count"]
        sums = np.zeros((self.V, g), self.acc_np)
        sumsqs = np.zeros((self.V, g), self.sq_np)
        mins = np.full((self.V, g), self.hi)
        maxs = np.full((self.V, g), self.lo)
        sums[:, io] = self.sums
        sumsqs[:, io] = self.sumsqs
        mins[:, io] = self.mins
        maxs[:, io] = self.maxs
        sums[:, i_n] += st["sums"]
        sumsqs[:, i_n] += st["sumsqs"]
        mins[:, i_n] = np.minimum(mins[:, i_n], st["mins"])
        maxs[:, i_n] = np.maximum(maxs[:, i_n], st["maxs"])
        self.keys, self.count = merged, count
        self.sums, self.sumsqs = sums, sumsqs
        self.mins, self.maxs = mins, maxs

    def state(self) -> dict:
        """The folded state; an empty scan is a zero-group result."""
        if self.keys is None:
            z = np.zeros(0, np.int64)
            return {"keys": z, "count": z,
                    "sums": np.zeros((self.V, 0), self.acc_np),
                    "sumsqs": np.zeros((self.V, 0), self.sq_np),
                    "mins": np.zeros((self.V, 0)),
                    "maxs": np.zeros((self.V, 0))}
        return {"keys": self.keys, "count": self.count,
                "sums": self.sums, "sumsqs": self.sumsqs,
                "mins": self.mins, "maxs": self.maxs}


@dataclass(frozen=True)
class QueryPlan:
    """What ``run()`` will do, decided before any I/O (EXPLAIN)."""

    operator: str          # aggregate | group_by | select | join | ...
    kernel: str            # cuda | torch | invalid
    device: str
    n_pages: int
    reason: str
    pushdown: str = ""     # "" | chip | host | raw (packed-sidecar scan)
    join_strategy: Optional[str] = None   # broadcast | partitioned(N)
    access_path: str = "direct"           # direct | vfs | index
    mode: str = "local"    # local | mesh
    workers: int = 0       # worker processes (0 = one process)
    cost_direct: float = 0.0
    cost_vfs: float = 0.0
    cache_hit_ratio: float = 0.0   # expected RAM-tier hit fraction
    hbm_hit_ratio: float = 0.0     # expected HBM-tier hit fraction

    def __str__(self) -> str:
        pd = f", pushdown {self.pushdown}" if self.pushdown else ""
        par = f", workers={self.workers}" if self.workers else ""
        cache = (f"  cache-resident: ~{self.cache_hit_ratio:.0%}"
                 if self.cache_hit_ratio > 0 else "")
        cache += (f"  hbm-resident: ~{self.hbm_hit_ratio:.0%}"
                  if self.hbm_hit_ratio > 0 else "")
        return (f"{self.operator} scan  [{self.access_path} path, "
                f"{self.kernel} route on {self.device}{pd}, {self.mode}"
                f"{par}]\n  pages: {self.n_pages}  cost: direct="
                f"{self.cost_direct:.0f} vfs={self.cost_vfs:.0f}{cache}\n"
                f"  {self.reason}")


def _tag_packed(src, meta) -> None:
    """Key a packed sidecar's extents apart from the heap's in the
    residency tiers: a representation tag and the encode's generation
    (a re-encoded sidecar never aliases a stale extent), and the logical
    bytes each packed byte serves, which the RAM tier credits."""
    src.cache_key_extra = ("#repr=cpk", f"#gen={meta.table_mtime_ns}")
    src.logical_scale = meta.logical_bytes / max(meta.packed_bytes, 1)


def stable_order(keys: np.ndarray, dev: torch.device) -> np.ndarray:
    """``np.argsort(keys, kind="stable")``, sorted by ``torch.sort(stable=
    True)`` on *dev*: the same permutation (NaN after every number, ±0
    equal, ties in arrival order), off the host.  Every key sorts as an
    int64 of the same order: float32 through
    :func:`..parallel.sort.sort_keys` (one key for both zeros, one for
    every NaN, above +inf), so no NaN's sign bit and no device sort's
    float handling can move a row; uint32 and uint64 by their value's
    order."""
    if keys.dtype == np.float32:
        from ..parallel.sort import sort_keys
        t = sort_keys(torch.from_numpy(np.ascontiguousarray(keys)).to(dev),
                      "f", False)
        return torch.sort(t, stable=True).indices.cpu().numpy()
    if keys.dtype == np.uint32:
        keys = keys.astype(np.int64)
    elif keys.dtype == np.uint64:
        keys = (keys ^ np.uint64(1 << 63)).view(np.int64)
    t = torch.from_numpy(np.ascontiguousarray(keys)).to(dev)
    return torch.sort(t, stable=True).indices.cpu().numpy()


def _host(t: torch.Tensor, dt: np.dtype) -> np.ndarray:
    """A decoded column (uint32 as int64) back on the host in *dt*."""
    a = t.cpu().numpy()
    return a if a.dtype == dt else a.astype(dt)


def _check_build_table(path: str, schema: HeapSchema, what: str) -> None:
    """The build table's first page header against *schema*: a missing
    file, a file that is not a heap or a column count that disagrees fails
    here, with the cause's errno (EINVAL for a mismatch)."""
    from .heap import validate_heap_header
    try:
        validate_heap_header(path, schema)
    except (OSError, ValueError) as e:
        raise StromError(getattr(e, "errno", None) or _errno.EINVAL,
                         f"{what} build table: {e}") from e


def _hv(user: Optional[Callable]) -> Callable:
    """HAVING of a value-keyed GROUP BY: empty groups drop, then *user*."""
    def hv(res):
        m = np.asarray(res["count"]) > 0
        if user is not None:
            m = m & np.asarray(user(res)).astype(bool)
        return m
    return hv


def _to_torch(x):
    """A numpy partial as CPU tensors (uint32 as ``torch.uint32``, uint64
    as ``torch.uint64``), the form the batch folds take."""
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    a = np.array(x)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    if a.dtype == np.uint64:
        return torch.from_numpy(a.view(np.int64)).view(torch.uint64)
    return torch.from_numpy(a)


def _buffered_batches(src, first_page: int, dev: torch.device):
    """The pages of *src* from *first_page* on, read through the page
    cache (``Source.read_buffered``) in batches of 1024 pages (8 MiB, the
    reference's grid), each yielded as a ``(n, PAGE_SIZE)`` tensor on
    *dev*.

    :data:`_VFS_READERS` threads read each batch in page-aligned pieces,
    and the next batch is read while the current one is folded.  On a
    CUDA device the scan stages through two pinned host buffers, taken
    once for the scan, and copies each batch to a fresh device tensor
    without blocking; a buffer is refilled only after its copy is done.
    Elsewhere each batch is a fresh host tensor."""
    from concurrent.futures import ThreadPoolExecutor
    batch = (8 << 20) // PAGE_SIZE
    n_pages = src.size // PAGE_SIZE
    spans = [(p0, min(batch, n_pages - p0))
             for p0 in range(first_page, n_pages, batch)]
    if not spans:
        return
    cuda = dev.type == "cuda"
    if cuda:
        staging = [torch.empty(batch * PAGE_SIZE, dtype=torch.uint8,
                               pin_memory=True) for _ in range(2)]
        copied = [None, None]
    with ThreadPoolExecutor(_VFS_READERS) as pool:
        def fill(i):
            """Start reading batch *i*: its host tensor and the reads."""
            p0, n = spans[i]
            if cuda:
                if copied[i % 2] is not None:
                    copied[i % 2].synchronize()
                host = staging[i % 2][:n * PAGE_SIZE]
            else:
                host = torch.empty(n * PAGE_SIZE, dtype=torch.uint8)
            view = memoryview(host.numpy())
            step = -(-n // _VFS_READERS)
            return host, [pool.submit(src.read_buffered, (p0 + a) * PAGE_SIZE,
                                      view[a * PAGE_SIZE:
                                           min(a + step, n) * PAGE_SIZE])
                          for a in range(0, n, step)]

        nxt = fill(0)
        for i, (_, n) in enumerate(spans):
            host, reads = nxt
            if i + 1 < len(spans):
                nxt = fill(i + 1)
            for r in reads:
                r.result()
            if not cuda:
                yield host.view(n, PAGE_SIZE).to(dev)
                continue
            pages = torch.empty((n, PAGE_SIZE), dtype=torch.uint8,
                                device=dev)
            pages.view(-1).copy_(host, non_blocking=True)
            copied[i % 2] = torch.cuda.Event()
            copied[i % 2].record(torch.cuda.current_stream(dev))
            yield pages


def _merge_topk(accs: List[dict], dt: np.dtype, largest: bool,
                k: int) -> dict:
    """The best *k* of several top-k candidate sets, ties to the lower
    position (a pad's -1 after every row), which is the order one
    process's scan gives them."""
    from ..ops.topk import topk_key
    vals = torch.cat([a["values"] for a in accs])
    pos = torch.cat([a["positions"] for a in accs])
    by_pos = torch.sort(torch.where(pos < 0, torch.iinfo(pos.dtype).max,
                                    pos), stable=True).indices
    best = torch.sort(topk_key(vals[by_pos], dt, largest), descending=True,
                      stable=True).indices[:k]
    idx = by_pos[best]
    return {"values": vals[idx], "positions": pos[idx]}


class Query:
    """Fluent scan builder over one heap table file.

    >>> q = (Query("/data/t.heap", schema)
    ...      .where(FilterPred(((0, "gt", 10),)))
    ...      .group_by(GroupKey(1, mod=8), 8, agg_cols=[0]))
    >>> print(q.explain())
    >>> out = q.run()
    """

    _SPILL_HARD_MAX = 1 << 24   # the sorted spill's own bound (ENOMEM)
    _WORKER_OPS = ("aggregate", "group_by", "top_k", "select", "star")

    def __init__(self, source, schema: HeapSchema, *,
                 stripe_chunk_size: int = 512 << 10, workers: int = 0):
        if isinstance(source, os.PathLike):
            source = str(source)
        elif isinstance(source, (list, tuple)):
            source = [str(p) for p in source]
        elif not isinstance(source, str) and not hasattr(source, "size"):
            raise StromError(_errno.EINVAL, "Query takes a heap table path, "
                                            "a list of paths (a stripe set) "
                                            "or an open Source")
        self.source = source
        self.schema = schema
        self._stripe_chunk = stripe_chunk_size
        self._workers = int(workers)   # >= 2: worker processes
        self._terms: tuple = ()
        self._callables: List[Callable] = []
        self._trees: List[tuple] = []  # picklable SQL predicate trees
        self._opaque = False           # a where() callable without a tree
        self._op = "aggregate"
        self._terminal_set = False
        self._agg_cols: Optional[Sequence[int]] = None
        self._group: Optional[tuple] = None
        self._group_cols: Optional[tuple] = None
        self._gk_decode: Optional[Callable] = None
        self._select: Optional[tuple] = None
        self._topk: Optional[tuple] = None
        self._order: Optional[tuple] = None
        self._quantiles: Optional[List[float]] = None
        # (probe_col, build keys, build values, materialize, limit, offset)
        self._join: Optional[tuple] = None
        self._join_how = "inner"
        # on-disk build side: (table, schema, key_col, value_col)
        self._join_src: Optional[tuple] = None
        self._agg_exprs: Optional[list] = None
        self._star: Optional[dict] = None
        self._star_resolved: Optional[list] = None
        self._eq: Optional[tuple] = None     # structured equality (col, v)
        self._range: Optional[tuple] = None  # structured range (col, lo, hi)
        self._in: Optional[tuple] = None     # structured IN (col, members)
        # the where() filters after a structured one: the index path's
        # recheck of the rows it resolves
        self._residual_terms: tuple = ()
        self._residual_calls: List[Callable] = []
        self._prefix_cands: Optional[List[str]] = None
        # state of one run(): the caller's session, a worker's shared
        # cursor and pinned scan ring, and the deepest H2D pipeline its
        # scans reached
        self._session = None
        self._cursor = None
        self._worker_pool = None
        self._h2d_depth = 0
        self._vfs = False              # the run's scans read buffered
        self._ranks = None             # the run's mesh when it spans ranks
        self._mesh_bp = None           # the run's batch_pages

    # -- builders -----------------------------------------------------------
    def where(self, predicate: Union[FilterPred, Callable], *,
              _tree=None) -> "Query":
        """Row filter: a :class:`FilterPred` whose terms carry their values,
        or ``predicate(cols) -> (B, T) bool`` in torch ops (the ``torch``
        route).  Chained filters form a conjunction; FilterPred terms
        concatenate (at most 8).  A term on a nullable column never
        selects a NULL row (SQL: NULL compares unknown); a callable sees
        the NULL masks as ``cols.nulls``.

        After a structured filter (:meth:`where_eq`, :meth:`where_range`,
        :meth:`where_in`) the predicate is also a residual: the scan
        applies the conjunction and the index path rechecks the rows the
        sidecar resolves against it (SQL's Index Cond + Filter), so adding
        a predicate never demotes an index scan to a seqscan.

        ``_tree`` (set by the SQL facade) is the callable's picklable
        condition tree: worker processes rebuild the predicate from it.  A
        callable without one cannot ship to workers."""
        structured = self._index_col() is not None
        if isinstance(predicate, FilterPred):
            if any(v is None for _c, _o, v in predicate.terms):
                raise StromError(_errno.EINVAL, "a Query predicate carries "
                                                "its values (no None terms)")
            self._terms = FilterPred(self._terms + predicate.terms).terms
            if structured:
                self._residual_terms += predicate.terms
        elif callable(predicate):
            self._callables.append(predicate)
            if _tree is not None:
                self._trees.append(_tree)
            else:
                self._opaque = True
            if structured:
                self._residual_calls.append(predicate)
        else:
            raise StromError(_errno.EINVAL, "where() takes a FilterPred or "
                                            "a callable")
        return self

    def _set_structured(self, *, terms=(), calls=(), eq=None, rng=None,
                        members=None) -> None:
        """Install exactly one structured filter as the WHOLE filter: its
        seqscan predicate (*terms*, *calls*) replaces every earlier
        ``where``, the other structured filters clear, and no residual of
        an earlier filter survives into the new one's recheck."""
        self._terms = FilterPred(tuple(terms)).terms
        self._callables = list(calls)
        self._trees = []
        self._opaque = False
        self._eq, self._range, self._in = eq, rng, members
        self._residual_terms = ()
        self._residual_calls = []

    def _never(self, col: int) -> tuple:
        """Terms no row passes (``c >= 1 and c <= 0``; NaN fails both),
        NULL-guarded like any term on *col*."""
        dt = self.schema.col_dtype(col)
        return ((col, "ge", dt.type(1)), (col, "le", dt.type(0)))

    def _check_filter_col(self, col, what: str) -> int:
        if not isinstance(col, (int, np.integer)) \
                or not 0 <= col < self.schema.n_cols:
            raise StromError(_errno.EINVAL, f"{what} column {col} out of "
                                            f"range")
        return int(col)

    @staticmethod
    def _representable(dt: np.dtype, value):
        """The literal as an exact numpy scalar of *dt*, or None when no
        such value exists (non-integral or out of range against an integer
        column: a cast would wrap and change which rows match).  Float
        columns always cast, so ``0.1`` against float32 is the stored
        ``float32(0.1)`` on both access paths."""
        if dt.kind in "iu":
            f = float(value)
            if not np.isfinite(f) or f != int(f):
                return None
            i = int(value)
            info = np.iinfo(dt)
            if not info.min <= i <= info.max:
                return None
            return dt.type(i)
        return dt.type(float(value))

    def where_eq(self, col, value) -> "Query":
        """Structured equality filter ``col == value``, visible to the
        planner: with a fresh sorted sidecar of *col* (:func:`.index.
        build_index`) or a composite one led by *col*, the query runs as an
        index scan reading only the matching pages; without one it
        seqscans with the ``FilterPred`` term (the kernels serve it where
        they take the query).  The literal is normalised to the column
        dtype first (:meth:`_representable`); one that has no exact
        representative matches no row on either path.

        *col* may be a pair ``(c0, c1)`` with *value* a pair ``(v0, v1)``
        (SQL's ``c0 = v0 AND c1 = v1``), one probe of a ``(c0, c1)``
        sidecar."""
        if isinstance(col, (tuple, list)):
            if len(col) != 2 or not isinstance(value, (tuple, list)) \
                    or len(value) != 2:
                raise StromError(_errno.EINVAL, "composite where_eq takes a "
                                                "column PAIR and a value PAIR")
            c0, c1 = (self._check_filter_col(c, "where_eq") for c in col)
            v0 = self._representable(self.schema.col_dtype(c0), value[0])
            v1 = self._representable(self.schema.col_dtype(c1), value[1])
            if v0 is None or v1 is None:
                self._set_structured(terms=self._never(c0),
                                     eq=((c0, c1), None))
            else:
                self._set_structured(terms=((c0, "eq", v0), (c1, "eq", v1)),
                                     eq=((c0, c1), (v0, v1)))
            return self
        col = self._check_filter_col(col, "where_eq")
        v = self._representable(self.schema.col_dtype(col), value)
        if v is None:
            self._set_structured(terms=self._never(col), eq=(col, None))
        else:
            self._set_structured(terms=((col, "eq", v),), eq=(col, v))
        return self

    def where_in(self, col: int, values) -> "Query":
        """Structured membership filter ``col IN values``, visible to the
        planner like :meth:`where_eq` (the sidecar resolves every member).
        Members with no exact representative in the column dtype, and NaN
        members, match no row and drop out; no member left matches no row.
        The seqscan predicate is a callable (``torch.isin``): no kernel
        takes a list of values."""
        col = self._check_filter_col(col, "where_in")
        dt = self.schema.col_dtype(col)
        reps = [self._representable(dt, v) for v in values]
        members = np.unique(np.array([r for r in reps if r is not None],
                                     dt))
        if dt.kind == "f":
            members = members[~np.isnan(members)]
        if len(members) == 0:
            self._set_structured(terms=self._never(col),
                                 members=(col, members))
            return self
        # the decoded form of the column: uint32 decodes as int64
        dec = members.astype(np.int64) if dt == np.dtype(np.uint32) \
            else members
        nullable = self.schema.col_nullable(col)
        on_dev = {}

        def isin(cols):
            v = cols[col]
            m = on_dev.get(v.device)
            if m is None:
                m = on_dev[v.device] = torch.from_numpy(dec).to(v.device)
            sel = torch.isin(v, m)
            return sel & ~cols.nulls[col] if nullable else sel

        self._set_structured(calls=[isin], members=(col, members))
        return self

    def where_range(self, col: int, lo=None, hi=None) -> "Query":
        """Structured range filter ``lo <= col <= hi`` (either bound None
        for open-ended), visible to the planner like :meth:`where_eq`.
        Bounds are normalised so the sidecar's searchsorted and the
        seqscan's terms agree: cast to the column dtype on a float column;
        on an integer column a fractional bound tightens (7.5 means ">= 8"
        or "<= 7") and a bound outside the dtype clamps to open, or to "no
        row" where nothing can pass it.  NaN rows never match."""
        col = self._check_filter_col(col, "where_range")
        if lo is None and hi is None:
            raise StromError(_errno.EINVAL, "where_range needs at least one "
                                            "bound")
        dt = self.schema.col_dtype(col)
        never = False
        if dt.kind == "f":
            nlo = None if lo is None else dt.type(float(lo))
            nhi = None if hi is None else dt.type(float(hi))
        else:
            info = np.iinfo(dt)
            nlo = nhi = None
            if lo is not None:
                if float(lo) > info.max:
                    never = True           # nothing can be >= lo
                else:
                    ilo = int(math.ceil(float(lo)))
                    if ilo > info.min:
                        nlo = dt.type(min(ilo, info.max))
            if hi is not None and not never:
                if float(hi) < info.min:
                    never = True           # nothing can be <= hi
                else:
                    ihi = int(math.floor(float(hi)))
                    if ihi < info.max:
                        nhi = dt.type(max(ihi, info.min))
        if never:
            # an empty range encodes "never": lo > hi on both paths
            nlo, nhi = dt.type(1), dt.type(0)
        terms = []
        if nlo is not None:
            terms.append((col, "ge", nlo))
        if nhi is not None:
            terms.append((col, "le", nhi))
        if not terms:
            # both bounds clamped open: every non-NULL row (the term keeps
            # the NULL guard)
            terms.append((col, "ge", dt.type(np.iinfo(dt).min)))
        self._set_structured(terms=terms, rng=(col, nlo, nhi))
        return self

    def _require_no_terminal(self) -> None:
        if self._terminal_set:
            raise StromError(_errno.EINVAL, "one terminal operator per query "
                                            "(it is one scan node)")

    def _terminal(self, op: str) -> None:
        self._require_no_terminal()
        self._op = op
        self._terminal_set = True

    def aggregate(self, cols: Optional[Sequence[int]] = None) -> "Query":
        """Terminal: selected-row count + per-column masked sums (of *cols*,
        in that order; all columns when None).  Nullable columns skip
        their NULL rows and add ``nncounts``, their non-NULL counts; int64
        and float64 columns sum in 64 bits."""
        self._terminal("aggregate")
        self._agg_cols = None if cols is None else [int(c) for c in cols]
        return self

    def group_by(self, key: Union[GroupKey, Callable], n_groups: int, *,
                 agg_cols: Optional[Sequence[int]] = None,
                 having: Optional[Callable] = None) -> "Query":
        """Terminal: per-group count/sum/min/max/avg/var/stddev.  *key* is
        a :class:`GroupKey` or ``key(cols) -> (B, T)`` ids (the ``torch``
        route); ids outside ``[0, n_groups)`` fall into no group.

        ``having(groups) -> (G,) bool`` filters groups after aggregation
        (SQL HAVING) on the finished numpy result; surviving groups are
        compressed out, their ids in ``"groups"``."""
        self._terminal("group_by")
        self._group = (key, int(n_groups), agg_cols, having)
        return self

    def group_by_cols(self, key_cols, *,
                      agg_cols: Optional[Sequence[int]] = None,
                      having: Optional[Callable] = None,
                      max_groups: int = 1 << 16) -> "Query":
        """Terminal: SQL ``GROUP BY col[, col2, ...]`` over column VALUES.
        Two passes: the sorted distinct key set is discovered first (from
        a fresh sidecar of :mod:`.index` on exactly the key columns with no
        table I/O, else by one projection scan), then the GROUP BY runs on
        the ``torch`` route with ``searchsorted`` key ids over it.

        Result: :meth:`group_by`'s plus ``key_cols``, one array per key
        column aligned with the surviving groups.  Groups that select no
        row are dropped; *having* then filters.  One to four non-null
        4-byte integer key columns.  Past *max_groups* distinct keys, 1-2
        key columns take the sorted spill (sort, then segment-reduce on
        the host, footprint O(distinct keys)); 3-4 fail with ENOMEM."""
        self._require_no_terminal()
        cols_ = [int(c) for c in (key_cols if isinstance(
            key_cols, (tuple, list)) else [key_cols])]
        if not 1 <= len(cols_) <= 4:
            raise StromError(_errno.EINVAL, "group_by_cols takes 1-4 key "
                                            "columns")
        for c in cols_:
            if not 0 <= c < self.schema.n_cols:
                raise StromError(_errno.EINVAL, f"group_by_cols column {c} "
                                                f"out of range")
            dt = self.schema.col_dtype(c)
            if dt.kind not in "iu" or dt.itemsize != 4:
                raise StromError(_errno.EINVAL, "group_by_cols keys must be "
                                                "4-byte integer columns")
            if self.schema.col_nullable(c):
                raise StromError(_errno.EINVAL, f"group_by_cols: c{c} is "
                                                f"nullable (NULL group keys "
                                                f"are outside this subset)")
        if max_groups < 1:
            raise StromError(_errno.EINVAL, "max_groups must be >= 1")
        self._terminal("group_by")
        self._group = (None, 0, agg_cols, None)   # keys come at run()
        self._group_cols = (cols_, agg_cols, having, int(max_groups))
        return self

    def select(self, cols: Optional[Sequence[int]] = None, *,
               limit: Optional[int] = None, offset: int = 0) -> "Query":
        """Terminal: the selected rows themselves — ``{"col<c>": values,
        "null<c>": NULL masks (nullable columns), "positions", "count"}``
        in physical arrival order.  ``cols=None`` projects every column;
        ``limit`` stops the scan's reads once ``offset + limit`` rows are
        gathered."""
        if limit is not None and limit < 0:
            raise StromError(_errno.EINVAL, "select limit must be >= 0")
        if offset < 0:
            raise StromError(_errno.EINVAL, "select offset must be >= 0")
        self._terminal("select")
        self._select = (None if cols is None else [int(c) for c in cols],
                        limit, int(offset))
        return self

    def top_k(self, col: int, k: int, *, largest: bool = True) -> "Query":
        """Terminal: the *k* best values of *col* and their global row
        positions (``{"values", "positions"}``; fewer rows pad with the
        dtype's worst value at position -1)."""
        self._require_no_terminal()
        if 0 <= int(col) < self.schema.n_cols:
            if self.schema.col_nullable(int(col)):
                raise StromError(_errno.EINVAL, f"top_k over the nullable "
                                                f"c{col} is outside this "
                                                f"subset (no NULL ordering)")
            if self.schema.col_dtype(int(col)).itemsize != 4:
                raise StromError(_errno.EINVAL, f"top_k supports 4-byte "
                                                f"columns (c{col} is 8-byte)")
        self._terminal("top_k")
        self._topk = (int(col), int(k), bool(largest))
        return self

    def order_by(self, col, *, descending: bool = False,
                 limit: Optional[int] = None, offset: int = 0) -> "Query":
        """Terminal: the ordering of the selected rows — ``{"values"`` (the
        first column), ``"positions"}``.  *col* may be a sequence (ORDER
        BY c_a, c_b, ...): later columns break ties of earlier ones, then
        arrival order; ``descending`` applies to the whole ordering;
        ``limit``/``offset`` slice it.  The rows gather to the host and
        sort there, as the JAX package's one-device path does."""
        if limit is not None and limit < 0:
            raise StromError(_errno.EINVAL, "order_by limit must be >= 0")
        if offset < 0:
            raise StromError(_errno.EINVAL, "order_by offset must be >= 0")
        cols = [int(col)] if isinstance(col, (int, np.integer)) \
            else [int(c) for c in col]
        if not cols:
            raise StromError(_errno.EINVAL, "order_by needs at least one "
                                            "column")
        self._terminal("order_by")
        self._order = (cols, bool(descending), limit, int(offset))
        return self

    def quantiles(self, col: int, qs: Sequence[float]) -> "Query":
        """Terminal: exact nearest-rank quantiles of *col* over the
        selected rows (``{"quantiles", "n"}``; NaN when none)."""
        qs = [float(q) for q in qs]
        if not qs:
            raise StromError(_errno.EINVAL, "quantiles needs at least one q")
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise StromError(_errno.EINVAL, f"quantile {q} outside "
                                                f"[0, 1]")
        self._terminal("quantiles")
        self._order = ([int(col)], False, None, 0)
        self._quantiles = qs
        return self

    def count_distinct(self, col: int) -> "Query":
        """Terminal: exact COUNT(DISTINCT col) of the selected rows
        (``{"distinct"}``; each float NaN counts as its own value)."""
        self._terminal("count_distinct")
        self._order = ([int(col)], False, None, 0)
        return self

    def join(self, probe_col: int, build_keys, build_values, *,
             materialize: bool = False, limit: Optional[int] = None,
             offset: int = 0, how: str = "inner") -> "Query":
        """Terminal: join against a dimension table in host arrays
        (unique int32 keys, int32/uint32/float32 values).

        *how*: ``"inner"`` (rows with a partner), ``"left"`` (every
        selected row; unpartnered rows carry payload 0 and a False
        ``matched``), ``"semi"`` (EXISTS: partnered rows, no payload) or
        ``"anti"`` (NOT EXISTS).  Every strategy serves every face.

        The aggregate face folds ``matched``, ``sums`` (every fact column),
        ``nncounts`` (each column's non-NULL count, for a schema with a
        nullable column), ``payload_sum`` (inner/left) and ``null_count``
        (left).
        ``materialize=True`` returns the rows: ``{"positions", "keys",
        "count"}`` plus ``payload`` (inner/left) and ``matched`` (left),
        ``limit``/``offset`` slicing them as :meth:`select` does (the
        early stop included)."""
        from ..ops.join import check_join_how
        self._require_no_terminal()
        try:
            check_join_how(how)
        except ValueError as e:
            raise StromError(_errno.EINVAL, str(e)) from None
        if 0 <= int(probe_col) < self.schema.n_cols \
                and self.schema.col_nullable(int(probe_col)):
            raise StromError(_errno.EINVAL, f"join probe column c{probe_col} "
                                            f"is nullable (NULL keys never "
                                            f"match; outside this subset)")
        if limit is not None and limit < 0:
            raise StromError(_errno.EINVAL, "join limit must be >= 0")
        if offset < 0:
            raise StromError(_errno.EINVAL, "join offset must be >= 0")
        if not materialize and (limit is not None or offset):
            # row slicing means something for rows only
            raise StromError(_errno.EINVAL, "join limit/offset require "
                                            "materialize=True")
        self._terminal("join")
        self._join = (int(probe_col), build_keys, build_values,
                      bool(materialize), limit, int(offset))
        self._join_how = how
        return self

    def join_table(self, probe_col: int, build_table, build_schema:
                   HeapSchema, key_col: int, value_col: int, *,
                   materialize: bool = False, limit: Optional[int] = None,
                   offset: int = 0, how: str = "inner") -> "Query":
        """Terminal: :meth:`join` whose build side is a heap table on disk.
        A build that broadcasts (its keys and values fit ``config
        join_broadcast_max``) loads with one projection scan and runs as
        :meth:`join`.  A larger one runs as local Grace passes, one hash
        partition of the build resident a pass, and is never held whole
        on the host above ``config join_build_host_max``: each pass loads
        its partition by a hash-predicate scan of the build table."""
        if isinstance(build_table, os.PathLike):
            build_table = str(build_table)
        # validated before the terminal is claimed: a refused call leaves
        # the query reusable
        for c in (key_col, value_col):
            if not 0 <= int(c) < build_schema.n_cols:
                raise StromError(_errno.EINVAL, f"join_table column {c} out "
                                                f"of range")
        if build_schema.col_dtype(int(key_col)) != _I32:
            raise StromError(_errno.EINVAL, "join_table key column must be "
                                            "int32")
        if build_schema.col_dtype(int(value_col)) not in _VALUE_DTS:
            raise StromError(_errno.EINVAL, "join_table value column must "
                                            "be int32/uint32/float32")
        _check_build_table(build_table, build_schema, "join_table")
        self.join(probe_col, None, None, materialize=materialize,
                  limit=limit, offset=offset, how=how)
        self._join_src = (build_table, build_schema, int(key_col),
                          int(value_col))
        return self

    def aggregate_exprs(self, exprs) -> "Query":
        """Terminal: the selected-row count and masked sums of expression
        trees over fact columns, SQL's ``SUM(c1 * c2)`` (the grammar and
        types of :mod:`.sql`): ``{"count", "esums": [one scalar per
        expression]}``.  Expressions over nullable columns are refused (a
        NULL operand would make the row's value NULL)."""
        self._require_no_terminal()
        exprs = list(exprs)
        if not exprs:
            raise StromError(_errno.EINVAL, "aggregate_exprs needs >= 1 "
                                            "expression")
        self._check_exprs(exprs)
        self._terminal("aggregate")
        self._agg_exprs = exprs
        return self

    def _check_exprs(self, exprs) -> None:
        from .sql import _expr_info
        for e in exprs:
            _dt, cs = _expr_info(e, self.schema)
            for c in sorted(cs):
                if self.schema.col_nullable(c):
                    raise StromError(_errno.EINVAL, f"SQL: expression "
                                                    f"aggregates over the "
                                                    f"nullable c{c} are "
                                                    f"outside this subset "
                                                    f"(NULL propagation)")

    def star_join(self, joins, *, materialize: bool = False,
                  fact_cols: Optional[Sequence[int]] = None,
                  exprs: Optional[Sequence] = None,
                  limit: Optional[int] = None, offset: int = 0) -> "Query":
        """Terminal: probe several dimension tables in one scan pass.

        *joins*: one dict a dimension — ``{"probe_col": fact column (a
        non-nullable int32), "table": heap path, "schema": HeapSchema,
        "key_col": its int32 unique-key column, "value_col": payload column
        or None (semi/anti take none), "how": inner|left|semi|anti}``.
        Every dimension must fit ``config join_broadcast_max`` (EINVAL
        otherwise): each loads once and is probed as a sorted broadcast
        table.

        Aggregate face: ``count``, ``sums`` (every fact column),
        ``nncounts``, ``pay_sums`` (per dimension, over emitted partnered
        rows), ``null_counts`` (per dimension, emitted unpartnered rows)
        and ``esums`` for *exprs* (the :meth:`aggregate_exprs` grammar).
        ``materialize=True`` returns the rows: the *fact_cols* (``c<c>``),
        per dimension its payload (``pay<i>``) and partner mask (``m<i>``),
        ``positions`` and ``count``, sliced by ``limit``/``offset``."""
        from ..config import config
        from ..ops.join import check_join_how
        self._require_no_terminal()
        joins = [dict(j) for j in joins]
        if not joins:
            raise StromError(_errno.EINVAL, "star_join needs >= 1 dimension")
        cap = int(config.get("join_broadcast_max"))
        for j in joins:
            try:
                check_join_how(j.get("how", "inner"))
            except ValueError as e:
                raise StromError(_errno.EINVAL, str(e)) from None
            j.setdefault("how", "inner")
            pc = int(j["probe_col"])
            if not 0 <= pc < self.schema.n_cols:
                raise StromError(_errno.EINVAL, f"star_join probe column "
                                                f"{pc} out of range")
            if self.schema.col_dtype(pc) != _I32 \
                    or self.schema.col_nullable(pc):
                raise StromError(_errno.EINVAL, "star_join probe columns "
                                                "must be non-nullable int32")
            j["probe_col"] = pc
            bs = j["schema"]
            if isinstance(j["table"], os.PathLike):
                j["table"] = str(j["table"])
            kc, vc = int(j["key_col"]), j.get("value_col")
            if not 0 <= kc < bs.n_cols:
                raise StromError(_errno.EINVAL, f"star_join key column {kc} "
                                                f"out of range")
            if bs.col_dtype(kc) != _I32:
                raise StromError(_errno.EINVAL, "star_join key columns must "
                                                "be int32")
            j["key_col"] = kc
            if vc is not None:
                vc = int(vc)
                if not 0 <= vc < bs.n_cols:
                    raise StromError(_errno.EINVAL, f"star_join value column "
                                                    f"{vc} out of range")
                if bs.col_dtype(vc) not in _VALUE_DTS:
                    raise StromError(_errno.EINVAL, "star_join value columns "
                                                    "must be int32/uint32/"
                                                    "float32")
                if j["how"] in ("semi", "anti"):
                    raise StromError(_errno.EINVAL, f"star_join: {j['how']} "
                                                    f"dimensions expose no "
                                                    f"payload (EXISTS "
                                                    f"semantics)")
            j["value_col"] = vc
            _check_build_table(j["table"], bs, "star_join")
            rows = (os.path.getsize(j["table"]) // PAGE_SIZE) \
                * bs.tuples_per_page
            if rows * 8 > cap:
                raise StromError(_errno.EINVAL, f"star_join: dimension "
                                                f"{j['table']} (~{rows} rows)"
                                                f" is above "
                                                f"join_broadcast_max — join "
                                                f"it singly (the partitioned "
                                                f"path)")
        exprs = list(exprs or [])
        self._check_exprs(exprs)
        if materialize:
            if limit is not None and limit < 0:
                raise StromError(_errno.EINVAL, "star_join limit must be "
                                                ">= 0")
            if offset < 0:
                raise StromError(_errno.EINVAL, "star_join offset must be "
                                                ">= 0")
            fact_cols = [int(c) for c in (fact_cols or [])]
            for c in fact_cols:
                if not 0 <= c < self.schema.n_cols:
                    raise StromError(_errno.EINVAL, f"star_join fact column "
                                                    f"{c} out of range")
        elif limit is not None or offset:
            raise StromError(_errno.EINVAL, "star_join limit/offset require "
                                            "materialize=True")
        self._terminal("star")
        self._star = {"joins": joins, "materialize": bool(materialize),
                      "fact_cols": list(fact_cols or []), "exprs": exprs,
                      "limit": limit, "offset": int(offset)}
        self._star_resolved = None
        return self

    # -- planning -----------------------------------------------------------
    def _null_guard(self, pred: FilterPred):
        """SQL comparison semantics on nullable columns: NULL cmp x is
        never true.  The FilterPred, or ``(cols, th) -> mask`` that also
        drops the NULL rows of every nullable column a term reads (their
        stored word is 0, which a bare ``col == 0`` would select)."""
        nn = sorted({c for c, _o, _v in pred.terms
                     if c < self.schema.n_cols
                     and self.schema.col_nullable(c)})
        if not nn:
            return pred
        schema = self.schema

        def guarded(cols, threshold):
            sel = pred.mask(cols, torch.ones(cols[0].shape, dtype=torch.bool,
                                             device=cols[0].device),
                            schema, threshold)
            for c in nn:
                sel = sel & ~cols.nulls[c]
            return sel
        return guarded

    def _predicate(self, terms: Optional[tuple] = None,
                   calls: Optional[list] = None):
        """The conjunction of *terms* and *calls* (the query's whole
        filter by default): a FilterPred, or a callable ``(cols, th)``
        when a callable joined it or a term needs its NULL guard."""
        terms = self._terms if terms is None else terms
        calls = list(self._callables if calls is None else calls)
        pred = self._null_guard(FilterPred(terms))
        if not calls:
            return pred
        schema = self.schema

        def conj(cols, threshold):
            sel = select_rows(pred, cols, torch.ones(
                cols[0].shape, dtype=torch.bool, device=cols[0].device),
                schema, threshold)
            for fn in calls:
                sel = sel & fn(cols)
            return sel
        return conj

    def _key(self):
        key = self._group[0]
        if isinstance(key, GroupKey) or self._group_cols is not None:
            return key          # a value-keyed key is (cols, th) already
        return lambda cols, _threshold: key(cols)

    def _check_sortable_col(self, col: int, opname: str) -> np.dtype:
        if not 0 <= col < self.schema.n_cols:
            raise StromError(_errno.EINVAL, f"{opname} column {col} out of "
                                            f"range")
        dt = self.schema.col_dtype(col)
        if dt not in _SORTABLE:
            raise StromError(_errno.EINVAL, f"{opname} supports int32/uint32"
                                            f"/float32 columns (got {dt})")
        if self.schema.col_nullable(col):
            raise StromError(_errno.EINVAL, f"{opname} over the nullable "
                                            f"c{col} is outside this subset "
                                            f"(no NULL ordering)")
        return dt

    def _invalid(self) -> str:
        """Why the query cannot run at all ('' = it can)."""
        s = self.schema
        if s.n_cols == 0:
            return "a schema without columns"
        try:
            FilterPred(self._terms).values(s, 0)
            if self._op == "group_by":
                key, g, agg, _having = self._group
                _check_agg_cols(s, agg)
                if self._group_cols is None:
                    if isinstance(key, GroupKey):
                        key.check(s)
                    elif not callable(key):
                        return "the key is a GroupKey or a callable"
                    if g < 1:
                        return f"n_groups {g}: at least 1"
            elif self._op in ("order_by", "quantiles", "count_distinct"):
                for c in self._order[0]:
                    self._check_sortable_col(c, self._op)
        except StromError as e:
            return str(e)
        if self._op == "join":
            pc = self._join[0]
            if not 0 <= pc < s.n_cols:
                return (f"join probe column {pc} out of range (schema has "
                        f"{s.n_cols})")
            if s.col_dtype(pc) != _I32:
                return f"join probe column c{pc} must be int32"
            if self._join_src is None and len(np.unique(
                    self._join[1])) != len(self._join[1]):
                return "join build_keys must be unique (a dimension key)"
        bad = []
        if self._op == "aggregate" and self._agg_cols is not None:
            bad = [c for c in self._agg_cols if not 0 <= c < s.n_cols]
        elif self._op == "select":
            bad = [c for c in (self._select[0] or [])
                   if not 0 <= c < s.n_cols]
        elif self._op == "top_k" and not 0 <= self._topk[0] < s.n_cols:
            bad = [self._topk[0]]
        if bad:
            return (f"{self._op} column {bad[0]} out of range (schema has "
                    f"{s.n_cols})")
        return ""

    def _cuda_refusal(self, probe=None) -> str:
        """Why the CUDA kernels cannot run this query ('' = they can)."""
        from ..ops import decode_cuda, filter_cuda, groupby_cuda
        if self._op == "join":
            return ("a join (searchsorted probes of a sorted build): no CUDA "
                    "kernel computes it")
        if self._op == "star":
            return ("a star join (searchsorted probes of each dimension): no "
                    "CUDA kernel computes it")
        if self._agg_exprs is not None:
            return "expression aggregates: no CUDA kernel computes them"
        if self._op in _ROW_OPS:
            return (f"{self._op} is a row/order terminal: no CUDA kernel "
                    f"computes it")
        if self._group_cols is not None:
            return ("value-keyed GROUP BY: the discovered key table is not "
                    "a GroupKey the B3 kernel takes")
        pred = FilterPred(self._terms) if not self._callables \
            else self._predicate()
        if self._op == "group_by":
            key, g, _agg, _having = self._group
            return groupby_cuda.kernel_refusal(self.schema, key, g, pred)
        if probe is not None and probe[0].mode == "chip":
            return decode_cuda.kernel_refusal(probe[1], pred)
        return filter_cuda.kernel_refusal(self.schema, pred)

    def _pushdown_need_cols(self):
        """Columns the packed scan must expand: the aggregate projection
        when no predicate reads other columns, else all."""
        if not self._terms and not self._callables \
                and self._agg_cols is not None:
            return tuple(self._agg_cols)
        return None

    def _pushdown_probe(self):
        """``(PushdownDecision, PackedMeta)`` when a fresh packed sidecar
        can serve this aggregate (4-byte non-null layout), else None."""
        if self._op != "aggregate" or self._agg_exprs is not None \
                or not isinstance(self.source, str) \
                or self.schema.has_wide or any(self.schema.nullable or ()):
            return None
        from .colpack import probe_packed
        meta = probe_packed(self.source)
        if meta is None:
            return None
        from .planner import decide_pushdown
        return decide_pushdown(meta, self._pushdown_need_cols()), meta

    def _cuda_reason(self) -> str:
        if self._op == "group_by":
            return (f"GROUP BY into {self._group[1]} groups: B3 "
                    f"groupby_pages (csrc/groupby.cu, shared-memory group "
                    f"accumulators)")
        return ("aggregate: B1 filter_pages (csrc/filter.cu, fused decode + "
                "predicate + masked sums)")

    def _torch_reason(self) -> str:
        if self._op == "star":
            n = len(self._star["joins"])
            face = "row materialization" if self._star["materialize"] \
                else "additive aggregate"
            return (f"star join: {n} broadcast dimension"
                    f"{'s' if n != 1 else ''} probed per batch (sorted "
                    f"searchsorted probes), {face} face")
        if self._op == "join":
            face = "row materialization" if self._join[3] \
                else "additive aggregate"
            return (f"join: the sorted build probed by searchsorted per "
                    f"batch, {face} face")
        if self._agg_exprs is not None:
            return (f"{len(self._agg_exprs)} expression aggregate(s): "
                    f"elementwise + masked sums")
        if self._group_cols is not None:
            return ("value-keyed GROUP BY: the distinct keys discovered "
                    "first (a fresh sidecar's keys at zero table I/O, else "
                    "one projection scan), then searchsorted key ids; past "
                    "max_groups a sorted spill; empty groups dropped")
        if self._op == "group_by":
            return (f"GROUP BY into {self._group[1]} groups: decode + "
                    f"bincount/index_add/scatter_reduce")
        if self._op == "aggregate":
            return "aggregate: decode + predicate + masked sums"
        if self._op == "select":
            return ("row materialization: decode + mask-compress gather, "
                    "rows return to the host in arrival order")
        if self._op == "top_k":
            return "top_k: per-batch stable-sort selection, folded"
        return (f"{self._op}: decode + gather, then the host sort of the "
                f"JAX package's one-device path")

    def explain(self, *, device=None, kernel: str = "auto",
                mesh=None) -> QueryPlan:
        """The plan ``run(device=..., kernel=..., mesh=...)`` would
        execute.  Under a mesh the query runs on the members' device and
        always scans (no sidecar, no packed pushdown); with the Query's
        ``workers=`` the workers scan too, direct through their shared
        cursor, as the reference's workers do."""
        from ..hbm.staging import resolve_device
        dev = mesh.home() if mesh is not None else resolve_device(device)
        return self._plan(dev, kernel, mesh, self._workers)

    # -- the source and its access path -------------------------------------
    def _source_facts(self):
        """``(file the planner probes, table bytes)``: the table file; a
        stripe set's first member and the set's bytes; a live Source's
        ``path``, or for a multi-file one its first member's (None when
        it has neither), and its size."""
        if isinstance(self.source, str):
            return self.source, os.path.getsize(self.source)
        if isinstance(self.source, list):
            return self.source[0], sum(os.path.getsize(p)
                                       for p in self.source)
        members = getattr(self.source, "members", None)
        probe = members[0].path if members \
            else getattr(self.source, "path", None)
        return probe, self.source.size

    @contextlib.contextmanager
    def _open_owned(self):
        """The table as an open Source: a live Source as the caller gave
        it (never closed here), else one opened for the block and closed
        after it — a list as a RAID-0 stripe set at the query's
        ``stripe_chunk_size``."""
        from ..engine import open_source
        if hasattr(self.source, "size"):
            yield self.source
            return
        src = open_source(self.source, stripe_chunk_size=self._stripe_chunk) \
            if isinstance(self.source, list) else open_source(self.source)
        try:
            yield src
        finally:
            src.close()

    def _scan_access(self):
        """``(access path, reason)`` of a scan by the planner's gate
        (:func:`.planner.should_use_direct_scan`): ``direct`` for a table
        at or above the direct-scan threshold on a direct-load capable
        file (or any such table under ``debug_no_threshold``), else
        ``vfs``, the page cache; a source with no file to probe is
        ``vfs``.  The reasons are the reference's."""
        from .planner import capability_cache, should_use_direct_scan
        path, size = self._source_facts()
        if path is not None and should_use_direct_scan(path,
                                                       table_size=size):
            return "direct", ("table above the direct-scan threshold and "
                              "backing eligible")
        info = capability_cache.probe(path) if path else None
        if info is not None and not info.supported:
            return "vfs", "source not direct-load capable (CHECK_FILE)"
        return "vfs", ("table below the direct-scan threshold (page cache "
                       "wins for small tables)")

    def _residency(self, why: str):
        """``(RAM-tier ratio, HBM-tier ratio, why)``: the fraction of the
        table's bytes each tier holds (the expected hit ratio of a scan;
        a Session looks in HBM first) and *why* with the reference's
        suffixes (``scan/query.py:1610-1657``)."""
        from ..tiering import extent_space
        ratio = hbm_ratio = 0.0
        path, size = self._source_facts()
        if extent_space.lookup_active and size:
            if isinstance(self.source, list):
                paths = list(self.source)
            elif isinstance(self.source, str):
                paths = [self.source]
            else:
                members = getattr(self.source, "members", None)
                paths = [m.path for m in members] if members \
                    else ([path] if path else [])
            fr = extent_space.resident_fraction(paths, size)
            ratio, hbm_ratio = fr.get("ram", 0.0), fr.get("hbm", 0.0)
        if hbm_ratio > 0:
            why += (f"; hbm tier holds ~{hbm_ratio:.0%} of the table "
                    f"(device hits, checked before the host tier)")
        if ratio >= 1.0:
            why += ("; fully cache-resident: served from the residency "
                    "tier, engine submission skipped")
        elif ratio > 0:
            why += (f"; residency tier holds ~{ratio:.0%} of the table "
                    f"(memcpy hits, no mincore probe)")
        return round(ratio, 4), round(hbm_ratio, 4), why

    def _plan(self, dev: torch.device, kernel: str, mesh,
              workers: int) -> QueryPlan:
        from .planner import _parallel_divisor, cost_direct_scan, \
            cost_vfs_scan
        if kernel not in _KERNELS:
            raise StromError(_errno.EINVAL, f"kernel {kernel!r} not one of "
                                            f"{_KERNELS}")
        mode = "local" if mesh is None else "mesh"
        nw = workers if workers >= 2 and mesh is None else 0
        n_pages = self._source_facts()[1] // PAGE_SIZE
        access, access_why = self._scan_access()
        n_tuples = n_pages * self.schema.tuples_per_page
        ratio, hbm_ratio, access_why = self._residency(access_why)
        costs = dict(mode=mode, workers=nw,
                     cost_direct=cost_direct_scan(n_pages, n_tuples,
                                                  workers=nw).total,
                     cost_vfs=cost_vfs_scan(n_pages, n_tuples,
                                            workers=nw).total,
                     cache_hit_ratio=ratio, hbm_hit_ratio=hbm_ratio)
        cuda = dev.type == "cuda"
        why = self._invalid()
        if not why and kernel == "cuda" and not cuda:
            why = "the CUDA kernels need a CUDA device"
        # the index branches plan only a query that is otherwise valid and
        # local; a sidecar-served plan reads no packed sidecar
        scan_only = mode == "mesh" or nw
        index_why = None if why or scan_only else self._index_plan()
        probe = None if why or index_why or scan_only \
            else self._pushdown_probe()
        refusal = self._cuda_refusal(probe) if cuda and not why else ""
        if kernel == "cuda" and refusal:
            why = (f"kernel='cuda': {refusal}; kernel='auto' or 'torch' "
                   f"runs it in PyTorch ops")
        js = self._join_strategy() if self._op == "join" else None
        if why:
            return QueryPlan(self._op, "invalid", str(dev), n_pages,
                             f"{access_why}; {why}",
                             join_strategy=js and js[0],
                             access_path=access, **costs)
        auto_why = ""
        if cuda and kernel == "auto" and not refusal \
                and self._op == "group_by" and self._group_cols is None:
            # the measured route (reference scan/query.py:1280-1290): float
            # aggregation leaves B3 where the torch route is faster on the
            # card
            agg_dt = _check_agg_cols(self.schema, self._group[2])[1]
            gk, gwhy = groupby_kernel_auto(agg_dt.kind)
            if gk == "torch":
                auto_why = gwhy
        if cuda and kernel != "torch" and not refusal and not auto_why:
            face, reason = "cuda", self._cuda_reason()
        elif auto_why:
            face = "torch"
            reason = f"{self._torch_reason()}; PyTorch ops on {dev} " \
                     f"({auto_why})"
        else:
            face = "torch"
            reason = f"{self._torch_reason()}; PyTorch ops on {dev}"
            if refusal:
                reason += f" (the CUDA kernels refuse it: {refusal})"
            elif cuda:
                reason += " (kernel='torch')"
        pd = ""
        if probe is not None:
            dec, _meta = probe
            pd = dec.mode
            reason += "; " + dec.explain()
            if pd == "chip":
                reason += ("; the packed pages decode in B2 "
                           "decode_filter_pages (csrc/decode.cu)"
                           if face == "cuda" else
                           "; the packed pages decode in PyTorch ops")
        if js is not None:
            reason += (f"; join type {self._join_how}; "
                       f"{self._strategy_text(js, mesh)}")
        if mesh is not None:
            ranks = mesh.multi_process
            gathers = ("each rank gathers its own members' rows and the "
                       "ranks' rows meet in scan order" if ranks else
                       "the rows gather on the first member")
            reason += f"; mesh of {mesh.size} members {mesh.shape} on " \
                      f"{dev}" + (f" over {len(set(mesh.owners))} ranks"
                                  if ranks else "") + ": " + (
                f"{gathers}, then the distributed sample sort (splitter "
                f"election + all_to_all) over every member"
                if self._op in ("order_by", "quantiles", "count_distinct")
                else "each batch's rows route to their key's owner"
                if js is not None and js[1] > 1 else
                ("the row step runs on each member's shard; " + gathers
                 if ranks else "the row face runs on the first member")
                if (self._op == "join" and self._join[3])
                or (self._op == "star" and self._star["materialize"]) else
                ("each member gathers its shard's selected rows"
                 if self._op == "select" else
                 "the step runs on each member's shard and the results "
                 "fold with the operator's combine")
                + "; the pages past the last whole batch scan on the "
                  "first member")
        if nw:
            reason += (f"; parallel: {nw} worker processes claim chunks "
                       f"from ONE shared cursor (per-worker sessions, "
                       f"partials fold on the leader; cost divisor "
                       f"{_parallel_divisor(nw):.1f})")
        if index_why:
            return QueryPlan(self._op, face, str(dev), n_pages,
                             f"{index_why}; the scan's route without the "
                             f"sidecar: {reason}", pd, js and js[0],
                             access_path="index", **costs)
        return QueryPlan(self._op, face, str(dev), n_pages,
                         f"{access_why}; {reason}", pd, js and js[0],
                         access_path=access, **costs)

    # -- the index access paths ---------------------------------------------
    def _index_col(self):
        """The column (or pair) a structured filter targets, or None."""
        for f in (self._eq, self._range, self._in):
            if f is not None:
                return f[0]
        return None

    def _has_residual(self) -> bool:
        return bool(self._residual_terms or self._residual_calls)

    def _order_key(self):
        """(order columns, sidecar key) of the ordered terminal: the one
        derivation explain() and run() share."""
        ocols = [self._topk[0]] if self._op == "top_k" else self._order[0]
        okey = ocols[0] if len(ocols) == 1 else tuple(ocols[:2])
        return ocols, okey

    def _eq_order_combo_path(self) -> Optional[str]:
        """The composite sidecar path serving ``WHERE c0 = v ORDER BY c1``
        (a single-column structured equality, no residual, and an
        ``order_by`` of one other integer column), or None.  A residual
        disqualifies it: the span is read off the sidecar unchecked."""
        if (self._op != "order_by" or self._eq is None
                or self._has_residual()
                or isinstance(self._eq[0], (tuple, list))
                or not isinstance(self.source, str)):
            return None
        oc = self._order[0]
        if len(oc) != 1:
            return None
        ce, c1 = int(self._eq[0]), int(oc[0])
        if ce == c1:
            return None
        for c in (ce, c1):
            if not 0 <= c < self.schema.n_cols \
                    or self.schema.col_dtype(c).kind not in "iu":
                return None
        from .index import index_path_for
        return index_path_for(self.source, (ce, c1))

    def _order_index_path(self) -> Optional[str]:
        """The sidecar path that can serve an unfiltered ordered terminal
        by itself — ``order_by`` (the index order is the answer),
        ``top_k`` (its head or tail), ``quantiles`` (nearest-rank reads),
        ``count_distinct`` (adjacent differences) — over one integer
        column, or the pair of a composite sidecar for ``order_by``.
        Float sidecars leave NaN keys out, so they cannot stand for the
        column's full row set."""
        if (self._op not in ("order_by", "quantiles", "count_distinct",
                             "top_k")
                or self._terms or self._callables
                or not isinstance(self.source, str)):
            return None
        cols, _okey = self._order_key()
        want = (1, 2) if self._op == "order_by" else (1,)
        if len(cols) not in want:
            return None
        for c in cols:
            if not 0 <= c < self.schema.n_cols \
                    or self.schema.col_dtype(c).kind not in "iu":
                return None
        from .index import index_path_for
        return index_path_for(self.source,
                              cols[0] if len(cols) == 1 else tuple(cols))

    def _index_path_candidates(self) -> List[str]:
        """Sidecars that could serve the structured filter, preferred
        first: the filter column's own, then (single-column filters) any
        composite whose FIRST column is the filter column — SQL's
        leftmost-prefix rule.  The directory glob runs once a Query."""
        col = self._index_col()
        if col is None or not isinstance(self.source, str):
            return []
        from .index import index_path_for
        out = [index_path_for(self.source, col)]
        if not isinstance(col, (tuple, list)):
            if self._prefix_cands is None:
                import glob
                import re
                # the table path escaped (metacharacters stay literal),
                # and only the exact .idx<c0>_<c1> shape: never .tmp
                # litter or lookalikes
                pat = glob.escape(self.source) + f".idx{int(col)}_*"
                rx = re.compile(re.escape(self.source)
                                + rf"\.idx{int(col)}_\d+$")
                self._prefix_cands = sorted(p for p in glob.glob(pat)
                                            if rx.fullmatch(p))
            out += self._prefix_cands
        return out

    def _index_fresh_for_eq(self) -> bool:
        """Header-only probe of the candidates (no key load: EXPLAIN stays
        cheap), each validated against its header's column field."""
        from .index import probe_index
        col = self._index_col()
        return any(probe_index(p, self.source, expect_col=col)
                   for p in self._index_path_candidates())

    def _index_for_eq(self):
        """A fresh sidecar serving the structured filter, or None (a
        missing, stale or corrupt one means the scan).  The header is
        authoritative, not the filename: a sidecar built for other
        columns under this name never serves the filter."""
        from .index import open_index
        col = self._index_col()
        want = tuple(col) if isinstance(col, (tuple, list)) else col
        for ipath in self._index_path_candidates():
            try:
                idx = open_index(ipath, table_path=self.source)
            except Exception:       # corrupt sidecars too
                continue
            if idx.col == want or (idx.composite
                                   and not isinstance(want, tuple)
                                   and idx.col[0] == want):
                return idx
        return None

    def _index_runs(self) -> bool:
        """Whether the structured-filter index runners serve this query:
        expression aggregates never ride the index (they have no fold on
        fetched rows), and a partitioned-sized on-disk join build keeps
        join_table's bounded host memory through the scan's Grace
        passes."""
        if self._op not in ("select", "aggregate", "top_k", "quantiles",
                            "count_distinct", "group_by", "join"):
            return False
        if self._agg_exprs is not None:
            return False
        return not (self._op == "join" and self._join_src is not None
                    and self._join_strategy()[1] > 1)

    def _index_plan(self) -> str:
        """The index reason of EXPLAIN, or '' when no sidecar serves the
        query: the composite span of ``WHERE c0 = v ORDER BY c1``, an
        ordered terminal read off the sidecar, or the structured filter's
        index scan."""
        from .index import probe_index
        comb = self._eq_order_combo_path()
        if comb is not None and self._eq[1] is not None:
            ce, oc = int(self._eq[0]), int(self._order[0][0])
            if probe_index(comb, self.source, expect_col=(ce, oc)):
                return (f"fresh composite index on col({ce}, {oc}): WHERE "
                        f"col{ce} = ... ORDER BY col{oc} is ONE "
                        f"pinned-prefix span of the sidecar (keys within "
                        f"the prefix are already in col{oc} order) — no "
                        f"sort, no table I/O")
        oip = self._order_index_path()
        if oip is not None:
            ocols, okey = self._order_key()
            # exact header match, no prefix: these terminals read the
            # keys as values
            if probe_index(oip, self.source, expect_col=okey,
                           allow_prefix=False):
                what = {
                    "order_by": "the sorted order IS the index order — "
                                "positions read from the sidecar, no "
                                "sort, and LIMIT reads only the head",
                    "quantiles": "nearest-rank reads of the sorted "
                                 "sidecar keys — no table I/O at all",
                    "count_distinct": "adjacent-diff over the sorted "
                                      "sidecar keys — no table I/O at all",
                    "top_k": "the k best keys are the sidecar's "
                             "head/tail — no scan, no table I/O",
                }[self._op]
                return f"fresh index on col{ocols}: {what}"
        if not self._index_runs() or not self._index_fresh_for_eq():
            return ""
        if self._eq is not None:
            c, v = self._eq
            cond = f"equality col{c} == {v!r}"
        elif self._in is not None:
            c, members = self._in
            cond = f"membership col{c} IN ({len(members)} values)"
        else:
            c, lo, hi = self._range
            cond = f"range {lo!r} <= col{c} <= {hi!r}"
        recheck = ("" if not self._has_residual() else
                   " + residual filter RECHECKED on index-resolved rows "
                   "(Index Cond + Filter)")
        return (f"fresh index on col{c}: {cond} resolves positions from "
                f"the sidecar and reads only matching pages{recheck}; the "
                f"fetched rows fold in PyTorch ops, no kernel")

    def _join_strategy(self) -> Optional[tuple]:
        """``(label, n_parts)`` of a join: ``("broadcast", 1)`` while the
        build side's keys and values fit ``config join_broadcast_max``,
        else ``("partitioned(N)", N)`` with the partition count that keeps
        the resident build within it."""
        from ..config import config
        if self._join_src is not None:
            # an on-disk build: 8 bytes a row (two 4-byte columns)
            bt, bs, _kc, _vc = self._join_src
            nbytes = (os.path.getsize(bt) // PAGE_SIZE) \
                * bs.tuples_per_page * 8
        else:
            nbytes = np.asarray(self._join[1]).nbytes \
                + np.asarray(self._join[2]).nbytes
        cap = int(config.get("join_broadcast_max"))
        if nbytes <= cap:
            return "broadcast", 1
        n = max(2, -(-nbytes // cap))
        return f"partitioned({n})", n

    def _strategy_text(self, js: tuple, mesh=None) -> str:
        label, n = js
        if n == 1:
            return f"join strategy {label}: the build side on the device " \
                   f"whole"
        text = (f"join strategy {label}: build side above "
                f"join_broadcast_max: " + (
                    f"hash-repartitioned over the mesh dp axis "
                    f"({mesh.dp} partitions), all_to_all row exchange, "
                    f"local sorted-probe" if mesh is not None else
                    f"{n} hash partitions probed as sequential passes "
                    f"(Grace join), resident build bounded to the cap"))
        if self._join_src is not None:
            from ..config import config
            text += "; build side STREAMED from the on-disk table: "
            if os.path.getsize(self._join_src[0]) \
                    <= int(config.get("join_build_host_max")):
                text += ("one projection scan, split by hash on the host "
                         "(the table is within join_build_host_max)")
            else:
                text += (f"one hash-predicate scan a partition, {n} in all "
                         f"(host RAM bounded to a partition: the table is "
                         f"above join_build_host_max)")
        return text

    # -- execution ----------------------------------------------------------
    def _project(self, out: dict) -> dict:
        if self._agg_cols is None or not out:
            return out
        res = {"count": out["count"],
               "sums": [out["sums"][c] for c in self._agg_cols]}
        if "nncounts" in out:
            res["nncounts"] = [out["nncounts"][c] for c in self._agg_cols]
        return res

    def _build_fn(self, face: str):
        """``(fn(pages) -> dict, combine or None)`` over heap pages, on the
        planned route."""
        pred = self._predicate()
        if self._op == "join":
            from ..ops.join import make_join_fn
            probe_col, bk, bv = self._join[:3]
            return make_join_fn(self.schema, probe_col, bk, bv,
                                predicate=pred, how=self._join_how), None
        if self._op == "star":
            from ..ops.join import make_star_fn
            fns, dts = self._expr_parts(self._star["exprs"])
            return make_star_fn(self.schema, self._star_resolved,
                                predicate=pred, expr_fns=fns,
                                expr_dtypes=dts), None
        if self._agg_exprs is not None:
            return self._make_expr_fn(pred), None
        if self._op == "top_k":
            from ..ops.topk import make_topk_fn
            col, k, largest = self._topk
            run = make_topk_fn(self.schema, col, k, largest=largest,
                               predicate=pred)
            return run, run.combine
        if self._op == "group_by":
            _key, g, agg, _having = self._group
            key = self._key()
            if face == "cuda":
                from ..ops.groupby_cuda import groupby_pages_cuda
                return (lambda pages: groupby_pages_cuda(
                    pages, 0, self.schema, key, g, agg_cols=agg,
                    predicate=pred)), combine_groupby
            from ..ops.groupby import make_groupby_fn
            return make_groupby_fn(self.schema, key, g, agg_cols=agg,
                                   predicate=pred), combine_groupby
        if face == "cuda":
            from ..ops.filter import wide_sums
            from ..ops.filter_cuda import filter_pages_cuda
            wide = wide_sums(self.schema)
            return (lambda pages: self._project(
                filter_pages_cuda(pages, 0, self.schema, pred,
                                  wide=wide))), None
        from ..ops.filter import make_filter_fn
        run = make_filter_fn(self.schema, pred)
        return (lambda pages: self._project(run(pages))), None

    def run(self, *, device=None, kernel: str = "auto", mesh=None,
            batch_pages: Optional[int] = None, session=None,
            analyze: bool = False, workers: Optional[int] = None) -> dict:
        """Execute the planned scan and return numpy results.  *device*
        defaults to ``cuda:0`` (ENODEV without a card; ``"cpu"`` runs the
        ``torch`` route on the host); *kernel* is ``"auto"``, ``"cuda"`` or
        ``"torch"`` (see the module docstring).

        *mesh* streams the scan sharded over the mesh's dp axis, on its
        members' device (*device* is not used); *batch_pages* pages make a
        batch, rounded down to a multiple of dp (default 128 pages a dp
        shard).  ``workers=N`` runs N worker processes (default: the
        Query's ``workers``).  *session* is an open
        :class:`..engine.Session` the leader's scans read through.

        ``analyze=True`` adds ``"_analyze"``: the run's ``elapsed_s``,
        ``bytes_direct`` (bytes the engine read), ``requests`` and
        ``avg_dma_bytes``, ``waits`` (tasks reaped by ``memcpy_wait``),
        ``submit_syscalls``, ``kernel_dispatches`` (batch steps the scans
        ran), ``h2d_depth_reached`` (this run's deepest H2D pipeline, 0
        when no scan ran) and ``scan_GBps``.  Workers' counters fold into
        the leader's.

        A *mesh* whose members belong to ranks that no process group
        joins (none is up, or it has fewer ranks) is ENOTCONN: this
        process alone would read only its own members' pages."""
        if mesh is not None and mesh.multi_process:
            from ..parallel import dist
            if max(mesh.owners) >= dist.process_count():
                raise StromError(_errno.ENOTCONN, f"the mesh's members "
                                                  f"belong to ranks "
                                                  f"{sorted(set(mesh.owners))}"
                                                  f" and the process group "
                                                  f"has {dist.process_count()}"
                                                  f" rank(s)")
        if analyze:
            return self._run_analyze(session, device=device, kernel=kernel,
                                     mesh=mesh, batch_pages=batch_pages,
                                     workers=workers)
        from ..hbm.staging import resolve_device
        nw = self._workers if workers is None else int(workers)
        dev = mesh.home() if mesh is not None else resolve_device(device)
        self._session, self._h2d_depth = session, 0
        self._ranks = mesh if mesh is not None and mesh.multi_process \
            else None
        self._mesh_bp = batch_pages
        try:
            if nw >= 2 and mesh is None:
                return self._run_workers(nw, dev, kernel)
            return self._run_local(dev, kernel, mesh, batch_pages)
        finally:
            self._session, self._vfs, self._ranks = None, False, None

    def _run_analyze(self, session, **kw) -> dict:
        """``run(analyze=True)``: the counters before and after the run,
        a caller's session's native counters folded in at both ends (a
        live session keeps them until ``stat_info`` or ``close``)."""
        def fold():
            if session is not None and \
                    getattr(session, "_native", None) is not None:
                session._fold_native_stats()

        fold()
        before = stats.snapshot()
        t0 = time.monotonic()
        out = self.run(session=session, **kw)
        dt = time.monotonic() - t0
        fold()
        after = stats.snapshot()
        d = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("total_dma_length", "nr_submit_dma",
                       "nr_ioctl_memcpy_wait", "nr_enter_dma",
                       "nr_kernel_dispatch")}
        nbytes = int(d["total_dma_length"])
        out["_analyze"] = {
            "elapsed_s": round(dt, 6),
            "bytes_direct": nbytes,
            "requests": int(d["nr_submit_dma"]),
            "avg_dma_bytes": nbytes // max(int(d["nr_submit_dma"]), 1),
            "waits": int(d["nr_ioctl_memcpy_wait"]),
            "submit_syscalls": int(d["nr_enter_dma"]),
            "kernel_dispatches": int(d["nr_kernel_dispatch"]),
            "h2d_depth_reached": int(self._h2d_depth),
            "scan_GBps": round(nbytes / dt / (1 << 30), 3) if dt > 0
            else None,
        }
        return out

    def _run_local(self, dev: torch.device, kernel: str, mesh,
                   batch_pages: Optional[int]) -> dict:
        """One process: the index, pushdown and scan paths, or a mesh."""
        plan = self._plan(dev, kernel, mesh, 0)
        if plan.kernel == "invalid":
            raise StromError(_errno.EINVAL, f"query not executable: "
                                            f"{plan.reason}")
        # the scans of this run (key discovery included) read the table on
        # the planned path; an index plan's scans take the gate's
        self._vfs = (plan.access_path if plan.access_path != "index"
                     else self._scan_access()[0]) == "vfs"
        if self._group_cols is not None:
            try:
                self._install_group_keys(self._discover_group_keys(dev),
                                         dev)
            except _GroupSpill:
                return self._run_groupby_sorted(dev)
        if plan.access_path == "index":
            out = self._run_index(dev)
            if out is not None:
                return out
            plan = self._replan_scan(plan)
        if self._op == "join":
            n_parts = self._join_strategy()[1]
            if n_parts > 1:
                return self._run_join_partitioned(dev, n_parts, mesh,
                                                  batch_pages)
            if self._join_src is not None:
                # a broadcast-sized build on disk: one projection scan,
                # then the host-array join
                self._resolve_join_build(dev)
            if self._join[3]:
                return self._run_join_rows(dev)
        if self._op == "star":
            self._resolve_star_builds(dev)
            if self._star["materialize"]:
                return self._run_star_rows(dev)
        if self._op == "order_by":
            return self._run_order_by(dev, mesh)
        if self._op in ("quantiles", "count_distinct"):
            return self._run_column(dev, mesh)
        if mesh is not None:
            return self._run_mesh(plan, mesh, batch_pages)
        if self._op == "select":
            return self._run_select(dev)
        if plan.pushdown in ("chip", "host"):
            # re-probe: the sidecar may have been retired since EXPLAIN
            probe = self._pushdown_probe()
            if probe is not None and probe[0].mode in ("chip", "host"):
                return self._run_pushdown(probe[0], probe[1], dev,
                                          plan.kernel)
        fn, combine = self._build_fn(plan.kernel)
        return self._finalize(self._scan(fn, dev, combine))

    def _scan(self, fn: Callable, dev: torch.device,
              combine: Optional[Callable] = None,
              path: Optional[str] = None) -> dict:
        """Fold *fn* over a scan of the table (or of *path*, a packed
        sidecar's file or open Source) on *dev*: through the page cache
        when the run planned
        ``vfs`` (:meth:`_vfs_scan`), else the direct scan through the
        run's session, on a worker's shared cursor when the scan is the
        table's; notes the H2D depth reached."""
        from .executor import TableScanner
        if path is not None:
            with TableScanner(path, session=self._session) as sc:
                out = sc.scan_filter(fn, device=dev, combine=combine)
                self._h2d_depth = max(self._h2d_depth, sc.last_h2d_depth)
            return out
        if self._vfs and self._cursor is None:
            return self._vfs_scan(fn, dev, combine)
        with self._open_owned() as src, \
                TableScanner(src, self.schema, session=self._session,
                             cursor=self._cursor,
                             pool=self._worker_pool) as sc:
            out = sc.scan_filter(fn, device=dev, combine=combine)
            self._h2d_depth = max(self._h2d_depth, sc.last_h2d_depth)
        return out

    def _vfs_scan(self, fn: Callable, dev: torch.device,
                  combine: Optional[Callable] = None) -> dict:
        """The buffered scan (the ``vfs`` access path): the table's
        :func:`_buffered_batches` (the reference's grid, so folds, ties and
        row order match its ``vfs`` face), each folded with *fn* and
        *combine* — the same step, kernels included, as the direct path.
        The engine reads nothing, so ``bytes_direct`` stays 0.  *fn* may
        raise :class:`.executor.ScanLimitReached` to stop the scan."""
        from .executor import ScanLimitReached, _to_numpy, fold_results
        acc = None
        with self._open_owned() as src:
            try:
                for pages in _buffered_batches(src, 0, dev):
                    acc = fold_results(acc, fn(pages), combine)
                    stats.add("nr_kernel_dispatch")
            except ScanLimitReached:
                pass
        return {} if acc is None else _to_numpy(acc)

    def _run_mesh(self, plan: QueryPlan, mesh, batch_pages) -> dict:
        """A scan terminal over a ring: whole batches stream sharded over
        the members (:meth:`_mesh_scan`) and the plan's step runs
        on each member's shard (B1/B3 where the plan names ``cuda``), the
        results folded in member order with the operator's combine, so
        ties resolve to the lower position as on one device; over ranks
        each rank folds its own members' shards and the folds meet in rank
        order (:meth:`_fold_ranks`).  Over an ``(sp, dp)`` mesh the step
        runs on lane 0's dp shards: every lane holds the same pages.  The
        pages past the last whole batch are read buffered and scanned on
        the first member.  ``select`` gathers each shard's rows
        (:meth:`_mesh_rows`)."""
        from .executor import _to_numpy, fold_results
        if self._op == "select":
            cols, limit, offset = self._select
            cols = list(range(self.schema.n_cols)) if cols is None else cols
            gather, fields, dtypes = self._make_gather_fn(cols)
            return self._select_result(cols, fields, self._mesh_rows(
                gather, fields, dtypes, mesh, batch_pages, limit, offset))
        fn, combine = self._build_fn(plan.kernel)
        acc = None

        def take(pages, _place):
            """Fold one shard's (or the tail's) step in scan order."""
            nonlocal acc
            acc = fold_results(acc, fn(pages), combine)
            stats.add("nr_kernel_dispatch")

        self._mesh_scan(mesh, take, batch_pages)
        if mesh.multi_process:
            acc = self._fold_ranks(acc, combine)
        return self._finalize({} if not acc else _to_numpy(acc))

    def _mesh_rows(self, gather, fields: Sequence[str], dtypes, mesh,
                   batch_pages, limit: Optional[int] = None,
                   offset: int = 0) -> List[np.ndarray]:
        """The rows *gather* selects, over *mesh*: each member's shards
        gathered with their (batch, member) place (the tail's after every
        batch, on member 0), the places of every rank met in one
        :func:`..parallel.dist.all_gather_object` and sorted, which is the
        one process's scan order, then cut to ``[offset, offset + limit)``.
        A process stops reading once it holds ``offset + limit`` rows of
        its own: the rows it would gather next come after all of them.
        One array a field."""
        from ..parallel import dist
        from .executor import ScanLimitReached
        stop = None if limit is None else offset + limit
        chunks, got = [], 0

        def take(pages, place):
            nonlocal got
            if stop is not None and got >= stop:
                raise ScanLimitReached
            out = gather(pages)
            chunks.append((place, [out[f] for f in fields]))
            got += out["n"]
            stats.add("nr_kernel_dispatch")

        self._mesh_scan(mesh, take, batch_pages)
        if mesh.multi_process:
            chunks = [c for part in dist.all_gather_object(chunks)
                      for c in part]
        chunks.sort(key=lambda c: c[0])
        arrs = [np.concatenate([c[1][i] for c in chunks]) if chunks
                else np.zeros(0, dt) for i, dt in enumerate(dtypes)]
        return [a[offset:stop] for a in arrs]

    def _mesh_scan(self, mesh, take, batch_pages) -> None:
        """Stream the table over *mesh*: whole batches sharded over dp
        (:class:`..parallel.stream.ShardedBatchStream`), ``take(pages,
        place)`` called on each of this process's lane-0 shards in member
        order with ``place = (batch, member)``, then the pages past the
        last whole batch read buffered and taken on member 0 (by its
        rank), each tail batch placed after every whole one.  *take* may
        raise :class:`.executor.ScanLimitReached` to stop this process's
        reads (the stream holds no collective)."""
        from ..parallel.stream import ShardedBatchStream
        from .executor import ScanLimitReached
        n = mesh.dp
        with self._open_owned() as src:
            n_pages = src.size // PAGE_SIZE
            bp = int(batch_pages or (1 << 20) // PAGE_SIZE * n)
            # a multiple of dp, at least a page a dp shard, and no larger
            # than the table; the remainder is the tail below
            bp = min(max(bp // n * n, n), n_pages // n * n)
            n_batches = n_pages // bp if bp >= n else 0
            try:
                if n_batches:
                    with ShardedBatchStream(src, mesh, batch_pages=bp,
                                            session=self._session) as stream:
                        for first, shards in stream:
                            for d, shard in enumerate(shards[:n]):
                                if shard is not None:   # else another rank's
                                    take(shard, (first // bp, d))
                if mesh.is_local(0):
                    for j, pages in enumerate(_buffered_batches(
                            src, n_batches * bp, mesh.home())):
                        take(pages, (n_batches + j, 0))
            except ScanLimitReached:
                pass

    @staticmethod
    def _fold_ranks(acc, combine):
        """Every rank's fold of its own shards, folded in rank order with
        the operator's *combine*: the same result on every rank (one
        :func:`..parallel.dist.all_gather_object`)."""
        from ..parallel import dist
        from .executor import _to_numpy, fold_results
        acc_all = None
        for part in dist.all_gather_object(
                None if acc is None else _to_numpy(acc)):
            if part is not None:
                acc_all = fold_results(acc_all, _to_torch(part), combine)
        return acc_all

    def _replan_scan(self, plan: QueryPlan) -> QueryPlan:
        """The sidecar EXPLAIN promised went away (or went stale or
        corrupt) before run(): the scan on the plan's route, its access
        path chosen afresh by the gate (a large table stays on the direct
        path, a small one reads through the page cache)."""
        access, why = self._scan_access()
        return dataclasses.replace(
            plan, access_path=access,
            reason=plan.reason + f"; the sidecar went away before run(): "
                                 f"{access} scan ({why})")

    def _open_exact(self, path: Optional[str], key):
        """The fresh sidecar at *path* whose header names exactly *key*,
        or None."""
        from .index import open_index
        if path is None:
            return None
        try:
            idx = open_index(path, table_path=self.source)
        except Exception:       # raced away, stale or corrupt
            return None
        return idx if idx.col == key else None

    def _run_index(self, dev) -> Optional[dict]:
        """run()'s index dispatch; None when the sidecar went away between
        EXPLAIN and now (the caller scans instead)."""
        from ..engine import Session
        if self._op == "order_by" and self._eq is not None:
            comb = self._eq_order_combo_path()
            idx = None if comb is None else self._open_exact(
                comb, (int(self._eq[0]), int(self._order[0][0])))
            return None if idx is None else self._run_order_by_prefix(idx)
        if self._op in ("order_by", "quantiles", "count_distinct",
                        "top_k") and self._index_col() is None:
            idx = self._open_exact(self._order_index_path(),
                                   self._order_key()[1])
            if idx is None:
                return None
            return {"order_by": self._run_order_by_indexed,
                    "quantiles": self._run_quantiles_sidecar,
                    "top_k": self._run_topk_sidecar,
                    "count_distinct": self._run_count_distinct_sidecar,
                    }[self._op](idx, dev)
        # one runner an op: an op without one here falls to the (always
        # correct) scan, never to another op's result shape
        runner = {"select": self._run_select_indexed,
                  "top_k": self._run_topk_indexed,
                  "quantiles": self._run_column_indexed,
                  "count_distinct": self._run_column_indexed,
                  "aggregate": self._run_aggregate_indexed,
                  "group_by": self._run_groupby_indexed,
                  "join": self._run_join_indexed,
                  }.get(self._op) if self._index_runs() else None
        idx = None if runner is None else self._index_for_eq()
        if idx is None:
            return None
        # one engine session for every fetch of the run: the caller's, or
        # one opened for it
        if self._session is not None:
            return runner(idx, dev, self._session)
        with Session() as sess:
            return runner(idx, dev, sess)

    def _run_pushdown(self, dec, meta, dev: torch.device, face: str) -> dict:
        """Aggregate over the packed sidecar instead of the heap table.

        ``chip``: the ``.cpk`` pages stream to the device unexpanded and
        the decode-filter expands them there (B2 on the ``cuda`` route),
        so the link carries packed bytes.  ``host``: packed bytes leave
        the disk, expand to heap pages on the host, and the heap filter
        consumes them.  Integer sums are byte-identical to the heap scan on
        both legs.  The whole leg is one ``pushdown_decode`` span."""
        t0 = time.monotonic_ns()
        try:
            return self._run_pushdown_leg(dec, meta, dev, face)
        finally:
            if _trace.active:
                _trace.span("pushdown_decode", t0, time.monotonic_ns(),
                            length=meta.packed_bytes,
                            args={"mode": dec.mode,
                                  "wire_bytes": dec.wire_bytes,
                                  "logical_bytes": dec.logical_bytes})

    def _run_pushdown_leg(self, dec, meta, dev: torch.device,
                          face: str) -> dict:
        from ..engine import open_source
        from .executor import _to_numpy, fold_results
        pred = self._predicate()
        saved = max(meta.logical_bytes / max(meta.packed_bytes, 1) - 1.0,
                    0.0)
        if dec.mode == "chip":
            need = self._pushdown_need_cols()
            if face == "cuda":
                from ..ops.decode_cuda import decode_filter_pages_cuda
                from ..ops.filter import wide_sums
                wide = wide_sums()

                def decode(pages):
                    return decode_filter_pages_cuda(pages, 0, meta, pred,
                                                    need_cols=need,
                                                    wide=wide)
            else:
                from ..ops.decode import make_decode_filter_fn
                decode = make_decode_filter_fn(meta, pred, need_cols=need)

            def fn(pages):
                stats.add("nr_pushdown_decode_chip")
                stats.add("bytes_wire_saved",
                          int(pages.shape[0] * PAGE_SIZE * saved))
                return decode(pages)

            with open_source(meta.path) as psrc:
                _tag_packed(psrc, meta)
                return self._finalize(self._project(
                    self._scan(fn, dev, path=psrc)))
        if face == "cuda":
            from ..ops.filter import wide_sums
            from ..ops.filter_cuda import filter_pages_cuda
            wide = wide_sums(self.schema)

            def heap_filter(pages):
                return filter_pages_cuda(pages, 0, self.schema, pred,
                                         wide=wide)
        else:
            from ..ops.filter import make_filter_fn
            heap_filter = make_filter_fn(self.schema, pred)
        from .colpack import decode_pages_numpy
        from .heap import build_pages
        acc = None
        batch = (8 << 20) // PAGE_SIZE
        with open_source(meta.path) as src:
            _tag_packed(src, meta)
            n_pages = src.size // PAGE_SIZE
            raw = bytearray(batch * PAGE_SIZE)
            for p0 in range(0, n_pages, batch):
                n = min(batch, n_pages - p0)
                view = memoryview(raw)[:n * PAGE_SIZE]
                src.read_buffered(p0 * PAGE_SIZE, view)
                cols, nr = decode_pages_numpy(
                    np.frombuffer(view, np.uint8).reshape(n, PAGE_SIZE), meta)
                stats.add("nr_pushdown_decode_host")
                stats.add("bytes_wire_saved", int(n * PAGE_SIZE * saved))
                if nr == 0:
                    continue
                pages = torch.from_numpy(
                    build_pages(cols, self.schema, checksum=False)).to(dev)
                acc = fold_results(acc, self._project(heap_filter(pages)))
        return self._finalize({} if acc is None else _to_numpy(acc))

    def _finalize(self, out: dict) -> dict:
        """Post-aggregation decoration: for group_by ``avgs`` (sum over
        the non-NULL count), ``vars``/``stds`` (population variance via
        E[x²]−E[x]², NaN for empty groups), all-NULL groups' sums/mins/maxs
        as NaN, HAVING, and ``key_cols`` of a value-keyed GROUP BY; for
        top_k the values back in the column's dtype."""
        if self._op == "top_k" and out:
            dt = self.schema.col_dtype(self._topk[0])
            return {"values": np.asarray(out["values"]).astype(dt),
                    "positions": np.asarray(out["positions"])}
        if self._op != "group_by" or not out:
            return out
        having = self._group[3]
        count = np.asarray(out["count"])
        sums = np.asarray(out["sums"])
        acc_np = acc_dtypes(_check_agg_cols(self.schema, self._group[2])[1],
                            self.schema)[0]
        if sums.dtype.kind in "iu" and sums.dtype != acc_np:
            # x64 uint32 sums: int64 on the device (torch has no uint64
            # arithmetic), uint64 on the host as the reference's
            sums = sums.astype(acc_np)
        nn = np.asarray(out["nncounts"]) if "nncounts" in out else None
        base = nn if nn is not None else count
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = np.maximum(base, 1)
            avgs = np.where(base > 0, sums / denom, np.nan)
        res = {"count": count, "sums": sums,
               "mins": np.asarray(out["mins"]),
               "maxs": np.asarray(out["maxs"]), "avgs": avgs}
        if nn is not None:
            res["nncounts"] = nn
            if (nn == 0).any():
                # all-NULL groups: SQL's NULL MIN/MAX/SUM, not the
                # accumulators' identities
                void = nn == 0
                for k in ("sums", "mins", "maxs"):
                    res[k] = np.where(void, np.nan,
                                      res[k].astype(np.float64))
        sumsqs = np.asarray(out["sumsqs"], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            # clamp: E[x^2]-E[x]^2 can dip epsilon-negative in floats
            vars_ = np.maximum(
                np.where(base > 0, sumsqs / denom - np.square(avgs),
                         np.nan), 0.0)
        res["sumsqs"] = sumsqs
        res["vars"] = vars_
        res["stds"] = np.sqrt(vars_)
        if having is None:
            return res
        mask = np.asarray(having(res)).astype(bool)
        if mask.shape != count.shape:
            raise StromError(_errno.EINVAL, f"having must return a "
                                            f"({len(count)},) bool mask, got "
                                            f"shape {mask.shape}")
        res = {k: (v[mask] if v.ndim == 1 else v[..., mask])
               for k, v in res.items()}
        res["groups"] = np.flatnonzero(mask).astype(np.int32)
        if self._gk_decode is not None:
            res["key_cols"] = self._gk_decode(res["groups"])
        return res

    # -- the gather the row terminals ride on -------------------------------
    def _make_gather_fn(self, cols: Sequence[int],
                        want_positions: bool = True):
        """Per-batch gather of projected columns (and global positions)
        with the query predicate folded in: ``(gather, fields, dtypes)``.
        ``gather(pages)`` compresses the selected rows on the pages' device
        and returns numpy arrays per field plus ``"n"``, the row count:
        ``f<i>`` is ``cols[i]``, ``n<i>`` its NULL mask (nullable columns),
        ``pos`` the positions (last)."""
        pred = self._predicate()
        schema = self.schema
        cols = list(cols)
        fields = [f"f{i}" for i in range(len(cols))]
        dtypes = [schema.col_dtype(c) for c in cols]
        nulls = [i for i, c in enumerate(cols) if schema.col_nullable(c)]
        fields += [f"n{i}" for i in nulls]
        dtypes += [np.dtype(bool)] * len(nulls)
        if want_positions:
            fields.append("pos")
            dtypes.append(np.dtype(np.int64))

        def gather(pages: torch.Tensor) -> dict:
            dcols, valid = decode_pages(pages, schema)
            m = select_rows(pred, dcols, valid, schema).reshape(-1)
            out = {"n": int(m.sum())}
            for i, c in enumerate(cols):
                out[f"f{i}"] = _host(dcols[c].reshape(-1)[m], dtypes[i])
            for i in nulls:
                out[f"n{i}"] = dcols.nulls[cols[i]].reshape(-1)[m] \
                    .cpu().numpy()
            if want_positions:
                out["pos"] = global_row_positions(pages, schema) \
                    .reshape(-1)[m].cpu().numpy()
            return out

        return gather, fields, dtypes

    def _collect_rows(self, gather, fields: Sequence[str], dtypes, dev, *,
                      limit: Optional[int] = None,
                      offset: int = 0) -> List[np.ndarray]:
        """Stream the scan through *gather*, keep the selected rows on the
        host (one concatenation at the end), stop issuing reads once
        ``offset + limit`` rows are in, and slice.  One array a field.
        Over the ranks of the run's mesh, each rank gathers its own
        members' shards and every rank returns the whole, in the scan's
        order (:meth:`_mesh_rows`)."""
        from .executor import ScanLimitReached
        if self._ranks is not None:
            return self._mesh_rows(gather, fields, dtypes, self._ranks,
                                   self._mesh_bp, limit, offset)
        stop = None if limit is None else offset + limit
        chunks = []
        gathered = 0

        def collect(pages):
            nonlocal gathered
            out = gather(pages)
            chunks.append([out[f] for f in fields])
            gathered += out["n"]
            if stop is not None and gathered >= stop:
                raise ScanLimitReached
            return {}   # nothing to fold

        self._stream_collect(collect, dev)
        if chunks:
            arrs = [np.concatenate([c[i] for c in chunks])
                    for i in range(len(fields))]
        else:
            arrs = [np.zeros(0, dt) for dt in dtypes]
        return [a[offset:stop] for a in arrs]

    def _stream_collect(self, collect, dev) -> None:
        self._scan(collect, dev)

    def _run_select(self, dev) -> dict:
        cols, limit, offset = self._select
        if cols is None:
            cols = list(range(self.schema.n_cols))
        gather, fields, dtypes = self._make_gather_fn(cols)
        return self._select_result(cols, fields, self._collect_rows(
            gather, fields, dtypes, dev, limit=limit, offset=offset))

    @staticmethod
    def _select_result(cols: Sequence[int], fields: Sequence[str],
                       arrs: Sequence[np.ndarray]) -> dict:
        """``select``'s result from the gathered arrays of
        :meth:`_make_gather_fn`'s *fields*."""
        named = dict(zip(fields, arrs))
        out = {f"col{c}": named[f"f{i}"] for i, c in enumerate(cols)}
        for i, c in enumerate(cols):
            if f"n{i}" in named:    # True = NULL
                out[f"null{c}"] = named[f"n{i}"]
        out["positions"] = named["pos"]
        out["count"] = np.int64(len(out["positions"]))
        return out

    def _run_order_by(self, dev, mesh=None) -> dict:
        """ORDER BY: gather (values, positions) on *dev*, then sort — a
        stable sort on *dev* locally (the host's lexsort for several key
        columns), the distributed sample sort over
        every member of *mesh* (one key column; the result then carries
        ``per_device_count`` and ``n_dropped``, and int32 positions, the
        exchange's payload width).  Over ranks the gather is each rank's
        members' (:meth:`_collect_rows`), so every rank sorts the same
        arrays, and the sorted rows of the other ranks' members come back
        through :func:`..parallel.sort.whole_rows`."""
        cols, descending, limit, offset = self._order
        end = None if limit is None else offset + limit
        if mesh is not None and len(cols) > 1:
            raise StromError(
                _errno.EOPNOTSUPP,
                "mesh order_by sorts one key column (the slab exchange "
                "carries a single key); sort multi-column orderings "
                "locally, or pre-combine the keys into one column")
        gather, fields, dtypes = self._make_gather_fn(cols)
        arrs = self._collect_rows(gather, fields, dtypes, dev)
        keys, poss = arrs[:-1], arrs[-1]
        vals = keys[0]
        if len(vals) == 0:
            if mesh is None:
                return {"values": vals, "positions": poss}
            return {"values": vals, "positions": poss.astype(np.int32),
                    "per_device_count": np.zeros(mesh.size, np.int32),
                    "n_dropped": np.int32(0)}
        if mesh is None:
            def sort_key(k):
                if not descending:
                    return k
                return -k if k.dtype.kind == "f" else ~k
            if len(keys) == 1:
                order = stable_order(sort_key(vals), dev)[offset:end]
            else:
                # np.lexsort: the LAST key is primary and the sort is
                # stable, so reversed keys give ORDER BY cols[0], cols[1],
                # ..., then arrival
                order = np.lexsort(tuple(sort_key(k)
                                         for k in reversed(keys)))[offset:end]
            return {"values": vals[order], "positions": poss[order]}
        from ..parallel.sort import make_distributed_sort, prefixes, \
            whole_rows
        from .executor import _to_numpy
        if len(poss) and int(poss.max()) > (1 << 31) - 1:
            # slab payloads are int32: a cast would wrap row identity
            raise StromError(_errno.ERANGE,
                             "mesh order_by row positions exceed int32; "
                             "tables past 2^31 rows need the local sort")
        dt = self._check_sortable_col(cols[0], "order_by")
        out = self._mesh_sort_loop(
            mesh, lambda flat, cap: make_distributed_sort(
                flat, capacity=cap, dtype=dt, descending=descending)[0],
            vals, poss.astype(np.int32))
        counts = _to_numpy(out["count"])
        v = _to_numpy(prefixes(whole_rows(out["values"]), counts)
                      [offset:end])
        p = _to_numpy(prefixes(whole_rows(out["payload"]), counts)
                      [offset:end])
        return {"values": v, "positions": p,
                "per_device_count": counts, "n_dropped": np.int32(0)}

    @staticmethod
    def _mesh_sort_loop(mesh, factory, *arrays) -> dict:
        """Run ``factory(mesh, capacity)``'s sort on *arrays* over every
        member of *mesh*, flattened (its owners kept), at the capacity
        :func:`..parallel.sort.capacity_loop` settles on: its rerun
        follows the drops of every rank, so the ranks rerun together."""
        from ..parallel.sort import capacity_loop
        flat = mesh.regrid(1)
        return capacity_loop(flat.size, len(arrays[0]),
                             lambda cap: factory(flat, cap)(*arrays))

    @staticmethod
    def _nearest_ranks(qs, n: int):
        """Nearest-rank indices into a sorted order of *n* elements."""
        return [min(n - 1, max(0, int(np.ceil(q * n)) - 1)) for q in qs]

    def _run_column(self, dev, mesh=None) -> dict:
        """quantiles / count_distinct over the gathered column: on the host
        locally, through the distributed sort over every member of
        *mesh*.  Over ranks each quantile's value is read on the rank that
        holds its row, and the picks meet in one gather."""
        gather, fields, dtypes = self._make_gather_fn(
            self._order[0], want_positions=False)
        (vals,) = self._collect_rows(gather, fields, dtypes, dev)
        if mesh is None:
            return self._column_result(vals)
        from .executor import _to_numpy
        dt = self._check_sortable_col(self._order[0][0], self._op)
        if self._op == "count_distinct":
            from ..parallel.sort import make_distributed_distinct
            out = self._mesh_sort_loop(
                mesh, lambda flat, cap: make_distributed_distinct(
                    flat, capacity=cap, dtype=dt)[0], vals)
            return {"distinct": np.int32(out["distinct"])}
        from ..parallel.sort import make_distributed_sort
        qs, n = self._quantiles, len(vals)
        if n == 0:
            return {"quantiles": np.full(len(qs), np.nan, np.float64),
                    "n": np.int64(0)}
        out = self._mesh_sort_loop(
            mesh, lambda flat, cap: make_distributed_sort(
                flat, capacity=cap, dtype=dt, with_payload=False)[0], vals)
        cum = np.cumsum(_to_numpy(out["count"]))
        picked = []
        for r in self._nearest_ranks(qs, n):
            b = int(np.searchsorted(cum, r + 1))
            within = r - (int(cum[b - 1]) if b else 0)
            # one member's row holds the rank: read that row alone (None
            # where another rank holds it)
            row = out["values"][b]
            picked.append(None if row is None else _to_numpy(row)[within])
        if mesh.multi_process:
            from ..parallel import dist
            parts = dist.all_gather_object(picked)
            picked = [next(p[i] for p in parts if p[i] is not None)
                      for i in range(len(picked))]
        return {"quantiles": np.array(picked, dt), "n": np.int64(n)}

    def _column_result(self, vals: np.ndarray) -> dict:
        """quantiles / count_distinct of the selected column values."""
        if self._op == "count_distinct":
            # equal_nan=False: each NaN is its own value (IEEE !=)
            return {"distinct": np.int32(len(
                np.unique(vals, equal_nan=False)))}
        qs, n = self._quantiles, len(vals)
        if n == 0:
            return {"quantiles": np.full(len(qs), np.nan, np.float64),
                    "n": np.int64(0)}
        return {"quantiles": np.sort(vals)[self._nearest_ranks(qs, n)],
                "n": np.int64(n)}

    def fetch(self, positions, cols: Optional[Sequence[int]] = None, *,
              device=None, session=None, max_batch_pages: int = 4096) -> dict:
        """Point lookup by global row position: only the pages holding
        *positions* are read (``engine.read_chunk_ids``, 8 KiB chunks the
        engine merges into larger requests), decoded on *device*, and the
        rows gathered in caller order.  *session* is an open
        :class:`..engine.Session` to read through (one is opened and
        closed for the call otherwise).

        Returns ``{"col<c>": values, "null<c>": NULL masks (nullable
        columns), "valid": mask}``; ``valid`` is False for a slot past its
        page's tuple count or invisible.  Duplicates and any order are
        fine; a position outside the table is ERANGE.  Not a terminal: it
        works on any Query (e.g. ``top_k`` positions back to full rows)."""
        from ..hbm.staging import resolve_device
        if cols is None:
            cols = list(range(self.schema.n_cols))
        for c in cols:
            if not 0 <= c < self.schema.n_cols:
                raise StromError(_errno.EINVAL, f"fetch column {c} out of "
                                                f"range")
        dev = resolve_device(device)
        pos = np.asarray(positions, np.int64).reshape(-1)
        dcols, valid = self._fetch_rows(pos, cols, dev, session,
                                        max_batch_pages)
        if not len(pos):
            out = {f"col{c}": np.zeros(0, self.schema.col_dtype(c))
                   for c in cols}
            out["valid"] = np.zeros(0, bool)
            return out
        out = {}
        for c in cols:
            out[f"col{c}"] = _host(dcols[c].reshape(-1),
                                   self.schema.col_dtype(c))
            if c in dcols.nulls:     # True = NULL
                out[f"null{c}"] = dcols.nulls[c].reshape(-1).cpu().numpy()
        out["valid"] = valid.reshape(-1).cpu().numpy()
        return out

    def _fetch_rows(self, pos: np.ndarray, cols: Optional[Sequence[int]],
                    dev, session=None, max_batch_pages: int = 4096):
        """The rows at *pos* (int64, any order) decoded on *dev*:
        ``(Cols, valid)`` with (1, n) tensors in the decoded form the scan
        steps take (uint32 as int64), ``None`` for a column not in *cols*
        (None = all), and the NULL masks of the fetched nullable columns.
        Only the pages holding *pos* are read."""
        from ..engine import Session, read_chunk_ids
        from ..ops.filter import Cols
        t = self.schema.tuples_per_page
        want = range(self.schema.n_cols) if cols is None else set(cols)
        with self._open_owned() as src:
            n_pages = src.size // PAGE_SIZE
            if len(pos) and (pos.min() < 0 or pos.max() >= n_pages * t):
                raise StromError(_errno.ERANGE, f"position outside the "
                                                f"table ({n_pages * t} "
                                                f"rows)")
            uniq = np.unique(pos // t)          # pages to touch, sorted
            parts = []
            sess = session if session is not None or not len(uniq) \
                else Session()
            try:
                for b0 in range(0, len(uniq), max_batch_pages):
                    ids = uniq[b0:b0 + max_batch_pages]
                    handle, buf = sess.alloc_dma_buffer(len(ids) * PAGE_SIZE)
                    try:
                        raw = read_chunk_ids(sess, src, ids, PAGE_SIZE,
                                             handle, buf.view())
                        parts.append(np.array(raw).reshape(-1, PAGE_SIZE))
                    finally:
                        sess.unmap_buffer(handle)
                        buf.close()
            finally:
                if sess is not session:
                    sess.close()
        # no position: one blank page gives the decoded columns' dtypes
        pages = torch.from_numpy(np.concatenate(parts) if parts else
                                 np.zeros((1, PAGE_SIZE), np.uint8)).to(dev)
        page_idx = torch.from_numpy(np.searchsorted(uniq, pos // t)).to(dev)
        slot = torch.from_numpy(pos % t).to(dev)
        dcols, valid = decode_pages(pages, self.schema)
        out = Cols([dcols[c][page_idx, slot].reshape(1, -1)
                    if c in want else None
                    for c in range(self.schema.n_cols)],
                   nulls={c: m[page_idx, slot].reshape(1, -1)
                          for c, m in dcols.nulls.items() if c in want})
        return out, valid[page_idx, slot].reshape(1, -1)

    # -- the index runners: fetched rows folded in PyTorch ops ---------------
    def _index_positions_cond(self, idx) -> np.ndarray:
        """The positions the structured filter (the index condition)
        resolves from the sidecar, in index order."""
        prefix = idx.composite and not isinstance(self._index_col(),
                                                  (tuple, list))
        if self._eq is not None:
            v = self._eq[1]
            if v is None:        # the literal can match no row
                return np.zeros(0, np.int64)
            if prefix:           # c0 alone over a (c0, c1) sidecar
                return idx.prefix_range(v, v)
            return idx.lookup([v])
        if self._in is not None:
            if prefix:
                parts = [idx.prefix_range(m, m) for m in self._in[1]]
                return np.concatenate(parts) if parts \
                    else np.zeros(0, np.int64)
            return idx.lookup(self._in[1])
        _c, lo, hi = self._range
        if prefix:
            return idx.prefix_range(lo, hi)
        return idx.range(lo, hi)

    def _index_positions(self, idx, dev, session) -> np.ndarray:
        """The index condition's positions, rechecked against the residual
        ``where`` filters (Index Cond + Filter) in batches of 65,536 fetched
        rows, so host and device memory stay bounded to a batch; an
        invisible row never comes back."""
        pos = np.asarray(self._index_positions_cond(idx), np.int64)
        if not self._has_residual() or not len(pos):
            return pos
        pred = self._predicate(self._residual_terms, self._residual_calls)
        keep = []
        batch = 1 << 16
        for b0 in range(0, len(pos), batch):
            pb = pos[b0:b0 + batch]
            cols, valid = self._fetch_rows(pb, None, dev, session)
            m = select_rows(pred, cols, valid, self.schema)
            keep.append(pb[m.reshape(-1).cpu().numpy()])
        return np.concatenate(keep)

    def _run_select_indexed(self, idx, dev, session) -> dict:
        """Index scan ``select``: the sidecar's positions, then only their
        pages, fetched in batches that stop once ``offset + limit`` valid
        rows are in.  :meth:`_run_select`'s result; rows in index order
        (ascending key, physical order within equal keys)."""
        cols, limit, offset = self._select
        if cols is None:
            cols = list(range(self.schema.n_cols))
        pos = self._index_positions(idx, dev, session)
        end = None if limit is None else offset + limit
        step = max(1, len(pos)) if end is None else max(end, 1024)
        dts = {c: self.schema.col_dtype(c) for c in cols}
        nullable = [c for c in dts if self.schema.col_nullable(c)]
        got = {**{f"col{c}": [] for c in dts},
               **{f"null{c}": [] for c in nullable}, "positions": []}
        n_valid = 0
        for b0 in range(0, len(pos), step):
            pb = pos[b0:b0 + step]
            dcols, valid = self._fetch_rows(pb, cols, dev, session)
            keep = valid.reshape(-1)
            for c, dt in dts.items():
                got[f"col{c}"].append(_host(dcols[c].reshape(-1)[keep], dt))
            for c in nullable:
                got[f"null{c}"].append(
                    dcols.nulls[c].reshape(-1)[keep].cpu().numpy())
            k = keep.cpu().numpy()
            got["positions"].append(pb[k])
            n_valid += int(k.sum())
            if end is not None and n_valid >= end:
                break
        blank = {**{f"col{c}": np.zeros(0, dt) for c, dt in dts.items()},
                 **{f"null{c}": np.zeros(0, bool) for c in nullable},
                 "positions": np.zeros(0, np.int64)}
        res = {k: np.concatenate(v)[offset:end] if v else blank[k]
               for k, v in got.items()}
        res["count"] = np.int64(len(res["positions"]))
        return res

    def _run_aggregate_indexed(self, idx, dev, session) -> dict:
        """COUNT/SUM over the index's rows: only their pages are read, and
        the plain filter step folds them, so the sums keep the scan's
        accumulation dtypes (int32 wrapping, ``nncounts``)."""
        from ..ops.filter import make_filter_fold
        from .executor import _to_numpy
        pos = self._index_positions(idx, dev, session)
        cols, valid = self._fetch_rows(pos, None, dev, session)
        out = make_filter_fold(self.schema, None)(cols, valid)
        return self._finalize(self._project(_to_numpy(out)))

    def _run_groupby_indexed(self, idx, dev, session) -> dict:
        """GROUP BY over the index's rows: the key (a GroupKey, a callable,
        or a value-keyed GROUP BY's ids) and the plain GROUP BY step on
        the fetched rows — NULL-aware, in :func:`..ops.groupby.acc_dtypes`
        — then :meth:`_finalize`."""
        from ..ops.groupby import make_groupby_fold
        from .executor import _to_numpy
        _key, g, agg, _having = self._group
        pos = self._index_positions(idx, dev, session)
        cols, valid = self._fetch_rows(pos, None, dev, session)
        out = make_groupby_fold(self.schema, self._key(), g,
                                agg_cols=agg)(cols, valid)
        return self._finalize(_to_numpy(out))

    def _run_topk_indexed(self, idx, dev, session) -> dict:
        """top_k over the index's rows through ``ops.topk.rank_topk``, the
        scan's ranking; candidates in ascending position, so ties go to
        the lowest position as on the scan."""
        from ..ops.topk import rank_topk
        from .executor import _to_numpy
        col, k, largest = self._topk
        pos = np.sort(self._index_positions(idx, dev, session))
        cols, valid = self._fetch_rows(pos, [col], dev, session)
        keep = valid.reshape(-1)
        vals, poss = rank_topk(cols[col].reshape(-1)[keep],
                               torch.from_numpy(pos).to(dev)[keep], k,
                               self.schema.col_dtype(col), largest)
        return self._finalize(_to_numpy({"values": vals,
                                         "positions": poss}))

    def _run_column_indexed(self, idx, dev, session) -> dict:
        """quantiles / count_distinct over the index's rows (p99 WHERE key
        = X): the scan's math on the fetched column."""
        col = self._order[0][0]
        pos = self._index_positions(idx, dev, session)
        cols, valid = self._fetch_rows(pos, [col], dev, session)
        return self._column_result(_host(
            cols[col].reshape(-1)[valid.reshape(-1)],
            self.schema.col_dtype(col)))

    def _run_join_indexed(self, idx, dev, session) -> dict:
        """Join over the index's rows: only their fact pages are read, and
        the join steps of ``ops/join.py`` (its sorted build, searchsorted
        probe and ``_emit_mask``) fold them.  The row face fetches the
        probe column alone, 65,536 positions a batch, and stops once
        ``offset + limit`` rows are emitted."""
        from ..ops.join import make_join_fn, make_join_rows_fn
        from .executor import _to_numpy
        if self._join_src is not None:
            # only a broadcast-sized build on disk reaches this runner
            self._resolve_join_build(dev)
        probe_col, bk, bv, materialize, limit, offset = self._join
        how = self._join_how
        pos_all = np.sort(self._index_positions(idx, dev, session))
        if not materialize:
            cols, valid = self._fetch_rows(pos_all, None, dev, session)
            run = make_join_fn(self.schema, probe_col, bk, bv, how=how)
            return _to_numpy(run.fold(cols, valid))
        run = make_join_rows_fn(self.schema, probe_col, bk, bv, how=how)
        fields, dtypes = self._join_row_fields(how)
        end = None if limit is None else offset + limit
        parts, got = [], 0
        batch = 1 << 16
        for b0 in range(0, len(pos_all), batch):
            pb = pos_all[b0:b0 + batch]
            cols, valid = self._fetch_rows(pb, [probe_col], dev, session)
            out = run.fold(cols, valid, torch.from_numpy(pb).to(dev))
            m = out["hit"]
            parts.append([_host(out[f][m], dt)
                          for f, dt in zip(fields, dtypes)])
            got += len(parts[-1][0])
            if end is not None and got >= end:
                break
        arrs = [np.concatenate([p[i] for p in parts])[offset:end] if parts
                else np.zeros(0, dt) for i, dt in enumerate(dtypes)]
        return self._join_rows_result(how, *arrs)

    # -- terminals served by the sidecar alone --------------------------------
    @staticmethod
    def _sidecar_descending_perm(ka: np.ndarray, lo_i: int,
                                 hi_i: int) -> np.ndarray:
        """[lo_i, hi_i) of the STABLE descending permutation of an
        ascending key array: key groups reverse, rows within an equal-key
        group keep ascending (physical) order, as the scan's stable sort
        of the negated keys does (a plain reversal would flip them)."""
        n = len(ka)
        starts = np.flatnonzero(
            np.concatenate(([True], ka[1:] != ka[:-1])))
        group_ends = np.append(starts[1:], n)
        if hi_i <= 4096:
            # a small head: walk the key groups from the tail and stop
            # once offset + limit rows are in
            parts = []
            got = 0
            for gi in range(len(starts) - 1, -1, -1):
                parts.append(np.arange(starts[gi], group_ends[gi]))
                got += group_ends[gi] - starts[gi]
                if got >= hi_i:
                    break
            return np.concatenate(parts)[lo_i:hi_i] if parts \
                else np.zeros(0, np.int64)
        g = np.cumsum(np.concatenate(
            ([0], (ka[1:] != ka[:-1]).astype(np.int64))))
        return np.argsort(-g, kind="stable")[lo_i:hi_i]

    def _run_topk_sidecar(self, idx, dev) -> dict:
        """Unfiltered top_k over an indexed integer column: the k best
        keys are the sidecar's head (smallest) or stable-descending tail
        (largest), ranked by the scan's ``rank_topk`` for the padding."""
        from ..ops.topk import rank_topk
        from .executor import _to_numpy
        col, k, largest = self._topk
        dt = self.schema.col_dtype(col)
        take = min(k, len(idx.keys))
        if largest:
            perm = self._sidecar_descending_perm(idx.keys, 0, take)
            vals, pos = idx.keys[perm], idx.positions[perm]
        else:
            vals, pos = idx.keys[:take], idx.positions[:take]
        # copies (the sidecar's arrays are read-only) in the decoded form
        # rank_topk takes: uint32 as int64
        v = torch.from_numpy(np.array(
            vals, np.int64 if dt == np.dtype(np.uint32) else dt))
        p = torch.from_numpy(np.array(pos, np.int64))
        vals_t, pos_t = rank_topk(v.to(dev), p.to(dev), k, dt, largest)
        return self._finalize(_to_numpy({"values": vals_t,
                                         "positions": pos_t}))

    def _run_quantiles_sidecar(self, idx, _dev) -> dict:
        """Unfiltered exact quantiles with no table I/O: nearest-rank
        reads of the sorted keys (integer columns only)."""
        qs, n = self._quantiles, len(idx.keys)
        if n == 0:
            return {"quantiles": np.full(len(qs), np.nan, np.float64),
                    "n": np.int64(0)}
        return {"quantiles": np.ascontiguousarray(
                    idx.keys[self._nearest_ranks(qs, n)]),
                "n": np.int64(n)}

    def _run_count_distinct_sidecar(self, idx, _dev) -> dict:
        """Unfiltered COUNT(DISTINCT) with no table I/O: adjacent
        differences of the sorted keys."""
        k = idx.keys
        d = 0 if len(k) == 0 else int((k[1:] != k[:-1]).sum()) + 1
        return {"distinct": np.int32(d)}

    def _run_order_by_prefix(self, idx) -> dict:
        """``WHERE c0 = v ORDER BY c1`` from a ``(c0, c1)`` sidecar: the
        matching rows are one contiguous span already in c1 order (the
        packed keys' low word) — no sort, no table I/O."""
        from .index import unpack_second
        _ce, v = self._eq
        _cols, descending, limit, offset = self._order
        a, b = idx.prefix_span(v) if v is not None else (0, 0)
        span_keys, span_pos = idx.keys[a:b], idx.positions[a:b]
        n = b - a
        end = n if limit is None else min(n, offset + limit)
        lo_i, hi_i = min(offset, n), min(end, n)
        if descending:
            vals1 = unpack_second(span_keys, idx.key_dtypes[1])
            perm = self._sidecar_descending_perm(vals1, lo_i, hi_i)
            pos, vals = span_pos[perm], vals1[perm]
        else:
            # LIMIT touches only the head: slice before unpacking
            pos = span_pos[lo_i:hi_i]
            vals = unpack_second(span_keys[lo_i:hi_i], idx.key_dtypes[1])
        return {"values": np.ascontiguousarray(vals),
                "positions": np.ascontiguousarray(pos, np.int64)}

    def _run_order_by_indexed(self, idx, dev) -> dict:
        """ORDER BY from a fresh sidecar: the index order is the answer,
        and a LIMIT reads only the sidecar's head (for a composite
        sidecar, and the pages of the head's rows for the first column's
        values).  :meth:`_run_order_by`'s result; equal keys in physical
        order, as the scan's stable sort."""
        cols, descending, limit, offset = self._order
        n = len(idx.positions)
        end = n if limit is None else min(n, offset + limit)
        lo_i, hi_i = min(offset, n), min(end, n)
        if descending:
            perm = self._sidecar_descending_perm(idx.keys, lo_i, hi_i)
            pos, keys = idx.positions[perm], idx.keys[perm]
        else:
            pos, keys = idx.positions[lo_i:hi_i], idx.keys[lo_i:hi_i]
        pos = np.ascontiguousarray(pos, np.int64)
        if not idx.composite:
            return {"values": np.ascontiguousarray(keys), "positions": pos}
        out = self.fetch(pos, cols=[cols[0]], device=dev)
        keep = out["valid"]
        return {"values": out[f"col{cols[0]}"][keep],
                "positions": pos[keep]}

    # -- worker processes (the Gather analog) --------------------------------
    def _run_workers(self, n_workers: int, dev: torch.device,
                     kernel: str) -> dict:
        """Leader side of the parallel scan: the serial path's plan and
        what cannot ship are refused before any process starts; GROUP BY
        keys are discovered once (every worker shares one key space) and
        star dimensions loaded once; then :func:`.parallel.run_query_workers`,
        the workers' counters folded into this process's, and the partials
        folded as the serial scan folds its batches.  ``_workers`` gives
        ``n``, each worker's ``scan_s`` and its kernel ``launches``."""
        from .parallel import run_query_workers
        if not isinstance(self.source, str):
            raise StromError(_errno.EINVAL, "workers: a parallel scan takes "
                                            "one table file path (a stripe "
                                            "set or an open Source scans in "
                                            "one process or over a mesh)")
        plan = self._plan(dev, kernel, None, n_workers)
        if plan.kernel == "invalid":
            raise StromError(_errno.EINVAL, f"query not executable: "
                                            f"{plan.reason}")
        if self._op == "join":
            raise StromError(_errno.EINVAL, "workers: JOIN is not "
                                            "worker-servable yet (run it "
                                            "without workers=)")
        if self._opaque:
            raise StromError(_errno.EINVAL, "workers: an opaque where() "
                                            "lambda cannot ship to worker "
                                            "processes — use where_eq/"
                                            "where_range/where_in, a "
                                            "FilterPred (its terms travel) "
                                            "or the SQL facade (predicate "
                                            "trees travel)")
        discovered, spill = None, None
        if self._op == "group_by":
            if self._group_cols is None:
                raise StromError(_errno.EINVAL, "workers: group_by needs "
                                                "group_by_cols (key-function "
                                                "closures cannot ship)")
            try:
                discovered = self._discover_group_keys(dev)
                self._install_group_keys(discovered, dev)
            except _GroupSpill:
                # the workers sort-aggregate, the leader merges
                spill = self._sorted_group_acc()
        elif self._op == "star":
            if self._star["materialize"]:
                raise StromError(_errno.EINVAL, "workers: the star row face "
                                                "is not worker-servable "
                                                "(aggregate face only)")
            self._resolve_star_builds(dev)
        elif self._op not in self._WORKER_OPS:
            raise StromError(_errno.EINVAL, f"workers: terminal {self._op!r}"
                                            f" is not worker-servable "
                                            f"({'/'.join(self._WORKER_OPS)})")
        partials = run_query_workers(self._worker_spec(
            dev, plan.kernel, discovered, spill is not None), n_workers)
        for p in partials:
            stats.merge_native(p.pop("stats"))
        self._h2d_depth = max(p.pop("h2d_depth") for p in partials)
        info = {"n": n_workers,
                "scan_s": [round(p.pop("scan_s"), 6) for p in partials],
                "launches": [p.pop("launches") for p in partials]}
        out = self._fold_partials(partials, dev, spill)
        if out:
            out["_workers"] = info
        return out

    def _fold_partials(self, partials: List[dict], dev,
                       spill: Optional[_SortedGroupAcc]) -> dict:
        """The workers' partials as the serial run's result.  Rows and
        top-k candidates take the serial scan's order: a worker claims its
        chunks in ascending order, so its rows arrive by position, and
        every chunk holding one of the first ``offset + limit`` rows of the
        table is gathered by some worker."""
        from ..ops.groupby import combine_groupby
        from .executor import _to_numpy, fold_results
        if spill is not None:
            for p in partials:
                spill.merge_state(p["sorted"])
            return self._sorted_group_result(spill)
        if self._op == "select":
            cols, limit, offset = self._select
            if cols is None:
                cols = list(range(self.schema.n_cols))
            _g, fields, _dts = self._make_gather_fn(cols)
            arrs = [np.concatenate([p["rows"][i] for p in partials])
                    for i in range(len(fields))]
            order = np.argsort(arrs[-1], kind="stable")   # positions
            stop = None if limit is None else offset + limit
            return self._select_result(cols, fields, [a[order][offset:stop]
                                                      for a in arrs])
        accs = [_to_torch(p["acc"]) for p in partials if p["acc"]]
        if not accs:
            # an empty table: no worker claimed a chunk.  The step over one
            # blank page (no tuples) gives the zero-row result
            fn, _c = self._build_fn("torch")
            return self._finalize(_to_numpy(fn(torch.zeros(
                (1, PAGE_SIZE), dtype=torch.uint8, device=dev))))
        if self._op == "top_k":
            col, k, largest = self._topk
            folded = _merge_topk(accs, self.schema.col_dtype(col), largest, k)
        else:
            combine = combine_groupby if self._op == "group_by" else None
            folded = None
            for a in accs:
                folded = fold_results(folded, a, combine)
        return self._finalize(_to_numpy(folded))

    def _worker_spec(self, dev, kernel: str, discovered, spill: bool) -> dict:
        """What a worker rebuilds the query from (picklable): the table,
        the filter's FilterPred terms, its ``where_in`` members and the SQL
        facade's predicate trees, the terminal, the leader's route, device
        and config (``x64``, which sets the accumulators' widths, named on
        its own), and the resolved GROUP BY keys or star dimensions."""
        from ..config import config
        spec = {"source": self.source, "schema": self.schema,
                "config": config.snapshot(),
                "chunk_size": int(config.get("chunk_size")),
                "device": str(dev), "kernel": kernel,
                "terms": self._terms, "in": self._in,
                "trees": list(self._trees),
                "op": "group_sorted" if spill else self._op,
                "agg_cols": self._agg_cols, "agg_exprs": self._agg_exprs,
                "select": self._select, "topk": self._topk,
                "x64": bool(config.get("x64"))}
        if self._op == "star":
            spec["star"] = self._star
            spec["star_resolved"] = self._star_resolved
        if self._op == "group_by":
            cols_, agg, _having, max_groups = self._group_cols
            spec["group"] = (list(cols_), agg, max_groups)
            spec["discovered"] = discovered
        return spec

    @classmethod
    def _from_worker_spec(cls, spec: dict) -> "Query":
        """The leader's query, rebuilt inside a worker (the inverse of
        :meth:`_worker_spec`)."""
        from ..hbm.staging import resolve_device
        q = cls(spec["source"], spec["schema"])
        if spec["in"] is not None:
            q.where_in(*spec["in"])       # its torch.isin callable
        q._terms = spec["terms"]
        from .sql import _tree_mask
        for t in spec["trees"]:
            q.where(lambda cols, t=t, s=q.schema: _tree_mask(t, cols, s),
                    _tree=t)
        op = spec["op"]
        if op == "aggregate":
            if spec["agg_exprs"] is not None:
                q.aggregate_exprs(spec["agg_exprs"])
            else:
                q.aggregate(spec["agg_cols"])
        elif op == "star":
            q._terminal("star")
            q._star, q._star_resolved = spec["star"], spec["star_resolved"]
        elif op == "top_k":
            col, k, largest = spec["topk"]
            q.top_k(col, k, largest=largest)
        elif op == "select":
            # the offset applies on the leader: a worker gathers up to
            # offset + limit rows
            cols, limit, offset = spec["select"]
            q.select(cols, limit=None if limit is None else offset + limit)
        elif op in ("group_by", "group_sorted"):
            cols_, agg, max_groups = spec["group"]
            q.group_by_cols(cols_, agg_cols=agg, max_groups=max_groups)
            if op == "group_by":
                q._install_group_keys(spec["discovered"],
                                      resolve_device(spec["device"]))
        else:
            raise StromError(_errno.EINVAL, f"worker spec op {op!r}")
        return q

    def _run_worker_partial(self, spec: dict, cursor,
                            ready: Callable[[], object] = lambda: None
                            ) -> dict:
        """Worker side: bring the device up, call *ready* (the workers'
        start barrier), scan the chunks claimed from the shared *cursor*
        with this process's own session and return the numpy partial,
        with the worker's ``scan_s`` (wall time from the barrier, net of
        process start and CUDA set-up), its kernel ``launches``, the
        deepest H2D pipeline it reached and its counter deltas."""
        from ..config import config
        from ..engine import Session
        from ..hbm.staging import resolve_device
        from ..ops import filter_cuda, groupby_cuda
        from .executor import scan_pool_bytes
        from .pool import DmaBufferPool
        dev = resolve_device(spec["device"])
        # the scan's set-up before the barrier: the session's engine and
        # the pinned ring, which four workers building them at once after
        # it finished unevenly enough to leave one without a batch
        sess = Session(device=dev)
        chunk = int(config.get("chunk_size"))
        pool = DmaBufferPool(chunk_size=chunk, total_size=scan_pool_bytes(
            chunk, int(config.get("async_depth"))))
        try:
            if dev.type == "cuda":
                torch.zeros(1, device=dev)
                pool.pin_cuda()
                torch.cuda.synchronize(dev)
            ready()
            before = stats.snapshot()
            l1, l3 = filter_cuda.launches, groupby_cuda.launches
            t0 = time.monotonic()
            self._cursor, self._session, self._worker_pool = \
                cursor, sess, pool
            try:
                out = self._worker_partial_inner(spec, dev)
            finally:
                self._cursor = self._session = self._worker_pool = None
        finally:
            pool.close()
            sess.close()
        out["scan_s"] = time.monotonic() - t0
        out["launches"] = {"filter_pages": filter_cuda.launches - l1,
                           "groupby_pages": groupby_cuda.launches - l3}
        out["h2d_depth"] = self._h2d_depth
        after = stats.snapshot()
        out["stats"] = {k: v - before.get(k, 0) for k, v in after.items()
                        if k != "h2d_depth_reached"}
        return out

    def _worker_partial_inner(self, spec: dict, dev) -> dict:
        if spec["op"] == "group_sorted":
            acc = self._sorted_group_acc()
            self._sorted_group_scan(acc, dev)
            return {"sorted": acc.state()}
        if self._op == "select":
            cols, stop, _offset = self._select
            if cols is None:
                cols = list(range(self.schema.n_cols))
            gather, fields, dtypes = self._make_gather_fn(cols)
            return {"rows": self._collect_rows(gather, fields, dtypes, dev,
                                               limit=stop)}
        fn, combine = self._build_fn(spec["kernel"])
        return {"acc": self._scan(fn, dev, combine)}

    # -- value-keyed GROUP BY -----------------------------------------------
    def _discover_group_keys(self, dev) -> np.ndarray:
        """Pass 1 of :meth:`group_by_cols`: the sorted distinct key set
        (the column's values for one key, packed uint64 pairs for two,
        lex-sorted (g, N) int64 rows for 3-4).  For 1-2 key columns with a
        fresh sidecar on exactly those columns, the sidecar's unique keys,
        with no table I/O (keys of rows the filter drops make groups that
        select no row, which the HAVING drops); else one projection scan
        of the selected rows.  Past ``max_groups`` raises
        :class:`_GroupSpill` for 1-2 key columns, ENOMEM for more.  Over
        the ranks of the run's mesh, each rank scans its own members'
        shards and the key sets meet in one gather, so every rank
        installs the same keys."""
        from .index import index_path_for, open_index, pack_pair, \
            probe_index
        cols_, _agg, _having, max_groups = self._group_cols
        dts = [self.schema.col_dtype(c) for c in cols_]
        if len(cols_) <= 2 and isinstance(self.source, str):
            want = cols_[0] if len(cols_) == 1 else tuple(cols_)
            ip = index_path_for(self.source, want)
            discovered = None
            try:
                if probe_index(ip, self.source, expect_col=want,
                               allow_prefix=False):
                    keys = open_index(ip, table_path=self.source).keys
                    # sorted already: the uniques are the first of each run
                    discovered = keys[np.concatenate(
                        ([True], keys[1:] != keys[:-1]))] if len(keys) \
                        else keys
            except Exception:   # raced away: the scan below
                discovered = None
            if discovered is not None:
                if len(discovered) > max_groups:
                    raise _GroupSpill(len(discovered))
                return discovered
        gather, _f, _d = self._make_gather_fn(cols_, want_positions=False)
        nk = len(cols_)
        if nk <= 2:
            merged = np.zeros(0, np.uint64 if nk == 2 else dts[0])
        else:
            merged = np.zeros((0, nk), np.int64)

        def merge(a, b):
            if nk <= 2:
                return np.union1d(a, b)
            return np.unique(np.concatenate([a, b]), axis=0)

        def check():
            if len(merged) > max_groups:
                if nk <= 2:
                    raise _GroupSpill(len(merged))
                raise StromError(_errno.ENOMEM, f"group_by_cols: more than "
                                                f"{max_groups} distinct keys "
                                                f"(raise max_groups, or use "
                                                f"group_by with a key "
                                                f"function)")

        def collect(pages):
            nonlocal merged
            out = gather(pages)
            vs = [out[f"f{i}"] for i in range(nk)]
            if nk == 1:
                merged = merge(merged, np.unique(vs[0]))
            elif nk == 2:
                merged = merge(merged, np.unique(
                    pack_pair(vs[0], vs[1], dts[0], dts[1])))
            else:
                merged = merge(merged, np.unique(
                    np.stack([v.astype(np.int64) for v in vs], 1), axis=0))
            if self._ranks is None:     # over ranks: after the gather
                check()
            return {}

        if self._ranks is not None:
            from ..parallel import dist
            self._mesh_scan(self._ranks, lambda pages, _at: collect(pages),
                            self._mesh_bp)
            for part in dist.all_gather_object(merged):
                merged = merge(merged, part)
            check()
            return merged
        self._stream_collect(collect, dev)
        return merged

    def _install_group_keys(self, discovered: np.ndarray, dev) -> None:
        """Pass 2's key: ``searchsorted`` ids over the discovered keys (on
        *dev*), the group count, the empty-group-dropping HAVING, and the
        decoder of ``key_cols``, all into ``self._group``."""
        from .index import unpack_first, unpack_second
        cols_, agg, user_having, _mg = self._group_cols
        dts = [self.schema.col_dtype(c) for c in cols_]

        def on_dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(
                a.astype(np.int64))).to(dev)

        def rank(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
            # the table follows the batch: a mesh's members may sit on
            # other cards than *dev*
            return torch.searchsorted(u.to(v.device),
                                      v.to(torch.int64).contiguous()) \
                .clamp_(0, max(u.shape[0] - 1, 0))

        if len(cols_) == 1:
            keys = discovered.astype(dts[0])
            g = len(keys)
            kt = on_dev(keys)

            def key_fn(cols, _threshold):
                v = cols[cols_[0]]
                if g == 0:           # empty table: one dropped bucket
                    return torch.zeros(v.shape, dtype=torch.int64,
                                       device=v.device)
                return rank(kt, v)

            n_groups = max(g, 1)
            self._gk_decode = lambda gids: [keys[gids]]
        else:
            if len(cols_) == 2:
                g = len(discovered)
                krows = [unpack_first(discovered, dts[0]),
                         unpack_second(discovered, dts[1])]
            else:
                g = len(discovered)
                krows = [discovered[:, j].astype(dts[j])
                         for j in range(len(cols_))]
            uniqs = [np.unique(k) for k in krows]
            dims = [max(len(u), 1) for u in uniqs]
            if int(np.prod(dims, dtype=np.float64)) > (1 << 22):
                raise StromError(_errno.ENOMEM, "group_by_cols: dense rank "
                                                "table over 4M entries; use "
                                                "group_by with a key "
                                                "function")
            # mixed-radix table: rank tuple -> group id; absent tuples
            # (and masked rows) land in the sentinel bucket g, which the
            # count > 0 HAVING drops
            table = np.full(int(np.prod(dims)), g, np.int64)
            if g:
                flat = np.zeros(g, np.int64)
                for j in range(len(cols_)):
                    flat = flat * dims[j] + np.searchsorted(uniqs[j],
                                                            krows[j])
                table[flat] = np.arange(g)
            uts, tt = [on_dev(u) for u in uniqs], on_dev(table)

            def key_fn(cols, _threshold):
                if g == 0:
                    return torch.zeros(cols[cols_[0]].shape,
                                       dtype=torch.int64,
                                       device=cols[cols_[0]].device)
                flat = None
                for j, cj in enumerate(cols_):
                    r = rank(uts[j], cols[cj])
                    flat = r if flat is None else flat * dims[j] + r
                return tt.to(flat.device)[flat]

            n_groups = g + 1
            self._gk_decode = lambda gids: [k[gids] for k in krows]
        self._group = (key_fn, n_groups, agg, _hv(user_having))

    def _sorted_group_acc(self) -> _SortedGroupAcc:
        """The sorted spill's empty accumulator; EINVAL when an aggregated
        column is nullable."""
        cols_, agg, _having, _mg = self._group_cols
        agg_idx, agg_dt = _check_agg_cols(self.schema, agg)
        for c in agg_idx:
            if self.schema.col_nullable(c):
                raise StromError(_errno.EINVAL, f"group_by_cols: c{c} is "
                                                f"nullable and the key set "
                                                f"exceeded max_groups — "
                                                f"high-cardinality GROUP BY "
                                                f"over nullable aggregates "
                                                f"is outside this subset")
        acc_np, sq_np, lo, hi = acc_dtypes(agg_dt, self.schema)
        return _SortedGroupAcc(len(agg_idx), acc_np, sq_np, lo, hi,
                               self._SPILL_HARD_MAX)

    def _sorted_group_scan(self, acc: _SortedGroupAcc, dev) -> None:
        """Stream the scan into *acc*: each batch's selected rows sort by
        packed key and ``reduceat`` into per-key partials on the host.
        Over ranks, the batches of this rank's members."""
        from .index import pack_pair
        cols_, agg, _having, _mg = self._group_cols
        agg_idx, _dt = _check_agg_cols(self.schema, agg)
        dts = [self.schema.col_dtype(c) for c in cols_]
        gather, _f, _d = self._make_gather_fn(list(cols_) + list(agg_idx),
                                              want_positions=False)
        nk = len(cols_)

        def collect(pages):
            out = gather(pages)
            ks = [out[f"f{i}"] for i in range(nk)]
            vals = np.stack([out[f"f{nk + j}"] for j in range(len(agg_idx))])
            acc.add_batch(ks[0] if nk == 1 else
                          pack_pair(ks[0], ks[1], dts[0], dts[1]), vals)
            return {}

        if self._ranks is not None:
            self._mesh_scan(self._ranks, lambda pages, _at: collect(pages),
                            self._mesh_bp)
            return
        self._stream_collect(collect, dev)

    def _sorted_group_result(self, acc: _SortedGroupAcc) -> dict:
        """The folded spill as the one-pass GROUP BY's result, ``key_cols``
        included."""
        from .index import unpack_first, unpack_second
        cols_, agg, user_having, _mg = self._group_cols
        dts = [self.schema.col_dtype(c) for c in cols_]
        st = acc.state()
        keys = st.pop("keys")
        self._group = (None, len(keys), agg, _hv(user_having))
        if len(cols_) == 1:
            kd = keys.astype(dts[0])
            self._gk_decode = lambda gids: [kd[gids]]
        else:
            k0, k1 = unpack_first(keys, dts[0]), unpack_second(keys, dts[1])
            self._gk_decode = lambda gids: [k0[gids], k1[gids]]
        return self._finalize(st)

    def _run_groupby_sorted(self, dev) -> dict:
        """GROUP BY past ``max_groups``: each batch's selected rows sort
        by packed key and ``reduceat`` into per-key partials on the host,
        merged into a running sorted state (O(distinct keys)).  Same
        result contract as the one-pass GROUP BY, ``key_cols`` included.
        Over ranks each rank builds the state of its own members' pages,
        and the states meet in one gather, merged in rank order (each
        merged key updated once, as the batches' merge)."""
        acc = self._sorted_group_acc()
        self._sorted_group_scan(acc, dev)
        if self._ranks is not None:
            from ..parallel import dist
            parts = dist.all_gather_object(
                None if acc.keys is None else acc.state())
            acc = self._sorted_group_acc()
            for st in parts:
                if st is not None:      # a rank that selected no row
                    acc.merge_state(st)
        return self._sorted_group_result(acc)

    # -- expression aggregates and joins ------------------------------------
    def _expr_parts(self, exprs):
        """``(fns, dtypes)``: each tree's evaluator over decoded columns and
        its result dtype (the dtype its sum accumulates in)."""
        from .sql import _eval_expr, _expr_info
        fns, dts = [], []
        for e in exprs:
            fns.append(lambda cols, e=e: _eval_expr(e, cols))
            dts.append(_expr_info(e, self.schema)[0])
        return fns, dts

    def _make_expr_fn(self, pred):
        """The expression-aggregate step: ``{"count", "esums"}`` a batch."""
        from ..ops.filter import _masked_sum, row_count, wide_sums
        fns, dts = self._expr_parts(self._agg_exprs)
        schema = self.schema
        wide = wide_sums(schema)

        def run(pages: torch.Tensor) -> dict:
            cols, valid = decode_pages(pages, schema)
            sel = select_rows(pred, cols, valid, schema)
            # each row's value stays in its expression dtype; only the
            # sum widens
            return {"count": row_count(sel, wide),
                    "esums": [_masked_sum(f(cols), sel, dt, wide)
                              for f, dt in zip(fns, dts)]}
        return run

    def _resolve_join_build(self, dev) -> None:
        """Load a broadcast-sized build table (one projection scan) into
        the host arrays :meth:`join` takes."""
        bt, bs, kc, vc = self._join_src
        out = Query(bt, bs).select([kc, vc]).run(device=dev)
        pc, _bk, _bv, mat, lim, off = self._join
        self._join = (pc, np.asarray(out[f"col{kc}"], np.int32),
                      np.asarray(out[f"col{vc}"], bs.col_dtype(vc)),
                      mat, lim, off)
        self._join_src = None

    def _resolve_star_builds(self, dev) -> None:
        """Load every dimension (one projection scan each) and sort it on
        the host; the join functions move it to the device once."""
        from ..ops.join import _sorted_build
        if self._star_resolved is not None:
            return
        resolved = []
        for j in self._star["joins"]:
            bs, kc, vc = j["schema"], j["key_col"], j["value_col"]
            cols = [kc] if vc is None or vc == kc else [kc, vc]
            out = Query(j["table"], bs).select(cols).run(device=dev)
            bk = np.asarray(out[f"col{kc}"], np.int32)
            bv = None if vc is None else np.asarray(out[f"col{vc}"],
                                                    bs.col_dtype(vc))
            try:
                keys, vals = _sorted_build(bk, bk if bv is None else bv,
                                           self.schema, j["probe_col"])
            except ValueError as e:
                raise StromError(_errno.EINVAL, f"star_join {j['table']}: "
                                                f"{e}") from None
            resolved.append((j["probe_col"], keys,
                             None if bv is None else vals, j["how"]))
        self._star_resolved = resolved

    @staticmethod
    def _rows_gather(run, fields: Sequence[str], dtypes):
        """A :meth:`_collect_rows` gather over a join row step: its
        per-row outputs compressed by ``hit`` on the pages' device, then
        moved to the host."""
        def gather(pages: torch.Tensor) -> dict:
            out = run(pages)
            m = out["hit"]
            res = {f: _host(out[f][m], dt) for f, dt in zip(fields, dtypes)}
            res["n"] = len(res[fields[0]])
            return res
        return gather

    def _join_value_dtype(self) -> np.dtype:
        from ..ops.join import _value_dtype
        if self._join_src is not None:
            _bt, bs, _kc, vc = self._join_src
            return bs.col_dtype(vc)
        return _value_dtype(self._join[2])

    def _join_row_fields(self, how: str):
        """The row step's outputs the row face keeps under *how*: a face
        that exposes no payload (semi/anti) or no partner mask (all but
        left) never moves them to the host."""
        fields = ["positions", "key"]
        dtypes = [np.dtype(np.int64), _I32]
        if how in ("inner", "left"):
            fields.append("payload")
            dtypes.append(self._join_value_dtype())
        if how == "left":
            fields.append("partner")
            dtypes.append(np.dtype(bool))
        return fields, dtypes

    @staticmethod
    def _join_rows_result(how: str, poss, keyv, payl=None,
                          partner=None) -> dict:
        """The row face's result, one contract for every strategy."""
        out = {"positions": poss, "keys": keyv,
               "count": np.int64(len(poss))}
        if how in ("inner", "left"):
            out["payload"] = payl
        if how == "left":
            out["matched"] = np.asarray(partner).astype(bool)
        return out

    def _run_join_rows(self, dev) -> dict:
        """SELECT with a broadcast JOIN: each batch probes the build and
        its emitted rows come back to the host in arrival order."""
        from ..ops.join import make_join_rows_fn
        probe_col, bk, bv, _mat, limit, offset = self._join
        how = self._join_how
        run = make_join_rows_fn(self.schema, probe_col, bk, bv,
                                predicate=self._predicate(), how=how)
        fields, dtypes = self._join_row_fields(how)
        arrs = self._collect_rows(self._rows_gather(run, fields, dtypes),
                                  fields, dtypes, dev, limit=limit,
                                  offset=offset)
        return self._join_rows_result(how, *arrs)

    def _run_star_rows(self, dev) -> dict:
        """The star join's row face: the requested fact columns, each
        dimension's payload and partner mask, and positions."""
        from ..ops.join import make_star_rows_fn
        st = self._star
        run = make_star_rows_fn(self.schema, self._star_resolved,
                                predicate=self._predicate(),
                                fact_cols=st["fact_cols"])
        fields = [f"c{c}" for c in st["fact_cols"]]
        dtypes = [self.schema.col_dtype(c) for c in st["fact_cols"]]
        for i, (_pc, _k, vals, _how) in enumerate(self._star_resolved):
            if vals is not None:
                fields.append(f"pay{i}")
                dtypes.append(vals.dtype)
            fields.append(f"m{i}")
            dtypes.append(np.dtype(bool))
        fields.append("positions")
        dtypes.append(np.dtype(np.int64))
        arrs = self._collect_rows(self._rows_gather(run, fields, dtypes),
                                  fields, dtypes, dev, limit=st["limit"],
                                  offset=st["offset"])
        out = dict(zip(fields, arrs))
        out["count"] = np.int64(len(out["positions"]))
        return out

    def _run_join_partitioned(self, dev, n_parts: int, mesh=None,
                              batch_pages: Optional[int] = None) -> dict:
        """The local Grace join, for a build side above
        ``join_broadcast_max``: one scan of the fact table a hash
        partition of the build, that partition alone on the device.
        Results add across partitions because every build key lives in
        exactly one; the left and anti faces restrict each pass to the
        probe rows whose key the pass owns, so an unpartnered row is
        emitted once.  Rows come in partition order, then arrival order
        (unspecified, as SQL without ORDER BY; equal to the broadcast
        result as a set).

        Over a *mesh*: one scan; the build lives hash-partitioned over dp
        (:mod:`..parallel.pjoin`, streamed from the table on disk when it
        is one) and each batch routes its rows to their key's owner, both
        faces (:meth:`_run_join_partitioned_mesh_rows` for rows)."""
        from ..ops.join import (hash_split_build, make_join_fn,
                                make_join_rows_fn)
        from .executor import _to_numpy, fold_results
        probe_col, bk, bv, materialize, limit, offset = self._join
        how = self._join_how
        pred = self._predicate()
        if mesh is not None and materialize:
            return self._run_join_partitioned_mesh_rows(mesh, batch_pages,
                                                        limit, offset)
        if mesh is not None:
            from ..parallel.pjoin import make_partitioned_join_step
            step = make_partitioned_join_step(
                mesh, self.schema, probe_col, bk, bv, predicate=pred,
                build_parts=self._streamed_build_parts(mesh, dev), how=how)
            acc = None
            for shards in self._mesh_page_batches(mesh, batch_pages):
                acc = fold_results(acc, _to_numpy(step(shards)))
                stats.add("nr_kernel_dispatch")
            return acc or {}
        own_needed = how in ("left", "anti")
        if self._join_src is not None:
            # one partition a pass from the table on disk: a limit that
            # stops early never reads the build rows of the skipped ones
            parts = self._streamed_build_partitions(n_parts, dev)
        else:
            parts = hash_split_build(bk, bv, n_parts)
        if materialize:
            stop = None if limit is None else offset + limit
            fields, dtypes = self._join_row_fields(how)
            got_all = [[] for _ in fields]
            gathered = 0
            for p, (pk, pv) in enumerate(parts):
                remaining = None if stop is None else stop - gathered
                if remaining is not None and remaining <= 0:
                    break
                run = make_join_rows_fn(
                    self.schema, probe_col, pk, pv, predicate=pred, how=how,
                    owner_part=(n_parts, p) if own_needed else None)
                got = self._collect_rows(self._rows_gather(run, fields,
                                                           dtypes),
                                         fields, dtypes, dev,
                                         limit=remaining)
                gathered += len(got[0])
                for acc, a in zip(got_all, got):
                    acc.append(a)
            if got_all[0]:
                arrs = [np.concatenate(a)[offset:stop] for a in got_all]
            else:       # limit=0: no partition scanned
                arrs = [np.zeros(0, dt) for dt in dtypes]
            return self._join_rows_result(how, *arrs)
        acc = None
        for p, (pk, pv) in enumerate(parts):
            run = make_join_fn(
                self.schema, probe_col, pk, pv, predicate=pred, how=how,
                owner_part=(n_parts, p) if own_needed else None)
            acc = fold_results(acc, self._scan(run, dev))
        # numpy per leaf: the sums list keeps each column's acc dtype
        return acc or {}

    def _mesh_page_batches(self, mesh, batch_pages: Optional[int]):
        """Lane 0's dp shards of page batches covering EVERY page of the
        table: the sharded stream for the batch-aligned body (the
        reference's batch size, 128 pages a dp shard by default), then
        buffered 8 MiB reads for the tail, zero-padded to a multiple of dp
        (zero pages decode as no valid tuples).  A process reads and holds
        only its own members' shards, tail included (None for another
        rank's), and every process yields the same number of batches.
        Shared by the mesh partitioned join's two faces; a consumer that
        stops early closes the stream."""
        from ..parallel.stream import ShardedBatchStream
        dp = mesh.dp
        devs = list(mesh.devices[:dp])
        with self._open_owned() as src:
            n_pages = src.size // PAGE_SIZE
            bp = int(batch_pages or (1 << 20) // PAGE_SIZE * dp)
            bp = min(max(bp // dp * dp, dp), n_pages // dp * dp)
            covered = 0
            if bp >= dp:
                with ShardedBatchStream(src, mesh, batch_pages=bp,
                                        session=self._session) as stream:
                    for _first, shards in stream:
                        yield shards[:dp]
                covered = n_pages // bp * bp
            tail = (8 << 20) // PAGE_SIZE
            for p0 in range(covered, n_pages, tail):
                npg = min(tail, n_pages - p0)
                r = -(-npg // dp)       # pages a shard, zero-padded
                shards = []
                for d, dev in enumerate(devs):
                    if not mesh.is_local(d):
                        shards.append(None)
                        continue
                    pages = np.zeros((r, PAGE_SIZE), np.uint8)
                    a, b = min(d * r, npg), min((d + 1) * r, npg)
                    if b > a:
                        src.read_buffered((p0 + a) * PAGE_SIZE, memoryview(
                            pages[:b - a].reshape(-1)))
                    shards.append(torch.from_numpy(pages).to(dev))
                yield shards

    def _streamed_build_parts(self, mesh, dev):
        """The mesh build for an on-disk build side (None when the build
        is host arrays): partition passes bounded by ``config
        join_build_host_max``."""
        if self._join_src is None:
            return None
        from ..parallel.pjoin import partition_build_sharded_from_table
        bt, bs, kc, vc = self._join_src
        return partition_build_sharded_from_table(
            bt, bs, kc, vc, mesh, session=self._session, device=dev)

    def _run_join_partitioned_mesh_rows(self, mesh, batch_pages,
                                        limit: Optional[int],
                                        offset: int) -> dict:
        """The mesh partitioned join's row face: each batch's rows (key and
        position words) route to their owner, and the owners' emitted rows
        come back to the host in batch, then owner, then sender, then
        arrival order; the stream stops reading once ``offset + limit``
        rows are in.  Over ranks each rank keeps the rows of its own
        owners, tagged with their (batch, owner) place; the rows a batch
        emitted are summed over the ranks, so every rank stops at the same
        batch and none leaves a collective early, and the ranks' rows
        then meet in one gather, the whole result on every rank."""
        from ..parallel import dist
        from ..parallel.pjoin import (combine_pos_words,
                                      make_partitioned_join_rows_step)
        probe_col, bk, bv = self._join[:3]
        how = self._join_how
        step = make_partitioned_join_rows_step(
            mesh, self.schema, probe_col, bk, bv,
            predicate=self._predicate(),
            build_parts=self._streamed_build_parts(mesh, mesh.home()),
            how=how)
        stop = None if limit is None else offset + limit
        fields, dtypes = self._join_row_fields(how)
        owned = [d for d in range(mesh.dp) if mesh.is_local(d)]
        chunks, gathered = [], 0
        batches = self._mesh_page_batches(mesh, batch_pages)
        try:
            for b, shards in enumerate(batches):
                if stop is not None and gathered >= stop:
                    break
                out = step(shards)
                stats.add("nr_kernel_dispatch")
                # one equal slab an owner of this process, in owner order
                per = out["hit"].shape[0] // len(owned)
                got = 0
                for k, d in enumerate(owned):
                    emit = out["hit"][k * per:(k + 1) * per]
                    part = {f: out[f][k * per:(k + 1) * per][emit]
                            for f in ("pos_lo", "pos_hi", *fields[1:])}
                    pos = combine_pos_words(part["pos_lo"].cpu().numpy(),
                                            part["pos_hi"].cpu().numpy())
                    chunks.append(((b, d), [pos] + [
                        _host(part[f], dt)
                        for f, dt in zip(fields[1:], dtypes[1:])]))
                    got += len(pos)
                if mesh.multi_process:
                    got = int(dist.all_reduce(torch.tensor(got)))
                gathered += got
        finally:
            batches.close()
        if mesh.multi_process:
            chunks = [c for part in dist.all_gather_object(chunks)
                      for c in part]
        chunks.sort(key=lambda c: c[0])
        if chunks:
            arrs = [np.concatenate([c[1][i] for c in chunks])[offset:stop]
                    for i in range(len(fields))]
        else:
            arrs = [np.zeros(0, dt) for dt in dtypes]
        return self._join_rows_result(how, *arrs)

    def _streamed_build_partitions(self, n_parts: int, dev):
        """Yield the Grace passes' ``(keys, values)`` partitions of the
        on-disk build.  Within ``join_build_host_max`` the table loads by
        one projection scan and splits on the host; above it each
        partition loads by its own hash-predicate scan, host RAM bounded
        to a partition, with the table's size and mtime checked between
        passes: a build table changed mid-query fails with EIO instead of
        counting keys that moved partitions twice."""
        from ..config import config
        from ..ops.join import hash_split_build, key_hash32
        bt, bs, kc, vc = self._join_src
        if os.path.getsize(bt) <= int(config.get("join_build_host_max")):
            out = Query(bt, bs).select([kc, vc]).run(device=dev)
            yield from hash_split_build(
                np.asarray(out[f"col{kc}"], np.int32),
                np.asarray(out[f"col{vc}"], bs.col_dtype(vc)), n_parts)
            return

        def stamp():
            st = os.stat(bt)
            return int(st.st_size), int(st.st_mtime_ns)

        s0 = stamp()
        for p in range(n_parts):
            part = Query(bt, bs) \
                .where(lambda cols, p=p: key_hash32(cols[kc]) % n_parts == p) \
                .select([kc, vc]).run(device=dev)
            if stamp() != s0:
                raise StromError(_errno.EIO, f"build table {bt} changed "
                                             f"between partition passes")
            yield (np.asarray(part[f"col{kc}"], np.int32),
                   np.asarray(part[f"col{vc}"], bs.col_dtype(vc)))
