"""Declarative query layer over one heap table: plan → stream → fold.

A reduced port of the JAX package's ``scan/query.py``: one :class:`Query`
builder over one heap table file, with a conjunctive ``where``, one
terminal operator (``aggregate`` or ``group_by``), ``explain`` and
``run``.  ``run`` streams the table through the scan pipeline
(:class:`.executor.TableScanner`) and folds each batch through a kernel:

* ``aggregate`` — the heap filter (B1, ``csrc/filter.cu``), or, where a
  fresh packed sidecar (``<table>.cpk``, :mod:`.colpack`) can serve the
  query, the pushdown decision (:mod:`.planner`): ``chip`` streams the
  packed pages to the device and decodes them there (B2,
  ``csrc/decode.cu``); ``host`` decodes them on the host into heap pages
  for B1;
* ``group_by`` — the GROUP BY kernel (B3, ``csrc/groupby.cu``).

On a CUDA device every batch goes through the CUDA kernels: predicates are
:class:`~..ops.filter.FilterPred` and keys :class:`~..ops.groupby.GroupKey`
descriptors, and a query the kernels cannot take is refused (EINVAL), never
run another way.  The plain PyTorch versions run for ``device="cpu"``,
where callables ``predicate(cols) -> bool`` and ``key(cols) -> ids`` work
too.

Left out against the JAX package: value-keyed ``group_by_cols``, nullable
and wide schemas, worker processes, meshes, index paths, select / top_k /
order_by / join / star terminals, the SQL facade and the VFS access path.
"""

from __future__ import annotations

import errno as _errno
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..api import StromError
from ..trace import recorder as _trace
from ..ops.filter import FilterPred
from ..ops.groupby import GroupKey, _check_agg_cols, combine_groupby
from ..stats import stats
from .heap import PAGE_SIZE, HeapSchema

__all__ = ["Query", "QueryPlan"]

_KERNELS = ("auto", "cuda", "plain")


@dataclass(frozen=True)
class QueryPlan:
    """What ``run()`` will do, decided before any I/O (EXPLAIN)."""

    operator: str          # aggregate | group_by
    kernel: str            # cuda | plain | invalid
    device: str
    n_pages: int
    reason: str
    pushdown: str = ""     # "" | chip | host | raw (packed-sidecar scan)

    def __str__(self) -> str:
        pd = f", pushdown {self.pushdown}" if self.pushdown else ""
        return (f"{self.operator} scan  [{self.kernel} kernel on "
                f"{self.device}{pd}]\n  pages: {self.n_pages}\n"
                f"  {self.reason}")


class Query:
    """Fluent scan builder over one heap table file.

    >>> q = (Query("/data/t.heap", schema)
    ...      .where(FilterPred(((0, "gt", 10),)))
    ...      .group_by(GroupKey(1, mod=8), 8, agg_cols=[0]))
    >>> print(q.explain())
    >>> out = q.run()
    """

    def __init__(self, source, schema: HeapSchema):
        if isinstance(source, os.PathLike):
            source = str(source)
        if not isinstance(source, str):
            raise StromError(_errno.EINVAL, "Query takes one heap table "
                                            "file path")
        self.source = source
        self.schema = schema
        self._terms: tuple = ()
        self._callables: List[Callable] = []
        self._op = "aggregate"
        self._terminal_set = False
        self._agg_cols: Optional[Sequence[int]] = None
        self._group: Optional[tuple] = None

    # -- builders -----------------------------------------------------------
    def where(self, predicate: Union[FilterPred, Callable]) -> "Query":
        """Row filter: a :class:`FilterPred` whose terms carry their values,
        or ``predicate(cols) -> (B, T) bool`` (CPU only).  Chained filters
        form a conjunction; FilterPred terms concatenate (at most 8)."""
        if isinstance(predicate, FilterPred):
            if any(v is None for _c, _o, v in predicate.terms):
                raise StromError(_errno.EINVAL, "a Query predicate carries "
                                                "its values (no None terms)")
            self._terms = FilterPred(self._terms + predicate.terms).terms
        elif callable(predicate):
            self._callables.append(predicate)
        else:
            raise StromError(_errno.EINVAL, "where() takes a FilterPred or "
                                            "a callable")
        return self

    def _require_no_terminal(self) -> None:
        if self._terminal_set:
            raise StromError(_errno.EINVAL, "one terminal operator per query "
                                            "(it is one scan node)")

    def aggregate(self, cols: Optional[Sequence[int]] = None) -> "Query":
        """Terminal: selected-row count + per-column masked sums (of *cols*,
        in that order; all columns when None)."""
        self._require_no_terminal()
        self._op = "aggregate"
        self._terminal_set = True
        self._agg_cols = None if cols is None else [int(c) for c in cols]
        return self

    def group_by(self, key: Union[GroupKey, Callable], n_groups: int, *,
                 agg_cols: Optional[Sequence[int]] = None,
                 having: Optional[Callable] = None) -> "Query":
        """Terminal: per-group count/sum/min/max/avg/var/stddev.  *key* is
        a :class:`GroupKey` or ``key(cols) -> (B, T)`` ids (CPU only); ids
        outside ``[0, n_groups)`` fall into no group.

        ``having(groups) -> (G,) bool`` filters groups after aggregation
        (SQL HAVING) on the finished numpy result; surviving groups are
        compressed out, their ids in ``"groups"``."""
        self._require_no_terminal()
        self._op = "group_by"
        self._terminal_set = True
        self._group = (key, int(n_groups), agg_cols, having)
        return self

    # -- planning -----------------------------------------------------------
    def _predicate(self):
        """The conjunction: a FilterPred, or a callable ``(cols, th)`` when
        a callable joined it."""
        pred = FilterPred(self._terms)
        if not self._callables:
            return pred
        schema, calls = self.schema, list(self._callables)

        def conj(cols, _threshold):
            sel = pred.mask(cols, torch.ones(cols[0].shape, dtype=torch.bool,
                                             device=cols[0].device),
                            schema, 0)
            for fn in calls:
                sel = sel & fn(cols)
            return sel
        return conj

    def _key(self):
        key = self._group[0]
        if isinstance(key, GroupKey):
            return key
        return lambda cols, _threshold: key(cols)

    def _invalid(self) -> str:
        """Why the query cannot run at all ('' = it can)."""
        s = self.schema
        if s.has_wide or any(s.nullable or ()):
            return ("wide/nullable page layouts are not served by the "
                    "port's Query (4-byte non-null columns only)")
        if s.n_cols == 0:
            return "a schema without columns"
        try:
            FilterPred(self._terms).values(s, 0)
            if self._op == "group_by":
                key, g, agg, _hv = self._group
                _check_agg_cols(s, agg)
                if isinstance(key, GroupKey):
                    key.check(s)
                elif not callable(key):
                    return "the key is a GroupKey or a callable"
                if g < 1:
                    return f"n_groups {g}: at least 1"
        except StromError as e:
            return str(e)
        if self._op == "aggregate" and self._agg_cols is not None:
            bad = [c for c in self._agg_cols if not 0 <= c < s.n_cols]
            if bad:
                return (f"aggregate column {bad[0]} out of range (schema "
                        f"has {s.n_cols})")
        return ""

    def _cuda_refusal(self) -> str:
        """Why the CUDA kernels cannot run this query ('' = they can)."""
        from ..ops import filter_cuda, groupby_cuda
        if self._op == "group_by":
            key, g, _agg, _hv = self._group
            return groupby_cuda.kernel_refusal(self.schema, key, g,
                                               self._predicate())
        return filter_cuda.kernel_refusal(self.schema, self._predicate())

    def _pushdown_need_cols(self):
        """Columns the packed scan must expand: the aggregate projection
        when no predicate reads other columns, else all."""
        if not self._terms and not self._callables \
                and self._agg_cols is not None:
            return tuple(self._agg_cols)
        return None

    def _pushdown_probe(self):
        """``(PushdownDecision, PackedMeta)`` when a fresh packed sidecar
        can serve this aggregate, else None."""
        if self._op != "aggregate":
            return None
        from .colpack import probe_packed
        meta = probe_packed(self.source)
        if meta is None:
            return None
        from .planner import decide_pushdown
        return decide_pushdown(meta, self._pushdown_need_cols()), meta

    def explain(self, *, device=None, kernel: str = "auto") -> QueryPlan:
        """The plan ``run(device=..., kernel=...)`` would execute."""
        from ..hbm.staging import resolve_device
        if kernel not in _KERNELS:
            raise StromError(_errno.EINVAL, f"kernel {kernel!r} not one of "
                                            f"{_KERNELS}")
        dev = resolve_device(device)
        n_pages = os.path.getsize(self.source) // PAGE_SIZE
        why = self._invalid()
        cuda = dev.type == "cuda"
        if not why and cuda and kernel == "plain":
            why = "the plain versions run only for CPU tensors"
        if not why and not cuda and kernel == "cuda":
            why = "the CUDA kernels need a CUDA device"
        if not why and cuda:
            why = self._cuda_refusal()
            if why:
                why += "; run on device='cpu' for the plain version"
        if why:
            return QueryPlan(self._op, "invalid", str(dev), n_pages, why)
        face = "cuda" if cuda else "plain"
        if self._op == "group_by":
            g = self._group[1]
            reason = (f"GROUP BY into {g} groups: B3 groupby_pages "
                      f"(csrc/groupby.cu, shared-memory group "
                      f"accumulators)" if cuda else
                      f"GROUP BY into {g} groups: plain PyTorch version")
        else:
            reason = ("aggregate: B1 filter_pages (csrc/filter.cu, fused "
                      "decode + predicate + masked sums)" if cuda else
                      "aggregate: plain PyTorch filter")
        pd = ""
        probe = self._pushdown_probe()
        if probe is not None:
            dec, _meta = probe
            pd = dec.mode
            reason += "; " + dec.explain()
            if pd == "chip":
                reason += ("; the packed pages decode in B2 "
                           "decode_filter_pages (csrc/decode.cu)" if cuda
                           else "; the packed pages decode in the plain "
                                "version")
        return QueryPlan(self._op, face, str(dev), n_pages, reason, pd)

    # -- execution ----------------------------------------------------------
    def _project(self, out: dict) -> dict:
        if self._agg_cols is None:
            return out
        return {"count": out["count"],
                "sums": [out["sums"][c] for c in self._agg_cols]}

    def _build_fn(self):
        """Returns ``(fn(pages) -> dict, combine or None)`` over heap
        pages."""
        pred = self._predicate()
        if self._op == "group_by":
            from ..ops.groupby_cuda import groupby_pages_cuda
            _key, g, agg, _hv = self._group
            key = self._key()
            return (lambda pages: groupby_pages_cuda(
                pages, 0, self.schema, key, g, agg_cols=agg,
                predicate=pred)), combine_groupby
        from ..ops.filter_cuda import filter_pages_cuda
        return (lambda pages: self._project(
            filter_pages_cuda(pages, 0, self.schema, pred))), None

    def run(self, *, device=None, kernel: str = "auto") -> dict:
        """Execute the planned scan and return numpy results.  *device*
        defaults to ``cuda:0`` (ENODEV without a card; ``"cpu"`` for the
        plain versions); *kernel* is ``"auto"``, ``"cuda"`` or
        ``"plain"`` and must fit the device."""
        from ..hbm.staging import resolve_device
        from .executor import TableScanner
        dev = resolve_device(device)
        plan = self.explain(device=dev, kernel=kernel)
        if plan.kernel == "invalid":
            raise StromError(_errno.EINVAL, f"query not executable: "
                                            f"{plan.reason}")
        if plan.pushdown in ("chip", "host"):
            # re-probe: the sidecar may have been retired since EXPLAIN
            probe = self._pushdown_probe()
            if probe is not None and probe[0].mode in ("chip", "host"):
                return self._run_pushdown(probe[0], probe[1], dev)
        fn, combine = self._build_fn()
        with TableScanner(self.source, self.schema) as sc:
            out = sc.scan_filter(fn, device=dev, combine=combine)
        return self._finalize(out)

    def _run_pushdown(self, dec, meta, dev: torch.device) -> dict:
        """Aggregate over the packed sidecar instead of the heap table.

        ``chip``: the ``.cpk`` pages stream to the device unexpanded and
        the fused decode kernel expands them there, so the link carries
        packed bytes.  ``host``: packed bytes leave the disk, expand to
        heap pages on the host, and the heap filter consumes them.
        Integer sums are byte-identical to the heap scan on both legs.
        The whole leg is one ``pushdown_decode`` span."""
        t0 = time.monotonic_ns()
        try:
            return self._run_pushdown_leg(dec, meta, dev)
        finally:
            if _trace.active:
                _trace.span("pushdown_decode", t0, time.monotonic_ns(),
                            length=meta.packed_bytes,
                            args={"mode": dec.mode,
                                  "wire_bytes": dec.wire_bytes,
                                  "logical_bytes": dec.logical_bytes})

    def _run_pushdown_leg(self, dec, meta, dev: torch.device) -> dict:
        from ..engine import open_source
        from .executor import TableScanner, _to_numpy, fold_results
        pred = self._predicate()
        saved = max(meta.logical_bytes / max(meta.packed_bytes, 1) - 1.0,
                    0.0)
        if dec.mode == "chip":
            from ..ops.decode_cuda import decode_filter_pages_cuda
            need = self._pushdown_need_cols()

            def fn(pages):
                stats.add("nr_pushdown_decode_chip")
                stats.add("bytes_wire_saved",
                          int(pages.shape[0] * PAGE_SIZE * saved))
                return decode_filter_pages_cuda(pages, 0, meta, pred,
                                                need_cols=need)

            with TableScanner(meta.path) as sc:
                out = sc.scan_filter(fn, device=dev)
            return self._finalize(self._project(out) if out else out)
        from ..ops.filter_cuda import filter_pages_cuda
        from .colpack import decode_pages_numpy
        from .heap import build_pages
        acc = None
        batch = (8 << 20) // PAGE_SIZE
        with open_source(meta.path) as src:
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
                acc = fold_results(
                    acc, self._project(filter_pages_cuda(
                        pages, 0, self.schema, pred)))
        return self._finalize({} if acc is None else _to_numpy(acc))

    def _finalize(self, out: dict) -> dict:
        """Post-aggregation decoration for group_by: ``avgs`` (sum/count),
        ``vars``/``stds`` (population variance via E[x²]−E[x]², NaN for
        empty groups) and HAVING, applied after the cross-batch fold."""
        if self._op != "group_by" or not out:
            return out
        having = self._group[3]
        count = np.asarray(out["count"])
        sums = np.asarray(out["sums"])
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = np.maximum(count, 1)
            avgs = np.where(count > 0, sums / denom, np.nan)
        res = {"count": count, "sums": sums,
               "mins": np.asarray(out["mins"]),
               "maxs": np.asarray(out["maxs"]), "avgs": avgs}
        sumsqs = np.asarray(out["sumsqs"], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            # clamp: E[x^2]-E[x]^2 can dip epsilon-negative in floats
            vars_ = np.maximum(
                np.where(count > 0, sumsqs / denom - np.square(avgs),
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
        return res
