"""Partitioned hash join over the ring (all-to-all repartition).

A port of the JAX package's ``parallel/pjoin.py``, the scale-out face of
:mod:`..ops.join`.  The broadcast join holds the whole build side on every
member, which stops working when the dimension table nears device memory;
here both sides repartition by key hash:

* the build side hash-splits across ``dp`` at set-up (member *d* holds the
  keys with ``key_hash32(k) % dp == d``, sorted, padded with ``INT32_MAX``
  to the largest partition, and ``nreal`` masks the pads out);
* each scanned fact batch routes its selected rows to their key's owner
  with :func:`.exchange.bucket_dispatch`;
* each owner probes only its partition (``searchsorted``, as the
  broadcast probe), and the per-owner aggregates fold over dp.

The exchange capacity is the whole local batch, so a join never drops a
row whatever the skew.  Fact columns ride the int32 slab as their bits
(float32 viewed, uint32 wrapped) and are restored on the owner.

On an ``(sp, dp)`` mesh the join runs over lane 0's dp ring: the
reference's ``P("dp", None)`` replicates the same work on every lane.

Over ranks (:mod:`.dist`) each process holds the build partitions, scans
the pages and probes for its own members of lane 0; the rows cross in
the exchange's all-to-all, the aggregates meet in one
:func:`.dist.all_reduce`, and the row face returns only the rows routed
to this process's members.
"""

from __future__ import annotations

import errno as _errno
import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..api import StromError
from ..ops.filter import (_masked_sum, decode_pages, global_row_positions,
                          row_count, select_rows, wide_sums)
from ..ops.join import (_emit_mask, _value_dtype, check_join_how,
                        key_hash32, sorted_has_duplicates)
from ..scan.heap import HeapSchema
from . import dist
from .dscan import split_pages
from .exchange import bucket_dispatch

__all__ = ["make_partitioned_join_step", "make_partitioned_join_rows_step",
           "partition_build_sharded", "partition_build_sharded_from_table",
           "combine_pos_words", "BuildParts"]

_I32_MAX = (1 << 31) - 1
_U32 = 0xFFFFFFFF


class BuildParts(NamedTuple):
    """The hash-partitioned build side: ``keys[d]``/``vals[d]`` member
    *d*'s ``(cap,)`` partition on its device (uint32 values as int64, the
    decode's form; None for another rank's member), ``nreal[d]`` its real
    rows, ``vdt`` the values' dtype,
    ``host_rows_peak`` the most build rows the host held at once while
    building (the streamed build's accounting)."""
    keys: List[torch.Tensor]
    vals: List[torch.Tensor]
    nreal: List[int]
    vdt: np.dtype
    host_rows_peak: int

    def host_arrays(self):
        """``(keys (dp, cap), vals (dp, cap), nreal (dp, 1))`` as numpy,
        the reference's sharded arrays' layout."""
        v = np.stack([t.cpu().numpy() for t in self.vals])
        return (np.stack([t.cpu().numpy() for t in self.keys]),
                v.astype(self.vdt), np.asarray(self.nreal,
                                               np.int32).reshape(-1, 1))


def _lane0(mesh):
    return list(mesh.devices[:mesh.dp])


def _place(parts_k, parts_v, vdt: np.dtype, mesh, peak: int) -> BuildParts:
    devs = _lane0(mesh)
    keys, vals = [], []
    for d, dev in enumerate(devs):
        if not mesh.is_local(d):
            keys.append(None)
            vals.append(None)
            continue
        k, v = parts_k[d], parts_v[d]
        if isinstance(v, np.ndarray) and vdt == np.dtype(np.uint32):
            v = v.astype(np.int64)
        keys.append(torch.as_tensor(k).to(dev))
        vals.append(torch.as_tensor(v).to(dev))
    return BuildParts(keys, vals, [0] * len(devs), vdt, peak)


def partition_build_sharded(build_keys, build_values, mesh,
                            schema: HeapSchema, probe_col: int) -> BuildParts:
    """Hash-partition the (validated: unique int32 keys) build table over
    dp and place partition *d* on lane 0's member *d*: keys sorted
    ascending, padded to the largest partition with ``INT32_MAX``; a
    genuine ``INT32_MAX`` key still matches (it sorts before the pads).
    The stable sort, the uniqueness check and the split run on the first
    member's device (the reference's host ``argsort`` order: the keys are
    unique, so every stable sort agrees)."""
    if schema.col_dtype(probe_col) != np.dtype(np.int32):
        raise ValueError("probe column must be int32")
    bv_np = np.asarray(build_values, _value_dtype(build_values))
    dev = mesh.home()
    bk = torch.from_numpy(np.ascontiguousarray(build_keys, np.int32)).to(dev)
    bk, order = torch.sort(bk, stable=True)
    if bk.shape[0] > 1 and bool((bk[1:] == bk[:-1]).any()):
        raise ValueError("build_keys must be unique (inner join on a "
                         "dimension key)")
    vdt = bv_np.dtype
    bv = torch.from_numpy(bv_np.astype(np.int64) if vdt == np.dtype(
        np.uint32) else np.ascontiguousarray(bv_np)).to(dev)[order]
    dp = mesh.dp
    part = key_hash32(bk) % dp
    sizes = torch.bincount(part, minlength=dp).tolist()
    cap = max(1, max(sizes))
    ks, vs = [], []
    for p in range(dp):
        sel = part == p
        kp = torch.full((cap,), _I32_MAX, dtype=torch.int32, device=dev)
        vp = torch.zeros((cap,), dtype=bv.dtype, device=dev)
        kp[:sizes[p]] = bk[sel]         # bk sorted: slices stay sorted
        vp[:sizes[p]] = bv[sel]
        ks.append(kp)
        vs.append(vp)
    out = _place(ks, vs, vdt, mesh, dp * cap)
    return out._replace(nreal=[int(n) for n in sizes])


def partition_build_sharded_from_table(table_path: str, build_schema,
                                       key_col: int, value_col: int,
                                       mesh, *, session=None, device=None,
                                       budget: Optional[int] = None
                                       ) -> BuildParts:
    """The partitioned build side STREAMED from an on-disk heap table: host
    RAM during set-up is bounded to one partition plus a scan batch, not
    the dp × cap tables of :func:`partition_build_sharded`.

    A table of at most *budget* bytes (config ``join_build_host_max`` by
    default) loads with one projection scan and partitions in memory.
    Above it, one streamed GROUP BY on the owner hash sizes the
    partitions, then each partition is built by its own hash-predicate
    scan (only its rows come back), sorted stably, padded and placed on
    its member.  ``host_rows_peak`` reports the largest partition held
    (at most ``cap``).  A table that changes between passes is EIO.
    Partitions are bit-identical to the in-memory build's.  Over ranks a
    process builds only the partitions of its own members of lane 0."""
    from ..config import config
    from ..scan.query import Query
    dp = mesh.dp
    if build_schema.col_dtype(key_col) != np.dtype(np.int32):
        raise StromError(_errno.EINVAL, "build key column must be int32")
    dt_v = build_schema.col_dtype(value_col)
    if budget is None:
        budget = int(config.get("join_build_host_max"))
    dev = device if device is not None else mesh.home()
    if os.path.getsize(table_path) <= budget:
        out = Query(table_path, build_schema) \
            .select([key_col, value_col]).run(session=session, device=dev)
        parts = partition_build_sharded(out[f"col{key_col}"],
                                        out[f"col{value_col}"], mesh,
                                        build_schema, key_col)
        return parts._replace(host_rows_peak=len(out[f"col{key_col}"]))

    def owner(cols, _th=0):
        return key_hash32(cols[key_col]) % dp

    # pass 0: partition sizes; cap is the global max so every member's
    # partition has one shape
    sizes_out = Query(table_path, build_schema).group_by(
        owner, dp, agg_cols=[value_col]).run(session=session, device=dev)
    sizes = np.asarray(sizes_out["count"]).reshape(-1).astype(np.int64)
    cap = max(1, int(sizes.max()))
    ks, vs, peak = [], [], 0
    for p in range(dp):
        if not mesh.is_local(p):        # another rank builds it
            ks.append(None)
            vs.append(None)
            continue
        part = Query(table_path, build_schema) \
            .where(lambda cols, _th=0, p=p: owner(cols) == p) \
            .select([key_col, value_col]) \
            .run(session=session, device=dev)
        pk = np.asarray(part[f"col{key_col}"], np.int32)
        pv = np.asarray(part[f"col{value_col}"], dt_v)
        order = np.argsort(pk, kind="stable")
        if sorted_has_duplicates(pk[order]):
            raise ValueError("build_keys must be unique (inner join on a "
                             "dimension key)")
        n = len(pk)
        if n != int(sizes[p]):
            raise StromError(_errno.EIO, f"build table changed between "
                                         f"passes (partition {p}: {n} != "
                                         f"{sizes[p]})")
        peak = max(peak, n)
        kp = np.full(cap, _I32_MAX, np.int32)
        vp = np.zeros(cap, dt_v)
        kp[:n] = pk[order]
        vp[:n] = pv[order]
        ks.append(kp)
        vs.append(vp)
    out = _place(ks, vs, _value_dtype(np.zeros(0, dt_v)), mesh, peak)
    return out._replace(nreal=[int(s) for s in sizes])


def _check_schema(schema: HeapSchema) -> None:
    for c in range(schema.n_cols):
        if schema.col_dtype(c).itemsize != 4:
            raise StromError(_errno.EINVAL, f"the partitioned join's exchange "
                                            f"carries 4-byte columns; c{c} is "
                                            f"{schema.col_dtype(c)}")


def _word(col: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """A decoded 4-byte column as the int32 word the slab carries."""
    if dt.kind == "f":
        return col.view(torch.int32)
    return col.to(torch.int32)      # uint32 arrives as int64: wraps


def _unword(w: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    if dt.kind == "f":
        return w.view(torch.float32)
    if dt == np.dtype(np.uint32):
        return w.to(torch.int64) & _U32
    return w


def _route(pages_list, schema, probe_col, predicate, extra, parts,
           mesh=None):
    """Decode each member's pages, route the selected rows (probe key plus
    *extra* words) to their owners, and probe there.  Returns per owner
    ``(recv, rvalid, hit, idx)`` (None for another rank's owner)."""
    dp = len(pages_list)
    owners = mesh.owners[:dp] if mesh is not None and mesh.multi_process \
        else None
    devs = [p.device if p is not None else mesh.devices[d]
            for d, p in enumerate(pages_list)]
    rows, buckets, oks = [], [], []
    for pages in pages_list:
        if pages is None:
            rows.append(None)
            buckets.append(None)
            oks.append(None)
            continue
        cols, valid = decode_pages(pages, schema)
        sel = select_rows(predicate, cols, valid, schema).reshape(-1)
        probe = cols[probe_col].reshape(-1)
        rows.append(torch.stack([probe.to(torch.int32)]
                                + extra(pages, cols), -1))
        buckets.append((key_hash32(probe) % dp).to(torch.int32))
        oks.append(sel)
    # capacity = the whole local batch: the exchange never drops a row
    n = max(r.shape[0] for r in rows if r is not None)
    if owners is not None:
        n = int(dist.all_reduce(torch.tensor(n), "max"))
    recv, counts, _keep = bucket_dispatch(rows, buckets, oks, dp, n,
                                          devices=devs, owners=owners)
    out = []
    for b in range(dp):
        if recv[b] is None:
            out.append(None)
            continue
        slot = torch.arange(dp * n, device=devs[b])
        rvalid = (slot % n) < counts[b][slot // n]
        k = parts.keys[b]
        rk = recv[b][:, 0].contiguous()
        idx = torch.searchsorted(k, rk).clamp_(0, k.shape[0] - 1)
        hit = rvalid & (idx < parts.nreal[b]) & (k[idx] == rk)
        out.append((recv[b], rvalid, hit, idx))
    return out


def _shards_of(mesh, pages) -> List[torch.Tensor]:
    """Lane 0's dp shards of a batch: a list of shards as the mesh's
    streams yield (lane 0 first), or one batch to split."""
    got = list(pages[:mesh.dp]) if isinstance(pages, (list, tuple)) \
        else split_pages(pages, mesh)
    # lane 0's members of this rank only (another lane's copy of a
    # column is not a sender)
    return [t if mesh.is_local(d) else None for d, t in enumerate(got)]


def _fold(parts: List[torch.Tensor], home, ranks: bool = False
          ) -> torch.Tensor:
    """Sum per-owner scalars on *home*; unsigned ones through their signed
    bits (torch adds no uint32); with *ranks*, then over every rank."""
    dt = parts[0].dtype
    if dt in (torch.uint32, torch.uint64):
        sdt = torch.int32 if dt == torch.uint32 else torch.int64
        out = sum(p.view(sdt).to(home) for p in parts).view(dt)
    else:
        out = sum(p.to(home) for p in parts)
    return dist.all_reduce(out) if ranks else out


def _check_ranks(mesh) -> None:
    """Over ranks, every rank needs a member of lane 0 (its share of the
    join's fold)."""
    if mesh.multi_process and not any(mesh.is_local(d)
                                      for d in range(mesh.dp)):
        raise StromError(_errno.EINVAL, f"rank {dist.process_index()} "
                                        f"owns no member of lane 0")


def make_partitioned_join_step(mesh, schema: HeapSchema, probe_col: int,
                               build_keys=None, build_values=None, *,
                               predicate=None,
                               build_parts: Optional[BuildParts] = None,
                               how: str = "inner"):
    """Build ``step(pages) -> dict``, the partitioned join over one page
    batch (a host array or tensor divisible by dp, or the per-member
    shards of a mesh stream).  The result contract is
    :func:`..ops.join.make_join_fn`'s for the same *how* — ``matched``,
    ``sums`` over every fact column (``step.sum_cols``), inner/left
    ``payload_sum``, left ``null_count`` — in the same accumulation
    dtypes, on lane 0's member 0 (``nncounts`` too where a column is
    nullable: its NULL bits ride the slab beside the words).  Every routed
    row reaches its key's owner once, so left and anti need no Grace
    ownership restriction.

    *predicate*: a FilterPred or ``predicate(cols, threshold)``.
    *build_parts*: a prebuilt :class:`BuildParts` (the streamed build);
    otherwise *build_keys*/*build_values* are partitioned here."""
    check_join_how(how)
    _check_schema(schema)
    _check_ranks(mesh)
    parts = build_parts or partition_build_sharded(
        build_keys, build_values, mesh, schema, probe_col)
    sum_cols = list(range(schema.n_cols))
    col_dts = [schema.col_dtype(c) for c in sum_cols]
    nullable = [c for c in sum_cols if schema.col_nullable(c)]
    wide = wide_sums(schema)
    home = mesh.home()
    ranks = mesh.multi_process

    def extra(_pages, cols):
        return [_word(cols[c].reshape(-1), dt)
                for c, dt in zip(sum_cols, col_dts)] + \
            [cols.nulls[c].reshape(-1).to(torch.int32) for c in nullable]

    def step(pages) -> dict:
        per = []
        for routed, v in zip(
                _route(_shards_of(mesh, pages), schema, probe_col,
                       predicate, extra, parts, mesh), parts.vals):
            if routed is None:
                continue
            recv, rvalid, hit, idx = routed
            emit = _emit_mask(how, rvalid, hit)
            o = {"matched": row_count(emit, wide),
                 "sums": [_masked_sum(_unword(recv[:, 1 + i], dt), emit, dt,
                                      wide)
                          for i, dt in enumerate(col_dts)]}
            if nullable:
                null_of = {c: recv[:, 1 + len(sum_cols) + j].bool()
                           for j, c in enumerate(nullable)}
                o["nncounts"] = [row_count(emit & ~null_of[c], wide)
                                 if c in null_of else o["matched"]
                                 for c in sum_cols]
            if how in ("inner", "left"):
                o["payload_sum"] = _masked_sum(v[idx], hit, parts.vdt, wide)
            if how == "left":
                o["null_count"] = row_count(emit & ~hit, wide)
            per.append(o)
        out = {"matched": _fold([o["matched"] for o in per], home, ranks),
               "sums": [_fold([o["sums"][i] for o in per], home, ranks)
                        for i in range(len(sum_cols))]}
        if nullable:
            out["nncounts"] = [_fold([o["nncounts"][i] for o in per], home,
                                     ranks) for i in range(len(sum_cols))]
        for k in ("payload_sum", "null_count"):
            if k in per[0]:
                out[k] = _fold([o[k] for o in per], home, ranks)
        return out

    step.sum_cols = sum_cols
    return step


def combine_pos_words(lo: np.ndarray, hi: np.ndarray,
                      dtype=np.int64) -> np.ndarray:
    """Row positions routed through the int32 exchange as (lo, hi) words,
    rejoined on the host; with int32 positions ``hi`` is all zeros and
    this is the identity."""
    full = (lo.astype(np.uint32).astype(np.int64)
            | (hi.astype(np.int64) << 32))
    return full.astype(dtype)


def make_partitioned_join_rows_step(mesh, schema: HeapSchema,
                                    probe_col: int, build_keys=None,
                                    build_values=None, *,
                                    predicate=None,
                                    build_parts: Optional[BuildParts] = None,
                                    how: str = "inner"):
    """Row twin of :func:`make_partitioned_join_step`: the same routing,
    but each owner reports its per-routed-row outcome — ``hit`` (the emit
    mask under *how*), the probed ``key``, the row's position as
    (``pos_lo``, ``pos_hi``) int32 words, inner/left the matched build
    ``payload`` (0 where unpartnered; uint32 as int64), left ``partner``.
    ``step(pages) -> dict`` of flat ``(dp * dp * n_local,)`` tensors in
    owner order, then sender order, then arrival order, on lane 0's
    member 0; rows whose ``hit`` is False are routing pads or rows not
    emitted.  Positions travel with the row: the outcome lives on the
    key's owner, not on the member that scanned the page.  Over ranks the
    tensors hold only the owners of this rank (in owner order), on its
    first member."""
    check_join_how(how)
    _check_ranks(mesh)
    parts = build_parts or partition_build_sharded(
        build_keys, build_values, mesh, schema, probe_col)
    home = mesh.home()

    def extra(pages, _cols):
        pos = global_row_positions(pages, schema).reshape(-1)
        return [(pos & _U32).to(torch.int32), (pos >> 32).to(torch.int32)]

    def step(pages) -> dict:
        outs = {k: [] for k in ("hit", "key", "pos_lo", "pos_hi",
                                "payload", "partner")}
        for routed, v in zip(
                _route(_shards_of(mesh, pages), schema, probe_col,
                       predicate, extra, parts, mesh), parts.vals):
            if routed is None:
                continue
            recv, rvalid, hit, idx = routed
            outs["hit"].append(_emit_mask(how, rvalid, hit).to(home))
            outs["key"].append(recv[:, 0].to(home))
            outs["pos_lo"].append(recv[:, 1].to(home))
            outs["pos_hi"].append(recv[:, 2].to(home))
            if how in ("inner", "left"):
                outs["payload"].append(torch.where(
                    hit, v[idx], torch.zeros((), dtype=v.dtype,
                                             device=v.device)).to(home))
            if how == "left":
                outs["partner"].append(hit.to(home))
        return {k: torch.cat(v) for k, v in outs.items() if v}

    return step
