"""Distributed scan: dp-sharded page batches, sp column lanes, and a fold
of the members' aggregates.

A port of the JAX package's ``parallel/dscan.py``.  The reference's
multi-worker scan shares an atomic block cursor and each worker scans a
disjoint page subset (`pgsql/nvme_strom.c:1057-1112`).  Over an ``(sp,
dp)`` mesh (:mod:`.mesh`):

* pages shard across ``dp`` (each member filters a disjoint page subset —
  the worker-cursor analog),
* wide schemas split their columns across ``sp`` lanes (every lane
  evaluates the predicate; lane *s* keeps the sums of its own
  ``ceil(n_cols / sp)`` columns),

and the members' results fold as the reference's ``psum``: the count over
dp (it is the same on every lane), the sums over both axes (disjoint
across lanes).

Each member's step is the page filter: B1 (:mod:`..ops.filter_cuda`) on a
CUDA member, its plain version on a CPU member.  Over ranks (:mod:`.dist`)
each process filters its own members' shards and folds them, and the
folds meet in one :func:`.dist.all_reduce` (the cross-process psum): the
result is the same on every rank.  The accumulation dtypes
are the reference's: the count and 4-byte integer sums are int32 and wrap
(``jnp.sum`` with ``x64`` off), 64-bit under the port's ``x64``
(:func:`..ops.filter.wide_sums`, ``jnp.sum`` under ``jax_enable_x64``);
float sums are float32; the stacked sums take the promotion of
``jnp.stack`` (a float column makes them float32).
"""

from __future__ import annotations

import contextlib
import errno as _errno
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..api import StromError
from ..ops.filter import DEFAULT_SCHEMA, STEP_PRED, FilterPred, wide_sums
from ..ops.filter_cuda import filter_pages_cuda
from ..scan.heap import HeapSchema
from . import dist
from .mesh import RingMesh, Shards, make_scan_mesh

__all__ = ["make_distributed_scan_step", "shard_pages"]


def split_pages(pages, mesh: RingMesh) -> List[torch.Tensor]:
    """A page batch (numpy or tensor, ``(B, PAGE_SIZE)``, ``B`` divisible
    by dp) -> the dp shards, shard *d* on this process's first member of
    column *d* (None for a column with no member here)."""
    t = pages if isinstance(pages, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(pages))
    dp = mesh.dp
    if t.shape[0] % dp:
        raise StromError(_errno.EINVAL, f"{t.shape[0]} pages do not divide "
                                        f"over dp={dp}")
    r = t.shape[0] // dp
    need = set(mesh.local_columns())
    return [t[d * r:(d + 1) * r].to(mesh.column_device(d)) if d in need
            else None for d in range(dp)]


def shard_pages(pages, mesh: RingMesh) -> Shards:
    """Place a page batch over the mesh: dp shard *d* (:func:`split_pages`)
    on every lane's member of column *d*."""
    return mesh.replicate(split_pages(pages, mesh))


def _stack_dtype(sums: List[torch.Tensor]) -> torch.dtype:
    """The dtype ``jnp.stack`` gives the per-column sums."""
    kinds = {s.dtype for s in sums}
    if any(k.is_floating_point for k in kinds):
        return torch.float32
    if kinds == {torch.uint32}:
        return torch.uint32
    if kinds == {torch.uint64}:
        return torch.uint64
    return torch.int64 if any(k in (torch.int64, torch.uint64)
                              for k in kinds) else torch.int32


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Unsigned sums as their signed bits (torch adds no uint32)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    return t.view(torch.int64) if t.dtype == torch.uint64 else t


def make_distributed_scan_step(devices: Optional[Sequence] = None, *,
                               sp: int = 1,
                               schema: HeapSchema = DEFAULT_SCHEMA,
                               predicate=None):
    """Build the distributed scan step over an ``(sp, dp)`` mesh of
    *devices* (default: every CUDA device, ENODEV without one).

    Returns ``(run, mesh)``.  ``run(pages, threshold)`` takes a page batch
    — a numpy array or tensor (leading axis divisible by dp), or the
    per-member shards a :class:`.stream.ShardedBatchStream` yields (over
    this mesh, or re-sharded from another's) — filters each member's dp
    shard, and folds: ``{"count": scalar, "sums": (n_cols,)}``, tensors on
    member 0's device (this rank's first member over ranks, the same
    values on every rank), the selected-row count and the per-column
    masked sums.

    *predicate*: a :class:`..ops.filter.FilterPred` (default ``col0 >
    threshold``, the reference's ``cols[0] > threshold``), or a callable
    ``predicate(cols, threshold)`` on CPU members only (EINVAL on CUDA
    members: B1 takes FilterPred terms).  Every lane evaluates it (it may
    read any column); lanes split only the aggregation.  ``run.step``
    returns each member's ``(count, sums)`` before the fold (None for
    another rank's member).  *devices* may be a :class:`.mesh.RingMesh`
    (its ranks kept)."""
    mesh = make_scan_mesh(devices, sp=sp)
    pred = STEP_PRED if predicate is None else predicate
    if mesh.device_type == "cuda" and not isinstance(pred, FilterPred):
        raise StromError(_errno.EINVAL, "a callable predicate runs on CPU "
                                        "members only; B1 on CUDA members "
                                        "takes FilterPred terms")
    n_cols = schema.n_cols
    per_lane = -(-n_cols // sp)
    dp = mesh.dp
    wide = wide_sums(schema)

    def _shards(pages) -> Sequence[torch.Tensor]:
        if isinstance(pages, Shards):
            if pages.mesh == mesh:
                return pages
            pages = torch.cat([p.to(mesh.home()) for p in pages.lane0()])
        elif isinstance(pages, (list, tuple)):
            pages = torch.cat([p.to(mesh.home()) for p in pages])
        return shard_pages(pages, mesh)

    def step(pages, threshold) -> list:
        th = np.int32(threshold)
        out = []
        for i, shard in enumerate(_shards(pages)):
            if shard is None:
                out.append(None)
                continue
            lane = i // dp
            # B1 launches on the current device's stream: a member on
            # another card makes its device current first
            with (torch.cuda.device(shard.device) if shard.is_cuda
                  else contextlib.nullcontext()):
                res = filter_pages_cuda(shard, th, schema, pred, wide=wide)
            lo = lane * per_lane
            # this lane's columns; the others' sums are zero here
            sums = [s if lo <= c < lo + per_lane else torch.zeros_like(s)
                    for c, s in enumerate(res["sums"])]
            out.append((res["count"], sums))
        return out

    def run(pages, threshold) -> dict:
        parts = step(pages, threshold)
        home = mesh.home()
        mine = [p for p in parts if p is not None]
        # count: identical on every lane, folded over lane 0's dp members
        # (this rank's of them; a rank without one adds a zero)
        count = sum((parts[d][0].to(home) for d in range(dp)
                     if parts[d] is not None),
                    torch.zeros_like(mine[0][0]).to(home))
        folded = [sum(_bits(p[1][c]).to(home) for p in mine)
                  for c in range(n_cols)]
        if mesh.multi_process:
            count = dist.all_reduce(count)
            folded = [dist.all_reduce(f) for f in folded]
        dt = _stack_dtype([p for p in mine[0][1]])
        if dt.is_floating_point:
            sums = torch.stack([f.to(torch.float32) for f in folded])
        elif dt in (torch.uint32, torch.uint64):
            sums = torch.stack(folded).view(dt)
        else:
            sums = torch.stack([f.to(dt) for f in folded])
        return {"count": count, "sums": sums}

    run.step = step
    return run, mesh
