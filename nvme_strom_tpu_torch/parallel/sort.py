"""Distributed sample sort: a full ORDER BY over the ring.

A port of the JAX package's ``parallel/sort.py``, step for step, so the
splitters, bucket counts, drops and padded rows are the reference's bit
for bit:

1. **splitter election**: each member sorts its keys (invalid rows ride
   as the worst key) and takes ``dp`` samples of its valid prefix at
   ``((k + 1) · nvalid) // (dp + 1)``; the ``dp²`` samples are gathered
   and sorted, and splitter *k* is sample ``(k + 1) · dp``;
2. **bucket exchange**: ``searchsorted(splitters, key, side="right")``
   names each element's owner, and the fixed-capacity exchange
   (:func:`.exchange.bucket_dispatch`) moves it there — drops are counted,
   never silent;
3. **local sort of the received bucket**, stable, with the pad slots
   after every real key: a pad sorts on the largest int64 key, above
   every value's, NaN's included.  (The reference sorts a pad on the worst
   value's key with a ``padflag`` second key, which places a NaN after
   the pads, so its count prefix reads a pad where the NaN was; for
   NaN-free input the two orders are the same.)

Member *b* then holds the *b*-th key range; its first ``count[b]`` values
in member order are the sorted sequence.  Descending order works in key
space through ``key_of``: ``-v`` for floats, ``~v`` for integers.

Every comparison runs on int64 keys: int32 as itself, uint32 as its
unsigned value (torch has no uint32 arithmetic), float32 through the
order-preserving map of its bits, with ±0 one key and every NaN one key
above +inf — the order ``jnp.sort`` and ``jnp.searchsorted`` give.
Values ride the int32 exchange slab as their bits, and an int32 payload
(row positions) rides beside them.

Over ranks (:mod:`.dist`) each process sorts its own members' slices: the
splitter samples meet in one gather (:func:`.dist.gather_members`, the
reference's all_gather), the buckets cross in the exchange's all-to-all,
and each rank keeps the buckets of its own members.
"""

from __future__ import annotations

import errno as _errno
from typing import Optional, Sequence

import numpy as np
import torch

from ..api import StromError
from ..scan.executor import _to_numpy
from . import dist
from .exchange import bucket_dispatch, split_rows
from .mesh import Shards, make_scan_mesh

__all__ = ["make_distributed_sort", "make_distributed_distinct",
           "distributed_sort_u64", "sort_keys", "prefixes", "capacity_loop"]

_U32 = 0xFFFFFFFF
#: a pad slot's sort key: above every value's key (at most 2^32)
_PAD_KEY = (1 << 63) - 1


def sort_keys(v: torch.Tensor, kind: str, descending: bool) -> torch.Tensor:
    """int64 keys whose order is *v*'s (``kind`` ``i``/``u``/``f``; a
    uint32 column arrives as int64 holding its value), reversed for
    *descending*."""
    if kind == "f":
        f = -v if descending else v
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")),
                        torch.where(f == 0, torch.zeros_like(f), f))
        bits = f.view(torch.int32).to(torch.int64)
        return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    k = v.to(torch.int64)
    if not descending:
        return k
    return _U32 - k if kind == "u" else ~k


def _to_bits(v: torch.Tensor, kind: str) -> torch.Tensor:
    """Values -> the int32 words the slab carries."""
    if kind == "f":
        return v.view(torch.int32)
    return v.to(torch.int32) if kind == "u" else v


def _from_bits(w: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "f":
        return w.view(torch.float32)
    return w.to(torch.int64) & _U32 if kind == "u" else w


def _values_tensor(a: np.ndarray, dt: np.dtype) -> np.ndarray:
    """Host values in the form the members compute on (uint32 as
    int64)."""
    return a.astype(np.int64) if dt == np.dtype(np.uint32) else a


def make_distributed_sort(devices: Optional[Sequence] = None, *,
                          capacity: int, dtype=np.int32,
                          descending: bool = False,
                          with_payload: bool = True):
    """Build the distributed sort over a one-axis ring of *devices*
    (default: every CUDA device).

    ``capacity`` bounds the elements a (sender, receiver) pair moves; a
    bucket absorbs up to ``dp * capacity``.  Returns ``(run, mesh)``.
    ``run(values, payload=None, valid=None)`` takes host arrays, splits
    them dp-contiguously (padded with invalid rows; an empty input still
    ships one invalid row a member) and returns tensors on member 0's
    device:

    * ``values`` — ``(dp, dp * capacity)``: member *b*'s row sorted
      (descending if asked), padded at the tail with the dtype's worst
      value (uint32 as ``torch.uint32``),
    * ``payload`` — int32, permuted with the values (-1 padding; absent
      with ``with_payload=False``, which leaves it off the slab),
    * ``count`` — ``(dp,)`` int32 valid elements a row,
    * ``n_dropped`` — elements lost to the capacity bound.

    The global order is row *b*'s first ``count[b]`` elements for ``b = 0
    .. dp - 1``.

    Over ranks every rank passes the same host arrays and reads only its
    members' slices; ``values`` and ``payload`` are then
    :class:`.mesh.Shards` of this rank's members' rows (None for the
    others'), while ``count`` and ``n_dropped`` are the whole mesh's on
    every rank (on this rank's first member)."""
    mesh = make_scan_mesh(devices, sp=1)
    dp = mesh.dp
    devs = list(mesh.devices)
    owners = mesh.owners if mesh.multi_process else None
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.int32), np.dtype(np.uint32),
                  np.dtype(np.float32)):
        raise StromError(_errno.EINVAL, f"sort supports int32/uint32/"
                                        f"float32 values, got {dt}")
    kind = dt.kind
    if kind == "f":
        worst = float("-inf") if descending else float("inf")
    else:
        info = np.iinfo(dt)
        worst = int(info.min if descending else info.max)

    def key_of(v):
        return sort_keys(v, kind, descending)

    def run(values_np, payload_np=None, valid_np=None) -> dict:
        values_np = np.asarray(values_np, dt)
        n = len(values_np)
        if payload_np is None:
            payload_np = np.arange(n, dtype=np.int32)
        if valid_np is None:
            valid_np = np.ones(n, bool)
        vals, pays, valid = split_rows(
            [_values_tensor(values_np, dt),
             np.asarray(payload_np, np.int32), np.asarray(valid_np, bool)],
            dp, devs, [0, -1, False], owners)
        home = mesh.home()

        # 1. splitter election, in key space
        samples = {}
        for i, (v, ok) in enumerate(zip(vals, valid)):
            if v is None:
                continue
            w = torch.where(ok, v, torch.full_like(v, worst))
            nvalid = int(ok.sum())
            sk = torch.sort(key_of(w), stable=True).values
            qpos = ((torch.arange(dp, device=v.device) + 1) * nvalid) \
                // (dp + 1)
            samples[i] = sk[qpos.clamp(0, v.shape[0] - 1)].to(home)
        allk = torch.sort(torch.cat(
            dist.gather_members(owners, samples) if owners is not None
            else [samples[i] for i in range(dp)]), stable=True).values
        splitters = allk[(torch.arange(dp - 1, device=home) + 1) * dp]

        # 2. owner per element, then the exchange
        rows, buckets = [], []
        for v, p in zip(vals, pays):
            if v is None:
                rows.append(None)
                buckets.append(None)
                continue
            buckets.append(torch.searchsorted(
                splitters.to(v.device), key_of(v).contiguous(),
                right=True).to(torch.int32))
            cols = [_to_bits(v, kind), p] if with_payload \
                else [_to_bits(v, kind)]
            rows.append(torch.stack(cols, -1))
        recv, counts, keep = bucket_dispatch(rows, buckets, valid, dp,
                                             capacity, devices=devs,
                                             owners=owners)
        dropped = sum(int(ok.sum()) - int(k.sum())
                      for ok, k in zip(valid, keep) if k is not None)

        # 3. the received bucket's local sort; pads after every real key
        out_v, out_p = [], []
        for b in range(dp):
            if recv[b] is None:
                out_v.append(None)
                out_p.append(None)
                continue
            dev = devs[b]
            slot = torch.arange(dp * capacity, device=dev)
            got = (slot % capacity) < counts[b][slot // capacity]
            rv = _from_bits(recv[b][:, 0], kind)
            rv = torch.where(got, rv, torch.full_like(rv, worst))
            pad = torch.full_like(rv, _PAD_KEY, dtype=torch.int64)
            key = torch.where(got, key_of(rv), pad)
            order = torch.sort(key, stable=True).indices
            sv = rv[order]
            if kind == "u":
                sv = sv.to(torch.int32).view(torch.uint32)
            out_v.append(sv if owners is not None else sv.to(home))
            if with_payload:
                rp = torch.where(got, recv[b][:, 1],
                                 torch.full_like(recv[b][:, 1], -1))
                out_p.append(rp[order] if owners is not None
                             else rp[order].to(home))
        if owners is not None:
            out = {"values": Shards(out_v, mesh),
                   "count": torch.stack(dist.gather_members(owners, {
                       b: counts[b].sum(dtype=torch.int32).to(home)
                       for b in mesh.local})),
                   "n_dropped": dist.all_reduce(torch.tensor(
                       dropped, dtype=torch.int64)).to(torch.int32)}
            if with_payload:
                out["payload"] = Shards(out_p, mesh)
            return out
        out = {"values": torch.stack(out_v),
               "count": torch.stack([c.sum(dtype=torch.int32).to(home)
                                     for c in counts]),
               "n_dropped": torch.tensor(dropped, dtype=torch.int32)}
        if with_payload:
            out["payload"] = torch.stack(out_p)
        return out

    return run, mesh


def capacity_loop(n_members: int, n: int, run_at) -> dict:
    """The ORDER BY family's capacity loop over *n_members* buckets and *n*
    elements: ``run_at(capacity)`` sorts at 2.5x slack over perfectly even
    buckets, rerun at twice the capacity while skewed keys overflow a
    bucket.  Returns the first result that dropped nothing."""
    capacity = max(64, -(-n * 5 // (2 * n_members * n_members)))
    while True:
        out = run_at(capacity)
        if int(out["n_dropped"]) == 0:
            return out
        capacity *= 2


def prefixes(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The global order of a sort's result: row *b*'s first ``counts[b]``
    elements for each *b*, concatenated on the rows' device (the padded
    slots never leave it)."""
    if rows.dtype == torch.uint32:
        return prefixes(rows.view(torch.int32), counts).view(torch.uint32)
    return torch.cat([rows[b][:int(n)] for b, n in enumerate(counts)])


def distributed_sort_u64(mesh, values: np.ndarray, payload: np.ndarray):
    """STABLE distributed sort of uint64 keys over every member of *mesh*
    (flattened): LSD radix riding the uint32 sample sort twice — the low
    words carrying the row index, then the high words in low-sorted order.
    Rank-preserving dispatch, sender-major slabs over contiguous ranges and
    stable local sorts make the permutation ``np.argsort(values,
    kind="stable")``'s, duplicates in physical order.

    Returns ``(sorted_values, payload_permuted)`` as host arrays.
    *payload* may be any dtype (permuted on the host; only the int32 row
    index rides the exchange, so ``len(values)`` must fit int32)."""
    values = np.ascontiguousarray(values, np.uint64)
    payload = np.asarray(payload)
    n = len(values)
    if n == 0:
        return values.copy(), payload.copy()
    if n > np.iinfo(np.int32).max:
        raise StromError(_errno.ERANGE, "distributed_sort_u64: row index "
                                        "exceeds int32")
    devices = list(mesh.devices)
    dp = len(devices)
    hi = (values >> np.uint64(32)).astype(np.uint32)
    lo = (values & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def one_pass(keys32: np.ndarray, pay: np.ndarray) -> np.ndarray:
        out = capacity_loop(dp, n, lambda cap: make_distributed_sort(
            devices, capacity=cap, dtype=np.uint32)[0](keys32, pay))
        return _to_numpy(prefixes(out["payload"], out["count"]))

    perm1 = one_pass(lo, np.arange(n, dtype=np.int32))
    perm = one_pass(hi[perm1], perm1)
    return values[perm], payload[perm]


def make_distributed_distinct(devices=None, *, capacity: int,
                              dtype=np.int32):
    """COUNT(DISTINCT col) over the ring: the distributed sort, then an
    adjacent-difference count on each member, summed.  Buckets split on
    the value, so every copy of a key lands on one member and no run spans
    two.  Each NaN counts on its own (IEEE ``!=``, as the local path).

    Returns ``(run, mesh)``; ``run(values, valid=None)`` gives
    ``{"distinct": int32 scalar, "n_dropped": scalar}``."""
    sort_run, mesh = make_distributed_sort(devices, capacity=capacity,
                                           dtype=dtype, with_payload=False)
    u32 = np.dtype(dtype) == np.dtype(np.uint32)

    def run(values_np, valid_np=None) -> dict:
        out = sort_run(values_np, valid_np=valid_np)
        total = 0
        for v, n in zip(out["values"], out["count"]):
            if v is None:       # another rank's member: its own count
                continue
            if u32:
                v = v.view(torch.int32)
            n = int(n)
            idx = torch.arange(v.shape[0], device=v.device)
            new_run = (idx < n) & ((idx == 0)
                                   | (v != torch.roll(v, 1)))
            total += int(new_run.sum())
        if mesh.multi_process:
            total = int(dist.all_reduce(torch.tensor(total)))
        return {"distinct": np.int32(total),
                "n_dropped": np.asarray(int(out["n_dropped"]), np.int32)}

    return run, mesh
