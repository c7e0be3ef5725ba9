"""All-to-all bucket exchange: repartition rows by key over the ring.

A port of the JAX package's ``parallel/exchange.py``, the third collective
pattern after the aggregate fold (:mod:`.dscan`) and the ring permute
(:mod:`.ring`): **all-to-all repartitioning**.  After a dp-sharded scan
rows live wherever their page landed; a distributed sort or join needs
every row whose key names member *b* on member *b*.

The exchange keeps the reference's fixed per-bucket capacity (the MoE
token-dispatch discipline): each sender fills a ``(dp, capacity, width)``
send slab, slot *b* holding its rows bound for member *b* in arrival
order, and rows past *capacity* are dropped and counted (``n_dropped``),
never silently.  The reference's ``jax.lax.all_to_all`` is XLA, not a
Pallas kernel; here it is tensor copies: sender *s*'s slab *b* lands in
receiver *b*'s receive slab at row block *s* (a peer copy when the two
sit on different cards).  Members of other ranks (:mod:`.dist`) get
their slabs, and send theirs, through one :func:`.dist.all_to_all` of
the packed slabs and counts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dist
from .mesh import make_scan_mesh

__all__ = ["make_bucket_exchange", "bucket_dispatch"]


def _dispatch_one(rows: torch.Tensor, bucket: torch.Tensor,
                  ok: torch.Tensor, dp: int, capacity: int,
                  fill_value: int) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """One sender: ``(slab (dp, capacity, width), sent (dp,), keep)``."""
    dev = rows.device
    # the one-hot bucket-major, (dp, N): the rank's cumulative sum then
    # runs along contiguous rows (a scan down the strided (N, dp) layout
    # took seconds on the card at 22M rows)
    onehot = (torch.arange(dp, device=dev)[:, None]
              == bucket.to(torch.int64)[None, :]) & ok[None, :]
    oh32 = onehot.to(torch.int32)
    # rank = number of earlier rows bound for the same member
    rank = torch.cumsum(oh32, 1, dtype=torch.int32) - oh32
    pos = (rank * oh32).sum(0)
    keep = ok & (pos < capacity)
    width = rows.shape[1]
    slab = torch.full((dp, capacity, width), fill_value, dtype=torch.int32,
                      device=dev)
    slab[bucket[keep].to(torch.int64), pos[keep].to(torch.int64)] = \
        rows[keep].to(torch.int32)
    sent = (oh32 * keep[None, :].to(torch.int32)).sum(1, dtype=torch.int32)
    return slab, sent, keep


def bucket_dispatch(rows: Sequence[Optional[torch.Tensor]],
                    bucket: Sequence[Optional[torch.Tensor]],
                    ok: Sequence[Optional[torch.Tensor]], dp: int,
                    capacity: int, *, fill_value: int = 0,
                    devices: Optional[Sequence[torch.device]] = None,
                    owners: Optional[Sequence[int]] = None):
    """Dispatch plus all-to-all over *dp* members (shared by the bucket
    exchange, :mod:`.sort` and :mod:`.pjoin`).

    Per sender *s*: ``rows[s] (N_s, width)`` int32, ``bucket[s] (N_s,)``
    owner member ids, ``ok[s] (N_s,)`` bool rows eligible to send.  A row
    ranks within its (sender, bucket) by the cumulative sum of the one-hot;
    rank ≥ *capacity* is dropped.  Returns per member:

    * ``recv[b] (dp * capacity, width)`` — member *b*'s bucket, one
      capacity-slab per sender in sender order, padded with *fill_value*,
      on member *b*'s device (``devices``, default the senders' own),
    * ``recv_counts[b] (dp,)`` int32 — valid rows per sender slab,
    * ``keep[s] (N_s,)`` bool — which of sender *s*'s rows were sent.

    *owners* (default: every member this process's) names each member's
    rank; a member of another rank is None on input and on output, and
    every rank must call with the same *capacity*.
    """
    if owners is not None and len(set(owners)) > 1:
        return _dispatch_ranks(rows, bucket, ok, dp, capacity, fill_value,
                               list(devices), list(owners))
    devices = list(devices) if devices is not None else \
        [r.device for r in rows]
    slabs, sents, keeps = [], [], []
    for r, b, o in zip(rows, bucket, ok):
        slab, sent, keep = _dispatch_one(r, b, o, dp, capacity, fill_value)
        slabs.append(slab)
        sents.append(sent)
        keeps.append(keep)
    width = rows[0].shape[1]
    recv, counts = [], []
    for b in range(dp):
        dev = devices[b]
        out = torch.empty((dp * capacity, width), dtype=torch.int32,
                          device=dev)
        for s in range(dp):
            out[s * capacity:(s + 1) * capacity].copy_(slabs[s][b],
                                                       non_blocking=True)
        recv.append(out)
        counts.append(torch.stack([sents[s][b].to(dev) for s in range(dp)]))
    return recv, counts, keeps


def _dispatch_ranks(rows, bucket, ok, dp, capacity, fill_value, devices,
                    owners):
    """:func:`bucket_dispatch` over ranks: this rank's senders dispatch,
    and rank *q* gets, packed flat, the slabs and counts of every (this
    rank's sender, *q*'s receiver) pair."""
    me = dist.process_index()
    world = dist.process_count()
    owned = [[i for i in range(dp) if owners[i] == q] for q in range(world)]
    mine = owned[me]
    slabs, sents, keeps = {}, {}, [None] * dp
    for s in mine:
        slabs[s], sents[s], keeps[s] = _dispatch_one(
            rows[s], bucket[s], ok[s], dp, capacity, fill_value)
    width = rows[mine[0]].shape[1]
    home = devices[mine[0]]
    send, want = [], []
    for q in range(world):
        pairs = [(s, b) for s in mine for b in owned[q]]
        send.append(torch.cat(
            [slabs[s][b].reshape(-1).to(home) for s, b in pairs]
            + [sents[s][b].reshape(1).to(home) for s, b in pairs])
            if pairs else torch.zeros(0, dtype=torch.int32, device=home))
        want.append(len(owned[q]) * len(mine) * (capacity * width + 1))
    got = dist.all_to_all(send, want)
    recv: List[Optional[torch.Tensor]] = [None] * dp
    counts: List[Optional[torch.Tensor]] = [None] * dp
    for b in mine:
        recv[b] = torch.empty((dp * capacity, width), dtype=torch.int32,
                              device=devices[b])
        counts[b] = torch.zeros(dp, dtype=torch.int32, device=devices[b])
    for q in range(world):
        senders = owned[q]
        n = len(senders) * len(mine)
        if not n:
            continue
        slab = got[q][:n * capacity * width].reshape(
            len(senders), len(mine), capacity, width)
        cnt = got[q][n * capacity * width:].reshape(len(senders), len(mine))
        for si, s in enumerate(senders):
            for bi, b in enumerate(mine):
                recv[b][s * capacity:(s + 1) * capacity].copy_(slab[si, bi])
                counts[b][s] = cnt[si, bi].to(devices[b])
    return recv, counts, keeps


def split_rows(arrays, dp: int, devices: Sequence[torch.device],
               pad_values, owners: Optional[Sequence[int]] = None
               ) -> List[List[Optional[torch.Tensor]]]:
    """Host arrays -> per-member tensors: each padded to a multiple of dp
    with its *pad_values* entry and split in dp contiguous ranges, range
    *d* on ``devices[d]`` (None where *owners* names another rank)."""
    me = dist.process_index()
    n = len(arrays[0])
    pad = (-n) % dp if n else dp
    out = []
    for a, fill in zip(arrays, pad_values):
        a = np.asarray(a)
        if pad:
            a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                           a.dtype)])
        t = torch.from_numpy(np.ascontiguousarray(a))
        r = len(a) // dp
        out.append([t[d * r:(d + 1) * r].to(devices[d])
                    if owners is None or owners[d] == me else None
                    for d in range(dp)])
    return out


def make_bucket_exchange(devices: Optional[Sequence] = None, *,
                         capacity: int, width: int, fill_value: int = 0):
    """Build the exchange over a one-axis ring of *devices* (default: every
    CUDA device).

    Returns ``(run, mesh)``.  ``run(rows, keys, valid=None)`` with host
    arrays ``rows (N, width)`` int32, ``keys (N,)`` int32 owner member in
    ``[0, dp)`` and ``valid (N,)`` bool splits them dp-contiguously (padded
    with invalid rows to a multiple of dp), and returns tensors on member
    0's device:

    * ``rows`` — ``(dp, dp * capacity, width)``: every row whose key names
      member *b*, at ``rows[b]``, padded with *fill_value*,
    * ``count`` — ``(dp,)`` rows each member received,
    * ``n_dropped`` — rows lost to the capacity bound or to a key outside
      ``[0, dp)`` (never wrapped into a bucket).

    Over ranks every rank passes the same host arrays; ``rows`` is then a
    list with this rank's members' buckets (None for the others'), and
    ``count`` and ``n_dropped`` are the whole mesh's on every rank.
    """
    mesh = make_scan_mesh(devices, sp=1)
    dp = mesh.dp
    devs = list(mesh.devices)
    owners = mesh.owners if mesh.multi_process else None

    def run(rows_np, keys_np, valid_np=None) -> dict:
        n = len(keys_np)
        if valid_np is None:
            valid_np = np.ones(n, bool)
        rows_s, keys_s, valid_s = split_rows(
            [np.asarray(rows_np, np.int32).reshape(n, width),
             np.asarray(keys_np, np.int32), np.asarray(valid_np, bool)],
            dp, devs, [0, 0, False], owners)
        # an out-of-range key is a drop: it never reaches the scatter
        ok = [None if k is None else v & (k >= 0) & (k < dp)
              for k, v in zip(keys_s, valid_s)]
        recv, counts, keep = bucket_dispatch(rows_s, keys_s, ok, dp,
                                             capacity, fill_value=fill_value,
                                             devices=devs, owners=owners)
        home = mesh.home()
        dropped = sum(int(v.sum()) - int(k.sum())
                      for v, k in zip(valid_s, keep) if k is not None)
        if owners is None:
            return {"rows": torch.stack([r.to(home) for r in recv]),
                    "count": torch.stack([c.sum().to(home)
                                          for c in counts]),
                    "n_dropped": torch.tensor(dropped, dtype=torch.int32)}
        count = torch.stack(dist.gather_members(
            owners, {b: counts[b].sum().to(home) for b in mesh.local}))
        dropped = dist.all_reduce(torch.tensor(dropped, dtype=torch.int64))
        return {"rows": recv, "count": count,
                "n_dropped": dropped.to(torch.int32)}

    return run, mesh
