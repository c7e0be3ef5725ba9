"""Ring streaming: rotate per-member blocks around the ring (B4).

A reduced copy of the JAX package's ``parallel/ring.py``.  Each ring member
starts with its own block; at every step the block moves to the next
member, so after N − 1 steps every member has seen every block with one
block resident per member.  Three users:

* :func:`ring_permute_step` — one +1 rotation of a list of per-member
  tensors, the explicit form of the JAX function's shard_map body;
* :func:`ring_all_gather` — every member ends with every shard, the
  destination of each step a slice of the gathered output;
* :func:`make_ring_multi_query_scan` / :func:`ring_scan_source` — N
  different scan queries (one threshold per member) each fold the whole
  table: a member folds its threshold over the resident block with the
  page filter (B1), then the block rotates.

The transport (``config ici_permute``): ``cuda`` is the hand-written kernel
(:mod:`..ops.permute_cuda`), ``plain`` PyTorch copies
(:mod:`..ops.permute`); ``auto`` follows the members' device type and
never substitutes one route for the other.  A rotation whose result no
member reads (the last of a scan or gather) is not made.
"""

from __future__ import annotations

import errno as _errno
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..api import StromError
from ..config import config
from ..ops.filter import DEFAULT_SCHEMA, STEP_PRED, wide_sums
from ..ops.filter_cuda import filter_pages_cuda
from ..ops.permute import check_blocks, permute_step_plain
from ..ops.permute_cuda import finish_ring, ring_permute_cuda
from ..scan.heap import PAGE_SIZE, HeapSchema
from .mesh import RingMesh, make_scan_mesh

__all__ = ["make_ring_multi_query_scan", "ring_scan_source",
           "permute_backend", "ring_permute_step", "ring_finish",
           "ring_all_gather"]


def permute_backend(backend: Optional[str] = None, *,
                    device="cuda") -> str:
    """Resolve the ring-permute transport: explicit *backend* wins, else
    ``config ici_permute``; ``auto`` is ``cuda`` for members on a CUDA
    *device* and ``plain`` for members on the CPU."""
    b = backend or str(config.get("ici_permute"))
    if b == "auto":
        kind = torch.device(device).type
        if kind not in ("cuda", "cpu"):
            raise StromError(_errno.EINVAL, f"ring members on {kind}: the "
                                            f"permute runs on cuda or cpu")
        b = "cuda" if kind == "cuda" else "plain"
    if b not in ("cuda", "plain"):
        raise StromError(_errno.EINVAL, f"ici_permute backend {b!r} (want "
                                        f"cuda|plain|auto)")
    return b


def ring_permute_step(blocks: Sequence[torch.Tensor], *,
                      ring: Union[int, RingMesh],
                      backend: Optional[str] = None,
                      out: Optional[Sequence[torch.Tensor]] = None,
                      finish: bool = True) -> List[torch.Tensor]:
    """Rotate per-member *blocks* one step (+1): the result's entry
    ``(i + 1) % N`` holds ``blocks[i]``'s bytes, in fresh tensors on the
    receiving members' devices or in *out*.  *ring* is the ring size or
    the ring itself.  ``finish=False`` leaves the CUDA transport's
    timeout check to a :func:`ring_finish` after the caller's last step."""
    n = ring if isinstance(ring, int) else ring.size
    if len(blocks) != n:
        raise StromError(_errno.EINVAL, f"{len(blocks)} blocks for a ring "
                                        f"of {n}")
    if permute_backend(backend, device=blocks[0].device) == "cuda":
        return ring_permute_cuda(blocks, out=out, finish=finish)
    check_blocks(blocks, [b.device for b in blocks], out)
    return permute_step_plain(blocks, out)


def ring_finish(devices: Sequence, *,
                backend: Optional[str] = None) -> None:
    """End a run of ``finish=False`` steps over the ring of *devices*: on
    the CUDA transport one bounded fence and one read of the waits' error
    words (ETIMEDOUT when a wait ran out of budget); nothing on the plain
    one."""
    if permute_backend(backend, device=devices[0]) == "cuda":
        finish_ring([torch.device(d) for d in devices])


def ring_all_gather(shards: Sequence[torch.Tensor], mesh: RingMesh, *,
                    backend: Optional[str] = None) -> List[torch.Tensor]:
    """All-gather per-member *shards* (each ``(rows, ...)``) by ring
    rotation: returns one ``(N * rows, ...)`` replica per member, shard
    *k* at rows ``[k * rows, (k + 1) * rows)``.  N − 1 steps; each step
    writes straight into the gathered outputs.  On an ``(sp, dp)`` mesh
    each lane gathers its own dp ring (N = dp), as the reference's
    gather over ``"dp"``."""
    if mesh.sp > 1:
        dp = mesh.dp
        return [t for s in range(mesh.sp)
                for t in ring_all_gather(shards[s * dp:(s + 1) * dp],
                                         mesh.lane(s), backend=backend)]
    n = mesh.size
    check_blocks(shards, mesh.devices)
    rows = shards[0].shape[0]
    outs = [torch.empty((n * rows,) + tuple(shards[0].shape[1:]),
                        dtype=shards[0].dtype, device=d)
            for d in mesh.devices]

    def part(i: int, origin: int) -> torch.Tensor:
        o = origin % n
        return outs[i][o * rows:(o + 1) * rows]

    for i in range(n):
        part(i, i).copy_(shards[i])
    for s in range(1, n):
        # member i forwards the shard that reached it last step, which
        # originated at i - s + 1; it receives the one from i - s
        ring_permute_step([part(i, i - s + 1) for i in range(n)], ring=n,
                          backend=backend,
                          out=[part(i, i - s) for i in range(n)],
                          finish=False)
    ring_finish(mesh.devices, backend=backend)
    return outs


def _int_bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def make_ring_multi_query_scan(devices: Optional[Sequence] = None, *,
                               schema: HeapSchema = DEFAULT_SCHEMA,
                               predicate=None):
    """Build the ring scan over the ring of *devices* (default: every
    CUDA device).  Returns ``(run, mesh)``: ``run(pages, thresholds)``
    takes a page batch (rows divisible by the ring size) and one threshold
    per member, and returns ``{"count": (N,), "sums": (N, n_cols)}`` int32
    (CPU tensors) holding, for each query, the aggregate over the WHOLE
    batch.  ``run.step(shards, thresholds)`` does the same over
    per-member shards already on their devices and returns each member's
    ``(count, sums)`` on its device.

    *predicate*: a :class:`~..ops.filter.FilterPred` (default ``col0 >
    threshold``), or a callable on CPU members only.  Sums are int32,
    wrapping, as the JAX scan's carry; float columns are EINVAL."""
    mesh = make_scan_mesh(devices, sp=1)
    n = mesh.size
    pred = STEP_PRED if predicate is None else predicate
    if any(schema.col_dtype(c).kind == "f" for c in range(schema.n_cols)):
        raise StromError(_errno.EINVAL, "the ring scan folds int32 sums; the "
                                        "schema has a float column")
    wide = wide_sums(schema)

    def step(shards: Sequence[torch.Tensor], thresholds) -> list:
        ths = [np.int32(t) for t in np.asarray(thresholds, np.int32)]
        blocks = list(shards)
        acc: list = [None] * n
        for s in range(n):
            for i in range(n):
                out = filter_pages_cuda(blocks[i], ths[i], schema, pred,
                                        wide=wide)
                sums = torch.stack([_int_bits(x) for x in out["sums"]])
                acc[i] = (out["count"], sums) if acc[i] is None else \
                    (acc[i][0] + out["count"], acc[i][1] + sums)
            if s < n - 1:
                blocks = ring_permute_step(blocks, ring=n, finish=False)
        ring_finish(mesh.devices)
        return acc

    def run(pages, thresholds) -> dict:
        if len(thresholds) != n:
            raise ValueError(f"need {n} thresholds (one per ring member), "
                             f"got {len(thresholds)}")
        pages = torch.as_tensor(np.asarray(pages)) \
            if not isinstance(pages, torch.Tensor) else pages
        if pages.shape[0] % n:
            raise ValueError(f"{pages.shape[0]} pages do not divide over "
                             f"{n} ring members")
        r = pages.shape[0] // n
        shards = [pages[i * r:(i + 1) * r].to(d)
                  for i, d in enumerate(mesh.devices)]
        acc = step(shards, thresholds)
        return {"count": torch.stack([a[0].cpu() for a in acc]),
                "sums": torch.stack([a[1].cpu() for a in acc])}

    run.step = step
    return run, mesh


def ring_scan_source(source, thresholds, *, batch_pages: int,
                     devices: Optional[Sequence] = None,
                     schema: HeapSchema = DEFAULT_SCHEMA,
                     predicate=None, session=None) -> dict:
    """Stream *source* through the ring scan: each batch is direct-loaded
    member-sharded (:class:`.stream.ShardedBatchStream`), rotated so every
    query folds every page, and summed.  Pages that do not fill a batch are
    scanned as a final batch padded with zero pages (a page with no tuples
    adds nothing).  Returns numpy ``{"count": (N,), "sums": (N, n_cols)}``
    int32 over the whole source."""
    from .stream import ShardedBatchStream

    run, mesh = make_ring_multi_query_scan(devices, schema=schema,
                                           predicate=predicate)
    n = mesh.size
    if batch_pages % n:
        raise ValueError(f"batch_pages {batch_pages} must divide by the "
                         f"ring size {n}")
    if len(thresholds) != n:
        raise ValueError(f"need {n} thresholds (one per ring member), got "
                         f"{len(thresholds)}")
    acc: list = []

    def fold(shards) -> None:
        parts = run.step(shards, thresholds)
        if not acc:
            acc.extend(parts)
            return
        for i, (c, s) in enumerate(parts):
            acc[i] = (acc[i][0] + c, acc[i][1] + s)

    n_pages = source.size // PAGE_SIZE
    covered = 0
    with ShardedBatchStream(source, mesh, batch_pages=batch_pages,
                            session=session) as stream:
        for first, shards in stream:
            fold(shards)
            covered = first + batch_pages
    if covered < n_pages:
        tail = np.zeros((batch_pages, PAGE_SIZE), np.uint8)
        view = np.empty((n_pages - covered) * PAGE_SIZE, np.uint8)
        source.read_buffered(covered * PAGE_SIZE, memoryview(view))
        tail[:n_pages - covered] = view.reshape(-1, PAGE_SIZE)
        r = batch_pages // n
        fold([torch.from_numpy(tail[i * r:(i + 1) * r]).to(d)
              for i, d in enumerate(mesh.devices)])
    if not acc:
        return {}
    return {"count": np.array([int(c) for c, _ in acc], np.int32),
            "sums": np.stack([s.cpu().numpy() for _, s in acc])}
