"""Ranks: the mesh's members spread over several processes.

The JAX package runs multi-host through ``jax.distributed`` (one process a
host, every device global, each process touching only its addressable
shards) and ``jax.experimental.multihost_utils``.  This module stands in
their place over ``torch.distributed``: a process group of ranks, each
owning some of the mesh's members (:class:`.mesh.RingMesh` ``owners``),
and the collectives the parallel layer needs across them — the psum
(:func:`all_reduce`), the gathers of splitter samples and counts
(:func:`all_gather`, :func:`gather_members`) and the bucket exchange
(:func:`all_to_all`).  Within a process the layer keeps its own copies
and B4; only what crosses a process boundary comes here.

The backend is chosen once, explicitly, and printed:

* ``nccl`` only where every rank has its own card
  (``torch.cuda.device_count() >= world``; NCCL refuses two ranks on one
  GPU), each rank on card ``rank``;
* ``gloo`` otherwise — CPU members, or several ranks sharing one card,
  whose CUDA tensors then cross through pinned host tensors.

Asking for ``nccl`` where it cannot run raises EINVAL; it never turns into
``gloo`` unasked.  With no group up (or a group of one) every call is the
identity, so single-process paths behave as they did.
"""

from __future__ import annotations

import datetime
import errno as _errno
from typing import Dict, List, Optional, Sequence

import torch

from ..api import StromError

__all__ = ["init_process_group", "shutdown", "is_initialized",
           "process_index", "process_count", "backend", "barrier",
           "all_reduce", "all_gather", "all_gather_object", "all_to_all",
           "gather_members", "local_device"]

_state: Dict[str, object] = {"backend": None, "rank": 0, "world": 1}


def _td():
    import torch.distributed as td
    return td


def init_process_group(rank: int, world_size: int, *,
                       init_method: str, backend: Optional[str] = None,
                       device_type: str = "cuda",
                       timeout_s: float = 120.0) -> str:
    """Join rank *rank* of *world_size* at *init_method* (``tcp://host:
    port``).  *backend* ``None`` chooses ``nccl`` when *device_type* is
    ``cuda`` and every rank can have its own card, else ``gloo``;
    ``"nccl"`` where that does not hold is EINVAL.  Prints the choice and
    returns it."""
    td = _td()
    if td.is_initialized():
        raise StromError(_errno.EBUSY, "a process group is already up")
    if not 0 <= rank < world_size:
        raise StromError(_errno.EINVAL, f"rank {rank} of {world_size}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    own_card = device_type == "cuda" and cards >= world_size
    if backend is None:
        backend = "nccl" if own_card else "gloo"
        why = (f"{cards} cards for {world_size} ranks" if own_card else
               f"{device_type} members" if device_type != "cuda" else
               f"{world_size} ranks share {cards} card(s)")
    elif backend == "nccl":
        if not own_card:
            raise StromError(_errno.EINVAL,
                             f"nccl needs a card a rank: {cards} card(s) "
                             f"for {world_size} ranks of {device_type} "
                             f"members")
        why = "asked"
    elif backend == "gloo":
        why = "asked"
    else:
        raise StromError(_errno.EINVAL, f"backend {backend!r}: nccl or gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    td.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=world_size,
                          timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(backend=backend, rank=rank, world=world_size)
    print(f"dist: rank {rank} of {world_size} over {backend} ({why})",
          flush=True)
    return backend


def shutdown() -> None:
    """Leave the group (idempotent)."""
    td = _td()
    if td.is_available() and td.is_initialized():
        td.destroy_process_group()
    _state.update(backend=None, rank=0, world=1)


def is_initialized() -> bool:
    return _state["backend"] is not None


def process_index() -> int:
    """This process's rank; 0 with no group up."""
    return int(_state["rank"])


def process_count() -> int:
    """The ranks in the group; 1 with no group up."""
    return int(_state["world"])


def backend() -> Optional[str]:
    return _state["backend"]


def local_device() -> Optional[torch.device]:
    """The card a ``nccl`` rank owns (collectives run on it); None under
    ``gloo`` or with no group."""
    if _state["backend"] == "nccl":
        return torch.device("cuda", process_index())
    return None


def _multi() -> bool:
    return process_count() > 1


def barrier(tag: str = "") -> None:
    """Every rank reaches this point before any leaves it (*tag* names
    the point in errors)."""
    if not _multi():
        return
    td = _td()
    try:
        if _state["backend"] == "nccl":
            td.barrier(device_ids=[process_index()])
        else:
            td.barrier()
    except Exception as e:
        raise StromError(_errno.EIO, f"barrier {tag!r} failed: {e}") from e


# -- staging: the wire form of a tensor -------------------------------------

_SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64,
           torch.bool: torch.uint8}


def _wire(t: torch.Tensor) -> torch.Tensor:
    """*t* as the backend carries it: on the rank's card under nccl, in
    (pinned, for a CUDA tensor) host memory under gloo; unsigned and bool
    words as their signed bits."""
    t = t.contiguous()
    if t.dtype in _SIGNED:
        t = t.view(_SIGNED[t.dtype])
    if _state["backend"] == "nccl":
        return t.to(local_device())
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t.clone()


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype in _SIGNED:
        w = w.view(like.dtype)
    return w.to(like.device)


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """*t* reduced over every rank (``sum``, ``max`` or ``min``), on
    *t*'s device; integer sums wrap as the words they are (uint32 through
    its int32 bits)."""
    if not _multi():
        return t
    td = _td()
    ops = {"sum": td.ReduceOp.SUM, "max": td.ReduceOp.MAX,
           "min": td.ReduceOp.MIN}
    if t.dtype in _SIGNED and op != "sum":
        raise StromError(_errno.EINVAL, f"{op} of {t.dtype}: sums only")
    w = _wire(t)
    td.all_reduce(w, op=ops[op])
    return _unwire(w, t)


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's *t* (one shape and dtype on every rank), in rank
    order, on *t*'s device."""
    if not _multi():
        return [t]
    td = _td()
    w = _wire(t)
    outs = [torch.empty_like(w) for _ in range(process_count())]
    td.all_gather(outs, w)
    return [_unwire(o, t) for o in outs]


def all_gather_object(obj) -> list:
    """Every rank's picklable *obj*, in rank order."""
    if not _multi():
        return [obj]
    out = [None] * process_count()
    _td().all_gather_object(out, obj)
    return out


def all_to_all(send: Sequence[torch.Tensor],
               recv_numel: Sequence[int]) -> List[torch.Tensor]:
    """Rank *r* sends ``send[q]`` (flat, one dtype) to rank *q* and gets
    ``recv_numel[q]`` elements back from each *q*; returns the received
    pieces in rank order, on ``send[0]``'s device."""
    like = send[0]
    if not _multi():
        return [send[0]]
    td = _td()
    # one all_to_all_single over the concatenated pieces: gloo implements
    # it (as alltoallv) where it has no list all_to_all
    flat = _wire(torch.cat([s.reshape(-1) for s in send]))
    out = torch.empty(sum(int(n) for n in recv_numel), dtype=flat.dtype,
                      device=flat.device)
    td.all_to_all_single(out, flat,
                         output_split_sizes=[int(n) for n in recv_numel],
                         input_split_sizes=[int(s.numel()) for s in send])
    return [_unwire(o, like) for o in
            torch.split(out, [int(n) for n in recv_numel])]


def gather_members(owners: Sequence[int],
                   local: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
    """Per-member tensors of one shape and dtype -> every member's, in
    member order, on the device of this rank's first one.  *local* holds
    this rank's members (``owners[i] == process_index()``); the gather
    runs over padded per-rank stacks."""
    me = process_index()
    mine = sorted(i for i, o in enumerate(owners) if o == me)
    if set(mine) != set(local):
        raise StromError(_errno.EINVAL, f"rank {me} holds members {mine}, "
                                        f"given {sorted(local)}")
    if not _multi():
        return [local[i] for i in range(len(owners))]
    first = local[mine[0]]
    home = first.device
    width = max(sum(1 for o in owners if o == r)
                for r in range(process_count()))
    stack = torch.zeros((width,) + tuple(first.shape), dtype=first.dtype,
                        device=home)
    for k, i in enumerate(mine):
        stack[k] = local[i].to(home)
    per_rank = all_gather(stack)
    out: List[Optional[torch.Tensor]] = [None] * len(owners)
    seen = [0] * process_count()
    for i, o in enumerate(owners):
        out[i] = per_rank[o][seen[o]]
        seen[o] += 1
    return out
