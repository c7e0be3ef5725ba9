"""The mesh of members the distributed paths run over.

The JAX package builds a ``jax.sharding.Mesh`` with axes ``(sp, dp)`` and
lets XLA place shards (`parallel/mesh.py`).  Here a member is a device plus
that member's own tensors, and a sharded array is a list of per-member
tensors, member *i*'s shard at position *i*.  Members may share a device:
N × ``cpu`` on the host, N × ``cuda:0`` on one card (the JAX package's N
virtual devices on one CPU, in PyTorch's idiom), or ``cuda:0…N-1`` on
several cards.

The members form an ``(sp, dp)`` grid, row-major with ``dp`` innermost, as
the reference's ``devices.reshape(sp, n // sp)``: member ``s * dp + d`` is
lane *s*'s member of dp column *d*.  ``sp == 1`` is the plain ring.  A
page batch or a leaf split over ``dp`` is replicated over the ``sp``
lanes (``P("dp", None)``): member ``(s, d)`` holds dp shard *d*.  Lanes
that sit on one device hold one tensor (:meth:`RingMesh.replicate`), never
one that a later step writes into.

A checkpoint leaf held over the mesh is a :class:`ShardedTensor`: its
per-member shards and a :class:`RingSharding`, the port's name for a
layout — a per-axis spec, each entry ``"dp"``, ``"sp"`` or None, as the
reference's ``PartitionSpec``.

Members may belong to several processes (:mod:`.dist`): ``owners[i]`` is
member *i*'s rank.  ``devices`` stays global, as ``jax.devices()`` is
under ``jax.distributed``, and a process holds tensors for its own
(*addressable*) members only: in a :class:`Shards` or a
:class:`ShardedTensor`, position *i* is member *i*'s shard, None where
another rank holds it.  With one process every member is addressable.
"""

from __future__ import annotations

import errno as _errno
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..api import StromError
from ..hbm.backend import default_device, resolve_device
from . import dist

__all__ = ["RingMesh", "make_scan_mesh", "pages_sharding", "RingSharding",
           "ShardedTensor", "Shards"]


class RingMesh:
    """Ordered members on an ``(sp, dp)`` grid: ``devices[s * dp + d]``
    holds member ``(s, d)``; lane *s*'s ring sends ``d`` to ``(d + 1) %
    dp``.  ``shape`` is ``{"sp": sp, "dp": N // sp}``, as the JAX mesh's;
    ``size`` counts every member.  ``owners[i]`` is member *i*'s rank
    (default: every member this process's)."""

    def __init__(self, devices: Sequence[torch.device], sp: int = 1,
                 owners: Optional[Sequence[int]] = None):
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        n = len(self.devices)
        if sp <= 0 or n % sp:
            raise StromError(_errno.EINVAL, f"sp={sp} must divide the "
                                            f"member count {n}")
        self.shape = {"sp": sp, "dp": n // sp}
        me = dist.process_index()
        self.owners: Tuple[int, ...] = tuple(
            [me] * n if owners is None else (int(o) for o in owners))
        if len(self.owners) != n:
            raise StromError(_errno.EINVAL, f"{len(self.owners)} owners for "
                                            f"{n} members")
        #: this process's members, in member order
        self.local: Tuple[int, ...] = tuple(
            i for i, o in enumerate(self.owners) if o == me)

    @property
    def multi_process(self) -> bool:
        """Members on more than one rank."""
        return len(set(self.owners)) > 1

    def is_local(self, i: int) -> bool:
        return self.owners[i] == dist.process_index()

    def local_columns(self) -> List[int]:
        """The dp columns with a member in this process: the dp shards of
        a batch this process reads."""
        return sorted({i % self.dp for i in self.local})

    def column_device(self, d: int) -> torch.device:
        """The device of this process's first member of dp column *d*."""
        for i in range(d, self.size, self.dp):
            if self.is_local(i):
                return self.devices[i]
        raise StromError(_errno.EINVAL, f"dp column {d} has no member in "
                                        f"rank {dist.process_index()}")

    def home(self) -> torch.device:
        """Where a folded result lives: this process's first member."""
        if not self.local:
            raise StromError(_errno.EINVAL, f"rank {dist.process_index()} "
                                            f"owns no member of {self!r}")
        return self.devices[self.local[0]]

    def regrid(self, sp: int) -> "RingMesh":
        """The same members, owners and order on an ``(sp, N / sp)``
        grid."""
        return self if sp == self.sp else \
            RingMesh(self.devices, sp, self.owners)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def sp(self) -> int:
        return self.shape["sp"]

    @property
    def dp(self) -> int:
        return self.shape["dp"]

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def lane(self, s: int = 0) -> "RingMesh":
        """Lane *s*'s dp ring: its ``dp`` members, a one-axis mesh."""
        dp = self.dp
        return RingMesh(self.devices[s * dp:(s + 1) * dp],
                        owners=self.owners[s * dp:(s + 1) * dp])

    def column(self, d: int) -> Tuple[torch.device, ...]:
        """The members of dp column *d*, one a lane."""
        return self.devices[d::self.dp]

    def replicate(self, shards: Sequence[Optional[torch.Tensor]]
                  ) -> "Shards":
        """dp shards -> one tensor a member, member ``(s, d)`` holding
        shard *d*: the same tensor where it already sits on the member's
        device, a copy where it does not; None for another rank's member
        (a shard no member of this process needs may be None)."""
        if len(shards) != self.dp:
            raise StromError(_errno.EINVAL, f"{len(shards)} shards for "
                                            f"dp={self.dp}")
        out: List[Optional[torch.Tensor]] = []
        for i in range(self.size):
            if not self.is_local(i):
                out.append(None)
                continue
            t, dev = shards[i % self.dp], self.devices[i]
            out.append(t if t.device == dev else t.to(dev))
        return Shards(out, self)

    def __eq__(self, other) -> bool:
        return isinstance(other, RingMesh) and \
            other.devices == self.devices and other.shape == self.shape \
            and other.owners == self.owners

    def __hash__(self) -> int:
        return hash((self.devices, self.sp, self.owners))

    def __repr__(self) -> str:
        grid = "" if self.sp == 1 else f", sp={self.sp}"
        own = "" if not self.multi_process else f", owners={list(self.owners)}"
        return f"RingMesh({[str(d) for d in self.devices]}{grid}{own})"


class Shards(list):
    """A batch's per-member tensors, in member order, with the mesh that
    laid them out (``mesh``): what :class:`.stream.ShardedBatchStream`
    yields, so a step built over another mesh can re-shard them.  Another
    rank's member holds None (the reference's ``addressable_shards`` are
    the others)."""

    def __init__(self, shards: Sequence[Optional[torch.Tensor]],
                 mesh: RingMesh):
        super().__init__(shards)
        self.mesh = mesh

    def lane0(self) -> List[torch.Tensor]:
        """The dp shards of lane 0: the batch, once (one process)."""
        if any(t is None for t in self[:self.mesh.dp]):
            raise StromError(_errno.EINVAL, "lane 0 is not all in this "
                                            "process: re-sharding needs "
                                            "the whole batch")
        return list(self[:self.mesh.dp])

    def addressable(self) -> List[Tuple[int, torch.Tensor]]:
        """``[(member, tensor)]`` of this process's members."""
        return [(i, t) for i, t in enumerate(self) if t is not None]


def make_scan_mesh(devices: Optional[Sequence] = None, *,
                   sp: int = 1) -> RingMesh:
    """An ``(sp, dp)`` mesh over *devices* (each a ``torch.device``, a
    string such as ``"cpu"`` or ``"cuda:0"``, or a CUDA ordinal), row-major
    with dp innermost; the default is every visible CUDA device, ENODEV
    when there is none.  ``sp`` must divide the member count (EINVAL).

    With a process group of several ranks up (:mod:`.dist`), *devices*
    are this rank's own members (default: the rank's card under ``nccl``,
    every visible card otherwise) and the mesh is every rank's, in rank
    order — a collective every rank calls.  A :class:`RingMesh` given as
    *devices* is kept, regridded to *sp*."""
    if isinstance(devices, RingMesh):
        return devices.regrid(sp)
    if devices is None and dist.local_device() is not None:
        devices = [dist.local_device()]
    if devices is None:
        default_device()
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise StromError(_errno.EINVAL, "a ring needs at least one member")
    if len({d.type for d in devs}) != 1 or devs[0].type not in ("cpu",
                                                                 "cuda"):
        raise StromError(_errno.EINVAL, f"ring members must all be cpu or "
                                        f"all cuda, got {devs}")
    if dist.process_count() == 1:
        return RingMesh(devs, sp)
    per_rank = dist.all_gather_object([str(d) for d in devs])
    if len({tuple(torch.device(d).type for d in r) for r in per_rank}) != 1:
        raise StromError(_errno.EINVAL, f"ranks disagree on the member "
                                        f"type: {per_rank}")
    glob = [torch.device(d) for r in per_rank for d in r]
    owners = [rank for rank, r in enumerate(per_rank) for _ in r]
    return RingMesh(glob, sp, owners)


def pages_sharding(mesh: RingMesh) -> "RingSharding":
    """A page batch's layout: split over dp, replicated over the sp lanes
    (the reference's ``P("dp", None)``)."""
    return RingSharding(mesh, spec=("dp", None))


_AXES = ("dp", "sp", None)


@dataclass(frozen=True, eq=False)
class RingSharding:
    """Layout of a leaf over *mesh*.  *spec* names, for each leading axis
    of the leaf, the mesh axis it is split over (``"dp"``, ``"sp"``) or
    None; axes past the spec are whole.  Member ``(s, d)`` holds part *d*
    of a ``"dp"`` axis and part *s* of an ``"sp"`` axis, and every axis
    must split evenly.  ``axis=0`` is the shorthand for ``spec=("dp",)``
    (the reference's ``P("dp")``), ``axis=None`` for ``spec=()`` (``P()``,
    every member holds the whole leaf), ``axis=k`` for ``k`` Nones and then
    ``"dp"``; afterwards ``axis`` reads the first split axis (None when
    nothing is split)."""

    mesh: RingMesh
    axis: Optional[int] = 0
    spec: Optional[Tuple] = None

    def __post_init__(self):
        spec = self.spec
        if spec is None:
            spec = () if self.axis is None else \
                (None,) * int(self.axis) + ("dp",)
        spec = tuple(spec)
        named = [e for e in spec if e is not None]
        if any(e not in _AXES for e in spec) or len(set(named)) != len(named):
            raise StromError(_errno.EINVAL, f"sharding spec {spec}: each "
                                            f"entry 'dp', 'sp' or None, each "
                                            f"mesh axis once")
        object.__setattr__(self, "spec", spec)
        split = [i for i, e in enumerate(spec) if e is not None]
        # axis: the first split axis, None when every member holds it whole
        object.__setattr__(self, "axis", split[0] if split else None)

    @property
    def leading_only(self) -> bool:
        """At most the leading axis is split (what a sharded save writes)."""
        return all(e is None for e in self.spec[1:])

    def check(self, what: str, shape=None) -> None:
        """EINVAL when *shape* (the whole leaf's) does not split evenly; a
        scalar is replicated whatever the spec."""
        if not shape:
            return
        shape = tuple(shape)
        if len(self.spec) > max(len(shape), 0) and any(
                e is not None for e in self.spec[len(shape):]):
            raise StromError(_errno.EINVAL,
                             f"{what}: spec {self.spec} splits more axes "
                             f"than the leaf's {len(shape)}")
        for ax, e in enumerate(self.spec[:len(shape)]):
            if e is not None and shape[ax] % self.mesh.shape[e]:
                raise StromError(_errno.EINVAL,
                                 f"{what}: {shape[ax]} rows do not split "
                                 f"evenly over {self.mesh.shape[e]} members "
                                 f"on axis {ax} ('{e}')")

    def indices(self, shape, what: str = "leaf") -> List[Tuple[slice, ...]]:
        """Each member's slice of a leaf of *shape*, one slice an axis (the
        reference's ``devices_indices_map``)."""
        self.check(what, shape)
        shape = tuple(shape)
        dp = self.mesh.dp
        spec = self.spec + (None,) * (len(shape) - len(self.spec))
        out = []
        for i in range(self.mesh.size):
            part = {"dp": i % dp, "sp": i // dp}
            idx = []
            for ax, e in enumerate(spec[:len(shape)]):
                if e is None:
                    idx.append(slice(0, shape[ax]))
                else:
                    q = shape[ax] // self.mesh.shape[e]
                    idx.append(slice(part[e] * q, (part[e] + 1) * q))
            out.append(tuple(idx))
        return out

    def shard_shape(self, shape) -> Tuple[int, ...]:
        shape = list(shape)
        for ax, e in enumerate(self.spec[:len(shape)]):
            if e is not None:
                shape[ax] //= self.mesh.shape[e]
        return tuple(shape)

    def row_ranges(self, n_rows: int, what: str):
        """``[(r0, r1)]`` of each member on the leading axis; EINVAL when
        *n_rows* does not split evenly."""
        return [(s[0].start, s[0].stop) if s else (0, n_rows)
                for s in self.indices((n_rows,), what)]


class ShardedTensor:
    """A leaf held over a mesh: ``shards[i]`` lives on member *i*'s device
    (None for another rank's member); ``shape`` and ``dtype`` are the
    whole leaf's."""

    def __init__(self, shards: Sequence[Optional[torch.Tensor]],
                 sharding: RingSharding):
        if len(shards) != sharding.mesh.size:
            raise StromError(_errno.EINVAL,
                             f"{len(shards)} shards for a ring of "
                             f"{sharding.mesh.size} members")
        self.shards = list(shards)
        self.sharding = sharding
        held = [t for t in self.shards if t is not None]
        if not held:
            raise StromError(_errno.EINVAL, "a sharded leaf needs one "
                                            "addressable shard")
        self.dtype = held[0].dtype
        shape = list(held[0].shape)
        for ax, e in enumerate(sharding.spec[:len(shape)]):
            if e is not None:
                shape[ax] *= sharding.mesh.shape[e]
        self.shape = tuple(shape)

    def addressable_shards(self) -> List[Tuple[int, Tuple[slice, ...],
                                               torch.Tensor]]:
        """``[(member, index, shard)]`` of this process's members, *index*
        the shard's slice of the whole leaf (the reference's
        ``addressable_shards``)."""
        idx = self.sharding.indices(self.shape)
        return [(i, idx[i], t) for i, t in enumerate(self.shards)
                if t is not None]

    def full(self) -> torch.Tensor:
        """The whole leaf on member 0's device (one process only)."""
        if any(t is None for t in self.shards):
            raise StromError(_errno.EINVAL, "the leaf is split over ranks: "
                                            "read addressable_shards()")
        dev = self.shards[0].device
        if all(e is None for e in self.sharding.spec):
            return self.shards[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for idx, s in zip(self.sharding.indices(self.shape), self.shards):
            out[idx].copy_(s)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, {self.sharding.mesh!r})")
