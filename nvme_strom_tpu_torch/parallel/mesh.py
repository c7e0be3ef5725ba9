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
"""

from __future__ import annotations

import errno as _errno
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..api import StromError
from ..hbm.backend import default_device, resolve_device

__all__ = ["RingMesh", "make_scan_mesh", "pages_sharding", "RingSharding",
           "ShardedTensor", "Shards"]


class RingMesh:
    """Ordered members on an ``(sp, dp)`` grid: ``devices[s * dp + d]``
    holds member ``(s, d)``; lane *s*'s ring sends ``d`` to ``(d + 1) %
    dp``.  ``shape`` is ``{"sp": sp, "dp": N // sp}``, as the JAX mesh's;
    ``size`` counts every member."""

    def __init__(self, devices: Sequence[torch.device], sp: int = 1):
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        n = len(self.devices)
        if sp <= 0 or n % sp:
            raise StromError(_errno.EINVAL, f"sp={sp} must divide the "
                                            f"member count {n}")
        self.shape = {"sp": sp, "dp": n // sp}

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
        return RingMesh(self.devices[s * dp:(s + 1) * dp])

    def column(self, d: int) -> Tuple[torch.device, ...]:
        """The members of dp column *d*, one a lane."""
        return self.devices[d::self.dp]

    def replicate(self, shards: Sequence[torch.Tensor]) -> "Shards":
        """dp shards (lane 0's) -> one tensor a member, member ``(s, d)``
        holding shard *d*: the same tensor where the lane shares the
        device, a copy where it does not."""
        if len(shards) != self.dp:
            raise StromError(_errno.EINVAL, f"{len(shards)} shards for "
                                            f"dp={self.dp}")
        out = list(shards)
        for i in range(self.dp, self.size):
            t, dev = shards[i % self.dp], self.devices[i]
            out.append(t if t.device == dev else t.to(dev))
        return Shards(out, self)

    def __eq__(self, other) -> bool:
        return isinstance(other, RingMesh) and \
            other.devices == self.devices and other.shape == self.shape

    def __hash__(self) -> int:
        return hash((self.devices, self.sp))

    def __repr__(self) -> str:
        grid = "" if self.sp == 1 else f", sp={self.sp}"
        return f"RingMesh({[str(d) for d in self.devices]}{grid})"


class Shards(list):
    """A batch's per-member tensors, in member order, with the mesh that
    laid them out (``mesh``): what :class:`.stream.ShardedBatchStream`
    yields, so a step built over another mesh can re-shard them."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: RingMesh):
        super().__init__(shards)
        self.mesh = mesh

    def lane0(self) -> List[torch.Tensor]:
        """The dp shards of lane 0: the batch, once."""
        return list(self[:self.mesh.dp])


def make_scan_mesh(devices: Optional[Sequence] = None, *,
                   sp: int = 1) -> RingMesh:
    """An ``(sp, dp)`` mesh over *devices* (each a ``torch.device``, a
    string such as ``"cpu"`` or ``"cuda:0"``, or a CUDA ordinal), row-major
    with dp innermost; the default is every visible CUDA device, ENODEV
    when there is none.  ``sp`` must divide the member count (EINVAL)."""
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
    return RingMesh(devs, sp)


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
    """A leaf held over a mesh: ``shards[i]`` lives on member *i*'s device;
    ``shape`` and ``dtype`` are the whole leaf's."""

    def __init__(self, shards: Sequence[torch.Tensor],
                 sharding: RingSharding):
        if len(shards) != sharding.mesh.size:
            raise StromError(_errno.EINVAL,
                             f"{len(shards)} shards for a ring of "
                             f"{sharding.mesh.size} members")
        self.shards = list(shards)
        self.sharding = sharding
        self.dtype = self.shards[0].dtype
        shape = list(self.shards[0].shape)
        for ax, e in enumerate(sharding.spec[:len(shape)]):
            if e is not None:
                shape[ax] *= sharding.mesh.shape[e]
        self.shape = tuple(shape)

    def full(self) -> torch.Tensor:
        """The whole leaf on member 0's device."""
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
