"""The ring of members the distributed paths run over.

The JAX package builds a ``jax.sharding.Mesh`` with axes ``(sp, dp)`` and
lets XLA place shards (`parallel/mesh.py`).  Here a ring member is a device
plus that member's own tensors, and a sharded array is a list of per-member
tensors, member *i*'s shard at position *i*.  Members may share a device:
N × ``cpu`` on the host, N × ``cuda:0`` on one card (the JAX package's N
virtual devices on one CPU, in PyTorch's idiom), or ``cuda:0…N-1`` on
several cards.

Only the pure data-parallel ring (``sp == 1``) exists so far; the column
lanes come with the distributed scan.

A checkpoint leaf held over the ring is a :class:`ShardedTensor`: its
per-member shards and a :class:`RingSharding`, the port's name for a
layout (the leading axis split across members, or replicated).
"""

from __future__ import annotations

import errno as _errno
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..api import StromError
from ..hbm.backend import default_device, resolve_device

__all__ = ["RingMesh", "make_scan_mesh", "RingSharding", "ShardedTensor"]


class RingMesh:
    """Ordered ring members: ``devices[i]`` holds member *i*; member *i*
    sends to ``(i + 1) % N``.  ``shape`` is ``{"sp": 1, "dp": N}``, as
    the JAX mesh's."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.shape = {"sp": 1, "dp": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"RingMesh({[str(d) for d in self.devices]})"


def make_scan_mesh(devices: Optional[Sequence] = None, *,
                   sp: int = 1) -> RingMesh:
    """A ring over *devices* (each a ``torch.device``, a string such as
    ``"cpu"`` or ``"cuda:0"``, or a CUDA ordinal); the default is every
    visible CUDA device, ENODEV when there is none.  ``sp > 1`` is EINVAL:
    column lanes are not ported yet."""
    if sp != 1:
        raise StromError(_errno.EINVAL, f"sp={sp}: only the sp=1 ring is "
                                        f"ported")
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
    return RingMesh(devs)


@dataclass(frozen=True, eq=False)
class RingSharding:
    """Layout of a leaf over *mesh*: ``axis=0`` splits the leading axis
    (member *i* holds rows ``[i·n/N, (i+1)·n/N)``, the JAX package's
    ``P("dp")``), ``axis=None`` replicates the whole leaf on every member
    (``P()``).  Other axes need column lanes (``make_scan_mesh(sp>1)``),
    which are not ported: the data tier refuses them with EINVAL."""

    mesh: RingMesh
    axis: Optional[int] = 0

    def check(self, what: str) -> None:
        if self.axis not in (0, None):
            raise StromError(_errno.EINVAL,
                             f"{what}: axis {self.axis} — the ring shards "
                             f"the leading axis only (leading-axis or "
                             f"replicated); splitting another axis needs "
                             f"column lanes (make_scan_mesh(sp>1)), not "
                             f"ported")

    def row_ranges(self, n_rows: int, what: str):
        """``[(r0, r1)]`` of each member; EINVAL when *n_rows* does not
        split evenly."""
        self.check(what)
        n = self.mesh.size
        if self.axis is None:
            return [(0, n_rows)] * n
        if n_rows % n:
            raise StromError(_errno.EINVAL,
                             f"{what}: {n_rows} rows do not split evenly "
                             f"over {n} members on the leading axis")
        q = n_rows // n
        return [(i * q, (i + 1) * q) for i in range(n)]


class ShardedTensor:
    """A leaf held over a ring: ``shards[i]`` lives on member *i*'s device;
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
        ax = sharding.axis
        if ax is not None and shape and 0 <= ax < len(shape):
            shape[ax] = sum(int(s.shape[ax]) for s in self.shards)
        self.shape = tuple(shape)

    def full(self) -> torch.Tensor:
        """The whole leaf on member 0's device."""
        self.sharding.check("ShardedTensor.full")
        if self.sharding.axis is None:
            return self.shards[0]
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards])

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"axis={self.sharding.axis}, {self.sharding.mesh!r})")
