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
"""

from __future__ import annotations

import errno as _errno
from typing import Optional, Sequence, Tuple

import torch

from ..api import StromError
from ..hbm.backend import default_device, resolve_device

__all__ = ["RingMesh", "make_scan_mesh"]


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
