"""Plain PyTorch version of the ring permute (B4).

One +1 rotation of a ring's per-member blocks: member *i*'s block lands on
member ``(i + 1) % N``, byte for byte, whatever its dtype (the oracle of
the JAX package is ``jax.lax.ppermute`` with ``perm = [(i, (i + 1) % N)]``).
Each block is copied into a fresh tensor on its destination member's
device, or into the caller's *out* tensors.  The CPU tests use it and
``chip_smoke.py`` holds the CUDA kernel (:mod:`.permute_cuda`) against it;
the main path does not run it on a card.
"""

from __future__ import annotations

import errno as _errno
from typing import List, Optional, Sequence

import torch

from ..api import StromError

__all__ = ["permute_step_plain", "check_blocks"]


def check_blocks(blocks: Sequence[torch.Tensor], devices,
                 out: Optional[Sequence[torch.Tensor]] = None) -> None:
    """EINVAL unless there is one contiguous block per member, on that
    member's device, all of one shape and dtype (and *out*, when given,
    matches them)."""
    if len(blocks) != len(devices) or not blocks:
        raise StromError(_errno.EINVAL, f"{len(blocks)} blocks for a ring of "
                                        f"{len(devices)} members")
    first = blocks[0]
    for i, (b, d) in enumerate(zip(blocks, devices)):
        if b.device != d:
            raise StromError(_errno.EINVAL, f"block {i} on {b.device}, its "
                                            f"member is on {d}")
        if b.shape != first.shape or b.dtype != first.dtype:
            raise StromError(_errno.EINVAL, f"block {i} is "
                                            f"{tuple(b.shape)} {b.dtype}, "
                                            f"block 0 {tuple(first.shape)} "
                                            f"{first.dtype}")
        if not b.is_contiguous():
            raise StromError(_errno.EINVAL, f"block {i} is not contiguous")
    if out is not None:
        check_blocks(out, devices)
        if out[0].shape != first.shape or out[0].dtype != first.dtype:
            raise StromError(_errno.EINVAL, "out must match the blocks' "
                                            "shape and dtype")


def permute_step_plain(blocks: Sequence[torch.Tensor],
                       out: Optional[Sequence[torch.Tensor]] = None
                       ) -> List[torch.Tensor]:
    """``result[(i + 1) % N] = blocks[i]``: each block ``copy_``'d into a
    fresh tensor on its destination member's device (or into ``out``)."""
    n = len(blocks)
    res = []
    for i in range(n):
        src = blocks[(i - 1) % n]
        if out is None:
            dst = torch.empty_like(src, device=blocks[i].device)
        else:
            dst = out[i]
        dst.copy_(src)
        res.append(dst)
    return res
