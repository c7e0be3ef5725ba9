"""Shared helpers for the CLI tools (utils/utils_common.h analog)."""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import parse_size

__all__ = ["parse_size", "drop_page_cache", "first_mismatch",
           "memdump_on_corruption"]


def drop_page_cache(path: str) -> None:
    """fsync + fadvise(DONTNEED): without the fsync, dirty pages silently
    survive the fadvise and a benchmark measures the page cache."""
    try:
        fd = os.open(path, os.O_RDWR)
    except OSError:
        fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def first_mismatch(landed: torch.Tensor, path: str, nbytes: int, *,
                   piece: int = 64 << 20):
    """Compare the first *nbytes* bytes of *landed* (any device) with the
    file, *piece* bytes at a time.  Returns None when identical, else
    ``(file_offset, landed_piece, file_piece)`` of the first bad piece."""
    flat = landed.reshape(-1).view(torch.uint8)
    with open(path, "rb", buffering=0) as f:
        for off in range(0, nbytes, piece):
            n = min(piece, nbytes - off)
            want = np.frombuffer(f.read(n), dtype=np.uint8)
            got = flat[off:off + n].cpu().numpy()
            if got.shape != want.shape or not np.array_equal(got, want):
                return off, got, want
    return None


def memdump_on_corruption(got: np.ndarray, want: np.ndarray,
                          base: int) -> None:
    """Hexdump around the first corrupt byte (reference
    memdump_on_corruption, utils/ssd2gpu_test.c:169-225)."""
    n = min(len(got), len(want))
    bad = np.nonzero(got[:n] != want[:n])[0]
    first = int(bad[0]) if len(bad) else n
    print(f"corruption at file offset {base + first:#x} "
          f"({len(bad)} bad bytes in this piece)", file=sys.stderr)
    lo = max(first - 32, 0) & ~15
    for row in range(lo, min(first + 48, n), 16):
        g, w = got[row:row + 16].tobytes(), want[row:row + 16].tobytes()
        print(f"{'!' if g != w else ' '} {base + row:#010x}  dma: "
              f"{g.hex(' ')}", file=sys.stderr)
        if g != w:
            print(f"              vfs: {w.hex(' ')}", file=sys.stderr)
