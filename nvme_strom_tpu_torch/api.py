"""Command and result types of the SSD→GPU path.

The reference's ioctl ABI (`kmod/nvme_strom.h:17-171`) survives as plain
dataclasses: an error type carrying an errno, the CHECK_FILE verdict, the
INFO geometry of a registered buffer, and the out-fields of a memcpy
command.  Only the fields the load-then-scan path fills are kept.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["StromError", "FsKind", "FileInfo", "BufferInfo",
           "MemCopyResult"]


class StromError(OSError):
    """Engine error carrying an errno-style code (the reference returns
    ``-errno`` from every ioctl)."""

    def __init__(self, errno_: int, msg: str):
        super().__init__(errno_, msg)


class FsKind(enum.IntEnum):
    """Filesystem classification from :func:`..engine.check_file`."""

    UNSUPPORTED = 0
    EXT4 = 1
    XFS = 2
    OTHER_DIRECT = 3   # O_DIRECT probe succeeded on some other fs


@dataclass(frozen=True)
class FileInfo:
    """Result of CHECK_FILE (reference ``ioctl_check_file``,
    kmod/nvme_strom.c:188-583)."""

    path: str
    file_size: int
    fs_kind: FsKind
    logical_block_size: int
    dma_max_size: int

    @property
    def supported(self) -> bool:
        return self.fs_kind != FsKind.UNSUPPORTED


@dataclass(frozen=True)
class BufferInfo:
    """Geometry of one registered buffer (INFO_GPU_MEMORY analog)."""

    handle: int
    length: int
    page_size: int
    n_pages: int
    owner_uid: int
    refcount: int
    kind: str            # 'hbm' | 'pinned_host' | 'user'
    device: Optional[str] = None


@dataclass
class MemCopyResult:
    """Out-fields of MEMCPY_SSD2GPU/RAM (reference kmod/nvme_strom.h:85-117).

    ``chunk_ids[i]`` names the chunk resident at destination slot *i*.  The
    port reads every chunk by direct I/O, so ``nr_ram2dev`` stays 0 and the
    order is the caller's."""

    dma_task_id: int
    nr_chunks: int
    nr_ssd2dev: int
    nr_ram2dev: int
    chunk_ids: List[int]
    landing: str = ""    # "direct" | "staged" for pipeline commands

    def __post_init__(self) -> None:
        if self.nr_ssd2dev + self.nr_ram2dev != self.nr_chunks:
            raise ValueError(f"chunk conservation violated: "
                             f"{self.nr_ssd2dev}+{self.nr_ram2dev}"
                             f"!={self.nr_chunks}")
