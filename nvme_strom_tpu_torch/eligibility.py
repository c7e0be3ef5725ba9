"""Backing-device eligibility from sysfs: what a file's bytes live on.

The reference verified a raw NVMe or md-RAID-0 backing inside the kernel
(``__extblock_is_supported_nvme``, kmod/nvme_strom.c:229-272 + 274-341,
and ``__mdblock_is_supported_nvme``, :343-438, the DMA64 probe :330-336).
The same facts come from sysfs here: ``/sys/dev/block/<maj>:<min>``
resolves to the disk directory whose ``queue/``, ``md/`` and ``device/``
subtrees carry what the module read from kernel structs:

- an NVMe namespace: the name ``nvme<c>n<ns>`` (:229-250), a
  non-rotational queue, a bound controller (``device/``, the stand-in for
  the ``NVME_IOCTL_ID`` ping, :259-272);
- md-RAID-0: the name ``md[_d]N`` (:361-381), ``md/level == raid0``
  (:402-407), a nonzero ``raid_disks`` (:395-400), a page-aligned chunk
  (:409-415), and every member a supported NVMe disk (:417-429) with the
  same block size; the least request cap and the NUMA node they agree on
  (:282-341).

Every function takes an explicit ``sysfs_root``, so tests run the whole
classifier over fake trees with no hardware.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional, Tuple


__all__ = ["BackingInfo", "probe_backing", "probe_backing_dev"]

PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")   # the engine's (mmap.PAGESIZE)

_NVME_NAME = re.compile(r"^nvme\d+n\d+$")
_MD_NAME = re.compile(r"^md(?:_d)?\d+$")


def _read(path: str) -> Optional[str]:
    """A sysfs attribute's text, stripped; None when it cannot be read."""
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


@dataclass(frozen=True)
class BackingInfo:
    """What the bytes of a file physically live on.

    ``supported`` means "the direct-load fast path's performance model
    holds" (raw NVMe or md-RAID-0 of NVMe).  The engine itself can drive
    any O_DIRECT fd; callers gate on this only under strict eligibility
    (config ``require_nvme_backing``), mirroring how the reference's
    planner trusted CHECK_FILE (pgsql/nvme_strom.c:313-318)."""

    kind: str                    # "nvme" | "md-raid0" | "md" (failed RAID-0
                                 # validation) | "other" | "none"
    name: str                    # disk name ("nvme0n1", "md0", "vda", "")
    supported: bool
    reason: str                  # human-readable why-not (empty if supported)
    members: Tuple[str, ...] = ()        # RAID member disk names
    numa_node_id: int = -1               # -1 = unknown / mixed
    logical_block_size: int = 0          # 0 = unknown
    dma_max_size: int = 0                # from queue/max_hw_sectors_kb; 0 = unknown
    support_dma64: bool = False
    stripe_chunk_size: int = 0           # md chunk in bytes (0 = not striped)
    rotational: Optional[bool] = None


def _whole_disk(real_dir: str) -> str:
    """Partition directory -> parent disk (bdget + bd_contains analog)."""
    if os.path.exists(os.path.join(real_dir, "partition")):
        return os.path.dirname(real_dir)
    return real_dir


def _disk_dir_of(maj: int, minor: int, sysfs_root: str) -> Optional[str]:
    """Resolve a device number to its whole-disk sysfs directory."""
    node = os.path.join(sysfs_root, "dev", "block", f"{maj}:{minor}")
    real = os.path.realpath(node)
    if not os.path.isdir(real):
        return None
    return _whole_disk(real)


def _queue_geometry(disk_dir: str) -> Tuple[int, int]:
    """(logical_block_size, effective dma cap) from the queue directory.

    The cap is min(hardware ceiling, active soft limit): the reference
    read queue_max_hw_sectors (:297-314), but an admin-lowered
    max_sectors_kb is what the block layer will actually merge to."""
    lbs_text = _read(os.path.join(disk_dir, "queue", "logical_block_size"))
    lbs = int(lbs_text) if lbs_text and lbs_text.isdigit() else 0
    caps = []
    for attr in ("max_hw_sectors_kb", "max_sectors_kb"):
        text = _read(os.path.join(disk_dir, "queue", attr))
        if text and text.isdigit():
            caps.append(int(text) << 10)
    return lbs, (min(caps) if caps else 0)


def _device_numa_node(disk_dir: str) -> int:
    """NUMA node from the device chain (kmod/nvme_strom.c:316-328 analog:
    ``nvme_ns->queue->dev->numa_node``)."""
    for rel in ("device/numa_node", "device/device/numa_node"):
        text = _read(os.path.join(disk_dir, rel))
        if text is not None:
            try:
                return int(text)
            except ValueError:
                pass
    return -1


def _dma64_of(disk_dir: str, is_nvme: bool) -> bool:
    """64-bit DMA capability (kmod/nvme_strom.c:330-336 checked
    ``dev->dma_mask == DMA_BIT_MASK(64)``).  sysfs exposes
    ``dma_mask_bits`` for PCI devices; when the attribute is absent an
    NVMe device is 64-bit by spec (PRP entries are 64-bit addresses),
    anything else gets no benefit of the doubt."""
    for rel in ("device/dma_mask_bits", "device/device/dma_mask_bits"):
        text = _read(os.path.join(disk_dir, rel))
        if text is not None:
            try:
                return int(text) >= 64
            except ValueError:
                return False
    return is_nvme


def _check_nvme_disk(disk_dir: str) -> BackingInfo:
    """One raw NVMe namespace (reference __extblock_is_supported_nvme).

    Unsupported backings still carry their readable geometry/NUMA facts:
    the verdict is policy, the facts are facts."""
    name = os.path.basename(disk_dir)
    rot_text = _read(os.path.join(disk_dir, "queue", "rotational"))
    rot = None if rot_text is None else rot_text == "1"
    lbs, dma_max = _queue_geometry(disk_dir)
    numa = _device_numa_node(disk_dir)
    if not _NVME_NAME.match(name):
        return BackingInfo(
            kind="other", name=name, supported=False, rotational=rot,
            numa_node_id=numa, logical_block_size=lbs, dma_max_size=dma_max,
            support_dma64=_dma64_of(disk_dir, is_nvme=False),
            reason=f"block device '{name}' is not an NVMe namespace"
                   + (" (rotational disk)" if rot else ""))
    if rot:
        return BackingInfo(kind="other", name=name, supported=False,
                           rotational=True, numa_node_id=numa,
                           logical_block_size=lbs, dma_max_size=dma_max,
                           support_dma64=_dma64_of(disk_dir, is_nvme=False),
                           reason=f"'{name}' reports rotational media")
    # controller-bound check: the userspace stand-in for the
    # NVME_IOCTL_ID ping (kmod/nvme_strom.c:259-272) — a namespace with
    # no bound controller has no device/ link and cannot do I/O
    if not os.path.isdir(os.path.join(disk_dir, "device")):
        return BackingInfo(kind="nvme", name=name, supported=False,
                           rotational=False, numa_node_id=numa,
                           logical_block_size=lbs, dma_max_size=dma_max,
                           reason=f"'{name}' has no bound NVMe controller")
    return BackingInfo(kind="nvme", name=name, supported=True, reason="",
                       numa_node_id=numa,
                       logical_block_size=lbs or 512, dma_max_size=dma_max,
                       support_dma64=_dma64_of(disk_dir, is_nvme=True),
                       rotational=False)


def _check_md_raid0(disk_dir: str, sysfs_root: str) -> BackingInfo:
    """md-RAID-0 of all-NVMe members (reference __mdblock_is_supported_nvme)."""
    name = os.path.basename(disk_dir)
    md = os.path.join(disk_dir, "md")
    level = _read(os.path.join(md, "level"))
    if level != "raid0":
        return BackingInfo(kind="md", name=name, supported=False,
                           reason=f"md-device '{name}' is not RAID-0 "
                                  f"(level={level!r})")
    raid_disks = _read(os.path.join(md, "raid_disks"))
    if not raid_disks or not raid_disks.isdigit() or int(raid_disks) == 0:
        return BackingInfo(kind="md", name=name, supported=False,
                           reason=f"md-device '{name}' has no underlying disks")
    chunk_text = _read(os.path.join(md, "chunk_size"))
    chunk = int(chunk_text) if chunk_text and chunk_text.isdigit() else 0
    if chunk < PAGE_SIZE or chunk % PAGE_SIZE:
        return BackingInfo(kind="md", name=name, supported=False,
                           reason=f"md-device '{name}' has invalid stripe "
                                  f"chunk {chunk} (need page-aligned >= "
                                  f"{PAGE_SIZE})")
    members = []
    try:
        rd_entries = sorted(e for e in os.listdir(md)
                            if re.match(r"^rd\d+$", e))
    except OSError:
        rd_entries = []
    if not rd_entries:
        return BackingInfo(kind="md", name=name, supported=False,
                           reason=f"md-device '{name}' lists no rd* members")
    numa, blksz, dma_max, dma64 = -2, -1, 0, True
    for rd in rd_entries:
        mdir = _whole_disk(os.path.realpath(os.path.join(md, rd, "block")))
        m = _check_nvme_disk(mdir)
        if not m.supported:
            return BackingInfo(kind="md", name=name, supported=False,
                               members=tuple(members),
                               reason=f"md-device '{name}' member {rd}: "
                                      f"{m.reason}")
        members.append(m.name)
        # cross-member agreement, as the kernel accumulated through the
        # p_* out-params (kmod/nvme_strom.c:282-341)
        if blksz < 0:
            blksz = m.logical_block_size
        elif blksz != m.logical_block_size:
            return BackingInfo(kind="md", name=name, supported=False,
                               members=tuple(members),
                               reason=f"member block size mismatch: "
                                      f"{blksz} vs {m.logical_block_size}")
        if m.dma_max_size:  # min over members with a known cap
            dma_max = min(dma_max or m.dma_max_size, m.dma_max_size)
        dma64 = dma64 and m.support_dma64
        if numa == -2:
            numa = m.numa_node_id
        elif numa != m.numa_node_id:
            numa = -1  # spans NUMA nodes (reference sets -1, :322-326)
    return BackingInfo(kind="md-raid0", name=name, supported=True, reason="",
                       members=tuple(members),
                       numa_node_id=numa if numa >= 0 else -1,
                       logical_block_size=blksz, dma_max_size=dma_max,
                       support_dma64=dma64, stripe_chunk_size=chunk,
                       rotational=False)


def probe_backing_dev(maj: int, minor: int, *,
                      sysfs_root: str = "/sys") -> BackingInfo:
    """Classify a block device number (the CHECK_FILE backing probe)."""
    disk_dir = _disk_dir_of(maj, minor, sysfs_root)
    if disk_dir is None:
        return BackingInfo(kind="none", name="", supported=False,
                           reason=f"no block device behind {maj}:{minor} "
                                  "(tmpfs/overlay/anonymous mount?)")
    name = os.path.basename(disk_dir)
    if _MD_NAME.match(name) or os.path.isdir(os.path.join(disk_dir, "md")):
        return _check_md_raid0(disk_dir, sysfs_root)
    return _check_nvme_disk(disk_dir)


def probe_backing(path: str, *, sysfs_root: str = "/sys") -> BackingInfo:
    """Classify the device backing *path* (reference file_is_supported_nvme,
    kmod/nvme_strom.c:443-542, minus the fs checks done by check_file)."""
    try:
        st = os.stat(path)
    except OSError as e:
        return BackingInfo(kind="none", name="", supported=False,
                           reason=f"cannot stat {path}: {e}")
    return probe_backing_dev(os.major(st.st_dev), os.minor(st.st_dev),
                             sysfs_root=sysfs_root)
