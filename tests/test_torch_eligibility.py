"""The port's backing-eligibility classifier and ``check_file(strict=,
sysfs_root=)`` against the JAX package's, on fake sysfs trees.

Every case of ``tests/test_eligibility.py`` is one parametrised case here:
it builds its tree once (with this file's own helpers), runs the port's
``probe_backing_dev`` or ``check_file`` and the JAX package's on it, holds
the two results equal field by field (``FileInfo``'s ``supported`` and
``strict_eligible`` too), and keeps the reference test's own assertions on
the port's result.  Then the same on this host's real ``/sys``, whose
verdict is a fact of the machine and only has to agree across packages.
"""

import dataclasses
import os

import pytest

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.eligibility import probe_backing as jprobe_backing
from nvme_strom_tpu.eligibility import probe_backing_dev as jprobe_dev
from nvme_strom_tpu.engine import check_file as jcheck_file
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.eligibility import probe_backing, \
    probe_backing_dev
from nvme_strom_tpu_torch.engine import check_file


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text + "\n")


def _disk(root, name, devno, *, rotational="0", lbs="512", max_hw_kb="2048",
          numa="1", dma_bits=None, controller=True):
    """One whole disk as sysfs shows it; returns its directory."""
    disk = os.path.join(root, "devices", "fake", name)
    _write(os.path.join(disk, "queue", "rotational"), rotational)
    _write(os.path.join(disk, "queue", "logical_block_size"), lbs)
    _write(os.path.join(disk, "queue", "max_hw_sectors_kb"), max_hw_kb)
    if controller:
        _write(os.path.join(disk, "device", "numa_node"), numa)
        if dma_bits is not None:
            _write(os.path.join(disk, "device", "dma_mask_bits"), dma_bits)
    os.makedirs(os.path.join(root, "dev", "block"), exist_ok=True)
    link = os.path.join(root, "dev", "block", devno)
    if not os.path.islink(link):
        os.symlink(disk, link)
    return disk


def _md(root, name, devno, members, *, level="raid0", chunk="65536"):
    """An md array over *members* (disk directories)."""
    disk = os.path.join(root, "devices", "fake", name)
    _write(os.path.join(disk, "md", "level"), level)
    _write(os.path.join(disk, "md", "raid_disks"), str(len(members)))
    _write(os.path.join(disk, "md", "chunk_size"), chunk)
    for i, mdir in enumerate(members):
        rd = os.path.join(disk, "md", f"rd{i}")
        os.makedirs(rd, exist_ok=True)
        os.symlink(mdir, os.path.join(rd, "block"))
    os.makedirs(os.path.join(root, "dev", "block"), exist_ok=True)
    os.symlink(disk, os.path.join(root, "dev", "block", devno))
    return disk


# -- probe_backing_dev: (tree maker -> device number, the reference
#    test's check on the result) -----------------------------------------

def _partition(root):
    disk = _disk(root, "nvme0n1", "259:0")
    part = os.path.join(disk, "nvme0n1p1")
    _write(os.path.join(part, "partition"), "1")
    os.symlink(part, os.path.join(root, "dev", "block", "259:1"))
    return 259, 1


def _two(root, numas=("0", "0"), kws=({}, {})):
    return [_disk(root, f"nvme{i}n1", f"259:{i}", numa=numas[i], **kws[i])
            for i in range(2)]


PROBES = {
    "nvme_disk_supported": (
        lambda r: (_disk(r, "nvme0n1", "259:0"), (259, 0))[1],
        lambda b: (b.supported and b.kind == "nvme" and b.name == "nvme0n1"
                   and b.numa_node_id == 1 and b.logical_block_size == 512
                   and b.dma_max_size == 2048 << 10 and b.support_dma64)),
    "rotational_rejected": (
        lambda r: (_disk(r, "nvme0n1", "259:0", rotational="1"),
                   (259, 0))[1],
        lambda b: not b.supported and "rotational" in b.reason),
    "non_nvme_name_rejected": (
        lambda r: (_disk(r, "vda", "254:0"), (254, 0))[1],
        lambda b: (not b.supported and b.kind == "other"
                   and "not an NVMe namespace" in b.reason)),
    "sata_style_name_rejected": (
        lambda r: (_disk(r, "sda", "8:0", rotational="1"), (8, 0))[1],
        lambda b: not b.supported and "rotational" in b.reason),
    "unbound_namespace_rejected": (
        lambda r: (_disk(r, "nvme0n1", "259:0", controller=False),
                   (259, 0))[1],
        lambda b: not b.supported and "controller" in b.reason),
    "partition_resolves_to_parent_disk": (
        _partition, lambda b: b.supported and b.name == "nvme0n1"),
    "dma_mask_bits_32_rejects_dma64": (
        lambda r: (_disk(r, "nvme0n1", "259:0", dma_bits="32"),
                   (259, 0))[1],
        lambda b: b.supported and not b.support_dma64),
    "no_sysfs_node_tmpfs": (
        lambda r: (0, 44),
        lambda b: (not b.supported and b.kind == "none"
                   and "no block device" in b.reason)),
    "md_raid0_all_nvme_supported": (
        lambda r: (_md(r, "md0", "9:0", _two(
            r, kws=({"max_hw_kb": "2048"}, {"max_hw_kb": "1024"}))),
            (9, 0))[1],
        lambda b: (b.supported and b.kind == "md-raid0"
                   and b.members == ("nvme0n1", "nvme1n1")
                   and b.stripe_chunk_size == 65536
                   and b.dma_max_size == 1024 << 10
                   and b.numa_node_id == 0)),
    "md_numa_mismatch_reports_minus_one": (
        lambda r: (_md(r, "md0", "9:0", _two(r, numas=("0", "1"))),
                   (9, 0))[1],
        lambda b: b.supported and b.numa_node_id == -1),
    "md_raid1_rejected": (
        lambda r: (_md(r, "md0", "9:0", [_disk(r, "nvme0n1", "259:0")],
                       level="raid1"), (9, 0))[1],
        lambda b: not b.supported and "not RAID-0" in b.reason),
    "md_bad_chunk_rejected": (
        lambda r: (_md(r, "md0", "9:0", [_disk(r, "nvme0n1", "259:0")],
                       chunk="2048"), (9, 0))[1],
        lambda b: not b.supported and "stripe" in b.reason),
    "md_non_nvme_member_rejected": (
        lambda r: (_md(r, "md0", "9:0", [_disk(r, "nvme0n1", "259:0"),
                                         _disk(r, "sdb", "8:16")]),
                   (9, 0))[1],
        lambda b: not b.supported and "rd1" in b.reason),
    "md_member_blocksize_mismatch_rejected": (
        lambda r: (_md(r, "md0", "9:0", _two(
            r, kws=({"lbs": "512"}, {"lbs": "4096"}))), (9, 0))[1],
        lambda b: not b.supported and "block size mismatch" in b.reason),
}


@pytest.mark.parametrize("case", sorted(PROBES))
def test_probe_backing_dev_matches_jax(tmp_path, case):
    build, check = PROBES[case]
    root = str(tmp_path / "sys")
    os.makedirs(root)
    maj, minor = build(root)
    mine = probe_backing_dev(maj, minor, sysfs_root=root)
    ref = jprobe_dev(maj, minor, sysfs_root=root)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert check(mine), mine


# -- check_file over a fake tree for the data file's own device -----------

def _devno(path):
    st = os.stat(path)
    return f"{os.major(st.st_dev)}:{os.minor(st.st_dev)}"


def _no_node(root, path):
    os.makedirs(os.path.join(root, "dev", "block"), exist_ok=True)


def _nvme_node(root, path):
    _disk(root, "nvme0n1", _devno(path), numa="0", max_hw_kb="512")


def _md_spanning_node(root, path):
    _md(root, "md0", _devno(path), _two(root, numas=("0", "1")))


CHECKS = {
    "strict_rejects_unverified_backing": (
        _no_node, True,
        lambda i: (not i.supported and not i.backing_supported
                   and "no block device" in i.backing_reason)),
    "nonstrict_reports_but_allows": (
        _no_node, False,
        lambda i: (i.supported and not i.backing_supported
                   and i.backing_reason and not i.support_dma64)),
    "preserves_md_spans_nodes_verdict": (
        _md_spanning_node, True,
        lambda i: (i.backing_kind == "md-raid0" and i.backing_supported
                   and i.numa_node_id == -1 and i.n_members == 2)),
    "nvme_backing_passes_strict": (
        _nvme_node, True,
        lambda i: (i.supported and i.backing_supported
                   and i.backing_kind == "nvme" and i.support_dma64
                   and i.dma_max_size <= 512 << 10
                   and i.numa_node_id == 0)),
}


def _same_info(mine, ref):
    a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
    a["fs_kind"], b["fs_kind"] = int(a["fs_kind"]), int(b["fs_kind"])
    assert a == b
    assert mine.supported == ref.supported
    assert mine.strict_eligible == ref.strict_eligible


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_check_file_matches_jax(tmp_path, case):
    build, strict, check = CHECKS[case]
    p = tmp_path / "data.bin"
    p.write_bytes(b"x" * 8192)
    root = str(tmp_path / "sys")
    build(root, str(p))
    mine = check_file(str(p), strict=strict, sysfs_root=root)
    _same_info(mine, jcheck_file(str(p), strict=strict, sysfs_root=root))
    assert check(mine), mine
    # the other policy over the same tree: the facts stay, only the
    # policy verdict may move
    other = check_file(str(p), strict=not strict, sysfs_root=root)
    _same_info(other, jcheck_file(str(p), strict=not strict,
                                  sysfs_root=root))
    assert dataclasses.replace(other, policy_rejected=False) == \
        dataclasses.replace(mine, policy_rejected=False)


@pytest.mark.parametrize("strict", [False, True])
def test_require_nvme_backing_is_the_default_policy(tmp_path, strict):
    """``strict=None`` reads config ``require_nvme_backing`` in both
    packages."""
    p = tmp_path / "data.bin"
    p.write_bytes(b"x" * 8192)
    root = str(tmp_path / "sys")
    _no_node(root, str(p))
    snap = config.snapshot()
    try:
        config.set("require_nvme_backing", strict)
        jconfig.set("require_nvme_backing", strict)
        mine = check_file(str(p), sysfs_root=root)
        _same_info(mine, jcheck_file(str(p), sysfs_root=root))
        assert mine.policy_rejected == strict
    finally:
        config.restore(snap)


def test_this_hosts_sysfs_matches_jax(tmp_path):
    """The real ``/sys`` behind a file of the test directory: whatever
    the verdict (a virtual disk, NVMe, none), both packages give it."""
    p = tmp_path / "data.bin"
    p.write_bytes(b"x" * 8192)
    assert dataclasses.asdict(probe_backing(str(p))) == \
        dataclasses.asdict(jprobe_backing(str(p)))
    for strict in (False, True):
        _same_info(check_file(str(p), strict=strict),
                   jcheck_file(str(p), strict=strict))
