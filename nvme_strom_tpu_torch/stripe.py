"""RAID-0 stripe remapping in userspace, and the member→host map.

A reduced copy of the JAX package's ``stripe.py``: the md-RAID-0 zone math
the reference re-implements in its kernel module (`kmod/nvme_strom.c:
823-910`: ``find_zone`` + ``strom_raid0_map_sector``) resolving a logical
byte range to per-member extents, and the round-robin member→host
ownership the multi-host sharded loader plans against.  When members
differ in size the address space is a sequence of zones, each striping
over the members that still have capacity at that depth.

With them, the member→lane map of the native engine's queue pairs
(``lane_of`` / ``lane_members``), and mirrored sets: under
``mirror='paired'`` member 2k+1 is a byte-identical replica of member 2k
(RAID-10), only the primaries are address space, and ``mirror_of`` names
a member's partner.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

__all__ = ["StripeZone", "StripeMap", "StripeExtent", "lane_of",
           "lane_members", "host_of", "host_members"]

SECTOR = 512


def lane_of(member: int, nlanes: int) -> int:
    """Engine queue pair (lane) serving *member*: ``member % nlanes``, the
    native engine's own map (``csrc/strom_engine.cc``), one lane a member
    when there are at least as many lanes as members (the per-NVMe-device
    hardware-queue analog, ``kmod/nvme_strom.c:1201-1223``)."""
    return member % max(nlanes, 1)


def lane_members(lane: int, n_members: int, nlanes: int) -> List[int]:
    """Members served by *lane* (the inverse of :func:`lane_of`); empty
    for a lane beyond the lane count."""
    nlanes = max(nlanes, 1)
    if lane < 0 or lane >= nlanes:
        return []
    return list(range(lane, n_members, nlanes))


def host_of(member: int, n_hosts: int) -> int:
    """Host whose local NVMe set holds stripe *member*: ``member %
    n_hosts``, so a 2H-member stripe over H hosts puts members {h, h+H}
    on host h and every host's local chunk grid is a regular sub-stripe."""
    return member % max(n_hosts, 1)


def host_members(host: int, n_members: int, n_hosts: int) -> List[int]:
    """Members locally resident on *host* (the inverse of
    :func:`host_of`); empty for a host index beyond the host count."""
    n_hosts = max(n_hosts, 1)
    if host < 0 or host >= n_hosts:
        return []
    return list(range(host, n_members, n_hosts))


@dataclass(frozen=True)
class StripeZone:
    zone_start: int      # first logical byte of this zone
    zone_len: int        # logical bytes covered by this zone
    dev_start: int       # byte offset into each member where this zone begins
    members: Tuple[int, ...]  # member indices participating in this zone


@dataclass(frozen=True)
class StripeExtent:
    """One physically-contiguous piece of a logical range."""

    member: int          # member index
    member_offset: int   # byte offset within the member
    length: int          # bytes
    logical_offset: int  # where this piece sits in the logical stream


class StripeMap:
    """Logical→member address resolution for an N-way RAID-0 stripe set."""

    def __init__(self, member_sizes: Sequence[int], chunk_size: int,
                 member_offsets: Sequence[int] | None = None,
                 mirror: str = "none"):
        if chunk_size <= 0 or chunk_size % SECTOR:
            raise ValueError(f"chunk_size {chunk_size} must be a positive "
                             f"multiple of {SECTOR}")
        if not member_sizes:
            raise ValueError("need at least one member")
        if mirror not in ("none", "paired"):
            raise ValueError(f"mirror must be 'none' or 'paired', got "
                             f"{mirror!r}")
        self.chunk_size = chunk_size
        self.n_members = len(member_sizes)
        self.mirror = mirror
        # partition start offsets (the reference adds these at
        # kmod/nvme_strom.c:904-906)
        self.member_offsets = tuple(member_offsets or [0] * self.n_members)
        # usable size per member = whole chunks only (md rounds down)
        usable = [size // chunk_size * chunk_size for size in member_sizes]
        if mirror == "paired":
            # member 2k+1 replicates member 2k: only the primaries are
            # address space, each pair as deep as its smaller member
            if self.n_members < 2 or self.n_members % 2:
                raise ValueError("mirror='paired' needs an even member "
                                 f"count >= 2, got {self.n_members}")
            for k in range(0, self.n_members, 2):
                pair = min(usable[k], usable[k + 1])
                usable[k], usable[k + 1] = pair, 0
        self.zones = self._build_zones(usable)
        self.total_size = sum(z.zone_len for z in self.zones)
        self._pow2 = (chunk_size & (chunk_size - 1)) == 0
        self._chunk_shift = chunk_size.bit_length() - 1 if self._pow2 else 0

    @staticmethod
    def _build_zones(usable: List[int]) -> List[StripeZone]:
        """md raid0 strip-zone construction: zone k stripes across every
        member whose usable size exceeds the depth already consumed."""
        zones: List[StripeZone] = []
        consumed = 0
        logical = 0
        while True:
            members = tuple(i for i, u in enumerate(usable) if u > consumed)
            if not members:
                break
            next_cut = min(usable[i] for i in members)
            height = next_cut - consumed
            zlen = height * len(members)
            zones.append(StripeZone(zone_start=logical, zone_len=zlen,
                                    dev_start=consumed, members=members))
            logical += zlen
            consumed = next_cut
        return zones

    def mirror_of(self, member: int):
        """The member holding a byte-identical replica of *member* at the
        same offsets (its pair partner under ``mirror='paired'``), or None
        when the set has no redundancy."""
        if self.mirror != "paired" or not 0 <= member < self.n_members:
            return None
        return member ^ 1

    def _find_zone(self, offset: int) -> StripeZone:
        for z in self.zones:
            if z.zone_start <= offset < z.zone_start + z.zone_len:
                return z
        raise ValueError(f"offset {offset} beyond stripe set size "
                         f"{self.total_size}")

    def map_offset(self, offset: int) -> Tuple[int, int, int]:
        """Resolve one logical byte offset to ``(member, member_offset,
        contig)``; ``contig`` is the distance to the next chunk boundary,
        where a request must split (kmod/nvme_strom.c:859-869)."""
        z = self._find_zone(offset)
        rel = offset - z.zone_start
        c = self.chunk_size
        if self._pow2:
            chunk_idx = rel >> self._chunk_shift
            in_chunk = rel & (c - 1)
        else:
            chunk_idx, in_chunk = divmod(rel, c)
        nb = len(z.members)
        member = z.members[chunk_idx % nb]
        row = chunk_idx // nb
        member_off = z.dev_start + row * c + in_chunk \
            + self.member_offsets[member]
        return member, member_off, c - in_chunk

    def map_range(self, offset: int, length: int) -> List[StripeExtent]:
        """Split a logical byte range into per-member contiguous extents,
        merging pieces physically adjacent on one member."""
        if offset < 0 or length < 0 or offset + length > self.total_size:
            raise ValueError(f"range [{offset}, {offset + length}) outside "
                             f"stripe set of size {self.total_size}")
        out: List[StripeExtent] = []
        pos = offset
        remaining = length
        while remaining > 0:
            member, moff, contig = self.map_offset(pos)
            take = min(contig, remaining)
            if out and out[-1].member == member and \
               out[-1].member_offset + out[-1].length == moff and \
               out[-1].logical_offset + out[-1].length == pos:
                prev = out.pop()
                out.append(StripeExtent(member, prev.member_offset,
                                        prev.length + take,
                                        prev.logical_offset))
            else:
                out.append(StripeExtent(member, moff, take, pos))
            pos += take
            remaining -= take
        return out
