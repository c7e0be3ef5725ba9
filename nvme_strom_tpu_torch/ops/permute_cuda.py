"""CUDA kernel for the ring permute (B4).

Replaces the Pallas TPU kernel ``nvme_strom_tpu/parallel/ring.py``
(``_pallas_permute_step``, ``pl.pallas_call`` at ``:108``) with
``csrc/permute.cu``, hand-written for sm_90a and bound with ``ctypes``.

A ring step launches, for each member *i*, the send kernel on the stream
of the device that holds member ``i - 1``: it copies that member's block
into member *i*'s destination through a raw pointer and then signals member
*i*'s counter once per thread block.  Only when every member's send is
queued does the step queue, on each member's stream, a one-thread wait
until its counter reaches the signals sent to it so far.  On one card all
members launch onto one stream, and a wait queued before its upstream
send would hold the stream forever; sends first, waits after, is what
keeps the one-card ring from deadlocking.  Across cards the waits are what
orders the receiver after the sender.

Bound: bytes.  A rotation reads and writes each block once: 2 x bytes
over 3.35 TB/s on one H100 (256 MiB a member is 0.16 ms).

Counters grow for the life of a ring (epochs, never reset).  A wait that
is not satisfied within its budget (``WAIT_BUDGET_S``) sets an error word
and returns; the step then raises :class:`~..api.StromError` ETIMEDOUT
after its bounded fence.  Nothing falls back to the plain version: CPU
tensors raise EINVAL here, and :mod:`.permute` is the plain version.

Buffer reuse and lifetime: destinations come from PyTorch's caching
allocator on the receiver's current stream.  When the sender sits on
another card, its stream first waits for an event recorded on the
receiver's stream (the buffer's previous use there is over: the TPU
kernel's send semaphore) and the destination records the sender's stream,
so the allocator does not hand it out again while the copy is in flight.
Peer access is enabled once per ordered pair; a pair without it is EINVAL.

``launches`` counts send kernels (one per member per step) and
``wait_launches`` the wait kernels; nothing else moves them.
"""

from __future__ import annotations

import ctypes
import errno as _errno
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import _build
from ..api import StromError
from ..hbm.staging import bounded_fence
from .permute import check_blocks

__all__ = ["launches", "wait_launches", "launch", "ring_permute_cuda",
           "wait_signals", "WAIT_BUDGET_S"]

#: send-kernel launches since the last reset (set to 0 to reset)
launches = 0
#: wait-kernel launches since the last reset (set to 0 to reset)
wait_launches = 0

#: seconds a member's wait may spin before the step raises ETIMEDOUT
WAIT_BUDGET_S = 5.0

_THREADS = 256
_BLOCKS_PER_SM = 8

_send = _build.launcher("permute", "strom_ring_send", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p])
_wait = _build.launcher("permute", "strom_ring_wait", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_ulonglong,
    ctypes.c_void_p, ctypes.c_void_p])
_enable_peer = _build.launcher("permute", "strom_enable_peer",
                               [ctypes.c_int, ctypes.c_int])


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch(src: torch.Tensor, dst: torch.Tensor,
           recv_count: torch.Tensor) -> int:
    """Launch the send kernel on the current stream of *src*'s device:
    copy *src*'s bytes into *dst*, then add one to the int64 word
    *recv_count* (on *dst*'s device) per thread block, with system-scope
    ordering when that is another card.  Returns the number of blocks
    (the signals sent); the one place ``launches`` moves."""
    global launches
    nbytes = src.numel() * src.element_size()
    vec = src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0
    units = nbytes // 16 if vec else nbytes
    dev = src.device.index
    grid = max(1, min(-(-units // _THREADS),
                      _build.grid_cap(dev, _BLOCKS_PER_SM)))
    _send(dev, src.data_ptr(), dst.data_ptr(), nbytes, int(vec),
          int(dst.device != src.device), recv_count.data_ptr(), grid,
          _stream(src.device))
    launches += 1
    return grid


class _Channel:
    """Signal counters of one ring: for each device a ``(N, 2)`` int64
    tensor whose row *i* is member *i*'s ``[signals received, error
    word]`` (only rows of members on that device are used), and on the
    host the signals sent to each member so far."""

    def __init__(self, devices: Tuple[torch.device, ...]):
        self.devices = devices
        n = len(devices)
        self.flags: Dict[torch.device, torch.Tensor] = {
            d: torch.zeros((n, 2), dtype=torch.int64, device=d)
            for d in dict.fromkeys(devices)}
        self.sent = [0] * n
        for i, d in enumerate(devices):
            up = devices[(i - 1) % n]
            if up != d:
                _peer(up, d)

    def count(self, i: int) -> torch.Tensor:
        return self.flags[self.devices[i]][i, 0:1]

    def wait(self, i: int, target: int, budget_s: float) -> None:
        global wait_launches
        dev = self.devices[i]
        row = self.flags[dev][i]
        _wait(dev.index, row[0:1].data_ptr(), target, int(budget_s * 1e9),
              row[1:2].data_ptr(), _stream(dev))
        wait_launches += 1

    def finish(self) -> None:
        """Bounded fence on every device, then raise ETIMEDOUT for a wait
        that ran out of budget (the channel is retired: a late signal must
        not land in a reused counter)."""
        for d in self.flags:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            bounded_fence(ev, "ring-permute")
        errs = {d: f[:, 1].tolist() for d, f in self.flags.items()}
        late = [i for i, d in enumerate(self.devices) if errs[d][i]]
        if late:
            _retired.append(_channels.pop(self.devices, self))
            raise StromError(_errno.ETIMEDOUT,
                             f"ring permute: member(s) {late} waited past "
                             f"their budget for the upstream member's copy")


_channels: Dict[Tuple[torch.device, ...], _Channel] = {}
#: channels retired after a timeout; their counters stay allocated, since
#: a late signal may still land in them
_retired: List[_Channel] = []
_peers: set = set()


def _peer(src: torch.device, dst: torch.device) -> None:
    """Enable kernels on *src* to write *dst*'s memory, once per pair."""
    key = (src.index, dst.index)
    if key in _peers:
        return
    lib = _build.load("permute")
    lib.strom_can_access_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.strom_can_access_peer.restype = ctypes.c_int
    if not lib.strom_can_access_peer(src.index, dst.index):
        raise StromError(_errno.EINVAL, f"{src} has no peer access to {dst}: "
                                        f"the ring cannot span them")
    _enable_peer(src.index, dst.index)
    _peers.add(key)


def _channel(devices: Tuple[torch.device, ...]) -> _Channel:
    ch = _channels.get(devices)
    if ch is None:
        ch = _channels[devices] = _Channel(devices)
    return ch


def ring_permute_cuda(blocks: Sequence[torch.Tensor], *,
                      out: Optional[Sequence[torch.Tensor]] = None,
                      budget_s: float = WAIT_BUDGET_S) -> List[torch.Tensor]:
    """One +1 rotation of per-member CUDA blocks (member *i*'s block is
    ``blocks[i]``, on member *i*'s device): returns ``res`` with
    ``res[(i + 1) % N]`` holding ``blocks[i]``'s bytes, in fresh tensors or
    in *out*.  The step ends with a bounded fence; ETIMEDOUT when a wait
    ran out of budget, EINVAL for CPU tensors."""
    devices = tuple(b.device for b in blocks)
    if not devices or any(d.type != "cuda" for d in devices):
        raise StromError(_errno.EINVAL, f"the CUDA ring permute takes CUDA "
                                        f"tensors, got {list(devices)}")
    check_blocks(blocks, devices, out)
    n = len(blocks)
    ch = _channel(devices)
    dsts = []
    for i in range(n):
        src, dev, up = blocks[(i - 1) % n], devices[i], devices[(i - 1) % n]
        dst = torch.empty_like(src, device=dev) if out is None else out[i]
        if up != dev:
            # the sender's stream starts after the destination's last use
            # on the receiver's stream, and the allocator keeps the
            # destination until the sender's copy is done
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            torch.cuda.current_stream(up).wait_event(ev)
            dst.record_stream(torch.cuda.current_stream(up))
        dsts.append(dst)
    # every send before any wait (see the module's docstring)
    for i in range(n):
        ch.sent[i] += launch(blocks[(i - 1) % n], dsts[i], ch.count(i))
    for i in range(n):
        ch.wait(i, ch.sent[i], budget_s)
    ch.finish()
    return dsts


def wait_signals(devices: Sequence[torch.device], member: int, count: int,
                 *, budget_s: float = WAIT_BUDGET_S) -> None:
    """Hold *member*'s stream until *count* more signals than have been
    sent to it arrive, with a bounded fence after: ETIMEDOUT when they do
    not come within *budget_s*."""
    ch = _channel(tuple(devices))
    ch.wait(member, ch.sent[member] + count, budget_s)
    ch.finish()
    ch.sent[member] += count
