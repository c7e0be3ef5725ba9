"""CUDA kernel for the ring permute (B4).

Replaces the Pallas TPU kernel ``nvme_strom_tpu/parallel/ring.py``
(``_pallas_permute_step``, ``pl.pallas_call`` at ``:108``) with
``csrc/permute.cu``, hand-written for sm_90a and bound with ``ctypes``.

A ring step launches, for each member *i*, the send kernel on the stream
of the device that holds member ``i - 1``: it copies that member's block
into member *i*'s destination through a raw pointer and then signals member
*i*'s counter once per CTA.  On one card, for a block of at least
``BULK_MIN_BYTES`` with source and destination equally aligned mod 16, the
copy is the TMA bulk kernel; :func:`plan_send` splits the block into an
unaligned head, ``STAGE_BYTES`` pieces dealt to at most two CTAs an SM,
and a tail.  Smaller blocks, sends across cards and pointers aligned
differently take the SIMT kernel (see ``csrc/permute.cu``).  Only when
every member's send is queued does the step queue, on each member's
stream, a one-thread wait until its counter reaches the signals sent to it
so far.  On one card all members launch onto one stream, and a wait queued
before its upstream send would hold the stream forever; sends first,
waits after, is what keeps the one-card ring from deadlocking.  Across
cards the waits are what orders the receiver after the sender.

Bound: bytes.  A rotation reads and writes each block once: 2 x bytes
over 3.35 TB/s on one H100 (256 MiB a member is 0.16 ms).

Counters grow for the life of a ring (epochs, never reset).  A wait that
is not satisfied within its budget (``WAIT_BUDGET_S``) sets its member's
error word and returns; the word stays set.  :func:`finish_ring` fences
the ring's devices (bounded) and reads the words once, raising
:class:`~..api.StromError` ETIMEDOUT: a single :func:`ring_permute_cuda`
call does that at its end, and a multi-step caller passes
``finish=False`` to each step and calls :func:`finish_ring` once after the
last, so the host syncs once per call and not once per step.  Nothing
falls back to the plain version: CPU tensors raise EINVAL here, and
:mod:`.permute` is the plain version.

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
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import _build
from ..api import StromError
from ..trace import recorder as _trace
from ..hbm.staging import bounded_fence
from .permute import check_blocks

__all__ = ["launches", "wait_launches", "launch", "ring_permute_cuda",
           "wait_signals", "finish_ring", "plan_send", "send_pieces",
           "SendPlan", "WAIT_BUDGET_S"]

#: send-kernel launches since the last reset (set to 0 to reset)
launches = 0
#: wait-kernel launches since the last reset (set to 0 to reset)
wait_launches = 0

#: seconds a member's wait may spin before the step raises ETIMEDOUT
WAIT_BUDGET_S = 5.0

#: the bulk kernel's piece: the size of one of its shared-memory stages
#: (``STAGE_BYTES`` in csrc/permute.cu)
STAGE_BYTES = 16 << 10
#: the least block the bulk kernel takes; the SIMT kernel is faster below
#: it (PERF.md)
BULK_MIN_BYTES = 16 << 20
_CTAS_PER_SM = 2
_SIMT_THREADS = 256

_send = _build.launcher("permute", "strom_ring_send", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_wait = _build.launcher("permute", "strom_ring_wait", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_ulonglong,
    ctypes.c_void_p, ctypes.c_void_p])
_enable_peer = _build.launcher("permute", "strom_enable_peer",
                               [ctypes.c_int, ctypes.c_int])


class SendPlan(NamedTuple):
    """How one send moves a block of ``head + body + tail`` bytes."""

    bulk: bool     # the TMA kernel (else the SIMT one)
    grid: int      # CTAs, and so the signals the send adds
    head: int      # bulk: bytes before the source's first 16-byte boundary
    body: int      # bulk: STAGE_BYTES pieces; SIMT: 16-byte vectors
    tail: int      # bytes after the body


def plan_send(src_ptr: int, dst_ptr: int, nbytes: int, *, peer: bool,
              sms: int) -> SendPlan:
    """Split a send of *nbytes* from *src_ptr* to *dst_ptr* for a card of
    *sms* multiprocessors, at most two CTAs an SM.  The bulk kernel takes a
    block of at least ``BULK_MIN_BYTES`` whose receiver is on the same card
    (not *peer*) and whose pointers are equally aligned mod 16: a head up
    to the first 16-byte boundary, a body of ``STAGE_BYTES`` pieces (the
    last shorter, a multiple of 16) dealt to the CTAs in turn, and a tail.
    Otherwise the SIMT kernel: 16-byte vectors over the body when both
    pointers are 16-byte aligned, bytes over the tail."""
    cap = sms * _CTAS_PER_SM
    if peer or (src_ptr - dst_ptr) % 16 or nbytes < BULK_MIN_BYTES:
        vec = src_ptr % 16 == 0 and dst_ptr % 16 == 0
        body = nbytes // 16 * 16 if vec else 0
        units = body // 16 + nbytes - body
        grid = max(1, min(-(-units // _SIMT_THREADS), cap))
        return SendPlan(False, grid, 0, body, nbytes - body)
    head = -src_ptr % 16
    body = (nbytes - head) // 16 * 16
    pieces = -(-body // STAGE_BYTES)
    return SendPlan(True, min(cap, pieces), head, body,
                    nbytes - head - body)


def send_pieces(plan: SendPlan) -> List[Tuple[int, int, int]]:
    """``(offset, size, cta)`` of every copy *plan* makes: the bulk
    kernel's head and tail (CTA 0's threads) and its pieces, piece *k* by
    CTA ``k % grid``; the SIMT kernel's vector body and byte tail (all its
    blocks, cta -1)."""
    if not plan.bulk:
        return [p for p in ((0, plan.body, -1), (plan.body, plan.tail, -1))
                if p[1]]
    pieces = [(0, plan.head, 0)] if plan.head else []
    stop = plan.head + plan.body
    for k, off in enumerate(range(plan.head, stop, STAGE_BYTES)):
        pieces.append((off, min(STAGE_BYTES, stop - off), k % plan.grid))
    if plan.tail:
        pieces.append((stop, plan.tail, 0))
    return pieces


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch(src: torch.Tensor, dst: torch.Tensor,
           recv_count: torch.Tensor) -> int:
    """Launch the send kernel on the current stream of *src*'s device:
    copy *src*'s bytes into *dst*, then add one to the int64 word
    *recv_count* (on *dst*'s device) per CTA, with system-scope ordering
    when that is another card.  Returns the number of CTAs (the signals
    sent); the one place ``launches`` moves."""
    global launches
    t0 = time.monotonic_ns() if _trace.active else 0
    dev = src.device.index
    peer = dst.device != src.device
    plan = plan_send(src.data_ptr(), dst.data_ptr(),
                     src.numel() * src.element_size(), peer=peer,
                     sms=_build.grid_cap(dev, 1))
    _send(dev, src.data_ptr(), dst.data_ptr(), int(plan.bulk), plan.head,
          plan.body, plan.tail, int(peer), recv_count.data_ptr(), plan.grid,
          _stream(src.device))
    launches += 1
    if t0:       # host time of the launch, not device time
        _trace.span("b4_permute", t0, time.monotonic_ns(),
                    args={"bytes": src.numel() * src.element_size()})
    return plan.grid


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
        that ran out of budget since the channel was made (the words are
        sticky; the channel is retired: a late signal must not land in a
        reused counter)."""
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
                      budget_s: float = WAIT_BUDGET_S,
                      finish: bool = True) -> List[torch.Tensor]:
    """One +1 rotation of per-member CUDA blocks (member *i*'s block is
    ``blocks[i]``, on member *i*'s device): returns ``res`` with
    ``res[(i + 1) % N]`` holding ``blocks[i]``'s bytes, in fresh tensors or
    in *out*.  With *finish* the step ends with :func:`finish_ring`
    (ETIMEDOUT when a wait ran out of budget); without, the caller calls
    it after its last step.  EINVAL for CPU tensors."""
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
    if finish:
        ch.finish()
    return dsts


def finish_ring(devices: Sequence[torch.device]) -> None:
    """Fence the ring of *devices* (bounded) and read its waits' error
    words once: ETIMEDOUT when any wait since the ring's channel was made
    ran out of budget.  A ring that never stepped has nothing to read."""
    ch = _channels.get(tuple(devices))
    if ch is not None:
        ch.finish()


def wait_signals(devices: Sequence[torch.device], member: int, count: int,
                 *, budget_s: float = WAIT_BUDGET_S,
                 finish: bool = True) -> None:
    """Hold *member*'s stream until *count* more signals than have been
    sent to it arrive, then (with *finish*) :func:`finish_ring`:
    ETIMEDOUT when they do not come within *budget_s*."""
    ch = _channel(tuple(devices))
    ch.wait(member, ch.sent[member] + count, budget_s)
    ch.sent[member] += count
    if finish:
        ch.finish()
