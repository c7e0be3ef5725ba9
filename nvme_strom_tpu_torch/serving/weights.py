"""Model cold start: a checkpoint streamed layer by layer onto the card.

The JAX package's ``serving/weights.py``.  Where
:func:`..data.checkpoint.restore_checkpoint` rebuilds a tree of leaves for
training, this streamer lands a model's weight bytes for inference, one
layer span at a time in file order, with the next ``depth - 1`` spans'
SSD reads in flight while the oldest one is verified and handed out:

1. the span (the layer's leaves, each 4096-aligned, padded to 4096) is
   read through the engine into host memory: a
   :class:`..hbm.registry.LandingBuffer` of its own on the CPU; on a CUDA
   device a slot of one pinned buffer (``cudaHostRegister`` once for the
   whole stream; the registry's landing is CPU-only), a span larger than
   a slot (64 MiB) landing in pieces;
2. at retire every leaf is crc32c-checked against the manifest on those
   host bytes (on by default; a leaf over several pieces is folded piece
   by piece), and a mismatch raises EBADMSG and unwinds every layer in
   flight and every layer handed out;
3. the layer becomes a uint8 tensor in :mod:`..hbm.registry`: on the CPU
   the landing buffer itself (``LandingBuffer.adopt_tensor`` and
   ``HbmBuffer.adopt``, no copy); on a card one ``copy_(non_blocking=
   True)`` a slot on a copy stream into the layer's own ``torch.empty``,
   the slot reused only once that copy's event completed.

Each layer handed out records a ``weight_stream`` span (submit to adopt;
on a card it ends when the copy is fenced, so a recorded layer is on the
card) whose ``layer`` arg shows the layers land in order; the stream's
rate is the ``coldstart_bytes_per_sec`` gauge.

:func:`stream_weights_sharded` splits the spans round-robin over host
threads, one Session and one source each, and ends in a digest handshake
through :func:`..parallel.ring.ring_all_gather` over a ring of the given
devices: on CUDA the ring permute kernel (B4).
"""

from __future__ import annotations

import errno as _errno
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..api import StromError
from ..config import config
from ..stats import stats
from ..trace import recorder as _trace

__all__ = ["StreamedModel", "stream_weights", "stream_weights_sharded"]

_ALIGN = 4096
#: layer index from a leaf key: "...layers.12...", "...layer_3...",
#: "['blocks'][7]", "transformer.h.12." etc.; keys without one belong to
#: the root group (embeddings, norms, heads) and stream in file order
#: around the layers
_LAYER_RE = re.compile(r"(?:^|[^a-z])(?:layers?|blocks?|h)[._\[\]'\"]*(\d+)",
                       re.IGNORECASE)

#: test hook of the sharded handshake: the host whose digest row is left
#: out, as if it adopted nothing (None in normal runs)
_digest_drop_host: Optional[int] = None


def _layer_of(key: str) -> Optional[int]:
    m = _LAYER_RE.search(key)
    return int(m.group(1)) if m else None


class _Layer:
    __slots__ = ("index", "label", "base", "nbytes", "leaves", "handle")

    def __init__(self, index: int, label, base: int) -> None:
        self.index = index          # stream order (file order)
        self.label = label          # parsed layer number or None (root)
        self.base = base            # absolute file offset of the span
        self.nbytes = 0             # span length (padded to _ALIGN)
        self.leaves: List[dict] = []
        self.handle = 0             # hbm registry handle once adopted


class StreamedModel:
    """Handles of a streamed weight checkpoint.

    ``handles`` maps stream index to an :mod:`..hbm.registry` handle, each
    holding one layer span as a uint8 tensor on the device.
    :meth:`leaf` is a typed view into its layer's tensor (no copy: leaves
    are 4096-aligned, so the view is legal for every dtype).
    :meth:`close` unmaps every handle."""

    def __init__(self, path: str, layers: List[_Layer]) -> None:
        self.path = path
        self._layers = layers
        self._by_key: Dict[str, tuple] = {}
        for ly in layers:
            for e in ly.leaves:
                self._by_key[e["key"]] = (ly, e)
        self.total_bytes = sum(ly.nbytes for ly in layers)

    @property
    def handles(self) -> Dict[int, int]:
        return {ly.index: ly.handle for ly in self._layers}

    def keys(self) -> List[str]:
        return list(self._by_key)

    def layer_array(self, index: int) -> torch.Tensor:
        """One layer span as its uint8 tensor on the device."""
        from ..hbm.registry import registry
        return registry.get(self._layers[index].handle).tensor

    def leaf(self, key: str) -> torch.Tensor:
        """Leaf *key* (the manifest's key string) as a typed view of its
        layer's tensor."""
        from ..data.dtypes import torch_dtype
        try:
            ly, e = self._by_key[key]
        except KeyError:
            raise StromError(_errno.ENOENT,
                             f"{self.path}: no leaf {key!r}") from None
        u8 = self.layer_array(ly.index)
        rel = e["abs"] - ly.base
        return u8[rel:rel + e["nbytes"]].view(
            torch_dtype(np.dtype(e["dtype"]))).reshape(tuple(e["shape"]))

    def close(self) -> None:
        _unmap_layers(self._layers)


def _unmap_layers(layers: Sequence[_Layer]) -> None:
    from ..hbm.registry import registry
    for ly in layers:
        if ly.handle:
            try:
                registry.unmap(ly.handle, timeout=5.0)
            except StromError:
                pass
            ly.handle = 0


def _plan_layers(meta: dict) -> List[_Layer]:
    """Group manifest leaves into contiguous streamed spans: consecutive
    leaves (file order) sharing a parsed layer label form one span, so
    every span is one contiguous read whatever the naming."""
    data0 = meta["data_offset"]
    layers: List[_Layer] = []
    cur: Optional[_Layer] = None
    for e in meta["leaves"]:
        label = _layer_of(e["key"])
        abs_off = data0 + e["offset"]
        if cur is None or label != cur.label:
            cur = _Layer(len(layers), label, abs_off)
            layers.append(cur)
        cur.leaves.append({"key": e["key"], "dtype": e["dtype"],
                           "shape": e["shape"], "abs": abs_off,
                           "nbytes": int(e["nbytes"]),
                           "crc32c": e.get("crc32c")})
        end = abs_off + int(e["nbytes"])
        cur.nbytes = (end - cur.base + _ALIGN - 1) // _ALIGN * _ALIGN
    return layers


#: a span up to this size is one command on the finest grid (the JAX
#: package's plan); a larger one is cut on the coarser grids too
_ONE_COMMAND = 1 << 20
#: a card's pinned slots hold a span or a piece of one this large: the
#: pinned memory of a stream is ``depth`` of them, whatever the layers
_PIECE = 64 << 20


def _grids(chunk_size: int) -> tuple:
    """The chunk grids a span is read on: *chunk_size*, then the coarser
    grids of :mod:`..data.checkpoint` (the same bytes in fewer chunks to
    plan)."""
    if chunk_size <= 0 or chunk_size & (chunk_size - 1) \
            or _ALIGN % chunk_size:
        raise StromError(_errno.EINVAL, f"chunk_size {chunk_size} must be a "
                                        f"power of two dividing {_ALIGN}")
    return (chunk_size,) + tuple(g for g in (_ALIGN, 64 << 10, 1 << 20)
                                 if g > chunk_size)


def _span_grids(grids: tuple, nbytes: int) -> tuple:
    return grids[:1] if nbytes <= _ONE_COMMAND else grids


class _LayerState:
    """One layer in flight: its pieces still to retire, each leaf's
    running crc32c, and where its bytes land."""

    __slots__ = ("ly", "left", "crcs", "ts", "landing", "tensor")

    def __init__(self, ly: _Layer, n_pieces: int) -> None:
        self.ly = ly
        self.left = n_pieces
        self.crcs = [0] * len(ly.leaves)
        self.ts = 0
        self.landing = None     # the CPU's LandingBuffer
        self.tensor = None      # a card's layer tensor


def _pieces(layers: Sequence[_Layer], piece: int) -> List[tuple]:
    """``(layer state, offset in the span, length)`` of every piece, in
    file order: a span is cut into pieces of at most *piece* bytes."""
    out = []
    for ly in layers:
        offs = range(0, ly.nbytes, piece)
        st = _LayerState(ly, len(offs))
        out.extend((st, off, min(piece, ly.nbytes - off)) for off in offs)
    return out


def _verify_piece(path: str, st: _LayerState, off: int, view) -> None:
    """Fold the piece's bytes (*view*, at span offset *off*) into the
    running crc32c of each leaf they overlap, and check every leaf that
    ends in the piece against the manifest: EBADMSG on a mismatch."""
    from ..scan.heap import crc32c_update
    ly = st.ly
    end = off + len(view)
    for k, e in enumerate(ly.leaves):
        if e["crc32c"] is None:
            continue
        a = e["abs"] - ly.base
        b = a + e["nbytes"]
        lo, hi = max(a, off), min(b, end)
        if lo >= hi:
            continue
        st.crcs[k] = crc32c_update(st.crcs[k], view[lo - off:hi - off])
        if hi == b and st.crcs[k] != e["crc32c"]:
            raise StromError(
                _errno.EBADMSG,
                f"{path}: leaf {e['key']} crc32c mismatch "
                f"(manifest {e['crc32c']:#010x}, landed {st.crcs[k]:#010x})")


class _Dest:
    """Where one piece's reads land: a mapped buffer (its handle and
    whole view) and the piece's place in it."""

    __slots__ = ("handle", "offset", "whole", "view")

    def __init__(self, handle: int, offset: int, whole: memoryview,
                 nbytes: int) -> None:
        self.handle = handle
        self.offset = offset
        self.whole = whole
        self.view = whole[offset:offset + nbytes]


def _record(ly: _Layer, ts: int, host: Optional[int]) -> None:
    if _trace.active:
        args = {"layer": ly.index, "label": ly.label,
                "leaves": len(ly.leaves)}
        if host is not None:
            args["host"] = host
        _trace.span("weight_stream", ts, time.monotonic_ns(),
                    offset=ly.base, length=ly.nbytes, args=args)


class _Landings:
    """The CPU's landing: a LandingBuffer a layer, read in place and
    adopted as the layer's tensor (no copy)."""

    piece = 1 << 62             # a span is never cut

    def __init__(self, sess, host: Optional[int]) -> None:
        self.sess = sess
        self.host = host
        self.open: List[_LayerState] = []

    def take(self, st: _LayerState, off: int, n: int) -> _Dest:
        from ..hbm.registry import LandingBuffer
        if st.landing is None:
            st.landing = LandingBuffer(self.sess, st.ly.nbytes)
            self.open.append(st)
        return _Dest(st.landing.handle, off, st.landing.view(), n)

    def give_back(self, dest: _Dest) -> None:
        pass                    # abort() releases the layer's buffer

    def land(self, st: _LayerState, off: int, dest: _Dest) -> None:
        if st.left:
            return
        from ..hbm.registry import registry
        t = st.landing.adopt_tensor(torch.uint8)
        handle = registry.map_device_memory(t)
        registry.get(handle).adopt(t, st.landing)
        self.open.remove(st)
        st.ly.handle = handle
        _record(st.ly, st.ts, self.host)

    def finish(self) -> None:
        pass

    def abort(self) -> None:
        for st in self.open:
            st.landing.release()
        self.open = []

    def close(self) -> None:
        pass


class _PinnedSlots:
    """A card's landing: *n* pinned slots of at most ``_PIECE`` bytes in
    one buffer, registered with CUDA once for the stream.  A retired
    piece is copied on a copy stream into its layer's own tensor; a slot
    is reused once its copy's event completed, and a layer is registered
    (and recorded) once its last copy is fenced."""

    def __init__(self, sess, layers: Sequence[_Layer], n: int,
                 dev: torch.device, host: Optional[int]) -> None:
        self.sess = sess
        self.dev = dev
        self.host = host
        self.piece = min(_PIECE, max(ly.nbytes for ly in layers))
        n = max(1, min(n, len(_pieces(layers, self.piece))))
        self.handle, self.buf = sess.alloc_dma_buffer(n * self.piece)
        self.free = deque(range(n))
        self.copying: deque = deque()   # (slot, event, state or None)
        try:
            self.buf.pin_cuda()
            self.stream = torch.cuda.Stream(device=dev)
        except BaseException:
            self.close()
            raise

    def take(self, st: _LayerState, off: int, n: int) -> _Dest:
        if not self.free:
            self._fence_one()
        slot = self.free.popleft()
        return _Dest(self.handle, slot * self.piece, self.buf.view(), n)

    def give_back(self, dest: _Dest) -> None:
        self.free.append(dest.offset // self.piece)

    def land(self, st: _LayerState, off: int, dest: _Dest) -> None:
        n = len(dest.view)
        src = torch.frombuffer(dest.view, dtype=torch.uint8, count=n)
        with torch.cuda.stream(self.stream):
            if st.tensor is None:
                st.tensor = torch.empty(st.ly.nbytes, dtype=torch.uint8,
                                        device=self.dev)
            st.tensor[off:off + n].copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.copying.append((dest.offset // self.piece, ev,
                             None if st.left else st))

    def _fence_one(self) -> None:
        from ..hbm.registry import registry
        from ..hbm.staging import bounded_fence, hand_off
        slot, ev, st = self.copying.popleft()
        try:
            bounded_fence(ev, "weight-h2d")
        finally:
            self.free.append(slot)
        if st is not None:      # the layer's last copy: it is on the card
            t, st.tensor = hand_off(st.tensor, ev, self.stream), None
            st.ly.handle = registry.map_device_memory(t)
            _record(st.ly, st.ts, self.host)

    def finish(self) -> None:
        while self.copying:
            self._fence_one()

    def abort(self) -> None:
        """Wait out the copies not fenced (the allocator may hand their
        blocks out again once their tensors go)."""
        from ..hbm.staging import bounded_fence
        while self.copying:
            ev = self.copying.popleft()[1]
            try:
                bounded_fence(ev, "weight-drain")
            except StromError:
                continue

    def close(self) -> None:
        """Drop the slot buffer (its unregistration synchronises)."""
        try:
            self.sess.unmap_buffer(self.handle)
        except StromError:
            pass
        self.buf.close()


def _stream_layer_subset(path: str, layers: List[_Layer], *, sess, src,
                         dev: torch.device, verify: bool, depth: int,
                         grids: tuple, host: Optional[int] = None) -> None:
    """The layer-pipelined submit, verify, adopt loop over one subset of
    spans, through ONE session: ``depth`` spans in flight (on a card a
    span past ``_PIECE`` bytes counts as its pieces of that size), each
    retired piece crc-folded against the manifest on its host bytes, a
    layer handed out once every leaf checked and every byte landed.
    Shared by the single-host streamer (every layer), each host thread of
    the sharded cold start (its round-robin slice) and the cold-start
    gate's serial leg (``depth=1``).  Fills ``ly.handle``; on failure
    drains its own reads, unmaps its own layers, then re-raises."""
    from ..data.checkpoint import _span_reap, _span_submit, _span_wait

    if not layers:
        return
    land = (_PinnedSlots(sess, layers, depth, dev, host)
            if dev.type == "cuda" else _Landings(sess, host))
    inflight: deque = deque()   # (state, offset, dest, tasks)

    def _retire() -> None:
        st, off, dest, tasks = inflight.popleft()
        try:
            _span_wait(sess, dest.whole, tasks)
            if verify:
                _verify_piece(path, st, off, dest.view)
            st.left -= 1
            land.land(st, off, dest)
        except BaseException:
            land.give_back(dest)
            raise

    try:
        for st, off, n in _pieces(layers, land.piece):
            if len(inflight) >= depth:
                _retire()       # hand out layer N while N+1.. are landing
            dest = land.take(st, off, n)
            if off == 0:
                st.ts = time.monotonic_ns()
            try:
                tasks = _span_submit(sess, src, dest.handle,
                                     st.ly.base + off, n,
                                     dest_offset=dest.offset,
                                     grids=_span_grids(grids, n))
            except BaseException:
                land.give_back(dest)
                raise
            inflight.append((st, off, dest, tasks))
        while inflight:
            _retire()
        land.finish()
    except BaseException:
        while inflight:
            dest, tasks = inflight.popleft()[2:]
            _span_reap(sess, tasks)
            land.give_back(dest)
        land.abort()
        land.close()
        _unmap_layers(layers)
        raise
    land.close()


def _resolve(device) -> torch.device:
    from ..hbm.backend import resolve_device
    return resolve_device(device)


def stream_weights(path: str, *, session=None, source=None, device=None,
                   verify: bool = True, depth: Optional[int] = None,
                   chunk_size: int = _ALIGN) -> StreamedModel:
    """Cold-start a model: stream checkpoint *path* layer by layer onto
    *device* (default ``cuda:0``, ENODEV without a card; ``"cpu"`` for the
    host), ``depth`` layers in flight (config ``weight_stream_depth``).
    ``verify`` checks each leaf's crc32c against the manifest before its
    layer is handed out (leaves without a stored checksum are skipped).
    *source* overrides the file source (the cold-start gate injects a
    latency-bound fake); *chunk_size* is the finest chunk grid of the
    reads."""
    from ..data.checkpoint import checkpoint_info
    from ..engine import Session, open_source

    meta = checkpoint_info(path)
    layers = _plan_layers(meta)
    depth = depth or int(config.get("weight_stream_depth"))
    grids = _grids(chunk_size)
    dev = _resolve(device)
    own_sess = session is None
    sess = session or Session(device=dev)
    own_src = source is None
    try:
        src = source or open_source(path)
    except BaseException:
        if own_sess:
            sess.close()
        raise
    total = sum(ly.nbytes for ly in layers)
    t0 = time.monotonic_ns()
    try:
        _stream_layer_subset(path, layers, sess=sess, src=src, dev=dev,
                             verify=verify, depth=depth, grids=grids)
    finally:
        if own_src:
            src.close()
        if own_sess:
            sess.close()
    elapsed = max(time.monotonic_ns() - t0, 1)
    stats.gauge_set("coldstart_bytes_per_sec",
                    int(total * 1_000_000_000 / elapsed))
    return StreamedModel(path, layers)


def _digest_handshake(layers: List[_Layer], ring,
                      backend: Optional[str]) -> None:
    """The sharded cold start's last step: each host contributes a digest
    row over the layers IT adopted (span base ^ length, +1 so a layer at
    offset 0 still counts), the rows all-gather around *ring* (one member
    a host; the ring permute kernel, B4, on CUDA), and every member's
    gathered rows must sum to the manifest's digests: a host that adopted
    nothing, or a layer nobody streamed, fails with EIO before the model
    is handed out.  Counted as the JAX package counts it
    (``nr_ici_permute`` / ``bytes_ici``, an ``ici_permute`` span with
    ``what="weight_digest"``)."""
    from ..parallel.ring import permute_backend, ring_all_gather

    hosts = ring.size
    n = len(layers)
    rows = np.zeros((hosts, n), np.int64)
    for ly in layers:
        h = ly.index % hosts
        if ly.handle and h != _digest_drop_host:
            rows[h, ly.index] = (ly.base ^ ly.nbytes) + 1
    shards = [torch.from_numpy(rows[h:h + 1].copy()).to(ring.devices[h])
              for h in range(hosts)]
    ts = time.monotonic_ns()
    gathered = ring_all_gather(shards, ring, backend=backend)
    sums = [g.cpu().numpy().sum(axis=0) for g in gathered]
    moved = hosts * hosts * n * rows.itemsize
    stats.add("nr_ici_permute", hosts)
    stats.add("bytes_ici", moved)
    if _trace.active:
        _trace.span("ici_permute", ts, time.monotonic_ns(), length=moved,
                    args={"steps": hosts, "ring": hosts,
                          "backend": permute_backend(
                              backend, device=ring.devices[0]),
                          "hosts": hosts, "gather": True,
                          "what": "weight_digest"})
    want = np.array([(ly.base ^ ly.nbytes) + 1 for ly in layers], np.int64)
    missing = sorted({int(i) for got in sums
                      for i in np.nonzero(got != want)[0]})
    if missing:
        raise StromError(_errno.EIO,
                         f"sharded cold-start handshake failed: layer "
                         f"digests {missing} missing or wrong")


def stream_weights_sharded(path: str, *, hosts: Optional[int] = None,
                           source_factory: Optional[Callable[[int], object]]
                           = None,
                           verify: bool = True, depth: Optional[int] = None,
                           chunk_size: int = _ALIGN,
                           devices: Optional[Sequence] = None,
                           backend: Optional[str] = None) -> StreamedModel:
    """Sharded cold start: split the checkpoint's layer spans round-robin
    over *hosts* (config ``shard_hosts``, else 1), stream each subset
    through that host's own Session and source on a thread of its own
    (the pipeline of :func:`stream_weights`), then run the digest
    handshake so no host serves before every layer landed somewhere.

    Host *h* lands its layers on ``devices[h % len(devices)]`` (default:
    every CUDA device, ENODEV without one; the tests pass ``["cpu"] *
    N``, one card ``["cuda:0"] * 4``), and the handshake runs over the
    ring of those members whatever their count, B4 on CUDA
    (``backend``: ``cuda|plain|auto``, as config ``ici_permute``).
    ``source_factory(h)`` opens host *h*'s view of the checkpoint (the
    gates inject latency-bound fakes); default ``open_source(path)``."""
    from ..data.checkpoint import checkpoint_info
    from ..engine import Session, open_source
    from ..parallel.mesh import RingMesh, make_scan_mesh

    hosts = int(hosts or config.get("shard_hosts") or 1)
    if hosts < 1:
        raise StromError(_errno.EINVAL, f"bad host count {hosts}")
    meta = checkpoint_info(path)
    layers = _plan_layers(meta)
    depth = depth or int(config.get("weight_stream_depth"))
    grids = _grids(chunk_size)
    devs = make_scan_mesh(devices).devices
    ring = RingMesh([devs[h % len(devs)] for h in range(hosts)])
    total = sum(ly.nbytes for ly in layers)
    subsets = [[ly for ly in layers if ly.index % hosts == h]
               for h in range(hosts)]
    errors: List[BaseException] = []
    t0 = time.monotonic_ns()

    def _run(h: int) -> None:
        try:
            dev = ring.devices[h]
            with Session(device=dev) as sess:
                src = source_factory(h) if source_factory \
                    else open_source(path)
                try:
                    _stream_layer_subset(path, subsets[h], sess=sess,
                                         src=src, dev=dev, verify=verify,
                                         depth=depth, grids=grids, host=h)
                finally:
                    src.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    if hosts == 1:
        _run(0)
    else:
        threads = [threading.Thread(target=_run, args=(h,),
                                    name=f"strom-coldstart-{h}")
                   for h in range(hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        _unmap_layers(layers)
        raise errors[0]
    if layers:
        try:
            _digest_handshake(layers, ring, backend)
        except BaseException:
            _unmap_layers(layers)
            raise
    elapsed = max(time.monotonic_ns() - t0, 1)
    stats.gauge_set("coldstart_bytes_per_sec",
                    int(total * 1_000_000_000 / elapsed))
    return StreamedModel(path, layers)
