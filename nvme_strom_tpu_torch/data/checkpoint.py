"""Direct-to-device checkpoint save and restore over torch tensors.

The JAX package's ``data/checkpoint.py`` with the same on-disk format, byte
for byte: a checkpoint written by either package restores bit-exact in the
other.  Restore streams every tensor through the same pinned-staging,
merge-planned read path as the scan; a sharded restore reads each ring
member's row range on its own.

On-disk layout (single file)::

    [ header: magic u64 | json_len u64 | header json, padded to 4096 ]
    [ leaf 0 bytes, padded to 4096 ]
    [ leaf 1 bytes, padded to 4096 ] ...

Header json: ``{version, leaves: [{key, dtype, shape, offset, nbytes,
crc32c?}]}``.  ``key`` is the JAX package's ``jax.tree_util.keystr`` of
the leaf's path (``"['w']"``, ``"['layers'][0]['b']"``), produced here by
:func:`_flatten` without JAX: a ``dict`` in sorted key order, an
``OrderedDict`` (every ``state_dict()``) in insertion order, a list or
tuple by index, a namedtuple by field, ``None`` dropped.  ``dtype`` is
numpy's ``dtype.str``; bfloat16 and float8 have none and are refused with
EINVAL (the JAX package cannot save them either).  ``crc32c`` is the
per-leaf checksum of the serialized bytes, written by
:func:`save_checkpoint`; ``restore_checkpoint(verify=True)`` recomputes it
(EBADMSG naming the leaf).  Sharded saves omit it, so verification is
when-present.
"""

from __future__ import annotations

import errno as _errno
import json
import os
import struct
import tempfile
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..api import StromError
from ..config import config
from ..engine import Session, open_source, reorder_chunks
from ..hbm.staging import (AdaptiveH2DDepth, _write_slices, bounded_fence,
                           device_empty, hand_off, resolve_device,
                           safe_device_put)
from ..parallel.mesh import RingSharding, ShardedTensor
from ..scan.heap import crc32c as _leaf_crc, crc32c_update as _leaf_crc_update
from ..tiering import extent_space
from .dtypes import numpy_dtype, torch_dtype

__all__ = ["save_checkpoint", "save_checkpoint_sharded",
           "restore_checkpoint", "checkpoint_info"]

_MAGIC = 0x53544B50_54505531  # "STKP" "TPU1"
_ALIGN = 4096
# temp litter younger than this may be a live concurrent save; only
# older files are swept (an in-flight writer touches its temp constantly)
_TMP_SWEEP_AGE_S = 3600.0


def _read_umask() -> int:
    """Current process umask WITHOUT the mutating os.umask(0) dance (which
    opens a world-writable window for other threads): Linux exposes it in
    /proc/self/status.  Falls back to the import-time snapshot below."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Umask:"):
                    return int(line.split()[1], 8)
    except (OSError, ValueError, IndexError):
        pass
    return _UMASK_AT_IMPORT


def _umask_at_import() -> int:
    u = os.umask(0)   # import runs single-threaded; window is confined
    os.umask(u)
    return u


_UMASK_AT_IMPORT = _umask_at_import()
_CHUNK = 4096          # leaf alignment: the finest chunk grid of span I/O
# chunk grids of span I/O, finest first: the engine plans a command chunk
# by chunk in Python, so a 64 MiB span on the 4 KiB grid alone — the JAX
# package's plan — costs 16384 chunks of planning; each coarser grid
# carries the part of a span its boundaries enclose
_GRIDS = (_CHUNK, 64 << 10, 1 << 20)
_VERSION = 1


def _pad(n: int, align: int = _ALIGN) -> int:
    return (n + align - 1) // align * align


def _grid_pieces(start: int, nbytes: int, grids=_GRIDS,
                 base: Optional[int] = None) -> List[tuple]:
    """Engine commands covering file bytes ``[start, start + nbytes)``
    (both multiples of ``grids[0]``): ``(chunk_size, chunk_ids, buffer
    offset)`` — the finest grid up to the next grid's first boundary, the
    middle from the coarser grids in turn, the finest grid after the
    middle's last boundary.  Fewer than 16 chunks of each finer grid on
    either side, so the chunk count is set by the span's length on the
    coarsest grid."""
    base = start if base is None else base
    end = start + nbytes
    fine = grids[0]
    if len(grids) == 1:
        return [(fine, list(range(start // fine, end // fine)),
                 start - base)] if end > start else []
    coarse = grids[1]
    a = min(end, _pad(start, coarse))
    b = max(a, end // coarse * coarse)
    return (_grid_pieces(start, a - start, grids[:1], base)
            + _grid_pieces(a, b - a, grids[1:], base)
            + _grid_pieces(b, end - b, grids[:1], base))


def _span_submit(sess: Session, source, handle: int, start: int,
                 nbytes: int, *, write: bool = False, dest_offset: int = 0,
                 grids=_GRIDS) -> List[tuple]:
    """Submit the engine commands that read file bytes ``[start, start +
    nbytes)`` into the mapped buffer *handle* from its *dest_offset* (or,
    with *write*, write them from it), one a piece of
    :func:`_grid_pieces`, all in flight together; returns the pending
    ``(task id, chunk, ids, buffer offset)`` for :func:`_span_wait`."""
    tasks = []
    try:
        for chunk, ids, off in _grid_pieces(start, nbytes, grids):
            off += dest_offset
            res = (sess.memcpy_ram2ssd(source, handle, ids, chunk,
                                       src_offset=off) if write else
                   sess.memcpy_ssd2ram(source, handle, ids, chunk,
                                       dest_offset=off))
            tasks.append((res.dma_task_id, chunk, ids, off))
    except BaseException:
        _span_reap(sess, tasks)     # submit failed midway: reap, bounded
        raise
    return tasks


def _span_reap(sess: Session, tasks) -> None:
    """Wait out *tasks* whatever their outcome (an unwind's drain)."""
    for tid, *_ in tasks:
        try:
            sess.memcpy_wait(tid, timeout=30.0)
        except StromError:
            pass


def _span_wait(sess: Session, view: memoryview, tasks,
               write: bool = False) -> None:
    """Wait for the commands of :func:`_span_submit`; the chunks of each
    read are put back in the caller's order inside *view* (the mapped
    buffer's whole view).  The first error is raised after every task was
    waited."""
    first_err = None
    for tid, chunk, ids, off in tasks:
        try:
            res = sess.memcpy_wait(tid)
        except StromError as e:
            first_err = first_err or e
            continue
        if not write and list(res.chunk_ids) != ids:
            raw = np.frombuffer(view[off:off + len(ids) * chunk], np.uint8)
            raw[:] = reorder_chunks(raw, chunk, res.chunk_ids, ids)
    if first_err is not None:
        raise first_err


def _span_io(sess: Session, source, handle: int, view: memoryview,
             start: int, nbytes: int, *, write: bool = False) -> None:
    """Read file bytes ``[start, start + nbytes)`` into the mapped buffer
    *handle* (or, with *write*, write them from it) through the engine's
    direct path, one command a piece of :func:`_grid_pieces`, all in
    flight together; chunks land in the caller's order."""
    _span_wait(sess, view, _span_submit(sess, source, handle, start, nbytes,
                                        write=write), write)


# -- tree paths ---------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree) -> List:
    """``[(key, leaf)]`` in the JAX package's order, keys in its
    ``keystr`` form.  Leaves are tensors, ShardedTensors, numpy arrays and
    scalars."""
    out: List = []

    def walk(node, prefix: str) -> None:
        if node is None:
            return
        if isinstance(node, OrderedDict):
            for k, v in node.items():
                walk(v, f"{prefix}[{k!r}]")
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}[{k!r}]")
        elif _is_namedtuple(node):
            for name, v in zip(node._fields, node):
                walk(v, f"{prefix}.{name}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")
        else:
            out.append((prefix, node))

    walk(tree, "")
    return out


def _unflatten(like, leaves: List):
    """*like*'s structure with its leaves replaced, in :func:`_flatten`'s
    order, by *leaves*."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, OrderedDict):
            new = type(node)((k, build(v)) for k, v in node.items())
            meta = getattr(node, "_metadata", None)
            if meta is not None:        # state_dict() version metadata
                new._metadata = meta
            return new
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*[build(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


# -- leaves -------------------------------------------------------------------

def _leaf_meta(key: str, leaf):
    """(numpy dtype, shape) of a leaf; EINVAL for a dtype the header
    cannot name or torch cannot restore."""
    if isinstance(leaf, (torch.Tensor, ShardedTensor)):
        return numpy_dtype(leaf.dtype, f"leaf {key}"), tuple(leaf.shape)
    arr = np.asarray(leaf)
    try:
        torch_dtype(arr.dtype)
    except StromError:
        raise StromError(_errno.EINVAL, f"leaf {key}: dtype "
                                        f"{arr.dtype.str} cannot be "
                                        f"checkpointed") from None
    return arr.dtype, tuple(int(s) for s in arr.shape)


def _entries_for(flat) -> List[Dict]:
    """Leaf table from whole-leaf shapes (a ShardedTensor's global
    shape), in the JAX package's key order: key, dtype, shape, offset,
    nbytes."""
    entries = []
    off = 0
    for key, leaf in flat:
        dtype, shape = _leaf_meta(key, leaf)
        nbytes = int(dtype.itemsize * np.prod(shape, dtype=np.int64)) \
            if shape else dtype.itemsize
        entries.append({"key": key, "dtype": dtype.str,
                        "shape": list(shape), "offset": off,
                        "nbytes": nbytes})
        off = _pad(off + nbytes)
    return entries


def _tensor_u8(t: torch.Tensor) -> torch.Tensor:
    """The bytes of tensor *t* as a flat uint8 tensor on its device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _leaf_blob(leaf, e: Dict):
    """The exact bytes entry *e*'s leaf serializes to: a flat uint8 tensor
    on the leaf's device for tensors, a uint8 numpy array otherwise."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        return _tensor_u8(leaf)
    arr = np.ascontiguousarray(np.asarray(leaf))
    if arr.dtype.str != e["dtype"]:
        arr = arr.astype(np.dtype(e["dtype"]))
    return arr.reshape(-1).view(np.uint8)


def _leaf_bytes(leaf, e: Dict) -> np.ndarray:
    """The serialized bytes on the host (the checksum pre-pass and the
    buffered writer share it, so they cannot diverge)."""
    blob = _leaf_blob(leaf, e)
    return blob.cpu().numpy() if isinstance(blob, torch.Tensor) else blob


def _first_cuda_device(flat) -> Optional[torch.device]:
    for _, leaf in flat:
        t = next((x for x in leaf.shards if x is not None), None) \
            if isinstance(leaf, ShardedTensor) else leaf
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            return t.device
    return None


def _fsync_dir(directory: str) -> None:
    try:
        dirfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dirfd)     # persist the rename itself
        finally:
            os.close(dirfd)
    except OSError:
        # the checkpoint IS installed at this point; a directory-fsync
        # refusal (weird fs, EACCES) only weakens rename durability
        pass


def _header(entries) -> tuple:
    header = json.dumps({"version": _VERSION, "leaves": entries}).encode()
    header_len = _pad(16 + len(header))
    end = header_len + (entries[-1]["offset"] + _pad(entries[-1]["nbytes"])
                        if entries else 0)
    return header, header_len, end


def _write_header(f, header: bytes, header_len: int) -> None:
    f.write(struct.pack("<QQ", _MAGIC, len(header)))
    f.write(header)
    f.write(b"\0" * (header_len - 16 - len(header)))


# -- save ---------------------------------------------------------------------

def save_checkpoint(path: str, tree: Any, *, direct: bool = False,
                    session: Optional[Session] = None,
                    staging_bytes: int = 64 << 20) -> Dict:
    """Serialize a tree of tensors (on any device), numpy arrays and
    scalars — a ``state_dict()``, or a dict of them.

    Default writer is buffered I/O + fsync.  ``direct=True`` copies each
    leaf's bytes (device to host, for a CUDA leaf) straight into a pinned
    staging buffer and writes them through the engine's async O_DIRECT
    write path (``Session.memcpy_ram2ssd``), so a large save does not
    evict the page cache the rest of the host uses.

    Crash-safe: bytes land in a same-directory temp file that is fsynced
    and atomically renamed over *path* (through a symlink, its target);
    a failure mid-save never corrupts an existing checkpoint at *path*.
    After the rename every residency-tier extent over *path* is dropped.
    """
    flat = _flatten(tree)
    entries = _entries_for(flat)
    # per-leaf crc32c: the header precedes the data on disk, so checksums
    # come from a pre-pass — one leaf on the host at a time, the same peak
    # host memory as the writer loop below
    for e, (key, leaf) in zip(entries, flat):
        e["crc32c"] = _leaf_crc(_leaf_bytes(leaf, e))
    header, header_len, end = _header(entries)
    # write through symlinks ('latest.strom -> step-N.strom' layouts):
    # os.replace on the link path would swap the link for a regular file
    # and leave the target stale
    path = os.path.realpath(path)
    directory = os.path.dirname(path) or "."
    base = os.path.basename(path)
    # sweep temp litter from hard-killed saves — only litter OLD enough
    # that it cannot be a concurrent saver's in-flight temp
    now = time.time()
    for stale in os.listdir(directory):
        if stale.startswith(base + ".tmp.") \
                or stale == base + ".shared_tmp":
            sp = os.path.join(directory, stale)
            try:
                if now - os.path.getmtime(sp) > _TMP_SWEEP_AGE_S:
                    os.unlink(sp)
            except OSError:
                pass
    # mkstemp: unique per save, so concurrent savers to one path cannot
    # truncate each other's in-flight temp
    tmp_fd, tmp = tempfile.mkstemp(dir=directory, prefix=base + ".tmp.")
    try:
        # mkstemp's 0600 would stick after the rename; honour the umask
        # like a plain open(path, 'wb') writer would
        os.fchmod(tmp_fd, 0o666 & ~_read_umask())
        with os.fdopen(tmp_fd, "wb") as f:
            _write_header(f, header, header_len)
            if not direct:
                # one leaf at a time: peak extra host memory = one leaf
                for e, (key, leaf) in zip(entries, flat):
                    f.seek(header_len + e["offset"])
                    f.write(_leaf_bytes(leaf, e))
            f.truncate(_pad(end))
            f.flush()
            os.fsync(f.fileno())
        if direct:
            _save_leaves_direct(tmp, entries, flat, header_len,
                                session, staging_bytes)
        os.replace(tmp, path)
        # the rename installed new bytes under the old identity: drop
        # every residency-tier extent over *path*
        extent_space.invalidate_paths([path])
        _fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return {"path": path, "leaves": len(entries), "bytes": _pad(end)}


def _save_leaves_direct(path, entries, flat, header_len,
                        session, staging_bytes) -> None:
    """Write every leaf through the engine's async O_DIRECT write path,
    one pinned staging buffer at a time."""
    dev = _first_cuda_device(flat)
    own = session is None
    sess = session or Session(device=dev)
    staging_bytes = _pad(staging_bytes, _CHUNK)
    try:
        with open_source(path, writable=True) as sink:
            handle, buf = sess.alloc_dma_buffer(staging_bytes)
            host = torch.frombuffer(buf.view(), dtype=torch.uint8)
            try:
                if dev is not None:
                    buf.pin_cuda()
                for e, (key, leaf) in zip(entries, flat):
                    blob = _leaf_blob(leaf, e)
                    on_card = isinstance(blob, torch.Tensor) \
                        and blob.device.type == "cuda"
                    base = header_len + e["offset"]   # _ALIGN-aligned
                    done = 0
                    while done < e["nbytes"]:
                        take = min(staging_bytes, e["nbytes"] - done)
                        padded = _pad(take, _CHUNK)
                        if on_card:
                            # D2H on the stream that produced the leaf,
                            # fenced (bounded) before the write reads it
                            stream = torch.cuda.current_stream(blob.device)
                            host[:take].copy_(blob[done:done + take],
                                              non_blocking=True)
                            ev = torch.cuda.Event()
                            ev.record(stream)
                            bounded_fence(ev, "ckpt-d2h")
                        elif isinstance(blob, torch.Tensor):
                            host[:take].copy_(blob[done:done + take])
                        else:
                            host[:take].numpy()[:] = blob[done:done + take]
                        host[take:padded].zero_()
                        _span_io(sess, sink, handle, buf.view(),
                                 base + done, padded, write=True)
                        done += take
            finally:
                del host
                sess.unmap_buffer(handle)
                buf.close()
            sink.sync()
    finally:
        if own:
            sess.close()


def _pwrite_all(fd: int, data, off: int) -> None:
    """pwrite the whole buffer, looping over short writes."""
    mv = memoryview(data).cast("B")
    done = 0
    while done < len(mv):
        n = os.pwrite(fd, mv[done:], off + done)
        if n <= 0:
            raise StromError(_errno.EIO,
                             f"pwrite returned {n} at offset {off + done}")
        done += n


def save_checkpoint_sharded(path: str, tree: Any) -> Dict:
    """Save a tree whose leaves may be :class:`ShardedTensor`\\ s over a
    ring, writing each shard's row range where it belongs in one file —
    no gather.  The layout is :func:`save_checkpoint`'s, data sections
    byte-identical, without the per-leaf crc32c (no writer holds a whole
    leaf), so either restore path reads it.

    A leading-axis split writes each distinct row block once (the first
    member holding it: sp lanes replicate dp blocks); a replicated leaf is
    written once, from member 0; plain tensors and arrays are written
    whole, by rank 0.  Over ranks (:mod:`..parallel.dist`) every rank
    calls this on the same tree and writes only the blocks of its own
    members, through one shared file on a filesystem every rank reaches
    (the reference's ``save_checkpoint_sharded``): each rank checks its
    leaves' layouts (leading-axis splits, addressable shards of the
    sharding's shape) before anything is written and the verdicts are
    gathered with each rank's leaf table, so a refusal on one rank (or
    ranks disagreeing on the table) is a refusal (EINVAL) on every rank
    before the file exists; then rank 0 writes the header, barrier
    ``header``, every rank writes and fsyncs its blocks, barrier ``data``,
    rank 0 renames the file over *path*, barrier ``installed``.  Crash-safe
    per save through the shared temp file; after the rename each rank's
    residency tiers drop their extents over it.  Concurrent sharded saves
    to one path are not supported."""
    from ..parallel import dist
    flat = _flatten(tree)
    entries = _entries_for(flat)
    bad = _sharded_layout_error(flat)
    if dist.process_count() > 1:
        # one rank's refusal is every rank's, before any barrier; ranks
        # that disagree on the leaf table would write two headers
        views = dist.all_gather_object((bad, entries))
        verdicts = [v for v, _e in views if v]
        if bad is None and verdicts:
            bad = verdicts[0]
        elif bad is None and any(e != entries for _v, e in views):
            bad = "ranks disagree on the leaf table (shapes or dtypes)"
    if bad is not None:
        raise StromError(_errno.EINVAL, bad)
    me = dist.process_index()
    header, header_len, end = _header(entries)
    path = os.path.realpath(path)
    tmp = path + ".shared_tmp"
    try:
        if me == 0:
            with open(tmp, "wb") as f:
                _write_header(f, header, header_len)
                f.truncate(_pad(end))
                f.flush()
                os.fsync(f.fileno())
        dist.barrier("header")
        fd = os.open(tmp, os.O_WRONLY)
        try:
            for e, (_key, leaf) in zip(entries, flat):
                base = header_len + e["offset"]
                if not isinstance(leaf, ShardedTensor):
                    if me == 0:
                        _pwrite_all(fd, _leaf_bytes(leaf, e), base)
                    continue
                rowbytes = _row_bytes(e)
                # one writer per distinct block, the first member holding
                # it: lanes and replicas hold copies another member writes
                firsts: Dict[tuple, int] = {}
                idxs = leaf.sharding.indices(leaf.shape) if e["shape"] \
                    else [()] * len(leaf.shards)
                for i, idx in enumerate(idxs):
                    firsts.setdefault((idx[0].start, idx[0].stop)
                                      if idx else (0, 0), i)
                for (r0, _r1), i in sorted(firsts.items()):
                    t = leaf.shards[i]
                    if t is None:       # another rank's member writes it
                        continue
                    _pwrite_all(fd, _tensor_u8(t).cpu().numpy(),
                                base + r0 * rowbytes)
            os.fsync(fd)
        finally:
            os.close(fd)
        dist.barrier("data")
        if me == 0:
            os.replace(tmp, path)
            _fsync_dir(os.path.dirname(path) or ".")
        dist.barrier("installed")
        extent_space.invalidate_paths([path])
    except BaseException:
        if me == 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
    return {"path": path, "leaves": len(entries), "bytes": _pad(end)}


def _row_bytes(e: Dict) -> int:
    """Bytes of one leading-axis row of entry *e*'s leaf."""
    shape = e["shape"]
    return int(np.dtype(e["dtype"]).itemsize
               * np.prod(shape[1:], dtype=np.int64)) \
        if len(shape) > 1 else np.dtype(e["dtype"]).itemsize


def _sharded_layout_error(flat) -> Optional[str]:
    """Why this rank's sharded leaves cannot be saved, or None: a split of
    another axis than the leading one, or an addressable shard whose shape
    is not the sharding's."""
    for key, leaf in flat:
        if not isinstance(leaf, ShardedTensor):
            continue
        sh = leaf.sharding
        if not sh.leading_only:
            return (f"leaf {key}: sharded save supports leading-axis "
                    f"sharding only (spec {sh.spec} splits another axis)")
        want = sh.shard_shape(leaf.shape)
        for i, t in enumerate(leaf.shards):
            if t is not None and tuple(t.shape) != want:
                return (f"leaf {key}: member {i}'s shard is "
                        f"{tuple(t.shape)}, the sharding's is {want}")
    return None


# -- inspect ------------------------------------------------------------------

def checkpoint_info(path: str) -> Dict:
    """Read the header (magic check + leaf table) without touching data."""
    with open(path, "rb") as f:
        magic, jlen = struct.unpack("<QQ", f.read(16))
        if magic != _MAGIC:
            raise StromError(_errno.EINVAL, f"{path}: not a strom checkpoint")
        meta = json.loads(f.read(jlen))
    if meta.get("version") != _VERSION:
        raise StromError(_errno.EINVAL, f"checkpoint version {meta.get('version')}")
    meta["data_offset"] = _pad(16 + jlen)
    return meta


# -- restore ------------------------------------------------------------------

def _leaf_sharding(shardings, key: str) -> Optional[RingSharding]:
    if shardings is None:
        return None
    if isinstance(shardings, dict):
        return shardings.get(key)
    return shardings  # one sharding for every leaf


class _PinnedRing:
    """Rotating pinned buffers + H2D fences for checkpoint restore.

    Max width from config ``h2d_depth_max`` (min 2); the ACTIVE rotation
    window is :class:`..hbm.staging.AdaptiveH2DDepth`: it starts at 2,
    widens whenever the rotation actually blocks on a fence and decays
    back when fences stop blocking.  Buffers are allocated lazily as the
    window grows, and pinned for CUDA when *cuda*.  Each buffer keeps the
    fences (CUDA events) of the copies that read it; H2D copies run on
    one copy stream per device."""

    def __init__(self, sess: Session, staging_bytes: int, cuda: bool):
        self.sess = sess
        self.cap = staging_bytes
        self.cuda = cuda
        n = max(2, int(config.get("h2d_depth_max")))
        self.adaptive = AdaptiveH2DDepth(n)
        self.bufs: List[tuple] = []
        self.fences: List[list] = []
        self.cur = -1
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def peek(self) -> int:
        """Index :meth:`next_buf` rotates to."""
        return (self.cur + 1) % self.adaptive.depth

    def stream(self, dev: torch.device):
        if dev.type != "cuda":
            return None
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def next_buf(self):
        """Rotate to the next in-window pinned buffer; fence its previous
        H2D reads, feeding the observed wait back to the depth policy."""
        self.cur = self.peek()
        while self.cur >= len(self.bufs):   # window grew: alloc lazily
            handle, buf = self.sess.alloc_dma_buffer(self.cap)
            if self.cuda:
                buf.pin_cuda()
            self.bufs.append((handle, buf))
            self.fences.append([])
        t0 = time.monotonic_ns()
        for f in self.fences[self.cur]:
            bounded_fence(f, "ckpt-h2d")   # ENODEV on a dead backend
        blocked_ns = time.monotonic_ns() - t0
        self.fences[self.cur] = []
        self.adaptive.observe(blocked_ns)
        return self.bufs[self.cur]

    def put(self, host: np.ndarray, dev: torch.device) -> torch.Tensor:
        """H2D of *host* (bytes in the current buffer) into a new uint8
        tensor on *dev*, fenced on the current buffer (several puts may
        read the same staged bytes — replicated shards)."""
        t, fence = safe_device_put(host, dev, stream=self.stream(dev))
        if self.cur >= 0:       # an empty span read no buffer
            self.fences[self.cur].append(fence)
        return t

    def close(self):
        for fl in self.fences:
            for f in fl:
                try:
                    bounded_fence(f, "ckpt-drain")
                except StromError:
                    # per fence: a latched loss fails the rest at once
                    continue
        for handle, buf in self.bufs:
            try:
                self.sess.unmap_buffer(handle)
            except StromError:
                pass
            buf.close()
        self.bufs = []


def _read_span(sess, source, file_off: int, nbytes: int,
               ring: _PinnedRing) -> np.ndarray:
    """Read one byte span through the direct path.

    Returns a view into the ring's current pinned buffer (consume with
    ``ring.put`` before the next ``_read_span``), or an owned array when
    the span exceeds one staging buffer."""
    if nbytes == 0:
        return np.empty(0, np.uint8)
    handle, buf = ring.next_buf()
    cap = len(buf.view())
    out = np.empty(nbytes, np.uint8) if nbytes > cap else None
    done = 0
    view = None
    while done < nbytes:
        take = min(cap, nbytes - done)
        start = file_off + done
        padded = _pad(take, _CHUNK)
        if start % _CHUNK == 0 and start + padded <= source.size:
            _span_io(sess, source, handle, buf.view(), start, padded)
            view = np.frombuffer(buf.view()[:take], np.uint8)
        else:
            # unaligned head or grid running past EOF: buffered leg
            source.read_buffered(start, buf.view()[:take])
            view = np.frombuffer(buf.view()[:take], np.uint8)
        if out is not None:
            out[done:done + take] = view
        done += take
    return out if out is not None else view[:nbytes]


def _restore_streamed(sess, source, base: int, dtype: np.dtype, shape,
                      dev: torch.device, ring: _PinnedRing,
                      compute_crc: bool = False):
    """Stream a leaf larger than one staging buffer straight onto the
    device: a ``torch.empty`` leaf, filled span by span in place — no
    host assembly of the whole leaf.

    Up to config ``scan_dispatch_batch`` staged spans land per fence
    (:func:`.._write_slices`, one CUDA event after their copies); a batch
    lands early when the ring is about to rotate onto a buffer whose span
    has not landed yet.  The JAX package routed leaves past 2^31 elements
    elsewhere for its int32 slice index; byte offsets here are 64-bit."""
    nbytes = int(dtype.itemsize * np.prod(shape, dtype=np.int64)) \
        if shape else dtype.itemsize
    stream = ring.stream(dev)
    dest = device_empty(nbytes, dev, stream)
    kmax = max(1, int(config.get("scan_dispatch_batch")))
    pending: List[tuple] = []   # (host view, byte offset, ring buffer)
    fence = None

    def flush():
        nonlocal fence
        if not pending:
            return
        fence = _write_slices(dest, [p[1] for p in pending],
                              [p[0] for p in pending], stream=stream)
        for idx in {p[2] for p in pending}:
            ring.fences[idx].append(fence)
        pending.clear()

    done = 0
    crc = 0
    while done < nbytes:
        take = min(ring.cap, nbytes - done)
        # element-align every take; the final take is nbytes - done,
        # already element-aligned by induction
        take -= take % dtype.itemsize
        if any(p[2] == ring.peek() for p in pending):
            flush()   # the next buffer still holds a span not landed
        view = _read_span(sess, source, base + done, take, ring)
        if compute_crc:
            # incremental: sub-spans are sequential and exhaustive, so the
            # running crc equals the whole-leaf checksum at the end
            crc = _leaf_crc_update(crc, view)
        pending.append((view, done, ring.cur))
        if len(pending) >= kmax:
            flush()
        done += take
    flush()
    out = hand_off(dest, fence, stream)
    return (out.view(torch_dtype(dtype)).reshape(shape),
            crc if compute_crc else None)


def restore_checkpoint(path: str, *, shardings=None, like=None,
                       session: Optional[Session] = None,
                       device=None, staging_bytes: int = 64 << 20,
                       verify: bool = False):
    """Load a checkpoint into device tensors through the direct path.

    ``device`` — where unsharded leaves go (default ``cuda:0``, ENODEV
    with no card; ``"cpu"`` for the host).  ``shardings`` — None, one
    :class:`..parallel.mesh.RingSharding` for every leaf, or a dict
    ``{key: RingSharding}`` (keys as in the header, ``"['w']"``); a
    sharded leaf comes back as a :class:`ShardedTensor`, each member's
    rows read on their own (replicated: one read, one H2D per member).
    ``like`` — a tree of the saved structure (a model's ``state_dict()``)
    to rebuild; by default a flat ``{key: tensor}`` dict is returned, so
    ``model.load_state_dict(restore_checkpoint(p, like=model.state_dict()))``
    works.

    ``verify=True`` recomputes each leaf's crc32c from the bytes read and
    compares it with the header's: a mismatch raises EBADMSG naming the
    leaf.  Leaves without a stored checksum (sharded saves) and sharded
    restores (no read sees a whole leaf) are not checked.

    Before the call returns, the caller's current stream waits on every
    leaf's copies, so a forward pass launched right after sees every byte.
    """
    meta = checkpoint_info(path)
    data0 = meta["data_offset"]
    plain = any(_leaf_sharding(shardings, e["key"]) is None
                for e in meta["leaves"])
    dev = resolve_device(device) if plain or not meta["leaves"] else None
    for e in meta["leaves"]:
        sh = _leaf_sharding(shardings, e["key"])
        if sh is not None:
            sh.check(f"leaf {e['key']}", tuple(e["shape"]))
            dev = dev or sh.mesh.home()
    own = session is None
    sess = session or Session(device=dev)
    out: Dict[str, Any] = {}
    try:
        with open_source(path) as source:
            ring = _PinnedRing(sess, staging_bytes,
                               cuda=dev is not None and dev.type == "cuda")
            try:
                for e in meta["leaves"]:
                    key = e["key"]
                    dtype = np.dtype(e["dtype"])
                    shape = tuple(e["shape"])
                    base = data0 + e["offset"]
                    sh = _leaf_sharding(shardings, key)
                    if sh is not None:
                        # sharded restores read only member row ranges —
                        # no read sees a whole leaf, so no crc check
                        out[key] = _restore_sharded(sess, source, base,
                                                    dtype, shape, sh, ring,
                                                    key)
                        continue
                    want = e.get("crc32c") if verify else None
                    if e["nbytes"] > ring.cap \
                            and ring.cap >= dtype.itemsize:
                        out[key], got = _restore_streamed(
                            sess, source, base, dtype, shape, dev, ring,
                            compute_crc=want is not None)
                    else:
                        span = _read_span(sess, source, base, e["nbytes"],
                                          ring)
                        got = _leaf_crc(span) if want is not None else None
                        out[key] = ring.put(span, dev).view(
                            torch_dtype(dtype)).reshape(shape)
                    if want is not None and got != want:
                        raise StromError(
                            _errno.EBADMSG,
                            f"{path}: leaf {key} crc32c mismatch "
                            f"(header {want:#010x}, data {got:#010x})"
                            f" — checkpoint is corrupt")
            finally:
                ring.close()
    finally:
        if own:
            sess.close()
    if like is not None:
        return _unflatten(like, [out[k] for k, _ in _flatten(like)])
    return out


def _restore_sharded(sess, source, base, dtype, shape, sharding,
                     ring: _PinnedRing, key: str) -> ShardedTensor:
    """A leaf over a mesh from per-member reads: one SSD read per unique
    leading-axis row range, then each member's slice of the other axes
    cut on the host (the reference's ``_restore_sharded``).  A scalar is
    replicated.  Members on one device that own the same slice share one
    tensor (one H2D).  Only this process's members' rows are read; another
    rank's member is None."""
    mesh = sharding.mesh
    if not shape:   # scalar leaf: replicate
        idxs = [()] * mesh.size
        rowbytes = dtype.itemsize
    else:
        idxs = sharding.indices(shape, f"leaf {key}")
        rowbytes = int(dtype.itemsize * np.prod(shape[1:], dtype=np.int64)) \
            if len(shape) > 1 else dtype.itemsize
    by_range: Dict[tuple, List[int]] = {}
    for i, idx in enumerate(idxs):
        if not mesh.is_local(i):
            continue
        rkey = (idx[0].start, idx[0].stop) if idx else (0, 1)
        by_range.setdefault(rkey, []).append(i)
    tdtype = torch_dtype(dtype)
    shards: List[Optional[torch.Tensor]] = [None] * mesh.size
    for (r0, r1), members in by_range.items():
        host = _read_span(sess, source, base + r0 * rowbytes,
                          (r1 - r0) * rowbytes, ring)
        block = (r1 - r0,) + tuple(shape[1:]) if shape else ()
        placed: Dict[tuple, torch.Tensor] = {}
        for i in members:
            sub = idxs[i][1:]
            dev = mesh.devices[i]
            pkey = (tuple((s.start, s.stop) for s in sub), dev)
            if pkey not in placed:
                if any(s != slice(0, n) for s, n in zip(sub, shape[1:])):
                    # sliced as same-width words: any leaf dtype
                    part = np.ascontiguousarray(
                        host.view(f"<u{dtype.itemsize}").reshape(block)
                        [(slice(None),) + tuple(sub)])
                    placed[pkey] = ring.put(part.reshape(-1).view(np.uint8),
                                            dev).view(tdtype) \
                        .reshape(part.shape)
                else:
                    placed[pkey] = ring.put(host, dev).view(tdtype) \
                        .reshape(block)
            shards[i] = placed[pkey]
    return ShardedTensor(shards, sharding)
