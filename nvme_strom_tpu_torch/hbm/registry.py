"""Device memory registration.

Capability analog of the reference's GPU memory mapper (``MAP_GPU_MEMORY``
et al., `kmod/pmemmap.c:19-495`): registration allocates (or adopts) a
destination tensor, hands out an integer handle, refcounts in-flight
transfers against it, and supports revocation (``unmap``) that blocks until
transfers drain.

Where the JAX package had to install a successor array after every donated
functional update (``swap``), a torch tensor is written in place: loads
``copy_`` into slices of :attr:`HbmBuffer.tensor`, and the holder only
changes its tensor when a zero-copy landing adopts a new one.
"""

from __future__ import annotations

import errno as _errno
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from ..api import BufferInfo, StromError
from .backend import monitor as _monitor, resolve_device

__all__ = ["HbmBuffer", "HbmRegistry", "LandingBuffer", "registry"]

_DEVICE_PAGE = 4096       # informational page size reported in INFO


class LandingBuffer:
    """Owned, page-aligned destination for zero-copy landing (CPU only).

    The staging ring's slots are reused, so their bytes must be copied off
    before the next SSD read; a LandingBuffer belongs to exactly one
    destination, so the engine's reads land here and the destination tensor
    is an alias of this memory (``torch.frombuffer``).  ``release()`` unmaps
    it from the session; the munmap itself waits until the last aliasing
    tensor is gone."""

    def __init__(self, session, nbytes: int):
        if nbytes <= 0:
            raise StromError(_errno.EINVAL,
                             "landing buffer size must be positive")
        self.nbytes = int(nbytes)
        self._session = session
        self.handle, self._dma = session.alloc_dma_buffer(self.nbytes)
        self._released = False

    def view(self) -> memoryview:
        return self._dma.view()[:self.nbytes]

    def adopt_tensor(self, dtype: torch.dtype) -> torch.Tensor:
        """The landed bytes as a CPU tensor aliasing this buffer."""
        return torch.frombuffer(self.view(), dtype=dtype)

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            self._session.unmap_buffer(self.handle)
        except StromError:
            pass        # session already closed / handle already gone
        self._dma.close()


class HbmBuffer:
    """Holder of one registered destination tensor."""

    def __init__(self, handle: int, tensor: torch.Tensor, owner_uid: int):
        self.handle = handle
        self._tensor = tensor
        self.owner_uid = owner_uid
        self.refcount = 0
        self.revoke_reason: Optional[str] = None
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._revoked = False
        self._landing: Optional[LandingBuffer] = None

    @property
    def tensor(self) -> torch.Tensor:
        with self._lock:
            if self._revoked:
                raise StromError(_errno.ENODEV,
                                 f"buffer {self.handle} revoked")
            return self._tensor

    def adopt(self, tensor: torch.Tensor, landing: LandingBuffer) -> None:
        """Install a directly-landed tensor together with the buffer it
        aliases; the holder owns *landing* from here on."""
        with self._lock:
            if self._revoked:
                raise StromError(_errno.ENODEV,
                                 f"buffer {self.handle} revoked")
            prev, self._landing = self._landing, landing
            self._tensor = tensor
        if prev is not None:
            prev.release()

    def _release_landing(self) -> None:
        with self._lock:
            landing, self._landing = self._landing, None
        if landing is not None:
            landing.release()

    @property
    def nbytes(self) -> int:
        return self._tensor.numel() * self._tensor.element_size()

    @property
    def device(self) -> torch.device:
        return self._tensor.device


class HbmRegistry:
    """Handle table of registered device buffers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buffers: Dict[int, HbmBuffer] = {}
        self._next = 1

    def map_device_memory(self, size_or_tensor, *,
                          dtype: torch.dtype = torch.uint8,
                          device=None) -> int:
        """Register a destination: adopt an existing tensor, or allocate
        ``size`` zeroed elements of ``dtype`` on *device* (default
        ``cuda:0``)."""
        if isinstance(size_or_tensor, torch.Tensor):
            t = size_or_tensor
        else:
            n = int(size_or_tensor)
            if n <= 0:
                raise StromError(_errno.EINVAL,
                                 "buffer size must be positive")
            t = torch.zeros(n, dtype=dtype, device=resolve_device(device))
        with self._lock:
            handle = self._next
            self._next += 1
            self._buffers[handle] = HbmBuffer(handle, t, os.getuid())
        return handle

    def get(self, handle: int) -> HbmBuffer:
        with self._lock:
            buf = self._buffers.get(handle)
        if buf is None:
            raise StromError(_errno.ENOENT, f"no device buffer {handle}")
        if buf.owner_uid != os.getuid():
            raise StromError(_errno.EPERM,
                             "device buffer owned by another uid")
        return buf

    def acquire(self, handle: int) -> HbmBuffer:
        buf = self.get(handle)
        with buf._lock:
            if buf._revoked:
                raise StromError(_errno.ENODEV, f"buffer {handle} revoked")
            buf.refcount += 1
        return buf

    def release(self, buf: HbmBuffer) -> None:
        with buf._lock:
            buf.refcount -= 1
            if buf.refcount == 0:
                buf._drained.notify_all()

    def unmap(self, handle: int, *, timeout: float = 30.0) -> None:
        """Revoke a handle, blocking until in-flight transfers drain (the
        ``callback_release_mapped_gpu_memory`` contract,
        kmod/pmemmap.c:149-208).  A buffer already revoked by backend loss
        unregisters at once."""
        buf = self.get(handle)
        deadline = time.monotonic() + timeout
        with buf._lock:
            while buf.refcount != 0 and not buf._revoked:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise StromError(
                        _errno.ETIMEDOUT,
                        f"buffer {handle} busy past revocation timeout")
                buf._drained.wait(timeout=remaining)
            buf._revoked = True
        with self._lock:
            self._buffers.pop(handle, None)
        buf._release_landing()

    def revoke_all(self, why: str) -> int:
        """Backend-loss revocation: mark every buffer revoked without
        waiting for refcounts (the transfers died with the backend) and
        wake any ``unmap`` drain.  Returns the number revoked."""
        with self._lock:
            bufs = list(self._buffers.values())
        n = 0
        for buf in bufs:
            with buf._lock:
                if not buf._revoked:
                    buf._revoked = True
                    buf.revoke_reason = why
                    n += 1
                buf._drained.notify_all()
            buf._release_landing()
        return n

    def list(self) -> List[int]:
        with self._lock:
            return sorted(self._buffers)

    def info(self, handle: int) -> BufferInfo:
        buf = self.get(handle)
        return BufferInfo(handle=handle, length=buf.nbytes,
                          page_size=_DEVICE_PAGE,
                          n_pages=(buf.nbytes + _DEVICE_PAGE - 1)
                          // _DEVICE_PAGE,
                          owner_uid=buf.owner_uid, refcount=buf.refcount,
                          kind="hbm", device=str(buf.device))


#: process-global registry; backend loss revokes its buffers
registry = HbmRegistry()
_monitor.register_registry(registry)
