"""Device-backend loss detection: bounded fences + latched revocation.

The reference's kernel module could revoke a GPU mapping from the other side of
the link (`kmod/pmemmap.c:149-208`).  Here the failure to guard against is
the device itself going away under a transfer: an unbounded wait on it is
a hang.  :class:`BackendMonitor` turns that into a detected, latched
failure:

* :meth:`BackendMonitor.fence` waits on a ``torch.cuda.Event`` with a
  deadline (config ``backend_fence_timeout``).  The fast path is one
  ``event.query()``; a pending event is synchronised in a helper thread
  joined with the deadline.
* A missed deadline or a CUDA runtime error latches loss: every registered
  :class:`.registry.HbmRegistry` revokes its buffers with ENODEV and every
  later fence fails fast.  An out-of-memory error is a per-allocation
  condition and raises ENOMEM without latching.

Also here: device resolution for every entry point of the package.  The
default is ``cuda:0``; the CPU runs only when the caller asks for it, and
with no CUDA device the default raises ENODEV instead of falling back.
"""

from __future__ import annotations

import errno as _errno
import threading
from typing import Callable, List, Optional

import torch

from ..api import StromError
from ..config import config
from ..log import pr_warn

__all__ = ["BackendMonitor", "monitor", "default_device", "resolve_device"]


def default_device(index: int = 0) -> torch.device:
    """``cuda:index``; ENODEV when this process sees no CUDA device (the
    reference's tools pick a GPU, `utils/ssd2gpu_test.c:632-656`, and the
    port never substitutes the CPU for one)."""
    if not torch.cuda.is_available():
        raise StromError(_errno.ENODEV, "no CUDA device (pass device='cpu' "
                                        "to run on the host)")
    if index >= torch.cuda.device_count():
        raise StromError(_errno.ENODEV, f"no CUDA device {index}")
    return torch.device("cuda", index)


def resolve_device(device=None) -> torch.device:
    """None -> :func:`default_device`; anything else -> ``torch.device``
    (an int is a CUDA ordinal)."""
    if device is None:
        return default_device()
    if isinstance(device, int):
        return default_device(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        return default_device(0 if dev.index is None else dev.index)
    return dev


class BackendMonitor:
    """Process-wide device-backend health latch."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lost: Optional[str] = None
        self._registries: List[object] = []
        # test hook (:class:`..testing.fake.backend_fault`): runs inside
        # the bounded wait, so an injected wedge is cut off like a real one
        self._fault: Optional[Callable[[str], None]] = None

    def lost(self) -> Optional[str]:
        with self._lock:
            return self._lost

    def check(self) -> None:
        """Raise ENODEV if the backend is latched lost."""
        why = self.lost()
        if why is not None:
            raise StromError(_errno.ENODEV, f"device backend lost: {why}")

    def register_registry(self, registry) -> None:
        with self._lock:
            if registry not in self._registries:
                self._registries.append(registry)

    def mark_lost(self, why: str) -> None:
        """Latch loss (first reason wins) and revoke registered buffers."""
        with self._lock:
            if self._lost is not None:
                return
            self._lost = why
            registries = list(self._registries)
        pr_warn("device backend LOST: %s — revoking registered buffers", why)
        for reg in registries:
            try:
                reg.revoke_all(why)
            except Exception as e:  # noqa: BLE001 - loss path must not throw
                pr_warn("revoke_all failed: %s", e)

    def reset(self) -> None:
        """Clear the latch; revoked buffers stay revoked."""
        with self._lock:
            self._lost = None

    def fence(self, event, *, what: str = "h2d",
              timeout_s: Optional[float] = None):
        """Wait until *event* (a ``torch.cuda.Event``) has completed.

        A latched loss fails immediately; a wait past the deadline or a
        runtime error latches loss and raises ENODEV; an out-of-memory
        error raises ENOMEM.  Returns *event*."""
        self.check()
        if timeout_s is None:
            timeout_s = float(config.get("backend_fence_timeout"))
        fault = self._fault
        try:
            if fault is None and event.query():
                return event
            if timeout_s <= 0:
                if fault is not None:
                    fault(what)
                event.synchronize()
                return event
            err: List[BaseException] = []

            def _wait() -> None:
                try:
                    if fault is not None:
                        fault(what)
                    event.synchronize()
                except BaseException as e:  # noqa: BLE001 - forwarded
                    err.append(e)

            t = threading.Thread(target=_wait, name="strom-fence",
                                 daemon=True)
            t.start()
            t.join(timeout_s)
            if t.is_alive():
                raise TimeoutError(f"{what} fence exceeded {timeout_s:g}s "
                                   f"(backend_fence_timeout)")
            if err:
                raise err[0]
            return event
        except StromError:
            raise
        except (KeyboardInterrupt, SystemExit):
            raise
        except torch.cuda.OutOfMemoryError as e:
            raise StromError(_errno.ENOMEM, f"device allocation failed "
                                            f"during {what}: {e}") from e
        except BaseException as e:
            self.mark_lost(f"{what}: {e}")
            raise StromError(_errno.ENODEV, f"device backend lost during "
                                            f"{what}: {e}") from e

    def _set_fault(self, hook: Optional[Callable[[str], None]]) -> None:
        self._fault = hook


#: process-global monitor; the global HbmRegistry registers with it
monitor = BackendMonitor()
