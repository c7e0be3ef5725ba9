"""Byte-rate shaping: the JAX package's ``daemon/qos.py``, reduced to its
:class:`TokenBucket`.

:mod:`..autotune` budgets readahead with one (``readahead_budget_mb_s``):
a prefetch whose bytes the bucket cannot pay now is skipped, never
waited for.  The tenants' weighted queues and latency classes of the
daemon's scheduler are not part of this package yet."""

from __future__ import annotations

import time

__all__ = ["TokenBucket"]


class TokenBucket:
    """Byte token bucket: ``rate`` bytes/s refill up to ``burst`` capacity.

    ``rate <= 0`` means unshaped (always admissible).  Items larger than
    the burst are admitted once the bucket is full — shaping stays
    approximate for oversized items instead of wedging them forever.
    Callers serialize access."""

    __slots__ = ("rate", "burst", "_tokens", "_t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._t_last = time.monotonic()

    def _refill(self, now: float) -> None:
        if now > self._t_last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now

    def ready_in(self, nbytes: int, now: float) -> float:
        """Seconds until *nbytes* is admissible (0.0 = admissible now)."""
        if self.rate <= 0:
            return 0.0
        self._refill(now)
        need = min(float(nbytes), self.burst)
        if self._tokens >= need:
            return 0.0
        return (need - self._tokens) / self.rate

    def consume(self, nbytes: int, now: float) -> None:
        """Take *nbytes* of tokens (at most a burst's worth)."""
        if self.rate <= 0:
            return
        self._refill(now)
        self._tokens -= min(float(nbytes), self.burst)
