"""Fault policy of the I/O engine: retry, member health, dirty extents.

The port's own copy of the JAX package's ``fault.py``.  The reference
latches a task's first error until the caller reaps it (the kernel
module's first-error latch) and has no recovery tier; this module is the
policy half of the one the engine adds:

* :class:`RetryPolicy`: bounded attempts with exponential backoff and
  jitter, from config ``io_retries``, ``retry_backoff_ms``,
  ``retry_backoff_max_ms`` and ``retry_jitter``;
* :class:`MemberHealthMachine`: one health state a stripe member::

      healthy <-> suspect             (p99 > suspect_ratio x the median)
      healthy/suspect -> quarantined  (quarantine_after transient
                                       failures in a row, quarantine_s)
      healthy/suspect -> failed       (a PERSISTENT error)
      quarantined --timer--> rejoining
      failed --canary success--> rejoining
      rejoining --rejoin_successes--> healthy   (token-bucket warmup)
      rejoining --transient failure--> quarantined
      rejoining --persistent failure--> failed

  SUSPECT members stay direct but are hedge targets; QUARANTINED and
  FAILED ones route to their mirror or the buffered leg; REJOINING ones
  take direct traffic at ``rejoin_tokens_s``;
* :class:`DirtyExtentJournal`: the extents a degraded member missed while
  a paired write landed on its mirror only, replayed before it may be
  HEALTHY again.

The machine reads time through its ``clock`` (default
``time.monotonic``), so a test can step it.  The mechanism half (where
retries, hedges, mirror reads and fallbacks happen) is
:class:`..engine.Session`.
"""

from __future__ import annotations

import enum
import random
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .config import config
from .stats import LAT_HIST_BUCKETS, hist_percentiles, stats
from .trace import recorder as _trace

__all__ = ["RetryPolicy", "HealthState", "MemberHealthMachine",
           "MemberHealth", "DirtyExtentJournal", "ALLOWED_TRANSITIONS"]


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry schedule for TRANSIENT I/O errors.

    ``attempts`` is the number of *re*-tries after the first failure; the
    backoff before retry ``i`` (0-based) is ``base * 2**i`` clamped to
    ``ceiling``, scaled by a uniform jitter in ``[1 - jitter, 1]`` so a
    striped set's members don't retry in lockstep.
    """

    attempts: int = 3
    backoff_s: float = 0.005
    backoff_max_s: float = 1.0
    jitter: float = 0.5

    @classmethod
    def from_config(cls) -> "RetryPolicy":
        return cls(attempts=int(config.get("io_retries")),
                   backoff_s=float(config.get("retry_backoff_ms")) / 1e3,
                   backoff_max_s=float(config.get("retry_backoff_max_ms")) / 1e3,
                   jitter=float(config.get("retry_jitter")))

    def delay(self, attempt: int, rng: random.Random = None) -> float:
        """Sleep before retry number ``attempt`` (0-based)."""
        d = min(self.backoff_s * (2 ** attempt), self.backoff_max_s)
        if d <= 0:
            return 0.0
        scale = 1.0 - (rng or random).uniform(0.0, self.jitter)
        return d * scale

    def sleep(self, attempt: int, rng: random.Random = None) -> None:
        d = self.delay(attempt, rng)
        if d > 0:
            time.sleep(d)


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    QUARANTINED = "quarantined"
    FAILED = "failed"
    REJOINING = "rejoining"


# Every edge the machine may take; the chaos harness asserts observed
# transition logs stay inside this set.
ALLOWED_TRANSITIONS = frozenset({
    (HealthState.HEALTHY, HealthState.SUSPECT),
    (HealthState.SUSPECT, HealthState.HEALTHY),
    (HealthState.HEALTHY, HealthState.QUARANTINED),
    (HealthState.SUSPECT, HealthState.QUARANTINED),
    (HealthState.HEALTHY, HealthState.FAILED),
    (HealthState.SUSPECT, HealthState.FAILED),
    (HealthState.QUARANTINED, HealthState.FAILED),
    (HealthState.QUARANTINED, HealthState.REJOINING),
    (HealthState.FAILED, HealthState.REJOINING),
    (HealthState.REJOINING, HealthState.HEALTHY),
    (HealthState.REJOINING, HealthState.QUARANTINED),
    # a PERSISTENT error during warmup (or from a straggler read issued
    # before the fail-stop) re-fails the member outright
    (HealthState.REJOINING, HealthState.FAILED),
})

# decay the per-member latency histogram once it holds this many samples
# so SUSPECT can clear after the member recovers
_HIST_DECAY_AT = 2048
# minimum samples before a member's p99 participates in suspect math
_SUSPECT_MIN_SAMPLES = 32
# evaluate the suspect predicate every N observations (it walks every
# member's histogram; per-request would be wasteful)
_SUSPECT_EVERY = 32


#: replay granularity: merged journal intervals are consumed in chunks of
#: this size so one token-bucket token maps to a bounded burst and the
#: replay scratch buffer stays small
_RESYNC_CHUNK = 1 << 20


class DirtyExtentJournal:
    """Per-member dirty-extent journal for mirror-coherent writes.

    When a write degrades to mirror-only because the health machine holds
    a member QUARANTINED/FAILED, the extents the member *missed* are
    recorded here (keyed by a weak sink reference so a closed sink drops
    its debt).  The rejoin path replays them — read-from-mirror, write-to-
    rejoiner — and :class:`MemberHealthMachine` refuses the
    REJOINING→HEALTHY edge while a member still owes bytes, so a rejoined
    disk never serves stale data.  Adjacent/overlapping records merge, so
    rewriting one hot range while degraded journals it once.

    The ``resync_pending_bytes`` gauge tracks journal content exactly:
    :meth:`record` adds, :meth:`take_extent` subtracts, :meth:`put_back`
    re-adds (replay failures don't leak debt).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # member -> sink weakref -> sorted disjoint [start, end) intervals
        self._ext: Dict[int, Dict["weakref.ref", List[List[int]]]] = {}

    def _drop_ref(self, ref: "weakref.ref") -> None:
        dropped = 0
        with self._lock:
            for member in list(self._ext):
                ivs = self._ext[member].pop(ref, None)
                if ivs:
                    dropped += sum(e - s for s, e in ivs)
                if not self._ext[member]:
                    del self._ext[member]
        if dropped:
            stats.gauge_add("resync_pending_bytes", -dropped)

    def record(self, sink, member: int, file_off: int, length: int) -> None:
        """Journal [file_off, file_off+length) as stale on *member*."""
        if length <= 0:
            return
        start, end = int(file_off), int(file_off) + int(length)
        with self._lock:
            per = self._ext.setdefault(member, {})
            ivs = None
            for ref in per:
                if ref() is sink:
                    ivs = per[ref]
                    break
            if ivs is None:
                ivs = per[weakref.ref(sink, self._drop_ref)] = []
            before = sum(e - s for s, e in ivs)
            merged: List[List[int]] = []
            for s, e in ivs:
                if e < start or s > end:
                    merged.append([s, e])
                else:
                    start, end = min(start, s), max(end, e)
            merged.append([start, end])
            merged.sort()
            ivs[:] = merged
            added = sum(e - s for s, e in ivs) - before
        if added:
            stats.gauge_add("resync_pending_bytes", added)

    def members(self) -> List[int]:
        with self._lock:
            return [m for m, per in self._ext.items()
                    if any(ivs for ivs in per.values())]

    def sink_refs(self, member: int) -> List["weakref.ref"]:
        with self._lock:
            return list(self._ext.get(member, {}))

    def pending_bytes(self, member: int) -> int:
        with self._lock:
            per = self._ext.get(member)
            if not per:
                return 0
            return sum(e - s for ivs in per.values() for s, e in ivs)

    def pending_extents(self, member: int) -> List[Tuple[int, int]]:
        """Snapshot of ``(file_off, length)`` owed by *member* (tests)."""
        with self._lock:
            per = self._ext.get(member, {})
            return sorted((s, e - s) for ivs in per.values()
                          for s, e in ivs)

    def take_extent(self, ref: "weakref.ref", member: int
                    ) -> Optional[Tuple[int, int]]:
        """Pop up to ``_RESYNC_CHUNK`` bytes of the first owed interval
        for replay; returns ``(file_off, length)`` or None when drained."""
        with self._lock:
            ivs = self._ext.get(member, {}).get(ref)
            if not ivs:
                return None
            s, e = ivs[0]
            take = min(e - s, _RESYNC_CHUNK)
            if s + take >= e:
                ivs.pop(0)
            else:
                ivs[0][0] = s + take
        stats.gauge_add("resync_pending_bytes", -take)
        return s, take

    def put_back(self, sink, member: int, file_off: int,
                 length: int) -> None:
        """Re-journal an extent whose replay failed (no debt leaks)."""
        self.record(sink, member, file_off, length)

    def drop_sink(self, ref: "weakref.ref") -> None:
        """Forget a sink's debt (its fds are gone; nothing to resync)."""
        self._drop_ref(ref)


@dataclass
class _Member:
    state: HealthState = HealthState.HEALTHY
    since: float = 0.0
    streak: int = 0              # consecutive direct-read failures
    until: float = 0.0           # quarantine expiry (monotonic)
    rejoin_ok: int = 0           # warmup successes accumulated
    tokens: float = 1.0          # rejoin token bucket level
    tokens_t: float = 0.0        # last refill timestamp
    hist: List[int] = field(default_factory=lambda: [0] * LAT_HIST_BUCKETS)
    hist_n: int = 0


class MemberHealthMachine:
    """Per-member health state machine with latency-driven suspicion,
    timed quarantine, fail-stop detection, and token-bucket rejoin.

    Thread-safe; one instance per :class:`engine.Session`.  Transitions
    are appended to a bounded log (:meth:`transitions`) and mirrored into
    the stats registry (``stats.member_state`` and the
    ``member_quarantine`` counters: entering QUARANTINED counts
    ``nr_member_quarantine`` and the member's ``quarantines``; leaving
    clears the live flag).
    """

    _LOG_MAX = 512

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._m: Dict[int, _Member] = {}
        self._log: List[Tuple[int, str, str, float]] = []
        # dirty-extent resync barrier: while attached, the
        # REJOINING->HEALTHY edge is refused and REJOINING routes away
        # until the member's journal is drained — a rejoined disk never
        # serves bytes it missed while degraded
        self._resync: Optional[DirtyExtentJournal] = None

    def attach_resync(self, journal: DirtyExtentJournal) -> None:
        self._resync = journal

    def _resync_pending(self, member: int) -> bool:
        j = self._resync
        return j is not None and j.pending_bytes(member) > 0

    # -- internals -------------------------------------------------------

    def _rec(self, member: int) -> _Member:
        rec = self._m.get(member)
        if rec is None:
            rec = _Member(since=self._clock())
            self._m[member] = rec
        return rec

    def _to(self, member: int, rec: _Member, new: HealthState,
            now: float) -> None:
        old = rec.state
        if old is new:
            return
        if len(self._log) < self._LOG_MAX:
            self._log.append((member, old.value, new.value, now))
        if new is HealthState.QUARANTINED:
            stats.member_quarantine(member, True)
        elif old is HealthState.QUARANTINED:
            stats.member_quarantine(member, False)
        if new is HealthState.FAILED:
            stats.add("nr_member_failed")
        if old is HealthState.REJOINING and new is HealthState.HEALTHY:
            stats.add("nr_member_rejoin")
        if new is HealthState.REJOINING:
            rec.rejoin_ok = 0
            rec.tokens = 1.0
            rec.tokens_t = now
        rec.state = new
        rec.since = now
        stats.member_state(member, new.value)
        if _trace.active:
            _trace.instant("health", member=member,
                           args={"from": old.value, "to": new.value})

    def _expire(self, member: int, rec: _Member, now: float) -> None:
        """QUARANTINED -> REJOINING once the hold lapses (a warmup, not a
        cliff back to healthy)."""
        if rec.state is HealthState.QUARANTINED and rec.until \
                and now >= rec.until:
            rec.streak = 0
            self._to(member, rec, HealthState.REJOINING, now)

    def _take_token(self, rec: _Member, now: float) -> bool:
        rate = float(config.get("rejoin_tokens_s"))
        if rate <= 0:
            return True
        cap = max(1.0, float(int(config.get("rejoin_successes"))))
        rec.tokens = min(cap, rec.tokens + (now - rec.tokens_t) * rate)
        rec.tokens_t = now
        if rec.tokens >= 1.0:
            rec.tokens -= 1.0
            return True
        return False

    # -- failure / success accounting -----------------------------------

    def record_failure(self, member: int, *, fatal: bool = False) -> bool:
        """Account one direct-read failure; ``fatal`` (a PERSISTENT
        error) drives the member straight to FAILED.  Returns True if
        this call moved the member off the direct path."""
        now = self._clock()
        with self._lock:
            rec = self._rec(member)
            self._expire(member, rec, now)
            if fatal:
                if rec.state is HealthState.FAILED:
                    return False
                rec.streak = 0
                self._to(member, rec, HealthState.FAILED, now)
                return True
            if rec.state in (HealthState.QUARANTINED, HealthState.FAILED):
                return False
            rec.streak += 1
            hold = float(config.get("quarantine_s"))
            if rec.state is HealthState.REJOINING:
                # warmup failure: back behind a fresh hold, no cliff retry
                rec.until = now + hold if hold > 0 else 0.0
                self._to(member, rec, HealthState.QUARANTINED, now)
                return True
            if rec.streak >= int(config.get("quarantine_after")) and hold > 0:
                rec.until = now + hold
                self._to(member, rec, HealthState.QUARANTINED, now)
                return True
        return False

    def record_success(self, member: int) -> None:
        now = self._clock()
        with self._lock:
            rec = self._m.get(member)
            if rec is None:
                return
            self._expire(member, rec, now)
            rec.streak = 0
            if rec.state in (HealthState.QUARANTINED, HealthState.FAILED):
                # a direct read got through anyway: begin warmup, counting
                # this success toward it
                self._to(member, rec, HealthState.REJOINING, now)
                rec.rejoin_ok = 1
            elif rec.state is HealthState.REJOINING:
                rec.rejoin_ok += 1
                if rec.rejoin_ok >= int(config.get("rejoin_successes")) \
                        and not self._resync_pending(member):
                    # resync completes before HEALTHY: warmup successes
                    # alone never clear a member that still owes extents
                    self._to(member, rec, HealthState.HEALTHY, now)

    def record_canary(self, member: int, ok: bool) -> None:
        """Account one background canary probe: success moves FAILED to
        REJOINING and advances a REJOINING warmup; failure sends a
        REJOINING member back behind a fresh quarantine hold."""
        stats.add("nr_canary_probe")
        if ok:
            self.record_success(member)
        else:
            now = self._clock()
            with self._lock:
                rec = self._m.get(member)
                if rec is not None and rec.state is HealthState.REJOINING:
                    hold = float(config.get("quarantine_s"))
                    rec.until = now + hold if hold > 0 else 0.0
                    rec.streak = 0
                    self._to(member, rec, HealthState.QUARANTINED, now)

    # -- latency-driven suspicion ---------------------------------------

    def observe_latency(self, member: int, ns: int) -> None:
        """Feed one direct-read service time into the member's log2-ns
        histogram; every ``_SUSPECT_EVERY`` samples re-evaluate the
        suspect predicate (p99 > ``suspect_ratio`` x the stripe median
        p99, lower-median across members with enough samples)."""
        b = min(max(int(ns), 1).bit_length() - 1, LAT_HIST_BUCKETS - 1)
        with self._lock:
            rec = self._rec(member)
            rec.hist[b] += 1
            rec.hist_n += 1
            if rec.hist_n >= _HIST_DECAY_AT:
                rec.hist = [v >> 1 for v in rec.hist]
                rec.hist_n = sum(rec.hist)
            if rec.hist_n % _SUSPECT_EVERY:
                return
            if rec.state not in (HealthState.HEALTHY, HealthState.SUSPECT):
                return
            p99s = {}
            for m, r in self._m.items():
                if r.hist_n >= _SUSPECT_MIN_SAMPLES:
                    p = hist_percentiles(r.hist, (0.99,))[0]
                    if p is not None:
                        p99s[m] = p
            mine = p99s.get(member)
            if mine is None or len(p99s) < 2:
                return
            med = sorted(p99s.values())[(len(p99s) - 1) // 2]
            if med <= 0:
                return
            ratio = float(config.get("suspect_ratio"))
            now = self._clock()
            if rec.state is HealthState.HEALTHY and mine > ratio * med:
                self._to(member, rec, HealthState.SUSPECT, now)
            elif rec.state is HealthState.SUSPECT \
                    and mine <= (ratio / 2.0) * med:
                self._to(member, rec, HealthState.HEALTHY, now)

    def observe_hist(self, member: int, deltas) -> None:
        """Fold a native per-member latency-histogram delta (the lane
        reaper's view) so suspect detection also covers the native path."""
        with self._lock:
            rec = self._rec(member)
            for i, v in enumerate(deltas[:LAT_HIST_BUCKETS]):
                rec.hist[i] += v
                rec.hist_n += v

    # -- routing queries -------------------------------------------------

    def allow_direct(self, member: int) -> bool:
        """May the engine issue a direct read against this member right
        now?  HEALTHY/SUSPECT: yes.  QUARANTINED/FAILED: no.  REJOINING:
        one warmup token per request."""
        now = self._clock()
        with self._lock:
            rec = self._m.get(member)
            if rec is None:
                return True
            self._expire(member, rec, now)
            if rec.state in (HealthState.HEALTHY, HealthState.SUSPECT):
                return True
            if rec.state is HealthState.REJOINING:
                # a rejoiner still owing resync extents serves nothing:
                # any direct read could return bytes it missed while
                # degraded (its mirror has the truth)
                if self._resync_pending(member):
                    return False
                return self._take_token(rec, now)
            return False

    def take_rejoin_token(self, member: int) -> bool:
        """Draw one warmup token for the resync replay (the same bucket
        client traffic draws from, so replay rides the rejoin budget).
        Non-REJOINING members are unthrottled."""
        now = self._clock()
        with self._lock:
            rec = self._m.get(member)
            if rec is None or rec.state is not HealthState.REJOINING:
                return True
            return self._take_token(rec, now)

    def quarantined(self, member: int) -> bool:
        """True when the member's extents must route away from the direct
        path (consumes a warmup token like :meth:`allow_direct`)."""
        return not self.allow_direct(member)

    def routes_away(self, member: int) -> bool:
        """True for QUARANTINED/FAILED — the native-path mirror-remap
        predicate (no token consumed, REJOINING serves native traffic)
        — and for a REJOINING member still owing resync extents (stale
        until the journal drains)."""
        now = self._clock()
        with self._lock:
            rec = self._m.get(member)
            if rec is None:
                return False
            self._expire(member, rec, now)
            if rec.state in (HealthState.QUARANTINED, HealthState.FAILED):
                return True
            return rec.state is HealthState.REJOINING \
                and self._resync_pending(member)

    def hedge_delay_s(self, member: int) -> Optional[float]:
        """Hedge latch for a chunk on *member*, or None when hedging is
        off.  ``fixed`` uses ``hedge_ms``; ``p99`` derives the latch from
        the member's own p99 with ``hedge_ms`` as the floor."""
        policy = str(config.get("hedge_policy"))
        if policy == "off":
            return None
        floor = float(config.get("hedge_ms")) / 1e3
        if policy == "fixed":
            return floor
        with self._lock:
            rec = self._m.get(member)
            p99 = None
            if rec is not None and rec.hist_n >= 16:
                p99 = hist_percentiles(rec.hist, (0.99,))[0]
        if not p99:
            return floor
        return max(p99 / 1e9, floor)

    # -- introspection ---------------------------------------------------

    def state(self, member: int) -> HealthState:
        with self._lock:
            rec = self._m.get(member)
            if rec is None:
                return HealthState.HEALTHY
            self._expire(member, rec, self._clock())
            return rec.state

    def time_in_state(self, member: int) -> float:
        with self._lock:
            rec = self._m.get(member)
            if rec is None:
                return 0.0
            return max(0.0, self._clock() - rec.since)

    def unhealthy_members(self) -> List[Tuple[int, str]]:
        """Members off plain HEALTHY, with their state names."""
        now = self._clock()
        out: List[Tuple[int, str]] = []
        with self._lock:
            for m, rec in self._m.items():
                self._expire(m, rec, now)
                if rec.state is not HealthState.HEALTHY:
                    out.append((m, rec.state.value))
        return out

    def canary_candidates(self) -> List[int]:
        """Members the background prober should touch: FAILED (detect
        recovery) and REJOINING (advance warmup without client traffic).
        QUARANTINED waits out its timer."""
        with self._lock:
            return [m for m, r in self._m.items()
                    if r.state in (HealthState.FAILED,
                                   HealthState.REJOINING)]

    def transitions(self, member: Optional[int] = None
                    ) -> List[Tuple[int, str, str, float]]:
        """Bounded transition log ``[(member, from, to, t_monotonic)]`` in
        order — the chaos harness asserts these walk ALLOWED_TRANSITIONS."""
        with self._lock:
            if member is None:
                return list(self._log)
            return [t for t in self._log if t[0] == member]


# the reference's earlier name, kept for its callers
MemberHealth = MemberHealthMachine
