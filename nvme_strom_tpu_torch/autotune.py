"""The self-driving data path: a per-session online autotuner and
predictive readahead (the JAX package's ``autotune.py``).

* :class:`AutoTuner` — one controller a :class:`~.engine.Session`.  Each
  epoch (``autotune_interval_ms``) it reads the delivered-byte delta and
  the latency-histogram deltas (the worst member's p99, else the global
  histogram's), and a :class:`HillClimber` moves, a stripe member each,
  the submit window (also the member's python pool width), the request
  cap and the hedge delay, and on a window step up the native engine's
  lane count.  Every bound is the knob's own (:meth:`.config.Config.
  bounds`).  While the health machine holds a member off HEALTHY the
  controller freezes: it never fights the fault ladder.
* :class:`ReadaheadPredictor` — a source's access model in chunk units:
  a constant stride over the last three demand spans, else the last
  successor of the span's start.  The tuner issues each prediction as a
  speculative fill of the RAM tier through the fault ladder, under a
  :class:`~.daemon.qos.TokenBucket` of ``readahead_budget_mb_s``; the
  fills are tagged speculative, so the ARC's ghost lists never learn from
  a guess (:mod:`.cache`).

``autotune`` and ``readahead`` are read once, when the Session is built;
the engine's sites test plain attributes (``enabled``, ``ra_active``), so
with both off a site costs one branch and no thread starts.  The tuner
hosts the per-member :class:`~.engine.AdaptiveChunkSizer` dict and is the
one writer of the effective chunk cap (:meth:`AutoTuner.chunk_cap`); with
``autotune`` off that cap is the sizer's, as before.

Two differences from the JAX package: a prefetch lands in one pinned
buffer the tuner keeps for its life (grown as needed, released by
:meth:`AutoTuner.close`) instead of a buffer allocated and unmapped for
every prefetch (the bytes read, the fills and the counters are the same);
and a prediction larger than the budget's burst is cut to the chunks the
burst covers, where the JAX package issues it whole once its bucket is
full and so can prefetch past rate × elapsed + burst.
The port has no stats exporter to fold a native engine's counters before
each reading, so the tuner folds its own session's (the exporter's
pre-publish fold in the JAX package).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from .cache import residency_cache as _rcache
from .config import config
from .daemon.qos import TokenBucket
from .stats import hist_percentiles, stats
from .tiering import source_key
from .trace import recorder as _trace

__all__ = ["Reading", "KnobFamily", "HillClimber", "ReadaheadPredictor",
           "AutoTuner"]


class Reading:
    """One epoch's sensor deltas.

    ``throughput`` is delivered bytes per nanosecond of the epoch (only
    ratios between epochs matter), ``p99_ns`` the worst member p99 of the
    histogram deltas (the global histogram's when no member delta has
    mass), ``nreq`` the completed requests — 0 marks an idle epoch, to
    which the climber must not attribute a probe."""

    __slots__ = ("throughput", "p99_ns", "nreq")

    def __init__(self, throughput: float = 0.0,
                 p99_ns: Optional[int] = None, nreq: int = 0) -> None:
        self.throughput = float(throughput)
        self.p99_ns = p99_ns
        self.nreq = int(nreq)

    @property
    def idle(self) -> bool:
        return self.nreq <= 0


class KnobFamily:
    """One controlled knob across stripe members.

    Bounds are the knob's declared minval/maxval; steps are geometric (×2,
    ÷2) and clamp a member each, so members diverge only at the bounds.
    ``armed=False`` (the hedge delay under ``hedge_policy=off``) takes the
    family out of probing and keeps its state."""

    __slots__ = ("name", "lo", "hi", "integral", "armed", "values")

    def __init__(self, name: str, lo: float, hi: float, *,
                 integral: bool = True) -> None:
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.integral = bool(integral)
        self.armed = True
        self.values: Dict[int, float] = {}

    def _clamp(self, v: float) -> float:
        v = min(max(v, self.lo), self.hi)
        return float(int(v)) if self.integral else v

    def ensure(self, member: int, initial: float) -> None:
        if member not in self.values:
            self.values[member] = self._clamp(float(initial))

    def stepped(self, direction: str) -> Dict[int, float]:
        """``{member: new value}`` of one geometric step; empty when every
        member sits at the bound that way."""
        out: Dict[int, float] = {}
        for m, v in self.values.items():
            nv = self._clamp(v * 2.0 if direction == "up" else v / 2.0)
            if nv != v:
                out[m] = nv
        return out


class HillClimber:
    """The hill-climb policy alone: knob families and epoch readings in,
    step / revert / freeze decisions out (no session, so tests drive it
    with made-up readings).

    A decision takes two epochs: epoch N applies one geometric probe on
    one (family, direction); epoch N+1 holds the reading against the
    baseline before the probe.  A probe that gains at least ``min_gain``
    with p99 within ``p99_tol`` × the baseline's is kept and the climb
    goes on that way at once; otherwise it steps back and that (family,
    direction) is marked rejected at that value.

    The rejected marks are the hysteresis: a settled trajectory never
    probes again a direction it has measured at its operating point, so
    it cannot oscillate.  A kept step marks the opposite direction
    rejected (the climb came from there).  An idle epoch defers the
    evaluation; a freeze reverts the probe in flight and stops probing,
    and the rejected marks outlive it."""

    def __init__(self, families: List[KnobFamily], *,
                 min_gain: float = 0.05, p99_tol: float = 1.5,
                 cooldown: int = 4) -> None:
        self.families = list(families)
        self.min_gain = float(min_gain)
        self.p99_tol = float(p99_tol)
        self.cooldown = int(cooldown)
        #: each epoch's events: the knob trajectory the gate reads
        self.history: List[list] = []
        self._probe: Optional[tuple] = None  # (family, dir, {m: old})
        self._baseline: Optional[Reading] = None
        self._cooldown: Dict[Tuple[str, str], int] = {}
        self._rejected: Dict[Tuple[str, str], Dict[int, float]] = {}

    def family(self, name: str) -> Optional[KnobFamily]:
        for fam in self.families:
            if fam.name == name:
                return fam
        return None

    def step(self, reading: Reading, *, frozen: bool = False) -> List[tuple]:
        """One epoch: ``[(kind, family, direction, values)]``, *kind*
        step / revert / freeze (*values* ``{member: applied value}``,
        None for a freeze)."""
        events: List[tuple] = []
        for k in [k for k, v in self._cooldown.items() if v <= 1]:
            del self._cooldown[k]
        for k in self._cooldown:
            self._cooldown[k] -= 1
        if frozen:
            if self._probe is not None:
                fam, d, olds = self._probe
                fam.values.update(olds)
                self._probe = None
                events.append(("revert", fam.name, d, dict(olds)))
            self._baseline = None
            events.append(("freeze", None, None, None))
            self.history.append(events)
            return events
        if reading.idle:
            # no traffic: nothing to attribute a probe in flight to
            self.history.append(events)
            return events
        if self._probe is not None:
            events.extend(self._evaluate(reading))
        else:
            self._baseline = reading
            ev = self._try_probe()
            if ev is not None:
                events.append(ev)
        self.history.append(events)
        return events

    def _evaluate(self, reading: Reading) -> List[tuple]:
        fam, d, olds = self._probe
        self._probe = None
        base = self._baseline
        gain = (reading.throughput / base.throughput
                if base is not None and base.throughput > 0 else 0.0)
        p99_bad = bool(base is not None and base.p99_ns and reading.p99_ns
                       and reading.p99_ns > base.p99_ns * self.p99_tol)
        if gain >= 1.0 + self.min_gain and not p99_bad:
            # kept: the opposite direction is now measured worse
            opp = "down" if d == "up" else "up"
            self._rejected[(fam.name, opp)] = dict(fam.values)
            self._rejected.pop((fam.name, d), None)
            self._baseline = reading
            nxt = self._apply(fam, d)
            return [("step", fam.name, d, nxt)] if nxt else []
        fam.values.update(olds)
        self._rejected[(fam.name, d)] = dict(olds)
        self._cooldown[(fam.name, d)] = self.cooldown
        self._baseline = reading
        return [("revert", fam.name, d, dict(olds))]

    def _try_probe(self) -> Optional[tuple]:
        for fam in self.families:
            if not fam.armed or not fam.values:
                continue
            for d in ("up", "down"):
                key = (fam.name, d)
                if key in self._cooldown:
                    continue
                rej = self._rejected.get(key)
                if rej is not None and rej == fam.values:
                    continue
                nxt = self._apply(fam, d)
                if nxt:
                    return ("step", fam.name, d, nxt)
        return None

    def _apply(self, fam: KnobFamily, d: str) -> Optional[Dict[int, float]]:
        """One geometric step of *fam* as the probe in flight; None when
        every member sits at the bound."""
        olds = dict(fam.values)
        stepped = fam.stepped(d)
        if not stepped:
            return None
        fam.values.update(stepped)
        self._probe = (fam, d, olds)
        return dict(fam.values)


class ReadaheadPredictor:
    """Access model of one source, in chunk units.

    Three demand spans of equal stride and equal length predict the next;
    a walk that is not strided but repeats falls back to a successor
    table, the last span seen after each span's start."""

    __slots__ = ("_recent", "_succ")

    def __init__(self) -> None:
        self._recent: deque = deque(maxlen=8)   # (first_chunk, nchunks)
        self._succ: Dict[int, Tuple[int, int]] = {}

    def observe(self, first: int, nchunks: int) -> None:
        if self._recent:
            pf, _pn = self._recent[-1]
            if first != pf:
                self._succ[pf] = (int(first), int(nchunks))
                if len(self._succ) > 512:
                    self._succ.pop(next(iter(self._succ)))
        self._recent.append((int(first), int(nchunks)))

    def predict(self) -> Optional[Tuple[int, int]]:
        r = self._recent
        if len(r) >= 3:
            (f0, n0), (f1, n1), (f2, n2) = r[-3], r[-2], r[-1]
            s = f2 - f1
            if s != 0 and f1 - f0 == s and n0 == n1 == n2:
                return f2 + s, n2
        if r:
            return self._succ.get(r[-1][0])
        return None


class AutoTuner:
    """A Session's controller: sensors to knobs, and the readahead issue
    loop, on one thread (``strom-autotune``) when either half is on.

    The switches, the epoch and the budget are read once, at
    construction.  :meth:`step_epoch` is public, so the gate and the tests
    drive epochs synchronously (after :meth:`stop`)."""

    #: the token bucket's burst: this many seconds of budget may go out
    #: back to back before shaping bites (at least 1 MiB)
    BURST_S = 0.25
    #: the widest python member pool the window knob may drive (native
    #: lanes are capped at 16 separately)
    MAX_POOL_WIDTH = 64
    #: most chunks in one speculative fill
    MAX_PREFETCH_CHUNKS = 64

    def __init__(self, session) -> None:
        self._sess = session
        self.enabled = bool(config.get("autotune"))
        self.ra_active = bool(config.get("readahead"))
        self.active = self.enabled or self.ra_active
        self.interval_s = max(float(config.get("autotune_interval_ms")),
                              10.0) / 1e3
        #: the per-member AdaptiveChunkSizer dict, hosted here so the
        #: controller is the one writer of the effective chunk cap;
        #: Session._chunk_sizers is the same dict
        self.chunk_sizers: Dict[int, object] = {}
        self.freeze_reason = ""
        self.last_step = ""
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the applied knobs a member (the engine's sites read these)
        self._windows: Dict[int, int] = {}
        self._caps: Dict[int, int] = {}
        self._hedges: Dict[int, float] = {}
        self._last_sample: Optional[tuple] = None
        self._climber: Optional[HillClimber] = None
        if self.enabled:
            self._climber = self._make_climber()
        dlo, dhi = config.bounds("dma_max_size")
        self._dma_lo = int(dlo) if dlo else 4 << 10
        self._dma_hi = int(dhi) if dhi else 16 << 20
        # readahead: id(source) -> (weakref, predictor, chunk_size)
        self._predictors: Dict[int, tuple] = {}
        self._issued: deque = deque(maxlen=256)
        self._issued_set: set = set()
        self._ra_rate = float(config.get("readahead_budget_mb_s")) * (1 << 20)
        self._bucket = TokenBucket(
            self._ra_rate, max(self._ra_rate * self.BURST_S, 1 << 20))
        # the prefetch landing buffer: (handle, DmaBuffer), grown as needed
        self._ra_buf: Optional[tuple] = None
        self._ra_lock = threading.Lock()

    # -- the policy's knobs ---------------------------------------------

    @staticmethod
    def _make_climber() -> HillClimber:
        def bounds(name: str, lo: float, hi: float) -> Tuple[float, float]:
            vlo, vhi = config.bounds(name)
            return (lo if vlo is None else float(vlo),
                    hi if vhi is None else float(vhi))

        wlo, whi = bounds("submit_window", 1, 256)
        clo, chi = bounds("coalesce_limit", 0, 256 << 20)
        dlo, _dhi = bounds("dma_max_size", 4 << 10, 16 << 20)
        hlo, hhi = bounds("hedge_ms", 0.0, 60000.0)
        return HillClimber([
            KnobFamily("window", max(wlo, 1.0), whi),
            KnobFamily("cap", max(clo, dlo), chi),
            KnobFamily("hedge_ms", max(hlo, 1.0), hhi, integral=False),
        ])

    def _applied(self, fname: str) -> dict:
        return {"window": self._windows, "cap": self._caps,
                "hedge_ms": self._hedges}[fname]

    def _seed_members(self) -> None:
        """Arm the families for every member the stats have seen (member 0
        always) at the static values: the controller starts where the
        operator's config sits."""
        members = set(stats.member_snapshot()) | {0}
        init = {"window": float(max(int(config.get("submit_window")), 1)),
                "cap": float(int(config.get("dma_max_size"))),
                "hedge_ms": float(config.get("hedge_ms"))}
        for fam in self._climber.families:
            v0 = init[fam.name]
            for m in members:
                if m not in fam.values:
                    fam.ensure(m, v0)
                    self._applied(fam.name)[m] = int(fam.values[m]) \
                        if fam.integral else fam.values[m]
            if fam.name == "hedge_ms":
                # a knob with no effect is never probed: the hedge delay
                # under hedge_policy=off
                fam.armed = str(config.get("hedge_policy")) != "off"

    # -- sensors ----------------------------------------------------------

    def _read_sensors(self) -> Reading:
        """The epoch's deltas: delivered bytes, the global latency
        histogram and each member's (the worst member p99 is the
        regression signal; the global histogram covers the python pools,
        whose service times feed only it).  A native engine's counters
        are folded first."""
        sess = self._sess
        if sess._native is not None and not sess._closed:
            try:
                sess._fold_native_stats()
            except Exception:   # noqa: BLE001 - a sensor never kills tuning
                pass
        now = time.monotonic_ns()
        total = stats.snapshot().get("total_dma_length", 0)
        hist = stats.lat_hist_snapshot()
        mh = stats.member_hist_snapshot()
        last, self._last_sample = self._last_sample, (now, total, hist, mh)
        if last is None:
            return Reading(0.0, None, 0)
        dt = max(now - last[0], 1)
        dh = [a - b for a, b in zip(hist, last[2])]
        nreq = sum(dh)
        p99 = None
        for m, h in mh.items():
            prev = last[3].get(m)
            dm = [a - b for a, b in zip(h, prev)] if prev else list(h)
            if sum(dm):
                mp99 = hist_percentiles(dm, (0.99,))[0]
                if mp99 and (p99 is None or mp99 > p99):
                    p99 = mp99
        if p99 is None and nreq:
            p99 = hist_percentiles(dh, (0.99,))[0]
        return Reading((total - last[1]) / dt, p99, nreq)

    def _health_freeze(self) -> bool:
        """Any member off plain HEALTHY freezes the controller."""
        try:
            bad = self._sess._member_health.unhealthy_members()
        except Exception:   # noqa: BLE001 - a sensor never kills tuning
            bad = []
        if bad:
            m, state = bad[0]
            self.freeze_reason = f"member {m} {state}"
            return True
        self.freeze_reason = ""
        return False

    # -- the epoch ----------------------------------------------------------

    def step_epoch(self) -> None:
        """One epoch: read the sensors, run the climber, apply its moves,
        then one readahead issue pass.  The thread calls exactly this."""
        if self.enabled:
            self._tune_epoch()
        if self.ra_active:
            self.readahead_tick()

    def _tune_epoch(self) -> None:
        self._seed_members()
        reading = self._read_sensors()
        frozen = self._health_freeze()
        for kind, fname, direction, vals in \
                self._climber.step(reading, frozen=frozen):
            if kind == "freeze":
                stats.add("nr_autotune_freeze")
                if _trace.active:
                    _trace.instant("autotune_step",
                                   args={"dir": "freeze",
                                         "reason": self.freeze_reason})
                continue
            stats.add("nr_autotune_step" if kind == "step"
                      else "nr_autotune_revert")
            self.last_step = f"{fname}:{direction}" \
                + (" (revert)" if kind == "revert" else "")
            self._apply(fname, direction, vals, kind)
            if _trace.active:
                _trace.instant(
                    "autotune_step",
                    args={"knob": fname, "dir": direction, "kind": kind,
                          "values": {str(m): v for m, v in vals.items()}})
        self._publish_knobs()

    def _apply(self, fname: str, direction: str, vals: Dict[int, float],
               kind: str) -> None:
        applied = self._applied(fname)
        retire: List[int] = []
        for m, v in vals.items():
            nv = float(v) if fname == "hedge_ms" else int(v)
            if applied.get(m) != nv:
                applied[m] = nv
                if fname == "window":
                    retire.append(m)
        sess = self._sess
        for m in retire:
            # the member's pool comes back at the tuned width on its next
            # submit; queued work drains on the old one
            try:
                sess._retire_member_pool(m)
            except Exception:   # noqa: BLE001 - a knob never kills I/O
                pass
        if fname == "window" and kind == "step" and direction == "up" \
                and retire:
            # a native lane a unit of tuned concurrency, up to 16
            try:
                sess._autotune_scale_lanes(max(self._windows.values()))
            except Exception:   # noqa: BLE001
                pass

    def _publish_knobs(self) -> None:
        for m in self._windows:
            stats.member_knobs(m, window=self._windows.get(m),
                               cap=self._caps.get(m),
                               hedge_ms=self._hedges.get(m),
                               step=self.last_step,
                               freeze=self.freeze_reason)

    # -- the effective knobs (the engine's sites) ---------------------------

    def submit_window(self, default: int) -> int:
        """The planning slice's window (the largest member's: the slice is
        one a task, the pool widths one a member)."""
        w = self._windows
        return max(w.values()) if w else default

    def pool_width(self, member: int, default: int) -> int:
        """The tuned python pool width of *member* (its real concurrency),
        at most :attr:`MAX_POOL_WIDTH`."""
        if not self.enabled:
            return default
        v = self._windows.get(member)
        return default if v is None else max(1, min(int(v),
                                                    self.MAX_POOL_WIDTH))

    def dma_cap(self, default: int) -> int:
        """The planner's request cap: the largest tuned member cap, inside
        ``dma_max_size``'s bounds."""
        caps = self._caps
        if not caps:
            return default
        return max(self._dma_lo, min(max(caps.values()), self._dma_hi))

    def hedge_delay(self, member: int, base_s: float) -> float:
        """The tuned hedge delay of *member* in seconds; whether to hedge
        at all stays the health machine's call."""
        v = self._hedges.get(member)
        return base_s if v is None else max(float(v), 1.0) / 1e3

    def chunk_cap(self, floor: int, limit: int, member: int = 0) -> int:
        """The one writer of the effective chunk cap: the member's
        :class:`~.engine.AdaptiveChunkSizer` keeps its halve/restore rule
        and the tuner sets its ceiling.  With ``autotune`` off this is
        the sizer alone, as before."""
        if self.enabled:
            tuned = self._caps.get(member)
            if tuned is not None:
                limit = max(floor, int(tuned))
        szr = self.chunk_sizers.get(member)
        if szr is None or szr.floor != floor or szr.limit != limit:
            from .engine import AdaptiveChunkSizer
            szr = self.chunk_sizers[member] = AdaptiveChunkSizer(floor, limit)
        return szr.effective

    # -- predictive readahead -------------------------------------------------

    def observe_submit(self, source, chunk_size: int, chunk_ids) -> None:
        """Feed one demand span (the engine calls this only under
        ``readahead`` and never for a speculative task, so the predictor
        never learns from its own prefetches)."""
        sid = id(source)
        ent = self._predictors.get(sid)
        if ent is None or ent[0]() is not source or ent[2] != chunk_size:
            if len(self._predictors) >= 64:
                self._gc_predictors()
            try:
                ref = weakref.ref(source)
            except TypeError:
                return
            ent = (ref, ReadaheadPredictor(), int(chunk_size))
            self._predictors[sid] = ent
        ent[1].observe(min(chunk_ids), len(chunk_ids))

    def _gc_predictors(self) -> None:
        for sid in [s for s, e in self._predictors.items() if e[0]() is None]:
            del self._predictors[sid]

    def readahead_tick(self) -> None:
        """One issue pass: a prediction a source, less what is resident or
        already issued, filled through the fault ladder if the budget
        pays it now; one it cannot pay is skipped (counted), never waited
        for, so prefetch cannot starve demand reads."""
        if not self.ra_active or not _rcache.active:
            return
        now = time.monotonic()
        for sid, (wref, pred, cs) in list(self._predictors.items()):
            src = wref()
            if src is None:
                self._predictors.pop(sid, None)
                continue
            p = pred.predict()
            if p is None:
                continue
            first, n = p
            try:
                size = int(src.size)
            except Exception:   # noqa: BLE001 - the source may be closing
                continue
            total = (size + cs - 1) // cs
            if first < 0 or first >= total:
                continue
            n = max(1, min(int(n), total - first, self.MAX_PREFETCH_CHUNKS))
            key = (sid, first, n)
            if key in self._issued_set:
                continue
            skey = source_key(src)
            ids = [cid for cid in range(first, first + n)
                   if not _rcache.peek(skey, cid * cs,
                                       min(cs, size - cid * cs))]
            if not ids:
                self._remember(key)
                continue
            if self._ra_rate > 0:
                ids = self._within_burst(ids, cs, size)
            nbytes = sum(min(cs, size - cid * cs) for cid in ids)
            if not ids or self._ra_rate <= 0 \
                    or self._bucket.ready_in(nbytes, now) > 0:
                # out of budget (or budget 0: predict only): skip
                stats.add("nr_readahead_skip")
                continue
            self._bucket.consume(nbytes, now)
            self._remember(key)
            self._prefetch(src, ids, cs, nbytes)

    def _within_burst(self, ids: List[int], cs: int, size: int) -> List[int]:
        """The leading chunks of *ids* whose bytes the bucket's burst
        covers: a prediction is never larger than the burst, so the bytes
        prefetched stay within rate × elapsed + burst.  (The JAX package
        issues an oversized prediction whole once the bucket is full.)"""
        out, total = [], 0
        for cid in ids:
            total += min(cs, size - cid * cs)
            if total > self._bucket.burst:
                break
            out.append(cid)
        return out

    def _remember(self, key: tuple) -> None:
        if len(self._issued) == self._issued.maxlen:
            self._issued_set.discard(self._issued[0])
        self._issued.append(key)
        self._issued_set.add(key)

    def _landing(self, nbytes: int) -> int:
        """The handle of the prefetch buffer, at least *nbytes* long: one
        pinned host buffer for the tuner's life, never registered with
        the CUDA runtime (its bytes go to the RAM tier only)."""
        from .engine import DmaBuffer
        if self._ra_buf is not None and self._ra_buf[1].length >= nbytes:
            return self._ra_buf[0]
        self._release_landing()
        buf = DmaBuffer(nbytes)
        try:
            handle = self._sess.map_buffer(buf.view(), kind="pinned_host",
                                           backing=buf)
        except BaseException:
            buf.close()
            raise
        self._ra_buf = (handle, buf)
        return handle

    def _release_landing(self) -> None:
        ent, self._ra_buf = self._ra_buf, None
        if ent is not None:
            try:
                self._sess.unmap_buffer(ent[0])
            except Exception:   # noqa: BLE001 - the session may be closed
                pass
            ent[1].close()

    def _prefetch(self, src, ids: List[int], cs: int, nbytes: int) -> None:
        sess = self._sess
        t0 = time.monotonic_ns()
        with self._ra_lock:
            try:
                handle = self._landing(len(ids) * cs)
            except Exception:   # noqa: BLE001 - allocation pressure: skip
                stats.add("nr_readahead_skip")
                return
            try:
                res = sess.memcpy_ssd2ram(src, handle, ids, cs,
                                          speculative=True)
                sess.memcpy_wait(res.dma_task_id, timeout=60.0)
            except Exception:   # noqa: BLE001 - a prefetch never raises:
                return          # demand reads retry through the ladder
        stats.add("nr_readahead_fill")
        stats.add("bytes_readahead", nbytes)
        if _trace.active:
            _trace.span("readahead_fill", t0, time.monotonic_ns(),
                        offset=ids[0] * cs, length=nbytes,
                        args={"chunks": len(ids)})

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        """Start the controller thread (nothing with both halves off)."""
        if not self.active or self._thread is not None:
            return
        t = threading.Thread(target=self._loop, daemon=True,
                             name="strom-autotune")
        self._thread = t
        t.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step_epoch()
            except Exception:   # noqa: BLE001 - the controller never takes
                pass            # the data path down with it

    def stop(self) -> None:
        """Stop the thread (idempotent); :meth:`step_epoch` stays usable."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def close(self) -> None:
        """Stop the thread and release the prefetch buffer (the Session's
        close)."""
        self.stop()
        with self._ra_lock:
            self._release_landing()
