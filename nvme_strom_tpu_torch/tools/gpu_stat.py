"""gpu_stat — iostat-style monitor over the engine's STAT_INFO counters.

The port of the JAX package's ``tpu_stat`` (itself the reference's
``utils/nvme_stat.c``): a one-shot dump, or interval rows of per-stage
**average latencies** in adaptive units (ns → us → ms → s, `:28-50`),
the average DMA size, wrong wakeups and the current / peak in-flight DMA;
``-v`` adds the request-build and submit stages, the four debug pairs,
the fault ladder's actions, latency percentiles and queue occupancy, and
the per-member, per-shard and scoreboard lines (`:116-166`).

It reads the JSON snapshots that running processes export: every Session
publishes to a per-pid file under ``STROM_STAT_EXPORT_DIR`` (default
``/dev/shm``) unless ``STROM_STAT_EXPORT=0``, and ``ssd2gpu_test`` and
``strom_daemon`` to the well-known file (``STROM_TPU_STAT_EXPORT``).
``-l`` lists the sessions (stale ones flagged and pruned), ``-p PID``
attaches to one, and with no selector a sole live session is picked.
``--daemon SOCK`` asks a running ``strom_daemon`` for its per-tenant
scoreboard.  The tool touches no device.

Usage: python -m nvme_strom_tpu_torch.tools.gpu_stat [-v] [--json] [-l]
       [-p PID] [-f STAT_FILE] [--trace] [--daemon [SOCK]] [interval]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..stats import (bytes_touched_ratio, hist_percentiles, list_exports,
                     pid_export_path)

__all__ = ["main"]

#: the rungs of the port engine's ladder (``engine._RUNGS``): the values a
#: payload's ``backend`` takes
_BACKENDS = ("nvme_passthru", "io_uring", "threadpool", "python")


def show_avg(clk_ns: float, count: float) -> str:
    """Adaptive-unit average latency (reference show_avg8,
    nvme_stat.c:28-50)."""
    if count <= 0:
        return "   --  "
    avg = clk_ns / count
    if avg < 1_000:
        return f"{avg:5.0f}ns"
    if avg < 1_000_000:
        return f"{avg / 1_000:5.1f}us"
    if avg < 1_000_000_000:
        return f"{avg / 1_000_000:5.1f}ms"
    return f"{avg / 1e9:5.2f}s "


def _read(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _pshow(ns) -> str:
    """One latency percentile in adaptive units (None: no samples)."""
    return show_avg(ns, 1) if ns is not None else "   --  "


def _hist_delta(cur: dict, prev: dict):
    """The interval's delta of the log2-ns latency histogram (None when
    the newer snapshot has none)."""
    ch = cur.get("lat_hist") or []
    ph = prev.get("lat_hist") or []
    if not ch:
        return None
    ph = ph + [0] * (len(ch) - len(ph))
    return [a - b for a, b in zip(ch, ph)]


_warned_unpinned = False


def _warn_unpinned(c: dict) -> None:
    """Warn once a run when the RAM tier runs unpinned: mlock(2) was
    refused under RLIMIT_MEMLOCK, so its slabs can be swapped out and a
    hit can stall on a swap-in."""
    global _warned_unpinned
    if _warned_unpinned:
        return
    if c.get("nr_cache_mlock_fail") or c.get("cache_unpinned_bytes"):
        _warned_unpinned = True
        print(f"WARNING: residency cache running UNPINNED "
              f"(mlock failed {c.get('nr_cache_mlock_fail', 0)}x, "
              f"{c.get('cache_unpinned_bytes', 0) / 1048576:.1f}MB "
              f"swappable) — raise RLIMIT_MEMLOCK or set memlock_budget")


def _row(cur_snap: dict, prev_snap: dict, verbose: bool) -> str:
    cur = cur_snap.get("counters", {})
    prev = prev_snap.get("counters", {})
    d = {k: cur.get(k, 0) - prev.get(k, 0) for k in cur}
    g = cur     # gauges are point-in-time
    nsub = d.get("nr_submit_dma", 0)
    avg_sz = (d.get("total_dma_length", 0) / nsub / 1024) if nsub else 0
    cols = [
        show_avg(d.get("clk_ioctl_memcpy_submit", 0),
                 d.get("nr_ioctl_memcpy_submit", 0)),
        show_avg(d.get("clk_ioctl_memcpy_wait", 0),
                 d.get("nr_ioctl_memcpy_wait", 0)),
        show_avg(d.get("clk_ssd2dev", 0), d.get("nr_ssd2dev", 0)),
        f"{avg_sz:7.0f}K",
        f"{d.get('nr_wrong_wakeup', 0):6d}",
        f"{g.get('cur_dma_count', 0):5d}",
        f"{g.get('max_dma_count', 0):5d}",
    ]
    if verbose:
        cols += [
            show_avg(d.get("clk_setup_prps", 0), d.get("nr_setup_prps", 0)),
            show_avg(d.get("clk_submit_dma", 0), d.get("nr_submit_dma", 0)),
            f"{d.get('nr_enter_dma', 0):6d}",
            # the spare debug pairs: 1 the engine's continuations, 2 its
            # full-queue stalls, 3 the staging pipeline's H2D landings,
            # 4 requests on fixed buffers
            f"{d.get('nr_debug1', 0):6d}",
            f"{d.get('nr_debug2', 0):6d}",
            f"{d.get('nr_debug3', 0):6d}",
            f"{d.get('nr_debug4', 0):6d}",
            # the fault ladder's actions: a degrading device shows here
            # before it latches errors
            f"{d.get('nr_io_retry', 0):5d}",
            f"{d.get('nr_io_fallback', 0):6d}",
            f"{d.get('nr_task_timeout', 0):4d}",
            f"{d.get('nr_csum_fail', 0):5d}",
            f"{d.get('nr_member_quarantine', 0):5d}",
        ]
        # the interval's request-latency percentiles and the mean queue
        # depth while busy (near queue_depth: the window kept the queue
        # full; near 1: the pipeline drained between chunks)
        hd = _hist_delta(cur_snap, prev_snap)
        p50, p95, p99 = hist_percentiles(hd) if hd else (None, None, None)
        occ_b = d.get("occ_busy_ns", 0)
        occ = d.get("occ_integral_ns", 0) / occ_b if occ_b else 0.0
        cols += [_pshow(p50), _pshow(p95), _pshow(p99), f"{occ:5.1f}"]
    return " ".join(cols)


def _header(verbose: bool) -> str:
    cols = ["submit ", "wait   ", "dma-lat", " avg-sz", " wrong", "  cur",
            "  max"]
    if verbose:
        cols += ["plan   ", "sq-sub ", "enters", "resub ", "sqfull",
                 "h2d   ", "fixed ", "retry", "fallbk", " tmo", " csum",
                 "quar ", "p50    ", "p95    ", "p99    ", "  occ"]
    return " ".join(cols)


def _tenant_scoreboard(tenants: dict, prev: dict = None,
                       dt: float = 0.0) -> None:
    """The daemon's per-tenant QoS scoreboard: policy (class, weight,
    shape, quota) beside delivery (in flight, GB/s, rejects, throttles,
    queue wait p50/p95).  With *prev* and *dt* the GB/s column is the
    interval's rate; one-shot it is the lifetime GB."""
    if not tenants:
        print("no tenants attached")
        return
    print("tenant            class    wgt  shape-GB/s  quota(t/B)     "
          "infl(t/B)      deliv-GB/s  rej  thr  wait-p50 wait-p95")
    for name, t in sorted(tenants.items()):
        p50, p95 = hist_percentiles(t.get("wait_hist") or [0],
                                    qs=(0.50, 0.95))
        pbytes = (prev or {}).get(name, {}).get("bytes", 0)
        if prev is not None and dt > 0:
            gbs = (t.get("bytes", 0) - pbytes) / dt / (1 << 30)
        else:
            gbs = t.get("bytes", 0) / (1 << 30)
        rate = t.get("rate", 0.0)
        shape = f"{rate / (1 << 30):10.2f}" if rate else "  unshaped"
        qt, qb = t.get("quota_tasks", 0), t.get("quota_bytes", 0)
        quota = f"{qt or '-':>5}/{(qb >> 20) if qb else '-':>6}"
        infl = f"{t.get('inflight_tasks', 0):>4}/" \
               f"{t.get('inflight_bytes', 0) >> 20:>6}M"
        print(f"{name:<17} {t.get('class', '?'):<8} "
              f"{t.get('weight', 1.0):4.1f}  {shape}  {quota:>12}  "
              f"{infl:>12}  {gbs:10.2f}  "
              f"{t.get('rejects', 0):>3}  {t.get('throttles', 0):>3}  "
              f"{_pshow(p50)} {_pshow(p95)}")


def _daemon_view(args) -> int:
    """``--daemon [SOCK]``: with a socket, attach a monitor session and
    read the live scoreboard; with none, render the ``tenants`` table of
    the selected export."""
    if args.daemon:
        from ..daemon import DaemonSession
        with DaemonSession(args.daemon, tenant="_gpu_stat") as mon:
            st = mon.daemon_stat()
            print(f"stromd @ {args.daemon}: {st.get('sessions', 0)} "
                  f"session(s), queue depth {st.get('queue_depth', 0)}")
            if args.interval is None:
                _tenant_scoreboard(st.get("tenants", {}))
                return 0
            prev, t_prev = st.get("tenants", {}), time.monotonic()
            try:
                while True:
                    time.sleep(args.interval)
                    st = mon.daemon_stat()
                    now = time.monotonic()
                    print(f"-- depth {st.get('queue_depth', 0)}  "
                          f"sessions {st.get('sessions', 0)}")
                    _tenant_scoreboard(st.get("tenants", {}), prev,
                                       now - t_prev)
                    prev, t_prev = st.get("tenants", {}), now
            except KeyboardInterrupt:
                return 0
    snap = _read(args.file) if args.file else None
    if snap is None:
        print("no stats payload — give --daemon a socket path or select "
              "an export with -f/-p", file=sys.stderr)
        return 1
    print(f"pid {snap.get('pid')} tenants:")
    _tenant_scoreboard(snap.get("tenants", {}))
    return 0


def _list_sessions() -> int:
    """``-l``: every per-pid export with its liveness, age and headline
    counters; a stale one (its process gone) is pruned as it is shown."""
    rows = list_exports()
    if not rows:
        print("no exporting sessions found", file=sys.stderr)
        return 1
    print("   pid  state  age     reqs        bytes  file")
    for pid, path, alive in rows:
        snap = _read(path)
        if snap is None:
            print(f"{pid:>6}  unreadable {path}")
            continue
        try:
            # a payload's timestamp is CLOCK_MONOTONIC: the file's mtime
            # gives the wall age
            age = max(0.0, time.time() - os.stat(path).st_mtime)
        except OSError:
            age = 0.0
        c = snap.get("counters", {})
        state = "live " if alive else "stale"
        print(f"{pid:>6}  {state}  {age:5.1f}s "
              f"{c.get('nr_submit_dma', 0):>6} "
              f"{c.get('total_dma_length', 0):>12}  {path}")
        if not alive:
            try:        # another gpu_stat may race the unlink
                os.unlink(path)
                print(f"{'':6}  (pruned)")
            except OSError:
                pass
    return 0


def _scoreboards(c: dict) -> None:
    """``-v`` one-shot: a line for each layer that moved."""
    if (c.get("nr_hedge_issued") or c.get("nr_mirror_read")):
        print(f"hedges: issued {c.get('nr_hedge_issued', 0)}  "
              f"won {c.get('nr_hedge_won', 0)}  "
              f"cancelled {c.get('nr_hedge_cancelled', 0)}  "
              f"mirror-reads {c.get('nr_mirror_read', 0)}")
    if (c.get("nr_landing_direct") or c.get("nr_landing_staged")
            or c.get("nr_landing_fallback")):
        print(f"landing: direct {c.get('nr_landing_direct', 0)}  "
              f"staged {c.get('nr_landing_staged', 0)}  "
              f"fallback {c.get('nr_landing_fallback', 0)} "
              f"(align {c.get('nr_landing_fallback_alignment', 0)} "
              f"dtype {c.get('nr_landing_fallback_dtype', 0)} "
              f"backend {c.get('nr_landing_fallback_backend', 0)})")
    if (c.get("nr_cache_hit") or c.get("nr_cache_miss")
            or c.get("nr_cache_fill")):
        lookups = c.get("nr_cache_hit", 0) + c.get("nr_cache_miss", 0)
        hr = c.get("nr_cache_hit", 0) / lookups if lookups else 0.0
        print(f"cache: hit {c.get('nr_cache_hit', 0)}  "
              f"miss {c.get('nr_cache_miss', 0)}  "
              f"({hr:.0%} hit)  "
              f"fill {c.get('nr_cache_fill', 0)}  "
              f"evict {c.get('nr_cache_evict', 0)}  "
              f"invalidate {c.get('nr_cache_invalidate', 0)}  "
              f"resident "
              f"{c.get('cache_resident_bytes', 0) / 1048576:.1f}MB")
    if (c.get("nr_pushdown_decode_chip")
            or c.get("nr_pushdown_decode_host")
            or c.get("bytes_wire_saved")):
        print(f"pushdown: chip-decodes "
              f"{c.get('nr_pushdown_decode_chip', 0)}  "
              f"host-decodes "
              f"{c.get('nr_pushdown_decode_host', 0)}  "
              f"wire-saved "
              f"{c.get('bytes_wire_saved', 0) / 1048576:.1f}MB")
    # serving: the HBM tier's traffic, KV paging and the last cold
    # start's rate
    if (c.get("nr_hbm_hit") or c.get("nr_hbm_promote")
            or c.get("nr_kv_pagein") or c.get("nr_kv_pageout")
            or c.get("coldstart_bytes_per_sec")):
        print(f"serving: hbm-hit {c.get('nr_hbm_hit', 0)}  "
              f"promote {c.get('nr_hbm_promote', 0)}  "
              f"demote {c.get('nr_hbm_demote', 0)}  "
              f"resident "
              f"{c.get('hbm_resident_bytes', 0) / 1048576:.1f}MB  "
              f"kv-pagein {c.get('nr_kv_pagein', 0)}  "
              f"kv-pageout {c.get('nr_kv_pageout', 0)}  "
              f"coldstart "
              f"{c.get('coldstart_bytes_per_sec', 0) / 1048576:.0f}"
              f"MB/s")
    # the unified tiers: resident bytes a tier against promotion,
    # demotion, demand faults and memlock sheds
    if (c.get("nr_tier_hbm_promote") or c.get("nr_tier_hbm_demote")
            or c.get("nr_tier_ram_fault")
            or c.get("nr_tier_ram_demote")
            or c.get("nr_tier_ram_shed")):
        looks = (c.get("nr_hbm_hit", 0) + c.get("nr_cache_hit", 0)
                 + c.get("nr_cache_miss", 0))
        hbm_hr = c.get("nr_hbm_hit", 0) / looks if looks else 0.0
        ram_hr = c.get("nr_cache_hit", 0) / looks if looks else 0.0
        print(f"tiering: hbm "
              f"{c.get('hbm_resident_bytes', 0) / 1048576:.1f}MB "
              f"(hit {hbm_hr:.0%})  ram "
              f"{c.get('cache_resident_bytes', 0) / 1048576:.1f}MB "
              f"(hit {ram_hr:.0%})  "
              f"promote {c.get('nr_tier_hbm_promote', 0)}  "
              f"demote {c.get('nr_tier_hbm_demote', 0)}"
              f"+{c.get('nr_tier_ram_demote', 0)}  "
              f"fault {c.get('nr_tier_ram_fault', 0)}  "
              f"shed {c.get('nr_tier_ram_shed', 0)}")
    if (c.get("nr_shard_load") or c.get("nr_ici_permute")
            or c.get("nr_kv_migrate")
            or c.get("nr_kv_migrate_fail")):
        print(f"multihost: shard-loads {c.get('nr_shard_load', 0)}  "
              f"({c.get('bytes_shard_load', 0) / 1048576:.1f}MB)  "
              f"ici-permutes {c.get('nr_ici_permute', 0)}  "
              f"ici-bytes "
              f"{c.get('bytes_ici', 0) / 1048576:.1f}MB  "
              f"kv-migrate {c.get('nr_kv_migrate', 0)}  "
              f"fail {c.get('nr_kv_migrate_fail', 0)}")
    if (c.get("nr_autotune_step") or c.get("nr_autotune_revert")
            or c.get("nr_autotune_freeze")
            or c.get("nr_readahead_fill")
            or c.get("nr_readahead_skip")):
        print(f"autotune: steps {c.get('nr_autotune_step', 0)}  "
              f"reverts {c.get('nr_autotune_revert', 0)}  "
              f"freezes {c.get('nr_autotune_freeze', 0)}  "
              f"ra-fill {c.get('nr_readahead_fill', 0)}  "
              f"ra-hit {c.get('nr_readahead_hit', 0)}  "
              f"ra-skip {c.get('nr_readahead_skip', 0)}  "
              f"ra-bytes "
              f"{c.get('bytes_readahead', 0) / 1048576:.1f}MB")
    # the passthrough lane, and why the rung was refused when it was
    refusals = {k[len("nr_passthru_refusal_"):]: c[k]
                for k in c if k.startswith("nr_passthru_refusal_")
                and c[k]}
    if (c.get("nr_passthru_dma") or c.get("bytes_passthru")
            or c.get("nr_passthru_refused_extent")
            or c.get("nr_passthru_fallback") or refusals):
        why = ("  refused-rung " +
               ",".join(f"{k}:{v}" for k, v in sorted(
                   refusals.items()))) if refusals else ""
        print(f"passthru: cmds {c.get('nr_passthru_dma', 0)}  "
              f"bytes "
              f"{c.get('bytes_passthru', 0) / 1048576:.1f}MB  "
              f"refused-extents "
              f"{c.get('nr_passthru_refused_extent', 0)}  "
              f"lane-exits {c.get('nr_passthru_fallback', 0)}"
              f"{why}")
    if (c.get("nr_mirror_write") or c.get("nr_write_retry")
            or c.get("nr_resync_extent")
            or c.get("nr_write_verify_fail")
            or c.get("resync_pending_bytes")):
        print(f"writes: mirror {c.get('nr_mirror_write', 0)}  "
              f"retry {c.get('nr_write_retry', 0)}  "
              f"resync {c.get('nr_resync_extent', 0)}  "
              f"verify-fail {c.get('nr_write_verify_fail', 0)}  "
              f"resync-pending "
              f"{c.get('resync_pending_bytes', 0) / 1048576:.1f}MB")
    if (c.get("nr_integrity_verify") or c.get("nr_scrub_extent")
            or c.get("nr_pressure_shed")
            or c.get("nr_pressure_passthrough")):
        print(f"integrity: verify {c.get('nr_integrity_verify', 0)}  "
              f"fail {c.get('nr_integrity_fail', 0)}  "
              f"scrubbed "
              f"{c.get('bytes_scrubbed', 0) / 1048576:.1f}MB  "
              f"repair {c.get('nr_scrub_repair', 0)}  "
              f"scrub-fail {c.get('nr_scrub_fail', 0)}  "
              f"shed {c.get('nr_pressure_shed', 0)}  "
              f"passthrough {c.get('nr_pressure_passthrough', 0)}")
    _warn_unpinned(c)
    # every byte the pipeline touched over every byte delivered (1.0 is
    # the direct path's floor)
    ratio = bytes_touched_ratio(c)
    if ratio is not None:
        print(f"bytes touched/delivered: {ratio:.3f}  "
              f"(staging {c.get('bytes_staging_copy', 0)}  "
              f"verify {c.get('bytes_verify_reread', 0)}  "
              f"hedge-dup {c.get('bytes_hedge_dup', 0)})")


def _members(members: dict) -> None:
    """``-v`` one-shot: a row a stripe member (a slow one stands out by
    its average and p50 at similar request counts) and the autotune
    controller's knobs a member."""
    print("per-member:")
    print("  member   reqs        bytes   avg-lat  p50      p95    "
          "  occ  errs  retry  quar  state        in-state")
    for m, v in sorted(members.items(), key=lambda kv: int(kv[0])):
        occ_b = v.get("occ_busy_ns", 0)
        occ = (f"{v.get('occ_integral_ns', 0) / occ_b:5.1f}"
               if occ_b else "   --")
        st = v.get("state", "healthy")
        st_s = v.get("state_s")
        in_state = f"{st_s:8.1f}s" if st_s is not None else "       --"
        health = f"{v.get('errors', 0):>5} {v.get('retries', 0):>6} " \
                 f"{v.get('quarantines', 0):>5}  {st:<11} {in_state}" \
                 + ("  QUARANTINED" if v.get("quarantined") else "")
        print(f"  {int(m):>6} {v['nreq']:>6} {v['bytes']:>12} "
              f"  {show_avg(v['clk_ns'], v['nreq'])} "
              f"{_pshow(v.get('p50_ns'))} {_pshow(v.get('p95_ns'))} "
              f"{occ} {health}")
    knobs = {m: v for m, v in members.items()
             if v.get("knob_window") is not None}
    if knobs:
        print("autotune knobs:")
        print("  member  window   cap        hedge-ms  last-step")
        for m, v in sorted(knobs.items(), key=lambda kv: int(kv[0])):
            hedge = v.get("knob_hedge_ms")
            print(f"  {int(m):>6} {int(v['knob_window']):>7} "
                  f"{int(v.get('knob_cap', 0)):>10} "
                  f"{hedge if hedge is not None else '--':>9} "
                  f" {v.get('knob_step') or '--'}")
        reasons = {v.get("knob_freeze") for v in knobs.values()
                   if v.get("knob_freeze")}
        for r in sorted(reasons):
            print(f"  FROZEN: {r}")


def _one_shot(snap: dict, verbose: bool) -> None:
    c = snap["counters"]
    backend = snap.get("backend") or "?"
    print(f"pid {snap['pid']}  version {snap['version']}  "
          f"backend {backend}")
    width = max(len(k) for k in c)
    for k in sorted(c):
        print(f"  {k:<{width}} {c[k]}")
    if verbose:
        hist = snap.get("lat_hist") or []
        if any(hist):
            p50, p95, p99 = hist_percentiles(hist)
            print(f"latency: p50 {_pshow(p50).strip()}  "
                  f"p95 {_pshow(p95).strip()}  "
                  f"p99 {_pshow(p99).strip()}")
        occ_b = c.get("occ_busy_ns", 0)
        if occ_b:
            print(f"mean queue occupancy (busy): "
                  f"{c.get('occ_integral_ns', 0) / occ_b:.2f}")
        _scoreboards(c)
    if verbose and snap.get("members"):
        _members(snap["members"])
    if verbose and snap.get("shards"):
        # a shard whose p95 sits far above its siblings' at similar
        # counts is the straggling host or SSD
        print("per-shard wait:")
        print("  shard   waits  p50      p95")
        for s, v in sorted(snap["shards"].items(),
                           key=lambda kv: int(kv[0])):
            print(f"  {int(s):>5} {v.get('n', 0):>7} "
                  f"{_pshow(v.get('p50_ns'))} {_pshow(v.get('p95_ns'))}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gpu_stat", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("interval", nargs="?", type=float, default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-f", "--file", default=None,
                    help="stat export file to watch")
    ap.add_argument("-l", "--list", action="store_true",
                    help="list exporting sessions (per-pid files), "
                         "pruning stale ones")
    ap.add_argument("-p", "--pid", type=int, default=None,
                    help="attach to a session by pid (its per-pid "
                         "export file)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="one-shot machine-readable snapshot (counters + "
                         "per-member breakdown) for scripts/monitoring")
    ap.add_argument("--trace", action="store_true", dest="trace",
                    help="list flight-recorder dumps (newest first) with "
                         "a per-file summary; open them with strom_trace "
                         "or Perfetto")
    ap.add_argument("--daemon", nargs="?", const="", default=None,
                    metavar="SOCK",
                    help="per-tenant stromd scoreboard: with SOCK attach "
                         "to the live daemon, without it render the "
                         "tenants table of the selected export (-f/-p)")
    args = ap.parse_args(argv)
    from ..stats import DEFAULT_STAT_EXPORT     # read when the tool runs
    if args.trace:
        from .strom_trace import list_cmd
        return list_cmd()
    if args.as_json and args.interval is not None:
        ap.error("--json is one-shot; drop the interval")
    if args.list:
        if args.file or args.pid or args.interval is not None:
            ap.error("-l lists sessions; drop the other selectors")
        return _list_sessions()
    if args.daemon:
        return _daemon_view(args)    # a socket: no export file needed
    if args.file and args.pid is not None:
        ap.error("-f and -p are exclusive selectors")
    if args.pid is not None:
        args.file = pid_export_path(args.pid)
    elif args.file is None:
        # no selector: the well-known file while a tool writes it (fresh),
        # else a sole live per-pid session; a stale well-known file from
        # a long-gone tool must not shadow a live workload
        args.file = DEFAULT_STAT_EXPORT
        fresh = False
        try:
            fresh = (time.time() - os.stat(args.file).st_mtime) < 5.0
        except OSError:
            pass
        if not fresh or _read(args.file) is None:
            live = [(p, f) for p, f, alive in list_exports() if alive]
            if len(live) == 1:
                args.file = live[0][1]
                print(f"watching pid {live[0][0]} ({args.file})",
                      file=sys.stderr)
            elif live:
                print("several live sessions — pick one:",
                      file=sys.stderr)
                _list_sessions()
                return 1

    if args.daemon is not None:
        return _daemon_view(args)    # no socket: the export's tenants

    snap = _read(args.file)
    if snap is None:
        print(f"no stats at {args.file} — is a tool/session running with "
              f"stats export on? (`gpu_stat -l` lists sessions)",
              file=sys.stderr)
        return 1

    if args.as_json:
        print(json.dumps(snap))
        return 0

    if args.interval is None:
        _one_shot(snap, args.verbose)
        return 0

    prev = snap
    n = 0
    try:
        while True:
            time.sleep(args.interval)
            snap = _read(args.file)
            if snap is None:
                continue
            if n % 20 == 0:
                print(_header(args.verbose), flush=True)
            print(_row(snap, prev, args.verbose), flush=True)
            if args.verbose:
                _warn_unpinned(snap.get("counters", {}))
            prev = snap
            n += 1
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
