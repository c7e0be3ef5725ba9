"""strom_daemon — run stromd, the shared serving daemon, in the foreground.

A port of the JAX package's ``tools/strom_daemon.py``.  One stromd owns
one engine Session (lanes, buffers, cache tier); every job on the host
attaches to its Unix socket instead of building a private engine, and the
daemon arbitrates — admission control, per-tenant quotas and the QoS
scheduler — as the reference's kernel module arbitrates every process's
ioctls through ``/proc/nvme-strom``.

Usage: python -m nvme_strom_tpu_torch.tools.strom_daemon [--socket PATH]
           [--max-sessions N] [--dispatch N] [--quota-tasks N]
           [--quota-bytes SZ] [--device DEV] [--hbm-tier SZ]
           [--allow-fake]

Runs until SIGINT/SIGTERM; sessions still attached at shutdown are reaped
(buffers revoked, sources closed) before it exits.  A client lands the
daemon's DMA into CUDA memory with ``ssd2gpu_test --daemon SOCK``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..config import config, parse_size
from ..stats import stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="strom_daemon", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--socket", default=None,
                    help="listen path (default: config daemon_socket, else "
                         "the per-uid temp-dir path)")
    ap.add_argument("--max-sessions", type=int, default=None,
                    help="attached-session ceiling (default config; "
                         "0 = unlimited)")
    ap.add_argument("--dispatch", type=int, default=None,
                    help="dispatcher threads (default config daemon_dispatch)")
    ap.add_argument("--quota-tasks", type=int, default=None,
                    help="per-tenant in-flight task quota (0 = unlimited)")
    ap.add_argument("--quota-bytes", type=parse_size, default=None,
                    help="per-tenant in-flight byte quota, e.g. 256m")
    ap.add_argument("--device", default=None,
                    help="device of the HBM tier and of a shared KV pool's "
                         "HBM blocks (default cuda:0 at first use; 'cpu' "
                         "for a host-only daemon)")
    ap.add_argument("--hbm-tier", type=parse_size, default=None,
                    help="capacity of the HBM tier on --device (config "
                         "tier_hbm_bytes; a shared KV pool's HBM blocks "
                         "live there), e.g. 256m")
    ap.add_argument("--allow-fake", action="store_true",
                    help="accept FakeNvmeSource specs (tests and gates ONLY)")
    args = ap.parse_args(argv)

    if args.quota_tasks is not None:
        config.set("daemon_quota_tasks", args.quota_tasks)
    if args.quota_bytes is not None:
        config.set("daemon_quota_bytes", args.quota_bytes)
    if args.hbm_tier is not None:
        config.set("tier_hbm_bytes", args.hbm_tier)

    from ..daemon.server import StromDaemon
    # its counters and the tenants' scoreboard go to the well-known file
    # for `gpu_stat` (`gpu_stat --daemon SOCK` asks the socket instead);
    # started before the daemon's Session, whose own per-pid export would
    # otherwise hold the one exporter
    stats.start_export()
    try:
        daemon = StromDaemon(args.socket, allow_fake=args.allow_fake,
                             max_sessions=args.max_sessions,
                             dispatchers=args.dispatch, device=args.device)
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        daemon.start()
        print(f"stromd listening on {daemon.socket_path}  "
              f"(max sessions {daemon._max_sessions or 'unlimited'}, "
              f"quotas {config.get('daemon_quota_tasks') or '-'} tasks / "
              f"{config.get('daemon_quota_bytes') or '-'} bytes per "
              f"tenant)", flush=True)
        try:
            stop.wait()
        finally:
            print("stromd shutting down "
                  f"({daemon.session_count()} session(s) to reap)",
                  flush=True)
            daemon.close()
    finally:
        stats.stop_export()
    return 0


def cli() -> int:
    from ..api import StromError
    try:
        return main()
    except (StromError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(cli())
