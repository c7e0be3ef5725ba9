"""strom_trace — inspect, validate and convert flight-recorder dumps.

The engine's flight recorder (:mod:`nvme_strom_tpu_torch.trace`) writes
Chrome trace-event JSON: load a dump straight into Perfetto or
``chrome://tracing`` — one track per stripe member and per lane, flow
arrows from task submit to device landing.  This tool is the terminal-side
companion:

  strom_trace -l                 list dumps in the trace dir (newest first)
  strom_trace PATH               summarize one dump (tracks, spans, window)
  strom_trace --last             summarize the newest dump
  strom_trace --check PATH       validate trace-event schema (exit 1 on bad)
  strom_trace --prom [STATFILE]  render a stats payload (JSON of
                                 ``stats.export_payload()``; default the
                                 sole live export, else the well-known
                                 file) as a Prometheus textfile
  strom_trace -o OUT PATH        copy a dump after validating it

Dumps land in config ``trace_dir`` (default: the temporary directory) on
demand (``recorder.dump()``) and on task failure, with ``trace_policy``
``sampled`` or ``all``.

Usage: python -m nvme_strom_tpu_torch.tools.strom_trace [-l | --last |
       --check | --prom | -o OUT] [-d DIR] [PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import Optional

from ..trace import (list_dumps, render_prometheus, summarize_chrome_trace,
                     trace_dir, validate_chrome_trace)

__all__ = ["main"]


def _load(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"strom_trace: cannot read {path}: {e}", file=sys.stderr)
        return None


def list_cmd(directory=None) -> int:
    """List dumps newest first with a one-line summary each."""
    dumps = list_dumps(directory)
    if not dumps:
        print(f"no trace dumps under {directory or trace_dir()}: enable "
              f"tracing (trace_policy=sampled|all) and dump with "
              f"recorder.dump(), or trigger a failure", file=sys.stderr)
        return 1
    for path in reversed(dumps):
        try:
            age = max(0.0, time.time() - os.stat(path).st_mtime)
        except OSError:
            continue
        doc = _load(path)
        if doc is None:
            continue
        n = len(doc.get("traceEvents", []))
        reason = (doc.get("otherData") or {}).get("reason", "?")
        print(f"{age:7.1f}s  {n:>6} events  {reason:<24} {path}")
    return 0


def summarize_cmd(path: str) -> int:
    doc = _load(path)
    if doc is None:
        return 1
    errs = validate_chrome_trace(doc)
    if errs:
        print(f"{path}: INVALID ({len(errs)} schema error(s)); "
              f"run --check for details", file=sys.stderr)
    print(f"{path}:")
    print(summarize_chrome_trace(doc))
    return 0


def check_cmd(path: str) -> int:
    doc = _load(path)
    if doc is None:
        return 1
    errs = validate_chrome_trace(doc)
    if errs:
        for e in errs[:50]:
            print(f"{path}: {e}")
        if len(errs) > 50:
            print(f"{path}: ... {len(errs) - 50} more")
        return 1
    print(f"{path}: OK ({len(doc.get('traceEvents', []))} events)")
    return 0


def prom_cmd(stat_file: Optional[str] = None) -> int:
    """Render a stats payload as a Prometheus textfile on stdout; with no
    file, the sole live per-pid export, else the well-known file."""
    from ..stats import DEFAULT_STAT_EXPORT, list_exports
    if stat_file is None:
        live = [path for _pid, path, alive in list_exports() if alive]
        if len(live) == 1:
            stat_file = live[0]
        elif os.path.exists(DEFAULT_STAT_EXPORT):
            stat_file = DEFAULT_STAT_EXPORT
        else:
            print("no live stats export found; pass the snapshot file "
                  "(gpu_stat --json > snap.json)", file=sys.stderr)
            return 1
    try:
        with open(stat_file) as f:
            snap = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"strom_trace: cannot read stats {stat_file}: {e}",
              file=sys.stderr)
        return 1
    sys.stdout.write(render_prometheus(snap))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="strom_trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", nargs="?", default=None,
                    help="trace dump to summarize (with --prom: the stats "
                         "payload file)")
    ap.add_argument("-l", "--list", action="store_true",
                    help="list dumps in the trace dir, newest first")
    ap.add_argument("--last", action="store_true",
                    help="summarize the newest dump")
    ap.add_argument("--check", action="store_true",
                    help="validate trace-event schema; exit 1 when invalid")
    ap.add_argument("--prom", action="store_true",
                    help="render a stats payload file (default: the sole "
                         "live export, else the well-known file) as a "
                         "Prometheus textfile")
    ap.add_argument("-d", "--dir", default=None,
                    help="trace dir override (default: config trace_dir)")
    ap.add_argument("-o", "--out", default=None,
                    help="validate then copy the dump to OUT")
    args = ap.parse_args(argv)

    if args.list:
        return list_cmd(args.dir)
    if args.prom:
        return prom_cmd(args.path)

    path = args.path
    if args.last or path is None:
        dumps = list_dumps(args.dir)
        if not dumps:
            print(f"no trace dumps under {args.dir or trace_dir()}",
                  file=sys.stderr)
            return 1
        path = dumps[-1]

    if args.out:
        rc = check_cmd(path)
        if rc:
            return rc
        shutil.copyfile(path, args.out)
        print(f"copied -> {args.out}")
        return 0
    if args.check:
        return check_cmd(path)
    return summarize_cmd(path)


if __name__ == "__main__":
    sys.exit(main())
