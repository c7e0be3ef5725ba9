"""Time each phase of a phased script's run from its own output.

    python3 nvme_strom_tpu_torch/tools/phase_clock.py --json OUT.json \\
        [--log OUT.log] -- python3 chip_smoke.py

Runs the command unbuffered, passes its standard output through (and into
``--log``), and stamps each line on the monotonic clock.  A line that
starts with a phase tag (``[4] ...``, ``[20b] ...``, ``    [13] took ...``)
belongs to phase 4, 20 or 13; an untagged line to the phase before it.
Lines run in blocks of one phase; a block lasts from the last line of the
block before it to its own last line, and a phase's time is the sum of its
blocks.  So work a phase does after its last line is counted to the next
phase.  ``--json`` gets ``{"phases": {"N": seconds}, "order": [...],
"total_s": s, "rc": rc}``.  The exit code is the command's.

Needs nothing but the standard library, so it can time a checkout of an
earlier commit, which does not have it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

_TAG = re.compile(r"^\s*\[(\d+)")


def phase_times(stamped):
    """``[(t, line)]`` with *t* seconds from the start -> ``(phases,
    order)``: seconds a phase tag, and the tags in order of appearance."""
    phases, order = {}, []
    cur, block_start, last_t = None, 0.0, 0.0
    for t, line in stamped:
        m = _TAG.match(line)
        tag = m.group(1) if m else cur
        if tag != cur:
            if cur is not None:
                phases[cur] = phases.get(cur, 0.0) + last_t - block_start
            block_start, cur = last_t, tag
            if tag is not None and tag not in order:
                order.append(tag)
        last_t = t
    if cur is not None:
        phases[cur] = phases.get(cur, 0.0) + last_t - block_start
    return phases, order


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phase_clock", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", required=True, help="where the times go")
    ap.add_argument("--log", default=None, help="a copy of the output")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.monotonic()
    stamped = []
    log = open(args.log, "w") if args.log else None
    try:
        with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                              env=env) as proc:
            for line in proc.stdout:
                stamped.append((time.monotonic() - t0, line))
                sys.stdout.write(line)
                if log is not None:
                    log.write(line)
            rc = proc.wait()
    finally:
        if log is not None:
            log.close()
    total = time.monotonic() - t0
    phases, order = phase_times(stamped)
    with open(args.json, "w") as f:
        json.dump({"phases": phases, "order": order, "total_s": total,
                   "rc": rc, "command": cmd}, f, indent=1)
    print(f"phase_clock: {total:.1f} s, rc {rc}: " + ", ".join(
        f"[{k}] {phases[k]:.1f}" for k in order), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
