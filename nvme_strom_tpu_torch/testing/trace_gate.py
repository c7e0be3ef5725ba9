"""Trace-overhead gate: sampled tracing must ride within 3% of off.

The flight recorder's contract is near-zero cost when off (one attribute
test a site) and production-safe when sampling (``trace_policy=sampled``,
1% of tasks by default).  This gate holds the second half: it loads one
seeded file through ``ssd2gpu_test``'s path (:func:`..tools.ssd2gpu_test.
run_load`) under ``trace_policy=off`` and ``sampled`` in alternating order
(A/B/A/B: interleaving cancels drift that back-to-back blocks would alias
onto one arm) and fails when the sampled median GB/s drops more than
``--pct`` percent below off, or below the off arm's own spread when that
is wider (the measured noise).

Usage: python -m nvme_strom_tpu_torch.testing.trace_gate [--device cpu]
       [--mib 256] [--runs 3] [--pct 3]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile

import numpy as np

from ..config import config
from ..tools.ssd2gpu_test import run_load

__all__ = ["gate", "main"]


def _run_once(path: str, policy: str, device) -> float:
    """One timed load under *policy*; returns GB/s."""
    config.set("trace_policy", policy)
    out = run_load(path, device=device, drop_cache=True)
    return out["nbytes"] / out["seconds"] / 1e9


def gate(path: str, *, device=None, runs: int = 3,
         limit_pct: float = 3.0) -> dict:
    """Alternate off / sampled loads of *path*; returns the medians, the
    drop, the off arm's noise and the verdict (``ok``)."""
    saved = config.get("trace_policy")
    off, sampled = [], []
    try:
        for _ in range(runs):
            off.append(_run_once(path, "off", device))
            sampled.append(_run_once(path, "sampled", device))
    finally:
        config.set("trace_policy", saved)
    m_off, m_sampled = statistics.median(off), statistics.median(sampled)
    drop_pct = (1.0 - m_sampled / m_off) * 100.0 if m_off else 0.0
    noise_pct = (max(off) - min(off)) / m_off * 100.0 if m_off else 0.0
    return {"off": off, "sampled": sampled, "off_median": m_off,
            "sampled_median": m_sampled, "drop_pct": drop_pct,
            "noise_pct": noise_pct,
            "ok": drop_pct <= max(limit_pct, noise_pct)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trace_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="load destination (default cuda:0; 'cpu' runs "
                         "on the host)")
    ap.add_argument("--mib", type=int, default=256,
                    help="size of the seeded file (default 256 MiB)")
    ap.add_argument("--runs", type=int, default=3, help="loads per arm")
    ap.add_argument("--pct", type=float, default=3.0,
                    help="largest allowed drop of the sampled median")
    args = ap.parse_args(argv)
    fd, path = tempfile.mkstemp(prefix="trace_gate_", suffix=".bin")
    try:
        rng = np.random.default_rng(0)
        with os.fdopen(fd, "wb") as f:
            for _ in range(args.mib):
                f.write(rng.integers(0, 256, 1 << 20, dtype=np.uint8)
                        .tobytes())
        res = gate(path, device=args.device, runs=args.runs,
                   limit_pct=args.pct)
    finally:
        os.unlink(path)
    print(f"trace-gate {'ok' if res['ok'] else 'FAIL'}: off median "
          f"{res['off_median']:.3f} GB/s, sampled median "
          f"{res['sampled_median']:.3f} GB/s, drop {res['drop_pct']:+.2f}% "
          f"(limit {args.pct}%, off-arm noise {res['noise_pct']:.2f}%)")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
