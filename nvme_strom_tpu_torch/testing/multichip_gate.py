"""The multichip gate: the JAX package's ``testing/multichip_gate.py``.

Holds the multi-host scale-out contracts over a ring of members with a
deterministic injected NVMe latency (:mod:`.fake`):

* **Aggregate scaling** — :func:`..parallel.shardload.load_pages_multihost`
  over 1, 2 and 4 hosts on a latency-bound synthetic must scale the
  aggregate GB/s by at least ``--ratio2`` (1.6×) at 2 hosts and
  ``--ratio4`` (2.8×) at 4.  Every page is one latency-bearing request
  (``dma_max_size`` = a page, coalescing off) serialized per session
  (``queue_depth`` = 1), so the wall is each host's submission window and
  the ratio measures the added hosts, not I/O luck.
* **Gathered identity** — the ``gather=True`` result (the cold-start
  shape: the ring all-gather, B4 on a card) equals the file's bytes on
  every member, at every host count.
* **Sharded cold start** — :func:`..serving.weights.stream_weights_sharded`
  at 2 hosts must take at most ``--cold-ratio`` (0.6) of the one-host
  wall at equal injected latency, and land a byte-identical model both
  ways.

The members are ``MEMBERS`` (8) × the device (``-d``, default
``cuda:0``; ``-d cpu`` runs on the host).  The gate prints its row as one
JSON line and writes nothing outside a temporary directory.

Usage: python -m nvme_strom_tpu_torch.testing.multichip_gate [-d DEVICE]
       [--ratio2 R] [--ratio4 R] [--cold-ratio R] [--rounds N]
       [--latency-ms MS] [--cold-latency-ms MS]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

#: the JAX package's limits and latencies
RATIO_2H = 1.6
RATIO_4H = 2.8
COLD_RATIO = 0.6
ROUNDS = 3
LATENCY_MS = 6.0
COLD_LATENCY_MS = 16.0
MEMBERS = 8

__all__ = ["main", "RATIO_2H", "RATIO_4H", "COLD_RATIO", "ROUNDS",
           "LATENCY_MS", "COLD_LATENCY_MS"]

#: 64 pages, one injected latency each: the one-host floor is 64 times
#: the latency, long against the run's fixed cost (the redistribution,
#: host staging), short enough for every check run
_N_PAGES = 64


def _fence(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leg_load_scaling(dirpath: str, dev, members: int, ratio2: float,
                      ratio4: float, rounds: int, latency_s: float) -> dict:
    import numpy as np
    import torch

    from ..config import config
    from ..engine import PlainSource
    from ..parallel.mesh import make_scan_mesh
    from ..parallel.shardload import load_pages_multihost
    from ..scan.heap import PAGE_SIZE
    from .fake import FakeNvmeSource, FaultPlan

    rng = np.random.default_rng(17)
    path = os.path.join(dirpath, "shards.dat")
    data = rng.integers(0, 256, _N_PAGES * PAGE_SIZE,
                        dtype=np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(data)
    # a page == a request == one injected latency, serialized per host
    # session: the wall is ceil(pages / hosts) latencies and the aggregate
    # ratio is the host count, what each host's own NVMe queues buy
    config.set("queue_depth", 1)
    config.set("dma_max_size", PAGE_SIZE)
    config.set("coalesce_limit", 0)
    mesh = make_scan_mesh([dev] * members)
    host_counts = [h for h in (1, 2, 4) if members % h == 0]
    want = torch.from_numpy(np.frombuffer(data, np.uint8).copy()
                            .reshape(_N_PAGES, PAGE_SIZE))

    def factory(_h: int):
        return FakeNvmeSource(path, fault_plan=FaultPlan(latency_s=latency_s),
                              force_cached_fraction=0.0)

    gbps = {}
    with PlainSource(path) as plan_src:
        for hosts in host_counts:
            # warm pass: the identity line, every member's replica
            out = load_pages_multihost(plan_src, mesh, hosts=hosts,
                                       source_factory=factory, gather=True)
            for i, rep in enumerate(out):
                assert torch.equal(rep.cpu(), want), \
                    f"hosts={hosts}: member {i}'s gathered bytes diverge " \
                    f"from the file"
            walls = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                load_pages_multihost(plan_src, mesh, hosts=hosts,
                                     source_factory=factory)
                _fence(dev)
                walls.append(time.perf_counter() - t0)
            gbps[hosts] = len(data) / statistics.median(walls) / 1e9
    r2 = gbps[2] / gbps[1] if 2 in gbps else None
    r4 = gbps[4] / gbps[1] if 4 in gbps else None
    if r2 is not None:
        assert r2 >= ratio2, \
            f"2-host aggregate only {r2:.2f}x one host (limit {ratio2}x; " \
            f"{gbps[1]:.4f} -> {gbps[2]:.4f} GB/s)"
    if r4 is not None:
        assert r4 >= ratio4, \
            f"4-host aggregate only {r4:.2f}x one host (limit {ratio4}x; " \
            f"{gbps[1]:.4f} -> {gbps[4]:.4f} GB/s)"
    print(f"multichip-gate load leg ok: aggregate "
          f"{' '.join(f'{h}h={g:.4f}GB/s' for h, g in sorted(gbps.items()))}"
          f" (2h {r2 or 0:.2f}x, 4h {r4 or 0:.2f}x; {rounds} rounds, "
          f"{_N_PAGES} pages at {latency_s * 1e3:.0f} ms a request, "
          f"{members} x {dev}), gathered bytes identical at every host "
          f"count")
    return {"gbps": {str(h): g for h, g in gbps.items()}, "ratio2": r2,
            "ratio4": r4, "pages": _N_PAGES, "lat_ms": latency_s * 1e3}


def _leg_sharded_coldstart(dirpath: str, dev, members: int,
                           cold_ratio: float, rounds: int,
                           latency_s: float) -> dict:
    from ..config import config
    from ..serving.weights import stream_weights_sharded
    from .coldstart_gate import _LAYER_BYTES, _check_tree, _make_checkpoint
    from .fake import FakeNvmeSource, FaultPlan

    path, tree = _make_checkpoint(dirpath)
    # one request (one latency) a layer on every host, depth 1: the
    # 2-host win is then shard parallelism, not pipelining (the cold-start
    # gate holds the pipelining line)
    config.set("dma_max_size", _LAYER_BYTES)
    devices = [dev] * members

    def factory(_h: int):
        return FakeNvmeSource(path, fault_plan=FaultPlan(latency_s=latency_s),
                              force_cached_fraction=0.0)

    walls = {}
    for hosts in (1, 2):
        # warm pass: byte identity on both host counts
        model = stream_weights_sharded(path, hosts=hosts,
                                       source_factory=factory, depth=1,
                                       devices=devices)
        try:
            _check_tree(model, tree)
        finally:
            model.close()
        ts = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            m = stream_weights_sharded(path, hosts=hosts,
                                       source_factory=factory, depth=1,
                                       devices=devices)
            ts.append(time.perf_counter() - t0)
            m.close()
        walls[hosts] = statistics.median(ts)
    ratio = walls[2] / walls[1] if walls[1] > 0 else float("inf")
    assert ratio <= cold_ratio, \
        f"2-host sharded cold start took {ratio:.2f}x the one-host wall " \
        f"(limit {cold_ratio}x; 1h {walls[1] * 1e3:.0f} ms, 2h " \
        f"{walls[2] * 1e3:.0f} ms)"
    print(f"multichip-gate coldstart leg ok: 2-host wall {ratio:.2f}x one "
          f"host (1h {walls[1] * 1e3:.0f} ms, 2h {walls[2] * 1e3:.0f} ms, "
          f"{rounds} rounds at {latency_s * 1e3:.0f} ms a layer), model "
          f"byte-identical both ways")
    return {"wall_1h_ms": walls[1] * 1e3, "wall_2h_ms": walls[2] * 1e3,
            "cold_ratio": ratio}


def main(argv=None) -> int:
    from ..api import StromError
    from ..config import config
    from ..hbm.backend import resolve_device

    ap = argparse.ArgumentParser(prog="multichip_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="the members' device (default cuda:0; 'cpu' runs "
                         "on the host)")
    ap.add_argument("--ratio2", type=float, default=RATIO_2H,
                    help=f"least 2-host aggregate speedup (default "
                         f"{RATIO_2H})")
    ap.add_argument("--ratio4", type=float, default=RATIO_4H,
                    help=f"least 4-host aggregate speedup (default "
                         f"{RATIO_4H})")
    ap.add_argument("--cold-ratio", type=float, default=COLD_RATIO,
                    help=f"most 2-host / 1-host cold-start wall (default "
                         f"{COLD_RATIO})")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"timed rounds a host count; medians compared "
                         f"(default {ROUNDS})")
    ap.add_argument("--latency-ms", type=float, default=LATENCY_MS,
                    help=f"latency injected a page request (default "
                         f"{LATENCY_MS})")
    ap.add_argument("--cold-latency-ms", type=float, default=COLD_LATENCY_MS,
                    help=f"latency injected a layer request (default "
                         f"{COLD_LATENCY_MS})")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"multichip-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    row = {"device": str(dev), "members": MEMBERS}
    try:
        with tempfile.TemporaryDirectory(prefix="strom_multichip_gate_") \
                as d:
            row.update(_leg_load_scaling(d, dev, MEMBERS, args.ratio2,
                                         args.ratio4, args.rounds,
                                         args.latency_ms / 1e3))
            config.restore(snap)
            row.update(_leg_sharded_coldstart(d, dev, MEMBERS,
                                              args.cold_ratio, args.rounds,
                                              args.cold_latency_ms / 1e3))
    except AssertionError as e:
        print(f"multichip-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
    print(json.dumps(row))
    print("multichip-gate ok: aggregate GB/s scales with hosts, gathered "
          "bytes identical, the sharded cold start beats one host")
    return 0


if __name__ == "__main__":
    sys.exit(main())
