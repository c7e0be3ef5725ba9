"""The cold-start gate: the JAX package's ``testing/coldstart_gate.py``.

Holds the weight streamer's contracts on a seeded synthetic checkpoint
read through a latency-bound fake source:

* **Speedup** — :func:`..serving.weights.stream_weights` (``depth``
  layers in flight: layer N+1's reads land while layer N is verified and
  handed out) must beat the naive cold start (read a layer, wait, hand it
  out, next layer: every serial loader's discipline, through the same
  landing) by at least ``--ratio`` (2×).  Both legs pay the same injected
  latency a request, so the ratio measures overlap, not I/O luck.
* **Identity** — every leaf the streamer lands equals the tree that was
  saved, with the crc check on.
* **Layer order** — the flight recorder's ``weight_stream`` spans retire
  in stream order (the ``layer`` arg increasing): many layers may be in
  flight, but they are handed out in order.
* **Refusal** — a flipped byte in a streamed leaf fails the manifest crc
  with EBADMSG before its layer is handed out.

The landing is the device's (``-d``, default ``cuda:0``; ``-d cpu`` runs
on the host): on a card both legs land through the streamer's pinned
slots and copy each layer to the card, the naive leg one layer at a time.
Everything is written to a temporary directory.

Usage: python -m nvme_strom_tpu_torch.testing.coldstart_gate [-d DEVICE]
       [--ratio R] [--rounds N] [--latency-ms MS]
"""

from __future__ import annotations

import argparse
import errno as _errno
import os
import statistics
import sys
import tempfile
import time

#: the JAX package's limits
RATIO_LIMIT = 2.0
ROUNDS = 3
LATENCY_MS = 4.0

__all__ = ["main", "RATIO_LIMIT", "ROUNDS", "LATENCY_MS"]

#: every layer is one 256 KiB span (one injected latency a read on both
#: legs at dma_max_size = the span)
_LAYER_BYTES = 256 << 10
_N_LAYERS = 12
_DEPTH = 4


def _make_checkpoint(dirpath: str):
    import numpy as np
    import torch

    from ..data.checkpoint import save_checkpoint

    rng = np.random.default_rng(11)
    n_el = _LAYER_BYTES // 4          # each leaf exactly one span
    tree = {"layers": [
        {"w": torch.from_numpy(rng.standard_normal(n_el).astype(np.float32))}
        for _ in range(_N_LAYERS)]}
    path = os.path.join(dirpath, "model.ckpt")
    save_checkpoint(path, tree)
    return path, tree


def _naive_coldstart(path: str, src, dev):
    """The serial baseline: read a layer, wait, hand it out, next layer,
    through the streamer's own landing at depth 1 with no crc check (a
    LandingBuffer a layer on the CPU; on a card one pinned slot, each
    layer's copy fenced before the next read).  Returns the layers, each
    with its registry handle."""
    from ..data.checkpoint import checkpoint_info
    from ..engine import Session
    from ..serving.weights import _grids, _plan_layers, _stream_layer_subset

    layers = _plan_layers(checkpoint_info(path))
    with Session(device=dev) as sess:
        _stream_layer_subset(path, layers, sess=sess, src=src, dev=dev,
                             verify=False, depth=1, grids=_grids(4096))
    return layers


def _check_tree(model, tree) -> None:
    import torch

    for i, layer in enumerate(tree["layers"]):
        key = f"['layers'][{i}]['w']"
        got = model.leaf(key).cpu()
        assert torch.equal(got, layer["w"]), \
            f"streamed leaf {key} diverged from the saved tree"


def _leg_speedup_identity_order(dirpath: str, dev, ratio_limit: float,
                                rounds: int, latency_s: float) -> float:
    """Returns the measured ratio."""
    from ..config import config
    from ..serving.weights import _unmap_layers, stream_weights
    from ..trace import recorder
    from .fake import FakeNvmeSource, FaultPlan

    path, tree = _make_checkpoint(dirpath)
    config.set("dma_max_size", _LAYER_BYTES)
    config.set("trace_policy", "all")
    recorder.configure()
    recorder.clear()
    naive_t, stream_t = [], []
    try:
        for _ in range(rounds):
            src = FakeNvmeSource(path, force_cached_fraction=0.0,
                                 fault_plan=FaultPlan(latency_s=latency_s))
            try:
                t0 = time.perf_counter()
                layers = _naive_coldstart(path, src, dev)
                naive_t.append(time.perf_counter() - t0)
                _unmap_layers(layers)
            finally:
                src.close()
            recorder.clear()    # the serial leg's spans are not counted
            src = FakeNvmeSource(path, force_cached_fraction=0.0,
                                 fault_plan=FaultPlan(latency_s=latency_s))
            try:
                t0 = time.perf_counter()
                model = stream_weights(path, source=src, device=dev,
                                       depth=_DEPTH)
                stream_t.append(time.perf_counter() - t0)
                try:
                    _check_tree(model, tree)
                finally:
                    model.close()
            finally:
                src.close()
            spans = [e for e in recorder.snapshot_events()
                     if e[2] == "weight_stream"]
            order = [e[8]["layer"] for e in sorted(spans,
                                                   key=lambda e: e[0])]
            assert order == list(range(_N_LAYERS)), \
                f"layers handed out out of order: {order}"
    finally:
        config.set("trace_policy", "off")
        recorder.configure()
        recorder.clear()
    n, s = statistics.median(naive_t), statistics.median(stream_t)
    ratio = n / s if s > 0 else float("inf")
    assert ratio >= ratio_limit, \
        f"streamed cold start only {ratio:.2f}x naive (limit " \
        f"{ratio_limit}x; naive {n * 1e3:.0f} ms, streamed {s * 1e3:.0f} ms)"
    print(f"coldstart-gate speedup leg ok: streamed {ratio:.2f}x naive "
          f"(naive {n * 1e3:.1f} ms, streamed {s * 1e3:.1f} ms, {rounds} "
          f"rounds at {latency_s * 1e3:.1f} ms a request, on {dev}), "
          f"layer order held by {rounds * _N_LAYERS} weight_stream spans")
    return ratio


def _leg_crc_refusal(dirpath: str, dev) -> None:
    from ..api import StromError
    from ..serving.weights import stream_weights

    path, _tree = _make_checkpoint(dirpath)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - _LAYER_BYTES // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    try:
        model = stream_weights(path, device=dev)
    except StromError as e:
        assert e.errno == _errno.EBADMSG, \
            f"corruption raised errno {e.errno}, want EBADMSG"
    else:
        model.close()
        raise AssertionError("a corrupted checkpoint streamed without a "
                             "crc refusal")
    print("coldstart-gate crc leg ok: a flipped byte refused with EBADMSG")


def main(argv=None) -> int:
    from ..api import StromError
    from ..config import config
    from ..hbm.backend import resolve_device

    ap = argparse.ArgumentParser(prog="coldstart_gate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", "--device", default=None,
                    help="where the layers land (default cuda:0; 'cpu' "
                         "runs on the host)")
    ap.add_argument("--ratio", type=float, default=RATIO_LIMIT,
                    help=f"least streamed / naive speedup (default "
                         f"{RATIO_LIMIT})")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"rounds of each leg; medians compared (default "
                         f"{ROUNDS})")
    ap.add_argument("--latency-ms", type=float, default=LATENCY_MS,
                    help=f"latency injected a request (default "
                         f"{LATENCY_MS})")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except StromError as e:
        print(f"coldstart-gate: {e}", file=sys.stderr)
        return 2
    snap = config.snapshot()
    try:
        with tempfile.TemporaryDirectory(prefix="strom_coldstart_") as d:
            _leg_speedup_identity_order(d, dev, args.ratio, args.rounds,
                                        args.latency_ms / 1e3)
            _leg_crc_refusal(d, dev)
    except AssertionError as e:
        print(f"coldstart-gate FAIL: {e}")
        return 1
    finally:
        config.restore(snap)
    print("coldstart-gate ok: the pipelined cold start beats the serial one, "
          "leaves byte-identical, layers land in order, corruption refused")
    return 0


if __name__ == "__main__":
    sys.exit(main())
