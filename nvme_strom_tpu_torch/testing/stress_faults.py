"""Randomized fault-plan stress over the loopback fake: the JAX package's
``testing/stress_faults.py``.

Each round draws a :class:`.fake.FaultPlan` from a seeded RNG (transient
EIO, periodic and random, injected latency, and now and then a persistent
dead region), drives a multi-chunk ``memcpy_ssd2ram`` through it and
checks the recovery contract:

* a plan of transient faults only gives a byte-identical copy (the retry
  ladder and the buffered rung did their job);
* a plan with a dead region surfaces a latched ``StromError`` from
  ``memcpy_wait`` inside the task deadline: never a hang, never silent
  data loss.

Every fourth round is one mirrored flaky round of :mod:`.chaos`.  The
seed is fixed (``STROM_STRESS_SEED``, default 1234; ``STROM_STRESS_ROUNDS``
rounds, default 40), so a failure reproduces:
``python -m nvme_strom_tpu_torch.testing.stress_faults``.
"""

from __future__ import annotations

import os
import random
import sys
import tempfile
import time

CHUNK = 64 << 10
N_CHUNKS = 16


def _one_round(rng: random.Random, path: str, round_no: int) -> str:
    from ..api import StromError
    from ..config import config
    from ..engine import Session
    from .fake import FakeNvmeSource, FaultPlan, expected_bytes

    config.set("dma_max_size", CHUNK)       # one request a chunk
    config.set("task_deadline_s", 30.0)
    config.set("io_retries", rng.choice([1, 2, 3]))
    persistent = rng.random() < 0.25
    plan = FaultPlan(
        fail_every_nth=rng.choice([0, 2, 3, 5]),
        fail_rate=rng.choice([0.0, 0.05, 0.15]),
        seed=rng.randrange(1 << 30),
        latency_s=rng.choice([0.0, 0.0, 0.002]),
        fail_offsets={rng.randrange(N_CHUNKS) * CHUNK + 64}
        if persistent else set(),
    )
    src = FakeNvmeSource(path, fault_plan=plan, force_cached_fraction=0.0)
    try:
        with Session() as sess:
            handle, buf = sess.alloc_dma_buffer(N_CHUNKS * CHUNK)
            res = sess.memcpy_ssd2ram(src, handle, list(range(N_CHUNKS)),
                                      CHUNK)
            try:
                sess.memcpy_wait(res.dma_task_id, timeout=60.0)
            except StromError as e:
                if not persistent:
                    raise AssertionError(
                        f"round {round_no}: transient-only plan {plan!r} "
                        f"surfaced {e!r}") from e
                return "latched"
            if persistent:
                raise AssertionError(f"round {round_no}: persistent plan "
                                     f"{plan!r} completed without error")
            if bytes(buf.view()[:N_CHUNKS * CHUNK]) != \
                    expected_bytes(0, N_CHUNKS * CHUNK):
                raise AssertionError(f"round {round_no}: byte mismatch "
                                     f"under plan {plan!r}")
            return "healed"
    finally:
        src.close()


def main(argv=None) -> int:
    seed = int(os.environ.get("STROM_STRESS_SEED", "1234"))
    rounds = int(os.environ.get("STROM_STRESS_ROUNDS", "40"))
    rng = random.Random(seed)
    from ..config import config
    from .fake import make_test_file
    tally = {"healed": 0, "latched": 0, "mirrored": 0}
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stress.bin")
        make_test_file(path, N_CHUNKS * CHUNK)
        for i in range(rounds):
            snap = config.snapshot()
            try:
                if i % 4 == 3:
                    from .chaos import flaky_mirrored_round
                    flaky_mirrored_round(rng, d)
                    tally["mirrored"] += 1
                else:
                    tally[_one_round(rng, path, i)] += 1
            finally:
                config.restore(snap)
    from ..stats import stats
    snap = stats.snapshot()
    print(f"stress-faults OK: {rounds} rounds in "
          f"{time.monotonic() - t0:.1f}s (seed={seed}) — "
          f"{tally['healed']} healed, {tally['latched']} latched, "
          f"{tally['mirrored']} mirrored; "
          f"retries={snap.get('nr_io_retry', 0)} "
          f"fallbacks={snap.get('nr_io_fallback', 0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
