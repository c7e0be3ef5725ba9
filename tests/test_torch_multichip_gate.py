"""The port's multichip gate (``testing/multichip_gate.py``) on CPU
members, held to the JAX package's ``testing/multichip_gate.py``: its
limits, latencies and page count are the reference's, every leg runs, and
the module writes nothing in the repo.

The ratio legs measure a latency-bound load against what each request
costs besides its latency: thread hand-offs that wait for a core.  Beside
six parallel test workers on eight cores a 4-host run's requests wait
longer than a 1-host run's (a 4-host ratio of 2.49x at 50 ms a request
in one such run), so the load leg injects 120 ms a page request and the
cold-start leg 100 ms a layer (the module keeps the reference's 6 ms and
16 ms), with two timed rounds; the limits are the reference's 1.6x, 2.8x
and 0.6."""


import json
import os

import pytest
import torch

import nvme_strom_tpu.testing.multichip_gate as jgate
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.testing import multichip_gate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TEST_LAT_S, TEST_COLD_LAT_S, TEST_ROUNDS = 0.120, 0.100, 2


@pytest.fixture(autouse=True)
def _cfg():
    snap = config.snapshot()
    yield
    config.restore(snap)


def test_multichip_gate_limits_are_the_references():
    assert multichip_gate.RATIO_2H == jgate.RATIO_2H == 1.6
    assert multichip_gate.RATIO_4H == jgate.RATIO_4H == 2.8
    assert multichip_gate.COLD_RATIO == jgate.COLD_RATIO == 0.6
    assert multichip_gate.ROUNDS == jgate.ROUNDS
    assert multichip_gate.LATENCY_MS == jgate._LAT_S * 1e3
    assert multichip_gate.COLD_LATENCY_MS == jgate._COLD_LAT_S * 1e3
    assert multichip_gate._N_PAGES == jgate._N_PAGES


def test_multichip_gate_load_leg_on_the_cpu(tmp_path):
    """Scaling at 2 and 4 hosts over 8 members, and every member's
    gathered replica equal to the file at every host count."""
    row = multichip_gate._leg_load_scaling(
        str(tmp_path), CPU, 8, multichip_gate.RATIO_2H,
        multichip_gate.RATIO_4H, TEST_ROUNDS, TEST_LAT_S)
    assert row["ratio2"] >= 1.6 and row["ratio4"] >= 2.8
    assert set(row["gbps"]) == {"1", "2", "4"}


def test_multichip_gate_coldstart_leg_on_the_cpu(tmp_path):
    row = multichip_gate._leg_sharded_coldstart(
        str(tmp_path), CPU, 4, multichip_gate.COLD_RATIO, TEST_ROUNDS,
        TEST_COLD_LAT_S)
    assert row["cold_ratio"] <= 0.6


def test_multichip_gate_main_writes_nothing_in_the_repo(capsys, monkeypatch):
    """``main`` prints its row (one JSON line) and journals nothing; with
    no card and no ``-d`` it exits 2."""
    before = set(os.listdir(ROOT))
    monkeypatch.setattr(multichip_gate, "MEMBERS", 4)
    # the plumbing, not the ratios (the legs above hold those): one round
    # at a quarter of the load leg's page latency, under loose limits
    assert multichip_gate.main(
        ["-d", "cpu", "--rounds", "1",
         "--ratio2", "1.2", "--ratio4", "1.5", "--cold-ratio", "0.9",
         "--latency-ms", str(TEST_LAT_S * 1e3 / 4),
         "--cold-latency-ms", str(TEST_COLD_LAT_S * 1e3)]) == 0
    assert set(os.listdir(ROOT)) == before
    out = capsys.readouterr().out
    assert "multichip-gate ok" in out
    row = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    assert row["members"] == 4 and row["device"] == "cpu"
    if not torch.cuda.is_available():
        assert multichip_gate.main([]) == 2
