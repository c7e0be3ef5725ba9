"""The port's QoS gate (``testing/qos_gate.py``), both legs on the CPU:
3:1 DRR weights deliver 3:1 bytes within the gate's tolerance, and a
latency-class tenant's p95 queue wait stays bounded under a bulk-class
antagonist."""

import pytest

from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.testing import qos_gate

pytestmark = pytest.mark.daemon


@pytest.fixture(autouse=True)
def _port_config():
    snap = config.snapshot()
    config.set("trace_policy", "off")
    yield
    config.restore(snap)


def test_gate_defaults_are_the_jax_gates():
    from nvme_strom_tpu.testing import qos_gate as jgate
    assert (qos_gate.TARGET_RATIO, qos_gate.TOLERANCE) == (3.0, 0.25)
    assert (qos_gate.TARGET_RATIO, qos_gate.TOLERANCE,
            qos_gate.WAIT_P95_NS) == (jgate.TARGET_RATIO, jgate.TOLERANCE,
                                      jgate.WAIT_P95_NS)


def test_fairness_leg_on_the_cpu(tmp_path):
    ratio = qos_gate._leg_fairness(str(tmp_path))
    lo = qos_gate.TARGET_RATIO * (1 - qos_gate.TOLERANCE)
    hi = qos_gate.TARGET_RATIO * (1 + qos_gate.TOLERANCE)
    assert lo <= ratio <= hi


def test_latency_isolation_leg_on_the_cpu(tmp_path):
    p95 = qos_gate._leg_latency_isolation(str(tmp_path))
    assert p95 < qos_gate.WAIT_P95_NS


def test_gate_main_exits_zero():
    assert qos_gate.main() == 0
