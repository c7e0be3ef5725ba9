"""tests/test_train_loop.py on the PyTorch port: record file -> shuffled
ring-sharded DeviceLoader -> logistic-regression steps summing per-member
gradients -> direct checkpoint save -> replicated restore -> bit-identical
resume, against the JAX package's loop on the same records.

The port's loop is ``chip_smoke._train_loop``, the code phase [12c] runs on
the card (there on a ring of 4 x cuda:0, here on 8 x cpu)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nvme_strom_tpu.data import DeviceLoader, write_records
from nvme_strom_tpu.parallel.mesh import make_scan_mesh

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_loop(tmp_path, n=1024, d=31, batch=128, epochs=3):
    """The JAX package's loop of tests/test_train_loop.py, returning the
    per-epoch losses (the last batch's) and the final weights."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32)
    y = (x @ w_true > 0).astype(np.float32)
    ds = write_records(str(tmp_path / "jtrain.rec"),
                       np.concatenate([x, y[:, None]], axis=1))
    mesh = make_scan_mesh(jax.devices()[:8], sp=1)
    repl = NamedSharding(mesh, P())

    def loss_fn(w, b):
        xb, yb = b[:, :d], b[:, d]
        p = jax.nn.sigmoid(xb @ w)
        return -jnp.mean(yb * jnp.log(p + 1e-7)
                         + (1 - yb) * jnp.log(1 - p + 1e-7))

    @jax.jit
    def step(w, b):
        loss, g = jax.value_and_grad(loss_fn)(w, b)
        return w - 0.5 * g, loss

    w = jax.device_put(jnp.zeros(d, jnp.float32), repl)
    losses = []
    with DeviceLoader(ds, batch_records=batch, shuffle=42, mesh=mesh) as dl:
        for epoch in range(epochs):
            for b in dl.epoch(epoch):
                w, loss = step(w, b)
            losses.append(float(loss))
    return losses, np.asarray(w), x, y


def test_port_train_loop_equals_reference(tmp_path, smoke):
    """Per-epoch losses within 1e-4 relative and final weights within
    1e-4 * max|w| of the JAX package's (float32 sums in another order);
    the port's restore equal and its resume bit-identical (torch.equal)."""
    want_losses, want_w, x, y = _jax_loop(tmp_path)
    losses, w, restored, resumed = smoke._train_loop(torch, ["cpu"] * 8,
                                                     str(tmp_path))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert np.max(np.abs(w - want_w)) <= 1e-4 * np.max(np.abs(want_w))
    assert restored and resumed
    assert losses[-1] < losses[0]
    assert float(np.mean((x @ w > 0) == (y > 0))) > 0.9


@pytest.mark.parametrize("members", [1, 2, 4])
def test_port_train_loop_on_smaller_rings(tmp_path, smoke, members):
    """The ring's width changes only the order of the gradient sum: the
    losses stay within 1e-4 of the 8-member run, and the resume is
    bit-identical at every width."""
    (tmp_path / "ref").mkdir()
    ref, _, _, _ = smoke._train_loop(torch, ["cpu"] * 8,
                                     str(tmp_path / "ref"))
    losses, _, restored, resumed = smoke._train_loop(
        torch, ["cpu"] * members, str(tmp_path))
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    assert restored and resumed
