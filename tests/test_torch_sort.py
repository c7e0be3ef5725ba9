"""The port's distributed sample sort (``parallel/sort.py``) and bucket
exchange (``parallel/exchange.py``) against the JAX package's on the
conftest's virtual CPU devices.  Every test of ``tests/test_sort.py`` is
held here (the numpy oracle and the JAX run both), with the exchange tests
of ``tests/test_scan_ops.py`` (:331, :364, :380), and hypothesis sweeps
random keys, skew, valid masks and capacities that drop.  The port's
members are N × ``"cpu"``.

Tolerance: none.  Splitters are not exposed, but values, payloads, bucket
counts, drops and padded rows are compared bit for bit (floats as their
bits), which they fix."""

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from nvme_strom_tpu.parallel import exchange as jexchange
from nvme_strom_tpu.parallel import sort as jsort
from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jax_mesh
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.parallel.exchange import make_bucket_exchange
from nvme_strom_tpu_torch.parallel.mesh import make_scan_mesh
from nvme_strom_tpu_torch.parallel.sort import (distributed_sort_u64,
                                                make_distributed_distinct,
                                                make_distributed_sort)

DEVS = ["cpu"] * 8


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.uint32:
            return t.view(torch.int32).numpy().view(np.uint32)
        return t.numpy()
    return np.asarray(t)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _collect(out):
    vals, pays, counts = _np(out["values"]), _np(out["payload"]), \
        _np(out["count"])
    v = np.concatenate([vals[b][:counts[b]] for b in range(len(counts))])
    p = np.concatenate([pays[b][:counts[b]] for b in range(len(counts))])
    return v, p


def _same_as_jax(out, jout, keys=("values", "payload", "count")):
    for k in keys:
        g, w = _np(out[k]), np.asarray(jout[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)
    assert int(out["n_dropped"]) == int(np.asarray(jout["n_dropped"]))


def _pair(n_dev=8, **kw):
    run, mesh = make_distributed_sort(DEVS[:n_dev], **kw)
    jrun, _ = jsort.make_distributed_sort(jax.devices()[:n_dev], **kw)
    assert mesh.shape == {"sp": 1, "dp": n_dev}
    return run, jrun


@pytest.mark.parametrize("dtype,descending", [
    (np.int32, False), (np.int32, True),
    (np.float32, False), (np.float32, True),
])
def test_sort_matches_numpy(dtype, descending):
    rng = np.random.default_rng(7)
    n = 4096
    if np.dtype(dtype).kind == "f":
        values = (rng.standard_normal(n) * 100).astype(dtype)
    else:
        values = rng.integers(-10_000, 10_000, n).astype(dtype)
    run, jrun = _pair(capacity=n, dtype=dtype, descending=descending)
    out = run(values)
    _same_as_jax(out, jrun(values))
    assert int(out["n_dropped"]) == 0
    v, p = _collect(out)
    want = np.sort(values)
    if descending:
        want = want[::-1]
    np.testing.assert_array_equal(v, want)
    np.testing.assert_array_equal(values[p], v)


def test_sort_buckets_are_balanced():
    rng = np.random.default_rng(11)
    n = 8192
    values = rng.integers(0, 1 << 30, n).astype(np.int32)
    run, jrun = _pair(capacity=n)
    out = run(values)
    _same_as_jax(out, jrun(values))
    counts = _np(out["count"])
    assert counts.sum() == n and counts.max() <= 3 * n // len(counts)


def test_sort_capacity_overflow_reported_not_silent():
    n = 1024
    values = np.zeros(n, np.int32)
    run, jrun = _pair(capacity=8)
    out = run(values)
    _same_as_jax(out, jrun(values))
    dropped = int(out["n_dropped"])
    assert dropped > 0
    v, _ = _collect(out)
    assert len(v) + dropped == n and (v == 0).all()


def test_sort_with_valid_mask_and_duplicates():
    rng = np.random.default_rng(13)
    n = 2000
    values = rng.integers(0, 50, n).astype(np.int32)
    valid = rng.random(n) > 0.3
    run, jrun = _pair(capacity=n)
    out = run(values, valid_np=valid)
    _same_as_jax(out, jrun(values, valid_np=valid))
    v, p = _collect(out)
    np.testing.assert_array_equal(v, np.sort(values[valid]))
    assert valid[p].all()
    np.testing.assert_array_equal(values[p], v)


def test_sort_float_special_values():
    """±inf and large magnitudes, and ±0.0 and NaN placed as ``jnp.sort``
    places them (both signs of zero equal, every NaN last).  With a NaN
    the buckets and counts are the reference's, and the count prefix
    holds the NaN rows: every pad slot sorts after them (the reference's
    padded rows put a NaN after its bucket's pads, ROADMAP Queue C
    slice 19)."""
    values = np.array([3.5, -np.inf, 0.0, np.inf, -2.25, 1e30, -1e30],
                      np.float32)
    run, jrun = _pair(capacity=16, dtype=np.float32)
    out = run(values)
    _same_as_jax(out, jrun(values))
    v, _ = _collect(out)
    np.testing.assert_array_equal(v, np.sort(values))
    odd = np.array([0.0, -0.0, np.nan, 1.0, -0.0, -np.nan, 0.0, np.inf],
                   np.float32)
    for desc in (False, True):
        run, jrun = _pair(capacity=16, dtype=np.float32, descending=desc)
        out = run(odd)
        _same_as_jax(out, jrun(odd), keys=("count",))
        v, p = _collect(out)
        want = np.argsort(-odd if desc else odd, kind="stable")
        np.testing.assert_array_equal(p, want)
        np.testing.assert_array_equal(v.view(np.int32),
                                      odd[want].view(np.int32))
        vals, pays, counts = (_np(out[k]) for k in ("values", "payload",
                                                    "count"))
        for b, n in enumerate(counts):
            assert (pays[b][n:] == -1).all()
            assert (vals[b][n:] == (-np.inf if desc else np.inf)).all()


def test_sort_property_random():
    rng = np.random.default_rng(17)
    run, jrun = _pair(capacity=4096)
    for trial in range(8):
        n = int(rng.integers(1, 3000))
        lo, hi = sorted(rng.integers(-1000, 1000, 2).tolist())
        if lo == hi:
            hi += 1
        values = rng.integers(lo, hi, n).astype(np.int32)
        valid = rng.random(n) < rng.random()
        out = run(values, valid_np=valid)
        _same_as_jax(out, jrun(values, valid_np=valid))
        counts = _np(out["count"])
        v = np.concatenate([_np(out["values"])[b][:counts[b]]
                            for b in range(len(counts))])
        np.testing.assert_array_equal(v, np.sort(values[valid]),
                                      err_msg=str(trial))


def _distinct_pair(n_dev=8, **kw):
    run, _ = make_distributed_distinct(DEVS[:n_dev], **kw)
    jrun, _ = jsort.make_distributed_distinct(jax.devices()[:n_dev], **kw)
    return run, jrun


def test_distinct_matches_numpy():
    rng = np.random.default_rng(19)
    run, jrun = _distinct_pair(capacity=4096)
    for trial in range(6):
        n = int(rng.integers(1, 3000))
        hi = int(rng.integers(2, 60))
        values = rng.integers(0, hi, n).astype(np.int32)
        valid = rng.random(n) < 0.8
        out = run(values, valid_np=valid)
        assert int(out["n_dropped"]) == 0
        want = len(np.unique(values[valid]))
        assert int(out["distinct"]) == want == \
            int(jrun(values, valid_np=valid)["distinct"]), trial


def test_distinct_single_value_everywhere():
    run, _ = _distinct_pair(capacity=2048)
    assert int(run(np.zeros(1024, np.int32))["distinct"]) == 1
    assert int(run(np.zeros(0, np.int32))["distinct"]) == 0


def test_distinct_sentinel_valued_keys():
    run, _ = _distinct_pair(capacity=64)
    assert int(run(np.full(8, (1 << 31) - 1, np.int32))["distinct"]) == 1
    fr, jfr = _distinct_pair(capacity=64, dtype=np.float32)
    f = np.array([np.inf, np.inf, 1.0, np.inf], np.float32)
    assert int(fr(f)["distinct"]) == 2 == int(jfr(f)["distinct"])
    # each NaN counts on its own (IEEE !=), as the local path and numpy
    # count them; the reference reads pads where its NaNs were
    nans = np.array([np.nan, np.nan, 0.0, -0.0], np.float32)
    assert int(fr(nans)["distinct"]) == 3 == len(np.unique(nans,
                                                           equal_nan=False))


def test_distributed_sort_uint32_values():
    rng = np.random.default_rng(13)
    vals = rng.integers(0, 1 << 32, 64 * 8, dtype=np.uint64) \
        .astype(np.uint32)
    run, jrun = _pair(capacity=len(vals), dtype=np.uint32)
    out = run(vals)
    _same_as_jax(out, jrun(vals))
    counts = _np(out["count"])
    got = np.concatenate([_np(out["values"])[b][:counts[b]]
                          for b in range(len(counts))])
    np.testing.assert_array_equal(got, np.sort(vals))
    assert got.dtype == np.uint32
    drun, _ = _distinct_pair(capacity=len(vals), dtype=np.uint32)
    assert int(drun(vals)["distinct"]) == len(np.unique(vals))


@pytest.mark.parametrize("sp", [1, 2])
def test_distributed_sort_u64_stable_matches_argsort(sp):
    rng = np.random.default_rng(11)
    n = 2048
    hi = rng.integers(0, 6, n).astype(np.uint64)
    lo = rng.integers(0, 9, n).astype(np.uint64)
    values = (hi << np.uint64(32)) | lo
    values[:8] = [0, (1 << 64) - 1, 0xFFFFFFFF, 0xFFFFFFFF00000000,
                  (1 << 64) - 1, 0, 0xFFFFFFFF, 0xFFFFFFFF00000000]
    payload = np.arange(n, dtype=np.int64) * 7
    mesh = make_scan_mesh(DEVS, sp=sp)      # the sort flattens the mesh
    sv, spay = distributed_sort_u64(mesh, values, payload)
    order = np.argsort(values, kind="stable")
    np.testing.assert_array_equal(sv, values[order])
    np.testing.assert_array_equal(spay, payload[order])
    jv, jp = jsort.distributed_sort_u64(jax_mesh(jax.devices(), sp=sp),
                                        values, payload)
    np.testing.assert_array_equal(sv, jv)
    np.testing.assert_array_equal(spay, jp)
    ev, ep = distributed_sort_u64(mesh, np.zeros(0, np.uint64),
                                  np.zeros(0, np.int64))
    assert len(ev) == 0 and len(ep) == 0


def test_sort_refuses_other_dtypes():
    with pytest.raises(StromError):
        make_distributed_sort(DEVS[:2], capacity=4, dtype=np.int64)


# -- hypothesis: random keys, skew, valid masks, capacities that drop ---------

_SETTINGS = settings(max_examples=15, deadline=None, derandomize=True,
                     suppress_health_check=[HealthCheck.too_slow])


@_SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(0, 700),
       n_dev=st.sampled_from([1, 2, 3, 4]),
       kind=st.sampled_from(["int32", "uint32", "float32"]),
       descending=st.booleans(), spread=st.integers(1, 1 << 20),
       capacity=st.sampled_from([1, 4, 16, 64, 512]),
       density=st.floats(0.0, 1.0), payload=st.booleans())
def test_hypothesis_sort_is_the_reference(seed, n, n_dev, kind, descending,
                                          spread, capacity, density,
                                          payload):
    rng = np.random.default_rng(seed)
    dt = np.dtype(kind)
    if kind == "float32":
        values = (rng.integers(-spread, spread + 1, n) / 8).astype(dt)
        values[rng.random(n) < 0.05] = np.inf
        values[rng.random(n) < 0.05] = -0.0
    elif kind == "uint32":
        values = rng.integers(0, spread + 1, n).astype(dt) \
            + np.uint32((1 << 32) - spread - 1) * (rng.random(n) < 0.3)
    else:
        values = rng.integers(-spread, spread + 1, n).astype(dt)
    valid = rng.random(n) < density
    run, jrun = _pair(n_dev=n_dev, capacity=capacity, dtype=dt,
                      descending=descending, with_payload=payload)
    out, jout = run(values, valid_np=valid), jrun(values, valid_np=valid)
    _same_as_jax(out, jout, ("values", "count")
                 + (("payload",) if payload else ()))
    counts = _np(out["count"])
    assert counts.sum() + int(out["n_dropped"]) == int(valid.sum())


@_SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(0, 400),
       n_dev=st.sampled_from([1, 2, 4]), width=st.integers(1, 4),
       capacity=st.sampled_from([1, 3, 8, 64]),
       skew=st.floats(0.0, 1.0), density=st.floats(0.0, 1.0))
def test_hypothesis_exchange_is_the_reference(seed, n, n_dev, width,
                                              capacity, skew, density):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, n_dev + 1, n).astype(np.int32)
    keys[rng.random(n) < skew] = 0             # skew onto one owner
    rows = rng.integers(-1000, 1000, (n, width)).astype(np.int32)
    valid = rng.random(n) < density
    run, mesh = make_bucket_exchange(DEVS[:n_dev], capacity=capacity,
                                     width=width, fill_value=-(1 << 20))
    jrun, _ = jexchange.make_bucket_exchange(
        jax.devices()[:n_dev], capacity=capacity, width=width,
        fill_value=-(1 << 20))
    out, jout = run(rows, keys, valid), jrun(rows, keys, valid)
    for k in ("rows", "count", "n_dropped"):
        np.testing.assert_array_equal(_np(out[k]), np.asarray(jout[k]),
                                      err_msg=k)


# -- tests/test_scan_ops.py's exchange tests ----------------------------------

def test_bucket_exchange_repartitions_rows_by_key():
    dp, width, cap = 8, 3, 16
    rng = np.random.default_rng(33)
    n = dp * 32
    keys = rng.integers(0, dp, n).astype(np.int32)
    rows = rng.integers(-1000, 1000, (n, width)).astype(np.int32)
    rows[:, 0] = keys
    valid = rng.random(n) < 0.9
    run, _ = make_bucket_exchange(DEVS, capacity=cap, width=width,
                                  fill_value=-(1 << 20))
    out = run(rows, keys, valid)
    assert int(out["n_dropped"]) == 0
    got, counts = _np(out["rows"]), _np(out["count"])
    for b in range(dp):
        sel = (keys == b) & valid
        assert counts[b] == sel.sum()
        real = got[b][got[b][:, 0] != -(1 << 20)]
        assert {tuple(r) for r in real} == {tuple(r) for r in rows[sel]}
        assert (real[:, 0] == b).all()


def test_bucket_exchange_capacity_drops_are_reported():
    dp = 8
    n = dp * 8
    keys = np.zeros(n, np.int32)
    rows = np.arange(n * 2, dtype=np.int32).reshape(n, 2)
    run, _ = make_bucket_exchange(DEVS, capacity=4, width=2)
    out = run(rows, keys)
    assert int(out["n_dropped"]) == n - dp * 4
    assert int(_np(out["count"])[0]) == dp * 4


def test_bucket_exchange_bad_keys_and_padding():
    run, _ = make_bucket_exchange(DEVS[:4], capacity=8, width=2,
                                  fill_value=-(1 << 20))
    keys = np.array([0, 1, -1, 5, 2, 3, 1], np.int32)
    rows = np.stack([keys, np.arange(7, dtype=np.int32)], 1)
    out = run(rows, keys)
    assert int(out["n_dropped"]) == 2
    got = _np(out["rows"])
    real = got[got[:, :, 0] != -(1 << 20)]
    assert {tuple(r) for r in real.reshape(-1, 2)} == \
        {(0, 0), (1, 1), (2, 4), (3, 5), (1, 6)}
