"""The port's distributed scan step (``parallel/dscan.py``), its ``(sp,
dp)`` mesh, and the sharded stream over that mesh, against the JAX
package's ``make_distributed_scan_step`` on the conftest's virtual CPU
devices, on the same heap bytes.  Each test mirrors one of
``tests/test_scan_ops.py`` (:76, :95, :178).  The port's members are N ×
``"cpu"`` (the plain version of B1 on each); a ``cuda``-marked test holds
B1 on the card against it.

Tolerances: counts and integer sums exact (int32 wraps mod 2^32, as
``jnp.sum`` with x64 off); float32 sums within ``1e-5 * sum(|x|) + 1e-6``
(the reduction order differs: per-member partials, then the fold)."""

import errno
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from nvme_strom_tpu.parallel.dscan import \
    make_distributed_scan_step as jax_step
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.engine import open_source
from nvme_strom_tpu_torch.ops import filter_cuda
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.parallel import (ShardedBatchStream,
                                           distributed_scan_filter,
                                           load_pages_sharded,
                                           make_distributed_scan_step,
                                           make_scan_mesh, pages_sharding,
                                           shard_pages)
from nvme_strom_tpu_torch.scan.heap import PAGE_SIZE, HeapSchema, \
    build_heap_file


@pytest.fixture(autouse=True)
def _cfg():
    snap = config.snapshot()
    yield
    config.restore(snap)


def _demo(n_rows, seed, n_cols=2, dtypes=None, pad_to=8):
    """tests/test_scan_ops.py's demo table as page bytes, zero pages
    padding the count to a multiple of *pad_to*."""
    rng = np.random.default_rng(seed)
    kw = dict(n_cols=n_cols, visibility=True, dtypes=dtypes)
    schema = HeapSchema(**kw)
    cols = []
    for c in range(n_cols):
        dt = np.dtype(dtypes[c]) if dtypes else np.dtype(np.int32)
        if dt.kind == "f":
            cols.append(rng.standard_normal(n_rows).astype(dt))
        elif dt.kind == "u":
            cols.append(rng.integers(0, 1 << 32, n_rows, dtype=np.uint64)
                        .astype(dt))
        else:
            cols.append(rng.integers(-1000, 1000, n_rows).astype(dt))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.heap")
        build_heap_file(path, cols, schema)
        pages = np.fromfile(path, np.uint8).reshape(-1, PAGE_SIZE)
    pad = (-len(pages)) % pad_to
    if pad:
        pages = np.concatenate([pages, np.zeros((pad, PAGE_SIZE), np.uint8)])
    return schema, JSchema(**kw), cols, pages


def _same(got, want, float_sum=False):
    g = np.asarray(got.cpu().numpy() if isinstance(got, torch.Tensor)
                   else got)
    w = np.asarray(want)
    if float_sum:
        assert np.all(np.abs(g.astype(np.float64) - w.astype(np.float64))
                      <= 1e-5 * np.abs(w.astype(np.float64)) + 1e-6)
    else:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_distributed_scan_psum_matches_local(sp):
    """tests/test_scan_ops.py:76 (sp=1) and :95 (sp=2): the folded count
    and sums equal the JAX step's and the numpy oracle's on an 8-member
    mesh, whatever the column lanes."""
    schema, js, (c0, c1), pages = _demo(8000, seed=4)
    run, mesh = make_distributed_scan_step(["cpu"] * 8, sp=sp)
    assert mesh.shape == {"sp": sp, "dp": 8 // sp}
    out = run(pages, 25)
    jrun, jmesh = jax_step(jax.devices()[:8], sp=sp)
    assert dict(jmesh.shape) == mesh.shape
    want = jrun(pages, np.int32(25))
    _same(out["count"], want["count"])
    _same(out["sums"], want["sums"])
    sel = c0 > 25
    assert int(out["count"]) == int(sel.sum())
    assert int(out["sums"][0]) == int(c0[sel].sum())
    assert int(out["sums"][1]) == int(c1[sel].sum())


def test_distributed_scan_2d_mesh_column_lanes():
    """tests/test_scan_ops.py:95: each lane keeps only its own columns'
    sums (``run.step``), and the fold over both axes is the whole."""
    schema, js, cols, pages = _demo(6000, seed=9, n_cols=5)
    run, mesh = make_distributed_scan_step(["cpu"] * 4, sp=2, schema=schema)
    parts = run.step(pages, -10)
    assert len(parts) == 4
    per_lane = 3                       # ceil(5 / 2)
    for i, (_count, sums) in enumerate(parts):
        lane = i // mesh.dp
        for c, s in enumerate(sums):
            if not lane * per_lane <= c < (lane + 1) * per_lane:
                assert int(s) == 0, (i, c)
    # count is the same on every lane: folded over dp only
    assert int(parts[0][0]) + int(parts[1][0]) == \
        int(parts[2][0]) + int(parts[3][0])
    out = run(pages, -10)
    want = jax_step(jax.devices()[:4], sp=2, schema=js)[0](pages,
                                                           np.int32(-10))
    _same(out["count"], want["count"])
    _same(out["sums"], want["sums"])


@pytest.mark.parametrize("dtypes", [("int32", "float32", "int32"),
                                    ("uint32", "uint32", "uint32"),
                                    ("float32", "float32", "float32")])
def test_distributed_scan_dtypes_follow_jnp(dtypes):
    """The stacked sums take ``jnp.stack``'s promotion: a float column
    makes every sum float32, an all-uint32 schema sums uint32 (wrapping)."""
    schema, js, cols, pages = _demo(3000, seed=12, n_cols=3, dtypes=dtypes)
    pred = FilterPred(((1, "gt", 0),))
    out = make_distributed_scan_step(["cpu"] * 4, sp=2, schema=schema,
                                     predicate=pred)[0](pages, 0)
    want = jax_step(jax.devices()[:4], sp=2, schema=js,
                    predicate=lambda c, th: c[1] > 0)[0](pages, np.int32(0))
    _same(out["count"], want["count"])
    w = np.asarray(want["sums"])
    g = out["sums"]
    if g.dtype == torch.uint32:
        g = g.view(torch.int32).numpy().view(np.uint32)
    else:
        g = g.numpy()
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    _same(g, w, float_sum=w.dtype.kind == "f")


def test_distributed_scan_callable_predicate_on_cpu_members():
    schema, js, (c0, c1), pages = _demo(4000, seed=3)
    run, _ = make_distributed_scan_step(
        ["cpu"] * 4, sp=2, predicate=lambda cols, th: cols[1] < th)
    out = run(pages, 50)
    sel = c1 < 50
    assert int(out["count"]) == int(sel.sum())
    assert int(out["sums"][0]) == int(c0[sel].sum())


def test_shard_pages_replicates_lanes_and_refuses_uneven():
    schema, js, _cols, pages = _demo(2000, seed=5, pad_to=4)
    mesh = make_scan_mesh(["cpu"] * 4, sp=2)
    sh = shard_pages(pages, mesh)
    r = len(pages) // 2
    for i, t in enumerate(sh):
        np.testing.assert_array_equal(t.numpy(),
                                      pages[(i % 2) * r:(i % 2 + 1) * r])
    assert sh[2] is sh[0] and sh[3] is sh[1]   # one device: one tensor
    assert pages_sharding(mesh).spec == ("dp", None)
    with pytest.raises(StromError) as e:
        shard_pages(pages[:3], mesh)
    assert e.value.errno == errno.EINVAL


def test_sharded_batch_stream_covers_and_matches(tmp_path):
    """tests/test_scan_ops.py:178: the stream over an ``(sp=2, dp=4)``
    mesh yields every page once a dp shard, the lanes sharing it; the
    step folded through ``distributed_scan_filter`` matches the oracle,
    fed by the same mesh and re-sharded from a one-axis ring's stream."""
    rng = np.random.default_rng(31)
    schema = HeapSchema(n_cols=2, visibility=True)
    t = schema.tuples_per_page
    n_pages = 48
    c0 = rng.integers(-1000, 1000, t * n_pages).astype(np.int32)
    c1 = rng.integers(0, 100, t * n_pages).astype(np.int32)
    path = str(tmp_path / "stream.heap")
    build_heap_file(path, [c0, c1], schema)
    want = np.fromfile(path, np.uint8).reshape(n_pages, PAGE_SIZE)
    mesh = make_scan_mesh(["cpu"] * 8, sp=2)
    seen = []
    with open_source(path) as src:
        with ShardedBatchStream(src, mesh, batch_pages=8) as stream:
            for first, shards in stream:
                seen.append(first)
                assert len(shards) == 8
                for i, s in enumerate(shards):
                    d = i % 4
                    np.testing.assert_array_equal(
                        s.numpy(), want[first + 2 * d:first + 2 * d + 2])
    assert seen == [0, 8, 16, 24, 32, 40]
    with open_source(path) as src:
        loaded = load_pages_sharded(src, mesh)
    for i, s in enumerate(loaded):
        d = i % 4
        np.testing.assert_array_equal(s.numpy(), want[12 * d:12 * d + 12])
    step, _ = make_distributed_scan_step(["cpu"] * 8, sp=2, schema=schema)
    sel = c0 > 50
    for stream_mesh in (mesh, make_scan_mesh(["cpu"] * 8)):
        with open_source(path) as src:
            out = distributed_scan_filter(src, stream_mesh,
                                          lambda a: step(a, 50),
                                          batch_pages=8)
        assert int(out["count"]) == int(sel.sum())
        assert int(out["sums"][1]) == int(c1[sel].sum())


def test_wide_sums_under_x64_are_64_bit():
    """Under the port's ``x64`` the count and integer sums are 64-bit, as
    ``jnp.sum`` under ``jax_enable_x64``: no wrap."""
    schema, js, (c0, c1), pages = _demo(4000, seed=8)
    config.set("x64", True)
    out = make_distributed_scan_step(["cpu"] * 4, sp=2)[0](pages, -2000)
    assert out["count"].dtype == torch.int64
    assert out["sums"].dtype == torch.int64
    with jax.enable_x64(True):
        want = jax_step(jax.devices()[:4], sp=2)[0](pages, -2000)
        _same(out["count"], want["count"])
        _same(out["sums"], want["sums"])


def test_mesh_refusals():
    with pytest.raises(StromError) as e:
        make_distributed_scan_step(["cpu"] * 4, sp=3)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError) as e:
        make_distributed_scan_step(sp=2)          # no card: never the CPU
    assert e.value.errno == errno.ENODEV


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B1 runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_member_step_launches_b1_on_the_card(cuda_device):
    """On CUDA members each member's step is one B1 launch, equal to the
    plain version on the host; a callable predicate is EINVAL there."""
    schema, js, (c0, c1), pages = _demo(8000, seed=4)
    run, mesh = make_distributed_scan_step([cuda_device] * 4, sp=2)
    before = filter_cuda.launches
    out = run(pages, 25)
    assert filter_cuda.launches == before + 4
    want = make_distributed_scan_step(["cpu"] * 4, sp=2)[0](pages, 25)
    assert int(out["count"]) == int(want["count"])
    assert torch.equal(out["sums"].cpu(), want["sums"])
    with pytest.raises(StromError) as e:
        make_distributed_scan_step([cuda_device] * 2,
                                   predicate=lambda c, th: c[0] > th)
    assert e.value.errno == errno.EINVAL
