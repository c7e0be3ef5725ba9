"""Ring permute (B4), all-gather and ring multi-query scan of the PyTorch
port against the JAX package on the same numpy inputs.

The port runs on N × ``cpu`` members and so through the plain versions;
the JAX oracle runs on the 8-device CPU mesh of ``tests/conftest.py``.
Bytes and integer results must match exactly (there are no float sums on
this path).  The JAX ``ring_all_gather`` does not run on this JAX (it
passes ``check_rep`` to ``shard_map``), so the gather's oracle is a gather
the test builds from the JAX ``ring_permute_step(backend="xla")`` inside
its own ``jax.shard_map(..., check_vma=False)``, and the file's bytes."""

import errno

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from nvme_strom_tpu.engine import PlainSource as JPlainSource
from nvme_strom_tpu.parallel.ring import (
    make_ring_multi_query_scan as jax_ring_scan,
    ring_permute_step as jax_permute_step,
    ring_scan_source as jax_ring_scan_source)
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import ConfigError, config
from nvme_strom_tpu_torch.engine import PlainSource
from nvme_strom_tpu_torch.ops import permute_cuda
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.permute import permute_step_plain
from nvme_strom_tpu_torch.parallel import (make_ring_multi_query_scan,
                                           make_scan_mesh, permute_backend,
                                           ring_all_gather,
                                           ring_permute_step,
                                           ring_scan_source)
from nvme_strom_tpu_torch.parallel.ring import ring_finish
from nvme_strom_tpu_torch.scan.heap import (PAGE_SIZE, HeapSchema,
                                            build_heap_file, build_pages)


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("dp",))


def _jax_rotate(global_np, n):
    """The JAX ppermute ring step over a (n * rows, ...) array, one block
    per device, in the test's own shard_map."""
    def body(x):
        return jax_permute_step(x, axis="dp", ring=n, backend="xla")
    spec = P("dp", *([None] * (global_np.ndim - 1)))
    fn = jax.shard_map(body, mesh=_jax_mesh(n), in_specs=spec,
                       out_specs=spec, check_vma=False)
    return np.asarray(fn(jnp.asarray(global_np)))


def _blocks(kind, n, rows, seed):
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        g = rng.integers(0, 256, (n * rows, PAGE_SIZE), dtype=np.uint8)
    elif kind == "int32":
        g = rng.integers(-(1 << 31), (1 << 31) - 1, n * rows,
                         dtype=np.int32)
    else:
        g = rng.standard_normal((n * rows, 16)).astype(np.float32)
        g[0, 0], g[-1, 1] = np.nan, -0.0
    return g


@pytest.mark.parametrize("rows", [1, 3, 5])
@pytest.mark.parametrize("kind", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_permute_step_matches_jax_ppermute(n, kind, rows):
    g = _blocks(kind, n, rows, seed=n * 100 + rows)
    want = _jax_rotate(g, n)
    mesh = make_scan_mesh(["cpu"] * n)
    blocks = [torch.from_numpy(g[i * rows:(i + 1) * rows].copy())
              for i in range(n)]
    got = ring_permute_step(blocks, ring=mesh)
    assert len(got) == n
    for i in range(n):
        assert got[i].dtype == blocks[i].dtype
        assert got[i].numpy().tobytes() == \
            want[i * rows:(i + 1) * rows].tobytes(), f"member {i}"
    # three steps in a row: the epoch count of the card has no role here,
    # but the rotation must compose, also with the timeout check deferred
    # to one ring_finish as the multi-step callers do
    again = ring_permute_step(ring_permute_step(got, ring=n, finish=False),
                              ring=n, finish=False)
    ring_finish(mesh.devices)
    for i in range(n):
        src = (i - 3) % n
        assert again[i].numpy().tobytes() == \
            g[src * rows:(src + 1) * rows].tobytes()


def test_permute_into_out_and_shape_checks():
    n = 4
    blocks = [torch.full((3, 2), i, dtype=torch.int32) for i in range(n)]
    out = [torch.empty((3, 2), dtype=torch.int32) for _ in range(n)]
    res = ring_permute_step(blocks, ring=n, out=out)
    assert all(r is o for r, o in zip(res, out))
    assert [int(o[0, 0]) for o in out] == [3, 0, 1, 2]
    with pytest.raises(StromError) as e:
        ring_permute_step(blocks[:3], ring=n)
    assert e.value.errno == errno.EINVAL
    bad = blocks[:3] + [torch.zeros((4, 2), dtype=torch.int32)]
    with pytest.raises(StromError):
        ring_permute_step(bad, ring=n)
    with pytest.raises(StromError):
        ring_permute_step(blocks, ring=n,
                          out=[torch.empty(3, dtype=torch.int32)] * n)


@pytest.fixture()
def port_config():
    snap = config.snapshot()
    yield config
    config.restore(snap)


def test_routes_resolve_from_the_members_and_never_substitute(port_config):
    assert permute_backend(device="cpu") == "plain"
    assert permute_backend(device="cuda:0") == "cuda"
    assert permute_backend("plain", device="cuda:0") == "plain"
    config.set("ici_permute", "plain")
    assert permute_backend(device="cuda:0") == "plain"
    config.set("ici_permute", "auto")
    with pytest.raises(ConfigError):
        config.set("ici_permute", "pallas")
    with pytest.raises(StromError):
        permute_backend("xla", device="cpu")
    blocks = [torch.zeros(4, dtype=torch.uint8) for _ in range(2)]
    before = permute_cuda.launches
    # the CUDA route on CPU members raises; it never runs the plain copy
    with pytest.raises(StromError) as e:
        ring_permute_step(blocks, ring=2, backend="cuda")
    assert e.value.errno == errno.EINVAL
    config.set("ici_permute", "cuda")
    with pytest.raises(StromError):
        ring_permute_step(blocks, ring=2)
    assert permute_cuda.launches == before
    meta = [torch.zeros(4, dtype=torch.uint8, device="meta")] * 2
    config.set("ici_permute", "auto")
    with pytest.raises(StromError) as e:
        ring_permute_step(meta, ring=2)
    assert e.value.errno == errno.EINVAL


def test_mesh_members_and_refusals():
    """The ``(sp, dp)`` grid is the reference's ``reshape(sp, n // sp)``,
    dp innermost (``nvme_strom_tpu/parallel/mesh.py:33-48``), with its lane
    rings and dp columns; refused: sp that does not divide the members,
    an empty ring, and no card for the default."""
    from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jmesh
    mesh = make_scan_mesh(["cpu"] * 3)
    assert mesh.shape == {"sp": 1, "dp": 3}
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert make_scan_mesh([torch.device("cpu")] * 3).devices == mesh.devices
    for sp in (1, 2, 4, 8):
        grid = make_scan_mesh(["cpu"] * 8, sp=sp)
        ref = jmesh(jax.devices()[:8], sp=sp)
        assert grid.shape == dict(ref.shape) and grid.size == 8
        flat = [d.id for d in ref.devices.reshape(-1)]
        for s in range(sp):
            lane = grid.lane(s)
            assert lane.shape == {"sp": 1, "dp": 8 // sp}
            assert [int(x.id) for x in ref.devices[s]] == \
                flat[s * grid.dp:(s + 1) * grid.dp]
        for d in range(grid.dp):
            assert len(grid.column(d)) == sp
    two = make_scan_mesh(["cpu"] * 4, sp=2)
    t = [torch.arange(3) + 10 * d for d in range(2)]
    rep = two.replicate(t)
    # lanes on one device share the dp shard's tensor
    assert len(rep) == 4 and rep[2] is t[0] and rep[3] is t[1]
    with pytest.raises(StromError) as e:
        make_scan_mesh(["cpu"] * 4, sp=3)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError):
        make_scan_mesh([])
    with pytest.raises(StromError) as e:
        make_scan_mesh()          # no CUDA device here: never the CPU
    assert e.value.errno == errno.ENODEV
    with pytest.raises(StromError) as e:
        make_scan_mesh(sp=2)
    assert e.value.errno == errno.ENODEV


def test_ring_all_gather_over_an_sp_mesh():
    """Each lane of an ``(sp=2, dp=3)`` mesh gathers its own dp ring: every
    member ends with the dp shards in order, as the reference's gather
    over ``"dp"``."""
    rng = np.random.default_rng(4)
    mesh = make_scan_mesh(["cpu"] * 6, sp=2)
    dp_shards = [torch.from_numpy(rng.integers(0, 256, (5, 16),
                                               dtype=np.uint8))
                 for _ in range(3)]
    out = ring_all_gather(mesh.replicate(dp_shards), mesh,
                          backend="plain")
    want = torch.cat(dp_shards)
    assert len(out) == 6
    for t in out:
        assert torch.equal(t, want)
    assert out[0] is not out[3]        # gathered into fresh tensors


def _jax_gather(g, n):
    """A ring all-gather built from the JAX xla ring step: member i's
    output holds shard k at rows k * rows."""
    rows = g.shape[0] // n

    def body(x):
        me = jax.lax.axis_index("dp")
        out = jnp.zeros((n * rows,) + x.shape[1:], x.dtype)
        block = x
        for s in range(n):
            src = jax.lax.rem(me - s + n, n)
            out = jax.lax.dynamic_update_slice_in_dim(out, block, src * rows,
                                                      axis=0)
            block = jax_permute_step(block, axis="dp", ring=n,
                                     backend="xla")
        return out[None]

    fn = jax.shard_map(body, mesh=_jax_mesh(n), in_specs=P("dp", None),
                       out_specs=P("dp", None, None), check_vma=False)
    return np.asarray(fn(jnp.asarray(g)))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_all_gather_matches_jax_ring_and_the_bytes(n):
    rng = np.random.default_rng(n)
    rows = 3
    g = rng.integers(0, 256, (n * rows, PAGE_SIZE), dtype=np.uint8)
    want = _jax_gather(g, n)
    mesh = make_scan_mesh(["cpu"] * n)
    shards = [torch.from_numpy(g[i * rows:(i + 1) * rows].copy())
              for i in range(n)]
    got = ring_all_gather(shards, mesh)
    for i in range(n):
        assert got[i].numpy().tobytes() == g.tobytes()
        assert got[i].numpy().tobytes() == want[i].tobytes()


def _heap(path, n_pages, seed, tail=0):
    rng = np.random.default_rng(seed)
    schema = HeapSchema(n_cols=2, visibility=True)
    n = schema.tuples_per_page * n_pages - tail
    c0 = rng.integers(-1000, 1000, n).astype(np.int32)
    c1 = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    vis = (rng.random(n) > 0.25).astype(np.int32)
    build_heap_file(path, [c0, c1], schema, visibility=vis)
    return schema, c0, c1, vis


def _wrap32(x):
    return np.int32(np.uint32(x.astype(np.int64).sum() & 0xFFFFFFFF)
                    .view(np.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_multi_query_scan_matches_jax(n):
    rng = np.random.default_rng(40 + n)
    schema = HeapSchema(n_cols=2, visibility=True)
    rows = schema.tuples_per_page * 4 * n - 9
    c0 = rng.integers(-1000, 1000, rows).astype(np.int32)
    c1 = rng.integers(-(1 << 31), (1 << 31) - 1, rows, dtype=np.int32)
    vis = (rng.random(rows) > 0.25).astype(np.int32)
    pages = build_pages([c0, c1], schema, visibility=vis)
    ths = np.array([-500, 0, 250, 900][:n], np.int32)
    jrun, _ = jax_ring_scan(jax.devices()[:n])
    want = jrun(pages, ths)
    run, mesh = make_ring_multi_query_scan(["cpu"] * n)
    got = run(pages, ths)
    assert got["count"].dtype == torch.int32
    assert np.array_equal(got["count"].numpy(), np.asarray(want["count"]))
    assert np.array_equal(got["sums"].numpy(), np.asarray(want["sums"]))
    for q, th in enumerate(ths):
        sel = (vis != 0) & (c0 > th)
        assert int(got["count"][q]) == int(sel.sum())
        assert int(got["sums"][q, 1]) == _wrap32(c1[sel])
    with pytest.raises(ValueError):
        run(pages, ths[:-1])


def test_ring_scan_predicates_and_refusals():
    schema = HeapSchema(n_cols=2, visibility=True)
    rng = np.random.default_rng(5)
    n_rows = schema.tuples_per_page * 8
    c0 = rng.integers(-50, 50, n_rows).astype(np.int32)
    c1 = rng.integers(-50, 50, n_rows).astype(np.int32)
    pages = build_pages([c0, c1], schema)
    ths = np.array([-10, 10], np.int32)
    pred = FilterPred(((0, "gt", None), (1, "lt", 0)))
    got = make_ring_multi_query_scan(["cpu"] * 2, predicate=pred)[0](
        pages, ths)
    # a callable on CPU members, through the plain filter
    call = make_ring_multi_query_scan(
        ["cpu"] * 2, predicate=lambda c, t: (c[0] > t) & (c[1] < 0))[0](
        pages, ths)
    jrun, _ = jax_ring_scan(jax.devices()[:2],
                            predicate=lambda c, t: (c[0] > t) & (c[1] < 0))
    want = jrun(pages, ths)
    for out in (got, call):
        assert np.array_equal(out["count"].numpy(),
                              np.asarray(want["count"]))
        assert np.array_equal(out["sums"].numpy(), np.asarray(want["sums"]))
    with pytest.raises(StromError) as e:
        make_ring_multi_query_scan(["cpu"] * 2,
                                   schema=HeapSchema(2, True,
                                                     ("int32", "float32")))
    assert e.value.errno == errno.EINVAL


@pytest.mark.parametrize("n_pages,batch", [(40, 8), (37, 8), (5, 8)])
def test_ring_scan_source_matches_jax(tmp_path, n_pages, batch):
    """Whole batches, a last batch the pages do not fill, and a table
    smaller than one batch."""
    path = str(tmp_path / "ring.heap")
    schema, c0, c1, vis = _heap(path, n_pages, seed=n_pages, tail=11)
    ths = np.array([-500, 0, 250, 900], np.int32)
    with JPlainSource(path) as src:
        want = jax_ring_scan_source(src, ths, batch_pages=batch,
                                    devices=jax.devices()[:4])
    with PlainSource(path) as src:
        got = ring_scan_source(src, ths, batch_pages=batch,
                               devices=["cpu"] * 4)
    assert np.array_equal(got["count"], want["count"])
    assert np.array_equal(got["sums"], want["sums"])
    for q, th in enumerate(ths):
        sel = (vis != 0) & (c0 > th)
        assert got["count"][q] == sel.sum()
        assert got["sums"][q, 1] == _wrap32(c1[sel])
    with PlainSource(path) as src:
        with pytest.raises(ValueError):
            ring_scan_source(src, ths, batch_pages=6, devices=["cpu"] * 4)


def test_plain_version_is_a_fresh_copy_per_member():
    blocks = [torch.arange(4, dtype=torch.int32) + 10 * i for i in range(3)]
    res = permute_step_plain(blocks)
    assert [int(r[0]) for r in res] == [20, 0, 10]
    res[1][0] = 99
    assert int(blocks[0][0]) == 0


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(9)
    for n, rows in ((2, 1), (3, 5), (4, 3)):
        blocks = [torch.from_numpy(rng.integers(0, 256, (rows, PAGE_SIZE),
                                                dtype=np.uint8)).to(
            cuda_device) for _ in range(n)]
        before = permute_cuda.launches
        got = ring_permute_step(blocks, ring=n)
        want = permute_step_plain(blocks)
        torch.cuda.synchronize()
        assert permute_cuda.launches == before + n
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(StromError) as e:
        permute_cuda.wait_signals([cuda_device] * 2, 0, 1, budget_s=0.05)
    assert e.value.errno == errno.ETIMEDOUT
