"""Checkpoints of the PyTorch port against the JAX package's on the same
seeded numpy trees: byte-identical files both ways (header, offsets,
padding, crc32c), cross restores bit-exact, the JAX key paths from the
port's own flatten, the streamed, sharded and replicated restores, the
sharded save, verify, crash safety, and the refusals (bad magic,
bfloat16/float8, a second-axis sharding)."""

import collections
import errno
import os

import jax
import numpy as np
import pytest
import torch

import nvme_strom_tpu.data as jdata
import nvme_strom_tpu_torch.data.checkpoint as ck
from nvme_strom_tpu.api import StromError as JStromError
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.parallel.mesh import make_scan_mesh as jax_mesh
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.data import (checkpoint_info, restore_checkpoint,
                                       save_checkpoint,
                                       save_checkpoint_sharded)
from nvme_strom_tpu_torch.engine import PlainSource
from nvme_strom_tpu_torch.parallel import (RingSharding, ShardedTensor,
                                           make_scan_mesh)
from nvme_strom_tpu_torch.tools import strom_ckpt


@pytest.fixture(autouse=True)
def _port_config():
    snap = tcfg.snapshot()
    yield
    tcfg.restore(snap)


def _tree_data():
    """tests/test_data.py's tree."""
    rng = np.random.default_rng(11)
    return {
        "w": rng.standard_normal((64, 48)).astype(np.float32),
        "b": rng.standard_normal((91,)).astype(np.float32),  # odd bytes
        "emb": {"table": rng.integers(0, 127, (33, 7)).astype(np.int8)},
        "step": np.int32(1234),
    }


def _tree_mixed():
    rng = np.random.default_rng(17)
    return {
        "f32": rng.standard_normal((911, 130)).astype(np.float32),
        "i32": rng.integers(-2**31, 2**31, (3001, 41),
                            dtype=np.int64).astype(np.int32),
        "u8": rng.integers(0, 255, 70_001, dtype=np.uint8),
        "f16": rng.standard_normal((33, 5)).astype(np.float16),
        "f64": rng.standard_normal(17),
        "i64": rng.integers(-2**62, 2**62, (9,), dtype=np.int64),
        "i16": rng.integers(-300, 300, (4, 4)).astype(np.int16),
        "u16": rng.integers(0, 60000, (6,)).astype(np.uint16),
        "u32": rng.integers(0, 2**32, (5,), dtype=np.uint64)
        .astype(np.uint32),
        "b1": rng.random((3, 3)) > 0.5,
        "c64": (rng.standard_normal(4) + 1j * rng.standard_normal(4))
        .astype(np.complex64),
        "empty": np.zeros((0, 5), np.float32),
        "tiny": np.arange(7, dtype=np.float32),
    }


def _tree_ordered():
    rng = np.random.default_rng(3)
    od = collections.OrderedDict()
    for name in ("z.weight", "a.weight", "m.bias", "b.running_mean"):
        od[name] = rng.standard_normal((8, 3)).astype(np.float32)
    od["num_batches_tracked"] = np.int64(5)
    return {"model": od, "opt": collections.OrderedDict(
        lr=np.float32(0.1), momentum=rng.standard_normal(3)
        .astype(np.float32))}


def _tree_nested():
    rng = np.random.default_rng(4)
    return {"layers": [{"w": rng.standard_normal((4, 4)).astype(np.float32),
                        "b": None},
                       (rng.integers(0, 9, 3).astype(np.int32), None,
                        np.float32(2.5))],
            "skip": None, "t": (np.arange(3, dtype=np.int64),)}


def _tree_scalars():
    return {"i": 3, "f": 2.5, "b": True, "nf": np.float32(1.5),
            "ni": np.int64(-7), "nb": np.bool_(False), "u": np.uint8(200)}


TREES = {"data": _tree_data, "mixed": _tree_mixed, "ordered": _tree_ordered,
         "nested": _tree_nested, "scalars": _tree_scalars}


def _to_torch(tree):
    """The same tree with every numpy array as a torch tensor (python
    scalars stay; numpy scalars become 0-d tensors)."""
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict((k, _to_torch(v))
                                       for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
@pytest.mark.parametrize("name", sorted(TREES))
def test_checkpoint_files_byte_identical(tmp_path, name, leaves):
    """The port's writer and the JAX package's write the same bytes for the
    same tree: header JSON, offsets, padding and crc32c included."""
    tree = TREES[name]()
    mine = str(tmp_path / "mine.strom")
    ref = str(tmp_path / "ref.strom")
    save_checkpoint(mine, _to_torch(tree) if leaves == "torch" else tree)
    jdata.save_checkpoint(ref, tree)
    assert open(mine, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("name", sorted(TREES))
def test_direct_save_byte_identical(tmp_path, name):
    """direct=True (pinned staging + memcpy_ram2ssd) writes the buffered
    writer's bytes, at a staging buffer smaller than the largest leaf."""
    tree = _to_torch(TREES[name]())
    mine = str(tmp_path / "mine.strom")
    ref = str(tmp_path / "ref.strom")
    save_checkpoint(mine, tree, direct=True, staging_bytes=64 << 10)
    jdata.save_checkpoint(ref, TREES[name]())
    assert open(mine, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("name", sorted(TREES))
def test_each_package_restores_the_others_file(tmp_path, name):
    tree = TREES[name]()
    jfile, tfile = str(tmp_path / "j.strom"), str(tmp_path / "t.strom")
    jdata.save_checkpoint(jfile, tree)
    save_checkpoint(tfile, _to_torch(tree))
    keys = [k for k, _ in ck._flatten(tree)]
    mine = restore_checkpoint(jfile, device="cpu", verify=True)
    ref = jdata.restore_checkpoint(tfile, verify=True)
    assert list(mine) == list(ref) == keys
    for k, leaf in ck._flatten(tree):
        want = np.asarray(leaf)
        # the JAX package holds 64-bit leaves at 32 bits (x64 is off):
        # its restore is bit-exact in the dtype it keeps
        jwant = want.astype(jax.dtypes.canonicalize_dtype(want.dtype))
        for got, w in ((mine[k].numpy(), want), (np.asarray(ref[k]), jwant)):
            assert got.dtype == w.dtype and got.shape == w.shape, k
            assert got.tobytes() == w.tobytes(), k


def test_flatten_gives_the_jax_key_paths():
    tree = {"od": collections.OrderedDict(z=1, a=2), "t": (3, None, 4)}
    assert [k for k, _ in ck._flatten(tree)] == \
        ["['od']['z']", "['od']['a']", "['t'][0]", "['t'][2]"]
    NT = collections.namedtuple("NT", "a b")
    for t in (_tree_nested(), _tree_ordered(), {"n": NT(1, [2, None, 3]),
                                               "x": {"b": 1, "a": 2}}):
        want = [jax.tree_util.keystr(p) for p, _ in
                jax.tree_util.tree_flatten_with_path(t)[0]]
        assert [k for k, _ in ck._flatten(t)] == want


def test_restore_like_rebuilds_a_state_dict(tmp_path):
    """model.load_state_dict(restore_checkpoint(p, like=model.state_dict()))
    works: the OrderedDict comes back in the model's key order."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(7, 5),
                                torch.nn.BatchNorm1d(5),
                                torch.nn.Linear(5, 3))
    path = str(tmp_path / "m.strom")
    save_checkpoint(path, model.state_dict())
    other = torch.nn.Sequential(torch.nn.Linear(7, 5),
                                torch.nn.BatchNorm1d(5),
                                torch.nn.Linear(5, 3))
    sd = restore_checkpoint(path, like=other.state_dict(), device="cpu")
    assert list(sd) == list(model.state_dict())
    other.load_state_dict(sd)
    for a, b in zip(model.state_dict().values(),
                    other.state_dict().values()):
        assert torch.equal(a, b)
    # and the JAX package reads the port's state_dict file
    got = jdata.restore_checkpoint(path)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(np.asarray(got[f"[{k!r}]"]),
                                      v.numpy())


def test_restore_like_nested_tree(tmp_path):
    tree = _tree_nested()
    path = str(tmp_path / "n.strom")
    save_checkpoint(path, tree)
    out = restore_checkpoint(path, like=tree, device="cpu")
    assert out["skip"] is None and out["layers"][0]["b"] is None
    assert isinstance(out["layers"][1], tuple)
    assert out["layers"][1][1] is None
    np.testing.assert_array_equal(out["layers"][0]["w"].numpy(),
                                  tree["layers"][0]["w"])
    assert float(out["layers"][1][2]) == 2.5


@pytest.mark.parametrize("staging", [16 << 10, 64 << 10])
@pytest.mark.parametrize("k", [1, 3, 64])
def test_streamed_restore_equals_reference(tmp_path, staging, k):
    """Leaves larger than the staging buffer land span by span in place,
    at every landing width (scan_dispatch_batch) and ring width."""
    tree = _tree_mixed()
    path = str(tmp_path / "s.strom")
    jdata.save_checkpoint(path, tree)
    tcfg.set("scan_dispatch_batch", k)
    tcfg.set("h2d_depth_max", 5)
    mine = restore_checkpoint(path, staging_bytes=staging, device="cpu",
                              verify=True)
    jcfg.set("scan_dispatch_batch", k)
    ref = jdata.restore_checkpoint(path, staging_bytes=staging)
    for key, leaf in ck._flatten(tree):
        want = np.asarray(leaf)
        assert mine[key].numpy().tobytes() == want.tobytes()
        assert mine[key].shape == want.shape == np.asarray(ref[key]).shape
        if want.dtype.itemsize < 8:     # the JAX package keeps 32 bits
            assert np.asarray(ref[key]).tobytes() == want.tobytes()


def test_grid_pieces_cover_the_span():
    for start, n in [(4096, 4096), (4096, 3 << 20), (0, 1 << 20),
                     ((1 << 20) + 8192, (5 << 20) + 4096), (8192, 64 << 20),
                     (69632, 12 << 20), (65536, 61440)]:
        pieces = ck._grid_pieces(start, n)
        pos = start
        for chunk, ids, off in pieces:
            assert off == pos - start and ids[0] * chunk == pos
            assert ids == list(range(ids[0], ids[0] + len(ids)))
            pos += len(ids) * chunk
        assert pos == start + n
        assert len(pieces) <= 5
        # fewer than 16 chunks of a finer grid on either side
        assert all(len(ids) < 16 for chunk, ids, _ in pieces
                   if chunk < ck._GRIDS[-1])


def test_sharded_restore_equals_reference(tmp_path):
    """A leading-axis split over 8 x cpu: each member holds the rows the
    JAX package's P("dp") shard holds; replicated leaves and scalars land
    whole on every member."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((32, 96)).astype(np.float32),
            "v": rng.standard_normal((16, 64)).astype(np.float32),
            "s": np.int32(9)}
    path = str(tmp_path / "sh.strom")
    save_checkpoint(path, tree)
    mesh = make_scan_mesh(["cpu"] * 8)
    split, repl = RingSharding(mesh), RingSharding(mesh, axis=None)
    out = restore_checkpoint(path, staging_bytes=16 << 10, shardings={
        "['w']": split, "['v']": repl, "['s']": split})
    jm = jax_mesh(jax.devices()[:8], sp=1)
    from jax.sharding import NamedSharding, PartitionSpec as P
    ref = jdata.restore_checkpoint(path, shardings={
        "['w']": NamedSharding(jm, P("dp", None))})
    w = out["['w']"]
    assert isinstance(w, ShardedTensor) and w.shape == (32, 96)
    for mine_s, ref_s in zip(w.shards, sorted(
            ref["['w']"].addressable_shards,
            key=lambda s: s.index[0].start)):
        np.testing.assert_array_equal(mine_s.numpy(), np.asarray(ref_s.data))
    for s in out["['v']"].shards:
        np.testing.assert_array_equal(s.numpy(), tree["v"])
    assert [int(s) for s in out["['s']"].shards] == [9] * 8
    np.testing.assert_array_equal(w.full().numpy(), tree["w"])


def test_sharded_save_matches_the_plain_writer(tmp_path):
    """save_checkpoint_sharded writes each shard's rows in place: data
    sections byte-identical to the plain writer, the leaf table equal but
    for the crc32c, and both packages restore it."""
    mesh = make_scan_mesh(["cpu"] * 8)
    w = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    shards = [torch.from_numpy(w[2 * i:2 * i + 2].copy()) for i in range(8)]
    tree = {"w": ShardedTensor(shards, RingSharding(mesh)),
            "r": ShardedTensor([torch.from_numpy(w.copy())] * 8,
                               RingSharding(mesh, axis=None)),
            "step": np.int32(9)}
    path = str(tmp_path / "s.strom")
    assert save_checkpoint_sharded(path, tree)["leaves"] == 3
    ref = str(tmp_path / "ref.strom")
    jdata.save_checkpoint(ref, {"w": w, "r": w, "step": np.int32(9)})
    meta, ref_meta = checkpoint_info(path), checkpoint_info(ref)
    assert [{k: v for k, v in e.items() if k != "crc32c"}
            for e in ref_meta["leaves"]] == meta["leaves"]
    with open(path, "rb") as a, open(ref, "rb") as b:
        a.seek(meta["data_offset"])
        b.seek(ref_meta["data_offset"])
        assert a.read() == b.read()
    back = restore_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(back["['w']"].numpy(), w)
    jback = jdata.restore_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(jback["['r']"]), w)
    # the plain writer takes a ShardedTensor too, gathered
    plain = str(tmp_path / "p.strom")
    save_checkpoint(plain, tree)
    assert open(plain, "rb").read() == open(ref, "rb").read()
    assert not [p for p in os.listdir(tmp_path) if "shared_tmp" in p]


def test_second_axis_sharding_is_refused(tmp_path):
    """The second-axis restore (``tests/test_data.py:180``) reads each
    unique leading row range once and slices the other axes per member:
    ``("dp", "sp")`` on an ``(sp, dp)`` mesh and ``(None, "dp")`` on a
    one-axis ring give shards equal to the JAX package's, and ``full()``
    reassembles the leaf.  What stays refused: a column-split save (the
    reference's "leading-axis" error, ``tests/test_data.py:544``), ``sp``
    that does not divide the members, and an uneven leading split."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(6)
    w = rng.standard_normal((8, 32)).astype(np.float32)
    path = str(tmp_path / "a.strom")
    save_checkpoint(path, {"w": w, "s": np.int32(3)})
    for sp, spec, jspec in ((2, ("dp", "sp"), P("dp", "sp")),
                            (4, ("dp", "sp"), P("dp", "sp")),
                            (1, (None, "dp"), P(None, "dp"))):
        mesh = make_scan_mesh(["cpu"] * 8, sp=sp)
        sh = RingSharding(mesh, spec=spec)
        out = restore_checkpoint(path, shardings=sh)
        leaf = out["['w']"]
        assert isinstance(leaf, ShardedTensor) and leaf.shape == w.shape
        np.testing.assert_array_equal(leaf.full().numpy(), w)
        jsh = NamedSharding(jax_mesh(jax.devices()[:8], sp=sp), jspec)
        ref = jdata.restore_checkpoint(path,
                                       shardings={"['w']": jsh})["['w']"]
        want = {d: np.asarray(s.data) for s in ref.addressable_shards
                for d in [s.device]}
        for i, (idx, got) in enumerate(zip(sh.indices(w.shape),
                                           leaf.shards)):
            jdev = jsh.mesh.devices.reshape(-1)[i]
            np.testing.assert_array_equal(got.numpy(), want[jdev])
            np.testing.assert_array_equal(got.numpy(), w[idx])
        assert int(out["['s']"].shards[0]) == 3     # a scalar replicates
    # (None, "dp") on a one-axis ring is the reference's P(None, "dp")
    assert RingSharding(make_scan_mesh(["cpu"] * 4), axis=1).spec == \
        (None, "dp")
    mesh = make_scan_mesh(["cpu"] * 4)
    cols = ShardedTensor([torch.zeros(8, 8)] * 4, RingSharding(mesh, axis=1))
    assert cols.shape == (8, 32)
    with pytest.raises(StromError, match="leading-axis") as e:
        save_checkpoint_sharded(str(tmp_path / "c.strom"), {"w": cols})
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError) as e:
        make_scan_mesh(["cpu"] * 4, sp=3)
    assert e.value.errno == errno.EINVAL
    # an uneven split is refused, on either axis, before anything is read
    for sh in (RingSharding(make_scan_mesh(["cpu"] * 3)),
               RingSharding(make_scan_mesh(["cpu"] * 6, sp=3),
                            spec=("dp", "sp"))):
        with pytest.raises(StromError) as e:
            restore_checkpoint(path, shardings=sh)
        assert e.value.errno == errno.EINVAL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_dtypes_numpy_lacks_are_refused_before_a_temp_file(tmp_path, dtype):
    """bfloat16 and float8 have no numpy dtype string: EINVAL naming the
    leaf, with no temp file left (the JAX package cannot save bfloat16
    either)."""
    tree = {"ok": torch.zeros(4), "bad": torch.zeros(8).to(dtype)}
    for direct in (False, True):
        with pytest.raises(StromError) as e:
            save_checkpoint(str(tmp_path / "x.strom"), tree, direct=direct)
        assert e.value.errno == errno.EINVAL and "['bad']" in str(e.value)
    assert os.listdir(tmp_path) == []
    import jax.numpy as jnp
    with pytest.raises(ValueError):     # the reference's own refusal
        jdata.save_checkpoint(str(tmp_path / "j.strom"),
                              {"w": jnp.arange(8, dtype=jnp.bfloat16)})


def test_bad_magic_and_version(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"\0" * 64)
    with pytest.raises(StromError) as e:
        checkpoint_info(str(p))
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError):
        restore_checkpoint(str(p), device="cpu")


def _flip(path, leaf=0, at=100):
    meta = checkpoint_info(path)
    off = meta["data_offset"] + meta["leaves"][leaf]["offset"] + at
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return meta["leaves"][leaf]["key"]


@pytest.mark.parametrize("staging", [64 << 20, 16 << 10])
def test_verify_names_the_corrupt_leaf(tmp_path, staging):
    """A flipped bit: verify=True raises EBADMSG naming the leaf on the
    whole-leaf and the streamed path; without verify the bytes differ
    (the reference's behaviour)."""
    rng = np.random.default_rng(13)
    tree = {"a": np.ones(5, np.float32),
            "w": rng.standard_normal((64, 64)).astype(np.float32)}
    path = str(tmp_path / "c.strom")
    jdata.save_checkpoint(path, tree)
    key = _flip(path, leaf=1, at=5000)
    with pytest.raises(StromError) as e:
        restore_checkpoint(path, verify=True, device="cpu",
                           staging_bytes=staging)
    assert e.value.errno == errno.EBADMSG and key in str(e.value)
    out = restore_checkpoint(path, device="cpu", staging_bytes=staging)
    assert not np.array_equal(out[key].numpy(), tree["w"])
    with pytest.raises(JStromError) as e:
        jdata.restore_checkpoint(path, verify=True)
    assert e.value.errno == errno.EBADMSG


def test_streamed_restore_surfaces_read_faults(tmp_path):
    """A direct-read fault mid-stream surfaces as StromError (no partial
    tree), and the next restore works."""
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal((3000, 50)).astype(np.float32)}
    path = str(tmp_path / "f.strom")
    save_checkpoint(path, tree)

    class Failing(PlainSource):
        """A dead region at 128 KiB: its direct and buffered legs fail,
        so the fault ladder's retries and fallback end in EIO."""

        def read_member_direct(self, member, file_off, dest):
            if file_off <= (128 << 10) < file_off + len(dest):
                raise StromError(errno.EIO, "injected read error")
            super().read_member_direct(member, file_off, dest)

        def read_member_buffered(self, member, file_off, dest):
            if file_off <= (128 << 10) < file_off + len(dest):
                raise StromError(errno.EIO, "injected read error")
            super().read_member_buffered(member, file_off, dest)

    real = ck.open_source
    ck.open_source = lambda p: Failing(p, 512)
    try:
        with pytest.raises(StromError) as e:
            restore_checkpoint(path, staging_bytes=64 << 10, device="cpu")
        assert e.value.errno == errno.EIO
    finally:
        ck.open_source = real
    out = restore_checkpoint(path, staging_bytes=64 << 10, device="cpu")
    np.testing.assert_array_equal(out["['w']"].numpy(), tree["w"])


def test_save_is_crash_safe(tmp_path):
    path = str(tmp_path / "ck.strom")
    good = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    save_checkpoint(path, good)

    class Boom:
        dtype = np.dtype(np.float32)
        shape = (4,)

        def __array__(self, dtype=None, copy=None):
            raise RuntimeError("leaf serialization boom")

    for direct in (False, True):
        with pytest.raises(RuntimeError):
            save_checkpoint(path, {"w": Boom()}, direct=direct)
    out = restore_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(out["['w']"].numpy(), good["w"])
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_save_writes_through_a_symlink(tmp_path):
    target = str(tmp_path / "step-1000.strom")
    link = str(tmp_path / "latest.strom")
    save_checkpoint(target, {"w": torch.zeros(8)})
    os.symlink(target, link)
    save_checkpoint(link, {"w": torch.arange(8, dtype=torch.float32)},
                    direct=True)
    assert os.path.islink(link)
    out = restore_checkpoint(target, device="cpu")
    assert torch.equal(out["['w']"], torch.arange(8, dtype=torch.float32))


def test_save_honours_the_umask(tmp_path):
    path = str(tmp_path / "perm.strom")
    old = os.umask(0o027)
    try:
        save_checkpoint(path, {"w": torch.zeros(4)})
    finally:
        os.umask(old)
    assert os.stat(path).st_mode & 0o777 == 0o640


def test_save_sweeps_only_stale_temps(tmp_path):
    path = str(tmp_path / "ck.strom")
    fresh = tmp_path / "ck.strom.tmp.live1"
    fresh.write_bytes(b"\0" * 128)
    old = tmp_path / "ck.strom.tmp.dead1"
    old.write_bytes(b"\0" * 4096)
    os.utime(old, (1, 1))   # ancient: cannot be a live concurrent save
    save_checkpoint(path, {"w": np.zeros(4, np.float32)})
    assert fresh.exists() and not old.exists() and os.path.exists(path)


def test_strom_ckpt_info_and_verify_on_a_jax_file(tmp_path, capsys):
    tree = _tree_data()
    path = str(tmp_path / "cli.strom")
    jdata.save_checkpoint(path, tree)
    assert strom_ckpt.main(["info", path]) == 0
    out = capsys.readouterr().out
    assert "4 leaves" in out and "['w']" in out
    assert strom_ckpt.main(["verify", "-d", "cpu", path]) == 0
    assert "all 4 leaves OK" in capsys.readouterr().out
    assert strom_ckpt.main(["bench", "-d", "cpu", path]) == 0
    assert "GB/s on cpu" in capsys.readouterr().out
    _flip(path)
    assert strom_ckpt.main(["verify", "-d", "cpu", path]) == 1
    assert "crc32c mismatch" in capsys.readouterr().err


def test_checkpoint_sharded_second_axis(tmp_path):
    """``tests/test_data.py:180`` on the port: ``P("dp", "sp")`` over an
    ``(sp=4, dp=2)`` mesh of 8 CPU members restores the leaf, each shard
    its slice; the save of a leading split over an ``(sp, dp)`` mesh
    writes each dp block once and equals the plain save, byte for byte."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((8, 32)).astype(np.float32)
    path = str(tmp_path / "ck4.strom")
    save_checkpoint(path, {"w": w})
    mesh = make_scan_mesh(["cpu"] * 8, sp=4)
    assert mesh.shape == {"sp": 4, "dp": 2}
    sh = RingSharding(mesh, spec=("dp", "sp"))
    leaf = restore_checkpoint(path, shardings=sh)["['w']"]
    assert leaf.shape == (8, 32) and leaf.sharding is sh
    assert [tuple(s.shape) for s in leaf.shards] == [(4, 8)] * 8
    np.testing.assert_array_equal(leaf.full().numpy(), w)
    for i, s in enumerate(leaf.shards):
        d, lane = i % 2, i // 2
        np.testing.assert_array_equal(
            s.numpy(), w[4 * d:4 * d + 4, 8 * lane:8 * lane + 8])
    # a leading split on the (sp, dp) mesh: lanes replicate dp blocks
    two = make_scan_mesh(["cpu"] * 4, sp=2)
    rows = restore_checkpoint(path, shardings=RingSharding(two))["['w']"]
    assert rows.shards[2] is rows.shards[0]     # one device: one tensor
    out = str(tmp_path / "rows.strom")
    save_checkpoint_sharded(out, {"w": rows})
    plain = str(tmp_path / "plain.strom")
    save_checkpoint(plain, {"w": w})
    a, b = checkpoint_info(out), checkpoint_info(plain)
    with open(out, "rb") as f, open(plain, "rb") as g:
        f.seek(a["data_offset"])
        g.seek(b["data_offset"])
        assert f.read() == g.read()
    with pytest.raises(StromError) as e:
        RingSharding(two, spec=("dp", "dp"))
    assert e.value.errno == errno.EINVAL
