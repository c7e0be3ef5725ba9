"""The port's weight streaming (``serving/weights.py``) and its cold-start
gate against the JAX package on the same bytes: the counterparts of
``tests/test_serving.py``'s streaming tests (byte identity and layer
order, depth, the crc refusal, ``verify=False``) and its HBM-tier tests
(admit and LRU, a pinned lease, demotion into the RAM tier, the resident
fraction), the span plan and layer labels of several checkpoints,
checkpoints read across the packages both ways, the serving knobs and
counters, and the sharded cold start with its handshake
(``tests/test_shardload.py``'s cold-start test takes its oracle from the
JAX package's ``stream_weights``: the JAX sharded form fails on this JAX,
``check_rep``).  The plan's ``hbm-resident`` share
(``tests/test_serving.py:332``) is held by
``test_torch_tiering.py::test_plan_hit_ratios_match_reference``."""

import errno
import os
from collections import OrderedDict

import numpy as np
import pytest
import torch

import nvme_strom_tpu.serving.weights as jw
import nvme_strom_tpu.testing.coldstart_gate as jgate
from nvme_strom_tpu.api import STAT_FIELDS, StromError as JStromError
from nvme_strom_tpu.cache import residency_cache as jcache
from nvme_strom_tpu.config import config as jcfg
from nvme_strom_tpu.data.checkpoint import (checkpoint_info as jinfo,
                                            save_checkpoint as jsave)
from nvme_strom_tpu.serving.hbm_tier import hbm_tier as jhbm
from nvme_strom_tpu.stats import stats as jstats
from nvme_strom_tpu.trace import recorder as jrec
import nvme_strom_tpu_torch.serving.weights as tw
from nvme_strom_tpu_torch.api import SERVING_COUNTERS, StromError
from nvme_strom_tpu_torch.cache import residency_cache as tcache
from nvme_strom_tpu_torch.config import config as tcfg
from nvme_strom_tpu_torch.data.checkpoint import (checkpoint_info as tinfo,
                                                  save_checkpoint as tsave)
from nvme_strom_tpu_torch.hbm.registry import registry
from nvme_strom_tpu_torch.serving.hbm_tier import hbm_tier as thbm
from nvme_strom_tpu_torch.stats import stats as tstats
from nvme_strom_tpu_torch.testing import coldstart_gate, reset_residency
from nvme_strom_tpu_torch.trace import recorder as trec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXT = 64 << 10          # tier-test extent size


@pytest.fixture(autouse=True)
def _port_state():
    snap = tcfg.snapshot()
    reset_residency()
    # the JAX package's Sessions on its python pool: nothing here waits
    # on its native library
    jcfg.set("io_backend", "python")
    handles = set(registry.list())
    yield
    tcfg.restore(snap)
    reset_residency()
    trec.configure()
    trec.clear()
    tw._digest_drop_host = None
    assert set(registry.list()) == handles, "a streamed layer leaked"


def _trace_all():
    for cfg, rec in ((jcfg, jrec), (tcfg, trec)):
        cfg.set("trace_policy", "all")
        rec.configure()
        rec.clear()


def _spans(rec, name="weight_stream"):
    return sorted((e for e in rec.snapshot_events() if e[2] == name),
                  key=lambda e: e[0])


def _np_tree(n_layers=4, n_el=2048, seed=3):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.standard_normal(n_el).astype(np.float32),
                        "b": rng.standard_normal(n_el // 16)
                        .astype(np.float32)}
                       for _ in range(n_layers)]}


def _torch_tree(tree):
    return {"layers": [{k: torch.from_numpy(v) for k, v in ly.items()}
                       for ly in tree["layers"]]}


def _ckpt(tmp_path, n_layers=4, n_el=2048, name="model.ckpt"):
    """The test_serving.py checkpoint, saved by the JAX package."""
    tree = _np_tree(n_layers, n_el)
    path = str(tmp_path / name)
    jsave(path, tree)
    return path, tree


def _gpt2_small(n_layer=3, e=64, vocab=97, pos=32, seed=5):
    """A GPT2LMHeadModel-shaped state_dict at a small width."""
    g = torch.Generator().manual_seed(seed)
    sd = OrderedDict()

    def put(name, *shape):
        sd[name] = torch.randn(*shape, generator=g)

    put("transformer.wte.weight", vocab, e)
    put("transformer.wpe.weight", pos, e)
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        put(p + "ln_1.weight", e)
        put(p + "attn.c_attn.weight", e, 3 * e)
        put(p + "attn.c_attn.bias", 3 * e)
        put(p + "mlp.c_fc.weight", e, 4 * e)
    put("transformer.ln_f.weight", e)
    put("transformer.ln_f.bias", e)
    return sd


def _leaves(model, keys):
    out = {}
    for k in keys:
        v = model.leaf(k)
        out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _flip(path, back=4097):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - back)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x5A]))


# -- knobs and counters -------------------------------------------------------

@pytest.mark.parametrize("value,ok", [(0, False), (1, True), (2, True),
                                      (16, True), (17, False)])
def test_weight_stream_depth_validates_like_the_reference(value, ok):
    for cfg in (jcfg, tcfg):
        if ok:
            cfg.set("weight_stream_depth", value)
            assert cfg.get("weight_stream_depth") == value
        else:
            with pytest.raises(Exception):
                cfg.set("weight_stream_depth", value)


def test_serving_counters_are_the_references():
    assert set(SERVING_COUNTERS) <= set(STAT_FIELDS)
    assert len(set(SERVING_COUNTERS)) == len(SERVING_COUNTERS)


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("key", [
    "['transformer.h.12.attn.c_attn.weight']", "['transformer.wte.weight']",
    "['layers'][3]['w']", "model.layers.7.mlp.down_proj.weight",
    "['blocks'][7]", "blocks.2.norm", "layer_3.w", "encoder.layer.11.out",
    "lm_head.weight", "['h'][0]", "head.bias", "['ln_f']"])
def test_layer_labels_match_the_reference(key):
    assert tw._layer_of(key) == jw._layer_of(key)


def _plan(mod, meta):
    return [(ly.index, ly.label, ly.base, ly.nbytes,
             [(e["key"], e["abs"], e["nbytes"], e["crc32c"])
              for e in ly.leaves]) for ly in mod._plan_layers(meta)]


@pytest.mark.parametrize("which", ["layers", "gpt2", "mixed"])
def test_span_plan_matches_the_reference(which, tmp_path):
    """Bases, lengths, labels and leaves of every span, on files saved by
    each package (the same file format)."""
    path = str(tmp_path / "p.ckpt")
    if which == "layers":
        jsave(path, _np_tree(5))
    elif which == "gpt2":
        tsave(path, _gpt2_small())
    else:
        tsave(path, {"emb": torch.arange(5000, dtype=torch.int64),
                     "blocks": [{"q": torch.ones(300, dtype=torch.float16),
                                 "m": torch.zeros(7, dtype=torch.bool),
                                 "s": torch.tensor(3, dtype=torch.int8)}
                                for _ in range(3)],
                     "head": torch.ones(2, 3)})
    plan = _plan(tw, tinfo(path))
    assert plan == _plan(jw, jinfo(path))
    if which == "gpt2":
        assert len(plan) == 3 + 2
        assert [p[1] for p in plan] == [None, 0, 1, 2, None]


# -- streaming ----------------------------------------------------------------

def test_stream_weights_byte_identity_and_layer_order(tmp_path):
    """test_serving.py:135 on both packages: every leaf equal to the tree
    and to the JAX streamer's, spans in layer order, the gauge set."""
    path, tree = _ckpt(tmp_path)
    _trace_all()
    jm = jw.stream_weights(path)
    tm = tw.stream_weights(path, device="cpu")
    try:
        keys = tm.keys()
        assert keys == jm.keys()
        got, want = _leaves(tm, keys), _leaves(jm, keys)
        for k in keys:
            np.testing.assert_array_equal(got[k], want[k])
        for i, ly in enumerate(tree["layers"]):
            np.testing.assert_array_equal(got[f"['layers'][{i}]['w']"],
                                          ly["w"])
        orders = [[e[8]["layer"] for e in _spans(rec)] for rec in (jrec, trec)]
        assert orders[0] == orders[1] == [0, 1, 2, 3]
        assert [(e[6], e[7]) for e in _spans(trec)] == \
            [(e[6], e[7]) for e in _spans(jrec)]
        assert tstats.snapshot().get("coldstart_bytes_per_sec", 0) > 0
    finally:
        tm.close()
        jm.close()


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_stream_weights_depth_pipelines_but_adopts_in_order(depth, tmp_path):
    """test_serving.py:157: layers land in order at any depth, as the JAX
    package's."""
    path, tree = _ckpt(tmp_path, n_layers=8)
    _trace_all()
    jm = jw.stream_weights(path, depth=depth)
    tm = tw.stream_weights(path, device="cpu", depth=depth)
    try:
        for rec in (jrec, trec):
            assert [e[8]["layer"] for e in _spans(rec)] == list(range(8))
        assert torch.equal(tm.leaf("['layers'][7]['b']"),
                           torch.from_numpy(tree["layers"][7]["b"]))
    finally:
        tm.close()
        jm.close()


def test_stream_weights_crc_refusal(tmp_path):
    """test_serving.py:172: a flipped byte is EBADMSG naming the crc32c
    in both packages, and the port unwinds every layer it handed out."""
    path, _tree = _ckpt(tmp_path)
    _flip(path)
    with pytest.raises(JStromError) as je:
        jw.stream_weights(path)
    with pytest.raises(StromError) as te:
        tw.stream_weights(path, device="cpu", depth=2)
    assert je.value.errno == te.value.errno == errno.EBADMSG
    assert "crc32c" in str(te.value) and "crc32c" in str(je.value)


def test_stream_weights_verify_off_streams_corrupt_bytes(tmp_path):
    """test_serving.py:185: ``verify=False`` lands the flipped byte, the
    same bytes in both packages."""
    path, tree = _ckpt(tmp_path)
    _flip(path)
    jm = jw.stream_weights(path, verify=False)
    tm = tw.stream_weights(path, device="cpu", verify=False)
    try:
        keys = tm.keys()
        got, want = _leaves(tm, keys), _leaves(jm, keys)
        assert all(np.array_equal(got[k], want[k]) for k in keys)
        last = tree["layers"][-1]
        assert not (np.array_equal(got["['layers'][3]['w']"], last["w"])
                    and np.array_equal(got["['layers'][3]['b']"], last["b"]))
    finally:
        tm.close()
        jm.close()


def test_jax_saved_checkpoint_streams_in_the_port(tmp_path):
    """A checkpoint the JAX package saved, streamed by the port: every
    leaf equal to the JAX streamer's (dtypes the JAX package streams
    without x64)."""
    path = str(tmp_path / "j.ckpt")
    rng = np.random.default_rng(41)
    jsave(path, {"blocks": [{"k": rng.integers(-9, 9, (17, 5))
                             .astype(np.int32),
                             "v": rng.standard_normal((3, 129))
                             .astype(np.float16),
                             "g": rng.integers(0, 255, 4099)
                             .astype(np.uint8)} for _ in range(3)],
                 "norm": rng.standard_normal(33).astype(np.float32)})
    jm = jw.stream_weights(path)
    tm = tw.stream_weights(path, device="cpu")
    try:
        keys = jm.keys()
        got, want = _leaves(tm, keys), _leaves(jm, keys)
        for k in keys:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    finally:
        tm.close()
        jm.close()


def test_port_saved_state_dict_streams_in_the_jax_package(tmp_path):
    """A GPT-2-shaped state_dict the port saved, streamed by the JAX
    package: every leaf equal to the port streamer's and to the
    state_dict."""
    path = str(tmp_path / "t.ckpt")
    sd = _gpt2_small()
    tsave(path, sd)
    jm = jw.stream_weights(path)
    tm = tw.stream_weights(path, device="cpu")
    try:
        keys = tm.keys()
        got, want = _leaves(tm, keys), _leaves(jm, keys)
        for name, t in sd.items():
            k = f"[{name!r}]"
            np.testing.assert_array_equal(want[k], got[k])
            np.testing.assert_array_equal(got[k], t.numpy())
    finally:
        tm.close()
        jm.close()


def test_streamed_model_handles_leaves_and_close(tmp_path):
    path, tree = _ckpt(tmp_path)
    jm = jw.stream_weights(path)
    tm = tw.stream_weights(path, device="cpu")
    try:
        assert sorted(tm.handles) == sorted(jm.handles) == [0, 1, 2, 3]
        assert all(h in registry.list() for h in tm.handles.values())
        assert tm.total_bytes == jm.total_bytes
        for i in range(4):
            assert tm.layer_array(i).numel() == \
                np.asarray(jm.layer_array(i)).size
            assert tm.layer_array(i).dtype == torch.uint8
        # a leaf is a view of its layer's tensor, not a copy
        w = tm.leaf("['layers'][1]['w']")
        assert w.untyped_storage().data_ptr() == \
            tm.layer_array(1).untyped_storage().data_ptr()
        for m, err in ((jm, JStromError), (tm, StromError)):
            with pytest.raises(err) as e:
                m.leaf("['nope']")
            assert e.value.errno == errno.ENOENT
    finally:
        tm.close()
        jm.close()
    assert set(tm.handles.values()) == {0}


def test_stream_weights_without_a_card_is_enodev(tmp_path):
    """The default device is ``cuda:0``: with no card the port raises
    ENODEV rather than landing on the CPU."""
    path, _tree = _ckpt(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(StromError) as e:
        tw.stream_weights(path)
    assert e.value.errno == errno.ENODEV


# -- the sharded cold start ---------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_sharded_coldstart_identity_and_layer_order(hosts, tmp_path):
    """The sharded cold start on a ring of 4 x cpu: every leaf equal to
    the JAX streamer's, each host's layers handed out in order, and the
    handshake counted and traced as the JAX package counts it."""
    path, tree = _ckpt(tmp_path, n_layers=8)
    _trace_all()
    before = tstats.snapshot()
    jm = jw.stream_weights(path)
    tm = tw.stream_weights_sharded(path, hosts=hosts, devices=["cpu"] * 4)
    try:
        keys = jm.keys()
        got, want = _leaves(tm, keys), _leaves(jm, keys)
        for k in keys:
            np.testing.assert_array_equal(got[k], want[k])
        spans = _spans(trec)
        assert sorted(e[8]["layer"] for e in spans) == list(range(8))
        for h in range(hosts):
            mine = [e[8]["layer"] for e in spans if e[8]["host"] == h]
            assert mine == list(range(h, 8, hosts))
        gather = _spans(trec, "ici_permute")
        assert len(gather) == 1
        assert gather[0][8]["what"] == "weight_digest"
        assert gather[0][8]["hosts"] == hosts
        assert gather[0][8]["backend"] == "plain"
        after = tstats.snapshot()
        assert after.get("nr_ici_permute", 0) - \
            before.get("nr_ici_permute", 0) == hosts
        assert after.get("bytes_ici", 0) - before.get("bytes_ici", 0) == \
            hosts * hosts * 8 * 8
        assert after.get("coldstart_bytes_per_sec", 0) > 0
    finally:
        tm.close()
        jm.close()


@pytest.mark.parametrize("devices,hosts", [(["cpu"] * 4, 4),
                                           (["cpu"], 3)])
def test_sharded_handshake_fault_is_eio(devices, hosts, tmp_path):
    """A host whose digest row is missing (as if it adopted nothing)
    fails the handshake with EIO before a model is returned, and every
    layer is unmapped.  With one device and three hosts the handshake
    still runs over a ring of three: the JAX package skips it when it
    has fewer devices than hosts (``serving/weights.py:300-301``)."""
    path, _tree = _ckpt(tmp_path, n_layers=6)
    tw._digest_drop_host = hosts - 1
    with pytest.raises(StromError) as e:
        tw.stream_weights_sharded(path, hosts=hosts, devices=devices)
    assert e.value.errno == errno.EIO and "handshake" in str(e.value)
    tw._digest_drop_host = None
    m = tw.stream_weights_sharded(path, hosts=hosts, devices=devices)
    m.close()


def test_sharded_host_error_unwinds_every_host(tmp_path):
    """One host's crc refusal fails the whole cold start: EBADMSG, and
    the other hosts' layers unmapped."""
    path, _tree = _ckpt(tmp_path, n_layers=6)
    _flip(path)
    with pytest.raises(StromError) as e:
        tw.stream_weights_sharded(path, hosts=3, devices=["cpu"] * 3)
    assert e.value.errno == errno.EBADMSG
    with pytest.raises(StromError) as e:
        tw.stream_weights_sharded(path, hosts=0, devices=["cpu"])
    # 0 hosts means config shard_hosts, else one host
    assert e.value.errno == errno.EBADMSG


# -- the cold-start gate ------------------------------------------------------

def test_coldstart_gate_limits_are_the_references():
    assert coldstart_gate.RATIO_LIMIT == jgate.RATIO_LIMIT == 2.0
    assert coldstart_gate.ROUNDS == jgate.ROUNDS
    assert coldstart_gate.LATENCY_MS == jgate._LAT_S * 1e3
    assert (coldstart_gate._LAYER_BYTES, coldstart_gate._N_LAYERS,
            coldstart_gate._DEPTH) == (jgate._LAYER_BYTES, jgate._N_LAYERS,
                                       jgate._DEPTH)


def test_coldstart_gate_speedup_leg_on_the_cpu(tmp_path):
    """The gate's speedup, identity and order leg at its 2x limit.  Beside
    a parallel test run each layer's host work (planning, landing, the
    crc) takes milliseconds, and the streamed leg turns host-bound at a
    few ms of latency, so the injected latency is 30 ms a request here
    (the module run keeps the reference's 4 ms)."""
    ratio = coldstart_gate._leg_speedup_identity_order(
        str(tmp_path), torch.device("cpu"), 2.0, 3, 0.030)
    assert ratio >= 2.0


def test_coldstart_gate_crc_leg_on_the_cpu(tmp_path):
    coldstart_gate._leg_crc_refusal(str(tmp_path), torch.device("cpu"))


def test_coldstart_gate_main_writes_nothing_in_the_repo(capsys):
    before = set(os.listdir(ROOT))
    assert coldstart_gate.main(["-d", "cpu", "--latency-ms", "30"]) == 0
    assert set(os.listdir(ROOT)) == before
    assert "coldstart-gate ok" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert coldstart_gate.main([]) == 2


# -- tests/test_serving.py's HBM tier tests, both packages --------------------

def _tier_on(pkg, nbytes):
    cfg, hbm = (jcfg, jhbm) if pkg == "jax" else (tcfg, thbm)
    cfg.set("hbm_cache_bytes", nbytes)
    if pkg == "jax":
        hbm.configure()
    else:
        hbm.configure(device="cpu")
    return hbm


PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


@PKG
def test_tier_admit_lookup_identity_and_lru(pkg):
    """test_serving.py:49."""
    hbm = _tier_on(pkg, 4 * EXT)
    skey = ("#t1",)
    blobs = {i: bytes([i + 1]) * EXT for i in range(6)}
    for i in range(4):
        assert hbm.admit(skey, i * EXT, EXT, blobs[i])
    assert hbm.resident_bytes() == 4 * EXT
    lease = hbm.lookup(skey, 0, EXT)
    out = bytearray(EXT)
    assert lease.copy_into(out) and bytes(out) == blobs[0]
    lease.release()
    assert hbm.admit(skey, 4 * EXT, EXT, blobs[4])
    assert hbm.resident_bytes() <= 4 * EXT
    assert hbm.lookup(skey, 1 * EXT, EXT) is None
    keep = hbm.lookup(skey, 0, EXT)
    assert keep is not None
    keep.release()
    hbm.clear()


@PKG
def test_tier_pinned_lease_is_not_evictable_and_goes_stale_on_clear(pkg):
    """test_serving.py:71."""
    hbm = _tier_on(pkg, 2 * EXT)
    skey = ("#t2",)
    assert hbm.admit(skey, 0, EXT, b"\x11" * EXT)
    pin = hbm.lookup(skey, 0, EXT)
    assert hbm.admit(skey, EXT, EXT, b"\x22" * EXT)
    assert hbm.admit(skey, 2 * EXT, EXT, b"\x33" * EXT)
    out = bytearray(EXT)
    assert pin.copy_into(out) and bytes(out) == b"\x11" * EXT
    hbm.clear()
    assert pin.stale
    assert pin.copy_into(out) is False
    assert pin.device_array() is None
    pin.release()


@PKG
def test_tier_eviction_demotes_into_host_tier(pkg):
    """test_serving.py:89."""
    cfg, cache, stats = (jcfg, jcache, None) if pkg == "jax" else \
        (tcfg, tcache, tstats)
    counters = (lambda: dict(jstats.snapshot(reset_max=False).counters)) \
        if pkg == "jax" else tstats.snapshot
    cfg.set("cache_bytes", 32 << 20)
    cache.configure()
    hbm = _tier_on(pkg, 2 * EXT)
    skey = ("#t3",)
    before = counters()
    for i in range(3):
        assert hbm.admit(skey, i * EXT, EXT, bytes([i + 5]) * EXT)
    after = counters()
    assert after.get("nr_hbm_demote", 0) > before.get("nr_hbm_demote", 0)
    lease = cache.lookup(skey, 0, EXT)
    assert lease is not None
    dst = bytearray(EXT)
    lease.copy_into(dst)
    assert bytes(dst) == bytes([5]) * EXT
    lease.release()
    hbm.clear()
    cache.clear()


@PKG
def test_tier_resident_fraction_matches_admitted_share(pkg, tmp_path):
    """test_serving.py:109."""
    path = str(tmp_path / "w.bin")
    with open(path, "wb") as f:
        f.write(b"x" * (4 * EXT))
    hbm = _tier_on(pkg, 4 * EXT)
    skey = (os.path.realpath(path),)
    hbm.admit(skey, 0, EXT, b"a" * EXT)
    hbm.admit(skey, EXT, EXT, b"b" * EXT)
    assert abs(hbm.resident_fraction([path], 4 * EXT) - 0.5) < 1e-6
    assert hbm.resident_fraction(["/no/such"], 4 * EXT) == 0.0
    hbm.clear()


@pytest.mark.parametrize("piece", [4096, 8192, 1 << 20])
def test_piece_crc_folds_across_pieces(piece, tmp_path):
    """A card lands a span larger than a slot in pieces and folds each
    leaf's crc32c piece by piece: on the file's clean bytes every leaf
    checks whatever the cut, and a byte flipped inside a leaf that spans
    pieces is EBADMSG at the piece where that leaf ends."""
    path = str(tmp_path / "p.ckpt")
    rng = np.random.default_rng(9)
    jsave(path, {"layers": [{"a": rng.standard_normal(3 * 1024 + 25)
                             .astype(np.float32),
                             "b": rng.standard_normal(700)
                             .astype(np.float32)} for _ in range(2)]})
    layers = tw._plan_layers(tinfo(path))
    with open(path, "rb") as f:
        blob = bytearray(f.read())

    def fold(data):
        for st, off, n in tw._pieces(layers, piece):
            base = st.ly.base + off
            tw._verify_piece(path, st, off, memoryview(data)[base:base + n])

    fold(blob)
    leaf = layers[1].leaves[0]
    blob[leaf["abs"] + 5000] ^= 0x10
    with pytest.raises(StromError) as e:
        fold(blob)
    assert e.value.errno == errno.EBADMSG and leaf["key"] in str(e.value)
