"""The port's ``Query`` (``scan/query.py``) against the JAX package's
``Query.run()`` on the same heap table and the same packed sidecar:
aggregate, GROUP BY with HAVING, and the pushdown chip and host legs
forced by config.  The port runs with ``device="cpu"`` (its plain
versions); the JAX package on its CPU backend.

Tolerances: counts, integer sums (int32/uint32 wrap mod 2^32), mins, maxs
and HAVING's surviving groups exact; float sums within ``1e-5 * sum(|x|) +
1e-6`` and sums of squares within ``1e-5 * sum(x^2) + 1e-6`` (the two
sides add in another order); ``avgs`` within ``1e-5 * mean(|x|) + 1e-6``,
``vars`` within ``1e-5 * mean(x^2) + 1e-6`` (E[x²]−E[x]² of those sums).
The data here is finite: the NaN/±inf group rules are held to the Pallas
kernel in ``test_torch_groupby.py``."""

import errno

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu.scan.query import Query as JQuery
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.config import config
from nvme_strom_tpu_torch.ops import groupby_cuda
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.groupby import GroupKey
from nvme_strom_tpu_torch.scan.colpack import build_packed
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file
from nvme_strom_tpu_torch.scan.query import Query
from nvme_strom_tpu_torch.stats import stats

KW = dict(n_cols=5, visibility=True,
          dtypes=("int32", "int32", "int32", "uint32", "float32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)


@pytest.fixture()
def configs():
    """64 KiB chunks on both sides (several batches to fold), restored
    after the test."""
    snap, jsnap = config.snapshot(), jconfig.snapshot()
    config.set("chunk_size", 1 << 16)
    jconfig.set("chunk_size", 1 << 16)
    yield
    config.restore(snap)
    jconfig.restore(jsnap)


@pytest.fixture()
def table(tmp_path):
    rng = np.random.default_rng(11)
    n = SCHEMA.tuples_per_page * 37 + 5
    cols = [rng.integers(-6, 6, n).astype(np.int32),
            rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            .astype(np.int32),
            rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            .astype(np.int32),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
            (rng.standard_normal(n) * 10).astype(np.float32)]
    cols[1][:4] = [-(1 << 31), (1 << 31) - 1, -1, 0]
    vis = (rng.random(n) > 0.2).astype(np.int32)
    path = str(tmp_path / "t.heap")
    build_heap_file(path, cols, SCHEMA, visibility=vis)
    return path, cols, vis


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype.kind in "iu" else a


def _same_aggregate(got, want, selected_floats):
    assert int(got["count"]) == int(want["count"])
    assert len(got["sums"]) == len(want["sums"])
    for g, w, sel in zip(got["sums"], want["sums"], selected_floats):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        if g.dtype.kind == "f":
            tol = 1e-5 * float(np.abs(sel.astype(np.float64)).sum()) + 1e-6
            assert abs(float(g) - float(w)) <= tol
        else:
            assert int(_bits(g)) == int(_bits(w))


def test_aggregate_matches_jax(configs, table):
    path, cols, vis = table
    got = Query(path, SCHEMA).where(FilterPred(((0, "gt", 0),))) \
        .where(FilterPred(((4, "lt", 0.5),))).aggregate([0, 3, 4]) \
        .run(device="cpu")
    want = JQuery(path, JS).where(lambda c: c[0] > 0) \
        .where(lambda c: c[4] < 0.5).aggregate([0, 3, 4]).run()
    sel = (vis != 0) & (cols[0] > 0) & (cols[4] < 0.5)
    _same_aggregate(got, want, [None, None, cols[4][sel]])
    assert int(got["count"]) == int(sel.sum())
    # no projection: every column's sum, in schema order
    got = Query(path, SCHEMA).aggregate().run(device="cpu")
    want = JQuery(path, JS).aggregate().run()
    _same_aggregate(got, want, [None] * 4 + [cols[4][vis != 0]])


_GROUP_CASES = {
    # name: (port key, JAX key, G, agg cols, port where, JAX where, having)
    "i32 abs%7 where": (GroupKey(1, 7, True), lambda c: jnp.abs(c[1]) % 7, 7,
                        [0, 2], FilterPred(((0, "ge", -2),)),
                        lambda c: c[0] >= -2,
                        lambda g: g["count"] > np.median(g["count"])),
    "u32 %5": (GroupKey(1, 5), lambda c: c[1] % 5, 5, [3], None, None,
               lambda g: g["sums"][0] % 2 == 0),
    "f32 value key": (GroupKey(0), lambda c: c[0], 8, [4],
                      FilterPred(((4, "gt", -5.5),)), lambda c: c[4] > -5.5,
                      lambda g: g["avgs"][0] > 0),
    "f32 u32 key %16": (GroupKey(3, 16), lambda c: c[3] % 16, 16, [4], None,
                        None, None),
}


@pytest.mark.parametrize("case", sorted(_GROUP_CASES))
def test_group_by_with_having_matches_jax(configs, table, case):
    path, cols, vis = table
    key, jkey, G, agg, pred, jpred, having = _GROUP_CASES[case]
    q, jq = Query(path, SCHEMA), JQuery(path, JS)
    if pred is not None:
        q, jq = q.where(pred), jq.where(jpred)
    got = q.group_by(key, G, agg_cols=agg, having=having).run(device="cpu")
    want = jq.group_by(jkey, G, agg_cols=agg, having=having).run()
    assert sorted(got) == sorted(want)
    if having is not None:
        np.testing.assert_array_equal(got["groups"], want["groups"])
        assert 0 < len(got["groups"]) < G
    np.testing.assert_array_equal(got["count"], want["count"])
    for k in ("sums", "mins", "maxs"):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "sums" and g.dtype.kind == "f":
            continue
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)
    # float magnitudes per surviving group from the JAX result's own
    # counts: mean |x| and mean x^2 bound the derived fields
    cnt = np.maximum(want["count"], 1)
    sq = np.asarray(want["sumsqs"], np.float64)
    if np.asarray(got["sums"]).dtype.kind == "f":
        mag = np.abs(np.asarray(want["avgs"])) * cnt + np.sqrt(sq * cnt)
        assert (np.abs(got["sums"] - want["sums"]) <= 1e-5 * mag + 1e-6).all()
    assert (np.abs(got["sumsqs"] - sq) <= 1e-5 * sq + 1e-6).all()
    mean_sq = sq / cnt
    assert (np.abs(got["avgs"] - want["avgs"])
            <= 1e-5 * np.sqrt(mean_sq) + 1e-6).all()
    assert (np.abs(got["vars"] - want["vars"]) <= 1e-5 * mean_sq + 1e-6).all()
    np.testing.assert_allclose(got["stds"], np.sqrt(got["vars"]))


def test_callable_key_and_predicate_run_on_cpu(configs, table):
    path, _cols, _vis = table
    a = Query(path, SCHEMA).where(FilterPred(((0, "gt", 1),))) \
        .group_by(GroupKey(1, 6), 6, agg_cols=[2]).run(device="cpu")
    b = Query(path, SCHEMA).where(lambda c: c[0] > 1) \
        .group_by(lambda c: c[1].to(torch.int64) % 6, 6,
                  agg_cols=[2]).run(device="cpu")
    for k in ("count", "sums", "mins", "maxs"):
        np.testing.assert_array_equal(a[k], b[k])


def _packed_table(tmp_path, seed=5):
    rng = np.random.default_rng(seed)
    n = 70_000
    cols = [rng.integers(0, 16, n).astype(np.int32),
            (rng.integers(0, 8, n) * 1000 - 3000).astype(np.int32),
            (np.arange(n) // 900 + (1 << 31)).astype(np.uint32),
            rng.standard_normal(n).astype(np.float32)]
    vis = (rng.random(n) > 0.1).astype(np.int32)
    kw = dict(n_cols=4, visibility=True,
              dtypes=("int32", "int32", "uint32", "float32"))
    path = str(tmp_path / "p.heap")
    build_heap_file(path, cols, HeapSchema(**kw), visibility=vis)
    # the sidecar holds the visible rows only
    meta = build_packed(path, HeapSchema(**kw))
    assert [c.codec for c in meta.cols] == ["bitpack", "dict", "rle", "raw"]
    return path, [c[vis != 0] for c in cols], HeapSchema(**kw), JSchema(**kw)


def _force(leg):
    """Config on both sides that makes the pushdown rule pick *leg*."""
    for cfg in (config, jconfig):
        if leg == "raw":
            cfg.set("pushdown", "off")
        elif leg == "chip":
            cfg.set("pushdown", "on")
        else:
            cfg.set("pushdown", "auto")
            cfg.set("pushdown_h2d_gbps", 40.0)
            cfg.set("pushdown_ssd_gbps", 4.0)   # SSD-bound -> host


@pytest.mark.parametrize("with_pred", [True, False])
@pytest.mark.parametrize("leg", ["chip", "host"])
def test_pushdown_legs_match_jax_and_the_heap_scan(configs, tmp_path, leg,
                                                   with_pred):
    path, cols, schema, js = _packed_table(tmp_path)

    def port():
        q = Query(path, schema)
        if with_pred:
            q = q.where(FilterPred(((0, "ge", 8), (1, "ne", -1000))))
        return q.aggregate([1, 2, 3])

    def jax_q():
        q = JQuery(path, js)
        if with_pred:
            q = q.where(lambda c: (c[0] >= 8) & (c[1] != -1000))
        return q.aggregate([1, 2, 3])

    _force("raw")
    heap = port().run(device="cpu")
    _force(leg)
    plan = port().explain(device="cpu")
    assert plan.pushdown == leg and jax_q().explain().pushdown == leg
    assert "predicted wire bytes" in plan.reason
    before = stats.snapshot().get(f"nr_pushdown_decode_{leg}", 0)
    got = port().run(device="cpu")
    assert stats.snapshot().get(f"nr_pushdown_decode_{leg}", 0) > before
    want = jax_q().run()
    sel = (cols[0] >= 8) & (cols[1] != -1000) if with_pred \
        else np.ones(len(cols[0]), bool)
    _same_aggregate(got, want, [None, None, cols[3][sel]])
    _same_aggregate(got, heap, [None, None, cols[3][sel]])
    assert int(got["count"]) == int(sel.sum())
    assert int(_bits(got["sums"][1])) == \
        int(cols[2][sel].astype(np.uint64).sum() & 0xFFFFFFFF)


def test_explain_routing_and_refusals(configs, table):
    path, _cols, _vis = table
    plan = Query(path, SCHEMA).group_by(GroupKey(1, 8), 8, agg_cols=[0]) \
        .explain(device="cpu")
    assert (plan.kernel, plan.operator, plan.pushdown) == \
        ("torch", "group_by", "")
    plan = Query(path, SCHEMA).aggregate([0]).explain(device="cpu",
                                                      kernel="cuda")
    assert plan.kernel == "invalid" and "CUDA" in plan.reason
    with pytest.raises(StromError) as e:
        Query(path, SCHEMA).aggregate([0]).run(device="cpu", kernel="cuda")
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError) as e:
        Query(path, SCHEMA).where(FilterPred(((0, "gt", None),)))
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError):
        Query(path, SCHEMA).aggregate([0]).group_by(GroupKey(1), 4)
    bad = Query(path, SCHEMA).group_by(GroupKey(4), 4, agg_cols=[0]) \
        .explain(device="cpu")
    assert bad.kernel == "invalid" and "int32 or uint32" in bad.reason
    # what the CUDA kernels would refuse, named before any I/O
    q = Query(path, SCHEMA)
    q.group_by(GroupKey(1, 8), groupby_cuda.MAX_GROUPS + 1, agg_cols=[0])
    assert str(groupby_cuda.MAX_GROUPS) in q._cuda_refusal()
    q = Query(path, SCHEMA).group_by(lambda c: c[1] % 4, 4, agg_cols=[0])
    assert "callable" in q._cuda_refusal()
    q = Query(path, SCHEMA).where(lambda c: c[0] > 0).aggregate([0])
    assert "callable" in q._cuda_refusal()


@pytest.mark.parametrize("mode,h2d,ssd,chip_ratio,need", [
    ("on", 0.0, 0.0, 1.15, None), ("off", 0.0, 0.0, 1.15, None),
    ("auto", 1.0, 4.0, 1.15, None), ("auto", 4.0, 1.0, 1.15, (0, 3)),
    ("auto", 1.0, 4.0, 3.0, None), ("auto", 1.0, 4.0, 1.15, (3,))])
def test_decide_pushdown_matches_jax(configs, tmp_path, mode, h2d, ssd,
                                     chip_ratio, need):
    from nvme_strom_tpu.scan.colpack import load_meta as jload
    from nvme_strom_tpu.scan.planner import decide_pushdown as jdecide
    from nvme_strom_tpu_torch.scan.colpack import probe_packed
    from nvme_strom_tpu_torch.scan.planner import decide_pushdown
    path, _cols, _schema, _js = _packed_table(tmp_path)
    meta = probe_packed(path)
    for cfg in (config, jconfig):
        cfg.set("pushdown", mode)
        cfg.set("pushdown_h2d_gbps", h2d or 40.0)
        cfg.set("pushdown_ssd_gbps", ssd or 4.0)
        cfg.set("pushdown_chip_ratio", chip_ratio)
    got = decide_pushdown(meta, need)
    want = jdecide(jload(meta.path), need)
    assert (got.mode, got.wire_bytes, got.logical_bytes, got.per_column) \
        == (want.mode, want.wire_bytes, want.logical_bytes,
            want.per_column)


def test_transport_rates_precedence(configs, monkeypatch):
    """Config overrides first, then the live host->device meter of the
    scan pipeline (h2d only), then the defaults measured on the card."""
    from nvme_strom_tpu_torch.hbm import staging
    from nvme_strom_tpu_torch.scan import planner
    meter = staging.H2DRateMeter()
    monkeypatch.setattr(staging, "h2d_meter", meter)
    assert planner.transport_rates() == (planner.H2D_GBPS_DEFAULT,
                                         planner.SSD_GBPS_DEFAULT)
    meter.note(1 << 30, 10**9)              # 1 GiB blocked for 1 s
    assert planner.transport_rates() == (pytest.approx(1.0),
                                         planner.SSD_GBPS_DEFAULT)
    config.set("pushdown_h2d_gbps", 3.0)
    config.set("pushdown_ssd_gbps", 2.0)
    assert planner.transport_rates() == (3.0, 2.0)


# ---------------------------------------------------------------------------
# 64-bit GROUP BY sums (A2.10)
# ---------------------------------------------------------------------------

@pytest.fixture()
def x64():
    config.set("x64", True)
    yield
    config.set("x64", False)


@pytest.mark.parametrize("agg", [[0, 2], [3], [4]])
def test_x64_group_by_matches_jax_under_x64(configs, table, x64, agg):
    """The switch on: the port's GROUP BY against the reference's under
    jax_enable_x64 on the same table, dtypes and integer sums exact (no
    int32 wrap), against numpy int64 truth too."""
    import jax
    path, cols, vis = table
    got = Query(path, SCHEMA).where(FilterPred(((0, "ge", -2),))) \
        .group_by(GroupKey(1, 7, True), 7, agg_cols=agg).run(device="cpu")
    with jax.enable_x64(True):
        want = JQuery(path, JS).where(lambda c: c[0] >= -2) \
            .group_by(lambda c: jnp.abs(c[1]) % 7, 7, agg_cols=agg).run()
        want = {k: np.asarray(v) for k, v in want.items()}
    for k in ("count", "sums", "sumsqs", "mins", "maxs"):
        assert np.asarray(got[k]).dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["mins"], want["mins"])
    np.testing.assert_array_equal(got["maxs"], want["maxs"])
    key = np.abs(cols[1].astype(np.int64))
    key = np.where(cols[1] == -(1 << 31), cols[1], key) % 7
    sel = (vis != 0) & (cols[0] >= -2)
    for j, c in enumerate(agg):
        if SCHEMA.col_dtype(c).kind == "f":
            tol = 1e-5 * float(np.abs(cols[c][sel]).sum()) + 1e-6
            assert np.abs(got["sums"][j].astype(np.float64)
                          - want["sums"][j]).max() <= tol
        else:
            truth = [int(cols[c][sel & (key == g)].astype(np.int64).sum())
                     for g in range(7)]
            assert [int(v) for v in got["sums"][j]] == truth
            assert [int(v) for v in want["sums"][j]] == truth
        np.testing.assert_allclose(got["sumsqs"][j], want["sumsqs"][j],
                                   rtol=1e-12)


def test_x64_plan_names_the_refusal_and_workers_carry_it(configs, table,
                                                          x64):
    path, _cols, _vis = table
    q = Query(path, SCHEMA).group_by(GroupKey(1, 8), 8, agg_cols=[0])
    w = Query(path, SCHEMA).group_by_cols([0], agg_cols=[2])
    assert "x64" in q._cuda_refusal()
    assert w._worker_spec(torch.device("cpu"), "torch", None,
                          False)["x64"] is True
    config.set("x64", False)
    assert q._cuda_refusal() == ""
    assert w._worker_spec(torch.device("cpu"), "torch", None,
                          False)["x64"] is False


@pytest.mark.parametrize("ratio", [0.5, 2.0])
@pytest.mark.parametrize("agg", [[4], [2]], ids=["float32", "int32"])
def test_group_by_auto_plan_takes_the_measured_route(configs, table, ratio,
                                                     agg):
    """kernel='auto' on a CUDA device (planned without one): a float
    GROUP BY leaves B3 for the torch route when the torch/B3 time ratio is
    below 1.0, and the plan says why; an int GROUP BY keeps B3.  On the
    CPU the route is torch either way and the answer the same."""
    path = table[0]
    config.set("groupby_cuda_ratio", ratio)
    q = Query(path, SCHEMA).group_by(GroupKey(0, mod=8), 8, agg_cols=agg)
    plan = q._plan(torch.device("cuda"), "auto", None, 0)
    leaves = ratio < 1.0 and agg == [4]
    assert plan.kernel == ("torch" if leaves else "cuda")
    assert (f"measured torch/B3 time ratio {ratio:g} < 1.0"
            in plan.reason) == leaves
    cpu = q._plan(torch.device("cpu"), "auto", None, 0)
    assert cpu.kernel == "torch" and "ratio" not in cpu.reason



@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plan's cuda route exists "
                    "only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_x64_group_by_plans_torch_on_the_card(configs, table, x64,
                                               cuda_device):
    path, _cols, _vis = table
    plan = Query(path, SCHEMA).group_by(GroupKey(1, 8), 8, agg_cols=[0]) \
        .explain(device=cuda_device)
    assert plan.kernel == "torch" and "x64" in plan.reason
