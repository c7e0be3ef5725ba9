"""Page filter of the PyTorch port against the JAX package on the same
pages: the port's plain version (``ops/filter.py``, which is also what the
CUDA wrapper runs for a CPU tensor) against the Pallas kernel in interpret
mode, the XLA path and a numpy oracle.

Tolerances: counts and integer sums exact (int32/uint32 wrap mod 2^32 on
both sides); float32 sums within ``1e-5 * sum(|selected x|) + 1e-6``,
because the two sides add in a different order."""

import errno

import numpy as np
import pytest
import torch

from nvme_strom_tpu.ops import filter_xla
from nvme_strom_tpu.ops.filter_pallas import (make_filter_fn_pallas,
                                              scan_filter_step_pallas)
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.ops import filter_cuda
from nvme_strom_tpu_torch.ops.filter import (FilterPred, make_filter_fn,
                                             scan_filter_step)
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_pages


def _float_close(a, b, selected):
    tol = 1e-5 * float(np.abs(selected.astype(np.float64)).sum()) + 1e-6
    return abs(float(a) - float(b)) <= tol


def _demo(n_rows, seed):
    rng = np.random.default_rng(seed)
    schema = HeapSchema(n_cols=2, visibility=True)
    c0 = rng.integers(-1000, 1000, n_rows).astype(np.int32)
    c1 = rng.integers(0, 1 << 30, n_rows).astype(np.int32)
    vis = (rng.random(n_rows) > 0.25).astype(np.int32)
    return schema, c0, c1, vis, build_pages([c0, c1], schema, visibility=vis)


@pytest.mark.parametrize("threshold", [-2000, 0, 250, 2000])
def test_scan_filter_step_matches_pallas_xla_and_oracle(threshold):
    _, c0, c1, vis, pages = _demo(3000, 7)
    sel = (vis != 0) & (c0 > threshold)
    got = scan_filter_step(torch.from_numpy(pages), threshold)
    pal = scan_filter_step_pallas(pages, np.int32(threshold), interpret=True)
    xla = filter_xla.scan_filter_step(pages, np.int32(threshold))
    assert got["count"].dtype == torch.int32
    assert int(got["count"]) == int(pal["count"]) == int(xla["count"]) \
        == int(sel.sum())
    want = np.int32(np.uint32(c1[sel].astype(np.int64).sum() & 0xFFFFFFFF)
                    .view(np.int32))
    assert got["sum"].dtype == torch.int32
    assert int(got["sum"]) == int(pal["sum"]) == int(xla["sum"]) == want


def test_partial_block_matches_pallas():
    schema, c0, c1, vis, pages = _demo(HeapSchema(2, True).tuples_per_page
                                       * 3 + 11, 11)
    assert pages.shape[0] % 8 != 0
    got = filter_cuda.scan_filter_step_cuda(torch.from_numpy(pages), 0)
    pal = scan_filter_step_pallas(pages, np.int32(0), interpret=True)
    assert int(got["count"]) == int(pal["count"])
    assert int(got["sum"]) == int(pal["sum"])


def test_no_visibility_descriptor_and_callable_match_pallas():
    rng = np.random.default_rng(9)
    schema = HeapSchema(n_cols=1)
    c0 = rng.integers(-50, 50, 3000).astype(np.int32)
    pages = build_pages([c0], schema)
    pal = make_filter_fn_pallas(JSchema(n_cols=1),
                                lambda cols, th: cols[0] > th,
                                interpret=True)(pages, np.int32(0))
    t = torch.from_numpy(pages)
    desc = make_filter_fn(schema, FilterPred(((0, "gt", None),)))(t, 0)
    call = make_filter_fn(schema, lambda cols, th: cols[0] > th)(t, 0)
    for out in (desc, call):
        assert int(out["count"]) == int(pal["count"]) == int((c0 > 0).sum())
        assert int(out["sums"][0]) == int(pal["sums"][0])


def _typed(seed=17, pages=5):
    rng = np.random.default_rng(seed)
    js = JSchema(n_cols=3, visibility=True,
                 dtypes=("float32", "uint32", "int32"))
    ts = HeapSchema(n_cols=3, visibility=True,
                    dtypes=("float32", "uint32", "int32"))
    n = ts.tuples_per_page * pages + 13
    f = rng.standard_normal(n).astype(np.float32)
    u = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    i = rng.integers(-500, 500, n).astype(np.int32)
    vis = (rng.random(n) > 0.2).astype(np.int32)
    return js, ts, f, u, i, vis, build_pages([f, u, i], ts, visibility=vis)


def test_typed_columns_match_pallas_and_xla():
    js, ts, f, u, i, vis, pages = _typed()
    sel = (vis != 0) & (f > np.float32(0.25))
    pal = make_filter_fn_pallas(js, lambda cols, th: cols[0] > th,
                                interpret=True)(pages, np.float32(0.25))
    xla = filter_xla.make_filter_fn(js, lambda cols: cols[0] > 0.25)(pages)
    got = make_filter_fn(ts, FilterPred(((0, "gt", None),)))(
        torch.from_numpy(pages), 0.25)
    assert int(got["count"]) == int(pal["count"]) == int(xla["count"]) \
        == int(sel.sum())
    assert got["sums"][0].dtype == torch.float32
    assert _float_close(got["sums"][0], pal["sums"][0], f[sel])
    assert _float_close(got["sums"][0], xla["sums"][0], f[sel])
    assert got["sums"][1].dtype == torch.uint32
    assert int(got["sums"][1]) == int(pal["sums"][1]) == int(xla["sums"][1])
    assert int(got["sums"][2]) == int(pal["sums"][2]) == int(i[sel].sum())


def test_uint32_sum_wraps_like_pallas():
    schema = HeapSchema(n_cols=1, dtypes=("uint32",))
    n = schema.tuples_per_page * 2
    u = np.full(n, 0xF000_0000, dtype=np.uint32)
    pages = build_pages([u], schema)
    pal = make_filter_fn_pallas(JSchema(n_cols=1, dtypes=("uint32",)),
                                lambda cols, th: cols[0] > np.uint32(0),
                                interpret=True)(pages, np.uint32(0))
    got = make_filter_fn(schema, FilterPred(((0, "gt", 0),)))(
        torch.from_numpy(pages))
    assert int(got["sums"][0]) == int(pal["sums"][0]) \
        == (n * 0xF000_0000) % (1 << 32)


@pytest.mark.parametrize("op,fn", [
    ("gt", lambda a, b: a > b), ("ge", lambda a, b: a >= b),
    ("lt", lambda a, b: a < b), ("le", lambda a, b: a <= b),
    ("eq", lambda a, b: a == b), ("ne", lambda a, b: a != b)])
def test_filter_pred_matches_equivalent_callable(op, fn):
    _, ts, f, u, i, vis, pages = _typed(seed=23, pages=2)
    t = torch.from_numpy(pages)
    # a Python int of 2^31 would be refused, as jnp refuses it
    pred = FilterPred(((2, op, None), (1, "ge", np.uint32(1 << 31))))
    a = make_filter_fn(ts, pred)(t, 7)
    b = make_filter_fn(ts, lambda cols, th: fn(cols[2], th)
                       & (cols[1] >= (1 << 31)))(t, 7)
    sel = (vis != 0) & fn(i, 7) & (u >= np.uint32(1 << 31))
    assert int(a["count"]) == int(b["count"]) == int(sel.sum())
    for c in range(3):
        assert a["sums"][c].dtype == b["sums"][c].dtype
        assert float(a["sums"][c]) == float(b["sums"][c])


def test_two_term_and_empty_conjunctions_match_pallas():
    schema, c0, c1, vis, pages = _demo(4000, 5)
    js = JSchema(n_cols=2, visibility=True)
    t = torch.from_numpy(pages)
    pal = make_filter_fn_pallas(js, lambda cols, th: (cols[0] > th)
                                & (cols[1] < (1 << 29)),
                                interpret=True)(pages, np.int32(10))
    got = make_filter_fn(schema, FilterPred(((0, "gt", None),
                                             (1, "lt", 1 << 29))))(t, 10)
    assert int(got["count"]) == int(pal["count"])
    assert [int(s) for s in got["sums"]] == [int(s) for s in pal["sums"]]
    every = make_filter_fn(schema, FilterPred(()))(t)
    assert int(every["count"]) == int((vis != 0).sum())


def test_nullable_schema_matches_xla():
    rng = np.random.default_rng(4)
    kw = dict(n_cols=2, visibility=True, dtypes=("int32", "float32"),
              nullable=(True, True))
    js, ts = JSchema(**kw), HeapSchema(**kw)
    n = ts.tuples_per_page * 2 + 5
    a = rng.integers(-100, 100, n).astype(np.int32)
    b = rng.standard_normal(n).astype(np.float32)
    nulls = {0: rng.random(n) < 0.3, 1: rng.random(n) < 0.1}
    vis = (rng.random(n) > 0.2).astype(np.int32)
    pages = build_pages([a, b], ts, visibility=vis, nulls=nulls)
    xla = filter_xla.make_filter_fn(js, lambda cols: cols[0] > 0)(pages)
    got = make_filter_fn(ts, FilterPred(((0, "gt", 0),)))(
        torch.from_numpy(pages))
    assert int(got["count"]) == int(xla["count"])
    assert [int(x) for x in got["nncounts"]] == \
        [int(x) for x in xla["nncounts"]]
    assert int(got["sums"][0]) == int(xla["sums"][0])
    sel = (vis != 0) & (a > 0) & ~nulls[0] & ~nulls[1]
    assert _float_close(got["sums"][1], xla["sums"][1], b[sel])


def test_kernel_refusals_and_spec_encoding():
    typed = HeapSchema(n_cols=3, visibility=True,
                       dtypes=("float32", "uint32", "int32"))
    pred = FilterPred(((0, "gt", None), (1, "le", 7), (2, "ne", -1)))
    assert filter_cuda.kernel_refusal(typed, pred) == ""
    assert "callable" in filter_cuda.kernel_refusal(typed, lambda c, t: c[0])
    assert "nullable" in filter_cuda.kernel_refusal(
        HeapSchema(n_cols=1, nullable=(True,)), pred)
    assert "int64" in filter_cuda.kernel_refusal(
        HeapSchema(n_cols=1, dtypes=("int64",)), pred)
    spec = filter_cuda._spec(typed, pred, 0.25)
    assert (spec.n_cols, spec.terms.n) == (3, 3)
    assert spec.tuples == typed.tuples_per_page
    assert spec.vis_off == typed.col_word_range(3)[0]
    assert list(spec.col_off)[:3] == [typed.col_word_range(c)[0]
                                      for c in range(3)]
    assert list(spec.col_kind)[:3] == [2, 1, 0]
    assert list(spec.col_slot)[:3] == [0, 0, 1]
    assert list(spec.terms.op)[:3] == [0, 3, 5]
    assert list(spec.terms.kind)[:3] == [2, 1, 0]
    assert list(spec.terms.val)[:3] == [
        int(np.float32(0.25).view(np.uint32)), 7, 0xFFFFFFFF]


_PROMO_OPS = {"ge": lambda a, b: a >= b, "lt": lambda a, b: a < b,
              "eq": lambda a, b: a == b, "ne": lambda a, b: a != b}


@pytest.mark.parametrize("op", sorted(_PROMO_OPS))
@pytest.mark.parametrize("value", [0.25, -0.5, (1 << 24) + 0.5])
def test_float_value_against_int_column_compares_in_float32(op, value):
    """A fractional value against an int32 column compares in float32, as
    jnp promotes it (the column converted too: above 2^24 int32 values
    round), never truncated to the column's type."""
    rng = np.random.default_rng(41)
    schema = HeapSchema(n_cols=1)
    n = schema.tuples_per_page * 8
    c = rng.integers(-5, 5, n).astype(np.int32)
    if value > 1 << 24:
        c = c + np.int32((1 << 24) + 2)      # 2^24-3 .. 2^24+6
    pages = build_pages([c], schema)
    fn = _PROMO_OPS[op]
    pal = make_filter_fn_pallas(JSchema(n_cols=1),
                                lambda cols, th: fn(cols[0], th),
                                interpret=True)(pages, value)
    want = int(fn(c.astype(np.float32), np.float32(value)).sum())
    t = torch.from_numpy(pages)
    for th, pred in ((value, FilterPred(((0, op, None),))),
                     (0, FilterPred(((0, op, value),)))):
        got = make_filter_fn(schema, pred)(t, th)
        assert int(got["count"]) == int(pal["count"]) == want
        assert int(got["sums"][0]) == int(pal["sums"][0])


def test_integer_values_follow_jnp_promotion():
    schema = HeapSchema(n_cols=2, dtypes=("int32", "uint32"))
    assert FilterPred(((1, "ge", -1),)).values(schema, 0) == \
        [("u", np.uint32(0xFFFFFFFF))]
    assert FilterPred(((1, "ge", np.int64(-1)),)).values(schema, 0) == \
        [("i", np.int32(-1))]
    assert FilterPred(((0, "lt", 0.5),)).values(schema, 0) == \
        [("f", np.float32(0.5))]
    assert FilterPred(((1, "ge", np.uint32(3_000_000_000)),)).values(
        schema, 0) == [("u", np.uint32(3_000_000_000))]
    js = JSchema(n_cols=2, dtypes=("int32", "uint32"))
    probe = build_pages([np.zeros(4, np.int32), np.zeros(4, np.uint32)],
                        schema)
    for col, bad in ((0, 1 << 31), (0, -(1 << 31) - 1), (1, 1 << 31),
                     (1, 3_000_000_000), (1, 1 << 32), (1, -(1 << 31) - 1)):
        with pytest.raises(StromError) as e:
            FilterPred(((col, "gt", bad),)).values(schema, 0)
        assert e.value.errno == errno.EINVAL
        # the JAX function raises on the same value
        with pytest.raises(OverflowError):
            make_filter_fn_pallas(js, lambda cols, t, c=col: cols[c] > t,
                                  interpret=True)(probe, bad)
    rng = np.random.default_rng(3)
    n = schema.tuples_per_page * 3
    a = rng.integers(-5, 5, n).astype(np.int32)
    pages = build_pages([a, a.astype(np.uint32)], schema)
    for th in (-1, np.int64(-1), -3, np.uint32(3_000_000_000)):
        pal = make_filter_fn_pallas(js, lambda cols, t: cols[1] >= t,
                                    interpret=True)(pages, th)
        got = make_filter_fn(schema, FilterPred(((1, "ge", None),)))(
            torch.from_numpy(pages), th)
        assert int(got["count"]) == int(pal["count"])


def test_wrapper_on_other_devices_raises_not_falls_back():
    pages = torch.zeros((2, 8192), dtype=torch.uint8, device="meta")
    with pytest.raises(StromError) as e:
        filter_cuda.scan_filter_step_cuda(pages, 0)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError):
        FilterPred(((0, "between", None),))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    _, ts, f, u, i, vis, pages = _typed(seed=31, pages=40)
    pred = FilterPred(((0, "gt", None), (2, "lt", 400)))
    t = torch.from_numpy(pages).to(cuda_device)
    before = filter_cuda.launches
    got = filter_cuda.make_filter_fn_cuda(ts, pred)(t, -0.5)
    want = make_filter_fn(ts, pred)(t, -0.5)
    torch.cuda.synchronize()
    assert filter_cuda.launches == before + 1
    assert int(got["count"]) == int(want["count"])
    assert int(got["sums"][1].view(torch.int32)) == \
        int(want["sums"][1].view(torch.int32))
    assert int(got["sums"][2]) == int(want["sums"][2])
    sel = (vis != 0) & (f > np.float32(-0.5)) & (i < 400)
    assert _float_close(got["sums"][0], want["sums"][0], f[sel])
    with pytest.raises(StromError):
        filter_cuda.make_filter_fn_cuda(ts, lambda c, th: c[0] > th)(t, 0)
