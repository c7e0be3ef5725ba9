"""GROUP BY of the PyTorch port against the JAX package on the same pages:
the port's plain version (``ops/groupby.py``, which the CUDA wrapper runs
for CPU tensors) against the Pallas kernel in interpret mode and the XLA
path, and the CUDA wrapper's output decoding against a numpy emulation of
the kernel's accumulators.

Tolerances: counts, integer sums (int32/uint32 wrap mod 2^32), mins and
maxs exact; float sums within ``1e-5 * sum(|x|) + 1e-6`` and sums of
squares within ``1e-5 * sum(x^2) + 1e-6`` per group, because the two sides
add in a different order.  NaN/±inf: the port follows the Pallas kernel
(the kernel it replaces): a NaN in a group makes its sum, sum of squares,
min and max NaN; +inf with -inf gives a NaN sum.  On the CPU the XLA path
(segment reductions) gives the same NaN/±inf results as Pallas on the
cases of ``test_ieee_group_results_follow_pallas``; where the two were to
disagree, the port is held to Pallas."""

import errno

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvme_strom_tpu.ops.groupby import make_groupby_fn as jax_groupby
from nvme_strom_tpu.ops.groupby_pallas import make_groupby_fn_pallas
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.ops import groupby_cuda
from nvme_strom_tpu_torch.ops.filter import FilterPred
from nvme_strom_tpu_torch.ops.groupby import (GroupKey, acc_dtypes,
                                              combine_groupby,
                                              make_groupby_fn)
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_pages

KW = dict(n_cols=5, visibility=True,
          dtypes=("int32", "int32", "int32", "uint32", "float32"))
SCHEMA, JS = HeapSchema(**KW), JSchema(**KW)

# name: (port key, JAX key_fn, G)
KEYS = {
    "mod7": (GroupKey(1, 7), lambda c: c[1] % 7, 7),
    "abs8": (GroupKey(1, 8, True), lambda c: jnp.abs(c[1]) % 8, 8),
    "value": (GroupKey(0), lambda c: c[0], 5),
    "one": (GroupKey(2, 1), lambda c: c[2] % 1, 1),
    "u32mod": (GroupKey(3, 6), lambda c: c[3] % 6, 6),
}
AGGS = {"int32": [0, 2], "uint32": [3], "float32": [4]}


def _table(seed, n_pages=3, nonfinite=True):
    rng = np.random.default_rng(seed)
    n = SCHEMA.tuples_per_page * n_pages + 11
    c0 = rng.integers(-6, 6, n).astype(np.int32)
    c1 = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    c1[:6] = [-(1 << 31), (1 << 31) - 1, -7, -1, 5, 0]
    c2 = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    c3 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    c4 = rng.standard_normal(n).astype(np.float32)
    if nonfinite:
        for v, p in ((np.nan, 0.004), (np.inf, 0.004), (-np.inf, 0.004)):
            c4[rng.random(n) < p] = v
    vis = (rng.random(n) > 0.2).astype(np.int32)
    cols = [c0, c1, c2, c3, c4]
    return cols, vis, build_pages(cols, SCHEMA, visibility=vis)


def _np(t):
    """A port result tensor as numpy (uint32 bit patterns kept)."""
    return t.view(torch.int32).numpy().view(np.uint32) \
        if t.dtype == torch.uint32 else t.numpy()


def _assert_same(got, want, mags=None):
    """Field by field; float sums/sumsqs within the stated tolerance."""
    for k in ("count", "sums", "sumsqs", "mins", "maxs"):
        a, b = _np(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if a.dtype.kind == "f" and k in ("sums", "sumsqs"):
            mag = mags[k] if mags is not None else np.abs(b)
            tol = 1e-5 * np.nan_to_num(mag, posinf=0) + 1e-6
            fin = np.isfinite(b)
            assert np.array_equal(np.isnan(a), np.isnan(b)), k
            assert np.array_equal(a[~fin & ~np.isnan(b)],
                                  b[~fin & ~np.isnan(b)]), k
            assert (np.abs(a[fin] - b[fin]) <= tol[fin]).all(), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _mags(cols, vis, key_np, G, agg, pred_np):
    """Per-group sum(|x|) and sum(x^2) of the selected finite values."""
    ids = key_np(cols)
    sel = (vis != 0) & (ids >= 0) & (ids < G) & pred_np(cols)
    s1 = np.zeros((len(agg), G))
    s2 = np.zeros((len(agg), G))
    for i, c in enumerate(agg):
        x = cols[c][sel].astype(np.float64)
        ok = np.isfinite(x)
        np.add.at(s1[i], ids[sel][ok], np.abs(x[ok]))
        np.add.at(s2[i], ids[sel][ok], x[ok] ** 2)
    return {"sums": s1, "sumsqs": s2}


_NP_KEYS = {
    "mod7": lambda c: c[1].astype(np.int64) % 7,
    "abs8": lambda c: (np.abs(c[1]).astype(np.int64)) % 8,
    "value": lambda c: c[0].astype(np.int64),
    "one": lambda c: c[2].astype(np.int64) % 1,
    "u32mod": lambda c: c[3].astype(np.int64) % 6,
}


@pytest.mark.parametrize("seed,key,agg,pred", [
    (1, "mod7", "int32", True), (2, "abs8", "float32", False),
    (3, "value", "uint32", True), (4, "one", "float32", True),
    (5, "u32mod", "int32", False), (6, "abs8", "uint32", False),
    (7, "mod7", "float32", True),
])
def test_plain_matches_pallas_interpret(seed, key, agg, pred):
    cols, vis, pages = _table(seed=seed)
    tkey, jkey, G = KEYS[key]
    tp = FilterPred(((0, "gt", 0),)) if pred else None
    jp = (lambda c: c[0] > 0) if pred else None
    got = make_groupby_fn(SCHEMA, tkey, G, agg_cols=AGGS[agg],
                          predicate=tp)(torch.from_numpy(pages))
    want = make_groupby_fn_pallas(JS, jkey, G, agg_cols=AGGS[agg],
                                  predicate=jp, interpret=True)(pages)
    npred = (lambda c: c[0] > 0) if pred else \
        (lambda c: np.ones(len(c[0]), bool))
    _assert_same(got, want, _mags(cols, vis, _NP_KEYS[key], G, AGGS[agg],
                                  npred))


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_plain_matches_xla_on_finite_data(agg):
    cols, vis, pages = _table(seed=5, nonfinite=False)
    got = make_groupby_fn(SCHEMA, GroupKey(1, 8, True), 8,
                          agg_cols=AGGS[agg],
                          predicate=FilterPred(((0, "le", 2),)))(
        torch.from_numpy(pages))
    want = jax_groupby(JS, lambda c: jnp.abs(c[1]) % 8, 8,
                       agg_cols=AGGS[agg],
                       predicate=lambda c: c[0] <= 2)(pages)
    _assert_same(got, want, _mags(cols, vis, _NP_KEYS["abs8"], 8,
                                  AGGS[agg], lambda c: c[0] <= 2))


_CHIP_G = {
    # the chip phase's larger group counts (the Pallas interpreter unrolls
    # G*V, so these are held to the XLA path on finite data)
    "c1%64": (GroupKey(1, 64), lambda c: c[1] % 64, 64,
              lambda c: c[1].astype(np.int64) % 64),
    "u32 c3%512": (GroupKey(3, 512), lambda c: c[3] % 512, 512,
                   lambda c: c[3].astype(np.int64) % 512),
    "value c0, ids out of range": (GroupKey(0), lambda c: c[0], 7,
                                   lambda c: c[0].astype(np.int64)),
}


@pytest.mark.parametrize("agg", sorted(AGGS))
@pytest.mark.parametrize("case", sorted(_CHIP_G))
def test_plain_matches_xla_at_chip_phase_group_counts(case, agg):
    cols, vis, pages = _table(seed=17, nonfinite=False)
    key, jkey, G, npkey = _CHIP_G[case]
    got = make_groupby_fn(SCHEMA, key, G, agg_cols=AGGS[agg],
                          predicate=FilterPred(((0, "gt", 0.25),)))(
        torch.from_numpy(pages))
    want = jax_groupby(JS, jkey, G, agg_cols=AGGS[agg],
                       predicate=lambda c: c[0] > 0.25)(pages)
    _assert_same(got, want, _mags(cols, vis, npkey, G, AGGS[agg],
                                  lambda c: c[0] > 0.25))


def test_ieee_group_results_follow_pallas():
    """Per group: NaN dominates the sum and sum of squares and makes min
    and max NaN; +inf with -inf sums to NaN; one-signed inf wins; an empty
    group reports +inf/-inf sentinels."""
    schema = HeapSchema(n_cols=2, dtypes=("int32", "float32"))
    js = JSchema(n_cols=2, dtypes=("int32", "float32"))
    key = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    val = np.array([np.nan, 1, np.inf, -np.inf, np.inf, 2, -1, 3],
                   np.float32)
    pages = build_pages([key, val], schema)
    got = make_groupby_fn(schema, GroupKey(0), 5, agg_cols=[1])(
        torch.from_numpy(pages))
    want = make_groupby_fn_pallas(js, lambda c: c[0], 5, agg_cols=[1],
                                  interpret=True)(pages)
    _assert_same(got, want)
    _assert_same(got, jax_groupby(js, lambda c: c[0], 5, agg_cols=[1])(pages))
    s = got["sums"][0].numpy()
    assert np.isnan(s[0]) and np.isnan(s[1]) and s[2] == np.inf \
        and s[3] == 2.0 and s[4] == 0.0
    mins, maxs = got["mins"][0].numpy(), got["maxs"][0].numpy()
    assert np.isnan(mins[0]) and np.isnan(maxs[0])
    assert mins[4] == np.inf and maxs[4] == -np.inf
    assert mins[1] == -np.inf and maxs[1] == np.inf


def test_uint32_results_are_bit_patterns_and_sentinels():
    schema = HeapSchema(n_cols=2, dtypes=("int32", "uint32"))
    key = np.array([0, 0, 0, 1], np.int32)
    val = np.array([0xFFFF_FFFF, 0x8000_0000, 1, 7], np.uint32)
    got = make_groupby_fn(schema, GroupKey(0), 3, agg_cols=[1])(
        torch.from_numpy(build_pages([key, val], schema)))
    for k in ("sums", "mins", "maxs"):
        assert got[k].dtype == torch.uint32
    assert list(_np(got["sums"])[0]) == [0x8000_0000, 7, 0]
    assert list(_np(got["mins"])[0]) == [1, 7, 0xFFFF_FFFF]
    assert list(_np(got["maxs"])[0]) == [0xFFFF_FFFF, 7, 0]
    assert acc_dtypes(np.dtype(np.uint32))[2:] == (0, 0xFFFF_FFFF)


def test_callable_key_matches_group_key_on_cpu():
    _cols, _vis, pages = _table(seed=9)
    t = torch.from_numpy(pages)
    a = make_groupby_fn(SCHEMA, GroupKey(1, 7), 7, agg_cols=[2])(t)
    b = make_groupby_fn(SCHEMA, lambda cols, th: torch.remainder(
        cols[1].to(torch.int64), 7), 7, agg_cols=[2])(t)
    _assert_same(a, {k: _np(v) for k, v in b.items()})


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_combine_of_halves_equals_whole(agg):
    _cols, _vis, pages = _table(seed=12, n_pages=4)
    fn = make_groupby_fn(SCHEMA, GroupKey(1, 6, True), 6, agg_cols=AGGS[agg])
    t = torch.from_numpy(pages)
    whole = fn(t)
    halves = combine_groupby(fn(t[:2].clone()), fn(t[2:].clone()))
    _assert_same(halves, {k: _np(v) for k, v in whole.items()})


def _emulate_kernel_buffer(pages, key, G, agg, pred):
    """What csrc/groupby.cu leaves in its output buffer: integer order
    images for min/max, finite float sums and NaN/+inf/-inf counts."""
    from nvme_strom_tpu_torch.ops.filter import decode_pages
    t = torch.from_numpy(pages)
    cols, valid = decode_pages(t, SCHEMA)
    ids = key.ids(cols, SCHEMA)
    sel = valid & (ids >= 0) & (ids < G)
    if pred is not None:
        sel = pred.mask(cols, sel, SCHEMA, 0)
    dt = SCHEMA.col_dtype(agg[0])
    buf = groupby_cuda.new_outputs(G, len(agg), dt, "cpu").numpy()
    VG = len(agg) * G
    k = ids[sel].numpy()
    np.add.at(buf[:G], k, 1)
    for a, c in enumerate(agg):
        bits = pages.view(np.int32).reshape(len(pages), -1)[
            :, SCHEMA.col_word_range(c)[0]:][:, :SCHEMA.tuples_per_page]
        b = bits[sel.numpy()]
        sl = lambda i: slice(G + i * VG + a * G, G + i * VG + (a + 1) * G)
        if dt.kind == "f":
            x = b.view(np.float32)
            nan, pinf, ninf = np.isnan(x), x == np.inf, x == -np.inf
            fin = ~(nan | pinf | ninf)
            s = np.zeros(G, np.float32)
            np.add.at(s, k[fin], x[fin])
            s2 = np.zeros(G, np.float32)
            np.add.at(s2, k[fin], x[fin] * x[fin])
            buf[sl(0)] = s.view(np.int32)
            buf[sl(1)] = s2.view(np.int32)
            for q, m in enumerate((nan, pinf, ninf)):
                np.add.at(buf[sl(4 + q)], k[m], 1)
            img = np.where(b >= 0, b, b ^ 0x7FFFFFFF)[~nan]
            kk = k[~nan]
        else:
            u = b.view(np.uint32).astype(np.uint64)
            acc = np.zeros(G, np.uint64)
            np.add.at(acc, k, u)
            buf[sl(0)] = (acc & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            xf = (u if dt.kind == "u" else b).astype(np.float32)
            s2 = np.zeros(G, np.float32)
            np.add.at(s2, k, xf * xf)
            buf[sl(1)] = s2.view(np.int32)
            img = (b.view(np.uint32) ^ np.uint32(0x80000000)).view(np.int32) \
                if dt.kind == "u" else b
            kk = k
        np.minimum.at(buf[sl(2)], kk, img)
        np.maximum.at(buf[sl(3)], kk, img)
    return torch.from_numpy(buf)


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_kernel_output_decoding_matches_plain(agg):
    """The wrapper's decoding of the kernel's accumulators (order images,
    IEEE rebuild from counts) gives the plain version's result."""
    cols, vis, pages = _table(seed=21)
    key, pred = GroupKey(1, 5, True), FilterPred(((0, "ge", -2),))
    buf = _emulate_kernel_buffer(pages, key, 5, AGGS[agg], pred)
    dt = SCHEMA.col_dtype(AGGS[agg][0])
    got = groupby_cuda.unpack_outputs(buf, 5, len(AGGS[agg]), dt)
    want = make_groupby_fn(SCHEMA, key, 5, agg_cols=AGGS[agg],
                           predicate=pred)(torch.from_numpy(pages))
    _assert_same(got, {k: _np(v) for k, v in want.items()},
                 _mags(cols, vis, lambda c: np.abs(c[1]).astype(np.int64) % 5,
                       5, AGGS[agg], lambda c: c[0] >= -2))


def test_spec_encoding_and_refusals():
    key = GroupKey(1, 64, True)
    spec = groupby_cuda._spec(SCHEMA, key, 64, [0, 2], np.dtype(np.int32),
                              FilterPred(((0, "gt", 0.5),)), 0)
    assert (spec.key_col, spec.key_abs, spec.key_mod) == (1, 1, 64)
    assert (spec.n_groups, spec.n_agg, spec.agg_kind) == (64, 2, 0)
    assert list(spec.agg_col)[:2] == [0, 2]
    assert (spec.terms.n, spec.terms.kind[0]) == (1, 2)    # f32 compare
    assert groupby_cuda.kernel_refusal(SCHEMA, key, 512) == ""
    assert "512" in groupby_cuda.kernel_refusal(SCHEMA, key, 513)
    assert "callable" in groupby_cuda.kernel_refusal(
        SCHEMA, lambda c, t: c[0], 8)
    for bad in (dict(col=-1), dict(col=0, mod=0), dict(col=0, mod=1 << 31)):
        with pytest.raises(StromError) as e:
            GroupKey(**bad)
        assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError):
        make_groupby_fn(SCHEMA, GroupKey(4), 4)        # float key column
    with pytest.raises(StromError):
        make_groupby_fn(SCHEMA, GroupKey(0), 4, agg_cols=[0, 3])  # mixed


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", sorted(AGGS))
def test_kernel_matches_plain_on_card(cuda_device, agg):
    cols, vis, pages = _table(seed=31, n_pages=40)
    t = torch.from_numpy(pages).to(cuda_device)
    key, pred = GroupKey(1, 64), FilterPred(((0, "gt", -3),))
    before = groupby_cuda.launches
    got = groupby_cuda.groupby_pages_cuda(t, 0, SCHEMA, key, 64,
                                          agg_cols=AGGS[agg], predicate=pred)
    want = make_groupby_fn(SCHEMA, key, 64, agg_cols=AGGS[agg],
                           predicate=pred)(t)
    torch.cuda.synchronize()
    assert groupby_cuda.launches == before + 1
    _assert_same({k: v.cpu() for k, v in got.items()},
                 {k: _np(v.cpu()) for k, v in want.items()},
                 _mags(cols, vis, lambda c: c[1].astype(np.int64) % 64, 64,
                       AGGS[agg], lambda c: c[0] > -3))


# ---------------------------------------------------------------------------
# the x64 switch (A2.10) and the measured route
# ---------------------------------------------------------------------------

@pytest.fixture()
def x64_on():
    from nvme_strom_tpu_torch.config import config
    config.set("x64", True)
    yield
    config.set("x64", False)


@pytest.mark.parametrize("dt", ["int32", "uint32", "float32", "int64",
                                "float64"])
def test_acc_dtypes_match_reference_with_and_without_x64(dt):
    """The accumulator dtypes of each column dtype, with the switch off
    and on, against the reference's without and under jax_enable_x64
    (8-byte columns: the port keeps 64-bit sums without the switch, the
    slice 8 divergence)."""
    import jax
    from nvme_strom_tpu.ops.groupby import acc_dtypes as jax_acc_dtypes
    from nvme_strom_tpu_torch.config import config
    d = np.dtype(dt)
    for on in (False, True):
        config.set("x64", on)
        try:
            mine = acc_dtypes(d)
            with jax.enable_x64(on):
                ref = jax_acc_dtypes(d)
        finally:
            config.set("x64", False)
        if d.itemsize == 8 and not on:
            assert mine[0] == d and mine[1] == np.float64
        else:
            assert (mine[0], mine[1]) == (ref[0], ref[1]), on
        assert (mine[2], mine[3]) == (ref[2], ref[3])


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_x64_sums_match_reference_exactly(x64_on, agg):
    """Under the switch int32 sums are int64 and exact (no wrap), uint32
    sums uint64-valued, every sum of squares float64: the reference's
    XLA path under jax_enable_x64 on the same pages, and numpy int64
    truth."""
    import jax
    cols, vis, pages = _table(seed=23, nonfinite=False)
    got = make_groupby_fn(SCHEMA, GroupKey(1, 8, True), 8,
                          agg_cols=AGGS[agg],
                          predicate=FilterPred(((0, "le", 2),)))(
        torch.from_numpy(pages))
    with jax.enable_x64(True):
        want = jax_groupby(JS, lambda c: jnp.abs(c[1]) % 8, 8,
                           agg_cols=AGGS[agg],
                           predicate=lambda c: c[0] <= 2)(pages)
        want = {k: np.asarray(v) for k, v in want.items()}
    assert got["sumsqs"].dtype == torch.float64
    assert want["sumsqs"].dtype == np.float64
    np.testing.assert_array_equal(got["count"].numpy(), want["count"])
    key = np.abs(cols[1].astype(np.int64))
    key = np.where(cols[1] == -(1 << 31), cols[1], key).astype(np.int64) % 8
    sel = (vis != 0) & (cols[0] <= 2)
    for j, c in enumerate(AGGS[agg]):
        if agg == "float32":
            assert got["sums"].dtype == torch.float32
            tol = 1e-5 * np.abs(cols[c][sel]).astype(np.float64).sum() + 1e-6
            assert np.abs(got["sums"][j].double().numpy()
                          - want["sums"][j]).max() <= tol
        else:
            assert got["sums"].dtype == torch.int64
            truth = np.array([cols[c][sel & (key == g)].astype(np.int64)
                              .sum() for g in range(8)])
            np.testing.assert_array_equal(got["sums"][j].numpy(), truth)
            np.testing.assert_array_equal(
                want["sums"][j].astype(np.int64), truth)
        for k in ("mins", "maxs"):
            np.testing.assert_array_equal(
                _as_np(got[k][j]), want[k][j].astype(_as_np(got[k][j]).dtype))
        np.testing.assert_allclose(got["sumsqs"][j].numpy(),
                                   want["sumsqs"][j], rtol=1e-12)


def _as_np(t):
    return t.view(torch.int32).numpy().view(np.uint32) \
        if t.dtype == torch.uint32 else t.numpy()


def test_x64_refused_by_the_kernel_and_combined_in_64_bits(x64_on):
    why = groupby_cuda.kernel_refusal(SCHEMA, GroupKey(1, 8), 8,
                                      FilterPred())
    assert "x64" in why
    a = make_groupby_fn(SCHEMA, GroupKey(1, 4), 4, agg_cols=[0])
    _cols, _vis, pages = _table(seed=3, nonfinite=False)
    p = torch.from_numpy(pages)
    half = p.shape[0] // 2
    whole = a(p)
    both = combine_groupby(a(p[:half]), a(p[half:]))
    assert both["sums"].dtype == torch.int64
    assert torch.equal(both["sums"], whole["sums"])


@pytest.mark.parametrize("ratio", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("kind", ["i", "u", "f"])
def test_groupby_kernel_auto_routes_as_the_reference(monkeypatch, ratio,
                                                     kind):
    """At the same measured ratio the port routes as the reference does
    (its cuda for the reference's pallas, torch for xla); the port reads
    its ratio from its own module or config, never BENCH_MATRIX.json."""
    import nvme_strom_tpu.ops.groupby as jg
    from nvme_strom_tpu_torch.config import config
    from nvme_strom_tpu_torch.ops.groupby import groupby_kernel_auto
    monkeypatch.setattr(jg, "_measured_ratio_cache", ratio)
    config.set("groupby_cuda_ratio", ratio)
    try:
        mine, why = groupby_kernel_auto(kind)
    finally:
        config.set("groupby_cuda_ratio", 0.0)
    ref, _ = jg.groupby_kernel_auto(kind)
    assert mine == {"pallas": "cuda", "xla": "torch"}[ref]
    if kind == "f":
        assert f"{ratio:g}" in why


def test_groupby_kernel_auto_default_is_the_cards_ratio():
    import nvme_strom_tpu_torch.ops.groupby as tg
    from nvme_strom_tpu_torch.ops.groupby import groupby_kernel_auto
    kernel, why = groupby_kernel_auto("f")
    assert f"{tg.GROUPBY_CUDA_RATIO:g}" in why
    assert kernel == ("cuda" if tg.GROUPBY_CUDA_RATIO >= 1.0 else "torch")
    src = open(tg.__file__).read()
    assert "BENCH_MATRIX" not in src and "0.851" not in src
