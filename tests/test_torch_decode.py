"""Fused decode → filter → aggregate of the PyTorch port against the JAX
package on the same packed pages: the port's plain version
(``ops/decode.py``, which the CUDA wrapper runs for CPU tensors) against
the Pallas kernel in interpret mode and the XLA path, for every codec, a
32768-row block, ``need_cols``, the file's header page and zero padding.

Tolerances: counts and integer sums exact (int32/uint32 wrap mod 2^32);
float sums within ``1e-5 * sum(|selected x|) + 1e-6`` (different order)."""

import errno

import numpy as np
import pytest
import torch

from nvme_strom_tpu.ops.decode_pallas import make_decode_filter_fn_pallas
from nvme_strom_tpu.ops.decode_xla import make_decode_filter_fn_xla
from nvme_strom_tpu.scan import colpack as jcp
from nvme_strom_tpu.scan.heap import HeapSchema as JSchema
from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.ops import decode_cuda
from nvme_strom_tpu_torch.ops.decode import (decode_block_words,
                                             make_decode_filter_fn)
from nvme_strom_tpu_torch.ops.filter import FilterPred, page_words
from nvme_strom_tpu_torch.scan import colpack as tcp
from nvme_strom_tpu_torch.scan.heap import HeapSchema, build_heap_file

KW = dict(n_cols=4, visibility=True,
          dtypes=("int32", "int32", "uint32", "float32"))


def _packed(tmp_path, codecs=None, n=21000, seed=0):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 16, n).astype(np.int32),
            (rng.integers(0, 8, n) * 100 - 300).astype(np.int32),
            (np.arange(n) // 600 + (1 << 31)).astype(np.uint32),
            rng.standard_normal(n).astype(np.float32)]
    vis = (rng.random(n) > 0.1).astype(np.int32)
    path = str(tmp_path / "d.heap")
    build_heap_file(path, cols, HeapSchema(**KW), visibility=vis)
    kw = {} if codecs is None else {"codecs": codecs}
    meta = tcp.build_packed(path, HeapSchema(**KW), **kw)
    raw = np.fromfile(meta.path, np.uint8).reshape(-1, 8192)
    # three zero pages of padding after the header page + blocks
    raw = np.concatenate([raw, np.zeros((3, 8192), np.uint8)])
    keep = vis != 0
    return meta, jcp.load_meta(meta.path), raw, [c[keep] for c in cols]


def _vals(out):
    return [int(out["count"])] + [
        float(np.asarray(s).view(np.int32)) if np.asarray(s).dtype ==
        np.uint32 else float(s) for s in out["sums"]]


def _tvals(out):
    return [int(out["count"])] + [
        float(s.view(torch.int32)) if s.dtype == torch.uint32 else float(s)
        for s in out["sums"]]


def _check(got, want, sel_float):
    a, b = _tvals(got), _vals(want)
    assert a[:4] == b[:4]
    tol = 1e-5 * float(np.abs(sel_float.astype(np.float64)).sum()) + 1e-6
    assert abs(a[4] - b[4]) <= tol


@pytest.mark.parametrize("codecs", [None, ("bitpack",), ("dict",), ("rle",),
                                    ()])
def test_plain_matches_pallas_and_xla(tmp_path, codecs):
    meta, jmeta, raw, (c0, c1, c2, c3) = _packed(tmp_path, codecs)
    js = JSchema(**KW)
    got = make_decode_filter_fn(
        meta, FilterPred(((0, "gt", 3), (1, "ne", 100))))(
        torch.from_numpy(raw))
    jp = lambda c: (c[0] > 3) & (c[1] != 100)
    pal = make_decode_filter_fn_pallas(jmeta, js, jp, interpret=True)(raw)
    xla = make_decode_filter_fn_xla(jmeta, jp)(raw)
    sel = (c0 > 3) & (c1 != 100)
    assert int(got["count"]) == int(sel.sum())
    _check(got, pal, c3[sel])
    _check(got, xla, c3[sel])
    assert got["sums"][2].dtype == torch.uint32
    assert int(got["sums"][2].view(torch.int32).numpy().view(np.uint32)) \
        == int(c2[sel].astype(np.uint64).sum() & 0xFFFFFFFF)


def test_need_cols_project_to_zeros(tmp_path):
    meta, jmeta, raw, (c0, c1, c2, c3) = _packed(tmp_path)
    got = make_decode_filter_fn(meta, need_cols=(1, 3))(torch.from_numpy(raw))
    pal = make_decode_filter_fn_pallas(jmeta, JSchema(**KW), None,
                                       need_cols=(1, 3), interpret=True)(raw)
    _check(got, pal, c3)
    v = _tvals(got)
    assert v[0] == len(c0) and v[1] == 0 and v[3] == 0
    assert v[2] == int(c1.sum())


def test_32768_row_block_and_pages_without_magic(tmp_path):
    rng = np.random.default_rng(4)
    n = 70001
    kw = dict(n_cols=1, dtypes=("int32",))
    c = rng.integers(5, 7, n).astype(np.int32)
    path = str(tmp_path / "b.heap")
    build_heap_file(path, [c], HeapSchema(**kw))
    meta = tcp.build_packed(path, HeapSchema(**kw))
    assert meta.rows_per_block == 32768 and meta.cols[0].bits == 1
    raw = np.fromfile(meta.path, np.uint8).reshape(-1, 8192)
    cols, valid = decode_block_words(page_words(torch.from_numpy(raw)), meta)
    assert not valid[0].any()                      # header page
    assert int(valid.sum()) == n
    assert np.array_equal(cols[0][valid].numpy(), c)
    got = make_decode_filter_fn(meta, FilterPred(((0, "eq", 6),)))(
        torch.from_numpy(raw))
    pal = make_decode_filter_fn_pallas(
        jcp.load_meta(meta.path), JSchema(**kw), lambda cc: cc[0] == 6,
        interpret=True)(raw)
    assert _tvals(got) == _vals(pal) == [int((c == 6).sum()),
                                         float(6 * (c == 6).sum())]


def test_promotion_applies_to_packed_columns(tmp_path):
    meta, _jm, raw, (c0, _c1, _c2, _c3) = _packed(tmp_path)
    got = make_decode_filter_fn(meta, FilterPred(((0, "ge", 7.5),)))(
        torch.from_numpy(raw))
    assert int(got["count"]) == int((c0 >= 8).sum())


def test_spec_and_refusals(tmp_path):
    meta, _jm, raw, _cols = _packed(tmp_path)
    spec = decode_cuda._spec(meta, FilterPred(((2, "lt", 5),)), (0, 2), 0)
    assert list(spec.codec)[:4] == [2, 0, 4, 0]        # bitpack, -, rle, -
    assert spec.rpb == meta.rows_per_block
    assert (spec.terms.n, spec.terms.kind[0]) == (1, 1)   # uint compare
    assert decode_cuda.kernel_refusal(meta, None) == ""
    assert "callable" in decode_cuda.kernel_refusal(meta, lambda c, t: c[0])
    meta_pages = torch.zeros((2, 8192), dtype=torch.uint8, device="meta")
    with pytest.raises(StromError) as e:
        decode_cuda.decode_filter_pages_cuda(meta_pages, 0, meta,
                                             lambda c, t: c[0] > 1)
    assert e.value.errno == errno.EINVAL and "callable" in str(e.value)
    cpu = decode_cuda.decode_filter_pages_cuda(torch.from_numpy(raw), 0,
                                               meta, None)
    assert int(cpu["count"]) == meta.n_rows


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("codecs", [None, ("rle",), ()])
def test_kernel_matches_plain_on_card(tmp_path, cuda_device, codecs):
    meta, _jm, raw, (c0, c1, _c2, c3) = _packed(tmp_path, codecs)
    t = torch.from_numpy(raw).to(cuda_device)
    pred = FilterPred(((0, "gt", 3), (3, "lt", 1.5)))
    before = decode_cuda.launches
    got = decode_cuda.decode_filter_pages_cuda(t, 0, meta, pred)
    want = make_decode_filter_fn(meta, pred)(t)
    torch.cuda.synchronize()
    assert decode_cuda.launches == before + 1
    sel = (c0 > 3) & (c3 < np.float32(1.5))
    a, b = _tvals(got), _tvals(want)
    assert a[:4] == b[:4]
    assert abs(a[4] - b[4]) <= 1e-5 * float(np.abs(c3[sel]).sum()) + 1e-6
