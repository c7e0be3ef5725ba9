"""Host-side planning of the Hopper kernels B4 (ring permute), B1 (page
filter), B3 (GROUP BY) and B2 (packed decode-filter), as pure functions the
CPU reaches: B4's split of a block into an unaligned head, per-CTA ranges
of bulk copies and a tail; B1's variant by column count, its persistent
grid and its refusal of pages a bulk copy cannot take; B3's accumulator
strategy, shared memory and bulk copies of a page's regions; B2's packed
slot geometry, staged span and row chunks.  The kernels themselves run
only on the card (``chip_smoke.py`` phases [3a]-[3c], [8], [9a])."""

import errno

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.ops import (decode_cuda, filter_cuda, groupby_cuda,
                                      permute_cuda)
from nvme_strom_tpu_torch.ops.decode import make_decode_filter_fn
from nvme_strom_tpu_torch.ops.filter import (DEFAULT_SCHEMA, STEP_PRED,
                                             FilterPred, make_filter_fn)
from nvme_strom_tpu_torch.ops.groupby import GroupKey, make_groupby_fn
from nvme_strom_tpu_torch.ops.permute_cuda import (BULK_MIN_BYTES,
                                                   STAGE_BYTES, plan_send,
                                                   send_pieces)
from nvme_strom_tpu_torch.scan.colpack import (_RPB_CANDIDATES, ColCodec,
                                               PackedMeta, build_packed)
from nvme_strom_tpu_torch.scan.heap import (HEADER_WORDS, PAGE_SIZE,
                                            HeapSchema, build_heap_file,
                                            build_pages)

_BASE = 1 << 40           # a 512-byte-aligned address, as the allocator's


def _covered_once(pieces, nbytes):
    """The pieces, in offset order, tile [0, nbytes) with no gap or
    overlap."""
    end = 0
    for off, size, _ in sorted(pieces):
        assert size > 0 and off == end
        end = off + size
    return end == nbytes


@settings(max_examples=400, deadline=None)
@given(nbytes=st.one_of(st.integers(0, 1 << 20),
                        st.integers(BULK_MIN_BYTES - 64,
                                    BULK_MIN_BYTES + (1 << 20))),
       src_off=st.integers(0, 15), dst_off=st.integers(0, 15),
       sms=st.sampled_from([1, 8, 132]), peer=st.booleans())
def test_send_plan_covers_every_byte_once_in_aligned_bulk_pieces(
        nbytes, src_off, dst_off, sms, peer):
    src, dst = _BASE + src_off, 3 * _BASE + dst_off
    plan = plan_send(src, dst, nbytes, peer=peer, sms=sms)
    pieces = send_pieces(plan)
    assert _covered_once(pieces, nbytes)
    assert plan.head + plan.body + plan.tail == nbytes
    assert 1 <= plan.grid <= 2 * sms
    assert plan.bulk == (not peer and src_off == dst_off
                         and nbytes >= BULK_MIN_BYTES)
    if not plan.bulk:
        # the SIMT kernel: 16-byte vectors only where both pointers allow
        assert plan.head == 0
        assert plan.body == (nbytes // 16 * 16 if src_off == dst_off == 0
                             else 0)
        return
    assert plan.head < 16 and plan.tail < 16
    bulk = [(o, n, c) for o, n, c in pieces
            if plan.head <= o < plan.head + plan.body]
    for off, size, _ in bulk:
        assert (src + off) % 16 == 0 and (dst + off) % 16 == 0
        assert size % 16 == 0 and 0 < size <= STAGE_BYTES
    # every CTA has pieces, dealt in turn
    assert {c for _, _, c in bulk} == set(range(plan.grid))


@pytest.mark.parametrize("nbytes, bulk, grid", [
    (256 << 20, True, 264),      # redistribution data and gather parts
    (4 << 20, False, 264),       # ring scan block
    (128 << 10, False, 32),      # redistribution ids
    (4, False, 1), (20, False, 1)])   # ids of rows_max 1 and 5
def test_send_plan_at_the_main_paths_blocks(nbytes, bulk, grid):
    plan = plan_send(_BASE, 2 * _BASE, nbytes, peer=False, sms=132)
    assert (plan.bulk, plan.grid) == (bulk, grid)
    assert plan.head == 0 and plan.tail == nbytes % 16
    assert not plan_send(_BASE, 2 * _BASE, nbytes, peer=True, sms=132).bulk


@pytest.mark.parametrize("n_cols", range(1, 18))
def test_column_template_is_the_smallest_that_holds_the_schema(n_cols):
    if n_cols > 16:
        with pytest.raises(StromError) as e:
            filter_cuda.column_template(n_cols)
        assert e.value.errno == errno.EINVAL
        return
    nc = filter_cuda.column_template(n_cols)
    assert nc in filter_cuda.TEMPLATES and n_cols <= nc
    assert all(t < n_cols for t in filter_cuda.TEMPLATES if t < nc)


@pytest.mark.parametrize("n_pages, per_sm, sms, grid", [
    (2048, 13, 132, 1716), (512, 13, 132, 512), (133, 8, 132, 133),
    (1, 6, 132, 1), (0, 6, 132, 1), (100000, 1, 132, 132)])
def test_filter_grid_is_the_occupancy_capped_by_the_pages(n_pages, per_sm,
                                                          sms, grid):
    assert filter_cuda.filter_grid(n_pages, per_sm, sms) == grid


@pytest.mark.parametrize("offset, ok", [(0, True), (16, True), (4, False),
                                        (8, False), (12, False)])
def test_pages_must_start_on_a_16_byte_boundary(offset, ok):
    flat = torch.zeros(3 * PAGE_SIZE + 64, dtype=torch.uint8)
    start = (-flat.data_ptr()) % 64 + offset
    view = flat[start:start + 2 * PAGE_SIZE].view(2, PAGE_SIZE)
    if ok:
        filter_cuda.check_pages(view)
        return
    with pytest.raises(StromError) as e:
        filter_cuda.check_pages(view)
    assert e.value.errno == errno.EINVAL


def test_page_check_refuses_shapes_and_strides():
    for bad in (torch.zeros((2, 4096), dtype=torch.uint8),
                torch.zeros((2, PAGE_SIZE), dtype=torch.int8),
                torch.zeros((2, 2 * PAGE_SIZE), dtype=torch.uint8)[:, ::2]):
        with pytest.raises(StromError) as e:
            filter_cuda.check_pages(bad)
        assert e.value.errno == errno.EINVAL


def test_output_words_hold_count_and_sums():
    typed = HeapSchema(n_cols=3, dtypes=("float32", "uint32", "int32"))
    floats = HeapSchema(n_cols=1, dtypes=("float32",))
    # count, the int sums, the float sums (one slot of each at least)
    for schema, words in ((DEFAULT_SCHEMA, 1 + 2 + 1), (typed, 1 + 2 + 1),
                          (floats, 1 + 1 + 1)):
        out = filter_cuda.new_outputs(schema, "cpu")
        assert out.dtype == torch.int32 and out.numel() == words
        assert not out.any()


def test_cpu_pages_take_the_plain_version_at_any_alignment():
    """Alignment is the kernel's rule only: a CPU batch, even a misaligned
    view, goes through the plain version and gives its answer."""
    rng = np.random.default_rng(5)
    n = DEFAULT_SCHEMA.tuples_per_page * 3
    pages = build_pages([rng.integers(-1000, 1000, n).astype(np.int32),
                         rng.integers(-1000, 1000, n).astype(np.int32)],
                        DEFAULT_SCHEMA,
                        visibility=np.ones(n, np.int32))
    flat = torch.zeros(pages.nbytes + 64, dtype=torch.uint8)
    start = (-flat.data_ptr()) % 64 + 4
    view = flat[start:start + pages.nbytes].view(-1, PAGE_SIZE)
    view.copy_(torch.from_numpy(pages))
    got = filter_cuda.scan_filter_step_cuda(view, 100)
    want = make_filter_fn(DEFAULT_SCHEMA, STEP_PRED)(
        torch.from_numpy(pages), 100)
    assert int(got["count"]) == int(want["count"])
    assert int(got["sum"]) == int(want["sums"][1])


def test_finish_ring_of_a_ring_that_never_stepped_does_nothing():
    before = (permute_cuda.launches, permute_cuda.wait_launches)
    permute_cuda.finish_ring([torch.device("cuda", 7)] * 3)
    assert (permute_cuda.launches, permute_cuda.wait_launches) == before


# -- B3: GROUP BY ------------------------------------------------------------

_H100_SMEM = 232448       # bytes one block may opt into (227 KB)


def _group_schema(n_agg: int, dtype: str) -> HeapSchema:
    """An int32 key column, then *n_agg* columns of *dtype*."""
    return HeapSchema(1 + n_agg, True, ("int32",) + (dtype,) * n_agg)


@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32"])
@pytest.mark.parametrize("n_agg", [1, 2, 15])
@pytest.mark.parametrize("n_groups", [1, 7, 8, 64, 512])
def test_groupby_plan_strategy_fits_the_card(n_groups, n_agg, dtype):
    schema = _group_schema(n_agg, dtype)
    regions = list(range(schema.n_cols + 1))        # every column, visibility
    plan = groupby_cuda.plan_groupby(schema, regions, n_groups, n_agg)
    assert plan.smem <= _H100_SMEM
    words = groupby_cuda.acc_words(n_groups, n_agg)
    assert plan.acc_words == words == n_groups * (1 + 4 * n_agg)
    assert plan.smem == 128 + plan.stages * plan.stage_bytes \
        + 4 * plan.copies * words
    assert 1 <= plan.window <= plan.stages
    # one copy per lane while it stays under the cap, else one per CTA
    lane = 4 * 32 * words <= groupby_cuda.LANE_CAP
    assert plan.strategy == ("lane" if lane else "cta")
    assert plan.copies == (32 if lane else 1)
    assert plan.threads == groupby_cuda.THREADS[plan.strategy]
    # as many stages as fit, up to the strategy's, halving
    most = groupby_cuda.STAGES[plan.strategy]
    assert plan.stages <= most and most % plan.stages == 0
    if plan.stages < most:
        assert plan.smem + plan.stages * plan.stage_bytes > _H100_SMEM
    if (n_groups, n_agg, dtype) == (512, 15, "float32"):
        assert plan.strategy == "cta" and plan.stages >= 1


@pytest.mark.parametrize("threads", [None, 256, 512])
@pytest.mark.parametrize("strategy", ["lane", "cta"])
@pytest.mark.parametrize("n_groups, n_agg", [(1, 1), (8, 2), (64, 2),
                                             (512, 15)])
def test_groupby_plan_takes_a_strategy_asked_for(strategy, threads,
                                                 n_groups, n_agg):
    schema = _group_schema(n_agg, "float32")
    regions = list(range(schema.n_cols + 1))
    words = groupby_cuda.acc_words(n_groups, n_agg)
    copies = groupby_cuda.COPIES[strategy]
    stage = sum(n for _, n, _ in groupby_cuda.plan_segments(schema,
                                                            regions)[0])
    if 128 + stage + 4 * copies * words > _H100_SMEM:
        with pytest.raises(StromError) as e:
            groupby_cuda.plan_groupby(schema, regions, n_groups, n_agg,
                                      strategy=strategy, threads=threads)
        assert e.value.errno == errno.EINVAL
        return
    plan = groupby_cuda.plan_groupby(schema, regions, n_groups, n_agg,
                                     strategy=strategy, threads=threads)
    assert (plan.strategy, plan.copies) == (strategy, copies)
    assert plan.threads == (threads or groupby_cuda.THREADS[strategy])
    assert plan.smem <= _H100_SMEM


def test_groupby_plan_refuses_what_cannot_fit():
    schema = _group_schema(15, "float32")
    with pytest.raises(StromError) as e:
        groupby_cuda.plan_groupby(schema, range(17), 512, 15,
                                  smem_optin=48 << 10)
    assert e.value.errno == errno.EINVAL
    with pytest.raises(StromError) as e:                # no such variant
        groupby_cuda.plan_groupby(schema, range(17), 8, 1, threads=128)
    assert e.value.errno == errno.EINVAL


@pytest.mark.parametrize("n_cols, visibility, regions", [
    (6, True, (0, 1, 2, 6)),         # the main path's int32 query
    (6, True, (1, 4, 5, 6)),         # the main path's float32 query
    (2, False, (0, 1)), (1, True, (1,)), (16, True, tuple(range(17))),
    (5, True, (4, 0)), (9, False, (3, 8, 1))])
def test_groupby_segments_bring_in_every_region(n_cols, visibility, regions):
    """Emulated bulk copies of a random page: the header's n_tuples and
    every region's words sit at the staged offsets the plan gives."""
    schema = HeapSchema(n_cols, visibility)
    segments, soff = groupby_cuda.plan_segments(schema, regions)
    rng = np.random.default_rng(n_cols)
    page = rng.integers(0, 256, PAGE_SIZE, dtype=np.uint8)
    stage = np.zeros(sum(n for _, n, _ in segments), np.uint8)
    end = 0
    for src, n, dst in segments:
        assert src % 16 == 0 and n % 16 == 0 and dst % 16 == 0 and n > 0
        assert src + n <= PAGE_SIZE and dst == end
        stage[dst:dst + n] = page[src:src + n]
        end = dst + n
    assert segments[0][0] == 0                      # the header sector
    words, staged = page.view(np.int32), stage.view(np.int32)
    assert staged[2] == words[2]
    t = schema.tuples_per_page
    for c in regions:
        start = schema.col_word_range(c)[0]
        assert np.array_equal(staged[soff[c]:soff[c] + t],
                              words[start:start + t])
    counted = 32 + 4 * t * len(set(regions))
    assert sum(n for _, n, _ in segments) <= counted + 32 * len(set(regions))


@pytest.mark.parametrize("n_cols", range(1, 17))
def test_slot_split_by_multiply_high_is_exact(n_cols):
    """The kernel splits a window's slot into (page, tuple) by a
    multiply-high with ceil(2^32 / T): exact over every slot of the
    largest window (all stages of the largest plan)."""
    for vis in (False, True):
        schema = HeapSchema(n_cols, vis)
        spec = groupby_cuda._spec(schema, GroupKey(0, 4), 4, [0],
                                  np.dtype(np.int32), FilterPred(), 0)
        t = schema.tuples_per_page
        idx = np.arange(max(groupby_cuda.STAGES.values()) * t,
                        dtype=np.uint64)
        k = (idx * np.uint64(spec.t_magic)) >> np.uint64(32)
        assert np.array_equal(k, idx // np.uint64(t))


def test_groupby_spec_carries_the_plan():
    schema = HeapSchema(6, True, ("int32", "int32", "int32", "uint32",
                                  "float32", "float32"))
    key, pred = GroupKey(1, 64), FilterPred(((0, "gt", 100),))
    spec = groupby_cuda._spec(schema, key, 64, [0, 2], np.dtype(np.int32),
                              pred, 0)
    plan = groupby_cuda.plan_groupby(schema, [0, 1, 2, 6], 64, 2)
    assert (spec.threads, spec.copies, spec.stages, spec.window) == \
        (plan.threads, plan.copies, plan.stages, plan.window)
    assert spec.key_pow2 == 1 and spec.key_soff == plan.soff[1]
    assert spec.vis_soff == plan.soff[6]
    assert list(spec.agg_soff)[:2] == [plan.soff[0], plan.soff[2]]
    assert spec.term_soff[0] == plan.soff[0]
    assert groupby_cuda.spec_smem(spec) == plan.smem
    assert not groupby_cuda._spec(schema, GroupKey(1, 7), 7, [0],
                                  np.dtype(np.int32), pred, 0).key_pow2


@pytest.mark.parametrize("offset", [4, 8, 12])
def test_groupby_cpu_pages_take_the_plain_version_at_any_alignment(offset):
    schema = HeapSchema(3, True, ("int32", "int32", "float32"))
    rng = np.random.default_rng(offset)
    n = schema.tuples_per_page * 3
    pages = build_pages([rng.integers(-50, 50, n).astype(np.int32),
                         rng.integers(-50, 50, n).astype(np.int32),
                         rng.standard_normal(n).astype(np.float32)], schema,
                        visibility=np.ones(n, np.int32))
    flat = torch.zeros(pages.nbytes + 64, dtype=torch.uint8)
    start = (-flat.data_ptr()) % 64 + offset
    view = flat[start:start + pages.nbytes].view(-1, PAGE_SIZE)
    view.copy_(torch.from_numpy(pages))
    key = GroupKey(0, 8, absolute=True)
    got = groupby_cuda.groupby_pages_cuda(view, 0, schema, key, 8,
                                          agg_cols=[1])
    want = make_groupby_fn(schema, key, 8, agg_cols=[1])(
        torch.from_numpy(pages))
    for f in ("count", "sums", "mins", "maxs"):
        assert torch.equal(got[f], want[f])


# -- B2: packed decode-filter ---------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("rpb", _RPB_CANDIDATES)
def test_packed_slot_geometry_matches_division(rpb, bits):
    """Shift and mask find row r where ``r // nw``, ``r % nw`` do, and a
    thread's rows r0 + i * THREADS share one word when nw divides
    THREADS (the kernel's hoisted load)."""
    nw = rpb * bits // 32
    for codec, data in (("bitpack", 1), ("dict", 4)):
        cm = ColCodec(codec, HEADER_WORDS, data + nw, bits=bits,
                      dsize=data if codec == "dict" else 0)
        geo = decode_cuda.column_geometry(cm)
        assert (geo["nw"], geo["data"], geo["bits"]) == (nw, data, bits)
        assert geo["vmask"] == (1 << bits) - 1
        r = np.arange(rpb)
        word, shift = decode_cuda.row_slot(r, geo["lg_nw"], bits)
        assert np.array_equal(word, r % nw)
        assert np.array_equal(shift, (r // nw) * bits)
        assert int(shift.max()) + bits <= 32
    threads, lg = decode_cuda.THREADS, (nw - 1).bit_length()
    if nw <= threads:
        for r0 in range(threads):
            rows = r0 + threads * np.arange(max(rpb // threads, 1))
            rows = rows[rows < rpb]
            word, shift = decode_cuda.row_slot(rows, lg, bits)
            assert (word == r0 & (nw - 1)).all()
            step = (threads >> lg) * bits
            sh0 = (r0 >> lg) * bits
            assert np.array_equal(shift, sh0 + step * np.arange(len(rows)))


def test_packed_geometry_refuses_a_region_not_a_power_of_two():
    with pytest.raises(StromError) as e:
        decode_cuda.column_geometry(ColCodec("bitpack", HEADER_WORDS, 1 + 96,
                                             bits=4))
    assert e.value.errno == errno.EINVAL


def _meta_of(codecs_words, rpb=1024):
    cols, off = [], HEADER_WORDS
    for codec, nwords in codecs_words:
        cols.append(ColCodec(codec, off, nwords))
        off += nwords
    return PackedMeta(1, rpb, 1, rpb, ("int32",) * len(cols), tuple(cols),
                      0, 0)


@pytest.mark.parametrize("need", [None, (), (0,), (1,), (0, 2), (2,), (3,)])
@pytest.mark.parametrize("layout", [
    [("bitpack", 129), ("dict", 136), ("rle", 5), ("raw", 1024)],
    [("raw", 2032)], [("bitpack", 2), ("rle", 129), ("raw", 7), ("raw", 1)],
    [("rle", 3), ("rle", 1), ("raw", 13), ("dict", 2)]])
def test_staged_span_covers_header_and_needed_regions(layout, need):
    meta = _meta_of(layout)
    need = None if need is None else tuple(c for c in need
                                           if c < len(layout))
    span = decode_cuda.staged_span(meta, need)
    assert span % 16 == 0 and 4 * HEADER_WORDS <= span <= PAGE_SIZE
    for c, cm in enumerate(meta.cols):
        if need is None or c in need:
            assert 4 * (cm.off + cm.nwords) <= span
    ends = [4 * (cm.off + cm.nwords) for c, cm in enumerate(meta.cols)
            if need is None or c in need]
    assert span - max(ends + [4 * HEADER_WORDS]) < 16


def test_staged_span_with_every_column_is_the_counted_bytes(tmp_path):
    rng = np.random.default_rng(7)
    n = 5000
    schema = HeapSchema(3, False, ("int32", "int32", "float32"))
    path = str(tmp_path / "s.heap")
    build_heap_file(path, [rng.integers(0, 16, n).astype(np.int32),
                           (np.arange(n) // 700).astype(np.int32),
                           rng.standard_normal(n).astype(np.float32)], schema)
    meta = build_packed(path, schema, codecs=("bitpack", "rle"))
    words = HEADER_WORDS + sum(cm.nwords for cm in meta.cols)
    assert decode_cuda.staged_span(meta, None) == -(-4 * words // 16) * 16


@pytest.mark.parametrize("n_rows", [0, 1, 31, 32, 127, 128, 1023, 1024, 1025,
                                    4096, 32767, 32768])
def test_row_chunks_cover_each_row_once(n_rows):
    chunks = decode_cuda.row_chunks(n_rows)
    seen = np.zeros(n_rows, np.int32)
    for c0, rows in chunks:
        assert 0 < rows <= decode_cuda.CHUNK_ROWS
        seen[c0:c0 + rows] += 1
    assert (seen == 1).all()
    assert decode_cuda.CHUNK_ROWS % decode_cuda.THREADS == 0


@pytest.mark.parametrize("offset", [4, 8, 12])
def test_decode_cpu_pages_take_the_plain_version_at_any_alignment(tmp_path,
                                                                   offset):
    rng = np.random.default_rng(offset)
    n = 3000
    schema = HeapSchema(2, False, ("int32", "float32"))
    path = str(tmp_path / "a.heap")
    build_heap_file(path, [rng.integers(0, 16, n).astype(np.int32),
                           rng.standard_normal(n).astype(np.float32)], schema)
    meta = build_packed(path, schema)
    raw = np.fromfile(meta.path, np.uint8)
    flat = torch.zeros(raw.nbytes + 64, dtype=torch.uint8)
    start = (-flat.data_ptr()) % 64 + offset
    view = flat[start:start + raw.nbytes].view(-1, PAGE_SIZE)
    view.copy_(torch.from_numpy(raw).view(-1, PAGE_SIZE))
    pred = FilterPred(((0, "ge", 8),))
    got = decode_cuda.decode_filter_pages_cuda(view, 0, meta, pred)
    want = make_decode_filter_fn(meta, pred)(
        torch.from_numpy(raw).view(-1, PAGE_SIZE))
    assert int(got["count"]) == int(want["count"])
    assert int(got["sums"][0]) == int(want["sums"][0])
