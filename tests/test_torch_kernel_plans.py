"""Host-side planning of the Hopper kernels B4 (ring permute) and B1 (page
filter), as pure functions the CPU reaches: B4's split of a block into an
unaligned head, per-CTA ranges of bulk copies and a tail; B1's variant by
column count, its persistent grid and its refusal of pages a bulk copy
cannot take.  The kernels themselves run only on the card
(``chip_smoke.py`` phases [3a], [8], [9a])."""

import errno

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from nvme_strom_tpu_torch.api import StromError
from nvme_strom_tpu_torch.ops import filter_cuda, permute_cuda
from nvme_strom_tpu_torch.ops.filter import (DEFAULT_SCHEMA, STEP_PRED,
                                             make_filter_fn)
from nvme_strom_tpu_torch.ops.permute_cuda import (BULK_MIN_BYTES,
                                                   STAGE_BYTES, plan_send,
                                                   send_pieces)
from nvme_strom_tpu_torch.scan.heap import PAGE_SIZE, HeapSchema, build_pages

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
