// Fused heap-page filter scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nvme_strom_tpu/ops/filter_pallas.py
// (_make_kernel, launched by _run_filter): decode the page header's
// n_tuples (word 2) and the columnar regions of each 8KB heap page, AND the
// visibility mask, apply a conjunction of column comparisons, and fold a
// masked count, wrapping 32-bit integer sums and float sums.
//
// Bound: memory.  Each page is read once and every tuple costs a handful
// of compares and adds, far below the card's operation rate, so the least
// time is the batch's bytes over device-memory bandwidth.  The first
// design (one 256-thread block a page) reached a fifth of it: each page
// was a chain of dependent global loads (the header's n_tuples, then
// visibility, then each column, then each column again for the sums), and
// a 512-page batch was one wave of one-page blocks.  This design:
//
// * Persistent CTAs: the wrapper sizes the grid from the kernel's
//   occupancy times the SMs, capped by the page count; CTA b takes pages
//   b, b + grid, ...  Small CTAs (128 threads, two stages) give the most
//   of them: every SM holds a dozen, so a batch's pages are all in flight
//   at once.
// * A TMA page pipeline: thread 0 keeps up to STAGES whole 8 KiB pages in
//   flight per CTA with bulk copies into shared memory, each completing on
//   its stage's mbarrier.  The header, the visibility word and every
//   column are then read from shared memory: no dependent global load, no
//   second read of a column.  A barrier after each page frees its stage
//   for the next bulk copy.
// * Per page, a thread's tuples (tid, tid + THREADS, ...) become a bit
//   mask: visibility first, then each term in turn, its compare kind and
//   op dispatched once per term and page, not per tuple.  The count and
//   the column sums are then taken over the mask.
// * Accumulators in registers across the CTA's pages, count first, one per
//   column (float bits for float columns), sized by a template on the
//   schema's column count (4, 8 or 16) so unused slots cost no registers.
// * One partial per CTA, the warps folded in a fixed order, then added to
//   the outputs with one reduction per output word and CTA (none per
//   page).  A last-CTA ticket that folded the partials in a fixed order
//   cost more than it saved: its returning atomics on one word serialise
//   across hundreds of CTAs (PERF.md).
//
// Pages must be 16-byte aligned (a bulk copy's rule); the wrapper refuses
// others.  Outputs (zeroed by the caller): count int32[1], isums int32[ni]
// (added as unsigned, so they wrap mod 2^32 exactly as the TPU's int32
// bank), fsums float32[nf] (the CTAs add in a varying order).

#include <cuda_runtime.h>
#include <stdint.h>

#include "strom_common.cuh"
#include "tma.cuh"

#define THREADS 128
#define WARPS (THREADS / 32)
#define STAGES 2
#define PAGE_BYTES (PAGE_WORDS * 4)

// Mirrored field for field by ctypes in ops/filter_cuda.py (_Spec).
struct FilterSpec {
    int n_cols;
    int tuples;            // tuples per page (T)
    int vis_off;           // visibility word offset, -1 = none
    int col_off[MAXC];     // first word of each column region
    int col_kind[MAXC];    // K_I32 | K_U32 | K_F32
    int col_slot[MAXC];    // index in isums (int kinds) or fsums (float)
    Terms terms;
};

// Word j of a partial: 0 the count, j > 0 column j - 1.
__device__ __forceinline__ bool word_is_float(const FilterSpec& s, int j) {
    return j > 0 && s.col_kind[j - 1] == K_F32;
}

__device__ __forceinline__ unsigned add_word(unsigned a, unsigned v,
                                             bool is_float) {
    return is_float ? __float_as_uint(__uint_as_float(a) + __uint_as_float(v))
                    : a + v;
}

// Clears bit i of `sel` where the term (compare kind KIND, op OP, both
// constants, so term_holds folds to one compare) fails on the thread's
// tuple i of `col`, for i < rounds (each below n_tuples).
template <int KIND, int OP>
__device__ __forceinline__ void apply_term(unsigned& sel, const int32_t* col,
                                           int col_kind, unsigned val,
                                           int rounds) {
#pragma unroll 4
    for (int i = 0; i < rounds; ++i) {
        const bool ok = term_holds(
            static_cast<unsigned>(col[threadIdx.x + i * THREADS]), col_kind,
            KIND, OP, val);
        sel &= ~(static_cast<unsigned>(!ok) << i);
    }
}

#define TERM_CASE(K, O) \
    case K * 6 + O: apply_term<K, O>(sel, col, col_kind, val, rounds); break;
#define TERM_CASES(K) \
    TERM_CASE(K, OP_GT) TERM_CASE(K, OP_GE) TERM_CASE(K, OP_LT) \
    TERM_CASE(K, OP_LE) TERM_CASE(K, OP_EQ) TERM_CASE(K, OP_NE)

// One page from shared memory into the thread's accumulators.  A page
// holds at most 2032 tuples, so a thread has at most 16 (< 32 mask bits).
template <int NC>
__device__ __forceinline__ void fold_page(const int32_t* w, int nt,
                                          const FilterSpec& s,
                                          unsigned (&acc)[NC + 1]) {
    const int tid = threadIdx.x;
    const int rounds = nt > tid ? (nt - 1 - tid) / THREADS + 1 : 0;
    unsigned sel = (1u << rounds) - 1u;
    if (s.vis_off >= 0) {
        const int32_t* vis = w + s.vis_off;
#pragma unroll 4
        for (int i = 0; i < rounds; ++i)
            sel &= ~(static_cast<unsigned>(vis[tid + i * THREADS] == 0) << i);
    }
    for (int q = 0; q < s.terms.n; ++q) {
        const int c = s.terms.col[q];
        const int32_t* col = w + s.col_off[c];
        const int col_kind = s.col_kind[c];
        const unsigned val = s.terms.val[q];
        switch (s.terms.kind[q] * 6 + s.terms.op[q]) {
            TERM_CASES(K_I32) TERM_CASES(K_U32) TERM_CASES(K_F32)
        }
    }
    acc[0] += __popc(sel);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        if (c < s.n_cols) {
            const int32_t* col = w + s.col_off[c];
            if (s.col_kind[c] == K_F32) {
                float f = __uint_as_float(acc[c + 1]);
#pragma unroll 4
                for (int i = 0; i < rounds; ++i)
                    f += (sel >> i & 1u)
                        ? __int_as_float(col[tid + i * THREADS]) : 0.f;
                acc[c + 1] = __float_as_uint(f);
            } else {
                unsigned u = acc[c + 1];
#pragma unroll 4
                for (int i = 0; i < rounds; ++i)
                    u += (sel >> i & 1u)
                        ? static_cast<unsigned>(col[tid + i * THREADS]) : 0u;
                acc[c + 1] = u;
            }
        }
    }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
filter_pages_kernel(const int32_t* __restrict__ words, long long n_pages,
                    const FilterSpec s, unsigned* __restrict__ count,
                    unsigned* __restrict__ isums, float* __restrict__ fsums) {
    __shared__ __align__(128) int32_t stage[STAGES][PAGE_WORDS];
    __shared__ __align__(8) uint64_t full[STAGES];
    __shared__ unsigned red[WARPS][NC + 1];
    // this CTA's pages: blockIdx.x + k * gridDim.x, k < mine (grid <= pages)
    const long long mine = (n_pages - 1 - blockIdx.x) / gridDim.x + 1;
    auto load = [&](long long k) {
        const int st = static_cast<int>(k % STAGES);
        mbar_expect_tx(&full[st], PAGE_BYTES);
        bulk_load(stage[st],
                  words + (blockIdx.x + k * gridDim.x) * PAGE_WORDS,
                  PAGE_BYTES, &full[st]);
    };
    if (threadIdx.x == 0) {
        for (int st = 0; st < STAGES; ++st) mbar_init(&full[st], 1);
        mbar_init_fence();
        for (long long k = 0; k < mine && k < STAGES; ++k) load(k);
    }
    __syncthreads();

    unsigned acc[NC + 1];
#pragma unroll
    for (int j = 0; j <= NC; ++j) acc[j] = 0;
    for (long long k = 0; k < mine; ++k) {
        const int st = static_cast<int>(k % STAGES);
        mbar_wait(&full[st], static_cast<uint32_t>((k / STAGES) & 1));
        const int32_t* w = stage[st];
        int nt = w[2];
        nt = nt < 0 ? 0 : (nt > s.tuples ? s.tuples : nt);
        fold_page<NC>(w, nt, s, acc);
        // every thread is done with the stage: refill it
        __syncthreads();
        if (threadIdx.x == 0 && k + STAGES < mine) load(k + STAGES);
    }

    // the CTA's partial: each word over the warp, then the warps in order
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j <= NC; ++j) {
        if (j <= s.n_cols) {
            const unsigned v = word_is_float(s, j)
                ? __float_as_uint(warp_sum(__uint_as_float(acc[j])))
                : warp_sum(acc[j]);
            if (lane == 0) red[warp][j] = v;
        }
    }
    __syncthreads();
    const int j = threadIdx.x;
    if (j > s.n_cols) return;
    const bool f = word_is_float(s, j);
    unsigned v = red[0][j];
    for (int w = 1; w < WARPS; ++w) v = add_word(v, red[w][j], f);
    if (j == 0)
        atomicAdd(count, v);
    else if (f)
        atomicAdd(fsums + s.col_slot[j - 1], __uint_as_float(v));
    else
        atomicAdd(isums + s.col_slot[j - 1], v);
}

template <int NC>
static int launch(const int32_t* words, long long n_pages,
                  const FilterSpec& s, unsigned* count, unsigned* isums,
                  float* fsums, int grid, cudaStream_t stream) {
    filter_pages_kernel<NC><<<grid, THREADS, 0, stream>>>(
        words, n_pages, s, count, isums, fsums);
    return static_cast<int>(cudaGetLastError());
}

template <int NC>
static int occupancy(int* blocks) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, filter_pages_kernel<NC>, THREADS, 0));
}

extern "C" {

// Launch the variant for up to `nc` columns (4, 8 or 16) on `stream` with
// `grid` CTAs (<= n_pages); returns the cudaError_t of the launch (0 =
// queued, cudaErrorInvalidValue for another nc).
int strom_filter_pages(const void* words, long long n_pages,
                       const void* spec, void* count, void* isums,
                       void* fsums, int nc, int grid, void* stream) {
    if (n_pages <= 0) return 0;
    const FilterSpec s = *static_cast<const FilterSpec*>(spec);
    const int32_t* w = static_cast<const int32_t*>(words);
    unsigned* c = static_cast<unsigned*>(count);
    unsigned* is = static_cast<unsigned*>(isums);
    float* fs = static_cast<float*>(fsums);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (nc) {
    case 4: return launch<4>(w, n_pages, s, c, is, fs, grid, st);
    case 8: return launch<8>(w, n_pages, s, c, is, fs, grid, st);
    case 16: return launch<16>(w, n_pages, s, c, is, fs, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// CTAs of the `nc` variant that fit on one SM of the current device at
// once, in *blocks.
int strom_filter_occupancy(int nc, int* blocks) {
    switch (nc) {
    case 4: return occupancy<4>(blocks);
    case 8: return occupancy<8>(blocks);
    case 16: return occupancy<16>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
