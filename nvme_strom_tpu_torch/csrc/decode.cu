// Fused decode -> filter -> aggregate over packed (.cpk) pages for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel nvme_strom_tpu/ops/decode_pallas.py
// (make_decode_filter_fn_pallas, kernel _make_kernel): each 8KB packed page
// carries rows_per_block (rpb, 32 to 32768) rows in per-column regions
// (scan/colpack.py): raw words, frame-of-reference bit-packing, a
// dictionary with bit-packed indices, or run-length values and ends.  The
// kernel expands every row, applies a conjunction of column comparisons and
// folds a masked count, wrapping 32-bit integer sums and float sums.
// Decoded rows never reach device memory; that is the point of pushdown.
//
// Bound: memory.  Each packed page's header and the regions of the columns
// it decodes are read once; a row costs a few shifts, masks and compares
// per column, far below the card's operation rate, so the least time is
// those bytes over device-memory bandwidth.  The first design (a row per
// thread per step, every column expanded into MAXC-wide register arrays
// through a per-row codec switch, runtime divisions for the packed slot, a
// binary search of the run ends in global memory per row) was bound by its
// instructions and latency at 109 registers and a quarter occupancy.  This
// design:
//
// * Persistent CTAs: the wrapper sizes the grid from the kernel's
//   occupancy at the plan's shared memory, capped by the pages.
// * A TMA page pipeline: thread 0 keeps `stages` pages in flight, each one
//   bulk copy of the span from the page's first word to the end of the
//   last decoded region, rounded up to 16 bytes (regions are contiguous
//   from the 64-byte header, so with every column decoded that is the
//   bytes the bound counts).  Dictionaries, run tables and packed words are
//   then read from shared memory.
// * No runtime division: rows_per_block and every packed width are powers
//   of two, so the region of nw words holds row r in word r & (nw - 1) at
//   shift (r >> log2 nw) * bits; the wrapper passes log2 nw.
// * Column by column, as the page filter (filter.cu) does: a thread's rows
//   of a chunk (tid + i * THREADS, i < ROUNDS, unrolled) become a bit mask,
//   each term clearing the bits its compare fails; the codec is dispatched
//   once per column and chunk and a term's op once per term and chunk,
//   never per row.  Then the count is a popcount and each decoded column
//   one masked sum (skipped where no row of the warp is left).  Where the
//   packed words divide THREADS, a thread's rows of a chunk share one word,
//   loaded once.  A run-length column finds the run of the thread's first
//   row by binary search over the run ends in shared memory, then keeps
//   the run's end and value in registers and steps forward.
// * Accumulators in registers across the CTA's pages, sized by a template
//   on the column count (4, 8 or 16), reduced per warp, then one reduction
//   per CTA and output word.
//
// Pages must be 16-byte aligned (a bulk copy's rule); the wrapper refuses
// others.  Outputs (zeroed by the caller): count int32[1], isums int32[ni]
// (added as unsigned: they wrap mod 2^32 as the TPU's int32 bank), fsums
// float[nf] (the CTAs add in a varying order).

#include <cuda_runtime.h>
#include <stdint.h>

#include "strom_common.cuh"
#include "tma.cuh"

#define THREADS 128
#define WARPS (THREADS / 32)
#define ROUNDS 8                    // rows of a thread in one chunk
#define CHUNK_ROWS (ROUNDS * THREADS)
#define BAR_BYTES 128               // the stages' mbarriers, before them
#define CPK_MAGIC 0x43504B31u

enum { C_ZERO = 0, C_RAW, C_BITPACK, C_DICT, C_RLE };

// Mirrored field for field by ctypes in ops/decode_cuda.py (_Spec).
struct DecodeSpec {
    int n_cols;
    int rpb;               // rows per block (page)
    int codec[MAXC];       // C_ZERO (not decoded) | C_RAW | ... | C_RLE
    int off[MAXC];         // region word offset (in the page and the stage)
    int lg_nw[MAXC];       // log2 of the packed words (bitpack, dict)
    int bits[MAXC];        // packed width (bitpack, dict)
    int dsize[MAXC];       // dictionary slots (dict)
    int rmax[MAXC];        // run slots (rle)
    int col_kind[MAXC];    // K_I32 | K_U32 | K_F32
    int col_slot[MAXC];    // index in isums (int kinds) or fsums (float)
    Terms terms;
    int span_bytes;        // staged bytes a page (multiple of 16, <= 8192)
    int stages;            // pages in flight per CTA
};

// Calls f(i, value) for the thread's rows r = r0 + i * THREADS, i < rounds
// (<= ROUNDS, unrolled), of column region `reg` in codec CODEC.
template <int CODEC, typename F>
__device__ __forceinline__ void walk(const uint32_t* reg, const DecodeSpec& s,
                                     int c, int r0, int rounds, F& f) {
    if (CODEC == C_RAW) {
#pragma unroll
        for (int i = 0; i < ROUNDS; ++i)
            if (i < rounds) f(i, reg[r0 + i * THREADS]);
    } else if (CODEC == C_BITPACK || CODEC == C_DICT) {
        const int lg = s.lg_nw[c];
        const int m = (1 << lg) - 1;
        const int bits = s.bits[c];
        const unsigned vm = (1u << bits) - 1u;
        const int dsize = s.dsize[c];
        const uint32_t* packed = reg + (CODEC == C_BITPACK ? 1 : dsize);
        const unsigned base = CODEC == C_BITPACK ? reg[0] : 0u;
        auto emit = [&](int i, unsigned x) {
            if (CODEC == C_BITPACK)
                f(i, x + base);
            else
                f(i, x < static_cast<unsigned>(dsize) ? reg[x] : 0u);
        };
        if (m < THREADS) {
            // nw divides THREADS: the thread's rows share one packed word,
            // each THREADS >> lg slots further along it
            const unsigned word = packed[r0 & m];
            const int sh0 = (r0 >> lg) * bits;
            const int step = (THREADS >> lg) * bits;
#pragma unroll
            for (int i = 0; i < ROUNDS; ++i)
                if (i < rounds) emit(i, (word >> (sh0 + i * step)) & vm);
        } else {
#pragma unroll
            for (int i = 0; i < ROUNDS; ++i) {
                if (i < rounds) {
                    const int r = r0 + i * THREADS;
                    emit(i, (packed[r & m] >> ((r >> lg) * bits)) & vm);
                }
            }
        }
    } else if (CODEC == C_RLE) {
        // the first run whose cumulative end is past r: binary search for
        // the first row, then forward steps (rows ascend, ends do too),
        // the current run's end and value kept in registers
        const int rmax = s.rmax[c];
        const int32_t* ends = reinterpret_cast<const int32_t*>(reg + 1 + rmax);
        int lo = 0, hi = rmax;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (ends[mid] <= r0) lo = mid + 1; else hi = mid;
        }
        int end = lo < rmax ? ends[lo] : 0x7FFFFFFF;
        unsigned val = lo < rmax ? reg[1 + lo] : 0u;
#pragma unroll
        for (int i = 0; i < ROUNDS; ++i) {
            if (i < rounds) {
                const int r = r0 + i * THREADS;
                if (end <= r) {
                    do { ++lo; } while (lo < rmax && ends[lo] <= r);
                    end = lo < rmax ? ends[lo] : 0x7FFFFFFF;
                    val = lo < rmax ? reg[1 + lo] : 0u;
                }
                f(i, val);
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < ROUNDS; ++i)
            if (i < rounds) f(i, 0u);
    }
}

template <typename F>
__device__ __forceinline__ void walk_column(const uint32_t* w,
                                            const DecodeSpec& s, int c,
                                            int r0, int rounds, F& f) {
    const uint32_t* reg = w + s.off[c];
    switch (s.codec[c]) {
    case C_RAW: walk<C_RAW>(reg, s, c, r0, rounds, f); break;
    case C_BITPACK: walk<C_BITPACK>(reg, s, c, r0, rounds, f); break;
    case C_DICT: walk<C_DICT>(reg, s, c, r0, rounds, f); break;
    case C_RLE: walk<C_RLE>(reg, s, c, r0, rounds, f); break;
    default: walk<C_ZERO>(reg, s, c, r0, rounds, f);
    }
}

// Clears bit i of `sel` where the term (op OP; a float compare when FLT,
// else unsigned bits after flipping `flip`, which makes a signed compare
// of int32) fails on the thread's row i of column c.
template <int OP, bool FLT>
__device__ __forceinline__ void apply_term(const uint32_t* w,
                                           const DecodeSpec& s, int c,
                                           unsigned val, unsigned flip,
                                           int r0, int rounds,
                                           unsigned& sel) {
    const int ck = s.col_kind[c];
    const float fv = __uint_as_float(val);
    const unsigned b = val ^ flip;
    auto term = [&](int i, unsigned x) {
        bool ok;
        if (FLT)
            ok = compare(as_f32(x, ck), fv, OP);
        else
            ok = compare(x ^ flip, b, OP);
        sel &= ~(static_cast<unsigned>(!ok) << i);
    };
    walk_column(w, s, c, r0, rounds, term);
}

#define TERM_CASE(O) \
    case O: \
        if (flt) apply_term<O, true>(w, s, c, val, flip, r0, rounds, sel); \
        else apply_term<O, false>(w, s, c, val, flip, r0, rounds, sel); \
        break;

__device__ __forceinline__ unsigned add_word(unsigned a, unsigned v,
                                             bool is_float) {
    return is_float ? __float_as_uint(__uint_as_float(a) + __uint_as_float(v))
                    : a + v;
}

// Word j of a partial: 0 the count, j > 0 column j - 1.
__device__ __forceinline__ bool word_is_float(const DecodeSpec& s, int j) {
    return j > 0 && s.col_kind[j - 1] == K_F32;
}

// One page from shared memory into the thread's accumulators, a chunk of
// CHUNK_ROWS rows at a time: the terms turn the thread's rows of the chunk
// into a bit mask, then the count and each decoded column's masked sum.
template <int NC>
__device__ __forceinline__ void fold_page(const uint32_t* w, int n,
                                          const DecodeSpec& s,
                                          unsigned (&acc)[NC + 1]) {
    const int tid = threadIdx.x;
    for (int c0 = 0; c0 < n; c0 += CHUNK_ROWS) {
        const int rows = n - c0 < CHUNK_ROWS ? n - c0 : CHUNK_ROWS;
        const int rounds = rows > tid ? (rows - 1 - tid) / THREADS + 1 : 0;
        unsigned sel = (1u << rounds) - 1u;
        const int r0 = c0 + tid;
        for (int q = 0; q < s.terms.n; ++q) {
            const int c = s.terms.col[q];
            const unsigned val = s.terms.val[q];
            const bool flt = s.terms.kind[q] == K_F32;
            const unsigned flip = s.terms.kind[q] == K_I32 ? 0x80000000u : 0u;
            switch (s.terms.op[q]) {
                TERM_CASE(OP_GT) TERM_CASE(OP_GE) TERM_CASE(OP_LT)
                TERM_CASE(OP_LE) TERM_CASE(OP_EQ) TERM_CASE(OP_NE)
            }
        }
        acc[0] += __popc(sel);
        if (!__any_sync(0xffffffffu, sel)) continue;   // no row of the warp
        for (int c = 0; c < s.n_cols; ++c) {
            if (s.codec[c] == C_ZERO) continue;
            const bool is_f = s.col_kind[c] == K_F32;
            unsigned part = 0;
            if (is_f) {
                float f = 0.f;
                auto add = [&](int i, unsigned x) {
                    f += (sel >> i & 1u) ? __uint_as_float(x) : 0.f;
                };
                walk_column(w, s, c, r0, rounds, add);
                part = __float_as_uint(f);
            } else {
                auto add = [&](int i, unsigned x) {
                    part += (sel >> i & 1u) ? x : 0u;
                };
                walk_column(w, s, c, r0, rounds, add);
            }
#pragma unroll
            for (int j = 1; j <= NC; ++j)
                if (j == c + 1) acc[j] = add_word(acc[j], part, is_f);
        }
    }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
decode_filter_kernel(const uint32_t* __restrict__ words, long long n_pages,
                     const DecodeSpec s, unsigned* __restrict__ count,
                     unsigned* __restrict__ isums,
                     float* __restrict__ fsums) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    unsigned char* stage = smem + BAR_BYTES;
    __shared__ unsigned red[WARPS][NC + 1];
    const int S = s.stages;
    // this CTA's pages: blockIdx.x + j * gridDim.x, j < mine (grid <= pages)
    const long long mine = (n_pages - 1 - blockIdx.x) / gridDim.x + 1;
    auto load = [&](long long j) {
        const int st = static_cast<int>(j % S);
        mbar_expect_tx(&full[st], s.span_bytes);
        bulk_load(stage + st * s.span_bytes,
                  words + (blockIdx.x + j * gridDim.x) * PAGE_WORDS,
                  s.span_bytes, &full[st]);
    };
    if (threadIdx.x == 0) {
        for (int st = 0; st < S; ++st) mbar_init(&full[st], 1);
        mbar_init_fence();
        for (long long j = 0; j < mine && j < S; ++j) load(j);
    }
    __syncthreads();

    unsigned acc[NC + 1];
#pragma unroll
    for (int j = 0; j <= NC; ++j) acc[j] = 0;
    int st = 0;
    uint32_t parity = 0;
    for (long long j = 0; j < mine; ++j) {
        mbar_wait(&full[st], parity);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(
            stage + st * s.span_bytes);
        if (w[0] == CPK_MAGIC) {             // else a header page, padding
            int n = static_cast<int>(w[2]);
            n = n < 0 ? 0 : (n > s.rpb ? s.rpb : n);
            fold_page<NC>(w, n, s, acc);
        }
        // every thread is done with the stage: refill it
        __syncthreads();
        if (threadIdx.x == 0 && j + S < mine) load(j + S);
        if (++st == S) {
            st = 0;
            parity ^= 1u;
        }
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
    if (j > s.n_cols || (j > 0 && s.codec[j - 1] == C_ZERO)) return;
    const bool f = word_is_float(s, j);
    unsigned v = red[0][j];
    for (int q = 1; q < WARPS; ++q) v = add_word(v, red[q][j], f);
    if (j == 0)
        atomicAdd(count, v);
    else if (f)
        atomicAdd(fsums + s.col_slot[j - 1], __uint_as_float(v));
    else
        atomicAdd(isums + s.col_slot[j - 1], v);
}

typedef void (*KernelFn)(const uint32_t*, long long, const DecodeSpec,
                         unsigned*, unsigned*, float*);

static KernelFn variant(int nc) {
    switch (nc) {
    case 4: return decode_filter_kernel<4>;
    case 8: return decode_filter_kernel<8>;
    case 16: return decode_filter_kernel<16>;
    default: return nullptr;
    }
}

extern "C" {

// Launch the variant for up to `nc` columns (4, 8 or 16) on `stream` with
// `grid` CTAs (<= n_pages) and the plan's dynamic shared memory; returns
// the cudaError_t of the launch (0 = queued, cudaErrorInvalidValue for
// another nc or a spec the kernel does not take).
int strom_decode_filter_pages(const void* words, long long n_pages,
                              const void* spec, void* count, void* isums,
                              void* fsums, int nc, int grid, void* stream) {
    if (n_pages <= 0) return 0;
    const DecodeSpec s = *static_cast<const DecodeSpec*>(spec);
    const KernelFn fn = variant(nc);
    if (!fn || s.n_cols > nc || s.stages < 1 || s.span_bytes < 16
            || s.span_bytes > PAGE_WORDS * 4 || s.span_bytes % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = BAR_BYTES + s.stages * s.span_bytes;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    fn<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), n_pages, s,
        static_cast<unsigned*>(count), static_cast<unsigned*>(isums),
        static_cast<float*>(fsums));
    return static_cast<int>(cudaGetLastError());
}

// CTAs of the `nc` variant with `smem` bytes of dynamic shared memory that
// fit on one SM of the current device at once, in *blocks.
int strom_decode_occupancy(int nc, int smem, int* blocks) {
    const KernelFn fn = variant(nc);
    if (!fn) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fn, THREADS, smem));
}

}  // extern "C"
