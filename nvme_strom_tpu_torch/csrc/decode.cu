// Fused decode -> filter -> aggregate over packed (.cpk) pages for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel nvme_strom_tpu/ops/decode_pallas.py
// (make_decode_filter_fn_pallas, kernel _make_kernel): each 8KB packed page
// carries rows_per_block (rpb, up to 32768) rows in per-column regions
// (scan/colpack.py): raw words, frame-of-reference bit-packing, a
// dictionary with bit-packed indices, or run-length values and ends.  The
// kernel expands every row in registers, applies a conjunction of column
// comparisons and folds a masked count, wrapping 32-bit integer sums and
// float sums.  Decoded rows never reach device memory; that is the point
// of pushdown.
//
// Bound: memory.  Each packed page is read once; a row costs a few shifts,
// masks and compares per column, far below the card's operation rate, so
// the least time is the batch's packed bytes over device-memory bandwidth.
// The TPU kernel decoded (block_pages, rpb) tensors in VMEM, a static
// D-way select for dictionaries and an R-step interval mask for runs.
// Here a block walks pages grid-stride and loops over a page's rows, one
// row per thread per step: the planar layout puts row j of a bit-packed
// region in word j % nw, so neighbouring threads read neighbouring words
// (coalesced).  A dictionary value is one indexed load from the page's
// region; a run is found by binary search over the page's cumulative ends
// (<= 64, nondecreasing as build_packed writes them), both served from L1.
// Sums stay in registers (one per column, indexed statically), then warp
// shuffles, one shared-memory pass and one atomicAdd per block and output.
//
// Outputs (zeroed by the caller): count int32[1], isums int32[ni] (added as
// unsigned: they wrap mod 2^32 as the TPU's int32 bank), fsums float[nf].

#include <cuda_runtime.h>
#include <stdint.h>

#include "strom_common.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define CPK_MAGIC 0x43504B31u

enum { C_ZERO = 0, C_RAW, C_BITPACK, C_DICT, C_RLE };

// Mirrored field for field by ctypes in ops/decode_cuda.py (_Spec).
struct DecodeSpec {
    int n_cols;
    int rpb;               // rows per block (page)
    int codec[MAXC];       // C_ZERO (not needed) | C_RAW | ... | C_RLE
    int off[MAXC];         // region word offset
    int nwords[MAXC];
    int bits[MAXC];
    int dsize[MAXC];
    int rmax[MAXC];
    int col_kind[MAXC];    // K_I32 | K_U32 | K_F32
    int col_slot[MAXC];    // index in isums (int kinds) or fsums (float)
    Terms terms;
};

// Row r's 32 bits in column c of the page at w.
__device__ __forceinline__ unsigned decode_value(const uint32_t* __restrict__ w,
                                                 const DecodeSpec& s, int c,
                                                 int r) {
    const uint32_t* reg = w + s.off[c];
    switch (s.codec[c]) {
    case C_RAW:
        return __ldg(reg + r);
    case C_BITPACK: {
        const int nw = s.nwords[c] - 1;
        const unsigned word = __ldg(reg + 1 + r % nw);
        const unsigned mask = (1u << s.bits[c]) - 1u;
        return ((word >> ((r / nw) * s.bits[c])) & mask) + __ldg(reg);
    }
    case C_DICT: {
        const int nw = s.nwords[c] - s.dsize[c];
        const unsigned word = __ldg(reg + s.dsize[c] + r % nw);
        const unsigned mask = (1u << s.bits[c]) - 1u;
        const unsigned idx = (word >> ((r / nw) * s.bits[c])) & mask;
        return idx < static_cast<unsigned>(s.dsize[c]) ? __ldg(reg + idx) : 0u;
    }
    case C_RLE: {
        // first run whose cumulative end is past r
        const int rmax = s.rmax[c];
        const int32_t* ends = reinterpret_cast<const int32_t*>(reg + 1 + rmax);
        int lo = 0, hi = rmax;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(ends + mid) <= r) lo = mid + 1; else hi = mid;
        }
        return lo < rmax ? __ldg(reg + 1 + lo) : 0u;
    }
    default:
        return 0u;
    }
}

__global__ void __launch_bounds__(THREADS)
decode_filter_kernel(const uint32_t* __restrict__ words, long long n_pages,
                     const DecodeSpec s, unsigned* __restrict__ count,
                     unsigned* __restrict__ isums,
                     float* __restrict__ fsums) {
    unsigned cnt = 0;
    unsigned acc_i[MAXC];
    float acc_f[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        acc_i[c] = 0;
        acc_f[c] = 0.f;
    }
    for (long long p = blockIdx.x; p < n_pages; p += gridDim.x) {
        const uint32_t* w = words + p * PAGE_WORDS;
        if (__ldg(w) != CPK_MAGIC) continue;      // header page, padding
        int n = static_cast<int>(__ldg(w + 2));
        n = n < 0 ? 0 : (n > s.rpb ? s.rpb : n);
        for (int r = threadIdx.x; r < n; r += THREADS) {
            unsigned v[MAXC];
#pragma unroll
            for (int c = 0; c < MAXC; ++c)
                v[c] = c < s.n_cols ? decode_value(w, s, c, r) : 0u;
            bool sel = true;
            for (int k = 0; k < s.terms.n; ++k) {
                unsigned x = 0;
#pragma unroll
                for (int c = 0; c < MAXC; ++c)
                    if (c == s.terms.col[k]) x = v[c];
                sel &= term_holds(x, s.col_kind[s.terms.col[k]],
                                  s.terms.kind[k], s.terms.op[k],
                                  s.terms.val[k]);
            }
            cnt += sel;
#pragma unroll
            for (int c = 0; c < MAXC; ++c) {
                if (c < s.n_cols) {
                    if (s.col_kind[c] == K_F32)
                        acc_f[c] += sel ? __uint_as_float(v[c]) : 0.f;
                    else
                        acc_i[c] += sel ? v[c] : 0u;
                }
            }
        }
    }

    __shared__ unsigned sh_i[WARPS][MAXC + 1];
    __shared__ float sh_f[WARPS][MAXC];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    cnt = warp_sum(cnt);
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        if (c < s.n_cols) {
            acc_i[c] = warp_sum(acc_i[c]);
            acc_f[c] = warp_sum(acc_f[c]);
        }
    }
    if (lane == 0) {
        sh_i[warp][0] = cnt;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
            sh_i[warp][c + 1] = acc_i[c];
            sh_f[warp][c] = acc_f[c];
        }
    }
    __syncthreads();
    if (warp != 0) return;
    unsigned u = lane < WARPS ? sh_i[lane][0] : 0u;
    u = warp_sum(u);
    if (lane == 0 && u) atomicAdd(count, u);
    for (int c = 0; c < s.n_cols; ++c) {
        if (s.col_kind[c] == K_F32) {
            float f = lane < WARPS ? sh_f[lane][c] : 0.f;
            f = warp_sum(f);
            if (lane == 0 && f != 0.f) atomicAdd(fsums + s.col_slot[c], f);
        } else {
            unsigned x = lane < WARPS ? sh_i[lane][c + 1] : 0u;
            x = warp_sum(x);
            if (lane == 0 && x) atomicAdd(isums + s.col_slot[c], x);
        }
    }
}

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int strom_decode_filter_pages(const void* words, long long n_pages,
                              const void* spec, void* count, void* isums,
                              void* fsums, int grid, void* stream) {
    if (n_pages <= 0) return 0;
    const DecodeSpec s = *static_cast<const DecodeSpec*>(spec);
    decode_filter_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), n_pages, s,
        static_cast<unsigned*>(count), static_cast<unsigned*>(isums),
        static_cast<float*>(fsums));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
