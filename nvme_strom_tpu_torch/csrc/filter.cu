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
// time is the batch's bytes over device-memory bandwidth.  The design
// serves that bound simply: one block walks pages (grid-stride), one
// thread per tuple slot, so consecutive threads read consecutive words of
// a column region (coalesced); accumulators stay in registers (one per
// column, indexed statically), and each block folds them with warp
// shuffles, one shared-memory pass, and a single atomicAdd per output.
// The TPU kernel's 8-page blocks and zero-page padding have no role here:
// a page with n_tuples == 0 simply does no work.
//
// Outputs (zeroed by the caller): count int32[1], isums int32[ni] (added
// as unsigned, so they wrap mod 2^32 exactly as the TPU's int32 bank),
// fsums float32[nf] (atomic order varies from run to run).

#include <cuda_runtime.h>
#include <stdint.h>

#include "strom_common.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)

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

__global__ void __launch_bounds__(THREADS)
filter_pages_kernel(const int32_t* __restrict__ words, long long n_pages,
                    const FilterSpec s, unsigned* __restrict__ count,
                    unsigned* __restrict__ isums, float* __restrict__ fsums) {
    unsigned cnt = 0;
    unsigned acc_i[MAXC];
    float acc_f[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        acc_i[c] = 0;
        acc_f[c] = 0.f;
    }
    for (long long p = blockIdx.x; p < n_pages; p += gridDim.x) {
        const int32_t* w = words + p * PAGE_WORDS;
        int nt = __ldg(w + 2);
        nt = nt < 0 ? 0 : (nt > s.tuples ? s.tuples : nt);
        // branch-free per tuple: every load is issued unconditionally, so
        // the visibility, predicate and sum loads are in flight together
        // instead of each waiting on the previous branch
        for (int t = threadIdx.x; t < nt; t += THREADS) {
            bool sel = s.vis_off < 0 || __ldg(w + s.vis_off + t) != 0;
            for (int k = 0; k < s.terms.n; ++k) {
                const int c = s.terms.col[k];
                const unsigned v = (unsigned)__ldg(w + s.col_off[c] + t);
                sel &= term_holds(v, s.col_kind[c], s.terms.kind[k],
                                  s.terms.op[k], s.terms.val[k]);
            }
            cnt += sel;
#pragma unroll
            for (int c = 0; c < MAXC; ++c) {
                if (c < s.n_cols) {
                    const unsigned v = (unsigned)__ldg(w + s.col_off[c] + t);
                    if (s.col_kind[c] == K_F32)
                        acc_f[c] += sel ? __uint_as_float(v) : 0.f;
                    else
                        acc_i[c] += sel ? v : 0u;
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
            unsigned v = lane < WARPS ? sh_i[lane][c + 1] : 0u;
            v = warp_sum(v);
            if (lane == 0 && v) atomicAdd(isums + s.col_slot[c], v);
        }
    }
}

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int strom_filter_pages(const void* words, long long n_pages,
                       const void* spec, void* count, void* isums,
                       void* fsums, int grid, void* stream) {
    if (n_pages <= 0) return 0;
    const FilterSpec s = *static_cast<const FilterSpec*>(spec);
    filter_pages_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), n_pages, s,
        static_cast<unsigned*>(count), static_cast<unsigned*>(isums),
        static_cast<float*>(fsums));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
