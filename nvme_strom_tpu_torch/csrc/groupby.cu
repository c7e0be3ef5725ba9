// GROUP BY over heap pages for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nvme_strom_tpu/ops/groupby_pallas.py
// (make_groupby_fn_pallas, kernel closure make_kernel): decode each 8KB
// heap page, AND visibility and a conjunction of column comparisons, map
// each tuple to a group id (GroupKey: (abs(c) if absolute) % mod of an
// int32/uint32 column; ids outside [0, G) fall into no group) and fold per
// group a count and, per aggregated column, sum, sum of squares, min and
// max.
//
// Bound: memory.  Each page is read once and a tuple costs a few integer
// ops and shared-memory atomics, so the least time is the batch's bytes
// over device-memory bandwidth.  The TPU kernel carried SMEM accumulators
// across a sequential grid, unrolled the int path over G and contracted
// floats as a one-hot matmul; none of that fits Hopper, where blocks run
// in any order.  Here each block keeps its own accumulators in shared
// memory, [V][G] arrays for sum, sumsq, min, max (and, for floats, NaN /
// +inf / -inf counts), walks pages grid-stride with one thread per tuple
// slot (consecutive threads read consecutive words of a column region:
// coalesced) and folds with shared-memory atomics; at the end each block
// merges the groups it touched into the global outputs with one atomic per
// group and output.
//
// Types: integer sums add as unsigned (wrap mod 2^32 for int32 and uint32
// alike); sums of squares are float32 of the value converted to float32;
// min/max compare as order-preserving int32 images: int32 as is, uint32
// sign-flipped, float32 by flipping the magnitude bits of negatives.
// Float NaN rows skip min/max (NaN has no place in that order) and sums;
// finite values sum, and NaN/+inf/-inf are counted per group, from which
// the wrapper rebuilds the IEEE results (NaN dominates, mixed infinities
// are NaN; a counted NaN makes min and max NaN, as jnp.min does).
//
// Outputs (initialised by the caller: zeros, mins = min_init, maxs =
// max_init): count int32[G]; sums [V*G] (unsigned bits or float);
// sumsq float[V*G]; mins, maxs int32 images [V*G]; nonf int32[3*V*G]
// (NaN, +inf, -inf counts, float columns only).  Index v*G + g.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strom_common.cuh"

#define THREADS 256
#define MAX_GROUPS 512

// Mirrored field for field by ctypes in ops/groupby_cuda.py (_Spec).
struct GroupSpec {
    int n_cols;
    int tuples;            // tuples per page (T)
    int vis_off;           // visibility word offset, -1 = none
    int col_off[MAXC];     // first word of each column region
    int col_kind[MAXC];    // K_I32 | K_U32 | K_F32
    Terms terms;
    int key_col;
    int key_abs;           // abs() before the mod (int32 keys)
    unsigned key_mod;      // 0 = the value itself
    int n_groups;          // G
    int n_agg;             // V
    int agg_kind;          // kind of every aggregated column
    int agg_col[MAXC];
};

__device__ __forceinline__ int order_image(unsigned bits, int kind) {
    if (kind == K_U32) return static_cast<int>(bits ^ 0x80000000u);
    if (kind == K_F32) {
        const int i = static_cast<int>(bits);
        return i >= 0 ? i : i ^ 0x7FFFFFFF;
    }
    return static_cast<int>(bits);
}

// Group id of one key value, or -1 for no group.
__device__ __forceinline__ int group_of(unsigned bits, const GroupSpec& s) {
    long long id;
    if (s.col_kind[s.key_col] == K_U32) {
        id = s.key_mod ? bits % s.key_mod : bits;
    } else {
        int x = static_cast<int>(bits);
        if (s.key_abs && x < 0)
            x = static_cast<int>(0u - bits);   // abs(INT_MIN) wraps
        if (s.key_mod) {
            const int m = static_cast<int>(s.key_mod);
            int r = x % m;                     // floor modulo, m > 0
            x = r < 0 ? r + m : r;
        }
        id = x;
    }
    return (id >= 0 && id < s.n_groups) ? static_cast<int>(id) : -1;
}

__global__ void __launch_bounds__(THREADS)
groupby_pages_kernel(const int32_t* __restrict__ words, long long n_pages,
                     const GroupSpec s, int min_init, int max_init,
                     int* __restrict__ count, unsigned* __restrict__ sums,
                     float* __restrict__ sumsq, int* __restrict__ mins,
                     int* __restrict__ maxs, int* __restrict__ nonf) {
    extern __shared__ int smem[];
    const int G = s.n_groups;
    const int VG = s.n_agg * G;
    const bool is_f = s.agg_kind == K_F32;
    int* s_count = smem;
    unsigned* s_sum = reinterpret_cast<unsigned*>(s_count + G);
    float* s_sq = reinterpret_cast<float*>(s_sum + VG);
    int* s_min = reinterpret_cast<int*>(s_sq + VG);
    int* s_max = s_min + VG;
    int* s_nonf = s_max + VG;                  // floats only: 3 * VG

    for (int i = threadIdx.x; i < G; i += THREADS) s_count[i] = 0;
    for (int i = threadIdx.x; i < VG; i += THREADS) {
        s_sum[i] = 0u;
        s_sq[i] = 0.f;
        s_min[i] = min_init;
        s_max[i] = max_init;
    }
    if (is_f)
        for (int i = threadIdx.x; i < 3 * VG; i += THREADS) s_nonf[i] = 0;
    __syncthreads();

    const int key_off = s.col_off[s.key_col];
    for (long long p = blockIdx.x; p < n_pages; p += gridDim.x) {
        const int32_t* w = words + p * PAGE_WORDS;
        int nt = __ldg(w + 2);
        nt = nt < 0 ? 0 : (nt > s.tuples ? s.tuples : nt);
        for (int t = threadIdx.x; t < nt; t += THREADS) {
            bool sel = s.vis_off < 0 || __ldg(w + s.vis_off + t) != 0;
            const int g = group_of(static_cast<unsigned>(__ldg(w + key_off + t)),
                                   s);
            sel &= g >= 0;
            for (int k = 0; k < s.terms.n; ++k) {
                const int c = s.terms.col[k];
                const unsigned v = static_cast<unsigned>(
                    __ldg(w + s.col_off[c] + t));
                sel &= term_holds(v, s.col_kind[c], s.terms.kind[k],
                                  s.terms.op[k], s.terms.val[k]);
            }
            if (!sel) continue;
            atomicAdd(s_count + g, 1);
            for (int a = 0; a < s.n_agg; ++a) {
                const unsigned bits = static_cast<unsigned>(
                    __ldg(w + s.col_off[s.agg_col[a]] + t));
                const int i = a * G + g;
                if (is_f) {
                    const float x = __uint_as_float(bits);
                    if (isnan(x)) {
                        atomicAdd(s_nonf + i, 1);
                        continue;
                    }
                    if (isinf(x)) {
                        atomicAdd(s_nonf + (x > 0.f ? VG : 2 * VG) + i, 1);
                    } else {
                        atomicAdd(reinterpret_cast<float*>(s_sum) + i, x);
                        atomicAdd(s_sq + i, x * x);
                    }
                } else {
                    atomicAdd(s_sum + i, bits);
                    const float xf = as_f32(bits, s.agg_kind);
                    atomicAdd(s_sq + i, xf * xf);
                }
                const int img = order_image(bits, s.agg_kind);
                atomicMin(s_min + i, img);
                atomicMax(s_max + i, img);
            }
        }
    }
    __syncthreads();

    // merge the groups this block touched
    for (int g = threadIdx.x; g < G; g += THREADS) {
        const int c = s_count[g];
        if (c == 0) continue;
        atomicAdd(count + g, c);
        for (int a = 0; a < s.n_agg; ++a) {
            const int i = a * G + g;
            if (is_f) {
                const float f = reinterpret_cast<float*>(s_sum)[i];
                if (f != 0.f) atomicAdd(reinterpret_cast<float*>(sums) + i, f);
                for (int q = 0; q < 3; ++q) {
                    const int n = s_nonf[q * VG + i];
                    if (n) atomicAdd(nonf + q * VG + i, n);
                }
            } else if (s_sum[i]) {
                atomicAdd(sums + i, s_sum[i]);
            }
            if (s_sq[i] != 0.f) atomicAdd(sumsq + i, s_sq[i]);
            if (s_min[i] != min_init) atomicMin(mins + i, s_min[i]);
            if (s_max[i] != max_init) atomicMax(maxs + i, s_max[i]);
        }
    }
}

// Dynamic shared memory of one block for G groups and V columns.
static int smem_bytes(int n_groups, int n_agg, bool is_float) {
    return 4 * n_groups + 4 * n_agg * n_groups * (is_float ? 7 : 4);
}

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int strom_groupby_pages(const void* words, long long n_pages,
                        const void* spec, int min_init, int max_init,
                        void* count, void* sums, void* sumsq, void* mins,
                        void* maxs, void* nonf, int grid, void* stream) {
    if (n_pages <= 0) return 0;
    const GroupSpec s = *static_cast<const GroupSpec*>(spec);
    if (s.n_groups < 1 || s.n_groups > MAX_GROUPS || s.n_agg < 1
            || s.n_agg > MAXC)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = smem_bytes(s.n_groups, s.n_agg, s.agg_kind == K_F32);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            groupby_pages_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    groupby_pages_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), n_pages, s, min_init, max_init,
        static_cast<int*>(count), static_cast<unsigned*>(sums),
        static_cast<float*>(sumsq), static_cast<int*>(mins),
        static_cast<int*>(maxs), static_cast<int*>(nonf));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
