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
// Bound: memory.  Each page's header and the column regions the query
// touches are read once, and a tuple costs a few integer ops and
// accumulator updates, so the least time is those bytes over device-memory
// bandwidth.  The TPU kernel carried accumulators across a sequential
// grid; on Hopper blocks run in any order.  The first design (one thread
// per tuple slot, shared atomics per tuple, a block per few pages, every
// block merging into global memory) reached a tenth of the bound: its page
// loads were chains of dependent global loads, its atomics replayed on the
// few addresses of a small G, and hundreds of blocks merged every group.
// This design:
//
// * Persistent CTAs: the wrapper sizes the grid from the kernel's
//   occupancy at the plan's shared memory, capped by the pages; CTA b takes
//   pages b, b + grid, ...
// * A TMA region pipeline: thread 0 keeps up to `stages` pages in flight,
//   each as a few bulk copies of only the header sector and the regions the
//   query reads (visibility, key, predicate and aggregated columns), each
//   rounded out to 16 bytes and merged where they touch (ops/groupby_cuda.py
//   plan_segments).  Every tuple is then read from shared memory.
// * Full lanes: the pages of a window (half the stages) are one flat range
//   of (page, tuple) slots, split by a multiply-high with ceil(2^32 / T),
//   so a 290-tuple page does not leave a pass with 34 live threads.  A
//   thread takes ROUNDS slots a pass: first a bit mask of the live,
//   visible slots, each term clearing its failures with its compare kind
//   and op dispatched once a pass (as filter.cu does), then the updates of
//   the slots left.
// * Accumulators in shared memory, word w of copy r at w * R + r, chosen
//   by the plan from (G, V) and the card's shared memory: one copy per lane
//   (R = 32: atomics that never collide within a warp, every lane in its
//   own bank) while the copies stay small, else one copy per CTA (R = 1),
//   in larger CTAs that hold all their pages at once.  Registers
//   (predicated updates of every group, G <= 8) and one copy per thread
//   (plain loads and stores) measured slower than the per-lane copies
//   (PERF.md).  A float's NaN/+inf/-inf counts go straight to the output
//   buffer with a global atomic: they are rare, and it keeps the shared
//   copies small.
// * One merge per CTA: the R copies fold word by word (each thread starting
//   at its own lane's copy, free of bank conflicts), then one global atomic
//   per word that moved.
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
// Outputs: one int32 buffer, initialised by the caller (zeros, mins =
// min_init, maxs = max_init), words [count G | sums VG | sumsq VG | mins
// VG | maxs VG | nonf 3VG] (sums unsigned bits or float, sumsq float,
// mins/maxs order images, nonf the NaN, +inf, -inf counts of float
// columns), index v*G + g within each part.  The shared accumulators use
// the same word order, without nonf.  Pages must be 16-byte aligned (a
// bulk copy's rule); the wrapper refuses others.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strom_common.cuh"
#include "tma.cuh"

#define MAX_GROUPS 512
#define MAX_SEGS (MAXC + 2)    // the header sector, every column, visibility
#define BAR_BYTES 128          // the stages' mbarriers, before the stages

// Mirrored field for field by ctypes in ops/groupby_cuda.py (_Spec).
struct GroupSpec {
    int tuples;            // tuples per page (T)
    unsigned t_magic;      // ceil(2^32 / T): slot / T = umulhi(slot, magic)
    int vis_soff;          // staged word of the visibility region, -1 = none
    int key_soff;          // staged word of the key region
    int key_col;           // the key's column (for the record)
    int key_kind;          // K_I32 | K_U32
    int key_abs;           // abs() before the mod (int32 keys)
    unsigned key_mod;      // 0 = the value itself
    int key_pow2;          // key_mod is a power of two: mod is a mask
    Terms terms;
    int term_soff[MAXT];   // staged word of each term's column
    int term_ckind[MAXT];  // kind of each term's column
    int n_groups;          // G
    int n_agg;             // V
    int agg_kind;          // kind of every aggregated column
    int agg_col[MAXC];     // the aggregated columns (for the record)
    int agg_soff[MAXC];    // staged word of each aggregated column
    int threads;           // threads a CTA: 256 or 512
    int copies;            // R: 32 (a copy per lane) or 1 (per CTA)
    int stages;            // pages in flight per CTA
    int window;            // pages folded together (<= stages)
    int stage_bytes;       // one stage (a multiple of 16)
    int n_seg;
    int seg_src[MAX_SEGS];   // byte offset in the page (multiple of 16)
    int seg_bytes[MAX_SEGS]; // a multiple of 16
    int seg_dst[MAX_SEGS];   // byte offset in the stage (multiple of 16)
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
    if (s.key_kind == K_U32) {
        id = !s.key_mod ? bits
            : (s.key_pow2 ? (bits & (s.key_mod - 1u)) : bits % s.key_mod);
    } else {
        int x = static_cast<int>(bits);
        if (s.key_abs && x < 0)
            x = static_cast<int>(0u - bits);   // abs(INT_MIN) wraps
        if (s.key_mod) {
            if (s.key_pow2) {
                // floor modulo by 2^k is the low bits, negatives too
                x &= static_cast<int>(s.key_mod - 1u);
            } else {
                const int m = static_cast<int>(s.key_mod);
                const int r = x % m;
                x = r < 0 ? r + m : r;
            }
        }
        id = x;
    }
    return (id >= 0 && id < s.n_groups) ? static_cast<int>(id) : -1;
}

#define ROUNDS 8       // slots of a thread in one pass over a window

// What word w of the shared accumulators holds.
enum { W_ADD = 0, W_FADD, W_MIN, W_MAX };

__device__ __forceinline__ int word_op(int w, int G, int VG, bool is_f) {
    if (w < G) return W_ADD;                         // count
    if (w < G + VG) return is_f ? W_FADD : W_ADD;    // sums
    if (w < G + 2 * VG) return W_FADD;               // sums of squares
    if (w < G + 3 * VG) return W_MIN;
    return W_MAX;
}

// Clears bit i of `sel` where the term (compare kind KIND, op OP, both
// constants, so term_holds folds to one compare) fails on slot i, whose
// column word is col[pos[i]].
template <int KIND, int OP>
__device__ __forceinline__ void apply_term(unsigned& sel, const int32_t* col,
                                           const int (&pos)[ROUNDS],
                                           int col_kind, unsigned val) {
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
        if (sel >> i & 1u) {
            const bool ok = term_holds(static_cast<unsigned>(col[pos[i]]),
                                       col_kind, KIND, OP, val);
            sel &= ~(static_cast<unsigned>(!ok) << i);
        }
    }
}

#define TERM_CASE(K, O) \
    case K * 6 + O: apply_term<K, O>(sel, col, pos, ck, val); break;
#define TERM_CASES(K) \
    TERM_CASE(K, OP_GT) TERM_CASE(K, OP_GE) TERM_CASE(K, OP_LT) \
    TERM_CASE(K, OP_LE) TERM_CASE(K, OP_EQ) TERM_CASE(K, OP_NE)

// One aggregated value of a selected tuple.
struct Val {
    unsigned bits;   // the column's bits (the integer sum's term)
    float x;         // the float sum's term: 0 for +-inf
    float xx;        // the sum of squares' term
    int img;         // order image for min/max
    bool mm;         // takes part in min/max (not NaN)
};

// The value's terms; a non-finite float is counted straight into the
// output's NaN/+inf/-inf words (rare) at index i.
template <bool IS_F>
__device__ __forceinline__ Val value_of(unsigned bits, int kind,
                                        unsigned* out_nonf, int VG, int i) {
    Val v;
    v.bits = bits;
    v.img = order_image(bits, kind);
    v.mm = true;
    if (IS_F) {
        float x = __uint_as_float(bits);
        if (!isfinite(x)) {
            const int q = isnan(x) ? 0 : (x > 0.f ? 1 : 2);
            atomicAdd(out_nonf + q * VG + i, 1u);
            v.mm = q != 0;
            x = 0.f;
        }
        v.x = x;
    } else {
        v.x = as_f32(bits, kind);
    }
    v.xx = v.x * v.x;
    return v;
}

template <int TPB, bool IS_F>
__global__ void __launch_bounds__(TPB)
groupby_pages_kernel(const int32_t* __restrict__ words, long long n_pages,
                     const GroupSpec s, int min_init, int max_init,
                     unsigned* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    unsigned char* stage = smem + BAR_BYTES;
    const int32_t* stage_w = reinterpret_cast<const int32_t*>(stage);
    unsigned* acc = reinterpret_cast<unsigned*>(
        stage + static_cast<size_t>(s.stages) * s.stage_bytes);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int G = s.n_groups;
    const int V = s.n_agg;
    const int VG = V * G;
    const int n_words = G + 4 * VG;    // NaN/inf counts go straight to out
    unsigned* out_nonf = out + n_words;
    const int R = s.copies;
    const int S = s.stages;
    const int T = s.tuples;
    const int stage_words = s.stage_bytes >> 2;
    // this CTA's pages: blockIdx.x + j * gridDim.x, j < mine (grid <= pages)
    const long long mine = (n_pages - 1 - blockIdx.x) / gridDim.x + 1;

    auto load = [&](long long j) {
        const int st = static_cast<int>(j % S);
        const unsigned char* page = reinterpret_cast<const unsigned char*>(
            words + (blockIdx.x + j * gridDim.x) * PAGE_WORDS);
        unsigned char* dst = stage + static_cast<size_t>(st) * s.stage_bytes;
        int total = 0;
        for (int q = 0; q < s.n_seg; ++q) total += s.seg_bytes[q];
        mbar_expect_tx(&full[st], total);
        for (int q = 0; q < s.n_seg; ++q)
            bulk_load(dst + s.seg_dst[q], page + s.seg_src[q],
                      s.seg_bytes[q], &full[st]);
    };
    if (tid == 0) {
        for (int st = 0; st < S; ++st) mbar_init(&full[st], 1);
        mbar_init_fence();
        for (long long j = 0; j < mine && j < S; ++j) load(j);
    }
    // shared accumulators: word w of copy r at w * R + r (R a power of two)
    const int lg_r = 31 - __clz(R);
    for (int i = tid; i < n_words * R; i += TPB) {
        const int op = word_op(i >> lg_r, G, VG, IS_F);
        acc[i] = op == W_MIN ? static_cast<unsigned>(min_init)
               : op == W_MAX ? static_cast<unsigned>(max_init) : 0u;
    }
    __syncthreads();

    unsigned* mine_acc = acc + (tid & (R - 1));
    for (long long j0 = 0; j0 < mine; j0 += s.window) {
        const int k_n = static_cast<int>(
            mine - j0 < s.window ? mine - j0 : s.window);
        const int slot0 = static_cast<int>(j0 % S);
        for (int k = 0; k < k_n; ++k)
            mbar_wait(&full[(j0 + k) % S],
                      static_cast<uint32_t>(((j0 + k) / S) & 1));
        // the window's pages as one range of (page, tuple) slots, ROUNDS
        // slots a thread at a time: first a bit mask of the live, visible
        // tuples that pass every term, then the updates
        const int n_slots = k_n * T;
        for (int base = 0; base < n_slots; base += ROUNDS * TPB) {
            int pos[ROUNDS];             // slot i's word in the stages
            unsigned sel = 0;
#pragma unroll
            for (int i = 0; i < ROUNDS; ++i) {
                const int idx = base + tid + i * TPB;
                pos[i] = 0;
                if (idx < n_slots) {
                    const int k = static_cast<int>(__umulhi(idx, s.t_magic));
                    const int t = idx - k * T;
                    const int st = slot0 + k < S ? slot0 + k : slot0 + k - S;
                    const int32_t* w = stage_w + st * stage_words;
                    pos[i] = st * stage_words + t;
                    const int nt = w[2];
                    sel |= static_cast<unsigned>(
                        t < nt && (s.vis_soff < 0 || w[s.vis_soff + t] != 0))
                        << i;
                }
            }
            for (int q = 0; q < s.terms.n; ++q) {
                const int32_t* col = stage_w + s.term_soff[q];
                const int ck = s.term_ckind[q];
                const unsigned val = s.terms.val[q];
                switch (s.terms.kind[q] * 6 + s.terms.op[q]) {
                    TERM_CASES(K_I32) TERM_CASES(K_U32) TERM_CASES(K_F32)
                }
            }
#pragma unroll
            for (int i = 0; i < ROUNDS; ++i) {
                if (!(sel >> i & 1u)) continue;
                const int g = group_of(
                    static_cast<unsigned>(stage_w[pos[i] + s.key_soff]), s);
                if (g < 0) continue;
                unsigned* p_cnt = mine_acc + (g << lg_r);
                atomicAdd(p_cnt, 1u);
                for (int a = 0; a < V; ++a) {
                    const int ia = a * G + g;
                    const Val v = value_of<IS_F>(static_cast<unsigned>(
                        stage_w[pos[i] + s.agg_soff[a]]), s.agg_kind,
                        out_nonf, VG, ia);
                    unsigned* p_sum = mine_acc + ((G + ia) << lg_r);
                    unsigned* p_sq = mine_acc + ((G + VG + ia) << lg_r);
                    unsigned* p_min = mine_acc + ((G + 2 * VG + ia) << lg_r);
                    unsigned* p_max = mine_acc + ((G + 3 * VG + ia) << lg_r);
                    if (IS_F) {
                        if (v.x != 0.f)
                            atomicAdd(reinterpret_cast<float*>(p_sum), v.x);
                    } else {
                        atomicAdd(p_sum, v.bits);
                    }
                    if (v.xx != 0.f)
                        atomicAdd(reinterpret_cast<float*>(p_sq), v.xx);
                    if (v.mm) {
                        atomicMin(reinterpret_cast<int*>(p_min), v.img);
                        atomicMax(reinterpret_cast<int*>(p_max), v.img);
                    }
                }
            }
        }
        // every thread is done with the window's stages: refill them
        __syncthreads();
        if (tid == 0)
            for (int k = 0; k < k_n; ++k)
                if (j0 + k + S < mine) load(j0 + k + S);
    }

    // fold the R copies of each word, then one atomic per word that moved
    for (int w = tid; w < n_words; w += TPB) {
        const int op = word_op(w, G, VG, IS_F);
        const unsigned* src = acc + (w << lg_r);
        unsigned v = src[lane & (R - 1)];
        for (int r = 1; r < R; ++r) {
            const unsigned x = src[(r + lane) & (R - 1)];
            switch (op) {
            case W_ADD: v += x; break;
            case W_FADD:
                v = __float_as_uint(__uint_as_float(v) + __uint_as_float(x));
                break;
            case W_MIN: v = min(static_cast<int>(v), static_cast<int>(x));
                break;
            default: v = max(static_cast<int>(v), static_cast<int>(x));
            }
        }
        switch (op) {
        case W_ADD: if (v) atomicAdd(out + w, v); break;
        case W_FADD:
            if (__uint_as_float(v) != 0.f)
                atomicAdd(reinterpret_cast<float*>(out) + w,
                          __uint_as_float(v));
            break;
        case W_MIN:
            if (static_cast<int>(v) != min_init)
                atomicMin(reinterpret_cast<int*>(out) + w,
                          static_cast<int>(v));
            break;
        default:
            if (static_cast<int>(v) != max_init)
                atomicMax(reinterpret_cast<int*>(out) + w,
                          static_cast<int>(v));
        }
    }
}

typedef void (*KernelFn)(const int32_t*, long long, const GroupSpec, int,
                         int, unsigned*);

// The variant for `threads` a CTA (256 or 512) and float columns or not;
// nullptr for another thread count.
static KernelFn variant(int threads, bool is_f) {
    switch (threads) {
    case 256: return is_f ? groupby_pages_kernel<256, true>
                          : groupby_pages_kernel<256, false>;
    case 512: return is_f ? groupby_pages_kernel<512, true>
                          : groupby_pages_kernel<512, false>;
    default: return nullptr;
    }
}

// Opts the variant into `smem` bytes of dynamic shared memory (above the
// default 48 KiB a kernel needs this first).
static cudaError_t allow_smem(KernelFn fn, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" {

// Launch on `stream` with `grid` CTAs (<= n_pages) of the spec's threads
// and `smem` bytes of dynamic shared memory (the plan's); returns the
// cudaError_t of the launch (0 = queued).
int strom_groupby_pages(const void* words, long long n_pages,
                        const void* spec, int min_init, int max_init,
                        void* out, int grid, int smem, void* stream) {
    if (n_pages <= 0) return 0;
    const GroupSpec s = *static_cast<const GroupSpec*>(spec);
    const KernelFn fn = variant(s.threads, s.agg_kind == K_F32);
    if (!fn || s.n_groups < 1 || s.n_groups > MAX_GROUPS || s.n_agg < 1
            || s.n_agg > MAXC || s.stages < 1 || s.window < 1
            || s.window > s.stages || s.n_seg < 1 || s.n_seg > MAX_SEGS
            || (s.copies != 32 && s.copies != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = allow_smem(fn, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fn<<<grid, s.threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), n_pages, s, min_init, max_init,
        static_cast<unsigned*>(out));
    return static_cast<int>(cudaGetLastError());
}

// CTAs of the variant (threads a CTA, float or not) with `smem` bytes of
// dynamic shared memory that fit on one SM of the current device at once,
// in *blocks.
int strom_groupby_occupancy(int threads, int is_float, int smem,
                            int* blocks) {
    const KernelFn fn = variant(threads, is_float != 0);
    if (!fn) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = allow_smem(fn, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fn, threads, smem));
}

}  // extern "C"
