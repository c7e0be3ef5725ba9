// Shared device helpers of the scan kernels (filter.cu, groupby.cu,
// decode.cu): column kinds, predicate terms, warp sums, the launch error
// message and the card's shared-memory limit.
//
// A predicate term compares one column value with a 32-bit constant in the
// term's compare kind, the type jnp promotion gives the pair (see
// ops/filter.py term_value): K_F32 converts the column to float32 (int32
// and uint32 round to nearest), K_U32 compares unsigned bits, K_I32 signed
// bits (a uint32 column read as int32 where a signed numpy scalar made the
// compare signed).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXC 16
#define MAXT 8
#define PAGE_WORDS 2048

enum { K_I32 = 0, K_U32 = 1, K_F32 = 2 };
enum { OP_GT = 0, OP_GE, OP_LT, OP_LE, OP_EQ, OP_NE };

// Mirrored field for field by ctypes in ops/filter_cuda.py (_Terms).
struct Terms {
    int n;
    int col[MAXT];
    int op[MAXT];
    int kind[MAXT];        // compare kind: K_I32 | K_U32 | K_F32
    unsigned val[MAXT];    // comparison value as 32 bits of that kind
};

template <typename T>
__device__ __forceinline__ bool compare(T a, T b, int op) {
    switch (op) {
    case OP_GT: return a > b;
    case OP_GE: return a >= b;
    case OP_LT: return a < b;
    case OP_LE: return a <= b;
    case OP_EQ: return a == b;
    default:    return a != b;
    }
}

// A column's 32 bits as float32: a float column's bits, or an integer
// column converted (round to nearest even, as XLA converts).
__device__ __forceinline__ float as_f32(unsigned bits, int col_kind) {
    if (col_kind == K_F32) return __uint_as_float(bits);
    if (col_kind == K_U32) return __uint2float_rn(bits);
    return __int2float_rn(static_cast<int>(bits));
}

__device__ __forceinline__ bool term_holds(unsigned bits, int col_kind,
                                           int kind, int op, unsigned val) {
    if (kind == K_F32)
        return compare(as_f32(bits, col_kind), __uint_as_float(val), op);
    if (kind == K_U32)
        return compare(bits, val, op);
    return compare(static_cast<int>(bits), static_cast<int>(val), op);
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// CUDA's message for a launcher's return code (read by _build.launcher).
// Each source builds into a library of its own, so each holds one copy.
extern "C" const char* strom_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most shared memory one block of `device` may opt into, in *bytes
// (read by _build.smem_optin); returns the cudaError_t.
extern "C" int strom_smem_optin(int device, int* bytes) {
    return static_cast<int>(cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}
