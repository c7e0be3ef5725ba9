// Hopper bulk-copy helpers of the redesigned kernels (filter.cu,
// permute.cu, groupby.cu, decode.cu): the Tensor Memory Accelerator's 1D
// bulk copies between global and shared memory, and the shared-memory
// mbarriers that report a load's completion.
//
// A bulk copy takes 16-byte-aligned addresses and a size that is a
// multiple of 16 bytes.  A load (global -> shared) completes on an
// mbarrier: the issuing thread first arms it with the bytes to expect
// (arrive.expect_tx), and a waiter spins on the barrier's phase parity.
// A store (shared -> global) joins the thread's bulk group: commit_group
// closes the group, wait_group.read N waits until at most N groups still
// read shared memory (their stages may be refilled), wait_group N until at
// most N groups have writes outstanding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (the TMA).
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Spins until the barrier's current phase is not `parity` (the phase
// that was armed has completed).  A copy that has not completed within
// MBAR_TIMEOUT_NS cannot be a slow one: the thread traps, so the launch
// fails with an error instead of holding its stream forever.
#define MBAR_TIMEOUT_NS 2000000000ull
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    unsigned long long t0 = 0;
    for (;;) {
        uint32_t done;
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(a), "r"(parity) : "memory");
        if (done) return;
        if (!t0)
            t0 = globaltimer_ns();
        else if (globaltimer_ns() - t0 > MBAR_TIMEOUT_NS)
            __trap();
    }
}

// global -> shared, `bytes` (a multiple of 16) completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst_smem)), "l"(src), "r"(bytes),
           "r"(smem_addr(bar)) : "memory");
}

// shared -> global, `bytes` (a multiple of 16), in the thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src_smem,
                                           uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst), "r"(smem_addr(src_smem)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// At most N committed groups still reading their shared-memory sources.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// Every committed group's writes performed.
__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Orders this thread's async-proxy (bulk copy) accesses to global memory
// before its later generic-proxy operations, such as a release signal.
__device__ __forceinline__ void fence_proxy_async_global() {
    asm volatile("fence.proxy.async.global;" ::: "memory");
}
