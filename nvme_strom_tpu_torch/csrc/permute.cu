// Ring permute (B4) for Hopper (sm_90a): one +1 rotation of a ring's
// per-member blocks, out[(i + 1) % N] = block[i], byte for byte.
//
// Replaces the Pallas TPU kernel nvme_strom_tpu/parallel/ring.py
// (_pallas_permute_step): there each device started an async remote DMA of
// its block to its logical neighbour, fenced by a paired send/recv DMA
// semaphore.  Here a member's block is copied by a kernel on the sender's
// device through a raw (unified-address) pointer into the receiver's
// buffer, and the semaphore becomes a device-side counter:
//
//   ring_send_kernel  grid-stride copy (16-byte vector loads and stores
//                     when both pointers are 16-byte aligned, then a byte
//                     tail), then each block fences its stores and adds 1
//                     to the receiver's counter with a release reduction.
//                     On one card the receiver's buffer is HBM of the same
//                     card (device scope); on two cards with peer access it
//                     is the peer's HBM over NVLink, and the fence and the
//                     counter are system scope.
//   ring_wait_kernel  one thread on the receiver's stream spins with
//                     acquire loads until the counter reaches the
//                     cumulative count of signals sent to it (epochs, never
//                     resets: a reset races with a late signal), bounded by
//                     a budget on %globaltimer; past it, it sets an error
//                     word and returns, and the wrapper raises ETIMEDOUT.
//
// The wrapper (ops/permute_cuda.py) launches every member's send before
// any member's wait: on one card all members launch onto one stream, and a
// wait queued ahead of its upstream member's send would spin forever.
//
// Bound: memory.  A rotation reads each block once and writes it once, so
// its least time is 2 x bytes over device-memory bandwidth (one card) or
// bytes over the link rate (two cards).  The design serves that with
// coalesced 16-byte accesses and four independent loads in flight per
// thread; TMA bulk copies are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strom_common.cuh"

#define THREADS 256

__device__ __forceinline__ void red_release_sys_add(unsigned long long* p,
                                                    unsigned long long v) {
    asm volatile("red.release.sys.global.add.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void red_release_gpu_add(unsigned long long* p,
                                                    unsigned long long v) {
    asm volatile("red.release.gpu.global.add.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void __launch_bounds__(THREADS)
ring_send_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 long long nbytes, int vec, int peer,
                 unsigned long long* __restrict__ recv_count) {
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long stride = (long long)gridDim.x * THREADS;
    long long head = 0;
    if (vec) {
        const long long n16 = nbytes >> 4;
        const uint4* s = reinterpret_cast<const uint4*>(src);
        uint4* d = reinterpret_cast<uint4*>(dst);
        long long i = tid;
        for (; i + 3 * stride < n16; i += 4 * stride) {
            const uint4 a = s[i];
            const uint4 b = s[i + stride];
            const uint4 c = s[i + 2 * stride];
            const uint4 e = s[i + 3 * stride];
            d[i] = a;
            d[i + stride] = b;
            d[i + 2 * stride] = c;
            d[i + 3 * stride] = e;
        }
        for (; i < n16; i += stride) d[i] = s[i];
        head = n16 << 4;
    }
    for (long long i = head + tid; i < nbytes; i += stride) dst[i] = src[i];
    // the block's stores happen before thread 0's fence and release bump
    // of the receiver's counter (the barrier orders the other threads'
    // stores before it: the pattern of CUDA's own grid sync).  System
    // scope only when the receiver is another card: on one card the
    // device scope orders everything the receiver reads, and a system
    // fence would cost every launch microseconds
    __syncthreads();
    if (threadIdx.x == 0) {
        if (peer) {
            __threadfence_system();
            red_release_sys_add(recv_count, 1ull);
        } else {
            __threadfence();
            red_release_gpu_add(recv_count, 1ull);
        }
    }
}

__global__ void ring_wait_kernel(const unsigned long long* recv_count,
                                 unsigned long long target,
                                 unsigned long long budget_ns,
                                 volatile long long* err) {
    const unsigned long long t0 = globaltimer_ns();
    while (ld_acquire_sys(recv_count) < target) {
        if (globaltimer_ns() - t0 > budget_ns) {
            *err = 1;
            __threadfence_system();
            return;
        }
        __nanosleep(256);
    }
}

// Runs a launch on `device` and puts the caller's current device back.
struct DeviceGuard {
    int prev = -1;
    cudaError_t err;
    explicit DeviceGuard(int device) {
        err = cudaGetDevice(&prev);
        if (err == cudaSuccess) err = cudaSetDevice(device);
    }
    ~DeviceGuard() {
        if (prev >= 0) cudaSetDevice(prev);
    }
};

extern "C" {

// Copy nbytes from src to dst on `stream` of `device`, then add `grid` to
// *recv_count (one per block); `peer` when dst and the counter are on
// another card.  Returns the launch's cudaError_t.
int strom_ring_send(int device, const void* src, void* dst, long long nbytes,
                    int vec, int peer, void* recv_count, int grid,
                    void* stream) {
    DeviceGuard g(device);
    if (g.err != cudaSuccess) return static_cast<int>(g.err);
    ring_send_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes,
        vec, peer, static_cast<unsigned long long*>(recv_count));
    return static_cast<int>(cudaGetLastError());
}

// Hold `stream` of `device` until *recv_count >= target, or set *err after
// budget_ns.  Returns the launch's cudaError_t.
int strom_ring_wait(int device, const void* recv_count,
                    unsigned long long target, unsigned long long budget_ns,
                    void* err, void* stream) {
    DeviceGuard g(device);
    if (g.err != cudaSuccess) return static_cast<int>(g.err);
    ring_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(recv_count), target, budget_ns,
        static_cast<volatile long long*>(err));
    return static_cast<int>(cudaGetLastError());
}

// 1 when kernels on `device` can write `peer`'s memory, else 0.
int strom_can_access_peer(int device, int peer) {
    int can = 0;
    if (cudaDeviceCanAccessPeer(&can, device, peer) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    return can;
}

// Let kernels on `device` write `peer`'s memory (already enabled is fine).
int strom_enable_peer(int device, int peer) {
    DeviceGuard g(device);
    if (g.err != cudaSuccess) return static_cast<int>(g.err);
    cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();      // not an error here; clear it
        e = cudaSuccess;
    }
    return static_cast<int>(e);
}

}  // extern "C"
