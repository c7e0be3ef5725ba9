// Ring permute (B4) for Hopper (sm_90a): one +1 rotation of a ring's
// per-member blocks, out[(i + 1) % N] = block[i], byte for byte.
//
// Replaces the Pallas TPU kernel nvme_strom_tpu/parallel/ring.py
// (_pallas_permute_step): there each device started an async remote DMA of
// its block to its logical neighbour, fenced by a paired send/recv DMA
// semaphore.  Here a member's block is copied by a kernel on the sender's
// device through a raw (unified-address) pointer into the receiver's
// buffer, and the semaphore becomes a device-side counter that each CTA
// of the send adds one to, once its bytes are written.
//
// Bound: memory.  A rotation reads each block once and writes it once, so
// its least time is 2 x bytes over device-memory bandwidth (one card) or
// bytes over the link rate (two cards).  The first design (a grid-stride
// copy of up to 8 blocks of 256 threads an SM, each with a fence and a
// release on the same counter) trailed cudaMemcpy at every size.  The
// wrapper (ops/permute_cuda.py, plan_send) now picks one of two kernels,
// each on a persistent grid of at most two CTAs an SM, one signal a CTA
// and no separate fence:
//
//   ring_send_bulk_kernel  one card, source and destination equally
//       aligned mod 16, blocks of at least BULK_MIN_BYTES (the 256 MiB
//       blocks of the redistribution and the gather).  One thread of each
//       CTA moves the CTA's pieces (16 KiB pieces of the 16-byte-aligned
//       body, CTA c taking pieces c, c + grid, ..., so the CTAs sweep the
//       block together) through a ring of STAGES shared-memory stages with
//       the Tensor Memory Accelerator: a bulk load per piece completing on
//       the stage's mbarrier, a bulk store from the stage, and a bulk-group
//       read wait before the stage is refilled, so up to STAGES loads and
//       the stores are in flight and no byte passes through registers.
//       The unaligned head and the tail (under 16 bytes each) go through
//       CTA 0's threads as plain loads and stores.  Then the CTA's signal:
//       the bulk writes complete (wait_group 0), a proxy fence orders them
//       (async proxy) before the release reduction (generic proxy), and
//       the barrier orders the threads' plain stores before it (a release
//       is cumulative).
//   ring_send_simt_kernel  every other send: a grid-stride copy with
//       streaming 16-byte vectors where both pointers allow, then bytes,
//       and one signal per block.  Below BULK_MIN_BYTES it is the faster
//       kernel: the bulk kernel's chain of load, store, write completion
//       and signal per CTA costs more than it saves there (PERF.md).
//       Across cards (NVLink) the receiver's memory is another card's; the
//       bulk stores have not been checked bit-exact there, so that leg
//       keeps this kernel, and its signal is system scope after a system
//       fence.  The choice is a branch on the plan, made before launch.
//   ring_wait_kernel  one thread on the receiver's stream spins with
//       acquire loads until the counter reaches the cumulative count of
//       signals sent to it (epochs, never resets: a reset races with a
//       late signal), bounded by a budget on %globaltimer; past it, it sets
//       an error word and returns, and the wrapper raises ETIMEDOUT.
//
// The wrapper launches every member's send before any member's wait: on
// one card all members launch onto one stream, and a wait queued ahead of
// its upstream member's send would spin forever.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strom_common.cuh"
#include "tma.cuh"

#define SIMT_THREADS 256
#define BULK_THREADS 32
#define STAGES 4
#define STAGE_BYTES (16 * 1024)
#define MAX_DEVICES 64

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

// Bytes [head, head + body) of the block in pieces of STAGE_BYTES (the
// last may be shorter; src + head and dst + head 16-byte aligned), CTA c
// taking pieces c, c + grid, ...; CTA 0's threads copy [0, head) and the
// `tail` bytes after the body.
__global__ void __launch_bounds__(BULK_THREADS, 1)
ring_send_bulk_kernel(const uint8_t* __restrict__ src,
                      uint8_t* __restrict__ dst, long long head,
                      long long body, long long tail,
                      unsigned long long* __restrict__ recv_count) {
    extern __shared__ __align__(128) uint8_t stage[];
    __shared__ __align__(8) uint64_t full[STAGES];
    if (threadIdx.x == 0) {
        const long long stop = head + body;
        const long long pieces = (body + STAGE_BYTES - 1) / STAGE_BYTES;
        const long long n = pieces > blockIdx.x
            ? (pieces - 1 - blockIdx.x) / gridDim.x + 1 : 0;
        auto offset = [&](long long k) {
            return head + (blockIdx.x + k * gridDim.x) * STAGE_BYTES;
        };
        auto size = [&](long long off) {
            return static_cast<uint32_t>(
                stop - off < STAGE_BYTES ? stop - off : STAGE_BYTES);
        };
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        mbar_init_fence();
        auto issue = [&](long long k) {
            const long long off = offset(k);
            const int s = static_cast<int>(k % STAGES);
            mbar_expect_tx(&full[s], size(off));
            bulk_load(stage + s * STAGE_BYTES, src + off, size(off),
                      &full[s]);
        };
        for (long long k = 0; k < n && k < STAGES; ++k) issue(k);
        for (long long k = 0; k < n; ++k) {
            const int s = static_cast<int>(k % STAGES);
            mbar_wait(&full[s], static_cast<uint32_t>((k / STAGES) & 1));
            const long long off = offset(k);
            bulk_store(dst + off, stage + s * STAGE_BYTES, size(off));
            bulk_commit();
            // piece k - 1 + STAGES refills the stage store k - 1 read,
            // once that store has read it (store k may still be reading)
            if (k >= 1 && k - 1 + STAGES < n) {
                bulk_wait_read<1>();
                issue(k - 1 + STAGES);
            }
        }
        bulk_wait_all();
        fence_proxy_async_global();
    }
    if (blockIdx.x == 0) {
        if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
        if (threadIdx.x < tail)
            dst[head + body + threadIdx.x] = src[head + body + threadIdx.x];
    }
    // the CTA's writes (its bulk stores, ordered by thread 0's proxy
    // fence, and CTA 0's plain stores) before the release
    __syncthreads();
    if (threadIdx.x == 0) red_release_gpu_add(recv_count, 1ull);
}

// Streaming 16-byte vectors over [0, body) (both pointers 16-byte aligned,
// else body is 0), then bytes over [body, body + tail); one signal per
// block, at system scope when the receiver is another card (`peer`).
__global__ void __launch_bounds__(SIMT_THREADS)
ring_send_simt_kernel(const uint8_t* __restrict__ src,
                      uint8_t* __restrict__ dst, long long body,
                      long long tail, int peer,
                      unsigned long long* __restrict__ recv_count) {
    const long long tid = (long long)blockIdx.x * SIMT_THREADS + threadIdx.x;
    const long long stride = (long long)gridDim.x * SIMT_THREADS;
    const long long n16 = body >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    long long i = tid;
    for (; i + 3 * stride < n16; i += 4 * stride) {
        const uint4 a = __ldcs(s + i);
        const uint4 b = __ldcs(s + i + stride);
        const uint4 c = __ldcs(s + i + 2 * stride);
        const uint4 e = __ldcs(s + i + 3 * stride);
        __stcs(d + i, a);
        __stcs(d + i + stride, b);
        __stcs(d + i + 2 * stride, c);
        __stcs(d + i + 3 * stride, e);
    }
    for (; i < n16; i += stride) __stcs(d + i, __ldcs(s + i));
    for (long long j = body + tid; j < body + tail; j += stride)
        dst[j] = src[j];
    // the barrier orders the block's stores before thread 0's release
    // (cumulative).  Across cards the system fence stays, as it was when
    // the cross-card leg was checked bit-exact on four cards (this
    // streaming copy loop has not run there since); on one card device
    // scope orders everything the receiver reads
    __syncthreads();
    if (threadIdx.x == 0) {
        if (peer) {
            __threadfence_system();
            red_release_sys_add(recv_count, 1ull);
        } else {
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

// Copy head + body + tail bytes from src to dst on `stream` of `device`
// as ops/permute_cuda.py planned it (plan_send), then add `grid` to
// *recv_count (one per CTA): the bulk kernel when `bulk`, else the SIMT
// kernel (head is 0 there; `peer` when dst and the counter are on another
// card).  Returns the launch's cudaError_t.
int strom_ring_send(int device, const void* src, void* dst, int bulk,
                    long long head, long long body, long long tail, int peer,
                    void* recv_count, int grid, void* stream) {
    DeviceGuard g(device);
    if (g.err != cudaSuccess) return static_cast<int>(g.err);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* s = static_cast<const uint8_t*>(src);
    uint8_t* d = static_cast<uint8_t*>(dst);
    unsigned long long* cnt = static_cast<unsigned long long*>(recv_count);
    if (!bulk) {
        ring_send_simt_kernel<<<grid, SIMT_THREADS, 0, st>>>(
            s, d, body, tail, peer, cnt);
        return static_cast<int>(cudaGetLastError());
    }
    const int smem = STAGES * STAGE_BYTES;
    static bool sized[MAX_DEVICES];
    if (device < 0 || device >= MAX_DEVICES)
        return static_cast<int>(cudaErrorInvalidDevice);
    if (!sized[device]) {
        const cudaError_t e = cudaFuncSetAttribute(
            ring_send_bulk_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        sized[device] = true;
    }
    ring_send_bulk_kernel<<<grid, BULK_THREADS, smem, st>>>(
        s, d, head, body, tail, cnt);
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
