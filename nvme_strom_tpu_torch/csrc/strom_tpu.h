/* strom_tpu.h — C ABI of the native async I/O engine.
 *
 * Capability analog of the reference's kernel UAPI (kmod/nvme_strom.h):
 * where the reference exposes ioctls on /proc/nvme-strom, this engine is
 * linked in-process and driven over a flat C ABI (ctypes-friendly: only
 * fixed-width ints and raw pointers).
 *
 * Ownership model (mirrors the reference's driver state):
 *  - an ENGINE is the "loaded module": backend threads, stats registry,
 *    512-slot task table (kmod/nvme_strom.c:639-644 analog);
 *  - a TASK is one submitted memcpy command: per-request refcount, first
 *    error latched, FAILED tasks retained until reaped by a wait or by
 *    nstpu_engine_reap (the ioctl-fd-close analog; design memo
 *    kmod/nvme_strom.c:612-626).
 *
 * The chunk planner (merging, cache arbitration, stripe resolution) runs in
 * the Python layer; this engine executes planned request batches with
 * io_uring (primary) or a pread thread pool (fallback), entirely outside
 * the GIL.
 */
#ifndef STROM_TPU_H
#define STROM_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define NSTPU_API_VERSION 4

/* backends — a failover ladder, top to bottom: raw NVMe passthrough
 * (IORING_OP_URING_CMD on the char device, the userspace analog of the
 * reference's raw command build, kmod/nvme_strom.c:1518-1589), io_uring
 * on block fds, pread thread pool. */
#define NSTPU_BACKEND_AUTO          0
#define NSTPU_BACKEND_IO_URING      1
#define NSTPU_BACKEND_THREADPOOL    2
#define NSTPU_BACKEND_NVME_PASSTHRU 3

/* counter indices for nstpu_engine_stats(); order is ABI.
 * Mirrors the reference's count+clock pairs (kmod/nvme_strom.c:83-106). */
enum {
  NSTPU_CTR_NR_SUBMIT_DMA = 0,
  NSTPU_CTR_CLK_SUBMIT_DMA,     /* ns spent in submission syscalls */
  NSTPU_CTR_NR_SSD2DEV,         /* completed tasks */
  NSTPU_CTR_CLK_SSD2DEV,        /* ns submit->last-completion per task */
  NSTPU_CTR_NR_WAIT_DTASK,
  NSTPU_CTR_CLK_WAIT_DTASK,
  NSTPU_CTR_NR_WRONG_WAKEUP,
  NSTPU_CTR_TOTAL_DMA_LENGTH,
  NSTPU_CTR_CUR_DMA_COUNT,
  NSTPU_CTR_MAX_DMA_COUNT,      /* read-and-reset by stats snapshot */
  NSTPU_CTR_NR_RESUBMIT,        /* short-read/-write continuations */
  NSTPU_CTR_NR_SQ_FULL,         /* submission stalls on full SQ */
  NSTPU_CTR_NR_WRITE_DMA,       /* write requests submitted (RAM2SSD leg) */
  NSTPU_CTR_TOTAL_WRITE_LENGTH, /* bytes submitted as writes */
  NSTPU_CTR_NR_FIXED_DMA,       /* requests that rode a registered buffer */
  NSTPU_CTR_NR_ENTER_DMA,       /* io_uring_enter submit syscalls (batched:
                                 * one covers a whole task's SQE batch, so
                                 * nr_enter_dma / nr_submit_dma ~ 1/N) */
  NSTPU_CTR_OCC_INTEGRAL_NS,    /* sum(in_flight * dt) over in-flight
                                 * transitions: mean queue occupancy over
                                 * an interval is d(integral)/d(busy) */
  NSTPU_CTR_OCC_BUSY_NS,        /* elapsed ns with in_flight > 0 */
  NSTPU_CTR_NR_PASSTHRU_DMA,    /* requests submitted as raw NVMe READ
                                 * commands over IORING_OP_URING_CMD */
  NSTPU_CTR__COUNT
};

/* log2-ns service-latency histogram depth for nstpu_engine_lat_hist():
 * bucket b counts completed requests whose submit->completion time fell
 * in [2^b, 2^(b+1)) ns. */
#define NSTPU_LAT_BUCKETS 64

/* request flags */
#define NSTPU_REQ_WRITE 0x1   /* buffer -> file instead of file -> buffer */
/* NSTPU_REQ_PASSTHRU: fd is IGNORED (the engine's probed char-device fd is
 * used), file_off is a DEVICE byte offset (blockmap-resolved: LBA <<
 * lba_shift) and both file_off and len must be LBA-multiple — the request
 * is submitted as a raw NVMe READ over IORING_OP_URING_CMD.  Only valid on
 * the NVME_PASSTHRU backend; misaligned or wrong-backend passthru requests
 * fail the whole submit with -EINVAL (a device offset must never be
 * reinterpreted as a file offset). */
#define NSTPU_REQ_PASSTHRU 0x2

/* nstpu_passthru_probe() refusal reasons (negative), mirrored by the
 * Python bindings into per-reason fallback counters.  >= 0 means usable
 * and is the namespace's LBA shift (lba_size = 1 << shift). */
#define NSTPU_PASSTHRU_EDISABLED -1  /* NSTPU_DISABLE_PASSTHRU env set */
#define NSTPU_PASSTHRU_ENODEV    -2  /* char device absent / unopenable /
                                      * not an NVMe namespace node */
#define NSTPU_PASSTHRU_ENOURING  -3  /* SQE128|CQE32 ring setup failed */
#define NSTPU_PASSTHRU_ENOCMD    -4  /* IORING_OP_URING_CMD unsupported */
#define NSTPU_PASSTHRU_ELBAFMT   -5  /* identify-namespace / LBA format
                                      * rejected (metadata or odd lbads) */

/* stripe-member attribution rides in flags bits 8..15 (index within the
 * striped source, clamped to NSTPU_MAX_MEMBERS-1); per-member counters
 * are the reference's per-disk iostat analog (part_stat_add incl. the md
 * aggregate, kmod/nvme_strom.c:1101-1123). */
#define NSTPU_REQ_MEMBER_SHIFT 8
#define NSTPU_MAX_MEMBERS 64

/* One planned I/O request: read [file_off, file_off+len) from fd into
 * dest_base + dest_off — or, with NSTPU_REQ_WRITE, write the same span
 * from dest_base + dest_off into fd (the RAM2SSD leg; the reference's
 * engine was read-only, kmod/nvme_strom.c:1136-1224, so the write
 * direction is a capability beyond it).  len <= the planner's dma_max
 * cap.  Callers MUST zero-initialize nstpu_req (v1's field here was a
 * pad whose value was ignored; now it is meaningful, and stack garbage
 * in it could silently turn a read into a write). */
typedef struct nstpu_req {
  int32_t  fd;
  int32_t  flags;
  uint64_t file_off;
  uint64_t len;
  uint64_t dest_off;
} nstpu_req;

/* Engine lifecycle.  Returns an opaque handle (0 on failure).
 * queue_depth: io_uring SQ entries / thread-pool width.
 *
 * nstpu_engine_create2 additionally fixes the lane (queue) count:
 * stripe members map member % nrings, each lane with its own
 * submit lock, reaper/workers, and queue_depth-deep in-flight window —
 * the per-NVMe-device hardware-queue analog (kmod/nvme_strom.c:1201-1223).
 * Both backends honor it: io_uring lanes are rings, threadpool lanes are
 * independent deque+worker sets.
 * nrings <= 0 means the built-in default (env NSTPU_RINGS, else 1).
 * Measured guidance: rings = number of DISTINCT physical devices; on a
 * single backing disk extra rings only inflate in-flight and seek (A/B:
 * 4x32-deep rings measured ~30% below 1x32 on a one-disk RAID-0). */
uint64_t nstpu_engine_create(int backend, int queue_depth);
uint64_t nstpu_engine_create2(int backend, int queue_depth, int nrings);
/* nstpu_engine_create3 (API v4) additionally names the NVMe character
 * device (/dev/ngXnY) for the passthrough ladder rung.  passthru_dev ==
 * NULL falls back to env NSTPU_PASSTHRU_DEV; with neither, AUTO skips
 * straight to io_uring (reason NSTPU_PASSTHRU_ENODEV retained).  An
 * explicit NSTPU_BACKEND_NVME_PASSTHRU request fails (returns 0) when the
 * probe refuses, like an explicit IO_URING under NSTPU_DISABLE_URING. */
uint64_t nstpu_engine_create3(int backend, int queue_depth, int nrings,
                              const char* passthru_dev);
void     nstpu_engine_destroy(uint64_t engine);
int      nstpu_engine_backend(uint64_t engine);     /* NSTPU_BACKEND_* or -errno */
int      nstpu_engine_version(void);
/* Static build signature string (version/toolchain/build time) — the
 * /proc/nvme-strom signature-read analog (kmod/nvme_strom.c:2111-2136). */
const char* nstpu_signature(void);

/* Submit one task of nreq requests reading into dest_base.
 * Returns task_id > 0, or -errno. */
int64_t  nstpu_submit(uint64_t engine, void* dest_base,
                      const nstpu_req* reqs, int32_t nreq);

/* Wait for a task and reap it (MEMCPY_WAIT analog).
 * 0 = success; -errno = the task's latched first error (task reaped);
 * -ETIMEDOUT = still running (task NOT reaped); -ENOENT = unknown id.
 * timeout_ms < 0 waits forever. */
int      nstpu_wait(uint64_t engine, int64_t task_id, int64_t timeout_ms);

/* List task ids still in the table (running or retained-failed).
 * Returns count written (<= cap), or -errno. */
int      nstpu_pending(uint64_t engine, int64_t* out, int32_t cap);

/* Force-reap every completed task, returning ids of FAILED ones
 * (the ioctl-fd-close reap, kmod/nvme_strom.c:2138-2166 analog).
 * Blocks up to timeout_ms for running tasks.  Returns count of failed
 * ids written (<= cap), or -errno. */
int      nstpu_engine_reap(uint64_t engine, int64_t* failed_out, int32_t cap,
                           int64_t timeout_ms);

/* Copy the counter array (NSTPU_CTR__COUNT entries).  MAX_DMA_COUNT is
 * read-and-reset to the current in-flight count, like the reference's
 * STAT_INFO (kmod/nvme_strom.c:2087).  Returns entries written. */
int      nstpu_engine_stats(uint64_t engine, uint64_t* out, int32_t cap);

/* Copy the per-request service-latency histogram (NSTPU_LAT_BUCKETS
 * log2-ns buckets, monotonic — callers delta successive reads).
 * Returns entries written, or -errno. */
int      nstpu_engine_lat_hist(uint64_t engine, uint64_t* out, int32_t cap);

/* Per-member accounting: out3[0]=completed requests, out3[1]=bytes,
 * out3[2]=ns of request busy time.  Returns 0, -EINVAL for member out of
 * [0, NSTPU_MAX_MEMBERS), -ENOENT for a bad engine handle. */
int      nstpu_engine_member_stats(uint64_t engine, int32_t member,
                                   uint64_t* out3);

/* -- lane topology (API v2) ---------------------------------------------
 * A LANE is one independent queue pair: an io_uring ring with its own
 * submit lock + completion reaper, or (threadpool backend) one request
 * deque with its own worker set.  Stripe members map lane = member %
 * nlanes, so a slow member queues behind itself, never behind siblings —
 * the per-NVMe-device blk-mq hardware-queue analog
 * (kmod/nvme_strom.c:1201-1223, independent per-device in-flight
 * :1585-1586). */

/* Lane count of a live engine.  Returns >= 1, or -errno. */
int      nstpu_engine_nlanes(uint64_t engine);

/* Pin one lane's service threads (reaper + workers) to a CPU list — the
 * NUMA-locality lever: the reference allocates DMA buffers on the
 * device-local node (pgsql/nvme_strom.c:1454-1526); here the completion
 * path is pinned to the member device's node so CQ reaping and the
 * landing memcpy stay on local memory.  Returns 0; -EINVAL on bad
 * lane/args; -ESHUTDOWN when the engine is stopping. */
int      nstpu_engine_lane_pin(uint64_t engine, int32_t lane,
                               const int32_t* cpus, int32_t ncpus);

/* Per-member service-latency histogram (NSTPU_LAT_BUCKETS log2-ns
 * buckets, monotonic — callers delta successive reads).  The per-member
 * feed for the per-member adaptive chunk sizer and tpu_stat -v columns.
 * Returns entries written, or -errno. */
int      nstpu_engine_member_lat_hist(uint64_t engine, int32_t member,
                                      uint64_t* out, int32_t cap);

/* Per-member queue-occupancy integrals: out2[0] = sum(in_flight * dt) in
 * ns, out2[1] = ns with that member's in_flight > 0.  Mean per-member
 * occupancy over a window is d(out2[0])/d(out2[1]).  Monotonic.
 * Returns 0, or -errno. */
int      nstpu_engine_member_occ(uint64_t engine, int32_t member,
                                 uint64_t* out2);

/* Registered (fixed) buffers — the PRP-list-pool analog: the reference
 * pre-allocates DMA-coherent PRP arrays so the hot path never pays mapping
 * setup (kmod/nvme_strom.c:912-936); here a pinned staging buffer is
 * registered with io_uring once, and every request whose destination falls
 * inside it rides IORING_OP_READ_FIXED/WRITE_FIXED with the pages already
 * GUP-pinned and translated — no per-request get_user_pages.
 *
 * nstpu_buf_register returns a slot >= 0, -ENOSYS when the backend has no
 * fixed-buffer support (threadpool, old kernel), -ENOSPC when all slots are
 * taken, or another -errno from the kernel (e.g. -ENOMEM memlock limit).
 * Callers MUST keep [base, base+len) mapped until nstpu_buf_unregister (or
 * engine destroy); requests simply fall back to the normal opcode when
 * their destination is not inside any registered region. */
int      nstpu_buf_register(uint64_t engine, void* base, uint64_t len);
int      nstpu_buf_unregister(uint64_t engine, int32_t slot);

/* -- flight-recorder event ring (API v3) --------------------------------
 * When tracing is enabled each lane records one event per completed
 * request — the measured device window (submit->last-completion, the same
 * CLOCK_MONOTONIC ns domain as Python's time.monotonic_ns()) plus its
 * extent and attribution.  Rings are bounded (drop-oldest) and touched
 * only under the lane's completion path; when tracing is off the hot path
 * pays exactly one relaxed atomic load per completion. */
#define NSTPU_TRACE_RING_EVENTS 4096

typedef struct nstpu_trace_event {
  uint64_t submit_ns;    /* CLOCK_MONOTONIC at request submission */
  uint64_t complete_ns;  /* CLOCK_MONOTONIC at final completion */
  uint64_t file_off;     /* original extent (pre-continuation) */
  uint64_t len;          /* original request length */
  uint32_t member;       /* stripe member attribution */
  uint32_t lane;         /* lane (queue pair) index */
  int32_t  result;       /* 0 or -errno latched for the request */
  uint32_t seq;          /* engine-global sequence (drop detection) */
} nstpu_trace_event;

/* Enable/disable event recording.  Returns previous state (0/1) or
 * -ENOENT for a bad handle.  Off is the default; enabling mid-flight is
 * safe (in-flight requests complete with recording per the flag at their
 * completion time). */
int      nstpu_engine_trace(uint64_t engine, int enable);

/* Drain up to cap recorded events (all lanes, oldest first per lane) into
 * out and clear them from the rings.  Returns events written, or -errno.
 * Callers poll this from the completion/await path; an undrained full
 * ring drops its oldest events (seq gaps reveal the loss). */
int      nstpu_engine_trace_drain(uint64_t engine, nstpu_trace_event* out,
                                  int32_t cap);

/* -- raw NVMe passthrough (API v4) --------------------------------------
 * Capability probe for one NVMe namespace char device: open + NVME_IOCTL_ID
 * + an SQE128|CQE32 ring + io_uring_probe(URING_CMD) + identify-namespace
 * LBA format — the engine-create ladder runs exactly this.  Returns the
 * LBA shift (>= 9) when passthrough is usable, or a negative
 * NSTPU_PASSTHRU_* refusal reason.  Never touches engine state. */
int      nstpu_passthru_probe(const char* dev_path);

/* Why the passthrough rung was (or was not) taken for this engine:
 * 0 = NVME_PASSTHRU is the active backend; negative NSTPU_PASSTHRU_*
 * reason = the ladder fell through to io_uring/threadpool; -ENOENT = bad
 * handle.  The bindings count the reason into per-reason fallback stats. */
int      nstpu_engine_passthru_reason(uint64_t engine);

#ifdef __cplusplus
}
#endif
#endif /* STROM_TPU_H */
