// strom_engine.cc — native async I/O engine (io_uring + thread-pool backends).
//
// This is the TPU framework's equivalent of the reference's kernel-resident
// runtime (kmod/nvme_strom.c): an async request executor with a 512-slot
// task table, per-request refcounting, first-error latching, failed-task
// retention, bounded in-flight depth, and a stats registry — rebuilt as an
// in-process C++ engine because on TPU the pinning/registration boundary is
// PJRT (userspace), not a kernel module (SURVEY.md SS7 design stance).
//
// Build: g++ -O2 -std=c++17 -fPIC -pthread -shared, at first use, by
// nvme_strom_tpu_torch/_build.py (build_engine) into its _build/ directory.

#include "strom_tpu.h"

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <linux/io_uring.h>
#include <pthread.h>
#include <stdlib.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <sched.h>
#include <time.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// small utilities
// ---------------------------------------------------------------------------

uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

// atomic max, the reference's atomic64_max_return (kmod/nvme_strom.c:108-119)
void atomic_max(std::atomic<uint64_t>& a, uint64_t v) {
  uint64_t cur = a.load(std::memory_order_relaxed);
  while (cur < v && !a.compare_exchange_weak(cur, v)) {
  }
}

// ---------------------------------------------------------------------------
// raw io_uring (no liburing in the image; ~the minimal subset we need)
// ---------------------------------------------------------------------------

int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete, flags,
                      nullptr, 0);
}
int sys_io_uring_register(int fd, unsigned opcode, void* arg,
                          unsigned nr_args) {
  return (int)syscall(__NR_io_uring_register, fd, opcode, arg, nr_args);
}

// Local mirror of the modern io_uring_rsrc_register: build-image UAPI
// headers may predate the `flags` field (older headers call it `resv`;
// the wire layout is identical), and IORING_RSRC_REGISTER_SPARSE with it.
// The running kernel decides support at io_uring_register time either way.
struct nstpu_rsrc_register {
  uint32_t nr;
  uint32_t flags;
  uint64_t resv2;
  uint64_t data;
  uint64_t tags;
};
static_assert(sizeof(nstpu_rsrc_register) == sizeof(io_uring_rsrc_register),
              "rsrc_register layout drifted from the kernel UAPI");
#ifndef IORING_RSRC_REGISTER_SPARSE
#define IORING_RSRC_REGISTER_SPARSE (1U << 0)
#endif

// ---------------------------------------------------------------------------
// NVMe passthrough UAPI mirrors (API v4).  Build-image headers may predate
// io_uring command passthrough entirely (5.19), so every constant and
// struct the submit path needs is mirrored locally with the layout pinned
// by static_assert — same discipline as nstpu_rsrc_register above.  The
// running kernel decides actual support at probe time.
// ---------------------------------------------------------------------------

#ifndef IORING_SETUP_SQE128
#define IORING_SETUP_SQE128 (1U << 10)  // 128-byte SQEs (passthru cmds)
#endif
#ifndef IORING_SETUP_CQE32
#define IORING_SETUP_CQE32 (1U << 11)   // 32-byte CQEs (cmd result space)
#endif
#ifndef IORING_REGISTER_PROBE
#define IORING_REGISTER_PROBE 8
#endif
// IORING_OP_URING_CMD slot (stable since 5.19); old headers lack the enum
#define NSTPU_IORING_OP_URING_CMD 46
#define NSTPU_IO_URING_OP_SUPPORTED (1U << 0)

// io_uring_probe mirror (header may predate it): 16-byte header + ops
struct nstpu_uring_probe_op {
  uint8_t op;
  uint8_t resv;
  uint16_t flags;
  uint32_t resv2;
};
struct nstpu_uring_probe {
  uint8_t last_op;
  uint8_t ops_len;
  uint16_t resv;
  uint32_t resv2[3];
  nstpu_uring_probe_op ops[64];
};
static_assert(sizeof(nstpu_uring_probe) == 16 + 64 * 8,
              "io_uring_probe mirror layout drifted");

// struct nvme_uring_cmd (linux/nvme_ioctl.h): the 72-byte raw command the
// kernel copies from sqe->cmd — the userspace mirror of the reference's
// raw READ command build (kmod/nvme_strom.c:1518-1589).
struct nstpu_nvme_uring_cmd {
  uint8_t opcode;
  uint8_t flags;
  uint16_t rsvd1;
  uint32_t nsid;
  uint32_t cdw2;
  uint32_t cdw3;
  uint64_t metadata;
  uint64_t addr;
  uint32_t metadata_len;
  uint32_t data_len;
  uint32_t cdw10;  // SLBA low
  uint32_t cdw11;  // SLBA high
  uint32_t cdw12;  // NLB - 1 (0-based block count)
  uint32_t cdw13;
  uint32_t cdw14;
  uint32_t cdw15;
  uint32_t timeout_ms;
  uint32_t rsvd2;
};
static_assert(sizeof(nstpu_nvme_uring_cmd) == 72,
              "nvme_uring_cmd mirror layout drifted");

// struct nvme_passthru_cmd (same wire layout, `result` in the last word)
// for the synchronous identify-namespace admin ioctl at probe time.
struct nstpu_nvme_passthru_cmd {
  uint8_t opcode;
  uint8_t flags;
  uint16_t rsvd1;
  uint32_t nsid;
  uint32_t cdw2;
  uint32_t cdw3;
  uint64_t metadata;
  uint64_t addr;
  uint32_t metadata_len;
  uint32_t data_len;
  uint32_t cdw10;
  uint32_t cdw11;
  uint32_t cdw12;
  uint32_t cdw13;
  uint32_t cdw14;
  uint32_t cdw15;
  uint32_t timeout_ms;
  uint32_t result;
};
static_assert(sizeof(nstpu_nvme_passthru_cmd) == 72,
              "nvme_passthru_cmd mirror layout drifted");

// _IO('N', 0x40) / _IOWR('N', 0x41, nvme_admin_cmd) / _IOWR('N', 0x80,
// nvme_uring_cmd) — precomputed so no <linux/nvme_ioctl.h> is needed
#define NSTPU_NVME_IOCTL_ID 0x4E40u
#define NSTPU_NVME_IOCTL_ADMIN_CMD 0xC0484E41u
#define NSTPU_NVME_URING_CMD_IO 0xC0484E80u
#define NSTPU_NVME_CMD_READ 0x02  // NVM command set READ opcode
// sqe->cmd offset: the passthru command block starts at byte 48 of the
// 128-byte SQE (old headers have no `cmd` member to name it by)
#define NSTPU_SQE_CMD_OFFSET 48

struct Uring {
  int fd = -1;
  unsigned sq_entries = 0, cq_entries = 0;
  // SQ ring
  void* sq_ring = nullptr;
  size_t sq_ring_sz = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  io_uring_sqe* sqes = nullptr;
  size_t sqes_sz = 0;
  // CQ ring
  void* cq_ring = nullptr;
  size_t cq_ring_sz = 0;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  io_uring_cqe* cqes = nullptr;
  bool single_mmap = false;
  // Stride shifts: passthru rings use 128-byte SQEs (the extra 80 bytes hold
  // the raw nvme_uring_cmd) and 32-byte CQEs, selected by init(entries, true).
  // All indexed access goes through get_sqe()/cqe_at() so both geometries
  // share one code path.
  unsigned sqe_shift = 6;  // 64B default, 7 for SQE128
  unsigned cqe_shift = 4;  // 16B default, 5 for CQE32

  bool init(unsigned entries, bool big = false) {
    struct io_uring_params p;
    memset(&p, 0, sizeof p);
    if (big) p.flags |= IORING_SETUP_SQE128 | IORING_SETUP_CQE32;
    sqe_shift = big ? 7 : 6;
    cqe_shift = big ? 5 : 4;
    fd = sys_io_uring_setup(entries, &p);
    if (fd < 0) return false;
    sq_entries = p.sq_entries;
    cq_entries = p.cq_entries;
    single_mmap = p.features & IORING_FEAT_SINGLE_MMAP;
    sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_ring_sz = p.cq_off.cqes + ((size_t)p.cq_entries << cqe_shift);
    if (single_mmap) sq_ring_sz = cq_ring_sz = std::max(sq_ring_sz, cq_ring_sz);
    sq_ring = mmap(nullptr, sq_ring_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (sq_ring == MAP_FAILED) return fail();
    cq_ring = single_mmap
                  ? sq_ring
                  : mmap(nullptr, cq_ring_sz, PROT_READ | PROT_WRITE,
                         MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
    if (cq_ring == MAP_FAILED) return fail();
    sqes_sz = (size_t)p.sq_entries << sqe_shift;
    sqes = (io_uring_sqe*)mmap(nullptr, sqes_sz, PROT_READ | PROT_WRITE,
                               MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES);
    if (sqes == MAP_FAILED) return fail();
    auto* sqb = (char*)sq_ring;
    sq_head = (unsigned*)(sqb + p.sq_off.head);
    sq_tail = (unsigned*)(sqb + p.sq_off.tail);
    sq_mask = (unsigned*)(sqb + p.sq_off.ring_mask);
    sq_array = (unsigned*)(sqb + p.sq_off.array);
    auto* cqb = (char*)cq_ring;
    cq_head = (unsigned*)(cqb + p.cq_off.head);
    cq_tail = (unsigned*)(cqb + p.cq_off.tail);
    cq_mask = (unsigned*)(cqb + p.cq_off.ring_mask);
    cqes = (io_uring_cqe*)(cqb + p.cq_off.cqes);
    return true;
  }

  bool fail() {
    destroy();
    return false;
  }

  void destroy() {
    if (sqes && sqes != MAP_FAILED) munmap(sqes, sqes_sz);
    if (!single_mmap && cq_ring && cq_ring != MAP_FAILED)
      munmap(cq_ring, cq_ring_sz);
    if (sq_ring && sq_ring != MAP_FAILED) munmap(sq_ring, sq_ring_sz);
    if (fd >= 0) close(fd);
    fd = -1;
    sq_ring = cq_ring = nullptr;
    sqes = nullptr;
  }

  // caller must hold the engine's sq mutex
  io_uring_sqe* get_sqe() {
    unsigned head = __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
    unsigned tail = *sq_tail;
    if (tail - head >= sq_entries) return nullptr;  // SQ full
    io_uring_sqe* sqe =
        (io_uring_sqe*)((char*)sqes + ((size_t)(tail & *sq_mask) << sqe_shift));
    memset(sqe, 0, (size_t)1 << sqe_shift);
    sq_array[tail & *sq_mask] = tail & *sq_mask;
    return sqe;
  }
  // CQE at ring index (stride-aware; idx already masked by the caller)
  io_uring_cqe* cqe_at(unsigned idx) const {
    return (io_uring_cqe*)((char*)cqes + ((size_t)idx << cqe_shift));
  }
  void advance_sq() {
    __atomic_store_n(sq_tail, *sq_tail + 1, __ATOMIC_RELEASE);
  }
};

// ---------------------------------------------------------------------------
// task table
// ---------------------------------------------------------------------------

constexpr int kTaskSlots = 512;  // reference slot count (kmod/nvme_strom.c:639)

struct Task {
  int64_t id;
  int pending;   // in-flight requests + 1 creator ref (guarded by slot mutex)
  bool frozen;   // submission loop finished; no new refs (:1766-1767)
  int err;       // first errno latched (:770-776)
  int state;     // 0 running, 1 done, 2 failed
  uint64_t t_submit;
};

struct Slot {
  std::mutex m;
  std::condition_variable cv;
  std::unordered_map<int64_t, Task*> tasks;
};

// one in-flight request; user_data in the uring / queue item in the pool
struct ReqCtx {
  Task* task;
  int fd;
  uint64_t file_off;
  uint64_t remaining;
  char* dest;  // advances as short reads/writes are continued
  bool write;  // NSTPU_REQ_WRITE: dest is the SOURCE, fd the destination
  uint8_t member;     // stripe member index for per-member accounting
  uint64_t orig_len;  // full request length (remaining shrinks on resubmit)
  uint64_t t_start;   // submit timestamp for per-member busy time
  uint8_t ring_idx = 0;    // which ring owns this request's window slot
  int16_t fixed_idx = -1;  // registered-buffer slot, resolved pre-queue
  // NSTPU_REQ_PASSTHRU: file_off is a DEVICE byte offset; queued as a raw
  // NVMe READ via IORING_OP_URING_CMD against the engine's char-dev fd
  bool passthru = false;
  // publication fence: submitter->reaper handoff otherwise flows through the
  // kernel ring, which TSAN cannot see; store-release before queueing, and
  // load-acquire on pickup, makes the happens-before edge explicit
  std::atomic<uint32_t> published{0};
};

// One LANE: an independent queue pair with its own submit lock, completion
// service threads, and in-flight window — the per-NVMe-device hardware
// queue analog: the reference submits each merged request onto the owning
// device's own blk-mq queue (kmod/nvme_strom.c:1201-1223) with independent
// in-flight across devices (:1585-1586).  Stripe members map onto lanes
// (member % nlanes), so a 4-member RAID-0 submits and completes on 4
// independent queues instead of funneling through one lock + one reaper,
// and a slow member queues behind itself, never behind its siblings.
// On the io_uring backend a lane is a ring + reaper; on the threadpool
// backend it is a request deque + worker set (ring.fd stays -1).
struct RingCtx {
  Uring ring;
  std::mutex sq_m;
  std::thread reaper;
  // per-lane bounded in-flight window (CQ can never overflow); members on
  // different lanes do not throttle each other
  std::mutex win_m;
  std::condition_variable win_cv;
  unsigned win_inflight = 0;
  // threadpool-lane queue (unused on the io_uring backend)
  std::mutex q_m;
  std::condition_variable q_cv;
  std::deque<ReqCtx*> q;
  std::vector<std::thread> workers;
  // flight-recorder event ring (API v3): one event per completed request,
  // recorded on this lane's completion path only when tracing is on —
  // bounded drop-oldest, drained by nstpu_engine_trace_drain.  Its own
  // mutex: never nests with sq_m/win_m/q_m (record happens after the
  // window slot is still held but touches no other lock).
  std::mutex tr_m;
  std::deque<nstpu_trace_event> tr;
};

// ---------------------------------------------------------------------------
// engine
// ---------------------------------------------------------------------------

struct Engine {
  int backend = NSTPU_BACKEND_THREADPOOL;
  unsigned depth = 32;
  // passthrough state (API v4): char-dev fd + geometry when the top rung
  // of the ladder won; otherwise passthru_reason says which probe rung
  // refused (0 = active, negative NSTPU_PASSTHRU_*)
  struct PtState {
    int dev_fd = -1;
    uint32_t nsid = 0;
    unsigned lba_shift = 9;
  } pt;
  int passthru_reason = NSTPU_PASSTHRU_ENODEV;
  std::string pt_dev;  // device path requested at create (may be empty)
  std::atomic<uint64_t> ctr[NSTPU_CTR__COUNT];
  // per-member request/byte/busy-ns counters (part_stat_add analog,
  // kmod/nvme_strom.c:1101-1123)
  std::atomic<uint64_t> member_ctr[NSTPU_MAX_MEMBERS][3];
  Slot slots[kTaskSlots];
  std::atomic<int64_t> next_task{1};
  std::atomic<bool> stopping{false};

  // flight recorder (API v3): off by default; when off the completion
  // path pays exactly one relaxed load.  trace_seq_ is engine-global so
  // drained events interleave with a total order and ring drops show as
  // sequence gaps.
  std::atomic<int> trace_on_{0};
  std::atomic<uint32_t> trace_seq_{0};

  // queue-occupancy integral: the interval ending at each in-flight
  // transition is accounted against the OLD level, so mean occupancy
  // over a stats window is d(OCC_INTEGRAL_NS)/d(OCC_BUSY_NS) — the
  // direct observable for "the submission window held the queue full".
  // Aggregated across lanes (the planner's queue_depth contract is
  // per-engine, and tpu_stat shows one gauge); the per-member integrals
  // below are the per-lane breakdown tpu_stat -v shows per member.
  std::mutex occ_m;
  uint64_t occ_last_ns = 0;
  uint64_t occ_cur = 0;
  uint64_t m_occ_last[NSTPU_MAX_MEMBERS] = {};
  uint64_t m_occ_cur[NSTPU_MAX_MEMBERS] = {};
  uint64_t m_occ_integral[NSTPU_MAX_MEMBERS] = {};
  uint64_t m_occ_busy[NSTPU_MAX_MEMBERS] = {};

  // per-request service-latency histogram: log2-ns buckets filled at
  // completion (submit->completion per request, the per-chunk latency
  // the adaptive sizer and tpu_stat percentiles consume); the per-member
  // planes feed per-member percentiles and the per-member adaptive sizer
  std::atomic<uint64_t> lat_hist_[NSTPU_LAT_BUCKETS];
  std::atomic<uint64_t> member_hist_[NSTPU_MAX_MEMBERS][NSTPU_LAT_BUCKETS];

  void occ_note(int delta, int member = -1) {
    uint64_t now = now_ns();
    std::lock_guard<std::mutex> lk(occ_m);
    if (occ_last_ns && occ_cur) {
      uint64_t dt = now - occ_last_ns;
      ctr[NSTPU_CTR_OCC_INTEGRAL_NS].fetch_add(occ_cur * dt,
                                               std::memory_order_relaxed);
      ctr[NSTPU_CTR_OCC_BUSY_NS].fetch_add(dt, std::memory_order_relaxed);
    }
    occ_last_ns = now;
    occ_cur = (uint64_t)((int64_t)occ_cur + delta);
    if (member >= 0 && member < NSTPU_MAX_MEMBERS) {
      if (m_occ_last[member] && m_occ_cur[member]) {
        uint64_t dt = now - m_occ_last[member];
        m_occ_integral[member] += m_occ_cur[member] * dt;
        m_occ_busy[member] += dt;
      }
      m_occ_last[member] = now;
      m_occ_cur[member] = (uint64_t)((int64_t)m_occ_cur[member] + delta);
    }
  }

  int member_occ(int32_t member, uint64_t* out2) {
    if (member < 0 || member >= NSTPU_MAX_MEMBERS || !out2) return -EINVAL;
    uint64_t now = now_ns();
    std::lock_guard<std::mutex> lk(occ_m);
    // bring the integral current: it only advances on transitions, so a
    // long steady interval would otherwise undercount (stats() analog)
    if (m_occ_last[member] && m_occ_cur[member]) {
      uint64_t dt = now - m_occ_last[member];
      m_occ_integral[member] += m_occ_cur[member] * dt;
      m_occ_busy[member] += dt;
      m_occ_last[member] = now;
    }
    out2[0] = m_occ_integral[member];
    out2[1] = m_occ_busy[member];
    return 0;
  }

  int trace_set(int enable) {
    return trace_on_.exchange(enable ? 1 : 0, std::memory_order_relaxed);
  }

  int trace_drain(nstpu_trace_event* out, int32_t cap) {
    if (!out || cap < 0) return -EINVAL;
    int n = 0;
    for (auto* rx : rings) {
      std::lock_guard<std::mutex> lk(rx->tr_m);
      while (n < cap && !rx->tr.empty()) {
        out[n++] = rx->tr.front();
        rx->tr.pop_front();
      }
      if (n >= cap) break;
    }
    return n;
  }

  // one lane per (member % nlanes), BOTH backends — see RingCtx
  std::vector<RingCtx*> rings;

  // registered (fixed) buffer table — the PRP-list-pool analog
  // (kmod/nvme_strom.c:912-936): pre-pinned, pre-translated destinations.
  // The logical table lives here under fixed_m; each ring mirrors every
  // registration (fixed tables are per-ring-fd in the kernel).  Lock
  // order: a submitter resolves fixed_idx under fixed_m BEFORE taking any
  // sq_m; register/unregister take only fixed_m — no sq_m nesting.
  static constexpr unsigned kFixedSlots = 64;
  struct FixedReg {
    char* base = nullptr;
    uint64_t len = 0;  // 0 = free slot
  };
  std::mutex fixed_m;
  FixedReg fixed[kFixedSlots];
  bool fixed_ok = false;

  Slot& slot_of(int64_t id) { return slots[id % kTaskSlots]; }

  RingCtx& ring_of(const ReqCtx* rc) { return *rings[rc->ring_idx]; }

  // verify IORING_OP_READ / IORING_OP_WRITE actually work (io_uring_setup
  // succeeds on 5.1-5.5 kernels where these opcodes do not exist); run
  // before the reapers start, so we can consume the CQEs synchronously
  bool probe_one_op(Uring& ring, uint8_t opcode) {
    int fd = open("/dev/null", O_RDWR);
    if (fd < 0) return false;
    char byte = 0;
    io_uring_sqe* sqe = ring.get_sqe();
    if (!sqe) {
      close(fd);
      return false;
    }
    sqe->opcode = opcode;
    sqe->fd = fd;
    sqe->addr = (uint64_t)&byte;
    sqe->len = 1;
    sqe->off = 0;
    sqe->user_data = 1;
    ring.advance_sq();
    int rc = sys_io_uring_enter(ring.fd, 1, 1, IORING_ENTER_GETEVENTS);
    close(fd);
    if (rc < 0) return false;
    unsigned head = __atomic_load_n(ring.cq_head, __ATOMIC_RELAXED);
    unsigned tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
    if (head == tail) return false;
    int res = ring.cqe_at(head & *ring.cq_mask)->res;
    __atomic_store_n(ring.cq_head, head + 1, __ATOMIC_RELEASE);
    return res != -EINVAL && res != -EOPNOTSUPP;
  }
  bool probe_ops(Uring& ring) {
    return probe_one_op(ring, IORING_OP_READ) &&
           probe_one_op(ring, IORING_OP_WRITE);
  }

  // ---- NVMe char-device passthrough probe (API v4) -----------------------
  // The userspace analog of the reference taking the raw NVMe queue
  // (kmod/nvme_strom.c:1518-1589): verify, at engine create, that
  //  (1) the char device opens,
  //  (2) it answers NVME_IOCTL_ID (it really is an NVMe ns node),
  //  (3) the kernel supports IORING_OP_URING_CMD (io_uring_probe),
  //  (4) identify-namespace yields a sane LBA format.
  // Returns the LBA shift (>= 0) on success, or a negative
  // NSTPU_PASSTHRU_* refusal reason — the ladder records which rung
  // refused so "why is passthru off" is answerable from counters.
  static int passthru_probe_dev(const char* dev, PtState* out) {
    const char* no_pt = getenv("NSTPU_DISABLE_PASSTHRU");
    if (no_pt && *no_pt && *no_pt != '0') return NSTPU_PASSTHRU_EDISABLED;
    if (!dev || !*dev) return NSTPU_PASSTHRU_ENODEV;
    int fd = open(dev, O_RDONLY);
    if (fd < 0) return NSTPU_PASSTHRU_ENODEV;
    int nsid = ioctl(fd, NSTPU_NVME_IOCTL_ID);
    if (nsid <= 0) {
      close(fd);
      return NSTPU_PASSTHRU_ENODEV;
    }
    // kernel-side URING_CMD support: a throwaway big ring + opcode probe
    {
      Uring probe_ring;
      if (!probe_ring.init(4, /*big=*/true)) {
        close(fd);
        return NSTPU_PASSTHRU_ENOURING;
      }
      auto* pr = (nstpu_uring_probe*)calloc(1, sizeof(nstpu_uring_probe));
      bool cmd_ok = false;
      if (pr &&
          sys_io_uring_register(probe_ring.fd, IORING_REGISTER_PROBE, pr,
                                64) == 0)
        cmd_ok = pr->last_op >= NSTPU_IORING_OP_URING_CMD &&
                 (pr->ops[NSTPU_IORING_OP_URING_CMD].flags &
                  NSTPU_IO_URING_OP_SUPPORTED);
      free(pr);
      probe_ring.destroy();
      if (!cmd_ok) {
        close(fd);
        return NSTPU_PASSTHRU_ENOCMD;
      }
    }
    // identify-namespace (admin opcode 0x06, CNS 0): flbas selects the
    // active LBA format; lbads is its log2 data size.  4K-aligned buffer —
    // the admin path DMAs into it.
    void* idbuf = nullptr;
    if (posix_memalign(&idbuf, 4096, 4096) != 0 || !idbuf) {
      close(fd);
      return NSTPU_PASSTHRU_ELBAFMT;
    }
    memset(idbuf, 0, 4096);
    nstpu_nvme_passthru_cmd cmd;
    memset(&cmd, 0, sizeof cmd);
    cmd.opcode = 0x06;  // identify
    cmd.nsid = (uint32_t)nsid;
    cmd.addr = (uint64_t)idbuf;
    cmd.data_len = 4096;
    cmd.cdw10 = 0;  // CNS 0: identify namespace
    int rc = ioctl(fd, NSTPU_NVME_IOCTL_ADMIN_CMD, &cmd);
    unsigned lba_shift = 0;
    if (rc == 0) {
      auto* id = (const uint8_t*)idbuf;
      unsigned fmt = id[26] & 0xF;  // flbas low nibble
      lba_shift = id[128 + 4 * fmt + 2];
    }
    free(idbuf);
    if (rc != 0 || lba_shift < 9 || lba_shift > 16) {
      close(fd);
      return NSTPU_PASSTHRU_ELBAFMT;
    }
    if (out) {
      out->dev_fd = fd;
      out->nsid = (uint32_t)nsid;
      out->lba_shift = lba_shift;
    } else {
      close(fd);
    }
    return (int)lba_shift;
  }

  // ring count when the caller does not fix one (nstpu_engine_create /
  // create2 with nrings <= 0): env NSTPU_RINGS, else 1.  Default is ONE
  // queue because extra rings only pay off when stripe members are
  // distinct physical devices — on a shared backing disk a 4x32-deep A/B
  // measured ~30% below 1x32 (they just multiply in-flight and seek).
  // Multi-device deployments raise it (config engine_rings / env).
  static unsigned want_rings() {
    const char* env = getenv("NSTPU_RINGS");
    long v = env ? atol(env) : 1;
    if (v < 1) v = 1;
    if (v > 16) v = 16;
    return (unsigned)v;
  }

  unsigned nrings_want = 0;  // 0 = want_rings() default; set by create2

  ~Engine() {
    shutdown();
    // RingCtx structs survive shutdown (their mutexes/CVs may still be
    // touched by a submitter waking up to observe `stopping`); only the
    // fully-quiesced destructor frees them
    for (auto* rx : rings) delete rx;
    rings.clear();
  }

  bool init(int want_backend, int queue_depth) {
    for (auto& c : ctr) c.store(0);
    for (auto& row : member_ctr)
      for (auto& c : row) c.store(0);
    for (auto& b : lat_hist_) b.store(0);
    for (auto& row : member_hist_)
      for (auto& b : row) b.store(0);
    depth = queue_depth > 0 ? (unsigned)queue_depth : 32u;
    // NSTPU_DISABLE_URING=1 makes io_uring setup "fail" deterministically:
    // AUTO falls over to the threadpool (the graceful-degradation path the
    // stress test exercises), an explicit IO_URING request fails honestly
    const char* no_uring = getenv("NSTPU_DISABLE_URING");
    bool uring_disabled = no_uring && *no_uring && *no_uring != '0';
    if (uring_disabled && want_backend == NSTPU_BACKEND_IO_URING)
      return false;
    // Top rung (API v4): raw NVMe passthrough over the char device.  Only
    // attempted when a device path is known; every refusal keeps its reason
    // in passthru_reason so the binding can count WHY the ladder fell.
    passthru_reason = NSTPU_PASSTHRU_EDISABLED;  // explicit lower backend
    if (want_backend == NSTPU_BACKEND_AUTO ||
        want_backend == NSTPU_BACKEND_NVME_PASSTHRU) {
      const char* dev = !pt_dev.empty() ? pt_dev.c_str()
                                        : getenv("NSTPU_PASSTHRU_DEV");
      int pr = passthru_probe_dev(dev, &pt);
      if (pr >= 0) {
        // big rings: SQE128 carries the 72-byte nvme_uring_cmd inline
        unsigned nr = nrings_want ? nrings_want : want_rings();
        bool ok = true;
        for (unsigned i = 0; i < nr; i++) {
          auto* rx = new RingCtx();
          if (!rx->ring.init(depth, /*big=*/true)) {
            delete rx;
            ok = !rings.empty();
            break;
          }
          rings.push_back(rx);
        }
        // passthru rings still serve plain READ/WRITE (continuations,
        // non-eligible extents never reach here, but probe_ops keeps the
        // same "opcodes actually work" guarantee as the uring rung)
        if (ok && !rings.empty() && probe_ops(rings[0]->ring)) {
          backend = NSTPU_BACKEND_NVME_PASSTHRU;
          depth = rings[0]->ring.sq_entries;
          passthru_reason = 0;
          fixed_ok = true;
          for (auto* rx : rings) {
            struct nstpu_rsrc_register rr;
            memset(&rr, 0, sizeof rr);
            rr.nr = kFixedSlots;
            rr.flags = IORING_RSRC_REGISTER_SPARSE;
            if (sys_io_uring_register(rx->ring.fd, IORING_REGISTER_BUFFERS2,
                                      &rr, sizeof rr) != 0)
              fixed_ok = false;
          }
          for (auto* rx : rings)
            rx->reaper = std::thread([this, rx] { reap_loop(rx); });
          return true;
        }
        for (auto* rx : rings) {
          rx->ring.destroy();
          delete rx;
        }
        rings.clear();
        close(pt.dev_fd);
        pt.dev_fd = -1;
        passthru_reason = NSTPU_PASSTHRU_ENOURING;
      } else {
        passthru_reason = pr;
      }
      if (want_backend == NSTPU_BACKEND_NVME_PASSTHRU) return false;
    }
    if (!uring_disabled &&
        (want_backend == NSTPU_BACKEND_AUTO ||
         want_backend == NSTPU_BACKEND_IO_URING)) {
      unsigned nr = nrings_want ? nrings_want : want_rings();
      bool ok = true;
      for (unsigned i = 0; i < nr; i++) {
        auto* rx = new RingCtx();
        if (!rx->ring.init(depth)) {
          delete rx;
          // ring 0 failing means no io_uring at all; a later ring failing
          // (fd/memlock limits) just caps the queue count
          ok = !rings.empty();
          break;
        }
        rings.push_back(rx);
      }
      if (ok && !rings.empty() && probe_ops(rings[0]->ring)) {
        backend = NSTPU_BACKEND_IO_URING;
        depth = rings[0]->ring.sq_entries;
        // sparse fixed-buffer table (5.13+) on EVERY ring; failure just
        // disables the READ_FIXED fast path, never the engine
        fixed_ok = true;
        for (auto* rx : rings) {
          struct nstpu_rsrc_register rr;
          memset(&rr, 0, sizeof rr);
          rr.nr = kFixedSlots;
          rr.flags = IORING_RSRC_REGISTER_SPARSE;
          if (sys_io_uring_register(rx->ring.fd, IORING_REGISTER_BUFFERS2,
                                    &rr, sizeof rr) != 0)
            fixed_ok = false;
        }
        for (auto* rx : rings)
          rx->reaper = std::thread([this, rx] { reap_loop(rx); });
        return true;
      }
      for (auto* rx : rings) {
        rx->ring.destroy();
        delete rx;
      }
      rings.clear();
      if (want_backend == NSTPU_BACKEND_IO_URING) return false;
    }
    backend = NSTPU_BACKEND_THREADPOOL;
    // same lane topology as the uring backend: nlanes independent
    // deque+worker sets, member % nlanes routing, per-lane windows —
    // the fallback path keeps the scale-out property
    unsigned nlanes = nrings_want ? nrings_want : want_rings();
    unsigned nthreads = std::min(depth, 16u);
    unsigned per_lane = std::max(1u, nthreads / nlanes);
    for (unsigned i = 0; i < nlanes; i++) rings.push_back(new RingCtx());
    for (auto* rx : rings)
      for (unsigned i = 0; i < per_lane; i++)
        rx->workers.emplace_back([this, rx] { worker_loop(rx); });
    return true;
  }

  bool ring_backend() const {
    return backend == NSTPU_BACKEND_IO_URING ||
           backend == NSTPU_BACKEND_NVME_PASSTHRU;
  }

  void shutdown() {
    if (stopping.exchange(true)) return;
    if (ring_backend()) {
      for (auto* rx : rings) {
        {  // poke the reaper with a NOP so its GETEVENTS wait returns
          std::lock_guard<std::mutex> lk(rx->sq_m);
          io_uring_sqe* sqe = rx->ring.get_sqe();
          if (sqe) {
            sqe->opcode = IORING_OP_NOP;
            sqe->user_data = 0;  // sentinel: shutdown poke
            rx->ring.advance_sq();
            sys_io_uring_enter(rx->ring.fd, 1, 0, 0);
          }
        }
        rx->win_cv.notify_all();
        if (rx->reaper.joinable()) rx->reaper.join();
        rx->ring.destroy();
      }
    } else {
      for (auto* rx : rings) {
        rx->q_cv.notify_all();
        rx->win_cv.notify_all();
        for (auto& w : rx->workers)
          if (w.joinable()) w.join();
      }
    }
    if (pt.dev_fd >= 0) {
      close(pt.dev_fd);
      pt.dev_fd = -1;
    }
  }

  // ---- task lifecycle ----------------------------------------------------

  Task* create_task() {
    auto* t = new Task{};
    t->id = next_task.fetch_add(1);
    t->pending = 1;  // creator ref
    t->frozen = false;
    t->err = 0;
    t->state = 0;
    t->t_submit = now_ns();
    Slot& s = slot_of(t->id);
    std::lock_guard<std::mutex> lk(s.m);
    s.tasks[t->id] = t;
    return t;
  }

  void task_get(Task* t) {
    Slot& s = slot_of(t->id);
    std::lock_guard<std::mutex> lk(s.m);
    t->pending++;
  }

  void task_put(Task* t, int err) {
    Slot& s = slot_of(t->id);
    bool done;
    {
      std::lock_guard<std::mutex> lk(s.m);
      if (err && !t->err) t->err = err;  // first error wins
      done = --t->pending == 0;
      if (done) {
        t->state = t->err ? 2 : 1;
        ctr[NSTPU_CTR_NR_SSD2DEV].fetch_add(1, std::memory_order_relaxed);
        ctr[NSTPU_CTR_CLK_SSD2DEV].fetch_add(now_ns() - t->t_submit,
                                             std::memory_order_relaxed);
      }
    }
    if (done) s.cv.notify_all();
  }

  // ---- request completion (shared by both backends) ----------------------

  // record one flight-recorder event for a finishing request: the
  // measured device window [t_start, now] plus the ORIGINAL extent
  // (file_off advanced on short-read continuations; walk it back by the
  // bytes already consumed).  Bounded drop-oldest per lane.
  void trace_record(ReqCtx* rc, uint64_t complete_ns, int err) {
    nstpu_trace_event ev;
    ev.submit_ns = rc->t_start;
    ev.complete_ns = complete_ns;
    ev.file_off = rc->file_off - (rc->orig_len - rc->remaining);
    ev.len = rc->orig_len;
    ev.member = rc->member;
    ev.lane = rc->ring_idx;
    ev.result = err ? -err : 0;
    ev.seq = trace_seq_.fetch_add(1, std::memory_order_relaxed);
    RingCtx& rx = ring_of(rc);
    std::lock_guard<std::mutex> lk(rx.tr_m);
    if (rx.tr.size() >= NSTPU_TRACE_RING_EVENTS) rx.tr.pop_front();
    rx.tr.push_back(ev);
  }

  void finish_req(ReqCtx* rc, int err) {
    // per-member accounting at completion: requests, bytes, busy ns
    uint64_t now = now_ns();
    if (trace_on_.load(std::memory_order_relaxed))
      trace_record(rc, now, err);
    uint64_t service_ns = now - rc->t_start;
    member_ctr[rc->member][0].fetch_add(1, std::memory_order_relaxed);
    member_ctr[rc->member][1].fetch_add(rc->orig_len,
                                        std::memory_order_relaxed);
    member_ctr[rc->member][2].fetch_add(service_ns,
                                        std::memory_order_relaxed);
    // log2 bucket: 63 - clz(ns), clamped (ns|1 keeps clz defined at 0)
    int bucket = 63 - __builtin_clzll(service_ns | 1);
    lat_hist_[bucket].fetch_add(1, std::memory_order_relaxed);
    member_hist_[rc->member][bucket].fetch_add(1, std::memory_order_relaxed);
    // drop the in-flight slot before waking the task's waiter, so a
    // post-wait stats snapshot never sees a stale cur_dma_count
    drop_inflight_slot(rc);
    task_put(rc->task, err);
    delete rc;
  }

  void drop_inflight_slot(ReqCtx* rc) {
    // both backends: the window slot lives on the owning lane
    RingCtx& rx = ring_of(rc);
    {
      std::lock_guard<std::mutex> lk(rx.win_m);
      rx.win_inflight--;
    }
    rx.win_cv.notify_one();
    ctr[NSTPU_CTR_CUR_DMA_COUNT].fetch_sub(1, std::memory_order_relaxed);
    occ_note(-1, rc->member);
  }

  // ---- io_uring backend --------------------------------------------------

  // resolve the registered-buffer slot for rc's CURRENT [dest, dest+
  // remaining) span (re-run on every continuation: registrations may have
  // churned since the original submit).  Takes fixed_m only — never nests
  // with any sq_m.
  void resolve_fixed(ReqCtx* rc) {
    rc->fixed_idx = -1;
    // passthru commands carry the raw destination pointer in the NVMe
    // command itself; fixed-buffer slots only apply to READ/WRITE opcodes
    if (rc->passthru) return;
    if (!fixed_ok) return;
    std::lock_guard<std::mutex> lk(fixed_m);
    for (unsigned i = 0; i < kFixedSlots; i++) {
      if (fixed[i].len && rc->dest >= fixed[i].base &&
          rc->dest + rc->remaining <= fixed[i].base + fixed[i].len) {
        rc->fixed_idx = (int16_t)i;
        // count once per request, not per continuation, matching the
        // NR_SUBMIT_DMA convention (a short-read resubmit has
        // remaining < orig_len)
        if (rc->remaining == rc->orig_len)
          ctr[NSTPU_CTR_NR_FIXED_DMA].fetch_add(1, std::memory_order_relaxed);
        return;
      }
    }
  }

  // hold rx.sq_m; queue one read/write sqe for rc (fixed_idx pre-resolved)
  bool queue_sqe_locked(RingCtx& rx, ReqCtx* rc) {
    io_uring_sqe* sqe = rx.ring.get_sqe();
    if (!sqe) return false;
    if (rc->passthru) {
      // raw NVMe READ via IORING_OP_URING_CMD — the userspace mirror of
      // the reference building the command itself (kmod/nvme_strom.c:
      // 1518-1589): SLBA/NLB from the blockmap-resolved device offset,
      // data pointer straight at the destination.  file_off is a DEVICE
      // byte offset here (LBA-multiple, pre-validated in submit()).
      sqe->opcode = NSTPU_IORING_OP_URING_CMD;
      sqe->fd = pt.dev_fd;
      // sqe->off unions with cmd_op (u32 at byte 8) + __pad1; the 64-bit
      // store sets cmd_op and zeroes the pad in one go
      sqe->off = NSTPU_NVME_URING_CMD_IO;
      auto* cmd =
          (nstpu_nvme_uring_cmd*)((char*)sqe + NSTPU_SQE_CMD_OFFSET);
      uint64_t slba = rc->file_off >> pt.lba_shift;
      cmd->opcode = NSTPU_NVME_CMD_READ;
      cmd->nsid = pt.nsid;
      cmd->addr = (uint64_t)rc->dest;
      cmd->data_len = (uint32_t)rc->remaining;
      cmd->cdw10 = (uint32_t)slba;
      cmd->cdw11 = (uint32_t)(slba >> 32);
      cmd->cdw12 = (uint32_t)((rc->remaining >> pt.lba_shift) - 1);
      sqe->user_data = (uint64_t)rc;
      rc->published.store(1, std::memory_order_release);
      rx.ring.advance_sq();
      return true;
    }
    if (rc->fixed_idx >= 0) {
      // destination inside a registered buffer -> fixed opcode: the pages
      // are already pinned + translated, no per-request get_user_pages
      sqe->opcode = rc->write ? IORING_OP_WRITE_FIXED : IORING_OP_READ_FIXED;
      sqe->buf_index = (uint16_t)rc->fixed_idx;
    } else {
      sqe->opcode = rc->write ? IORING_OP_WRITE : IORING_OP_READ;
    }
    sqe->fd = rc->fd;
    sqe->addr = (uint64_t)rc->dest;
    sqe->len = (uint32_t)rc->remaining;
    sqe->off = rc->file_off;
    sqe->user_data = (uint64_t)rc;
    // all submitter-side rc accesses are done; publish for the reaper
    rc->published.store(1, std::memory_order_release);
    rx.ring.advance_sq();
    return true;
  }

  void reap_loop(RingCtx* rxp) {
    RingCtx& rx = *rxp;
    Uring& ring = rx.ring;
    for (;;) {
      unsigned head = __atomic_load_n(ring.cq_head, __ATOMIC_RELAXED);
      unsigned tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
      if (head == tail) {
        if (stopping.load()) return;
        int rc = sys_io_uring_enter(ring.fd, 0, 1, IORING_ENTER_GETEVENTS);
        if (rc < 0 && errno != EINTR && errno != EAGAIN && errno != EBUSY)
          return;  // ring broken; outstanding tasks will be failed by reap
        continue;
      }
      while (head != tail) {
        io_uring_cqe* cqe = ring.cqe_at(head & *ring.cq_mask);
        auto* rc = (ReqCtx*)cqe->user_data;
        int res = cqe->res;
        head++;
        __atomic_store_n(ring.cq_head, head, __ATOMIC_RELEASE);
        if (!rc) continue;  // shutdown NOP
        rc->published.load(std::memory_order_acquire);
        if (rc->passthru) {
          // passthru CQE semantics: res is the NVMe command status mapped
          // by the kernel — 0 = the whole command completed, < 0 = -errno.
          // Never a byte count, never short: no continuation path.
          finish_req(rc, res < 0 ? -res : 0);
          tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
          continue;
        }
        if (res == -EFAULT && rc->fixed_idx >= 0) {
          // registered-buffer slot churned between resolve_fixed and the
          // kernel's execution (buf_unregister no longer shares a lock
          // with submission): fall back to the plain opcode — the
          // mapping itself is still valid, only the registration went
          rc->fixed_idx = -1;
          ctr[NSTPU_CTR_NR_RESUBMIT].fetch_add(1, std::memory_order_relaxed);
          std::lock_guard<std::mutex> lk(rx.sq_m);
          if (queue_sqe_locked(rx, rc) && enter_batch_locked(rx, 1) == 1) {
            tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
            continue;
          }
          finish_req(rc, EIO);
        } else if (res < 0) {
          finish_req(rc, -res);
        } else if ((uint64_t)res < rc->remaining && res > 0) {
          // short read/write: continue from where it stopped
          rc->dest += res;
          rc->file_off += res;
          rc->remaining -= res;
          ctr[NSTPU_CTR_NR_RESUBMIT].fetch_add(1, std::memory_order_relaxed);
          resolve_fixed(rc);
          std::lock_guard<std::mutex> lk(rx.sq_m);
          if (queue_sqe_locked(rx, rc) && enter_batch_locked(rx, 1) == 1) {
            // continuation in flight
          } else {
            finish_req(rc, EIO);  // defensive: SQ full / ring broken
          }
        } else if (res == 0) {
          // unexpected EOF (read) / no-progress (write) inside a planned req
          finish_req(rc, EIO);
        } else {
          finish_req(rc, 0);
        }
        tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
      }
    }
  }

  // ---- threadpool backend ------------------------------------------------

  void worker_loop(RingCtx* rxp) {
    RingCtx& rx = *rxp;
    for (;;) {
      ReqCtx* rc;
      {
        std::unique_lock<std::mutex> lk(rx.q_m);
        rx.q_cv.wait(lk, [this, &rx] { return stopping.load() || !rx.q.empty(); });
        if (rx.q.empty()) return;  // stopping
        rc = rx.q.front();
        rx.q.pop_front();
      }
      int err = 0;
      while (rc->remaining > 0) {
        ssize_t n = rc->write
                        ? pwrite(rc->fd, rc->dest, rc->remaining, rc->file_off)
                        : pread(rc->fd, rc->dest, rc->remaining, rc->file_off);
        if (n < 0) {
          if (errno == EINTR) continue;
          err = errno;
          break;
        }
        if (n == 0) {
          err = EIO;
          break;
        }
        rc->dest += n;
        rc->file_off += n;
        rc->remaining -= n;
        if (rc->remaining)
          ctr[NSTPU_CTR_NR_RESUBMIT].fetch_add(1, std::memory_order_relaxed);
      }
      finish_req(rc, err);
    }
  }

  // Submit n queued SQEs with as few io_uring_enter syscalls as possible
  // (ideally ONE — the batched-submission discipline the reference gets
  // for free from blk_execute_rq_nowait queueing, VERDICT r2 #4).  Retries
  // transient failures; returns how many SQEs the kernel consumed and
  // rolls back the unconsumed tail (the kernel never saw those, so their
  // ReqCtxs are safe to free).  Caller holds rx.sq_m.
  unsigned enter_batch_locked(RingCtx& rx, unsigned n) {
    unsigned done = 0;
    for (int tries = 0; tries < 1000 && done < n; tries++) {
      int rcsub = sys_io_uring_enter(rx.ring.fd, n - done, 0, 0);
      ctr[NSTPU_CTR_NR_ENTER_DMA].fetch_add(1, std::memory_order_relaxed);
      if (rcsub > 0) {
        done += (unsigned)rcsub;
        continue;
      }
      if (rcsub < 0 && errno != EINTR && errno != EAGAIN && errno != EBUSY)
        break;
      sched_yield();
    }
    if (done < n)
      __atomic_store_n(rx.ring.sq_tail, *rx.ring.sq_tail - (n - done),
                       __ATOMIC_RELEASE);
    return done;
  }

  // ---- submit ------------------------------------------------------------

  // flush one ring's collected batch: queue every SQE under the ring's
  // submit lock, then ONE io_uring_enter for the lot — syscalls/request
  // ~ 1/batch instead of 1 (VERDICT r2 #4; the reference's per-request
  // blk_execute_rq_nowait had no syscall to amortize, this path does)
  void flush_ring_batch(Task* t, std::vector<ReqCtx*>& batch, RingCtx& rx) {
    if (batch.empty()) return;
    size_t queued = 0;
    unsigned entered = 0;
    {
      std::lock_guard<std::mutex> lk(rx.sq_m);
      for (auto* rc : batch) {
        if (!queue_sqe_locked(rx, rc)) break;  // SQ full: fail the rest
        queued++;
      }
      entered = enter_batch_locked(rx, (unsigned)queued);
    }
    // [entered, queued) were queued + rolled back; [queued, size) were
    // never queued.  In both cases the kernel never saw the SQE, so the
    // ReqCtx is ours to free.
    int enter_err = errno ? errno : EIO;
    for (size_t i = entered; i < batch.size(); i++) {
      task_put(t, i < queued ? enter_err : EBUSY);
      drop_inflight_slot(batch[i]);
      delete batch[i];
    }
    batch.clear();
  }

  int64_t submit(void* dest_base, const nstpu_req* reqs, int32_t nreq) {
    if (stopping.load()) return -ESHUTDOWN;
    if (nreq <= 0 || !reqs) return -EINVAL;
    // NSTPU_REQ_PASSTHRU contract check up front — the whole submit is
    // refused before any task exists, so a planner bug never half-runs:
    // flagged requests are read-only, need the passthru backend active,
    // and file_off/len must be LBA multiples (the command encodes whole
    // blocks; a misaligned span would silently read the wrong bytes)
    for (int32_t i = 0; i < nreq; i++) {
      if (!(reqs[i].flags & NSTPU_REQ_PASSTHRU)) continue;
      if (backend != NSTPU_BACKEND_NVME_PASSTHRU) return -EINVAL;
      uint64_t lba_mask = ((uint64_t)1 << pt.lba_shift) - 1;
      if ((reqs[i].flags & NSTPU_REQ_WRITE) || reqs[i].len == 0 ||
          (reqs[i].file_off & lba_mask) || (reqs[i].len & lba_mask))
        return -EINVAL;
    }
    Task* t = create_task();
    uint64_t t0 = now_ns();
    bool uring = ring_backend();
    // per-ring SQE batches, flushed on window pressure and at the end
    std::vector<std::vector<ReqCtx*>> batches(uring ? rings.size() : 0);
    auto flush_all = [&] {
      for (size_t ri = 0; ri < batches.size(); ri++)
        flush_ring_batch(t, batches[ri], *rings[ri]);
    };
    for (int32_t i = 0; i < nreq; i++) {
      bool is_write = (reqs[i].flags & NSTPU_REQ_WRITE) != 0;
      unsigned member = (reqs[i].flags >> NSTPU_REQ_MEMBER_SHIFT) & 0xFF;
      if (member >= NSTPU_MAX_MEMBERS) member = NSTPU_MAX_MEMBERS - 1;
      auto* rc = new ReqCtx{t,
                            reqs[i].fd,
                            reqs[i].file_off,
                            reqs[i].len,
                            (char*)dest_base + reqs[i].dest_off,
                            is_write,
                            (uint8_t)member,
                            reqs[i].len,
                            now_ns()};
      rc->passthru = (reqs[i].flags & NSTPU_REQ_PASSTHRU) != 0;
      task_get(t);
      bool shut = false;
      {
        // member -> lane: each stripe member submits/completes on its own
        // queue, like the reference's per-device blk-mq HW queues; both
        // backends carry the window on the lane, so a slow member only
        // throttles submissions bound for itself
        rc->ring_idx = (uint8_t)(member % rings.size());
        RingCtx& rx = *rings[rc->ring_idx];
        std::unique_lock<std::mutex> lk(rx.win_m);
        if (rx.win_inflight >= depth) {
          ctr[NSTPU_CTR_NR_SQ_FULL].fetch_add(1, std::memory_order_relaxed);
          if (uring) {
            // the window can only drain if our queued-but-unentered SQEs
            // reach the kernel: flush before sleeping
            lk.unlock();
            flush_all();
            lk.lock();
          }
        }
        rx.win_cv.wait(lk, [this, &rx] {
          return rx.win_inflight < depth || stopping.load();
        });
        if (stopping.load())
          shut = true;
        else
          rx.win_inflight++;
      }
      if (shut) {
        task_put(t, ESHUTDOWN);
        delete rc;
        // abort, don't flush: a concurrent shutdown() may already have
        // munmapped the rings, and nothing would reap SQEs entered after
        // the reapers joined.  Batched rcs were never queued to any SQ,
        // so failing them touches only RingCtx state (which outlives
        // shutdown), never ring memory.
        for (auto& b : batches) {
          for (auto* brc : b) {
            task_put(t, ESHUTDOWN);
            drop_inflight_slot(brc);
            delete brc;
          }
          b.clear();
        }
        break;  // epilogue's flush_all sees only empty batches
      }
      uint64_t cur =
          ctr[NSTPU_CTR_CUR_DMA_COUNT].fetch_add(1, std::memory_order_relaxed)
          + 1;
      atomic_max(ctr[NSTPU_CTR_MAX_DMA_COUNT], cur);
      occ_note(+1, (int)member);
      ctr[NSTPU_CTR_TOTAL_DMA_LENGTH].fetch_add(reqs[i].len,
                                                std::memory_order_relaxed);
      ctr[NSTPU_CTR_NR_SUBMIT_DMA].fetch_add(1, std::memory_order_relaxed);
      if (is_write) {
        ctr[NSTPU_CTR_NR_WRITE_DMA].fetch_add(1, std::memory_order_relaxed);
        ctr[NSTPU_CTR_TOTAL_WRITE_LENGTH].fetch_add(
            reqs[i].len, std::memory_order_relaxed);
      }
      if (rc->passthru)
        ctr[NSTPU_CTR_NR_PASSTHRU_DMA].fetch_add(1, std::memory_order_relaxed);
      if (uring) {
        resolve_fixed(rc);
        batches[rc->ring_idx].push_back(rc);
        // never collect more than the SQ can hold in one flush
        if (batches[rc->ring_idx].size() >= depth)
          flush_ring_batch(t, batches[rc->ring_idx], *rings[rc->ring_idx]);
      } else {
        RingCtx& rx = *rings[rc->ring_idx];
        {
          std::lock_guard<std::mutex> lk(rx.q_m);
          rx.q.push_back(rc);
        }
        rx.q_cv.notify_one();
      }
    }
    if (uring) flush_all();
    ctr[NSTPU_CTR_CLK_SUBMIT_DMA].fetch_add(now_ns() - t0,
                                            std::memory_order_relaxed);
    // freeze + drop creator ref
    {
      Slot& s = slot_of(t->id);
      std::lock_guard<std::mutex> lk(s.m);
      t->frozen = true;
    }
    int64_t id = t->id;
    task_put(t, 0);
    return id;
  }

  // ---- wait / reap -------------------------------------------------------

  int wait(int64_t task_id, int64_t timeout_ms) {
    uint64_t t0 = now_ns();
    Slot& s = slot_of(task_id);
    std::unique_lock<std::mutex> lk(s.m);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
    for (;;) {
      auto it = s.tasks.find(task_id);
      if (it == s.tasks.end()) return -ENOENT;
      Task* t = it->second;
      if (t->state != 0) {
        int err = t->err;
        s.tasks.erase(it);  // reap
        delete t;
        ctr[NSTPU_CTR_NR_WAIT_DTASK].fetch_add(1, std::memory_order_relaxed);
        ctr[NSTPU_CTR_CLK_WAIT_DTASK].fetch_add(now_ns() - t0,
                                                std::memory_order_relaxed);
        return err ? -err : 0;
      }
      if (timeout_ms < 0) {
        s.cv.wait(lk);
      } else if (s.cv.wait_until(lk, deadline) == std::cv_status::timeout) {
        return -ETIMEDOUT;
      }
      // woken but maybe for a different task in this slot
      auto it2 = s.tasks.find(task_id);
      if (it2 != s.tasks.end() && it2->second->state == 0)
        ctr[NSTPU_CTR_NR_WRONG_WAKEUP].fetch_add(1, std::memory_order_relaxed);
    }
  }

  int pending(int64_t* out, int32_t cap) {
    int n = 0;
    for (auto& s : slots) {
      std::lock_guard<std::mutex> lk(s.m);
      for (auto& kv : s.tasks) {
        if (n < cap) out[n] = kv.first;
        n++;
      }
    }
    return n < cap ? n : cap;
  }

  int reap(int64_t* failed_out, int32_t cap, int64_t timeout_ms) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms < 0 ? 3600000 : timeout_ms);
    int nfailed = 0;
    for (auto& s : slots) {
      std::unique_lock<std::mutex> lk(s.m);
      for (;;) {
        bool running = false;
        for (auto& kv : s.tasks)
          if (kv.second->state == 0) running = true;
        if (!running) break;
        if (s.cv.wait_until(lk, deadline) == std::cv_status::timeout) break;
      }
      for (auto it = s.tasks.begin(); it != s.tasks.end();) {
        Task* t = it->second;
        if (t->state == 0) {
          ++it;  // still running past timeout: leave it (caller may retry)
          continue;
        }
        if (t->state == 2 && nfailed < cap && failed_out)
          failed_out[nfailed] = t->id;
        if (t->state == 2) nfailed++;
        delete t;
        it = s.tasks.erase(it);
      }
    }
    return nfailed < cap ? nfailed : (cap > 0 ? cap : 0);
  }

  // pin one lane's service threads (reaper + workers) to a CPU set — the
  // NUMA lever: completion reaping and the landing memcpy stay on the
  // member device's local node (pgsql NUMA pool analog, :1454-1526)
  int lane_pin(int32_t lane, const int32_t* cpus, int32_t ncpus) {
    if (stopping.load()) return -ESHUTDOWN;
    if (lane < 0 || (size_t)lane >= rings.size() || !cpus || ncpus <= 0)
      return -EINVAL;
    cpu_set_t set;
    CPU_ZERO(&set);
    for (int32_t i = 0; i < ncpus; i++)
      if (cpus[i] >= 0 && cpus[i] < CPU_SETSIZE) CPU_SET(cpus[i], &set);
    if (CPU_COUNT(&set) == 0) return -EINVAL;
    RingCtx& rx = *rings[lane];
    int rc = 0;
    if (rx.reaper.joinable())
      rc = pthread_setaffinity_np(rx.reaper.native_handle(), sizeof set, &set);
    for (auto& w : rx.workers)
      if (w.joinable()) {
        int r = pthread_setaffinity_np(w.native_handle(), sizeof set, &set);
        if (r) rc = r;
      }
    return rc ? -rc : 0;
  }

  int stats(uint64_t* out, int32_t cap) {
    // bring the occupancy integral current: it only advances on in-flight
    // transitions, so a long steady interval would otherwise undercount
    occ_note(0);
    int n = std::min<int32_t>(cap, NSTPU_CTR__COUNT);
    for (int i = 0; i < n; i++) out[i] = ctr[i].load(std::memory_order_relaxed);
    // read-and-reset max to current (kmod/nvme_strom.c:2087)
    ctr[NSTPU_CTR_MAX_DMA_COUNT].store(
        ctr[NSTPU_CTR_CUR_DMA_COUNT].load(std::memory_order_relaxed));
    return n;
  }

  // ---- registered (fixed) buffers ----------------------------------------

  int buf_update_slot(RingCtx& rx, unsigned slot, void* base, uint64_t len) {
    struct iovec iov;
    iov.iov_base = base;
    iov.iov_len = (size_t)len;
    struct io_uring_rsrc_update2 up;
    memset(&up, 0, sizeof up);
    up.offset = slot;
    up.data = (uint64_t)&iov;
    up.nr = 1;
    int rc = sys_io_uring_register(rx.ring.fd, IORING_REGISTER_BUFFERS_UPDATE,
                                   &up, sizeof up);
    return rc < 0 ? -errno : 0;
  }

  int buf_register(void* base, uint64_t len) {
    if (!ring_backend() || !fixed_ok) return -ENOSYS;
    if (!base || !len) return -EINVAL;
    std::lock_guard<std::mutex> lk(fixed_m);
    int slot = -1;
    for (unsigned i = 0; i < kFixedSlots; i++)
      if (fixed[i].len == 0) {
        slot = (int)i;
        break;
      }
    if (slot < 0) return -ENOSPC;
    // every ring needs the registration (fixed tables are per-ring-fd);
    // all-or-nothing so a fixed_idx is valid on whichever ring the
    // request lands on
    for (size_t ri = 0; ri < rings.size(); ri++) {
      int rc = buf_update_slot(*rings[ri], (unsigned)slot, base, len);
      if (rc < 0) {
        for (size_t rj = 0; rj < ri; rj++)
          buf_update_slot(*rings[rj], (unsigned)slot, nullptr, 0);
        return rc;
      }
    }
    fixed[slot] = {(char*)base, len};
    return slot;
  }

  int buf_unregister(int32_t slot) {
    if (!ring_backend() || !fixed_ok) return -ENOSYS;
    if (slot < 0 || slot >= (int32_t)kFixedSlots) return -EINVAL;
    std::lock_guard<std::mutex> lk(fixed_m);
    if (fixed[slot].len == 0) return -ENOENT;
    // clear the kernel slot on every ring (empty iovec = sparse again);
    // in-flight fixed ops hold their own rsrc refs, so this never yanks
    // pages mid-I/O.  Either way the table entry is freed: a later
    // register overwrites the kernel slots via the same update path.
    int rc = 0;
    for (auto* rx : rings) {
      int r = buf_update_slot(*rx, (unsigned)slot, nullptr, 0);
      if (r < 0) rc = r;
    }
    fixed[slot] = {nullptr, 0};
    return rc;
  }
};

// ---------------------------------------------------------------------------
// handle registry
// ---------------------------------------------------------------------------

std::mutex g_m;
std::unordered_map<uint64_t, Engine*> g_engines;
uint64_t g_next = 1;

Engine* lookup(uint64_t h) {
  std::lock_guard<std::mutex> lk(g_m);
  auto it = g_engines.find(h);
  return it == g_engines.end() ? nullptr : it->second;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

int nstpu_engine_version(void) { return NSTPU_API_VERSION; }

const char* nstpu_signature(void) {
  // the /proc/nvme-strom version-read analog (kmod/nvme_strom.c:2111-2136):
  // a static build signature userspace can surface without creating an engine
#ifndef NSTPU_BUILD_TS
#define NSTPU_BUILD_TS __DATE__ " " __TIME__
#endif
  return "strom_tpu native engine api " /* api version stringized below */
         "v4, built " NSTPU_BUILD_TS
#ifdef __clang__
         ", clang"
#elif defined(__GNUC__)
         ", gcc"
#endif
      ;
}

uint64_t nstpu_engine_create3(int backend, int queue_depth, int nrings,
                              const char* passthru_dev) {
  auto* e = new Engine();
  if (nrings > 0) e->nrings_want = std::min(nrings, 16);
  if (passthru_dev && *passthru_dev) e->pt_dev = passthru_dev;
  if (!e->init(backend, queue_depth)) {
    delete e;
    return 0;
  }
  std::lock_guard<std::mutex> lk(g_m);
  uint64_t h = g_next++;
  g_engines[h] = e;
  return h;
}

uint64_t nstpu_engine_create2(int backend, int queue_depth, int nrings) {
  return nstpu_engine_create3(backend, queue_depth, nrings, nullptr);
}

uint64_t nstpu_engine_create(int backend, int queue_depth) {
  return nstpu_engine_create2(backend, queue_depth, 0);
}

int nstpu_passthru_probe(const char* dev_path) {
  // standalone capability probe (strom_check's blockmap/passthru row):
  // same ladder as engine create, no engine state left behind
  return Engine::passthru_probe_dev(dev_path, nullptr);
}

int nstpu_engine_passthru_reason(uint64_t engine) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->backend == NSTPU_BACKEND_NVME_PASSTHRU ? 0 : e->passthru_reason;
}

void nstpu_engine_destroy(uint64_t engine) {
  Engine* e;
  {
    std::lock_guard<std::mutex> lk(g_m);
    auto it = g_engines.find(engine);
    if (it == g_engines.end()) return;
    e = it->second;
    g_engines.erase(it);
  }
  e->reap(nullptr, 0, 30000);
  delete e;
}

int nstpu_engine_backend(uint64_t engine) {
  Engine* e = lookup(engine);
  return e ? e->backend : -ENOENT;
}

int64_t nstpu_submit(uint64_t engine, void* dest_base, const nstpu_req* reqs,
                     int32_t nreq) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->submit(dest_base, reqs, nreq);
}

int nstpu_wait(uint64_t engine, int64_t task_id, int64_t timeout_ms) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->wait(task_id, timeout_ms);
}

int nstpu_pending(uint64_t engine, int64_t* out, int32_t cap) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->pending(out, cap);
}

int nstpu_engine_reap(uint64_t engine, int64_t* failed_out, int32_t cap,
                      int64_t timeout_ms) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->reap(failed_out, cap, timeout_ms);
}

int nstpu_engine_stats(uint64_t engine, uint64_t* out, int32_t cap) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->stats(out, cap);
}

int nstpu_buf_register(uint64_t engine, void* base, uint64_t len) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->buf_register(base, len);
}

int nstpu_buf_unregister(uint64_t engine, int32_t slot) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->buf_unregister(slot);
}

int nstpu_engine_lat_hist(uint64_t engine, uint64_t* out, int32_t cap) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  if (!out || cap < 0) return -EINVAL;
  int n = cap < NSTPU_LAT_BUCKETS ? cap : NSTPU_LAT_BUCKETS;
  for (int i = 0; i < n; i++)
    out[i] = e->lat_hist_[i].load(std::memory_order_relaxed);
  return n;
}

int nstpu_engine_member_stats(uint64_t engine, int32_t member,
                              uint64_t* out3) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  if (member < 0 || member >= NSTPU_MAX_MEMBERS || !out3) return -EINVAL;
  for (int i = 0; i < 3; i++)
    out3[i] = e->member_ctr[member][i].load(std::memory_order_relaxed);
  return 0;
}

int nstpu_engine_nlanes(uint64_t engine) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return (int)e->rings.size();
}

int nstpu_engine_lane_pin(uint64_t engine, int32_t lane, const int32_t* cpus,
                          int32_t ncpus) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->lane_pin(lane, cpus, ncpus);
}

int nstpu_engine_member_lat_hist(uint64_t engine, int32_t member,
                                 uint64_t* out, int32_t cap) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  if (member < 0 || member >= NSTPU_MAX_MEMBERS || !out || cap < 0)
    return -EINVAL;
  int n = cap < NSTPU_LAT_BUCKETS ? cap : NSTPU_LAT_BUCKETS;
  for (int i = 0; i < n; i++)
    out[i] = e->member_hist_[member][i].load(std::memory_order_relaxed);
  return n;
}

int nstpu_engine_member_occ(uint64_t engine, int32_t member, uint64_t* out2) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->member_occ(member, out2);
}

int nstpu_engine_trace(uint64_t engine, int enable) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->trace_set(enable);
}

int nstpu_engine_trace_drain(uint64_t engine, nstpu_trace_event* out,
                             int32_t cap) {
  Engine* e = lookup(engine);
  if (!e) return -ENOENT;
  return e->trace_drain(out, cap);
}

}  // extern "C"
