// Async file I/O library for the NVMe offload tier (ZeRO-Infinity).
//
// The port's copy of deepspeed_tpu/ops/csrc/aio.cpp (the counterpart of the
// reference's csrc/aio/, libaio-backed deepspeed_aio_thread.cpp /
// deepspeed_py_aio_handle.cpp).  Two engines behind one C ABI:
//
//  1. io_uring (preferred): raw-syscall ring (no liburing dependency) —
//     kernel-level async submission/completion like the reference's libaio,
//     with queue-depth parallelism and no per-op thread handoff.
//  2. worker-thread pool fallback (when io_uring_setup is unavailable —
//     seccomp'd containers, old kernels): POSIX pread/pwrite per worker.
//
// The Python-facing handle API (submit async read/write, wait for
// completions) mirrors the reference aio_handle; short transfers complete
// synchronously for the remainder so partial reads/writes never succeed
// silently.  No TPU kernel corresponds to it; it is bound by the storage
// device's bandwidth.
//
// C ABI for ctypes binding.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#if defined(__linux__) && __has_include(<linux/io_uring.h>)
#define DS_HAVE_URING 1
#include <linux/io_uring.h>
#else
#define DS_HAVE_URING 0
#endif

namespace {

struct Request {
  std::string path;
  void* buf;
  int64_t nbytes;
  int64_t offset;
  bool write;
};

// ---------------------------------------------------------------- interface
struct Engine {
  virtual ~Engine() = default;
  virtual void submit(Request req) = 0;
  virtual int64_t wait() = 0;  // drain; returns #failures since last wait
};

// ------------------------------------------------------------- thread pool
struct ThreadEngine : Engine {
  std::vector<std::thread> workers;
  std::queue<Request> queue;
  std::mutex mu;
  std::condition_variable cv_submit;
  std::condition_variable cv_done;
  int64_t pending = 0;
  int64_t errors = 0;
  bool shutdown = false;

  explicit ThreadEngine(int num_threads) {
    for (int i = 0; i < num_threads; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  ~ThreadEngine() override {
    {
      std::lock_guard<std::mutex> lock(mu);
      shutdown = true;
    }
    cv_submit.notify_all();
    for (auto& t : workers) t.join();
  }

  void submit(Request req) override {
    {
      std::lock_guard<std::mutex> lock(mu);
      queue.push(std::move(req));
      ++pending;
    }
    cv_submit.notify_one();
  }

  int64_t wait() override {
    std::unique_lock<std::mutex> lock(mu);
    cv_done.wait(lock, [this] { return pending == 0; });
    int64_t e = errors;
    errors = 0;
    return e;
  }

  void run() {
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_submit.wait(lock, [this] { return shutdown || !queue.empty(); });
        if (queue.empty()) {
          if (shutdown) return;
          continue;
        }
        req = std::move(queue.front());
        queue.pop();
      }
      bool ok = execute(req);
      {
        std::lock_guard<std::mutex> lock(mu);
        if (!ok) ++errors;
        if (--pending == 0) cv_done.notify_all();
      }
    }
  }

  static bool execute(const Request& req) {
    int flags = req.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    int fd = ::open(req.path.c_str(), flags, 0644);
    if (fd < 0) return false;
    bool ok = transfer(fd, req.write, req.buf, req.nbytes, req.offset);
    ::close(fd);
    return ok;
  }

  // Synchronous pread/pwrite loop; also finishes io_uring short transfers.
  static bool transfer(int fd, bool write, void* buf, int64_t nbytes,
                       int64_t offset) {
    char* p = static_cast<char*>(buf);
    int64_t left = nbytes;
    int64_t off = offset;
    while (left > 0) {
      ssize_t n = write ? ::pwrite(fd, p, left, off)
                        : ::pread(fd, p, left, off);
      if (n <= 0) return false;
      p += n;
      off += n;
      left -= n;
    }
    return true;
  }
};

#if DS_HAVE_URING
// ---------------------------------------------------------------- io_uring
// Raw-syscall ring (the image ships linux/io_uring.h but not liburing).
// Opcode numbers are spelled out (stable kernel ABI) so this compiles
// against pre-5.6 headers whose enum lacks IORING_OP_READ/WRITE; whether
// the RUNNING kernel supports them is probed at init with a trial read,
// falling back to the thread engine otherwise.
constexpr uint8_t kOpRead = 22;   // IORING_OP_READ  (kernel >= 5.6)
constexpr uint8_t kOpWrite = 23;  // IORING_OP_WRITE (kernel >= 5.6)

struct UringEngine : Engine {
  static constexpr unsigned kEntries = 256;

  int ring_fd = -1;
  io_uring_params params{};
  // SQ ring
  void* sq_ptr = nullptr;
  size_t sq_len = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  io_uring_sqe* sqes = nullptr;
  size_t sqes_len = 0;
  // CQ ring
  void* cq_ptr = nullptr;
  size_t cq_len = 0;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  io_uring_cqe* cqes = nullptr;

  struct Inflight {
    int fd;
    Request req;
    bool used = false;
  };
  std::vector<Inflight> table;
  std::mutex mu;
  unsigned inflight = 0;
  unsigned unsubmitted = 0;  // queued SQEs the kernel has not consumed yet
  int64_t errors = 0;

  static UringEngine* create(int /*unused*/) {
    auto* e = new UringEngine();
    if (!e->init() || !e->probe_ops()) {
      delete e;
      return nullptr;
    }
    return e;
  }

  // io_uring_setup succeeding (5.1+) does not imply IORING_OP_READ support
  // (5.6+): trial-read /dev/zero and require success before committing.
  // enqueue_locked takes ownership of the fd (complete() closes it).
  bool probe_ops() {
    int fd = ::open("/dev/zero", O_RDONLY);
    if (fd < 0) return false;
    char byte = 0;
    std::lock_guard<std::mutex> lock(mu);
    if (!enqueue_locked(fd, Request{"", &byte, 1, 0, false})) {
      ::close(fd);
      return false;
    }
    while (inflight > 0) reap_locked(inflight);
    bool ok = errors == 0;
    errors = 0;
    return ok;
  }

  bool init() {
    std::memset(&params, 0, sizeof(params));
    ring_fd = static_cast<int>(
        ::syscall(__NR_io_uring_setup, kEntries, &params));
    if (ring_fd < 0) return false;

    sq_len = params.sq_off.array + params.sq_entries * sizeof(unsigned);
    cq_len = params.cq_off.cqes + params.cq_entries * sizeof(io_uring_cqe);
    if (params.features & IORING_FEAT_SINGLE_MMAP) {
      sq_len = cq_len = std::max(sq_len, cq_len);
    }
    sq_ptr = ::mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
    if (sq_ptr == MAP_FAILED) return false;
    cq_ptr = (params.features & IORING_FEAT_SINGLE_MMAP)
                 ? sq_ptr
                 : ::mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                          MAP_SHARED | MAP_POPULATE, ring_fd,
                          IORING_OFF_CQ_RING);
    if (cq_ptr == MAP_FAILED) return false;

    auto* sqb = static_cast<char*>(sq_ptr);
    sq_head = reinterpret_cast<unsigned*>(sqb + params.sq_off.head);
    sq_tail = reinterpret_cast<unsigned*>(sqb + params.sq_off.tail);
    sq_mask = reinterpret_cast<unsigned*>(sqb + params.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned*>(sqb + params.sq_off.array);

    sqes_len = params.sq_entries * sizeof(io_uring_sqe);
    sqes = static_cast<io_uring_sqe*>(
        ::mmap(nullptr, sqes_len, PROT_READ | PROT_WRITE,
               MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQES));
    if (sqes == MAP_FAILED) return false;

    auto* cqb = static_cast<char*>(cq_ptr);
    cq_head = reinterpret_cast<unsigned*>(cqb + params.cq_off.head);
    cq_tail = reinterpret_cast<unsigned*>(cqb + params.cq_off.tail);
    cq_mask = reinterpret_cast<unsigned*>(cqb + params.cq_off.ring_mask);
    cqes = reinterpret_cast<io_uring_cqe*>(cqb + params.cq_off.cqes);

    table.resize(params.cq_entries);
    return true;
  }

  ~UringEngine() override {
    if (sqes && sqes != MAP_FAILED) ::munmap(sqes, sqes_len);
    if (cq_ptr && cq_ptr != sq_ptr && cq_ptr != MAP_FAILED)
      ::munmap(cq_ptr, cq_len);
    if (sq_ptr && sq_ptr != MAP_FAILED) ::munmap(sq_ptr, sq_len);
    if (ring_fd >= 0) ::close(ring_fd);
  }

  void submit(Request req) override {
    std::lock_guard<std::mutex> lock(mu);
    if (req.nbytes > INT32_MAX) {
      // SQE len is 32-bit; oversized requests complete synchronously
      if (!ThreadEngine::execute(req)) ++errors;
      return;
    }
    int flags = req.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    int fd = ::open(req.path.c_str(), flags, 0644);
    if (fd < 0) {
      ++errors;
      return;
    }
    Request fallback = req;  // enqueue_locked moves from req
    if (!enqueue_locked(fd, std::move(req))) {
      bool ok = ThreadEngine::transfer(fd, fallback.write, fallback.buf,
                                       fallback.nbytes, fallback.offset);
      if (!ok) ++errors;
      ::close(fd);
    }
  }

  // Queue one op on the ring; owns ``fd`` from here on (closed by
  // complete()).  Returns false only if no slot could be obtained.
  bool enqueue_locked(int fd, Request req) {
    // free table slot + SQ room (reap if the ring is saturated)
    int slot = -1;
    for (;;) {
      for (size_t i = 0; i < table.size(); ++i) {
        if (!table[i].used) {
          slot = static_cast<int>(i);
          break;
        }
      }
      unsigned head = __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
      unsigned t = __atomic_load_n(sq_tail, __ATOMIC_RELAXED);
      if (slot >= 0 && t - head < params.sq_entries) break;
      if (inflight == 0) return false;  // saturated with nothing to reap
      slot = -1;
      reap_locked(1);
    }
    table[slot].fd = fd;
    table[slot].req = std::move(req);
    table[slot].used = true;

    unsigned tail = __atomic_load_n(sq_tail, __ATOMIC_ACQUIRE);
    unsigned idx = tail & *sq_mask;
    io_uring_sqe* sqe = &sqes[idx];
    std::memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = table[slot].req.write ? kOpWrite : kOpRead;
    sqe->fd = fd;
    sqe->addr = reinterpret_cast<uint64_t>(table[slot].req.buf);
    sqe->len = static_cast<unsigned>(table[slot].req.nbytes);
    sqe->off = static_cast<uint64_t>(table[slot].req.offset);
    sqe->user_data = static_cast<uint64_t>(slot);
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
    ++inflight;
    ++unsubmitted;
    long n = ::syscall(__NR_io_uring_enter, ring_fd, unsubmitted, 0, 0,
                       nullptr, 0);
    if (n > 0) unsubmitted -= static_cast<unsigned>(n);
    // on transient enter failure the SQE stays queued; the next enter
    // (submit or reap) passes the updated unsubmitted count
    return true;
  }

  // Process one CQE; resubmission-free: finish short transfers with
  // synchronous pread/pwrite of the remainder (matches the thread engine
  // and keeps failure semantics identical).
  void complete(const io_uring_cqe& cqe) {
    auto slot = static_cast<size_t>(cqe.user_data);
    Inflight& fl = table[slot];
    const Request& r = fl.req;
    bool ok = cqe.res >= 0;
    int64_t done = ok ? cqe.res : 0;
    if (ok && done < r.nbytes) {
      ok = ThreadEngine::transfer(fl.fd, r.write,
                                  static_cast<char*>(r.buf) + done,
                                  r.nbytes - done, r.offset + done);
    }
    if (!ok) ++errors;
    ::close(fl.fd);
    fl.used = false;
    --inflight;
  }

  void reap_locked(unsigned min_complete) {
    if (inflight == 0) return;
    if (min_complete > inflight) min_complete = inflight;
    long n = ::syscall(__NR_io_uring_enter, ring_fd, unsubmitted, min_complete,
                       IORING_ENTER_GETEVENTS, nullptr, 0);
    if (n > 0) unsubmitted -= static_cast<unsigned>(n);
    unsigned head = __atomic_load_n(cq_head, __ATOMIC_ACQUIRE);
    unsigned tail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
    while (head != tail) {
      complete(cqes[head & *cq_mask]);
      ++head;
    }
    __atomic_store_n(cq_head, head, __ATOMIC_RELEASE);
  }

  int64_t wait() override {
    std::lock_guard<std::mutex> lock(mu);
    while (inflight > 0) reap_locked(inflight);
    int64_t e = errors;
    errors = 0;
    return e;
  }
};
#endif  // DS_HAVE_URING

struct Handle {
  Engine* engine;
  bool uring;
};

}  // namespace

extern "C" {

void* ds_aio_handle_new(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  auto* h = new Handle{nullptr, false};
#if DS_HAVE_URING
  if (auto* u = UringEngine::create(num_threads)) {
    h->engine = u;
    h->uring = true;
    return h;
  }
#endif
  h->engine = new ThreadEngine(num_threads);
  return h;
}

void ds_aio_handle_free(void* h) {
  auto* handle = static_cast<Handle*>(h);
  delete handle->engine;
  delete handle;
}

// 1 = io_uring, 0 = worker-thread fallback
int ds_aio_backend(void* h) { return static_cast<Handle*>(h)->uring ? 1 : 0; }

void ds_aio_pread(void* h, const char* path, void* buf, int64_t nbytes,
                  int64_t offset) {
  static_cast<Handle*>(h)->engine->submit({path, buf, nbytes, offset, false});
}

void ds_aio_pwrite(void* h, const char* path, const void* buf, int64_t nbytes,
                   int64_t offset) {
  static_cast<Handle*>(h)->engine->submit(
      {path, const_cast<void*>(buf), nbytes, offset, true});
}

int64_t ds_aio_wait(void* h) { return static_cast<Handle*>(h)->engine->wait(); }

}  // extern "C"
