// Asynchronous file I/O for the NVMe swap tier (ZeRO-Infinity equivalent): a copy of the
// JAX package's deepspeed_tpu/ops/csrc/aio/deepspeed_aio.cpp, with the same C entry points.
//
// Behavioural equivalent of reference csrc/aio/py_lib/deepspeed_py_aio_handle.cpp
// (deepspeed_aio_handle_t: async_pread:294 / async_pwrite, wait, thread-pool backed) and
// csrc/aio/common/deepspeed_aio_utils.cpp. The reference drives libaio/io_submit; this
// implementation uses a pthread worker pool issuing pread/pwrite — on modern kernels with
// page-cached NVMe this saturates the device for the large sequential blocks the swapper
// moves, without the libaio dependency. The queue/completion semantics match: submit
// returns immediately with a ticket, wait() blocks until the submitted batch completes.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <unistd.h>

#include <condition_variable>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Request {
  int fd;
  void* buf;
  int64_t nbytes;
  int64_t offset;
  bool write;
};

struct Handle {
  std::vector<std::thread> workers;
  std::queue<Request> pending;
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  int64_t inflight = 0;
  int64_t errors = 0;
  bool shutdown = false;
  int64_t block_size;

  explicit Handle(int n_threads, int64_t block) : block_size(block) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  ~Handle() {
    {
      std::lock_guard<std::mutex> lock(mu);
      shutdown = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }

  static bool do_io(const Request& r, int64_t block) {
    char* p = static_cast<char*>(r.buf);
    int64_t left = r.nbytes;
    int64_t off = r.offset;
    while (left > 0) {
      int64_t chunk = left < block ? left : block;
      ssize_t n = r.write ? pwrite(r.fd, p, chunk, off)
                          : pread(r.fd, p, chunk, off);
      if (n <= 0) return false;
      p += n;
      off += n;
      left -= n;
    }
    return true;
  }

  void run() {
    for (;;) {
      Request r;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [this] { return shutdown || !pending.empty(); });
        if (shutdown && pending.empty()) return;
        r = pending.front();
        pending.pop();
      }
      bool ok = do_io(r, block_size);
      {
        std::lock_guard<std::mutex> lock(mu);
        if (!ok) ++errors;
        --inflight;
      }
      cv_done.notify_all();
    }
  }

  void submit(const Request& r) {
    {
      std::lock_guard<std::mutex> lock(mu);
      pending.push(r);
      ++inflight;
    }
    cv_work.notify_one();
  }

  int64_t wait() {
    std::unique_lock<std::mutex> lock(mu);
    cv_done.wait(lock, [this] { return inflight == 0; });
    int64_t e = errors;
    errors = 0;
    return e;  // 0 = all ok
  }
};

}  // namespace

extern "C" {

void* ds_aio_handle_new(int n_threads, int64_t block_size) {
  if (n_threads < 1) n_threads = 1;
  if (block_size < 4096) block_size = 1 << 20;
  return new Handle(n_threads, block_size);
}

void ds_aio_handle_free(void* h) { delete static_cast<Handle*>(h); }

int ds_aio_open(const char* path, int for_write) {
  // O_TRUNC: an overwrite must not leave stale tail bytes from a longer old file
  int flags = for_write ? (O_WRONLY | O_CREAT | O_TRUNC) : O_RDONLY;
  return open(path, flags, 0644);
}

int ds_aio_open_direct(const char* path, int for_write) {
  // O_DIRECT bypasses the page cache (reference deepspeed_aio_common.cpp:76-116
  // opens with O_DIRECT for its io_submit path): required for NVMe swap tiers whose
  // working set exceeds RAM, where buffered IO double-copies and evicts. Caller
  // guarantees 4096-aligned buffers/offsets/lengths. Returns -1 when the
  // filesystem refuses O_DIRECT (e.g. tmpfs) — caller falls back to buffered.
  // Returns the fd, or -errno so the caller can distinguish a genuine O_DIRECT
  // refusal (EINVAL/EOPNOTSUPP) from unrelated failures (ENOENT, EACCES).
#ifdef O_DIRECT
  int flags = for_write ? (O_WRONLY | O_CREAT | O_TRUNC | O_DIRECT) : (O_RDONLY | O_DIRECT);
  int fd = open(path, flags, 0644);
  return fd >= 0 ? fd : -errno;
#else
  (void)path; (void)for_write;
  return -EINVAL;
#endif
}

void ds_aio_close(int fd) { close(fd); }

void ds_aio_pread(void* h, int fd, void* buf, int64_t nbytes, int64_t offset) {
  static_cast<Handle*>(h)->submit({fd, buf, nbytes, offset, false});
}

void ds_aio_pwrite(void* h, int fd, void* buf, int64_t nbytes, int64_t offset) {
  static_cast<Handle*>(h)->submit({fd, buf, nbytes, offset, true});
}

// Blocks until every submitted op completes; returns the number of FAILED ops.
int64_t ds_aio_wait(void* h) { return static_cast<Handle*>(h)->wait(); }

}  // extern "C"
