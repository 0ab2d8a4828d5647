// dsaring — POSIX shared-memory block ring buffer.
//
// TPU-native framework's replacement for the reference's PSRDADA
// ingest (SURVEY.md L1/C3: dada_hdu connect/lock_read of fixed-size
// voltage blocks from a shared-memory ring written by a separate
// capture process).  Same responsibilities, fresh implementation:
//
//   * one shared-memory segment = control page + header-text area +
//     nbufs fixed-size data blocks;
//   * single producer (capture), single consumer (beamformer), in
//     separate processes, lock-free via C++11 atomics on the control
//     page (release on commit, acquire on read);
//   * writer NEVER blocks: if the consumer lags nbufs behind, the new
//     block is counted in `dropped` and discarded (back-pressure with
//     loss accounting, like PSRDADA's overrun counters);
//   * reader can `read_next` (in-order) or `read_latest` (skip-ahead
//     to the newest block, counting skips — the overrun policy
//     SURVEY.md §5 prescribes for the rebuild);
//   * a text header area carries stream metadata once per observation
//     (the DADA-header analog), and an EOD flag ends the stream.
//
// Built as a small shared library; Python binds via ctypes
// (ingest/ring.py).  No external dependencies.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x445341524E471002ULL;  // "DSARNG" + version
constexpr uint64_t kCtrlBytes = 4096;

struct Ctrl {
  uint64_t magic;
  uint64_t nbufs;
  uint64_t bufsz;
  uint64_t hdrsz;
  std::atomic<uint64_t> w_head;     // seq of next block to be written
  std::atomic<uint64_t> r_tail;     // seq of next block to be read
  std::atomic<uint64_t> dropped;    // writer-side drops (consumer lagging)
  std::atomic<uint64_t> skipped;    // reader-side skip-ahead count
  std::atomic<uint64_t> eod;        // end-of-data flag
  std::atomic<uint64_t> hdr_ready;  // header text committed
  // Best-effort count of handles that have read from this ring and
  // are still open (crashed readers leak it) — advisory only, so a
  // second consumer can WARN before stealing blocks from the shared
  // SPSC r_tail cursor.
  std::atomic<uint64_t> readers;
};

static_assert(sizeof(Ctrl) <= kCtrlBytes, "control page overflow");

struct Ring {
  int fd = -1;
  uint8_t* base = nullptr;
  uint64_t map_bytes = 0;
  Ctrl* ctrl = nullptr;
  uint8_t* hdr = nullptr;
  uint8_t* data = nullptr;
  // per-handle state
  uint64_t write_open_seq = ~0ULL;
  uint64_t read_open_seq = ~0ULL;
  bool counted_reader = false;
};

uint8_t* slot_ptr(Ring* r, uint64_t seq) {
  return r->data + (seq % r->ctrl->nbufs) * r->ctrl->bufsz;
}

void shm_name(const char* name, char* out, size_t cap) {
  snprintf(out, cap, "/dsaring-%s", name);
}

}  // namespace

extern "C" {

Ring* dsaring_create(const char* name, uint64_t nbufs, uint64_t bufsz,
                     uint64_t hdrsz) {
  if (nbufs == 0 || bufsz == 0) return nullptr;
  char path[256];
  shm_name(name, path, sizeof(path));
  shm_unlink(path);  // fresh segment
  int fd = shm_open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = kCtrlBytes + hdrsz + nbufs * bufsz;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(path);
    return nullptr;
  }
  // Reserve the pages up front: tmpfs ftruncate is sparse, so an
  // over-committed ring would otherwise be created "successfully" and
  // SIGBUS the producer when shared memory fills mid-observation.
  // posix_fallocate returns ENOSPC here instead.
  if (posix_fallocate(fd, 0, (off_t)total) != 0) {
    close(fd);
    shm_unlink(path);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(path);
    return nullptr;
  }
  Ring* r = new Ring();
  r->fd = fd;
  r->base = (uint8_t*)base;
  r->map_bytes = total;
  r->ctrl = (Ctrl*)base;
  r->hdr = r->base + kCtrlBytes;
  r->data = r->hdr + hdrsz;
  memset(r->ctrl, 0, sizeof(Ctrl));
  r->ctrl->nbufs = nbufs;
  r->ctrl->bufsz = bufsz;
  r->ctrl->hdrsz = hdrsz;
  std::atomic_thread_fence(std::memory_order_release);
  r->ctrl->magic = kMagic;  // publish last
  return r;
}

Ring* dsaring_connect(const char* name) {
  char path[256];
  shm_name(name, path, sizeof(path));
  int fd = shm_open(path, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < kCtrlBytes) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Ring* r = new Ring();
  r->fd = fd;
  r->base = (uint8_t*)base;
  r->map_bytes = (uint64_t)st.st_size;
  r->ctrl = (Ctrl*)base;
  if (r->ctrl->magic != kMagic) {
    munmap(base, (size_t)st.st_size);
    close(fd);
    delete r;
    return nullptr;
  }
  r->hdr = r->base + kCtrlBytes;
  r->data = r->hdr + r->ctrl->hdrsz;
  return r;
}

void dsaring_close(Ring* r) {
  if (!r) return;
  if (r->counted_reader && r->ctrl)
    r->ctrl->readers.fetch_sub(1, std::memory_order_relaxed);
  if (r->base) munmap(r->base, r->map_bytes);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

int dsaring_destroy(const char* name) {
  char path[256];
  shm_name(name, path, sizeof(path));
  return shm_unlink(path);
}

uint64_t dsaring_nbufs(Ring* r) { return r->ctrl->nbufs; }
uint64_t dsaring_bufsz(Ring* r) { return r->ctrl->bufsz; }
uint64_t dsaring_hdrsz(Ring* r) { return r->ctrl->hdrsz; }
uint64_t dsaring_dropped(Ring* r) {
  return r->ctrl->dropped.load(std::memory_order_relaxed);
}
uint64_t dsaring_skipped(Ring* r) {
  return r->ctrl->skipped.load(std::memory_order_relaxed);
}
uint64_t dsaring_w_head(Ring* r) {
  return r->ctrl->w_head.load(std::memory_order_acquire);
}
uint64_t dsaring_readers(Ring* r) {
  return r->ctrl->readers.load(std::memory_order_relaxed);
}

uint64_t dsaring_r_tail(Ring* r) {
  return r->ctrl->r_tail.load(std::memory_order_acquire);
}

// ---- header (DADA-header analog) ----

int dsaring_write_header(Ring* r, const char* text, uint64_t len) {
  if (len > r->ctrl->hdrsz) return -1;
  memcpy(r->hdr, text, len);
  if (len < r->ctrl->hdrsz) r->hdr[len] = 0;
  r->ctrl->hdr_ready.store(1, std::memory_order_release);
  return 0;
}

// Returns pointer to the NUL-terminated header text, or NULL if the
// producer has not committed one yet.
const char* dsaring_read_header(Ring* r) {
  if (!r->ctrl->hdr_ready.load(std::memory_order_acquire)) return nullptr;
  return (const char*)r->hdr;
}

// ---- producer ----

// Returns a writable slot pointer, or NULL if the ring is full (the
// block should be counted dropped by calling dsaring_drop_write, or
// retried).
void* dsaring_open_write(Ring* r) {
  uint64_t w = r->ctrl->w_head.load(std::memory_order_relaxed);
  uint64_t t = r->ctrl->r_tail.load(std::memory_order_acquire);
  if (w - t >= r->ctrl->nbufs) return nullptr;  // full
  r->write_open_seq = w;
  return slot_ptr(r, w);
}

int dsaring_commit_write(Ring* r) {
  if (r->write_open_seq == ~0ULL) return -1;
  r->ctrl->w_head.store(r->write_open_seq + 1, std::memory_order_release);
  r->write_open_seq = ~0ULL;
  return 0;
}

void dsaring_drop_write(Ring* r) {
  r->ctrl->dropped.fetch_add(1, std::memory_order_relaxed);
}

void dsaring_set_eod(Ring* r) {
  r->ctrl->eod.store(1, std::memory_order_release);
}

int dsaring_eod(Ring* r) {
  // Stream ends when EOD is set AND everything written has been read.
  if (!r->ctrl->eod.load(std::memory_order_acquire)) return 0;
  return r->ctrl->r_tail.load(std::memory_order_acquire) >=
         r->ctrl->w_head.load(std::memory_order_acquire);
}

// ---- consumer ----

// Wait up to timeout_us for the next block.  latest != 0 applies the
// skip-ahead overrun policy: jump to the newest available block,
// counting skipped blocks.  Returns slot pointer (valid until
// dsaring_release_read) or NULL on timeout/EOD; *seq_out gets the
// block sequence number.
const void* dsaring_open_read(Ring* r, int64_t timeout_us, int latest,
                              uint64_t* seq_out) {
  if (!r->counted_reader) {
    r->ctrl->readers.fetch_add(1, std::memory_order_relaxed);
    r->counted_reader = true;
  }
  const int64_t poll_ns = 50 * 1000;  // 50 us
  int64_t waited_us = 0;
  for (;;) {
    uint64_t t = r->ctrl->r_tail.load(std::memory_order_relaxed);
    uint64_t w = r->ctrl->w_head.load(std::memory_order_acquire);
    if (w > t) {
      uint64_t seq = t;
      if (latest && w - t > 1) {
        r->ctrl->skipped.fetch_add(w - t - 1, std::memory_order_relaxed);
        seq = w - 1;
      }
      r->read_open_seq = seq;
      if (seq_out) *seq_out = seq;
      return slot_ptr(r, seq);
    }
    if (r->ctrl->eod.load(std::memory_order_acquire)) return nullptr;
    if (timeout_us >= 0 && waited_us >= timeout_us) return nullptr;
    struct timespec ts = {0, poll_ns};
    nanosleep(&ts, nullptr);
    waited_us += poll_ns / 1000;
  }
}

int dsaring_release_read(Ring* r) {
  if (r->read_open_seq == ~0ULL) return -1;
  r->ctrl->r_tail.store(r->read_open_seq + 1, std::memory_order_release);
  r->read_open_seq = ~0ULL;
  return 0;
}

}  // extern "C"
