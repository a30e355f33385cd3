// Group-commit write-ahead log: the durability hot path behind the
// port's server/raft.py FileLog (a copy of nomad_tpu/native/wal.cc).
//
// Every log apply pays an fsync; with concurrent appliers (the batch
// workers' eval writes and the plan applier's commits) a log that syncs
// under its lock serializes one fsync per append.  This WAL batches them:
// appenders write their framed record under the lock, then one thread
// performs a single fsync for every record written since the last sync
// (group commit).
//
// Record framing:  [u32 len][u32 crc32(payload)][payload]
// Recovery: scan until EOF/short-read/CRC mismatch, truncate the torn or
// corrupt tail so subsequent appends follow the last good record.
//
// Plain C ABI for ctypes; built with g++ at first use by
// nomad_tpu_torch/native/__init__.py.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// CRC-32 (IEEE, reflected) — table-driven, computed once.
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Wal {
  int fd = -1;
  std::string path;
  int sync_mode = 1;  // 0 = no fsync (tests), 1 = fsync on append

  std::mutex mu;
  std::condition_variable cv;
  uint64_t written_seq = 0;   // records written to the fd
  uint64_t synced_seq = 0;    // records known durable
  bool sync_in_flight = false;
  // Sticky: one failed fsync poisons the log.  The kernel may CLEAR
  // the error state after reporting it once (fsyncgate), so a sibling
  // waiter retrying the fsync would get rc==0 and falsely ack entries
  // whose dirty pages were dropped.
  bool failed = false;
  long fsyncs = 0;            // fsync calls made by appenders' syncs

  // iteration state (single iterator at a time; guarded by mu)
  std::vector<uint8_t> iter_buf;
  off_t iter_off = 0;

  long entry_count = 0;
};

void set_err(char* errbuf, int errcap, const char* msg) {
  if (errbuf && errcap > 0) {
    std::snprintf(errbuf, (size_t)errcap, "%s: %s", msg, std::strerror(errno));
  }
}

// Scan the log, count whole CRC-valid records, truncate anything after
// the last good one.  Returns -1 on IO error.
long recover(Wal* w, char* errbuf, int errcap) {
  off_t size = ::lseek(w->fd, 0, SEEK_END);
  if (size < 0) { set_err(errbuf, errcap, "lseek"); return -1; }
  off_t off = 0;
  long count = 0;
  std::vector<uint8_t> buf;
  while (true) {
    uint8_t hdr[8];
    if (off + 8 > size) break;  // short header → torn tail
    if (::pread(w->fd, hdr, 8, off) != 8) break;
    uint32_t len, crc;
    std::memcpy(&len, hdr, 4);
    std::memcpy(&crc, hdr + 4, 4);
    if (off + 8 + (off_t)len > size) break;  // record runs past EOF
    buf.resize(len);
    if (len && ::pread(w->fd, buf.data(), len, off + 8) != (ssize_t)len)
      break;
    if (crc32(buf.data(), len) != crc) break;  // corrupt tail
    off += 8 + (off_t)len;
    count++;
  }
  if (off < size) {
    if (::ftruncate(w->fd, off) != 0) {
      set_err(errbuf, errcap, "ftruncate");
      return -1;
    }
  }
  if (::lseek(w->fd, off, SEEK_SET) < 0) {
    set_err(errbuf, errcap, "lseek");
    return -1;
  }
  return count;
}

}  // namespace

extern "C" {

Wal* nwal_open(const char* path, int sync_mode, char* errbuf, int errcap) {
  crc_init();
  Wal* w = new Wal();
  w->path = path;
  w->sync_mode = sync_mode;
  w->fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (w->fd < 0) {
    set_err(errbuf, errcap, "open");
    delete w;
    return nullptr;
  }
  long n = recover(w, errbuf, errcap);
  if (n < 0) {
    ::close(w->fd);
    delete w;
    return nullptr;
  }
  w->entry_count = n;
  return w;
}

long nwal_entry_count(Wal* w) { return w->entry_count; }

// fsync calls made so far by group-commit syncs (one covers every record
// written before it started): records written over this is the
// coalescing factor.
long nwal_fsync_count(Wal* w) {
  std::lock_guard<std::mutex> lk(w->mu);
  return w->fsyncs;
}

// Write one framed record WITHOUT waiting for durability; returns the
// record's seq (>0), 0 on error.  Callers that need an ordering
// guarantee (the raft log: record index order == file order for the
// durable prefix) serialize their write() calls externally and only
// overlap the sync_seq() waits — that separation is what lets
// concurrent raft appliers share one fsync instead of paying one each
// under the apply lock.
uint64_t nwal_write(Wal* w, const void* data, uint32_t len) {
  uint8_t hdr[8];
  uint32_t crc = crc32((const uint8_t*)data, len);
  std::memcpy(hdr, &len, 4);
  std::memcpy(hdr + 4, &crc, 4);
  std::lock_guard<std::mutex> lk(w->mu);
  off_t start = ::lseek(w->fd, 0, SEEK_CUR);
  if (start < 0) return 0;
  if (::write(w->fd, hdr, 8) != 8 ||
      (len && ::write(w->fd, data, len) != (ssize_t)len)) {
    // Roll the torn frame back (ENOSPC / short write): leaving it
    // mid-log would strand every LATER successful append behind it —
    // recovery truncates at the first bad frame, silently discarding
    // acked-durable entries.
    ::ftruncate(w->fd, start);
    ::lseek(w->fd, start, SEEK_SET);
    return 0;
  }
  w->entry_count++;
  return ++w->written_seq;
}

// Block until records through ``seq`` are durable (group commit): if a
// sibling's fsync is in flight, wait — when it finishes it covers every
// record written before it started; otherwise become the syncer for
// everything written so far.  Returns 0 durable, -1 on fsync error.
int nwal_sync_seq(Wal* w, uint64_t seq) {
  std::unique_lock<std::mutex> lk(w->mu);
  if (w->sync_mode == 0) {
    if (w->synced_seq < w->written_seq) w->synced_seq = w->written_seq;
    return 0;
  }
  while (true) {
    if (w->failed) return -1;
    if (w->synced_seq >= seq) return 0;
    if (!w->sync_in_flight) break;
    w->cv.wait(lk);
  }
  w->sync_in_flight = true;
  uint64_t cover = w->written_seq;
  lk.unlock();
  // fsync outside the lock: writers keep appending the next batch.
  int rc = ::fsync(w->fd);
  lk.lock();
  w->fsyncs++;
  w->sync_in_flight = false;
  if (rc == 0) {
    if (cover > w->synced_seq) w->synced_seq = cover;
  } else {
    w->failed = true;  // sticky: no waiter may retry and falsely ack
  }
  w->cv.notify_all();
  if (rc != 0) return -1;
  return w->synced_seq >= seq ? 0 : -1;
}

// Append one record; returns 0 when the record is DURABLE (group-commit
// fsync has covered it), -1 on error.
int nwal_append(Wal* w, const void* data, uint32_t len) {
  uint64_t seq = nwal_write(w, data, len);
  if (seq == 0) return -1;
  return nwal_sync_seq(w, seq);
}

// Iterate records from the start.  nwal_iter_next fills *data/*len with
// a pointer valid until the next call; returns 1 on a record, 0 at end,
// -1 on error.
void nwal_iter_start(Wal* w) {
  std::lock_guard<std::mutex> lk(w->mu);
  w->iter_off = 0;
}

int nwal_iter_next(Wal* w, const uint8_t** data, uint32_t* len) {
  std::lock_guard<std::mutex> lk(w->mu);
  uint8_t hdr[8];
  ssize_t r = ::pread(w->fd, hdr, 8, w->iter_off);
  if (r == 0) return 0;
  if (r != 8) return 0;  // torn tail already truncated at open; be lenient
  uint32_t rlen, crc;
  std::memcpy(&rlen, hdr, 4);
  std::memcpy(&crc, hdr + 4, 4);
  w->iter_buf.resize(rlen);
  if (rlen && ::pread(w->fd, w->iter_buf.data(), rlen, w->iter_off + 8)
                  != (ssize_t)rlen)
    return -1;
  if (crc32(w->iter_buf.data(), rlen) != crc) return -1;
  w->iter_off += 8 + (off_t)rlen;
  *data = w->iter_buf.data();
  *len = rlen;
  return 1;
}

// Reset the log to empty (post-snapshot truncation).
int nwal_reset(Wal* w) {
  std::lock_guard<std::mutex> lk(w->mu);
  if (::ftruncate(w->fd, 0) != 0) return -1;
  if (::lseek(w->fd, 0, SEEK_SET) < 0) return -1;
  w->entry_count = 0;
  if (w->sync_mode && ::fsync(w->fd) != 0) return -1;
  return 0;
}

int nwal_sync(Wal* w) {
  if (w->sync_mode == 0) return 0;
  return ::fsync(w->fd) == 0 ? 0 : -1;
}

void nwal_close(Wal* w) {
  if (!w) return;
  if (w->fd >= 0) ::close(w->fd);
  delete w;
}

}  // extern "C"
