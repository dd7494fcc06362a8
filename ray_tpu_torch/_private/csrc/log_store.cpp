// Native append-log key-value store for GCS persistence.
//
// C++ implementation of the GCS store-client role (reference: ray
// src/ray/gcs/store_client/redis_store_client.h — persistence the GCS
// replays after a restart; here an append-only log with compaction, the
// same on-disk format as the Python fallback in
// ray_tpu_torch/_private/gcs_store.py is NOT shared: this store frames
// (table, key, value) byte strings natively and owns its file, so the
// Python layer keeps pickling keys/values and hands opaque bytes down).
//
//   record := [4B LE total_len][4B tlen][4B klen][8B vlen][table][key][value]
//   vlen == UINT64_MAX marks a tombstone (key deleted).
//
// Open replays the log into an in-memory map (torn tails are truncated),
// compacts it to live records via an atomic rename, and appends from
// there. Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Built by ray_tpu_torch/_private/native_store.py (g++ at first load)
// into build/ray_tpu_torch/librtpu_store-<hash>.so.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kTombstone = UINT64_MAX;
// File magic: refuses foreign formats (e.g. the Python FileLogStore's
// pickle framing) instead of compacting them down to nothing.
constexpr char kLogMagic[8] = {'R', 'T', 'P', 'U', 'L', 'G', '0', '2'};

struct LogRecord {
  std::string value;
};

struct LogStore {
  std::string path;
  int fd = -1;
  bool fsync_each = false;
  // (table, key) -> value; std::map keeps iteration deterministic.
  std::map<std::pair<std::string, std::string>, std::string> live;
  // iterator state for rtpu_log_iter_next
  std::map<std::pair<std::string, std::string>, std::string>::iterator it;
  bool iterating = false;

  bool WriteRecord(int out_fd, const std::string& table,
                   const std::string& key, const std::string* value) {
    const uint32_t tlen = table.size();
    const uint32_t klen = key.size();
    const uint64_t vlen = value ? value->size() : kTombstone;
    const uint32_t body = tlen + klen + (value ? value->size() : 0);
    const uint32_t total = 4 + 4 + 8 + body;
    std::vector<uint8_t> buf(4 + total);
    uint8_t* p = buf.data();
    std::memcpy(p, &total, 4);
    std::memcpy(p + 4, &tlen, 4);
    std::memcpy(p + 8, &klen, 4);
    std::memcpy(p + 12, &vlen, 8);
    std::memcpy(p + 20, table.data(), tlen);
    std::memcpy(p + 20 + tlen, key.data(), klen);
    if (value) std::memcpy(p + 20 + tlen + klen, value->data(), value->size());
    const uint8_t* cur = buf.data();
    size_t remaining = buf.size();
    while (remaining > 0) {
      ssize_t n = ::write(out_fd, cur, remaining);
      if (n <= 0) return false;
      cur += n;
      remaining -= n;
    }
    return true;
  }

  // Returns false when the file exists but is not ours (foreign format).
  bool Load() {
    live.clear();
    int in = ::open(path.c_str(), O_RDONLY);
    if (in < 0) return true;  // fresh file
    struct stat st;
    if (::fstat(in, &st) != 0 || st.st_size == 0) {
      ::close(in);
      return true;
    }
    std::vector<uint8_t> data(st.st_size);
    size_t n = 0;  // loop: a single ::read caps at ~2GB on Linux
    while (n < data.size()) {
      ssize_t got = ::read(in, data.data() + n, data.size() - n);
      if (got <= 0) break;
      n += static_cast<size_t>(got);
    }
    ::close(in);
    if (n < sizeof(kLogMagic) ||
        std::memcmp(data.data(), kLogMagic, sizeof(kLogMagic)) != 0) {
      return false;  // foreign format: never compact-destroy it
    }
    size_t off = sizeof(kLogMagic);
    while (off + 4 <= n) {
      uint32_t total;
      std::memcpy(&total, data.data() + off, 4);
      if (off + 4 + total > n || total < 16) break;  // torn tail: stop
      const uint8_t* p = data.data() + off + 4;
      uint32_t tlen, klen;
      uint64_t vlen;
      std::memcpy(&tlen, p, 4);
      std::memcpy(&klen, p + 4, 4);
      std::memcpy(&vlen, p + 8, 8);
      const bool tomb = (vlen == kTombstone);
      const uint64_t vsz = tomb ? 0 : vlen;
      if (16ULL + tlen + klen + vsz != total) break;  // corrupt: stop
      std::string table(reinterpret_cast<const char*>(p + 16), tlen);
      std::string key(reinterpret_cast<const char*>(p + 16 + tlen), klen);
      auto mk = std::make_pair(std::move(table), std::move(key));
      if (tomb) {
        live.erase(mk);
      } else {
        live[std::move(mk)] = std::string(
            reinterpret_cast<const char*>(p + 16 + tlen + klen), vsz);
      }
      off += 4 + total;
    }
    return true;
  }

  bool Compact() {
    const std::string tmp = path + ".compact";
    int out = ::open(tmp.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0644);
    if (out < 0) return false;
    if (::write(out, kLogMagic, sizeof(kLogMagic)) !=
        (ssize_t)sizeof(kLogMagic)) {
      ::close(out);
      ::unlink(tmp.c_str());
      return false;
    }
    for (const auto& kv : live) {
      if (!WriteRecord(out, kv.first.first, kv.first.second, &kv.second)) {
        ::close(out);
        ::unlink(tmp.c_str());
        return false;
      }
    }
    ::fsync(out);
    ::close(out);
    return ::rename(tmp.c_str(), path.c_str()) == 0;
  }
};

}  // namespace

extern "C" {

// Open (replaying + compacting an existing log). Returns nullptr on error.
void* rtpu_log_open(const char* path, int fsync_each) {
  auto* s = new LogStore;
  s->path = path;
  s->fsync_each = fsync_each != 0;
  if (!s->Load()) {  // foreign format: refuse, caller falls back
    delete s;
    return nullptr;
  }
  if (!s->Compact()) {
    // A fresh file in an unwritable dir: fail open.
    struct stat st;
    if (::stat(path, &st) != 0) {
      delete s;
      return nullptr;
    }
  }
  s->fd = ::open(path, O_CREAT | O_APPEND | O_WRONLY, 0644);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  return s;
}

// value == nullptr -> tombstone. Returns 0 on success.
int rtpu_log_put(void* handle, const uint8_t* table, uint64_t tlen,
                 const uint8_t* key, uint64_t klen,
                 const uint8_t* value, uint64_t vlen) {
  auto* s = static_cast<LogStore*>(handle);
  std::string t(reinterpret_cast<const char*>(table), tlen);
  std::string k(reinterpret_cast<const char*>(key), klen);
  std::string v;
  const std::string* vp = nullptr;
  if (value != nullptr) {
    v.assign(reinterpret_cast<const char*>(value), vlen);
    vp = &v;
  }
  const off_t before = ::lseek(s->fd, 0, SEEK_END);
  if (!s->WriteRecord(s->fd, t, k, vp)) {
    // Truncate the torn record: later successful appends after it would
    // be silently discarded by replay's torn-tail handling.
    if (before >= 0) {
      if (::ftruncate(s->fd, before) != 0) {
        // best effort; replay still stops at the torn record
      }
    }
    return -1;
  }
  if (s->fsync_each) ::fsync(s->fd);
  auto mk = std::make_pair(std::move(t), std::move(k));
  if (vp) {
    s->live[std::move(mk)] = std::move(v);
  } else {
    s->live.erase(mk);
  }
  return 0;
}

uint64_t rtpu_log_count(void* handle) {
  return static_cast<LogStore*>(handle)->live.size();
}

void rtpu_log_iter_start(void* handle) {
  auto* s = static_cast<LogStore*>(handle);
  s->it = s->live.begin();
  s->iterating = true;
}

// Fills pointers into store-owned memory valid until the next mutation.
// Returns 1 while records remain, 0 at the end.
int rtpu_log_iter_next(void* handle, const uint8_t** table, uint64_t* tlen,
                       const uint8_t** key, uint64_t* klen,
                       const uint8_t** value, uint64_t* vlen) {
  auto* s = static_cast<LogStore*>(handle);
  if (!s->iterating || s->it == s->live.end()) {
    s->iterating = false;
    return 0;
  }
  *table = reinterpret_cast<const uint8_t*>(s->it->first.first.data());
  *tlen = s->it->first.first.size();
  *key = reinterpret_cast<const uint8_t*>(s->it->first.second.data());
  *klen = s->it->first.second.size();
  *value = reinterpret_cast<const uint8_t*>(s->it->second.data());
  *vlen = s->it->second.size();
  ++s->it;
  return 1;
}

void rtpu_log_close(void* handle) {
  auto* s = static_cast<LogStore*>(handle);
  if (s->fd >= 0) {
    ::fsync(s->fd);
    ::close(s->fd);
  }
  delete s;
}

}  // extern "C"
