// Native shared-memory object store.
//
// C++ implementation of the node-local object store (plasma analog —
// reference: ray src/ray/object_manager/plasma/{store.h,
// object_lifecycle_manager.h:101, eviction_policy.h:160}).  Same on-disk
// format as the Python fallback in ray_tpu_torch/_private/object_store.py:
//
//   [8B magic "RTPUOBJ1"][8B metadata_len][8B data_len][metadata][data]
//
// sealed atomically via rename, so Python readers/writers and this native
// store interoperate on the same directory.  Exposed as a C ABI for
// ctypes (no pybind11 in this environment).
//
// Built by ray_tpu_torch/_private/native_store.py (g++ at first load)
// into build/ray_tpu_torch/librtpu_store-<hash>.so.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'R', 'T', 'P', 'U', 'O', 'B', 'J', '1'};
constexpr uint64_t kHeader = 24;

std::string ObjPath(const std::string& dir, const std::string& oid_hex) {
  return dir + "/" + oid_hex + ".obj";
}

// --- page-recycling pool (plasma-arena analog) -----------------------------
// Freshly created tmpfs pages are zeroed + faulted by the kernel, capping a
// fresh-file put at ~3 GB/s on this class of host; a memcpy into RECYCLED
// pages runs at memory bandwidth (~11 GB/s measured). Freed objects above
// kPoolMinBytes therefore move into `<dir>/.pool/` instead of being
// unlinked; the next writer CLAIMS a best-fit pooled file via rename (atomic
// on one fs — safe across processes), mmaps and memcpys into the warm
// pages, truncates to the exact size, and seals via rename as usual.
// The pool is bounded (kPoolMaxFiles / kPoolMaxBytes) so the recycled pages
// cost a fixed tmpfs overhead; oversized or surplus frees fall back to
// unlink. Reference analog: plasma's preallocated arena
// (src/ray/object_manager/plasma/plasma_allocator.h) achieves the same
// no-page-fault property by never returning pages to the OS at all.
constexpr uint64_t kPoolMinBytes = 1ull << 20;    // don't pool small files
constexpr uint64_t kPoolMaxBytes = 512ull << 20;  // total pooled budget
constexpr int kPoolMaxFiles = 4;

std::string PoolDir(const std::string& dir) { return dir + "/.pool"; }

// In-process cache of RW mappings of pooled files, keyed by inode (an
// inode survives every pool<->object rename, so a recycled file's warm
// mapping keeps working across claims). Re-mapping per claim would pay a
// soft page fault per 4K page — measured 1.9 GB/s vs ~11 GB/s through a
// persistent mapping on this host. Bounded at kPoolMaxFiles entries; an
// entry whose file was unlinked elsewhere just pins its pages until
// evicted (bounded by kPoolMaxBytes).
struct PoolMapping {
  void* addr;
  uint64_t len;
  int users;  // writers currently memcpying through this mapping
};
std::mutex g_pool_map_mu;
std::unordered_map<uint64_t, PoolMapping> g_pool_maps;

// Acquire a warm RW mapping for the claimed file; the entry is marked
// in-use so a concurrent claimer's eviction cannot munmap it mid-memcpy
// (ctypes releases the GIL across rtpu_write_object, so concurrent
// writers are real). Pair with PoolMappingRelease(ino).
uint8_t* PoolMappingAcquire(int fd, uint64_t file_size, uint64_t* ino_out) {
  struct stat st;
  if (::fstat(fd, &st) != 0) return nullptr;
  const uint64_t ino = static_cast<uint64_t>(st.st_ino);
  std::lock_guard<std::mutex> lock(g_pool_map_mu);
  auto it = g_pool_maps.find(ino);
  if (it != g_pool_maps.end() && it->second.len >= file_size) {
    it->second.users += 1;
    *ino_out = ino;
    return static_cast<uint8_t*>(it->second.addr);
  }
  if (it != g_pool_maps.end() && it->second.users == 0) {
    ::munmap(it->second.addr, it->second.len);
    g_pool_maps.erase(it);
  } else if (it != g_pool_maps.end()) {
    return nullptr;  // shorter mapping still in use elsewhere: rare; skip
  }
  void* map =
      ::mmap(nullptr, file_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) return nullptr;
  if (g_pool_maps.size() >= static_cast<size_t>(kPoolMaxFiles)) {
    for (auto evict = g_pool_maps.begin(); evict != g_pool_maps.end();
         ++evict) {
      if (evict->second.users == 0) {
        ::munmap(evict->second.addr, evict->second.len);
        g_pool_maps.erase(evict);
        break;
      }
    }
  }
  g_pool_maps[ino] = PoolMapping{map, file_size, 1};
  *ino_out = ino;
  return static_cast<uint8_t*>(map);
}

void PoolMappingRelease(uint64_t ino) {
  std::lock_guard<std::mutex> lock(g_pool_map_mu);
  auto it = g_pool_maps.find(ino);
  if (it != g_pool_maps.end() && it->second.users > 0) {
    it->second.users -= 1;
  }
}

// Move a freed object file into the pool; returns true if pooled (caller
// skips unlink), false if the pool is full / file out of range.
bool PoolFreedFile(const std::string& dir, const std::string& obj_path,
                   uint64_t size) {
  {
    // pool files keep their (possibly larger) recycled length: name by
    // the REAL file size so best-fit claims see usable capacity
    struct stat st;
    if (::stat(obj_path.c_str(), &st) == 0) {
      size = static_cast<uint64_t>(st.st_size);
    }
  }
  if (size < kPoolMinBytes || size > kPoolMaxBytes) return false;
  const std::string pool = PoolDir(dir);
  ::mkdir(pool.c_str(), 0755);
  uint64_t bytes = 0;
  int files = 0;
  if (DIR* d = ::opendir(pool.c_str())) {
    while (dirent* e = ::readdir(d)) {
      if (e->d_name[0] == '.') continue;
      struct stat st;
      if (::stat((pool + "/" + e->d_name).c_str(), &st) == 0) {
        bytes += static_cast<uint64_t>(st.st_size);
        ++files;
      }
    }
    ::closedir(d);
  }
  if (files >= kPoolMaxFiles || bytes + size > kPoolMaxBytes) return false;
  // A live zero-copy reader holds a SHARED flock on the file for its
  // mapping's lifetime; recycling would rewrite the pages under it. Only
  // pool when the EXCLUSIVE lock is free — otherwise the caller unlinks,
  // which keeps the inode (and the reader's view) intact forever.
  int fd = ::open(obj_path.c_str(), O_RDWR);
  if (fd < 0) return false;
  if (::flock(fd, LOCK_EX | LOCK_NB) != 0) {
    ::close(fd);
    return false;
  }
  // name carries the size for cheap best-fit scans; pid+address uniquify
  static std::atomic<uint64_t> seq{0};
  const std::string dst = pool + "/" + std::to_string(size) + "-" +
                          std::to_string(::getpid()) + "-" +
                          std::to_string(seq.fetch_add(1)) + ".pool";
  const bool ok = ::rename(obj_path.c_str(), dst.c_str()) == 0;
  ::close(fd);  // releases the lock; the file is out of readers' reach now
  return ok;
}

// Claim the best-fit pooled file with st_size >= total: rename it to
// `claim_path` (atomic claim; a lost race just tries the next candidate).
// Returns the claimed file's size, or 0 when nothing fits.
uint64_t ClaimPooledFile(const std::string& dir, uint64_t total,
                         const std::string& claim_path) {
  const std::string pool = PoolDir(dir);
  DIR* d = ::opendir(pool.c_str());
  if (d == nullptr) return 0;
  // collect candidates sorted by size (pool is <= kPoolMaxFiles entries)
  std::vector<std::pair<uint64_t, std::string>> fits;
  // slack cap: a claimed file keeps its full length for mapping reuse, so
  // letting a 1MB object claim a 400MB file would carry the slack as
  // invisible tmpfs footprint for the object's lifetime; 2x bounds the
  // worst-case shm overshoot at 2x live bytes
  const uint64_t max_size = total * 2;
  while (dirent* e = ::readdir(d)) {
    if (e->d_name[0] == '.') continue;
    const uint64_t size = ::strtoull(e->d_name, nullptr, 10);
    if (size >= total && size <= max_size) {
      fits.emplace_back(size, pool + "/" + e->d_name);
    }
  }
  ::closedir(d);
  std::sort(fits.begin(), fits.end());
  for (const auto& [size, path] : fits) {
    if (::rename(path.c_str(), claim_path.c_str()) == 0) return size;
  }
  return 0;
}

// One mapped, sealed object handed out to a reader. The fd stays open
// holding a SHARED flock for the mapping's lifetime: the recycling pool
// only rewrites pages of files it can take an EXCLUSIVE flock on, so a
// live reader's view is never recycled under it.
struct MappedObject {
  void* base = nullptr;
  uint64_t size = 0;
  int fd = -1;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// stateless object IO (any process)
// ---------------------------------------------------------------------------

// Create + seal an object from N buffers. Returns total file size on
// success, 0 if the object already exists, -1 on error.
long rtpu_write_object(const char* store_dir, const char* oid_hex,
                       const uint8_t* metadata, uint64_t meta_len,
                       const uint8_t* const* bufs, const uint64_t* buf_lens,
                       uint64_t nbufs) {
  const std::string final_path = ObjPath(store_dir, oid_hex);
  struct stat st;
  if (::stat(final_path.c_str(), &st) == 0) return 0;  // immutable: no-op

  uint64_t data_len = 0;
  for (uint64_t i = 0; i < nbufs; ++i) data_len += buf_lens[i];
  const uint64_t total = kHeader + meta_len + data_len;

  const std::string tmp =
      final_path + ".building." + std::to_string(::getpid());

  // Fast path: memcpy into a recycled file's already-faulted pages
  // through a persistent (inode-keyed) mapping — ~11 GB/s vs ~3 GB/s for
  // the fresh-page write() below. The file keeps its pooled length (the
  // header records the true lengths; readers ignore trailing slack), so
  // the warm mapping stays valid for the next recycle.
  if (total >= kPoolMinBytes) {
    if (const uint64_t pooled = ClaimPooledFile(store_dir, total, tmp)) {
      int fd = ::open(tmp.c_str(), O_RDWR);
      if (fd >= 0) {
        uint64_t ino = 0;
        uint8_t* p = PoolMappingAcquire(fd, pooled, &ino);
        ::close(fd);  // the cached mapping keeps the inode alive
        if (p != nullptr) {
          std::memcpy(p, kMagic, 8);
          std::memcpy(p + 8, &meta_len, 8);
          std::memcpy(p + 16, &data_len, 8);
          p += kHeader;
          std::memcpy(p, metadata, meta_len);
          p += meta_len;
          for (uint64_t i = 0; i < nbufs; ++i) {
            std::memcpy(p, bufs[i], buf_lens[i]);
            p += buf_lens[i];
          }
          PoolMappingRelease(ino);
          if (::rename(tmp.c_str(), final_path.c_str()) == 0) {
            return static_cast<long>(total);
          }
          ::unlink(tmp.c_str());
          return -1;
        }
      }
      ::unlink(tmp.c_str());  // claimed but unusable: drop, fall through
    }
  }

  int fd = ::open(tmp.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0644);
  if (fd < 0) return -1;
  // write() instead of ftruncate+mmap+memcpy: filling FRESH tmpfs pages
  // through a mapping pays a page fault + kernel zeroing per page
  // (~1.3 GB/s measured on this host); full-page write() skips the
  // zeroing and the faults (~3 GB/s).
  auto write_all = [fd](const uint8_t* p, uint64_t n) -> bool {
    while (n > 0) {
      ssize_t w = ::write(fd, p, n);
      if (w < 0 && errno == EINTR) continue;  // CPython signals lack
      // SA_RESTART in extension code; a SIGCHLD mid-copy is not an error
      if (w <= 0) return false;
      p += w;
      n -= static_cast<uint64_t>(w);
    }
    return true;
  };
  uint8_t header[kHeader];
  std::memcpy(header, kMagic, 8);
  std::memcpy(header + 8, &meta_len, 8);
  std::memcpy(header + 16, &data_len, 8);
  bool ok = write_all(header, kHeader) && write_all(metadata, meta_len);
  for (uint64_t i = 0; ok && i < nbufs; ++i) {
    ok = write_all(bufs[i], buf_lens[i]);
  }
  ::close(fd);
  if (!ok) {
    ::unlink(tmp.c_str());
    return -1;
  }
  if (::rename(tmp.c_str(), final_path.c_str()) != 0) {
    ::unlink(tmp.c_str());
    return -1;
  }
  return static_cast<long>(total);
}

// Map a sealed object read-only. On success returns an opaque handle and
// fills the out-pointers; returns nullptr if absent or corrupt.
void* rtpu_open_object(const char* store_dir, const char* oid_hex,
                       const uint8_t** meta_ptr, uint64_t* meta_len,
                       const uint8_t** data_ptr, uint64_t* data_len) {
  const std::string path = ObjPath(store_dir, oid_hex);
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  // SHARED lock for the mapping's lifetime (fends off page recycling);
  // the inode recheck closes the open->lock race against a concurrent
  // pool rename — a recycled file is simply "absent".
  struct stat pst;
  if (::flock(fd, LOCK_SH) != 0 ||
      ::stat(path.c_str(), &pst) != 0 ||
      ::fstat(fd, &st) != 0 || st.st_ino != pst.st_ino ||
      st.st_size < (off_t)kHeader) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* p = static_cast<const uint8_t*>(map);
  if (std::memcmp(p, kMagic, 8) != 0) {
    ::munmap(map, st.st_size);
    return nullptr;
  }
  uint64_t mlen, dlen;
  std::memcpy(&mlen, p + 8, 8);
  std::memcpy(&dlen, p + 16, 8);
  if (kHeader + mlen + dlen > static_cast<uint64_t>(st.st_size)) {
    ::munmap(map, st.st_size);
    return nullptr;
  }
  *meta_ptr = p + kHeader;
  *meta_len = mlen;
  *data_ptr = p + kHeader + mlen;
  *data_len = dlen;
  auto* handle =
      new MappedObject{map, static_cast<uint64_t>(st.st_size), fd};
  return handle;
}

void rtpu_release_object(void* handle) {
  auto* h = static_cast<MappedObject*>(handle);
  if (h == nullptr) return;
  ::munmap(h->base, h->size);
  if (h->fd >= 0) ::close(h->fd);  // drops the reader's shared flock
  delete h;
}

int rtpu_object_exists(const char* store_dir, const char* oid_hex) {
  struct stat st;
  return ::stat(ObjPath(store_dir, oid_hex).c_str(), &st) == 0 ? 1 : 0;
}

// ---------------------------------------------------------------------------
// owner-side store: capacity accounting, pinning, LRU eviction
// (one instance inside the raylet; reference: ObjectLifecycleManager)
// ---------------------------------------------------------------------------

// Byte-copy src -> dst (cross-device safe: shm -> disk). Atomic via .tmp.
static bool CopyFileRaw(const std::string& src, const std::string& dst) {
  int in = ::open(src.c_str(), O_RDONLY);
  if (in < 0) return false;
  const std::string tmp = dst + ".tmp";
  int out = ::open(tmp.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0644);
  if (out < 0) {
    ::close(in);
    return false;
  }
  char buf[1 << 20];
  bool ok = true;
  for (;;) {
    ssize_t n = ::read(in, buf, sizeof(buf));
    if (n == 0) break;
    if (n < 0 || ::write(out, buf, n) != n) {
      ok = false;
      break;
    }
  }
  ::close(in);
  ::close(out);
  if (!ok || ::rename(tmp.c_str(), dst.c_str()) != 0) {
    ::unlink(tmp.c_str());
    return false;
  }
  return true;
}

struct RtpuStore {
  std::string dir;
  std::string spill_dir;  // empty = spilling disabled
  uint64_t capacity = 0;
  uint64_t used = 0;
  uint64_t spilled_bytes_total = 0;
  uint64_t restored_bytes_total = 0;
  std::mutex mu;
  // LRU list front = oldest; map value = (size, pin_count, lru iterator)
  std::list<std::string> lru;
  struct Entry {
    uint64_t size;
    int pins;
    std::list<std::string>::iterator it;
  };
  std::unordered_map<std::string, Entry> objects;
  struct SpilledEntry {
    uint64_t size;
    int pins;  // a spilled primary copy is still the primary copy
  };
  std::unordered_map<std::string, SpilledEntry> spilled;

  std::string SpillPath(const std::string& oid) const {
    return spill_dir + "/" + oid + ".obj";
  }

  void DeleteLocked(const std::string& oid) {
    auto sp = spilled.find(oid);
    if (sp != spilled.end()) {
      ::unlink(SpillPath(oid).c_str());
      spilled.erase(sp);
    }
    auto found = objects.find(oid);
    if (found == objects.end()) return;
    const std::string path = ObjPath(dir, oid);
    // Recycling rewrites the file's pages in place, so only an object no
    // internal protocol still holds may be pooled: pinned entries
    // (mid-transfer/spill, borrower handoff) must keep immutable pages —
    // plain unlink leaves the inode intact for live mappings. (Reader
    // views kept alive past all refs see recycled pages change — same
    // undefined behavior as the reference's plasma memory reuse at
    // refcount zero.)
    if (found->second.pins > 0 ||
        !PoolFreedFile(dir, path, found->second.size)) {
      ::unlink(path.c_str());
    }
    used -= found->second.size;
    lru.erase(found->second.it);
    objects.erase(found);
  }

  // Move one object's file shm -> spill dir, keeping it addressable
  // (reference: local_object_manager.h:40 SpillObjects).
  bool SpillOneLocked(const std::string& oid) {
    auto found = objects.find(oid);
    if (found == objects.end()) return false;
    if (!CopyFileRaw(ObjPath(dir, oid), SpillPath(oid))) return false;
    ::unlink(ObjPath(dir, oid).c_str());
    spilled[oid] = SpilledEntry{found->second.size, found->second.pins};
    used -= found->second.size;
    spilled_bytes_total += found->second.size;
    lru.erase(found->second.it);
    objects.erase(found);
    return true;
  }

  // returns false if space cannot be made (everything pinned, no spill dir)
  bool EnsureSpaceLocked(uint64_t size) {
    if (used + size <= capacity) return true;
    // SPILL-first when a target exists: nothing pins primary copies in
    // this runtime, and deleting the sole copy of a ray.put object is
    // unrecoverable (puts have no lineage); spilled objects stay
    // addressable and restore on access.
    if (!spill_dir.empty()) {
      for (auto it = lru.begin(); it != lru.end() && used + size > capacity;) {
        const std::string oid = *it;
        ++it;
        SpillOneLocked(oid);
      }
    }
    for (auto it = lru.begin(); it != lru.end() && used + size > capacity;) {
      const std::string oid = *it;
      ++it;  // advance before possible erase
      auto found = objects.find(oid);
      if (found == objects.end() || found->second.pins > 0) continue;
      DeleteLocked(oid);
    }
    return used + size <= capacity;
  }

  void TrackLocked(const std::string& oid, uint64_t size) {
    auto found = objects.find(oid);
    if (found != objects.end()) {
      lru.splice(lru.end(), lru, found->second.it);
      return;
    }
    lru.push_back(oid);
    objects[oid] = Entry{size, 0, std::prev(lru.end())};
    used += size;
  }
};

void* rtpu_store_create(const char* dir, uint64_t capacity) {
  ::mkdir(dir, 0755);
  auto* s = new RtpuStore;
  s->dir = dir;
  s->capacity = capacity;
  return s;
}

// Variant with a spill directory (on real disk) enabling spill-to-disk
// under memory pressure (reference: local_object_manager.h:40).
void* rtpu_store_create2(const char* dir, uint64_t capacity,
                         const char* spill_dir) {
  auto* s = static_cast<RtpuStore*>(rtpu_store_create(dir, capacity));
  if (spill_dir != nullptr && spill_dir[0] != '\0') {
    s->spill_dir = spill_dir;
    ::mkdir(spill_dir, 0755);
  }
  return s;
}

// Restore a spilled object into shm. 1 = restored, 0 = not spilled,
// -1 = IO error or no room.
int rtpu_store_restore(void* store, const char* oid_hex) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  auto sp = s->spilled.find(oid_hex);
  if (sp == s->spilled.end()) return 0;
  const uint64_t size = sp->second.size;
  const int pins = sp->second.pins;
  if (!s->EnsureSpaceLocked(size)) return -1;
  if (!CopyFileRaw(s->SpillPath(oid_hex), ObjPath(s->dir, oid_hex))) return -1;
  ::unlink(s->SpillPath(oid_hex).c_str());
  s->spilled.erase(oid_hex);
  s->TrackLocked(oid_hex, size);
  s->objects[oid_hex].pins = pins;
  s->restored_bytes_total += size;
  return 1;
}

int rtpu_store_is_spilled(void* store, const char* oid_hex) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->spilled.count(oid_hex) ? 1 : 0;
}

uint64_t rtpu_store_spilled_bytes(void* store) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->spilled_bytes_total;
}

void rtpu_store_destroy(void* store) {
  delete static_cast<RtpuStore*>(store);
}

// put = ensure space + write + account. Returns bytes written (0 if the
// object existed), -1 on IO error, -2 if it cannot fit (store full).
long rtpu_store_put(void* store, const char* oid_hex, const uint8_t* metadata,
                    uint64_t meta_len, const uint8_t* const* bufs,
                    const uint64_t* buf_lens, uint64_t nbufs) {
  auto* s = static_cast<RtpuStore*>(store);
  uint64_t data_len = 0;
  for (uint64_t i = 0; i < nbufs; ++i) data_len += buf_lens[i];
  const uint64_t total = kHeader + meta_len + data_len;
  {
    // Reserve the bytes under the same lock as the capacity check so
    // concurrent puts cannot each pass the check and overshoot capacity;
    // the reservation is rolled back below once the real size is known.
    std::lock_guard<std::mutex> lock(s->mu);
    if (!s->EnsureSpaceLocked(total)) return -2;
    s->used += total;
  }
  long written = rtpu_write_object(s->dir.c_str(), oid_hex, metadata,
                                   meta_len, bufs, buf_lens, nbufs);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    s->used -= total;  // release reservation (TrackLocked re-adds)
    if (written > 0) {
      s->TrackLocked(oid_hex, static_cast<uint64_t>(written));
    }
  }
  return written;
}

// Account for an object file written directly by a worker process — the
// main write path, so capacity is enforced here too (spill older objects
// to make room; the new object already sits on shm, so a full store just
// tracks the overshoot honestly rather than dropping it).
void rtpu_store_register_external(void* store, const char* oid_hex) {
  auto* s = static_cast<RtpuStore*>(store);
  struct stat st;
  if (::stat(ObjPath(s->dir, oid_hex).c_str(), &st) != 0) return;
  std::lock_guard<std::mutex> lock(s->mu);
  // already-tracked check BEFORE making space: a re-register at capacity
  // must not let EnsureSpace spill the very object being registered
  // (register_put and register_stored can both report the same oid)
  if (s->objects.count(oid_hex) || s->spilled.count(oid_hex)) {
    s->TrackLocked(oid_hex, static_cast<uint64_t>(st.st_size));  // LRU touch
    return;
  }
  s->EnsureSpaceLocked(static_cast<uint64_t>(st.st_size));
  s->TrackLocked(oid_hex, static_cast<uint64_t>(st.st_size));
}

void rtpu_store_touch(void* store, const char* oid_hex) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  auto found = s->objects.find(oid_hex);
  if (found != s->objects.end()) {
    s->lru.splice(s->lru.end(), s->lru, found->second.it);
  }
}

void rtpu_store_pin(void* store, const char* oid_hex) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  auto found = s->objects.find(oid_hex);
  if (found != s->objects.end()) {
    found->second.pins += 1;
    return;
  }
  auto sp = s->spilled.find(oid_hex);
  if (sp != s->spilled.end()) sp->second.pins += 1;
}

void rtpu_store_unpin(void* store, const char* oid_hex) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  auto found = s->objects.find(oid_hex);
  if (found != s->objects.end() && found->second.pins > 0) {
    found->second.pins -= 1;
    return;
  }
  auto sp = s->spilled.find(oid_hex);
  if (sp != s->spilled.end() && sp->second.pins > 0) sp->second.pins -= 1;
}

void rtpu_store_delete(void* store, const char* oid_hex) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  s->DeleteLocked(oid_hex);
}

uint64_t rtpu_store_used(void* store) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->used;
}

uint64_t rtpu_store_count(void* store) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->objects.size() + s->spilled.size();
}

// Fill up to cap entries of oid hex strings (65 bytes each incl NUL);
// spilled objects are listed too (they are still addressable here).
// Returns number written.
uint64_t rtpu_store_list(void* store, char* out, uint64_t cap) {
  auto* s = static_cast<RtpuStore*>(store);
  std::lock_guard<std::mutex> lock(s->mu);
  uint64_t n = 0;
  for (const auto& kv : s->objects) {
    if (n >= cap) break;
    std::snprintf(out + n * 65, 65, "%s", kv.first.c_str());
    ++n;
  }
  for (const auto& kv : s->spilled) {
    if (n >= cap) break;
    std::snprintf(out + n * 65, 65, "%s", kv.first.c_str());
    ++n;
  }
  return n;
}

}  // extern "C"
