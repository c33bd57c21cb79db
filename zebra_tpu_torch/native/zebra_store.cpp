// zebra_store: append-only compressed blob log with a 16-byte-key index (the
// port's own copy of zebra_tpu/native/zebra_store.cpp; the code below is
// unchanged, so a log written by one package opens in the other).
//
// Design:
//   * one packed log file instead of one small file per document (batch
//     fsync, sequential IO)
//   * zlib per-record compression (flagged per record)
//   * crash safety via CRC32-checked records; a truncated/corrupt tail is
//     dropped on open
//   * delete = tombstone record; compact() rewrites live data
//
// C ABI for ctypes. Thread-safe via a single mutex per store (the Python side
// already batches; contention is not the bottleneck).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <mutex>
#include <zlib.h>

#include <cerrno>
#include <fcntl.h>
#include <unistd.h>
#include <sys/stat.h>

namespace {

constexpr uint32_t MAGIC = 0x5A424C31;  // "ZBL1"
constexpr uint8_t FLAG_TOMBSTONE = 1;
constexpr uint8_t FLAG_ZLIB = 2;

#pragma pack(push, 1)
struct RecordHeader {
  uint32_t magic;
  uint8_t key[16];
  uint8_t flags;
  uint32_t raw_len;      // uncompressed payload length
  uint32_t stored_len;   // bytes on disk following this header
  uint32_t crc;          // crc32 of stored payload bytes
};
#pragma pack(pop)

struct KeyHash {
  size_t operator()(const std::string& k) const {
    uint64_t h = 1469598103934665603ull;
    for (unsigned char c : k) { h ^= c; h *= 1099511628211ull; }
    return (size_t)h;
  }
};

struct Entry {
  uint64_t offset;     // file offset of RecordHeader
  uint32_t raw_len;
  uint32_t stored_len;
  uint8_t flags;
};

struct Store {
  std::string path;
  int fd = -1;
  uint64_t end = 0;  // logical end of valid log
  std::unordered_map<std::string, Entry, KeyHash> index;
  std::mutex mu;
  bool dirty = false;
};

std::string key_str(const uint8_t* key) {
  return std::string(reinterpret_cast<const char*>(key), 16);
}

bool read_exact(int fd, uint64_t off, void* buf, size_t n) {
  ssize_t got = pread(fd, buf, n, (off_t)off);
  return got == (ssize_t)n;
}

// Scan the log, building the index; stop at the first corrupt/truncated
// record and truncate the logical end there.
void recover(Store* s) {
  struct stat st;
  if (fstat(s->fd, &st) != 0) return;
  uint64_t size = (uint64_t)st.st_size;
  uint64_t off = 0;
  std::vector<uint8_t> payload;
  while (off + sizeof(RecordHeader) <= size) {
    RecordHeader h;
    if (!read_exact(s->fd, off, &h, sizeof(h)) || h.magic != MAGIC) break;
    if (off + sizeof(h) + h.stored_len > size) break;
    payload.resize(h.stored_len);
    if (h.stored_len && !read_exact(s->fd, off + sizeof(h), payload.data(), h.stored_len)) break;
    uint32_t crc = crc32(0, payload.data(), h.stored_len);
    if (crc != h.crc) break;
    std::string k = key_str(h.key);
    if (h.flags & FLAG_TOMBSTONE) {
      s->index.erase(k);
    } else {
      s->index[k] = Entry{off, h.raw_len, h.stored_len, h.flags};
    }
    off += sizeof(h) + h.stored_len;
  }
  s->end = off;
  if (off < size) {
    // drop the corrupt tail so future appends start at a clean boundary
    if (ftruncate(s->fd, (off_t)off) != 0) { /* keep going; appends use end */ }
  }
}

int append_record(Store* s, const uint8_t key[16], uint8_t flags,
                  const uint8_t* payload, uint32_t raw_len,
                  const uint8_t* stored, uint32_t stored_len) {
  RecordHeader h;
  h.magic = MAGIC;
  memcpy(h.key, key, 16);
  h.flags = flags;
  h.raw_len = raw_len;
  h.stored_len = stored_len;
  h.crc = crc32(0, stored, stored_len);
  (void)payload;
  struct WritePart {
    const void* base; size_t len;
  } parts[2] = {{&h, sizeof(h)}, {stored, stored_len}};
  uint64_t off = s->end;
  uint64_t pos = off;
  for (auto& p : parts) {
    const uint8_t* b = (const uint8_t*)p.base;
    size_t left = p.len;
    while (left) {
      ssize_t w = pwrite(s->fd, b, left, (off_t)pos);
      if (w <= 0) return -1;
      b += w; left -= (size_t)w; pos += (uint64_t)w;
    }
  }
  s->end = pos;
  s->dirty = true;
  std::string k = key_str(key);
  if (flags & FLAG_TOMBSTONE) s->index.erase(k);
  else s->index[k] = Entry{off, raw_len, stored_len, flags};
  return 0;
}

}  // namespace

extern "C" {

void* zs_open(const char* dir) {
  std::string d(dir);
  if (mkdir(d.c_str(), 0755) != 0 && errno != EEXIST) return nullptr;
  auto* s = new Store();
  s->path = d + "/blobs.log";
  s->fd = open(s->path.c_str(), O_RDWR | O_CREAT, 0644);
  if (s->fd < 0) { delete s; return nullptr; }
  recover(s);
  return s;
}

int zs_put(void* h, const uint8_t key[16], const uint8_t* data, uint32_t len,
           int compress_flag) {
  auto* s = (Store*)h;
  std::lock_guard<std::mutex> lock(s->mu);
  if (compress_flag) {
    uLongf bound = compressBound(len);
    std::vector<uint8_t> out(bound);
    if (compress2(out.data(), &bound, data, len, 1) == Z_OK && bound < len) {
      return append_record(s, key, FLAG_ZLIB, data, len, out.data(), (uint32_t)bound);
    }
  }
  return append_record(s, key, 0, data, len, data, len);
}

// Returns the uncompressed length, or -1 if absent.
int64_t zs_get_len(void* h, const uint8_t key[16]) {
  auto* s = (Store*)h;
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->index.find(key_str(key));
  if (it == s->index.end()) return -1;
  return it->second.raw_len;
}

// Copies the uncompressed payload into buf (size buflen); returns bytes
// written or -1 on absence/corruption/undersized buffer.
int64_t zs_get(void* h, const uint8_t key[16], uint8_t* buf, uint32_t buflen) {
  auto* s = (Store*)h;
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->index.find(key_str(key));
  if (it == s->index.end()) return -1;
  const Entry& e = it->second;
  if (buflen < e.raw_len) return -1;
  std::vector<uint8_t> stored(e.stored_len);
  if (!read_exact(s->fd, e.offset + sizeof(RecordHeader), stored.data(), e.stored_len))
    return -1;
  if (e.flags & FLAG_ZLIB) {
    uLongf out_len = e.raw_len;
    if (uncompress(buf, &out_len, stored.data(), e.stored_len) != Z_OK) return -1;
    return (int64_t)out_len;
  }
  memcpy(buf, stored.data(), e.stored_len);
  return (int64_t)e.stored_len;
}

int zs_del(void* h, const uint8_t key[16]) {
  auto* s = (Store*)h;
  std::lock_guard<std::mutex> lock(s->mu);
  if (s->index.find(key_str(key)) == s->index.end()) return 0;
  uint8_t none = 0;
  return append_record(s, key, FLAG_TOMBSTONE, &none, 0, &none, 0);
}

int zs_flush(void* h) {
  auto* s = (Store*)h;
  std::lock_guard<std::mutex> lock(s->mu);
  if (!s->dirty) return 0;
  int r = fsync(s->fd);
  s->dirty = (r != 0);
  return r;
}

int64_t zs_count(void* h) {
  auto* s = (Store*)h;
  std::lock_guard<std::mutex> lock(s->mu);
  return (int64_t)s->index.size();
}

// Rewrite only live records into a fresh log (reclaims deleted space).
int zs_compact(void* h) {
  auto* s = (Store*)h;
  std::lock_guard<std::mutex> lock(s->mu);
  std::string tmp = s->path + ".compact";
  int nfd = open(tmp.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (nfd < 0) return -1;
  uint64_t noff = 0;
  std::unordered_map<std::string, Entry, KeyHash> nindex;
  std::vector<uint8_t> buf;
  for (auto& [k, e] : s->index) {
    RecordHeader hrec;
    hrec.magic = MAGIC;
    memcpy(hrec.key, k.data(), 16);
    hrec.flags = e.flags;
    hrec.raw_len = e.raw_len;
    hrec.stored_len = e.stored_len;
    buf.resize(e.stored_len);
    if (!read_exact(s->fd, e.offset + sizeof(RecordHeader), buf.data(), e.stored_len)) {
      close(nfd); unlink(tmp.c_str()); return -1;
    }
    hrec.crc = crc32(0, buf.data(), e.stored_len);
    uint64_t start = noff;
    if (pwrite(nfd, &hrec, sizeof(hrec), (off_t)noff) != (ssize_t)sizeof(hrec)) {
      close(nfd); unlink(tmp.c_str()); return -1;
    }
    noff += sizeof(hrec);
    if (e.stored_len &&
        pwrite(nfd, buf.data(), e.stored_len, (off_t)noff) != (ssize_t)e.stored_len) {
      close(nfd); unlink(tmp.c_str()); return -1;
    }
    noff += e.stored_len;
    nindex[k] = Entry{start, e.raw_len, e.stored_len, e.flags};
  }
  if (fsync(nfd) != 0 || rename(tmp.c_str(), s->path.c_str()) != 0) {
    close(nfd); unlink(tmp.c_str()); return -1;
  }
  close(s->fd);
  s->fd = nfd;
  s->end = noff;
  s->index = std::move(nindex);
  s->dirty = true;
  return 0;
}

void zs_close(void* h) {
  auto* s = (Store*)h;
  {
    std::lock_guard<std::mutex> lock(s->mu);
    if (s->dirty) fsync(s->fd);
    close(s->fd);
  }
  delete s;
}

// ---------------------------------------------------------------------------
// IdMap: flat open-addressing 16-byte-key -> int64 map for host id lookups at
// 10M+ scale (Python dicts cost ~100B/entry and GC pressure; this is 24B).
// ---------------------------------------------------------------------------

struct IdMap {
  std::vector<uint8_t> keys;    // 16B per bucket
  std::vector<int64_t> values;  // -1 = empty, -2 = tombstone
  // used_ counts live + tombstone slots. Load-factor checks MUST use used_,
  // not size_: probe loops terminate only on an empty (-1) slot, so a table
  // whose every slot is live-or-tombstone spins forever. put/delete churn of
  // distinct keys creates exactly that state if tombstones are unaccounted.
  size_t cap = 0, size_ = 0, used_ = 0;
  std::mutex mu;

  void init(size_t c) {
    cap = c;
    keys.assign(cap * 16, 0);
    values.assign(cap, -1);
    size_ = 0;
    used_ = 0;
  }
  size_t probe_start(const uint8_t* k) const {
    uint64_t hv = 1469598103934665603ull;
    for (int i = 0; i < 16; i++) { hv ^= k[i]; hv *= 1099511628211ull; }
    return (size_t)(hv & (cap - 1));
  }
  void grow();
  bool put(const uint8_t* k, int64_t v) {
    if ((used_ + 1) * 10 > cap * 7) grow();
    size_t i = probe_start(k);
    size_t first_tomb = SIZE_MAX;
    for (;;) {
      int64_t cur = values[i];
      if (cur == -1) {
        size_t target = (first_tomb != SIZE_MAX) ? first_tomb : i;
        memcpy(&keys[target * 16], k, 16);
        values[target] = v;
        size_++;
        if (target == i) used_++;  // reused tombstone slots were already counted
        return true;
      }
      if (cur == -2) {
        if (first_tomb == SIZE_MAX) first_tomb = i;
      } else if (memcmp(&keys[i * 16], k, 16) == 0) {
        values[i] = v;
        return true;
      }
      i = (i + 1) & (cap - 1);
    }
  }
  int64_t get(const uint8_t* k) const {
    size_t i = probe_start(k);
    for (;;) {
      int64_t cur = values[i];
      if (cur == -1) return -1;
      if (cur != -2 && memcmp(&keys[i * 16], k, 16) == 0) return cur;
      i = (i + 1) & (cap - 1);
    }
  }
  bool del(const uint8_t* k) {
    size_t i = probe_start(k);
    for (;;) {
      int64_t cur = values[i];
      if (cur == -1) return false;
      if (cur != -2 && memcmp(&keys[i * 16], k, 16) == 0) {
        values[i] = -2;
        size_--;
        return true;
      }
      i = (i + 1) & (cap - 1);
    }
  }
};

void IdMap::grow() {
  IdMap bigger;
  // Rehash always drops tombstones; double capacity only when the live load
  // is actually high — churn-heavy workloads just reclaim dead slots in place.
  size_t ncap = (size_ * 2 > cap) ? cap * 2 : cap;
  bigger.init(ncap);
  for (size_t i = 0; i < cap; i++) {
    if (values[i] >= 0) bigger.put(&keys[i * 16], values[i]);
  }
  keys = std::move(bigger.keys);
  values = std::move(bigger.values);
  cap = bigger.cap;
  used_ = size_;  // tombstones gone; size_ unchanged
}

extern "C" void* zim_new(uint64_t initial_cap) {
  auto* m = new IdMap();
  size_t c = 1024;
  while (c < initial_cap * 2) c <<= 1;
  m->init(c);
  return m;
}

extern "C" void zim_free(void* h) { delete (IdMap*)h; }

extern "C" int zim_put(void* h, const uint8_t key[16], int64_t v) {
  auto* m = (IdMap*)h;
  std::lock_guard<std::mutex> lock(m->mu);
  return m->put(key, v) ? 0 : -1;
}

extern "C" int64_t zim_get(void* h, const uint8_t key[16]) {
  auto* m = (IdMap*)h;
  std::lock_guard<std::mutex> lock(m->mu);
  return m->get(key);
}

extern "C" int zim_del(void* h, const uint8_t key[16]) {
  auto* m = (IdMap*)h;
  std::lock_guard<std::mutex> lock(m->mu);
  return m->del(key) ? 0 : -1;
}

extern "C" int64_t zim_size(void* h) {
  auto* m = (IdMap*)h;
  std::lock_guard<std::mutex> lock(m->mu);
  return (int64_t)m->size_;
}

// Bulk ops: amortize ctypes overhead for batch insert/lookup.
extern "C" int zim_put_many(void* h, const uint8_t* keys, const int64_t* vals, uint64_t n) {
  auto* m = (IdMap*)h;
  std::lock_guard<std::mutex> lock(m->mu);
  for (uint64_t i = 0; i < n; i++) m->put(keys + i * 16, vals[i]);
  return 0;
}

extern "C" int zim_get_many(void* h, const uint8_t* keys, int64_t* out, uint64_t n) {
  auto* m = (IdMap*)h;
  std::lock_guard<std::mutex> lock(m->mu);
  for (uint64_t i = 0; i < n; i++) out[i] = m->get(keys + i * 16);
  return 0;
}

}  // extern "C" (zs_*)
