// Native data-loading tier: multi-threaded .npz/.npy reader with fused
// normalization, exposed through a C ABI consumed via ctypes
// (domain_transfer_gan_torch/data/native.py).
//
// The host-side loading path of the reference (dataloader.py:13-59
// load_numpy_data and the per-file NumpyDataset, dataloader.py:158-232) in
// native code: ZIP/npy container parsing, inflate via zlib, dtype
// conversion to float32, and the exact normalization semantics (NaN->0,
// per-sample-per-channel min-max to [-1,1], +-inf->0) fused into the read
// loop so each sample is touched once while it is cache-resident.
//
// Built at first use by data/native.py (g++ -O3 -shared -fPIC ... -lz) into
// the build directory beside the package, under a name hashed from this
// source and the flags.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cfloat>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// minimal ZIP reader (enough for numpy's savez/savez_compressed output)
// ---------------------------------------------------------------------------

struct Entry {
  std::string name;
  uint16_t method = 0;       // 0 = stored, 8 = deflate
  uint64_t comp_size = 0;
  uint64_t raw_size = 0;
  uint64_t data_offset = 0;  // absolute offset of the payload
};

struct Buffer {
  std::vector<uint8_t> data;
};

static uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
static uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

static bool read_file(const char* path, Buffer* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->data.resize(n);
  bool ok = fread(out->data.data(), 1, n, f) == (size_t)n;
  fclose(f);
  return ok;
}

// Walk local file headers sequentially (numpy writes simple archives).
static bool list_entries(const Buffer& zip, std::vector<Entry>* out) {
  const uint8_t* p = zip.data.data();
  size_t n = zip.data.size();
  size_t off = 0;
  while (off + 30 <= n) {
    uint32_t sig = rd32(p + off);
    if (sig != 0x04034b50) break;  // not a local header: central dir reached
    Entry e;
    e.method = rd16(p + off + 8);
    uint32_t comp = rd32(p + off + 18);
    uint32_t raw = rd32(p + off + 22);
    uint16_t name_len = rd16(p + off + 26);
    uint16_t extra_len = rd16(p + off + 28);
    e.name.assign((const char*)(p + off + 30), name_len);
    e.comp_size = comp;
    e.raw_size = raw;
    e.data_offset = off + 30 + name_len + extra_len;
    // zip64 sizes live in the extra field
    if (comp == 0xffffffffu || raw == 0xffffffffu) {
      const uint8_t* x = p + off + 30 + name_len;
      size_t xoff = 0;
      while (xoff + 4 <= extra_len) {
        uint16_t id = rd16(x + xoff), sz = rd16(x + xoff + 2);
        if (id == 0x0001 && sz >= 16) {
          memcpy(&e.raw_size, x + xoff + 4, 8);
          memcpy(&e.comp_size, x + xoff + 12, 8);
        }
        xoff += 4 + sz;
      }
    }
    if (e.data_offset + e.comp_size > n) return false;
    out->push_back(e);
    off = e.data_offset + e.comp_size;
  }
  return !out->empty();
}

static bool extract(const Buffer& zip, const Entry& e,
                    std::vector<uint8_t>* out) {
  // e.raw_size comes straight from the (possibly corrupt) archive: bound
  // it BEFORE allocating — a stored entry can't exceed its archive bytes
  // and deflate expands at most ~1032x, so anything past that is garbage
  // (and an unchecked resize of e.g. 2^60 throws bad_alloc, which must
  // not unwind through the C ABI / worker threads).
  if (e.method == 0 && e.raw_size != e.comp_size) return false;
  if (e.raw_size > e.comp_size * 1040 + (1 << 16)) return false;
  try {
    out->resize(e.raw_size);
  } catch (const std::exception&) {
    return false;
  }
  const uint8_t* src = zip.data.data() + e.data_offset;
  if (e.method == 0) {
    memcpy(out->data(), src, e.raw_size);
    return true;
  }
  if (e.method != 8) return false;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;  // raw deflate
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)e.comp_size;
  zs.next_out = out->data();
  zs.avail_out = (uInt)out->size();
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

// ---------------------------------------------------------------------------
// .npy parsing (v1/v2 headers, C-order, common dtypes)
// ---------------------------------------------------------------------------

struct NpyInfo {
  char kind = 'f';       // 'f' float, 'i' int, 'u' uint, 'b' bool
  int itemsize = 4;
  bool little_endian = true;
  bool fortran = false;
  std::vector<int64_t> shape;
  size_t payload_offset = 0;
};

static bool parse_npy_header(const uint8_t* buf, size_t n, NpyInfo* info) {
  if (n < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  int major = buf[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = rd16(buf + 8);
    hoff = 10;
  } else {
    hlen = rd32(buf + 8);
    hoff = 12;
  }
  if (hoff + hlen > n) return false;
  std::string hdr((const char*)(buf + hoff), hlen);
  info->payload_offset = hoff + hlen;

  // descr (every find is bounds-checked: the header may be corrupt)
  size_t dpos = hdr.find("'descr'");
  if (dpos != std::string::npos) {
    size_t colon = hdr.find(':', dpos);
    size_t q1 = colon == std::string::npos ? std::string::npos
                                           : hdr.find('\'', colon);
    size_t q2 = q1 == std::string::npos ? std::string::npos
                                        : hdr.find('\'', q1 + 1);
    if (q2 == std::string::npos) return false;
    std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
    if (descr.empty()) return false;
    size_t i = 0;
    if (descr[i] == '<' || descr[i] == '|') { info->little_endian = true; i++; }
    else if (descr[i] == '>') { info->little_endian = false; i++; }
    if (i >= descr.size()) return false;
    info->kind = descr[i++];
    info->itemsize = atoi(descr.c_str() + i);
    if (info->itemsize <= 0 || info->itemsize > 16) return false;
  }
  info->fortran = hdr.find("'fortran_order': True") != std::string::npos;

  size_t spos = hdr.find("'shape'");
  if (spos == std::string::npos) return false;
  size_t p1 = hdr.find('(', spos);
  size_t p2 = p1 == std::string::npos ? std::string::npos : hdr.find(')', p1);
  if (p2 == std::string::npos) return false;
  std::string tup = hdr.substr(p1 + 1, p2 - p1 - 1);
  const char* s = tup.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    char* end = nullptr;
    long long v = strtoll(s, &end, 10);
    // a token strtoll can't consume means a corrupt header — bail instead
    // of spinning forever on the same character (fuzz-found hang)
    if (end == s || v < 0) return false;
    s = end;
    info->shape.push_back(v);
  }
  return true;
}

static bool to_float32(const uint8_t* payload, const NpyInfo& info,
                       int64_t count, float* out) {
  if (!info.little_endian) return false;  // big-endian unsupported
  if (info.kind == 'f' && info.itemsize == 4) {
    memcpy(out, payload, count * 4);
    return true;
  }
  if (info.kind == 'f' && info.itemsize == 8) {
    const double* p = (const double*)payload;
    for (int64_t i = 0; i < count; i++) out[i] = (float)p[i];
    return true;
  }
  if (info.kind == 'f' && info.itemsize == 2) {  // float16
    const uint16_t* p = (const uint16_t*)payload;
    for (int64_t i = 0; i < count; i++) {
      uint16_t h = p[i];
      uint32_t sign = (h & 0x8000u) << 16;
      uint32_t exp = (h >> 10) & 0x1f;
      uint32_t man = h & 0x3ff;
      uint32_t f;
      if (exp == 0) {
        if (man == 0) f = sign;
        else {  // subnormal
          exp = 127 - 15 + 1;
          while (!(man & 0x400)) { man <<= 1; exp--; }
          man &= 0x3ff;
          f = sign | (exp << 23) | (man << 13);
        }
      } else if (exp == 31) {
        f = sign | 0x7f800000u | (man << 13);
      } else {
        f = sign | ((exp - 15 + 127) << 23) | (man << 13);
      }
      memcpy(&out[i], &f, 4);
    }
    return true;
  }
  if ((info.kind == 'i' || info.kind == 'u') && info.itemsize <= 8) {
    for (int64_t i = 0; i < count; i++) {
      int64_t v = 0;
      memcpy(&v, payload + i * info.itemsize, info.itemsize);
      if (info.kind == 'i' && info.itemsize < 8) {
        int64_t shift = 64 - 8 * info.itemsize;
        v = (v << shift) >> shift;  // sign extend
      }
      out[i] = (float)v;
    }
    return true;
  }
  if (info.kind == 'b' && info.itemsize == 1) {
    for (int64_t i = 0; i < count; i++) out[i] = payload[i] ? 1.f : 0.f;
    return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// normalization (fused, per sample x channel over H*W) — the reference's
// min-max rescale to [-1, 1] with NaN/inf scrubbing
// ---------------------------------------------------------------------------

static void normalize_sample(float* x, int64_t hw, int64_t c) {
  for (int64_t ch = 0; ch < c; ch++) {
    float lo = INFINITY, hi = -INFINITY;
    for (int64_t i = 0; i < hw; i++) {
      float v = x[i * c + ch];
      // numpy nan_to_num semantics first (the reference applies it before
      // the min-max, dataloader.py:18): NaN -> 0, +-inf -> +-FLT_MAX
      if (std::isnan(v)) v = 0.f;
      else if (std::isinf(v)) v = v > 0 ? FLT_MAX : -FLT_MAX;
      x[i * c + ch] = v;
      if (v < lo) lo = v;
      if (v > hi) hi = v;
    }
    // match numpy float32 arithmetic: scale = 2/(hi-lo) applied as
    // -1 + 2*(v-lo)/range, with div-by-zero/overflow scrubbed to 0 after
    float range = hi - lo;  // may overflow to inf, like numpy
    for (int64_t i = 0; i < hw; i++) {
      float v = -1.f + 2.f * (x[i * c + ch] - lo) / range;
      // the reference's post-scrub is nan_to_num (dataloader.py:25): NaN->0,
      // +-inf -> +-FLT_MAX; its subsequent == inf checks are dead code
      // because nan_to_num already made everything finite
      if (std::isnan(v)) v = 0.f;
      else if (std::isinf(v)) v = v > 0 ? FLT_MAX : -FLT_MAX;
      x[i * c + ch] = v;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Read the named member ('data' by default) of one .npz (or a bare .npy)
// into out (float32, C-order).  Returns ndim, fills shape[8]; negative on
// error.  If out is null, only probes the shape.  If src_kind is non-null
// it receives the source dtype kind character ('f', 'i', 'u', 'b') so
// callers can preserve integer-scaling semantics (e.g. uint8 -> /255).
static int npz_read_f32_impl(const char* path, const char* member, float* out,
                             int64_t out_capacity, int64_t* shape,
                             char* src_kind) {
  Buffer zip;
  if (!read_file(path, &zip)) return -1;

  std::vector<uint8_t> raw;
  const uint8_t* npy = nullptr;
  size_t npy_len = 0;

  if (zip.data.size() >= 6 && memcmp(zip.data.data(), "\x93NUMPY", 6) == 0) {
    npy = zip.data.data();
    npy_len = zip.data.size();
  } else {
    std::vector<Entry> entries;
    if (!list_entries(zip, &entries)) return -2;
    std::string want = std::string(member ? member : "data") + ".npy";
    const Entry* pick = nullptr;
    for (const auto& e : entries)
      if (e.name == want) { pick = &e; break; }
    if (!pick && !entries.empty()) pick = &entries[0];
    if (!pick) return -3;
    if (!extract(zip, *pick, &raw)) return -4;
    npy = raw.data();
    npy_len = raw.size();
  }

  NpyInfo info;
  if (!parse_npy_header(npy, npy_len, &info)) return -5;
  if (info.fortran) return -6;
  if (info.shape.size() > 8) return -9;  // shape[8] contract
  if (src_kind) *src_kind = info.kind;
  int64_t count = 1;
  for (size_t i = 0; i < info.shape.size(); i++) {
    shape[i] = info.shape[i];
    count *= info.shape[i];
  }
  int ndim = (int)info.shape.size();
  // the claimed shape must fit the actual payload bytes — checked before
  // the probe return so a corrupt header can neither trigger an
  // out-of-bounds read here nor a giant np.empty on the Python side
  if (info.payload_offset > npy_len) return -5;
  int64_t avail = (int64_t)(npy_len - info.payload_offset);
  if (info.itemsize <= 0 || count > avail / info.itemsize) return -5;
  if (!out) return ndim;
  if (count > out_capacity) return -7;
  if (!to_float32(npy + info.payload_offset, info, count, out)) return -8;
  return ndim;
}

int npz_read_f32_ex(const char* path, const char* member, float* out,
                    int64_t out_capacity, int64_t* shape, char* src_kind) {
  // C++ exceptions must never unwind through the C ABI (UB) or a worker
  // thread body (guaranteed std::terminate) — map them to an error code.
  try {
    return npz_read_f32_impl(path, member, out, out_capacity, shape,
                             src_kind);
  } catch (...) {
    return -10;
  }
}

int npz_read_f32(const char* path, const char* member, float* out,
                 int64_t out_capacity, int64_t* shape) {
  return npz_read_f32_ex(path, member, out, out_capacity, shape, nullptr);
}

// Load n same-shaped samples (HWC each) from npz files in parallel into one
// (n, h, w, c) float32 buffer, optionally applying the reference min-max
// normalization per sample-channel.  Returns 0 on success, else the index
// of the first failing file + 1.
int npz_load_batch_f32(const char** paths, int64_t n, const char* member,
                       float* out, int64_t h, int64_t w, int64_t c,
                       int normalize, int n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  int64_t sample = h * w * c;
  int workers = n_threads > 0 ? n_threads
                              : (int)std::thread::hardware_concurrency();
  if (workers > n) workers = (int)n;
  if (workers < 1) workers = 1;

  auto work = [&]() {
    int64_t shape[8];
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n || err.load()) break;
      float* dst = out + i * sample;
      int ndim = npz_read_f32_ex(paths[i], member, dst, sample, shape, nullptr);
      if (ndim < 0) { err.store((int)i + 1); break; }
      // accept (h, w, c) or (h, w) with c==1
      int64_t got = 1;
      for (int d = 0; d < ndim; d++) got *= shape[d];
      if (got != sample) { err.store((int)i + 1); break; }
      if (normalize) normalize_sample(dst, h * w, c);
    }
  };

  std::vector<std::thread> ts;
  for (int t = 0; t < workers; t++) ts.emplace_back(work);
  for (auto& t : ts) t.join();
  return err.load();
}

// In-place batch normalization of an (n, h, w, c) buffer with a thread pool
// (the bundle-loading path: NaN->0, per-sample-channel min-max -> [-1,1]).
void batch_normalize_f32(float* data, int64_t n, int64_t hw, int64_t c,
                         int n_threads) {
  std::atomic<int64_t> next(0);
  int workers = n_threads > 0 ? n_threads
                              : (int)std::thread::hardware_concurrency();
  if (workers > n) workers = (int)n;
  if (workers < 1) workers = 1;
  auto work = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      normalize_sample(data + i * hw * c, hw, c);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < workers; t++) ts.emplace_back(work);
  for (auto& t : ts) t.join();
}

}  // extern "C"
