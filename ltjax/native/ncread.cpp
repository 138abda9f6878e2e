// Minimal NetCDF3 classic (CDF-1/CDF-2) reader with a C ABI.
//
// Analog of the reference's NetCDF Fortran input layer
// (hydrodynamic_module.f90 initHydro/updateHydro, SURVEY.md SS3.3):
// the streaming input pipeline needs one-record hyperslab reads that
// run OFF the Python GIL so the host prefetch thread genuinely
// overlaps device compute (SURVEY.md SS7.3 item 5).  ctypes calls
// release the GIL, and everything here is plain pread(2) — no libc
// FILE locking, no mmap, thread-safe per handle for reads at
// distinct offsets.
//
// Format reference: the public NetCDF classic format spec (CDF-1:
// 32-bit offsets, CDF-2: 64-bit offsets).  Big-endian on disk.
//
// Build: g++ -O3 -shared -fPIC -o _ltnc.so ncread.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint32_t NC_DIMENSION = 0x0A;
constexpr uint32_t NC_VARIABLE = 0x0B;
constexpr uint32_t NC_ATTRIBUTE = 0x0C;

inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

int type_size(int t) {
  switch (t) {
    case 1: return 1;  // byte
    case 2: return 1;  // char
    case 3: return 2;  // short
    case 4: return 4;  // int
    case 5: return 4;  // float
    case 6: return 8;  // double
  }
  return 0;
}

struct Var {
  std::string name;
  std::vector<int> dimids;
  int type = 0;
  bool record = false;
  int64_t begin = 0;
  int64_t n_per_rec = 0;   // elements per record (or total for non-record)
  int64_t slab_bytes = 0;  // unpadded bytes per record slab
};

struct File {
  int fd = -1;
  int version = 0;
  int64_t numrecs = 0;
  std::vector<int64_t> dimlen;
  std::vector<Var> vars;
  int64_t recsize = 0;  // padded bytes of one whole record
  std::string error;
};

// -- incremental big-endian header reader ----------------------------------
struct Reader {
  int fd;
  int64_t pos = 0;
  bool ok = true;

  explicit Reader(int fd_) : fd(fd_) {}

  bool bytes(void* out, int64_t n) {
    if (!ok) return false;
    int64_t got = 0;
    auto* p = static_cast<char*>(out);
    while (got < n) {
      ssize_t r = pread(fd, p + got, n - got, pos + got);
      if (r <= 0) { ok = false; return false; }
      got += r;
    }
    pos += n;
    return true;
  }
  uint32_t u32() {
    uint32_t v = 0;
    bytes(&v, 4);
    return bswap32(v);
  }
  uint64_t u64() {
    uint64_t v = 0;
    bytes(&v, 8);
    return bswap64(v);
  }
  std::string name() {
    uint32_t n = u32();
    std::string s(n, '\0');
    bytes(s.data(), n);
    int64_t pad = (4 - (n % 4)) % 4;
    pos += pad;
    return s;
  }
  void skip(int64_t n) { pos += n; }
};

void skip_attrs(Reader& r) {
  uint32_t tag = r.u32();
  uint32_t count = r.u32();
  if (tag != NC_ATTRIBUTE && count != 0) { r.ok = false; return; }
  for (uint32_t a = 0; a < count && r.ok; ++a) {
    r.name();
    uint32_t t = r.u32();
    uint32_t n = r.u32();
    int64_t nbytes = (int64_t)n * type_size((int)t);
    r.skip(nbytes + ((4 - (nbytes % 4)) % 4));
  }
}

File* parse(const char* path) {
  auto* f = new File();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { f->error = "open failed"; return f; }
  Reader r(f->fd);
  char magic[4];
  if (!r.bytes(magic, 4) || magic[0] != 'C' || magic[1] != 'D' ||
      magic[2] != 'F' || (magic[3] != 1 && magic[3] != 2)) {
    f->error = "not a CDF-1/CDF-2 file";
    return f;
  }
  f->version = magic[3];
  uint32_t nr = r.u32();
  f->numrecs = (nr == 0xFFFFFFFFu) ? -1 : (int64_t)nr;  // -1 = STREAMING

  // dim_list
  uint32_t tag = r.u32();
  uint32_t ndims = r.u32();
  if (!(tag == NC_DIMENSION || (tag == 0 && ndims == 0))) {
    f->error = "bad dim_list";
    return f;
  }
  for (uint32_t i = 0; i < ndims && r.ok; ++i) {
    r.name();
    f->dimlen.push_back((int64_t)r.u32());  // 0 => record dim
  }
  skip_attrs(r);  // global attributes

  // var_list
  tag = r.u32();
  uint32_t nvars = r.u32();
  if (!(tag == NC_VARIABLE || (tag == 0 && nvars == 0))) {
    f->error = "bad var_list";
    return f;
  }
  int n_record_vars = 0;
  for (uint32_t i = 0; i < nvars && r.ok; ++i) {
    Var v;
    v.name = r.name();
    uint32_t nd = r.u32();
    for (uint32_t d = 0; d < nd; ++d) v.dimids.push_back((int)r.u32());
    skip_attrs(r);
    v.type = (int)r.u32();
    r.u32();  // vsize (unreliable for large vars; recomputed below)
    v.begin = (f->version == 1) ? (int64_t)r.u32() : (int64_t)r.u64();
    v.record = !v.dimids.empty() && f->dimlen[v.dimids[0]] == 0;
    int64_t n = 1;
    for (size_t d = v.record ? 1 : 0; d < v.dimids.size(); ++d)
      n *= f->dimlen[v.dimids[d]];
    v.n_per_rec = n;
    v.slab_bytes = n * type_size(v.type);
    if (v.record) ++n_record_vars;
    f->vars.push_back(std::move(v));
  }
  if (!r.ok) { f->error = "truncated header"; return f; }

  // record size: sum of padded slabs; a SINGLE record var is unpadded
  for (auto& v : f->vars) {
    if (!v.record) continue;
    int64_t padded = (n_record_vars == 1)
                         ? v.slab_bytes
                         : (v.slab_bytes + 3) & ~int64_t(3);
    f->recsize += padded;
  }
  return f;
}

template <typename SRC, typename DST, typename SWAP>
void convert(const char* raw, int64_t n, DST* out, SWAP swp) {
  for (int64_t i = 0; i < n; ++i) {
    SRC v;
    std::memcpy(&v, raw + i * sizeof(SRC), sizeof(SRC));
    v = swp(v);
    out[i] = (DST)v;
  }
}

template <typename DST>
bool read_convert(File* f, const Var& v, int64_t off, int64_t n, DST* out) {
  std::vector<char> raw((size_t)(n * type_size(v.type)));
  int64_t got = 0;
  while (got < (int64_t)raw.size()) {
    ssize_t r = pread(f->fd, raw.data() + got, raw.size() - got, off + got);
    if (r <= 0) return false;
    got += r;
  }
  switch (v.type) {
    case 1:
    case 2: {
      auto* s = reinterpret_cast<const int8_t*>(raw.data());
      for (int64_t i = 0; i < n; ++i) out[i] = (DST)s[i];
      break;
    }
    case 3: {
      for (int64_t i = 0; i < n; ++i) {
        uint16_t u;
        std::memcpy(&u, raw.data() + i * 2, 2);
        u = bswap16(u);
        int16_t s;
        std::memcpy(&s, &u, 2);
        out[i] = (DST)s;
      }
      break;
    }
    case 4: {
      for (int64_t i = 0; i < n; ++i) {
        uint32_t u;
        std::memcpy(&u, raw.data() + i * 4, 4);
        u = bswap32(u);
        int32_t s;
        std::memcpy(&s, &u, 4);
        out[i] = (DST)s;
      }
      break;
    }
    case 5: {
      for (int64_t i = 0; i < n; ++i) {
        uint32_t u;
        std::memcpy(&u, raw.data() + i * 4, 4);
        u = bswap32(u);
        float s;
        std::memcpy(&s, &u, 4);
        out[i] = (DST)s;
      }
      break;
    }
    case 6: {
      for (int64_t i = 0; i < n; ++i) {
        uint64_t u;
        std::memcpy(&u, raw.data() + i * 8, 8);
        u = bswap64(u);
        double s;
        std::memcpy(&s, &u, 8);
        out[i] = (DST)s;
      }
      break;
    }
    default:
      return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* ltnc_open(const char* path) {
  File* f = parse(path);
  if (!f->error.empty() || f->fd < 0) {
    if (f->fd >= 0) close(f->fd);
    delete f;
    return nullptr;
  }
  return f;
}

void ltnc_close(void* h) {
  auto* f = static_cast<File*>(h);
  if (!f) return;
  if (f->fd >= 0) close(f->fd);
  delete f;
}

long long ltnc_numrecs(void* h) { return static_cast<File*>(h)->numrecs; }

int ltnc_num_vars(void* h) {
  return (int)static_cast<File*>(h)->vars.size();
}

// Copies the variable name into out (cap bytes incl. NUL); returns len.
int ltnc_var_name(void* h, int vid, char* out, int cap) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  const auto& s = f->vars[vid].name;
  int n = (int)s.size() < cap - 1 ? (int)s.size() : cap - 1;
  std::memcpy(out, s.data(), n);
  out[n] = '\0';
  return (int)s.size();
}

int ltnc_find_var(void* h, const char* name) {
  auto* f = static_cast<File*>(h);
  for (size_t i = 0; i < f->vars.size(); ++i)
    if (f->vars[i].name == name) return (int)i;
  return -1;
}

int ltnc_var_ndims(void* h, int vid) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  return (int)f->vars[vid].dimids.size();
}

int ltnc_var_isrec(void* h, int vid) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  return f->vars[vid].record ? 1 : 0;
}

// NetCDF external type code (1 byte, 2 char, 3 short, 4 int,
// 5 float, 6 double)
int ltnc_var_type(void* h, int vid) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  return f->vars[vid].type;
}

// shape with the record dim resolved to numrecs
void ltnc_var_shape(void* h, int vid, long long* out) {
  auto* f = static_cast<File*>(h);
  const auto& v = f->vars[vid];
  for (size_t d = 0; d < v.dimids.size(); ++d) {
    int64_t len = f->dimlen[v.dimids[d]];
    out[d] = (d == 0 && v.record) ? f->numrecs : len;
  }
}

// Read one record (rec >= 0, record vars) or the whole variable
// (rec < 0).  out receives float32 (want=0) or float64 (want=1).
// Returns number of elements written, or -1.
long long ltnc_read(void* h, int vid, long long rec, void* out, int want) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  const auto& v = f->vars[vid];
  int64_t n, off;
  if (v.record && rec >= 0) {
    n = v.n_per_rec;
    off = v.begin + rec * f->recsize;
  } else if (!v.record) {
    n = v.n_per_rec;
    off = v.begin;
  } else {  // whole record variable: strided, read record by record
    if (f->numrecs < 0) return -1;
    int64_t total = 0;
    for (int64_t rr = 0; rr < f->numrecs; ++rr) {
      char* dst = static_cast<char*>(out) +
                  (int64_t)v.n_per_rec * rr * (want ? 8 : 4);
      long long w = ltnc_read(h, vid, rr, dst, want);
      if (w < 0) return -1;
      total += w;
    }
    return total;
  }
  bool ok = want ? read_convert<double>(f, v, off, n, (double*)out)
                 : read_convert<float>(f, v, off, n, (float*)out);
  return ok ? n : -1;
}

}  // extern "C"
