// Native host-side decoders for the Colate file formats.
//
// The reference implements this layer as row-of-structs text parsing
// inside relate_lib (src/mutations.cpp:57-257) and record-at-a-time
// fread loops (coal/coal.cpp:2125-2145).  Here the same grammars are
// decoded in one pass into flat columnar buffers that numpy can wrap
// zero-copy — the TPU pipeline consumes columns, never rows.
//
// C ABI only (consumed via ctypes; no pybind11 in this environment).
//
// Columns exposed for a .mut table (cn_mut_col ids):
//   0 snp_id   int64[n]        5 num_branches int64[n]
//   1 pos      int64[n]        6 branch_flat  int32[sum(num_branches)]
//   2 dist     int64[n]        7 branch_off   int64[n+1]
//   3 tree     int64[n]        8 age_begin    float64[n] (strtof parity)
//   4 flipped  int64[n]        9 age_end      float64[n]
//  10 anc_code uint8[n]       13 mtype_off    uint64[n+1]
//  11 der_code uint8[n]       14 rsid_blob    char[]
//  12 valid    uint8[n]       15 rsid_off     uint64[n+1]
//  16 mtype_blob char[]       17 rest_blob    char[]
//  18 rest_off uint64[n+1]    19 header       char[]
//
// anc/der/valid replicate the mode-mut allele validation exactly
// (coal.cpp:2150-2176): valid iff mutation_type is "X/Y" with
// X in {A,C,G,T,0} and Y in {A,C,G,T,1}.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <string>
#include <thread>
#include <vector>
#include <time.h>

#include <zlib.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

struct Blob {
  std::vector<char> data;
  std::vector<uint64_t> off;  // n+1 offsets
  void start() { off.push_back(data.size()); }
  void append(const char* p, size_t n) { data.insert(data.end(), p, p + n); }
  void finish() { off.push_back(data.size()); }
};

struct MutTableC {
  std::vector<int64_t> snp_id, pos, dist, tree, flipped, num_branches;
  std::vector<int32_t> branch_flat;
  std::vector<int64_t> branch_off;
  std::vector<double> age_begin, age_end;
  std::vector<uint8_t> anc_code, der_code, valid;
  Blob mtype, rsid, rest;
  std::string header;
};

// Leave 8 NUL bytes of readable storage past out.size() so
// word-at-a-time scanners may load one u64 straddling the logical end.
inline void pad8(std::vector<char>& out) {
  const size_t n = out.size();
  out.resize(n + 8, '\0');
  out.resize(n);  // shrinking keeps both the capacity and the NULs
}

// Slurp a file through zlib (transparently handles plain and gzip,
// mirroring the reference's .gz fallback at mutations.cpp:263-266).
// The returned buffer always has 8 readable NUL bytes past .size()
// (see pad8) for SWAR scanners.
bool slurp(const char* path, std::vector<char>& out, std::string& err) {
  std::string p = path;
  FILE* probe = fopen(p.c_str(), "rb");
  if (!probe) {
    p += ".gz";
    probe = fopen(p.c_str(), "rb");
    if (!probe) {
      err = "cannot open " + std::string(path);
      return false;
    }
  }
  // plain (non-gzip) files: read in one pass at the stat'd size instead
  // of decompress-probing through zlib with doubling buffers
  unsigned char magic[2] = {0, 0};
  size_t got_magic = fread(magic, 1, 2, probe);
  if (got_magic < 2 || magic[0] != 0x1f || magic[1] != 0x8b) {
    if (fseek(probe, 0, SEEK_END) == 0) {
      long sz = ftell(probe);
      if (sz >= 0 && fseek(probe, 0, SEEK_SET) == 0) {
        out.resize((size_t)sz + 8);  // zero-fills (incl. the future pad)
        size_t n = fread(out.data(), 1, (size_t)sz, probe);
        fclose(probe);
        out.resize(n);
        return true;
      }
    }
  }
  fclose(probe);
  gzFile f = gzopen(p.c_str(), "rb");
  if (!f) {
    err = "gzopen failed: " + p;
    return false;
  }
  gzbuffer(f, 1 << 20);
  out.clear();
  size_t cap = 1 << 22;
  out.resize(cap);
  size_t n = 0;
  for (;;) {
    if (n == out.size()) out.resize(out.size() * 2);
    int got = gzread(f, out.data() + n, (unsigned)(out.size() - n));
    if (got < 0) {
      err = "gzread error: " + p;
      gzclose(f);
      return false;
    }
    if (got == 0) break;
    n += (size_t)got;
  }
  gzclose(f);
  out.resize(n);
  pad8(out);
  return true;
}

// SWAR byte-match: high bit set in every byte of x that is zero
// (x = word XOR broadcast(delim) -> matches of delim).
inline uint64_t zbyte_mask(uint64_t x) {
  return (x - 0x0101010101010101ULL) & ~x & 0x8080808080808080ULL;
}

}  // namespace

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Zero-copy read-only view of a file.  Page-cached inputs cost nothing
// (the fread slurp moves ~1.3 GB/s on this class of host — a quarter of
// the whole parse budget at genome scale).  The file pages are mapped
// over an anonymous reservation one page larger, so there are ALWAYS
// >= 8 readable zero bytes past data+size for SWAR scanners, whatever
// the file length.  gzip inputs (and any mmap failure) fall back to the
// padded slurp.
struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  bool ok = false;
  void* map_ = nullptr;
  size_t maplen_ = 0;
  std::vector<char> fb_;

  ~MappedFile() {
    if (map_) munmap(map_, maplen_);
  }
  MappedFile() = default;
  MappedFile(const MappedFile&) = delete;
  MappedFile& operator=(const MappedFile&) = delete;

  bool open(const char* path, std::string& err) {
    std::string p = path;
    int fd = ::open(p.c_str(), O_RDONLY);
    if (fd < 0) {
      p += ".gz";  // the reference's .gz fallback (mutations.cpp:263-266)
      fd = ::open(p.c_str(), O_RDONLY);
      if (fd < 0) {
        err = "cannot open " + std::string(path);
        return false;
      }
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode)) {
      close(fd);
      return slurp_fallback(path, err);
    }
    const size_t sz = (size_t)st.st_size;
    if (sz == 0) {
      close(fd);
      fb_.assign(8, '\0');
      fb_.resize(0);
      data = fb_.data();
      size = 0;
      ok = true;
      return true;
    }
    const size_t pg = 4096;
    const size_t len = ((sz + pg - 1) / pg) * pg;
    char* a = (char*)mmap(nullptr, len + pg, PROT_READ,
                          MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (a == MAP_FAILED) {
      close(fd);
      return slurp_fallback(path, err);
    }
    char* m = (char*)mmap(a, len, PROT_READ, MAP_SHARED | MAP_FIXED, fd, 0);
    close(fd);
    if (m == MAP_FAILED) {
      munmap(a, len + pg);
      return slurp_fallback(path, err);
    }
    // NOTE: no MADV_SEQUENTIAL — its drop-behind frees the pages right
    // after access, making every re-read of a fixture cold again
    if (sz >= 2 && (uint8_t)m[0] == 0x1f && (uint8_t)m[1] == 0x8b) {
      // gzip payload: decode through the slurp path instead
      munmap(a, len + pg);
      return slurp_fallback(path, err);
    }
    map_ = a;
    maplen_ = len + pg;
    data = m;
    size = sz;
    ok = true;
    return true;
  }

  bool slurp_fallback(const char* path, std::string& err) {
    if (!slurp(path, fb_, err)) return false;
    data = fb_.data();
    size = fb_.size();
    ok = true;
    return true;
  }
};

inline bool anc_ok(char c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T' || c == '0';
}
inline bool der_ok(char c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T' || c == '1';
}

// SWAR decimal: value of the L leading bytes of w (first char in the
// lowest byte), false if any of them is not a digit.  The three
// mask-multiply reduction steps are the classic 8-digit trick
// (public-domain simdjson/Lemire formulation); shorter runs left-pad
// with zero digits by shifting.
inline bool swar_try_digits(uint64_t w, int L, uint32_t* out) {
  const uint64_t lowmask = L >= 8 ? ~0ULL : ((1ULL << (8 * L)) - 1);
  const uint64_t d = (w ^ 0x3030303030303030ULL) & lowmask;  // '0'..'9' -> 0..9
  if (((d + 0x7676767676767676ULL) | d) & 0x8080808080808080ULL) return false;
  uint64_t v = d << (64 - 8 * (uint64_t)L);
  v = (v * 2561) >> 8;
  v = ((v & 0x00FF00FF00FF00FFULL) * 6553601) >> 16;
  *out = (uint32_t)(((v & 0x0000FFFF0000FFFFULL) * 42949672960001ULL) >> 32);
  return true;
}

const int64_t kP10I[9] = {1,      10,      100,      1000,     10000,
                          100000, 1000000, 10000000, 100000000};

// delimiter-bounded integer parse.  Callers pass fields inside slurp or
// MappedFile buffers, both of which guarantee >=8 readable bytes past
// the data end (slurp pads; MappedFile maps a zero guard page), so the
// 8-byte loads never fault; any non-digit byte falls back to the
// byte loop with identical stop-at-non-digit semantics.
inline int64_t parse_i64(const char* b, const char* e) {
  bool neg = false;
  if (b < e && (*b == '-' || *b == '+')) neg = (*b++ == '-');
  int64_t v = 0;
  int64_t L = e - b;
  uint32_t d;
  uint64_t w;
  while (L >= 8) {
    memcpy(&w, b, 8);
    if (!swar_try_digits(w, 8, &d)) goto tail;
    v = v * 100000000 + d;
    b += 8;
    L -= 8;
  }
  if (L > 0) {
    memcpy(&w, b, 8);
    if (swar_try_digits(w, (int)L, &d)) {
      v = v * kP10I[L] + d;
      b = e;
    }
  }
tail:
  while (b < e && *b >= '0' && *b <= '9') v = v * 10 + (*b++ - '0');
  return neg ? -v : v;
}

// Clinger fast path for decimal → float32: when the mantissa has ≤7
// digits (exact in float) and the fractional scale is ≤1e10 (exact in
// float), a single IEEE float division gives the correctly-rounded
// result — bit-identical to glibc strtof, which the reference's
// std::stof uses (mutations.cpp:150-152).  Anything else (scientific
// notation, hex, long mantissas) falls back to strtof.
const float kP10F[11] = {1e0f, 1e1f, 1e2f, 1e3f, 1e4f, 1e5f,
                         1e6f, 1e7f, 1e8f, 1e9f, 1e10f};

inline float fast_strtof(const char* b, const char* e, bool& ok) {
  // SWAR "[digits][.digits]" matcher: one 8-byte load finds the integer
  // digit run, a second reads the fraction; anything else (scientific,
  // hex, >7 digits, stray characters) falls back to strtof, which
  // produces the identical value for every input the old byte loop
  // accepted (Clinger: one correctly-rounded division).
  const char* q = b;
  bool neg = false;
  if (q < e && (*q == '-' || *q == '+')) neg = (*q++ == '-');
  const int64_t L = e - q;
  if (L <= 0 || L > 15) {
    ok = false;
    return 0;
  }
  uint64_t w;
  memcpy(&w, q, 8);
  const uint64_t d = w ^ 0x3030303030303030ULL;
  const uint64_t nd =
      ((d + 0x7676767676767676ULL) | d) & 0x8080808080808080ULL;
  int run1 = nd ? (__builtin_ctzll(nd) >> 3) : 8;
  if (run1 > L) run1 = (int)L;
  uint32_t ip = 0, fp = 0;
  int frac = 0;
  if (run1 == (int)L) {  // pure integer
    if (run1 == 0 || run1 > 7) {
      ok = false;
      return 0;
    }
    swar_try_digits(w, run1, &ip);
  } else if (q[run1] == '.') {
    const char* fq = q + run1 + 1;
    frac = (int)(e - fq);
    if (frac < 1 || run1 + frac > 7) {
      ok = false;
      return 0;
    }
    uint64_t w2;
    memcpy(&w2, fq, 8);
    if (run1 && !swar_try_digits(w, run1, &ip)) {
      ok = false;
      return 0;
    }
    if (!swar_try_digits(w2, frac, &fp)) {
      ok = false;
      return 0;
    }
  } else {
    ok = false;
    return 0;
  }
  ok = true;
  const uint64_t m = (uint64_t)ip * (uint64_t)kP10I[frac] + fp;
  float v = (float)m / kP10F[frac];
  return neg ? -v : v;
}

inline double parse_age(const char* b, const char* e) {
  bool ok;
  float v = fast_strtof(b, e, ok);
  return (double)(ok ? v : strtof(b, nullptr));
}

#if defined(__x86_64__)
static inline bool cpu_has_avx512bw() {
  static const bool ok = __builtin_cpu_supports("avx512bw");
  return ok;
}

// one 64-byte block's ';'/'\n' bitmasks (bit i = byte q[i] matches);
// returns the combined mask, *nl the newline-only mask
__attribute__((target("avx512bw"))) static uint64_t delim_mask64(
    const char* q, uint64_t* nl) {
  const __m512i v = _mm512_loadu_si512((const void*)q);
  *nl = (uint64_t)_mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('\n'));
  return (uint64_t)_mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8(';')) | *nl;
}

// shared AVX-512 delimiter-walk skeleton: walks the ';'/'\n' masks over
// [p, end-64], assembling per-row field pointers f[0..11]; calls
// emit(f, nf, row_end) per non-empty row (returning false stops the
// walk as failure) and tail(rs, end) once for the in-flight row plus
// the last <=64 bytes (loads are always in-bounds before that).
template <class Emit, class Tail>
__attribute__((target("avx512bw"))) static bool delim_rows_avx512(
    const char* p, const char* end, Emit&& emit, Tail&& tail) {
  const char* const stop = end - 64;
  const char* f[12];
  int nf = 0;
  const char* rs = p;
  f[0] = rs;
  const char* q = p;
  uint64_t mnl;
  uint64_t m = delim_mask64(q, &mnl);
  for (;;) {
    while (m == 0) {
      q += 64;
      if (q > stop) return tail(rs, end);
      m = delim_mask64(q, &mnl);
    }
    const int b = __builtin_ctzll(m);
    m &= m - 1;
    const char* c = q + b;
    if ((mnl >> b) & 1) {
      if (c != rs && !emit(f, nf, c)) return false;
      rs = c + 1;
      nf = 0;
      f[0] = rs;
    } else if (nf < 11) {
      f[++nf] = c + 1;
    }
  }
}
#endif  // __x86_64__

// one .mut row given its field starts f[0..nf] and line end e.  f[i]
// points just past the i-th ';'; nf is capped at 11, so f[11]-1 is the
// ';' that terminates the mutation_type field (field 10).
static bool mut_emit_row(const char* const* f, int nf, const char* e,
                         const char* bufbase, MutTableC* t,
                         std::string& err) {
  if (nf < 11) {
    err = "short .mut row at byte " + std::to_string((long)(f[0] - bufbase));
    return false;
  }
  t->snp_id.push_back(parse_i64(f[0], f[1] - 1));
  t->pos.push_back(parse_i64(f[1], f[2] - 1));
  t->dist.push_back(parse_i64(f[2], f[3] - 1));
  t->rsid.start();
  t->rsid.append(f[3], f[4] - 1 - f[3]);
  t->tree.push_back(parse_i64(f[4], f[5] - 1));
  // branch: space-separated ints
  {
    const char* b = f[5];
    const char* be = f[6] - 1;
    int64_t cnt = 0;
    while (b < be) {
      while (b < be && (*b == ' ' || *b == '\t')) b++;
      if (b >= be) break;
      const char* s = b;
      while (b < be && *b != ' ' && *b != '\t') b++;
      t->branch_flat.push_back((int32_t)parse_i64(s, b));
      cnt++;
    }
    t->num_branches.push_back(cnt);
    t->branch_off.push_back((int64_t)t->branch_flat.size());
  }
  // f[6] = is_not_mapping (ignored, like the reference parser)
  t->flipped.push_back(parse_i64(f[7], f[8] - 1));
  // ages as float32 like the reference's std::stof; Clinger fast path
  // with in-place strtof fallback (fields are ';'-terminated and never
  // last-on-line, so strtof stops at the ';')
  t->age_begin.push_back(parse_age(f[8], f[9] - 1));
  t->age_end.push_back(parse_age(f[9], f[10] - 1));
  // mutation_type: field 10, terminated by the 11th ';' (guaranteed by
  // the nf >= 11 guard above); everything after it is `rest`
  {
    const char* m = f[10];
    const char* me = f[11] - 1;
    t->mtype.start();
    t->mtype.append(m, me - m);
    size_t len = (size_t)(me - m);
    uint8_t v = (len == 3 && m[1] == '/' && anc_ok(m[0]) && der_ok(m[2]));
    t->valid.push_back(v);
    t->anc_code.push_back(v ? (uint8_t)m[0] : 0);
    t->der_code.push_back(v ? (uint8_t)m[2] : 0);
    t->rest.start();
    if (f[11] < e) t->rest.append(f[11], e - f[11]);
  }
  return true;
}

// scalar (memchr) row loop — the portable path and the tail handler
// behind the AVX-512 front-end
static bool parse_mut_rows_scalar(const char* p, const char* end,
                                  const char* bufbase, MutTableC* t,
                                  std::string& err) {
  const char* f[12];  // starts of fields 0..11 (nf capped at 11)
  while (p < end) {
    const char* e = (const char*)memchr(p, '\n', end - p);
    if (!e) e = end;
    if (e == p) {
      p = e + 1;
      continue;
    }
    int nf = 0;
    f[0] = p;
    const char* q = p;
    while (nf < 11 && q < e) {
      const char* s = (const char*)memchr(q, ';', e - q);
      if (!s) break;
      f[++nf] = s + 1;
      q = s + 1;
    }
    if (!mut_emit_row(f, nf, e, bufbase, t, err)) return false;
    p = e + 1;
  }
  return true;
}

#if defined(__x86_64__)
// AVX-512 front-end: the shared block-mask walk (delim_rows_avx512)
// with the .mut row body; the in-flight row plus the last <=64 bytes
// hand off to the scalar loop
static bool parse_mut_rows_avx512(const char* p, const char* end,
                                  const char* bufbase, MutTableC* t,
                                  std::string& err) {
  return delim_rows_avx512(
      p, end,
      [&](const char* const* f, int nf, const char* e) {
        return mut_emit_row(f, nf, e, bufbase, t, err);
      },
      [&](const char* rs, const char* e2) {
        return parse_mut_rows_scalar(rs, e2, bufbase, t, err);
      });
}

#endif  // __x86_64__

bool parse_mut_range(const char* p, const char* end, const char* bufbase,
                     MutTableC* t, std::string& err) {
  size_t nlines = (size_t)(end - p) / 48 + 4;  // lower-bound row estimate
  t->snp_id.reserve(nlines);
  t->pos.reserve(nlines);
  t->dist.reserve(nlines);
  t->tree.reserve(nlines);
  t->flipped.reserve(nlines);
  t->num_branches.reserve(nlines);
  t->branch_off.reserve(nlines + 1);
  t->age_begin.reserve(nlines);
  t->age_end.reserve(nlines);
  t->anc_code.reserve(nlines);
  t->der_code.reserve(nlines);
  t->valid.reserve(nlines);
  t->branch_off.push_back(0);

  bool ok;
#if defined(__x86_64__)
  if (cpu_has_avx512bw() && end - p > 256)
    ok = parse_mut_rows_avx512(p, end, bufbase, t, err);
  else
#endif
    ok = parse_mut_rows_scalar(p, end, bufbase, t, err);
  if (!ok) return false;
  t->rsid.finish();
  t->mtype.finish();
  t->rest.finish();
  return true;
}

// append src's finished blob onto dst (offset rebasing)
void merge_blob(Blob& dst, const Blob& src, bool first) {
  if (first) {
    dst = src;
    return;
  }
  uint64_t base = dst.data.size();
  dst.data.insert(dst.data.end(), src.data.begin(), src.data.end());
  for (size_t i = 1; i < src.off.size(); i++)
    dst.off.push_back(src.off[i] + base);
}

}  // namespace

extern "C" {

void* cn_mut_read(const char* path, char* errbuf, int errlen) {
  std::string err;
  std::vector<char> buf;
  if (!slurp(path, buf, err)) {
    snprintf(errbuf, errlen, "%s", err.c_str());
    return nullptr;
  }
  const char* p = buf.data();
  const char* end = p + buf.size();
  // header line
  const char* nl = (const char*)memchr(p, '\n', end - p);
  if (!nl) {
    snprintf(errbuf, errlen, "empty .mut file: %s", path);
    return nullptr;
  }
  std::string header(p, (size_t)(nl - p));
  p = nl + 1;

  // split the body at line boundaries and parse in parallel — the text
  // grammar is per-line (mutations.cpp:57-257), so ranges are independent
  size_t total = (size_t)(end - p);
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 8) nt = 8;
  if (total < (1u << 20)) nt = 1;
  std::vector<const char*> bnd{p};
  for (unsigned i = 1; i < nt; i++) {
    const char* q = p + total * i / nt;
    if (q <= bnd.back()) q = bnd.back();
    const char* e = (const char*)memchr(q, '\n', end - q);
    q = e ? e + 1 : end;
    if (q > bnd.back() && q < end) bnd.push_back(q);
  }
  bnd.push_back(end);
  size_t nw = bnd.size() - 1;
  std::vector<MutTableC> parts(nw);
  std::vector<std::string> errs(nw);
  std::vector<char> ok(nw, 1);
  {
    std::vector<std::thread> th;
    for (size_t w = 0; w < nw; w++)
      th.emplace_back([&, w] {
        ok[w] = parse_mut_range(bnd[w], bnd[w + 1], buf.data(), &parts[w],
                                errs[w]);
      });
    for (auto& x : th) x.join();
  }
  for (size_t w = 0; w < nw; w++)
    if (!ok[w]) {
      snprintf(errbuf, errlen, "%s", errs[w].c_str());
      return nullptr;
    }

  auto* t = new MutTableC();
  t->header = header;
  if (nw == 1) {
    *t = std::move(parts[0]);
    t->header = header;
    return t;
  }
  auto cat = [](auto& dst, auto& src) {
    dst.insert(dst.end(), src.begin(), src.end());
  };
  for (size_t w = 0; w < nw; w++) {
    auto& s = parts[w];
    int64_t bbase = (int64_t)t->branch_flat.size();
    cat(t->snp_id, s.snp_id);
    cat(t->pos, s.pos);
    cat(t->dist, s.dist);
    cat(t->tree, s.tree);
    cat(t->flipped, s.flipped);
    cat(t->num_branches, s.num_branches);
    cat(t->branch_flat, s.branch_flat);
    if (w == 0) {
      t->branch_off = std::move(s.branch_off);
    } else {
      for (size_t i = 1; i < s.branch_off.size(); i++)
        t->branch_off.push_back(s.branch_off[i] + bbase);
    }
    cat(t->age_begin, s.age_begin);
    cat(t->age_end, s.age_end);
    cat(t->anc_code, s.anc_code);
    cat(t->der_code, s.der_code);
    cat(t->valid, s.valid);
    merge_blob(t->mtype, s.mtype, w == 0);
    merge_blob(t->rsid, s.rsid, w == 0);
    merge_blob(t->rest, s.rest, w == 0);
  }
  return t;
}

int64_t cn_mut_n(void* h) { return (int64_t)((MutTableC*)h)->pos.size(); }

void* cn_mut_col(void* h, int col, int64_t* nbytes) {
  auto* t = (MutTableC*)h;
  auto ret = [&](void* p, size_t nb) {
    *nbytes = (int64_t)nb;
    return p;
  };
  switch (col) {
    case 0: return ret(t->snp_id.data(), t->snp_id.size() * 8);
    case 1: return ret(t->pos.data(), t->pos.size() * 8);
    case 2: return ret(t->dist.data(), t->dist.size() * 8);
    case 3: return ret(t->tree.data(), t->tree.size() * 8);
    case 4: return ret(t->flipped.data(), t->flipped.size() * 8);
    case 5: return ret(t->num_branches.data(), t->num_branches.size() * 8);
    case 6: return ret(t->branch_flat.data(), t->branch_flat.size() * 4);
    case 7: return ret(t->branch_off.data(), t->branch_off.size() * 8);
    case 8: return ret(t->age_begin.data(), t->age_begin.size() * 8);
    case 9: return ret(t->age_end.data(), t->age_end.size() * 8);
    case 10: return ret(t->anc_code.data(), t->anc_code.size());
    case 11: return ret(t->der_code.data(), t->der_code.size());
    case 12: return ret(t->valid.data(), t->valid.size());
    case 13: return ret(t->mtype.off.data(), t->mtype.off.size() * 8);
    case 14: return ret(t->rsid.data.data(), t->rsid.data.size());
    case 15: return ret(t->rsid.off.data(), t->rsid.off.size() * 8);
    case 16: return ret(t->mtype.data.data(), t->mtype.data.size());
    case 17: return ret(t->rest.data.data(), t->rest.data.size());
    case 18: return ret(t->rest.off.data(), t->rest.off.size() * 8);
    case 19: return ret((void*)t->header.data(), t->header.size());
    default: break;
  }
  *nbytes = -1;
  return nullptr;
}

void cn_mut_free(void* h) { delete (MutTableC*)h; }

// ---------------------------------------------------------------------------
// .colate.in binary site stream (record layout coal/coal.cpp:2503-2515)
// ---------------------------------------------------------------------------

struct ColateInC {
  std::vector<int32_t> bp, aaf, daf;
  std::vector<uint8_t> anc, der;
  Blob names;                    // one entry per chromosome run
  std::vector<int64_t> run_len;  // records per run
};

void* cn_colatein_read(const char* path, char* errbuf, int errlen) {
  std::string err;
  std::vector<char> buf;
  if (!slurp(path, buf, err)) {
    snprintf(errbuf, errlen, "%s", err.c_str());
    return nullptr;
  }
  auto* t = new ColateInC();
  const char* p = buf.data();
  const char* end = p + buf.size();
  std::string cur;
  int64_t cur_n = 0;
  while (p + 4 <= end) {
    int32_t lchrom;
    memcpy(&lchrom, p, 4);
    if (lchrom <= 0 || lchrom > 1023 || p + 4 + lchrom + 14 > end) break;
    const char* name = p + 4;
    p += 4 + lchrom;
    int32_t bp_, aaf_, daf_;
    memcpy(&bp_, p, 4);
    uint8_t anc_ = (uint8_t)p[4];
    uint8_t der_ = (uint8_t)p[5];
    memcpy(&aaf_, p + 6, 4);
    memcpy(&daf_, p + 10, 4);
    p += 14;
    if ((int64_t)cur.size() != lchrom || memcmp(cur.data(), name, lchrom)) {
      if (cur_n) {
        t->names.start();
        t->names.append(cur.data(), cur.size());
        t->run_len.push_back(cur_n);
      }
      cur.assign(name, lchrom);
      cur_n = 0;
    }
    t->bp.push_back(bp_);
    t->anc.push_back(anc_);
    t->der.push_back(der_);
    t->aaf.push_back(aaf_);
    t->daf.push_back(daf_);
    cur_n++;
  }
  if (cur_n) {
    t->names.start();
    t->names.append(cur.data(), cur.size());
    t->run_len.push_back(cur_n);
  }
  t->names.finish();
  return t;
}

int64_t cn_colatein_n(void* h) { return (int64_t)((ColateInC*)h)->bp.size(); }

void* cn_colatein_col(void* h, int col, int64_t* nbytes) {
  auto* t = (ColateInC*)h;
  auto ret = [&](void* p, size_t nb) {
    *nbytes = (int64_t)nb;
    return p;
  };
  switch (col) {
    case 0: return ret(t->bp.data(), t->bp.size() * 4);
    case 1: return ret(t->anc.data(), t->anc.size());
    case 2: return ret(t->der.data(), t->der.size());
    case 3: return ret(t->aaf.data(), t->aaf.size() * 4);
    case 4: return ret(t->daf.data(), t->daf.size() * 4);
    case 5: return ret(t->run_len.data(), t->run_len.size() * 8);
    case 6: return ret(t->names.data.data(), t->names.data.size());
    case 7: return ret(t->names.off.data(), t->names.off.size() * 8);
    default: break;
  }
  *nbytes = -1;
  return nullptr;
}

void cn_colatein_free(void* h) { delete (ColateInC*)h; }

// ---------------------------------------------------------------------------
// tmptmp join: the mode-mut hot loop over precomputed site streams
// (reference coal/coal.cpp:2071-2321).  Python pre-filters the .mut rows
// (flips/branches/ages/alleles/masks — coal.cpp:2150-2176) and passes the
// survivors; this walks both record streams with the reference's exact
// consumed-record cursor semantics and emits per-site weights.
// ---------------------------------------------------------------------------

namespace {

struct JoinOutC {
  std::vector<double> ab, ae, ws, wn, wsm, wnm;
  std::vector<int32_t> blk;
  int64_t num_blocks = 0;
};

struct StreamCur {
  const int32_t *bp, *aaf, *daf;
  const uint8_t *anc, *der;
  int64_t n;
  const char* name_blob;
  const int64_t* name_off;   // nr+1
  const int64_t* run_start;  // nr+1 record indices
  int64_t nr;
  int64_t idx = -1;  // last-read record
  int64_t run = 0;

  bool name_is(const char* c, size_t cl) const {
    if (idx < 0) return false;
    int64_t l = name_off[run + 1] - name_off[run];
    return (int64_t)cl == l && memcmp(name_blob + name_off[run], c, l) == 0;
  }
  bool read() {
    if (idx + 1 >= n) return false;
    idx++;
    while (run + 1 < nr && idx >= run_start[run + 1]) run++;
    return true;
  }
};

}  // namespace

void* cn_join_tmptmp(
    int n_chr, const char* chrom_blob, const int64_t* chrom_off,
    const int64_t* m_off, const int64_t* m_pos, const double* m_ab,
    const double* m_ae, const uint8_t* m_anc, const uint8_t* m_der,
    const int32_t* t_bp, const uint8_t* t_anc, const uint8_t* t_der,
    const int32_t* t_aaf, const int32_t* t_daf, int64_t t_n,
    const char* t_names, const int64_t* t_name_off, const int64_t* t_runs,
    int64_t t_nr,
    const int32_t* r_bp, const uint8_t* r_anc, const uint8_t* r_der,
    const int32_t* r_aaf, const int32_t* r_daf, int64_t r_n,
    const char* r_names, const int64_t* r_name_off, const int64_t* r_runs,
    int64_t r_nr, double ref_age, int64_t num_bases_per_block) {
  auto* out = new JoinOutC();
  StreamCur tgt{t_bp, t_aaf, t_daf, t_anc, t_der, t_n,
                t_names, t_name_off, t_runs, t_nr};
  StreamCur ref{r_bp, r_aaf, r_daf, r_anc, r_der, r_n,
                r_names, r_name_off, r_runs, r_nr};
  int64_t num_blocks = 0;

  for (int c = 0; c < n_chr; c++) {
    const char* chrom = chrom_blob + chrom_off[c];
    size_t cl = (size_t)(chrom_off[c + 1] - chrom_off[c]);
    // chromosome scan (coal.cpp:2125-2146): consume until name matches
    while (!ref.name_is(chrom, cl))
      if (!ref.read()) break;
    while (!tgt.name_is(chrom, cl))
      if (!tgt.read()) break;

    int64_t current_block_base = 0;
    for (int64_t i = m_off[c]; i < m_off[c + 1]; i++) {
      int64_t pos = m_pos[i];
      // --- reference stream (coal.cpp:2183-2199) ---
      int32_t DAF_ref = 0, AAF_ref = 0;
      while (ref.name_is(chrom, cl) && ref.bp[ref.idx] < pos) {
        if (!ref.read()) break;
        AAF_ref = ref.aaf[ref.idx];
        DAF_ref = ref.daf[ref.idx];
      }
      bool use = ref.name_is(chrom, cl) && ref.bp[ref.idx] == pos &&
                 ref.anc[ref.idx] == m_anc[i] && ref.der[ref.idx] == m_der[i];
      if (DAF_ref == 0) use = false;
      int32_t N_ref = DAF_ref + AAF_ref;
      if (!use) continue;
      // --- target stream (coal.cpp:2201-2222) ---
      int32_t DAF_t = 0, AAF_t = 0;
      while (tgt.name_is(chrom, cl) && tgt.bp[tgt.idx] < pos) {
        if (!tgt.read()) break;
        AAF_t = tgt.aaf[tgt.idx];
        DAF_t = tgt.daf[tgt.idx];
      }
      use = tgt.name_is(chrom, cl) && tgt.bp[tgt.idx] == pos &&
            tgt.anc[tgt.idx] == m_anc[i] && tgt.der[tgt.idx] == m_der[i];
      int32_t N_t = DAF_t + AAF_t;
      if (N_t == 0) use = false;
      if (!use) continue;

      while (current_block_base + num_bases_per_block < pos) {
        current_block_base += num_bases_per_block;
        num_blocks++;
      }
      // pseudo-diploid rounding in float (coal.cpp:2236-2242)
      float f_DAF = (float)DAF_t, f_AAF = (float)AAF_t;
      f_DAF = (float)(f_DAF / (N_t / 2.0));
      f_AAF = (float)(f_AAF / (N_t / 2.0));
      f_DAF = std::round(f_DAF);
      f_AAF = std::round(f_AAF);
      double ab = m_ab[i] < ref_age ? ref_age : m_ab[i];
      out->ab.push_back(ab);
      out->ae.push_back(m_ae[i]);
      out->ws.push_back((double)f_DAF * DAF_ref / (double)N_ref);
      out->wn.push_back((double)f_AAF * DAF_ref / (double)N_ref);
      out->wsm.push_back((double)f_DAF * DAF_ref / ((double)N_ref * 100.0));
      out->wnm.push_back((double)f_AAF * DAF_ref / ((double)N_ref * 100.0));
      out->blk.push_back((int32_t)num_blocks);
    }
    num_blocks++;  // end-of-chromosome block boundary (coal.cpp:2307-2312)
  }
  out->num_blocks = num_blocks;
  return out;
}

int64_t cn_join_n(void* h) { return (int64_t)((JoinOutC*)h)->ab.size(); }

int64_t cn_join_num_blocks(void* h) { return ((JoinOutC*)h)->num_blocks; }

void* cn_join_col(void* h, int col, int64_t* nbytes) {
  auto* t = (JoinOutC*)h;
  auto ret = [&](void* p, size_t nb) {
    *nbytes = (int64_t)nb;
    return p;
  };
  switch (col) {
    case 0: return ret(t->ab.data(), t->ab.size() * 8);
    case 1: return ret(t->ae.data(), t->ae.size() * 8);
    case 2: return ret(t->ws.data(), t->ws.size() * 8);
    case 3: return ret(t->wn.data(), t->wn.size() * 8);
    case 4: return ret(t->wsm.data(), t->wsm.size() * 8);
    case 5: return ret(t->wnm.data(), t->wnm.size() * 8);
    case 6: return ret(t->blk.data(), t->blk.size() * 4);
    default: break;
  }
  *nbytes = -1;
  return nullptr;
}

void cn_join_free(void* h) { delete (JoinOutC*)h; }

// ---------------------------------------------------------------------------
// Analytic age-bin histograms: the exact expectation of the reference's
// 100-draw Monte-Carlo binning (coal/coal.cpp:2244-2298), accumulated in
// O(sites) with range-adds over bin edges + one prefix-sum per block.
//
// For a site with age interval [ab, ae] the per-bin mass is the overlap
// of the uniform draw with each log-age bin; the cumulative mass at edge
// e is piecewise linear in e with at most two breakpoints, so each site
// contributes three range-adds (slope, slope*offset, constant) into
// per-block difference arrays.  A final prefix-sum over the 186 edges
// reconstructs the cumulative curve G and hist[k] = G[k+1]-G[k].
// Semantics match pipeline/binning.py:bin_sites_analytic (the JAX device
// path, kept for mesh-sharded runs); that implementation works in f32,
// this one in f64 — tests compare the two within tolerance.
// ---------------------------------------------------------------------------

void cn_bin_analytic(
    int64_t n, const double* ab, const double* ae, const double* ws,
    const double* wn, const int32_t* blk, int64_t num_blocks, int nbins,
    const double* edges /* nbins+1 */, double age, double bin_c,
    double* shared, double* notshared, double* shared_emp,
    double* notshared_emp /* each [num_blocks * nbins], zeroed by caller */) {
  const int ne = nbins + 1;          // edge count
  const int nd = nbins + 2;          // diff-array length (hi index may be ne)
  const double e_last = edges[nbins];
  const char* names[6] = {};
  (void)names;
  std::vector<double> d(6 * (size_t)num_blocks * nd, 0.0);
  auto D = [&](int arr, int64_t b) {
    return d.data() + ((size_t)arr * num_blocks + b) * nd;
  };
  // arr 0/1/2: shared slope / slope*offset / const
  // arr 3/4/5: notshared slope / slope*offset / const
  const double* eb = edges;
  const double* ee = edges + ne;
  // edges follow exp((b-1.5)/C)/10 (config.age_bin_edges), so the edge
  // rank of x is ~log(10x)*C+1.5; seed the search there and fix up with
  // exact comparisons — identical results to the binary searches at a
  // fraction of the branches (the fixup loop runs 0-2 steps).
  const double inv_lc = bin_c;
  auto upper_edge = [&](double x) -> int {  // first edge > x
    int g = 0;
    if (x > 0) {
      double t = std::log(10.0 * x) * inv_lc + 2.5;
      g = t < 0 ? 0 : (t > (double)ne ? ne : (int)t);
    }
    while (g < ne && eb[g] <= x) g++;
    while (g > 0 && eb[g - 1] > x) g--;
    return g;
  };
  auto lower_edge = [&](double x) -> int {  // first edge >= x
    int g = 0;
    if (x > 0) {
      double t = std::log(10.0 * x) * inv_lc + 2.5;
      g = t < 0 ? 0 : (t > (double)ne ? ne : (int)t);
    }
    while (g < ne && eb[g] < x) g++;
    while (g > 0 && eb[g - 1] >= x) g--;
    return g;
  };

  for (int64_t i = 0; i < n; i++) {
    const double a0 = ab[i], a1 = ae[i];
    const double width = a1 - a0;
    if (!(width > 0)) continue;
    const int64_t b = blk[i];
    if (b < 0 || b >= num_blocks) continue;
    if (a0 <= age) {
      // --- emp site (coal.cpp:2249-2256): shared/notshared mass into the
      // emp matrices keyed by bin(age_end); notshared also distributed by
      // the clamped-CDF law T = max(U[a0,a1], age) ---
      int bin2 = 0;
      if (a1 > 0) {
        long v = (long)std::floor(std::log(10.0 * a1) * bin_c + 0.5) + 1;
        bin2 = v < 0 ? 0 : (v > nbins - 1 ? nbins - 1 : (int)v);
      }
      shared_emp[b * nbins + bin2] += ws[i];
      notshared_emp[b * nbins + bin2] += wn[i];

      const double w = wn[i];
      const double s = w / width;
      int e_lo = upper_edge(a0);
      int e_hi = lower_edge(a1);
      int e_age = upper_edge(age);
      int lo2 = e_lo > e_age ? e_lo : e_age;
      int hi2 = e_hi > e_age ? e_hi : e_age;
      double* Ds = D(3, b);
      double* Do = D(4, b);
      double* Dc = D(5, b);
      if (lo2 < hi2) {
        Ds[lo2] += s;    Ds[hi2] -= s;
        Do[lo2] += s * a0;  Do[hi2] -= s * a0;
      }
      if (hi2 < ne) Dc[hi2] += w;
      // beyond-table mass clips into the last bin (binning.py:154-157)
      double f_last = e_last > age
                          ? (e_last <= a0 ? 0.0
                                          : (e_last >= a1 ? 1.0
                                                          : (e_last - a0) / width))
                          : 0.0;
      notshared[b * nbins + (nbins - 1)] += w * (1.0 - f_last);
    } else {
      // --- regular site: U[a0,a1] conditional on landing in-table
      // (the reference rejects+redraws out-of-table ages) ---
      const double z = (a1 < e_last ? a1 : e_last) - a0;
      if (!(z > 0)) continue;
      int e_lo = upper_edge(a0);
      int e_hi = lower_edge(a1);
      const double ss = ws[i] / z, sn = wn[i] / z;
      double* S0 = D(0, b);
      double* S1 = D(1, b);
      double* S2 = D(2, b);
      double* N0 = D(3, b);
      double* N1 = D(4, b);
      double* N2 = D(5, b);
      if (e_lo < e_hi) {
        S0[e_lo] += ss;  S0[e_hi] -= ss;
        S1[e_lo] += ss * a0;  S1[e_hi] -= ss * a0;
        N0[e_lo] += sn;  N0[e_hi] -= sn;
        N1[e_lo] += sn * a0;  N1[e_hi] -= sn * a0;
      }
      if (e_hi < ne) {
        S2[e_hi] += ws[i];
        N2[e_hi] += wn[i];
      }
    }
  }

  // prefix-sum the difference arrays into cumulative curves and diff
  // adjacent edges into per-bin mass
  for (int64_t b = 0; b < num_blocks; b++) {
    const double* S0 = D(0, b);
    const double* S1 = D(1, b);
    const double* S2 = D(2, b);
    const double* N0 = D(3, b);
    const double* N1 = D(4, b);
    const double* N2 = D(5, b);
    double s_sl = 0, s_of = 0, s_ct = 0, n_sl = 0, n_of = 0, n_ct = 0;
    double g_s_prev = 0, g_n_prev = 0;
    for (int e = 0; e < ne; e++) {
      s_sl += S0[e]; s_of += S1[e]; s_ct += S2[e];
      n_sl += N0[e]; n_of += N1[e]; n_ct += N2[e];
      const double g_s = s_sl * edges[e] - s_of + s_ct;
      const double g_n = n_sl * edges[e] - n_of + n_ct;
      if (e > 0) {
        const double hs = g_s - g_s_prev;
        const double hn = g_n - g_n_prev;
        shared[b * nbins + (e - 1)] += hs > 0 ? hs : 0.0;
        notshared[b * nbins + (e - 1)] += hn > 0 ? hn : 0.0;
      }
      g_s_prev = g_s;
      g_n_prev = g_n;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused tmptmp pipeline: per chromosome, parse the .mut file (only the
// columns mode `mut` needs), apply the row filters (coal.cpp:2150-2176),
// walk the precomputed target/reference site-stream segments with the
// reference's consumed-record cursor (coal.cpp:2183-2242), and bin the
// accepted sites analytically — one native call, chromosomes in
// parallel on host threads.  Byte-identical semantics to the separate
// cn_mut_read → Python filter → cn_join_tmptmp → cn_bin_analytic
// pipeline (tests/test_native_io.py compares the two); fused to skip
// materialising the 20-column .mut table and the intermediate site
// arrays on the hot path.
//
// Stream segments are computed by the caller from the run-length
// chromosome index: for each chromosome, [lo, hi) is the matching run
// at/after the cursor, with the record at `lo` already consumed by the
// chromosome scan — the cursor's cross-chromosome state reduces to
// exactly this (pipeline/join.py:_Cursor.segment).
// ---------------------------------------------------------------------------

namespace {

struct FusedChrom {
  std::vector<double> ab, ae, ws, wn;
  std::vector<int32_t> blk;
  int64_t blocks_used = 1;  // >=1: every chromosome ends one block
  int64_t num_sites = 0;
  bool ok = true;
  std::string err;
};

// .mut rows surviving the mode-mut filters (coal.cpp:2150-2176)
struct FilteredRows {
  std::vector<int64_t> pos;
  std::vector<double> ab, ae;
  std::vector<uint8_t> anc, der;
  int64_t n_read = 0;  // rows the filters saw
  bool ok = true;
  std::string err;
};

// Spans of the fused parse, one per chromosome, shard, run scan, join and
// binning (never per row), read back as flat int64 records by
// cn_prefilter_spans / cn_fused_spans.  Times are CLOCK_MONOTONIC, the
// clock of Python's time.perf_counter_ns on Linux, so they lie on the
// caller's spans; cpu_ns is the thread's own CPU time
// (CLOCK_THREAD_CPUTIME_ID) inside the span, less that of spans it holds
// on the same thread, so a call's CPU is the sum over its spans.  worker
// numbers the threads of one call, 0 being the caller's.
enum SpanKind : int64_t {
  SPAN_PREFILTER_CHROM = 0,  // n0 rows read, n1 rows kept
  SPAN_PREFILTER_SHARD = 1,  // n0 rows read, n1 rows kept
  SPAN_SCAN = 2,             // part 0 target, 1 reference; n0 records, n1 runs
  SPAN_JOIN = 3,             // n0 sites joined, n1 prefiltered rows
  SPAN_BIN = 4,              // n0 sites binned, n1 blocks
};

struct SpanRec {
  int64_t kind, chrom, part, worker, start_ns, end_ns, cpu_ns, n0, n1;
};
static_assert(sizeof(SpanRec) == 9 * sizeof(int64_t), "flat int64 records");

inline int64_t clock_ns(clockid_t id) {
  timespec ts;
  clock_gettime(id, &ts);
  return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}
inline int64_t mono_ns() { return clock_ns(CLOCK_MONOTONIC); }
inline int64_t thread_cpu_ns() { return clock_ns(CLOCK_THREAD_CPUTIME_ID); }

// the accessor's array: the call's worker count, then the records
void flatten_spans(int64_t workers, const std::vector<SpanRec>& spans,
                   std::vector<int64_t>& out) {
  out.assign(1, workers);
  const int64_t* p = (const int64_t*)spans.data();
  out.insert(out.end(), p, p + spans.size() * 9);
}

struct FusedOutC {
  std::vector<double> sh, ns, se, ne;  // [num_blocks * nbins]
  int64_t num_blocks = 0;
  int64_t num_sites = 0;
  std::vector<int64_t> spans;  // flatten_spans: join+bin workers, records
};

// mask lookup (coal.cpp:2163-2168): pass when pos >= len or mask[pos-1]=='P'
inline bool mask_pass(const uint8_t* m, int64_t len, int64_t pos) {
  if (!m || pos >= len) return true;
  int64_t i = pos - 1;
  if (i < 0) i = 0;
  if (i >= len) i = len - 1;
  return m[i] == 'P';
}

// row body shared by the SWAR and AVX-512 scanners: filters
// (coal.cpp:2150-2176, cheap fields first) + emit.  Returns false only
// on a malformed row (out->ok already set).
static inline bool fused_emit_row(const char* const* f, int nf, const char* e,
                                  const uint8_t* tmask, int64_t tmask_len,
                                  const uint8_t* rmask, int64_t rmask_len,
                                  double age, FilteredRows* out) {
  out->n_read++;
  if (nf < 11) {
    out->err = "short .mut row";
    out->ok = false;
    return false;
  }
  if (parse_i64(f[7], f[8] - 1) != 0) return true;  // flipped
  {                                                 // mutation_type 'X/Y'
    const char* m = f[10];
    const char* s = (const char*)memchr(m, ';', e - m);
    const char* me = s ? s : e;
    if (me - m != 3 || m[1] != '/' || !anc_ok(m[0]) || !der_ok(m[2]))
      return true;
  }
  {  // exactly one mapped branch
    const char* b = f[5];
    const char* be = f[6] - 1;
    while (b < be && (*b == ' ' || *b == '\t')) b++;
    if (b >= be) return true;  // zero branches
    while (b < be && *b != ' ' && *b != '\t') b++;
    while (b < be && (*b == ' ' || *b == '\t')) b++;
    if (b < be) return true;  // second token
  }
  const double m_ab = parse_age(f[8], f[9] - 1);
  const double m_ae = parse_age(f[9], f[10] - 1);
  if (!(m_ab < m_ae) || m_ae < age) return true;
  const int64_t pos = parse_i64(f[1], f[2] - 1);
  if (!mask_pass(tmask, tmask_len, pos)) return true;
  if (!mask_pass(rmask, rmask_len, pos)) return true;
  out->pos.push_back(pos);
  out->ab.push_back(m_ab);
  out->ae.push_back(m_ae);
  out->anc.push_back((uint8_t)f[10][0]);
  out->der.push_back((uint8_t)f[10][2]);
  return true;
}

// word-at-a-time (SWAR) scanner: the portable path, and the tail
// handler behind the AVX-512 front-end.  The buffer guarantees 8
// readable bytes past `end` (slurp pads; mmap reads stop at row
// boundaries before the last 64 bytes — see fused_parse_range);
// interior shard boundaries always sit just after a '\n', and within
// one word matches are consumed in ascending byte order, so a delimiter
// belonging to the next shard can never be taken before this row's
// terminating newline.
void fused_parse_range_swar(const char* p, const char* end,
                            const uint8_t* tmask, int64_t tmask_len,
                            const uint8_t* rmask, int64_t rmask_len,
                            double age, FilteredRows* out) {
  const char* f[12];
  constexpr uint64_t SEMI = 0x3B3B3B3B3B3B3B3BULL;
  constexpr uint64_t NLBC = 0x0A0A0A0A0A0A0A0AULL;
  while (p < end) {
    int nf = 0;
    f[0] = p;
    const char* q = p;
    const char* e;
    for (;;) {
      uint64_t w;
      memcpy(&w, q, 8);
      const uint64_t mn = zbyte_mask(w ^ NLBC);
      uint64_t m = zbyte_mask(w ^ SEMI) | mn;
      while (m) {
        const int b = __builtin_ctzll(m) >> 3;
        const char* c = q + b;
        if (c >= end) {
          e = end;
          goto row_end;
        }
        if (mn & (0x80ULL << (8 * b))) {
          e = c;
          goto row_end;
        }
        if (nf < 11) f[++nf] = c + 1;
        m &= m - 1;
      }
      q += 8;
      if (q >= end) {
        e = end;
        goto row_end;
      }
    }
  row_end:
    if (e == p) {
      p = e + 1;
      continue;
    }
    p = e + 1;
    if (!fused_emit_row(f, nf, e, tmask, tmask_len, rmask, rmask_len, age,
                        out))
      return;
  }
}

#if defined(__x86_64__)
// AVX-512 front-end: the shared block-mask walk (delim_rows_avx512,
// one compare per 64 input bytes — measured ~8x the SWAR scan rate on
// this core) with the prefilter row body; the in-flight row plus the
// last <=64 bytes hand off to the SWAR scanner.
static void fused_parse_range_avx512(
    const char* p, const char* end, const uint8_t* tmask, int64_t tmask_len,
    const uint8_t* rmask, int64_t rmask_len, double age, FilteredRows* out) {
  delim_rows_avx512(
      p, end,
      [&](const char* const* f, int nf, const char* e) {
        return fused_emit_row(f, nf, e, tmask, tmask_len, rmask, rmask_len,
                              age, out);
      },
      [&](const char* rs, const char* e2) {
        fused_parse_range_swar(rs, e2, tmask, tmask_len, rmask, rmask_len,
                               age, out);
        return true;
      });
}
#endif  // __x86_64__

// parse + filter one line range (ranges split at line boundaries, so
// shards are independent and can run on separate threads)
void fused_parse_range(const char* p, const char* end, const uint8_t* tmask,
                       int64_t tmask_len, const uint8_t* rmask,
                       int64_t rmask_len, double age, FilteredRows* out) {
  {  // one upfront reservation (~40 B/row lower bound) — the filters
     // keep most rows, so growth reallocations would copy the columns
     // several times over
    const size_t est = (size_t)(end - p) / 40 + 16;
    out->pos.reserve(est);
    out->ab.reserve(est);
    out->ae.reserve(est);
    out->anc.reserve(est);
    out->der.reserve(est);
  }
#if defined(__x86_64__)
  if (cpu_has_avx512bw() && end - p > 256) {
    fused_parse_range_avx512(p, end, tmask, tmask_len, rmask, rmask_len, age,
                             out);
    return;
  }
#endif
  fused_parse_range_swar(p, end, tmask, tmask_len, rmask, rmask_len, age, out);
}

// one chromosome's .mut on the thread `worker`; its span, then its
// shards' spans, go to `spans` (shard threads numbered from next_worker)
void mut_prefilter_one(const char* mut_path, const uint8_t* tmask,
                       int64_t tmask_len, const uint8_t* rmask,
                       int64_t rmask_len, double age, int par, int chrom,
                       int worker, std::atomic<int>* next_worker,
                       FilteredRows* out, std::vector<SpanRec>* spans) {
  const int64_t t0 = mono_ns(), cpu0 = thread_cpu_ns();
  std::vector<SpanRec> shard_spans;
  int64_t inline_cpu = 0;  // of a shard parsed on this thread
  auto finish = [&] {
    spans->push_back({SPAN_PREFILTER_CHROM, chrom, -1, worker, t0, mono_ns(),
                      thread_cpu_ns() - cpu0 - inline_cpu, out->n_read,
                      (int64_t)out->pos.size()});
    spans->insert(spans->end(), shard_spans.begin(), shard_spans.end());
  };
  MappedFile buf;
  if (!buf.open(mut_path, out->err)) {
    out->ok = false;
    return;
  }
  const char* p = buf.data;
  const char* end = p + buf.size;
  const char* nl = (const char*)memchr(p, '\n', end - p);
  if (!nl) {  // empty table: header only
    finish();
    return;
  }
  p = nl + 1;

  // parse + filter, sharded on threads when this chromosome got spare
  // parallel budget (few-chromosome runs, e.g. the chr-at-a-time
  // north-star workload)
  size_t total = (size_t)(end - p);
  if (par < 1) par = 1;
  if (total < (1u << 21)) par = 1;
  std::vector<const char*> bnd{p};
  for (int i = 1; i < par; i++) {
    const char* q = p + total * i / par;
    if (q <= bnd.back()) q = bnd.back();
    const char* e = (const char*)memchr(q, '\n', end - q);
    q = e ? e + 1 : end;
    if (q > bnd.back() && q < end) bnd.push_back(q);
  }
  bnd.push_back(end);
  const size_t nshard = bnd.size() - 1;
  std::vector<FilteredRows> shards(nshard);
  shard_spans.resize(nshard);
  auto shard = [&](size_t w, int wk) {
    const int64_t s0 = mono_ns(), c0 = thread_cpu_ns();
    fused_parse_range(bnd[w], bnd[w + 1], tmask, tmask_len, rmask, rmask_len,
                      age, &shards[w]);
    shard_spans[w] = {SPAN_PREFILTER_SHARD, chrom, (int64_t)w, wk, s0,
                      mono_ns(), thread_cpu_ns() - c0, shards[w].n_read,
                      (int64_t)shards[w].pos.size()};
  };
  if (nshard == 1) {
    shard(0, worker);
    inline_cpu = shard_spans[0].cpu_ns;
  } else {
    std::vector<std::thread> th;
    for (size_t w = 0; w < nshard; w++) {
      const int wk = next_worker->fetch_add(1);
      th.emplace_back([&, w, wk] { shard(w, wk); });
    }
    for (auto& x : th) x.join();
  }
  for (auto& s : shards) out->n_read += s.n_read;
  if (nshard == 1) {
    FilteredRows& s = shards[0];
    out->pos = std::move(s.pos);
    out->ab = std::move(s.ab);
    out->ae = std::move(s.ae);
    out->anc = std::move(s.anc);
    out->der = std::move(s.der);
    out->ok = s.ok;
    out->err = s.err;
    finish();
    return;
  }
  size_t nr = 0;
  for (auto& s : shards) nr += s.pos.size();
  out->pos.reserve(nr); out->ab.reserve(nr); out->ae.reserve(nr);
  out->anc.reserve(nr); out->der.reserve(nr);
  for (auto& s : shards) {
    if (!s.ok) { out->ok = false; out->err = s.err; return; }
    out->pos.insert(out->pos.end(), s.pos.begin(), s.pos.end());
    out->ab.insert(out->ab.end(), s.ab.begin(), s.ab.end());
    out->ae.insert(out->ae.end(), s.ae.begin(), s.ae.end());
    out->anc.insert(out->anc.end(), s.anc.begin(), s.anc.end());
    out->der.insert(out->der.end(), s.der.begin(), s.der.end());
  }
  finish();
}

}  // namespace

// cursor-join the prefiltered rows of one chromosome
static void fused_join_chrom(
    const FilteredRows& rows,
    const int32_t* t_bp, const uint8_t* t_anc, const uint8_t* t_der,
    const int32_t* t_aaf, const int32_t* t_daf, int64_t t_total,
    int64_t tlo, int64_t thi,
    const int32_t* r_bp, const uint8_t* r_anc, const uint8_t* r_der,
    const int32_t* r_aaf, const int32_t* r_daf, int64_t r_total,
    int64_t rlo, int64_t rhi, double ref_age, int64_t nbpb, FusedChrom* out) {
  int64_t ridx = rlo, tidx = tlo;  // current (consumed) record per stream
  int64_t block_base = 0, nb_local = 0;

  for (size_t i = 0; i < rows.pos.size(); i++) {
    const int64_t pos = rows.pos[i];
    const double m_ab = rows.ab[i];
    const double m_ae = rows.ae[i];
    const uint8_t anc = rows.anc[i];
    const uint8_t der = rows.der[i];

    // --- reference stream cursor (coal.cpp:2183-2199) ---
    // scan bp only; AAF/DAF read once at the stop position (same final
    // values as the original per-advance loads)
    int32_t DAF_ref = 0, AAF_ref = 0;
    {
      int64_t j = ridx;
      while (j < rhi && r_bp[j] < pos && j + 1 < r_total) j++;
      if (j > ridx) {
        ridx = j;
        AAF_ref = r_aaf[j];
        DAF_ref = r_daf[j];
      }
    }
    if (!(ridx < rhi && r_bp[ridx] == pos && r_anc[ridx] == anc &&
          r_der[ridx] == der) ||
        DAF_ref == 0)
      continue;
    const int32_t N_ref = DAF_ref + AAF_ref;

    // --- target stream cursor (coal.cpp:2201-2222) ---
    int32_t DAF_t = 0, AAF_t = 0;
    {
      int64_t j = tidx;
      while (j < thi && t_bp[j] < pos && j + 1 < t_total) j++;
      if (j > tidx) {
        tidx = j;
        AAF_t = t_aaf[j];
        DAF_t = t_daf[j];
      }
    }
    if (!(tidx < thi && t_bp[tidx] == pos && t_anc[tidx] == anc &&
          t_der[tidx] == der))
      continue;
    const int32_t N_t = DAF_t + AAF_t;
    if (N_t == 0) continue;

    while (block_base + nbpb < pos) {
      block_base += nbpb;
      nb_local++;
    }
    // pseudo-diploid rounding in float (coal.cpp:2236-2242)
    float f_DAF = (float)((float)DAF_t / (N_t / 2.0));
    float f_AAF = (float)((float)AAF_t / (N_t / 2.0));
    f_DAF = std::round(f_DAF);
    f_AAF = std::round(f_AAF);
    out->ab.push_back(m_ab < ref_age ? ref_age : m_ab);
    out->ae.push_back(m_ae);
    out->ws.push_back((double)f_DAF * DAF_ref / (double)N_ref);
    out->wn.push_back((double)f_AAF * DAF_ref / (double)N_ref);
    out->blk.push_back((int32_t)nb_local);
  }
  out->blocks_used = nb_local + 1;
  out->num_sites = (int64_t)out->ab.size();
}

// prefilter handle: parsed+filtered .mut rows per chromosome
struct PrefilterC {
  std::vector<FilteredRows> rows;
  std::vector<std::string> paths;
  std::vector<int64_t> spans;  // flatten_spans: parse threads, records
};

extern "C" {

// Phase 1: parse + filter the per-chromosome .mut files (threaded, with
// intra-file sharding).  Independent of the site streams, so callers
// overlap it with the .colate.in decode.  Returns a PrefilterC handle.
void* cn_mut_prefilter(
    int n_chr, const char* mpath_blob, const int64_t* mpath_off,
    const uint8_t* tmask_blob, const int64_t* tmask_off,
    const uint8_t* rmask_blob, const int64_t* rmask_off, double age,
    char* errbuf, int errlen) {
  auto* pf = new PrefilterC();
  pf->rows.resize(n_chr);
  pf->paths.resize(n_chr);
  for (int c = 0; c < n_chr; c++)
    pf->paths[c].assign(mpath_blob + mpath_off[c],
                        (size_t)(mpath_off[c + 1] - mpath_off[c]));
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (hw > 8) hw = 8;
  unsigned nt = hw;
  if ((int)nt > n_chr) nt = (unsigned)n_chr;
  const int par = (int)(hw / (nt ? nt : 1));
  std::atomic<int> next{0};
  // workers: 0 the caller, 1..nt the chromosome threads, then shard threads
  std::atomic<int> next_worker{nt <= 1 ? 1 : (int)nt + 1};
  std::vector<std::vector<SpanRec>> chrom_spans(n_chr);
  auto work = [&](int worker) {
    for (;;) {
      const int c = next.fetch_add(1);
      if (c >= n_chr) return;
      const uint8_t* tm = tmask_off ? tmask_blob + tmask_off[c] : nullptr;
      const int64_t tml = tmask_off ? tmask_off[c + 1] - tmask_off[c] : 0;
      const uint8_t* rm = rmask_off ? rmask_blob + rmask_off[c] : nullptr;
      const int64_t rml = rmask_off ? rmask_off[c + 1] - rmask_off[c] : 0;
      mut_prefilter_one(pf->paths[c].c_str(), tm, tml, rm, rml, age, par, c,
                        worker, &next_worker, &pf->rows[c], &chrom_spans[c]);
    }
  };
  if (nt <= 1) {
    work(0);
  } else {
    std::vector<std::thread> th;
    for (unsigned i = 0; i < nt; i++) th.emplace_back(work, (int)i + 1);
    for (auto& x : th) x.join();
  }
  std::vector<SpanRec> all;
  for (auto& v : chrom_spans) all.insert(all.end(), v.begin(), v.end());
  flatten_spans((int64_t)nt * par, all, pf->spans);
  for (int c = 0; c < n_chr; c++)
    if (!pf->rows[c].ok) {
      snprintf(errbuf, errlen, "%s: %s", pf->paths[c].c_str(),
               pf->rows[c].err.c_str());
      delete pf;
      return nullptr;
    }
  return pf;
}

void cn_prefilter_free(void* h) { delete (PrefilterC*)h; }

// the prefilter's spans (flatten_spans): the parse threads it chose
// (chromosome threads times shards a chromosome), then a record per
// chromosome followed by its shards'
void* cn_prefilter_spans(void* h, int64_t* nbytes) {
  auto& v = ((PrefilterC*)h)->spans;
  *nbytes = (int64_t)(v.size() * 8);
  return v.data();
}

// Phase 2: cursor-join the prefiltered rows against the decoded site
// streams and bin analytically.  Consumes (frees) the prefilter handle.
void* cn_tmptmp_join_bin(
    void* prefilter,
    const int32_t* t_bp, const uint8_t* t_anc, const uint8_t* t_der,
    const int32_t* t_aaf, const int32_t* t_daf, int64_t t_total,
    const int64_t* t_seg,
    const int32_t* r_bp, const uint8_t* r_anc, const uint8_t* r_der,
    const int32_t* r_aaf, const int32_t* r_daf, int64_t r_total,
    const int64_t* r_seg, double ref_age, int64_t nbpb, int nbins,
    const double* edges, double age, double bin_c) {
  auto* pf = (PrefilterC*)prefilter;
  const int n_chr = (int)pf->rows.size();
  std::vector<FusedChrom> parts(n_chr);
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 8) nt = 8;
  if ((int)nt > n_chr) nt = (unsigned)n_chr;
  std::atomic<int> next{0};
  auto work = [&] {
    for (;;) {
      const int c = next.fetch_add(1);
      if (c >= n_chr) return;
      fused_join_chrom(pf->rows[c], t_bp, t_anc, t_der, t_aaf, t_daf, t_total,
                       t_seg[2 * c], t_seg[2 * c + 1], r_bp, r_anc, r_der,
                       r_aaf, r_daf, r_total, r_seg[2 * c], r_seg[2 * c + 1],
                       ref_age, nbpb, &parts[c]);
    }
  };
  if (nt <= 1) {
    work();
  } else {
    std::vector<std::thread> th;
    for (unsigned i = 0; i < nt; i++) th.emplace_back(work);
    for (auto& x : th) x.join();
  }
  delete pf;

  auto* out = new FusedOutC();
  for (int c = 0; c < n_chr; c++) out->num_blocks += parts[c].blocks_used;
  const size_t hn = (size_t)out->num_blocks * nbins;
  out->sh.assign(hn, 0.0);
  out->ns.assign(hn, 0.0);
  out->se.assign(hn, 0.0);
  out->ne.assign(hn, 0.0);
  int64_t off = 0;
  for (int c = 0; c < n_chr; c++) {
    FusedChrom& pc = parts[c];
    out->num_sites += pc.num_sites;
    if (pc.num_sites)
      cn_bin_analytic(pc.num_sites, pc.ab.data(), pc.ae.data(), pc.ws.data(),
                      pc.wn.data(), pc.blk.data(), pc.blocks_used, nbins,
                      edges, age, bin_c, out->sh.data() + off * nbins,
                      out->ns.data() + off * nbins, out->se.data() + off * nbins,
                      out->ne.data() + off * nbins);
    off += pc.blocks_used;
  }
  return out;
}

namespace {

// Strided view of one chromosome run inside a mapped .colate.in file:
// every record in a run shares the same (lchrom, name) prefix, so the
// run is an array of fixed-stride structs over the mapped bytes — the
// join reads fields in place, nothing is materialised.  (The reference
// freads record-by-record into scalars, coal.cpp:2125-2145.)
struct RecView {
  const char* base = nullptr;  // first record's bp field
  size_t stride = 0;           // 18 + lchrom
  int64_t n = 0;               // records in the run
  int32_t bp(int64_t i) const {
    int32_t v;
    memcpy(&v, base + (size_t)i * stride, 4);
    return v;
  }
  uint8_t anc(int64_t i) const { return (uint8_t)base[(size_t)i * stride + 4]; }
  uint8_t der(int64_t i) const { return (uint8_t)base[(size_t)i * stride + 5]; }
  int32_t aaf(int64_t i) const {
    int32_t v;
    memcpy(&v, base + (size_t)i * stride + 6, 4);
    return v;
  }
  int32_t daf(int64_t i) const {
    int32_t v;
    memcpy(&v, base + (size_t)i * stride + 10, 4);
    return v;
  }
};

struct ColateSeg {
  std::string name;
  size_t lo = 0, hi = 0;  // byte range of the run
  size_t lchrom = 0;
};

// One pass over the mapped file collecting chromosome-run boundaries
// (~5 cycles/record: a u64 masked name compare and a stride add).  A
// garbage length field or truncated record ends the scan — exactly
// where the record-at-a-time reader would stop.
void scan_colatein_runs(const char* data, size_t size,
                        std::vector<ColateSeg>& out) {
  size_t off = 0;
  while (size - off >= 4 && off < size) {
    int32_t L;
    memcpy(&L, data + off, 4);
    if (L <= 0 || L > 1023) break;
    const size_t rec = 18 + (size_t)L;
    if (size - off < rec) break;
    ColateSeg seg;
    seg.name.assign(data + off + 4, (size_t)L);
    seg.lo = off;
    seg.lchrom = (size_t)L;
    uint64_t nm8 = 0;
    memcpy(&nm8, seg.name.data(), (size_t)L < 8 ? (size_t)L : 8);
    const uint64_t nmask =
        (size_t)L >= 8 ? ~0ULL : ((1ULL << (8 * (size_t)L)) - 1);
    off += rec;
    // header match of the record at `o` (8-byte pad past EOF guaranteed)
    auto hdr_match = [&](size_t o) {
      int32_t lc;
      memcpy(&lc, data + o, 4);
      if (lc != L) return false;
      uint64_t w;
      memcpy(&w, data + o + 4, 8);
      if (((w ^ nm8) & nmask) != 0) return false;
      return (size_t)L <= 8 || memcmp(data + o + 12, seg.name.data() + 8,
                                      (size_t)L - 8) == 0;
    };
    // unrolled x4 (almost every record continues the current run), then
    // single-step to the exact boundary
    while (size - off >= 4 * rec &&
           (hdr_match(off) & hdr_match(off + rec) & hdr_match(off + 2 * rec) &
            hdr_match(off + 3 * rec)))
      off += 4 * rec;
    while (size - off >= rec && hdr_match(off)) off += rec;
    seg.hi = off;
    out.push_back(std::move(seg));
  }
}

// Per-chromosome record ranges under the first-match-after-previous
// rule (pipeline/join.py:_static_segments): runs are consumed in file
// order; a chromosome's segment is the first later run with its name,
// else empty forever once the scan runs out.
void resolve_segments(const std::vector<ColateSeg>& runs,
                      const std::vector<std::string>& want,
                      std::vector<const ColateSeg*>& seg) {
  seg.assign(want.size(), nullptr);
  size_t r = 0;
  bool exhausted = false;
  for (size_t i = 0; i < want.size(); i++) {
    if (exhausted) continue;
    size_t rr = r;
    while (rr < runs.size() && runs[rr].name != want[i]) rr++;
    if (rr >= runs.size()) {
      exhausted = true;
      continue;
    }
    seg[i] = &runs[rr];
    r = rr + 1;
  }
}

// cursor-join one chromosome's prefiltered rows against the two mapped
// runs (same record semantics as fused_join_chrom, strided in-place)
void fused_join_chrom_mm(const FilteredRows& rows, const RecView& t,
                         const RecView& r, double ref_age, int64_t nbpb,
                         FusedChrom* out) {
  int64_t ridx = 0, tidx = 0;
  int64_t block_base = 0, nb_local = 0;
  const int64_t tn = t.n, rn = r.n;
  const size_t nrow = rows.pos.size();
  out->ab.reserve(nrow);
  out->ae.reserve(nrow);
  out->ws.reserve(nrow);
  out->wn.reserve(nrow);
  out->blk.reserve(nrow);

  for (size_t i = 0; i < nrow; i++) {
    const int64_t pos = rows.pos[i];
    const uint8_t anc = rows.anc[i];
    const uint8_t der = rows.der[i];

    // --- reference stream cursor (coal.cpp:2183-2199) ---
    // scan bp only; AAF/DAF are read once at the stop position (the
    // original loop loaded them on every advance — same final values)
    int32_t DAF_ref = 0, AAF_ref = 0;
    {
      int64_t j = ridx;
      while (j < rn && r.bp(j) < pos && j + 1 < rn) j++;
      if (j > ridx) {
        ridx = j;
        AAF_ref = r.aaf(j);
        DAF_ref = r.daf(j);
      }
    }
    if (!(ridx < rn && r.bp(ridx) == pos && r.anc(ridx) == anc &&
          r.der(ridx) == der) ||
        DAF_ref == 0)
      continue;
    const int32_t N_ref = DAF_ref + AAF_ref;

    // --- target stream cursor (coal.cpp:2201-2222) ---
    int32_t DAF_t = 0, AAF_t = 0;
    {
      int64_t j = tidx;
      while (j < tn && t.bp(j) < pos && j + 1 < tn) j++;
      if (j > tidx) {
        tidx = j;
        AAF_t = t.aaf(j);
        DAF_t = t.daf(j);
      }
    }
    if (!(tidx < tn && t.bp(tidx) == pos && t.anc(tidx) == anc &&
          t.der(tidx) == der))
      continue;
    const int32_t N_t = DAF_t + AAF_t;
    if (N_t == 0) continue;

    while (block_base + nbpb < pos) {
      block_base += nbpb;
      nb_local++;
    }
    // pseudo-diploid rounding in float (coal.cpp:2236-2242)
    float f_DAF = (float)((float)DAF_t / (N_t / 2.0));
    float f_AAF = (float)((float)AAF_t / (N_t / 2.0));
    f_DAF = std::round(f_DAF);
    f_AAF = std::round(f_AAF);
    const double m_ab = rows.ab[i];
    out->ab.push_back(m_ab < ref_age ? ref_age : m_ab);
    out->ae.push_back(rows.ae[i]);
    out->ws.push_back((double)f_DAF * DAF_ref / (double)N_ref);
    out->wn.push_back((double)f_AAF * DAF_ref / (double)N_ref);
    out->blk.push_back((int32_t)nb_local);
  }
  out->blocks_used = nb_local + 1;
  out->num_sites = (int64_t)out->ab.size();
}

}  // namespace

// Streaming phase 2: join + bin straight over zero-copy mmap views of
// the two .colate.in files.  A single cheap scan per file finds the
// chromosome-run boundaries; chromosomes then fan out over a worker
// pool, each joining its prefiltered rows against the strided record
// views in place (no columns are materialised) and binning into its own
// slot, so results are bit-identical to the serial loop.  Consumes
// (frees) the prefilter handle.
void* cn_tmptmp_fused_stream(
    void* prefilter, const char* t_path, const char* r_path,
    const char* chrom_blob, const int64_t* chrom_off, double ref_age,
    int64_t nbpb, int nbins, const double* edges, double age, double bin_c,
    char* errbuf, int errlen) {
  auto* pf = (PrefilterC*)prefilter;
  const int n_chr = (int)pf->rows.size();
  std::vector<std::string> want(n_chr);
  for (int c = 0; c < n_chr; c++)
    want[c].assign(chrom_blob + chrom_off[c],
                   (size_t)(chrom_off[c + 1] - chrom_off[c]));

  MappedFile tm, rm;
  std::string err;
  if (!tm.open(t_path, err)) {
    snprintf(errbuf, errlen, "cannot open %s", t_path);
    delete pf;
    return nullptr;
  }
  if (!rm.open(r_path, err)) {
    snprintf(errbuf, errlen, "cannot open %s", r_path);
    delete pf;
    return nullptr;
  }

  // workers: 0 the caller (the reference's scan), 1 the target's scan,
  // 2..nt+1 the join+bin threads (the caller's 0 when there is one)
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (int)std::min<unsigned>(hw ? hw : 2, 32);
  if (nt > n_chr) nt = n_chr;
  std::vector<SpanRec> scan_spans(2);
  auto scan = [&](const MappedFile& m, std::vector<ColateSeg>& runs, int part,
                  int worker) {
    const int64_t t0 = mono_ns(), c0 = thread_cpu_ns();
    scan_colatein_runs(m.data, m.size, runs);
    int64_t records = 0;
    for (auto& r : runs) records += (int64_t)((r.hi - r.lo) / (18 + r.lchrom));
    scan_spans[part] = {SPAN_SCAN, -1, part, worker, t0, mono_ns(),
                        thread_cpu_ns() - c0, records, (int64_t)runs.size()};
  };
  // the two run scans are independent - overlap them
  std::vector<ColateSeg> t_runs, r_runs;
  {
    std::thread th([&] { scan(tm, t_runs, 0, 1); });
    scan(rm, r_runs, 1, 0);
    th.join();
  }
  std::vector<const ColateSeg*> t_seg, r_seg;
  resolve_segments(t_runs, want, t_seg);
  resolve_segments(r_runs, want, r_seg);

  std::vector<FusedChrom> parts(n_chr);
  std::vector<std::vector<double>> h_sh(n_chr), h_ns(n_chr), h_se(n_chr),
      h_ne(n_chr);
  std::atomic<int64_t> total_sites{0};
  std::atomic<int> next{0};
  std::vector<SpanRec> join_spans(n_chr), bin_spans(n_chr);
  auto work = [&](int worker) {
    for (;;) {
      const int c = next.fetch_add(1);
      if (c >= n_chr) return;
      FusedChrom& fc = parts[c];
      const int64_t j0 = mono_ns(), jc0 = thread_cpu_ns();
      RecView tv, rv;
      if (t_seg[c]) {
        tv.stride = 18 + t_seg[c]->lchrom;
        tv.base = tm.data + t_seg[c]->lo + 4 + t_seg[c]->lchrom;
        tv.n = (int64_t)((t_seg[c]->hi - t_seg[c]->lo) / tv.stride);
      }
      if (r_seg[c]) {
        rv.stride = 18 + r_seg[c]->lchrom;
        rv.base = rm.data + r_seg[c]->lo + 4 + r_seg[c]->lchrom;
        rv.n = (int64_t)((r_seg[c]->hi - r_seg[c]->lo) / rv.stride);
      }
      fused_join_chrom_mm(pf->rows[c], tv, rv, ref_age, nbpb, &fc);
      const int64_t b0 = mono_ns(), bc0 = thread_cpu_ns();
      join_spans[c] = {SPAN_JOIN, c, -1, worker, j0, b0, bc0 - jc0,
                       fc.num_sites, (int64_t)pf->rows[c].pos.size()};
      const size_t hn = (size_t)fc.blocks_used * nbins;
      h_sh[c].assign(hn, 0.0);
      h_ns[c].assign(hn, 0.0);
      h_se[c].assign(hn, 0.0);
      h_ne[c].assign(hn, 0.0);
      total_sites += fc.num_sites;
      if (fc.num_sites)
        cn_bin_analytic(fc.num_sites, fc.ab.data(), fc.ae.data(),
                        fc.ws.data(), fc.wn.data(), fc.blk.data(),
                        fc.blocks_used, nbins, edges, age, bin_c,
                        h_sh[c].data(), h_ns[c].data(), h_se[c].data(),
                        h_ne[c].data());
      bin_spans[c] = {SPAN_BIN, c, -1, worker, b0, mono_ns(),
                      thread_cpu_ns() - bc0, fc.num_sites, fc.blocks_used};
      // release this chromosome's joined columns, prefiltered rows and
      // mapped record pages before claiming the next — peak RSS stays a
      // couple of chromosomes, not the genome (blocks_used/num_sites
      // stay for the concatenation below)
      std::vector<double>().swap(fc.ab);
      std::vector<double>().swap(fc.ae);
      std::vector<double>().swap(fc.ws);
      std::vector<double>().swap(fc.wn);
      std::vector<int32_t>().swap(fc.blk);
      pf->rows[c] = FilteredRows();
      const size_t pg = 4096;
      auto drop = [&](const MappedFile& m, const ColateSeg* s) {
        if (!s || !m.map_) return;
        size_t lo = (s->lo / pg) * pg;
        size_t hi = ((s->hi + pg - 1) / pg) * pg;
        if (hi > m.size) hi = (m.size / pg) * pg;
        if (hi > lo)
          madvise((void*)(m.data + lo), hi - lo, MADV_DONTNEED);
      };
      drop(tm, t_seg[c]);
      drop(rm, r_seg[c]);
    }
  };
  if (nt <= 1) {
    work(0);
  } else {
    std::vector<std::thread> th;
    for (int i = 0; i < nt; i++) th.emplace_back(work, i + 2);
    for (auto& x : th) x.join();
  }
  delete pf;

  auto* out = new FusedOutC();
  std::vector<SpanRec> all = scan_spans;
  for (int c = 0; c < n_chr; c++) {
    all.push_back(join_spans[c]);
    all.push_back(bin_spans[c]);
  }
  flatten_spans(nt, all, out->spans);
  out->num_sites = total_sites;
  for (int c = 0; c < n_chr; c++) out->num_blocks += parts[c].blocks_used;
  const size_t hn = (size_t)out->num_blocks * nbins;
  out->sh.reserve(hn);
  out->ns.reserve(hn);
  out->se.reserve(hn);
  out->ne.reserve(hn);
  for (int c = 0; c < n_chr; c++) {
    out->sh.insert(out->sh.end(), h_sh[c].begin(), h_sh[c].end());
    out->ns.insert(out->ns.end(), h_ns[c].begin(), h_ns[c].end());
    out->se.insert(out->se.end(), h_se[c].begin(), h_se[c].end());
    out->ne.insert(out->ne.end(), h_ne[c].begin(), h_ne[c].end());
  }
  return out;
}

int64_t cn_fused_num_blocks(void* h) { return ((FusedOutC*)h)->num_blocks; }
int64_t cn_fused_num_sites(void* h) { return ((FusedOutC*)h)->num_sites; }

void* cn_fused_hist(void* h, int which, int64_t* nbytes) {
  auto* t = (FusedOutC*)h;
  std::vector<double>* v = nullptr;
  switch (which) {
    case 0: v = &t->sh; break;
    case 1: v = &t->ns; break;
    case 2: v = &t->se; break;
    case 3: v = &t->ne; break;
    default: *nbytes = -1; return nullptr;
  }
  *nbytes = (int64_t)(v->size() * 8);
  return v->data();
}

// the join+bin's spans (flatten_spans): its join+bin threads, then the
// target's and the reference's run scans, then each chromosome's join
// and binning
void* cn_fused_spans(void* h, int64_t* nbytes) {
  auto& v = ((FusedOutC*)h)->spans;
  *nbytes = (int64_t)(v.size() * 8);
  return v.data();
}

void cn_fused_free(void* h) { delete (FusedOutC*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// .anc marginal-tree file (header mutations.cpp:342-397; tree-line record
// grammar "<pos>: p:(branch_length num_events SNP_begin SNP_end) ...",
// anc.cpp:6-47).  The reference re-parses every line with sscanf per node;
// here all tree lines are tokenised in parallel straight into flat
// [T, 2N-1] column buffers (the device populate kernel consumes columns).
// ---------------------------------------------------------------------------

namespace {

struct AncC {
  int64_t n_hap = 0, num_trees = 0;
  std::vector<double> sample_ages;       // [N] or empty
  std::vector<int64_t> start_pos;        // [T]
  std::vector<int32_t> parent, sb, se;   // [T*M]
  std::vector<double> blen;              // [T*M] (%lf like anc.cpp:19)
  std::vector<float> nev;                // [T*M] (%f)
};

// Clinger fast path for decimal -> double: mantissa of <=15 digits is
// exact in double, and 10^frac for frac<=22 is exact, so one division
// is correctly rounded (bit-identical to strtod).  Exponents/overlong
// mantissas fall back to strtod (fields are delimiter-terminated).
const double kP10D[23] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                          1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                          1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline double fast_strtod(const char* b, const char* e, bool& ok) {
  const char* q = b;
  bool neg = false;
  if (q < e && (*q == '-' || *q == '+')) neg = (*q++ == '-');
  const int64_t L = e - q;
  // SWAR fast shape "[<=8 digits][.<=7 digits]" (covers printf-style
  // branch lengths); anything else drops to the byte loop below with
  // identical semantics.  8-byte loads are safe: all callers pass
  // fields inside slurp/MappedFile buffers with >=8 readable bytes
  // past the data end.
  if (L >= 1 && L <= 16) {
    uint64_t w;
    memcpy(&w, q, 8);
    const uint64_t d = w ^ 0x3030303030303030ULL;
    const uint64_t nd =
        ((d + 0x7676767676767676ULL) | d) & 0x8080808080808080ULL;
    int run1 = nd ? (__builtin_ctzll(nd) >> 3) : 8;
    if (run1 > L) run1 = (int)L;
    if (run1 >= 1) {
      uint32_t ip = 0, fp = 0;
      if (run1 == (int)L) {  // pure integer, <=8 digits: exact
        swar_try_digits(w, run1, &ip);
        ok = true;
        return neg ? -(double)ip : (double)ip;
      }
      if (q[run1] == '.') {
        const char* fq = q + run1 + 1;
        const int fr = (int)(e - fq);
        if (fr >= 1 && fr <= 7 && run1 + fr <= 15) {
          uint64_t w2;
          memcpy(&w2, fq, 8);
          if (swar_try_digits(w2, fr, &fp)) {
            swar_try_digits(w, run1, &ip);
            ok = true;
            const uint64_t m = (uint64_t)ip * (uint64_t)kP10I[fr] + fp;
            double v = (double)m / kP10D[fr];
            return neg ? -v : v;
          }
        }
      }
    }
  }
  uint64_t m = 0;
  int digs = 0, frac = 0;
  bool seen_dot = false;
  while (q < e) {
    char c = *q;
    if (c >= '0' && c <= '9') {
      m = m * 10 + (uint64_t)(c - '0');
      digs++;
      if (seen_dot) frac++;
      q++;
    } else if (c == '.' && !seen_dot) {
      seen_dot = true;
      q++;
    } else {
      break;
    }
  }
  if (q < e || digs == 0 || digs > 15 || frac > 22) {
    ok = false;
    return 0;
  }
  ok = true;
  double v = (double)m / kP10D[frac];
  return neg ? -v : v;
}

inline double parse_f64_tok(const char* b, const char* e) {
  bool ok;
  double v = fast_strtod(b, e, ok);
  return ok ? v : strtod(b, nullptr);
}

inline float parse_f32_tok(const char* b, const char* e) {
  bool ok;
  float v = fast_strtof(b, e, ok);
  return ok ? v : strtof(b, nullptr);
}

// greedy in-place numeric parsers: advance p past the value, false (p
// untouched) when the token needs the delimiter-bounded fallback
inline bool g_i64(const char*& p, const char* e, int64_t& v) {
  const char* q = p;
  bool neg = false;
  if (q < e && (*q == '-' || *q == '+')) neg = (*q++ == '-');
  const char* d = q;
  uint64_t m = 0;
  while (q < e && (uint8_t)(*q - '0') <= 9) m = m * 10 + (uint8_t)(*q++ - '0');
  if (q == d) return false;
  v = neg ? -(int64_t)m : (int64_t)m;
  p = q;
  return true;
}

inline bool g_f64(const char*& p, const char* e, double& v) {
  const char* q = p;
  bool neg = false;
  if (q < e && (*q == '-' || *q == '+')) neg = (*q++ == '-');
  // SWAR fast shape "[1-7 digits][.0-7 digits]" (printf-style branch
  // lengths); digit runs that might extend past one 8-byte probe, and
  // every other shape, drop to the byte loop below (8-byte loads are
  // in-bounds: slurp/MappedFile guarantee >=8 readable bytes past end)
  if (q < e) {
    uint64_t w;
    memcpy(&w, q, 8);
    const uint64_t d1 = w ^ 0x3030303030303030ULL;
    const uint64_t nd1 =
        ((d1 + 0x7676767676767676ULL) | d1) & 0x8080808080808080ULL;
    int run1 = nd1 ? (__builtin_ctzll(nd1) >> 3) : 8;
    const int64_t avail = e - q;
    if (run1 > avail) run1 = (int)avail;
    if (run1 >= 1 && run1 <= 7) {
      uint32_t ip = 0;
      const char nc1 = run1 < avail ? q[run1] : '\0';
      if (nc1 != '.') {
        if (nc1 == 'e' || nc1 == 'E' || nc1 == 'x' || nc1 == 'X')
          return false;
        swar_try_digits(w, run1, &ip);
        v = neg ? -(double)ip : (double)ip;
        p = q + run1;
        return true;
      }
      const char* fq = q + run1 + 1;
      const int64_t favail = e - fq;
      uint64_t w2;
      memcpy(&w2, fq, 8);
      const uint64_t d2 = w2 ^ 0x3030303030303030ULL;
      const uint64_t nd2 =
          ((d2 + 0x7676767676767676ULL) | d2) & 0x8080808080808080ULL;
      int run2 = nd2 ? (__builtin_ctzll(nd2) >> 3) : 8;
      if (run2 > favail) run2 = (int)favail;
      if (run2 <= 7) {
        const char nc2 = run2 < favail ? fq[run2] : '\0';
        if (nc2 == 'e' || nc2 == 'E' || nc2 == 'x' || nc2 == 'X')
          return false;
        uint32_t fp = 0;
        swar_try_digits(w, run1, &ip);
        if (run2) swar_try_digits(w2, run2, &fp);
        const uint64_t m = (uint64_t)ip * (uint64_t)kP10I[run2] + fp;
        v = (double)m / kP10D[run2];
        if (neg) v = -v;
        p = fq + run2;
        return true;
      }
    }
  }
  uint64_t m = 0;
  int digs = 0, frac = 0;
  bool dot = false;
  while (q < e) {
    const char c = *q;
    if ((uint8_t)(c - '0') <= 9) {
      m = m * 10 + (uint8_t)(c - '0');
      digs++;
      if (dot) frac++;
      q++;
    } else if (c == '.' && !dot) {
      dot = true;
      q++;
    } else {
      break;
    }
  }
  if (digs == 0 || digs > 15 || frac > 22) return false;
  if (q < e && (*q == 'e' || *q == 'E' || *q == 'x' || *q == 'X'))
    return false;  // exponent form: caller falls back to strtod
  v = (double)m / kP10D[frac];
  if (neg) v = -v;
  p = q;
  return true;
}

// parse tree lines [t0, t1) of `lines` into t->... at row offsets t*M.
// minimal=true decodes only parent + branch_length (what the tree/LA/
// cond estimators consume) and hops the "(ev sb se)" tail with one
// memchr — roughly half the per-record work.
//
// Measured negative result (r5): replacing the per-record byte walk
// with an AVX-512 ')'-position mask iterator (the fused_parse_range
// pattern) ran 2-4x SLOWER here — the scan is a small fraction of the
// per-record work (two number parses dominate), so the 512-bit
// license/transition cost swamps the scan savings.  Don't retry
// without profiling.
bool parse_anc_range(const std::vector<const char*>& lo,
                     const std::vector<const char*>& hi, size_t t0, size_t t1,
                     int64_t M, bool minimal, AncC* t, std::string& err) {
  for (size_t ti = t0; ti < t1; ti++) {
    const char* p = lo[ti];
    const char* e = hi[ti];
    const char* colon = (const char*)memchr(p, ':', e - p);
    if (!colon) {
      err = ".anc tree " + std::to_string(ti) + ": missing start position";
      return false;
    }
    t->start_pos[ti] = parse_i64(p, colon);
    p = colon + 1;
    int64_t base = (int64_t)ti * M;
    for (int64_t j = 0; j < M; j++) {
      while (p < e && (*p == ' ' || *p == '\t')) p++;
      {  // greedy fast path: "<parent>:(<blen> " with plain decimals
        const char* q = p;
        int64_t pv;
        double bv;
        if (g_i64(q, e, pv) && q + 1 < e && q[0] == ':' && q[1] == '(' &&
            (q += 2, g_f64(q, e, bv)) && q < e && *q == ' ') {
          t->parent[base + j] = (int32_t)pv;
          t->blen[base + j] = bv;
          p = q + 1;
          if (minimal) {
            // the ")" is ~10 bytes away ("ev sb se)"): an inline byte
            // scan beats memchr's setup at that distance
            while (p < e && *p != ')') p++;
            if (p >= e) goto bad;
            p++;
            continue;
          }
          goto tail_fields;
        }
      }
      {  // fallback: delimiter-bounded tokens (exponent floats, junk)
        const char* c2 = (const char*)memchr(p, ':', e - p);
        if (!c2 || c2 + 1 >= e || c2[1] != '(') {
          err = ".anc tree " + std::to_string(ti) + ": short record " +
                std::to_string(j);
          return false;
        }
        t->parent[base + j] = (int32_t)parse_i64(p, c2);
        p = c2 + 2;
        const char* s1 = (const char*)memchr(p, ' ', e - p);
        if (!s1) goto bad;
        t->blen[base + j] = parse_f64_tok(p, s1);
        p = s1 + 1;
        if (minimal) {
          const char* s4 = (const char*)memchr(p, ')', e - p);
          if (!s4) goto bad;
          p = s4 + 1;
          continue;
        }
      }
    tail_fields:
      {
        const char* s2 = (const char*)memchr(p, ' ', e - p);
        if (!s2) goto bad;
        t->nev[base + j] = parse_f32_tok(p, s2);
        p = s2 + 1;
        const char* s3 = (const char*)memchr(p, ' ', e - p);
        if (!s3) goto bad;
        t->sb[base + j] = (int32_t)parse_i64(p, s3);
        p = s3 + 1;
        const char* s4 = (const char*)memchr(p, ')', e - p);
        if (!s4) goto bad;
        t->se[base + j] = (int32_t)parse_i64(p, s4);
        p = s4 + 1;
      }
      continue;
    bad:
      err = ".anc tree " + std::to_string(ti) + ": truncated record " +
            std::to_string(j);
      return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

void* cn_anc_read(const char* path, char* errbuf, int errlen, int minimal) {
  std::string err;
  MappedFile buf;
  if (!buf.open(path, err)) {
    snprintf(errbuf, errlen, "%s", err.c_str());
    return nullptr;
  }
  const char* p = buf.data;
  const char* end = p + buf.size;
  auto next_line = [&](const char*& q) -> std::pair<const char*, const char*> {
    const char* s = q;
    const char* e = (const char*)memchr(s, '\n', end - s);
    if (!e) e = end;
    q = e < end ? e + 1 : end;
    return {s, e};
  };
  auto [h1b, h1e] = next_line(p);
  auto [h2b, h2e] = next_line(p);
  if (h1b == h1e || h2b == h2e) {
    snprintf(errbuf, errlen, "truncated .anc header: %s", path);
    return nullptr;
  }
  // header 1: NUM_HAPLOTYPES N [sample_ages...]
  std::vector<std::pair<const char*, const char*>> tok;
  for (const char* q = h1b; q < h1e;) {
    while (q < h1e && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
    const char* s = q;
    while (q < h1e && *q != ' ' && *q != '\t' && *q != '\r') q++;
    if (q > s) tok.emplace_back(s, q);
  }
  if (tok.size() < 2) {
    snprintf(errbuf, errlen, "bad .anc header: %s", path);
    return nullptr;
  }
  auto* t = new AncC();
  t->n_hap = parse_i64(tok[1].first, tok[1].second);
  if ((size_t)tok.size() >= 2 + (size_t)t->n_hap && t->n_hap > 0) {
    // ages present iff every token parses as a float (anc reader parity)
    bool all_ok = true;
    std::vector<double> ages;
    ages.reserve(t->n_hap);
    for (int64_t i = 0; i < t->n_hap; i++) {
      const char* b = tok[2 + i].first;
      const char* e2 = tok[2 + i].second;
      char* endp = nullptr;
      std::string s(b, e2);  // tokens are short; bounded copy for strtod
      double v = strtod(s.c_str(), &endp);
      if (!endp || *endp != '\0' || endp == s.c_str()) {
        all_ok = false;
        break;
      }
      ages.push_back(v);
    }
    if (all_ok) t->sample_ages = std::move(ages);
  }
  // header 2: NUM_TREES T
  {
    const char* sp = (const char*)memchr(h2b, ' ', h2e - h2b);
    if (!sp) {
      snprintf(errbuf, errlen, "bad .anc NUM_TREES line: %s", path);
      delete t;
      return nullptr;
    }
    t->num_trees = parse_i64(sp + 1, h2e);
  }
  int64_t T = t->num_trees, M = 2 * t->n_hap - 1;
  if (T < 0 || t->n_hap <= 0) {
    snprintf(errbuf, errlen, "bad .anc dimensions: %s", path);
    delete t;
    return nullptr;
  }
  // index the first T nonempty body lines
  std::vector<const char*> lo, hi;
  lo.reserve(T);
  hi.reserve(T);
  while (p < end && (int64_t)lo.size() < T) {
    auto [s, e] = next_line(p);
    const char* s2 = s;
    while (s2 < e && (*s2 == ' ' || *s2 == '\t' || *s2 == '\r')) s2++;
    if (s2 < e) {
      lo.push_back(s);
      hi.push_back(e);
    }
  }
  if ((int64_t)lo.size() < T) {
    snprintf(errbuf, errlen, "header claims %lld trees, found %lld: %s",
             (long long)T, (long long)lo.size(), path);
    delete t;
    return nullptr;
  }
  t->start_pos.resize(T);
  t->parent.resize(T * M);
  t->blen.resize(T * M);
  if (!minimal) {
    t->nev.resize(T * M);
    t->sb.resize(T * M);
    t->se.resize(T * M);
  }
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 8) nt = 8;
  if ((size_t)T * (size_t)M < (1u << 16)) nt = 1;
  std::vector<std::string> errs(nt);
  std::vector<char> ok(nt, 1);
  {
    std::vector<std::thread> th;
    for (unsigned w = 0; w < nt; w++) {
      size_t t0 = (size_t)T * w / nt, t1 = (size_t)T * (w + 1) / nt;
      th.emplace_back([&, w, t0, t1] {
        ok[w] = parse_anc_range(lo, hi, t0, t1, M, minimal != 0, t, errs[w]);
      });
    }
    for (auto& x : th) x.join();
  }
  for (unsigned w = 0; w < nt; w++)
    if (!ok[w]) {
      snprintf(errbuf, errlen, "%s: %s", errs[w].c_str(), path);
      delete t;
      return nullptr;
    }
  return t;
}

int64_t cn_anc_n(void* h) { return ((AncC*)h)->num_trees; }
int64_t cn_anc_nhap(void* h) { return ((AncC*)h)->n_hap; }

void* cn_anc_col(void* h, int col, int64_t* nbytes) {
  auto* t = (AncC*)h;
  auto ret = [&](void* p, size_t nb) {
    *nbytes = (int64_t)nb;
    return p;
  };
  switch (col) {
    case 0: return ret(t->start_pos.data(), t->start_pos.size() * 8);
    case 1: return ret(t->parent.data(), t->parent.size() * 4);
    case 2: return ret(t->blen.data(), t->blen.size() * 8);
    case 3: return ret(t->nev.data(), t->nev.size() * 4);
    case 4: return ret(t->sb.data(), t->sb.size() * 4);
    case 5: return ret(t->se.data(), t->se.size() * 4);
    case 6: return ret(t->sample_ages.data(), t->sample_ages.size() * 8);
    default: break;
  }
  *nbytes = -1;
  return nullptr;
}

void cn_anc_free(void* h) { delete (AncC*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Node coordinates (Tree::GetCoordinates, anc.cpp:280-334): age(node) =
// max over children of age(child) + branch_length(child); leaves at 0 or
// their sample age.  Requires Relate's parents-after-children numbering
// (one ascending pass per tree); returns 0 so callers can fall back to
// the general post-order path when the numbering is arbitrary.  Each
// node f32-rounds once like the reference's std::vector<float>.
// ---------------------------------------------------------------------------

extern "C" {

int cn_tree_coords(int64_t T, int64_t M, int64_t N, const int32_t* parent,
                   const double* blen, const double* sample_ages, float* out) {
  for (int64_t i = 0; i < T * M; i++) {
    int64_t j = i % M;
    if (parent[i] >= 0 && parent[i] <= (int32_t)j) return 0;  // not ordered
  }
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 8) nt = 8;
  if ((size_t)(T * M) < (1u << 16)) nt = 1;
  auto work = [&](size_t t0, size_t t1) {
    std::vector<double> acc(M);
    for (size_t t = t0; t < t1; t++) {
      const int32_t* par = parent + t * M;
      const double* bl = blen + t * M;
      float* o = out + t * M;
      std::fill(acc.begin(), acc.end(), -1e300);
      for (int64_t j = 0; j < M; j++) {
        float c = j < N ? (sample_ages ? (float)sample_ages[j] : 0.0f)
                        : (float)acc[j];
        o[j] = c;
        int32_t p = par[j];
        if (p >= 0) {
          double v = (double)c + bl[j];
          if (v > acc[p]) acc[p] = v;
        }
      }
    }
  };
  std::vector<std::thread> th;
  for (unsigned w = 0; w < nt; w++)
    th.emplace_back(work, (size_t)T * w / nt, (size_t)T * (w + 1) / nt);
  for (auto& x : th) x.join();
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The .colate_mat cache (formats/colate_mat.py): whitespace-separated
// text, row 0 the bin ages, then a shared and a not-shared row per
// replicate.  The file is mapped and split into lines, and the rows are
// parsed by workers that take chunks of rows in turn and write each
// value straight into the caller's arrays.  The values, the rows and the
// failures are np.loadtxt's (its blank lines skipped, a lone '\r' a line
// break as in Python's universal newlines), but a '#' starts no comment:
// no writer of the format emits one, and Colate's reader takes none.
// ---------------------------------------------------------------------------

#include <charconv>
#include <locale.h>
#include <sched.h>

namespace {

// each worker parses at least this many rows, so small files take one
constexpr int64_t kColateMatRowsPerWorker = 128;
constexpr int64_t kColateMatChunk = 16;  // rows a worker takes at a time

struct ColateMatLine {
  const char* b;
  const char* e;
  int64_t line;  // 1-based
};

inline bool cm_sep(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

// One value, as np.loadtxt reads it: std::from_chars is correctly rounded
// and ignores the locale; a leading '+' is taken, and so are inf,
// infinity and nan in any case; a value past the range of a double is
// +-inf or +-0 (strtod in the C locale).  nan(...) is refused.
bool cm_value(const char* b, const char* e, double* out) {
  const char* p = b;
  if (p < e && *p == '+') {
    p++;
    if (p < e && (*p == '+' || *p == '-')) return false;
  }
  auto r = std::from_chars(p, e, *out);
  if (r.ec == std::errc::invalid_argument || r.ptr != e) return false;
  if (r.ec == std::errc::result_out_of_range) {
    static const locale_t c_locale = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    *out = strtod_l(std::string(b, e).c_str(), nullptr, c_locale);
  } else if (std::isnan(*out) && memchr(p, '(', (size_t)(e - p))) {
    return false;
  }
  return true;
}

// Parses a line into out[0, n) (nothing stored where out is null) and
// returns the values it holds; -1 at a token that is not a number, which
// goes into *err.
int64_t cm_row(const ColateMatLine& ln, double* out, int64_t n,
               std::string* err) {
  int64_t k = 0;
  const char* p = ln.b;
  for (;;) {
    while (p < ln.e && cm_sep(*p)) p++;
    if (p == ln.e) return k;
    const char* t = p;
    while (p < ln.e && !cm_sep(*p)) p++;
    double v;
    if (!cm_value(t, p, &v)) {
      const size_t shown = std::min<size_t>((size_t)(p - t), 40);
      *err = "line " + std::to_string(ln.line) + ": '" +
             std::string(t, shown) + "' is not a number";
      return -1;
    }
    if (out && k < n) out[k] = v;
    k++;
  }
}

// The lines of [data, data + size) that hold a value.
std::vector<ColateMatLine> cm_rows(const char* data, size_t size) {
  std::vector<ColateMatLine> rows;
  int64_t line = 0;
  auto add = [&](const char* b, const char* e) {
    line++;
    const char* p = b;
    while (p < e && cm_sep(*p)) p++;
    if (p < e) rows.push_back({b, e, line});
  };
  const char* p = data;
  const char* end = data + size;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* e = nl ? nl : end;
    // a '\r' before anything but the '\n' ends a line of its own
    for (const char* r;
         (r = (const char*)memchr(p, '\r', (size_t)(e - p))) && r + 1 < e;
         p = r + 1)
      add(p, r);
    add(p, e);
    p = e + 1;
  }
  return rows;
}

}  // namespace

extern "C" {

// Reads the .colate_mat at path: row 0 into ages[ncols], row 1+2i into
// shared[i] and row 2+2i into notshared[i] for i < B ([B, ncols] each,
// row-major; the caller zero-fills them, for the replicates the file
// lacks).  Rows past 2B, and a last shared row without its not-shared
// row, are parsed, as np.loadtxt does, and dropped.
// *width gets row 0's number of values; where that is not ncols nothing
// more is read and 0 is returned.  Otherwise returns the workers that
// parsed the rows (at most the CPUs the process may run on), -1 where
// the file cannot be read, or -2 where it is not a matrix of numbers,
// with the file and the 1-based line in errbuf.
int cn_colate_mat_read(const char* path, int64_t B, int64_t ncols,
                       double* ages, double* shared, double* notshared,
                       int64_t* width, char* errbuf, int errlen) {
  MappedFile f;
  std::string err;
  if (!f.open(path, err)) {
    snprintf(errbuf, errlen, "%s", err.c_str());
    return -1;
  }
  const std::vector<ColateMatLine> rows = cm_rows(f.data, f.size);
  if (rows.empty()) {
    snprintf(errbuf, errlen, "%s: line 1: no data", path);
    return -2;
  }
  *width = cm_row(rows[0], ages, ncols, &err);
  if (*width < 0) {
    snprintf(errbuf, errlen, "%s: %s", path, err.c_str());
    return -2;
  }
  if (*width != ncols) return 0;

  const int64_t n = (int64_t)rows.size();
  cpu_set_t cpus;
  const int64_t allowed =
      sched_getaffinity(0, sizeof cpus, &cpus) == 0 ? CPU_COUNT(&cpus) : 1;
  const int64_t nw = std::max<int64_t>(
      1, std::min(allowed, (n - 1) / kColateMatRowsPerWorker));
  std::atomic<int64_t> next{1};
  // each worker's first failure: its line (INT64_MAX: none) and message
  std::vector<std::pair<int64_t, std::string>> fail(nw, {INT64_MAX, ""});
  auto work = [&](int64_t w) {
    for (;;) {
      const int64_t r0 = next.fetch_add(kColateMatChunk);
      if (r0 >= n) return;
      for (int64_t r = r0; r < std::min(n, r0 + kColateMatChunk); r++) {
        // a replicate whose not-shared row is missing is dropped whole
        const int64_t i = (r - 1) / 2;
        double* out = i >= B || 2 + 2 * i >= n
                          ? nullptr
                          : (r % 2 ? shared : notshared) + i * ncols;
        std::string e;
        const int64_t k = cm_row(rows[r], out, ncols, &e);
        const int64_t line = rows[r].line;
        if (k == ncols || line >= fail[w].first) continue;
        if (k >= 0)
          e = "line " + std::to_string(line) + ": " + std::to_string(k) +
              " values, where line " + std::to_string(rows[0].line) +
              " has " + std::to_string(ncols);
        fail[w] = {line, e};
      }
    }
  };
  std::vector<std::thread> th;
  for (int64_t w = 1; w < nw; w++) th.emplace_back(work, w);
  work(0);
  for (auto& t : th) t.join();
  const auto first = std::min_element(fail.begin(), fail.end());
  if (first->first != INT64_MAX) {
    snprintf(errbuf, errlen, "%s: %s", path, first->second.c_str());
    return -2;
  }
  return (int)nw;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The .coal writer (formats/coal.py): rows of float64 values as text, each
// value as C's printf("%g") prints it in the C locale, which is also
// Python's f"{x:g}" (6 significant digits, the shorter of fixed and
// exponent form, trailing zeros dropped, "inf", "-inf", "-0").
// std::to_chars is specified as that printf and reads no locale; a NaN of
// either sign is "nan", as Python prints it, where glibc prints "-nan".
// ---------------------------------------------------------------------------

extern "C" {

// Writes the R rows of values ([R, C], row-major) into out[0, cap): for
// row r, "<labels[2r]> <labels[2r+1]> " where labels ([R, 2]) is not null,
// then values[r][first..C) joined by single spaces, then " \n".  Returns
// the bytes written, or -1 where they do not fit in cap.
int64_t cn_coal_rows(const double* values, int64_t R, int64_t C, int64_t first,
                     const int64_t* labels, char* out, int64_t cap) {
  char* p = out;
  char* const end = out + cap;
  for (int64_t r = 0; r < R; r++) {
    if (labels) {
      for (int k = 0; k < 2; k++) {
        auto t = std::to_chars(p, end, labels[2 * r + k]);
        if (t.ec != std::errc() || t.ptr == end) return -1;
        p = t.ptr;
        *p++ = ' ';
      }
    }
    const double* row = values + r * C;
    for (int64_t c = first; c < C; c++) {
      if (c > first) {
        if (p == end) return -1;
        *p++ = ' ';
      }
      if (std::isnan(row[c])) {
        if (end - p < 3) return -1;
        memcpy(p, "nan", 3);
        p += 3;
        continue;
      }
      auto t = std::to_chars(p, end, row[c], std::chars_format::general, 6);
      if (t.ec != std::errc()) return -1;
      p = t.ptr;
    }
    if (end - p < 2) return -1;
    *p++ = ' ';
    *p++ = '\n';
  }
  return (int64_t)(p - out);
}

}  // extern "C"
