// Fast ASCII artifact IO for the large density-pipeline files.
//
// The reference reads coordinates with a two-pass native reader
// (src/tools.hxx:39-111) and writes artifacts with C++ iostreams
// (src/tools.hxx:256-272, src/tools.cpp:144-174); at 10^7 frames the
// Python-level per-token parsing/formatting dominated end-to-end runs.
//
// Parsing: whitespace-separated tokens, multithreaded. Each token takes
// the Clinger fast path (exact when the decimal mantissa fits in 53 bits
// and |10-exponent| <= 22: one correctly-rounded multiply) and falls back
// to strtod otherwise -- both correctly rounded, so results are
// bit-identical to CPython's float(). A token that does not parse in full
// aborts with -1 and the caller falls back to the exact Python line-skip
// loop (semantics of reference tools.hxx:228-253).
//
// Formatting: byte-identical to CPython's "%e"/"%g"/str(int) (glibc printf
// and CPython dtoa are both correctly rounded; fuzz-tested in
// tests/test_io.py), multithreaded into per-chunk regions then compacted.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <malloc.h>
#include <thread>
#include <vector>

namespace {

const double POW10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                        1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                        1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline bool is_ws(char c) {
  return c == ' ' || c == '\n' || c == '\t' || c == '\r';
}

// parse one token [s, e); returns false unless the whole token parses
bool parse_token_f64(const char* s, const char* e, double* out) {
  const char* p = s;
  bool neg = false;
  if (p < e && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  bool any = false, overflow = false;
  for (; p < e && *p >= '0' && *p <= '9'; ++p) {
    any = true;
    if (digits < 19) {
      mant = mant * 10 + (uint64_t)(*p - '0');
      ++digits;
    } else {
      overflow = true;
    }
  }
  if (p < e && *p == '.') {
    ++p;
    for (; p < e && *p >= '0' && *p <= '9'; ++p) {
      any = true;
      if (digits < 19) {
        mant = mant * 10 + (uint64_t)(*p - '0');
        ++digits;
        ++frac;
      } else {
        overflow = true;
      }
    }
  }
  if (!any) return false;
  long exp10 = 0;
  if (p < e && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < e && (*p == '+' || *p == '-')) eneg = (*p++ == '-');
    if (p == e || *p < '0' || *p > '9') return false;
    for (; p < e && *p >= '0' && *p <= '9'; ++p) {
      if (exp10 < 100000) exp10 = exp10 * 10 + (*p - '0');
    }
    if (eneg) exp10 = -exp10;
  }
  if (p != e) return false;
  exp10 -= frac;
  // Clinger fast path: one correctly-rounded multiply/divide
  if (!overflow && mant < (1ull << 53) && exp10 >= -22 && exp10 <= 22) {
    double v = (double)mant;
    v = (exp10 >= 0) ? v * POW10[exp10] : v / POW10[-exp10];
    *out = neg ? -v : v;
    return true;
  }
  // slow exact path (rare: >15 significant digits or big exponents)
  char tmp[512];
  size_t len = (size_t)(e - s);
  if (len >= sizeof(tmp)) return false;
  memcpy(tmp, s, len);
  tmp[len] = 0;
  char* endp = nullptr;
  *out = strtod(tmp, &endp);
  return endp == tmp + len;
}

bool parse_token_i64(const char* s, const char* e, long long* out) {
  const char* p = s;
  bool neg = false;
  if (p < e && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  if (p == e) return false;
  unsigned long long v = 0;
  int digits = 0;
  for (; p < e; ++p) {
    if (*p < '0' || *p > '9') return false;
    if (++digits > 19) return false;
    v = v * 10 + (unsigned long long)(*p - '0');
  }
  if (neg) {
    if (v > 0x8000000000000000ull) return false;
    *out = (long long)(0ull - v);
  } else {
    if (v > 0x7fffffffffffffffull) return false;
    *out = (long long)v;
  }
  return true;
}

// count tokens in [s, e)
long long count_tokens(const char* s, const char* e) {
  long long n = 0;
  const char* p = s;
  while (p < e) {
    while (p < e && is_ws(*p)) ++p;
    if (p == e) break;
    ++n;
    while (p < e && !is_ws(*p)) ++p;
  }
  return n;
}

// move chunk start forward to the next token boundary
const char* chunk_start(const char* base, const char* end, long long off) {
  const char* p = base + off;
  if (p <= base) return base;
  if (p >= end) return end;
  // skip a partial token (it belongs to the previous chunk)
  while (p < end && !is_ws(*p)) ++p;
  return p;
}

// 0 = auto (hardware_concurrency); set via set_max_threads for the CLI's
// -n/--nthreads (reference: clustering.cpp wires it to omp_set_num_threads)
static std::atomic<int> g_max_threads{0};

extern "C" void set_max_threads(int n) { g_max_threads.store(n); }

// Raise glibc's mmap threshold so repeated multi-MB numpy buffers
// (NN/pops finish outputs, download destinations) are served from the
// reusable sbrk heap instead of fresh mmaps. glibc munmaps large blocks
// on free, so without this every postlude allocation re-faults all its
// pages -- measured 2.2s for a 24MB first touch in a 0.5GB-RSS process
// on the single-core target VM vs ~2ms from reused heap pages. 256MB
// keeps truly huge buffers (16M-frame arrays) on mmap so peak RSS stays
// bounded. Returns 1 on success, 0 if mallopt rejected the setting.
extern "C" int tune_host_malloc() {
  int ok = mallopt(M_MMAP_THRESHOLD, 256 << 20);
  return ok;
}

int pick_threads(long long work, long long per_thread) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  int cap = g_max_threads.load();
  if (cap > 0 && (unsigned)cap < hw) hw = (unsigned)cap;
  long long want = work / per_thread + 1;
  if (want > (long long)hw) want = hw;
  if (want < 1) want = 1;
  return (int)want;
}

template <typename T, typename F>
long long parse_mt(const char* buf, long long len, T* out, long long cap,
                   F token_fn) {
  const char* end = buf + len;
  int nt = pick_threads(len, 1 << 22);
  if (nt == 1) {
    // single pass, no counting (caller over-allocates)
    const char* p = buf;
    long long n = 0;
    while (p < end) {
      while (p < end && is_ws(*p)) ++p;
      if (p == end) break;
      const char* tok = p;
      while (p < end && !is_ws(*p)) ++p;
      if (n >= cap) return -2;
      if (!token_fn(tok, p, out + n)) return -1;
      ++n;
    }
    return n;
  }
  std::vector<const char*> bounds(nt + 1);
  bounds[0] = buf;
  bounds[nt] = end;
  for (int t = 1; t < nt; ++t)
    bounds[t] = chunk_start(buf, end, len * t / nt);
  std::vector<long long> counts(nt, 0);
  std::vector<char> failed(nt, 0);
  // pass 1: per-chunk token counts (cheap scan)
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t)
      ths.emplace_back([&, t] {
        counts[t] = count_tokens(bounds[t], bounds[t + 1]);
      });
    for (auto& th : ths) th.join();
  }
  long long total = 0;
  std::vector<long long> offs(nt, 0);
  for (int t = 0; t < nt; ++t) {
    offs[t] = total;
    total += counts[t];
  }
  if (total > cap) return -2;
  // pass 2: parse into exact output offsets
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t)
      ths.emplace_back([&, t] {
        const char* p = bounds[t];
        const char* e = bounds[t + 1];
        T* o = out + offs[t];
        while (p < e) {
          while (p < e && is_ws(*p)) ++p;
          if (p == e) break;
          const char* tok = p;
          while (p < e && !is_ws(*p)) ++p;
          if (!token_fn(tok, p, o++)) {
            failed[t] = 1;
            return;
          }
        }
      });
    for (auto& th : ths) th.join();
  }
  for (int t = 0; t < nt; ++t)
    if (failed[t]) return -1;
  return total;
}

// Exact "%e" fast path: the 7 significant digits are the correctly
// (half-even) rounded value of |v| * 10^(6 - e10), computed as an exact
// 128-bit rational m*2^e * 10^p. Exact decimal ties and out-of-range
// exponents bail out to snprintf, so output is glibc-identical by
// construction (fuzz-tested against CPython "%e" in tests/test_io.py).
// ~5x faster than snprintf for the typical fe/distance magnitudes.
bool format_e_fast(double v, char* o, int* olen) {
  if (!std::isfinite(v)) return false;
  bool neg = std::signbit(v);
  double a = std::fabs(v);
  int w = 0;
  if (neg) o[w++] = '-';
  if (a == 0.0) {
    memcpy(o + w, "0.000000e+00\n", 13);
    *olen = w + 13;
    return true;
  }
  int e2;
  double fr = std::frexp(a, &e2);
  uint64_t m = (uint64_t)(fr * 9007199254740992.0);  // fr * 2^53, exact
  int e = e2 - 53;
  int e10 = (int)std::floor(std::log10(a));
  static const unsigned __int128 P10_128[] = {
      (unsigned __int128)1,
      (unsigned __int128)10,
      (unsigned __int128)100,
      (unsigned __int128)1000,
      (unsigned __int128)10000,
      (unsigned __int128)100000,
      (unsigned __int128)1000000,
      (unsigned __int128)10000000,
      (unsigned __int128)100000000,
      (unsigned __int128)1000000000,
      (unsigned __int128)10000000000ull,
      (unsigned __int128)100000000000ull,
      (unsigned __int128)1000000000000ull,
      (unsigned __int128)10000000000000ull,
      (unsigned __int128)100000000000000ull,
      (unsigned __int128)1000000000000000ull,
      (unsigned __int128)10000000000000000ull,
      (unsigned __int128)100000000000000000ull,
      (unsigned __int128)1000000000000000000ull,
      (unsigned __int128)10000000000000000000ull,
      (unsigned __int128)10000000000000000000ull * 10,
      (unsigned __int128)10000000000000000000ull * 100,
      (unsigned __int128)10000000000000000000ull * 1000};
  for (int attempt = 0; attempt < 3; ++attempt) {
    int p = 6 - e10;
    int p_num = p > 0 ? p : 0, p_den = p < 0 ? -p : 0;
    int e_num = e > 0 ? e : 0, e_den = e < 0 ? -e : 0;
    if (p_num > 22 || p_den > 22) return false;
    // num = m * 10^p_num * 2^e_num (m < 2^53, 10^22 < 2^74: one multiply
    // cannot overflow 128 bits)
    unsigned __int128 num = (unsigned __int128)m * P10_128[p_num];
    if (e_num) {
      if (e_num > 120 || (num >> (127 - e_num))) return false;
      num <<= e_num;
    }
    unsigned __int128 q, r, den;
    if (p_den == 0) {
      // den = 2^e_den: shift instead of 128-bit division (the common
      // case, |v| < 10^7)
      if (e_den > 126) return false;
      den = (unsigned __int128)1 << e_den;
      q = num >> e_den;
      r = num & (den - 1);
    } else {
      den = P10_128[p_den];
      if (e_den) {
        if (e_den > 120 || (den >> (127 - e_den))) return false;
        den <<= e_den;
      }
      q = num / den;
      r = num - q * den;
    }
    unsigned __int128 twice = r << 1;
    if (twice > den) {
      ++q;
    } else if (twice == den) {
      return false;  // exact decimal tie: defer to snprintf
    }
    if (q == 10000000ull) {  // rounding carried into 8 digits
      q = 1000000ull;
      ++e10;
    }
    if (q >= 10000000ull) {
      ++e10;
      continue;
    }
    if (q < 1000000ull) {
      --e10;
      continue;
    }
    uint32_t d = (uint32_t)q;
    char buf[8];
    for (int k = 6; k >= 0; --k) {
      buf[k] = (char)('0' + d % 10);
      d /= 10;
    }
    o[w++] = buf[0];
    o[w++] = '.';
    memcpy(o + w, buf + 1, 6);
    w += 6;
    o[w++] = 'e';
    int ex = e10;
    o[w++] = ex < 0 ? '-' : '+';
    if (ex < 0) ex = -ex;
    if (ex >= 100) {
      o[w++] = (char)('0' + ex / 100);
      ex %= 100;
    }
    o[w++] = (char)('0' + ex / 10);
    o[w++] = (char)('0' + ex % 10);
    o[w++] = '\n';
    *olen = w;
    return true;
  }
  return false;
}

// fast int64 -> decimal; returns chars written
inline int itoa64(long long v, char* out) {
  char tmp[24];
  int n = 0;
  unsigned long long u;
  bool neg = v < 0;
  u = neg ? 0ull - (unsigned long long)v : (unsigned long long)v;
  do {
    tmp[n++] = (char)('0' + (u % 10));
    u /= 10;
  } while (u);
  int w = 0;
  if (neg) out[w++] = '-';
  while (n) out[w++] = tmp[--n];
  return w;
}

// format rows [lo, hi) with row_fn(row, char*)->len into per-chunk regions
// of stride max_width, then compact; returns total bytes or -1
template <typename F>
long long format_mt(long long n, char* out, long long cap,
                    long long max_width, F row_fn) {
  if (n * max_width > cap) return -2;
  int nt = pick_threads(n, 1 << 20);
  std::vector<long long> lo(nt + 1);
  for (int t = 0; t <= nt; ++t) lo[t] = n * t / nt;
  std::vector<long long> written(nt, 0);
  std::vector<char> failed(nt, 0);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t)
      ths.emplace_back([&, t] {
        char* o = out + lo[t] * max_width;
        long long w = 0;
        for (long long i = lo[t]; i < lo[t + 1]; ++i) {
          int k = row_fn(i, o + w);
          if (k < 0 || k > max_width) {
            failed[t] = 1;
            return;
          }
          w += k;
        }
        written[t] = w;
      });
    for (auto& th : ths) th.join();
  }
  for (int t = 0; t < nt; ++t)
    if (failed[t]) return -1;
  long long total = written[0];
  for (int t = 1; t < nt; ++t) {
    memmove(out + total, out + lo[t] * max_width, (size_t)written[t]);
    total += written[t];
  }
  return total;
}

}  // namespace

extern "C" {

// multithreaded whitespace-token count (for exact output allocation)
long long count_ws_tokens(const char* buf, long long len) {
  const char* end = buf + len;
  int nt = pick_threads(len, 1 << 22);
  std::vector<const char*> bounds(nt + 1);
  bounds[0] = buf;
  bounds[nt] = end;
  for (int t = 1; t < nt; ++t)
    bounds[t] = chunk_start(buf, end, len * t / nt);
  std::vector<long long> counts(nt, 0);
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; ++t)
    ths.emplace_back([&, t] {
      counts[t] = count_tokens(bounds[t], bounds[t + 1]);
    });
  for (auto& th : ths) th.join();
  long long total = 0;
  for (int t = 0; t < nt; ++t) total += counts[t];
  return total;
}

// uniform tokens-per-line scan (table-shape validation): returns the
// common token count of every non-blank line (>0), 0 when the buffer
// holds no tokens, -1 when line widths disagree. One sequential pass --
// replaces a numpy mask/cumsum/bincount pipeline that cost ~9s on a
// 38MB table where this loop costs ~0.05s.
long long line_cols(const char* buf, long long len) {
  long long cur = 0, common = 0;
  bool in_tok = false, have = false;
  for (long long i = 0; i < len; ++i) {
    const char c = buf[i];
    if (c == '\n') {
      if (in_tok) { ++cur; in_tok = false; }
      if (cur) {
        if (!have) { common = cur; have = true; }
        else if (common != cur) return -1;
      }
      cur = 0;
    } else if (c == ' ' || c == '\t' || c == '\r') {
      if (in_tok) { ++cur; in_tok = false; }
    } else {
      in_tok = true;
    }
  }
  if (in_tok) ++cur;
  if (cur) {
    if (!have) { common = cur; have = true; }
    else if (common != cur) return -1;
  }
  return have ? common : 0;
}

// parse all whitespace-separated float tokens; returns count, -1 on any
// malformed token (caller falls back to the exact line-skip loop), -2 on
// short output buffer
long long parse_f64(const char* buf, long long len, double* out,
                    long long cap) {
  return parse_mt(buf, len, out, cap, parse_token_f64);
}

long long parse_i64(const char* buf, long long len, long long* out,
                    long long cap) {
  return parse_mt(buf, len, out, cap, parse_token_i64);
}

// one "%e\n" line per value; returns bytes written, < 0 on error
long long format_e(const double* v, long long n, char* out, long long cap) {
  return format_mt(n, out, cap, 32, [v](long long i, char* o) {
    int k;
    if (format_e_fast(v[i], o, &k)) return k;
    k = snprintf(o, 32, "%e\n", v[i]);
    return (k >= 32) ? -1 : k;
  });
}

// one "%lld\n" line per value
long long format_i64(const long long* v, long long n, char* out,
                     long long cap) {
  return format_mt(n, out, cap, 24, [v](long long i, char* o) {
    int k = itoa64(v[i], o);
    o[k++] = '\n';
    return k;
  });
}

// neighborhood rows: "id dsqr id_hd dsqr_hd\n" with %g distances
// (reference: src/tools.cpp:144-174)
long long format_nn(const long long* nh_idx, const double* nh_dist,
                    const long long* hd_idx, const double* hd_dist,
                    long long n, char* out, long long cap) {
  return format_mt(n, out, cap, 96,
                   [nh_idx, nh_dist, hd_idx, hd_dist](long long i, char* o) {
    int w = itoa64(nh_idx[i], o);
    o[w++] = ' ';
    int k = snprintf(o + w, 40, "%g", nh_dist[i]);
    if (k < 0 || k >= 40) return -1;
    w += k;
    o[w++] = ' ';
    w += itoa64(hd_idx[i], o + w);
    o[w++] = ' ';
    k = snprintf(o + w, 40, "%g", hd_dist[i]);
    if (k < 0 || k >= 40) return -1;
    w += k;
    o[w++] = '\n';
    return w;
  });
}

// ASCII coords rows: " %g %g ...\n" per (n_cols,) float32 row. The
// reference AsciiHandler::write streams " " << f with default ostream
// float formatting (src/coords_file/coords_file.cpp:76-84), which is
// printf %g of the value promoted to double -- identical to the Python
// streaming handler's ' %g' % float(np.float32(v)).
long long format_g_rows(const float* v, long long n_rows, long long n_cols,
                        char* out, long long cap) {
  return format_mt(n_rows, out, cap, n_cols * 41 + 2,
                   [v, n_cols](long long i, char* o) {
    int w = 0;
    const float* row = v + i * n_cols;
    for (long long c = 0; c < n_cols; ++c) {
      o[w++] = ' ';
      int k = snprintf(o + w, 40, "%g", (double)row[c]);
      if (k < 0 || k >= 40) return -1;
      w += k;
    }
    o[w++] = '\n';
    return w;
  });
}

// NN-finish host postlude: take the raw (2, n) int32 neighbor-id
// download (INT32_MAX marks frames with no admissible neighbor), emit
// zeroed int64 id rows plus fp32 squared distances recomputed from the
// (n_frames, d) row-major coords. The accumulation is one multiply and
// one add per dimension in ascending order -- fp32 with a rounding per
// op, bit-identical to the Pallas sweep kernel's VPU arithmetic and to
// the numpy fallback in ops/engine.py::_host_pair_d2 (x86-64 baseline
// has no FMA and -ffp-contract is irrelevant here; fuzz-pinned in
// tests/test_engine.py). Replaces ~4 full-array numpy passes that cost
// ~0.5s at 1M frames on this VM (reference stores distances straight
// from its kernels: src/density_clustering.cpp:256-286 -- it never
// pays a device->host link for them; this keeps the link payload to
// the ids alone).
void nn_finish_host_range(const float* coords, long long n_frames,
                          long long d, const int* jj, long long n,
                          long long frame0,
                          long long* nh_j, long long* hd_j,
                          float* nh_d, float* hd_d) {
  const int kAbsent = 2147483647;
  for (int row = 0; row < 2; ++row) {
    const int* ids = jj + row * n;
    long long* out_j = row ? hd_j : nh_j;
    float* out_d = row ? hd_d : nh_d;
    for (long long i = 0; i < n; ++i) {
      int j = ids[i];
      // out-of-range ids (absent sentinel, or a corrupt transfer)
      // must not index coords
      if (j == kAbsent || j < 0 || (long long)j >= n_frames) {
        out_j[i] = 0;
        out_d[i] = 0.0f;
        continue;
      }
      out_j[i] = j;
      // ids[i] belongs to global frame frame0 + i (streamed finish
      // passes frame-range chunks of the full download)
      const float* a = coords + (frame0 + i) * d;
      const float* b = coords + (long long)j * d;
      float acc = 0.0f;
      for (long long k = 0; k < d; ++k) {
        float diff = a[k] - b[k];
        acc += diff * diff;
      }
      out_d[i] = acc;
    }
  }
}

void nn_finish_host(const float* coords, long long n_frames, long long d,
                    const int* jj, long long n,
                    long long* nh_j, long long* hd_j,
                    float* nh_d, float* hd_d) {
  nn_finish_host_range(coords, n_frames, d, jj, n, 0, nh_j, hd_j, nh_d,
                       hd_d);
}

// u24 variant: ids arrive as three uint8 byte planes per row (layout
// (2, 3, n) row-major -- 6 bytes/frame instead of 8 over the
// device->host link); any decoded id >= n_frames means "no admissible
// neighbor" (the device packer remaps INT32_MAX to 0xFFFFFF).
void nn_finish_host_u24(const float* coords, long long n_frames,
                        long long d, const unsigned char* jj, long long n,
                        long long* nh_j, long long* hd_j,
                        float* nh_d, float* hd_d) {
  for (int row = 0; row < 2; ++row) {
    const unsigned char* b0 = jj + (row * 3 + 0) * n;
    const unsigned char* b1 = jj + (row * 3 + 1) * n;
    const unsigned char* b2 = jj + (row * 3 + 2) * n;
    long long* out_j = row ? hd_j : nh_j;
    float* out_d = row ? hd_d : nh_d;
    for (long long i = 0; i < n; ++i) {
      long long j = (long long)b0[i] | ((long long)b1[i] << 8)
                    | ((long long)b2[i] << 16);
      if (j >= n_frames) {
        out_j[i] = 0;
        out_d[i] = 0.0f;
        continue;
      }
      out_j[i] = j;
      const float* a = coords + i * d;
      const float* b = coords + j * d;
      float acc = 0.0f;
      for (long long k = 0; k < d; ++k) {
        float diff = a[k] - b[k];
        acc += diff * diff;
      }
      out_d[i] = acc;
    }
  }
}

// pops-finish host postlude: scatter each radius's int32 count row
// (laid out at ``stride`` >= n, i.e. straight off the padded device
// download -- no host slice/copy) back to original frame positions
// while widening to int64 in the same pass. ``order`` maps sorted
// position -> original frame id (null = rows already in original
// order). Replaces a numpy scatter + per-radius astype(int64) that
// cost 0.3-5s at 1M frames x 3 radii on this VM (reference counts
// never leave host memory: src/density_clustering.cpp:155-193).
void pops_finish_host(const int* counts, long long r, long long n,
                      long long stride, const long long* order,
                      long long* out) {
  for (long long ri = 0; ri < r; ++ri) {
    const int* src = counts + ri * stride;
    long long* dst = out + ri * n;
    if (order) {
      for (long long i = 0; i < n; ++i) dst[order[i]] = src[i];
    } else {
      for (long long i = 0; i < n; ++i) dst[i] = src[i];
    }
  }
}

// narrow variant of pops_finish_host for the engine's halved-bytes
// uint16 counts download (valid when every per-radius maximum <= 65535)
void pops_finish_host_u16(const unsigned short* counts, long long r,
                          long long n, long long stride,
                          const long long* order, long long* out) {
  for (long long ri = 0; ri < r; ++ri) {
    const unsigned short* src = counts + ri * stride;
    long long* dst = out + ri * n;
    if (order) {
      for (long long i = 0; i < n; ++i) dst[order[i]] = src[i];
    } else {
      for (long long i = 0; i < n; ++i) dst[i] = src[i];
    }
  }
}

// One-pass dynamical-coring scan of one concat chunk: the semantics of
// models/coring.py::core_trajectory's inner loop (itself the vectorized
// form of reference src/coring.cpp:189-289). ``seg`` holds the chunk's
// states, ``cw`` the per-frame coring window (already min'd with the
// ramp's current max), ``limit_rel`` = next_limit - lo (the raw concat
// limit relative to the chunk start: a window must fit before it for a
// frame to enter a core). iterative=1 checks only the window's LAST
// frame against the current one (coring.cpp:248-253). Outputs the cored
// chunk plus the in-core flags; frames before the first core get the
// first-truncated-window core (coring.cpp:226-239), seg[0] when no
// candidate exists.
void coring_pass(const long long* seg, long long m, const long long* cw,
                 long long limit_rel, int iterative,
                 long long* cored, signed char* incore) {
  if (m <= 0) return;
  long long first_core = seg[0];
  int have_first = 0;
  long long cur = 0;
  int have_cur = 0;
  long long prefix = 0;  // frames emitted before any core existed
  long long r = 0;
  while (r < m) {
    const long long v = seg[r];
    long long e = r + 1;  // exclusive end of the maximal constant run
    while (e < m && seg[e] == v) ++e;
    for (long long i = r; i < e; ++i) {
      const long long w = cw[i];
      int cwin;
      if (iterative) {
        // the window's LAST frame vs the current one -- an equal value
        // in a LATER run counts too (coring.cpp:248-253), so this must
        // be a value comparison, not a same-run test
        long long j = i + w - 1;
        if (j > m - 1) j = m - 1;
        cwin = seg[j] == v;
      } else {
        cwin = e >= i + w;
      }
      const int ic = cwin && (i + w <= m) && (i + w <= limit_rel);
      if (!have_first) {
        long long t = i + w;
        if (t > m) t = m;
        if (e >= t) {
          first_core = v;
          have_first = 1;
        }
      }
      incore[i] = (signed char)ic;
      if (ic) {
        cur = v;
        have_cur = 1;
      }
      if (have_cur) {
        cored[i] = cur;
      } else {
        ++prefix;
      }
    }
    r = e;
  }
  for (long long i = 0; i < prefix; ++i) cored[i] = first_core;
}

// two-column "key value\n" map lines: int64 keys, "%g" values
// (reference writer: tools.hxx:207-226); swap=1 emits "value key\n"
long long format_kv_ig(const long long* keys, const double* vals,
                       long long n, int swap, char* out, long long cap) {
  return format_mt(n, out, cap, 72, [keys, vals, swap](long long i,
                                                       char* o) {
    int w = 0;
    if (!swap) {
      w = itoa64(keys[i], o);
      o[w++] = ' ';
      int k = snprintf(o + w, 40, "%g", vals[i]);
      if (k < 0 || k >= 40) return -1;
      w += k;
    } else {
      int k = snprintf(o, 40, "%g", vals[i]);
      if (k < 0 || k >= 40) return -1;
      w = k;
      o[w++] = ' ';
      w += itoa64(keys[i], o + w);
    }
    o[w++] = '\n';
    return w;
  });
}

// Morton (Z-order) frame order + permuted padded layout in one native
// pass. Bit-identical to ops/pruning.py::morton_order (float64
// quantization, identical key assembly, stable sort = numpy
// kind="stable" for tied keys) -- the numpy bit-interleave loop makes
// ~60 full passes over 16M uint64 keys and the fancy-index permute
// touches 256MB; together they cost 30-50s on the single-core target
// VM where this pass costs a few seconds. ``padded_out`` (n_pad x d
// row-major f32, pad rows 3e38) may be null to compute the order only.
// Returns 0 on success.
extern "C" long long morton_order_pad(const float* coords, long long n,
                                      int d, long long n_pad,
                                      long long* order_out,
                                      float* padded_out) {
  if (n <= 0 || d <= 0 || d > 31 || (padded_out && n_pad < n)) return -1;
  int bits = 62 / d;
  if (bits < 1) bits = 1;
  std::vector<double> lo(d, 0.0), span(d, 0.0);
  for (int k = 0; k < d; ++k) {
    double mn = (double)coords[k], mx = (double)coords[k];
    for (long long i = 1; i < n; ++i) {
      const double v = (double)coords[i * d + k];
      if (v < mn) mn = v;
      if (v > mx) mx = v;
    }
    lo[k] = mn;
    span[k] = (mx - mn) == 0.0 ? 1.0 : (mx - mn);
  }
  const double scale = (double)((1ULL << bits) - 1);
  std::vector<uint64_t> key(n);
  {
    int nt = pick_threads(n, 1 << 20);
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t)
      ths.emplace_back([&, t] {
        const long long a = n * t / nt, b = n * (t + 1) / nt;
        for (long long i = a; i < b; ++i) {
          uint64_t kk = 0;
          for (int k = 0; k < d; ++k) {
            // same double ops and order as the numpy reference:
            // (c - lo) / span * (2^bits - 1), truncated to uint64
            const double v = (double)coords[i * d + k];
            const uint64_t q = (uint64_t)((v - lo[k]) / span[k] * scale);
            for (int bb = 0; bb < bits; ++bb)
              kk |= ((q >> bb) & 1ULL) << (bb * d + k);
          }
          key[i] = kk;
        }
      });
    for (auto& th : ths) th.join();
  }
  // LSD radix sort (8-bit digits): stable per pass, so the final order
  // equals std::stable_sort / numpy kind="stable" for tied keys, at
  // O(n) instead of O(n log n) single-threaded comparisons (the
  // comparison sort was ~70% of this pass at 16M frames). Passes whose
  // digit histogram is a single bucket are skipped.
  {
    std::vector<long long> idx(n), tmp_idx(n);
    std::vector<uint64_t> tmp_key(n);
    for (long long i = 0; i < n; ++i) idx[i] = i;
    uint64_t* kin = key.data();
    uint64_t* kout = tmp_key.data();
    long long* iin = idx.data();
    long long* iout = tmp_idx.data();
    const int passes = (bits * d + 7) / 8;
    long long hist[256];
    for (int p = 0; p < passes; ++p) {
      const int shift = p * 8;
      std::memset(hist, 0, sizeof(hist));
      for (long long i = 0; i < n; ++i)
        ++hist[(kin[i] >> shift) & 0xFF];
      bool single = false;
      for (int b = 0; b < 256; ++b)
        if (hist[b] == n) { single = true; break; }
      if (single) continue;
      long long pos = 0;
      for (int b = 0; b < 256; ++b) {
        const long long c = hist[b];
        hist[b] = pos;
        pos += c;
      }
      for (long long i = 0; i < n; ++i) {
        const long long dst = hist[(kin[i] >> shift) & 0xFF]++;
        kout[dst] = kin[i];
        iout[dst] = iin[i];
      }
      std::swap(kin, kout);
      std::swap(iin, iout);
    }
    std::memcpy(order_out, iin, sizeof(long long) * n);
  }
  if (padded_out) {
    int nt = pick_threads(n_pad, 1 << 20);
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t)
      ths.emplace_back([&, t] {
        const long long a = n_pad * t / nt, b = n_pad * (t + 1) / nt;
        for (long long i = a; i < b; ++i) {
          float* dst = padded_out + i * d;
          if (i < n) {
            const float* src = coords + order_out[i] * d;
            for (int k = 0; k < d; ++k) dst[k] = src[k];
          } else {
            for (int k = 0; k < d; ++k) dst[k] = 3e38f;
          }
        }
      });
    for (auto& th : ths) th.join();
  }
  return 0;
}

}  // extern "C"
