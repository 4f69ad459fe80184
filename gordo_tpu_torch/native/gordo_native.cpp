// Native data-layer kernels for the timeseries pipeline.
//
// The reference's data layer (gordo-dataset) does per-tag resample/aggregate
// joins in pandas; at fleet scale (1000+ machines x N tags) the pandas
// object overhead dominates the host-side cost of a batched TPU build.
// These kernels do the same time-bucket aggregation in one pass over the
// raw (timestamp, value) arrays.
//
// Aggregation semantics match pandas Series.resample(freq).agg(method) with
// the default closed='left', label='left' bucketing: a sample at time t
// lands in bucket floor((t - origin) / bucket). NaN values are skipped
// (pandas skipna): empty buckets give NaN for mean/min/max/median, 0 for
// sum/count.
//
// Built with plain g++ -O3 -shared -fPIC; bound via ctypes (no pybind11 in
// the image). All symbols are extern "C".

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string_view>
#include <unordered_set>
#include <vector>

// CPython's shortest-repr digit generator (the David Gay dtoa behind
// float.__repr__), resolved from the host process at load time: mode 0
// yields the unique shortest digit string that round-trips, so the serving
// encoder's float formatting is byte-identical to json.dumps by
// construction. NOT thread-safe without the GIL (private freelists) — the
// Python binding uses PYFUNCTYPE so ctypes keeps the GIL held.
extern "C" char* _Py_dg_dtoa(double d, int mode, int ndigits, int* decpt,
                             int* sign, char** rve);
extern "C" void _Py_dg_freedtoa(char* s);

namespace {

const double kNaN = std::numeric_limits<double>::quiet_NaN();

enum Agg : int32_t {
  kMean = 0,
  kMin = 1,
  kMax = 2,
  kSum = 3,
  kCount = 4,
  kMedian = 5,
};

}  // namespace

extern "C" {

// Single-pass bucket aggregation.
//   ts_ns:     sample timestamps (ns since epoch), ascending
//   vals:      sample values (may contain NaN)
//   n:         number of samples
//   origin_ns: left edge of bucket 0
//   bucket_ns: bucket width
//   n_buckets: number of output buckets
//   aggs:      aggregation codes (see Agg), length n_aggs
//   out:       [n_aggs][n_buckets] row-major output
// Returns 0 on success, nonzero on invalid input.
int32_t gordo_resample(const int64_t* ts_ns, const double* vals, int64_t n,
                       int64_t origin_ns, int64_t bucket_ns, int64_t n_buckets,
                       const int32_t* aggs, int32_t n_aggs, double* out) {
  if (bucket_ns <= 0 || n_buckets < 0 || n_aggs <= 0) return 1;

  bool need_median = false;
  for (int32_t a = 0; a < n_aggs; ++a) {
    if (aggs[a] < kMean || aggs[a] > kMedian) return 2;
    if (aggs[a] == kMedian) need_median = true;
  }

  std::vector<double> sum(n_buckets, 0.0);
  std::vector<double> mn(n_buckets, kNaN);
  std::vector<double> mx(n_buckets, kNaN);
  std::vector<int64_t> cnt(n_buckets, 0);
  // per-bucket values only gathered when median is requested
  std::vector<std::vector<double>> per_bucket;
  if (need_median) per_bucket.resize(n_buckets);

  for (int64_t i = 0; i < n; ++i) {
    const double v = vals[i];
    if (std::isnan(v)) continue;
    const int64_t rel = ts_ns[i] - origin_ns;
    if (rel < 0) continue;
    const int64_t b = rel / bucket_ns;
    if (b >= n_buckets) continue;
    sum[b] += v;
    if (cnt[b] == 0) {
      mn[b] = v;
      mx[b] = v;
    } else {
      mn[b] = std::min(mn[b], v);
      mx[b] = std::max(mx[b], v);
    }
    ++cnt[b];
    if (need_median) per_bucket[b].push_back(v);
  }

  for (int32_t a = 0; a < n_aggs; ++a) {
    double* row = out + static_cast<int64_t>(a) * n_buckets;
    switch (aggs[a]) {
      case kMean:
        for (int64_t b = 0; b < n_buckets; ++b)
          row[b] = cnt[b] ? sum[b] / static_cast<double>(cnt[b]) : kNaN;
        break;
      case kMin:
        for (int64_t b = 0; b < n_buckets; ++b) row[b] = mn[b];
        break;
      case kMax:
        for (int64_t b = 0; b < n_buckets; ++b) row[b] = mx[b];
        break;
      case kSum:
        for (int64_t b = 0; b < n_buckets; ++b) row[b] = sum[b];
        break;
      case kCount:
        for (int64_t b = 0; b < n_buckets; ++b)
          row[b] = static_cast<double>(cnt[b]);
        break;
      case kMedian:
        for (int64_t b = 0; b < n_buckets; ++b) {
          std::vector<double>& pb = per_bucket[b];
          if (pb.empty()) {
            row[b] = kNaN;
            continue;
          }
          const size_t mid = pb.size() / 2;
          std::nth_element(pb.begin(), pb.begin() + mid, pb.end());
          double hi = pb[mid];
          if (pb.size() % 2 == 1) {
            row[b] = hi;
          } else {
            double lo = *std::max_element(pb.begin(), pb.begin() + mid);
            row[b] = 0.5 * (lo + hi);
          }
        }
        break;
    }
  }
  return 0;
}

// Rolling-min-then-global-max (threshold math: pandas rolling(w).min().max()).
//   vals: [n] input; returns NaN when n < w. Monotonic-deque sliding minimum,
//   O(n) for any window size.
double gordo_rolling_min_max(const double* vals, int64_t n, int64_t w) {
  if (w <= 0 || n < w) return kNaN;
  std::vector<int64_t> deque(n);
  int64_t head = 0, tail = 0;  // deque[head..tail) holds candidate indices
  double best = kNaN;
  bool any = false;
  // pandas rolling(w).min() yields NaN for any window containing a NaN
  // (min_periods defaults to the window size), and NaN windows never
  // contribute to the max — so a window only counts when the trailing
  // run of non-NaN values is at least w long
  int64_t run = 0;  // consecutive non-NaN count ending at i
  for (int64_t i = 0; i < n; ++i) {
    if (std::isnan(vals[i])) {
      run = 0;
      head = tail = 0;
      continue;
    }
    ++run;
    while (tail > head && vals[deque[tail - 1]] >= vals[i]) --tail;
    deque[tail++] = i;
    while (deque[head] <= i - w) ++head;
    if (run >= w) {
      const double wmin = vals[deque[head]];
      if (!any || wmin > best) {
        best = wmin;
        any = true;
      }
    }
  }
  return any ? best : kNaN;
}

}  // extern "C"

// ------------------------------------------------------------------------
// Serving codec kernels: strict request-body parser and template response
// encoder for the hot prediction path. Both are parity-first: any input
// the C grammar can't prove equivalent to the Python json path returns a
// "fallback" code and the caller re-runs the pure-Python codec.

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  return p;
}

// Strict JSON number (RFC 8259 grammar) plus the NaN/Infinity/-Infinity
// constants and null that Python's json.loads accepts. Returns the position
// past the token, or nullptr to signal fallback. Parity notes:
//   - strtod is correctly rounded, so float tokens match Python's float()
//   - "1e999" overflows to inf in both (Python float() saturates)
//   - integer tokens become Python ints then float64 via np.asarray; that
//     matches strtod except "-0" (int 0 -> +0.0) which we normalize, and
//     huge integers (exact bignum -> float64 can raise OverflowError), so
//     integer tokens longer than 18 digits bail to the Python path
inline const char* parse_num(const char* p, const char* end, double* out) {
  if (p >= end) return nullptr;
  if (*p == 'n') {
    if (end - p >= 4 && std::memcmp(p, "null", 4) == 0) {
      *out = kNaN;
      return p + 4;
    }
    return nullptr;
  }
  if (*p == 'N') {
    if (end - p >= 3 && std::memcmp(p, "NaN", 3) == 0) {
      *out = kNaN;
      return p + 3;
    }
    return nullptr;
  }
  const char* start = p;
  bool neg = false;
  if (*p == '-') {
    neg = true;
    ++p;
    if (p >= end) return nullptr;
  }
  if (*p == 'I') {
    if (end - p >= 8 && std::memcmp(p, "Infinity", 8) == 0) {
      *out = neg ? -std::numeric_limits<double>::infinity()
                 : std::numeric_limits<double>::infinity();
      return p + 8;
    }
    return nullptr;
  }
  const char* int_start = p;
  if (*p == '0') {
    ++p;
  } else if (*p >= '1' && *p <= '9') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') ++p;
  } else {
    return nullptr;
  }
  const long int_digits = static_cast<long>(p - int_start);
  bool is_int = true;
  if (p < end && *p == '.') {
    ++p;
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    while (p < end && *p >= '0' && *p <= '9') ++p;
    is_int = false;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    if (p < end && (*p == '+' || *p == '-')) ++p;
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    while (p < end && *p >= '0' && *p <= '9') ++p;
    is_int = false;
  }
  if (is_int && int_digits > 18) return nullptr;
  char* strtod_end = nullptr;
  double v = std::strtod(start, &strtod_end);
  if (strtod_end != p) return nullptr;
  if (is_int && v == 0.0) v = 0.0;  // "-0" is int 0 -> +0.0 in Python
  *out = v;
  return p;
}

// [[num, ...], ...] into row-major `out` (capacity `cap` doubles). Ragged,
// empty, or nested-deeper matrices return nullptr (the Python path decides
// whether that's a 400 or a legitimate shape).
const char* parse_matrix(const char* p, const char* end, double* out,
                         int64_t cap, int64_t* shape) {
  p = skip_ws(p, end);
  if (p >= end || *p != '[') return nullptr;
  ++p;
  p = skip_ws(p, end);
  if (p < end && *p == ']') return nullptr;  // empty matrix
  int64_t rows = 0, cols = -1, total = 0;
  while (true) {
    p = skip_ws(p, end);
    if (p >= end || *p != '[') return nullptr;
    ++p;
    p = skip_ws(p, end);
    if (p < end && *p == ']') return nullptr;  // empty row
    int64_t c = 0;
    while (true) {
      p = skip_ws(p, end);
      if (total >= cap) return nullptr;
      p = parse_num(p, end, &out[total]);
      if (p == nullptr) return nullptr;
      ++total;
      ++c;
      p = skip_ws(p, end);
      if (p >= end) return nullptr;
      if (*p == ',') {
        ++p;
        continue;
      }
      if (*p == ']') {
        ++p;
        break;
      }
      return nullptr;
    }
    if (cols < 0) {
      cols = c;
    } else if (c != cols) {
      return nullptr;
    }
    ++rows;
    p = skip_ws(p, end);
    if (p >= end) return nullptr;
    if (*p == ',') {
      ++p;
      continue;
    }
    if (*p == ']') {
      ++p;
      break;
    }
    return nullptr;
  }
  shape[0] = rows;
  shape[1] = cols;
  return p;
}

// One JSON string token with NO escapes and no raw control bytes: returns the
// position past the closing quote and records the content span. Escaped
// spellings ("A") would need full JSON string semantics to match
// json.loads — those bail to the Python path (nullptr), which is always
// parity-safe. Raw UTF-8 passes through: the Python side decodes the span
// exactly as json.loads would.
inline const char* parse_plain_string(const char* p, const char* end,
                                      const char** tok_start,
                                      const char** tok_end) {
  if (p >= end || *p != '"') return nullptr;
  ++p;
  const char* s = p;
  while (p < end) {
    const unsigned char c = static_cast<unsigned char>(*p);
    if (c == '"') {
      *tok_start = s;
      *tok_end = p;
      return p + 1;
    }
    if (c == '\\' || c < 0x20) return nullptr;
    ++p;
  }
  return nullptr;
}

// {name: {key: num, ...}, ...} (the dataframe_to_dict flat column shape)
// into column-major `out` plus token spans for the index keys (first
// column's, as offsets into the body) and the column names. Every column
// must carry the byte-identical key sequence — ragged or reordered columns
// take the pandas label-alignment path. Duplicate names/keys would collapse
// in json.loads (last wins), so they bail too. Returns the position past
// the closing '}', or nullptr for fallback.
const char* parse_coldict(const char* base, const char* p, const char* end,
                          double* out, int64_t cap, int64_t* key_off,
                          int32_t* key_len, int64_t key_cap, int64_t* name_off,
                          int32_t* name_len, int64_t name_cap, int64_t* shape) {
  p = skip_ws(p, end);
  if (p >= end || *p != '{') return nullptr;
  ++p;
  p = skip_ws(p, end);
  if (p < end && *p == '}') return nullptr;  // empty dict
  std::unordered_set<std::string_view> seen_keys;
  int64_t rows = -1, cols = 0, total = 0;
  while (true) {
    p = skip_ws(p, end);
    const char *ns, *ne;
    p = parse_plain_string(p, end, &ns, &ne);
    if (p == nullptr) return nullptr;
    if (cols >= name_cap) return nullptr;
    for (int64_t c = 0; c < cols; ++c) {
      if (name_len[c] == ne - ns &&
          std::memcmp(base + name_off[c], ns, ne - ns) == 0)
        return nullptr;  // duplicate column name
    }
    name_off[cols] = ns - base;
    name_len[cols] = static_cast<int32_t>(ne - ns);
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return nullptr;
    ++p;
    p = skip_ws(p, end);
    if (p >= end || *p != '{') return nullptr;
    ++p;
    p = skip_ws(p, end);
    if (p < end && *p == '}') return nullptr;  // empty column
    int64_t r = 0;
    while (true) {
      p = skip_ws(p, end);
      const char *ks, *ke;
      p = parse_plain_string(p, end, &ks, &ke);
      if (p == nullptr) return nullptr;
      if (cols == 0) {
        if (r >= key_cap) return nullptr;
        if (!seen_keys.emplace(ks, static_cast<size_t>(ke - ks)).second)
          return nullptr;  // duplicate index key
        key_off[r] = ks - base;
        key_len[r] = static_cast<int32_t>(ke - ks);
      } else if (r >= rows || key_len[r] != ke - ks ||
                 std::memcmp(base + key_off[r], ks, ke - ks) != 0) {
        return nullptr;
      }
      p = skip_ws(p, end);
      if (p >= end || *p != ':') return nullptr;
      ++p;
      p = skip_ws(p, end);
      if (total >= cap) return nullptr;
      p = parse_num(p, end, &out[total]);
      if (p == nullptr) return nullptr;
      ++total;
      ++r;
      p = skip_ws(p, end);
      if (p >= end) return nullptr;
      if (*p == ',') {
        ++p;
        continue;
      }
      if (*p == '}') {
        ++p;
        break;
      }
      return nullptr;
    }
    if (rows < 0) {
      rows = r;
    } else if (r != rows) {
      return nullptr;
    }
    ++cols;
    p = skip_ws(p, end);
    if (p >= end) return nullptr;
    if (*p == ',') {
      ++p;
      continue;
    }
    if (*p == '}') {
      ++p;
      break;
    }
    return nullptr;
  }
  shape[0] = rows;
  shape[1] = cols;
  return p;
}

// --------------------------------------------------------- float formatting
//
// Shortest round-tripping digit generation via Grisu3 (Loitsch 2010; the
// double-conversion FastDtoa shortest mode). Grisu3 is exact-or-bails: when
// it returns true the digits are provably the shortest correctly-rounded
// decimal (identical to CPython's dtoa mode 0, i.e. repr), and for the
// ~0.5% of doubles where the 64-bit arithmetic can't prove optimality it
// returns false and we fall back to CPython's dtoa. ~10x faster than dtoa
// on full-precision doubles, which is what a float response body is full of.

struct DiyFp {
  uint64_t f;
  int e;
};

inline DiyFp diy_normalize(DiyFp v) {
  const int shift = __builtin_clzll(v.f);
  v.f <<= shift;
  v.e -= shift;
  return v;
}

inline DiyFp diy_from_double(double d) {
  uint64_t bits;
  std::memcpy(&bits, &d, 8);
  const uint64_t kHidden = 1ULL << 52;
  const uint64_t sig = bits & (kHidden - 1);
  const int biased = static_cast<int>((bits >> 52) & 0x7FF);
  if (biased != 0) return {sig + kHidden, biased - 1075};
  return {sig, -1074};
}

inline DiyFp diy_multiply(DiyFp x, DiyFp y) {
  const unsigned __int128 p =
      static_cast<unsigned __int128>(x.f) * static_cast<unsigned __int128>(y.f);
  uint64_t h = static_cast<uint64_t>(p >> 64);
  if (static_cast<uint64_t>(p) & (1ULL << 63)) ++h;  // round
  return {h, x.e + y.e + 64};
}

struct CachedPower {
  uint64_t significand;
  int16_t binary_exponent;
  int16_t decimal_exponent;
};

// 10^d for d = -348..340 step 8, as round-to-nearest 64-bit significands
// (generated with exact integer arithmetic; spot-checked against the
// canonical double-conversion cached-powers table).
const CachedPower kCachedPowers[] = {
    {0xfa8fd5a0081c0288, -1220, -348}, {0xbaaee17fa23ebf76, -1193, -340}, {0x8b16fb203055ac76, -1166, -332},
    {0xcf42894a5dce35ea, -1140, -324}, {0x9a6bb0aa55653b2d, -1113, -316}, {0xe61acf033d1a45df, -1087, -308},
    {0xab70fe17c79ac6ca, -1060, -300}, {0xff77b1fcbebcdc4f, -1034, -292}, {0xbe5691ef416bd60c, -1007, -284},
    {0x8dd01fad907ffc3c, -980, -276}, {0xd3515c2831559a83, -954, -268}, {0x9d71ac8fada6c9b5, -927, -260},
    {0xea9c227723ee8bcb, -901, -252}, {0xaecc49914078536d, -874, -244}, {0x823c12795db6ce57, -847, -236},
    {0xc21094364dfb5637, -821, -228}, {0x9096ea6f3848984f, -794, -220}, {0xd77485cb25823ac7, -768, -212},
    {0xa086cfcd97bf97f4, -741, -204}, {0xef340a98172aace5, -715, -196}, {0xb23867fb2a35b28e, -688, -188},
    {0x84c8d4dfd2c63f3b, -661, -180}, {0xc5dd44271ad3cdba, -635, -172}, {0x936b9fcebb25c996, -608, -164},
    {0xdbac6c247d62a584, -582, -156}, {0xa3ab66580d5fdaf6, -555, -148}, {0xf3e2f893dec3f126, -529, -140},
    {0xb5b5ada8aaff80b8, -502, -132}, {0x87625f056c7c4a8b, -475, -124}, {0xc9bcff6034c13053, -449, -116},
    {0x964e858c91ba2655, -422, -108}, {0xdff9772470297ebd, -396, -100}, {0xa6dfbd9fb8e5b88f, -369, -92},
    {0xf8a95fcf88747d94, -343, -84}, {0xb94470938fa89bcf, -316, -76}, {0x8a08f0f8bf0f156b, -289, -68},
    {0xcdb02555653131b6, -263, -60}, {0x993fe2c6d07b7fac, -236, -52}, {0xe45c10c42a2b3b06, -210, -44},
    {0xaa242499697392d3, -183, -36}, {0xfd87b5f28300ca0e, -157, -28}, {0xbce5086492111aeb, -130, -20},
    {0x8cbccc096f5088cc, -103, -12}, {0xd1b71758e219652c, -77, -4}, {0x9c40000000000000, -50, 4},
    {0xe8d4a51000000000, -24, 12}, {0xad78ebc5ac620000, 3, 20}, {0x813f3978f8940984, 30, 28},
    {0xc097ce7bc90715b3, 56, 36}, {0x8f7e32ce7bea5c70, 83, 44}, {0xd5d238a4abe98068, 109, 52},
    {0x9f4f2726179a2245, 136, 60}, {0xed63a231d4c4fb27, 162, 68}, {0xb0de65388cc8ada8, 189, 76},
    {0x83c7088e1aab65db, 216, 84}, {0xc45d1df942711d9a, 242, 92}, {0x924d692ca61be758, 269, 100},
    {0xda01ee641a708dea, 295, 108}, {0xa26da3999aef774a, 322, 116}, {0xf209787bb47d6b85, 348, 124},
    {0xb454e4a179dd1877, 375, 132}, {0x865b86925b9bc5c2, 402, 140}, {0xc83553c5c8965d3d, 428, 148},
    {0x952ab45cfa97a0b3, 455, 156}, {0xde469fbd99a05fe3, 481, 164}, {0xa59bc234db398c25, 508, 172},
    {0xf6c69a72a3989f5c, 534, 180}, {0xb7dcbf5354e9bece, 561, 188}, {0x88fcf317f22241e2, 588, 196},
    {0xcc20ce9bd35c78a5, 614, 204}, {0x98165af37b2153df, 641, 212}, {0xe2a0b5dc971f303a, 667, 220},
    {0xa8d9d1535ce3b396, 694, 228}, {0xfb9b7cd9a4a7443c, 720, 236}, {0xbb764c4ca7a44410, 747, 244},
    {0x8bab8eefb6409c1a, 774, 252}, {0xd01fef10a657842c, 800, 260}, {0x9b10a4e5e9913129, 827, 268},
    {0xe7109bfba19c0c9d, 853, 276}, {0xac2820d9623bf429, 880, 284}, {0x80444b5e7aa7cf85, 907, 292},
    {0xbf21e44003acdd2d, 933, 300}, {0x8e679c2f5e44ff8f, 960, 308}, {0xd433179d9c8cb841, 986, 316},
    {0x9e19db92b4e31ba9, 1013, 324}, {0xeb96bf6ebadf77d9, 1039, 332}, {0xaf87023b9bf0ee6b, 1066, 340},
};

const int kMinimalTargetExponent = -60;
const int kMaximalTargetExponent = -32;

inline void cached_power_for_binary_exponent(int min_exponent, DiyFp* power,
                                             int* decimal_exponent) {
  const double kD_1_LOG2_10 = 0.30102999566398114;
  const double k = std::ceil((min_exponent + 64 - 1) * kD_1_LOG2_10);
  const int index = (348 + static_cast<int>(k) - 1) / 8 + 1;
  const CachedPower& cp = kCachedPowers[index];
  *power = {cp.significand, cp.binary_exponent};
  *decimal_exponent = cp.decimal_exponent;
}

const uint32_t kSmallPowersOfTen[] = {0,      1,       10,       100,
                                      1000,   10000,   100000,   1000000,
                                      10000000, 100000000, 1000000000};

inline void biggest_power_ten(uint32_t number, int number_bits,
                              uint32_t* power, int* exponent_plus_one) {
  int guess = ((number_bits + 1) * 1233 >> 12) + 1;
  if (number < kSmallPowersOfTen[guess]) --guess;
  *power = kSmallPowersOfTen[guess];
  *exponent_plus_one = guess;
}

// Round the last generated digit toward w and verify unambiguity; false
// means another double shares the interval and Grisu3 must bail to dtoa.
bool round_weed(char* buffer, int length, uint64_t distance_too_high_w,
                uint64_t unsafe_interval, uint64_t rest, uint64_t ten_kappa,
                uint64_t unit) {
  const uint64_t small_distance = distance_too_high_w - unit;
  const uint64_t big_distance = distance_too_high_w + unit;
  while (rest < small_distance && unsafe_interval - rest >= ten_kappa &&
         (rest + ten_kappa < small_distance ||
          small_distance - rest >= rest + ten_kappa - small_distance)) {
    --buffer[length - 1];
    rest += ten_kappa;
  }
  if (rest < big_distance && unsafe_interval - rest >= ten_kappa &&
      (rest + ten_kappa < big_distance ||
       big_distance - rest > rest + ten_kappa - big_distance)) {
    return false;
  }
  return (2 * unit <= rest) && (rest <= unsafe_interval - 4 * unit);
}

bool digit_gen(DiyFp low, DiyFp w, DiyFp high, char* buffer, int* length,
               int* kappa) {
  uint64_t unit = 1;
  const DiyFp too_low = {low.f - unit, low.e};
  const DiyFp too_high = {high.f + unit, high.e};
  uint64_t unsafe_interval = too_high.f - too_low.f;
  const DiyFp one = {1ULL << -w.e, w.e};
  uint32_t integrals = static_cast<uint32_t>(too_high.f >> -one.e);
  uint64_t fractionals = too_high.f & (one.f - 1);
  uint32_t divisor;
  int divisor_exponent_plus_one;
  biggest_power_ten(integrals, 64 - (-one.e), &divisor,
                    &divisor_exponent_plus_one);
  *kappa = divisor_exponent_plus_one;
  *length = 0;
  while (*kappa > 0) {
    const int digit = integrals / divisor;
    buffer[(*length)++] = static_cast<char>('0' + digit);
    integrals %= divisor;
    --(*kappa);
    const uint64_t rest = (static_cast<uint64_t>(integrals) << -one.e) +
                          fractionals;
    if (rest < unsafe_interval) {
      return round_weed(buffer, *length, too_high.f - w.f, unsafe_interval,
                        rest, static_cast<uint64_t>(divisor) << -one.e, unit);
    }
    divisor /= 10;
  }
  for (;;) {
    fractionals *= 10;
    unit *= 10;
    unsafe_interval *= 10;
    const int digit = static_cast<int>(fractionals >> -one.e);
    buffer[(*length)++] = static_cast<char>('0' + digit);
    fractionals &= one.f - 1;
    --(*kappa);
    if (fractionals < unsafe_interval) {
      return round_weed(buffer, *length, (too_high.f - w.f) * unit,
                        unsafe_interval, fractionals, one.f, unit);
    }
  }
}

bool grisu3(double v, char* buffer, int* length, int* decimal_exponent) {
  const DiyFp w = diy_normalize(diy_from_double(v));
  // boundaries: the midpoints to the neighbouring doubles, normalized to
  // w's exponent; the lower one is closer when v sits on a power of 2
  const DiyFp raw = diy_from_double(v);
  DiyFp boundary_plus = diy_normalize({(raw.f << 1) + 1, raw.e - 1});
  uint64_t bits;
  std::memcpy(&bits, &v, 8);
  const bool physical_sig_zero = (bits & ((1ULL << 52) - 1)) == 0;
  const int biased = static_cast<int>((bits >> 52) & 0x7FF);
  DiyFp boundary_minus;
  if (physical_sig_zero && biased > 1) {
    boundary_minus = {(raw.f << 2) - 1, raw.e - 2};
  } else {
    boundary_minus = {(raw.f << 1) - 1, raw.e - 1};
  }
  boundary_minus.f <<= boundary_minus.e - boundary_plus.e;
  boundary_minus.e = boundary_plus.e;

  DiyFp ten_mk;
  int mk;
  cached_power_for_binary_exponent(kMinimalTargetExponent - (w.e + 64),
                                   &ten_mk, &mk);
  const DiyFp scaled_w = diy_multiply(w, ten_mk);
  const DiyFp scaled_minus = diy_multiply(boundary_minus, ten_mk);
  const DiyFp scaled_plus = diy_multiply(boundary_plus, ten_mk);
  int kappa;
  const bool result =
      digit_gen(scaled_minus, scaled_w, scaled_plus, buffer, length, &kappa);
  *decimal_exponent = -mk + kappa;
  return result;
}

// repr(float) for a finite double: shortest round-tripping digits (Grisu3
// fast path, CPython dtoa when Grisu3 can't prove optimality), assembled
// with CPython's format_float_short rules ('r' code + Py_DTSF_ADD_DOT_0):
// fixed notation for -4 < decpt <= 16 (".0" appended when integral), else
// d[.ddd]e±XX with a >= 2 digit exponent. Byte parity with json.dumps is
// asserted per template shape at runtime (fast_codec self-check) and
// fuzzed against repr in tests. Writes at most 25 bytes; returns the new
// write position, nullptr on dtoa failure.
char* format_repr(double v, char* p) {
  if (std::signbit(v)) {
    *p++ = '-';
    v = -v;
  }
  char grisu_buf[20];
  char* dtoa_buf = nullptr;
  const char* digits;
  long nd;
  int decpt;
  int glen, gexp;
  if (v == 0.0) {
    digits = "0";
    nd = 1;
    decpt = 1;
  } else if (grisu3(v, grisu_buf, &glen, &gexp)) {
    digits = grisu_buf;
    nd = glen;
    decpt = glen + gexp;
  } else {
    int sign = 0;
    char* end = nullptr;
    dtoa_buf = _Py_dg_dtoa(v, 0, 0, &decpt, &sign, &end);
    if (dtoa_buf == nullptr) return nullptr;
    digits = dtoa_buf;
    nd = end - dtoa_buf;
  }
  if (decpt <= -4 || decpt > 16) {
    *p++ = digits[0];
    if (nd > 1) {
      *p++ = '.';
      std::memcpy(p, digits + 1, nd - 1);
      p += nd - 1;
    }
    *p++ = 'e';
    int e = decpt - 1;
    if (e < 0) {
      *p++ = '-';
      e = -e;
    } else {
      *p++ = '+';
    }
    char ebuf[8];
    int ei = 0;
    do {
      ebuf[ei++] = static_cast<char>('0' + e % 10);
      e /= 10;
    } while (e);
    if (ei < 2) ebuf[ei++] = '0';
    while (ei) *p++ = ebuf[--ei];
  } else if (decpt <= 0) {
    *p++ = '0';
    *p++ = '.';
    for (int i = 0; i < -decpt; ++i) *p++ = '0';
    std::memcpy(p, digits, nd);
    p += nd;
  } else if (decpt >= nd) {
    std::memcpy(p, digits, nd);
    p += nd;
    for (long i = nd; i < decpt; ++i) *p++ = '0';
    *p++ = '.';
    *p++ = '0';
  } else {
    std::memcpy(p, digits, decpt);
    p += decpt;
    *p++ = '.';
    std::memcpy(p, digits + decpt, nd - decpt);
    p += nd - decpt;
  }
  if (dtoa_buf != nullptr) _Py_dg_freedtoa(dtoa_buf);
  return p;
}

}  // namespace

extern "C" {

// Parse a prediction request body of exactly the form
// {"X": [[...], ...]} or {"X": ..., "y": ...} ("y" may be null) into
// preallocated row-major buffers. Any other structure — extra keys,
// duplicate keys, escaped key spellings, trailing garbage — returns 0 and
// the caller falls back to json.loads. Returns 1 on success; yshape[0] is
// -1 when y is absent or null.
int32_t gordo_parse_xy(const char* s, int64_t n, double* xout, int64_t xcap,
                       int64_t* xshape, double* yout, int64_t ycap,
                       int64_t* yshape) {
  xshape[0] = -1;
  xshape[1] = -1;
  yshape[0] = -1;
  yshape[1] = -1;
  const char* end = s + n;
  const char* p = skip_ws(s, end);
  if (p >= end || *p != '{') return 0;
  ++p;
  bool have_x = false, have_y = false;
  while (true) {
    p = skip_ws(p, end);
    if (p + 3 > end || *p != '"' || p[2] != '"') return 0;
    const char key = p[1];
    if (key != 'X' && key != 'y') return 0;
    p += 3;
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return 0;
    ++p;
    if (key == 'X') {
      if (have_x) return 0;
      have_x = true;
      p = parse_matrix(p, end, xout, xcap, xshape);
      if (p == nullptr) return 0;
    } else {
      if (have_y) return 0;
      have_y = true;
      p = skip_ws(p, end);
      if (end - p >= 4 && std::memcmp(p, "null", 4) == 0) {
        p += 4;  // "y": null means y absent
      } else {
        p = parse_matrix(p, end, yout, ycap, yshape);
        if (p == nullptr) return 0;
      }
    }
    p = skip_ws(p, end);
    if (p >= end) return 0;
    if (*p == ',') {
      ++p;
      continue;
    }
    if (*p == '}') {
      ++p;
      break;
    }
    return 0;
  }
  if (!have_x || xshape[0] < 0) return 0;
  p = skip_ws(p, end);
  return p == end ? 1 : 0;
}

// Parse a prediction request body of exactly the form
// {"X": {name: {key: num, ...}, ...}} — the flat column-dict shape
// dataframe_to_dict emits — into a column-major float64 buffer plus token
// spans (offsets into the body) for the shared index keys and the column
// names. "y" may appear only as null (a column-dict y falls back to the
// Python path). Any other structure returns 0 and the caller falls back to
// json.loads. Returns 1 on success.
int32_t gordo_parse_body_cols(const char* s, int64_t n, double* out,
                              int64_t cap, int64_t* key_off, int32_t* key_len,
                              int64_t key_cap, int64_t* name_off,
                              int32_t* name_len, int64_t name_cap,
                              int64_t* shape) {
  shape[0] = -1;
  shape[1] = -1;
  const char* end = s + n;
  const char* p = skip_ws(s, end);
  if (p >= end || *p != '{') return 0;
  ++p;
  bool have_x = false, have_y = false;
  while (true) {
    p = skip_ws(p, end);
    if (p + 3 > end || *p != '"' || p[2] != '"') return 0;
    const char key = p[1];
    if (key != 'X' && key != 'y') return 0;
    p += 3;
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return 0;
    ++p;
    if (key == 'X') {
      if (have_x) return 0;
      have_x = true;
      p = parse_coldict(s, p, end, out, cap, key_off, key_len, key_cap,
                        name_off, name_len, name_cap, shape);
      if (p == nullptr) return 0;
    } else {
      if (have_y) return 0;
      have_y = true;
      p = skip_ws(p, end);
      if (end - p >= 4 && std::memcmp(p, "null", 4) == 0) {
        p += 4;
      } else {
        return 0;
      }
    }
    p = skip_ws(p, end);
    if (p >= end) return 0;
    if (*p == ',') {
      ++p;
      continue;
    }
    if (*p == '}') {
      ++p;
      break;
    }
    return 0;
  }
  if (!have_x || shape[0] < 0) return 0;
  p = skip_ws(p, end);
  return p == end ? 1 : 0;
}

// Render a response fragment from a precomputed byte template interleaved
// with repr-formatted doubles. pre_len has n_vals + 1 entries: bytes of
// template to copy before each value, plus the trailing chunk. Non-finite
// values render as "null" (simplejson ignore_nan parity). Returns the
// number of bytes written, or a negative code on overflow/format failure.
// Must be called with the GIL held: PyOS_double_to_string allocates via
// PyMem (the Python binding uses PYFUNCTYPE for exactly this reason).
int64_t gordo_encode_tpl(const char* tmpl, const int32_t* pre_len,
                         int64_t n_vals, const double* vals, char* out,
                         int64_t cap) {
  const char* t = tmpl;
  char* p = out;
  const char* lim = out + cap;
  for (int64_t i = 0; i < n_vals; ++i) {
    const int32_t chunk = pre_len[i];
    // 32 covers the longest float repr (~24 chars) and "null"
    if (p + chunk + 32 > lim) return -1;
    std::memcpy(p, t, chunk);
    p += chunk;
    t += chunk;
    const double v = vals[i];
    if (std::isfinite(v)) {
      p = format_repr(v, p);
      if (p == nullptr) return -2;
    } else {
      std::memcpy(p, "null", 4);
      p += 4;
    }
  }
  const int32_t tail = pre_len[n_vals];
  if (p + tail > lim) return -1;
  std::memcpy(p, t, tail);
  p += tail;
  return p - out;
}

}  // extern "C"
