// Native data-loading runtime: multithreaded CSV/TSV parsing.
//
// Host-side counterpart of the reference's C++ IO layer
// (reference: src/io/parser.cpp CSV/TSV parsers + utils/text_reader.h
// buffered line reading + pipeline_reader.h double buffering).  The
// hot loop is a branch-light strtod-style float scan; rows are split
// across a thread pool after a newline-index pre-pass, writing
// directly into one contiguous row-major double buffer handed to
// Python via ctypes (no pybind11 dependency).
//
// Exports (C ABI):
//   ltpu_load_csv(path, sep, skip_rows, &rows, &cols) -> double* | null
//   ltpu_free(ptr)
//   ltpu_count_lines(path) -> long
//   ltpu_bin_values(values, n, bounds, nb, missing_type, out_bins)

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// double parse, correctly rounded (the value strtod and numpy give):
// a plain decimal of at most 19 significant digits whose mantissa fits
// 2^53 and whose power of ten is within 1e22 is one exact mantissa
// times or over one exact power of ten, a single rounding (Clinger's
// fast path); anything else (longer mantissas, large exponents,
// inf, hex) goes to strtod
inline const char* parse_double(const char* p, double* out) {
  static const double kPow10[] = {
      1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
      1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
  while (*p == ' ' || *p == '\t') ++p;
  const char* start = p;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') ++p;
  if ((p[0] == 'n' || p[0] == 'N') && (p[1] == 'a' || p[1] == 'A')) {
    *out = std::nan("");
    p += 2;
    if (*p == 'n' || *p == 'N') ++p;
    return p;
  }
  uint64_t mant = 0;
  int sig = 0, digits = 0, exp10 = 0;
  bool exact = true;
  while (*p >= '0' && *p <= '9') {
    int d = *p - '0';
    if (sig < 19) {
      if (mant != 0 || d != 0) { mant = mant * 10 + d; ++sig; }
    } else {
      ++exp10;
      if (d != 0) exact = false;
    }
    ++p; ++digits;
  }
  if (*p == '.') {
    ++p;
    while (*p >= '0' && *p <= '9') {
      int d = *p - '0';
      if (sig < 19) {
        if (mant != 0 || d != 0) { mant = mant * 10 + d; ++sig; }
        --exp10;
      } else if (d != 0) {
        exact = false;
      }
      ++p; ++digits;
    }
  }
  if (digits == 0) {  // not a plain number: strtod fallback
    char* end = nullptr;
    *out = std::strtod(start, &end);
    if (end == start) { *out = std::nan(""); ++p; return p; }
    return end;
  }
  if (*p == 'e' || *p == 'E') {
    const char* q = p + 1;
    bool eneg = false;
    if (*q == '-') { eneg = true; ++q; }
    else if (*q == '+') ++q;
    if (*q >= '0' && *q <= '9') {
      int ex = 0;
      while (*q >= '0' && *q <= '9') {
        if (ex < 100000) ex = ex * 10 + (*q - '0');
        ++q;
      }
      exp10 += eneg ? -ex : ex;
      p = q;
    }
  }
  if (mant == 0) {
    *out = neg ? -0.0 : 0.0;
    return p;
  }
  if (exact && mant <= (uint64_t(1) << 53) && exp10 >= -22 && exp10 <= 22) {
    double v = static_cast<double>(mant);
    v = exp10 < 0 ? v / kPow10[-exp10] : v * kPow10[exp10];
    *out = neg ? -v : v;
    return p;
  }
  char* end = nullptr;
  *out = std::strtod(start, &end);
  return end;
}

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  ~FileBuf() { std::free(data); }
  bool read(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (sz < 0) { std::fclose(f); return false; }
    data = static_cast<char*>(std::malloc(sz + 1));
    if (!data) { std::fclose(f); return false; }
    size = std::fread(data, 1, sz, f);
    data[size] = '\0';
    std::fclose(f);
    return true;
  }
};

}  // namespace

extern "C" {

long ltpu_count_lines(const char* path) {
  FileBuf buf;
  if (!buf.read(path)) return -1;
  long n = 0;
  for (size_t i = 0; i < buf.size; ++i) {
    if (buf.data[i] == '\n') ++n;
  }
  if (buf.size > 0 && buf.data[buf.size - 1] != '\n') ++n;
  return n;
}

// Parse a CSV/TSV file of floats into a freshly-malloc'd row-major
// (rows x cols) double array.  Returns nullptr on error.
double* ltpu_load_csv(const char* path, char sep, int skip_rows,
                      int64_t* out_rows, int64_t* out_cols) {
  FileBuf buf;
  if (!buf.read(path)) return nullptr;
  char* data = buf.data;
  size_t size = buf.size;

  // line-start index pre-pass
  std::vector<size_t> line_starts;
  line_starts.push_back(0);
  for (size_t i = 0; i < size; ++i) {
    if (data[i] == '\n' && i + 1 < size) line_starts.push_back(i + 1);
  }
  // drop trailing blank lines
  while (!line_starts.empty()) {
    size_t s = line_starts.back();
    bool blank = true;
    for (size_t i = s; i < size && data[i] != '\n'; ++i) {
      if (!std::isspace(static_cast<unsigned char>(data[i]))) {
        blank = false;
        break;
      }
    }
    if (blank) line_starts.pop_back(); else break;
  }
  if (static_cast<size_t>(skip_rows) >= line_starts.size()) return nullptr;
  size_t first = static_cast<size_t>(skip_rows);
  int64_t rows = static_cast<int64_t>(line_starts.size() - first);

  // column count from the first data row
  int64_t cols = 1;
  for (size_t i = line_starts[first]; i < size && data[i] != '\n'; ++i) {
    if (data[i] == sep) ++cols;
  }

  double* out = static_cast<double*>(
      std::malloc(sizeof(double) * rows * cols));
  if (!out) return nullptr;

  int nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (rows < nthreads * 64) nthreads = 1;
  std::atomic<bool> ok{true};

  auto worker = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const char* p = data + line_starts[first + r];
      double* row = out + r * cols;
      for (int64_t c = 0; c < cols; ++c) {
        double v = std::nan("");
        if (*p != sep && *p != '\n' && *p != '\r' && *p != '\0') {
          p = parse_double(p, &v);
        }
        row[c] = v;
        while (*p != sep && *p != '\n' && *p != '\0') ++p;
        if (*p == sep) ++p;
      }
    }
  };

  if (nthreads == 1) {
    worker(0, rows);
  } else {
    std::vector<std::thread> pool;
    int64_t per = (rows + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      int64_t r0 = t * per;
      int64_t r1 = r0 + per < rows ? r0 + per : rows;
      if (r0 >= r1) break;
      pool.emplace_back(worker, r0, r1);
    }
    for (auto& th : pool) th.join();
  }
  if (!ok.load()) { std::free(out); return nullptr; }
  *out_rows = rows;
  *out_cols = cols;
  return out;
}

void ltpu_free(double* ptr) { std::free(ptr); }

// Batch value->bin for one numerical feature (the reference's
// ValueToBin binary search, bin.h:450-486, vectorized + threaded).
void ltpu_bin_values(const double* values, int64_t n,
                     const double* bounds, int32_t num_bin,
                     int32_t missing_type, uint8_t* out_bins) {
  const int32_t search_n =
      missing_type == 2 ? num_bin - 1 : num_bin;  // 2 = NaN type
  auto one = [&](int64_t i) {
    double v = values[i];
    if (std::isnan(v)) {
      if (missing_type == 2) {
        out_bins[i] = static_cast<uint8_t>(num_bin - 1);
        return;
      }
      v = 0.0;
    }
    int32_t lo = 0, hi = search_n - 1;
    while (lo < hi) {
      int32_t mid = (lo + hi - 1) / 2;
      if (v <= bounds[mid]) hi = mid; else lo = mid + 1;
    }
    out_bins[i] = static_cast<uint8_t>(lo);
  };
  int nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1 || n < 1 << 16) nthreads = 1;
  if (nthreads == 1) {
    for (int64_t i = 0; i < n; ++i) one(i);
  } else {
    std::vector<std::thread> pool;
    int64_t per = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      int64_t i0 = t * per;
      int64_t i1 = i0 + per < n ? i0 + per : n;
      if (i0 >= i1) break;
      pool.emplace_back([&, i0, i1]() {
        for (int64_t i = i0; i < i1; ++i) one(i);
      });
    }
    for (auto& th : pool) th.join();
  }
}

}  // extern "C"
