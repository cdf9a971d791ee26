// Host-side native code of sparse_tpu_torch: work that runs on CPU
// tensors only, outside the card's compute path.
//
//   * a two-pass Gustavson SpGEMM, C = A @ B for CSR operands (count the
//     nonzeros of each row with a row-stamped mask, then fill with a
//     linked-list accumulator and sort each row), values in double;
//   * the MatrixMarket body tokenizers of io.mmread (coordinate lines and
//     the dense "array" body), one pass over the bytes.
//
// Built with g++ -O3 -shared -fPIC on first use by sparse_tpu_torch/native.py
// and bound with ctypes; callers take their plain path when it cannot be.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <utility>
#include <vector>

extern "C" {

// Pass 1: per-row nnz of C via a row-stamped dense mask. Returns total nnz.
int64_t spgemm_count(int64_t m, int64_t n,
                     const int64_t* Ap, const int64_t* Aj,
                     const int64_t* Bp, const int64_t* Bj,
                     int64_t* Cp) {
  std::vector<int64_t> mask(static_cast<size_t>(n), -1);
  Cp[0] = 0;
  int64_t nnz = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t row_nnz = 0;
    for (int64_t jj = Ap[i]; jj < Ap[i + 1]; ++jj) {
      const int64_t j = Aj[jj];
      for (int64_t kk = Bp[j]; kk < Bp[j + 1]; ++kk) {
        const int64_t k = Bj[kk];
        if (mask[static_cast<size_t>(k)] != i) {
          mask[static_cast<size_t>(k)] = i;
          ++row_nnz;
        }
      }
    }
    nnz += row_nnz;
    Cp[i + 1] = nnz;
  }
  return nnz;
}

// Pass 2: fill values with a linked-list accumulator, then sort each row's
// (column, value) pairs so the output is canonical CSR.
void spgemm_fill(int64_t m, int64_t n,
                 const int64_t* Ap, const int64_t* Aj, const double* Ax,
                 const int64_t* Bp, const int64_t* Bj, const double* Bx,
                 const int64_t* Cp, int64_t* Cj, double* Cx) {
  std::vector<int64_t> next(static_cast<size_t>(n), -1);
  std::vector<double> sums(static_cast<size_t>(n), 0.0);
  std::vector<std::pair<int64_t, double>> row;
  for (int64_t i = 0; i < m; ++i) {
    int64_t head = -2;
    int64_t length = 0;
    for (int64_t jj = Ap[i]; jj < Ap[i + 1]; ++jj) {
      const int64_t j = Aj[jj];
      const double v = Ax[jj];
      for (int64_t kk = Bp[j]; kk < Bp[j + 1]; ++kk) {
        const int64_t k = Bj[kk];
        sums[static_cast<size_t>(k)] += v * Bx[kk];
        if (next[static_cast<size_t>(k)] == -1) {
          next[static_cast<size_t>(k)] = head;
          head = k;
          ++length;
        }
      }
    }
    row.clear();
    row.reserve(static_cast<size_t>(length));
    for (int64_t cnt = 0; cnt < length; ++cnt) {
      row.emplace_back(head, sums[static_cast<size_t>(head)]);
      const int64_t tmp = head;
      head = next[static_cast<size_t>(head)];
      next[static_cast<size_t>(tmp)] = -1;
      sums[static_cast<size_t>(tmp)] = 0.0;
    }
    std::sort(row.begin(), row.end());
    int64_t out = Cp[i];
    for (const auto& cv : row) {
      Cj[out] = cv.first;
      Cx[out] = cv.second;
      ++out;
    }
  }
}

// Parse `nnz` coordinate lines starting at `body` (after header/size line).
// kind: 0 = pattern (no value), 1 = real/integer (1 value), 2 = complex.
// Returns the number of entries parsed (== nnz on success, < nnz on error).
int64_t mtx_parse_body(const char* body, int64_t body_len, int64_t nnz,
                       int32_t kind, int64_t* rows, int64_t* cols,
                       double* vals_re, double* vals_im) {
  const char* p = body;
  const char* end = body + body_len;
  int64_t i = 0;
  while (i < nnz && p < end) {
    // skip whitespace/newlines and comment lines
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
      p++;
    }
    if (p < end && *p == '%') {
      while (p < end && *p != '\n') p++;
      continue;
    }
    if (p >= end) break;
    char* next;
    long long r = strtoll(p, &next, 10);
    if (next == p) break;
    p = next;
    long long c = strtoll(p, &next, 10);
    if (next == p) break;
    p = next;
    rows[i] = r - 1;  // MatrixMarket is 1-based
    cols[i] = c - 1;
    if (kind == 0) {
      vals_re[i] = 1.0;
    } else {
      double re = strtod(p, &next);
      if (next == p) break;
      p = next;
      vals_re[i] = re;
      if (kind == 2) {
        double im = strtod(p, &next);
        if (next == p) break;
        p = next;
        vals_im[i] = im;
      }
    }
    i++;
  }
  return i;
}

// Parse a whitespace-separated array of doubles (MatrixMarket "array" body).
int64_t mtx_parse_dense(const char* body, int64_t body_len, int64_t count,
                        double* out) {
  const char* p = body;
  const char* end = body + body_len;
  int64_t i = 0;
  while (i < count && p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
      p++;
    }
    if (p < end && *p == '%') {
      while (p < end && *p != '\n') p++;
      continue;
    }
    if (p >= end) break;
    char* next;
    double v = strtod(p, &next);
    if (next == p) break;
    p = next;
    out[i++] = v;
  }
  return i;
}

}  // extern "C"
