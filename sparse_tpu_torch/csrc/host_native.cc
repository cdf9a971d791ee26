// Host-side native code of sparse_tpu_torch: work that runs on CPU
// tensors only, outside the card's compute path.
//
//   * a two-pass Gustavson SpGEMM, C = A @ B for CSR operands (count the
//     nonzeros of each row with a row-stamped mask, then fill with a
//     linked-list accumulator and sort each row), values in double;
//   * the MatrixMarket body tokenizers of io.mmread (coordinate lines and
//     the dense "array" body), one pass over the bytes;
//   * the factorizations behind linalg's direct solvers and incomplete
//     preconditioners (_direct.py): ILU(0) and IC(0) on a canonical CSR,
//     and a Gilbert-Peierls left-looking sparse LU with partial pivoting
//     (exact, or ILUT with threshold and fill-cap drops). They are
//     row- or column-sequential, so they run here as setup steps; the
//     triangular solves with their factors run on the tensors' device;
//   * the independent-set BFS expansion of quantum.py's Hamiltonian build
//     (one level of bitset sets at a time).
//
// Built with g++ -O3 -shared -fPIC on first use by sparse_tpu_torch/native.py
// and bound with ctypes; callers take their plain path when it cannot be.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
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

// ---------------------------------------------------------------------------
// ILU(0), IC(0) and sparse LU
// ---------------------------------------------------------------------------

extern "C" {

// In-place ILU(0), IKJ form, on a canonical (sorted, deduplicated) CSR.
// After return data holds L (strict lower, unit diagonal implicit) and U
// (upper incl. diagonal) on A's sparsity pattern. Returns 0, or -(i+1) if
// row i has no structural diagonal / a zero pivot.
int64_t ilu0_csr(int64_t n, const int64_t* indptr, const int64_t* indices,
                 double* data) {
  std::vector<int64_t> pos(n, -1);
  std::vector<int64_t> diag(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (indices[p] == i) {
        diag[i] = p;
        break;
      }
    }
    if (diag[i] < 0) return -(i + 1);
  }
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) pos[indices[p]] = p;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t k = indices[p];
      if (k >= i) break;
      double ukk = data[diag[k]];
      if (ukk == 0.0) return -(k + 1);
      double lik = data[p] / ukk;
      data[p] = lik;
      for (int64_t q = diag[k] + 1; q < indptr[k + 1]; ++q) {
        int64_t pj = pos[indices[q]];
        if (pj >= 0) data[pj] -= lik * data[q];
      }
    }
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) pos[indices[p]] = -1;
    if (data[diag[i]] == 0.0) return -(i + 1);
  }
  return 0;
}

// In-place IC(0) on the LOWER-triangular part of an SPD matrix in canonical
// CSR (each row's diagonal entry is its last). After return data holds L
// with A ~= L L^T on the lower pattern. Returns 0, or -(i+1) on a missing
// diagonal / non-positive pivot (matrix not SPD enough for IC(0)).
int64_t ic0_csr(int64_t n, const int64_t* indptr, const int64_t* indices,
                double* data) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t pi0 = indptr[i], pi1 = indptr[i + 1];
    if (pi1 <= pi0 || indices[pi1 - 1] != i) return -(i + 1);
    for (int64_t p = pi0; p < pi1; ++p) {
      int64_t j = indices[p];
      // dot of L rows i and j over columns < j (two-pointer, sorted CSR)
      double s = 0.0;
      int64_t a = pi0;
      int64_t b = indptr[j], b1 = indptr[j + 1] - 1;  // exclude row j's diag
      while (a < p && b < b1) {
        int64_t ca = indices[a], cb = indices[b];
        if (ca == cb) {
          s += data[a] * data[b];
          ++a;
          ++b;
        } else if (ca < cb) {
          ++a;
        } else {
          ++b;
        }
      }
      if (j < i) {
        double ljj = data[indptr[j + 1] - 1];
        if (ljj == 0.0) return -(j + 1);
        data[p] = (data[p] - s) / ljj;
      } else {
        double v = data[p] - s;
        if (v <= 0.0) return -(i + 1);
        data[p] = std::sqrt(v);
      }
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse LU with partial pivoting (Gilbert-Peierls, left-looking): P A = L U.
//
// The setup-phase factorization behind splu above the dense ceiling. The
// symbolic step per column is the classic CSparse reach (DFS through the
// pivoted L columns, reverse postorder = topological elimination order), so
// total work is O(flops(L,U)), not O(n * nnz). Natural (no COLAMD) column
// order; fill is whatever the ordering gives — callers with huge fill
// should precondition + iterate instead.
//
// L is unit-lower (diagonal implicit), U upper, both CSC over PIVOT row
// ids; perm[k] = original row chosen as pivot k (PA = LU reads
// (PA)[k, :] = A[perm[k], :]).
// ---------------------------------------------------------------------------

namespace {

struct SpluHandle {
  int64_t n = 0;
  std::vector<int64_t> Lp, Li, Up, Ui;
  std::vector<double> Lx, Ux;
  std::vector<int64_t> perm;
};

}  // namespace

// Shared Gilbert-Peierls core. droptol == 0 && lfil == 0 -> exact LU;
// otherwise ILUT(p, tau): entries with |x| < droptol * ||A(:,j)||_2 are
// dropped (pivot always kept) and at most lfil largest-|value| entries
// are kept per column in EACH of L and U-off-diagonal (lfil == 0 means
// unlimited). Dropping shrinks downstream reach, which is the point.
static SpluHandle* lu_factor_core(int64_t n, const int64_t* Ap,
                                  const int64_t* Ai, const double* Ax,
                                  double droptol, int64_t lfil,
                                  int64_t* info) {
  auto* h = new SpluHandle();
  h->n = n;
  h->Lp.assign(1, 0);
  h->Up.assign(1, 0);
  h->perm.assign(n, -1);
  std::vector<int64_t> pinv(n, -1);   // original row -> pivot position
  std::vector<double> x(n, 0.0);
  std::vector<unsigned char> mark(n, 0);
  std::vector<int64_t> topo, stack, pstack;
  std::vector<std::pair<int64_t, double>> ucol, lcol;
  topo.reserve(64);
  *info = 0;

  for (int64_t j = 0; j < n; ++j) {
    // symbolic: reach of pattern(A(:, j)) through the pivoted L columns
    topo.clear();
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int64_t root = Ai[p];
      if (mark[root]) continue;
      mark[root] = 1;
      stack.assign(1, root);
      pstack.assign(1, pinv[root] >= 0 ? h->Lp[pinv[root]] : -1);
      while (!stack.empty()) {
        int64_t node = stack.back();
        int64_t k = pinv[node];
        bool descended = false;
        if (k >= 0) {
          int64_t end = h->Lp[k + 1];
          int64_t& pp = pstack.back();
          if (pp < 0) pp = h->Lp[k];
          while (pp < end) {
            int64_t child = h->Li[pp++];
            if (!mark[child]) {
              mark[child] = 1;
              stack.push_back(child);
              pstack.push_back(pinv[child] >= 0 ? h->Lp[pinv[child]] : -1);
              descended = true;
              break;
            }
          }
        }
        if (!descended) {  // postorder emit; reverse gives topo order
          topo.push_back(node);
          stack.pop_back();
          pstack.pop_back();
        }
      }
    }
    // numeric: scatter A(:, j), eliminate in reverse postorder
    double cn2 = 0.0;
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      x[Ai[p]] = Ax[p];
      cn2 += Ax[p] * Ax[p];
    }
    const double tau = droptol > 0.0 ? droptol * std::sqrt(cn2) : 0.0;
    for (int64_t t = (int64_t)topo.size() - 1; t >= 0; --t) {
      int64_t i = topo[t];
      int64_t k = pinv[i];
      if (k < 0) continue;
      double xi = x[i];
      if (xi == 0.0) continue;
      for (int64_t p = h->Lp[k]; p < h->Lp[k + 1]; ++p)
        x[h->Li[p]] -= h->Lx[p] * xi;
    }
    // partial pivot: largest |x| among unpivoted reached rows
    int64_t piv = -1;
    double pmax = 0.0;
    for (int64_t i : topo) {
      if (pinv[i] < 0) {
        double a = std::fabs(x[i]);
        if (a > pmax) {
          pmax = a;
          piv = i;
        }
      }
    }
    if (piv < 0 || pmax == 0.0) {
      *info = -(j + 1);
      delete h;
      return nullptr;
    }
    double d = x[piv];
    pinv[piv] = j;
    h->perm[j] = piv;
    // emit: pivoted rows -> U(:, j) (incl. the new diagonal), unpivoted
    // rows -> L(:, j) scaled by the pivot; then keep the lfil largest per
    // half; clear the workspace. ILUT drop rules (SuperLU/Saad): U drops on the raw value |x| < tau = droptol * ||A(:,j)||2,
    // L drops on the SCALED multiplier |x/d| < droptol — the pivot is
    // picked first, so a large pivot no longer keeps entries that are
    // tiny as L multipliers (nor a tiny pivot drop large ones). The
    // U diagonal is never dropped.
    ucol.clear();
    lcol.clear();
    for (int64_t i : topo) {
      if (pinv[i] >= 0) {
        if (pinv[i] == j || std::fabs(x[i]) >= tau)
          ucol.emplace_back(pinv[i], x[i]);
      } else if (x[i] != 0.0 &&
                 (droptol <= 0.0 || std::fabs(x[i] / d) >= droptol)) {
        lcol.emplace_back(i, x[i] / d);  // ORIGINAL row id; remapped later
      }
      x[i] = 0.0;
      mark[i] = 0;
    }
    if (lfil > 0) {
      auto by_mag = [](const std::pair<int64_t, double>& a,
                       const std::pair<int64_t, double>& b) {
        return std::fabs(a.second) > std::fabs(b.second);
      };
      if ((int64_t)lcol.size() > lfil) {
        std::nth_element(lcol.begin(), lcol.begin() + lfil, lcol.end(),
                         by_mag);
        lcol.resize(lfil);
      }
      // U keeps its diagonal unconditionally + the lfil largest others
      if ((int64_t)ucol.size() > lfil + 1) {
        auto diag_it = std::find_if(
            ucol.begin(), ucol.end(),
            [j](const std::pair<int64_t, double>& e) { return e.first == j; });
        std::swap(*diag_it, ucol.back());
        auto dent = ucol.back();
        ucol.pop_back();
        std::nth_element(ucol.begin(), ucol.begin() + lfil, ucol.end(),
                         by_mag);
        ucol.resize(lfil);
        ucol.push_back(dent);
      }
    }
    std::sort(ucol.begin(), ucol.end());
    for (auto& e : ucol) {
      h->Ui.push_back(e.first);
      h->Ux.push_back(e.second);
    }
    for (auto& e : lcol) {
      h->Li.push_back(e.first);
      h->Lx.push_back(e.second);
    }
    h->Lp.push_back((int64_t)h->Li.size());
    h->Up.push_back((int64_t)h->Ui.size());
  }
  // L row ids -> pivot space (every row is pivoted by now)
  for (auto& i : h->Li) i = pinv[i];
  return h;
}

extern "C" {

// Exact factorization of the n x n CSC matrix (Ap, Ai, Ax). Returns an
// opaque handle (or nullptr on failure) and sets *info to 0, or -(j+1)
// when column j has no usable pivot.
void* splu_factor(int64_t n, const int64_t* Ap, const int64_t* Ai,
                  const double* Ax, int64_t* info) {
  return lu_factor_core(n, Ap, Ai, Ax, 0.0, 0, info);
}

// ---------------------------------------------------------------------------
// Independent-set BFS expansion (quantum.py's level-by-level enumeration)
// ---------------------------------------------------------------------------

// Total number of size-(k+1) sets generated from this level:
// sum of popcounts of the extension queues.
int64_t ind_sets_count(const uint64_t* queues, int64_t S, int64_t W) {
  int64_t total = 0;
  for (int64_t i = 0; i < S * W; i++) {
    total += __builtin_popcountll(queues[i]);
  }
  return total;
}

// Expand one BFS level. new_sets/new_queues must hold ind_sets_count rows.
// Parent-major, then extension node ascending: the numpy expansion's order.
void ind_sets_expand(const uint64_t* sets, const uint64_t* queues,
                     const uint64_t* comp_gt,  // [n, W] candidate masks
                     int64_t S, int64_t W, int64_t n, uint64_t* new_sets,
                     uint64_t* new_queues) {
  int64_t out = 0;
  for (int64_t i = 0; i < S; i++) {
    const uint64_t* q = queues + i * W;
    const uint64_t* s = sets + i * W;
    for (int64_t w = 0; w < W; w++) {
      uint64_t bits = q[w];
      while (bits) {
        int b = __builtin_ctzll(bits);
        bits &= bits - 1;
        int64_t u = w * 64 + b;
        uint64_t* ns = new_sets + out * W;
        uint64_t* nq = new_queues + out * W;
        const uint64_t* cg = comp_gt + u * W;
        for (int64_t ww = 0; ww < W; ww++) {
          ns[ww] = s[ww];
          nq[ww] = q[ww] & cg[ww];
        }
        ns[w] |= (uint64_t(1) << b);
        out++;
      }
    }
  }
}

// ILUT(p, tau) incomplete factorization — same handle/getter protocol.
void* ilut_factor(int64_t n, const int64_t* Ap, const int64_t* Ai,
                  const double* Ax, double droptol, int64_t lfil,
                  int64_t* info) {
  return lu_factor_core(n, Ap, Ai, Ax, droptol, lfil, info);
}

int64_t splu_lnnz(void* vh) { return (int64_t)((SpluHandle*)vh)->Li.size(); }
int64_t splu_unnz(void* vh) { return (int64_t)((SpluHandle*)vh)->Ui.size(); }

void splu_get(void* vh, int64_t* Lp, int64_t* Li, double* Lx, int64_t* Up,
              int64_t* Ui, double* Ux, int64_t* perm) {
  auto* h = (SpluHandle*)vh;
  // empty-vector data() may be null (diagonal matrices have empty L);
  // memcpy from null is UB even at size 0
  auto cp = [](void* dst, const void* src, size_t bytes) {
    if (bytes) std::memcpy(dst, src, bytes);
  };
  cp(Lp, h->Lp.data(), h->Lp.size() * sizeof(int64_t));
  cp(Li, h->Li.data(), h->Li.size() * sizeof(int64_t));
  cp(Lx, h->Lx.data(), h->Lx.size() * sizeof(double));
  cp(Up, h->Up.data(), h->Up.size() * sizeof(int64_t));
  cp(Ui, h->Ui.data(), h->Ui.size() * sizeof(int64_t));
  cp(Ux, h->Ux.data(), h->Ux.size() * sizeof(double));
  cp(perm, h->perm.data(), h->perm.size() * sizeof(int64_t));
}

void splu_free(void* vh) { delete (SpluHandle*)vh; }

}  // extern "C"
