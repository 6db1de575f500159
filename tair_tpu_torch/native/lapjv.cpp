// Batched rectangular linear-assignment solver (Hungarian algorithm with
// potentials, O(n^2 m) successive shortest augmenting paths).
//
// The port's copy of native/lapjv.cpp, built by tair_tpu_torch/native_ext.py:
// the native counterpart of the reference's scipy.optimize.linear_sum_assignment
// hop inside the TESTR matchers (TESTR's adet/modeling/testr/matcher.py:74-76),
// behind the "hungarian_host" matcher. Exposed via a C ABI for ctypes; no
// Python/pybind dependency. The solver assigns every one of the n valid columns,
// so it needs n <= Q: the wrapper solves a batch element with more valid targets
// than queries transposed.
//
// cost layout: [B, Q, M] row-major (Q queries/rows, M target slots/columns).
// For batch b only the first n_valid[b] columns are real; out[b*M + j] gets
// the assigned query index for target j, or -1 for padding columns.

#include <cfloat>
#include <cstring>
#include <vector>

namespace {

// Assign each of n columns (targets) to one of m rows (queries), n <= m,
// minimizing total cost. cost(i, j) = costQ[j * ldm + i]: column i, row j.
// Returns row index per column in col_to_row.
void hungarian(const float* cost, int q, int m_cols, int ld,
               std::vector<int>& col_to_row) {
  const int n = m_cols;   // columns to assign
  const int m = q;        // rows available
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int> p(m + 1, 0), way(m + 1, 0);

  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(m + 1, DBL_MAX);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      const int i0 = p[j0];
      int j1 = 0;
      double delta = DBL_MAX;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        // a[i0][j] = cost of (column i0-1, row j-1)
        const double cur =
            static_cast<double>(cost[(j - 1) * ld + (i0 - 1)]) - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= m; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      const int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }

  col_to_row.assign(n, -1);
  for (int j = 1; j <= m; ++j) {
    if (p[j] > 0) col_to_row[p[j] - 1] = j - 1;
  }
}

}  // namespace

extern "C" {

// cost: [B, Q, M] float32, n_valid: [B] int32, out: [B, M] int32 (query per
// target, -1 for padding).
void lapjv_batch(const float* cost, int b, int q, int m, const int* n_valid,
                 int* out) {
  std::vector<float> sub;
  std::vector<int> col_to_row;
  for (int bi = 0; bi < b; ++bi) {
    const float* c = cost + static_cast<long>(bi) * q * m;
    int* o = out + static_cast<long>(bi) * m;
    for (int j = 0; j < m; ++j) o[j] = -1;
    const int n = n_valid[bi] < m ? n_valid[bi] : m;
    if (n <= 0) continue;
    // pack the valid columns contiguously: sub[j * n + i] = c[j * m + i]
    sub.resize(static_cast<size_t>(q) * n);
    for (int j = 0; j < q; ++j) {
      std::memcpy(&sub[static_cast<size_t>(j) * n], c + static_cast<long>(j) * m,
                  sizeof(float) * n);
    }
    hungarian(sub.data(), q, n, n, col_to_row);
    for (int i = 0; i < n; ++i) o[i] = col_to_row[i];
  }
}

}  // extern "C"
