// native.cpp — the host-side native runtime of petlion_tpu_torch.
//
// Plain C ABI, bound with ctypes by runtime/native.py, which builds it with
// g++ at first use; no external dependencies. It provides:
//
//   * natural cubic splines, batched over columns (Solution.__call__
//     re-interpolation, utils/interp.py:spline_interp)
//   * a banded+arrowhead LU tailored to the P2D Newton matrix (host solves
//     of one cell's 301x301 system)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Natural cubic spline, batched over columns.
// t: (n) strictly increasing; y: (n, m) row-major; tq: (nq); out: (nq, m).
// ---------------------------------------------------------------------------
int cubic_spline_interp(int64_t n, const double* t, int64_t m,
                        const double* y, int64_t nq, const double* tq,
                        double* out, int extrapolate) {
  if (n < 2 || m < 1) return 1;
  if (n < 4) {
    // linear fallback, matching the Python path for short segments
    for (int64_t q = 0; q < nq; ++q) {
      double x = tq[q];
      if (!extrapolate) x = x < t[0] ? t[0] : (x > t[n - 1] ? t[n - 1] : x);
      int64_t i = 0;
      while (i < n - 2 && t[i + 1] < x) ++i;
      const double w = (x - t[i]) / (t[i + 1] - t[i]);
      for (int64_t j = 0; j < m; ++j)
        out[q * m + j] = (1 - w) * y[i * m + j] + w * y[(i + 1) * m + j];
    }
    return 0;
  }

  // second-derivative coefficients M (n, m) via the Thomas algorithm
  std::vector<double> h(n - 1), cp(n), M(n * m, 0.0), dp(n * m, 0.0);
  for (int64_t i = 0; i < n - 1; ++i) {
    h[i] = t[i + 1] - t[i];
    if (h[i] <= 0) h[i] = 1e-300;
  }
  // rows 1..n-2: a=h[i-1], b=2(h[i-1]+h[i]), c=h[i]; natural BCs b=1 at ends
  cp[0] = 0.0;
  for (int64_t j = 0; j < m; ++j) dp[j] = 0.0;
  for (int64_t i = 1; i < n; ++i) {
    double a, b, c;
    if (i < n - 1) {
      a = h[i - 1];
      b = 2.0 * (h[i - 1] + h[i]);
      c = h[i];
    } else {
      a = 0.0;
      b = 1.0;
      c = 0.0;
    }
    const double mlt = b - a * cp[i - 1];
    cp[i] = c / mlt;
    for (int64_t j = 0; j < m; ++j) {
      double d = 0.0;
      if (i < n - 1) {
        d = 6.0 * ((y[(i + 1) * m + j] - y[i * m + j]) / h[i] -
                   (y[i * m + j] - y[(i - 1) * m + j]) / h[i - 1]);
      }
      dp[i * m + j] = (d - a * dp[(i - 1) * m + j]) / mlt;
    }
  }
  for (int64_t j = 0; j < m; ++j) M[(n - 1) * m + j] = dp[(n - 1) * m + j];
  for (int64_t i = n - 2; i >= 0; --i)
    for (int64_t j = 0; j < m; ++j)
      M[i * m + j] = dp[i * m + j] - cp[i] * M[(i + 1) * m + j];

  for (int64_t q = 0; q < nq; ++q) {
    double x = tq[q];
    if (!extrapolate) x = x < t[0] ? t[0] : (x > t[n - 1] ? t[n - 1] : x);
    // binary search for the interval
    int64_t lo = 0, hi = n - 1;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) / 2;
      if (t[mid] <= x) lo = mid; else hi = mid;
    }
    if (lo > n - 2) lo = n - 2;
    const double hh = t[lo + 1] - t[lo];
    const double A = (t[lo + 1] - x) / hh;
    const double B = (x - t[lo]) / hh;
    const double C = (A * A * A - A) * hh * hh / 6.0;
    const double D = (B * B * B - B) * hh * hh / 6.0;
    for (int64_t j = 0; j < m; ++j)
      out[q * m + j] = A * y[lo * m + j] + B * y[(lo + 1) * m + j] +
                       C * M[lo * m + j] + D * M[(lo + 1) * m + j];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Banded + arrowhead LU for the P2D Newton matrix.
//
// Solves (A + arrow) x = b where A is a banded matrix with lower/upper
// bandwidth kl/ku (stored dense row-major n×n for simplicity at n≈301) and
// the "arrow" is the last row and last column being dense (the scalar
// current state couples globally; scalar_residual.jl:204-229). Factorization
// is pivot-free within the band (the P2D matrix is strongly diagonally
// dominant after row/col equilibration) with the border handled by a
// bordered-Schur update: O(n·(kl+ku)²) instead of O(n³).
// ---------------------------------------------------------------------------
int banded_arrow_factor(int64_t n, int64_t kl, int64_t ku, double* A /*n*n*/,
                        double* work /*2n+2*/) {
  const int64_t nb = n - 1;  // banded part excludes the border row/col
  // equilibrate: scale rows of the full matrix to unit max-norm
  for (int64_t i = 0; i < n; ++i) {
    double mx = 0.0;
    for (int64_t j = 0; j < n; ++j) mx = std::fmax(mx, std::fabs(A[i * n + j]));
    if (mx == 0.0) return 2;
    work[i] = 1.0 / mx;
    for (int64_t j = 0; j < n; ++j) A[i * n + j] *= work[i];
  }
  // banded LU (Doolittle, no pivoting) on the leading nb×nb block,
  // simultaneously eliminating into the border row/column
  for (int64_t k = 0; k < nb; ++k) {
    const double piv = A[k * n + k];
    if (std::fabs(piv) < 1e-300) return 3;
    const int64_t imax = std::min(nb - 1, k + kl);
    for (int64_t i = k + 1; i <= imax; ++i) {
      const double l = A[i * n + k] / piv;
      A[i * n + k] = l;
      const int64_t jmax = std::min(nb - 1, k + ku);
      for (int64_t j = k + 1; j <= jmax; ++j)
        A[i * n + j] -= l * A[k * n + j];
      A[i * n + nb] -= l * A[k * n + nb];  // border column
    }
    // border row elimination
    const double lr = A[nb * n + k] / piv;
    A[nb * n + k] = lr;
    const int64_t jmax = std::min(nb - 1, k + ku);
    for (int64_t j = k + 1; j <= jmax; ++j)
      A[nb * n + j] -= lr * A[k * n + j];
    A[nb * n + nb] -= lr * A[k * n + nb];
  }
  if (std::fabs(A[nb * n + nb]) < 1e-300) return 3;
  return 0;
}

int banded_arrow_solve(int64_t n, int64_t kl, int64_t ku, const double* A,
                       const double* work, const double* b, double* x) {
  const int64_t nb = n - 1;
  std::vector<double> y(n);
  for (int64_t i = 0; i < n; ++i) y[i] = b[i] * work[i];
  // forward: L y = b (unit diagonal), banded + border row
  for (int64_t k = 0; k < nb; ++k) {
    const int64_t imax = std::min(nb - 1, k + kl);
    for (int64_t i = k + 1; i <= imax; ++i) y[i] -= A[i * n + k] * y[k];
    y[nb] -= A[nb * n + k] * y[k];
  }
  // back substitution: U x = y, border first
  x[nb] = y[nb] / A[nb * n + nb];
  for (int64_t i = nb - 1; i >= 0; --i) {
    double s = y[i] - A[i * n + nb] * x[nb];
    const int64_t jmax = std::min(nb - 1, i + ku);
    for (int64_t j = i + 1; j <= jmax; ++j) s -= A[i * n + j] * x[j];
    x[i] = s / A[i * n + i];
  }
  return 0;
}

int version() { return 1; }

}  // extern "C"
