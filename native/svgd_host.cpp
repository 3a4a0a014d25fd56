// Host-side native helpers for svgdcpp_jax.
//
// The device compute path is JAX/XLA/Pallas; these are the host-runtime pieces
// where native code genuinely wins over Python:
//
//   * selection (k-th element / median with the reference library's
//     even-count averaging semantics, cf. SVGDCpp
//     GaussianRBFKernel::ComputeMedian) over large host buffers — used to
//     cross-verify the on-device selection kernels against an exact host
//     answer at sizes where a NumPy full sort hurts;
//   * the intermediate-matrix debug log writer — formatting millions of
//     doubles through Python string formatting is ~50x slower than
//     std::to_chars.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// k-th smallest (0-indexed) of data[0..n). Operates in place (caller passes
// a scratch copy).
double svgd_kth_element_f64(double* data, int64_t n, int64_t k) {
  if (n <= 0 || k < 0 || k >= n) return 0.0;
  std::nth_element(data, data + k, data + n);
  return data[k];
}

// Median with even-count averaging: for even n, the mean of the two middle
// order statistics; for odd n, the middle one. In place.
double svgd_median_f64(double* data, int64_t n) {
  if (n <= 0) return 0.0;
  if (n % 2 == 0) {
    const int64_t hi_idx = n / 2;
    std::nth_element(data, data + hi_idx, data + n);
    const double hi = data[hi_idx];
    const double lo = *std::max_element(data, data + hi_idx);
    return 0.5 * (lo + hi);
  }
  const int64_t mid = n / 2;
  std::nth_element(data, data + mid, data + n);
  return data[mid];
}

namespace {

// Append a double in %.9g-equivalent form.
void append_double(std::vector<char>& buf, double v) {
  char tmp[64];
  const int len = std::snprintf(tmp, sizeof(tmp), "%.9g", v);
  buf.insert(buf.end(), tmp, tmp + len);
}

// Append a row-major (rows x cols) matrix as space-separated text rows.
void append_matrix(std::vector<char>& buf, const double* data, int64_t rows,
                   int64_t cols) {
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t c = 0; c < cols; ++c) {
      if (c) buf.push_back(' ');
      append_double(buf, data[r * cols + c]);
    }
    buf.push_back('\n');
  }
  if (!buf.empty() && buf.back() == '\n') buf.pop_back();
}

void append_str(std::vector<char>& buf, const char* s) {
  buf.insert(buf.end(), s, s + std::strlen(s));
}

}  // namespace

// Write the per-iteration intermediate-matrix log in the SVGDCpp text
// layout (cf. SVGD::Run / WriteIntermediateMatricesToFile). Inputs are
// host row-major f64 stacks, already in the REFERENCE orientation:
//   lmg:    (steps, m, n)        LogModelGrad
//   ker:    (steps, n, n)        Kernel, (j, i) indexing
//   kgrad:  (steps, m*n, n)      stacked KernelGrad blocks
//   coords: (steps, m, n)        CoordMat
// Returns 0 on success, nonzero on I/O failure.
int svgd_write_intermediate_log_v2(const char* path, int64_t steps,
                                   int64_t n, int64_t m, int64_t start_step,
                                   int append, const double* lmg,
                                   const double* ker, const double* kgrad,
                                   const double* coords) {
  // append + start_step let per-step drivers extend an existing dump in
  // O(new steps) instead of rewriting the whole history each call.
  std::FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return 1;
  std::vector<char> buf;
  buf.reserve(static_cast<size_t>(1) << 20);
  char header[128];
  for (int64_t t = 0; t < steps; ++t) {
    buf.clear();
    std::snprintf(header, sizeof(header),
                  "========== Step %lld ==========\nLogModelGrad=\n",
                  static_cast<long long>(start_step + t));
    append_str(buf, header);
    append_matrix(buf, lmg + t * m * n, m, n);
    append_str(buf, "\n\nKernel=\n");
    append_matrix(buf, ker + t * n * n, n, n);
    append_str(buf, "\n\nKernelGrad=\n");
    append_matrix(buf, kgrad + t * m * n * n, m * n, n);
    append_str(buf, "\n\nCoordMat=\n");
    append_matrix(buf, coords + t * m * n, m, n);
    append_str(buf, "\n\n");
    if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
      std::fclose(f);
      return 2;
    }
  }
  return std::fclose(f) == 0 ? 0 : 3;
}

int svgd_write_intermediate_log(const char* path, int64_t steps, int64_t n,
                                int64_t m, const double* lmg,
                                const double* ker, const double* kgrad,
                                const double* coords) {
  // Original whole-file ABI, kept for compatibility.
  return svgd_write_intermediate_log_v2(path, steps, n, m, 1, 0, lmg, ker,
                                        kgrad, coords);
}

// ---------------------------------------------------------------------
// Independent per-pair SVGD oracle (MVN target, isotropic RBF kernel,
// AdaGrad) — a from-scratch C++ implementation of the algorithm in the
// same per-pair style the reference library tests itself with
// (cf. SVGDCpp tests/test_svgd.cpp ManualSVGDStep). Used by the Python
// test suite as a cross-LANGUAGE trajectory check of the JAX engine.
// ---------------------------------------------------------------------

namespace {

// median of pairwise distances including self-zeros, even-count averaging
double pairwise_median(const double* x, int64_t n, int64_t m,
                       std::vector<double>& scratch) {
  scratch.resize(static_cast<size_t>(n) * n);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      double sq = 0.0;
      for (int64_t d = 0; d < m; ++d) {
        const double diff = x[i * m + d] - x[j * m + d];
        sq += diff * diff;
      }
      scratch[i * n + j] = std::sqrt(sq);
    }
  }
  return svgd_median_f64(scratch.data(), n * n);
}

}  // namespace

// Runs `iters` SVGD steps in place on coords (n x m row-major).
// cov_inv: m x m row-major inverse covariance of the MVN target.
// gamma_fixed < 0 => recompute the median-heuristic bandwidth each step.
// AdaGrad with learning rate lr and stabilizer 1e-8.
int svgd_oracle_mvn_rbf_adagrad(double* coords, int64_t n, int64_t m,
                                const double* mean, const double* cov_inv,
                                double gamma_fixed, double lr, int64_t iters) {
  if (n <= 0 || m <= 0) return 1;
  std::vector<double> phi(static_cast<size_t>(n) * m);
  std::vector<double> score(static_cast<size_t>(n) * m);
  std::vector<double> accum(static_cast<size_t>(n) * m, 0.0);
  std::vector<double> med_scratch;

  for (int64_t it = 0; it < iters; ++it) {
    double gamma = gamma_fixed;
    if (gamma_fixed < 0.0) {
      const double med = pairwise_median(coords, n, m, med_scratch);
      gamma = std::log(static_cast<double>(n)) / (med * med);
    }
    // scores: -cov_inv (x - mean)
    for (int64_t j = 0; j < n; ++j) {
      for (int64_t a = 0; a < m; ++a) {
        double s = 0.0;
        for (int64_t b = 0; b < m; ++b) {
          s -= cov_inv[a * m + b] * (coords[j * m + b] - mean[b]);
        }
        score[j * m + a] = s;
      }
    }
    // phi per pair
    std::fill(phi.begin(), phi.end(), 0.0);
    for (int64_t i = 0; i < n; ++i) {
      for (int64_t j = 0; j < n; ++j) {
        double sq = 0.0;
        for (int64_t d = 0; d < m; ++d) {
          const double diff = coords[j * m + d] - coords[i * m + d];
          sq += diff * diff;
        }
        const double k = std::exp(-gamma * sq);
        for (int64_t d = 0; d < m; ++d) {
          const double diff = coords[j * m + d] - coords[i * m + d];
          phi[i * m + d] += k * score[j * m + d] - 2.0 * gamma * diff * k;
        }
      }
    }
    // AdaGrad update
    for (int64_t i = 0; i < n * m; ++i) {
      const double g = phi[i] / static_cast<double>(n);
      accum[i] += g * g;
      coords[i] += lr * g / (1.0e-8 + std::sqrt(accum[i]));
    }
  }
  return 0;
}

}  // extern "C"
