// Golden-model C++ implementation of the analytical coalescence step.
//
// Independent of JAX/XLA: closure inversion, diagnostic moments, the
// log-grid Simpson / incomplete-gamma autoconversion integrals and the
// Q/R/S assembly, for spectra of gamma/exponential modes with fixed
// thresholds (the flagship configuration). Used
//   (a) as an independent cross-validation oracle in tests, and
//   (b) as the single-CPU-core baseline bench.py compares the GPU against
//       (the reference publishes no throughput numbers — BASELINE.md).
//
// Mirrors reference semantics: closure inversion
// (src/ParticleDistributions/ParticleDistributions.jl:456-541),
// moment_source_helper log grid (:567-612), SimpsonEvenFast weights
// (:698-710), Q/R/S sums (src/Sources/Coalescence.jl:260-455).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libcloudy_golden.so cloudy_golden.cc

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kEps = std::numeric_limits<double>::epsilon();

// ---------------------------------------------------------------------------
// special functions (Lanczos lgamma + fixed-iteration regularized P(a,x))
// ---------------------------------------------------------------------------

double lgamma_(double x) { return std::lgamma(x); }

double gammainc_p(double a, double x) {
  if (x <= 0.0) return 0.0;
  if (x > 1e6) return 1.0;
  if (x < a + 1.0) {  // series
    double ap = a, term = 1.0 / a, total = term;
    for (int i = 0; i < 256; ++i) {
      ap += 1.0;
      term *= x / ap;
      total += term;
      if (std::fabs(term) < std::fabs(total) * 1e-16) break;
    }
    return total * std::exp(a * std::log(x) - x - lgamma_(a));
  }
  // continued fraction (modified Lentz) for Q
  const double tiny = 1e-290;
  double b = x + 1.0 - a, c = 1.0 / tiny, d = 1.0 / b, h = d;
  for (int i = 1; i <= 256; ++i) {
    double an = -1.0 * i * (i - a);
    b += 2.0;
    d = an * d + b;
    if (std::fabs(d) < tiny) d = tiny;
    c = b + an / c;
    if (std::fabs(c) < tiny) c = tiny;
    d = 1.0 / d;
    double del = d * c;
    h *= del;
    if (std::fabs(del - 1.0) < 1e-16) break;
  }
  double q = std::exp(a * std::log(x) - x - lgamma_(a)) * h;
  double p = 1.0 - q;
  return p < 0.0 ? 0.0 : (p > 1.0 ? 1.0 : p);
}

// ---------------------------------------------------------------------------
// Simpson-EvenFast weights (reference semantics, additive accumulation)
// ---------------------------------------------------------------------------

void simpson_weights(int n_bins, std::vector<double>* w) {
  w->assign(n_bins + 1, 0.0);
  for (int j = 5; j <= n_bins - 3; ++j) (*w)[j - 1] += 1.0;
  const int e = n_bins + 1;
  const double c[4] = {17.0, 59.0, 43.0, 49.0};
  for (int t = 0; t < 4; ++t) {
    (*w)[t] += c[t] / 48.0;
    (*w)[e - 1 - t] += c[t] / 48.0;
  }
}

// moment_source_helper for a gamma(n, theta, k) mode (exp == k = 1):
// returns the full MxM matrix of  ∫∫_{x+x'<T} x^p x'^q f f'.
void msh_matrix_gamma(double n, double theta, double k, double T, int M,
                      double* out /*M*M*/) {
  const double x_lo = std::min(1e-5, 1e-5 * T);
  const int n_bins = static_cast<int>(std::floor(15.0 * std::log10(T / x_lo)));
  const double x_min = std::log(x_lo);
  const double dx = (std::log(T) - x_min) / n_bins;
  std::vector<double> w;
  simpson_weights(n_bins, &w);

  const int G = n_bins + 1;
  std::vector<double> x(G), expterm(G);
  std::vector<double> gi(G * M);
  for (int g = 0; g < G; ++g) {
    x[g] = std::exp(x_min + g * dx);
    const double rem = std::max(T - x[g], 0.0) / theta;
    double p0 = gammainc_p(k, rem);
    gi[g * M] = p0;
    const double logrem = rem > 0 ? std::log(rem) : -745.0;
    for (int q = 1; q < M; ++q) {
      const double a = k + (q - 1);
      double delta = rem > 0 ? std::exp(a * logrem - rem - lgamma_(a + 1.0)) : 0.0;
      p0 -= delta;
      if (p0 < 0) p0 = 0;
      gi[g * M + q] = p0;
    }
    // mask: reference y_func is zero for j > n_bins (the final grid point)
    const double mask = (g < n_bins) ? 1.0 : 0.0;
    expterm[g] = std::exp(k * std::log(x[g]) - x[g] / theta) * w[g] * mask;
  }

  const double lgk = lgamma_(k);
  for (int p = 0; p < M; ++p) {
    for (int q = 0; q < M; ++q) {
      double acc = 0.0;
      for (int g = 0; g < G; ++g) {
        acc += std::pow(x[g], p) * expterm[g] * gi[g * M + q];
      }
      const double pref =
          n * n * std::exp((q - k) * std::log(theta) + lgamma_(q + k) - 2.0 * lgk);
      out[p * M + q] = acc * dx * pref;
    }
  }
}

}  // namespace

extern "C" {

// Analytical coalescence tendencies for a batch of columns.
//   mom:        [n_cols, n_tot] normalized prognostic moments
//   families:   [n_modes] 0 = exponential, 1 = gamma
//   nprog:      [n_modes]
//   kernels:    [n_modes, n_modes, P, P] normalized kernel tensors
//   thresholds: [n_modes] normalized mass thresholds (inf for none)
//   out:        [n_cols, n_tot]
// Returns 0 on success.
int coal_ints_golden(const double* mom, int64_t n_cols, int n_modes,
                     const int* families, const int* nprog,
                     const double* kernels, int P, const double* thresholds,
                     double* out) {
  const int M = P + 2;
  int n_tot = 0;
  std::vector<int> offs(n_modes);
  for (int i = 0; i < n_modes; ++i) {
    offs[i] = n_tot;
    n_tot += nprog[i];
  }
  std::vector<int> n2d(n_modes);
  for (int i = 0; i < n_modes; ++i) {
    const int nxt = (i < n_modes - 1) ? std::max(nprog[i], nprog[i + 1]) : nprog[i];
    n2d[i] = (P - 1) + nxt;
  }
  auto kc = [&](int j, int k, int a, int b) {
    return kernels[((j * n_modes + k) * P + a) * P + b];
  };
  auto binom = [](int m, int c) {
    double r = 1.0;
    for (int i = 0; i < c; ++i) r = r * (m - i) / (i + 1);
    return r;
  };

  std::vector<double> mf(n_modes * M), f2(n_modes * M * M);
  std::vector<double> msh(M * M);
  for (int64_t col = 0; col < n_cols; ++col) {
    const double* m = mom + col * n_tot;
    // --- closure inversion + diagnostic moments ---
    for (int i = 0; i < n_modes; ++i) {
      const double m0 = m[offs[i]], m1 = m[offs[i] + 1];
      double n = 0.0, theta = 1.0, k = 1.0;
      if (m0 > kEps && m1 > kEps) {
        n = m0;
        if (families[i] == 1) {  // gamma
          const double m2 = m[offs[i] + 2];
          const double mean = m1 / m0;
          double denom = m2 / m1 - mean;
          if (std::fabs(denom) <= 0) denom = kEps;
          k = mean / denom;
          if (k < kEps) k = kEps;
          if (k > 10.0) k = 10.0;
          theta = mean / k;
        } else {  // exponential
          theta = m1 / m0;
          k = 1.0;
        }
      }
      double mo = n;
      mf[i * M] = mo;
      for (int p = 0; p < M - 1; ++p) {
        mo = mo * theta * (k + p);
        mf[i * M + p + 1] = mo;
      }
      // --- F2 ---
      const bool thresholded =
          (i < n_modes - 1) && std::isfinite(thresholds[i]);
      if (thresholded) {
        const double kk = families[i] == 1 ? k : 1.0;
        msh_matrix_gamma(n, theta, kk, thresholds[i], M, msh.data());
      }
      for (int p = 0; p < M; ++p) {
        for (int q = 0; q < M; ++q) {
          const double mm = mf[i * M + p] * mf[i * M + q];
          double v;
          if (mm < kEps || p >= n2d[i] || q >= n2d[i]) {
            v = 0.0;
          } else if (!thresholded) {
            v = mm;
          } else {
            const int pp = std::min(p, q), qq = std::max(p, q);
            v = std::min(mm, msh[pp * M + qq]);
          }
          f2[(i * M + p) * M + q] = v;
        }
      }
    }

    // --- Q/R/S assembly (reference Coalescence.jl:140-149, 260-455) ---
    double* o = out + col * n_tot;
    for (int k_ = 0; k_ < n_modes; ++k_) {
      for (int mo = 0; mo < nprog[k_]; ++mo) {
        double acc = 0.0;
        // Q: gain into k_ from j < k_
        for (int j = 0; j < k_; ++j)
          for (int a = 0; a < P; ++a)
            for (int b = 0; b < P; ++b)
              for (int c = 0; c <= mo; ++c)
                acc += kc(j, k_, a, b) * binom(mo, c) * mf[j * M + a + c] *
                       mf[k_ * M + b + mo - c];
        // R: loss of k_ with every mode
        for (int j = 0; j < n_modes; ++j)
          for (int a = 0; a < P; ++a)
            for (int b = 0; b < P; ++b)
              acc -= kc(j, k_, a, b) * mf[j * M + a] * mf[k_ * M + b + mo];
        // S1 of k_
        for (int a = 0; a < P; ++a)
          for (int b = 0; b < P; ++b)
            for (int c = 0; c <= mo; ++c)
              acc += 0.5 * kc(k_, k_, a, b) * binom(mo, c) *
                     f2[(k_ * M + a + c) * M + b + mo - c];
        // S2 of k_-1
        if (k_ >= 1) {
          const int i = k_ - 1;
          for (int a = 0; a < P; ++a)
            for (int b = 0; b < P; ++b)
              for (int c = 0; c <= mo; ++c)
                acc += 0.5 * kc(i, i, a, b) * binom(mo, c) *
                       (mf[i * M + a + c] * mf[i * M + b + mo - c] -
                        f2[(i * M + a + c) * M + b + mo - c]);
        }
        o[offs[k_] + mo] = acc;
      }
    }
  }
  return 0;
}
}
