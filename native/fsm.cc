// Classical serial fast-sweeping eikonal solver (FSM), C++.
//
// This is the native-equivalent of the reference's Fortran sweep driver
// (SURVEY.md §2.2 N1-N3): Godunov upwind local solver + 2^D corner-to-corner
// Gauss-Seidel sweep orderings iterated to convergence. In this framework it
// serves as (a) the golden oracle that the parallel JAX solvers are
// cross-checked against in tests (same discrete fixed point, independently
// implemented), and (b) a fast host-side traveltime-table builder for
// locate-only workflows on machines without accelerators.
//
// Discretization matches mceik_tpu/eikonal/godunov.py exactly: solve
//   sum_d w_d * max(t - a_d, 0)^2 = s^2,   w_d = 1/h_d^2
// by the sorted-subset rule with the numerically stable discriminant
//   disc_n = (sum w) s^2 - sum_{i<j} w_i w_j (a_i - a_j)^2.
// Source seeding: T = s(src) * |x - x_src| inside a ball of
// seed_radius * max(h), frozen during sweeps (multilinear-interpolated
// s(src), same as solve.seed_source).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kBig = 1e10;

struct Pair {
  double a;
  double w;
};

inline double local_solve(Pair* p, int d, double s) {
  std::sort(p, p + d, [](const Pair& x, const Pair& y) { return x.a < y.a; });
  double t = p[0].a + s / std::sqrt(p[0].w);
  if (d == 1 || t <= p[1].a) return t;
  double A = p[0].w + p[1].w;
  double B = p[0].w * p[0].a + p[1].w * p[1].a;
  double diff01 = p[0].a - p[1].a;
  double disc = A * s * s - p[0].w * p[1].w * diff01 * diff01;
  t = (B + std::sqrt(std::max(disc, 0.0))) / A;
  if (d == 2 || t <= p[2].a) return t;
  double A3 = A + p[2].w;
  double B3 = B + p[2].w * p[2].a;
  double d02 = p[0].a - p[2].a, d12 = p[1].a - p[2].a;
  double disc3 = A3 * s * s -
                 (p[0].w * p[1].w * diff01 * diff01 +
                  p[0].w * p[2].w * d02 * d02 + p[1].w * p[2].w * d12 * d12);
  return (B3 + std::sqrt(std::max(disc3, 0.0))) / A3;
}

}  // namespace

extern "C" {

// Returns number of full sweep passes executed; T_out must hold the field.
// shape/spacing length = ndim (2 or 3); src in physical coordinates
// relative to origin 0 (caller pre-subtracts the grid origin).
int fsm_solve(int ndim, const int64_t* shape, const double* spacing,
              const float* slowness, const double* src, double seed_radius,
              double tol, int max_passes, float* T_out) {
  if (ndim != 2 && ndim != 3) return -1;
  int64_t nx = shape[0], ny = shape[1], nz = (ndim == 3) ? shape[2] : 1;
  double hx = spacing[0], hy = spacing[1], hz = (ndim == 3) ? spacing[2] : 1.0;
  int64_t n = nx * ny * nz;
  std::vector<double> T(n, kBig);
  std::vector<uint8_t> frozen(n, 0);

  auto idx = [&](int64_t i, int64_t j, int64_t k) {
    return (i * ny + j) * nz + k;
  };

  // s at the source by multilinear interpolation (clamped), matching
  // jax.scipy.ndimage.map_coordinates(order=1, mode="nearest").
  double fi = src[0] / hx, fj = src[1] / hy,
         fk = (ndim == 3) ? src[2] / hz : 0.0;
  auto clampd = [](double v, double lo, double hi) {
    return std::min(std::max(v, lo), hi);
  };
  fi = clampd(fi, 0.0, double(nx - 1));
  fj = clampd(fj, 0.0, double(ny - 1));
  fk = clampd(fk, 0.0, double(nz - 1));
  int64_t i0 = int64_t(fi), j0 = int64_t(fj), k0 = int64_t(fk);
  int64_t i1 = std::min(i0 + 1, nx - 1), j1 = std::min(j0 + 1, ny - 1),
          k1 = std::min(k0 + 1, nz - 1);
  double di = fi - i0, dj = fj - j0, dk = fk - k0;
  double s_src = 0.0;
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b)
      for (int c = 0; c < (ndim == 3 ? 2 : 1); ++c) {
        double w = (a ? di : 1 - di) * (b ? dj : 1 - dj) *
                   (ndim == 3 ? (c ? dk : 1 - dk) : 1.0);
        s_src += w * double(slowness[idx(a ? i1 : i0, b ? j1 : j0,
                                         c ? k1 : k0)]);
      }

  // Seed-ball membership and values are computed in FLOAT32, matching the
  // JAX solver bit-for-bit: the frozen set is decided by an fp32
  // comparison there, and a borderline node frozen on one side but solved
  // on the other shifts the downstream fixed point by O(0.1).
  double hmax = std::max(hx, std::max(hy, (ndim == 3) ? hz : 0.0));
  float radius = float(seed_radius) * float(hmax);
  float s_src_f = float(s_src);
  for (int64_t i = 0; i < nx; ++i)
    for (int64_t j = 0; j < ny; ++j)
      for (int64_t k = 0; k < nz; ++k) {
        float dx = float(i) * float(hx) - float(src[0]);
        float dy = float(j) * float(hy) - float(src[1]);
        float dz = (ndim == 3) ? float(k) * float(hz) - float(src[2]) : 0.0f;
        float dist = std::sqrt(dx * dx + dy * dy + dz * dz + 1e-12f);
        if (dist <= radius) {
          T[idx(i, j, k)] = double(s_src_f * dist);
          frozen[idx(i, j, k)] = 1;
        }
      }

  const double wx = 1.0 / (hx * hx), wy = 1.0 / (hy * hy),
               wz = 1.0 / (hz * hz);
  int pass = 0;
  double delta = kBig;
  const int n_orderings = (ndim == 3) ? 8 : 4;
  while (delta > tol && pass < max_passes) {
    delta = 0.0;
    for (int ord = 0; ord < n_orderings; ++ord) {
      bool ri = ord & 1, rj = ord & 2, rk = ord & 4;
      for (int64_t ii = 0; ii < nx; ++ii) {
        int64_t i = ri ? nx - 1 - ii : ii;
        for (int64_t jj = 0; jj < ny; ++jj) {
          int64_t j = rj ? ny - 1 - jj : jj;
          for (int64_t kk = 0; kk < nz; ++kk) {
            int64_t k = rk ? nz - 1 - kk : kk;
            int64_t c = idx(i, j, k);
            if (frozen[c]) continue;
            Pair p[3];
            int d = 0;
            double ax = std::min(i > 0 ? T[idx(i - 1, j, k)] : kBig,
                                 i < nx - 1 ? T[idx(i + 1, j, k)] : kBig);
            p[d++] = {ax, wx};
            double ay = std::min(j > 0 ? T[idx(i, j - 1, k)] : kBig,
                                 j < ny - 1 ? T[idx(i, j + 1, k)] : kBig);
            p[d++] = {ay, wy};
            if (ndim == 3) {
              double az = std::min(k > 0 ? T[idx(i, j, k - 1)] : kBig,
                                   k < nz - 1 ? T[idx(i, j, k + 1)] : kBig);
              p[d++] = {az, wz};
            }
            double t = local_solve(p, d, double(slowness[c]));
            if (t < T[c]) {
              delta = std::max(delta, T[c] - t);
              T[c] = t;
            }
          }
        }
      }
    }
    ++pass;
  }

  for (int64_t q = 0; q < n; ++q) T_out[q] = float(T[q]);
  return pass;
}

}  // extern "C"
