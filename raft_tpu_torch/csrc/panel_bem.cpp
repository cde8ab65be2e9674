// Panel-method potential-flow solver of raft_tpu_torch (host C++).
//
// First-order potential-flow boundary-element solver core: constant-
// strength source panels (Hess & Smith) with a flat free surface
// handled by the method of images.  This is the native-code foundation
// of the HAMS-equivalent solver the reference delegates to an external
// Fortran package (pyHAMS; RAFT raft_fowt.py:1288-1442)
// — here the influence-matrix assembly and dense solve live in C++
// behind a C ABI consumed through ctypes.
//
// Scope:
//   * frequency-limit radiation problems:
//       mirror = -1 : high-frequency free-surface condition (phi = 0
//                     on z = 0, negative image)  -> A(w -> inf)
//       mirror = +1 : rigid-lid condition (dphi/dz = 0, positive
//                     image) -> A(w -> 0)
//   * finite-frequency radiation/diffraction with the wave Green
//     function: infinite depth via the tabulated Telste-Noblesse-style
//     kernel (wave_term() below), finite depth via John's
//     eigenfunction series with adaptive evanescent cutoff
//     (fd_wave_term(), dispatched for Kh <= 6).
//
// Numerics: panel integrals by centroid collocation with 2x2 Gauss
// refinement for near-field pairs and an analytic equivalent-disk self
// term; dense partial-pivot LU for the source strengths.

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline double norm(const V3& a) { return std::sqrt(dot(a, a)); }

// potential at p of a unit-strength source distribution (1/(4 pi r)
// kernel) over a quad panel given by 4 vertices, by Gauss quadrature
double quad_potential(const V3* verts, double area, const V3& p) {
  // bilinear map with 2x2 Gauss points
  static const double gp[2] = {-0.5773502691896257, 0.5773502691896257};
  double phi = 0.0;
  for (int iu = 0; iu < 2; ++iu) {
    for (int iv = 0; iv < 2; ++iv) {
      double u = 0.5 * (1 + gp[iu]);
      double v = 0.5 * (1 + gp[iv]);
      V3 q{
          (1 - u) * (1 - v) * verts[0].x + u * (1 - v) * verts[1].x +
              u * v * verts[2].x + (1 - u) * v * verts[3].x,
          (1 - u) * (1 - v) * verts[0].y + u * (1 - v) * verts[1].y +
              u * v * verts[2].y + (1 - u) * v * verts[3].y,
          (1 - u) * (1 - v) * verts[0].z + u * (1 - v) * verts[1].z +
              u * v * verts[2].z + (1 - u) * v * verts[3].z,
      };
      double r = norm(sub(p, q));
      phi += 0.25 * area / (4.0 * M_PI * (r > 1e-12 ? r : 1e-12));
    }
  }
  return phi;
}

// velocity (gradient of potential) at p from a quad source panel
V3 quad_velocity(const V3* verts, double area, const V3& p) {
  static const double gp[2] = {-0.5773502691896257, 0.5773502691896257};
  V3 vel{0, 0, 0};
  for (int iu = 0; iu < 2; ++iu) {
    for (int iv = 0; iv < 2; ++iv) {
      double u = 0.5 * (1 + gp[iu]);
      double v = 0.5 * (1 + gp[iv]);
      V3 q{
          (1 - u) * (1 - v) * verts[0].x + u * (1 - v) * verts[1].x +
              u * v * verts[2].x + (1 - u) * v * verts[3].x,
          (1 - u) * (1 - v) * verts[0].y + u * (1 - v) * verts[1].y +
              u * v * verts[2].y + (1 - u) * v * verts[3].y,
          (1 - u) * (1 - v) * verts[0].z + u * (1 - v) * verts[1].z +
              u * v * verts[2].z + (1 - u) * v * verts[3].z,
      };
      V3 d = sub(p, q);
      double r = norm(d);
      double r3 = (r > 1e-9 ? r * r * r : 1e-27);
      double c = 0.25 * area / (4.0 * M_PI * r3);
      vel.x += c * d.x;
      vel.y += c * d.y;
      vel.z += c * d.z;
    }
  }
  return vel;
}

// dense partial-pivot LU solve: A (n x n, row major) x = b, overwrites
int lu_solve(std::vector<double>& A, std::vector<double>& b, int n) {
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int k = 0; k < n; ++k) {
    int pk = k;
    double amax = std::fabs(A[k * n + k]);
    for (int i = k + 1; i < n; ++i) {
      double a = std::fabs(A[i * n + k]);
      if (a > amax) {
        amax = a;
        pk = i;
      }
    }
    if (amax < 1e-30) return 1;
    if (pk != k) {
      for (int j = 0; j < n; ++j) std::swap(A[k * n + j], A[pk * n + j]);
      std::swap(b[k], b[pk]);
    }
    double inv = 1.0 / A[k * n + k];
    for (int i = k + 1; i < n; ++i) {
      double f = A[i * n + k] * inv;
      if (f == 0.0) continue;
      A[i * n + k] = f;
      for (int j = k + 1; j < n; ++j) A[i * n + j] -= f * A[k * n + j];
      b[i] -= f * b[k];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int j = i + 1; j < n; ++j) s -= A[i * n + j] * b[j];
    b[i] = s / A[i * n + i];
  }
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// finite-frequency machinery
// ---------------------------------------------------------------------------

#include <complex>

namespace {

using cd = std::complex<double>;

// complex dense partial-pivot LU with multiple right-hand sides.
// A (n x n row major) is destroyed; B is (nrhs x n) row-per-RHS.
int lu_solve_cplx(std::vector<cd>& A, std::vector<cd>& B, int n, int nrhs) {
  for (int k = 0; k < n; ++k) {
    int pk = k;
    double amax = std::abs(A[static_cast<size_t>(k) * n + k]);
    for (int i = k + 1; i < n; ++i) {
      double a = std::abs(A[static_cast<size_t>(i) * n + k]);
      if (a > amax) {
        amax = a;
        pk = i;
      }
    }
    if (amax < 1e-30) return 1;
    if (pk != k) {
      for (int j = 0; j < n; ++j)
        std::swap(A[static_cast<size_t>(k) * n + j], A[static_cast<size_t>(pk) * n + j]);
      for (int r = 0; r < nrhs; ++r)
        std::swap(B[static_cast<size_t>(r) * n + k], B[static_cast<size_t>(r) * n + pk]);
    }
    cd inv = 1.0 / A[static_cast<size_t>(k) * n + k];
    for (int i = k + 1; i < n; ++i) {
      cd f = A[static_cast<size_t>(i) * n + k] * inv;
      if (f == cd(0.0, 0.0)) continue;
      A[static_cast<size_t>(i) * n + k] = f;
      for (int j = k + 1; j < n; ++j)
        A[static_cast<size_t>(i) * n + j] -= f * A[static_cast<size_t>(k) * n + j];
      for (int r = 0; r < nrhs; ++r)
        B[static_cast<size_t>(r) * n + i] -= f * B[static_cast<size_t>(r) * n + k];
    }
  }
  for (int r = 0; r < nrhs; ++r) {
    for (int i = n - 1; i >= 0; --i) {
      cd s = B[static_cast<size_t>(r) * n + i];
      for (int j = i + 1; j < n; ++j)
        s -= A[static_cast<size_t>(i) * n + j] * B[static_cast<size_t>(r) * n + j];
      B[static_cast<size_t>(r) * n + i] = s / A[static_cast<size_t>(i) * n + i];
    }
  }
  return 0;
}

// bilinear lookup in the (ln d, alpha = R/d) wave-term tables
struct GreenTab {
  int nd, na;
  const double *lnd, *alpha, *L, *M;
};

inline double tab_interp(const GreenTab& t, const double* T, double x, double a) {
  if (x < t.lnd[0]) x = t.lnd[0];
  if (x > t.lnd[t.nd - 1]) x = t.lnd[t.nd - 1];
  if (a < 0) a = 0;
  if (a > 1) a = 1;
  // uniform grids
  double fx = (x - t.lnd[0]) / (t.lnd[t.nd - 1] - t.lnd[0]) * (t.nd - 1);
  double fa = (a - t.alpha[0]) / (t.alpha[t.na - 1] - t.alpha[0]) * (t.na - 1);
  int i = static_cast<int>(fx);
  int j = static_cast<int>(fa);
  if (i > t.nd - 2) i = t.nd - 2;
  if (j > t.na - 2) j = t.na - 2;
  fx -= i;
  fa -= j;
  const double* row0 = T + static_cast<size_t>(i) * t.na;
  const double* row1 = row0 + t.na;
  return (1 - fx) * ((1 - fa) * row0[j] + fa * row0[j + 1]) +
         fx * ((1 - fa) * row1[j] + fa * row1[j + 1]);
}

// wave part of the Green function (kernel normalisation 1/(4 pi r)):
// potential and gradient at field p due to a unit source at q, both z<0.
// K: wavenumber.  Uses G_w = (1/4pi)[2K L + i 2 pi K e^Z J0].
struct WaveEval {
  cd pot;
  cd grad[3];  // d/dx, d/dy, d/dz at the field point
};

inline WaveEval wave_term(const GreenTab& t, double K, const V3& p, const V3& q) {
  double dx = p.x - q.x, dy = p.y - q.y;
  double Rh = std::sqrt(dx * dx + dy * dy);
  double R = K * Rh;
  double Z = K * (p.z + q.z);
  if (Z > -1e-12) Z = -1e-12;
  double d = std::sqrt(R * R + Z * Z);
  double x = std::log(d > 1e-300 ? d : 1e-300);
  double a = (d > 0 ? R / d : 0.0);
  double L = tab_interp(t, t.L, x, a);
  double M = tab_interp(t, t.M, x, a);

  double eZ = std::exp(Z);
  double J0 = j0(R);
  double J1 = j1(R);

  const double c = 1.0 / (4.0 * M_PI);
  WaveEval w;
  w.pot = c * cd(2.0 * K * L, 2.0 * M_PI * K * eZ * J0);

  // dL/dR = -((d - |Z|)/(R d) + M); dL/dZ = L + 1/d
  double dLdR = (R > 1e-12) ? -((d + Z) / (R * d) + M) : 0.0;  // Z<0: |Z|=-Z
  double dLdZ = L + 1.0 / d;
  double dRe_dRh = c * 2.0 * K * K * dLdR;
  double dIm_dRh = -c * 2.0 * M_PI * K * K * eZ * J1;
  double dRe_dz = c * 2.0 * K * K * dLdZ;
  double dIm_dz = c * 2.0 * M_PI * K * K * eZ * J0;

  double ux = (Rh > 1e-12) ? dx / Rh : 0.0;
  double uy = (Rh > 1e-12) ? dy / Rh : 0.0;
  w.grad[0] = cd(dRe_dRh * ux, dIm_dRh * ux);
  w.grad[1] = cd(dRe_dRh * uy, dIm_dRh * uy);
  w.grad[2] = cd(dRe_dz, dIm_dz);
  return w;
}

// wave term integrated over source panel j by its 2x2 Gauss points
inline WaveEval wave_panel(const GreenTab& t, double K, const V3& p,
                           const V3* verts, double area) {
  static const double gp[2] = {-0.5773502691896257, 0.5773502691896257};
  WaveEval acc;
  acc.pot = 0;
  acc.grad[0] = acc.grad[1] = acc.grad[2] = 0;
  for (int iu = 0; iu < 2; ++iu) {
    for (int iv = 0; iv < 2; ++iv) {
      double u = 0.5 * (1 + gp[iu]);
      double v = 0.5 * (1 + gp[iv]);
      V3 q{
          (1 - u) * (1 - v) * verts[0].x + u * (1 - v) * verts[1].x +
              u * v * verts[2].x + (1 - u) * v * verts[3].x,
          (1 - u) * (1 - v) * verts[0].y + u * (1 - v) * verts[1].y +
              u * v * verts[2].y + (1 - u) * v * verts[3].y,
          (1 - u) * (1 - v) * verts[0].z + u * (1 - v) * verts[1].z +
              u * v * verts[2].z + (1 - u) * v * verts[3].z,
      };
      WaveEval w = wave_term(t, K, p, q);
      acc.pot += 0.25 * area * w.pot;
      for (int k = 0; k < 3; ++k) acc.grad[k] += 0.25 * area * w.grad[k];
    }
  }
  return acc;
}

}  // namespace

// ---------------------------------------------------------------------------
// finite-depth wave kernel: John's eigenfunction series
// (raft_tpu_torch/native/green_fd.py is the validated host-side prototype;
// constants/roots are solved there and passed in)
// ---------------------------------------------------------------------------

#include <mutex>

struct FDGreen {
  int n_modes;      // evanescent modes available in km/Cm
  double K;         // omega^2 / g
  double h;         // water depth
  double k0;        // propagating wavenumber: k0 tanh k0 h = K
  double den0;      // h k0^2 sech^2(k0 h) + K  (stable C0 denominator)
  const double* km;  // (n_modes,)
  const double* Cm;  // (n_modes,) (km^2+K^2)/(h(km^2+K^2)-K)
};

namespace {

// K0/K1 lookup tables on a log grid (cyl_bessel_k is far too slow to
// call n^2 * n_modes times); ~1e-7 relative interpolation error.
constexpr int kBesselN = 1 << 14;
constexpr double kBesselXmin = 1e-7, kBesselXmax = 700.0;
double kK0tab[kBesselN], kK1tab[kBesselN];
std::once_flag kBesselOnce;

void build_bessel_tables() {
  double lmin = std::log(kBesselXmin), lmax = std::log(kBesselXmax);
  for (int i = 0; i < kBesselN; ++i) {
    double x = std::exp(lmin + (lmax - lmin) * i / (kBesselN - 1));
    kK0tab[i] = std::cyl_bessel_k(0.0, x);
    kK1tab[i] = std::cyl_bessel_k(1.0, x);
  }
}

inline void bessel_k01(double x, double* K0v, double* K1v) {
  // beyond the table the terms are below 1e-300; below it use the
  // small-x forms K0 ~ -ln(x/2)-gamma, K1 ~ 1/x
  if (x >= kBesselXmax) {
    *K0v = 0.0;
    *K1v = 0.0;
    return;
  }
  if (x <= kBesselXmin) {
    *K0v = -std::log(0.5 * x) - 0.5772156649015329;
    *K1v = 1.0 / x;
    return;
  }
  double lmin = std::log(kBesselXmin), lmax = std::log(kBesselXmax);
  double f = (std::log(x) - lmin) / (lmax - lmin) * (kBesselN - 1);
  int i = static_cast<int>(f);
  if (i > kBesselN - 2) i = kBesselN - 2;
  f -= i;
  *K0v = (1 - f) * kK0tab[i] + f * kK0tab[i + 1];
  *K1v = (1 - f) * kK1tab[i] + f * kK1tab[i + 1];
}

// stable cosh k0(z+h) cosh k0(zeta+h) / cosh^2(k0 h): all exponents <= 0
inline double prop_profile(double k0, double h, double z, double zeta,
                           double* dprof_dz) {
  double a = k0 * (z + h), b = k0 * (zeta + h), c = k0 * h;
  double f = std::exp(a + b - 2 * c) * (1 + std::exp(-2 * a)) *
             (1 + std::exp(-2 * b)) /
             ((1 + std::exp(-2 * c)) * (1 + std::exp(-2 * c)));
  // d/dz: factor tanh(k0 (z+h)) * k0
  double th = std::tanh(a);
  *dprof_dz = k0 * th * f;
  return f;
}

// finite-depth wave term at a point pair: the full eigen-series G minus
// the 1/r and 1/r1 (surface image) Rankine parts the assembly adds
// separately.  Kernel normalisation 1/(4 pi r), like wave_term().
WaveEval fd_wave_point(const FDGreen& fd, double Rh, double zf, double zq) {
  const double c4 = 1.0 / (4.0 * M_PI);
  double dp;
  double prof = prop_profile(fd.k0, fd.h, zf, zq, &dp);
  double A0 = fd.k0 * fd.k0 * prof / fd.den0;
  double dA0_dz = fd.k0 * fd.k0 * dp / fd.den0;

  double x = fd.k0 * Rh;
  double J0 = j0(x), J1 = j1(x), Y0 = y0(x), Y1 = y1(x);
  // G_prop = 2 pi A0 (-Y0 + i J0)(k0 R)
  cd pot = 2.0 * M_PI * cd(-A0 * Y0, A0 * J0);
  double dRe_dR = 2.0 * M_PI * A0 * fd.k0 * Y1;
  double dIm_dR = -2.0 * M_PI * A0 * fd.k0 * J1;
  double dRe_dz = 2.0 * M_PI * (-dA0_dz * Y0);
  double dIm_dz = 2.0 * M_PI * (dA0_dz * J0);

  // evanescent sum: 4 sum Cm cos km(z+h) cos km(zeta+h) K0(km R);
  // adaptive cutoff from the e^{-km R} decay of K0
  int M = fd.n_modes;
  if (Rh * fd.km[0] > 1e-12) {
    double need = 36.0 / Rh;  // km beyond this: K0 < ~2e-16
    int Mneed = static_cast<int>(need * fd.h / M_PI) + 2;
    if (Mneed < M) M = Mneed;
  }
  double zfh = zf + fd.h, zqh = zq + fd.h;
  double sum = 0, dsum_dR = 0, dsum_dz = 0;
  for (int m = 0; m < M; ++m) {
    double kmv = fd.km[m];
    double K0v, K1v;
    bessel_k01(kmv * Rh, &K0v, &K1v);
    if (K0v == 0.0 && K1v == 0.0) break;
    double ca = std::cos(kmv * zfh), cb = std::cos(kmv * zqh);
    double sa = std::sin(kmv * zfh);
    double t = 4.0 * fd.Cm[m] * cb;
    sum += t * ca * K0v;
    dsum_dR += -t * ca * kmv * K1v;
    dsum_dz += -t * sa * kmv * K0v;
  }
  pot += sum;
  dRe_dR += dsum_dR;
  dRe_dz += dsum_dz;

  // subtract the Rankine parts the assembly adds explicitly
  double dz1 = zf - zq, dz2 = zf + zq;
  double r = std::sqrt(Rh * Rh + dz1 * dz1);
  double r1 = std::sqrt(Rh * Rh + dz2 * dz2);
  if (r > 1e-12) {
    pot -= 1.0 / r;
    dRe_dR += Rh / (r * r * r);
    dRe_dz += dz1 / (r * r * r);
  }
  if (r1 > 1e-12) {
    pot -= 1.0 / r1;
    dRe_dR += Rh / (r1 * r1 * r1);
    dRe_dz += dz2 / (r1 * r1 * r1);
  }

  WaveEval w;
  w.pot = c4 * pot;
  w.grad[0] = c4 * cd(dRe_dR, dIm_dR);   // d/dRh (direction applied by caller)
  w.grad[1] = 0;
  w.grad[2] = c4 * cd(dRe_dz, dIm_dz);
  return w;
}

// finite-depth wave term with small-R treatment: the truncated
// evanescent series (minus Rankine parts) loses accuracy for
// R << h / n_modes, but the remainder is smooth and even in R there,
// so extrapolate quadratically in R^2 from three well-converged radii.
WaveEval fd_wave_term(const FDGreen& fd, const V3& p, const V3& q) {
  double dx = p.x - q.x, dy = p.y - q.y;
  double Rh = std::sqrt(dx * dx + dy * dy);
  double zf = (p.z < -1e-9 ? p.z : -1e-9);
  double zq = (q.z < -1e-9 ? q.z : -1e-9);
  // radius below which n_modes no longer resolves the series
  double Rc = 40.0 * fd.h / (M_PI * fd.n_modes);

  WaveEval w;
  if (Rh >= Rc) {
    w = fd_wave_point(fd, Rh, zf, zq);
  } else {
    // three-point fit f(R^2) = a + b R^2 + c R^4 on {Rc, sqrt2 Rc, 2 Rc}
    WaveEval w1 = fd_wave_point(fd, Rc, zf, zq);
    WaveEval w2 = fd_wave_point(fd, Rc * 1.4142135623730951, zf, zq);
    WaveEval w3 = fd_wave_point(fd, 2.0 * Rc, zf, zq);
    double s = Rc * Rc;
    double t = Rh * Rh / s;  // in units of Rc^2: nodes at 1, 2, 4
    // Lagrange weights for nodes {1, 2, 4} in t
    double l1 = (t - 2) * (t - 4) / ((1 - 2) * (1 - 4));
    double l2 = (t - 1) * (t - 4) / ((2 - 1) * (2 - 4));
    double l3 = (t - 1) * (t - 2) / ((4 - 1) * (4 - 2));
    w.pot = l1 * w1.pot + l2 * w2.pot + l3 * w3.pot;
    w.grad[2] = l1 * w1.grad[2] + l2 * w2.grad[2] + l3 * w3.grad[2];
    // df/dR = df/dt * dt/dR = (sum dl/dt f) * 2R/s
    double d1 = ((t - 2) + (t - 4)) / 3.0;
    double d2 = ((t - 1) + (t - 4)) / -2.0;
    double d3 = ((t - 1) + (t - 2)) / 6.0;
    w.grad[0] = (d1 * w1.pot + d2 * w2.pot + d3 * w3.pot) * (2.0 * Rh / s);
    w.grad[1] = 0;
  }
  double ux = (Rh > 1e-12) ? dx / Rh : 0.0;
  double uy = (Rh > 1e-12) ? dy / Rh : 0.0;
  cd dR = w.grad[0];
  w.grad[0] = dR * ux;
  w.grad[1] = dR * uy;
  return w;
}

// finite-depth wave term integrated over source panel j (2x2 Gauss)
inline WaveEval fd_wave_panel(const FDGreen& fd, const V3& p, const V3* verts,
                              double area) {
  static const double gp[2] = {-0.5773502691896257, 0.5773502691896257};
  WaveEval acc;
  acc.pot = 0;
  acc.grad[0] = acc.grad[1] = acc.grad[2] = 0;
  for (int iu = 0; iu < 2; ++iu) {
    for (int iv = 0; iv < 2; ++iv) {
      double u = 0.5 * (1 + gp[iu]);
      double v = 0.5 * (1 + gp[iv]);
      V3 q{
          (1 - u) * (1 - v) * verts[0].x + u * (1 - v) * verts[1].x +
              u * v * verts[2].x + (1 - u) * v * verts[3].x,
          (1 - u) * (1 - v) * verts[0].y + u * (1 - v) * verts[1].y +
              u * v * verts[2].y + (1 - u) * v * verts[3].y,
          (1 - u) * (1 - v) * verts[0].z + u * (1 - v) * verts[1].z +
              u * v * verts[2].z + (1 - u) * v * verts[3].z,
      };
      WaveEval w = fd_wave_term(fd, p, q);
      acc.pot += 0.25 * area * w.pot;
      for (int k = 0; k < 3; ++k) acc.grad[k] += 0.25 * area * w.grad[k];
    }
  }
  return acc;
}

}  // namespace

extern "C" {

// Solve radiation (6 modes) + diffraction (nh headings) at ONE frequency.
//
// Geometry as in panel_radiation_added_mass.  K is the (finite-depth
// mapped) wavenumber, omega the angular frequency, rho/g fluid
// properties, ref the reference point for rotational modes.
// Wave tables are passed from Python (see raft_tpu_torch/native/green_table.py).
//
// Outputs: A_out/B_out (6x6) added mass / radiation damping;
// X_out (nh x 6 x 2): excitation force complex amplitudes per unit wave
// amplitude (WAMIT heading convention: beta measured from +x).
int panel_solve_frequency(int n, const double* vertices, const double* centroid,
                          const double* normal, const double* area, double K,
                          double omega, double rho, double g, const double* ref,
                          int nh, const double* headings, int nd, int na,
                          const double* lnd_grid, const double* alpha_grid,
                          const double* Ltab, const double* Mtab, double* A_out,
                          double* B_out, double* X_out) {
  const V3* verts = reinterpret_cast<const V3*>(vertices);
  const V3* cen = reinterpret_cast<const V3*>(centroid);
  const V3* nor = reinterpret_cast<const V3*>(normal);
  const V3 r0{ref[0], ref[1], ref[2]};
  GreenTab tab{nd, na, lnd_grid, alpha_grid, Ltab, Mtab};

  // ---- influence matrices: normal velocity G_v and potential P at
  // centroid i from unit source on panel j (Rankine + positive image +
  // wave term)
  std::vector<cd> Gv(static_cast<size_t>(n) * n);
  std::vector<cd> P(static_cast<size_t>(n) * n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      double g_re, p_re;
      if (i == j) {
        g_re = 0.5;
        double a_eq = std::sqrt(area[j] / M_PI);
        p_re = 0.5 * a_eq;
      } else {
        V3 vel = quad_velocity(&verts[4 * j], area[j], cen[i]);
        g_re = dot(vel, nor[i]);
        p_re = quad_potential(&verts[4 * j], area[j], cen[i]);
      }
      // positive image above z = 0 (the 1/r1 term of the wave G)
      V3 iv[4];
      for (int k = 0; k < 4; ++k) {
        iv[k] = verts[4 * j + k];
        iv[k].z = -iv[k].z;
      }
      V3 velm = quad_velocity(iv, area[j], cen[i]);
      double phim = quad_potential(iv, area[j], cen[i]);
      g_re += dot(velm, nor[i]);
      p_re += phim;
      // wave term (smooth; 2x2 Gauss over the source panel).
      //
      // Sign convention: the Rankine blocks above follow the legacy
      // rows (g_re = -(true gradient) . n, +0.5 diagonal), i.e. the
      // assembled system solves  -dphi/dn = rhs.  The wave gradient is
      // the TRUE field-point gradient, so it enters with a minus; the
      // potential matrix is negated wholesale so that phi = P sigma
      // recovers the true potential for the sign-flipped sigma.
      WaveEval w = wave_panel(tab, K, cen[i], &verts[4 * j], area[j]);
      cd gn = w.grad[0] * nor[i].x + w.grad[1] * nor[i].y + w.grad[2] * nor[i].z;
      Gv[static_cast<size_t>(i) * n + j] = cd(g_re, 0.0) - gn;
      P[static_cast<size_t>(i) * n + j] = -(cd(p_re, 0.0) + w.pot);
    }
  }

  // ---- right-hand sides: 6 radiation modes + nh diffraction headings
  int nrhs = 6 + nh;
  std::vector<cd> rhs(static_cast<size_t>(nrhs) * n);
  std::vector<double> nmode(static_cast<size_t>(6) * n);
  for (int i = 0; i < n; ++i) {
    V3 rr = sub(cen[i], r0);
    double nm[6] = {nor[i].x,
                    nor[i].y,
                    nor[i].z,
                    rr.y * nor[i].z - rr.z * nor[i].y,
                    rr.z * nor[i].x - rr.x * nor[i].z,
                    rr.x * nor[i].y - rr.y * nor[i].x};
    for (int m = 0; m < 6; ++m) {
      nmode[static_cast<size_t>(m) * n + i] = nm[m];
      rhs[static_cast<size_t>(m) * n + i] = nm[m];
    }
  }
  // incident potential for UNIT POSITIVE elevation amplitude travelling
  // toward heading beta (e^{-i omega t} convention; elevation
  // zeta = (i omega / g) phi_I at z=0):
  //   phi_I = -(i g / omega) e^{Kz} e^{+i K (x cosb + y sinb)}
  // diffraction BC: d(phi_S)/dn = -d(phi_I)/dn
  std::vector<cd> phiI(static_cast<size_t>(nh) * n);
  for (int h = 0; h < nh; ++h) {
    double cb = std::cos(headings[h]);
    double sb = std::sin(headings[h]);
    for (int i = 0; i < n; ++i) {
      cd e = std::exp(cd(K * cen[i].z, K * (cen[i].x * cb + cen[i].y * sb)));
      cd pI = cd(0.0, -g / omega) * e;
      phiI[static_cast<size_t>(h) * n + i] = pI;
      cd dpx = pI * cd(0.0, K * cb);
      cd dpy = pI * cd(0.0, K * sb);
      cd dpz = pI * K;
      // the assembled system solves -dphi/dn = rhs and phi is read back
      // through the negated potential matrix, so the scattering BC
      // dphi_S/dn = -dphi_I/dn enters with rhs = -dphi_I/dn (the double
      // sign flip cancels; radiation absorbs it in the A/B formulas)
      rhs[static_cast<size_t>(6 + h) * n + i] =
          -(dpx * nor[i].x + dpy * nor[i].y + dpz * nor[i].z);
    }
  }

  std::vector<cd> Gc(Gv);
  if (lu_solve_cplx(Gc, rhs, n, nrhs)) return 1;

  // ---- potentials on the body per RHS
  std::vector<cd> phi(static_cast<size_t>(nrhs) * n);
  for (int r = 0; r < nrhs; ++r) {
    for (int i = 0; i < n; ++i) {
      cd s = 0;
      for (int j = 0; j < n; ++j)
        s += P[static_cast<size_t>(i) * n + j] * rhs[static_cast<size_t>(r) * n + j];
      phi[static_cast<size_t>(r) * n + i] = s;
    }
  }

  // ---- radiation: with true potentials (e^{-i omega t} convention)
  // rho int phi_m n_k dS = -A_km - (i/omega) B_km
  for (int k = 0; k < 6; ++k) {
    for (int m = 0; m < 6; ++m) {
      cd s = 0;
      for (int i = 0; i < n; ++i)
        s += phi[static_cast<size_t>(m) * n + i] *
             nmode[static_cast<size_t>(k) * n + i] * area[i];
      A_out[k * 6 + m] = -rho * s.real();
      B_out[k * 6 + m] = -rho * omega * s.imag();
    }
  }

  // ---- excitation: X_k = -i omega rho int (phi_I + phi_S) n_k dS
  for (int h = 0; h < nh; ++h) {
    for (int k = 0; k < 6; ++k) {
      cd s = 0;
      for (int i = 0; i < n; ++i)
        s += (phiI[static_cast<size_t>(h) * n + i] +
              phi[static_cast<size_t>(6 + h) * n + i]) *
             nmode[static_cast<size_t>(k) * n + i] * area[i];
      cd X = cd(0.0, -omega) * rho * s;
      // conjugate: the WAMIT-format files the reference pipeline
      // consumes (and the HAMS outputs validated against) carry the
      // e^{+i omega t} phase convention
      X_out[(h * 6 + k) * 2] = X.real();
      X_out[(h * 6 + k) * 2 + 1] = -X.imag();
    }
  }
  return 0;
}

// Finite-depth variant of panel_solve_frequency: the wave term is
// John's eigenfunction series (see green_fd.py for the validated
// prototype and the root solve), the incident wave uses the
// cosh-profile, and the dispersion data (k0, evanescent km, Cm) comes
// precomputed from Python.
//
// NOTE: the assembly/solve/output blocks mirror panel_solve_frequency
// line for line (only the wave kernel and incident wave differ).  Any
// fix to the sign-convention logic (negated P matrix, conjugated X
// output, self terms) MUST be applied to both functions.
int panel_solve_frequency_fd(
    int n, const double* vertices, const double* centroid,
    const double* normal, const double* area, double omega, double rho,
    double g, double depth, const double* ref, int nh,
    const double* headings, int n_modes, double k0_in, const double* km,
    const double* Cm, double* A_out, double* B_out, double* X_out) {
  const V3* verts = reinterpret_cast<const V3*>(vertices);
  const V3* cen = reinterpret_cast<const V3*>(centroid);
  const V3* nor = reinterpret_cast<const V3*>(normal);
  const V3 r0{ref[0], ref[1], ref[2]};

  std::call_once(kBesselOnce, build_bessel_tables);

  double K = omega * omega / g;
  double c0h = k0_in * depth;
  double sech2 = (c0h < 350.0)
                     ? 1.0 / (std::cosh(c0h) * std::cosh(c0h))
                     : 4.0 * std::exp(-2.0 * c0h);
  FDGreen fd{n_modes, K, depth, k0_in,
             depth * k0_in * k0_in * sech2 + K, km, Cm};

  std::vector<cd> Gv(static_cast<size_t>(n) * n);
  std::vector<cd> P(static_cast<size_t>(n) * n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      double g_re, p_re;
      if (i == j) {
        g_re = 0.5;
        double a_eq = std::sqrt(area[j] / M_PI);
        p_re = 0.5 * a_eq;
      } else {
        V3 vel = quad_velocity(&verts[4 * j], area[j], cen[i]);
        g_re = dot(vel, nor[i]);
        p_re = quad_potential(&verts[4 * j], area[j], cen[i]);
      }
      // positive surface image (the fd wave term subtracts it)
      V3 iv[4];
      for (int k = 0; k < 4; ++k) {
        iv[k] = verts[4 * j + k];
        iv[k].z = -iv[k].z;
      }
      V3 velm = quad_velocity(iv, area[j], cen[i]);
      double phim = quad_potential(iv, area[j], cen[i]);
      g_re += dot(velm, nor[i]);
      p_re += phim;
      WaveEval w = fd_wave_panel(fd, cen[i], &verts[4 * j], area[j]);
      cd gn = w.grad[0] * nor[i].x + w.grad[1] * nor[i].y + w.grad[2] * nor[i].z;
      Gv[static_cast<size_t>(i) * n + j] = cd(g_re, 0.0) - gn;
      P[static_cast<size_t>(i) * n + j] = -(cd(p_re, 0.0) + w.pot);
    }
  }

  int nrhs = 6 + nh;
  std::vector<cd> rhs(static_cast<size_t>(nrhs) * n);
  std::vector<double> nmode(static_cast<size_t>(6) * n);
  for (int i = 0; i < n; ++i) {
    V3 rr = sub(cen[i], r0);
    double nm[6] = {nor[i].x,
                    nor[i].y,
                    nor[i].z,
                    rr.y * nor[i].z - rr.z * nor[i].y,
                    rr.z * nor[i].x - rr.x * nor[i].z,
                    rr.x * nor[i].y - rr.y * nor[i].x};
    for (int m = 0; m < 6; ++m) {
      nmode[static_cast<size_t>(m) * n + i] = nm[m];
      rhs[static_cast<size_t>(m) * n + i] = nm[m];
    }
  }
  // finite-depth incident wave, unit positive elevation amplitude:
  //   phi_I = -(i g / omega) (cosh k0(z+h)/cosh k0 h) e^{+i k0 (x cb + y sb)}
  std::vector<cd> phiI(static_cast<size_t>(nh) * n);
  for (int h = 0; h < nh; ++h) {
    double cb = std::cos(headings[h]);
    double sb = std::sin(headings[h]);
    for (int i = 0; i < n; ++i) {
      double a = k0_in * (cen[i].z + depth);
      double prof = std::exp(a - c0h) * (1 + std::exp(-2 * a)) /
                    (1 + std::exp(-2 * c0h));
      cd e = prof *
             std::exp(cd(0.0, k0_in * (cen[i].x * cb + cen[i].y * sb)));
      cd pI = cd(0.0, -g / omega) * e;
      phiI[static_cast<size_t>(h) * n + i] = pI;
      cd dpx = pI * cd(0.0, k0_in * cb);
      cd dpy = pI * cd(0.0, k0_in * sb);
      cd dpz = pI * (k0_in * std::tanh(a));
      rhs[static_cast<size_t>(6 + h) * n + i] =
          -(dpx * nor[i].x + dpy * nor[i].y + dpz * nor[i].z);
    }
  }

  std::vector<cd> Gc(Gv);
  if (lu_solve_cplx(Gc, rhs, n, nrhs)) return 1;

  std::vector<cd> phi(static_cast<size_t>(nrhs) * n);
  for (int r = 0; r < nrhs; ++r) {
    for (int i = 0; i < n; ++i) {
      cd s = 0;
      for (int j = 0; j < n; ++j)
        s += P[static_cast<size_t>(i) * n + j] *
             rhs[static_cast<size_t>(r) * n + j];
      phi[static_cast<size_t>(r) * n + i] = s;
    }
  }

  for (int k = 0; k < 6; ++k) {
    for (int m = 0; m < 6; ++m) {
      cd s = 0;
      for (int i = 0; i < n; ++i)
        s += phi[static_cast<size_t>(m) * n + i] *
             nmode[static_cast<size_t>(k) * n + i] * area[i];
      A_out[k * 6 + m] = -rho * s.real();
      B_out[k * 6 + m] = -rho * omega * s.imag();
    }
  }

  for (int h = 0; h < nh; ++h) {
    for (int k = 0; k < 6; ++k) {
      cd s = 0;
      for (int i = 0; i < n; ++i)
        s += (phiI[static_cast<size_t>(h) * n + i] +
              phi[static_cast<size_t>(6 + h) * n + i]) *
             nmode[static_cast<size_t>(k) * n + i] * area[i];
      cd X = cd(0.0, -omega) * rho * s;
      X_out[(h * 6 + k) * 2] = X.real();
      X_out[(h * 6 + k) * 2 + 1] = -X.imag();
    }
  }
  return 0;
}

}  // extern "C"

extern "C" {

// Solve the radiation problem for all 6 rigid-body modes.
//
// vertices : (n, 4, 3) panel corner coordinates (below the waterline)
// centroid : (n, 3); normal : (n, 3) body-outward unit normals;
// area     : (n,)
// mirror   : -1 (phi=0 free surface, w->inf) or +1 (rigid lid, w->0)
// rho      : fluid density
// ref      : (3,) reference point for the rotational modes
// A_out    : (6, 6) added-mass matrix, row major
//
// Returns 0 on success.
int panel_radiation_added_mass(int n, const double* vertices,
                               const double* centroid, const double* normal,
                               const double* area, int mirror, double rho,
                               const double* ref, double* A_out) {
  const V3* verts = reinterpret_cast<const V3*>(vertices);
  const V3* cen = reinterpret_cast<const V3*>(centroid);
  const V3* nor = reinterpret_cast<const V3*>(normal);
  const V3 r0{ref[0], ref[1], ref[2]};

  // ---- influence matrix: normal velocity at panel i from unit source
  // on panel j (+ mirrored image panel)
  std::vector<double> G(static_cast<size_t>(n) * n);
  std::vector<double> P(static_cast<size_t>(n) * n);  // potentials
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      if (i == j) {
        // analytic self terms: half-space velocity jump + equivalent disk
        G[i * n + j] = 0.5;  // (sigma/2) outward normal velocity
        double a_eq = std::sqrt(area[j] / M_PI);
        P[i * n + j] = 0.5 * a_eq;  // disk potential a/2 for 1/(4 pi r)
      } else {
        V3 vel = quad_velocity(&verts[4 * j], area[j], cen[i]);
        G[i * n + j] = dot(vel, nor[i]);
        P[i * n + j] = quad_potential(&verts[4 * j], area[j], cen[i]);
      }
      // mirrored image above z = 0
      V3 iv[4];
      for (int k = 0; k < 4; ++k) {
        iv[k] = verts[4 * j + k];
        iv[k].z = -iv[k].z;
      }
      V3 velm = quad_velocity(iv, area[j], cen[i]);
      double phim = quad_potential(iv, area[j], cen[i]);
      G[i * n + j] += mirror * dot(velm, nor[i]);
      P[i * n + j] += mirror * phim;
    }
  }

  // ---- modes: rigid-body normal velocities
  // translations: n_k ; rotations: ((r - r0) x n)_k
  std::vector<double> phi(static_cast<size_t>(6) * n);  // panel potentials per mode
  std::vector<double> nmode(static_cast<size_t>(6) * n);
  for (int i = 0; i < n; ++i) {
    V3 rr = sub(cen[i], r0);
    double nm[6] = {nor[i].x,
                    nor[i].y,
                    nor[i].z,
                    rr.y * nor[i].z - rr.z * nor[i].y,
                    rr.z * nor[i].x - rr.x * nor[i].z,
                    rr.x * nor[i].y - rr.y * nor[i].x};
    for (int m = 0; m < 6; ++m) nmode[m * n + i] = nm[m];
  }

  for (int m = 0; m < 6; ++m) {
    std::vector<double> Gc(G);  // LU destroys the matrix
    std::vector<double> rhs(nmode.begin() + m * n, nmode.begin() + (m + 1) * n);
    if (lu_solve(Gc, rhs, n)) return 1;
    // potentials phi_m(i) = sum_j P(i,j) sigma_j
    for (int i = 0; i < n; ++i) {
      double s = 0.0;
      for (int j = 0; j < n; ++j) s += P[i * n + j] * rhs[j];
      phi[m * n + i] = s;
    }
  }

  // ---- added mass A_km = rho * sum_i phi_m(i) n_k(i) dS_i
  for (int k = 0; k < 6; ++k) {
    for (int m = 0; m < 6; ++m) {
      double s = 0.0;
      for (int i = 0; i < n; ++i) s += phi[m * n + i] * nmode[k * n + i] * area[i];
      A_out[k * 6 + m] = rho * s;
    }
  }
  return 0;
}

}  // extern "C"
