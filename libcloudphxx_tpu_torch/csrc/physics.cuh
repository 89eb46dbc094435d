// Device functions shared by the step kernels (cond.cu, cond_flat.cu,
// transport.cu, coal.cu): the per-cell closure, the terminal velocity
// formulas, the collision kernels and the Shima collision
// (the condensation's per-droplet growth and root find are in
// cond_cell.cuh).  Each follows its plain PyTorch version operation for
// operation:
//   closure        lgrngn/hskpng.py hskpng_Tpr
//   vt_formula     lgrngn/vterm.py vt_in_kernel (vt_beard77, vt_beard76,
//                  vt_khvorostyanov: common/vterm.py)
//   kernel_value   lgrngn/coalescence.py kernel_value
//   collision_count, collide   lgrngn/coalescence.py shima
// The library is built with -fmad=false, so no multiply-add is contracted
// that the plain version rounds twice.  Where PyTorch on the card divides a
// tensor by a Python number it multiplies by the float reciprocal, and it
// computes number / tensor as reciprocal(tensor) * number; it raises a
// tensor to the power 2 or 3 by multiplying (x * x, x * x * x) and to any
// other number or tensor by powf.  The vt formulas, which feed the
// sedimentation and hence the cell classification, copy all of it so that
// kernel and plain version classify every droplet alike.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace lcp {

// common/constants.py
constexpr double M_d = 0.02897;
constexpr double M_v = 1e-3 + 17e-3;
constexpr double eps = M_v / M_d;
constexpr double kaBoNA = 8.3144621;
constexpr double R_d = kaBoNA / M_d;
constexpr double R_v = kaBoNA / M_v;
constexpr double c_pd = 1005.0;
constexpr double c_pv = 1850.0;
constexpr double c_pw = 4218.0;
constexpr double c_pi = 2114.0;
constexpr double rho_w = 1e3;
constexpr double rho_i = 910.0;
constexpr double D_0 = 2.26e-5;
constexpr double K_0 = 2.4e-2;
constexpr double p_tri = 611.73;
constexpr double T_tri = 273.16;
constexpr double l_tri = 2.5e6;
constexpr double ls_tri = 2.834e6;
constexpr double p_stp = 101325.0;
constexpr double T_stp = 273.15 + 15;
constexpr double rho_stp = p_stp / T_stp / R_d;
constexpr double p_1000 = 100000.0;
constexpr double pi = 3.141592653589793;
constexpr double grav = 9.81;  // constants.py g
constexpr double COND_MLT = 2.0;

#define F(x) static_cast<float>(x)

// a / s for a Python number s, as PyTorch computes it on the card: times
// the reciprocal, taken in double and rounded to a's type (for s = 5.01
// and float that differs from 1.0f / 5.01f)
template <class T>
__device__ __forceinline__ T div_s(T a, double s) {
  return a * static_cast<T>(1.0 / s);
}
// s / a for a Python number s: reciprocal(a) * s
template <class T>
__device__ __forceinline__ T rdiv_s(double s, T a) {
  return (T(1) / a) * static_cast<T>(s);
}

struct Closure {
  float T, p, RH, eta;
};

// common/vterm.py visc
__device__ __forceinline__ float visc(float T) {
  float Tr = div_s(T, T_tri);
  return F(1.72e-5) * rdiv_s(393.0, T + 120.0f) * Tr * sqrtf(Tr);
}

// RH by the four formulas of lgrngn/hskpng.py RH_of
__device__ __forceinline__ float rh_of(int formula, float p, float rv,
                                       float T) {
  if (formula == 0 || formula == 2) {  // pv_cc, pv_tet
    float pv = p * rv / (rv + F(eps));
    float pvs;
    if (formula == 0) {
      constexpr double a = (l_tri + (c_pw - c_pv) * T_tri) / R_v;
      constexpr double b = (c_pw - c_pv) / R_v;
      pvs = F(p_tri) * expf(F(a) * (F(1.0 / T_tri) - rdiv_s(1.0, T))
                            - F(b) * logf(div_s(T, T_tri)));
    } else {
      float T_C = T - 273.15f;
      pvs = F(6.1078e2) * expf(F(17.27) * T_C / (T_C + 237.3f));
    }
    return pv / pvs;
  }
  float rvs;
  if (formula == 1) {  // rv_cc
    constexpr double a = (l_tri + (c_pw - c_pv) * T_tri) / R_v;
    constexpr double b = (c_pw - c_pv) / R_v;
    float pvs = F(p_tri) * expf(F(a) * (F(1.0 / T_tri) - rdiv_s(1.0, T))
                                - F(b) * logf(div_s(T, T_tri)));
    rvs = F(eps) / (p / pvs - 1.0f);
  } else {  // rv_tet
    float T_C = T - 273.15f;
    rvs = F(380.0) / (p * expf(F(-17.2693882) * T_C / (T - 35.86f))
                      - F(610.9));
  }
  return rv / rvs;
}

// lgrngn/hskpng.py hskpng_Tpr: th_dry or th_std (with p0), variable or
// prescribed pressure
__device__ __forceinline__ Closure closure(bool th_dry, bool const_p,
                                           int rh_formula, float th, float rv,
                                           float rhod, float p0) {
  Closure c;
  if (th_dry) {
    float q = powf(div_s(rhod * F(R_d), p_1000), F(R_d / c_pd));
    c.T = powf(th * q, F(c_pd / (c_pd - R_d)));
  } else {
    c.T = th * powf(div_s(p0, p_1000), F(R_d / c_pd));
  }
  c.p = const_p ? p0 : rhod * (rv * F(R_v) + F(R_d)) * c.T;
  c.RH = rh_of(rh_formula, c.p, rv, c.T);
  c.eta = visc(c.T);
  return c;
}

// lgrngn/condensation.py _perparticle_thermo: a super-droplet's closure
// from its private th, rv, rhod and p, with that function's clamps (rhod
// to 1e-10 under th_dry, p to 1 Pa under th_std and for RH)
__device__ __forceinline__ Closure sd_closure(bool th_dry, bool const_p,
                                              int rh_formula, float th,
                                              float rv, float rhod, float p) {
  Closure c;
  if (th_dry) {
    float q = powf(div_s(fmaxf(rhod, F(1e-10)) * F(R_d), p_1000),
                   F(R_d / c_pd));
    c.T = powf(th * q, F(c_pd / (c_pd - R_d)));
  } else {
    c.T = th * powf(div_s(fmaxf(p, 1.0f), p_1000), F(R_d / c_pd));
  }
  c.p = const_p ? p : rhod * (rv * F(R_v) + F(R_d)) * c.T;
  c.RH = rh_of(rh_formula, fmaxf(c.p, 1.0f), rv, c.T);
  c.eta = visc(c.T);
  return c;
}

// common/mean_free_path.py lambda_D and lambda_K
__device__ __forceinline__ float mfp_D(float T) {
  return rdiv_s(2.0 * D_0, sqrtf(T * F(2.0 * R_v)));
}
__device__ __forceinline__ float mfp_K(float T, float p) {
  return T * F(K_0) / p * F(0.8) / sqrtf(T * F(2.0 * R_d));
}

// d(theta)/d(rv), common/theta_dry.py d_th_d_rv
__device__ __forceinline__ float d_th_d_rv(float T, float th) {
  float l_v = F(c_pv - c_pw) * (T - F(T_tri)) + F(l_tri);
  return div_s(-th / T * l_v, c_pd);
}

template <int N>
__device__ __forceinline__ float polyval(const float (&c)[N], float x) {
  float acc = c[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) acc = acc * x + c[i];
  return acc;
}

// lgrngn/vterm.py vt_in_kernel: beard77 (and beard77fast) by the direct
// polynomial, common/vterm.py vt_beard77_fact * vt_beard77_v0
__device__ __forceinline__ float vt_beard77(float rw2, float p, float rhoa,
                                            float eta) {
  const float small[4] = {F(0.105035e2), F(0.108750e1), F(-0.133245),
                          F(-0.659969e-2)};
  const float large[8] = {F(0.65639e1),  F(-0.10391e1),  F(-0.14001e1),
                          F(-0.82736e0), F(-0.34277e0),  F(-0.83072e-1),
                          F(-0.10583e-1), F(-0.54208e-3)};
  const double eta_0 = 1.818e-5, l_0 = 6.62e-8;
  float r = sqrtf(fmaxf(rw2, 1e-30f));
  // altitude factor
  float l = F(l_0) * div_s(eta, eta_0)
            * sqrtf(rdiv_s(p_stp, p) * F(rho_stp) / rhoa);
  float fact_small = rdiv_s(eta_0, eta) * (1.0f + F(1.255) * (l / r))
                     / (1.0f + F(1.255) * rdiv_s(l_0, r));
  float eps_s = rdiv_s(eta_0, eta) - 1.0f;
  float eps_c = sqrtf(rdiv_s(rho_stp, rhoa)) - 1.0f;
  float lx = logf(200.0f * r);
  float fact_large = F(1.104) * eps_s
                     + div_s((F(1.058) * eps_c - F(1.104) * eps_s)
                             * (F(5.52) + lx), 5.01)
                     + 1.0f;
  float fact = (r <= F(20e-6)) ? fact_small : fact_large;
  // sea-level velocity
  float y = (r <= F(20e-6)) ? polyval(small, lx) : polyval(large, lx);
  float v = fact * div_s(expf(y), 100.0);
  return rw2 > 0.0f ? v : 0.0f;
}

// lgrngn/enums.py vt_t: the terminal velocity formula, a template
// parameter of every kernel that computes vt (one instantiation each, so
// that no formula's registers set another's allocation)
enum VtFormula {
  kVtUndefined = 0,
  kVtBeard76 = 1,
  kVtBeard77 = 2,
  kVtBeard77fast = 3,
  kVtKhvorostyanovSpherical = 4,
  kVtKhvorostyanovNonspherical = 5,
};

// The cell's fields a vt formula reads
struct Ambient {
  float T, p, rhoa, eta;
};

// common/kelvin.py sg_surf
__device__ __forceinline__ float sg_surf(float T) {
  return F(0.07275) * (1.0f - F(0.002) * (T - 291.0f));
}

// common/vterm.py vt_beard76 at radius r: one of its three regimes (the
// plain version computes all three and selects one; each regime's bits do
// not depend on the others)
__device__ __forceinline__ float vt_beard76(float r, const Ambient& a) {
  const float mid[7] = {F(-0.318657e1), F(0.992696),    F(-0.153193e-2),
                        F(-0.987059e-3), F(-0.578878e-3), F(0.855176e-4),
                        F(-0.327815e-5)};
  const float big[6] = {F(-0.500015e1), F(0.523778e1),  F(-0.204914e1),
                        F(0.475294),    F(-0.542819e-1), F(0.238449e-2)};
  const float drho = F(rho_w) - a.rhoa;
  if (r > F(5.035e-4)) {  // Bond and physical-property numbers
    const float sg = sg_surf(a.T);
    const float Bo = F(16.0 / 3.0) * r * r * drho * F(grav) / sg;
    const float N_p = div_s(sg * sg * sg * (a.rhoa * a.rhoa)
                                / powf(a.eta, 4.0f), grav) / drho;
    const float N_p6 = powf(N_p, F(1.0 / 6.0));
    const float X = logf(fmaxf(Bo * N_p6, 1e-30f));
    const float N_Re = N_p6 * expf(polyval(big, X));
    return div_s(a.eta * N_Re / a.rhoa, 2.0) / r;
  }
  // the slip correction of the small and middle regimes
  const float l = F(6.62e-8) * div_s(a.eta, 1.818e-5) * rdiv_s(p_stp, a.p)
                  * sqrtf(div_s(a.T, 293.15));
  const float C_ac = 1.0f + F(1.255) * l / r;
  if (r <= F(9.5e-6))  // Stokes
    return drho * F(grav) / (F(4.5) * a.eta) * C_ac * r * r;
  // the Davies number
  const float N_Da = F(32.0 / 3.0) * (r * r * r) * a.rhoa * drho * F(grav)
                     / (a.eta * a.eta);
  const float N_Re = C_ac * expf(polyval(mid, logf(fmaxf(N_Da, 1e-30f))));
  return div_s(a.eta * N_Re / a.rhoa, 2.0) / r;
}

// common/vterm.py vt_khvorostyanov at radius r (T enters through eta), in
// float64 as the plain version evaluates it: root - 1 cancels, and in
// float32 it gives 0 / 0 under ~2.5 nm
template <bool SPHERICAL>
__device__ __forceinline__ float vt_khvorostyanov(float r_f,
                                                  const Ambient& amb) {
  const double r = r_f, rhoa = amb.rhoa, eta = amb.eta;
  // Best number, eq 2.7
  const double X = (32.0 / 3) * (rho_w - rhoa) / rhoa * grav * (r * r * r)
                   / (eta * eta) * (rhoa * rhoa);
  const double sqX = sqrt(X);
  const double root = sqrt(1.0 + 0.0902 * sqX);
  const double rm1 = root - 1.0;
  const double b = (0.0902 / 2) * sqX / (rm1 * root);
  const double a = (9.06 * 9.06 / 4) * (rm1 * rm1) / pow(X, b);
  double B;  // the base that b raises
  if (SPHERICAL) {  // eq 3.1
    B = rdiv_s(4.0 / 3 * rho_w, rhoa);
  } else {  // aspect ratio eq 3.4, lambda_half 2.35 mm
    const double e = exp(div_s(-r, 2.35e-3));
    const double ksi = e + (1.0 - e) / (1.0 + div_s(r, 2.35e-3));
    B = 2.546479 * (ksi * (pi / 6.0 * rho_w)) / rhoa;
  }
  const double Av = a * pow(eta / rhoa * 1e4, 1.0 - 2.0 * b)
                    * pow(B * grav * 1e2, b);
  return static_cast<float>(div_s(Av * pow(2e2 * r, 3.0 * b - 1.0), 1e2));
}

// rw2 at which a masked lane evaluates what a droplet of rw2 <= 0 would
// take (and then discards): 1 um^2, so that no lane takes the IEEE
// division's slow path (kernel G's growth rate) or carries Khvorostyanov's
// 0 / 0 through its powers
constexpr float kMaskedRw2 = 1e-12f;

// lgrngn/vterm.py vt_in_kernel: the formula VT of a droplet of rw2 in a
// cell; beard77 and beard77fast both by the direct polynomial, as on the
// TPU (pallas_coal.py _vt_in_kernel)
template <int VT>
__device__ __forceinline__ float vt_formula(float rw2, const Ambient& a) {
  if (VT == kVtBeard77 || VT == kVtBeard77fast)
    return vt_beard77(rw2, a.p, a.rhoa, a.eta);
  if (VT == kVtUndefined) return 0.0f;
  const bool live = rw2 > 0.0f;
  const float r = sqrtf(fmaxf(live ? rw2 : kMaskedRw2, 1e-30f));
  float v;
  if (VT == kVtBeard76)
    v = vt_beard76(r, a);
  else
    v = vt_khvorostyanov<VT == kVtKhvorostyanovSpherical>(r, a);
  return live ? v : 0.0f;
}

// Whether formula VT reads the cell's temperature
template <int VT>
__host__ __device__ constexpr bool vt_reads_T() {
  return VT == kVtBeard76;
}

template <int VT>
using VtConst = std::integral_constant<int, VT>;

// fn(VtConst<VT>()) for the formula ``vt`` (a vt_t value; beard77fast
// runs as beard77), or cudaErrorInvalidValue for any other number: the
// one place a kernel's entry point picks its instantiation
template <class Fn>
int with_vt(int vt, Fn&& fn) {
  switch (vt) {
    case kVtUndefined: return fn(VtConst<kVtUndefined>());
    case kVtBeard76: return fn(VtConst<kVtBeard76>());
    case kVtBeard77:
    case kVtBeard77fast: return fn(VtConst<kVtBeard77>());
    case kVtKhvorostyanovSpherical:
      return fn(VtConst<kVtKhvorostyanovSpherical>());
    case kVtKhvorostyanovNonspherical:
      return fn(VtConst<kVtKhvorostyanovNonspherical>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The collision kernel of kernel E: lgrngn/coalescence.py kernel_value for
// golovin, geometric, long, the hall family and vohl.  ``coef`` is
// golovin's pi * 4/3 * b, or geometric's multiplier (1 without
// kernel_parameters).
struct CollisionKernel {
  int kern;         // kernel_t value
  float coef;
  const float* eff;  // the clamped efficiency table (hall family, vohl)
  float r_max_m1;    // the table's largest radius [um] - 1e-6
  int clamp;         // the table's saturation index
};
// How a table's rows lie (a template parameter of the lookups and of
// kernel E): the hall family's clamped table is 128 wide (its saturation
// index is 120); a wider one (vohl's, index 150) is clamp + 2 wide
// (coalescence.py clamped_efficiency_table), its row stride read from
// ``clamp``.
constexpr int kTableNarrow = 128, kTableWide = 0;
constexpr int kGeometric = 1, kGolovin = 2, kLong = 5;

// coalescence.py _kernel_index
__device__ __forceinline__ int eff_index(float r_um) {
  return static_cast<int>(r_um <= 100.0f
                              ? r_um
                              : 100.0f + div_s(r_um - 100.0f, 10.0));
}

struct EffNode {
  int i0, i1;
  float w_hi, w_lo, d;
};

// coalescence.py interpolated_efficiency prep, indices clamped
__device__ __forceinline__ EffNode eff_node(float r_m,
                                            const CollisionKernel& k) {
  EffNode e;
  const float r = fminf(r_m * 1e6f, k.r_max_m1);
  const bool big = r >= 100.0f;
  const float x0 = big ? floorf(div_s(r, 10.0)) * 10.0f : floorf(r);
  e.d = big ? 10.0f : 1.0f;
  e.i0 = min(eff_index(x0), k.clamp);
  e.i1 = min(eff_index(x0 + e.d), k.clamp);
  e.w_hi = r - x0;
  e.w_lo = x0 + e.d - r;
  return e;
}

// coalescence.py interpolated_efficiency: four corners read through the
// read-only cache, combined in the plain version's order
template <int TW>
__device__ __forceinline__ float efficiency(const CollisionKernel& k,
                                            float rw_a, float rw_b) {
  const int w = TW == kTableWide ? k.clamp + 2 : TW;
  const EffNode a = eff_node(rw_a, k), b = eff_node(rw_b, k);
  const float t00 = __ldg(k.eff + a.i0 * w + b.i0);
  const float t10 = __ldg(k.eff + a.i1 * w + b.i0);
  const float t01 = __ldg(k.eff + a.i0 * w + b.i1);
  const float t11 = __ldg(k.eff + a.i1 * w + b.i1);
  return (t00 * a.w_lo * b.w_lo + t10 * a.w_hi * b.w_lo
          + t01 * a.w_lo * b.w_hi + t11 * a.w_hi * b.w_hi) / a.d / b.d;
}

// coalescence.py kernel_value
template <int TW>
__device__ __forceinline__ float kernel_value(const CollisionKernel& k,
                                              float n_a, float n_b,
                                              float rw2_a, float rw2_b,
                                              float vt_a, float vt_b) {
  const float n_max = fmaxf(n_a, n_b);
  if (k.kern == kGolovin)
    return k.coef * n_max * (rw2_a * sqrtf(rw2_a) + rw2_b * sqrtf(rw2_b));
  const float rw_a = sqrtf(rw2_a), rw_b = sqrtf(rw2_b);
  const float geo = F(pi) * n_max * fabsf(vt_a - vt_b)
                    * (rw2_a + rw2_b + 2.0f * rw_a * rw_b);
  if (k.kern == kGeometric) return geo * k.coef;
  if (k.kern == kLong) {
    const float r_L = fmaxf(rw_a, rw_b), r_s = fminf(rw_a, rw_b);
    const float eff = r_s <= F(3e-6) ? 0.0f
                      : F(4.5e8) * r_L * r_L * (1.0f - rdiv_s(3e-6, r_s));
    return r_L < F(50e-6) ? geo * eff : geo;
  }
  return geo * efficiency<TW>(k, rw_a, rw_b);
}

struct Drop {
  float n, rw2, rd3, kpa, vt;
};

struct Collision {
  bool happened;
  float n_big_new, rw2_small_new, rd3_small_new, kpa_small_new;
};

// lgrngn/coalescence.py shima for one pair (a, b), in two halves so that a
// caller can skip the second where no pair of its warp collides.  The
// first: the pair's collision count before the multiplicity cap, and
// whether it asked for more than one (``overflow``); ``u`` the pair's
// draw, ``dt_dv`` dt / dv, ``scale`` the Shima scale factor.
template <int TW>
__device__ __forceinline__ float collision_count(const CollisionKernel& k,
                                                 const Drop& a, const Drop& b,
                                                 float u, float dt_dv,
                                                 float scale,
                                                 bool& overflow) {
  const float K = kernel_value<TW>(k, a.n, b.n, a.rw2, b.rw2, a.vt, b.vt);
  const float prob = dt_dv * scale * K;
  const float col_no = floorf(prob);
  overflow = col_no >= 1.0f;
  return col_no + (u < prob - col_no ? 1.0f : 0.0f);
}

// The second half, for a pair whose count is above 0: the outcome of
// ``col_no`` capped by the multiplicities; ``a_big`` whether a has the
// larger multiplicity.
__device__ __forceinline__ Collision collide(const Drop& a, const Drop& b,
                                            bool a_big, float col_no) {
  Collision s;
  // by value: a reference chosen at run time would put a and b on the stack
  const Drop big = a_big ? a : b;
  const Drop small = a_big ? b : a;
  const float ratio =
      small.n > 0.0f ? floorf(big.n / fmaxf(small.n, 1.0f)) : 0.0f;
  col_no = fminf(col_no, ratio);
  s.happened = col_no > 0.0f;
  s.n_big_new = big.n - col_no * small.n;
  const float rw3 =
      col_no * big.rw2 * sqrtf(big.rw2) + small.rw2 * sqrtf(small.rw2);
  // coalescence.py _cbrt: the exp/log cube root of the plain version
  const float r = expf(div_s(logf(fmaxf(rw3, F(1e-38))), 3.0));
  s.rw2_small_new = r * r;
  s.rd3_small_new = col_no * big.rd3 + small.rd3;
  s.kpa_small_new =
      s.rd3_small_new > 0.0f
          ? (col_no * big.kpa * big.rd3 + small.kpa * small.rd3)
                / s.rd3_small_new
          : small.kpa;
  return s;
}

}  // namespace lcp
