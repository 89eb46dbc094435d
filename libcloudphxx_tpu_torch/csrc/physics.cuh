// Device functions shared by the step kernels (cond.cu, cond_flat.cu,
// transport.cu, coal.cu): the per-cell closure, the beard77 terminal
// velocity, the collision kernels and the Shima collision
// (the condensation's per-droplet growth and root find are in
// cond_cell.cuh).  Each follows its plain PyTorch version operation for
// operation:
//   closure        lgrngn/hskpng.py hskpng_Tpr
//   vt_beard77     lgrngn/vterm.py vt_in_kernel
//   kernel_value   lgrngn/coalescence.py kernel_value
//   collision_count, collide   lgrngn/coalescence.py shima
// The library is built with -fmad=false, so no multiply-add is contracted
// that the plain version rounds twice.  Where PyTorch on the card divides a
// tensor by a Python number it multiplies by the float reciprocal, and it
// computes number / tensor as reciprocal(tensor) * number; vt_beard77, which
// feeds the sedimentation and hence the cell classification, copies both so
// that kernel and plain version classify every droplet alike.
#pragma once

#include <cuda_runtime.h>

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
constexpr double rho_w = 1e3;
constexpr double D_0 = 2.26e-5;
constexpr double K_0 = 2.4e-2;
constexpr double p_tri = 611.73;
constexpr double T_tri = 273.16;
constexpr double l_tri = 2.5e6;
constexpr double p_stp = 101325.0;
constexpr double T_stp = 273.15 + 15;
constexpr double rho_stp = p_stp / T_stp / R_d;
constexpr double p_1000 = 100000.0;
constexpr double pi = 3.141592653589793;
constexpr double COND_MLT = 2.0;

#define F(x) static_cast<float>(x)

// a / s for a Python number s, as PyTorch computes it on the card: times
// the reciprocal, taken in double and rounded to float (for s = 5.01 that
// differs from 1.0f / 5.01f)
__device__ __forceinline__ float div_s(float a, double s) {
  return a * F(1.0 / s);
}
// s / a for a Python number s: reciprocal(a) * s
__device__ __forceinline__ float rdiv_s(double s, float a) {
  return (1.0f / a) * F(s);
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

// The collision kernel of kernel E: lgrngn/coalescence.py kernel_value for
// golovin, geometric, long and the hall family.  ``coef`` is golovin's
// pi * 4/3 * b, or geometric's multiplier (1 without kernel_parameters).
struct CollisionKernel {
  int kern;         // kernel_t value
  float coef;
  const float* eff;  // hall family: the clamped 128x128 efficiency table
  float r_max_m1;    // the table's largest radius [um] - 1e-6
  int clamp;         // the table's saturation index
};
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
__device__ __forceinline__ float efficiency(const CollisionKernel& k,
                                            float rw_a, float rw_b) {
  const EffNode a = eff_node(rw_a, k), b = eff_node(rw_b, k);
  const float t00 = __ldg(k.eff + a.i0 * 128 + b.i0);
  const float t10 = __ldg(k.eff + a.i1 * 128 + b.i0);
  const float t01 = __ldg(k.eff + a.i0 * 128 + b.i1);
  const float t11 = __ldg(k.eff + a.i1 * 128 + b.i1);
  return (t00 * a.w_lo * b.w_lo + t10 * a.w_hi * b.w_lo
          + t01 * a.w_lo * b.w_hi + t11 * a.w_hi * b.w_hi) / a.d / b.d;
}

// coalescence.py kernel_value
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
  return geo * efficiency(k, rw_a, rw_b);
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
__device__ __forceinline__ float collision_count(const CollisionKernel& k,
                                                 const Drop& a, const Drop& b,
                                                 float u, float dt_dv,
                                                 float scale,
                                                 bool& overflow) {
  const float K = kernel_value(k, a.n, b.n, a.rw2, b.rw2, a.vt, b.vt);
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
