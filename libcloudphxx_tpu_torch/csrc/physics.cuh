// Device functions shared by the step kernels (cond.cu, transport.cu): the
// per-cell closure, the beard77 terminal velocity, drw2_dt and the
// per-droplet backward-Euler root find.  Each follows its plain PyTorch
// version operation for operation:
//   closure        lgrngn/hskpng.py hskpng_Tpr
//   vt_beard77     lgrngn/vterm.py vt_in_kernel
//   drw2_dt        lgrngn/condensation.py drw2_dt
//   advance_rw2    lgrngn/condensation.py _advance_rw2_core
//   solve_bracketed ops/rootfind.py solve_bracketed
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

// Per-droplet inputs of the growth rate that stay fixed over a substep.
struct Growth {
  float rd3, kpa, vt;            // droplet
  float rhod, rv, T, p, RH, eta;  // cell
  float lam_D, lam_K, RH_max;
};

// lgrngn/condensation.py drw2_dt
__device__ __forceinline__ float fs_beta(float Kn) {
  return (1.0f + Kn) / (1.0f + F(1.71) * Kn + F(1.33) * Kn * Kn);
}

__device__ __forceinline__ float nusselt(float Pr, float Re) {
  float cb = expf(div_s(logf(1.0f + Re * Pr), 3.0));
  float pw = expf(logf(Re) * F(0.077));
  return 1.0f + cb * fmaxf(pw, 1.0f);
}

__device__ __forceinline__ float drw2_dt(float rw2, const Growth& g) {
  float rw = sqrtf(rw2);
  float rw3 = rw2 * rw;
  float Re = g.vt * (2.0f * rw) * g.rhod / g.eta;
  float Sc = div_s(g.eta / g.rhod, D_0);
  float Pr = div_s(F(c_pd) * g.eta, K_0);
  float D = F(D_0) * fs_beta(g.lam_D / rw) * (nusselt(Sc, Re) * 0.5f);
  float K = F(K_0) * fs_beta(g.lam_K / rw) * (nusselt(Pr, Re) * 0.5f);
  float RH = fminf(g.RH, g.RH_max);
  float a_w = (rw3 - g.rd3) / (rw3 - g.rd3 * (1.0f - g.kpa));
  float sg = F(0.07275) * (1.0f - F(0.002) * (g.T - 291.0f));
  float A = div_s(div_s(2.0f * sg, R_v) / g.T, rho_w);
  float klv = expf(A / rw);
  float l_v = F(c_pv - c_pw) * (g.T - F(T_tri)) + F(l_tri);
  float rho_v = g.rhod * g.rv;
  float num = div_s(1.0f - a_w * klv / RH, rho_w);
  float den = rdiv_s(1.0, D) / rho_v
              + l_v / K / RH / g.T * (div_s(l_v, R_v) / g.T - 1.0f);
  return 2.0f * (num / den);
}

__device__ __forceinline__ float minfun(float x, float rw2_safe, float dt,
                                        const Growth& g) {
  return rw2_safe + dt * drw2_dt(x, g) - x;
}

// ops/rootfind.py solve_bracketed: fixed-iteration Anderson-Bjoerck
__device__ inline float solve_bracketed(float a, float b, float rw2_safe, float dt,
                                 const Growth& g, int iters) {
  float fa = minfun(a, rw2_safe, dt, g);
  float fb = minfun(b, rw2_safe, dt, g);
  for (int it = 0; it < iters; ++it) {
    float denom = fb - fa;
    float mid = 0.5f * (a + b);
    float sec = denom != 0.0f ? (a * fb - b * fa) / denom : mid;
    float lo = fminf(a, b), hi = fmaxf(a, b);
    float x = (sec > lo && sec < hi) ? sec : mid;
    float fx = minfun(x, rw2_safe, dt, g);
    bool left = fa * fx <= 0.0f;
    float m_l = 1.0f - fx / (fb == 0.0f ? 1.0f : fb);
    float m_r = 1.0f - fx / (fa == 0.0f ? 1.0f : fa);
    m_l = m_l > 0.0f ? m_l : 0.5f;
    m_r = m_r > 0.0f ? m_r : 0.5f;
    float na = left ? a : x;
    float nfa = left ? fa * m_l : fx;
    float nb = left ? x : b;
    float nfb = left ? fx : fb * m_r;
    a = fx == 0.0f ? x : na;
    b = fx == 0.0f ? x : nb;
    fa = nfa;
    fb = nfb;
  }
  return fabsf(fa) < fabsf(fb) ? a : b;
}

// lgrngn/condensation.py _advance_rw2_core for one droplet.  The plain
// version runs the root find on every element and selects; here it runs
// only where the bracket holds, which selects the same value.
__device__ inline float advance_rw2(float dt, float rw2_old, const Growth& g,
                             int iters) {
  bool alive = rw2_old > 0.0f;
  float rw2_safe = alive ? rw2_old : powf(g.rd3, F(2.0 / 3));
  float drw2 = dt * drw2_dt(rw2_safe, g);
  float rd = expf(div_s(logf(g.rd3), 3.0));
  float rd2 = rd * rd;
  if (!(alive && drw2 != 0.0f)) return rw2_old;
  float a = fmaxf(rd2, rw2_safe + fminf(F(COND_MLT) * drw2, 0.0f));
  float b = rw2_safe + fmaxf(F(COND_MLT) * drw2, 0.0f);
  float fa = drw2 > 0.0f ? drw2 : minfun(a, rw2_safe, dt, g);
  float fb = drw2 > 0.0f ? minfun(b, rw2_safe, dt, g) : drw2;
  bool bracketed = (fa * fb <= 0.0f) && (a < b);
  float rw2_new = bracketed ? solve_bracketed(a, b, rw2_safe, dt, g, iters)
                            : rw2_safe + drw2;
  return fmaxf(rw2_new, rd2);
}

// Sum over the block, the same on every thread; a fixed shuffle tree and a
// fixed order over the warps, so the result repeats run to run.
// ``scratch`` holds one value per warp plus one.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read from a previous call
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = 0;
    for (int w = 0; w < nwarp; ++w) s += scratch[w];
    scratch[nwarp] = s;
  }
  __syncthreads();
  return scratch[nwarp];
}

}  // namespace lcp
