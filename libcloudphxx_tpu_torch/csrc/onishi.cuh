// Kernel E's onishi form: the turbulent (onishi) collision kernels at
// dissipation rate 0, as the JAX package's dense engine computes them in
// XLA (libcloudphxx_tpu/lgrngn/dense.py:606, :738; lgrngn/coalescence.py:
// 377-388): the hall table's efficiency times the Wang et al. 2009
// enhancement times sqrt(geometric^2 + nograv^2), nograv (the Onishi
// kernel without gravity) 0 at dissipation rate 0.  Plain version:
// lgrngn/coalescence.py kernel_value with turb = (rhod, eta, 0)
// (wang_enhancement, onishi_nograv).  Included by the sources of kernel
// E's y and onishi forms (coal_y*.cu) only, so that the other sources'
// modules hold no copy of the table.
#pragma once

#include <cuda_runtime.h>

#include "coal.cuh"

namespace lcp {

// Wang et al. 2009 table 1 (reference src/detail/
// wang_collision_enhancement.hpp:11-110; coalescence.py _WANG_*): the
// collector radii R0, the radius ratios, and eta[ratio][eps > 2.5e-2]
// [collector radius], each rounded to float as the plain version's
// float32 tensors hold them
__constant__ float kWangR0[7] = {F(1e-05), F(2e-05), F(3e-05), F(4e-05),
                                 F(5e-05), F(6e-05), F(0.0001)};
__constant__ float kWangRat[11] = {
    F(0.0), F(0.1), F(0.2), F(0.30000000000000004),
    F(0.4), F(0.5), F(0.6000000000000001), F(0.7000000000000001),
    F(0.8), F(0.9), F(1.0)};
__constant__ float kWangEta[11 * 2 * 7] = {
    F(1.74), F(1.74), F(1.773), F(1.49), F(1.207), F(1.207), F(1.0),
    F(4.976), F(4.976), F(3.593), F(2.519), F(1.445), F(1.445), F(1.0),
    F(1.46), F(1.46), F(1.421), F(1.245), F(1.069), F(1.069), F(1.0),
    F(2.984), F(2.984), F(2.181), F(1.691), F(1.201), F(1.201), F(1.0),
    F(1.32), F(1.32), F(1.245), F(1.123), F(1.0), F(1.0), F(1.0),
    F(1.988), F(1.988), F(1.475), F(1.313), F(1.15), F(1.15), F(1.0),
    F(1.25), F(1.25), F(1.148), F(1.087), F(1.025), F(1.025), F(1.0),
    F(1.49), F(1.49), F(1.187), F(1.156), F(1.126), F(1.126), F(1.0),
    F(1.186), F(1.186), F(1.066), F(1.06), F(1.056), F(1.056), F(1.0),
    F(1.249), F(1.249), F(1.088), F(1.09), F(1.092), F(1.092), F(1.0),
    F(1.045), F(1.045), F(1.0), F(1.014), F(1.028), F(1.028), F(1.0),
    F(1.139), F(1.139), F(1.13), F(1.091), F(1.051), F(1.051), F(1.0),
    F(1.07), F(1.07), F(1.03), F(1.038), F(1.046), F(1.046), F(1.0),
    F(1.22), F(1.22), F(1.19), F(1.138), F(1.086), F(1.086), F(1.0),
    F(1.0), F(1.0), F(1.054), F(1.042), F(1.029), F(1.029), F(1.0),
    F(1.325), F(1.325), F(1.267), F(1.165), F(1.063), F(1.063), F(1.0),
    F(1.223), F(1.223), F(1.117), F(1.069), F(1.021), F(1.021), F(1.0),
    F(1.716), F(1.716), F(1.345), F(1.223), F(1.1), F(1.1), F(1.0),
    F(1.57), F(1.57), F(1.244), F(1.166), F(1.088), F(1.088), F(1.0),
    F(3.788), F(3.788), F(1.501), F(1.311), F(1.12), F(1.12), F(1.0),
    F(20.3), F(20.3), F(14.6), F(8.61), F(2.6), F(2.6), F(1.0),
    F(36.52), F(36.52), F(19.16), F(22.8), F(26.0), F(26.0), F(1.0),
};

__device__ __forceinline__ float wang_eta(int rat, int eps, int r0) {
  return kWangEta[(rat * 2 + eps) * 7 + r0];
}

// coalescence.py wang_enhancement: a bilinear lookup in (collector radius,
// radius ratio) by searchsorted(side="right") on both axes, the ratio's
// node clipped to [1, 10], the first R0 column below R0[0], 1 above
// 100 um; in the plain version's order of operations
__device__ __forceinline__ float wang_enhancement(float r1, float r2,
                                                  int n_eps) {
  const float R = fmaxf(r1, r2), r = fminf(r1, r2);
  int n_R0 = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) n_R0 += kWangR0[i] <= R ? 1 : 0;
  // r / clamp(R, min=1e-300): the bound is 0 in float
  const float ratio = r / fmaxf(R, 0.0f);
  int n_rat = 0;
#pragma unroll
  for (int i = 0; i < 11; ++i) n_rat += kWangRat[i] <= ratio ? 1 : 0;
  n_rat = min(max(n_rat, 1), 10);
  const int c = min(max(n_R0, 1), 6);
  const float w0 = R - kWangR0[c - 1];
  const float w1 = kWangR0[c] - R;
  const float w2 = ratio - kWangRat[n_rat - 1];
  const float w3 = kWangRat[n_rat] - ratio;
  const float interp =
      (wang_eta(n_rat - 1, n_eps, c - 1) * w1 * w3
       + wang_eta(n_rat - 1, n_eps, c) * w0 * w3
       + wang_eta(n_rat, n_eps, c - 1) * w1 * w2
       + wang_eta(n_rat, n_eps, c) * w0 * w2)
      / (kWangR0[c] - kWangR0[c - 1])
      / (kWangRat[n_rat] - kWangRat[n_rat - 1]);
  const float out = n_R0 == 0 ? wang_eta(n_rat, n_eps, 0) : interp;
  return R > F(100e-6) ? 1.0f : out;
}

// physics.cuh kernel_value's onishi branch (TW kTableAny): k.coef is
// kernel_parameters[0], Wang's dissipation rate (and Re_lambda, which the
// nograv term at dissipation rate 0 does not read); nograv is 0, so
// sqrt(geo^2 + nograv^2) is sqrt(geo * geo), with the square rounded (for
// haze pairs it underflows, as in the plain version)
template <int TW>
__device__ __forceinline__ float onishi_value(const CollisionKernel& k,
                                              float rw_a, float rw_b,
                                              float geo) {
  const float eff = efficiency<kTableNarrow>(k, rw_a, rw_b);
  const float enh =
      wang_enhancement(rw_a, rw_b, k.coef > F(2.5e-2) ? 1 : 0);
  return eff * enh * sqrtf(geo * geo);
}

}  // namespace lcp
