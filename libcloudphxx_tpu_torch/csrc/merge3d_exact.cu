// Kernel D's 3-D exact-mode form: merge3d.cu's merge carrying twelve
// planes, the eight of merge3d.cu and each droplet's private ambient th,
// rv, rhod and p (lgrngn/dense.py EXACT_ATTRS), so that a droplet that
// changes rows keeps its old cell's snapshot.  The design: merge3d.cuh.
//
// Replaces the same re-binning as merge3d.cu (libcloudphxx_tpu/lgrngn/
// dense.py:1095-1180, rebin over attrs_of) in the JAX package's exact mode
// on the 3-D grid.  Plain version: ops/step.py rebin_x_plain with the y
// plane and the four private planes in ``extra``.

#include <cuda_runtime.h>

#include "merge3d.cuh"

namespace lcp {

// n rw2 rd3 kpa vt x z y sd_th sd_rv sd_rh sd_p
constexpr int kExactPlanes3 = 12;

template <bool VEC>
__global__ void __launch_bounds__(kMaxBrick * 32, 2)
merge3d_exact_brick_kernel(
    const float* __restrict__ n, const float* __restrict__ rw2,
    const float* __restrict__ rd3, const float* __restrict__ kpa,
    const float* __restrict__ vt, const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ y,
    const float* __restrict__ sd_th, const float* __restrict__ sd_rv,
    const float* __restrict__ sd_rh, const float* __restrict__ sd_p,
    const int* __restrict__ tgt, float* __restrict__ n_out,
    float* __restrict__ rw2_out, float* __restrict__ rd3_out,
    float* __restrict__ kpa_out, float* __restrict__ vt_out,
    float* __restrict__ x_out, float* __restrict__ z_out,
    float* __restrict__ y_out, float* __restrict__ sd_th_out,
    float* __restrict__ sd_rv_out, float* __restrict__ sd_rh_out,
    float* __restrict__ sd_p_out, float* __restrict__ drops, int cap,
    int nx, int ny, int nz, int brick, int bricks) {
  const float* const in[kExactPlanes3] = {n,     rw2,   rd3,   kpa,
                                          vt,    x,     z,     y,
                                          sd_th, sd_rv, sd_rh, sd_p};
  float* const out[kExactPlanes3] = {n_out,     rw2_out,   rd3_out,
                                     kpa_out,   vt_out,    x_out,
                                     z_out,     y_out,     sd_th_out,
                                     sd_rv_out, sd_rh_out, sd_p_out};
  merge_brick<kExactPlanes3, VEC>(in, out, tgt, drops, cap, nx, ny, nz,
                                  brick, bricks);
}

}  // namespace lcp

// lcp_merge_3d with the four private ambient planes after the eight, in
// and out
extern "C" int lcp_merge_3d_exact(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const float* x, const float* z, const float* y,
    const float* sd_th, const float* sd_rv, const float* sd_rh,
    const float* sd_p, const int* tgt, float* n_out, float* rw2_out,
    float* rd3_out, float* kpa_out, float* vt_out, float* x_out,
    float* z_out, float* y_out, float* sd_th_out, float* sd_rv_out,
    float* sd_rh_out, float* sd_p_out, float* drops, int n_cell, int cap,
    int nx, int ny, int nz, int brick, cudaStream_t stream) {
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, rd3, kpa, vt, x, z, y, sd_th, sd_rv, sd_rh, sd_p, tgt,
            n_out, rw2_out, rd3_out, kpa_out, vt_out, x_out, z_out, y_out,
            sd_th_out, sd_rv_out, sd_rh_out, sd_p_out});
  auto kernel = vec ? lcp::merge3d_exact_brick_kernel<true>
                    : lcp::merge3d_exact_brick_kernel<false>;
  return lcp::launch_brick(
      kernel, n_cell, cap, nx, ny, nz, brick, stream, n, rw2, rd3, kpa, vt,
      x, z, y, sd_th, sd_rv, sd_rh, sd_p, tgt, n_out, rw2_out, rd3_out,
      kpa_out, vt_out, x_out, z_out, y_out, sd_th_out, sd_rv_out, sd_rh_out,
      sd_p_out, drops);
}

// lcp_merge_3d_attrs for the twelve-plane form
extern "C" int lcp_merge_3d_exact_attrs(int vec, int brick, int cap,
                                        int* out) {
  return lcp::brick_attrs(vec ? lcp::merge3d_exact_brick_kernel<true>
                              : lcp::merge3d_exact_brick_kernel<false>,
                          brick, cap, out);
}
