// Kernel D's exact-mode form: the re-binning merge carrying eleven planes,
// the seven of merge.cu and each droplet's private ambient th, rv, rhod and
// p (lgrngn/dense.py EXACT_ATTRS), so that a droplet that changes rows keeps
// its old cell's snapshot.
//
// Replaces the same TPU code as merge.cu (libcloudphxx_tpu/ops/
// pallas_step.py:_xmerge_kernel and the z-merge epilogue of _kernel) where
// the JAX package's exact mode re-bins the four planes with the seven
// (lgrngn/dense.py:1088-1180, rebin over attrs_of).  Plain version:
// ops/step.py rebin_x_plain with ``extra``.
//
// The design is merge.cu's, over merge.cuh's row code with the plane count
// 11: what bounds it is memory, the taken droplets' planes read once and
// every plane written in full.

#include <cuda_runtime.h>

#include "merge.cuh"

namespace lcp {

constexpr int kExactPlanes = 11;  // n rw2 rd3 kpa vt x z sd_th sd_rv sd_rh sd_p

template <bool VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
merge_exact_kernel(
    const float* __restrict__ n, const float* __restrict__ rw2,
    const float* __restrict__ rd3, const float* __restrict__ kpa,
    const float* __restrict__ vt, const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ sd_th,
    const float* __restrict__ sd_rv, const float* __restrict__ sd_rh,
    const float* __restrict__ sd_p, const int* __restrict__ tgt,
    float* __restrict__ n_out, float* __restrict__ rw2_out,
    float* __restrict__ rd3_out, float* __restrict__ kpa_out,
    float* __restrict__ vt_out, float* __restrict__ x_out,
    float* __restrict__ z_out, float* __restrict__ sd_th_out,
    float* __restrict__ sd_rv_out, float* __restrict__ sd_rh_out,
    float* __restrict__ sd_p_out, float* __restrict__ drops, int n_cell,
    int cap, int nx, int nz) {
  const float* const in[kExactPlanes] = {n, rw2, rd3, kpa, vt, x, z,
                                         sd_th, sd_rv, sd_rh, sd_p};
  float* const out[kExactPlanes] = {n_out, rw2_out, rd3_out, kpa_out,
                                    vt_out, x_out, z_out, sd_th_out,
                                    sd_rv_out, sd_rh_out, sd_p_out};
  merge_rows<kExactPlanes, VEC, Grid2>(in, out, tgt, drops, n_cell, cap, nx,
                                         nz);
}

}  // namespace lcp

// lcp_merge (merge.cu) with the four private ambient planes after the
// seven, in and out
extern "C" int lcp_merge_exact(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const float* x, const float* z, const float* sd_th,
    const float* sd_rv, const float* sd_rh, const float* sd_p,
    const int* tgt, float* n_out, float* rw2_out, float* rd3_out,
    float* kpa_out, float* vt_out, float* x_out, float* z_out,
    float* sd_th_out, float* sd_rv_out, float* sd_rh_out, float* sd_p_out,
    float* drops, int n_cell, int cap, int nx, int nz, cudaStream_t stream) {
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, rd3, kpa, vt, x, z, sd_th, sd_rv, sd_rh, sd_p, tgt,
            n_out, rw2_out, rd3_out, kpa_out, vt_out, x_out, z_out,
            sd_th_out, sd_rv_out, sd_rh_out, sd_p_out});
  const dim3 grid(lcp::row_blocks(n_cell)), block(lcp::kWarpRows * 32);
  auto kernel = vec ? lcp::merge_exact_kernel<true>
                    : lcp::merge_exact_kernel<false>;
  kernel<<<grid, block, 0, stream>>>(
      n, rw2, rd3, kpa, vt, x, z, sd_th, sd_rv, sd_rh, sd_p, tgt, n_out,
      rw2_out, rd3_out, kpa_out, vt_out, x_out, z_out, sd_th_out, sd_rv_out,
      sd_rh_out, sd_p_out, drops, n_cell, cap, nx, nz);
  return static_cast<int>(cudaGetLastError());
}
