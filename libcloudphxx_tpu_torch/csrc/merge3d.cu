// Kernel D's 3-D form: the re-binning merge on the 3-D grid, each row
// taking its droplets from itself and its 26 neighbours in one pass, the
// eight planes n rw2 rd3 kpa vt x z y.
//
// Replaces the merge of the re-binning that the JAX package runs in XLA on
// the 3-D grid (libcloudphxx_tpu/lgrngn/dense.py:1095-1144 _rebin_neighbor,
// its z, y and x phases; :1150-1180 rebin), which its TPU kernels
// (libcloudphxx_tpu/ops/pallas_step.py:_kernel's z-merge epilogue and
// :716 _xmerge_kernel) do not run in 3-D.  Plain version: ops/step.py
// rebin_x_plain on the 3-D grid.
//
// The design is merge.cu's, over merge.cuh's row code with Grid3: a warp a
// destination row, the 27 source rows in MERGE_SOURCES_3D order (x and y
// periodic, z bounded), at capacity 128 every source's target loads in
// flight before the first ballot.  What bounds it is memory: the targets
// of 27 rows are read for every slot, the taken droplets' planes once and
// every plane written in full.  A droplet that wraps in y lands here as
// one that wraps in x does, where the JAX package sends it to the global
// re-bin (dense.py:1170-1173); the rows' multisets are the same.

#include <cuda_runtime.h>

#include "merge.cuh"

namespace lcp {

constexpr int kPlanes3 = 8;  // n rw2 rd3 kpa vt x z y

template <bool VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
merge3d_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
               const float* __restrict__ rd3, const float* __restrict__ kpa,
               const float* __restrict__ vt, const float* __restrict__ x,
               const float* __restrict__ z, const float* __restrict__ y,
               const int* __restrict__ tgt, float* __restrict__ n_out,
               float* __restrict__ rw2_out, float* __restrict__ rd3_out,
               float* __restrict__ kpa_out, float* __restrict__ vt_out,
               float* __restrict__ x_out, float* __restrict__ z_out,
               float* __restrict__ y_out, float* __restrict__ drops,
               int n_cell, int cap, int nx, int ny, int nz) {
  const float* const in[kPlanes3] = {n, rw2, rd3, kpa, vt, x, z, y};
  float* const out[kPlanes3] = {n_out, rw2_out, rd3_out, kpa_out, vt_out,
                                x_out, z_out, y_out};
  merge_rows<kPlanes3, VEC, Grid3>(in, out, tgt, drops, n_cell, cap, nx, ny,
                                   nz);
}

}  // namespace lcp

// lcp_merge's arguments with the y plane after z, in and out, and ny
// before nz; n_cell = nx * ny * nz, nx and ny at least 3
extern "C" int lcp_merge_3d(const float* n, const float* rw2,
                            const float* rd3, const float* kpa,
                            const float* vt, const float* x, const float* z,
                            const float* y, const int* tgt, float* n_out,
                            float* rw2_out, float* rd3_out, float* kpa_out,
                            float* vt_out, float* x_out, float* z_out,
                            float* y_out, float* drops, int n_cell, int cap,
                            int nx, int ny, int nz, cudaStream_t stream) {
  if (nx < 3 || ny < 3 || n_cell != nx * ny * nz)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, rd3, kpa, vt, x, z, y, tgt, n_out, rw2_out, rd3_out,
            kpa_out, vt_out, x_out, z_out, y_out});
  const dim3 grid(lcp::row_blocks(n_cell)), block(lcp::kWarpRows * 32);
  auto kernel = vec ? lcp::merge3d_kernel<true> : lcp::merge3d_kernel<false>;
  kernel<<<grid, block, 0, stream>>>(n, rw2, rd3, kpa, vt, x, z, y, tgt,
                                     n_out, rw2_out, rd3_out, kpa_out,
                                     vt_out, x_out, z_out, y_out, drops,
                                     n_cell, cap, nx, ny, nz);
  return static_cast<int>(cudaGetLastError());
}
