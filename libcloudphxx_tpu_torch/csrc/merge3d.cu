// Kernel D's 3-D form: the re-binning merge on the 3-D grid, each row
// taking its droplets from itself and its 26 neighbours in one pass, the
// eight planes n rw2 rd3 kpa vt x z y.  The design, what it replaces and
// what bounds it: merge3d.cuh (a brick of destination rows a block, the
// targets staged in shared memory); merge3d_exact.cu is the exact mode's
// form, with four more planes.  Plain version: ops/step.py rebin_x_plain
// on the 3-D grid.

#include <cuda_runtime.h>

#include "merge3d.cuh"

namespace lcp {

constexpr int kPlanes3 = 8;  // n rw2 rd3 kpa vt x z y

template <bool VEC>
__global__ void __launch_bounds__(kMaxBrick * 32, 2)
merge3d_brick_kernel(
    const float* __restrict__ n, const float* __restrict__ rw2,
    const float* __restrict__ rd3, const float* __restrict__ kpa,
    const float* __restrict__ vt, const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ y,
    const int* __restrict__ tgt, float* __restrict__ n_out,
    float* __restrict__ rw2_out, float* __restrict__ rd3_out,
    float* __restrict__ kpa_out, float* __restrict__ vt_out,
    float* __restrict__ x_out, float* __restrict__ z_out,
    float* __restrict__ y_out, float* __restrict__ drops, int cap, int nx,
    int ny, int nz, int brick, int bricks) {
  const float* const in[kPlanes3] = {n, rw2, rd3, kpa, vt, x, z, y};
  float* const out[kPlanes3] = {n_out, rw2_out, rd3_out, kpa_out, vt_out,
                                x_out, z_out, y_out};
  merge_brick<kPlanes3, VEC>(in, out, tgt, drops, cap, nx, ny, nz, brick,
                             bricks);
}

}  // namespace lcp

// lcp_merge's arguments with the y plane after z, in and out, ny before nz
// and the brick's rows (ops/step.py merge3d_plan) after them; n_cell = nx *
// ny * nz, nx and ny at least 3
extern "C" int lcp_merge_3d(const float* n, const float* rw2,
                            const float* rd3, const float* kpa,
                            const float* vt, const float* x, const float* z,
                            const float* y, const int* tgt, float* n_out,
                            float* rw2_out, float* rd3_out, float* kpa_out,
                            float* vt_out, float* x_out, float* z_out,
                            float* y_out, float* drops, int n_cell, int cap,
                            int nx, int ny, int nz, int brick,
                            cudaStream_t stream) {
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, rd3, kpa, vt, x, z, y, tgt, n_out, rw2_out, rd3_out,
            kpa_out, vt_out, x_out, z_out, y_out});
  auto kernel = vec ? lcp::merge3d_brick_kernel<true>
                    : lcp::merge3d_brick_kernel<false>;
  return lcp::launch_brick(kernel, n_cell, cap, nx, ny, nz, brick, stream,
                           n, rw2, rd3, kpa, vt, x, z, y, tgt, n_out,
                           rw2_out, rd3_out, kpa_out, vt_out, x_out, z_out,
                           y_out, drops);
}

// The form's kernel on the card (lcp::brick_attrs) in its 16-byte (vec 1)
// or scalar-slot layout
extern "C" int lcp_merge_3d_attrs(int vec, int brick, int cap, int* out) {
  return lcp::brick_attrs(vec ? lcp::merge3d_brick_kernel<true>
                              : lcp::merge3d_brick_kernel<false>,
                          brick, cap, out);
}
