// Kernel D: the re-binning merge, z and x in one pass.
//
// Replaces the merge half of the re-binning epilogue of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 405-503: z movers
// through cap/2 windows, stable partitions) and the x pass
// libcloudphxx_tpu/ops/pallas_step.py:_xmerge_kernel (lines 716-757).
// Plain version: ops/step.py rebin_x_plain.
//
// Every droplet already carries its target row (kernel C).  Destination
// row r takes the droplets of its own row and of its eight neighbours
// (x-periodic) whose target is r, in MERGE_SOURCES order and slot order
// within each source, packed from lane 0; the lanes past the last droplet
// are zero in every plane, and the droplets that do not fit are counted
// per row (no atomics).  The TPU kernel needed the z pass, the x pass and
// cap/2 mover windows because its blocks ran in order on one core; here
// the kernel boundary after kernel C is the grid-wide barrier, so any
// number of movers fits and nothing is held back.
//
// What bounds it on the card: memory.  The targets of the nine source rows
// are read for every slot, the seven planes of each taken droplet once, and
// the seven planes are written in full.  A row's work is short, so the time
// goes to how many dependent memory round trips a row makes.
// What the design does about it: a warp a destination row in the layout of
// warp_rows.cuh (four consecutive slots a lane, 16-byte loads and stores
// at capacities that are multiples of 128), no __syncthreads() and no
// shared memory.  A warp issues the target loads of nine (source, tile)
// units before its first ballot: at capacity 128 that is every source at
// once, one round trip instead of nine.  Positions stay stable without a
// barrier: four ballots, one per slot of a lane, give each lane the number
// of taken slots in the lanes below it and the unit's total, so a taken
// slot lands at count + before + its rank in the lane, the plain version's
// order.  The planes are read only for the slots taken, and a lane whose
// four slots are all taken to a 16-byte aligned position (most of a row's
// own droplets) stores them as 16 bytes a plane.
//
// The row code is merge.cuh's merge_rows; merge_exact.cu is the exact
// mode's form, with four more planes.

#include <cuda_runtime.h>

#include "merge.cuh"

namespace lcp {

constexpr int kPlanes = 7;  // n rw2 rd3 kpa vt x z

template <bool VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
merge_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
             const float* __restrict__ rd3, const float* __restrict__ kpa,
             const float* __restrict__ vt, const float* __restrict__ x,
             const float* __restrict__ z, const int* __restrict__ tgt,
             float* __restrict__ n_out, float* __restrict__ rw2_out,
             float* __restrict__ rd3_out, float* __restrict__ kpa_out,
             float* __restrict__ vt_out, float* __restrict__ x_out,
             float* __restrict__ z_out, float* __restrict__ drops,
             int n_cell, int cap, int nx, int nz) {
  // the planes as kernel parameters marked __restrict__, not a struct of
  // pointers: the compiler may then move a unit's plane loads ahead of the
  // previous unit's stores
  const float* const in[kPlanes] = {n, rw2, rd3, kpa, vt, x, z};
  float* const out[kPlanes] = {n_out, rw2_out, rd3_out, kpa_out, vt_out,
                               x_out, z_out};
  merge_rows<kPlanes, VEC, Grid2>(in, out, tgt, drops, n_cell, cap, nx, nz);
}

}  // namespace lcp

extern "C" int lcp_merge(const float* n, const float* rw2, const float* rd3,
                         const float* kpa, const float* vt, const float* x,
                         const float* z, const int* tgt, float* n_out,
                         float* rw2_out, float* rd3_out, float* kpa_out,
                         float* vt_out, float* x_out, float* z_out,
                         float* drops, int n_cell, int cap, int nx, int nz,
                         cudaStream_t stream) {
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, rd3, kpa, vt, x, z, tgt, n_out, rw2_out, rd3_out, kpa_out,
            vt_out, x_out, z_out});
  const dim3 grid(lcp::row_blocks(n_cell)), block(lcp::kWarpRows * 32);
  auto kernel = vec ? lcp::merge_kernel<true> : lcp::merge_kernel<false>;
  kernel<<<grid, block, 0, stream>>>(n, rw2, rd3, kpa, vt, x, z, tgt, n_out,
                                     rw2_out, rd3_out, kpa_out, vt_out, x_out,
                                     z_out, drops, n_cell, cap, nx, nz);
  return static_cast<int>(cudaGetLastError());
}
