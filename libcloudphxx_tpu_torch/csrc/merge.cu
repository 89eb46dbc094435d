// Kernel D: the re-binning merge, z and x in one pass.
//
// Replaces the merge half of the re-binning epilogue of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 405-503: z movers
// through cap/2 windows, stable partitions) and the x pass
// libcloudphxx_tpu/ops/pallas_step.py:_xmerge_kernel (lines 716-757).
// Plain version: ops/step.py rebin_x_plain.
//
// Every droplet already carries its target row (kernel C).  Destination
// row r takes, in a fixed order, the droplets of its own row and of its
// eight neighbours (x-periodic) whose target is r, packed alive-first.
// What bounds it on the card: memory.  A block reads the target plane of
// nine rows and moves each droplet's seven attributes once.
// What the design does about it: one block per destination row, one
// thread per lane; compaction is a warp ballot and popcount prefix plus a
// scan over the warp totals, which keeps lane order stable at any row
// width.  The TPU kernel needed the z pass, the x pass and cap/2 mover
// windows because its blocks ran in order on one core; here the kernel
// boundary after kernel C is the grid-wide barrier, so any number of
// movers fits and nothing is held back.  Droplets that do not fit the row
// are counted per row (no atomics); lanes past the last droplet are zeroed.

#include <cuda_runtime.h>

namespace lcp {

constexpr int kPlanes = 7;  // n rw2 rd3 kpa vt x z

struct Planes {
  const float* in[kPlanes];
  float* out[kPlanes];
};

__global__ void __launch_bounds__(128)
merge_kernel(Planes pl, const int* __restrict__ tgt, float* __restrict__ drops,
             int n_cell, int cap, int nx, int nz) {
  __shared__ int s_warp[128 / 32];
  const int r = blockIdx.x;
  const int i = r / nz, k = r % nz;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  int count = 0;  // droplets taken so far, the same on every thread
  // sources: own row first, then the z neighbours, then the columns to
  // the left and right (each: same level, below, above)
  const int di_of[9] = {0, 0, 0, -1, -1, -1, 1, 1, 1};
  const int dk_of[9] = {0, -1, 1, 0, -1, 1, 0, -1, 1};
  for (int s = 0; s < 9; ++s) {
    const int ks = k + dk_of[s];
    if (ks < 0 || ks >= nz) continue;
    const int is = (i + di_of[s] + nx) % nx;
    const size_t src = static_cast<size_t>(is * nz + ks) * cap;
    for (int l0 = 0; l0 < cap; l0 += blockDim.x) {
      const int l = l0 + threadIdx.x;
      const bool take = l < cap && tgt[src + l] == r;
      const unsigned ballot = __ballot_sync(0xffffffffu, take);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < nwarp; ++w) {
        before += w < warp ? s_warp[w] : 0;
        total += s_warp[w];
      }
      const int pos = count + before + __popc(ballot & ((1u << lane) - 1u));
      if (take && pos < cap) {
        const size_t dst = static_cast<size_t>(r) * cap + pos;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) pl.out[p][dst] = pl.in[p][src + l];
      }
      count += total;
      __syncthreads();  // s_warp is rewritten by the next chunk
    }
  }
  const size_t base = static_cast<size_t>(r) * cap;
  for (int l = count + threadIdx.x; l < cap; l += blockDim.x) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) pl.out[p][base + l] = 0.0f;
  }
  if (threadIdx.x == 0) drops[r] = count > cap ? float(count - cap) : 0.0f;
}

}  // namespace lcp

extern "C" int lcp_merge(const float* n, const float* rw2, const float* rd3,
                         const float* kpa, const float* vt, const float* x,
                         const float* z, const int* tgt, float* n_out,
                         float* rw2_out, float* rd3_out, float* kpa_out,
                         float* vt_out, float* x_out, float* z_out,
                         float* drops, int n_cell, int cap, int nx, int nz,
                         cudaStream_t stream) {
  lcp::Planes pl{{n, rw2, rd3, kpa, vt, x, z},
                 {n_out, rw2_out, rd3_out, kpa_out, vt_out, x_out, z_out}};
  lcp::merge_kernel<<<n_cell, 128, 0, stream>>>(pl, tgt, drops, n_cell, cap,
                                                nx, nz);
  return static_cast<int>(cudaGetLastError());
}
