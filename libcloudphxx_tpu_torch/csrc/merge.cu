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

#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace lcp {

constexpr int kPlanes = 7;  // n rw2 rd3 kpa vt x z
constexpr int kGroup = 9;   // (source, tile) units whose loads go first

// MERGE_SOURCES (ops/step.py), the source rows of the merge in order: own
// row, the z neighbours, then the columns to the left and to the right
// (each: same level, below, above)
__device__ __forceinline__ int source_di(int s) {
  return s < 3 ? 0 : (s < 6 ? -1 : 1);
}
__device__ __forceinline__ int source_dk(int s) {
  const int m = s % 3;
  return m == 0 ? 0 : (m == 1 ? -1 : 1);
}
// row i * nz + k's neighbour MERGE_SOURCES[s] (x-periodic), or -2 beyond
// the z walls
__device__ __forceinline__ int neighbour(int i, int k, int s, int nx,
                                         int nz) {
  const int ks = k + source_dk(s);
  return ks < 0 || ks >= nz ? -2 : ((i + source_di(s) + nx) % nx) * nz + ks;
}

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
  const float* in[kPlanes] = {n, rw2, rd3, kpa, vt, x, z};
  float* out[kPlanes] = {n_out, rw2_out, rd3_out, kpa_out, vt_out, x_out,
                         z_out};
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= n_cell) return;  // the whole warp
  const int i = r / nz, k = r % nz;
  const unsigned below = (1u << lane) - 1u;
  const int tiles = (cap + kTile - 1) / kTile;
  const size_t dst = static_cast<size_t>(r) * cap;
  int count = 0;  // droplets taken so far, the same on every lane
  // units u = source * tiles + tile, kGroup at a time (9 * tiles in all)
  for (int u0 = 0; u0 < 9 * tiles; u0 += kGroup) {
    unsigned take[kGroup];  // bit q: slot lo + q goes to row r
    size_t src[kGroup];
    int lo[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int u = u0 + g;
      const int row = neighbour(i, k, u / tiles, nx, nz);
      lo[g] = (u % tiles) * kTile + 4 * lane;
      take[g] = 0u;
      src[g] = 0;
      if (row < 0 || lo[g] >= cap) continue;
      src[g] = static_cast<size_t>(row) * cap + lo[g];
      int t[4];
      load4<VEC>(tgt, src[g], lo[g], cap, -1, t);
#pragma unroll
      for (int q = 0; q < 4; ++q) take[g] |= (t[q] == r ? 1u : 0u) << q;
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      int before = 0, total = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned b = __ballot_sync(kAll, (take[g] >> q) & 1u);
        before += __popc(b & below);
        total += __popc(b);
      }
      if (take[g]) {
        float v[kPlanes][4];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          if constexpr (VEC) {
            load4<true>(in[p], src[g], lo[g], cap, 0.0f, v[p]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v[p][q] = (take[g] >> q) & 1u ? __ldg(in[p] + src[g] + q)
                                            : 0.0f;
          }
        }
        int pos = count + before;
        if (VEC && take[g] == 0xfu && pos % 4 == 0 && pos + 4 <= cap) {
#pragma unroll
          for (int p = 0; p < kPlanes; ++p)
            store4<VEC>(out[p], dst + pos, pos, cap, v[p]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if ((take[g] >> q) & 1u) {
              if (pos < cap) {
#pragma unroll
                for (int p = 0; p < kPlanes; ++p) out[p][dst + pos] = v[p][q];
              }
              ++pos;
            }
          }
        }
      }
      count += total;
    }
  }
  // the lanes past the last droplet
  for (int l0 = 4 * lane; l0 < cap; l0 += kTile) {
    if (VEC && l0 >= count) {  // all four slots of the lane
      const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
        store4<VEC>(out[p], dst + l0, l0, cap, zero);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = l0 + q;
        if (l < cap && l >= count) {
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) out[p][dst + l] = 0.0f;
        }
      }
    }
  }
  if (lane == 0) drops[r] = count > cap ? float(count - cap) : 0.0f;
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
