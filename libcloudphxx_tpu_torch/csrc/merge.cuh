// Kernel D's row code, shared by its forms on the 2-D grid (Grid2):
// merge.cu (the seven planes of the main path), merge_mpdata.cu (the seven
// with the MPDATA epilogue) and merge_exact.cu (eleven, with the exact
// mode's private ambient planes); and kernel B's merge-prologue form
// (cond_merged.cu).  The 3-D forms have a design of their own
// (merge3d.cuh), which takes MERGE_SOURCES' (di, dk) order from here.  Each
// form is a source of its own, so that the main path's kernel compiles as
// it did before the second form existed: in one translation unit the
// second instantiation changes the first one's register allocation and
// SASS.
#pragma once

#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace lcp {

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

// A destination row's source rows on the 2-D grid: the 9 of
// MERGE_SOURCES, the target loads of kGroup (source, tile) units in flight
// at once
struct Grid2 {
  static constexpr int kSources = 9, kGroupUnits = kGroup;
  int i, k, nx, nz;
  __device__ __forceinline__ Grid2(int r, int nx_, int nz_)
      : i(r / nz_), k(r % nz_), nx(nx_), nz(nz_) {}
  __device__ __forceinline__ int source(int s) const {
    return neighbour(i, k, s, nx, nz);
  }
};

// Grid2 with 3 (source, tile) units in flight, not 9: kernel B's
// merge-prologue form (cond.cuh MergePrologue), whose registers are the
// condensation's to spend
struct Grid2Lean : Grid2 {
  static constexpr int kGroupUnits = 3;
  __device__ __forceinline__ Grid2Lean(int r, int nx_, int nz_)
      : Grid2(r, nx_, nz_) {}
};

// Destination row ``r``, taken by the warp, over the NP planes ``in``
// (read) and ``out`` (written), which the kernels fill from their own
// __restrict__ parameters; ``grid`` (Grid2, Grid2Lean) gives r's source
// rows.
// Kernel B's merge-prologue form (cond.cuh MergePrologue) and D's MPDATA
// form (merge_mpdata.cu) call it for the rows they own.
template <int NP, bool VEC, class G>
__device__ __forceinline__ void merge_row(
    const float* const (&in)[NP], float* const (&out)[NP],
    const int* __restrict__ tgt, float* __restrict__ drops, int r, int cap,
    const G& grid) {
  constexpr int kUnits = G::kGroupUnits;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int tiles = (cap + kTile - 1) / kTile;
  const size_t dst = static_cast<size_t>(r) * cap;
  int count = 0;  // droplets taken so far, the same on every lane
  // units u = source * tiles + tile, kUnits at a time (kSources * tiles
  // in all, a multiple of kUnits)
  for (int u0 = 0; u0 < G::kSources * tiles; u0 += kUnits) {
    unsigned take[kUnits];  // bit q: slot lo + q goes to row r
    size_t src[kUnits];
    int lo[kUnits];
#pragma unroll
    for (int g = 0; g < kUnits; ++g) {
      const int u = u0 + g;
      const int row = grid.source(u / tiles);
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
    for (int g = 0; g < kUnits; ++g) {
      int before = 0, total = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned b = __ballot_sync(kAll, (take[g] >> q) & 1u);
        before += __popc(b & below);
        total += __popc(b);
      }
      if (take[g]) {
        float v[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
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
          for (int p = 0; p < NP; ++p)
            store4<VEC>(out[p], dst + pos, pos, cap, v[p]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if ((take[g] >> q) & 1u) {
              if (pos < cap) {
#pragma unroll
                for (int p = 0; p < NP; ++p) out[p][dst + pos] = v[p][q];
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
      for (int p = 0; p < NP; ++p)
        store4<VEC>(out[p], dst + l0, l0, cap, zero);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = l0 + q;
        if (l < cap && l >= count) {
#pragma unroll
          for (int p = 0; p < NP; ++p) out[p][dst + l] = 0.0f;
        }
      }
    }
  }
  if (lane == 0) drops[r] = count > cap ? float(count - cap) : 0.0f;
}

// merge_row for the warp's row in D's own layout: 8 rows a block, a row
// a warp; G made from the row and ``dims``.
template <int NP, bool VEC, class G, class... Dims>
__device__ __forceinline__ void merge_rows(
    const float* const (&in)[NP], float* const (&out)[NP],
    const int* __restrict__ tgt, float* __restrict__ drops, int n_cell,
    int cap, Dims... dims) {
  const int r = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= n_cell) return;  // the whole warp
  merge_row<NP, VEC>(in, out, tgt, drops, r, cap, G(r, dims...));
}

}  // namespace lcp
