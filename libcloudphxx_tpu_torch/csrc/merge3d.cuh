// Kernel D's 3-D forms (merge3d.cu: the eight planes n rw2 rd3 kpa vt x z
// y; merge3d_exact.cu: twelve, the exact mode's private ambient planes
// riding): the re-binning merge on the 3-D grid, each row taking its
// droplets from itself and its 26 neighbours in one pass.
//
// Replaces the re-binning that the JAX package runs in XLA on the 3-D grid
// (libcloudphxx_tpu/lgrngn/dense.py:1095-1144 _rebin_neighbor, its z, y
// and x phases; :1150-1180 rebin), which its TPU kernels
// (libcloudphxx_tpu/ops/pallas_step.py:_kernel's z-merge epilogue and :716
// _xmerge_kernel) do not run in 3-D.  Plain version: ops/step.py
// rebin_x_plain on the 3-D grid.
//
// Destination row r takes every droplet whose target is r from the 27
// source rows of MERGE_SOURCES_3D (ops/step.py: (di, dj, dk) with dk
// innermost, each 0, -1, 1; x and y periodic, z bounded), in that order
// and in slot order within each source, packed from slot 0; the slots past
// the last droplet are zero in every plane, and the droplets that do not
// fit are counted a row.  A droplet that wraps in y lands here as one that
// wraps in x does, where the JAX package sends it to the global re-bin
// (dense.py:1170-1173); the rows' multisets are the same.
//
// What bounded the old shape (PR 18: merge.cuh's row code with 27 source
// rows, a warp a destination row, the target loads of all 27 sources in
// registers before the first ballot): 150-174 registers a thread, so one
// block of 8 warps an SM; each row a chain of dependent device-memory
// round trips (the targets, then a gather and its stores for every source
// unit with droplets taken), which 8 warps an SM could not hide; and every
// slot's target read by 27 warps.  It ran at 6.29 ms in the 76^3 step, 14%
// of its bound (0.8727 ms, bytes), against 49% for the 2-D form.
// What this design does about it:
//   - a block owns a brick of B consecutive z-rows of one (i, j) column, a
//     warp a row (B <= kMaxBrick; ops/step.py merge3d_plan picks B from
//     the capacity and nz).  Its source rows are the 3 x 3 neighbouring
//     columns x (B + 2) levels: nine contiguous runs of targets, staged
//     into shared memory once, so a target is read from device memory
//     about (B + 2) / B times, not 27;
//   - a target is staged as a byte, the row of the brick it names (or
//     kNone): every slot a brick row may take is in the brick's column,
//     so the code is the target less the brick's first row, no division.
//     A staged row is cap bytes (a row stride of whole 128-slot tiles),
//     a quarter of the targets' bytes, so a brick of 16 rows at cap 128
//     holds 29 KB: registers, not shared memory, bound the blocks an SM;
//   - the scan runs against shared memory: a lane reads the four codes of
//     its four consecutive slots of a 128-slot tile as one word, one
//     __vcmpeq4 and one ballot tell the warp whether the tile gives the
//     row anything, and only then four ballots place its droplets (a
//     taken slot lands at count + the taken slots of the lanes below +
//     its rank in the lane, the plain version's order).  Nothing of a
//     source is held in registers across sources;
//   - the row's taken slots go to a list in shared memory, then the
//     gather reads them 32 slots a pass, 4 passes' plane loads (2 with
//     twelve planes) issued before their stores: at cap 128 a row waits
//     for one device-memory round trip, not one per source unit.  The
//     loads and stores of consecutive slots are consecutive addresses.
//   - __launch_bounds__(kMaxBrick * 32, 2): at most 64 registers a
//     thread, 32 warps an SM.
// What it measured: PERF.md section 6 (chip_smoke.py phase 22).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "merge.cuh"

namespace lcp {

constexpr int kMaxBrick = 16;        // destination rows (warps) a block
constexpr unsigned kNone = 0xFFu;    // a staged slot no row of the brick takes
constexpr uint32_t kNoSlot = 0xFFFFFFFFu;

// The bytes a staged source row takes: its capacity in whole 128-slot
// tiles, a byte a slot (the slots past the capacity hold kNone)
__host__ __device__ constexpr int brick_stride(int cap) {
  return (cap + kTile - 1) / kTile * kTile;
}

// A brick's dynamic shared memory: the codes of 9 columns x (brick + 2)
// levels, then each row's list of the slots it takes (cap 4-byte global
// slot indices a row)
__host__ __device__ constexpr size_t brick_smem(int brick, int cap) {
  return static_cast<size_t>(9 * (brick + 2)) * brick_stride(cap)
         + static_cast<size_t>(brick) * cap * 4;
}

__device__ __forceinline__ int wrap(int a, int n) {
  return a < 0 ? a + n : (a >= n ? a - n : a);
}

// The first row of column c (0..8: MERGE_SOURCES_3D's (di, dj) in order,
// c = source / 3) around column (i, j), x and y periodic
__device__ __forceinline__ int column_row(int i, int j, int c, int nx,
                                          int ny, int nz) {
  return (wrap(i + source_dk(c / 3), nx) * ny + wrap(j + source_dk(c % 3),
                                                     ny)) * nz;
}

// The brick of block blockIdx.x (``bricks`` bricks a column of nz rows,
// ``brick`` rows each) over the NP planes ``in`` (read) and ``out``
// (written), which the kernels fill from their own __restrict__
// parameters.
template <int NP, bool VEC>
__device__ __forceinline__ void merge_brick(
    const float* const (&in)[NP], float* const (&out)[NP],
    const int* __restrict__ tgt, float* __restrict__ drops, int cap, int nx,
    int ny, int nz, int brick, int bricks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = brick_stride(cap), levels = brick + 2;
  uint32_t* const codes = reinterpret_cast<uint32_t*>(smem);
  uint32_t* const lists =
      reinterpret_cast<uint32_t*>(smem + 9 * levels * stride);
  const int col = blockIdx.x / bricks;
  const int k0 = (blockIdx.x % bricks) * brick;
  const int i = col / ny, j = col % ny;
  const int base = col * nz + k0;  // the brick's first row

  // Stage the codes: word e of the staged rows is (column c, level lvl,
  // slots 4w..4w+3), level lvl the row at k0 - 1 + lvl; the levels beyond
  // the z walls are not staged (no row reads them).  Four words a thread
  // at once, their loads before their stores.
  const int words = stride / 4;
  const int n_words = 9 * levels * words;
  constexpr int kBatch = 4;
  for (int e0 = threadIdx.x; e0 < n_words; e0 += kBatch * blockDim.x) {
    int t[kBatch][4];
    bool staged[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * blockDim.x;
      const int w = e % words, rest = e / words;
      const int k = k0 - 1 + rest % levels, l0 = 4 * w;
      staged[b] = e < n_words && k >= 0 && k < nz;
#pragma unroll
      for (int q = 0; q < 4; ++q) t[b][q] = -1;
      if (staged[b] && l0 < cap) {
        const int row = column_row(i, j, rest / levels, nx, ny, nz) + k;
        load4<VEC>(tgt, static_cast<size_t>(row) * cap + l0, l0, cap, -1,
                   t[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (!staged[b]) continue;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned d = static_cast<unsigned>(t[b][q] - base);
        word |= (d < static_cast<unsigned>(brick) ? d : kNone) << (8 * q);
      }
      codes[e0 + b * blockDim.x] = word;
    }
  }
  __syncthreads();  // the block's only barrier

  const int kk = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = k0 + kk;
  if (kk >= brick || k >= nz) return;  // a whole warp
  const int r = base + kk;
  uint32_t* const list = lists + static_cast<size_t>(kk) * cap;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t want = 0x01010101u * static_cast<uint32_t>(kk);
  const int tiles = stride / kTile;
  int count = 0;  // droplets taken so far, the same on every lane
  for (int c = 0; c < 9; ++c) {
    const int row0 = column_row(i, j, c, nx, ny, nz);
#pragma unroll
    for (int m = 0; m < 3; ++m) {  // source 3c + m: dk innermost
      const int dk = source_dk(m);
      if (k + dk < 0 || k + dk >= nz) continue;
      const uint32_t* const staged =
          codes + (c * levels + kk + 1 + dk) * (stride / 4);
      const size_t src0 = static_cast<size_t>(row0 + k + dk) * cap;
      for (int tile = 0; tile < tiles; ++tile) {
        const uint32_t eq = __vcmpeq4(staged[tile * 32 + lane], want);
        const unsigned take = (eq & 1u) | ((eq >> 7) & 2u)
                              | ((eq >> 14) & 4u) | ((eq >> 21) & 8u);
        if (__ballot_sync(kAll, take != 0u) == 0u) continue;
        int before = 0, total = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned b = __ballot_sync(kAll, (take >> q) & 1u);
          before += __popc(b & below);
          total += __popc(b);
        }
        int pos = count + before;
        const int l0 = tile * kTile + 4 * lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((take >> q) & 1u) {
            if (pos < cap) list[pos] = static_cast<uint32_t>(src0 + l0 + q);
            ++pos;
          }
        }
        count += total;
      }
    }
  }
  __syncwarp();

  // the gather: slot p of the row takes list[p], the slots past the last
  // droplet zero
  const int placed = count < cap ? count : cap;
  const size_t dst = static_cast<size_t>(r) * cap;
  constexpr int kPasses = NP > 8 ? 2 : 4;
  for (int p0 = 0; p0 < cap; p0 += 32 * kPasses) {
    uint32_t src[kPasses];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int p = p0 + 32 * u + lane;
      src[u] = p < placed ? list[p] : kNoSlot;
    }
    float v[kPasses][NP];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
#pragma unroll
      for (int pl = 0; pl < NP; ++pl)
        v[u][pl] = src[u] != kNoSlot ? __ldg(in[pl] + src[u]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int p = p0 + 32 * u + lane;
      if (p < cap) {
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) out[pl][dst + p] = v[u][pl];
      }
    }
  }
  if (lane == 0) drops[r] = count > cap ? float(count - cap) : 0.0f;
}

// The launch every form shares: the checks, the dynamic shared memory
// (set for the kernel at every launch: bricks of other heights may run in
// between), the grid of nx * ny * bricks blocks of brick warps
template <class K, class... Args>
int launch_brick(K kernel, int n_cell, int cap, int nx, int ny, int nz,
                 int brick, cudaStream_t stream, Args... args) {
  if (nx < 3 || ny < 3 || nz < 1 || n_cell != nx * ny * nz || cap < 1
      || brick < 1 || brick > kMaxBrick
      || static_cast<unsigned long long>(n_cell) * cap >= kNoSlot)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = brick_smem(brick, cap);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return static_cast<int>(err);
  }
  const int bricks = (nz + brick - 1) / brick;
  kernel<<<nx * ny * bricks, brick * 32, smem, stream>>>(
      args..., cap, nx, ny, nz, brick, bricks);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of a form's kernel with a brick of ``brick`` rows at
// capacity ``cap``: out = registers a thread, static shared memory, the
// dynamic shared memory the launch asks for, local memory a thread (bytes),
// blocks an SM, threads a block.  Returns the CUDA error of setting the
// dynamic shared memory or of a query (0 if none).
template <class K>
int brick_attrs(K kernel, int brick, int cap, int* out) {
  if (brick < 1 || brick > kMaxBrick || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = brick_smem(brick, cap);
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        brick * 32, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = blocks;
  out[5] = brick * 32;
  return 0;
}

}  // namespace lcp
