// The cell of a parcel on a thread-block cluster: the frame of kernel F's
// and kernel G-fixed's parcel forms (cond_flat.cu cond_flat_parcel_kernel,
// cond_sd_fixed.cu cond_sd_fixed_parcel_kernel, and their turb_cond forms).
//
// A parcel has one cell (n_dims 0), so cond_cell.cuh's warp-a-cell frame
// ran its whole launch on one warp of one SM.  Here a cluster of R CTAs of
// T threads takes a cell (a grid of one cluster a cell, so several cells
// run too): thread t of the cluster takes the slots t, t + R T, ... of the
// cell's segment, in registers across the substeps when it holds one
// (``resident``), else through a per-slot scratch.  A slot that the
// plain version does not advance, and a thread past the segment's end,
// run a placeholder droplet masked off, so that every lane of a warp
// takes every stage of the shared per-droplet routines (advance's
// ballot) and none feeds an IEEE division garbage.
//
// The cell sums of a substep (F's latent heat; G-fixed's mixed vapour and
// heat) are float64 and in a fixed order: each thread's slots in order,
// the warp's __shfl_xor_sync butterfly, the warps in order in shared
// memory, the CTA's partial into a slot of its shared memory by substep
// parity, one cluster barrier, then warp 0 of each CTA reads the R
// partials through distributed shared memory and adds them in rank order.
// Every thread of the cluster holds the same sum, from run to run.  The
// parity slots let one cluster barrier a substep suffice: a CTA writes a
// slot again two substeps later, after a barrier that every reader of it
// has passed.  ops/cond.py parcel_plan picks R and T.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cond_cell.cuh"

namespace lcp {

namespace cg = cooperative_groups;

constexpr int kParcelCluster = 16;    // ops/cond.py PARCEL_MAX_CLUSTER
constexpr int kParcelThreads = 512;   // PARCEL_MAX_THREADS

// The cell of the thread's cluster, by its place in the grid
__device__ __forceinline__ int cluster_cell() {
  return static_cast<int>(blockIdx.x / cg::this_cluster().num_blocks());
}

// Where a thread of a cell's cluster stands in the segment [begin, end):
// its index in the cluster, the cluster's thread count, and the chunks of
// that many slots the segment takes
struct ClusterLane {
  long long t, stride;
  int n_chunk;
  __device__ __forceinline__ ClusterLane(long long begin, long long end) {
    cg::cluster_group cl = cg::this_cluster();
    t = static_cast<long long>(cl.block_rank()) * blockDim.x + threadIdx.x;
    stride = static_cast<long long>(cl.num_blocks()) * blockDim.x;
    n_chunk = static_cast<int>((end - begin + stride - 1) / stride);
  }
};

// The shared memory of a cell sum of K float64 values
template <int K>
struct ClusterSum {
  double warp[kParcelThreads / 32][K];  // the CTA's warps' partials
  double cta[2][K];                     // the CTA's partial, by parity
  double total[K];                      // the cluster's sum
};

// The cluster's sums of v[0..K) (each thread's partials in, every
// thread's sums out) in substep ``parity``
template <int K>
__device__ __forceinline__ void cluster_sum(double (&v)[K], ClusterSum<K>& sm,
                                            int parity) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sm.warp[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n_warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double s = 0.0;
      for (int w = 0; w < n_warps; ++w) s += sm.warp[w][k];
      sm.cta[parity][k] = s;
    }
  }
  cl.sync();
  if (warp == 0) {
    const int R = static_cast<int>(cl.num_blocks());
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const double x =
          lane < R ? cl.map_shared_rank(&sm, lane)->cta[parity][k] : 0.0;
      double s = 0.0;
      for (int r = 0; r < R; ++r) s += __shfl_sync(kFullMask, x, r);
      if (lane == 0) sm.total[k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = sm.total[k];
}

// A placeholder droplet for a lane without one: finite through drw2_dt
// (rw^3 above rd3, vt 0), masked off wherever it is used
__device__ __forceinline__ CondDrop no_drop() {
  return make_drop(0, kMaskedRw2, F(1e-21), 0.5f, 0.0f, 0.0f);
}

// A launch of one cluster of ``ctas`` CTAs of ``threads`` threads a cell;
// ``wide`` whether the kernel may take clusters of more than 8 CTAs yet
// (the attribute is set once: setting it at every launch costs more host
// time than the kernel takes)
template <class... Exp>
cudaError_t parcel_config(void (*kernel)(Exp...), bool& wide, int n_cell,
                          int ctas, int threads, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute& attr, cudaStream_t stream) {
  if (n_cell < 1 || ctas < 1 || ctas > kParcelCluster || threads < 32
      || threads > kParcelThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  if (ctas > 8 && !wide) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas) * n_cell);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <class... Exp, class... Act>
int parcel_launch(void (*kernel)(Exp...), bool& wide, int n_cell, int ctas,
                  int threads, cudaStream_t stream, Act&&... args) {
  if (n_cell <= 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      parcel_config(kernel, wide, n_cell, ctas, threads, cfg, attr, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the plan the card holds at once (0: it takes no
// cluster of that size, e.g. 16 CTAs where the card takes at most 8)
template <class... Exp>
int parcel_clusters(void (*kernel)(Exp...), bool& wide, int ctas,
                    int threads, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      parcel_config(kernel, wide, 1, ctas, threads, cfg, attr, nullptr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    *count = 0;
  }
  return static_cast<int>(err);
}

}  // namespace lcp
