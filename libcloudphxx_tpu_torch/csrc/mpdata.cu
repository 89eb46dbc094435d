// Kernel A: MPDATA advection of one or more scalar fields sharing courants.
//
// Replaces the TPU kernels of libcloudphxx_tpu/models/mpdata.py: the
// one-field body in advect (lines 226-237) and the two-field body in
// advect2 (lines 256-269), both _advect_body (lines 180-189): a donor-cell
// pass, then n_iters-1 antidiffusive passes with an optional FCT limiter;
// periodic x halo, edge-copy z halo, exact-zero ratio guard, no
// antidiffusive flux through the top and bottom walls, FCT extrema over
// both the field before and after the donor pass.  Plain version:
// models/mpdata.py _advect_body.
//
// What bounds it on the card: latency and instruction count, not bytes.
// At 76x76 a field is 23 KB and a pass a few thousand cells of stencil
// arithmetic, while each pass needs the whole result of the one before.
// What the design does about it: one thread-block cluster of R CTAs a
// field (R = 16 where the card takes a cluster that large, else 8, never
// above nx; models/mpdata.py launch_plan), so a field's passes run on R
// SMs.  Each CTA owns a contiguous slab of x columns (a ceil split) and
// the whole z extent, and keeps in its shared memory its slab plus one
// halo column a side of psi before and after, G and the z courants, its
// slab's x faces, and the FCT betas.  Between passes cluster.sync(), then
// each CTA copies its halo columns from its neighbours' shared memory
// (distributed shared memory; x is periodic, so rank 0's left neighbour is
// rank R-1).  A slab's boundary x face is computed by both CTAs beside it
// from the same inputs, so both hold the same bits.  Threads map to
// (column, k), and no pass divides an integer.  Each cell's operations
// follow _advect_body's order, so the kernel is bitwise equal to it.  The
// passes and the ring are mpdata.cuh's, which kernel D's MPDATA epilogue
// (merge_mpdata.cu) runs on clusters of its own.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mpdata.cuh"

namespace cg = cooperative_groups;

namespace lcp {

constexpr int kMaxCluster = 16;
constexpr size_t kSmemLimit = 232448;  // models/mpdata.py SMEM_LIMIT

// grid (R, nfields), clusters of (R, 1, 1): CTA q of field blockIdx.y owns
// columns [q * cols, min(nx, (q + 1) * cols))
__global__ void __launch_bounds__(1024)
mpdata_kernel(const float* __restrict__ psi_in, float* __restrict__ psi_out,
              const float* __restrict__ gcx, const float* __restrict__ gcz,
              const float* __restrict__ Gin, int nx, int nz, int n_iters,
              int fct, int cols) {
  extern __shared__ float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int R = gridDim.x, q = blockIdx.x;
  const int x0 = q * cols;
  const int w = min(cols, nx - x0);
  const int ql = q == 0 ? R - 1 : q - 1, qr = q == R - 1 ? 0 : q + 1;
  const Ring ring{ql, qr, min(cols, nx - ql * cols), w};
  const Slab g{nz, w};
  const int nc = (cols + 2) * nz, nfx = (cols + 1) * nz,
            nfz = (cols + 2) * (nz + 1);
  float* prev = smem;
  float* cur = prev + nc;
  float* G = cur + nc;
  float* gx = G + nc;
  float* gx2 = gx + nfx;
  float* gz = gx2 + nfx;
  float* gz2 = gz + nfz;
  float* bup = gz2 + nfz;  // only with fct
  float* bdn = bup + nc;

  // the slab and its halo columns, x wrapped
  const float* src = psi_in + static_cast<size_t>(blockIdx.y) * nx * nz;
  for2d(0, w + 2, nz, [&](int ci, int k) {
    int i = x0 + ci - 1;
    i = i < 0 ? i + nx : (i >= nx ? i - nx : i);
    prev[g.c(ci, k)] = src[i * nz + k];
    G[g.c(ci, k)] = Gin[i * nz + k];
  });
  for2d(0, w + 2, nz + 1, [&](int ci, int f) {
    int i = x0 + ci - 1;
    i = i < 0 ? i + nx : (i >= nx ? i - nx : i);
    gz[g.fz(ci, f)] = gcz[i * (nz + 1) + f];
  });
  for2d(0, w + 1, nz, [&](int fi, int k) {
    gx[g.fx(fi, k)] = gcx[(x0 + fi) * nz + k];
  });
  __syncthreads();

  advect_once(g, prev, gx, gz, G, cur);
  if (n_iters > 1) {
    cl.sync();
    ring.halo(cl, cur, nz, nz);
    __syncthreads();
  }
  for (int it = 1; it < n_iters; ++it) {
    antidiff(g, cur, gx, gz, G, gx2, gz2);
    __syncthreads();
    if (fct) {
      fct_betas(g, prev, cur, gx2, gz2, G, bup, bdn);
      cl.sync();
      ring.halo(cl, bup, nz, nz);
      ring.halo(cl, bdn, nz, nz);
      __syncthreads();
      fct_limit(g, bup, bdn, gx2, gz2);
      __syncthreads();
    }
    float* t = gx; gx = gx2; gx2 = t;
    t = gz; gz = gz2; gz2 = t;
    advect_once(g, cur, gx, gz, G, prev);  // prev is no longer needed
    t = prev; prev = cur; cur = t;
    if (it + 1 < n_iters) {  // the next antidiff reads both halos
      cl.sync();
      ring.halo(cl, cur, nz, nz);
      ring.halo(cl, gz, nz + 1, nz + 1);
      __syncthreads();
    }
  }

  __syncthreads();
  float* dst = psi_out + static_cast<size_t>(blockIdx.y) * nx * nz;
  for2d(1, w + 1, nz, [&](int ci, int k) {
    dst[(x0 + ci - 1) * nz + k] = cur[g.c(ci, k)];
  });
  cl.sync();  // no CTA leaves while a neighbour may still read its memory
}

// Dynamic shared memory a CTA of ``cols`` columns needs (models/mpdata.py
// launch_plan counts the same).
size_t smem_bytes(int cols, int nz, int fct) {
  return mpdata_floats(cols, nz, fct) * sizeof(float);
}

dim3 block_of(int cols, int nz) {
  const int bx = min(((nz + 1 + 31) / 32) * 32, 1024);
  const int by = max(1, min(cols + 1, 1024 / bx));
  return dim3(bx, by);
}

// Check a plan (R CTAs of ``cols`` columns, ``smem`` bytes each) against
// the grid, set the kernel's attributes and fill the launch config.
cudaError_t configure(int nfields, int nx, int nz, int fct, int R, int cols,
                      int smem, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr, cudaStream_t stream) {
  if (nfields < 1 || nx < 1 || nz < 1 || R < 1 || R > kMaxCluster
      || cols < 1 || static_cast<long long>(R) * cols < nx
      || static_cast<long long>(R - 1) * cols >= nx
      || smem < 0 || static_cast<size_t>(smem) != smem_bytes(cols, nz, fct)
      || static_cast<size_t>(smem) > kSmemLimit)
    return cudaErrorInvalidValue;
  // the attributes only grow, so each is set once per size (setting them
  // at every launch costs more host time than the kernel takes)
  static int smem_set = 0;
  static bool wide_set = false;
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(mpdata_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (R > 8 && !wide_set) {
    err = cudaFuncSetAttribute(
        mpdata_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_set = true;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(R, nfields);
  cfg.blockDim = block_of(cols, nz);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace lcp

// How many clusters of the plan the card can hold at once (0: the plan
// does not fit, e.g. a cluster of 16 where the card takes at most 8).
extern "C" int lcp_mpdata_clusters(int nx, int nz, int fct, int R, int cols,
                                   int smem, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      lcp::configure(1, nx, nz, fct, R, cols, smem, cfg, attr, nullptr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(count, lcp::mpdata_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    *count = 0;
  }
  return static_cast<int>(err);
}

extern "C" int lcp_mpdata(const float* psi_in, float* psi_out, const float* gcx,
                          const float* gcz, const float* G, int nfields,
                          int nx, int nz, int n_iters, int fct, int R,
                          int cols, int smem, cudaStream_t stream) {
  if (n_iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      lcp::configure(nfields, nx, nz, fct, R, cols, smem, cfg, attr, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, lcp::mpdata_kernel, psi_in, psi_out, gcx,
                           gcz, G, nx, nz, n_iters, fct, cols);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
