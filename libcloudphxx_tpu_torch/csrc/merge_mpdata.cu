// Kernel D's MPDATA-epilogue form: the re-binning merge of merge.cu and,
// in the same launch, the next model step's MPDATA advection of th and rv.
//
// Replaces the MPDATA epilogue of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_xmerge_kernel (mp_iters, lines
// 722 and 740-757; rebin_x(..., mpdata_fields), line 765), which advects
// the post-condensation th and rv in grid step 0 of the x-merge kernel, so
// that the step needs no launch of its own for them.  Plain version:
// ops/step.py rebin_x_mpdata_plain (rebin_x_plain, then models/mpdata.py
// _advect_body a field).
//
// The launch is D's (a warp a destination row, 8 rows a block, merge.cuh
// merge_row) plus, first in the grid so that they start with the first
// wave of rows, one cluster of R CTAs a field (models/mpdata.py
// launch_plan with at most 8 CTAs, the portable cluster size), which runs
// kernel A's passes on its slabs as kernel A does (mpdata.cuh: the same
// per-cell arithmetic in _advect_body's order and the same ring of halo
// columns through distributed shared memory), so the pair is bitwise
// kernel A's.  The whole launch is in clusters of R and every block has
// the slab's shared memory (a few tens of KB, which does not bound D's
// blocks an SM); D's row blocks use neither.  Blocks are 32 x 8 threads: a
// row a warp for D (threadIdx.y), (k, column) for the passes.
//
// What bounds it on the card: D's bytes; the fields' passes, each of which
// waits for the one before, run beside D's row blocks on 2R SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "merge.cuh"
#include "mpdata.cuh"

namespace cg = cooperative_groups;

namespace lcp {

constexpr int kMpPlanes = 7;  // n rw2 rd3 kpa vt x z
constexpr int kMpFields = 2;  // th rv
constexpr int kMpCluster = 8;  // the portable cluster size

// What the epilogue's clusters read and write: the fields (nx, nz) in and
// out, the courants, G; the plan (CTAs a cluster, columns a CTA)
struct Epilogue {
  const float* psi[kMpFields];
  float* out[kMpFields];
  const float* gcx;
  const float* gcz;
  const float* G;
  int nx, nz, n_iters, fct, ctas, cols;
};

// Field blockIdx.x / R's MPDATA on the cluster's slabs: kernel A's body
// (mpdata.cu mpdata_kernel), CTA q of the cluster owning columns
// [q * cols, min(nx, (q + 1) * cols))
__device__ __forceinline__ void advect_field(const Epilogue& e) {
  extern __shared__ float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int R = e.ctas, q = static_cast<int>(cl.block_rank());
  const int nx = e.nx, nz = e.nz, cols = e.cols;
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
  const bool first = static_cast<int>(blockIdx.x) < R;
  const float* src = first ? e.psi[0] : e.psi[1];
  for2d(0, w + 2, nz, [&](int ci, int k) {
    int i = x0 + ci - 1;
    i = i < 0 ? i + nx : (i >= nx ? i - nx : i);
    prev[g.c(ci, k)] = src[i * nz + k];
    G[g.c(ci, k)] = e.G[i * nz + k];
  });
  for2d(0, w + 2, nz + 1, [&](int ci, int f) {
    int i = x0 + ci - 1;
    i = i < 0 ? i + nx : (i >= nx ? i - nx : i);
    gz[g.fz(ci, f)] = e.gcz[i * (nz + 1) + f];
  });
  for2d(0, w + 1, nz, [&](int fi, int k) {
    gx[g.fx(fi, k)] = e.gcx[(x0 + fi) * nz + k];
  });
  __syncthreads();

  advect_once(g, prev, gx, gz, G, cur);
  if (e.n_iters > 1) {
    cl.sync();
    ring.halo(cl, cur, nz, nz);
    __syncthreads();
  }
  for (int it = 1; it < e.n_iters; ++it) {
    antidiff(g, cur, gx, gz, G, gx2, gz2);
    __syncthreads();
    if (e.fct) {
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
    if (it + 1 < e.n_iters) {  // the next antidiff reads both halos
      cl.sync();
      ring.halo(cl, cur, nz, nz);
      ring.halo(cl, gz, nz + 1, nz + 1);
      __syncthreads();
    }
  }

  __syncthreads();
  float* dst = first ? e.out[0] : e.out[1];
  for2d(1, w + 1, nz, [&](int ci, int k) {
    dst[(x0 + ci - 1) * nz + k] = cur[g.c(ci, k)];
  });
  cl.sync();  // no CTA leaves while a neighbour may still read its memory
}

// grid: kMpFields clusters of R epilogue CTAs, then D's row blocks (the
// grid a whole number of clusters)
template <bool VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
merge_mpdata_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
                    const float* __restrict__ rd3,
                    const float* __restrict__ kpa,
                    const float* __restrict__ vt, const float* __restrict__ x,
                    const float* __restrict__ z, const int* __restrict__ tgt,
                    float* __restrict__ n_out, float* __restrict__ rw2_out,
                    float* __restrict__ rd3_out, float* __restrict__ kpa_out,
                    float* __restrict__ vt_out, float* __restrict__ x_out,
                    float* __restrict__ z_out, float* __restrict__ drops,
                    int n_cell, int cap, int nx, int nz, Epilogue e) {
  const int first = kMpFields * e.ctas;
  if (static_cast<int>(blockIdx.x) < first) {
    advect_field(e);
    return;
  }
  const int r = (static_cast<int>(blockIdx.x) - first) * kWarpRows
                + static_cast<int>(threadIdx.y);
  if (r >= n_cell) return;  // the whole warp
  const float* const in[kMpPlanes] = {n, rw2, rd3, kpa, vt, x, z};
  float* const out[kMpPlanes] = {n_out, rw2_out, rd3_out, kpa_out, vt_out,
                                 x_out, z_out};
  merge_row<kMpPlanes, VEC>(in, out, tgt, drops, r, cap, Grid2(r, nx, nz));
}

}  // namespace lcp

// lcp_merge's arguments, then th and rv (n_cell = nx * nz values each) in,
// their advected fields out, the courants gc_x (nx + 1, nz) and gc_z (nx,
// nz + 1), G (nx, nz), n_iters and fct, and the plan (models/mpdata.py
// launch_plan at most 8 CTAs: CTAs a cluster, columns a CTA, shared bytes
// a CTA)
extern "C" int lcp_merge_mpdata(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const float* x, const float* z, const int* tgt,
    float* n_out, float* rw2_out, float* rd3_out, float* kpa_out,
    float* vt_out, float* x_out, float* z_out, float* drops, int n_cell,
    int cap, int nx, int nz, const float* th, const float* rv,
    float* th_out, float* rv_out, const float* gcx, const float* gcz,
    const float* G, int n_iters, int fct, int ctas, int cols, int smem,
    cudaStream_t stream) {
  if (n_iters < 1 || nx < 3 || static_cast<long long>(nx) * nz != n_cell
      || ctas < 1 || ctas > lcp::kMpCluster || cols < 1
      || static_cast<long long>(ctas) * cols < nx
      || static_cast<long long>(ctas - 1) * cols >= nx || smem < 0
      || static_cast<size_t>(smem)
             != lcp::mpdata_floats(cols, nz, fct) * sizeof(float))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, rd3, kpa, vt, x, z, tgt, n_out, rw2_out, rd3_out, kpa_out,
            vt_out, x_out, z_out});
  auto kernel = vec ? lcp::merge_mpdata_kernel<true>
                    : lcp::merge_mpdata_kernel<false>;
  // the attribute only grows, so it is set once per size
  static int smem_set[2] = {0, 0};
  if (smem > smem_set[vec]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[vec] = smem;
  }
  const int rows = lcp::row_blocks(n_cell);
  const lcp::Epilogue e{{th, rv}, {th_out, rv_out}, gcx, gcz, G, nx, nz,
                        n_iters, fct, ctas, cols};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(ctas * (lcp::kMpFields + (rows + ctas - 1) / ctas));
  cfg.blockDim = dim3(32, lcp::kWarpRows);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, n, rw2, rd3, kpa, vt, x, z, tgt, n_out, rw2_out, rd3_out,
      kpa_out, vt_out, x_out, z_out, drops, n_cell, cap, nx, nz, e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
