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
// What bounds it on the card: latency.  At 76x76 a field is 23 KB and a
// pass is a few thousand cells of stencil arithmetic, while each pass
// needs the whole result of the one before.
// What the design does about it: one thread block per field, the whole
// grid of that field in shared memory (field before and after, G, the two
// courant fields and their antidiffusive successors, the FCT betas: 209 KB
// at 76x76 with FCT, set through cudaFuncAttributeMaxDynamicSharedMemorySize),
// and __syncthreads() between passes in place of kernel boundaries.  Fields
// run on separate SMs in parallel.  A grid that does not fit raises in the
// wrapper.

#include <cuda_runtime.h>

namespace lcp {

struct Grid {
  int nx, nz;
  __device__ int c(int i, int k) const { return i * nz + k; }      // cell
  __device__ int fx(int f, int k) const { return f * nz + k; }     // x face
  __device__ int fz(int i, int f) const { return i * (nz + 1) + f; }  // z face
  __device__ int wrap(int i) const { return (i + nx) % nx; }
  __device__ int clampk(int k) const { return k < 0 ? 0 : (k >= nz ? nz - 1 : k); }
};

__device__ __forceinline__ float frac(float num, float den) {
  return den > 0.0f ? num / den : 0.0f;
}

__device__ __forceinline__ float donor(float psi_l, float psi_r, float gc) {
  return fmaxf(gc, 0.0f) * psi_l + fminf(gc, 0.0f) * psi_r;
}

// psi_new = psi - (dF_x + dF_z) / G  (mpdata.py _advect_once)
__device__ void advect_once(const Grid& g, const float* psi, const float* gx,
                            const float* gz, const float* G, float* out) {
  for (int idx = threadIdx.x; idx < g.nx * g.nz; idx += blockDim.x) {
    const int i = idx / g.nz, k = idx % g.nz;
    const float p = psi[idx];
    const float fl = donor(psi[g.c(g.wrap(i - 1), k)], p, gx[g.fx(i, k)]);
    const float fr = donor(p, psi[g.c(g.wrap(i + 1), k)], gx[g.fx(i + 1, k)]);
    const float fb = donor(psi[g.c(i, g.clampk(k - 1))], p, gz[g.fz(i, k)]);
    const float fa = donor(p, psi[g.c(i, g.clampk(k + 1))], gz[g.fz(i, k + 1)]);
    out[idx] = p - ((fr - fl) + (fa - fb)) / G[idx];
  }
}

// antidiffusive pseudo-velocities (mpdata.py _antidiff_gc)
__device__ void antidiff(const Grid& g, const float* psi, const float* gx,
                         const float* gz, const float* G, float* gx2,
                         float* gz2) {
  for (int idx = threadIdx.x; idx < (g.nx + 1) * g.nz; idx += blockDim.x) {
    const int f = idx / g.nz, k = idx % g.nz;
    const int il = g.wrap(f - 1), ir = g.wrap(f);
    const int kd = g.clampk(k - 1), ku = g.clampk(k + 1);
    const float pl = psi[g.c(il, k)], pr = psi[g.c(ir, k)];
    const float A = frac(pr - pl, pr + pl);
    const float Gx = 0.5f * (G[g.c(il, k)] + G[g.c(ir, k)]);
    const float up = psi[g.c(ir, ku)] + psi[g.c(il, ku)];
    const float dn = psi[g.c(ir, kd)] + psi[g.c(il, kd)];
    const float B = 0.5f * frac(up - dn, up + dn);
    const float gzx = 0.25f * (gz[g.fz(il, k)] + gz[g.fz(il, k + 1)]
                               + gz[g.fz(ir, k)] + gz[g.fz(ir, k + 1)]);
    const float c = gx[idx];
    gx2[idx] = fabsf(c) * (1.0f - fabsf(c) / Gx) * A - c * gzx / Gx * B;
  }
  for (int idx = threadIdx.x; idx < g.nx * (g.nz + 1); idx += blockDim.x) {
    const int i = idx / (g.nz + 1), f = idx % (g.nz + 1);
    if (f == 0 || f == g.nz) {  // no antidiffusive flux through the walls
      gz2[idx] = 0.0f;
      continue;
    }
    const int kd = g.clampk(f - 1), ku = g.clampk(f);
    const int iL = g.wrap(i - 1), iR = g.wrap(i + 1);
    const float pd = psi[g.c(i, kd)], pu = psi[g.c(i, ku)];
    const float A = frac(pu - pd, pu + pd);
    const float Gz = 0.5f * (G[g.c(i, kd)] + G[g.c(i, ku)]);
    const float right = psi[g.c(iR, ku)] + psi[g.c(iR, kd)];
    const float left = psi[g.c(iL, ku)] + psi[g.c(iL, kd)];
    const float B = 0.5f * frac(right - left, right + left);
    const float gxz = 0.25f * (gx[g.fx(i, kd)] + gx[g.fx(i + 1, kd)]
                               + gx[g.fx(i, ku)] + gx[g.fx(i + 1, ku)]);
    const float c = gz[idx];
    gz2[idx] = fabsf(c) * (1.0f - fabsf(c) / Gz) * A - c * gxz / Gz * B;
  }
}

__device__ __forceinline__ void star_extrema(const Grid& g, const float* psi,
                                             int i, int k, float& mx,
                                             float& mn) {
  const float a = psi[g.c(g.wrap(i - 1), k)], b = psi[g.c(g.wrap(i + 1), k)];
  const float d = psi[g.c(i, g.clampk(k - 1))], u = psi[g.c(i, g.clampk(k + 1))];
  const float p = psi[g.c(i, k)];
  mx = fmaxf(fmaxf(a, b), fmaxf(fmaxf(d, u), p));
  mn = fminf(fminf(a, b), fminf(fminf(d, u), p));
}

// FCT betas (mpdata.py _fct_limit, first half): psi_n before the donor
// pass of the last iteration, psi after it, gx2/gz2 the antidiffusive
// courants to be limited
__device__ void fct_betas(const Grid& g, const float* psi_n, const float* psi,
                          const float* gx2, const float* gz2, const float* G,
                          float* bup, float* bdn) {
  for (int idx = threadIdx.x; idx < g.nx * g.nz; idx += blockDim.x) {
    const int i = idx / g.nz, k = idx % g.nz;
    float mx, mn, mx_n, mn_n;
    star_extrema(g, psi, i, k, mx, mn);
    star_extrema(g, psi_n, i, k, mx_n, mn_n);
    mx = fmaxf(mx, mx_n);
    mn = fminf(mn, mn_n);
    const float p = psi[idx];
    const float fl = donor(psi[g.c(g.wrap(i - 1), k)], p, gx2[g.fx(i, k)]);
    const float fr = donor(p, psi[g.c(g.wrap(i + 1), k)], gx2[g.fx(i + 1, k)]);
    const float fb = donor(psi[g.c(i, g.clampk(k - 1))], p, gz2[g.fz(i, k)]);
    const float fa = donor(p, psi[g.c(i, g.clampk(k + 1))], gz2[g.fz(i, k + 1)]);
    const float f_in = fmaxf(fl, 0.0f) - fminf(fr, 0.0f) + fmaxf(fb, 0.0f)
                       - fminf(fa, 0.0f);
    const float f_out = fmaxf(fr, 0.0f) - fminf(fl, 0.0f) + fmaxf(fa, 0.0f)
                        - fminf(fb, 0.0f);
    bup[idx] = frac((mx - p) * G[idx], f_in);
    bdn[idx] = frac((p - mn) * G[idx], f_out);
  }
}

// FCT limit of each face by the donor's beta_dn and the receiver's beta_up
__device__ void fct_limit(const Grid& g, const float* bup, const float* bdn,
                          float* gx2, float* gz2) {
  for (int idx = threadIdx.x; idx < (g.nx + 1) * g.nz; idx += blockDim.x) {
    const int f = idx / g.nz, k = idx % g.nz;
    const int l = g.c(g.wrap(f - 1), k), r = g.c(g.wrap(f), k);
    const float c = gx2[idx];
    const float lim = c >= 0.0f ? fminf(1.0f, fminf(bdn[l], bup[r]))
                                : fminf(1.0f, fminf(bup[l], bdn[r]));
    gx2[idx] = c * lim;
  }
  for (int idx = threadIdx.x; idx < g.nx * (g.nz + 1); idx += blockDim.x) {
    const int i = idx / (g.nz + 1), f = idx % (g.nz + 1);
    const int d = g.c(i, g.clampk(f - 1)), u = g.c(i, g.clampk(f));
    const float c = gz2[idx];
    const float lim = c >= 0.0f ? fminf(1.0f, fminf(bdn[d], bup[u]))
                                : fminf(1.0f, fminf(bup[d], bdn[u]));
    gz2[idx] = c * lim;
  }
}

__global__ void __launch_bounds__(512)
mpdata_kernel(const float* __restrict__ psi_in, float* __restrict__ psi_out,
              const float* __restrict__ gcx, const float* __restrict__ gcz,
              const float* __restrict__ Gin, int nx, int nz, int n_iters,
              int fct) {
  extern __shared__ float smem[];
  const Grid g{nx, nz};
  const int nc = nx * nz, nfx = (nx + 1) * nz, nfz = nx * (nz + 1);
  float* prev = smem;
  float* cur = prev + nc;
  float* G = cur + nc;
  float* gx = G + nc;
  float* gz = gx + nfx;
  float* gx2 = gz + nfz;
  float* gz2 = gx2 + nfx;
  float* bup = gz2 + nfz;  // only with fct
  float* bdn = bup + nc;

  const float* src = psi_in + static_cast<size_t>(blockIdx.x) * nc;
  for (int idx = threadIdx.x; idx < nc; idx += blockDim.x) {
    prev[idx] = src[idx];
    G[idx] = Gin[idx];
  }
  for (int idx = threadIdx.x; idx < nfx; idx += blockDim.x) gx[idx] = gcx[idx];
  for (int idx = threadIdx.x; idx < nfz; idx += blockDim.x) gz[idx] = gcz[idx];
  __syncthreads();

  advect_once(g, prev, gx, gz, G, cur);
  __syncthreads();
  for (int it = 1; it < n_iters; ++it) {
    antidiff(g, cur, gx, gz, G, gx2, gz2);
    __syncthreads();
    if (fct) {
      fct_betas(g, prev, cur, gx2, gz2, G, bup, bdn);
      __syncthreads();
      fct_limit(g, bup, bdn, gx2, gz2);
      __syncthreads();
    }
    float* t = gx; gx = gx2; gx2 = t;
    t = gz; gz = gz2; gz2 = t;
    advect_once(g, cur, gx, gz, G, prev);  // prev is no longer needed
    __syncthreads();
    t = prev; prev = cur; cur = t;
  }

  float* dst = psi_out + static_cast<size_t>(blockIdx.x) * nc;
  for (int idx = threadIdx.x; idx < nc; idx += blockDim.x) dst[idx] = cur[idx];
}

}  // namespace lcp

// Dynamic shared memory the kernel needs for an nx x nz grid.
extern "C" size_t lcp_mpdata_smem_bytes(int nx, int nz, int fct) {
  const size_t nc = static_cast<size_t>(nx) * nz;
  const size_t faces = static_cast<size_t>(nx + 1) * nz
                       + static_cast<size_t>(nx) * (nz + 1);
  return ((fct ? 5 : 3) * nc + 2 * faces) * sizeof(float);
}

extern "C" int lcp_mpdata(const float* psi_in, float* psi_out, const float* gcx,
                          const float* gcz, const float* G, int nfields,
                          int nx, int nz, int n_iters, int fct,
                          cudaStream_t stream) {
  const size_t smem = lcp_mpdata_smem_bytes(nx, nz, fct);
  cudaError_t err = cudaFuncSetAttribute(
      lcp::mpdata_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lcp::mpdata_kernel<<<nfields, 512, smem, stream>>>(psi_in, psi_out, gcx, gcz,
                                                     G, nx, nz, n_iters, fct);
  return static_cast<int>(cudaGetLastError());
}
