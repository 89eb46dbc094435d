// Kernel A's per-cell arithmetic, shared by its forms: the slab view of a
// field, the donor-cell pass, the antidiffusive pseudo-velocities and the
// FCT limiter of models/mpdata.py _advect_body, each a pass over a slab's
// cells with the threads of a block over (column, k), and the cluster's
// ring of slabs.  mpdata.cu runs them in kernel A, merge_mpdata.cu in
// kernel D's MPDATA epilogue, so that both follow _advect_body's order in
// every cell and agree bitwise.  The passes are static: each
// source that includes this header keeps its own copy.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace lcp {

// A CTA's view of its slab: local column 0 is the left halo, 1..w the
// owned columns, w+1 the right halo; x faces 0..w are the faces x0..x0+w.
// Arrays are laid out for ``cols`` columns (the plan's widest slab), so
// every CTA of a cluster has the same offsets.
struct Slab {
  int nz, w;
  __device__ int c(int ci, int k) const { return ci * nz + k; }  // cell
  __device__ int fx(int fi, int k) const { return fi * nz + k; }  // x face
  __device__ int fz(int ci, int f) const {                         // z face
    return ci * (nz + 1) + f;
  }
  __device__ int clampk(int k) const {
    return k < 0 ? 0 : (k >= nz ? nz - 1 : k);
  }
};

// f(ci, k) for ci in [c0, c1) and k in [0, m), threads over (column, k)
template <typename F>
__device__ __forceinline__ void for2d(int c0, int c1, int m, F f) {
  for (int ci = c0 + static_cast<int>(threadIdx.y); ci < c1;
       ci += blockDim.y)
    for (int k = threadIdx.x; k < m; k += blockDim.x) f(ci, k);
}

__device__ __forceinline__ float frac(float num, float den) {
  return den > 0.0f ? num / den : 0.0f;
}

__device__ __forceinline__ float donor(float psi_l, float psi_r, float gc) {
  return fmaxf(gc, 0.0f) * psi_l + fminf(gc, 0.0f) * psi_r;
}

// psi_new = psi - (dF_x + dF_z) / G on the owned cells (mpdata.py
// _advect_once)
static __device__ void advect_once(const Slab& g, const float* psi,
                                   const float* gx, const float* gz,
                                   const float* G, float* out) {
  for2d(1, g.w + 1, g.nz, [&](int ci, int k) {
    const float p = psi[g.c(ci, k)];
    const float fl = donor(psi[g.c(ci - 1, k)], p, gx[g.fx(ci - 1, k)]);
    const float fr = donor(p, psi[g.c(ci + 1, k)], gx[g.fx(ci, k)]);
    const float fb = donor(psi[g.c(ci, g.clampk(k - 1))], p, gz[g.fz(ci, k)]);
    const float fa =
        donor(p, psi[g.c(ci, g.clampk(k + 1))], gz[g.fz(ci, k + 1)]);
    out[g.c(ci, k)] = p - ((fr - fl) + (fa - fb)) / G[g.c(ci, k)];
  });
}

// antidiffusive pseudo-velocities of the slab's x faces and owned z faces
// (mpdata.py _antidiff_gc)
static __device__ void antidiff(const Slab& g, const float* psi,
                                const float* gx, const float* gz,
                                const float* G, float* gx2, float* gz2) {
  for2d(0, g.w + 1, g.nz, [&](int fi, int k) {
    const int il = fi, ir = fi + 1;
    const int kd = g.clampk(k - 1), ku = g.clampk(k + 1);
    const float pl = psi[g.c(il, k)], pr = psi[g.c(ir, k)];
    const float A = frac(pr - pl, pr + pl);
    const float Gx = 0.5f * (G[g.c(il, k)] + G[g.c(ir, k)]);
    const float up = psi[g.c(ir, ku)] + psi[g.c(il, ku)];
    const float dn = psi[g.c(ir, kd)] + psi[g.c(il, kd)];
    const float B = 0.5f * frac(up - dn, up + dn);
    const float gzx = 0.25f * (gz[g.fz(il, k)] + gz[g.fz(il, k + 1)]
                               + gz[g.fz(ir, k)] + gz[g.fz(ir, k + 1)]);
    const float c = gx[g.fx(fi, k)];
    gx2[g.fx(fi, k)] =
        fabsf(c) * (1.0f - fabsf(c) / Gx) * A - c * gzx / Gx * B;
  });
  for2d(1, g.w + 1, g.nz + 1, [&](int ci, int f) {
    if (f == 0 || f == g.nz) {  // no antidiffusive flux through the walls
      gz2[g.fz(ci, f)] = 0.0f;
      return;
    }
    const int kd = g.clampk(f - 1), ku = g.clampk(f);
    const float pd = psi[g.c(ci, kd)], pu = psi[g.c(ci, ku)];
    const float A = frac(pu - pd, pu + pd);
    const float Gz = 0.5f * (G[g.c(ci, kd)] + G[g.c(ci, ku)]);
    const float right = psi[g.c(ci + 1, ku)] + psi[g.c(ci + 1, kd)];
    const float left = psi[g.c(ci - 1, ku)] + psi[g.c(ci - 1, kd)];
    const float B = 0.5f * frac(right - left, right + left);
    const float gxz = 0.25f * (gx[g.fx(ci - 1, kd)] + gx[g.fx(ci, kd)]
                               + gx[g.fx(ci - 1, ku)] + gx[g.fx(ci, ku)]);
    const float c = gz[g.fz(ci, f)];
    gz2[g.fz(ci, f)] =
        fabsf(c) * (1.0f - fabsf(c) / Gz) * A - c * gxz / Gz * B;
  });
}

__device__ __forceinline__ void star_extrema(const Slab& g, const float* psi,
                                             int ci, int k, float& mx,
                                             float& mn) {
  const float a = psi[g.c(ci - 1, k)], b = psi[g.c(ci + 1, k)];
  const float d = psi[g.c(ci, g.clampk(k - 1))];
  const float u = psi[g.c(ci, g.clampk(k + 1))];
  const float p = psi[g.c(ci, k)];
  mx = fmaxf(fmaxf(a, b), fmaxf(fmaxf(d, u), p));
  mn = fminf(fminf(a, b), fminf(fminf(d, u), p));
}

// FCT betas of the owned cells (mpdata.py _fct_limit, first half): psi_n
// before the donor pass of the last iteration, psi after it, gx2/gz2 the
// antidiffusive courants to be limited
static __device__ void fct_betas(const Slab& g, const float* psi_n,
                                 const float* psi, const float* gx2,
                                 const float* gz2, const float* G, float* bup,
                                 float* bdn) {
  for2d(1, g.w + 1, g.nz, [&](int ci, int k) {
    float mx, mn, mx_n, mn_n;
    star_extrema(g, psi, ci, k, mx, mn);
    star_extrema(g, psi_n, ci, k, mx_n, mn_n);
    mx = fmaxf(mx, mx_n);
    mn = fminf(mn, mn_n);
    const float p = psi[g.c(ci, k)];
    const float fl = donor(psi[g.c(ci - 1, k)], p, gx2[g.fx(ci - 1, k)]);
    const float fr = donor(p, psi[g.c(ci + 1, k)], gx2[g.fx(ci, k)]);
    const float fb = donor(psi[g.c(ci, g.clampk(k - 1))], p, gz2[g.fz(ci, k)]);
    const float fa =
        donor(p, psi[g.c(ci, g.clampk(k + 1))], gz2[g.fz(ci, k + 1)]);
    const float f_in = fmaxf(fl, 0.0f) - fminf(fr, 0.0f) + fmaxf(fb, 0.0f)
                       - fminf(fa, 0.0f);
    const float f_out = fmaxf(fr, 0.0f) - fminf(fl, 0.0f) + fmaxf(fa, 0.0f)
                        - fminf(fb, 0.0f);
    bup[g.c(ci, k)] = frac((mx - p) * G[g.c(ci, k)], f_in);
    bdn[g.c(ci, k)] = frac((p - mn) * G[g.c(ci, k)], f_out);
  });
}

// FCT limit of each face by the donor's beta_dn and the receiver's beta_up
static __device__ void fct_limit(const Slab& g, const float* bup,
                                 const float* bdn, float* gx2, float* gz2) {
  for2d(0, g.w + 1, g.nz, [&](int fi, int k) {
    const int l = g.c(fi, k), r = g.c(fi + 1, k);
    const float c = gx2[g.fx(fi, k)];
    const float lim = c >= 0.0f ? fminf(1.0f, fminf(bdn[l], bup[r]))
                                : fminf(1.0f, fminf(bup[l], bdn[r]));
    gx2[g.fx(fi, k)] = c * lim;
  });
  for2d(1, g.w + 1, g.nz + 1, [&](int ci, int f) {
    const int d = g.c(ci, g.clampk(f - 1)), u = g.c(ci, g.clampk(f));
    const float c = gz2[g.fz(ci, f)];
    const float lim = c >= 0.0f ? fminf(1.0f, fminf(bdn[d], bup[u]))
                                : fminf(1.0f, fminf(bup[d], bdn[u]));
    gz2[g.fz(ci, f)] = c * lim;
  });
}

// The cluster's ring of slabs: after cluster.sync(), copy into ``a``'s
// halo columns (len values a column, ``stride`` apart) the left
// neighbour's last owned column and the right neighbour's first.
struct Ring {
  int left, right, w_left, w;
  __device__ void halo(cooperative_groups::cluster_group& cl, float* a,
                       int stride, int len) const {
    const float* l = cl.map_shared_rank(a, left);
    const float* r = cl.map_shared_rank(a, right);
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    const int nt = blockDim.x * blockDim.y;
    for (int k = t; k < len; k += nt) {
      a[k] = l[w_left * stride + k];
      a[(w + 1) * stride + k] = r[stride + k];
    }
  }
};

// The floats a slab of ``cols`` columns keeps in shared memory (kernel A's
// CTA, and a CTA of kernel D's MPDATA epilogue): psi before and after, G,
// the x faces twice, the z faces twice, and with ``fct`` the two betas.
inline size_t mpdata_floats(int cols, int nz, int fct) {
  const size_t nc = static_cast<size_t>(cols + 2) * nz;
  const size_t faces = static_cast<size_t>(cols + 1) * nz
                       + static_cast<size_t>(cols + 2) * (nz + 1);
  return (fct ? 5 : 3) * nc + 2 * faces;
}

}  // namespace lcp
