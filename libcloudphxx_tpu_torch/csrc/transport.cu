// Kernel C: transport, walls/puddle and the re-binning classification.
//
// Replaces the transport phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 338-403: vt refresh,
// implicit/euler advection, sedimentation, periodic/open walls, puddle
// partials) and the classification half of its re-binning epilogue
// (lines 414-487: target cell, far-mover flag).  Plain version: ops/step.py
// transport_plain.
//
// What bounds it on the card: memory.  It reads n for every slot and rw2,
// x and z for the live ones (rd3 only for a droplet that falls into the
// puddle), and writes n, x, z, vt and the target of every slot, with some
// 100 operations of arithmetic a live droplet (vt_beard77's log, exp and
// divisions under -fmad=false).
// What the design does about it: a warp a row in the layout of
// warp_rows.cuh (four consecutive slots a lane, 16-byte loads and stores
// at capacities that are multiples of 128), no __syncthreads() and no
// shared memory; the row's cell fields are loaded once a warp.  Slots dead
// at load (n == 0) skip vt, advection and walls and write n = x = z = vt =
// 0 and target -1, and a lane whose four slots are dead reads nothing but
// n.  The puddle partials and the far flag reduce by warp shuffle, the
// partials only in rows where a droplet fell (__any_sync).  The puddle is
// written as per-row partials that the caller sums: no float atomics, so it
// repeats run to run.  The TPU kernel merges the z movers in the same pass;
// here the merge is kernel D (merge.cu), which reads the targets written
// here once every row has them.

#include <cuda_runtime.h>

#include "physics.cuh"
#include "warp_rows.cuh"

namespace lcp {

struct Geometry {
  int nx, nz;
  float dx, dz, dt;
  float x0, z0, wx, wz, x1, z1;
  int implicit_adve, do_sedi, open_side, periodic_topbot;
};

__device__ __forceinline__ float warp_sum(float v) {
  // a fixed butterfly: every lane ends with the same bits, run to run
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// cells: 8 rows of n_cell: T p rhod eta C_l C_r C_b C_a
// rowinfo: (n_cell, 8): liq_vol dry_vol liq_num prt_num far 0 0 0
template <bool VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
transport_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
                 const float* __restrict__ rd3, const float* __restrict__ x,
                 const float* __restrict__ z, const float* __restrict__ cells,
                 float* __restrict__ n_out, float* __restrict__ x_out,
                 float* __restrict__ z_out, float* __restrict__ vt_out,
                 int* __restrict__ tgt_out, float* __restrict__ rowinfo,
                 int n_cell, int cap, Geometry geo) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= n_cell) return;  // the whole warp
  const float i_row = static_cast<float>(r / geo.nz);
  const float k_row = static_cast<float>(r % geo.nz);
  const float p = __ldg(cells + 1 * n_cell + r);
  const float rhod = __ldg(cells + 2 * n_cell + r);
  const float eta = __ldg(cells + 3 * n_cell + r);
  const float C_l = __ldg(cells + 4 * n_cell + r);
  const float C_r = __ldg(cells + 5 * n_cell + r);
  const float C_b = __ldg(cells + 6 * n_cell + r);
  const float C_a = __ldg(cells + 7 * n_cell + r);
  const float dCx = C_r - C_l;
  const float dCz = C_a - C_b;

  float liq_vol = 0.0f, dry_vol = 0.0f, liq_num = 0.0f, prt_num = 0.0f;
  bool fell = false, far = false;
  const size_t base = static_cast<size_t>(r) * cap;
  for (int l0 = 4 * lane; l0 < cap; l0 += kTile) {
    const size_t off = base + l0;
    float nn[4], xx[4] = {}, zz[4] = {}, vt[4] = {};
    int tgt[4] = {-1, -1, -1, -1};
    load4<VEC>(n, off, l0, cap, 0.0f, nn);
    if (nn[0] > 0.0f || nn[1] > 0.0f || nn[2] > 0.0f || nn[3] > 0.0f) {
      float w2[4], xi[4], zi[4];
      load4<VEC>(rw2, off, l0, cap, 0.0f, w2);
      load4<VEC>(x, off, l0, cap, 0.0f, xi);
      load4<VEC>(z, off, l0, cap, 0.0f, zi);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(nn[q] > 0.0f)) {
          nn[q] = 0.0f;
          continue;
        }
        float m = nn[q], xq = xi[q], zq = zi[q];
        vt[q] = vt_beard77(w2[q], p, rhod, eta);
        if (geo.implicit_adve) {
          xq = (xq + geo.dx * (C_l - i_row * dCx)) / (1.0f - dCx);
          zq = (zq + geo.dz * (C_b - k_row * dCz)) / (1.0f - dCz);
        } else {  // euler
          xq = xq + dCx * (xq - geo.dx * i_row) + geo.dx * C_l;
          zq = zq + dCz * (zq - geo.dz * k_row) + geo.dz * C_b;
        }
        if (geo.do_sedi) zq = zq - geo.dt * vt[q];

        if (!geo.open_side) {
          const float s = xq - geo.x0;
          xq = geo.x0 + (s - floorf(s / geo.wx) * geo.wx);
        } else if (xq >= geo.x1 || xq < geo.x0) {
          m = 0.0f;
        }
        if (geo.periodic_topbot) {
          const float s = zq - geo.z0;
          zq = geo.z0 + (s - floorf(s / geo.wz) * geo.wz);
        } else {
          if (zq >= geo.z1) m = 0.0f;
          if (zq < geo.z0 && m > 0.0f) {
            // the droplet falls through the bottom into the puddle
            const float w = w2[q];
            liq_vol += F((4.0 / 3) * pi) * m * w * sqrtf(fmaxf(w, 0.0f));
            dry_vol += F((4.0 / 3) * pi) * m * __ldg(rd3 + off + q);
            liq_num += w > 0.0f ? m : 0.0f;
            prt_num += m;
            fell = true;
            m = 0.0f;
          }
        }

        // target cell: the same float math as the TPU kernel (the grid
        // starts at 0, not at x0); movers by more than one cell on an axis
        // stay in their row and raise the flag for the global re-bin
        if (m > 0.0f) {
          const float k_t = fminf(fmaxf(floorf(zq / geo.dz), 0.0f),
                                  static_cast<float>(geo.nz - 1));
          const float i_t = fminf(fmaxf(floorf(xq / geo.dx), 0.0f),
                                  static_cast<float>(geo.nx - 1));
          const float dk = k_t - k_row;
          const float di = i_t - i_row;
          const float wrap = static_cast<float>(geo.nx - 1);
          const bool near_z = fabsf(dk) <= 1.0f;
          const bool near_x = di == 0.0f || di == 1.0f || di == -1.0f
                              || di == wrap || di == -wrap;
          if (near_z && near_x) {
            tgt[q] = static_cast<int>(i_t) * geo.nz + static_cast<int>(k_t);
          } else {
            tgt[q] = r;
            far = true;
          }
        }
        nn[q] = m;
        xx[q] = xq;
        zz[q] = zq;
      }
    }
    store4<VEC>(n_out, off, l0, cap, nn);
    store4<VEC>(x_out, off, l0, cap, xx);
    store4<VEC>(z_out, off, l0, cap, zz);
    store4<VEC>(vt_out, off, l0, cap, vt);
    store4<VEC>(tgt_out, off, l0, cap, tgt);
  }

  if (__any_sync(kAll, fell)) {
    liq_vol = warp_sum(liq_vol);
    dry_vol = warp_sum(dry_vol);
    liq_num = warp_sum(liq_num);
    prt_num = warp_sum(prt_num);
  }
  const float far_row = __any_sync(kAll, far) ? 1.0f : 0.0f;
  if (lane < 8) {
    const float info[8] = {liq_vol, dry_vol, liq_num, prt_num, far_row,
                           0.0f, 0.0f, 0.0f};
    float v = info[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) v = lane == j ? info[j] : v;
    rowinfo[static_cast<size_t>(r) * 8 + lane] = v;
  }
}

}  // namespace lcp

extern "C" int lcp_transport(const float* n, const float* rw2, const float* rd3,
                             const float* x, const float* z,
                             const float* cells, float* n_out, float* x_out,
                             float* z_out, float* vt_out, int* tgt_out,
                             float* rowinfo, int n_cell, int cap, int nx,
                             int nz, double dx, double dz, double dt,
                             double x0, double x1, double z0, double z1,
                             int implicit_adve, int do_sedi, int open_side,
                             int periodic_topbot,
                             cudaStream_t stream) {
  lcp::Geometry geo{nx, nz,
                    static_cast<float>(dx), static_cast<float>(dz),
                    static_cast<float>(dt), static_cast<float>(x0),
                    static_cast<float>(z0), static_cast<float>(x1 - x0),
                    static_cast<float>(z1 - z0), static_cast<float>(x1),
                    static_cast<float>(z1), implicit_adve, do_sedi,
                    open_side, periodic_topbot};
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, x, z, n_out, x_out, z_out, vt_out, tgt_out});
  const dim3 grid(lcp::row_blocks(n_cell)), block(lcp::kWarpRows * 32);
  if (vec)
    lcp::transport_kernel<true><<<grid, block, 0, stream>>>(
        n, rw2, rd3, x, z, cells, n_out, x_out, z_out, vt_out, tgt_out,
        rowinfo, n_cell, cap, geo);
  else
    lcp::transport_kernel<false><<<grid, block, 0, stream>>>(
        n, rw2, rd3, x, z, cells, n_out, x_out, z_out, vt_out, tgt_out,
        rowinfo, n_cell, cap, geo);
  return static_cast<int>(cudaGetLastError());
}
