// Kernel C: transport, walls/puddle and the re-binning classification.
//
// Replaces the transport phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 338-403: vt refresh,
// implicit/euler advection, sedimentation, periodic/open walls, puddle
// partials) and the classification half of its re-binning epilogue
// (lines 414-487: target cell, far-mover flag).  Plain version: ops/step.py
// transport_plain.
//
// What bounds it on the card: memory.  Each droplet is read once (n, rw2,
// rd3, x, z: 20 bytes) and written once (n, x, z, vt, target: 20 bytes)
// with a few dozen flops of arithmetic.
// What the design does about it: one pass, one thread per droplet lane and
// one block per cell row, so the row's courants and thermodynamics load
// once per block and the puddle and flag reduce within the block.  The
// puddle is written as per-row partials that the caller sums: no float
// atomics, so the puddle repeats run to run.  The TPU kernel merges the z
// movers in the same pass; here the merge is kernel D (merge.cu), which
// reads the targets written below once every row has them.

#include <cuda_runtime.h>

#include "physics.cuh"

namespace lcp {

struct Geometry {
  int nx, nz;
  float dx, dz, dt;
  float x0, z0, wx, wz, x1, z1;
  int implicit_adve, do_sedi, open_side, periodic_topbot;
};

// cells: 8 rows of n_cell: T p rhod eta C_l C_r C_b C_a
// rowinfo: (n_cell, 8): liq_vol dry_vol liq_num prt_num far 0 0 0
__global__ void __launch_bounds__(128)
transport_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
                 const float* __restrict__ rd3, const float* __restrict__ x,
                 const float* __restrict__ z, const float* __restrict__ cells,
                 float* __restrict__ n_out, float* __restrict__ x_out,
                 float* __restrict__ z_out, float* __restrict__ vt_out,
                 int* __restrict__ tgt_out, float* __restrict__ rowinfo,
                 int n_cell, int cap, Geometry geo) {
  __shared__ float s_red[128 / 32 + 1];
  const int r = blockIdx.x;
  const float i_row = static_cast<float>(r / geo.nz);
  const float k_row = static_cast<float>(r % geo.nz);
  const float p = cells[1 * n_cell + r];
  const float rhod = cells[2 * n_cell + r];
  const float eta = cells[3 * n_cell + r];
  const float C_l = cells[4 * n_cell + r];
  const float C_r = cells[5 * n_cell + r];
  const float C_b = cells[6 * n_cell + r];
  const float C_a = cells[7 * n_cell + r];
  const float dCx = C_r - C_l;
  const float dCz = C_a - C_b;

  float liq_vol = 0.0f, dry_vol = 0.0f, liq_num = 0.0f, prt_num = 0.0f;
  float far = 0.0f;
  const size_t base = static_cast<size_t>(r) * cap;
  for (int l = threadIdx.x; l < cap; l += blockDim.x) {
    float nn = n[base + l];
    const float w2 = rw2[base + l];
    float xx = x[base + l];
    float zz = z[base + l];
    const float vt = vt_beard77(w2, p, rhod, eta);

    if (geo.implicit_adve) {
      xx = (xx + geo.dx * (C_l - i_row * dCx)) / (1.0f - dCx);
      zz = (zz + geo.dz * (C_b - k_row * dCz)) / (1.0f - dCz);
    } else {  // euler
      xx = xx + dCx * (xx - geo.dx * i_row) + geo.dx * C_l;
      zz = zz + dCz * (zz - geo.dz * k_row) + geo.dz * C_b;
    }
    if (geo.do_sedi) zz = zz - geo.dt * vt;

    if (!geo.open_side) {
      const float q = xx - geo.x0;
      xx = geo.x0 + (q - floorf(q / geo.wx) * geo.wx);
    } else if (xx >= geo.x1 || xx < geo.x0) {
      nn = 0.0f;
    }
    if (geo.periodic_topbot) {
      const float q = zz - geo.z0;
      zz = geo.z0 + (q - floorf(q / geo.wz) * geo.wz);
    } else {
      if (zz >= geo.z1) nn = 0.0f;
      if (zz < geo.z0 && nn > 0.0f) {
        // the droplet falls through the bottom into the puddle
        liq_vol += F((4.0 / 3) * pi) * nn * w2 * sqrtf(fmaxf(w2, 0.0f));
        dry_vol += F((4.0 / 3) * pi) * nn * rd3[base + l];
        liq_num += w2 > 0.0f ? nn : 0.0f;
        prt_num += nn;
        nn = 0.0f;
      }
    }

    // target cell: the same float math as the TPU kernel (the grid starts
    // at 0, not at x0); movers by more than one cell on an axis stay in
    // their row and raise the flag for the global re-bin
    int tgt = -1;
    if (nn > 0.0f) {
      const float k_t = fminf(fmaxf(floorf(zz / geo.dz), 0.0f),
                              static_cast<float>(geo.nz - 1));
      const float i_t = fminf(fmaxf(floorf(xx / geo.dx), 0.0f),
                              static_cast<float>(geo.nx - 1));
      const float dk = k_t - k_row;
      const float di = i_t - i_row;
      const float wrap = static_cast<float>(geo.nx - 1);
      const bool near_z = fabsf(dk) <= 1.0f;
      const bool near_x = di == 0.0f || di == 1.0f || di == -1.0f
                          || di == wrap || di == -wrap;
      if (near_z && near_x) {
        tgt = static_cast<int>(i_t) * geo.nz + static_cast<int>(k_t);
      } else {
        tgt = r;
        far = 1.0f;
      }
    }
    n_out[base + l] = nn;
    x_out[base + l] = xx;
    z_out[base + l] = zz;
    vt_out[base + l] = vt;
    tgt_out[base + l] = tgt;
  }

  liq_vol = block_sum(liq_vol, s_red);
  dry_vol = block_sum(dry_vol, s_red);
  liq_num = block_sum(liq_num, s_red);
  prt_num = block_sum(prt_num, s_red);
  far = block_sum(far, s_red);
  if (threadIdx.x == 0) {
    float* info = rowinfo + static_cast<size_t>(r) * 8;
    info[0] = liq_vol;
    info[1] = dry_vol;
    info[2] = liq_num;
    info[3] = prt_num;
    info[4] = far > 0.0f ? 1.0f : 0.0f;
    info[5] = info[6] = info[7] = 0.0f;
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
  lcp::transport_kernel<<<n_cell, 128, 0, stream>>>(
      n, rw2, rd3, x, z, cells, n_out, x_out, z_out, vt_out, tgt_out, rowinfo,
      n_cell, cap, geo);
  return static_cast<int>(cudaGetLastError());
}
