// Kernel F: the flat engine's per-cell condensation substep loop.
//
// Replaces the TPU kernel libcloudphxx_tpu/ops/pallas_cond.py:_kernel
// (advance_rw2_pallas), the per-droplet root find the JAX flat engine calls
// sstp_cond times a step from a host loop that gathers the cell values to
// every droplet and sums each cell's latent heat between the calls.  Here
// the whole loop is one launch a step: every substep's closure, root finds
// and cell sums run per cell on the card.
// Plain version: ops/cond.py cond_flat_plain (that host loop, over
// lgrngn/condensation.py _advance_rw2_core).
//
// What bounds it on the card: instruction issue, as for kernel B: a
// bracketed droplet evaluates drw2_dt 15 times a substep, each 14 IEEE
// divisions, 9 exp/log and a square root under -fmad=false, against ~24
// bytes a droplet read or written once a step.  The first design ran one
// thread per droplet over twelve gathered arrays, once a substep, beside
// ~70 small PyTorch launches a substep for the gathers, the closure and the
// cumulative-sum cell sums.
// What the design does about it: the warp-per-cell routine of
// cond_cell.cuh on the cell-sorted segments [ends[c-1] + 1, ends[c] + 1),
// the longest first: the cell values are read once a cell, the sums are
// warp butterflies, the live droplets (weight > 0) are ranked by ballot,
// and the dead slots, which the flat engine keeps in cell 0, are read 256
// at a time a scan step and copied through.  Its device time is above
// that of the first design's sstp_cond launches (a cell's 48-80 droplets
// take 2-3 chunks of 32 lanes, the last partly idle; PERF.md section 6);
// what it saves is the host loop around them.

#include <cuda_runtime.h>

#include "cond_cell.cuh"

namespace lcp {

// A cell-sorted segment's droplets: weight numerators, rd3, kappa, vt
struct FlatSeg {
  const float* __restrict__ wgt;
  const float* __restrict__ rd3;
  const float* __restrict__ kpa;
  const float* __restrict__ vt;
  __device__ __forceinline__ float wnum(long long i) const { return wgt[i]; }
  __device__ __forceinline__ CondDrop drop(long long i, float rw2,
                                           float wn) const {
    return make_drop(i, rw2, rd3[i], kpa[i], vt[i], wn);
  }
};

// cells_in: 10 rows of n_cell: dth drv drh (the step's increments) th rv
// rhod (at the last sstp_save) p dv lamD lamK
// cells_out: 3 rows of n_cell: th rv rhod
__global__ void __launch_bounds__(32 * kCondWarps, 1)
cond_flat_kernel(const float* __restrict__ wgt, const float* __restrict__ rw2,
                 const float* __restrict__ rd3, const float* __restrict__ kpa,
                 const float* __restrict__ vt,
                 const long long* __restrict__ ends,
                 const float* __restrict__ cells_in,
                 float* __restrict__ rw2_out, float* __restrict__ cells_out,
                 Compact cs, const int* __restrict__ order, int n_cell,
                 CondOpts o) {
  const int w = blockIdx.x * kCondWarps + (threadIdx.x >> 5);
  if (w >= n_cell) return;
  const int c = order[w];
  const float* col = cells_in + c;
  CellIn in;
  in.dth = div_s(col[0 * n_cell], o.sstp);
  in.drv = div_s(col[1 * n_cell], o.sstp);
  in.drh = div_s(col[2 * n_cell], o.sstp);
  in.th = col[3 * n_cell];
  in.rv = col[4 * n_cell];
  in.rhod = col[5 * n_cell];
  in.p0 = col[6 * n_cell];
  in.dv = col[7 * n_cell];
  in.lam_D = col[8 * n_cell];
  in.lam_K = col[9 * n_cell];
  const long long begin = c == 0 ? 0 : ends[c - 1] + 1;
  const long long end = ends[c] + 1;
  const FlatSeg src{wgt, rd3, kpa, vt};
  const CellOut out = cond_cell(src, begin, end, in, o, rw2, rw2_out, cs);
  if ((threadIdx.x & 31) == 0) {
    cells_out[0 * n_cell + c] = out.th;
    cells_out[1 * n_cell + c] = out.rv;
    cells_out[2 * n_cell + c] = out.rhod;
  }
}

}  // namespace lcp

// SD arrays (cell-sorted, n_sd each): weight numerators, rw2, rd3, kappa,
// vt; ends (n_cell int64); ``pos`` and ``buf`` scratch of n_sd ints and
// 6 * n_sd floats; warp w takes cell order[w]
extern "C" int lcp_cond_flat(const float* wgt, const float* rw2,
                             const float* rd3, const float* kpa,
                             const float* vt, const long long* ends,
                             const float* cells_in, float* rw2_out,
                             float* cells_out, int* pos, float* buf,
                             const int* order, int n_cell, int n_sd,
                             int sstp, double dt_sub, double RH_max,
                             int th_dry, int const_p, int rh_formula,
                             int var_rho, int iters, cudaStream_t stream) {
  if (n_cell <= 0) return 0;
  const long long m = n_sd;
  const lcp::Compact cs{pos,         buf,         buf + m,    buf + 2 * m,
                        buf + 3 * m, buf + 4 * m, buf + 5 * m};
  const lcp::CondOpts o{sstp, static_cast<float>(dt_sub),
                        static_cast<float>(RH_max), th_dry, const_p,
                        rh_formula, var_rho, iters};
  const int blocks = (n_cell + lcp::kCondWarps - 1) / lcp::kCondWarps;
  lcp::cond_flat_kernel<<<blocks, 32 * lcp::kCondWarps, 0, stream>>>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out, cs, order,
      n_cell, o);
  return static_cast<int>(cudaGetLastError());
}
