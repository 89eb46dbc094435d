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
//
// The turb_cond form (cond_flat_turb_kernel) is the same loop with the SGS
// supersaturation: each droplet's ssp advances by dt_sub * dot_ssp each
// substep and adds to its cell's RH (the JAX package's
// lgrngn/condensation.py:353-358, at each droplet's RH the TPU kernel
// takes), ssp and dot_ssp riding the compaction in two more scratch rows;
// its plain version is cond_flat_plain with ssp and dot_ssp.
//
// The parcel forms (cond_flat_parcel_kernel, and with the SGS
// supersaturation cond_flat_parcel_turb_kernel) run the loop of a parcel,
// whose one cell is 1 kg of dry air (cond_cell.cuh ParcelAir): a droplet
// weighs wnum / (dv rhod) in the cell sum with dv = 1 / rhod at each
// substep's rhod, where the grid forms take the cell volume dv.  Under
// var_rho, when a rising parcel's host passes a new rhod every step, the
// two differ; the JAX package's parcel diagnoses dv at every substep
// (libcloudphxx_tpu/lgrngn/hskpng.py:50, condensation.py:366).  Their
// plain version is cond_flat_plain on a parcel's configuration.
//
// The ice forms (cond_flat_ice_kernel<S, A>: on a grid or in a parcel,
// without and with the SGS supersaturation) replace the TPU kernel at its
// ice caller, the unsorted substep loop of the JAX package's
// lgrngn/condensation.py:248-305, which runs the root find and then
// lgrngn/ice.py:106 ice_dep_substep each substep.  After each substep's
// liquid growth and latent heat the frozen live SDs' semi-axes grow by
// forward Euler at the substep's closure (T, p, eta from before the
// latent heat) and the rv after it, with fresh mean free paths, and the
// cell's rv and th take the ice mass gained and the heat of deposition
// (cond_cell.cuh IceDep).  ice_a, ice_c and ice_rho ride the compaction in
// three more scratch rows (9, or 11 with the SGS supersaturation); a
// frozen SD (rw2 0) takes no liquid growth.  The cells out gain two rows:
// the th and rv of the last substep's closure, which the JAX loop leaves
// as the cells' closure.  Their plain version is cond_flat_plain with the
// ice.

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
// cells_out: 3 rows of n_cell: th rv rhod, and for the ice forms 2 more:
// the th and rv that the last substep's closure took
template <class S, class A, class I = NoIce>
__device__ __forceinline__ void cond_flat_body(
    const float* __restrict__ wgt, const float* __restrict__ rw2,
    const float* __restrict__ rd3, const float* __restrict__ kpa,
    const float* __restrict__ vt, const long long* __restrict__ ends,
    const float* __restrict__ cells_in, float* __restrict__ rw2_out,
    float* __restrict__ cells_out, const Compact& cs,
    const int* __restrict__ order, int n_cell, const CondOpts& o,
    const S& sg, const I& ice = I{}) {
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
  const CellOut out = cond_cell<FlatSeg, S, A, I>(src, begin, end, in, o,
                                                  rw2, rw2_out, cs, sg, ice);
  if ((threadIdx.x & 31) == 0) {
    cells_out[0 * n_cell + c] = out.th;
    cells_out[1 * n_cell + c] = out.rv;
    cells_out[2 * n_cell + c] = out.rhod;
    if constexpr (I::on) {
      cells_out[3 * n_cell + c] = out.th_c;
      cells_out[4 * n_cell + c] = out.rv_c;
    }
  }
}

__global__ void __launch_bounds__(32 * kCondWarps, 1)
cond_flat_kernel(const float* __restrict__ wgt, const float* __restrict__ rw2,
                 const float* __restrict__ rd3, const float* __restrict__ kpa,
                 const float* __restrict__ vt,
                 const long long* __restrict__ ends,
                 const float* __restrict__ cells_in,
                 float* __restrict__ rw2_out, float* __restrict__ cells_out,
                 Compact cs, const int* __restrict__ order, int n_cell,
                 CondOpts o) {
  cond_flat_body<NoSgs, CellAir>(wgt, rw2, rd3, kpa, vt, ends, cells_in,
                                 rw2_out, cells_out, cs, order, n_cell, o,
                                 NoSgs{});
}

// the turb_cond form: each droplet's ssp and dot_ssp ride the compaction
// (two more scratch rows) and its ssp comes back to its slot
__global__ void __launch_bounds__(32 * kCondWarps, 1)
cond_flat_turb_kernel(const float* __restrict__ wgt,
                      const float* __restrict__ rw2,
                      const float* __restrict__ rd3,
                      const float* __restrict__ kpa,
                      const float* __restrict__ vt,
                      const long long* __restrict__ ends,
                      const float* __restrict__ cells_in,
                      float* __restrict__ rw2_out,
                      float* __restrict__ cells_out, Compact cs,
                      const int* __restrict__ order, int n_cell, CondOpts o,
                      Sgs sg) {
  cond_flat_body<Sgs, CellAir>(wgt, rw2, rd3, kpa, vt, ends, cells_in,
                               rw2_out, cells_out, cs, order, n_cell, o, sg);
}

// the parcel forms: the cell is 1 kg of dry air (ParcelAir), without and
// with the SGS supersaturation
__global__ void __launch_bounds__(32 * kCondWarps, 1)
cond_flat_parcel_kernel(const float* __restrict__ wgt,
                        const float* __restrict__ rw2,
                        const float* __restrict__ rd3,
                        const float* __restrict__ kpa,
                        const float* __restrict__ vt,
                        const long long* __restrict__ ends,
                        const float* __restrict__ cells_in,
                        float* __restrict__ rw2_out,
                        float* __restrict__ cells_out, Compact cs,
                        const int* __restrict__ order, int n_cell,
                        CondOpts o) {
  cond_flat_body<NoSgs, ParcelAir>(wgt, rw2, rd3, kpa, vt, ends, cells_in,
                                   rw2_out, cells_out, cs, order, n_cell, o,
                                   NoSgs{});
}

__global__ void __launch_bounds__(32 * kCondWarps, 1)
cond_flat_parcel_turb_kernel(const float* __restrict__ wgt,
                             const float* __restrict__ rw2,
                             const float* __restrict__ rd3,
                             const float* __restrict__ kpa,
                             const float* __restrict__ vt,
                             const long long* __restrict__ ends,
                             const float* __restrict__ cells_in,
                             float* __restrict__ rw2_out,
                             float* __restrict__ cells_out, Compact cs,
                             const int* __restrict__ order, int n_cell,
                             CondOpts o, Sgs sg) {
  cond_flat_body<Sgs, ParcelAir>(wgt, rw2, rd3, kpa, vt, ends, cells_in,
                                 rw2_out, cells_out, cs, order, n_cell, o,
                                 sg);
}

// the ice forms: the loop with the deposition after each substep's liquid
// growth (IceDep), on a grid or in a parcel, without and with the SGS
// supersaturation
template <class S, class A>
__global__ void __launch_bounds__(32 * kCondWarps, 1)
cond_flat_ice_kernel(const float* __restrict__ wgt,
                     const float* __restrict__ rw2,
                     const float* __restrict__ rd3,
                     const float* __restrict__ kpa,
                     const float* __restrict__ vt,
                     const long long* __restrict__ ends,
                     const float* __restrict__ cells_in,
                     float* __restrict__ rw2_out,
                     float* __restrict__ cells_out, Compact cs,
                     const int* __restrict__ order, int n_cell, CondOpts o,
                     S sg, IceDep ice) {
  cond_flat_body<S, A, IceDep>(wgt, rw2, rd3, kpa, vt, ends, cells_in,
                               rw2_out, cells_out, cs, order, n_cell, o, sg,
                               ice);
}

}  // namespace lcp

namespace {

// the per-slot scratch and the options of a launch; warp w takes cell
// order[w]
lcp::Compact compact(int* pos, float* buf, int n_sd) {
  const long long m = n_sd;
  return lcp::Compact{pos,         buf,         buf + m,    buf + 2 * m,
                      buf + 3 * m, buf + 4 * m, buf + 5 * m};
}

lcp::CondOpts cond_opts(int sstp, double dt_sub, double RH_max, int th_dry,
                        int const_p, int rh_formula, int var_rho,
                        int iters) {
  return lcp::CondOpts{sstp,       static_cast<float>(dt_sub),
                       static_cast<float>(RH_max), th_dry, const_p,
                       rh_formula, var_rho,        iters};
}

int blocks_of(int n_cell) {
  return (n_cell + lcp::kCondWarps - 1) / lcp::kCondWarps;
}

// an ice form's launch: ``rows`` the scratch rows before the ice's three
// (6, or 8 with the SGS supersaturation)
template <class S, class A>
int launch_ice(const float* wgt, const float* rw2, const float* rd3,
               const float* kpa, const float* vt, const long long* ends,
               const float* cells_in, float* rw2_out, float* cells_out,
               int* pos, float* buf, const int* order, int n_cell, int n_sd,
               const lcp::CondOpts& o, const S& sg, int rows,
               const float* ice_a, const float* ice_c, const float* ice_rho,
               float* ice_a_out, float* ice_c_out, cudaStream_t stream) {
  if (n_cell <= 0) return 0;
  const long long m = n_sd;
  const lcp::IceDep ice{ice_a,        ice_c,
                        ice_rho,      ice_a_out,
                        ice_c_out,    buf + rows * m,
                        buf + (rows + 1) * m, buf + (rows + 2) * m};
  lcp::cond_flat_ice_kernel<S, A><<<blocks_of(n_cell), 32 * lcp::kCondWarps,
                                    0, stream>>>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out,
      compact(pos, buf, n_sd), order, n_cell, o, sg, ice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
  lcp::cond_flat_kernel<<<blocks_of(n_cell), 32 * lcp::kCondWarps, 0,
                          stream>>>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out,
      compact(pos, buf, n_sd), order, n_cell,
      cond_opts(sstp, dt_sub, RH_max, th_dry, const_p, rh_formula, var_rho,
                iters));
  return static_cast<int>(cudaGetLastError());
}

// lcp_cond_flat's arguments, ``buf`` of 8 * n_sd floats, and the sorted
// ssp and dot_ssp in, ssp out (n_sd each)
extern "C" int lcp_cond_flat_turb(
    const float* wgt, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const long long* ends, const float* cells_in,
    float* rw2_out, float* cells_out, int* pos, float* buf, const int* order,
    int n_cell, int n_sd, int sstp, double dt_sub, double RH_max, int th_dry,
    int const_p, int rh_formula, int var_rho, int iters, const float* ssp,
    const float* dssp, float* ssp_out, cudaStream_t stream) {
  if (n_cell <= 0) return 0;
  const long long m = n_sd;
  const lcp::Sgs sg{ssp, dssp, ssp_out, buf + 6 * m, buf + 7 * m};
  lcp::cond_flat_turb_kernel<<<blocks_of(n_cell), 32 * lcp::kCondWarps, 0,
                               stream>>>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out,
      compact(pos, buf, n_sd), order, n_cell,
      cond_opts(sstp, dt_sub, RH_max, th_dry, const_p, rh_formula, var_rho,
                iters),
      sg);
  return static_cast<int>(cudaGetLastError());
}

// the parcel forms: lcp_cond_flat's and lcp_cond_flat_turb's arguments
// (the cells' dv is not read: a parcel's is 1 / rhod at each substep)
extern "C" int lcp_cond_flat_parcel(
    const float* wgt, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const long long* ends, const float* cells_in,
    float* rw2_out, float* cells_out, int* pos, float* buf, const int* order,
    int n_cell, int n_sd, int sstp, double dt_sub, double RH_max, int th_dry,
    int const_p, int rh_formula, int var_rho, int iters,
    cudaStream_t stream) {
  if (n_cell <= 0) return 0;
  lcp::cond_flat_parcel_kernel<<<blocks_of(n_cell), 32 * lcp::kCondWarps, 0,
                                 stream>>>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out,
      compact(pos, buf, n_sd), order, n_cell,
      cond_opts(sstp, dt_sub, RH_max, th_dry, const_p, rh_formula, var_rho,
                iters));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lcp_cond_flat_parcel_turb(
    const float* wgt, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const long long* ends, const float* cells_in,
    float* rw2_out, float* cells_out, int* pos, float* buf, const int* order,
    int n_cell, int n_sd, int sstp, double dt_sub, double RH_max, int th_dry,
    int const_p, int rh_formula, int var_rho, int iters, const float* ssp,
    const float* dssp, float* ssp_out, cudaStream_t stream) {
  if (n_cell <= 0) return 0;
  const long long m = n_sd;
  const lcp::Sgs sg{ssp, dssp, ssp_out, buf + 6 * m, buf + 7 * m};
  lcp::cond_flat_parcel_turb_kernel<<<blocks_of(n_cell),
                                      32 * lcp::kCondWarps, 0, stream>>>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out,
      compact(pos, buf, n_sd), order, n_cell,
      cond_opts(sstp, dt_sub, RH_max, th_dry, const_p, rh_formula, var_rho,
                iters),
      sg);
  return static_cast<int>(cudaGetLastError());
}

// the ice forms: lcp_cond_flat's (and lcp_cond_flat_turb's) arguments,
// ``buf`` of 9 (11) * n_sd floats and ``cells_out`` of 5 rows, then the
// sorted ice_a, ice_c and ice_rho in and ice_a and ice_c out (n_sd each)
extern "C" int lcp_cond_flat_ice(
    const float* wgt, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const long long* ends, const float* cells_in,
    float* rw2_out, float* cells_out, int* pos, float* buf, const int* order,
    int n_cell, int n_sd, int sstp, double dt_sub, double RH_max, int th_dry,
    int const_p, int rh_formula, int var_rho, int iters, const float* ice_a,
    const float* ice_c, const float* ice_rho, float* ice_a_out,
    float* ice_c_out, cudaStream_t stream) {
  return launch_ice<lcp::NoSgs, lcp::CellAir>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out, pos, buf,
      order, n_cell, n_sd,
      cond_opts(sstp, dt_sub, RH_max, th_dry, const_p, rh_formula, var_rho,
                iters),
      lcp::NoSgs{}, 6, ice_a, ice_c, ice_rho, ice_a_out, ice_c_out, stream);
}

extern "C" int lcp_cond_flat_ice_turb(
    const float* wgt, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const long long* ends, const float* cells_in,
    float* rw2_out, float* cells_out, int* pos, float* buf, const int* order,
    int n_cell, int n_sd, int sstp, double dt_sub, double RH_max, int th_dry,
    int const_p, int rh_formula, int var_rho, int iters, const float* ssp,
    const float* dssp, float* ssp_out, const float* ice_a,
    const float* ice_c, const float* ice_rho, float* ice_a_out,
    float* ice_c_out, cudaStream_t stream) {
  const long long m = n_sd;
  return launch_ice<lcp::Sgs, lcp::CellAir>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out, pos, buf,
      order, n_cell, n_sd,
      cond_opts(sstp, dt_sub, RH_max, th_dry, const_p, rh_formula, var_rho,
                iters),
      lcp::Sgs{ssp, dssp, ssp_out, buf + 6 * m, buf + 7 * m}, 8, ice_a,
      ice_c, ice_rho, ice_a_out, ice_c_out, stream);
}

extern "C" int lcp_cond_flat_parcel_ice(
    const float* wgt, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const long long* ends, const float* cells_in,
    float* rw2_out, float* cells_out, int* pos, float* buf, const int* order,
    int n_cell, int n_sd, int sstp, double dt_sub, double RH_max, int th_dry,
    int const_p, int rh_formula, int var_rho, int iters, const float* ice_a,
    const float* ice_c, const float* ice_rho, float* ice_a_out,
    float* ice_c_out, cudaStream_t stream) {
  return launch_ice<lcp::NoSgs, lcp::ParcelAir>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out, pos, buf,
      order, n_cell, n_sd,
      cond_opts(sstp, dt_sub, RH_max, th_dry, const_p, rh_formula, var_rho,
                iters),
      lcp::NoSgs{}, 6, ice_a, ice_c, ice_rho, ice_a_out, ice_c_out, stream);
}

extern "C" int lcp_cond_flat_parcel_ice_turb(
    const float* wgt, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const long long* ends, const float* cells_in,
    float* rw2_out, float* cells_out, int* pos, float* buf, const int* order,
    int n_cell, int n_sd, int sstp, double dt_sub, double RH_max, int th_dry,
    int const_p, int rh_formula, int var_rho, int iters, const float* ssp,
    const float* dssp, float* ssp_out, const float* ice_a,
    const float* ice_c, const float* ice_rho, float* ice_a_out,
    float* ice_c_out, cudaStream_t stream) {
  const long long m = n_sd;
  return launch_ice<lcp::Sgs, lcp::ParcelAir>(
      wgt, rw2, rd3, kpa, vt, ends, cells_in, rw2_out, cells_out, pos, buf,
      order, n_cell, n_sd,
      cond_opts(sstp, dt_sub, RH_max, th_dry, const_p, rh_formula, var_rho,
                iters),
      lcp::Sgs{ssp, dssp, ssp_out, buf + 6 * m, buf + 7 * m}, 8, ice_a,
      ice_c, ice_rho, ice_a_out, ice_c_out, stream);
}
