// Kernel G, fixed-count form: the whole exact per-particle condensation
// phase in one launch.
//
// Replaces the TPU kernel libcloudphxx_tpu/ops/pallas_cond.py:_kernel
// (advance_rw2_pallas) with the substep loop the JAX package runs around
// it in XLA: lgrngn/condensation.py:468 (cond_perparticle) and
// lgrngn/dense.py:359 (step_cond_exact).  Each of sstp_cond substeps adds
// a share of the step's increments to every super-droplet's private th,
// rv, rhod (and p under const_p), closes it there, grows the SD at that
// state and feeds the vapour of its d(rw^3) and the heat that goes with
// it back: with sstp_cond_mix to every SD of its cell, without it to
// itself.  Plain version: ops/cond.py perparticle_fixed_plain
// (lgrngn/condensation.py perparticle_fixed_core over the same layout).
//
// What bounds it on the card: instruction issue.  A bracketed SD
// evaluates drw2_dt 15 times a substep (14 IEEE divisions, 9 exp/log and
// a square root each under -fmad=false) beside its closure, against ~56
// bytes a live SD read or written once a phase.  The first design
// launched the one-substep kernel G (cond_sd.cu) once a substep,
// with ~85 elementwise PyTorch launches around each and the cell sums in
// float64 cumulative sums, over every slot of the dense planes, dead or
// not.
// What the design does about it: one warp a cell for the whole phase, 8
// cells a block, the cells in order (the dense rows, or the flat engine's
// cell-sorted segments through ``order``, as kernel F takes them).  A
// cell's values are read once, its stale mean free paths computed from
// its T and p at the start of the step (hskpng_mfp's operations).  The
// warp ranks the SDs it advances (n > 0, or rw2 > 0, which the plain
// version grows too) by ballot; every other slot is copied through (its
// rw2, and its private values, which no caller reads: the cells close on
// the live SDs and sstp_save overwrites them) with no growth rate and no
// division.  Lane j takes the ranked SDs j, j+32, ...; an SD's state
// lives in the output arrays between substeps (cached in L1/L2), so a
// cell of any size runs the same loop.  With mixing the cell sums are a
// float64 __shfl_xor_sync butterfly over the warp; each SD stores its
// pre-feedback state and takes the sums at the start of the next substep
// (and after the last one, in a pass of its own), so that a cell of more
// than 32 SDs sums over all its chunks before any SD applies the sums.
// Every other operation is the plain version's in its order (the library
// is built with -fmad=false): without mixing rw2 and the private state of
// every advanced SD are bitwise the plain version's; with mixing the sums
// add in another order than the plain version's (a float64 cumulative
// sum differenced at the cell ends; torch.sum over a row).

#include <cuda_runtime.h>

#include "cond_cell.cuh"

namespace lcp {

__global__ void __launch_bounds__(32 * kCondWarps)
cond_sd_fixed_kernel(SdIn in, SdCells cells, SdLayout L, SdOut out,
                     int* __restrict__ pos, int n_cell, CondOpts o, int mix) {
  const int c = blockIdx.x * kCondWarps + (threadIdx.x >> 5);
  if (c >= n_cell) return;
  const int lane = threadIdx.x & 31;
  long long begin, end;
  L.segment(c, begin, end);
  const SdCell a = SdCell::of(cells, c);
  const int nsd = rank_sds(
      L, begin, end, pos,
      [&](long long j) { return in.n[j] > 0.0f || in.rw2[j] > 0.0f; },
      [&](long long j) { out.keep(in, j); });
  if (nsd == 0) return;
  const int n_chunk = (nsd + 31) >> 5;
  float sum_rv = 0.0f, sum_th = 0.0f;  // mixing: the last substep's sums
  for (int s = 0; s < o.sstp; ++s) {
    // the state at the end of the last substep
    const SdIn st = s == 0 ? in : SdIn{in.n, out.rw2, in.rd3, in.kpa, in.vt,
                                       out.th, out.rv, out.rh, out.p};
    double part_rv = 0.0, part_th = 0.0;
    for (int ch = 0; ch < n_chunk; ++ch) {
      // lanes past the last SD take its values, masked
      const int i = ch * 32 + lane;
      const bool on = i < nsd;
      const long long j = pos[begin + min(i, nsd - 1)];
      const float n = in.n[j];
      const float w = st.rw2[j];
      float th = st.th[j], rv = st.rv[j], rh = st.rh[j], p = st.p[j];
      if (mix && s > 0) {
        rv = rv + sum_rv;
        th = th + sum_th;
      }
      // the increments: the cell's value minus the SD's at the last save
      const float base_rv = rv + div_s(a.rv - in.rv[j], o.sstp);
      const float base_th = th + div_s(a.th - in.th[j], o.sstp);
      rh = rh + div_s(a.rhod - in.rh[j], o.sstp);
      if (o.const_p) p = p + div_s(a.p - in.p[j], o.sstp);
      const Closure cl = sd_closure(o.th_dry, o.const_p, o.rh_formula,
                                    base_th, base_rv, rh, p);
      const float w_new = sd_advance(on, w, in.rd3[j], in.kpa[j], in.vt[j],
                                     cl, rh, base_rv, a.lam_D, a.lam_K, o);
      const bool live = n > 0.0f;
      const float drw3 = live ? rw3_of(w_new) - rw3_of(w) : 0.0f;
      const float drv = drw3 * F(kDrvMlt) * n / rh / a.dv;
      const float dth = live ? drv * d_th_d_rv(cl.T, base_th) : 0.0f;
      if (mix) {
        part_rv += on ? static_cast<double>(drv) : 0.0;
        part_th += on ? static_cast<double>(dth) : 0.0;
      }
      if (on) {
        out.rw2[j] = w_new;
        out.rv[j] = mix ? base_rv : base_rv + drv;
        out.th[j] = mix ? base_th : base_th + dth;
        out.rh[j] = rh;
        out.p[j] = p;
      }
    }
    if (mix) {
      sum_rv = static_cast<float>(warp_sum(part_rv));
      sum_th = static_cast<float>(warp_sum(part_th));
    }
  }
  if (mix) {
    for (int i = lane; i < nsd; i += 32) {
      const long long j = pos[begin + i];
      out.rv[j] = out.rv[j] + sum_rv;
      out.th[j] = out.th[j] + sum_th;
    }
  }
}

}  // namespace lcp

// SD arrays (n_slots each, slot order): n rw2 rd3 kpa vt, the private th
// rv rhod p; cells (n_cell each): th rv rhod p dv, and T and p at the
// start of the step (the stale mean free paths'); the layout
// (order, ends and sijk, int64, or null for the dense (n_cell, cap)
// rows); outputs (n_slots each): rw2 th rv rhod p; ``pos`` scratch of
// n_slots ints
extern "C" int lcp_cond_sd_fixed(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const float* th0, const float* rv0, const float* rh0,
    const float* p0, const float* th, const float* rv, const float* rhod,
    const float* p, const float* dv, const float* T_mfp, const float* p_mfp,
    const long long* order, const long long* ends, const long long* sijk,
    float* rw2_out, float* th_out, float* rv_out, float* rh_out,
    float* p_out, int* pos, int n_cell, int cap, int sstp, double dt,
    double RH_max, int th_dry, int const_p, int rh_formula, int mix,
    int iters, cudaStream_t stream) {
  if (n_cell <= 0) return 0;
  const lcp::SdIn in{n, rw2, rd3, kpa, vt, th0, rv0, rh0, p0};
  const lcp::SdCells cells{th, rv, rhod, p, dv, T_mfp, p_mfp, nullptr};
  const lcp::SdLayout L{order, ends, sijk, cap};
  const lcp::SdOut out{rw2_out, th_out, rv_out, rh_out, p_out};
  const lcp::CondOpts o{sstp, static_cast<float>(dt / sstp),
                        static_cast<float>(RH_max), th_dry, const_p,
                        rh_formula, 0, iters};
  const int blocks = (n_cell + lcp::kCondWarps - 1) / lcp::kCondWarps;
  lcp::cond_sd_fixed_kernel<<<blocks, 32 * lcp::kCondWarps, 0, stream>>>(
      in, cells, L, out, pos, n_cell, o, mix);
  return static_cast<int>(cudaGetLastError());
}
