// Kernel G, adaptive form: the whole adaptive per-particle condensation
// phase in one launch.
//
// Replaces the TPU kernel libcloudphxx_tpu/ops/pallas_cond.py:_kernel
// (advance_rw2_pallas) with the loops the JAX package runs around it in
// XLA: lgrngn/condensation.py:684 (perparticle_adaptive_core) and
// lgrngn/dense.py:456 (step_cond_adaptive).  Each super-droplet on its
// own (the mode has no in-cell mixing): phase A tries 1, 2, 4, ... <=
// sstp_cond substeps and takes the first count whose d(rw^2) agrees with
// the half-size estimate; an SD that crosses its critical radius takes
// sstp_cond_act (the Koehler maximum by common/kappa_koehler.py rw3_cr's
// 48-iteration bracketed solve); where the adaptation is abandoned the
// pre-adaptation ambient state comes back; phase B runs the SD's own
// count of substeps of dt / count, each feeding the vapour of its d(rw^3)
// and the heat back to the SD.  Plain version: ops/cond.py
// perparticle_adaptive_plain (lgrngn/condensation.py
// perparticle_adaptive_core over the same layout).
//
// What bounds it on the card: instruction issue, as the fixed form
// (cond_sd_fixed.cu): up to 15 evaluations of drw2_dt a try and a
// substep, and the critical radius' 50 evaluations of its Koehler
// function (a powf each), against ~56 bytes a live SD read or written
// once.  The first design launched the one-substep kernel
// G once a try and once a substep of max(sstp_cond, sstp_cond_act)
// masked ones, with the plain rw3_cr over every slot and hundreds of
// elementwise PyTorch launches around them.
// What the design does about it: an SD's whole phase runs in one lane's
// registers, its cell's values (the mean free paths computed from the
// cell's T and p at the start of the step) read with it.  A thread takes
// a slot, a warp 32 consecutive sorted positions, a dead lane computing
// on a live neighbour's data, masked.  (A warp a cell over its ranked
// live SDs, cond_sd_fixed.cu's frame, ran 1.08x (dense rows) to 1.5x
// (flat segments) slower on the H100: a cell's 64 live SDs are two
// serial chunks whose lanes wait for the longest count; PERF.md section
// 6.)  A slot with n == 0 keeps its rw2 (the plain version's phase B
// leaves it) and its private values (which no caller reads).  Every
// growth rate a try or a substep does not use is skipped (a warp runs
// the root find only where one of its SDs needs it), and the warp leaves
// phase B once each lane's SD is past its own count and its last idle
// substep left its state bitwise as it was (so that every later idle
// substep would too).  Every operation is the plain version's in its
// order, in float32 with that version's clamps as they act there (rd3
// clamped to 1e-300, which is 0 in float32), so rw2 and the private
// state of every live SD are bitwise the plain version's.

#include <cuda_runtime.h>

#include "cond_cell.cuh"

namespace lcp {

struct AdaptOpts {
  CondOpts o;       // sstp (= sstp_cond), RH_max, closure options, iters
  int sstp_act, rw3cr_iters;
  double dt;
  float eps, dmax;  // sstp_cond_adapt_drw2_eps, _max
};

struct SdResult {
  float rw2, th, rv, rh, p;
};

// common/kappa_koehler.py rw3_cr: the critical wet radius cubed, by
// ops/rootfind.py solve_bracketed on [rd3, 1e8 rd3]
__device__ __forceinline__ float rw3_cr(float rd3, float kappa, float T,
                                        int iters) {
  const float A = div_s(div_s(2.0f * sg_surf(T), R_v) / T, rho_w);
  const auto f = [&](float rw3) {
    return A * (rd3 - rw3) * ((kappa - 1.0f) * rd3 + rw3)
           + kappa * 3.0f * rd3 * rw3 * powf(rw3, F(1.0 / 3.0));
  };
  float a = rd3 * 1.0f, b = rd3 * F(1e8);
  float fa = f(a), fb = f(b);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float x = ab_point(a, b, fa, fb);
    const float fx = f(x);
    const bool left = fa * fx <= 0.0f;
    float m_l = 1.0f - fx / (fb == 0.0f ? 1.0f : fb);
    float m_r = 1.0f - fx / (fa == 0.0f ? 1.0f : fa);
    m_l = m_l > 0.0f ? m_l : 0.5f;
    m_r = m_r > 0.0f ? m_r : 0.5f;
    const float na = left ? a : x;
    const float nfa = left ? fa * m_l : fx;
    const float nb = left ? x : b;
    const float nfb = left ? fx : fb * m_r;
    a = fx == 0.0f ? x : na;
    b = fx == 0.0f ? x : nb;
    fa = nfa;
    fb = nfb;
  }
  return fabsf(fa) < fabsf(fb) ? a : b;
}

// lgrngn/condensation.py perparticle_adaptive_core for the SD in slot j of
// cell ``a`` (``on``: the lane's SD is live and its result used; a lane
// without one computes on a live SD's data, masked).  Every lane of the
// warp calls it together.
__device__ __forceinline__ SdResult adaptive_sd(bool on, const SdIn& in,
                                                long long j, const SdCell& a,
                                                const AdaptOpts& ao) {
  const CondOpts& o = ao.o;
  const int sstp_max = o.sstp;
  const float n = in.n[j], rw2 = in.rw2[j], rd3 = in.rd3[j];
  const float kpa = in.kpa[j], vt = in.vt[j];
  // without const_p the phase starts every private p at 0
  // (perparticle_adaptive_core's tmp_p0), whatever the array holds
  const float th0 = in.th[j], rv0 = in.rv[j], rh0 = in.rh[j];
  const float p0 = o.const_p ? in.p[j] : 0.0f;
  const float dlt_rv = a.rv - rv0, dlt_th = a.th - th0;
  const float dlt_rh = a.rhod - rh0, dlt_p = a.p - p0;
  // the closure at an ambient state, and rw2 after a step of dt there
  // where ``use`` says (w elsewhere; no growth rate where no lane uses it)
  const auto grow = [&](bool use, float w, float th, float rv, float rh,
                        float p, float dt, Closure& c) {
    c = sd_closure(o.th_dry, o.const_p, o.rh_formula, th, rv, rh, p);
    if (!__any_sync(kFullMask, use)) return w;
    CondOpts od = o;
    od.dt = dt;
    return sd_advance(use, w, rd3, kpa, vt, c, rh, rv, a.lam_D, a.lam_K, od);
  };

  // phase A: the counts 1, 2, 4, ... <= sstp_cond
  float tmp_rv = rv0, tmp_th = th0, tmp_rh = rh0, tmp_p = p0;
  int sstp = sstp_max;
  bool done = false, first_done = sstp_max == 1;
  float drw2 = 0.0f;
  Closure c;
#pragma unroll 1
  for (int t = 1; t <= sstp_max; t *= 2) {
    const float mult = t == 1 ? 1.0f : F(-1.0 / t);
    if (!done) {
      tmp_rv = tmp_rv + dlt_rv * mult;
      tmp_th = tmp_th + dlt_th * mult;
      tmp_rh = tmp_rh + dlt_rh * mult;
      if (o.const_p) tmp_p = tmp_p + dlt_p * mult;
    }
    const float rw2_t = grow(on && !done, rw2, tmp_th, tmp_rv, tmp_rh, tmp_p,
                             static_cast<float>(ao.dt / t), c);
    const float drw2_t = rw2_t - rw2;
    if (t == 1) {
      drw2 = drw2_t;
      continue;
    }
    const bool conv = fabsf(drw2_t * 2.0f - drw2) <= ao.eps * rw2
                      && fabsf(drw2) < ao.dmax * rw2;
    if (conv && !done) {
      sstp = t / 2;
      // the state after one converged substep
      tmp_rv = tmp_rv - dlt_rv * mult;
      tmp_th = tmp_th - dlt_th * mult;
      tmp_rh = tmp_rh - dlt_rh * mult;
      if (o.const_p) tmp_p = tmp_p - dlt_p * mult;
      first_done = true;
      done = true;
    }
    if (!done) drw2 = drw2_t;
  }

  // the activation/deactivation override
  if (ao.sstp_act > 1) {
    const float rc2 = powf(rw3_cr(fmaxf(rd3, 0.0f), fmaxf(kpa, F(1e-10)),
                                  a.T, ao.rw3cr_iters),
                           F(2.0 / 3));
    const float proj = rw2 + static_cast<float>(sstp) * drw2;
    if ((rw2 < rc2 && proj > rc2) || (rw2 > rc2 && proj < rc2)) {
      sstp = ao.sstp_act;
      first_done = false;
    }
  }

  // abandonment: the pristine pre-adaptation ambient state
  if (!first_done) {
    tmp_rv = rv0;
    tmp_th = th0;
    tmp_rh = rh0;
    tmp_p = p0;
  }

  // phase B: the SD's own count of substeps
  const float frac = rdiv_s(1.0, static_cast<float>(sstp));
  const float dt_sd = frac * static_cast<float>(ao.dt);
  float w = rw2;
  const int n_b = max(sstp_max, ao.sstp_act);
#pragma unroll 1
  for (int step = 0; step < n_b; ++step) {
    const bool active = step < sstp && on;
    const bool reuse = first_done && step == 0;
    const bool app = active && !reuse;
    const float rv_n = app ? tmp_rv + dlt_rv * frac : tmp_rv;
    const float th_n = app ? tmp_th + dlt_th * frac : tmp_th;
    const float rh_n = app ? tmp_rh + dlt_rh * frac : tmp_rh;
    const float p_n = o.const_p && app ? tmp_p + dlt_p * frac : tmp_p;
    float w_new = grow(app, w, th_n, rv_n, rh_n, p_n, dt_sd, c);
    w_new = reuse ? w + drw2 : w_new;
    w_new = active ? w_new : w;
    const float drw3 = active ? rw3_of(w_new) - rw3_of(w) : 0.0f;
    const float drv = drw3 * F(kDrvMlt) * n / rh_n / a.dv;
    const float rv_next = rv_n + drv;
    const float th_next = th_n + drv * d_th_d_rv(c.T, th_n);
    // past its count an SD's substep changes nothing once one such
    // substep has left its state as it was: the next computes the same
    const bool settled = !on || (step >= sstp
                                 && __float_as_uint(rv_next)
                                        == __float_as_uint(tmp_rv)
                                 && __float_as_uint(th_next)
                                        == __float_as_uint(tmp_th)
                                 && __float_as_uint(rh_n)
                                        == __float_as_uint(tmp_rh)
                                 && __float_as_uint(p_n)
                                        == __float_as_uint(tmp_p)
                                 && __float_as_uint(w_new)
                                        == __float_as_uint(w));
    tmp_rv = rv_next;
    tmp_th = th_next;
    tmp_rh = rh_n;
    tmp_p = p_n;
    w = w_new;
    if (__all_sync(kFullMask, settled)) break;
  }
  return SdResult{w, tmp_th, tmp_rv, tmp_rh, tmp_p};
}

__device__ __forceinline__ void put(const SdOut& out, long long j,
                                    const SdResult& r) {
  out.rw2[j] = r.rw2;
  out.th[j] = r.th;
  out.rv[j] = r.rv;
  out.rh[j] = r.rh;
  out.p[j] = r.p;
}

// a thread a slot, 32 consecutive sorted positions a warp
__global__ void __launch_bounds__(32 * kCondWarps)
cond_sd_adaptive_kernel(SdIn in, SdCells cells, SdLayout L, SdOut out,
                        long long n_slots, AdaptOpts ao) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x
                     + (threadIdx.x - lane);
       w < n_slots; w += stride) {
    const long long q = w + lane;
    const bool in_range = q < n_slots;
    const long long j = in_range ? L.slot(q) : 0;
    const bool live = in_range && in.n[j] > 0.0f;
    const unsigned m = __ballot_sync(kFullMask, live);
    if (m == 0u) {
      if (in_range) out.keep(in, j);
      continue;
    }
    const int src = __ffs(m) - 1;
    const long long q_src = __shfl_sync(kFullMask, q, src);
    const long long j_src = __shfl_sync(kFullMask, j, src);
    const SdCell a = SdCell::of(cells, L.cell(live ? q : q_src));
    const SdResult r = adaptive_sd(live, in, live ? j : j_src, a, ao);
    if (live)
      put(out, j, r);
    else if (in_range)
      out.keep(in, j);
  }
}

}  // namespace lcp

// lcp_cond_sd_fixed's arguments (without its scratch positions), with the
// cells' T after p_mfp, and sstp_cond_act and the drw2 criteria
extern "C" int lcp_cond_sd_adaptive(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* vt, const float* th0, const float* rv0, const float* rh0,
    const float* p0, const float* th, const float* rv, const float* rhod,
    const float* p, const float* dv, const float* T_mfp, const float* p_mfp,
    const float* T, const long long* order, const long long* ends,
    const long long* sijk, float* rw2_out, float* th_out, float* rv_out,
    float* rh_out, float* p_out, int n_cell, int cap,
    long long n_slots, int sstp, int sstp_act, double dt, double RH_max,
    double eps, double dmax, int th_dry, int const_p, int rh_formula,
    int iters, cudaStream_t stream) {
  if (n_cell <= 0 || n_slots <= 0) return 0;
  const lcp::SdIn in{n, rw2, rd3, kpa, vt, th0, rv0, rh0, p0};
  const lcp::SdCells cells{th, rv, rhod, p, dv, T_mfp, p_mfp, T};
  const lcp::SdLayout L{order, ends, sijk, cap};
  const lcp::SdOut out{rw2_out, th_out, rv_out, rh_out, p_out};
  const lcp::AdaptOpts ao{
      lcp::CondOpts{sstp, 0.0f, static_cast<float>(RH_max), th_dry, const_p,
                    rh_formula, 0, iters},
      sstp_act, 48, dt, static_cast<float>(eps), static_cast<float>(dmax)};
  const int threads = 32 * lcp::kCondWarps;
  const long long want = (n_slots + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  lcp::cond_sd_adaptive_kernel<<<blocks, threads, 0, stream>>>(
      in, cells, L, out, n_slots, ao);
  return static_cast<int>(cudaGetLastError());
}
