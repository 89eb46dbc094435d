// The condensation substep loop of one cell, run by one warp: the device
// routine of kernel B (cond.cu, the dense (n_cell, cap) rows) and kernel F
// (cond_flat.cu, the flat engine's cell-sorted segments).  Kernel G
// (cond_sd.cu, one droplet a thread at its own ambient conditions) takes
// its per-droplet parts: cell_growth, drw2_dt, make_drop and advance.
//
// Per substep the cell's th/rv (and rhod) take their increment, the
// closure gives T, p, RH and eta, every live droplet of the cell takes one
// backward-Euler step of rw^2, and the latent heat of the cell's droplets
// feeds th and rv of the next substep.  Plain versions: ops/step.py
// cond_plain and ops/cond.py cond_flat_plain, both over
// lgrngn/condensation.py drw2_dt and _advance_rw2_core.
//
// How the work is laid out:
//   - a warp owns a cell for the whole substep loop; nothing is shared
//     between warps, so the loop has no block barrier; a block is
//     kCondWarps warps; the kernels hand the cells to the warps longest
//     first (the wrappers' cell order), so that the cells with the longest
//     serial work do not start last;
//   - before the first substep the warp ranks the cell's live droplets
//     (weight > 0, i.e. n > 0) by ballot, wherever they sit in the
//     segment, and writes their positions to the front of the segment's
//     span of a per-slot scratch; dead slots are copied through untouched
//     and cost no growth-rate evaluation; then each lane writes beside
//     the positions of its droplets what their growth takes from them
//     alone (the dry radius' square, rd3 * (1 - kappa), vt, the weight's
//     numerator), once a call (in a pass of its own: inlined into the
//     unrolled scan it raised the kernels' registers from 66-70 to 80-86
//     and slowed B by a tenth);
//   - lane j takes the live droplets j, j+32, ... of the scratch, one at a
//     time (one slot a lane); a cell of up to 32 live droplets keeps them
//     in registers across all substeps, a longer one goes through them 32
//     at a time, its rw^2 held in the scratch between substeps;
//   - each growth-rate evaluation of the substep (the explicit step, the
//     bracket ends, each Anderson-Bjoerck iteration) is a stage of one loop
//     with one inlined drw2_dt; a warp runs the root-find stages only where
//     a droplet of its 32 is bracketed, and a droplet without a bracket
//     evaluates at its own rw2 meanwhile, so that no lane feeds a zero, an
//     infinity or a NaN to an IEEE division or square root (their slow
//     path would hold the warp);
//   - the cell sum of the latent heat is a fixed __shfl_xor_sync butterfly
//     in double, the same in every lane and from run to run.
// The kernels are bound by instruction issue: 14 IEEE divisions, 9
// exp/log and a square root an evaluation, up to 15 evaluations a droplet
// and substep.  More slots a lane (independent chains interleaved) and
// more warps an SM (a lower register cap) gained nothing on the card; one
// slot a lane, which lets a warp skip the root find for 32 droplets at a
// time, was the fastest (PERF.md section 6).
//
// Every droplet's arithmetic is that of _advance_rw2_core operation for
// operation (the library is built with -fmad=false): rw^2 is bitwise the
// plain version's wherever the cell's th/rv are.  What is evaluated once
// instead of repeatedly gives the same values: the dry radius' cube root,
// rd3 * (1 - kappa) and vt once a droplet and step, the cell's terms of
// drw2_dt once a substep, and of the two bracket ends the root find
// evaluates first, the one the bracket test already evaluated.  The cell
// sums add in another order than the plain versions' (torch.sum over a
// row; a cumulative sum differenced at the cell ends), so th/rv may
// differ in the last bit.
#pragma once

#include <cuda_runtime.h>

#include "physics.cuh"

namespace lcp {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCondWarps = 8;  // cells a block

// What drw2_dt (lgrngn/condensation.py) takes from the cell in a substep,
// with the terms that depend on the cell alone evaluated once.
struct CellGrowth {
  float rhod, eta, T, lam_D, lam_K;
  float Sc, Pr, RH, A, l_v, rho_v, lv_term;
};

__device__ __forceinline__ CellGrowth cell_growth(const Closure& c, float rhod,
                                                  float rv, float lam_D,
                                                  float lam_K, float RH_max) {
  CellGrowth g;
  g.rhod = rhod;
  g.eta = c.eta;
  g.T = c.T;
  g.lam_D = lam_D;
  g.lam_K = lam_K;
  g.Sc = div_s(c.eta / rhod, D_0);
  g.Pr = div_s(F(c_pd) * c.eta, K_0);
  g.RH = fminf(c.RH, RH_max);
  const float sg = F(0.07275) * (1.0f - F(0.002) * (c.T - 291.0f));
  g.A = div_s(div_s(2.0f * sg, R_v) / c.T, rho_w);
  g.l_v = F(c_pv - c_pw) * (c.T - F(T_tri)) + F(l_tri);
  g.rho_v = rhod * rv;
  g.lv_term = div_s(g.l_v, R_v) / c.T - 1.0f;
  return g;
}

__device__ __forceinline__ float fs_beta(float Kn) {
  return (1.0f + Kn) / (1.0f + F(1.71) * Kn + F(1.33) * Kn * Kn);
}

__device__ __forceinline__ float nusselt(float Pr, float Re) {
  const float cb = expf(div_s(logf(1.0f + Re * Pr), 3.0));
  const float pw = expf(logf(Re) * F(0.077));
  return 1.0f + cb * fmaxf(pw, 1.0f);
}

// lgrngn/condensation.py drw2_dt for a droplet of dry volume rd3, with
// rd3k = rd3 * (1 - kappa), and terminal velocity vt
__device__ __forceinline__ float drw2_dt(float rw2, float rd3, float rd3k,
                                         float vt, const CellGrowth& g) {
  const float rw = sqrtf(rw2);
  const float rw3 = rw2 * rw;
  const float Re = vt * (2.0f * rw) * g.rhod / g.eta;
  const float D = F(D_0) * fs_beta(g.lam_D / rw) * (nusselt(g.Sc, Re) * 0.5f);
  const float K = F(K_0) * fs_beta(g.lam_K / rw) * (nusselt(g.Pr, Re) * 0.5f);
  const float a_w = (rw3 - rd3) / (rw3 - rd3k);
  const float klv = expf(g.A / rw);
  const float num = div_s(1.0f - a_w * klv / g.RH, rho_w);
  const float den = rdiv_s(1.0, D) / g.rho_v
                    + g.l_v / K / g.RH / g.T * g.lv_term;
  return 2.0f * (num / den);
}

// A live droplet as its growth takes it: rw2, rd3, rd3 * (1 - kappa), the
// dry radius squared, vt, the weight's numerator; and its slot
struct CondDrop {
  float rw2, rd3, rd3k, rd2, vt, wnum;
  int pos;
};

__device__ __forceinline__ CondDrop make_drop(long long pos, float rw2,
                                              float rd3, float kpa, float vt,
                                              float wnum) {
  const float rd = expf(div_s(logf(rd3), 3.0));
  return CondDrop{rw2, rd3, rd3 * (1.0f - kpa), rd * rd, vt, wnum,
                  static_cast<int>(pos)};
}

// The per-slot scratch: a cell's live droplets, in rank order at the front
// of its segment's span, each array of one element a slot
struct Compact {
  int* pos;
  float *rw2, *rd3, *rd3k, *rd2, *vt, *wnum;
  __device__ __forceinline__ void put(long long i,
                                      const CondDrop& d) const {
    pos[i] = d.pos;
    rw2[i] = d.rw2;
    rd3[i] = d.rd3;
    rd3k[i] = d.rd3k;
    rd2[i] = d.rd2;
    vt[i] = d.vt;
    wnum[i] = d.wnum;
  }
  __device__ __forceinline__ CondDrop get(long long i) const {
    return CondDrop{rw2[i], rd3[i], rd3k[i], rd2[i],
                    vt[i], wnum[i], pos[i]};
  }
};

struct CondOpts {
  int sstp;
  float dt, RH_max;
  int th_dry, const_p, rh_formula, var_rho, iters;
};

// The cell's inputs: the increments of one substep, th/rv/rhod where the
// substep loop starts, and what stays fixed over it.
struct CellIn {
  float dth, drv, drh, th, rv, rhod, p0, dv, lam_D, lam_K;
};

// The Anderson-Bjoerck point of a bracket: the secant's root where it lies
// inside, else the midpoint (ops/rootfind.py solve_bracketed, which also
// divides by 1 where the denominator is 0: a division by 0 would take the
// IEEE division's slow path, for the whole warp)
__device__ __forceinline__ float ab_point(float a, float b, float fa,
                                          float fb) {
  const float denom = fb - fa;
  const float mid = 0.5f * (a + b);
  const float q = (a * fb - b * fa) / (denom == 0.0f ? 1.0f : denom);
  const float sec = denom != 0.0f ? q : mid;
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  return (sec > lo && sec < hi) ? sec : mid;
}

// One backward-Euler substep of the lane's droplet (``on`` where it holds
// one): ops/rootfind.py solve_bracketed inside lgrngn/condensation.py
// _advance_rw2_core.  Every growth-rate evaluation of a substep is one
// stage of one loop, with one drw2_dt: stage 0 the explicit step at rw2, 1
// the bracket end the bracket test needs, and, once a bracket holds
// anywhere in the warp, 2 the other end and 3 ... the root-find
// iterations.  Returns the lane's part of the cell sum of weight *
// d(rw^3).
__device__ __forceinline__ double advance(CondDrop& d, bool on,
                                          const CellGrowth& g,
                                          const CondOpts& o, float wden) {
  const float dt = o.dt;
  const float w = d.rw2;
  float x = w, drw2 = 0.0f, a = 0.0f, b = 0.0f, fa = 0.0f, fb = 0.0f;
  bool act = false, brk = false;
  int stages = 2;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    const float r = drw2_dt(x, d.rd3, d.rd3k, d.vt, g);
    if (s == 0) {
      // the explicit growth rate at rw2 itself (a droplet with rw2 <= 0
      // keeps it, so _advance_rw2_core's rw2_safe for it is never needed),
      // and the bracket from the cond_mlt-scaled explicit step
      drw2 = dt * r;
      act = on && w > 0.0f && drw2 != 0.0f;
      a = fmaxf(d.rd2, w + fminf(F(COND_MLT) * drw2, 0.0f));
      b = w + fmaxf(F(COND_MLT) * drw2, 0.0f);
      x = drw2 > 0.0f ? b : a;
      continue;
    }
    const float f = w + dt * r - x;
    const bool up = drw2 > 0.0f;
    if (s == 1) {
      // the bracket test, with f(rw2) == drw2 at the other end
      fa = up ? drw2 : f;
      fb = up ? f : drw2;
      brk = act && fa * fb <= 0.0f && a < b;
      x = up ? a : b;
      if (__any_sync(kFullMask, brk)) stages = 3 + o.iters;
    } else if (s == 2) {
      // solve_bracketed's f at both ends: this one, and the one the
      // bracket test evaluated
      const float ftest = up ? fb : fa;
      fa = up ? f : ftest;
      fb = up ? ftest : f;
      // a droplet without a bracket evaluates at its own rw2 from here
      // on, where the growth rate is finite, and its result is not used
      x = brk ? ab_point(a, b, fa, fb) : w;
    } else if (brk) {
      // an Anderson-Bjoerck iteration at x
      const bool left = fa * f <= 0.0f;
      float m_l = 1.0f - f / (fb == 0.0f ? 1.0f : fb);
      float m_r = 1.0f - f / (fa == 0.0f ? 1.0f : fa);
      m_l = m_l > 0.0f ? m_l : 0.5f;
      m_r = m_r > 0.0f ? m_r : 0.5f;
      const float na = left ? a : x;
      const float nfa = left ? fa * m_l : f;
      const float nb = left ? x : b;
      const float nfb = left ? f : fb * m_r;
      a = f == 0.0f ? x : na;
      b = f == 0.0f ? x : nb;
      fa = nfa;
      fb = nfb;
      x = ab_point(a, b, fa, fb);
    }
  }
  const float root = fabsf(fa) < fabsf(fb) ? a : b;
  float nw = brk ? root : w + drw2;
  nw = act ? fmaxf(nw, d.rd2) : w;
  const float drw3 = nw * sqrtf(nw) - w * sqrtf(fmaxf(w, 0.0f));
  d.rw2 = nw;
  return on ? static_cast<double>((d.wnum / wden) * drw3) : 0.0;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

struct CellOut {
  float th, rv, rhod;
  Closure c;
  // the th and rv that the last substep's closure took (IceDep's only)
  float th_c, rv_c;
};

// The SGS supersaturation perturbation of kernel F's turb_cond form: each
// droplet's ssp advances by dt * dot_ssp at the start of every substep
// and adds to its cell's RH (lgrngn/condensation.py cond_percell with
// turb_cond; libcloudphxx_tpu/lgrngn/condensation.py:353-358).  NoSgs is
// every other form's: its code compiles away.
struct NoSgs {
  static constexpr bool on = false;
};
struct Sgs {
  static constexpr bool on = true;
  const float* __restrict__ ssp;   // per slot: in, its tendency, out
  const float* __restrict__ dssp;
  float* __restrict__ ssp_out;
  float* cs_ssp;                   // two more rows of the per-slot scratch
  float* cs_dssp;
};

// The air a cell's droplets exchange vapour with (the template parameter
// ``A`` of cond_cell, kernel G's forms): CellAir is a grid cell's, rhod dv
// of dry air, dv its volume (every form of a grid); ParcelAir a parcel's,
// 1 kg of dry air (the JAX package's n_dims == 0; libcloudphxx_tpu/lgrngn/
// hskpng.py:50, condensation.py:478-481, 787-790): kernel F weighs a
// droplet by wnum / (dv rhod) with dv = 1 / rhod at each substep's rhod,
// and G feeds an SD's private air the vapour itself.  CellAir's code is
// what it was before ParcelAir.
struct CellAir {
  static constexpr bool parcel = false;
};
struct ParcelAir {
  static constexpr bool parcel = true;
};

// The ice of kernel F's ice forms (the template parameter ``I`` of
// cond_cell; NoIce is every other form's, whose code compiles away): after
// each substep's liquid growth and latent heat, the frozen live SDs'
// semi-axes grow by deposition, and the cell's rv and th take the ice mass
// and the heat of deposition (lgrngn/ice.py dep_axes, ops/cond.py
// cond_flat_plain; libcloudphxx_tpu/lgrngn/condensation.py:284-288,
// lgrngn/ice.py:106-148).  ice_a, ice_c and ice_rho ride the compaction in
// three more scratch rows, and a dead slot keeps its axes.
struct NoIce {
  static constexpr bool on = false;
};
struct IceDep {
  static constexpr bool on = true;
  const float* __restrict__ a;    // per slot in: ice_a, ice_c, ice_rho
  const float* __restrict__ c;
  const float* __restrict__ rho;
  float* __restrict__ a_out;      // per slot out: ice_a, ice_c
  float* __restrict__ c_out;
  float* cs_a;                    // three more rows of the per-slot scratch
  float* cs_c;
  float* cs_rho;
};

// What the deposition takes from the cell in a substep: the closure's T, p
// and eta (from before the liquid's latent heat), rhod, the rv after it,
// and the fresh mean free paths from that T and p (lgrngn/ice.py dep_axes)
struct IceGrowth {
  float rhod, eta, T, p, lam_D, lam_K, Sc, Pr, RH_i, l_s, rho_v, ls_term;
};

__device__ __forceinline__ IceGrowth ice_growth(const Closure& c, float rhod,
                                                float rv, float RH_max) {
  IceGrowth g;
  g.rhod = rhod;
  g.eta = c.eta;
  g.T = c.T;
  g.p = c.p;
  g.lam_D = mfp_D(c.T);
  g.lam_K = mfp_K(c.T, c.p);
  g.Sc = div_s(c.eta / rhod, D_0);
  g.Pr = div_s(F(c_pd) * c.eta, K_0);
  // p_v / p_vsi, common/moist_air.py p_v over common/const_cp.py p_vsi
  constexpr double a = (ls_tri + (c_pi - c_pv) * T_tri) / R_v;
  constexpr double b = (c_pi - c_pv) / R_v;
  const float pvsi = F(p_tri) * expf(F(a) * (F(1.0 / T_tri) - rdiv_s(1.0, c.T))
                                     - F(b) * logf(div_s(c.T, T_tri)));
  g.RH_i = fminf(c.p * rv / (rv + F(eps)) / pvsi, RH_max);
  g.l_s = F(c_pv - c_pi) * (c.T - F(T_tri)) + F(ls_tri);
  g.rho_v = rhod * rv;
  g.ls_term = div_s(g.l_s, R_v) / c.T - 1.0f;
  return g;
}

// lgrngn/ice.py dep_rate: d(x)/dt of a semi-axis x, 2 rdrdt_i at the
// sphere of radius x over 2 x
__device__ __forceinline__ float dep_rate(float x, float vt,
                                          const IceGrowth& g) {
  const float r = sqrtf(fmaxf(x * x, 0.0f));
  const float Re = vt * (2.0f * r) * g.rhod / g.eta;
  const float D = F(D_0) * fs_beta(g.lam_D / r) * (nusselt(g.Sc, Re) * 0.5f);
  const float K = F(K_0) * fs_beta(g.lam_K / r) * (nusselt(g.Pr, Re) * 0.5f);
  const float num = div_s(1.0f - rdiv_s(1.0, g.RH_i), rho_i);
  const float den = rdiv_s(1.0, D) / g.rho_v
                    + g.l_s / K / g.RH_i / g.T * g.ls_term;
  return 2.0f * (num / den) / (2.0f * x);
}

// One forward-Euler substep of an SD's axes (a, c) where ``is_ice``; the
// placeholders of the others keep every lane's arithmetic finite.  Returns
// the SD's part of the cell sum of the ice mass gained, its weight wt (=
// n 4/3 pi rho_w / (dv rhod)) times ice_rho / rho_w d(a^2 c), the
// difference taken as da (2a + da) c' + a^2 dc (lgrngn/ice.py dep_volume).
__device__ __forceinline__ double deposit(float& a, float& c, float rho,
                                          float vt, float wt, bool is_ice,
                                          const IceGrowth& g, float dt) {
  const float a0 = is_ice ? a : F(1e-6);
  const float c0 = is_ice ? c : F(1e-6);
  const float a1 = fmaxf(a0 + dt * dep_rate(a0, vt, g), F(1e-9));
  const float c1 = fmaxf(c0 + dt * dep_rate(c0, vt, g), F(1e-9));
  const float da = a1 - a0, dc = c1 - c0;
  const float dvol = da * (2.0f * a0 + da) * c1 + a0 * a0 * dc;
  if (!is_ice) return 0.0;
  a = a1;
  c = c1;
  return static_cast<double>(wt * (div_s(rho, rho_w) * dvol));
}

// d(theta)/d(rv) of deposition, common/theta_dry.py d_th_d_rv_dep
__device__ __forceinline__ float d_th_d_rv_dep(float T, float th) {
  const float l_s = F(c_pv - c_pi) * (T - F(T_tri)) + F(ls_tri);
  return div_s(-th / T * l_s, c_pd);
}

// The liquid growth of a live droplet; under IceDep a frozen SD (rw2 ==
// 0) takes none, and evaluates at kMaskedRw2 meanwhile, so that no lane
// feeds a zero to an IEEE division or square root
template <class I>
__device__ __forceinline__ double advance_live(CondDrop& d, bool on,
                                              const CellGrowth& g,
                                              const CondOpts& o, float wden) {
  if constexpr (I::on) {
    const float w = d.rw2;
    const bool frozen = !(w > 0.0f);
    if (frozen) d.rw2 = kMaskedRw2;
    const double part = advance(d, on && !frozen, g, o, wden);
    if (frozen) d.rw2 = w;
    return part;
  } else {
    return advance(d, on, g, o, wden);
  }
}

// The substep loop of the cell whose droplets sit at positions [begin,
// end) of the SD arrays.  ``Src`` reads a droplet: wnum(pos), the
// numerator of its weight (n * 4/3 pi rho_w; it is live where wnum > 0),
// and drop(pos, rw2, wnum), the CondDrop of a live one; its weight in the
// cell sum is wnum / (dv * rhod).  ``cs`` is the per-slot scratch; ``sg``
// the SGS supersaturation (Sgs, kernel F's turb_cond form: ssp rides the
// scratch beside rw2, and a dead slot keeps its ssp as its rw2); ``A``
// the air (CellAir; ParcelAir, F's parcel forms); ``ice`` the ice
// (IceDep, F's ice forms).  Every lane returns the cell's end state.
template <class Src, class S = NoSgs, class A = CellAir, class I = NoIce>
__device__ __forceinline__ CellOut cond_cell(const Src& src, long long begin,
                                             long long end, const CellIn& in,
                                             const CondOpts& o,
                                             const float* __restrict__ rw2,
                                             float* __restrict__ rw2_out,
                                             const Compact& cs,
                                             const S& sg = S{},
                                             const I& ice = I{}) {
  constexpr int kScan = 8;  // windows of 32 slots a scan step reads at once
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // rank the live droplets into the scratch; copy the dead slots through
  int nlive = 0;
  for (long long w = begin; w < end; w += 32 * kScan) {
    float wn[kScan], r2[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const long long pos = w + u * 32 + lane;
      wn[u] = pos < end ? src.wnum(pos) : 0.0f;
      r2[u] = pos < end ? rw2[pos] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const long long pos = w + u * 32 + lane;
      const bool live = wn[u] > 0.0f;
      const unsigned m = __ballot_sync(kFullMask, live);
      if (live) {
        cs.pos[begin + nlive + __popc(m & below)] = static_cast<int>(pos);
      } else if (pos < end) {
        rw2_out[pos] = r2[u];
        if constexpr (S::on) sg.ssp_out[pos] = sg.ssp[pos];
        if constexpr (I::on) {
          ice.a_out[pos] = ice.a[pos];
          ice.c_out[pos] = ice.c[pos];
        }
      }
      nlive += __popc(m);
    }
  }
  __syncwarp();
  // each live droplet's set-up, once: lane j takes the droplets it will
  // advance, j, j+32, ...
  for (int i = lane; i < nlive; i += 32) {
    const int pos = cs.pos[begin + i];
    cs.put(begin + i, src.drop(pos, rw2[pos], src.wnum(pos)));
    if constexpr (S::on) {
      sg.cs_ssp[begin + i] = sg.ssp[pos];
      sg.cs_dssp[begin + i] = sg.dssp[pos];
    }
    if constexpr (I::on) {
      ice.cs_a[begin + i] = ice.a[pos];
      ice.cs_c[begin + i] = ice.c[pos];
      ice.cs_rho[begin + i] = ice.rho[pos];
    }
  }
  __syncwarp();

  const int n_chunk = (nlive + 31) >> 5;
  const bool resident = n_chunk <= 1;
  CondDrop d;
  float ssp = 0.0f, dssp = 0.0f;  // the turb_cond form's
  float ia = 0.0f, ic = 0.0f, irho = 0.0f;  // the ice forms', resident
  float th = in.th, rv = in.rv, rhod = in.rhod;
  float th_c = 0.0f, rv_c = 0.0f;
  for (int s = 0; s < o.sstp; ++s) {
    th = th + in.dth;
    rv = rv + in.drv;
    if (o.var_rho) rhod = rhod + in.drh;
    if constexpr (I::on) {
      th_c = th;
      rv_c = rv;
    }
    const Closure c =
        closure(o.th_dry, o.const_p, o.rh_formula, th, rv, rhod, in.p0);
    const CellGrowth g = cell_growth(c, rhod, rv, in.lam_D, in.lam_K, o.RH_max);
    float wden;
    if constexpr (A::parcel)
      wden = (1.0f / rhod) * rhod;
    else
      wden = in.dv * rhod;
    const bool last = s == o.sstp - 1;
    double part = 0.0;
    for (int ch = 0; ch < n_chunk; ++ch) {
      // lanes past the last droplet take its values, masked, so that no
      // lane computes on garbage
      const int i = ch * 32 + lane;
      const bool on = i < nlive;
      if (!resident || s == 0) {
        d = cs.get(begin + min(i, nlive - 1));
        if constexpr (S::on) {
          ssp = sg.cs_ssp[begin + min(i, nlive - 1)];
          dssp = sg.cs_dssp[begin + min(i, nlive - 1)];
        }
      }
      if constexpr (S::on) {
        // ssp advances before the closure that reads it, and the droplet
        // grows at its cell's RH plus its ssp
        ssp = ssp + o.dt * dssp;
        CellGrowth gd = g;
        gd.RH = fminf(c.RH + ssp, o.RH_max);
        part += advance_live<I>(d, on, gd, o, wden);
        if (on && last) sg.ssp_out[d.pos] = ssp;
        else if (on && !resident) sg.cs_ssp[begin + i] = ssp;
      } else {
        part += advance_live<I>(d, on, g, o, wden);
      }
      if (on && last) rw2_out[d.pos] = d.rw2;
      else if (on && !resident) cs.rw2[begin + i] = d.rw2;
    }
    const float dcell = -static_cast<float>(warp_sum(part));
    const float th_new = th + dcell * d_th_d_rv(c.T, th);
    rv = rv + dcell;
    th = th_new;
    if constexpr (I::on) {
      // the deposition, at the closure and the rv after the latent heat
      const IceGrowth gi = ice_growth(c, rhod, rv, o.RH_max);
      double ipart = 0.0;
      for (int ch = 0; ch < n_chunk; ++ch) {
        const int i = ch * 32 + lane;
        const bool on = i < nlive;
        const long long j = begin + min(i, nlive - 1);
        if (!resident) d = cs.get(j);
        if (!resident || s == 0) {
          ia = ice.cs_a[j];
          ic = ice.cs_c[j];
          irho = ice.cs_rho[j];
        }
        const bool is_ice = on && ia > 0.0f && ic > 0.0f;
        ipart += deposit(ia, ic, irho, d.vt, d.wnum / wden, is_ice, gi, o.dt);
        if (on && last) {
          ice.a_out[d.pos] = ia;
          ice.c_out[d.pos] = ic;
        } else if (on && !resident) {
          ice.cs_a[j] = ia;
          ice.cs_c[j] = ic;
        }
      }
      const float dice = static_cast<float>(warp_sum(ipart));
      rv = rv - dice;
      th = th - dice * d_th_d_rv_dep(c.T, th);
    }
  }
  CellOut out;
  out.th = th;
  out.rv = rv;
  out.rhod = rhod;
  if constexpr (I::on) {
    out.th_c = th_c;
    out.rv_c = rv_c;
  }
  out.c = closure(o.th_dry, o.const_p, o.rh_formula, th, rv, rhod, in.p0);
  return out;
}

// ---- kernel G's fixed-count and adaptive forms (cond_sd_fixed.cu,
// cond_sd_adaptive.cu): the per-particle substepping, where every
// super-droplet carries its own th, rv, rhod and p between substeps.

// Where a cell's SDs lie.  The flat engine's cell-sorted segments (kernel
// F's layout): cell c holds the sorted positions ends[c-1] + 1 to ends[c],
// sorted position q is slot order[q] of the SD arrays and lies in cell
// sijk[q].  Without ``order``, the dense engine's (n_cell, cap) planes:
// cell c is row c, position q slot q.
struct SdLayout {
  const long long* order;
  const long long* ends;
  const long long* sijk;
  int cap;
  __device__ __forceinline__ void segment(int c, long long& begin,
                                          long long& end) const {
    if (order != nullptr) {
      begin = c == 0 ? 0 : ends[c - 1] + 1;
      end = ends[c] + 1;
    } else {
      begin = static_cast<long long>(c) * cap;
      end = begin + cap;
    }
  }
  __device__ __forceinline__ long long slot(long long q) const {
    return order != nullptr ? order[q] : q;
  }
  __device__ __forceinline__ int cell(long long q) const {
    return static_cast<int>(order != nullptr ? sijk[q] : q / cap);
  }
};

// The SD arrays in slot order: the SD, and its private ambient state at
// the last sstp_save (the inputs), and the outputs
struct SdIn {
  const float *n, *rw2, *rd3, *kpa, *vt, *th, *rv, *rh, *p;
};
struct SdOut {
  float *rw2, *th, *rv, *rh, *p;
  // a slot the loop does not advance keeps its rw2 and private state
  __device__ __forceinline__ void keep(const SdIn& in, long long j) const {
    rw2[j] = in.rw2[j];
    th[j] = in.th[j];
    rv[j] = in.rv[j];
    rh[j] = in.rh[j];
    p[j] = in.p[j];
  }
};

// The cells: th, rv, rhod and p (the step's increment of an SD's private
// value is the cell's value minus it), dv, T and p at the start of the
// step (the stale mean free paths come from them, hskpng_mfp), and T
// after the step's closure (the adaptive form's activation test)
struct SdCells {
  const float *th, *rv, *rhod, *p, *dv, *T_mfp, *p_mfp, *T;
};
struct SdCell {
  float th, rv, rhod, p, dv, lam_D, lam_K, T;
  static __device__ __forceinline__ SdCell of(const SdCells& a, int c) {
    const float T_mfp = a.T_mfp[c];
    return SdCell{a.th[c], a.rv[c], a.rhod[c], a.p[c], a.dv[c],
                  mfp_D(T_mfp), mfp_K(T_mfp, a.p_mfp[c]),
                  a.T != nullptr ? a.T[c] : 0.0f};
  }
};

// lgrngn/condensation.py rw3_of
__device__ __forceinline__ float rw3_of(float rw2) {
  return rw2 * sqrtf(fmaxf(rw2, 0.0f));
}

// -(4/3) pi rho_w: the vapour a unit of d(rw^3) takes
constexpr double kDrvMlt = -(4.0 / 3) * pi * rho_w;

// The warp ranks the SDs of positions [begin, end) that ``take(slot)``
// selects: their slots go to pos[begin], pos[begin + 1], ... in segment
// order, and ``skip(slot)`` gets every other slot.  Returns the count
// (the same in every lane).
template <class Take, class Skip>
__device__ __forceinline__ int rank_sds(const SdLayout& L, long long begin,
                                        long long end, int* __restrict__ pos,
                                        Take take, Skip skip) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (long long w = begin; w < end; w += 32) {
    const long long q = w + lane;
    const bool in = q < end;
    const long long j = in ? L.slot(q) : 0;
    const bool t = in && take(j);
    const unsigned m = __ballot_sync(kFullMask, t);
    if (t)
      pos[begin + count + __popc(m & below)] = static_cast<int>(j);
    else if (in)
      skip(j);
    count += __popc(m);
  }
  __syncwarp();
  return count;
}

// One backward-Euler step of an SD's rw2 at its own ambient state
// (lgrngn/condensation.py _perparticle_thermo, then _advance_rw2_core at
// those conditions): ``c`` its closure; the warp's lanes call it together
// (advance's ballot), ``on`` where the lane's result is used.  An SD with
// rw2 <= 0 keeps it, evaluated at kMaskedRw2 meanwhile.
__device__ __forceinline__ float sd_advance(bool on, float w, float rd3,
                                            float kpa, float vt,
                                            const Closure& c, float rhod,
                                            float rv, float lam_D,
                                            float lam_K, const CondOpts& o) {
  const CellGrowth g = cell_growth(c, rhod, rv, lam_D, lam_K, o.RH_max);
  const bool grows = w > 0.0f;
  CondDrop d = make_drop(0, grows ? w : kMaskedRw2, rd3, kpa, vt, 0.0f);
  advance(d, on && grows, g, o, 1.0f);
  return grows ? d.rw2 : w;
}

}  // namespace lcp
