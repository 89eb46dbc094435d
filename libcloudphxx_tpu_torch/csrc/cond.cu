// Kernel B: the condensation phase of the resident step.
//
// Replaces the condensation phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 191-231): per cell row,
// sstp_cond substeps of the implicit per-droplet root find, each closed by
// the latent-heat row sum that feeds th and rv of the next substep.
// Plain version: ops/step.py cond_plain.
//
// What bounds it on the card: instruction issue.  A bracketed droplet
// evaluates drw2_dt 15 times a substep (the explicit step, the bracket end,
// the root find's other end and 12 Anderson-Bjoerck iterations), each 14
// IEEE divisions, 9 exp/log and a square root under -fmad=false, while the
// whole row reads and writes 16 bytes a droplet; and substep s+1 of a row
// needs the row's th/rv after substep s.  The first design (one 128-thread
// block a row) lost time to what surrounds that arithmetic: at sd_conc 64
// half of each row's 128 lanes are dead and still ran the prologue's
// evaluations, and every substep ended in a three-barrier block reduction
// that waited for the slowest warp's root find.
// What the design does about it: the warp-per-cell routine of
// cond_cell.cuh on the dense rows.  A warp owns a row for the whole
// substep loop, with no block barrier; the live droplets are ranked by
// ballot, so the dead lanes cost nothing; the rows go to the warps fullest
// first; the row sum is a warp butterfly in double.  The stale vt of the
// previous step's end is rebuilt once a droplet, from the rw2 it was
// computed from and the cell state it saw (pallas_step.py:203-210), by
// the configured formula, a template parameter (one kernel a formula).

#include <cuda_runtime.h>

#include "cond_cell.cuh"

namespace lcp {

// A dense row's droplets: n, rd3, kappa planes; vt by formula VT rebuilt
// from the previous closure (T, p and eta of th0/rv0)
template <int VT>
struct DenseRow {
  const float* __restrict__ n;
  const float* __restrict__ rd3;
  const float* __restrict__ kpa;
  Ambient prev;
  __device__ __forceinline__ float wnum(long long i) const {
    return n[i] * F((4.0 / 3) * pi * rho_w);
  }
  __device__ __forceinline__ CondDrop drop(long long i, float rw2,
                                           float wn) const {
    return make_drop(i, rw2, rd3[i], kpa[i], vt_formula<VT>(rw2, prev), wn);
  }
};

// Blocks an SM holds at least: three under Khvorostyanov, as many as the
// root find's 66 registers give the other formulas unasked; unbounded,
// the float64 pows of the set-up pass's vt take 82 registers and leave
// room for two, which slows the kernel by a sixth on the H100
template <int VT>
__host__ __device__ constexpr int cond_min_blocks() {
  return VT == kVtKhvorostyanovSpherical
                 || VT == kVtKhvorostyanovNonspherical
             ? 3
             : 1;
}

// cells_in: 9 rows of n_cell: thadv rvadv th0 rv0 rhod dv lamD lamK p0
// cells_out: 6 rows of n_cell: th rv T p RH eta
template <int VT>
__global__ void __launch_bounds__(32 * kCondWarps, cond_min_blocks<VT>())
cond_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
            const float* __restrict__ rd3, const float* __restrict__ kpa,
            const float* __restrict__ cells_in, float* __restrict__ rw2_out,
            float* __restrict__ cells_out, Compact cs,
            const int* __restrict__ order, int n_cell, int cap, CondOpts o) {
  const int w = blockIdx.x * kCondWarps + (threadIdx.x >> 5);
  if (w >= n_cell) return;
  const int r = order[w];
  const float thadv = cells_in[0 * n_cell + r];
  const float rvadv = cells_in[1 * n_cell + r];
  CellIn in;
  in.th = cells_in[2 * n_cell + r];
  in.rv = cells_in[3 * n_cell + r];
  in.rhod = cells_in[4 * n_cell + r];
  in.dv = cells_in[5 * n_cell + r];
  in.lam_D = cells_in[6 * n_cell + r];
  in.lam_K = cells_in[7 * n_cell + r];
  in.p0 = cells_in[8 * n_cell + r];
  in.dth = div_s(thadv - in.th, o.sstp);
  in.drv = div_s(rvadv - in.rv, o.sstp);
  in.drh = 0.0f;
  const Closure prev =
      closure(o.th_dry, o.const_p, o.rh_formula, in.th, in.rv, in.rhod, in.p0);
  const DenseRow<VT> src{n, rd3, kpa, {prev.T, prev.p, in.rhod, prev.eta}};
  const long long base = static_cast<long long>(r) * cap;
  const CellOut out = cond_cell(src, base, base + cap, in, o, rw2, rw2_out, cs);
  if ((threadIdx.x & 31) == 0) {
    cells_out[0 * n_cell + r] = out.th;
    cells_out[1 * n_cell + r] = out.rv;
    cells_out[2 * n_cell + r] = out.c.T;
    cells_out[3 * n_cell + r] = out.c.p;
    cells_out[4 * n_cell + r] = out.c.RH;
    cells_out[5 * n_cell + r] = out.c.eta;
  }
}

}  // namespace lcp

// ``pos`` and ``buf`` scratch of n_cell * cap ints and 6 * n_cell * cap
// floats; warp w takes row order[w]; ``vt`` the formula (vt_t)
extern "C" int lcp_cond(const float* n, const float* rw2, const float* rd3,
                        const float* kpa, const float* cells_in,
                        float* rw2_out, float* cells_out, int* pos,
                        float* buf, const int* order, int n_cell, int cap,
                        int sstp, double dt_sub, double RH_max, int th_dry,
                        int const_p, int rh_formula, int iters, int vt,
                        cudaStream_t stream) {
  if (n_cell <= 0) return 0;
  const long long m = static_cast<long long>(n_cell) * cap;
  const lcp::Compact cs{pos,         buf,         buf + m,    buf + 2 * m,
                        buf + 3 * m, buf + 4 * m, buf + 5 * m};
  const lcp::CondOpts o{sstp, static_cast<float>(dt_sub),
                        static_cast<float>(RH_max), th_dry, const_p,
                        rh_formula, 0, iters};
  const int blocks = (n_cell + lcp::kCondWarps - 1) / lcp::kCondWarps;
  return lcp::with_vt(vt, [&](auto f) {
    lcp::cond_kernel<decltype(f)::value>
        <<<blocks, 32 * lcp::kCondWarps, 0, stream>>>(
            n, rw2, rd3, kpa, cells_in, rw2_out, cells_out, cs, order,
            n_cell, cap, o);
    return static_cast<int>(cudaGetLastError());
  });
}
