// Kernel B's kernel template and its launch, shared by its two sources:
// cond.cu (the condensation of the rows as they are, the main path) and
// cond_merged.cu (the merge-prologue form: the deferred re-binning of the
// previous step first).  Each form is a source of its own, so that the
// main path's kernel compiles as it did before the second form existed.
#pragma once

#include <cuda_runtime.h>

#include "cond_cell.cuh"
#include "merge.cuh"

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
// room for two, which slows the kernel by a sixth on the H100.  The
// merge-prologue form asks for three under every formula: its merge would
// take 90-93 registers and leave room for two.
template <int VT, class P>
__host__ __device__ constexpr int cond_min_blocks() {
  return P::on || VT == kVtKhvorostyanovSpherical
                 || VT == kVtKhvorostyanovNonspherical
             ? 3
             : 1;
}

// The main path's form: the rows are condensed as they are.
struct NoMerge {
  static constexpr bool on = false;
  __device__ __forceinline__ void merge(int, int) const {}
};

// The merge-prologue form (the deferred re-binning, the TPU kernel's
// do_xmerge prologue): before its condensation the warp builds its row r
// from the previous step's planes ``in`` (n rw2 rd3 kpa vt x z after kernel
// C) and targets ``tgt``, with kernel D's row code (merge.cuh merge_row:
// the droplets of r's nine source rows whose target is r, in
// MERGE_SOURCES and slot order, the lanes past the last zero, the
// droplets that do not fit counted in ``drops``), into the fresh planes
// ``out``, and condenses that row.  Another warp's row is a source of this
// one, so the form reads only ``in`` and ``tgt``, which no block of the
// launch writes, and its own row of ``out`` after __syncwarp().  VEC:
// D's 16-byte slots (merge.cuh, vector_ok).  The merge keeps 3 (source,
// tile) units in flight (Grid2Lean), not D's 9: the condensation's
// registers bound the kernel.
template <bool VEC>
struct MergePrologue {
  static constexpr bool on = true;
  static constexpr int kPlanes = 7;  // n rw2 rd3 kpa vt x z
  const float* in[kPlanes];
  float* out[kPlanes];
  const int* tgt;
  float* drops;
  int nx, nz;
  __device__ __forceinline__ void merge(int r, int cap) const {
    merge_row<kPlanes, VEC>(in, out, tgt, drops, r, cap,
                            Grid2Lean(r, nx, nz));
  }
};

// cells_in: 9 rows of n_cell: thadv rvadv th0 rv0 rhod dv lamD lamK p0
// cells_out: 6 rows of n_cell: th rv T p RH eta
template <int VT, class P>
__global__ void __launch_bounds__(32 * kCondWarps, cond_min_blocks<VT, P>())
cond_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
            const float* __restrict__ rd3, const float* __restrict__ kpa,
            const float* __restrict__ cells_in, float* __restrict__ rw2_out,
            float* __restrict__ cells_out, Compact cs,
            const int* __restrict__ order, int n_cell, int cap, CondOpts o,
            P pro) {
  const int w = blockIdx.x * kCondWarps + (threadIdx.x >> 5);
  if (w >= n_cell) return;
  const int r = order[w];
  // the planes the condensation reads: the merged row in the prologue form
  // (pointers into memory this launch writes: plain loads, not __ldg)
  const float* n_r = n;
  const float* rw2_r = rw2;
  const float* rd3_r = rd3;
  const float* kpa_r = kpa;
  if constexpr (P::on) {
    pro.merge(r, cap);
    __syncwarp();
    n_r = pro.out[0];
    rw2_r = pro.out[1];
    rd3_r = pro.out[2];
    kpa_r = pro.out[3];
  }
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
  const DenseRow<VT> src{n_r, rd3_r, kpa_r,
                         {prev.T, prev.p, in.rhod, prev.eta}};
  const long long base = static_cast<long long>(r) * cap;
  const CellOut out =
      cond_cell(src, base, base + cap, in, o, rw2_r, rw2_out, cs);
  if ((threadIdx.x & 31) == 0) {
    cells_out[0 * n_cell + r] = out.th;
    cells_out[1 * n_cell + r] = out.rv;
    cells_out[2 * n_cell + r] = out.c.T;
    cells_out[3 * n_cell + r] = out.c.p;
    cells_out[4 * n_cell + r] = out.c.RH;
    cells_out[5 * n_cell + r] = out.c.eta;
  }
}

// The launch of either form: ``pos`` and ``buf`` scratch of n_cell * cap
// ints and 6 * n_cell * cap floats; warp w takes row order[w]; ``vt`` the
// formula (vt_t)
template <class P>
int launch_cond(const float* n, const float* rw2, const float* rd3,
                const float* kpa, const float* cells_in, float* rw2_out,
                float* cells_out, int* pos, float* buf, const int* order,
                int n_cell, int cap, int sstp, double dt_sub, double RH_max,
                int th_dry, int const_p, int rh_formula, int iters, int vt,
                const P& pro, cudaStream_t stream) {
  if (n_cell <= 0) return 0;
  const long long m = static_cast<long long>(n_cell) * cap;
  const Compact cs{pos,         buf,         buf + m,    buf + 2 * m,
                   buf + 3 * m, buf + 4 * m, buf + 5 * m};
  const CondOpts o{sstp, static_cast<float>(dt_sub),
                   static_cast<float>(RH_max), th_dry, const_p,
                   rh_formula, 0, iters};
  const int blocks = (n_cell + kCondWarps - 1) / kCondWarps;
  return with_vt(vt, [&](auto f) {
    cond_kernel<decltype(f)::value, P>
        <<<blocks, 32 * kCondWarps, 0, stream>>>(
            n, rw2, rd3, kpa, cells_in, rw2_out, cells_out, cs, order,
            n_cell, cap, o, pro);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace lcp
