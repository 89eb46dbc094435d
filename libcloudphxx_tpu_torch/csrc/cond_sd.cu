// Kernel G: the per-droplet condensation root find at each droplet's own
// ambient conditions.
//
// Replaces the TPU kernel libcloudphxx_tpu/ops/pallas_cond.py:_kernel
// (advance_rw2_pallas) at its per-droplet-ambient callers: the exact
// per-particle substepping (lgrngn/condensation.py cond_perparticle) and
// its adaptive form (perparticle_adaptive_core), where every droplet
// carries its own th, rv, rhod and p between substeps, so that T, p, RH,
// eta and rhod differ from droplet to droplet even within a cell.  The
// per-cell caller (cond_percell) is kernel F's (cond_flat.cu).
// Plain version: ops/cond.py advance_rw2_plain, which is
// lgrngn/condensation.py _advance_rw2_core.
//
// What bounds it on the card: its 52 bytes a droplet read or written once
// (12 float inputs, one output; 56 with a per-droplet dt) and its
// operations at the card's float32 rate take about the same least time;
// what holds it far above both is instruction issue: a bracketed droplet
// evaluates drw2_dt 15 times (the explicit step, both bracket ends, 12
// Anderson-Bjoerck iterations), each 14 IEEE divisions, 9 exp/log and a
// square root under -fmad=false.
// What the design does about it: one thread a droplet in a grid-stride
// loop; every input is read once into registers and the whole root find
// runs there.  The growth rate, the bracket and the iteration are
// cond_cell.cuh's (cell_growth, drw2_dt, advance), the device code of
// kernels B and F, so the three agree with _advance_rw2_core operation for
// operation and G's rw2 is bitwise its plain version's.  A warp runs the
// root-find stages only where one of its droplets is bracketed (advance's
// ballot), so the loop keeps whole warps together: the lanes past the end
// and the slots with rw2 <= 0 (dead, which keep their rw2) evaluate at a
// finite radius, masked, and never take the IEEE division's slow path.

#include <cuda_runtime.h>

#include "cond_cell.cuh"

namespace lcp {

constexpr int kSdThreads = 256;

__global__ void __launch_bounds__(kSdThreads)
cond_sd_kernel(const float* __restrict__ rw2, const float* __restrict__ rd3,
               const float* __restrict__ kpa, const float* __restrict__ vt,
               const float* __restrict__ rhod, const float* __restrict__ rv,
               const float* __restrict__ T, const float* __restrict__ p,
               const float* __restrict__ RH, const float* __restrict__ eta,
               const float* __restrict__ lam_D,
               const float* __restrict__ lam_K,
               const float* __restrict__ dt_sd, float* __restrict__ rw2_out,
               long long n, CondOpts o) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the warp's first droplet: the loop bound is the same in every lane
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x
                        + (threadIdx.x - lane);
       base < n; base += stride) {
    const long long i = base + lane;
    const bool on = i < n;
    const long long j = on ? i : n - 1;
    const float w = rw2[j];
    const bool alive = w > 0.0f;
    Closure c;
    c.T = T[j];
    c.p = p[j];
    c.RH = RH[j];
    c.eta = eta[j];
    const CellGrowth g =
        cell_growth(c, rhod[j], rv[j], lam_D[j], lam_K[j], o.RH_max);
    CondOpts od = o;
    if (dt_sd != nullptr) od.dt = dt_sd[j];
    CondDrop d = make_drop(j, alive ? w : kMaskedRw2, rd3[j], kpa[j], vt[j],
                           0.0f);
    advance(d, on && alive, g, od, 1.0f);
    if (on) rw2_out[i] = alive ? d.rw2 : w;
  }
}

}  // namespace lcp

// 12 input arrays of n floats (rw2 rd3 kpa vt rhod rv T p RH eta lam_D
// lam_K), the per-droplet dt (n floats, or null for the scalar dt), one
// output array of n floats
extern "C" int lcp_cond_sd(const float* rw2, const float* rd3,
                           const float* kpa, const float* vt,
                           const float* rhod, const float* rv, const float* T,
                           const float* p, const float* RH, const float* eta,
                           const float* lam_D, const float* lam_K,
                           const float* dt_sd, float* rw2_out, long long n,
                           double dt, double RH_max, int iters,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  const lcp::CondOpts o{1, static_cast<float>(dt),
                        static_cast<float>(RH_max), 0, 0, 0, 0, iters};
  // enough blocks for every SM to hold several; the loop strides past them
  const long long want = (n + lcp::kSdThreads - 1) / lcp::kSdThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  lcp::cond_sd_kernel<<<blocks, lcp::kSdThreads, 0, stream>>>(
      rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lam_D, lam_K, dt_sd,
      rw2_out, n, o);
  return static_cast<int>(cudaGetLastError());
}
