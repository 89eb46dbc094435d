// Kernel B: the condensation phase of the resident step.
//
// Replaces the condensation phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 191-231): per cell row,
// sstp_cond substeps of the implicit per-droplet root find, each closed by
// the latent-heat row sum that feeds th and rv of the next substep.
// Plain version: ops/step.py cond_plain.
//
// What bounds it on the card: arithmetic.  Each droplet evaluates drw2_dt
// (~8 transcendentals) about 16 times per substep (12 root-find
// iterations), 10 substeps a step, while it reads and writes 16 bytes.  The
// substep loop also carries a dependency through the row: substep s+1
// needs the row's th/rv after substep s.
// What the design does about it: one thread block per cell row, one thread
// per droplet lane (a block strides over the row when cap exceeds it), the
// whole substep loop inside the kernel with rw2 in shared memory.  The row
// sum is a block reduction (warp shuffles, then one value per warp in
// shared memory) in a fixed order, so th/rv repeat run to run.  The root
// find runs only where the bracket holds.

#include <cuda_runtime.h>

#include "physics.cuh"

namespace lcp {

// cells_in: 9 rows of n_cell: thadv rvadv th0 rv0 rhod dv lamD lamK p0
// cells_out: 6 rows of n_cell: th rv T p RH eta
__global__ void __launch_bounds__(128)
cond_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
            const float* __restrict__ rd3, const float* __restrict__ kpa,
            const float* __restrict__ cells_in, float* __restrict__ rw2_out,
            float* __restrict__ cells_out, int n_cell, int cap, int sstp,
            float dt_sub, float RH_max, int th_dry, int const_p,
            int rh_formula, int iters) {
  extern __shared__ float smem[];
  float* s_rw2 = smem;             // cap
  float* s_vt = smem + cap;        // cap
  float* s_wgt = smem + 2 * cap;   // cap
  // one double per warp + 1, 8-byte aligned after the float arrays
  double* s_red = reinterpret_cast<double*>(smem + ((3 * cap + 1) & ~1));

  const int r = blockIdx.x;
  const float thadv = cells_in[0 * n_cell + r];
  const float rvadv = cells_in[1 * n_cell + r];
  const float th0 = cells_in[2 * n_cell + r];
  const float rv0 = cells_in[3 * n_cell + r];
  const float rhod = cells_in[4 * n_cell + r];
  const float dv = cells_in[5 * n_cell + r];
  const float lam_D = cells_in[6 * n_cell + r];
  const float lam_K = cells_in[7 * n_cell + r];
  const float p0 = cells_in[8 * n_cell + r];

  const float dth = div_s(thadv - th0, sstp);
  const float drv = div_s(rvadv - rv0, sstp);

  // the stale vt of the previous step's end, rebuilt from the rw2 it was
  // computed from and the cell state it saw (pallas_step.py:203-210)
  const Closure prev = closure(th_dry, const_p, rh_formula, th0, rv0, rhod, p0);
  const float dv_rhod = dv * rhod;
  const size_t base = static_cast<size_t>(r) * cap;
  for (int l = threadIdx.x; l < cap; l += blockDim.x) {
    float w = rw2[base + l];
    s_rw2[l] = w;
    s_vt[l] = vt_beard77(w, prev.p, rhod, prev.eta);
    s_wgt[l] = n[base + l] * F((4.0 / 3) * pi * rho_w) / dv_rhod;
  }
  __syncthreads();

  float th = th0, rv = rv0;
  for (int s = 0; s < sstp; ++s) {
    th = th + dth;
    rv = rv + drv;
    const Closure c = closure(th_dry, const_p, rh_formula, th, rv, rhod, p0);
    double part = 0.0;
    for (int l = threadIdx.x; l < cap; l += blockDim.x) {
      const Growth g{rd3[base + l], kpa[base + l], s_vt[l], rhod, rv,
                     c.T, c.p, c.RH, c.eta, lam_D, lam_K, RH_max};
      const float old = s_rw2[l];
      const float nw = advance_rw2(dt_sub, old, g, iters);
      const float drw3 = nw * sqrtf(nw) - old * sqrtf(fmaxf(old, 0.0f));
      part += static_cast<double>(s_wgt[l] * drw3);
      s_rw2[l] = nw;
    }
    const float dcell = -static_cast<float>(block_sum(part, s_red));
    const float th_new = th + dcell * d_th_d_rv(c.T, th);
    rv = rv + dcell;
    th = th_new;
  }

  for (int l = threadIdx.x; l < cap; l += blockDim.x)
    rw2_out[base + l] = s_rw2[l];
  if (threadIdx.x == 0) {
    const Closure c = closure(th_dry, const_p, rh_formula, th, rv, rhod, p0);
    cells_out[0 * n_cell + r] = th;
    cells_out[1 * n_cell + r] = rv;
    cells_out[2 * n_cell + r] = c.T;
    cells_out[3 * n_cell + r] = c.p;
    cells_out[4 * n_cell + r] = c.RH;
    cells_out[5 * n_cell + r] = c.eta;
  }
}

}  // namespace lcp

extern "C" int lcp_cond(const float* n, const float* rw2, const float* rd3,
                        const float* kpa, const float* cells_in,
                        float* rw2_out, float* cells_out, int n_cell, int cap,
                        int sstp, double dt_sub, double RH_max, int th_dry,
                        int const_p, int rh_formula, int iters,
                        cudaStream_t stream) {
  const int threads = 128;
  const size_t smem = ((3 * static_cast<size_t>(cap) + 1) & ~size_t(1))
                      * sizeof(float) + (threads / 32 + 1) * sizeof(double);
  lcp::cond_kernel<<<n_cell, threads, smem, stream>>>(
      n, rw2, rd3, kpa, cells_in, rw2_out, cells_out, n_cell, cap, sstp,
      static_cast<float>(dt_sub), static_cast<float>(RH_max), th_dry, const_p,
      rh_formula, iters);
  return static_cast<int>(cudaGetLastError());
}
