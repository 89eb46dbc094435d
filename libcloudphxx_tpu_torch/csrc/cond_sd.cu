// Kernel F: the per-droplet condensation root find on flat SD arrays.
//
// Replaces the TPU kernel libcloudphxx_tpu/ops/pallas_cond.py:_kernel
// (advance_rw2_pallas), which runs lgrngn/condensation.py _advance_rw2_core
// over the flat engine's SD population in (256, 128) VMEM blocks.  The flat
// engine calls it sstp_cond times a step, on the cell-sorted SD arrays with
// the cell values already gathered to every SD.
// Plain version: lgrngn/condensation.py _advance_rw2_core (ops/cond.py
// advance_rw2 with plain=True or a CPU tensor).
//
// What bounds it on the card: arithmetic.  A live droplet evaluates
// drw2_dt (~10 transcendentals and ~10 divisions, ~95 operations) about 16
// times (the explicit guess, one bracket end, 12 root-find iterations at
// float32), against 52 bytes of traffic (12 float inputs, one output).
// What the design does about it: one thread per droplet in a grid-stride
// loop, the ragged tail masked by the loop bound; every input is read once
// into registers and the whole root find runs there, so the traffic is the
// 52 bytes.  The root find runs only where the bracket holds (dead slots and
// droplets with no growth return at once).  The physics is the device code
// kernel B runs (physics.cuh Growth / advance_rw2): one source for both, so
// both agree bitwise with the plain version under -fmad=false.

#include <cuda_runtime.h>

#include "physics.cuh"

namespace lcp {

__global__ void __launch_bounds__(256)
cond_sd_kernel(const float* __restrict__ rw2, const float* __restrict__ rd3,
               const float* __restrict__ kpa, const float* __restrict__ vt,
               const float* __restrict__ rhod, const float* __restrict__ rv,
               const float* __restrict__ T, const float* __restrict__ p,
               const float* __restrict__ RH, const float* __restrict__ eta,
               const float* __restrict__ lam_D,
               const float* __restrict__ lam_K, float* __restrict__ rw2_out,
               long long n, float dt, float RH_max, int iters) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += stride) {
    const Growth g{rd3[i], kpa[i], vt[i], rhod[i], rv[i], T[i], p[i],
                   RH[i],  eta[i], lam_D[i], lam_K[i], RH_max};
    rw2_out[i] = advance_rw2(dt, rw2[i], g, iters);
  }
}

}  // namespace lcp

// 12 input arrays of n floats (rw2 rd3 kpa vt rhod rv T p RH eta lam_D
// lam_K), one output array of n floats
extern "C" int lcp_cond_sd(const float* rw2, const float* rd3,
                           const float* kpa, const float* vt,
                           const float* rhod, const float* rv, const float* T,
                           const float* p, const float* RH, const float* eta,
                           const float* lam_D, const float* lam_K,
                           float* rw2_out, long long n, double dt,
                           double RH_max, int iters, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  // enough blocks for every SM to hold several; the loop strides past them
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  lcp::cond_sd_kernel<<<blocks, threads, 0, stream>>>(
      rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lam_D, lam_K, rw2_out, n,
      static_cast<float>(dt), static_cast<float>(RH_max), iters);
  return static_cast<int>(cudaGetLastError());
}
