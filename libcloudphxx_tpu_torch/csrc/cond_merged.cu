// Kernel B's merge-prologue form: the deferred re-binning of the previous
// step, then the condensation of the merged rows, in one launch.
//
// Replaces the deferred-x prologue of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (do_xmerge, lines 126-131
// and 170-175 over _xmerge_values, lines 53-112; step_resident(..., xkey),
// line 537), which moves the x pass of step N's re-binning into step N+1's
// kernel.  The port's kernel D does the z and the x pass at once from
// kernel C's target rows, so the port defers the whole merge: a state
// whose merge is pending carries C's planes and targets
// (lgrngn/dense.DenseState.pending_tgt), and the next step's first launch
// is this form.  Plain version: ops/step.py cond_merged_plain
// (rebin_x_plain, then cond_plain on the merged rows).
//
// A warp takes row order[w], builds it with kernel D's row code (merge.cuh
// merge_row, the same routine kernel D runs, so the merged planes are D's
// bit for bit) into fresh planes, and runs kernel B's row code on it
// (cond.cuh cond_kernel with MergePrologue).  The rows' sources are other
// warps' rows, so the form reads only the previous step's planes and
// targets, which no block of the launch writes, and condenses from its own
// merged row after __syncwarp().
//
// What bounds it on the card: B's instruction issue (cond.cu); the merge
// adds D's bytes, a few percent of B's time.  The merged rows are written
// once and read back by the warp that wrote them (L1 or L2).  With it a
// steady deferred step runs B (this form), E and C: no launch of D.
//
// One instantiation a terminal velocity formula and slot layout (D's
// 16-byte slots where vector_ok, else scalar ones).

#include <cuda_runtime.h>

#include "cond.cuh"

// lcp_cond's arguments (n, rw2, rd3, kpa the planes before the merge),
// then the planes vt, x, z before it, the targets, the seven merged planes
// out (n rw2 rd3 kpa vt x z), the drops a row, nx and nz
extern "C" int lcp_cond_merged(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* cells_in, float* rw2_out, float* cells_out, int* pos,
    float* buf, const int* order, int n_cell, int cap, int sstp,
    double dt_sub, double RH_max, int th_dry, int const_p, int rh_formula,
    int iters, int vt, const float* vt_in, const float* x, const float* z,
    const int* tgt, float* n_m, float* rw2_m, float* rd3_m, float* kpa_m,
    float* vt_m, float* x_m, float* z_m, float* drops, int nx, int nz,
    cudaStream_t stream) {
  if (nx < 3 || static_cast<long long>(nx) * nz != n_cell)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, rd3, kpa, vt_in, x, z, tgt, n_m, rw2_m, rd3_m, kpa_m,
            vt_m, x_m, z_m});
  auto launch = [&](auto pro) {
    return lcp::launch_cond(n, rw2, rd3, kpa, cells_in, rw2_out, cells_out,
                            pos, buf, order, n_cell, cap, sstp, dt_sub,
                            RH_max, th_dry, const_p, rh_formula, iters, vt,
                            pro, stream);
  };
  if (vec)
    return launch(lcp::MergePrologue<true>{
        {n, rw2, rd3, kpa, vt_in, x, z},
        {n_m, rw2_m, rd3_m, kpa_m, vt_m, x_m, z_m}, tgt, drops, nx, nz});
  return launch(lcp::MergePrologue<false>{
      {n, rw2, rd3, kpa, vt_in, x, z},
      {n_m, rw2_m, rd3_m, kpa_m, vt_m, x_m, z_m}, tgt, drops, nx, nz});
}
