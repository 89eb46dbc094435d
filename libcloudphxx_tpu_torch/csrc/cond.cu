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
//
// The kernel template is cond.cuh's (shared with the merge-prologue form,
// cond_merged.cu); this source instantiates the form that condenses the
// rows as they are.

#include <cuda_runtime.h>

#include "cond.cuh"

extern "C" int lcp_cond(const float* n, const float* rw2, const float* rd3,
                        const float* kpa, const float* cells_in,
                        float* rw2_out, float* cells_out, int* pos,
                        float* buf, const int* order, int n_cell, int cap,
                        int sstp, double dt_sub, double RH_max, int th_dry,
                        int const_p, int rh_formula, int iters, int vt,
                        cudaStream_t stream) {
  return lcp::launch_cond(n, rw2, rd3, kpa, cells_in, rw2_out, cells_out,
                          pos, buf, order, n_cell, cap, sstp, dt_sub, RH_max,
                          th_dry, const_p, rh_formula, iters, vt,
                          lcp::NoMerge{}, stream);
}
