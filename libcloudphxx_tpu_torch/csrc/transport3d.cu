// Kernel C's 3-D forms: the entry points lcp_transport_3d and
// lcp_transport_3d_pred_corr, and their kernels' attributes (the streaming
// kernel and its design are in transport3d.cuh; the scalar layout runs
// transport.cuh's row code).
//
// Replaces the transport phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 338-487) on the 3-D
// grid, which the TPU kernel refuses (libcloudphxx_tpu/lgrngn/dense.py:
// 1209-1241) and the JAX package runs in XLA (lgrngn/dense.py:918-1030
// adve_sedi_bcnd, :1150-1180 rebin's classification).  Plain version:
// ops/step.py transport_plain with y3.

#include "transport3d.cuh"

namespace {

lcp::YAxis y_axis(int ny, double dy, double y0, double y1, const float* y,
                  float* y_out, const float* cy) {
  return lcp::YAxis{ny,
                    static_cast<float>(dy), static_cast<float>(y0),
                    static_cast<float>(y1 - y0), static_cast<float>(y1),
                    dy, y, y_out, cy};
}

}  // namespace

// The 3-D form: lcp_transport's arguments, then the y plane in and out,
// the y axis (ny, dy, y0, y1) and the launch plan (ops/step.py
// transport3d_plan: a brick's rows, the persistent blocks); n_cell = nx *
// ny * nz, the cell rows T p rhod eta C_l C_r C_b C_a C_f C_h (and w_LS
// with do_subs).
extern "C" int lcp_transport_3d(
    const float* n, const float* rw2, const float* rd3, const float* x,
    const float* z, const float* cells, float* n_out, float* x_out,
    float* z_out, float* vt_out, int* tgt_out, float* rowinfo, int n_cell,
    int cap, int nx, int nz, double dx, double dz, double dt, double x0,
    double x1, double z0, double z1, int implicit_adve, int do_adve,
    int do_sedi, int do_subs, int open_side, int periodic_topbot, int vt,
    const float* y, float* y_out, int ny, double dy, double y0, double y1,
    int brick, int blocks, cudaStream_t stream) {
  const bool moves = do_adve || do_sedi || do_subs;
  if (ny < 1 || n_cell != nx * ny * nz || (moves && (!y || !y_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  const lcp::With3D<lcp::Geometry> geo{
      geometry(nx, nz, dx, dz, dt, x0, x1, z0, z1, implicit_adve, do_adve,
               do_sedi, do_subs, open_side, periodic_topbot),
      y_axis(ny, dy, y0, y1, y, y_out, nullptr)};
  return lcp::transport3d_launch(n, rw2, rd3, x, z, cells, n_out, x_out,
                                 z_out, vt_out, tgt_out, rowinfo, n_cell, cap,
                                 geo, vt, brick, blocks, stream);
}

// The 3-D pred_corr form: lcp_transport_3d's arguments (do_adve set,
// implicit_adve clear), then the staggered courant_x ((nx+1)*ny*nz),
// courant_z (nx*ny*(nz+1)) and courant_y (nx*(ny+1)*nz).
extern "C" int lcp_transport_3d_pred_corr(
    const float* n, const float* rw2, const float* rd3, const float* x,
    const float* z, const float* cells, float* n_out, float* x_out,
    float* z_out, float* vt_out, int* tgt_out, float* rowinfo, int n_cell,
    int cap, int nx, int nz, double dx, double dz, double dt, double x0,
    double x1, double z0, double z1, int implicit_adve, int do_adve,
    int do_sedi, int do_subs, int open_side, int periodic_topbot, int vt,
    const float* y, float* y_out, int ny, double dy, double y0, double y1,
    int brick, int blocks, const float* cx, const float* cz, const float* cy,
    cudaStream_t stream) {
  if (!do_adve || implicit_adve || !cx || !cz || !cy || !y || !y_out
      || ny < 1 || n_cell != nx * ny * nz)
    return static_cast<int>(cudaErrorInvalidValue);
  const lcp::With3D<lcp::PredCorrGeometry> geo{
      {geometry(nx, nz, dx, dz, dt, x0, x1, z0, z1, implicit_adve, do_adve,
                do_sedi, do_subs, open_side, periodic_topbot),
       cx, cz, dx, dz, static_cast<float>(z0 + 1e-8 * dz),
       static_cast<float>(z1 - 1e-8 * dz)},
      y_axis(ny, dy, y0, y1, y, y_out, cy)};
  return lcp::transport3d_launch(n, rw2, rd3, x, z, cells, n_out, x_out,
                                 z_out, vt_out, tgt_out, rowinfo, n_cell, cap,
                                 geo, vt, brick, blocks, stream);
}

// The streaming kernel of either form (``pred_corr``) under formula ``vt``
// on the card at capacity ``cap`` (lcp::transport3d_attrs)
extern "C" int lcp_transport_3d_attrs(int vt, int pred_corr, int cap,
                                      int* out) {
  return pred_corr
             ? lcp::transport3d_attrs<lcp::With3D<lcp::PredCorrGeometry>>(
                   vt, cap, out)
             : lcp::transport3d_attrs<lcp::With3D<lcp::Geometry>>(vt, cap,
                                                                  out);
}
