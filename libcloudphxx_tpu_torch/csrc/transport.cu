// Kernel C's entry points on the 2-D grid: lcp_transport,
// lcp_transport_pred_corr and lcp_transport_unwrapped (the kernel and its
// design are in transport.cuh; the 3-D forms' entry points in
// transport3d.cu, a source of their own, so that the 2-D instantiations
// compile as they did before the 3-D forms existed).

#include "transport.cuh"

extern "C" int lcp_transport(const float* n, const float* rw2, const float* rd3,
                             const float* x, const float* z,
                             const float* cells, float* n_out, float* x_out,
                             float* z_out, float* vt_out, int* tgt_out,
                             float* rowinfo, int n_cell, int cap, int nx,
                             int nz, double dx, double dz, double dt,
                             double x0, double x1, double z0, double z1,
                             int implicit_adve, int do_adve, int do_sedi,
                             int do_subs, int open_side, int periodic_topbot,
                             int vt, cudaStream_t stream) {
  return transport_launch(
      n, rw2, rd3, x, z, cells, n_out, x_out, z_out, vt_out, tgt_out,
      rowinfo, n_cell, cap,
      geometry(nx, nz, dx, dz, dt, x0, x1, z0, z1, implicit_adve, do_adve,
               do_sedi, do_subs, open_side, periodic_topbot),
      vt, stream);
}

// The pred_corr form: lcp_transport's arguments (do_adve set, implicit_adve
// clear), then the staggered courant_x ((nx+1)*nz) and courant_z
// (nx*(nz+1)).
extern "C" int lcp_transport_pred_corr(
    const float* n, const float* rw2, const float* rd3, const float* x,
    const float* z, const float* cells, float* n_out, float* x_out,
    float* z_out, float* vt_out, int* tgt_out, float* rowinfo, int n_cell,
    int cap, int nx, int nz, double dx, double dz, double dt, double x0,
    double x1, double z0, double z1, int implicit_adve, int do_adve,
    int do_sedi, int do_subs, int open_side, int periodic_topbot, int vt,
    const float* cx, const float* cz, cudaStream_t stream) {
  if (!do_adve || implicit_adve || cx == nullptr || cz == nullptr
      || n_cell != nx * nz)
    return static_cast<int>(cudaErrorInvalidValue);
  const lcp::PredCorrGeometry geo{
      geometry(nx, nz, dx, dz, dt, x0, x1, z0, z1, implicit_adve, do_adve,
               do_sedi, do_subs, open_side, periodic_topbot),
      cx, cz, dx, dz, static_cast<float>(z0 + 1e-8 * dz),
      static_cast<float>(z1 - 1e-8 * dz)};
  return transport_launch(n, rw2, rd3, x, z, cells, n_out, x_out, z_out,
                          vt_out, tgt_out, rowinfo, n_cell, cap, geo, vt,
                          stream);
}

// The unwrapped form on a shard of the x-slab mesh: the n_cell rows are
// columns col0 .. col0 + n_cell / nz - 1 of the global nx x nz grid, the
// first ncol of them the shard's own; some transport must run.
extern "C" int lcp_transport_unwrapped(
    const float* n, const float* rw2, const float* rd3, const float* x,
    const float* z, const float* cells, float* n_out, float* x_out,
    float* z_out, float* vt_out, int* tgt_out, float* rowinfo, int n_cell,
    int cap, int nx, int nz, double dx, double dz, double dt, double x0,
    double x1, double z0, double z1, int implicit_adve, int do_adve,
    int do_sedi, int do_subs, int open_side, int periodic_topbot, int vt,
    int col0, int ncol, cudaStream_t stream) {
  if (!(do_adve || do_sedi || do_subs) || n_cell % nz || col0 < 0
      || ncol < 1 || ncol > n_cell / nz)
    return static_cast<int>(cudaErrorInvalidValue);
  const lcp::SlabGeometry geo{
      geometry(nx, nz, dx, dz, dt, x0, x1, z0, z1, implicit_adve, do_adve,
               do_sedi, do_subs, open_side, periodic_topbot),
      col0, ncol};
  return transport_launch(n, rw2, rd3, x, z, cells, n_out, x_out, z_out,
                          vt_out, tgt_out, rowinfo, n_cell, cap, geo, vt,
                          stream);
}
