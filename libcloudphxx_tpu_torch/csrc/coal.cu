// Kernel E's entry points, and its instantiation for the beard77 formulas
// (the main path's); the kernels are in coal.cuh, the wide-table form's
// instantiations in coal_vohl*.cu, the y and onishi forms' and the 2-D
// warp rows' (above capacity 128) in coal_y*.cu.

#include "coal.cuh"

template int lcp::coal_launch<lcp::kVtBeard77>(int, const lcp::CoalArgs&,
                                               cudaStream_t);

namespace {

lcp::CoalArgs coal_args(const float* n, const float* rw2, const float* rd3,
                        const float* kpa, const float* x, const float* z,
                        const float* cells, const float* eff, float* n_out,
                        float* rw2_out, float* rd3_out, float* kpa_out,
                        float* x_out, float* z_out, float* vt_out,
                        unsigned char* ovf, int n_cell, int cap, int sstp,
                        double dt_sub, int kern, double coef,
                        double r_max_m1, int clamp, unsigned seed,
                        unsigned step, unsigned row0, bool wide = false) {
  return lcp::CoalArgs{
      n, rw2, rd3, kpa, x, z, cells, n_out, rw2_out, rd3_out, kpa_out,
      x_out, z_out, vt_out, ovf, n_cell, cap, sstp, dt_sub,
      lcp::CollisionKernel{kern, static_cast<float>(coef), eff,
                           static_cast<float>(r_max_m1), clamp},
      seed, step, row0, wide};
}

int coal_formula(int vt, int mode, const lcp::CoalArgs& a,
                 cudaStream_t stream) {
  return lcp::with_vt(vt, [&](auto f) {
    return lcp::coal_launch<decltype(f)::value>(mode, a, stream);
  });
}

}  // namespace

// The resident step's form: stride (sort = 0) or sort (sort = 1) pairing;
// ``vt`` the formula (vt_t); row r draws as row row0 + r.
extern "C" int lcp_coal(const float* n, const float* rw2, const float* rd3,
                        const float* kpa, const float* x, const float* z,
                        const float* cells, const float* eff, float* n_out,
                        float* rw2_out, float* rd3_out, float* kpa_out,
                        float* x_out, float* z_out, unsigned char* ovf,
                        int n_cell, int cap, int sstp, double dt_sub,
                        int kern, double coef, double r_max_m1, int clamp,
                        unsigned seed, unsigned step, int vt, int sort,
                        unsigned row0, cudaStream_t stream) {
  return coal_formula(
      vt, sort ? lcp::kSort : lcp::kStride,
      coal_args(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out, rd3_out,
                kpa_out, x_out, z_out, nullptr, ovf, n_cell, cap, sstp,
                dt_sub, kern, coef, r_max_m1, clamp, seed, step, row0),
      stream);
}

// The resident step's form with the wide table (vohl_davis_no_waals; its
// row stride clamp + 2): lcp_coal's arguments.
extern "C" int lcp_coal_vohl(const float* n, const float* rw2,
                             const float* rd3, const float* kpa,
                             const float* x, const float* z,
                             const float* cells, const float* eff,
                             float* n_out, float* rw2_out, float* rd3_out,
                             float* kpa_out, float* x_out, float* z_out,
                             unsigned char* ovf, int n_cell, int cap,
                             int sstp, double dt_sub, int kern, double coef,
                             double r_max_m1, int clamp, unsigned seed,
                             unsigned step, int vt, int sort, unsigned row0,
                             cudaStream_t stream) {
  if (eff == nullptr || clamp < 127)
    return static_cast<int>(cudaErrorInvalidValue);
  return coal_formula(
      vt, sort ? lcp::kSort : lcp::kStride,
      coal_args(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out, rd3_out,
                kpa_out, x_out, z_out, nullptr, ovf, n_cell, cap, sstp,
                dt_sub, kern, coef, r_max_m1, clamp, seed, step, row0, true),
      stream);
}

// The standalone form (dense.coal), which also returns vt.
extern "C" int lcp_coal_standalone(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* x, const float* z, const float* cells, const float* eff,
    float* n_out, float* rw2_out, float* rd3_out, float* kpa_out,
    float* x_out, float* z_out, float* vt_out, unsigned char* ovf, int n_cell,
    int cap, int sstp, double dt_sub, int kern, double coef, double r_max_m1,
    int clamp, unsigned seed, unsigned step, int vt, cudaStream_t stream) {
  return coal_formula(
      vt, lcp::kStandalone,
      coal_args(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out, rd3_out,
                kpa_out, x_out, z_out, vt_out, ovf, n_cell, cap, sstp, dt_sub,
                kern, coef, r_max_m1, clamp, seed, step, 0),
      stream);
}

namespace {

int coal_y_formula(int vt, int sort, const lcp::CoalArgs& a, int* queue,
                   cudaStream_t stream) {
  return lcp::with_vt(vt, [&](auto f) {
    return lcp::coal_launch_y<decltype(f)::value>(
        sort ? lcp::kSort : lcp::kStride, a, queue, stream);
  });
}

lcp::CoalArgs with_y(lcp::CoalArgs a, const float* y, float* y_out) {
  a.y = y;
  a.y_out = y_out;
  return a;
}

}  // namespace

// The y forms, the resident step's on the 3-D grid (the y plane riding):
// lcp_coal's arguments up to the pairing, then the y plane in and out and
// the scratch of n_cell + 1 ints (coal_y.cuh: the rows the one-warp pass
// leaves to the wide form; unused up to cap 128); the grid's own rows.
// lcp_coal_3d reads the formula kernels and the hall family's tables,
// lcp_coal_vohl_3d vohl's wide table.
extern "C" int lcp_coal_3d(const float* n, const float* rw2, const float* rd3,
                           const float* kpa, const float* x, const float* z,
                           const float* cells, const float* eff,
                           float* n_out, float* rw2_out, float* rd3_out,
                           float* kpa_out, float* x_out, float* z_out,
                           unsigned char* ovf, int n_cell, int cap, int sstp,
                           double dt_sub, int kern, double coef,
                           double r_max_m1, int clamp, unsigned seed,
                           unsigned step, int vt, int sort, const float* y,
                           float* y_out, int* queue, cudaStream_t stream) {
  if (y == nullptr || y_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return coal_y_formula(
      vt, sort,
      with_y(coal_args(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out,
                       rd3_out, kpa_out, x_out, z_out, nullptr, ovf, n_cell,
                       cap, sstp, dt_sub, kern, coef, r_max_m1, clamp, seed,
                       step, 0),
             y, y_out),
      queue, stream);
}

extern "C" int lcp_coal_vohl_3d(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* x, const float* z, const float* cells, const float* eff,
    float* n_out, float* rw2_out, float* rd3_out, float* kpa_out,
    float* x_out, float* z_out, unsigned char* ovf, int n_cell, int cap,
    int sstp, double dt_sub, int kern, double coef, double r_max_m1,
    int clamp, unsigned seed, unsigned step, int vt, int sort,
    const float* y, float* y_out, int* queue, cudaStream_t stream) {
  if (eff == nullptr || clamp < 127 || y == nullptr || y_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return coal_y_formula(
      vt, sort,
      with_y(coal_args(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out,
                       rd3_out, kpa_out, x_out, z_out, nullptr, ovf, n_cell,
                       cap, sstp, dt_sub, kern, coef, r_max_m1, clamp, seed,
                       step, 0, true),
             y, y_out),
      queue, stream);
}

// The onishi form (onishi_hall, onishi_hall_davis_no_waals at dissipation
// rate 0; ``coef`` their kernel_parameters[0], the hall family's table):
// lcp_coal's arguments, row r drawing as row row0 + r (a shard's of the
// x-slab mesh on the 2-D grid), then the y plane in and out, null off the
// 3-D grid, and lcp_coal_3d's scratch.
extern "C" int lcp_coal_onishi(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* x, const float* z, const float* cells, const float* eff,
    float* n_out, float* rw2_out, float* rd3_out, float* kpa_out,
    float* x_out, float* z_out, unsigned char* ovf, int n_cell, int cap,
    int sstp, double dt_sub, int kern, double coef, double r_max_m1,
    int clamp, unsigned seed, unsigned step, int vt, int sort,
    unsigned row0, const float* y, float* y_out, int* queue,
    cudaStream_t stream) {
  if (eff == nullptr || clamp > 126 || (y == nullptr) != (y_out == nullptr)
      || (y != nullptr && row0 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return coal_y_formula(
      vt, sort,
      with_y(coal_args(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out,
                       rd3_out, kpa_out, x_out, z_out, nullptr, ovf, n_cell,
                       cap, sstp, dt_sub, kern, coef, r_max_m1, clamp, seed,
                       step, row0),
             y, y_out),
      queue, stream);
}

// The resident step's 2-D rows above capacity 128 (coal_y.cuh's warp
// rows: the one-warp pass over the rows whose droplets lie in their first
// 128 slots, the others queued to cap / 128 warps a row; no y plane):
// lcp_coal's arguments, row r drawing as row row0 + r (a shard's of the
// x-slab mesh), then lcp_coal_3d's scratch.  lcp_coal_warp_rows reads the
// formula kernels and the hall family's tables, lcp_coal_vohl_warp_rows
// vohl's wide table.
extern "C" int lcp_coal_warp_rows(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* x, const float* z, const float* cells, const float* eff,
    float* n_out, float* rw2_out, float* rd3_out, float* kpa_out,
    float* x_out, float* z_out, unsigned char* ovf, int n_cell, int cap,
    int sstp, double dt_sub, int kern, double coef, double r_max_m1,
    int clamp, unsigned seed, unsigned step, int vt, int sort,
    unsigned row0, int* queue, cudaStream_t stream) {
  if (eff != nullptr && clamp > 126)
    return static_cast<int>(cudaErrorInvalidValue);
  return coal_y_formula(
      vt, sort,
      coal_args(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out, rd3_out,
                kpa_out, x_out, z_out, nullptr, ovf, n_cell, cap, sstp,
                dt_sub, kern, coef, r_max_m1, clamp, seed, step, row0),
      queue, stream);
}

extern "C" int lcp_coal_vohl_warp_rows(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* x, const float* z, const float* cells, const float* eff,
    float* n_out, float* rw2_out, float* rd3_out, float* kpa_out,
    float* x_out, float* z_out, unsigned char* ovf, int n_cell, int cap,
    int sstp, double dt_sub, int kern, double coef, double r_max_m1,
    int clamp, unsigned seed, unsigned step, int vt, int sort,
    unsigned row0, int* queue, cudaStream_t stream) {
  if (eff == nullptr || clamp < 127)
    return static_cast<int>(cudaErrorInvalidValue);
  return coal_y_formula(
      vt, sort,
      coal_args(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out, rd3_out,
                kpa_out, x_out, z_out, nullptr, ovf, n_cell, cap, sstp,
                dt_sub, kern, coef, r_max_m1, clamp, seed, step, row0, true),
      queue, stream);
}

// Kernel E's y or onishi form's kernels on the card (coal_y.cuh
// coal_y_attrs) for formula ``vt``, pairing ``sort`` and capacity ``cap``:
// the wide form (``narrow`` 0) or the one-warp pass (``narrow`` 1)
extern "C" int lcp_coal_y_attrs(int vt, int sort, int cap, int narrow,
                                int* out) {
  return lcp::with_vt(vt, [&](auto f) {
    return lcp::coal_y_attrs<decltype(f)::value>(
        sort ? lcp::kSort : lcp::kStride, cap, narrow, out);
  });
}
