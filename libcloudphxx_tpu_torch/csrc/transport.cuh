// Kernel C: transport, walls/puddle and the re-binning classification.
//
// Replaces the transport phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 338-403: vt refresh
// by any formula of pallas_coal._vt_in_kernel, implicit/euler advection,
// sedimentation, subsidence, periodic/open walls, puddle partials) and
// the classification half of its re-binning epilogue
// (lines 414-487: target cell, far-mover flag).  Plain version: ops/step.py
// transport_plain.
//
// The TPU kernel decides statically which of advection, sedimentation and
// subsidence run (do_adve, do_sedi, do_subs); here they are flags of the
// one kernel.  With none of them on (the async phase of the public API
// with no transport) it refreshes vt alone: it reads n and rw2 and writes
// vt, and the walls, targets and row info are not touched.
//
// The unwrapped form (entry lcp_transport_unwrapped, the geometry a
// SlabGeometry) is the TPU kernel's x_wrap=False form (pallas_step.py:
// 378-382), which each shard of the dense x-slab mesh runs
// (parallel/dense_mesh.py): the rows are the global columns col0, col0 + 1,
// ... of the grid, x is left unwrapped and the open side walls do not
// kill; a droplet outside the shard's columns [col0, col0 + ncol) or
// outside the domain [x0, x1) gets target -1 and no far flag (the mesh
// moves it), the others a local target by the near test without its x-wrap
// clause.  The x-periodic form's instantiations take the Geometry of
// before, and their source is unchanged.
//
// The pred_corr form (entry lcp_transport_pred_corr, the geometry a
// PredCorrGeometry) advects by the predictor-corrector scheme, which the
// JAX package runs in XLA (lgrngn/dense.py:962-1005; plain version
// ops/step.py pred_corr): the euler predictor with the row's courants, z
// clamped inside the domain, x wrapped with its old position shifted
// alike, then the corrector's displacement with the courants of the cell
// the predictor reached, four loads from the staggered courant_x
// ((nx+1)*nz) and courant_z (nx*(nz+1)) through the read-only cache (the
// cell by a float64 division, as hskpng.ijk_of_xyz), and the mean of the
// two.  Sedimentation, subsidence, walls and targets follow as in the
// other forms.
//
// The pred_corr form on a shard of the x-slab mesh (entry
// lcp_transport_pred_corr_unwrapped, the geometry a PredCorrSlabGeometry),
// which the JAX package's mesh runs in XLA (lgrngn/dense.py:962-1005 with
// x_wrap=False): the rows as the unwrapped form's, the predictor and the
// corrector as the pred_corr form's, x wrapped as that form wraps it (the
// predictor's wrap and the final one; the open side walls do not kill), so
// that a shard's positions are the serial engine's bits.  The corrector's
// courants come from the halo-2 layout of parallel/decomp.py
// xchng_courants_pc: x faces -2 .. nx_pad + 2 ((nx_pad + 6) * nz values)
// and z columns -2 .. nx_pad + 1 ((nx_pad + 4) * (nz + 1)), indexed by the
// predictor's global column less col0, taken modulo nx into [-2, ncol + 1]
// (a predictor across the periodic wrap reads the ring's halo).  A droplet
// whose column is outside the shard's, or that moved across the periodic
// wrap (on one shard its column is the shard's own), gets target -1: the
// mesh moves it, as the serial engine's wrap clause sends it to the
// neighbouring column.
//
// The 3-D forms (entries lcp_transport_3d and lcp_transport_3d_pred_corr,
// the geometry a With3D<Geometry> or With3D<PredCorrGeometry>) run the
// 3-D grid, which the JAX package runs in XLA (lgrngn/dense.py:918-1030;
// plain version ops/step.py transport_plain with y3): row r is cell
// (i, j, k) = (r / (ny nz), (r / nz) % ny, r % nz); y is advected by the
// scheme of x with the row's front and hind courants C_f and C_h (cell
// rows 8 and 9, the subsidence row 10), wrapped by the periodic side walls
// or killed beyond the open ones after x; under pred_corr its predictor
// and corrector follow x's, the corrector's courant_y (nx*(ny+1)*nz) read
// at the predictor's cell as courant_x and courant_z are, in the 3-D
// index math of transport.courant_indices.  The target row is
// (i*ny + j)*nz + k, and a move by more than one cell in y (a wrap move
// aside: kernel D's 3-D form takes it, where the JAX package re-bins it
// globally) raises the far flag as one in x or z does.  The 2-D
// instantiations keep their code: every 3-D line is under
// ``if constexpr (kThreeD<G>)``.
//
// What bounds it on the card: memory.  It reads n for every slot and rw2,
// x and z for the live ones (rd3 only for a droplet that falls into the
// puddle), and writes n, x, z, vt and the target of every slot, with some
// 60 operations of arithmetic a live droplet beside its vt (under
// -fmad=false): vt_beard77's 45 (a log, an exp, divisions), beard76's
// 20-44 (by the droplet's regime), Khvorostyanov's 49-57 in float64 (four
// pow).  The vt formula is a template parameter; T is read only for
// beard76.
// What the design does about it: a warp a row in the layout of
// warp_rows.cuh (four consecutive slots a lane, 16-byte loads and stores
// at capacities that are multiples of 128), no __syncthreads() and no
// shared memory; the row's cell fields are loaded once a warp.  Slots dead
// at load (n == 0) skip vt, advection and walls and write n = x = z = vt =
// 0 and target -1, and a lane whose four slots are dead reads nothing but
// n.  The puddle partials and the far flag reduce by warp shuffle, the
// partials only in rows where a droplet fell (__any_sync).  The puddle is
// written as per-row partials that the caller sums: no float atomics, so it
// repeats run to run.  The TPU kernel merges the z movers in the same pass;
// here the merge is kernel D (merge.cu), which reads the targets written
// here once every row has them.
//
// The entry points are in transport.cu (the 2-D forms) and transport3d.cu
// (the 3-D forms, which run this row code in the scalar layout only; their
// 16-byte layout is transport3d.cuh's streaming kernel).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "physics.cuh"
#include "warp_rows.cuh"

namespace lcp {

struct Geometry {
  int nx, nz;
  float dx, dz, dt;
  float x0, z0, wx, wz, x1, z1;
  int implicit_adve, do_adve, do_sedi, do_subs, open_side, periodic_topbot;
};

// the unwrapped form's: the shard's first column and its width
struct SlabGeometry : Geometry {
  int col0, ncol;
};

template <class G>
constexpr bool kUnwrapped = std::is_same_v<G, SlabGeometry>;

// the pred_corr form's: the staggered courants, the grid steps in double
// (for the corrector's cell) and the predictor's z bounds
struct PredCorrGeometry : Geometry {
  const float* cx;
  const float* cz;
  double dx_d, dz_d;
  float z_lo, z_hi;
};

template <class G>
constexpr bool kPredCorr = std::is_base_of_v<PredCorrGeometry, G>;

// the pred_corr form's on a shard: the shard's first column and its width
// (the courants in the halo-2 layout)
struct PredCorrSlabGeometry : PredCorrGeometry {
  int col0, ncol;
};

// the forms on a shard's rows (x unwrapped in the euler and implicit form,
// wrapped as the serial engine wraps it in the pred_corr form)
template <class G>
constexpr bool kSlab =
    kUnwrapped<G> || std::is_same_v<G, PredCorrSlabGeometry>;

// the 3-D forms' y axis: the rows of columns, y's bounds, the y plane in
// and out, and courant_y (read by the pred_corr form)
struct YAxis {
  int ny;
  float dy, y0, wy, y1;
  double dy_d;
  const float* y;
  float* y_out;
  const float* cy;
};

template <class G>
struct With3D : G {
  YAxis ya;
};

template <class G>
constexpr bool kThreeD = false;
template <class G>
constexpr bool kThreeD<With3D<G>> = true;

// hskpng.ijk_of_xyz's cell along one axis: a float64 division, the floor
// clamped to [0, n)
__device__ __forceinline__ int cell_of(float pos, double d, int n) {
  const double q = floor(static_cast<double>(pos) / d);
  return q < 0.0 ? 0 : q > n - 1 ? n - 1 : static_cast<int>(q);
}

__device__ __forceinline__ float warp_sum(float v) {
  // a fixed butterfly: every lane ends with the same bits, run to run
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// cells: rows of n_cell: T p rhod eta C_l C_r C_b C_a (the 3-D forms C_f
// C_h after them), and w_LS after those with do_subs (the courants are
// read with do_adve)
// rowinfo: (n_cell, 8): liq_vol dry_vol liq_num prt_num far 0 0 0
template <bool VEC, int VT, class G>
__global__ void __launch_bounds__(kWarpRows * 32)
transport_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
                 const float* __restrict__ rd3, const float* __restrict__ x,
                 const float* __restrict__ z, const float* __restrict__ cells,
                 float* __restrict__ n_out, float* __restrict__ x_out,
                 float* __restrict__ z_out, float* __restrict__ vt_out,
                 int* __restrict__ tgt_out, float* __restrict__ rowinfo,
                 int n_cell, int cap, G geo) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= n_cell) return;  // the whole warp
  float i_row;
  [[maybe_unused]] float j_row = 0.0f;
  if constexpr (kSlab<G>) {
    i_row = static_cast<float>(geo.col0 + r / geo.nz);
  } else if constexpr (kThreeD<G>) {
    i_row = static_cast<float>(r / (geo.ya.ny * geo.nz));
    j_row = static_cast<float>((r / geo.nz) % geo.ya.ny);
  } else {
    i_row = static_cast<float>(r / geo.nz);
  }
  const float k_row = static_cast<float>(r % geo.nz);
  // the cell's fields, T only for a formula that reads it
  const Ambient amb{vt_reads_T<VT>() ? __ldg(cells + r) : 0.0f,
                    __ldg(cells + 1 * n_cell + r),
                    __ldg(cells + 2 * n_cell + r),
                    __ldg(cells + 3 * n_cell + r)};
  const bool moves = geo.do_adve || geo.do_sedi || geo.do_subs;
  float C_l = 0.0f, C_r = 0.0f, C_b = 0.0f, C_a = 0.0f;
  if (geo.do_adve) {
    C_l = __ldg(cells + 4 * n_cell + r);
    C_r = __ldg(cells + 5 * n_cell + r);
    C_b = __ldg(cells + 6 * n_cell + r);
    C_a = __ldg(cells + 7 * n_cell + r);
  }
  const float dCx = C_r - C_l;
  const float dCz = C_a - C_b;
  [[maybe_unused]] float C_f = 0.0f, C_h = 0.0f;
  if constexpr (kThreeD<G>) {
    if (geo.do_adve) {
      C_f = __ldg(cells + 8 * n_cell + r);
      C_h = __ldg(cells + 9 * n_cell + r);
    }
  }
  [[maybe_unused]] const float dCy = C_h - C_f;
  constexpr int kSubsRow = kThreeD<G> ? 10 : 8;
  const float w_ls =
      geo.do_subs ? __ldg(cells + kSubsRow * n_cell + r) : 0.0f;

  float liq_vol = 0.0f, dry_vol = 0.0f, liq_num = 0.0f, prt_num = 0.0f;
  bool fell = false, far = false;
  const size_t base = static_cast<size_t>(r) * cap;
  for (int l0 = 4 * lane; l0 < cap; l0 += kTile) {
    const size_t off = base + l0;
    float nn[4], xx[4] = {}, zz[4] = {}, vt[4] = {};
    [[maybe_unused]] float yy[4] = {};
    int tgt[4] = {-1, -1, -1, -1};
    load4<VEC>(n, off, l0, cap, 0.0f, nn);
    if (nn[0] > 0.0f || nn[1] > 0.0f || nn[2] > 0.0f || nn[3] > 0.0f) {
      float w2[4], xi[4] = {}, zi[4] = {};
      [[maybe_unused]] float yi[4] = {};
      load4<VEC>(rw2, off, l0, cap, 0.0f, w2);
      if (moves) {
        load4<VEC>(x, off, l0, cap, 0.0f, xi);
        load4<VEC>(z, off, l0, cap, 0.0f, zi);
        if constexpr (kThreeD<G>) load4<VEC>(geo.ya.y, off, l0, cap, 0.0f, yi);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(nn[q] > 0.0f)) {
          nn[q] = 0.0f;
          continue;
        }
        vt[q] = vt_formula<VT>(w2[q], amb);
        if (!moves) continue;
        float m = nn[q], xq = xi[q], zq = zi[q];
        [[maybe_unused]] float yq = yi[q];
        if constexpr (kPredCorr<G> && kThreeD<G>) {  // do_adve
          float xo = xq, zo = zq, yo = yq;
          xq = xq + dCx * (xq - geo.dx * i_row) + geo.dx * C_l;
          zq = zq + dCz * (zq - geo.dz * k_row) + geo.dz * C_b;
          yq = yq + dCy * (yq - geo.ya.dy * j_row) + geo.ya.dy * C_f;
          zq = fminf(fmaxf(zq, geo.z_lo), geo.z_hi);
          if (!geo.open_side) {
            const float s = xq - geo.x0;
            const float xw = geo.x0 + (s - floorf(s / geo.wx) * geo.wx);
            xo = xo + (xw - xq);
            xq = xw;
            const float t = yq - geo.ya.y0;
            const float yw =
                geo.ya.y0 + (t - floorf(t / geo.ya.wy) * geo.ya.wy);
            yo = yo + (yw - yq);
            yq = yw;
          }
          const int im = cell_of(xq, geo.dx_d, geo.nx);
          const int jm = cell_of(yq, geo.ya.dy_d, geo.ya.ny);
          const int km = cell_of(zq, geo.dz_d, geo.nz);
          const int lft = (im * geo.ya.ny + jm) * geo.nz + km;
          const int blw = lft + im * geo.ya.ny + jm, fre = lft + im * geo.nz;
          const float cl = __ldg(geo.cx + lft);
          const float cr = __ldg(geo.cx + lft + geo.ya.ny * geo.nz);
          const float cb = __ldg(geo.cz + blw);
          const float ca = __ldg(geo.cz + blw + 1);
          const float cf = __ldg(geo.ya.cy + fre);
          const float ch = __ldg(geo.ya.cy + fre + geo.nz);
          const float dxm = (cr - cl) * (xq - geo.dx * static_cast<float>(im))
                            + geo.dx * cl;
          const float dzm = (ca - cb) * (zq - geo.dz * static_cast<float>(km))
                            + geo.dz * cb;
          const float dym =
              (ch - cf) * (yq - geo.ya.dy * static_cast<float>(jm))
              + geo.ya.dy * cf;
          xq = (xq + xo + dxm) / 2.0f;
          zq = (zq + zo + dzm) / 2.0f;
          yq = (yq + yo + dym) / 2.0f;
        } else if constexpr (kPredCorr<G>) {  // do_adve: the wrapper's pick
          float xo = xq, zo = zq;
          xq = xq + dCx * (xq - geo.dx * i_row) + geo.dx * C_l;
          zq = zq + dCz * (zq - geo.dz * k_row) + geo.dz * C_b;
          zq = fminf(fmaxf(zq, geo.z_lo), geo.z_hi);
          if (!geo.open_side) {
            const float s = xq - geo.x0;
            const float xw = geo.x0 + (s - floorf(s / geo.wx) * geo.wx);
            xo = xo + (xw - xq);
            xq = xw;
          }
          const int im = cell_of(xq, geo.dx_d, geo.nx);
          const int km = cell_of(zq, geo.dz_d, geo.nz);
          int lft = im * geo.nz + km, blw = lft + im;
          if constexpr (kSlab<G>) {  // the halo-2 layout, from column -2
            int li = im - geo.col0;
            if (li < -2)
              li += geo.nx;
            else if (li > geo.ncol + 1)
              li -= geo.nx;
            li = li < -2 ? -2 : li > geo.ncol + 1 ? geo.ncol + 1 : li;
            lft = (li + 2) * geo.nz + km;
            blw = (li + 2) * (geo.nz + 1) + km;
          }
          const float cl = __ldg(geo.cx + lft);
          const float cr = __ldg(geo.cx + lft + geo.nz);
          const float cb = __ldg(geo.cz + blw);
          const float ca = __ldg(geo.cz + blw + 1);
          const float dxm = (cr - cl) * (xq - geo.dx * static_cast<float>(im))
                            + geo.dx * cl;
          const float dzm = (ca - cb) * (zq - geo.dz * static_cast<float>(km))
                            + geo.dz * cb;
          xq = (xq + xo + dxm) / 2.0f;
          zq = (zq + zo + dzm) / 2.0f;
        } else if (geo.do_adve && geo.implicit_adve) {
          xq = (xq + geo.dx * (C_l - i_row * dCx)) / (1.0f - dCx);
          zq = (zq + geo.dz * (C_b - k_row * dCz)) / (1.0f - dCz);
          if constexpr (kThreeD<G>)
            yq = (yq + geo.ya.dy * (C_f - j_row * dCy)) / (1.0f - dCy);
        } else if (geo.do_adve) {  // euler
          xq = xq + dCx * (xq - geo.dx * i_row) + geo.dx * C_l;
          zq = zq + dCz * (zq - geo.dz * k_row) + geo.dz * C_b;
          if constexpr (kThreeD<G>)
            yq = yq + dCy * (yq - geo.ya.dy * j_row) + geo.ya.dy * C_f;
        }
        if (geo.do_sedi) zq = zq - geo.dt * vt[q];
        if (geo.do_subs) zq = zq - geo.dt * w_ls;

        if constexpr (!kSlab<G>) {  // else the mesh wraps or kills
          if (!geo.open_side) {
            const float s = xq - geo.x0;
            xq = geo.x0 + (s - floorf(s / geo.wx) * geo.wx);
          } else if (xq >= geo.x1 || xq < geo.x0) {
            m = 0.0f;
          }
        } else if constexpr (kPredCorr<G>) {  // the serial form's wrap
          if (!geo.open_side) {
            const float s = xq - geo.x0;
            xq = geo.x0 + (s - floorf(s / geo.wx) * geo.wx);
          }
        }
        if constexpr (kThreeD<G>) {  // the y side walls, as x's
          if (!geo.open_side) {
            const float s = yq - geo.ya.y0;
            yq = geo.ya.y0 + (s - floorf(s / geo.ya.wy) * geo.ya.wy);
          } else if (yq >= geo.ya.y1 || yq < geo.ya.y0) {
            m = 0.0f;
          }
        }
        if (geo.periodic_topbot) {
          const float s = zq - geo.z0;
          zq = geo.z0 + (s - floorf(s / geo.wz) * geo.wz);
        } else {
          if (zq >= geo.z1) m = 0.0f;
          if (zq < geo.z0 && m > 0.0f) {
            // the droplet falls through the bottom into the puddle
            const float w = w2[q];
            liq_vol += F((4.0 / 3) * pi) * m * w * sqrtf(fmaxf(w, 0.0f));
            dry_vol += F((4.0 / 3) * pi) * m * __ldg(rd3 + off + q);
            liq_num += w > 0.0f ? m : 0.0f;
            prt_num += m;
            fell = true;
            m = 0.0f;
          }
        }

        // target cell: the same float math as the TPU kernel (the grid
        // starts at 0, not at x0); movers by more than one cell on an axis
        // stay in their row and raise the flag for the global re-bin
        if (m > 0.0f) {
          const float k_t = fminf(fmaxf(floorf(zq / geo.dz), 0.0f),
                                  static_cast<float>(geo.nz - 1));
          const float i_t = fminf(fmaxf(floorf(xq / geo.dx), 0.0f),
                                  static_cast<float>(geo.nx - 1));
          const float dk = k_t - k_row;
          const float di = i_t - i_row;
          if constexpr (kThreeD<G>) {
            const float j_t =
                fminf(fmaxf(floorf(yq / geo.ya.dy), 0.0f),
                      static_cast<float>(geo.ya.ny - 1));
            const float dj = j_t - j_row;
            const float wrap = static_cast<float>(geo.nx - 1);
            const float wrap_j = static_cast<float>(geo.ya.ny - 1);
            const bool near_z = fabsf(dk) <= 1.0f;
            const bool near_x = di == 0.0f || di == 1.0f || di == -1.0f
                                || di == wrap || di == -wrap;
            const bool near_y = dj == 0.0f || dj == 1.0f || dj == -1.0f
                                || dj == wrap_j || dj == -wrap_j;
            if (near_z && near_x && near_y) {
              tgt[q] = (static_cast<int>(i_t) * geo.ya.ny
                        + static_cast<int>(j_t)) * geo.nz
                       + static_cast<int>(k_t);
            } else {
              tgt[q] = r;
              far = true;
            }
          } else if constexpr (!kSlab<G>) {
            const float wrap = static_cast<float>(geo.nx - 1);
            const bool near_z = fabsf(dk) <= 1.0f;
            const bool near_x = di == 0.0f || di == 1.0f || di == -1.0f
                                || di == wrap || di == -wrap;
            if (near_z && near_x) {
              tgt[q] = static_cast<int>(i_t) * geo.nz + static_cast<int>(k_t);
            } else {
              tgt[q] = r;
              far = true;
            }
          } else {
            bool leaves = xq < geo.x0 || xq >= geo.x1
                          || i_t < static_cast<float>(geo.col0)
                          || i_t >= static_cast<float>(geo.col0 + geo.ncol);
            if constexpr (kPredCorr<G>) {  // a move across the wrap
              const float wrap = static_cast<float>(geo.nx - 1);
              leaves = leaves || (!geo.open_side && wrap > 1.0f
                                  && (di == wrap || di == -wrap));
            }
            // a droplet that stays in the shard; one that leaves keeps -1
            if (!leaves && fabsf(dk) <= 1.0f && fabsf(di) <= 1.0f) {
              tgt[q] = (static_cast<int>(i_t) - geo.col0) * geo.nz
                       + static_cast<int>(k_t);
            } else if (!leaves) {
              tgt[q] = r;
              far = true;
            }
          }
        }
        nn[q] = m;
        xx[q] = xq;
        zz[q] = zq;
        if constexpr (kThreeD<G>) yy[q] = yq;
      }
    }
    store4<VEC>(vt_out, off, l0, cap, vt);
    if (!moves) continue;
    store4<VEC>(n_out, off, l0, cap, nn);
    store4<VEC>(x_out, off, l0, cap, xx);
    store4<VEC>(z_out, off, l0, cap, zz);
    if constexpr (kThreeD<G>) store4<VEC>(geo.ya.y_out, off, l0, cap, yy);
    store4<VEC>(tgt_out, off, l0, cap, tgt);
  }
  if (!moves) return;  // the whole warp

  if (__any_sync(kAll, fell)) {
    liq_vol = warp_sum(liq_vol);
    dry_vol = warp_sum(dry_vol);
    liq_num = warp_sum(liq_num);
    prt_num = warp_sum(prt_num);
  }
  const float far_row = __any_sync(kAll, far) ? 1.0f : 0.0f;
  if (lane < 8) {
    const float info[8] = {liq_vol, dry_vol, liq_num, prt_num, far_row,
                           0.0f, 0.0f, 0.0f};
    float v = info[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) v = lane == j ? info[j] : v;
    rowinfo[static_cast<size_t>(r) * 8 + lane] = v;
  }
}

}  // namespace lcp

namespace {

template <class G>
int transport_launch(const float* n, const float* rw2, const float* rd3,
                     const float* x, const float* z, const float* cells,
                     float* n_out, float* x_out, float* z_out, float* vt_out,
                     int* tgt_out, float* rowinfo, int n_cell, int cap,
                     const G& geo, int vt, cudaStream_t stream) {
  // with no transport only n, rw2, the cell fields and vt are passed (the
  // other pointers may be null)
  const bool vec = lcp::vector_ok(
      cap, {n, rw2, x, z, n_out, x_out, z_out, vt_out, tgt_out});
  const dim3 grid(lcp::row_blocks(n_cell)), block(lcp::kWarpRows * 32);
  return lcp::with_vt(vt, [&](auto f) {
    constexpr int VT = decltype(f)::value;
    if (vec)
      lcp::transport_kernel<true, VT, G><<<grid, block, 0, stream>>>(
          n, rw2, rd3, x, z, cells, n_out, x_out, z_out, vt_out, tgt_out,
          rowinfo, n_cell, cap, geo);
    else
      lcp::transport_kernel<false, VT, G><<<grid, block, 0, stream>>>(
          n, rw2, rd3, x, z, cells, n_out, x_out, z_out, vt_out, tgt_out,
          rowinfo, n_cell, cap, geo);
    return static_cast<int>(cudaGetLastError());
  });
}

lcp::Geometry geometry(int nx, int nz, double dx, double dz, double dt,
                       double x0, double x1, double z0, double z1,
                       int implicit_adve, int do_adve, int do_sedi,
                       int do_subs, int open_side, int periodic_topbot) {
  return lcp::Geometry{nx, nz,
                       static_cast<float>(dx), static_cast<float>(dz),
                       static_cast<float>(dt), static_cast<float>(x0),
                       static_cast<float>(z0), static_cast<float>(x1 - x0),
                       static_cast<float>(z1 - z0), static_cast<float>(x1),
                       static_cast<float>(z1), implicit_adve, do_adve,
                       do_sedi, do_subs, open_side, periodic_topbot};
}

}  // namespace
