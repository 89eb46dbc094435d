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

#include <cuda_runtime.h>

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
constexpr bool kPredCorr = std::is_same_v<G, PredCorrGeometry>;

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

// cells: rows of n_cell: T p rhod eta C_l C_r C_b C_a, and w_LS after them
// with do_subs (the courants are read with do_adve)
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
  if constexpr (kUnwrapped<G>)
    i_row = static_cast<float>(geo.col0 + r / geo.nz);
  else
    i_row = static_cast<float>(r / geo.nz);
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
  const float w_ls = geo.do_subs ? __ldg(cells + 8 * n_cell + r) : 0.0f;

  float liq_vol = 0.0f, dry_vol = 0.0f, liq_num = 0.0f, prt_num = 0.0f;
  bool fell = false, far = false;
  const size_t base = static_cast<size_t>(r) * cap;
  for (int l0 = 4 * lane; l0 < cap; l0 += kTile) {
    const size_t off = base + l0;
    float nn[4], xx[4] = {}, zz[4] = {}, vt[4] = {};
    int tgt[4] = {-1, -1, -1, -1};
    load4<VEC>(n, off, l0, cap, 0.0f, nn);
    if (nn[0] > 0.0f || nn[1] > 0.0f || nn[2] > 0.0f || nn[3] > 0.0f) {
      float w2[4], xi[4] = {}, zi[4] = {};
      load4<VEC>(rw2, off, l0, cap, 0.0f, w2);
      if (moves) {
        load4<VEC>(x, off, l0, cap, 0.0f, xi);
        load4<VEC>(z, off, l0, cap, 0.0f, zi);
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
        if constexpr (kPredCorr<G>) {  // do_adve: the wrapper's pick
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
          const int lft = im * geo.nz + km, blw = lft + im;
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
        } else if (geo.do_adve) {  // euler
          xq = xq + dCx * (xq - geo.dx * i_row) + geo.dx * C_l;
          zq = zq + dCz * (zq - geo.dz * k_row) + geo.dz * C_b;
        }
        if (geo.do_sedi) zq = zq - geo.dt * vt[q];
        if (geo.do_subs) zq = zq - geo.dt * w_ls;

        if constexpr (!kUnwrapped<G>) {  // else the mesh wraps or kills
          if (!geo.open_side) {
            const float s = xq - geo.x0;
            xq = geo.x0 + (s - floorf(s / geo.wx) * geo.wx);
          } else if (xq >= geo.x1 || xq < geo.x0) {
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
          if constexpr (!kUnwrapped<G>) {
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
          } else if (!(xq < geo.x0 || xq >= geo.x1
                       || i_t < static_cast<float>(geo.col0)
                       || i_t >= static_cast<float>(geo.col0 + geo.ncol))) {
            // a droplet that stays in the shard; one that leaves keeps -1
            if (fabsf(dk) <= 1.0f && fabsf(di) <= 1.0f) {
              tgt[q] = (static_cast<int>(i_t) - geo.col0) * geo.nz
                       + static_cast<int>(k_t);
            } else {
              tgt[q] = r;
              far = true;
            }
          }
        }
        nn[q] = m;
        xx[q] = xq;
        zz[q] = zq;
      }
    }
    store4<VEC>(vt_out, off, l0, cap, vt);
    if (!moves) continue;
    store4<VEC>(n_out, off, l0, cap, nn);
    store4<VEC>(x_out, off, l0, cap, xx);
    store4<VEC>(z_out, off, l0, cap, zz);
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
