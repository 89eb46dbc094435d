// Kernel C's 3-D forms in their streaming design (transport3d.cu:
// lcp_transport_3d, lcp_transport_3d_pred_corr, in the 16-byte layout; the
// scalar layout keeps transport.cuh's row code).
//
// Replaces the transport phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 338-487) on the 3-D
// grid, which the TPU kernel refuses and the JAX package runs in XLA
// (libcloudphxx_tpu/lgrngn/dense.py:918-1030).  Plain version: ops/step.py
// transport_plain with y3.
//
// The per-droplet arithmetic, its order and its float64 steps are
// transport.cuh's kThreeD lines, copied into droplet3d below (so that the
// 2-D instantiations of transport.cuh keep their code): vt by formula,
// implicit / euler / pred_corr advection, sedimentation, subsidence, the x
// and y side walls, the top and bottom walls and the puddle, the target
// row and the far flag.  What changed is how the bytes move.
//
// What bounds it on the card: memory.  At 76^3 and capacity 128 it reads
// n for every slot and rw2, x, z, y for the 28.1 M live droplets, and
// writes n, x, z, y, vt and the target of all 56.2 M slots: ~2.05 GB,
// 0.61 ms at 3.35 TB/s.  What held the old shape (transport.cuh: a warp a
// row, 8 rows a block, a block gone after its rows) at 42% of that bound
// (1.4645 ms in the step): each row made two dependent device-memory round
// trips (n, then the planes of the lanes with a live slot) before its
// arithmetic, and only then its stores, so the bytes in flight an SM were
// its resident warps' one tile each; and a row holds its droplets first
// (E's shuffle, D's compaction), so half of every warp's lanes (at 64 of
// 128 slots) idled through the arithmetic, whose float divisions at
// -fmad=false cost as many instructions as the bytes cost time.  At
// capacity 256 (the pred_corr case's rows of at most 65 droplets) three
// quarters idled, and the second tile's n waited behind the first tile's
// stores.
// What this design does about it:
//   - a block takes a brick of B = 8 R consecutive rows (ops/step.py
//     transport3d_plan: R rows a warp, R = max(1, 512 / cap)), one
//     contiguous span of every plane; the blocks are persistent, about as
//     many as the card holds at once, and walk the bricks b, b + blocks,
//     ...  Warp w of a block takes the brick's rows w, w + 8, ..., so the
//     block streams consecutive rows;
//   - each warp prefetches the n of its rows kC3Ahead rows ahead, and the
//     row's cell fields beside it, with cp.async into a ring of shared
//     memory (no registers held, completion by cp.async.wait_group): a
//     row's n has arrived before the warp reaches it;
//   - from the row's n the warp builds the list of its live slots in slot
//     order (four ballots a 128-slot tile, no shared-memory scan) and
//     writes the dead slots at once (n = x = z = y = vt = 0, target -1;
//     16-byte stores where a lane's four slots are all dead): they depend
//     on nothing but n.  A dead slot in the middle of a row is dead like
//     any other; live-first rows only make the live stores contiguous;
//   - then the lanes take the live droplets, list rank lane, lane + 32,
//     ... (kC3Chunk a lane at once): every load of a chunk (rw2, x, z, y)
//     is issued before its arithmetic, every lane computes a live droplet,
//     and the stores of consecutive droplets are consecutive addresses;
//   - the row info keeps the old shape's order: the far flag is a ballot,
//     and in a row where a droplet fell into the puddle (the bottom
//     level's, ~1% of the rows) each lane recomputes its slots of the old
//     layout (4 j .. 4 j + 3 of each tile) in the old order, so the
//     partials and the fixed warp butterfly give the old bits, run to run.
// The constants are the fastest of the variants timed on phase 22's
// arguments (H100; scripts/transport3d_variants.py): two droplets a lane
// at once (76-78 registers under beard77, no spill; four spilled at the
// launch bounds' 80), three blocks of 8 warps an SM, n two rows ahead.  Two blocks or four, n four rows ahead, and the
// next row's planes staged in shared memory by cp.async too (one round
// trip fewer a row) each ran no faster, so the bytes in flight no longer
// set the pace; the arithmetic's instructions are the likely limit (not
// profiled: Nsight Compute does not run on the card's machine).
// What it measured: PERF.md section 6 (chip_smoke.py phase 22).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "transport.cuh"

namespace lcp {

constexpr int kC3Warps = 8;    // warps a block: a row each at a time
constexpr int kC3Ahead = 2;    // rows a warp's prefetch of n runs ahead
constexpr int kC3Fields = 16;  // floats of a row's fields in its ring slot
constexpr int kC3Chunk = 2;    // live droplets a lane takes at once
constexpr int kC3Slots = 512;  // slots of a warp's rows in a brick (R cap)
constexpr int kC3MinBlocks = 3;  // blocks an SM the launch bounds keep

// a brick's rows a warp at row capacity ``cap``
__host__ __device__ constexpr int c3_rows_a_warp(int cap) {
  return cap >= kC3Slots ? 1 : kC3Slots / cap;
}

// a block's dynamic shared memory at row capacity ``cap``: each warp's
// ring of kC3Ahead + 1 rows (n, then the row's fields), then its list of
// live slots (2 bytes a slot)
__host__ __device__ constexpr size_t c3_smem(int cap) {
  return static_cast<size_t>(kC3Warps)
         * ((kC3Ahead + 1) * (cap + kC3Fields) * 4 + 2 * cap);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A row's place and fields, as transport.cuh's kernel reads them
struct Row3 {
  float i_row, j_row, k_row;
  float C_l, C_b, C_f, dCx, dCz, dCy, w_ls;
  int r;
};

// One droplet's outcome: its multiplicity, position and vt after the
// step, its target, whether it is a far mover, and whether (with what
// multiplicity) it fell into the puddle
struct Drop3 {
  float m, x, z, y, vt;
  int tgt;
  bool far, fell;
  float m_fell;
};

// transport.cuh's per-droplet body on the 3-D grid for a live droplet
// (n > 0) of multiplicity ``m``: the same operations in the same order
template <int VT, class G>
__device__ __forceinline__ Drop3 droplet3d(const G& geo, const Ambient& amb,
                                           const Row3& w, bool moves,
                                           float m, float w2, float xq,
                                           float zq, float yq) {
  Drop3 d{m, xq, zq, yq, vt_formula<VT>(w2, amb), -1, false, false, 0.0f};
  if (!moves) return d;
  const float i_row = w.i_row, j_row = w.j_row, k_row = w.k_row;
  const float C_l = w.C_l, C_b = w.C_b, C_f = w.C_f;
  const float dCx = w.dCx, dCz = w.dCz, dCy = w.dCy;
  if constexpr (kPredCorr<G>) {  // do_adve
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
      const float yw = geo.ya.y0 + (t - floorf(t / geo.ya.wy) * geo.ya.wy);
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
    const float dxm =
        (cr - cl) * (xq - geo.dx * static_cast<float>(im)) + geo.dx * cl;
    const float dzm =
        (ca - cb) * (zq - geo.dz * static_cast<float>(km)) + geo.dz * cb;
    const float dym = (ch - cf) * (yq - geo.ya.dy * static_cast<float>(jm))
                      + geo.ya.dy * cf;
    xq = (xq + xo + dxm) / 2.0f;
    zq = (zq + zo + dzm) / 2.0f;
    yq = (yq + yo + dym) / 2.0f;
  } else if (geo.do_adve && geo.implicit_adve) {
    xq = (xq + geo.dx * (C_l - i_row * dCx)) / (1.0f - dCx);
    zq = (zq + geo.dz * (C_b - k_row * dCz)) / (1.0f - dCz);
    yq = (yq + geo.ya.dy * (C_f - j_row * dCy)) / (1.0f - dCy);
  } else if (geo.do_adve) {  // euler
    xq = xq + dCx * (xq - geo.dx * i_row) + geo.dx * C_l;
    zq = zq + dCz * (zq - geo.dz * k_row) + geo.dz * C_b;
    yq = yq + dCy * (yq - geo.ya.dy * j_row) + geo.ya.dy * C_f;
  }
  if (geo.do_sedi) zq = zq - geo.dt * d.vt;
  if (geo.do_subs) zq = zq - geo.dt * w.w_ls;

  if (!geo.open_side) {
    const float s = xq - geo.x0;
    xq = geo.x0 + (s - floorf(s / geo.wx) * geo.wx);
  } else if (xq >= geo.x1 || xq < geo.x0) {
    m = 0.0f;
  }
  if (!geo.open_side) {  // the y side walls, as x's
    const float s = yq - geo.ya.y0;
    yq = geo.ya.y0 + (s - floorf(s / geo.ya.wy) * geo.ya.wy);
  } else if (yq >= geo.ya.y1 || yq < geo.ya.y0) {
    m = 0.0f;
  }
  if (geo.periodic_topbot) {
    const float s = zq - geo.z0;
    zq = geo.z0 + (s - floorf(s / geo.wz) * geo.wz);
  } else {
    if (zq >= geo.z1) m = 0.0f;
    if (zq < geo.z0 && m > 0.0f) {  // through the bottom into the puddle
      d.fell = true;
      d.m_fell = m;
      m = 0.0f;
    }
  }

  // target cell: the same float math as the TPU kernel (the grid starts
  // at 0, not at x0); movers by more than one cell on an axis stay in
  // their row and raise the flag for the global re-bin
  if (m > 0.0f) {
    const float k_t = fminf(fmaxf(floorf(zq / geo.dz), 0.0f),
                            static_cast<float>(geo.nz - 1));
    const float i_t = fminf(fmaxf(floorf(xq / geo.dx), 0.0f),
                            static_cast<float>(geo.nx - 1));
    const float dk = k_t - k_row;
    const float di = i_t - i_row;
    const float j_t = fminf(fmaxf(floorf(yq / geo.ya.dy), 0.0f),
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
      d.tgt = (static_cast<int>(i_t) * geo.ya.ny + static_cast<int>(j_t))
                  * geo.nz
              + static_cast<int>(k_t);
    } else {
      d.tgt = w.r;
      d.far = true;
    }
  }
  d.m = m;
  d.x = xq;
  d.z = zq;
  d.y = yq;
  return d;
}

// The row's fields from its ring slot ``fr`` and its place ``r``
template <int VT, class G>
__device__ __forceinline__ Row3 row_of3(const G& geo, const float* fr, int r,
                                        Ambient& amb) {
  amb = Ambient{vt_reads_T<VT>() ? fr[0] : 0.0f, fr[1], fr[2], fr[3]};
  Row3 w;
  w.r = r;
  w.i_row = static_cast<float>(r / (geo.ya.ny * geo.nz));
  w.j_row = static_cast<float>((r / geo.nz) % geo.ya.ny);
  w.k_row = static_cast<float>(r % geo.nz);
  float C_r = 0.0f, C_a = 0.0f, C_h = 0.0f;
  w.C_l = w.C_b = w.C_f = 0.0f;
  if (geo.do_adve) {
    w.C_l = fr[4];
    C_r = fr[5];
    w.C_b = fr[6];
    C_a = fr[7];
    w.C_f = fr[8];
    C_h = fr[9];
  }
  w.dCx = C_r - w.C_l;
  w.dCz = C_a - w.C_b;
  w.dCy = C_h - w.C_f;
  w.w_ls = geo.do_subs ? fr[10] : 0.0f;
  return w;
}

// A row's live slots from its n (``nr``, in shared memory) into ``list``
// in slot order, and its dead slots written (16 bytes where a lane's four
// are dead).  Returns the live count.
__device__ __forceinline__ int list_row(
    const float* nr, unsigned short* list, size_t base, int cap, int lane,
    bool moves, float* __restrict__ n_out,
    float* __restrict__ x_out, float* __restrict__ z_out,
    float* __restrict__ y_out, float* __restrict__ vt_out,
    int* __restrict__ tgt_out) {
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  for (int l0 = 4 * lane; l0 < cap; l0 += kTile) {
    const float4 nv = *reinterpret_cast<const float4*>(nr + l0);
    const bool live[4] = {nv.x > 0.0f, nv.y > 0.0f, nv.z > 0.0f,
                          nv.w > 0.0f};
    int pos = total;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned b = __ballot_sync(kAll, live[q]);
      pos += __popc(b & below);
      total += __popc(b);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (live[q]) list[pos++] = static_cast<unsigned short>(l0 + q);
    const size_t off = base + l0;
    if (!(live[0] || live[1] || live[2] || live[3])) {
      const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int none[4] = {-1, -1, -1, -1};
      store4<true>(vt_out, off, l0, cap, zero);
      if (moves) {
        store4<true>(n_out, off, l0, cap, zero);
        store4<true>(x_out, off, l0, cap, zero);
        store4<true>(z_out, off, l0, cap, zero);
        store4<true>(y_out, off, l0, cap, zero);
        store4<true>(tgt_out, off, l0, cap, none);
      }
      continue;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (live[q]) continue;
      vt_out[off + q] = 0.0f;
      if (moves) {
        n_out[off + q] = 0.0f;
        x_out[off + q] = 0.0f;
        z_out[off + q] = 0.0f;
        y_out[off + q] = 0.0f;
        tgt_out[off + q] = -1;
      }
    }
  }
  return total;
}

// cells: rows of n_cell: T p rhod eta C_l C_r C_b C_a C_f C_h, and w_LS
// after those with do_subs; rowinfo (n_cell, 8): liq_vol dry_vol liq_num
// prt_num far 0 0 0.  The planes in the 16-byte layout (cap % 128 == 0,
// every plane 16-byte aligned); ``rows`` a brick's rows a warp.
template <int VT, class G>
__global__ void __launch_bounds__(kC3Warps * 32, kC3MinBlocks)
transport3d_kernel(const float* __restrict__ n, const float* __restrict__ rw2,
                   const float* __restrict__ rd3,
                   const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ y,
                   const float* __restrict__ cells,
                   float* __restrict__ n_out, float* __restrict__ x_out,
                   float* __restrict__ z_out, float* __restrict__ y_out,
                   float* __restrict__ vt_out, int* __restrict__ tgt_out,
                   float* __restrict__ rowinfo, int n_cell, int cap,
                   int rows, G geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int ring_stride = cap + kC3Fields;  // floats a ring slot
  float* const ring = reinterpret_cast<float*>(smem)
                      + wp * (kC3Ahead + 1) * ring_stride;
  unsigned short* const list = reinterpret_cast<unsigned short*>(
      reinterpret_cast<float*>(smem)
      + kC3Warps * (kC3Ahead + 1) * ring_stride) + wp * cap;
  const bool moves = geo.do_adve || geo.do_sedi || geo.do_subs;
  const int brick = kC3Warps * rows;
  // the warp's i-th row: brick blockIdx.x + (i / rows) gridDim.x, its row
  // wp + 8 (i % rows); rows grow with i, so the first past n_cell ends it
  auto row_of = [&](int i) {
    const long long b = blockIdx.x + static_cast<long long>(i / rows)
                                         * gridDim.x;
    const long long r = b * brick + (i % rows) * kC3Warps + wp;
    return r < n_cell ? static_cast<int>(r) : -1;
  };
  // prefetch row i's n and fields into its ring slot (a group a call,
  // empty past the last row)
  auto prefetch = [&](int i) {
    const int r = row_of(i);
    if (r >= 0) {
      float* const slot = ring + (i % (kC3Ahead + 1)) * ring_stride;
      const size_t base = static_cast<size_t>(r) * cap;
      for (int l0 = 4 * lane; l0 < cap; l0 += kTile)
        cp_async16(slot + l0, n + base + l0);
      const bool field = lane < 4 || (lane < 10 && geo.do_adve)
                         || (lane == 10 && geo.do_subs);
      if (field)
        cp_async4(slot + cap + lane,
                  cells + static_cast<size_t>(lane) * n_cell + r);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kC3Ahead; ++i) prefetch(i);

  for (int i = 0;; ++i) {
    const int r = row_of(i);
    if (r < 0) break;  // the whole warp
    prefetch(i + kC3Ahead);
    cp_async_wait<kC3Ahead>();
    __syncwarp();
    const float* const nr = ring + (i % (kC3Ahead + 1)) * ring_stride;
    const size_t base = static_cast<size_t>(r) * cap;
    Ambient amb;
    const Row3 w = row_of3<VT>(geo, nr + cap, r, amb);
    const int total = list_row(nr, list, base, cap, lane, moves, n_out,
                               x_out, z_out, y_out, vt_out, tgt_out);
    __syncwarp();

    // the live droplets, kC3Chunk a lane at once: loads, then arithmetic
    bool far = false, fell = false;
    for (int c0 = 0; c0 < total; c0 += 32 * kC3Chunk) {
      int s[kC3Chunk];
      float w2[kC3Chunk], xi[kC3Chunk], zi[kC3Chunk], yi[kC3Chunk];
#pragma unroll
      for (int c = 0; c < kC3Chunk; ++c) {
        const int k = c0 + 32 * c + lane;
        s[c] = k < total ? list[k] : -1;
        w2[c] = xi[c] = zi[c] = yi[c] = 0.0f;
        if (s[c] < 0) continue;
        const size_t off = base + s[c];
        w2[c] = __ldg(rw2 + off);
        if (moves) {
          xi[c] = __ldg(x + off);
          zi[c] = __ldg(z + off);
          yi[c] = __ldg(y + off);
        }
      }
#pragma unroll
      for (int c = 0; c < kC3Chunk; ++c) {
        if (s[c] < 0) continue;
        const size_t off = base + s[c];
        const Drop3 d = droplet3d<VT>(geo, amb, w, moves, nr[s[c]], w2[c],
                                      xi[c], zi[c], yi[c]);
        vt_out[off] = d.vt;
        if (!moves) continue;
        n_out[off] = d.m;
        x_out[off] = d.x;
        z_out[off] = d.z;
        y_out[off] = d.y;
        tgt_out[off] = d.tgt;
        far |= d.far;
        fell |= d.fell;
      }
    }
    if (moves) {
      // the puddle partials in the old layout's order: lane j's slots
      // 4 j .. 4 j + 3 of each tile, then the fixed butterfly
      float liq_vol = 0.0f, dry_vol = 0.0f, liq_num = 0.0f, prt_num = 0.0f;
      if (__any_sync(kAll, fell)) {
        for (int l0 = 4 * lane; l0 < cap; l0 += kTile) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float m = nr[l0 + q];
            if (!(m > 0.0f)) continue;
            const size_t off = base + l0 + q;
            const float wq = __ldg(rw2 + off);
            const Drop3 d = droplet3d<VT>(geo, amb, w, true, m, wq,
                                          __ldg(x + off), __ldg(z + off),
                                          __ldg(y + off));
            if (!d.fell) continue;
            const float mf = d.m_fell;
            liq_vol += F((4.0 / 3) * pi) * mf * wq * sqrtf(fmaxf(wq, 0.0f));
            dry_vol += F((4.0 / 3) * pi) * mf * __ldg(rd3 + off);
            liq_num += wq > 0.0f ? mf : 0.0f;
            prt_num += mf;
          }
        }
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
    __syncwarp();  // the ring slot and the list are reused
  }
  cp_async_wait<0>();
}

// The launch both entries share: in the 16-byte layout the streaming
// kernel over bricks of ``brick`` rows (kC3Warps times a warp's rows) on
// ``blocks`` persistent blocks (ops/step.py transport3d_plan), its dynamic
// shared memory set at every launch (other capacities may run in
// between); in the scalar layout transport.cuh's row code, a warp a row
// (``brick`` and ``blocks`` unused).  With no transport only n, rw2, the
// cell fields and vt are passed (the other pointers may be null).
template <class G>
int transport3d_launch(const float* n, const float* rw2, const float* rd3,
                       const float* x, const float* z, const float* cells,
                       float* n_out, float* x_out, float* z_out,
                       float* vt_out, int* tgt_out, float* rowinfo,
                       int n_cell, int cap, const G& geo, int vt, int brick,
                       int blocks, cudaStream_t stream) {
  const bool vec = vector_ok(cap, {n, rw2, x, z, n_out, x_out, z_out, vt_out,
                                   tgt_out, geo.ya.y, geo.ya.y_out});
  if (!vec) {
    const dim3 grid(row_blocks(n_cell)), block(kWarpRows * 32);
    return with_vt(vt, [&](auto f) {
      transport_kernel<false, decltype(f)::value, G>
          <<<grid, block, 0, stream>>>(n, rw2, rd3, x, z, cells, n_out,
                                       x_out, z_out, vt_out, tgt_out,
                                       rowinfo, n_cell, cap, geo);
      return static_cast<int>(cudaGetLastError());
    });
  }
  if (brick < kC3Warps || brick % kC3Warps || blocks < 1 || cap > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = c3_smem(cap);
  return with_vt(vt, [&](auto f) {
    auto kernel = transport3d_kernel<decltype(f)::value, G>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return static_cast<int>(err);
    }
    kernel<<<blocks, kC3Warps * 32, smem, stream>>>(
        n, rw2, rd3, x, z, geo.ya.y, cells, n_out, x_out, z_out,
        geo.ya.y_out, vt_out, tgt_out, rowinfo, n_cell, cap,
        brick / kC3Warps, geo);
    return static_cast<int>(cudaGetLastError());
  });
}

// What the card makes of the streaming kernel of formula ``vt`` (the
// implicit / euler form's, or the pred_corr form's with ``G``
// With3D<PredCorrGeometry>) at capacity ``cap``: out = registers a thread,
// static shared memory, the dynamic shared memory the launch asks for,
// local memory a thread (bytes), blocks an SM, threads a block, 0, 0.
// Returns the CUDA error of setting the dynamic shared memory or of a
// query (0 if none).
template <class G>
int transport3d_attrs(int vt, int cap, int* out) {
  if (cap < kTile || cap % kTile || cap > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = c3_smem(cap);
  return with_vt(vt, [&](auto f) {
    auto kernel = transport3d_kernel<decltype(f)::value, G>;
    cudaFuncAttributes a;
    int blocks = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kC3Warps * 32, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.sharedSizeBytes);
    out[2] = static_cast<int>(smem);
    out[3] = static_cast<int>(a.localSizeBytes);
    out[4] = blocks;
    out[5] = kC3Warps * 32;
    out[6] = out[7] = 0;
    return 0;
  });
}

}  // namespace lcp
