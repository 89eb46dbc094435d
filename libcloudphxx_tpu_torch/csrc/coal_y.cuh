// Kernel E's y and onishi forms (coal.cu lcp_coal_3d, lcp_coal_vohl_3d,
// lcp_coal_onishi): the resident coalescence substep loop of coal.cuh with
// the 3-D grid's y plane riding and the collision kernel's table picked at
// run time, a row over one warp or several.
//
// Replaces the coal phase of the TPU kernel libcloudphxx_tpu/ops/
// pallas_step.py:_kernel (lines 233-336) at its 3-D and onishi callers,
// which the JAX package runs in XLA (libcloudphxx_tpu/lgrngn/dense.py:
// 799-805, the sort pairing carrying y; the onishi kernels at dissipation
// rate 0, dense.py:606, :738, which its TPU kernel refuses, :1221-1225).
// Plain version: ops/coal.py coal_resident_plain with ``y`` (and row0 on a
// shard of the x-slab mesh).
//
// The algorithm, the draws and the order of every operation are coal.cuh's
// (its header says what bounds kernel E: the instructions it runs, the
// Philox chains and the shuffle's compare-exchanges).  What bounded the
// old shape (PR 18: coal.cuh's coal_kernel with the rows' type YRows, a
// warp a row, S = cap / 32 register slots a lane): at cap 256 a lane held
// 8 slots (Row<8> alone 48 registers), so min_blocks allowed one block of
// 8 warps an SM, and a row cost 4.5x the cap-128 row for twice the slots
// (vohl's large tail at 76^3: 24.84 ms a call, 13x its bound).
// What this design does about it: a row over W = max(1, cap / 128) warps
// of at most 4 register slots a lane (ops/coal.py coal_y_plan):
//   - row slot j lies in warp j / 128 of the row, lane j % 32, register
//     slot (j % 128) / 32.  Stride pairing's strides are at most 32 and
//     sort pairing's pairs are (2i, 2i + 1), so no pair crosses a warp:
//     a substep's collisions are each warp's own;
//   - the warps of a row share two integers a substep, the live count and
//     the pair count (exact in any order): each warp's __reduce_add_sync
//     sum goes to shared memory, one named barrier over the row's 32 W
//     threads (bar.sync id, 32 W; W = 1 a __syncwarp), and every warp adds
//     the W sums.  The overflow flag is the same sum at the end;
//   - the shuffle is the bitonic network over the row's cap keys: partners
//     128 or more slots apart exchange keys through the row's shared
//     tile between two barriers, nearer ones as coal.cuh's do.  The SDs
//     follow through the row's tile (6 planes x cap, 6 KB at cap 256);
//   - the Philox words stay keyed by the row's slot index, so the draws
//     are coal.cuh's;
//   - 8 warps a block, (256, 3) launch bounds: at cap 256 two warps a row
//     at 4 slots a lane, 24 warps an SM instead of 8.  Up to cap 128 W is
//     1 and the kernel is coal.cuh's row with the slot index spelled out.
// That alone measured 22.09 ms (H100, phase 22 (b)): the large tail's
// rows hold at most 65 droplets in their 256 slots, and a shuffle packs
// the live SDs first, so every live SD sat in the row's first warp and
// the second idled.  Hence the one-warp pass:
//   - above cap 128 a first launch runs every row whose droplets all lie
//     in its first 128 slots as a one-warp row over those 128 (8 rows a
//     block, 24 warps an SM all busy).  Its other slots are dead, and dead
//     slots never move: the shuffle's dead keys sort after every live one
//     in slot order (slots past the live count keep theirs), no pair of
//     dead SDs draws or collides, and the counts are the same; so the row
//     ends in the bits of the full W-warp row, and its slots past 128 are
//     copied through;
//   - the other rows go to a queue (an atomic count; a row's bits do not
//     depend on when it runs), and a second launch, as many blocks as
//     the card holds at once, walks it with the W-warp rows.
// 10 instantiations a formula (stride and sort at (S, W) = (1, 1), (2, 1),
// (4, 1), (4, 2), (4, 4)), each formula's in a source coal_y*.cu of its
// own; (4, 1) is also the one-warp pass above cap 128.  What it measured:
// PERF.md section 6 (chip_smoke.py phase 22).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "onishi.cuh"

namespace lcp {

constexpr int kYWarps = 8;  // warps a block

// A thread's place in its row of S * 32 * W slots: warp ``w`` of the row,
// its lane, and the row's named barrier ``id``
template <int S, int W>
struct RowWarps {
  int lane, w, id;
  // the row slot of register slot c
  __device__ __forceinline__ int slot(int c) const {
    return (w << 7) | (c << 5) | lane;
  }
  // the row's warps meet (their shared-memory writes visible to each other)
  __device__ __forceinline__ void sync() const {
    if constexpr (W == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(32 * W) : "memory");
  }
  // the row's sum of the lanes' ``v``: each warp's sum, then the W warps'
  // in warp order through ``buf`` (2 W ints, alternating halves by
  // ``phase``: a half is written again only after a later barrier)
  __device__ __forceinline__ int sum(int v, int* buf, int& phase) const {
    v = __reduce_add_sync(kFull, v);
    if constexpr (W == 1) {
      return v;
    } else {
      int* const half = buf + (phase & 1) * W;
      ++phase;
      if (lane == 0) half[w] = v;
      sync();
      int t = 0;
#pragma unroll
      for (int q = 0; q < W; ++q) t += half[q];
      return t;
    }
  }
};

// Sort the row's 32 * S * W keys ascending; ``xk`` the row's key tile
// (partners 128 or more slots apart, W > 1)
template <int S, int W>
__device__ __forceinline__ void bitonic_rows(uint64_t (&key)[S],
                                             const RowWarps<S, W>& rw,
                                             uint64_t* xk) {
  constexpr int kN = 32 * S * W;
  constexpr int kLog = kN == 32    ? 5
                       : kN == 64  ? 6
                       : kN == 128 ? 7
                       : kN == 256 ? 8
                                   : 9;
#pragma unroll
  for (int lk = 1; lk <= kLog; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int d = 1 << lj;
      if (d >= 128) {  // partner warp w ^ (d / 128), the same lane and slot
#pragma unroll
        for (int c = 0; c < S; ++c) xk[rw.slot(c)] = key[c];
        rw.sync();
#pragma unroll
        for (int c = 0; c < S; ++c) {
          const int j = rw.slot(c);
          const uint64_t other = xk[j ^ d];
          const bool keep_min = ((j & d) == 0) == ((j & k) == 0);
          key[c] = (keep_min == (key[c] < other)) ? key[c] : other;
        }
        rw.sync();
      } else if (d >= 32) {  // partner slot c ^ (d / 32), the same lane
#pragma unroll
        for (int c = 0; c < S; ++c) {
          const int h = c ^ (d >> 5);
          if (h > c) {
            const bool up = (rw.slot(c) & k) == 0;
            const uint64_t a = key[c], b = key[h];
            const bool swap = (a > b) == up;
            key[c] = swap ? b : a;
            key[h] = swap ? a : b;
          }
        }
      } else {  // partner lane ^ d, the same register slot
#pragma unroll
        for (int c = 0; c < S; ++c) {
          const uint64_t other = shfl_xor64(key[c], d);
          const int j = rw.slot(c);
          const bool keep_min = ((j & d) == 0) == ((j & k) == 0);
          key[c] = (keep_min == (key[c] < other)) ? key[c] : other;
        }
      }
    }
  }
}

// coal.cuh shuffle over the row's warps: every slot j of the row takes the
// SD of the slot its sorted key names, through the row's ``tile``
template <int S, int W>
__device__ __forceinline__ void shuffle_rows(Row<S>& v,
                                             float (*tile)[32 * S * W],
                                             uint64_t* xk,
                                             const RowWarps<S, W>& rw,
                                             const Draws& dr, int s) {
  uint64_t key[S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const int j = rw.slot(c);
    uint64_t hi = 1ull << 32;
    if (v.n[c] > 0.0f) hi = dr.word(s, kShuffle, j);
    key[c] = (hi << 16) | static_cast<uint64_t>(j);
    tile[0][j] = v.n[c];
    tile[1][j] = v.rw2[c];
    tile[2][j] = v.rd3[c];
    tile[3][j] = v.kpa[c];
    tile[4][j] = v.vt[c];
    tile[5][j] = __int_as_float(v.org[c]);
  }
  rw.sync();
  bitonic_rows<S, W>(key, rw, xk);
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const int src = static_cast<int>(key[c] & 0xFFFF);
    v.n[c] = tile[0][src];
    v.rw2[c] = tile[1][src];
    v.rd3[c] = tile[2][src];
    v.kpa[c] = tile[3][src];
    v.vt[c] = tile[4][src];
    v.org[c] = __float_as_int(tile[5][src]);
  }
  rw.sync();
}

// coal.cuh pair_draws keyed by the row's slot index
template <int S, int W>
__device__ __forceinline__ void pair_draws_rows(const bool (&pair)[S],
                                                const RowWarps<S, W>& rw,
                                                int dist, const Draws& dr,
                                                int s, float (&u)[S]) {
  const bool is_a = (rw.lane & dist) == 0;
#pragma unroll
  for (int c = 0; c < S; c += 2) {
    constexpr int kNext = S > 1 ? 1 : 0;
    const bool next = S > 1 && pair[c + kNext];
    const bool draw = is_a ? pair[c] : next;
    float ud = 0.0f;
    if (draw)
      ud = u01(dr.word(s, kBernoulli,
                       is_a ? rw.slot(c) : rw.slot(c + kNext) ^ dist));
    const float other = __shfl_xor_sync(kFull, ud, dist);
    u[c] = is_a ? ud : other;
    if (S > 1) u[c + kNext] = is_a ? other : ud;
  }
}

// coal.cuh stride_substep over the row's warps (the partner j ^ stride,
// stride <= 32, in the same warp; the counts the row's)
template <int VT, int S, int W>
__device__ __forceinline__ void stride_substep_rows(
    Row<S>& v, const RowWarps<S, W>& rw, int* sums_buf, int& phase,
    int stride, const Draws& dr, int s, const CollisionKernel& kern,
    float dt_dv, const Ambient& amb, bool& ovf) {
  const bool far = stride >= 32;  // partner in register slot c ^ 1
  auto partner = [&](const float (&a)[S], int c) {
    constexpr int kFlip = S > 1 ? 1 : 0;
    return far ? a[c ^ kFlip] : __shfl_xor_sync(kFull, a[c], stride);
  };
  float pn[S];
  bool ok[S];
  int sums = 0;
#pragma unroll
  for (int c = 0; c < S; ++c) {
    pn[c] = partner(v.n, c);
    const bool alive = v.n[c] > 0.0f;
    ok[c] = alive && pn[c] > 0.0f;
    const bool is_a = (rw.slot(c) & stride) == 0;
    sums += (alive ? 1 : 0) + (ok[c] && is_a ? 1 << 16 : 0);
  }
  sums = rw.sum(sums, sums_buf, phase);
  const float count = static_cast<float>(sums & 0xFFFF);
  const float npairs = static_cast<float>(sums >> 16);
  const float scale =
      (count > 1.0f && npairs > 0.0f)
          ? div_s(count * (count - 1.0f), 2.0) / fmaxf(npairs, 1.0f)
          : 0.0f;
  constexpr int kNext = S > 1 ? 1 : 0;
  float u[S];
  if (far) {  // the even register slot carries the draw of both
#pragma unroll
    for (int c = 0; c < S; c += 2) {
      float ud = 0.0f;
      if (ok[c]) ud = u01(dr.word(s, kBernoulli, rw.slot(c)));
      u[c] = ud;
      u[c + kNext] = ud;
    }
  } else {
    pair_draws_rows<S, W>(ok, rw, stride, dr, s, u);
  }
  // A partner's values are read before either SD of the pair changes: a
  // near pair lies in one register slot; a far pair's (c, c + 1) outcome
  // of slot c waits until slot c + 1 has read it.
  Collision held{};
  bool held_hit = false, held_big = false;
#pragma unroll
  for (int c = 0; c < S; ++c) {
    Collision o{};
    bool hit = false, big = false;
    if (__any_sync(kFull, ok[c])) {
      const Drop me{v.n[c], v.rw2[c], v.rd3[c], v.kpa[c], v.vt[c]};
      const Drop pa{pn[c], partner(v.rw2, c), partner(v.rd3, c),
                    partner(v.kpa, c), partner(v.vt, c)};
      if (ok[c]) {
        const bool is_a = (rw.slot(c) & stride) == 0;
        bool over;
        const float col =
            collision_count<kTableAny>(kern, me, pa, u[c], dt_dv, scale,
                                       over);
        ovf |= over;
        if (col > 0.0f) {
          big = me.n > pa.n || (me.n == pa.n && is_a);
          o = collide(me, pa, big, col);
          hit = o.happened;
        }
      }
    }
    if (far && (c & 1) == 0) {
      held = o;
      held_hit = hit;
      held_big = big;
    } else {
      if (hit) apply<VT>(v, c, o, big, amb);
      if ((c & 1) && far && held_hit)
        apply<VT>(v, c ^ 1, held, held_big, amb);
    }
  }
}

// coal.cuh adjacent_substep over the row's warps (the pairs (2i, 2i + 1)
// in one warp; the live count the row's)
template <int VT, int S, int W>
__device__ __forceinline__ void adjacent_substep_rows(
    Row<S>& v, const RowWarps<S, W>& rw, int* sums_buf, int& phase,
    const Draws& dr, int s, const CollisionKernel& kern, float dt_dv,
    const Ambient& amb, bool& ovf) {
  int mine = 0;
#pragma unroll
  for (int c = 0; c < S; ++c) mine += v.n[c] > 0.0f ? 1 : 0;
  const int count = rw.sum(mine, sums_buf, phase);
  const float cf = static_cast<float>(count);
  const float half = floorf(div_s(cf, 2.0));
  const float scale = count > 1 ? div_s(cf * (cf - 1.0f), 2.0) / half : 0.0f;
  const bool odd = rw.lane & 1;
  bool pair[S];
#pragma unroll
  for (int c = 0; c < S; ++c) pair[c] = (rw.slot(c) | 1) < count;
  float u[S];
  pair_draws_rows<S, W>(pair, rw, 1, dr, s, u);
#pragma unroll
  for (int c = 0; c < S; ++c) {
    if (!__any_sync(kFull, pair[c])) continue;
    const Drop me{v.n[c], v.rw2[c], v.rd3[c], v.kpa[c], v.vt[c]};
    const Drop nb{__shfl_xor_sync(kFull, v.n[c], 1),
                  __shfl_xor_sync(kFull, v.rw2[c], 1),
                  __shfl_xor_sync(kFull, v.rd3[c], 1),
                  __shfl_xor_sync(kFull, v.kpa[c], 1),
                  __shfl_xor_sync(kFull, v.vt[c], 1)};
    if (pair[c]) {
      const Drop a = odd ? nb : me;
      const Drop b = odd ? me : nb;
      bool over;
      const float col =
          collision_count<kTableAny>(kern, a, b, u[c], dt_dv, scale, over);
      ovf |= over && !odd;
      if (col > 0.0f) {
        const bool a_big = a.n >= b.n;
        const Collision o = collide(a, b, a_big, col);
        if (o.happened) apply<VT>(v, c, o, odd ? !a_big : a_big, amb);
      }
    }
  }
}

// Row r of the launch ``a`` (its y plane null off the 3-D grid; row r
// draws as the global row row0 + r: 0 on the grid, a shard's first row
// under the onishi kernels on the x-slab mesh) over the W warps of ``rw``
// (their tile, key tile and sums in the block's shared memory), the first
// 32 S W of its slots; the slots past them (the one-warp pass of a wider
// row: all dead) copied through
template <int MODE, int S, int W, int VT>
__device__ __forceinline__ void coal_y_row(const CoalArgs& a, int r,
                                           const RowWarps<S, W>& rw,
                                           float (*tile)[32 * S * W],
                                           uint64_t* xk, int* sums,
                                           int& phase) {
  const int n_cell = a.n_cell, cap = a.cap;
  // the row's fields, T only for a formula that reads it
  const Ambient amb{vt_reads_T<VT>() ? a.cells[r] : 0.0f,
                    a.cells[n_cell + r], a.cells[2 * n_cell + r],
                    a.cells[3 * n_cell + r]};
  const float dt_dv = rdiv_s(a.dt_sub, a.cells[4 * n_cell + r]);
  const Draws dr{a.seed, a.row0 + static_cast<uint32_t>(r), a.step};
  const size_t row = static_cast<size_t>(r) * cap;

  Row<S> v;
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const int j = rw.slot(c);
    const bool in = j < cap;
    v.n[c] = in ? a.n[row + j] : 0.0f;
    v.rw2[c] = in ? a.rw2[row + j] : 0.0f;
    v.rd3[c] = in ? a.rd3[row + j] : 0.0f;
    v.kpa[c] = in ? a.kpa[row + j] : 0.0f;
    v.org[c] = j;
    v.vt[c] = 0.0f;
    if (v.n[c] > 0.0f) v.vt[c] = vt_formula<VT>(v.rw2[c], amb);
  }
  int n_strides = 1;
  while ((1 << n_strides) <= cap / 4 && n_strides < 6) ++n_strides;

  bool ovf = false;
  for (int s = 0; s < a.sstp; ++s) {
    const int sidx = s % n_strides;
    if (MODE != kStride || sidx == 0)
      shuffle_rows<S, W>(v, tile, xk, rw, dr, s);
    if (MODE == kStride)
      stride_substep_rows<VT, S, W>(v, rw, sums, phase, 1 << sidx, dr, s,
                                    a.kern, dt_dv, amb, ovf);
    else
      adjacent_substep_rows<VT, S, W>(v, rw, sums, phase, dr, s, a.kern,
                                      dt_dv, amb, ovf);
  }

  if (MODE == kSort) {  // one unsort by the slot of origin
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int o = v.org[c];
      tile[0][o] = v.n[c];
      tile[1][o] = v.rw2[c];
      tile[2][o] = v.rd3[c];
      tile[3][o] = v.kpa[c];
    }
    rw.sync();
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int j = rw.slot(c);
      v.n[c] = tile[0][j];
      v.rw2[c] = tile[1][j];
      v.rd3[c] = tile[2][j];
      v.kpa[c] = tile[3][j];
      v.org[c] = j;
    }
  }
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const int j = rw.slot(c);
    if (j >= cap) continue;
    a.n_out[row + j] = v.n[c];
    a.rw2_out[row + j] = v.rw2[c];
    a.rd3_out[row + j] = v.rd3[c];
    a.kpa_out[row + j] = v.kpa[c];
    a.x_out[row + j] = a.x[row + v.org[c]];
    a.z_out[row + j] = a.z[row + v.org[c]];
    if (a.y_out) a.y_out[row + j] = a.y[row + v.org[c]];
  }
  // the dead slots past the row's warps never move
  for (int j = 32 * S * W + rw.lane; j < cap; j += 32) {
    a.n_out[row + j] = a.n[row + j];
    a.rw2_out[row + j] = a.rw2[row + j];
    a.rd3_out[row + j] = a.rd3[row + j];
    a.kpa_out[row + j] = a.kpa[row + j];
    a.x_out[row + j] = a.x[row + j];
    a.z_out[row + j] = a.z[row + j];
    if (a.y_out) a.y_out[row + j] = a.y[row + j];
  }
  const int any = rw.sum(ovf ? 1 : 0, sums, phase);
  if (rw.w == 0 && rw.lane == 0) a.ovf[r] = any > 0 ? 1 : 0;
}

// A row over W warps of S register slots a lane, 8 / W rows a block.
// W = 1: row r = 8 * block + warp; a row of more than 128 slots whose
// droplets do not all lie in its first 128 goes to the queue instead (its
// index at an atomically counted place: the order does not change a
// row's bits) and the rest run on one warp.  W > 1: the block's rows walk
// the queue, a persistent grid.  The planes as kernel parameters marked
// __restrict__ (CoalArgs' fields), not a struct of pointers: the compiler
// may then move loads ahead of the stores of other planes.
template <int MODE, int S, int W, int VT>
__global__ void __launch_bounds__(32 * kYWarps, 3)
coal_y_kernel(const float* __restrict__ n_in,
              const float* __restrict__ rw2_in,
              const float* __restrict__ rd3_in,
              const float* __restrict__ kpa_in,
              const float* __restrict__ x_in, const float* __restrict__ z_in,
              const float* __restrict__ cells, float* __restrict__ n_out,
              float* __restrict__ rw2_out, float* __restrict__ rd3_out,
              float* __restrict__ kpa_out, float* __restrict__ x_out,
              float* __restrict__ z_out, unsigned char* __restrict__ ovf_out,
              int n_cell, int cap, int sstp, double dt_sub,
              CollisionKernel kern, uint32_t seed, uint32_t step,
              uint32_t row0, const float* __restrict__ y,
              float* __restrict__ y_out, int* __restrict__ queue) {
  const CoalArgs a{n_in,    rw2_in,  rd3_in,  kpa_in, x_in,    z_in,
                   cells,   n_out,   rw2_out, rd3_out, kpa_out, x_out,
                   z_out,   nullptr, ovf_out, n_cell, cap,     sstp,
                   dt_sub,  kern,    seed,    step,   row0,    false,
                   y,       y_out};
  constexpr int kRows = kYWarps / W;  // rows a block
  constexpr int kCap = 32 * S * W;    // slots a row at most
  __shared__ float tiles[kRows][kTilePlanes][kCap];
  __shared__ uint64_t keys[kRows][W > 1 ? kCap : 1];
  __shared__ int sums[kRows][2 * W];
  const int warp = threadIdx.x >> 5, q = warp / W;
  const RowWarps<S, W> rw{static_cast<int>(threadIdx.x & 31), warp % W,
                          q + 1};
  int phase = 0;
  if constexpr (W == 1) {
    const int r = blockIdx.x * kRows + q;
    if (r >= a.n_cell) return;
    if (a.cap > kCap) {  // one warp for the first 128 slots, if they hold all
      const size_t row = static_cast<size_t>(r) * a.cap;
      bool live = false;
      for (int j = kCap + rw.lane; j < a.cap; j += 32)
        live |= a.n[row + j] > 0.0f;
      if (__any_sync(kFull, live)) {
        if (rw.lane == 0) queue[atomicAdd(queue + a.n_cell, 1)] = r;
        return;
      }
    }
    coal_y_row<MODE, S, W, VT>(a, r, rw, tiles[q], keys[q], sums[q], phase);
  } else {
    const int queued = queue[a.n_cell];
    for (int i = blockIdx.x * kRows + q; i < queued; i += gridDim.x * kRows)
      coal_y_row<MODE, S, W, VT>(a, queue[i], rw, tiles[q], keys[q],
                                 sums[q], phase);
  }
}

// The form for a row capacity: register slots S and warps a row W (ops/
// coal.py coal_y_plan)
template <int MODE, int VT, class Fn>
auto with_y_form(int cap, Fn fn) {
  return cap <= 32    ? fn(coal_y_kernel<MODE, 1, 1, VT>, 1, 1)
         : cap == 64  ? fn(coal_y_kernel<MODE, 2, 1, VT>, 2, 1)
         : cap == 128 ? fn(coal_y_kernel<MODE, 4, 1, VT>, 4, 1)
         : cap == 256 ? fn(coal_y_kernel<MODE, 4, 2, VT>, 4, 2)
                      : fn(coal_y_kernel<MODE, 4, 4, VT>, 4, 4);
}

// coal_y_kernel's launch on ``a`` and ``queue``
template <class K>
void launch_y_kernel(K kernel, int blocks, const CoalArgs& a, int* queue,
                     cudaStream_t stream) {
  kernel<<<blocks, 32 * kYWarps, 0, stream>>>(
      a.n, a.rw2, a.rd3, a.kpa, a.x, a.z, a.cells, a.n_out, a.rw2_out,
      a.rd3_out, a.kpa_out, a.x_out, a.z_out, a.ovf, a.n_cell, a.cap, a.sstp,
      a.dt_sub, a.kern, a.seed, a.step, a.row0, a.y, a.y_out, queue);
}

template <int MODE, int VT>
int launch_y(const CoalArgs& a, int* queue, cudaStream_t stream) {
  // the one-warp pass: every row up to cap 128; above it the rows whose
  // droplets lie in their first 128 slots
  const auto narrow = with_y_form<MODE, VT>(
      a.cap < 128 ? a.cap : 128, [](auto kernel, int, int) {
        return kernel;
      });
  if (a.cap > 128 &&
      cudaMemsetAsync(queue + a.n_cell, 0, sizeof(int), stream)
          != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  launch_y_kernel(narrow, (a.n_cell + kYWarps - 1) / kYWarps, a, queue,
                  stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.cap <= 128) return static_cast<int>(err);
  // the queued rows over cap / 128 warps each, as many blocks as the card
  // holds at once
  return with_y_form<MODE, VT>(a.cap, [&](auto kernel, int, int w) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, 32 * kYWarps, 0);
    if (e != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return static_cast<int>(e);
    }
    const int rows = kYWarps / w;
    const int need = (a.n_cell + rows - 1) / rows;
    const int blocks = need < sms * per_sm ? need : sms * per_sm;
    launch_y_kernel(kernel, blocks > 0 ? blocks : 1, a, queue, stream);
    return static_cast<int>(cudaGetLastError());
  });
}

// The y and onishi forms in a resident ``mode`` (stride or sort) for
// formula VT; ``queue`` n_cell + 1 ints of scratch (the rows above 128
// slots that the one-warp pass leaves to the wide form), null up to cap
// 128
template <int VT>
int coal_launch_y(int mode, const CoalArgs& a, int* queue,
                  cudaStream_t stream) {
  if (a.cap < 1 || a.cap > kMaxCap || (a.cap & (a.cap - 1)) || a.n_cell < 0
      || (mode != kStride && mode != kSort)
      || (a.cap > 128 && queue == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_cell == 0) return 0;
  return mode == kSort ? launch_y<kSort, VT>(a, queue, stream)
                       : launch_y<kStride, VT>(a, queue, stream);
}

// What the card makes of the form's kernels at capacity ``cap``: out =
// registers a thread, static shared memory, dynamic shared memory (0),
// local memory a thread (bytes), blocks an SM, threads a block, warps a
// row, register slots a lane; of the one-warp pass at ``cap`` <= 128, of
// the wide form above it (``narrow`` 0) or of its one-warp pass
// (``narrow`` 1).  Returns the CUDA error of a query (0 if none).
template <int VT>
int coal_y_attrs(int mode, int cap, int narrow, int* out) {
  if (cap < 1 || cap > kMaxCap || (cap & (cap - 1))
      || (mode != kStride && mode != kSort))
    return static_cast<int>(cudaErrorInvalidValue);
  if (narrow && cap > 128) cap = 128;
  auto query = [&](auto kernel, int s, int w) {
    cudaFuncAttributes at;
    int blocks = 0;
    cudaError_t err = cudaFuncGetAttributes(&at, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, 32 * kYWarps, 0);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    out[0] = at.numRegs;
    out[1] = static_cast<int>(at.sharedSizeBytes);
    out[2] = 0;
    out[3] = static_cast<int>(at.localSizeBytes);
    out[4] = blocks;
    out[5] = 32 * kYWarps;
    out[6] = w;
    out[7] = s;
    return 0;
  };
  return mode == kSort ? with_y_form<kSort, VT>(cap, query)
                       : with_y_form<kStride, VT>(cap, query);
}

}  // namespace lcp
