// Kernel E: the coalescence substep loop (the kernels; coal.cu holds the
// entry points).
//
// Replaces the coalescence phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 233-336) and the
// standalone TPU kernel libcloudphxx_tpu/ops/pallas_coal.py:_kernel (line 99):
// per cell row, sstp_coal substeps of the super-droplet method (Shima et
// al. 2009) with a random in-row pairing.  One kernel, three modes:
//   stride      one shuffle every n_strides substeps, partner slot ^ stride
//   sort        a shuffle every substep, adjacent pairs, one final unsort
//   standalone  vt of every SD before every shuffle and after the last
//               substep, x/z/vt following the SDs, no unsort
// Plain versions: ops/coal.py coal_resident_plain, coal_standalone_plain.
//
// What bounds it on the card: the instructions it runs.  A row reads and
// writes ~30 bytes a droplet once; the work is the Philox draws (10 rounds of
// integer multiplies a word), the collision kernel of each pair and the
// shuffle's compare-exchanges, and only a small part of it on the data's
// own terms: a GMD row holds 48-80 live droplets in 128 slots, and few
// pairs collide in a substep.
// What the design does about it:
//   - one warp a row for the whole substep loop, several rows a block (8,
//     4 at cap 512 in the standalone form: what keeps the warps' tiles in
//     48 KB), no block barrier: slot j of the row lives in lane j % 32, register slot
//     j / 32 (S = max(1, cap / 32) register slots a lane, a template
//     parameter, so every slot index is known at compile time);
//   - the shuffle is a bitonic network over the row's tie-free keys
//     (bits << 16 | slot, dead slots above every live one): partners 32 or
//     more slots apart are a compare-exchange of a lane's own registers,
//     nearer ones a __shfl_xor_sync.  The SDs follow through the warp's
//     own shared-memory tile (write every plane, __syncwarp, read the
//     source slot the sorted key names).  The slot of origin rides along,
//     in place of x and z: the sort mode unsorts by it, the other modes
//     read x and z from where the SD started when they write the row out;
//   - stride partners below 32 are a __shfl_xor_sync of the registers, the
//     partner at 32 register slot c ^ 1 of the same lane; counts are
//     __reduce_add_sync of per-lane integer sums, exact in any order;
//   - only what the outcome needs is computed: a register slot none of
//     whose lanes is in a pair is skipped by ballot, a dead slot (n == 0)
//     draws nothing and computes no collision, one Philox word a lane
//     serves the pairs of two register slots (an a-lane draws for its own
//     pair, a b-lane for the next slot's), the collision's outcome only
//     where a pair collides, and vt is computed once a live SD at load and
//     again only for the small droplet of a collision (every formula
//     depends only on rw2 and the row's T, p, rhod and eta, so these are
//     the bits the plain version's recomputation at every substep gives).
// The vt formula is a template parameter beside the mode, the register
// slots and the rows' type (GridRows, or ShardRows for the resident forms
// on a mesh shard): 17 instantiations a formula (the resident forms at 1,
// 2 and 4 register slots a lane, up to cap 128: their rows above it run on
// coal_y.cuh's warp rows; the standalone form at 1-16).  coal.cu instantiates
// beard77's, and each other formula's come from a source of their own
// (coal_beard76.cu, coal_khvorostyanov_spherical.cu,
// coal_khvorostyanov_nonspherical.cu, coal_undefined.cu), so that nvcc
// compiles them in parallel.
// The hall-family efficiencies are read from the 128x128 table in global
// memory through the read-only cache.  The wide-table form (the rows' type
// WideTable<GridRows> or WideTable<ShardRows>; the resident forms only, 12
// instantiations a formula up to cap 128, each formula's in a source
// coal_vohl*.cu of its own) reads a table wider than 128 at row stride clamp + 2:
// vohl_davis_no_waals's, whose saturation index is 150.  Nothing in the
// TPU kernel does this (the JAX package reads vohl's efficiencies in XLA,
// lgrngn/coalescence.py:374-376); its plain version is the same
// coal_resident_plain.
// The y and onishi forms (coal_y.cuh: the same substep loop with a row
// over one warp or several, 10 instantiations a formula, each formula's in
// a source coal_y*.cu of its own; the y forms on the grid's own rows, the
// onishi form also on a shard's of the x-slab mesh, its rows keyed by row0
// as ShardRows' are) carry the 3-D grid's y plane: it is written out by
// the slot of origin, as x and z are (the JAX package's sort pairing
// carries y, libcloudphxx_tpu/lgrngn/dense.py:801-804), where the rows' y
// pointer is set.  Their collision kernel is picked at run time
// (physics.cuh kTableAny): the formula kernels, the hall family's narrow
// table, vohl's wide one, and the turbulent (onishi) kernels at
// dissipation rate 0 (onishi.cuh: the hall table's efficiency times Wang's
// enhancement times the geometric kernel), which the JAX package computes
// in XLA and its TPU kernel refuses (lgrngn/dense.py:1221-1225).  Their
// plain version is coal_resident_plain with ``y``.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "physics.cuh"

namespace lcp {

enum CoalMode { kStride = 0, kSort = 1, kStandalone = 2 };
constexpr int kMaxCap = 512;   // ops/coal.py MAX_CAP
constexpr int kTilePlanes = 6;  // n rw2 rd3 kpa vt origin
constexpr unsigned kFull = 0xffffffffu;

// Rows (warps) a block: as many as keep the block's tiles within the 48 KB
// of static shared memory, at most 8.
template <int S>
__host__ __device__ constexpr int rows_per_block() {
  return S >= 16 ? 4 : 8;
}

// Blocks an SM holds at least: up to cap 128 three (24 warps at ~80
// registers a thread, without spilling), which hide more of the shuffles'
// and the Philox chains' latency than the two that an unbounded register
// count leaves room for; wider rows keep their registers.  Under
// Khvorostyanov the float64 pows spill at cap 128 (up to 112 bytes), and
// three blocks still ran faster than two unspilled on the H100.
template <int S>
__host__ __device__ constexpr int min_blocks() {
  return S <= 4 ? 3 : 1;
}

// One row's SDs in a warp: slot j = 32 * c + lane in register slot c.
template <int S>
struct Row {
  float n[S], rw2[S], rd3[S], kpa[S], vt[S];
  int org[S];  // the slot the SD started the call in
};

// Whose rows a launch holds: the grid's own (row r draws as row r), or a
// shard's of the x-slab mesh, whose row r draws as the global row row0 + r
// (parallel/dense_mesh.py); and how the efficiency table's rows lie
// (kTable, physics.cuh).  The type is a template parameter of the kernel,
// so that the grid's instantiations, GridRows an empty type, keep the code
// (and the names) they had before the mesh and the wide table.
struct GridRows {
  static constexpr int kTable = kTableNarrow;
  __host__ static GridRows of(uint32_t) { return {}; }
  __device__ __forceinline__ uint32_t global(int r) const {
    return static_cast<uint32_t>(r);
  }
};
struct ShardRows {
  static constexpr int kTable = kTableNarrow;
  uint32_t row0;
  __host__ static ShardRows of(uint32_t row0) { return {row0}; }
  __device__ __forceinline__ uint32_t global(int r) const {
    return row0 + static_cast<uint32_t>(r);
  }
};
// R's rows with the wide table (vohl's)
template <class R>
struct WideTable : R {
  static constexpr int kTable = kTableWide;
  __host__ static WideTable of(uint32_t row0) {
    return WideTable{R::of(row0)};
  }
};
// Where a row's random draws come from: key (seed, row), counter (step,
// substep, kind, slot).
struct Draws {
  uint32_t seed, row, step;
  __device__ __forceinline__ uint32_t word(int s, uint32_t kind,
                                           int slot) const {
    return philox_word(seed, row, step, s, kind, slot);
  }
};

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int mask) {
  const uint32_t lo = __shfl_xor_sync(kFull, static_cast<uint32_t>(v), mask);
  const uint32_t hi =
      __shfl_xor_sync(kFull, static_cast<uint32_t>(v >> 32), mask);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Sort the warp's 32 * S keys ascending (slot j = 32 * c + lane).
template <int S>
__device__ __forceinline__ void bitonic(uint64_t (&key)[S], int lane) {
  constexpr int kLog = S == 1 ? 5 : S == 2 ? 6 : S == 4 ? 7 : S == 8 ? 8 : 9;
#pragma unroll
  for (int lk = 1; lk <= kLog; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int d = 1 << lj;
      if (d >= 32) {  // partner slot c ^ (d / 32), the same lane
#pragma unroll
        for (int c = 0; c < S; ++c) {
          const int h = c ^ (d >> 5);
          if (h > c) {
            const bool up = ((c << 5) & k) == 0;
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
          const int j = (c << 5) | lane;
          const bool keep_min = ((j & d) == 0) == ((j & k) == 0);
          key[c] = (keep_min == (key[c] < other)) ? key[c] : other;
        }
      }
    }
  }
}

// The random in-row shuffle of substep s: every slot j of the row takes
// the SD of the slot its sorted key names.  ``tile`` is the warp's own.
template <int S>
__device__ __forceinline__ void shuffle(Row<S>& v, float (*tile)[32 * S],
                                        int lane, const Draws& dr, int s) {
  uint64_t key[S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const int j = (c << 5) | lane;
    // the key cannot tie: 32 random bits above the slot, dead slots (and
    // the lanes past cap < 32, which hold no SD) above every live one
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
  __syncwarp();
  bitonic<S>(key, lane);
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
  __syncwarp();
}

// The Bernoulli draws of the pairs of partners ``dist`` < 32 lanes apart:
// the a-lane (lane & dist clear) carries each pair's draw, keyed by its
// slot.  One Philox word a lane serves two register slots: the a-lane of
// slot c draws its own pair's word, the b-lane the word of slot c + 1's
// a-lane (lane ^ dist), and one shuffle hands each the other.  ``pair``
// marks the lanes whose pair needs a draw (both lanes of a pair agree);
// ``u`` gets the pair's draw on both of its lanes.
template <int S>
__device__ __forceinline__ void pair_draws(const bool (&pair)[S], int lane,
                                           int dist, const Draws& dr, int s,
                                           float (&u)[S]) {
  const bool is_a = (lane & dist) == 0;
#pragma unroll
  for (int c = 0; c < S; c += 2) {
    constexpr int kNext = S > 1 ? 1 : 0;
    const bool next = S > 1 && pair[c + kNext];
    const bool draw = is_a ? pair[c] : next;
    float ud = 0.0f;
    if (draw)
      ud = u01(dr.word(s, kBernoulli,
                       is_a ? (c << 5) | lane
                            : ((c + kNext) << 5) | (lane ^ dist)));
    const float other = __shfl_xor_sync(kFull, ud, dist);
    u[c] = is_a ? ud : other;
    if (S > 1) u[c + kNext] = is_a ? other : ud;
  }
}

// Apply a collision's outcome to this SD: the big one loses multiplicity,
// the small one grows (and its vt follows its new rw2).
template <int VT, int S>
__device__ __forceinline__ void apply(Row<S>& v, int c, const Collision& o,
                                      bool own_big, const Ambient& amb) {
  if (own_big) {
    v.n[c] = o.n_big_new;
  } else {
    v.rw2[c] = o.rw2_small_new;
    v.rd3[c] = o.rd3_small_new;
    v.kpa[c] = o.kpa_small_new;
    v.vt[c] = vt_formula<VT>(o.rw2_small_new, amb);
  }
}

// dense.py pair_and_collide_partners: slot j pairs with j ^ stride; each
// lane computes its own SD's outcome from both SDs, the pair's draw is the
// a-slot's (stride bit clear).
template <int VT, int S, int TW>
__device__ __forceinline__ void stride_substep(
    Row<S>& v, int lane, int stride, const Draws& dr, int s,
    const CollisionKernel& kern, float dt_dv, const Ambient& amb,
    bool& ovf) {
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
    const bool is_a = (((c << 5) | lane) & stride) == 0;
    sums += (alive ? 1 : 0) + (ok[c] && is_a ? 1 << 16 : 0);
  }
  sums = __reduce_add_sync(kFull, sums);
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
      if (ok[c]) ud = u01(dr.word(s, kBernoulli, (c << 5) | lane));
      u[c] = ud;
      u[c + kNext] = ud;
    }
  } else {
    pair_draws<S>(ok, lane, stride, dr, s, u);
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
        const bool is_a = (((c << 5) | lane) & stride) == 0;
        bool over;
        const float col =
            collision_count<TW>(kern, me, pa, u[c], dt_dv, scale, over);
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

// dense.py pair_and_collide: after a shuffle the live SDs come first;
// slots 2i and 2i+1 pair while both are live, both lanes compute the
// pair's outcome from the same inputs and the even slot's draw, and each
// keeps its own part.
template <int VT, int S, int TW>
__device__ __forceinline__ void adjacent_substep(
    Row<S>& v, int lane, const Draws& dr, int s, const CollisionKernel& kern,
    float dt_dv, const Ambient& amb, bool& ovf) {
  int mine = 0;
#pragma unroll
  for (int c = 0; c < S; ++c) mine += v.n[c] > 0.0f ? 1 : 0;
  const int count = __reduce_add_sync(kFull, mine);
  const float cf = static_cast<float>(count);
  const float half = floorf(div_s(cf, 2.0));
  const float scale = count > 1 ? div_s(cf * (cf - 1.0f), 2.0) / half : 0.0f;
  const bool odd = lane & 1;
  bool pair[S];
#pragma unroll
  for (int c = 0; c < S; ++c) pair[c] = (((c << 5) | lane) | 1) < count;
  float u[S];
  pair_draws<S>(pair, lane, 1, dr, s, u);
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
          collision_count<TW>(kern, a, b, u[c], dt_dv, scale, over);
      ovf |= over && !odd;
      if (col > 0.0f) {
        const bool a_big = a.n >= b.n;
        const Collision o = collide(a, b, a_big, col);
        if (o.happened) apply<VT>(v, c, o, odd ? !a_big : a_big, amb);
      }
    }
  }
}

// planes: n rw2 rd3 kpa x z; cells: 5 rows of n_cell: T p rhod eta dv
template <int MODE, int S, int VT, class R>
__global__ void __launch_bounds__(32 * rows_per_block<S>(), min_blocks<S>())
coal_kernel(const float* __restrict__ n_in, const float* __restrict__ rw2_in,
            const float* __restrict__ rd3_in, const float* __restrict__ kpa_in,
            const float* __restrict__ x_in, const float* __restrict__ z_in,
            const float* __restrict__ cells, float* __restrict__ n_out,
            float* __restrict__ rw2_out, float* __restrict__ rd3_out,
            float* __restrict__ kpa_out, float* __restrict__ x_out,
            float* __restrict__ z_out, float* __restrict__ vt_out,
            unsigned char* __restrict__ ovf_out, int n_cell, int cap,
            int sstp, double dt_sub, CollisionKernel kern, uint32_t seed,
            uint32_t step, R rows) {
  constexpr int kRows = rows_per_block<S>();
  __shared__ float tiles[kRows][kTilePlanes][32 * S];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kRows + w;
  if (r >= n_cell) return;  // a whole warp: no barrier waits for it
  float(*tile)[32 * S] = tiles[w];

  // the row's fields, T only for a formula that reads it
  const Ambient amb{vt_reads_T<VT>() ? cells[r] : 0.0f, cells[n_cell + r],
                    cells[2 * n_cell + r], cells[3 * n_cell + r]};
  const float dt_dv = rdiv_s(dt_sub, cells[4 * n_cell + r]);
  const Draws dr{seed, rows.global(r), step};
  const size_t row = static_cast<size_t>(r) * cap;

  Row<S> v;
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const int j = (c << 5) | lane;
    const bool in = j < cap;
    v.n[c] = in ? n_in[row + j] : 0.0f;
    v.rw2[c] = in ? rw2_in[row + j] : 0.0f;
    v.rd3[c] = in ? rd3_in[row + j] : 0.0f;
    v.kpa[c] = in ? kpa_in[row + j] : 0.0f;
    v.org[c] = j;
    v.vt[c] = 0.0f;
    if (v.n[c] > 0.0f) v.vt[c] = vt_formula<VT>(v.rw2[c], amb);
  }
  int n_strides = 1;
  while ((1 << n_strides) <= cap / 4 && n_strides < 6) ++n_strides;

  bool ovf = false;
  for (int s = 0; s < sstp; ++s) {
    const int sidx = s % n_strides;
    if (MODE != kStride || sidx == 0) shuffle<S>(v, tile, lane, dr, s);
    if (MODE == kStride)
      stride_substep<VT, S, R::kTable>(v, lane, 1 << sidx, dr, s, kern,
                                       dt_dv, amb, ovf);
    else
      adjacent_substep<VT, S, R::kTable>(v, lane, dr, s, kern, dt_dv, amb,
                                         ovf);
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
    __syncwarp();
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int j = (c << 5) | lane;
      v.n[c] = tile[0][j];
      v.rw2[c] = tile[1][j];
      v.rd3[c] = tile[2][j];
      v.kpa[c] = tile[3][j];
      v.org[c] = j;
    }
  }
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const int j = (c << 5) | lane;
    if (j >= cap) continue;
    n_out[row + j] = v.n[c];
    rw2_out[row + j] = v.rw2[c];
    rd3_out[row + j] = v.rd3[c];
    kpa_out[row + j] = v.kpa[c];
    x_out[row + j] = x_in[row + v.org[c]];
    z_out[row + j] = z_in[row + v.org[c]];
    if (MODE == kStandalone) {  // a live SD's cached vt is vt_of(rw2)
      float vt = v.vt[c];
      if (v.n[c] <= 0.0f) vt = vt_formula<VT>(v.rw2[c], amb);
      vt_out[row + j] = vt;
    }
  }
  const bool any = __any_sync(kFull, ovf);
  if (lane == 0) ovf_out[r] = any ? 1 : 0;
}

// What an entry point hands kernel E: the planes in (n rw2 rd3 kpa x z),
// the five cell rows and the efficiency table; the planes out (vt_out
// only in the standalone form) and the row flags; the sizes, the substeps
// and the collision kernel; the draws' seed and step, and the global index
// of the first row (a shard's of the x-slab mesh, the resident forms
// only; 0 otherwise); whether the table is the wide one (resident forms
// only); the y plane in and out (the y and onishi forms, coal_y.cuh; null
// otherwise).
struct CoalArgs {
  const float *n, *rw2, *rd3, *kpa, *x, *z, *cells;
  float *n_out, *rw2_out, *rd3_out, *kpa_out, *x_out, *z_out, *vt_out;
  unsigned char* ovf;
  int n_cell, cap, sstp;
  double dt_sub;
  CollisionKernel kern;
  unsigned seed, step, row0;
  bool wide;
  const float* y;
  float* y_out;
};

template <int MODE, int S, int VT, class R>
cudaError_t launch_rows(const CoalArgs& a, cudaStream_t stream) {
  constexpr int kRows = rows_per_block<S>();
  coal_kernel<MODE, S, VT, R><<<(a.n_cell + kRows - 1) / kRows, 32 * kRows,
                                0, stream>>>(
      a.n, a.rw2, a.rd3, a.kpa, a.x, a.z, a.cells, a.n_out, a.rw2_out,
      a.rd3_out, a.kpa_out, a.x_out, a.z_out, a.vt_out, a.ovf, a.n_cell,
      a.cap, a.sstp, a.dt_sub, a.kern, a.seed, a.step, R::of(a.row0));
  return cudaGetLastError();
}

template <int MODE, int VT, class R>
int launch_mode(const CoalArgs& a, cudaStream_t stream) {
  // register slots a lane: what cap forces.  The resident forms' rows
  // above 128 slots run on coal_y.cuh's warp rows (ops/coal.py routes them
  // to lcp_coal_warp_rows / lcp_coal_vohl_warp_rows), so only the
  // standalone form instantiates 8 and 16 slots a lane.
  if constexpr (MODE != kStandalone) {
    if (a.cap > 128) return static_cast<int>(cudaErrorInvalidValue);
    auto go = a.cap <= 32   ? &launch_rows<MODE, 1, VT, R>
              : a.cap == 64 ? &launch_rows<MODE, 2, VT, R>
                            : &launch_rows<MODE, 4, VT, R>;
    return static_cast<int>(go(a, stream));
  } else {
    auto go = a.cap <= 32    ? &launch_rows<MODE, 1, VT, R>
              : a.cap == 64  ? &launch_rows<MODE, 2, VT, R>
              : a.cap == 128 ? &launch_rows<MODE, 4, VT, R>
              : a.cap == 256 ? &launch_rows<MODE, 8, VT, R>
                             : &launch_rows<MODE, 16, VT, R>;
    return static_cast<int>(go(a, stream));
  }
}

// The wide-table form in a resident ``mode`` (stride or sort) for formula
// VT; instantiated in the sources coal_vohl*.cu
template <int VT>
int coal_launch_wide(int mode, const CoalArgs& a, cudaStream_t stream) {
  if (mode != kStride && mode != kSort)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shard = a.row0 != 0;
  auto go = mode == kSort
                ? (shard ? &launch_mode<kSort, VT, WideTable<ShardRows>>
                         : &launch_mode<kSort, VT, WideTable<GridRows>>)
                : (shard ? &launch_mode<kStride, VT, WideTable<ShardRows>>
                         : &launch_mode<kStride, VT, WideTable<GridRows>>);
  return go(a, stream);
}

extern template int coal_launch_wide<kVtUndefined>(int, const CoalArgs&,
                                                   cudaStream_t);
extern template int coal_launch_wide<kVtBeard76>(int, const CoalArgs&,
                                                 cudaStream_t);
extern template int coal_launch_wide<kVtBeard77>(int, const CoalArgs&,
                                                 cudaStream_t);
extern template int coal_launch_wide<kVtKhvorostyanovSpherical>(
    int, const CoalArgs&, cudaStream_t);
extern template int coal_launch_wide<kVtKhvorostyanovNonspherical>(
    int, const CoalArgs&, cudaStream_t);

// The y and onishi forms in a resident ``mode`` (stride or sort) for
// formula VT (``queue``: n_cell + 1 ints of scratch above cap 128), and
// their kernels' attributes on the card at a capacity; defined in
// coal_y.cuh, instantiated in the sources coal_y*.cu
template <int VT>
int coal_launch_y(int mode, const CoalArgs& a, int* queue,
                  cudaStream_t stream);
template <int VT>
int coal_y_attrs(int mode, int cap, int narrow, int* out);

extern template int coal_launch_y<kVtUndefined>(int, const CoalArgs&, int*,
                                                cudaStream_t);
extern template int coal_launch_y<kVtBeard76>(int, const CoalArgs&, int*,
                                              cudaStream_t);
extern template int coal_launch_y<kVtBeard77>(int, const CoalArgs&, int*,
                                              cudaStream_t);
extern template int coal_launch_y<kVtKhvorostyanovSpherical>(
    int, const CoalArgs&, int*, cudaStream_t);
extern template int coal_launch_y<kVtKhvorostyanovNonspherical>(
    int, const CoalArgs&, int*, cudaStream_t);
extern template int coal_y_attrs<kVtUndefined>(int, int, int, int*);
extern template int coal_y_attrs<kVtBeard76>(int, int, int, int*);
extern template int coal_y_attrs<kVtBeard77>(int, int, int, int*);
extern template int coal_y_attrs<kVtKhvorostyanovSpherical>(
    int, int, int, int*);
extern template int coal_y_attrs<kVtKhvorostyanovNonspherical>(
    int, int, int, int*);

// Kernel E in ``mode`` for formula VT, after the checks every form shares
template <int VT>
int coal_launch(int mode, const CoalArgs& a, cudaStream_t stream) {
  if (a.cap < 1 || a.cap > kMaxCap || (a.cap & (a.cap - 1)) || a.n_cell < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_cell == 0) return 0;
  if (a.wide) return coal_launch_wide<VT>(mode, a, stream);
  // a shard's rows past the first take ShardRows (shard 0's draw as the
  // grid's)
  const bool shard = a.row0 != 0;
  auto go = mode == kSort
                ? (shard ? &launch_mode<kSort, VT, ShardRows>
                         : &launch_mode<kSort, VT, GridRows>)
            : mode == kStride ? (shard ? &launch_mode<kStride, VT, ShardRows>
                                       : &launch_mode<kStride, VT, GridRows>)
                              : &launch_mode<kStandalone, VT, GridRows>;
  return go(a, stream);
}

// One source instantiates each formula's kernels; the others see these
// declarations and link to them
extern template int coal_launch<kVtUndefined>(int, const CoalArgs&,
                                              cudaStream_t);
extern template int coal_launch<kVtBeard76>(int, const CoalArgs&,
                                            cudaStream_t);
extern template int coal_launch<kVtBeard77>(int, const CoalArgs&,
                                            cudaStream_t);
extern template int coal_launch<kVtKhvorostyanovSpherical>(
    int, const CoalArgs&, cudaStream_t);
extern template int coal_launch<kVtKhvorostyanovNonspherical>(
    int, const CoalArgs&, cudaStream_t);

}  // namespace lcp
