// Kernel E: the coalescence substep loop.
//
// Replaces the coalescence phase of the TPU kernel
// libcloudphxx_tpu/ops/pallas_step.py:_kernel (lines 233-336) and the
// standalone TPU kernel libcloudphxx_tpu/ops/pallas_coal.py:_kernel (line 99):
// per cell row, sstp_coal substeps of the super-droplet method (Shima et
// al. 2009) with a random in-row pairing.  One kernel, three modes:
//   stride      one shuffle every n_strides substeps, partner lane ^ stride
//   sort        a shuffle every substep, adjacent pairs, one final unsort
//   standalone  vt refreshed before every shuffle, x/z/vt riding, no unsort
// Plain versions: ops/coal.py coal_resident_plain, coal_standalone_plain.
//
// What bounds it on the card: latency, not bytes or arithmetic.  A row
// reads and writes ~30 bytes a droplet once, while each substep needs the
// whole row twice (the shuffle, the partner fetch) and the row's counts.
// What the design does about it: one thread block per row and one thread
// per lane, the whole substep loop inside the kernel, the row in registers
// and shared memory between barriers.  The random numbers are Philox
// draws computed where they are used (philox.cuh).  The shuffle sorts a key
// that cannot tie (bits << 16 | lane; dead lanes above every live one)
// with a bitonic network: warp shuffles for partners in the warp, shared
// memory for the rest; each thread then fetches its SD from the lane the
// sort names.  Counts are integer block sums, exact in any order.  The
// hall-family efficiencies are read from the 128x128 table in global
// memory through the read-only cache.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "physics.cuh"

namespace lcp {

enum CoalMode { kStride = 0, kSort = 1, kStandalone = 2 };
constexpr int kMaxCap = 512;  // ops/coal.py MAX_CAP
constexpr int kPlanes = 7;    // n rw2 rd3 kpa e x z, e = vt or lane id

// The lane this thread's position takes its SD from after an ascending
// sort of the row's keys.
__device__ __forceinline__ int sorted_source(uint64_t key, uint64_t* s_key,
                                             int cap) {
  const int t = threadIdx.x;
  for (int k = 2; k <= cap; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      uint64_t other;
      if (j >= 32) {
        __syncthreads();
        s_key[t] = key;
        __syncthreads();
        other = s_key[t ^ j];
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      key = (keep_min == (key < other)) ? key : other;
    }
  }
  return static_cast<int>(key & 0xFFFF);
}

// v[0..N) of every lane := v[0..N) of lane src
template <int N>
__device__ __forceinline__ void gather(float (&v)[kPlanes], int src,
                                       float* s_pl, bool live) {
  const int t = threadIdx.x, nt = blockDim.x;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) s_pl[q * nt + t] = v[q];
  __syncthreads();
  if (live) {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = s_pl[q * nt + src];
  }
}

// v[0..N) of lane dst := v[0..N) of this lane (the inverse of gather)
template <int N>
__device__ __forceinline__ void scatter(float (&v)[kPlanes], int dst,
                                        float* s_pl, bool live) {
  const int t = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  if (live) {
#pragma unroll
    for (int q = 0; q < N; ++q) s_pl[q * nt + dst] = v[q];
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = s_pl[q * nt + t];
  }
}

// Publish this lane's SD and draw, then read lane q's.
__device__ __forceinline__ Drop exchange(const Drop& me, float u, int q,
                                         float* s_pl, float& u_q) {
  const int t = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  s_pl[t] = me.n;
  s_pl[nt + t] = me.rw2;
  s_pl[2 * nt + t] = me.rd3;
  s_pl[3 * nt + t] = me.kpa;
  s_pl[4 * nt + t] = me.vt;
  s_pl[5 * nt + t] = u;
  __syncthreads();
  u_q = s_pl[5 * nt + q];
  return Drop{s_pl[q], s_pl[nt + q], s_pl[2 * nt + q], s_pl[3 * nt + q],
              s_pl[4 * nt + q]};
}

// planes: n rw2 rd3 kpa x z; cells: 5 rows of n_cell: T p rhod eta dv
template <int MODE>
__global__ void __launch_bounds__(kMaxCap)
coal_kernel(const float* __restrict__ n_in, const float* __restrict__ rw2_in,
            const float* __restrict__ rd3_in, const float* __restrict__ kpa_in,
            const float* __restrict__ x_in, const float* __restrict__ z_in,
            const float* __restrict__ cells, float* __restrict__ n_out,
            float* __restrict__ rw2_out, float* __restrict__ rd3_out,
            float* __restrict__ kpa_out, float* __restrict__ x_out,
            float* __restrict__ z_out, float* __restrict__ vt_out,
            unsigned char* __restrict__ ovf_out, int n_cell, int cap,
            int sstp, double dt_sub, CollisionKernel kern, uint32_t seed,
            uint32_t step) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int t = threadIdx.x, nt = blockDim.x, r = blockIdx.x;
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);
  float* s_pl = reinterpret_cast<float*>(s_key + nt);
  int* s_red = reinterpret_cast<int*>(s_pl + kPlanes * nt);

  const float p = cells[n_cell + r];
  const float rhod = cells[2 * n_cell + r];
  const float eta = cells[3 * n_cell + r];
  const float dt_dv = rdiv_s(dt_sub, cells[4 * n_cell + r]);
  const bool live = t < cap;
  const size_t at = static_cast<size_t>(r) * cap + t;
  // this lane's SD: n rw2 rd3 kpa e x z
  float v[kPlanes] = {0.0f, 0.0f, 0.0f, 0.0f, static_cast<float>(t), 0.0f,
                      0.0f};
  if (live) {
    v[0] = n_in[at];
    v[1] = rw2_in[at];
    v[2] = rd3_in[at];
    v[3] = kpa_in[at];
    v[5] = x_in[at];
    v[6] = z_in[at];
  }
  auto vt_of = [&](float rw2) {
    return live ? vt_beard77(rw2, p, rhod, eta) : 0.0f;
  };
  int n_strides = 1;
  while ((1 << n_strides) <= cap / 4 && n_strides < 6) ++n_strides;

  bool ovf = false;
  for (int s = 0; s < sstp; ++s) {
    const int sidx = s % n_strides;
    if (MODE == kStandalone) v[4] = vt_of(v[1]);
    if (MODE != kStride || sidx == 0) {
      const uint32_t bits = philox_word(seed, r, step, s, kShuffle, t);
      const uint64_t key =
          live ? (static_cast<uint64_t>(v[0] > 0.0f ? bits : 0x100000000ull)
                  << 16) | static_cast<uint64_t>(t)
               : ~0ull;
      const int src = sorted_source(key, s_key, cap);
      if (MODE == kSort)
        gather<5>(v, src, s_pl, live);  // x, z stay; the lane id rides
      else
        gather<kPlanes>(v, src, s_pl, live);
    }
    const Drop me{v[0], v[1], v[2], v[3],
                  MODE == kStandalone ? v[4] : vt_of(v[1])};
    const float u = u01(philox_word(seed, r, step, s, kBernoulli, t));
    const bool alive = live && me.n > 0.0f;

    if (MODE == kStride) {
      // dense.py pair_and_collide_partners: lane t pairs with t ^ stride
      const int stride = 1 << sidx;
      float u_b;
      const Drop pa = exchange(me, u, t ^ stride, s_pl, u_b);
      const bool pair_ok = alive && pa.n > 0.0f;
      const bool is_a = (t & stride) == 0;
      const int sums =
          block_sum<int>((alive ? 1 : 0) + (pair_ok && is_a ? 1 << 16 : 0),
                         s_red);
      const float count = static_cast<float>(sums & 0xFFFF);
      const float npairs = static_cast<float>(sums >> 16);
      const float scale =
          (count > 1.0f && npairs > 0.0f)
              ? div_s(count * (count - 1.0f), 2.0) / fmaxf(npairs, 1.0f)
              : 0.0f;
      const bool self_big = me.n > pa.n || (me.n == pa.n && is_a);
      const Collision c = shima(kern, me, pa, self_big, pair_ok,
                                is_a ? u : u_b, dt_dv, scale);
      ovf |= c.overflow;
      if (c.happened && self_big) {
        v[0] = c.n_big_new;
      } else if (c.happened) {
        v[1] = c.rw2_small_new;
        v[2] = c.rd3_small_new;
        v[3] = c.kpa_small_new;
      }
    } else {
      // dense.py pair_and_collide: lanes 2j and 2j+1 pair; both compute the
      // pair's outcome from the same inputs and each keeps its own part
      const int count = block_sum<int>(alive ? 1 : 0, s_red);
      const bool odd = t & 1;
      float u_q;
      const Drop nb = exchange(me, u, odd ? t - 1 : min(t + 1, cap - 1),
                               s_pl, u_q);
      const Drop& a = odd ? nb : me;
      const Drop& b = odd ? me : nb;
      const bool is_pair = live && (odd ? t : t + 1) < count;
      const float cf = static_cast<float>(count);
      const float half = floorf(div_s(cf, 2.0));
      const float scale =
          count > 1 ? div_s(cf * (cf - 1.0f), 2.0) / half : 0.0f;
      const bool a_big = a.n >= b.n;
      const Collision c =
          shima(kern, a, b, a_big, is_pair, odd ? u_q : u, dt_dv, scale);
      ovf |= c.overflow && !odd;
      const bool own_big = odd ? !a_big : a_big;
      if (c.happened && own_big) {
        v[0] = c.n_big_new;
      } else if (c.happened) {
        v[1] = c.rw2_small_new;
        v[2] = c.rd3_small_new;
        v[3] = c.kpa_small_new;
      }
    }
  }
  // sort: one unsort by the lane id puts every SD back in its lane
  if (MODE == kSort) scatter<5>(v, static_cast<int>(v[4]), s_pl, live);
  if (MODE == kStandalone) v[4] = vt_of(v[1]);

  if (live) {
    n_out[at] = v[0];
    rw2_out[at] = v[1];
    rd3_out[at] = v[2];
    kpa_out[at] = v[3];
    x_out[at] = v[5];
    z_out[at] = v[6];
    if (MODE == kStandalone) vt_out[at] = v[4];
  }
  const int any = __syncthreads_or(ovf);
  if (t == 0) ovf_out[r] = any ? 1 : 0;
}

template <int MODE>
int launch(const float* n, const float* rw2, const float* rd3,
           const float* kpa, const float* x, const float* z,
           const float* cells, const float* eff, float* n_out, float* rw2_out,
           float* rd3_out, float* kpa_out, float* x_out, float* z_out,
           float* vt_out, unsigned char* ovf, int n_cell, int cap, int sstp,
           double dt_sub, int kern, double coef, double r_max_m1, int clamp,
           unsigned seed, unsigned step, cudaStream_t stream) {
  if (cap < 1 || cap > kMaxCap || (cap & (cap - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = cap < 32 ? 32 : cap;
  const size_t smem = nt * sizeof(uint64_t) + kPlanes * nt * sizeof(float)
                      + (nt / 32 + 1) * sizeof(int);
  const CollisionKernel k{kern, static_cast<float>(coef), eff,
                          static_cast<float>(r_max_m1), clamp};
  coal_kernel<MODE><<<n_cell, nt, smem, stream>>>(
      n, rw2, rd3, kpa, x, z, cells, n_out, rw2_out, rd3_out, kpa_out, x_out,
      z_out, vt_out, ovf, n_cell, cap, sstp, dt_sub, k, seed, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lcp

// The resident step's form: stride (sort = 0) or sort (sort = 1) pairing.
extern "C" int lcp_coal(const float* n, const float* rw2, const float* rd3,
                        const float* kpa, const float* x, const float* z,
                        const float* cells, const float* eff, float* n_out,
                        float* rw2_out, float* rd3_out, float* kpa_out,
                        float* x_out, float* z_out, unsigned char* ovf,
                        int n_cell, int cap, int sstp, double dt_sub,
                        int kern, double coef, double r_max_m1, int clamp,
                        unsigned seed, unsigned step, int sort,
                        cudaStream_t stream) {
  auto go = sort ? &lcp::launch<lcp::kSort> : &lcp::launch<lcp::kStride>;
  return go(n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out, rd3_out,
            kpa_out, x_out, z_out, nullptr, ovf, n_cell, cap, sstp, dt_sub,
            kern, coef, r_max_m1, clamp, seed, step, stream);
}

// The standalone form (dense.coal), which also returns vt.
extern "C" int lcp_coal_standalone(
    const float* n, const float* rw2, const float* rd3, const float* kpa,
    const float* x, const float* z, const float* cells, const float* eff,
    float* n_out, float* rw2_out, float* rd3_out, float* kpa_out,
    float* x_out, float* z_out, float* vt_out, unsigned char* ovf, int n_cell,
    int cap, int sstp, double dt_sub, int kern, double coef, double r_max_m1,
    int clamp, unsigned seed, unsigned step, cudaStream_t stream) {
  return lcp::launch<lcp::kStandalone>(
      n, rw2, rd3, kpa, x, z, cells, eff, n_out, rw2_out, rd3_out, kpa_out,
      x_out, z_out, vt_out, ovf, n_cell, cap, sstp, dt_sub, kern, coef,
      r_max_m1, clamp, seed, step, stream);
}
