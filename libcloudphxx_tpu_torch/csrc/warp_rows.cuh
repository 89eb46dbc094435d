// The row layout of kernels C (transport.cu) and D (merge.cu): a warp a
// row of SD slots, 8 rows a block, lane j holding the four consecutive
// slots 4j..4j+3 of each 128-slot tile of a row.  Where the row capacity is
// a multiple of 128 and the planes are 16-byte aligned (the "vector" form,
// chosen by the C entry points with vector_ok), a lane moves its four slots
// of a plane as one 16-byte load or store; otherwise (the scalar form) as
// four 4-byte ones, with the slots past the capacity masked.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace lcp {

constexpr int kWarpRows = 8;    // rows (warps) a block
constexpr int kTile = 128;      // slots a warp takes at once: 4 a lane
constexpr unsigned kAll = 0xffffffffu;

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// the four slots of a lane from slot l0 (at offset ``off``); the scalar
// form gives ``fill`` for the slots past ``cap``
template <bool VEC, typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, size_t off,
                                      int l0, int cap, T fill, T (&v)[4]) {
  if constexpr (VEC) {
    const auto t = __ldg(reinterpret_cast<const typename Vec4<T>::type*>(
        p + off));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = l0 + q < cap ? __ldg(p + off + q) : fill;
  }
}

template <bool VEC, typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, size_t off, int l0,
                                       int cap, const T (&v)[4]) {
  if constexpr (VEC) {
    typename Vec4<T>::type t;
    t.x = v[0], t.y = v[1], t.z = v[2], t.w = v[3];
    *reinterpret_cast<typename Vec4<T>::type*>(p + off) = t;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (l0 + q < cap) p[off + q] = v[q];
  }
}

// whether a launch at row capacity ``cap`` on these planes takes the
// vector form
inline bool vector_ok(int cap, std::initializer_list<const void*> planes) {
  bool ok = cap % kTile == 0;
  for (const void* p : planes)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return ok;
}

inline int row_blocks(int n_cell) {
  return (n_cell + kWarpRows - 1) / kWarpRows;
}

}  // namespace lcp
