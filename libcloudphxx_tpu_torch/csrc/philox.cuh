// Philox 4x32-10 (Salmon et al., SC11), word 0 of one block: the counter-
// based draws of kernel E.  Same rounds as the plain version
// ops/philox.py philox4x32, so both give the same bits from
// key (seed, row) and counter (step, substep, kind, lane).
#pragma once

#include <cstdint>

namespace lcp {

constexpr uint32_t kShuffle = 0, kBernoulli = 1;  // ops/philox.py SHUFFLE ...

__device__ __forceinline__ uint32_t philox_word(uint32_t seed, uint32_t row,
                                                uint32_t step,
                                                uint32_t substep,
                                                uint32_t kind,
                                                uint32_t lane) {
  uint32_t c0 = step, c1 = substep, c2 = kind, c3 = lane;
  uint32_t k0 = seed, k1 = row;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// ops/philox.py u01: the top 23 bits times 2**-23, exact in float32
__device__ __forceinline__ float u01(uint32_t bits) {
  return static_cast<float>(bits >> 9) * (1.0f / 8388608.0f);
}

}  // namespace lcp
