/* Native core for the reference-compatible SD init sampler (the port's
 * copy of libcloudphxx_tpu/native/refinit_core.c).
 *
 * The golden-parity init (lgrngn/refinit.py) must reproduce the reference
 * serial backend bit-for-bit: std::mt19937 draws turned into float32 u01
 * values (libstdc++ generate_canonical<float, 24>: float(u32) / 2^32) and
 * glibc logf/expf evaluated on whole arrays.  numpy's own f32 SIMD log/exp
 * differ from glibc by 1 ulp at some inputs — enough to flip integer
 * multiplicities at the floor(+0.5) knife edge — and per-element ctypes
 * calls cost ~1 us each (minutes at 3-D population sizes).  This file is
 * the vectorized native path: the exact mt19937 recurrence and batch
 * logf/expf at C speed.
 *
 * Built on demand by native/__init__.py with the system C compiler into
 * the package's _build/ directory; loaded with ctypes.
 */

#include <math.h>
#include <stdint.h>

/* --- std::mt19937 (MT19937 32-bit, init_genrand seeding) --------------- */

typedef struct {
    uint32_t mt[624];
    int mti;
} mt19937_t;

void mt19937_seed(mt19937_t *s, uint32_t seed)
{
    s->mt[0] = seed;
    for (int i = 1; i < 624; ++i)
        s->mt[i] = (uint32_t)(1812433253u * (s->mt[i - 1]
                              ^ (s->mt[i - 1] >> 30)) + i);
    s->mti = 624;
}

static uint32_t mt19937_next(mt19937_t *s)
{
    static const uint32_t MAG[2] = {0u, 0x9908b0dfu};
    if (s->mti >= 624) {
        int kk;
        uint32_t y;
        for (kk = 0; kk < 624 - 397; ++kk) {
            y = (s->mt[kk] & 0x80000000u) | (s->mt[kk + 1] & 0x7fffffffu);
            s->mt[kk] = s->mt[kk + 397] ^ (y >> 1) ^ MAG[y & 1u];
        }
        for (; kk < 623; ++kk) {
            y = (s->mt[kk] & 0x80000000u) | (s->mt[kk + 1] & 0x7fffffffu);
            s->mt[kk] = s->mt[kk + (397 - 624)] ^ (y >> 1) ^ MAG[y & 1u];
        }
        y = (s->mt[623] & 0x80000000u) | (s->mt[0] & 0x7fffffffu);
        s->mt[623] = s->mt[396] ^ (y >> 1) ^ MAG[y & 1u];
        s->mti = 0;
    }
    uint32_t y = s->mt[s->mti++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= (y >> 18);
    return y;
}

/* u01 stream: float(u32) / 2^32, the libstdc++ uniform_real_distribution
 * <float> path the reference serial RNG uses (src/detail/urand.hpp:20-88) */
void mt19937_u01(mt19937_t *s, float *out, int64_t n)
{
    for (int64_t i = 0; i < n; ++i)
        out[i] = (float)mt19937_next(s) / 4294967296.0f;
}

/* --- glibc-exact float32 transcendentals ------------------------------- */

void vec_logf(const float *in, float *out, int64_t n)
{
    for (int64_t i = 0; i < n; ++i)
        out[i] = logf(in[i]);
}

void vec_expf(const float *in, float *out, int64_t n)
{
    for (int64_t i = 0; i < n; ++i)
        out[i] = expf(in[i]);
}
