// Device helpers shared by the Rate-Limiter gate kernels (fused_gate.cu,
// rate_gate.cu) and the chunk step's draws (threefry_draw.cu): the
// switch's LUT lookup and the threefry draw of the gate's uniform bits.
//
// The draw reproduces jax.random.randint(key, (n,), 0, 2^prob_bits) with
// partitionable threefry (JAX 0.9's default) lane for lane, in uint32
// registers:
//   k2      = threefry2x32(key, (0, 1))        (the second key of split)
//   bits_i  = x0 ^ x1 of threefry2x32(k2, (0, i)),  masked to prob_bits.
// randint also draws from the first key of the split, but multiplies
// those bits by (2^16 % span)^2 mod 2^32, which is 0 for every
// power-of-two span (the wrappers assert it), so they never reach the
// result.

#pragma once

#include <stdint.h>

namespace fenix_gate {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// prob = lut[clip(t >> t_shift), clip(c >> c_shift)], from shared memory
__device__ __forceinline__ int lut_lookup(const int32_t* s_lut, int t, int c,
                                          int tb, int cb, int t_shift,
                                          int c_shift) {
  const int ti = clampi(t >> t_shift, 0, tb - 1);
  const int ci = clampi(c >> c_shift, 0, cb - 1);
  return s_lut[ti * cb + ci];
}

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0;
}

// Threefry-2x32, 20 rounds, in place on the count words (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
}

// split(key)[1] of a key (k0, k1): the key of randint's lower bits.
__device__ __forceinline__ void draw_key(uint32_t k0, uint32_t k1,
                                         uint32_t& d0, uint32_t& d1) {
  d0 = 0u;
  d1 = 1u;
  threefry2x32(k0, k1, d0, d1);
}

// The same of a threefry key held as two int64 words of uint32 values
// (the port's key layout).
__device__ __forceinline__ void draw_key(const int64_t* key, uint32_t& d0,
                                         uint32_t& d1) {
  draw_key(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]), d0,
           d1);
}

// Lane `lane`'s draw in [0, mask]: randint's value for a span of mask + 1.
__device__ __forceinline__ int draw_lane(uint32_t d0, uint32_t d1,
                                         uint32_t lane, uint32_t mask) {
  uint32_t x0 = 0u, x1 = lane;
  threefry2x32(d0, d1, x0, x1);
  return static_cast<int>((x0 ^ x1) & mask);
}

}  // namespace fenix_gate
