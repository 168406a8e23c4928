// The threefry split and random draws of the Data Engine's chunk step
// (FENIX §4.2: the Rate Limiter's random threshold), every pipe of a step
// in one launch.
//
// Replaces no TPU kernel: the JAX package draws with jax.random's
// threefry (split, then randint), which XLA fuses into its step.  The
// port's plain version of the same draws (core/prng.py: prng.split, then
// prng.randint) runs ~170 int64 elementwise kernels a threefry2x32 call,
// ~510 a chunk.  Per pipe p, from its carry key k = key[p] (two uint32
// words held in int64):
//
//   key_out[p] = split(k)[0] = threefry2x32(k, (0, 0))
//   sub_out[p] = split(k)[1] = threefry2x32(k, (0, 1))
//   rand[p, i] = randint(sub_out[p], (n,), 0, 2^prob_bits)[i],  i < n
//
// bit for bit as core/prng.py and jax.random give them (gate_common.cuh
// derives the draw).  With n = 0 it gives the split alone: the drawing
// gate kernel (fused_gate_prng) draws its lanes from sub itself.
//
// Bound on the H100: launch latency.  The work is P x (n + 3)
// threefry2x32 calls of ~70 32-bit instructions each: at [1, 4096] ~0.29 M
// instructions, ~17 ns at the 32-bit issue rate, and ~16 KB written
// (4 bytes a lane, 32 a pipe), ~5 ns at 3.35 TB/s.  One launch takes
// microseconds.
//
// Design: one launch for every pipe, on a grid of (lane blocks, P).
// Every thread recomputes its pipe's two splits in registers (40 rounds
// that read nothing but the key's 16 bytes: no shared memory, no barrier)
// and then draws its lanes; thread 0 of a pipe's first block writes key'
// and sub.  The outputs are out of place, since other blocks still read
// the key.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const int64_t* __restrict__ key,
                     int64_t* __restrict__ key_out,
                     int64_t* __restrict__ sub_out,
                     int32_t* __restrict__ rand, int n, uint32_t mask) {
  const int p = blockIdx.y;
  const uint32_t k0 = static_cast<uint32_t>(key[2 * p]);
  const uint32_t k1 = static_cast<uint32_t>(key[2 * p + 1]);
  uint32_t s0, s1;
  fenix_gate::draw_key(k0, k1, s0, s1);              // sub = split(k)[1]
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    uint32_t a0 = 0u, a1 = 0u;
    fenix_gate::threefry2x32(k0, k1, a0, a1);        // key' = split(k)[0]
    key_out[2 * p] = a0;
    key_out[2 * p + 1] = a1;
    sub_out[2 * p] = s0;
    sub_out[2 * p + 1] = s1;
  }
  if (n == 0) return;
  uint32_t d0, d1;
  fenix_gate::draw_key(s0, s1, d0, d1);              // split(sub)[1]
  int32_t* row = rand + static_cast<size_t>(p) * n;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    row[i] = fenix_gate::draw_lane(d0, d1, static_cast<uint32_t>(i), mask);
}

}  // namespace

// key, key_out, sub_out: [pipes, 2] int64 (uint32 words); rand: [pipes, n]
// int32 (unused when n == 0).  pipes in [1, 65535], n >= 0, prob_bits in
// [1, 31].  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int threefry_draw_launch(const void* key, void* key_out,
                                    void* sub_out, void* rand, int pipes,
                                    int n, int prob_bits, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int threads = n == 0 ? 32 : kThreads;       // the split alone
  const uint32_t mask = (1u << prob_bits) - 1u;
  threefry_draw_kernel<<<dim3(blocks, pipes), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<int64_t*>(key_out),
      static_cast<int64_t*>(sub_out), static_cast<int32_t*>(rand), n, mask);
  return static_cast<int>(cudaGetLastError());
}
