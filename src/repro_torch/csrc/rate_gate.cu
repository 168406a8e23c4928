// Selection-only probability gate of the Rate Limiter (FENIX §4.2,
// Algorithm 1 line 6).
//
// Replaces the TPU kernel src/repro/kernels/rate_gate/kernel.py ::
// rate_gate_pallas in both its variants: rand-input (_kernel_randin,
// `rate_gate_launch`) and on-core PRNG (_kernel_prng,
// `rate_gate_prng_launch`).  Per lane i:
//
//   selected_i = rand16_i < lut[clip(t_i >> t_shift), clip(c_i >> c_shift)]
//
// rand16_i is read from memory or drawn in registers from a threefry key
// (gate_common.cuh); drawn from PRNGKey(seed), it is lane for lane the
// draw of the reference's rate_gate(seed=seed, rand16=None,
// backend="pallas"), which does not depend on the reference's padding to
// 256 lanes because partitionable threefry bits depend only on the lane.
//
// Bound on the H100: bytes.  Each lane reads two or three int32 values and
// writes one byte; the LUT is 8 KB.  The draw adds ~100 integer operations
// a lane, under the bytes' time at the 67 T ops/s scalar rate.
//
// Design: the TPU kernel walks 256-lane tiles on a sequential grid and
// evaluates the lookup as a one-hot matmul.  Lanes are independent, so
// here many CTAs of 256 threads each stage the LUT in shared memory and
// then gather from it, striding over the lanes; ragged lanes are masked,
// so the caller pads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

// kDraw: draw rand16 from `key` (rand16 unused), else read it (key unused)
template <bool kDraw>
__global__ void __launch_bounds__(kThreads)
rate_gate_kernel(const int32_t* __restrict__ t_i,
                 const int32_t* __restrict__ c_i,
                 const int32_t* __restrict__ rand16,
                 const int64_t* __restrict__ key,
                 const int32_t* __restrict__ lut,
                 uint8_t* __restrict__ selected, int n, int tb, int cb,
                 int t_shift, int c_shift, uint32_t rand_mask) {
  extern __shared__ int32_t s_lut[];
  for (int i = threadIdx.x; i < tb * cb; i += kThreads) s_lut[i] = lut[i];
  uint32_t d0 = 0u, d1 = 0u;
  if (kDraw) fenix_gate::draw_key(key, d0, d1);
  __syncthreads();
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += gridDim.x * kThreads) {
    const int prob = fenix_gate::lut_lookup(s_lut, t_i[idx], c_i[idx], tb,
                                            cb, t_shift, c_shift);
    const int r = kDraw ? fenix_gate::draw_lane(d0, d1, idx, rand_mask)
                        : rand16[idx];
    selected[idx] = r < prob ? 1 : 0;
  }
}

template <bool kDraw>
int launch(const void* t_i, const void* c_i, const void* rand16,
           const void* key, const void* lut, void* selected, int n, int tb,
           int cb, int t_shift, int c_shift, uint32_t rand_mask,
           void* stream) {
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(tb) * cb;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rate_gate_kernel<kDraw>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(t_i), static_cast<const int32_t*>(c_i),
          static_cast<const int32_t*>(rand16),
          static_cast<const int64_t*>(key), static_cast<const int32_t*>(lut),
          static_cast<uint8_t*>(selected), n, tb, cb, t_shift, c_shift,
          rand_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rand-input variant.  Launches on `stream`; returns cudaGetLastError()
// (0 on success).  n >= 1.
extern "C" int rate_gate_launch(const void* t_i, const void* c_i,
                                const void* rand16, const void* lut,
                                void* selected, int n, int tb, int cb,
                                int t_shift, int c_shift, void* stream) {
  return launch<false>(t_i, c_i, rand16, nullptr, lut, selected, n, tb, cb,
                       t_shift, c_shift, 0u, stream);
}

// Drawing variant: `key` is a threefry key, [2] int64 words holding uint32
// values, read on the device.  prob_bits in [1, 31].
extern "C" int rate_gate_prng_launch(const void* t_i, const void* c_i,
                                     const void* key, const void* lut,
                                     void* selected, int n, int tb, int cb,
                                     int t_shift, int c_shift, int prob_bits,
                                     void* stream) {
  const uint32_t mask = (1u << prob_bits) - 1u;
  return launch<true>(t_i, c_i, nullptr, key, lut, selected, n, tb, cb,
                      t_shift, c_shift, mask, stream);
}
