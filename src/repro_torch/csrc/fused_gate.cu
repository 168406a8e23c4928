// Fused admission gate for the Data Engine's Rate Limiter (FENIX §4.2).
//
// Replaces the TPU kernel src/repro/kernels/rate_gate/kernel.py ::
// fused_gate_pallas in both its variants: rand-input (_kernel_fused_randin,
// `fused_gate_launch`) and on-core PRNG (_kernel_fused_prng,
// `fused_gate_prng_launch`), with _fused_body and _lut_lookup.  Per packet
// i of one batch:
//
//   prob_i    = lut[clip(t_i >> t_shift), clip(c_i >> c_shift)]
//   sel_i     = i < n && rand16_i < prob_i
//   spend_i   = sum_{j <= i} sel_j * cost_us
//   granted_i = sel_i && spend_i <= burst0 + max(ts_i - t_ref, 0)
//   bucket'   = clip(burst0 + max(ts_{n-1} - t_ref, 0)
//                    - n_granted * cost_us, 0, bucket_cap_us)
//
// rand16_i is read from memory (rand-input) or drawn in registers from
// the chunk's threefry subkey (gate_common.cuh).  The TPU's on-core bits
// cannot be reproduced off a TPU and were promised only in distribution;
// keyed to the chunk's threefry stream, the drawn variant is bit-exact
// with the rand-input one fed prng.randint(key, n, 0, 2^prob_bits).
//
// Bound on the H100: bytes.  A batch reads four int32 lanes per packet
// (three when drawing) and the 8 KB LUT, and writes one byte per packet:
// about 74 KB at 4096 packets.  The draw adds ~100 integer operations a
// lane, still under the bytes' time.  The work is one dependent prefix
// sum, so in practice launch latency and the block scan's barriers bound
// it, not either roofline.
//
// Design: the TPU kernel evaluates the lookup as a one-hot MXU matmul and
// carries the spend across a sequential grid in SMEM.  Neither carries
// over.  One CTA of 1024 threads copies the LUT into shared memory and
// gathers from it directly; it walks the batch in 1024-lane tiles with a
// block-wide inclusive scan (warp shuffles, then a scan of the 32 warp
// sums), keeping the running spend and grant count in registers from
// tile to tile.  Lanes past n are masked, so the caller pads nothing, and
// the bucket level is computed from the true last timestamp.  A
// multi-CTA decoupled look-back scan is the next step for larger batches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_common.cuh"

namespace {

using fenix_gate::clampi;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// kDraw: draw rand16 from `key` (rand16 unused), else read it (key unused)
template <bool kDraw>
__global__ void __launch_bounds__(kThreads)
fused_gate_kernel(const int32_t* __restrict__ t_i,
                  const int32_t* __restrict__ c_i,
                  const int32_t* __restrict__ ts,
                  const int32_t* __restrict__ rand16,
                  const int64_t* __restrict__ key,
                  const int32_t* __restrict__ lut,
                  const int32_t* __restrict__ scal,
                  uint8_t* __restrict__ granted,
                  int32_t* __restrict__ bucket_out,
                  int n, int tb, int cb, int t_shift, int c_shift,
                  uint32_t rand_mask, int cost_us, int bucket_cap_us) {
  extern __shared__ int32_t s_lut[];
  __shared__ int32_t s_warp[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < tb * cb; i += kThreads) s_lut[i] = lut[i];
  // scal[0] = burst0 (batch-start credit, capped), scal[1] = t_ref
  const int burst0 = scal[0];
  const int t_ref = scal[1];
  uint32_t d0 = 0u, d1 = 0u;
  if (kDraw) fenix_gate::draw_key(key, d0, d1);
  __syncthreads();

  int spend_carry = 0;   // selected spend of all earlier tiles
  int count_carry = 0;   // grants of all earlier tiles
  for (int base = 0; base < n; base += kThreads) {
    const int idx = base + tid;
    const bool valid = idx < n;
    bool sel = false;
    int ts_v = 0;
    if (valid) {
      const int prob = fenix_gate::lut_lookup(s_lut, t_i[idx], c_i[idx], tb,
                                              cb, t_shift, c_shift);
      const int r = kDraw ? fenix_gate::draw_lane(d0, d1, idx, rand_mask)
                          : rand16[idx];
      sel = r < prob;
      ts_v = ts[idx];
    }
    // block-wide inclusive scan of sel * cost_us
    int x = sel ? cost_us : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const int spend = spend_carry + (warp > 0 ? s_warp[warp - 1] : 0) + x;
    const int gap = ts_v - t_ref;
    const int credit = burst0 + (gap > 0 ? gap : 0);
    const bool g = sel && spend <= credit;
    if (valid) granted[idx] = g ? 1 : 0;
    spend_carry += s_warp[kWarps - 1];
    // the barrier also orders this tile's reads of s_warp before the
    // next tile's writes
    count_carry += __syncthreads_count(g);
  }
  if (tid == 0) {
    const int gap = ts[n - 1] - t_ref;
    const int credit = burst0 + (gap > 0 ? gap : 0);
    bucket_out[0] = clampi(credit - count_carry * cost_us, 0, bucket_cap_us);
  }
}

template <bool kDraw>
int launch(const void* t_i, const void* c_i, const void* ts,
           const void* rand16, const void* key, const void* lut,
           const void* scal, void* granted, void* bucket_out, int n, int tb,
           int cb, int t_shift, int c_shift, uint32_t rand_mask, int cost_us,
           int bucket_cap_us, void* stream) {
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(tb) * cb;
  fused_gate_kernel<kDraw>
      <<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(t_i), static_cast<const int32_t*>(c_i),
          static_cast<const int32_t*>(ts),
          static_cast<const int32_t*>(rand16),
          static_cast<const int64_t*>(key), static_cast<const int32_t*>(lut),
          static_cast<const int32_t*>(scal), static_cast<uint8_t*>(granted),
          static_cast<int32_t*>(bucket_out), n, tb, cb, t_shift, c_shift,
          rand_mask, cost_us, bucket_cap_us);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rand-input variant.  Launches on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int fused_gate_launch(const void* t_i, const void* c_i,
                                 const void* ts, const void* rand16,
                                 const void* lut, const void* scal,
                                 void* granted, void* bucket_out, int n,
                                 int tb, int cb, int t_shift, int c_shift,
                                 int cost_us, int bucket_cap_us,
                                 void* stream) {
  return launch<false>(t_i, c_i, ts, rand16, nullptr, lut, scal, granted,
                       bucket_out, n, tb, cb, t_shift, c_shift, 0u, cost_us,
                       bucket_cap_us, stream);
}

// Drawing variant: `key` is the chunk's threefry subkey, [2] int64 words
// holding uint32 values, read on the device.  prob_bits in [1, 31].
extern "C" int fused_gate_prng_launch(const void* t_i, const void* c_i,
                                      const void* ts, const void* key,
                                      const void* lut, const void* scal,
                                      void* granted, void* bucket_out,
                                      int n, int tb, int cb, int t_shift,
                                      int c_shift, int prob_bits,
                                      int cost_us, int bucket_cap_us,
                                      void* stream) {
  const uint32_t mask = (1u << prob_bits) - 1u;
  return launch<true>(t_i, c_i, ts, nullptr, key, lut, scal, granted,
                      bucket_out, n, tb, cb, t_shift, c_shift, mask, cost_us,
                      bucket_cap_us, stream);
}
