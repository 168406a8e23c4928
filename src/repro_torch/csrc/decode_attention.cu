// GQA decode attention: one new token per sequence against its KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py ::
// decode_attention_pallas (its `_kernel`).  For every batch row b and query
// head h of group G = Hq / Hkv:
//
//   out[b, h] = softmax(q[b, h] . K[b, :len_b, h/G]^T * D^-1/2)
//               . V[b, :len_b, h/G]
//
// with scores, the running max, the sum and the accumulator in float32,
// updated tile by tile with the TPU kernel's online-softmax step (the
// isinf guards included), and out = acc / max(l, 1e-30), so an empty row
// (len_b = 0) gives 0.
//
// Bound on the H100: bytes.  The valid K/V rows are read once (2 * len_b *
// D * sizeof(kv) per KV head); each row is used by G query heads, i.e.
// ~2G operations a byte in bf16, far under the card's ~295 operations a
// byte.
//
// Design.  The TPU kernel walks (B, Hkv, S/ck) on a sequential grid with K/V
// transposed to [B, Hkv, S, D] by its wrapper (a full copy of the cache per
// call) and padded to a multiple of ck (another).  Here one CTA of eight
// warps owns one (b, kv_head) and reads the cache in place in its own
// [B, S, Hkv, D] layout: a row of one KV head is D contiguous elements at
// stride Hkv * D, copied 16 bytes a thread with cp.async into a tile in
// shared memory, double-buffered so the next tile's copies are in flight
// while this tile is computed.  Rows past len_b are never read; the last
// tile is ragged.  Within a tile: a few adjacent threads per K row compute
// its G scores against the group's queries (float32, in shared memory; a
// shuffle sums their slices), one warp per query head folds the tile into
// its (m, l), and each thread accumulates a pair of value columns for all
// G heads over its group of rows; the row groups' partial sums are added
// once, at the end.  Nothing is split across CTAs (flash-decoding) yet:
// with B * Hkv CTAs a small batch does not fill the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;         // query heads per KV head
constexpr int kTileBytes = 16384;    // one K (or V) tile of one buffer
constexpr int kMaxRows = 128;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename TKV, int D>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kChunks = D / kVec;        // 16-byte copies a row
  // rows are padded by 16 bytes, so that the 16-byte reads of the threads
  // of a quarter-warp fall in distinct bank groups
  static constexpr int kStride = D + kVec;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));
  static constexpr int kRows =
      kTileBytes / kRowBytes < kMaxRows ? kTileBytes / kRowBytes : kMaxRows;
  // scores: kTpr adjacent threads share a K row, kChunks / kTpr chunks each
  static constexpr int kTpr = kThreads / kRows;
  // values: a thread owns a pair of columns of one row group
  static constexpr int kPairs = D / 2;
  static constexpr int kGroups = kThreads / kPairs;
  static constexpr size_t kSmem =
      4 * sizeof(TKV) * static_cast<size_t>(kRows) * kStride  // K, V x 2
      + sizeof(float) * (kMaxGroup * D + kMaxGroup * kRows + 3 * kMaxGroup);
  static_assert(kTpr >= 1 && kTpr <= 32 && kChunks % kTpr == 0, "tile");
  static_assert(kGroups >= 1 && kThreads % kPairs == 0, "value groups");
  // the row groups' partial accumulators are summed in the K/V buffers
  static_assert(sizeof(float) * kGroups * kMaxGroup * D
                <= 4 * sizeof(TKV) * static_cast<size_t>(kRows) * kStride,
                "reduction buffer");
};

// Start the copies of rows [row0, row0 + n) of one KV head into `dst`
// ([rows, kStride], row-major).
template <typename TKV, int D>
__device__ __forceinline__ void stage(TKV* dst, const TKV* src,
                                      int64_t stride_s, int row0, int n) {
  using T = Tile<TKV, D>;
  for (int c = threadIdx.x; c < n * T::kChunks; c += kThreads) {
    const int r = c / T::kChunks, col = (c % T::kChunks) * T::kVec;
    cp_async16(dst + r * T::kStride + col,
               src + static_cast<int64_t>(row0 + r) * stride_s + col);
  }
}

template <typename TKV>
__device__ __forceinline__ void load16(const TKV* src, float* dst);
template <>
__device__ __forceinline__ void load16<float>(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
}
template <>
__device__ __forceinline__ void load16<bf16>(const bf16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x, dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}
__device__ __forceinline__ float2 load2(const bf16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        TKV* __restrict__ out, int S, int hkv, int G,
                        int64_t k_sb, int64_t k_ss, int64_t v_sb,
                        int64_t v_ss, float scale) {
  using T = Tile<TKV, D>;
  constexpr int TK = T::kRows;
  constexpr int RS = T::kStride;
  constexpr int VEC = T::kVec;
  constexpr int TPR = T::kTpr;
  constexpr int CPT = T::kChunks / TPR;     // chunks a thread, scores
  constexpr int NP = T::kPairs;
  constexpr int RG = T::kGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* ks = reinterpret_cast<TKV*>(smem_raw);            // [2][TK][RS]
  TKV* vs = ks + 2 * TK * RS;                             // [2][TK][RS]
  float* q_s = reinterpret_cast<float*>(vs + 2 * TK * RS);  // [G][D]
  float* sc = q_s + kMaxGroup * D;                        // [G][TK]
  float* m_s = sc + kMaxGroup * TK;
  float* l_s = m_s + kMaxGroup;
  float* corr_s = l_s + kMaxGroup;

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hq = hkv * G;
  const int len = min(max(lengths[b], 0), S);
  const TKV* kb = k + b * k_sb + static_cast<int64_t>(h) * D;
  const TKV* vb = v + b * v_sb + static_cast<int64_t>(h) * D;
  const int64_t q0 = (static_cast<int64_t>(b) * hq + h * G) * D;
  // this thread's K row slot and part (scores), column pair and row group
  // (values)
  const int srow = threadIdx.x / TPR, spart = threadIdx.x % TPR;
  const int cp = threadIdx.x % NP, rg = threadIdx.x / NP;

  for (int i = threadIdx.x; i < G * D; i += kThreads)
    q_s[i] = to_f32(q[q0 + i]);
  if (threadIdx.x < kMaxGroup) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[kMaxGroup][2];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g][0] = acc[g][1] = 0.f;

  const int n_tiles = (len + TK - 1) / TK;
  if (n_tiles > 0) {
    stage<TKV, D>(ks, kb, k_ss, 0, min(TK, len));
    stage<TKV, D>(vs, vb, v_ss, 0, min(TK, len));
  }
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int rows = min(TK, len - t * TK);
    if (t + 1 < n_tiles) {
      const int next = (t + 1) * TK;
      stage<TKV, D>(ks + (buf ^ 1) * TK * RS, kb, k_ss, next,
                    min(TK, len - next));
      stage<TKV, D>(vs + (buf ^ 1) * TK * RS, vb, v_ss, next,
                    min(TK, len - next));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile (and, at t = 0, q_s, m_s, l_s) visible
    const TKV* kt = ks + buf * TK * RS;
    const TKV* vt = vs + buf * TK * RS;

    // scores of this tile: TPR adjacent threads per K row, each a slice
    // of D for all G heads of the group, then a shuffle reduction
    {
      float s[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
      if (srow < rows) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = (spart * CPT + c) * VEC;
          float kf[VEC];
          load16<TKV>(kt + srow * RS + col, kf);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < G) {
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                s[g] += q_s[g * D + col + e] * kf[e];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
      if (spart == 0 && srow < rows) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) sc[g * TK + srow] = s[g] * scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head folds the tile into (m, l)
    for (int g = warp; g < G; g += kWarps) {
      float* sg = sc + g * TK;
      float mx = -INFINITY;
      for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < rows; j += 32) {
        const float sj = sg[j];
        const float p = isinf(sj) ? 0.f : expf(sj - m_safe);
        sg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = isinf(m_old) ? 0.f : expf(m_old - m_safe);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * corr[g] + sum_j p[g, j] * V[j, d]: this thread's
    // column pair over its row group's rows, for all G heads
    {
      float a[kMaxGroup][2];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) a[g][0] = a[g][1] = 0.f;
      for (int j = rg; j < rows; j += RG) {
        const float2 vf = load2(vt + j * RS + 2 * cp);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            const float p = sc[g * TK + j];
            a[g][0] += p * vf.x;
            a[g][1] += p * vf.y;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        acc[g][0] = acc[g][0] * corr_s[g] + a[g][0];
        acc[g][1] = acc[g][1] * corr_s[g] + a[g][1];
      }
    }
    // the next iteration's copies overwrite this tile's other buffer
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();   // m_s, l_s visible when there was no tile

  // sum the row groups' partial accumulators (in the K/V buffers) and
  // normalise
  float* red = reinterpret_cast<float*>(smem_raw);        // [RG][G][D]
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      red[(rg * kMaxGroup + g) * D + 2 * cp] = acc[g][0];
      red[(rg * kMaxGroup + g) * D + 2 * cp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float o = 0.f;
    for (int r = 0; r < RG; ++r) o += red[(r * kMaxGroup + g) * D + d];
    out[q0 + idx] = from_f32<TKV>(o / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int b, int s, int hkv, int g, int64_t k_sb,
           int64_t k_ss, int64_t v_sb, int64_t v_ss, float scale,
           cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TKV, D>;
  constexpr size_t smem = Tile<TKV, D>::kSmem;
  static bool configured = false;   // the attribute is set once a kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kernel<<<dim3(hkv, b), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int32_t*>(lengths),
      static_cast<TKV*>(out), s, hkv, g, k_sb, k_ss, v_sb, v_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* lengths, void* out, int b, int s, int hkv, int g,
               int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<TQ, TKV, 16>(q, k, v, lengths, out, b, s, hkv, g, k_sb,
                                 k_ss, v_sb, v_ss, scale, stream);
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, lengths, out, b, s, hkv, g, k_sb,
                                 k_ss, v_sb, v_ss, scale, stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, lengths, out, b, s, hkv, g, k_sb,
                                 k_ss, v_sb, v_ss, scale, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, lengths, out, b, s, hkv, g, k_sb,
                                  k_ss, v_sb, v_ss, scale, stream);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, lengths, out, b, s, hkv, g, k_sb,
                                  k_ss, v_sb, v_ss, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hkv*G, D] contiguous; k, v [B, S, Hkv, D] with unit element stride,
// head stride D and batch/seq strides (in elements) as given, 16-byte
// aligned rows; lengths [B] int32 on the device; out [B, Hkv*G, D]
// contiguous, of the KV dtype; scale is D^-1/2 as float32.  q_bf16 /
// kv_bf16 select bfloat16 (else float32): q and KV of one dtype, or a
// float32 q against a bfloat16 cache (the int8-KV path loads as bfloat16);
// a bfloat16 q against a float32 cache has no caller and is refused.
// D in {16, 32, 64, 128, 256}, 1 <= G <= 8.  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int b, int s, int hkv,
                                       int g, int d, long long k_sb,
                                       long long k_ss, long long v_sb,
                                       long long v_ss, float scale,
                                       int q_bf16, int kv_bf16,
                                       void* stream) {
  if (g < 1 || g > kMaxGroup || b < 1 || hkv < 1 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return dispatch_d<bf16, bf16>(d, q, k, v, lengths, out, b, s, hkv, g,
                                  k_sb, k_ss, v_sb, v_ss, scale, st);
  if (kv_bf16)
    return dispatch_d<float, bf16>(d, q, k, v, lengths, out, b, s, hkv, g,
                                   k_sb, k_ss, v_sb, v_ss, scale, st);
  if (q_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d<float, float>(d, q, k, v, lengths, out, b, s, hkv, g,
                                  k_sb, k_ss, v_sb, v_ss, scale, st);
}
